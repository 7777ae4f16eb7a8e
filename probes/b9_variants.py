"""Variants of kernel B9's CUDA source, shared by the B9 probes and by
``chip_smoke.py``'s phase 5g: each variant is a copy of
``csrc/mma_attention.cu`` with a few text edits, built by its own
``nvcc`` (all started together) against the shared ``csrc/hopper.cuh``,
called through its C interface ``b9_attention``, and timed by CUDA
events or by ``torch.profiler``'s device time.

    import b9_variants as bv                  # beside it in probes/
    running = bv.start_builds({"mma_sync": bv.MMA_SYNC}, "b9")
    libs, logs = bv.finish_builds(running)
    call = bv.variant_call(libs["mma_sync"], qg, k, v, kw)
    bv.median_ms(call), bv.device_ms(call, ("attn_kernel",))
"""

from __future__ import annotations

import ctypes
import os
import re
import statistics
import subprocess

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "build", "probes")
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# (old text, new text) edits; each old text must occur exactly once in
# the source.  These two switch the f32 prefill form and the decode form
# off in the chooser.
OFF_WF = ("  return q_dtype == kF32 && kv_dtype == kF32 && rows > 16 &&",
          "  return false && q_dtype == kF32 && kv_dtype == kF32 && "
          "rows > 16 &&")
OFF_DC = ("  return (q_dtype == kF32 || q_dtype == kBF16) && "
          "kv_dtype == kBF16 &&",
          "  return false && (q_dtype == kF32 || q_dtype == kBF16) && "
          "kv_dtype == kBF16 &&")
# The mma.sync form (``attn_kernel``) wherever f32 prefill and decode
# steps ran on it before B9's f32 prefill and decode forms: its code is
# the one they ran.
MMA_SYNC = [OFF_WF, OFF_DC]


def variant_source(base: str, name: str, edits) -> str:
    src = base
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"probe: the {name} edit does not match the "
                             f"source once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def start_builds(variants: dict, prefix: str) -> dict:
    """Write each variant's source ({name: edits}) and start its nvcc;
    returns {name: (library, process)}."""
    os.makedirs(BUILD, exist_ok=True)
    base = open(os.path.join(CSRC, "mma_attention.cu")).read()
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    running = {}
    for name, edits in variants.items():
        src = os.path.join(BUILD, f"{prefix}_{name}.cu")
        lib = os.path.join(BUILD, f"lib{prefix}_{name}.so")
        with open(src, "w") as f:
            f.write(variant_source(base, name, edits))
        running[name] = (lib, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-I",
             CSRC, "-o", lib, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return running


def finish_builds(running: dict) -> tuple:
    """Wait for the builds; returns ({name: library}, {name: nvcc's
    log})."""
    libs, logs = {}, {}
    for name, (lib, proc) in running.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"probe: nvcc failed for {name}:\n"
                             f"{log[-4000:]}")
        logs[name] = log
        dll = ctypes.CDLL(lib)
        ptr, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                         ctypes.c_float)
        dll.b9_attention.argtypes = [ptr] * 7 + [i] * 11 + [ll, f, i, f, ptr]
        dll.b9_attention.restype = i
        libs[name] = dll
    return libs, logs


def ptxas_report(log: str, needles) -> dict:
    """{kernel name from its first needle on (40 characters): [registers,
    spill store bytes]} of the kernels whose mangled name holds one of
    ``needles``, from nvcc's ``-Xptxas=-v`` log."""
    found, cur = {}, None
    for line in log.splitlines():
        got = re.search(r"Compiling entry function '([^']+)'", line)
        if got:
            cur = got.group(1) if any(n in got.group(1)
                                      for n in needles) else None
            continue
        if cur is None:
            continue
        short = cur[min(cur.find(n) for n in needles if n in cur):][:40]
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill:
            found.setdefault(short, [None, 0])[1] = int(spill.group(1))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            found.setdefault(short, [None, 0])[0] = int(regs.group(1))
    return found


def variant_call(dll, qg, k, v, kw, scratch_bytes: int = 16):
    """A call of a variant's b9_attention (kw: qpos (B, Sq) and kv_len
    (B,) or None as int32 on the card, causal, window, scale, cap): the
    output in v's dtype.  ``scratch_bytes`` of scratch go with it: the f32
    prefill form's word planes, the decode form's chunk states; the
    mma.sync form takes none."""
    B, Sq, KV, G, hd = qg.shape
    Sk, hd_v = k.shape[1], v.shape[-1]
    out = torch.empty(B, Sq, KV, G, hd_v, dtype=v.dtype, device="cuda")
    scratch = torch.empty(max(int(scratch_bytes), 16), dtype=torch.uint8,
                          device="cuda")
    window, cap, kv_len = kw["window"], kw["cap"], kw["kv_len"]
    args = (qg.data_ptr(), k.data_ptr(), v.data_ptr(), kw["qpos"].data_ptr(),
            None if kv_len is None else kv_len.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), B, Sq, Sk, KV, G, hd, hd_v,
            _DTYPES[qg.dtype], _DTYPES[k.dtype], int(kw["causal"]),
            0 if window is None else 1, 0 if window is None else int(window),
            float(kw["scale"]), 0 if cap is None else 1,
            0.0 if cap is None else float(cap),
            torch.cuda.current_stream().cuda_stream)

    def call():
        rc = dll.b9_attention(*args)
        if rc:
            raise RuntimeError(f"probe: b9_attention returned {rc}")
        return out
    return call


def median_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Median of ``reps`` CUDA-event timings of single calls of fn."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(call, keys, calls: int = 3) -> dict:
    """{key: {"ms": device ms a launch, "launches": launches the trace
    holds}} over ``calls`` calls under torch.profiler, for the kernels
    whose name holds a key of ``keys``: each key's device time over the
    launches the trace recorded for it, which a caller holds against
    ``calls`` (a launch the trace lost shows as a short count, not as a
    short time)."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    us, count = {}, {}
    for ev in prof.key_averages():
        for key in keys:
            if key in ev.key:
                us[key] = us.get(key, 0.0) + (
                    getattr(ev, "device_time_total", 0) or 0)
                count[key] = count.get(key, 0) + int(ev.count)
    return {key: {"ms": us[key] / count[key] / 1e3, "launches": count[key]}
            for key in us if count[key]}
