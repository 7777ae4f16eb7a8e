"""Can several ranks share one card over NCCL?  The probe behind phase
3m's choice of gloo (``chip_smoke.py``): two ranks on the one card
(``launch.mesh.run_ranks``) all-reduce a CUDA tensor, once over
``nccl`` and once over ``gloo``, and the probe prints what each
backend did (the sum, or the error the ranks raised).

    PYTHONPATH=src python3 probes/nccl_one_card.py
"""

from __future__ import annotations

import sys


def _all_reduce() -> float:
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    t = torch.full((4,), float(dist.get_rank() + 1), device="cuda")
    dist.all_reduce(t)
    torch.cuda.synchronize()
    return float(t[0])


def main() -> int:
    import torch
    from repro_torch.launch import mesh as launch_mesh
    if not torch.cuda.is_available():
        print("nccl_one_card: no CUDA device", file=sys.stderr)
        return 2
    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}",
          flush=True)
    for backend in ("nccl", "gloo"):
        try:
            got = launch_mesh.run_ranks(_all_reduce, 2, backend=backend,
                                        timeout=120)
            print(f"{backend}: served, the sum {got} (want 3.0)", flush=True)
        except RuntimeError as e:
            last = [ln for ln in str(e).splitlines() if ln.strip()][-3:]
            print(f"{backend}: refused: {' | '.join(last)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
