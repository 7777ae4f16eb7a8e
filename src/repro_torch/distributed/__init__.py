"""The port's distributed layer.

Served (ROADMAP item 14a, the mesh and its collectives): ``sharding``
(the logical-axis rules, specs and shardings over a mesh of ranks),
``collectives`` (the fast-before-slow psum tree and the int8 all-reduce
with error feedback), ``tc_collectives`` (the chained-MMA collectives:
one f32 partial a rank, folded over the mesh) and ``fault_tolerance``
(checkpoint / restart, ``remesh`` and the replan after it).  The meshes
themselves are ``compat.make_mesh`` and ``launch.mesh``.

Waiting for ROADMAP item 14b (the model over a mesh), and refused naming
it: the SPMD train step (``launch.train`` with ``data_parallel`` or
``model_parallel`` above 1, ``make_train_step(mesh=...)``) and
``SyntheticLMData``'s sharded batch, ``Server`` and ``ContinuousServer``
over a mesh, ``models.moe``'s expert-parallel branch, and
``launch/dryrun``.
"""
