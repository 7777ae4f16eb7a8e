"""The port's distributed layer.

Served (ROADMAP item 14a, the mesh and its collectives): ``sharding``
(the logical-axis rules, specs and shardings over a mesh of ranks),
``collectives`` (the fast-before-slow psum tree and the int8 all-reduce
with error feedback), ``tc_collectives`` (the chained-MMA collectives:
one f32 partial a rank, folded over the mesh) and ``fault_tolerance``
(checkpoint / restart, ``remesh`` and the replan after it).  The meshes
themselves are ``compat.make_mesh`` and ``launch.mesh``.

Served (ROADMAP item 14b(i) to (iii)): the SPMD train step of every
arch (``launch.train`` with ``data_parallel`` or ``model_parallel``
above 1, ``make_train_step(mesh=...)``), ``SyntheticLMData``'s sharded
batch, the sharded AdamW state and its checkpoints, ``models.moe``'s
expert-parallel branch (the ``etp`` and ``ep2d`` layouts, with the
autograd all-to-all and conjugate collectives of ``collectives``), and
``launch.serve``'s ``Server`` and ``ContinuousServer`` over a mesh (each
rank decoding its own rows, ``sharding.batch_rows``), and
``launch.dryrun``'s dry run of those steps for rank 0 of a fake world
the size of a production mesh (14b(iv)).
"""
