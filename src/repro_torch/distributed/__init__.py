"""The port's distributed layer, its one-card part: ``sharding`` (the
logical axes the model layers name), ``tc_collectives`` (the chained-MMA
collectives, which reduce to plain dispatch on one card) and
``fault_tolerance`` (checkpoint / restart around the training loop)."""
