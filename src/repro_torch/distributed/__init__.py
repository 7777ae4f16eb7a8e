"""The port's distributed layer.  One module so far: the one-device part
of ``sharding`` that the model layers import."""
