"""Circuit layer of the port: the device witness generator.  The R1CS and
the voting circuit itself are the JAX package's jax-free
``vote_saver_tpu.circuit`` modules."""
