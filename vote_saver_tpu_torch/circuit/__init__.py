"""Circuit layer of the port: the R1CS builder, the voting circuit and its
gadgets (copies of ``vote_saver_tpu/circuit/{r1cs,gadgets,voting}.py``), and
the device witness generator."""
