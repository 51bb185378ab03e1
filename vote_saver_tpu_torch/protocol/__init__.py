"""Protocol layer of the port: Groth16 prover/verifier, SAVER host arm,
key/proof parsing and the vote-phase functions."""
