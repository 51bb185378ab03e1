"""Shared utilities: seedable randomness (the port's copy of
``vote_saver_tpu/utils/rng.py``)."""
