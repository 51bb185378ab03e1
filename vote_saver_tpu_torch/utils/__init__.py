"""Shared utilities: seedable randomness, profiling, logging (the port's
copies of ``vote_saver_tpu/utils/rng.py`` and ``logging.py``, and its
counterpart of ``profiling.py``)."""
