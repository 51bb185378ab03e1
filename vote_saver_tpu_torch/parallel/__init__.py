"""Multi-rank MSM, NTT and tally over torch.distributed (``sharded.py``)."""
