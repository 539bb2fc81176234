"""Tensor parallelism of the port: one process per tp rank
(``group.py``) and the split of every weight with the collectives the
forward runs (``tp.py``)."""
