"""Parallelism of the port: one process per (dp, tp) rank (``group.py``),
the split of every weight with the collectives the forward runs
(``tp.py``), and the batch rows over dp with the pools' replica sync
(``dp.py``)."""
