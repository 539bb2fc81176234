"""Parallelism of the port: one process per (pp, dp, sp, ep, tp) rank
(``group.py``), the split of every weight with the collectives the forward
runs (``tp.py``), the experts over ep (``ep.py``), the batch rows over dp
with the pools' replica sync (``dp.py``), a prefill chunk's tokens over sp
with ring attention (``ring_attention.py``), and the layer stack in
pipeline stages with their microbatch relays (``pipeline.py``)."""
