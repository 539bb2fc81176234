"""How a step's batch rows split over the dp ranks, and how the dp replicas
of the KV pools stay one.

The counterpart of ``BATCH_SPECS`` in production_stack_tpu/parallel/
shardings.py (``P("dp", ...)`` on every row-leading step input) and of
``KV_PAGES_SPEC``, which replicates the pools over dp:

- ``row_slice``: dp group d takes rows [d * B/dp, (d + 1) * B/dp) of every
  row-leading input; ``gather_rows`` joins the groups' results on every
  rank, bit for bit (tp._exact_gather over the dp group).
- Every rank holds the whole pool of its KV heads, and page ids are global.
  A step writes each page from one row (prefix-cached pages are only read),
  so after a step that writes, ``sync_replicas`` gathers the whole pages each
  dp group wrote, with their int8 scales, and copies them into every other
  replica: byte-exact by construction, partial pages included (their older
  slots were equal in every replica already, and an int8 page's zeroed tail
  travels with it). Every rank lists what every group wrote from the step's
  whole inputs (``written_pages``, ``burst_positions``), which the step
  stream gives every rank; after a speculative dispatch also from the rows'
  final lengths (``spec_positions``), which every rank gathers.

With sequence ranks inside a replica (dp x sp) each of them takes its
replica's rows and writes the same pages, so its dp group (the dp ranks of
one sequence place) syncs one sp replica of each pool, and every sp
replica gets the same pages.

With ``group`` None (dp = 1) every function here is the identity.
"""

from __future__ import annotations

import numpy as np
import torch

from production_stack_tpu_torch.parallel.tp import _exact_gather


def row_slice(x, group):
    """This rank's contiguous B/dp rows of a row-leading array (numpy or
    torch; None passes). A step whose B does not divide by dp is refused:
    the scheduler pads every batch to a multiple of data_parallel_size, so
    another B is a fault, not something to pad here."""
    if group is None or x is None:
        return x
    B = x.shape[0]
    if B % group.size:
        raise ValueError(
            f"a step of {B} rows does not split over {group.size} dp ranks "
            "(the scheduler pads every batch to a multiple of data_parallel_size)"
        )
    n = B // group.size
    return x[group.rank * n: (group.rank + 1) * n]


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every dp rank's rows joined in rank order, on every rank, bit for
    bit."""
    if group is None:
        return x
    return _exact_gather(x.contiguous(), 0, group)


def written_pages(page_table, positions, page_size: int) -> np.ndarray:
    """The page ids, sorted and unique, that rows write at ``positions``
    [B, T] (-1: no write) through their ``page_table`` [B, maxp]."""
    pos = np.asarray(positions)
    rows, cols = np.nonzero(pos >= 0)
    return np.unique(np.asarray(page_table)[rows, pos[rows, cols] // page_size])


def burst_positions(positions, kv_lens, kv_limits, k: int) -> np.ndarray:
    """The positions [B, k] a k-step decode burst commits, -1 for none: a
    row that starts at position p0 >= 0 writes p0 and goes on while its
    length stays under its limit, so it writes min(k, max(1, limit - kv_len
    + 1)) tokens. runner.step_multi commits its window at these positions
    and syncs their pages, so the write and the sync read one rule."""
    p0 = np.asarray(positions)[:, 0].astype(np.int64)
    lens = np.asarray(kv_lens).astype(np.int64)
    limits = np.full_like(lens, np.iinfo(np.int32).max // 2) if kv_limits is None else np.asarray(kv_limits)
    count = np.where(p0 >= 0, np.minimum(k, np.maximum(1, limits - lens + 1)), 0)
    j = np.arange(k)[None, :]
    return np.where(j < count[:, None], p0[:, None] + j, -1)


def spec_positions(positions, kv_lens, kv_limits, lens_final, k: int) -> np.ndarray:
    """The positions [B, W] a speculative dispatch (runner.step_spec) may
    have written, -1 for none: a row that emitted (``lens_final`` past its
    ``kv_lens``) wrote from its current token's position kv_lens - 1 up to
    at most its last round's kv_len - 1 + k, which lies under both
    lens_final - 1 + k and its ``kv_limits`` (a round runs only while kv_len +
    k <= kv_limits, inside the row's own pages). A page in that range that
    the rounds did not reach is the row's own too, so syncing it is exact."""
    lo = np.asarray(kv_lens, np.int64) - 1
    hi = np.minimum(np.asarray(lens_final, np.int64) - 1 + k, np.asarray(kv_limits, np.int64) - 1)
    wrote = (np.asarray(positions)[:, 0] >= 0) & (np.asarray(lens_final) > np.asarray(kv_lens))
    width = int(max(1, (hi - lo + 1)[wrote].max(initial=1)))
    p = lo[:, None] + np.arange(width)[None, :]
    return np.where(wrote[:, None] & (p <= hi[:, None]), p, -1)


def group_pages(page_table, positions, page_size: int, dp: int) -> list[np.ndarray]:
    """``written_pages`` of each dp group's rows."""
    B = len(page_table)
    n = B // dp
    return [written_pages(page_table[g * n: (g + 1) * n], positions[g * n: (g + 1) * n], page_size)
            for g in range(dp)]


def sync_replicas(tensors: list, pages: list[np.ndarray], group) -> int:
    """Copy the pages each other dp group wrote into this rank's replica:
    ``tensors`` are its pools and scales ([L, P, ...], page axis 1), and
    ``pages[g]`` the ids group g wrote (the same lists on every rank). One
    exact gather over the dp group carries every group's pages, each page
    one row of its bytes from every tensor. Returns the bytes gathered."""
    if group is None:
        return 0
    n = max(len(p) for p in pages)
    if n == 0:
        return 0
    dev = tensors[0].device
    own = np.zeros(n, np.int64)
    own[: len(pages[group.rank])] = pages[group.rank]
    idx = torch.as_tensor(own, device=dev)
    parts = [t[:, idx].transpose(0, 1).contiguous().view(n, -1).view(torch.uint8) for t in tensors]
    full = _exact_gather(torch.cat(parts, dim=1), 0, group)
    others = [g for g in range(group.size) if g != group.rank and len(pages[g])]
    if others:
        rows = torch.cat([full[g * n: g * n + len(pages[g])] for g in others])
        pids = torch.as_tensor(np.concatenate([pages[g] for g in others]).astype(np.int64), device=dev)
        off = 0
        for t, part in zip(tensors, parts):
            w = part.shape[1]
            vals = rows[:, off: off + w].contiguous().view(t.dtype).view(len(pids), t.shape[0], *t.shape[2:])
            t[:, pids] = vals.transpose(0, 1)
            off += w
    return full.nbytes
