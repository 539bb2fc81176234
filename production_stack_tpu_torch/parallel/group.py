"""The engine's ranks: one process per (pp, dp, sp, ep, tp) rank, each on
its own device, joined by ``torch.distributed``.

The counterpart of production_stack_tpu/parallel/mesh.py for the five axes
of its mesh. Where the JAX engine lays a (pp, dp, sp, ep, tp) device mesh
under one program and lets GSPMD and ``shard_map`` insert the collectives,
the port runs one process per rank (engine/engine.py starts them) and calls
its collectives itself (parallel/tp.py over a tp group, parallel/ep.py over
an expert group, parallel/dp.py over a dp group,
parallel/ring_attention.py over a sequence group, parallel/pipeline.py
over a stage group). Rank r sits at (p, d, s, e, t) with
r = (((p * dp + d) * sp + s) * ep + e) * tp + t, the mesh's order
(pp, dp, sp, ep, tp) with pp outermost and tp innermost:

- a tp group, the tp ranks of one (p, d, s, e), splits the heads, the
  dense MLP, the vocabulary and each expert's FFN (where tp is a multiple
  of the KV heads, tp/KH ranks in a row share one KV head: parallel/tp.py);
- an expert group, the ep x tp ranks of one (p, d, s), holds the experts
  (E/ep a rank) and sums a MoE layer's output with one all-reduce; the
  attention, the router, the norms and the embeddings are replicated along
  ep, so the ranks of one (d, t) hold the same KV heads and write the same
  pages (the JAX ``KV_PAGES_SPEC`` shards tp only);
- a dp group, the dp ranks of one (p, s, e, t), are the replicas of one
  pool shard across the dp replicas;
- a sequence group, the sp ranks of one (p, d, e, t), splits a prefill
  chunk's tokens: it joins the chunk's K/V along the tokens
  (``all_gather``) and rotates the ring's KV blocks from rank s to rank
  s + 1 (``rotate``, over two-rank groups); the weights and the pools are
  replicated along it (the JAX ``KV_PAGES_SPEC`` shards tp only), so its
  ranks are also the replicas of one pool shard;
- a stage group, the pp ranks of one (d, s, e, t), holds the layer stack
  in pp contiguous stages: it relays a microbatch's activations from stage
  p to stage p + 1 (``send_next``/``recv_prev``, over the two ranks' own
  group), hands the last stage's final hidden states to every stage
  (``broadcast_from_last``) and gathers a page's layers.
  In this port dp = 1 whenever pp > 1 (engine/config.check_supported, in
  the JAX engine's words); sp composes with dp or pp ranks (a dp
  replica's or a stage's sequence ranks), and ep with all of them, the
  expert group of a stage's or a sequence rank's (p, d, s) holding its
  experts.

Multi-host serving splits the ranks into equal blocks, one per host
process: host h of n runs global ranks [h * L, (h + 1) * L), L = ranks / n
(``host_ranks``), so the split falls on the outermost axes, as the JAX
``make_mesh`` reshapes the global device list (process 0's devices first).
Every rank joins over the coordinator's c10d TCP store
(``tcp://host:port``, hosted by global rank 0), which also carries the
step stream's secret (engine/distributed.resolve_sync_secret). A host
names only its own devices (``tp_device_ids``: L indices); rank r runs on
its host's ``r % L``-th.

The backend is named by the caller, never guessed: ``nccl`` (the default)
needs a CUDA device per rank and refuses two ranks on one device; ``gloo``
takes CUDA or CPU tensors and stages CUDA ones through the host, so several
ranks may share one card (a functional test of the path, not a speed
figure) and a CPU engine can run dp and tp in tests. Rank r runs on
``devices[r]``: ``cuda:r`` unless ``tp_device_ids`` maps the ranks
(``"0,0,0,0"``: four ranks on the first card).

``TPGroup`` counts what crosses any of its groups (calls, bytes, host
seconds inside the collectives), the stage relays and hand-overs apart as
well (``relay_calls``, ``relay_bytes``, ``relay_seconds``), and what crosses
the sequence group apart too (``ring_calls``, ``ring_bytes``,
``ring_seconds``: the ring's rotations and the token gathers). On gloo a
collective of CUDA tensors waits for the device to finish the work queued
before it, so its seconds include that wait. The relays and the ring's
rotations are broadcasts over a two-rank group, which every backend takes
for CUDA tensors (gloo's ``send``/``recv`` take CPU tensors only), moved as
bytes.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
# rendezvous and per-collective timeout: a rank that dies is seen at once
# (its sockets close); one that hangs, or a host that never joins, ends the
# set after this long (PSTPU_RANK_TIMEOUT_S)
TIMEOUT_S = float(os.environ.get("PSTPU_RANK_TIMEOUT_S", "300"))


_AXES_NAMED = ("pipeline_parallel_size x data_parallel_size x sequence_parallel_size x "
               "expert_parallel_size x tensor_parallel_size")


def parse_device_ids(spec: Optional[str], ranks: int) -> Optional[list[int]]:
    """``"0,0"`` -> [0, 0]: one CUDA device index per rank this host runs
    (all pp x dp x sp x ep x tp of them on one host; None: its i-th rank on
    device i)."""
    if spec is None or spec == "":
        return None
    try:
        ids = [int(x) for x in str(spec).split(",")]
    except ValueError:
        raise ValueError(f"tp_device_ids {spec!r} must be comma-separated device indices") from None
    if len(ids) != ranks or min(ids) < 0:
        raise ValueError(
            f"tp_device_ids {spec!r} must name one device index >= 0 for each of the engine's {ranks} ranks "
            f"on this host ({_AXES_NAMED}, over distributed_num_processes)"
        )
    return ids


def rank_devices(device, ranks: int, device_ids: Optional[list[int]] = None) -> list[torch.device]:
    """The device of each rank: every rank on the CPU for a CPU engine, else
    ``cuda:<device_ids[r]>`` (``cuda:r`` by default). Raises for a CUDA
    index the machine lacks."""
    dev = torch.device(device)
    if dev.type == "cpu":
        if device_ids is not None:
            raise ValueError("tp_device_ids name CUDA devices; a CPU engine runs every rank on the CPU")
        return [dev] * ranks
    ids = device_ids if device_ids is not None else list(range(ranks))
    n = torch.cuda.device_count()
    if max(ids) >= n:
        raise ValueError(
            f"{ranks} ranks ({_AXES_NAMED}) need CUDA "
            f"devices {sorted(set(ids))}, this machine has {n} devices; ranks may share a card with "
            "--tp-backend gloo --tp-device-ids 0,0"
        )
    return [torch.device("cuda", i) for i in ids]


def check_backend(backend: str, devices: list[torch.device]) -> None:
    """Refuse a backend the ranks' devices cannot take; nothing switches to
    another backend quietly."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown tp_backend {backend!r}; options: {BACKENDS}")
    if backend != "nccl":
        return
    if any(d.type != "cuda" for d in devices):
        raise ValueError("tp_backend 'nccl' needs a CUDA device per rank; a CPU engine takes --tp-backend gloo")
    if len(set(devices)) < len(devices):
        raise ValueError(
            f"tp_backend 'nccl' refuses two ranks on one device ({[str(d) for d in devices]}); "
            "ask for --tp-backend gloo, which stages the collectives through the host"
        )


def host_ranks(world: int, hosts: int, host: int) -> range:
    """The global ranks host process ``host`` of ``hosts`` runs: an equal
    block of consecutive ranks, the outermost axes split first."""
    if hosts < 1 or world % hosts or not 0 <= host < hosts:
        raise ValueError(f"{hosts} host processes cannot split {world} ranks into equal blocks (host {host})")
    per = world // hosts
    return range(host * per, (host + 1) * per)


def rank_place(rank: int, dp: int, tp: int, ep: int = 1, pp: int = 1, sp: int = 1) -> tuple:
    """(p, d, s, e, t) of global ``rank``: r = (((p * dp + d) * sp + s) * ep
    + e) * tp + t."""
    per = dp * sp * ep * tp
    p, rest = divmod(rank, per)
    d, within = divmod(rest, sp * ep * tp)
    s, place = divmod(within, ep * tp)
    e, t = divmod(place, tp)
    return p, d, s, e, t


def device_labels(devices: list[torch.device], dp: int = 1, ep: int = 1, pp: int = 1, sp: int = 1,
                  hosts: int = 1) -> list[str]:
    """One distinct label per rank: ``cuda:0`` for a single rank, else the
    device and the rank (``cuda:0/tp1``; with dp > 1 ``cuda:0/dp1tp0``; with
    ep > 1 ``cuda:0/dp0ep1tp0``; with sp > 1 ``cuda:0/sp1tp0``, beside dp
    ``cuda:0/dp1sp0tp0``; with pp > 1 the stage first, ``cuda:0/pp1tp0``,
    ``cuda:0/pp1sp0tp0``), so ranks on one card stay rows of their own;
    across hosts the host first (``host1/cuda:0/dp1tp0``)."""
    per_host = len(devices) // hosts
    names = [(f"host{r // per_host}/" if hosts > 1 else "") + f"{d.type}:{d.index or 0}"
             for r, d in enumerate(devices)]
    if len(devices) == 1:
        return names
    per = len(devices) // pp  # the ranks of one stage
    tp = per // (dp * sp * ep)

    def place(r):
        if sp > 1:
            d, rest = divmod(r, sp * ep * tp)
            s, rest = divmod(rest, ep * tp)
            e, t = divmod(rest, tp)
            return (f"dp{d}" if dp > 1 else "") + f"sp{s}" + (f"ep{e}" if ep > 1 else "") + f"tp{t}"
        if dp == 1 and ep == 1:
            return f"tp{r}"
        if ep == 1:
            return f"dp{r // tp}tp{r % tp}"
        return f"dp{r // (ep * tp)}ep{r // tp % ep}tp{r % tp}"

    stage = (lambda r: f"pp{r // per}") if pp > 1 else (lambda r: "")
    return [f"{name}/{stage(r)}{place(r % per)}" for r, name in enumerate(names)]


class Group:
    """One collective group of the engine's ranks: this process's ``rank``
    in it, its ``size``, and the collectives the port runs over it, each
    counted in ``counts`` (the process's ``TPGroup``). A group of one rank
    runs no collective."""

    def __init__(self, rank: int, size: int, pg, first: int, counts: "TPGroup"):
        # pg None: the default group (every rank); first: the global rank of
        # the group's first member, the source of its broadcasts
        self.rank, self.size, self.pg, self.first = rank, size, pg, first
        self._counts = counts

    def _run(self, op, t: torch.Tensor, relay: bool = False, ring: bool = False) -> None:
        if self.size == 1:
            return
        t0 = time.perf_counter()
        op(t)
        c = self._counts
        dt = time.perf_counter() - t0
        c.seconds += dt
        c.calls += 1
        c.bytes += t.nbytes
        if relay:
            c.relay_seconds += dt
            c.relay_calls += 1
            c.relay_bytes += t.nbytes
        if ring:
            c.ring_seconds += dt
            c.ring_calls += 1
            c.ring_bytes += t.nbytes

    def all_reduce(self, t: torch.Tensor) -> None:
        """Sum ``t`` over the group's ranks, in place."""
        self._run(lambda x: dist.all_reduce(x, group=self.pg), t)

    def broadcast(self, t: torch.Tensor) -> None:
        """The group's first rank's ``t`` on every rank of the group, in
        place (``src`` is that rank's global rank, which every torch
        version takes)."""
        self._run(lambda x: dist.broadcast(x, src=self.first, group=self.pg), t)


class TPGroup(Group):
    """This process's rank among the engine's pp x dp x sp x ep x tp ranks:
    its tp group (``rank``, ``size`` and the collectives the forward runs),
    ``expert`` (the ep x tp ranks of its (p, d, s) place, at rank e * tp +
    t: the MoE layers' all-reduce and the sampled ids' broadcast; it holds
    the rank's place on the ep axis), ``dp`` (the ranks holding the
    same KV heads at the same (p, s, e), one per dp replica: the replicas of
    its pool shard), ``seq`` (the sp ranks of its (p, d, e, t) place, at
    rank s: a chunk's token split and the ring), ``stage`` (the pp ranks of
    its (d, s, e, t) place, at rank p: the relays between stages),
    ``world`` (every rank), the device and label of every rank, and the
    counts of what crosses any of them (``expert_calls`` and
    ``expert_bytes`` count the expert group's all-reduces alone; ``relay_*``
    the stage group's relays and hand-overs; ``ring_*`` the sequence
    group's rotations and gathers)."""

    def __init__(self, world_rank: int, dp: int, tp: int, backend: str, devices: list[torch.device],
                 pgs: tuple = (None, None, None, None, None, None, None), ep: int = 1, pp: int = 1, sp: int = 1,
                 hosts: int = 1, store=None):
        per = dp * sp * ep * tp  # the ranks of one stage
        p, d, s, e, t = rank_place(world_rank, dp, tp, ep, pp, sp)
        rest = world_rank - p * per
        place = e * tp + t
        self.calls = 0
        self.bytes = 0
        self.seconds = 0.0
        self.expert_calls = 0
        self.expert_bytes = 0
        self.relay_calls = 0
        self.relay_bytes = 0
        self.relay_seconds = 0.0
        self.ring_calls = 0
        self.ring_bytes = 0
        self.ring_seconds = 0.0
        tp_pg, expert_pg, dp_pg, stage_pg, pair_pgs, seq_pg, ring_pgs = pgs
        super().__init__(t, tp, tp_pg, world_rank - t, self)
        self.expert = ExpertGroup(place, ep * tp, expert_pg, world_rank - place, self, e, ep)
        self.dp = Group(d, dp, dp_pg, world_rank - d * sp * ep * tp, self)
        self.seq = SeqGroup(s, sp, seq_pg, world_rank - s * ep * tp, self, ep * tp, ring_pgs or {})
        self.stage = StageGroup(p, pp, stage_pg, rest, self, per, pair_pgs or {})
        self.world = Group(world_rank, pp * per, None, 0, self)
        self.backend = backend
        self.devices = devices
        self.device = devices[world_rank]
        self.hosts = hosts
        self.labels = device_labels(devices, dp, ep, pp, sp, hosts)
        # the rendezvous' c10d store (global rank 0 hosts it): the step
        # stream's secret crosses it between hosts
        self.store = store

    @classmethod
    def init(cls, rank: int, dp: int, tp: int, backend: str, devices: list[torch.device], init_method: str,
             timeout_s: float = TIMEOUT_S, ep: int = 1, pp: int = 1, sp: int = 1, hosts: int = 1) -> "TPGroup":
        """Join the engine's ranks as global ``rank`` (a barrier: returns
        once every rank has joined, or raises past ``timeout_s``), after
        making the rank's device current. ``init_method`` is
        ``tcp://host:port``: a c10d TCP store that global rank 0 starts
        there and every other rank dials (retrying until the timeout, so a
        rank may start before rank 0 listens); with ``hosts`` > 1 the
        ranks are ``hosts`` blocks of the world, one per host process. The
        world is the process's default ``torch.distributed``
        group, so a process takes part in one engine's ranks at a time.
        Every rank makes every tp, expert, dp, sequence and stage subgroup
        that is neither the world nor a single rank (nor, at ep = 1, the tp
        group again), then at pp > 2 the two-rank relay group of every pair
        of neighbouring stages and at sp > 2 the two-rank ring group of
        every pair of neighbouring sequence ranks, in one order, as
        ``dist.new_group`` asks, even those it is not in."""
        check_backend(backend, devices)
        if dist.is_initialized():
            raise RuntimeError("this process is already in a tp group: one tp engine per process at a time")
        if devices[rank].type == "cuda":
            torch.cuda.set_device(devices[rank])
        timeout = datetime.timedelta(seconds=timeout_s)
        per = dp * sp * ep * tp
        if not init_method.startswith("tcp://"):
            raise ValueError(f"init_method {init_method!r} must be tcp://host:port")
        host, _, port = init_method[len("tcp://"):].rpartition(":")
        store = dist.TCPStore(host, int(port), pp * per, rank == 0, timeout=timeout, wait_for_workers=False)
        dist.init_process_group(backend, store=store, world_size=pp * per, rank=rank, timeout=timeout)
        p, rest = divmod(rank, per)
        d, within = divmod(rest, sp * ep * tp)
        place = within % (ep * tp)

        def new(ranks):
            return dist.new_group(ranks, timeout=timeout)

        # None: the world, or a group of one rank
        tp_pg = expert_pg = dp_pg = seq_pg = stage_pg = None
        if tp > 1 and pp * dp * sp * ep > 1:  # one per (p, d, s, e)
            tps = [new([g * tp + c for c in range(tp)]) for g in range(pp * dp * sp * ep)]
            tp_pg = tps[rank // tp]
        if ep * tp > 1 and pp * dp * sp > 1:  # one per (p, d, s); at ep = 1 the tp group
            if ep == 1:
                expert_pg = tp_pg
            else:
                experts = [new([g * ep * tp + c for c in range(ep * tp)]) for g in range(pp * dp * sp)]
                expert_pg = experts[rank // (ep * tp)]
        if dp > 1 and pp * sp * ep * tp > 1:  # one per (p, s, e, t)
            dps = [new([q * per + g * sp * ep * tp + c for g in range(dp)])
                   for q in range(pp) for c in range(sp * ep * tp)]
            dp_pg = dps[p * sp * ep * tp + within]
        # the sequence ranks of each (p, d, e, t): ranks q * per + g * sp *
        # ep * tp + s * ep * tp + c for s in range(sp)
        seqs = [[q * per + g * sp * ep * tp + s * ep * tp + c for s in range(sp)]
                for q in range(pp) for g in range(dp) for c in range(ep * tp)]
        mine = (p * dp + d) * ep * tp + place
        if sp > 1 and pp * dp * ep * tp > 1:
            seq_pgs = [new(ranks) for ranks in seqs]
            seq_pg = seq_pgs[mine]
        if pp > 1 and per > 1:  # one per (d, s, e, t)
            stages = [new([q * per + c for q in range(pp)]) for c in range(per)]
            stage_pg = stages[rest]
        pairs = {0: stage_pg} if pp == 2 else {}
        if pp > 2:  # stages q and q + 1 of each (d, s, e, t)
            for c in range(per):
                for q in range(pp - 1):
                    pg = new([q * per + c, (q + 1) * per + c])
                    if c == rest:
                        pairs[q] = pg
        # the ring's pairs: sequence ranks s and s + 1 (mod sp); at sp = 2
        # both pairs are the sequence group itself
        rings = {0: seq_pg, 1: seq_pg} if sp == 2 else {}
        if sp > 2:
            for i, ranks in enumerate(seqs):
                for s in range(sp):
                    pg = new([ranks[s], ranks[(s + 1) % sp]])
                    if i == mine:
                        rings[s] = pg
        return cls(rank, dp, tp, backend, devices, (tp_pg, expert_pg, dp_pg, stage_pg, pairs, seq_pg, rings),
                   ep=ep, pp=pp, sp=sp, hosts=hosts, store=store)

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()

    def stats(self) -> tuple[int, int, float]:
        return self.calls, self.bytes, self.seconds

    def reset_stats(self) -> None:
        self.calls, self.bytes, self.seconds = 0, 0, 0.0
        self.expert_calls = self.expert_bytes = 0
        self.relay_calls, self.relay_bytes, self.relay_seconds = 0, 0, 0.0
        self.ring_calls, self.ring_bytes, self.ring_seconds = 0, 0, 0.0


class ExpertGroup(Group):
    """The ep x tp ranks of one dp replica, and the rank's place on its ep
    axis (``ep_rank`` of ``ep_size``): its all-reduces (a MoE layer's sums,
    an expert tensor's gather) also add to ``expert_calls`` and
    ``expert_bytes`` of the process's ``TPGroup``."""

    def __init__(self, rank: int, size: int, pg, first: int, counts: "TPGroup", ep_rank: int, ep_size: int):
        super().__init__(rank, size, pg, first, counts)
        self.ep_rank, self.ep_size = ep_rank, ep_size

    def all_reduce(self, t: torch.Tensor) -> None:
        super().all_reduce(t)
        if self.size > 1:
            self._counts.expert_calls += 1
            self._counts.expert_bytes += t.nbytes


class StageGroup(Group):
    """The pp ranks of one (d, e, t) place, stage ``rank`` of ``size``: the
    pipeline's relays (parallel/pipeline.py). Stage q's rank is q *
    ``stride`` + the place's offset; ``pairs[q]`` is the group of stages q
    and q + 1 this rank is in (the stage group itself at pp = 2). Every
    relay and hand-over moves the tensor's bytes (a broadcast of uint8,
    which every backend takes, exact) and adds to the ``relay_*`` counts as
    well as to the collective counts."""

    def __init__(self, rank: int, size: int, pg, first: int, counts: "TPGroup", stride: int, pairs: dict):
        super().__init__(rank, size, pg, first, counts)
        self.stride, self.pairs = stride, pairs

    def _global(self, q: int) -> int:
        return self.first + q * self.stride

    def _bcast(self, t: torch.Tensor, src_stage: int, pg) -> None:
        raw = t.view(torch.uint8)
        self._run(lambda x: dist.broadcast(x, src=self._global(src_stage), group=pg), raw, relay=True)

    def send_next(self, x: torch.Tensor) -> None:
        """Hand ``x`` (contiguous) to stage rank + 1; waits for it to take it."""
        self._bcast(x, self.rank, self.pairs[self.rank])

    def recv_prev(self, buf: torch.Tensor) -> torch.Tensor:
        """Stage rank - 1's ``send_next``, into ``buf`` (contiguous, its shape
        and dtype); returns ``buf``."""
        self._bcast(buf, self.rank - 1, self.pairs[self.rank - 1])
        return buf

    def broadcast_from_last(self, t: torch.Tensor) -> torch.Tensor:
        """The last stage's ``t`` on every stage, in place (the JAX
        pipeline's closing ``psum`` of the last stage's outputs)."""
        self._bcast(t, self.size - 1, self.pg)
        return t


class SeqGroup(Group):
    """The sp ranks of one (p, d, e, t) place, sequence rank ``rank`` of
    ``size``: a prefill chunk's token split (parallel/ring_attention.py,
    models/llama.py). Sequence rank q's global rank is ``first`` + q *
    ``stride``; ``rings[q]`` is the group of ranks q and q + 1 (mod sp)
    this rank is in (the sequence group itself at sp = 2). Everything that
    crosses the group adds to the ``ring_*`` counts as well as to the
    collective counts."""

    def __init__(self, rank: int, size: int, pg, first: int, counts: "TPGroup", stride: int, rings: dict):
        super().__init__(rank, size, pg, first, counts)
        self.stride, self.rings = stride, rings

    def all_reduce(self, t: torch.Tensor) -> None:
        self._run(lambda x: dist.all_reduce(x, group=self.pg), t, ring=True)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every sequence rank's ``x`` joined along ``dim`` in rank order,
        bit for bit, on every rank (parallel/tp._exact_gather: an
        all-reduce of int32 words over a zero-filled whole)."""
        if self.size == 1:
            return x
        from production_stack_tpu_torch.parallel.tp import _exact_gather  # tp imports nothing of this module

        return _exact_gather(x.contiguous(), dim, self)

    def _bcast(self, buf: torch.Tensor, src: int) -> None:
        """Sequence rank ``src``'s ``buf`` (uint8) on sequence rank src + 1,
        over their two-rank group."""
        self._run(lambda x: dist.broadcast(x, src=self.first + src * self.stride, group=self.rings[src]), buf,
                  ring=True)

    def rotate(self, *tensors: torch.Tensor) -> tuple:
        """The ring's step: this rank's ``tensors`` go to sequence rank
        rank + 1 and rank - 1's come in their place (``lax.ppermute`` with
        the permutation i -> i + 1 mod sp). The tensors move together as one
        buffer of their bytes (exact), in two broadcasts: an even rank sends
        first and then receives, an odd one the other way round, so no
        cycle of ranks waits on itself. Returns the received tensors, in
        their shapes and dtypes."""
        if self.size == 1:
            return tensors
        out = torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in tensors])
        got = torch.empty_like(out)
        prev = (self.rank - 1) % self.size
        if self.rank % 2 == 0:
            self._bcast(out, self.rank)
            self._bcast(got, prev)
        else:
            self._bcast(got, prev)
            self._bcast(out, self.rank)
        res, at = [], 0
        for t in tensors:
            n = t.numel() * t.element_size()
            res.append(got[at: at + n].view(t.dtype).reshape(t.shape))
            at += n
        return tuple(res)
