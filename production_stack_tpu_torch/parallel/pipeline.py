"""Pipeline parallelism: the layer stack in pp contiguous stages, one stage
a rank (with its own tp group), microbatches relayed from stage to stage.

The counterpart of production_stack_tpu/parallel/pipeline.py
(``serving_layer_pipeline``, the GPipe fill-drain the JAX llama forward runs
under pp) and of the pp refusals of production_stack_tpu/engine/runner.py.
Where the JAX engine runs every stage inside one ``shard_map`` program and
moves a tick's activations with ``ppermute``, each stage here is a process
(parallel/group.py's stage group) that runs its microbatches in order:

- stage 0 embeds the batch; every stage takes microbatch m from the stage
  before it (``recv_prev``), runs its L/pp layers on it and hands it on
  (``send_next``), so while stage s runs microbatch m, stage s - 1 runs
  m + 1: the GPipe schedule of M + S - 1 ticks, its bubble (S - 1) /
  (M + S - 1), falls out of the blocking relays;
- the last stage keeps what the head reads of each microbatch (its rows'
  last positions, or every position with ``all_logits``) and one
  broadcast over the stage group gives it to every stage (the JAX
  ``psum`` of the last stage's outputs), where the final norm and the head
  run as they do without pp;
- each stage's K/V are written into its own pools ([L/pp, P, page, KH/tp,
  D], the JAX ``KV_PAGES_SPEC_PP``) by its layers, a microbatch at a time;
- a MoE model's stage holds its layers' experts, split over its expert
  group (the ep x tp ranks of the stage), whose all-reduce sums each MoE
  layer of a microbatch inside the stage; ``stage_routes`` gives a stage
  a one-rank run's routes in the order its layers route them.

On sequence ranks (pp x sp) each stage group is the pp ranks of one
sequence place: a stage relays its T/sp token slice of a microbatch to the
same sequence rank of the next stage (``act`` is the slice's shape), the
ring runs over each stage's own sequence group, and the last stage
gathers over its sequence group what the head reads before the hand-over
(models/llama.py ``_chunk_sp``). A MoE stage's routes replay a stage's
microbatches and a sequence rank's token slice at once: ``stage_routes``,
then parallel/ring_attention.seq_routes on each entry.

The relays carry the model's dtype as bytes (the JAX relay runs in f32
only to work around XLA:CPU; the values are the same). Every stage rank
issues its collectives in one order: its tp group's inside each
microbatch's layers, then that microbatch's relay, so a relay for
microbatch m never waits behind a collective for m + 1.
"""

from __future__ import annotations

from typing import Callable

import torch

from production_stack_tpu_torch.parallel.tp import gather_split


def check_pp(module, cfg, pp: int) -> None:
    """Refuse, by name, a pp the model cannot be served at: the JAX
    runner's refusals in its words (a family whose ``MESH_AXES`` lacks
    "pp"; a pp that does not divide the layers)."""
    if pp < 1:
        raise ValueError(f"pipeline_parallel_size must be >= 1, got {pp}")
    if pp == 1:
        return
    if "pp" not in getattr(module, "MESH_AXES", ("dp", "tp")):
        raise ValueError(
            f"model family {module.__name__.rsplit('.', 1)[-1]!r} does not support sequence/pipeline parallelism"
        )
    if cfg.num_layers % pp:
        raise ValueError(f"pipeline_parallel_size={pp} must divide num_layers={cfg.num_layers}")


def stage_range(num_layers: int, pp: int, p: int) -> range:
    """The model's layers stage ``p`` of ``pp`` holds."""
    n = num_layers // pp
    return range(p * n, (p + 1) * n)


def stage_place(stage) -> tuple[int, int]:
    """(pp, p) of a stage group (parallel/group.StageGroup); (1, 0) for
    None."""
    return (1, 0) if stage is None else (stage.size, stage.rank)


def local_name(name: str, num_layers: int, stage) -> "str | None":
    """A whole model's parameter ``name`` as stage ``stage`` names it
    (``layers.9.wq`` -> ``layers.1.wq`` on stage 1 of pp 2 over 16 layers),
    or None for a layer the stage does not hold; names outside the layer
    stack are every stage's."""
    pp, p = stage_place(stage)
    if pp == 1 or not name.startswith("layers."):
        return name
    _, i, leaf = name.split(".", 2)
    held = stage_range(num_layers, pp, p)
    return f"layers.{int(i) - held.start}.{leaf}" if int(i) in held else None


def microbatches(B: int, pp: int) -> int:
    """The microbatch count of a B-row step: M = min(B, 2 * pp), lowered
    until it divides B (``serving_layer_pipeline``'s rule)."""
    M = min(B, 2 * pp)
    while B % M:
        M -= 1
    return M


def stage_routes(picks: list, num_layers: int, stage) -> list:
    """A one-rank run's MoE routes (``picks``: [B, T, k] per layer and
    forward, every layer of a forward in order) in the order stage
    ``stage`` routes them: for each forward, each of its microbatches
    (``microbatches(B, pp)``), the stage's layers on the microbatch's rows.
    The picks themselves without a stage."""
    pp, p = stage_place(stage)
    if pp == 1:
        return list(picks)
    if len(picks) % num_layers:
        raise ValueError(f"{len(picks)} routed calls are not whole forwards of {num_layers} layers")
    held = stage_range(num_layers, pp, p)
    out = []
    for f in range(0, len(picks), num_layers):
        fwd = picks[f: f + num_layers]
        B = fwd[0].shape[0]
        n = B // microbatches(B, pp)
        for r in range(0, B, n):
            out += [fwd[i][r: r + n] for i in held]
    return out


def run(stage, B: int, inject: Callable, body: Callable, keep: Callable, out: torch.Tensor,
        act: tuple, M: "int | None" = None) -> torch.Tensor:
    """This stage's part of one pipelined pass over B rows in M microbatches
    (``microbatches(B, pp)`` by default) of n = B / M rows.

    - ``inject(rows)``: stage 0's input activations of a slice of rows;
    - ``body(x, rows)``: the stage's layers on microbatch ``x`` [n, ...];
    - ``keep(y, rows)``: what the last stage keeps of its output, written
      into ``out[rows]``;
    - ``act``: (shape after the rows, dtype) of an activation, the buffer a
      stage after the first receives into.

    ``out`` (every rank's, of one shape) holds the last stage's kept rows
    on every stage when this returns."""
    pp = stage.size
    M = M or microbatches(B, pp)
    n = B // M
    first, last = stage.rank == 0, stage.rank == pp - 1
    shape, dtype = act
    for m in range(M):
        rows = slice(m * n, (m + 1) * n)
        if first:
            x = inject(rows)
        else:
            x = stage.recv_prev(torch.empty((n, *shape), dtype=dtype, device=out.device))
        y = body(x, rows)
        if last:
            out[rows] = keep(y, rows)
        else:
            stage.send_next(y.contiguous())
    return stage.broadcast_from_last(out)


def gather_layer_param(own: dict, name: str, num_layers: int, stage) -> torch.Tensor:
    """Stage-split parameter ``name`` of the whole model (``layers.{i}.*``)
    from the stage that holds it, on every stage: each stage puts in its
    tensor of the same local index and an exact gather over the stage group
    (parallel/tp._exact_gather) joins them, of which the holder's is
    taken. ``own`` is the stage's ``named_parameters()``."""
    pp, _ = stage_place(stage)
    if pp == 1 or not name.startswith("layers."):
        return own[name]
    _, i, leaf = name.split(".", 2)
    per = num_layers // pp
    p, j = divmod(int(i), per)
    return gather_split(own[f"layers.{j}.{leaf}"].detach()[None], 0, stage)[p]
