"""Multi-LoRA adapter manager of the port (the JAX engine's engine/lora.py,
in its own copy).

The reference stack reaches LoRA through vLLM's ``--enable-lora`` and the
``/v1/load_lora_adapter`` / ``/v1/unload_lora_adapter`` routes that its
``LoraAdapter`` operator controller drives. Here:

- Adapters live in the runner's slot-stacked device buffers
  (``models.llama.init_lora_buffers``), so one forward serves a batch that
  mixes any loaded adapters (each row gathers its slot's A and B).
- ``read_checkpoint`` parses a PEFT directory (``adapter_config.json`` and
  ``adapter_model.safetensors``, read with utils/safetensors_io.py), maps
  HF module names to the port's projection names, pads the rank to the
  configured maximum, and refuses what it would apply only in part.
- ``load_parsed`` writes a free slot; slot 0 is the base model and stays
  all zero. The runner may be an engine's ranks behind the step stream
  (engine/distributed.py): the whole adapter goes to every rank as numpy
  arrays, and each keeps its part (engine/runner.set_lora_slot). Each load versions the adapter's prefix-cache salt
  (``lora:{name}:{gen}``), so a reload under the same name never matches
  pages cached under the old weights.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional

import torch

from production_stack_tpu_torch.models.llama import lora_dims
from production_stack_tpu_torch.utils.arrays import numpy_from_tensor
from production_stack_tpu_torch.utils.logging import init_logger
from production_stack_tpu_torch.utils.safetensors_io import SafetensorsDir, save_file

logger = init_logger(__name__)

ADAPTER_CONFIG = "adapter_config.json"
ADAPTER_WEIGHTS = "adapter_model.safetensors"

# HF/PEFT module name -> the port's projection name
_HF_TO_LEAF = {
    "q_proj": "wq",
    "k_proj": "wk",
    "v_proj": "wv",
    "o_proj": "wo",
    "gate_proj": "w_gate",
    "up_proj": "w_up",
    "down_proj": "w_down",
}
_LEAF_TO_HF = {v: k for k, v in _HF_TO_LEAF.items()}


def lora_targets(modules: str) -> tuple[str, ...]:
    """``--lora-target-modules`` (comma-separated HF module names) as the
    port's projection names, refusing an unknown module as the JAX engine
    does."""
    mods = [m.strip() for m in modules.split(",") if m.strip()]
    bad = [m for m in mods if m not in _HF_TO_LEAF]
    if bad:
        raise ValueError(f"unknown --lora-target-modules {bad}; valid: {sorted(_HF_TO_LEAF)}")
    return tuple(_HF_TO_LEAF[m] for m in mods)


class LoRAError(ValueError):
    pass


class LoRAManager:
    """Adapter name -> slot, and the writes of adapter weights into the
    runner's buffers. The HTTP side loads and unloads while requests
    resolve and pin slots: every map below is guarded by one lock. The slot
    writes themselves run on the engine loop's thread (LLMEngine._lora_cmd),
    never under a running step."""

    def __init__(self, runner, *, max_loras: int = 4, max_rank: int = 16):
        self.runner = runner
        self.max_loras = max_loras  # adapters at once (slot 0, the base, comes on top)
        self.max_rank = max_rank
        self._lock = threading.Lock()
        self._slots: dict[str, int] = {}  # guarded-by: _lock
        self._gen = 0  # bumped per load: versions the prefix-cache salt
        self._salt_gen: dict[str, int] = {}  # guarded-by: _lock
        self._refs: dict[int, int] = {}  # guarded-by: _lock; in-flight requests per slot

    # -- queries -------------------------------------------------------------

    def list_adapters(self) -> list[str]:
        with self._lock:
            return sorted(self._slots)

    def slot_for(self, name: Optional[str]) -> int:
        """A request's model name as an adapter slot (0 = base)."""
        if not name:
            return 0
        with self._lock:
            return self._slots.get(name, 0)

    def is_adapter(self, name: str) -> bool:
        with self._lock:
            return name in self._slots

    def acquire(self, name: str) -> tuple[int, bytes]:
        """Resolve an adapter for a request and pin its slot (counted), in
        one step under the lock, so unload can neither clear nor re-target
        it while the request is in flight. Pair with ``release``. Returns
        (slot, prefix-cache salt)."""
        with self._lock:
            slot = self._slots.get(name)
            if slot is None:
                raise LoRAError(f"LoRA adapter {name!r} is not loaded")
            self._refs[slot] = self._refs.get(slot, 0) + 1
            return slot, f"lora:{name}:{self._salt_gen[name]}".encode()

    def release(self, slot: int) -> None:
        with self._lock:
            n = self._refs.get(slot, 0) - 1
            if n > 0:
                self._refs[slot] = n
            else:
                self._refs.pop(slot, None)

    def has_free_slot(self) -> bool:
        with self._lock:
            return len(self._slots) < self.max_loras

    def cache_salt(self, name: str) -> bytes:
        """The adapter's prefix-cache salt, versioned per load (b"" when it
        is not loaded)."""
        with self._lock:
            gen = self._salt_gen.get(name)
        return b"" if gen is None else f"lora:{name}:{gen}".encode()

    # -- load / unload -------------------------------------------------------

    def load(self, name: str, path: str) -> int:
        """Parse a PEFT adapter directory and load it into a free slot."""
        tensors, scale = self.read_checkpoint(path)
        return self.load_parsed(name, tensors, scale)

    def load_parsed(self, name: str, tensors: dict, scale: float) -> int:
        """Write parsed adapter weights into a free slot; returns the slot."""
        with self._lock:
            if name in self._slots:
                raise LoRAError(f"adapter {name!r} is already loaded")
            used = set(self._slots.values())
            free = [s for s in range(1, self.max_loras + 1) if s not in used]
            if not free:
                raise LoRAError(
                    f"no free LoRA slots (max_loras={self.max_loras}, loaded={sorted(self._slots)})"
                )
            slot = free[0]
            # numpy arrays: with ranks the call crosses the step stream,
            # whose codec carries arrays and plain values only
            self.runner.set_lora_slot(slot, {k: numpy_from_tensor(v) for k, v in tensors.items()}, scale)
            self._gen += 1
            self._salt_gen[name] = self._gen
            self._slots[name] = slot
            logger.info("loaded LoRA adapter %r into slot %d", name, slot)
            return slot

    def unload(self, name: str, in_use: bool = False) -> None:
        """Unload an adapter. Refused while requests hold its slot (the
        ``acquire`` count, or the caller's ``in_use``: a scheduler scan)."""
        with self._lock:
            slot = self._slots.get(name)
            if slot is None:
                raise LoRAError(f"adapter {name!r} is not loaded")
            if in_use or self._refs.get(slot, 0) > 0:
                raise LoRAError(f"adapter {name!r} has in-flight requests; retry when drained")
            del self._slots[name]
            self._salt_gen.pop(name, None)
            self.runner.clear_lora_slot(slot)
            logger.info("unloaded LoRA adapter %r (slot %d)", name, slot)

    # -- PEFT checkpoints ----------------------------------------------------

    def read_checkpoint(self, path: str) -> tuple[dict, float]:
        """``adapter_config.json`` and ``adapter_model.safetensors`` as
        per-target f32 CPU tensors ``{"a_<t>": [L, in, R], "b_<t>": [L, R,
        out]}`` (PEFT's [r, in] / [out, r] transposed, the rank zero-padded
        to the maximum), and the scale ``alpha / r``."""
        cfg_path = os.path.join(path, ADAPTER_CONFIG)
        if not os.path.isfile(cfg_path):
            raise LoRAError(f"no {ADAPTER_CONFIG} in {path}")
        with open(cfg_path) as f:
            acfg = json.load(f)
        r = int(acfg.get("r", 8))
        alpha = float(acfg.get("lora_alpha", r))
        if r > self.max_rank:
            raise LoRAError(f"adapter rank {r} exceeds max_lora_rank {self.max_rank}")
        if not os.path.isfile(os.path.join(path, ADAPTER_WEIGHTS)):
            raise LoRAError(f"no {ADAPTER_WEIGHTS} in {path}")
        st = SafetensorsDir(path, files=(ADAPTER_WEIGHTS,))
        raw = {key: st.get(key) for key in st.keys()}

        cfg = self.runner.cfg
        targets = self.runner.lora_targets
        L, R = cfg.num_layers, self.max_rank
        dims = lora_dims(cfg)
        # an adapter that targets modules not applied here is refused:
        # dropping trained deltas would serve another model than was trained
        enabled_hf = {_LEAF_TO_HF[t] for t in targets}
        in_ckpt = {key.split(".")[-3] for key in raw if key.endswith(".lora_A.weight")}
        extra = in_ckpt - enabled_hf
        if extra:
            raise LoRAError(
                f"adapter targets {sorted(extra)} but only {sorted(enabled_hf)} "
                f"are enabled (--lora-target-modules); refusing partial application"
            )
        out: dict[str, torch.Tensor] = {}
        present = set()
        for t in targets:
            din, dout = dims[t]
            a = torch.zeros((L, din, R), dtype=torch.float32)
            b = torch.zeros((L, R, dout), dtype=torch.float32)
            hf = _LEAF_TO_HF[t]
            for layer in range(L):
                ka = _find_tensor(raw, layer, hf, "lora_A")
                kb = _find_tensor(raw, layer, hf, "lora_B")
                if ka is None or kb is None:
                    continue
                present.add(t)
                wa, wb = raw[ka], raw[kb]  # PEFT: lora_A [r, in], lora_B [out, r]
                if tuple(wa.shape) != (r, din) or tuple(wb.shape) != (dout, r):
                    raise LoRAError(
                        f"layer {layer} {hf}: expected A {(r, din)} / B {(dout, r)}, "
                        f"got {tuple(wa.shape)} / {tuple(wb.shape)}"
                    )
                a[layer, :, :r] = wa.t().float()
                b[layer, :r, :] = wb.t().float()
            out["a_" + t] = a
            out["b_" + t] = b
        if not present:
            raise LoRAError(
                f"adapter in {path} targets none of the enabled modules {[_LEAF_TO_HF[t] for t in targets]}"
            )
        return out, alpha / r


def _find_tensor(raw: dict, layer: int, hf_name: str, ab: str) -> Optional[str]:
    """A PEFT tensor's key, whichever prefix it carries
    (``base_model.model.model.layers.N...`` or ``model.layers.N...``)."""
    needle = f".layers.{layer}."
    suffix_attn = f".self_attn.{hf_name}.{ab}.weight"
    suffix_mlp = f".mlp.{hf_name}.{ab}.weight"
    for key in raw:
        if needle in key and (key.endswith(suffix_attn) or key.endswith(suffix_mlp)):
            return key
    return None


def save_peft_adapter(path: str, cfg, rank: int, alpha: float, tensors: dict) -> None:
    """Write a PEFT-format adapter directory. ``tensors`` maps a projection
    name to (A [L, r, in], B [L, out, r]) in PEFT's orientation (numpy or
    torch); they are written as f32."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, ADAPTER_CONFIG), "w") as f:
        json.dump(
            {
                "peft_type": "LORA",
                "r": rank,
                "lora_alpha": alpha,
                "target_modules": sorted(_LEAF_TO_HF[t] for t in tensors),
                "task_type": "CAUSAL_LM",
            },
            f,
        )
    flat: dict[str, torch.Tensor] = {}
    for t, (a, b) in tensors.items():
        hf = _LEAF_TO_HF[t]
        group = "mlp" if t in ("w_gate", "w_up", "w_down") else "self_attn"
        for layer in range(a.shape[0]):
            base = f"base_model.model.model.layers.{layer}.{group}.{hf}"
            flat[f"{base}.lora_A.weight"] = torch.as_tensor(a[layer]).float().contiguous()
            flat[f"{base}.lora_B.weight"] = torch.as_tensor(b[layer]).float().contiguous()
    save_file(os.path.join(path, ADAPTER_WEIGHTS), flat)
