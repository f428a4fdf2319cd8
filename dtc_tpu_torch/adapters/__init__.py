"""Multi-tenant LoRA adapters for the port: factors, the resident stack
and its registry, the merge oracle, the artifact and the finetune leg (the
JAX package's ``dtc_tpu.adapters``).

- :mod:`~dtc_tpu_torch.adapters.lora`: factor shapes, initialisation, the
  serving stack, validation, ``merge_lora``, the ``.npz`` artifact;
- :mod:`~dtc_tpu_torch.adapters.store`: the LRU + refcounted registry of
  the stack's slots (slot 0 pinned to base);
- :mod:`~dtc_tpu_torch.adapters.finetune`: ``finetune_adapter`` (train,
  eval gate) and its CLI, ``python -m dtc_tpu_torch.adapters.finetune``
  (not imported here, so that ``-m`` runs it as the main module).

The site math (:func:`~dtc_tpu_torch.models.gpt.apply_lora`) and the
per-row gather from the stack (``gather_slot_lora``) live with the model.
"""

from dtc_tpu_torch.adapters.lora import (
    init_lora,
    init_lora_stack,
    load_adapter_file,
    lora_enabled,
    lora_shapes,
    merge_lora,
    save_adapter,
    validate_lora_tree,
)
from dtc_tpu_torch.adapters.store import BASE_SLOT, AdapterStore
from dtc_tpu_torch.models.gpt import apply_lora, gather_slot_lora

__all__ = [
    "AdapterStore",
    "BASE_SLOT",
    "apply_lora",
    "gather_slot_lora",
    "init_lora",
    "init_lora_stack",
    "load_adapter_file",
    "lora_enabled",
    "lora_shapes",
    "merge_lora",
    "save_adapter",
    "validate_lora_tree",
]
