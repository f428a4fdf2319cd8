"""Speculative decoding: a draft rung of the target's bottom layers
proposes, the target verifies a window of ``spec_k`` tokens in one launch,
and greedy (or Leviathan) acceptance keeps the output exact."""

from dtc_tpu_torch.spec.core import check_spec_backend, spec_generate, spec_round
from dtc_tpu_torch.spec.draft import draft_config, extract_draft

__all__ = [
    "check_spec_backend", "draft_config", "extract_draft", "spec_generate",
    "spec_round",
]
