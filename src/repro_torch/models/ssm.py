"""Mamba2 SSD configuration: the port of ``repro.models.ssm``'s
``SSMConfig``, which ``repro_torch.configs.base`` needs. The blocks
themselves (chunked SSD, decode step) are a later slice;
``repro_torch.models.transformer`` refuses SSM and hybrid configs."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    chunk: int = 256
    n_groups: int = 1
    d_conv: int = 4

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.headdim
