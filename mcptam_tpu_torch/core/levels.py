"""Pyramid-level coordinate helpers (port of mcptam_tpu/core/levels.py,
ref include/mcptam/LevelHelpers.h:55-97): level-N pixel centres sit at
``(p0 + 0.5) / 2^n - 0.5``."""

from __future__ import annotations

import torch


def _scale(level, like: torch.Tensor):
    if isinstance(level, torch.Tensor):
        return torch.exp2(level.to(torch.float32))
    return torch.full((), 2.0 ** float(level), device=like.device)


def level_zero_pos(pos_level: torch.Tensor, level) -> torch.Tensor:
    """Level-N coords -> level-0 coords."""
    pos = pos_level.to(torch.float32)
    return (pos + 0.5) * _scale(level, pos) - 0.5


def level_n_pos(pos_l0: torch.Tensor, level) -> torch.Tensor:
    """Level-0 coords -> level-N coords."""
    pos = pos_l0.to(torch.float32)
    return (pos + 0.5) / _scale(level, pos) - 0.5
