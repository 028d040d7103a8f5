"""Train state, counterpart of ``dmf_tpu/train/state.py``: the model (its
parameters and BatchNorm statistics), the AdamW moments, the per-group step
counts and the global step."""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn

from .optim import AdamWState, adamw_init


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    opt_state: AdamWState
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, num_groups: int = 3) -> "TrainState":
        return cls(model=model, opt_state=adamw_init(dict(model.named_parameters()),
                                                     num_groups))

    def copy(self) -> "TrainState":
        """An independent copy on the same device (the best-epoch snapshot)."""
        return TrainState(model=copy.deepcopy(self.model),
                          opt_state=copy.deepcopy(self.opt_state), step=self.step)

    def state_dict(self) -> Dict[str, Any]:
        o = self.opt_state
        return {"model": self.model.state_dict(), "mu": o.mu, "nu": o.nu,
                "count": torch.from_numpy(o.count.copy()), "step": self.step}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.model.load_state_dict(sd["model"])
        with torch.no_grad():
            for name, t in self.opt_state.mu.items():
                t.copy_(sd["mu"][name])
                self.opt_state.nu[name].copy_(sd["nu"][name])
        self.opt_state.count = torch.as_tensor(sd["count"]).cpu().numpy().astype(np.int64)
        self.step = int(sd["step"])
