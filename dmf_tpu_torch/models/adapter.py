"""Backbone feature adapter (NCHW), counterpart of ``dmf_tpu/models/adapter.py``.

Concatenates the selected backbone features per chain and passes each
through a 2 x (3x3 conv + BN + GELU) neck (reference model_module.py:401-476),
named ``necks.f{i}.{0,1,3,4}`` as the reference checkpoint has them
(ref_ckpt.py:516-522).  In eval every neck stage is one call to
:func:`~dmf_tpu_torch.ops.conv3x3.conv3x3_bn_gelu`; ``train=True`` runs the
conv, the batch-statistics BatchNorm and the GELU as three modules, the JAX
adapter's training route (adapter.py:73-76).

Unlike the JAX module, the adapter takes the backbone's features rather than
the backbone: the encoder owns the backbone once, so the port's state dict
carries it under ``backbone.`` only (the reference serializes a second alias
under ``backbone_adapter.backbone.``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from ..ops.conv3x3 import conv3x3_bn_gelu
from .layers import BatchNorm2d, run


class BackboneAdapter(nn.Module):
    def __init__(self, feature_dims: Sequence[int],
                 selected_indices_chains: Sequence[Sequence[int]],
                 out_channels: Tuple[int, int, int], **kw):
        super().__init__()
        self.chains = tuple(tuple(c) for c in selected_indices_chains)
        necks = {}
        for i, chain in enumerate(self.chains):
            cin = sum(feature_dims[j] for j in chain)
            cout = out_channels[i]
            necks[f"f{i + 1}"] = nn.Sequential(
                nn.Conv2d(cin, cout, 3, padding=1, **kw), BatchNorm2d(cout, **kw),
                nn.GELU(),
                nn.Conv2d(cout, cout, 3, padding=1, **kw), BatchNorm2d(cout, **kw),
                nn.GELU())
        self.necks = nn.ModuleDict(necks)

    def forward(self, feats: Sequence[torch.Tensor], train: bool = False):
        outputs = []
        for i, chain in enumerate(self.chains):
            out = torch.cat([feats[j] for j in chain], dim=1)
            if out.is_cuda:
                out = out.contiguous(memory_format=torch.channels_last)
            neck = self.necks[f"f{i + 1}"]
            if train:
                outputs.append(run(neck, out, True))
                continue
            for conv, bn in ((neck[0], neck[1]), (neck[3], neck[4])):
                out = conv3x3_bn_gelu(out, conv.weight, conv.bias, bn.weight,
                                      bn.bias, bn.running_mean, bn.running_var,
                                      bn.eps)
            outputs.append(out)
        return tuple(outputs)
