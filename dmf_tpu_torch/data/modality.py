"""Per-modality batch processing: augmentation + normalization + ADC append.

Counterpart of ``dmf_tpu/data/modality.py``, without ``jit``: PyTorch runs the
same order eagerly on the processor's device (the card unless the caller
asks for the CPU): augment (train only) -> resize -> normalize -> append the
(un-augmented) ADC channel.  DWI normalisation is the hand-written kernel
behind :func:`~dmf_tpu_torch.ops.dwi_norm.dwi_normalize`; DCE runs the
:class:`~.preprocess.NyulStandardizer` transform.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import Config
from .augment import augment_batch, eval_resize
from .preprocess import NyulStandardizer, append_adc, dwi_normalize


class ModalityProcessor:
    """Device-side processing for one modality.

    ``adc_map`` (DWI only): the split's shared ADC map under reference
    compat (prepare_single_model.py:319-332); per-sample maps travel with
    their batch as ``adc`` instead.
    """

    def __init__(self, cfg: Config, method: str,
                 nyul: Optional[NyulStandardizer] = None,
                 adc_map: Optional[torch.Tensor] = None, device="cuda"):
        if method == "dce" and nyul is None:
            raise ValueError("DCE processing requires a fitted NyulStandardizer")
        self.cfg = cfg
        self.method = method
        self.nyul = nyul
        self.adc_map = adc_map
        self.device = torch.device(device)
        self.input_size = cfg.model_config(method).input_size

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def _finish(self, x: torch.Tensor, adc) -> torch.Tensor:
        if self.method == "dwi":
            # compat: skip+zero the last raw b-value channel (the reference's
            # effective behaviour); fixed: z-score every b-value channel (the
            # ADC channel is appended afterwards either way)
            compat = self.cfg.reference_compat
            x = dwi_normalize(x.contiguous(), skip_last=compat, zero_last=compat)
        else:
            x = self.nyul.transform(x)
        if adc is not None:
            return append_adc(x, self._dev(adc))
        if self.method == "dwi" and self.cfg.dwi_add_adc_map and self.adc_map is not None:
            return append_adc(x, self.adc_map)
        return x

    def train_batch(self, generator: torch.Generator, imgs, adc=None) -> torch.Tensor:
        """Augment, normalize and append ADC; ``generator`` lives on the device."""
        return self._finish(augment_batch(generator, self._dev(imgs), self.input_size), adc)

    def eval_batch(self, imgs, adc=None) -> torch.Tensor:
        return self._finish(eval_resize(self._dev(imgs), self.input_size), adc)

    def eval_split(self, imgs, adc=None, chunk: int = 256) -> np.ndarray:
        """Whole-split eval preprocessing in chunks of ``chunk`` volumes,
        bounding device residency; the tail chunk is padded with its last
        volume as the JAX processor pads it (modality.py:111-125)
        (normalisation is per sample, so padding never affects kept rows).
        Returns a host numpy array."""
        n = len(imgs)
        if n <= chunk:
            return self.eval_batch(imgs, adc=adc).cpu().numpy()
        outs = []
        for i in range(0, n, chunk):
            im = np.asarray(imgs[i:i + chunk])
            ad = np.asarray(adc[i:i + chunk]) if adc is not None else None
            k = len(im)
            if k < chunk:
                pad = chunk - k
                im = np.concatenate([im, np.repeat(im[-1:], pad, axis=0)])
                if ad is not None:
                    ad = np.concatenate([ad, np.repeat(ad[-1:], pad, axis=0)])
            outs.append(self.eval_batch(im, adc=ad)[:k].cpu().numpy())
        return np.concatenate(outs)
