"""Single-modality preparation: raw tensors -> splits, processors, model.

Counterpart of ``dmf_tpu/pipeline/prepare_single.py``: per-modality raw prep
(ADC maps for DWI, the global max normalisation for DCE), nearest mask
resize and the stratified split, the Nyul fit on the train split, and the
processed ``.npz`` splits that fusion training reads.  The arrays of a split
stay on the host (numpy), as in the JAX package; the work on them runs on
``device``, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..config import Config, resolve_backbone_config
from ..data.modality import ModalityProcessor
from ..data.preprocess import NyulStandardizer, dce_global_max_normalize, prep_dwi_adc_maps
from ..data.splits import train_val_indices
from ..data.synthetic import make_synthetic_arrays
from ..models.backbones.registry import pretrained_state_dict
from ..models.backbones.vit import ViTSize
from ..models.build import init_weights
from ..models.encoder import Encoder
from ..ops.resize import resize_nearest


@dataclass
class SingleModelData:
    """Raw per-split arrays + processors for one modality/fold."""

    method: str
    fold: int
    splits: Dict[str, Dict[str, Optional[np.ndarray]]]  # train/val/test
    processor: ModalityProcessor
    processors_by_split: Dict[str, ModalityProcessor]
    nyul: Optional[NyulStandardizer]
    train_labels: np.ndarray


def load_raw_tensors(cfg: Config, method: str) -> Dict[str, np.ndarray]:
    """Load the raw tensor store under ``cfg.base_path``.

    ``<method>_tensordata.npz`` (channels-last), else the reference's ``.pth``
    tensors (NCHW, transposed on load; flat or one directory per store,
    parameters_generate.py:290-296), else synthetic data, since the Kaggle
    tensors are not distributed.
    """
    base = cfg.base_path
    npz = os.path.join(base, f"{method}_tensordata.npz")
    if os.path.exists(npz):
        with np.load(npz) as d:
            return {k: d[k] for k in d.files}

    def find_pth(stem: str) -> Optional[str]:
        for p in (os.path.join(base, f"{stem}.pth"), os.path.join(base, stem, f"{stem}.pth")):
            if os.path.exists(p):
                return p
        return None

    if find_pth(f"{method}_tensordata") is not None:
        def load(stem):
            return torch.load(find_pth(stem), map_location="cpu")

        def nhwc(t):
            return t.float().numpy().transpose(0, 2, 3, 1)

        return {
            "imgs": nhwc(load(f"{method}_tensordata")),
            "test_imgs": nhwc(load(f"{method}_test_tensordata")),
            "labels": load("labels_tensordata").numpy(),
            "test_labels": load("labels_test_tensordata").numpy(),
            "masks": nhwc(torch.load(os.path.join(base, "masks/mask.pth"), map_location="cpu")),
        }
    raw = make_synthetic_arrays(seed=cfg.seed)
    key = "dwi" if method == "dwi" else "dce"
    return {"imgs": raw[key], "test_imgs": raw[f"{key}_test"],
            "labels": raw["labels"], "test_labels": raw["labels_test"],
            "masks": raw["masks"]}


def prepare_single_data(cfg: Config, method: str, fold: int,
                        raw: Optional[Dict[str, np.ndarray]] = None,
                        device="cuda") -> SingleModelData:
    """Split + fit normalizers for one (method, fold); the work runs on ``device``."""
    raw = raw or load_raw_tensors(cfg, method)
    imgs, test_imgs = raw["imgs"], raw["test_imgs"]
    labels, test_labels = raw["labels"], raw["test_labels"]
    mc = cfg.model_config(method)
    tr, va = train_val_indices(labels, cfg.segnum, cfg.class_num, fold, cfg.seed)

    # modality-specific raw prep (prepare_single_model.py:311-343)
    adc_maps: List[Optional[torch.Tensor]] = [None, None, None]
    adc_splits: List[Optional[np.ndarray]] = [None, None, None]
    nyul = None
    if method == "dwi" and cfg.dwi_add_adc_map:
        adc_maps = prep_dwi_adc_maps(imgs, test_imgs, cfg.dwi_bvals_to_use,
                                     cfg.reference_compat, device)
        # compat: one map per split from raw samples 0/1/test0, before the
        # split; corrected: per-sample maps travel with their samples
        if not cfg.reference_compat:
            all_train = adc_maps[0].cpu().numpy()
            adc_splits = [all_train[tr], all_train[va], adc_maps[2].cpu().numpy()]
            adc_maps = [None, None, None]
    elif method == "dce":
        imgs, test_imgs = (dce_global_max_normalize(
            torch.as_tensor(a, dtype=torch.float32, device=device)).cpu().numpy()
            for a in (imgs, test_imgs))

    # masks -> mask_target_size (nearest), split with images
    masks = raw.get("masks")
    mask_splits: List[Optional[np.ndarray]] = [None, None, None]
    if mc.mask.enabled and masks is not None:
        target = tuple(mc.mask.mask_target_size)
        if masks.shape[1:3] != target:
            masks = resize_nearest(torch.as_tensor(masks, device=device), target).cpu().numpy()
        mask_splits = [masks[tr], masks[va], None]  # test masks don't exist

    splits = {
        "train": {"imgs": imgs[tr], "masks": mask_splits[0], "labels": labels[tr],
                  "adc": adc_splits[0]},
        "val": {"imgs": imgs[va], "masks": mask_splits[1], "labels": labels[va],
                "adc": adc_splits[1]},
        "test": {"imgs": test_imgs, "masks": None, "labels": test_labels,
                 "adc": adc_splits[2]},
    }

    # Nyul fit on the raw (max-normalized) train split, or its saved landmarks
    if method == "dce":
        nyul = NyulStandardizer()
        nyul_path = os.path.join(cfg.base_path, "nyul_landmarks.npy")
        if os.path.exists(nyul_path):
            try:
                nyul.load(nyul_path)
            except (OSError, ValueError, KeyError, EOFError, pickle.UnpicklingError):
                pass  # unreadable: fit anew and overwrite
        if not nyul.fitted:
            nyul.fit(splits["train"]["imgs"])
            try:
                os.makedirs(cfg.base_path, exist_ok=True)
                nyul.save(nyul_path)
            except OSError:
                pass

    per_split = {name: ModalityProcessor(cfg, method, nyul=nyul, adc_map=adc_maps[i],
                                         device=device)
                 for i, name in enumerate(("train", "val", "test"))}
    return SingleModelData(method=method, fold=fold, splits=splits,
                           processor=per_split["train"], processors_by_split=per_split,
                           nyul=nyul, train_labels=splits["train"]["labels"])


def build_single_model(cfg: Config, method: str, pretrained_path: Optional[str] = None,
                       dtype: torch.dtype = torch.float32, device="cuda",
                       generator: Optional[torch.Generator] = None,
                       backbone_layers: Union[Sequence[int], ViTSize] = (3, 4, 6, 3)):
    """The single-modality encoder on seeded random weights, its backbone
    from ``pretrained_path`` when one is given (a local timm / resnet50d /
    RadImageNet ResNet-50 or timm ViT-B/16 / DINO checkpoint, imported by
    :func:`~dmf_tpu_torch.models.backbones.registry.pretrained_state_dict`).

    Returns ``(model, resolved_cfg)``; the module holds its weights (the JAX
    function returns its variables beside the module).  ``generator`` lives
    on ``device`` (default: seeded with ``cfg.seed``).  The import is loaded
    after the seeded draw, which redraws every conv and BatchNorm.
    """
    mc = cfg.model_config(method)
    if mc.use_backbone:
        mc = resolve_backbone_config(mc)
    if generator is None:
        generator = torch.Generator(device).manual_seed(cfg.seed)
    model = Encoder(method, mc, cfg.channel_num(method), cfg.class_num, backbone_layers,
                    device=device, dtype=dtype)
    init_weights(model, generator)
    if mc.use_backbone and pretrained_path:
        model.backbone.load_state_dict(
            pretrained_state_dict(mc, cfg.channel_num(method), pretrained_path))
    if torch.device(device).type == "cuda":
        model.to(memory_format=torch.channels_last)
    resolved = (dataclasses.replace(cfg, **{f"{method}_model": mc})
                if method in ("dwi", "dce") else cfg)
    return model, resolved


def save_processed_split(path: str, imgs: np.ndarray, masks: Optional[np.ndarray],
                         labels: Optional[np.ndarray]) -> None:
    """Processed-split cache for fusion reuse (prepare_single_model.py:259-265)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    data = {"imgs": imgs}
    if masks is not None:
        data["masks"] = masks
    if labels is not None:
        data["labels"] = labels
    np.savez(path, **data)


def load_processed_split(path: str) -> Dict[str, np.ndarray]:
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def export_processed_splits(cfg: Config, data: SingleModelData,
                            generator: Optional[torch.Generator] = None) -> Dict[str, str]:
    """Process every split once and write it to
    ``<base_path>/processed/<method><fold><split>data.npz``.

    Under ``reference_compat`` the train split is one frozen augmentation
    drawn from ``generator`` (on the processors' device; default seeded 0),
    the reference's quirk (prepare_single_model.py:154-174); val and test
    take the eval pipeline.  Returns the paths by split.
    """
    out = {}
    for split, arrays in data.splits.items():
        proc = data.processors_by_split[split]
        adc = arrays.get("adc")
        if split == "train" and cfg.reference_compat:
            if generator is None:
                generator = torch.Generator(proc.device).manual_seed(0)
            imgs = proc.train_batch(generator, arrays["imgs"], adc=adc).cpu().numpy()
        else:
            imgs = proc.eval_split(arrays["imgs"], adc=adc)
        path = os.path.join(cfg.base_path, "processed", f"{data.method}{data.fold}{split}data")
        dwi = data.method == "dwi"
        save_processed_split(path, imgs, arrays.get("masks") if dwi else None,
                             arrays.get("labels") if dwi else None)
        out[split] = path + ".npz"
    return out
