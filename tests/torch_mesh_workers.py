"""Rank programs of the data-mesh tests (``test_torch_mesh*.py``).

:func:`spawn` runs one of :data:`JOBS` on N gloo ranks on the CPU, each a
process of its own (``torch.multiprocessing.spawn``) that joins a process
group through a ``file://`` store under the test's temporary directory (so
that pytest-xdist workers never share a port) and builds
``make_mesh(N, 1, devices="cpu")``.  The jobs import the port alone; each
also runs with ``mesh=None``, the single-process run the tests hold the
mesh's against.
"""

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def spawn(tmp, world, job, **payload):
    """``JOBS[job](mesh, **payload)`` on ``world`` ranks; returns each
    rank's result."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    torch.save(payload, os.path.join(tmp, "payload.pt"))
    mp.spawn(_rank_main, args=(world, tmp, job), nprocs=world, join=True)
    return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
            for r in range(world)]


def _rank_main(rank, world, tmp, job):
    # the parent's pool (test_torch_helpers): the CPU convs' sums then run in
    # the same order, and a fold stepped here is bit-equal to the parent's
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(tmp, "store"),
                           rank=rank, world_size=world)
    try:
        from dmf_tpu_torch.parallel import make_mesh

        mesh = make_mesh(world, 1, devices="cpu")
        payload = torch.load(os.path.join(tmp, "payload.pt"), weights_only=False)
        out = JOBS[job](mesh, **payload)
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


def floats(metrics):
    return {k: float(v) for k, v in metrics.items()}


def model_state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def tensors(batch):
    return {k: torch.as_tensor(v) if k != "aux_w" else v for k, v in batch.items()}


# ---------------------------------------------------------------- train steps
def steps(mesh, kind, cfg, model, batches, hp, train_labels, seed=5):
    """``make_spmd_step`` of the fusion (``kind="fusion"``, a
    ``FusionNetwork``) or the DWI train step over ``batches`` (global ones),
    dropout from one generator seeded ``seed``: each step's metrics and the
    final model state (parameters and BatchNorm statistics)."""
    from dmf_tpu_torch.losses import get_classification_loss_fn, get_mask_loss_fn
    from dmf_tpu_torch.parallel import make_spmd_step, shard_state
    from dmf_tpu_torch.train import TrainState
    from dmf_tpu_torch.train.fusion import make_fusion_train_step
    from dmf_tpu_torch.train.optim import build_fusion_group_spec, build_group_spec
    from dmf_tpu_torch.train.single import make_single_train_step

    names = [n for n, _ in model.named_parameters()]
    method = "fusion" if kind == "fusion" else "dwi"
    clf = get_classification_loss_fn(cfg, train_labels, method)
    mask = get_mask_loss_fn(cfg, method)
    if kind == "fusion":
        state = TrainState.create(model, num_groups=4)
        step = make_fusion_train_step(cfg, clf, mask, build_fusion_group_spec(names, cfg))
    else:
        state = TrainState.create(model)
        spec = build_group_spec(names, cfg.dwi_model.use_backbone, cfg.reference_compat)
        step = make_single_train_step(cfg, "dwi", clf, mask, spec)
    if mesh is not None:
        shard_state(state, mesh)
        step = make_spmd_step(step, mesh)
    g = torch.Generator().manual_seed(seed)
    metrics = [floats(step(state, tensors(b), g, hp)) for b in batches]
    return {"metrics": metrics, "state": model_state(model)}


# ---------------------------------------------------------------- predictors
def predict(mesh, cfg, models, requests, cases, seed=3):
    """The fusion predictor (``mesh=``) on each request (``(dwi, dce)``
    NHWC batches) in each case ``(mode, int8)``: ``(mean, std, aux)``; the
    int8 forward quantizes on the first request's volumes."""
    from dmf_tpu_torch.evals.predict import make_fusion_predictor
    from dmf_tpu_torch.ops.quant import make_quantized_fusion_apply, make_quantized_fusion_fwd

    d, c, f = models
    out = {}
    for mode, int8 in cases:
        fwd = None
        if int8:
            _, qsets = make_quantized_fusion_apply(d, c, f, calibration=requests[0],
                                                   calibration_mc=False)
            fwd = make_quantized_fusion_fwd(d, c, f, qsets)
        predictor = make_fusion_predictor(cfg, d, c, f, mode=mode, fwd_override=fwd,
                                          mesh=mesh)
        g = torch.Generator().manual_seed(seed)
        out[(mode, int8)] = [predictor(torch.as_tensor(x), torch.as_tensor(y), g)
                             for x, y in requests]
    return out


# ---------------------------------------------------------------- the fold axis
def multifold(mesh, cfg, models, batches, hp, train_labels):
    """``make_multifold_step(mesh=)`` of the DWI step over K fold models and
    one batch each, each fold's dropout from a generator seeded 7 + fold:
    the stacked metrics and every fold's model state (the ones this rank
    stepped, others as given)."""
    from dmf_tpu_torch.losses import get_classification_loss_fn, get_mask_loss_fn
    from dmf_tpu_torch.parallel import make_multifold_step, stack_fold_states
    from dmf_tpu_torch.train import TrainState
    from dmf_tpu_torch.train.optim import build_group_spec
    from dmf_tpu_torch.train.single import make_single_train_step

    names = [n for n, _ in models[0].named_parameters()]
    spec = build_group_spec(names, cfg.dwi_model.use_backbone, cfg.reference_compat)
    raw = make_single_train_step(cfg, "dwi", get_classification_loss_fn(cfg, train_labels, "dwi"),
                                 get_mask_loss_fn(cfg, "dwi"), spec)
    states = stack_fold_states([TrainState.create(m) for m in models])
    gens = [torch.Generator().manual_seed(7 + i) for i in range(len(models))]
    metrics = make_multifold_step(raw, mesh=mesh)(states, [tensors(b) for b in batches],
                                                  gens, hp)
    return {"metrics": {k: v.clone() for k, v in metrics.items()},
            "states": [model_state(m) for m in models],
            "owned": list(mesh.folds(len(models))) if mesh is not None else None}


# ---------------------------------------------------------------- fits
class IdentityProcessor:
    """A processor whose train and eval transforms are the identity (the
    two packages' augmentations draw from different random streams)."""

    def train_batch(self, generator, imgs, adc=None):
        return torch.as_tensor(imgs)

    def eval_split(self, imgs, adc=None):
        return np.asarray(imgs)


def fit(mesh, kind, cfg, model, train, val, workdir, epochs=2, processor=None):
    """``fit_fusion`` (``kind="fusion"``, a ``FusionNetwork``) or
    ``fit_single("dwi")`` with ``mesh=``, ``viz_every=0``: the history
    (wall times aside), the final model state and the files rank 0 wrote;
    also the error of a batch size that does not divide over the mesh."""
    from dmf_tpu_torch.train import SingleModelOptController, TrainState, fit_fusion, fit_single

    workdir = os.path.join(workdir, "mesh" if mesh is not None else "single")
    kw = dict(num_epochs=epochs, min_epochs=1, viz_every=0, mesh=mesh)
    if kind == "fusion":
        res = fit_fusion(cfg, TrainState.create(model, num_groups=4), train, val, workdir, **kw)
    else:
        res = fit_single(cfg, "dwi", TrainState.create(model), train, val,
                         processor or IdentityProcessor(), SingleModelOptController(cfg, "dwi"),
                         workdir, **kw)
    error = None
    if mesh is not None and mesh.n_data > 1:
        try:
            fit_fusion(cfg.replace(batch_size=mesh.n_data + 1), TrainState.create(model, 4),
                       train, val, workdir, **kw)
        except ValueError as e:
            error = str(e)
    history = [{k: v for k, v in h.items() if not k.endswith("_time")} for h in res.history]
    files = sorted(os.path.relpath(os.path.join(r, f), workdir)
                   for r, _, fs in os.walk(workdir) for f in fs)
    with open(os.path.join(workdir, "logs", "metrics.jsonl")) as fh:
        log_lines = len(fh.readlines())
    return {"history": history, "state": model_state(res.state.model), "error": error,
            "files": files, "log_lines": log_lines,
            "best": None if res.best_state is None else model_state(res.best_state.model)}


def multifold_fit(mesh, cfg, models, folds, workdir, epochs=2):
    """``fit_single_multifold(mesh=)`` of K fold models (``folds``: a
    (train, val) pair each): every fold's history (wall times aside), final
    and best model states, on every rank."""
    from dmf_tpu_torch.train import SingleModelOptController, TrainState
    from dmf_tpu_torch.train.multifold_loop import fit_single_multifold

    workdir = os.path.join(workdir, "mesh" if mesh is not None else "single")
    fits = fit_single_multifold(
        cfg, "dwi", [TrainState.create(m) for m in models], [t for t, _ in folds],
        [v for _, v in folds], [IdentityProcessor() for _ in folds],
        [SingleModelOptController(cfg, "dwi") for _ in folds],
        [os.path.join(workdir, f"fold{i}") for i in range(len(folds))], num_epochs=epochs,
        min_epochs=1, mesh=mesh)
    return [{"history": [{k: v for k, v in h.items() if not k.endswith("_time")}
                         for h in f.history],
             "state": model_state(f.state.model),
             "best": None if f.best_state is None else model_state(f.best_state.model)}
            for f in fits]


def several(mesh, jobs):
    """Several jobs in one spawn: ``[(name, kwargs), ...]`` -> their results."""
    return [JOBS[name](mesh, **kw) for name, kw in jobs]


JOBS = {"steps": steps, "predict": predict, "multifold": multifold, "fit": fit,
        "multifold_fit": multifold_fit, "several": several}
