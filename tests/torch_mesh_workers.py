"""Rank programs of the mesh tests (``test_torch_mesh*.py``,
``test_torch_tp*.py``).

:func:`spawn` runs one of :data:`JOBS` on N gloo ranks on the CPU, each a
process of its own (``torch.multiprocessing.spawn``) that joins a process
group through a ``file://`` store under the test's temporary directory (so
that pytest-xdist workers never share a port) and builds
``make_mesh(N / M, M, devices="cpu")`` (M the model axis, 1 by default).
The jobs import the port alone; each also runs with ``mesh=None``, the
single-process run the tests hold the mesh's against.  States come back
whole (a model sharded over the model axis is gathered).
"""

import collections
import contextlib
import copy
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def spawn(tmp, world, job, n_model=1, **payload):
    """``JOBS[job](mesh, **payload)`` on ``world`` ranks, ``n_model`` on the
    model axis; returns each (global) rank's result."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    torch.save(payload, os.path.join(tmp, "payload.pt"))
    mp.spawn(_rank_main, args=(world, tmp, job, n_model), nprocs=world, join=True)
    return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
            for r in range(world)]


def _rank_main(rank, world, tmp, job, n_model=1):
    # the parent's pool (test_torch_helpers): the CPU convs' sums then run in
    # the same order, and a fold stepped here is bit-equal to the parent's
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(tmp, "store"),
                           rank=rank, world_size=world)
    try:
        from dmf_tpu_torch.parallel import make_mesh

        mesh = make_mesh(world // n_model, n_model, devices="cpu")
        payload = torch.load(os.path.join(tmp, "payload.pt"), weights_only=False)
        out = JOBS[job](mesh, **payload)
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


def floats(metrics):
    return {k: float(v) for k, v in metrics.items()}


def model_state(model):
    """The whole state dict (a collective over the model group where the
    model is sharded: every rank of the group calls it)."""
    from dmf_tpu_torch.parallel.sharding import full_parameters

    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    sd.update({k: v.clone() for k, v in full_parameters(model).items()})
    return sd


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


@contextlib.contextmanager
def recorded_masks():
    """``{pass: [mask, ...]}``: every seed-route keep mask drawn on the CPU
    under the context (``ops/dropout.py::keep_mask_plain``, which kernel 1's
    and the keep-mask operator's CPU implementations call), split into its
    passes, in the order the sites draw them; a sharded site's is the whole
    tensor's."""
    from dmf_tpu_torch.ops import dropout

    plain = dropout.keep_mask_plain
    by_pass = collections.defaultdict(list)

    def hook(shape, drop_rate, seed, base=0, first_pass=0, passes=1):
        keep = plain(shape, drop_rate, seed, base, first_pass, passes)
        for p, part in enumerate(keep.chunk(passes)):
            by_pass[first_pass + p].append(part.clone())
        return keep

    dropout.keep_mask_plain = hook
    try:
        yield by_pass
    finally:
        dropout.keep_mask_plain = plain


def mc_chunks(mesh, cfg, models, request, chunks, seed=5):
    """``tta_mc`` over ``mesh`` at each ``mc_chunk`` of ``chunks``, the
    caller's generator seeded ``seed``: ``{chunk: ((mean, std), masks)}``,
    with the masks this rank drew by pass (:func:`recorded_masks`)."""
    from dmf_tpu_torch.evals.predict import make_fusion_predictor

    out = {}
    for c in chunks:
        predictor = make_fusion_predictor(cfg, *models, mode="tta_mc", mc_chunk=c, mesh=mesh)
        with recorded_masks() as masks:
            mean, std, _ = predictor(*request, torch.Generator().manual_seed(seed))
        out[c] = ((mean, std), dict(masks))
    return out


def mc_fused(mesh, cfg, models, request, chunks, seed=5):
    """:func:`mc_chunks` with every MC attention site on the fused route
    (``use_flash`` patched to hold at the toy token count): ``(runs,
    calls)``, ``calls[chunk]`` each fused site's ``(p, base, first_pass,
    passes, heads, h0, local heads)`` in the order the sites run."""
    from dmf_tpu_torch.models import transformer
    from dmf_tpu_torch.ops import flash_attention

    ref, rule = flash_attention.flash_attention_dropout_ref, transformer.use_flash
    calls = []

    def recorded(q, k, v, scale, p, seed_, base, first_pass=0, passes=1, heads=None, h0=0):
        calls.append((p, base, first_pass, passes, heads, h0, q.shape[1]))
        return ref(q, k, v, scale, p, seed_, base, first_pass, passes, heads, h0)

    flash_attention.flash_attention_dropout_ref = recorded
    transformer.use_flash = lambda *a: True
    try:
        runs, by_chunk = {}, {}
        for c in chunks:
            calls.clear()
            runs.update(mc_chunks(mesh, cfg, models, request, (c,), seed))
            by_chunk[c] = list(calls)
    finally:
        flash_attention.flash_attention_dropout_ref, transformer.use_flash = ref, rule
    return runs, by_chunk


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


def fit(mesh, kind, cfg, model, train, val, workdir, epochs=2, processor=None, reload=False):
    """``fit_fusion`` (``kind="fusion"``, a ``FusionNetwork``) or
    ``fit_single("dwi")`` with ``mesh=``, ``viz_every=0``: the history
    (wall times aside), the final model state and the files rank 0 wrote;
    also the error of a batch size that does not divide over the mesh, and
    with ``reload`` the final state after ``load_checkpoint`` of the best
    checkpoint (``reloaded``)."""
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
    final, reloaded = model_state(res.state.model), None
    if reload:
        from dmf_tpu_torch.utils.checkpoint import load_checkpoint

        load_checkpoint(os.path.join(workdir, "checkpoints", "best.pt"), res.state)
        reloaded = model_state(res.state.model)
    history = [{k: v for k, v in h.items() if not k.endswith("_time")} for h in res.history]
    files = sorted(os.path.relpath(os.path.join(r, f), workdir)
                   for r, _, fs in os.walk(workdir) for f in fs)
    with open(os.path.join(workdir, "logs", "metrics.jsonl")) as fh:
        log_lines = len(fh.readlines())
    return {"history": history, "state": final, "error": error, "reloaded": reloaded,
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


# ---------------------------------------------------------------- the model axis
def _nchw(a):
    return torch.as_tensor(a).permute(0, 3, 1, 2).contiguous()


def _digest(t):
    import hashlib

    return hashlib.sha256(t.detach().contiguous().reshape(-1).view(torch.uint8)
                          .numpy().tobytes()).hexdigest()


def tp_forward(mesh, encoder, x, net, dwi, dce):
    """Eval forwards of an encoder and a fusion network, sharded over the
    mesh's model axis: the encoder's logits, the network's logits and
    head-averaged cross-attention weights, and the local shapes of the
    network's sharded parameters."""
    from dmf_tpu_torch.parallel.tensor import parameter_shards, tensor_parallel

    if mesh is not None:
        tensor_parallel(encoder, mesh)
        tensor_parallel(net, mesh)
    shards = parameter_shards(net)
    with torch.no_grad():
        enc = encoder(_nchw(x))[0]
        logits, _, aux, _ = net(_nchw(dwi), _nchw(dce))
    return {"encoder": enc, "fusion": logits, "attn": aux["attn_weights"],
            "shapes": {n: tuple(p.shape) for n, p in net.named_parameters() if n in shards}}


def tp_steps(mesh, **kw):
    """:func:`steps`, with each step's gradients of the replicated
    parameters digested bit for bit (the AdamW update's input) and the
    names of the sharded ones."""
    import dmf_tpu_torch.train.fusion as tf
    import dmf_tpu_torch.train.single as ts
    from dmf_tpu_torch.parallel.tensor import parameter_shards

    digests = []

    def record(update):
        def wrapped(params, grads, state, *a, **k):
            shards = parameter_shards(kw["model"])
            digests.append({n: _digest(g) for n, g in grads.items()
                            if g is not None and n not in shards})
            return update(params, grads, state, *a, **k)
        return wrapped

    plain = tf.adamw_update, ts.adamw_update
    tf.adamw_update, ts.adamw_update = record(plain[0]), record(plain[1])
    try:
        out = steps(mesh, **kw)
    finally:
        tf.adamw_update, ts.adamw_update = plain
    out["digests"] = digests
    out["sharded"] = sorted(parameter_shards(kw["model"]))
    return out


def tp_test_fusion(mesh, cfg, models, test_data, chunks=(None, 2), int8=False,
                   calibration_data=None):
    """``test_fusion_model(mesh=)`` on a fusion network's state, per
    ``mc_chunk`` in ``chunks``: probabilities, std, the modality attention
    and the metrics (``int8=True``: on the int8 convs, calibrated on
    ``calibration_data``)."""
    from dmf_tpu_torch.pipeline.run_fusion import test_fusion_model
    from dmf_tpu_torch.train import TrainState
    from dmf_tpu_torch.train.fusion import FusionNetwork

    state = TrainState.create(FusionNetwork(*models), num_groups=4)
    out = {}
    for c in chunks:
        r = test_fusion_model(cfg.replace(mc_chunk=c), state, test_data, seed=0, mesh=mesh,
                              int8=int8, calibration_data=calibration_data)
        out[c] = {k: r[k] for k in ("probs", "std", "labels", "modality_attention", "metrics")}
    return out


def tp_neck(mesh, adapter, feats):
    """The adapter's necks on backbone features, sharded over the model
    axis: the eval route (kernel 2's plain version on the CPU) and the train
    route's outputs, and the train route's gradients of the features and of
    every parameter (whole)."""
    from dmf_tpu_torch.parallel.tensor import gather_full, parameter_shards, tensor_parallel

    if mesh is not None:
        tensor_parallel(adapter, mesh)
    xs = [torch.as_tensor(f) for f in feats]
    with torch.no_grad():
        evals = adapter(xs, train=False)
    xs = [x.clone().requires_grad_(True) for x in xs]
    outs = adapter(xs, train=True)
    loss = sum((o * o).mean() for o in outs)
    params = dict(adapter.named_parameters())
    grads = torch.autograd.grad(loss, xs + list(params.values()))
    shards = parameter_shards(adapter)
    pgrads = {n: gather_full(g, shards[n], mesh) if n in shards else g
              for n, g in zip(params, grads[len(xs):])}
    return {"eval": evals, "train": [o.detach() for o in outs],
            "input_grads": grads[:len(xs)], "grads": pgrads, "sharded": sorted(shards)}


# ---------------------------------------------------------------- int8 on the model axis
def _quant_shapes(*models):
    """``{name: (class, weight_q shape)}`` of every int8 conv of ``models``."""
    from dmf_tpu_torch.ops.quant import QuantConv2d

    return {f"{i}.{n}": (type(m).__name__, tuple(m.weight_q.shape))
            for i, model in enumerate(models) for n, m in model.named_modules()
            if isinstance(m, QuantConv2d)}


def tp_int8_conv(mesh, convs, x, adapter, feats, neck_qset):
    """The int8 convs of ``convs`` (a ModuleDict of whole ``nn.Conv2d``),
    sharded over the model axis where ``param_spec`` says so: their QuantSet
    (from the shards), and the outputs of the quantized copies on ``x`` with
    static (x's abs-max) and dynamic scales, in fp32 and bf16; and the
    adapter's necks on the int8 convs of ``neck_qset`` (one process's, cut
    to the shards) in fp32 and bf16, with kernel 2's calls."""
    import dmf_tpu_torch.models.adapter as adapter_mod
    from dmf_tpu_torch.ops import quant
    from dmf_tpu_torch.parallel.tensor import tensor_parallel

    if mesh is not None:
        tensor_parallel(convs, mesh)
        tensor_parallel(adapter, mesh)
    qset = quant.build_quant_set(convs, min_fan_in=64, min_out=8)
    x = torch.as_tensor(x)
    # the size test on the whole conv: Cout 128 passes, a shard's 64 would not
    wide = sorted(quant.build_quant_set(convs, min_fan_in=64, min_out=100))
    xs = torch.tensor(float(x.abs().max()) / 127.0)
    out = {"qset": qset, "y": {}, "selected_at_min_out_100": wide}
    for static in (True, False):
        q = {n: dict(e, x_scale=xs) if static else e for n, e in qset.items()}
        copies = {dt: quant.quantized_copy(convs, q).to(dt) for dt in (torch.float32,
                                                                       torch.bfloat16)}
        out["shapes"] = _quant_shapes(copies[torch.float32])
        with torch.no_grad():
            for dt, qm in copies.items():
                for n in qset:
                    out["y"][(n, static, str(dt))] = qm[n](x.to(dt))
    neck = quant.quantized_copy(adapter, quant.shard_quant_set(neck_qset, adapter))
    out["neck_shapes"] = _quant_shapes(neck)
    calls, plain = [], adapter_mod.conv3x3_bn_gelu

    def counted(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    adapter_mod.conv3x3_bn_gelu = counted
    try:
        with torch.no_grad():
            out["neck"] = {str(dt): copy.deepcopy(neck).to(dt)([torch.as_tensor(f).to(dt)
                                                                for f in feats])
                           for dt in (torch.float32, torch.bfloat16)}
    finally:
        adapter_mod.conv3x3_bn_gelu = plain
    out["neck_kernel_2"] = len(calls)
    return out


def tp_int8_predict(mesh, cfg, models, calibration, requests, qsets=None, cases=()):
    """Int8 serving over the model axis on the models sharded first: the
    QuantSets that ``make_quantized_fusion_apply`` builds and calibrates
    (``calibration_mc=False``) on the shards, and, on ``qsets`` (one
    process's, cut to the shards), the predictors of ``make_quantized_fusion_fwd``
    ("int8") and ``make_hybrid_fusion_fwd`` ("hybrid") in each case ``(kind,
    mode)`` on each request, MC masks from a generator seeded 3; the int8
    weights' shapes; and the error of a predictor over the mesh on a whole
    int8 forward."""
    from dmf_tpu_torch.evals.predict import make_fusion_predictor
    from dmf_tpu_torch.ops import quant
    from dmf_tpu_torch.parallel.tensor import tensor_parallel

    whole = copy.deepcopy(models)
    if mesh is not None:
        for m in models:
            tensor_parallel(m, mesh)
    _, own = quant.make_quantized_fusion_apply(*models, calibration=calibration,
                                               calibration_mc=False)
    out = {"qsets": own, "y": {}}
    qsets = qsets or own
    cut = {k: quant.shard_quant_set(qsets[k], m)
           for k, m in zip(("dwi", "dce", "fusion"), models)}
    fwds = {"int8": quant.make_quantized_fusion_fwd(*models, cut),
            "hybrid": quant.make_hybrid_fusion_fwd(*models, cut)}
    out["shapes"] = _quant_shapes(*fwds["int8"].modules.values())
    for kind, mode in cases:
        predictor = make_fusion_predictor(cfg, *models, mode=mode, fwd_override=fwds[kind],
                                          mesh=mesh)
        g = torch.Generator().manual_seed(3)
        out["y"][(kind, mode)] = [predictor(torch.as_tensor(a), torch.as_tensor(b), g)[:2]
                                  for a, b in requests]
    if mesh is not None:
        try:
            make_fusion_predictor(cfg, *whole, mode="tta", mesh=mesh,
                                  fwd_override=quant.make_quantized_fusion_fwd(*whole, qsets))
        except ValueError as e:
            out["refused"] = str(e)
    return out


def several(mesh, jobs):
    """Several jobs in one spawn: ``[(name, kwargs), ...]`` -> their results."""
    return [JOBS[name](mesh, **kw) for name, kw in jobs]


JOBS = {"steps": steps, "predict": predict, "multifold": multifold, "fit": fit,
        "multifold_fit": multifold_fit, "tp_forward": tp_forward, "tp_steps": tp_steps,
        "tp_test_fusion": tp_test_fusion, "tp_neck": tp_neck, "tp_int8_conv": tp_int8_conv,
        "tp_int8_predict": tp_int8_predict, "several": several, "mc_chunks": mc_chunks,
        "mc_fused": mc_fused}
