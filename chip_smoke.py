"""Smoke run of the PyTorch port (dmf_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. card identity (nvidia-smi name and power limit, torch and CUDA versions);
  2. kernel build from the sources in this checkout (the eight CUDA
     libraries by nvcc and the native host library by g++, in parallel),
     with ptxas registers, spills and static shared memory, and the wgmma
     kernels' dynamic shared memory;
  3. each hand-written kernel vs its plain PyTorch version at the served
     paths' shapes, fp32 (TF32 off) and bf16, with errors beside stated
     tolerances and median times beside the plain version's, the bound and
     the one PyTorch call that computes the same function (where there is
     one): 3a SE epilogue (its Philox keep bits against the numpy Philox at
     element indices past 2^31 and 2^32, in one pass and with pass words, the
     largest map of a B=128 tta_mc request, past 2^31 elements, against the
     plain version on maps at its start, around element 2^31 and at its end,
     32^2 maps of tta_mc's lean chunk with its 9 pass words, the keep-mask
     kernel's bits equal to the plain mask's and kernel 1's drops to them,
     128^2 maps of hybrid-nb), 3b conv3x3+BN+GELU, 3c
     flash-attention forward (fp32 on the 3xTF32 kernel at (32 | 128, 4096,
     128) and (32, 4096, 64), two calls compared bit for bit, its error and
     the plain version's against a float64 attention; bf16 beside it), 3d
     its backward (dQ, dK/dV; fp32 on the 3xTF32 kernels at (32 | 128,
     4096, 128) and (32, 4096, 64), bf16 beside it; two calls compared bit
     for bit; the fp32 kernels' error and the plain version's against a
     float64 backward at (32, 4096, 128)), 3i the flash forward with
     attention dropout (the MC attention of ``hybrid-nb`` on the seed route,
     bf16 and fp32 at a ``tta_mc`` B=2 suffix's (8, 4, 4096, 128) at
     mc_chunk 1, D=64, and mc_chunk 3's (24, ...) with 3 pass words): its
     head-shared instance (a pre-pass makes one Philox call for 4 heads)
     bit-equal to its per-element one and against the plain version, both
     timed in turns beside the same kernel at p = 0, SDPA with
     ``dropout_p`` (never on the path), the tensor bound and the integer
     floor of the Philox calls the keep bits need (``ops/sass.py``; each
     instance's SASS instructions a call from ``cuobjdump -sass`` beside
     it), and 3i(b) its keep bits (q = 0 and V
     one-hot over the first and the last 128-key window: ``out != 0`` is the
     mask) bit-equal to the keep-mask kernel's at pass words, counter bases
     and a head shard's h0, on each instance, 3j the dQ and dK/dV kernels'
     dropout instances (the training route's attention dropout; their
     pre-pass redraws the keep bits, query-major for dQ, key-major for
     dK/dV) on the dropout forward's out and lse at (8, 4, 4096, 128 | 64),
     bf16 against their plain versions, fp32 against a float64 backward of
     the weights route on the keep-mask kernel's mask, two calls bit-equal,
     3j(b) their keep bits
     (q = 0, delta = 0: dQ with K one-hot over a 128-key window, dV with dO
     one-hot over a 128-query window) bit-equal to the keep-mask kernel's on
     both pre-passes, and timed at the training shape (32, 4, 4096, 128)
     beside the p = 0 pair in turns, SDPA's backward with ``dropout_p``, the
     tensor bound and each pre-pass's integer floor, with, for the wgmma
     kernels (3b, 3c, 3d, 3i, 3j), the kernel's own device
     time per call (profiler; fp32 flash: its pre-pass included), its TFLOP/s
     and share of the bound, and the kernel timed in turns with its library
     yardstick (SDPA in fp32 with TF32 off for the fp32 flash kernels) and
     their ratio;
     3e the DWI z-score, 3f the histogram percentiles (max-normalised
     synthetic DCE rows at (48 | 1536, 65536), the same with 60 % of each
     row at 0, ragged and unaligned rows at (48, 65539) and (7, 10007),
     rows past the kernel's shared-memory budget at (4, 2^20); two calls
     compared bit for bit), 3g the standalone SE; 3a, 3b and 3g also in
     fp32 at a validation batch's maps (B=32: training builds the models in
     fp32), kernel 2 (3xTF32) there and at a tta_mc test batch's views
     (N=128) against cuDNN's fp32 chain in turns (and, for context, the chain
     with TF32 on), two calls compared bit for bit, its error and the plain
     version's against a float64 conv at K = 27648, beside the 3xTF32 bound
     (3x the operations at 495 TFLOP/s) and the CUDA-core fp32 one (67
     TFLOP/s); the memory-bound kernels
     (3a, 3e-3g) with their device time, GB/s and share of the bytes bound;
     3h autograd through the full-width hybrid-nb transformer stage in bf16
     and in fp32 (the backward kernels' path: 6 launches of dQ and of dK/dV
     a backward), its gradients against an fp32 copy on the plain route at
     B=2 and its backward timed at B=8 (CUDA events, peak memory, one
     profiled backward with the flash backward kernels' share), then in
     train mode (attention dropout on, the projection and MLP dropouts off,
     one fixed seed a site on both devices) at B=1 in bf16 and fp32 against
     the CPU's plain versions (each site's keep mask from the keep-mask
     kernel), 6 launches each of the dropout forward, dQ and dK/dV;
  4. end-to-end parity, card (kernels) vs CPU (plain versions), fp32,
     seeded random weights at full width: 4 the default ResNet-50 models in
     ``tta`` at B=2, 4b the hybrid-transformer no-backbone models
     (``hybrid-nb``) in ``normal`` at B=1; 4c the data preparation
     (``prepare_single_data`` + ``export_processed_splits``, dwi and dce,
     256 + 64 synthetic volumes of 256^2), card vs CPU, with stage times
     (the DCE Nyul fit by the native threaded C++ beside the plain numpy
     fit on the same volumes, and their landmarks' largest difference);
  5. serving raw NHWC volumes -> on-card preprocessing -> predictor in bf16,
     3 requests of B=8 each, with launch counters checked per request and
     the preprocessing timed apart from the predictor: 5 the default models
     in ``tta_mc``, 5b ``hybrid-nb`` in ``normal`` then ``tta``;
  6. a profiler breakdown of one more ``tta_mc`` and one ``hybrid-nb``
     ``normal`` request;
  7. training at full width, a whole fold of the default config (dilated
     ResNet-50 encoders, 256^2, fp32 with TF32 off): 7a two train steps at
     B=2 on the card and on the CPU from the same weights and processed
     batches, one with the backbone group frozen and one after its
     unfreeze, the per-step losses and then the parameters and BatchNorm
     statistics beside their tolerances (against the disagreement of two CPU
     memory formats), with the launches per train step (none of kernels 1,
     2, 6), per DWI batch (kernel 7), per validation batch and per ``tta_mc``
     test batch; 7b ``run_single_model("dwi")`` at B=32 on synthetic volumes
     for two epochs (the backbone trained in the second), with the step
     times by CUDA events and the batch preparation apart, epoch,
     validation and test times, the peak memory, the run's launches, the
     backbone bit-equal after the frozen epoch and trained after, the best
     checkpoint's reload, the test ensemble's sums and MC std, and one
     profiled train step (idle share, top kernels); 7c two fusion train
     steps of the default models at full width (two ResNet-50 encoders and
     the fusion head) at B=4 on the card and on the CPU, one with the
     encoders frozen and one after group 2's unfreeze (losses, then
     parameters and statistics against two CPU memory formats, no kernel
     launched); 7d the rest of the fold: ``run_single_model("dce")`` beside
     7b's DWI run, then ``run_fusion_model`` over both for three epochs with
     two unfreezes (step times, epoch / validation / test times, peak memory,
     launches per validation and test batch, the single-model states left
     bit-equal, the best reload bit-equal, a profiled step); 7e the
     validation route of a full-width ``hybrid-nb`` DWI model
     (``make_single_eval_step`` at B=32, fp32 with TF32 off: 6 launches of
     the fp32 flash forward at (128, 4096, 128) a batch, none of the
     backward), its peak memory beside the fp32 forward's K/V scratch, its
     batch time by CUDA events, one profiled batch (the flash
     forward's device time, the idle share) and the first two volumes'
     logits against the same eval step on the CPU (rel 1e-4);
  8. the command line on the card: 7b's 158 + 32 volumes written as a tensor
     store (``dwi_tensordata.npz``, ``dce_tensordata.npz``), a seeded
     ResNet-50 written in the Lab-Rasool layout and a resnet50d in timm's,
     the default config at full width as JSON; the imports (host seconds)
     held bit-equal to ``build_single_model(..., pretrained_path=)`` on the
     card at 14 and 6 channels and to ``build_backbone`` for resnet50d; then
     ``cli.main(["run", "--fusion", ...])`` in-process for fold 0, one
     epoch a stage with the backbone frozen: stage wall seconds, peak
     memory, a finite three-stage summary, each ``metrics.json``, the
     backbone parameters of both single runs' final and best states
     bit-equal to the import, one decodable mask triptych a stage (epoch 0),
     kernels 1, 2, 6 and 7 launched by 7b's and 7d's formulas (one more
     validation batch's launches for each triptych); ``export-ckpt --method
     fusion`` in its own process, each file loaded strictly into fresh
     models and equal to the trained ones; ``export-serving --mode tta_mc
     --batch 8`` on the fold's checkpoint in its own process (served in 11),
     the two processes at once;
     ``debug-suite --fusion`` on the card (kernels 1 and 6 at 8-32
     channels), and its models with dropout off, card against CPU;
  9. the ViT-backed path (``dino_vitbase16_pretrain`` for both encoders,
     256^2, full ViT-B/16 width: 768 wide, 12 blocks, 12 heads): 9a kernels
     2 and 1 at its shapes against their plain versions (kernel 2 at the six
     neck sites, Cin 2304 / 3072 / 3840 / 768 -> 768 at 16^2, N=32 bf16 with
     cuDNN's chain in turns and N=32 fp32 on the 3xTF32 kernel, its error
     and the plain version's against a float64 conv at K = 34560; kernel 1
     at 16^2 x 768, N=32 fp32 drop 0 and N=288 bf16 drop 0.2), with bounds
     and device times; 9b the seeded ViT-backed fusion models in ``tta`` at
     B=2, fp32, card vs CPU; 9c three ``tta_mc`` requests of B=8 raw volumes
     in bf16 with their launch counts and the preprocessing timed apart; 9d
     seeded ViT-B/16 checkpoints in timm's layout on the 224 grid imported
     at 14 and 6 channels (bit-equal to ``build_single_model(...,
     pretrained_path=)`` on the card), then ``cli.main(["run", "--fusion",
     ...])`` for fold 0 on phase 8's tensor store, one epoch a stage, the
     backbone frozen, ``use_native_loader=True`` (every train epoch's batches
     from the native loader), with 8's checks;
  10. training options under deterministic algorithms (cuDNN's and
     torch's): 10a ``ModelConfig.remat`` on the default DWI encoder at full
     width, B=32, fp32: three train steps plain, with remat and plain again
     from the same weights, batches and dropout seed (losses, parameters,
     BatchNorm statistics and the dropout generator bit-equal across the
     three), their CUDA-event step times, peak memory and the GiB autograd
     keeps (and the plain and remat steps' again with the default
     algorithms), and fusion train steps at B=32 plain, with remat on both
     encoders and plain again (step time, peak memory; the two plain runs'
     parameters bit-equal and no op warning that it has no deterministic
     implementation); 10b ``cli.main(["run",
     "--parallel-folds", "--folds", "0", "1", "--methods", "dwi", "dce",
     ...])`` on phase 8's store and checkpoint, one epoch, the backbone
     frozen, against the same folds run one after another: each fold's
     ``metrics.json`` and best checkpoint bit-equal, both runs' wall seconds
     per modality, peak memory, raw loads and model builds, and the
     launches by phase 8's formulas per fold;
  11. the serving artifact (``serving.py``, ``torch.export`` with the
     weights as arguments): the default config in ``tta_mc`` bf16 and in
     ``normal`` fp32 at B=8 and ``hybrid-nb`` ``normal`` bf16 at B=2, each
     run once eagerly on the seed route (its launches), exported (seconds,
     graph nodes, each kernel operator's nodes equal to the eager launches,
     the nodes preparing weights in the graph, no parameter, buffer or
     constant held, artifact bytes beside the state dicts'), saved, loaded
     in the parent for one profiled request (each kernel's own symbol among
     the profiler's kernel names); then one fresh process that imports
     ``torch`` and ``dmf_tpu_torch.ops.library`` and nothing else of the
     package serves each artifact and phase 8's CLI artifact (the fold's
     weights read from its ``best.pt`` with torch alone) 3 requests (seeds
     7, 7, 8): load seconds, CUDA-event ms, launches equal to 3x the
     nodes, probabilities finite and summing to 1, ``tta_mc`` bit-equal for
     one seed and not for two with std > 0, the deterministic artifacts
     within 1e-6 (fp32) or 2^-7 (bf16) of the eager seed-route predictor;
     the ``tta_mc`` program in fp32 at B=1 exported on the card at
     ``mc_chunk`` 3 and on the CPU unchunked, and the eager predictor
     (unchunked) on both, one seed: every (pass, site) mask bit-equal across
     the four, the outputs within 1e-4; the operator layer's host
     microseconds per call against the ``ctypes`` launch;
  12. int8 serving (``ops/quant.py``) of the default config at full width in
     bf16, its QuantSets from the fp32 weights (the copies' scales and biases
     checked fp32), calibrated with MC dropout on 4 preprocessed volumes of a
     separate draw: 12a the int8 conv (``csrc/int8_conv.cu``) at every distinct
     quantized conv shape of a ``tta_mc`` request at B=8 (the prefix at 32
     views, the suffix at the lean chunk's 288 maps and the last pass's 32),
     int32 and dequantized bf16 bit-equal to the plain version and across
     two calls, with its time, TOP/s, bound, the plain version's, cuDNN's
     bf16 conv's and, at the 1x1 stride-1 sites, ``torch._int_mm``'s, and
     ptxas's registers (a spill fails); 12b the static and the dynamic
     quantize (``csrc/int8_quantize.cu``; the dynamic one abs-max, scale and
     quantize in one launch) bit-equal to their plain versions at every
     distinct conv input, timed beside their bounds (the dynamic one's with
     one read and with two reads of x) and ``vector_norm(x, inf)``, a NaN
     input's scale NaN, one ``_dynamic_quantize`` call one CUDA kernel under
     the profiler, and the static route a request (quantize + conv) against
     cuDNN's bf16 convs; 12c int8 (static scales), int8 with dynamic scales,
     fp and int8-prefix hybrid ``tta_mc`` requests of B=8 raw volumes in
     turns on the same inputs and masks (3 each): median latency, argmax
     agreement, mean and std errors against fp, launches per request; 12d
     int8 ``tta`` at B=1 in fp32 with dynamic scales, card vs CPU; 12e ``test_fusion_model(int8=True,
     calibration_data=val)`` on phase 8's trained fold; 12f the int8
     ``tta_mc`` serving artifact in a fresh process, bit-equal to the eager
     int8 seed-route predictor;
  13. the data mesh (``parallel/mesh.py``, ``parallel/sharding.py``): two
     ranks pinned to the one card with gloo, each a process of its own
     (``python -m torch.distributed.run --nproc-per-node 2 chip_smoke.py
     --mesh-rank OUT`` runs one rank): 13a two full-width fusion train
     steps at global B=32 (16 a rank), fp32, dropout 0, through
     ``make_spmd_step``, their losses and parameters against one process's
     steps at phase 7c's bound (over the larger of two floors: one process
     in another memory format, and 13d's run), with each rank's step ms,
     peak memory and the ms of its all-reduces; 13b data-parallel ``tta_mc``
     bf16 requests of B=8 raw volumes (4 a rank), each rank's launches of
     kernels 1, 2, 6 and 7 a request and its latency beside one process's
     (two ranks sharing one card: no scaling figure), ``tta`` fp32 against
     one process's at phase 4's tolerance; 13c two DWI folds of
     ``make_multifold_step(mesh=)``, one a rank, bit-equal to one process's
     fold step; 13d 13a's steps on a 1x1 mesh over NCCL in this process, and
     ``run --mesh 2`` raising its "needs 2 cards" error;
  14. the mesh's model axis (tensor parallelism: ``parallel/tensor.py``,
     ``parallel/sharding.py``) on a 1x2 mesh at full width: two ranks pinned
     to the one card with gloo (``python -m torch.distributed.run
     --nproc-per-node 2 chip_smoke.py --tp-rank OUT`` runs one rank), the
     wide convs on output-channel shards and the attention on head shards:
     14a (this process) kernel 2 against its plain version at the six neck
     sites' shard shapes (half of each Cout, the whole Cin), N=32, bf16 and
     fp32 (3xTF32), with its time, its share of the bound and cuDNN's chain
     in turns; 14b the default fusion predictor sharded over the two ranks:
     a ``tta`` fp32 request of B=2 against one process's at phase 4's
     tolerance, one ``tta_mc`` bf16 request of B=2 raw volumes (each rank's
     launches: kernel 2 on its shards), its ms and the ms in its
     collectives, each rank's peak memory and parameter bytes; 14c a
     ``hybrid-nb`` ``tta`` fp32 request of B=2, the flash forward on two of
     the four heads a rank, against one process's; 14d two full-width
     fusion train steps at global B=4, fp32, dropout 0, against one
     process's (losses at rel 1e-3, parameters per group at 13a's bound over
     floors at this B), the replicated parameters' gradients bit-equal on
     the two ranks, step ms, the last step's ms in collectives and both
     ranks' peaks; 14e
     int8 serving over the model axis (the models sharded, then quantized
     and calibrated): (a, this process) the int8 conv at every distinct
     shard shape of an int8 ``tta_mc`` request at B=8 bit-equal to its plain
     version in int32 and bf16, its ms, TOP/s and share of the bound beside
     the whole conv's ms and cuDNN's bf16 conv at the shard; on each rank
     (b) an int8 ``tta`` fp32 request of B=2 against one process's at 12d's
     tolerance, the calibrated scales against one process's, and (c) one
     int8 ``tta_mc`` bf16 request of B=4 raw volumes (no warm-up): launches
     as one process's (kernel 2 none), ms and ms in collectives, argmax
     agreement with one process's on the same masks, peak memory, parameter
     and int8-conv bytes;
  15 (run after 2, so that a fault there ends the run early) the port's
     bench (``dmf_tpu_torch/bench.py``, ``bench.py``'s counterpart): the
     CLI's default ``bench`` in its own process (``normal``, B=128, 256^2,
     bf16), then in-process runs of ``bench.main(argv)``, the launch counts
     set to 0 just before and read just after each: the default ``tta_mc`` at
     B=8 (kernels 1, 2, 6, 7 per request, exactly), ``--encoder hybrid`` and
     ``hybrid-nb`` ``tta_mc`` at full width (B=8; B=2 with ``--mc-chunk 1``:
     kernels 1, 6, 7 and, for hybrid-nb only, the flash forward with dropout
     12 times a suffix), ``--int8-prefix --mode tta_mc``
     (its agreement with the fp ensemble), ``--train`` at B=32 and with two
     folds at B=8 (bf16 compute on fp32 parameters, no kernel), ``--train-e2e
     single`` at B=32 for two epochs and ``--numerics`` (20 steps, 64 test
     volumes; its AUC delta and agreement gated); each run's one JSON line
     parsed, its value finite, ``mfu`` printed exactly on a card of the peak
     table, with its seconds and peak memory;
  16 (run after 6) the ``tta_mc`` ensemble across ``mc_chunk`` None, 1 and
     3 (every pass draws its masks from its own pass word of the request
     seed, ``ops/dropout.py``), each request's launches counted from 0 and
     gated: 16b the default models in bf16 at B=8, every (pass, site) mask
     bit-equal across the chunkings, mean and std within 3x the floor the
     same requests with dropout off show; 16a each distinct kernel 1 and
     keep-mask call of that request on synthetic inputs of its shape with
     its pass words (the keep-mask kernel bit-equal to the plain mask, kernel
     1's drops equal to it and its output within tolerance), the keep-mask
     kernel's ms summed over the request beside the plain version's, a
     ``torch.rand < keep`` draw of the same size and the bytes bound, its
     device time; 16c ``hybrid-nb`` in bf16 at B=2 (unchunked where it fits
     the card; the attention dropout on the fused forward, 12 launches a
     suffix), each keep-mask site's digest equal across the chunkings, mean
     and std within 2^-7, ms and peak memory, a profile at mc_chunk 1; 16d
     the same request on the weights route (called explicitly) at mc_chunk
     1, its ms, peak and launches (gated on their own, not counted in the
     kernels line: the program does not take that route here), its dropout
     sites taking the fused request's shapes, counter bases and passes in
     order, its mean and std within 3x the two attention routes'
     dropout-off floor of the fused route's;
  17 (run after 7d) ``hybrid-nb`` training at full width on the training
     route's dropout kernels (6 dropout forwards, dQ and dK/dV an encoder a
     step, exactly): 17a ``bench --train --encoder hybrid-nb --batch 32`` in
     process (bf16 compute on fp32 parameters), 17b ``run_single_model``
     of a ``hybrid-nb`` DWI fold's stage at B=32 in fp32 (4 train steps,
     validation, the ``tta_mc`` test at mc_chunk 1), 17c an fp32 fusion
     train step at B=16 (B=32 does not fit the card), 17d the DWI train
     step at B=4 on the flash route and on the weights route in turns:
     steps/s or step ms and peak GiB;
  5c (run last) one default ``tta_mc`` request at bench.py's default B=128
     (all lean passes in one batch: kernel 1's maps pass 2^31 elements),
     with its peak memory.
The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA device the script exits non-zero before printing anything.
"""

import collections
import contextlib
import copy
import dataclasses
import functools
import io
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from dmf_tpu_torch import default_parameters, resolve_backbone_config  # noqa: E402
from dmf_tpu_torch.data.preprocess import (DEFAULT_LANDMARKS, NyulStandardizer,  # noqa: E402
                                           dce_global_max_normalize, nyul_fit_plain,
                                           nyul_transform_fast, prep_dwi_adc_maps,
                                           preprocess_fusion_inputs)
from dmf_tpu_torch.data.synthetic import make_synthetic_arrays  # noqa: E402
from dmf_tpu_torch.evals.predict import make_fusion_predictor  # noqa: E402
from dmf_tpu_torch.serving import (export_program, export_serving, load_serving,  # noqa: E402
                                   make_serving_fn, operator_nodes, serving_variables)
from dmf_tpu_torch.ops.dropout import SeedStream  # noqa: E402
from dmf_tpu_torch.models import build_fusion_models  # noqa: E402
from dmf_tpu_torch.models import transformer as transformer_mod  # noqa: E402
from dmf_tpu_torch.ops import attention as attn  # noqa: E402
from dmf_tpu_torch.ops import conv3x3 as k2  # noqa: E402
from dmf_tpu_torch.ops import dropout as seed_route  # noqa: E402
from dmf_tpu_torch.ops import dwi_norm, dwi_norm_cuda, se_cuda  # noqa: E402
from dmf_tpu_torch.ops import epilogue as k1  # noqa: E402
from dmf_tpu_torch.ops import epilogue_cuda  # noqa: E402
from dmf_tpu_torch.ops import flash_attention as fa  # noqa: E402
from dmf_tpu_torch.ops import library  # noqa: E402
from dmf_tpu_torch.ops import histogram as hist  # noqa: E402
from dmf_tpu_torch.ops import sass  # noqa: E402
from dmf_tpu_torch.ops import se as sek  # noqa: E402
from dmf_tpu_torch.ops import quant as int8q  # noqa: E402
from dmf_tpu_torch.ops import quant_cuda as int8_cuda  # noqa: E402
from dmf_tpu_torch.ops.cuda_build import BUILD_DIR, build_library  # noqa: E402
from dmf_tpu_torch.data.modality import ModalityProcessor  # noqa: E402
from dmf_tpu_torch.evals.predict import make_single_predictor, to_model  # noqa: E402
from dmf_tpu_torch.losses import get_classification_loss_fn, get_mask_loss_fn  # noqa: E402
from dmf_tpu_torch.pipeline import (build_fusion_state, build_single_model,  # noqa: E402
                                    export_processed_splits, load_processed_split,
                                    prepare_fusion_data, prepare_single_data, run_fusion_model,
                                    run_single_model, test_fusion_model, test_single_model)
from dmf_tpu_torch.train.fusion import (FusionNetwork, make_fusion_eval_step,  # noqa: E402
                                        make_fusion_train_step)
from dmf_tpu_torch.train.optim import (FusionOptController,  # noqa: E402
                                       SingleModelOptController, build_fusion_group_spec,
                                       build_group_spec)
from dmf_tpu_torch.train.schedule import aux_loss_weight  # noqa: E402
from dmf_tpu_torch.train.single import (make_single_eval_step,  # noqa: E402
                                        make_single_train_step)
from dmf_tpu_torch.train.state import TrainState  # noqa: E402
from dmf_tpu_torch.utils.checkpoint import load_checkpoint  # noqa: E402
from dmf_tpu_torch import bench, cli, debug_suite  # noqa: E402
from dmf_tpu_torch.models import init_weights, load_reference_state_dict  # noqa: E402
from dmf_tpu_torch.models.backbones import (ResNetFeatures, ViTFeatures,  # noqa: E402
                                            build_backbone, import_resnet50,
                                            import_vit_base, pretrained_state_dict)
from dmf_tpu_torch.data import pipeline as data_pipeline  # noqa: E402
from dmf_tpu_torch.utils import native  # noqa: E402
from dmf_tpu_torch.models.backbones.importers import map_rasool_to_timm_keys  # noqa: E402
from dmf_tpu_torch.models.weights import load_lightning_ckpt  # noqa: E402
from dmf_tpu_torch.pipeline import run_fusion as run_fusion_mod  # noqa: E402
from dmf_tpu_torch.pipeline import run_single as run_single_mod  # noqa: E402
from dmf_tpu_torch.pipeline import prepare_single as prepare_single_mod  # noqa: E402

DEV = torch.device("cuda", 0)
SEED = 0
B_SERVE = 8
B_LARGE = 128  # bench.py's default batch (bench.py:366)
REQUESTS = 3
# fp32 sum-order tolerance; bf16: one bf16 ulp (2^-7) after an fp32 sum in
# another order flips a rounding.  Both relative to max(1, max|plain|).
TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
# main-path geometry at 256^2 inputs: SE epilogue maps at 32^2 (P-1 = 9 lean
# passes x 4 views x B), neck stages (Cin, Cout, side) at 4 views x B
EPI_CHANNELS = (128, 256, 512)
NECKS = (("neck_f1_conv0", 256, 128, 64), ("neck_f1_conv1", 128, 128, 64),
         ("neck_f2_conv0", 512, 128, 32), ("neck_f2_conv1", 128, 128, 32),
         ("neck_f3_conv0", 3072, 256, 32), ("neck_f3_conv1", 256, 256, 32))
# hybrid-nb geometry at 256^2 inputs: SE epilogue maps of block1/block2 at
# 128^2 x 128/256; attention over 64^2 = 4096 tokens, 4 heads of 128
HYB_EPI_CHANNELS = (128, 256)
# the kernels of the SE epilogue (kernel 1), the standalone SE (kernel 6) and
# the DWI z-score (kernel 7), as the profiler names them; no name is part of
# another kernel's name (the SE MLP kernel, shared by kernels 1 and 6, carries
# its caller's tag: se_epilogue_mlp, se_scale_mlp)
EPI_KERNELS = ("epi_y_partials", "se_epilogue_mlp", "epi_scale")
SE_KERNELS = ("se_pool_partials", "se_scale_mlp", "se_apply")
DWI_KERNELS = ("dwi_partials", "dwi_merge", "dwi_apply")
SEQ, HEAD_DIM, HEADS = 4096, 128, 4
# the hybrid-nb transformer stage's parity batch: its fp32 plain-route
# reference holds (B x heads, 4096, 4096) fp32 scores and weights per block
# for autograd, ~10 GB at B=2 and ~40 GB at B=8
B_STAGE_PARITY = 2
# bf16 stage vs the fp32 plain-route copy, relative L2 error per tensor: bf16
# activations through 6 pre-LN blocks alone put some gradients (the LayerNorm
# weights') a few percent off fp32; phase 3h prints a bf16 plain-route copy's
# error beside the kernels'
STAGE_TOL = {torch.bfloat16: 2.0 ** -4,
             # fp32 (the 3xTF32 flash kernels): sums in other orders
             torch.float32: 1e-4}
# standalone SE maps (N, side, C) of a tta_mc request at B=8: modality
# attention on the dwi and dce inputs (4 views), fusion_se on the lean chunk
# (9 passes x 4 views) and on the last pass
SE_MAPS = ((32, 256, 14), (32, 256, 6), (288, 32, 128), (32, 32, 128))
LANDMARKS = tuple(float(p) for p in DEFAULT_LANDMARKS)
# data preparation: the synthetic store at full image size
N_TRAIN, N_TEST, IMAGE = 256, 64, 256
# H100 SXM datasheet peaks (dense): the bounds are the larger of bytes over
# the memory rate and operations over the peak rate of their type
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12  # fp32 outside the tensor cores
TF32_FLOP_PER_S = 495e12  # TF32 on the tensor cores (3xTF32: three products per fp32 one)
# a validation batch of the default config (batch_size 32): training builds
# the models in fp32, so validation runs kernels 1, 2 and 6 in fp32, and so
# does the tta_mc test of B_VAL volumes (4 views, the 9 lean MC passes in one
# chunk and the last pass, dropout 0.2)
B_VAL = 32
N_TEST_VIEWS = 4 * B_VAL
# standalone SE maps (N, side, C) of that test batch: modality attention on
# both inputs, fusion_se on the lean chunk and on the last pass
SE_TEST_MAPS = ((N_TEST_VIEWS, 256, 14), (N_TEST_VIEWS, 256, 6),
                (9 * N_TEST_VIEWS, 32, 128), (N_TEST_VIEWS, 32, 128))


def log(*a):
    print(*a, flush=True)


def gen(seed=SEED):
    return torch.Generator(device=DEV).manual_seed(seed)


def cuda_time(fn, reps=10, trials=5):
    """Median ms per call over ``trials`` windows of ``reps`` calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def launch_costs(fn, kernels, calls=20):
    """``fn``'s device ms per call in the kernels whose names contain one of
    ``kernels`` (profiler), its host ms per call to enqueue them (host clock
    over ``calls`` calls, no synchronize inside), and the device ms per call
    of each of ``kernels``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    each = {k: sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type.name == "CUDA" and k in e.key) / 5 / 1e3 for k in kernels}
    return sum(each.values()), host, each


def in_turns(kernel, library, **kw):
    """Median ms of ``kernel`` and ``library`` timed in turns (kernel,
    library, library, kernel), each the mean of its two windows: their
    ratio, not the raw times, is what compares across chip calls."""
    k1, l1 = cuda_time(kernel, **kw), cuda_time(library, **kw)
    l2, k2_ = cuda_time(library, **kw), cuda_time(kernel, **kw)
    return (k1 + k2_) / 2, (l1 + l2) / 2


def device_rate(tag, fn, kernels, bound, flop=0, nbytes=0):
    """Log and return ``fn``'s device ms per call in ``kernels`` (profiler),
    with its TFLOP/s (``flop``) or GB/s (``nbytes``) and its share of the
    bound, and its host ms per call to enqueue them: ``(device, host)``.  A profiler session
    at times records only some of the kernels' launches, or none: it is taken
    again, up to two sessions, and the time is None ("not measured") if
    neither records every one of ``kernels``; a device time of 0 is never
    printed."""
    for _ in range(2):
        dev, host, each = launch_costs(fn, kernels)
        if all(t > 0 for t in each.values()):
            rate = (f"{flop / dev / 1e9:.1f} TFLOP/s" if flop
                    else f"{nbytes / dev / 1e6:.1f} GB/s")
            split = (" (" + " + ".join(f"{k} {t:.4f}" for k, t in each.items()) + ")"
                     if len(kernels) > 1 else "")
            log(f"  {tag}: device {dev:.4f} ms per call{split} (profiler), {rate}, "
                f"{100 * bound / dev:.1f} % of the bound; host {host:.4f} ms per call "
                f"to enqueue")
            return dev, host
    log(f"  {tag}: device time not measured (no profiler session of two recorded "
        f"every one of {'/'.join(kernels)}); host {host:.4f} ms per call to enqueue")
    return None, host


def check(name, got, ref, dtype):
    err = (got.float() - ref.float()).abs().max().item()
    bound = TOL[dtype] * max(1.0, ref.float().abs().max().item())
    log(f"  {name}: max_abs_err {err:.3e} (tolerance {bound:.3e})")
    if not err <= bound:
        raise AssertionError(f"{name}: error {err} above tolerance {bound}")
    return err


def check_rel(name, got, ref, dtype):
    """Error against TOL[dtype] * max|plain|, for tensors far below 1 in
    magnitude (attention gradients), where max(1, .) would say nothing."""
    err = (got.float() - ref.float()).abs().max().item()
    bound = TOL[dtype] * ref.float().abs().max().item()
    log(f"  {name}: max_abs_err {err:.3e} (tolerance {bound:.3e} = {TOL[dtype]:.3g} x max|plain|)")
    if not err <= bound:
        raise AssertionError(f"{name}: error {err} above tolerance {bound}")
    return err


def expect_value_error(name, fn):
    """The check passes only if ``fn`` raises ValueError."""
    try:
        fn()
    except ValueError as e:
        log(f"  {name}: raises ValueError ({e})")
        return
    raise AssertionError(f"{name}: no ValueError raised")


def cl(t):
    return t.contiguous(memory_format=torch.channels_last)


# name: (module, wrapper, counter), read at each use: a probe of another tree
# (scripts/int8_turns.py) imports this file whatever wrappers that tree has
COUNTERS = {"se_epilogue": (k1, "se_epilogue", "launches"),
            "keep_mask": (seed_route, "keep_mask", "launches"),
            "conv3x3_bn_gelu": (k2, "conv3x3_bn_gelu", "launches"),
            "flash_attention_fwd": (fa, "flash_attention", "launches"),
            "flash_attention_fwd_dropout": (fa, "flash_attention_dropout", "launches"),
            "flash_attention_bwd_dq": (fa, "flash_attention", "launches_dq"),
            "flash_attention_bwd_dkv": (fa, "flash_attention", "launches_dkv"),
            # the backward's dropout instances (the training route's attention dropout)
            "flash_attention_bwd_dq_dropout": (fa, "flash_attention_dropout", "launches_dq"),
            "flash_attention_bwd_dkv_dropout": (fa, "flash_attention_dropout", "launches_dkv"),
            "se_scale": (sek, "se_scale", "launches"),
            "dwi_normalize": (dwi_norm, "dwi_normalize", "launches"),
            "histogram_percentiles": (hist, "histogram_percentiles", "launches"),
            "int8_conv": (int8q, "int8_conv", "launches"),
            "int8_quantize": (int8q, "quantize", "launches"),
            "int8_dynamic_quantize": (int8q, "dynamic_quantize", "launches"),
            # the dropout forward's launches by instance (in the kernel's entry)
            "flash_attention_fwd_dropout_head_shared": (fa, "flash_attention_dropout",
                                                        "launches_shared"),
            "flash_attention_fwd_dropout_per_element": (fa, "flash_attention_dropout",
                                                        "launches_each")}
DROP_INSTANCES = {"head_shared": "flash_attention_fwd_dropout_head_shared",
                  "per_element": "flash_attention_fwd_dropout_per_element"}


def reset_counts():
    for mod, fn, attr in COUNTERS.values():
        setattr(getattr(mod, fn), attr, 0)


def counts():
    return {name: getattr(getattr(mod, fn), attr) for name, (mod, fn, attr) in COUNTERS.items()}


def hybrid_nb_config(cfg):
    """``bench.py --encoder hybrid-nb`` (bench.py:517-535): the default config
    with the hybrid-transformer encoders and no backbone, at full width."""
    mc = resolve_backbone_config(dataclasses.replace(
        cfg.dwi_model, use_backbone=False, use_hybrid_transformer=True))
    return cfg.replace(dwi_model=mc, dce_model=mc, fusion_model=dataclasses.replace(
        mc, fusion_specific=cfg.fusion_model.fusion_specific))


# ------------------------------------------------------------------ phase 1
def phase_identity():
    log("== phase 1: card identity")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return smi


# ------------------------------------------------------------------ phase 2
def phase_build():
    log("== phase 2: kernel build")
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    libs = {"conv3x3_bn_gelu": k2._library, "flash_attention": fa._library,
            "histogram_percentiles": hist._library, "se_epilogue": epilogue_cuda._library,
            "se_scale": se_cuda._library, "dwi_norm": dwi_norm_cuda._library,
            "int8_conv": int8_cuda._conv_library, "int8_quantize": int8_cuda._quant_library}
    # one nvcc per source and the host library's g++, all together
    with ThreadPoolExecutor(len(libs) + 1) as pool:
        for f in [pool.submit(build) for build in (*libs.values(), native.load)]:
            f.result()
    log(f"  {' + '.join(libs)} (nvcc, sm_90a) and dmf_native (g++), in parallel: "
        f"{time.perf_counter() - t0:.2f} s")
    for name in libs:
        for p in sorted(BUILD_DIR.glob(f"{name}-*/build.log")):
            kernel = ""
            for line in p.read_text().splitlines():
                if "Compiling entry function" in line:
                    kernel = line.split("'")[1][-60:]
                elif ("registers" in line or "spill" in line or "setmaxnreg" in line
                      or "(C7" in line or "warning" in line.lower()):
                    log(f"  ptxas {name} {kernel}: {line.strip()}")
    # ptxas reports static shared memory only, and the launch bound's register
    # cap for the warp-specialised kernels (setmaxnreg moves registers at run
    # time); the wgmma kernels' shared memory is dynamic
    flash_smem, conv_smem = fa._library().flash_wgmma_smem, \
        k2._library().conv3x3_bn_gelu_wgmma_smem
    int8_smem = int8_cuda._conv_library().int8_conv_smem
    log("  dynamic shared memory per block: " + "; ".join(
        f"{name} D=128 {flash_smem(i, 128)} B, D=64 {flash_smem(i, 64)} B" for i, name in
        enumerate(("flash_fwd_wgmma", "flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma",
                   "flash_fwd_tf32x3", "flash_bwd_tf32x3 (dQ, dK/dV)")))
        + f"; conv3x3_bn_gelu_wgmma 128x256 {conv_smem(1, 256)} B, 128x128 {conv_smem(1, 128)} B"
        + f"; conv3x3_bn_gelu_tf32x3 128x128 {conv_smem(0, 128)} B"
        + "; int8_conv_wgmma " + ", ".join(f"128x{t} {int8_smem(t)} B" for t in (64, 128, 256)))


# ------------------------------------------------------------------ phase 3
def epi_inputs(n, c, dtype, g, side=32):
    x = cl(torch.randn(n, c, side, side, device=DEV, generator=g).to(dtype))
    idn = cl(torch.randn(n, c, side, side, device=DEV, generator=g).to(dtype))
    w1 = torch.randn(c // 2, c, device=DEV, generator=g) * c ** -0.5
    w2 = torch.randn(c, c // 2, device=DEV, generator=g) * (c / 2) ** -0.5
    b1 = torch.randn(c // 2, device=DEV, generator=g) * 0.1
    b2 = torch.randn(c, device=DEV, generator=g) * 0.1
    return x, idn, w1, b1, w2, b2


def philox_bits():
    """Kernel 1's keep bits (its keep-mask entry point) against the plain
    numpy Philox4x32-10 at element indices that straddle 2^31 and 2^32 (the
    counter and the offsets are 64-bit), in one pass and in two passes from
    pass words 0 and 2^31 - 1 (a per-pass count that is not a multiple of 4
    among them)."""
    for shape in ((2, 8, 4, 4), (2, 5, 3, 3)):
        x = cl(torch.zeros(*shape, device=DEV))
        for base in (0, 2 ** 31 - 64, 2 ** 32 - 64, 2 ** 40 + 4):
            for seed in (12345, (0x5EED << 32) | 77):
                for first, passes in ((0, 1), (0, 2), (2 ** 31 - 1, 2)):
                    got = epilogue_cuda.keep_mask(x, 0.2, torch.tensor([seed], device=DEV),
                                                  base, first, passes)
                    flat = got.permute(0, 2, 3, 1).reshape(-1).cpu().numpy()
                    ref = epilogue_cuda.keep_mask_ref(base, x.numel(), 0.2, seed, first, passes)
                    if not (flat == ref).all():
                        raise AssertionError(f"keep bits differ from Philox at base {base}, "
                                             f"seed {seed}, passes {first}+{passes}")
    log("  keep bits of 2 x 8 x 4^2 and 2 x 5 x 3^2 elements from indices 0, 2^31 - 64, "
        "2^32 - 64, 2^40 + 4, two seeds, one pass and two from pass words 0 and 2^31 - 1: "
        "equal to the numpy Philox4x32-10")


def epilogue_past_2_31(n_maps):
    """Kernel 1 with dropout on the largest map of a ``tta_mc`` request at
    B_LARGE (``n_maps`` x 32^2 x 512 bf16, past 2^31 elements), against the
    plain version fed the kernel's own keep bits (the keep mask from the
    first element of the maps compared) on the first maps, the maps around
    element 2^31 and the last maps: the tile, offset and scale-pass index
    math, not only the Philox bits, is held past 2^31."""
    c, side, p = max(EPI_CHANNELS), 32, 0.2
    per = side * side * c
    log(f"  bf16 N={n_maps} C={c} 32^2 drop={p}: {n_maps * per / 2 ** 31:.3f} x 2^31 "
        f"elements")
    if n_maps * per <= 2 ** 31:
        raise AssertionError("the map does not pass 2^31 elements")
    g = gen(6)
    # (N, H, W, C) storage seen as channels_last (N, C, H, W): no copy
    x, idn = (torch.randn(n_maps, side, side, c, device=DEV, generator=g,
                          dtype=torch.bfloat16).permute(0, 3, 1, 2) for _ in range(2))
    _, _, w1, b1, w2, b2 = epi_inputs(1, c, torch.bfloat16, g)
    seed = torch.tensor([(0x5EED << 32) | 2024], device=DEV)
    out = epilogue_cuda.launch_se_epilogue(x, idn, w1, b1, w2, b2, p, seed)
    errs = []
    wrap = 2 ** 31 // per
    for lo, hi in ((0, 2), (wrap - 2, wrap + 2), (n_maps - 2, n_maps)):
        keep = epilogue_cuda.keep_mask(x[lo:hi], p, seed, base=lo * per)
        ref = k1.se_epilogue_ref(x[lo:hi], idn[lo:hi], w1, b1, w2, b2, drop_rate=p, keep=keep)
        errs.append(check(f"maps {lo}..{hi - 1} (elements from {lo * per})", out[lo:hi], ref,
                          torch.bfloat16))
    t_k = cuda_time(lambda: epilogue_cuda.launch_se_epilogue(x, idn, w1, b1, w2, b2, p, seed),
                    reps=3, trials=3)
    b_c = 3 * x.numel() * x.element_size()
    log(f"  N={n_maps}: kernel {t_k:.4f} ms (median), bound {b_c / HBM_BYTES_PER_S * 1e3:.4f} "
        f"ms (bytes, {b_c / 1e9:.2f} GB)")
    del x, idn, out, keep, ref
    torch.cuda.empty_cache()
    return max(errs)


def drops_match(tag, out, keep, x, idn):
    """Kernel 1's own mask, bit for bit: its output is 0 exactly where
    ``keep`` drops, wherever gelu(x + identity) is not within 1e-6 of 0 (fp32
    GELU is 0 below about -5.5, where a kept output is 0 too)."""
    live = F.gelu(x.float() + idn.float()).abs() > 1e-6
    off = int(((out == 0) != ~keep)[live].sum())
    if off:
        raise AssertionError(f"{tag}: kernel 1 drops {off} elements otherwise than the plain "
                             f"mask")


def phase_epilogue(n_passes, n_views):
    n_lean = n_passes * n_views
    log(f"== phase 3a: se_epilogue (CUDA) vs plain, N={n_passes}x{n_views} maps of 32x32xC")
    philox_bits()
    errs = [epilogue_past_2_31(n_passes * 4 * B_LARGE)]
    ms, plain_ms, nbytes, devs = 0.0, 0.0, 0, []
    g = gen(1)
    p = 0.2
    for i, dtype in enumerate((torch.float32, torch.bfloat16)):
        for j, c in enumerate(EPI_CHANNELS):
            args = epi_inputs(n_lean, c, dtype, g)
            tag = f"{str(dtype)[6:]} C={c}"
            out = k1.se_epilogue(*args)
            errs.append(check(f"{tag} drop=0", out, k1.se_epilogue_ref(*args), dtype))
            # the served call: the lean chunk's n_passes passes pass-major, each
            # drawing from its pass word (a SeedStream, as the predictor makes)
            seed = torch.tensor([(0x5EED << 32) | (100 + 10 * i + j)], device=DEV)

            def served():
                return k1.se_epilogue(*args, drop_rate=p,
                                      generator=SeedStream(seed, passes=n_passes))

            out = served()
            keep = epilogue_cuda.keep_mask(args[0], p, seed, 0, 0, n_passes)
            plain_keep = seed_route.keep_mask_plain(args[0].shape, p, seed, 0, 0, n_passes)
            if not torch.equal(keep, plain_keep):
                raise AssertionError(f"{tag}: the keep-mask kernel's pass-word bits differ "
                                     f"from the plain version's")
            drops_match(tag, out, keep, *args[:2])
            errs.append(check(f"{tag} drop={p} over {n_passes} pass words (kernel's mask "
                              f"bit-equal to the plain one)", out,
                              k1.se_epilogue_ref(*args, drop_rate=p, keep=keep), dtype))
            del plain_keep
            n = keep.numel()
            frac = keep.float().mean().item()
            bound = 5 * ((p * (1 - p)) / n) ** 0.5
            log(f"  {tag} keep fraction {frac:.6f} (1-p={1 - p}, 5-sigma bound {bound:.2e})")
            if abs(frac - (1 - p)) > bound:
                raise AssertionError("keep fraction outside binomial bounds")
            # two MC passes are two segments of the folded batch
            rows = keep.permute(0, 2, 3, 1).reshape(n_passes, -1).float()
            a, b = rows[0] - rows[0].mean(), rows[1] - rows[1].mean()
            corr = ((a * b).mean() / (a.std() * b.std())).item()
            cb = 5 / rows.shape[1] ** 0.5
            log(f"  {tag} pass-0/pass-1 mask correlation {corr:+.2e} (bound {cb:.2e})")
            if abs(corr) > cb:
                raise AssertionError("MC pass masks are correlated")
            t_k = cuda_time(served)
            gp = gen(2)
            t_p = cuda_time(lambda: k1.se_epilogue_ref(*args, drop_rate=p, generator=gp))
            # least traffic: read x and identity, write out, once each
            b_c = 3 * args[0].numel() * args[0].element_size()
            log(f"  {tag} drop={p}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms (median), bound "
                f"{b_c / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes, {b_c / 1e6:.1f} MB)")
            if dtype == torch.bfloat16:
                ms += t_k
                plain_ms += t_p
                nbytes += b_c
                devs.append(device_rate(f"{tag} drop={p}", served, EPI_KERNELS,
                                        b_c / HBM_BYTES_PER_S * 1e3, nbytes=b_c)[0])
            del args, out, keep, rows
    torch.cuda.empty_cache()
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    device = ("device not measured" if None in devs else
              f"device {sum(devs):.4f} ms ({100 * bound / sum(devs):.1f} % of the bound)")
    log(f"  bf16 sum over C: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound:.4f} ms (bytes); {device}")
    errs.append(epilogue_validation_fp32(g))
    errs.append(epilogue_test_fp32(g, n_passes, p))
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": None}


def epilogue_test_fp32(g, n_passes, p):
    """Kernel 1 in fp32 at a tta_mc test batch's maps (the lean chunk of
    ``n_passes`` passes and the last pass, each of N_TEST_VIEWS maps at 32^2,
    with their pass words), dropout ``p`` by the kernel's own mask, against
    the plain version."""
    log(f"  fp32 at a tta_mc test batch's maps (N={n_passes}x{N_TEST_VIEWS} and "
        f"{N_TEST_VIEWS}, 32^2, drop {p}):")
    errs = []
    for first, passes in ((0, n_passes), (n_passes, 1)):
        n = passes * N_TEST_VIEWS
        for c in EPI_CHANNELS:
            args = epi_inputs(n, c, torch.float32, g)
            seed = torch.tensor([300 + c + n], device=DEV)
            out = k1.se_epilogue(*args, drop_rate=p, generator=SeedStream(
                seed, first_pass=first, passes=passes))
            keep = epilogue_cuda.keep_mask(args[0], p, seed, 0, first, passes)
            errs.append(check(f"float32 N={n} C={c} drop={p} (kernel's own mask)", out,
                              k1.se_epilogue_ref(*args, drop_rate=p, keep=keep), torch.float32))
            del args, out, keep
            torch.cuda.empty_cache()
    return max(errs)


def epilogue_validation_fp32(g):
    """Kernel 1 in fp32 at a validation batch's maps (B_VAL x 32^2 x C,
    dropout 0): error, kernel and plain times, bytes bound, device time."""
    log(f"  fp32 at a validation batch's maps (N={B_VAL}, 32^2, drop 0):")
    errs, ms, plain_ms, nbytes, devs = [], 0.0, 0.0, 0, []
    for c in EPI_CHANNELS:
        args = epi_inputs(B_VAL, c, torch.float32, g)
        tag = f"float32 N={B_VAL} C={c} drop=0"
        errs.append(check(tag, k1.se_epilogue(*args), k1.se_epilogue_ref(*args), torch.float32))
        t_k = cuda_time(lambda: k1.se_epilogue(*args))
        t_p = cuda_time(lambda: k1.se_epilogue_ref(*args))
        b_c = 3 * args[0].numel() * args[0].element_size()
        bound = b_c / HBM_BYTES_PER_S * 1e3
        log(f"  {tag}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms (median), bound {bound:.4f} ms "
            f"(bytes, {b_c / 1e6:.1f} MB)")
        devs.append(device_rate(tag, lambda: k1.se_epilogue(*args), EPI_KERNELS, bound,
                                nbytes=b_c)[0])
        ms, plain_ms, nbytes = ms + t_k, plain_ms + t_p, nbytes + b_c
        del args
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    device = ("device not measured" if None in devs else
              f"device {sum(devs):.4f} ms ({100 * bound / sum(devs):.1f} % of the bound)")
    log(f"  fp32 validation sum over C (one encoder's three blocks): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms (bytes); {device}")
    return max(errs)


def phase_epilogue_hybrid():
    log("== phase 3a (hybrid-nb): se_epilogue (CUDA) vs plain at 128x128 maps, drop 0 "
        "(normal: N=8, tta: N=32)")
    g = gen(5)
    for n in (8, 32):
        for dtype in (torch.float32, torch.bfloat16):
            for c in HYB_EPI_CHANNELS:
                args = epi_inputs(n, c, dtype, g, side=128)
                tag = f"{str(dtype)[6:]} N={n} C={c} 128^2"
                check(tag, k1.se_epilogue(*args), k1.se_epilogue_ref(*args), dtype)
                if dtype == torch.bfloat16:
                    t_k = cuda_time(lambda: k1.se_epilogue(*args))
                    t_p = cuda_time(lambda: k1.se_epilogue_ref(*args))
                    b_c = 3 * args[0].numel() * 2
                    bound = b_c / HBM_BYTES_PER_S * 1e3
                    log(f"  {tag}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound "
                        f"{bound:.4f} ms (bytes, {b_c / 1e6:.1f} MB) (median)")
                    device_rate(tag, lambda: k1.se_epilogue(*args), EPI_KERNELS, bound,
                                nbytes=b_c)
                del args
    torch.cuda.empty_cache()


def neck_inputs(n, cin, cout, side, dtype, g):
    """(x, w, bias, gamma, beta, mean, var) of one neck site, random BN
    running statistics."""
    x = cl(torch.randn(n, cin, side, side, device=DEV, generator=g).to(dtype))
    w = torch.randn(cout, cin, 3, 3, device=DEV, generator=g) * (9 * cin) ** -0.5
    bias = torch.randn(cout, device=DEV, generator=g) * 0.1
    gamma = torch.rand(cout, device=DEV, generator=g) + 0.5
    beta = torch.randn(cout, device=DEV, generator=g) * 0.1
    mean = torch.randn(cout, device=DEV, generator=g) * 0.1
    var = torch.rand(cout, device=DEV, generator=g) + 0.5
    return x, w, bias, gamma, beta, mean, var


def conv_f32(n, g, necks):
    """Kernel 2 in fp32 (the 3xTF32 kernel) at ``necks``' sites at N=n:
    its error against the plain version, two calls bit-equal, kernel and
    plain ms, the kernel against cuDNN's fp32 chain (TF32 off) in turns,
    cuDNN's chain with TF32 on (context: the one-product accuracy class the
    kernel avoids) with its error, the device time and its share of the
    3xTF32 bound (3x the operations at 495 TFLOP/s, the kernel's bound) and
    of the CUDA-core fp32 bound (67 TFLOP/s).  Returns the sites' errors."""
    tot = dict.fromkeys(("kernel", "plain", "turns", "chain", "tf32", "flop", "bound",
                         "bound_f32"), 0.0)
    devs, errs = [], []
    for name, cin, cout, side in necks:
        args = neck_inputs(n, cin, cout, side, torch.float32, g)
        x, w, bias, gamma, beta, mean, var = args
        tag = f"float32 {name} N={n} ({side}^2, {cin}->{cout})"
        kernel = lambda: k2.conv3x3_bn_gelu(*args)  # noqa: E731
        ref, out = k2.conv3x3_bn_gelu_ref(*args), kernel()
        errs.append(check(tag, out, ref, torch.float32))
        if not torch.equal(out, kernel()):
            raise AssertionError(f"{tag}: two calls differ")
        t_k = cuda_time(kernel, reps=5)
        t_p = cuda_time(lambda: k2.conv3x3_bn_gelu_ref(*args), reps=5)
        flop = 2 * n * side * side * 9 * cin * cout
        bytes_ms = 4 * (x.numel() + w.numel() + n * cout * side * side) / HBM_BYTES_PER_S * 1e3
        bound = max(3 * flop / TF32_FLOP_PER_S * 1e3, bytes_ms)
        bound_f32 = max(flop / FP32_FLOP_PER_S * 1e3, bytes_ms)
        wc = w.contiguous(memory_format=torch.channels_last)
        chain = lambda: F.gelu(F.batch_norm(  # noqa: E731
            F.conv2d(x, wc, bias, padding=1), mean, var, gamma, beta, False, 0.0, 1e-5))
        t_kt, t_c = in_turns(kernel, chain, reps=5)
        torch.backends.cudnn.allow_tf32 = True
        try:
            tf32_err = (chain() - ref).abs().max().item()
            t_tf32 = cuda_time(chain, reps=5)
        finally:
            torch.backends.cudnn.allow_tf32 = False
        log(f"  {tag}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms (median); in turns kernel "
            f"{t_kt:.4f} ms, cuDNN fp32 conv+BN+GELU chain (TF32 off) {t_c:.4f} ms, ratio "
            f"{t_kt / t_c:.3f}; cuDNN chain with TF32 on {t_tf32:.4f} ms, max_abs_err "
            f"{tf32_err:.3e}; bound {bound:.4f} ms (3xTF32 operations), fp32 bound "
            f"{bound_f32:.4f} ms (67 TFLOP/s)")
        dev = device_rate(tag, kernel, ("conv3x3_bn_gelu_tf32x3",), bound, flop=flop)[0]
        if dev is not None:
            log(f"  {tag}: device {100 * bound_f32 / dev:.1f} % of the fp32 bound")
        devs.append(dev)
        for k, v in (("kernel", t_k), ("plain", t_p), ("turns", t_kt), ("chain", t_c),
                     ("tf32", t_tf32), ("flop", flop), ("bound", bound),
                     ("bound_f32", bound_f32)):
            tot[k] += v
        del x, w, args, ref, out
        torch.cuda.empty_cache()
    if None in devs:
        device = "device not measured"
    else:
        dev_ms = sum(devs)
        device = (f"device {dev_ms:.4f} ms ({tot['flop'] / dev_ms / 1e9:.1f} TFLOP/s, "
                  f"{100 * tot['bound'] / dev_ms:.1f} % of the 3xTF32 bound, "
                  f"{100 * tot['bound_f32'] / dev_ms:.1f} % of the fp32 bound)")
    log(f"  fp32 sum over the six sites at N={n} (one encoder's necks): kernel "
        f"{tot['kernel']:.4f} ms, plain {tot['plain']:.4f} ms, bound {tot['bound']:.4f} ms "
        f"(3x {tot['flop'] / 1e9:.1f} GFLOP at 495 TFLOP/s), fp32 bound "
        f"{tot['bound_f32']:.4f} ms (67 TFLOP/s); {device}; in turns kernel "
        f"{tot['turns']:.4f} ms vs cuDNN fp32 chain {tot['chain']:.4f} ms, ratio "
        f"{tot['turns'] / tot['chain']:.3f}; cuDNN chain with TF32 on {tot['tf32']:.4f} ms")
    return errs


def conv_f64(g, site):
    """Kernel 2 in fp32 and the plain version (cuDNN, TF32 off) against a
    float64 conv at ``site`` (N=2; ``neck_f3_conv0``: K = 27648 behind a
    ResNet-50, 34560 behind a ViT-B/16), on random operands and on operands
    exact in TF32, where only the sums differ: the 3xTF32 kernel adds each
    step's products into an fp32 sum and has to hold fp32 accuracy over the
    whole K."""
    name, cin, cout, side = site
    x, w, bias, gamma, beta, mean, var = neck_inputs(2, cin, cout, side, torch.float32, g)
    s = gamma.double() / torch.sqrt(var.double() + 1e-5)
    t = (bias.double() - mean.double()) * s + beta.double()
    errs = []
    for what in ("random", "TF32-exact"):
        if what == "TF32-exact":
            x, w = cl(k2.rna_tf32(x)), k2.rna_tf32(w)
        args = (x, w, bias, gamma, beta, mean, var)
        exact = F.gelu(F.conv2d(x.double(), w.double(), padding=1) * s[:, None, None]
                       + t[:, None, None])
        plain = (k2.conv3x3_bn_gelu_ref(*args).double() - exact).abs().max().item()
        errs.append(check(f"float32 {name} N=2, K={9 * cin}, {what} operands, kernel "
                          f"against float64", k2.conv3x3_bn_gelu(*args), exact, torch.float32))
        log(f"  float32 {name} N=2, K={9 * cin}, {what} operands: plain version against "
            f"float64 max_abs_err {plain:.3e}")
    return errs


def conv_bf16(n, g, necks):
    """Kernel 2 in bf16 at ``necks``' sites at N=n: its error against the
    plain version, kernel and plain ms, the kernel against cuDNN's bf16
    chain in turns, the device time and its share of the bound, and at a
    Cout of 256s both channel tiles in turns.  Returns the errors and the
    sums over the sites."""
    errs, ms, plain_ms, lib_ms, flop, devs = [], 0.0, 0.0, 0.0, 0, []
    turns_k = 0.0
    for name, cin, cout, side in necks:
        dtype = torch.bfloat16
        args = neck_inputs(n, cin, cout, side, dtype, g)
        x, w, bias, gamma, beta, mean, var = args
        tag = f"{str(dtype)[6:]} {name} N={n} ({side}^2, {cin}->{cout})"
        errs.append(check(tag, k2.conv3x3_bn_gelu(*args), k2.conv3x3_bn_gelu_ref(*args),
                          dtype))
        t_k = cuda_time(lambda: k2.conv3x3_bn_gelu(*args), reps=5)
        t_p = cuda_time(lambda: k2.conv3x3_bn_gelu_ref(*args), reps=5)
        log(f"  {tag}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms (median)")
        ms += t_k
        plain_ms += t_p
        site_flop = 2 * n * side * side * 9 * cin * cout
        flop += site_flop
        bound = site_flop / BF16_FLOP_PER_S * 1e3
        xb, wb = x, w.to(dtype).contiguous(memory_format=torch.channels_last)
        chain = lambda: F.gelu(F.batch_norm(  # noqa: E731
            F.conv2d(xb, wb, bias.to(dtype), padding=1),
            mean, var, gamma, beta, False, 0.0, 1e-5))
        t_kt, t_c = in_turns(lambda: k2.conv3x3_bn_gelu(*args), chain, reps=5)
        log(f"  {tag}: in turns kernel {t_kt:.4f} ms, cuDNN bf16 conv+BN+GELU chain "
            f"{t_c:.4f} ms, ratio {t_kt / t_c:.3f}")
        turns_k += t_kt
        lib_ms += t_c
        devs.append(device_rate(tag, lambda: k2.conv3x3_bn_gelu(*args),
                                ("conv3x3_bn_gelu_wgmma",), bound, flop=site_flop)[0])
        if cout % 256 == 0:  # the channel tile, chosen by this comparison
            t256, t128 = in_turns(lambda: k2.conv3x3_bn_gelu(*args, _tile_n=256),
                                  lambda: k2.conv3x3_bn_gelu(*args, _tile_n=128), reps=5)
            log(f"  {tag}: in turns 128x256 tiles {t256:.4f} ms, 128x128 tiles "
                f"{t128:.4f} ms (default {k2.tile_n(cout, dtype)})")
        del x, w, args
    torch.cuda.empty_cache()
    bound = flop / BF16_FLOP_PER_S * 1e3
    if None in devs:
        device = "device not measured"
    else:
        dev_ms = sum(devs)
        device = (f"device {dev_ms:.4f} ms ({flop / dev_ms / 1e9:.1f} TFLOP/s, "
                  f"{100 * bound / dev_ms:.1f} % of the bound)")
    log(f"  bf16 sum over the six sites at N={n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, bound {bound:.4f} ms ({flop / 1e9:.1f} GFLOP); {device}; in turns kernel "
        f"{turns_k:.4f} ms vs cuDNN chain {lib_ms:.4f} ms, ratio {turns_k / lib_ms:.3f}")
    return errs, {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "library_ms": lib_ms}


def phase_conv(n):
    log(f"== phase 3b: conv3x3_bn_gelu (CUDA) vs plain, N={n}, random BN running stats")
    r = cl(torch.randn(1, 6, 4, 4, device=DEV))
    ones = torch.ones(8, device=DEV)
    expect_value_error("fp32 Cin=6", lambda: k2.conv3x3_bn_gelu(
        r, torch.randn(8, 6, 3, 3, device=DEV), None, ones, ones, ones, ones))
    g = gen(3)
    errs, sums = conv_bf16(n, g, NECKS)
    # fp32, the validation route's dtype: its accuracy against float64, then a
    # validation batch (N=B_VAL) and a tta_mc test batch's views (the prefix
    # runs the necks once on 4 x B_VAL)
    errs += conv_f64(g, NECKS[4])
    for n_f32 in (B_VAL, N_TEST_VIEWS):
        errs += conv_f32(n_f32, g, NECKS)
    return {"max_abs_err": max(errs), **sums, "bound_by": "operations"}


def attn_inputs(bh, dtype, g, n=4):
    return [torch.randn(bh, SEQ, HEAD_DIM, device=DEV, generator=g).to(dtype)
            for _ in range(n)]


# the fp32 forward's kernels (the K/V pre-pass, twice a call, and the 3xTF32
# kernel), as the profiler names them
F32_FWD_KERNELS = ("flash_split", "flash_fwd_tf32x3")


def attention_f64(q, k, v, scale, heads=4):
    """``(out, lse)`` of attention in float64 over (BH, N, D), ``heads`` at a time."""
    out = torch.empty(q.shape, device=DEV, dtype=torch.float64)
    lse = torch.empty(q.shape[:2], device=DEV, dtype=torch.float64)
    for h0 in range(0, q.shape[0], heads):
        sl = slice(h0, h0 + heads)
        s = torch.einsum("bqd,bkd->bqk", q[sl].double(), k[sl].double()) * scale
        lse[sl] = torch.logsumexp(s, -1)
        out[sl] = torch.exp(s - lse[sl, :, None]) @ v[sl].double()
        del s
    return out, lse


def flash_f64(g):
    """The fp32 forward (3xTF32, each key tile's P V into a sum of its own)
    and the plain version against a float64 attention at (32, SEQ,
    HEAD_DIM), on unit-scale operands and with q, k scaled by 1.5 (scores of
    standard deviation 2.25, where one TF32 product would miss the
    tolerance: tests/test_torch_flash_f32.py).  Returns the kernel's errors."""
    errs = []
    scale = HEAD_DIM ** -0.5
    for what, qk_scale in (("unit operands", 1.0), ("q, k x 1.5", 1.5)):
        q, k = (torch.randn(32, SEQ, HEAD_DIM, device=DEV, generator=g) * qk_scale
                for _ in range(2))
        v = torch.randn(32, SEQ, HEAD_DIM, device=DEV, generator=g)
        out64, lse64 = attention_f64(q, k, v, scale)
        tag = f"float32 BH=32 D={HEAD_DIM}, {what}"
        out, lse = fa.flash_forward(q, k, v, scale)
        errs.append(check(f"{tag}, kernel out against float64", out, out64, torch.float32))
        errs.append(check(f"{tag}, kernel lse against float64", lse, lse64, torch.float32))
        o, l_ = fa.flash_attention_ref(q, k, v, scale)
        log(f"  {tag}, plain version against float64: out max_abs_err "
            f"{(o.double() - out64).abs().max().item():.3e}, lse "
            f"{(l_.double() - lse64).abs().max().item():.3e}")
        del q, k, v, out64, lse64, out, lse, o, l_
        torch.cuda.empty_cache()
    return errs


def phase_flash_forward():
    log(f"== phase 3c: flash_attention forward (CUDA) vs plain, (B*H, N, D) = "
        f"(32 normal B=8 | 128 tta B=8 and a hybrid-nb validation batch B=32, {SEQ}, "
        f"{HEAD_DIM} | 64); fp32 (3xTF32) and bf16 against SDPA in turns")
    r = torch.randn(1, 1, 100, HEAD_DIM, device=DEV)
    expect_value_error("unaligned N=100", lambda: fa.flash_attention(r, r, r))
    expect_value_error("fp16", lambda: fa.flash_attention(r.half(), r.half(), r.half()))
    g = gen(6)
    errs, res = [], {}
    # bf16 at D=64 beside D=128: half the products, the same exponentials
    for bh, d, dtype in ((32, HEAD_DIM, torch.float32), (32, HEAD_DIM, torch.bfloat16),
                         (128, HEAD_DIM, torch.float32), (128, HEAD_DIM, torch.bfloat16),
                         (32, 64, torch.float32), (32, 64, torch.bfloat16)):
        scale = d ** -0.5
        q, k, v = (torch.randn(bh, SEQ, d, device=DEV, generator=g).to(dtype) for _ in range(3))
        tag = f"{str(dtype)[6:]} BH={bh} D={d}"
        f32 = dtype == torch.float32
        out, lse = fa.flash_forward(q, k, v, scale)
        ref_out, ref_lse = fa.flash_attention_ref(q, k, v, scale)
        errs.append(check(f"{tag} out", out, ref_out, dtype))
        errs.append(check(f"{tag} lse", lse, ref_lse, dtype))
        if f32 and not all(torch.equal(a, b) for a, b in
                           zip((out, lse), fa.flash_forward(q, k, v, scale))):
            raise AssertionError(f"{tag}: two calls differ")
        del out, lse, ref_out, ref_lse
        t_k = cuda_time(lambda: fa.flash_forward(q, k, v, scale), reps=3, trials=3)
        t_p = cuda_time(lambda: fa.flash_attention_ref(q, k, v, scale), reps=1, trials=3)
        # (B, H, N, D) views: PyTorch's fused backends take 4-D inputs only
        q4, k4, v4 = (t.view(bh // HEADS, HEADS, SEQ, d) for t in (q, k, v))
        t_l = cuda_time(lambda: F.scaled_dot_product_attention(q4, k4, v4), reps=3, trials=3)
        flop = 4 * bh * SEQ * SEQ * d
        # the bound of the kernel's own route: bf16 tensor cores, or 3xTF32
        bound = (3 * flop / TF32_FLOP_PER_S if f32 else flop / BF16_FLOP_PER_S) * 1e3
        log(f"  {tag}: kernel {t_k:.4f} ms ({flop / t_k / 1e9:.1f} TFLOP/s), plain "
            f"{t_p:.4f} ms, SDPA {t_l:.4f} ms (median); "
            + (f"{f32_bounds(flop)}" if f32 else f"bf16 bound {bound:.4f} ms")
            + f" ({flop / 1e12:.3f} TFLOP, {bh * SEQ * SEQ / 1e6:.0f}M exp)")
        t_kt, t_lt = in_turns(lambda: fa.flash_forward(q, k, v, scale),
                              lambda: F.scaled_dot_product_attention(q4, k4, v4),
                              reps=3, trials=3)
        log(f"  {tag}: in turns kernel {t_kt:.4f} ms, SDPA {t_lt:.4f} ms "
            f"({'fp32, TF32 off' if f32 else 'bf16'}), ratio {t_kt / t_lt:.3f}")
        device_rate(tag + (" (pre-pass + 3xTF32 kernel)" if f32 else ""),
                    lambda: fa.flash_forward(q, k, v, scale),
                    F32_FWD_KERNELS if f32 else ("flash_fwd_wgmma",), bound, flop=flop)
        res[(bh, d, dtype)] = (t_k, t_p, t_l, bound)
        del q, k, v, q4, k4, v4
        torch.cuda.empty_cache()
    errs += flash_f64(g)
    # the entry's times are bf16 at (32, SEQ, HEAD_DIM), the served shape;
    # "fp32" holds the 3xTF32 kernel's at (128, SEQ, HEAD_DIM), a hybrid-nb
    # validation batch's
    t_k, t_p, t_l, bound = res[(32, HEAD_DIM, torch.bfloat16)]
    f_k, f_p, f_l, f_bound = res[(128, HEAD_DIM, torch.float32)]
    return {"max_abs_err": max(errs), "ms": t_k, "plain_ms": t_p, "bound_ms": bound,
            "bound_by": "operations", "library_ms": t_l,
            "fp32": {"bh": 128, "ms": f_k, "plain_ms": f_p, "bound_ms": f_bound,
                     "library_ms": f_l}}


def f32_bounds(flop):
    """The fp32 operation bounds of ``flop``: on the CUDA cores (67 TFLOP/s)
    and as 3xTF32 on the tensor cores (3x the operations at 495 TFLOP/s)."""
    return (f"fp32 bounds {flop / FP32_FLOP_PER_S * 1e3:.4f} ms (67 TFLOP/s), "
            f"{3 * flop / TF32_FLOP_PER_S * 1e3:.4f} ms (3xTF32)")


def bwd_bounds(bh, d, el):
    """The bound (ms) of dQ and of dK/dV at (bh, SEQ, d), element size ``el``:
    the larger of their tensor-core operations (6 and 8 BH N^2 D; bf16, or
    fp32 as 3xTF32: 3x the operations at the TF32 rate) and their bytes (q,
    k, v, dout, lse, delta read once; dq, or dk and dv, written once) over
    the memory rate."""
    rows = bh * SEQ
    out = []
    for mult, outs in ((6, 1), (8, 2)):
        flop = mult * bh * SEQ * SEQ * d
        ops = 3 * flop / TF32_FLOP_PER_S if el == 4 else flop / BF16_FLOP_PER_S
        nbytes = (4 + outs) * rows * d * el + 2 * rows * 4
        out.append((max(ops, nbytes / HBM_BYTES_PER_S) * 1e3, flop))
    return out


# the fp32 backward's kernels as the profiler names them: the pre-pass that
# writes the streamed operands' images (twice a call) and each 3xTF32 kernel
F32_DQ_KERNELS = ("flash_split", "flash_bwd_dq_tf32x3")
F32_DKV_KERNELS = ("flash_split", "flash_bwd_dkv_tf32x3")


def attention_grads_f64(q, k, v, dout, scale, heads=4):
    """``(dq, dk, dv)`` of attention in float64 over (BH, N, D), ``heads`` at
    a time (autograd through the materialized softmax)."""
    grads = [torch.empty(t.shape, device=DEV, dtype=torch.float64) for t in (q, k, v)]
    for h0 in range(0, q.shape[0], heads):
        sl = slice(h0, h0 + heads)
        leaves = [t[sl].double().requires_grad_() for t in (q, k, v)]
        s = torch.einsum("bqd,bkd->bqk", leaves[0], leaves[1]) * scale
        got = torch.autograd.grad(torch.softmax(s, -1) @ leaves[2], leaves, dout[sl].double())
        for r, gr in zip(grads, got):
            r[sl] = gr
        del leaves, s, got
    return grads


def flash_bwd_f64(g):
    """The fp32 backward (3xTF32, each tile's product into a sum of its own)
    and autograd through the plain version against a float64 backward at
    (32, SEQ, HEAD_DIM) with q, k scaled by 1.5 (where one TF32 product
    would miss the tolerance: tests/test_torch_flash_f32.py), each error
    over max|float64|.  Returns the kernels' errors: ``(dq, dkv)``."""
    scale = HEAD_DIM ** -0.5
    q, k = (torch.randn(32, SEQ, HEAD_DIM, device=DEV, generator=g) * 1.5 for _ in range(2))
    v, dout = (torch.randn(32, SEQ, HEAD_DIM, device=DEV, generator=g) for _ in range(2))
    ref = attention_grads_f64(q, k, v, dout, scale)
    out, lse = fa.flash_forward(q, k, v, scale)
    delta = fa.backward_delta(out, dout)
    got = (fa.flash_bwd_dq(q, k, v, dout, lse, delta, scale),
           *fa.flash_bwd_dkv(q, k, v, dout, lse, delta, scale))
    plain = torch.empty_like(ref[0]), torch.empty_like(ref[1]), torch.empty_like(ref[2])
    for h0 in range(0, 32, 8):
        sl = slice(h0, h0 + 8)
        leaves = [t[sl].clone().requires_grad_() for t in (q, k, v)]
        for r, gr in zip(plain, torch.autograd.grad(fa.flash_attention_ref(*leaves, scale)[0],
                                                    leaves, dout[sl])):
            r[sl] = gr
    tag = f"float32 BH=32 D={HEAD_DIM}, q, k x 1.5"
    errs = []
    for name, a, p, r in zip(("dq", "dk", "dv"), got, plain, ref):
        errs.append(check_rel(f"{tag}, kernel {name} against float64", a, r, torch.float32))
        log(f"  {tag}, plain version {name} against float64: max_abs_err "
            f"{(p.double() - r).abs().max().item():.3e}")
    del q, k, v, dout, ref, out, lse, delta, got, plain
    torch.cuda.empty_cache()
    return errs[0], max(errs[1:])


def phase_flash_backward():
    log(f"== phase 3d: flash_attention backward (CUDA dQ, dK/dV) vs autograd through "
        f"the plain version, (B*H, N, D) = (32 | 128, {SEQ}, {HEAD_DIM} | 64), fp32 "
        f"(3xTF32) and bf16, seeded cotangent; two calls of each kernel compared bit for "
        f"bit; against SDPA's backward in turns (fp32: TF32 off); fp32 against float64")
    g = gen(7)
    errs = {"dq": [], "dkv": []}
    res = {}
    for bh, d, dtype in ((32, HEAD_DIM, torch.float32), (32, HEAD_DIM, torch.bfloat16),
                         (128, HEAD_DIM, torch.float32), (128, HEAD_DIM, torch.bfloat16),
                         (32, 64, torch.float32), (32, 64, torch.bfloat16)):
        scale = d ** -0.5
        q, k, v, dout = (torch.randn(bh, SEQ, d, device=DEV, generator=g).to(dtype)
                         for _ in range(4))
        tag = f"{str(dtype)[6:]} BH={bh} D={d}"
        out, lse = fa.flash_forward(q, k, v, scale)
        delta = fa.backward_delta(out, dout)

        def dq_call():
            return fa.flash_bwd_dq(q, k, v, dout, lse, delta, scale)

        def dkv_call():
            return fa.flash_bwd_dkv(q, k, v, dout, lse, delta, scale)

        dq, (dk, dv) = dq_call(), dkv_call()
        again = (dq_call(), *dkv_call())
        if not all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)):
            raise AssertionError(f"{tag}: two calls of a backward kernel differ")
        log(f"  {tag}: two calls of each kernel give the same bits")
        # the oracle, 32 heads at a time: the plain version materializes the
        # (heads, N, N) fp32 scores and weights
        ref = [torch.empty_like(t) for t in (q, k, v)]
        for h0 in range(0, bh, 32):
            sl = slice(h0, h0 + 32)
            leaves = [t[sl].detach().clone().requires_grad_() for t in (q, k, v)]
            grads = torch.autograd.grad(fa.flash_attention_ref(*leaves, scale)[0], leaves,
                                        dout[sl])
            for r, gr in zip(ref, grads):
                r[sl] = gr
            del leaves, grads
        errs["dq"].append(check_rel(f"{tag} dq", dq, ref[0], dtype))
        errs["dkv"].append(check_rel(f"{tag} dk", dk, ref[1], dtype))
        errs["dkv"].append(check_rel(f"{tag} dv", dv, ref[2], dtype))
        del dq, dk, dv, again, ref
        t_dq = cuda_time(dq_call, reps=3, trials=3)
        t_dkv = cuda_time(dkv_call, reps=3, trials=3)
        t_pdq = t_pdkv = None
        if bh == 32:  # the plain version's autograd at 128 heads would hold ~35 GB
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            ref_out = fa.flash_attention_ref(*leaves, scale)[0]
            t_pdq = cuda_time(lambda: torch.autograd.grad(ref_out, leaves[0], dout,
                                                          retain_graph=True), reps=1, trials=3)
            t_pdkv = cuda_time(lambda: torch.autograd.grad(ref_out, leaves[1:], dout,
                                                           retain_graph=True), reps=1, trials=3)
            del leaves, ref_out
        lib_leaves = [t.detach().clone().view(bh // HEADS, HEADS, SEQ, d).requires_grad_()
                      for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*lib_leaves)
        lib_dout = dout.view_as(lib_out)

        def sdpa_bwd():
            return torch.autograd.grad(lib_out, lib_leaves, lib_dout, retain_graph=True)

        t_l = cuda_time(sdpa_bwd, reps=3, trials=3)
        f32 = dtype == torch.float32
        (b_dq, f_dq), (b_dkv, f_dkv) = bwd_bounds(bh, d, q.element_size())
        plain = (f"plain {t_pdq:.4f} / {t_pdkv:.4f} ms" if t_pdq is not None
                 else "plain not timed at this size")
        log(f"  {tag}: dQ kernel {t_dq:.4f} ms ({f_dq / t_dq / 1e9:.1f} TFLOP/s, bound "
            f"{b_dq:.4f}); dK/dV kernel {t_dkv:.4f} ms ({f_dkv / t_dkv / 1e9:.1f} TFLOP/s, "
            f"bound {b_dkv:.4f}); {plain}; SDPA backward (dq, dk, dv in one call) "
            f"{t_l:.4f} ms (median)"
            + (f"; dQ {f32_bounds(f_dq)}; dK/dV {f32_bounds(f_dkv)}" if f32 else ""))
        t_kt, t_lt = in_turns(lambda: (dq_call(), dkv_call()), sdpa_bwd, reps=3, trials=3)
        log(f"  {tag}: in turns dQ + dK/dV {t_kt:.4f} ms, SDPA backward {t_lt:.4f} ms "
            f"({'fp32, TF32 off' if f32 else 'bf16'}), ratio {t_kt / t_lt:.3f}; their bound "
            f"{b_dq + b_dkv:.4f} ms")
        device_rate(f"{tag} dQ" + (" (pre-pass + 3xTF32 kernel)" if f32 else ""), dq_call,
                    F32_DQ_KERNELS if f32 else ("flash_bwd_dq_wgmma",), b_dq, flop=f_dq)
        device_rate(f"{tag} dK/dV" + (" (pre-pass + 3xTF32 kernel)" if f32 else ""), dkv_call,
                    F32_DKV_KERNELS if f32 else ("flash_bwd_dkv_wgmma",), b_dkv, flop=f_dkv)
        res[(bh, d, dtype)] = (t_dq, t_pdq, b_dq, t_dkv, t_pdkv, b_dkv, t_l)
        del q, k, v, dout, out, lse, delta, lib_leaves, lib_out, lib_dout
        torch.cuda.empty_cache()
    e_dq, e_dkv = flash_bwd_f64(g)
    errs["dq"].append(e_dq)
    errs["dkv"].append(e_dkv)
    # the entries' times are bf16 at (32, SEQ, HEAD_DIM), the served shape;
    # "fp32" holds the 3xTF32 kernels' at the same shape, the fp32 stage
    # backward's at B=8 (phase 3h)
    t_dq, t_pdq, b_dq, t_dkv, t_pdkv, b_dkv, t_l = res[(32, HEAD_DIM, torch.bfloat16)]
    f_dq, f_pdq, fb_dq, f_dkv, f_pdkv, fb_dkv, f_l = res[(32, HEAD_DIM, torch.float32)]
    return ({"max_abs_err": max(errs["dq"]), "ms": t_dq, "plain_ms": t_pdq,
             "bound_ms": b_dq, "bound_by": "operations", "library_ms": t_l,
             "fp32": {"bh": 32, "ms": f_dq, "plain_ms": f_pdq, "bound_ms": fb_dq,
                      "library_ms": f_l}},
            {"max_abs_err": max(errs["dkv"]), "ms": t_dkv, "plain_ms": t_pdkv,
             "bound_ms": b_dkv, "bound_by": "operations", "library_ms": t_l,
             "fp32": {"bh": 32, "ms": f_dkv, "plain_ms": f_pdkv, "bound_ms": fb_dkv,
                      "library_ms": f_l}})


# ------------------------------------------------------------------ phase 3i
ATTN_DROP = 0.1  # the hybrid stage's attention dropout (models/transformer.py)
# the dropout forward's cases: (dtype, D, rows, first pass, passes, counter
# base). The served shape is a hybrid-nb tta_mc B=2 request's suffix at
# mc_chunk 1: 2 volumes x 4 views of one pass, 4 heads (BH = 32); then D=64,
# and mc_chunk 3's three passes (BH = 96)
DROP_CASES = ((torch.bfloat16, HEAD_DIM, 8, 4, 1, 2 ** 33),
              (torch.float32, HEAD_DIM, 8, 4, 1, 2 ** 33),
              (torch.bfloat16, 64, 8, 0, 1, 0), (torch.float32, 64, 8, 0, 1, 0),
              (torch.bfloat16, HEAD_DIM, 24, 3, 3, 4 * 10 ** 9))
# the mask windows of 3i(b): (first pass, passes, counter base, heads of the
# call, first head) on rows of 2 volumes a pass, 4 heads in all
MASK_CASES = ((0, 1, 0, HEADS, 0), (5, 2, 2 ** 33 + 4, HEADS, 0), (3, 1, 1000, 2, 2),
              (0, 2, 2 ** 32 - 2, 2, 0))


def flash_dropout_ref_by_pass(q, k, v, scale, seed, base, first, passes):
    """The plain version a pass at a time: pass i's mask is its own pass
    word's, so the passes' outputs stack to the whole call's.  The oracle
    of a bf16 kernel takes the operands in fp32: the plain version in bf16
    is the weights route, which rounds the logits to bf16 as JAX's XLA route
    does, where the kernel keeps S in fp32 (as flash_attention_ref does)."""
    rows = q.shape[0] // passes
    return torch.cat([fa.flash_attention_dropout_ref(
        q[i * rows:(i + 1) * rows], k[i * rows:(i + 1) * rows], v[i * rows:(i + 1) * rows],
        scale, ATTN_DROP, seed, base, first + i, 1) for i in range(passes)])


def flash_dropout_mask_bits(seed):
    """3i(b): with q = 0 every score is 0, P is uniform and l = N_k; with V
    one-hot over a window of 128 keys (V[k, d] = 1 for k = w + d), out[q, d] =
    keep(q, w + d) / (N_k (1 - p)).  So ``out != 0`` is the kernel's mask of
    that window, held bit for bit against the keep-mask kernel's mask of the
    whole (B, H, N, N) weights, at the first and the last window, in bf16 and
    fp32, on each instance a case allows (the per-element one always, the
    head-shared one where ``fa.dropout_group`` gives G > 1); the kept values
    against 1 / (N_k (1 - p)).  Returns the windows."""
    n = 0
    for dtype in (torch.bfloat16, torch.float32):
        for first, passes, base, local, h0 in MASK_CASES:
            b = 2 * passes
            q = torch.zeros(b, local, SEQ, HEAD_DIM, device=DEV, dtype=dtype)
            k = torch.randn(b, local, SEQ, HEAD_DIM, device=DEV, generator=gen(31)).to(dtype)
            whole = q.new_empty(()).expand(b, HEADS, SEQ, SEQ)
            keep = epilogue_cuda.keep_mask(whole, ATTN_DROP, seed, base, first, passes)
            group = fa.dropout_group(HEADS, h0, local, base)
            for g in sorted({1, group}):
                for w in (0, SEQ - HEAD_DIM):
                    v = torch.zeros(b, local, SEQ, HEAD_DIM, device=DEV, dtype=dtype)
                    v[:, :, w:w + HEAD_DIM] = torch.eye(HEAD_DIM, device=DEV, dtype=dtype)
                    out = fa.launch_flash_forward_dropout(q, k, v, HEAD_DIM ** -0.5, ATTN_DROP,
                                                          seed, base, first, passes, HEADS, h0,
                                                          g)[0]
                    want = keep[:, h0:h0 + local, :, w:w + HEAD_DIM]
                    tag = (f"3i(b) {str(dtype)[6:]} G={g} passes {first}..{first + passes - 1} "
                           f"base {base} heads {h0}..{h0 + local - 1} of {HEADS}, keys "
                           f"{w}..{w + 127}")
                    if not torch.equal(out != 0, want):
                        raise AssertionError(f"{tag}: {(out != 0).ne(want).sum().item()} keep "
                                             f"bits differ from the keep-mask kernel's")
                    kept = out[want].float()
                    value = 1.0 / (SEQ * (1.0 - ATTN_DROP))
                    err = (kept - value).abs().max().item() / value
                    if not err <= TOL[dtype]:
                        raise AssertionError(f"{tag}: kept values {err} off 1/(N(1-p))")
                    n += 1
            del q, k, v, out, keep, want
    log(f"  3i(b): the kernels' keep bits equal the keep-mask kernel's in {n} windows of "
        f"{SEQ} queries x 128 keys x heads x rows (first and last window; pass words 0..6; "
        f"counter bases 0, 1000, 2^32 - 2, 2^33 + 4; whole heads and a 2-way shard's h0 = "
        f"0, 2), bf16 and fp32, the per-element instance on every case and the head-shared "
        f"one on G = 4 (bases 0, 2^33 + 4) and G = 2 (the shard at base 1000); kept values "
        f"within TOL of 1/(N_k (1-p))")
    return n


def drop_sass(smi_clock):
    """SASS instructions a Philox call of each dropout instance (``ops/sass.py``
    on ``cuobjdump -sass`` of the built library), by (dtype, D): a
    diagnostic beside the function's integer floor; the forward instances'
    and the pre-pass's SASS is kept beside the build log."""
    lib = build_library("flash_attention", fa._SOURCES)
    text = sass.dump(str(lib))
    (lib.parent / "flash_fwd.sass").write_text(sass.select(text, ("flash_fwd_", "draw_bits")))
    out = {}
    for dtype, kernel in ((torch.bfloat16, "flash_fwd_wgmma"), (torch.float32, "flash_fwd_tf32x3")):
        for d in (HEAD_DIM, 64):
            out[(dtype, d)] = sass.per_call(text, kernel, d, fa.dropout_key_tile(dtype, d))
            log(f"  3i SASS {kernel} D={d}: " + ", ".join(
                f"{k} {v:.1f} instructions a call" for k, v in out[(dtype, d)].items())
                + " (cuobjdump -sass; the head-shared one in its pre-pass draw_bits)")
    log(f"  3i integer floor: {sass.PHILOX_CALL_INSTRUCTIONS} SASS instructions a Philox call "
        f"(the rounds and keep tests a call needs at least, ops/sass.py) x the calls the keep "
        f"bits need (one a counter group of 4) / (132 SMs x 128 a clock x the SM clock, "
        f"{smi_clock} MHz), the same for both instances")
    return out


def sm_clock_mhz():
    """The SM clock's maximum, as nvidia-smi reports it (MHz)."""
    return float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                 "--format=csv,noheader,nounits"], capture_output=True,
                                text=True, check=True, timeout=60).stdout.split()[0])


def phase_flash_dropout():
    """Phase 3i: the forward kernels' dropout instances (the MC attention of
    the seed route), the head-shared one (the served path's) and the
    per-element one on the same inputs: bit-equal, against the plain version
    at the served shapes, timed in turns beside the same kernel at p = 0,
    the plain version, SDPA with ``dropout_p`` (a yardstick, never on the
    path; its own mask) and both bounds (the tensor cores' and the integer
    issue of the Philox calls the keep bits need, the same for both
    instances); then the keep bits (3i(b))."""
    log(f"== phase 3i: flash forward with attention dropout {ATTN_DROP} (CUDA) vs plain, "
        f"(B, {HEADS}, {SEQ}, D): a hybrid-nb tta_mc B=2 suffix at mc_chunk 1 (B = 8) and 3 "
        f"(B = 24, 3 pass words), bf16 and fp32 (3xTF32), the head-shared instance "
        f"(a pre-pass makes one Philox call for G heads) and the per-element one")
    seed = torch.tensor([(0x5EED << 32) | 39], device=DEV)
    r = torch.randn(2, 2, 128, 64, device=DEV)
    expect_value_error("p = 0", lambda: fa.launch_flash_forward_dropout(
        r, r, r, 0.125, 0.0, seed, 0, 0, 1, 2, 0, 1))
    expect_value_error("a head past the whole count", lambda: fa.launch_flash_forward_dropout(
        r, r, r, 0.125, ATTN_DROP, seed, 0, 0, 1, 2, 1, 1))
    clock = sm_clock_mhz()
    per_call = drop_sass(clock)
    g = gen(39)
    errs, res = [], {}
    for dtype, d, b, first, passes, base in DROP_CASES:
        scale = d ** -0.5
        q, k, v = (torch.randn(b, HEADS, SEQ, d, device=DEV, generator=g).to(dtype)
                   for _ in range(3))
        group = fa.dropout_group(HEADS, 0, HEADS, base)
        tag = (f"{str(dtype)[6:]} B={b} (BH={b * HEADS}) D={d} passes {first}.."
               f"{first + passes - 1} base {base}")
        f32 = dtype == torch.float32

        def kernel(grp=group):
            return fa.launch_flash_forward_dropout(q, k, v, scale, ATTN_DROP, seed, base, first,
                                                   passes, HEADS, 0, grp)[0]

        out = kernel()
        errs.append(check(f"3i {tag} head-shared (G={group}) out against the plain version on "
                          f"fp32 operands", out, flash_dropout_ref_by_pass(
                              q.float(), k.float(), v.float(), scale, seed, base, first,
                              passes), dtype))
        if not f32:
            gap = (out.float() - flash_dropout_ref_by_pass(q, k, v, scale, seed, base, first,
                                                           passes).float()).abs().max().item()
            log(f"  3i {tag}: against the plain version in bf16 (the weights route, logits "
                f"rounded to bf16) {gap:.3e}")
        if not torch.equal(out, kernel()):
            raise AssertionError(f"3i {tag}: two calls differ")
        if not torch.equal(out, kernel(1)):
            raise AssertionError(f"3i {tag}: the head-shared instance differs from the "
                                 f"per-element one")
        log(f"  3i {tag}: the head-shared and the per-element instance bit-equal, two calls "
            f"bit-equal")
        del out
        q3, k3, v3 = (t.view(b * HEADS, SEQ, d) for t in (q, k, v))
        # in turns: shared, per-element, per-element, shared
        t_s, t_e = in_turns(kernel, lambda: kernel(1), reps=3, trials=3)
        t_0 = cuda_time(lambda: fa.flash_forward(q3, k3, v3, scale), reps=3, trials=3)
        t_p = cuda_time(lambda: flash_dropout_ref_by_pass(q, k, v, scale, seed, base, first,
                                                          passes), reps=1, trials=3)
        t_l = cuda_time(lambda: F.scaled_dot_product_attention(q, k, v, dropout_p=ATTN_DROP),
                        reps=3, trials=3)
        flop = 4 * b * HEADS * SEQ * SEQ * d
        tensor = (3 * flop / TF32_FLOP_PER_S if f32 else flop / BF16_FLOP_PER_S) * 1e3
        # the integer floor: the Philox calls the keep bits need (one for the 4
        # heads of a weight), the same for both instances
        calls = sass.philox_calls(b // passes * HEADS * SEQ * SEQ, passes, base)
        floor = sass.issue_floor_ms(calls, clock)
        bound = max(tensor, floor)
        entry = {"plain_ms": t_p, "library_ms": t_l, "p0_ms": t_0, "tensor_bound_ms": tensor,
                 "integer_bound_ms": floor, "bound_ms": bound, "calls": calls,
                 "sm_clock_mhz": clock}
        log(f"  3i {tag}: the kernel at p = 0 {t_0:.4f} ms, plain {t_p:.4f} ms, SDPA "
            f"dropout_p={ATTN_DROP} {t_l:.4f} ms (median); tensor bound {tensor:.4f} ms "
            f"(operations: " + ("3x the products at 495 TFLOP/s" if f32 else
                                "bf16 at 989 TFLOP/s") + f"); integer floor {floor:.4f} ms "
            f"({calls / 1e6:.0f}M Philox calls x {sass.PHILOX_CALL_INSTRUCTIONS} instructions); "
            f"bound {bound:.4f} ms, both instances")
        forward = F32_FWD_KERNELS if f32 else ("flash_fwd_wgmma",)
        for name, t_k, made, grp in (("head_shared", t_s, calls * 4 // group, group),
                                     ("per_element", t_e, calls * 4, 1)):
            dev, _ = device_rate(f"3i {tag} {name} (G={grp})", lambda: kernel(grp),
                                 (("draw_bits",) if grp > 1 else ()) + forward, bound, flop=flop)
            shares = (f"{100 * tensor / dev:.1f} % of the tensor bound, {100 * floor / dev:.1f} "
                      f"% of the integer floor" if dev else "device time not measured")
            ipc = per_call[(dtype, d)][name]
            log(f"  3i {tag} {name} (G={grp}): kernel {t_k:.4f} ms (x{t_k / t_0:.2f} p = 0, "
                f"x{t_k / t_l:.2f} SDPA with dropout_p), device "
                + ("not measured" if dev is None else f"{dev:.4f} ms") + f" ({shares}); "
                f"{made / 1e6:.0f}M Philox calls made, {ipc:.1f} SASS instructions a call")
            entry[name] = {"ms": t_k, "device_ms": dev, "bound_ms": bound,
                           "sass_per_call": ipc, "calls_made": made}
        log(f"  3i {tag}: head-shared / per-element {t_s / t_e:.3f} in turns")
        res[(dtype, d, b)] = entry
        del q, k, v, q3, k3, v3
        torch.cuda.empty_cache()
    windows = flash_dropout_mask_bits(seed)
    torch.cuda.empty_cache()
    # the entry's times: the head-shared instance (the served path's) in bf16
    # at the served (8, 4, 4096, 128); "fp32" the 3xTF32 kernel's
    served = res[(torch.bfloat16, HEAD_DIM, 8)]
    return {"max_abs_err": max(errs), "ms": served["head_shared"]["ms"],
            "plain_ms": served["plain_ms"], "bound_ms": served["bound_ms"],
            "bound_by": "operations", "library_ms": served["library_ms"],
            "tensor_bound_ms": served["tensor_bound_ms"],
            "integer_bound_ms": served["integer_bound_ms"],
            "per_element_ms": served["per_element"]["ms"], "p0_ms": served["p0_ms"],
            "mask_windows": windows, "fp32": res[(torch.float32, HEAD_DIM, 8)],
            "d64": {str(dt)[6:]: res[(dt, 64, 8)] for dt in (torch.bfloat16, torch.float32)}}


# ------------------------------------------------------------------ phase 3j
# the backward's dropout instances: (dtype, D) held at (B_DROP_BWD, 4, 4096, D)
# against a float64 backward, timed at (B_DROP_BWD_TIMED, 4, 4096, 128), the
# training route's shape at the config's batch (32 volumes, 4 heads)
B_DROP_BWD, B_DROP_BWD_TIMED = 8, 32
DROP_BWD_CASES = ((torch.bfloat16, HEAD_DIM, 2 ** 33), (torch.float32, HEAD_DIM, 2 ** 33),
                  (torch.bfloat16, 64, 0), (torch.float32, 64, 0))
# the backward's dropout kernels as the profiler names them (the pre-pass
# draw_bits, twice a step, and, fp32, the image pre-pass flash_split)
DQ_DROP_KERNELS = {torch.bfloat16: ("draw_bits", "flash_bwd_dq_wgmma"),
                   torch.float32: ("draw_bits", "flash_split", "flash_bwd_dq_tf32x3")}
DKV_DROP_KERNELS = {torch.bfloat16: ("draw_bits", "flash_bwd_dkv_wgmma"),
                    torch.float32: ("draw_bits", "flash_split", "flash_bwd_dkv_tf32x3")}


def dropout_grads_f64(q, k, v, dout, keep, scale, pairs=4):
    """``(dq, dk, dv)`` in float64 of softmax(Q K^T scale) * keep / (1 - p)
    times V over (B, H, N, D), ``pairs`` (b, h) at a time (autograd through
    the materialized weights); ``keep`` the (B, H, N, N) mask."""
    B, H = q.shape[:2]
    flat = [t.reshape(B * H, *t.shape[2:]) for t in (q, k, v, dout)]
    keep = keep.reshape(B * H, *keep.shape[2:])
    grads = [torch.empty(t.shape, device=DEV, dtype=torch.float64) for t in flat[:3]]
    for i in range(0, B * H, pairs):
        sl = slice(i, i + pairs)
        leaves = [t[sl].double().requires_grad_() for t in flat[:3]]
        w = torch.softmax(torch.einsum("bqd,bkd->bqk", leaves[0], leaves[1]) * scale, -1)
        out = torch.where(keep[sl], w / (1.0 - ATTN_DROP), 0.0) @ leaves[2]
        for r, gr in zip(grads, torch.autograd.grad(out, leaves, flat[3][sl].double())):
            r[sl] = gr
        del leaves, w, out
    return [g.view(q.shape[0], H, *g.shape[1:]) for g in grads]


def dropout_bwd_mask_bits(seed):
    """3j(b): the backward kernels' keep bits against the keep-mask kernel's.
    With q = 0, P = 1/N_k and lse = log N_k; with delta = 0, dS = P dP~ keep
    / (1 - p).  dQ: K one-hot over a window of 128 keys (K[k, d] = 1 for k =
    w + d) and dO, V both e_0 rows (dP~ = 1), so dQ[q, d] = scale keep(q, w +
    d) / (N_k (1 - p)): ``dq != 0`` is the mask of the window.  dV: dO one-hot
    over a window of 128 queries, so dV[k, d] = P~[w + d, k]: ``dv != 0`` is
    the window's mask transposed (the dK/dV kernel's key-major bits).  First
    and last window, bf16 and fp32, both pre-passes where the case allows
    (G = 4 or 2, and one Philox call a weight).  Returns the windows."""
    n = 0
    for dtype in (torch.bfloat16, torch.float32):
        for first, passes, base, local, h0 in MASK_CASES:
            b = 2 * passes
            zeros = torch.zeros(b, local, SEQ, HEAD_DIM, device=DEV, dtype=dtype)
            e0 = zeros.clone()
            e0[..., 0] = 1.0
            rnd = torch.randn(b, local, SEQ, HEAD_DIM, device=DEV, generator=gen(33)).to(dtype)
            lse = torch.full((b, local, SEQ), math.log(SEQ), device=DEV)
            delta = torch.zeros_like(lse)
            whole = zeros.new_empty(()).expand(b, HEADS, SEQ, SEQ)
            keep = epilogue_cuda.keep_mask(whole, ATTN_DROP, seed, base, first, passes)
            keep = keep[:, h0:h0 + local]
            args = (HEAD_DIM ** -0.5, ATTN_DROP, seed, base, first, passes, HEADS, h0)
            group = fa.dropout_group(HEADS, h0, local, base)
            for g in sorted({1, group}):
                for w in (0, SEQ - HEAD_DIM):
                    hot = zeros.clone()
                    hot[:, :, w:w + HEAD_DIM] = torch.eye(HEAD_DIM, device=DEV, dtype=dtype)
                    dq = fa.launch_flash_bwd_dq_dropout(zeros, hot, e0, e0, lse, delta, *args, g)
                    dv = fa.launch_flash_bwd_dkv_dropout(zeros, rnd, rnd, hot, lse, delta, *args,
                                                         g)[1]
                    tag = (f"3j(b) {str(dtype)[6:]} G={g} passes {first}..{first + passes - 1} "
                           f"base {base} heads {h0}..{h0 + local - 1} of {HEADS}, window "
                           f"{w}..{w + 127}")
                    for name, got, want in (
                            ("dQ", dq != 0, keep[..., w:w + HEAD_DIM]),
                            ("dK/dV", dv != 0, keep[:, :, w:w + HEAD_DIM].transpose(2, 3))):
                        if not torch.equal(got, want):
                            raise AssertionError(f"{tag}: {name} kernel's keep bits differ from "
                                                 f"the keep-mask kernel's in "
                                                 f"{got.ne(want).sum().item()} places")
                    n += 1
            del zeros, e0, rnd, keep, hot, dq, dv
    log(f"  3j(b): the dQ and dK/dV kernels' keep bits equal the keep-mask kernel's in {n} "
        f"windows of {SEQ} x 128 weights x heads x rows each (first and last; pass words "
        f"0..6; counter bases 0, 1000, 2^32 - 2, 2^33 + 4; whole heads and a 2-way shard), "
        f"bf16 and fp32, the one-call-a-weight pre-pass on every case and the head-shared "
        f"one on G = 4 and G = 2")
    return n


def phase_flash_dropout_backward():
    """Phase 3j: the dQ and dK/dV kernels' dropout instances (the training
    route's attention dropout) on the dropout forward's out and lse: bf16
    against their plain versions on fp32 operands, fp32 against a float64
    backward of the weights route on the same keep mask (the plain
    versions' own error beside it), two calls bit-equal, their keep bits
    (3j(b)); then timed at the training shape
    beside the same kernels at p = 0, the plain version, SDPA's backward
    with ``dropout_p`` (a yardstick, its own mask), the tensor bound and the
    integer floor of the Philox calls each pre-pass makes."""
    log(f"== phase 3j: flash backward with attention dropout {ATTN_DROP} (CUDA dQ, dK/dV "
        f"dropout instances) at ({B_DROP_BWD}, {HEADS}, {SEQ}, {HEAD_DIM} | 64), bf16 vs "
        f"the plain version and fp32 (3xTF32) vs a float64 backward; timed at "
        f"({B_DROP_BWD_TIMED}, {HEADS}, {SEQ}, {HEAD_DIM})")
    seed = torch.tensor([(0x5EED << 32) | 41], device=DEV)
    g = gen(45)
    errs = []
    for dtype, d, base in DROP_BWD_CASES:
        scale = d ** -0.5
        b = B_DROP_BWD
        q, k, v, dout = (torch.randn(b, HEADS, SEQ, d, device=DEV, generator=g).to(dtype)
                         for _ in range(4))
        args = (scale, ATTN_DROP, seed, base, 0, 1, HEADS, 0)
        out, lse = fa.launch_flash_forward_dropout(q, k, v, *args, 4)
        delta = fa.backward_delta(out, dout)

        def kernels():
            return (fa.launch_flash_bwd_dq_dropout(q, k, v, dout, lse, delta, *args, 4),
                    *fa.launch_flash_bwd_dkv_dropout(q, k, v, dout, lse, delta, *args, 4))

        got = kernels()
        if not all(torch.equal(a, c) for a, c in zip(got, kernels())):
            raise AssertionError(f"3j {dtype} D={d}: two calls differ")
        whole = q.new_empty(()).expand(b, HEADS, SEQ, SEQ)
        keep = epilogue_cuda.keep_mask(whole, ATTN_DROP, seed, base)
        ref = dropout_grads_f64(q, k, v, dout, keep, scale)
        # the plain versions on the same lse and delta, fp32 operands
        qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
        plain = (fa.flash_bwd_dq_dropout_ref(qf, kf, vf, dof, lse, delta, *args),
                 *fa.flash_bwd_dkv_dropout_ref(qf, kf, vf, dof, lse, delta, *args))
        tag = f"3j {str(dtype)[6:]} (B, H, N, D) = ({b}, {HEADS}, {SEQ}, {d}) base {base}"
        for name, a, p_, r in zip(("dq", "dk", "dv"), got, plain, ref):
            if dtype == torch.float32:  # fp32 against float64, as 3c-3d
                errs.append(check_rel(f"{tag} kernel {name} against float64", a, r, dtype))
                log(f"  {tag} plain version {name} against float64: max_abs_err "
                    f"{(p_.double() - r).abs().max().item():.3e}")
            else:
                errs.append(check_rel(f"{tag} kernel {name} against the plain version", a, p_,
                                      dtype))
        log(f"  {tag}: two calls of each kernel give the same bits")
        del q, k, v, dout, out, lse, delta, got, keep, ref, qf, kf, vf, dof, plain
        torch.cuda.empty_cache()
    windows = dropout_bwd_mask_bits(seed)
    torch.cuda.empty_cache()
    clock = sm_clock_mhz()
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        b, d = B_DROP_BWD_TIMED, HEAD_DIM
        f32 = dtype == torch.float32
        q, k, v, dout = (torch.randn(b, HEADS, SEQ, d, device=DEV, generator=g).to(dtype)
                         for _ in range(4))
        args = (d ** -0.5, ATTN_DROP, seed, 0, 0, 1, HEADS, 0)
        out, lse = fa.launch_flash_forward_dropout(q, k, v, *args, 4)
        delta = fa.backward_delta(out, dout)
        q3, k3, v3, do3 = (t.view(b * HEADS, SEQ, d) for t in (q, k, v, dout))
        out0, lse0 = fa.flash_forward(q3, k3, v3, args[0])
        delta0 = fa.backward_delta(out0, do3)

        def dq_call():
            return fa.launch_flash_bwd_dq_dropout(q, k, v, dout, lse, delta, *args, 4)

        def dkv_call():
            return fa.launch_flash_bwd_dkv_dropout(q, k, v, dout, lse, delta, *args, 4)

        def p0_pair():
            return (fa.flash_bwd_dq(q3, k3, v3, do3, lse0.view(-1, SEQ), delta0, args[0]),
                    fa.flash_bwd_dkv(q3, k3, v3, do3, lse0.view(-1, SEQ), delta0, args[0]))

        t_dq = cuda_time(dq_call, reps=3, trials=3)
        t_dkv = cuda_time(dkv_call, reps=3, trials=3)
        t_pair, t_p0 = in_turns(lambda: (dq_call(), dkv_call()), p0_pair, reps=2, trials=3)
        lib_leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*lib_leaves, dropout_p=ATTN_DROP)

        def sdpa_bwd():
            return torch.autograd.grad(lib_out, lib_leaves, dout, retain_graph=True)

        t_l = cuda_time(sdpa_bwd, reps=2, trials=3)
        del lib_leaves, lib_out
        (b_dq, f_dq), (b_dkv, f_dkv) = bwd_bounds(b * HEADS, d, q.element_size())
        calls = sass.philox_calls(b * HEADS * SEQ * SEQ, 1, 0)
        floor = sass.issue_floor_ms(calls, clock)
        tag = f"{str(dtype)[6:]} ({b}, {HEADS}, {SEQ}, {d})"
        log(f"  3j {tag}: dQ dropout {t_dq:.4f} ms ({f_dq / t_dq / 1e9:.1f} TFLOP/s), dK/dV "
            f"dropout {t_dkv:.4f} ms ({f_dkv / t_dkv / 1e9:.1f} TFLOP/s) (median, pre-passes "
            f"included); in turns the pair {t_pair:.4f} ms against the p = 0 pair "
            f"{t_p0:.4f} ms (x{t_pair / t_p0:.3f}); SDPA backward with dropout_p={ATTN_DROP} "
            f"(dq, dk, dv in one call, " + ("fp32, TF32 off" if f32 else "bf16") +
            f") {t_l:.4f} ms; tensor bounds dQ {b_dq:.4f} / dK/dV {b_dkv:.4f} ms; integer "
            f"floor of each pre-pass {floor:.4f} ms ({calls / 1e6:.0f}M Philox calls x "
            f"{sass.PHILOX_CALL_INSTRUCTIONS} instructions at {clock:.0f} MHz)")
        entry = {}
        for name, fn, t_k, tensor, flop, names in (
                ("dq", dq_call, t_dq, b_dq, f_dq, DQ_DROP_KERNELS[dtype]),
                ("dkv", dkv_call, t_dkv, b_dkv, f_dkv, DKV_DROP_KERNELS[dtype])):
            bound = max(tensor, floor)
            dev, _ = device_rate(f"3j {tag} {name} dropout (pre-pass + kernel)", fn, names,
                                 bound, flop=flop)
            entry[name] = {"ms": t_k, "device_ms": dev, "bound_ms": bound,
                           "bound_by": "operations", "tensor_bound_ms": tensor,
                           "integer_bound_ms": floor, "library_ms": t_l,
                           "p0_pair_ms": t_p0, "pair_ms": t_pair}
        del q, k, v, dout, out, lse, delta, q3, k3, v3, do3, out0, lse0, delta0
        torch.cuda.empty_cache()
        # the plain version (fp32 formulas on the seed route's mask) at B_DROP_BWD
        b = B_DROP_BWD
        q, k, v, dout = (torch.randn(b, HEADS, SEQ, d, device=DEV, generator=g).to(dtype)
                         for _ in range(4))
        lse = fa.attention_lse(q, k, args[0])
        delta = torch.zeros_like(lse)
        entry["dq"]["plain_ms"] = cuda_time(lambda: fa.flash_bwd_dq_dropout_ref(
            q, k, v, dout, lse, delta, *args), reps=1, trials=3)
        entry["dkv"]["plain_ms"] = cuda_time(lambda: fa.flash_bwd_dkv_dropout_ref(
            q, k, v, dout, lse, delta, *args), reps=1, trials=3)
        for name in ("dq", "dkv"):
            entry[name]["plain_shape"] = [b, HEADS, SEQ, d]
        log(f"  3j {str(dtype)[6:]} plain version at ({b}, {HEADS}, {SEQ}, {d}): dQ "
            f"{entry['dq']['plain_ms']:.3f} ms, dK/dV {entry['dkv']['plain_ms']:.3f} ms")
        res[dtype] = entry
        del q, k, v, dout, lse, delta
        torch.cuda.empty_cache()
    # the entries: bf16 at the training shape; "fp32" the 3xTF32 kernels'
    return tuple(dict(res[torch.bfloat16][name], max_abs_err=max(errs),
                      mask_windows=windows, fp32=res[torch.float32][name])
                 for name in ("dq", "dkv"))


@contextlib.contextmanager
def weights_route():
    """The MC attention through the weights route (materialized weights, the
    keep-mask kernel, the value product) at every shape, for this script's
    comparisons only: ``models/transformer.py`` takes the fused route where
    the flash shape rule holds."""
    bound = transformer_mod.use_flash
    transformer_mod.use_flash = lambda *a: False
    try:
        yield
    finally:
        transformer_mod.use_flash = bound


@contextlib.contextmanager
def plain_route():
    """The transformer stage's attention through the plain route (weights
    materialized), for this script's own reference copies only: the port has
    no such switch."""
    bound = transformer_mod.scaled_dot_product_attention
    transformer_mod.scaled_dot_product_attention = (
        lambda q, k, v: attn.plain_attention(q, k, v, q.shape[-1] ** -0.5)[0])
    try:
        yield
    finally:
        transformer_mod.scaled_dot_product_attention = bound


def stage_grads(stage, x, cot):
    """``(out, {name: grad})`` of one forward and backward of ``stage`` on a
    fresh leaf ``x``; the input's gradient is under ``"x"``."""
    stage.zero_grad(set_to_none=True)
    x = x.detach().clone().requires_grad_()
    out = stage(x)
    out.backward(cot)
    return out.detach(), {"x": x.grad, **{n: p.grad for n, p in stage.named_parameters()}}


def rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def stage_backward_timed(stage, x, cot, expect, tag):
    """Three forward + backward runs of ``stage`` on ``x`` by CUDA events,
    each backward's launches checked, the peak memory from just before, and
    one backward under the profiler with the flash backward kernels' share.
    Returns the first run's launches and ``{"bwd_ms", "peak_gib"}``."""
    depth = expect["flash_attention_bwd_dq"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fwd_ms, bwd_ms = [], []
    for r in range(3):
        stage.zero_grad(set_to_none=True)
        leaf = x.detach().clone().requires_grad_()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        reset_counts()
        torch.cuda.synchronize()
        ev[0].record()
        out = stage(leaf)
        ev[1].record()
        before = counts()
        out.backward(cot)
        ev[2].record()
        torch.cuda.synchronize()
        got = counts()
        if r == 0:
            launched = got
        bwd = {k: got[k] - before[k] for k in ("flash_attention_bwd_dq",
                                               "flash_attention_bwd_dkv")}
        if got != expect or bwd != {"flash_attention_bwd_dq": depth,
                                    "flash_attention_bwd_dkv": depth}:
            raise AssertionError(f"{tag}: forward + backward launched {got} "
                                 f"(backward {bwd}), expected {expect}")
        if not (torch.isfinite(leaf.grad).all() and all(
                torch.isfinite(p.grad).all() for p in stage.parameters())):
            raise AssertionError(f"{tag}: stage gradients not finite")
        fwd_ms.append(ev[0].elapsed_time(ev[1]))
        bwd_ms.append(ev[1].elapsed_time(ev[2]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  {tag}: forward {statistics.median(fwd_ms):.3f} ms, backward "
        f"{statistics.median(bwd_ms):.3f} ms (median of 3 by CUDA events: "
        f"{', '.join(f'{t:.3f}' for t in bwd_ms)}); each backward launched dQ and dK/dV "
        f"{depth} times; peak memory {peak:.2f} GiB")
    from torch.profiler import ProfilerActivity, profile
    stage.zero_grad(set_to_none=True)
    leaf = x.detach().clone().requires_grad_()
    out = stage(leaf)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out.backward(cot)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total = sum(e.self_device_time_total for e in events) / 1e3
    if total > 0:
        # names of either tree's kernels: dQ, dK/dV and (3xTF32) their pre-pass
        mine = {k: sum(e.self_device_time_total for e in events if k in e.key) / 1e3
                for k in ("flash_bwd_dq", "flash_bwd_dkv", "flash_split")}
        log(f"  {tag}, one backward under the profiler: {total:.3f} ms of device time, "
            + ", ".join(f"{k}* {t:.3f} ms ({100 * t / total:.1f} %)" for k, t in mine.items()))
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x  {e.key[:90]}")
    else:
        log(f"  {tag}: backward device time not measured (the profiler recorded no kernel)")
    del leaf, out
    return launched, {"bwd_ms": statistics.median(bwd_ms), "peak_gib": peak}


def phase_stage_backward(hcfg, dtypes=(torch.bfloat16, torch.float32)):
    """Autograd through the full-width hybrid-nb transformer stage on the
    flash kernels (the backward kernels' path), in each of ``dtypes``: its
    gradients against an fp32 copy on the plain route at B_STAGE_PARITY, then
    the backward timed at B_SERVE.  Returns the launches of the first timed
    run of each dtype, summed, and ``{dtype: times}``."""
    mc = hcfg.dwi_model
    depth, heads = mc.transformer_depth, mc.transformer_heads
    log(f"== phase 3h: autograd through the hybrid-nb transformer stage at full width "
        f"({depth} blocks, {heads} heads, {SEQ} tokens x {mc.transformer_embed_dim}), eval "
        f"mode, {' and '.join(str(d)[6:] for d in dtypes)} (flash forward, dQ, dK/dV "
        f"kernels) vs an fp32 copy on the plain route at B={B_STAGE_PARITY}; the backward "
        f"timed at B={B_SERVE}")
    enc = build_fusion_models(hcfg, DEV, torch.float32, gen(SEED))[0]
    stages = {torch.bfloat16: enc.transformer.to(torch.bfloat16)}
    side = enc.feature_size * mc.transformer_patch_size
    cin, embed = stages[torch.bfloat16].patch_embed.proj.in_channels, mc.transformer_embed_dim
    del enc
    # the same (bf16-rounded) weights in fp32: the reference's and the fp32 stage's
    ref32 = stages[torch.float32] = copy.deepcopy(stages[torch.bfloat16]).float()
    g = gen(41)

    def inputs(b):
        x = cl(torch.randn(b, cin, side, side, device=DEV, generator=g).to(torch.bfloat16))
        cot = torch.randn(b, embed, side // mc.transformer_patch_size,
                          side // mc.transformer_patch_size, device=DEV, generator=g)
        return x, cot.to(torch.bfloat16)

    expect = dict.fromkeys(COUNTERS, 0) | {"flash_attention_fwd": depth,
                                           "flash_attention_bwd_dq": depth,
                                           "flash_attention_bwd_dkv": depth}
    x, cot = inputs(B_STAGE_PARITY)
    reset_counts()
    with plain_route():
        out_r, grads_r = stage_grads(ref32, x.float(), cot.float())  # the reference
    if counts() != dict.fromkeys(COUNTERS, 0):
        raise AssertionError("the plain-route reference launched a kernel")
    for dtype in dtypes:
        stage = stages[dtype]
        reset_counts()
        out, grads = stage_grads(stage, x.to(dtype), cot.to(dtype))
        launched = counts()
        if launched != expect:
            raise AssertionError(f"{dtype} stage forward + backward launched {launched}, "
                                 f"expected {expect}")
        errs = {"out": rel_l2(out, out_r)} | {n: rel_l2(grads[n], grads_r[n]) for n in grads}
        beside = {}
        if dtype == torch.bfloat16:  # the bf16 plain route's own error, for context
            with plain_route():
                out_p, grads_p = stage_grads(stage, x, cot)
            if counts() != launched:
                raise AssertionError("the plain-route copy launched a kernel")
            beside = {"out": rel_l2(out_p, out_r)} | {n: rel_l2(grads_p[n], grads_r[n])
                                                       for n in grads_p}
            del out_p, grads_p
        tol = STAGE_TOL[dtype]
        worst = sorted(errs.items(), key=lambda kv: -kv[1])
        log(f"  {str(dtype)[6:]}, B={B_STAGE_PARITY}: launches {launched}; relative L2 error "
            f"against the fp32 plain-route copy"
            + (", kernels (bf16 plain route beside)" if beside else "")
            + f", tolerance {tol:.4g}, over the output, the input gradient and "
            f"{len(grads) - 1} parameter gradients:")
        for n in ["out", "x"] + [n for n, _ in worst if n not in ("out", "x")][:6]:
            log(f"    {n}: {errs[n]:.3e}" + (f" ({beside[n]:.3e})" if beside else ""))
        if not all(e <= tol for e in errs.values()):
            raise AssertionError(f"{dtype} stage gradients: {worst[0][0]} off by "
                                 f"{worst[0][1]:.3e}, above {tol}")
        qkv = [n for n in grads if n.endswith("attn.qkv.weight")]
        log(f"  qkv weight gradients (their q, k, v slices come from dQ, dK, dV): kernels at "
            f"most {max(errs[n] for n in qkv):.3e}"
            + (f", bf16 plain route at most {max(beside[n] for n in qkv):.3e}"
               if beside else ""))
        del out, grads
    del out_r, grads_r, x, cot
    torch.cuda.empty_cache()

    x, cot = inputs(B_SERVE)
    total = dict.fromkeys(COUNTERS, 0)
    times = {}
    for dtype in dtypes:
        launched, times[dtype] = stage_backward_timed(
            stages[dtype], x.to(dtype), cot.to(dtype), expect,
            f"{str(dtype)[6:]} B={B_SERVE}")
        total = {k: total[k] + launched[k] for k in COUNTERS}
    del stages, ref32, x, cot
    torch.cuda.empty_cache()
    return total, times


# 3h in train mode: B_STAGE_TRAIN volumes through the full-width stage with its
# attention dropout on, card against the CPU, the training route's seeds fixed
# (STAGE_TRAIN_SEED, + 1, ... a site) on both devices
B_STAGE_TRAIN = 1
STAGE_TRAIN_SEED = (0x5EED << 32) | 51


@contextlib.contextmanager
def fixed_seeds(first):
    """The training route's seed draws (``models/transformer.py::draw_seed``,
    one a fused attention site) as ``first``, ``first + 1``, ... on the
    caller's device: the same seeds on the card and on the CPU, whose
    generators draw different numbers."""
    bound = transformer_mod.draw_seed
    seeds = itertools.count(first)
    transformer_mod.draw_seed = lambda generator, device: torch.tensor(
        [next(seeds)], device=device, dtype=torch.int64)
    try:
        yield
    finally:
        transformer_mod.draw_seed = bound


@contextlib.contextmanager
def card_masks():
    """The CPU plain versions' keep masks (``ops/dropout.py::keep_mask_plain``,
    which the plain forward and both plain backward kernels call for each
    site) taken from the keep-mask kernel on the card, once a site: phases
    3a and 16a hold that kernel bit-equal to ``keep_mask_plain``, whose
    integer Philox takes ~15 s a full-width site on the host."""
    bound = seed_route.keep_mask_plain
    cache = {}

    def keep_mask_plain(shape, drop_rate, seed, base=0, first_pass=0, passes=1):
        key = (tuple(shape), drop_rate, int(seed), base, first_pass, passes)
        if key not in cache:
            whole = torch.empty((), device=DEV).expand(*shape)
            cache[key] = epilogue_cuda.keep_mask(whole, drop_rate, seed.to(DEV), base,
                                                 first_pass, passes).cpu()
        return cache[key]

    seed_route.keep_mask_plain = keep_mask_plain
    try:
        yield cache
    finally:
        seed_route.keep_mask_plain = bound


def phase_stage_train(hcfg):
    """Phase 3h in train mode: the full-width hybrid-nb stage with its
    attention dropout on (``mc=True`` with a generator: the training route,
    one seed a site), forward and backward on the card in bf16 and in fp32
    (the dropout forward, dQ and dK/dV kernels, 6 launches each) against the
    CPU's plain versions on the same seeds, at phase 3h's tolerances; the
    projection and MLP dropouts off in every copy (their ``uniform_`` masks
    differ between the devices).  Returns the card runs' launches, summed."""
    mc = hcfg.dwi_model
    depth = mc.transformer_depth
    log(f"== phase 3h (train mode): autograd through the hybrid-nb transformer stage at full "
        f"width ({depth} blocks, {HEADS} heads, {SEQ} tokens), attention dropout "
        f"{ATTN_DROP} on (the training route's fused sites, one fixed seed a site), "
        f"B={B_STAGE_TRAIN}, bf16 and fp32 on the card against fp32 on the CPU")
    enc = build_fusion_models(hcfg, DEV, torch.float32, gen(SEED))[0]
    stage = enc.transformer
    for block in stage.transformer.layers:
        block.attn.proj_drop, block.mlp.drop = 0.0, 0.0
    side = enc.feature_size * mc.transformer_patch_size
    cin, embed = stage.patch_embed.proj.in_channels, mc.transformer_embed_dim
    del enc
    g = gen(47)
    x = cl(torch.randn(B_STAGE_TRAIN, cin, side, side, device=DEV, generator=g))
    cot = torch.randn(B_STAGE_TRAIN, embed, side // mc.transformer_patch_size,
                      side // mc.transformer_patch_size, device=DEV, generator=g)

    def train_grads(st, x_, cot_):
        st.zero_grad(set_to_none=True)
        leaf = x_.detach().clone().requires_grad_()
        with fixed_seeds(STAGE_TRAIN_SEED):
            out = st(leaf, mc=True, generator=torch.Generator(x_.device))
        out.backward(cot_)
        return out.detach(), {"x": leaf.grad, **{n: p.grad for n, p in st.named_parameters()}}

    t0 = time.perf_counter()
    with card_masks() as sites:
        out_r, grads_r = train_grads(copy.deepcopy(stage).cpu(), x.cpu(), cot.cpu())
    log(f"  CPU fp32 forward + backward: {time.perf_counter() - t0:.1f} s, {len(sites)} "
        f"dropout sites")
    if len(sites) != depth:
        raise AssertionError(f"the CPU stage drew {len(sites)} masks, expected {depth}")
    expect = dict.fromkeys(COUNTERS, 0) | {
        "flash_attention_fwd_dropout": depth, DROP_INSTANCES["head_shared"]: depth,
        "flash_attention_bwd_dq_dropout": depth, "flash_attention_bwd_dkv_dropout": depth}
    total = dict.fromkeys(COUNTERS, 0)
    for dtype in (torch.bfloat16, torch.float32):
        st = copy.deepcopy(stage).to(dtype)
        reset_counts()
        out, grads = train_grads(st, x.to(dtype), cot.to(dtype))
        torch.cuda.synchronize()
        launched = counts()
        if launched != expect:
            raise AssertionError(f"3h train {dtype}: launched {launched}, expected {expect}")
        errs = {"out": rel_l2(out.cpu(), out_r)} | {n: rel_l2(grads[n].cpu(), grads_r[n])
                                                     for n in grads}
        tol = STAGE_TOL[dtype]
        worst = sorted(errs.items(), key=lambda kv: -kv[1])
        qkv = max(errs[n] for n in errs if n.endswith("attn.qkv.weight"))
        log(f"  {str(dtype)[6:]} card vs CPU: launches "
            f"{', '.join(f'{k} {v}' for k, v in launched.items() if v)}; relative L2 error, "
            f"tolerance {tol:.4g}: out {errs['out']:.3e}, x {errs['x']:.3e}, "
            f"qkv weights at most {qkv:.3e}, worst {worst[0][0]} {worst[0][1]:.3e}")
        if not all(e <= tol for e in errs.values()):
            raise AssertionError(f"3h train {dtype}: {worst[0][0]} off by {worst[0][1]:.3e}, "
                                 f"above {tol}")
        total = {k: total[k] + launched[k] for k in COUNTERS}
        del st, out, grads
    del stage, x, cot, out_r, grads_r
    torch.cuda.empty_cache()
    return total


def phase_dwi_norm():
    log(f"== phase 3e: dwi_normalize (CUDA) vs plain, (8 served | 256 prepared, "
        f"{IMAGE}, {IMAGE}, 13), raw intensities 10-2010")
    g = gen(8)
    errs, res = [], {}
    for n in (8, 256):
        base = torch.rand(n, IMAGE, IMAGE, 13, device=DEV, generator=g) * 2000.0 + 10.0
        for dtype in (torch.float32, torch.bfloat16):
            img = base.to(dtype)
            # outputs in [0, 1]: fp32 sum order, 1e-6 (a ddof=0 std would be
            # off by ~3.8e-6 at 256^2); bf16 one ulp, 2^-7
            tol = 1e-6 if dtype == torch.float32 else 2.0 ** -7
            tag = f"{str(dtype)[6:]} N={n}"
            for flags in ((True, True), (True, False), (False, False)):
                out = dwi_norm.dwi_normalize(img, (-3.0, 3.0), *flags)
                ref = dwi_norm.dwi_normalize_ref(img, (-3.0, 3.0), *flags)
                err = (out.float() - ref.float()).abs().max().item()
                log(f"  {tag} skip_last={flags[0]} zero_last={flags[1]}: max_abs_err "
                    f"{err:.3e} (tolerance {tol:.3e})")
                if not err <= tol:
                    raise AssertionError(f"dwi_normalize {tag} {flags}: error {err} above {tol}")
                if dtype == torch.float32:
                    errs.append(err)
                del out, ref
            t_k = cuda_time(lambda: dwi_norm.dwi_normalize(img, (-3.0, 3.0), True, True))
            t_p = cuda_time(lambda: dwi_norm.dwi_normalize_ref(img, (-3.0, 3.0), True, True),
                            reps=3)
            # least traffic: read the images, write the output, once each
            bound = 2 * img.numel() * img.element_size() / HBM_BYTES_PER_S * 1e3
            log(f"  {tag}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms (median), bound "
                f"{bound:.4f} ms (bytes, {2 * img.numel() * img.element_size() / 1e6:.1f} MB)")
            device_rate(f"{tag} (its {len(DWI_KERNELS)} kernels)",
                        lambda: dwi_norm.dwi_normalize(img, (-3.0, 3.0), True, True),
                        DWI_KERNELS, bound, nbytes=2 * img.numel() * img.element_size())
            res[(n, dtype)] = (t_k, t_p, bound)
            del img
        del base
        torch.cuda.empty_cache()
    t_k, t_p, bound = res[(8, torch.float32)]  # the served call
    return {"max_abs_err": max(errs), "ms": t_k, "plain_ms": t_p, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": None}


def fullest_bin_share(flat):
    """The largest share of a row that one of its 4096 bins holds."""
    mn = flat.min(1, keepdim=True).values
    span = (flat.max(1, keepdim=True).values - mn).clamp(min=1e-12)
    idx = ((flat - mn) / span * hist.NBINS).clamp(0, hist.NBINS - 1).floor().long()
    counts = torch.zeros(flat.shape[0], hist.NBINS, dtype=torch.int64, device=flat.device)
    counts.scatter_add_(1, idx, torch.ones_like(idx))
    return (counts.max(1).values.float() / flat.shape[1]).max().item()


def phase_histogram(dce_norm):
    """``dce_norm``: the max-normalised synthetic DCE volumes on the card."""
    rows = dce_norm.permute(0, 3, 1, 2).reshape(-1, IMAGE * IMAGE).contiguous()
    flat_all = rows.view(-1)
    crowded = rows[:48].clone()
    crowded[torch.rand(crowded.shape, device=DEV, generator=gen(10)) < 0.6] = 0.0
    crowded_all = rows.clone()
    crowded_all[torch.rand(crowded_all.shape, device=DEV, generator=gen(11)) < 0.6] = 0.0
    # (tag, rows): the served B=8 batch's 48 rows, the prepared store's rows,
    # both with 60 % of each row at the background value 0 (a breast slice's
    # background), ragged and 16-byte-unaligned rows cut from the same values,
    # and rows whose slices exceed the kernel's shared-memory budget
    cases = [("synthetic", rows[:48]), ("synthetic", rows), ("crowded", crowded),
             ("crowded", crowded_all), ("ragged", flat_all[: 48 * 65539].view(48, 65539)),
             ("ragged", flat_all[: 7 * 10007].view(7, 10007)),
             ("large", flat_all[: 4 * 2 ** 20].view(4, 2 ** 20))]
    log(f"== phase 3f: histogram_percentiles (CUDA, one cluster of 8 blocks a row) vs plain "
        f"on max-normalised synthetic DCE rows, fp32: "
        + ", ".join(f"{tag} {tuple(f.shape)}" for tag, f in cases))
    resident = hist._library().histogram_percentiles_resident_clusters
    log("  clusters of 8 blocks resident at once: " + ", ".join(
        f"P={p} {resident(p)}" for p in sorted({f.shape[1] for _, f in cases})))
    errs, res = [], {}
    for tag, flat in cases:
        name = f"{tag} {tuple(flat.shape)}"
        out = hist.histogram_percentiles(flat, LANDMARKS)
        ref = hist.histogram_percentiles_ref(flat, LANDMARKS)
        span = (flat.max(1).values - flat.min(1).values).clamp(min=1e-12)[:, None]
        err = (out - ref).abs().max().item()
        err_bins = ((out - ref).abs() / (span / hist.NBINS)).max().item()
        # the same bins and the same in-bin interpolation: within 1e-6 * span
        # (0.004 bins), as the plain version is held to the Pallas kernel;
        # a kernel without the interpolation or a bin off would be ~1 bin out
        tol_bins = 1e-6 * hist.NBINS
        same = torch.equal(out, hist.histogram_percentiles(flat, LANDMARKS))
        log(f"  {name}: max_abs_err {err:.3e}, {err_bins:.3e} bins of span/4096 "
            f"(tolerance {tol_bins:.3e} bins = 1e-6 x span); two calls bit-equal {same}; "
            f"fullest bin {100 * fullest_bin_share(flat):.2f} % of its row")
        if not err_bins <= tol_bins:
            raise AssertionError(f"histogram_percentiles {name}: {err_bins} bins apart")
        if not same:
            raise AssertionError(f"histogram_percentiles {name}: two calls differ")
        errs.append(err)
        t_k = cuda_time(lambda: hist.histogram_percentiles(flat, LANDMARKS))
        t_p = cuda_time(lambda: hist.histogram_percentiles_ref(flat, LANDMARKS), reps=3)
        bound = flat.numel() * 4 / HBM_BYTES_PER_S * 1e3  # one read of the rows
        log(f"  {name}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms (median), bound "
            f"{bound:.4f} ms (bytes, {flat.numel() * 4 / 1e6:.1f} MB)")
        device_rate(name, lambda: hist.histogram_percentiles(flat, LANDMARKS),
                    ("histogram_percentiles",), bound, nbytes=flat.numel() * 4)
        res[name] = (t_k, t_p, bound)
        del out, ref
    del crowded, crowded_all
    # the path that carries the kernel: nyul_transform_hist on one B=8 batch,
    # counts set to 0 just before and read just after
    batch = dce_norm[:B_SERVE].contiguous()
    lm = torch.tensor(LANDMARKS, device=DEV)
    scale = torch.linspace(0.0, 1.0, len(LANDMARKS), device=DEV)
    reset_counts()
    via_hist = hist.nyul_transform_hist(batch, LANDMARKS, scale)
    torch.cuda.synchronize()
    launches = counts()["histogram_percentiles"]
    via_fast = nyul_transform_fast(batch, lm, scale)
    diff = (via_hist - via_fast).abs().max().item()
    log(f"  nyul_transform_hist vs nyul_transform_fast (B={B_SERVE}, information only: "
        f"two estimators): max |diff| {diff:.3e}; histogram launches {launches}")
    if launches != 1 or not torch.isfinite(via_hist).all():
        raise AssertionError("nyul_transform_hist did not run through the kernel once")
    t_k, t_p, bound = res[f"synthetic (48, {IMAGE * IMAGE})"]
    return {"max_abs_err": max(errs), "ms": t_k, "plain_ms": t_p, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": None, "served": False}, launches


def se_weights(c, g):
    """(w1, b1, w2, b2) of an SE MLP over ``c`` channels, hidden c // 2."""
    mid = max(c // 2, 1)
    w1 = torch.randn(mid, c, 1, 1, device=DEV, generator=g) * c ** -0.5
    w2 = torch.randn(c, mid, 1, 1, device=DEV, generator=g) * mid ** -0.5
    b1 = torch.randn(mid, device=DEV, generator=g) * 0.1
    b2 = torch.randn(c, device=DEV, generator=g) * 0.1
    return w1, b1, w2, b2


def phase_se_scale():
    log("== phase 3g: se_scale (CUDA) vs plain SEBlock, (N, side^2, C) = "
        + ", ".join(f"({n}, {s}^2, {c})" for n, s, c in SE_MAPS))
    g = gen(9)
    errs, ms, plain_ms, nbytes, devs, hosts = [], 0.0, 0.0, 0, [], []
    f32_ms, f32_plain, f32_bytes, f32_devs = 0.0, 0.0, 0, []
    for n, side, c in SE_MAPS:
        w1, b1, w2, b2 = se_weights(c, g)
        base = torch.randn(n, c, side, side, device=DEV, generator=g)
        for dtype in (torch.float32, torch.bfloat16):
            x = cl(base.to(dtype))
            args = (x, w1, b1, w2, b2)
            tag = f"{str(dtype)[6:]} ({n}, {side}^2, {c})"
            out, s = sek.se_scale(*args)
            ref_out, ref_s = sek.se_scale_ref(*args)
            errs.append(check(f"{tag} out", out, ref_out, dtype))
            errs.append(check(f"{tag} s", s, ref_s, dtype))
            del out, s, ref_out, ref_s
            if dtype == torch.bfloat16 or n == B_VAL:
                t_k = cuda_time(lambda: sek.se_scale(*args))
                t_p = cuda_time(lambda: sek.se_scale_ref(*args))
                b = 2 * x.numel() * x.element_size()
                log(f"  {tag}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms (median), bound "
                    f"{b / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes, {b / 1e6:.1f} MB)")
                dev, host = device_rate(f"{tag} (its 3 kernels)", lambda: sek.se_scale(*args),
                                        SE_KERNELS, b / HBM_BYTES_PER_S * 1e3, nbytes=b)
                if dtype == torch.bfloat16:
                    devs.append(dev)
                    hosts.append(host)
                    ms += t_k
                    plain_ms += t_p
                    nbytes += b
                else:  # fp32 at a validation batch's maps
                    f32_devs.append(dev)
                    f32_ms, f32_plain, f32_bytes = f32_ms + t_k, f32_plain + t_p, f32_bytes + b
            del x, args
        del base
        torch.cuda.empty_cache()
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    device = ("device not measured" if None in devs else
              f"device {sum(devs):.4f} ms ({100 * bound / sum(devs):.1f} % of the bound)")
    log(f"  bf16 sum over the four calls of a tta_mc request: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms (bytes); {device}; host {sum(hosts):.4f} ms "
        f"to enqueue")
    b32 = f32_bytes / HBM_BYTES_PER_S * 1e3
    device = ("device not measured" if None in f32_devs else
              f"device {sum(f32_devs):.4f} ms ({100 * b32 / sum(f32_devs):.1f} % of the bound)")
    log(f"  fp32 sum over a validation batch's three calls (modality attention x 2, "
        f"fusion_se): kernel {f32_ms:.4f} ms, plain {f32_plain:.4f} ms, bound {b32:.4f} ms "
        f"(bytes); {device}")
    for n, side, c in SE_TEST_MAPS:  # fp32 at the four maps of a tta_mc test batch
        x = cl(torch.randn(n, c, side, side, device=DEV, generator=g))
        args = (x, *se_weights(c, g))
        tag = f"float32 ({n}, {side}^2, {c}) of a tta_mc test batch"
        out, s = sek.se_scale(*args)
        ref_out, ref_s = sek.se_scale_ref(*args)
        errs.append(check(f"{tag} out", out, ref_out, torch.float32))
        errs.append(check(f"{tag} s", s, ref_s, torch.float32))
        del x, args, out, s, ref_out, ref_s
        torch.cuda.empty_cache()
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": None}


# ------------------------------------------------------------------ phase 4
def card_and_cpu_models(cfg):
    cpu_models = build_fusion_models(cfg, "cpu", torch.float32,
                                     torch.Generator().manual_seed(SEED))
    dev_models = [copy.deepcopy(m).to(DEV).to(memory_format=torch.channels_last)
                  for m in cpu_models]
    return cpu_models, dev_models


def compare_card_cpu(pairs):
    for name, a, b, tol in pairs:
        err = (a.cpu() - b).abs().max().item()
        log(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:.0e})")
        if not err <= tol:
            raise AssertionError(f"card-vs-CPU {name} error {err} above {tol}")


def phase_parity(cfg, title="4: end-to-end parity"):
    log(f"== phase {title}, tta, B=2, fp32: card (kernels) vs CPU (plain)")
    cpu_models, dev_models = card_and_cpu_models(cfg)
    g = torch.Generator().manual_seed(11)
    S = cfg.dwi_model.input_size
    dwi = torch.rand(2, S, S, cfg.dwi_channel_num, generator=g)
    dce = torch.rand(2, S, S, cfg.dce_channel_num, generator=g)
    reset_counts()
    t0 = time.perf_counter()
    mean_d, std_d, aux_d = make_fusion_predictor(cfg, *dev_models, mode="tta")(
        dwi.to(DEV), dce.to(DEV))
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    launched = counts()
    t0 = time.perf_counter()
    mean_c, std_c, aux_c = make_fusion_predictor(cfg, *cpu_models, mode="tta")(dwi, dce)
    t_cpu = time.perf_counter() - t0
    log(f"  card {t_dev:.2f} s (launches {launched}), CPU {t_cpu:.2f} s")
    # 3 ResLite SE epilogues x 2 encoders, 6 necks x 2; modality attention x 2
    # and fusion_se: standalone SE
    expect = dict.fromkeys(COUNTERS, 0) | {"se_epilogue": 6, "conv3x3_bn_gelu": 12,
                                           "se_scale": 3}
    if launched != expect:
        raise AssertionError(f"tta forward launched {launched}, expected {expect}")
    # ResNet-50 or ViT-B/16 depth in fp32 on two devices: sums in other orders; hold
    # probabilities to 1e-4 absolute and the gate to 1e-4 relative
    compare_card_cpu((("mean", mean_d, mean_c, 1e-4), ("std", std_d, std_c, 1e-4),
                      ("gating_weights", aux_d["gating_weights"],
                       aux_c["gating_weights"], 1e-4)))
    log(f"  mean probs (card) {mean_d.cpu().numpy().round(5).tolist()}")
    del dev_models, cpu_models
    torch.cuda.empty_cache()


# per forward of the hybrid-nb models: 6 transformer blocks x 2 encoders of
# flash attention, 2 SE epilogues (block1, block2) x 2 encoders, no neck
# convs, modality attention x 2 and fusion_se; a served request adds the
# DWI z-score of its preprocessing
HYBRID_EXPECT = dict.fromkeys(COUNTERS, 0) | {"flash_attention_fwd": 12, "se_epilogue": 4,
                                              "se_scale": 3}


def phase_parity_hybrid(hcfg):
    log("== phase 4b: hybrid-nb end-to-end parity, normal, B=1, fp32: card (kernels) "
        "vs CPU (plain)")
    cpu_models, dev_models = card_and_cpu_models(hcfg)
    g = torch.Generator().manual_seed(12)
    S = hcfg.dwi_model.input_size
    dwi = torch.rand(1, S, S, hcfg.dwi_channel_num, generator=g)
    dce = torch.rand(1, S, S, hcfg.dce_channel_num, generator=g)
    reset_counts()
    t0 = time.perf_counter()
    mean_d, _, aux_d = make_fusion_predictor(hcfg, *dev_models, mode="normal")(
        dwi.to(DEV), dce.to(DEV))
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    launched = counts()
    t0 = time.perf_counter()
    mean_c, _, aux_c = make_fusion_predictor(hcfg, *cpu_models, mode="normal")(dwi, dce)
    t_cpu = time.perf_counter() - t0
    log(f"  card {t_dev:.2f} s (launches {launched}), CPU {t_cpu:.2f} s")
    if launched != HYBRID_EXPECT:
        raise AssertionError(f"hybrid-nb forward launched {launched}, "
                             f"expected {HYBRID_EXPECT}")
    # 6 transformer blocks in fp32 on two devices, flash (online softmax) on
    # the card vs the materialized softmax on the CPU: 1e-4 absolute
    compare_card_cpu((("mean", mean_d, mean_c, 1e-4),
                      ("gating_weights", aux_d["gating_weights"],
                       aux_c["gating_weights"], 1e-4)))
    log(f"  mean probs (card) {mean_d.cpu().numpy().round(5).tolist()}")
    del dev_models, cpu_models
    torch.cuda.empty_cache()


def synced(fn):
    """``fn()`` and its host seconds, ending in a device synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_prepare(cfg, raw):
    log(f"== phase 4c: data preparation, card vs CPU: prepare_single_data + "
        f"export_processed_splits, fold 0, {N_TRAIN} + {N_TEST} synthetic volumes of "
        f"{IMAGE}^2, reference_compat={cfg.reference_compat}")
    launches = dict.fromkeys(COUNTERS, 0)
    for method in ("dwi", "dce"):
        store = {"imgs": raw[method], "test_imgs": raw[f"{method}_test"],
                 "labels": raw["labels"], "test_labels": raw["labels_test"],
                 "masks": raw["masks"]}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)  # scratch stores inside the checkout
        with (tempfile.TemporaryDirectory(dir=BUILD_DIR) as d_card,
              tempfile.TemporaryDirectory(dir=BUILD_DIR) as d_cpu):
            c_card, c_cpu = cfg.replace(base_path=d_card), cfg.replace(base_path=d_cpu)
            reset_counts()
            data, t_prep = synced(lambda: prepare_single_data(c_card, method, 0, raw=store,
                                                              device=DEV))
            paths, t_export = synced(lambda: export_processed_splits(c_card, data, gen(31)))
            got = counts()
            log(f"  {method} card: prepare {t_prep:.3f} s, export {t_export:.3f} s, launches "
                + ", ".join(f"{k} {v}" for k, v in got.items() if v))
            expect = dict.fromkeys(COUNTERS, 0) | ({"dwi_normalize": 3} if method == "dwi"
                                                   else {})
            if got != expect:
                raise AssertionError(f"{method} preparation launched {got}, expected {expect}")
            launches = {k: launches[k] + got[k] for k in COUNTERS}
            t0 = time.perf_counter()
            data_c = prepare_single_data(c_cpu, method, 0, raw=store, device="cpu")
            if data_c.nyul is not None:  # the card's estimator: fast, not the CPU's exact one
                data_c.nyul.transform = functools.partial(data_c.nyul.transform, fast=True)
            paths_c = export_processed_splits(c_cpu, data_c, torch.Generator().manual_seed(31))
            log(f"  {method} CPU: prepare + export {time.perf_counter() - t0:.3f} s")
            for split in ("train", "val", "test"):
                a, b = load_processed_split(paths[split]), load_processed_split(paths_c[split])
                if a.keys() != b.keys() or a["imgs"].shape != b["imgs"].shape:
                    raise AssertionError(f"{method} {split}: card and CPU splits differ in form")
                for k in set(a) - {"imgs"}:
                    if not np.array_equal(a[k], b[k]):
                        raise AssertionError(f"{method} {split}: {k} differ")
                imgs = a["imgs"]
                if not np.isfinite(imgs).all() or imgs.min() < 0.0 or imgs.max() > 1.0:
                    raise AssertionError(f"{method} {split}: not finite or outside [0, 1]")
                if split == "train":  # one frozen augmentation: other generators
                    log(f"  {method} train {imgs.shape}: finite, in [0, 1] (card and CPU "
                        f"draw other augmentation streams)")
                    continue
                diff = np.abs(imgs - b["imgs"])
                err = float(diff.max())
                log(f"  {method} {split} {imgs.shape}: card vs CPU max_abs_err {err:.3e} "
                    f"(tolerance 1e-05); by channel {diff.max(axis=(0, 1, 2)).tolist()}")
                if not err <= 1e-5:
                    raise AssertionError(f"{method} {split}: card vs CPU error {err}")
            del data_c
        # stage times on the card, each stage as prepare_single_data and
        # export_processed_splits run it
        splits = data.splits
        if method == "dwi":
            _, t = synced(lambda: prep_dwi_adc_maps(store["imgs"], store["test_imgs"],
                                                    cfg.dwi_bvals_to_use,
                                                    cfg.reference_compat, DEV))
            log(f"  dwi stage ADC maps: {t * 1e3:.2f} ms")
        else:
            _, t = synced(lambda: [dce_global_max_normalize(
                torch.as_tensor(a, device=DEV)).cpu().numpy()
                for a in (store["imgs"], store["test_imgs"])])
            log(f"  dce stage max-normalise (with host-device copies): {t * 1e3:.2f} ms")
            train_imgs = splits["train"]["imgs"]
            ny, t = synced(lambda: fitted(train_imgs))
            lm_plain, t_plain = synced(lambda: nyul_fit_plain(train_imgs, ny.landmarks))
            diff = float(np.abs(ny.channel_landmarks - lm_plain).max())
            log(f"  dce stage Nyul fit on {len(train_imgs)} volumes (host): native threaded "
                f"C++ {t * 1e3:.2f} ms ({os.cpu_count()} host cores), plain numpy "
                f"{t_plain * 1e3:.2f} ms; landmarks' largest difference {diff:.3e} "
                f"(tolerance 1e-05)")
            if not diff <= 1e-5:
                raise AssertionError(f"native Nyul fit {diff} off the numpy fit")
        procs = data.processors_by_split
        _, t = synced(lambda: procs["train"].train_batch(
            gen(32), splits["train"]["imgs"]).cpu().numpy())
        log(f"  {method} stage train split ({len(splits['train']['imgs'])} volumes, augment + "
            f"normalise): {t * 1e3:.2f} ms")
        n_eval, t_eval = 0, 0.0
        for split in ("val", "test"):
            _, t = synced(lambda: procs[split].eval_split(splits[split]["imgs"]))
            n = len(splits[split]["imgs"])
            log(f"  {method} stage {split} split ({n} volumes, eval_split): {t * 1e3:.2f} ms")
            n_eval, t_eval = n_eval + n, t_eval + t
        log(f"  {method} eval_split: {n_eval / t_eval:.1f} volumes/s (host arrays in and out)")
        del data
    log(f"  launches of the preparation runs: {launches}")
    return launches


def fitted(imgs):
    ny = NyulStandardizer()
    ny.fit(imgs)
    return ny


# ------------------------------------------------------------------ phase 5
def raw_request(cfg, predict, g_data, g_mc=None, b=B_SERVE):
    """One request: ``b`` raw NHWC volumes -> preprocessing -> predictor."""
    S = cfg.dwi_model.input_size
    adc_map = torch.full((S, S, 1), 0.5, device=DEV)

    def request():
        """Host seconds of the request; the preprocessing's and the
        predictor's device-stream ms (CUDA events) go to ``split``."""
        dwi_raw = torch.rand(b, S, S, cfg.dwi_base_channel_num, device=DEV,
                             generator=g_data) * 1000.0
        dce_raw = torch.rand(b, S, S, cfg.dce_channel_num, device=DEV, generator=g_data)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        dx, cx = preprocess_fusion_inputs(dwi_raw, dce_raw, adc_map)
        ev[1].record()
        mean, std, _ = predict(dx, cx, g_mc)
        ev[2].record()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        request.split = (ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]))
        return dt, mean, std

    return request


def gate(name, cfg, launched, expect, mean, std, stochastic, b):
    """The correctness gates of one request: launch counts, probabilities
    finite, of shape (b, classes) and summing to 1, std finite (and > 0 for
    MC)."""
    if launched != expect:
        raise AssertionError(f"{name} request launched {launched}, expected {expect}")
    if mean.shape != (b, cfg.class_num) or not torch.isfinite(mean).all():
        raise AssertionError("probabilities not finite or misshapen")
    if not torch.isfinite(std).all():
        raise AssertionError("std not finite")
    if stochastic and not (std > 0).all():
        raise AssertionError("MC std not strictly positive")
    if (mean.sum(-1) - 1).abs().max().item() > 1e-3:
        raise AssertionError("probabilities do not sum to 1")


def serve(name, cfg, request, expect, stochastic):
    """Warm-up, then REQUESTS requests with per-request launch counts and the
    correctness gates; the counts are reset just before and read just after."""
    t_warm, _, _ = request()
    log(f"  {name} warm-up request: {t_warm:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    lat, pre, pred = [], [], []
    for r in range(REQUESTS):
        before = counts()
        dt, mean, std = request()
        rose = {k: v - before[k] for k, v in counts().items()}
        lat.append(dt)
        pre.append(request.split[0])
        pred.append(request.split[1])
        log(f"  {name} request {r}: {dt * 1e3:.2f} ms, {B_SERVE / dt:.2f} volumes/s "
            f"(preprocessing {request.split[0]:.3f} ms, predictor {request.split[1]:.3f} ms "
            f"by CUDA events), launches " + ", ".join(f"{k} +{v}" for k, v in rose.items() if v))
        gate(name, cfg, rose, expect, mean, std, stochastic, B_SERVE)
    launched = counts()
    med = statistics.median(lat)
    log(f"  {name}: median latency {med * 1e3:.2f} ms, {B_SERVE / med:.2f} volumes/s; "
        f"median preprocessing {statistics.median(pre):.3f} ms, predictor "
        f"{statistics.median(pred):.3f} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    log(f"  {name} last request mean probs {mean[0].float().cpu().numpy().round(4).tolist()}, "
        f"std {std[0].float().cpu().numpy().round(4).tolist()}")
    return launched


def phase_serve(cfg):
    log(f"== phase 5: serve tta_mc in bf16, {REQUESTS} requests of B={B_SERVE} raw volumes")
    models = build_fusion_models(cfg, DEV, torch.bfloat16, gen(SEED))
    predict = make_fusion_predictor(cfg, *models, mode="tta_mc")
    request = raw_request(cfg, predict, gen(21), gen(22))
    n_suffix = 2  # all lean passes in one chunk (cfg.mc_chunk None) + the full last pass
    # 3 SE epilogues x 2 encoders per suffix; 6 necks x 2; standalone SE:
    # modality attention x 2 in the prefix, fusion_se once per suffix; the
    # DWI z-score once in preprocessing
    expect = dict.fromkeys(COUNTERS, 0) | {"se_epilogue": 6 * n_suffix,
                                           "keep_mask": 6 * n_suffix,
                                           "conv3x3_bn_gelu": 12,
                                           "se_scale": 2 + n_suffix, "dwi_normalize": 1}
    log(f"  {cfg.mc_passes} MC passes x 4 views")
    launched = serve("tta_mc", cfg, request, expect, stochastic=True)
    return launched, request, functools.partial(serve_large, cfg, predict, expect)


def serve_large(cfg, predict, expect):
    """One default ``tta_mc`` request at B_LARGE: the lean passes fold into
    one batch of (mc_passes - 1) x 4 x B_LARGE maps, so kernel 1's largest
    map passes 2^31 elements; counts set to 0 just before and read just
    after."""
    n_lean = (cfg.mc_passes - 1) * 4 * B_LARGE
    epi = n_lean * 32 * 32 * max(EPI_CHANNELS)
    neck = max(4 * B_LARGE * side * side * max(cin, cout) for _, cin, cout, side in NECKS)
    log(f"== phase 5c: one tta_mc request at B={B_LARGE} in bf16: kernel 1's largest map "
        f"{n_lean} x 32^2 x {max(EPI_CHANNELS)} = {epi / 2 ** 31:.3f} x 2^31 elements; "
        f"kernel 2's largest map at {4 * B_LARGE} views {neck / 2 ** 31:.3f} x 2^31 (its "
        f"32-bit guard {'not ' if neck < 2 ** 31 else ''}reached)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    request = raw_request(cfg, predict, gen(24), gen(25), b=B_LARGE)
    reset_counts()
    dt, mean, std = request()
    launched = counts()
    gate(f"tta_mc B={B_LARGE}", cfg, launched, expect, mean, std, True, B_LARGE)
    log(f"  tta_mc B={B_LARGE}: {dt * 1e3:.2f} ms (first request at this B: cuDNN "
        f"plans for new shapes included), preprocessing {request.split[0]:.3f} ms, predictor "
        f"{request.split[1]:.3f} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; probabilities finite, "
        f"summing to 1, std finite and > 0; launches as at B={B_SERVE}")
    del request, mean, std
    torch.cuda.empty_cache()


def phase_serve_hybrid(hcfg):
    log(f"== phase 5b: serve hybrid-nb in bf16, normal then tta, {REQUESTS} requests "
        f"of B={B_SERVE} raw volumes each")
    models = build_fusion_models(hcfg, DEV, torch.bfloat16, gen(SEED))
    launched, requests = [], {}
    for mode in ("normal", "tta"):
        predict = make_fusion_predictor(hcfg, *models, mode=mode)
        requests[mode] = raw_request(hcfg, predict, gen(23))
        launched.append(serve(f"hybrid-nb {mode}", hcfg, requests[mode],
                              HYBRID_EXPECT | {"dwi_normalize": 1}, stochastic=False))
    return launched, requests["normal"]


# ------------------------------------------------------------------ phase 16
# the MC ensemble across mc_chunk: every pass draws its masks from its own
# pass word of the request seed (ops/dropout.py), whatever chunk it runs in
MC_CHUNKS = (None, 1, 3)
MC_FLOOR_MARGIN = 3  # 16b: dropout-on gaps across chunkings within 3x the dropout-off floor
MC_HYB_B = 2         # 16c: bench.py --encoder hybrid-nb's MC batch
KEEP_KERNELS = ("keep_mask_kernel",)


def mask_digest(keep):
    """A positional digest of a bool mask, on its device: its bytes in the
    seed order read as int64 words (copied and zero-padded where they do not
    align), each times an odd weight of its index, summed with int64
    wrap-around."""
    flat = (keep.permute(0, 2, 3, 1) if keep.dim() == 4 else keep).reshape(-1).view(torch.uint8)
    if flat.numel() % 8 or flat.storage_offset() % 8:
        flat = torch.cat([flat, flat.new_zeros(-flat.numel() % 8)])
    words = flat.view(torch.int64)
    return (words * torch.arange(1, 2 * words.numel(), 2, device=words.device)).sum()


@contextlib.contextmanager
def recorded_masks(digest=False):
    """``(masks, calls)``: the seed-route keep mask of every dropout site run
    under the context, split into its passes, ``{pass: [mask, ...]}`` in the
    order the sites draw them (``digest``: :func:`mask_digest` of each), and
    each site's call ``(kind, shape, dtype, drop_rate, base, first_pass,
    passes)``.  On the card a keep-mask site's mask is the kernel's output
    and a kernel 1 site's the keep-mask kernel on its arguments (phase 3a and
    16a hold the two bit-equal; a direct call, which no count sees); on the
    CPU ``keep_mask_plain``'s output.  A fused attention site (the dropout
    forward) records its call alone, with the shape of the whole (B, H, N_q,
    N_k) weights whose counters it takes; its bits are phase 3i(b)'s."""
    masks, calls = collections.defaultdict(list), []
    kernel, launch, plain, fused = (epilogue_cuda.keep_mask, epilogue_cuda.launch_se_epilogue,
                                    seed_route.keep_mask_plain, fa.launch_flash_forward_dropout)

    def record(kind, keep, drop_rate, base, first_pass, passes, dtype):
        calls.append((kind, tuple(keep.shape), dtype, drop_rate, base, first_pass, passes))
        for p, part in enumerate(keep.chunk(passes)):
            masks[first_pass + p].append(mask_digest(part) if digest else part)

    def keep_mask(x, drop_rate, seed, base=0, first_pass=0, passes=1):
        keep = kernel(x, drop_rate, seed, base, first_pass, passes)
        record("keep_mask", keep, drop_rate, base, first_pass, passes, x.dtype)
        return keep

    def launch_se_epilogue(x, identity, w1, b1, w2, b2, drop_rate, seed, base=0,
                           first_pass=0, passes=1):
        if drop_rate > 0.0:
            record("se_epilogue", kernel(x, drop_rate, seed, base, first_pass, passes),
                   drop_rate, base, first_pass, passes, x.dtype)
        return launch(x, identity, w1, b1, w2, b2, drop_rate, seed, base, first_pass, passes)

    def keep_mask_plain(shape, drop_rate, seed, base=0, first_pass=0, passes=1):
        keep = plain(shape, drop_rate, seed, base, first_pass, passes)
        record("plain", keep, drop_rate, base, first_pass, passes, None)
        return keep

    def launch_flash_forward_dropout(q, k, v, scale, p, seed, base, first_pass, passes, heads,
                                     h0, group):
        if h0 != 0 or heads != q.shape[1]:
            raise AssertionError(f"a fused attention site of one process at heads {h0}.. of "
                                 f"{heads}, {q.shape[1]} a call")
        calls.append(("fused", (q.shape[0], heads, q.shape[2], k.shape[2]), q.dtype, p, base,
                      first_pass, passes))
        return fused(q, k, v, scale, p, seed, base, first_pass, passes, heads, h0, group)

    epilogue_cuda.keep_mask, epilogue_cuda.launch_se_epilogue = keep_mask, launch_se_epilogue
    seed_route.keep_mask_plain = keep_mask_plain
    fa.launch_flash_forward_dropout = launch_flash_forward_dropout
    try:
        yield masks, calls
    finally:
        epilogue_cuda.keep_mask, epilogue_cuda.launch_se_epilogue = kernel, launch
        seed_route.keep_mask_plain = plain
        fa.launch_flash_forward_dropout = fused


def same_masks(tag, runs):
    """Every run's masks (or digests) equal the first run's, pass by pass and
    site by site; returns the (pass, site) masks of a run."""
    (ref_name, ref), *rest = runs.items()
    for name, masks in rest:
        if sorted(masks) != sorted(ref) or any(len(masks[p]) != len(ref[p]) for p in ref):
            raise AssertionError(f"{tag}: {name} drew other passes or sites than {ref_name}")
        for p, sites in ref.items():
            for i, (got, want) in enumerate(zip(masks[p], sites)):
                if not torch.equal(got.to(want.device), want):
                    raise AssertionError(f"{tag}: pass {p} site {i}: the mask of {name} differs "
                                         f"from {ref_name}'s")
    return sum(len(v) for v in ref.values())


def mc_expect(models, chunk, passes, prefix, fused=True):
    """The launches of one ``tta_mc`` request of the fusion ``models`` at
    ``mc_chunk`` ``chunk``: per suffix forward (each lean chunk, then the last
    pass) and encoder, kernel 1 once a ResLite block and the keep-mask kernel
    once a bottleneck and three times a transformer block (the projection,
    the MLP's two), and its attention dropout once a block: the fused
    forward (``fused``: at the flash shapes, hybrid-nb's 4096 tokens), or
    the weights route's keep-mask kernel, its head-shared instance at
    hybrid-nb's 4 heads; kernel 6 on the modality attention twice and on
    fusion_se once a suffix; ``prefix`` the rest."""
    n_lean = passes - 1
    n_suffix = -(-n_lean // (n_lean if chunk is None else min(chunk, n_lean))) + 1
    n_epi = n_keep = n_attn = 0
    for enc in models[:2]:
        blocks = [b for b in (enc.block1, enc.block2, enc.block3) if b is not None]
        n_epi += len(blocks)
        n_keep += sum(len(b.bottlenecks) for b in blocks)
        if enc.transformer is not None:
            n_keep += 3 * len(enc.transformer.transformer.layers)
            n_attn += len(enc.transformer.transformer.layers)
    if not fused:
        n_keep, n_attn = n_keep + n_attn, 0
    return dict.fromkeys(COUNTERS, 0) | prefix | {
        "se_epilogue": n_epi * n_suffix, "keep_mask": n_keep * n_suffix, "se_scale": 2 + n_suffix,
        "flash_attention_fwd_dropout": n_attn * n_suffix,
        DROP_INSTANCES["head_shared"]: n_attn * n_suffix}


def mc_inputs(cfg, b, seed):
    S = cfg.dwi_model.input_size
    g = gen(seed)
    return preprocess_fusion_inputs(
        torch.rand(b, S, S, cfg.dwi_base_channel_num, device=DEV, generator=g) * 1000.0,
        torch.rand(b, S, S, cfg.dce_channel_num, device=DEV, generator=g),
        torch.full((S, S, 1), 0.5, device=DEV))


def mc_run(name, cfg, models, chunk, dx, cx, seed, prefix, record=None, fused=True):
    """One ``tta_mc`` request of preprocessed ``(dx, cx)`` at ``mc_chunk``
    ``chunk`` on the seed tensor ``seed``: ``(mean, std, launches, s, peak
    GiB)``, the launches counted from 0 and gated (``prefix``: the launches
    beside the suffixes'; None: not gated; ``fused``: attention dropout on the
    fused forward); ``record`` (False or True for digests): also the masks,
    under :func:`recorded_masks`."""
    predict = make_fusion_predictor(cfg, *models, mode="tta_mc", mc_chunk=chunk)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with (recorded_masks(record) if record is not None
          else contextlib.nullcontext((None, None))) as (masks, calls):
        (mean, std, _), dt = synced(lambda: predict(dx, cx, seed))
    launched = counts()
    if prefix is not None:
        gate(name, cfg, launched, mc_expect(models, chunk, cfg.mc_passes, prefix, fused), mean,
             std, True, dx.shape[0])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return mean, std, launched, dt, peak, masks, calls


def gaps(runs):
    """Max |mean| and |std| differences of each run from the first."""
    (m0, s0), *rest = runs.values()
    return max([0.0] + [max((m - m0).abs().max().item(), (s - s0).abs().max().item())
                        for m, s in rest])


def mc_kernels(calls, seed):
    """16a: each distinct seed-route call of a request (kernel 1 and the
    keep-mask kernel, with their pass words) on synthetic inputs of its shape:
    the keep-mask kernel bit-equal to ``keep_mask_plain``, kernel 1's zeros
    exactly its drops and its output within TOL of the plain version on that
    mask; the keep-mask kernel's ms summed over the request's calls beside
    the plain version's, a same-size ``torch.rand < keep`` draw and the bytes
    bound (one byte written an element), and its device time."""
    g = gen(162)
    distinct = {}
    for call in calls:
        distinct[call] = distinct.get(call, 0) + 1
    ms = plain_ms = draw_ms = bound = 0.0
    devs = []
    for (kind, shape, dtype, p, base, first, passes), n in distinct.items():
        tag = (f"{kind} {shape} {str(dtype)[6:]} drop {p} base {base} passes {first}.."
               f"{first + passes - 1} (x{n} a request)")
        x = torch.randn(*shape, device=DEV, generator=g).to(dtype)
        x = cl(x) if x.dim() == 4 else x
        keep = epilogue_cuda.keep_mask(x, p, seed, base, first, passes)
        if not torch.equal(keep, seed_route.keep_mask_plain(shape, p, seed, base, first, passes)):
            raise AssertionError(f"16a {tag}: the keep-mask kernel differs from the plain mask")
        if kind == "se_epilogue":
            c = shape[1]
            idn = cl(torch.randn(*shape, device=DEV, generator=g).to(dtype))
            w = se_weights(c, g)
            out = k1.se_epilogue(x, idn, *w, drop_rate=p, generator=SeedStream(
                seed, counter=base, first_pass=first, passes=passes))
            drops_match(f"16a {tag}", out, keep, x, idn)
            check(f"16a {tag}: kernel 1 (its drops bit-equal to the plain mask)", out,
                  k1.se_epilogue_ref(x, idn, *w, drop_rate=p, keep=keep), dtype)
            continue
        t_k = cuda_time(lambda: epilogue_cuda.keep_mask(x, p, seed, base, first, passes))
        t_p = cuda_time(lambda: seed_route.keep_mask_plain(shape, p, seed, base, first, passes),
                        reps=3, trials=3)
        t_d = cuda_time(lambda: torch.rand(shape, device=DEV) < (1.0 - p))
        b = keep.numel() / HBM_BYTES_PER_S * 1e3
        log(f"  16a {tag}: bit-equal to the plain mask; kernel {t_k:.4f} ms, plain "
            f"{t_p:.4f} ms, torch.rand < keep {t_d:.4f} ms, bound {b:.4f} ms (bytes, "
            f"{keep.numel() / 1e6:.1f} MB written)")
        devs.append(device_rate(f"16a {tag}", lambda: epilogue_cuda.keep_mask(
            x, p, seed, base, first, passes), KEEP_KERNELS, b, nbytes=keep.numel())[0])
        if devs[-1] is not None:
            devs[-1] *= n
        ms, plain_ms, draw_ms, bound = ms + n * t_k, plain_ms + n * t_p, draw_ms + n * t_d, \
            bound + n * b
    device = ("device not measured" if None in devs else
              f"device {sum(devs):.4f} ms ({100 * bound / sum(devs):.1f} % of the bound)")
    n_keep = sum(n for call, n in distinct.items() if call[0] == "keep_mask")
    log(f"  16a keep-mask kernel, a request's {n_keep} calls summed: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, torch.rand < keep {draw_ms:.4f} ms, bound {bound:.4f} ms (bytes); "
        f"{device}")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": None, "draw_ms": draw_ms}


def phase_mc_chunks(cfg, hcfg):
    """Phase 16: the MC ensemble across ``mc_chunk``, and 16d the fused
    attention against the weights route; returns the dropout-on requests'
    launches and the keep-mask kernel's numbers."""
    t_phase = time.perf_counter()
    log(f"== phase 16: the tta_mc ensemble across mc_chunk {MC_CHUNKS} (every pass's masks "
        f"from its own pass word): 16a kernel 1 and the keep-mask kernel with pass words at a "
        f"request's calls, 16b the default models bf16 B={B_SERVE}, 16c hybrid-nb bf16 "
        f"B={MC_HYB_B} (its attention dropout on the fused forward), 16d against the weights "
        f"route")
    launched = dict.fromkeys(COUNTERS, 0)
    seed = torch.tensor([(0x5EED << 32) | 16], device=DEV)
    # 16b: the default models, masks kept whole; the dropout-off floor first
    models = build_fusion_models(cfg, DEV, torch.bfloat16, gen(SEED))
    dx, cx = mc_inputs(cfg, B_SERVE, 161)
    blocks = [b for m in models for b in m.modules() if hasattr(b, "bottlenecks")]
    rates = [b.dropout for b in blocks]
    for b in blocks:
        b.dropout = 0.0
    mc_run("16b warm-up", cfg, models, None, dx, cx, seed, None)
    off = {c: mc_run("16b drop 0", cfg, models, c, dx, cx, seed, None)[:2] for c in MC_CHUNKS}
    for b, r in zip(blocks, rates):
        b.dropout = r
    floor = gaps(off)
    on, masks, calls = {}, {}, None
    for c in MC_CHUNKS:
        mean, std, got, dt, peak, _, _ = mc_run(f"16b chunk {c}", cfg, models, c, dx, cx, seed,
                                                {"conv3x3_bn_gelu": 12})
        launched = {k: launched[k] + got[k] for k in COUNTERS}
        on[c] = (mean, std)
        _, _, _, _, _, masks[f"mc_chunk {c}"], rec = mc_run(
            f"16b chunk {c} recorded", cfg, models, c, dx, cx, seed, None, record=False)
        calls = rec if c is None else calls
        log(f"  16b mc_chunk {c}: {dt * 1e3:.2f} ms, peak {peak:.2f} GiB, launches "
            + ", ".join(f"{k} {v}" for k, v in got.items() if v))
    n = same_masks("16b", masks)
    gap, bound = gaps(on), max(MC_FLOOR_MARGIN * floor, 1e-6)
    log(f"  16b: {n} (pass, site) masks a request bit-equal across mc_chunk {MC_CHUNKS}; mean "
        f"and std across the chunkings within {gap:.3e} of the unchunked (dropout-off floor "
        f"{floor:.3e}; bound {bound:.3e})")
    if not gap <= bound:
        raise AssertionError(f"16b: the chunked ensembles stray {gap} from the unchunked")
    del masks, on, off, models, dx, cx
    torch.cuda.empty_cache()
    measured = mc_kernels(calls, seed)
    torch.cuda.empty_cache()
    # 16c: hybrid-nb, the masks as digests (each pass holds 4 x 4096^2 weights a
    # view, layer and encoder); unchunked where it fits the card
    models = build_fusion_models(hcfg, DEV, torch.bfloat16, gen(SEED))
    dx, cx = mc_inputs(hcfg, MC_HYB_B, 163)
    mc_run("16c warm-up", hcfg, models, 1, dx, cx, seed, None)
    on, digests, sites = {}, {}, {}
    for c in (1, 3, None):
        try:
            mean, std, got, dt, peak, _, _ = mc_run(f"16c chunk {c}", hcfg, models, c, dx, cx,
                                                    seed, {})
            d, sites[c] = mc_run(f"16c chunk {c} recorded", hcfg, models, c, dx, cx, seed,
                                 None, record=True)[5:]
        except torch.cuda.OutOfMemoryError:
            log(f"  16c mc_chunk {c}: out of device memory (not run)")
            torch.cuda.empty_cache()
            continue
        launched = {k: launched[k] + got[k] for k in COUNTERS}
        on[c] = (mean, std)
        digests[f"mc_chunk {c}"] = {p: [t.cpu() for t in v] for p, v in d.items()}
        log(f"  16c mc_chunk {c}: {dt * 1e3:.2f} ms, peak {peak:.2f} GiB, launches "
            + ", ".join(f"{k} {v}" for k, v in got.items() if v))
        del d
        torch.cuda.empty_cache()
    n = same_masks("16c", digests)
    gap = gaps(on)
    log(f"  16c: {n} (pass, site) mask digests a request (the keep-mask sites; the fused "
        f"attention sites' bits are 3i(b)'s) equal across mc_chunk {tuple(on)}; mean and std "
        f"within {gap:.3e} of chunk 1's (bound {TOL[torch.bfloat16]:.3e}, one bf16 ulp at 1)")
    if len(on) < 2 or not gap <= TOL[torch.bfloat16]:
        raise AssertionError(f"16c: chunkings {tuple(on)}, gap {gap}")
    predict = make_fusion_predictor(hcfg, *models, mode="tta_mc", mc_chunk=1)
    phase_profile(f"hybrid-nb tta_mc B={MC_HYB_B} mc_chunk 1",
                  lambda: (synced(lambda: predict(dx, cx, seed))[1], None, None), "16c")
    # 16d's launches are the weights route's, which the program does not take
    # here: gated in 16d and kept out of the main path's counts
    mc_fused_against_weights(hcfg, models, dx, cx, seed, on[1], sites[1])
    del models, dx, cx
    torch.cuda.empty_cache()
    log(f"  phase 16: {time.perf_counter() - t_phase:.1f} s")
    return launched, measured


def mc_fused_against_weights(hcfg, models, dx, cx, seed, fused, fused_sites):
    """16d: the hybrid-nb ``tta_mc`` request of 16c on the weights route
    (called explicitly, :func:`weights_route`) at mc_chunk 1 on the same seed:
    its ms, peak and launches, gated on their own (the keep-mask kernel at the
    attention sites, no fused forward); every dropout site of the request, in
    order, takes the same (shape, dtype, rate, counter base, passes) on both
    routes (``fused_sites``: 16c's chunk 1 calls, each fused site's with the
    whole weights' shape); and the mean and std within 3x the floor that the
    two attention routes show with dropout off (a ``tta`` request through the
    flash forward and through the plain attention) of the fused route's
    ``fused`` (16c's chunk 1)."""
    with weights_route():
        mean, std, got, dt, peak, _, _ = mc_run("16d weights route", hcfg, models, 1, dx, cx,
                                                seed, {}, fused=False)
        sites = mc_run("16d weights route recorded", hcfg, models, 1, dx, cx, seed, None,
                       record=True)[6]
    n_fused = sum(c[0] == "fused" for c in fused_sites)
    if n_fused == 0 or [c[1:] for c in sites] != [c[1:] for c in fused_sites]:
        raise AssertionError("16d: the fused request's dropout sites differ from the weights "
                             "route's in shape, rate, counter base or passes")
    predict = make_fusion_predictor(hcfg, *models, mode="tta")
    flash = predict(dx, cx, None)[:2]
    with plain_route():
        plain = predict(dx, cx, None)[:2]
    floor = gaps({"flash": flash, "plain": plain})
    gap = gaps({"fused": fused, "weights": (mean, std)})
    bound = MC_FLOOR_MARGIN * floor
    log(f"  16d hybrid-nb B={MC_HYB_B} on the weights route (materialized weights, the "
        f"keep-mask kernel), mc_chunk 1: {dt * 1e3:.2f} ms, peak {peak:.2f} GiB, launches "
        + ", ".join(f"{k} {v}" for k, v in got.items() if v)
        + f" (not the main path's: kept out of the kernels line); its {len(sites)} dropout "
        f"sites take the fused request's shapes, rates, counter bases and passes ({n_fused} "
        f"of them fused there); mean and std within {gap:.3e} of the fused route's (the "
        f"attention routes' dropout-off floor {floor:.3e}; bound {MC_FLOOR_MARGIN}x, "
        f"{bound:.3e})")
    if not gap <= bound:
        raise AssertionError(f"16d: the fused ensemble strays {gap} from the weights route's")
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 6
# the hand-written kernels as the profiler names them (regular expressions),
# for phase 6: the forward kernels' p = 0 and dropout instances apart, by
# their template's DROP argument (0; 1 per-element, 2 head-shared)
FLASH_FWD_P0 = (r"flash_fwd_\w+<\d+, 0>",)
FLASH_FWD_DROP = (r"flash_fwd_\w+<\d+, [12]>",)
DRAW_BITS = (r"draw_bits<\d+>",)  # the head-shared instance's pre-pass
PROFILE_KERNELS = {"kernel 1 se_epilogue (3 kernels a call)": EPI_KERNELS,
                   "kernel 2 conv3x3_bn_gelu": ("conv3x3_bn_gelu",),
                   "kernel 3 flash forward (p = 0)": FLASH_FWD_P0,
                   "flash forward with attention dropout (and its pre-pass)":
                       FLASH_FWD_DROP + DRAW_BITS,
                   "kernel 6 se_scale (3 kernels a call)": SE_KERNELS,
                   "kernel 7 dwi_normalize (3 kernels a call)": DWI_KERNELS}


def phase_profile(name, request, phase="phase 6"):
    log(f"== {phase}: profiler breakdown of one more {name} request (device time by kernel)")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dt, _, _ = request()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total = sum(e.self_device_time_total for e in events)
    log(f"  {name} request under the profiler {dt * 1e3:.2f} ms; device time "
        f"{total / 1e3:.2f} ms ({100 * (1 - total / 1e3 / (dt * 1e3)):.1f} % idle)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x  {e.key[:90]}")
    log("  device time of the hand-written kernels:")
    for name, keys in PROFILE_KERNELS.items():
        # a name counts where it starts the key or follows a non-name character
        # (kernel 6's `se_apply` is not part of kernel 7's `dwi_apply`)
        hits = [e for e in events
                if any(re.search(rf"(^|[^A-Za-z0-9_]){k}", e.key) for k in keys)]
        if hits:
            log(f"  {sum(e.self_device_time_total for e in hits) / 1e3:9.3f} ms "
                f"{sum(e.count for e in hits):5d}x  {name}")
    log("  device time by the host op that launched it:")
    ops = [e for e in prof.key_averages()
           if e.device_type.name == "CPU" and e.self_device_time_total > 0]
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x  {e.key[:90]}")
    log("  host time by op (self CPU time under the profiler):")
    ops = [e for e in prof.key_averages() if e.device_type.name == "CPU"]
    for e in sorted(ops, key=lambda e: -e.self_cpu_time_total)[:10]:
        log(f"  {e.self_cpu_time_total / 1e3:9.3f} ms {e.count:5d}x  {e.key[:90]}")


# ------------------------------------------------------------------ phase 7
# single-modality training of the default DWI encoder (ResNet-50 at 256^2, fp32)
B_TRAIN_PARITY = 2
PARITY_STEPS = 1  # per epoch: a step with the backbone frozen, one after its unfreeze
# card vs CPU after the steps (fp32, TF32 off): per-step losses rel 1e-3 (the
# ROADMAP's train-step tolerance).  The parameters and BatchNorm statistics are
# held against the disagreement of two CPU runs that differ only in memory
# format (contiguous vs channels_last): at full width and B=2 the train-mode
# forward is ill-conditioned (the two CPU runs' backbone updates differ by
# about a quarter in L2 after three steps; a bias before a BatchNorm has a
# gradient of pure rounding noise), and AdamW's first steps move each
# element by about +-lr whatever its gradient's size.  Bound: each
# group's card-vs-CPU difference over its update in L2, and the statistics'
# max error over max(1, max|CPU|), at most twice the two CPU runs' or 1e-3
TRAIN_LOSS_RTOL, TRAIN_FLOOR = 1e-3, 1e-3
# phase 7b: the first 158 + 32 volumes of the synthetic store; fold 0 of 5
# splits them into 128 train (4 full steps of B=32 an epoch) and 30 validation
RUN_TRAIN, RUN_TEST, RUN_EPOCHS = 158, 32, 2
# every fit draws the mask triptych of one validation sample at the epochs
# that are multiples of its viz_every (default 10: epoch 0 of these runs), one
# more eval forward on the served route: a validation batch's launches
VIZ_EVERY = 10


def drawn(epochs):
    """The triptychs a fit of ``epochs`` epochs draws."""
    return -(-epochs // VIZ_EVERY)


def train_config(cfg, **mc):
    """The default config for DWI training with the backbone unfrozen at
    epoch 1 (``foundation_model_unfreeze_timer=1``)."""
    return cfg.replace(foundation_model_unfreeze_timer=1,
                       dwi_model=dataclasses.replace(cfg.dwi_model, **mc))


def dwi_batches(rcfg, n, b, seed):
    """``n`` processed DWI batches of ``b`` raw 256^2 volumes (kernel 7 on the
    card, once a batch) with masks at the mask head's size and labels."""
    S = rcfg.dwi_model.input_size
    m = rcfg.dwi_model.mask.mask_target_size[0]
    proc = ModalityProcessor(rcfg, "dwi", adc_map=torch.full((S, S, 1), 0.5, device=DEV),
                             device=DEV)
    g = gen(seed)
    out = []
    for i in range(n):
        raw = torch.rand(b, S, S, rcfg.dwi_base_channel_num, device=DEV, generator=g) * 1000.0
        out.append({"imgs": proc.train_batch(g, raw),
                    "masks": (torch.rand(b, m, m, 1, device=DEV, generator=g) > 0.8).float(),
                    "labels": torch.arange(i, i + b, device=DEV) % rcfg.class_num})
    return out


def disagreement(model_a, model_b, init, spec):
    """Per group: ||a - b|| / ||b - init|| over the parameters (L2; the
    excluded group: ||a - b||), and the BatchNorm running statistics' max
    |a - b| over max(1, max|b|) under the key "stats"."""
    diff, upd = {}, {}
    pa = dict(model_a.named_parameters())
    for name, pb in model_b.named_parameters():
        g = spec.group_ids[name]
        a, b = pa[name].detach().double().cpu(), pb.detach().double().cpu()
        diff[g] = diff.get(g, 0.0) + ((a - b) ** 2).sum().item()
        upd[g] = upd.get(g, 0.0) + ((b - init[name].double()) ** 2).sum().item()
    out = {g: (diff[g] / upd[g]) ** 0.5 if upd[g] else diff[g] ** 0.5 for g in sorted(diff)}
    sa, worst = model_a.state_dict(), 0.0
    for k, b in model_b.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            b = b.double().cpu()
            worst = max(worst, (sa[k].double().cpu() - b).abs().max().item()
                        / max(1.0, b.abs().max().item()))
    out["stats"] = worst
    return out


def phase_train_parity(cfg):
    log(f"== phase 7a: train-step parity, card vs CPU: the default DWI encoder at full width "
        f"(ResNet-50, 256^2, fp32, TF32 off), B={B_TRAIN_PARITY}, dropout 0, {PARITY_STEPS} "
        f"steps with the backbone frozen then {PARITY_STEPS} after its unfreeze, the same "
        f"processed batches")
    cpu_model, rcfg = build_single_model(train_config(cfg, dropout=0.0), "dwi", device="cpu",
                                         generator=torch.Generator().manual_seed(SEED))
    models = {"card": copy.deepcopy(cpu_model).to(DEV).to(memory_format=torch.channels_last),
              "cpu": cpu_model,
              "cpu channels_last": copy.deepcopy(cpu_model).to(memory_format=torch.channels_last)}
    init = {n: p.detach().clone() for n, p in cpu_model.named_parameters()}
    spec = build_group_spec(list(init), True, rcfg.reference_compat)
    clf = get_classification_loss_fn(rcfg, np.arange(rcfg.class_num), "dwi")
    step = make_single_train_step(rcfg, "dwi", clf, get_mask_loss_fn(rcfg, "dwi"), spec)
    states = {k: TrainState.create(m) for k, m in models.items()}
    reset_counts()
    batches = dwi_batches(rcfg, 2 * PARITY_STEPS, B_TRAIN_PARITY, 41)
    prep_launches = counts()
    ctrl = SingleModelOptController(rcfg, "dwi")
    step_launches = dict.fromkeys(COUNTERS, 0)
    for i, batch in enumerate(batches):
        epoch = i // PARITY_STEPS
        if i % PARITY_STEPS == 0:
            ctrl.on_epoch_start(epoch)
            hp = ctrl.hyperparams()
        aux_w = aux_loss_weight(epoch, rcfg.aux_loss_weight_epoch_limit)
        before = counts()
        loss = {}
        for k, state in states.items():
            dev_batch = batch if k == "card" else {n: v.cpu() for n, v in batch.items()}
            loss[k] = float(step(state, dict(dev_batch, aux_w=aux_w), None, hp)["loss"])
            if k == "card":
                step_launches = {c: step_launches[c] + v - before[c]
                                 for c, v in counts().items()}
        rel = abs(loss["card"] - loss["cpu"]) / abs(loss["cpu"])
        log(f"  step {i} ({'backbone frozen' if hp.trainable[0] == 0 else 'all groups'}, "
            f"aux_w {aux_w:.4f}): loss card {loss['card']:.6f} CPU {loss['cpu']:.6f}, rel "
            f"{rel:.2e} (tolerance {TRAIN_LOSS_RTOL:.0e}; CPU channels_last "
            f"{loss['cpu channels_last']:.6f})")
        if not rel <= TRAIN_LOSS_RTOL:
            raise AssertionError(f"train step {i}: card loss off the CPU's by {rel}")
        if i == PARITY_STEPS - 1:  # the frozen group untouched on every device
            for model in models.values():
                for n, p in model.named_parameters():
                    if spec.group_ids[n] == 0 and not torch.equal(p.detach().cpu(), init[n]):
                        raise AssertionError(f"frozen parameter {n} changed")
            log("  after the frozen steps: every backbone and neck parameter bit-equal to "
                "its initial value in every run")
    log(f"  launches: batch preparation {prep_launches['dwi_normalize']} dwi_normalize for "
        f"{len(batches)} batches; train steps {step_launches}")
    if prep_launches != dict.fromkeys(COUNTERS, 0) | {"dwi_normalize": len(batches)}:
        raise AssertionError(f"batch preparation launched {prep_launches}")
    if step_launches != dict.fromkeys(COUNTERS, 0):
        raise AssertionError(f"train steps launched kernels: {step_launches}")
    card = disagreement(models["card"], cpu_model, init, spec)
    floor = disagreement(models["cpu channels_last"], cpu_model, init, spec)
    for g in card:
        what = ("BatchNorm running statistics (max err over max(1, max|CPU|))" if g == "stats"
                else f"group {spec.names[g] if g >= 0 else 'excluded (classification head)'} "
                     f"(difference over the update, L2)")
        tol = 0.0 if g == -1 else max(TRAIN_FLOOR, 2 * floor[g])
        log(f"  {what}: card vs CPU {card[g]:.3e}, CPU channels_last vs CPU {floor[g]:.3e} "
            f"(tolerance {tol:.3e})")
        if not card[g] <= tol:
            raise AssertionError(f"{what}: card off the CPU by {card[g]}, above {tol}")
    # one validation batch and one test batch on the card: the served route
    batch = batches[0]
    eval_step = make_single_eval_step(rcfg, "dwi", clf, get_mask_loss_fn(rcfg, "dwi"))
    reset_counts()
    eval_step(states["card"], batch)
    val_launches = counts()
    reset_counts()
    mean, std, _ = make_single_predictor(rcfg, models["card"], mode="tta_mc")(batch["imgs"],
                                                                               gen(42))
    test_launches = counts()
    log(f"  launches per validation batch {val_launches}; per tta_mc test batch "
        f"{test_launches}")
    expect_val = dict.fromkeys(COUNTERS, 0) | {"se_epilogue": 3, "conv3x3_bn_gelu": 6,
                                               "se_scale": 1}
    # tta_mc: the prefix (modality SE, backbone, necks) once, the suffix's three
    # SE epilogues on the lean chunk and on the full last pass (dropout 0 here:
    # no keep-mask launch)
    expect_test = expect_val | {"se_epilogue": 6}
    if val_launches != expect_val or test_launches != expect_test:
        raise AssertionError(f"eval launches {val_launches} / {test_launches}, expected "
                             f"{expect_val} / {expect_test}")
    gate("single tta_mc", rcfg, expect_test, expect_test, mean, std, True, B_TRAIN_PARITY)
    del states, models, cpu_model, batches
    torch.cuda.empty_cache()


# phase 7e: a hybrid-nb single model's validation batch (the fold builds its
# models in fp32, so the transformer stage's 6 blocks take the flash route in
# fp32, each at (B_VAL x 4 heads, 4096, 128)); its SE epilogues (block1,
# block2) and modality attention run kernels 1 and 6 in fp32
HYBRID_VAL_EXPECT = dict.fromkeys(COUNTERS, 0) | {"flash_attention_fwd": 6, "se_epilogue": 2,
                                                  "se_scale": 1}
HYBRID_VAL_RTOL = 1e-4  # card vs CPU logits over max|CPU logits|, fp32 both


def phase_hybrid_validation(hcfg):
    """The validation route of a full-width ``hybrid-nb`` DWI model:
    ``make_single_eval_step`` on one batch of B_VAL processed 256^2 volumes
    in fp32 (TF32 off), its launches and peak memory, its time by CUDA
    events, one profiled batch (the flash forward's device time, the idle
    share) and the first two volumes' logits against the same eval step on
    the CPU.  Returns the batch's launches and a summary of the times."""
    log(f"== phase 7e: hybrid-nb validation route at full width: make_single_eval_step on "
        f"the DWI encoder (transformer stage, 6 blocks, {HEADS} heads of {HEAD_DIM}, {SEQ} "
        f"tokens), B={B_VAL}, fp32 (TF32 off)")
    model, rcfg = build_single_model(hcfg, "dwi", device=DEV, generator=gen(SEED))
    clf = get_classification_loss_fn(rcfg, np.arange(rcfg.class_num), "dwi")
    eval_step = make_single_eval_step(rcfg, "dwi", clf, get_mask_loss_fn(rcfg, "dwi"))
    state = TrainState.create(model)
    batch = dwi_batches(rcfg, 1, B_VAL, 43)[0]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    logits, probs, _ = eval_step(state, batch)
    torch.cuda.synchronize()
    launched = counts()
    peak = torch.cuda.max_memory_allocated()
    scratch = 4 * B_VAL * HEADS * SEQ * HEAD_DIM * 4  # fa.flash_forward's, one call at a time
    log(f"  launches per validation batch {launched}; peak memory {peak / 2 ** 30:.3f} GiB, "
        f"{(peak - base) / 2 ** 30:.3f} GiB above the model and batch, of which the fp32 "
        f"flash forward's K/V scratch takes {scratch / 2 ** 30:.3f} GiB a call")
    if launched != HYBRID_VAL_EXPECT:
        raise AssertionError(f"hybrid-nb validation batch launched {launched}, expected "
                             f"{HYBRID_VAL_EXPECT}")
    if logits.shape != (B_VAL, rcfg.class_num) or not torch.isfinite(logits).all() \
            or (probs.sum(-1) - 1).abs().max().item() > 1e-3:
        raise AssertionError("validation logits not finite or misshapen, or probabilities "
                             "not summing to 1")
    batch_ms = cuda_time(lambda: eval_step(state, batch), reps=1, trials=5)
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eval_step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device = sum(e.self_device_time_total for e in events) / 1e3
    # the fp32 forward and its pre-pass, under either tree's names
    flash = sum(e.self_device_time_total for e in events
                if any(k in e.key for k in ("flash_fwd", "flash_split"))) / 1e3
    log(f"  validation batch {batch_ms:.3f} ms (median of 5 by CUDA events), "
        f"{B_VAL * 1e3 / batch_ms:.2f} volumes/s; one batch under the profiler {wall:.3f} ms, "
        f"device time {device:.3f} ms ({100 * (1 - device / wall):.1f} % idle), flash "
        f"forward {flash:.3f} ms ({100 * flash / device:.1f} % of the device time)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x  {e.key[:90]}")
    cpu_model = copy.deepcopy(model).cpu().to(memory_format=torch.contiguous_format)
    t0 = time.perf_counter()
    cpu_logits = eval_step(TrainState.create(cpu_model),
                           {k: v[:2].cpu() for k, v in batch.items()})[0]
    err = (logits[:2].cpu() - cpu_logits).abs().max().item()
    rel = err / cpu_logits.abs().max().item()
    log(f"  first two volumes' logits, card vs CPU ({time.perf_counter() - t0:.1f} s): "
        f"max_abs_err {err:.3e}, over max|CPU| {rel:.3e} (tolerance "
        f"{HYBRID_VAL_RTOL:.0e}); CPU logits {cpu_logits.numpy().round(5).tolist()}")
    if not rel <= HYBRID_VAL_RTOL:
        raise AssertionError(f"hybrid-nb validation logits off the CPU's by {rel}")
    del cpu_model, model, state, batch
    torch.cuda.empty_cache()
    return launched, {"val_batch_ms": batch_ms, "profiled_ms": wall, "device_ms": device,
                      "flash_device_ms": flash, "peak_gib": peak / 2 ** 30,
                      "peak_above_gib": (peak - base) / 2 ** 30}


def all_finite(metrics):
    vals = []
    for v in metrics.values():
        vals.extend(v if isinstance(v, list) else [v])
    return all(np.isfinite(float(x)) for x in vals)


def phase_run_single(cfg, raw, tmp):
    B = cfg.batch_size
    log(f"== phase 7b: run_single_model('dwi') on the card: the default DWI encoder at full "
        f"width (ResNet-50, 256^2, fp32, TF32 off), B={B}, {RUN_TRAIN} + {RUN_TEST} synthetic "
        f"volumes, {RUN_EPOCHS} epochs, backbone unfrozen at epoch 1, test in "
        f"{cfg.test_mode} ({cfg.mc_passes} passes)")
    store = {"imgs": raw["dwi"][:RUN_TRAIN], "test_imgs": raw["dwi_test"][:RUN_TEST],
             "labels": raw["labels"][:RUN_TRAIN], "test_labels": raw["labels_test"][:RUN_TEST],
             "masks": raw["masks"][:RUN_TRAIN]}
    rcfg0 = train_config(cfg).replace(base_path=os.path.join(tmp, "data"))
    data = prepare_single_data(rcfg0, "dwi", 0, raw=store, device=DEV)
    n_tr, n_va = len(data.splits["train"]["labels"]), len(data.splits["val"]["labels"])
    model, rcfg = build_single_model(rcfg0, "dwi", device=DEV, generator=gen(SEED))
    init = {k: t.detach().clone() for k, t in model.state_dict().items()
            if k.startswith("backbone.")}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out, t_run = synced(lambda: run_single_model(
        rcfg, "dwi", 0, data=data, state=TrainState.create(model), num_epochs=RUN_EPOCHS,
        min_epochs=RUN_EPOCHS, base_dir=os.path.join(tmp, "results"), device=DEV))
    launched = counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    hist = out["history"]
    n_steps = -(-n_tr // B)
    log(f"  splits: train {n_tr} ({n_steps} steps an epoch), validation {n_va}, test "
        f"{RUN_TEST}; run {t_run:.2f} s (prepare excluded); peak memory {peak:.2f} GiB")
    for e, h in enumerate(hist):
        log(f"  epoch {e}: train {h['train_time']:.3f} s, validation "
            f"{h['epoch_time'] - h['train_time']:.3f} s, epoch {h['epoch_time']:.3f} s; "
            f"train loss {h['train_loss']:.5f}, val loss {h['val_loss']:.5f}, val acc "
            f"{h['val_acc']:.4f}, val AUC {h['val_roc_auc']:.4f}; group lrs "
            f"{[float(f'{x:.3g}') for x in h['group_lrs']]}, trainable "
            f"{h['group_trainable']}")
    prep_ms = [p for p, _ in out["step_ms"]]
    step_ms = [s_ for _, s_ in out["step_ms"]]
    # full batches of B after the first step (cuDNN plans); a short tail
    # batch ends each epoch when B does not divide the split
    full = [t for i, t in enumerate(step_ms)
            if i and (i % n_steps < n_steps - 1 or n_tr % B == 0)]
    med = statistics.median(full)
    log(f"  train steps by CUDA events (ms): {', '.join(f'{t:.2f}' for t in step_ms)}; "
        f"median of the {len(full)} full batches after the first {med:.2f} ms "
        f"({min(full):.2f}-{max(full):.2f}), {1e3 / med:.3f} steps/s, "
        f"{B * 1e3 / med:.2f} volumes/s; batch preparation (augment + kernel 7) median "
        f"{statistics.median(prep_ms):.3f} ms ({min(prep_ms):.3f}-{max(prep_ms):.3f})")
    log(f"  test metrics {json.dumps({k: round(v, 5) for k, v in out['test_metrics'].items()})}")
    if len(hist) != RUN_EPOCHS or not all(all_finite(h) for h in hist) \
            or not all_finite(out["test_metrics"]):
        raise AssertionError("a metric is not finite (or an epoch is missing)")
    if [h["group_trainable"][0] for h in hist] != [0.0, 1.0]:
        raise AssertionError("the backbone group was not frozen then trained")
    # launches: kernel 7 once a train batch, once for each eval_split (validation
    # in the fit, test in the test pass) and 3 times in export_processed_splits;
    # kernels 1, 2, 6 per validation batch (and triptych) and per tta_mc test
    # batch (phase 7a)
    n_val, n_test = -(-n_va // B), -(-RUN_TEST // B)
    n_eval = RUN_EPOCHS * n_val + drawn(RUN_EPOCHS)
    expect = dict.fromkeys(COUNTERS, 0) | {
        "dwi_normalize": RUN_EPOCHS * n_steps + 2 + 3,
        "se_epilogue": 3 * n_eval + 6 * n_test, "keep_mask": 6 * n_test,
        "conv3x3_bn_gelu": 6 * (n_eval + n_test),
        "se_scale": n_eval + n_test}
    log(f"  launches of the run {launched}")
    if launched != expect:
        raise AssertionError(f"run launched {launched}, expected {expect}")
    # the rolling checkpoint holds the state after epoch 0 (loop.ROLL_EVERY 10)
    ckdir = os.path.join(tmp, "results", "dwi", "fold_0", "checkpoints")
    after0 = torch.load(os.path.join(ckdir, "last.pt"), map_location=DEV,
                        weights_only=True)["model"]
    final = out["final_state"].model.state_dict()
    stats = [k for k in init if k.endswith(("running_mean", "running_var"))]
    params = [n for n, _ in out["final_state"].model.named_parameters()
              if n.startswith("backbone.")]
    if not all(torch.equal(after0[k], init[k]) for k in params):
        raise AssertionError("a backbone parameter changed in the frozen epoch")
    if not all(not torch.equal(after0[k], init[k]) and not torch.equal(final[k], after0[k])
               for k in stats):
        raise AssertionError("a backbone BatchNorm statistic did not move in each epoch")
    n_moved = sum(not torch.equal(final[k], init[k]) for k in params)
    log(f"  backbone: {len(params)} parameters bit-equal to their initial values after "
        f"epoch 0, {n_moved} of them changed after epoch 1; its {len(stats)} BatchNorm "
        f"statistics moved in both epochs")
    if n_moved != len(params):
        raise AssertionError("a backbone parameter did not train after the unfreeze")
    # the best checkpoint reloaded into a model of other weights
    fresh, _ = build_single_model(rcfg0, "dwi", device=DEV, generator=gen(SEED + 1))
    load_checkpoint(out["best_checkpoint"], TrainState.create(fresh))
    val = torch.as_tensor(data.processors_by_split["val"].eval_split(
        data.splits["val"]["imgs"][:B]), device=DEV)
    with torch.no_grad():
        a = fresh(to_model(val, fresh))[0]
        b = out["state"].model(to_model(val, fresh))[0]
    err = (a - b).abs().max().item()
    log(f"  best checkpoint reloaded: eval logits max_abs_err {err:.3e} against the best "
        f"state's (tolerance 0: {'bit-equal' if err == 0 else 'NOT bit-equal'})")
    if err != 0:
        raise AssertionError("reloaded checkpoint gives other logits")
    probs, std = out["test_probs"], out["test_std"]
    if not (np.abs(probs.sum(-1) - 1) <= 1e-3).all() or not (std > 0).all():
        raise AssertionError("test probabilities do not sum to 1, or an MC std is 0")
    log(f"  test: probabilities finite and summing to 1, MC std > 0 (mean "
        f"{std.mean():.5f})")
    # the test pass timed again on its own
    reset_counts()
    res, t_test = synced(lambda: test_single_model(rcfg, out["state"], data, seed=1))
    log(f"  test_single_model again: {t_test:.3f} s for {RUN_TEST} volumes "
        f"({RUN_TEST / t_test:.2f} volumes/s, eval_split included), launches {counts()}")
    # one more train step under the profiler, on the final state
    state = out["final_state"]
    clf = get_classification_loss_fn(rcfg, data.train_labels, "dwi")
    spec = build_group_spec([n for n, _ in state.model.named_parameters()], True,
                            rcfg.reference_compat)
    step = make_single_train_step(rcfg, "dwi", clf, get_mask_loss_fn(rcfg, "dwi"), spec)
    ctrl = SingleModelOptController(rcfg, "dwi")
    ctrl.on_epoch_start(1)
    hp = ctrl.hyperparams()
    idx = np.arange(B)
    batch = {"imgs": data.processor.train_batch(gen(43), data.splits["train"]["imgs"][idx]),
             "masks": torch.as_tensor(data.splits["train"]["masks"][idx], device=DEV),
             "labels": data.splits["train"]["labels"][idx], "aux_w": 1.0}
    step(state, batch, gen(44), hp)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, dt = synced(lambda: step(state, batch, gen(44), hp))
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total = sum(e.self_device_time_total for e in events) / 1e3
    idle = (f"{100 * (1 - total / (dt * 1e3)):.1f} % idle" if total > 0
            else "device time not measured: the profiler recorded no kernel")
    log(f"  one train step under the profiler: {dt * 1e3:.2f} ms, device time {total:.2f} "
        f"ms ({idle}); top device kernels:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x  {e.key[:90]}")
    del res, state, model, fresh
    torch.cuda.empty_cache()
    return launched, out, rcfg0

# fusion training of the default models (two ResNet-50 encoders + the fusion
# head at 256^2, fp32): 7c parity at B=4 (the sample-pair mimic is live from
# 4 samples), 2 steps an epoch with unfreeze_timer=1, so group 2 (both
# encoders' block3 + other) joins at step 2; 7d the fold end to end
B_FUSION_PARITY = 4
FUSION_PARITY_STEPS = 1
# card vs CPU after the fusion steps: each group's parameter update (L2) and
# the statistics within three times the two CPU memory formats'
# disagreement, or 1e-3 where that is smaller.  Three, not 7a's two: the
# card's cuDNN algorithms (FFT, split reductions) round further from the CPU
# than the CPU's two layouts do from each other; two runs on the H100 read
# the fusion head's update 1.94x its two-layout floor (2.334e-03 and
# 2.339e-03 against 1.202e-03) and the encoders' block3 group 1.13x
# (1.032e-02 and 1.030e-02 against 9.134e-03)
FUSION_FLOOR_MARGIN = 3
FUSION_EPOCHS = 3  # unfreeze_timer=1: groups 2 and 1 join at epochs 1 and 2
FUSION_LOSSES = ("loss", "clf_loss", "mask_loss", "recon_loss", "mimic_loss")
# kernel launches per fusion validation batch and per tta_mc test batch: the
# SE epilogue 3 x 2 encoders per suffix (validation: one; test: the lean
# chunk and the last pass), the necks 6 x 2 once (the test's prefix runs
# once), the standalone SE on both modality attentions and once per suffix
# at fusion_se
FUSION_VAL = {"se_epilogue": 6, "keep_mask": 0, "conv3x3_bn_gelu": 12, "se_scale": 3}
FUSION_TEST = {"se_epilogue": 12, "keep_mask": 12, "conv3x3_bn_gelu": 12, "se_scale": 4}


def fusion_config(cfg, **model):
    """The default config with the unfreeze every epoch (``unfreeze_timer=1``,
    the backbone's own timer 1 for the single runs), ``model`` fields on
    every model config."""
    return cfg.replace(
        unfreeze_timer=1, foundation_model_unfreeze_timer=1,
        **{f"{m}_model": dataclasses.replace(getattr(cfg, f"{m}_model"), **model)
           for m in ("dwi", "dce", "fusion")})


def fusion_batches(fcfg, n, b, seed):
    """``n`` processed fusion batches of ``b`` volumes on the card: z-scored
    DWI-like and [0, 1] DCE-like inputs at 256^2, masks at the mask head's
    size, labels."""
    S = fcfg.dwi_model.input_size
    m = fcfg.fusion_model.mask.mask_target_size[0]
    g = gen(seed)
    return [{"dwi": torch.randn(b, S, S, fcfg.dwi_channel_num, device=DEV, generator=g),
             "dce": torch.rand(b, S, S, fcfg.dce_channel_num, device=DEV, generator=g),
             "masks": (torch.rand(b, m, m, 1, device=DEV, generator=g) > 0.8).float(),
             "labels": torch.arange(i, i + b, device=DEV) % fcfg.class_num}
            for i in range(n)]


def phase_fusion_parity(cfg):
    log(f"== phase 7c: fusion train-step parity, card vs CPU: the default models at full width "
        f"(two ResNet-50 encoders + the fusion head, 256^2, fp32, TF32 off), "
        f"B={B_FUSION_PARITY}, dropout 0, {FUSION_PARITY_STEPS} steps with the encoders frozen "
        f"then {FUSION_PARITY_STEPS} after group 2's unfreeze, the same batches")
    fcfg = fusion_config(cfg, dropout=0.0)
    cpu_net = FusionNetwork(*build_fusion_models(fcfg, "cpu",
                                                 generator=torch.Generator().manual_seed(SEED)))
    nets = {"card": copy.deepcopy(cpu_net).to(DEV).to(memory_format=torch.channels_last),
            "cpu": cpu_net,
            "cpu channels_last": copy.deepcopy(cpu_net).to(memory_format=torch.channels_last)}
    init = {n: p.detach().clone() for n, p in cpu_net.named_parameters()}
    spec = build_fusion_group_spec(list(init), fcfg)
    clf = get_classification_loss_fn(fcfg, np.arange(fcfg.class_num), "fusion")
    step = make_fusion_train_step(fcfg, clf, get_mask_loss_fn(fcfg, "fusion"), spec)
    states = {k: TrainState.create(m, num_groups=4) for k, m in nets.items()}
    batches = fusion_batches(fcfg, 2 * FUSION_PARITY_STEPS, B_FUSION_PARITY, 51)
    ctrl = FusionOptController(fcfg)
    step_launches = dict.fromkeys(COUNTERS, 0)
    for i, batch in enumerate(batches):
        epoch = i // FUSION_PARITY_STEPS
        if i % FUSION_PARITY_STEPS == 0:
            ctrl.on_epoch_start(epoch)
            hp = ctrl.hyperparams()
        aux_w = aux_loss_weight(epoch, fcfg.aux_loss_weight_epoch_limit)
        metrics = {}
        for k, state in states.items():
            dev_batch = batch if k == "card" else {n: v.cpu() for n, v in batch.items()}
            reset_counts()
            t0 = time.perf_counter()
            metrics[k] = {n: float(v) for n, v in
                          step(state, dict(dev_batch, aux_w=aux_w), None, hp).items()}
            dt = time.perf_counter() - t0
            if k == "card":
                step_launches = {c: step_launches[c] + v for c, v in counts().items()}
            else:
                log(f"  step {i} on the {k}: {dt:.1f} s")
        rel = {n: abs(metrics["card"][n] - metrics["cpu"][n]) / abs(metrics["cpu"][n])
               for n in FUSION_LOSSES}
        log(f"  step {i} (trainable groups {hp.trainable.tolist()}, aux_w {aux_w:.4f}): "
            + ", ".join(f"{n} card {metrics['card'][n]:.6f} CPU {metrics['cpu'][n]:.6f} rel "
                        f"{rel[n]:.2e}" for n in FUSION_LOSSES)
            + f" (tolerance {TRAIN_LOSS_RTOL:.0e}; CPU channels_last loss "
            f"{metrics['cpu channels_last']['loss']:.6f}); grad norms card "
            f"{metrics['card']['grad_norm']:.5f} CPU {metrics['cpu']['grad_norm']:.5f}")
        if not all(r <= TRAIN_LOSS_RTOL for r in rel.values()):
            raise AssertionError(f"fusion train step {i}: card losses off the CPU's: {rel}")
        if i == FUSION_PARITY_STEPS - 1:  # the encoders untouched on every device
            for net in nets.values():
                for n, p in net.named_parameters():
                    if spec.group_ids[n] in (0, 1, 2) and not torch.equal(p.detach().cpu(),
                                                                          init[n]):
                        raise AssertionError(f"frozen parameter {n} changed")
            log("  after the frozen steps: every encoder parameter of groups 0-2 bit-equal to "
                "its initial value in every run")
    log(f"  launches in the {len(batches)} card train steps: {step_launches}")
    if step_launches != dict.fromkeys(COUNTERS, 0):
        raise AssertionError(f"fusion train steps launched kernels: {step_launches}")
    card = disagreement(nets["card"], cpu_net, init, spec)
    floor = disagreement(nets["cpu channels_last"], cpu_net, init, spec)
    for g in card:
        what = ("BatchNorm running statistics (max err over max(1, max|CPU|))" if g == "stats"
                else f"group {spec.names[g] if g >= 0 else 'excluded (classification heads)'} "
                     f"(difference over the update, L2)")
        tol = 0.0 if g == -1 else max(TRAIN_FLOOR, FUSION_FLOOR_MARGIN * floor[g])
        log(f"  {what}: card vs CPU {card[g]:.3e}, CPU channels_last vs CPU {floor[g]:.3e} "
            f"(tolerance {tol:.3e})")
        if not card[g] <= tol:
            raise AssertionError(f"{what}: card off the CPU by {card[g]}, above {tol}")
    del states, nets, cpu_net, batches
    torch.cuda.empty_cache()


def snapshot_model(model):
    return {k: t.detach().clone() for k, t in model.state_dict().items()}


def phase_fold(cfg, raw, tmp, dwi_out, rcfg0):
    B = cfg.batch_size
    log(f"== phase 7d: the fold end to end on the card, the default models at full width "
        f"(256^2, fp32, TF32 off), B={B}: run_single_model('dce') for {RUN_EPOCHS} epochs beside "
        f"7b's DWI run, then run_fusion_model over both for {FUSION_EPOCHS} epochs with "
        f"unfreeze_timer=1, test in {cfg.test_mode}")
    store = {"imgs": raw["dce"][:RUN_TRAIN], "test_imgs": raw["dce_test"][:RUN_TEST],
             "labels": raw["labels"][:RUN_TRAIN], "test_labels": raw["labels_test"][:RUN_TEST],
             "masks": raw["masks"][:RUN_TRAIN]}
    fcfg = rcfg0.replace(unfreeze_timer=1)
    (data, (model, dcfg)), t_prep = synced(lambda: (
        prepare_single_data(fcfg, "dce", 0, raw=store, device=DEV),
        build_single_model(fcfg, "dce", device=DEV, generator=gen(SEED + 2))))
    reset_counts()
    dce_out, t_dce = synced(lambda: run_single_model(
        dcfg, "dce", 0, data=data, state=TrainState.create(model), num_epochs=RUN_EPOCHS,
        min_epochs=RUN_EPOCHS, base_dir=os.path.join(tmp, "results"), device=DEV))
    dce_launched = counts()
    n_va = len(data.splits["val"]["labels"])
    n_val, n_test = -(-n_va // B), -(-RUN_TEST // B)
    step_ms = [s_ for _, s_ in dce_out["step_ms"][1:]]
    log(f"  DCE: prepare {t_prep:.2f} s (the Nyul fit on the host), run {t_dce:.2f} s; train "
        f"steps median {statistics.median(step_ms):.2f} ms after the first; epochs "
        + ", ".join(f"{h['epoch_time']:.3f} s (val acc {h['val_acc']:.4f})"
                    for h in dce_out["history"])
        + f"; launches {dce_launched}")
    n_eval = RUN_EPOCHS * n_val + drawn(RUN_EPOCHS)
    expect = dict.fromkeys(COUNTERS, 0) | {
        "se_epilogue": 3 * n_eval + 6 * n_test, "keep_mask": 6 * n_test,
        "conv3x3_bn_gelu": 6 * (n_eval + n_test),
        "se_scale": n_eval + n_test}
    if dce_launched != expect or [h["group_trainable"][0] for h in dce_out["history"]] != [0, 1]:
        raise AssertionError(f"DCE run launched {dce_launched} (expected {expect}) or its "
                             f"backbone was not frozen then trained")
    if not all(all_finite(h) for h in dce_out["history"]) or not all_finite(
            dce_out["test_metrics"]):
        raise AssertionError("a DCE metric is not finite")

    singles = {"dwi": dwi_out["state"].model, "dce": dce_out["state"].model}
    before = {m: snapshot_model(net) for m, net in singles.items()}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    fus, t_run = synced(lambda: run_fusion_model(
        fcfg, 0, dwi_out, dce_out, num_epochs=FUSION_EPOCHS, min_epochs=FUSION_EPOCHS,
        base_dir=os.path.join(tmp, "results")))
    launched = counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    fdata = prepare_fusion_data(fcfg, 0)
    n_tr = len(fdata["train"]["labels"])
    n_steps = -(-n_tr // B)
    log(f"  fusion: train {n_tr} ({n_steps} steps an epoch), validation {n_va}, test "
        f"{RUN_TEST}; run {t_run:.2f} s; peak memory {peak:.2f} GiB")
    hist = fus["history"]
    for e, h in enumerate(hist):
        log(f"  epoch {e}: train {h['train_time']:.3f} s, validation "
            f"{h['epoch_time'] - h['train_time']:.3f} s, epoch {h['epoch_time']:.3f} s; train "
            f"loss {h['train_loss']:.5f} (mimic {h['train_mimic_loss']:.5f}), val loss "
            f"{h['val_loss']:.5f}, val acc {h['val_acc']:.4f}; group lrs "
            f"{[float(f'{x:.3g}') for x in h['group_lrs']]}, trainable {h['group_trainable']}")
    steps = [s_ for _, s_ in fus["step_ms"]]
    full = [t for i, t in enumerate(steps) if i and (i % n_steps < n_steps - 1 or n_tr % B == 0)]
    med = statistics.median(full)
    log(f"  fusion train steps by CUDA events (ms): {', '.join(f'{t:.2f}' for t in steps)}; "
        f"median of the {len(full)} full batches after the first {med:.2f} ms "
        f"({min(full):.2f}-{max(full):.2f}), {1e3 / med:.3f} steps/s, {B * 1e3 / med:.2f} "
        f"volumes/s")
    log(f"  test metrics {json.dumps({k: round(v, 5) for k, v in fus['test_metrics'].items()})}")
    if [h["group_trainable"] for h in hist] != [[0, 0, 0, 1], [0, 0, 1, 1], [0, 1, 1, 1]]:
        raise AssertionError("the encoder groups were not unfrozen deep to shallow")
    if not all(all_finite(h) for h in hist) or not all_finite(fus["test_metrics"]):
        raise AssertionError("a fusion metric is not finite")
    expect = dict.fromkeys(COUNTERS, 0) | {
        k: FUSION_VAL[k] * (FUSION_EPOCHS * n_val + drawn(FUSION_EPOCHS))
        + FUSION_TEST[k] * n_test for k in FUSION_VAL}
    log(f"  launches of the fusion run {launched}")
    if launched != expect:
        raise AssertionError(f"fusion run launched {launched}, expected {expect}")
    for m, net in singles.items():
        after = net.state_dict()
        if not all(torch.equal(after[k], t) for k, t in before[m].items()):
            raise AssertionError(f"run_fusion_model changed the {m} result's state")
    log("  both single-model states bit-equal to theirs before the fusion run")
    root = os.path.join(tmp, "results", "fusion", "fold_0")
    for rel in ("metrics.json", "checkpoints/best.pt", f"checkpoints/fusion_fold0.pt"):
        if not os.path.exists(os.path.join(root, rel)):
            raise AssertionError(f"{rel} not written")
    probs, std = fus["test_probs"], fus["test_std"]
    if not (np.abs(probs.sum(-1) - 1) <= 1e-3).all() or not (std > 0).all():
        raise AssertionError("test probabilities do not sum to 1, or an MC std is 0")
    log(f"  test: probabilities finite and summing to 1, MC std > 0 (mean {std.mean():.5f}); "
        f"modality attention {fus['modality_attention'].round(4).tolist()}")
    # the best checkpoint reloaded into a network of other weights
    fresh = build_fusion_state(fcfg, dwi_out["state"], dce_out["state"],
                               generator=gen(SEED + 3))
    load_checkpoint(fus["best_checkpoint"], fresh)
    batch = {k: torch.as_tensor(v[:B], device=DEV) for k, v in fdata["val"].items()}
    with torch.no_grad():
        a = fresh.model(to_model(batch["dwi"], fresh.model), to_model(batch["dce"], fresh.model),
                        lean_encoders=True)[0]
        b = fus["state"].model(to_model(batch["dwi"], fresh.model),
                               to_model(batch["dce"], fresh.model), lean_encoders=True)[0]
    err = (a - b).abs().max().item()
    log(f"  best checkpoint reloaded: eval logits max_abs_err {err:.3e} against the best "
        f"state's (tolerance 0: {'bit-equal' if err == 0 else 'NOT bit-equal'})")
    if err != 0:
        raise AssertionError("reloaded fusion checkpoint gives other logits")
    # launches per validation batch and per test batch, and the test timed again
    clf = get_classification_loss_fn(fcfg, fdata["train"]["labels"], "fusion")
    evaluate = make_fusion_eval_step(fcfg, clf, get_mask_loss_fn(fcfg, "fusion"))
    reset_counts()
    evaluate(fus["state"], batch)
    val_launches = counts()
    reset_counts()
    res, t_test = synced(lambda: test_fusion_model(fcfg, fus["state"], fdata["test"], seed=1))
    test_launches = counts()
    log(f"  launches per validation batch {val_launches}; per tta_mc test batch "
        f"{test_launches}; test_fusion_model again {t_test:.3f} s for {RUN_TEST} volumes "
        f"({RUN_TEST / t_test:.2f} volumes/s)")
    if (val_launches != dict.fromkeys(COUNTERS, 0) | FUSION_VAL
            or test_launches != dict.fromkeys(COUNTERS, 0) | FUSION_TEST):
        raise AssertionError(f"eval launches {val_launches} / {test_launches}")
    # one more train step under the profiler, on the final state
    state = fus["final_state"]
    spec = build_fusion_group_spec([n for n, _ in state.model.named_parameters()], fcfg)
    step = make_fusion_train_step(fcfg, clf, get_mask_loss_fn(fcfg, "fusion"), spec)
    ctrl = FusionOptController(fcfg)
    for e in range(FUSION_EPOCHS):
        ctrl.on_epoch_start(e)
    hp = ctrl.hyperparams()
    batch = {k: torch.as_tensor(v[:B], device=DEV) for k, v in fdata["train"].items()}
    batch["aux_w"] = 1.0
    step(state, batch, gen(45), hp)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, dt = synced(lambda: step(state, batch, gen(45), hp))
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total = sum(e.self_device_time_total for e in events) / 1e3
    idle = (f"{100 * (1 - total / (dt * 1e3)):.1f} % idle" if total > 0
            else "device time not measured: the profiler recorded no kernel")
    log(f"  one fusion train step under the profiler: {dt * 1e3:.2f} ms, device time "
        f"{total:.2f} ms ({idle}); top device kernels:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x  {e.key[:90]}")
    del fus, res, state, fresh, dce_out, data, model, fdata, batch
    torch.cuda.empty_cache()
    return {k: launched[k] + dce_launched[k] for k in COUNTERS}


# ------------------------------------------------------------------ phase 8
# the command line on the card: 7b's volumes as a tensor store, one epoch a
# stage (the backbone frozen throughout: foundation_model_unfreeze_timer=2)
CLI_EPOCHS = 1
RASOOL_STAGES = {"conv1.": "0.", "bn1.": "1.", "layer1.": "4.", "layer2.": "5.",
                 "layer3.": "6.", "layer4.": "7."}


def seeded_resnet(deep_stem, seed):
    """A timm-layout ResNet-50 (resnet50d with ``deep_stem``) state dict for 3
    input channels on seeded random weights and BatchNorm statistics, with
    timm's 1000-class ``fc`` head."""
    g = torch.Generator().manual_seed(seed)
    net = ResNetFeatures(3, deep_stem=deep_stem, avg_down=deep_stem)
    init_weights(net, g)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    sd = dict(net.state_dict())
    sd["fc.weight"] = torch.randn(1000, 2048, generator=g) * 0.02
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def rasool_layout(sd):
    """The Lab-Rasool layout: a ``backbone.`` prefix, the stem as ``0.``/``1.``,
    the stages as ``4.``-``7.``, and the ``fc.`` head."""
    out = {}
    for k, v in sd.items():
        for timm, rasool in RASOOL_STAGES.items():
            if k.startswith(timm):
                k = rasool + k[len(timm):]
                break
        out["backbone." + k] = v
    return out


def bit_equal(name, got, ref):
    """Every tensor of ``ref`` (CPU) equal, bit for bit, to ``got``'s."""
    bad = [k for k, v in ref.items() if not torch.equal(got[k].detach().cpu(), v)]
    if sorted(got) != sorted(ref) or bad:
        raise AssertionError(f"{name}: {len(bad)} tensors differ (first {bad[:3]}) or the "
                             f"key sets differ")
    log(f"  {name}: {len(ref)} tensors bit-equal")


class Spy:
    """Wraps a pipeline function the CLI looks up at call time: records each
    call's result and wall seconds (to a synchronize)."""

    def __init__(self, module, name):
        self.module, self.name, self.fn = module, name, getattr(module, name)
        self.calls = []

    def __enter__(self):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            out = self.fn(*a, **kw)
            torch.cuda.synchronize()
            self.calls.append((out, time.perf_counter() - t0))
            return out

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def decode_png(path):
    """``(height, width, title)`` of an 8-bit grayscale PNG, its rows
    decompressed with ``zlib`` and checked against its header."""
    import struct
    import zlib

    data = open(path, "rb").read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    pos, chunks = 8, {}
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        chunks.setdefault(data[pos + 4:pos + 8], b"")
        chunks[data[pos + 4:pos + 8]] += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    if (depth, color) != (8, 0) or len(zlib.decompress(chunks[b"IDAT"])) != h * (w + 1):
        raise AssertionError(f"{path}: not an 8-bit gray image of {h} x {w}")
    return h, w, chunks.get(b"tEXt", b"").split(b"\x00", 1)[-1].decode("latin-1")


def cli_fold(argv, root, results, ccfg, imports, smi):
    """``cli.main(argv)``, a ``run --fusion`` of fold 0 for CLI_EPOCHS epochs a
    stage with the backbone frozen, in-process: the stage wall seconds, the
    peak memory, a finite three-stage summary, each ``metrics.json``, both
    single runs' backbones (final and best state) bit-equal to ``imports``,
    and the launches by 7b's and 7d's formulas (counts set to 0 just before
    the run and read just after).  Returns the launches and the stages'
    results."""
    log("  cli.main: " + " ".join(a.replace(root, "<tmp>") for a in argv))
    torch.cuda.reset_peak_memory_stats()
    text = io.StringIO()
    reset_counts()
    with Spy(run_single_mod, "run_single_model") as singles, \
            Spy(run_fusion_mod, "run_fusion_model") as fusions, \
            contextlib.redirect_stdout(text):
        rc = cli.main(argv)
    launched = counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    text = text.getvalue()
    if rc != 0:
        raise AssertionError(f"cli run returned {rc}")
    summary = json.loads(text[text.rindex("\n{\n") + 1:])
    (dwi_out, t_dwi), (dce_out, t_dce) = singles.calls
    (fus_out, t_fus), = fusions.calls
    log(f"  stages (wall s, prepare and test included): DWI {t_dwi:.2f}, DCE {t_dce:.2f}, "
        f"fusion {t_fus:.2f}; peak memory {peak:.2f} GiB; {smi}")
    for key, metrics in summary.items():
        log(f"  summary {key}: {json.dumps({k: round(v, 5) for k, v in metrics.items()})}")
    if sorted(summary) != ["fold0_dce", "fold0_dwi", "fold0_fusion"] or not all(
            all_finite(m) for m in summary.values()):
        raise AssertionError(f"summary {sorted(summary)} incomplete or not finite")
    for stage in ("dwi", "dce", "fusion"):
        if not os.path.exists(os.path.join(results, stage, "fold_0", "metrics.json")):
            raise AssertionError(f"{stage} metrics.json not written")
    # one mask triptych a stage, at epoch 0 (viz_every 10)
    shapes = {}
    for stage in ("dwi", "dce", "fusion"):
        viz = os.path.join(results, stage, "fold_0", "viz")
        names = sorted(os.listdir(viz)) if os.path.isdir(viz) else []
        if names != [f"epoch_{e:04d}.png" for e in range(0, CLI_EPOCHS, VIZ_EVERY)]:
            raise AssertionError(f"{stage}: triptychs {names}")
        shapes[stage] = decode_png(os.path.join(viz, names[0]))
    log(f"  mask triptychs: one a stage at epoch 0, decoded (height, width, title): {shapes}")
    # the backbone stayed frozen for both epochs: its parameters are the import
    for method, out in (("dwi", dwi_out), ("dce", dce_out)):
        if [h["group_trainable"][0] for h in out["history"]] != [0.0] * CLI_EPOCHS:
            raise AssertionError(f"{method}: the backbone group was trained")
        for which in ("final_state", "state"):
            params = dict(out[which].model.backbone.named_parameters())
            bit_equal(f"{method} {which} backbone parameters against the import",
                      params, {k: imports[method][k] for k in params})
    # launches by 7b's and 7d's formulas
    B = ccfg.batch_size
    n_tr = len(dwi_out["data"].splits["train"]["labels"])
    n_va = len(dwi_out["data"].splits["val"]["labels"])
    n_steps, n_val, n_test = -(-n_tr // B), -(-n_va // B), -(-RUN_TEST // B)
    n_eval = CLI_EPOCHS * n_val + drawn(CLI_EPOCHS)
    single = {"se_epilogue": 3 * n_eval + 6 * n_test, "keep_mask": 6 * n_test,
              "conv3x3_bn_gelu": 6 * (n_eval + n_test),
              "se_scale": n_eval + n_test}
    expect = dict.fromkeys(COUNTERS, 0) | {
        k: 2 * single[k] + FUSION_VAL[k] * n_eval + FUSION_TEST[k] * n_test
        for k in single} | {"dwi_normalize": CLI_EPOCHS * n_steps + 2 + 3}
    log(f"  launches of the run {launched}")
    if launched != expect:
        raise AssertionError(f"cli run launched {launched}, expected {expect}")
    return launched, dwi_out, dce_out, fus_out


def phase_cli(cfg, raw, tmp, smi):
    t_phase = time.perf_counter()
    root = os.path.join(tmp, "cli")
    base, results = os.path.join(root, "data"), os.path.join(root, "results")
    os.makedirs(base)
    log(f"== phase 8: python -m dmf_tpu_torch.cli on the card: run --fusion (fold 0, "
        f"{CLI_EPOCHS} epochs a stage) on a tensor store of {RUN_TRAIN} + {RUN_TEST} "
        f"volumes of {IMAGE}^2, the default config at full width (ResNet-50, fp32, TF32 "
        f"off, B={cfg.batch_size}) with RadImageNet-layout backbones from a seeded "
        f"checkpoint; export-ckpt; debug-suite")
    t0 = time.perf_counter()
    for m in ("dwi", "dce"):
        np.savez(os.path.join(base, f"{m}_tensordata.npz"), imgs=raw[m],
                 test_imgs=raw[f"{m}_test"], labels=raw["labels"],
                 test_labels=raw["labels_test"], masks=raw["masks"])
    rasool = os.path.join(root, "radimagenet_resnet50.pt")
    torch.save({"state_dict": rasool_layout(seeded_resnet(False, SEED + 80))}, rasool)
    r50d = os.path.join(root, "resnet50d.pth")
    torch.save(seeded_resnet(True, SEED + 81), r50d)
    ccfg = cfg.replace(foundation_model_unfreeze_timer=2)
    config = os.path.join(root, "config.json")
    ccfg.save(config)
    log(f"  tensor store, two checkpoints and the config written in "
        f"{time.perf_counter() - t0:.2f} s")

    # the imports on the host, then build_single_model on the card at 14 and 6 channels
    imports = {}
    for method in ("dwi", "dce"):
        mc, ch = ccfg.model_config(method), ccfg.channel_num(method)
        t0 = time.perf_counter()
        imports[method] = pretrained_state_dict(mc, ch, rasool)
        t_imp = time.perf_counter() - t0
        direct = import_resnet50(map_rasool_to_timm_keys(
            torch.load(rasool, weights_only=True)["state_dict"]), ch,
            use_advanced_adapt=resolve_backbone_config(mc).use_advanced_adapt)
        bit_equal(f"RadImageNet import at {ch} channels (host {t_imp:.3f} s) against "
                  f"import_resnet50", imports[method], direct)
        model, _ = build_single_model(ccfg, method, pretrained_path=rasool, device=DEV)
        bit_equal(f"build_single_model('{method}', pretrained_path=) backbone on the card",
                  model.backbone.state_dict(), imports[method])
        del model
    mc_d = dataclasses.replace(ccfg.dwi_model, backbone_str="resnet50d")
    t0 = time.perf_counter()
    sd_d = pretrained_state_dict(mc_d, 14, r50d)
    t_imp = time.perf_counter() - t0
    net = build_backbone(mc_d, 14, pretrained_path=r50d, device=DEV)
    bit_equal(f"resnet50d through build_backbone on the card (import host {t_imp:.3f} s)",
              net.state_dict(), sd_d)
    del net, sd_d
    torch.cuda.empty_cache()

    argv = ["run", "--config", config, "--base-path", base, "--results-dir", results,
            "--folds", "0", "--fusion", "--epochs", str(CLI_EPOCHS), "--min-epochs",
            str(CLI_EPOCHS), "--pretrained-dwi", rasool, "--pretrained-dce", rasool]
    launched, dwi_out, dce_out, fus_out = cli_fold(argv, root, results, ccfg, imports, smi)

    # export-ckpt (each file then loaded strictly into a fresh model) and
    # export-serving (phase 11 serves the artifact), each in its own process,
    # the two at once
    best = os.path.join(results, "fusion", "fold_0", "checkpoints", "best.pt")
    stem = os.path.join(root, "fold0.ckpt")
    del dwi_out, dce_out
    torch.cuda.empty_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    cli_run = [sys.executable, "-m", "dmf_tpu_torch.cli"]
    commands = {
        "export-ckpt --method fusion": cli_run + [
            "export-ckpt", "--config", config, "--base-path", base, "--method", "fusion",
            "--checkpoint", best, "--out", stem],
        f"export-serving --mode tta_mc --batch {B_SERVE}": cli_run + [
            "export-serving", "--config", config, "--base-path", base, "--checkpoint", best,
            "--mode", "tta_mc", "--batch", str(B_SERVE), "--out",
            os.path.join(root, f"fold0_tta_mc_b{B_SERVE}.pt2")]}
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        runs = {}
        for name, cmd in commands.items():
            out, err = (stack.enter_context(tempfile.TemporaryFile("w+")) for _ in range(2))
            runs[name] = (stack.enter_context(subprocess.Popen(
                cmd, cwd=here, env=dict(os.environ, PYTHONPATH=here), stdout=out,
                stderr=err)), out, err)
        try:
            for name, (proc, out, err) in runs.items():
                if proc.wait(timeout=600) != 0:
                    err.seek(0)
                    raise AssertionError(f"{name} exited {proc.returncode}: "
                                         f"{err.read()[-2000:]}")
                out.seek(0)
                text = out.read().replace(root, "<tmp>").strip()
                log(f"  {name}: {time.perf_counter() - t0:.2f} s in its own process (the "
                    f"two at once); {'; '.join(text.splitlines())}")
        except BaseException:
            for proc, _, _ in runs.values():
                proc.kill()
            raise
    dwi_m, _ = build_single_model(ccfg, "dwi", device=DEV, generator=gen(SEED + 5))
    dce_m, _ = build_single_model(ccfg, "dce", device=DEV, generator=gen(SEED + 6))
    fresh = build_fusion_state(ccfg, TrainState.create(dwi_m), TrainState.create(dce_m),
                               generator=gen(SEED + 7)).model
    trained = fus_out["state"].model
    for part in ("dwi", "dce", "fusion"):
        report = load_reference_state_dict(getattr(fresh, part),
                                           load_lightning_ckpt(f"{root}/fold0_{part}.ckpt"))
        bit_equal(f"fold0_{part}.ckpt loaded strictly ({len(report['dropped'])} reference "
                  f"slots dropped) against the trained {part}",
                  getattr(fresh, part).state_dict(),
                  {k: v.detach().cpu() for k, v in getattr(trained, part).state_dict().items()})
    del fus_out, fresh, trained, dwi_m, dce_m
    torch.cuda.empty_cache()

    # debug-suite on the card (kernels 1 and 6 at 8-32 channels)
    text = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(text):
        rc = cli.main(["debug-suite", "--config", config, "--fusion"])
    dbg_launched = counts()
    text = text.getvalue()
    log(f"  debug-suite --fusion on the card: exit {rc}, {text.count('ALL PASS')} suites "
        f"passed, launches {dbg_launched}")
    if rc != 0 or text.count("ALL PASS") != 3:
        raise AssertionError("debug-suite failed on the card:\n" + text)
    if not (dbg_launched["se_epilogue"] > 0 and dbg_launched["se_scale"] > 0):
        raise AssertionError("debug-suite did not launch kernels 1 and 6")
    # its models with dropout off: the MC outputs on the card against the CPU's
    # plain route (the same weights: the suite draws them on the host)
    dcfg = ccfg.replace(**{f"{m}_model": dataclasses.replace(ccfg.model_config(m), dropout=0.0)
                           for m in ("dwi", "dce", "fusion")})
    rng = np.random.RandomState(SEED)
    S = 64
    xs = {m: torch.as_tensor(rng.rand(4, S, S, dcfg.channel_num(m)).astype(np.float32))
          for m in ("dwi", "dce")}
    outs = {}
    for dev in ("cpu", DEV):
        dwi, dce, fusion = debug_suite.debug_fusion_models(dcfg, 0, dev)
        g = torch.Generator(dev).manual_seed(3)
        outs[str(dev)] = (
            make_single_predictor(dcfg, dwi, mode="mc", mc_passes=8)(xs["dwi"].to(dev), g)[:2],
            make_single_predictor(dcfg, dce, mode="mc", mc_passes=8)(xs["dce"].to(dev), g)[:2],
            make_fusion_predictor(dcfg, dwi, dce, fusion, mode="tta_mc", mc_passes=4)(
                xs["dwi"].to(dev), xs["dce"].to(dev), g)[:2])
    for name, (cpu, card) in zip(("dwi mc", "dce mc", "fusion tta_mc"),
                                 zip(outs["cpu"], outs[str(DEV)])):
        check(f"debug {name} mean, card vs CPU, dropout off", card[0].cpu(), cpu[0],
              torch.float32)
        check(f"debug {name} std, card vs CPU, dropout off", card[1].cpu(), cpu[1],
              torch.float32)
    torch.cuda.empty_cache()
    log(f"  phase 8: {time.perf_counter() - t_phase:.1f} s")
    return {k: launched[k] + dbg_launched[k] for k in COUNTERS}


# ------------------------------------------------------------------ phase 9
VIT_NAME = "dino_vitbase16_pretrain"
# the ViT-backed encoders at 256^2: 16^2 token maps of 768 channels, chained
# [0-2] / [3-6] / [7-11] into the necks (Cin, Cout, side), channels (768, 768,
# 768) and no block downsampling (config.py's backbone-derived fields)
VIT_NECKS = (("neck_f1_conv0", 2304, 768, 16), ("neck_f1_conv1", 768, 768, 16),
             ("neck_f2_conv0", 3072, 768, 16), ("neck_f2_conv1", 768, 768, 16),
             ("neck_f3_conv0", 3840, 768, 16), ("neck_f3_conv1", 768, 768, 16))
VIT_EPI = (768, 16)  # kernel 1's maps: C and side


def vit_config(cfg):
    """The default config with the DINO ViT-B/16 backbone for both encoders,
    at full width (768 wide, 12 blocks, 12 heads, 256^2 inputs)."""
    return cfg.replace(**{f"{m}_model": dataclasses.replace(cfg.model_config(m),
                                                            backbone_str=VIT_NAME)
                          for m in ("dwi", "dce")})


def seeded_vit(seed):
    """A timm-layout ViT-B/16 state dict for 3 input channels on the 224 grid
    (pos_embed 1 + 14^2), seeded with the JAX module's initialisers, with
    timm's final norm and 1000-class head."""
    g = torch.Generator().manual_seed(seed)
    net = ViTFeatures(3, 224)
    net.reset_parameters(g)
    sd = dict(net.state_dict())
    sd["norm.weight"], sd["norm.bias"] = torch.ones(768), torch.zeros(768)
    sd["head.weight"] = torch.randn(1000, 768, generator=g) * 0.02
    sd["head.bias"] = torch.zeros(1000)
    return sd


def phase_vit_kernels(cfg):
    """9a: kernels 2 and 1 at the ViT-backed models' shapes against their
    plain versions (a tta_mc request at B=8: the prefix's necks on 4 x 8
    views, the lean passes' ResLite maps; a validation batch at B=32)."""
    n_views = 4 * B_SERVE
    n_lean = (cfg.mc_passes - 1) * n_views
    c, side = VIT_EPI
    log(f"== phase 9a: kernels 2 and 1 at the ViT-B/16 encoders' shapes: the six necks "
        f"at 16^2 (Cin 2304 / 3072 / 3840 / 768 -> 768) at N={n_views} in bf16 and "
        f"N={B_VAL} in fp32; kernel 1 at {side}^2 x {c}, N={B_VAL} fp32 drop 0 and "
        f"N={n_lean} bf16 drop 0.2")
    g = gen(90)
    errs, sums = conv_bf16(n_views, g, VIT_NECKS)
    errs += conv_f64(g, VIT_NECKS[4])
    errs += conv_f32(B_VAL, g, VIT_NECKS)
    p = 0.2
    for n, dtype, drop in ((B_VAL, torch.float32, 0.0), (n_lean, torch.bfloat16, p)):
        args = epi_inputs(n, c, dtype, g, side=side)
        tag = f"kernel 1 {str(dtype)[6:]} N={n} {side}^2 x {c} drop={drop}"
        if drop:
            # the kernel's own mask: a twin generator gives its Philox seed back
            g_mc = gen(91)
            out = k1.se_epilogue(*args, drop_rate=drop, generator=g_mc)
            keep = epilogue_cuda.keep_mask(args[0], drop, epilogue_cuda.draw_seed(gen(91), DEV))
            ref = k1.se_epilogue_ref(*args, drop_rate=drop, keep=keep)
            kernel = lambda: k1.se_epilogue(*args, drop_rate=drop, generator=g_mc)  # noqa
            gp = gen(92)
            plain = lambda: k1.se_epilogue_ref(*args, drop_rate=drop, generator=gp)  # noqa
        else:
            out, ref = k1.se_epilogue(*args), k1.se_epilogue_ref(*args)
            kernel = lambda: k1.se_epilogue(*args)  # noqa: E731
            plain = lambda: k1.se_epilogue_ref(*args)  # noqa: E731
        errs.append(check(tag, out, ref, dtype))
        t_k, t_p = cuda_time(kernel), cuda_time(plain)
        b_c = 3 * args[0].numel() * args[0].element_size()
        bound = b_c / HBM_BYTES_PER_S * 1e3
        log(f"  {tag}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms (median), bound {bound:.4f} ms "
            f"(bytes, {b_c / 1e6:.1f} MB)")
        device_rate(tag, kernel, EPI_KERNELS, bound, nbytes=b_c)
        del args, out, ref
    torch.cuda.empty_cache()
    log(f"  phase 9a largest error {max(errs):.3e}; kernel 2 bf16 sums at N={n_views}: "
        f"{json.dumps({k: round(v, 4) for k, v in sums.items()})}")


def phase_serve_vit(vcfg):
    """9c: three tta_mc requests of B=8 raw volumes in bf16 through the
    ViT-backed models, the preprocessing timed apart; counts set to 0 just
    before and read just after."""
    log(f"== phase 9c: serve the ViT-backed ({VIT_NAME}) models in tta_mc, bf16, "
        f"{REQUESTS} requests of B={B_SERVE} raw volumes")
    models = build_fusion_models(vcfg, DEV, torch.bfloat16, gen(SEED + 90))
    predict = make_fusion_predictor(vcfg, *models, mode="tta_mc")
    n_suffix = 2  # the lean passes in one chunk + the full last pass
    # per request, as phase 5: 3 ResLite SE epilogues x 2 encoders per suffix,
    # 6 necks x 2 encoders in the prefix (once), modality attention x 2 in the
    # prefix and fusion_se once per suffix, the DWI z-score once
    expect = dict.fromkeys(COUNTERS, 0) | {"se_epilogue": 6 * n_suffix,
                                           "keep_mask": 6 * n_suffix,
                                           "conv3x3_bn_gelu": 12,
                                           "se_scale": 2 + n_suffix, "dwi_normalize": 1}
    log(f"  expected launches a request: se_epilogue and keep_mask 3 blocks x 2 encoders x "
        f"{n_suffix} "
        f"suffixes = {expect['se_epilogue']}, conv3x3_bn_gelu 6 necks x 2 encoders = 12, "
        f"se_scale 2 + {n_suffix} = {expect['se_scale']}, dwi_normalize 1; the ViT's "
        f"attention at N=257 tokens takes the plain route (no flash launch)")
    launched = serve("ViT tta_mc", vcfg, raw_request(vcfg, predict, gen(93), gen(94)),
                     expect, stochastic=True)
    del models, predict
    torch.cuda.empty_cache()
    return launched


def phase_vit_cli(vcfg, tmp, smi):
    """9d: seeded ViT-B/16 checkpoints in timm's layout on the 224 grid
    imported at 14 and 6 channels (the position embedding resized to 16^2),
    held bit-equal to ``build_single_model(..., pretrained_path=)`` on the
    card; then a ``run --fusion`` fold through the CLI on phase 8's tensor
    store with the backbone frozen and ``use_native_loader=True`` (the
    splits kept on the host, so that the train batches come from the native
    loader); counts set to 0 just before the run and read just after."""
    t_phase = time.perf_counter()
    root = os.path.join(tmp, "vit")
    base, results = os.path.join(tmp, "cli", "data"), os.path.join(root, "results")
    os.makedirs(root)
    log(f"== phase 9d: python -m dmf_tpu_torch.cli run --fusion with {VIT_NAME} backbones "
        f"(fold 0, {CLI_EPOCHS} epochs a stage, frozen, use_native_loader=True) on phase 8's "
        f"tensor store of {RUN_TRAIN} + {RUN_TEST} volumes of {IMAGE}^2")
    ckpt = os.path.join(root, "dino_vitb16.pth")
    torch.save({"model": seeded_vit(SEED + 95)}, ckpt)
    ccfg = vcfg.replace(foundation_model_unfreeze_timer=2, use_native_loader=True,
                        device_data=False)
    config = os.path.join(root, "config.json")
    ccfg.save(config)
    imports = {}
    for method in ("dwi", "dce"):
        mc, ch = ccfg.model_config(method), ccfg.channel_num(method)
        t0 = time.perf_counter()
        imports[method] = pretrained_state_dict(mc, ch, ckpt)
        t_imp = time.perf_counter() - t0
        direct = import_vit_base(torch.load(ckpt, weights_only=True)["model"], ch,
                                 img_size=mc.input_size,
                                 use_advanced_adapt=resolve_backbone_config(mc).use_advanced_adapt)
        bit_equal(f"ViT import at {ch} channels, pos_embed {tuple(direct['pos_embed'].shape)} "
                  f"(host {t_imp:.3f} s) against import_vit_base", imports[method], direct)
        model, _ = build_single_model(ccfg, method, pretrained_path=ckpt, device=DEV)
        bit_equal(f"build_single_model('{method}', pretrained_path=) ViT backbone on the card",
                  model.backbone.state_dict(), imports[method])
        del model
    torch.cuda.empty_cache()
    argv = ["run", "--config", config, "--base-path", base, "--results-dir", results,
            "--folds", "0", "--fusion", "--epochs", str(CLI_EPOCHS), "--min-epochs",
            str(CLI_EPOCHS), "--pretrained-dwi", ckpt, "--pretrained-dce", ckpt]
    loads = []
    real = data_pipeline.native_batches

    def counted(*a, **kw):
        loads.append(a[1])
        yield from real(*a, **kw)

    data_pipeline.native_batches = counted
    try:
        launched, dwi_out, dce_out, fus_out = cli_fold(argv, tmp, results, ccfg, imports, smi)
    finally:
        data_pipeline.native_batches = real
    if len(loads) != 3 * CLI_EPOCHS:
        raise AssertionError(f"{len(loads)} train epochs took the native loader, expected "
                             f"{3 * CLI_EPOCHS}")
    log(f"  the native loader gave the train batches of all {len(loads)} epochs "
        f"(B={loads[0]}); phase 9d {time.perf_counter() - t_phase:.1f} s")
    del dwi_out, dce_out, fus_out
    torch.cuda.empty_cache()
    return launched


def phase_vit(cfg, tmp, smi):
    """Phase 9, the ViT-backed path; returns the launches of 9c and 9d."""
    vcfg = vit_config(cfg)
    phase_vit_kernels(cfg)
    phase_parity(vcfg, title=f"9b: ViT-backed ({VIT_NAME}) end-to-end parity")
    serve_launches = phase_serve_vit(vcfg)
    cli_launches = phase_vit_cli(vcfg, tmp, smi)
    return {k: serve_launches[k] + cli_launches[k] for k in COUNTERS}


# ------------------------------------------------------------------ phase 10
# 10a: REMAT_STEPS train steps of the default DWI encoder at full width and
# B=32 with ModelConfig.remat off, on, then off again (the same weights,
# batches and dropout seed), under deterministic algorithms: the two plain
# runs bit-equal (no run-to-run floor), and the remat run bit-equal to them;
# then a fusion train step at B=32 plain and with remat on both encoders (two
# steps each, the second timed).  10b: ``run --parallel-folds`` over PF_FOLDS
# through the CLI on phase 8's store, bit-equal to the same folds run one
# after another
REMAT_STEPS = 3
PF_FOLDS = (0, 1)
PF_EPOCHS = 1


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms and torch's deterministic
    implementations (warn-only: an op without one warns).  The recon loss's
    bilinear upsample then takes torch's decomposition, whose backward
    accumulates by a sorted ``index_put`` where the kernel's adds by atomics."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = old


def tensor_gap(got, ref):
    """The largest max|got - ref| / max(1, max|ref|) over the float tensors
    of two state dicts (0.0: bit-equal)."""
    worst = 0.0
    for k, b in ref.items():
        a = got[k]
        if not torch.equal(a, b) and b.is_floating_point():
            b = b.double()
            worst = max(worst, (a.double() - b).abs().max().item()
                        / max(1.0, b.abs().max().item()))
        elif not torch.equal(a, b):
            worst = max(worst, float("inf"))
    return worst


def saved_bytes():
    """A saved-tensor hook pair that sums the bytes autograd keeps for the
    backward (outside checkpointed regions; a view counts whole)."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    return total, torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t)


def remat_run(cfg, remat, batches):
    """DWI train steps on ``batches`` from the seeded weights; returns the
    losses, the model, the dropout generator's state, the peak memory (GiB)
    and the peak above the memory held before the first step, the CUDA-event
    step times (ms), and the GiB autograd kept for the first step's
    backward."""
    model, rcfg = build_single_model(train_config(cfg, remat=remat), "dwi", device=DEV,
                                     generator=gen(SEED))
    state = TrainState.create(model)
    spec = build_group_spec([n for n, _ in model.named_parameters()], True,
                            rcfg.reference_compat)
    step = make_single_train_step(rcfg, "dwi", get_classification_loss_fn(
        rcfg, np.arange(rcfg.class_num), "dwi"), get_mask_loss_fn(rcfg, "dwi"), spec)
    ctrl = SingleModelOptController(rcfg, "dwi")
    ctrl.on_epoch_start(1)  # every group trainable
    hp = ctrl.hyperparams()
    drop = gen(SEED + 50)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    losses, ms = [], []
    kept, hooks = saved_bytes()
    for i, b in enumerate(batches):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        with hooks if i == 0 else contextlib.nullcontext():
            losses.append(step(state, dict(b, aux_w=1.0), drop, hp)["loss"])
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
    peak = torch.cuda.max_memory_allocated()
    return (torch.stack(losses).cpu(), model, drop.get_state(), peak / 2 ** 30,
            (peak - base) / 2 ** 30, ms, kept[0] / 2 ** 30)


def nondeterministic_ops(model, rcfg, batch):
    """The ops of one DWI train forward and backward that have no
    deterministic implementation on the card (torch's warn-only list)."""
    import warnings

    step = make_single_train_step(rcfg, "dwi", get_classification_loss_fn(
        rcfg, np.arange(rcfg.class_num), "dwi"), get_mask_loss_fn(rcfg, "dwi"),
        build_group_spec([n for n, _ in model.named_parameters()], True,
                         rcfg.reference_compat))
    ctrl = SingleModelOptController(rcfg, "dwi")
    ctrl.on_epoch_start(1)
    with warnings.catch_warnings(record=True) as caught, deterministic():
        warnings.simplefilter("always")
        step(TrainState.create(model), dict(batch, aux_w=1.0), gen(SEED + 53),
             ctrl.hyperparams())
        torch.cuda.synchronize()
    return sorted({str(w.message).split(" does not have a deterministic")[0]
                   for w in caught if "deterministic" in str(w.message)})


def phase_remat(cfg):
    B = cfg.batch_size
    log(f"== phase 10a: ModelConfig.remat on the card: the default DWI encoder at full width "
        f"(ResNet-50, 256^2, fp32, TF32 off), B={B}, {REMAT_STEPS} train steps plain, with "
        f"remat, plain again, from the same weights, batches and dropout seed "
        f"(dropout {cfg.dwi_model.dropout}), deterministic algorithms (cuDNN's and torch's)")
    rcfg = train_config(cfg)
    with deterministic():
        batches = dwi_batches(rcfg, REMAT_STEPS, B, 60)
        runs = {name: remat_run(cfg, remat, batches)
                for name, remat in (("plain", False), ("remat", True), ("plain again", False))}
    (l0, m0, g0, *_), (l1, m1, g1, *_), (l2, m2, g2, *_) = runs.values()
    for name, (losses, _, _, peak, above, ms, kept) in runs.items():
        log(f"  {name}: losses {[f'{x:.7f}' for x in losses.tolist()]}; step ms by CUDA "
            f"events {', '.join(f'{t:.2f}' for t in ms)} (median after the first "
            f"{statistics.median(ms[1:]):.2f}); peak memory {peak:.2f} GiB, {above:.2f} GiB "
            f"above the state and batches; autograd kept {kept:.2f} GiB for the first "
            f"step's backward")
    sd0, sd1, sd2 = (m.state_dict() for m in (m0, m1, m2))
    if not (torch.equal(l0, l2) and tensor_gap(sd2, sd0) == 0.0 and torch.equal(g0, g2)):
        ops = nondeterministic_ops(m0, rcfg.replace(dwi_model=m0.config), batches[0])
        raise AssertionError(f"two plain runs differ under deterministic algorithms (ops "
                             f"without a deterministic implementation: {ops})")
    gap = tensor_gap(sd1, sd0)
    if not (torch.equal(l0, l1) and gap == 0.0 and torch.equal(g0, g1)):
        raise AssertionError(f"remat differs from the plain steps (worst tensor {gap:.3e})")
    log(f"  remat vs plain: losses, {len(sd0)} parameters and BatchNorm statistics and the "
        f"dropout generator's state bit-equal; the two plain runs bit-equal too (no "
        f"run-to-run floor)")
    del runs, m0, m1, m2, sd0, sd1, sd2
    torch.cuda.empty_cache()
    # the same steps as a user trains them, without the deterministic algorithms
    for name, remat in (("plain", False), ("remat", True)):
        _, _, _, peak, above, ms, kept = remat_run(cfg, remat, batches)
        log(f"  {name}, default algorithms: step ms {', '.join(f'{t:.2f}' for t in ms)} "
            f"(median after the first {statistics.median(ms[1:]):.2f}); peak memory "
            f"{peak:.2f} GiB, {above:.2f} GiB above the state and batches; autograd kept "
            f"{kept:.2f} GiB")
        torch.cuda.empty_cache()
    del batches

    # fusion train steps at B=32, plain, with remat on both encoders, plain
    # again: the two plain runs bit-equal, and no op without a deterministic
    # implementation (the head's 32 -> 4 token pool is avg_pool2d)
    import warnings

    fb = fusion_batches(fusion_config(cfg), 2, B, 61)
    runs = []
    for remat in (False, True, False):
        fcfg = fusion_config(cfg, remat=remat)
        dwi, fcfg = build_single_model(fcfg, "dwi", device=DEV, generator=gen(SEED))
        dce, fcfg = build_single_model(fcfg, "dce", device=DEV, generator=gen(SEED + 2))
        state = build_fusion_state(fcfg, TrainState.create(dwi), TrainState.create(dce))
        del dwi, dce
        spec = build_fusion_group_spec([n for n, _ in state.model.named_parameters()], fcfg)
        step = make_fusion_train_step(fcfg, get_classification_loss_fn(
            fcfg, np.arange(fcfg.class_num), "fusion"), get_mask_loss_fn(fcfg, "fusion"), spec)
        ctrl = FusionOptController(fcfg)
        for e in range(FUSION_EPOCHS):
            ctrl.on_epoch_start(e)
        hp = ctrl.hyperparams()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with warnings.catch_warnings(record=True) as caught, deterministic():
            warnings.simplefilter("always")
            losses = [float(step(state, dict(b, aux_w=1.0), gen(SEED + 51), hp)["loss"])
                      for b in fb[:1]]
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            losses.append(float(step(state, dict(fb[1], aux_w=1.0), gen(SEED + 52), hp)["loss"]))
            ev[1].record()
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        nondet = sorted({str(w.message)[:160] for w in caught
                         if "deterministic" in str(w.message)})
        other = sorted({f"{w.category.__name__}: {str(w.message)[:120]}" for w in caught
                        if "deterministic" not in str(w.message)})
        log(f"  fusion train step, B={B}, {'remat on both encoders' if remat else 'plain'}: "
            f"losses {[f'{x:.6f}' for x in losses]}, the second step "
            f"{ev[0].elapsed_time(ev[1]):.2f} ms by CUDA events; peak memory "
            f"{peak / 2 ** 30:.2f} GiB ({(peak - base) / 2 ** 30:.2f} GiB above the state and "
            f"batches; phase 7d printed its whole fusion run's peak); nondeterminism warnings "
            f"{len(nondet)}" + (f"; other warnings {other}" if other else ""))
        if nondet:
            raise AssertionError(f"fusion step under deterministic algorithms: ops without a "
                                 f"deterministic implementation: {nondet}")
        if not all(np.isfinite(x) for x in losses):
            raise AssertionError("fusion remat step: loss not finite")
        runs.append((losses, {k: v.detach().clone() for k, v in state.model.state_dict().items()}))
        del state, step
        torch.cuda.empty_cache()
    (l0, sd0), (l1, sd1), (l2, sd2) = runs
    gap = tensor_gap(sd2, sd0)
    if not (l0 == l2 and gap == 0.0):
        raise AssertionError(f"two plain fusion steps differ under deterministic algorithms "
                             f"(losses {l0} / {l2}, worst tensor {gap:.3e})")
    log(f"  fusion: the two plain runs' losses and {len(sd0)} parameters and BatchNorm "
        f"statistics bit-equal, no nondeterminism warning; remat against plain: losses "
        f"{'equal' if l0 == l1 else 'differ'}, worst tensor {tensor_gap(sd1, sd0):.3e}")
    del fb, runs, sd0, sd1, sd2
    torch.cuda.empty_cache()


def read_run(results, method, fold):
    """A run's ``metrics.json`` without wall times, its best checkpoint (on
    the host) and the best checkpoint's epoch."""
    root = os.path.join(results, method, f"fold_{fold}")
    with open(os.path.join(root, "metrics.json")) as f:
        metrics = json.load(f)
    metrics["train_metrics"] = {k: v for k, v in metrics["train_metrics"].items()
                                if not k.endswith("_time")}
    best = torch.load(os.path.join(root, "checkpoints", "best.pt"), map_location="cpu",
                      weights_only=True)
    with open(os.path.join(root, "checkpoints", "best.json")) as f:
        return metrics, best, json.load(f)["epoch"]


def phase_parallel_folds(cfg, tmp, smi):
    """Phase 10b; returns the fold-parallel run's launches."""
    root = os.path.join(tmp, "cli")
    base, config = os.path.join(root, "data"), os.path.join(root, "config.json")
    rasool = os.path.join(root, "radimagenet_resnet50.pt")
    ccfg = cfg.replace(foundation_model_unfreeze_timer=2)
    folds = [str(f) for f in PF_FOLDS]
    log(f"== phase 10b: run --parallel-folds --folds {' '.join(folds)} --methods dwi dce "
        f"through the CLI on the card, phase 8's store and RadImageNet-layout checkpoint, "
        f"{PF_EPOCHS} epochs, the backbone frozen, deterministic algorithms; then the same folds "
        f"one after another")
    out = {}
    for name, extra in (("parallel", ["--parallel-folds"]), ("sequential", [])):
        results = os.path.join(root, f"results_{name}")
        argv = (["run", "--config", config, "--base-path", base, "--results-dir", results,
                 "--folds", *folds, "--methods", "dwi", "dce", "--epochs", str(PF_EPOCHS),
                 "--min-epochs", str(PF_EPOCHS), "--pretrained-dwi", rasool,
                 "--pretrained-dce", rasool] + extra)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        text = io.StringIO()
        reset_counts()
        with deterministic(), \
                Spy(run_single_mod, "run_single_model_multifold") as multi, \
                Spy(run_single_mod, "run_single_model") as single, \
                Spy(run_single_mod, "build_single_model") as builds, \
                Spy(run_single_mod, "load_raw_tensors") as loads_multi, \
                Spy(prepare_single_mod, "load_raw_tensors") as loads_single, \
                contextlib.redirect_stdout(text):
            (rc, t_run) = synced(lambda: cli.main(argv))
        launched = counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        text = text.getvalue()
        if rc != 0:
            raise AssertionError(f"cli run ({name}) returned {rc}")
        summary = json.loads(text[text.rindex("\n{\n") + 1:])
        if name == "parallel":
            per_modality = [t for _, t in multi.calls]
            results_by = {(m, f): r for m, (res, _) in zip(("dwi", "dce"), multi.calls)
                          for f, r in res.items()}
            if single.calls:
                raise AssertionError("the fold-parallel run called run_single_model")
        else:
            per_modality = [sum(t for _, t in single.calls[i::2]) for i in range(2)]
            results_by = {(m, f): r for (r, _), (f, m) in zip(
                single.calls, [(f, m) for f in PF_FOLDS for m in ("dwi", "dce")])}
            if multi.calls:
                raise AssertionError("the sequential run called run_single_model_multifold")
        loads = [t for _, t in loads_multi.calls + loads_single.calls]
        out[name] = dict(summary=summary, launched=launched, t=t_run, peak=peak,
                         per_modality=per_modality, loads=loads,
                         builds=[t for _, t in builds.calls], results=results,
                         by=results_by)
        log(f"  {name}: {t_run:.2f} s wall (DWI {per_modality[0]:.2f} s, DCE "
            f"{per_modality[1]:.2f} s, prepare and test included); peak memory {peak:.2f} GiB; "
            f"{len(loads)} raw loads ({sum(loads):.3f} s), {len(builds.calls)} model builds "
            f"({sum(out[name]['builds']):.3f} s, the import included); launches {launched}; "
            f"{smi}")
    par, seq = out["parallel"], out["sequential"]
    log(f"  the parallel path saved {len(seq['loads']) - len(par['loads'])} raw loads and "
        f"{len(seq['builds']) - len(par['builds'])} model builds: "
        f"{sum(seq['loads']) - sum(par['loads']):.3f} s and "
        f"{sum(seq['builds']) - sum(par['builds']):.3f} s")
    if par["summary"] != seq["summary"]:
        bad = [k for k in seq["summary"] if par["summary"].get(k) != seq["summary"][k]]
        log(f"  summaries differ at {bad}")
    for method in ("dwi", "dce"):
        for fold in PF_FOLDS:
            (mp, bp, ep), (ms, bs, es) = (read_run(r["results"], method, fold)
                                          for r in (par, seq))
            gap = max(tensor_gap(bp[k], bs[k]) for k in ("model", "mu", "nu"))
            if not (mp == ms and gap == 0.0 and ep == es and bp["step"] == bs["step"]
                    and torch.equal(bp["count"], bs["count"])):
                raise AssertionError(f"{method} fold {fold}: the fold-parallel run differs "
                                     f"from the sequential one (checkpoint worst tensor "
                                     f"{gap:.3e}, metrics.json equal: {mp == ms}, best epochs "
                                     f"{ep} / {es})")
            log(f"  {method} fold {fold}: metrics.json (wall times aside) equal, best "
                f"checkpoint bit-equal (best epoch {ep}, {bp['step']} steps)")
    if par["summary"] != seq["summary"]:
        raise AssertionError("the runs' summaries differ")
    log("  every fold's summary, metrics.json and best checkpoint bit-equal to the "
        "sequential run's")
    # launches by phase 8's formulas, summed over the folds
    B = ccfg.batch_size
    expect = dict.fromkeys(COUNTERS, 0)
    for (method, fold), r in par["by"].items():
        n_tr = len(r["data"].splits["train"]["labels"])
        n_val = -(-len(r["data"].splits["val"]["labels"]) // B)
        n_test = -(-len(r["data"].splits["test"]["labels"]) // B)
        n_eval = PF_EPOCHS * n_val + drawn(PF_EPOCHS)
        expect["se_epilogue"] += 3 * n_eval + 6 * n_test
        expect["keep_mask"] += 6 * n_test
        expect["conv3x3_bn_gelu"] += 6 * (n_eval + n_test)
        expect["se_scale"] += n_eval + n_test
        if method == "dwi":
            expect["dwi_normalize"] += PF_EPOCHS * -(-n_tr // B) + 2 + 3
    for name in ("parallel", "sequential"):
        if out[name]["launched"] != expect:
            raise AssertionError(f"{name} run launched {out[name]['launched']}, expected "
                                 f"{expect}")
    log(f"  launches of each run by phase 8's formulas summed over {len(PF_FOLDS)} folds: "
        f"{expect}")
    for r in (par, seq):
        r["by"].clear()
    torch.cuda.empty_cache()
    return par["launched"]


# ------------------------------------------------------------------ phase 11
# the serving artifacts: (name, config, mode, dtype, B)
ARTIFACT_REQUESTS = 3
ARTIFACT_SEEDS = (7, 7, 8)  # requests 0 and 1 share a seed
# an artifact request's kernels as the profiler names them (regular
# expressions), by operator
OPERATOR_KERNELS = {"se_epilogue": EPI_KERNELS, "keep_mask": ("keep_mask_kernel",),
                    "conv3x3_bn_gelu": ("conv3x3_bn_gelu",), "se_scale": SE_KERNELS,
                    "flash_forward": FLASH_FWD_P0, "flash_forward_dropout": FLASH_FWD_DROP}
# the operators' counts under the names of the kernels line
OPERATOR_COUNTERS = {"se_epilogue": "se_epilogue", "keep_mask": "keep_mask",
                     "conv3x3_bn_gelu": "conv3x3_bn_gelu",
                     "se_scale": "se_scale", "flash_forward": "flash_attention_fwd",
                     "flash_forward_dropout": "flash_attention_fwd_dropout"}
# a process that imports torch and the kernels' operators and nothing else of
# the package: loads each artifact, serves its requests, prints one JSON line
SERVE_CHILD = r"""
import json, sys, time
import torch
# fp32 as the parent runs it: cuDNN's default would take TF32 for fp32 convolutions
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
t0 = time.perf_counter()
from dmf_tpu_torch.ops import library
t_import = time.perf_counter() - t0
if "dmf_tpu_torch.models" in sys.modules:
    sys.exit("the serving process imported the model code")
print(json.dumps({"modules": sorted(m for m in sys.modules if m.startswith("dmf_tpu_torch")),
                  "import_s": t_import}), flush=True)
for job in json.loads(sys.argv[1]):
    t0 = time.perf_counter()
    program = torch.export.load(job["artifact"]).module()
    t_load = time.perf_counter() - t0
    inputs = torch.load(job["inputs"], map_location="cuda", weights_only=True)
    variables = inputs.get("variables")
    if variables is None:  # a fusion run's best.pt: the weights by their prefix
        variables = {"dwi": {}, "dce": {}, "fusion": {}}
        state = torch.load(job["checkpoint"], map_location="cuda", weights_only=True)
        for key, t in state["model"].items():
            part, rest = key.split(".", 1)
            variables[part][rest] = t
    library.reset_launch_counts()
    ms, host_ms, outs = [], [], []
    for seed in job["seeds"]:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        seed = torch.tensor(seed, dtype=torch.int64, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        mean, std = program(variables, inputs["dwi_x"], inputs["dce_x"], seed)
        ev[1].record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        ms.append(ev[0].elapsed_time(ev[1]))
        outs.append((mean.float().cpu().tolist(), std.float().cpu().tolist()))
    print(json.dumps({"name": job["name"], "load_s": t_load, "counts": library.launch_counts(),
                      "ms": ms, "host_ms": host_ms, "outputs": outs}), flush=True)
    del program, variables, inputs
    torch.cuda.empty_cache()
"""


def prep_nodes(ep):
    """The graph nodes between a weight placeholder and a kernel operator's
    weight arguments (the in-graph weight preparation: a cast, transpose or
    BatchNorm fold traced into the program)."""
    weights = {"se_epilogue": slice(2, 6), "conv3x3_bn_gelu": slice(1, 7),
               "se_scale": slice(1, 5)}
    found = set()
    for node in ep.graph.nodes:
        name = getattr(node.target, "name", lambda: "")()
        op = name.split("::")[-1].split(".")[0]
        if node.op == "call_function" and name.startswith("dmf::") and op in weights:
            found |= {a for a in node.args[weights[op]]
                      if hasattr(a, "op") and a.op != "placeholder"}
    return len(found)


def profiled_kernels(run, want):
    """The CUDA kernel names of one ``run()`` under the profiler that match
    each pattern of ``want`` (up to three sessions: one at times records only
    some kernels)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages() if e.device_type.name == "CUDA"}
        hits = {w: sorted(n for n in names if re.search(w, n)) for w in want}
        if all(hits.values()):
            return hits
    raise AssertionError(f"kernels {[w for w, h in hits.items() if not h]} not in the "
                         f"profile of an artifact request")


def artifact_case(name, c, mode, dtype, b, art_dir, seed_data):
    """Build, run eagerly (the seed route), export and save one artifact;
    returns its record for the serving process and the parent's checks."""
    models = build_fusion_models(c, DEV, dtype, gen(SEED))
    fn = make_serving_fn(c, *models, mode=mode)
    S = c.dwi_model.input_size
    g = gen(seed_data)
    adc_map = torch.full((S, S, 1), 0.5, device=DEV)
    dx, cx = preprocess_fusion_inputs(
        torch.rand(b, S, S, c.dwi_base_channel_num, device=DEV, generator=g) * 1000.0,
        torch.rand(b, S, S, c.dce_channel_num, device=DEV, generator=g), adc_map)
    variables = serving_variables(*models)
    args = (variables, dx, cx, torch.tensor(ARTIFACT_SEEDS[0], device=DEV))
    fn(*args)  # warm-up: cuDNN plans, prepared weights
    torch.cuda.synchronize()
    library.reset_launch_counts()
    eager = fn(*args)
    torch.cuda.synchronize()
    eager_launches = library.launch_counts()
    # the eager seed-route predictor, and the same under functional_call (the
    # weights swapped in per call, as the traced function runs it)
    predict = make_fusion_predictor(c, *models, mode=mode)
    seed = args[3] if mode in ("mc", "tta_mc") else None
    eager_ms = cuda_time(lambda: predict(dx, cx, seed), reps=1, trials=5)
    functional_ms = cuda_time(lambda: fn(*args), reps=1, trials=5)
    (ep, t_export) = synced(lambda: export_program(fn, args))
    nodes = operator_nodes(ep)
    path = os.path.join(art_dir, name.replace(" ", "_").replace("=", "") + ".pt2")
    torch.export.save(ep, path)
    inputs = os.path.join(art_dir, name.replace(" ", "_").replace("=", "") + ".inputs.pt")
    torch.save({"variables": variables, "dwi_x": dx, "dce_x": cx}, inputs)
    weight_bytes = sum(t.numel() * t.element_size() for sd in variables.values()
                       for t in sd.values())
    n_prep = prep_nodes(ep)
    log(f"  {name}: export {t_export:.2f} s, {len(ep.graph.nodes)} graph nodes, operator "
        f"nodes {nodes}, in-graph weight preparation nodes {n_prep}; artifact "
        f"{os.path.getsize(path)} bytes beside {weight_bytes} bytes of state dicts (held: "
        f"{len(ep.state_dict)} parameters or buffers, {len(ep.constants)} constants); eager "
        f"seed-route predictor {eager_ms:.3f} ms a request (CUDA events; {functional_ms:.3f} "
        f"under functional_call), launches {eager_launches}")
    if nodes != eager_launches:
        raise AssertionError(f"{name}: operator nodes {nodes} differ from the eager "
                             f"launches {eager_launches}")
    served = load_serving(path)
    want = [k for w, n in nodes.items() if n for k in OPERATOR_KERNELS[w]]
    hits = profiled_kernels(lambda: served(*args), want)
    log(f"  {name}: profiler kernel names of one artifact request: "
        + "; ".join(f"{w}: {h[0][:60]}" for w, h in hits.items()))
    del served, models, fn, ep
    return {"name": name, "artifact": path, "inputs": inputs,
            "seeds": list(ARTIFACT_SEEDS)}, {
        "dtype": dtype, "mode": mode, "b": b, "nodes": nodes, "eager": eager,
        "eager_ms": eager_ms, "class_num": c.class_num}


def operator_layer_cost():
    """Host microseconds per call of each kernel operator against its
    ``ctypes`` launch called directly, on small maps (the host bounds them),
    over 200 calls each in turns."""
    from dmf_tpu_torch.ops import conv3x3, epilogue_cuda, se_cuda
    g = gen(61)
    x = cl(torch.randn(4, 128, 8, 8, device=DEV, generator=g))
    w1, b1, w2, b2 = se_weights(128, g)
    wc = torch.randn(128, 128, 3, 3, device=DEV, generator=g) * 0.03
    bn = (torch.ones(128, device=DEV), torch.zeros(128, device=DEV),
          torch.zeros(128, device=DEV), torch.ones(128, device=DEV))
    seed = torch.tensor(3, device=DEV)
    pairs = {
        "se_epilogue": (lambda: torch.ops.dmf.se_epilogue(x, x, w1, b1, w2, b2, 0.2, seed, 0),
                        lambda: epilogue_cuda.launch_se_epilogue(x, x, w1, b1, w2, b2, 0.2,
                                                                 seed, 0)),
        "keep_mask": (lambda: torch.ops.dmf.keep_mask(x, 0.2, seed, 0),
                      lambda: epilogue_cuda.keep_mask(x, 0.2, seed, 0)),
        "conv3x3_bn_gelu": (lambda: torch.ops.dmf.conv3x3_bn_gelu(x, wc, None, *bn, 1e-5, 0),
                            lambda: conv3x3.launch_conv3x3_bn_gelu(x, wc, None, *bn, 1e-5)),
        "se_scale": (lambda: torch.ops.dmf.se_scale(x, w1, b1, w2, b2),
                     lambda: se_cuda.launch_se_scale(x, w1, b1, w2, b2))}

    def host_us(fn, calls=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        dt = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        return dt

    cost = {}
    with torch.no_grad():
        for name, (op, direct) in pairs.items():
            a1, d1 = host_us(op), host_us(direct)
            d2, a2 = host_us(direct), host_us(op)
            cost[name] = ((a1 + a2) / 2, (d1 + d2) / 2)
    return cost


def artifact_chunk_parity(cfg):
    """11: the tta_mc program in fp32 at B=1, the card's export at mc_chunk 3
    against the CPU's (unchunked), and the eager predictor (unchunked) on
    both, one seed: the same masks everywhere, the outputs within 1e-4."""
    S = cfg.dwi_model.input_size
    cpu_models, dev_models = card_and_cpu_models(cfg)
    g = torch.Generator().manual_seed(73)
    dx = torch.rand(1, S, S, cfg.dwi_channel_num, generator=g)
    cx = torch.rand(1, S, S, cfg.dce_channel_num, generator=g)
    outs, masks = {}, {}
    for where, models in (("card", dev_models), ("cpu", cpu_models)):
        dev = DEV if where == "card" else torch.device("cpu")
        a = (serving_variables(*models), dx.to(dev), cx.to(dev),
             torch.tensor(ARTIFACT_SEEDS[0], device=dev))
        chunk = 3 if where == "card" else None
        fn = make_serving_fn(cfg, *models, mode="tta_mc", mc_chunk=chunk)
        (served, t_exp) = synced(lambda: load_serving(export_serving(fn, a)))
        with recorded_masks() as (masks[f"{where} artifact"], _):
            (outs[f"{where} artifact"], t_run) = synced(lambda: served(*a))
        predict = make_fusion_predictor(cfg, *models, mode="tta_mc")
        with recorded_masks() as (masks[f"{where} eager"], _):
            (eager, t_eager) = synced(lambda: predict(a[1], a[2], a[3]))
        outs[f"{where} eager"] = eager[:2]
        log(f"  tta_mc fp32 B=1 on the {where}: export at mc_chunk {chunk} + save + load "
            f"{t_exp:.2f} s, request {t_run:.2f} s; the eager predictor (unchunked) "
            f"{t_eager:.2f} s")
    n = same_masks("tta_mc fp32 B=1", {k: masks[k] for k in (
        "card eager", "card artifact", "cpu eager", "cpu artifact")})
    log(f"  tta_mc fp32 B=1: {n} (pass, site) masks bit-equal across the card's eager "
        f"predictor (unchunked), its artifact (mc_chunk 3), the CPU's eager predictor and "
        f"its artifact (unchunked)")
    ref = {k: tuple(t.cpu() for t in v) for k, v in outs.items() if k.startswith("card")}
    compare_card_cpu((("tta_mc fp32 B=1 artifact mean, card vs CPU", outs["card artifact"][0],
                       outs["cpu artifact"][0], 1e-4),
                      ("tta_mc fp32 B=1 artifact std, card vs CPU", outs["card artifact"][1],
                       outs["cpu artifact"][1], 1e-4),
                      ("tta_mc fp32 B=1 eager mean, card vs CPU", outs["card eager"][0],
                       outs["cpu eager"][0], 1e-4),
                      ("tta_mc fp32 B=1 eager std, card vs CPU", outs["card eager"][1],
                       outs["cpu eager"][1], 1e-4),
                      ("tta_mc fp32 B=1 card mean, artifact at mc_chunk 3 vs eager",
                       outs["card artifact"][0], ref["card eager"][0], 1e-4),
                      ("tta_mc fp32 B=1 card std, artifact at mc_chunk 3 vs eager",
                       outs["card artifact"][1], ref["card eager"][1], 1e-4)))
    del cpu_models, dev_models, outs, masks, ref
    torch.cuda.empty_cache()


def phase_serving(cfg, hcfg, tmp, smi):
    """Phase 11: the serving artifacts; returns the serving process's launches."""
    t_phase = time.perf_counter()
    log(f"== phase 11: the serving artifact: export (torch.export, weights as arguments) the "
        f"default config in tta_mc bf16 and normal fp32 at B={B_SERVE} and hybrid-nb normal "
        f"bf16 at B=2; save; load and serve {ARTIFACT_REQUESTS} requests each (seeds "
        f"{ARTIFACT_SEEDS}) in a fresh process that imports torch and "
        f"dmf_tpu_torch.ops.library only, with phase 8's CLI artifact (export-serving tta_mc "
        f"B={B_SERVE} fp32 on the fold's checkpoint); the tta_mc program in fp32 at B=1 "
        f"exported on the card at mc_chunk 3 against its CPU export and the eager predictor "
        f"on both")
    art_dir = os.path.join(tmp, "serving")
    os.makedirs(art_dir)
    jobs, checks = [], {}
    for name, c, mode, dtype, b in (
            (f"tta_mc bf16 B={B_SERVE}", cfg, "tta_mc", torch.bfloat16, B_SERVE),
            (f"normal fp32 B={B_SERVE}", cfg, "normal", torch.float32, B_SERVE),
            ("hybrid-nb normal bf16 B=2", hcfg, "normal", torch.bfloat16, 2)):
        job, checks[name] = artifact_case(name, c, mode, dtype, b, art_dir, 71)
        jobs.append(job)
        torch.cuda.empty_cache()
    cli_art = os.path.join(tmp, "cli", f"fold0_tta_mc_b{B_SERVE}.pt2")
    cli_inputs = os.path.join(art_dir, "cli.inputs.pt")
    S = cfg.dwi_model.input_size
    g = gen(72)
    dx, cx = preprocess_fusion_inputs(
        torch.rand(B_SERVE, S, S, cfg.dwi_base_channel_num, device=DEV, generator=g) * 1000.0,
        torch.rand(B_SERVE, S, S, cfg.dce_channel_num, device=DEV, generator=g),
        torch.full((S, S, 1), 0.5, device=DEV))
    torch.save({"dwi_x": dx, "dce_x": cx}, cli_inputs)
    jobs.append({"name": "cli tta_mc fp32", "artifact": cli_art, "inputs": cli_inputs,
                 "checkpoint": os.path.join(tmp, "cli", "results", "fusion", "fold_0",
                                            "checkpoints", "best.pt"),
                 "seeds": list(ARTIFACT_SEEDS)})
    checks["cli tta_mc fp32"] = {"dtype": torch.float32, "mode": "tta_mc", "b": B_SERVE,
                                 "nodes": None, "eager": None, "class_num": cfg.class_num}

    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", SERVE_CHILD, json.dumps(jobs)], cwd=here,
                          env=dict(os.environ, PYTHONPATH=here), capture_output=True,
                          text=True, timeout=600)
    t_child = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"serving process exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    head, results = lines[0], {r["name"]: r for r in lines[1:]}
    log(f"  serving process: {t_child:.1f} s in all; imported "
        f"{', '.join(head['modules'])} (ops.library in {head['import_s']:.2f} s); "
        f"{smi}")
    launched = dict.fromkeys(COUNTERS, 0)
    for name, ck in checks.items():
        r = results[name]
        ms = r["ms"]
        log(f"  {name}: load {r['load_s']:.2f} s; requests by CUDA events (ms) "
            + ", ".join(f"{t:.3f}" for t in ms) + f", median after the first "
            f"{statistics.median(ms[1:]):.3f} ms ({statistics.median(r['host_ms'][1:]):.3f} ms "
            f"on the host clock)"
            + (f" against {ck['eager_ms']:.3f} ms of the eager predictor in the parent"
               if ck.get("eager_ms") else "")
            + f"; launches {r['counts']}")
        for op, n in r["counts"].items():
            if op in OPERATOR_COUNTERS:
                launched[OPERATOR_COUNTERS[op]] += n
        if ck["nodes"] is not None and r["counts"] != {
                k: ARTIFACT_REQUESTS * v for k, v in ck["nodes"].items()}:
            raise AssertionError(f"{name}: the serving process launched {r['counts']}, "
                                 f"expected {ARTIFACT_REQUESTS} x {ck['nodes']}")
        means = [torch.tensor(m) for m, _ in r["outputs"]]
        stds = [torch.tensor(sd) for _, sd in r["outputs"]]
        for mean, std in zip(means, stds):
            gate(name, cfg, {}, {}, mean, std, ck["mode"] == "tta_mc", ck["b"])
        if ck["mode"] == "tta_mc":
            if not (torch.equal(means[0], means[1]) and torch.equal(stds[0], stds[1])):
                raise AssertionError(f"{name}: one seed, two results")
            if torch.equal(means[1], means[2]):
                raise AssertionError(f"{name}: two seeds, one result")
            log(f"  {name}: seed {ARTIFACT_SEEDS[0]} twice bit-equal, seed "
                f"{ARTIFACT_SEEDS[2]} other numbers, std > 0 (mean {stds[0].mean():.5f})")
        if ck["eager"] is not None:
            tol = 1e-6 if ck["dtype"] == torch.float32 else TOL[torch.bfloat16]
            for what, got, ref in (("mean", means[0], ck["eager"][0]),
                                   ("std", stds[0], ck["eager"][1])):
                err = (got - ref.float().cpu()).abs().max().item()
                log(f"  {name}: artifact {what} against the eager seed-route predictor: "
                    f"max_abs_err {err:.3e} (tolerance {tol:.1e})")
                if not err <= tol:
                    raise AssertionError(f"{name}: artifact {what} off the eager one by {err}")

    artifact_chunk_parity(cfg)
    cost = operator_layer_cost()
    nodes = checks[f"tta_mc bf16 B={B_SERVE}"]["nodes"]
    extra_ms = sum((op - direct) * nodes[k] for k, (op, direct) in cost.items()) / 1e3
    log("  operator layer, host us per call (through torch.ops.dmf / the ctypes launch "
        "called directly, in turns): "
        + ", ".join(f"{k} {a:.1f} / {d:.1f}" for k, (a, d) in cost.items())
        + f"; a tta_mc request's {sum(nodes.values())} operator calls: {extra_ms:.3f} ms "
        f"of host time more")
    log(f"  phase 11: {time.perf_counter() - t_phase:.1f} s")
    return launched


# ------------------------------------------------------------------ phase 12
INT8_REQUESTS = 3
INT8_CALIB = 4  # preprocessed volumes of a draw apart from the requests' (bench.py:641-652)
INT8_TOP_S = 1979e12  # H100 SXM dense int8 tensor-core rate
INT8_CPU_TOL = 5e-3   # 12d: card vs CPU probabilities, fp32, dynamic scales
INT8_SOURCES = ("cp.async", "byte gather")  # csrc/int8_conv.cu ``Src``


def int8_registers():
    """``{(tile, source): "R registers, S bytes spill stores"}`` of the int8
    conv's instantiations, from ptxas's report in build.log; raises on any
    spill."""
    out, key = {}, None
    for p in sorted(BUILD_DIR.glob("int8_conv-*/build.log")):
        for line in p.read_text().splitlines():
            m = re.search(r"int8_conv_wgmmaILi(\d+)ELi(\d)E", line)
            if m:
                key = (int(m.group(1)), int(m.group(2)))
            elif key and "spill stores" in line:
                spills = [int(v) for v in re.findall(r"(\d+) bytes spill", line)]
                if any(spills):
                    raise AssertionError(f"int8 conv {key}: ptxas spills ({line.strip()})")
                out[key] = line.strip().split(",")[1].strip()
            elif key and "registers" in line:
                out[key] = line.split("Used")[1].split(",")[0].strip() + ", " + out.get(key, "")
    if len(out) != 3 * len(INT8_SOURCES):
        raise AssertionError(f"int8 conv: ptxas reported {len(out)} instantiations: {out}")
    return out


def conv_sites(predict, dx, cx, g_mc, modules):
    """The int8 convs one request runs: ``{shape: calls}`` with shape
    ``(N, Cin, H, W, O, kh, kw, stride, padding, dilation)``, and one module
    of each shape (its int8 weight, scales and bias)."""
    sites, mods, hooks = {}, {}, []

    def hook(m, args):
        n, c, h, w = args[0].shape
        key = (n, c, h, w, m.out_channels, *m.kernel_size, tuple(m.stride), tuple(m.padding),
               tuple(m.dilation))
        sites[key] = sites.get(key, 0) + 1
        mods.setdefault(key, m)

    for model in modules:
        hooks += [m.register_forward_pre_hook(hook) for m in model.modules()
                  if isinstance(m, int8q.QuantConv2d)]
    predict(dx, cx, g_mc)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    return sites, mods


def int8_conv_bound(key):
    """``(operations, bytes, bound ms)`` of one int8 conv with a bf16 output."""
    n, c, h, w, o, kh, kw, s, p, d = key
    ho = int8_cuda.conv_out_size(h, kh, s[0], p[0], d[0])
    wo = int8_cuda.conv_out_size(w, kw, s[1], p[1], d[1])
    m, k = n * ho * wo, kh * kw * c
    ops = 2 * m * o * k
    nbytes = n * h * w * c + o * k + 2 * m * o + 4 * o
    return ops, nbytes, max(ops / INT8_TOP_S, nbytes / HBM_BYTES_PER_S) * 1e3


def int8_conv_case(key, wq, w_scale, x_scale, bias, g):
    """The int8 conv at ``key``'s shape on a random int8 map and the weight
    ``wq`` (its scales and bias): int32 and dequantized bf16 outputs held
    bit-equal to the plain version and across two calls (raises), then the
    kernel's, the plain version's and cuDNN's bf16 conv's CUDA-event ms; the
    int8 map and the int32 accumulators."""
    n, c, h, w, o, kh, kw, s, p, d = key
    xq = cl(torch.randint(-127, 128, (n, c, h, w), device=DEV, generator=g, dtype=torch.int8))
    xs = x_scale if x_scale is not None else torch.tensor(0.01, device=DEV)
    args = (xq, wq, w_scale)
    geo = (s, p, d)
    acc = int8_cuda.launch_int8_conv(*args, None, None, *geo, torch.int32)
    acc_ref = int8q.int8_conv_ref(*args, None, None, *geo, torch.int32)
    y = int8_cuda.launch_int8_conv(*args, xs, bias, *geo, torch.bfloat16)
    y_ref = int8q.int8_conv_ref(*args, xs, bias, *geo, torch.bfloat16)
    torch.cuda.synchronize()
    y2 = int8_cuda.launch_int8_conv(*args, xs, bias, *geo, torch.bfloat16)
    if not (torch.equal(acc, acc_ref) and torch.equal(y, y_ref) and torch.equal(y, y2)):
        raise AssertionError(f"int8 conv {key}: int32 equal {torch.equal(acc, acc_ref)}, "
                             f"bf16 equal {torch.equal(y, y_ref)}, two calls equal "
                             f"{torch.equal(y, y2)}")
    t_k = cuda_time(lambda: int8_cuda.launch_int8_conv(*args, xs, bias, *geo, torch.bfloat16))
    t_p = cuda_time(lambda: int8q.int8_conv_ref(*args, xs, bias, *geo, torch.bfloat16),
                    reps=1, trials=1)
    xb = cl(xq.to(torch.bfloat16))
    wb = wq.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    t_c = cuda_time(lambda: F.conv2d(xb, wb, None, s, p, d))
    return t_k, t_p, t_c, xq, acc


def phase_int8_kernels(sites, mods):
    """12a and 12b: the int8 conv at every distinct shape of the request and
    the quantize kernels at every distinct conv input, against their plain
    versions (bit for bit), with times, bounds and yardsticks; returns the
    kernels line's entries (times per request: each shape's time x its calls)."""
    regs = int8_registers()
    g = gen(91)
    tot = dict.fromkeys(("ms", "plain", "bound", "bound_ops", "bound_bytes", "cudnn", "ops"), 0.0)
    mm = dict.fromkeys(("ms", "lib", "bound"), 0.0)
    log(f"  12a: {len(sites)} distinct int8 conv shapes, {sum(sites.values())} calls a request "
        f"(N, Cin, HxW -> Cout, kernel, stride, padding, dilation; bf16 out)")
    for key, calls in sorted(sites.items(), key=lambda kv: -int8_conv_bound(kv[0])[0]):
        n, c, h, w, o, kh, kw, s, p, d = key
        m = mods[key]
        t_k, t_p, t_c, xq, acc = int8_conv_case(key, m.weight_q, m.w_scale, m.x_scale, m.bias, g)
        ops, nbytes, bound = int8_conv_bound(key)
        lib = ""
        if kh == kw == 1 and s == (1, 1) and p == (0, 0):
            a = xq.permute(0, 2, 3, 1).reshape(-1, c)
            b = m.weight_q.reshape(o, c).t()
            if not torch.equal(torch._int_mm(a, b), acc.permute(0, 2, 3, 1).reshape(-1, o)):
                raise AssertionError(f"torch._int_mm disagrees with the int8 conv at {key}")
            t_l = cuda_time(lambda: torch._int_mm(a, b))
            mm["ms"] += t_k * calls
            mm["lib"] += t_l * calls
            mm["bound"] += bound * calls
            lib = f", torch._int_mm {t_l:.4f} ({t_k / t_l:.2f}x)"
        tot["ms"] += t_k * calls
        tot["plain"] += t_p * calls
        tot["bound"] += bound * calls
        tot["bound_ops"] += ops / INT8_TOP_S * 1e3 * calls
        tot["bound_bytes"] += nbytes / HBM_BYTES_PER_S * 1e3 * calls
        tot["cudnn"] += t_c * calls
        tot["ops"] += ops * calls
        tile = (int8_cuda.conv_tile(o), int8_cuda.pixel_source(xq))
        log(f"  12a ({n}, {c}, {h}x{w} -> {o}, {kh}x{kw}, s{s[0]}, p{p[0]}, d{d[0]}) x{calls}: "
            f"int32 and bf16 bit-equal, two calls bit-equal; kernel {t_k:.4f} ms "
            f"({ops / t_k / 1e9:.1f} TOP/s, {100 * bound / t_k:.1f} % of the bound "
            f"{bound:.4f}), plain (float64) {t_p:.3f}, cuDNN bf16 conv {t_c:.4f} "
            f"({t_k / t_c:.2f}x){lib}; tile {tile[0]} {INT8_SOURCES[tile[1]]}: "
            f"{regs.get(tile, 'no ptxas report')}")
    log(f"  12a per request (each shape's time x its calls): int8 conv {tot['ms']:.3f} ms "
        f"({tot['ops'] / tot['ms'] / 1e9:.1f} TOP/s, {100 * tot['bound'] / tot['ms']:.1f} % of "
        f"the bound {tot['bound']:.3f}: operations {tot['bound_ops']:.3f}, bytes "
        f"{tot['bound_bytes']:.3f}), plain {tot['plain']:.1f}, cuDNN's bf16 convs "
        f"{tot['cudnn']:.3f} ({tot['ms'] / tot['cudnn']:.2f}x); at the 1x1 stride-1 sites "
        f"{mm['ms']:.3f} against torch._int_mm's {mm['lib']:.3f} ({mm['ms'] / mm['lib']:.2f}x; "
        f"bound {mm['bound']:.3f})")

    # 12b: the quantize kernels at each distinct conv input of the request (bf16)
    inputs = {}
    for (n, c, h, w, *_), calls in sites.items():
        inputs[(n, c, h, w)] = inputs.get((n, c, h, w), 0) + calls
    q = dict.fromkeys(("ms", "plain", "bound", "dyn_ms", "dyn_plain", "dyn_bound", "dyn_bound2",
                       "dyn_norm", "dyn_dev"), 0.0)
    for shape, calls in sorted(inputs.items()):
        x = cl(torch.randn(*shape, device=DEV, generator=g).to(torch.bfloat16) * 3)
        xq, scale = int8_cuda.launch_dynamic_quantize(x)
        xq_ref, scale_ref = int8q.dynamic_quantize_ref(x)
        xq2, scale2 = int8_cuda.launch_dynamic_quantize(x)
        sc = scale * 0.9  # the static route at a scale that clips
        checks = [torch.equal(xq, xq_ref) and torch.equal(scale, scale_ref),
                  torch.equal(xq2, xq) and torch.equal(scale2, scale),
                  torch.equal(int8_cuda.launch_quantize(x, sc, False),
                              int8q.quantize_ref(x, sc, False))]
        if not all(checks):
            raise AssertionError(f"int8 quantize at {shape}: dynamic equal to its plain version, "
                                 f"two dynamic calls equal, static equal: {checks}")
        numel = x.numel()
        t_q = cuda_time(lambda: int8_cuda.launch_quantize(x, scale, False))
        t_qp = cuda_time(lambda: int8q.quantize_ref(x, scale, False))
        t_d = cuda_time(lambda: int8_cuda.launch_dynamic_quantize(x))
        t_dp = cuda_time(lambda: int8q.dynamic_quantize_ref(x))
        t_dn = cuda_time(lambda: torch.linalg.vector_norm(x, float("inf")))
        b_q = (3 * numel + 8) / HBM_BYTES_PER_S * 1e3
        # the dynamic quantize: x read once (twice, where pass 2 misses L2),
        # the int8 copy and the scale written
        b_d = (3 * numel + 4) / HBM_BYTES_PER_S * 1e3
        b_d2 = (5 * numel + 4) / HBM_BYTES_PER_S * 1e3
        for k_, v in (("ms", t_q), ("plain", t_qp), ("bound", b_q), ("dyn_ms", t_d),
                      ("dyn_plain", t_dp), ("dyn_bound", b_d), ("dyn_bound2", b_d2),
                      ("dyn_norm", t_dn)):
            q[k_] += v * calls
        log(f"  12b {shape} x{calls}: dynamic quantize bit-equal to its plain version (codes "
            f"and scale) and across two calls, static quantize bit-equal; dynamic {t_d:.4f} ms "
            f"({(3 * numel + 4) / t_d / 1e6:.1f} GB/s of one read, {100 * b_d / t_d:.1f} % of "
            f"the one-read bound {b_d:.4f}, {100 * b_d2 / t_d:.1f} % of the two-read bound "
            f"{b_d2:.4f}), plain {t_dp:.4f}, vector_norm(inf) (pass 1's yardstick) {t_dn:.4f}; "
            f"static quantize {t_q:.4f} ({3 * numel / t_q / 1e6:.1f} GB/s, "
            f"{100 * b_q / t_q:.1f} % of the bound), plain {t_qp:.4f}")
        # the kernel's own device time: the CUDA-event time of a small input is
        # the wrapper's host time
        t_dd = device_rate(f"12b {shape} dynamic quantize, one-read bound",
                           lambda: int8_cuda.launch_dynamic_quantize(x),
                           ("dynamic_quantize_kernel",), b_d, nbytes=3 * numel + 4)[0]
        q["dyn_dev"] = None if None in (t_dd, q["dyn_dev"]) else q["dyn_dev"] + t_dd * calls
    # a NaN in the largest input: the scale NaN, as the plain version's (and
    # JAX's) max keeps it
    shape = max(inputs, key=lambda s_: s_[0] * s_[1] * s_[2] * s_[3])
    x = cl(torch.randn(*shape, device=DEV, generator=g).to(torch.bfloat16))
    x.permute(0, 2, 3, 1).view(-1)[x.numel() // 3] = float("nan")
    xq, scale = int8_cuda.launch_dynamic_quantize(x)
    xq_ref, scale_ref = int8q.dynamic_quantize_ref(x)
    if not (torch.isnan(scale) and torch.isnan(scale_ref) and torch.equal(xq, xq_ref)):
        raise AssertionError(f"12b NaN at {shape}: scale {scale.item()} (plain "
                             f"{scale_ref.item()}), codes equal {torch.equal(xq, xq_ref)}")
    names = dynamic_quantize_names(shape)
    if len(names) != 1 or "dynamic_quantize_kernel" not in names[0]:
        raise AssertionError(f"12b: one _dynamic_quantize call ran {names}")
    log(f"  12b NaN in a {shape} input: scale NaN, as the plain version's; codes equal. One "
        f"_dynamic_quantize call's CUDA work (profiler, a process of its own): {names}")
    dyn_dev = "not measured" if q["dyn_dev"] is None else f"{q['dyn_dev']:.3f} ms"
    log(f"  12b per request: the dynamic route (one launch a conv) {q['dyn_ms']:.3f} ms, the "
        f"kernel's device time {dyn_dev} (bound "
        f"{q['dyn_bound']:.3f} with one read of x, {q['dyn_bound2']:.3f} with two; plain "
        f"{q['dyn_plain']:.3f}; vector_norm(inf) alone {q['dyn_norm']:.3f}); static quantize "
        f"{q['ms']:.3f} (bound {q['bound']:.3f}, plain {q['plain']:.3f})")
    log(f"  12a/12b per request: the static route (quantize + int8 conv) "
        f"{q['ms'] + tot['ms']:.3f} ms ({q['ms']:.3f} + {tot['ms']:.3f}; bound "
        f"{q['bound'] + tot['bound']:.3f}) against cuDNN's bf16 convs {tot['cudnn']:.3f} "
        f"({(q['ms'] + tot['ms']) / tot['cudnn']:.2f}x); the dynamic route "
        f"{q['dyn_ms'] + tot['ms']:.3f}")
    bound_by = "operations" if tot["bound_ops"] >= tot["bound_bytes"] else "bytes"
    return {
        "int8_conv": {"ms": tot["ms"], "plain_ms": tot["plain"], "bound_ms": tot["bound"],
                      "bound_by": bound_by, "library_ms": None, "max_abs_err": 0.0,
                      "per": "int8 tta_mc request at B=8, bf16 (each shape x its calls)",
                      "int_mm_sites": {"ms": mm["ms"], "library_ms": mm["lib"],
                                       "bound_ms": mm["bound"]},
                      "cudnn_bf16_ms": tot["cudnn"],
                      "with_quantize_ms": tot["ms"] + q["ms"]},
        "int8_quantize": {"ms": q["ms"], "plain_ms": q["plain"], "bound_ms": q["bound"],
                          "bound_by": "bytes", "library_ms": None, "max_abs_err": 0.0,
                          "per": "int8 tta_mc request at B=8, bf16 (static scales)"},
        # no one PyTorch call computes the whole function; vector_norm(x, inf)
        # computes pass 1's abs-max alone
        "int8_dynamic_quantize": {"ms": q["dyn_ms"], "plain_ms": q["dyn_plain"],
                                  "bound_ms": q["dyn_bound"], "bound_by": "bytes",
                                  "library_ms": None, "max_abs_err": 0.0,
                                  "bound_two_reads_ms": q["dyn_bound2"],
                                  "device_ms": q["dyn_dev"],
                                  "vector_norm_inf_ms": q["dyn_norm"],
                                  "per": "the same inputs, as the dynamic route runs them"},
    }


# a process of its own that prints the names of the CUDA work (kernels,
# memsets, copies) one ``_dynamic_quantize`` call on a bf16 channels_last map
# of the given shape puts on the device, under the profiler: late in this
# script's process a profiler session often records nothing
NAMES_CHILD = r"""
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
from dmf_tpu_torch.ops import library, quant  # noqa: F401  (registers the dmf:: operators)
x = torch.randn(*json.loads(sys.argv[1]), device="cuda").to(torch.bfloat16).contiguous(
    memory_format=torch.channels_last)
quant._dynamic_quantize(x)
torch.cuda.synchronize()
for _ in range(5):  # a session at times records nothing
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        quant._dynamic_quantize(x)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    if names:
        break
print(json.dumps(names))
"""


def dynamic_quantize_names(shape):
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-c", NAMES_CHILD, json.dumps(list(shape))], cwd=here,
                          env=dict(os.environ, PYTHONPATH=here), capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"12b profiling process exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.splitlines()[-1])


def int8_request(cfg, predict, seed):
    """A raw request as phase 5's, its data and MC generators from ``seed``:
    the same seed gives two predictors the same volumes and masks."""
    return raw_request(cfg, predict, gen(seed), gen(seed + 1000))


def phase_int8_serve(cfg, models, qfwd, dfwd, hfwd, expect):
    """12c: int8 (static scales), int8 with dynamic scales, fp and hybrid
    tta_mc requests of B=8 raw volumes, in turns, on the same inputs and MC
    seeds; launches of each set to 0 just before and read just after."""
    preds = {name: make_fusion_predictor(cfg, *models, mode="tta_mc", fwd_override=f)
             for name, f in (("int8", qfwd), ("int8-dynamic", dfwd), ("fp", None),
                             ("int8-prefix", hfwd))}
    for name, p in preds.items():  # warm-up: cuDNN plans, prepared weights
        int8_request(cfg, p, 99)()
    lat = {k: [] for k in preds}
    split = {k: [] for k in preds}
    outs = {k: [] for k in preds}
    launched = dict.fromkeys(COUNTERS, 0)
    for r in range(INT8_REQUESTS):
        for name, p in preds.items():
            request = int8_request(cfg, p, 200 + r)
            reset_counts()
            dt, mean, std = request()
            rose = counts()
            gate(f"12c {name}", cfg, rose, expect[name], mean, std, True, B_SERVE)
            if name != "fp":
                launched = {k: launched[k] + rose[k] for k in COUNTERS}
            lat[name].append(dt * 1e3)
            split[name].append(request.split[1])
            outs[name].append((mean.float(), std.float()))
    fp_ms = statistics.median(lat["fp"])
    for name in preds:
        log(f"  12c {name} tta_mc B={B_SERVE} bf16: median latency "
            f"{statistics.median(lat[name]):.2f} ms over {INT8_REQUESTS} requests "
            f"({B_SERVE * 1e3 / statistics.median(lat[name]):.2f} volumes/s; predictor "
            f"{statistics.median(split[name]):.3f} ms by CUDA events); "
            f"{statistics.median(lat[name]) / fp_ms:.3f}x the fp predictor's; launches a "
            f"request {expect[name]}")
    log(f"  12c int8 with dynamic scales against static: median latency "
        f"{statistics.median(lat['int8-dynamic']):.2f} ms against "
        f"{statistics.median(lat['int8']):.2f} ms")
    agree = {}
    for name in ("int8", "int8-dynamic", "int8-prefix"):
        mean_q = torch.cat([m for m, _ in outs[name]])
        mean_f = torch.cat([m for m, _ in outs["fp"]])
        std_q = torch.cat([s for _, s in outs[name]])
        std_f = torch.cat([s for _, s in outs["fp"]])
        same = (mean_q.argmax(-1) == mean_f.argmax(-1)).float().mean().item()
        e_mean = (mean_q - mean_f).abs().max().item()
        e_std = (std_q - std_f).abs().max().item()
        agree[name] = (same, e_mean, e_std)
        log(f"  12c {name} against fp on the same inputs and masks "
            f"({INT8_REQUESTS * B_SERVE} volumes): argmax agreement {same:.4f}, max mean-prob "
            f"error {e_mean:.3e}, max std error {e_std:.3e}")
        if not (same >= 0.9 and e_mean <= 0.05 and e_std <= 0.05):
            raise AssertionError(f"{name} strays from the fp ensemble: {agree[name]}")
    log(f"  12c launches (the int8, dynamic int8 and hybrid requests): {launched}")
    return launched, {k: statistics.median(v) for k, v in lat.items()}


def phase_int8_cpu(cfg):
    """12d: the int8 tta forward at B=1 in fp32 with dynamic scales (the
    dynamic quantize route), card against CPU; launches set to 0 just before
    the card's run and read just after."""
    cpu_models, dev_models = card_and_cpu_models(cfg)
    qsets = {k: int8q.build_quant_set(m) for k, m in zip(("dwi", "dce", "fusion"), cpu_models)}
    g = torch.Generator().manual_seed(93)
    S = cfg.dwi_model.input_size
    dwi = torch.rand(1, S, S, cfg.dwi_channel_num, generator=g)
    dce = torch.rand(1, S, S, cfg.dce_channel_num, generator=g)
    card_fwd = int8q.make_quantized_fusion_fwd(*dev_models, qsets)
    cpu_fwd = int8q.make_quantized_fusion_fwd(*cpu_models, qsets)
    reset_counts()
    (mean_d, std_d, _), t_dev = synced(lambda: make_fusion_predictor(
        cfg, *dev_models, mode="tta", fwd_override=card_fwd)(dwi.to(DEV), dce.to(DEV)))
    launched = counts()
    (mean_c, std_c, _), t_cpu = synced(lambda: make_fusion_predictor(
        cfg, *cpu_models, mode="tta", fwd_override=cpu_fwd)(dwi, dce))
    n_q = sum(len(s) for s in qsets.values())
    log(f"  12d int8 tta B=1 fp32, dynamic scales: card {t_dev:.2f} s (launches {launched}), "
        f"CPU {t_cpu:.2f} s; {n_q} quantized convs")
    if not (launched["int8_dynamic_quantize"] == launched["int8_conv"] > 0
            and launched["int8_quantize"] == 0 and launched["conv3x3_bn_gelu"] == 0):
        raise AssertionError(f"12d launches {launched}")
    compare_card_cpu((("12d int8 mean, card vs CPU", mean_d, mean_c, INT8_CPU_TOL),
                      ("12d int8 std, card vs CPU", std_d, std_c, INT8_CPU_TOL)))
    del cpu_models, dev_models, card_fwd, cpu_fwd
    torch.cuda.empty_cache()
    return launched


def phase_int8_fold(cfg, tmp):
    """12e: test_fusion_model(int8=True, calibration_data=val) on phase 8's
    trained fp32 fusion state and processed splits; launches set to 0 just
    before and read just after."""
    base = os.path.join(tmp, "cli", "data")
    ccfg = cfg.replace(foundation_model_unfreeze_timer=2, base_path=base)
    best = os.path.join(tmp, "cli", "results", "fusion", "fold_0", "checkpoints", "best.pt")
    # the fold's state as cli export-serving rebuilds it
    dwi_model, _ = build_single_model(ccfg, "dwi", device=DEV)
    dce_model, _ = build_single_model(ccfg, "dce", device=DEV)
    state = load_checkpoint(best, build_fusion_state(ccfg, TrainState.create(dwi_model),
                                                     TrainState.create(dce_model)))
    fd = prepare_fusion_data(ccfg, 0)
    reset_counts()
    res, t = synced(lambda: test_fusion_model(ccfg, state, fd["test"], seed=0, int8=True,
                                              calibration_data=fd["val"]))
    launched = counts()
    ref, t_fp = synced(lambda: test_fusion_model(ccfg, state, fd["test"], seed=0))
    if not all_finite(res["metrics"]) or not np.isfinite(res["probs"]).all():
        raise AssertionError(f"12e: int8 test metrics not finite: {res['metrics']}")
    same = float((res["probs"].argmax(-1) == ref["probs"].argmax(-1)).mean())
    log(f"  12e test_fusion_model(int8=True, calibration_data=val) on phase 8's fold "
        f"({len(fd['test']['labels'])} test volumes, {len(fd['val']['labels'])} validation, "
        f"fp32 {ccfg.test_mode}): {t:.2f} s (fp {t_fp:.2f} s), metrics finite: "
        + ", ".join(f"{k} {v:.4f}" for k, v in sorted(res["metrics"].items())
                    if isinstance(v, float) and "per_class" not in k)
        + f"; argmax agreement with the fp test {same:.4f}; launches {launched}")
    if launched["int8_conv"] <= 0 or launched["conv3x3_bn_gelu"] != 0:
        raise AssertionError(f"12e launches {launched}")
    del dwi_model, dce_model, state
    torch.cuda.empty_cache()
    return launched


def phase_int8_artifact(cfg, models, qfwd, tmp):
    """12f: the int8 tta_mc serving artifact, exported on the card, served in
    a fresh process (torch and ops.library only) against the eager int8
    seed-route predictor, bit for bit; returns the serving process's launches."""
    art_dir = os.path.join(tmp, "int8")
    os.makedirs(art_dir)
    S = cfg.dwi_model.input_size
    g = gen(94)
    dx, cx = preprocess_fusion_inputs(
        torch.rand(B_SERVE, S, S, cfg.dwi_base_channel_num, device=DEV, generator=g) * 1000.0,
        torch.rand(B_SERVE, S, S, cfg.dce_channel_num, device=DEV, generator=g),
        torch.full((S, S, 1), 0.5, device=DEV))
    fn = make_serving_fn(cfg, *models, mode="tta_mc", fwd_override=qfwd)
    variables = serving_variables(*models, fwd_override=qfwd)
    args = (variables, dx, cx, torch.tensor(ARTIFACT_SEEDS[0], device=DEV))
    predict = make_fusion_predictor(cfg, *models, mode="tta_mc", fwd_override=qfwd)
    eager = predict(dx, cx, args[3])
    eager_ms = cuda_time(lambda: predict(dx, cx, args[3]), reps=1, trials=5)
    (ep, t_export) = synced(lambda: export_program(fn, args))
    nodes = operator_nodes(ep)
    path = os.path.join(art_dir, "int8_tta_mc_bf16.pt2")
    torch.export.save(ep, path)
    inputs = os.path.join(art_dir, "int8.inputs.pt")
    torch.save({"variables": variables, "dwi_x": dx, "dce_x": cx}, inputs)
    q_bytes = sum(t.numel() * t.element_size() for k, sd in variables.items()
                  if k.startswith("int8_") for t in sd.values())
    log(f"  12f int8 tta_mc bf16 B={B_SERVE}: export {t_export:.2f} s, operator nodes {nodes}, "
        f"artifact {os.path.getsize(path)} bytes (held: {len(ep.state_dict)} parameters or "
        f"buffers, {len(ep.constants)} constants) beside {q_bytes} bytes of the quantized "
        f"copies' state dicts; eager seed-route predictor {eager_ms:.3f} ms")
    del ep
    job = {"name": "int8", "artifact": path, "inputs": inputs, "seeds": list(ARTIFACT_SEEDS)}
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-c", SERVE_CHILD, json.dumps([job])], cwd=here,
                          env=dict(os.environ, PYTHONPATH=here), capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"int8 serving process exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    r = lines[1]
    if r["counts"] != {k: ARTIFACT_REQUESTS * v for k, v in nodes.items()}:
        raise AssertionError(f"12f: launched {r['counts']}, expected {ARTIFACT_REQUESTS} x "
                             f"{nodes}")
    mean, std = (torch.tensor(v) for v in r["outputs"][0])
    if not (torch.equal(mean, eager[0].float().cpu()) and torch.equal(std, eager[1].float().cpu())):
        raise AssertionError(f"12f: the artifact's (mean, std) differ from the eager int8 "
                             f"predictor's by {(mean - eager[0].float().cpu()).abs().max()}")
    log(f"  12f fresh process ({', '.join(lines[0]['modules'])}): load {r['load_s']:.2f} s; "
        f"requests (ms, CUDA events) " + ", ".join(f"{t:.3f}" for t in r["ms"])
        + f", median after the first {statistics.median(r['ms'][1:]):.3f} ms against "
        f"{eager_ms:.3f} eager; seed {ARTIFACT_SEEDS[0]} bit-equal to the eager int8 seed-route "
        f"predictor; launches {r['counts']}")
    names = {"int8_conv": "int8_conv", "quantize": "int8_quantize",
             "dynamic_quantize": "int8_dynamic_quantize", "keep_mask": "keep_mask"}
    return {names[k]: v for k, v in r["counts"].items() if k in names}


def phase_int8(cfg, tmp):
    """Phase 12: int8 post-training quantization (ops/quant.py) at full width;
    returns the launches of its served paths and the kernels line's entries."""
    t_phase = time.perf_counter()
    log(f"== phase 12: int8 serving (ops/quant.py): the default config at full width in bf16, "
        f"calibrated with MC dropout on {INT8_CALIB} preprocessed volumes of a separate draw")
    # the fp32 weights are quantized (as JAX quantizes its fp32 params), the
    # bf16 models calibrated and served
    weights = build_fusion_models(cfg, DEV, torch.float32, gen(SEED))
    models = [copy.deepcopy(m).to(torch.bfloat16) for m in weights]
    S = cfg.dwi_model.input_size
    g = gen(81)
    calib = preprocess_fusion_inputs(
        torch.rand(INT8_CALIB, S, S, cfg.dwi_base_channel_num, device=DEV, generator=g) * 1000.0,
        torch.rand(INT8_CALIB, S, S, cfg.dce_channel_num, device=DEV, generator=g),
        torch.full((S, S, 1), 0.5, device=DEV))
    (_, qsets), t_cal = synced(lambda: int8q.make_quantized_fusion_apply(
        *models, calibration=calib, calibration_mc=True, calibration_rng=gen(82),
        weights=weights))
    del weights
    qfwd = int8q.make_quantized_fusion_fwd(*models, qsets)
    hfwd = int8q.make_hybrid_fusion_fwd(*models, qsets)
    # the calibration-free route: the same QuantSets without their static scales
    dfwd = int8q.make_quantized_fusion_fwd(*models, {
        k: {name: {kk: v for kk, v in e.items() if kk != "x_scale"} for name, e in qs.items()}
        for k, qs in qsets.items()})
    kept = {(n, b.dtype) for f in (qfwd, dfwd, hfwd) for mod in f.modules.values()
            for m in mod.modules() if isinstance(m, int8q.QuantConv2d)
            for n, b in m.named_buffers() if n != "weight_q"}
    if {d for _, d in kept} != {torch.float32}:
        raise AssertionError(f"12: the quantized copies' scales and biases are not fp32: {kept}")
    log(f"  quantize (fp32 weights) + calibrate (bf16 models): {t_cal:.2f} s; quantized convs "
        + ", ".join(f"{k} {len(v)}" for k, v in qsets.items())
        + f"; the copies' scales and biases fp32 ({', '.join(sorted({n for n, _ in kept}))})")
    g_req = gen(83)
    dx, cx = preprocess_fusion_inputs(
        torch.rand(B_SERVE, S, S, cfg.dwi_base_channel_num, device=DEV, generator=g_req) * 1e3,
        torch.rand(B_SERVE, S, S, cfg.dce_channel_num, device=DEV, generator=g_req),
        torch.full((S, S, 1), 0.5, device=DEV))
    pred = make_fusion_predictor(cfg, *models, mode="tta_mc", fwd_override=qfwd)
    sites, mods = conv_sites(pred, dx, cx, gen(84), qfwd.modules.values())
    hpred = make_fusion_predictor(cfg, *models, mode="tta_mc", fwd_override=hfwd)
    hsites, _ = conv_sites(hpred, dx, cx, gen(84), hfwd.modules.values())
    measured = phase_int8_kernels(sites, mods)
    n_conv, n_hyb = sum(sites.values()), sum(hsites.values())
    base = dict.fromkeys(COUNTERS, 0) | {"se_epilogue": 12, "keep_mask": 12, "se_scale": 4,
                                         "dwi_normalize": 1}
    expect = {"int8": base | {"int8_conv": n_conv, "int8_quantize": n_conv},
              "int8-dynamic": base | {"int8_conv": n_conv, "int8_dynamic_quantize": n_conv},
              "fp": base | {"conv3x3_bn_gelu": 12},
              "int8-prefix": base | {"int8_conv": n_hyb, "int8_quantize": n_hyb}}
    launched, lat = phase_int8_serve(cfg, models, qfwd, dfwd, hfwd, expect)
    for k, v in phase_int8_cpu(cfg).items():
        launched[k] += v
    for k, v in phase_int8_fold(cfg, tmp).items():
        launched[k] += v
    for k, v in phase_int8_artifact(cfg, models, qfwd, tmp).items():
        launched[k] += v
    del models, qfwd, dfwd, hfwd, pred, hpred, mods
    torch.cuda.empty_cache()
    log(f"  phase 12: {time.perf_counter() - t_phase:.1f} s")
    return launched, measured

# ------------------------------------------------------------------ phase 13
# the data mesh (parallel/mesh.py) on the one card: two ranks pinned to it
# with gloo (NCCL refuses two ranks on one card), each a process of its own
# started by torch.distributed.run, running this file with --mesh-rank
MESH_RANKS = 2
MESH_B, MESH_STEPS = 32, 2  # 13a: global B=32, 16 a rank
MESH_FOLD_B, MESH_FOLD_STEPS = 2, 2  # 13c: the DWI encoder, one fold a rank
MESH_STEP_SEED, MESH_DROP_SEED = 61, 62
MESH_SERVE_SEEDS = (81, 82, 83)


def mesh_fusion_setup(cfg, n_steps=MESH_STEPS, b=MESH_B, seed=MESH_STEP_SEED, net=None):
    """13a's full-width fusion network (dropout 0, as phase 7c: its bound
    reads a run in another memory format; every group trainable; ``net``
    given: that one), its step, hyperparameters and ``n_steps`` global
    batches of ``b``, the same in every process (seeded generators on the
    card)."""
    fcfg = fusion_config(cfg, dropout=0.0)
    if net is None:
        net = FusionNetwork(*build_fusion_models(fcfg, DEV, generator=gen(SEED)))
    init = {n: p.detach().cpu().clone() for n, p in net.named_parameters()}
    spec = build_fusion_group_spec(list(init), fcfg)
    clf = get_classification_loss_fn(fcfg, np.arange(fcfg.class_num), "fusion")
    step = make_fusion_train_step(fcfg, clf, get_mask_loss_fn(fcfg, "fusion"), spec)
    ctrl = FusionOptController(fcfg)
    ctrl.on_epoch_start(3)
    aux_w = aux_loss_weight(3, fcfg.aux_loss_weight_epoch_limit)
    batches = [dict(x, aux_w=aux_w) for x in fusion_batches(fcfg, n_steps, b, seed)]
    return fcfg, net, init, spec, step, ctrl.hyperparams(), batches


def mesh_fold_setup(cfg):
    """13c's two folds of the full-width DWI encoder (one build copied, as
    ``run_single_model_multifold`` does), its raw step and each fold's
    batches (kernel 7 and the augmentation on the card)."""
    rcfg = train_config(cfg)
    model, rcfg = build_single_model(rcfg, "dwi", device=DEV)
    models = [model, copy.deepcopy(model)]
    names = [n for n, _ in model.named_parameters()]
    spec = build_group_spec(names, rcfg.dwi_model.use_backbone, rcfg.reference_compat)
    clf = get_classification_loss_fn(rcfg, np.arange(rcfg.class_num), "dwi")
    raw = make_single_train_step(rcfg, "dwi", clf, get_mask_loss_fn(rcfg, "dwi"), spec)
    ctrl = SingleModelOptController(rcfg, "dwi")
    ctrl.on_epoch_start(1)
    batches = [[dict(b, aux_w=1.0) for b in dwi_batches(rcfg, MESH_FOLD_STEPS, MESH_FOLD_B,
                                                          90 + f)] for f in range(2)]
    return models, raw, ctrl.hyperparams(), batches


def state_digest(model):
    """A digest of a model's parameters and buffers, bit for bit."""
    import hashlib

    h = hashlib.sha256()
    for k, t in model.state_dict().items():
        h.update(k.encode())
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def mesh_fold_steps(cfg, mesh=None):
    """13c: the two folds' steps (``make_multifold_step``, deterministic
    algorithms); the digest of each fold this process stepped."""
    from dmf_tpu_torch.parallel import make_multifold_step

    models, raw, hp, batches = mesh_fold_setup(cfg)
    states = [TrainState.create(m) for m in models]
    step = make_multifold_step(raw, mesh=mesh)
    with deterministic():
        for i in range(MESH_FOLD_STEPS):
            step(states, [b[i] for b in batches], [gen(95 + f + 10 * i) for f in range(2)], hp)
    owned = mesh.folds(2) if mesh is not None else range(2)
    return {f: state_digest(models[f]) for f in owned}


def mesh_request(cfg, predict, b=B_SERVE):
    """One request of ``b`` raw volumes from 13b's seeded draws (the same in
    every process): preprocessing (kernel 7) then the predictor."""
    S = cfg.dwi_model.input_size
    g = gen(MESH_SERVE_SEEDS[0])
    dwi_raw = torch.rand(b, S, S, cfg.dwi_base_channel_num, device=DEV, generator=g) * 1000.0
    dce_raw = torch.rand(b, S, S, cfg.dce_channel_num, device=DEV, generator=g)
    dx, cx = preprocess_fusion_inputs(dwi_raw, dce_raw, torch.full((S, S, 1), 0.5, device=DEV))
    return predict(dx, cx, gen(MESH_SERVE_SEEDS[1]))


class CollectiveTimer:
    """Within ``with``: the mesh's collectives timed apart (the stream
    synchronised around each), their ms and count."""

    NAMES = ("all_reduce", "model_all_reduce", "model_gather")

    def __init__(self):
        from dmf_tpu_torch.parallel import mesh as mesh_mod

        self.cls, self.ms, self.n = mesh_mod.Mesh, 0.0, 0

    def __enter__(self):
        self.plain = {n: getattr(self.cls, n) for n in self.NAMES}

        def timed(fn):
            def wrapped(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                self.ms += (time.perf_counter() - t0) * 1e3
                self.n += 1
                return out
            return wrapped

        for n, fn in self.plain.items():
            setattr(self.cls, n, timed(fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.plain.items():
            setattr(self.cls, n, fn)


def mesh_rank_main(out):
    """One rank of phase 13 (``python -m torch.distributed.run --nproc-per-node
    2 chip_smoke.py --mesh-rank OUT``): 13a, 13b and 13c on this rank's rows
    or folds; its results into ``OUT/rank<r>.json``."""
    from dmf_tpu_torch.parallel import make_mesh, make_spmd_step, shard_state

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(MESH_RANKS, 1, devices=[DEV] * MESH_RANKS)
    cfg = default_parameters()
    res = {"rank": mesh.rank, "backend": mesh.backend}
    # 13a
    fcfg, net, init, spec, step, hp, batches = mesh_fusion_setup(cfg)
    state = TrainState.create(net, num_groups=4)
    shard_state(state, mesh)
    dp = make_spmd_step(step, mesh)
    g = gen(MESH_DROP_SEED)
    torch.cuda.reset_peak_memory_stats()
    res["metrics"], res["step_ms"] = [], []
    for b in batches:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        mesh.barrier()
        ev[0].record()
        m = dp(state, b, g, hp)
        ev[1].record()
        torch.cuda.synchronize()
        res["metrics"].append({k: float(v) for k, v in m.items()})
        res["step_ms"].append(ev[0].elapsed_time(ev[1]))
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    single = copy.deepcopy(net)
    single.load_state_dict(torch.load(os.path.join(out, "single_fusion.pt"), map_location=DEV,
                                      weights_only=True))
    res["gaps"] = {str(k): v for k, v in disagreement(net, single, init, spec).items()}
    del single
    # one more step with every collective timed apart (synchronised around it)
    with CollectiveTimer() as timer:
        mesh.barrier()
        t0 = time.perf_counter()
        dp(state, batches[0], g, hp)
        torch.cuda.synchronize()
        res["timed_step_ms"] = (time.perf_counter() - t0) * 1e3
    res["collective_ms"], res["collectives"] = timer.ms, timer.n
    del state, net, dp, batches
    torch.cuda.empty_cache()
    # 13b
    models = build_fusion_models(cfg, DEV, torch.bfloat16, gen(SEED))
    predict = make_fusion_predictor(cfg, *models, mode="tta_mc", mesh=mesh)
    mesh_request(cfg, predict)  # warm-up
    res["requests"] = []
    for _ in range(REQUESTS):
        reset_counts()
        mesh.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean, std, _ = mesh_request(cfg, predict)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        gate("mesh tta_mc", cfg, counts(), MESH_SERVE_EXPECT, mean, std, True, B_SERVE)
        res["requests"].append({"ms": dt * 1e3, "counts": counts()})
    del models, predict
    models = build_fusion_models(cfg, DEV, torch.float32, gen(SEED))
    mean, std, _ = mesh_request(cfg, make_fusion_predictor(cfg, *models, mode="tta", mesh=mesh))
    ref = torch.load(os.path.join(out, "single_tta.pt"), map_location=DEV, weights_only=True)
    res["tta_err"] = [(mean - ref["mean"]).abs().max().item(),
                      (std - ref["std"]).abs().max().item()]
    del models
    torch.cuda.empty_cache()
    # 13c
    res["folds"] = mesh_fold_steps(cfg, mesh)
    with open(os.path.join(out, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


# per rank and request: the same launches as one process's request (phase 5)
MESH_SERVE_EXPECT = dict.fromkeys(COUNTERS, 0) | {"se_epilogue": 12, "keep_mask": 12,
                                                  "conv3x3_bn_gelu": 12,
                                                  "se_scale": 4, "dwi_normalize": 1}


def phase_mesh(cfg, tmp, smi):
    """Phase 13: the data mesh; returns the ranks' launches."""
    from dmf_tpu_torch.parallel import local_mesh, make_spmd_step, shard_state

    t_phase = time.perf_counter()
    log(f"== phase 13: the data mesh (parallel/mesh.py) on the one card: {MESH_RANKS} ranks "
        f"pinned to it with gloo, each a process of its own (torch.distributed.run); 13a "
        f"{MESH_STEPS} full-width fusion train steps at global B={MESH_B} fp32 (dropout 0, "
        f"every group trainable) against one process's at phase 7c's bound, 13b tta_mc bf16 "
        f"requests of B={B_SERVE} served data parallel, tta fp32 against one process's, 13c "
        f"two DWI folds on the two ranks against one process's, 13d 13a's steps on a 1x1 mesh "
        f"over NCCL")
    out = os.path.join(tmp, "mesh")
    os.makedirs(out)
    # one process's runs first, the references the ranks read
    fcfg, net, init, spec, step, hp, batches = mesh_fusion_setup(cfg)

    def steps(model, mesh=None):
        state, g = TrainState.create(model, num_groups=4), gen(MESH_DROP_SEED)
        run = step
        if mesh is not None:
            shard_state(state, mesh)
            run = make_spmd_step(step, mesh)
        return [{k: float(v) for k, v in run(state, b, g, hp).items()} for b in batches]

    alt = copy.deepcopy(net).to(memory_format=torch.contiguous_format)
    nccl = copy.deepcopy(net)
    single = steps(net)
    # phase 7c's floor: the same steps in another memory format
    steps(alt)
    layout = {str(k): v for k, v in disagreement(alt, net, init, spec).items()}
    del alt
    # 13d: the same steps on a 1x1 mesh over NCCL, one process: the mesh
    # route's BatchNorm (two passes over the group's sums) and gradient sum,
    # every collective through NCCL; a floor of the route beside the layout's
    mesh = local_mesh(DEV)
    if mesh.backend != "nccl":
        raise AssertionError(f"13d: the 1x1 mesh runs {mesh.backend}")
    one_rank = steps(nccl, mesh)
    route = {str(k): v for k, v in disagreement(nccl, net, init, spec).items()}
    for i, (a, b) in enumerate(zip(one_rank, single)):
        rel = {n: abs(a[n] - b[n]) / max(abs(b[n]), 1e-12) for n in FUSION_LOSSES}
        if not all(v <= TRAIN_LOSS_RTOL for v in rel.values()):
            raise AssertionError(f"13d step {i}: losses off one process's: {rel}")
    if route["-1"] != 0.0:
        raise AssertionError("13d: the excluded group moved")
    log(f"  13d: a 1x1 mesh on {mesh.backend}: the {MESH_STEPS} steps of 13a through "
        f"make_spmd_step (BatchNorm's sums, the gradient sum and the metrics by NCCL's "
        f"all-reduce): losses " + "; ".join(
            ", ".join(f"{n} {a[n]:.6f}" for n in FUSION_LOSSES) for a in one_rank)
        + f" within rel {TRAIN_LOSS_RTOL:.0e} of one process's; against one process's "
        f"parameters per group " + ", ".join(f"{k} {v:.3e}" for k, v in route.items())
        + "; one process in contiguous memory format against channels_last (phase 7c's "
        f"floor): " + ", ".join(f"{k} {v:.3e}" for k, v in layout.items()))
    tols = {g_: 0.0 if g_ == "-1" else
            max(TRAIN_FLOOR, FUSION_FLOOR_MARGIN * max(layout[g_], route[g_]))
            for g_ in layout}
    torch.save(net.state_dict(), os.path.join(out, "single_fusion.pt"))
    del net, nccl, batches
    torch.cuda.empty_cache()
    models = build_fusion_models(cfg, DEV, torch.bfloat16, gen(SEED))
    predict = make_fusion_predictor(cfg, *models, mode="tta_mc")
    mesh_request(cfg, predict)
    one = []
    for _ in range(REQUESTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh_request(cfg, predict)
        torch.cuda.synchronize()
        one.append((time.perf_counter() - t0) * 1e3)
    del models, predict
    models = build_fusion_models(cfg, DEV, torch.float32, gen(SEED))
    mean, std, _ = mesh_request(cfg, make_fusion_predictor(cfg, *models, mode="tta"))
    torch.save({"mean": mean, "std": std}, os.path.join(out, "single_tta.pt"))
    tta_scale = max(1.0, mean.abs().max().item())
    del models
    torch.cuda.empty_cache()
    single_folds = mesh_fold_steps(cfg)
    torch.cuda.empty_cache()

    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc-per-node", str(MESH_RANKS), os.path.abspath(__file__),
                           "--mesh-rank", out], cwd=here,
                          env=dict(os.environ, PYTHONPATH=here, OMP_NUM_THREADS="4"),
                          capture_output=True, text=True, timeout=600)
    t_ranks = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"mesh ranks exited {proc.returncode}: {proc.stderr[-4000:]}")
    ranks = []
    for r in range(MESH_RANKS):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    log(f"  {MESH_RANKS} ranks: {t_ranks:.1f} s in all (start, build, 13a-13c); backend "
        f"{ranks[0]['backend']}; {smi}")
    # 13a
    for i, ref in enumerate(single):
        for r in ranks:
            got = r["metrics"][i]
            rel = {n: abs(got[n] - ref[n]) / max(abs(ref[n]), 1e-12) for n in FUSION_LOSSES}
            if not all(v <= TRAIN_LOSS_RTOL for v in rel.values()):
                raise AssertionError(f"13a step {i} rank {r['rank']}: losses off one "
                                     f"process's: {rel}")
        log(f"  13a step {i}: " + ", ".join(
            f"{n} one process {ref[n]:.6f} ranks "
            + "/".join(f"{r['metrics'][i][n]:.6f}" for r in ranks) for n in FUSION_LOSSES)
            + f" (tolerance rel {TRAIN_LOSS_RTOL:.0e}); grad norm one process "
            f"{ref['grad_norm']:.5f} ranks "
            + "/".join(f"{r['metrics'][i]['grad_norm']:.5f}" for r in ranks))
    for r in ranks:
        for g_, gap in r["gaps"].items():
            if not gap <= tols[g_]:
                raise AssertionError(f"13a rank {r['rank']} group {g_}: off one process's "
                                     f"step by {gap}, above {tols[g_]}")
        log(f"  13a rank {r['rank']}: parameters and statistics against one process's, per "
            f"group (difference over the update, L2; stats: max err over max(1, max|one|)) "
            + ", ".join(f"{k} {v:.3e} (tolerance {tols[k]:.3e})" for k, v in r["gaps"].items())
            + "; step ms by CUDA "
            f"events " + ", ".join(f"{t:.1f}" for t in r["step_ms"])
            + f"; peak {r['peak_gib']:.2f} GiB; one more step with every collective timed "
            f"apart: {r['timed_step_ms']:.1f} ms, of which {r['collective_ms']:.1f} ms in "
            f"{r['collectives']} all-reduces; {smi}")
    # 13b
    bound = TOL[torch.float32] * tta_scale
    launched = dict.fromkeys(COUNTERS, 0)
    for r in ranks:
        if not max(r["tta_err"]) <= bound:
            raise AssertionError(f"13b rank {r['rank']}: tta off one process's by "
                                 f"{r['tta_err']}, above {bound}")
        for q in r["requests"]:
            for k, v in q["counts"].items():
                launched[k] += v
        log(f"  13b rank {r['rank']}: tta fp32 B={B_SERVE} against one process's: mean "
            f"max_abs_err {r['tta_err'][0]:.3e}, std {r['tta_err'][1]:.3e} (tolerance "
            f"{bound:.3e}); tta_mc bf16 requests (ms, host clock, two ranks sharing one card: "
            f"no scaling figure) " + ", ".join(f"{q['ms']:.2f}" for q in r["requests"])
            + f"; launches a request {r['requests'][-1]['counts']}")
    log(f"  13b one process: tta_mc bf16 requests (ms, host clock) "
        + ", ".join(f"{t:.2f}" for t in one) + f"; {smi}")
    # 13c
    for r in ranks:
        for f, digest in r["folds"].items():
            if digest != single_folds[int(f)]:
                raise AssertionError(f"13c fold {f} on rank {r['rank']} differs from one "
                                     f"process's")
    owners = ", ".join(f"fold {f} on rank {r['rank']}" for r in ranks for f in r["folds"])
    log(f"  13c: {owners}: bit-equal to one process's multifold step ({MESH_FOLD_STEPS} "
        f"steps, B={MESH_FOLD_B}, deterministic algorithms)")
    # 13d: a mesh the card cannot hold
    expect_value_error("13d: run --mesh 2 on the one card",
                       lambda: cli.main(["run", "--mesh", "2", "--folds", "0"]))
    torch.distributed.destroy_process_group()
    log(f"  phase 13: {time.perf_counter() - t_phase:.1f} s")
    return launched


# ------------------------------------------------------------------ phase 14
# the model axis (tensor parallelism) on the one card: a 1x2 mesh, two ranks
# pinned to it with gloo, each a process of its own started by
# torch.distributed.run, running this file with --tp-rank
TP_RANKS = 2
TP_B, TP_STEPS = 4, 2  # 14d: global B=4, both ranks on the same rows
TP_MC_B = 2  # 14b's requests: each gather moves maps of B x views (x passes)
TP_INT8_MC_B = 4  # 14e(c): one argmax flip of 4 still meets TP_AGREE
TP_HYB_B = 2  # 14c
TP_INT8_TTA_B = 2  # 14e(b): B cut from 8 to keep the script inside its time limit
TP_STEP_SEED, TP_DROP_SEED = 71, 72
# kernel 2 at each neck site's shard: half of Cout, the whole (gathered) Cin
TP_NECKS = tuple((f"{name} shard", cin, cout // TP_RANKS, side)
                 for name, cin, cout, side in NECKS)
# a rank's launches a request: as one process's (phases 5 and 5b; the
# request's preprocessing launches kernel 7), kernel 2 on its shards
TP_HYBRID_EXPECT = HYBRID_EXPECT | {"dwi_normalize": 1}


def param_bytes(*models):
    return sum(p.numel() * p.element_size() for m in models for p in m.parameters())


def tp_train_steps(cfg, net, mesh=None, digests=None, peak=False, time_collectives=False):
    """14d: ``TP_STEPS`` fusion steps at global B=``TP_B`` on ``net`` (over
    ``mesh``: sharded, through ``make_spmd_step``); each step's metrics and
    CUDA-event ms, and a :class:`CollectiveTimer` that timed the last step's
    collectives apart where ``time_collectives``.  ``digests`` collects each
    step's digests of the replicated parameters' gradients (AdamW's input)."""
    from dmf_tpu_torch.parallel import make_spmd_step, shard_state
    from dmf_tpu_torch.parallel.tensor import parameter_shards
    from dmf_tpu_torch.train import fusion as fusion_mod

    fcfg, _, _, spec, step, hp, batches = mesh_fusion_setup(cfg, TP_STEPS, TP_B, TP_STEP_SEED,
                                                            net=net)
    state, g = TrainState.create(net, num_groups=4), gen(TP_DROP_SEED)
    run = step
    if mesh is not None:
        shard_state(state, mesh)
        run = make_spmd_step(step, mesh)
    plain = fusion_mod.adamw_update
    if digests is not None:
        import hashlib

        def recorded(params, grads, *a, **k):
            shards = parameter_shards(net)
            digests.append({n: hashlib.sha256(g.detach().float().cpu().contiguous().numpy()
                                              .tobytes()).hexdigest()
                            for n, g in grads.items() if g is not None and n not in shards})
            return plain(params, grads, *a, **k)

        fusion_mod.adamw_update = recorded
    if peak:
        torch.cuda.reset_peak_memory_stats()
    metrics, ms = [], []
    timer = CollectiveTimer() if time_collectives else None
    # deterministic algorithms (as phase 10): the bilinear upsample's
    # backward adds by atomics otherwise, and the two ranks' replicated
    # gradients would differ by rounding
    try:
        with deterministic():
            for i, b in enumerate(batches):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                if mesh is not None:
                    mesh.barrier()
                last = timer is not None and i == len(batches) - 1
                with timer if last else contextlib.nullcontext():
                    ev[0].record()
                    m = run(state, b, g, hp)
                    ev[1].record()
                    torch.cuda.synchronize()
                metrics.append({k: float(v) for k, v in m.items()})
                ms.append(ev[0].elapsed_time(ev[1]))
    finally:
        fusion_mod.adamw_update = plain
    return metrics, ms, state, timer


# 14e: int8 serving over the model axis, built as test_fusion_model builds it
# (the models sharded, then quantized and calibrated on INT8_CALIB volumes of
# their own draw; in bf16 with MC dropout on, for tta_mc).  A rank's
# calibrated x_scale against one process's, relative: the scales are
# abs-maxes of the whole conv inputs, which differ from one process's only by
# the rounding of the sharded fp convs before them (cuDNN may pick another
# algorithm at half the channels), in bf16 by a few ulps (2^-8) grown through
# the layers; a wrong shard, or MC masks drawn in another memory order, is off
# by far more (10 % at block3's convs, before the shards kept their weights'
# strides)
TP_INT8_SEED = 141
TP_SCALE_RTOL = {"fp32": 1e-5, "bf16": 2.0 ** -5}
TP_AGREE = 0.75  # 14e(c): argmax agreement with one process's int8 request


def tp_int8_forward(cfg, dtype, mesh=None):
    """14e's int8 serving: the default fusion models from ``SEED`` in
    ``dtype``, sharded over ``mesh``'s model axis first, their convs
    quantized from the fp32 weights (fp32: from the models themselves, on a
    mesh from the shards; bf16: from whole fp32 twins, cut to the shards)
    and calibrated on 14e's volumes; ``(models, qsets, fwd)``."""
    from dmf_tpu_torch.parallel.tensor import tensor_parallel

    weights = build_fusion_models(cfg, DEV, torch.float32, gen(SEED))
    fp32 = dtype == torch.float32
    models = weights if fp32 else [copy.deepcopy(m).to(dtype) for m in weights]
    if mesh is not None:
        for m in models:
            tensor_parallel(m, mesh)
    S = cfg.dwi_model.input_size
    g = gen(TP_INT8_SEED)
    calib = preprocess_fusion_inputs(
        torch.rand(INT8_CALIB, S, S, cfg.dwi_base_channel_num, device=DEV, generator=g) * 1000.0,
        torch.rand(INT8_CALIB, S, S, cfg.dce_channel_num, device=DEV, generator=g),
        torch.full((S, S, 1), 0.5, device=DEV))
    _, qsets = int8q.make_quantized_fusion_apply(
        *models, calibration=calib, calibration_mc=not fp32,
        calibration_rng=None if fp32 else gen(TP_INT8_SEED + 1),
        weights=None if fp32 else weights)
    del weights, calib
    return models, qsets, int8q.make_quantized_fusion_fwd(*models, qsets)


def x_scales(qsets):
    """The calibrated scales (convs the calibration forward did not reach have none)."""
    return {f"{k}:{n}": float(e["x_scale"]) for k, qs in qsets.items() for n, e in qs.items()
            if "x_scale" in e}


def scale_gap(mine, ref):
    """The largest relative gap of a rank's calibrated scales to one process's."""
    if mine.keys() != ref.keys():
        raise AssertionError(f"14e: the rank quantized other convs: "
                             f"{sorted(mine.keys() ^ ref.keys())[:5]}")
    return max(abs(mine[k] - ref[k]) / ref[k] for k in ref)


def int8_bytes(fwd):
    """``(parameter bytes, int8-conv buffer bytes)`` of an int8 forward's copies."""
    mods = list(fwd.modules.values())
    q = sum(b.numel() * b.element_size() for mod in mods for m in mod.modules()
            if isinstance(m, int8q.QuantConv2d) for b in m.buffers())
    return param_bytes(*mods), q


def tp_int8_rank(cfg, mesh, out, res):
    """14e(b) and (c) on this rank: an int8 tta fp32 request and one int8
    tta_mc bf16 request on the sharded, quantized and calibrated models."""
    # (b) tta fp32, static scales calibrated on the shards
    models, qsets, fwd = tp_int8_forward(cfg, torch.float32, mesh)
    ref = torch.load(os.path.join(out, "single_int8_tta.pt"), map_location=DEV,
                     weights_only=True)
    res["int8_scale_gap"] = scale_gap(x_scales(qsets), ref["scales"])
    shards = [(m.weight_q.shape[0], m.out_channels) for mod in fwd.modules.values()
              for m in mod.modules() if isinstance(m, int8q.ShardedQuantConv2d)]
    res["int8_shards"] = [len(shards), sum(o * TP_RANKS == whole for o, whole in shards)]
    predict = make_fusion_predictor(cfg, *models, mode="tta", fwd_override=fwd, mesh=mesh)
    reset_counts()
    mean, std, _ = mesh_request(cfg, predict, b=TP_INT8_TTA_B)
    res["int8_tta_counts"] = counts()
    res["int8_tta_err"] = [(mean - ref["mean"]).abs().max().item(),
                           (std - ref["std"]).abs().max().item()]
    del models, qsets, fwd, predict
    torch.cuda.empty_cache()
    # (c) one tta_mc bf16 request, no warm-up, the MC dropout's calibration
    models, qsets, fwd = tp_int8_forward(cfg, torch.bfloat16, mesh)
    ref = torch.load(os.path.join(out, "single_int8_tta_mc.pt"), map_location=DEV,
                     weights_only=True)
    res["int8_mc_scale_gap"] = scale_gap(x_scales(qsets), ref["scales"])
    predict = make_fusion_predictor(cfg, *models, mode="tta_mc", fwd_override=fwd, mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with CollectiveTimer() as timer:
        mesh.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean, std, _ = mesh_request(cfg, predict, b=TP_INT8_MC_B)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launched = counts()
    gate("tp int8 tta_mc", cfg, launched, ref["counts"], mean, std, True, TP_INT8_MC_B)
    res["int8_request"] = {
        "ms": dt * 1e3, "collective_ms": timer.ms, "collectives": timer.n, "counts": launched,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "bytes": int8_bytes(fwd),
        "agree": (mean.argmax(-1) == ref["mean"].argmax(-1)).float().mean().item(),
        "mean_err": (mean.float() - ref["mean"].float()).abs().max().item()}
    del models, qsets, fwd, predict
    torch.cuda.empty_cache()


def tp_rank_main(out):
    """One rank of phase 14 (``python -m torch.distributed.run
    --nproc-per-node 2 chip_smoke.py --tp-rank OUT``): 14b-14d on a 1x2
    mesh; its results into ``OUT/rank<r>.json``."""
    from dmf_tpu_torch.parallel import make_mesh
    from dmf_tpu_torch.parallel.sharding import full_state_dict
    from dmf_tpu_torch.parallel.tensor import parameter_shards

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(1, TP_RANKS, devices=[DEV] * TP_RANKS)
    cfg = default_parameters()
    hcfg = hybrid_nb_config(cfg)
    res = {"rank": mesh.model_rank, "backend": mesh.backend, "seconds": {}}
    t_sub = time.perf_counter()
    # 14b: tta fp32 against one process's
    models = build_fusion_models(cfg, DEV, torch.float32, gen(SEED))
    whole = param_bytes(*models)
    predict = make_fusion_predictor(cfg, *models, mode="tta", mesh=mesh)
    res["param_bytes"] = [whole, param_bytes(*models)]
    res["sharded"] = sum(len(parameter_shards(m)) for m in models)
    mean, std, _ = mesh_request(cfg, predict, b=TP_MC_B)
    ref = torch.load(os.path.join(out, "single_tta.pt"), map_location=DEV, weights_only=True)
    res["tta_err"] = [(mean - ref["mean"]).abs().max().item(),
                      (std - ref["std"]).abs().max().item()]
    del models, predict
    torch.cuda.empty_cache()
    # 14b: tta_mc bf16 requests, launches counted per request
    models = build_fusion_models(cfg, DEV, torch.bfloat16, gen(SEED))
    predict = make_fusion_predictor(cfg, *models, mode="tta_mc", mesh=mesh)
    res["param_bytes_bf16"] = param_bytes(*models)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    # one request at B=TP_MC_B (no warm-up: each gathers ~3.5 GB over gloo), its
    # collectives timed apart
    with CollectiveTimer() as timer:
        mesh.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean, std, _ = mesh_request(cfg, predict, b=TP_MC_B)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    gate("tp tta_mc", cfg, counts(), MESH_SERVE_EXPECT, mean, std, True, TP_MC_B)
    res["requests"] = [{"ms": dt * 1e3, "counts": counts()}]
    res["serve_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    res["request_collective_ms"], res["request_collectives"] = timer.ms, timer.n
    del models, predict
    torch.cuda.empty_cache()
    res["seconds"]["14b"], t_sub = time.perf_counter() - t_sub, time.perf_counter()
    # 14c: hybrid-nb tta fp32 at B=2, the flash forward on this rank's heads
    models = build_fusion_models(hcfg, DEV, torch.float32, gen(SEED))
    predict = make_fusion_predictor(hcfg, *models, mode="tta", mesh=mesh)
    res["hybrid_heads"] = models[0].transformer.transformer.layers[0].attn.qkv.weight.shape[0]
    reset_counts()
    mean, std, _ = mesh_request(hcfg, predict, b=TP_HYB_B)
    res["hybrid_counts"] = counts()
    gate("tp hybrid-nb tta", hcfg, res["hybrid_counts"], TP_HYBRID_EXPECT, mean, std, False,
         TP_HYB_B)
    ref = torch.load(os.path.join(out, "single_hybrid.pt"), map_location=DEV, weights_only=True)
    res["hybrid_err"] = [(mean - ref["mean"]).abs().max().item(),
                         (std - ref["std"]).abs().max().item()]
    del models, predict
    torch.cuda.empty_cache()
    res["seconds"]["14c"], t_sub = time.perf_counter() - t_sub, time.perf_counter()
    # 14d: the fusion train steps, sharded
    fcfg, net, init, spec, *_ = mesh_fusion_setup(cfg, TP_STEPS, TP_B, TP_STEP_SEED)
    whole = copy.deepcopy(net)
    digests = []
    res["metrics"], res["step_ms"], state, timer = tp_train_steps(
        cfg, net, mesh, digests, peak=True, time_collectives=True)
    res["step_collective_ms"], res["step_collectives"] = timer.ms, timer.n
    res["train_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    res["train_param_bytes"] = [param_bytes(whole), param_bytes(net)]
    res["digests"] = digests
    whole.load_state_dict(full_state_dict(state)["model"])
    single = copy.deepcopy(whole)
    single.load_state_dict(torch.load(os.path.join(out, "single_fusion.pt"), map_location=DEV,
                                      weights_only=True))
    res["gaps"] = {str(k): v for k, v in disagreement(whole, single, init, spec).items()}
    del single, whole, state
    torch.cuda.empty_cache()
    res["seconds"]["14d"], t_sub = time.perf_counter() - t_sub, time.perf_counter()
    # 14e: int8 serving over the model axis
    tp_int8_rank(cfg, mesh, out, res)
    res["seconds"]["14e"] = time.perf_counter() - t_sub
    with open(os.path.join(out, f"rank{mesh.model_rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


def phase_tp_kernels():
    """14a: kernel 2 at the neck sites' shard shapes."""
    log(f"== phase 14a: conv3x3_bn_gelu (CUDA) vs plain at the neck sites' shard shapes on a "
        f"{TP_RANKS}-way model axis (Cout halved, the whole Cin), N={B_VAL}")
    g = gen(14)
    errs, sums = conv_bf16(B_VAL, g, TP_NECKS)
    errs += conv_f32(B_VAL, g, TP_NECKS)
    return max(errs), sums


def shard_sites(cfg, predict, modules):
    """The int8 convs of one request that a ``TP_RANKS``-way model axis
    shards (``param_spec`` on the conv's name and whole shape): ``{shard
    shape: calls}``, the shape's Cout a shard's, and a whole module of each."""
    from dmf_tpu_torch.parallel.sharding import param_spec

    sites, mods, hooks = {}, {}, []

    def hook_for(name):
        def hook(m, args):
            n, c, h, w = args[0].shape
            whole = torch.empty((m.out_channels, c, *m.kernel_size), device="meta")
            if param_spec(f"{name}.weight", whole, TP_RANKS) is None:
                return
            key = (n, c, h, w, m.out_channels // TP_RANKS, *m.kernel_size, tuple(m.stride),
                   tuple(m.padding), tuple(m.dilation))
            sites[key] = sites.get(key, 0) + 1
            mods.setdefault(key, m)
        return hook

    for model in modules:
        hooks += [m.register_forward_pre_hook(hook_for(name))
                  for name, m in model.named_modules() if isinstance(m, int8q.QuantConv2d)]
    mesh_request(cfg, predict)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    return sites, mods


def phase_tp_int8_kernels(sites, mods):
    """14e(a): the int8 conv at every distinct shard shape (model rank 0's
    rows of the weight, its scales and bias) against its plain version,
    beside the whole conv's time and cuDNN's bf16 conv at the shard shape;
    the sums over a request (each shape x its calls)."""
    regs = int8_registers()
    g = gen(142)
    tot = dict.fromkeys(("ms", "whole_ms", "plain", "bound", "cudnn", "ops"), 0.0)
    log(f"  14e(a): {len(sites)} distinct shard shapes of the sharded int8 convs, "
        f"{sum(sites.values())} calls a request (N, Cin, HxW -> a shard's Cout, kernel, "
        f"stride, padding, dilation; bf16 out)")
    for key, calls in sorted(sites.items(), key=lambda kv: -int8_conv_bound(kv[0])[0]):
        n, c, h, w, o, kh, kw, st, p, d = key
        m = mods[key]
        rows = (m.weight_q[:o].contiguous(), m.w_scale[:o].contiguous(),
                None if m.bias is None else m.bias[:o].contiguous())
        t_k, t_p, t_c, xq, _ = int8_conv_case(key, rows[0], rows[1], m.x_scale, rows[2], g)
        xs = m.x_scale if m.x_scale is not None else torch.tensor(0.01, device=DEV)
        t_w = cuda_time(lambda: int8_cuda.launch_int8_conv(
            xq, m.weight_q, m.w_scale, xs, m.bias, st, p, d, torch.bfloat16))
        ops, _, bound = int8_conv_bound(key)
        for k_, v in (("ms", t_k), ("whole_ms", t_w), ("plain", t_p), ("bound", bound),
                      ("cudnn", t_c), ("ops", ops)):
            tot[k_] += v * calls
        tile = (int8_cuda.conv_tile(o), int8_cuda.pixel_source(xq))
        log(f"  14e(a) ({n}, {c}, {h}x{w} -> {o} of {2 * o}, {kh}x{kw}, s{st[0]}, p{p[0]}, "
            f"d{d[0]}) x{calls}: int32 and bf16 bit-equal, two calls bit-equal; shard "
            f"{t_k:.4f} ms ({ops / t_k / 1e9:.1f} TOP/s, {100 * bound / t_k:.1f} % of the bound "
            f"{bound:.4f}), whole conv {t_w:.4f} ({t_k / t_w:.3f}x), plain (float64) "
            f"{t_p:.3f}, cuDNN bf16 conv at the shard {t_c:.4f} ({t_k / t_c:.2f}x); tile "
            f"{tile[0]} {INT8_SOURCES[tile[1]]}: {regs.get(tile, 'no ptxas report')}")
    log(f"  14e(a) per request and rank (each shape's time x its calls): int8 conv on the shards "
        f"{tot['ms']:.3f} ms ({tot['ops'] / tot['ms'] / 1e9:.1f} TOP/s, "
        f"{100 * tot['bound'] / tot['ms']:.1f} % of the bound {tot['bound']:.3f}) against the "
        f"whole convs' {tot['whole_ms']:.3f} ms in one process; plain {tot['plain']:.1f}; cuDNN's "
        f"bf16 convs at the shards {tot['cudnn']:.3f} ({tot['ms'] / tot['cudnn']:.2f}x)")
    return {"ms": tot["ms"], "whole_ms": tot["whole_ms"], "plain_ms": tot["plain"],
            "bound_ms": tot["bound"], "cudnn_bf16_ms": tot["cudnn"],
            "per": f"the int8 convs a {TP_RANKS}-way model axis shards, one rank's shards, an "
                   f"int8 tta_mc request at B={B_SERVE}, bf16"}


def tp_int8_references(cfg, out):
    """14e's one-process runs: the int8 tta fp32 request and the int8
    tta_mc bf16 one (no warm-up; its launches, ms, peak and bytes) that the
    ranks are held against; then 14e(a) on that request's shard sites."""
    models, qsets, fwd = tp_int8_forward(cfg, torch.float32)
    mean, std, _ = mesh_request(cfg, make_fusion_predictor(cfg, *models, mode="tta",
                                                           fwd_override=fwd), b=TP_INT8_TTA_B)
    torch.save({"mean": mean, "std": std, "scales": x_scales(qsets)},
               os.path.join(out, "single_int8_tta.pt"))
    tta_scale = max(1.0, mean.abs().max().item())
    del models, qsets, fwd
    torch.cuda.empty_cache()
    models, qsets, fwd = tp_int8_forward(cfg, torch.bfloat16)
    predict = make_fusion_predictor(cfg, *models, mode="tta_mc", fwd_override=fwd)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean, std, _ = mesh_request(cfg, predict, b=TP_INT8_MC_B)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launched = counts()
    one = {"ms": ms, "counts": launched, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "bytes": int8_bytes(fwd), "tta_scale": tta_scale}
    base = dict.fromkeys(COUNTERS, 0) | {"se_epilogue": 12, "keep_mask": 12, "se_scale": 4,
                                         "dwi_normalize": 1}
    n = launched["int8_conv"]
    if not (n > 0 and launched == base | {"int8_conv": n, "int8_quantize": n}):
        raise AssertionError(f"14e one process's int8 tta_mc request launched {launched}")
    gate("14e one process int8 tta_mc", cfg, launched, launched, mean, std, True, TP_INT8_MC_B)
    torch.save({"mean": mean, "counts": launched, "scales": x_scales(qsets)},
               os.path.join(out, "single_int8_tta_mc.pt"))
    sites, mods = shard_sites(cfg, predict, fwd.modules.values())
    one["sums"] = phase_tp_int8_kernels(sites, mods)
    del models, qsets, fwd, predict, mods
    torch.cuda.empty_cache()
    return one


def phase_tp(cfg, tmp, smi):
    """Phase 14: the model axis on a 1x2 mesh; returns the ranks' launches."""
    from dmf_tpu_torch.parallel import local_mesh

    t_phase = time.perf_counter()
    log(f"== phase 14: the model axis (parallel/tensor.py) on a 1x{TP_RANKS} mesh at full "
        f"width: {TP_RANKS} ranks pinned to the one card with gloo; 14b the default fusion "
        f"predictor sharded (tta fp32 against one process's, tta_mc bf16 B={TP_MC_B}), 14c "
        f"hybrid-nb tta fp32 B={TP_HYB_B}, 14d {TP_STEPS} fusion train steps at global "
        f"B={TP_B} fp32 (dropout 0), 14e int8 serving")
    err14a, sums14a = phase_tp_kernels()
    hcfg = hybrid_nb_config(cfg)
    out = os.path.join(tmp, "tp")
    os.makedirs(out)
    # one process's runs first, the references the ranks read
    models = build_fusion_models(cfg, DEV, torch.float32, gen(SEED))
    mean, std, _ = mesh_request(cfg, make_fusion_predictor(cfg, *models, mode="tta"), b=TP_MC_B)
    torch.save({"mean": mean, "std": std}, os.path.join(out, "single_tta.pt"))
    tta_scale = max(1.0, mean.abs().max().item())
    del models
    models = build_fusion_models(hcfg, DEV, torch.float32, gen(SEED))
    mean, std, _ = mesh_request(hcfg, make_fusion_predictor(hcfg, *models, mode="tta"),
                                b=TP_HYB_B)
    torch.save({"mean": mean, "std": std}, os.path.join(out, "single_hybrid.pt"))
    hyb_scale = max(1.0, mean.abs().max().item())
    del models
    torch.cuda.empty_cache()
    one_ms = []
    models = build_fusion_models(cfg, DEV, torch.bfloat16, gen(SEED))
    predict = make_fusion_predictor(cfg, *models, mode="tta_mc")
    mesh_request(cfg, predict, b=TP_MC_B)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(REQUESTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh_request(cfg, predict, b=TP_MC_B)
        torch.cuda.synchronize()
        one_ms.append((time.perf_counter() - t0) * 1e3)
    one_serve_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    one_bytes = param_bytes(*models)
    del models, predict
    torch.cuda.empty_cache()
    # 14d's references: one process, the same in another memory format
    # (phase 7c's floor), and a 1x1 mesh over NCCL (13d's floor)
    _, net, init, spec, *_ = mesh_fusion_setup(cfg, TP_STEPS, TP_B, TP_STEP_SEED)
    alt = copy.deepcopy(net).to(memory_format=torch.contiguous_format)
    nccl = copy.deepcopy(net)
    single, single_ms, *_ = tp_train_steps(cfg, net, peak=True)
    one_train_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tp_train_steps(cfg, alt)
    layout = {str(k): v for k, v in disagreement(alt, net, init, spec).items()}
    del alt
    tp_train_steps(cfg, nccl, local_mesh(DEV), peak=True)
    # the mesh route's peak alone (BatchNorm's two passes over the group's
    # sums in fp32, no sharding), beside one process's and the ranks'
    route_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    route = {str(k): v for k, v in disagreement(nccl, net, init, spec).items()}
    del nccl
    tols = {g_: 0.0 if g_ == "-1" else
            max(TRAIN_FLOOR, FUSION_FLOOR_MARGIN * max(layout[g_], route[g_]))
            for g_ in layout}
    torch.save(net.state_dict(), os.path.join(out, "single_fusion.pt"))
    del net
    torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()
    log(f"== phase 14e: int8 serving over the model axis (ops/quant.py's shard route): the "
        f"models sharded, quantized and calibrated on {INT8_CALIB} volumes; (a) here, (b) a "
        f"tta fp32 request of B={TP_INT8_TTA_B} and (c) one tta_mc bf16 request of "
        f"B={TP_INT8_MC_B} on each rank")
    one = tp_int8_references(cfg, out)

    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc-per-node", str(TP_RANKS), os.path.abspath(__file__),
                           "--tp-rank", out], cwd=here,
                          env=dict(os.environ, PYTHONPATH=here, OMP_NUM_THREADS="4",
                                   CUBLAS_WORKSPACE_CONFIG=":4096:8"),
                          capture_output=True, text=True, timeout=600)
    t_ranks = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"tp ranks exited {proc.returncode}: {proc.stderr[-4000:]}")
    ranks = []
    for r in range(TP_RANKS):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    log(f"  {TP_RANKS} ranks: {t_ranks:.1f} s in all (start, build, 14b-14d); backend "
        f"{ranks[0]['backend']}; seconds a sub-phase (rank 0) "
        + ", ".join(f"{k} {v:.1f}" for k, v in ranks[0]["seconds"].items()) + f"; {smi}")
    # 14b
    launched = dict.fromkeys(COUNTERS, 0)
    bound = TOL[torch.float32] * tta_scale
    for r in ranks:
        if not max(r["tta_err"]) <= bound:
            raise AssertionError(f"14b rank {r['rank']}: tta off one process's by "
                                 f"{r['tta_err']}, above {bound}")
        for q in r["requests"]:
            for k, v in q["counts"].items():
                launched[k] += v
        whole, mine = r["param_bytes"]
        log(f"  14b rank {r['rank']}: {r['sharded']} parameters sharded; fp32 parameter bytes "
            f"{mine / 2 ** 20:.1f} MiB of the whole {whole / 2 ** 20:.1f} MiB (bf16 "
            f"{r['param_bytes_bf16'] / 2 ** 20:.1f} MiB); tta fp32 B={TP_MC_B} against one "
            f"process's: mean max_abs_err {r['tta_err'][0]:.3e}, std {r['tta_err'][1]:.3e} "
            f"(tolerance {bound:.3e}); tta_mc bf16 request of B={TP_MC_B} (host clock, no "
            f"warm-up, two ranks sharing one card, every collective timed apart) "
            f"{r['requests'][0]['ms']:.2f} ms, of which {r['request_collective_ms']:.1f} ms in "
            f"{r['request_collectives']} collectives; peak {r['serve_peak_gib']:.2f} GiB; "
            f"launches a request {r['requests'][-1]['counts']}")
    log(f"  14b one process: tta_mc bf16 requests of B={TP_MC_B} (ms, host clock) "
        + ", ".join(f"{t:.2f}" for t in one_ms) + f"; peak {one_serve_peak:.2f} GiB; bf16 "
        f"parameter bytes {one_bytes / 2 ** 20:.1f} MiB; {smi}")
    # 14c
    bound = TOL[torch.float32] * hyb_scale
    for r in ranks:
        if not max(r["hybrid_err"]) <= bound:
            raise AssertionError(f"14c rank {r['rank']}: hybrid-nb tta off one process's by "
                                 f"{r['hybrid_err']}, above {bound}")
        for k, v in r["hybrid_counts"].items():
            launched[k] += v
        log(f"  14c rank {r['rank']}: hybrid-nb tta fp32 B={TP_HYB_B}: qkv rows "
            f"{r['hybrid_heads']} of {3 * hcfg.dwi_model.transformer_embed_dim} (the q, k and "
            f"v of {r['hybrid_heads'] // 3 // (hcfg.dwi_model.transformer_embed_dim // hcfg.dwi_model.transformer_heads)} "
            f"heads); against one process's: mean max_abs_err {r['hybrid_err'][0]:.3e}, std "
            f"{r['hybrid_err'][1]:.3e} (tolerance {bound:.3e}); launches {r['hybrid_counts']}")
    # 14d
    for i, ref in enumerate(single):
        for r in ranks:
            got = r["metrics"][i]
            rel = {n: abs(got[n] - ref[n]) / max(abs(ref[n]), 1e-12) for n in FUSION_LOSSES}
            if not all(v <= TRAIN_LOSS_RTOL for v in rel.values()):
                raise AssertionError(f"14d step {i} rank {r['rank']}: losses off one "
                                     f"process's: {rel}")
        log(f"  14d step {i}: " + ", ".join(
            f"{n} one process {ref[n]:.6f} ranks "
            + "/".join(f"{r['metrics'][i][n]:.6f}" for r in ranks) for n in FUSION_LOSSES)
            + f" (tolerance rel {TRAIN_LOSS_RTOL:.0e}); grad norm one process "
            f"{ref['grad_norm']:.5f} ranks "
            + "/".join(f"{r['metrics'][i]['grad_norm']:.5f}" for r in ranks))
    for a, b in zip(ranks[0]["digests"], ranks[1]["digests"]):
        if not a or a != b:
            raise AssertionError("14d: the replicated parameters' gradients differ between "
                                 "the model ranks: "
                                 + str([k for k in a if a[k] != b.get(k)][:5]))
    for r in ranks:
        for g_, gap in r["gaps"].items():
            if not gap <= tols[g_]:
                raise AssertionError(f"14d rank {r['rank']} group {g_}: off one process's "
                                     f"steps by {gap}, above {tols[g_]}")
        whole, mine = r["train_param_bytes"]
        log(f"  14d rank {r['rank']}: parameters and statistics against one process's, per "
            f"group " + ", ".join(f"{k} {v:.3e} (tolerance {tols[k]:.3e})"
                                  for k, v in r["gaps"].items())
            + f"; the gradients of {len(r['digests'][0])} replicated parameters bit-equal on "
            f"both ranks at each step; step ms by CUDA events "
            + ", ".join(f"{t:.1f}" for t in r["step_ms"]) + f"; peak {r['train_peak_gib']:.2f} "
            f"GiB; parameter bytes {mine / 2 ** 20:.1f} of {whole / 2 ** 20:.1f} MiB; the last "
            f"step's collectives timed apart: {r['step_collective_ms']:.1f} ms in "
            f"{r['step_collectives']} collectives; {smi}")
    log(f"  14d one process: step ms by CUDA events " + ", ".join(f"{t:.1f}" for t in single_ms)
        + f"; peak {one_train_peak:.2f} GiB (the 1x1 NCCL mesh's route: {route_peak:.2f} "
        f"GiB); floors: one process in contiguous memory format "
        + ", ".join(f"{k} {v:.3e}" for k, v in layout.items()) + "; a 1x1 mesh over NCCL "
        + ", ".join(f"{k} {v:.3e}" for k, v in route.items()))
    # 14e
    bound = INT8_CPU_TOL * one["tta_scale"]
    for r in ranks:
        n_sh, n_rows = r["int8_shards"]
        if not (n_sh > 0 and n_rows == n_sh):
            raise AssertionError(f"14e rank {r['rank']}: {n_rows} of {n_sh} int8 shards hold "
                                 f"1/{TP_RANKS} of their conv's rows")
        if not max(r["int8_tta_err"]) <= bound:
            raise AssertionError(f"14e(b) rank {r['rank']}: int8 tta off one process's by "
                                 f"{r['int8_tta_err']}, above {bound}")
        if not (r["int8_scale_gap"] <= TP_SCALE_RTOL["fp32"]
                and r["int8_mc_scale_gap"] <= TP_SCALE_RTOL["bf16"]):
            raise AssertionError(f"14e rank {r['rank']}: calibrated scales off one process's by "
                                 f"rel {r['int8_scale_gap']} (fp32), {r['int8_mc_scale_gap']} "
                                 f"(bf16), above {TP_SCALE_RTOL}")
        q = r["int8_request"]
        if not (q["agree"] >= TP_AGREE and q["mean_err"] <= 0.05):
            raise AssertionError(f"14e(c) rank {r['rank']}: argmax agreement {q['agree']}, max "
                                 f"mean-prob error {q['mean_err']} against one process's")
        tta = r["int8_tta_counts"]
        if not (tta["int8_conv"] > 0 and tta["conv3x3_bn_gelu"] == 0):
            raise AssertionError(f"14e(b) rank {r['rank']}: launches {tta}")
        for k in COUNTERS:
            launched[k] += tta[k] + q["counts"][k]
        (p_b, q_b), (one_p, one_q) = q["bytes"], one["bytes"]
        log(f"  14e rank {r['rank']}: {n_sh} int8 convs on their shards (weight_q rows 1/"
            f"{TP_RANKS} of the conv's); calibrated x_scale against one process's: max rel "
            f"{r['int8_scale_gap']:.3e} (fp32), {r['int8_mc_scale_gap']:.3e} (bf16, MC on) "
            f"(tolerances {TP_SCALE_RTOL}); (b) int8 tta fp32 B={TP_INT8_TTA_B}: mean max_abs_err "
            f"{r['int8_tta_err'][0]:.3e}, std {r['int8_tta_err'][1]:.3e} (tolerance "
            f"{bound:.3e}); (c) int8 tta_mc bf16 B={TP_INT8_MC_B}, no warm-up: {q['ms']:.1f} ms (host "
            f"clock, collectives timed apart: {q['collective_ms']:.1f} ms in "
            f"{q['collectives']} collectives), argmax agreement with one process's on the same "
            f"masks {q['agree']:.3f} (gate {TP_AGREE}), max mean-prob error {q['mean_err']:.3e}; "
            f"peak {q['peak_gib']:.2f} GiB; parameters {p_b / 2 ** 20:.1f} MiB + int8 convs "
            f"{q_b / 2 ** 20:.1f} MiB (one process {one_p / 2 ** 20:.1f} + "
            f"{one_q / 2 ** 20:.1f}); launches {q['counts']}")
    log(f"  14e one process: int8 tta_mc bf16 B={TP_INT8_MC_B}, no warm-up: {one['ms']:.1f} ms (host "
        f"clock), peak {one['peak_gib']:.2f} GiB; launches {one['counts']}; {smi}")
    log(f"  phase 14: {time.perf_counter() - t_phase:.1f} s")
    return launched, err14a, sums14a, one["sums"]


# ------------------------------------------------------------------ phase 17
# hybrid-nb training at full width on the flash route (the training route's
# attention dropout in the dropout forward, dQ and dK/dV kernels): (a) the
# bench's fusion train step (bf16 compute on fp32 parameters) at the config's
# B=32; (b) a hybrid-nb DWI fold's first stage, run_single_model at B=32 in
# fp32 (HYB_RUN_TRAIN + HYB_RUN_TEST volumes, one epoch, the tta_mc test at
# mc_chunk 1); (c) one fp32 fusion train step at B_FUSION_F32; (d) the DWI
# train step at B_ROUTES on the flash route and on the weights route in turns
HYB_BENCH_ARGV = ["--train", "--encoder", "hybrid-nb", "--batch", "32", "--warmup", "1",
                  "--steps", "3"]
HYB_RUN_TRAIN, HYB_RUN_TEST = 120, 32
# the fp32 fusion step at the largest power of two that fits the 80 GB
# card: at B=16 it peaked at 44.81 GiB on the H100, and B=32 ran out of
# memory at 76.45 GiB allocated (two hybrid-nb encoders' activations, ~2.8
# GB a block at 16 volumes; ROADMAP 2b.24)
B_FUSION_F32 = 16
B_ROUTES, ROUTE_STEPS = 4, 2


def flash_train_expect(depth, steps, encoders):
    """The training route's launches over ``steps`` train steps of
    ``encoders`` hybrid-nb encoders: each fused attention site one dropout
    forward (head-shared), one dQ and one dK/dV dropout instance."""
    n = depth * encoders * steps
    return {"flash_attention_fwd_dropout": n, DROP_INSTANCES["head_shared"]: n,
            "flash_attention_bwd_dq_dropout": n, "flash_attention_bwd_dkv_dropout": n}


def hybrid_bench_train(depth):
    """17(a): ``bench --train --encoder hybrid-nb --batch 32`` in-process."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = bench.main(HYB_BENCH_ARGV)
    dt = time.perf_counter() - t0
    launched = counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    args = bench.parse_args(HYB_BENCH_ARGV)
    line = bench_line("17a hybrid-nb train", out.getvalue(), result)
    calls = 1 + args.warmup + args.steps  # the FLOP count's step, warm-up, timed
    expect = dict.fromkeys(COUNTERS, 0) | flash_train_expect(depth, calls, 2)
    log(f"  17a bench {' '.join(HYB_BENCH_ARGV)}: {dt:.1f} s, peak {peak:.2f} GiB: {line}")
    if result["metric"] != "fusion_training_throughput" or launched != expect:
        raise AssertionError(f"17a: launched {launched}, expected {expect}; line {line}")
    step_ms = 1e3 / result["value"]
    log(f"  17a: {result['value']:.3f} steps/s, {step_ms:.1f} ms a step (host clock over "
        f"{args.steps} steps), launches per encoder per step 6 / 6 / 6 (dropout forward, dQ, "
        f"dK/dV)")
    return launched, {"steps_per_s": result["value"], "step_ms": step_ms, "peak_gib": peak,
                      "batch": args.batch}


def hybrid_run_single(hcfg, raw, tmp, depth):
    """17(b): ``run_single_model(hcfg, "dwi")`` at B=32 in fp32, one epoch
    of a few steps, its validation and its tta_mc test (mc_chunk 1)."""
    B = hcfg.batch_size
    store = {"imgs": raw["dwi"][:HYB_RUN_TRAIN], "test_imgs": raw["dwi_test"][:HYB_RUN_TEST],
             "labels": raw["labels"][:HYB_RUN_TRAIN],
             "test_labels": raw["labels_test"][:HYB_RUN_TEST],
             "masks": raw["masks"][:HYB_RUN_TRAIN]}
    rcfg0 = hcfg.replace(mc_chunk=1, base_path=os.path.join(tmp, "hybrid_data"))
    data = prepare_single_data(rcfg0, "dwi", 0, raw=store, device=DEV)
    n_tr, n_va = len(data.splits["train"]["labels"]), len(data.splits["val"]["labels"])
    model, rcfg = build_single_model(rcfg0, "dwi", device=DEV, generator=gen(SEED))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out, t_run = synced(lambda: run_single_model(
        rcfg, "dwi", 0, data=data, state=TrainState.create(model), num_epochs=1, min_epochs=1,
        base_dir=os.path.join(tmp, "hybrid_results"), device=DEV))
    launched = counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_steps, n_val, n_test = -(-n_tr // B), -(-n_va // B), -(-HYB_RUN_TEST // B)
    # the train steps' sites, then the test's: 10 suffix forwards a batch at mc_chunk 1
    want = flash_train_expect(depth, n_steps, 1)
    mc = depth * rcfg.mc_passes * n_test
    want["flash_attention_fwd_dropout"] += mc
    want[DROP_INSTANCES["head_shared"]] += mc
    want["flash_attention_fwd"] = depth * (n_val + drawn(1))  # validation and its triptych
    got = {k: launched[k] for k in want}
    hist = out["history"][0]
    step_ms = [t for _, t in out["step_ms"]]
    # full batches after the first (a short tail batch ends the epoch)
    full = [t for i, t in enumerate(step_ms) if i and (i < n_steps - 1 or n_tr % B == 0)]
    log(f"  17b run_single_model('dwi'), hybrid-nb, B={B}, fp32: train {n_tr} ({n_steps} steps), "
        f"validation {n_va}, test {HYB_RUN_TEST}; run {t_run:.2f} s; epoch train "
        f"{hist['train_time']:.3f} s, validation {hist['epoch_time'] - hist['train_time']:.3f} "
        f"s; train loss {hist['train_loss']:.5f}, val loss {hist['val_loss']:.5f}; steps by "
        f"CUDA events (ms) {', '.join(f'{t:.1f}' for t in step_ms)}; peak {peak:.2f} GiB; "
        f"launches {', '.join(f'{k} {v}' for k, v in launched.items() if v)}")
    if got != want:
        raise AssertionError(f"17b: launched {got}, expected {want}")
    if not all_finite(hist) or not all_finite(out["test_metrics"]):
        raise AssertionError("17b: a metric is not finite")
    del out, model, data
    torch.cuda.empty_cache()
    log(f"  17b: median of the {len(full)} full batches after the first "
        f"{statistics.median(full):.1f} ms a step")
    return launched, {"step_ms": statistics.median(full), "peak_gib": peak, "steps": n_steps,
                      "batch": B}


def hybrid_fusion_step(hcfg, depth, b):
    """17(c): fp32 fusion train steps of the hybrid-nb models at batch ``b``
    (one warm, one timed by CUDA events), the peak memory."""
    torch.cuda.empty_cache()
    net = FusionNetwork(*build_fusion_models(hcfg, DEV, torch.float32, gen(SEED)))
    state = TrainState.create(net, num_groups=4)
    spec = build_fusion_group_spec([n for n, _ in net.named_parameters()], hcfg)
    clf = get_classification_loss_fn(hcfg, np.arange(hcfg.class_num), "fusion")
    step = make_fusion_train_step(hcfg, clf, get_mask_loss_fn(hcfg, "fusion"), spec)
    hp = FusionOptController(hcfg).hyperparams()
    batch = dict(fusion_batches(hcfg, 1, b, 53)[0], aux_w=1.0)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step(state, batch, gen(54), hp)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    metrics = step(state, batch, gen(55), hp)
    ev[1].record()
    torch.cuda.synchronize()
    launched = counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = ev[0].elapsed_time(ev[1])
    log(f"  17c fp32 fusion train step, hybrid-nb encoders, B={b}: {ms:.1f} ms (CUDA events, "
        f"the second step), peak {peak:.2f} GiB, loss {float(metrics['loss']):.5f}")
    if launched != dict.fromkeys(COUNTERS, 0) | flash_train_expect(depth, 2, 2):
        raise AssertionError(f"17c: launched {launched}")
    if not torch.isfinite(metrics["loss"]).all():
        raise AssertionError("17c: loss not finite")
    del net, state, step, batch
    torch.cuda.empty_cache()
    return launched, {"step_ms": ms, "peak_gib": peak, "batch": b}


def hybrid_routes(hcfg, depth):
    """17(d): the hybrid-nb DWI train step (fp32) at B_ROUTES on the flash
    route and on the weights route (the materialized weights, the
    generator's ``uniform_`` mask; the script's ``weights_route()``) in turns
    (flash, weights, weights, flash), each turn one warm step and
    ROUTE_STEPS timed by CUDA events, with its peak memory."""
    model, rcfg = build_single_model(hcfg, "dwi", device=DEV, generator=gen(SEED))
    state = TrainState.create(model)
    spec = build_group_spec([n for n, _ in model.named_parameters()], True,
                            rcfg.reference_compat)
    clf = get_classification_loss_fn(rcfg, np.arange(rcfg.class_num), "dwi")
    step = make_single_train_step(rcfg, "dwi", clf, get_mask_loss_fn(rcfg, "dwi"), spec)
    hp = SingleModelOptController(rcfg, "dwi").hyperparams()
    batch = dict(dwi_batches(rcfg, 1, B_ROUTES, 57)[0], aux_w=1.0)
    turns = {"flash": [], "weights": []}
    launched = dict.fromkeys(COUNTERS, 0)
    for route in ("flash", "weights", "weights", "flash"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with (weights_route() if route == "weights" else contextlib.nullcontext()):
            step(state, batch, gen(58), hp)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            for _ in range(ROUTE_STEPS):
                step(state, batch, gen(59), hp)
            ev[1].record()
            torch.cuda.synchronize()
        got = counts()
        want = flash_train_expect(depth, (1 + ROUTE_STEPS) * (route == "flash"), 1)
        if {k: got[k] for k in want} != want:
            raise AssertionError(f"17d {route} route: launched {got}, expected {want}")
        if route == "flash":
            launched = {k: launched[k] + got[k] for k in COUNTERS}
        turns[route].append((ev[0].elapsed_time(ev[1]) / ROUTE_STEPS,
                             torch.cuda.max_memory_allocated() / 2 ** 30))
    res = {r: {"step_ms": statistics.mean(t for t, _ in v), "peak_gib": max(p for _, p in v)}
           for r, v in turns.items()}
    log(f"  17d DWI train step, hybrid-nb, fp32, B={B_ROUTES}, in turns (flash, weights, "
        f"weights, flash; {ROUTE_STEPS} steps a turn after a warm one): flash route "
        f"{res['flash']['step_ms']:.1f} ms, peak {res['flash']['peak_gib']:.2f} GiB; weights "
        f"route {res['weights']['step_ms']:.1f} ms, peak {res['weights']['peak_gib']:.2f} GiB "
        f"(x{res['weights']['step_ms'] / res['flash']['step_ms']:.2f} the time)")
    del model, state, step, batch
    torch.cuda.empty_cache()
    return launched, res


def phase_hybrid_train(hcfg, raw, tmp, smi):
    """Phase 17: hybrid-nb training on the card through the training route's
    dropout kernels; returns the launches of (a)-(d)'s flash runs, summed,
    and their numbers."""
    depth = hcfg.dwi_model.transformer_depth
    log(f"== phase 17: hybrid-nb training at full width ({depth} blocks, {HEADS} heads, "
        f"{SEQ} tokens) on the flash route with attention dropout {ATTN_DROP} on {smi}")
    t0 = time.perf_counter()
    total = dict.fromkeys(COUNTERS, 0)
    res = {}
    for name, run in (("bench_train", lambda: hybrid_bench_train(depth)),
                      ("run_single", lambda: hybrid_run_single(hcfg, raw, tmp, depth)),
                      ("fusion_fp32", lambda: hybrid_fusion_step(hcfg, depth, B_FUSION_F32)),
                      ("routes_b4", lambda: hybrid_routes(hcfg, depth))):
        launched, res[name] = run()
        total = {k: total[k] + launched[k] for k in COUNTERS}
    log(f"  phase 17: {time.perf_counter() - t0:.1f} s")
    return total, res


# ------------------------------------------------------------------ phase 15
# the port's bench (dmf_tpu_torch/bench.py) on the card: its argv beside
# bench.py's defaults (B=128, 20 steps after 3 warm-up calls, 256^2); the
# full-width hybrid-nb MC request is cut to 3 steps after 1
BENCH_RUNS = (
    ("tta_mc", ["--mode", "tta_mc", "--batch", "8"]),
    ("hybrid tta_mc", ["--encoder", "hybrid", "--mode", "tta_mc", "--batch", "8"]),
    ("hybrid-nb tta_mc", ["--encoder", "hybrid-nb", "--mode", "tta_mc", "--batch", "2",
                          "--mc-chunk", "1", "--warmup", "1", "--steps", "3"]),
    ("int8-prefix tta_mc", ["--int8-prefix", "--mode", "tta_mc", "--batch", "8"]),
    ("train", ["--train", "--batch", "32", "--steps", "3"]),
    ("train 2 folds", ["--train", "--parallel-folds", "2", "--batch", "8", "--steps", "2"]),
    ("train-e2e single", ["--train-e2e", "single", "--train-e2e-epochs", "2", "--batch", "32"]),
    ("numerics", ["--numerics", "--numerics-train-steps", "20", "--numerics-test-n", "64"]),
)
# a tta_mc request of the default models (phase 5's count)
BENCH_TTA_MC = {"se_epilogue": 12, "keep_mask": 12, "conv3x3_bn_gelu": 12, "se_scale": 4,
                "dwi_normalize": 1}
BENCH_AGREE, BENCH_PROB_ERR = 0.875, 0.05  # int8-prefix against fp: one of 8 may flip
# a hybrid-nb tta_mc request at --mc-chunk 1 (10 suffix forwards: 9 lean chunks
# and the last pass): the fused forward at its 12 attention sites (6 blocks x
# 2 encoders), the keep-mask kernel at its 40 other sites, a suffix
BENCH_HYB_NB = {"flash_attention_fwd_dropout": 12 * 10, "keep_mask": 40 * 10}
BENCH_NUMERICS = {"argmax_agreement": 0.75, "auc_delta": 0.05}


def bench_line(name, out, result):
    """The one JSON line a bench run printed, equal to what it returned, with
    a finite value (> 0 but for the AUC delta)."""
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    if len(lines) != 1 or json.loads(lines[0]) != result:
        raise AssertionError(f"15 {name}: printed {lines}, returned {result}")
    value = result["value"]
    if not (np.isfinite(value) and (value > 0 or result["metric"] == "bf16_vs_fp32_numerics")):
        raise AssertionError(f"15 {name}: value {value}")
    peak = torch.cuda.get_device_name(0) in bench.PEAK_TFLOPS
    if "achieved_tflops" in result and ("mfu" in result) != peak:
        raise AssertionError(f"15 {name}: mfu printed {'mfu' in result}, the card in the "
                             f"peak table {peak}")
    return lines[0]


def bench_gate(name, result, launched, calls):
    """Phase 15's gates on one in-process run of ``calls`` requests or steps:
    launches by its path, the agreement lines, a finite loss."""
    served = all(launched[k] > 0 for k in ("se_epilogue", "se_scale", "dwi_normalize"))
    if name == "tta_mc":
        ok = launched == dict.fromkeys(COUNTERS, 0) | {k: v * calls
                                                       for k, v in BENCH_TTA_MC.items()}
    elif name.startswith("hybrid"):
        # kernel 3 without dropout never; its dropout variant on hybrid-nb's
        # 4096 tokens only (hybrid: 256 tokens, the weights route)
        nb = name.startswith("hybrid-nb")
        ok = (served and launched["flash_attention_fwd"] == 0 and launched["int8_conv"] == 0
              and launched["flash_attention_fwd_dropout"]
              == (BENCH_HYB_NB["flash_attention_fwd_dropout"] * calls if nb else 0)
              and launched[DROP_INSTANCES["head_shared"]]
              == launched["flash_attention_fwd_dropout"]
              and (not nb or launched["keep_mask"] == BENCH_HYB_NB["keep_mask"] * calls))
    elif name.startswith("int8-prefix"):
        ok = (served and launched["int8_conv"] > 0
              and launched["int8_quantize"] == launched["int8_conv"]
              and launched["int8_dynamic_quantize"] == 0
              and result["hybrid_agreement"] >= BENCH_AGREE
              and result["max_prob_err"] <= BENCH_PROB_ERR
              and result["max_std_err"] <= BENCH_PROB_ERR)
    elif name.startswith("train-e2e"):
        # kernel 7 on every DWI train batch, kernels 1 and 6 in validation
        ok = (served and launched["flash_attention_fwd"] == 0
              and len(result["epoch_times_s"]) == result["epochs"])
    elif name.startswith("train"):
        ok = not any(launched.values())  # the train route calls no kernel
    else:  # numerics: the bf16 and fp32 test passes run kernels 1, 2 and 6
        ok = (launched["se_epilogue"] > 0 and launched["conv3x3_bn_gelu"] > 0
              and launched["dwi_normalize"] == 0 and np.isfinite(result["final_train_loss"])
              and result["argmax_agreement"] >= BENCH_NUMERICS["argmax_agreement"]
              and result["value"] <= BENCH_NUMERICS["auc_delta"])
    if not ok:
        raise AssertionError(f"15 {name}: launches {launched}, line {result}")


def phase_bench(smi):
    """Phase 15: the CLI's default ``bench`` in its own process, then each run
    of BENCH_RUNS in-process through ``bench.main(argv)``, the launch counts
    set to 0 just before and read just after each; returns their sum."""
    t_phase = time.perf_counter()
    log(f"== phase 15: the port's bench (dmf_tpu_torch/bench.py) on {smi}")
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "dmf_tpu_torch", "bench"], cwd=root,
                         env=dict(os.environ, PYTHONPATH=root), capture_output=True,
                         text=True, timeout=600)
    if run.returncode != 0:
        raise AssertionError(f"15 cli bench: exit {run.returncode}: {run.stderr[-2000:]}")
    result = json.loads([ln for ln in run.stdout.splitlines() if ln.startswith("{")][-1])
    line = bench_line("cli bench", run.stdout, result)
    if result["metric"] != "fusion_inference_throughput":
        raise AssertionError(f"15 cli bench: {line}")
    log(f"  15 cli bench (its own process, bench.py's defaults: normal, B=128, 256^2, bf16): "
        f"{time.perf_counter() - t0:.1f} s: {line}")
    total = dict.fromkeys(COUNTERS, 0)
    for name, argv in BENCH_RUNS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            result = bench.main(argv)
        dt = time.perf_counter() - t0
        launched = counts()
        args = bench.parse_args(argv)
        line = bench_line(name, out.getvalue(), result)
        log(f"  15 {name} ({' '.join(argv)}): {dt:.1f} s, peak "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB: {line}")
        log(f"  15 {name} launches " + ", ".join(f"{k} {v}" for k, v in launched.items() if v))
        bench_gate(name, result, launched, 1 + args.warmup + args.steps)
        for k, v in launched.items():
            total[k] += v
    torch.cuda.empty_cache()
    log(f"  phase 15: {time.perf_counter() - t_phase:.1f} s")
    return total


def main():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    def mark(what):  # the script's clock after each phase
        log(f"  [{time.perf_counter() - t_start:.1f} s] {what} done")

    cfg = default_parameters()
    hcfg = hybrid_nb_config(cfg)
    smi = phase_identity()
    phase_build()
    mark("2")
    # the bench first: its runs' launches are counted each on its own
    bench_launches = phase_bench(smi)
    mark("15")
    n_views = 4 * B_SERVE
    measured = {"se_epilogue": phase_epilogue(cfg.mc_passes - 1, n_views)}
    phase_epilogue_hybrid()
    measured["conv3x3_bn_gelu"] = phase_conv(n_views)
    measured["flash_attention_fwd"] = phase_flash_forward()
    (measured["flash_attention_bwd_dq"],
     measured["flash_attention_bwd_dkv"]) = phase_flash_backward()
    measured["flash_attention_fwd_dropout"] = phase_flash_dropout()
    drop_bwd = phase_flash_dropout_backward()
    mark("3a-3d, 3i, 3j")
    # the backward's path: counts set to 0 just before it and read just after
    stage_launches = phase_stage_backward(hcfg)[0]
    stage_train_launches = phase_stage_train(hcfg)
    mark("3h")
    measured["dwi_normalize"] = phase_dwi_norm()
    mark("3e")
    t0 = time.perf_counter()
    raw = make_synthetic_arrays(n_train=N_TRAIN, n_test=N_TEST, image_size=IMAGE,
                                mask_size=IMAGE, seed=SEED)
    log(f"== synthetic store: {N_TRAIN} + {N_TEST} volumes of {IMAGE}^2 "
        f"({time.perf_counter() - t0:.1f} s on the host)")
    dce_norm = dce_global_max_normalize(torch.as_tensor(raw["dce"], device=DEV))
    measured["histogram_percentiles"], hist_launches = phase_histogram(dce_norm)
    del dce_norm
    torch.cuda.empty_cache()
    measured["se_scale"] = phase_se_scale()
    mark("3f-3g")
    phase_parity(cfg)
    phase_parity_hybrid(hcfg)
    prep_launches = phase_prepare(cfg, raw)
    mark("4")
    raw = {k: v[:RUN_TEST if "test" in k else RUN_TRAIN] for k, v in raw.items()}
    # each served path: counts set to 0 just before it and read just after
    tta_mc_launches, request, large = phase_serve(cfg)
    hybrid_launches, hybrid_request = phase_serve_hybrid(hcfg)
    phase_profile("tta_mc", request)
    phase_profile("hybrid-nb normal", hybrid_request)
    mark("5-6")
    mc_launches, measured["keep_mask"] = phase_mc_chunks(cfg, hcfg)
    mark("16")
    phase_train_parity(cfg)
    phase_fusion_parity(cfg)
    mark("7a, 7c")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        # each run: counts set to 0 just before, read just after
        run_launches, dwi_out, rcfg0 = phase_run_single(cfg, raw, tmp)
        fold_launches = phase_fold(cfg, raw, tmp, dwi_out, rcfg0)
        del dwi_out
        mark("7b, 7d")
        # hybrid-nb training: each run's counts set to 0 just before, read just after
        hyb_launches, hyb_train = phase_hybrid_train(hcfg, raw, tmp, smi)
        mark("17")
        cli_launches = phase_cli(cfg, raw, tmp, smi)
        del raw
        mark("8")
        val_launches = phase_hybrid_validation(hcfg)[0]
        mark("7e")
        # phases 9d and 10b train on phase 8's tensor store
        vit_launches = phase_vit(cfg, tmp, smi)
        mark("9")
        t0 = time.perf_counter()
        phase_remat(cfg)
        mark("10a")
        pf_launches = phase_parallel_folds(cfg, tmp, smi)
        log(f"  phase 10: {time.perf_counter() - t0:.1f} s")
        mark("10b")
        # phase 11 serves phase 8's CLI artifact; its launches are the serving process's
        serving_launches = phase_serving(cfg, hcfg, tmp, smi)
        mark("11")
        # phase 12 tests phase 8's fold on the int8 path
        int8_launches, int8_measured = phase_int8(cfg, tmp)
        measured.update(int8_measured)
        mark("12")
        # phase 13: the data mesh; its launches are the ranks'
        mesh_launches = phase_mesh(cfg, tmp, smi)
        mark("13")
        # phase 14: the model axis; its launches are the ranks'
        tp_launches, _, _, measured["int8_conv"]["model_axis_shards"] = phase_tp(cfg, tmp, smi)
        mark("14")
    launches = {k: tta_mc_launches[k] + sum(h[k] for h in hybrid_launches) + mc_launches[k]
                + prep_launches[k] + stage_launches[k] + run_launches[k] + fold_launches[k]
                + val_launches[k] + cli_launches[k] + vit_launches[k] + pf_launches[k]
                + serving_launches[k] + int8_launches.get(k, 0) + mesh_launches[k]
                + tp_launches[k] + bench_launches[k] + stage_train_launches[k]
                + hyb_launches[k] for k in COUNTERS}
    launches["histogram_percentiles"] = hist_launches  # no served path: phase 3f
    log(f"  launches on the served paths, the chunked MC requests, the data preparation, the "
        f"stage backward, the "
        f"single-modality runs, the fusion run, the hybrid-nb validation batch, the "
        f"CLI, the ViT path, the fold-parallel run, the serving artifacts, the int8 "
        f"path, the data and model meshes, the bench, the stage in train mode and the "
        f"hybrid-nb training runs: {launches}")
    for name in COUNTERS:
        if launches[name] <= 0 and name not in DROP_INSTANCES.values():
            raise AssertionError(f"{name} was not launched on its path")
    by_instance = {k: launches[v] for k, v in DROP_INSTANCES.items()}
    if by_instance["head_shared"] != launches["flash_attention_fwd_dropout"]:
        raise AssertionError(f"the served dropout forward left the head-shared instance: "
                             f"{by_instance}")
    large()  # last: its maps take most of the card's memory
    log(f"== total {time.perf_counter() - t_start:.1f} s on {smi}")
    where = {
        "se_epilogue": ("cuda", "dmf_tpu_torch/csrc/se_epilogue.cu",
                        "dmf_tpu/ops/epilogue_pallas.py:222"),
        # no Pallas kernel: XLA lowers flax's Dropout (its bernoulli draw)
        "keep_mask": ("cuda", "dmf_tpu_torch/csrc/se_epilogue.cu",
                      "dmf_tpu/models/layers.py:337"),
        "conv3x3_bn_gelu": ("cuda", "dmf_tpu_torch/csrc/conv3x3_bn_gelu.cu",
                            "dmf_tpu/ops/conv3x3_pallas.py:217"),
        "flash_attention_fwd": ("cuda", "dmf_tpu_torch/csrc/flash_attention.cu",
                                "dmf_tpu/ops/flash_attention.py:43"),
        # no Pallas kernel: XLA lowers the MC attention's materialized
        # weights, flax's Dropout on them and the value product
        "flash_attention_fwd_dropout": ("cuda", "dmf_tpu_torch/csrc/flash_attention.cu",
                                        "dmf_tpu/models/transformer.py:45"),
        "flash_attention_bwd_dq": ("cuda", "dmf_tpu_torch/csrc/flash_attention.cu",
                                   "dmf_tpu/ops/flash_attention.py:114"),
        "flash_attention_bwd_dkv": ("cuda", "dmf_tpu_torch/csrc/flash_attention.cu",
                                    "dmf_tpu/ops/flash_attention.py:144"),
        "se_scale": ("cuda", "dmf_tpu_torch/csrc/se_scale.cu",
                     "dmf_tpu/ops/se_pallas.py:110"),
        "dwi_normalize": ("cuda", "dmf_tpu_torch/csrc/dwi_norm.cu",
                          "dmf_tpu/ops/preprocess_pallas.py:28"),
        "histogram_percentiles": ("cuda", "dmf_tpu_torch/csrc/histogram_percentiles.cu",
                                  "dmf_tpu/ops/histogram_pallas.py:38"),
        # no Pallas kernel: XLA lowers the JAX package's int8 conv and quantize
        "int8_conv": ("cuda", "dmf_tpu_torch/csrc/int8_conv.cu", "dmf_tpu/ops/quant.py:127"),
        "int8_quantize": ("cuda", "dmf_tpu_torch/csrc/int8_quantize.cu",
                          "dmf_tpu/ops/quant.py:90"),
        "int8_dynamic_quantize": ("cuda", "dmf_tpu_torch/csrc/int8_quantize.cu",
                                  "dmf_tpu/ops/quant.py:76"),
    }
    measured["flash_attention_fwd_dropout"]["launches_by_instance"] = by_instance
    # the backward's dropout instances: phase 3j's numbers, their launches on
    # the training paths (3h in train mode, 17), phase 17's steps
    for name, entry in zip(("flash_attention_bwd_dq", "flash_attention_bwd_dkv"), drop_bwd):
        measured[name]["dropout"] = dict(entry, launches=launches[f"{name}_dropout"])
    measured["flash_attention_bwd_dq"]["dropout"]["hybrid_nb_training"] = hyb_train
    kernels = [{"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": launches[name], **measured[name]}
               for name, (route, source, replaces) in where.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        mesh_rank_main(sys.argv[2])
    elif sys.argv[1:2] == ["--tp-rank"]:
        tp_rank_main(sys.argv[2])
    else:
        main()
