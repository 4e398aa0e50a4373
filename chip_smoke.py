#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N]   # from the repository root

Weights, token ids, lengths and labels are drawn from ``--seed``.

Phases, in order; any failure exits non-zero and prints no result line:

1. device: a CUDA card is required; prints its name and power limit (as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them) and turns TF32 off for matmuls and cuDNN, so f32 means f32;
2. build: compiles the port's four CUDA libraries from
   ``paddle_tpu_torch/csrc`` (one ``nvcc`` each, all started together),
   prints ptxas's register and spill lines, counts the HMMA (tensor-core)
   instructions in the SASS (``cuobjdump -sass``) of the flash-attention
   forward and backward libraries and of the LSTM backward library (its dW
   kernel) and fails if one has none, if an f32 instantiation of the flash
   forward, of the flash dQ or dK/dV kernel, or of the LSTM walk spills,
   or if any instantiation of the LSTM forward spills (every flash
   backward, LSTM forward, walk and dW instantiation's registers and
   spills printed);
3. kernel vs plain: the flash-attention forward kernel, then its dQ and
   dK/dV kernels (and the delta the dQ kernel writes, against
   ``bwd_delta``), against their plain PyTorch versions on the card, over
   causal/non-causal, with/without lengths (0, partial, full), self and cross
   attention, a ragged Lq, every supported head_dim, f32 and bf16; then the
   LSTM forward kernel (with and without the saved activations), its
   backward walk and its dW kernel against theirs, over f32/bf16, D 32, 64,
   128, 256, 512, B 128 and 13, T 64 and 1, full and ragged lengths (0 and
   T among them), nonzero h0/c0, each case with the forward's and the
   walk's cluster sizes; then the forward and the walk at every cluster
   size their plans take against the plain versions and, bitwise, against
   the size the library picks;
4. Transformer serving: Transformer-base at full width (6+6 layers, 8 heads,
   d_model 512, d_ff 2048, vocab 30000, seq 256; random weights from a seed)
   serves four requests of 16 x 256 tokens through ``Executor.run`` on
   ``CUDAPlace(0)``; then one 2 x 256 batch runs on the card and on
   ``CPUPlace()`` (the plain versions) with the same weights and the two are
   compared;
5. Transformer training: the same model's training program (append_backward
   + Adam at lr 1e-3) takes five steps of 16 x 256 tokens on one fixed batch;
   the loss must fall at every step; then the card's state (parameters,
   moments, beta powers, learning rate) is handed to a ``CPUPlace()`` scope
   and one 2 x 256 step runs on each, comparing loss, gradients and updated
   parameters;
6. stacked-LSTM serving: the IMDB stacked-LSTM model at its published widths
   (dictionary 5149, embedding 128, hidden 128, 3 LSTM layers, 2 classes;
   random weights from a seed) in two forms, as built (peepholes: the scan
   path) and the same net without peepholes (the LSTM kernels), serves four
   LoD requests of 128 rows with lengths in [1, 64]; each form's 8-row
   request is compared with ``CPUPlace()``;
7. stacked-LSTM training: five Adam steps (lr 0.002) of the kernel form on
   one 128-row batch with exact launch counts and a falling loss; one step
   of each form from the same state on the card and on the CPU;
8. NMT serving: the seq2seq NMT model at bench.py's bench_nmt widths
   (dictionaries 30000, embedding, encoder and decoder 512; random weights
   from a seed) in two forms, as built (the encoder LSTM with peepholes:
   the scan path) and the same net without peepholes (``nmt_programs``:
   the LSTM kernels at D = 512); its test program serves four LoD requests
   of 128 sentence pairs as built (lengths in [8, 32], T = 32, the
   [128, 32, 30000] prediction fetched; one request under
   ``torch.profiler``) with no kernel launch, and two of the kernel form
   with one ``lstm_fwd`` launch each;
9. NMT training: five Adam steps (lr 1e-3) as built on one 128-pair batch
   with a falling loss, a sixth under ``torch.profiler`` (busy, idle
   share, the grads' replay); three of the kernel form with exactly 2
   ``lstm_fwd``, 1 ``lstm_bwd`` and 1 ``lstm_bwd_dw`` launches a step;
   one 2-pair step of each form from the same state on the card and on the
   CPU (``NMT_TRAIN_TOL``);
10. NMT beam decode: ``build_decode`` (beam 4, 16 steps) serves four
   requests of 64 source sentences (one under ``torch.profiler``), then a
   2-sentence request on the card and on the CPU, compared tie-aware
   (``compare_beams``, ``NMT_BEAM_TOL``);
11. ResNet-50 serving: ResNet-50 at full width as bench.py builds it
   (1000 classes, 224 x 224, bottleneck blocks [3, 4, 6, 3]; random
   weights from a seed) serves four requests of 64 images through its test
   program (batch norm on the running statistics), the softmax fetched:
   request wall, images/s, peak device memory and one request's device busy
   time under ``torch.profiler``; then a 2-image request on the card and on
   ``CPUPlace()`` with the same state, softmax and logits compared;
12. ResNet-50 training: five Momentum steps (lr 0.01, mu 0.9) on one fixed
   64-image batch, every loss finite and the fifth below the first; step
   wall, peak memory, one step's device busy time, idle share, the
   convolutions' and the grads' forward replay's shares; then one 2-image
   step from the card's state on each device: loss, every trainable
   gradient, the updated parameters, velocities and batch-norm running
   statistics;
13. MNIST MLP at its published width (784-200-200-10, tanh, Adam): five
   steps of 64 images with a falling loss, one 8-image step against the
   CPU;
14. VGG-16 (1000 classes, 224 x 224): a 2-image request of the test program
   and a 2-image training step (dropout_prob 0 on every dropout op) each
   against the CPU; no hand-written kernel may launch in phases 11-14, and
   the CPU runs of phases 11-14 flush denormals to zero;
15. CTR serving: the CTR wide-and-deep model at bench.py's bench_ctr widths
   (vocabulary 1,000,000, embedding 64, hidden (256, 128), 26 sparse slots,
   13 dense features; random weights from a seed; ``is_sparse=True``)
   serves four requests of 1024 rows (zipf ids), the prediction fetched:
   wall, rows/s, peak memory, one request's busy time and idle share; one
   request on the card and on ``CPUPlace()`` from the same state;
16. CTR training: 20 sparse Adam steps (lr 1e-3) on one fixed batch with a
   falling loss, one more under ``torch.profiler`` (busy, idle share, the
   kernels with the most device time); one step from that state on the
   card and on the CPU: loss, gradients (the table's a SelectedRows with
   the CPU's rows), parameters, moments, and the untouched rows of the
   table and its moments bitwise as they were on both (lazy Adam); then
   the dense form (``is_sparse=False``) against the sparse from the
   startup state: one Adam step leaves every persistable var bitwise equal
   in the two, each step's peak memory above what was allocated before it
   (the sparse step's below one [V, D] table), and five SGD steps of both
   forms, bitwise equal; one sparse word2vec step (its four lookups'
   SparseRows summed) on the card and on the CPU; no hand-written kernel
   may launch in phases 15-17;
17. CTR captured: the request, the sparse step and the dense step captured
   against eager (below); ``ctr_embedding@GRAD`` fetched from the eager
   call, a capture and a replay, a SelectedRows each, bitwise the eager
   one after a replay on another batch; ``run_multi`` of 8 sparse steps
   against 8 ``run`` calls;
18. times: each kernel, its plain version and the one PyTorch call computing
   the same function, at each slice's shape (CUDA events, median), the
   kernel and the library call also by their device time alone under
   ``torch.profiler`` (``device_ms``, ``library_device_ms``; the names of
   the kernels SDPA ran are printed), each kernel's bound (operations at
   the 3xTF32 tensor-core rate, bytes at the HBM rate; the same with the
   f32 FMA rate is printed beside it), the LSTM forward's and walk's device
   time at each cluster size, the walk's at bf16, and the ``lstm`` op's scan
   and kernel paths; the three LSTM kernels again at NMT's shape (B=128,
   T=32, D=512, entries ``*_d512``, beside cuDNN's LSTM there), and all
   five kernels' bf16 instantiations at the shapes of paths A and B below
   (entries ``*_bf16``, bound at the 989 TFLOP/s bf16 tensor-core rate,
   beside SDPA's and cuDNN's bf16 calls), all printed as one
   ``{"kernels": [...]}`` JSON line;
19. the last line: ``{"ok": true, "device": {...}}``.

Each ``Executor`` on the card runs the first call of a block eagerly,
captures the block as a CUDA graph at the second and replays it from then
on, so phases 4-16 drive the captured path.  Beside them, the captured path
against the eager one (``eager_run``), from the same state:
Transformer-base's request and Adam step (after phase 5), the stacked
LSTM's kernel form's request and step (after phase 7), NMT's kernel form's
Adam step (after phase 10), ResNet-50's request and Momentum step (after
phase 12) and CTR's request and sparse and dense Adam steps (phase 17).  Each asserts ``mode == 'graph'``, one capture of one block,
the hand-written kernels the capture launched, the captured call against
the eager call (fetches and every state var written, ``CAPTURE_TOL``, or
twice the eager path's own spread from the same state, which is printed),
a replay from the state again against the capture's call, and the kernels
a replay launches, counted by name in the profiler's device activity; then
times ``CAPTURE_CALLS`` calls of each path: median wall, device busy and
idle share of one call under ``torch.profiler``, peak memory.  After the
stacked LSTM: ``run_multi`` (8 Adam steps on 8 batches) against 8 ``run``
calls (the last loss and every persistable var) and ``run_eval_multi`` (8
requests) against 8 ``run`` calls (every fetch); dropout at p = 0.1 in a
graph (each replay's mask keeps 0.9 +- ``DROPOUT_KEPT_TOL`` and differs
from the last); and staleness (an op appended after the capture compiles
the block again, a parameter handed over between two replays is read by
the second, the stacked LSTM's train and test graphs share their
parameter buffers, and state that one graph writes before it reads it
survives the replays of another graph captured before it).

Every launch counter is set to 0 just before each serving and each training
path, and read just after it (``launches`` in the kernels line).  A replay
calls no kernel wrapper, so every call of a main path runs under
``torch.profiler`` and its hand-written kernels are counted by name in the
device activity, replays included, and asserted call by call
(``device_launches``); the wrappers' counts are asserted too: the call's
kernels in a call that ran the lowerings, none in a replay.

Mixed precision (``fluid.amp_guard()``: bf16 products and activations, f32
master weights), each path from the state its f32 phases left:

A. after the Transformer's capture phase: four 16 x 256 requests (the bf16
   prediction fetched) and a 2 x 256 request against the CPU under AMP
   (``AMP_SERVE_TOL``); five Adam steps with a falling loss; f32 and AMP
   training from one state, ``AMP_F32_STEPS`` steps, within
   ``AMP_F32_LOSS_TOL``; a 2 x 256 step against the CPU under AMP
   (``AMP_TRAIN_TOL``); the request and the step captured against eager;
B. after the stacked LSTM's phases, its kernel form: four requests and an
   8-row request against the CPU, five Adam steps, ``AMP_LSTM_STEPS`` of
   AMP against f32 within ``AMP_LSTM_LOSS_TOL``, a 16-row step against the
   CPU, the request and the step captured against eager;
D. after ResNet-50's phases: five Momentum steps at batch 64 (every
   parameter and ``@GRAD`` f32), a 2-image step against the CPU under AMP
   (``AMP_CV_TRAIN_TOL``), the step captured against eager;
C. then ResNet-50 served as bench.py's bench_resnet_infer_bf16 serves it:
   ``save_inference_model`` of the test program, loaded three times (as
   loaded, batch norm folded by ``InferenceTranspiler``, folded and
   ``Float16Transpiler('bfloat16')``), each served by ``run_eval_multi``
   of 4 lots of 256 images, captured, and freed before the next: images/s,
   busy and idle share, peak memory; folded against unfolded
   (``INFER_FOLD_RTOL``), bf16 against f32 (``INFER_HALF_TOL``).

In A and B every hand-written kernel counted on the card is a bf16
instantiation (``__nv_bfloat16`` in its name) and none an f32 one; in the
f32 paths, the reverse.

The memory plan: every block frees each var after its last op (its release
plan; see ``fluid/executor.py``).  Each capture phase prints the block's
``memory_analysis`` (temp, argument and output bytes) beside the capture's
measured peak above what was allocated before it; after the Transformer's
and ResNet-50's capture phases one training step from one state is
captured with the plan and run in a refused block (eager, nothing freed),
bitwise equal (``phase_plan_bitwise``; cuDNN deterministic for both).

E. bench widths, after CTR's phases: bench.py's six configurations as
   bench.py builds them, at the batches of ``BENCH_WIDTHS`` (bench.py's
   own unless cut, and then printed beside it as ``cut_from``):
   bench_resnet (512, AMP, Momentum lr 0.1), bench_transformer (128 x 256,
   base, AMP: the bf16 flash forward, dQ and dK/dV kernels), bench_nmt
   (512 pairs, T 32, AMP, LoD feeds, as built: the scan path),
   bench_stacked_lstm (128 x 64, AMP, as built), bench_resnet_infer_bf16
   (256 images, the f32 program as loaded and the folded bf16 one,
   ``run_eval_multi`` of ``BENCH_INFER_K`` lots) and bench_ctr (1,000,000
   x 64, batch 1024, sparse, Adam).  Each: startup, an eager call, the
   capture, ``BENCH_REPLAYS`` replays, under ``FLAGS_cost_accounting``; a
   ``path E: {...}`` line with the peak device memory of the eager call
   and of the captured calls, ``memory_analysis``'s temp bytes,
   ``cost_report``'s FLOPs a step beside bench.py's analytic count, ms a
   step (a lot) and the loss.  ``probe_bench_widths.py`` finds the batches
   that fit.

It imports nothing of JAX or of the JAX package ``paddle_tpu``.
"""

import argparse
import concurrent.futures
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016

# H100 SXM data-sheet peaks (dense): f32 outside the tensor cores, HBM3;
# f32-accurate products on the tensor cores take three TF32 products each
# (3xTF32), so their least time is at a third of the 495 TFLOP/s TF32 rate
PEAK_F32_FLOPS = 67e12
PEAK_3XTF32_FLOPS = 495e12 / 3
PEAK_BYTES_PER_S = 3.35e12
BOUND_RATE = ('operations at 165 TFLOP/s (3xTF32 on the tensor cores), '
              'bytes at 3.35 TB/s')
# bf16 products on the tensor cores (dense, f32 accumulation)
PEAK_BF16_FLOPS = 989e12
BOUND_RATE_BF16 = ('operations at 989 TFLOP/s (bf16 on the tensor cores), '
                   'bytes at 3.35 TB/s')


def bound(flops, nbytes, rate=PEAK_3XTF32_FLOPS):
    """(bound_ms, bound_by, bound_simt_ms) of the work: the larger of its
    operations at ``rate`` (by default the 3xTF32 rate of f32 work) and its
    bytes at the HBM rate; and the same with the operations at the f32 rate
    outside the tensor cores."""
    t_ops, t_bytes = flops / rate, nbytes / PEAK_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            'operations' if t_ops >= t_bytes else 'bytes',
            1e3 * max(flops / PEAK_F32_FLOPS, t_bytes))

TRANSFORMER_BASE = dict(src_vocab=30000, trg_vocab=30000, max_len=256,
                        n_layer=6, n_head=8, d_model=512, d_ff=2048)
BATCH = 16
REQUESTS = 4
TRAIN_STEPS = 5
LR = 1e-3
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# card vs CPU on the whole 12-layer model in f32: summation order differs
# in every matmul and reduction
SLICE_RTOL, SLICE_ATOL = 1e-3, 1e-7
# one training step, card vs CPU.  Gradients: f32 sums in another order
# through 12 layers and back, with cancellation in the softmax and layer-norm
# backward, so a parameter's error scales with the activations' gradients
# more than with its own.  Each parameter's max|dg| must stay within
# GRAD_RTOL of its own max|g| plus GRAD_ATOL of the largest max|g| in the
# model (after a few steps on one batch some attention projections' grads
# fall to ~1e-12, pure rounding noise on both sides); the norm of all
# gradients' differences must stay within GRAD_NORM_TOL of the norm of all
# gradients.  Updated parameters: Adam divides by sqrt(m2) + eps, so where a
# gradient is near 0 a change of summation order can move the update by up
# to about lr; elsewhere it moves far less than PARAM_ATOL.  So every element
# is held within LR of the CPU, and at most PARAM_FRAC of the elements may
# differ by more than PARAM_ATOL.
GRAD_RTOL, GRAD_ATOL, GRAD_NORM_TOL = 1e-2, 1e-6, 1e-4
PARAM_ATOL, PARAM_FRAC = 1e-6, 1e-4
TRAIN_TOL = dict(loss=SLICE_RTOL, grad_rtol=GRAD_RTOL, grad_atol=GRAD_ATOL,
                 grad_norm=GRAD_NORM_TOL, param_atol=PARAM_ATOL,
                 param_frac=PARAM_FRAC)

# the stacked-LSTM IMDB model at its published widths (bench.py's
# stacked_lstm configuration: 3 layers, embedding and hidden 128, dictionary
# 5149, batch 128, sequences up to 64)
STACKED_LSTM = dict(dict_dim=5149, emb_dim=128, hid_dim=128, stacked_num=3,
                    class_dim=2)
LSTM_BATCH = 128
LSTM_MAX_LEN = 64
LSTM_LR = 0.002
LSTM_CPU_ROWS = 8        # rows of the request compared with the CPU
LSTM_CPU_TRAIN_ROWS = 16  # rows of the training step compared with the CPU
# LSTM kernels vs their plain versions, scaled by max(1, max|plain|).  f32:
# the same recurrence with h . W (and dgates . W^T, dW) summed in another
# order, over up to 64 dependent steps.  bf16: h rounds to bf16 at every
# step, so a sum taken in another order can land on the neighbouring bf16
# value (2^-8 relative) and that difference travels through the remaining
# steps; dW sums bf16 dgates and h in f32.
LSTM_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# the kernel-vs-plain sweep's D: powers of two, and two widths at which no
# cluster holds all of W and 8 CTAs are refused
LSTM_WIDTHS = (32, 64, 128, 256, 288, 480, 512)
# stacked-LSTM prediction, card vs CPU: 3 layers x 64 dependent steps of f32
# in another summation order on each side (the card's LSTM kernel against
# the CPU's scan path), then a 2-class softmax
LSTM_PRED_RTOL, LSTM_PRED_ATOL = 1e-4, 1e-6

# the seq2seq NMT model at bench.py's bench_nmt widths (dictionaries of
# 30000, embedding, encoder and decoder 512), Adam at the build's lr 1e-3;
# LoD batches of 128 sentence pairs with lengths in [8, 32] (one row at 32,
# so T = 32); beam decode at the build's beam 4 and max_length 16
NMT = dict(src_dict_dim=30000, trg_dict_dim=30000, embedding_dim=512,
           encoder_size=512, decoder_size=512)
NMT_LR = 1e-3
NMT_BATCH = 128
NMT_MIN_LEN, NMT_MAX_LEN = 8, 32
NMT_BEAM, NMT_OUT_LEN = 4, 16
NMT_DECODE_BATCH = 64
NMT_CPU_PAIRS = 2
# one NMT training step on 2 pairs, card vs CPU (compare_train_step's keys).
# Measured on an NVIDIA H100 80GB HBM3 at 700 W, seeds 20261016 and
# 20261116, both forms: the losses within 1e-7; the worst max|dg| / max|g|
# 8.1e-4 to 6.9e-3 in the kernel form (the attention's state projection
# fc_3.w_0, whose gradient cancels over the source steps; at most 1.6e-5
# as built), |dg| / |g| over all 3.1e-7; updated parameters max|dp| 3e-6,
# none beyond 1e-5.  Adam can move a parameter
# whose gradient is rounding noise by up to lr either way, hence param_max.
# Adam's moments, each |d| / |v|, follow the gradients: measured 2.5e-6 to
# 4e-5 as built and 1.4e-3 to 1.7e-2 in the kernel form, varying from run
# to run on the card (three runs at each of the two seeds); where the check
# named the worst, it was fc_3.w_0's first moment.
NMT_TRAIN_TOL = dict(loss=1e-5, grad_rtol=1e-2, grad_atol=1e-6,
                     grad_norm=1e-5, param_max=NMT_LR, param_atol=1e-5,
                     param_frac=1e-4, moments=0.1)
# the decode's accumulated beam scores (about -165 after 16 steps), card vs
# CPU (compare_beams): measured 1.5e-5 at the default seed
NMT_BEAM_TOL = 1e-4

# the dense CV slice: ResNet-50 as bench.py's bench_resnet builds it
# (resnet.build(depth=50, class_dim=1000, image_shape=(3, 224, 224)):
# bottleneck blocks [3, 4, 6, 3], the fused softmax_with_cross_entropy head,
# Momentum 0.9 at the build's lr 0.01), the MNIST MLP at its published
# width (784-200-200-10, tanh, Adam at the build's lr 0.01) and VGG-16 with
# batch norm (1000 classes, 224 x 224, Adam at lr 0.01)
RESNET50 = dict(depth=50, class_dim=1000, image_shape=(3, 224, 224))
VGG16 = dict(class_dim=1000, image_shape=(3, 224, 224))
CV_LR = 0.01
CV_BATCH = 64       # images a ResNet-50 request and training step
CV_CPU_BATCH = 2    # images of the requests and steps compared with the CPU
MNIST_BATCH = 64
# card vs CPU on the CV models, f32 with TF32 off: cuDNN's convolutions and
# oneDNN's sum in other orders (cuDNN takes FFT algorithms for some); batch
# norm over 2 images divides by the standard deviation of 2 x 7 x 7 values a
# channel at ResNet-50's last stage (of 2 values at VGG-16's 2-D batch
# norm), amplifying those differences layer by layer; a ReLU or max-pool
# input within rounding of a tie takes the other branch on one side, which
# moves every gradient below it by up to a few percent
# (tests/test_torch_resnet.py measures the same against the JAX package).
# Served softmax and logits: ratio of 2-norms (measured 2.5e-6 at most).
CV_SERVE_RTOL = 1e-4
# One training step: loss rtol; each gradient's max|dg| within grad_rtol of
# its own max|g| plus grad_atol of the largest in the model, and |dg| / |g|
# over all gradients within grad_norm; updated parameters within param_max
# of the CPU and at most param_frac of their elements beyond param_atol;
# each momentum velocity within velocity and each batch-norm running
# statistic within stats (ratios of 2-norms).  The existing models keep
# their constants (TRAIN_TOL).  Measured on an NVIDIA H100 80GB HBM3 at
# 700 W, seeds 20261016 and 20261116, twice each: ResNet-50 loss 3.3e-6, the worst max|dg| / max|g| 0.37, over all
# 0.030, max|dp| 0.0023 with 0.3-0.5% of the elements beyond 1e-4,
# velocities 0.036, statistics 3.4e-6; the MLP loss 1.7e-7, 1.4e-4,
# 1.1e-4, max|dp| 1e-6 (its loss is 4e-4 after five steps, so softmax's
# p - 1 cancels: 1e-7 / 1e-4); VGG-16 loss 7.7e-6, over all 0.014,
# statistics 9.7e-6, 0.2% of the parameters' elements beyond lr / 10, and
# a bias that a batch norm subtracts again has a gradient of rounding noise
# (max|dg| / max|g| up to 2.2), which Adam turns into a step of lr either
# way (max|dp| 2 lr).
CV_TRAIN_TOL = {
    'resnet50': dict(loss=1e-4, grad_rtol=1.0, grad_atol=1e-3,
                     grad_norm=0.1, param_max=CV_LR, param_atol=1e-4,
                     param_frac=0.02, velocity=0.1, stats=1e-4),
    'mnist': dict(loss=1e-5, grad_rtol=1e-3, grad_atol=1e-6,
                  grad_norm=1e-3, param_max=CV_LR, param_atol=1e-6,
                  param_frac=1e-3),
    'vgg16': dict(loss=1e-4, grad_rtol=1.0, grad_atol=1e-4, grad_norm=0.05,
                  param_max=2 * CV_LR, param_atol=CV_LR / 10,
                  param_frac=0.02, stats=1e-4),
}

# CTR wide-and-deep at bench.py's bench_ctr widths on one card (bench.py:
# 1027-1030, its on_tpu branch, without the row-sharding over an 'mp' mesh
# axis): vocabulary 1,000,000, embedding 64, hidden (256, 128), 26 sparse
# slots and 13 dense features, Adam at lr 1e-3, batch 1024, ids from
# zipf_batch (zipf 1.2).  The table is 256 MB in f32, 768 MB with Adam's
# moments; a batch touches at most 26,624 rows.
CTR = dict(sparse_dim=1000000, embed_size=64, hidden_sizes=(256, 128),
           lr=1e-3)
CTR_BATCH = 1024
CTR_TRAIN_STEPS = 20
CTR_SGD_STEPS = 5
# card vs CPU on CTR, f32 with TF32 off: the fc layers (K = 1677 at the
# first) sum in another order; an MLP like MNIST's, so MNIST's step
# tolerances; the served prediction as a ratio of 2-norms.  The table's
# sparse gradient must have the same rows on both, its values held as a
# gradient.
CTR_SERVE_RTOL = 1e-5
CTR_TRAIN_TOL = dict(loss=1e-5, grad_rtol=1e-3, grad_atol=1e-6,
                     grad_norm=1e-3, param_max=CTR['lr'], param_atol=1e-6,
                     param_frac=1e-3, moments=1e-3)
# word2vec (the build's widths: dictionary 200, embedding 32, hidden 256,
# SGD at lr 1e-3), one sparse step against the CPU
W2V_BATCH = 128
W2V_LR = 1e-3

# mixed precision (amp_guard): bf16 products and activations, f32 master
# weights, gradients of f32 parameters and optimizer state.  Card vs CPU,
# both under AMP: each side rounds its own f32 sums to bf16 (cuBLAS, cuDNN
# and the flash and LSTM kernels on the card, oneDNN and the plain versions
# on the CPU), so a bf16 value may land one bf16 step (2^-8) away and carry
# that through the layers after it.  AMP_SERVE_TOL: the loss, relative; the
# prediction, max|d| / max(1, max|v|) and the ratio of 2-norms.
# AMP_TRAIN_TOL and AMP_CV_TRAIN_TOL: compare_train_step's keys.
# Measured (default seed): Transformer loss 6.6e-6, prediction 5.7e-6 and
# 0.0020; stacked LSTM 0.0019, 0.0039 (one bf16 step of a probability)
# and 0.0019.
AMP_SERVE_TOL = dict(loss=2e-2, pred_max=2e-2, pred_norm=5e-2)
# Adam moves an element by up to about lr, and by more where m / sqrt(v)
# exceeds 1, so two sides whose gradients differ in sign may part by up to
# 2 lr (param_max).  Adam's moments are not held, as TRAIN_TOL does not
# hold them in f32: after a few steps on one batch some projections'
# gradients are rounding noise, and so are their moments (measured: the
# worst moment |d| / |v| 0.40 from the startup state, 1.06 after the f32
# phases' steps).
# Measured on an NVIDIA H100 80GB HBM3 at 700 W at the default seed, from
# the state the f32 phases leave: Transformer loss 1.9e-5, |dg| / |g| over
# all 0.0030, the worst element 0.067 of its allowance (2.15 of its own
# max|g|: a projection whose gradient is rounding noise after those
# steps; with grad_atol 0.01 a run reached 0.98 of the allowance),
# max|dp| 0.89 lr; stacked LSTM loss 6.1e-4, 0.0087, 0.055, max|dp| 1.11
# lr.
AMP_TRAIN_TOL = dict(loss=2e-2, grad_rtol=0.5, grad_atol=3e-2, grad_norm=0.1,
                     param_max=2 * LR, param_atol=LR / 10, param_frac=0.05)
AMP_LSTM_TRAIN_TOL = dict(AMP_TRAIN_TOL, param_max=2 * LSTM_LR,
                          param_atol=LSTM_LR / 10)
# ResNet-50's gradients at these weights are chaotic under rounding: a
# batch-norm network's gradients grow through its depth, and bf16 rounding
# of the activations turns the backbone's gradients into another vector on
# the card and on the CPU alike (profile_amp_resnet_grads.py on an NVIDIA
# H100 80GB HBM3 at 700 W, batches 2 and 8, from the startup state and
# after 5 f32 steps: AMP against f32 on one device |dg| / |g| over all
# 1.296-1.329 on the card and on the CPU, card against CPU under AMP
# 1.079-1.167; in f32, card against CPU 0.020-0.026).  So under AMP the
# step holds the forward (the loss and the batch-norm running statistics)
# and the head, the fc layer one product from the loss, its gradients,
# update and velocity; the backbone's gradients are printed over all.
# Measured at the default seed: the head's worst max|dg| / max|g| 0.117,
# |dg| / |g| 0.043, velocities 0.030, statistics 0.0074, the loss 0.0046.
AMP_CV_TRAIN_TOL = dict(loss=2e-2, grad_rtol=0.3, grad_atol=1e-2,
                        grad_norm=0.1, param_max=CV_LR, param_atol=CV_LR / 10,
                        param_frac=0.05, velocity=0.1, stats=2e-2)
# AMP against f32 training from the same state, the JAX package's own
# bounds: |loss_amp - loss_f32| at each of AMP_F32_STEPS Adam steps of the
# Transformer (tests/test_amp.py:88-113, 0.15) and of AMP_LSTM_STEPS of
# the stacked LSTM (tests/test_amp.py:115-154, 0.1)
AMP_F32_STEPS, AMP_F32_LOSS_TOL = 5, 0.15
AMP_LSTM_STEPS, AMP_LSTM_LOSS_TOL = 20, 0.1
# ResNet-50 served in bf16 as bench.py's bench_resnet_infer_bf16 serves it:
# save_inference_model -> load_inference_model -> InferenceTranspiler ->
# Float16Transpiler('bfloat16') -> run_eval_multi of INFER_K lots of
# INFER_BATCH images, captured.  The bf16 softmax against f32 within
# tests/test_float16_transpiler.py's bound (max|d|), and the logits (the
# softmax's input, fetched beside it: at random weights the softmax can
# saturate) as a ratio of 2-norms; the folded f32 logits against the
# unfolded ones (f32 arithmetic in another order: BN's scale moved into
# the filter).
# Measured (default seed): folded 1.9e-6, bf16 logits 0.0042; the softmax
# is saturated at these weights (mean top probability 1), max|d| 0.
INFER_BATCH, INFER_K, INFER_CALLS = 256, 4, 5
INFER_HALF_TOL = 3e-2
INFER_HALF_LOGITS_RTOL = 5e-2
INFER_FOLD_RTOL = 1e-4

LIBRARIES = ('flash_attention_fwd', 'flash_attention_bwd', 'lstm_fwd',
             'lstm_bwd')


def fail(msg):
    print('chip_smoke: FAILED: %s' % msg, file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def phase_device():
    check(torch.cuda.is_available(), 'torch.cuda.is_available() is False: '
          'this script runs on a CUDA card only')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader',
         '-i', str(torch.cuda.current_device())],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(),
          'nvidia-smi failed: %s' % smi.stderr)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print('device: %s (torch %s, CUDA %s); TF32 off: matmul.allow_tf32=%s '
          'cudnn.allow_tf32=%s' % (torch.cuda.get_device_name(0),
                                   torch.__version__, torch.version.cuda,
                                   torch.backends.cuda.matmul.allow_tf32,
                                   torch.backends.cudnn.allow_tf32),
          flush=True)
    return card


def phase_build():
    from paddle_tpu_torch.ops.kernels import _build

    def timed(name):
        t0 = time.perf_counter()
        path, log = _build.build(name)
        return path, log, time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(LIBRARIES)) as pool:
        built = list(pool.map(timed, LIBRARIES))
    for name, (path, log, seconds) in zip(LIBRARIES, built):
        print('build: %s -> %s' % (name, os.path.relpath(path, REPO)))
        for line in (log or '').splitlines():
            if 'Function properties' in line or 'registers' in line or \
                    'spill' in line:
                print('  ptxas: ' + line.strip())
        print('build: %s %.1f s%s' % (name, seconds, '' if log is not None
                                      else ' (previous build reused)'))
        if name == 'flash_attention_fwd':
            check_fwd_build(path, log)
        elif name == 'flash_attention_bwd':
            check_flash_bwd_build(path, log)
        elif name == 'lstm_fwd':
            check_lstm_fwd_build(log)
        elif name == 'lstm_bwd':
            check_bwd_build(path, log)
    print('build: %d libraries %.1f s' % (len(LIBRARIES),
                                          time.perf_counter() - t0),
          flush=True)


def _check_hmma(name, path, what):
    """Count the HMMA (tensor-core) instructions in library ``name``'s SASS
    (cuobjdump next to nvcc); fail if there are none."""
    from paddle_tpu_torch.ops.kernels import _build
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), 'cuobjdump')
    sass = subprocess.run([cuobjdump, '-sass', str(path)], capture_output=True,
                          text=True, timeout=300)
    check(sass.returncode == 0, 'cuobjdump -sass failed: %s' % sass.stderr)
    hmma = [ln.split()[1] for ln in sass.stdout.splitlines()
            if 'HMMA' in ln and len(ln.split()) > 1]
    kinds = sorted(set(h for h in hmma if h.startswith('HMMA')))
    print('build: %s SASS holds %d HMMA instructions (%s)' %
          (name, len(hmma), ', '.join(kinds)), flush=True)
    check(hmma, '%s: no HMMA instruction in its SASS: %s does not run on '
          'the tensor cores' % (name, what))


def _ptxas_table(log):
    """{mangled kernel name: (registers, spill bytes stored + loaded)} from
    ptxas -v output."""
    table, fn = {}, None
    for line in log.splitlines():
        if 'Function properties for' in line:
            fn = line.split('Function properties for')[1].strip()
            table[fn] = [0, 0]
        elif 'bytes spill stores' in line and fn:
            nums = [int(w) for w in line.replace(',', ' ').split()
                    if w.isdigit()]
            table[fn][1] = nums[1] + nums[2]  # stack frame, stores, loads
        elif 'Used' in line and 'registers' in line and fn:
            words = line.split()
            table[fn][0] = int(words[words.index('Used') + 1])
    return {f: tuple(v) for f, v in table.items()}


def check_bwd_build(path, log):
    """The LSTM backward library: its dW kernel runs on the tensor cores
    (HMMA in the SASS), and no f32 instantiation of the walk spills; prints
    every walk and dW instantiation's registers and spills."""
    import re
    _check_hmma('lstm_bwd', path, 'the dW kernel')
    if log is None:
        print('build: lstm_bwd spills: not checked (previous build reused)')
        return
    names = {'f': 'f32', '13__nv_bfloat16': 'bf16'}
    walk_f32 = []
    for fn, (regs, spill) in sorted(_ptxas_table(log).items()):
        walk = re.search(r'lstm_bwd_walk_kernelI(f|13__nv_bfloat16)Li(\d)E',
                         fn)
        dw = re.search(r'lstm_dw_partial_kernelI(f|13__nv_bfloat16)E', fn)
        if walk:
            what = 'walk %s UW=%s' % (names[walk.group(1)], walk.group(2))
            if walk.group(1) == 'f':
                walk_f32.append(spill)
        elif dw:
            what = 'dW %s' % names[dw.group(1)]
        else:
            continue
        print('build: lstm_bwd %-16s %3d registers, %d spill bytes' %
              (what, regs, spill), flush=True)
    check(len(walk_f32) == 3 and not any(walk_f32),
          'lstm_bwd: an f32 walk instantiation spills or is missing: %s' %
          walk_f32)


def check_lstm_fwd_build(log):
    """The LSTM forward library: no instantiation of its kernel (f32, bf16)
    spills; prints each one's registers and spills."""
    import re
    if log is None:
        print('build: lstm_fwd spills: not checked (previous build reused)')
        return
    found = {}
    for fn, (regs, spill) in sorted(_ptxas_table(log).items()):
        m = re.search(r'lstm_fwd_kernelI(f|13__nv_bfloat16)E', fn)
        if m:
            dtype = 'f32' if m.group(1) == 'f' else 'bf16'
            found[dtype] = spill
            print('build: lstm_fwd %-4s %3d registers, %d spill bytes' %
                  (dtype, regs, spill), flush=True)
    check(sorted(found) == ['bf16', 'f32'] and not any(found.values()),
          'lstm_fwd: an instantiation spills or is missing: %s' % found)


def check_fwd_build(path, log):
    """The forward library runs on the tensor cores (HMMA instructions in its
    SASS, counted with cuobjdump) and its f32 instantiations spill nothing
    (ptxas; checked when this run compiled the library)."""
    _check_hmma('flash_attention_fwd', path, 'the forward kernel')
    if log is None:
        print('build: flash_attention_fwd spills: not checked (previous '
              'build reused)')
        return
    spills = {f: n for f, (_, n) in _ptxas_table(log).items()}
    f32 = {f: n for f, n in spills.items() if 'fwd_kernelIf' in f}
    print('build: flash_attention_fwd f32 instantiations, spill bytes '
          '(stores + loads): %s' % ', '.join(
              '%s %d' % (f[f.index('fwd_kernelIf'):][:17], n)
              for f, n in sorted(f32.items())), flush=True)
    check(len(f32) == 4 and not any(f32.values()),
          'flash_attention_fwd: f32 instantiations spill or are missing: %s'
          % f32)


def check_flash_bwd_build(path, log):
    """The flash backward library runs on the tensor cores (HMMA in its
    SASS), and none of the 8 f32 instantiations of its dQ and dK/dV kernels
    spills; prints every instantiation's registers and spills."""
    import re
    _check_hmma('flash_attention_bwd', path, 'the dQ and dK/dV kernels')
    if log is None:
        print('build: flash_attention_bwd spills: not checked (previous '
              'build reused)')
        return
    f32 = []
    for fn, (regs, spill) in sorted(_ptxas_table(log).items()):
        m = re.search(r'(dq|dkv)_kernelI(f|13__nv_bfloat16)Li(\d+)E', fn)
        if not m:
            continue
        dtype = 'f32' if m.group(2) == 'f' else 'bf16'
        if dtype == 'f32':
            f32.append(spill)
        print('build: flash_attention_bwd %-3s %-4s D=%-3s %3d registers, %d '
              'spill bytes' % (m.group(1), dtype, m.group(3), regs, spill),
              flush=True)
    check(len(f32) == 8 and not any(f32),
          'flash_attention_bwd: an f32 instantiation spills or is missing: '
          '%s' % f32)


def _qkv(b, lq, lk, h, d, dtype, seed):
    g = torch.Generator(device='cuda')
    g.manual_seed(seed)
    mk = lambda l: torch.randn(b, l, h, d, device='cuda', generator=g).to(
        dtype)
    return mk(lq), mk(lk), mk(lk)


def phase_kernel_vs_plain():
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    b, h = 4, 8
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in fa.SUPPORTED_HEAD_DIMS:
            for lq, lk in ((256, 256), (256, 200), (200, 200)):
                for causal in (False, True):
                    for with_lens in (False, True):
                        q, k, v = _qkv(b, lq, lk, h, d, dtype, SEED + n)
                        lens = (torch.tensor([0, 37, lk - 1, lk],
                                             dtype=torch.int32, device='cuda')
                                if with_lens else None)
                        o, lse = fa.flash_attention_fwd(
                            q, k, v, causal=causal, seq_lengths=lens)
                        po, plse = fa.flash_attention_plain(
                            q, k, v, causal=causal, seq_lengths=lens)
                        torch.cuda.synchronize()
                        tol = TOL[dtype]
                        err_o = (o.float() - po.float()).abs().max().item()
                        err_l = (lse - plse).abs().max().item()
                        case = ('%s D=%d Lq=%d Lk=%d causal=%s lens=%s' %
                                (str(dtype)[6:], d, lq, lk, causal,
                                 with_lens))
                        check(torch.allclose(o.float(), po.float(), rtol=tol,
                                             atol=tol) and
                              torch.allclose(lse, plse, rtol=tol, atol=tol),
                              'kernel disagrees with plain: %s: max|dO|=%g '
                              'max|dLSE|=%g (tol %g)' % (case, err_o, err_l,
                                                         tol))
                        worst[dtype] = max(worst[dtype], err_o)
                        n += 1
                        print('kernel vs plain: %-52s max|dO|=%.3g '
                              'max|dLSE|=%.3g' % (case, err_o, err_l))
    print('kernel vs plain: %d cases agree; worst max|dO| f32 %.3g (tol '
          '1e-4), bf16 %.3g (tol 2e-2)' % (n, worst[torch.float32],
                                          worst[torch.bfloat16]), flush=True)
    return worst[torch.float32]


def phase_bwd_vs_plain():
    """dQ, dK, dV of the kernels against flash_attention_bwd_plain on the
    same (q, k, v, O, LSE, dO), over the forward's grid of cases."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    b, h = 4, 8
    worst = {(dt, name): 0.0 for dt in TOL
             for name in ('dq', 'dk', 'dv', 'delta')}
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in fa.SUPPORTED_HEAD_DIMS:
            for lq, lk in ((256, 256), (256, 200), (200, 200)):
                for causal in (False, True):
                    for with_lens in (False, True):
                        q, k, v = _qkv(b, lq, lk, h, d, dtype, SEED + 500 + n)
                        do = _qkv(b, lq, lq, h, d, dtype, SEED + 900 + n)[0]
                        lens = (torch.tensor([0, 37, lk - 1, lk],
                                             dtype=torch.int32, device='cuda')
                                if with_lens else None)
                        o, lse = fa.flash_attention_plain(
                            q, k, v, causal=causal, seq_lengths=lens)
                        got = fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                     causal=causal,
                                                     seq_lengths=lens)
                        want = fa.flash_attention_bwd_plain(
                            q, k, v, o, lse, do, causal=causal,
                            seq_lengths=lens)
                        # the delta that the dQ kernel writes for dK/dV
                        delta = fa._launch_dq(
                            q, k, v, o, do, lse, fa._lengths(lens, b, q.device),
                            causal, d**-0.5)[1]
                        got += (delta, )
                        want += (fa.bwd_delta(o, do), )
                        torch.cuda.synchronize()
                        case = ('%s D=%d Lq=%d Lk=%d causal=%s lens=%s' %
                                (str(dtype)[6:], d, lq, lk, causal,
                                 with_lens))
                        errs = []
                        for name, g, w in zip(('dq', 'dk', 'dv', 'delta'),
                                              got, want):
                            scale = max(1.0, w.float().abs().max().item())
                            err = (g.float() - w.float()).abs().max().item()
                            check(err <= TOL[dtype] * scale,
                                  'backward kernel disagrees with plain: %s: '
                                  'max|%s| err %g > %g * %g' %
                                  (case, name, err, TOL[dtype], scale))
                            worst[dtype, name] = max(worst[dtype, name], err)
                            errs.append(err)
                        n += 1
                        print('bwd vs plain: %-52s max|ddQ|=%.3g max|ddK|=%.3g'
                              ' max|ddV|=%.3g max|ddelta|=%.3g' %
                              ((case, ) + tuple(errs)))
    for dtype in TOL:
        print('bwd vs plain: %s worst max|ddQ| %.3g, max|ddK| %.3g, max|ddV| '
              '%.3g, max|ddelta| %.3g (tol %g * max(1, max|plain|))' %
              ((str(dtype)[6:], ) +
               tuple(worst[dtype, g] for g in ('dq', 'dk', 'dv', 'delta')) +
               (TOL[dtype], )))
    print('bwd vs plain: %d cases agree' % n, flush=True)
    return {'dq': worst[torch.float32, 'dq'],
            'dkv': max(worst[torch.float32, 'dk'],
                       worst[torch.float32, 'dv'])}


def _lstm_inputs(dtype, b, t, d, ragged, seed):
    """Recurrence inputs on the card.  W is scaled by 1/sqrt(D): at a fixed
    scale the recurrence turns chaotic as D grows (with N(0, 0.2^2) weights
    the plain version's own f32 and f64 runs part at D=512 after 64 steps),
    and a chaotic recurrence magnifies any summation-order difference."""
    g = torch.Generator(device='cuda')
    g.manual_seed(seed)
    rnd = lambda scale, *shape: torch.randn(*shape, device='cuda',
                                            generator=g) * scale
    xs = rnd(0.3, t, b, 4 * d).to(dtype)
    w = rnd(d**-0.5, d, 4 * d).to(dtype)
    bias = rnd(0.1, 1, 4 * d)
    h0, c0 = rnd(0.5, b, d).to(dtype), rnd(0.5, b, d)
    if ragged:
        lens = torch.randint(0, t + 1, (b, ), device='cuda', generator=g)
        lens[0], lens[-1] = 0, t
    else:
        lens = torch.full((b, ), t, device='cuda')
    mask = (torch.arange(t, device='cuda')[:, None] <
            lens[None, :]).float().contiguous()
    dhs, dcs = rnd(1.0, t, b, d).to(dtype), rnd(1.0, t, b, d)
    return xs, w, bias, h0, c0, mask, dhs, dcs


def phase_lstm_vs_plain():
    """The LSTM forward kernel (with and without the saved activations), the
    backward walk and the dW kernel against lstm_fwd_plain / lstm_bwd_plain
    on the same inputs (the backward on the plain forward's hs, cs, acts)."""
    from paddle_tpu_torch.ops.kernels import lstm as lk
    worst = {(dt, k): 0.0 for dt in LSTM_TOL
             for k in ('lstm_fwd', 'lstm_bwd', 'lstm_dw')}
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in LSTM_WIDTHS:
            for b in (LSTM_BATCH, 13):
                for t in (LSTM_MAX_LEN, 1):
                    for ragged in (False, True):
                        xs, w, bias, h0, c0, mask, dhs, dcs = _lstm_inputs(
                            dtype, b, t, d, ragged, SEED + 2000 + n)
                        plain = lk.lstm_fwd_plain(xs, w, bias, h0, c0, mask)
                        bare = lk.lstm_fwd(xs, w, bias, h0, c0, mask,
                                           save_acts=False)
                        full = lk.lstm_fwd(xs, w, bias, h0, c0, mask)
                        phs, pcs, pacts = plain
                        got_b = lk.lstm_bwd(w, mask, pacts, pcs, phs, h0, c0,
                                            dhs, dcs)
                        want_b = lk.lstm_bwd_plain(w, mask, pacts, pcs, phs,
                                                   h0, c0, dhs, dcs)
                        torch.cuda.synchronize()
                        case = '%s D=%d B=%d T=%d %s N=%d/%d' % (
                            str(dtype)[6:], d, b, t,
                            'ragged' if ragged else 'full',
                            lk.fwd_cluster(b, d, dtype),
                            lk.walk_cluster(b, d, dtype))
                        pairs = [('lstm_fwd', 'hs', bare[0], phs),
                                 ('lstm_fwd', 'cs', bare[1], pcs),
                                 ('lstm_fwd', 'hs+acts', full[0], phs),
                                 ('lstm_fwd', 'cs+acts', full[1], pcs),
                                 ('lstm_fwd', 'acts', full[2], pacts)]
                        pairs += [(k, name, g_, w_) for k, name, g_, w_ in zip(
                            ('lstm_bwd', 'lstm_dw', 'lstm_dw', 'lstm_bwd',
                             'lstm_bwd'), ('dx', 'dW', 'db', 'dh0', 'dc0'),
                            got_b, want_b)]
                        errs = []
                        for kernel, name, got, want in pairs:
                            scale = max(1.0, want.float().abs().max().item())
                            err = (got.float() - want.float()).abs().max().item()
                            check(got.shape == want.shape and
                                  err <= LSTM_TOL[dtype] * scale,
                                  'LSTM kernel disagrees with plain: %s: '
                                  'max|d%s| %g > %g * %g' %
                                  (case, name, err, LSTM_TOL[dtype], scale))
                            worst[dtype, kernel] = max(worst[dtype, kernel],
                                                       err)
                            errs.append('%s %.2g' % (name, err))
                        n += 1
                        print('lstm vs plain: %-32s %s' % (case,
                                                           ', '.join(errs)))
    for dtype in LSTM_TOL:
        print('lstm vs plain: %s worst max|d| forward %.3g, walk %.3g, dW/db '
              '%.3g (tol %g * max(1, max|plain|))' %
              ((str(dtype)[6:], ) +
               tuple(worst[dtype, k] for k in ('lstm_fwd', 'lstm_bwd',
                                               'lstm_dw')) +
               (LSTM_TOL[dtype], )))
    print('lstm vs plain: %d cases agree (N: the forward\'s / the walk\'s CTAs '
          'a cluster)' % n, flush=True)
    check_cluster_choices()
    check_fwd_clusters()
    check_walk_clusters()
    return {k: worst[torch.float32, k]
            for k in ('lstm_fwd', 'lstm_bwd', 'lstm_dw')}


def check_cluster_choices():
    """At every width the kernels take, f32 and bf16, B 128 and 13: the
    cluster size each LSTM library picks is one its plan takes."""
    from paddle_tpu_torch.ops.kernels import lstm as lk
    for dtype in (torch.float32, torch.bfloat16):
        picks = []
        for d in range(32, 513, 32):
            fwd_sizes = lk.fwd_cluster_sizes(d, dtype)
            walk_sizes = lk.walk_cluster_sizes(d, dtype)
            for b in (LSTM_BATCH, 13):
                nf = lk.fwd_cluster(b, d, dtype)
                nw = lk.walk_cluster(b, d, dtype)
                check(nf in fwd_sizes and nw in walk_sizes,
                      'lstm: %s D=%d B=%d: the libraries pick clusters of '
                      '%d (forward; its plan takes %s) and %d (walk; %s)' %
                      (str(dtype)[6:], d, b, nf, fwd_sizes, nw, walk_sizes))
                picks.append('%d/%d' % (nf, nw))
            picks[-2:] = ['%d:%s,%s' % (d, picks[-2], picks[-1])]
        print('lstm clusters: %s, D:forward/walk N at B=%d,13: %s; each a '
              'size its plan takes' % (str(dtype)[6:], LSTM_BATCH,
                                       ' '.join(picks)), flush=True)


def check_fwd_clusters():
    """The forward at every cluster size its plan takes, against the plain
    version (hs, cs, acts) within LSTM_TOL, and bitwise against the size the
    library picks: each sum over k runs in the same order whichever CTA owns
    the unit."""
    from paddle_tpu_torch.ops.kernels import lstm as lk
    for dtype in (torch.float32, torch.bfloat16):
        for d in (32, 128, 288, 480, 512):
            for b in (LSTM_BATCH, 13):
                xs, w, bias, h0, c0, mask, _, _ = _lstm_inputs(
                    dtype, b, LSTM_MAX_LEN, d, True, SEED + 4000 + d + b)
                args = (xs, w, bias, h0, c0, mask, True)
                want = lk.lstm_fwd_plain(*args)
                picked = lk._launch_fwd(*args)
                same = []
                for n in lk.fwd_cluster_sizes(d, dtype):
                    got = lk._launch_fwd(*args, cluster=n)
                    torch.cuda.synchronize()
                    for name, g, w_ in zip(('hs', 'cs', 'acts'), got, want):
                        scale = max(1.0, w_.float().abs().max().item())
                        err = (g.float() - w_.float()).abs().max().item()
                        check(err <= LSTM_TOL[dtype] * scale,
                              'lstm forward: %s D=%d B=%d with clusters of %d '
                              'CTAs: max|d%s| %g > %g * %g' %
                              (str(dtype)[6:], d, b, n, name, err,
                               LSTM_TOL[dtype], scale))
                    check(all(torch.equal(g, p_) for g, p_ in zip(got, picked)),
                          'lstm forward: %s D=%d B=%d with clusters of %d CTAs '
                          'is not bitwise the picked size\'s' %
                          (str(dtype)[6:], d, b, n))
                    same.append(str(n))
                print('lstm forward: %s D=%d B=%d T=%d ragged: clusters of %s '
                      'CTAs agree with plain and bitwise with the picked size, '
                      '%d' % (str(dtype)[6:], d, b, LSTM_MAX_LEN,
                              ', '.join(same), lk.fwd_cluster(b, d, dtype)),
                      flush=True)


def check_walk_clusters():
    """The walk at every cluster size its plan takes, against the plain
    version (dx, dh0, dc0, and db as the sum of the clusters' rows) within
    LSTM_TOL, and bitwise against the size the library picks: each (row,
    unit) sum runs in the same order whichever CTA owns the unit."""
    from paddle_tpu_torch.ops.kernels import lstm as lk
    for dtype in (torch.float32, torch.bfloat16):
        for d, b in ((128, LSTM_BATCH), (128, 13), (32, LSTM_BATCH),
                     (480, LSTM_BATCH), (512, LSTM_BATCH)):
            xs, w, bias, h0, c0, mask, dhs, dcs = _lstm_inputs(
                dtype, b, LSTM_MAX_LEN, d, True, SEED + 3000 + d + b)
            hs, cs, acts = lk.lstm_fwd_plain(xs, w, bias, h0, c0, mask)
            args = (w, mask, acts, cs, h0, c0, dhs, dcs)
            want = lk.lstm_bwd_plain(w, mask, acts, cs, hs, h0, c0, dhs, dcs)
            want = (want[0], want[3], want[4], want[2][0])
            picked = lk._launch_walk(*args)
            same = []
            for n in lk.walk_cluster_sizes(d, dtype):
                got = lk._launch_walk(*args, cluster=n)
                torch.cuda.synchronize()
                got = got[:3] + (got[3].sum(0), )
                for name, g, w_ in zip(('dx', 'dh0', 'dc0', 'db'), got, want):
                    scale = max(1.0, w_.float().abs().max().item())
                    err = (g.float() - w_.float()).abs().max().item()
                    check(err <= LSTM_TOL[dtype] * scale,
                          'lstm walk: %s D=%d B=%d with clusters of %d CTAs: '
                          'max|d%s| %g > %g * %g' % (str(dtype)[6:], d, b, n,
                                                     name, err,
                                                     LSTM_TOL[dtype], scale))
                check(all(torch.equal(g, p_)
                          for g, p_ in zip(got[:3], picked[:3])),
                      'lstm walk: %s D=%d B=%d with clusters of %d CTAs is '
                      'not bitwise the picked size\'s' % (str(dtype)[6:], d,
                                                           b, n))
                same.append(str(n))
            print('lstm walk: %s D=%d B=%d T=%d ragged: clusters of %s CTAs '
                  'agree with plain and bitwise with the picked size, %d' %
                  (str(dtype)[6:], d, b, LSTM_MAX_LEN, ', '.join(same),
                   lk.walk_cluster(b, d, dtype)), flush=True)


def build_model():
    """Transformer-base at full width, training program included, with its
    startup run on the card."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import transformer
    cfg = TRANSFORMER_BASE
    with fluid.unique_name.guard():
        model = transformer.build(lr=LR, **cfg)
    model['startup'].random_seed = SEED
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    t0 = time.perf_counter()
    exe.run(model['startup'], scope=scope)
    torch.cuda.synchronize()
    n_params = sum(math.prod(p.shape)
                   for p in model['test'].all_parameters())
    print('model: Transformer-base %s, %d parameters, Adam lr %g, startup '
          '%.2f s' % (cfg, n_params, LR, time.perf_counter() - t0),
          flush=True)
    return model, scope, exe


KERNEL_KEYS = ('fwd', 'dq', 'dkv', 'lstm_fwd', 'lstm_bwd', 'lstm_dw')
# the device kernel counted for each launch key (a dW call launches its
# split-K products and one reduction: the reduction is counted)
DEVICE_KERNELS = {'fwd': 'fwd_kernel', 'dq': 'dq_kernel',
                  'dkv': 'dkv_kernel', 'lstm_fwd': 'lstm_fwd_kernel',
                  'lstm_bwd': 'lstm_bwd_walk_kernel',
                  'lstm_dw': 'lstm_dw_reduce_kernel'}


# the instantiation counted for each key when kernels are counted by dtype
# (the dW reduction is f32 whatever the dtype: its split-K products are
# counted instead)
DTYPE_KERNELS = dict(DEVICE_KERNELS, lstm_dw='lstm_dw_partial_kernel')


def _wrapper_counts():
    """Each kernel wrapper's launch count, by key.  A replay of a captured
    graph calls no wrapper: it counts nothing here."""
    from paddle_tpu_torch.ops import registry
    counts = registry.counts()
    return {k: counts[k] for k in KERNEL_KEYS}


def _zero_counts():
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import lstm as lk
    fa.LAUNCHES = fa.LAUNCHES_DQ = fa.LAUNCHES_DKV = 0
    lk.LAUNCHES_FWD = lk.LAUNCHES_BWD = lk.LAUNCHES_DW = 0


def _expect(**nonzero):
    """A full launch-count dict: the named counters, every other one 0."""
    out = dict.fromkeys(KERNEL_KEYS, 0)
    out.update(nonzero)
    return out


def _kernel_base(name):
    """A device activity's function name without namespace or template."""
    return _activity_name(name).split('<')[0].split()[-1].split('::')[-1]


def _kernel_dtype(name):
    """'bf16' or 'f32': the element type a hand-written kernel's template
    was instantiated with."""
    args = _activity_name(name).partition('<')[2]
    return 'bf16' if '__nv_bfloat16' in args else 'f32'


def _device_kernels(prof):
    """(the hand-written kernels a profiler session saw run on the card, by
    launch key; the session's device activities; the same kernels by
    instantiation, {'bf16': {key: n}, 'f32': {key: n}}, from
    DTYPE_KERNELS)."""
    by_name = {v: k for k, v in DEVICE_KERNELS.items()}
    by_dtype_name = {v: k for k, v in DTYPE_KERNELS.items()}
    seen = dict.fromkeys(KERNEL_KEYS, 0)
    kinds = {t: dict.fromkeys(KERNEL_KEYS, 0) for t in ('bf16', 'f32')}
    device = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device += 1
            base = _kernel_base(e.name)
            key = by_name.get(base)
            if key is not None:
                seen[key] += 1
            key = by_dtype_name.get(base)
            if key is not None:
                kinds[_kernel_dtype(e.name)][key] += 1
    return seen, device, kinds


def _check_dtype(tag, kinds, dtype, want=None):
    """No hand-written kernel of another instantiation than ``dtype`` ran,
    and (``want``) each key's count of ``dtype``'s."""
    other = 'f32' if dtype == 'bf16' else 'bf16'
    check(not any(kinds[other].values()),
          '%s: %s instantiations ran on the card: %s' %
          (tag, other, {k: v for k, v in kinds[other].items() if v}))
    if want is not None:
        check(kinds[dtype] == want, '%s: the %s instantiations ran %s, '
              'expected %s' % (tag, dtype, kinds[dtype], want))


class _Path(object):
    """A main path's launches over its run.  ``begin()`` sets every
    counter to 0 just before the path; ``call`` makes one call of it under
    torch.profiler and checks it; ``end()`` reads the counters just after.

    Each call's kernels are counted by name in the profiler's device
    activity, replays of captured graphs included, and must be ``want``;
    with ``dtype`` ('bf16' or 'f32') each must be that instantiation.
    The wrappers' counters must have grown by ``want`` in a call that ran
    the lowerings (the eager first call, a capture) and by nothing in a
    replay, which calls no wrapper; so must the lstm op's scan-path runs
    (``scans``).  The profiler sometimes drops events (``_device_ms``): a
    call whose session counted fewer kernels than ``want``, and none more,
    is printed and made again, five times at most over the path (it ran
    all the same: a training step's loss is kept)."""

    RETAKES = 5

    def __init__(self, tag, exe, dtype=None):
        self.tag, self.exe, self.dtype = tag, exe, dtype
        self.device = dict.fromkeys(KERNEL_KEYS, 0)
        self.by_dtype = {t: dict.fromkeys(KERNEL_KEYS, 0)
                         for t in ('bf16', 'f32')}
        self.ran = []
        self.retakes = 0

    def begin(self):
        _zero_counts()  # every launch counter to 0 just before the path
        return self

    def call(self, fn, want, scans=0):
        """``fn()``'s result and wall (host clock, the profiler on, up to
        the card's end of the call), once its session counted ``want``:
        (result, wall, kernels, ran) for each call made, the last one
        counted."""
        made = []
        while True:
            before, scans0 = _wrapper_counts(), _scan_runs()
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                result = fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            after = _wrapper_counts()
            wrapped = {k: after[k] - before[k] for k in KERNEL_KEYS}
            ran_scans = _scan_runs() - scans0
            ran = self.exe.cached_blocks()[-1].last_ran
            seen, device, kinds = _device_kernels(prof)
            made.append((result, wall, seen, ran))
            for k in KERNEL_KEYS:
                self.device[k] += seen[k]
                for t in kinds:
                    self.by_dtype[t][k] += kinds[t][k]
            self.ran.append(ran)
            lowered = ran != 'replay'
            check(wrapped == (want if lowered else _expect()) and
                  ran_scans == (scans if lowered else 0),
                  '%s: a call (%s) grew the wrappers\' counters by %s and '
                  'ran the scan path %d times, expected %s and %d' %
                  (self.tag, ran, wrapped, ran_scans,
                   want if lowered else _expect(), scans if lowered else 0))
            if seen == want:
                if self.dtype is not None:
                    # every hand-written kernel of the call in self.dtype
                    _check_dtype(self.tag, kinds, self.dtype,
                                 {k: want[k] for k in KERNEL_KEYS})
                return made
            short = all(seen[k] <= want[k] for k in KERNEL_KEYS)
            check(short and self.retakes < self.RETAKES,
                  '%s: the profiler counted %s run on the card in a call '
                  '(%s, %d device activities), expected %s' %
                  (self.tag, seen, ran, device, want))
            self.retakes += 1
            print('%s: profiler session counted %s of %s (%d device '
                  'activities, a %s call): the call is made again (%d of %d)'
                  % (self.tag, seen, want, device, ran, self.retakes,
                     self.RETAKES), flush=True)

    def end(self):
        """The path's counts: ``wrapper``, each wrapper's counter read just
        after the path, and ``device``, the kernels counted on the card."""
        self.wrapper = _wrapper_counts()
        return self

    def summary(self):
        ran = {r: self.ran.count(r) for r in ('eager', 'capture', 'replay')}
        return ('wrappers %s, on the card %s (profiler, by kernel name); '
                'calls %s%s' %
                ({k: v for k, v in self.wrapper.items() if v} or 'none',
                 {k: v for k, v in self.device.items() if v} or 'none',
                 ', '.join('%d %s' % (n, r) for r, n in ran.items() if n),
                 ', %d retaken' % self.retakes if self.retakes else ''))


def phase_slice(card, model, scope, exe):
    import paddle_tpu_torch.fluid as fluid
    cfg = TRANSFORMER_BASE
    seq, vocab = cfg['max_len'], cfg['trg_vocab']
    rng = np.random.RandomState(SEED)
    ids = lambda b: rng.randint(1, vocab, size=(b, seq)).astype('int64')
    requests = [{name: ids(BATCH) for name in model['feeds']}
                for _ in range(REQUESTS)]
    fetch = [model['loss'], model['prediction']]
    per_request = 3 * cfg['n_layer']
    walls = []
    torch.cuda.reset_peak_memory_stats()
    path = _Path('slice', exe, 'f32').begin()
    for i, feed in enumerate(requests):
        (loss, pred), wall, seen, ran = path.call(
            lambda: exe.run(model['test'], feed=feed, fetch_list=fetch,
                            scope=scope), _expect(fwd=per_request))[-1]
        walls.append(wall)
        grew = seen['fwd']
        check(loss.shape == (1, ) and np.isfinite(loss).all(),
              'request %d: loss %s is not finite' % (i, loss))
        check(pred.shape == (BATCH, seq, vocab) and np.isfinite(pred).all(),
              'request %d: prediction shape %s or values not finite' %
              (i, pred.shape))
        row_err = float(np.abs(pred.sum(-1, dtype=np.float64) - 1.0).max())
        check(row_err < 1e-4, 'request %d: prediction rows sum to 1 +- %g' %
              (i, row_err))
        print('slice: request %d (%s) wall %.4f s, loss %.6f, %d flash '
              'forwards on the card, max|row sum - 1| %.2g [%s]' %
              (i + 1, ran, wall, loss[0], grew, row_err, card), flush=True)
    launches = path.end()
    peak = torch.cuda.max_memory_allocated()
    steady = statistics.median(walls[1:])
    tokens = BATCH * seq
    print('slice: %d requests, launches %s (%d flash forwards per request); '
          'steady request wall %.4f s (median of requests 2-%d under '
          'torch.profiler; request 1 includes first-call set-up), %.0f '
          'target tokens/s (batch %d x seq %d, loss and full prediction '
          'fetched to the host); peak device memory %.1f MiB [%s]' %
          (REQUESTS, launches.summary(), per_request, steady, REQUESTS,
           tokens / steady, BATCH, seq, peak / 2**20, card), flush=True)

    # the same weights and one 2 x 256 batch on the card and on the CPU
    small = {name: ids(2) for name in model['feeds']}
    gloss, gpred = exe.run(model['test'], feed=small, fetch_list=fetch,
                           scope=scope)
    cpu_scope = fluid.Scope()
    fluid.params_from_numpy(
        model['test'],
        {p.name: scope.find_var(p.name).value().cpu().numpy()
         for p in model['test'].all_parameters()},
        scope=cpu_scope, place=fluid.CPUPlace())
    t0 = time.perf_counter()
    closs, cpred = fluid.Executor(fluid.CPUPlace()).run(
        model['test'], feed=small, fetch_list=fetch, scope=cpu_scope)
    cpu_s = time.perf_counter() - t0
    pred_err = float(np.abs(gpred - cpred).max())
    pred_rel = float((np.abs(gpred - cpred) /
                      np.maximum(np.abs(cpred), 1e-30)).max())
    loss_rel = float(abs(gloss[0] - closs[0]) / abs(closs[0]))
    check(np.allclose(gpred, cpred, rtol=SLICE_RTOL, atol=SLICE_ATOL) and
          loss_rel < SLICE_RTOL,
          'card and CPU disagree on the slice: max|dpred| %g (max rel %g), '
          'loss rel %g (rtol %g, atol %g)' % (pred_err, pred_rel, loss_rel,
                                              SLICE_RTOL, SLICE_ATOL))
    print('slice: card vs CPU on 2 x %d: loss %.6f vs %.6f (rel %.2g), '
          'max|dpred| %.3g, max rel %.3g (rtol %g, atol %g); CPU run %.2f s'
          % (seq, gloss[0], closs[0], loss_rel, pred_err, pred_rel,
             SLICE_RTOL, SLICE_ATOL, cpu_s), flush=True)
    return launches


def phase_train(card, model, scope, exe):
    """TRAIN_STEPS Adam steps of BATCH x seq on one fixed batch."""
    cfg = TRANSFORMER_BASE
    seq, vocab = cfg['max_len'], cfg['trg_vocab']
    rng = np.random.RandomState(SEED + 1)
    feed = {name: rng.randint(1, vocab, size=(BATCH, seq)).astype('int64')
            for name in model['feeds']}
    n_flash = 3 * cfg['n_layer']
    # the forward pass launches the forward kernel once per flash_attention
    # op; each op's generic grad replays its forward (one more forward
    # launch, eagerly: nothing merges it with the first) and then runs the
    # dQ and dK/dV kernels once each
    per_step = _expect(fwd=2 * n_flash, dq=n_flash, dkv=n_flash)
    losses, walls = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    path = _Path('train', exe, 'f32').begin()
    for step in range(TRAIN_STEPS):
        made = path.call(lambda: exe.run(model['main'], feed=feed,
                                         fetch_list=[model['loss']],
                                         scope=scope), per_step)
        for (loss, ), wall, seen, ran in made:
            check(loss.shape == (1, ) and np.isfinite(loss).all(),
                  'training step %d: loss %s is not finite' % (step + 1,
                                                                loss))
            losses.append(float(loss[0]))
            walls.append(wall)
        print('train: step %d (%s) wall %.4f s, loss %.6f, on the card %s '
              '[%s]' % (step + 1, ran, wall, losses[-1],
                        {k: v for k, v in seen.items() if v}, card),
              flush=True)
    launches = path.end()
    peak = torch.cuda.max_memory_allocated()
    check(all(b < a for a, b in zip(losses, losses[1:])),
          'training loss did not fall at every step: %s' % losses)
    steady = statistics.median(walls[1:])
    print('train: %d Adam steps (lr %g) on one %d x %d batch, loss %.6f -> '
          '%.6f, falling at every step; launches %s (%s per step); steady '
          'step wall %.4f s (median of steps 2-%d under torch.profiler; step '
          '1 includes first-call set-up), %.0f target tokens/s; peak device '
          'memory %.1f MiB [%s]' %
          (len(losses), LR, BATCH, seq, losses[0], losses[-1],
           launches.summary(), {k: v for k, v in per_step.items() if v},
           steady, len(walls), BATCH * seq / steady, peak / 2**20, card),
          flush=True)
    return launches


def phase_train_card_vs_cpu(card, model, scope, exe):
    """One Transformer training step on the card and on the CPU from the
    same state."""
    seq, vocab = TRANSFORMER_BASE['max_len'], TRANSFORMER_BASE['trg_vocab']
    rng = np.random.RandomState(SEED + 2)
    feed = {name: rng.randint(1, vocab, size=(2, seq)).astype('int64')
            for name in model['feeds']}
    compare_train_step(card, 'train', '2 x %d' % seq, model['main'],
                       model['loss'].name, feed, scope, exe, LR)


def compare_train_step(card, tag, what, main, loss_name, feed, scope, exe,
                       lr, tol=None, held=None):
    """Hand the card's state (every persistable var: parameters, optimizer
    accumulators, batch-norm running statistics, learning rate) to a
    CPUPlace() scope, run one step of ``main`` on each, and hold the card
    to the CPU (``tol``: TRAIN_TOL, the updated parameters within lr, unless
    given): the loss, every trainable parameter's ``@GRAD``, the updated
    parameters, and the updated momentum velocities and batch-norm running
    statistics where the program has them, and Adam's moments where
    ``tol`` has a ``moments`` entry.  A sparse gradient (a SelectedRows)
    must have the CPU's rows, and its values are held as a gradient.
    ``held``: the parameters whose gradients, updates and velocities are
    held (all by default); the others' gradients are printed over all.
    Returns the CPU scope."""
    import paddle_tpu_torch.fluid as fluid
    tol = tol or dict(TRAIN_TOL, param_max=lr)
    state = [v.name for v in main.list_vars() if v.persistable]
    cpu_scope = fluid.Scope()
    fluid.persistables_from_numpy(
        main, {n: scope.find_var(n).value().cpu().numpy() for n in state},
        scope=cpu_scope, place=fluid.CPUPlace())
    params = [p.name for p in main.all_parameters() if p.trainable]
    held = params if held is None else held
    fetch = [loss_name] + [p + '@GRAD' for p in params]
    got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    t0 = time.perf_counter()
    want = fluid.Executor(fluid.CPUPlace()).run(main, feed=feed,
                                                fetch_list=fetch,
                                                scope=cpu_scope)
    cpu_s = time.perf_counter() - t0
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(w, fluid.core.SelectedRows):
            check(isinstance(g, fluid.core.SelectedRows) and
                  g.rows() == w.rows() and g.height() == w.height(),
                  '%s step, card vs CPU: %s is %r on the card, %r on the CPU'
                  ' (or their rows differ)' % (tag, fetch[i], g, w))
            got[i], want[i] = np.asarray(g.get_tensor()), \
                np.asarray(w.get_tensor())
    loss_rel = float(abs(got[0][0] - want[0][0]) / max(abs(want[0][0]),
                                                        1e-30))
    check(loss_rel < tol['loss'], '%s step, card vs CPU: loss %.7f vs %.7f '
          '(rel %g, tol %g)' % (tag, got[0][0], want[0][0], loss_rel,
                                tol['loss']))
    top = max(float(np.abs(w).max()) for n, w in zip(params, want[1:])
              if n in held)
    grad_err, diff_sq, norm_sq = 0.0, 0.0, 0.0
    own_err = (0.0, '')  # the worst max|dg| / max|g| and its parameter
    rest_sq = [0.0, 0.0]  # |dg|^2 and |g|^2 of the gradients not held
    for name, g, w in zip(params, got[1:], want[1:]):
        if name not in held:
            rest_sq[0] += float(np.square(g - w, dtype=np.float64).sum())
            rest_sq[1] += float(np.square(w, dtype=np.float64).sum())
            continue
        err = float(np.abs(g - w).max())
        own = float(np.abs(w).max())
        allowed = tol['grad_rtol'] * own + tol['grad_atol'] * top
        check(err <= allowed,
              '%s step, card vs CPU: %s@GRAD max|dg| %g > %g * %g + %g * %g'
              % (tag, name, err, tol['grad_rtol'], own, tol['grad_atol'],
                 top))
        grad_err = max(grad_err, err / allowed)
        own_err = max(own_err, (err / max(own, 1e-30), name))
        diff_sq += float(np.square(g - w, dtype=np.float64).sum())
        norm_sq += float(np.square(w, dtype=np.float64).sum())
    norm_err = math.sqrt(diff_sq / norm_sq)
    check(norm_err <= tol['grad_norm'], '%s step, card vs CPU: |dg| / |g| '
          'over all gradients %g (tol %g)' % (tag, norm_err,
                                              tol['grad_norm']))
    value = lambda s, n: s.find_var(n).value().cpu().numpy()
    worst, n_far, n_all = 0.0, 0, 0
    for name in held:
        dp = np.abs(value(scope, name) - value(cpu_scope, name))
        worst = max(worst, float(dp.max()))
        n_far += int((dp > tol['param_atol']).sum())
        n_all += dp.size
    check(worst <= tol['param_max'] and n_far <= tol['param_frac'] * n_all,
          '%s step, card vs CPU: updated parameters differ by up to %g '
          '(limit %g), %d of %d elements by more than %g (limit %g of '
          'them)' % (tag, worst, tol['param_max'], n_far, n_all,
                     tol['param_atol'], tol['param_frac']))
    ops = main.global_block().ops
    extra = {'velocity': sorted(n for op in ops if op.type == 'momentum' and
                                op.input('Param')[0] in held
                                for n in op.input('Velocity')),
             'stats': sorted(n for op in ops if op.type == 'batch_norm'
                             for n in op.input('Mean') + op.input('Variance'))}
    if 'moments' in tol:
        extra['moments'] = sorted(n for op in ops if op.type == 'adam'
                                  for n in op.input('Moment1') +
                                  op.input('Moment2'))
    state_err = {}
    for key, names in extra.items():
        for name in names:
            w = value(cpu_scope, name).astype(np.float64)
            err = float(np.linalg.norm(value(scope, name) - w) /
                        max(np.linalg.norm(w), 1e-30))
            check(err <= tol[key], '%s step, card vs CPU: %s |d| / |v| %g '
                  '(tol %g)' % (tag, name, err, tol[key]))
            state_err[key] = max(state_err.get(key, 0.0), err)
    states = ''.join(
        '; %d %s: worst |d| / |v| %.3g (tol %g)' %
        (len(extra[key]), {'velocity': 'velocities', 'stats':
                           'running statistics', 'moments': 'Adam moments'}[key],
         err, tol[key])
        for key, err in sorted(state_err.items()))
    if rest_sq[1]:
        states += '; the %d gradients not held: |dg| / |g| over all %.3g' % (
            len(params) - len(held), math.sqrt(rest_sq[0] / rest_sq[1]))
    print('%s: card vs CPU, one step on %s from the same state: loss %.6f vs '
          '%.6f (rel %.2g, tol %g); %d gradients: the worst max|dg| is %.3g '
          'of its allowance (%g of its max|g| + %g of the largest, %.3g; '
          'the worst max|dg| / max|g| %.3g, %s), |dg| / |g| over all %.3g '
          '(tol %g); updated parameters: max|dp| %.3g (limit %g), %d of %d '
          'elements differ by more than %g (limit %g of them)%s; CPU step '
          '%.2f s [%s]' %
          (tag, what, got[0][0], want[0][0], loss_rel, tol['loss'],
           len(held), grad_err, tol['grad_rtol'], tol['grad_atol'], top,
           own_err[0], own_err[1], norm_err, tol['grad_norm'], worst,
           tol['param_max'], n_far, n_all, tol['param_atol'],
           tol['param_frac'], states, cpu_s, card), flush=True)
    return cpu_scope


def stacked_lstm_programs(fluid, use_peepholes=True, dict_dim=5149,
                          class_dim=2, emb_dim=128, hid_dim=128,
                          stacked_num=3, lr=0.002):
    """``stacked_lstm.build()``'s programs, built with the public
    ``fluid.layers`` of ``fluid`` (either package) with every LSTM's
    ``use_peepholes`` chosen: True gives the model as built, False the same
    net at the same widths, whose LSTMs the kernels take."""
    main, startup = fluid.Program(), fluid.Program()
    layers = fluid.layers
    with fluid.program_guard(main, startup):
        data = layers.data(name='words', shape=[1], dtype='int64',
                           lod_level=1)
        label = layers.data(name='label', shape=[1], dtype='int64')
        emb = layers.embedding(input=data, size=[dict_dim, emb_dim],
                               is_sparse=False)
        fc1 = layers.fc(input=emb, size=hid_dim * 4)
        lstm1, _ = layers.dynamic_lstm(input=fc1, size=hid_dim * 4,
                                       use_peepholes=use_peepholes)
        inputs = [fc1, lstm1]
        for i in range(2, stacked_num + 1):
            fc = layers.fc(input=inputs, size=hid_dim * 4)
            lstm, _ = layers.dynamic_lstm(input=fc, size=hid_dim * 4,
                                          use_peepholes=use_peepholes,
                                          is_reverse=(i % 2) == 0)
            inputs = [fc, lstm]
        fc_last = layers.sequence_pool(input=inputs[0], pool_type='max')
        lstm_last = layers.sequence_pool(input=inputs[1], pool_type='max')
        prediction = layers.fc(input=[fc_last, lstm_last], size=class_dim,
                               act='softmax')
        loss = layers.mean(layers.cross_entropy(input=prediction,
                                                label=label))
        acc = layers.accuracy(input=prediction, label=label)
        test = main.clone(for_test=True)
        fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
    return dict(main=main, startup=startup, test=test,
                feeds=['words', 'label'], prediction=prediction, loss=loss,
                acc=acc)


def lstm_request(rng, rows):
    """A LoD request of ``rows`` sequences, lengths in [1, LSTM_MAX_LEN] with
    one row at LSTM_MAX_LEN, word ids and 0/1 labels, drawn from ``rng``."""
    import paddle_tpu_torch.fluid as fluid
    lengths = rng.randint(1, LSTM_MAX_LEN + 1, size=rows)
    lengths[rng.randint(rows)] = LSTM_MAX_LEN
    ids = rng.randint(0, STACKED_LSTM['dict_dim'],
                      size=(int(lengths.sum()), 1)).astype('int64')
    label = rng.randint(0, STACKED_LSTM['class_dim'],
                        size=(rows, 1)).astype('int64')
    return {'words': fluid.create_lod_tensor(ids, [lengths.tolist()]),
            'label': label}


def build_lstm_models():
    """The two forms of the stacked-LSTM model, {'kernel': no peepholes,
    'as built': stacked_lstm.build()}: (model, scope, executor), each with
    its startup run on the card."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import stacked_lstm
    forms = {}
    for form in ('kernel', 'as built'):
        with fluid.unique_name.guard():
            if form == 'as built':
                model = stacked_lstm.build(lr=LSTM_LR, **STACKED_LSTM)
            else:
                model = stacked_lstm_programs(fluid, use_peepholes=False,
                                              lr=LSTM_LR, **STACKED_LSTM)
        model['startup'].random_seed = SEED
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(model['startup'], scope=scope)
        forms[form] = (model, scope, exe)
    torch.cuda.synchronize()
    n_params = sum(math.prod(p.shape)
                   for p in forms['as built'][0]['test'].all_parameters())
    print('model: stacked LSTM %s, %d parameters as built (peepholes), Adam '
          'lr %g; FLAGS_fused_lstm=%r' % (STACKED_LSTM, n_params, LSTM_LR,
                                          fluid.FLAGS.fused_lstm),
          flush=True)
    return forms


_SCAN = {'runs': None}


def _scan_runs():
    """Runs of the lstm op's scan path through its lowering so far: the scan
    path's Python function counts its calls (a capture records the scan's
    kernels; its replays call no Python)."""
    from paddle_tpu_torch.ops import registry, sequence_ops
    if _SCAN['runs'] is None:
        _SCAN['runs'] = 0
        real = sequence_ops._lstm_scan

        def counted(*args):
            _SCAN['runs'] += 1
            return real(*args)

        sequence_ops._lstm_scan = counted
        registry.register_counter(lambda: {'lstm_scan': _SCAN['runs']})
    return _SCAN['runs']


def phase_lstm_serve(card, forms):
    """Four 128-row LoD requests of each form's test program, then each
    form's 8-row request on the card and on the CPU."""
    import paddle_tpu_torch.fluid as fluid
    n_layers = STACKED_LSTM['stacked_num']
    rng = np.random.RandomState(SEED + 3)
    requests = [lstm_request(rng, LSTM_BATCH) for _ in range(REQUESTS)]
    small = lstm_request(rng, LSTM_CPU_ROWS)
    launches = None
    for form, (model, scope, exe) in forms.items():
        fetch = [model['prediction'], model['acc']]
        kernel = form == 'kernel'
        per_request = _expect(lstm_fwd=n_layers) if kernel else _expect()
        walls = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        path = _Path('lstm serve (%s)' % form, exe, 'f32').begin()
        for i, feed in enumerate(requests):
            (pred, acc), wall, grew, ran = path.call(
                lambda: exe.run(model['test'], feed=feed, fetch_list=fetch,
                                scope=scope), per_request,
                scans=0 if kernel else n_layers)[-1]
            walls.append(wall)
            row_err = float(np.abs(pred.sum(-1, dtype=np.float64) - 1).max())
            check(pred.shape == (LSTM_BATCH, STACKED_LSTM['class_dim']) and
                  np.isfinite(pred).all() and row_err < 1e-5 and
                  0 <= acc[0] <= 1,
                  'lstm serve (%s): request %d prediction %s, rows sum to 1 '
                  '+- %g, accuracy %s' % (form, i, pred.shape, row_err, acc))
            print('lstm serve (%s): request %d (%s) wall %.4f s, accuracy '
                  '%.4f, on the card %s [%s]' %
                  (form, i + 1, ran, wall, acc[0],
                   {k: v for k, v in grew.items() if v} or 'none', card),
                  flush=True)
        path.end()
        if kernel:
            launches = path
        steady = statistics.median(walls[1:])
        tokens = sum(len(r['words'].numpy()) for r in requests[1:]) / (
            REQUESTS - 1)
        print('lstm serve (%s): %d requests of %d rows (T=%d); launches %s; '
              'steady request wall %.4f s (median of requests 2-%d under '
              'torch.profiler), %.0f rows/s, %.0f tokens/s; peak device '
              'memory %.1f MiB [%s]' %
              (form, REQUESTS, LSTM_BATCH, LSTM_MAX_LEN, path.summary(),
               steady, REQUESTS, LSTM_BATCH / steady, tokens / steady,
               torch.cuda.max_memory_allocated() / 2**20, card), flush=True)

        gpred, gacc = exe.run(model['test'], feed=small, fetch_list=fetch,
                              scope=scope)
        cpu_scope = fluid.Scope()
        fluid.params_from_numpy(
            model['test'],
            {p.name: scope.find_var(p.name).value().cpu().numpy()
             for p in model['test'].all_parameters()},
            scope=cpu_scope, place=fluid.CPUPlace())
        cpred, cacc = fluid.Executor(fluid.CPUPlace()).run(
            model['test'], feed=small, fetch_list=fetch, scope=cpu_scope)
        err = float(np.abs(gpred - cpred).max())
        check(np.allclose(gpred, cpred, rtol=LSTM_PRED_RTOL,
                          atol=LSTM_PRED_ATOL),
              'lstm serve (%s): card and CPU disagree: max|dpred| %g (rtol '
              '%g, atol %g)' % (form, err, LSTM_PRED_RTOL, LSTM_PRED_ATOL))
        # accuracy may differ only through a row the two sides nearly tie on
        ties = int((np.abs(cpred[:, 0] - cpred[:, 1]) < 2 * err + 1e-7).sum())
        check(abs(gacc[0] - cacc[0]) * LSTM_CPU_ROWS <= ties + 1e-6,
              'lstm serve (%s): accuracy %g on the card, %g on the CPU' %
              (form, gacc[0], cacc[0]))
        print('lstm serve (%s): card vs CPU on %d rows: max|dpred| %.3g (rtol '
              '%g, atol %g), accuracy %.4f vs %.4f [%s]' %
              (form, LSTM_CPU_ROWS, err, LSTM_PRED_RTOL, LSTM_PRED_ATOL,
               gacc[0], cacc[0], card), flush=True)
    return launches


def phase_lstm_train(card, forms):
    """TRAIN_STEPS Adam steps of the kernel form on one 128-row batch."""
    model, scope, exe = forms['kernel']
    n = STACKED_LSTM['stacked_num']
    feed = lstm_request(np.random.RandomState(SEED + 4), LSTM_BATCH)
    # each lstm op: one forward launch without the activations in the
    # forward pass; its generic grad replays the forward (through LSTMCore,
    # saving the activations) and runs the walk and the dW kernels once
    per_step = _expect(lstm_fwd=2 * n, lstm_bwd=n, lstm_dw=n)
    losses, walls = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    path = _Path('lstm train', exe, 'f32').begin()
    for step in range(TRAIN_STEPS):
        made = path.call(lambda: exe.run(model['main'], feed=feed,
                                         fetch_list=[model['loss']],
                                         scope=scope), per_step)
        for (loss, ), wall, grew, ran in made:
            check(loss.shape == (1, ) and np.isfinite(loss).all(),
                  'lstm train: step %d loss %s is not finite' % (step + 1,
                                                                 loss))
            losses.append(float(loss[0]))
            walls.append(wall)
        print('lstm train: step %d (%s) wall %.4f s, loss %.6f, on the card '
              '%s [%s]' % (step + 1, ran, wall, losses[-1],
                           {k: v for k, v in grew.items() if v}, card),
              flush=True)
    launches = path.end()
    from paddle_tpu_torch.ops.kernels import lstm as lk
    print('lstm train: each walk launch runs clusters of %d CTAs (B=%d, D=%d,'
          ' f32)' % (lk.walk_cluster(LSTM_BATCH, STACKED_LSTM['hid_dim'],
                                     torch.float32), LSTM_BATCH,
                     STACKED_LSTM['hid_dim']), flush=True)
    check(all(b < a for a, b in zip(losses, losses[1:])),
          'lstm train: the loss did not fall at every step: %s' % losses)
    print('lstm train: %d Adam steps (lr %g) on one %d-row batch (T=%d), '
          'loss %.6f -> %.6f, falling at every step; launches %s (%s per '
          'step); steady step wall %.4f s (median of steps 2-%d under '
          'torch.profiler); peak device memory %.1f MiB [%s]' %
          (len(losses), LSTM_LR, LSTM_BATCH, LSTM_MAX_LEN, losses[0],
           losses[-1], launches.summary(),
           {k: v for k, v in per_step.items() if v},
           statistics.median(walls[1:]), len(walls),
           torch.cuda.max_memory_allocated() / 2**20, card), flush=True)
    return launches


def phase_lstm_train_card_vs_cpu(card, forms):
    """One training step of each form on the card and on the CPU from the
    same state (the kernel form after its five steps, the form as built from
    its startup)."""
    feed = lstm_request(np.random.RandomState(SEED + 5), LSTM_CPU_TRAIN_ROWS)
    for form, (model, scope, exe) in forms.items():
        compare_train_step(card, 'lstm train (%s)' % form,
                           '%d rows (T=%d)' % (LSTM_CPU_TRAIN_ROWS,
                                               LSTM_MAX_LEN),
                           model['main'], model['loss'].name, feed, scope,
                           exe, LSTM_LR)


def nmt_programs(use_peepholes=True, **widths):
    """``seq2seq.build()``'s programs (the widths of ``NMT`` unless given),
    built with the port's public layers with the encoder LSTM's
    ``use_peepholes`` chosen: True gives the model as built, False the same
    net at the same widths, whose LSTM the kernels take."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import seq2seq
    w = dict(NMT, **widths)
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src = layers.data(name='src_word_id', shape=[1], dtype='int64',
                          lod_level=1)
        trg = layers.data(name='target_language_word', shape=[1],
                          dtype='int64', lod_level=1)
        label = layers.data(name='target_language_next_word', shape=[1],
                            dtype='int64', lod_level=1)
        emb = layers.embedding(input=src, size=[w['src_dict_dim'],
                                                w['embedding_dim']])
        fc1 = layers.fc(input=emb, size=w['encoder_size'] * 4, act='tanh')
        encoder_out, _ = layers.dynamic_lstm(
            input=fc1, size=w['encoder_size'] * 4,
            use_peepholes=use_peepholes)
        encoder_proj = layers.fc(input=encoder_out, size=w['decoder_size'],
                                 bias_attr=False)
        encoder_last = layers.sequence_last_step(input=encoder_out)
        decoder_boot = layers.fc(input=encoder_last, size=w['decoder_size'],
                                 act='tanh')
        logits, valid_mask = seq2seq.train_decoder(
            decoder_boot, encoder_out, encoder_proj, trg, w['trg_dict_dim'],
            w['embedding_dim'], w['decoder_size'])
        prediction = layers.elementwise_mul(layers.softmax(logits),
                                            valid_mask)
        cost = layers.softmax_with_cross_entropy(logits, label)
        loss = layers.mean(layers.sequence_pool(input=cost, pool_type='sum'))
        test = main.clone(for_test=True)
        fluid.optimizer.Adam(learning_rate=NMT_LR).minimize(loss)
    return dict(main=main, startup=startup, test=test,
                feeds=['src_word_id', 'target_language_word',
                       'target_language_next_word'],
                prediction=prediction, loss=loss)


def decode_fetch(model):
    """The fetch list of a ``build_decode`` request: the stacked per-step
    ids, scores and parent rows of its beams, then the sentences and their
    scores."""
    dec = [op for op in model['main'].global_block().ops
           if op.type == 'beam_search_decode'][0]
    return [dec.input('Ids')[0], dec.input('Scores')[0],
            dec.input('ParentIdx')[0], model['sentence_ids'].name,
            model['sentence_scores'].name]


def _beam_hypotheses(ids, scores, parents, beam):
    """For each step, for each sentence, {token prefix: accumulated score}
    of its beams, from the stacked outputs of beam_search."""
    t_len, bk = ids.shape[0], ids.shape[1]
    ids = np.asarray(ids).reshape(t_len, bk)
    scores = np.asarray(scores).reshape(t_len, bk)
    parents = np.asarray(parents).reshape(t_len, bk).astype(np.int64)
    prefixes = [()] * bk
    out = []
    for t in range(t_len):
        prefixes = [prefixes[parents[t, r]] + (int(ids[t, r]), )
                    for r in range(bk)]
        out.append([{prefixes[r]: float(scores[t, r])
                     for r in range(s * beam, (s + 1) * beam)}
                    for s in range(bk // beam)])
    return out, prefixes


def compare_beams(got, want, beam, tol):
    """Tie-aware comparison of two runs of a ``build_decode`` request,
    each the fetches of ``decode_fetch`` (``want`` the reference).

    Exact ids cannot be required everywhere: where two candidates' scores
    lie within rounding of each other, either side may keep either, and
    from there that sentence's beams follow other histories.  So, step by
    step for each sentence: where both sides hold the same beams (token
    prefixes), every beam's score agrees within ``tol``; where they differ,
    every beam held by one side only must be at the edge of that side's top
    K, within ``tol`` of its lowest score (not clear of the candidate that
    replaced it), and the sentence is compared no further.  A sentence that
    agrees to the last step has the same sentences and scores within
    ``tol``.  Each side's sentences must also be its own last beams
    backtracked, and its scores their last scores.

    Returns (problems, stats): a list of disagreements (empty when the runs
    agree) and {'max_score_err', 'compared_to_end', 'diverged': {sentence:
    step}}."""
    problems = []
    hyps = []
    for tag, run in (('got', got), ('want', want)):
        ids, scores, parents, sent, sent_scores = (np.asarray(a) for a in run)
        steps, last = _beam_hypotheses(ids, scores, parents, beam)
        hyps.append(steps)
        t_len, bk = ids.shape[0], ids.shape[1]
        backtracked = np.asarray(last).reshape(bk // beam, beam, t_len)
        if not np.array_equal(sent, backtracked):
            problems.append('%s: the sentences are not the last beams '
                            'backtracked' % tag)
        if not np.array_equal(sent_scores,
                              scores.reshape(t_len, bk)[-1].reshape(
                                  bk // beam, beam)):
            problems.append('%s: the sentence scores are not the last '
                            'step\'s' % tag)
    worst, diverged, to_end = 0.0, {}, 0
    for s in range(len(hyps[1][0])):
        for t in range(len(hyps[1])):
            g, w = hyps[0][t][s], hyps[1][t][s]
            if set(g) == set(w):
                err = max(abs(g[p] - w[p]) for p in w)
                worst = max(worst, err)
                if err > tol:
                    problems.append('sentence %d step %d: beam scores differ '
                                    'by %g (tol %g)' % (s, t, err, tol))
                    break
                continue
            edge_g, edge_w = min(g.values()), min(w.values())
            only = [(v, edge_g) for p, v in g.items() if p not in w] + \
                [(v, edge_w) for p, v in w.items() if p not in g]
            if abs(edge_g - edge_w) <= tol and all(v - edge <= tol
                                                   for v, edge in only):
                diverged[s] = t
            else:
                problems.append('sentence %d step %d: the beams differ away '
                                'from a near-tie: %s vs %s' %
                                (s, t, sorted(g.items(), key=lambda e: -e[1]),
                                 sorted(w.items(), key=lambda e: -e[1])))
            break
        else:
            to_end += 1
    return problems, {'max_score_err': worst, 'compared_to_end': to_end,
                      'diverged': diverged}


def nmt_batch(rng, pairs, target=True):
    """A LoD batch of ``pairs`` sentence pairs (of source sentences only
    without ``target``): lengths in [NMT_MIN_LEN, NMT_MAX_LEN] with one row
    at NMT_MAX_LEN on each side, word ids from 2 up, drawn from ``rng``;
    the labels are the target ids shifted by one, end id 1 last."""
    import paddle_tpu_torch.fluid as fluid

    def sentences(vocab):
        n = rng.randint(NMT_MIN_LEN, NMT_MAX_LEN + 1, size=pairs)
        n[rng.randint(pairs)] = NMT_MAX_LEN
        return n, rng.randint(2, vocab, size=(int(n.sum()), 1)).astype(
            'int64')

    src_len, src = sentences(NMT['src_dict_dim'])
    feed = {'src_word_id': fluid.create_lod_tensor(src, [src_len.tolist()])}
    if target:
        trg_len, trg = sentences(NMT['trg_dict_dim'])
        nxt = np.concatenate([np.append(r[1:], 1) for r in np.split(
            trg[:, 0], np.cumsum(trg_len)[:-1])])[:, None]
        feed['target_language_word'] = fluid.create_lod_tensor(
            trg, [trg_len.tolist()])
        feed['target_language_next_word'] = fluid.create_lod_tensor(
            nxt, [trg_len.tolist()])
    return feed


def _target_lengths(feed):
    return np.diff(feed['target_language_word'].lod()[-1])


def build_nmt_models():
    """The NMT model at full width, each with its startup run on the card
    from SEED: {'as built': seq2seq.build(), 'kernel': the same net without
    peepholes (nmt_programs), 'decode': seq2seq.build_decode()}, each
    (model, scope, executor)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import seq2seq
    models = {}
    t0 = time.perf_counter()
    for form in ('as built', 'kernel', 'decode'):
        with fluid.unique_name.guard():
            if form == 'as built':
                model = seq2seq.build(lr=NMT_LR, **NMT)
            elif form == 'kernel':
                model = nmt_programs(use_peepholes=False)
            else:
                model = seq2seq.build_decode(beam_size=NMT_BEAM,
                                             max_length=NMT_OUT_LEN, **NMT)
        model['startup'].random_seed = SEED
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(model['startup'], scope=scope)
        models[form] = (model, scope, exe)
    torch.cuda.synchronize()
    n_params = sum(math.prod(p.shape) for p in
                   models['as built'][0]['main'].all_parameters())
    print('model: seq2seq NMT %s, %d parameters as built (encoder LSTM with '
          'peepholes), Adam lr %g; build_decode beam %d, max_length %d; '
          'startups %.2f s' % (NMT, n_params, NMT_LR, NMT_BEAM, NMT_OUT_LEN,
                               time.perf_counter() - t0), flush=True)
    return models


def phase_nmt_serve(card, models):
    """The test program (teacher-forced, the prediction fetched): four
    128-pair requests as built, no kernel launch and one scan-path LSTM
    each, one of them under torch.profiler; two of the kernel form, one
    lstm_fwd launch each."""
    rng = np.random.RandomState(SEED + 10)
    requests = [nmt_batch(rng, NMT_BATCH) for _ in range(REQUESTS)]
    from paddle_tpu_torch.fluid.shape_policy import bucketed_len
    shape = (NMT_BATCH, bucketed_len(NMT_MAX_LEN), NMT['trg_dict_dim'])
    launches = None
    for form, n_req in (('as built', REQUESTS), ('kernel', 2)):
        model, scope, exe = models[form]
        kernel = form == 'kernel'
        per_request = _expect(lstm_fwd=1) if kernel else _expect()
        fetch = [model['prediction']]
        walls = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        path = _Path('nmt serve (%s)' % form, exe, 'f32').begin()
        for i, feed in enumerate(requests[:n_req]):
            (pred, ), wall, grew, ran = path.call(
                lambda: exe.run(model['test'], feed=feed, fetch_list=fetch,
                                scope=scope), per_request,
                scans=0 if kernel else 1)[-1]
            walls.append(wall)
            valid = np.arange(shape[1])[None, :] < \
                _target_lengths(feed)[:, None]
            row_err = float(np.abs(pred[valid].sum(-1, dtype=np.float64) -
                                   1).max()) if pred.shape == shape else 1.0
            check(pred.shape == shape and np.isfinite(pred).all() and
                  row_err < 1e-4 and not pred[~valid].any(),
                  'nmt serve (%s): request %d prediction %s (expected %s), '
                  'valid steps sum to 1 +- %g, padded steps nonzero: %s' %
                  (form, i, pred.shape, shape, row_err,
                   bool(pred[~valid].any())))
            print('nmt serve (%s): request %d (%s) wall %.4f s, max|row sum '
                  '- 1| %.2g, on the card %s [%s]' %
                  (form, i + 1, ran, wall, row_err,
                   {k: v for k, v in grew.items() if v} or 'none', card),
                  flush=True)
        path.end()
        if kernel:
            launches = path
            print('nmt serve (kernel): %d requests, launches %s (%s per '
                  'request) [%s]' % (n_req, path.summary(),
                                     {k: v for k, v in per_request.items()
                                      if v}, card), flush=True)
            continue
        peak = torch.cuda.max_memory_allocated()
        steady = statistics.median(walls[1:])
        tokens = statistics.mean(_target_lengths(r).sum()
                                 for r in requests[1:])
        prof = profile_run(lambda: exe.run(model['test'], feed=requests[0],
                                           fetch_list=fetch, scope=scope))
        print('nmt serve (as built): %d requests of %d pairs (T=%d, '
              'vocabulary %d); launches %s; steady request wall %.4f s '
              '(median of requests 2-%d under torch.profiler), %.1f pairs/s, %.0f target tokens/s (the [%d, %d, %d] '
              'prediction fetched to the host); peak device memory %.1f MiB; '
              'one request under torch.profiler: %s; most device time: %s '
              '[%s]' %
              (REQUESTS, NMT_BATCH, shape[1], shape[2], path.summary(),
               steady, REQUESTS, NMT_BATCH / steady, tokens / steady, shape[0], shape[1],
               shape[2], peak / 2**20, _busy_line(prof),
               _top_line(prof), card), flush=True)
    return launches


def phase_nmt_train(card, models):
    """Adam steps on one 128-pair batch: five as built (no kernel launch,
    two scan-path LSTM runs a step: the forward and its grad's replay), a
    sixth under torch.profiler; three of the kernel form with exact launch
    counts; the loss falling at every step of each; then one 2-pair step of
    each form on the card and on the CPU from the same state."""
    feed = nmt_batch(np.random.RandomState(SEED + 11), NMT_BATCH)
    tokens = int(_target_lengths(feed).sum())
    launches = None
    for form, steps in (('as built', TRAIN_STEPS), ('kernel', 3)):
        model, scope, exe = models[form]
        kernel = form == 'kernel'
        # the lstm op: the forward launch without the activations, and its
        # generic grad's replay (saving them), the walk and dW once each
        per_step = (_expect(lstm_fwd=2, lstm_bwd=1, lstm_dw=1) if kernel
                    else _expect())
        scans_per_step = 0 if kernel else 2
        step = lambda: exe.run(model['main'], feed=feed,
                               fetch_list=[model['loss']], scope=scope)
        losses, walls = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        path = _Path('nmt train (%s)' % form, exe, 'f32').begin()
        for i in range(steps):
            for (loss, ), wall, grew, ran in path.call(
                    step, per_step, scans=scans_per_step):
                check(loss.shape == (1, ) and np.isfinite(loss).all(),
                      'nmt train (%s): step %d loss %s is not finite' %
                      (form, i + 1, loss))
                losses.append(float(loss[0]))
                walls.append(wall)
            print('nmt train (%s): step %d (%s) wall %.4f s, loss %.6f, on '
                  'the card %s [%s]' %
                  (form, i + 1, ran, wall, losses[-1],
                   {k: v for k, v in grew.items() if v} or 'none', card),
                  flush=True)
        counts = path.end()
        peak = torch.cuda.max_memory_allocated()
        check(all(b < a for a, b in zip(losses, losses[1:])),
              'nmt train (%s): the loss did not fall at every step: %s' %
              (form, losses))
        steady = statistics.median(walls[1:])
        if kernel:
            launches = counts
            from paddle_tpu_torch.ops.kernels import lstm as lk
            busy = 'walk clusters of %d CTAs, forward clusters of %d' % (
                lk.walk_cluster(NMT_BATCH, NMT['encoder_size'],
                                torch.float32),
                lk.fwd_cluster(NMT_BATCH, NMT['encoder_size'],
                               torch.float32))
        else:
            prof = profile_run(step, recompute=True)
            busy = 'one step under torch.profiler: %s; most device time: %s' % (
                _busy_line(prof), _top_line(prof))
        print('nmt train (%s): %d Adam steps (lr %g) on one %d-pair batch '
              '(T=%d, %d target tokens), loss %.6f -> %.6f, falling at every '
              'step; launches %s (%s per step); steady step wall %.4f s '
              '(median of steps 2-%d under torch.profiler), %.0f target '
              'tokens/s; peak device memory %.1f MiB; %s [%s]' %
              (form, len(losses), NMT_LR, NMT_BATCH, NMT_MAX_LEN, tokens,
               losses[0], losses[-1], counts.summary(),
               {k: v for k, v in per_step.items() if v}, steady, len(walls),
               tokens / steady, peak / 2**20, busy, card), flush=True)
        compare_train_step(card, 'nmt train (%s)' % form,
                           '%d pairs' % NMT_CPU_PAIRS, model['main'],
                           model['loss'].name,
                           nmt_batch(np.random.RandomState(SEED + 12),
                                     NMT_CPU_PAIRS), scope, exe, NMT_LR,
                           NMT_TRAIN_TOL)
    return launches


def phase_nmt_decode(card, models):
    """build_decode at full width: four requests of 64 source sentences
    (beam 4, 16 steps), one under torch.profiler; then a 2-sentence request
    on the card and on the CPU from the same state, compared tie-aware."""
    import paddle_tpu_torch.fluid as fluid
    model, scope, exe = models['decode']
    rng = np.random.RandomState(SEED + 13)
    requests = [nmt_batch(rng, NMT_DECODE_BATCH, target=False)
                for _ in range(REQUESTS)]
    fetch = [model['sentence_ids'], model['sentence_scores']]
    shape = (NMT_DECODE_BATCH, NMT_BEAM, NMT_OUT_LEN)
    walls = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    path = _Path('nmt decode', exe, 'f32').begin()
    for i, feed in enumerate(requests):
        (ids, scores), wall, _, ran = path.call(
            lambda: exe.run(model['main'], feed=feed, fetch_list=fetch,
                            scope=scope), _expect(), scans=1)[-1]
        walls.append(wall)
        ended = ids == 1
        check(ids.shape == shape and scores.shape == shape[:2] and
              np.isfinite(scores).all() and
              (np.diff(scores, axis=1) <= 0).all() and
              (np.maximum.accumulate(ended, axis=2) == ended).all(),
              'nmt decode: request %d sentences %s, scores %s: expected %s, '
              'finite scores best first, a sentence ended stays ended' %
              (i, ids.shape, scores.shape, shape))
        print('nmt decode: request %d (%s) wall %.4f s, best scores %.4f .. '
              '%.4f, %d beams ended [%s]' %
              (i + 1, ran, wall, scores[:, 0].max(), scores[:, 0].min(),
               int(ended[..., -1].sum()), card), flush=True)
    path.end()
    peak = torch.cuda.max_memory_allocated()
    steady = statistics.median(walls[1:])
    prof = profile_run(lambda: exe.run(model['main'], feed=requests[0],
                                       fetch_list=fetch, scope=scope))
    print('nmt decode: %d requests of %d source sentences (lengths %d-%d), '
          'beam %d, %d steps; launches %s; steady request wall %.4f s '
          '(median of requests 2-%d under torch.profiler), %.1f sentences/s, %.0f generated tokens/s (%d a sentence, '
          'its best beam), %.0f beam-row tokens/s; peak device memory %.1f '
          'MiB; one request under torch.profiler: %s; most device time: %s '
          '[%s]' %
          (REQUESTS, NMT_DECODE_BATCH, NMT_MIN_LEN, NMT_MAX_LEN, NMT_BEAM,
           NMT_OUT_LEN, path.summary(), steady, REQUESTS, NMT_DECODE_BATCH / steady,
           NMT_DECODE_BATCH * NMT_OUT_LEN / steady, NMT_OUT_LEN,
           NMT_DECODE_BATCH * NMT_BEAM * NMT_OUT_LEN / steady, peak / 2**20,
           _busy_line(prof), _top_line(prof), card), flush=True)

    small = nmt_batch(rng, NMT_CPU_PAIRS, target=False)
    dfetch = decode_fetch(model)
    got = exe.run(model['main'], feed=small, fetch_list=dfetch, scope=scope)
    cpu_scope = fluid.Scope()
    fluid.persistables_from_numpy(
        model['main'], {v.name: scope.find_var(v.name).value().cpu().numpy()
                        for v in model['main'].list_vars() if v.persistable},
        scope=cpu_scope, place=fluid.CPUPlace())
    t0 = time.perf_counter()
    want = fluid.Executor(fluid.CPUPlace()).run(
        model['main'], feed=small, fetch_list=dfetch, scope=cpu_scope)
    cpu_s = time.perf_counter() - t0
    problems, stats = compare_beams(got, want, NMT_BEAM, NMT_BEAM_TOL)
    check(not problems, 'nmt decode, card vs CPU: %s' % '; '.join(problems))
    print('nmt decode: card vs CPU on %d sentences, tie-aware: beam scores '
          'max|d| %.3g (tol %g); %d sentences agree to the last step, %s '
          'part at a near-tie (sentence: step); best scores %s vs %s; CPU '
          'run %.2f s [%s]' %
          (NMT_CPU_PAIRS, stats['max_score_err'], NMT_BEAM_TOL,
           stats['compared_to_end'], stats['diverged'] or 'none',
           got[4][:, 0], want[4][:, 0], cpu_s, card), flush=True)


@contextlib.contextmanager
def cpu_ftz():
    """Denormal f32 values flushed to zero on the CPU while active: the
    CPU's convolutions and batch-norm gradients otherwise slow down many
    times over on them (the card's kernels do not)."""
    torch.set_flush_denormal(True)
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


RECOMPUTE = 'grad/recompute'
# device kernels of the convolutions: cuDNN's (its implicit GEMMs end in
# ``cudnn``, cuBLAS's in ``cublas``), its FFT algorithm's transforms and
# complex products, and its layout transposes
CONV_KERNELS = ('conv', 'cudnn', 'wgrad', 'dgrad', 'fprop', 'winograd',
                'fft', 'cf32', 'nchwtonhwc', 'nhwctonchw')


def profile_run(fn, trace_path=None, recompute=False):
    """Run fn once under torch.profiler: {'wall_s', 'busy_ms', 'by_name',
    'recompute_ms', 'top'}: the host wall of the run, the device time summed
    by kernel name and in all, and (``recompute``: each generic grad's
    ``torch.func.vjp`` call inside a ``grad/recompute`` range) the device
    time of the kernels the grads' forward replays launched.  Writes the
    Chrome trace to ``trace_path`` if given."""
    real_vjp = torch.func.vjp

    def annotated_vjp(f, *primals):
        with torch.profiler.record_function(RECOMPUTE):
            return real_vjp(f, *primals)

    if recompute:
        torch.func.vjp = annotated_vjp
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    try:
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        torch.func.vjp = real_vjp
    if trace_path:
        os.makedirs(os.path.dirname(trace_path), exist_ok=True)
        prof.export_chrome_trace(trace_path)
    by_name = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, 'self_device_time_total', None)
        if dev_us is None:
            dev_us = getattr(evt, 'self_cuda_time_total', 0)
        # a range's device-side span (idle gaps included) is no kernel
        if evt.key == RECOMPUTE:
            continue
        if dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.key] = by_name.get(evt.key, 0.0) + dev_us / 1e3
    # a host range's device time: the kernels its ops launched
    replay = sum(evt.device_time_total / 1e3 for evt in prof.events()
                 if evt.name == RECOMPUTE and
                 evt.device_type == torch.autograd.DeviceType.CPU)
    return {'wall_s': wall, 'busy_ms': sum(by_name.values()),
            'by_name': by_name, 'recompute_ms': replay,
            'top': sorted(by_name.items(), key=lambda kv: -kv[1])[:12]}


def conv_ms(prof):
    """Device time of the convolution kernels in a ``profile_run``."""
    return sum(ms for name, ms in prof['by_name'].items()
               if any(k in name.lower() for k in CONV_KERNELS))


def _top_line(prof, n=4):
    """The ``n`` kernels with the most device time in a ``profile_run``."""
    return ', '.join('%s %.3f ms' % (_activity_name(name)[:60], ms)
                     for name, ms in prof['top'][:n])


def _busy_line(prof):
    check(prof['busy_ms'] > 0, 'torch.profiler saw no device kernel')
    busy = prof['busy_ms']
    return ('device busy %.3f ms of %.4f s profiled wall (idle share %.3f)'
            '%s%s' %
            (busy, prof['wall_s'], 1 - busy / 1e3 / prof['wall_s'],
             '; convolution kernels %.3f ms (%.3f of busy)' %
             (conv_ms(prof), conv_ms(prof) / busy) if conv_ms(prof) else '',
             '; the grads\' forward replay %.3f ms (%.3f of busy)' %
             (prof['recompute_ms'], prof['recompute_ms'] / busy)
             if prof['recompute_ms'] else ''))


def build_cv_model(name, **kwargs):
    """One of the CV models (``resnet``, ``mnist``, ``vgg``) built with
    ``kwargs``, its startup run on the card from SEED: (model, scope,
    executor)."""
    import importlib
    import paddle_tpu_torch.fluid as fluid
    module = importlib.import_module('paddle_tpu_torch.models.' + name)
    with fluid.unique_name.guard():
        model = module.build(**kwargs)
    model['startup'].random_seed = SEED
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    t0 = time.perf_counter()
    exe.run(model['startup'], scope=scope)
    torch.cuda.synchronize()
    n_params = sum(math.prod(p.shape) for p in model['main'].all_parameters()
                   if p.trainable)
    print('model: %s %s, %d trainable parameters, startup %.2f s' %
          (name, kwargs, n_params, time.perf_counter() - t0), flush=True)
    return model, scope, exe


def image_batch(rng, batch, shape, classes):
    return {'img': rng.standard_normal((batch, ) + tuple(shape)).astype(
                'float32'),
            'label': rng.randint(0, classes, size=(batch, 1)).astype('int64')}


def _logits_name(program):
    """The input of the program's last softmax: the served logits."""
    return [op for op in program.global_block().ops
            if op.type == 'softmax'][-1].input('X')[0]


def compare_serve(card, tag, model, feed, scope, exe):
    """The test program on ``feed`` on the card and on the CPU with the same
    persistable state: softmax and logits within CV_SERVE_RTOL."""
    import paddle_tpu_torch.fluid as fluid
    test = model['test']
    fetch = [model['prediction'].name, _logits_name(test)]
    got = exe.run(test, feed=feed, fetch_list=fetch, scope=scope)
    cpu_scope = fluid.Scope()
    fluid.persistables_from_numpy(
        test, {v.name: scope.find_var(v.name).value().cpu().numpy()
               for v in test.list_vars() if v.persistable},
        scope=cpu_scope, place=fluid.CPUPlace())
    t0 = time.perf_counter()
    with cpu_ftz():
        want = fluid.Executor(fluid.CPUPlace()).run(
            test, feed=feed, fetch_list=fetch, scope=cpu_scope)
    cpu_s = time.perf_counter() - t0
    errs = []
    for name, g, w in zip(('softmax', 'logits'), got, want):
        check(g.shape == w.shape and np.isfinite(g).all(),
              '%s: card %s %s, CPU %s' % (tag, name, g.shape, w.shape))
        w = w.astype(np.float64)
        errs.append(float(np.linalg.norm(g - w) / np.linalg.norm(w)))
        check(errs[-1] <= CV_SERVE_RTOL, '%s: card and CPU disagree on the '
              '%s: |d| / |v| %g (tol %g)' % (tag, name, errs[-1],
                                             CV_SERVE_RTOL))
    print('%s: card vs CPU on %d images: |d| / |v| softmax %.3g, logits %.3g '
          '(tol %g), max|dlogit| %.3g; CPU run %.2f s [%s]' %
          (tag, len(feed['img']), errs[0], errs[1], CV_SERVE_RTOL,
           float(np.abs(got[1] - want[1]).max()), cpu_s, card), flush=True)


def _no_launches(tag):
    """No wrapper launched (a capture records only what the wrappers
    launched, so its replays launch none either)."""
    check(_wrapper_counts() == _expect(), '%s launched %s; no hand-written '
          'kernel lies on the CV path' % (tag, _wrapper_counts()))


def phase_resnet_serve(card, model, scope, exe):
    """Four 64-image requests of ResNet-50's test program (batch norm on
    its running statistics), the softmax fetched; one of them under
    torch.profiler; then a 2-image request on the card and on the CPU."""
    shape, classes = RESNET50['image_shape'], RESNET50['class_dim']
    rng = np.random.RandomState(SEED + 6)
    requests = [image_batch(rng, CV_BATCH, shape, classes)
                for _ in range(REQUESTS)]
    fetch = [model['prediction']]
    walls = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()  # every launch counter to 0 just before the serving path
    for i, feed in enumerate(requests):
        t0 = time.perf_counter()
        pred, = exe.run(model['test'], feed=feed, fetch_list=fetch,
                        scope=scope)
        walls.append(time.perf_counter() - t0)
        row_err = float(np.abs(pred.sum(-1, dtype=np.float64) - 1).max())
        check(pred.shape == (CV_BATCH, classes) and np.isfinite(pred).all()
              and row_err < 1e-4, 'resnet serve: request %d prediction %s, '
              'rows sum to 1 +- %g' % (i, pred.shape, row_err))
        print('resnet serve: request %d wall %.4f s, max|row sum - 1| %.2g '
              '[%s]' % (i + 1, walls[-1], row_err, card), flush=True)
    _no_launches('resnet serve')
    peak = torch.cuda.max_memory_allocated()
    steady = statistics.median(walls[1:])
    prof = profile_run(lambda: exe.run(model['test'], feed=requests[0],
                                       fetch_list=fetch, scope=scope))
    print('resnet serve: %d requests of %d x %s; steady request wall %.4f s '
          '(median of requests 2-%d; request 1 includes first-call set-up), '
          '%.1f images/s (softmax fetched to the host); peak device memory '
          '%.1f MiB; one request under torch.profiler: %s [%s]' %
          (REQUESTS, CV_BATCH, shape, steady, REQUESTS, CV_BATCH / steady,
           peak / 2**20, _busy_line(prof), card), flush=True)
    compare_serve(card, 'resnet serve', model,
                  image_batch(rng, CV_CPU_BATCH, shape, classes), scope, exe)


def phase_resnet_train(card, model, scope, exe):
    """TRAIN_STEPS Momentum steps of ResNet-50 on one 64-image batch, a
    sixth under torch.profiler, then one 2-image step against the CPU."""
    shape, classes = RESNET50['image_shape'], RESNET50['class_dim']
    rng = np.random.RandomState(SEED + 7)
    feed = image_batch(rng, CV_BATCH, shape, classes)
    step = lambda: exe.run(model['main'], feed=feed,
                           fetch_list=[model['loss']], scope=scope)
    losses, walls = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()  # every launch counter to 0 just before the training path
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss, = step()
        walls.append(time.perf_counter() - t0)
        check(loss.shape == (1, ) and np.isfinite(loss).all(),
              'resnet train: step %d loss %s is not finite' % (i + 1, loss))
        losses.append(float(loss[0]))
        print('resnet train: step %d wall %.4f s, loss %.6f [%s]' %
              (i + 1, walls[-1], losses[-1], card), flush=True)
    _no_launches('resnet train')
    peak = torch.cuda.max_memory_allocated()
    check(losses[-1] < losses[0], 'resnet train: loss %s: the fifth is not '
          'below the first' % losses)
    prof = profile_run(step, recompute=True)
    print('resnet train: %d Momentum steps (lr %g, mu 0.9) on one %d x %s '
          'batch, loss %.6f -> %.6f; steady step wall %.4f s (median of steps '
          '2-%d), %.1f images/s; peak device memory %.1f MiB; one step under '
          'torch.profiler: %s [%s]' %
          (TRAIN_STEPS, CV_LR, CV_BATCH, shape, losses[0], losses[-1],
           statistics.median(walls[1:]), TRAIN_STEPS,
           CV_BATCH / statistics.median(walls[1:]), peak / 2**20,
           _busy_line(prof), card), flush=True)
    small = image_batch(rng, CV_CPU_BATCH, shape, classes)
    with cpu_ftz():
        compare_train_step(card, 'resnet train', '%d x %s' % (CV_CPU_BATCH,
                                                              shape),
                           model['main'], model['loss'].name, small, scope,
                           exe, CV_LR, CV_TRAIN_TOL['resnet50'])


def phase_mnist(card):
    """The MNIST MLP at its published width: five Adam steps of 64 images
    with a falling loss, then one step against the CPU."""
    model, scope, exe = build_cv_model('mnist')
    rng = np.random.RandomState(SEED + 8)
    feed = {'img': rng.uniform(-1, 1, (MNIST_BATCH, 784)).astype('float32'),
            'label': rng.randint(0, 10, size=(MNIST_BATCH, 1)).astype(
                'int64')}
    losses, walls = [], []
    _zero_counts()  # every launch counter to 0 just before the training path
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss, = exe.run(model['main'], feed=feed, fetch_list=[model['loss']],
                        scope=scope)
        walls.append(time.perf_counter() - t0)
        check(np.isfinite(loss).all(), 'mnist: loss %s' % loss)
        losses.append(float(loss[0]))
    _no_launches('mnist train')
    check(all(b < a for a, b in zip(losses, losses[1:])),
          'mnist: the loss did not fall at every step: %s' % losses)
    print('mnist: %d Adam steps (lr %g) of %d images, loss %.6f -> %.6f, '
          'falling at every step; steady step wall %.4f s [%s]' %
          (TRAIN_STEPS, CV_LR, MNIST_BATCH, losses[0], losses[-1],
           statistics.median(walls[1:]), card), flush=True)
    small = {'img': feed['img'][:8], 'label': feed['label'][:8]}
    with cpu_ftz():
        compare_train_step(card, 'mnist train', '8 images', model['main'],
                           model['loss'].name, small, scope, exe, CV_LR,
                           CV_TRAIN_TOL['mnist'])


def phase_vgg(card):
    """VGG-16 at 1000 classes and 224 x 224: a 2-image request of the test
    program and a 2-image training step from the startup state, each on the
    card and on the CPU; dropout_prob is 0 on every dropout op of the
    training program, since the card's and the CPU's random streams
    differ."""
    model, scope, exe = build_cv_model('vgg', lr=CV_LR, **VGG16)
    shape, classes = VGG16['image_shape'], VGG16['class_dim']
    rng = np.random.RandomState(SEED + 9)
    _zero_counts()  # every launch counter to 0 just before the CV path
    compare_serve(card, 'vgg serve', model,
                  image_batch(rng, CV_CPU_BATCH, shape, classes), scope, exe)
    for op in model['main'].global_block().ops:
        if op.type == 'dropout':
            op.attrs['dropout_prob'] = 0.0
    with cpu_ftz():
        compare_train_step(card, 'vgg train', '%d x %s' % (CV_CPU_BATCH,
                                                           shape),
                           model['main'], model['loss'].name,
                           image_batch(rng, CV_CPU_BATCH, shape, classes),
                           scope, exe, CV_LR, CV_TRAIN_TOL['vgg16'])
    _no_launches('vgg')


# ----------------------------------------------------------------------------
# the captured path: each block captured once as a CUDA graph and replayed
# ----------------------------------------------------------------------------
CAPTURE_CALLS = 20  # timed calls of each path, eager and captured
MULTI_K = 8         # steps of the run_multi and run_eval_multi phases
DROPOUT_P = 0.1
DROPOUT_ROWS, DROPOUT_WIDTH = 256, 4096
# the kept share of a p = 0.1 mask over 256 x 4096 elements has a standard
# deviation of sqrt(0.09 / 1048576) = 2.9e-4: the bound is 17 of them
DROPOUT_KEPT_TOL = 5e-3
# max |captured - eager| / max(1, max|eager|) of each fetch and state var:
# 1e-6, or twice what the eager path differs from itself run twice from the
# same state where that is more (a training step's embedding gradients and
# cuDNN's weight gradients sum in no fixed order)
CAPTURE_TOL = 1e-6
def _persistables(program, scope):
    """Copies of the program's persistable vars that the scope holds."""
    out = {}
    for v in program.list_vars():
        var = scope.find_var(v.name) if v.persistable else None
        if var is not None and var.value() is not None:
            out[v.name] = var.value().clone()
    return out


def _load(scope, state):
    for name, value in state.items():
        scope.var(name).set_value(value.clone())


def _max_diff(got, want, names=None):
    """max |got - want| / max(1, max|want|) over lists of arrays (inf at a
    shape mismatch), or with ``names`` (worst, name of the worst)."""
    worst, at = 0.0, None
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        if g.shape != w.shape:
            worst, at = float('inf'), i
            break
        if g.size:
            w64 = w.astype(np.float64)
            d = float(np.abs(g.astype(np.float64) - w64).max()) / max(
                1.0, float(np.abs(w64).max()))
            if d > worst:
                worst, at = d, i
    if names is None:
        return worst
    return worst, (names[at] if at is not None else None)


def _replay_kernels(run, want):
    """The kernel launches, by key, of one call of ``run`` that replays a
    captured graph, counted by name in the profiler's device activity.  The
    profiler sometimes drops events (``_device_ms``): a session that does
    not count ``want`` is printed and taken again, five sessions at most."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for session in range(5):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            run()
            torch.cuda.synchronize()
        seen, device, kinds = _device_kernels(prof)
        if seen == want:
            break
        print('capture: profiler session %d of 5 counted %s of %s (%d device '
              'activities)' % (session + 1, seen, want, device), flush=True)
    return seen, kinds


def eager_run(exe, program, feed, fetch_list, scope):
    """One call of ``program`` on the eager path of ``exe``'s block for it
    (``Executor.run(..., eager=True)``), the path a block takes before its
    capture: every lowering dispatched from the host."""
    return exe.run(program, feed=feed, fetch_list=fetch_list, scope=scope,
                   eager=True)


def f32_fetches(fetches):
    """Fetches taken with ``return_numpy=False`` as f32 numpy arrays (a bf16
    fetch has no numpy form)."""
    return [f.tensor().float().cpu().numpy() for f in fetches]


def amp_call(exe, program, feed, fetch_list, scope, eager=False):
    """One ``Executor.run`` under ``amp_guard()``, its fetches as f32 numpy
    arrays."""
    import paddle_tpu_torch.fluid as fluid
    with fluid.amp_guard():
        return f32_fetches(exe.run(program, feed=feed, fetch_list=fetch_list,
                                   scope=scope, return_numpy=False,
                                   eager=eager))


def phase_capture(card, tag, program, feed, fetch, state, expect, amp=False):
    """One path captured against eager from the same state: the eager call
    (``eager_run``) and the capture's call compared, a replay
    from the state again compared with the capture's call, the kernels of a
    replay counted on the device, and CAPTURE_CALLS calls of each path
    timed (median wall, device busy and idle share of one call under
    torch.profiler, peak memory).  ``expect``: the hand-written kernels a
    call launches, by key.  ``amp``: every call under ``amp_guard()``,
    the replay's hand-written kernels all bf16 instantiations."""
    import paddle_tpu_torch.fluid as fluid
    place = fluid.CUDAPlace(0)
    if amp:
        run = lambda exe, scope: amp_call(exe, program, feed, fetch, scope)
        eager = lambda exe, scope: amp_call(exe, program, feed, fetch, scope,
                                            eager=True)
    else:
        run = lambda exe, scope: exe.run(program, feed=feed,
                                         fetch_list=fetch, scope=scope)
        eager = lambda exe, scope: eager_run(exe, program, feed, fetch,
                                             scope)
    timed = {}

    def time_calls(call, exe, scope, path):
        walls = []
        for _ in range(CAPTURE_CALLS):
            t0 = time.perf_counter()
            call(exe, scope)
            walls.append(time.perf_counter() - t0)
        prof = profile_run(lambda: call(exe, scope))
        check(prof['busy_ms'] > 0, '%s: torch.profiler saw no device kernel '
              'on the %s path' % (tag, path))
        timed[path] = dict(
            wall=statistics.median(walls), wall_min=min(walls),
            wall_max=max(walls), busy_ms=prof['busy_ms'],
            idle=1 - prof['busy_ms'] / 1e3 / prof['wall_s'],
            peak=torch.cuda.max_memory_allocated())

    # eager, from the state
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    _load(scope, state)
    want = eager(exe, scope)
    block = exe.cached_blocks()[-1]
    check(block.last_ran == 'eager' and not block.captures,
          '%s: the eager call ran %s' % (tag, block.last_ran))
    want_state = [scope.find_var(n).value().cpu().numpy()
                  for n in block.state_out]
    # the eager path against itself from the same state
    _load(scope, state)
    control = eager(exe, scope)
    control_state = [scope.find_var(n).value().cpu().numpy()
                     for n in block.state_out]
    control_err = max(_max_diff(control, want),
                      _max_diff(control_state, want_state))
    torch.cuda.reset_peak_memory_stats()
    time_calls(eager, exe, scope, 'eager')
    del exe, scope
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # captured, from the same state
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    _load(scope, state)
    first = run(exe, scope)  # the first call of a key runs eagerly
    block = exe.cached_blocks()[-1]
    check(block.mode == 'graph' and block.last_ran == 'eager',
          '%s: the block runs %s (%s), not as a graph' %
          (tag, block.mode, block.why))
    check(_max_diff(first, want) <= max(CAPTURE_TOL, 2 * control_err),
          '%s: the first call (eager) differs from eager_run\'s by %g' %
          (tag, _max_diff(first, want)))
    _load(scope, state)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    got = run(exe, scope)
    capture_above = torch.cuda.max_memory_allocated() - before
    check(block.last_ran == 'capture' and block.captures == 1 and
          exe.compile_count == 1, '%s: the second call ran %s, %d captures, '
          'compile_count %d: expected one capture of one block' %
          (tag, block.last_ran, block.captures, exe.compile_count))
    captured = {k: block.captured_launches.get(k, 0) for k in KERNEL_KEYS}
    check(captured == _expect(**expect), '%s: the capture launched %s, '
          'expected %s' % (tag, captured, _expect(**expect)))
    got_state = [scope.find_var(n).value().cpu().numpy()
                 for n in block.state_out]
    fetch_err = _max_diff(got, want)
    state_err, worst = _max_diff(got_state, want_state, block.state_out)
    err = max(fetch_err, state_err)
    tol = max(CAPTURE_TOL, 2 * control_err)
    check(err <= tol, '%s: captured and eager differ by %g (fetches %g, %d '
          'state vars %g, the most %s; tolerance %g; eager against eager %g)'
          % (tag, err, fetch_err, len(got_state), state_err, worst, tol,
             control_err))
    # a replay from the state again: the capture's call once more
    _load(scope, state)
    again = run(exe, scope)
    replay_err = _max_diff(again, got)
    check(block.last_ran == 'replay' and block.captures == 1 and
          replay_err <= tol, '%s: a replay from the same state ran '
          '%s and differs from the capture\'s call by %g' %
          (tag, block.last_ran, replay_err))
    seen, kinds = _replay_kernels(lambda: run(exe, scope), captured)
    check(seen == captured, '%s: a replay launched %s on the card, the '
          'capture %s' % (tag, seen, captured))
    _check_dtype(tag + ' replay', kinds, 'bf16' if amp else 'f32', captured)
    time_calls(run, exe, scope, 'captured')
    check(block.captures == 1 and exe.compile_count == 1,
          '%s: %d captures, compile_count %d after the timed calls' %
          (tag, block.captures, exe.compile_count))
    with (fluid.amp_guard() if amp else contextlib.nullcontext()):
        stats = exe.memory_analysis(program, feed=feed, fetch_list=fetch,
                                    scope=scope)
    check(stats.temp_size_in_bytes > 0, '%s: memory_analysis %s' %
          (tag, stats))
    timed['memory'] = dict(temp=stats.temp_size_in_bytes,
                           argument=stats.argument_size_in_bytes,
                           capture_above=capture_above)
    print('memory %s: release plan frees %d names; memory_analysis '
          'temp_size_in_bytes %.1f MiB, argument %.1f MiB, output %.1f MiB; '
          'the capture\'s peak above what was allocated before it %.1f MiB '
          '(%.2fx temp) [%s]' %
          (tag, sum(len(v) for v in block._release.values()),
           stats.temp_size_in_bytes / 2**20,
           stats.argument_size_in_bytes / 2**20,
           stats.output_size_in_bytes / 2**20, capture_above / 2**20,
           capture_above / stats.temp_size_in_bytes, card), flush=True)
    e, c = timed['eager'], timed['captured']
    print('capture %s: mode %s, %d ops, %d state vars; captured vs eager '
          'from the same state: %s (max|d| / max(1, max|v|) %g over %d '
          'fetches and %d state vars, the most %s; eager against eager %g); '
          'a replay from the state again against the capture\'s call %g; '
          'kernels a replay launched %s (profiler, by kernel name); eager wall %.4f s '
          '(median of %d, %.4f-%.4f), busy %.3f ms, idle share %.3f, peak '
          '%.1f MiB; captured wall %.4f s (%.4f-%.4f), busy %.3f ms, idle '
          'share %.3f, peak %.1f MiB (the capture included); eager / '
          'captured wall %.2fx [%s]' %
          (tag, block.mode, len(block.ops), len(block.state_in),
           'bitwise equal' if err == 0 else 'within %g' % tol, err,
           len(got), len(got_state), worst if err else '-', control_err,
           replay_err, {k: v for k, v in seen.items() if v} or 'none', e['wall'],
           CAPTURE_CALLS, e['wall_min'], e['wall_max'], e['busy_ms'],
           e['idle'], e['peak'] / 2**20, c['wall'], c['wall_min'],
           c['wall_max'], c['busy_ms'], c['idle'], c['peak'] / 2**20,
           e['wall'] / c['wall'], card), flush=True)
    del exe, scope
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return timed


@contextlib.contextmanager
def _refused(program):
    """``program``'s blocks refused by the capture rules, as a block holding
    an uncapturable op is: its first op's type is declared uncapturable
    for the duration (a refused block runs eagerly and, without
    ``memory_optimize``, frees nothing)."""
    from paddle_tpu_torch.ops import registry
    op_type = program.global_block().ops[0].type
    saved = registry._UNCAPTURABLE.get(op_type)
    registry.declare_uncapturable(op_type, 'refused for the comparison')
    try:
        yield
    finally:
        if saved is None:
            registry._UNCAPTURABLE.pop(op_type)
        else:
            registry._UNCAPTURABLE[op_type] = saved


def phase_plan_bitwise(card, tag, program, feed, fetch, state):
    """One step from ``state`` captured with the release plan against the
    same step in a refused block (eager, nothing freed): the fetches and
    every state var written, to 0 difference.  cuDNN runs its
    deterministic algorithms for both (its default ones differ from run
    to run on their own)."""
    import paddle_tpu_torch.fluid as fluid
    place = fluid.CUDAPlace(0)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        exe, scope = fluid.Executor(place), fluid.Scope()
        _load(scope, state)
        exe.run(program, feed=feed, fetch_list=fetch, scope=scope)  # eager
        _load(scope, state)
        got = exe.run(program, feed=feed, fetch_list=fetch, scope=scope)
        block = exe.cached_blocks()[-1]
        check(block.last_ran == 'capture' and block.refusal is None,
              '%s: the plan\'s call ran %s' % (tag, block.last_ran))
        freed = sum(len(v) for v in block._release.values())
        got_state = [scope.find_var(n).value().cpu().numpy()
                     for n in block.state_out]
        del exe, scope
        with _refused(program):
            exe, scope = fluid.Executor(place), fluid.Scope()
            _load(scope, state)
            want = exe.run(program, feed=feed, fetch_list=fetch, scope=scope)
            ref = exe.cached_blocks()[-1]
            check(ref.refusal is not None and not ref._release,
                  '%s: the refused block frees %s' % (tag, ref._release))
            want_state = [scope.find_var(n).value().cpu().numpy()
                          for n in ref.state_out]
            del exe, scope
    finally:
        torch.backends.cudnn.deterministic = saved
    err = max(_max_diff(got, want), _max_diff(got_state, want_state))
    check(err == 0, '%s: captured with the release plan and refused differ '
          'by %g' % (tag, err))
    print('plan %s: captured with the release plan (%d names freed) and the '
          'block refused (eager, none freed) from one state: bitwise equal '
          'over %d fetches and %d state vars [%s]' %
          (tag, freed, len(got), len(got_state), card), flush=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_transformer_capture(card, model, scope):
    cfg = TRANSFORMER_BASE
    rng = np.random.RandomState(SEED + 30)
    feed = {name: rng.randint(1, cfg['trg_vocab'], size=(
        BATCH, cfg['max_len'])).astype('int64') for name in model['feeds']}
    n = 3 * cfg['n_layer']
    state = _persistables(model['main'], scope)
    phase_capture(card, 'transformer serve %d x %d' % (BATCH, cfg['max_len']),
                  model['test'], feed, [model['loss'], model['prediction']],
                  state, dict(fwd=n))
    phase_capture(card, 'transformer train %d x %d' % (BATCH, cfg['max_len']),
                  model['main'], feed, [model['loss']], state,
                  dict(fwd=2 * n, dq=n, dkv=n))
    phase_plan_bitwise(card, 'transformer train %d x %d' %
                       (BATCH, cfg['max_len']), model['main'], feed,
                       [model['loss']], state)


def phase_lstm_capture(card, forms):
    model, scope, _ = forms['kernel']
    n = STACKED_LSTM['stacked_num']
    feed = lstm_request(np.random.RandomState(SEED + 31), LSTM_BATCH)
    state = _persistables(model['main'], scope)
    what = 'B=%d T=%d D=%d' % (LSTM_BATCH, LSTM_MAX_LEN,
                               STACKED_LSTM['hid_dim'])
    phase_capture(card, 'lstm serve (kernel) ' + what, model['test'], feed,
                  [model['prediction'], model['acc']], state,
                  dict(lstm_fwd=n))
    phase_capture(card, 'lstm train (kernel) ' + what, model['main'], feed,
                  [model['loss']], state,
                  dict(lstm_fwd=2 * n, lstm_bwd=n, lstm_dw=n))


def phase_nmt_capture(card, models):
    model, scope, _ = models['kernel']
    feed = nmt_batch(np.random.RandomState(SEED + 32), NMT_BATCH)
    phase_capture(card, 'nmt train (kernel) %d pairs T=%d D=%d' %
                  (NMT_BATCH, NMT_MAX_LEN, NMT['encoder_size']),
                  model['main'], feed, [model['loss']],
                  _persistables(model['main'], scope),
                  dict(lstm_fwd=2, lstm_bwd=1, lstm_dw=1))


def phase_resnet_capture(card, model, scope):
    shape, classes = RESNET50['image_shape'], RESNET50['class_dim']
    feed = image_batch(np.random.RandomState(SEED + 33), CV_BATCH, shape,
                       classes)
    state = _persistables(model['main'], scope)
    what = '%d x %s' % (CV_BATCH, 'x'.join(map(str, shape)))
    phase_capture(card, 'resnet serve ' + what, model['test'], feed,
                  [model['prediction']], state, {})
    phase_capture(card, 'resnet train ' + what, model['main'], feed,
                  [model['loss']], state, {})
    phase_plan_bitwise(card, 'resnet train ' + what, model['main'], feed,
                       [model['loss']], state)


# ---- mixed precision: paths A-D ----

def _amp_steps(exe, program, feed, loss, scope, steps, amp):
    """``steps`` steps of ``program`` (under amp_guard when ``amp``): the
    losses."""
    import paddle_tpu_torch.fluid as fluid
    out = []
    with fluid.amp_guard(amp):
        for _ in range(steps):
            out.append(float(exe.run(program, feed=feed, fetch_list=[loss],
                                     scope=scope)[0][0]))
    return out


def _amp_loss_parity(card, tag, exe, model, feed, scope, state, steps, tol):
    """f32 and AMP training from the same state on one batch: the losses
    within ``tol`` at every one of ``steps`` steps."""
    _load(scope, state)
    f32 = _amp_steps(exe, model['main'], feed, model['loss'], scope, steps,
                     False)
    _load(scope, state)
    amp = _amp_steps(exe, model['main'], feed, model['loss'], scope, steps,
                     True)
    gap = max(abs(a - f) for a, f in zip(amp, f32))
    check(all(np.isfinite(f32 + amp)) and gap < tol,
          '%s: the AMP and f32 losses of %d steps differ by up to %g (tol %g):'
          ' %s, %s' % (tag, steps, gap, tol, amp, f32))
    print('%s: AMP vs f32 training from the same state, %d steps on one '
          'batch: loss %.6f -> %.6f under AMP, %.6f -> %.6f in f32, max|d| '
          'over the steps %.4f (tol %g) [%s]' %
          (tag, steps, amp[0], amp[-1], f32[0], f32[-1], gap, tol, card),
          flush=True)


def _amp_compare_serve(card, tag, program, feed, fetch, scope, exe,
                       params):
    """The loss and the bf16 prediction of one request under AMP, card vs
    CPU with the same parameters (AMP_SERVE_TOL)."""
    import paddle_tpu_torch.fluid as fluid
    with fluid.amp_guard():
        got = exe.run(program, feed=feed, fetch_list=fetch, scope=scope,
                      return_numpy=False)
        dtypes = [str(f.tensor().dtype) for f in got]
        check(dtypes == ['torch.float32', 'torch.bfloat16'],
              '%s: the loss and prediction fetched as %s, expected f32 and '
              'bf16' % (tag, dtypes))
        cpu_scope = fluid.Scope()
        fluid.params_from_numpy(
            program, {n: scope.find_var(n).value().cpu().numpy()
                      for n in params}, scope=cpu_scope,
            place=fluid.CPUPlace())
        t0 = time.perf_counter()
        want = fluid.Executor(fluid.CPUPlace()).run(
            program, feed=feed, fetch_list=fetch, scope=cpu_scope,
            return_numpy=False)
        cpu_s = time.perf_counter() - t0
    (gl, gp), (wl, wp) = f32_fetches(got), f32_fetches(want)
    loss_rel = float(abs(gl[0] - wl[0]) / abs(wl[0]))
    wp64 = wp.astype(np.float64)
    pred_max = float(np.abs(gp - wp64).max()) / max(1.0, float(
        np.abs(wp64).max()))
    pred_norm = float(np.linalg.norm(gp - wp64) / np.linalg.norm(wp64))
    check(loss_rel <= AMP_SERVE_TOL['loss'] and
          pred_max <= AMP_SERVE_TOL['pred_max'] and
          pred_norm <= AMP_SERVE_TOL['pred_norm'],
          '%s: card and CPU disagree under AMP: loss rel %g, prediction '
          'max|d| %g, |d| / |v| %g (tol %s)' % (tag, loss_rel, pred_max,
                                               pred_norm, AMP_SERVE_TOL))
    print('%s: card vs CPU under AMP on %s: loss %.6f vs %.6f (rel %.3g), '
          'bf16 prediction max|d| %.3g, |d| / |v| %.3g (tol %s); CPU run '
          '%.2f s [%s]' % (tag, 'x'.join(map(str, gp.shape)), gl[0], wl[0],
                           loss_rel, pred_max, pred_norm, AMP_SERVE_TOL,
                           cpu_s, card), flush=True)


def _amp_train_path(card, tag, exe, model, feed, scope, per_step):
    """TRAIN_STEPS AMP steps through ``_Path`` (every hand-written kernel a
    bf16 instantiation): the launches; the loss finite and the last below
    the first."""
    losses, walls = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    path = _Path(tag, exe, 'bf16').begin()
    for step in range(TRAIN_STEPS):
        made = path.call(lambda: amp_call(exe, model['main'], feed,
                                          [model['loss']], scope), per_step)
        for (loss, ), wall, seen, ran in made:
            check(loss.shape == (1, ) and np.isfinite(loss).all(),
                  '%s: step %d loss %s is not finite' % (tag, step + 1, loss))
            losses.append(float(loss[0]))
            walls.append(wall)
        print('%s: step %d (%s) wall %.4f s, loss %.6f, bf16 kernels on the '
              'card %s [%s]' % (tag, step + 1, ran, wall, losses[-1],
                                {k: v for k, v in seen.items() if v} or
                                'none', card), flush=True)
    launches = path.end()
    check(losses[-1] < losses[0], '%s: the loss %s: the last is not below '
          'the first' % (tag, losses))
    print('%s: %d AMP steps, loss %.6f -> %.6f; launches %s (%s per step, '
          'all bf16: %s); steady step wall %.4f s (median of steps 2-%d '
          'under torch.profiler); peak device memory %.1f MiB [%s]' %
          (tag, len(losses), losses[0], losses[-1], launches.summary(),
           {k: v for k, v in per_step.items() if v} or 'none',
           {k: v for k, v in launches.by_dtype['bf16'].items() if v} or
           'none', statistics.median(walls[1:]), len(walls),
           torch.cuda.max_memory_allocated() / 2**20, card), flush=True)
    return launches


def phase_amp_transformer(card, model, scope, exe):
    """Path A: Transformer-base under amp_guard() from the state the f32
    phases left: requests, then Adam steps eager and captured."""
    cfg = TRANSFORMER_BASE
    seq, vocab = cfg['max_len'], cfg['trg_vocab']
    n = 3 * cfg['n_layer']
    state = _persistables(model['main'], scope)
    rng = np.random.RandomState(SEED + 40)
    ids = lambda b: {name: rng.randint(1, vocab, size=(b, seq)).astype(
        'int64') for name in model['feeds']}
    fetch = [model['loss'], model['prediction']]
    walls = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    path = _Path('amp serve', exe, 'bf16').begin()
    for i in range(REQUESTS):
        feed = ids(BATCH)
        (loss, pred), wall, seen, ran = path.call(
            lambda: amp_call(exe, model['test'], feed, fetch, scope),
            _expect(fwd=n))[-1]
        walls.append(wall)
        row_err = float(np.abs(pred.sum(-1, dtype=np.float64) - 1.0).max())
        check(np.isfinite(loss).all() and pred.shape == (BATCH, seq, vocab)
              and np.isfinite(pred).all() and row_err < AMP_SERVE_TOL[
                  'pred_norm'], 'amp serve: request %d: loss %s, prediction '
              '%s, rows sum to 1 +- %g' % (i + 1, loss, pred.shape, row_err))
        print('amp serve: request %d (%s) wall %.4f s, loss %.6f, max|row '
              'sum - 1| %.3g (bf16 prediction) [%s]' %
              (i + 1, ran, wall, loss[0], row_err, card), flush=True)
    serve = path.end()
    print('amp serve: %d requests of %d x %d under amp_guard(); launches %s '
          '(bf16: %s); steady request wall %.4f s; peak device memory %.1f '
          'MiB [%s]' % (REQUESTS, BATCH, seq, serve.summary(),
                        {k: v for k, v in serve.by_dtype['bf16'].items()
                         if v}, statistics.median(walls[1:]),
                        torch.cuda.max_memory_allocated() / 2**20, card),
          flush=True)
    _amp_compare_serve(card, 'amp serve', model['test'], ids(2), fetch,
                       scope, exe,
                       [p.name for p in model['test'].all_parameters()])
    feed = ids(BATCH)
    _load(scope, state)
    train = _amp_train_path(card, 'amp train', exe, model, feed, scope,
                            _expect(fwd=2 * n, dq=n, dkv=n))
    _amp_loss_parity(card, 'amp train', exe, model, feed, scope, state,
                     AMP_F32_STEPS, AMP_F32_LOSS_TOL)
    import paddle_tpu_torch.fluid as fluid
    _load(scope, state)  # the step against the CPU from the path's state
    with fluid.amp_guard():
        compare_train_step(card, 'amp train', '2 x %d under AMP' % seq,
                           model['main'], model['loss'].name, ids(2), scope,
                           exe, LR, AMP_TRAIN_TOL)
    what = '%d x %d under AMP' % (BATCH, seq)
    phase_capture(card, 'amp transformer serve ' + what, model['test'],
                  feed, fetch, state, dict(fwd=n), amp=True)
    phase_capture(card, 'amp transformer train ' + what, model['main'],
                  feed, [model['loss']], state, dict(fwd=2 * n, dq=n, dkv=n),
                  amp=True)
    _load(scope, state)
    return {'amp_serve': serve, 'amp_train': train}


def phase_amp_lstm(card, forms):
    """Path B: the stacked LSTM's kernel form under amp_guard(): requests,
    Adam steps eager and captured, 20 steps against f32 training."""
    model, scope, exe = forms['kernel']
    n = STACKED_LSTM['stacked_num']
    state = _persistables(model['main'], scope)
    rng = np.random.RandomState(SEED + 41)
    fetch = [model['loss'], model['prediction']]
    path = _Path('amp lstm serve', exe, 'bf16').begin()
    for i in range(REQUESTS):
        feed = lstm_request(rng, LSTM_BATCH)
        (loss, pred), wall, seen, ran = path.call(
            lambda: amp_call(exe, model['test'], feed, fetch, scope),
            _expect(lstm_fwd=n))[-1]
        check(np.isfinite(loss).all() and pred.shape == (
            LSTM_BATCH, STACKED_LSTM['class_dim']) and
            np.isfinite(pred).all(), 'amp lstm serve: request %d: loss %s, '
            'prediction %s' % (i + 1, loss, pred.shape))
        print('amp lstm serve: request %d (%s) wall %.4f s, loss %.6f [%s]'
              % (i + 1, ran, wall, loss[0], card), flush=True)
    serve = path.end()
    print('amp lstm serve: %d requests of %d rows (T=%d) under amp_guard(); '
          'launches %s (bf16: %s) [%s]' %
          (REQUESTS, LSTM_BATCH, LSTM_MAX_LEN, serve.summary(),
           {k: v for k, v in serve.by_dtype['bf16'].items() if v}, card),
          flush=True)
    _amp_compare_serve(card, 'amp lstm serve', model['test'],
                       lstm_request(rng, LSTM_CPU_ROWS), fetch, scope, exe,
                       [p.name for p in model['test'].all_parameters()])
    feed = lstm_request(np.random.RandomState(SEED + 4), LSTM_BATCH)
    _load(scope, state)
    train = _amp_train_path(card, 'amp lstm train', exe, model, feed, scope,
                            _expect(lstm_fwd=2 * n, lstm_bwd=n, lstm_dw=n))
    _amp_loss_parity(card, 'amp lstm train', exe, model, feed, scope, state,
                     AMP_LSTM_STEPS, AMP_LSTM_LOSS_TOL)
    import paddle_tpu_torch.fluid as fluid
    _load(scope, state)  # the step against the CPU from the path's state
    with fluid.amp_guard():
        compare_train_step(
            card, 'amp lstm train', '%d rows (T=%d) under AMP' %
            (LSTM_CPU_TRAIN_ROWS, LSTM_MAX_LEN), model['main'],
            model['loss'].name, lstm_request(np.random.RandomState(SEED + 5),
                                             LSTM_CPU_TRAIN_ROWS), scope,
            exe, LSTM_LR, AMP_LSTM_TRAIN_TOL)
    what = '(kernel) B=%d T=%d D=%d under AMP' % (
        LSTM_BATCH, LSTM_MAX_LEN, STACKED_LSTM['hid_dim'])
    phase_capture(card, 'amp lstm serve ' + what, model['test'], feed,
                  [model['prediction'], model['acc']], state,
                  dict(lstm_fwd=n), amp=True)
    phase_capture(card, 'amp lstm train ' + what, model['main'], feed,
                  [model['loss']], state,
                  dict(lstm_fwd=2 * n, lstm_bwd=n, lstm_dw=n), amp=True)
    _load(scope, state)
    return {'amp_lstm_serve': serve, 'amp_lstm_train': train}


def phase_amp_resnet_train(card, model, scope, exe):
    """Path D: ResNet-50 Momentum steps under amp_guard() at batch
    CV_BATCH: cuDNN's convolutions in bf16, every parameter and gradient
    f32; card vs CPU under AMP; captured against eager."""
    import paddle_tpu_torch.fluid as fluid
    shape, classes = RESNET50['image_shape'], RESNET50['class_dim']
    state = _persistables(model['main'], scope)
    rng = np.random.RandomState(SEED + 42)
    feed = image_batch(rng, CV_BATCH, shape, classes)
    params = [p.name for p in model['main'].all_parameters() if p.trainable]
    losses, walls = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()  # every launch counter to 0 just before the path
    with fluid.amp_guard():
        for i in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            loss, = exe.run(model['main'], feed=feed,
                            fetch_list=[model['loss']], scope=scope)
            walls.append(time.perf_counter() - t0)
            check(np.isfinite(loss).all(), 'amp resnet train: step %d loss '
                  '%s is not finite' % (i + 1, loss))
            losses.append(float(loss[0]))
            print('amp resnet train: step %d wall %.4f s, loss %.6f [%s]' %
                  (i + 1, walls[-1], losses[-1], card), flush=True)
        grads = exe.run(model['main'], feed=feed,
                        fetch_list=[p + '@GRAD' for p in params],
                        scope=scope, return_numpy=False)
    _no_launches('amp resnet train')
    peak = torch.cuda.max_memory_allocated()
    check(losses[-1] < losses[0], 'amp resnet train: loss %s: the fifth is '
          'not below the first' % losses)
    wrong = [n for n, g in zip(params, grads) if g.tensor().dtype !=
             torch.float32]
    wrong += [n for n in params if scope.find_var(n).value().dtype !=
              torch.float32]
    check(not wrong, 'amp resnet train: not f32 under AMP: %s' % wrong[:5])
    print('amp resnet train: %d Momentum steps under amp_guard() on one %d x '
          '%s batch, loss %.6f -> %.6f; steady step wall %.4f s, %.1f '
          'images/s; %d parameters and their @GRAD all f32; peak device '
          'memory %.1f MiB [%s]' %
          (TRAIN_STEPS, CV_BATCH, shape, losses[0], losses[-1],
           statistics.median(walls[1:]), CV_BATCH / statistics.median(
               walls[1:]), len(params), peak / 2**20, card), flush=True)
    small = image_batch(rng, CV_CPU_BATCH, shape, classes)
    with fluid.amp_guard(), cpu_ftz():
        compare_train_step(card, 'amp resnet train', '%d x %s under AMP' %
                           (CV_CPU_BATCH, shape), model['main'],
                           model['loss'].name, small, scope, exe, CV_LR,
                           AMP_CV_TRAIN_TOL,
                           held=[n for n in params if n.startswith('fc_')])
    phase_capture(card, 'amp resnet train %d x %s' % (
        CV_BATCH, 'x'.join(map(str, shape))), model['main'], feed,
        [model['loss']], state, {}, amp=True)
    _load(scope, state)


def phase_resnet_infer_bf16(card, model):
    """Path C: ResNet-50's test program at its startup weights (random from
    SEED, as bench_resnet_infer_bf16 serves it: trained on one batch, the
    softmax saturates and two runners agree trivially) saved with
    save_inference_model, loaded three times and served with run_eval_multi
    (INFER_K lots of INFER_BATCH images, captured): as loaded (f32), batch
    norm folded (InferenceTranspiler, f32), and folded then
    Float16Transpiler('bfloat16'), one runner at a time, each freed before
    the next."""
    import tempfile
    import paddle_tpu_torch.fluid as fluid
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(model['startup'], scope=scope)
    shape = RESNET50['image_shape']
    x = np.random.RandomState(SEED + 43).standard_normal(
        (INFER_BATCH, ) + tuple(shape)).astype('float32')
    # bytes, reckoned before the first run: the images 154 MB a lot; the
    # eager executor keeps every activation of a block until it ends, about
    # 23 GB for ResNet-50's forward at batch 256 in f32 (half in bf16), and
    # a captured graph holds its activations in its pool the same way
    logits = model['test'].global_block().var(_logits_name(model['test']))
    with tempfile.TemporaryDirectory() as td:
        with fluid.scope_guard(scope):
            fluid.io.save_inference_model(td, ['img'], [model['prediction'],
                                                        logits], exe,
                                          main_program=model['test'])
        del exe, scope
        out = {}
        for kind in ('f32', 'folded', 'bf16'):
            out[kind] = _infer_runner(card, kind, td, x)
    f32, folded, half = out['f32'], out['folded'], out['bf16']
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    fold_err = rel(folded['logits'], f32['logits'])
    half_err = float(np.abs(half['pred'] - f32['pred']).max())
    half_logits = rel(half['logits'], f32['logits'])
    top = float(f32['pred'].max(-1).mean())
    check(fold_err <= INFER_FOLD_RTOL, 'resnet infer: the folded f32 '
          'logits differ from the unfolded ones: |d| / |v| %g (tol %g)' %
          (fold_err, INFER_FOLD_RTOL))
    check(half_err <= INFER_HALF_TOL and half_logits <=
          INFER_HALF_LOGITS_RTOL, 'resnet infer: bf16 against f32: softmax '
          'max|d| %g (tol %g), logits |d| / |v| %g (tol %g)' %
          (half_err, INFER_HALF_TOL, half_logits, INFER_HALF_LOGITS_RTOL))
    print('resnet infer: %d x %d images (K=%d lots of %d, one run_eval_multi '
          'call, captured): f32 %.1f images/s, folded f32 %.1f, bf16 %.1f; '
          'bf16 : f32 %.2fx; folded vs unfolded f32 logits |d| / |v| %.3g '
          '(tol %g); bf16 vs f32 softmax max|d| %.3g (tol %g), logits |d| / '
          '|v| %.3g (tol %g); the f32 softmax\'s mean top probability %.3g '
          '[%s]' %
          (INFER_K, INFER_BATCH, INFER_K, INFER_BATCH, f32['ips'],
           folded['ips'], half['ips'], half['ips'] / f32['ips'], fold_err,
           INFER_FOLD_RTOL, half_err, INFER_HALF_TOL, half_logits,
           INFER_HALF_LOGITS_RTOL, top, card), flush=True)
    return out


def _infer_runner(card, kind, dirname, x):
    """One loaded copy of the saved model (``kind``: 'f32', 'folded' or
    'bf16') served INFER_CALLS + 1 times by run_eval_multi: {'pred', 'ips',
    'wall', 'busy_ms', 'idle', 'peak'}, its executor freed."""
    import paddle_tpu_torch.fluid as fluid
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        prog, feeds, fetches = fluid.io.load_inference_model(dirname, exe)
        if kind != 'f32':
            fluid.InferenceTranspiler().transpile(prog, scope=scope)
        if kind == 'bf16':
            fluid.Float16Transpiler().transpile(
                prog, scope=scope, dtype='bfloat16', feeded_var_names=feeds,
                fetch_var_names=fetches)
    ops = [op.type for op in prog.global_block().ops]
    halves = [v.name for v in prog.list_vars() if v.persistable and
              scope.find_var(v.name).value().dtype == torch.bfloat16]
    check(('batch_norm' in ops) == (kind == 'f32') and
          bool(halves) == (kind == 'bf16'), 'resnet infer %s: %d batch_norm '
          'ops, %d bf16 parameters' % (kind, ops.count('batch_norm'),
                                       len(halves)))
    _zero_counts()
    call = lambda: exe.run_eval_multi(prog, feed={feeds[0]: x},
                                      fetch_list=fetches, steps=INFER_K,
                                      scope=scope)
    pred, logits = call()  # eager, capture, replays
    walls = []
    for _ in range(INFER_CALLS):
        t0 = time.perf_counter()
        again, _ = call()
        walls.append(time.perf_counter() - t0)
    block = exe.cached_blocks()[-1]
    replay_err = _max_diff([again], [pred])
    check(block.mode == 'graph' and block.captures == 1 and
          replay_err <= CAPTURE_TOL, 'resnet infer %s: mode %s, %d '
          'captures, the replays against the first call %g (tol %g)' %
          (kind, block.mode, block.captures, replay_err, CAPTURE_TOL))
    row_err = float(np.abs(pred.sum(-1, dtype=np.float64) - 1).max())
    check(pred.shape == (INFER_K, INFER_BATCH, RESNET50['class_dim']) and
          pred.dtype == np.float32 and np.isfinite(pred).all() and
          row_err < 1e-2, 'resnet infer %s: prediction %s %s, rows sum to 1 '
          '+- %g' % (kind, pred.shape, pred.dtype, row_err))
    _no_launches('resnet infer ' + kind)
    prof = profile_run(call)
    wall = statistics.median(walls)
    res = dict(pred=pred[0].astype(np.float64),
               logits=logits[0].astype(np.float64), wall=wall,
               ips=INFER_K * INFER_BATCH / wall, busy_ms=prof['busy_ms'],
               idle=1 - prof['busy_ms'] / 1e3 / prof['wall_s'],
               peak=torch.cuda.max_memory_allocated())
    print('resnet infer %s: %d ops (%d batch_norm), %d bf16 parameters; '
          'run_eval_multi of %d x %d images (%d calls after the first, '
          'median) %.4f s, %.1f images/s; one call under torch.profiler: %s; '
          'peak device memory %.1f MiB [%s]' %
          (kind, len(ops), ops.count('batch_norm'), len(halves), INFER_K,
           INFER_BATCH, INFER_CALLS, wall, res['ips'], _busy_line(prof),
           res['peak'] / 2**20, card), flush=True)
    del exe, scope, prog
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return res


def phase_multi(card, forms):
    """run_multi: MULTI_K Adam steps of the stacked LSTM's kernel form on
    MULTI_K batches against MULTI_K run() calls from the same state (every
    persistable var and the last loss); run_eval_multi: MULTI_K requests of
    its test program against MULTI_K run() calls (every fetch)."""
    import paddle_tpu_torch.fluid as fluid
    place = fluid.CUDAPlace(0)
    model, scope0, _ = forms['kernel']
    n = STACKED_LSTM['stacked_num']
    state = _persistables(model['main'], scope0)
    rng = np.random.RandomState(SEED + 34)
    batches = [lstm_request(rng, LSTM_BATCH) for _ in range(MULTI_K)]
    fetch = [model['loss']]
    seq_exe, seq_scope = fluid.Executor(place), fluid.Scope()
    _load(seq_scope, state)
    for feed in batches:
        seq, = seq_exe.run(model['main'], feed=feed, fetch_list=fetch,
                           scope=seq_scope)
    exe, scope = fluid.Executor(place), fluid.Scope()
    _load(scope, state)
    _zero_counts()  # every launch counter to 0 just before this path
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    multi, = exe.run_multi(model['main'], feed_list=batches,
                           fetch_list=fetch, scope=scope)
    wall = time.perf_counter() - t0
    block = exe.cached_blocks()[-1]
    counts = _wrapper_counts()
    per_step = _expect(lstm_fwd=2 * n, lstm_bwd=n, lstm_dw=n)
    check(block.mode == 'graph' and block.captures == 1 and
          block.replays == MULTI_K - 2 and
          counts == {k: 2 * v for k, v in per_step.items()},
          'run_multi: mode %s, %d captures, %d replays, wrapper launches %s: '
          'expected a graph, 1 eager step, 1 capture, %d replays and %s a '
          'step from the wrappers of the first two' %
          (block.mode, block.captures, block.replays, counts, MULTI_K - 2,
           per_step))
    names = sorted(state)
    value = lambda s: [s.find_var(v).value().cpu().numpy() for v in names]
    err = max(_max_diff(multi, seq), _max_diff(value(scope),
                                               value(seq_scope)))
    check(err <= CAPTURE_TOL, 'run_multi: %d steps against %d run() calls '
          'differ by %g (tolerance %g)' % (MULTI_K, MULTI_K, err,
                                           CAPTURE_TOL))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exe.run_multi(model['main'], feed_list=batches, fetch_list=fetch,
                  scope=scope)
    replayed = time.perf_counter() - t0
    check(block.captures == 1 and block.replays == 2 * MULTI_K - 2,
          'run_multi again: %d captures, %d replays' %
          (block.captures, block.replays))
    # once more under the profiler: MULTI_K replays' kernels on the card
    want = {k: MULTI_K * v for k, v in per_step.items()}
    seen, _ = _replay_kernels(lambda: exe.run_multi(
        model['main'], feed_list=batches, fetch_list=fetch, scope=scope),
        want)
    check(seen == want and block.captures == 1, 'run_multi: %d replays ran '
          '%s on the card, expected %s' % (MULTI_K, seen, want))
    print('run_multi: %d Adam steps of the stacked LSTM (kernel form, %d '
          'rows, T=%d) on %d batches against %d run() calls from the same '
          'state: %s (max|d| %g over the last loss and %d persistable vars); '
          'wrapper launches %s (the eager step and the capture), %d replays '
          'ran %s on the card (profiler, by kernel name); wall %.4f s (one '
          'eager step and one capture among them), again %.4f s (%d '
          'replays, %.4f s a step) [%s]' %
          (MULTI_K, LSTM_BATCH, LSTM_MAX_LEN, MULTI_K, MULTI_K,
           'bitwise equal' if err == 0 else 'within %g' % CAPTURE_TOL, err,
           len(names), {k: v for k, v in counts.items() if v}, MULTI_K,
           {k: v for k, v in seen.items() if v}, wall,
           replayed, MULTI_K, replayed / MULTI_K, card), flush=True)

    lots = [lstm_request(rng, LSTM_BATCH) for _ in range(MULTI_K)]
    fetch = [model['prediction'], model['acc']]
    one_exe, one_scope = fluid.Executor(place), fluid.Scope()
    _load(one_scope, state)
    singles = [one_exe.run(model['test'], feed=lot, fetch_list=fetch,
                           scope=one_scope) for lot in lots]
    exe, scope = fluid.Executor(place), fluid.Scope()
    _load(scope, state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stacked = exe.run_eval_multi(model['test'], feed_list=lots,
                                 fetch_list=fetch, scope=scope)
    wall = time.perf_counter() - t0
    block = exe.cached_blocks()[-1]
    check([s.shape for s in stacked] ==
          [(MULTI_K, ) + s.shape for s in singles[0]],
          'run_eval_multi: fetches %s' % [s.shape for s in stacked])
    err = max(_max_diff([s[i] for s in stacked], singles[i])
              for i in range(MULTI_K))
    check(block.mode == 'graph' and block.replays == MULTI_K - 2 and
          err <= CAPTURE_TOL, 'run_eval_multi: mode %s, %d replays; %d '
          'requests against %d run() calls differ by %g (tolerance %g)' %
          (block.mode, block.replays, MULTI_K, MULTI_K, err, CAPTURE_TOL))
    print('run_eval_multi: %d requests of the stacked LSTM\'s test program '
          '(kernel form, %d rows) against %d run() calls: %s (max|d| %g over '
          'every fetch of every request); wall %.4f s [%s]' %
          (MULTI_K, LSTM_BATCH, MULTI_K, 'bitwise equal' if err == 0 else
           'within %g' % CAPTURE_TOL, err, wall, card), flush=True)


def phase_dropout(card):
    """Dropout at p = DROPOUT_P in a captured graph: every replay draws a
    new mask, each keeping 1 - p of the elements."""
    import paddle_tpu_torch.fluid as fluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data('x', [DROPOUT_WIDTH])
        out = fluid.layers.dropout(x, dropout_prob=DROPOUT_P)
    main.random_seed = SEED
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    feed = {'x': np.ones((DROPOUT_ROWS, DROPOUT_WIDTH), 'float32')}
    masks, ran = [], []
    for _ in range(4):  # eager, capture, replay, replay
        got, = exe.run(main, feed=feed, fetch_list=[out], scope=scope)
        masks.append(got != 0)
        ran.append(exe.cached_blocks()[-1].last_ran)
    check(ran == ['eager', 'capture', 'replay', 'replay'],
          'dropout: the calls ran %s' % ran)
    kept = [float(m.mean()) for m in masks]
    check(all(abs(k - (1 - DROPOUT_P)) <= DROPOUT_KEPT_TOL for k in kept),
          'dropout: kept shares %s, expected %g +- %g' %
          (kept, 1 - DROPOUT_P, DROPOUT_KEPT_TOL))
    differ = [float((a != b).mean()) for a, b in zip(masks, masks[1:])]
    # two independent masks differ in 2 p (1 - p) = 0.18 of the elements
    check(all(d > 0.1 for d in differ), 'dropout: consecutive masks differ '
          'in %s of the elements' % differ)
    print('dropout: p %g over %d x %d, calls eager, capture, replay, replay: '
          'kept shares %s (expected %g +- %g), consecutive masks differ in '
          '%s of the elements (independent: %g) [%s]' %
          (DROPOUT_P, DROPOUT_ROWS, DROPOUT_WIDTH,
           ', '.join('%.5f' % k for k in kept), 1 - DROPOUT_P,
           DROPOUT_KEPT_TOL, ', '.join('%.4f' % d for d in differ),
           2 * DROPOUT_P * (1 - DROPOUT_P), card), flush=True)


def phase_staleness(card, forms):
    """A program built onto after its capture compiles again; a parameter
    replaced in the scope between two replays is read by the second; a
    train program and its test program over one scope read the same state
    buffers; state written before it is read survives another graph's
    replays (``phase_pool_order``)."""
    import paddle_tpu_torch.fluid as fluid
    place = fluid.CUDAPlace(0)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data('x', [256])
        hidden = fluid.layers.fc(x, 512, act='relu')
        pred = fluid.layers.fc(hidden, 10, act='softmax')
    startup.random_seed = SEED
    exe, scope = fluid.Executor(place), fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(SEED + 35)
    feed = {'x': rng.standard_normal((64, 256)).astype('float32')}
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[pred], scope=scope)
    count = exe.compile_count
    check(exe.cached_blocks()[-1].last_ran == 'replay',
          'staleness: the third call did not replay')
    with fluid.program_guard(main, startup):
        fluid.layers.scale(pred, scale=2.0)
    ran = []
    for _ in range(3):
        out, = exe.run(main, feed=feed, fetch_list=[pred], scope=scope)
        ran.append(exe.cached_blocks()[-1].last_ran)
    recount = exe.compile_count
    check(recount == count + 1 and ran == ['eager', 'capture', 'replay'],
          'staleness: after an op was appended, compile_count %d (was %d), '
          'calls %s' % (recount, count, ran))
    params = {p.name: rng.standard_normal(p.shape).astype('float32') * 0.05
              for p in main.all_parameters()}
    fluid.params_from_numpy(main, params, scope=scope, place=place)
    swapped, = exe.run(main, feed=feed, fetch_list=[pred], scope=scope)
    block = exe.cached_blocks()[-1]
    check(block.last_ran == 'replay' and block.captures == 1,
          'staleness: the call after the hand-over ran %s, %d captures' %
          (block.last_ran, block.captures))
    ref_scope = fluid.Scope()
    fluid.params_from_numpy(main, params, scope=ref_scope, place=place)
    want, = eager_run(fluid.Executor(place), main, feed, [pred], ref_scope)
    err = _max_diff([swapped], [want])
    moved = _max_diff([swapped], [out])
    check(err <= CAPTURE_TOL and moved > 1e-3, 'staleness: the replay after '
          'the hand-over differs from an eager run on the new parameters by '
          '%g and from the replay before it by %g' % (err, moved))
    model, scope, exe = forms['kernel']
    blocks = {b.program is model['main']: b for b in exe.cached_blocks()
              if b.mode == 'graph' and b.captures and
              b.program in (model['main'], model['test'])}
    check(len(blocks) == 2, 'staleness: no captured train and test blocks '
          'of the stacked LSTM')
    shared = [p.name for p in model['test'].all_parameters()
              if blocks[True]._state_bufs[p.name] is
              blocks[False]._state_bufs[p.name]]
    check(len(shared) == len(model['test'].all_parameters()),
          'staleness: the stacked LSTM\'s train and test graphs share %d of '
          '%d parameter buffers' % (len(shared),
                                    len(model['test'].all_parameters())))
    print('staleness: an op appended after the capture: compile_count %d -> '
          '%d, calls %s; a hand-over between two replays read by the second '
          '(max|d| %g from an eager run on the new parameters, %g from the '
          'replay before); the stacked LSTM\'s train and test graphs read the '
          'same %d parameter buffers [%s]' %
          (count, recount, ran, err, moved, len(shared), card), flush=True)
    phase_pool_order(card)


def phase_pool_order(card):
    """Two graphs of one executor (one memory pool) replayed out of their
    capture order.  Graph A frees [ROWS, WIDTH] temporaries inside its
    capture; graph B, captured after it, writes the persistable var S
    before it reads it.  S must hold what B's last replay wrote through
    every later replay of A, which reuses its own freed memory as
    scratch."""
    import paddle_tpu_torch.fluid as fluid
    rows, width = DROPOUT_ROWS, DROPOUT_WIDTH
    prog_a, prog_b, startup = fluid.Program(), fluid.Program(), \
        fluid.Program()
    with fluid.unique_name.guard():
        with fluid.program_guard(prog_a, fluid.Program()):
            xa = fluid.layers.data('xa', [width])
            mean_a = fluid.layers.mean(fluid.layers.scale(
                fluid.layers.scale(xa, scale=3.0), scale=0.5, bias=1.0))
        with fluid.program_guard(prog_b, startup):
            xb = fluid.layers.data('xb', [width])
            state = fluid.layers.create_global_var(
                [rows, width], 0.0, 'float32', persistable=True,
                name='written_before_read')
            fluid.layers.assign(fluid.layers.scale(xb, scale=2.0), state)
            mean_b = fluid.layers.mean(xb)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(SEED + 36)
    lot = lambda: rng.standard_normal((rows, width)).astype('float32')
    run_a = lambda: exe.run(prog_a, feed={'xa': lot()}, fetch_list=[mean_a],
                            scope=scope)
    ran, held = [], []

    def run_b():
        feed = lot()
        exe.run(prog_b, feed={'xb': feed}, fetch_list=[mean_b], scope=scope)
        return 2 * feed

    def read():
        got = scope.find_var(state.name).value().cpu().numpy()
        held.append(float(np.abs(got - want).max()))

    def last():
        ran.append(exe.cached_blocks()[-1].last_ran)

    for _ in range(2):  # A: eager, capture
        run_a()
        last()
    for _ in range(2):  # B: eager, capture
        want = run_b()
        last()
    read()
    for _ in range(2):  # then out of capture order
        run_a()
        last()
        read()
        want = run_b()
        last()
        read()
        run_a()
        last()
        read()
    check(ran == ['eager', 'capture'] * 2 + ['replay'] * 6 and
          max(held) == 0, 'pool order: the calls ran %s; |S - what B wrote| '
          'after each call from B\'s capture on: %s' % (ran, held))
    print('pool order: graphs A and B of one executor, B captured after A '
          'and writing S (%d x %d) before it reads it, then replayed A, B, A '
          'twice: S equals what B last wrote at each of the %d reads [%s]' %
          (rows, width, len(held), card), flush=True)


# ----------------------------------------------------------------------------
# CTR: wide-and-deep over one sparse embedding (SparseRows gradients, the
# lazy row-subset optimizers)
# ----------------------------------------------------------------------------
def build_ctr(is_sparse=True, sgd=False):
    """CTR at CTR's widths as bench_ctr builds it (``is_distributed``, an
    attr only in the port; Adam at lr 1e-3, or SGD with ``sgd``), its
    startup run on the card from SEED: (model, scope, executor)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import ctr
    with fluid.unique_name.guard():
        opt = (fluid.optimizer.SGD if sgd else fluid.optimizer.Adam)(
            learning_rate=CTR['lr'])
        model = ctr.build(is_sparse=is_sparse, is_distributed=True,
                          optimizer=opt, **CTR)
    model['startup'].random_seed = SEED
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    t0 = time.perf_counter()
    exe.run(model['startup'], scope=scope)
    torch.cuda.synchronize()
    state = [scope.find_var(v.name).value()
             for v in model['main'].list_vars() if v.persistable]
    print('model: ctr %s %s form, %s, %d persistable vars of %.1f MiB, '
          'startup %.2f s' %
          (CTR, 'sparse' if is_sparse else 'dense', 'SGD' if sgd else 'Adam',
           len(state), _nbytes(state) / 2**20, time.perf_counter() - t0),
          flush=True)
    return model, scope, exe


def ctr_batch(rng):
    """zipf_batch of CTR_BATCH rows at CTR's vocabulary: dense features,
    26 zipfian ids a row, random labels."""
    from paddle_tpu_torch.dataset import ctr as ctr_data
    return ctr_data.zipf_batch(rng, CTR_BATCH, CTR['sparse_dim'])


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _cpu_copy(program, scope):
    """A CPUPlace() scope holding the card scope's persistable vars of
    ``program``."""
    import paddle_tpu_torch.fluid as fluid
    cpu_scope = fluid.Scope()
    fluid.persistables_from_numpy(
        program, {v.name: scope.find_var(v.name).value().cpu().numpy()
                  for v in program.list_vars() if v.persistable},
        scope=cpu_scope, place=fluid.CPUPlace())
    return cpu_scope


def _touched(feed):
    rows = np.zeros(CTR['sparse_dim'], bool)
    rows[np.unique(feed['sparse_ids'])] = True
    return rows


def phase_ctr_serve(card, model, scope, exe):
    """REQUESTS requests of CTR_BATCH rows of CTR's test program, the
    prediction fetched; one under torch.profiler; then the last request's
    batch on the CPU from the same state."""
    import paddle_tpu_torch.fluid as fluid
    rng = np.random.RandomState(SEED + 40)
    requests = [ctr_batch(rng) for _ in range(REQUESTS)]
    fetch = [model['prediction']]
    walls, preds = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()  # every launch counter to 0 just before the serving path
    for i, feed in enumerate(requests):
        t0 = time.perf_counter()
        pred, = exe.run(model['test'], feed=feed, fetch_list=fetch,
                        scope=scope)
        walls.append(time.perf_counter() - t0)
        check(pred.shape == (CTR_BATCH, 1) and np.isfinite(pred).all() and
              ((pred > 0) & (pred < 1)).all(), 'ctr serve: request %d '
              'prediction %s, in (0, 1): %s' % (i, pred.shape,
                                                 ((pred > 0) &
                                                  (pred < 1)).all()))
        preds.append(pred)
    _no_launches('ctr serve')
    peak = torch.cuda.max_memory_allocated()
    steady = statistics.median(walls[1:])
    prof = profile_run(lambda: exe.run(model['test'], feed=requests[0],
                                       fetch_list=fetch, scope=scope))
    print('ctr serve: %d requests of %d rows; steady request wall %.4f s '
          '(median of requests 2-%d; request 1 includes first-call set-up), '
          '%.1f rows/s (prediction fetched to the host); peak device memory '
          '%.1f MiB; one request under torch.profiler: %s [%s]' %
          (REQUESTS, CTR_BATCH, steady, REQUESTS, CTR_BATCH / steady,
           peak / 2**20, _busy_line(prof), card), flush=True)
    cpu_scope = _cpu_copy(model['test'], scope)
    t0 = time.perf_counter()
    want, = fluid.Executor(fluid.CPUPlace()).run(
        model['test'], feed=requests[-1], fetch_list=fetch, scope=cpu_scope)
    cpu_s = time.perf_counter() - t0
    got = preds[-1]
    err = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    check(err <= CTR_SERVE_RTOL, 'ctr serve: card and CPU disagree on the '
          'prediction: |d| / |v| %g (tol %g)' % (err, CTR_SERVE_RTOL))
    print('ctr serve: card vs CPU on %d rows: prediction |d| / |v| %.3g (tol '
          '%g), max|d| %.3g; CPU run %.2f s [%s]' %
          (CTR_BATCH, err, CTR_SERVE_RTOL, float(np.abs(got - want).max()),
           cpu_s, card), flush=True)


def phase_ctr_train(card, model, scope, exe):
    """CTR_TRAIN_STEPS sparse Adam steps on one fixed batch with a falling
    loss (zipf_batch's labels are random: only a fixed batch shows the loss
    fall), one more under torch.profiler; then one step from that state on
    the card and on the CPU: the loss, every gradient (the table's a
    SelectedRows: the same rows, its values), the updated parameters and
    moments, and the table's and the moments' untouched rows bitwise as
    they were on both."""
    rng = np.random.RandomState(SEED + 41)
    feed = ctr_batch(rng)
    losses, walls = [], []
    _zero_counts()  # every launch counter to 0 just before the training path
    for _ in range(CTR_TRAIN_STEPS):
        t0 = time.perf_counter()
        loss, = exe.run(model['main'], feed=feed,
                        fetch_list=[model['loss']], scope=scope)
        walls.append(time.perf_counter() - t0)
        check(np.isfinite(loss).all(), 'ctr train: loss %s' % loss)
        losses.append(float(loss[0]))
    _no_launches('ctr train')
    check(all(b < a for a, b in zip(losses, losses[1:])),
          'ctr train: the loss did not fall at every step: %s' % losses)
    prof = profile_run(lambda: exe.run(model['main'], feed=feed,
                                       fetch_list=[model['loss']],
                                       scope=scope))
    print('ctr train: %d sparse Adam steps (lr %g) on one batch of %d rows, '
          'loss %.6f -> %.6f, falling at every step; steady step wall %.4f s '
          '(median of steps 2-%d); one step under torch.profiler: %s; the '
          'most device time: %s [%s]' %
          (CTR_TRAIN_STEPS, CTR['lr'], CTR_BATCH, losses[0], losses[-1],
           statistics.median(walls[1:]), CTR_TRAIN_STEPS, _busy_line(prof),
           _top_line(prof, 8), card), flush=True)
    compare_ctr_step(card, 'ctr train (sparse)', model, ctr_batch(rng), scope,
                     exe)


def compare_ctr_step(card, tag, model, feed, scope, exe):
    """compare_train_step on one CTR step, then the table's and its moments'
    rows that ``feed`` does not touch: bitwise as they were, on the card and
    on the CPU (lazy Adam)."""
    main = model['main']
    lazy = ['ctr_embedding'] + sorted(
        n for op in main.global_block().ops if op.type == 'adam' and
        op.input('Param') == ['ctr_embedding']
        for n in op.input('Moment1') + op.input('Moment2'))
    before = {n: scope.find_var(n).value().cpu().numpy().copy()
              for n in lazy}
    cpu_scope = compare_train_step(card, tag, '%d rows' % len(feed['dense']),
                                   main, model['loss'].name, feed, scope, exe,
                                   CTR['lr'], CTR_TRAIN_TOL)
    touched = _touched(feed)
    for name in lazy:
        for where, s in (('CPU', cpu_scope), ('card', scope)):
            after = s.find_var(name).value().cpu().numpy()
            check(np.array_equal(after[~touched], before[name][~touched]),
                  '%s: %s moved %s\'s untouched rows' % (tag, where, name))
        moved = (after != before[name]).any(axis=1)  # the card's
        check(moved[touched].mean() > 0.99, '%s: only %d of %d touched rows '
              'of %s moved' % (tag, moved[touched].sum(), touched.sum(),
                               name))
    print('%s: %d of %d rows touched; the other rows of %s bitwise as they '
          'were on the card and on the CPU [%s]' %
          (tag, touched.sum(), CTR['sparse_dim'], ', '.join(lazy), card),
          flush=True)


def _step_peak(exe, program, feed, fetch, scope):
    """One step's max_memory_allocated above what was allocated just before
    it (the state among it), in bytes."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    exe.run(program, feed=feed, fetch_list=fetch, scope=scope)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def phase_ctr_forms(card, sparse, dense, start):
    """The sparse and the dense form from the startup state ``start`` (zero
    moments): one Adam step on one batch leaves every persistable var
    bitwise equal in the two (both merge a repeated id's rows alike, and
    dense Adam moves no untouched row at step 1, so those rows are the
    start's); each step's peak memory above what was allocated before it
    (the sparse step's must stay below one [V, D] table); then
    CTR_SGD_STEPS SGD steps of both forms on the same batches, bitwise
    equal too."""
    import paddle_tpu_torch.fluid as fluid
    place = fluid.CUDAPlace(0)
    feed = ctr_batch(np.random.RandomState(SEED + 42))
    touched = _touched(feed)
    table_bytes = CTR['sparse_dim'] * CTR['embed_size'] * 4
    after, peaks = {}, {}
    for form, model in (('sparse', sparse), ('dense', dense)):
        exe, scope = fluid.Executor(place), fluid.Scope()
        _load(scope, start)
        _zero_counts()  # every launch counter to 0 just before this path
        # the first call of a key runs eagerly: every lowering's own
        # allocations
        peaks[form] = _step_peak(exe, model['main'], feed, [model['loss']],
                                 scope)
        _no_launches('ctr %s step' % form)
        after[form] = {n: scope.find_var(n).value().cpu().numpy()
                       for n in start}
        del exe, scope
        torch.cuda.empty_cache()
    state_bytes = _nbytes(start.values())
    check(peaks['sparse'] < table_bytes, 'ctr forms: the sparse step held '
          '%.1f MiB above the state, not below one [V, D] table (%.1f MiB)'
          % (peaks['sparse'] / 2**20, table_bytes / 2**20))
    differ = [n for n in sorted(start)
              if not np.array_equal(after['sparse'][n], after['dense'][n])]
    lazy = [n for n in start if n.startswith('ctr_embedding')]
    moved = [n for n in lazy if not np.array_equal(
        after['sparse'][n][~touched], start[n].cpu().numpy()[~touched])]
    check(not differ and not moved, 'ctr forms: after one Adam step the '
          'forms differ in %s; untouched rows moved in %s' % (differ, moved))
    print('ctr forms: one Adam step from zero moments on %d rows (%d ids '
          'touched): the sparse and the dense form bitwise equal in all %d '
          'persistable vars, the untouched rows of %s the start\'s; the '
          'step\'s peak above what was allocated before it (state %.1f MiB): '
          'sparse %.1f MiB (limit: one table, %.1f MiB), dense %.1f MiB [%s]'
          % (CTR_BATCH, touched.sum(), len(start), ', '.join(sorted(lazy)),
             state_bytes / 2**20, peaks['sparse'] / 2**20,
             table_bytes / 2**20, peaks['dense'] / 2**20, card), flush=True)
    # SGD: the two forms stay equal over CTR_SGD_STEPS steps
    forms = {}
    for is_sparse in (True, False):
        forms[is_sparse] = build_ctr(is_sparse, sgd=True)
    sgd_state = _persistables(forms[True][0]['main'], forms[True][1])
    _load(forms[False][1], sgd_state)
    rng = np.random.RandomState(SEED + 43)
    batches = [ctr_batch(rng) for _ in range(CTR_SGD_STEPS)]
    _zero_counts()
    for model, scope, exe in forms.values():
        for feed in batches:
            exe.run(model['main'], feed=feed, fetch_list=[model['loss']],
                    scope=scope)
    _no_launches('ctr sgd')
    value = lambda is_sparse, n: forms[is_sparse][1].find_var(n).value()
    differ = [n for n in sorted(sgd_state)
              if not torch.equal(value(True, n), value(False, n))]
    moved = float((value(True, 'ctr_embedding') -
                   sgd_state['ctr_embedding']).abs().max())
    check(not differ and moved > 0, 'ctr sgd: after %d steps the forms '
          'differ in %s; the table moved by %g' %
          (CTR_SGD_STEPS, differ, moved))
    print('ctr sgd: %d SGD steps (lr %g) of the sparse and the dense form on '
          'the same batches: bitwise equal in all %d persistable vars; the '
          'table moved by up to %.3g [%s]' %
          (CTR_SGD_STEPS, CTR['lr'], len(sgd_state), moved, card),
          flush=True)


def phase_word2vec(card):
    """word2vec with is_sparse=True at its build's widths: its four lookups'
    SparseRows summed by one sum op; one SGD step on the card and on the
    CPU from the same state."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import word2vec
    with fluid.unique_name.guard():
        model = word2vec.build(is_sparse=True)
    model['startup'].random_seed = SEED
    scope, exe = fluid.Scope(), fluid.Executor(fluid.CUDAPlace(0))
    exe.run(model['startup'], scope=scope)
    rng = np.random.RandomState(SEED + 44)
    dict_size = model['prediction'].shape[-1]
    feed = {n: rng.randint(0, dict_size, (W2V_BATCH, 1)).astype('int64')
            for n in model['feeds']}
    _zero_counts()
    compare_train_step(card, 'word2vec train (sparse)', '%d rows' % W2V_BATCH,
                       model['main'], model['loss'].name, feed, scope, exe,
                       W2V_LR, dict(CTR_TRAIN_TOL, param_max=W2V_LR))
    _no_launches('word2vec')


def phase_ctr_capture(card, sparse, dense, state):
    """CTR's request, sparse step and dense step captured against eager
    (phase_capture); a fetched ``ctr_embedding@GRAD`` from the eager call,
    the capture and a replay: a SelectedRows each, equal; then run_multi of
    MULTI_K sparse steps against MULTI_K run() calls."""
    import paddle_tpu_torch.fluid as fluid
    place = fluid.CUDAPlace(0)
    rng = np.random.RandomState(SEED + 45)
    feed = ctr_batch(rng)
    what = '%d rows, V=%d D=%d' % (CTR_BATCH, CTR['sparse_dim'],
                                   CTR['embed_size'])
    timed = {}
    timed['serve'] = phase_capture(card, 'ctr serve ' + what, sparse['test'],
                                   feed, [sparse['prediction']], state, {})
    timed['sparse'] = phase_capture(card, 'ctr train (sparse) ' + what,
                                    sparse['main'], feed, [sparse['loss']],
                                    state, {})
    timed['dense'] = phase_capture(card, 'ctr train (dense) ' + what,
                                   dense['main'], feed, [dense['loss']],
                                   state, {})
    print('ctr capture: the sparse step against the dense, captured wall '
          '%.4f / %.4f s, busy %.3f / %.3f ms, peak %.1f / %.1f MiB [%s]' %
          (timed['sparse']['captured']['wall'],
           timed['dense']['captured']['wall'],
           timed['sparse']['captured']['busy_ms'],
           timed['dense']['captured']['busy_ms'],
           timed['sparse']['captured']['peak'] / 2**20,
           timed['dense']['captured']['peak'] / 2**20, card), flush=True)

    # the table's sparse gradient fetched from each path
    fetch = [sparse['loss'], 'ctr_embedding@GRAD']
    exe, scope = fluid.Executor(place), fluid.Scope()
    _load(scope, state)
    want = eager_run(exe, sparse['main'], feed, fetch, scope)
    exe, scope = fluid.Executor(place), fluid.Scope()
    got = {}
    for ran in ('eager', 'capture', 'replay'):
        _load(scope, state)
        got[ran] = exe.run(sparse['main'], feed=feed, fetch_list=fetch,
                           scope=scope)
        check(exe.cached_blocks()[-1].last_ran == ran, 'ctr fetch: a call '
              'ran %s, expected %s' % (exe.cached_blocks()[-1].last_ran, ran))
    # a replay on another batch overwrites the graph's outputs: the fetches
    # already handed out must not change
    exe.run(sparse['main'], feed=ctr_batch(rng), fetch_list=fetch,
            scope=scope)
    check(exe.cached_blocks()[-1].last_ran == 'replay',
          'ctr fetch: the last call did not replay')
    dense_want = want[1].to_dense()
    for ran, out in got.items():
        sr = out[1]
        check(isinstance(sr, fluid.core.SelectedRows) and
              sr.height() == CTR['sparse_dim'] and
              sr.rows() == want[1].rows() and
              np.array_equal(out[0], want[0]) and
              np.array_equal(sr.to_dense(), dense_want),
              'ctr fetch: the %s call\'s ctr_embedding@GRAD (%r) differs from '
              'the eager one\'s' % (ran, sr))
    print('ctr fetch: ctr_embedding@GRAD from the eager call, the capture '
          'and a replay: a SelectedRows of %d rows (height %d) each, its '
          'to_dense() bitwise the eager one\'s after a replay on another '
          'batch [%s]' %
          (len(want[1].rows()), CTR['sparse_dim'], card), flush=True)
    del exe, scope

    # run_multi: MULTI_K sparse steps on MULTI_K batches
    batches = [ctr_batch(rng) for _ in range(MULTI_K)]
    fetch = [sparse['loss']]
    seq_exe, seq_scope = fluid.Executor(place), fluid.Scope()
    _load(seq_scope, state)
    for b in batches:
        seq, = seq_exe.run(sparse['main'], feed=b, fetch_list=fetch,
                           scope=seq_scope)
    exe, scope = fluid.Executor(place), fluid.Scope()
    _load(scope, state)
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    multi, = exe.run_multi(sparse['main'], feed_list=batches,
                           fetch_list=fetch, scope=scope)
    wall = time.perf_counter() - t0
    _no_launches('ctr run_multi')
    block = exe.cached_blocks()[-1]
    names = sorted(state)
    value = lambda s: [s.find_var(v).value().cpu().numpy() for v in names]
    err = max(_max_diff(multi, seq), _max_diff(value(scope),
                                               value(seq_scope)))
    check(block.mode == 'graph' and block.captures == 1 and
          block.replays == MULTI_K - 2 and err <= CAPTURE_TOL,
          'ctr run_multi: mode %s, %d captures, %d replays; %d steps against '
          '%d run() calls differ by %g (tolerance %g)' %
          (block.mode, block.captures, block.replays, MULTI_K, MULTI_K, err,
           CAPTURE_TOL))
    print('ctr run_multi: %d sparse Adam steps on %d batches against %d '
          'run() calls from the same state: %s (max|d| %g over the last loss '
          'and %d persistable vars); wall %.4f s (one eager step and one '
          'capture among them) [%s]' %
          (MULTI_K, MULTI_K, MULTI_K, 'bitwise equal' if err == 0 else
           'within %g' % CAPTURE_TOL, err, len(names), wall, card),
          flush=True)


# ----------------------------------------------------------------------------
# path E: bench.py's configurations at bench.py's widths, with the release
# plan
# ----------------------------------------------------------------------------
# config -> (the batch the card runs, bench.py's batch); a batch below
# bench.py's is a cut, printed beside it (``cut_from``), its out-of-memory
# error recorded in PERF.md (found by probe_bench_widths.py, never here)
BENCH_WIDTHS = {
    'resnet': (512, 512),              # bench.py:351, 224 x 224, AMP
    'transformer': (128, 128),         # bench.py:506, seq 256, base, AMP
    'nmt': (512, 512),                 # bench.py:392, T 32, AMP, LoD feeds
    'stacked_lstm': (128, 128),        # bench.py:596, T 64, AMP
    'resnet_infer_bf16': (256, 256),   # bench.py:689, f32 and bf16
    'ctr': (1024, 1024),               # bench.py:1025, 1,000,000 x 64
}
BENCH_REPLAYS = 3   # timed replays of each configuration after its capture
BENCH_INFER_K = 10  # lots a run_eval_multi call, as bench.py's K


def _transformer_flops_per_token(n_layer, d, d_ff, seq, vocab):
    """bench.py's analytic training FLOPs a token (bench.py:494)."""
    enc = n_layer * (4 * d * d + 2 * d * d_ff + 2 * seq * d)
    dec = n_layer * (8 * d * d + 2 * d * d_ff + 4 * seq * d)
    return 3.0 * 2.0 * (enc + dec + vocab * d)


def _device_feed(feed):
    """Dense feeds staged on the card once, as bench.py stages them (a LoD
    feed stays a host LoDTensor)."""
    return {k: v if not isinstance(v, np.ndarray) else
            torch.from_numpy(v).cuda() for k, v in feed.items()}


def bench_runners(name, batch):
    """bench.py's configuration ``name`` built as bench.py builds it, at
    ``batch``, its startup run on the card from SEED: a list of (tag,
    model dict with 'program', 'startup', 'feed', 'fetch', 'amp',
    'analytic' (bench.py's analytic FLOPs a step) and 'eval_k'), one for
    each program bench.py times (two for resnet_infer_bf16: f32 as loaded
    and folded + bf16)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.dataset import ctr as ctr_data
    from paddle_tpu_torch.models import (ctr, resnet, seq2seq,
                                         stacked_lstm, transformer)
    rng = np.random.RandomState(SEED + 71)
    with fluid.unique_name.guard():
        if name in ('resnet', 'resnet_infer_bf16'):
            m = resnet.build(depth=50, class_dim=1000,
                             image_shape=(3, 224, 224), lr=0.1)
        elif name == 'transformer':
            m = transformer.build(src_vocab=30000, trg_vocab=30000,
                                  max_len=256, n_layer=6, n_head=8,
                                  d_model=512, d_ff=2048)
        elif name == 'nmt':
            m = seq2seq.build(src_dict_dim=30000, trg_dict_dim=30000,
                              embedding_dim=512, encoder_size=512,
                              decoder_size=512)
        elif name == 'stacked_lstm':
            m = stacked_lstm.build()
        else:
            m = ctr.build(sparse_dim=1000000, embed_size=64,
                          hidden_sizes=(256, 128), is_sparse=True,
                          is_distributed=True,
                          optimizer=fluid.optimizer.Adam(learning_rate=1e-3))
    m['startup'].random_seed = SEED
    spec = dict(program=m['main'], startup=m['startup'], fetch=[m['loss']],
                amp=True, eval_k=None, expect={})
    if name == 'resnet':
        spec['feed'] = _device_feed(image_batch(rng, batch, (3, 224, 224),
                                                1000))
        spec['analytic'] = 23.15e9 * batch
    elif name == 'transformer':
        spec['feed'] = _device_feed({
            k: rng.randint(1, 30000, size=(batch, 256)).astype('int64')
            for k in ('src_ids', 'trg_ids', 'lbl_ids')})
        spec['analytic'] = _transformer_flops_per_token(
            6, 512, 2048, 256, 30000) * batch * 256
        # 18 attentions: each forward launched twice (the pass and the
        # grads' replay), dQ and dK/dV once
        spec['expect'] = dict(fwd=36, dq=18, dkv=18)
    elif name == 'nmt':
        def lod(ids):
            rows = [r.reshape(-1, 1).tolist() for r in ids]
            return fluid.create_lod_tensor(rows, [[32] * len(rows)])
        trg = lod(rng.randint(3, 30000, size=(batch, 32)))
        spec['feed'] = {'src_word_id': lod(rng.randint(3, 30000,
                                                       size=(batch, 32))),
                        'target_language_word': trg,
                        'target_language_next_word': trg}
        spec['analytic'] = 1.404e8 * batch * 32
    elif name == 'stacked_lstm':
        rows = [rng.randint(0, 5149, size=(64, 1)).tolist()
                for _ in range(batch)]
        spec['feed'] = {'words': fluid.create_lod_tensor(rows,
                                                         [[64] * batch]),
                        'label': rng.randint(0, 2, size=(batch, 1)).astype(
                            'int64')}
        spec['analytic'] = 3.0 * 2.0 * (128 * 512 + 128 * 512 + 2 * (
            256 * 512 + 128 * 512)) * batch * 64
    elif name == 'ctr':
        spec['feed'] = _device_feed(ctr_data.zipf_batch(rng, batch, 1000000))
        spec['amp'] = False
        d_in = ctr_data.DENSE_DIM + ctr_data.SPARSE_SLOTS * 64
        spec['analytic'] = (d_in * 256 + 256 * 128 + 128 +
                            ctr_data.DENSE_DIM) * 2 * 3 * batch
    if name != 'resnet_infer_bf16':
        return [(name, spec)]
    # bench_resnet_infer_bf16: the test program saved with
    # save_inference_model, loaded as it is (f32) and loaded, batch norm
    # folded and Float16Transpiler('bfloat16')'d; K lots a call
    import tempfile
    x = torch.from_numpy(rng.standard_normal(
        (batch, 3, 224, 224)).astype('float32')).cuda()
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(m['startup'], scope=scope)
    runners = []
    with tempfile.TemporaryDirectory() as td:
        with fluid.scope_guard(scope):
            fluid.io.save_inference_model(td, ['img'], [m['prediction']], exe,
                                          main_program=m['test'])
        del exe, scope
        for half in (False, True):
            exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
            with fluid.scope_guard(scope):
                prog, feeds, fetches = fluid.io.load_inference_model(td, exe)
                if half:
                    fluid.InferenceTranspiler().transpile(prog, scope=scope)
                    fluid.Float16Transpiler().transpile(
                        prog, scope=scope, dtype='bfloat16',
                        feeded_var_names=feeds, fetch_var_names=fetches)
            runners.append(('resnet_infer_%s' % ('bf16' if half else 'f32'),
                            dict(program=prog, startup=None, exe=exe,
                                 scope=scope, feed={feeds[0]: x},
                                 fetch=fetches, amp=False,
                                 eval_k=BENCH_INFER_K, expect={},
                                 analytic=23.15e9 / 3 * batch)))
            del exe, scope
    return runners


def run_bench_width(card, name, batch, cut_from=None):
    """Path E for one configuration: startup, an eager call, the capture
    (a second call), BENCH_REPLAYS replays (resnet_infer_bf16: a
    run_eval_multi call of BENCH_INFER_K lots, captured, then
    BENCH_REPLAYS of them), under FLAGS_cost_accounting.  The launch
    counts are set to 0 before the eager call and read after the capture
    (the hand-written kernels of two calls: bench_transformer's three bf16
    flash kernels; none elsewhere), and a replay's kernels are counted by
    name in the profiler, every one a bf16 instantiation.  Prints each
    program's peak device memory on the eager call and on the capture and
    replays, ``memory_analysis``'s temp bytes beside the capture's peak
    above what was allocated before it, ``cost_report``'s FLOPs a step
    beside bench.py's analytic count, ms a step (a lot), and the loss;
    returns the printed records."""
    import paddle_tpu_torch.fluid as fluid
    records = []
    fluid.FLAGS.cost_accounting = True
    try:
        for tag, spec in bench_runners(name, batch):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            exe = spec.get('exe') or fluid.Executor(fluid.CUDAPlace(0))
            scope = spec.get('scope') or fluid.Scope()
            if spec['startup'] is not None:
                exe.run(spec['startup'], scope=scope)
            program, feed, fetch = spec['program'], spec['feed'], \
                spec['fetch']
            amp = fluid.amp_guard() if spec['amp'] else \
                contextlib.nullcontext()

            def call():
                out = exe.run(program, feed=feed, fetch_list=fetch,
                              scope=scope)
                torch.cuda.synchronize()
                return out

            def timed():
                t0 = time.perf_counter()
                if spec['eval_k']:
                    out = exe.run_eval_multi(program, feed=feed,
                                             fetch_list=fetch,
                                             steps=spec['eval_k'],
                                             scope=scope)
                else:
                    out = call()
                torch.cuda.synchronize()
                return out, (time.perf_counter() - t0) / (spec['eval_k']
                                                         or 1)

            with amp:
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                _zero_counts()
                t0 = time.perf_counter()
                first = call()  # eager
                eager_s = time.perf_counter() - t0
                peak_eager = torch.cuda.max_memory_allocated()
                torch.cuda.empty_cache()
                before = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                call()  # the capture
                peak_capture = torch.cuda.max_memory_allocated()
                launched = _wrapper_counts()
                want = _expect(**{k: 2 * v
                                  for k, v in spec['expect'].items()})
                check(launched == want, 'path E %s: the eager call and the '
                      'capture launched %s, expected %s' %
                      (tag, launched, want))
                if spec['expect']:
                    seen, kinds = _replay_kernels(call,
                                                  _expect(**spec['expect']))
                    check(seen == _expect(**spec['expect']), 'path E %s: a '
                          'replay launched %s on the card' % (tag, seen))
                    _check_dtype('path E ' + tag, kinds, 'bf16', seen)
                walls, out = [], None
                timed()  # the first eval call of a K lots
                for _ in range(BENCH_REPLAYS):
                    out, wall = timed()
                    walls.append(wall)
                peak_captured = torch.cuda.max_memory_allocated()
                stats = exe.memory_analysis(program, feed=feed,
                                            fetch_list=fetch, scope=scope)
            block = exe.cached_blocks()[-1]
            check(block.mode == 'graph' and block.captures == 1 and
                  block.last_ran == 'replay', 'path E %s: the block runs %s '
                  '(%s), %d captures, last %s' %
                  (tag, block.mode, block.why, block.captures,
                   block.last_ran))
            freed = sum(len(v) for v in block._release.values())
            check(freed > 0, 'path E %s: the release plan frees nothing'
                  % tag)
            entries = [e for e in exe.cost_report() if e['kind'] == 'run'
                       and e['fetch_names'] == block.fetch_names]
            check(len(entries) == 1 and entries[0]['flops_per_step'] > 0,
                  'path E %s: cost entries %s' % (tag, entries))
            flops = entries[0]['flops_per_step']
            vals = [np.asarray(v, np.float64) for v in list(first) +
                    list(out)]
            check(all(np.isfinite(v).all() for v in vals),
                  'path E %s: a fetch is not finite' % tag)
            rec = {
                'path': 'E', 'config': tag, 'batch': batch,
                'cut_from': cut_from, 'amp': spec['amp'],
                'eager_s': round(eager_s, 4),
                'peak_mib_eager': round(peak_eager / 2**20, 1),
                'peak_mib_captured': round(peak_captured / 2**20, 1),
                'state_mib': round(base / 2**20, 1),
                'capture_above_before_mib': round(
                    (peak_capture - before) / 2**20, 1),
                'temp_mib': round(stats.temp_size_in_bytes / 2**20, 1),
                'argument_mib': round(stats.argument_size_in_bytes / 2**20,
                                      1),
                'ops': len(block.ops), 'freed_names': freed,
                'launches': {k: v for k, v in launched.items() if v},
                'flops_per_step': flops,
                'analytic_flops_per_step': spec['analytic'],
                'flops_ratio': round(flops / spec['analytic'], 4),
                'ms_per_step': round(1e3 * statistics.median(walls), 3),
                'tflops_per_s': round(flops / statistics.median(walls) /
                                      1e12, 2),
                'loss': (float(np.asarray(out[0], np.float64).mean())
                         if not spec['eval_k'] else None),
                'card': card,
            }
            print('path E: %s' % json.dumps(rec), flush=True)
            records.append(rec)
            del exe, scope, first, out
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
    finally:
        fluid.FLAGS.cost_accounting = False
    return records


def phase_bench_widths(card):
    """Path E: every configuration of BENCH_WIDTHS at its batch."""
    records = []
    for name, (batch, bench_batch) in BENCH_WIDTHS.items():
        records += run_bench_width(card, name, batch,
                                   None if batch == bench_batch else
                                   bench_batch)
    return records


def _time_ms(fn, launches_per_sample=10, samples=20, warmup=5):
    """Median device time of one call (CUDA events around back-to-back
    launches, so host overhead between launches is hidden)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches_per_sample):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches_per_sample)
    return statistics.median(times)


def _activity_name(name):
    """A device activity's name without its argument list."""
    return name.replace('(anonymous namespace)::', '').split('(')[0].strip()


def _device_ms(fn, calls=20, warmup=3):
    """(device time of one call in ms, names of the device activities it
    ran) under torch.profiler, over ``calls`` back-to-back calls: for each
    activity, its median duration times its count per call (rounded, so
    that an event the profiler drops moves nothing), summed.  The wrapper's
    host work does not count.  A count that is not a multiple of ``calls``
    is printed; (None, names) when the profiler saw no device events.

    The profiler sometimes records no device activity in a session, or
    drops most of one activity's events (seen in late phases of long runs
    on the card; every activity here runs at least once a call): such a
    session is printed and taken again, five sessions at most, and the last
    one is used."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for session in range(5):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        durations = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                durations.setdefault(e.name, []).append(
                    e.time_range.elapsed_us())
        short = [n for n, d in durations.items() if 2 * len(d) < calls]
        if durations and not short:
            break
        print('times: profiler session %d of 5 recorded %s' %
              (session + 1, 'no device activity' if not durations else
               'under half the events of %s' %
               ', '.join(_activity_name(n)[:60] for n in short)),
              flush=True)
    names = sorted(set(_activity_name(n)[:100] for n in durations))
    for name, d in sorted(durations.items()):
        if len(d) % calls:
            print('times: %d device events of %s in %d calls' %
                  (len(d), _activity_name(name)[:100], calls), flush=True)
    if not durations:
        print('times: no device event in %d calls' % calls, flush=True)
        return None, names
    return sum(max(1, round(len(d) / calls)) * statistics.median(d)
               for d in durations.values()) / 1e3, names


def _kernel_device_ms(fn, name):
    """The device time of one call of a kernel's wrapper; fails without it."""
    ms = _device_ms(fn)[0]
    check(ms is not None, '%s: torch.profiler gave no device time' % name)
    return ms


def _fmt_ms(ms):
    return 'not measured' if ms is None else '%.4f ms' % ms


def phase_times(card, launches, fwd_err, bwd_err, dtype=torch.float32,
                path='train'):
    """The flash kernels, their plain versions and SDPA at the Transformer
    slice's shape in ``dtype``; ``launches`` of the main path ``path``.
    ``fwd_err``/``bwd_err``: the kernels' worst errors against plain from
    the sweeps, or None to hold the kernels' errors at this shape only.
    bf16 rows are named with the suffix ``_bf16`` and bound at the bf16
    tensor-core rate."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    bf16 = dtype == torch.bfloat16
    label, suffix = ('bf16', '_bf16') if bf16 else ('f32', '')
    esize = 2 if bf16 else 4
    rate, rate_text = ((PEAK_BF16_FLOPS, BOUND_RATE_BF16) if bf16 else
                       (PEAK_3XTF32_FLOPS, BOUND_RATE))
    b, h, seq = BATCH, TRANSFORMER_BASE['n_head'], TRANSFORMER_BASE['max_len']
    d = TRANSFORMER_BASE['d_model'] // h
    scale = d**-0.5
    q, k, v = _qkv(b, seq, seq, h, d, dtype, SEED)
    do = _qkv(b, seq, seq, h, d, dtype, SEED + 7)[0]
    err = ({'fwd': fwd_err, 'dq': bwd_err['dq'], 'dkv': bwd_err['dkv']}
           if fwd_err is not None else dict.fromkeys(('fwd', 'dq', 'dkv'),
                                                      0.0))
    for causal in (False, True):  # the slice's encoder and decoder calls
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        po, plse = fa.flash_attention_plain(q, k, v, causal=causal)
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        pdq, pdk, pdv = fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                     causal=causal)
        torch.cuda.synchronize()
        for name, g, w in (('O', o, po), ('LSE', lse, plse), ('dQ', dq, pdq),
                           ('dK', dk, pdk), ('dV', dv, pdv)):
            tol = TOL[dtype] * max(1.0, w.abs().max().item())
            check((g - w).abs().max().item() <= tol,
                  'kernel disagrees with plain at the slice shape (%s, '
                  'causal=%s): %s' % (label, causal, name))
        diff = lambda g, w: (g.float() - w.float()).abs().max().item()
        err['fwd'] = max(err['fwd'], diff(o, po))
        err['dq'] = max(err['dq'], diff(dq, pdq))
        err['dkv'] = max(err['dkv'], diff(dk, pdk), diff(dv, pdv))
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = fa._launch_dq(q, k, v, o, do, lse, None, False, scale)[1]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    calls = {
        'fwd': lambda: fa.flash_attention_fwd(q, k, v),
        'dq': lambda: fa._launch_dq(q, k, v, o, do, lse, None, False, scale),
        'dkv': lambda: fa._launch_dkv(q, k, v, do, lse, delta, None, False,
                                      scale),
    }
    ms = {key: _time_ms(fn) for key, fn in calls.items()}
    # the same calls' device time alone, without the wrappers' host work
    device_ms = {key: _kernel_device_ms(fn, key)
                 for key, fn in calls.items()}
    plain_ms = {'fwd': _time_ms(lambda: fa.flash_attention_plain(q, k, v))}
    # the plain backward computes dQ, dK and dV in one call: both backward
    # rows carry its time
    plain_ms['dq'] = plain_ms['dkv'] = _time_ms(
        lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do))
    sdpa_fwd = lambda: sdpa(qt, kt, vt)
    library_ms = {'fwd': _time_ms(sdpa_fwd)}
    library_device_ms = {}
    library_device_ms['fwd'], fwd_names = _device_ms(sdpa_fwd)
    # SDPA's backward alone: one call gives dQ, dK and dV, so both backward
    # rows carry this combined time
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    out = sdpa(qg, kg, vg)
    dout = do.transpose(1, 2).contiguous()
    sdpa_bwd = lambda: torch.autograd.grad(out, (qg, kg, vg), dout,
                                           retain_graph=True)
    library_ms['dq'] = library_ms['dkv'] = _time_ms(sdpa_bwd)
    bwd_dev, bwd_names = _device_ms(sdpa_bwd)
    library_device_ms['dq'] = library_device_ms['dkv'] = bwd_dev
    print('times: SDPA %s ran, forward: %s; backward: %s [%s]' %
          (label, ', '.join(fwd_names), ', '.join(bwd_names), card),
          flush=True)
    # least time of each call: its products (2 FLOP per multiply-add, every
    # (row, column) pair unmasked here) at the 3xTF32 rate, against its
    # inputs read once and its outputs written once at the HBM rate
    elems = b * seq * h * d * esize  # bytes of one [B, L, H, D] tensor
    rows = b * seq * h * 4           # one [B, L, H] f32 tensor (LSE, delta)
    pairs = b * h * seq * seq * d
    work = {
        'fwd': (4.0 * pairs, 4 * elems + rows),  # q k v -> O LSE
        # q k v O dO LSE -> dQ delta (delta's products, 2 FLOP an element)
        'dq': (6.0 * pairs + 2.0 * elems / esize, 6 * elems + 2 * rows),
        'dkv': (8.0 * pairs, 6 * elems + 2 * rows),  # -> dK dV
    }
    sources = {
        'fwd': ('flash_attention_fwd', 'flash_attention_fwd.cu', 37),
        'dq': ('flash_attention_dq', 'flash_attention_bwd.cu', 87),
        'dkv': ('flash_attention_dkv', 'flash_attention_bwd.cu', 130),
    }
    kernels = []
    for key in ('fwd', 'dq', 'dkv'):
        flops, nbytes = work[key]
        bound_ms, bound_by, bound_simt_ms = bound(flops, nbytes, rate)
        name, src, line = sources[key]
        name += suffix
        print('times: %s %s B=%d Lq=Lk=%d H=%d D=%d non-causal: kernel %.4f '
              'ms (device %s), plain %.4f ms, library %.4f ms (device %s), '
              'bound %.4f ms by %s (%.3g GFLOP, %.3g MB; %s), %.4f ms at 67 '
              'TFLOP/s f32 [%s]' %
              (name, label, b, seq, h, d, ms[key], _fmt_ms(device_ms[key]),
               plain_ms[key], library_ms[key],
               _fmt_ms(library_device_ms[key]), bound_ms, bound_by,
               flops / 1e9, nbytes / 1e6, rate_text, bound_simt_ms, card),
              flush=True)
        kernels.append({
            'name': name,
            'dtype': label,
            'route': 'cuda',
            'source': 'paddle_tpu_torch/csrc/' + src,
            'replaces': 'paddle_tpu/ops/pallas/flash_attention.py:%d' % line,
            'launches': launches[path].wrapper[key],
            'launches_by_path': {p: launches[p].wrapper[key]
                                 for p in launches},
            'device_launches': launches[path].by_dtype[label][key],
            'device_launches_by_path': {p: launches[p].device[key]
                                        for p in launches},
            'max_abs_err': err[key],
            'ms': ms[key],
            'device_ms': device_ms[key],
            'plain_ms': plain_ms[key],
            'bound_ms': bound_ms,
            'bound_by': bound_by,
            'bound_rate': rate_text,
            'library_ms': library_ms[key],
            'library_device_ms': library_device_ms[key],
        })
    if bf16:
        return kernels
    # the forward in bf16 at the same shape, beside SDPA's bf16 call
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    qtb, ktb, vtb = (x.transpose(1, 2).contiguous() for x in (qb, kb, vb))
    kernel_bf16 = lambda: fa.flash_attention_fwd(qb, kb, vb)
    sdpa_bf16 = lambda: sdpa(qtb, ktb, vtb)
    bf16 = [(_time_ms(kernel_bf16),
             _kernel_device_ms(kernel_bf16, 'fwd bf16')),
            (_time_ms(sdpa_bf16), _device_ms(sdpa_bf16)[0])]
    print('times: flash_attention_fwd bf16 at the same shape: kernel %.4f ms '
          '(device %s), SDPA bf16 %.4f ms (device %s) [%s]' %
          (bf16[0][0], _fmt_ms(bf16[0][1]), bf16[1][0], _fmt_ms(bf16[1][1]),
           card), flush=True)
    bwd_device = device_ms['dq'] + device_ms['dkv']
    print('times: backward at the slice shape, device time: dQ with delta %s '
          '+ dK/dV %s = %s against SDPA backward (dQ, dK, dV in one call) %s, '
          '%s; events: dQ %.4f + dK/dV %.4f = %.4f ms against SDPA backward '
          '%.4f ms; plain backward %.4f ms [%s]' %
          (_fmt_ms(device_ms['dq']), _fmt_ms(device_ms['dkv']),
           _fmt_ms(bwd_device), _fmt_ms(library_device_ms['dq']),
           'not measured' if library_device_ms['dq'] is None else
           '%.2fx' % (bwd_device / library_device_ms['dq']),
           ms['dq'], ms['dkv'], ms['dq'] + ms['dkv'], library_ms['dq'],
           plain_ms['dq'], card), flush=True)
    return kernels


def _lstm_op(fluid, d):
    """A one-op program: the ``lstm`` op of the kernel form's layers
    (no peepholes) over a LoD input of width 4D; (block, op)."""
    prog = fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog,
                                                         fluid.Program()):
        x = fluid.layers.data(name='x', shape=[4 * d], dtype='float32',
                              lod_level=1)
        fluid.layers.dynamic_lstm(input=x, size=4 * d, use_peepholes=False)
    block = prog.global_block()
    return block, [op for op in block.ops if op.type == 'lstm'][0]


def _lstm_errors_at(lk, xs, w, bias, h0, c0, mask, dhs, dcs, what):
    """The LSTM kernels against their plain versions on these inputs (as
    phase_lstm_vs_plain): the worst max|d| of the forward, the walk and
    dW/db."""
    phs, pcs, pacts = lk.lstm_fwd_plain(xs, w, bias, h0, c0, mask)
    bare = lk.lstm_fwd(xs, w, bias, h0, c0, mask, save_acts=False)
    got_b = lk.lstm_bwd(w, mask, pacts, pcs, phs, h0, c0, dhs, dcs)
    want_b = lk.lstm_bwd_plain(w, mask, pacts, pcs, phs, h0, c0, dhs, dcs)
    torch.cuda.synchronize()
    pairs = [('lstm_fwd', 'hs', bare[0], phs), ('lstm_fwd', 'cs', bare[1],
                                                  pcs)]
    pairs += list(zip(('lstm_bwd', 'lstm_dw', 'lstm_dw', 'lstm_bwd',
                       'lstm_bwd'), ('dx', 'dW', 'db', 'dh0', 'dc0'), got_b,
                      want_b))
    worst = dict.fromkeys(('lstm_fwd', 'lstm_bwd', 'lstm_dw'), 0.0)
    tol = LSTM_TOL[xs.dtype]
    for kernel, name, got, want in pairs:
        scale = max(1.0, want.abs().max().item())
        e = (got.float() - want.float()).abs().max().item()
        check(got.shape == want.shape and e <= tol * scale,
              'LSTM kernel disagrees with plain at %s: max|d%s| %g > '
              '%g * %g' % (what, name, e, tol, scale))
        worst[kernel] = max(worst[kernel], e)
    return worst


def phase_lstm_times(card, launches, err, b=LSTM_BATCH, t=LSTM_MAX_LEN,
                     d=STACKED_LSTM['hid_dim'], path='lstm_train',
                     suffix='', extras=True, dtype=torch.float32):
    """The LSTM kernels, their plain versions and cuDNN's LSTM at B, T, D in
    ``dtype``, every row full length (the stacked-LSTM slice's shape by
    default); ``launches`` of the main path ``path``; ``err`` the kernels'
    worst errors against plain, measured at this shape when None.
    ``extras``: also the forward's and the walk's device time at each
    cluster size, the walk at bf16, and the lstm op's two paths on the
    card."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.ops.kernels import lstm as lk
    shape = '%s B=%d T=%d D=%d' % ('bf16' if dtype == torch.bfloat16 else
                                   'f32', b, t, d)
    xs, w, bias, h0, c0, mask, dhs, dcs = _lstm_inputs(
        dtype, b, t, d, False, SEED + 6)
    if err is None:
        err = _lstm_errors_at(lk, xs, w, bias, h0, c0, mask, dhs, dcs, shape)
    hs, cs, acts = lk.lstm_fwd(xs, w, bias, h0, c0, mask)
    dx, _, _, db_part = lk._launch_walk(w, mask, acts, cs, h0, c0, dhs, dcs)
    calls = {
        'lstm_fwd': lambda: lk.lstm_fwd(xs, w, bias, h0, c0, mask,
                                        save_acts=False),
        'lstm_bwd': lambda: lk._launch_walk(w, mask, acts, cs, h0, c0, dhs,
                                            dcs),
        'lstm_dw': lambda: lk._launch_dw(hs, h0, dx, db_part),
    }
    ms = {key: _time_ms(fn) for key, fn in calls.items()}
    device_ms = {key: _kernel_device_ms(fn, key)
                 for key, fn in calls.items()}
    fwd_acts_ms = _time_ms(lambda: lk.lstm_fwd(xs, w, bias, h0, c0, mask))
    if extras:
        extra = _lstm_cluster_times(card, lk, b, t, d, xs, w, bias, h0, c0,
                                    mask, acts, cs, dhs, dcs)
    else:
        extra = {}
    plain_ms = {'lstm_fwd': _time_ms(
        lambda: lk.lstm_fwd_plain(xs, w, bias, h0, c0, mask,
                                  save_acts=False), 2, 10)}
    # the plain backward computes dx, dW and db in one call: both backward
    # rows carry its time
    plain_ms['lstm_bwd'] = plain_ms['lstm_dw'] = _time_ms(
        lambda: lk.lstm_bwd_plain(w, mask, acts, cs, hs, h0, c0, dhs, dcs),
        2, 10)
    # cuDNN's LSTM at the same B, T and D; it also projects its D-wide
    # input (x . W_ih, which the port's lstm op receives done)
    cudnn = torch.nn.LSTM(d, d).cuda().to(dtype)
    x_in = torch.randn(t, b, d, device='cuda', dtype=dtype)
    def cudnn_fwd():
        with torch.no_grad():
            return cudnn(x_in)

    library_ms = {'lstm_fwd': _time_ms(cudnn_fwd)}
    library_device_ms = {'lstm_fwd': _device_ms(cudnn_fwd)[0]}
    x_req = x_in.detach().requires_grad_()
    out, _ = cudnn(x_req)
    wrt = [x_req] + list(cudnn.parameters())
    dout = torch.randn_like(out)
    # cuDNN's backward gives dx and the weight gradients in one call: both
    # backward rows carry its time
    cudnn_bwd = lambda: torch.autograd.grad(out, wrt, dout, retain_graph=True)
    library_ms['lstm_bwd'] = library_ms['lstm_dw'] = _time_ms(cudnn_bwd)
    library_device_ms['lstm_bwd'] = library_device_ms['lstm_dw'] = \
        _device_ms(cudnn_bwd)[0]
    if extras:
        extra['op_ms'] = _lstm_op_times(card, fluid, registry, b, t, d, xs, w,
                                        bias)
    return _lstm_rows(card, b, t, d, launches, path, suffix, err, shape, ms,
                      device_ms, plain_ms, library_ms, library_device_ms,
                      fwd_acts_ms, extra, dtype)


def _lstm_cluster_times(card, lk, b, t, d, xs, w, bias, h0, c0, mask, acts,
                        cs, dhs, dcs):
    """The walk's device time at each cluster size (f32) and at bf16, and
    the forward's at each cluster size its plan takes."""
    # the walk's device time at each cluster size (f32), and at bf16 beside
    # f32: bf16 halves the bytes of W, so where W streams from L2 (one CTA
    # a cluster) the gap between the two prices that streaming
    cluster = lk.walk_cluster(b, d, torch.float32)
    by_cluster = {n: _kernel_device_ms(
        lambda: lk._launch_walk(w, mask, acts, cs, h0, c0, dhs, dcs,
                                cluster=n), 'lstm_bwd N=%d' % n)
        for n in (1, 2, 4, 8)}
    xb, wb, hb, dhb = (x.to(torch.bfloat16) for x in (xs, w, h0, dhs))
    _, csb, actsb = lk.lstm_fwd(xb, wb, bias, hb, c0, mask)
    walk_bf16 = lambda n=0: lk._launch_walk(wb, mask, actsb, csb, hb, c0, dhb,
                                            dcs, cluster=n)
    bf16_ms = _time_ms(walk_bf16)
    bf16_device = {n: _kernel_device_ms(lambda: walk_bf16(n),
                                        'lstm_bwd bf16 N=%d' % n)
                   for n in (0, 1)}
    print('times: lstm_bwd walk device time by cluster size (f32 B=%d T=%d '
          'D=%d; the library picks %d): %s; bf16 %.4f ms (device %s, %s at '
          'N=1; the library picks %d) [%s]' %
          (b, t, d, cluster, ', '.join('N=%d %s' % (n, _fmt_ms(v))
                                       for n, v in by_cluster.items()),
           bf16_ms, _fmt_ms(bf16_device[0]), _fmt_ms(bf16_device[1]),
           lk.walk_cluster(b, d, torch.bfloat16), card), flush=True)
    # the forward's device time at each cluster size its plan takes
    fwd_n = lk.fwd_cluster(b, d, torch.float32)
    fwd_by_cluster = {n: _kernel_device_ms(
        lambda: lk._launch_fwd(xs, w, bias, h0, c0, mask, False, cluster=n),
        'lstm_fwd N=%d' % n)
        for n in lk.fwd_cluster_sizes(d, torch.float32)}
    print('times: lstm_fwd device time by cluster size (f32 B=%d T=%d D=%d, '
          'no activations saved; the library picks %d): %s [%s]' %
          (b, t, d, fwd_n, ', '.join('N=%d %s' % (n, _fmt_ms(v))
                                     for n, v in fwd_by_cluster.items()),
           card), flush=True)
    return {'fwd_n': fwd_n, 'fwd_by_cluster': fwd_by_cluster,
            'cluster': cluster, 'by_cluster': by_cluster,
            'bf16_ms': bf16_ms, 'bf16_device': bf16_device}


def _lstm_op_times(card, fluid, registry, b, t, d, xs, w, bias):
    """The lstm op on the card, scan path ('never') and kernel ('auto'):
    CUDA events around back-to-back runs of the lowering, so the host's
    launch gaps count."""
    block, op = _lstm_op(fluid, d)
    env = {op.input('Input')[0]: xs.transpose(0, 1).contiguous(),
           op.input('Input')[0] + registry.SEQLEN_SUFFIX:
           torch.full((b, ), t, dtype=torch.int32, device='cuda'),
           op.input('Weight')[0]: w, op.input('Bias')[0]: bias}
    ctx = registry.LoweringContext(block, env, fluid.CUDAPlace(0))
    op_ms = {}
    with torch.no_grad():
        for mode in ('never', 'auto', 'never', 'auto'):
            fluid.FLAGS.fused_lstm = mode
            op_ms.setdefault(mode, []).append(_time_ms(
                lambda: registry.run_op(ctx, op), 2, 10))
    fluid.FLAGS.fused_lstm = 'auto'
    print('times: lstm op (B=%d T=%d D=%d f32, no peepholes) on the card: '
          'scan path (FLAGS_fused_lstm=never) %s ms, kernel path (auto) %s '
          'ms (two turns each, never/auto/never/auto) [%s]' %
          (b, t, d, ', '.join('%.4f' % v for v in op_ms['never']),
           ', '.join('%.4f' % v for v in op_ms['auto']), card), flush=True)
    return op_ms


def _lstm_rows(card, b, t, d, launches, path, suffix, err, shape, ms,
               device_ms, plain_ms, library_ms, library_device_ms,
               fwd_acts_ms, extra, dtype=torch.float32):
    """The kernels line's LSTM entries at one shape, each printed."""
    # least time: the products (2 FLOP per multiply-add) at the tensor-core
    # rate of the dtype (3xTF32 for f32), against the inputs read once and
    # the outputs written once: x, W, h, the activations and dx in the
    # dtype (e bytes), the cell, mask, bias and the db rows f32
    bf16 = dtype == torch.bfloat16
    label, e = ('bf16', 2) if bf16 else ('f32', 4)
    rate, rate_text = ((PEAK_BF16_FLOPS, BOUND_RATE_BF16) if bf16 else
                       (PEAK_3XTF32_FLOPS, BOUND_RATE))
    gate_elems, h_elems = t * b * 4 * d, t * b * d
    db_rows = math.ceil(b / 4) * 4 * d
    flops = 2.0 * t * b * d * 4 * d
    work = {
        # xs, w, h0, hs | bias, c0, mask, cs
        'lstm_fwd': (flops, e * (gate_elems + 4 * d * d + b * d + h_elems) +
                     4 * (4 * d + b * d + t * b + h_elems)),
        # w, acts, dx, dhs, h0 | mask, cs, dcs, c0, dc0, db rows
        'lstm_bwd': (flops, e * (4 * d * d + 2 * gate_elems + h_elems +
                                 b * d) +
                     4 * (t * b + 2 * h_elems + 2 * b * d + db_rows)),
        # hs, h0, dx | db rows -> dW, db
        'lstm_dw': (flops, e * (h_elems + b * d + gate_elems) +
                    4 * (db_rows + 4 * d * d + 4 * d)),
    }
    sources = {
        'lstm_fwd': ('lstm_fwd', 'lstm_fwd.cu', 41),
        'lstm_bwd': ('lstm_bwd', 'lstm_bwd.cu', 83),
        'lstm_dw': ('lstm_bwd_dw', 'lstm_bwd.cu', 83),
    }
    kernels = []
    for key in ('lstm_fwd', 'lstm_bwd', 'lstm_dw'):
        flops_k, nbytes = work[key]
        bound_ms, bound_by, bound_simt_ms = bound(flops_k, nbytes, rate)
        name, src, line = sources[key]
        name += suffix
        print('times: %s %s B=%d T=%d D=%d: kernel %.4f ms (%.2f us a step; '
              'device %s), plain %.4f ms, cuDNN LSTM %.4f ms (device %s), '
              'bound %.4f ms by %s (%.3g GFLOP, %.3g MB; %s), %.4f ms at 67 '
              'TFLOP/s f32 [%s]' %
              (name, label, b, t, d, ms[key], 1e3 * ms[key] / t,
               _fmt_ms(device_ms[key]), plain_ms[key], library_ms[key],
               _fmt_ms(library_device_ms[key]), bound_ms, bound_by,
               flops_k / 1e9, nbytes / 1e6, rate_text, bound_simt_ms, card),
              flush=True)
        entry = {
            'name': name,
            'dtype': label,
            'route': 'cuda',
            'source': 'paddle_tpu_torch/csrc/' + src,
            'replaces': 'paddle_tpu/ops/pallas/lstm.py:%d' % line,
            'shape': shape,
            'launches': launches[path].wrapper[key],
            'launches_by_path': {p: launches[p].wrapper[key]
                                 for p in launches},
            'device_launches': launches[path].by_dtype[label][key],
            'device_launches_by_path': {p: launches[p].device[key]
                                        for p in launches},
            'max_abs_err': err[key],
            'ms': ms[key],
            'device_ms': device_ms[key],
            'plain_ms': plain_ms[key],
            'bound_ms': bound_ms,
            'bound_by': bound_by,
            'bound_rate': rate_text,
            'library_ms': library_ms[key],
            'library_device_ms': library_device_ms[key],
        }
        if key == 'lstm_fwd':
            entry['ms_with_acts'] = fwd_acts_ms
        if extra and key == 'lstm_fwd':
            entry['cluster'] = extra['fwd_n']
            entry['device_ms_by_cluster'] = extra['fwd_by_cluster']
        if extra and key == 'lstm_bwd':
            entry['cluster'] = extra['cluster']
            entry['device_ms_by_cluster'] = extra['by_cluster']
            entry['bf16_ms'] = extra['bf16_ms']
            entry['bf16_device_ms'] = extra['bf16_device'][0]
        kernels.append(entry)
    print('times: at %s: lstm_fwd with the activations saved %.4f ms; '
          'forward device time / cuDNN forward\'s %.2fx; backward walk + dW '
          '%.4f ms against cuDNN backward %.4f ms (includes its input '
          'projection\'s gradient)%s [%s]' %
          (shape, fwd_acts_ms, device_ms['lstm_fwd'] /
           library_device_ms['lstm_fwd'] if library_device_ms['lstm_fwd']
           else float('nan'), ms['lstm_bwd'] + ms['lstm_dw'],
           library_ms['lstm_bwd'],
           '; op scan path / kernel path %.1fx' %
           (statistics.median(extra['op_ms']['never']) /
            statistics.median(extra['op_ms']['auto'])) if extra else '',
           card), flush=True)
    return kernels


def main():
    global SEED
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--seed', type=int, default=SEED)
    SEED = ap.parse_args().seed
    card = phase_device()
    sys.path.insert(0, REPO)
    phase_build()
    _scan_runs()  # counts the lstm op's scan path from here on
    fwd_err = phase_kernel_vs_plain()
    bwd_err = phase_bwd_vs_plain()
    lstm_err = phase_lstm_vs_plain()
    model, scope, exe = build_model()
    launches = {'serve': phase_slice(card, model, scope, exe),
                'train': phase_train(card, model, scope, exe)}
    phase_train_card_vs_cpu(card, model, scope, exe)
    phase_transformer_capture(card, model, scope)
    launches.update(phase_amp_transformer(card, model, scope, exe))
    del model, scope, exe
    torch.cuda.empty_cache()
    forms = build_lstm_models()
    launches['lstm_serve'] = phase_lstm_serve(card, forms)
    launches['lstm_train'] = phase_lstm_train(card, forms)
    phase_lstm_train_card_vs_cpu(card, forms)
    phase_lstm_capture(card, forms)
    phase_multi(card, forms)
    phase_dropout(card)
    phase_staleness(card, forms)
    launches.update(phase_amp_lstm(card, forms))
    del forms
    torch.cuda.empty_cache()
    nmt = build_nmt_models()
    launches['nmt_serve'] = phase_nmt_serve(card, nmt)
    launches['nmt_train'] = phase_nmt_train(card, nmt)
    phase_nmt_decode(card, nmt)
    phase_nmt_capture(card, nmt)
    del nmt
    torch.cuda.empty_cache()
    resnet = build_cv_model('resnet', lr=CV_LR, **RESNET50)
    phase_resnet_serve(card, *resnet)
    phase_resnet_train(card, *resnet)
    phase_resnet_capture(card, resnet[0], resnet[1])
    phase_amp_resnet_train(card, *resnet)
    resnet[2].close()  # its graphs' pool, before batch 256
    torch.cuda.empty_cache()
    phase_resnet_infer_bf16(card, resnet[0])
    del resnet
    torch.cuda.empty_cache()
    phase_mnist(card)
    phase_vgg(card)
    sparse, scope, exe = build_ctr(is_sparse=True)
    start = _persistables(sparse['main'], scope)
    phase_ctr_serve(card, sparse, scope, exe)
    phase_ctr_train(card, sparse, scope, exe)
    dense = build_ctr(is_sparse=False)[0]
    phase_ctr_forms(card, sparse, dense, start)
    phase_word2vec(card)
    phase_ctr_capture(card, sparse, dense,
                      _persistables(sparse['main'], scope))
    del sparse, dense, scope, exe, start
    torch.cuda.empty_cache()
    phase_bench_widths(card)
    kernels = phase_times(card, launches, fwd_err, bwd_err)
    kernels += phase_lstm_times(card, launches, lstm_err)
    kernels += phase_lstm_times(card, launches, None, b=NMT_BATCH,
                                t=NMT_MAX_LEN, d=NMT['encoder_size'],
                                path='nmt_train', suffix='_d512',
                                extras=False)
    # the bf16 instantiations, at the shapes of paths A and B
    kernels += phase_times(card, launches, None, None, dtype=torch.bfloat16,
                           path='amp_train')
    kernels += phase_lstm_times(card, launches, None, path='amp_lstm_train',
                                suffix='_bf16', extras=False,
                                dtype=torch.bfloat16)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
