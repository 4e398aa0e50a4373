#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N]   # from the repository root
    python3 chip_smoke.py --only-book | --only-flow | --only-serve |
        --only-generate | --only-pipeline | --only-ops | --only-parallel

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
F. the book models, run after phase 3 and before phase 4, each fed
   through its dataset's reader, ``paddle_tpu_torch.batch`` and
   ``fluid.DataFeeder``.  No hand-written kernel lies on this path: the
   launch counters are set to 0 before each of its training and serving
   runs and must read 0 after it, and its calls run without the profiler
   (a replay of each block is counted by name in ``phase_capture``):
   F1. SRL (``label_semantic_roles``) at the widths of the book chapter
       (word_dim 32, mark_dim 5, hidden 512, depth 8; conll05's 4000
       words, 200 verbs, 59 labels): ``BOOK_STEPS`` SGD steps of
       ``SRL_BATCH`` sentences, eager then captured, the loss falling; one
       step against the CPU (``SRL_TRAIN_TOL``); ``SRL_SERVE`` sentences
       decoded against the CPU, tie-aware (``compare_viterbi``,
       ``SRL_DECODE_TOL``); a ``ChunkEvaluator`` (IOB, 29 chunk types) over
       the served paths, run eagerly through its host op and never
       captured, with the CPU's precision, recall and F1;
   F2. the recommender at its build's widths on movielens: ``BOOK_STEPS``
       steps of ``REC_BATCH`` ratings, one against the CPU, a request
       against the CPU;
   F3. fit_a_line on uci_housing: ``FIT_EPOCHS`` epochs of ``FIT_BATCH``
       rows, one step against the CPU, ``save_inference_model`` ->
       ``load_inference_model`` predicting what the test program does.
   Each step and request is also captured against eager
   (``phase_capture``), and each prints a ``path F: {...}`` line: walls
   eager and captured, busy and idle share, peak memory,
   ``memory_analysis``'s temp bytes and ``cost_report``'s FLOPs a step
   (the host-op block: its eager wall beside the decode's, no temp, as
   ``memory_analysis`` raises on it by design).  ``--only-book`` runs the
   device phase and path F alone and prints no result line.
G. control flow, tensor arrays, learning-rate schedules and the optimizers
   of the control-flow slice, run right after path F, f32:
   G1. Transformer-base (``TRANSFORMER_BASE``, BATCH x 256) built from
       ``models/transformer.py``'s helpers (``transformer_noam_programs``)
       and trained by Fluid's recipe: Adam (beta2 0.98, epsilon 1e-9)
       under ``2.0 * noam_decay(512, 4000)``, the scale through
       ``math_op_patch``.  One eager call, the capture and
       ``FLOW_REPLAYS`` replays, each counting 36 flash forwards, 18 dQ
       and 18 dK/dV on the card (``_Path``); the rate fetched at every
       step against noam's closed form within ``LR_RTOL``; the step
       counter equal to the calls; one 2 x 256 step against the CPU
       (``TRAIN_TOL``); the step captured against eager.
   G2. CTR at bench_ctr's widths (1,000,000 x 64, batch 1024, sparse)
       under each optimizer with a sparse form: Adagrad, RMSProp, Ftrl and
       Adadelta by row subset, Adamax and DecayedAdagrad by ``lazy_apply``,
       each at a rate from ``piecewise_decay`` (``CTR_PIECEWISE``:
       boundaries cut to steps 2 and 4 so that the replays cross both),
       one after another, each one's state freed before the next:
       ``FLOW_STEPS`` calls on new batches, the rate at each; the rows no
       batch touched bitwise as they were in the table and every
       accumulator, no NaN; one step against the CPU (``CTR_TRAIN_TOL``,
       its untouched rows bitwise on both); the step captured against
       eager.
   G3. the MNIST MLP (784-200-200-10, batch ``MNIST_BATCH``) under
       ProximalGD and ProximalAdagrad, each with exponential_decay,
       natural_exp_decay, inverse_time_decay and polynomial_decay(cycle)
       (``G3_SCHEDULES``): the rates against their closed forms, one step
       against the CPU, the step captured against eager; append_LARS's
       rates and one step against the CPU; ModelAverage over captured
       SGD steps: apply against the mean of the updates, restore bitwise,
       the next replay against an eager step from the restored state.
   G4. control flow at width ``FLOW_WIDTH``, batch ``FLOW_BATCH``: a
       bounded While (``FLOW_TRIPS`` trips through an fc, a tensor array)
       trained, its request (the array fetched as a ``LoDTensorArray``)
       and step against the CPU; the same loop unbounded as a request,
       eager at every call (``why`` names ``while``: its condition is
       read on the host each trip), against the CPU; IfElse routing rows
       to two fc branches, trained; a Switch over a step counter setting
       SGD's rate.  Each captured block also against eager.
   No hand-written kernel lies on G2-G4 (their calls run as path F's,
   their counters 0 before and after); each block prints a ``path G:
   {...}`` line as path F's.  ``--only-flow`` runs the device phase, the
   kernels' build and path G alone and prints no result line.
H. the serving tier (``paddle_tpu_torch.serving``, ``inference``), run
   right after path G, f32:
   H0. two ``InferenceEngine``s with no registry (no dispatch gate) on one
       ``Executor``, one scope and one inference program (the MNIST MLP at
       its published width), fed from two threads with distinct requests
       of ``TWO_ENGINE_ROWS`` rows while the interpreter switches threads
       every microsecond: every response against the same request served
       alone (``TWO_ENGINE_TOL``).  The engines share one captured block;
       without the executor's lock one engine's feeds reach the other's
       replay (it failed so on the code before the lock).
   H1. Transformer-base's test program served by a started
       ``InferenceEngine`` on ``CUDAPlace(0)`` as bench.py's
       bench_transformer serves it: requests of ``SERVE_ROWS`` rows at
       lengths ``SERVE_LENGTHS``, every id feed on the explicit trailing
       ladder [256], lots of 16 rows (one bucket).  Two warm lots (the
       block's eager call and its capture), then ``SERVE_WINDOWS`` windows
       of 16 requests under torch.profiler, each lot one replay of the
       graph through ``run_eval_multi``, 18 f32 flash forwards a lot
       counted by name; lots fewer than requests; every response against
       a direct ``exe.run`` of its zero-padded request
       (``SERVE_RTOL``/``SERVE_ATOL``); then, the allocator's cache
       emptied, the engine and its executor dropped with the cyclic
       collector off: both dead at once, and ``memory_reserved`` falling
       by their graphs and pool.
   H2. ResNet-50 f32 and its path C inference form (folded, bf16) in one
       ``ModelRegistry``, batch ``REGISTRY_BATCH``: each served resident
       (eager, capture, ``REGISTRY_REPLAYS`` replays), then a budget that
       holds either model but not both; ``REGISTRY_ROUNDS`` rounds in
       which each model's first request evicts the other and reloads it,
       every response after a reload bitwise equal to the resident one of
       the same call (eager, capture, replay; cuDNN deterministic), and an
       eviction through the arbiter that lowers ``memory_allocated`` by at
       least the bytes moved.  No hand-written kernel.
   H3. the stacked LSTM's kernel form saved with ``save_inference_model``
       and served by ``create_paddle_predictor(NativeConfig(use_gpu=
       True))`` with LoD ``PaddleTensor``s of 128 rows: 3 ``lstm_fwd`` a
       request (``_Path``), an 8-row request against a CPU predictor
       (``LSTM_PRED_RTOL``).
   After H2's phase has returned, what still holds device memory: the
   allocator's counts, its largest live blocks (``memory_snapshot``), the
   CUDA tensors the collector reaches and the executors, blocks and graphs
   alive; then the counts once cuBLAS's workspaces are released.
   Each part prints a ``path H: {...}`` line (rows or images a second,
   lots and executables, trailing padding waste, p50/p99 latency, peak
   memory, the card).  ``--only-serve`` runs the device phase, the
   kernels' build and path H alone and prints no result line.
I. generation serving (``serving.decode``, the engine's decode and chunk
   lanes), run right after path H, f32, random weights from ``--seed``:
   I1. ``seq2seq.build_step_decode`` at bench_nmt's widths (``GEN_NMT``:
       dictionaries 30000, embedding and decoder 512, ``max_len`` 16)
       behind a started ``InferenceEngine`` as bench.py's decode block
       serves it: ``GEN_SLOTS`` slots, ``GEN_STEPS`` steps a dispatch,
       prompts of ``GEN_LENS`` tokens; a warm round, a timed round and a
       profiled round, at ``decode_pipeline_depth`` 1 and 2.  Every
       response against a per-request greedy loop of ``exe.run`` on the
       card (prefill, then the step program), ``GEN_CPU_REQUESTS`` against
       the port's CPU loop at the same weights, tie-aware
       (``compare_tokens``: a differing token only where that step's two
       top logits lie within ``GEN_TIE_RTOL``, the request compared no
       further); the step block runs as a graph, its replays counted.
   I2. ``transformer.build_step_decode`` at bench_transformer's widths
       (``GEN_TF``: vocab 30000, d_model = d_k = 512, ``max_ctx`` 256),
       prompts on the trailing ladder ``GEN_TF_LADDER``, as I1.
   I3. chunked against monolithic prefill as tools/perf_gate.py's
       chunked_prefill cell sets it (chunk 64, one 4096-token prompt
       landing while three short ones decode, 4 slots, K 2, ``max_len``
       24), on I1's model with a chunk program: both lanes against the
       greedy loop, tie-aware; chunk dispatches > 0, no prefill lot on
       the chunked lane; ``max_decode_stall_s`` of each.
   I4. I1's model with ``generation=`` in a ``ModelRegistry`` beside the
       MNIST MLP (saved and loaded by dirname) under a budget one byte
       short of the three accounts: the ``nmt:decode-cache`` account
       (the least recently used) is evicted, and back at the next
       generation; the tokens after the reload equal those before.
   No hand-written kernel lies on path I (the counters read 0 after it).
   Each part prints a ``path I: {...}`` line (tokens/s, decode
   dispatches, steps and tokens a dispatch, slot occupancy, host syncs a
   token, executables, the step block's captures and replays, busy and
   idle share of the profiled round, peak memory, the card).
   ``--only-generate`` runs the device phase and path I alone and prints
   no result line.
J. the input pipeline (``fluid.FeedPipeline``, ``layers.py_reader``,
   ``recordio_writer``, ``Trainer``), run right after path I:
   J1. Transformer-base at bench_transformer's widths (``J_BATCH`` x 256,
       base shape) under ``amp_guard()``, trained through
       ``FeedPipeline(source=..., steps=J_STEPS, pipeline_depth=J_DEPTH)``
       on fresh batches as bench.py's feed_overlap block feeds it: one
       warmup dispatch in a pipeline of its own, then ``J_TIMED`` timed
       ones in another, timed from a synchronize to the last delivery,
       every timed dispatch under
       ``torch.cuda.set_sync_debug_mode('error')``; ms a step overlapped,
       feed stall a dispatch, overlap ratio, host syncs (0);
       the losses and the parameters bitwise those of
       ``run_multi(feed_list=...)`` over the same batches from the same
       start; one more dispatch under torch.profiler counting 36 bf16
       flash forwards, 18 dQ and 18 dK/dV a step (``_Path``
       ``feed_pipeline`` in the kernels line).
   J2. the MNIST MLP at its published width fed by ``py_reader`` +
       ``double_buffer`` + ``read_file`` on ``CUDAPlace(0)``:
       ``run_multi(reader=, steps=J_STEPS)`` over two passes (two full
       blocks, a tail, ``EOFException``, ``reset()``/``start()``), then
       ``run_eval_multi(reader=)``, each bitwise against the feed_list
       path over the same batches.
   J3. ``Trainer.train`` for 2 epochs with ``steps_per_dispatch``
       ``J_STEPS`` and a ``CheckpointConfig``, stopped at the start of the
       second epoch and resumed by a new Trainer, bitwise against an
       uninterrupted run.
   J4. batches written by ``recordio_writer`` into recordio files, read
       back through ``open_files`` into training steps on the card,
       against the same steps fed by data layers (``J_MLP_RTOL``, printed
       whether bitwise); it prints whether the
       native library (``build/runtime/``) or the pure-Python recordio
       path ran.
   J2-J4 run no hand-written kernel.  Each part prints a ``path J:
   {...}`` line.  ``--only-pipeline`` runs the device phase, the kernels'
   build and path J alone and prints no result line.
K. the common tensor, shape, reduce, loss and metric ops (their 52
   lowerings, their layers and ``nets``' helpers), run right after path J,
   f32:
   K1. Fluid's Transformer recipe in plain layers at G1's widths
       (``OPS_TF``: 6 layers, d_model 512, 8 heads, d_ff 2048, vocab
       30000), BATCH x 256 (``ops_transformer_programs``): Q, K and V by
       ``fc(num_flatten_dims=2)``, ``nets.scaled_dot_product_attention``
       (``reshape``, ``transpose``, batched ``matmul``, ``softmax``), the
       output ``fc``, residuals under ``layer_norm``, a ReLU FFN, the vocab
       head, and ``reduce_mean`` of ``softmax_with_cross_entropy(
       soft_label=True)`` against ``label_smooth(one_hot(label), 0.1)``;
       Adam at ``OPS_LR``.  One eager call, the capture and
       ``OPS_REPLAYS`` replays on one batch (``_Path``: no hand-written
       kernel), the loss falling at every step; one 2 x 256 step against
       the CPU (``TRAIN_TOL``, G1's); layer 0's attention context against
       the ``flash_attention`` op (the f32 kernel) on its Q, K and V
       (``TOL``); one captured step under ``amp_guard()`` within
       ``AMP_SERVE_TOL['loss']`` of an f32 step from one state; the step
       captured against eager and timed (``OPS_CAPTURE_CALLS``), the
       capture's peak within ``OPS_MEMORY_RATIO`` of ``memory_analysis``'s
       temp bytes; a ``path K: {...}`` line with ms a step eager and
       captured, busy and idle share, peak memory and ``cost_report``'s
       FLOPs a step.
   K2. every lowering of the slice (``OPS_LOWERINGS``), one op at a time
       on the cases of ``ops_cases()`` (the CPU tests' cases): card
       against ``CPUPlace()`` (``OPS_TOL``, integer outputs exactly), the
       generic grad where the op is differentiable, and the op captured and
       replayed against its eager call (``CAPTURE_TOL``); the random ops by
       distribution at 10^6 draws (``OPS_DRAW_TOL``), each replay drawing
       anew; the count of lowerings checked, which must be the 52.
   K3. CTR at bench_ctr's widths, its test program with ``layers.auc`` and
       ``layers.precision_recall`` appended, on a CTR_BATCH-row request:
       the metrics on the card against the CPU, and the request timed with
       and without them (``OPS_CTR_CALLS`` replays each).
   No hand-written kernel lies on path K (its counters read 0 after each
   part; K1's flash check launches the kernel outside them).
   ``--only-ops`` runs the device phase and path K alone and prints no
   result line.
L. data parallelism on ``torch.distributed`` (``fluid.ParallelExecutor``),
   run right after path K:
   L1. Transformer-base at G1's widths, dropout 0, Adam at ``LR``:
       ``PAR_STEPS`` steps of the global batch BATCH x 256 trained by
       ``PAR_RANKS`` ranks that share the card under gloo, each a
       subprocess of this script (``--parallel-rank``) under
       ``PAR_TIMEOUT``; rank 1 starts from other weights and takes rank
       0's by ``bcast_params``; both ranks' replicas end bitwise equal
       (SHA-256 of every persistable); each rank launches 36 flash
       forwards, 18 dQ and 18 dK/dV a step; each step held against one
       ``Executor`` step from the state the ranks started it from: on the
       same global batch, the loss, the gradients and the parameters at
       G1's card-step bounds (``SLICE_RTOL``, ``GRAD_*``, each element
       within ``LR``); on each rank's half, the gradients' mean to
       ``PAR_HALVES_TOL``, and the program's update ops on that mean to
       every parameter within ``PAR_UPDATE_TOL``; each rank's step wall,
       the collectives' share of it (the device synchronized on either
       side of each), ``bcast_params``' seconds and its peak memory.
   L2. the same model through a ``ParallelExecutor`` of world size 1 on
       NCCL in this process: ``run_multi`` of ``PAR_K`` steps (the eager
       step and the capture launch the kernels through their wrappers),
       then a block of ``PAR_K`` replays under torch.profiler: one
       capture, the replays run no collective eagerly, the NCCL kernels
       and every flash kernel of the steps are on the card; the losses
       and parameters bitwise ``Executor.run_multi``'s over the same
       batches from the same state; both
       captured steps timed (``PAR_TIMED`` blocks each).
   L3. ResNet-50 (bench.py:347), Momentum at ``CV_LR``: ``PAR_RANKS``
       gloo ranks of ``PAR_CV_BATCH`` images take one step against one
       ``Executor`` step on the whole batch: the loss, the fc head's
       gradients and every batch-norm running mean and variance
       (``CV_TRAIN_TOL['resnet50']``; the synced batch statistics).
   Each part prints ``path L: {...}`` lines; the kernels line's
   ``parallel`` entries count the wrappers over L1's ranks and L2, and
   the kernels on the card in L2's profiled replays.  ``--only-parallel``
   runs the device phase, the kernels' build and path L alone and prints
   no result line.
M. the detection family, run right after path L, f32:
   M1. MobileNet-SSD (``mobilenet_ssd_programs``: PaddlePaddle models'
       fluid/object_detection/mobilenet_ssd.py at scale 1.0, 300 x 300,
       21 classes, 1917 priors), reduce_sum(ssd_loss), RMSProp at
       ``SSD_LR`` with L2Decay(``SSD_L2``), ``SSD_BATCH`` seeded images
       with 1 to ``SSD_MAX_GT`` boxes each as LoD feeds: ``SSD_STEPS``
       steps on one batch (``_Path``: the eager call, the capture and
       replays; no hand-written kernel), the loss falling; one
       ``SSD_CPU_BATCH`` step against the CPU from the same state
       (``SSD_TRAIN_TOL``); the step captured against eager and timed
       (``SSD_CAPTURE_CALLS``, cuDNN's deterministic algorithms) with busy
       and idle share, peak memory
       against ``memory_analysis`` and ``cost_report``'s FLOPs on a
       ``path M: {...}`` line.
   M2. its test program (``clone(for_test=True)``) with
       ``detection_output`` (NMS at ``SSD_NMS_THRESHOLD``) and an 11-point
       ``detection_map`` accumulating over ``SSD_EVAL_BATCHES`` batches,
       eager (host ops): each batch's host ops run again on the CPU on the
       arrays the card fed them, bitwise equal (detections, LoD, mAP,
       state); the first ``SSD_EVAL_CPU_IMAGES`` images through the test
       program on the CPU: ``locs`` and ``confs`` within
       ``CV_SERVE_RTOL``, the detections that differ counted; the host
       ops' seconds beside each batch's wall and the mAP.
   M3. the RPN stages (``rpn_programs``, ``RPN``: a stride-16 map of a
       600 x 800 image, 15 anchors a cell, 2 images): ``anchor_generator``,
       ``generate_proposals``, ``rpn_target_assign`` and
       ``generate_proposal_labels`` with ``fix_seed``, every output bitwise
       the same program's on the CPU, and the host ops' seconds.
   Each part prints ``path M: {...}`` lines; the kernels line's
   ``detect`` entries are 0.  ``--only-detect`` runs the device phase and
   path M alone and prints no result line.

It imports nothing of JAX or of the JAX package ``paddle_tpu``.
"""

import argparse
import collections
import concurrent.futures
import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings
import weakref

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


NOAM = dict(scale=2.0, warmup_steps=4000)  # 2.0 * noam_decay(d_model, 4000)
NOAM_ADAM = dict(beta1=0.9, beta2=0.98, epsilon=1e-9)


def noam_lr(step, d_model, scale=NOAM['scale'],
            warmup_steps=NOAM['warmup_steps']):
    """The closed form of ``scale * noam_decay(d_model, warmup_steps)`` at
    run ``step`` (counted from 1)."""
    return scale * d_model ** -0.5 * min(step ** -0.5,
                                         step * warmup_steps ** -1.5)


def transformer_noam_programs(fluid, transformer, src_vocab=1000,
                              trg_vocab=1000, max_len=32, n_layer=2,
                              n_head=4, d_model=64, d_ff=128, dropout=0.0,
                              scale=NOAM['scale'],
                              warmup_steps=NOAM['warmup_steps']):
    """Fluid's published Transformer recipe: the encoder-decoder of
    ``transformer.build`` (``fluid``'s package and its ``transformer``
    module's own helpers), trained by Adam at beta2 0.98 and epsilon 1e-9
    with the learning rate ``scale * noam_decay(d_model, warmup_steps)``
    (the scale through ``math_op_patch``).  Returns the programs, the feed
    names, the loss and the learning-rate var."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src, trg, lbl = (fluid.layers.data(name=n, shape=[max_len],
                                           dtype='int64')
                         for n in ('src_ids', 'trg_ids', 'lbl_ids'))
        enc = transformer._embed(src, src_vocab, d_model, max_len,
                                 'src_emb')
        for i in range(n_layer):
            attn = transformer._attention(enc, enc, d_model, n_head,
                                          causal=False,
                                          name='enc_self_%d' % i)
            enc = transformer._add_norm(enc, attn, dropout)
            enc = transformer._add_norm(
                enc, transformer._ffn(enc, d_model, d_ff), dropout)
        dec = transformer._embed(trg, trg_vocab, d_model, max_len,
                                 'trg_emb')
        for i in range(n_layer):
            attn = transformer._attention(dec, dec, d_model, n_head,
                                          causal=True,
                                          name='dec_self_%d' % i)
            dec = transformer._add_norm(dec, attn, dropout)
            cross = transformer._attention(dec, enc, d_model, n_head,
                                           causal=False,
                                           name='dec_cross_%d' % i)
            dec = transformer._add_norm(dec, cross, dropout)
            dec = transformer._add_norm(
                dec, transformer._ffn(dec, d_model, d_ff), dropout)
        logits = fluid.layers.fc(input=dec, size=trg_vocab,
                                 num_flatten_dims=2)
        cost = fluid.layers.softmax_with_cross_entropy(
            logits, fluid.layers.unsqueeze(lbl, axes=[2]))
        loss = fluid.layers.mean(cost)
        test = main.clone(for_test=True)
        lr = scale * fluid.layers.noam_decay(d_model, warmup_steps)
        fluid.optimizer.Adam(learning_rate=lr, **NOAM_ADAM).minimize(loss)
    return dict(main=main, startup=startup, test=test,
                feeds=['src_ids', 'trg_ids', 'lbl_ids'], loss=loss, lr=lr)


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


# torch.profiler loses a run of device activities at the head of a
# session on the card: none in most short sessions, hundreds in some
# sessions of a long run, varying from one to the next (a late session
# lost the head of a training step, most calls of a timed kernel, or all of
# a short call).  The activities it keeps carry right timestamps: the loss
# is a count, not a time window (``probe_profiler.py``).  So every session
# (``_profiled``) opens with a preamble of short marker kernels
# (``torch.cuda._sleep``'s spin_kernel) for the loss to take: while one of
# them is recorded, none of the session's own activities was lost.  A
# preamble half lost is doubled for the sessions after it.
PROFILER_MARKER = 'spin_kernel'
MARK_CYCLES = 100
PROFILER = {'preamble': 1024, 'lost': []}


def _is_marker(name):
    return PROFILER_MARKER in name


@contextlib.contextmanager
def _profiled():
    """One torch.profiler session of host and device activity behind its
    preamble (PROFILER): yields an object whose ``prof`` is the profiler,
    to be read after the block, and whose ``kept`` says that the loss at
    the session's head stayed inside the preamble.  The block ends its own
    work on the card (``torch.cuda.synchronize``)."""
    session = type('ProfilerSession', (), {'prof': None, 'kept': True})()
    preamble = PROFILER['preamble']
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(preamble):
            torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        yield session
    session.prof = prof
    marks = sum(e.device_type == torch.autograd.DeviceType.CUDA and
                _is_marker(e.name) for e in prof.events())
    lost = preamble - marks
    PROFILER['lost'].append(lost)
    session.kept = marks > 0
    if 2 * lost > preamble:
        PROFILER['preamble'] = 2 * preamble
        print('profiler: session %d lost %d of its %d preamble kernels; the '
              'preamble is now %d' % (len(PROFILER['lost']), lost, preamble,
                                      PROFILER['preamble']), flush=True)


def profiler_summary():
    """One line: the profiler sessions of the run and the device
    activities each lost at its head (PROFILER)."""
    lost = PROFILER['lost']
    print('profiler: %d sessions; device activities lost at a session\'s '
          'head: %s in the first, %s in the last, at most %s; preamble at '
          'the end %d kernels' %
          (len(lost), lost[0] if lost else '-', lost[-1] if lost else '-',
           max(lost) if lost else '-', PROFILER['preamble']), flush=True)


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
        if (e.device_type == torch.autograd.DeviceType.CUDA and
                not _is_marker(e.name)):
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
    (``scans``).  The profiler loses events at a session's head
    (PROFILER): a call whose session counted fewer kernels than ``want``,
    and none more, is printed and made again, five times at most over the
    path (it ran all the same: a training step's loss is kept)."""

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
            with _profiled() as session:
                t0 = time.perf_counter()
                result = fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            prof = session.prof
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
    try:
        with _profiled() as session:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        torch.func.vjp = real_vjp
    prof = session.prof
    if trace_path:
        os.makedirs(os.path.dirname(trace_path), exist_ok=True)
        prof.export_chrome_trace(trace_path)
    by_name = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, 'self_device_time_total', None)
        if dev_us is None:
            dev_us = getattr(evt, 'self_cuda_time_total', 0)
        # a range's device-side span (idle gaps included) is no kernel
        if evt.key == RECOMPUTE or _is_marker(evt.key):
            continue
        if dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.key] = by_name.get(evt.key, 0.0) + dev_us / 1e3
    # a host range's device time: the kernels its ops launched
    replay = sum(evt.device_time_total / 1e3 for evt in prof.events()
                 if evt.name == RECOMPUTE and
                 evt.device_type == torch.autograd.DeviceType.CPU)
    return {'wall_s': wall, 'busy_ms': sum(by_name.values()),
            'kept': session.kept, 'by_name': by_name, 'recompute_ms': replay,
            'top': sorted(by_name.items(), key=lambda kv: -kv[1])[:12]}


def profile_busy(fn, what, sessions=5):
    """``profile_run(fn)`` until its session records device time and
    keeps it all (PROFILER; each retake runs ``fn`` once more, and is
    printed); fails after ``sessions``."""
    for session in range(sessions):
        prof = profile_run(fn)
        if prof['busy_ms'] > 0 and prof['kept']:
            return prof
        print('%s: profiler session %d of %d recorded %s: taken again' %
              (what, session + 1, sessions, 'no device kernel' if
               prof['busy_ms'] <= 0 else 'a loss past its preamble'),
              flush=True)
    fail('%s: torch.profiler saw no device kernel in %d sessions' %
         (what, sessions))


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
CAPTURE_CALLS = 8   # timed calls of each path, eager and captured
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
        # equal arrays differ by 0 (the f64 pass below costs seconds on a
        # model's state)
        if g.size and not np.array_equal(g, w):
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
    profiler loses events at a session's head (PROFILER): a session that
    does not count ``want`` is printed and taken again, five sessions at
    most."""
    for session in range(5):
        with _profiled() as profiled:
            run()
            torch.cuda.synchronize()
        seen, device, kinds = _device_kernels(profiled.prof)
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


def phase_capture(card, tag, program, feed, fetch, state, expect, amp=False,
                  calls=CAPTURE_CALLS):
    """One path captured against eager from the same state: the eager call
    (``eager_run``) and the capture's call compared, a replay
    from the state again compared with the capture's call, the kernels of a
    replay counted on the device, and CAPTURE_CALLS calls of each path
    timed (median wall, device busy and idle share of one call under
    torch.profiler, peak memory).  ``expect``: the hand-written kernels a
    call launches, by key.  ``amp``: every call under ``amp_guard()``,
    the replay's hand-written kernels all bf16 instantiations.  ``calls``:
    the calls of each path timed."""
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
        for _ in range(calls):
            t0 = time.perf_counter()
            call(exe, scope)
            walls.append(time.perf_counter() - t0)
        prof = profile_busy(lambda: call(exe, scope),
                            '%s, the %s path' % (tag, path))
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
           calls, e['wall_min'], e['wall_max'], e['busy_ms'],
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
    bufs = {k: b._loops[b._BLOCK]['state'] for k, b in blocks.items()}
    shared = [p.name for p in model['test'].all_parameters()
              if bufs[True][p.name] is bufs[False][p.name]]
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


def compare_ctr_step(card, tag, model, feed, scope, exe, lr=CTR['lr'],
                     tol=CTR_TRAIN_TOL):
    """compare_train_step on one CTR step, then the rows that ``feed`` does
    not touch of the table and of its optimizer's row-shaped accumulators
    (Adam's moments, ...): bitwise as they were, on the card and on the
    CPU (the lazy sparse optimizers)."""
    main = model['main']
    blk = main.global_block()
    lazy = ['ctr_embedding'] + sorted(
        n for op in blk.ops if op.input('Param') == ['ctr_embedding']
        for slot, names in op.inputs.items()
        if slot not in ('Param', 'Grad', 'LearningRate')
        for n in names if tuple(blk.var(n).shape[:1]) ==
        (CTR['sparse_dim'], ))
    before = {n: scope.find_var(n).value().cpu().numpy().copy()
              for n in lazy}
    cpu_scope = compare_train_step(card, tag, '%d rows' % len(feed['dense']),
                                   main, model['loss'].name, feed, scope, exe,
                                   lr, tol)
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


# ---- path F: the book models, fed as the book chapters feed them ----
# SRL at the widths of the PaddlePaddle book's chapter 07
# (label_semantic_roles: word_dim 32, mark_dim 5, hidden 512, depth 8),
# with the dictionary sizes of the port's conll05.get_dict()
SRL = dict(word_dict_len=4000, pred_dict_len=200, mark_dict_len=2,
           label_dict_len=59, word_dim=32, mark_dim=5, hidden_dim=512,
           depth=8, lr=0.01)
SRL_BATCH = 10        # the chapter's BATCH_SIZE
BOOK_STEPS = 20       # SGD steps of each book model
SRL_SERVE = 128       # conll05.test() sentences a decode request
SRL_CHUNK_TYPES = 29  # IOB over the 59 labels: 2 x 29 tags and O
# conll05's columns, in the order the DataFeeder takes them
SRL_FEEDS = ['word_data', 'ctx_n2_data', 'ctx_n1_data', 'ctx_0_data',
             'ctx_p1_data', 'ctx_p2_data', 'verb_data', 'mark_data',
             'target']
# one SRL step, card vs CPU (compare_train_step): 8 LSTM layers, the CRF's
# log-sum-exp recursion over T = 32 and its vjp sum in another order on
# each; the updated parameters move by lr times the gradients' differences.
# Measured on an NVIDIA H100 80GB HBM3 at 700.00 W: loss rel 0, the worst
# max|dg| / max|g| 4.2e-6 (lstm_5.b_0), |dg| / |g| over all 1.7e-6,
# max|dp| 1.5e-8
SRL_TRAIN_TOL = dict(loss=1e-5, grad_rtol=1e-3, grad_atol=1e-6,
                     grad_norm=1e-4, param_max=1e-5, param_atol=1e-6,
                     param_frac=1e-3)
# a served Viterbi path may differ from the CPU's only where both paths'
# scores, taken under the CPU's emissions and transition, agree within this
# share of max(1, |score|) (measured on the same card: max|d emission|
# 1.6e-6, no path differs)
SRL_DECODE_TOL = 1e-4
REC = dict(lr=0.2)    # the recommender at its build's widths
REC_BATCH = 256
# measured on the same card: the request's |d| / |v| 9.8e-8; the step's
# loss rel 6.1e-8, the worst max|dg| / max|g| 7.1e-7, |dg| / |g| 2.9e-7
# (fit_a_line: 1.3e-7, 1.2e-7)
REC_SERVE_RTOL = 1e-5
REC_TRAIN_TOL = dict(loss=1e-5, grad_rtol=1e-3, grad_atol=1e-6,
                     grad_norm=1e-4, param_max=1e-5, param_atol=1e-6,
                     param_frac=1e-3)
FIT = dict(lr=0.01)   # fit_a_line: 13 features, SGD at its build's lr
FIT_BATCH = 20
FIT_EPOCHS = 5        # of uci_housing.train()'s 20 batches of 20: the loss
                      # of the last epoch's steps against the first's
FIT_TRAIN_TOL = REC_TRAIN_TOL
BOOK_CAPTURE_CALLS = 5  # timed calls of each path F block, eager and captured


def _book_model(module, **kwargs):
    """``module.build(**kwargs)`` with its startup run on the card from
    SEED: (model, scope, executor)."""
    import paddle_tpu_torch.fluid as fluid
    with fluid.unique_name.guard():
        model = module.build(**kwargs)
    return _started('%s %s' % (module.__name__.split('.')[-1], kwargs),
                    model)


def _started(tag, model):
    """``model``'s startup run on the card from SEED: (model, scope,
    executor)."""
    import paddle_tpu_torch.fluid as fluid
    model['startup'].random_seed = SEED
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    t0 = time.perf_counter()
    exe.run(model['startup'], scope=scope)
    torch.cuda.synchronize()
    state = [scope.find_var(v.name).value()
             for v in model['main'].list_vars() if v.persistable]
    print('model: %s, %d persistable vars of %.1f MiB, startup %.2f s' %
          (tag, len(state), _nbytes(state) / 2**20,
           time.perf_counter() - t0), flush=True)
    return model, scope, exe


def _feeder(program, names, place=None):
    """A DataFeeder over ``program``'s vars ``names``."""
    import paddle_tpu_torch.fluid as fluid
    blk = program.global_block()
    return fluid.DataFeeder([blk.var(n) for n in names],
                            place or fluid.CUDAPlace(0), program=program)


def _minibatches(reader, size, count):
    """``count`` minibatches of ``size`` samples: ``paddle_tpu_torch.batch``
    over ``reader`` (drop_last), its epochs repeated."""
    import paddle_tpu_torch
    out = []
    while len(out) < count:
        for mb in paddle_tpu_torch.batch(reader, size, drop_last=True)():
            out.append(mb)
            if len(out) == count:
                break
    return out


def _cost_per_step(exe, fetch_names):
    """``cost_report()``'s FLOPs a step of each block run with these
    fetches."""
    return sorted({e['flops_per_step'] for e in exe.cost_report()
                   if e['kind'] == 'run' and e['fetch_names'] == fetch_names})


def _book_run(tag, exe, calls, scans):
    """``calls`` (thunks, each one ``Executor.run``) under FLAGS_cost_accounting
    as one main path: the launch counters set to 0 before it and read after
    it (none may grow: no hand-written kernel lies on path F), ``scans``
    scan-path LSTM runs in each call that ran the lowerings and none in a
    replay, each call's wall on the host clock up to the card's end.
    Returns (results, walls, how each call ran)."""
    import paddle_tpu_torch.fluid as fluid
    results, walls, ran = [], [], []
    fluid.FLAGS.cost_accounting = True
    try:
        _zero_counts()  # every launch counter to 0 just before the path
        for call in calls:
            scans0 = _scan_runs()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results.append(call())
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            ran.append(exe.cached_blocks()[-1].last_ran)
            grew = _scan_runs() - scans0
            check(grew == (0 if ran[-1] == 'replay' else scans),
                  '%s: a call (%s) ran the scan path %d times, expected %d'
                  % (tag, ran[-1], grew, 0 if ran[-1] == 'replay' else
                     scans))
        counts = _wrapper_counts()  # read just after the path
    finally:
        fluid.FLAGS.cost_accounting = False
    check(counts == _expect(), '%s: hand-written kernels launched: %s' %
          (tag, counts))
    return results, walls, ran


def _book_train(card, tag, model, scope, exe, feeds, scans, window=5):
    """One SGD step of ``model['main']`` on each of ``feeds`` (DataFeeder
    outputs) through ``_book_run``; the loss falls (the mean of the last
    ``window`` steps below that of the first ``window``).  Returns (losses,
    flops a step)."""
    loss_name = model['loss'].name
    results, walls, ran = _book_run(tag + ' train', exe, [
        (lambda f=f: exe.run(model['main'], feed=f, fetch_list=[loss_name],
                             scope=scope)) for f in feeds], scans)
    losses = [float(r[0][0]) for r in results]
    check(all(np.isfinite(losses)), '%s: a loss is not finite: %s' %
          (tag, losses))
    first, last = np.mean(losses[:window]), np.mean(losses[-window:])
    check(last < first, '%s: the loss did not fall over %d steps: %s' %
          (tag, len(losses), losses))
    flops = _cost_per_step(exe, [loss_name])
    check(flops and min(flops) > 0, '%s: cost_report FLOPs %s' % (tag, flops))
    replays = [w for w, r in zip(walls, ran) if r == 'replay']
    print('%s train: %d SGD steps, each a new minibatch through the reader, '
          'batch and DataFeeder; loss %.4f -> %.4f (mean of the first %d '
          '%.4f, of the last %d %.4f); wall of the eager call '
          '%.4f s, of the capture %.4f s, median replay %.4f s; launches '
          'none; calls %s; cost_report FLOPs a step %s [%s]' %
          (tag, len(losses), losses[0], losses[-1], window, first, window,
           last, walls[ran.index('eager')],
           walls[ran.index('capture')] if 'capture' in ran else float('nan'),
           statistics.median(replays) if replays else float('nan'),
           ', '.join('%d %s' % (ran.count(r), r) for r in
                     ('eager', 'capture', 'replay') if r in ran),
           ', '.join('%.4e' % f for f in flops), card),
          flush=True)
    return losses, flops[-1]


def _book_record(card, tag, timed, flops, path='F', **extra):
    """One phase's ``path F:`` (or ``path``) line from ``phase_capture``'s
    times."""
    e, c = timed['eager'], timed['captured']
    rec = dict(path=path, phase=tag, eager_s=round(e['wall'], 5),
               captured_s=round(c['wall'], 5),
               busy_ms_eager=round(e['busy_ms'], 3),
               busy_ms_captured=round(c['busy_ms'], 3),
               idle_eager=round(e['idle'], 3), idle_captured=round(c['idle'], 3),
               peak_mib_eager=round(e['peak'] / 2**20, 1),
               peak_mib_captured=round(c['peak'] / 2**20, 1),
               temp_bytes=int(timed['memory']['temp']),
               flops_per_step=flops, card=card)
    rec.update(extra)
    print('path %s: %s' % (path, json.dumps(rec)), flush=True)
    return rec


def _viterbi_score(em, tr, path):
    """A tag path's score under emissions ``em`` [L, D] and the CRF's
    transition ``tr`` (row 0 start, row 1 end, rows 2.. [D, D]), f64."""
    em, tr = em.astype(np.float64), tr.astype(np.float64)
    return float(tr[0][path[0]] + tr[1][path[-1]] +
                 em[np.arange(len(path)), path].sum() +
                 tr[2:][path[:-1], path[1:]].sum())


def compare_viterbi(got, want, em, tr, lengths, tol):
    """Card paths ``got`` against CPU paths ``want`` ([B, T, 1]), tie-aware:
    each row's padding is 0 on both, and where the two paths differ, their
    scores under the CPU's emissions ``em`` and transition ``tr`` agree
    within ``tol`` of max(1, |score|).  Returns (rows that differ,
    positions that differ, the worst score difference so measured)."""
    rows = positions = 0
    worst = 0.0
    for i, n in enumerate(lengths):
        g, w = got[i, :, 0], want[i, :, 0]
        check(not g[n:].any() and not w[n:].any(), 'decode row %d: a '
              'padding step is not 0' % i)
        if (g[:n] == w[:n]).all():
            continue
        rows += 1
        positions += int((g[:n] != w[:n]).sum())
        sg = _viterbi_score(em[i, :n], tr, g[:n])
        sw = _viterbi_score(em[i, :n], tr, w[:n])
        d = abs(sg - sw) / max(1.0, abs(sw))
        worst = max(worst, d)
        check(d <= tol, 'decode row %d: the card\'s path scores %.6f, the '
              'CPU\'s %.6f under the CPU\'s emissions (|d| / max(1, |s|) '
              '%g > %g)' % (i, sg, sw, d, tol))
    return rows, positions, worst


def _chunk_evaluator(fluid):
    """A ChunkEvaluator program (IOB, SRL_CHUNK_TYPES chunk types) over
    inferred and gold tag sequences: (program, startup, evaluator, feed
    vars)."""
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        inf = fluid.layers.data(name='inference', shape=[1], dtype='int64',
                                lod_level=1)
        lab = fluid.layers.data(name='label', shape=[1], dtype='int64',
                                lod_level=1)
        ev = fluid.evaluator.ChunkEvaluator(
            input=inf, label=lab, chunk_scheme='IOB',
            num_chunk_types=SRL_CHUNK_TYPES)
    return prog, startup, ev, [inf, lab]


def _chunk_eval(place, records):
    """The ChunkEvaluator streamed over ``records`` ((inferred tags, gold
    tags) a sentence) in two halves on ``place``: (precision, recall and
    F1; the counts; the walls of its runs; the executor, scope, program and
    the last feed)."""
    import paddle_tpu_torch.fluid as fluid
    prog, startup, ev, feed_vars = _chunk_evaluator(fluid)
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    feeder = fluid.DataFeeder(feed_vars, place, program=prog)
    walls = []
    half = len(records) // 2
    with fluid.scope_guard(scope):
        exe.run(startup)
        for part in (records[:half], records[half:]):
            feed = feeder.feed(part)
            t0 = time.perf_counter()
            exe.run(prog, feed=feed, fetch_list=ev.metrics)
            if place.device.type == 'cuda':
                torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        prf = ev.eval(exe)
    counts = [int(scope.find_var(s.name).value().reshape(-1)[0])
              for s in ev.states]
    return prf, counts, walls, (exe, scope, prog, feed, ev)


def phase_book_srl(card):
    """F1: SRL at the chapter's widths.  BOOK_STEPS SGD steps, each on a
    new SRL_BATCH-sentence minibatch of conll05.train() (reader, batch,
    DataFeeder), eager then captured, the loss falling; one step from that
    state against the CPU (SRL_TRAIN_TOL); the step captured against eager;
    the test program decoding SRL_SERVE sentences of conll05.test() (the
    Viterbi paths fetched) against the CPU, tie-aware (SRL_DECODE_TOL), and
    captured against eager; then a ChunkEvaluator over the served paths:
    eager, through its host op, never captured, with the CPU's precision,
    recall and F1 on the same paths."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.dataset import conll05
    from paddle_tpu_torch.models import label_semantic_roles
    model, scope, exe = _book_model(label_semantic_roles, **SRL)
    lstm_ops = sum(op.type == 'lstm' for op in model['main'].global_block().ops)
    check(lstm_ops == SRL['depth'], 'SRL: %d lstm ops' % lstm_ops)
    feeder = _feeder(model['main'], SRL_FEEDS)
    batches = _minibatches(conll05.train(), SRL_BATCH, BOOK_STEPS + 1)
    feeds = [feeder.feed(mb) for mb in batches]
    # the forward's lstm ops and their grads' replays, each a scan-path run
    _, train_flops = _book_train(card, 'F1 SRL', model, scope, exe,
                                 feeds[:BOOK_STEPS], scans=2 * lstm_ops)
    loss_name = model['loss'].name
    compare_train_step(card, 'F1 SRL', '%d sentences' % SRL_BATCH,
                       model['main'], loss_name, feeds[BOOK_STEPS], scope,
                       exe, SRL['lr'], SRL_TRAIN_TOL)
    state = _persistables(model['main'], scope)
    timed = phase_capture(card, 'F1 SRL step', model['main'],
                          feeds[BOOK_STEPS], [loss_name], state, {},
                          calls=BOOK_CAPTURE_CALLS)
    _book_record(card, 'F1 SRL step', timed, train_flops,
                 batch=SRL_BATCH, widths=SRL)

    # serving: SRL_SERVE test sentences, the Viterbi paths fetched
    test = model['test']
    records = _minibatches(conll05.test(), SRL_SERVE, 1)[0]
    feed = _feeder(test, SRL_FEEDS).feed(records)
    lengths = [len(r[0]) for r in records]
    decode = model['crf_decode'].name
    crf_op, = [op for op in test.global_block().ops
               if op.type == 'crf_decoding']
    emission = crf_op.input('Emission')[0]
    [[paths]], walls, ran = _book_run('F1 SRL decode', exe, [
        lambda: exe.run(test, feed=feed, fetch_list=[decode], scope=scope)],
        scans=lstm_ops)
    decode_flops = _cost_per_step(exe, [decode])
    from paddle_tpu_torch.fluid.shape_policy import bucketed_len
    check(paths.shape == (SRL_SERVE, bucketed_len(max(lengths)), 1) and
          paths.min() >= 0 and paths.max() < SRL['label_dict_len'],
          'F1 SRL decode: paths %s in [%d, %d]' % (paths.shape, paths.min(),
                                                    paths.max()))
    cpu_scope = _cpu_copy(test, scope)
    t0 = time.perf_counter()
    want, want_em = fluid.Executor(fluid.CPUPlace()).run(
        test, feed=_feeder(test, SRL_FEEDS, fluid.CPUPlace()).feed(records),
        fetch_list=[decode, emission], scope=cpu_scope)
    cpu_s = time.perf_counter() - t0
    got, got_em = exe.run(test, feed=feed, fetch_list=[decode, emission],
                          scope=scope)
    em_err = float(np.abs(got_em - want_em).max())
    tr = cpu_scope.find_var('crfw').value().numpy()
    rows, positions, worst = compare_viterbi(got, want, want_em, tr, lengths,
                                             SRL_DECODE_TOL)
    print('F1 SRL decode: %d sentences (lengths %d-%d, T %d), one request '
          '(%s, wall %.4f s), card vs CPU tie-aware: '
          '%d rows and %d positions differ, the worst score difference '
          '%.3g (tol %g of max(1, |score|)); max|d emission| %.3g; CPU run '
          '%.2f s; cost_report FLOPs %s [%s]' %
          (SRL_SERVE, min(lengths), max(lengths), paths.shape[1], ran[0],
           walls[0], rows, positions, worst, SRL_DECODE_TOL, em_err, cpu_s,
           ', '.join('%.4e' % f for f in decode_flops), card), flush=True)
    timed = phase_capture(card, 'F1 SRL decode', test, feed, [decode],
                          _persistables(test, scope), {},
                          calls=BOOK_CAPTURE_CALLS)
    _book_record(card, 'F1 SRL decode', timed, decode_flops[-1],
                 batch=SRL_SERVE, rows_differ=rows)

    # chunk evaluation of the served paths, on the card and on the CPU
    chunks = [(list(paths[i, :n, 0]), r[8])
              for i, (n, r) in enumerate(zip(lengths, records))]
    fluid.FLAGS.cost_accounting = True
    try:
        prf, counts, walls, (cexe, cscope, cprog, cfeed, ev) = _chunk_eval(
            fluid.CUDAPlace(0), chunks)
    finally:
        fluid.FLAGS.cost_accounting = False
    chunk_flops = _cost_per_step(cexe, [m.name for m in ev.metrics])
    block = cexe.cached_blocks()[-1]
    check(block.mode == 'eager' and 'host op' in (block.refusal or '') and
          block.captures == 0 and block.calls == 2 and
          block.host_ops == ['chunk_eval'],
          'F1 chunk_eval: the block runs %s (%s), %d captures, %d calls, '
          'host ops %s' % (block.mode, block.why, block.captures,
                           block.calls, block.host_ops))
    want_prf, want_counts, cpu_walls, _ = _chunk_eval(fluid.CPUPlace(),
                                                      chunks)
    check(counts == want_counts and np.array_equal(prf, want_prf),
          'F1 chunk_eval: card %s %s, CPU %s %s' % (counts, prf, want_counts,
                                                    want_prf))
    for what, call in (('memory_analysis', lambda: cexe.memory_analysis(
            cprog, feed=cfeed, fetch_list=[], scope=cscope)),
                       ('run_multi', lambda: cexe.run_multi(
            cprog, feed=cfeed, fetch_list=[], steps=2, scope=cscope))):
        try:
            call()
            fail('F1 chunk_eval: %s ran on a host-op block' % what)
        except RuntimeError as e:
            check('host ops' in str(e), 'F1 chunk_eval: %s raised %s' %
                  (what, e))
    eager_walls = []
    with fluid.scope_guard(cscope):
        for _ in range(BOOK_CAPTURE_CALLS):
            t0 = time.perf_counter()
            cexe.run(cprog, feed=cfeed, fetch_list=ev.metrics)
            torch.cuda.synchronize()
            eager_walls.append(time.perf_counter() - t0)
        prof = profile_busy(lambda: cexe.run(cprog, feed=cfeed,
                                             fetch_list=ev.metrics),
                            'F1 chunk_eval')
    check(block.captures == 0 and block.mode == 'eager',
          'F1 chunk_eval: captured after %d calls' % block.calls)
    wall = statistics.median(eager_walls)
    rec = dict(path='F', phase='F1 chunk_eval', eager_s=round(wall, 5),
               captured_s=None, mode=block.mode, why=block.why,
               busy_ms_eager=round(prof['busy_ms'], 3),
               idle_eager=round(1 - prof['busy_ms'] / 1e3 / prof['wall_s'],
                                3),
               temp_bytes=None, flops_per_step=chunk_flops[-1],
               decode_eager_s=round(timed['eager']['wall'], 5),
               decode_captured_s=round(timed['captured']['wall'], 5),
               precision_recall_f1=[float(v) for v in prf],
               counts=counts, card=card)
    print('F1 chunk_eval: ChunkEvaluator (IOB, %d chunk types) over the %d '
          'served paths in two halves, eagerly through its host op (%s), '
          'never captured; precision %.4f, recall %.4f, F1 %.4f, counts '
          '(inferred, gold, correct) %s, equal to the CPU\'s on the same '
          'paths; the host-op block %.4f s a call (median of %d) beside the '
          'decode it follows, eager %.4f s, captured %.4f s; '
          'memory_analysis and run_multi raise on it, by design [%s]' %
          (SRL_CHUNK_TYPES, SRL_SERVE, block.why, prf[0], prf[1], prf[2],
           counts, wall, len(eager_walls), timed['eager']['wall'],
           timed['captured']['wall'], card), flush=True)
    print('path F: %s' % json.dumps(rec), flush=True)
    del model, scope, exe, cexe, cscope
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_book_recommender(card):
    """F2: the recommender at its build's widths on movielens: BOOK_STEPS
    SGD steps of REC_BATCH ratings (reader, batch, DataFeeder; two LoD
    inputs of different LoD), eager then captured, the loss falling; one
    step against the CPU (REC_TRAIN_TOL); the step captured against eager;
    ``prediction`` served on REC_BATCH test ratings against the CPU
    (REC_SERVE_RTOL) and captured against eager."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.dataset import movielens
    from paddle_tpu_torch.models import recommender
    model, scope, exe = _book_model(recommender, **REC)
    names = model['feeds']
    feeder = _feeder(model['main'], names)
    feeds = [feeder.feed(mb) for mb in _minibatches(
        movielens.train(), REC_BATCH, BOOK_STEPS + 1)]
    lods = [feeds[0][n].lod() for n in ('category_id', 'movie_title')]
    check(all(lods) and lods[0] != lods[1], 'F2: category_id and '
          'movie_title LoD %s' % lods)
    _, train_flops = _book_train(card, 'F2 recommender', model, scope, exe,
                                 feeds[:BOOK_STEPS], scans=0)
    loss_name = model['loss'].name
    compare_train_step(card, 'F2 recommender', '%d ratings' % REC_BATCH,
                       model['main'], loss_name, feeds[BOOK_STEPS], scope,
                       exe, REC['lr'], REC_TRAIN_TOL)
    timed = phase_capture(card, 'F2 recommender step', model['main'],
                          feeds[BOOK_STEPS], [loss_name],
                          _persistables(model['main'], scope), {},
                          calls=BOOK_CAPTURE_CALLS)
    _book_record(card, 'F2 recommender step', timed, train_flops,
                 batch=REC_BATCH)
    test, pred = model['test'], model['prediction'].name
    records = _minibatches(movielens.test(), REC_BATCH, 1)[0]
    feed = _feeder(test, names).feed(records)
    [[got]], walls, ran = _book_run('F2 recommender serve', exe, [
        lambda: exe.run(test, feed=feed, fetch_list=[pred], scope=scope)],
        scans=0)
    serve_flops = _cost_per_step(exe, [pred])
    want, = fluid.Executor(fluid.CPUPlace()).run(
        test, feed=_feeder(test, names, fluid.CPUPlace()).feed(records),
        fetch_list=[pred], scope=_cpu_copy(test, scope))
    err = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    check(got.shape == (REC_BATCH, 1) and np.isfinite(got).all() and
          err <= REC_SERVE_RTOL, 'F2 recommender serve: card vs CPU |d| / '
          '|v| %g (tol %g), shape %s' % (err, REC_SERVE_RTOL, got.shape))
    print('F2 recommender serve: %d ratings (%s, wall %.4f s), '
          'prediction in [%.3f, %.3f], card vs CPU |d| / '
          '|v| %.3g (tol %g) [%s]' %
          (REC_BATCH, ran[0], walls[0], got.min(), got.max(), err,
           REC_SERVE_RTOL, card), flush=True)
    timed = phase_capture(card, 'F2 recommender serve', test, feed, [pred],
                          _persistables(test, scope), {},
                          calls=BOOK_CAPTURE_CALLS)
    _book_record(card, 'F2 recommender serve', timed, serve_flops[-1],
                 batch=REC_BATCH)
    del model, scope, exe
    torch.cuda.empty_cache()


def phase_book_fit_a_line(card):
    """F3: fit_a_line (13 features, SGD) on uci_housing: FIT_EPOCHS epochs
    of FIT_BATCH-row steps (reader, batch, DataFeeder), eager then
    captured, the last epoch's loss below the first's; one step against the CPU; the step captured against
    eager; then ``save_inference_model`` -> ``load_inference_model``, the
    loaded program's prediction equal to the test program's."""
    import tempfile
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.dataset import uci_housing
    from paddle_tpu_torch.models import fit_a_line
    model, scope, exe = _book_model(fit_a_line, **FIT)
    feeder = _feeder(model['main'], ['x', 'y'])
    epoch = 404 // FIT_BATCH
    feeds = [feeder.feed(mb) for mb in _minibatches(
        uci_housing.train(), FIT_BATCH, FIT_EPOCHS * epoch + 1)]
    _, flops = _book_train(card, 'F3 fit_a_line', model, scope, exe,
                           feeds[:-1], scans=0, window=epoch)
    loss_name = model['loss'].name
    compare_train_step(card, 'F3 fit_a_line', '%d rows' % FIT_BATCH,
                       model['main'], loss_name, feeds[-1], scope,
                       exe, FIT['lr'], FIT_TRAIN_TOL)
    timed = phase_capture(card, 'F3 fit_a_line step', model['main'],
                          feeds[-1], [loss_name],
                          _persistables(model['main'], scope), {},
                          calls=BOOK_CAPTURE_CALLS)
    _book_record(card, 'F3 fit_a_line step', timed, flops, batch=FIT_BATCH)
    records = _minibatches(uci_housing.test(), FIT_BATCH, 1)[0]
    feed = _feeder(model['test'], ['x', 'y']).feed(records)
    with tempfile.TemporaryDirectory() as d, fluid.scope_guard(scope):
        fluid.io.save_inference_model(d, ['x'], [model['prediction']], exe,
                                      main_program=model['main'])
        prog, feed_names, fetch_targets = fluid.io.load_inference_model(d,
                                                                         exe)
        want, = exe.run(model['test'], feed=feed,
                        fetch_list=[model['prediction']])
        got, = exe.run(prog, feed={feed_names[0]: feed['x']},
                       fetch_list=fetch_targets)
    check(got.shape == want.shape == (FIT_BATCH, 1) and
          np.allclose(got, want, rtol=1e-5, atol=1e-6),
          'F3 fit_a_line: the loaded inference model predicts %s, the test '
          'program %s' % (got.ravel()[:4], want.ravel()[:4]))
    print('F3 fit_a_line: save_inference_model -> load_inference_model: '
          'the loaded program\'s %d predictions within rtol 1e-5, atol 1e-6 '
          'of the test program\'s (max|d| %.3g) [%s]' %
          (FIT_BATCH, float(np.abs(got - want).max()), card), flush=True)
    del model, scope, exe
    torch.cuda.empty_cache()


def phase_book(card):
    """Path F: the three book models the port runs since the book slice."""
    phase_book_srl(card)
    phase_book_recommender(card)
    phase_book_fit_a_line(card)


# ----------------------------------------------------------------------------
# path G: control flow, tensor arrays, learning-rate schedules and the
# optimizers the port took on in its control-flow slice
# ----------------------------------------------------------------------------
FLOW_REPLAYS = 10        # G1's replays after the eager call and the capture
FLOW_CAPTURE_CALLS = 5   # timed calls of each path G block, eager and captured
FLOW_STEPS = 6           # G2-G4's main paths: eager, capture, 4 replays
G3_STEPS = 8
# G2's piecewise_decay: the ImageNet recipe's boundaries (epochs 30, 60, 90,
# a tenth each) cut to steps 2 and 4, so that the replays cross both
CTR_PIECEWISE = dict(boundaries=[2, 4], factors=(1.0, 0.1, 0.01))
# G2: each optimizer with a sparse form (row subset or lazy_apply) at its
# defaults, its base rate, and the most one step can move an element, in
# rates (param_max is twice it: a gradient of rounding noise may take
# either sign on each side): Adagrad lr; RMSProp and DecayedAdagrad lr /
# sqrt(1 - 0.95); Ftrl at l1 = l2 = 0 lr (a row's first step is
# p - lr sign(g)); Adamax lr / (1 - beta1^t), under 2 lr from t = 7;
# Adadelta takes no rate, and moves an element by at most
# sqrt(epsilon / (1 - rho)) (None below)
G2_OPTIMIZERS = {
    'adagrad': ('Adagrad', 0.01, 1.0),
    'rmsprop': ('RMSProp', 1e-3, (1 - 0.95) ** -0.5),
    'ftrl': ('Ftrl', 0.01, 1.0),
    'adadelta': ('Adadelta', 1.0, None),
    'adamax': ('Adamax', 1e-3, 2.0),
    'decayed_adagrad': ('DecayedAdagrad', 0.01, (1 - 0.95) ** -0.5),
}
ROW_SUBSET = ('adagrad', 'rmsprop', 'ftrl', 'adadelta')
# G2's step against the CPU leaves out the batch's rows at which a ReLU
# input lies on the other side of 0 on the card than on the CPU from the
# same state (``relu_ties``): f32 sums of 1677 terms differ by ~1e-6
# between cuBLAS and the CPU, and a unit that one side zeroes moves that
# row's gradient by the unit's whole share, in the table's sparse
# gradient (a row a looked-up id) and in the first fc's (a sum over the
# batch).  The other rows are held to CTR_TRAIN_TOL.  Measured on one
# H100 (the first path G calls, NVIDIA H100 80GB HBM3, 700.00 W): after
# six Adadelta steps the whole batch's table gradient differed by max|dg|
# 1.26e-6 of max|g| 1.14e-4 and fc_0.w_0's by 4.9e-5 of 0.0147, where the
# other optimizers' steps held at 1e-6 of max|g| and below.
# G3: the MNIST MLP's optimizers, each with its base rate (ProximalAdagrad
# at 0.1 drove the batch's loss to 1.7e-4 in 8 steps, where the softmax's
# p -> 1 leaves the f32 loss a few ulps of 1 wide: card and CPU 4.4e-5
# apart, measured on one H100), and the schedules (decay_steps 3, so that the
# replays move the rate), each with its closed form at base rate lr and
# counter value s
G3_OPTIMIZERS = {'ProximalGD': 0.1, 'ProximalAdagrad': 0.01}
G3_SCHEDULES = {
    'exponential_decay': (dict(decay_steps=3, decay_rate=0.5),
                          lambda lr, s: lr * 0.5 ** (s / 3)),
    'natural_exp_decay': (dict(decay_steps=3, decay_rate=0.5),
                          lambda lr, s: lr * math.exp(-0.5 * s / 3)),
    'inverse_time_decay': (dict(decay_steps=3, decay_rate=0.5),
                           lambda lr, s: lr / (1 + 0.5 * s / 3)),
    'polynomial_decay': (dict(decay_steps=3, cycle=True),
                         lambda lr, s: (lr - 1e-4) * (1 - s / (3 * max(
                             math.ceil(s / 3), 1))) + 1e-4),
}
G3_LR = G3_OPTIMIZERS['ProximalGD']  # append_LARS's and ModelAverage's SGD
LR_RTOL = 1e-6  # a fetched rate against its closed form (f64)
LARS = dict(lr=0.1, weight_decay=5e-4)
LARS_RTOL = 1e-4  # the card's LARS rates against the CPU's (norms of sums)
MA = dict(average_window_rate=10.0, min_average_window=1,
          max_average_window=100)
MA_RTOL = 1e-5  # the applied parameters against the mean of the snapshots
FLOW_WIDTH, FLOW_BATCH, FLOW_TRIPS = 512, 128, 16
FLOW_LR = 0.01
FLOW_SWITCH = dict(boundaries=(2.0, 4.0), values=(0.1, 0.05, 0.01))
# card vs CPU for the G3 and G4 blocks: f32 sums in another order, as
# MNIST's (CV_TRAIN_TOL['mnist']), param_max set by each block's rate
FLOW_TRAIN_TOL = dict(loss=1e-5, grad_rtol=1e-3, grad_atol=1e-6,
                      grad_norm=1e-3, param_atol=1e-6, param_frac=1e-3)
FLOW_SERVE_RTOL = 1e-4  # a forward's fetches card vs CPU, ratio of 2-norms


def _free():
    """Free what a dropped model held on the card.  A dropped executor
    frees its blocks and graphs at once (its cache's finalizers hold it
    weakly; path H checks it); a program is a reference cycle (its blocks
    point back at it), which Python's cyclic collector frees, with what
    the program holds."""
    gc.collect()
    torch.cuda.empty_cache()
    print('memory: freed; %.1f MiB allocated, %.1f MiB reserved' %
          (torch.cuda.memory_allocated() / 2**20,
           torch.cuda.memory_reserved() / 2**20), flush=True)


def _counter(scope, name):
    return int(scope.find_var(name).value().reshape(-1)[0])


def _check_rates(tag, rates, closed, start=0):
    """Each fetched rate against ``closed(counter)``, the counter ``start``
    at the first."""
    worst = 0.0
    for i, got in enumerate(rates):
        want = closed(start + i)
        err = abs(got - want) / abs(want)
        check(err <= LR_RTOL, '%s: the rate at step %d is %.9g, its closed '
              'form %.9g (rel %g, tol %g)' % (tag, start + i, got, want, err,
                                              LR_RTOL))
        worst = max(worst, err)
    return worst


def relu_ties(program, feed, scope, exe):
    """[B] bool: the rows of ``feed`` at which an input of one of
    ``program``'s relu ops has another sign on the card than on the CPU,
    from the card's state."""
    import paddle_tpu_torch.fluid as fluid
    names = [op.input('X')[0] for op in program.global_block().ops
             if op.type == 'relu']
    got = exe.run(program, feed=feed, fetch_list=names, scope=scope)
    want = fluid.Executor(fluid.CPUPlace()).run(
        program, feed=feed, fetch_list=names,
        scope=_cpu_copy(program, scope))
    rows = len(next(iter(feed.values())))
    tied = np.zeros(rows, bool)
    for g, w in zip(got, want):
        tied |= ((g > 0) != (w > 0)).reshape(rows, -1).any(axis=1)
    return tied


def compare_fetches(card, tag, program, feed, fetch, scope, exe, rtol):
    """One run of ``program`` on the card and on the CPU from the card's
    state: each fetch (a tensor array as its stacked elements) within
    ``rtol`` (ratio of 2-norms).  Returns the card's fetches."""
    import paddle_tpu_torch.fluid as fluid
    cpu_scope = _cpu_copy(program, scope)
    got = exe.run(program, feed=feed, fetch_list=fetch, scope=scope)
    want = fluid.Executor(fluid.CPUPlace()).run(program, feed=feed,
                                                fetch_list=fetch,
                                                scope=cpu_scope)
    worst = 0.0
    for name, g, w in zip(fetch, got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        err = float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
        check(g.shape == w.shape and np.isfinite(g).all() and err <= rtol,
              '%s: card vs CPU, %s shape %s / %s, |d| / |v| %g (tol %g)' %
              (tag, name, g.shape, w.shape, err, rtol))
        worst = max(worst, err)
    print('%s: card vs CPU, %d fetches from the same state within |d| / |v| '
          '%.3g (tol %g) [%s]' % (tag, len(fetch), worst, rtol, card),
          flush=True)
    return got


def phase_flow_transformer(card):
    """G1: Transformer-base at full width trained by Fluid's recipe, Adam
    (beta2 0.98, epsilon 1e-9) under 2 * noam_decay(512, 4000): one eager
    call, the capture and FLOW_REPLAYS replays of BATCH x 256, every call
    counting 36 flash forwards, 18 dQ and 18 dK/dV on the card; the rate
    fetched at every step against noam's closed form; the step counter
    advanced by every call, replays included; one 2 x 256 step against the
    CPU (TRAIN_TOL); the step captured against eager."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import transformer
    cfg = TRANSFORMER_BASE
    tag = 'G1 Transformer-base noam'
    with fluid.unique_name.guard():
        model = transformer_noam_programs(fluid, transformer, **cfg)
    model, scope, exe = _started(tag + ' ' + str(cfg), model)
    main, loss = model['main'], model['loss'].name
    counter = '@LR_DECAY_COUNTER@'
    seq, vocab, d_model = cfg['max_len'], cfg['trg_vocab'], cfg['d_model']
    rng = np.random.RandomState(SEED + 30)
    feeds = [{n: rng.randint(1, vocab, size=(BATCH, seq)).astype('int64')
              for n in model['feeds']} for _ in range(2 + FLOW_REPLAYS)]
    n_flash = 3 * cfg['n_layer']
    per_step = _expect(fwd=2 * n_flash, dq=n_flash, dkv=n_flash)
    fetch = [loss, model['lr'].name]
    made = []
    path = _Path(tag, exe, 'f32').begin()
    fluid.FLAGS.cost_accounting = True
    try:
        for feed in feeds:
            made += path.call(lambda: exe.run(main, feed=feed,
                                              fetch_list=fetch, scope=scope),
                              per_step)
    finally:
        fluid.FLAGS.cost_accounting = False
    path.end()
    block = exe.cached_blocks()[-1]
    ran = [m[3] for m in made]
    check(block.mode == 'graph' and block.captures == 1 and
          ran.count('replay') >= FLOW_REPLAYS,
          '%s: the block ran %s (%s), %d captures, calls %s' %
          (tag, block.mode, block.why, block.captures, ran))
    losses = [float(m[0][0][0]) for m in made]
    rates = [float(m[0][1][0]) for m in made]
    check(np.isfinite(losses).all(), '%s: losses %s' % (tag, losses))
    worst = _check_rates(tag, rates, lambda s: noam_lr(s, d_model), start=1)
    runs = _counter(scope, counter)
    check(runs == len(made), '%s: the step counter reads %d after %d calls '
          '(the eager call, the capture and the replays)' % (tag, runs,
                                                             len(made)))
    flops = _cost_per_step(exe, fetch)
    check(flops and min(flops) > 0, '%s: cost_report FLOPs %s' % (tag, flops))
    walls = [m[1] for m in made if m[3] == 'replay']
    print('%s: %d Adam steps (beta2 0.98, epsilon 1e-9), loss %.6f -> %.6f; '
          'rate 2 * noam_decay(%d, %d) from %.6g to %.6g, every step within '
          '%.2g of its closed form (tol %g); the step counter %d = the calls '
          '(%d replays); launches %s (%s a step); median replay wall %.4f s '
          'under torch.profiler; cost_report FLOPs a step %.4e [%s]' %
          (tag, len(made), losses[0], losses[-1], d_model,
           NOAM['warmup_steps'], rates[0], rates[-1], worst, LR_RTOL, runs,
           ran.count('replay'), path.summary(),
           {k: v for k, v in per_step.items() if v},
           statistics.median(walls), flops[-1], card), flush=True)
    small = {n: rng.randint(1, vocab, size=(2, seq)).astype('int64')
             for n in model['feeds']}
    compare_train_step(card, tag, '2 x %d' % seq, main, loss, small, scope,
                       exe, noam_lr(runs + 1, d_model))
    timed = phase_capture(card, tag + ' step', main, feeds[0], [loss],
                          _persistables(main, scope),
                          dict(fwd=2 * n_flash, dq=n_flash, dkv=n_flash),
                          calls=FLOW_CAPTURE_CALLS)
    _book_record(card, tag + ' step', timed, flops[-1], path='G',
                 batch=BATCH, replays=ran.count('replay'),
                 launches={k: v for k, v in per_step.items() if v})
    del model, scope, exe
    torch.cuda.empty_cache()


class _Scheduled(object):
    """An optimizer whose rate is a schedule: ``minimize``, called inside
    the model's program_guard, builds ``lr = make_lr()`` there and then
    ``make_opt(lr)``'s update ops (``models.ctr.build`` takes an optimizer
    object)."""

    def __init__(self, make_lr, make_opt):
        self.make_lr, self.make_opt = make_lr, make_opt
        self.lr = None

    def minimize(self, loss, **kwargs):
        self.lr = self.make_lr()
        return self.make_opt(self.lr).minimize(loss, **kwargs)


def _piecewise(base):
    return [base * f for f in CTR_PIECEWISE['factors']]


def _piecewise_at(base, step):
    values = _piecewise(base)
    for b, v in zip(CTR_PIECEWISE['boundaries'], values):
        if step < b:
            return v
    return values[-1]


def phase_flow_ctr(card):
    """G2: CTR at bench_ctr's widths (1,000,000 x 64, batch 1024, sparse)
    with each optimizer that has a sparse form, its rate from
    piecewise_decay (CTR_PIECEWISE), one after another, each one's state
    freed before the next: the eager call, the capture and 4 replays on new
    batches, the rate against the piecewise values at every step; the rows
    of the table and of every accumulator that no batch touched bitwise as
    they were, no NaN anywhere; one step against the CPU (CTR_TRAIN_TOL,
    param_max twice the optimizer's largest move of an element), its
    untouched rows bitwise on both; the step captured against eager."""
    rng = np.random.RandomState(SEED + 31)
    for name, (cls, base, step_max) in G2_OPTIMIZERS.items():
        _flow_ctr(card, rng, name, cls, base, step_max)
        _free()


def _flow_ctr(card, rng, name, cls, base, step_max):
    """One optimizer of G2 (``phase_flow_ctr``)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import ctr
    tag = 'G2 CTR %s' % name
    sched = _Scheduled(
        lambda: fluid.layers.piecewise_decay(
            CTR_PIECEWISE['boundaries'], _piecewise(base)),
        lambda lr: getattr(fluid.optimizer, cls)(learning_rate=lr))
    with fluid.unique_name.guard():
        model = ctr.build(is_sparse=True, is_distributed=True,
                          optimizer=sched, **CTR)
    model, scope, exe = _started(
        '%s (%s, %s)' % (tag, 'row subset' if name in ROW_SUBSET else
                         'lazy_apply', CTR_PIECEWISE), model)
    main, loss = model['main'], model['loss'].name
    height = CTR['sparse_dim']
    lazy = [v.name for v in main.list_vars() if v.persistable and
            tuple(scope.find_var(v.name).value().shape[:1]) == (height, )]
    check(len(lazy) >= 2, '%s: the table and its accumulators %s' %
          (tag, lazy))
    before = {n: scope.find_var(n).value().clone() for n in lazy}
    feeds = [ctr_batch(rng) for _ in range(FLOW_STEPS)]
    fetch = [loss, sched.lr.name]
    results, walls, ran = _book_run(tag + ' train', exe, [
        (lambda f=f: exe.run(main, feed=f, fetch_list=fetch,
                             scope=scope)) for f in feeds], scans=0)
    block = exe.cached_blocks()[-1]
    check(block.mode == 'graph' and ran.count('replay') == FLOW_STEPS - 2,
          '%s: calls %s, the block %s (%s)' % (tag, ran, block.mode,
                                               block.why))
    rates = [float(r[1][0]) for r in results]
    for i, rate in enumerate(rates):
        check(rate == np.float32(_piecewise_at(base, i)),
              '%s: the rate at step %d is %r, piecewise_decay %r' %
              (tag, i, rate, _piecewise_at(base, i)))
    losses = [float(r[0][0]) for r in results]
    check(np.isfinite(losses).all(), '%s: losses %s' % (tag, losses))
    touched = torch.zeros(height, dtype=torch.bool, device='cuda')
    for f in feeds:
        touched[torch.as_tensor(np.unique(f['sparse_ids']),
                                device='cuda')] = True
    for n in lazy:
        after = scope.find_var(n).value()
        check(bool(torch.isfinite(after).all()), '%s: %s holds a NaN or '
              'an Inf' % (tag, n))
        check(torch.equal(after[~touched], before[n][~touched]),
              '%s: rows of %s that no batch touched moved' % (tag, n))
    moved = (scope.find_var('ctr_embedding').value() !=
             before['ctr_embedding']).any(dim=1)
    check(bool(moved[touched].float().mean() > 0.99),
          '%s: only %d of %d touched rows of the table moved' %
          (tag, int(moved[touched].sum()), int(touched.sum())))
    del before
    flops = _cost_per_step(exe, fetch)
    print('%s: %d steps (%s), loss %.6f -> %.6f, rates %s (piecewise '
          'boundaries %s); %d of %d rows touched; the untouched rows of '
          '%s bitwise as they were, no NaN; median replay wall %.5f s; '
          'cost_report FLOPs a step %.4e [%s]' %
          (tag, len(losses), ', '.join('%d %s' % (ran.count(r), r) for r
                                       in ('eager', 'capture', 'replay')),
           losses[0], losses[-1], rates, CTR_PIECEWISE['boundaries'],
           int(touched.sum()), height, ', '.join(lazy),
           statistics.median(w for w, r in zip(walls, ran)
                             if r == 'replay'), flops[-1], card),
          flush=True)
    # the rate of the next step
    lr_now = _piecewise_at(base, _counter(scope, '@LR_DECAY_COUNTER@') + 1)
    move = 2 * (step_max * lr_now if step_max is not None else
                (1e-6 / (1 - 0.95)) ** 0.5)
    feed = ctr_batch(rng)
    tied = relu_ties(model['test'], feed, scope, exe)
    print('%s: %d of %d rows have a ReLU input on the other side of 0 '
          'on the card than on the CPU; the step against the CPU '
          'leaves them out [%s]' % (tag, tied.sum(), len(tied), card),
          flush=True)
    compare_ctr_step(card, tag, model,
                     {k: v[~tied] for k, v in feed.items()}, scope, exe,
                     lr=lr_now, tol=dict(CTR_TRAIN_TOL, param_max=move))
    timed = phase_capture(card, tag + ' step', main, feeds[0], [loss],
                          _persistables(main, scope), {},
                          calls=FLOW_CAPTURE_CALLS)
    _book_record(card, tag + ' step', timed, flops[-1], path='G',
                 batch=CTR_BATCH, sparse='row subset'
                 if name in ROW_SUBSET else 'lazy_apply')


def _mlp(fluid, make_opt, make_lr=None):
    """The MNIST MLP (784-200-200-10, tanh, softmax), trained by
    ``make_opt(lr)`` with ``lr = make_lr()`` (a schedule) or G3_LR."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data('img', shape=[784])
        label = fluid.layers.data('label', shape=[1], dtype='int64')
        h = fluid.layers.fc(img, size=200, act='tanh')
        h = fluid.layers.fc(h, size=200, act='tanh')
        pred = fluid.layers.fc(h, size=10, act='softmax')
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        test = main.clone(for_test=True)
        lr = make_lr() if make_lr is not None else None
        opt = make_opt(lr if lr is not None else G3_LR)
        if opt is not None:
            opt.minimize(loss)
    return dict(main=main, startup=startup, test=test, loss=loss, lr=lr,
                prediction=pred)


def _mnist_batch(rng):
    return {'img': rng.uniform(-1, 1, (MNIST_BATCH, 784)).astype('float32'),
            'label': rng.randint(0, 10, (MNIST_BATCH, 1)).astype('int64')}


def _flow_train(card, tag, model, scope, exe, feed, fetch, steps):
    """``steps`` calls of the training program on one batch through
    ``_book_run`` (no hand-written kernel; the eager call, the capture,
    replays): the block captured, the loss falling.  Returns (fetches of
    each call, FLOPs a step)."""
    main = model['main']
    results, walls, ran = _book_run(tag + ' train', exe, [
        lambda: exe.run(main, feed=feed, fetch_list=fetch, scope=scope)] *
        steps, scans=0)
    block = exe.cached_blocks()[-1]
    check(block.mode == 'graph' and block.captures == 1 and
          ran.count('replay') == steps - 2, '%s: calls %s, the block %s (%s)'
          % (tag, ran, block.mode, block.why))
    losses = [float(r[0][0]) for r in results]
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          '%s: the loss did not fall: %s' % (tag, losses))
    flops = _cost_per_step(exe, fetch)
    print('%s: %d steps on one batch (%s), loss %.6f -> %.6f; median replay '
          'wall %.5f s; cost_report FLOPs a step %.4e [%s]' %
          (tag, steps, ', '.join('%d %s' % (ran.count(r), r) for r in
                                 ('eager', 'capture', 'replay')),
           losses[0], losses[-1],
           statistics.median(w for w, r in zip(walls, ran) if r == 'replay'),
           flops[-1], card), flush=True)
    return results, flops[-1]


def phase_flow_mlp(card):
    """G3: the MNIST MLP at its published widths, batch MNIST_BATCH:
    ProximalGD and ProximalAdagrad under each of exponential_decay,
    natural_exp_decay, inverse_time_decay and polynomial_decay(cycle=True)
    (G3_SCHEDULES), G3_STEPS calls each (eager, capture, replays), each
    rate against its closed form, one step against the CPU, the step
    captured against eager; append_LARS once against the CPU; ModelAverage
    over a captured SGD run: apply against the mean of the updated
    parameters, restore bitwise to the parameters before apply, and the
    next replayed step against an eager step from the same state."""
    rng = np.random.RandomState(SEED + 32)
    feed = _mnist_batch(rng)
    for cls, base in G3_OPTIMIZERS.items():
        for sched, (kwargs, form) in G3_SCHEDULES.items():
            _flow_mlp(card, feed, cls, base, sched, kwargs, form)
            _free()
    phase_flow_lars(card, feed)
    _free()
    phase_flow_model_average(card, feed)


def _flow_mlp(card, feed, cls, base, sched, kwargs, form):
    """One optimizer and schedule of G3 (``phase_flow_mlp``)."""
    import paddle_tpu_torch.fluid as fluid
    tag = 'G3 MLP %s %s' % (cls, sched)
    closed = lambda s: form(base, s)
    with fluid.unique_name.guard():
        model = _mlp(fluid, lambda lr: getattr(fluid.optimizer, cls)(
            learning_rate=lr, l1=1e-4, l2=1e-4),
            lambda: getattr(fluid.layers, sched)(base, **kwargs))
    model, scope, exe = _started(tag, model)
    fetch = [model['loss'].name, model['lr'].name]
    results, flops = _flow_train(card, tag, model, scope, exe, feed,
                                 fetch, G3_STEPS)
    worst = _check_rates(tag, [float(r[1][0]) for r in results],
                         closed)
    print('%s: %d rates within %.2g of the closed form (tol %g) '
          '[%s]' % (tag, len(results), worst, LR_RTOL, card),
          flush=True)
    lr = closed(_counter(scope, '@LR_DECAY_COUNTER@') + 1)
    compare_train_step(card, tag, '%d images' % MNIST_BATCH,
                       model['main'], model['loss'].name, feed,
                       scope, exe, lr,
                       dict(FLOW_TRAIN_TOL, param_max=2 * lr))
    timed = phase_capture(card, tag + ' step', model['main'], feed,
                          [model['loss'].name],
                          _persistables(model['main'], scope), {},
                          calls=FLOW_CAPTURE_CALLS)
    _book_record(card, tag + ' step', timed, flops, path='G',
                 batch=MNIST_BATCH)


def phase_flow_lars(card, feed):
    """append_LARS on the MLP: each parameter's rate LARS['lr'] |p| /
    (|g| + weight_decay |p|), an sgd op a parameter driven by it; one step
    on the card and on the CPU from one state, the rates within
    LARS_RTOL, then compare_train_step."""
    import paddle_tpu_torch.fluid as fluid
    tag = 'G3 MLP append_LARS'
    with fluid.unique_name.guard():
        model = _mlp(fluid, lambda lr: None)
        main = model['main']
        with fluid.program_guard(main, model['startup']):
            params_grads = fluid.backward.append_backward(model['loss'])
            fluid.layers.append_LARS(params_grads, LARS['lr'],
                                     LARS['weight_decay'])
            rates = []
            for p, g in params_grads:
                rate = p.optimize_attr['learning_rate']
                rates.append(rate.name)
                main.global_block().append_op(
                    type='sgd', inputs={'Param': [p], 'Grad': [g],
                                        'LearningRate': [rate]},
                    outputs={'ParamOut': [p]})
    model, scope, exe = _started(tag, model)
    got = compare_fetches(card, tag, main, feed, rates, scope, exe,
                          LARS_RTOL)
    top = max(float(r[0]) for r in got)
    compare_train_step(card, tag, '%d images' % MNIST_BATCH, main,
                       model['loss'].name, feed, scope, exe, top,
                       dict(FLOW_TRAIN_TOL, param_max=top))
    print('%s: %d parameter rates from %.4g to %.4g [%s]' %
          (tag, len(got), min(float(r[0]) for r in got), top, card),
          flush=True)


def phase_flow_model_average(card, feed):
    """ModelAverage (MA) after SGD on the MLP: G3_STEPS captured calls, the
    parameters after each kept; ``apply`` (its program through the same
    executor) against their mean (MA_RTOL), ``restore`` bitwise to the
    parameters before apply; then a replay of the training block from the
    restored state against an eager step from the same state."""
    import paddle_tpu_torch.fluid as fluid
    tag = 'G3 MLP ModelAverage'
    with fluid.unique_name.guard():
        model = _mlp(fluid, lambda lr: fluid.optimizer.SGD(learning_rate=lr))
        with fluid.program_guard(model['main'], model['startup']):
            ma = fluid.optimizer.ModelAverage(**MA)
    model, scope, exe = _started(tag, model)
    main, loss = model['main'], model['loss'].name
    params = [p.name for p in main.all_parameters()]
    snapshots = []

    def step():
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        snapshots.append([scope.find_var(n).value().cpu().numpy().copy()
                          for n in params])
        return out

    _book_run(tag + ' train', exe, [step] * G3_STEPS, scans=0)
    block = exe.cached_blocks()[-1]
    check(block.captures == 1 and block.last_ran == 'replay',
          '%s: the training block %s, %d captures' % (tag, block.last_ran,
                                                       block.captures))
    value = lambda: [scope.find_var(n).value().cpu().numpy().copy()
                     for n in params]
    live = value()
    with fluid.scope_guard(scope):
        with ma.apply(exe):
            averaged = value()
        restored = value()
    worst = 0.0
    for name, got, snaps in zip(params, averaged, zip(*snapshots)):
        want = np.mean(np.stack(snaps).astype(np.float64), axis=0)
        err = float(np.abs(got - want).max() / max(np.abs(want).max(),
                                                   1e-30))
        check(err <= MA_RTOL, '%s: applied %s differs from the mean of %d '
              'updates by %g (tol %g)' % (tag, name, len(snaps), err,
                                          MA_RTOL))
        worst = max(worst, err)
    for name, got, want in zip(params, restored, live):
        check(np.array_equal(got, want), '%s: restore left %s other than '
              'before apply' % (tag, name))
    # the next replay from the restored state against an eager step from it
    state = _persistables(main, scope)
    got = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    check(block.last_ran == 'replay' and block.captures == 1,
          '%s: the step after restore ran %s, %d captures' %
          (tag, block.last_ran, block.captures))
    got_state = value()
    eager_exe, eager_scope = fluid.Executor(fluid.CUDAPlace(0)), \
        fluid.Scope()
    _load(eager_scope, state)
    want = eager_run(eager_exe, main, feed, [loss], eager_scope)
    want_state = [eager_scope.find_var(n).value().cpu().numpy()
                  for n in params]
    err = max(_max_diff(got, want), _max_diff(got_state, want_state))
    check(err <= CAPTURE_TOL, '%s: the replay after restore differs from '
          'an eager step from the same state by %g (tol %g)' %
          (tag, err, CAPTURE_TOL))
    print('%s (%s): %d captured SGD steps; apply: every parameter within '
          '%.3g of the mean of its %d updates (tol %g); restore: bitwise the '
          'parameters before apply; the next replay %s an eager step from '
          'the restored state [%s]' %
          (tag, MA, G3_STEPS, worst, len(snapshots), MA_RTOL,
           'bitwise equal to' if err == 0 else 'within %g of' % err, card),
          flush=True)


def flow_loop_programs(fluid, max_trip_count=FLOW_TRIPS, width=FLOW_WIDTH):
    """A While carrying a [B, width] state through an fc (tanh) for
    FLOW_TRIPS trips, each trip's state written into a tensor array
    (``tests/test_control_flow.py::test_while_grad_bounded``'s pattern);
    bounded by ``max_trip_count`` (0: unbounded).  ``main`` regresses the
    last state on y by SGD, ``test`` fetches the last state and the
    array."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data('x', shape=[width])
        y = fluid.layers.data('y', shape=[width])
        i = fluid.layers.fill_constant(shape=[1], dtype='int64', value=0)
        states = fluid.layers.array_write(x, i)
        trips = fluid.layers.fill_constant(shape=[1], dtype='int64',
                                           value=FLOW_TRIPS)
        cond = fluid.layers.less_than(x=i, y=trips)
        loop = fluid.layers.While(cond=cond, max_trip_count=max_trip_count)
        with loop.block():
            h = fluid.layers.array_read(states, i)
            h.shape = x.shape  # an array element's shape, for fc's weight
            h = fluid.layers.fc(h, size=width, act='tanh',
                                param_attr=fluid.ParamAttr(name='loop_w'),
                                bias_attr=fluid.ParamAttr(name='loop_b'))
            fluid.layers.increment(x=i, in_place=True)
            fluid.layers.array_write(h, i, array=states)
            fluid.layers.less_than(x=i, y=trips, cond=cond)
        last = fluid.layers.array_read(states, i)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(last, y))
        test = main.clone(for_test=True)
        fluid.optimizer.SGD(learning_rate=FLOW_LR).minimize(loss)
    return dict(main=main, startup=startup, test=test, loss=loss,
                last=last, states=states)


def flow_ifelse_programs(fluid, width=FLOW_WIDTH):
    """IfElse over y < 0 routing rows to two fc branches (tanh), each
    reading its rows through ``ie.input`` (``tests/test_split_merge_lod.py``'s
    pattern), regressing on t by SGD."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data('x', shape=[width])
        y = fluid.layers.data('y', shape=[1])
        t = fluid.layers.data('t', shape=[width])
        cond = fluid.layers.less_than(
            x=y, y=fluid.layers.fill_constant([1], 'float32', 0.0))
        ie = fluid.layers.IfElse(cond)
        for branch, block in ((True, ie.true_block), (False, ie.false_block)):
            with block():
                ie.output(fluid.layers.fc(
                    ie.input(x), size=width, act='tanh',
                    param_attr=fluid.ParamAttr(name='branch_%s' % branch)))
        out = ie()[0]
        loss = fluid.layers.mean(fluid.layers.square_error_cost(out, t))
        fluid.optimizer.SGD(learning_rate=FLOW_LR).minimize(loss)
    return dict(main=main, startup=startup, loss=loss, out=out)


def flow_switch_programs(fluid, width=FLOW_WIDTH):
    """An fc regression trained by SGD at a rate a Switch sets from a step
    counter: FLOW_SWITCH's values before each boundary, the last after."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data('x', shape=[width])
        t = fluid.layers.data('t', shape=[width])
        loss = fluid.layers.mean(fluid.layers.square_error_cost(
            fluid.layers.fc(x, size=width, act='tanh'), t))
        step = fluid.layers.cast(fluid.layers.autoincreased_step_counter(
            counter_name='@SWITCH_STEP@', begin=0), 'float32')
        lr = fluid.layers.create_global_var(shape=[1], value=0.0,
                                            dtype='float32', persistable=True,
                                            name='switch_lr')
        (b1, b2), (v1, v2, v3) = FLOW_SWITCH['boundaries'], \
            FLOW_SWITCH['values']
        const = lambda v: fluid.layers.fill_constant([1], 'float32', v)
        switch = fluid.layers.Switch()
        with switch.block():
            with switch.case(fluid.layers.less_than(step, const(b1))):
                fluid.layers.assign(const(v1), lr)
            with switch.case(fluid.layers.less_than(step, const(b2))):
                fluid.layers.assign(const(v2), lr)
            with switch.default():
                fluid.layers.assign(const(v3), lr)
        fluid.optimizer.SGD(learning_rate=lr).minimize(loss)
    return dict(main=main, startup=startup, loss=loss, lr=lr)


def _switch_rate(step):
    for b, v in zip(FLOW_SWITCH['boundaries'], FLOW_SWITCH['values']):
        if step < b:
            return v
    return FLOW_SWITCH['values'][-1]


def phase_flow_control(card):
    """G4: control flow at width FLOW_WIDTH, batch FLOW_BATCH.  A bounded
    While (FLOW_TRIPS trips, ``flow_loop_programs``) trained: FLOW_STEPS
    calls, the loss falling, one step against the CPU, its request (the
    last state and the tensor array, fetched as a LoDTensorArray) against
    the CPU, the step captured against eager; the same loop unbounded as a
    request: eager on every call with its reason naming while, against
    the CPU; IfElse routing rows to two fc branches trained likewise; a
    Switch over a step counter setting SGD's rate, each call's rate
    against FLOW_SWITCH."""
    import paddle_tpu_torch.fluid as fluid
    rng = np.random.RandomState(SEED + 33)
    f32 = lambda *s: rng.standard_normal(s).astype('float32')
    feed = {'x': f32(FLOW_BATCH, FLOW_WIDTH), 'y': f32(FLOW_BATCH,
                                                       FLOW_WIDTH)}

    # the bounded loop, trained
    tag = 'G4 While bounded (%d trips)' % FLOW_TRIPS
    with fluid.unique_name.guard():
        model = flow_loop_programs(fluid)
    model, scope, exe = _started(tag, model)
    fetch = [model['loss'].name]
    _, flops = _flow_train(card, tag, model, scope, exe, feed, fetch,
                           FLOW_STEPS)
    compare_train_step(card, tag, '%d rows' % FLOW_BATCH, model['main'],
                       model['loss'].name, feed, scope, exe, FLOW_LR,
                       dict(FLOW_TRAIN_TOL, param_max=FLOW_LR))
    request = [model['last'].name, model['states'].name]
    got = compare_fetches(card, tag + ' request', model['test'], feed,
                          request, scope, exe, FLOW_SERVE_RTOL)
    check(isinstance(got[1], fluid.core.LoDTensorArray) and
          len(got[1]) == 1 + FLOW_TRIPS,
          '%s: the tensor array fetched as %s of %d' %
          (tag, type(got[1]).__name__, len(got[1])))
    timed = phase_capture(card, tag + ' step', model['main'], feed, fetch,
                          _persistables(model['main'], scope), {},
                          calls=FLOW_CAPTURE_CALLS)
    _book_record(card, tag + ' step', timed, flops, path='G',
                 batch=FLOW_BATCH, width=FLOW_WIDTH, trips=FLOW_TRIPS)
    params = {n: scope.find_var(n).value().cpu().numpy()
              for n in ('loop_w', 'loop_b')}
    del model, scope, exe

    # the same loop unbounded, served: eager on every call
    tag = 'G4 While unbounded request'
    with fluid.unique_name.guard():
        model = flow_loop_programs(fluid, max_trip_count=0)
    model, scope, exe = _started(tag, model)
    test = model['test']
    fluid.params_from_numpy(test, params, scope=scope,
                            place=fluid.CUDAPlace(0))
    results, walls, ran = _book_run(tag, exe, [
        lambda: exe.run(test, feed=feed, fetch_list=request, scope=scope)] *
        FLOW_CAPTURE_CALLS, scans=0)
    block = exe.cached_blocks()[-1]
    check(block.mode == 'eager' and 'while' in (block.why or '') and
          set(ran) == {'eager'} and not block.captures,
          '%s: the block ran %s (%s), calls %s' % (tag, block.mode,
                                                   block.why, ran))
    got = compare_fetches(card, tag, test, feed, request, scope, exe,
                          FLOW_SERVE_RTOL)
    check(isinstance(got[1], fluid.core.LoDTensorArray) and
          len(got[1]) == 1 + FLOW_TRIPS, '%s: the tensor array fetched as '
          '%s of %d (a list grown trip by trip)' %
          (tag, type(got[1]).__name__, len(got[1])))
    prof = profile_busy(lambda: exe.run(test, feed=feed, fetch_list=request,
                                        scope=scope), tag)
    stats = exe.memory_analysis(test, feed=feed, fetch_list=request,
                                scope=scope)
    flops = _cost_per_step(exe, request)
    rec = dict(path='G', phase=tag, eager_s=round(statistics.median(walls), 5),
               captured_s=None, busy_ms_eager=round(prof['busy_ms'], 3),
               idle_eager=round(1 - prof['busy_ms'] / 1e3 / prof['wall_s'],
                                3),
               peak_mib_eager=round(torch.cuda.max_memory_allocated() /
                                    2**20, 1),
               temp_bytes=int(stats.temp_size_in_bytes),
               flops_per_step=flops[-1] if flops else None, why=block.why,
               batch=FLOW_BATCH, width=FLOW_WIDTH, trips=FLOW_TRIPS, card=card)
    print('%s: %d calls, every one eager (%s); median wall %.4f s [%s]' %
          (tag, len(ran), block.why, rec['eager_s'], card), flush=True)
    print('path G: %s' % json.dumps(rec), flush=True)
    del model, scope, exe

    # IfElse, trained
    tag = 'G4 IfElse routed'
    with fluid.unique_name.guard():
        model = flow_ifelse_programs(fluid)
    model, scope, exe = _started(tag, model)
    ifeed = {'x': feed['x'], 'y': f32(FLOW_BATCH, 1), 't': feed['y']}
    fetch = [model['loss'].name]
    _, flops = _flow_train(card, tag, model, scope, exe, ifeed, fetch,
                           FLOW_STEPS)
    compare_train_step(card, tag, '%d rows, %d true' %
                       (FLOW_BATCH, int((ifeed['y'] < 0).sum())),
                       model['main'], fetch[0], ifeed, scope, exe, FLOW_LR,
                       dict(FLOW_TRAIN_TOL, param_max=FLOW_LR))
    timed = phase_capture(card, tag + ' step', model['main'], ifeed, fetch,
                          _persistables(model['main'], scope), {},
                          calls=FLOW_CAPTURE_CALLS)
    _book_record(card, tag + ' step', timed, flops, path='G',
                 batch=FLOW_BATCH, width=FLOW_WIDTH)
    del model, scope, exe

    # Switch over a step counter
    tag = 'G4 Switch over a step counter'
    with fluid.unique_name.guard():
        model = flow_switch_programs(fluid)
    model, scope, exe = _started(tag, model)
    sfeed = {'x': feed['x'], 't': feed['y']}
    fetch = [model['loss'].name, model['lr'].name]
    results, flops = _flow_train(card, tag, model, scope, exe, sfeed, fetch,
                                 FLOW_STEPS)
    rates = [float(r[1][0]) for r in results]
    want = [np.float32(_switch_rate(s)) for s in range(len(rates))]
    check(rates == want, '%s: rates %s, the Switch\'s %s' % (tag, rates,
                                                             want))
    lr = _switch_rate(_counter(scope, '@SWITCH_STEP@') + 1)
    compare_train_step(card, tag, '%d rows' % FLOW_BATCH, model['main'],
                       fetch[0], sfeed, scope, exe, lr,
                       dict(FLOW_TRAIN_TOL, param_max=lr))
    timed = phase_capture(card, tag + ' step', model['main'], sfeed,
                          fetch[:1], _persistables(model['main'], scope), {},
                          calls=FLOW_CAPTURE_CALLS)
    _book_record(card, tag + ' step', timed, flops, path='G',
                 batch=FLOW_BATCH, width=FLOW_WIDTH, rates=rates)
    del model, scope, exe
    torch.cuda.empty_cache()


def phase_flow(card):
    """Path G: control flow, tensor arrays, schedules and the optimizers
    of the control-flow slice."""
    _free()
    for phase in (phase_flow_transformer, phase_flow_ctr, phase_flow_mlp,
                  phase_flow_control):
        phase(card)
        _free()


# ----------------------------------------------------------------------------
# path H: the serving tier (paddle_tpu_torch.serving, inference)
# ----------------------------------------------------------------------------
# H1: bench_transformer's trailing-bucket block (bench.py:527-549): requests
# of SERVE_ROWS rows at the lengths seq/4 .. seq, every id feed on the
# explicit ladder [seq], lots of max_batch_size 16 padded to the one bucket
SERVE_LENGTHS = (64, 128, 192, 256)
SERVE_ROWS = 4
SERVE_MAX_BATCH = 16
SERVE_WINDOWS = 2  # timed windows of SERVE_WINDOW_ROUNDS rounds each
SERVE_WINDOW_ROUNDS = 4
# a response against a direct exe.run of its own (zero-padded) request on
# the card: the lot runs 16 rows, the direct run 4, and cuBLAS picks its
# algorithms by the row count, so the 12 layers sum in another order; the
# prediction is a 30000-way softmax (values about 3e-5)
SERVE_RTOL, SERVE_ATOL = 1e-4, 1e-7
# H2: ResNet-50 f32 and its bf16 inference form in one registry, the budget
# 1.5x one model's live bytes (bench.py:735-798), lots of REGISTRY_BATCH
REGISTRY_BATCH = 64
REGISTRY_ROUNDS = 2  # rounds of (f32 x 3 calls, bf16 x 3 calls) after warm
REGISTRY_REPLAYS = 4  # resident replays timed beside the reloads


def _serve_line(part, record, card):
    record = dict(record, card=card)
    print('path H: %s' % json.dumps(dict(part=part, **record)), flush=True)


def _latency(m):
    return {'p50_latency_ms': m['p50_latency_ms'],
            'p99_latency_ms': m['p99_latency_ms']}


def _stream_kernels(path, fn, want, lowered):
    """``fn()`` under torch.profiler: the hand-written kernels counted by
    name on the card must be ``want()`` (read after the call) and the
    wrappers must have grown by ``lowered``; a session that counted fewer
    (its head lost, PROFILER) is made again, five times at most.  Returns
    fn's last result and wall."""
    for attempt in range(_Path.RETAKES + 1):
        before = _wrapper_counts()
        with _profiled() as session:
            t0 = time.perf_counter()
            result = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        after = _wrapper_counts()
        grew = {k: after[k] - before[k] for k in KERNEL_KEYS}
        check(grew == lowered, '%s: the wrappers grew by %s, expected %s' %
              (path.tag, grew, lowered))
        seen, device, kinds = _device_kernels(session.prof)
        for k in KERNEL_KEYS:
            path.device[k] += seen[k]
            for t in kinds:
                path.by_dtype[t][k] += kinds[t][k]
        want_now = want()
        if seen == want_now:
            _check_dtype(path.tag, kinds, 'f32', want_now)
            return result, wall
        want = lambda w=want_now: w
        check(all(seen[k] <= want_now[k] for k in KERNEL_KEYS) and
              attempt < _Path.RETAKES,
              '%s: the profiler counted %s on the card (%d device '
              'activities), expected %s' % (path.tag, seen, device,
                                            want_now))
        path.retakes += 1
        print('%s: profiler session counted %s of %s: made again' %
              (path.tag, seen, want_now), flush=True)


def phase_serve_transformer(card):
    """H1: Transformer-base's test program served by a started
    InferenceEngine with bench_transformer's trailing ladder."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import serving
    model, scope, exe = build_model()
    cfg = TRANSFORMER_BASE
    seq, vocab = cfg['max_len'], cfg['trg_vocab']
    feeds, pred = model['feeds'], model['prediction']
    per_lot = _expect(fwd=3 * cfg['n_layer'])
    rng = np.random.RandomState(SEED + 61)

    def rounds(n):
        return [{name: rng.randint(1, vocab, size=(SERVE_ROWS, l)).astype(
            'int64') for name in feeds} for _ in range(n)
            for l in SERVE_LENGTHS]

    eng = serving.InferenceEngine(
        model['test'], feed_names=feeds, fetch_list=[pred], scope=scope,
        place=fluid.CUDAPlace(0), name='h1-transformer',
        config=serving.ServingConfig(
            max_batch_size=SERVE_MAX_BATCH, bucket_sizes=[SERVE_MAX_BATCH],
            max_wait_ms=20, steps_per_dispatch=4,
            trailing_ladders={name: [seq] for name in feeds}))
    check(eng.place == fluid.CUDAPlace(0) and eng._exe is not exe,
          'h1: the engine runs on %s' % eng.place)
    served = []

    def window(reqs):
        futs = [eng.submit(r) for r in reqs]
        outs = [f.result(600) for f in futs]
        served.extend(zip(reqs, outs))
        return outs

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    path = _Path('serve engine', None, 'f32').begin()
    eng.start()
    # two warm lots, each alone in its dispatch: the block's eager call and
    # its capture (the graph's one replay)
    for _ in range(2):
        with eng.paused():
            warm = rounds(1)
            futs = [eng.submit(r) for r in warm]
        served.extend((r, f.result(600)) for r, f in zip(warm, futs))
    block = eng._exe.cached_blocks()[-1]
    check(block.mode == 'graph' and block.captures == 1 and
          _wrapper_counts() == _expect(fwd=2 * per_lot['fwd']),
          'h1: after two lots the block is %s (%s), %d captures, the '
          'wrappers %s' % (block.mode, block.why, block.captures,
                           _wrapper_counts()))
    walls, lots = [], []
    for _ in range(SERVE_WINDOWS):
        # the window's lots, each one replay of the captured block
        lots0 = eng.metrics()['lots']
        _, wall = _stream_kernels(
            path, lambda: window(rounds(SERVE_WINDOW_ROUNDS)),
            lambda: {k: v * (eng.metrics()['lots'] - lots0)
                     for k, v in per_lot.items()}, _expect())
        walls.append(wall)
        lots.append(eng.metrics()['lots'] - lots0)
    eng.stop()
    path.end()
    path.ran = (['eager'] * (block.calls - block.captures - block.replays) +
                ['capture'] * block.captures + ['replay'] * block.replays)
    peak = torch.cuda.max_memory_allocated()
    m = eng.metrics()
    check(m['lots'] < m['requests'] and m['errors'] == 0,
          'h1: %d lots for %d requests, %d errors' %
          (m['lots'], m['requests'], m['errors']))
    check(block.replays >= sum(lots) and block.captures == 1 and
          len(eng._exe.cached_blocks()) == 1,
          'h1: %d replays, %d captures, %d blocks' %
          (block.replays, block.captures, len(eng._exe.cached_blocks())))
    # every response against a direct exe.run of its own request
    worst_abs = worst_rel = 0.0
    for r, (out, ) in served:
        padded = {n: np.pad(v, ((0, 0), (0, seq - v.shape[1])))
                  for n, v in r.items()}
        ref, = exe.run(model['test'], feed=padded, fetch_list=[pred],
                       scope=scope)
        check(out.shape == ref.shape == (SERVE_ROWS, seq, vocab) and
              np.isfinite(out).all(), 'h1: response %s, direct run %s' %
              (out.shape, ref.shape))
        d = np.abs(out - ref)
        worst_abs = max(worst_abs, float(d.max()))
        worst_rel = max(worst_rel, float((d / np.maximum(
            np.abs(ref), 1e-30)).max()))
        check(np.allclose(out, ref, rtol=SERVE_RTOL, atol=SERVE_ATOL),
              'h1: a response and the direct run of its request disagree: '
              'max|d| %g (rtol %g, atol %g)' % (float(d.max()), SERVE_RTOL,
                                                SERVE_ATOL))
    rows = SERVE_ROWS * len(SERVE_LENGTHS) * SERVE_WINDOW_ROUNDS
    record = {
        'model': 'Transformer-base %s' % cfg, 'requests': m['requests'],
        'lots': m['lots'], 'dispatches': m['dispatches'],
        'executables': m['executor_compile_count'],
        'block_calls': {'calls': block.calls, 'captures': block.captures,
                        'replays': block.replays},
        'trailing_padding_waste': m['trailing_padding_waste'],
        'trailing_hits': m['trailing_buckets']['hits'],
        'window_lots': lots,
        'rows_per_s_profiled': [round(rows / w, 2) for w in walls],
        'peak_mib': round(peak / 2**20, 1),
        'response_vs_direct_max_abs': worst_abs,
        'response_vs_direct_max_rel': worst_rel,
        'launches': path.summary()}
    record.update(_latency(m))
    _serve_line('H1 engine', record, card)
    # a dropped engine and its executor free their graphs at once: no
    # cyclic collection runs here.  The allocator's cache is emptied first,
    # so the fall is the dropped executor's graphs and pool alone, not the
    # windows' freed fetch buffers
    torch.cuda.synchronize()
    gc.disable()
    try:
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        exe_ref, eng_ref = weakref.ref(eng._exe), weakref.ref(eng)
        del eng, block
        torch.cuda.empty_cache()
        freed = reserved - torch.cuda.memory_reserved()
        dead = exe_ref() is None and eng_ref() is None
    finally:
        gc.enable()
    check(dead, 'h1: the dropped engine or its executor is still alive '
          'without a cyclic collection')
    check(freed > 0, 'h1: memory_reserved did not fall when the engine and '
          'its executor were dropped (%d bytes)' % freed)
    print('serve engine: dropping the engine and its executor released %.1f '
          'MiB of reserved memory without a cyclic collection [%s]' %
          (freed / 2**20, card), flush=True)
    del model, scope, exe, served
    _free()
    return path


def _registry_models(tmpdir):
    """ResNet-50's test program saved with save_inference_model and loaded
    twice on the card: f32 as loaded, and the path C inference format
    (batch norm folded, Float16Transpiler('bfloat16')).  {name: (program,
    feed names, fetch targets, scope)}."""
    import paddle_tpu_torch.fluid as fluid
    model, scope, exe = build_cv_model('resnet', lr=CV_LR, **RESNET50)
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(tmpdir, ['img'], [model['prediction']],
                                      exe, main_program=model['test'])
    del model, scope, exe
    handles = {}
    for name in ('resnet_f32', 'resnet_bf16'):
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        with fluid.scope_guard(scope):
            prog, feeds, fetches = fluid.io.load_inference_model(tmpdir, exe)
            if name == 'resnet_bf16':
                fluid.InferenceTranspiler().transpile(prog, scope=scope)
                fluid.Float16Transpiler().transpile(
                    prog, scope=scope, dtype='bfloat16',
                    feeded_var_names=feeds, fetch_var_names=fetches)
        # the transpilers leave the f32 originals in the scope, on the
        # card: the engine counts, evicts and stages only what its program
        # reads, so they stay there, outside every account
        handles[name] = (prog, feeds, fetches, scope)
    return handles


def phase_serve_registry(card):
    """H2: two ResNet-50 models in one ModelRegistry under a budget of 1.5x
    one model's live bytes: evictions, reloads, the responses after a
    reload bitwise equal to the resident ones, memory_allocated falling on
    an eviction.  No hand-written kernel lies on this part."""
    import tempfile
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import serving
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as td:
            handles = _registry_models(td)
        x = np.random.RandomState(SEED + 67).standard_normal(
            (REGISTRY_BATCH, ) + tuple(RESNET50['image_shape'])).astype(
                'float32')
        reg = serving.ModelRegistry(
            place=fluid.CUDAPlace(0), config=serving.ServingConfig(
                max_batch_size=REGISTRY_BATCH, bucket_sizes=[REGISTRY_BATCH]))
        for name, (prog, feeds, fetches, scope) in handles.items():
            reg.load(name, program=prog, feed_names=feeds,
                     fetch_list=fetches, scope=scope)
        names = list(handles)
        feed = {handles[names[0]][1][0]: x}
        _zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident, walls = {}, {'resident': [], 'reload': []}
        with reg:
            # resident: each model's eager call, capture and replays (the
            # replays timed)
            for name in names:
                resident[name] = []
                for k in range(3 + REGISTRY_REPLAYS):
                    t0 = time.perf_counter()
                    out = reg.infer(name, feed, timeout=600)[0]
                    if k >= 2:
                        walls['resident'].append(time.perf_counter() - t0)
                        check(k == 2 or np.array_equal(out, resident[name][2]),
                              'h2: %s: two replays differ' % name)
                    if k < 3:
                        resident[name].append(out)
            for name in names:
                reg._ensure_resident(name)
            live = sorted(s['hbm_bytes']
                          for s in reg.status()['models'].values())
            # room for either model, not both: bench.py's 1.5x of the larger
            # would hold both here (the bf16 model has half the bytes)
            reg.arbiter.set_budget(live[-1] + live[0] // 2)
            print('h2: live bytes %s, budget %d [%s]' %
                  ({n: a['bytes'] for n, a in reg.arbiter.snapshot()[
                      'accounts'].items()}, reg.arbiter.budget_bytes, card),
                  flush=True)
            # the second model's request evicts the first (least recently
            # used): from here on each model's first call reloads it
            out = reg.infer(names[1], feed, timeout=600)[0]
            check(reg.arbiter.evictions == 1 and
                  np.array_equal(out, resident[names[1]][2]),
                  'h2: the priming request evicted %d models' %
                  reg.arbiter.evictions)
            worst, alloc = 0.0, []
            for _ in range(REGISTRY_ROUNDS):
                for name in names:
                    # the first call evicts the other model and reloads this
                    # one (an eager call), the next two capture and replay
                    for k in range(3):
                        ev0 = reg.arbiter.evictions
                        rl0 = reg.arbiter.reloads
                        t0 = time.perf_counter()
                        out = reg.infer(name, feed, timeout=600)[0]
                        wall = time.perf_counter() - t0
                        if k == 0:
                            walls['reload'].append(wall)
                            check(reg.arbiter.evictions == ev0 + 1 and
                                  reg.arbiter.reloads == rl0 + 1,
                                  'h2: a request to %s evicted %d models, '
                                  'reloaded %d; accounts %s' % (
                                      name, reg.arbiter.evictions - ev0,
                                      reg.arbiter.reloads - rl0,
                                      reg.arbiter.snapshot()['accounts']))
                        check(np.array_equal(out, resident[name][k]),
                              'h2: %s call %d after a reload differs from the '
                              'resident one: max|d| %g' % (
                                  name, k, float(np.abs(
                                      out - resident[name][k]).max())))
                        worst = max(worst, float(np.abs(
                            out.astype(np.float64) -
                            resident[name][k]).max()))
            # an explicit eviction through the arbiter: the allocator's
            # count falls by at least the bytes moved
            victim = reg.arbiter.snapshot()['lru_order'][-1]
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            moved = reg.arbiter.evict(victim, reg._evict_to_host)
            after = torch.cuda.memory_allocated()
            alloc = (before, after, moved)
            m = reg.metrics()
            status = reg.status()
        _no_launches('h2 registry')
        check(after <= before - moved and moved > 0,
              'h2: evicting %s moved %d bytes but memory_allocated went %d -> '
              '%d' % (victim, moved, before, after))
        check(m['evictions'] == 2 * REGISTRY_ROUNDS + 2 and m['reloads'] ==
              2 * REGISTRY_ROUNDS and m['admission_rejects'] == 0 and
              all(mm['errors'] == 0 for mm in m['models'].values()),
              'h2: evictions %d, reloads %d, admission rejects %d' %
              (m['evictions'], m['reloads'], m['admission_rejects']))
        record = {
            'models': {n: {'live_bytes': status['models'][n]['hbm_bytes'],
                           'executables': m['models'][n][
                               'executor_compile_count'],
                           'lots': m['models'][n]['lots']}
                       for n in names},
            'budget_bytes': m['budget_bytes'], 'evictions': m['evictions'],
            'reloads': m['reloads'],
            'admission_rejects': m['admission_rejects'],
            'images_per_s_resident': round(REGISTRY_BATCH / statistics.median(
                walls['resident']), 2),
            'images_per_s_reload': round(REGISTRY_BATCH / statistics.median(
                walls['reload']), 2),
            'after_reload_vs_resident_max_abs': worst,
            'evict_allocated_mib': [round(v / 2**20, 1) for v in alloc],
            'peak_mib': round(torch.cuda.max_memory_allocated() / 2**20, 1)}
        record.update(_latency(m['models'][names[0]]))
        _serve_line('H2 registry', record, card)
        del reg, handles
    finally:
        torch.backends.cudnn.deterministic = saved
    _free()


def phase_serve_predictor(card):
    """H3: the stacked LSTM's kernel form saved with save_inference_model
    and served by create_paddle_predictor(NativeConfig(use_gpu=True)) with
    LoD PaddleTensors; an 8-row request against a CPU predictor."""
    import tempfile
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import inference
    n_layers = STACKED_LSTM['stacked_num']
    with fluid.unique_name.guard():
        model = stacked_lstm_programs(fluid, use_peepholes=False, lr=LSTM_LR,
                                      **STACKED_LSTM)
    model['startup'].random_seed = SEED
    scope, exe = fluid.Scope(), fluid.Executor(fluid.CUDAPlace(0))
    exe.run(model['startup'], scope=scope)
    rng = np.random.RandomState(SEED + 71)

    def tensors(rows):
        req = lstm_request(rng, rows)['words']
        return [inference.PaddleTensor(name='words', data=req.numpy(),
                                       lod=req.lod())]

    with tempfile.TemporaryDirectory() as td:
        with fluid.scope_guard(scope):
            fluid.io.save_inference_model(td, ['words'],
                                          [model['prediction']], exe,
                                          main_program=model['test'])
        pred = inference.create_paddle_predictor(
            inference.NativeConfig(model_dir=td, use_gpu=True))
        cpu = inference.create_paddle_predictor(
            inference.NativeConfig(model_dir=td, use_gpu=False))
    check(pred._exe.place == fluid.CUDAPlace(0) and
          cpu._exe.place == fluid.CPUPlace(), 'h3: predictor places %s, %s' %
          (pred._exe.place, cpu._exe.place))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    path = _Path('serve predictor', pred._exe, 'f32').begin()
    walls = []
    for i in range(REQUESTS + 2):
        req = tensors(LSTM_BATCH)
        out, wall, seen, ran = path.call(
            lambda: pred.run(req), _expect(lstm_fwd=n_layers))[-1]
        walls.append(wall)
        p = out[0].data
        row_err = float(np.abs(p.sum(-1, dtype=np.float64) - 1).max())
        check(p.shape == (LSTM_BATCH, STACKED_LSTM['class_dim']) and
              np.isfinite(p).all() and row_err < 1e-5,
              'h3: request %d prediction %s, rows sum to 1 +- %g' %
              (i, p.shape, row_err))
    path.end()
    check(path.ran[:2] == ['eager', 'capture'] and
          set(path.ran[2:]) == {'replay'}, 'h3: calls %s' % path.ran)
    small = tensors(LSTM_CPU_ROWS)
    got, want = pred.run(small)[0].data, cpu.run(small)[0].data
    err = float(np.abs(got - want).max())
    check(np.allclose(got, want, rtol=LSTM_PRED_RTOL, atol=LSTM_PRED_ATOL),
          'h3: the card and the CPU predictors disagree: max|dpred| %g '
          '(rtol %g, atol %g)' % (err, LSTM_PRED_RTOL, LSTM_PRED_ATOL))
    steady = statistics.median(walls[2:])
    record = {'model': 'stacked LSTM kernel form %s' % STACKED_LSTM,
              'requests': len(walls), 'rows': LSTM_BATCH,
              'lots': len(walls), 'executables': pred._exe.compile_count,
              'rows_per_s': round(LSTM_BATCH / steady, 2),
              'wall_ms_p50': round(1e3 * steady, 3),
              'wall_ms_max': round(1e3 * max(walls[2:]), 3),
              'peak_mib': round(torch.cuda.max_memory_allocated() / 2**20, 1),
              'card_vs_cpu_max_abs': err, 'launches': path.summary()}
    _serve_line('H3 predictor', record, card)
    del pred, cpu, model, scope, exe
    _free()
    return path


# two engines with no registry on one executor and one program (H0)
TWO_ENGINE_REQUESTS = 200
TWO_ENGINE_ROWS = 8
# a request served beside another engine's against the same request
# served alone: lots of other compositions take other cuBLAS kernels, so
# the last bits of an f32 softmax may differ; another request's rows
# differ by O(1)
TWO_ENGINE_TOL = dict(rtol=1e-5, atol=1e-6)


def phase_serve_two_engines(card, place=None):
    """H0: two InferenceEngines without a registry (no dispatch gate) on
    one Executor, one scope and one inference program (the MNIST MLP at
    its published width), fed from two threads with distinct requests, the
    interpreter switching threads every microsecond; every response must
    equal the same request served alone.  They share one captured block:
    without the executor's lock one engine's feeds reach the other's
    replay."""
    import threading
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.models import mnist
    place = place if place is not None else fluid.CUDAPlace(0)
    with fluid.unique_name.guard():
        m = mnist.build(nn_type='mlp')
    m['startup'].random_seed = SEED
    exe, scope = fluid.Executor(place), fluid.Scope()
    exe.run(m['startup'], scope=scope)
    program = fluid.io.get_inference_program([m['prediction']], m['test'])
    rng = np.random.RandomState(SEED + 97)
    reqs = [[{'img': rng.standard_normal((TWO_ENGINE_ROWS, 784)).astype(
        'float32')} for _ in range(TWO_ENGINE_REQUESTS)] for _ in range(2)]
    config = serving.ServingConfig(max_batch_size=TWO_ENGINE_ROWS,
                                   bucket_sizes=[TWO_ENGINE_ROWS],
                                   steps_per_dispatch=4, pipeline_depth=2)
    engines = [serving.InferenceEngine(
        program, feed_names=['img'], fetch_list=[m['prediction']],
        scope=scope, executor=exe, place=place, config=config,
        name='h0-%d' % i) for i in range(2)]
    for eng in engines:
        eng.start()
    try:
        # each request alone, one at a time (the first calls also capture)
        alone = [[eng.submit(r).result(600)[0] for r in rs]
                 for eng, rs in zip(engines, reqs)]
        got = [None, None]

        def serve(i):
            futs = [engines[i].submit(r) for r in reqs[i]]
            got[i] = [f.result(600)[0] for f in futs]

        switch = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=serve, args=(i, ))
                       for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
        finally:
            sys.setswitchinterval(switch)
        check(not any(t.is_alive() for t in threads) and None not in got,
              'H0: a serving thread did not finish')
        wrong = [(i, k) for i in range(2) for k in range(len(reqs[i]))
                 if not np.allclose(got[i][k], alone[i][k],
                                    **TWO_ENGINE_TOL)]
        metrics = [eng.metrics() for eng in engines]
    finally:
        for eng in engines:
            eng.stop()
    check(not wrong, 'H0: %d of %d responses of two ungated engines on one '
          'executor differ from the same requests served alone (first: '
          'engine %d request %d)' % (len(wrong), 2 * TWO_ENGINE_REQUESTS,
                                     wrong[0][0], wrong[0][1])
          if wrong else '')
    blocks = [c for c in exe.cached_blocks() if c.program is program]
    record = {'engines': 2, 'requests': 2 * TWO_ENGINE_REQUESTS,
              'rows': TWO_ENGINE_ROWS,
              'lots': [mm['lots'] for mm in metrics],
              'dispatches': [mm['dispatches'] for mm in metrics],
              'blocks': len(blocks),
              'captures': sum(c.captures for c in blocks),
              'replays': sum(c.replays for c in blocks), 'wrong': 0}
    _serve_line('H0 two engines', record, card)
    exe.close()
    del engines, exe, scope
    if place.device.type == 'cuda':
        _free()


def _memory_report(tag):
    """What still holds device memory: the allocator's counts, its largest
    live blocks (``memory_snapshot``; a pool id other than (0, 0) is a
    graph's), the largest CUDA tensors the collector still reaches, with
    their shapes, and the executors, blocks and graphs still alive; then,
    with no graph alive, the counts once cuBLAS's workspaces are
    released."""
    gc.collect()
    torch.cuda.synchronize()
    blocks = []
    for seg in torch.cuda.memory_snapshot():
        for b in seg['blocks']:
            if b['state'] == 'active_allocated':
                blocks.append((b['size'], seg['segment_type'],
                               str(seg.get('segment_pool_id'))))
    blocks.sort(reverse=True)
    with warnings.catch_warnings():
        # an isinstance test of every object touches deprecated aliases
        warnings.simplefilter('ignore', FutureWarning)
        objects = gc.get_objects()
        tensors = sorted(
            ((o.untyped_storage().nbytes(), tuple(o.shape), str(o.dtype))
             for o in objects if isinstance(o, torch.Tensor) and o.is_cuda),
            reverse=True)
    alive = collections.Counter(
        type(o).__name__ for o in objects
        if type(o).__name__ in ('Executor', '_CompiledBlock', 'CUDAGraph',
                                'InferenceEngine', 'ModelRegistry'))
    del objects
    print('%s: %.1f MiB allocated, %.1f MiB reserved; %d live blocks, %.1f '
          'MiB, the largest (bytes, segment, pool) %s; %d CUDA tensors '
          'reachable, %.1f MiB, the largest (bytes, shape, dtype) %s; alive '
          '%s' % (tag, torch.cuda.memory_allocated() / 2**20,
                  torch.cuda.memory_reserved() / 2**20, len(blocks),
                  sum(b[0] for b in blocks) / 2**20, blocks[:8],
                  len(tensors), sum(t[0] for t in tensors) / 2**20,
                  tensors[:8], dict(alive) or 'none'), flush=True)
    if not alive['CUDAGraph'] and hasattr(torch._C,
                                          '_cuda_clearCublasWorkspaces'):
        # cuBLAS keeps a workspace for each stream it ran on (a capture's
        # stream among them), allocated through the caching allocator;
        # with no graph alive nothing can still use one
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
        print('%s: with cuBLAS\'s workspaces released, %.1f MiB allocated, '
              '%.1f MiB reserved' % (tag, torch.cuda.memory_allocated() /
                                     2**20, torch.cuda.memory_reserved() /
                                     2**20), flush=True)


def phase_serve(card):
    """Path H: the serving tier.  Returns the launch records of its two
    parts with hand-written kernels, by path name."""
    _free()
    phase_serve_two_engines(card)
    launches = {'serve_engine': phase_serve_transformer(card)}
    phase_serve_registry(card)
    # after H2's function returned: its locals (the last model's program
    # and scope among them) are gone with it
    _free()
    _memory_report('h2: the registry dropped')
    launches['serve_predictor'] = phase_serve_predictor(card)
    return launches


# ---- path I: generation serving -------------------------------------------

# bench.py's decode blocks at bench_nmt's and bench_transformer's widths
GEN_NMT = dict(src_dict_dim=30000, trg_dict_dim=30000, embedding_dim=512,
               encoder_size=512, decoder_size=512, max_len=16)
GEN_TF = dict(vocab=30000, d_model=512, d_k=512, max_ctx=256, max_len=16)
GEN_TF_LADDER = [4, 8, 12]
GEN_LENS = [3, 6, 9, 4, 8, 5]
GEN_SLOTS = 4
GEN_STEPS = 4
GEN_DEPTHS = (1, 2)
GEN_CPU_REQUESTS = 2
# timed rounds a depth: tokens/s is given as their median and spread
GEN_TIMED_ROUNDS = 7
# tools/perf_gate.py's chunked_prefill cell on I1's model: one long prompt
# among three short ones
GEN_CHUNK = 64
GEN_CHUNK_LONG = 4096
GEN_CHUNK_SHORT = [5, 7, 6]
GEN_CHUNK_STEPS = 2
GEN_CHUNK_MAX_LEN = 24
# device work queued ahead of I3's dispatch pair, which must not wait for it
GEN_BUSY_MS = 50
# a differing greedy token is a tie when the reference's two top logits at
# that step lie within this relative distance
GEN_TIE_RTOL = 1e-4


def gen_model(kind, seed, chunk=None, **overrides):
    """A ``build_step_decode`` model of the port (``kind`` 'nmt' or
    'transformer') at path I's widths (``overrides`` replacing some of
    them), its startups run on the card from ``seed``: (model, scope,
    executor)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import seq2seq, transformer
    place = fluid.CUDAPlace(0)
    with fluid.unique_name.guard():
        if kind == 'nmt':
            m = seq2seq.build_step_decode(
                chunk=chunk, **dict(GEN_NMT, **overrides))
        else:
            m = transformer.build_step_decode(
                chunk=chunk, **dict(GEN_TF, **overrides))
    exe, scope = fluid.Executor(place), fluid.Scope()
    for i, key in enumerate(('prefill_startup', 'chunk_startup',
                             'step_startup')):
        if m.get(key) is not None:
            m[key].random_seed = seed + i
            exe.run(m[key], scope=scope)
    return m, scope, exe


def gen_prompt(kind, rng, length):
    """One prompt's feed: an LoD sequence for NMT, a dense [1, L, 1] block
    and its length for the Transformer."""
    import paddle_tpu_torch.fluid as fluid
    vocab = GEN_NMT['src_dict_dim'] if kind == 'nmt' else GEN_TF['vocab']
    ids = rng.randint(2, vocab, size=(length, 1)).astype('int64')
    if kind == 'nmt':
        return {'src_word_id': fluid.create_lod_tensor(
            ids.tolist(), [[length]], fluid.CPUPlace())}
    return {'gen_src': ids[None],
            'gen_src_len': np.array([[length]], np.float32)}


def greedy_reference(m, exe, scope, feed, max_len):
    """Per-request greedy decode by ``exe.run``: the prefill program, then
    the step program once per token.  Returns (tokens, each step's
    logits)."""
    from paddle_tpu_torch import serving
    spec = serving.GenerationSpec.from_model(m)
    boot = exe.run(m['prefill'], feed=feed, fetch_list=m['prefill_fetches'],
                   scope=scope)
    state = {}
    for name, val in zip(spec.slot_feeds, boot):
        want = (1, ) + spec.slot_shapes[name]
        padded = np.zeros(want, spec.slot_dtypes[name])
        padded[tuple(slice(0, d) for d in val.shape)] = val
        state[name] = padded
    tok, toks, logits = m['start_id'], [], []
    names = [n for n, _ in m['state']]
    for _ in range(max_len):
        out = exe.run(m['step'], feed=dict(state, **{
            m['token']: np.array([[tok]], np.int64)}),
            fetch_list=[m['logits']] + [f for _, f in m['state']],
            scope=scope)
        lg = np.asarray(out[0]).reshape(-1)
        tok = int(np.argmax(lg))
        toks.append(tok)
        logits.append(lg)
        if tok == m['end_id']:
            break
        state.update(zip(names, out[1:]))
    return toks, logits


def compare_tokens(got, want, want_logits, rtol=GEN_TIE_RTOL):
    """Tie-aware comparison of two greedy decodes of one prompt (``want``
    the reference with its logits): equal, or equal up to a step where
    the reference's two top logits lie within ``rtol`` of each other,
    from which the request is compared no further.  Returns (ok, the step
    of a tie or None)."""
    for j, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        top = np.sort(want_logits[j])[-2:]
        gap = abs(float(top[1] - top[0]))
        return gap <= rtol * max(abs(float(top[1])), abs(float(top[0]))), j
    return len(got) == len(want), None


def _gen_engine(m, scope, exe, name, depth=2, chunk=None, slots=GEN_SLOTS,
                steps=GEN_STEPS, ladders=None, max_batch=None):
    from paddle_tpu_torch import serving
    spec = serving.GenerationSpec.from_model(m)
    return serving.InferenceEngine(
        m['prefill'], fetch_list=m['prefill_fetches'], scope=scope,
        executor=exe, config=serving.ServingConfig(
            max_batch_size=max_batch or len(GEN_LENS), max_wait_ms=5,
            decode_slots=slots, decode_steps=steps,
            decode_pipeline_depth=depth, prefill_chunk=chunk,
            trailing_ladders=ladders),
        generation=spec, name=name)


def _step_blocks(exe, program):
    blocks = [c for c in exe.cached_blocks() if c.program is program]
    return {'mode': [c.mode for c in blocks],
            'captures': sum(c.captures for c in blocks),
            'replays': sum(c.replays for c in blocks)}


def _gen_line(part, record, card):
    record = dict(record, card=card)
    print('path I: %s' % json.dumps(dict(part=part, **record)), flush=True)


def _check_against(tag, outs, refs):
    """Every output against its reference, tie-aware; returns the ties."""
    ties = []
    for i, (got, (want, logits)) in enumerate(zip(outs, refs)):
        ok, tie = compare_tokens(list(got), want, logits)
        check(ok, '%s: request %d decoded %s, the reference %s' %
              (tag, i, list(got), want))
        if tie is not None:
            ties.append((i, tie))
    return ties


def gen_decode_block(card, part, kind, m, scope, exe, prompts, refs,
                     ladders=None):
    """One model through started engines as bench.py's decode block runs
    it, at each of GEN_DEPTHS: a warm round, GEN_TIMED_ROUNDS timed rounds
    (tokens/s their median, min and max), a profiled round; every
    response against ``refs``."""
    results = {}
    for depth in GEN_DEPTHS:
        torch.cuda.reset_peak_memory_stats()
        before = _step_blocks(exe, m['step'])
        eng = _gen_engine(m, scope, exe, '%s-d%d' % (part, depth),
                          depth=depth, ladders=ladders)
        rounds = []
        with eng:
            warm = [eng.submit_generate(p) for p in prompts]
            [f.result(600) for f in warm]
            for _ in range(GEN_TIMED_ROUNDS):
                t0 = time.perf_counter()
                futs = [eng.submit_generate(p) for p in prompts]
                outs = [f.result(600) for f in futs]
                rounds.append((time.perf_counter() - t0, outs))
            prof = profile_run(lambda: [f.result(600) for f in [
                eng.submit_generate(p) for p in prompts]])
        m_eng = eng.metrics()
        d = m_eng['decode']
        check(d['dispatches'] > 0 and
              d['finished'] == (2 + GEN_TIMED_ROUNDS) * len(prompts),
              '%s: the decode lane did not finish every request: %s' %
              (part, d))
        check(d['tokens_per_dispatch'] > 1, '%s: %s' % (part, d))
        ties = []
        for _, outs in rounds:
            ties = _check_against('%s depth %d' % (part, depth), outs, refs)
        tokens = sum(len(o) for o in outs)
        rates = sorted(tokens / wall for wall, _ in rounds)
        blocks = _step_blocks(exe, m['step'])
        check(blocks['mode'] and set(blocks['mode']) == {'graph'},
              '%s: the step block runs %s, not as a graph' %
              (part, blocks['mode']))
        check(blocks['replays'] > before['replays'],
              '%s: no replay of the captured decode step' % part)
        busy = prof['busy_ms']
        record = {
            'model': kind, 'depth': depth, 'requests': len(prompts),
            'tokens': tokens, 'timed_rounds': len(rounds),
            'tokens_per_sec': statistics.median(rates),
            'tokens_per_sec_min': rates[0], 'tokens_per_sec_max': rates[-1],
            'timed_round_s': [wall for wall, _ in rounds],
            'decode_dispatches': d['dispatches'],
            'steps_per_dispatch': d['steps_per_dispatch'],
            'tokens_per_dispatch': d['tokens_per_dispatch'],
            'slot_occupancy': d['slot_occupancy'],
            'host_syncs_per_token': d['host_syncs_per_token'],
            'chain_flushes': d['chain_flushes'],
            'prefill_lots': d['prefill_lots'],
            'executables': m_eng['executor_compile_count'],
            'step_captures': blocks['captures'] - before['captures'],
            'step_replays': blocks['replays'] - before['replays'],
            'busy_ms': busy, 'profiled_wall_s': prof['wall_s'],
            'idle_share': 1 - busy / 1e3 / prof['wall_s'],
            'peak_mib': torch.cuda.max_memory_allocated() / 2**20,
            'ties': ties}
        _gen_line(part, record, card)
        results[depth] = [list(o) for o in outs]
    return results


def gen_cpu_check(part, m, scope, prompts, outs):
    """GEN_CPU_REQUESTS requests of the card's engine against the port's
    CPU greedy decode at the same weights, tie-aware."""
    import paddle_tpu_torch.fluid as fluid
    cpu_scope = fluid.Scope()
    for key in ('prefill', 'step'):
        _copy_params(m[key], scope, cpu_scope)
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    refs = [greedy_reference(m, cpu_exe, cpu_scope, p, m['max_len'])
            for p in prompts[:GEN_CPU_REQUESTS]]
    ties = _check_against('%s against the CPU' % part,
                          outs[:GEN_CPU_REQUESTS], refs)
    print('path I: %s: %d requests equal to the CPU port\'s greedy decode '
          '(ties at %s)' % (part, len(refs), ties), flush=True)


def _copy_params(program, scope, cpu_scope):
    import paddle_tpu_torch.fluid as fluid
    fluid.params_from_numpy(
        program, {p.name: scope.find_var(p.name).value().cpu().numpy()
                  for p in program.all_parameters()},
        scope=cpu_scope, place=fluid.CPUPlace())


def gen_two_owners(card, m, scope, exe, prompts, refs):
    """I1, two carries on one step block.  First, two slot batches decoded
    through ``exe.run_decode_multi`` with no owner, alternating, against
    each decoded alone: equal.  Then two models of one ModelRegistry on
    I1's executor, scope and step program (depths 1 and 2), each warmed
    alone and then decoding at the same time: every response against the
    greedy reference, and the step block captured once more for each
    engine's slot cache."""
    from paddle_tpu_torch import serving
    spec = serving.GenerationSpec.from_model(m)
    decode = spec.decode_arg()
    rng = np.random.RandomState(SEED + 87)

    def carry():
        return {'slots': {n: rng.standard_normal(
                    (GEN_SLOTS, ) + spec.slot_shapes[n]).astype(
                        spec.slot_dtypes[n]) for n in spec.slot_feeds},
                'token': np.full((GEN_SLOTS, 1), m['start_id'], np.int64),
                'alive': np.ones((GEN_SLOTS, ), bool),
                'remaining': np.full((GEN_SLOTS, ), 3 * GEN_STEPS, np.int32)}

    def chain(carries, order):
        toks = {i: [] for i in carries}
        for i in order:
            carries[i], t, _ = exe.run_decode_multi(
                m['step'], carry=carries[i], steps=GEN_STEPS,
                decode=decode, scope=scope)
            toks[i].append(t.cpu().numpy())
        return {i: np.concatenate(t) for i, t in toks.items()}

    c0, c1 = carry(), carry()
    alone = {0: chain({0: dict(c0)}, [0, 0, 0])[0],
             1: chain({1: dict(c1)}, [1, 1, 1])[1]}
    mixed = chain({0: dict(c0), 1: dict(c1)}, [0, 1, 0, 1, 0, 1])
    for i in (0, 1):
        check(np.array_equal(mixed[i], alone[i]),
              'I1: two carries alternating on one step block decode %s, '
              'each alone %s' % (mixed[i].tolist(), alone[i].tolist()))
    before = _step_blocks(exe, m['step'])
    reg = serving.ModelRegistry(name='path-I1-shared')
    for name, depth in (('a', 1), ('b', 2)):
        reg.load(name, program=m['prefill'], feed_names=m['prefill_feeds'],
                 fetch_list=m['prefill_fetches'], scope=scope, executor=exe,
                 generation=spec, config=serving.ServingConfig(
                     max_batch_size=1, decode_slots=GEN_SLOTS,
                     decode_steps=GEN_STEPS, decode_pipeline_depth=depth))
    outs = {}
    with reg:
        for name in ('a', 'b'):
            # alone first: each slot cache's step is captured over its
            # own buffers before the two decode at once
            for _ in range(2):
                [f.result(600) for f in [reg.submit_generate(name, p)
                                         for p in prompts]]
        futs = {name: [] for name in ('a', 'b')}
        for p in prompts:
            for name in ('a', 'b'):
                futs[name].append(reg.submit_generate(name, p))
        outs = {name: [list(f.result(600)) for f in fs]
                for name, fs in futs.items()}
        met = reg.metrics()
    reg.stop()
    for name in ('a', 'b'):
        _check_against('I1 two engines, %s' % name, outs[name], refs)
    after = _step_blocks(exe, m['step'])
    check(after['captures'] - before['captures'] >= 2,
          'I1: the two engines captured the step %d times' %
          (after['captures'] - before['captures']))
    _gen_line('I1 two owners', {
        'alternating_carries_equal_alone': True,
        'engines': 2, 'requests_each': len(prompts),
        'step_captures': after['captures'] - before['captures'],
        'decode_dispatches': {n: met['models'][n]['decode']['dispatches']
                              for n in ('a', 'b')}}, card)
    del reg
    _free()


def phase_generate_nmt(card):
    """I1: the stepwise NMT decoder at bench_nmt's widths."""
    m, scope, exe = gen_model('nmt', SEED + 81)
    rng = np.random.RandomState(SEED + 82)
    prompts = [gen_prompt('nmt', rng, n) for n in GEN_LENS]
    refs = [greedy_reference(m, exe, scope, p, m['max_len'])
            for p in prompts]
    outs = gen_decode_block(card, 'I1', 'nmt', m, scope, exe, prompts, refs)
    gen_cpu_check('I1', m, scope, prompts, outs[GEN_DEPTHS[-1]])
    gen_two_owners(card, m, scope, exe, prompts, refs)
    return m, scope, exe, prompts, refs


def phase_generate_transformer(card):
    """I2: the KV-cache Transformer decoder at bench_transformer's
    widths, prompts on the trailing ladder GEN_TF_LADDER."""
    m, scope, exe = gen_model('transformer', SEED + 83)
    rng = np.random.RandomState(SEED + 84)
    prompts = [gen_prompt('transformer', rng, n) for n in GEN_LENS]
    refs = [greedy_reference(m, exe, scope, p, m['max_len'])
            for p in prompts]
    outs = gen_decode_block(card, 'I2', 'transformer', m, scope, exe,
                            prompts, refs,
                            ladders={'gen_src': GEN_TF_LADDER})
    gen_cpu_check('I2', m, scope, prompts, outs[GEN_DEPTHS[-1]])
    del m, scope, exe
    _free()


def phase_generate_chunked(card):
    """I3: chunked against monolithic prefill on I1's model with a chunk
    program, one GEN_CHUNK_LONG-token prompt among short ones."""
    m, scope, exe = gen_model('nmt', SEED + 81, chunk=GEN_CHUNK,
                              max_len=GEN_CHUNK_MAX_LEN)
    rng = np.random.RandomState(SEED + 85)
    lens = GEN_CHUNK_SHORT[:1] + [GEN_CHUNK_LONG] + GEN_CHUNK_SHORT[1:]
    prompts = [gen_prompt('nmt', rng, n) for n in lens]
    refs = [greedy_reference(m, exe, scope, p, GEN_CHUNK_MAX_LEN)
            for p in prompts]
    outs = {}
    for chunk in (None, GEN_CHUNK):
        torch.cuda.reset_peak_memory_stats()
        eng = _gen_engine(m, scope, exe, 'I3-%s' % chunk, chunk=chunk,
                          steps=GEN_CHUNK_STEPS, max_batch=1)
        t0 = time.perf_counter()
        with eng:
            # the shorts first; the long prompt lands once they decode
            futs = {i: eng.submit_generate(p, max_len=GEN_CHUNK_MAX_LEN)
                    for i, p in enumerate(prompts) if i != 1}
            deadline = time.time() + 60
            while time.time() < deadline and not (
                    eng.metrics()['decode'] or {}).get('dispatches'):
                time.sleep(0.001)
            futs[1] = eng.submit_generate(prompts[1],
                                          max_len=GEN_CHUNK_MAX_LEN)
            got = [list(futs[i].result(900)) for i in range(len(prompts))]
        wall = time.perf_counter() - t0
        d = eng.metrics()['decode']
        ties = _check_against('I3 chunk=%s' % chunk, got, refs)
        if chunk is not None:
            check(d['prefill_chunks'] > 0 and d['prefill_lots'] == 0,
                  'I3: the chunked lane ran %d chunks, %d prefill lots' %
                  (d['prefill_chunks'], d['prefill_lots']))
            check(d['prefill_chunk_tokens'] == sum(lens),
                  'I3: %d prompt tokens chunked, %d submitted' %
                  (d['prefill_chunk_tokens'], sum(lens)))
        outs[chunk] = got
        blocks = _step_blocks(exe, m['chunk']) if chunk else {}
        _gen_line('I3', {
            'lane': 'chunked' if chunk else 'monolithic', 'chunk': chunk,
            'prompt_lengths': lens, 'wall_s': wall,
            'decode_dispatches': d['dispatches'],
            'prefill_chunks': d['prefill_chunks'],
            'prefill_lots': d['prefill_lots'],
            'max_decode_stall_s': d['max_decode_stall_s'],
            'max_decode_stall_cycles': d['max_decode_stall_cycles'],
            'host_syncs_per_token': d['host_syncs_per_token'],
            'chunk_captures': blocks.get('captures'),
            'chunk_replays': blocks.get('replays'),
            'peak_mib': torch.cuda.max_memory_allocated() / 2**20,
            'ties': ties}, card)
    same = outs[None] == outs[GEN_CHUNK]
    print('path I: I3: the chunked and the monolithic lanes decoded %s '
          'tokens' % ('the same' if same else 'tie-equivalent'), flush=True)
    gen_no_sync(m, scope, exe)
    del m, scope, exe
    _free()


def gen_no_sync(m, scope, exe):
    """I3: a decode dispatch and a chunk dispatch behind it, both
    replayed, queue with no host sync: they run behind ~GEN_BUSY_MS of
    device work (``torch.cuda._sleep``) under
    ``torch.cuda.set_sync_debug_mode('error')``, which raises at a
    synchronizing call (a blocking host-to-card copy among them), and the
    host's wall of the pair must stay under half that work."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.fluid.executor import HostCopy
    from paddle_tpu_torch.ops.registry import SEQLEN_SUFFIX
    spec = serving.GenerationSpec.from_model(m)
    cache = serving.SlotStateCache(spec, GEN_SLOTS)
    s = cache.slots
    rng = np.random.RandomState(SEED + 88)
    c = spec.chunk_width
    lens = np.full((s, ), c, np.int32)
    feed = {spec.chunk_token: rng.randint(
                2, GEN_NMT['src_dict_dim'], (s, c, 1)).astype('int64'),
            spec.chunk_token + SEQLEN_SUFFIX: lens}
    if spec.chunk_len is not None:
        feed[spec.chunk_len] = lens.astype(np.float32)[:, None]
    aux = {'active': np.ones((s, ), bool), 'finish': np.zeros((s, ), bool),
           'budget': np.zeros((s, ), np.int32)}

    def cycle():
        carry, toks, alive, _ = exe._dispatch_decode_multi(
            m['step'], carry=cache.carry(), steps=GEN_CHUNK_STEPS,
            decode=spec.decode_arg(), scope=scope, owner=cache)
        cache.set_carry(carry)
        carry, ok, _ = exe._dispatch_chunk_prefill(
            m['chunk'], feed=feed, carry=cache.carry(), aux=aux,
            chunk=spec.chunk_arg(), scope=scope, owner=cache)
        cache.set_carry(carry)
        return HostCopy([toks, alive, ok])

    for _ in range(2):  # eager, then the captures
        cycle().result()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(GEN_BUSY_MS * 1e-3 * 1.98e9))  # cycles at 1.98 GHz
    torch.cuda.set_sync_debug_mode('error')
    try:
        t0 = time.perf_counter()
        out = cycle()
        wall = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode('default')
    out.result()
    check(wall < GEN_BUSY_MS * 1e-3 / 2,
          'I3: the dispatch pair took the host %.2f ms behind %g ms of '
          'device work' % (1e3 * wall, GEN_BUSY_MS))
    print('path I: I3: a replayed decode dispatch and a chunk dispatch '
          'behind it queued with no host sync: %.3f ms of host time behind '
          '%g ms of device work' % (1e3 * wall, GEN_BUSY_MS), flush=True)


def phase_generate_registry(card, nmt):
    """I4: I1's model with generation= in a ModelRegistry beside the MNIST
    MLP, under a budget that forces the ``:decode-cache`` account out and
    back; the tokens after the reload against those before."""
    import tempfile
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import serving
    m, scope, exe, prompts, refs = nmt
    spec = serving.GenerationSpec.from_model(m)
    mlp, mlp_scope, mlp_exe = build_cv_model('mnist', nn_type='mlp')
    reg = serving.ModelRegistry(name='path-I4')
    reg.load('nmt', program=m['prefill'], feed_names=m['prefill_feeds'],
             fetch_list=m['prefill_fetches'], scope=scope, executor=exe,
             generation=spec, config=serving.ServingConfig(
                 max_batch_size=1, decode_slots=GEN_SLOTS,
                 decode_steps=GEN_STEPS))
    with tempfile.TemporaryDirectory() as td:
        with fluid.scope_guard(mlp_scope):
            fluid.io.save_inference_model(td, ['img'], [mlp['prediction']],
                                          mlp_exe, main_program=mlp['test'])
        reg.load('mlp', td)
    img = {'img': np.random.RandomState(SEED + 86).standard_normal(
        (8, 784)).astype('float32')}
    cache = 'nmt' + serving.registry.DECODE_CACHE_SUFFIX
    with reg:
        before = [list(reg.generate('nmt', p, timeout=600))
                  for p in prompts[:2]]
        _check_against('I4 resident', before, refs[:2])
        # the MLP's first request stages its weights (its account is
        # corrected to them at its next), the NMT model's own forward
        # request, then the MLP's: the cache is now the least recently
        # used account
        reg.infer('mlp', img, timeout=600)
        reg.infer('nmt', prompts[0], timeout=600)
        reg.infer('mlp', img, timeout=600)
        accounts = reg.arbiter.snapshot()['accounts']
        total = sum(a['bytes'] for a in accounts.values())
        reg.arbiter.set_budget(total - 1)
        allocated = torch.cuda.memory_allocated()
        reg.infer('mlp', img, timeout=600)
        check(not reg.arbiter.is_resident(cache),
              'I4: the budget did not evict %s: %s' %
              (cache, reg.arbiter.snapshot()['accounts']))
        check(reg.arbiter.is_resident('nmt'), 'I4: the weights went too')
        evicted_to = torch.cuda.memory_allocated()
        after = [list(reg.generate('nmt', p, timeout=600))
                 for p in prompts[:2]]
        check(reg.arbiter.is_resident(cache), 'I4: the cache did not '
              'come back')
        check(after == before, 'I4: after the reload the tokens %s, '
              'before it %s' % (after, before))
        met = reg.metrics()
    _gen_line('I4', {
        'accounts': {n: a['bytes'] for n, a in accounts.items()},
        'budget_bytes': total - 1, 'evictions': met['evictions'],
        'reloads': met['reloads'],
        'allocated_mib_before_eviction': allocated / 2**20,
        'allocated_mib_after_eviction': evicted_to / 2**20,
        'tokens_equal_after_reload': True}, card)
    reg.stop()
    del reg, mlp, mlp_scope, mlp_exe
    _free()


def phase_generate(card):
    """Path I: generation serving.  No hand-written kernel lies on it: the
    launch counters are set to 0 before it and must read 0 after it."""
    _free()
    _zero_counts()
    t0 = time.perf_counter()
    nmt = phase_generate_nmt(card)
    phase_generate_registry(card, nmt)
    del nmt
    _free()
    phase_generate_transformer(card)
    phase_generate_chunked(card)
    _no_launches('path I')
    print('path I: %.1f s' % (time.perf_counter() - t0), flush=True)


# ---- path J: the input pipeline ------------------------------------------

# bench.py's feed_overlap block on bench_transformer (bench.py:160-193,
# :504): Transformer-base at batch 128 x 256 under amp_guard(), fresh
# batches every step through FeedPipeline, K 4 steps a dispatch at depth 2;
# one warmup dispatch (the eager step and the capture) and J_TIMED timed
# ones, dropout 0 (the build's)
J_BATCH = 128
J_STEPS = 4
J_DEPTH = 2
J_TIMED = 3
# the MNIST MLP at its published width (784-200-200-10, tanh, Adam at the
# build's lr 0.01) fed by readers: J_READER_BATCHES batches of J_MLP_BATCH
# a pass (two blocks of J_STEPS and a tail of 2), J_EVAL_BATCHES to
# evaluate, J_EPOCH_BATCHES an epoch for the Trainer, recordio files of
# J_FILE_BATCHES batches
J_MLP_BATCH = 64
J_READER_BATCHES = 10
J_EVAL_BATCHES = 6
J_EPOCH_BATCHES = 8
J_FILE_BATCHES = 3
# J4's losses, read back from recordio files, against the data-layer feed
# path (another program and executor, the same batches and start): the
# same steps on the card, eager, captured and replayed alike, bitwise on
# an NVIDIA H100 80GB HBM3 at 700 W; the bound allows the last bits of an
# f32 sum taken in another order.  J2 and J3 hold their results bitwise.
J_MLP_RTOL = 1e-6
J_MLP_ATOL = 1e-7


def _host_state(program, scope):
    """{name: CPU copy} of the program's persistable tensors."""
    return {n: v.detach().cpu().clone()
            for n, v in _persistables(program, scope).items()}


def _bitwise(a, b):
    return all(np.array_equal(np.asarray(a[n]), np.asarray(b[n]))
               for n in a)


def _state_diff(a, b):
    """max over vars of max|a - b| / max(1, max|b|), and the var."""
    names = sorted(a)
    return _max_diff([np.asarray(a[n], np.float64) for n in names],
                     [np.asarray(b[n], np.float64) for n in names], names)


def _mark_end(ends):
    """Record a timing event on the card's stream behind the work queued
    so far (a dispatch's end), no host sync."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    ends.append(ev)


def _steady_device_ms(ends):
    """Device ms a step from the first dispatch end in ``ends`` to the
    last, J_STEPS steps a dispatch: the card's own clock, so neither a
    host blocked in a launch nor a late delivery moves it; an idle gap
    between dispatches does.  None on the CPU."""
    if not ends:
        return None
    ends[-1].synchronize()
    return ends[0].elapsed_time(ends[-1]) / ((len(ends) - 1) * J_STEPS)


def pipeline_transformer(card, place):
    """J1: Transformer-base trained through FeedPipeline(source=...) under
    amp_guard() against run_multi(feed_list=...) over the same batches
    from the same start; ms a step overlapped, feed stall, overlap ratio,
    the dispatch loop's host syncs (none: every timed dispatch runs under
    ``torch.cuda.set_sync_debug_mode('error')``), and on the card one more
    dispatch under torch.profiler counting the bf16 flash kernels.
    Returns the path's launch record (None on the CPU)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import transformer
    cfg = dict(TRANSFORMER_BASE)
    cuda = place.device.type == 'cuda'
    with fluid.unique_name.guard():
        model = transformer.build(lr=LR, **cfg)
    model['startup'].random_seed = SEED
    main, loss = model['main'], model['loss']
    exe, scope = fluid.Executor(place), fluid.Scope()
    exe.run(model['startup'], scope=scope)
    start = _host_state(main, scope)
    rng = np.random.RandomState(SEED + 91)
    seq, vocab = cfg['max_len'], cfg['trg_vocab']
    n_dispatch = 1 + J_TIMED
    batches = [{n: rng.randint(1, vocab, size=(J_BATCH, seq)).astype(
        'int64') for n in model['feeds']}
        for _ in range((n_dispatch + 1) * J_STEPS)]
    timed = batches[:n_dispatch * J_STEPS]
    path = _Path('feed_pipeline', exe, 'bf16').begin() if cuda else None

    def pipeline(src, name):
        return fluid.FeedPipeline(exe, fetch_list=[loss], program=main,
                                  source=iter(src), steps=J_STEPS,
                                  pipeline_depth=J_DEPTH, scope=scope,
                                  name=name)

    syncs = []
    with fluid.amp_guard():
        # the warmup dispatch (the eager step and the capture) in a
        # pipeline of its own, delivered, and the card drained before the
        # window opens
        losses = [out[0] for out in
                  pipeline(timed[:J_STEPS], 'j1-warmup').run()]
        if cuda:
            torch.cuda.synchronize()
        pipe = pipeline(timed[J_STEPS:], 'j1')
        dispatch = pipe._dispatch
        ends = []

        def no_sync_dispatch(block):
            # a replayed dispatch queues with no host sync: a
            # synchronizing call raises
            if not cuda:
                return dispatch(block)
            torch.cuda.set_sync_debug_mode('error')
            try:
                dispatch(block)
                _mark_end(ends)
            except RuntimeError as e:
                syncs.append(repr(e))
                raise
            finally:
                torch.cuda.set_sync_debug_mode('default')

        pipe._dispatch = no_sync_dispatch
        # the window holds the first block's staging (the pipeline's
        # fill) and ends at the last delivery, which waits for the last
        # dispatch's fetches: every timed step's device work lies in it
        t0, n, ahead_done, first = time.perf_counter(), 0, 0, None
        for out in pipe:
            if first is None:
                first = time.perf_counter()
            losses.append(out[0])
            n += 1
            # delivering a dispatch waits for its own copies only: the
            # dispatch queued behind it is still running on the card
            if cuda and pipe._inflight:
                ahead_done += pipe._inflight[-1][1].done()
        elapsed = time.perf_counter() - t0
    m = pipe.metrics()
    check(not ahead_done, 'J1: %d deliveries waited for the dispatch '
          'queued behind them' % ahead_done)
    check(not syncs and m['dispatches'] == J_TIMED and n == J_TIMED and
          m['steps_dispatched'] == J_TIMED * J_STEPS,
          'J1: %d timed dispatches of %d steps in all, %d delivered, host '
          'syncs %s' % (m['dispatches'], m['steps_dispatched'], n, syncs))
    losses = [float(np.asarray(l).reshape(-1)[0]) for l in losses]
    check(all(np.isfinite(losses)), 'J1: losses %s' % losses)
    after = _host_state(main, scope)
    record = {
        'steps_per_dispatch': J_STEPS, 'pipeline_depth': J_DEPTH,
        'warmup_dispatches': 1, 'dispatches': m['dispatches'],
        'ms_per_step_overlapped':
            elapsed / (m['steps_dispatched']) * 1e3,
        # from the first dispatch's end to the last's on the card: the
        # pipeline full, its fill left out
        'device_ms_per_step_steady': _steady_device_ms(ends),
        'first_delivery_ms': (first - t0) * 1e3,
        'stage_ms_first_block': m['stage_s_first'] * 1e3,
        'feed_stall_ms_per_dispatch':
            m['feed_stall_s'] / max(m['dispatches'] - 1, 1) * 1e3,
        'overlap_ratio': m['overlap_ratio'],
        'dispatch_loop_host_syncs': len(syncs),
        'deliveries_after_next_done': ahead_done,
        'captures': sum(c.captures for c in exe.cached_blocks()),
        'losses': losses}
    if cuda:
        # one more dispatch, replayed, its kernels counted by name on the
        # card: 4 steps of 36 bf16 flash forwards, 18 dQ and 18 dK/dV
        extra = batches[n_dispatch * J_STEPS:]

        def one_dispatch():
            with fluid.amp_guard():
                return fluid.FeedPipeline(
                    exe, fetch_list=[loss], program=main, source=iter(extra),
                    steps=J_STEPS, pipeline_depth=J_DEPTH, scope=scope,
                    name='j1-profiled').run()

        path.call(one_dispatch, _expect(fwd=36 * J_STEPS, dq=18 * J_STEPS,
                                        dkv=18 * J_STEPS))
        path.end()
        record['launches'] = path.summary()
    exe.close()
    del exe, scope, pipe
    if cuda:
        _free()
    # the same batches through run_multi(feed_list=...) from the same start
    exe2, scope2 = fluid.Executor(place), fluid.Scope()
    _load(scope2, start)
    ref, ends = [], []
    with fluid.amp_guard():
        for i in range(n_dispatch):
            if i == 1:
                # the same window, unpipelined: each dispatch uploads its
                # batches and returns its loss on the host before the next
                if cuda:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
            out, = exe2.run_multi(main, feed_list=timed[i * J_STEPS:
                                                        (i + 1) * J_STEPS],
                                  fetch_list=[loss], scope=scope2)
            ref.append(float(np.asarray(out).reshape(-1)[0]))
            if cuda and i >= 1:
                _mark_end(ends)
        record['ms_per_step_run_multi'] = \
            (time.perf_counter() - t0) / (J_TIMED * J_STEPS) * 1e3
        record['device_ms_per_step_run_multi_steady'] = \
            _steady_device_ms(ends)
    want = _host_state(main, scope2)
    exe2.close()
    del exe2, scope2
    worst, at = _state_diff(after, want)
    bitwise = ref == losses and _bitwise(after, want)
    record.update(reference_losses=ref, bitwise=bitwise,
                  param_max_rel=worst, param_worst=at)
    check(bitwise, 'J1: the pipeline\'s losses %s and state against '
          'run_multi(feed_list=)\'s %s: worst %g at %s' %
          (losses, ref, worst, at))
    print('path J: %s' % json.dumps(dict(part='J1 transformer', card=card,
                                         **record)), flush=True)
    return path


def _mlp_programs(fluid, feed='data', train=True):
    """The MNIST MLP (``models/mnist.py``'s ``mlp``, Adam at lr 0.01 when
    ``train``), its image and label from data layers (``feed='data'``), a
    double-buffered py_reader ('reader') or ``open_files`` over recordio
    files (a list of paths).  The same parameter names in every form."""
    from paddle_tpu_torch.models import mnist
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    shapes, dtypes = [[-1, 784], [-1, 1]], ['float32', 'int64']
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        rd = None
        if feed == 'data':
            img = fluid.layers.data('img', [784])
            label = fluid.layers.data('label', [1], dtype='int64')
        elif feed == 'reader':
            rd = fluid.layers.py_reader(capacity=8, shapes=shapes,
                                        dtypes=dtypes)
            rd = fluid.layers.double_buffer(rd)
            img, label = fluid.layers.read_file(rd)
        else:
            rd = fluid.layers.open_files(feed, shapes=shapes,
                                         lod_levels=[0, 0], dtypes=dtypes,
                                         is_test=True)
            img, label = fluid.layers.read_file(rd)
        pred, loss = mnist.mlp(img, label)
        if train:
            fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, rd, pred, loss


def _mlp_batches(seed, n):
    rng = np.random.RandomState(seed)
    return [(rng.standard_normal((J_MLP_BATCH, 784)).astype('float32'),
             rng.randint(0, 10, (J_MLP_BATCH, 1)).astype('int64'))
            for _ in range(n)]


def _close(tag, got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    check(got.shape == want.shape and np.allclose(
        got, want, rtol=J_MLP_RTOL, atol=J_MLP_ATOL),
        '%s: %s against %s' % (tag, got.reshape(-1)[:8],
                               want.reshape(-1)[:8]))


def pipeline_reader(card, place):
    """J2: py_reader + double_buffer + read_file: run_multi(reader=,
    steps=J_STEPS) over two passes (two full blocks, a tail of 2, then
    EOFException; reset() and start()), then run_eval_multi(reader=),
    each bitwise against the feed_list path over the same batches."""
    import paddle_tpu_torch.fluid as fluid
    batches = _mlp_batches(SEED + 93, J_READER_BATCHES)
    main, startup, rd, pred, loss = _mlp_programs(fluid, 'reader')
    exe, scope = fluid.Executor(place), fluid.Scope()
    exe.run(startup, scope=scope)
    start = _host_state(main, scope)
    rd.decorate_tensor_provider(lambda: iter(batches))
    feeder = fluid.layers.io.get_reader_feeder(rd.name)
    chunks = [J_STEPS, J_STEPS, J_READER_BATCHES - 2 * J_STEPS]
    got = []
    for _ in range(2):
        rd.start()
        for k in chunks:
            out, = exe.run_multi(main, reader=rd, fetch_list=[loss],
                                 steps=J_STEPS, scope=scope)
            got.append(float(np.asarray(out).reshape(-1)[0]))
        try:
            exe.run_multi(main, reader=rd, fetch_list=[loss], steps=J_STEPS,
                          scope=scope)
            fail('J2: a run_multi past the pass did not raise EOFException')
        except fluid.EOFException:
            pass
        rd.reset()
    check(feeder._effective_db_place() == place,
          'J2: double_buffer staged for %r, the executor runs on %r' %
          (feeder._effective_db_place(), place))
    trained = _host_state(main, scope)
    # the feed_list path: a program of data layers, from the same start
    dmain, _, _, dpred, dloss = _mlp_programs(fluid, 'data')
    exe_r, scope_r = fluid.Executor(place), fluid.Scope()
    _load(scope_r, start)
    want, i = [], 0
    for _ in range(2):
        i = 0
        for k in chunks:
            out, = exe_r.run_multi(dmain, feed_list=[
                {'img': x, 'label': y} for x, y in batches[i:i + k]],
                fetch_list=[dloss], scope=scope_r)
            want.append(float(np.asarray(out).reshape(-1)[0]))
            i += k
    want_state = _host_state(dmain, scope_r)
    worst, at = _state_diff(trained, want_state)
    check(got == want and _bitwise(trained, want_state),
          'J2: run_multi(reader=)\'s losses %s against the feed_list '
          'path\'s %s, parameters %g apart at %s' % (got, want, worst, at))
    # evaluation: a reader-fed test program over the trained scope, K lots
    # a call (a tail, then EOF), against run_eval_multi(feed_list=)
    emain, _, erd, epred, _ = _mlp_programs(fluid, 'reader', train=False)
    dtest, _, _, dtpred, _ = _mlp_programs(fluid, 'data', train=False)
    ebatches = _mlp_batches(SEED + 94, J_EVAL_BATCHES)
    erd.decorate_tensor_provider(lambda: iter(ebatches))
    erd.start()
    i, evals = 0, 0
    while True:
        try:
            outs = exe.run_eval_multi(emain, reader=erd, fetch_list=[epred],
                                      steps=J_STEPS, scope=scope)
        except fluid.EOFException:
            break
        k = outs[0].shape[0]
        ref = exe.run_eval_multi(dtest, feed_list=[
            {'img': x, 'label': y} for x, y in ebatches[i:i + k]],
            fetch_list=[dtpred], scope=scope)
        check(np.array_equal(outs[0], ref[0]), 'J2: run_eval_multi(reader=) '
              'against the feed_list path: max|d| %g' % float(
                  np.abs(outs[0] - ref[0]).max()))
        i += k
        evals += 1
    erd.reset()
    check(i == J_EVAL_BATCHES and evals == 2,
          'J2: run_eval_multi(reader=) evaluated %d lots in %d calls' %
          (i, evals))
    record = {'train_calls_per_pass': len(chunks), 'steps': chunks,
              'passes': 2, 'eval_lots': i, 'eval_calls': evals,
              'bitwise': True,
              'prefetch_place': repr(feeder._effective_db_place())}
    print('path J: %s' % json.dumps(dict(part='J2 py_reader', card=card,
                                         **record)), flush=True)
    exe.close()
    exe_r.close()


class _Killed(Exception):
    """The interruption J3's event handler raises."""


def pipeline_trainer(card, place):
    """J3: Trainer.train for 2 epochs with steps_per_dispatch=J_STEPS and
    a CheckpointConfig, stopped by an exception at the start of the second
    epoch and resumed from its checkpoint by a new Trainer, against an
    uninterrupted run, bitwise."""
    import tempfile
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import mnist
    rng = np.random.RandomState(SEED + 95)
    data = [[(rng.standard_normal(784).astype('float32'),
              int(rng.randint(0, 10))) for _ in range(J_MLP_BATCH)]
            for _ in range(J_EPOCH_BATCHES)]

    def train_func():
        img = fluid.layers.data('img', [784])
        label = fluid.layers.data('label', [1], dtype='int64')
        return [mnist.mlp(img, label)[1]]

    def trainer(cfg=None):
        with fluid.unique_name.guard():
            return fluid.Trainer(train_func,
                                 lambda: fluid.optimizer.Adam(0.01),
                                 place=place, checkpoint_config=cfg)

    def state(tr):
        return _host_state(tr.train_program, tr.scope)

    def run(tr, epochs, handler=lambda e: None):
        tr.train(epochs, handler, reader=lambda: iter(data),
                 feed_order=['img', 'label'], steps_per_dispatch=J_STEPS)

    whole = trainer()
    losses = []
    run(whole, 2, lambda e: losses.append(float(np.asarray(
        e.metrics[0]).reshape(-1)[0])) if isinstance(
            e, fluid.EndStepEvent) else None)
    want = state(whole)
    with tempfile.TemporaryDirectory() as td:
        cfg = lambda: fluid.CheckpointConfig(td, step_interval=1)

        def kill(e):
            if isinstance(e, fluid.BeginEpochEvent) and e.epoch == 1:
                raise _Killed()

        first = trainer(cfg())
        try:
            run(first, 2, kill)
            fail('J3: the first Trainer was not stopped')
        except _Killed:
            pass
        saved = state(first)
        del first
        resumed = trainer(cfg())
        rcfg = resumed.checkpoint_cfg
        check(rcfg.load_serial is not None and rcfg.epoch_id == 0 and
              rcfg.step_id == J_EPOCH_BATCHES // J_STEPS - 1,
              'J3: resumed from serial %s, epoch %s, step %s' %
              (rcfg.load_serial, rcfg.epoch_id, rcfg.step_id))
        loaded = state(resumed)
        check(_bitwise(loaded, saved), 'J3: the resumed state differs from '
              'the state the first Trainer checkpointed')
        run(resumed, 1)
        got = state(resumed)
    worst, at = _state_diff(got, want)
    check(_bitwise(got, want), 'J3: the resumed run\'s parameters %g from '
          'the uninterrupted run\'s at %s' % (worst, at))
    record = {'epochs': 2, 'steps_per_dispatch': J_STEPS,
              'dispatches_per_epoch': J_EPOCH_BATCHES // J_STEPS,
              'losses': losses, 'resumed_serial': rcfg.load_serial,
              'bitwise': True}
    print('path J: %s' % json.dumps(dict(part='J3 trainer', card=card,
                                         **record)), flush=True)


def pipeline_recordio(card, place):
    """J4: batches written by recordio_writer into recordio files, read
    back through open_files into training steps on ``place``, against the
    same steps fed by data layers."""
    import tempfile
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.runtime import lib_available
    native = lib_available()
    print('path J: J4 recordio through the %s' %
          ('native library (build/runtime/libpaddle_tpu_rt.so)' if native
           else 'pure-Python recordio path'), flush=True)
    batches = _mlp_batches(SEED + 96, J_EPOCH_BATCHES)
    with tempfile.TemporaryDirectory() as td:
        dmain, dstart, _, _, dloss = _mlp_programs(fluid, 'data')
        feeder = fluid.DataFeeder(feed_list=['img', 'label'],
                                  place=fluid.CPUPlace(), program=dmain)
        files = fluid.recordio_writer.convert_reader_to_recordio_files(
            os.path.join(td, 'mnist.recordio'), J_FILE_BATCHES,
            lambda: iter([list(zip(x, y)) for x, y in batches]), feeder)
        main, startup, rd, _, loss = _mlp_programs(fluid, files)
        exe, scope = fluid.Executor(place), fluid.Scope()
        exe.run(startup, scope=scope)
        start = _host_state(main, scope)
        rd.start()
        got = []
        while True:
            try:
                out, = exe.run(main, fetch_list=[loss], scope=scope)
            except fluid.EOFException:
                break
            got.append(float(np.asarray(out).reshape(-1)[0]))
        rd.reset()
    exe_r, scope_r = fluid.Executor(place), fluid.Scope()
    _load(scope_r, start)
    want = [float(np.asarray(exe_r.run(
        dmain, feed={'img': x, 'label': y}, fetch_list=[dloss],
        scope=scope_r)[0]).reshape(-1)[0]) for x, y in batches]
    check(len(files) == -(-J_EPOCH_BATCHES // J_FILE_BATCHES) and
          len(got) == J_EPOCH_BATCHES,
          'J4: %d files, %d batches read back' % (len(files), len(got)))
    _close('J4 losses', got, want)
    print('path J: %s' % json.dumps(dict(
        part='J4 recordio', card=card, native=native, files=len(files),
        batches=len(got), bitwise=got == want, losses=got)), flush=True)
    exe.close()
    exe_r.close()


def phase_pipeline(card):
    """Path J: the input pipeline on the card.  Returns J1's launch
    record."""
    import paddle_tpu_torch.fluid as fluid
    place = fluid.CUDAPlace(0)
    _free()
    t0 = time.perf_counter()
    launches = pipeline_transformer(card, place)
    _zero_counts()  # J2-J4 run no hand-written kernel
    pipeline_reader(card, place)
    pipeline_trainer(card, place)
    pipeline_recordio(card, place)
    _no_launches('path J2-J4')
    _free()
    print('path J: %.1f s' % (time.perf_counter() - t0), flush=True)
    return launches


# ---- path K: the common tensor, shape, reduce, loss and metric ops ----
# K1: Fluid's Transformer recipe in plain layers at path G1's widths
# (bench.py's bench_transformer base shape), batch BATCH x 256
OPS_TF = dict(n_layer=6, d_model=512, n_head=8, d_ff=2048, vocab=30000,
              seq=256)
OPS_LR = 1e-3
OPS_SMOOTH = 0.1        # label_smooth's epsilon, as Fluid's recipe sets it
OPS_REPLAYS = 3         # K1's replays after the eager call and the capture
OPS_CAPTURE_CALLS = 5   # K1's timed calls of each path, eager and captured
# the capture's peak above what was allocated before it against
# memory_analysis's temp bytes: a view (transpose, split, slice, unstack)
# is counted as bytes of its own while it shares its base's, and keeps its
# base alive past the base's release; the plan must still hold the peak
# within this factor either way
OPS_MEMORY_RATIO = 2.0
# K2: each new lowering on the card against the CPU, f32 with TF32 off: the
# same arithmetic, summed in another order or by another libm
OPS_TOL = dict(rtol=1e-5, atol=1e-6)
# 10^6 draws of each random op: the standard errors of their mean and
# standard deviation are under 1e-3
OPS_DRAWS = (1000, 1000)
OPS_DRAW_TOL = 5e-3
OPS_CROP_REPLAYS = 40   # random_crop's replays: the starts cover each dim
# K3: CTR's request, with and without the metrics, timed calls of each
OPS_CTR_CALLS = 10
# the 52 lowerings of the slice: the shape, index, sort and fill ops of
# tensor_ops and misc_ops, the random ops, the math ops, the losses and the
# metrics
OPS_LOWERINGS = (
    'reshape2', 'transpose', 'transpose2', 'squeeze', 'split', 'shape',
    'slice', 'stack', 'unstack', 'flatten', 'flatten2', 'squeeze2',
    'unsqueeze2', 'reverse', 'pad', 'pad2d', 'multiplex', 'label_smooth',
    'argmax', 'argmin', 'arg_max', 'arg_min', 'argsort', 'crop', 'scatter',
    'isfinite', 'truncated_gaussian_random',
    'uniform_random_batch_size_like', 'gaussian_random_batch_size_like',
    'random_crop', 'reduce_mean', 'reduce_max', 'reduce_min', 'reduce_prod',
    'elementwise_mod', 'elementwise_floordiv', 'squared_l2_norm',
    'squared_l2_distance', 'cumsum', 'l1_norm', 'norm', 'huber_loss',
    'smooth_l1_loss', 'log_loss', 'hinge_loss', 'rank_loss',
    'margin_rank_loss', 'modified_huber_loss', 'kldiv_loss', 'auc',
    'precision_recall', 'positive_negative_pair')
OPS_RANDOM = ('truncated_gaussian_random', 'uniform_random_batch_size_like',
              'gaussian_random_batch_size_like', 'random_crop')


def ops_transformer_programs(fluid, n_layer=2, d_model=32, n_head=4,
                             d_ff=64, vocab=50, seq=8, lr=OPS_LR,
                             epsilon=OPS_SMOOTH):
    """Fluid's Transformer recipe written in plain layers (``fluid``'s
    package): a word embedding scaled by sqrt(d_model) plus a learned
    position table (``create_parameter``); each encoder layer projects Q,
    K and V with ``fc(num_flatten_dims=2)``, attends through
    ``nets.scaled_dot_product_attention`` (``reshape``, ``transpose``,
    batched ``matmul``, ``softmax``), projects the context, adds the
    residual under ``layer_norm`` and does the same around a ReLU FFN; the
    head projects onto the vocabulary, and the loss is
    ``softmax_with_cross_entropy(soft_label=True)`` against
    ``label_smooth(one_hot(label), epsilon)``, under ``reduce_mean``; Adam
    at ``lr``.  Returns the programs, the feed names, the loss and each
    layer's (Q, K, V, context) vars."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src = layers.data(name='src_ids', shape=[seq], dtype='int64')
        lbl = layers.data(name='lbl_ids', shape=[seq, 1], dtype='int64')
        emb = layers.embedding(src, size=[vocab, d_model],
                               param_attr=fluid.ParamAttr(name='word_emb'))
        pos = layers.create_parameter(
            shape=[seq, d_model], dtype='float32', name='pos_table',
            default_initializer=fluid.initializer.Normal(0.0, 0.02))
        x = layers.elementwise_add(
            layers.scale(emb, scale=float(d_model) ** 0.5), pos, axis=1)
        attention = []
        for i in range(n_layer):
            q, k, v = (layers.fc(x, size=d_model, num_flatten_dims=2,
                                 bias_attr=False,
                                 param_attr=fluid.ParamAttr(
                                     name='enc_%d_%s.w' % (i, n)))
                       for n in 'qkv')
            ctx = fluid.nets.scaled_dot_product_attention(
                q, k, v, num_heads=n_head)
            attention.append((q, k, v, ctx))
            out = layers.fc(ctx, size=d_model, num_flatten_dims=2)
            x = layers.layer_norm(layers.elementwise_add(x, out),
                                  begin_norm_axis=2)
            ffn = layers.fc(layers.fc(x, size=d_ff, num_flatten_dims=2,
                                      act='relu'),
                            size=d_model, num_flatten_dims=2)
            x = layers.layer_norm(layers.elementwise_add(x, ffn),
                                  begin_norm_axis=2)
        logits = layers.fc(x, size=vocab, num_flatten_dims=2)
        smoothed = layers.label_smooth(layers.one_hot(lbl, vocab),
                                       epsilon=epsilon)
        cost = layers.softmax_with_cross_entropy(logits, smoothed,
                                                 soft_label=True)
        loss = layers.reduce_mean(cost)
        test = main.clone(for_test=True)
        fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
    return dict(main=main, startup=startup, test=test,
                feeds=['src_ids', 'lbl_ids'], loss=loss, attention=attention)


def ops_transformer_batch(rng, batch, seq, vocab):
    """Token ids and next-token labels for ``ops_transformer_programs``."""
    return {'src_ids': rng.randint(1, vocab, (batch, seq)).astype('int64'),
            'lbl_ids': rng.randint(1, vocab, (batch, seq, 1)).astype('int64')}


def op_rand(seed, *shape, lo=None):
    """Seeded standard-normal f32 values (their magnitudes + ``lo`` with
    ``lo``)."""
    x = np.random.RandomState(seed).standard_normal(shape).astype('float32')
    return np.abs(x) + lo if lo is not None else x


def op_out_names(outputs):
    """A one-op case's output var names, in slot order."""
    return [n for v in outputs.values()
            for n in (v if isinstance(v, list) else [v])]


def one_op_program(fluid, op_type, inputs, outputs, attrs):
    """A program of one op: ``inputs`` {slot: (name, array) or a list of
    them}, ``outputs`` {slot: name or a list of names}.  Returns (program,
    feed)."""
    slots = {s: (v if isinstance(v, list) else [v])
             for s, v in inputs.items()}
    prog = fluid.Program()
    blk = prog.global_block()
    feed = {}
    for pairs in slots.values():
        for name, arr in pairs:
            blk.create_var(name=name, shape=arr.shape, dtype=str(arr.dtype))
            feed[name] = arr
    for name in op_out_names(outputs):
        if not blk.has_var(name):
            blk.create_var(name=name, dtype='float32')
    blk.append_op(type=op_type,
                  inputs={s: [n for n, _ in pairs]
                          for s, pairs in slots.items()},
                  outputs={s: list(v) if isinstance(v, list) else [v]
                           for s, v in outputs.items()},
                  attrs=attrs)
    return prog, feed


def one_op_grad_program(fluid, case, out, wrt, cot):
    """``case``'s one-op program with the gradients of the vars ``wrt``
    (``calc_gradient``) for the cotangent ``cot`` fed to its output
    ``out``.  Returns (program, feed, the gradients' names)."""
    prog, feed = one_op_program(fluid, *case[:4])
    with fluid.program_guard(prog, fluid.Program()):
        blk = prog.global_block()
        cvar = blk.create_var(name='cot', shape=cot.shape, dtype='float32')
        feed['cot'] = cot
        fluid.backward.calc_gradient(targets=[blk.var(out)],
                                     inputs=[blk.var(n) for n in wrt],
                                     target_gradients=[cvar])
    return prog, feed, [n + '@GRAD' for n in wrt]


def ops_cases():
    """The deterministic lowerings' one-op cases, small and seeded: {name:
    (op, inputs, outputs, attrs, the output a gradient's cotangent is fed
    to or None, the inputs differentiated)}.  Ties, negative operands,
    out-of-range slices, stable sorts and the ``*2`` ops' XShape among
    them."""
    x234, x2345, x2131 = op_rand(1, 2, 3, 4), op_rand(2, 2, 3, 4, 5), \
        op_rand(3, 2, 1, 3, 1)
    ties = np.random.RandomState(20).randint(0, 3, (4, 8)).astype('float32')
    one_hot = np.eye(5, dtype='float32')[[0, 3, 1, 4]]
    tied = np.array([[1.0, 3.0, 3.0, -2.0], [2.0, 2.0, 2.0, 2.0],
                     [-1.0, -4.0, 0.5, -4.0]], 'float32')
    near_one = (1.0 + 0.1 * op_rand(41, 2, 3, 4)).astype('float32')
    neg_x = np.array([[-7.5, 7.5, -3.25, 5.0], [-0.5, 0.75, -9.0, 4.5]],
                     'float32')
    neg_y = np.array([[2.0, -2.0, -1.5, -3.0], [0.25, -0.5, 4.0, -2.5]],
                     'float32')
    int_x = np.array([[-7, 7, -3, 5], [-1, 0, -9, 4]], 'int32')
    int_y = np.array([[2, -2, -2, -3], [3, -5, 4, -2]], 'int32')
    x = op_rand(42, 3, 4, 5)
    reduce = lambda dim, keep=False, all_=False: {
        'dim': dim, 'keep_dim': keep, 'reduce_all': all_}
    n = 6
    lx, ly = op_rand(51, n, 3), op_rand(52, n, 3)
    p = 1.0 / (1.0 + np.exp(-op_rand(53, n, 1)))
    label = np.random.RandomState(54).randint(0, 2, (n, 1)).astype('float32')
    log_p = op_rand(55, n, 4)
    log_p = log_p - np.log(np.exp(log_p).sum(-1, keepdims=True))
    target = op_rand(56, n, 4, lo=0.0)
    target = (target / target.sum(-1, keepdims=True)).astype('float32')
    target[0, 1] = 0.0  # a zero target: its term is 0
    mrng = np.random.RandomState(70)
    probs = mrng.uniform(size=(64, 2)).astype('float32')
    auc_label = mrng.randint(0, 2, (64, 1)).astype('int64')
    score = mrng.randint(0, 5, (24, 1)).astype('float32')  # ties
    pairs = lambda: {'Score': ('s', score),
                     'Label': ('l', mrng.randint(0, 3, (24, 1))
                               .astype('float32')),
                     'QueryID': ('q', mrng.randint(0, 3, (24, 1))
                                 .astype('int64'))}
    pair_outs = {'PositivePair': 'pos', 'NegativePair': 'neg',
                 'NeutralPair': 'neu'}
    return {
        # shape ops
        'reshape2': ('reshape2', {'X': ('x', x234)},
                     {'Out': 'out', 'XShape': 'xs'}, {'shape': [0, -1]},
                     'out', ['x']),
        'transpose': ('transpose', {'X': ('x', x234)}, {'Out': 'out'},
                      {'axis': [1, 0, 2]}, 'out', ['x']),
        'transpose2': ('transpose2', {'X': ('x', x2345)},
                       {'Out': 'out', 'XShape': 'xs'},
                       {'axis': [0, 2, 1, 3]}, 'out', ['x']),
        'squeeze_axes': ('squeeze', {'X': ('x', x2131)}, {'Out': 'out'},
                         {'axes': [1, 0]}, 'out', ['x']),
        'squeeze_all': ('squeeze', {'X': ('x', x2131)}, {'Out': 'out'},
                        {'axes': []}, 'out', ['x']),
        'squeeze2': ('squeeze2', {'X': ('x', x2131)},
                     {'Out': 'out', 'XShape': 'xs'}, {'axes': [3]}, 'out',
                     ['x']),
        'unsqueeze2': ('unsqueeze2', {'X': ('x', x234)},
                       {'Out': 'out', 'XShape': 'xs'}, {'axes': [0, 3]},
                       'out', ['x']),
        'flatten': ('flatten', {'X': ('x', x2345)}, {'Out': 'out'},
                    {'axis': 2}, 'out', ['x']),
        'flatten_axis0': ('flatten', {'X': ('x', x234)}, {'Out': 'out'},
                          {'axis': 0}, 'out', ['x']),
        'flatten2': ('flatten2', {'X': ('x', x2345)},
                     {'Out': 'out', 'XShape': 'xs'}, {'axis': 1}, 'out',
                     ['x']),
        'split_num': ('split', {'X': ('x', op_rand(4, 4, 6))},
                      {'Out': ['o0', 'o1', 'o2']},
                      {'num': 3, 'sections': [], 'axis': 1}, 'o1', ['x']),
        'split_sections': ('split', {'X': ('x', op_rand(5, 4, 7))},
                           {'Out': ['o0', 'o1', 'o2']},
                           {'num': 0, 'sections': [2, 4, 1], 'axis': 1},
                           'o2', ['x']),
        'shape': ('shape', {'Input': ('x', x2345)}, {'Out': 'out'}, {},
                  None, ()),
        'slice_out_of_range': ('slice', {'Input': ('x', op_rand(6, 4, 5, 6))},
                               {'Out': 'out'},
                               {'axes': [0, 2], 'starts': [1, -3],
                                'ends': [100, -1]}, 'out', ['x']),
        'slice_open': ('slice', {'Input': ('x', op_rand(7, 4, 5, 6))},
                       {'Out': 'out'},
                       {'axes': [1, 2], 'starts': [-(2**31 - 1), 2],
                        'ends': [2**31 - 1, 4]}, 'out', ['x']),
        'slice_empty': ('slice', {'Input': ('x', op_rand(8, 4, 5))},
                        {'Out': 'out'},
                        {'axes': [1], 'starts': [4], 'ends': [2]}, None,
                        ()),
        'stack': ('stack', {'X': [('a', op_rand(9, 2, 3)),
                                  ('b', op_rand(10, 2, 3)),
                                  ('c', op_rand(11, 2, 3))]},
                  {'Y': 'y'}, {'axis': 1}, 'y', ['a', 'b', 'c']),
        'unstack': ('unstack', {'X': ('x', op_rand(12, 3, 2, 4))},
                    {'Y': ['y0', 'y1']}, {'axis': 1, 'num': 2}, 'y1',
                    ['x']),
        # index, sort and fill ops
        'reverse': ('reverse', {'X': ('x', op_rand(21, 3, 4, 5))},
                    {'Out': 'out'}, {'axis': [0, 2]}, 'out', ['x']),
        'reverse_int_axis': ('reverse', {'X': ('x', op_rand(22, 3, 4))},
                             {'Out': 'out'}, {'axis': 1}, 'out', ['x']),
        'pad': ('pad', {'X': ('x', op_rand(23, 2, 3))}, {'Out': 'out'},
                {'paddings': [1, 0, 2, 1], 'pad_value': 0.5}, 'out', ['x']),
        'pad2d_constant': ('pad2d', {'X': ('x', op_rand(24, 1, 2, 4, 5))},
                           {'Out': 'out'},
                           {'paddings': [1, 2, 2, 1], 'mode': 'constant',
                            'pad_value': -1.0}, 'out', ['x']),
        'pad2d_reflect': ('pad2d', {'X': ('x', op_rand(25, 1, 2, 4, 5))},
                          {'Out': 'out'},
                          {'paddings': [1, 2, 2, 1], 'mode': 'reflect'},
                          'out', ['x']),
        'pad2d_edge': ('pad2d', {'X': ('x', op_rand(26, 1, 2, 4, 5))},
                       {'Out': 'out'},
                       {'paddings': [2, 0, 1, 3], 'mode': 'edge'}, 'out',
                       ['x']),
        'multiplex': ('multiplex',
                      {'X': [('a', op_rand(27, 4, 5)),
                             ('b', op_rand(28, 4, 5)),
                             ('c', op_rand(29, 4, 5))],
                       'Ids': ('ids', np.array([[2], [0], [1], [2]],
                                               'int32'))},
                      {'Out': 'out'}, {}, 'out', ['a', 'b', 'c']),
        'label_smooth': ('label_smooth', {'X': ('x', one_hot)},
                         {'Out': 'out'}, {'epsilon': 0.1}, 'out', ['x']),
        'label_smooth_prior': ('label_smooth',
                               {'X': ('x', one_hot),
                                'PriorDist': ('d', op_rand(30, 5, lo=0.1))},
                               {'Out': 'out'}, {'epsilon': 0.2}, 'out',
                               ['x', 'd']),
        'argmax_ties': ('argmax', {'X': ('x', ties)}, {'Out': 'out'},
                        {'axis': 1}, None, ()),
        'argmin_ties': ('argmin', {'X': ('x', ties)}, {'Out': 'out'},
                        {'axis': 0}, None, ()),
        'arg_max': ('arg_max', {'X': ('x', op_rand(31, 4, 6))},
                    {'Out': 'out'}, {'axis': -1}, None, ()),
        'arg_min': ('arg_min', {'X': ('x', op_rand(32, 4, 6))},
                    {'Out': 'out'}, {'axis': 1}, None, ()),
        'argsort_stable': ('argsort', {'X': ('x', ties)},
                           {'Out': 'out', 'Indices': 'idx'}, {'axis': -1},
                           'out', ['x']),
        'argsort_axis0': ('argsort', {'X': ('x', ties)},
                          {'Out': 'out', 'Indices': 'idx'}, {'axis': 0},
                          'out', ['x']),
        'crop': ('crop', {'X': ('x', op_rand(33, 4, 5, 6))}, {'Out': 'out'},
                 {'offsets': [1, 0, 2], 'shape': [2, 5, 3]}, 'out', ['x']),
        'crop_like_y': ('crop', {'X': ('x', op_rand(34, 4, 5, 6)),
                                 'Y': ('y', op_rand(35, 3, 2, 4))},
                        {'Out': 'out'}, {'offsets': [0, 3, 1]}, 'out',
                        ['x']),
        'scatter': ('scatter', {'X': ('x', op_rand(36, 6, 3)),
                                'Ids': ('ids', np.array([4, 0, 2],
                                                        'int64')),
                                'Updates': ('u', op_rand(37, 3, 3))},
                    {'Out': 'out'}, {}, 'out', ['x', 'u']),
        'isfinite': ('isfinite', {'X': ('x', op_rand(38, 3, 4))},
                     {'Out': 'out'}, {}, None, ()),
        'isfinite_inf': ('isfinite',
                         {'X': ('x', np.array([1.0, np.inf, 2.0],
                                              'float32'))},
                         {'Out': 'out'}, {}, None, ()),
        # math ops
        'reduce_mean_dim': ('reduce_mean', {'X': ('x', x)}, {'Out': 'out'},
                            reduce([1]), 'out', ['x']),
        'reduce_mean_keep': ('reduce_mean', {'X': ('x', x)},
                             {'Out': 'out'}, reduce([0, -1], keep=True),
                             'out', ['x']),
        'reduce_mean_all': ('reduce_mean', {'X': ('x', x)},
                            {'Out': 'out'}, reduce([0], all_=True), 'out',
                            ['x']),
        'reduce_max_ties': ('reduce_max', {'X': ('x', tied)},
                            {'Out': 'out'}, reduce([1]), 'out', ['x']),
        'reduce_max_all_ties': ('reduce_max', {'X': ('x', tied)},
                                {'Out': 'out'}, reduce([0], all_=True),
                                'out', ['x']),
        'reduce_min_ties': ('reduce_min', {'X': ('x', tied)},
                            {'Out': 'out'}, reduce([1], keep=True), 'out',
                            ['x']),
        'reduce_prod_dims': ('reduce_prod', {'X': ('x', near_one)},
                             {'Out': 'out'}, reduce([0, 2]), 'out', ['x']),
        'reduce_prod_keep': ('reduce_prod', {'X': ('x', near_one)},
                             {'Out': 'out'}, reduce([1], keep=True), 'out',
                             ['x']),
        'reduce_prod_all': ('reduce_prod', {'X': ('x', near_one)},
                            {'Out': 'out'}, reduce([0], all_=True), 'out',
                            ['x']),
        'mod_negative': ('elementwise_mod', {'X': ('x', neg_x),
                                             'Y': ('y', neg_y)},
                         {'Out': 'out'}, {'axis': -1}, 'out', ['x', 'y']),
        'mod_negative_int': ('elementwise_mod', {'X': ('x', int_x),
                                                 'Y': ('y', int_y)},
                             {'Out': 'out'}, {'axis': -1}, None, ()),
        'floordiv_negative': ('elementwise_floordiv',
                              {'X': ('x', neg_x), 'Y': ('y', neg_y)},
                              {'Out': 'out'}, {'axis': -1}, None, ()),
        'floordiv_negative_int': ('elementwise_floordiv',
                                  {'X': ('x', int_x), 'Y': ('y', int_y)},
                                  {'Out': 'out'}, {'axis': -1}, None, ()),
        'mod_broadcast': ('elementwise_mod',
                          {'X': ('x', op_rand(43, 2, 3, 4) * 5),
                           'Y': ('y', op_rand(44, 3, lo=0.5))},
                          {'Out': 'out'}, {'axis': 1}, 'out', ['x']),
        'squared_l2_norm': ('squared_l2_norm', {'X': ('x', x)},
                            {'Out': 'out'}, {}, 'out', ['x']),
        'squared_l2_distance': ('squared_l2_distance',
                                {'X': ('x', op_rand(45, 4, 6)),
                                 'Y': ('y', op_rand(46, 4, 6))},
                                {'Out': 'out', 'sub_result': 'sub'}, {},
                                'out', ['x', 'y']),
        'squared_l2_distance_row': ('squared_l2_distance',
                                    {'X': ('x', op_rand(47, 4, 6)),
                                     'Y': ('y', op_rand(48, 1, 6))},
                                    {'Out': 'out', 'sub_result': 'sub'}, {},
                                    'out', ['x', 'y']),
        'cumsum': ('cumsum', {'X': ('x', x)}, {'Out': 'out'}, {'axis': 1},
                   'out', ['x']),
        'cumsum_exclusive_reverse': ('cumsum', {'X': ('x', x)},
                                     {'Out': 'out'},
                                     {'axis': -1, 'exclusive': True,
                                      'reverse': True}, 'out', ['x']),
        'cumsum_int': ('cumsum', {'X': ('x', int_x)}, {'Out': 'out'},
                       {'axis': 0, 'exclusive': True}, None, ()),
        'l1_norm': ('l1_norm', {'X': ('x', x)}, {'Out': 'out'}, {}, 'out',
                    ['x']),
        'norm': ('norm', {'X': ('x', x)}, {'Out': 'out', 'Norm': 'n'},
                 {'axis': 1, 'epsilon': 1e-10}, 'out', ['x']),
        # losses
        'huber_loss': ('huber_loss', {'X': ('x', lx), 'Y': ('y', ly)},
                       {'Out': 'out', 'Residual': 'r'}, {'delta': 0.8},
                       'out', ['x', 'y']),
        'smooth_l1_loss': ('smooth_l1_loss', {'X': ('x', lx), 'Y': ('y', ly)},
                           {'Out': 'out', 'Diff': 'd'}, {'sigma': 1.5},
                           'out', ['x', 'y']),
        'smooth_l1_loss_weighted': (
            'smooth_l1_loss',
            {'X': ('x', lx), 'Y': ('y', ly),
             'InsideWeight': ('iw', op_rand(57, n, 3, lo=0.1)),
             'OutsideWeight': ('ow', op_rand(58, n, 3, lo=0.1))},
            {'Out': 'out', 'Diff': 'd'}, {'sigma': 1.0}, 'out', ['x', 'y']),
        'log_loss': ('log_loss', {'Predicted': ('p', p),
                                  'Labels': ('l', label)},
                     {'Loss': 'loss'}, {'epsilon': 1e-4}, 'loss', ['p']),
        'hinge_loss': ('hinge_loss', {'Logits': ('x', op_rand(59, n, 1)),
                                      'Labels': ('l', label)},
                       {'Loss': 'loss'}, {}, 'loss', ['x']),
        'rank_loss': ('rank_loss', {'Label': ('l', label),
                                    'Left': ('a', op_rand(60, n, 1)),
                                    'Right': ('b', op_rand(61, n, 1))},
                      {'Out': 'out'}, {}, 'out', ['a', 'b']),
        'margin_rank_loss': ('margin_rank_loss',
                             {'Label': ('l', 2 * label - 1),
                              'X1': ('a', op_rand(62, n, 1)),
                              'X2': ('b', op_rand(63, n, 1))},
                             {'Out': 'out', 'Activated': 'act'},
                             {'margin': 0.3}, 'out', ['a', 'b']),
        'modified_huber_loss': ('modified_huber_loss',
                                {'X': ('x', 1.5 * op_rand(64, n, 1)),
                                 'Y': ('y', label)},
                                {'Out': 'out', 'IntermediateVal': 'z'}, {},
                                'out', ['x']),
        'kldiv_loss_mean': ('kldiv_loss', {'X': ('x', log_p),
                                           'Target': ('t', target)},
                            {'Loss': 'loss'}, {'reduction': 'mean'}, 'loss',
                            ['x', 't']),
        'kldiv_loss_batchmean': ('kldiv_loss', {'X': ('x', log_p),
                                                'Target': ('t', target)},
                                 {'Loss': 'loss'},
                                 {'reduction': 'batchmean'}, 'loss',
                                 ['x']),
        'kldiv_loss_none': ('kldiv_loss', {'X': ('x', log_p),
                                           'Target': ('t', target)},
                            {'Loss': 'loss'}, {'reduction': 'none'},
                            'loss', ['x']),
        # metrics
        'auc': ('auc', {'Predict': ('p', probs), 'Label': ('l', auc_label)},
                {'AUC': 'auc'}, {'curve': 'ROC', 'num_thresholds': 200},
                None, ()),
        'auc_50': ('auc', {'Predict': ('p', probs[:, 1]),
                           'Label': ('l', auc_label)},
                   {'AUC': 'auc'}, {'num_thresholds': 50}, None, ()),
        'precision_recall': ('precision_recall',
                             {'Indices': ('i', mrng.randint(0, 4, (32, 1))
                                          .astype('int64')),
                              'Labels': ('l', mrng.randint(0, 4, (32, 1))
                                         .astype('int64'))},
                             {'BatchMetrics': 'm'}, {'class_number': 4},
                             None, ()),
        'positive_negative_pair': ('positive_negative_pair', pairs(),
                                   pair_outs, {}, None, ()),
        'positive_negative_pair_accumulate': (
            'positive_negative_pair',
            dict(pairs(),
                 AccumulatePositivePair=('ap', np.array([3.0], 'float32')),
                 AccumulateNegativePair=('an', np.array([1.0], 'float32')),
                 AccumulateNeutralPair=('au', np.array([2.0], 'float32'))),
            pair_outs, {}, None, ()),
    }


def _ops_close(tag, got, want, tol=OPS_TOL):
    """Each fetch of ``got`` against ``want``: the same shape, integer and
    bool values exactly, floats within ``tol`` (atol scaled by
    max(1, max|want|)).  Returns the worst max|d| / max(1, max|want|)."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        check(g.shape == w.shape, '%s: output %d has shape %s on the card, '
              '%s on the CPU' % (tag, i, g.shape, w.shape))
        if w.dtype.kind in 'biu':
            check(np.array_equal(g, w), '%s: integer output %d differs: %s '
                  'vs %s' % (tag, i, g.ravel()[:8], w.ravel()[:8]))
            continue
        if not w.size:
            continue
        scale = max(1.0, float(np.abs(w).max()))
        check(np.allclose(g, w, rtol=tol['rtol'], atol=tol['atol'] * scale),
              '%s: output %d: max|d| %g (rtol %g, atol %g x %g)' %
              (tag, i, float(np.abs(g - w).max()), tol['rtol'], tol['atol'],
               scale))
        worst = max(worst, float(np.abs(g - w).max()) / scale)
    return worst


def phase_ops_lowerings(card):
    """K2: every lowering of the slice, one op at a time, on the card
    against ``CPUPlace()``: the forward (integer outputs exactly); the
    generic grad where the op is differentiable; the op captured (its
    second call) and replayed (its third) against its eager first call;
    the random ops by distribution.  Fails unless every one of the
    OPS_LOWERINGS was checked."""
    import paddle_tpu_torch.fluid as fluid
    gpu, cpu = fluid.CUDAPlace(0), fluid.CPUPlace()
    checked, worst = set(), {'forward': 0.0, 'grad': 0.0, 'capture': 0.0}
    n_grads = n_captured = 0
    t0 = time.perf_counter()
    for name, case in sorted(ops_cases().items()):
        prog, feed = one_op_program(fluid, *case[:4])
        fetch = op_out_names(case[2])
        exe, scope = fluid.Executor(gpu), fluid.Scope()
        runs = [exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
                for _ in range(3)]
        block = exe.cached_blocks()[-1]
        want = fluid.Executor(cpu).run(prog, feed=feed, fetch_list=fetch,
                                       scope=fluid.Scope())
        worst['forward'] = max(worst['forward'],
                               _ops_close('K2 ' + name, runs[0], want))
        check(block.mode == 'graph' and block.captures == 1 and
              block.last_ran == 'replay',
              'K2 %s: the block ran %s (%s), %d captures, last %s' %
              (name, block.mode, block.why, block.captures, block.last_ran))
        err = max(_max_diff(runs[1], runs[0]), _max_diff(runs[2], runs[0]))
        check(err <= CAPTURE_TOL, 'K2 %s: captured and replayed calls '
              'differ from the eager one by %g (tol %g)' %
              (name, err, CAPTURE_TOL))
        worst['capture'] = max(worst['capture'], err)
        n_captured += 1
        if case[4] is not None:
            shape = np.asarray(want[fetch.index(case[4])]).shape
            cot = np.random.RandomState(8).standard_normal(shape).astype(
                'float32')
            gprog, gfeed, gnames = one_op_grad_program(fluid, case, case[4],
                                                       case[5], cot)
            got = fluid.Executor(gpu).run(gprog, feed=gfeed,
                                          fetch_list=gnames,
                                          scope=fluid.Scope())
            wantg = fluid.Executor(cpu).run(gprog, feed=gfeed,
                                            fetch_list=gnames,
                                            scope=fluid.Scope())
            check(all(np.abs(w).max() > 0 for w in wantg),
                  'K2 %s: a gradient is all 0 on the CPU' % name)
            worst['grad'] = max(worst['grad'],
                                _ops_close('K2 %s grad' % name, got, wantg))
            n_grads += 1
        checked.add(case[0])
    checked |= phase_ops_random(card)
    check(sorted(checked) == sorted(OPS_LOWERINGS),
          'K2: checked %d lowerings, the slice registers %d: missing %s' %
          (len(checked), len(OPS_LOWERINGS),
           sorted(set(OPS_LOWERINGS) - checked)))
    print('K2: %d lowerings checked (the %d the slice registers), %d cases: '
          'card vs CPU forward worst %.3g, %d generic grads worst %.3g '
          '(rtol %g, atol %g x max(1, max|v|)), integer outputs exact; %d '
          'captured and replayed against eager, worst %.3g (tol %g); %.1f s '
          '[%s]' % (len(checked), len(OPS_LOWERINGS), len(ops_cases()),
                    worst['forward'], n_grads, worst['grad'], OPS_TOL['rtol'],
                    OPS_TOL['atol'], n_captured, worst['capture'],
                    CAPTURE_TOL, time.perf_counter() - t0, card), flush=True)


def _draw_stats(tag, x, mean, std, lo=-np.inf, hi=np.inf):
    """``x``'s draws in [lo, hi] with mean ``mean`` and standard deviation
    ``std`` within OPS_DRAW_TOL."""
    x = np.asarray(x, np.float64)
    got_mean, got_std = float(x.mean()), float(x.std())
    check(x.min() >= lo and x.max() <= hi and
          abs(got_mean - mean) <= OPS_DRAW_TOL and
          abs(got_std - std) <= OPS_DRAW_TOL,
          '%s: draws in [%g, %g], mean %.5f (want %.5f), std %.5f (want '
          '%.5f), tol %g, support [%g, %g]' %
          (tag, x.min(), x.max(), got_mean, mean, got_std, std,
           OPS_DRAW_TOL, lo, hi))
    return got_mean, got_std


def phase_ops_random(card):
    """K2's random ops, by distribution at 10^6 draws on the card and on
    the CPU: truncated_gaussian_random (support mean +- 2 std, the cut
    normal's standard deviation 0.8796 std), the ``*_batch_size_like``
    pair (the batch dim from Input), each captured with its replay drawing
    anew; random_crop captured, OPS_CROP_REPLAYS replays each a window of X
    whose starts cover every position.  Returns the op types checked."""
    import paddle_tpu_torch.fluid as fluid
    gpu, cpu = fluid.CUDAPlace(0), fluid.CPUPlace()
    rows, cols = OPS_DRAWS
    ref = ('ref', np.zeros((rows, 3), 'float32'))
    bsl = dict(shape=[1, cols], input_dim_idx=0, output_dim_idx=0, seed=0)
    cut_std = 0.8796256610342398  # a standard normal cut at +-2
    cases = {
        'truncated_gaussian_random': (
            {}, dict(shape=[rows, cols], mean=0.5, std=2.0, seed=0),
            (0.5, 2.0 * cut_std, -3.5, 4.5)),
        'uniform_random_batch_size_like': (
            {'Input': ref}, dict(bsl, min=-2.0, max=1.0),
            (-0.5, 3.0 / math.sqrt(12.0), -2.0, 1.0)),
        'gaussian_random_batch_size_like': (
            {'Input': ref}, dict(bsl, mean=1.0, std=0.5),
            (1.0, 0.5, -np.inf, np.inf)),
    }
    lines = []
    for op_type, (inputs, attrs, (mean, std, lo, hi)) in cases.items():
        prog, feed = one_op_program(fluid, op_type, inputs, {'Out': 'out'},
                                    attrs)
        prog.random_seed = SEED
        exe, scope = fluid.Executor(gpu), fluid.Scope()
        draws = [exe.run(prog, feed=feed, fetch_list=['out'],
                         scope=scope)[0] for _ in range(3)]
        block = exe.cached_blocks()[-1]
        check(block.mode == 'graph' and block.last_ran == 'replay',
              'K2 %s: the block ran %s (%s), last %s' %
              (op_type, block.mode, block.why, block.last_ran))
        check(not np.array_equal(draws[1], draws[2]),
              'K2 %s: a replay drew what the capture drew' % op_type)
        stats = [_draw_stats('K2 %s %s' % (op_type, which), d, mean, std,
                             lo, hi)
                 for which, d in zip(('eager', 'captured', 'replayed'),
                                     draws)]
        cpu_draw = fluid.Executor(cpu).run(prog, feed=feed,
                                           fetch_list=['out'],
                                           scope=fluid.Scope())[0]
        stats.append(_draw_stats('K2 %s CPU' % op_type, cpu_draw, mean, std,
                                 lo, hi))
        check(draws[0].shape == (rows, cols) and
              cpu_draw.shape == (rows, cols),
              'K2 %s: shapes %s / %s' % (op_type, draws[0].shape,
                                         cpu_draw.shape))
        lines.append('%s mean/std eager %.4f/%.4f, replay %.4f/%.4f, CPU '
                     '%.4f/%.4f (want %.4f/%.4f)' %
                     ((op_type, ) + stats[0] + stats[2] + stats[3] +
                      (mean, std)))
    x = np.arange(2 * 6 * 7, dtype='float32').reshape(2, 6, 7)
    prog, feed = one_op_program(fluid, 'random_crop', {'X': ('x', x)},
                                {'Out': 'out'}, {'shape': [3, 4]})
    prog.random_seed = SEED
    starts = {}
    for place in (gpu, cpu):
        exe, scope = fluid.Executor(place), fluid.Scope()
        seen = set()
        for _ in range(2 + OPS_CROP_REPLAYS):
            out, = exe.run(prog, feed=feed, fetch_list=['out'], scope=scope)
            r, c = int(out[0, 0, 0]) // 7, int(out[0, 0, 0]) % 7
            check(out.shape == (2, 3, 4) and
                  np.array_equal(out, x[:, r:r + 3, c:c + 4]),
                  'K2 random_crop: an output is no window of X')
            seen.add((r, c))
        starts[str(place)] = seen
        check({r for r, _ in seen} == set(range(4)) and
              {c for _, c in seen} == set(range(4)),
              'K2 random_crop on %s: starts %s do not cover [0, 3] in each '
              'dim' % (place, sorted(seen)))
        if place == gpu:
            block = exe.cached_blocks()[-1]
            check(block.mode == 'graph' and block.captures == 1 and
                  block.last_ran == 'replay',
                  'K2 random_crop: the block ran %s (%s), last %s' %
                  (block.mode, block.why, block.last_ran))
    print('K2 random ops, 10^6 draws each, tol %g: %s; random_crop %d calls '
          '(captured: %d replays) each a window of X, distinct starts %d on '
          'the card, %d on the CPU [%s]' %
          (OPS_DRAW_TOL, '; '.join(lines), 2 + OPS_CROP_REPLAYS,
           OPS_CROP_REPLAYS, len(starts[str(gpu)]), len(starts[str(cpu)]),
           card), flush=True)
    return set(cases) | {'random_crop'}


def phase_ops_transformer(card):
    """K1: Fluid's Transformer recipe in plain layers at G1's widths
    (``ops_transformer_programs(**OPS_TF)``), BATCH x 256, Adam at OPS_LR
    from a seed: one eager call, the capture and OPS_REPLAYS replays on one
    batch, with no hand-written kernel launched and a loss falling at every
    step; one 2 x 256 step against the CPU (TRAIN_TOL, G1's); the first
    layer's attention context against the port's ``flash_attention`` op
    (the f32 kernel) on its Q, K and V (TOL); one captured step under
    ``amp_guard()`` against an f32 step from one state
    (``AMP_SERVE_TOL['loss']``); the step captured against eager, timed,
    with memory_analysis against the capture's peak (OPS_MEMORY_RATIO).
    Returns the path's launch record."""
    import paddle_tpu_torch.fluid as fluid
    cfg = OPS_TF
    tag = 'K1 Transformer-base in plain layers'
    with fluid.unique_name.guard():
        model = ops_transformer_programs(fluid, **cfg)
    model, scope, exe = _started('%s %s' % (tag, cfg), model)
    main, loss = model['main'], model['loss'].name
    seq, vocab = cfg['seq'], cfg['vocab']
    rng = np.random.RandomState(SEED + 90)
    feed = ops_transformer_batch(rng, BATCH, seq, vocab)
    made = []
    path = _Path(tag, exe, 'f32').begin()
    fluid.FLAGS.cost_accounting = True
    try:
        for _ in range(2 + OPS_REPLAYS):
            made += path.call(lambda: exe.run(main, feed=feed,
                                              fetch_list=[loss],
                                              scope=scope), _expect())
    finally:
        fluid.FLAGS.cost_accounting = False
    path.end()
    check(path.wrapper == _expect(), '%s: hand-written kernels launched: %s'
          % (tag, path.wrapper))
    block = exe.cached_blocks()[-1]
    ran = [m[3] for m in made]
    check(block.mode == 'graph' and block.captures == 1 and
          ran.count('replay') >= OPS_REPLAYS,
          '%s: the block ran %s (%s), %d captures, calls %s' %
          (tag, block.mode, block.why, block.captures, ran))
    losses = [float(m[0][0][0]) for m in made]
    check(np.isfinite(losses).all() and
          all(b < a for a, b in zip(losses, losses[1:])),
          '%s: the loss did not fall at every step: %s' % (tag, losses))
    flops = _cost_per_step(exe, [loss])
    check(flops and min(flops) > 0, '%s: cost_report FLOPs %s' % (tag, flops))
    ops = collections.Counter(op.type for op in
                              model['test'].global_block().ops)
    print('%s: %d Adam steps (lr %g) on one batch, loss %s; launches %s; '
          'median replay wall %.4f s under torch.profiler; cost_report '
          'FLOPs a step %.4e; forward ops: transpose %d, reshape %d, '
          'matmul %d, label_smooth %d, reduce_mean %d [%s]' %
          (tag, len(made), OPS_LR, ' -> '.join('%.6f' % l for l in losses),
           path.summary(),
           statistics.median(m[1] for m in made if m[3] == 'replay'),
           flops[-1], ops['transpose'], ops['reshape'], ops['matmul'],
           ops['label_smooth'], ops['reduce_mean'], card), flush=True)
    small = ops_transformer_batch(rng, 2, seq, vocab)
    compare_train_step(card, tag, '2 x %d' % seq, main, loss, small, scope,
                       exe, OPS_LR)
    _ops_flash_check(card, tag, model, scope, feed)
    _ops_amp_step(card, tag, model, scope, feed)
    timed = phase_capture(card, tag + ' step', main, feed, [loss],
                          _persistables(main, scope), {},
                          calls=OPS_CAPTURE_CALLS)
    ratio = timed['memory']['capture_above'] / timed['memory']['temp']
    check(1.0 / OPS_MEMORY_RATIO <= ratio <= OPS_MEMORY_RATIO,
          '%s: the capture\'s peak above what was allocated before it is '
          '%.2fx memory_analysis\'s temp bytes (within %gx either way)' %
          (tag, ratio, OPS_MEMORY_RATIO))
    _book_record(card, tag + ' step', timed, flops[-1], path='K',
                 batch=BATCH, ms_eager=timed['eager']['wall'] * 1e3,
                 ms_captured=timed['captured']['wall'] * 1e3,
                 capture_over_temp=round(ratio, 3),
                 tflops_captured=flops[-1] / timed['captured']['wall'] / 1e12)
    path.exe = None  # the launch record outlives the path's executor
    del model, scope, exe, block
    _free()
    return path


def _ops_flash_check(card, tag, model, scope, feed):
    """The first layer's attention context from the plain layers against
    the port's ``flash_attention`` op on the same Q, K and V (the f32
    kernel, one launch), at the kernel's tolerance TOL."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    cfg = OPS_TF
    q, k, v, ctx = (var.name for var in model['attention'][0])
    exe = fluid.Executor(fluid.CUDAPlace(0))
    got = exe.run(model['test'], feed=feed, fetch_list=[q, k, v, ctx],
                  scope=scope)
    prog = fluid.Program()
    with fluid.program_guard(prog, fluid.Program()):
        qkv = [fluid.layers.data(name=n, shape=[cfg['seq'], cfg['d_model']],
                                 dtype='float32') for n in 'qkv']
        out = fluid.layers.flash_attention(*qkv, num_heads=cfg['n_head'])
    before = fa.LAUNCHES
    flash, = exe.run(prog, feed=dict(zip('qkv', got[:3])), fetch_list=[out],
                     scope=fluid.Scope())
    launched = fa.LAUNCHES - before
    tol = TOL[torch.float32]
    err = float(np.abs(flash - got[3]).max())
    check(launched == 1 and flash.shape == got[3].shape and
          np.allclose(flash, got[3], rtol=tol, atol=tol),
          '%s: the plain layers\' attention context against the flash '
          'kernel (%d launches): shapes %s / %s, max|d| %g (tol %g)' %
          (tag, launched, got[3].shape, flash.shape, err, tol))
    print('%s: layer 0 attention context (scaled_dot_product_attention in '
          'plain layers, %s) against the flash_attention op on its Q, K, V '
          '(%d f32 kernel launch, outside the path\'s counts): max|d| %.3g '
          '(tol %g) [%s]' % (tag, got[3].shape, launched, err, tol, card),
          flush=True)


def _ops_amp_step(card, tag, model, scope, feed):
    """One step from the scope's state in f32 (eager) and one captured
    under ``amp_guard()`` from the same state (its first call eager, the
    second the capture): the AMP loss finite and within
    ``AMP_SERVE_TOL['loss']`` of the f32 one."""
    import paddle_tpu_torch.fluid as fluid
    main, loss = model['main'], model['loss'].name
    state = _persistables(main, scope)
    exe, amp_scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    _load(amp_scope, state)
    f32, = eager_run(exe, main, feed, [loss], amp_scope)
    for _ in range(2):
        _load(amp_scope, state)
        amp, = amp_call(exe, main, feed, [loss], amp_scope)
    block = exe.cached_blocks()[-1]
    rel = float(abs(amp[0] - f32[0]) / abs(f32[0]))
    check(block.mode == 'graph' and block.last_ran == 'capture' and
          np.isfinite(amp).all() and rel <= AMP_SERVE_TOL['loss'],
          '%s: the AMP step ran %s (%s, last %s), loss %s against f32 %s '
          '(rel %g, tol %g)' % (tag, block.mode, block.why, block.last_ran,
                                amp, f32, rel, AMP_SERVE_TOL['loss']))
    print('%s: one captured step under amp_guard() from the f32 path\'s '
          'state: loss %.6f against f32 %.6f (rel %.3g, tol %g) [%s]' %
          (tag, amp[0], f32[0], rel, AMP_SERVE_TOL['loss'], card),
          flush=True)
    del exe, amp_scope, block
    torch.cuda.empty_cache()


def phase_ops_ctr(card):
    """K3: CTR at bench_ctr's widths, its test program with ``layers.auc``
    and ``layers.precision_recall`` (over [1 - p, p]) appended, on a
    CTR_BATCH-row request: the metrics on the card against the CPU from the
    same state, both forms captured, and OPS_CTR_CALLS requests of each
    timed (median wall)."""
    import paddle_tpu_torch.fluid as fluid
    tag = 'K3 ctr request with auc and precision_recall'
    model, scope, exe = build_ctr(is_sparse=True)
    test = model['test']
    metered = test.clone()
    with fluid.program_guard(metered, fluid.Program()):
        blk = metered.global_block()
        pred, label = blk.var(model['prediction'].name), blk.var('label')
        auc = fluid.layers.auc(input=pred, label=label)
        two = fluid.layers.concat([1.0 - pred, pred], axis=1)
        pr = fluid.layers.precision_recall(two, label, class_number=2)
    rng = np.random.RandomState(SEED + 91)
    feed = ctr_batch(rng)
    plain_fetch = [model['prediction'].name]
    fetch = plain_fetch + [auc.name, pr.name]
    forms = {'plain': (test, plain_fetch), 'metrics': (metered, fetch)}

    def call(form):
        prog, names = forms[form]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = exe.run(prog, feed=feed, fetch_list=names, scope=scope)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    _zero_counts()
    for form in forms:  # each form's eager call and its capture
        call(form)
        call(form)
        block = exe.cached_blocks()[-1]
        check(block.mode == 'graph' and block.last_ran == 'capture',
              '%s: the %s form ran %s (%s), last %s' %
              (tag, form, block.mode, block.why, block.last_ran))
    # replays in turns: plain, metrics, metrics, plain, ...
    walls = {form: [] for form in forms}
    for i in range(OPS_CTR_CALLS):
        for form in (('plain', 'metrics') if i % 2 == 0 else
                     ('metrics', 'plain')):
            out, wall = call(form)
            walls[form].append(wall)
            if form == 'metrics':
                got = out
    _no_launches(tag)
    check(all(b.mode == 'graph' and b.captures == 1 and b.replays
              for b in exe.cached_blocks()[-2:]),
          '%s: the forms\' blocks %s' %
          (tag, [(b.mode, b.captures, b.replays)
                 for b in exe.cached_blocks()[-2:]]))
    walls = {form: statistics.median(w) for form, w in walls.items()}
    want = fluid.Executor(fluid.CPUPlace()).run(
        metered, feed=feed, fetch_list=fetch,
        scope=_cpu_copy(metered, scope))
    err = _ops_close(tag, got[1:], want[1:])
    pred_err = float(np.linalg.norm(got[0] - want[0]) /
                     np.linalg.norm(want[0]))
    check(pred_err <= CTR_SERVE_RTOL and 0.0 <= got[1][0] <= 1.0,
          '%s: prediction |d| / |v| %g (tol %g), auc %s' %
          (tag, pred_err, CTR_SERVE_RTOL, got[1]))
    print('%s: %d rows; auc %.6f (CPU %.6f), precision/recall/F1 %s (CPU '
          '%s), card vs CPU worst %.3g (rtol %g); request wall median of %d '
          'replays each, in turns: %.5f s plain, %.5f s with the metrics '
          '(%+.5f s) [%s]' %
          (tag, CTR_BATCH, got[1][0], want[1][0],
           np.round(got[2], 6).tolist(), np.round(want[2], 6).tolist(), err,
           OPS_TOL['rtol'], OPS_CTR_CALLS, walls['plain'], walls['metrics'],
           walls['metrics'] - walls['plain'], card), flush=True)
    print('path K: %s' % json.dumps(dict(
        path='K', phase=tag, rows=CTR_BATCH, plain_s=walls['plain'],
        metrics_s=walls['metrics'], auc=float(got[1][0]),
        card=card)), flush=True)
    del model, scope, exe, test, metered, block
    _free()


def phase_ops(card):
    """Path K: the common tensor, shape, reduce, loss and metric ops.
    Returns K1's launch record."""
    t0 = time.perf_counter()
    _free()
    launches = phase_ops_transformer(card)
    _zero_counts()  # K2 and K3 run no hand-written kernel
    phase_ops_lowerings(card)
    phase_ops_ctr(card)
    _no_launches('path K2-K3')
    print('path K: %.1f s' % (time.perf_counter() - t0), flush=True)
    return launches


# ---- path L: data parallelism on torch.distributed ----
# L1: Transformer-base at G1's widths (bench.py:506-511), Adam at LR,
# dropout 0, PAR_STEPS steps of the global batch BATCH x 256 trained by
# PAR_RANKS ranks that share the card under gloo, each a subprocess of this
# script; rank 0 holds the steps against one Executor on the same global
# batches.  L2: the same model through a ParallelExecutor of world size 1
# on NCCL in this process, run_multi of PAR_K steps captured with its
# collectives.  L3: ResNet-50 (bench.py:347), Momentum, PAR_CV_BATCH images
# a rank against one Executor step at PAR_RANKS * PAR_CV_BATCH.
PAR_RANKS = 2
PAR_STEPS = 3
PAR_K = 4
PAR_CV_BATCH = 16
PAR_TIMEOUT = 900       # a rank's limit (s); a rank that ends later fails
PAR_TIMED = 3           # L2's timed run_multi blocks of each executor
# L1's gradient against the mean of one process's gradients on each rank's
# half of the batch: the same products and sums (the mean's 1/N_global is
# 1/(2 N_half), an exact halving), the halves added last by the
# all-reduce.  Measured bitwise, all 184 gradients at each step (NVIDIA
# H100 80GB HBM3, 700 W); the embeddings' scatter-adds may add in another
# order, hence not 0.  Against the whole batch the sums run in another
# order: the loss, the gradients and each parameter's largest change are
# held to G1's card-step bounds; the share of parameter
# elements beyond PARAM_ATOL is printed, not held: at 16 x 256 from a fresh
# start it was 2.6e-4-3.6e-3 (G1's PARAM_FRAC was set at 2 x 256).  The
# parameters each step left are held to PAR_UPDATE_TOL (a hundredth of
# the step Adam takes, about LR an element) against the program's update
# ops alone (``_update_program``) run by one Executor on the halves' mean
# gradient from the state the ranks started the step from: an update
# applied twice, or to a gradient before its all-reduce, moves them by
# about LR.  L2's losses and parameters are held bitwise to
# Executor.run_multi (the same captured ops; a one-rank all-reduce is a
# copy), as measured on the card.
PAR_HALVES_TOL = 1e-6
PAR_UPDATE_TOL = 1e-2 * LR


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _state_digest(program, scope):
    """A SHA-256 over the bytes of every persistable the scope holds, in
    name order: two ranks' replicas are equal iff their digests are."""
    import hashlib
    h = hashlib.sha256()
    for v in sorted(program.list_vars(), key=lambda v: v.name):
        var = scope.find_var(v.name) if v.persistable else None
        if var is not None and isinstance(var.value(), torch.Tensor):
            h.update(v.name.encode())
            h.update(var.value().detach().cpu().contiguous().view(
                torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _update_program(main, grads):
    """A clone of ``main`` holding only the ops after the last one that
    writes a gradient of ``grads``: the clip, the regularizers and the
    optimizer, run on gradients fed in."""
    ops = main.global_block().ops
    last = max(i for i, op in enumerate(ops)
               if set(grads).intersection(op.output_arg_names))
    update = main.clone()
    for i in reversed(range(last + 1)):
        update.global_block()._remove_op(i)
    return update


def _par_params_against(main, got, want, max_dp, frac=PARAM_FRAC):
    """The trainable parameters ``got[name]`` against ``want[name]``: (the
    largest |dp|, elements beyond PARAM_ATOL, elements); fails beyond
    ``max_dp`` or beyond ``frac`` of the elements (None: not held)."""
    worst, n_far, n_all = 0.0, 0, 0
    for p in main.all_parameters():
        if not p.trainable:
            continue
        d = (got[p.name].to(want[p.name].device) - want[p.name]).abs()
        worst = max(worst, float(d.max()))
        n_far += int((d > PARAM_ATOL).sum())
        n_all += d.numel()
    check(worst <= max_dp and (frac is None or n_far <= frac * n_all),
          'path L: parameters differ from the one-process run by up to %g '
          '(limit %g), %d of %d elements by more than %g (limit %s of them)'
          % (worst, max_dp, n_far, n_all, PARAM_ATOL, frac))
    return worst, n_far, n_all


def _scope_params(main, scope):
    return {p.name: scope.find_var(p.name).value()
            for p in main.all_parameters()}


def _host_state(program, scope):
    """Host copies of the program's persistable vars the scope holds."""
    return {n: v.cpu() for n, v in _persistables(program, scope).items()}


def _par_transformer_model(fluid):
    from paddle_tpu_torch.models import transformer
    cfg = TRANSFORMER_BASE
    with fluid.unique_name.guard():
        return transformer.build(dropout=0.0, lr=LR, **cfg)


def _par_token_feeds(seed, n):
    cfg = TRANSFORMER_BASE
    rng = np.random.RandomState(seed)
    return [{k: rng.randint(1, cfg['trg_vocab'], size=(
        BATCH, cfg['max_len'])).astype('int64')
        for k in ('src_ids', 'trg_ids', 'lbl_ids')} for _ in range(n)]


def _par_grads_against(names, got, want):
    """Gradients ``got`` against ``want`` (host arrays, in ``names``'
    order) at TRAIN_TOL's gradient bounds, G1's: each max|dg| within
    GRAD_RTOL of its own max|g| plus GRAD_ATOL of the largest, and |dg| /
    |g| over all within GRAD_NORM_TOL.  Returns (the worst max|dg| over its
    allowance, |dg| / |g| over all)."""
    top = max(float(np.abs(w).max()) for w in want)
    worst, diff_sq, norm_sq = 0.0, 0.0, 0.0
    for name, g, w in zip(names, got, want):
        err = float(np.abs(g - w).max())
        allowed = GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL * top
        worst = max(worst, err / allowed)
        diff_sq += float(np.square(g - w, dtype=np.float64).sum())
        norm_sq += float(np.square(w, dtype=np.float64).sum())
    return worst, math.sqrt(diff_sq / norm_sq)


def _par_far_params(main, got, want, top=3):
    """The parameters with the most elements beyond PARAM_ATOL of
    ``want``: [(name, count)], the largest counts first."""
    far = [(p.name, int(((got[p.name].to(want[p.name].device) -
                         want[p.name]).abs() > PARAM_ATOL).sum()))
           for p in main.all_parameters() if p.trainable]
    return sorted(far, key=lambda x: -x[1])[:top]


def par_rank_transformer(card, rank):
    """L1 on one rank: every rank fed the same global batches, rank 1
    started from other weights (``bcast_params`` gives it rank 0's).
    Returns its record; rank 0's holds the one-process comparisons: after
    the steps, each step again by one Executor from the state the ranks
    started it from (host copies), on the whole batch (its loss, every
    parameter's gradient and the parameters it left) and on each rank's
    half alone: the ranks' gradient is the mean of the halves' (the same
    products and sums, the halves added last), the whole batch's another
    order of the sums.  (Run free for several steps, two summation orders
    drift apart wherever Adam divides a gradient of rounding noise by its
    own size.)"""
    import paddle_tpu_torch.fluid as fluid
    model = _par_transformer_model(fluid)
    model['startup'].random_seed = SEED + rank
    scope = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(model['startup'], scope=scope)
    main, loss = model['main'], model['loss'].name
    grads = [p.name + '@GRAD' for p in main.all_parameters() if p.trainable]
    feeds = _par_token_feeds(SEED + 40, PAR_STEPS)
    _zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pe = fluid.ParallelExecutor(use_cuda=True, loss_name=loss,
                                main_program=main, scope=scope)
    bcast_s = time.perf_counter() - t0
    digest0 = _state_digest(main, scope)
    snaps = [_host_state(main, scope)] if rank == 0 else None
    losses, walls, shares, got_grads = [], [], [], []
    for feed in feeds:
        s0 = pe.dp.seconds
        torch.cuda.synchronize()
        # the ranks start each timed step together (rank 0 copies its
        # state to the host after each)
        torch.distributed.barrier()
        t0 = time.perf_counter()
        got = pe.run([loss] + grads, feed=feed)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        shares.append((pe.dp.seconds - s0) / walls[-1])
        losses.append(float(got[0][0]))
        if rank == 0:
            snaps.append(_host_state(main, scope))
            got_grads.append(got[1:])
    launches = _wrapper_counts()
    block = pe.cached_blocks()[-1]
    rec = dict(losses=losses, walls=walls, shares=shares, launches=launches,
               bcast_s=bcast_s, mode=block.mode, why=block.why,
               peak_mib=torch.cuda.max_memory_allocated() / 2**20,
               start=digest0, end=_state_digest(main, scope),
               collectives=pe.dp.calls, bytes=pe.dp.bytes)
    del pe
    if rank == 0:
        ref_scope = fluid.Scope()
        ref = fluid.Executor(fluid.CUDAPlace(0))
        update = _update_program(main, grads)
        half = BATCH // 2
        cmp = []
        for i, feed in enumerate(feeds):
            runs = []
            for f in (feed, {n: v[:half] for n, v in feed.items()},
                      {n: v[half:] for n, v in feed.items()}):
                _load(ref_scope, {n: v.cuda() for n, v in snaps[i].items()})
                out = ref.run(main, feed=f, fetch_list=[loss] + grads,
                              scope=ref_scope)
                runs.append((float(out[0][0]), out[1:],
                             {n: t.clone() for n, t in _scope_params(
                                 main, ref_scope).items()}))
            (w_loss, w_grads, w_params), (_, a, _), (_, b, _) = runs
            halves = [(x + y) * np.float32(0.5) for x, y in zip(a, b)]
            _load(ref_scope, {n: v.cuda() for n, v in snaps[i].items()})
            ref.run(update, feed=dict(zip(grads, halves)), scope=ref_scope)
            stepped = _scope_params(main, ref_scope)
            c = dict(loss_rel=abs(losses[i] - w_loss) / abs(w_loss),
                     want=w_loss,
                     grads=_par_grads_against(grads, got_grads[i], w_grads),
                     params=_par_params_against(main, snaps[i + 1],
                                                w_params, LR, frac=None),
                     far=_par_far_params(main, snaps[i + 1], w_params),
                     update=_par_params_against(main, snaps[i + 1], stepped,
                                                PAR_UPDATE_TOL, frac=None),
                     update_bitwise=sum(int(torch.equal(
                         snaps[i + 1][p.name].cuda(), stepped[p.name]))
                         for p in main.all_parameters() if p.trainable),
                     halves=_par_grads_against(grads, got_grads[i], halves),
                     halves_bitwise=sum(int(np.array_equal(g, h)) for g, h
                                        in zip(got_grads[i], halves)))
            print('L1 step %d against one process: %s' % (i + 1, json.dumps(
                c)), flush=True)
            cmp.append(c)
            check(c['loss_rel'] <= SLICE_RTOL and c['grads'][0] <= 1.0 and
                  c['grads'][1] <= GRAD_NORM_TOL and
                  c['halves'][1] <= PAR_HALVES_TOL,
                  'L1 step %d: loss rel %g (tol %g); against the whole '
                  'batch the worst gradient %g of its allowance, |dg| / |g| '
                  'over all %g (tol %g); against the halves\' mean |dg| / '
                  '|g| %g (tol %g)' %
                  (i + 1, c['loss_rel'], SLICE_RTOL, c['grads'][0],
                   c['grads'][1], GRAD_NORM_TOL, c['halves'][1],
                   PAR_HALVES_TOL))
        rec.update(cmp=cmp)
        del ref, ref_scope, snaps
    del scope
    _free()
    return rec


def par_rank_resnet(card, rank):
    """L3 on one rank: one Momentum step of ResNet-50 on this rank's
    PAR_CV_BATCH of the global batch; rank 0 holds the loss, the fc head's
    gradients and every batch-norm running statistic against one Executor
    step on the whole batch."""
    import paddle_tpu_torch.fluid as fluid
    model, scope, exe = build_cv_model('resnet', lr=CV_LR, **RESNET50)
    main, loss = model['main'], model['loss'].name
    rng = np.random.RandomState(SEED + 41)
    feed = image_batch(rng, PAR_RANKS * PAR_CV_BATCH,
                       RESNET50['image_shape'], RESNET50['class_dim'])
    head = [p.name for p in main.all_parameters()][-2:]
    stats = sorted(n for op in main.global_block().ops
                   if op.type == 'batch_norm'
                   for n in op.input('Mean') + op.input('Variance'))
    fetch = [loss] + [p + '@GRAD' for p in head]
    start = _persistables(main, scope) if rank == 0 else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pe = fluid.ParallelExecutor(use_cuda=True, loss_name=loss,
                                main_program=main, scope=scope)
    s0 = pe.dp.seconds
    t0 = time.perf_counter()
    got = pe.run(fetch, feed=feed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec = dict(loss=float(got[0][0]), wall=wall,
               share=(pe.dp.seconds - s0) / wall,
               peak_mib=torch.cuda.max_memory_allocated() / 2**20,
               end=_state_digest(main, scope), n_stats=len(stats))
    if rank == 0:
        tol = CV_TRAIN_TOL['resnet50']
        ref_scope = fluid.Scope()
        _load(ref_scope, start)
        want = fluid.Executor(fluid.CUDAPlace(0)).run(
            main, feed=feed, fetch_list=fetch, scope=ref_scope)
        loss_rel = abs(got[0][0] - want[0][0]) / abs(want[0][0])
        grad = max(float(np.linalg.norm(g - w) / np.linalg.norm(w))
                   for g, w in zip(got[1:], want[1:]))
        value = lambda s, n: s.find_var(n).value().double()
        stat = max(float((value(scope, n) - value(ref_scope, n)).norm() /
                         value(ref_scope, n).norm().clamp_min(1e-30))
                   for n in stats)
        check(loss_rel <= tol['loss'] and grad <= tol['grad_norm'] and
              stat <= tol['stats'],
              'L3: against one process at %d images: loss rel %g (tol %g), '
              'fc head |dg| / |g| %g (tol %g), running statistics |d| / |v| '
              '%g (tol %g)' % (PAR_RANKS * PAR_CV_BATCH, loss_rel,
                               tol['loss'], grad, tol['grad_norm'], stat,
                               tol['stats']))
        rec.update(want=float(want[0][0]), loss_rel=float(loss_rel),
                   head_grad=grad, stats=stat)
    del pe, scope, exe
    _free()
    return rec


def parallel_rank(rank, port, workdir):
    """One rank of paths L1 and L3 (this script run with
    ``--parallel-rank``): gloo between the ranks that share the card;
    writes its records to ``workdir``."""
    import torch.distributed as dist
    from paddle_tpu_torch.parallel import init_distributed_env
    card = phase_device()
    sys.path.insert(0, REPO)
    init_distributed_env('localhost:%d' % port, PAR_RANKS, rank,
                         backend='gloo')
    out = {'L1': par_rank_transformer(card, rank),
           'L3': par_rank_resnet(card, rank)}
    dist.destroy_process_group()
    with open(os.path.join(workdir, 'rank%d.json' % rank), 'w') as f:
        json.dump(out, f)


def _par_ranks(card):
    """L1 and L3: PAR_RANKS subprocesses of this script, each under
    PAR_TIMEOUT; a rank that fails or times out fails the run.  Returns
    the ranks' records."""
    import tempfile
    workdir = tempfile.mkdtemp(prefix='chip_smoke_parallel_')
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), '--parallel-rank',
         str(r), '--parallel-port', str(port), '--parallel-dir', workdir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(PAR_RANKS)]
    logs = [None] * PAR_RANKS
    try:
        with concurrent.futures.ThreadPoolExecutor(PAR_RANKS) as pool:
            futures = [pool.submit(p.communicate, timeout=PAR_TIMEOUT)
                       for p in procs]
            for r, fut in enumerate(futures):
                try:
                    logs[r] = fut.result()[0]
                except subprocess.TimeoutExpired:
                    for p in procs:
                        p.kill()
                    fail('path L: rank %d did not end within %d s' %
                         (r, PAR_TIMEOUT))
    finally:
        for p in procs:
            p.kill()
    for r, log in enumerate(logs):
        for line in (log or '').splitlines():
            if not line.startswith(card):
                print('path L rank %d | %s' % (r, line), flush=True)
    for r, p in enumerate(procs):
        check(p.returncode == 0, 'path L: rank %d exited %s' %
              (r, p.returncode))
    recs = []
    for r in range(PAR_RANKS):
        with open(os.path.join(workdir, 'rank%d.json' % r)) as f:
            recs.append(json.load(f))
    return recs


class _Launches(object):
    """A path's launch counts for the kernels line: ``wrapper`` (the
    wrappers' counters over the path) and ``device`` (kernels counted on
    the card by name)."""

    def __init__(self, wrapper, device):
        self.wrapper, self.device = wrapper, device


def par_nccl(card):
    """L2: Transformer-base through a ParallelExecutor of world size 1 on
    NCCL: run_multi of PAR_K steps, eager then captured with the
    collectives inside the graph, then a block of replays under
    torch.profiler; the losses and parameters against Executor.run_multi
    over the same batches from the same state; both captured steps timed.
    The Executor is fed the all-ones sample mask that the
    ParallelExecutor adds, so that both take the masked mean.  Returns
    (wrapper counts, device counts)."""
    import torch.distributed as dist
    import paddle_tpu_torch.fluid as fluid
    dist.init_process_group('nccl', init_method='tcp://localhost:%d' %
                            _free_port(), world_size=1, rank=0)
    try:
        model, scope, exe = _started('L2 Transformer-base',
                                     _par_transformer_model(fluid))
        main, loss = model['main'], model['loss'].name
        start = _persistables(main, scope)
        blocks = [_par_token_feeds(SEED + 42 + i, PAR_K) for i in range(2)]
        n_flash = 3 * TRANSFORMER_BASE['n_layer']
        step = _expect(fwd=2 * n_flash, dq=n_flash, dkv=n_flash)
        _zero_counts()
        pe = fluid.ParallelExecutor(use_cuda=True, loss_name=loss,
                                    main_program=main, scope=scope)
        first, = pe.run_multi([loss], feed_list=blocks[0])
        lowered = _wrapper_counts()
        check(lowered == {k: 2 * v for k, v in step.items()},
              'L2: the eager step and the capture launched %s, expected '
              'twice %s' % (lowered, step))
        calls = pe.dp.calls
        with _profiled() as session:
            t0 = time.perf_counter()
            last, = pe.run_multi([loss], feed_list=blocks[1])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        seen, device, _ = _device_kernels(session.prof)
        nccl = [e for e in session.prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA and
                'nccl' in e.name.lower()]
        nccl_ms = sum(e.time_range.elapsed_us() for e in nccl) / 1e3
        block = pe.cached_blocks()[-1]
        check(block.mode == 'graph' and block.captures == 1 and
              block.replays >= 2 * PAR_K - 2 and pe.dp.calls == calls and
              pe.dp.captured > 0 and _wrapper_counts() == lowered and
              seen == {k: PAR_K * v for k, v in step.items()},
              'L2: block %s (%s), %d captures, %d replays; collectives '
              'captured %d, run eagerly in the replays %d; wrappers %s; on '
              'the card %s' %
              (block.mode, block.why, block.captures, block.replays,
               pe.dp.captured, pe.dp.calls - calls, _wrapper_counts(),
               seen))
        from paddle_tpu_torch.ops import registry
        ones = np.ones((BATCH, ), 'float32')
        masked = [[dict(f, **{registry.SAMPLE_MASK_NAME: ones}) for f in b]
                  for b in blocks]
        ref_scope = fluid.Scope()
        _load(ref_scope, start)
        ref = fluid.Executor(fluid.CUDAPlace(0))
        want = [ref.run_multi(main, feed_list=b, fetch_list=[loss],
                              scope=ref_scope)[0] for b in masked]
        got = [first, last]
        rel = max(float(abs(g[0] - w[0]) / abs(w[0]))
                  for g, w in zip(got, want))
        bitwise = all(np.array_equal(g, w) for g, w in zip(got, want))
        check(rel <= SLICE_RTOL, 'L2: losses %s against Executor.run_multi '
              '%s (rel %g, tol %g)' % (got, want, rel, SLICE_RTOL))
        check(bitwise, 'L2: losses %s, Executor.run_multi\'s %s: not '
              'bitwise' % (got, want))
        params = _par_params_against(
            main, _scope_params(main, scope), _scope_params(main, ref_scope),
            0.0, frac=None)

        def timed(run):
            ms = []
            for b in range(PAR_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(b % 2)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3 / PAR_K)
            return statistics.median(ms), ms

        pe_ms = timed(lambda i: pe.run_multi([loss], feed_list=blocks[i]))
        exe_ms = timed(lambda i: ref.run_multi(
            main, feed_list=masked[i], fetch_list=[loss], scope=ref_scope))
        print('path L: %s' % json.dumps({
            'part': 'L2', 'backend': 'nccl', 'world': 1,
            'captures': block.captures, 'replays': block.replays,
            'collectives_eager': calls - pe.dp.captured,
            'collectives_captured': pe.dp.captured,
            'nccl_kernels_a_block': len(nccl),
            'nccl_ms_a_block': nccl_ms, 'profiled_block_s': wall,
            'loss_rel': rel, 'losses_bitwise': bitwise,
            'params_bitwise': params[0] == 0.0, 'param_max_dp': params[0],
            'param_far': params[1], 'param_elements': params[2],
            'captured_ms_a_step': pe_ms[0], 'captured_ms': pe_ms[1],
            'executor_captured_ms_a_step': exe_ms[0],
            'executor_ms': exe_ms[1],
            'peak_mib': torch.cuda.max_memory_allocated() / 2**20,
            'card': card}), flush=True)
        device_counts = seen
        del pe, ref, scope, ref_scope, exe, start
        return lowered, device_counts
    finally:
        dist.destroy_process_group()
        _free()


def phase_parallel(card):
    """Path L: data parallelism on torch.distributed.  Returns its launch
    record (``parallel`` in the kernels line): the wrappers' counts over
    L1's ranks and L2, and the kernels counted on the card in L2's
    profiled block of replays."""
    t0 = time.perf_counter()
    _free()
    recs = _par_ranks(card)
    n_flash = 3 * TRANSFORMER_BASE['n_layer']
    step = _expect(fwd=2 * n_flash, dq=n_flash, dkv=n_flash)
    wrapper = _expect()
    for r, rec in enumerate(recs):
        l1 = rec['L1']
        check(l1['launches'] == {k: PAR_STEPS * v for k, v in step.items()},
              'L1: rank %d launched %s, expected %d steps of %s' %
              (r, l1['launches'], PAR_STEPS, step))
        check(l1['mode'] == 'eager' and 'gloo' in (l1['why'] or ''),
              'L1: rank %d ran its block %s (%s)' % (r, l1['mode'],
                                                    l1['why']))
        for k in KERNEL_KEYS:
            wrapper[k] += l1['launches'][k]
    l1, l3 = recs[0]['L1'], recs[0]['L3']
    check(all(rec['L1']['start'] == l1['start'] and
              rec['L1']['end'] == l1['end'] and
              rec['L3']['end'] == l3['end'] for rec in recs),
          'path L: the ranks\' replicas differ (start %s, end %s, L3 %s)' %
          ([rec['L1']['start'][:12] for rec in recs],
           [rec['L1']['end'][:12] for rec in recs],
           [rec['L3']['end'][:12] for rec in recs]))
    for r, rec in enumerate(recs):
        print('path L: %s' % json.dumps({
            'part': 'L1', 'rank': r, 'backend': 'gloo',
            'ranks': PAR_RANKS, 'global_batch': [BATCH,
                                                 TRANSFORMER_BASE['max_len']],
            'losses': rec['L1']['losses'], 'step_s': rec['L1']['walls'],
            'allreduce_share': rec['L1']['shares'],
            'bcast_params_s': rec['L1']['bcast_s'],
            'collectives': rec['L1']['collectives'],
            'collective_bytes': rec['L1']['bytes'],
            'launches': {k: v for k, v in rec['L1']['launches'].items()
                         if v},
            'block': '%s (%s)' % (rec['L1']['mode'], rec['L1']['why']),
            'peak_mib': rec['L1']['peak_mib'], 'card': card}), flush=True)
    print('path L: %s' % json.dumps({
        'part': 'L1', 'against': 'one Executor on the global batches, each '
        'step from the state the ranks started it from',
        'want': [c['want'] for c in l1['cmp']],
        'loss_rel': [c['loss_rel'] for c in l1['cmp']],
        'grad_allowance': [c['grads'][0] for c in l1['cmp']],
        'grad_rel': [c['grads'][1] for c in l1['cmp']],
        'param_max_dp': [c['params'][0] for c in l1['cmp']],
        'param_far': [c['params'][1] for c in l1['cmp']],
        'param_elements': l1['cmp'][0]['params'][2],
        'halves_grad_rel': [c['halves'][1] for c in l1['cmp']],
        'halves_bitwise_grads': [c['halves_bitwise'] for c in l1['cmp']],
        'update_max_dp': [c['update'][0] for c in l1['cmp']],
        'update_tol': PAR_UPDATE_TOL,
        'update_bitwise_params': [c['update_bitwise'] for c in l1['cmp']],
        'replicas_equal': True, 'card': card}), flush=True)
    print('path L: %s' % json.dumps({
        'part': 'L3', 'ranks': PAR_RANKS, 'images_a_rank': PAR_CV_BATCH,
        'loss': l3['loss'], 'want': l3['want'], 'loss_rel': l3['loss_rel'],
        'fc_head_grad_rel': l3['head_grad'],
        'running_stats_rel': l3['stats'], 'running_stats': l3['n_stats'],
        'step_s': [rec['L3']['wall'] for rec in recs],
        'allreduce_share': [rec['L3']['share'] for rec in recs],
        'peak_mib': [rec['L3']['peak_mib'] for rec in recs],
        'card': card}), flush=True)
    lowered, device = par_nccl(card)
    for k in KERNEL_KEYS:
        wrapper[k] += lowered[k]
    print('path L: %.1f s' % (time.perf_counter() - t0), flush=True)
    return _Launches(wrapper, device)


# ---- path M: the detection family, MobileNet-SSD 300 ----
# M1: MobileNet-SSD as PaddlePaddle models' fluid/object_detection/
# mobilenet_ssd.py builds it (``mobilenet_ssd_programs``: scale 1.0, 300 x
# 300, 21 VOC classes, 1917 priors over the 19^2 ... 1^2 maps),
# reduce_sum(ssd_loss), RMSProp at SSD_LR with L2Decay(SSD_L2), on
# SSD_BATCH seeded images each with 1 to SSD_MAX_GT boxes (labels 1-20, a
# tenth difficult) as LoD feeds.  M2: its test program (``clone(
# for_test=True)``) with ``detection_output`` (NMS at SSD_NMS_THRESHOLD)
# and an accumulating 11-point ``detection_map`` over SSD_EVAL_BATCHES
# batches, eager (host ops).  M3: the RPN stages at a Faster R-CNN
# stride-16 map of a 600 x 800 image (RPN).
SSD = dict(scale=1.0, size=300, num_classes=21)
SSD_LR, SSD_L2 = 1e-3, 5e-5
SSD_RMSPROP_RHO = 0.95  # fluid.optimizer.RMSProp's default decay
SSD_BATCH = 32
SSD_CPU_BATCH = 8       # M1's step against the CPU
SSD_STEPS = 5           # M1's profiled steps: eager, capture, 3 replays
SSD_CAPTURE_CALLS = 10  # M1's timed calls of each path, eager and captured
SSD_MAX_GT = 8
SSD_EVAL_BATCHES = 4
SSD_EVAL_CPU_IMAGES = 4  # M2's images run on the CPU too
SSD_NMS_THRESHOLD = 0.45
# M1's step against the CPU: the loss, gradients and batch-norm statistics
# at ResNet-50's card-step bounds (CV_TRAIN_TOL: depthwise convolutions and
# 35 batch norms over 8 images, f32 sums in other orders).  The parameters:
# RMSProp's first step from a zero mean square moves an element by lr g /
# sqrt((1 - rho) g^2), up to lr / sqrt(1 - rho) whatever the size of g, so
# a gradient of rounding noise may move it that far either way on each side
# (param_max, twice that); at most param_frac of the elements beyond lr /
# 10, as VGG-16's Adam step is held.
SSD_TRAIN_TOL = dict(CV_TRAIN_TOL['resnet50'],
                     param_max=2 * SSD_LR / math.sqrt(1 - SSD_RMSPROP_RHO),
                     param_atol=SSD_LR / 10)
# Faster R-CNN's RPN on a 600 x 800 image (the reference's
# rpn_target_assign and generate_proposals defaults): a stride-16 map of
# 38 x 50 cells, 5 sizes x 3 ratios = 15 anchors a cell, 2 images with 1
# to RPN_MAX_GT boxes, 81 COCO classes for generate_proposal_labels
RPN = dict(image=(600, 800), stride=16.0,
           sizes=[32.0, 64.0, 128.0, 256.0, 512.0], ratios=[0.5, 1.0, 2.0],
           images=2, class_nums=81)
RPN_MAX_GT = 8


def mobilenet_ssd_programs(fluid, scale=1.0, size=300, num_classes=21,
                           lr=SSD_LR, l2=SSD_L2):
    """MobileNet-SSD (PaddlePaddle models, fluid/object_detection/
    mobilenet_ssd.py, at ``scale``): ``conv_bn`` 32/2, depthwise-separable
    blocks 64, 128/2, 128, 256/2, 256, 512/2, 5 x 512, 1024/2, 1024, extra
    blocks 256->512, 128->256, 128->256, 64->128, each /2; every conv
    without bias, MSRA-uniform, at a tenth of the learning rate, under a
    ReLU batch norm; ``multi_box_head`` over the 19^2 ... 1^2 maps (at 300)
    with min sizes 60-285 and max sizes 150-300 (in proportion at another
    ``size``), ratios [2] then [2, 3], flip, offset 0.5.  The main program
    trains reduce_sum(ssd_loss) with RMSProp at ``lr`` and L2Decay(``l2``);
    the test program is its ``clone(for_test=True)`` with
    ``detection_output`` (NMS at SSD_NMS_THRESHOLD) and an 11-point
    ``detection_map`` (overlap 0.5, difficult boxes not evaluated) that
    accumulates its state in three persistable vars while ``has_state`` is
    fed 1."""
    L = fluid.layers

    def conv_bn(x, filter_size, num_filters, stride, padding, groups=1):
        fan_in = int(x.shape[1]) // groups * filter_size * filter_size
        limit = math.sqrt(6.0 / fan_in)
        conv = L.conv2d(x, num_filters=num_filters, filter_size=filter_size,
                        stride=stride, padding=padding, groups=groups,
                        param_attr=fluid.ParamAttr(
                            learning_rate=0.1,
                            initializer=fluid.initializer.Uniform(-limit,
                                                                  limit)),
                        bias_attr=False)
        return L.batch_norm(conv, act='relu')

    def separable(x, f1, f2, stride):
        dw = conv_bn(x, 3, int(f1 * scale), stride, 1,
                     groups=int(f1 * scale))
        return conv_bn(dw, 1, int(f2 * scale), 1, 0)

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        image = L.data(name='image', shape=[3, size, size], dtype='float32')
        gt_box = L.data(name='gt_box', shape=[4], dtype='float32',
                        lod_level=1)
        gt_label = L.data(name='gt_label', shape=[1], dtype='int32',
                          lod_level=1)
        x = conv_bn(image, 3, int(32 * scale), 2, 1)
        for f1, f2, stride in ((32, 64, 1), (64, 128, 2), (128, 128, 1),
                               (128, 256, 2), (256, 256, 1), (256, 512, 2)) \
                + ((512, 512, 1), ) * 5:
            x = separable(x, f1, f2, stride)
        maps = [x]
        maps.append(separable(separable(x, 512, 1024, 2), 1024, 1024, 1))
        for f1, f2 in ((256, 512), (128, 256), (128, 256), (64, 128)):
            maps.append(conv_bn(conv_bn(maps[-1], 1, int(f1 * scale), 1, 0),
                                3, int(f2 * scale), 2, 1))
        k = size / 300.0
        locs, confs, box, box_var = L.multi_box_head(
            inputs=maps, image=image, base_size=size,
            num_classes=num_classes, min_ratio=20, max_ratio=90,
            min_sizes=[k * s for s in (60.0, 105.0, 150.0, 195.0, 240.0,
                                       285.0)],
            max_sizes=[[]] + [k * s for s in (150.0, 195.0, 240.0, 285.0,
                                              300.0)],
            aspect_ratios=[[2.0]] + [[2.0, 3.0]] * 5, offset=0.5, flip=True)
        loss = L.reduce_sum(L.ssd_loss(locs, confs, gt_box, gt_label, box,
                                       box_var))
        test = main.clone(for_test=True)
        fluid.optimizer.RMSProp(
            learning_rate=lr,
            regularization=fluid.regularizer.L2Decay(l2)).minimize(loss)
    with fluid.program_guard(test, fluid.Program()):
        blk = test.global_block()
        nmsed = L.detection_output(*(blk.var(v.name) for v in (
            locs, confs, box, box_var)), nms_threshold=SSD_NMS_THRESHOLD)
        difficult = L.data(name='gt_difficult', shape=[1], dtype='int32',
                           lod_level=1)
        label = L.concat([L.cast(blk.var(gt_label.name), 'float32'),
                          blk.var(gt_box.name), L.cast(difficult, 'float32')],
                         axis=-1)
        has_state = L.data(name='has_state', shape=[1], dtype='int32',
                           append_batch_size=False)
        states = [blk.create_var(name='map_accum_' + n, persistable=True)
                  for n in ('pos_count', 'true_pos', 'false_pos')]
        m_ap = L.detection_map(nmsed, label, num_classes, background_label=0,
                               overlap_threshold=0.5,
                               evaluate_difficult=False, has_state=has_state,
                               input_states=states, out_states=states,
                               ap_version='11point')
    return dict(main=main, startup=startup, test=test, loss=loss, locs=locs,
                confs=confs, nmsed=nmsed, map=m_ap,
                states=[s.name for s in states],
                feeds=['image', 'gt_box', 'gt_label'])


def lod_tensor(fluid, rows, dtype):
    """A one-level LoD tensor of ``fluid``'s package from per-sequence
    [n, d] arrays."""
    lt = fluid.core.LoDTensor(np.concatenate(rows).astype(dtype))
    lt.set_recursive_sequence_lengths([[len(r) for r in rows]])
    return lt


def ssd_batch(fluid, rng, batch, size=300, num_classes=21,
              max_gt=SSD_MAX_GT):
    """``batch`` seeded images, each with 1 to ``max_gt`` normalized boxes
    (labels 1 to num_classes - 1, a tenth difficult): (the feed of every
    data var of ``mobilenet_ssd_programs`` but ``has_state``, the rows of
    each image's ``detection_map`` label [label, box, difficult])."""
    image = rng.standard_normal((batch, 3, size, size)).astype('float32')
    boxes, labels, difficult = [], [], []
    for n in rng.randint(1, max_gt + 1, batch):
        centre = rng.uniform(0.15, 0.85, (n, 2))
        half = rng.uniform(0.05, 0.25, (n, 2))
        boxes.append(np.clip(np.concatenate([centre - half, centre + half],
                                            1), 0.0, 1.0).astype('float32'))
        labels.append(rng.randint(1, num_classes, (n, 1)).astype('int32'))
        difficult.append((rng.rand(n, 1) < 0.1).astype('int32'))
    rows = [np.concatenate([l.astype('float32'), b, d.astype('float32')], 1)
            for b, l, d in zip(boxes, labels, difficult)]
    return {'image': image, 'gt_box': lod_tensor(fluid, boxes, 'float32'),
            'gt_label': lod_tensor(fluid, labels, 'int32'),
            'gt_difficult': lod_tensor(fluid, difficult, 'int32')}, rows


def ssd_host_program(fluid, test, shapes):
    """The host ops of ``mobilenet_ssd_programs``' test program alone, fed
    the arrays they read there (``bboxes`` and ``scores`` of ``shapes``,
    the label rows as a LoD feed, ``has_state``), with the same attrs and
    their own state vars."""
    L = fluid.layers
    ops = {op.type: op for op in test.global_block().ops}
    nms, dmap = ops['multiclass_nms'], ops['detection_map']
    prog = fluid.Program()
    with fluid.program_guard(prog, fluid.Program()):
        bboxes = L.data(name='bboxes', shape=list(shapes[0][1:]),
                        dtype='float32')
        scores = L.data(name='scores', shape=list(shapes[1][1:]),
                        dtype='float32')
        label = L.data(name='label', shape=[6], dtype='float32', lod_level=1)
        has_state = L.data(name='has_state', shape=[1], dtype='int32',
                           append_batch_size=False)
        states = [prog.global_block().create_var(
            name='host_' + n, persistable=True) for n in dmap.output(
                'AccumPosCount') + dmap.output('AccumTruePos') +
            dmap.output('AccumFalsePos')]
        out = L.multiclass_nms(bboxes, scores, score_threshold=0.0,
                               nms_top_k=0, keep_top_k=0)
        m_ap = L.detection_map(out, label, 0, has_state=has_state,
                               input_states=states, out_states=states)
    for op in prog.global_block().ops:
        op.attrs.update(nms.attrs if op.type == 'multiclass_nms' else
                        dmap.attrs)
    return dict(program=prog, nmsed=out, map=m_ap,
                states=[s.name for s in states])


def rpn_programs(fluid, cfg=RPN):
    """Faster R-CNN's RPN stages (``cfg``): ``anchor_generator`` on a
    [N, 8, H / 16, W / 16] map; ``generate_proposals`` over the fed scores
    and deltas (the reference's defaults: pre-NMS top 6000, post-NMS top
    1000, NMS at 0.7); ``rpn_target_assign`` of the anchors against the
    LoD ground truth (256 a image, a quarter positive, with ``fix_seed``);
    ``generate_proposal_labels`` of the proposals (512 RoIs a image at a
    quarter foreground, without random sampling, ``class_nums``)."""
    L = fluid.layers
    h, w = cfg['image']
    fh, fw = (int(math.ceil(s / cfg['stride'])) for s in (h, w))
    na = len(cfg['sizes']) * len(cfg['ratios'])
    prog = fluid.Program()
    with fluid.program_guard(prog, fluid.Program()):
        feat = L.data(name='rpn_feat', shape=[8, fh, fw], dtype='float32')
        anchors, variances = L.anchor_generator(
            feat, anchor_sizes=cfg['sizes'], aspect_ratios=cfg['ratios'],
            variance=[1.0, 1.0, 1.0, 1.0],
            stride=[cfg['stride'], cfg['stride']])
        scores = L.data(name='rpn_scores', shape=[na, fh, fw],
                        dtype='float32')
        deltas = L.data(name='rpn_deltas', shape=[4 * na, fh, fw],
                        dtype='float32')
        im_info = L.data(name='im_info', shape=[3], dtype='float32')
        gt_box = L.data(name='rpn_gt_box', shape=[4], dtype='float32',
                        lod_level=1)
        gt_class = L.data(name='rpn_gt_class', shape=[1], dtype='int32',
                          lod_level=1)
        crowd = L.data(name='rpn_is_crowd', shape=[1], dtype='int32',
                       lod_level=1)
        rois, probs = L.generate_proposals(scores, deltas, im_info, anchors,
                                           variances)
        assign = L.rpn_target_assign(
            deltas, scores, L.reshape(anchors, shape=[-1, 4]), gt_box,
            fix_seed=True, seed=SEED % 1000)
        labels = L.generate_proposal_labels(
            rois, gt_class, crowd, gt_box, im_info, batch_size_per_im=512,
            class_nums=cfg['class_nums'], use_random=False)
    return dict(program=prog, fetch=[anchors, variances, rois, probs] +
                list(assign) + list(labels),
                lod=[rois.name, probs.name] + [v.name for v in labels])


def rpn_feed(fluid, rng, cfg=RPN):
    """Seeded inputs of ``rpn_programs``: objectness probabilities and
    deltas (0.1 of a normal draw) at each anchor, im_info (the image at
    scale 1), and 1 to RPN_MAX_GT ground-truth boxes an image in pixels,
    a tenth of them crowd."""
    h, w = cfg['image']
    n = cfg['images']
    fh, fw = (int(math.ceil(s / cfg['stride'])) for s in (h, w))
    na = len(cfg['sizes']) * len(cfg['ratios'])
    boxes, classes, crowd = [], [], []
    for k in rng.randint(1, RPN_MAX_GT + 1, n):
        x0 = rng.uniform(0, w - 64, (k, 1))
        y0 = rng.uniform(0, h - 64, (k, 1))
        bw = rng.uniform(32, 400, (k, 1))
        bh = rng.uniform(32, 400, (k, 1))
        boxes.append(np.concatenate([x0, y0, np.minimum(x0 + bw, w - 1),
                                     np.minimum(y0 + bh, h - 1)],
                                    1).astype('float32'))
        classes.append(rng.randint(1, cfg['class_nums'], (k, 1)).astype(
            'int32'))
        crowd.append((rng.rand(k, 1) < 0.1).astype('int32'))
    logits = rng.standard_normal((n, na, fh, fw))
    return {'rpn_feat': np.zeros((n, 8, fh, fw), 'float32'),
            'rpn_scores': (1.0 / (1.0 + np.exp(-logits))).astype('float32'),
            'rpn_deltas': (0.1 * rng.standard_normal(
                (n, 4 * na, fh, fw))).astype('float32'),
            'im_info': np.tile(np.asarray([[h, w, 1.0]], 'float32'), (n, 1)),
            'rpn_gt_box': lod_tensor(fluid, boxes, 'float32'),
            'rpn_gt_class': lod_tensor(fluid, classes, 'int32'),
            'rpn_is_crowd': lod_tensor(fluid, crowd, 'int32')}


@contextlib.contextmanager
def _host_op_seconds(types):
    """The host wall each host op of ``types`` takes while active, summed
    by type (each registered function wrapped in a timer)."""
    from paddle_tpu_torch.ops import registry
    spent = dict.fromkeys(types, 0.0)
    saved = {t: registry._HOST_OPS[t] for t in types}

    def timed(t, fn):
        def run(ctx, op, scope):
            t0 = time.perf_counter()
            try:
                return fn(ctx, op, scope)
            finally:
                spent[t] += time.perf_counter() - t0
        return run

    registry._HOST_OPS.update({t: timed(t, fn) for t, fn in saved.items()})
    try:
        yield spent
    finally:
        registry._HOST_OPS.update(saved)


def phase_detect_train(card):
    """M1: MobileNet-SSD (``SSD``) trained on SSD_BATCH images: SSD_STEPS
    profiled steps on one batch (``_Path``: the eager call, the capture and
    replays; no hand-written kernel), the loss finite and the last below the
    first; one SSD_CPU_BATCH step against the CPU from the same state
    (``SSD_TRAIN_TOL``); the step captured against eager and timed
    (SSD_CAPTURE_CALLS) with cuDNN's deterministic algorithms, with
    ``cost_report()``'s FLOPs and the capture's peak against
    ``memory_analysis``.  Returns (the model, its scope, the
    path's launch record)."""
    import paddle_tpu_torch.fluid as fluid
    tag = 'M1 MobileNet-SSD %d' % SSD['size']
    with fluid.unique_name.guard():
        model = mobilenet_ssd_programs(fluid, **SSD)
    model, scope, exe = _started('%s %s' % (tag, SSD), model)
    main, loss = model['main'], model['loss'].name
    rng = np.random.RandomState(SEED + 100)
    feed, _ = ssd_batch(fluid, rng, SSD_BATCH, SSD['size'],
                        SSD['num_classes'])
    feed = {k: feed[k] for k in model['feeds']}
    made = []
    path = _Path(tag, exe, 'f32').begin()
    fluid.FLAGS.cost_accounting = True
    try:
        for _ in range(SSD_STEPS):
            made += path.call(lambda: exe.run(main, feed=feed,
                                              fetch_list=[loss],
                                              scope=scope), _expect())
    finally:
        fluid.FLAGS.cost_accounting = False
    path.end()
    check(path.wrapper == _expect(), '%s: hand-written kernels launched: %s'
          % (tag, path.wrapper))
    block = exe.cached_blocks()[-1]
    ran = [m[3] for m in made]
    check(block.mode == 'graph' and block.captures == 1 and
          ran.count('replay') >= SSD_STEPS - 2,
          '%s: the block ran %s (%s), %d captures, calls %s' %
          (tag, block.mode, block.why, block.captures, ran))
    losses = [float(m[0][0][0]) for m in made]
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          '%s: the loss did not fall: %s' % (tag, losses))
    flops = _cost_per_step(exe, [loss])
    check(flops and min(flops) > 0, '%s: cost_report FLOPs %s' % (tag, flops))
    ops = collections.Counter(op.type for op in
                              model['test'].global_block().ops)
    print('%s: %d RMSProp steps (lr %g) on one %d-image batch, loss %s; '
          'launches %s; cost_report FLOPs a step %.4e; %d parameters of %d '
          'elements; test program ops: conv2d %d, depthwise_conv2d %d, '
          'batch_norm %d, prior_box %d, ssd_loss %d, multiclass_nms %d, '
          'detection_map %d [%s]' %
          (tag, len(made), SSD_LR, SSD_BATCH,
           ' -> '.join('%.4f' % l for l in losses), path.summary(),
           flops[-1], len(main.all_parameters()),
           sum(int(np.prod(p.shape)) for p in main.all_parameters()),
           ops['conv2d'], ops['depthwise_conv2d'], ops['batch_norm'],
           ops['prior_box'], ops['ssd_loss'], ops['multiclass_nms'],
           ops['detection_map'], card), flush=True)
    small, _ = ssd_batch(fluid, rng, SSD_CPU_BATCH, SSD['size'],
                         SSD['num_classes'])
    with cpu_ftz():
        compare_train_step(card, tag, '%d x 3 x %d x %d' % (
            SSD_CPU_BATCH, SSD['size'], SSD['size']), main, loss,
            {k: small[k] for k in model['feeds']}, scope, exe, SSD_LR,
            SSD_TRAIN_TOL)
    # cuDNN's deterministic algorithms for the capture against eager and
    # their times: its default weight gradients sum in no fixed order, and
    # through 35 batch norms that order can move the step by more than
    # twice what it moves it from one eager run to the next, the capture's
    # tolerance
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        timed = phase_capture(card, tag + ' step', main, feed, [loss],
                              _persistables(main, scope), {},
                              calls=SSD_CAPTURE_CALLS)
    finally:
        torch.backends.cudnn.deterministic = saved
    ratio = timed['memory']['capture_above'] / timed['memory']['temp']
    _book_record(card, tag + ' step', timed, flops[-1], path='M',
                 batch=SSD_BATCH, ms_eager=timed['eager']['wall'] * 1e3,
                 ms_captured=timed['captured']['wall'] * 1e3,
                 capture_over_temp=round(ratio, 3),
                 tflops_captured=flops[-1] / timed['captured']['wall'] / 1e12)
    path.exe = None  # the launch record outlives the path's executor
    del exe, block
    return model, scope, path


def _detections_apart(got, want, tol=1e-4):
    """How many detection rows [label, score, box] of one image are in only
    one of ``got`` and ``want``: rows matched greedily within ``tol`` by
    label, score and box."""
    got = [r for r in np.asarray(got).reshape(-1, 6)]
    left = [r for r in np.asarray(want).reshape(-1, 6)]
    apart = 0
    for r in got:
        hit = next((i for i, w in enumerate(left) if w[0] == r[0] and
                    np.abs(w[1:] - r[1:]).max() <= tol), None)
        if hit is None:
            apart += 1
        else:
            left.pop(hit)
    return apart + len(left)


def _image_rows(arr, lod, i):
    return np.asarray(arr)[lod[i]:lod[i + 1]]


def phase_detect_eval(card, model, scope):
    """M2: the test program over SSD_EVAL_BATCHES batches of SSD_BATCH on
    the card, eager (its host ops), the map's state accumulating; each
    batch's host ops run again on the CPU (``ssd_host_program``) on the
    arrays the card fed them, bitwise equal (detections, their LoD, the mAP
    and the state); the first SSD_EVAL_CPU_IMAGES images of the first
    batch through the test program on the CPU: ``locs`` and ``confs``
    within CV_SERVE_RTOL (ratios of 2-norms), and the count of detections
    that differ printed."""
    import paddle_tpu_torch.fluid as fluid
    tag = 'M2 MobileNet-SSD evaluation'
    test = model['test']
    ops = {op.type: op for op in test.global_block().ops}
    rng = np.random.RandomState(SEED + 101)
    fetch = [model['nmsed'].name, model['map'].name,
             ops['multiclass_nms'].input('BBoxes')[0],
             ops['multiclass_nms'].input('Scores')[0],
             model['locs'].name, model['confs'].name]
    exe = fluid.Executor(fluid.CUDAPlace(0))
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    host_scope = fluid.Scope()
    walls, host_s, maps, counts, first = [], [], [], [], None
    types = ('multiclass_nms', 'detection_map')
    card_s = dict.fromkeys(types, 0.0)  # the card's runs' alone
    _zero_counts()
    with _host_op_seconds(types) as spent:
        for i in range(SSD_EVAL_BATCHES):
            feed, rows = ssd_batch(fluid, rng, SSD_BATCH, SSD['size'],
                                   SSD['num_classes'])
            state = np.full((1, ), int(i > 0), 'int32')
            before = dict(spent)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = exe.run(test, feed=dict(feed, has_state=state),
                          fetch_list=fetch, scope=scope)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            for t in types:
                card_s[t] += spent[t] - before[t]
            host_s.append(sum(spent[t] - before[t] for t in types))
            lod = scope.find_var(model['nmsed'].name).value().lod()[0]
            accum = [fluid.fetch_var(n, scope) for n in model['states']]
            # the same host ops on the CPU, on the arrays the card fed them
            if i == 0:
                host = ssd_host_program(fluid, test, (got[2].shape,
                                                      got[3].shape))
            want = cpu_exe.run(host['program'], feed={
                'bboxes': got[2], 'scores': got[3], 'has_state': state,
                'label': lod_tensor(fluid, rows, 'float32')},
                fetch_list=[host['nmsed'], host['map']], scope=host_scope)
            want_lod = host_scope.find_var(host['nmsed'].name).value().lod()
            want_accum = [fluid.fetch_var(n, host_scope)
                          for n in host['states']]
            same = [lod] == want_lod and all(
                np.array_equal(g, w) for g, w in
                zip(got[:2] + accum, want + want_accum))
            check(same, '%s: batch %d: the card\'s host ops differ from the '
                  'same ops on the CPU on the same arrays (detections %s / '
                  '%s, LoD %s / %s, mAP %s / %s)' %
                  (tag, i, got[0].shape, want[0].shape, lod[-1],
                   want_lod[0][-1], got[1], want[1]))
            block = exe.cached_blocks()[-1]
            check(block.mode == 'eager' and got[0].shape[1:] == (6, ) and
                  np.isfinite(got[0]).all() and
                  np.isin(got[0][:, 0], np.arange(1, SSD['num_classes'])).all()
                  and 0.0 <= got[1][0] <= 1.0,
                  '%s: batch %d ran %s (%s): detections %s, mAP %s' %
                  (tag, i, block.mode, block.why, got[0].shape, got[1]))
            maps.append(float(got[1][0]))
            counts.append(int(got[0].shape[0]))
            if first is None:
                first = (feed, rows, got, lod)
    _no_launches(tag)
    # the first images through the test program on the CPU
    feed, rows, got, lod = first
    n = SSD_EVAL_CPU_IMAGES
    cut = {'image': feed['image'][:n], 'has_state': np.zeros((1, ), 'int32')}
    for name, dtype, col in (('gt_box', 'float32', slice(1, 5)),
                             ('gt_label', 'int32', slice(0, 1)),
                             ('gt_difficult', 'int32', slice(5, 6))):
        cut[name] = lod_tensor(fluid, [r[:, col] for r in rows[:n]], dtype)
    cpu_scope = _cpu_copy(model['main'], scope)
    t0 = time.perf_counter()
    want = cpu_exe.run(test, feed=cut, fetch_list=[
        model['nmsed'].name, model['locs'].name, model['confs'].name],
        scope=cpu_scope)
    cpu_s = time.perf_counter() - t0
    want_lod = cpu_scope.find_var(model['nmsed'].name).value().lod()[0]
    rel = [float(np.linalg.norm(g[:n] - w) / np.linalg.norm(w))
           for g, w in zip(got[4:], want[1:])]
    check(max(rel) <= CV_SERVE_RTOL, '%s: locs, confs on the card against '
          'the CPU |d| / |v| %s (tol %g)' % (tag, rel, CV_SERVE_RTOL))
    apart = sum(_detections_apart(_image_rows(got[0], lod, i),
                                  _image_rows(want[0], want_lod, i))
                for i in range(n))
    print('%s: %d batches of %d images, eager (host ops): detections %s, '
          'mAP (11-point, accumulated) %s; the host ops bitwise the same '
          'ops on the CPU on the card\'s arrays in every batch; batch wall '
          '%s s, of which host ops %s s (multiclass_nms %.3f s, '
          'detection_map %.3f s in all), the device block the rest; the '
          'first %d images on the CPU (%.2f s): locs, confs |d| / |v| %s '
          '(tol %g), %d of %d detections differ (CPU %d) [%s]' %
          (tag, SSD_EVAL_BATCHES, SSD_BATCH, counts,
           ['%.6f' % m for m in maps], ['%.3f' % w for w in walls],
           ['%.3f' % s for s in host_s], card_s['multiclass_nms'],
           card_s['detection_map'], n, cpu_s,
           ['%.3g' % r for r in rel], CV_SERVE_RTOL, apart, lod[n],
           want_lod[n], card), flush=True)
    print('path M: %s' % json.dumps(dict(
        path='M', phase=tag, batches=SSD_EVAL_BATCHES, batch=SSD_BATCH,
        detections=counts, map=maps, batch_s=walls, host_op_s=host_s,
        nms_s=card_s['multiclass_nms'], map_s=card_s['detection_map'],
        cpu_locs_confs_rel=rel, detections_apart=apart, card=card)),
        flush=True)


def phase_detect_rpn(card):
    """M3: the RPN stages (``rpn_programs``) on the card and on the CPU from
    the same seeded inputs: every output bitwise (the anchors and the IoU
    are exact f32 arithmetic on both, the host ops numpy on the same
    arrays, with ``fix_seed``), each host op's seconds on the card's
    run."""
    import paddle_tpu_torch.fluid as fluid
    tag = 'M3 RPN stages'
    rng = np.random.RandomState(SEED + 102)
    model = rpn_programs(fluid, RPN)
    feed = rpn_feed(fluid, rng, RPN)
    types = ('rpn_target_assign', 'generate_proposals',
             'generate_proposal_labels')
    outs = {}
    _zero_counts()
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        scope = fluid.Scope()
        with _host_op_seconds(types) as spent:
            t0 = time.perf_counter()
            got = fluid.Executor(place).run(
                model['program'], feed=feed, fetch_list=model['fetch'],
                scope=scope)
            wall = time.perf_counter() - t0
        lods = [scope.find_var(n).value().lod() for n in model['lod']]
        outs[place.device.type] = (got, lods, dict(spent), wall)
    _no_launches(tag)
    (got, lods, spent, wall), (want, want_lods, cpu_spent, cpu_wall) = \
        outs['cuda'], outs['cpu']
    names = [v.name for v in model['fetch']]
    differ = [n for n, g, w in zip(names, got, want)
              if not np.array_equal(g, w)]
    check(not differ and lods == want_lods,
          '%s: the card and the CPU differ in %s (LoD equal: %s)' %
          (tag, differ, lods == want_lods))
    anchors, rois, labels = got[0], got[2], got[9]
    check(anchors.shape == tuple(
        [int(math.ceil(s / RPN['stride'])) for s in RPN['image']] +
        [len(RPN['sizes']) * len(RPN['ratios']), 4]) and
        len(lods[0][0]) == RPN['images'] + 1 and rois.shape[1] == 4,
        '%s: anchors %s, proposals %s, LoD %s' %
        (tag, anchors.shape, rois.shape, lods[0]))
    print('%s: anchors %s on a %s image (stride %g), %d proposals (LoD %s), '
          '%d sampled anchors (%d positive), %d RoIs (%d foreground), '
          'bitwise the CPU\'s in all %d outputs; host seconds on the card\'s '
          'run %s (wall %.3f s; the CPU run %s, wall %.3f s) [%s]' %
          (tag, anchors.shape, RPN['image'], RPN['stride'], rois.shape[0],
           lods[0][0], got[5].shape[0], got[4].shape[0], labels.shape[0],
           int((labels > 0).sum()), len(names),
           {k: round(v, 4) for k, v in spent.items()}, wall,
           {k: round(v, 4) for k, v in cpu_spent.items()}, cpu_wall, card),
          flush=True)
    print('path M: %s' % json.dumps(dict(
        path='M', phase=tag, proposals=int(rois.shape[0]),
        rois=int(labels.shape[0]), host_s=spent, wall_s=wall, card=card)),
        flush=True)


def phase_detect(card):
    """Path M: the detection family.  Returns M1's launch record (no
    hand-written kernel lies on the path)."""
    marks = [time.perf_counter()]
    _free()
    model, scope, launches = phase_detect_train(card)
    marks.append(time.perf_counter())
    phase_detect_eval(card, model, scope)
    del model, scope
    _free()
    marks.append(time.perf_counter())
    phase_detect_rpn(card)
    marks.append(time.perf_counter())
    print('path M: %.1f s (M1 %.1f s, M2 %.1f s, M3 %.1f s)' % (
        (marks[-1] - marks[0], ) + tuple(b - a for a, b in zip(
            marks, marks[1:]))), flush=True)
    return launches


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

    A session that records no device activity, drops most of one
    activity's events (every activity here runs at least once a call) or
    loses more than its preamble (PROFILER) is printed and taken again,
    five sessions at most, and the last one is used."""
    for _ in range(warmup):
        fn()
    for session in range(5):
        with _profiled() as profiled:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        durations = {}
        for e in profiled.prof.events():
            if (e.device_type == torch.autograd.DeviceType.CUDA and
                    not _is_marker(e.name)):
                durations.setdefault(e.name, []).append(
                    e.time_range.elapsed_us())
        short = [n for n, d in durations.items() if 2 * len(d) < calls]
        if durations and not short and profiled.kept:
            break
        print('times: profiler session %d of 5 recorded %s' %
              (session + 1, 'no device activity' if not durations else
               'under half the events of %s' %
               ', '.join(_activity_name(n)[:60] for n in short) if short
               else 'a loss past its preamble'), flush=True)
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
    ap.add_argument('--only-book', action='store_true',
                    help='run the device phase and path F alone, and print '
                    'no result line (a partial run)')
    ap.add_argument('--only-flow', action='store_true',
                    help='run the device phase, the kernels\' build and path '
                    'G alone, and print no result line (a partial run)')
    ap.add_argument('--only-serve', action='store_true',
                    help='run the device phase, the kernels\' build and path '
                    'H alone, and print no result line (a partial run)')
    ap.add_argument('--only-generate', action='store_true',
                    help='run the device phase and path I alone, and print '
                    'no result line (a partial run)')
    ap.add_argument('--only-pipeline', action='store_true',
                    help='run the device phase, the kernels\' build and path '
                    'J alone, and print no result line (a partial run)')
    ap.add_argument('--only-ops', action='store_true',
                    help='run the device phase and path K alone, and print '
                    'no result line (a partial run)')
    ap.add_argument('--only-parallel', action='store_true',
                    help='run the device phase, the kernels\' build and '
                    'path L alone, and print no result line (a partial run)')
    ap.add_argument('--only-detect', action='store_true',
                    help='run the device phase and path M alone, and print '
                    'no result line (a partial run)')
    # one rank of path L, started by path L itself
    ap.add_argument('--parallel-rank', type=int, help=argparse.SUPPRESS)
    ap.add_argument('--parallel-port', type=int, help=argparse.SUPPRESS)
    ap.add_argument('--parallel-dir', help=argparse.SUPPRESS)
    args = ap.parse_args()
    SEED = args.seed
    if args.parallel_rank is not None:
        parallel_rank(args.parallel_rank, args.parallel_port,
                      args.parallel_dir)
        return
    card = phase_device()
    sys.path.insert(0, REPO)
    if args.only_generate:
        phase_generate(card)
        profiler_summary()
        print('chip_smoke: --only-generate: path I passed; a partial run '
              'prints no result line', flush=True)
        return
    if args.only_detect:
        phase_detect(card)
        profiler_summary()
        print('chip_smoke: --only-detect: path M passed; a partial run '
              'prints no result line', flush=True)
        return
    if args.only_ops:
        phase_ops(card)
        profiler_summary()
        print('chip_smoke: --only-ops: path K passed; a partial run prints '
              'no result line', flush=True)
        return
    if args.only_book:
        _scan_runs()
        phase_book(card)
        profiler_summary()
        print('chip_smoke: --only-book: path F passed; a partial run prints '
              'no result line', flush=True)
        return
    phase_build()
    _scan_runs()  # counts the lstm op's scan path from here on
    if args.only_flow:
        phase_flow(card)
        profiler_summary()
        print('chip_smoke: --only-flow: path G passed; a partial run prints '
              'no result line', flush=True)
        return
    if args.only_serve:
        phase_serve(card)
        profiler_summary()
        print('chip_smoke: --only-serve: path H passed; a partial run prints '
              'no result line', flush=True)
        return
    if args.only_pipeline:
        phase_pipeline(card)
        profiler_summary()
        print('chip_smoke: --only-pipeline: path J passed; a partial run '
              'prints no result line', flush=True)
        return
    if args.only_parallel:
        phase_parallel(card)
        profiler_summary()
        print('chip_smoke: --only-parallel: path L passed; a partial run '
              'prints no result line', flush=True)
        return
    since = [time.perf_counter()]

    def took(what):
        # each group of phases' seconds, to see where the script's time goes
        now = time.perf_counter()
        print('time: %s %.1f s' % (what, now - since[0]), flush=True)
        since[0] = now

    fwd_err = phase_kernel_vs_plain()
    bwd_err = phase_bwd_vs_plain()
    lstm_err = phase_lstm_vs_plain()
    took('kernels vs plain')
    phase_book(card)
    took('path F')
    phase_flow(card)
    took('path G')
    serve_launches = phase_serve(card)
    took('path H')
    phase_generate(card)
    took('path I')
    pipeline_launches = phase_pipeline(card)
    took('path J')
    ops_launches = phase_ops(card)
    took('path K')
    parallel_launches = phase_parallel(card)
    took('path L')
    detect_launches = phase_detect(card)
    took('path M')
    model, scope, exe = build_model()
    launches = {'serve': phase_slice(card, model, scope, exe),
                'train': phase_train(card, model, scope, exe)}
    launches.update(serve_launches)
    launches['feed_pipeline'] = pipeline_launches
    launches['ops'] = ops_launches
    launches['parallel'] = parallel_launches
    launches['detect'] = detect_launches
    phase_train_card_vs_cpu(card, model, scope, exe)
    phase_transformer_capture(card, model, scope)
    launches.update(phase_amp_transformer(card, model, scope, exe))
    del model, scope, exe
    torch.cuda.empty_cache()
    took('Transformer phases')
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
    took('stacked-LSTM phases')
    nmt = build_nmt_models()
    launches['nmt_serve'] = phase_nmt_serve(card, nmt)
    launches['nmt_train'] = phase_nmt_train(card, nmt)
    phase_nmt_decode(card, nmt)
    phase_nmt_capture(card, nmt)
    del nmt
    torch.cuda.empty_cache()
    took('NMT phases')
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
    took('ResNet-50 phases')
    phase_mnist(card)
    phase_vgg(card)
    took('MNIST and VGG-16')
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
    _free()
    took('CTR phases')
    phase_bench_widths(card)
    took('path E')
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
    took('kernel times')
    profiler_summary()
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
