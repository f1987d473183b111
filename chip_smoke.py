#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA
card — the quickest proof that the port still builds, serves and trains on
the GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only tick   # the build and phase 13 alone (a
                                        # diagnostic: no final line)
    python3 chip_smoke.py --only serve  # the build and phases 4, 14, 24
                                        # and 25 alone (no final line)
    python3 chip_smoke.py --only spec   # the build and phases 3 (paged
                                        # attention), 4 and 26 alone (no
                                        # final line)
    python3 chip_smoke.py --only invariance  # the build, phases 28, 4
                                        # and 26 (no final line)
    python3 chip_smoke.py --only sched  # the build and phase 29 alone (no
                                        # final line)
    python3 chip_smoke.py --only recovery  # the build and phase 30 alone
                                        # (no final line)
    python3 chip_smoke.py --only dense  # the build, phase 4 and phase 31
                                        # alone (no final line)
    python3 chip_smoke.py --only finetune  # the build, phase 6's AdamW
                                        # kernel and phase 32 (no final
                                        # line)
    python3 chip_smoke.py --only vision  # the build and phase 33 (no
                                        # final line)
    python3 chip_smoke.py --only tensor  # the build and phase 34 (no
                                        # final line)
    python3 chip_smoke.py --only ocr    # the build and phase 35 (no
                                        # final line)
    python3 chip_smoke.py --only hapi   # the build and phase 36 (no
                                        # final line)
    python3 chip_smoke.py --only fleet  # the build, phase 4 and phase 37
                                        # (no final line)

Phases (any failure exits non-zero before the final line):

1. Card: prints ``nvidia-smi --query-gpu=name,power.limit``.
2. Build: compiles the port's CUDA kernels from ``paddle_tpu_torch/ops/
   csrc`` with nvcc for sm_90a and prints the build time and each kernel's
   registers / spills; then the flash forward kernel's and the backward
   kernels' registers, shared memory, ring and tile sizes at both head
   dims (``forward_config``, ``backward_config``), failing on a spill or an
   ignored ``setmaxnreg`` (C7508) in ``flash_attention.cu`` or
   ``flash_attention_bwd.cu`` (one helper for both); and each instantiation
   of the weight-streaming kernels (``w8_matmul.cu``, ``fused_lora.cu``:
   the bf16 streaming product ``stream_matmul.cu`` in both W layouts; one
   main loop, ``stream_gemm.cuh``), of the paged attention kernel
   per pool type and of the whole-tick kernel (``decode_megakernel.cu``,
   its 4 instantiations), failing on a spill or local bytes.
3. Serving kernels against their plain PyTorch versions on the card, in
   bf16, at the serving path's shapes: RMSNorm at rows {8, 128} x 4096
   (and at 4096 x 4096, the training path's B x S rows);
   paged attention (``PAGED_FORMS``) in decode form (B=8, H=32, KV=8,
   D=128, bs=16, mixed context lengths with partial final blocks, a block
   boundary and a poisoned scratch block 0; every row at 2047 keys; every
   row at 512, the serving pass breakdown's shape; one long row among
   short ones), verify windows of 4 tokens (B=4) and of 5 (B=8, the
   speculative server's, two windows across a block boundary), and in
   prefill form (B=1, C=128 behind 384 earlier tokens, at start 0 and at
   1920).
   Tolerances are per element (RMSNorm) or per output row (attention), and
   the attention tolerance is shown to reject planted faults of the plain
   version: a causal mask one key off either way, the wrong page, one
   split of the kernel's plan dropped. Each prints its max abs error and
   its time beside the plain version's, the bound (the least time the card
   could take) and one PyTorch library call of the same function
   (``library_ms``, a yardstick the port never calls).
4. Serve: Llama-3-8B at full width and depth with random bf16 weights made
   on the card from a seed, behind ``GenerationServer(cache="paged")``,
   answering 12 greedy requests through 8 slots; checks every request's
   length, that every decode tick and prefill chunk went through both
   kernels (counts reset just before, read just after) and that every
   decode window and prefill chunk was a replay of one of the executor's
   CUDA graphs (its replay counters; the graphs are captured by a warm-up
   request before the run). Then one decode tick and one prefill chunk are
   timed on the host clock and, from the replay of the executor's graph
   with no host in the loop, on the device: their ratio is the device's
   idle share in a pass. Every serving phase runs this way.
5. End to end: one request's first prefill chunk plus 4 decode ticks with
   the kernels and with the plain versions, in bf16, and with the plain
   versions on an fp32 copy of the weights: the kernels' logits may be at
   most 1.25 x as far from the fp32 ones as the plain bf16 path's, and may
   differ from the plain bf16 path's by a bounded share of the rms logit.
6. Training kernels against their plain versions, bf16, at B=2, H=32,
   KV=8, D=128: flash forward at S=2048, at S=8192 (B=1) and at Sq=384 /
   Sk=2048; the dQ and dK/dV kernels at S=2048; forward and backward at
   the tile edges (``FLASH_EDGES``: no causal mask, S = 129, 130 and 200
   across the 128-row and 128-key blocks, Sq=300 / Sk=1000, a single
   query row against 1000 keys, Sq > Sk; and the forward with a
   negative scale) at KV=8 and KV=32 (untimed);
   each flash kernel (forward, dQ, dK/dV) launched twice must give the
   same bits; AdamW on a 4096 x 14336 and a 4096-element tensor
   with and without an fp32 master weight, on the largest tensor of the
   path (the 128256 x 4096 embedding or lm-head) with one, and with fp32
   grads at a ragged length.
   Attention is compared per output row (and the LSE per row), with the
   tolerance shown to reject a causal mask one key off in the forward and
   in the backward; AdamW per element. Times, bounds and library calls as
   in phase 3 (SDPA forward; SDPA's backward as the graph-timed forward +
   backward less the forward; ``torch.optim.AdamW(fused=True)``).
7. Train: ``ParallelEngine(LlamaForCausalLM(llama3_8b_config(
   num_hidden_layers=8)), AdamW(multi_precision, ClipGradByGlobalNorm))``
   on the card, 10 steps (2 warm-up) on one seeded batch of B=2 x S=2048,
   on the graphed engine (every step from the third a CUDA graph replay;
   the first is its warm-up, the second its capture) and on its eager
   twin (``graphs = False``), each from the same seeded weights and fresh
   AdamW state; checks the loss falls and that every step launched each
   flash kernel once per layer, RMSNorm 2 x layers + 1 times and AdamW
   once per parameter tensor (counts reset before each step, read after),
   the same in both twins, and that the graphed engine replayed. Prints,
   for each twin, ms/step, tokens/s, MFU (formula printed), peak memory,
   device ms a step (graphed: CUDA events around back-to-back replays;
   eager: the busy time of ``torch.profiler``'s trace, which is also
   printed for the graphs), busy share, replays and captures.
8. Train end to end, 2 layers at full width: one forward + backward with
   the kernels, with the plain versions (bf16) and with the plain versions
   on an fp32 copy: the kernels' loss and every gradient may be at most
   1.25 x as far (rms per tensor, and over all) from fp32 as the plain
   bf16 path's; then three AdamW steps of both bf16 paths, a fresh seeded
   batch each, whose losses (relative, per step) and changes of the fp32
   master weights may differ by bounded amounts; the weight-change limit
   is shown to reject two planted faults of the plain path (causal mask
   one key off; bias correction stuck at step 1).

Phases 9-12 run between phases 5 and 6, while the bf16 serving model is on
the card:

9. int8 and LoRA kernels against their plain PyTorch versions, bf16:
   w8_matmul at M in {1, 8, 16, 40, 128} on every decode shape of
   Llama-3-8B (the projections and the lm-head), per element within one
   bf16 step plus the fp32 summation bound, shown to reject a lost K
   slice (at 40 and 128 rows measured beside the dequantize-once path
   those rows took before they streamed); int8-pool paged
   attention at phase 3's cases (scratch poisoned with full codes at a
   huge scale), per row, shown to reject phase 3's faults and the scales
   of the wrong block; the fused LoRA matmul per target shape at a decode batch
   (adapters of ranks 8, 8, 4 in max_rank 8 plus null rows, which must
   equal the kernel's output with every s = 0 bitwise) and a 128-token
   prefill chunk, shown to reject the wrong adapter page. Every w8_matmul
   and fused LoRA case is launched 3 times more and must give the same
   bits, and prints its launch plan and the wrapper's host us a call.
   Times, bounds and a library yardstick as in phase 3 (``torch.matmul`` on
   a bf16 weight; SDPA on the dequantized K/V; ``torch.matmul`` + the torch
   ``bgmv``).
10. LoRA serving: the phase-4 model and traffic behind
   ``lora=LoRAConfig(registry, max_live_adapters=2, max_rank=8)`` with
   three seeded adapters (ranks 8, 8, 4) on 8 of the 12 requests; checks
   that every pass launched the fused LoRA kernel 7 x 32 times, that an
   adapter upload followed an eviction, and that one prompt served under
   a1, a2 and a2 again hits the prefix cache only on the third turn
   (blocks keyed by adapter). Prints as phase 4.
11. int8 serving: ``quantize_int8()`` in place, then the phase-4 traffic
   with ``kv_quant="int8"``; checks that every decode tick and every
   prefill chunk launched w8_matmul 7 x 32 + 1 times (a chunk's 128 rows
   stream too) and the int8 attention 32 times. Prints as phase 4. Then
   phase 26's int8-weights cell (bf16 KV): the plain and the n-gram
   speculative server on the repeat-suffix traffic, every request's
   tokens equal, and (b) at B = 8 for the int8 model.
12. End to end as phase 5, for the LoRA path (before phase 11) and for the
   int8 path (the fp32 copy holds the same codes and scales), with phase
   5's limits.

Phases 13-16 run between phases 5 and 9, on the same model:

13. The whole-tick decode kernel (``decode_tick``) against its plain twin,
   bf16, at 1 and 4 of the model's layers, B=8, W in {1, 4} (and 5, the
   speculative verify window, for fp and int8 pools), phase 3's
   positions and poisoned scratch block, in each variant: fp pools, int8
   pools (both ``dequant`` modes; "tile" at W=1), LoRA on every target
   (pages of ranks 8, 8, 4 and the null page) over fp and over int8 pools:
   output rows and the pool entries the tick wrote (int8: the written
   blocks dequantized, within one code step of the block's scale on top),
   per row within phase 3's tolerance per rounding (two a layer for the
   output rows), shown to reject planted faults (the causal mask one key
   off; the wrong adapter page; a scale applied twice); no pool entry
   outside the window moves; the kernel no farther from an fp32 twin than
   the bf16 twin, by the drift ratio of phase 5; with every row on the
   null page the LoRA tick equals the fp tick bit for bit. Then each
   variant timed at 32 layers beside the twin, the per-layer kernels' tick
   (the yardstick: no single PyTorch call computes a tick) and the bound,
   and at W = 4; fp and int8 pools at W = 5 (40 rows) at full depth
   against the twin (two tolerances a layer), timed beside it with their
   bound, the JAX byte estimate and clock counters; two ticks on the same
   inputs must give the same bits, and
   so must a tick with the clock counters on; the counters' breakdown per
   phase (summed over the layers: work time over the blocks, barrier
   waits, ring waits, staging, fragment ends, epilogues, attention's key
   loops and merges, the weight stream's TB/s) is printed at W = 1 and 4.
14. Megakernel serving: phase 4's traffic behind ``kernels="megakernel"``;
   checks that every decode tick launched ``decode_tick`` once and the
   per-layer attention never, and every prefill chunk the per-layer
   attention once a layer and ``decode_tick`` never; counts the requests
   whose tokens equal phase 4's. Prints as phase 4.
15. End to end as phase 5, the decode ticks through ``decode_tick`` (the
   plain bf16 run through its twin).
16. int8 KV pools under the bf16 model: phase 4's traffic with
   ``kv_quant="int8"``, per layer (the int8-pool attention once a layer
   every pass) and behind ``kernels="megakernel"`` (every decode tick one
   ``decode_tick`` and no per-layer kernel but the final norm); then end
   to end as phase 15.

Phase 24 runs beside each serving cell and phase 25 after phase 16, on
the same model:

24. Graphs on and off: right after each serving cell (phases 4, 10, 11,
   14, 16, 17), the first ``EAGER_REQUESTS`` of its requests once more
   with the executor's graphs off (every pass eager, its device time from
   the pass captured here); each of those requests' tokens must equal the
   graphed run's, and each eager pass launch what a graphed pass of the
   same kind and size launched (each run's totals held to the cell's
   launch rule); prints both runs' per-pass host wall, enqueue and
   device time (by kernel class for the graphed run), rates and peak
   memory; the graphed per-layer bf16 tick's host wall may be at most
   ``GRAPH_WALL_RATIO`` x its device time.
25. ``tick_window=4``: phase 4's and phase 14's cells, 4 ticks a replay,
   every pass's launches checked per tick; both cells' tokens must equal
   their W = 1 runs' on the same requests; then 4 sampled requests at
   W = 4 with the graphs on and off from one seed: every sampled window a
   replay of a graph that draws from the server's generator.

Phase 26 runs after phase 25, on the same model:

26. Speculative serving (``GenerationServer(spec=SpecConfig(k=4))``,
   tools/serving_benchmark.py's ``--spec 4`` mode). (a) Cells, each with
   its warm-up request capturing every graph: the plain graphed server
   per layer and through the megakernel on the repeat-suffix traffic
   (12 prompts tiling one motif at phase 4's lengths, 64 new tokens:
   the yardsticks); the n-gram drafter at ``tick_window=4`` per layer on
   that traffic and on phase 4's, through the megakernel, sampled
   (temperature 0.8, top-p 0.9); the draft model of that tool (hidden
   2048, 8 layers, 16 heads, 4 KV heads) at ``tick_window=1``; and
   drafts replayed from the plain cell's outputs (``ReplayDrafter``: the
   verify path at an acceptance near 1, which the random weights deny
   the n-gram drafter), and the n-gram drafter with the gate off, both
   with ``gate_cooldown=0``. Each
   checks every request's length, that every speculative trip and gated
   plain trip was a graph replay, the launches of every kernel in the
   run and of rows 11 and 13 per verify window; prints
   ``spec_metrics()``, rates, ms per trip and per emitted token, and one
   trip's host wall, enqueue and device time (the draft program's
   apart). (b) One request after its prefill: a W = 5 verify window of
   the plain server's next tokens against 5 decode ticks on a copy of
   the pools, with the kernels (per layer and whole tick: equal bit for
   bit), their plain twins in bf16 and on an fp32 copy, and the kernels'
   verify logits at most DRIFT_RATIO x as far from fp32 as the twins';
   then the served batch, 8 distinct requests (``verify_decode_b8``):
   verify (40 rows) and decode (8 rows) logits equal bit for bit per
   layer and through ``decode_tick``, and each row's equal to the same
   row's alone; over int8 pools the row test holds and the verify
   against decode difference is printed (a window's later tokens
   requantize a block before its earlier queries read it); after phases
   10 and 11 the same for LoRA (rows on two adapters and none) and int8
   weights. (c) Greedy tokens against the plain server's cells: every
   greedy cell's 12 requests identical (near ties at the first
   differing token are printed as a diagnostic); a planted fault (one
   draft accepted too many) must make a request differ. (d) The n-gram cell
   with graphs off gives the same tokens and launches (its first
   ``EAGER_REQUESTS`` requests, as phase 24); the sampled cell twice from
   one seed the same tokens.

Phase 28 runs after phase 3, phase 29 after phase 26:

28. Batch invariance of every decode and verify product: at Llama-3-8B's
   q/o, k/v, gate/up, down and lm-head shapes (and the lm-head tied, its
   W^T read K-major), the bf16 streaming product, w8_matmul and (q, gate,
   down) the fused LoRA kernel give one row the same bits at M in {1, 8,
   16, 40, 64, 128, 160, 512}, at the first and the last row among random
   others, as at M = 8 (the token tile runs 8 to 128 rows: a wgmma's sum
   for one element does not depend on its N; past 128 rows several token
   tiles run with the same K slices); a planted fault (a K split that
   follows M) fails the check; cuBLAS's rows are checked alike as a
   diagnostic. The bf16 and int8 products against their plain twins per
   element (one bf16 step plus the fp32 summation bound, shown to reject
   a lost K slice), the bf16 one repeatable, and each kernel timed at M =
   8, 40 and 160 beside ``torch.matmul`` of the same shape, with its
   bound.
29. Scheduling and preemption: ``GenerationServer(policy="priority")``
   with a pool of 45 % of the blocks phase 4's requests need, phase 4's
   12 requests at normal priority and 4 urgent ones submitted after the
   first decode window in which no slot prefills (so that their victims
   decode and swap), ``assert_conserved()`` after every step; bf16 and
   int8 KV, per layer and through the megakernel. Every request's tokens
   must equal the same request's on a pool that never runs dry (phase 4's
   cells), preemptions (swaps to pinned host memory) must happen, no
   graph be captured after the warm-up, and every pass of a kind launch
   the same kernels. Prints preemptions, resumes, the host pool's peak
   bytes, the swap copies' ms a block and GB/s each way,
   ``sched_metrics()`` and ``load_metrics()``.

Phases 18-20 run last, after phase 8: long-context training, past the
8192 keys where flash attention takes its streaming kernels (rows 2, 5
and 6 of the kernel table; same bodies as the loop rows' kernels, own
entry points and counters):

18. The streaming forward, dQ and dK/dV kernels through the dispatch,
   bf16, B=1, H=32, KV=8, D=128: causal at S=16384, without the causal
   mask at S=12288, with a ragged last tile at Sq=8256 / Sk=16448 and
   causal at phase 19's S=32768 (both untimed); phase 6's per-row
   tolerances, shown to reject a causal mask
   one key off in the forward and in the backward; only the ``*_stream``
   counters move; the forward and the backward bitwise repeatable. Times
   as phase 6.
19. Long-context training: ``ParallelEngine`` over
   ``llama3_8b_config(num_hidden_layers=4, max_position_embeddings=
   32768)`` (cut from 8 layers to pay for phase 32), B=1, AdamW as phase
   7: (a) S=16384 without remat, 4 steps (2 warm-up); (b) S=32768 under
   ``remat=True, remat_policy="nothing"``, 3 steps (1 warm-up); (c)
   S=16384, one step under each policy, each
   cell from the same seeded weights and fresh AdamW state. Checks
   the loss falls (a, b), every first loss equals (a)'s bit for bit, and
   every step's launches: the streaming forward
   once a layer (twice under remat: the layer's recompute runs it again),
   dQ and dK/dV once, the loop kernels never, RMSNorm 2 x layers + 1
   (4 x layers + 1 under remat) and AdamW once per parameter tensor; and
   that peak memory orders as the policies save (nothing <= save_attn <=
   save_attn_mlp, save_qkv_attn <= dots, 1 % slack; dots < no remat).
   (a) and (b) run on the graphed engine and on its eager twin, as phase
   7; (c)'s one step is a graphed engine's warm-up, eager.
   Prints as phase 7, with each cell's compute bound.
20. End to end at S=16384, 2 layers at full width: the kernels (twice),
   the kernels under ``remat_policy="dots"``, the plain versions in bf16
   and on an fp32 copy: the remat run equals the kernels' run bit for
   bit; the kernels' loss and gradients within phase 8's drift ratio.

Phases 21-23 run after phase 20: ERNIE-3.0 base finetune (BASELINE config
2, ``examples/ernie_finetune.py``), through the LayerNorm kernel (row 8)
and the flash kernels at head dim 64 (rows 1, 3, 4):

21. LayerNorm against its plain version, bf16 and fp32, eps 1e-12, at
   ERNIE's B x S rows (4096 and 16384) x 768, at 8 x 768 and at 4096 x
   4096, rows with means of either sign: per element one rounding step of
   the output plus the fp32 sums' bound on the row mean, shown to reject
   the bias left out and the variance taken about 0. Times beside the
   plain version and ``F.layer_norm``, with the byte bound.
22. The flash forward, dQ and dK/dV kernels at D = 64 without the causal
   mask, B=32, H=12, S in {128, 512}, against the plain versions with
   phase 6's per-row tolerances, shown to reject the last key dropped;
   times beside SDPA forward and backward (as phase 6); every kernel
   bitwise repeatable; then phase 6's tile edges at D = 64, KV = 12 and 3.
   (Phases 6 and 18 keep D = 128.)
23. ``ErnieForSequenceClassification`` at 12 layers, hidden 768, 12
   heads, vocab 40000, seeded random weights, ``model.bfloat16()``, AdamW
   lr 5e-5 (fp32 master weights), ``ParallelEngine(loss_fn=model.
   loss_fn)``: (a) the recipe, B=32, S=128, dropout 0.1 / 0.1 (attention
   takes the SDPA reference, as in the JAX package); (b) B=32, S=512,
   attention dropout 0 (the flash kernels); 10 steps each (2 warm-up),
   every step's launches checked (LayerNorm 25, flash 12 / 12 / 12 in (b)
   and 0 in (a), AdamW once a parameter tensor); (c) the eval forward
   (``eval_batch``) at both shapes (LayerNorm 25, flash forward 12). Each
   cell on the graphed engine and its eager twin (a model of the same
   seed: weights and dropout masks), as phase 7. Prints as phase 7. Then
   2 layers at dropout 0, B=128, S in {128, 512}: the kernels' per-example
   losses and gradients against the plain bf16 path and an fp32 copy
   under phase 8's drift ratio, the eval outputs under phase 5's rule.

Phase 27 runs after phase 23: the graphed training step against the eager one,
4 steps each from the same weights and seeds, losses, parameters and
every optimizer slot bit for bit, launches equal (else the largest
difference and its tensor are printed and the run fails): (a)
Llama-3-8B's width at 2 layers, B=2 x S=2048, ``ClipGradByGlobalNorm``,
``grad_accum=2``, ``LinearWarmup`` -> ``CosineAnnealingDecay``; (b)
ERNIE (a) with dropout 0.1 / 0.1, whose graphed step's host wall (the
loss read back) may be at most 1.25 x its device time (phase 24's
limit); (c) (a)'s model under ``remat=True, remat_policy="dots"``; (d) a
checkpointed layer that draws a dropout mask from the default generator,
under ``remat_policy="nothing"``: each recompute draws its forward's mask
(the engine's graph-safe generator states). ``python3 chip_smoke.py
--only train_graph`` runs the build, phase 6's AdamW kernel, phases 7,
23 and 27 alone (a diagnostic, no final line).

Phase 30, observability and recovery, serves after phase 29 (the bf16
model on the card) and trains after phase 27: (a) phase 4's traffic with
``telemetry=True`` and without, in turns, per layer and through the
whole-tick kernel: the same tokens, decode tok/s both ways, the host ms a
step that telemetry adds, the flight records and spans, the chrome trace
written and read back, no graph captured after the warm-up (no
``steady_state_recompile``), ``tenants``; the server generator behind a
sampled window's graph reports its moved offset and takes a restored one;
(b) phase 29's overload on its tight pool under a fault plan (a poisoned
request quarantined, tick faults retried, allocator exhaustion, a refused
swap-out, a corrupted swap-in payload re-prefilled), bf16 and int8 KV,
every surviving request's tokens those of the unpressured run and the
pool conserved after every step; a drafter fault in the n-gram cell; a
fatal fault (``submit`` then raises ``EngineFailedError``); (c) the
overload snapshotted with swapped entries waiting and slots decoding
(``trust_kv`` True and False), per layer and through the whole-tick
kernel: the captured server and fresh servers restored from each snapshot
all give the unpressured tokens; one request evacuated into a busy server
(``admit_migrated``); (d) a shared 1024-token prefix demoted under the
watermarks and promoted for a later request, bf16 and int8 KV, tokens
those of a server without the tier, and the demote / promote copies' ms a
block and GB/s; (e) phase 7's cell with ``TrainTelemetry`` (this card's
bf16 peak for MFU) and without, and a ``train_step`` fault at step 3
retried: the parameters after 5 steps bit for bit the fault-free run's,
goodput exactly 1.0. ``python3 chip_smoke.py --only recovery`` runs the
build and phase 30 alone (no final line).

Phase 31, dense-cache generation, serves after phase 30 (the bf16 model
on the card), takes its int8 cell after phase 12 and GPT-2 after the
serving model is freed: (a) phase 4's traffic through
``GenerationServer(cache="dense", max_batch=8, max_len=2048,
prompt_buckets=(128, 256, 512, 1024))``: every request's length, every
prefill and decode window a replay of a graph captured by the warm-up
(one request a bucket), launches per pass (a prefill: flash forward 32,
RMSNorm 65; a tick: RMSNorm 65, ``stream_matmul`` 225), tokens bit-equal
to the eager twin's and at ``tick_window=4`` to W = 1's, against phase
4's paged tokens every difference a near tie (phase 26's rule: an fp32
copy of the weights, the bound twice the largest bf16 - fp32 logit gap
over every position of two prompts), which a planted fault (a bucket's
logits read at ``true_len``) breaks; tok/s, ms a tick, the passes' device
ms by kernel class and peak memory beside phase 4's cell; (b)
``LlamaForCausalLM.generate`` on four of phase 4's prompts alone (32
greedy tokens: launches, two captures a key then one replay a token,
graphed equal to eager, tokens against the dense server's within the
rule) and ``num_beams=4`` on two (against the same search in reference
mode within the beam rule, :func:`beam_ties`: the fp32 score of the
yardstick's beam over the kernels' at most the bound a generated token);
the int8 model's dense server (``w8_matmul`` 225 a tick) and generate;
(c) GPT-2 small (bf16, random weights from a seed): ``generate`` at B = 4
x 256 + 64 greedy tokens and 4 beams — LayerNorm 25 launches a forward,
flash forward (D = 64) 12 a prefill, graphed equal to eager, greedy and
beams against an fp32 copy in reference mode within the two rules, each
rule breaking on a planted fault (the position embedding read one
position on). ``python3 chip_smoke.py --only dense`` runs the build,
phase 4 and phase 31 (no final line).

Phase 32, the rest of the training side, runs last (each cell's model
made and freed in turn; every number beside the card's name and power
limit): (a) ``LlamaForCausalLM(llama3_8b_config(lora_rank=8,
lora_alpha=16))`` at full width and all 32 layers, bf16 base from a seed,
``ParallelEngine(model, AdamW(parameters=lora_parameters(model)),
remat=True, remat_policy="dots")``, 8 graphed steps of B = 2 x 2048 on one
fixed seeded batch: ms a step, tokens/s, MFU (formula printed), peak
memory, device ms by kernel class, launches a step (flash forward 64, dQ
32, dK/dV 32, RMSNorm 129, AdamW 448, checked each step); the loss falls,
every base weight bit for bit what the seed draws, every ``lora_B``
moved, ``set_lr`` reaching the device without a new capture; (b) the
adapter exported (``.npz``), loaded, registered and served (4 of phase
4's prompts, 24 greedy tokens) through the paged server on the unmerged
base (the fused LoRA kernel, row 12, and paged attention, row 11,
launched), against ``merge_lora``'s model served plain: tokens equal or
every first difference a near tie (phase 31's rule); row 12 at the
trained factors against its plain twin; (c) ``offload_opt_state=True``:
2 layers, 3 steps, parameters and moments bit for bit the resident
engine's; then a full finetune at 4 layers, or the deepest depth below
whose moments fit ``MemAvailable`` (read with ``ulimit -l`` first; pinning that fails
raises), 3 graphed steps: ms a step, the pinned copy rates each way, the
PCIe bound, peak memory; (d) ``PT_MT_ADAMW=1`` at 6 layers (more
than 2^31 elements in one launch): parameters bit for bit the per-tensor
path's, AdamW device ms and launches a step both ways, the flat launch
against its byte bound; (e) ``remat_policy="offload_attn"`` against
``"nothing"`` (losses and parameters bit for bit) and ``"dots"`` at phase
19's S = 16384: ms a step, peak memory, host anchor bytes; (f) AMP O2
(``decorate``) with ``GradScaler`` at 2 layers: two planted inf
gradients skip their steps and halve the scale once, masters fp32.
Every kernel's launches in (a)'s steps and (b)'s served run stand in the
kernels line as ``finetune_launches``; row 10 also carries the flat
launch (``flat_case``). Each phase group's end is printed as it
passes (``phase group ... ended at``).

Phase 34, after phase 33, drives the tensor functions and the rest of
the framework core (``paddle_tpu_torch/tensor``, ``framework``,
``device``): (a) every family (math, manipulation, logic, search, stat,
linalg, random, containers) on the card against the port on the CPU at
``tools/op_benchmark.py``'s TPU widths (2048 x 2048 bf16 and fp32,
int32 / int64, linalg at 512 x 512 fp32; integer, logic, search and
index results equal, floating ones within per-family limits, random
draws' moments within 6 standard errors and ``paddle.seed`` repeating
each draw bit for bit); (b) ``tools/op_benchmark.py``'s op-level suite
through the public API at its TPU sizes (matmul, Conv2D, softmax,
LayerNorm, Embedding, sum, and the causal GQA flash cell), each op's
device ms, the launches of rows 1 and 8 (``op_suite_launches`` in the
kernels line), LayerNorm at (32, 2048) against ``F.layer_norm``; (c)
ResNet-50's top-1 / top-5 on phase 33 (c)'s B = 256 logits through
``paddle.topk`` / ``equal`` / ``cast`` / ``mean`` / ``argmax``, card and
CPU equal; (d) ``FLAGS_check_nan_inf`` on an eager ResNet-50 step at
B = 32 (off and on, a planted Inf raising, the graphed engine refusing),
C3 at B = 1 on 3 x 32 x 32 against the CPU, C2 (a bf16 state dict saved
from the card loads bf16 bit for bit) and AMP O1's product hooks.

Phase 35, after phase 34, drives BASELINE config 5, the OCR pair,
through the recurrent layers, CTC and the rest of ``nn``
(``paddle_tpu_torch/nn/{layer/rnn,functional/loss,functional/common}``,
``vision/models/ocr.py``): (a) CRNN + CTC training at
``tools/model_benchmark.py``'s recipe (B = 64 x 1 x 32 x 96, Adam, the
model computing its own loss: the LSTM's step loop and the CTC loop
inside the engine's graph) and (b) DBNet at B = 16 x 3 x 640 x 640, each
8 graphed steps and its eager twin bit for bit under deterministic cuDNN
(losses, parameters, both moments, BatchNorm statistics), the loss
falling, every statistic moving, row 10 once a trainable parameter a
step (``ocr_launches_per_step`` in the kernels line), device ms by class
(products and convolutions by the ATen op that launched the kernel);
(c) both against the port on the CPU (TF32 off: loss, gradients,
statistics, eval outputs; one Adam step from the trained state, row 10
against its plain version at the models' shapes; a freshly seeded CRNN's
per-step argmax and greedy decodes equal, not all blank); (d) LSTM / GRU /
SimpleRNN, ``ctc_loss`` (timed beside ``F.ctc_loss``, a yardstick off the
path) and ``interpolate`` in every mode against the CPU; (e) an eval
forward of each vision family at its native size against the CPU.
Phase 32 (c)'s full offloaded finetune runs at 8 layers to pay for it
(4 since phase 38).

Phase 36, after phase 35, drives the data pipeline, the metrics,
``paddle.Model`` and the rest of ``vision`` (``paddle_tpu_torch/{io,
metric,hapi,reader}``, ``vision/{ops,datasets,transforms}``): (a)
BASELINE config 1 as ``examples/resnet_cifar10.py`` runs it (ResNet-50,
the synthetic Cifar10 under its transforms, Momentum with
CosineAnnealingDecay(0.1) and weight decay 5e-4, ``fit(num_workers=2)``
for one epoch with its eval set), its datasets behind a probe that
raises unless a worker process without CUDA reads each sample: images a
second, ms a step and waiting on the loader, the device's busy share
(a CUDA-only trace), the eval accuracy, the loader alone at 0 and 2
workers; ``fit``'s losses and parameters equal to a hand loop of
``train_batch`` over the same batches bit for bit (deterministic cuDNN);
two workers' eval batches equal to one process's bit for bit; (b)
``Model(LeNet())`` on MNIST with Adam: row 10 once a trainable parameter
a step (``hapi_launches_per_step`` in the kernels line), ``evaluate``,
``predict``, ``save`` / ``load`` (eval logits bit for bit), ``summary``'s
totals, one ``train_batch`` against the CPU (loss, gradients, phase 35's
Adam step); (c) every ``vision.ops`` op on the card against the port on
the CPU at detection shapes, forward and gradient, each limit shown to
reject a planted fault, each op's device ms; (d) the native token reader
built with g++ from ``csrc/ptio.cpp``: tokens a second at B = 2 x 2048
over a seeded 64 M-token file, every row a window of the file with its
next-token labels. The loader's forkserver starts after the build.

Phase 37, after phase 31 (a)-(b) while the bf16 model is on the card,
drives the serving fleet (``paddle_tpu_torch/inference/{fleet,transport,
replica_worker,autoscale}.py``, ``fleetsim/``) at phase 4's configuration
(Llama-3-8B, 32 layers, bf16, paged, B = 8, block 16, chunk 128, CUDA
graphs; each replica's pool sized by bytes to phase 4's blocks), its
yardstick phase 4's tokens: (a) a ``FleetRouter`` over two
``InProcessReplica`` servers sharing the model: phase 4's 12 requests,
tokens equal 12 of 12, then again with replica 0 drained mid-decode
(tokens equal, no CUDA graph captured after the warm-up): the fleet's
decode tok/s against the single server, per-replica rows, the drain's ms
a request, payload bytes and GB/s; (b) ``FaultPlan.fleet_chaos`` on a
fresh pair (a misroute, a replica down mid-decode salvaged through the
re-prefill rung), then a fresh replica added and the survivor drained
onto it while the plan runs (its payload flip caught by the receiver's
CRC and counted): tokens equal, ``fleet_deaths`` 1, no quarantine, the
host ms from the kill until every salvaged request is admitted on a
peer; (c) one ``role="prefill"`` and one ``role="decode"`` replica: 12
handoffs, tokens equal, no decode pass on the prefill replica, handoff ms
p50 / p99 and bytes a handoff; then ``FaultPlan.disagg_chaos`` (the
prefill replica killed mid-chunk, salvaged onto the decode class):
tokens equal; (d) ``tools/fleet_sim.py``'s execute_slice on
``SubprocessReplica`` workers (fresh interpreters loading the parent's
kernel build; Llama-3-8B's width at ``FLEET_D_LAYERS`` = 2 layers): a
drawn day's first 12 sessions through two workers, a ``FleetAutoscaler``
scripted through one scale-up and one drain, one SIGKILL mid-decode
salvaged from the handle's journal; tokens equal to the slice on one
in-process server of that configuration, each worker's weights
fingerprint equal to the parent's; worker start s, ``ping`` round trip
µs, salvage ms. Every replica pass launches row 11 and row 7 once a
layer (and the final norm) and a decode tick ``stream_matmul`` 7 a layer
and the head (each worker's launches against its passes); each token
check rejects the yardstick with one token flipped, the fingerprint
check a fingerprint off by one. ``fleet_launches`` in the kernels line:
(a)-(c)'s launches.

Phase 17 runs after phase 12's LoRA check: phase 10's LoRA cell behind
``kernels="megakernel"`` (every decode tick one ``decode_tick``, no fused
LoRA or per-layer attention launch; prefill chunks as in phase 10, the
shared-prompt check included), then end to end as phase 15.

Kernel times are device times from CUDA graphs of many calls (so the
Python wrappers' host cost is left out); serving and training rates are
host wall time around work that ends in a copy of its result to the host.

The second-to-last line is a JSON object listing each kernel with its
launches on the main path and its measurements (``stream_matmul``, the
port's own kernel with no TPU counterpart, with its launches a tick and
a window; the tick kernel once per
variant: ``decode_tick``, ``decode_tick_int8``, ``decode_tick_lora``, each
with the launches of its serving cell; the flash rows once more at head
dim 64, ``flash_fwd_d64``, ``flash_bwd_dq_d64``, ``flash_bwd_dkv_d64``,
with phase 23's launches; every kernel with its launches in phase 31,
``dense_launches``, and in phase 37, ``fleet_launches``); the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

# the paged attention wrappers' module (the package exports a function
# of the same name, so it is imported by its full name)
PAGED_WRAPPERS = "paddle_tpu_torch.ops.paged_attention_cuda"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
# the served configuration (phase 4) and the block-table width it gives
MAX_BATCH, BLOCK_SIZE, PREFILL_CHUNK, MAX_LEN = 8, 16, 128, 2048
TABLE_WIDTH = MAX_LEN // BLOCK_SIZE + PREFILL_CHUNK // BLOCK_SIZE
# phase 5 limits (see end_to_end). On an H100 the kernels' logits were
# 1.01x (max) and 0.97x (rms) as far from fp32 as the plain bf16 path's,
# and the two bf16 paths differed by 0.060 of the rms logit (1.28); the
# run is deterministic, so the limits leave room only for another
# machine's library versions
DRIFT_RATIO = 1.25
GAP_FRACTION = 0.1
# the training cell (phases 6-8): Llama-3-8B width, depth cut to 8 layers
# (AdamW state with fp32 master weights does not fit 32 layers on one
# 80 GB card), batch 2 x 2048 tokens
TRAIN_LAYERS, TRAIN_B, TRAIN_S = 8, 2, 2048
TRAIN_STEPS, TRAIN_WARMUP = 10, 2
E2E_LAYERS = 2
# phase 8: three AdamW steps of the kernels' and the plain bf16 path, a
# fresh batch each: the largest per-step loss gap relative to the loss,
# and the gap between their changes of the master weights (see
# train_end_to_end). On an H100 the first reading was 2.3e-5 and 0.052
# (the run is deterministic); two planted faults of the plain path, the
# causal mask one key off and the bias correction stuck at step 1, read
# 1.5e-4 / 0.25 and 2.2e-4 / 0.30. The limits lie between
STEP_LOSS_REL = 1e-4
UPDATE_GAP = 0.1


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(p.returncode == 0, f"nvidia-smi failed: {p.stderr.strip()}")
    return p.stdout.strip().splitlines()[0]


def _graph_ms(torch, body, iters: int, replays: int = 3) -> float:
    """Device time of one CUDA-graph replay of ``iters`` calls of ``body``
    (median of ``replays``), in ms. A graph launches its kernels back to
    back, so the host-side cost of the Python wrappers stays out of it."""
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            body()
    g.replay()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def time_ms(fn, iters: int = 50, flush=None) -> float:
    """Device time of one call of ``fn`` in ms: ``iters`` calls captured in
    a CUDA graph and replayed, timed with CUDA events. With ``flush`` (a
    tensor larger than the 50 MB L2) each call follows a rewrite of it, so
    every call finds its inputs cold in device memory as the serving path
    does; the graph of the rewrites alone is timed too and subtracted."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):         # warm-up before capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    if flush is None:
        return _graph_ms(torch, fn, iters) / iters

    def flushed():
        flush.zero_()
        fn()

    total = _graph_ms(torch, flushed, iters)
    return max(total - _graph_ms(torch, flush.zero_, iters), 0.0) / iters


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = flops / peak_flops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _ptxas_check(_build, source: str, what: str) -> dict:
    """The ptxas lines of one source in the build log: none may show a
    spill or an ignored ``setmaxnreg`` (warning C7508). Returns the count
    of its lines and its wgmma performance warnings (reported, not
    fatal)."""
    import re

    text = _build.BUILD_INFO["log"]
    part = text.split(f"== {source}", 1)
    lines = part[1].split("\n== ", 1)[0].splitlines() if len(part) > 1 \
        else []
    spills, kernel = [], "?"
    for ln in lines:
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            kernel = m.group(1)
        if any(int(n) for n in re.findall(r"(\d+) bytes spill "
                                          r"(?:stores|loads)", ln)):
            spills.append(f"{kernel}: {ln.strip()}")
    ignored = [ln.strip() for ln in lines
               if "C7508" in ln or "setmaxnreg ignored" in ln]
    check(not spills, f"{what} build spills: {spills}")
    check(not ignored, f"{what} build ignores setmaxnreg: {ignored}")
    # ptxas's performance notes on wgmma: serialized products (C7510) or a
    # fence it had to inject (C7519)
    wgmma = [ln.strip() for ln in lines if "C7510" in ln or "C7519" in ln]
    return dict(ptxas_lines=len(lines), wgmma_warnings=wgmma)


def _no_local_bytes(conf: dict, name: str) -> None:
    check(conf["local_bytes"] == 0,
          f"{name}: {conf['local_bytes']} local bytes a thread")


def flash_bwd_build(_build, fac) -> dict:
    """Phase 2's check of the flash backward kernels' build: for each head
    dim, their registers, shared memory, ring and tile sizes (from the
    library), and no spill or ignored ``setmaxnreg`` in the ptxas lines of
    ``flash_attention_bwd.cu``."""
    ptxas = _ptxas_check(_build, "flash_attention_bwd.cu", "flash backward")
    conf = {f"D={D}": fac.backward_config(D) for D in (64, 128)}
    for per_d in conf.values():
        for name, c in per_d.items():
            _no_local_bytes(c, name)
    return dict(ptxas, **conf)


def flash_fwd_build(_build, fac) -> dict:
    """Phase 2's check of the flash forward kernel's build, as
    :func:`flash_bwd_build`: its launch shape at each head dim and no spill
    or ignored ``setmaxnreg`` in ``flash_attention.cu``."""
    ptxas = _ptxas_check(_build, "flash_attention.cu", "flash forward")
    conf = {f"D={D}": fac.forward_config(D) for D in (64, 128)}
    for D, c in conf.items():
        _no_local_bytes(c, f"flash_fwd {D}")
    return dict(ptxas, **conf)


def stream_gemm_build(_build) -> dict:
    """Phase 2's check of the weight-streaming kernels' build (w8_matmul,
    fused LoRA's second launch, the bf16 streaming product in both W
    layouts; one main loop, ``stream_gemm.cuh``): each
    instantiation's launch shape, registers and local bytes (none may have
    any), and no spill in the ptxas lines of either source."""
    from paddle_tpu_torch.ops import (fused_lora_cuda, int8_cuda,
                                      stream_matmul_cuda)

    out = {}
    for source, name, conf in (
            ("w8_matmul.cu", "w8_matmul", int8_cuda.kernel_config()),
            ("fused_lora.cu", "fused_lora", fused_lora_cuda.kernel_config()),
            ("stream_matmul.cu", "stream_matmul",
             stream_matmul_cuda.kernel_config())):
        ptxas = _ptxas_check(_build, source, name)
        for key, c in conf.items():
            _no_local_bytes(c, f"{name} {key}")
        out[name] = dict(ptxas, **conf)
    return out


def decode_tick_build(_build) -> dict:
    """The whole-tick kernel's build: each of its 4 instantiations' launch
    shape, registers and local bytes (none may have any), and no spill or
    ignored ``setmaxnreg`` in the ptxas lines of ``decode_megakernel.cu``."""
    from paddle_tpu_torch.ops import decode_megakernel_cuda as mkc

    ptxas = _ptxas_check(_build, "decode_megakernel.cu", "decode_tick")
    conf = mkc.kernel_config()
    for name, c in conf.items():
        _no_local_bytes(c, f"decode_tick {name}")
    return dict(ptxas, **conf)


def host_us(torch, fn, calls: int = 200) -> float:
    """Host time of one eager call of ``fn`` in us: the wrapper's checks,
    allocations and launches, the card left to run behind them (``calls``
    launches stay well inside the launch queue)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def _repeats(torch, fn, first, times: int = 3) -> bool:
    """``times`` more launches of ``fn`` all give the bits of ``first``."""
    return all(_repeatable(torch, fn, first) for _ in range(times))


# --------------------------------------------------------------- phase 3
def kernel_rms_norm(torch, fused_norm, cfg):
    from torch.nn import functional as F

    D, eps = cfg.hidden_size, cfg.rms_norm_eps
    g = torch.Generator(device="cuda").manual_seed(1)
    cases = []
    # a decode tick's and a prefill chunk's rows, then a train step's B x S
    for rows in (8, 128, TRAIN_B * TRAIN_S):
        x = torch.randn(rows, D, generator=g, device="cuda").to(torch.bfloat16)
        w = (1 + 0.1 * torch.randn(D, generator=g, device="cuda")).to(
            torch.bfloat16)
        y = fused_norm.rms_norm_cuda(x, w, eps)
        ref = fused_norm._rms_ref(x, w, eps)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(y.float()).all()), "rms_norm: non-finite")
        diff = (y.float() - ref.float()).abs()
        err = diff.max().item()
        # kernel and plain version differ only in fp32 summation order and
        # rsqrt rounding, so each output element may land one bf16 step
        # (2^-7 of its magnitude) away: the tolerance is elementwise
        tol_el = 2.0 ** -7 * ref.float().abs() + 1e-6
        worst = (diff / tol_el).max().item()
        check(worst <= 1.0, f"rms_norm rows={rows}: an element is off by "
                            f"{worst:.3g} x its tolerance of one bf16 step")
        b, by = bound_ms(2 * (2 * rows * D + D), 4 * rows * D, FP32_FLOPS)
        case = dict(rows=rows, dim=D, max_abs_err=err,
                    worst_err_over_tol=worst,
                    ms=time_ms(lambda: fused_norm.rms_norm_cuda(x, w, eps),
                               200),
                    plain_ms=time_ms(lambda: fused_norm._rms_ref(x, w, eps),
                                     200),
                    bound_ms=b, bound_by=by,
                    library_ms=time_ms(lambda: F.rms_norm(x, (D,), w, eps),
                                       200))
        log(f"kernel rms_norm rows={rows}x{D} bf16: " + json.dumps(case))
        cases.append(case)
    return cases


def _paged_case(torch, g, B, W, H, KV, D, bs, pos, M):
    """Block-table case: blocks handed out in a scrambled order, tail
    entries of every row (M wide) left on scratch block 0, scratch poisoned
    with +-1e9."""
    need = [(p + W - 1) // bs + 1 for p in pos]
    check(M > max(need), "table too narrow for the case")
    N = sum(need) + 8
    kp = torch.randn(N, bs, KV, D, generator=g, device="cuda").to(torch.bfloat16)
    vp = torch.randn(N, bs, KV, D, generator=g, device="cuda").to(torch.bfloat16)
    kp[0] = 1e9
    vp[0] = -1e9
    q = torch.randn(B, W, H, D, generator=g, device="cuda").to(torch.bfloat16)
    perm = (torch.randperm(N - 1, generator=torch.Generator().manual_seed(2))
            + 1).tolist()
    tables = torch.zeros(B, M, dtype=torch.int32)
    took = 0
    for b in range(B):
        tables[b, :need[b]] = torch.tensor(perm[took:took + need[b]])
        took += need[b]
    return (q, kp, vp, tables.cuda(), torch.tensor(pos, dtype=torch.int32,
                                                   device="cuda"))


# The cases of phases 3 and 9, as (form, B, W, pos): decode at the served
# batch (8 rows: mid-block, a block boundary on each side — 511 ends block
# 31, 512 opens block 32 — long contexts and a short one of 6 keys, where
# one key more or less moves the output far past the tolerance) and the
# prefill chunk behind earlier chunks, the serving path's shapes (the first
# two, the kernels line's); then decode with every row at 2047 keys and
# with one long row among short ones, a verify window of 4 tokens, the
# prefill chunks at start 0 and at 1920 (the last chunk at MAX_LEN), and
# the speculative server's verify window (phase 26: k = 4, W = 5, the
# served batch of 8 at mixed lengths, two windows across a block boundary)
PAGED_FORMS = [("decode", 8, 1, [1000, 511, 512, 255, 37, 700, 128, 5]),
               ("prefill", 1, PREFILL_CHUNK, [384]),
               ("decode_all_long", 8, 1, [MAX_LEN - 1] * 8),
               ("decode_512", 8, 1, [512] * 8),
               ("decode_one_long", 8, 1, [MAX_LEN - 1, 3, 17, 0, 9, 31, 1,
                                          64]),
               ("verify", 4, 4, [0, 125, 700, MAX_LEN - 4]),
               ("prefill_0", 1, PREFILL_CHUNK, [0]),
               ("prefill_last", 1, PREFILL_CHUNK, [MAX_LEN - PREFILL_CHUNK]),
               ("verify_5", 8, 5, [1000, 511, 509, 255, 37, 700, 13, 128])]


def paged_attention_build(_build) -> dict:
    """Phase 2's check of the paged attention kernel's build: its launch
    shape per pool type, registers and local bytes (none may have any), and
    no spill in the ptxas lines of ``paged_attention.cu``."""
    pac = importlib.import_module(PAGED_WRAPPERS)

    ptxas = _ptxas_check(_build, "paged_attention.cu", "paged attention")
    conf = pac.kernel_config()
    for name, c in conf.items():
        _no_local_bytes(c, f"paged_attention {name}")
    return dict(ptxas, **conf)


def _paged_kernel_cases(torch, ops, pa, cfg, quant: bool, seed: int):
    """Phases 3 (fp pools) and 9 (int8 pools): the paged attention kernel
    against its plain twin at every case of ``PAGED_FORMS``, scratch block
    0 poisoned (fp: +-1e9; int8: full codes at a huge scale). Tolerance per
    output row; it must reject each planted fault of the plain version: the
    causal mask one key off either way, the wrong page (the first table
    entry of row 0 pointing at a block of no row), one split of the
    kernel's plan dropped from the merge (its keys taken out of the rows
    that hold them) and, for int8, each page read with the scales of the
    block at the next table entry."""
    from torch.nn import functional as F

    pac = importlib.import_module(PAGED_WRAPPERS)

    name = "paged_attention_int8" if quant else "paged_attention"
    wrapper = pac.paged_attention_int8_cuda if quant else \
        pac.paged_attention_cuda
    plain_fn = pa.paged_verify_attention_q if quant else \
        pa.paged_verify_attention
    H, KV, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    bs = BLOCK_SIZE
    g = torch.Generator(device="cuda").manual_seed(seed)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    cases = []
    for form, B, W, pos in PAGED_FORMS:
        q, kp, vp, tables, posv = _paged_case(torch, g, B, W, H, KV, D, bs,
                                              pos, TABLE_WIDTH)
        N = kp.shape[0]
        if quant:
            kq, ks = pa.quantize_block_kv(kp)
            vq, vs = pa.quantize_block_kv(vp)
            kq[0], vq[0] = 127, -127
            ks[0], vs[0] = 1e9, 1e9
            args = (q, kq, ks, vq, vs, tables, posv)
            pools = (kq, vq)
            rms_v = pa.dequantize_block_kv(vq[1:], vs[1:]).square().mean() \
                .sqrt().item()
        else:
            args = (q, kp, vp, tables, posv)
            pools = (kp, vp)
            rms_v = vp[1:].float().square().mean().sqrt().item()
        del kp, vp
        out = wrapper(*args)
        ops.set_kernel_mode("reference")
        ref = plain_fn(*args)
        ops.set_kernel_mode("auto")
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out.float()).all()),
              f"{name} {form}: non-finite output (scratch leaked?)")
        # Tolerance per output row (b, w, h), scaled to what is compared:
        # each output is rounded to bf16 once on either side, which may
        # leave them one bf16 step apart (2^-7 x the row's largest value);
        # p is rounded to bf16 at another scale than in the plain version
        # (unnormalised per 64-key stage vs normalised), a relative error
        # of at most 2^-8 per key that averages out over the keys: 2^-8 x
        # rms(V) (int8: of the dequantized values) bounds its sum even for
        # a row with a single key
        worst = _row_ratio(out, ref, rms_v).max().item()
        check(worst <= 1.0, f"{name} {form}: a row is off by {worst:.3g} x "
                            f"its tolerance")
        # the planted faults, each the plain version on changed inputs.
        # Scratch block 0 gets ordinary values for this, so that a key read
        # past a row's last block is a plausible key, not the poison
        kc, vc = pools[0].clone(), pools[1].clone()
        kc[0], vc[0] = pools[0][1], pools[1][1]
        if quant:
            ksc, vsc = ks.clone(), vs.clone()
            ksc[0], vsc[0] = ks[1], vs[1]
        qpos = posv.long()[:, None] + torch.arange(W, device="cuda")[None]

        def core(tbl, qp, scale_tbl=None):
            ck, cv = pa.gather_block_kv(kc, tbl), pa.gather_block_kv(vc, tbl)
            if not quant:
                return pa._attention_core(q, ck, cv, qp)
            st = tbl if scale_tbl is None else scale_tbl
            return pa._attention_core(q, ck, cv, qp,
                                      pa.gather_block_scales(ksc, st, bs),
                                      pa.gather_block_scales(vsc, st, bs))

        faults = {f"mask{d:+d}": core(tables, qpos + d) for d in (1, -1)}
        wrong = tables.clone()
        wrong[0, 0] = N - 1                 # _paged_case leaves it unused
        faults["wrong_page"] = core(wrong, qpos)
        # split 0 of the plan dropped: its table entries moved past every
        # row's frontier, the rows' positions moved down by its keys; rows
        # that see no key past it keep the reference (no split merged)
        plan = pac.plan(B, W, H, KV, bs, TABLE_WIDTH)
        sk = plan["split_keys"]
        held = (qpos >= sk)[:, :, None, None]
        if bool(held.any()):
            moved = torch.cat([tables[:, sk // bs:], tables[:, :sk // bs]],
                              1)
            faults["split_dropped"] = torch.where(
                held, core(moved, qpos - sk), ref)
        if quant:
            faults["wrong_scale"] = core(tables, qpos,
                                         torch.roll(tables, -1, 1))
        mutants = {}
        for fname, fo in faults.items():
            r = _row_ratio(fo, ref, rms_v)
            mutants[fname] = dict(worst_err_over_tol=r.max().item(),
                                  rows_failed=(r > 1.0).float().mean()
                                  .item())
            check(r.max().item() > 1.0,
                  f"{name} {form}: the tolerance passes the {fname} fault "
                  f"({r.max().item():.3g} x tolerance)")
        del faults, kc, vc
        # bytes this data needs: q and out once, each visible K/V row once
        # (int8: one byte an element, with its block's two scales)
        ctx = [p + W for p in pos]             # keys of the last row
        if quant:
            kv_bytes = sum(c * KV * D * 2 + -(-c // bs) * KV * 8
                           for c in ctx)
        else:
            kv_bytes = sum(c * KV * D * 2 * 2 for c in ctx)
        nbytes = 2 * q.numel() * 2 + kv_bytes + tables.numel() * 4 + B * 4
        # QK and PV: 2 flops per multiply-add, each query row over its
        # visible keys
        vis = sum(p + w + 1 for p in pos for w in range(W))
        b, by = bound_ms(nbytes, 4 * D * H * vis, BF16_FLOPS)
        # library yardstick: SDPA over the gathered dense K/V (int8:
        # dequantized; GQA heads expanded, boolean position mask), made
        # outside the timing
        ck = pa.gather_block_kv(pools[0], tables)
        cv = pa.gather_block_kv(pools[1], tables)
        if quant:
            ck = (ck.float() * pa.gather_block_scales(ks, tables, bs)[
                ..., None]).to(torch.bfloat16)
            cv = (cv.float() * pa.gather_block_scales(vs, tables, bs)[
                ..., None]).to(torch.bfloat16)
        ck = ck.repeat_interleave(H // KV, 2)
        cv = cv.repeat_interleave(H // KV, 2)
        qs, kss, vss = (t.transpose(1, 2).contiguous() for t in (q, ck, cv))
        del ck, cv
        L = kss.shape[2]
        mask = (torch.arange(L, device="cuda")[None, None, :]
                <= qpos[:, :, None])[:, None]

        def plain():
            ops.set_kernel_mode("reference")
            plain_fn(*args)
            ops.set_kernel_mode("auto")

        case = dict(form=form, B=B, W=W, H=H, KV=KV, D=D, block_size=bs,
                    pos=pos, plan=plan,
                    max_abs_err=(out.float() - ref.float()).abs().max()
                    .item(),
                    worst_err_over_tol=worst, mutants=mutants,
                    ms=time_ms(lambda: wrapper(*args), 50, flush),
                    plain_ms=time_ms(plain, 20, flush),
                    bound_ms=b, bound_by=by,
                    library_ms=time_ms(
                        lambda: F.scaled_dot_product_attention(
                            qs, kss, vss, attn_mask=mask), 50, flush),
                    host_us=host_us(torch, lambda: wrapper(*args)))
        log(f"kernel {name} {form}: " + json.dumps(case))
        cases.append(case)
        del qs, kss, vss, mask, args, pools, out, ref
    return cases


def kernel_paged_attention(torch, ops, pa, cfg):
    return _paged_kernel_cases(torch, ops, pa, cfg, quant=False, seed=3)


# -------------------------------------------------------------- phase 28
# Batch invariance of the decode and verify products: the row counts a
# decode tick (1, 8, 16 rows), a verify window (40 = 8 x 5) and larger
# batches run, past one 128-row token tile too (160 = 32 x 5, a 32-slot
# server's k = 4 window; 512, four tiles), and Llama-3-8B's product
# shapes (K, N)
INVARIANCE_ROWS = (1, 8, 16, 40, 64, 128, 160, 512)
# the row counts each product is also held against its plain twin and timed
TIMED_ROWS = (8, 40, 160)
PRODUCT_SHAPES = (("gate_up", 4096, 14336), ("q_o", 4096, 4096),
                  ("k_v", 4096, 1024), ("down", 14336, 4096),
                  ("lm_head", 4096, 128256))
LORA_TARGETS = (("q", 4096, 4096), ("gate", 4096, 14336),
                ("down", 14336, 4096))


def _row_mismatches(torch, fn, K, g):
    """The bits of one row of x through ``fn`` (x (M, K) bf16 -> (M, N))
    inside batches of every M in INVARIANCE_ROWS, at the first and the
    last row, the other rows random each time, against the same row at M =
    8. Returns (the M, position pairs whose row differs, the row at M =
    8)."""
    row = torch.randn(1, K, generator=g, device="cuda").to(torch.bfloat16)

    def at(M, r):
        x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
        x[r] = row[0]
        return fn(x, r)[r]

    want = at(8, 3)
    bad = [(M, r) for M in INVARIANCE_ROWS for r in sorted({0, M - 1})
           if not torch.equal(at(M, r), want)]
    return bad, want


def _split_by_rows(torch, fn, K):
    """A planted fault: ``fn`` at up to 8 rows, and above 8 rows the same
    kernel over the two halves of K, added in fp32 and rounded again (a K
    split that follows the row count)."""
    def mutant(x, r):
        if x.shape[0] <= 8:
            return fn(x, r, 0, K)
        h = K // 2
        return (fn(x, r, 0, h).float() + fn(x, r, h, K).float()).to(
            torch.bfloat16)
    return mutant


def batch_invariance(torch, ops):
    """Phase 28: every product of a decode tick and a verify window is
    batch-invariant. For each Llama-3-8B shape (q/o, k/v, gate/up, down,
    the lm-head; and the lm-head tied, W^T read K-major) the bf16 streaming
    product, w8_matmul (int8 weights) and, for q, gate and down, the fused
    LoRA kernel (an adapter a row, the tested row always on one page) give
    one row the same bits at M in INVARIANCE_ROWS, whatever the rows
    beside it, as at M = 8: the token tile runs 8 to 128 rows, so the
    check also shows that a wgmma's sum for one element does not depend on
    its N; 160 and 512 rows run several token tiles. A planted fault (a K
    split that follows M) fails the same check; cuBLAS (``torch.matmul``)
    is checked alike, as a diagnostic. The bf16 and int8 kernels are held
    against their plain twins per element (one bf16 step plus the fp32
    summation bound) and, with fused LoRA, timed at each of TIMED_ROWS
    beside ``torch.matmul`` of the same shape."""
    from paddle_tpu_torch.ops import int8 as i8
    from paddle_tpu_torch.ops import stream_matmul as smm
    from paddle_tpu_torch.ops.fused_lora_cuda import fused_lora_matmul_cuda
    from paddle_tpu_torch.ops.int8_cuda import plan, w8_matmul_cuda
    from paddle_tpu_torch.ops.stream_matmul_cuda import stream_matmul_cuda
    from paddle_tpu_torch.nn import lora as tl

    g = torch.Generator(device="cuda").manual_seed(28)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    res = {"rows": INVARIANCE_ROWS, "bf16": [], "int8": [], "lora": [],
           "cublas_rows_differing": {}}
    shapes = PRODUCT_SHAPES + (("lm_head_tied", 4096, 128256),)
    for name, K, N in shapes:
        tied = name == "lm_head_tied"
        w = (0.02 * torch.randn(N if tied else K, K if tied else N,
                                generator=g, device="cuda")).to(
            torch.bfloat16)
        wk = w.t() if tied else w

        def bf(x, r, k0=0, k1=K):
            if k0 == 0 and k1 == K:
                return stream_matmul_cuda(x, w, tied)
            return stream_matmul_cuda(x[:, k0:k1].contiguous(),
                                      (w[:, k0:k1] if tied else w[k0:k1])
                                      .contiguous(), tied)

        bad, _ = _row_mismatches(torch, bf, K, g)
        check(not bad, f"phase 28: stream_matmul {name} {K}x{N}: the row "
                       f"differs at (M, row) {bad}")
        if name == "q_o":
            fault, _ = _row_mismatches(torch, _split_by_rows(torch, bf, K),
                                       K, g)
            check(bool(fault), "phase 28: the check passes a K split that "
                               "follows the row count")
            res["planted_fault_rows_differing"] = len(fault)
        lib, _ = _row_mismatches(torch, lambda x, r: torch.matmul(x, wk), K,
                                 g)
        res["cublas_rows_differing"][name] = len(lib)
        for M in TIMED_ROWS:
            x = torch.randn(M, K, generator=g, device="cuda").to(
                torch.bfloat16)
            out = stream_matmul_cuda(x, w, tied)
            ref = smm._stream_plain(x, w, tied)
            torch.cuda.synchronize()
            mag = x.float().abs() @ wk.float().abs()
            worst = _el_ratio(out, ref, mag, K).max().item()
            check(worst <= 1.0, f"phase 28: stream_matmul {name} M={M}: an "
                                f"element is off by {worst:.3g} x its "
                                f"tolerance")
            lost = smm._stream_plain(x[:, :-128], (w[:, :-128] if tied
                                                   else w[:-128]), tied)
            check(_el_ratio(lost, ref, mag, K).max().item() > 1.0,
                  f"phase 28: stream_matmul {name}: the tolerance passes a "
                  f"lost K slice")
            check(_repeats(torch, lambda: stream_matmul_cuda(x, w, tied),
                           out), f"phase 28: stream_matmul {name} M={M}: a "
                                 f"repeated launch differs")
            b, by = bound_ms(2 * K * N + 2 * M * K + 2 * M * N, 2 * M * K * N,
                             BF16_FLOPS)
            case = dict(shape=name, M=M, K=K, N=N, plan=plan(M, K, N),
                        max_abs_err=(out.float() - ref.float()).abs()
                        .max().item(), worst_err_over_tol=worst,
                        ms=time_ms(lambda: stream_matmul_cuda(x, w, tied),
                                   50, flush),
                        host_us=host_us(torch, lambda: stream_matmul_cuda(
                            x, w, tied)),
                        plain_ms=time_ms(lambda: smm._stream_plain(
                            x, w, tied), 3, flush),
                        bound_ms=b, bound_by=by,
                        library_ms=time_ms(lambda: torch.matmul(x, wk), 50,
                                           flush))
            case["ms_over_library"] = case["ms"] / case["library_ms"]
            log(f"phase 28 stream_matmul {name} M={M}: " + json.dumps(case))
            res["bf16"].append(case)
        if tied:
            del w, wk
            torch.cuda.empty_cache()
            continue
        wq, sc = i8.quantize_per_channel(w)

        def w8(x, r, k0=0, k1=K):
            return w8_matmul_cuda(x, wq, sc)

        bad, _ = _row_mismatches(torch, w8, K, g)
        check(not bad, f"phase 28: w8_matmul {name} {K}x{N}: the row differs "
                       f"at (M, row) {bad}")
        for M in TIMED_ROWS:
            x = torch.randn(M, K, generator=g, device="cuda").to(
                torch.bfloat16)
            out = w8_matmul_cuda(x, wq, sc)
            ref = i8._w8_plain(x, wq, sc)
            torch.cuda.synchronize()
            mag = x.float().abs() @ (wq.float().abs() * sc)
            worst = _el_ratio(out, ref, mag, K).max().item()
            check(worst <= 1.0, f"phase 28: w8_matmul {name} M={M}: an "
                                f"element is off by {worst:.3g} x its "
                                f"tolerance")
            b, by = bound_ms(K * N + 4 * N + 2 * M * K + 2 * M * N,
                             2 * M * K * N, BF16_FLOPS)
            case = dict(shape=name, M=M, K=K, N=N, worst_err_over_tol=worst,
                        ms=time_ms(lambda: w8_matmul_cuda(x, wq, sc), 50,
                                   flush), bound_ms=b, bound_by=by,
                        library_ms=time_ms(lambda: torch.matmul(x, w), 50,
                                           flush))
            log(f"phase 28 w8_matmul {name} M={M}: " + json.dumps(case))
            res["int8"].append(case)
        del w, wq, sc
        torch.cuda.empty_cache()
    R, L, layer = LORA_MAX_RANK, 1, 0
    for t, K, N in LORA_TARGETS:
        w = (0.02 * torch.randn(K, N, generator=g, device="cuda")).to(
            torch.bfloat16)
        A = 0.02 * torch.randn(4, L, K, R, generator=g, device="cuda")
        Bf = 0.02 * torch.randn(4, L, R, N, generator=g, device="cuda")
        A[0].zero_()
        Bf[0].zero_()
        s = torch.tensor([0.0, 2.0, 1.0, 0.5], device="cuda")

        def lora(x, r, k0=0, k1=K):
            M = x.shape[0]
            ai = (torch.arange(M, device="cuda") % 4).to(torch.int32)
            ai[r] = 1
            return fused_lora_matmul_cuda(x[:, None, :], w, A, Bf, s, layer,
                                          ai)[:, 0]

        bad, _ = _row_mismatches(torch, lora, K, g)
        check(not bad, f"phase 28: fused_lora {t} {K}x{N}: the row differs "
                       f"at (M, row) {bad}")
        for M in TIMED_ROWS:
            x = torch.randn(M, 1, K, generator=g, device="cuda").to(
                torch.bfloat16)
            ai = (torch.arange(M, device="cuda") % 4).to(torch.int32)
            pooled = tl.PooledFactors(A, Bf, s, layer, ai)

            def library():
                torch.matmul(x, w)
                tl.bgmv(x, pooled)

            case = dict(target=t, M=M, K=K, N=N, rank=R,
                        ms=time_ms(lambda: fused_lora_matmul_cuda(
                            x, w, A, Bf, s, layer, ai), 50, flush),
                        library_ms=time_ms(library, 20, flush))
            log(f"phase 28 fused_lora {t} M={M}: " + json.dumps(case))
            res["lora"].append(case)
        del w, A, Bf
        torch.cuda.empty_cache()
    res["wgmma_n_invariant"] = True       # every check above passed
    log("phase 28, batch invariance: " + json.dumps(
        {k: v for k, v in res.items() if k not in ("bf16", "int8", "lora")}))
    return res


def clear_blocks_cost(torch, srv, cleared):
    """What clearing an int8 pool's fresh blocks cost a run: the calls, the
    blocks and the host ms spent in them (``cleared``: (blocks, seconds)
    a call), its launches a call (an ``index_fill_`` a pool tensor: 4 a
    layer), and one call's device ms on one free block (events around 20
    calls)."""
    ex = srv._exec
    out = dict(calls=len(cleared), blocks=sum(n for n, _ in cleared),
               host_ms=sum(t for _, t in cleared) * 1e3,
               launches_a_call=len(ex._flat_pools))
    free = srv.alloc._free
    if free:
        ex.clear_blocks([free[-1]])
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t = time.perf_counter()
        a.record()
        for _ in range(20):
            ex.clear_blocks([free[-1]])
        b.record()
        torch.cuda.synchronize()
        out["host_us_a_call"] = (time.perf_counter() - t) / 20 * 1e6
        out["device_ms_a_call"] = a.elapsed_time(b) / 20
    return out


# --------------------------------------------------------------- phase 4
PHASE4_LENS = [100, 1000, 517, 256, 733, 129, 384, 960, 211, 640, 300, 871]


def phase4_traffic(cfg):
    """Phase 4's requests: (prompts, max_new_tokens). 12 requests > 8
    slots: slots refill mid-flight; lengths span 1-8 chunks of 128, some
    ending mid-block, two on a chunk boundary."""
    import numpy as np

    rng = np.random.default_rng(0)
    news = rng.integers(32, 65, len(PHASE4_LENS)).tolist()
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in PHASE4_LENS]
    return prompts, news


# the executor's passes, each with the keyword that counts its units: a
# decode window's ticks, a speculative trip's verify windows
EXECUTOR_PASSES = (("decode_paged", "ticks"), ("chunk_prefill", None),
                   ("spec_scan", "windows"), ("spec_verify", None))


def serve(torch, ops, model, label="serve llama3-8b paged", adapters=None,
          expect=None, expect_per_pass=None, graphs=True, traffic=None,
          requests_kw=None, warmup=None, prime=None, breakdown=None,
          **server_kw):
    """Phase 4's traffic (or ``traffic``: (prompts, max_new_tokens), with
    ``requests_kw`` each request's other ``submit`` arguments) through
    ``GenerationServer(**server_kw)``; ``adapters`` names each request's
    LoRA adapter (phase 10), ``expect`` maps (launches, passes, stats) to
    {kernel: wanted launches} (default: the fp path's attention and
    norms), ``expect_per_pass`` maps an executor pass ("decode_paged",
    "chunk_prefill", "spec_scan", "spec_verify") to the launches every
    such pass must make per unit (a decode window's tick, a speculative
    trip's window; phase 14). ``graphs=False`` turns the executor's CUDA
    graphs off (every pass eager: phase 24's yardstick); with them on,
    every decode window, prefill chunk and speculative trip of the run
    must be a replay of a graph captured before it (by the warm-up
    requests: ``warmup``, a list of (prompt, max_new_tokens, submit
    keywords); default one greedy request), then ``prime(srv)`` when
    given. ``breakdown(torch, srv)``
    reads the passes' host and device times after the run (default
    :func:`pass_breakdown`). Returns (readings, longest prompt, server);
    the readings' "tokens" holds every request's output, in order."""
    from paddle_tpu_torch.inference.serving import GenerationServer

    # earlier servers (executor and server refer to each other) and their
    # graphs' pools would count in this cell's peak memory
    t_cell = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = model.cfg
    srv = GenerationServer(model, cache="paged", max_batch=MAX_BATCH,
                           block_size=BLOCK_SIZE, prefill_chunk=PREFILL_CHUNK,
                           max_len=MAX_LEN, **server_kw)
    if srv.spec is None:
        check(srv._table_width == TABLE_WIDTH, "block-table width")
    ex = srv._exec
    check(ex.graphs, f"{label}: the executor does not graph its passes on "
                     f"the card")
    ex.graphs = graphs
    # each model pass's own launches: (kind, units, {kernel: launches})
    per_pass = []
    for kind, unit in EXECUTOR_PASSES:
        def counted(*a, _fn=getattr(ex, kind), _kind=kind, _unit=unit, **k):
            before = ops.launch_counts()
            out = _fn(*a, **k)
            per_pass.append((_kind, k.get(_unit, 1) if _unit else 1,
                             {n: c - before[n] for n, c in
                              ops.launch_counts().items()}))
            return out
        setattr(ex, kind, counted)
    # int8 pools: the blocks cleared as they are allocated (calls, blocks,
    # host seconds inside the call)
    cleared = []

    def clearing(bids, _fn=ex.clear_blocks):
        t = time.perf_counter()
        _fn(bids)
        cleared.append((len(bids), time.perf_counter() - t))
    ex.clear_blocks = clearing
    # warm-up requests (cuBLAS handles, allocator, the graphs' captures):
    # not part of the run
    for prompt, new, kw in warmup or [(list(range(1, 40)),
                                       4 * srv.tick_window, {})]:
        srv.submit(prompt, max_new_tokens=new, **kw)
    srv.run()
    if prime is not None:
        prime(srv)
    t_setup = time.perf_counter() - t_cell
    prompts, news = traffic or phase4_traffic(cfg)
    if not graphs:
        # an eager twin serves the traffic's first EAGER_REQUESTS requests
        prompts, news = prompts[:EAGER_REQUESTS], news[:EAGER_REQUESTS]
    adapters = (adapters or [None] * len(prompts))[:len(prompts)]
    requests_kw = (requests_kw or [{}] * len(prompts))[:len(prompts)]
    t_before = srv.throughput_stats()
    ad_before = srv.adapter_stats()
    sm_before = srv.spec_metrics()
    replays_before, captures_before = dict(ex.replays), ex.captures
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    per_pass.clear()
    cleared.clear()
    t0 = time.perf_counter()
    rids = [srv.submit(p, max_new_tokens=m, adapter=a, **kw)
            for p, m, a, kw in zip(prompts, news, adapters, requests_kw)]
    out = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    t_after = srv.throughput_stats()
    st = {k: t_after[k] - t_before[k] for k in t_after}
    replays = {k: n - replays_before[k] for k, n in ex.replays.items()}
    for rid, p, m in zip(rids, prompts, news):
        check(rid in out, f"request {rid} did not finish")
        toks = out[rid]
        check(toks[:len(p)] == p and len(toks) == len(p) + m,
              f"request {rid}: {len(toks)} tokens, want {len(p) + m}")
        check(all(0 <= t < cfg.vocab_size for t in toks[len(p):]),
              f"request {rid}: token id out of range")
    passes = st["decode_ticks"] + st["prefill_chunks"] + st["verify_windows"]
    L = cfg.num_hidden_layers
    # every decode tick, verify window and prefill chunk: one attention per
    # layer, two norms per layer plus the final norm
    # (and the bf16 streaming product for the 7 projections of every
    # layer and the head, each decode tick and verify window)
    want = (expect or (lambda st: {
        "paged_attention": L * passes, "rms_norm": (2 * L + 1) * passes,
        "stream_matmul": (7 * L + 1) * (st["decode_ticks"]
                                        + st["verify_windows"])}))(st)
    for name, n in want.items():
        check(launches[name] == n, f"{label}: {name} launches "
                                   f"{launches[name]} != {n} ({passes} model "
                                   f"passes: {st['decode_ticks']} ticks, "
                                   f"{st['verify_windows']} verify windows, "
                                   f"{st['prefill_chunks']} chunks)")
    calls = st["decode_trips"] + st["prefill_chunks"] + st["verify_trips"]
    check(len(per_pass) == calls, f"{label}: {len(per_pass)} executor "
                                  f"calls for {calls} passes")
    # every pass of the run a graph replay, none captured in it (or, with
    # the graphs off, none replayed)
    want_replays = ({"decode": st["decode_trips"],
                     "chunk": st["prefill_chunks"],
                     "spec": st["verify_trips"]} if graphs
                    else {"decode": 0, "chunk": 0, "spec": 0})
    check(replays == want_replays and ex.captures == captures_before,
          f"{label}: graph replays {replays}, want {want_replays}; "
          f"{ex.captures - captures_before} captures during the run")
    for kind, want_one in (expect_per_pass or {}).items():
        for k, units, got in per_pass:
            if k != kind:
                continue
            for name, n in want_one.items():
                check(got[name] == n * units,
                      f"{label}: a {kind} pass of {units} units launched "
                      f"{name} {got[name]} times, want {n * units}")
    res = dict(requests=len(rids), wall_s=wall, graphs=graphs,
               tick_window=srv.tick_window, graph_replays=replays,
               graph_captures=ex.captures,
               pass_launches=_pass_signatures(per_pass),
               prefill_tokens=st["prefill_tokens"],
               prefill_chunks=st["prefill_chunks"],
               prefill_tok_s=st["prefill_tokens"] / st["prefill_s"],
               decode_trips=st["decode_trips"],
               decode_ticks=st["decode_ticks"],
               decode_tokens=st["decode_tokens"],
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               peak_reserved_gib=torch.cuda.max_memory_reserved() / 2 ** 30,
               launches=launches)
    if st["decode_ticks"]:
        res["ms_per_decode_tick"] = st["decode_s"] / st["decode_ticks"] * 1e3
    if srv.alloc.kv_quant == "int8":
        res["clear_blocks"] = clear_blocks_cost(torch, srv, cleared)
    if srv.spec is None:
        res["decode_tok_s"] = st["decode_tokens"] / st["decode_s"]
    else:
        # every emitted token, plain and speculative trips together
        tokens = st["decode_tokens"] + st["verify_tokens"]
        secs = st["decode_s"] + st["verify_s"]
        sm = srv.spec_metrics()
        spec = {k: sm[k] - sm_before[k] for k in
                ("draft_tokens_proposed", "draft_tokens_accepted",
                 "gated_plain_windows")}
        spec["acceptance_rate"] = (spec["draft_tokens_accepted"]
                                   / max(spec["draft_tokens_proposed"], 1))
        res.update(decode_tok_s=tokens / secs,
                   ms_per_emitted_token=secs / tokens * 1e3,
                   verify_trips=st["verify_trips"],
                   verify_windows=st["verify_windows"],
                   verify_tokens=st["verify_tokens"],
                   ms_per_verify_trip=(st["verify_s"] / st["verify_trips"]
                                       * 1e3 if st["verify_trips"] else None),
                   ms_per_plain_trip=(st["decode_s"] / st["decode_trips"]
                                      * 1e3 if st["decode_trips"] else None),
                   spec=srv.spec.describe(), spec_metrics=spec)
    if srv._lora is not None:
        ad = srv.adapter_stats()
        res["adapters"] = {k: ad[k] - ad_before.get(k, 0) for k in (
            "adapter_hits", "adapter_uploads", "adapter_evictions")}
    log(f"{label}: " + json.dumps(res))
    t_bd = time.perf_counter()
    res["breakdown"] = (breakdown or pass_breakdown)(torch, srv)
    # the cell's own seconds: the server, its warm-up and captures; the
    # served run; the breakdown (printed, not stored)
    log(f"{label}: cell seconds " + json.dumps(dict(
        set_up=t_setup, run=wall, breakdown=time.perf_counter() - t_bd,
        whole=time.perf_counter() - t_cell)))
    res["tokens"] = [out[rid] for rid in rids]
    res["prompts"] = prompts
    for kind, _ in EXECUTOR_PASSES:
        delattr(ex, kind)       # the counting wrappers hold the executor
    return res, max(prompts, key=len), srv


def _pass_signatures(per_pass):
    """Each distinct (executor pass, units, its launches) of a run, as
    sorted strings: an eager twin's passes must each be one of the graphed
    run's (a replay counts what its capture launched)."""
    return sorted({f"{kind} x{units}: " + json.dumps(
        {k: n for k, n in sorted(got.items()) if n})
        for kind, units, got in per_pass})


def _twin_launches(label, graphed, eager):
    """Phase 24's launch check of one cell: every pass the eager twin
    made (its traffic's first EAGER_REQUESTS requests) launched what a
    pass of the same kind and size launched in the graphed run; each run's
    totals are held to the cell's launch rule inside :func:`serve`."""
    missing = sorted(set(eager["pass_launches"])
                     - set(graphed["pass_launches"]))
    check(not missing, f"{label}: eager passes launch otherwise than the "
                       f"graphed run's: {missing}")


def _replayed_ms(torch, fn, passes: int = 5, repeats: int = 5) -> float:
    """Device time of one pass of ``fn`` that replays the executor's graph:
    CUDA events around ``passes`` passes enqueued back to back (the host
    runs ahead, so the device sees no gap after the first), median of
    ``repeats``, per pass."""
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(passes):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / passes)
    return sorted(times)[len(times) // 2]


def pass_breakdown(torch, srv):
    """Host against device time of one decode window (every slot at 512
    tokens of context; ``tick_window`` ticks) and one 128-token prefill
    chunk (behind 384 tokens) through the server's executor: wall time
    (host clock up to a synchronize), the host's enqueue time (the call's
    return, before the device is done) and the device time of the same
    work with no host in the loop — the replay of the executor's own graph
    (events around passes enqueued back to back), or, with its graphs off,
    the eager pass captured in a CUDA graph here — and the device time of
    three passes by kernel class (``torch.profiler``). Run after the
    served requests have finished, on blocks of the server's pool."""
    import statistics

    ex = srv._exec
    B, bs, C = srv.max_batch, srv.block_size, srv.prefill_chunk
    ctx, start = 512, 384
    nblk = (ctx + srv.tick_window - 1) // bs + 1
    tables = torch.zeros(B, srv._table_width, dtype=torch.int32)
    for b in range(B):
        tables[b, :nblk] = torch.arange(1 + b * nblk, 1 + (b + 1) * nblk)
    tables = tables.cuda()
    pos = torch.full((B,), ctx, dtype=torch.int32, device="cuda")
    active = torch.ones(B, dtype=torch.int32, device="cuda")
    toks = torch.ones(B, dtype=torch.int32, device="cuda")
    chunk = torch.ones(1, C, dtype=torch.int32, device="cuda")
    start_v = torch.tensor([start], dtype=torch.int32, device="cuda")
    last_v = torch.tensor([C - 1], dtype=torch.int32, device="cuda")
    aidx = pages = None
    if srv._lora is not None:
        # rows on two adapters' pages and on the null page
        names = srv._lora.registry.names()[:2]
        pages = [srv._lora.acquire(n) for n in names]
        aidx = torch.tensor([pages[b % 3] if b % 3 < 2 else 0
                             for b in range(B)], dtype=torch.int32,
                            device="cuda")

    def tick():
        return ex.decode_paged(toks, tables, pos, None, None, None, active,
                               None, aidx=aidx, greedy=True,
                               ticks=srv.tick_window)

    def prefill():
        return ex.chunk_prefill(chunk, tables[0], start_v, last_v,
                                None if aidx is None else aidx[:1])

    res = {}
    for name, fn in (("decode_window", tick), ("prefill_chunk", prefill)):
        fn()
        torch.cuda.synchronize()
        walls, enq = [], []
        for _ in range(7):
            t0 = time.perf_counter()
            fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            enq.append(t1 - t0)
        wall = statistics.median(walls) * 1e3
        device = (_replayed_ms(torch, fn) if ex.graphs
                  else time_ms(fn, iters=3))
        res[name] = dict(wall_ms=wall,
                         host_enqueue_ms=statistics.median(enq) * 1e3,
                         device_ms=device,
                         device_idle_share=max(0.0, 1.0 - device / wall))
        if ex.graphs:
            # device time of 3 passes by kernel class (torch.profiler); an
            # eager twin runs the same kernels, and tracing its host
            # operators costs seconds a pass kind
            busy, _, classes, _ = _device_busy(torch, fn, 3)
            res[name]["device_ms_by_class"] = {
                c: t / 3 * 1e3 for c, t in sorted(
                    classes.items(), key=lambda kv: -kv[1])}
    res["graphs"] = ex.graphs
    res["ticks_a_window"] = srv.tick_window
    for p in pages or ():
        srv._lora.release(p)
    log("pass breakdown (host vs device): " + json.dumps(res))
    return res


# --------------------------------------------------------------- phase 5
def end_to_end(torch, ops, model, prompt, label="end_to_end", kv_quant="none",
               lora=None, megakernel=False):
    """First prefill chunk + 4 decode ticks of one request, run three times
    on fresh pools with the same tokens fed: bf16 with the kernels, bf16
    with the plain versions, and the plain versions on an fp32 copy of the
    same weights (the yardstick for bf16 rounding). ``kv_quant="int8"``:
    int8 KV pools (for an int8 model the fp32 copy holds the same codes and
    scales); ``lora``: (adapter pool, page) — the request runs on that
    adapter page, the same factors in all three runs; ``megakernel``: both
    bf16 runs take each decode tick through ``decode_tick`` — the kernel,
    and its plain twin, which rounds a LoRA delta as the kernel does
    (``bf16(base) + bf16(delta)``, where the per-layer plain path adds in
    fp32 and rounds once); the prefill chunk keeps the per-layer path."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.ops import decode_megakernel as mk

    cfg = model.cfg
    C, bs, ticks = PREFILL_CHUNK, BLOCK_SIZE, 4
    nblk = (C + ticks) // bs + 2
    table = torch.arange(1, nblk + 1, dtype=torch.int32, device="cuda")
    shape = (nblk + 1, bs, cfg.num_key_value_heads, cfg.head_dim)
    factors = tick_lora = None
    if lora is not None:
        aidx = torch.tensor([lora[1]], dtype=torch.int32, device="cuda")
        factors = lora[0].layer_factors(aidx)
        tick_lora = mk.lora_tables(lora[0], aidx)

    def pools_for(dt):
        if kv_quant == "int8":
            sc = (nblk + 1, cfg.num_key_value_heads)
            return [(torch.zeros(shape, dtype=torch.int8, device="cuda"),
                     torch.zeros(sc, device="cuda"),
                     torch.zeros(shape, dtype=torch.int8, device="cuda"),
                     torch.zeros(sc, device="cuda"))
                    for _ in range(cfg.num_hidden_layers)]
        return [(torch.zeros(shape, dtype=dt, device="cuda"),
                 torch.zeros(shape, dtype=dt, device="cuda"))
                for _ in range(cfg.num_hidden_layers)]

    def run(m, mode, feed):
        ops.set_kernel_mode(mode)
        pools = pools_for(m.cfg.torch_dtype)
        ids = torch.tensor([prompt[:C]], device="cuda")
        tick_kernel = megakernel and m is model
        weights = mk.stack_layer_weights(m) if tick_kernel else None
        with torch.no_grad():
            h, _ = m.model.paged_prefill_chunk(ids, pools, table, 0, factors)
            logits = [m.head(h[:, -1:])[:, 0].float()]
            toks = []
            for t in range(ticks):
                tok = feed[t] if feed else int(logits[-1].argmax())
                toks.append(tok)
                tokv = torch.tensor([[tok]], device="cuda")
                posv = torch.tensor([C + t], dtype=torch.int32,
                                    device="cuda")
                if tick_kernel:
                    x = m.model.embed_tokens(tokv)
                    cr, sr = mk.gather_rope_rows(m.model._cos, m.model._sin,
                                                 posv, 1)
                    xo, _ = mk.decode_tick(
                        x, [p for pool in pools for p in pool], table[None],
                        posv, weights, cr, sr, block_size=bs,
                        eps=m.cfg.rms_norm_eps, lora=tick_lora)
                    h = m.model.norm(xo)
                else:
                    h, _ = m.model.paged_decode_step(tokv, pools, table[None],
                                                     posv, factors)
                logits.append(m.head(h)[:, 0].float())
        ops.set_kernel_mode("auto")
        return torch.cat(logits), toks

    lk, toks = run(model, "auto", None)
    lr, _ = run(model, "reference", toks)
    # full-fp32 products for the yardstick (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    m32 = LlamaForCausalLM(dataclasses.replace(cfg, dtype="float32"),
                           device="cuda")
    with torch.no_grad():
        if model.quantized:             # the same codes and scales
            m32.quantize_int8()
            m32.load_state_dict(model.state_dict())
        else:
            for p32, p16 in zip(m32.parameters(), model.parameters()):
                p32.copy_(p16)          # exact widening of bf16
    lf, _ = run(m32, "reference", toks)
    del m32
    torch.cuda.empty_cache()
    check(bool(torch.isfinite(lk).all()), "end to end: non-finite logits")
    check(tuple(lk.shape) == (ticks + 1, cfg.vocab_size), "end to end: shape")
    # The kernels round to bf16 in other places than the plain versions (p
    # before PV unnormalised, summation order), so over 32 layers the two
    # bf16 paths drift apart; neither is the exact answer. The fp32 run of
    # the same weights is: the kernels' path may not be farther from it
    # than the plain bf16 path is, by more than DRIFT_RATIO, in the largest
    # and in the rms logit error; and the two bf16 paths may differ by at
    # most GAP_FRACTION of the rms logit.
    def rms(t):
        return t.square().mean().sqrt().item()

    res = dict(max_abs_logit_diff=(lk - lr).abs().max().item(),
               rms_logit_diff=rms(lk - lr),
               plain_bf16_vs_fp32_max=(lr - lf).abs().max().item(),
               kernels_bf16_vs_fp32_max=(lk - lf).abs().max().item(),
               plain_bf16_vs_fp32_rms=rms(lr - lf),
               kernels_bf16_vs_fp32_rms=rms(lk - lf),
               max_abs_logit=lf.abs().max().item(), rms_logit=rms(lf),
               argmax_agree_kernels_plain=int(
                   (lk.argmax(-1) == lr.argmax(-1)).sum()),
               positions=ticks + 1)
    res["drift_ratio_max"] = (res["kernels_bf16_vs_fp32_max"]
                              / res["plain_bf16_vs_fp32_max"])
    res["drift_ratio_rms"] = (res["kernels_bf16_vs_fp32_rms"]
                              / res["plain_bf16_vs_fp32_rms"])
    res["gap_fraction"] = res["rms_logit_diff"] / res["rms_logit"]
    log(f"{label} kernels vs plain vs fp32: " + json.dumps(res))
    for key in ("drift_ratio_max", "drift_ratio_rms"):
        check(res[key] <= DRIFT_RATIO, f"{label}: the kernels drift from "
              f"fp32 {res[key]:.3g} x as far as the plain bf16 path "
              f"(limit {DRIFT_RATIO})")
    check(res["gap_fraction"] <= GAP_FRACTION,
          f"{label}: kernels and plain versions differ by "
          f"{res['gap_fraction']:.3g} of the rms logit (limit {GAP_FRACTION})")
    return res


# -------------------------------------------------------------- phase 13
MK_CHECK_LAYERS = 4
# the speculative server's verify window (phase 26: k = 4): 8 x 5 = 40
# rows a tick, which only the fp and int8-pool variants serve there
MK_VERIFY_W = 5
# decode positions of phase 3: mid-block, a block boundary on each side,
# long contexts and a short one
MK_POS = [1000, 511, 512, 255, 37, 700, 128, 5]


def _layers_view(model, n):
    """A stand-in exposing the first ``n`` decoder layers of ``model`` as
    ``.model.layers`` (the weight table of a shallower tick)."""
    import types

    return types.SimpleNamespace(model=types.SimpleNamespace(
        layers=model.model.layers[:n]))


def _tick_inputs(torch, model, g, L, W, quant=False):
    """A tick's inputs at the serving shapes: B = 8 rows at MK_POS, window
    W, per-layer pools with blocks in a scrambled order, scratch block 0
    poisoned (+-1e9; int8: full codes at scale 1e9), embedded random tokens
    and their rope rows. ``quant``: int8 pools, the random blocks quantized
    (codes and scales of K, then of V, a layer)."""
    from paddle_tpu_torch.ops import decode_megakernel as mk
    from paddle_tpu_torch.ops import paged_attention as pa

    cfg = model.cfg
    B, bs, KV, D = MAX_BATCH, BLOCK_SIZE, cfg.num_key_value_heads, cfg.head_dim
    need = [(p + W - 1) // bs + 1 for p in MK_POS]
    N = sum(need) + 8
    pools = []
    for i in range(2 * L):
        p = torch.randn(N, bs, KV, D, generator=g, device="cuda").to(
            torch.bfloat16)
        if quant:
            codes, scales = pa.quantize_block_kv(p)
            codes[0], scales[0] = 127 if i % 2 == 0 else -127, 1e9
            pools += [codes, scales]
        else:
            p[0] = 1e9 if i % 2 == 0 else -1e9
            pools.append(p)
    perm = (torch.randperm(N - 1, generator=torch.Generator().manual_seed(2))
            + 1).tolist()
    tables = torch.zeros(B, TABLE_WIDTH, dtype=torch.int32)
    took = 0
    for b in range(B):
        tables[b, :need[b]] = torch.tensor(perm[took:took + need[b]])
        took += need[b]
    tables = tables.cuda()
    pos = torch.tensor(MK_POS, dtype=torch.int32, device="cuda")
    tok = torch.randint(1, cfg.vocab_size, (B, W), generator=g, device="cuda")
    x = model.model.embed_tokens(tok)
    cosr, sinr = mk.gather_rope_rows(model.model._cos, model.model._sin, pos, W)
    return x, pools, tables, pos, cosr, sinr


# the rows' adapter pages in the LoRA cases: LORA_ADAPTERS on pages 1-3
# (ranks 8, 8, 4 in max_rank 8) and the null page 0
MK_PAGES = [1, 2, 3, 0, 1, 0, 3, 2]


def _tick_lora(torch, cfg, L, g):
    """``LoraTables`` of an L-layer tick: every target, pages 1-3 holding
    LORA_ADAPTERS' seeded factors (rank-padded to LORA_MAX_RANK) and their
    alpha/r, page 0 the null adapter, the rows on MK_PAGES."""
    from paddle_tpu_torch.inference.lora import LORA_TARGETS, target_dims
    from paddle_tpu_torch.ops import decode_megakernel as mk

    R, pages = LORA_MAX_RANK, len(LORA_ADAPTERS) + 1
    factors = {}
    for t in LORA_TARGETS:
        i, o = target_dims(cfg)[t]
        A = torch.zeros(pages, L, i, R, device="cuda")
        Bf = torch.zeros(pages, L, R, o, device="cuda")
        for p, (_, r, _) in enumerate(LORA_ADAPTERS, start=1):
            A[p, :, :, :r] = 0.02 * torch.randn(L, i, r, generator=g,
                                                device="cuda")
            Bf[p, :, :r] = 0.02 * torch.randn(L, r, o, generator=g,
                                              device="cuda")
        factors[t] = (A, Bf)
    scale = torch.tensor([0.0] + [a / r for _, r, a in LORA_ADAPTERS],
                         device="cuda")
    return mk.LoraTables(factors, scale, torch.tensor(
        MK_PAGES, dtype=torch.int32, device="cuda"), R)


class _F32Weights:
    """fp32 copies of a ``LayerWeights``' tensors, for the fp32 twin."""

    def __init__(self, weights):
        self.num_layers = weights.num_layers
        self._t = {n: [t.float() for t in weights[n]] for n in weights.NAMES}

    def __getitem__(self, name):
        return self._t[name]


# the tick's variants: (name, int8 pools, dequant mode, LoRA)
MK_VARIANTS = (("fp", False, "scores", False),
               ("int8", True, "scores", False),
               ("int8_tile", True, "tile", False),
               ("lora", False, "scores", True),
               ("int8_lora", True, "scores", True))


def _written_blocks(torch, tables, W, N):
    """(block, slot) mask of the entries a tick of window W writes in a pool
    of N blocks, and the blocks it writes (an int8 insert rewrites its
    whole block-head)."""
    bs = BLOCK_SIZE
    slots = torch.zeros(N, bs, dtype=torch.bool, device="cuda")
    for b, p in enumerate(MK_POS):
        for w in range(W):
            slots[tables[b, (p + w) // bs], (p + w) % bs] = True
    return slots, slots.any(1)


def _pool_ratio(torch, kp, rp, pools, tables, W, quant):
    """(worst written-entry error over its tolerance, entries moved outside
    what the tick writes). fp: per written K/V row, phase 3's tolerance
    once per layer up to the writer. int8: the written blocks dequantized,
    per element, one code step of the block-head's scale plus the token
    tolerance of its largest row; no code or scale of another block may
    move."""
    slots, blocks = _written_blocks(torch, tables, W, pools[0].shape[0])
    worst, moved = 0.0, 0
    st = 4 if quant else 2
    for i in range(0, len(pools), 2 if quant else 1):
        layer = i // st + 1
        if not quant:
            a, r, p0 = kp[i], rp[i], pools[i]
            m = slots
            worst = max(worst, _row_ratio(a[m], r[m], _rms(r[m])).max().item()
                        / layer)
            moved += int((a[~m] != p0[~m]).sum())
            continue
        qa, sa, qr, sr = kp[i], kp[i + 1], rp[i], rp[i + 1]
        m = blocks
        da = qa[m].float() * sa[m][:, None, :, None]
        dr = qr[m].float() * sr[m][:, None, :, None]
        # a token off by its tolerance moves the block-head's scale, and
        # every code with it, by up to that much: the token tolerance is
        # the block-head's largest row's
        step = torch.maximum(sa[m], sr[m])[:, None, :, None]
        tol = step + layer * (2.0 ** -7 * dr.abs().amax((1, 3), keepdim=True)
                              + 2.0 ** -8 * _rms(dr))
        worst = max(worst, ((da - dr).abs() / tol).max().item())
        moved += int((qa[~m] != pools[i][~m]).sum())
        moved += int((sa[~m] != pools[i + 1][~m]).sum())
    return worst, moved


def _mutant_twin(torch, mk, fault, args, kw):
    """The plain twin with one planted fault: the causal mask one key off
    (``mask+1`` / ``mask-1``; scratch given ordinary values so that a key
    read past a row's last block is plausible), every row on the next
    row's adapter page (``wrong_page``), or a scale applied twice
    (``scale_twice``: the int8 pools' k- and v-scales, else the adapters'
    alpha/r)."""
    x, pools, tables, pos, weights, cosr, sinr = args
    mp = [p.clone() for p in pools]
    for p in mp:
        p[0] = p[1]
    lora = kw["lora"]
    orig_core, orig_scales = mk._attention_core, mk.gather_block_scales
    if fault.startswith("mask"):
        d = int(fault[4:])
        mk._attention_core = (lambda q, ck, cv, qpos, *a, _d=d:
                              orig_core(q, ck, cv, qpos + _d, *a))
    elif fault == "wrong_page":
        lora = mk.LoraTables(lora.factors, lora.scale,
                             torch.roll(lora.aidx, 1), lora.max_rank)
    elif pools[0].dtype == torch.int8:
        mk.gather_block_scales = (lambda sc, t, bs:
                                  orig_scales(sc, t, bs) ** 2)
    else:
        lora = mk.LoraTables(lora.factors, lora.scale ** 2, lora.aidx,
                             lora.max_rank)
    try:
        with torch.no_grad():
            return mk._tick_plain(x, mp, tables, pos, weights, cosr, sinr,
                                  **dict(kw, lora=lora))
    finally:
        mk._attention_core, mk.gather_block_scales = orig_core, orig_scales



def _phase_weight_bytes(cfg):
    """Weight bytes a layer of each product phase of the tick reads (the
    counters' TB/s): q/k/v, o, gate/up, down."""
    Hd, I = cfg.hidden_size, cfg.intermediate_size
    KVD = cfg.num_key_value_heads * cfg.head_dim
    return {"qkv": Hd * (Hd + 2 * KVD) * 2, "o": Hd * Hd * 2,
            "gate_up": 2 * Hd * I * 2, "down": I * Hd * 2}


def _tick_breakdown(torch, mkc, trace, phase_bytes):
    """The clock counters of one traced tick, per phase summed over the
    layers: the median and the largest work time over the blocks (entry
    to the end of the block's work), the median barrier wait (end of work
    to exit from the grid barrier), the phase's wall time (last exit less
    first entry, a layer), the median and largest waits of the consumers
    on the weight ring and of the producer on a full ring, the parts of the
    consumers' work (``TRACE_WORK``: a product phase's staging, fragment
    ends and epilogues, attention's key loops, split merges and int8
    inserts; summed over both warpgroups where both do them), and the
    phase's weight bytes over its wall time; all in ms, the rate in
    TB/s."""
    t = trace.cpu().double()
    out = {}
    for p, name in enumerate(mkc.TRACE_PHASES):
        entry, end, exit_ = t[:, p, :, 0], t[:, p, :, 1], t[:, p, :, 2]
        ran = (entry != 0).all(1)
        if not bool(ran.any()):
            continue
        e, w, x = entry[ran], end[ran], exit_[ran]
        work = (w - e).sum(0) / 1e6             # per block, ms
        wait = (x - w).sum(0) / 1e6
        cw = t[ran, p, :, 3].sum(0) / 1e6
        pw = t[ran, p, :, 4].sum(0) / 1e6
        wall = float((x.max(1).values - e.min(1).values).sum()) / 1e6
        row = dict(layers=int(ran.sum()),
                   work_median_ms=float(work.median()),
                   work_max_ms=float(work.max()),
                   barrier_wait_median_ms=float(wait.median()),
                   wall_ms=wall,
                   consumer_ring_wait_median_ms=float(cw.median()),
                   consumer_ring_wait_max_ms=float(cw.max()),
                   producer_full_wait_median_ms=float(pw.median()))
        # the parts of the consumers' work (a warpgroup's sums add up)
        parts = mkc.TRACE_WORK["attention" if name == "attention"
                               else "product"]
        if name in phase_bytes or name == "attention":
            for k, part in enumerate(parts):
                v = t[ran, p, :, 5 + k].sum(0) / 1e6
                row[f"{part}_median_ms"] = float(v.median())
                row[f"{part}_max_ms"] = float(v.max())
        if name in phase_bytes:
            nbytes = phase_bytes[name] * int(ran.sum())
            row["weight_bytes"] = nbytes
            row["weight_tb_s"] = nbytes / (wall * 1e-3) / 1e12
        out[name] = row
    first = t[:, :, :, 0]
    last = t[:, :, :, 2]
    out["tick_ms"] = float(last[last != 0].max() - first[first != 0].min()) \
        / 1e6
    return out


def _tick_bound(cfg, L, W, quant, lora=None):
    """(bytes, bound ms, bound_by, grid barriers) of an L-layer tick of
    window W at MK_POS. Bytes this data needs: every layer's seven
    projections and two norm weights once, each visible K/V row once
    (int8: each visible block's codes, which the insert reads whole, and
    its scales; each written block-head back), the window's K/V written,
    x in and out, the table, the used adapter pages' factors once;
    operations: 2 per weight element and row, QK + PV over each query's
    visible keys, and the LoRA shrink and expand."""
    bs, B = BLOCK_SIZE, MAX_BATCH
    Hd, I = cfg.hidden_size, cfg.intermediate_size
    KV, D = cfg.num_key_value_heads, cfg.head_dim
    KVD = KV * D
    w_elems = Hd * Hd * 2 + 2 * Hd * KVD + 3 * Hd * I
    keys = sum(p + W for p in MK_POS)              # the last query's
    vis = sum(p + w + 1 for p in MK_POS for w in range(W))
    nblk = sum((p + W - 1) // bs + 1 for p in MK_POS)
    written = sum((p + W - 1) // bs - p // bs + 1 for p in MK_POS)
    if quant:
        kv_bytes = L * 2 * (nblk + written) * (bs * KVD + KV * 4)
    else:
        kv_bytes = L * (2 * keys * KVD * 2 + 2 * B * W * KVD * 2)
    nbytes = (L * (w_elems + 2 * Hd) * 2 + kv_bytes + 2 * B * W * Hd * 2
              + B * TABLE_WIDTH * 4)
    flops = L * (2 * B * W * w_elems + 4 * D * cfg.num_attention_heads * vis)
    barriers = 5 * L
    if lora is not None:
        used = len(set(MK_PAGES) - {0})
        per_page = sum(A[0, 0].numel() + Bf[0, 0].numel()
                       for A, Bf in lora.factors.values()) * 4
        nbytes += used * L * per_page
        live = sum(p != 0 for p in MK_PAGES)
        flops += 2 * live * W * L * per_page // 4
        barriers += 4 * L
    b, by = bound_ms(nbytes, flops, BF16_FLOPS)
    return nbytes, b, by, barriers


def _tick_hbm_estimate(mk, cfg, W, quant):
    """The JAX package's per-trip byte estimate at MK_POS."""
    nblk = sum((p + W - 1) // BLOCK_SIZE + 1 for p in MK_POS)
    return mk.hbm_bytes_per_trip(cfg, batch=MAX_BATCH, window=W,
                                 block_size=BLOCK_SIZE,
                                 avg_ctx_blocks=round(nblk / MAX_BATCH),
                                 kv_quant="int8" if quant else "none",
                                 dtype_bytes=2)


def _tick_verify_full_depth(torch, mk, mkc, model, g, quant, dequant,
                            phase_bytes):
    """The speculative verify tick, W = MK_VERIFY_W (B·W = 40 rows), at the
    model's full depth: output rows and written entries against the plain
    twin with the rule of the shallow checks (two tolerances a layer),
    then timed beside the twin, its bound and the JAX byte estimate, and
    its clock counters printed."""
    from paddle_tpu_torch.ops.decode_megakernel_cuda import decode_tick_cuda

    cfg = model.cfg
    L, W = cfg.num_hidden_layers, MK_VERIFY_W
    weights = mk.stack_layer_weights(model)
    x, pools, tables, pos, cosr, sinr = _tick_inputs(torch, model, g, L, W,
                                                     quant)
    kw = dict(eps=cfg.rms_norm_eps, dequant=dequant, lora=None)
    kp = [p.clone() for p in pools]
    rp = [p.clone() for p in pools]
    with torch.no_grad():
        out = decode_tick_cuda(x, kp, tables, pos, weights, cosr, sinr, **kw)
        ref = mk._tick_plain(x, rp, tables, pos, weights, cosr, sinr, **kw)
    torch.cuda.synchronize()
    label = f"decode_tick {'int8' if quant else 'fp'} W={W} L={L}"
    check(bool(torch.isfinite(out.float()).all()),
          f"{label}: non-finite output")
    worst = (_row_ratio(out, ref, _rms(ref)) / (2 * L)).max().item()
    worst_kv, moved = _pool_ratio(torch, kp, rp, pools, tables, W, quant)
    check(worst <= 1.0, f"{label}: an output row is off by {worst:.3g} x "
                        f"its tolerance")
    check(worst_kv <= 1.0, f"{label}: a written K/V entry is off by "
                           f"{worst_kv:.3g} x its tolerance")
    check(moved == 0, f"{label}: {moved} pool entries outside the window "
                      f"moved")
    max_err = (out.float() - ref.float()).abs().max().item()
    del kp, rp, out, ref
    for p in pools:
        p[0] = 0
    with torch.no_grad():
        ms = time_ms(lambda: decode_tick_cuda(x, pools, tables, pos, weights,
                                              cosr, sinr, **kw), 5)
        plain_ms = time_ms(lambda: mk._tick_plain(
            x, pools, tables, pos, weights, cosr, sinr, **kw), 2)
        buf = mkc.trace_buffer(L, x.device)
        decode_tick_cuda(x, pools, tables, pos, weights, cosr, sinr,
                         trace=buf, **kw)
        counters = _tick_breakdown(torch, mkc, buf, phase_bytes)
    nbytes, b, by, _ = _tick_bound(cfg, L, W, quant)
    res = dict(W=W, rows=MAX_BATCH * W, layers=L, max_abs_err=max_err,
               worst_err_over_tol=worst, kv_worst_err_over_tol=worst_kv,
               ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
               bytes=nbytes,
               hbm_bytes_per_trip=_tick_hbm_estimate(mk, cfg, W, quant))
    log(f"kernel {label} (full depth): " + json.dumps(res))
    log(f"kernel decode_tick {'int8' if quant else 'fp'} clock counters "
        f"(full depth, W = {W}): " + json.dumps(counters))
    res["counters"] = counters
    del x, pools, buf
    torch.cuda.empty_cache()
    return res


def kernel_decode_tick(torch, ops, model):
    """The whole-tick kernel against its plain twin, bf16, Llama-3-8B width,
    1 and MK_CHECK_LAYERS layers of the served model, B = 8, W in {1, 4},
    in each variant of MK_VARIANTS (fp or int8 pools, each dequant mode,
    with and without LoRA on every target): output rows and the pool
    entries the tick wrote, per row, within phase 3's tolerance once per
    layer the tick ran (see below), shown to reject planted faults (the
    causal mask one key off; with LoRA the wrong adapter page; a scale
    applied twice); the kernel no farther from the fp32 twin than the bf16
    twin is, by DRIFT_RATIO; with every row on the null page the LoRA
    kernel's tick equals the fp kernel's bit for bit. Then each variant's
    kernel, twin and per-layer kernels timed at the model's full depth
    (W = 1). Returns {variant: [timed case, check cases...]}."""
    from paddle_tpu_torch.ops import decode_megakernel as mk
    from paddle_tpu_torch.ops import decode_megakernel_cuda as mkc
    from paddle_tpu_torch.ops.decode_megakernel_cuda import decode_tick_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = model.cfg
    eps, bs = cfg.rms_norm_eps, BLOCK_SIZE
    phase_bytes = _phase_weight_bytes(cfg)
    g = torch.Generator(device="cuda").manual_seed(31)
    cases = {name: [] for name, *_ in MK_VARIANTS}
    for name, quant, dequant, with_lora in MK_VARIANTS:
        for W in (1, 4, MK_VERIFY_W):
            for L in (1, MK_CHECK_LAYERS):
                if name == "int8_tile" and W == 4:
                    continue
                if W == MK_VERIFY_W and name not in ("fp", "int8"):
                    continue
                view = _layers_view(model, L)
                weights = mk.stack_layer_weights(view)
                x, pools, tables, pos, cosr, sinr = _tick_inputs(
                    torch, model, g, L, W, quant)
                lora = _tick_lora(torch, cfg, L, g) if with_lora else None
                kw = dict(eps=eps, dequant=dequant, lora=lora)
                kp = [p.clone() for p in pools]
                rp = [p.clone() for p in pools]
                fp = [p.float() if p.dtype == torch.bfloat16 else p.clone()
                      for p in pools]
                with torch.no_grad():
                    out = decode_tick_cuda(x, kp, tables, pos, weights, cosr,
                                           sinr, **kw)
                    ref = mk._tick_plain(x, rp, tables, pos, weights, cosr,
                                         sinr, **kw)
                    f32 = mk._tick_plain(x.float(), fp, tables, pos,
                                         _F32Weights(weights), cosr, sinr,
                                         **kw)
                torch.cuda.synchronize()
                label = f"decode_tick {name} W={W} L={L}"
                check(bool(torch.isfinite(out.float()).all()),
                      f"{label}: non-finite output (scratch leaked?)")
                # Phase 3's per-row tolerance (one bf16 step of the row's
                # largest value + 2^-8 of the rms of what is compared)
                # holds one rounding of each side. A layer rounds its
                # residual twice (the attention and the MLP adds) behind
                # eight rounded products, and the two sides' roundings (fp32
                # sums in other orders, p kept in fp32 in the kernel) drift
                # apart layer by layer: on an H100 the fp output rows reached
                # 0.94-1.33 x the one-rounding tolerance at one layer (W = 1,
                # 4) and 1.95 x at four, with the kernel as far from the fp32
                # twin as the bf16 twin (0.95-1.07 x). So an output row may
                # differ by two tolerances per layer, the K/V written by
                # layer l by l + 1 (one rounding a layer behind them); int8
                # codes are compared dequantized, with one code step of the
                # block's scale on top (a token that moved by a rounding can
                # flip a code that sat on a half step)
                ratio = _row_ratio(out, ref, _rms(ref)) / (2 * L)
                worst = ratio.max().item()
                worst_kv, moved = _pool_ratio(torch, kp, rp, pools, tables,
                                              W, quant)
                drift_rms = _rms(out.float() - f32) / _rms(ref.float() - f32)
                drift_max = ((out.float() - f32).abs().max()
                             / (ref.float() - f32).abs().max()).item()
                faults = ["mask+1", "mask-1"]
                if with_lora:
                    faults.append("wrong_page")
                if quant or with_lora:
                    faults.append("scale_twice")
                mutants = {}
                args = (x, pools, tables, pos, weights, cosr, sinr)
                for fault in faults:
                    mo = _mutant_twin(torch, mk, fault, args, kw)
                    r = _row_ratio(mo, ref, _rms(ref)) / (2 * L)
                    mutants[fault] = dict(
                        worst_err_over_tol=r.max().item(),
                        rows_failed=(r > 1.0).float().mean().item())
                    del mo
                case = dict(variant=name, layers=L, B=MAX_BATCH, W=W,
                            pos=MK_POS, dequant=dequant,
                            pages=MK_PAGES if with_lora else None,
                            max_abs_err=(out.float() - ref.float()).abs()
                            .max().item(),
                            worst_err_over_tol=worst,
                            row_err_over_tol=ratio.flatten().tolist(),
                            kv_worst_err_over_tol=worst_kv,
                            drift_ratio_rms=drift_rms,
                            drift_ratio_max=drift_max, mutants=mutants)
                if with_lora and L == MK_CHECK_LAYERS:
                    # every row on the null page: the fp kernel's tick, bit
                    # for bit (a delta of 0 leaves bf16(base) as it is)
                    zp = [p.clone() for p in pools]
                    fpk = [p.clone() for p in pools]
                    zero = mk.LoraTables(lora.factors, lora.scale,
                                         torch.zeros_like(lora.aidx),
                                         lora.max_rank)
                    with torch.no_grad():
                        oz = decode_tick_cuda(x, zp, tables, pos, weights,
                                              cosr, sinr, **dict(kw,
                                                                 lora=zero))
                        of = decode_tick_cuda(x, fpk, tables, pos, weights,
                                              cosr, sinr, **dict(kw,
                                                                 lora=None))
                    case["null_pages_bitwise_fp"] = bool(
                        torch.equal(oz, of) and all(
                            torch.equal(a, b) for a, b in zip(zp, fpk)))
                    check(case["null_pages_bitwise_fp"],
                          f"{label}: with every row on page 0 the LoRA tick "
                          f"differs from the fp tick")
                    del zp, fpk, oz, of
                log(f"kernel {label}: " + json.dumps(case))
                check(worst <= 1.0, f"{label}: an output row is off by "
                                    f"{worst:.3g} x its tolerance")
                check(worst_kv <= 1.0, f"{label}: a written K/V entry is off "
                                       f"by {worst_kv:.3g} x its tolerance")
                check(moved == 0, f"{label}: {moved} pool entries outside "
                                  f"the window moved")
                for key in ("drift_ratio_rms", "drift_ratio_max"):
                    check(case[key] <= DRIFT_RATIO, f"{label}: {key} "
                          f"{case[key]:.3g} > {DRIFT_RATIO}")
                for fault, m in mutants.items():
                    check(m["worst_err_over_tol"] > 1.0,
                          f"{label}: the tolerance passes the {fault} fault "
                          f"({m['worst_err_over_tol']:.3g})")
                cases[name].append(case)
                del kp, rp, fp, pools, out, ref, f32, lora
                torch.cuda.empty_cache()

    # timing at full depth, W = 1, the serving path's shapes
    L = cfg.num_hidden_layers
    weights = mk.stack_layer_weights(model)
    tok = torch.ones(MAX_BATCH, 1, dtype=torch.long, device="cuda")
    timed = {}
    for name, quant, dequant, with_lora in MK_VARIANTS:
        x, pools, tables, pos, cosr, sinr = _tick_inputs(torch, model, g, L,
                                                         1, quant)
        for p in pools:
            p[0] = 0
        lora = _tick_lora(torch, cfg, L, g) if with_lora else None
        kw = dict(eps=eps, dequant=dequant, lora=lora)
        st = 4 if quant else 2
        layer_pools = [tuple(pools[st * i:st * (i + 1)]) for i in range(L)]
        factors = None if lora is None else [
            {t: lora.pooled(i, t) for t in lora.factors} for i in range(L)]

        def kernel():
            decode_tick_cuda(x, pools, tables, pos, weights, cosr, sinr, **kw)

        def plain():
            mk._tick_plain(x, pools, tables, pos, weights, cosr, sinr, **kw)

        def per_layer():     # the per-layer kernels' tick, embedding to norm
            model.model.paged_decode_step(tok, layer_pools, tables, pos,
                                          factors)

        with torch.no_grad():
            ms = time_ms(kernel, 5)
            plain_ms = time_ms(plain, 2)
            per_layer_ms = time_ms(per_layer, 3)

            # the clock counters of one tick, and its bits: two ticks on
            # the same inputs (fresh copies of the pools) are the same, and
            # a traced tick is the untraced one
            def fresh(trace=None):
                kp = [p.clone() for p in pools]
                out = decode_tick_cuda(x, kp, tables, pos, weights, cosr,
                                       sinr, trace=trace, **kw)
                return out, kp

            o1, k1 = fresh()
            o2, k2 = fresh()
            buf = mkc.trace_buffer(L, x.device)
            o3, k3 = fresh(buf)
            torch.cuda.synchronize()
            deterministic = bool(torch.equal(o1, o2) and all(
                torch.equal(u, v) for u, v in zip(k1, k2)))
            trace_identical = bool(torch.equal(o1, o3) and all(
                torch.equal(u, v) for u, v in zip(k1, k3)))
            counters = _tick_breakdown(torch, mkc, buf, phase_bytes)
            del o1, o2, o3, k1, k2, k3, buf
            log(f"kernel decode_tick {name} clock counters (full depth, "
                f"W = 1): " + json.dumps(counters))
            check(deterministic, f"decode_tick {name}: two ticks on the "
                                 f"same inputs differ")
            check(trace_identical, f"decode_tick {name}: the traced tick "
                                   f"differs from the untraced one")
            # a verify tick, W = 4, at full depth
            x4, p4, t4, pos4, c4, s4 = _tick_inputs(torch, model, g, L, 4,
                                                    quant)
            for pp in p4:
                pp[0] = 0
            kw4 = dict(kw, lora=_tick_lora(torch, cfg, L, g)
                       if with_lora else None)
            ms_w4 = time_ms(lambda: decode_tick_cuda(
                x4, p4, t4, pos4, weights, c4, s4, **kw4), 5)
            buf = mkc.trace_buffer(L, x.device)
            decode_tick_cuda(x4, p4, t4, pos4, weights, c4, s4, trace=buf,
                             **kw4)
            counters_w4 = _tick_breakdown(torch, mkc, buf, phase_bytes)
            log(f"kernel decode_tick {name} clock counters (full depth, "
                f"W = 4): " + json.dumps(counters_w4))
            del x4, p4, kw4, buf
            verify = (_tick_verify_full_depth(torch, mk, mkc, model, g, quant,
                                              dequant, phase_bytes)
                      if name in ("fp", "int8") else None)
        nbytes, b, by, barriers = _tick_bound(cfg, L, 1, quant, lora)
        est = _tick_hbm_estimate(mk, cfg, 1, quant)
        t = dict(variant=name, layers=L, B=MAX_BATCH, W=1, pos=MK_POS,
                 dequant=dequant, pages=MK_PAGES if lora else None,
                 grid=torch.cuda.get_device_properties(0)
                 .multi_processor_count,      # one block per SM
                 barriers_per_tick=barriers,
                 ms=ms, plain_ms=plain_ms, per_layer_kernels_ms=per_layer_ms,
                 ms_w4=ms_w4, verify_w5=verify, deterministic=deterministic,
                 trace_identical=trace_identical, counters=counters,
                 counters_w4=counters_w4,
                 bound_ms=b, bound_by=by, bytes=nbytes,
                 hbm_bytes_per_trip=est,
                 library_ms=None,
                 library_note="no single PyTorch call computes a tick; "
                              "per_layer_kernels_ms is the yardstick")
        log(f"kernel decode_tick {name} (full depth): " + json.dumps(t))
        # the main case (full depth, timed) first, with the checks' errors
        t["max_abs_err"] = max(c["max_abs_err"] for c in cases[name])
        timed[name] = t
        del pools, layer_pools, factors, lora
        torch.cuda.empty_cache()
    return {name: [timed[name]] + [dict(c, ms=None, plain_ms=None,
                                         bound_ms=None, bound_by=None,
                                         library_ms=None)
                                   for c in cases[name]]
            for name in cases}


# -------------------------------------------------------------- phase 14
def serve_megakernel(torch, ops, model, phase4_tokens, graphs=True,
                     label="serve llama3-8b paged megakernel", **server_kw):
    """Phase 4's model and traffic behind ``kernels="megakernel"``: every
    decode tick launches decode_tick once and the per-layer attention never;
    every prefill chunk launches the per-layer attention once a layer and
    decode_tick never. Counts how many requests give phase 4's tokens.
    ``graphs`` and ``server_kw`` (``tick_window``) as in :func:`serve`."""
    L = model.cfg.num_hidden_layers

    def expect(st):
        return {"decode_tick": st["decode_ticks"],
                "paged_attention": L * st["prefill_chunks"],
                "rms_norm": st["decode_ticks"]
                + (2 * L + 1) * st["prefill_chunks"],
                "stream_matmul": st["decode_ticks"]}     # the head

    label += _cell_suffix(graphs, server_kw.get("tick_window", 1))
    try:
        res, _, srv = serve(
            torch, ops, model, label=label, expect=expect, graphs=graphs,
            kernels="megakernel",
            expect_per_pass={
                "decode_paged": {"decode_tick": 1, "paged_attention": 0},
                "chunk_prefill": {"decode_tick": 0, "paged_attention": L}},
            **server_kw)
        check(srv._exec.megakernel, "phase 14: the server did not take the "
                                    "megakernel")
    finally:
        ops.set_kernel_mode("auto")
    _shared_tokens(res, phase4_tokens, f"{label} vs phase 4")
    return res


def _cell_suffix(graphs, window=1):
    """A serving cell's label past its kernels: the window and whether its
    passes are eager."""
    return (f" W={window}" if window != 1 else "") + ("" if graphs
                                                      else " (eager)")


def _shared_tokens(res, ref_tokens, label):
    """Record how many requests of a megakernel cell give its per-layer
    cell's tokens, and how many generated tokens each shares with them
    before the first difference: greedy decoding of random weights meets
    near-ties, where the two paths' bf16 roundings may pick different
    tokens."""
    same = sum(a == b for a, b in zip(res["tokens"], ref_tokens))
    common = []
    for a, b in zip(res["tokens"], ref_tokens):
        n = 0
        while n < min(len(a), len(b)) and a[n] == b[n]:
            n += 1
        common.append(n)
    prompt_lens = [len(p) for p in res.pop("prompts")]
    res["requests_identical_to_per_layer"] = same
    res["generated_tokens_shared_with_per_layer"] = [
        c - n for c, n in zip(common, prompt_lens)]
    log(f"{label}: " + json.dumps(
        {"requests_identical": same, "requests": len(ref_tokens),
         "generated_tokens_shared":
             res["generated_tokens_shared_with_per_layer"]}))


# -------------------------------------------------------------- phase 16
def serve_int8_kv(torch, ops, model, megakernel, graphs=True):
    """Phase 4's traffic over the bf16 model with ``kv_quant="int8"``
    pools: per layer (every pass launches the int8-pool attention once a
    layer), or behind ``kernels="megakernel"`` (every decode tick launches
    decode_tick once and no per-layer kernel but the final norm; every
    prefill chunk the int8-pool attention once a layer and decode_tick
    never). ``graphs`` as in :func:`serve`."""
    L = model.cfg.num_hidden_layers

    def expect(st):
        ticks, chunks = st["decode_ticks"], st["prefill_chunks"]
        if megakernel:
            return {"decode_tick": ticks,
                    "paged_attention_int8": L * chunks,
                    "paged_attention": 0, "w8_matmul": 0,
                    "rms_norm": ticks + (2 * L + 1) * chunks,
                    "stream_matmul": ticks}
        return {"decode_tick": 0, "paged_attention_int8": L * (ticks + chunks),
                "paged_attention": 0, "w8_matmul": 0,
                "rms_norm": (2 * L + 1) * (ticks + chunks),
                "stream_matmul": (7 * L + 1) * ticks}

    kw = {}
    if megakernel:
        kw = dict(kernels="megakernel", expect_per_pass={
            "decode_paged": {"decode_tick": 1, "paged_attention_int8": 0,
                             "paged_attention": 0, "fused_lora_matmul": 0,
                             "w8_matmul": 0},
            "chunk_prefill": {"decode_tick": 0, "paged_attention_int8": L}})
    label = ("serve llama3-8b paged int8-kv"
             + (" megakernel" if megakernel else "")
             + _cell_suffix(graphs))
    try:
        res, _, srv = serve(torch, ops, model, label=label, expect=expect,
                            kv_quant="int8", graphs=graphs, **kw)
        check(srv._exec.megakernel == megakernel,
              f"{label}: the server's megakernel flag")
    finally:
        ops.set_kernel_mode("auto")
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------- phases 24-25
# the graph-on/off phase's limit: a graphed per-layer decode tick's host
# wall over its device time (the host enqueues a replay, 5 input copies and
# reads 8 tokens back)
GRAPH_WALL_RATIO = 1.25
WINDOW = 4
# an eager twin serves its cell's first EAGER_REQUESTS requests (of 12:
# prompts of 1-8 chunks; the LoRA cell's first four take three adapters
# through two live pages, so an eviction precedes an upload), the graphed
# run all
EAGER_REQUESTS = 4


def _pass_line(res):
    """One cell's per-pass readings (window, chunk) and rates."""
    bd = res["breakdown"]
    out = {k: res[k] for k in ("decode_tok_s", "prefill_tok_s",
                               "ms_per_decode_tick", "peak_memory_gib",
                               "peak_reserved_gib")}
    for kind in ("decode_window", "prefill_chunk"):
        out[kind] = {k: bd[kind][k] for k in ("wall_ms", "host_enqueue_ms",
                                              "device_ms",
                                              "device_idle_share")}
    return out


def eager_twin(name, graphed, eager):
    """Phase 24 for one serving cell: the first EAGER_REQUESTS requests of
    its traffic served once more with the executor's graphs off, every
    pass eager. Every one of those requests' tokens must equal the graphed
    run's, and every eager pass must launch what a graphed pass of the
    same kind and size launched. Returns both runs' per-pass readings
    (host wall, enqueue, device time, idle share) and rates."""
    same = sum(a == b for a, b in zip(graphed["tokens"], eager["tokens"]))
    n = len(eager["tokens"])
    check(n == min(EAGER_REQUESTS, len(graphed["tokens"])) and same == n,
          f"phase 24: {name}: {same} of {n} requests give the same tokens "
          f"with graphs on and off")
    _twin_launches(f"phase 24: {name}", graphed, eager)
    out = {"requests_identical": same, "graphs": _pass_line(graphed),
           "eager": _pass_line(eager)}
    log(f"phase 24, {name}, graphs on / off: " + json.dumps(out))
    return out


def graphed_tick_check(graphed):
    """Phase 24's limit: the graphed per-layer bf16 tick's host wall over
    its device time, at most GRAPH_WALL_RATIO."""
    tick = graphed["breakdown"]["decode_window"]
    ratio = tick["wall_ms"] / tick["device_ms"]
    check(ratio <= GRAPH_WALL_RATIO,
          f"phase 24: the graphed bf16 tick's host wall is {ratio:.3f} x "
          f"its device time (limit {GRAPH_WALL_RATIO})")
    return ratio


def serve_windows(torch, ops, model, w1, w1_mk):
    """Phase 25: phase 4's and phase 14's cells at ``tick_window=4`` (4
    ticks a graph replay, one host round trip a window). Each cell's tokens
    must equal its W = 1 run's on phase 4's requests: a row's arithmetic
    does not depend on the rows beside it (the paged attention sizes its
    key splits from the launch's shapes, ``paged_tiles.cuh``
    ``row_split_keys``), so W = 4's other refill timing changes nothing.
    Then sampled requests at W = 4 with the graphs on and off from one
    seed (:func:`serve_sampled_window`)."""
    res, _, srv = serve(torch, ops, model,
                        label=f"serve llama3-8b paged W={WINDOW}",
                        tick_window=WINDOW)
    del srv
    res_mk = serve_megakernel(torch, ops, model, res["tokens"],
                              tick_window=WINDOW)
    for name, got, want in (("bf16", res, w1), ("bf16 megakernel", res_mk,
                                                w1_mk)):
        same = sum(a == b for a, b in zip(got["tokens"], want["tokens"]))
        check(same == len(want["tokens"]),
              f"phase 25: {name}: {same} of {len(want['tokens'])} requests "
              f"give W = 1's tokens at W = {WINDOW}")
        got["requests_identical_to_w1"] = same
    sampled = serve_sampled_window(torch, model)
    log(f"phase 25, W = {WINDOW}: " + json.dumps(
        {"bf16": _pass_line(res), "bf16 megakernel": _pass_line(res_mk),
         "sampled": sampled}))
    return res, res_mk, {"sampled": sampled}


def serve_sampled_window(torch, model):
    """Four sampled requests (temperature 0.8, top-k 50, top-p 0.95) at
    ``tick_window=4`` from one seed, with the executor's graphs on and then
    off. Graphs on, every sampled window must be a replay of a graph that
    draws from the server's generator (``CUDAGraph.
    register_generator_state``). Returns the replays and how many requests
    drew the same tokens both ways."""
    import numpy as np

    from paddle_tpu_torch.inference.serving import GenerationServer

    V = model.cfg.vocab_size
    runs = {}
    for graphs in (True, False):
        srv = GenerationServer(model, cache="paged", max_batch=MAX_BATCH,
                               block_size=BLOCK_SIZE,
                               prefill_chunk=PREFILL_CHUNK, max_len=MAX_LEN,
                               tick_window=WINDOW, seed=5)
        srv._exec.graphs = graphs
        rng = np.random.default_rng(1)
        prompts = [rng.integers(1, V, n).tolist() for n in (200, 333, 90,
                                                            500)]
        rids = [srv.submit(p, max_new_tokens=24, temperature=0.8, top_k=50,
                           top_p=0.95) for p in prompts]
        out = srv.run()
        for rid, p in zip(rids, prompts):
            toks = out[rid]
            check(len(toks) == len(p) + 24 and all(
                0 <= t < V for t in toks[len(p):]),
                  f"phase 25: sampled request {rid}: bad output")
        runs[graphs] = ([out[r] for r in rids], dict(srv._exec.replays),
                        srv.throughput_stats()["decode_trips"])
        del srv
        gc.collect()
    replays, trips = runs[True][1]["decode"], runs[True][2]
    check(replays == trips,
          f"phase 25: {replays} sampled windows replayed of {trips}")
    same = sum(a == b for a, b in zip(runs[True][0], runs[False][0]))
    return {"windows": trips,
            "windows_replayed": replays,
            "requests_same_tokens_graphs_on_off": same,
            "requests": len(runs[True][0])}


# -------------------------------------------------------------- phase 26
# Speculative serving, tools/serving_benchmark.py's --spec 4 mode
# (:460-474, 736-742): k = 4 drafts a window; tick_window 4 with the
# n-gram drafter (that tool's default under --spec), 1 with the draft
# model; SPEC_NEW new tokens a request (its default is 128 under
# --repeat-suffix: cut to 64 to pay for phase 32 inside the run's time,
# then to 32 for phase 33)
SPEC_K, SPEC_WINDOW, SPEC_NEW = 4, 4, 32
# the draft model of tools/serving_benchmark.py:962-973 at Llama-3-8B:
# half the width, a quarter of the depth, half the heads
DRAFT_CFG = dict(hidden_size=2048, intermediate_size=7168,
                 num_hidden_layers=8, num_attention_heads=16,
                 num_key_value_heads=4)
SAMPLED = dict(temperature=0.8, top_p=0.9)


def repeat_suffix_traffic(cfg):
    """tools/serving_benchmark.py's --repeat-suffix requests (:906-911):
    every prompt tiles one motif of 8 random tokens (seeded), at phase 4's
    prompt lengths, SPEC_NEW new tokens each; the shared motif makes the
    prompts share their prefix blocks."""
    import numpy as np

    motif = np.random.default_rng(26).integers(1, cfg.vocab_size,
                                               8).tolist()
    prompts = [(motif * (n // len(motif) + 1))[:n] for n in PHASE4_LENS]
    return prompts, [SPEC_NEW] * len(prompts)


def _spec_warmup(kw):
    """A speculative cell's warm-up: a random 39-token prompt (the drafts
    miss: the gate's plain trips follow the first speculative trip), 64
    tokens, submitted with the cell's sampling keywords."""
    return [(list(range(1, 40)), 64, kw)]


def _prime_gate(torch, srv, greedy):
    """Capture the gate's plain program (``gate_ticks`` ticks) over zeroed
    inputs (every row idle: its writes land in scratch block 0), so that
    no capture falls in the measured run whether or not the warm-up's
    gate fired."""
    B, TW = srv.max_batch, srv._table_width
    zi = torch.zeros(B, dtype=torch.int32, device="cuda")
    zf = torch.zeros(B, dtype=torch.float32, device="cuda")
    srv._exec.decode_paged(zi, torch.zeros(B, TW, dtype=torch.int32,
                                           device="cuda"), zi, zf, zi, zf,
                           zi, srv._gen, greedy=greedy,
                           ticks=srv.spec.gate_ticks)
    torch.cuda.synchronize()


def spec_breakdown(torch, srv, greedy=True):
    """Host against device time of one speculative trip of the cell's own
    key (every row at 512 tokens of context, random tokens, every draft
    budget k): a fused drafter's scan of ``tick_window`` windows, or a
    host-side drafter's verify window and, apart, its draft program (the
    drafter's graph replayed). Wall time (host clock up to a synchronize),
    the host's enqueue time and the device time of the graph's replay
    (events around passes enqueued back to back); per window as well."""
    import statistics

    ex = srv._exec
    B, bs, k = srv.max_batch, srv.block_size, srv.spec_k
    S, ctx = srv._spec_windows, 512
    nblk = (ctx + S * (k + 1)) // bs + 1
    tables = torch.zeros(B, srv._table_width, dtype=torch.int32)
    for b in range(B):
        tables[b, :nblk] = torch.arange(1 + b * nblk, 1 + (b + 1) * nblk)
    g = torch.Generator(device="cuda").manual_seed(4)
    dev = dict(device="cuda", dtype=torch.int32)
    toks = torch.randint(1, srv.cfg.vocab_size, (B, srv.max_len),
                         generator=g, **dev)
    tables = tables.cuda()
    pos = torch.full((B,), ctx, **dev)
    ones = torch.ones(B, **dev)
    kcaps = torch.full((B,), k, **dev)
    temps = torch.full((B,), SAMPLED["temperature"], device="cuda")
    topps = torch.full((B,), SAMPLED["top_p"], device="cuda")
    zi = torch.zeros(B, **dev)

    if srv._spec_fused:
        def trip():
            return ex.spec_scan(toks, tables, pos, temps, zi, topps, kcaps,
                                ones, srv._gen, greedy=greedy, windows=S)
    else:
        drafts = toks[:, 1:k + 1].contiguous()

        def trip():
            return ex.spec_verify(toks[:, 0], drafts, tables, pos, temps, zi,
                                  topps, kcaps, srv._gen, greedy=greedy)

    def time_pass(fn):
        fn()
        torch.cuda.synchronize()
        walls, enq = [], []
        for _ in range(7):
            t0 = time.perf_counter()
            fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            enq.append(t1 - t0)
        wall = statistics.median(walls) * 1e3
        device = _replayed_ms(torch, fn) if ex.graphs else time_ms(fn, 3)
        return dict(wall_ms=wall, host_enqueue_ms=statistics.median(enq) * 1e3,
                    device_ms=device,
                    device_idle_share=max(0.0, 1.0 - device / wall))

    res = {"verify_trip": time_pass(trip)}
    res["verify_trip"]["windows"] = S
    res["verify_trip"]["device_ms_per_window"] = \
        res["verify_trip"]["device_ms"] / S
    # the trip's host wall over the most tokens it can emit (every draft
    # accepted): the verify path's ceiling
    res["verify_trip"]["ms_per_token_all_accepted"] = \
        res["verify_trip"]["wall_ms"] / (B * S * (k + 1))
    if getattr(srv.drafter, "_graphs", None):
        prog = srv.drafter._graphs[k]
        res["draft_program"] = dict(device_ms=_replayed_ms(torch,
                                                           prog.replay),
                                    forwards=k)
    res["graphs"] = ex.graphs
    log("speculative trip breakdown (host vs device): " + json.dumps(res))
    return res


def _spec_expect(L, megakernel, draft_cfg=None, int8=False):
    """The launches a speculative cell's run must count: every verify
    window and decode tick as a model pass (the per-layer path: an
    attention a layer, 2 norms a layer and the final one; the whole-tick
    kernel: one decode_tick and the final norm; prefill chunks per layer
    either way); the draft model's k forwards a window (a flash forward
    a layer, 2 norms a layer and the final one)."""
    def expect(st):
        windows, ticks, chunks = (st["verify_windows"], st["decode_ticks"],
                                  st["prefill_chunks"])
        if int8:
            # int8 weights: the projections and the head through w8_matmul
            # in every pass (prefill chunks' 128 rows included)
            passes = ticks + windows + chunks
            want = {"paged_attention": L * passes,
                    "rms_norm": (2 * L + 1) * passes,
                    "w8_matmul": (7 * L + 1) * passes, "stream_matmul": 0}
        elif megakernel:
            want = {"decode_tick": ticks + windows,
                    "paged_attention": L * chunks,
                    "rms_norm": ticks + windows + (2 * L + 1) * chunks,
                    "stream_matmul": ticks + windows}
        else:
            passes = ticks + windows + chunks
            want = {"paged_attention": L * passes,
                    "rms_norm": (2 * L + 1) * passes,
                    "stream_matmul": (7 * L + 1) * (ticks + windows)}
        if draft_cfg is not None:
            Ld = draft_cfg["num_hidden_layers"]
            want["rms_norm"] += (2 * Ld + 1) * SPEC_K * windows
            want["flash_fwd"] = Ld * SPEC_K * windows
        return want
    return expect


class ReplayDrafter:
    """A host-side drafter (the ``SpecConfig(drafter=obj)`` protocol) that
    proposes the plain server's own next tokens for a context that is a
    prefix of one of its outputs, and repeats the last token otherwise:
    the verify path at an acceptance near 1, its ceiling on this model
    (the random weights never continue the n-gram drafts)."""

    deterministic = True
    fusible = False

    def __init__(self, outputs):
        self.outputs = [list(o) for o in outputs]

    def propose(self, contexts, k, temps=None, generator=None):
        import numpy as np

        out = np.zeros((len(contexts), k), np.int32)
        for i, ctx in enumerate(contexts):
            if ctx is None:
                continue
            n = len(ctx)
            # the output this context is a prefix of (the repeat-suffix
            # prompts are prefixes of each other: their outputs are not)
            nxt = next((o[n:n + k] for o in self.outputs
                        if len(o) > n and o[:n] == ctx), [])
            out[i] = (nxt + [ctx[-1]] * k)[:k]
        return out, None


def serve_spec_cell(torch, ops, model, label, traffic, megakernel=False,
                    drafter=None, sampled=False, graphs=True, int8=False,
                    **spec_kw):
    """One speculative cell of phase 26 through :func:`serve`:
    ``GenerationServer(spec=SpecConfig(k=SPEC_K, ...), tick_window=
    SPEC_WINDOW)`` (1 with a draft model), per layer or behind
    ``kernels="megakernel"``; ``spec_kw``: more ``SpecConfig`` fields
    (``gate_cooldown=0``: the gate off); every verify window and gated
    plain trip a graph replay; the launches of rows 11 and 13 per window
    checked."""
    from paddle_tpu_torch.inference.speculative import SpecConfig

    L = model.cfg.num_hidden_layers
    kw = dict(SAMPLED) if sampled else {}
    if drafter is None:
        spec = SpecConfig(k=SPEC_K, **spec_kw)
    elif isinstance(drafter, ReplayDrafter):
        spec = SpecConfig(k=SPEC_K, drafter=drafter, **spec_kw)
    else:
        spec = SpecConfig(k=SPEC_K, drafter="model", draft_model=drafter,
                          **spec_kw)
    draft_model = drafter is not None and not isinstance(drafter,
                                                         ReplayDrafter)
    server_kw = dict(spec=spec, tick_window=1 if drafter else SPEC_WINDOW,
                     seed=7)
    if megakernel:
        server_kw["kernels"] = "megakernel"
        per_window = {"decode_tick": 1, "paged_attention": 0, "rms_norm": 1}
    else:
        per_window = {"paged_attention": L, "rms_norm": 2 * L + 1}
    pass_kind = "spec_verify" if drafter is not None else "spec_scan"
    expect_per_pass = {pass_kind: per_window, "decode_paged": per_window}
    if draft_model:
        expect_per_pass[pass_kind] = dict(per_window, flash_fwd=0)

    def prime(srv):
        _prime_gate(torch, srv, greedy=not sampled)

    def breakdown(torch, srv):
        return spec_breakdown(torch, srv, greedy=not sampled)

    try:
        res, _, srv = serve(
            torch, ops, model, label=label + _cell_suffix(graphs),
            expect=_spec_expect(L, megakernel,
                                DRAFT_CFG if draft_model else None, int8),
            expect_per_pass=expect_per_pass, graphs=graphs, traffic=traffic,
            requests_kw=[kw] * len(traffic[0]), warmup=_spec_warmup(kw),
            prime=prime, breakdown=breakdown, **server_kw)
        check(srv._exec.megakernel == megakernel,
              f"{label}: the server's megakernel is {srv._exec.megakernel}")
    finally:
        ops.set_kernel_mode("auto")
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _first_difference(a, b):
    n = 0
    while n < min(len(a), len(b)) and a[n] == b[n]:
        n += 1
    return n


def near_ties(torch, ops, m32, got, want, tie, logits=None):
    """Phase 26 (c): for each request whose speculative tokens differ from
    the plain server's, the target's fp32 logits (the plain twins on the
    fp32 copy, a dense forward over the common tokens; ``logits(ids)``,
    the last position's fp32 logits, when given) at the first differing
    position: the two candidate tokens' logits must lie within ``tie``.
    Returns (requests identical, [per differing request: position, the
    two logits' gap, fp32 argmax among the two], all within)."""
    same, rows, ok = 0, [], True
    ops.set_kernel_mode("reference")
    try:
        for a, b in zip(got, want):
            if a == b:
                same += 1
                continue
            n = _first_difference(a, b)
            ids = torch.tensor([a[:n]], device="cuda")
            with torch.no_grad():
                lg = (logits(ids) if logits is not None else
                      m32.head(m32.model(ids)[:, -1]).float()[0])
            gap = abs(lg[a[n]].item() - lg[b[n]].item())
            top = int(lg.argmax())
            rows.append(dict(position=n, gap=gap,
                             fp32_argmax_is=("spec" if top == a[n] else
                                             "plain" if top == b[n] else
                                             "neither")))
            ok = ok and gap <= tie
    finally:
        ops.set_kernel_mode("auto")
    return same, rows, ok


def verify_vs_decode(torch, ops, model, m32, prompt, following):
    """Phase 26 (b): one request's state after its prefill (its prompt in
    chunks of 128 into fresh pools); a verify window of W = 5 (the first
    token and the plain server's next 4) scored at once, against 5 single
    decode ticks on a copy of the pools — with the kernels (per layer, and
    through decode_tick at W = 5 against W = 1), with the plain twins in
    bf16 and with the plain twins on the fp32 copy. Prints the largest
    |verify - decode| logit difference per position for each (the products
    at 5 rows against 1: 0 with the kernels); the kernels' verify logits
    may be at most DRIFT_RATIO x as far from the fp32 ones as the plain
    bf16 path's (phase 5's rule). Returns the readings, with the largest
    |bf16 kernels - fp32| logit difference seen (verify or decode), the
    ground of (c)'s near-tie diagnostic. The served batch's form, 8
    distinct rows, is :func:`verify_decode_b8`."""
    from paddle_tpu_torch.ops import decode_megakernel as mk

    cfg = model.cfg
    C, bs, W = PREFILL_CHUNK, BLOCK_SIZE, SPEC_K + 1
    n = len(prompt)
    nblk = -(-(n + C) // bs) + 1       # the last chunk's padding too
    table = torch.arange(1, nblk + 1, dtype=torch.int32, device="cuda")
    shape = (nblk + 1, bs, cfg.num_key_value_heads, cfg.head_dim)
    window = torch.tensor([following[:W]], device="cuda")
    posv = torch.tensor([n], dtype=torch.int32, device="cuda")

    def run(m, mode, megakernel=False, B=1):
        ops.set_kernel_mode(mode)
        tb = table[None].expand(B, -1).contiguous()
        win, pv = window.expand(B, -1), posv.expand(B).contiguous()
        pools = [tuple(torch.zeros(shape, dtype=m.cfg.torch_dtype,
                                   device="cuda") for _ in range(2))
                 for _ in range(cfg.num_hidden_layers)]
        with torch.no_grad():
            for start in range(0, n, C):
                chunk = torch.zeros(1, C, dtype=torch.long, device="cuda")
                part = prompt[start:start + C]
                chunk[0, :len(part)] = torch.tensor(part)
                m.model.paged_prefill_chunk(chunk, pools, table, start)
            copy = [tuple(p.clone() for p in pool) for pool in pools]
            flat = [p for pool in pools for p in pool]
            flat_copy = [p for pool in copy for p in pool]
            if megakernel:
                weights = mk.stack_layer_weights(m)

                def tick(toks, pool_list, p):
                    x = m.model.embed_tokens(toks)
                    cr, sr = mk.gather_rope_rows(m.model._cos, m.model._sin,
                                                 p, toks.shape[1])
                    xo, _ = mk.decode_tick(x, pool_list, tb, p, weights, cr,
                                           sr, block_size=bs,
                                           eps=m.cfg.rms_norm_eps)
                    return m.head(m.model.norm(xo)).float()[0]

                ver = tick(win, flat, pv)
                dec = torch.stack([tick(win[:, j:j + 1], flat_copy,
                                        pv + j)[0] for j in range(W)])
            else:
                h, _ = m.model.paged_verify_step(win, pools, tb, pv)
                ver = m.head(h).float()[0]
                dec = torch.stack([m.head(m.model.paged_decode_step(
                    win[:, j:j + 1], copy, tb, pv + j)[0])
                    .float()[0, 0] for j in range(W)])
        ops.set_kernel_mode("auto")
        del pools, copy
        return ver, dec

    paths = {"kernels": run(model, "auto"),
             "plain_bf16": run(model, "reference"),
             "megakernel": run(model, "megakernel", megakernel=True),
             "megakernel_plain_bf16": run(model, "reference",
                                          megakernel=True),
             "plain_fp32": run(m32, "reference")}
    fv, fd = paths["plain_fp32"]

    def rms(t):
        return t.square().mean().sqrt().item()

    res = {name: dict(verify_vs_decode_max_per_position=(v - d).abs()
                      .amax(-1).tolist(),
                      verify_vs_fp32_max=(v - fv).abs().max().item(),
                      verify_vs_fp32_rms=rms(v - fv),
                      decode_vs_fp32_max=(d - fd).abs().max().item())
           for name, (v, d) in paths.items()}
    for kern, plain in (("kernels", "plain_bf16"),
                        ("megakernel", "megakernel_plain_bf16")):
        for key in ("max", "rms"):
            ratio = (res[kern][f"verify_vs_fp32_{key}"]
                     / res[plain][f"verify_vs_fp32_{key}"])
            res[kern][f"drift_ratio_{key}"] = ratio
            check(ratio <= DRIFT_RATIO,
                  f"phase 26 (b): {kern}' verify logits drift from fp32 "
                  f"{ratio:.3g} x as far as {plain}'s (limit {DRIFT_RATIO})")
    for name in ("kernels", "megakernel"):
        check(max(res[name]["verify_vs_decode_max_per_position"]) == 0.0,
              f"phase 26 (b): {name}' verify and decode logits differ at "
              f"B = 1: {res[name]['verify_vs_decode_max_per_position']}")
    res["argmax_verify_equals_decode"] = {
        name: int((v.argmax(-1) == d.argmax(-1)).sum())
        for name, (v, d) in paths.items()}
    res["kernels_vs_fp32_max"] = max(
        max(res[k]["verify_vs_fp32_max"], res[k]["decode_vs_fp32_max"])
        for k in ("kernels", "megakernel"))
    res["rms_logit"] = rms(fv)
    res["prompt_tokens"] = n
    log("phase 26 (b), verify against decode: " + json.dumps(res))
    return res


# phase 26 (b) at the served batch: 8 distinct requests' prompt lengths
B8_LENS = (100, 300, 517, 256, 129, 384, 211, 640)


def verify_decode_b8(torch, ops, model, label, kv_quant="none",
                     megakernel=False, lora=None):
    """Phase 26 (b) at the served batch: 8 requests (distinct prompts of
    B8_LENS tokens, each prefilled in chunks of 128 into its own blocks of
    fresh pools; ``kv_quant`` "int8": int8 pools), then a window of W = 5
    random tokens a row scored at once (a verify window, 40 rows) against
    5 single decode ticks (8 rows) on a copy of the pools, per layer or
    through ``decode_tick`` (``megakernel``); and rows 0 and 7 alone (B =
    1, a verify window of 5 rows and ticks of 1). ``lora``: (adapter pool,
    pages of the 8 rows). Requires verify = decode bit for bit at B = 8
    (over int8 pools the window's later tokens requantize a block before
    its earlier queries read it, so there the difference is printed, not
    required 0) and each row's logits at B = 8 = the same row's alone, in
    both forms, bit for bit. Returns the readings."""
    from paddle_tpu_torch.ops import decode_megakernel as mk

    cfg = model.cfg
    C, bs, W, B = PREFILL_CHUNK, BLOCK_SIZE, SPEC_K + 1, MAX_BATCH
    g = torch.Generator(device="cuda").manual_seed(29)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g,
                             device="cuda") for n in B8_LENS]
    nblk = -(-(max(B8_LENS) + C) // bs) + 1
    tables = (1 + torch.arange(B * nblk, dtype=torch.int32, device="cuda")
              ).reshape(B, nblk)
    pos = torch.tensor(B8_LENS, dtype=torch.int32, device="cuda")
    win = torch.randint(1, cfg.vocab_size, (B, W), generator=g,
                        device="cuda")
    N = B * nblk + 1
    shape = (N, bs, cfg.num_key_value_heads, cfg.head_dim)

    def layer():
        if kv_quant == "int8":
            sc = (N, cfg.num_key_value_heads)
            return (torch.zeros(shape, dtype=torch.int8, device="cuda"),
                    torch.zeros(sc, device="cuda"),
                    torch.zeros(shape, dtype=torch.int8, device="cuda"),
                    torch.zeros(sc, device="cuda"))
        return tuple(torch.zeros(shape, dtype=cfg.torch_dtype, device="cuda")
                     for _ in range(2))

    def factors(rows):
        if lora is None:
            return None, None
        aidx = torch.tensor([lora[1][r] for r in rows], dtype=torch.int32,
                            device="cuda")
        return lora[0].layer_factors(aidx), mk.lora_tables(lora[0], aidx)

    ops.set_kernel_mode("megakernel" if megakernel else "auto")
    weights = mk.stack_layer_weights(model) if megakernel else None
    try:
        with torch.no_grad():
            base = [layer() for _ in range(cfg.num_hidden_layers)]
            for b, p in enumerate(prompts):
                fac, _ = factors([b])
                for start in range(0, len(p), C):
                    chunk = torch.zeros(1, C, dtype=torch.long, device="cuda")
                    part = p[start:start + C]
                    chunk[0, :len(part)] = part
                    model.model.paged_prefill_chunk(chunk, base, tables[b],
                                                    start, fac)

            def window(toks, pools, tb, pv, rows):
                fac, tick_lora = factors(rows)
                if megakernel:
                    x = model.model.embed_tokens(toks)
                    cr, sr = mk.gather_rope_rows(model.model._cos,
                                                 model.model._sin, pv,
                                                 toks.shape[1])
                    xo, _ = mk.decode_tick(
                        x, [t for pool in pools for t in pool], tb, pv,
                        weights, cr, sr, block_size=bs,
                        eps=cfg.rms_norm_eps, lora=tick_lora)
                    h = model.model.norm(xo)
                else:
                    h, _ = model.model.paged_verify_step(toks, pools, tb, pv,
                                                         fac)
                return model.head(h, stream=True).float()

            def both(rows):
                tb, pv, wn = tables[rows], pos[rows], win[rows]
                copy = [tuple(t.clone() for t in pool) for pool in base]
                ver = window(wn, copy, tb, pv, rows)
                copy = [tuple(t.clone() for t in pool) for pool in base]
                dec = torch.cat([window(wn[:, j:j + 1], copy, tb, pv + j,
                                        rows) for j in range(W)], 1)
                return ver, dec

            v8, d8 = both(list(range(B)))
            alone = {r: both([r]) for r in (0, B - 1)}
    finally:
        ops.set_kernel_mode("auto")
    res = dict(verify_vs_decode_max=(v8 - d8).abs().max().item(),
               verify_vs_decode_max_per_position=(v8 - d8).abs()
               .amax(-1).amax(0).tolist(),
               argmax_verify_equals_decode=int(
                   (v8.argmax(-1) == d8.argmax(-1)).sum()),
               rows_alone_equal={str(r): [torch.equal(v8[r], v[0]),
                                          torch.equal(d8[r], d[0])]
                                 for r, (v, d) in alone.items()},
               finite=bool(torch.isfinite(v8).all()), rows=B, window=W)
    log(f"phase 26 (b) {label}, B = {B}: " + json.dumps(res))
    check(res["finite"], f"phase 26 (b) {label}: non-finite logits")
    check(all(all(v) for v in res["rows_alone_equal"].values()),
          f"phase 26 (b) {label}: a row's logits at B = {B} differ from the "
          f"same row's alone: {res['rows_alone_equal']}")
    if kv_quant != "int8":
        check(res["verify_vs_decode_max"] == 0.0,
              f"phase 26 (b) {label}: verify and decode logits differ by "
              f"{res['verify_vs_decode_max']} at B = {B}")
    del base
    torch.cuda.empty_cache()
    return res


def _faulty_accept(orig):
    """A planted fault of the acceptance: one draft more accepted than the
    target agreed with (up to the row's draft budget)."""
    import torch

    def accept(logits, proposals, temps, topks, topps, kcaps, generator,
               qprobs=None, greedy=False):
        out, acc = orig(logits, proposals, temps, topks, topps, kcaps,
                        generator, qprobs, greedy)
        acc2 = torch.minimum(acc + 1, kcaps)
        B, W = out.shape
        pad = torch.cat([proposals.to(out.dtype),
                         torch.zeros(B, 1, dtype=out.dtype,
                                     device=out.device)], 1)
        wpos = torch.arange(W, device=out.device)[None]
        return torch.where(wpos < acc2[:, None], pad, out), acc2
    return accept


def serve_spec(torch, ops, model, phase4_tokens):
    """Phase 26: speculative serving of Llama-3-8B (see the module
    docstring); ``phase4_tokens``: phase 4's plain run of the random-prompt
    traffic, the yardstick of that cell's tokens."""
    import paddle_tpu_torch.inference.speculative as spec_mod
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    cfg = model.cfg
    rs = repeat_suffix_traffic(cfg)
    out = {}
    # (a) the yardsticks: the plain graphed server, per layer and through
    # the whole-tick kernel, on the repeat-suffix traffic
    plain, _, srv = serve(torch, ops, model,
                          label="phase 26 plain (repeat-suffix)", traffic=rs)
    del srv
    plain_mk = serve_megakernel(torch, ops, model, plain["tokens"],
                                label="phase 26 plain megakernel "
                                      "(repeat-suffix)", traffic=rs)
    cells = {
        "ngram": serve_spec_cell(torch, ops, model,
                                 "phase 26 spec ngram (repeat-suffix)", rs),
        "ngram random": serve_spec_cell(
            torch, ops, model, "phase 26 spec ngram (random prompts)",
            phase4_traffic(cfg)),
        "ngram megakernel": serve_spec_cell(
            torch, ops, model, "phase 26 spec ngram megakernel "
                               "(repeat-suffix)", rs, megakernel=True),
        "ngram sampled": serve_spec_cell(
            torch, ops, model, "phase 26 spec ngram sampled "
                               "(repeat-suffix)", rs, sampled=True),
    }
    draft = LlamaForCausalLM(LlamaConfig(
        vocab_size=cfg.vocab_size, max_position_embeddings=MAX_LEN,
        **DRAFT_CFG), seed=1)
    cells["draft model"] = serve_spec_cell(
        torch, ops, model, "phase 26 spec draft model (repeat-suffix)", rs,
        drafter=draft)
    del draft
    # the gate off: every trip speculative, whatever the acceptance
    cells["ngram gate off"] = serve_spec_cell(
        torch, ops, model, "phase 26 spec ngram, gate off (repeat-suffix)",
        rs, gate_cooldown=0)
    # the verify path's ceiling: drafts that the target accepts (the gate
    # off, so that a row's drafts missing after a near tie leave the
    # others speculating)
    cells["replayed drafts"] = serve_spec_cell(
        torch, ops, model, "phase 26 spec replayed drafts, gate off "
                           "(repeat-suffix)", rs,
        drafter=ReplayDrafter(plain["tokens"]), gate_cooldown=0)
    # (d) determinism: graphs off give the greedy cell's tokens; the
    # sampled cell once more from the same seed gives the same bits
    eager = serve_spec_cell(torch, ops, model,
                            "phase 26 spec ngram (repeat-suffix)", rs,
                            graphs=False)
    again = serve_spec_cell(torch, ops, model,
                            "phase 26 spec ngram sampled (repeat-suffix, "
                            "again)", rs, sampled=True)
    det = {"graphs_on_off_identical": sum(
        a == b for a, b in zip(cells["ngram"]["tokens"], eager["tokens"])),
           "eager_requests": len(eager["tokens"]),
           "sampled_twice_identical": sum(
               a == b for a, b in zip(cells["ngram sampled"]["tokens"],
                                      again["tokens"])),
           "requests": len(rs[0])}
    log("phase 26 (d), determinism: " + json.dumps(det))
    check(det["eager_requests"] == min(EAGER_REQUESTS, len(rs[0]))
          and det["graphs_on_off_identical"] == det["eager_requests"],
          f"phase 26 (d): graphs on and off: {det['graphs_on_off_identical']}"
          f" of {det['eager_requests']} requests identical")
    check(det["sampled_twice_identical"] == len(rs[0]),
          f"phase 26 (d): sampled twice: {det['sampled_twice_identical']} of "
          f"{len(rs[0])} requests identical")
    _twin_launches("phase 26 (d)", cells["ngram"], eager)
    t_cells = time.perf_counter()
    # the planted fault of (c): one draft accepted too many
    orig = spec_mod.speculative_accept
    spec_mod.speculative_accept = _faulty_accept(orig)
    try:
        faulty = serve_spec_cell(torch, ops, model,
                                 "phase 26 planted fault: one draft accepted "
                                 "too many", rs)
    finally:
        spec_mod.speculative_accept = orig
    # (b) and (c) against the fp32 copy of the weights
    torch.backends.cuda.matmul.allow_tf32 = False
    import dataclasses as dc

    m32 = LlamaForCausalLM(dc.replace(cfg, dtype="float32"), device="cuda")
    with torch.no_grad():
        for p32, p16 in zip(m32.parameters(), model.parameters()):
            p32.copy_(p16)
    i = PHASE4_LENS.index(517)
    vd = verify_vs_decode(torch, ops, model, m32, rs[0][i],
                          plain["tokens"][i][len(rs[0][i]):])
    vd["b8"] = {name: verify_decode_b8(torch, ops, model, name, kv_quant=kvq,
                                       megakernel=mega)
                for name, kvq, mega in (("kernels", "none", False),
                                        ("megakernel", "none", True),
                                        ("int8-kv", "int8", False),
                                        ("int8-kv megakernel", "int8",
                                         True))}
    # every greedy cell's tokens equal the plain server's, request for
    # request (the verify window's products are the decode tick's bit for
    # bit); near ties are printed as a diagnostic only: both bf16 paths lie
    # within the largest error (b) saw of the fp32 logits, so two tokens
    # they order differently lie within twice it of each other in fp32
    tie = 2 * vd["kernels_vs_fp32_max"]
    ties = {"near_tie_bound": tie}
    n = len(rs[0])
    for name, got, want in (
            ("ngram", cells["ngram"], plain),
            ("ngram random", cells["ngram random"],
             {"tokens": phase4_tokens}),
            ("ngram megakernel", cells["ngram megakernel"], plain_mk),
            ("ngram gate off", cells["ngram gate off"], plain),
            ("draft model", cells["draft model"], plain),
            ("replayed drafts", cells["replayed drafts"], plain),
            ("planted fault", faulty, plain)):
        same, rows, ok = near_ties(torch, ops, m32, got["tokens"],
                                   want["tokens"], tie)
        ties[name] = dict(requests_identical=same, requests=n,
                          differing=rows, near_ties_within_bound=ok)
        if name == "planted fault":
            check(same < n, "phase 26 (c): the planted fault's tokens equal "
                            "the plain server's")
        else:
            check(same == n, f"phase 26 (c): {name}: {same} of {n} requests "
                             f"identical to the plain server's ({rows})")
    log("phase 26 (c), greedy tokens against the plain server: "
        + json.dumps(ties))
    log(f"phase 26 (b), (c) after the cells: "
        f"{time.perf_counter() - t_cells:.1f} s")
    del m32
    gc.collect()
    torch.cuda.empty_cache()
    out.update(plain=plain, plain_megakernel=plain_mk, cells=cells,
               determinism=det, verify_vs_decode=vd, ties=ties)
    return out


def serve_spec_int8(torch, ops, model):
    """Phase 26's int8-weights cell, on the quantized model (phase 11):
    the plain server and the n-gram speculative server (k = 4, tick_window
    4) on the repeat-suffix traffic over bf16 KV pools, every projection
    and the head through w8_matmul (decode ticks, verify windows and
    prefill chunks alike); every request's tokens must equal the plain
    server's; and (b) at B = 8 for the int8 model."""
    check(model.quantized, "phase 26 int8: the model is not quantized")
    L = model.cfg.num_hidden_layers
    rs = repeat_suffix_traffic(model.cfg)

    def expect(st):
        passes = st["decode_ticks"] + st["prefill_chunks"]
        return {"w8_matmul": (7 * L + 1) * passes, "stream_matmul": 0,
                "paged_attention": L * passes,
                "rms_norm": (2 * L + 1) * passes}

    plain, _, srv = serve(torch, ops, model,
                          label="phase 26 plain int8 weights (repeat-suffix)",
                          traffic=rs, expect=expect)
    del srv
    cell = serve_spec_cell(torch, ops, model, "phase 26 spec ngram int8 "
                                              "weights (repeat-suffix)", rs,
                           int8=True)
    n = len(rs[0])
    same = sum(a == b for a, b in zip(cell["tokens"], plain["tokens"]))
    out = dict(requests_identical=same, requests=n,
               plain_decode_tok_s=plain["decode_tok_s"],
               plain_ms_per_decode_tick=plain["ms_per_decode_tick"],
               plain_prefill_tok_s=plain["prefill_tok_s"],
               spec_decode_tok_s=cell["decode_tok_s"],
               acceptance_rate=cell["spec_metrics"]["acceptance_rate"],
               b8=verify_decode_b8(torch, ops, model, "int8 weights"))
    log("phase 26 (c) int8 weights: " + json.dumps(out))
    check(same == n, f"phase 26 (c): int8 weights: {same} of {n} requests "
                     f"identical to the plain server's")
    return out


def log_spec(res):
    """Phase 26's readings once more, for the last lines of the output:
    each cell's rates, acceptance, launches and trip breakdown beside the
    plain cells' ms per tick."""
    plain = {}
    for name in ("plain", "plain_megakernel"):
        r = res[name]
        plain[name] = dict(decode_tok_s=r["decode_tok_s"],
                           ms_per_decode_tick=r["ms_per_decode_tick"],
                           prefill_tok_s=r["prefill_tok_s"],
                           decode_ticks=r["decode_ticks"],
                           tick=r["breakdown"]["decode_window"])
    log("phase 26, plain yardsticks (repeat-suffix): " + json.dumps(plain))
    for name, r in res["cells"].items():
        r = {k: v for k, v in r.items() if k not in ("tokens", "prompts")}
        log(f"phase 26, spec {name}: " + json.dumps(r))
    log("phase 26 (b): " + json.dumps(res["verify_vs_decode"]))
    log("phase 26 (c): " + json.dumps(res["ties"]))
    log("phase 26 (d): " + json.dumps(res["determinism"]))


# -------------------------------------------------------------- phase 29
# the pool of the preempting cells: this share of the blocks phase 4's
# requests need at their full length, so that the batch outgrows it
SCHED_POOL_SHARE = 0.45
# the urgent requests, submitted after the first decode window in which
# every occupied slot decodes (none prefills): prompt lengths and new
# tokens
SCHED_HIGH = ((200, 48), (700, 48), (150, 48), (400, 48))


def sched_traffic(cfg):
    """Phase 29's requests: phase 4's 12 (normal priority) and 4 urgent
    ones (prompts from a seed)."""
    import numpy as np

    prompts, news = phase4_traffic(cfg)
    rng = np.random.default_rng(29)
    high = [rng.integers(1, cfg.vocab_size, n).tolist()
            for n, _ in SCHED_HIGH]
    return prompts, news, high, [m for _, m in SCHED_HIGH]


def swap_copy_rates(torch, srv, nblocks=64, repeats=5):
    """The host pool's copies on the server's own pools: ``nblocks``
    blocks of every layer gathered into pinned host memory (the swap-out
    copy, ``KVOffloadEngine.gather_payload``: one pinned buffer, one
    ``index_select`` and copy a pool tensor) and scattered back in place
    (the swap-in copy: ``index_copy_`` a pool tensor), the same values
    back, each timed on the host from a synchronized card to its end
    (median of ``repeats`` after a warm-up, each payload freed before the
    next: the caching host allocator hands its buffer back): ms a block
    and GB/s each way."""
    import statistics

    eng, pools = srv._offload, srv._exec._flat_pools
    table = list(range(1, nblocks + 1))
    idx = torch.tensor(table, dtype=torch.long, device="cuda")
    nbytes = nblocks * srv.alloc.bytes_per_block
    outs, ins = [], []
    arrays = eng.gather_payload(table, pools)       # warm-up
    for _ in range(repeats):
        arrays = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        arrays = eng.gather_payload(table, pools)
        outs.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p, a in zip(pools, arrays):
            p.index_copy_(0, idx, a.to("cuda", non_blocking=True))
        torch.cuda.synchronize()
        ins.append(time.perf_counter() - t0)
    o, i = statistics.median(outs), statistics.median(ins)
    return dict(blocks=nblocks, bytes=nbytes,
                swap_out_ms_per_block=o / nblocks * 1e3,
                swap_in_ms_per_block=i / nblocks * 1e3,
                swap_out_gb_s=nbytes / o / 1e9, swap_in_gb_s=nbytes / i / 1e9)


def serve_sched(torch, ops, model, label, kv_quant="none", megakernel=False,
                ref_tokens=None, keep=None):
    """One cell of phase 29: ``GenerationServer(policy="priority",
    num_blocks=)`` with a pool of SCHED_POOL_SHARE of the blocks phase 4's
    requests need, per layer or behind ``kernels="megakernel"``, over bf16
    or int8 KV pools. Phase 4's 12 greedy requests at normal priority, then
    (after the first decode window in which no slot prefills, so that a
    victim of theirs decodes and swaps) 4 urgent ones; every step is
    followed
    by ``assert_conserved()``. Every request's tokens must equal those of
    the same request on a pool that never runs dry (``ref_tokens``: the
    12's from that cell's phase-4 run; else they are served here, all 16
    at once), preemptions must happen, no graph may be captured after the
    warm-up, and every decode pass (and every prefill chunk) must launch
    the same kernels as every other. Prints the preemptions and resumes,
    the host pool's peak bytes, the swap copies' ms a block and GB/s, and
    ``sched_metrics()`` / ``load_metrics()``. ``keep``: a dict that
    receives the 16 requests' yardstick tokens under ``label``."""
    from paddle_tpu_torch.inference.scheduler import PRIORITY_HIGH
    from paddle_tpu_torch.inference.serving import GenerationServer

    gc.collect()
    torch.cuda.empty_cache()
    cfg = model.cfg
    prompts, news, high, high_news = sched_traffic(cfg)
    need = sum(-(-(len(p) + n) // BLOCK_SIZE)
               for p, n in zip(prompts, news))
    kw = dict(cache="paged", max_batch=MAX_BATCH, block_size=BLOCK_SIZE,
              prefill_chunk=PREFILL_CHUNK, max_len=MAX_LEN,
              kv_quant=kv_quant)
    if megakernel:
        kw["kernels"] = "megakernel"
    try:
        ref = GenerationServer(model, **kw)
        todo = list(zip(high, high_news))
        if ref_tokens is None:
            todo = list(zip(prompts, news)) + todo
        rids = [ref.submit(p, max_new_tokens=n) for p, n in todo]
        out = ref.run()
        want = list(ref_tokens or []) + [out[r] for r in rids]
        if keep is not None:
            keep[label] = want
        del ref, out
        gc.collect()
        torch.cuda.empty_cache()
        srv = GenerationServer(model, policy="priority",
                               num_blocks=int(SCHED_POOL_SHARE * need) + 1,
                               **kw)
        ex = srv._exec
        srv.submit(list(range(1, 40)), max_new_tokens=8)   # warm-up
        srv.run()
        captures = ex.captures
        per_pass = []
        for kind in ("decode_paged", "chunk_prefill"):
            def counted(*a, _fn=getattr(ex, kind), _kind=kind, **k):
                before = ops.launch_counts()
                res = _fn(*a, **k)
                per_pass.append((_kind, {n: c - before[n] for n, c in
                                         ops.launch_counts().items()}))
                return res
            setattr(ex, kind, counted)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        rids = [srv.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, news)]
        trips0 = srv.throughput_stats()["decode_trips"]
        high_rids, peak_q, steps = None, 0, 0
        while True:
            left = srv.step()
            steps += 1
            srv.assert_conserved()
            peak_q = max(peak_q, srv.load_metrics()["queue_depth"])
            if high_rids is None and \
                    srv.throughput_stats()["decode_trips"] > trips0 and \
                    not any(srv._prefilling[s] for s in range(MAX_BATCH)
                            if srv._slots[s] is not None):
                high_rids = [srv.submit(p, max_new_tokens=n,
                                        priority=PRIORITY_HIGH)
                             for p, n in zip(high, high_news)]
                continue
            if not left and high_rids is not None:
                break
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = srv.take_results()
        for kind in ("decode_paged", "chunk_prefill"):
            delattr(ex, kind)
        sm = srv.sched_metrics()
        lm = srv.load_metrics()
        tokens = [got.get(r) for r in rids + high_rids]
        same = sum(a == b for a, b in zip(tokens, want))
        kinds = {}
        for kind, counts in per_pass:
            kinds.setdefault(kind, set()).add(tuple(sorted(
                (n, c) for n, c in counts.items() if c)))
        rates = swap_copy_rates(torch, srv)
        eng = srv._offload
        res = dict(requests=len(tokens), requests_identical=same,
                   num_blocks=srv.alloc.num_blocks, blocks_needed=need,
                   steps=steps, wall_s=wall, peak_queue_depth=peak_q,
                   preemptions=sm["preemptions"], resumes=sm["resumes"],
                   prefill_aborts=sm["prefill_aborts"],
                   stalled_reservations=sm["stalled_reservations"],
                   host_bytes_peak=sm["host_bytes_peak"],
                   swap_out_blocks=srv.kv_stats()["swap_out_blocks"],
                   swap_in_blocks=srv.kv_stats()["swap_in_blocks"],
                   swap_out_wall_ms_per_block=(
                       eng.swap_out_s * 1e3
                       / max(srv.kv_stats()["swap_out_blocks"], 1)),
                   captures_after_warmup=ex.captures - captures,
                   launch_sets_per_pass_kind={k: len(v)
                                              for k, v in kinds.items()},
                   sched_metrics=sm, load_metrics=lm, copy_rates=rates,
                   throughput=srv.throughput_stats())
        log(f"phase 29 {label}: " + json.dumps(res))
        check(all(t is not None for t in tokens),
              f"phase 29 {label}: a request did not finish")
        check(same == len(tokens), f"phase 29 {label}: {same} of "
                                   f"{len(tokens)} requests identical to the "
                                   f"run on a pool that never runs dry")
        check(sm["preemptions"] > 0 and sm["resumes"] > 0,
              f"phase 29 {label}: no swap ({sm})")
        check(ex.captures == captures, f"phase 29 {label}: "
                                       f"{ex.captures - captures} graph "
                                       f"captures after the warm-up")
        check(all(len(v) == 1 for v in kinds.values()),
              f"phase 29 {label}: passes of one kind launched different "
              f"kernels: {kinds}")
        check(sm["host_bytes_in_use"] == 0 and sm["swapped_waiting"] == 0,
              f"phase 29 {label}: host pool not drained ({sm})")
    finally:
        ops.set_kernel_mode("auto")
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    return res


def scheduling(torch, ops, model, ref=None, yardsticks=None):
    """Phase 29: the preempting cells, bf16 and int8 KV, per layer and
    behind the whole-tick kernel. ``ref``: {cell: phase 4's tokens of the
    same pool and kernels} (None: served here); ``yardsticks``: a dict
    that receives each cell's 16 yardstick tokens (phase 30's
    references)."""
    ref = ref or {}
    out = {}
    for name, kvq, mega in (("bf16", "none", False),
                            ("bf16 megakernel", "none", True),
                            ("int8-kv", "int8", False),
                            ("int8-kv megakernel", "int8", True)):
        out[name] = serve_sched(torch, ops, model, name, kv_quant=kvq,
                                megakernel=mega, ref_tokens=ref.get(name),
                                keep=yardsticks)
    return out


# -------------------------------------------------------------- phase 30
# Observability and recovery over phase 4's model and traffic (and phase
# 29's overload): (a) telemetry on / off, (b) the fault ladder, (c)
# snapshot / restore and migration, (d) the warm KV tier, and (e) the
# train engine's telemetry and retried step. The fault plan of (b): a
# poisoned request (the first of the traffic, decoding from the first
# trip) faulted on the first 4 trips (> fault_retries = 3: quarantined),
# two tick faults later (retried), allocator exhaustion, the first
# swap-out refused by the host pool and the first swap-in's payload
# corrupted (the re-prefill rung)
RECOVERY_TICK_AT, RECOVERY_ALLOC_AT = 12, 150
# (d): a shared prompt prefix of 1024 tokens (64 blocks) behind two
# requests, four 1000-token prompts between them that push the pool's
# free share under the low watermark, in a pool of 300 usable blocks
WARM_PREFIX, WARM_SUFFIX, WARM_PRESSURE, WARM_NEW = 1024, 100, 1000, 32
WARM_BLOCKS, WARM_LOW, WARM_HIGH = 301, 0.3, 0.6
# (e): phase 7's cell, 8 steps a run (the first two the warm-up and the
# capture), the parameters compared after 5
RECOVERY_TRAIN_STEPS = 8



def _rec_server(torch, model, warm=True, **kw):
    """A phase-4 server (its slots, blocks, chunk and max_len) over
    ``model`` with ``kw``, warmed up by one greedy request (its graphs
    captured) unless ``warm`` is False; a fault injector is disarmed for
    the warm-up (its sites count from the traffic's first call)."""
    from paddle_tpu_torch.inference.serving import GenerationServer

    gc.collect()
    torch.cuda.empty_cache()
    srv = GenerationServer(model, cache="paged", max_batch=MAX_BATCH,
                           block_size=BLOCK_SIZE,
                           prefill_chunk=PREFILL_CHUNK, max_len=MAX_LEN,
                           device=model.device, **kw)
    if warm:
        armed, srv.faults.enabled = srv.faults.enabled, False
        srv.submit(list(range(1, 40)), max_new_tokens=4 * srv.tick_window)
        srv.run()
        srv.faults.enabled = armed
    return srv


def _drain(srv, conserve=False):
    """Step ``srv`` until it holds no work; returns the steps."""
    steps = 0
    while srv.step():
        if conserve:
            srv.assert_conserved()
        steps += 1
        check(steps < 20000, "phase 30: a server wedged")
    return steps


def _overload(srv, traffic, stop=None, conserve=True):
    """Phase 29's overload through ``srv``: the 12 requests at normal
    priority, then the 4 urgent ones after the first decode window in
    which no slot prefills; ``stop(srv)``, when given, ends the drive
    early (once the urgent ones are in) and returns True. Returns (the
    16 rids, whether it stopped early)."""
    from paddle_tpu_torch.inference.scheduler import PRIORITY_HIGH

    prompts, news, high, high_news = traffic
    rids = [srv.submit(p, max_new_tokens=n) for p, n in zip(prompts, news)]
    trips0 = srv.throughput_stats()["decode_trips"]
    high_rids, steps = None, 0
    while True:
        left = srv.step()
        steps += 1
        check(steps < 20000, "phase 30: an overloaded server wedged")
        if conserve:
            srv.assert_conserved()
        if high_rids is None and \
                srv.throughput_stats()["decode_trips"] > trips0 and \
                not any(srv._prefilling[s] for s in range(srv.max_batch)
                        if srv._slots[s] is not None):
            high_rids = [srv.submit(p, max_new_tokens=n,
                                    priority=PRIORITY_HIGH)
                         for p, n in zip(high, high_news)]
            continue
        if high_rids is not None and stop is not None and stop(srv):
            return rids + high_rids, True
        if not left and high_rids is not None:
            return rids + high_rids, False


def _recovery_ref(torch, model, traffic, **kw):
    """The overload traffic's tokens on a pool that never runs dry, all 16
    at once (phase 29's yardstick)."""
    prompts, news, high, high_news = traffic
    srv = _rec_server(torch, model, warm=False, **kw)
    rids = [srv.submit(p, max_new_tokens=n)
            for p, n in zip(prompts + high, news + high_news)]
    out = srv.run()
    del srv
    return [out[r] for r in rids]


def _tight_blocks(cfg, traffic):
    prompts, news = traffic[0], traffic[1]
    need = sum(-(-(len(p) + n) // BLOCK_SIZE) for p, n in zip(prompts, news))
    return int(SCHED_POOL_SHARE * need) + 1


def recovery_telemetry(torch, model, ref, here, megakernel=False):
    """(a) Phase 4's traffic with ``telemetry=True`` and without, in turns
    (off, on; per layer or behind the whole-tick kernel): the
    same tokens (phase 4's), decode tok/s both ways and the host ms a
    step that telemetry adds (the steps' wall difference); with it on,
    the flight records and spans, the chrome trace written and read back
    (events a request), no ``steady_state_recompile`` after the warm-up
    and ``sched_metrics()["tenants"]``."""
    cfg = model.cfg
    prompts, news = phase4_traffic(cfg)
    label = "phase 30 (a) telemetry" + (" megakernel" if megakernel else "")
    kw = dict(kernels="megakernel") if megakernel else {}
    runs = {False: [], True: []}
    seen = {}
    # one turn each way (off, on, on, off per layer before phase 32 took
    # the time)
    for on in (False, True):
        srv = _rec_server(torch, model, telemetry=on, **kw)
        if on:
            srv.telemetry.reset()      # the warm-up boundary
        caps = srv._exec.captures
        t_before = srv.throughput_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = [srv.submit(p, max_new_tokens=m) for p, m in zip(prompts, news)]
        steps = _drain(srv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out = srv.take_results()
        toks = [out.get(r) for r in rids]
        check(toks == ref, f"{label} (telemetry={on}): "
                           f"{sum(a == b for a, b in zip(toks, ref))} of "
                           f"{len(ref)} requests equal to phase 4's")
        t_after = srv.throughput_stats()
        st = {k: t_after[k] - t_before[k] for k in t_after}
        runs[on].append(dict(wall_s=wall, steps=steps,
                             host_ms_per_step=wall / steps * 1e3,
                             decode_tok_s=st["decode_tokens"]
                             / st["decode_s"],
                             captures_after_warmup=srv._exec.captures
                             - caps))
        check(srv._exec.captures == caps,
              f"{label}: {srv._exec.captures - caps} graph captures after "
              f"the warm-up")
        if on and "flight_records" not in seen:
            tel = srv.telemetry
            finds = srv.watchdog_findings()
            check(not [f for f in finds
                       if f["kind"] == "steady_state_recompile"],
                  f"{label}: recapture findings {finds}")
            sm = srv.sched_metrics()
            check("tenants" in sm and sm["tenants"]["default"]["completed"]
                  == len(rids), f"{label}: tenants {sm.get('tenants')}")
            with tempfile.TemporaryDirectory(dir=here) as tmp:
                path = srv.export_chrome_trace(os.path.join(tmp,
                                                            "trace.json"))
                with open(path) as f:
                    evs = json.load(f)["traceEvents"]
            per_req = [sum(1 for e in evs if e.get("tid") == r
                           and e["ph"] in ("X", "i")) for r in rids]
            check(min(per_req) > 0, f"{label}: a request without trace "
                                    f"events")
            seen = dict(flight_records=tel.flight.total,
                        spans=len(tel.tracer.spans()),
                        trace_events=len(evs),
                        trace_events_per_request=per_req,
                        watchdog_findings=finds,
                        tenants=sm["tenants"],
                        snapshot_keys=sorted(srv.telemetry_snapshot()))
        del srv
    off = runs[False]
    on = runs[True]
    res = dict(
        off=off, on=on,
        decode_tok_s_off=_median([r["decode_tok_s"] for r in off]),
        decode_tok_s_on=_median([r["decode_tok_s"] for r in on]),
        host_ms_per_step_added=(
            sum(r["host_ms_per_step"] for r in on) / len(on)
            - sum(r["host_ms_per_step"] for r in off) / len(off)),
        **seen)
    log(f"{label}: " + json.dumps(res))
    return res


def recovery_faults(torch, model, traffic, ref, kv_quant="none"):
    """(b) Phase 29's overload on its tight pool under one fault plan
    (above), bf16 or int8 KV, ``assert_conserved()`` after every step:
    the poisoned request quarantined, every other request's tokens those
    of the run on a pool that never runs dry, each rung fired and
    counted."""
    from paddle_tpu_torch.faults import FaultInjector, FaultPlan, FaultSpec

    label = f"phase 30 (b) faults {kv_quant}"
    poison = 1          # the warm-up request took rid 0
    inj = FaultInjector(FaultPlan([
        FaultSpec("tick", at=0, count=4, rid=poison),
        FaultSpec("tick", at=RECOVERY_TICK_AT, count=2),
        FaultSpec("alloc", at=RECOVERY_ALLOC_AT, count=2),
        FaultSpec("host_put", at=0),
        FaultSpec("swap_corrupt", at=0)], seed=30))
    srv = _rec_server(torch, model, kv_quant=kv_quant, policy="priority",
                      num_blocks=_tight_blocks(model.cfg, traffic),
                      faults=inj, telemetry=True)
    t0 = time.perf_counter()
    rids, _ = _overload(srv, traffic)
    wall = time.perf_counter() - t0
    statuses = [srv.status(r) for r in rids]
    out = srv.take_results()
    toks = [out.get(r) for r in rids]
    reg = srv.telemetry.registry
    sites = {s for s, _ in inj.fired}
    same = sum(t == w for t, w, s in zip(toks, ref, statuses)
               if s != "failed")
    res = dict(requests=len(rids), quarantined=statuses.count("failed"),
               surviving_identical=same, fired=inj.fired, wall_s=wall,
               tick_retries=reg.counter("serving_tick_retries").total(),
               reprefills=reg.counter("serving_swap_reprefills").total(),
               faults_injected={s: reg.counter(
                   "serving_faults_injected").value(site=s)
                   for s in ("tick", "drafter")},
               sched_metrics={k: v for k, v in srv.sched_metrics().items()
                              if k != "tenants"},
               kv_stats=srv.kv_stats(), audit=srv.assert_conserved())
    log(f"{label}: " + json.dumps(res))
    check(statuses[0] == "failed" and statuses.count("failed") == 1,
          f"{label}: statuses {statuses}")
    check(same == len(rids) - 1, f"{label}: {same} of {len(rids) - 1} "
                                 f"surviving requests identical")
    check({"tick", "alloc", "host_put", "swap_corrupt"} <= sites,
          f"{label}: fired {inj.fired}")
    check(res["reprefills"] >= 1 and res["tick_retries"] >= 6,
          f"{label}: rungs {res}")
    del srv
    return res


def recovery_drafter(torch, model, ref):
    """(b) A ``drafter`` fault in phase 26's n-gram cell (k = 4,
    ``tick_window`` 4) over phase 4's traffic: the trip runs the plain
    program, and every request's tokens are phase 4's."""
    from paddle_tpu_torch.faults import FaultInjector, FaultPlan, FaultSpec
    from paddle_tpu_torch.inference.speculative import SpecConfig

    inj = FaultInjector(FaultPlan([FaultSpec("drafter", at=1)]))
    srv = _rec_server(torch, model, spec=SpecConfig(k=SPEC_K),
                      tick_window=SPEC_WINDOW, seed=7, faults=inj,
                      warm=False)
    prompts, news = phase4_traffic(model.cfg)
    rids = [srv.submit(p, max_new_tokens=m) for p, m in zip(prompts, news)]
    out = srv.run()
    toks = [out[r] for r in rids]
    reg = srv.telemetry.registry
    res = dict(fired=inj.fired, identical=sum(a == b for a, b in
                                              zip(toks, ref)),
               drafter_faults=reg.counter("serving_faults_injected")
               .value(site="drafter"), spec_metrics=srv.spec_metrics())
    log("phase 30 (b) drafter fault, n-gram: " + json.dumps(res))
    check(inj.fired == [("drafter", 1)] and res["drafter_faults"] == 1,
          f"phase 30 (b) drafter: {res}")
    check(res["identical"] == len(ref), f"phase 30 (b) drafter: "
                                        f"{res['identical']} of {len(ref)}")
    del srv
    return res


def recovery_fatal(torch, model):
    """(b) A ``fatal`` tick fault: the run raises, the server is failed,
    ``submit`` raises ``EngineFailedError``, a salvage snapshot works."""
    from paddle_tpu_torch.faults import (EngineFailedError, FaultInjector,
                                         FaultPlan, FaultSpec)

    srv = _rec_server(torch, model, warm=False, faults=FaultInjector(
        FaultPlan([FaultSpec("tick", at=0, kind="fatal")])))
    srv.submit(list(range(1, 200)), max_new_tokens=8)
    try:
        srv.run()
        fail("phase 30 (b) fatal: the run did not raise")
    except RuntimeError as e:
        check("injected fatal" in str(e), f"phase 30 (b) fatal: {e}")
    try:
        srv.submit([1, 2, 3], max_new_tokens=2)
        fail("phase 30 (b) fatal: submit did not raise")
    except EngineFailedError:
        pass
    phases = [d["phase"] for d in srv.snapshot(trust_kv=False)["requests"]]
    log(f"phase 30 (b) fatal: submit raises EngineFailedError; salvage "
        f"snapshot phases {phases}")
    del srv
    return dict(submit_raises="EngineFailedError", salvage_phases=phases)


def _payload_bytes(snap):
    return sum(d["kv"]["nbytes"] for d in snap["requests"]
               if d["phase"] == "kv") + sum(w["nbytes"]
                                            for w in snap["warm_tier"])


def recovery_snapshot(torch, model, traffic, ref, megakernel=False):
    """(c) Phase 29's overload on its tight pool (per layer or behind the
    whole-tick kernel) until swapped entries wait and slots decode; then
    ``snapshot()`` (the decoding slots' KV copied) and
    ``snapshot(trust_kv=False)`` (salvage: they re-prefill); the captured
    server runs on, and each snapshot restores into a fresh server over
    the same model: all 16 requests' tokens in every run must be those of
    the pool that never runs dry."""
    label = "phase 30 (c) snapshot" + (" megakernel" if megakernel else "")
    kw = dict(policy="priority",
              num_blocks=_tight_blocks(model.cfg, traffic))
    if megakernel:
        kw["kernels"] = "megakernel"
    srv = _rec_server(torch, model, **kw)

    def swapped_and_decoding(s):
        return s.sched_metrics()["swapped_waiting"] > 0 and any(
            s._slots[i] is not None and not s._prefilling[i]
            for i in range(s.max_batch))
    rids, stopped = _overload(srv, traffic, stop=swapped_and_decoding)
    check(stopped, f"{label}: no step with swapped entries and decoding "
                   f"slots")
    snaps, res = {}, {}
    for trust in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snaps[trust] = srv.snapshot(trust_kv=trust)
        res[f"snapshot_ms_{'kv' if trust else 'salvage'}"] = \
            (time.perf_counter() - t0) * 1e3
    phases = [d["phase"] for d in snaps[True]["requests"]]
    res.update(snapshot_bytes=_payload_bytes(snaps[True]),
               salvage_bytes=_payload_bytes(snaps[False]),
               phases=phases, finished_before=len(snaps[True]["results"]),
               swapped_waiting=srv.sched_metrics()["swapped_waiting"])
    _drain(srv, conserve=True)
    out = srv.take_results()
    res["captured_identical"] = sum(out.get(r) == w
                                    for r, w in zip(rids, ref))
    del srv
    for trust in (True, False):
        name = "kv" if trust else "salvage"
        fresh = _rec_server(torch, model, warm=False, **kw)
        t0 = time.perf_counter()
        n = fresh.restore(snaps[trust])
        res[f"restore_ms_{name}"] = (time.perf_counter() - t0) * 1e3
        _drain(fresh, conserve=True)
        out = fresh.run()
        res[f"restored_{name}"] = n
        res[f"restored_identical_{name}"] = sum(
            out.get(r) == w for r, w in zip(rids, ref))
        res[f"reprefills_{name}"] = fresh.telemetry.registry.counter(
            "serving_swap_reprefills").total()
        del fresh
    log(f"{label}: " + json.dumps(res))
    check(phases.count("kv") >= 2, f"{label}: KV payloads {phases}")
    for key in ("captured_identical", "restored_identical_kv",
                "restored_identical_salvage"):
        check(res[key] == len(rids), f"{label}: {key} {res[key]} of "
                                     f"{len(rids)}")
    return res


def recovery_migrate(torch, model, ref):
    """(c) ``evacuate(rids=[r])`` one decoding request of phase 4's
    traffic out of its server (its KV copied), ``admit_migrated`` it into
    a server busy with 4 requests of its own: every request's tokens
    (phase 4's) on both servers."""
    prompts, news = phase4_traffic(model.cfg)
    src = _rec_server(torch, model)
    rids = [src.submit(p, max_new_tokens=m) for p, m in zip(prompts, news)]
    moving = rids[1]                    # the 1000-token prompt

    def generated(rid):
        return next((len(r.generated) for r in src._slots
                     if r is not None and r.rid == rid), 0)
    while src.status(moving) != "running" or generated(moving) < 4:
        check(src.step() > 0, "phase 30 (c) migrate: the request finished")
    t0 = time.perf_counter()
    snap = src.evacuate(rids=[moving])
    evac_ms = (time.perf_counter() - t0) * 1e3
    check([d["phase"] for d in snap["requests"]] == ["kv"],
          f"phase 30 (c) migrate: {snap['requests']}")
    dst = _rec_server(torch, model, warm=False)
    dst.set_rid_base(1000)
    own = [dst.submit(p, max_new_tokens=m)
           for p, m in zip(prompts[4:8], news[4:8])]
    for _ in range(3):
        dst.step()
    dst.admit_migrated(snap["requests"][0], source_config=snap["config"])
    out_dst = dst.run()
    out_src = src.run()
    res = dict(evacuate_ms=evac_ms, moved_bytes=_payload_bytes(snap),
               moved_identical=out_dst[moving] == ref[1],
               busy_identical=sum(out_dst[r] == ref[4 + i]
                                  for i, r in enumerate(own)),
               source_identical=sum(out_src[r] == ref[i]
                                    for i, r in enumerate(rids)
                                    if r != moving))
    log("phase 30 (c) migrate: " + json.dumps(res))
    check(res["moved_identical"] and res["busy_identical"] == 4
          and res["source_identical"] == len(rids) - 1,
          f"phase 30 (c) migrate: {res}")
    dst.assert_conserved()
    src.assert_conserved()
    del src, dst
    return res


def warm_traffic(cfg):
    """(d): request A (the shared prefix and its own suffix), the four
    pressure prompts, then C (the prefix and another suffix)."""
    import numpy as np

    rng = np.random.default_rng(30)
    prefix = rng.integers(1, cfg.vocab_size, WARM_PREFIX).tolist()
    a = prefix + rng.integers(1, cfg.vocab_size, WARM_SUFFIX).tolist()
    pressure = [rng.integers(1, cfg.vocab_size, WARM_PRESSURE).tolist()
                for _ in range(4)]
    c = prefix + rng.integers(1, cfg.vocab_size, WARM_SUFFIX).tolist()
    return [[a], pressure, [c]]


def _warm_run(srv, waves):
    toks = []
    for wave in waves:
        rids = [srv.submit(p, max_new_tokens=WARM_NEW) for p in wave]
        _drain(srv, conserve=True)
        out = srv.take_results()
        toks += [out[r] for r in rids]
    return toks


def tier_copy_rates(torch, srv, prompt, repeats=3):
    """The warm tier's copies on the server's own pools: the first
    WARM_PREFIX // BLOCK_SIZE blocks of ``prompt``'s cached chain demoted
    (``KVOffloadEngine.demote``: one gather into pinned memory, its
    synchronise, a CRC and a host copy a block) and promoted back
    (``match_prefix_tiered``: ``index_copy_`` a pool tensor, timed to a
    synchronise), median of ``repeats``: ms a block and GB/s each way."""
    import statistics

    a, eng, pools = srv.alloc, srv._offload, srv._exec._flat_pools
    n = WARM_PREFIX // BLOCK_SIZE
    hashes = a.chain_hashes(prompt)[:n]
    downs, ups = [], []
    for _ in range(repeats):
        victims = [(a._by_hash[h], h) for h in hashes]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        moved = eng.demote(victims, pools)
        downs.append(time.perf_counter() - t0)
        check(moved == n, f"phase 30 (d): demoted {moved} of {n}")
        t0 = time.perf_counter()
        table, _, st = eng.match_prefix_tiered(prompt, pools)
        torch.cuda.synchronize()
        ups.append(time.perf_counter() - t0)
        check(st["warm"] == n, f"phase 30 (d): promoted {st}")
        for bid in table:
            a.free(bid)
    d, u = statistics.median(downs), statistics.median(ups)
    nbytes = n * a.bytes_per_block
    return dict(blocks=n, bytes=nbytes, demote_ms_per_block=d / n * 1e3,
                promote_ms_per_block=u / n * 1e3,
                demote_gb_s=nbytes / d / 1e9, promote_gb_s=nbytes / u / 1e9)


def recovery_warm(torch, model, kv_quant="none"):
    """(d) The warm tier: A, then the pressure prompts (the free share
    falls under ``tier_demote_low``, the coldest cached blocks — A's,
    the shared prefix first — move to host memory), then C, whose prefix
    is promoted back; every token that of a server with no warm tier;
    then the copies' rates."""
    label = f"phase 30 (d) warm tier {kv_quant}"
    waves = warm_traffic(model.cfg)
    plain = _rec_server(torch, model, warm=False, kv_quant=kv_quant)
    want = _warm_run(plain, waves)
    del plain
    srv = _rec_server(torch, model, warm=False, kv_quant=kv_quant,
                      num_blocks=WARM_BLOCKS, tier_demote_low=WARM_LOW,
                      tier_demote_high=WARM_HIGH)
    got = _warm_run(srv, waves)
    st = srv.kv_stats()
    res = dict(identical=sum(a == b for a, b in zip(got, want)),
               requests=len(want),
               **{k: st[k] for k in ("warm_demoted_blocks",
                                     "warm_promoted_blocks", "cold_refills",
                                     "evictions", "warm_bytes_peak")},
               rates=tier_copy_rates(torch, srv, waves[2][0]))
    log(f"{label}: " + json.dumps(res))
    prefix_blocks = WARM_PREFIX // BLOCK_SIZE
    check(res["identical"] == len(want), f"{label}: {res['identical']} of "
                                         f"{len(want)} identical")
    check(st["warm_demoted_blocks"] >= prefix_blocks
          and st["warm_promoted_blocks"] >= prefix_blocks,
          f"{label}: the prefix did not go warm and come back ({st})")
    srv.assert_conserved()
    del srv
    return res


def recovery_generator(torch, model):
    """The server generator behind a graph: after sampled windows replayed
    from a graph that registers it, ``get_state()`` reports a moved
    offset, and ``set_state()`` of the earlier state makes the same
    replays draw the same tokens (what a restore relies on)."""
    srv = _rec_server(torch, model, warm=False, seed=3)
    srv.submit(list(range(1, 40)), max_new_tokens=8, temperature=0.8)
    srv.run()                           # the sampled window's graph
    prompt = list(range(5, 5 + MAX_LEN // 8))
    state = srv._gen.get_state()
    r = srv.submit(prompt, max_new_tokens=24, temperature=0.8)
    first = srv.run()[r]
    moved = srv._gen.get_state()
    srv._gen.set_state(state)
    r = srv.submit(prompt, max_new_tokens=24, temperature=0.8)
    again = srv.run()[r]
    res = dict(offset_moved=not torch.equal(state, moved),
               same_draws=first == again,
               state_after_equal=torch.equal(srv._gen.get_state(), moved),
               sampled_replays=srv._exec.replays["decode"])
    log("phase 30 generator state behind a graph: " + json.dumps(res))
    check(all(v for k, v in res.items() if k != "sampled_replays"),
          f"phase 30 generator state: {res}")
    del srv
    return res


def recovery_serving(torch, ops, model, here, ref=None, over=None):
    """Phase 30's serving half, (a)-(d), with the bf16 model on the card;
    ``ref``: {cell: phase 4's tokens} (None: served here); ``over``:
    {cell: phase 29's yardstick tokens of the overload traffic} for
    "bf16", "int8-kv" and "bf16 megakernel" (None: served here, all 16 at
    once on a pool that never runs dry). Returns the readings and the
    launches of the whole half."""
    cfg = model.cfg
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    ref = dict(ref or {})
    out, secs = {}, {}

    def cell(name, fn, *a, **kw):
        t = time.perf_counter()
        out[name] = fn(*a, **kw)
        secs[name] = time.perf_counter() - t

    try:
        traffic = sched_traffic(cfg)
        t = time.perf_counter()
        if over is None:
            over = {"bf16": _recovery_ref(torch, model, traffic),
                    "int8-kv": _recovery_ref(torch, model, traffic,
                                             kv_quant="int8"),
                    "bf16 megakernel": _recovery_ref(torch, model, traffic,
                                                     kernels="megakernel")}
        secs["references"] = time.perf_counter() - t
        ops.set_kernel_mode("auto")
        for name in ("bf16", "bf16 megakernel"):
            ref.setdefault(name, over[name][:len(PHASE4_LENS)])
        cell("telemetry", recovery_telemetry, torch, model, ref["bf16"],
             here)
        cell("telemetry megakernel", recovery_telemetry, torch, model,
             ref["bf16 megakernel"], here, megakernel=True)
        ops.set_kernel_mode("auto")
        cell("generator", recovery_generator, torch, model)
        cell("faults bf16", recovery_faults, torch, model, traffic,
             over["bf16"])
        cell("faults int8-kv", recovery_faults, torch, model, traffic,
             over["int8-kv"], "int8")
        cell("drafter", recovery_drafter, torch, model, ref["bf16"])
        cell("fatal", recovery_fatal, torch, model)
        cell("snapshot", recovery_snapshot, torch, model, traffic,
             over["bf16"])
        cell("snapshot megakernel", recovery_snapshot, torch, model,
             traffic, over["bf16 megakernel"], megakernel=True)
        ops.set_kernel_mode("auto")
        cell("migrate", recovery_migrate, torch, model, ref["bf16"])
        cell("warm bf16", recovery_warm, torch, model)
        cell("warm int8-kv", recovery_warm, torch, model, "int8")
        log("phase 30 (a)-(d) cell seconds: " + json.dumps(secs))
    finally:
        ops.set_kernel_mode("auto")
    launches = ops.launch_counts()
    for name in ("paged_attention", "paged_attention_int8", "rms_norm",
                 "stream_matmul", "decode_tick"):
        check(launches[name] > 0, f"phase 30: {name} never launched")
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    return out


def recovery_train(torch, ops):
    """(e) Phase 7's cell (8 Llama-3-8B-wide layers, B = 2 x 2048, AdamW
    with clip): the graphed step with ``TrainTelemetry`` (peak_flops: this
    card's bf16 peak) and without, and a ``train_step`` fault at step 3,
    retried: after 5 steps the parameters equal the fault-free run's bit
    for bit; goodput exactly 1.0."""
    from paddle_tpu_torch.faults import (FaultInjector, FaultPlan, FaultSpec,
                                         StepFault)
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama3_8b_config)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ParallelEngine
    from paddle_tpu_torch.telemetry import TrainTelemetry

    t_start = time.perf_counter()
    ops.reset_launch_counts()
    cfg = llama3_8b_config(num_hidden_layers=TRAIN_LAYERS)
    model = LlamaForCausalLM(cfg, seed=0)
    gen = torch.Generator(device=model.device).manual_seed(7)
    tok = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1),
                        generator=gen, device=model.device)
    batch = (tok[:, :-1].contiguous(), tok[:, 1:].contiguous())
    steps, at = RECOVERY_TRAIN_STEPS, 3

    def run(injector=None, telemetry=None):
        model.reset_parameters(0)
        opt = AdamW(learning_rate=3e-4, parameters=model.named_parameters(),
                    weight_decay=0.01, multi_precision=True,
                    grad_clip=ClipGradByGlobalNorm(1.0))
        eng = ParallelEngine(model, optimizer=opt, injector=injector,
                             telemetry=telemetry)
        walls, snap, retried = [], None, 0
        for i in range(steps):
            t0 = time.perf_counter()
            try:
                loss = eng.train_batch(*batch).item()
            except StepFault:
                retried += 1
                loss = eng.train_batch(*batch).item()
            walls.append(time.perf_counter() - t0)
            check(loss == loss, "phase 30 (e): a non-finite loss")
            if i == 4:
                snap = [p.detach().clone() for p in model.parameters()]
        del eng, opt
        _free(torch)
        return walls, snap, retried

    walls_off, ref, _ = run()
    peak = BF16_FLOPS
    tel = TrainTelemetry(peak_flops=peak)
    inj = FaultInjector(FaultPlan([FaultSpec("train_step", at=at)]))
    walls_on, got, retried = run(inj, tel)
    equal = all(torch.equal(a, b) for a, b in zip(ref, got))
    del ref, got
    reg = tel.registry
    off_ms, on_ms = (_median(w[2:]) * 1e3 for w in (walls_off, walls_on))
    res = dict(card=card_line(), peak_flops=peak,
               ms_per_step_off=off_ms, ms_per_step_on=on_ms,
               fired=inj.fired, retried=retried,
               params_bit_equal_after_5=equal,
               goodput_ratio=tel.goodput.ratio(),
               mfu=reg.gauge("train_mfu").value(),
               mfu_formula="6 * N * T / step_s / peak_flops, N = every "
                           "parameter (embeddings included), T = B * S",
               tokens_per_s=reg.gauge("train_tokens_per_s").value(),
               model_params=tel.model_params,
               flight_steps=[r["step"] for r in tel.flight.dump()],
               recompiles=[r["recompiles"] for r in tel.flight.dump()],
               watchdog=tel.watchdog(), seconds=0.0)
    launches = ops.launch_counts()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "fused_adamw",
                 "rms_norm"):
        check(launches[name] > 0, f"phase 30 (e): {name} never launched")
    res["launches"] = launches
    del model
    _free(torch)
    res["seconds"] = time.perf_counter() - t_start
    log("phase 30 (e) engine: " + json.dumps(res))
    check(equal, "phase 30 (e): parameters after the retried step differ "
                 "from the fault-free run's")
    check(inj.fired == [("train_step", at)] and retried == 1,
          f"phase 30 (e): fired {inj.fired}, retried {retried}")
    check(res["goodput_ratio"] == 1.0, f"phase 30 (e): goodput {res}")
    check(res["flight_steps"] == list(range(steps)),
          f"phase 30 (e): flight {res['flight_steps']}")
    check(not res["watchdog"], f"phase 30 (e): findings {res['watchdog']}")
    return res



# --------------------------------------------------------------- phase 9
# the decode shapes (K, N) of Llama-3-8B's projections and lm-head
W8_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
             (4096, 128256))
# the phase-10 adapters: (name, rank, alpha) in a pool of max_rank 8
LORA_ADAPTERS = (("a1", 8, 16.0), ("a2", 8, 8.0), ("a3", 4, 8.0))
LORA_MAX_RANK, LORA_LIVE = 8, 2


def _el_ratio(x, ref, mag, K):
    """Per element |x - ref| against one bf16 step of ref (each side rounds
    once) plus the fp32 summation-order bound K * 2^-24 of the summed
    magnitudes ``mag``."""
    tol = 2.0 ** -7 * ref.float().abs() + K * 2.0 ** -24 * mag
    return (x.float() - ref.float()).abs() / tol


def kernel_w8(torch, ops):
    """w8_matmul against its plain twin at every decode shape, M in
    {1, 8, 16, 40, 128} (decode ticks, a verify window of 8 x 5 rows, a
    prefill chunk: every one streams, ``int8.streams_int8``), with the
    tolerance shown to reject a lost K slice; each launch repeated 3
    times bit for bit, the wrapper's host us a call beside its device
    time. At 40 and 128 rows the dequantize-once path those rows took
    before is measured beside it."""
    from paddle_tpu_torch.ops import int8 as i8
    from paddle_tpu_torch.ops.int8_cuda import plan, w8_matmul_cuda

    g = torch.Generator(device="cuda").manual_seed(21)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    cases = []
    for K, N in ((4096, 14336),) + tuple(sh for sh in W8_SHAPES
                                        if sh != (4096, 14336)):
        w = (0.02 * torch.randn(K, N, generator=g, device="cuda")).to(
            torch.bfloat16)
        wq, sc = i8.quantize_per_channel(w)
        # the prefill path's one-pass dequantize is the reference's
        # (w_q * scale in fp32, rounded to bf16) bit for bit
        check(torch.equal(i8.dequantize(wq, sc, torch.bfloat16),
                          (wq.float() * sc).to(torch.bfloat16)),
              f"dequantize {K}x{N}: not the fp32 product rounded to bf16")
        for M in (8, 1, 16, 40, 128):
            x = torch.randn(M, K, generator=g, device="cuda").to(
                torch.bfloat16)
            out = w8_matmul_cuda(x, wq, sc)
            ref = i8._w8_plain(x, wq, sc)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out.float()).all()),
                  f"w8_matmul {M}x{K}x{N}: non-finite")
            mag = (x.float().abs() @ wq.float().abs()) * sc
            worst = _el_ratio(out, ref, mag, K).max().item()
            check(worst <= 1.0, f"w8_matmul {M}x{K}x{N}: an element is off "
                                f"by {worst:.3g} x its tolerance")
            # planted fault: the plain twin without the last 128 rows of K
            # (a K slice lost)
            lost = i8._w8_plain(x[:, :-128], wq[:-128], sc)
            fault = _el_ratio(lost, ref, mag, K).max().item()
            check(fault > 1.0, f"w8_matmul {M}x{K}x{N}: the tolerance "
                               f"passes a lost K slice ({fault:.3g})")
            check(_repeats(torch, lambda: w8_matmul_cuda(x, wq, sc), out),
                  f"w8_matmul {M}x{K}x{N}: a repeated launch differs")
            b, by = bound_ms(K * N + 4 * N + 2 * M * K + 2 * M * N,
                             2 * M * K * N, BF16_FLOPS)
            case = dict(M=M, K=K, N=N, plan=plan(M, K, N),
                        max_abs_err=(out.float() - ref.float()).abs()
                        .max().item(),
                        worst_err_over_tol=worst, lost_slice_fault=fault,
                        bitwise_repeatable=True,
                        ms=time_ms(lambda: w8_matmul_cuda(x, wq, sc), 50,
                                   flush),
                        host_us=host_us(torch,
                                        lambda: w8_matmul_cuda(x, wq, sc)),
                        plain_ms=time_ms(lambda: i8._w8_plain(x, wq, sc), 5,
                                         flush),
                        bound_ms=b, bound_by=by,
                        library_ms=time_ms(lambda: torch.matmul(x, w), 50,
                                           flush))
            if M >= 40:
                # measurement only: the path these rows took before they
                # streamed
                case["dequant_ms"] = time_ms(
                    lambda: i8._w8_dequant(x, wq, sc), 20, flush)
            log(f"kernel w8_matmul M={M} {K}x{N}: " + json.dumps(case))
            cases.append(case)
        del w, wq, sc, x, out, ref, mag, lost
        torch.cuda.empty_cache()
    return cases


def kernel_paged_attention_int8(torch, ops, pa, cfg):
    """The int8-pool attention kernel against its plain twin at phase 3's
    cases and faults (and the wrong block's scales)."""
    return _paged_kernel_cases(torch, ops, pa, cfg, quant=True, seed=23)


def kernel_fused_lora(torch, ops, cfg):
    """The fused LoRA kernel against its plain twin per target shape, at a
    decode batch (8 rows: adapters of ranks 8, 8 and 4 in max_rank 8 and
    null rows, which must equal the same kernel's output with every s = 0
    bitwise) and a prefill chunk (1 x 128 rows); the tolerance is shown to
    reject the delta of the wrong adapter page; each launch repeated 3
    times bit for bit, the wrapper's host us a call beside its device
    time."""
    from paddle_tpu_torch.inference.lora import target_dims
    from paddle_tpu_torch.nn import lora as tl
    from paddle_tpu_torch.ops.fused_lora_cuda import fused_lora_matmul_cuda
    from paddle_tpu_torch.ops.int8_cuda import plan

    g = torch.Generator(device="cuda").manual_seed(25)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    R, L, layer = LORA_MAX_RANK, 2, 1
    ranks = [r for _, r, _ in LORA_ADAPTERS]
    scales = [a / r for _, r, a in LORA_ADAPTERS]
    cases = []
    dims = target_dims(cfg)
    order = ["gate", "q", "k", "v", "o", "up", "down"]
    for form, E, S, aidx in (("decode", MAX_BATCH, 1,
                              [1, 2, 3, 0, 1, 0, 3, 2]),
                             ("prefill", 1, PREFILL_CHUNK, [1])):
        for t in order:
            K, N = dims[t]
            w = (0.02 * torch.randn(K, N, generator=g, device="cuda")).to(
                torch.bfloat16)
            x = torch.randn(E, S, K, generator=g, device="cuda").to(
                torch.bfloat16)
            A = torch.zeros(len(ranks) + 1, L, K, R, device="cuda")
            Bf = torch.zeros(len(ranks) + 1, L, R, N, device="cuda")
            for p, r in enumerate(ranks, start=1):
                A[p, :, :, :r] = 0.02 * torch.randn(L, K, r, generator=g,
                                                    device="cuda")
                Bf[p, :, :r] = 0.02 * torch.randn(L, r, N, generator=g,
                                                  device="cuda")
            s = torch.tensor([0.0] + scales, device="cuda")
            ai = torch.tensor(aidx, dtype=torch.int32, device="cuda")
            pooled = tl.PooledFactors(A, Bf, s, layer, ai)
            out = fused_lora_matmul_cuda(x, w, A, Bf, s, layer, ai)
            ref = tl._lora_plain(x, w, *pooled.gather())
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out.float()).all()),
                  f"fused_lora {form} {t}: non-finite")
            Ag, Bg, sg = pooled.gather()
            xa = torch.bmm(x.float(), Ag).abs()
            mag = (x.float().abs() @ w.float().abs()
                   + torch.bmm(xa, Bg.abs()) * sg[:, None, None])
            worst = _el_ratio(out, ref, mag, K).max().item()
            check(worst <= 1.0, f"fused_lora {form} {t}: an element is off "
                                f"by {worst:.3g} x its tolerance")
            # planted fault: every entry reads the next entry's page
            wrong = tl._lora_plain(x, w, *tl.PooledFactors(
                A, Bf, s, layer, torch.roll(ai, 1) if E > 1 else ai + 1)
                .gather())
            fault = _el_ratio(wrong, ref, mag, K).max().item()
            check(fault > 1.0, f"fused_lora {form} {t}: the tolerance passes "
                               f"the wrong page ({fault:.3g})")
            check(_repeats(torch, lambda: fused_lora_matmul_cuda(
                x, w, A, Bf, s, layer, ai), out),
                  f"fused_lora {form} {t}: a repeated launch differs")
            null = [e for e, p in enumerate(aidx) if p == 0]
            if null:
                zero = fused_lora_matmul_cuda(x, w, A, Bf, torch.zeros_like(s),
                                              layer, ai)
                check(torch.equal(out[null], zero[null]),
                      f"fused_lora {form} {t}: null rows differ from the "
                      f"kernel's output with s = 0")
            used = sorted(set(aidx) - {0})
            nbytes = (2 * x.numel() + 2 * K * N + 2 * E * S * N
                      + len(used) * (K * R + R * N) * 4 + 4 * E)
            flops = 2 * E * S * K * N + 2 * E * S * R * (K + N)
            b, by = bound_ms(nbytes, flops, BF16_FLOPS)

            def plain():
                tl._lora_plain(x, w, *pooled.gather())

            def library():
                torch.matmul(x, w)
                tl.bgmv(x, pooled)

            case = dict(form=form, target=t, rows=E * S, K=K, N=N, rank=R,
                        pages=aidx,
                        max_abs_err=(out.float() - ref.float()).abs()
                        .max().item(),
                        worst_err_over_tol=worst, wrong_page_fault=fault,
                        bitwise_repeatable=True, plan=plan(E * S, K, N),
                        ms=time_ms(lambda: fused_lora_matmul_cuda(
                            x, w, A, Bf, s, layer, ai), 50, flush),
                        host_us=host_us(torch, lambda: fused_lora_matmul_cuda(
                            x, w, A, Bf, s, layer, ai)),
                        plain_ms=time_ms(plain, 5, flush),
                        bound_ms=b, bound_by=by,
                        library_ms=time_ms(library, 20, flush))
            log(f"kernel fused_lora {form} {t}: " + json.dumps(case))
            cases.append(case)
            del w, x, A, Bf, out, ref, mag, wrong, xa
        torch.cuda.empty_cache()
    return cases


# --------------------------------------------------------------- phase 10
def lora_registry(cfg):
    """The three adapters of phase 10, every target of every layer, factors
    made from a seed with numpy (the registry's host tier)."""
    import numpy as np

    from paddle_tpu_torch.inference.lora import (LORA_TARGETS,
                                                 AdapterRegistry,
                                                 target_dims)

    reg = AdapterRegistry()
    dims = target_dims(cfg)
    for i, (name, rank, alpha) in enumerate(LORA_ADAPTERS):
        rng = np.random.default_rng(100 + i)
        w = {}
        for layer in range(cfg.num_hidden_layers):
            for t in LORA_TARGETS:
                fi, fo = dims[t]
                w[(layer, t)] = (
                    rng.standard_normal((fi, rank), np.float32) * 0.02,
                    rng.standard_normal((rank, fo), np.float32) * 0.02)
        reg.register(name, w, rank=rank, alpha=alpha)
    return reg


def serve_lora(torch, ops, model, megakernel=False, graphs=True):
    """Phase 4's traffic behind ``lora=LoRAConfig(registry, max_live_adapters
    =2, max_rank=8)``: 8 requests on three adapters, 4 without; then one
    prompt of 2+ blocks under a1, then a2, then a2 again. ``megakernel``
    (phase 17): behind ``kernels="megakernel"``, where every decode tick
    launches decode_tick once and neither the fused LoRA kernel nor the
    per-layer attention, and every prefill chunk launches both as the
    per-layer path does. ``graphs`` as in :func:`serve`."""
    from paddle_tpu_torch.inference.lora import LoRAConfig

    cfg = model.cfg
    L = cfg.num_hidden_layers
    t0 = time.perf_counter()
    reg = lora_registry(cfg)
    log(f"lora: {len(reg)} adapters registered in "
        f"{time.perf_counter() - t0:.1f} s")
    adapters = ["a1", "a2", None, "a3", "a1", None, "a2", "a3", None, "a1",
                None, "a2"]

    def expect(st):
        ticks, chunks = st["decode_ticks"], st["prefill_chunks"]
        if megakernel:
            return {"decode_tick": ticks, "fused_lora_matmul": 7 * L * chunks,
                    "paged_attention": L * chunks,
                    "rms_norm": ticks + (2 * L + 1) * chunks,
                    "stream_matmul": ticks}
        passes = ticks + chunks
        return {"fused_lora_matmul": 7 * L * passes,
                "paged_attention": L * passes,
                "rms_norm": (2 * L + 1) * passes,
                "stream_matmul": ticks}

    kw = {}
    if megakernel:
        kw = dict(kernels="megakernel", expect_per_pass={
            "decode_paged": {"decode_tick": 1, "fused_lora_matmul": 0,
                             "paged_attention": 0},
            "chunk_prefill": {"decode_tick": 0, "fused_lora_matmul": 7 * L}})
    label = ("serve llama3-8b paged lora"
             + (" megakernel" if megakernel else "")
             + _cell_suffix(graphs))
    try:
        res, prompt, srv = serve(
            torch, ops, model, label=label, adapters=adapters, expect=expect,
            graphs=graphs,
            lora=LoRAConfig(reg, max_live_adapters=LORA_LIVE,
                            max_rank=LORA_MAX_RANK), **kw)
        check(srv._exec.megakernel == megakernel,
              f"{label}: the server's megakernel flag")
    finally:
        ops.set_kernel_mode("auto")
    check(res["adapters"]["adapter_evictions"] >= 1,
          f"phase 10: no adapter upload followed an eviction "
          f"({res['adapters']})")
    # one new prompt of 3 full blocks (+5 tokens), in turn under a1, a2 and
    # a2 again: the prefix cache keys blocks by adapter, so only the third
    # hits
    shared = prompt[::-1][:3 * BLOCK_SIZE + 5]
    hits = []
    for name in ("a1", "a2", "a2"):
        before = srv.kv_stats()["prefix_hit_blocks"]
        rid = srv.submit(shared, max_new_tokens=8, adapter=name)
        check(len(srv.run()[rid]) == len(shared) + 8, "shared prompt length")
        hits.append(srv.kv_stats()["prefix_hit_blocks"] - before)
    res["shared_prompt_prefix_hits"] = hits
    check(hits == [0, 0, 3], f"phase 10: prefix hits per turn {hits}, want "
                             f"[0, 0, 3] (blocks keyed by adapter)")
    log("serve lora shared prompt: " + json.dumps({"prefix_hits": hits}))
    return res, prompt, srv


# --------------------------------------------------------------- phase 11
def serve_int8(torch, ops, model, graphs=True):
    """``quantize_int8()`` in place (once), then phase 4's traffic with
    ``kv_quant="int8"``: every decode tick and every prefill chunk (128
    rows) streams the 7 x 32 projections and the lm-head through
    w8_matmul, and reads the int8 pool through the int8 attention kernel.
    ``graphs`` as in :func:`serve`."""
    cfg = model.cfg
    L = cfg.num_hidden_layers
    if not model.quantized:
        t0 = time.perf_counter()
        model.quantize_int8()
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        log(f"int8: quantized in {time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the card")

    def expect(st):
        passes = st["decode_ticks"] + st["prefill_chunks"]
        return {"w8_matmul": (7 * L + 1) * passes, "stream_matmul": 0,
                "paged_attention_int8": L * passes, "paged_attention": 0,
                "rms_norm": (2 * L + 1) * passes}

    res, prompt, _ = serve(torch, ops, model,
                           label="serve llama3-8b paged int8"
                           + _cell_suffix(graphs),
                           expect=expect, kv_quant="int8", graphs=graphs)
    return res, prompt


# -------------------------------------------------------------- phase 31
# the dense server's prompt buckets (phase 4's prompts run 100-1000 tokens)
DENSE_BUCKETS = (128, 256, 512, 1024)
# (b): four of phase 4's prompts, each alone, and two of them in a beam
# search
DENSE_GEN_LENS = (100, 256, 517, 1000)
DENSE_GEN_NEW = 32
DENSE_BEAM_LENS = (100, 517)
DENSE_BEAMS = 4
# the prompts whose every position measures the bf16 logits' distance from
# the fp32 copy's (the near-tie bound)
DENSE_TIE_LENS = (517, 1000)
# (c): GPT-2 small, bf16
GPT_B, GPT_P, GPT_NEW, GPT_BEAMS = 4, 256, 64, 4
# the executor's dense passes, each with the keyword that counts its units
DENSE_PASSES = (("decode_dense", "ticks"), ("prefill_dense", None))


def serve_dense(torch, ops, model, label="serve llama3-8b dense",
                graphs=True, tick_window=1, fault=False):
    """Phase 31 (a): phase 4's traffic through ``GenerationServer(cache=
    "dense", max_batch=8, max_len=2048, prompt_buckets=DENSE_BUCKETS)``
    after a warm-up request in every bucket (the graphs' captures). Checks
    every request's length and ids, the launches of every pass (a prefill:
    flash forward once a layer, RMSNorm 2L + 1; a tick: RMSNorm 2L + 1 and
    the 7L + 1 decode products, ``stream_matmul`` or, on an int8 model,
    ``w8_matmul``; no paged attention), and, with ``graphs``, that every
    prefill and decode window of the run was a replay of a graph captured
    before it. ``fault``: the planted fault of the near-tie rule, each
    bucket's logits read at ``true_len`` (the first padding position)
    instead of ``true_len - 1``. Returns (readings with every request's
    "tokens", the server)."""
    from paddle_tpu_torch.inference.serving import GenerationServer

    gc.collect()
    torch.cuda.empty_cache()
    cfg = model.cfg
    L = cfg.num_hidden_layers
    int8 = model.quantized
    srv = GenerationServer(model, max_batch=MAX_BATCH, max_len=MAX_LEN,
                           prompt_buckets=DENSE_BUCKETS,
                           tick_window=tick_window)
    ex = srv._exec
    check(srv.cache_mode == "dense" and ex.graphs,
          f"{label}: not a dense server graphing its passes")
    ex.graphs = graphs
    if fault:
        right = ex.prefill_dense

        def read_at_true_len(bucket, prompt, true_len, slot):
            return right(bucket, prompt,
                         torch.clamp(true_len + 1, max=bucket), slot)
        ex.prefill_dense = read_at_true_len
    per_pass = []
    for kind, unit in DENSE_PASSES:
        def counted(*a, _fn=getattr(ex, kind), _kind=kind, _unit=unit, **k):
            before = ops.launch_counts()
            out = _fn(*a, **k)
            per_pass.append((_kind, k.get(_unit, 1) if _unit else 1,
                             {n: c - before[n] for n, c in
                              ops.launch_counts().items()}))
            return out
        setattr(ex, kind, counted)
    for b in DENSE_BUCKETS:                 # warm-up: every graph captured
        srv.submit(list(range(1, b)), max_new_tokens=2 * tick_window)
    srv.run()
    prompts, news = phase4_traffic(cfg)
    t_before = srv.throughput_stats()
    replays_before, captures_before = dict(ex.replays), ex.captures
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    per_pass.clear()
    t0 = time.perf_counter()
    rids = [srv.submit(p, max_new_tokens=m) for p, m in zip(prompts, news)]
    out = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    t_after = srv.throughput_stats()
    st = {k: t_after[k] - t_before[k] for k in t_after}
    replays = {k: n - replays_before[k] for k, n in ex.replays.items()}
    for rid, p, m in zip(rids, prompts, news):
        check(rid in out, f"{label}: request {rid} did not finish")
        toks = out[rid]
        check(toks[:len(p)] == p and len(toks) == len(p) + m,
              f"{label}: request {rid}: {len(toks)} tokens, want "
              f"{len(p) + m}")
        check(all(0 <= t < cfg.vocab_size for t in toks[len(p):]),
              f"{label}: request {rid}: token id out of range")
    prefills, ticks = st["prefill_chunks"], st["decode_ticks"]
    product = "w8_matmul" if int8 else "stream_matmul"
    check(prefills == len(rids), f"{label}: {prefills} prefills")
    want = {"rms_norm": (2 * L + 1) * (prefills + ticks),
            "flash_fwd": L * prefills, "paged_attention": 0,
            "decode_tick": 0, "stream_matmul": 0 if int8 else
            (7 * L + 1) * ticks}
    for name, n in want.items():
        check(launches[name] == n, f"{label}: {name} launches "
                                   f"{launches[name]} != {n} ({prefills} "
                                   f"prefills, {ticks} ticks)")
    for kind, units, got in per_pass:
        one = ({"rms_norm": 2 * L + 1, "flash_fwd": L}
               if kind == "prefill_dense" else
               {"rms_norm": 2 * L + 1, product: 7 * L + 1, "flash_fwd": 0})
        for name, n in one.items():
            check(got[name] == n * units,
                  f"{label}: a {kind} pass of {units} units launched "
                  f"{name} {got[name]} times, want {n * units}")
    want_replays = ({"decode": st["decode_trips"], "prefill": prefills}
                    if graphs else {"decode": 0, "prefill": 0})
    check(replays == want_replays and ex.captures == captures_before,
          f"{label}: graph replays {replays}, want {want_replays}; "
          f"{ex.captures - captures_before} captures during the run")
    res = dict(requests=len(rids), wall_s=wall, graphs=graphs,
               tick_window=srv.tick_window, graph_replays=replays,
               graph_captures=ex.captures,
               pass_launches=_pass_signatures(per_pass),
               prefill_tokens=st["prefill_tokens"], prefills=prefills,
               prefill_tok_s=st["prefill_tokens"] / st["prefill_s"],
               decode_trips=st["decode_trips"], decode_ticks=ticks,
               decode_tokens=st["decode_tokens"],
               decode_tok_s=st["decode_tokens"] / st["decode_s"],
               ms_per_decode_tick=st["decode_s"] / ticks * 1e3,
               slab_gib=sum(t.numel() * t.element_size()
                            for t in ex.slab) / 2 ** 30,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=launches)
    log(f"{label}: " + json.dumps(res))
    res["tokens"] = [out[rid] for rid in rids]
    for kind, _ in DENSE_PASSES:
        delattr(ex, kind)
    return res, srv


def dense_breakdown(torch, srv):
    """Host against device time of one dense decode window (every slot at
    512 tokens of context; attention reads the whole 2048-row slab, masked)
    and one 512-bucket prefill (into slot 0) through the server's
    executor, as :func:`pass_breakdown` reads the paged ones. Run after the
    served requests have finished."""
    import statistics

    ex = srv._exec
    B = srv.max_batch
    n = DENSE_BUCKETS[2]
    i32 = dict(dtype=torch.int32, device="cuda")
    pos = torch.full((B,), n, **i32)
    ones = torch.ones(B, **i32)
    prompt = torch.ones(1, n, **i32)
    true_len = torch.tensor([n], dtype=torch.long, device="cuda")
    slot = torch.zeros(1, dtype=torch.long, device="cuda")

    def tick():
        return ex.decode_dense(ones, pos, None, None, None, ones, None,
                               greedy=True, ticks=srv.tick_window)

    def prefill():
        return ex.prefill_dense(n, prompt, true_len, slot)

    res = {}
    for name, fn in (("decode_window", tick), (f"prefill_{n}", prefill)):
        fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(7):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = statistics.median(walls) * 1e3
        device = (_replayed_ms(torch, fn) if ex.graphs
                  else time_ms(fn, iters=3))
        _, _, classes, _ = _device_busy(torch, fn, 3)
        res[name] = dict(wall_ms=wall, device_ms=device,
                         device_idle_share=max(0.0, 1.0 - device / wall),
                         device_ms_by_class={
                             c: t / 3 * 1e3 for c, t in sorted(
                                 classes.items(), key=lambda kv: -kv[1])})
    log("dense pass breakdown (host vs device): " + json.dumps(res))
    return res


def _logit_error(torch, ops, fwd16, fwd32, prompts):
    """The largest |kernels' bf16 - plain fp32| logit difference over every
    position of ``prompts`` (each a full forward: ``fwd16`` with the
    kernels, ``fwd32`` with the plain versions on the fp32 copy; each
    returns (S, vocab) logits)."""
    err = 0.0
    for p in prompts:
        ids = torch.tensor([p], device="cuda")
        with torch.no_grad():
            lg16 = fwd16(ids).float()
            ops.set_kernel_mode("reference")
            try:
                lg32 = fwd32(ids).float()
            finally:
                ops.set_kernel_mode("auto")
        err = max(err, (lg16 - lg32).abs().max().item())
        del lg16, lg32
    return err


def _seq_logprob(torch, ops, fwd, seq, P):
    """log p(seq[P:] | seq[:P]) in fp32 from one forward of ``fwd`` (ids ->
    (1, S, vocab) logits) over ``seq[:-1]``, with the plain versions."""
    ids = torch.tensor([seq[:-1]], device="cuda")
    ops.set_kernel_mode("reference")
    try:
        with torch.no_grad():
            lp = torch.log_softmax(fwd(ids)[0, P - 1:].float(), dim=-1)
    finally:
        ops.set_kernel_mode("auto")
    tgt = torch.tensor(seq[P:], device="cuda")
    return lp.gather(1, tgt[:, None]).sum().item()


def beam_ties(torch, ops, fwd32, got, want, P, tie):
    """The near-tie rule of a beam search, which picks by a hypothesis's
    summed log-probability, not one step's logits, and is not continuous
    in them (a near tie at a pruning step drops a hypothesis for good):
    for each row whose beams ``got`` (the kernels' search) and ``want``
    (the yardstick's) differ, the fp32 copy's log-probability of ``want``
    (``fwd32``: ids -> logits with the plain versions) may exceed
    ``got``'s by at most ``tie`` (two bf16 logits' largest gap, the bound
    of one step's log-probability error) a generated token. Returns (rows
    identical, [per differing row: first difference, score gap, bound],
    all within)."""
    same, rows, ok = 0, [], True
    for a, b in zip(got, want):
        if a == b:
            same += 1
            continue
        gap = (_seq_logprob(torch, ops, fwd32, b, P)
               - _seq_logprob(torch, ops, fwd32, a, P))
        bound = tie * (len(a) - P)
        rows.append(dict(position=_first_difference(a, b), score_gap=gap,
                         bound=bound))
        ok = ok and gap <= bound
    return same, rows, ok


def _gen_program(model):
    """The generate program made last (the newest key)."""
    return list(model._gen_cache.values())[-1]


def dense_generate(torch, ops, model, prompts, dense_tokens, m32, tie):
    """Phase 31 (b): ``LlamaForCausalLM.generate`` on the card, each of
    four of phase 4's prompts alone, 32 greedy tokens: launches (a prefill
    and 31 decode steps), one capture a body per key then one replay a
    step (a second call replays only, the same bits), graphed bit-equal to
    eager, and the tokens against the dense server's within the near-tie
    rule; then ``num_beams=4`` on two prompts: lengths, launches, and the
    beams against the same search in reference mode (equal, or within the
    beam rule, :func:`beam_ties`)."""
    cfg = model.cfg
    L = cfg.num_hidden_layers
    N = DENSE_GEN_NEW
    model.__dict__.pop("_gen_cache", None)
    got, want, runs = [], [], []
    for n in DENSE_GEN_LENS:
        i = PHASE4_LENS.index(n)
        p = prompts[i]
        ids = torch.tensor([p], device="cuda")
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.generate(ids, max_new_tokens=N)[0].tolist()
        first_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        prog = _gen_program(model)
        t0 = time.perf_counter()
        again = model.generate(ids, max_new_tokens=N)[0].tolist()
        wall = time.perf_counter() - t0
        check(len(out) == n + N and out[:n] == p,
              f"generate P={n}: {len(out)} tokens")
        check(again == out, f"generate P={n}: a second call differs")
        want_l = {"flash_fwd": L, "rms_norm": (2 * L + 1) * N,
                  "stream_matmul": (7 * L + 1) * (N - 1),
                  "paged_attention": 0}
        for name, k in want_l.items():
            check(launches[name] == k, f"generate P={n}: {name} launches "
                                       f"{launches[name]} != {k}")
        check(prog.captures == 2 and prog.replays == 2 * N,
              f"generate P={n}: {prog.captures} captures, {prog.replays} "
              f"replays (want 2 and {2 * N})")
        runs.append(dict(prompt=n, first_call_s=first_s, wall_s=wall,
                         tok_s=N / wall, captures=prog.captures,
                         replays=prog.replays))
        got.append(out)
        want.append(dense_tokens[i][:n + N])
    model.gen_graphs = False
    try:
        eager = model.generate(torch.tensor([got[0][:DENSE_GEN_LENS[0]]],
                                            device="cuda"),
                               max_new_tokens=N)[0].tolist()
    finally:
        del model.gen_graphs
    check(eager == got[0], "generate: graphed tokens differ from eager")
    same, rows, ok = near_ties(torch, ops, m32, got, want, tie)
    check(ok, f"phase 31 (b): generate against the dense server outside "
              f"the near-tie bound {tie}: {rows}")
    beams = []
    for n in DENSE_BEAM_LENS:
        p = prompts[PHASE4_LENS.index(n)]
        ids = torch.tensor([p], device="cuda")
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = model.generate(ids, max_new_tokens=N,
                             num_beams=DENSE_BEAMS)[0].tolist()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        check(len(out) == n + N and out[:n] == p,
              f"beam P={n}: {len(out)} tokens")
        check(launches["flash_fwd"] == L and launches["stream_matmul"]
              == (7 * L + 1) * (N - 1),
              f"beam P={n}: launches {launches}")
        ops.set_kernel_mode("reference")
        try:
            ref = model.generate(ids, max_new_tokens=N,
                                 num_beams=DENSE_BEAMS)[0].tolist()
        finally:
            ops.set_kernel_mode("auto")
        b_same, b_rows, b_ok = beam_ties(
            torch, ops, lambda x: m32.head(m32.model(x)), [out], [ref], n,
            tie)
        check(b_ok, f"beam P={n}: against reference mode outside the "
                    f"beam near-tie bound: {b_rows}")
        beams.append(dict(prompt=n, wall_s=wall, identical=b_same,
                          differing=b_rows))
    model.__dict__.pop("_gen_cache", None)
    res = dict(runs=runs, requests_identical_to_dense=same,
               requests=len(got), differing=rows, beams=beams)
    log("phase 31 (b) generate: " + json.dumps(res))
    return res


def dense_generation(torch, ops, model, paged_tokens):
    """Phase 31 (a)-(b), the bf16 Llama-3-8B on the card (see
    :func:`serve_dense`, :func:`dense_generate`); ``paged_tokens``: phase
    4's tokens of the same traffic."""
    import dataclasses as dc

    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    cfg = model.cfg
    a, srv = serve_dense(torch, ops, model)
    a["breakdown"] = dense_breakdown(torch, srv)
    del srv
    eager, srv = serve_dense(torch, ops, model,
                             label="serve llama3-8b dense (eager)",
                             graphs=False)
    del srv
    w4, srv = serve_dense(torch, ops, model, tick_window=WINDOW,
                          label=f"serve llama3-8b dense W={WINDOW}")
    del srv
    faulty, srv = serve_dense(torch, ops, model, fault=True,
                              label="phase 31 planted fault: logits read "
                                    "at true_len")
    del srv
    n = len(a["tokens"])
    for name, other in (("eager", eager), (f"W={WINDOW}", w4)):
        same = sum(x == y for x, y in zip(a["tokens"], other["tokens"]))
        check(same == n, f"phase 31 (a): dense {name}: {same} of {n} "
                         f"requests equal the graphed W=1 run's")
    check(eager["launches"] == a["launches"],
          "phase 31 (a): launches differ with graphs on and off")
    # the near-tie rule against phase 26's fp32 copy of the weights
    torch.backends.cuda.matmul.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    m32 = LlamaForCausalLM(dc.replace(cfg, dtype="float32"), device="cuda")
    with torch.no_grad():
        for p32, p16 in zip(m32.parameters(), model.parameters()):
            p32.copy_(p16)
    prompts, _ = phase4_traffic(cfg)
    err = _logit_error(
        torch, ops, lambda ids: model.head(model.model(ids))[0],
        lambda ids: m32.head(m32.model(ids))[0],
        [prompts[PHASE4_LENS.index(k)] for k in DENSE_TIE_LENS])
    tie = 2 * err
    ties = {"kernels_vs_fp32_max": err, "near_tie_bound": tie}
    for name, got in (("dense vs paged", a["tokens"]),
                      ("planted fault vs paged", faulty["tokens"])):
        same, rows, ok = near_ties(torch, ops, m32, got, paged_tokens, tie)
        ties[name] = dict(requests_identical=same, requests=n,
                          differing=rows, near_ties_within_bound=ok)
        if name.startswith("planted"):
            check(not ok, "phase 31: the planted fault's tokens lie within "
                          "the near-tie bound")
        else:
            check(ok, f"phase 31 (a): dense against paged outside the "
                      f"near-tie bound {tie}: {rows}")
    log("phase 31 (a) near ties: " + json.dumps(ties))
    b = dense_generate(torch, ops, model, prompts, a["tokens"], m32, tie)
    del m32
    gc.collect()
    torch.cuda.empty_cache()
    for r in (a, eager, w4, faulty):
        r.pop("tokens")
    return dict(dense=a, eager=eager, window=w4, ties=ties, generate=b,
                launches=a["launches"])


def dense_int8(torch, ops, model):
    """Phase 31 (b), int8 weights (the model after phase 11's
    ``quantize_int8``): the dense server's traffic (``w8_matmul`` the 7L +
    1 decode products of every tick, no ``stream_matmul``) and ``generate``
    on two of its prompts (one capture a body, one replay a step;
    ``w8_matmul`` counted); tokens of the two paths compared (a count: no
    fp32 copy holds these codes)."""
    check(model.quantized, "phase 31 int8: the model is not quantized")
    L = model.cfg.num_hidden_layers
    N = DENSE_GEN_NEW
    srv_res, srv = serve_dense(torch, ops, model,
                               label="serve llama3-8b dense int8")
    del srv
    prompts, _ = phase4_traffic(model.cfg)
    model.__dict__.pop("_gen_cache", None)
    same = 0
    runs = []
    for n in DENSE_BEAM_LENS:
        i = PHASE4_LENS.index(n)
        ids = torch.tensor([prompts[i]], device="cuda")
        ops.reset_launch_counts()
        out = model.generate(ids, max_new_tokens=N)[0].tolist()
        launches = ops.launch_counts()
        prog = _gen_program(model)
        check(len(out) == n + N, f"int8 generate P={n}: {len(out)} tokens")
        check(launches["stream_matmul"] == 0
              and launches["w8_matmul"] >= (7 * L + 1) * (N - 1),
              f"int8 generate P={n}: launches {launches}")
        check(prog.captures == 2 and prog.replays == N,
              f"int8 generate P={n}: {prog.captures} captures, "
              f"{prog.replays} replays")
        same += out == srv_res["tokens"][i][:n + N]
        runs.append(dict(prompt=n, w8_matmul=launches["w8_matmul"]))
    model.__dict__.pop("_gen_cache", None)
    srv_res.pop("tokens")
    res = dict(server=srv_res, generate=runs,
               generate_equal_to_server=same, requests=len(runs),
               launches=srv_res["launches"])
    log("phase 31 int8: " + json.dumps({k: v for k, v in res.items()
                                         if k != "server"}))
    return res


def gpt_generation(torch, ops):
    """Phase 31 (c): GPT-2 small (``gpt2_small_config``, bf16, random
    weights from a seed) on the card: ``generate`` at B = 4 x 256-token
    prompts + 64 greedy tokens and ``num_beams=4``: LayerNorm (row 8) 25
    launches a forward, the flash forward (row 1, D = 64) 12 a prefill, one
    capture a body then one replay a step, graphed bit-equal to eager;
    tokens against an fp32 copy in reference mode within the near-tie rule
    (2 x the largest bf16 - fp32 logit gap over the prompts), the beams
    against the same search on the fp32 copy within the beam rule
    (:func:`beam_ties`) and, reported, on the bf16 model in reference
    mode; a planted fault (the position embedding read one position on)
    breaks both rules."""
    import numpy as np

    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt2_small_config

    gc.collect()
    torch.cuda.empty_cache()
    cfg = gpt2_small_config(dtype="bfloat16")
    L, N = cfg.num_hidden_layers, GPT_NEW
    m = GPTForCausalLM(cfg, seed=3).eval()      # dropout off, as served
    rng = np.random.default_rng(31)
    ids = torch.tensor(rng.integers(0, cfg.vocab_size, (GPT_B, GPT_P)),
                       dtype=torch.int32, device="cuda")

    def run(**kw):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = m.generate(ids, max_new_tokens=N, **kw)
        torch.cuda.synchronize()
        return out.tolist(), time.perf_counter() - t0, ops.launch_counts()

    res = {}
    for name, kw in (("greedy", {}), ("beam", dict(num_beams=GPT_BEAMS))):
        out, first_s, launches = run(**kw)
        prog = _gen_program(m)
        again, wall, _ = run(**kw)
        check(all(len(r) == GPT_P + N for r in out), f"gpt {name}: lengths")
        check(again == out, f"gpt {name}: a second call differs")
        check(launches["layer_norm"] == (2 * L + 1) * N
              and launches["flash_fwd"] == L,
              f"gpt {name}: launches {launches}")
        bodies = 3 if kw else 2
        check(prog.captures == bodies
              and prog.replays == 2 * (bodies - 2 + N),
              f"gpt {name}: {prog.captures} captures, {prog.replays} "
              f"replays")
        m.gen_graphs = False
        try:
            eager, _, eager_launches = run(**kw)
        finally:
            del m.gen_graphs
        check(eager == out and eager_launches == launches,
              f"gpt {name}: graphed differs from eager")
        res[name] = dict(tokens=out, first_call_s=first_s, wall_s=wall,
                         tok_s=GPT_B * N / wall, launches={
                             k: v for k, v in launches.items() if v})
    # the fp32 copy in reference mode, and the near-tie rule
    torch.backends.cuda.matmul.allow_tf32 = False
    m32 = GPTForCausalLM(gpt2_small_config(), seed=3).eval()
    with torch.no_grad():
        for p32, p16 in zip(m32.parameters(), m.parameters()):
            p32.copy_(p16)
    err = _logit_error(torch, ops, lambda x: m(x)[0], lambda x: m32(x)[0],
                       ids.tolist())
    tie = 2 * err

    def fp32_last(x):
        return m32(x)[:, -1].float()[0]

    # the yardsticks, in reference mode: greedy and beams on the fp32 copy;
    # the beams on the bf16 model too (reported, as (b) checks them)
    ops.set_kernel_mode("reference")
    try:
        ref = {"greedy": m32.generate(ids, max_new_tokens=N).tolist(),
               "beam": m32.generate(ids, max_new_tokens=N,
                                    num_beams=GPT_BEAMS).tolist(),
               "beam bf16": m.generate(ids, max_new_tokens=N,
                                       num_beams=GPT_BEAMS).tolist()}
    finally:
        ops.set_kernel_mode("auto")

    def rule(name, got):
        if name == "greedy":
            return near_ties(torch, ops, None, got, ref[name], tie,
                             logits=fp32_last)
        return beam_ties(torch, ops, m32, got, ref[name], GPT_P, tie)

    ties = {"kernels_vs_fp32_max": err, "near_tie_bound": tie}
    got = {name: res[name].pop("tokens") for name in ("greedy", "beam")}
    got["beam bf16"] = got["beam"]
    for name in ("greedy", "beam", "beam bf16"):
        same, rows, ok = rule(name, got[name])
        ties[name] = dict(requests_identical=same, requests=GPT_B,
                          differing=rows, within_bound=ok)
        if name != "beam bf16":
            check(ok, f"gpt {name}: against its yardstick outside the "
                      f"near-tie rule (greedy bound {tie}): {rows}")
    # the planted fault: the position embedding read one position on
    right = m.transformer.decode_step

    def wpe_one_on(token, caches, pos):
        return right(token, caches, pos + 1)

    m.transformer.decode_step = wpe_one_on
    m.__dict__.pop("_gen_cache", None)
    try:
        faulty = {name: m.generate(ids, max_new_tokens=N, **kw).tolist()
                  for name, kw in (("greedy", {}),
                                   ("beam", dict(num_beams=GPT_BEAMS)))}
    finally:
        del m.transformer.decode_step
    for name in ("greedy", "beam"):
        same, rows, ok = rule(name, faulty[name])
        ties[f"planted fault {name}"] = dict(
            requests_identical=same, requests=GPT_B, differing=rows,
            within_bound=ok)
        check(not ok, f"gpt {name}: the planted fault's tokens lie within "
                      f"the rule")
    res["ties"] = ties
    res["launches"] = res["greedy"]["launches"]
    log("phase 31 (c) gpt-2 small: " + json.dumps(res))
    del m, m32
    gc.collect()
    torch.cuda.empty_cache()
    return res


def log_dense(res, paged):
    """Phase 31's readings, the dense cell beside phase 4's paged one."""
    keys = ("prefill_tok_s", "decode_tok_s", "ms_per_decode_tick",
            "decode_ticks", "peak_memory_gib")
    log("phase 31 (a) dense beside paged: " + json.dumps(
        {"dense": {k: res["dense"][k] for k in keys},
         "dense eager": {k: res["eager"][k] for k in keys},
         f"dense W={WINDOW}": {k: res["window"][k] for k in keys},
         "paged": {k: paged.get(k) for k in keys}}))
    log("phase 31 (a) dense pass breakdown: "
        + json.dumps(res["dense"]["breakdown"]))
    log("phase 31 (a) near ties: " + json.dumps(res["ties"]))
    log("phase 31 (b) generate: " + json.dumps(res["generate"]))
    log("phase 31 int8: " + json.dumps(res["int8"]))
    log("phase 31 (c) gpt-2 small: " + json.dumps(res["gpt"]))


# --------------------------------------------------------------- phase 6
def event_ms(torch, fn, iters: int, flush=None) -> float:
    """Device time per call from CUDA events around ``iters`` eager calls
    (after 2 warm-up calls): for work a CUDA graph cannot capture
    (torch.optim's step); includes whatever host time the calls leave the
    device idle. ``flush`` as in :func:`time_ms`."""
    def run(body):
        for _ in range(2):
            body()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            body()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    if flush is None:
        return run(fn)

    def flushed():
        flush.zero_()
        fn()

    return max(run(flushed) - run(flush.zero_), 0.0)


def sdpa_backward_ms(torch, q, k, v, do, iters: int, **mask) -> dict:
    """Device time of SDPA's backward, which computes dQ, dK and dV in one
    call: SDPA's forward + ``autograd.grad`` captured in a CUDA graph and
    timed through :func:`time_ms` (side-stream warm-up), less the
    graph-timed forward, so that no host gap counts. ``library_ms`` is the
    backward, ``library_fwd_bwd_ms`` both."""
    from torch.nn import functional as F

    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(qg, kg, vg, enable_gqa=True,
                                              **mask)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qg, kg, vg), do)

    fb = time_ms(fwd_bwd, iters)
    return dict(library_ms=fb - time_ms(fwd, iters), library_fwd_bwd_ms=fb)


def _repeatable(torch, fn, first) -> bool:
    """Whether launching ``fn`` again on the same inputs gives the bits of
    ``first`` (a tensor or a tuple of them): the backward kernels sum in a
    fixed order, with no atomics."""
    again = fn()
    pairs = zip(first, again) if isinstance(first, tuple) else [(first,
                                                                 again)]
    return all(torch.equal(a, b) for a, b in pairs)


def _row_ratio(x, ref, rms_scale):
    """Per output row: |x - ref| max over the row against one bf16 step of
    the row's largest value plus 2^-8 of ``rms_scale`` (the tolerance form
    of phase 3)."""
    tol = 2.0 ** -7 * ref.float().abs().amax(-1) + 2.0 ** -8 * rms_scale
    return (x.float() - ref.float()).abs().amax(-1) / tol


def _rms(t) -> float:
    return t.float().square().mean().sqrt().item()


@contextlib.contextmanager
def _mask_shifted(fa, d: int):
    """The plain flash versions with the causal mask moved ``d`` keys
    (query i sees key j iff j <= i + Sk - Sq + d): the fault the
    tolerances must reject, computed with the plain versions' own
    rounding so that only the mask differs."""
    orig = fa._visible
    fa._visible = lambda q0, q1, Sq, Sk, dev: orig(q0 + d, q1 + d, Sq, Sk,
                                                  dev)
    try:
        yield
    finally:
        fa._visible = orig


def _visible_pairs(Sq, Sk):
    """(query, key) pairs the bottom-right causal mask keeps."""
    offs = Sk - Sq
    return sum(min(max(i + offs + 1, 0), Sk) for i in range(Sq))


# the flash kernels' branches and tile edges that the training shapes do
# not reach, as (B, Sq, Sk, causal): no causal mask; ragged last tiles
# (S not a multiple of 64, and 129, 130 and 200 across the 128-row and
# 128-key blocks); Sq < Sk (bottom-right alignment), down to a single query
# row, where the forward's second warpgroup holds no row; Sq > Sk, where
# the first causal rows see no key (O = 0, zero gradients)
FLASH_EDGES = ((1, 1000, 1000, False), (1, 300, 1000, True),
               (1, 300, 1000, False), (1, 200, 130, True),
               (1, 200, 130, False), (2, 200, 200, True),
               (2, 130, 130, True), (1, 130, 130, False),
               (1, 1, 1000, True), (1, 129, 129, True))


def _flash_edges(torch, fa, fac, rnd, H, KV, D):
    """The forward, dQ and dK/dV kernels at FLASH_EDGES, H query and KV
    heads of head dim D, against the plain versions with phase 6's
    per-row tolerances (untimed), and the forward once more with a
    negative scale; each kernel, launched a second time, must give the
    same bits. (forward cases, [(name, case)])."""
    s = 1.0 / D ** 0.5
    fwd_cases, bwd_cases = [], []
    for B, Sq, Sk, causal in FLASH_EDGES:
        q, k, v = rnd(B, H, Sq, D), rnd(B, KV, Sk, D), rnd(B, KV, Sk, D)
        do = rnd(B, H, Sq, D)
        out, lse = fac.flash_fwd_cuda(q, k, v, causal, s)
        ref, rlse = fa._flash_fwd_plain(q, k, v, causal, s)
        delta = (do.float() * ref.float()).sum(-1)

        def dq_fn():
            return fac.flash_bwd_dq_cuda(q, k, v, do, rlse, delta, causal, s)

        def dkv_fn():
            return fac.flash_bwd_dkv_cuda(q, k, v, do, rlse, delta, causal,
                                          s)

        got = dict(o=out, dq=dq_fn())
        got["dk"], got["dv"] = dkv_fn()
        want = dict(zip(("dq", "dk", "dv"), fa._flash_bwd_plain(
            q, k, v, do, rlse, delta, causal, s)), o=ref)
        torch.cuda.synchronize()
        ratios = {n: _row_ratio(x, want[n], _rms(v) if n == "o"
                                else _rms(want[n])).max().item()
                  for n, x in got.items()}
        ratios["lse"] = _lse_ratio(lse, rlse, Sk).max().item()
        errs = {n: (x.float() - want[n].float()).abs().max().item()
                for n, x in got.items()}
        repeat = (_repeatable(torch, lambda: fac.flash_fwd_cuda(
            q, k, v, causal, s), (out, lse))
                  and _repeatable(torch, dq_fn, got["dq"])
                  and _repeatable(torch, dkv_fn, (got["dk"], got["dv"])))
        case = dict(B=B, H=H, KV=KV, D=D, Sq=Sq, Sk=Sk, causal=causal,
                    max_abs_errs=errs, worst_err_over_tol=ratios,
                    bitwise_repeatable=repeat)
        label = f"flash edge D={D} KV={KV} B={B} Sq={Sq} Sk={Sk} " \
                f"causal={causal}"
        log(f"kernel {label}: " + json.dumps(case))
        for n, w in ratios.items():
            check(bool(torch.isfinite(got.get(n, lse).float()).all()),
                  f"{label}: {n} non-finite")
            check(w <= 1.0, f"{label}: {n} off by {w:.3g} x its tolerance")
        check(repeat, f"{label}: a second launch gave other bits")
        fwd_cases.append(dict(case, max_abs_err=errs["o"]))
        for name, keys in (("flash_bwd_dq", ("dq",)),
                           ("flash_bwd_dkv", ("dk", "dv"))):
            bwd_cases.append((name, dict(case, max_abs_err=max(
                errs[n] for n in keys))))
    # a negative scale takes the forward's other softmax form (each score
    # scaled before the row max); forward only, same tolerances
    q, k, v = rnd(1, H, 200, D), rnd(1, KV, 200, D), rnd(1, KV, 200, D)
    out, lse = fac.flash_fwd_cuda(q, k, v, True, -s)
    ref, rlse = fa._flash_fwd_plain(q, k, v, True, -s)
    torch.cuda.synchronize()
    ratios = {"o": _row_ratio(out, ref, _rms(v)).max().item(),
              "lse": _lse_ratio(lse, rlse, 200).max().item()}
    repeat = _repeatable(torch, lambda: fac.flash_fwd_cuda(q, k, v, True, -s),
                         (out, lse))
    case = dict(B=1, H=H, KV=KV, D=D, Sq=200, Sk=200, causal=True, scale=-s,
                max_abs_err=(out.float() - ref.float()).abs().max().item(),
                worst_err_over_tol=ratios, bitwise_repeatable=repeat)
    label = f"flash edge D={D} KV={KV} negative scale"
    log(f"kernel {label}: " + json.dumps(case))
    check(bool(torch.isfinite(out.float()).all()), f"{label}: non-finite")
    for n, w in ratios.items():
        check(w <= 1.0, f"{label}: {n} off by {w:.3g} x its tolerance")
    check(repeat, f"{label}: a second launch gave other bits")
    fwd_cases.append(case)
    return fwd_cases, bwd_cases


def kernel_flash(torch, fa, fac, ops):
    """Flash forward at three shapes and the backward pair at S=2048,
    against the plain versions, with mutant-mask checks."""
    from torch.nn import functional as F

    H, KV, D = 32, 8, 128
    s = 1.0 / D ** 0.5
    g = torch.Generator(device="cuda").manual_seed(11)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(
            torch.bfloat16)

    fwd_cases, bwd_cases = [], []
    for B, Sq, Sk in ((TRAIN_B, TRAIN_S, TRAIN_S), (1, 8192, 8192),
                      (TRAIN_B, 384, TRAIN_S)):
        q, k, v = rnd(B, H, Sq, D), rnd(B, KV, Sk, D), rnd(B, KV, Sk, D)
        out, lse = fac.flash_fwd_cuda(q, k, v, True, s)
        ref, rlse = fa._flash_fwd_plain(q, k, v, True, s)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out.float()).all()),
              f"flash_fwd S={Sq}/{Sk}: non-finite output")
        check(_repeatable(torch, lambda: fac.flash_fwd_cuda(q, k, v, True, s),
                          (out, lse)),
              f"flash_fwd S={Sq}/{Sk}: a second launch gave other bits")
        rms_v = _rms(v)
        # one bf16 step of the row's largest value (each side rounds O to
        # bf16 once); p is rounded to bf16 against the running max in the
        # kernel and the final max in the plain version, a relative error
        # of at most 2^-8 per key that averages out over the keys: 2^-8 x
        # rms(V) bounds its sum even for a row with one key
        worst = _row_ratio(out, ref, rms_v).max().item()
        check(worst <= 1.0, f"flash_fwd S={Sq}/{Sk}: a row is off by "
                            f"{worst:.3g} x its tolerance")
        # LSE: both sum the same fp32 exponentials in other orders; Sk
        # terms bound the relative error of the sum by Sk * 2^-24
        lse_err = (lse - rlse).abs()
        lse_tol = Sk * 2.0 ** -24 + 2.0 ** -20 * rlse.abs()
        worst_lse = (lse_err / lse_tol).max().item()
        check(worst_lse <= 1.0, f"flash_fwd S={Sq}/{Sk}: LSE off by "
                                f"{worst_lse:.3g} x its tolerance")
        mutants = {}
        for d in (1, -1):
            with _mask_shifted(fa, d):
                r = _row_ratio(fa._flash_fwd_plain(q, k, v, True, s)[0], ref,
                               rms_v)
            mutants[f"mask{d:+d}"] = dict(
                worst_err_over_tol=r.max().item(),
                rows_failed=(r > 1.0).float().mean().item())
            check(r.max().item() > 1.0, f"flash_fwd S={Sq}/{Sk}: the "
                                        f"tolerance passes the mask{d:+d} "
                                        f"fault")
        pairs = _visible_pairs(Sq, Sk)
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * lse.numel()
        bnd, by = bound_ms(nbytes, 4 * D * B * H * pairs, BF16_FLOPS)
        if Sq == Sk:
            def lib():
                return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                      enable_gqa=True)
        else:   # SDPA's is_causal aligns top-left: pass the mask
            mask = torch.ones(Sq, Sk, dtype=torch.bool,
                              device="cuda").tril(Sk - Sq)

            def lib():
                return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                      enable_gqa=True)
        case = dict(B=B, H=H, KV=KV, D=D, Sq=Sq, Sk=Sk, causal=True,
                    max_abs_err=(out.float() - ref.float()).abs().max().item(),
                    worst_err_over_tol=worst,
                    lse_max_abs_err=lse_err.max().item(),
                    lse_worst_err_over_tol=worst_lse, mutants=mutants,
                    bitwise_repeatable=True,
                    ms=time_ms(lambda: fac.flash_fwd_cuda(q, k, v, True, s),
                               20),
                    plain_ms=time_ms(
                        lambda: fa._flash_fwd_plain(q, k, v, True, s), 2),
                    bound_ms=bnd, bound_by=by, library_ms=time_ms(lib, 20))
        log(f"kernel flash_fwd S={Sq}/{Sk} B={B} bf16: " + json.dumps(case))
        fwd_cases.append(case)
        if (Sq, Sk) != (TRAIN_S, TRAIN_S):
            continue
        do = rnd(B, H, Sq, D)
        delta = (do.float() * ref.float()).sum(-1)
        dq = fac.flash_bwd_dq_cuda(q, k, v, do, rlse, delta, True, s)
        dk, dv = fac.flash_bwd_dkv_cuda(q, k, v, do, rlse, delta, True, s)
        rdq, rdk, rdv = fa._flash_bwd_plain(q, k, v, do, rlse, delta, True, s)
        torch.cuda.synchronize()
        grads = {"dq": (dq, rdq), "dk": (dk, rdk), "dv": (dv, rdv)}
        # per output row: one bf16 step of the row's largest value (each
        # side rounds once) plus 2^-8 of the tensor's rms for dS and P,
        # rounded to bf16 from fp32 values that may differ in their last
        # bits, averaged over the keys (dQ) or query rows (dK, dV)
        ratios = {n: _row_ratio(x, r, _rms(r)).max().item()
                  for n, (x, r) in grads.items()}
        for n, w in ratios.items():
            check(bool(torch.isfinite(grads[n][0].float()).all()),
                  f"flash backward {n}: non-finite")
            check(w <= 1.0, f"flash backward {n}: a row is off by {w:.3g} x "
                            f"its tolerance")
        check(_repeatable(torch, lambda: fac.flash_bwd_dq_cuda(
            q, k, v, do, rlse, delta, True, s), dq)
              and _repeatable(torch, lambda: fac.flash_bwd_dkv_cuda(
                  q, k, v, do, rlse, delta, True, s), (dk, dv)),
              f"flash backward S={Sq}: a second launch gave other bits")
        # the mutant's whole plain pipeline: its own O, LSE and delta
        bmut = {}
        for d in (1, -1):
            with _mask_shifted(fa, d):
                mo, ml = fa._flash_fwd_plain(q, k, v, True, s)
                got = fa._flash_bwd_plain(q, k, v, do, ml,
                                          (do.float() * mo.float()).sum(-1),
                                          True, s)
            bmut[f"mask{d:+d}"] = {
                n: _row_ratio(x, grads[n][1], _rms(grads[n][1])).max().item()
                for n, x in zip(("dq", "dk", "dv"), got)}
            del mo, ml, got
            for n, w in bmut[f"mask{d:+d}"].items():
                check(w > 1.0, f"flash backward {n}: the tolerance passes "
                               f"the mask{d:+d} fault ({w:.3g} x tolerance)")
        lib = sdpa_backward_ms(torch, q, k, v, do, 10, is_causal=True)
        plain_bwd = time_ms(lambda: fa._flash_bwd_plain(
            q, k, v, do, rlse, delta, True, s), 2)
        io = 2 * (2 * q.numel() + k.numel() + v.numel()) + 8 * lse.numel()
        for name, products, outs, fn in (
                ("flash_bwd_dq", 3, dq.numel(),
                 lambda: fac.flash_bwd_dq_cuda(q, k, v, do, rlse, delta,
                                               True, s)),
                ("flash_bwd_dkv", 4, dk.numel() + dv.numel(),
                 lambda: fac.flash_bwd_dkv_cuda(q, k, v, do, rlse, delta,
                                                True, s))):
            bnd, by = bound_ms(io + 2 * outs, 2 * products * D * B * H * pairs,
                               BF16_FLOPS)
            errs = {n: (grads[n][0].float() - grads[n][1].float()).abs()
                    .max().item() for n in (("dq",) if name.endswith("dq")
                                            else ("dk", "dv"))}
            case = dict(B=B, H=H, KV=KV, D=D, S=Sq, causal=True,
                        max_abs_err=max(errs.values()), max_abs_errs=errs,
                        worst_err_over_tol={n: ratios[n] for n in errs},
                        mutants={d: {n: m[n] for n in errs}
                                 for d, m in bmut.items()},
                        bitwise_repeatable=True,
                        ms=time_ms(fn, 20), plain_ms=plain_bwd,
                        bound_ms=bnd, bound_by=by, **lib)
            log(f"kernel {name} S={Sq} B={B} bf16: " + json.dumps(case))
            bwd_cases.append((name, case))
        del do, dq, dk, dv, rdq, rdk, rdv, grads
    # the kernels' branches and tile edges the training path does not
    # take, at both GQA group sizes; same tolerances, not timed
    for group in (H // KV, 1):
        f, b = _flash_edges(torch, fa, fac, rnd, H, H // group, D)
        fwd_cases += f
        bwd_cases += b
    return fwd_cases, bwd_cases


def kernel_adamw(torch, fw, ops):
    """AdamW kernel against ``_reference_update`` per element, at an MLP
    projection, a norm weight and the largest tensor of the training path
    (the embedding table and the lm-head), and with fp32 grads."""
    lr, step = 3e-4, 5
    hp = dict(b1=0.9, b2=0.95, eps=1e-8, decay=0.01)
    # the step's [lr, 1/bc1, 1/bc2] on the card, as the optimizer builds
    # it (every launch reads it)
    hp["scalars"] = fw.adamw_scalars(
        torch.tensor(lr, device="cuda"),
        torch.tensor(step, dtype=torch.int32, device="cuda"),
        torch.tensor([hp["b1"], hp["b2"]], dtype=torch.float32,
                     device="cuda"))
    g = torch.Generator(device="cuda").manual_seed(12)
    # a train step updates each tensor once, from device memory: every
    # timed call follows a rewrite of a buffer larger than the L2
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    cases = []
    # an MLP projection and a norm weight with bf16 grads, each with and
    # without a master weight; the path's largest tensor (embedding and
    # lm-head, 525 M elements) as the path updates it, with a master; then
    # the fp32-grad instantiations (gradient accumulation hands the update
    # fp32 grads) at a length with a ragged tail (n % 8 != 0); an fp32
    # parameter, its own master (a LoRA factor, phase 32), ragged too
    for shape, with_master, gdt, pdt in (
            ((4096, 14336), True, torch.bfloat16, torch.bfloat16),
            ((4096, 14336), False, torch.bfloat16, torch.bfloat16),
            ((4096,), True, torch.bfloat16, torch.bfloat16),
            ((4096,), False, torch.bfloat16, torch.bfloat16),
            ((128256, 4096), True, torch.bfloat16, torch.bfloat16),
            ((1000003,), True, torch.float32, torch.bfloat16),
            ((1000003,), False, torch.float32, torch.bfloat16),
            ((14337, 8), False, torch.float32, torch.float32)):
        p = (0.02 * torch.randn(*shape, generator=g, device="cuda")).to(pdt)
        grad = (1e-3 * torch.randn(*shape, generator=g,
                                   device="cuda")).to(gdt)
        m = 1e-4 * torch.randn(*shape, generator=g, device="cuda")
        v = 1e-7 * torch.rand(*shape, generator=g, device="cuda")
        master = (p.float() + 1e-4 * torch.randn(
            *shape, generator=g, device="cuda")) if with_master else None
        pf = master if with_master else p.float()
        gf = grad.float()
        rp, rm, rv = p.clone(), m.clone(), v.clone()
        rw = master.clone() if with_master else None
        ops.set_kernel_mode("reference")
        fw.fused_adamw_update(rp, grad, rm, rv, master=rw, **hp)
        ops.set_kernel_mode("auto")
        # the magnitudes of each result's summed terms, against which
        # an fp32 relative tolerance cannot be defeated by cancellation
        t_m = hp["b1"] * m.abs() + (1 - hp["b1"]) * gf.abs()
        t_v = hp["b2"] * v + (1 - hp["b2"]) * gf.square()
        new = rw if with_master else None
        kp, km, kv = p.clone(), m.clone(), v.clone()
        kw = master.clone() if with_master else None
        fw.fused_adamw_update(kp, grad, km, kv, master=kw, **hp)
        torch.cuda.synchronize()
        mhat = rm / (1 - hp["b1"] ** step)
        vhat = rv / (1 - hp["b2"] ** step)
        t_w = (pf.abs() * (1 - lr * hp["decay"])
               + lr * mhat.abs() / (vhat.sqrt() + hp["eps"]))
        # p: one bf16 step of the element; m, v, master: fp32 relative
        # 1e-6 of their terms (both multiply by the same 1/(1-beta^t);
        # PyTorch's eager ops may round a product the kernel keeps apart:
        # a few fp32 ulps)
        p_tol = (1e-6 * t_w if pdt == torch.float32
                 else 2.0 ** -7 * rp.float().abs())
        worst = {
            "p": ((kp.float() - rp.float()).abs()
                  / (p_tol + 1e-30)).max().item(),
            "m": ((km - rm).abs() / (1e-6 * t_m + 1e-30)).max().item(),
            "v": ((kv - rv).abs() / (1e-6 * t_v + 1e-30)).max().item()}
        if with_master:
            worst["master"] = ((kw - new).abs()
                               / (1e-6 * t_w + 1e-30)).max().item()
        del t_m, t_v, t_w, mhat, vhat, p_tol  # room for the largest tensor
        for n, w in worst.items():
            check(w <= 1.0, f"fused_adamw {shape} master={with_master}: "
                            f"{n} off by {w:.3g} x its tolerance")
        err = max((kp.float() - rp.float()).abs().max().item(),
                  (km - rm).abs().max().item(),
                  (kv - rv).abs().max().item())
        n = p.numel()
        gb, pb = grad.element_size(), p.element_size()
        # reads: master or p, g, m, v; writes: p, m, v, master
        nbytes = n * ((4 + gb + 8) + (2 + 8 + 4) if with_master
                      else (pb + gb + 8) + (pb + 8))
        bnd, by = bound_ms(nbytes, 15 * n, FP32_FLOPS)
        w32 = (master if with_master else p.float()).clone()
        w32.requires_grad_()
        w32.grad = gf.clone()
        lib_opt = torch.optim.AdamW([w32], lr=lr,
                                    betas=(hp["b1"], hp["b2"]),
                                    eps=hp["eps"],
                                    weight_decay=hp["decay"], fused=True)

        def plain():
            ops.set_kernel_mode("reference")
            fw.fused_adamw_update(rp, grad, rm, rv, master=rw, **hp)
            ops.set_kernel_mode("auto")

        case = dict(shape=list(shape), master=with_master,
                    grad=str(gdt).replace("torch.", ""),
                    param=str(pdt).replace("torch.", ""),
                    max_abs_err=err, worst_err_over_tol=worst,
                    ms=time_ms(lambda: fw.fused_adamw_update(
                        kp, grad, km, kv, master=kw, **hp), 20, flush),
                    plain_ms=time_ms(plain, 5, flush),
                    bound_ms=bnd, bound_by=by,
                    library_ms=event_ms(torch, lib_opt.step, 20, flush))
        log(f"kernel fused_adamw {shape} master={with_master}: "
            + json.dumps(case))
        cases.append(case)
        del p, grad, m, v, master, rp, rm, rv, rw, kp, km, kv, kw, w32, gf
        del pf, new, lib_opt
        gc.collect()
        torch.cuda.empty_cache()
    return cases


# --------------------------------------------------------------- phase 7
# kernel-name fragments of the port's own kernels, for the step breakdown
OWN_KERNELS = {"flash_fwd_kernel": "flash_fwd", "flash_bwd_dq_kernel":
               "flash_bwd_dq", "flash_bwd_dkv_kernel": "flash_bwd_dkv",
               "adamw_kernel": "fused_adamw", "rms_norm_kernel": "rms_norm",
               "layer_norm_kernel": "layer_norm",
               "paged_attention_": "paged_attention", "w8_": "w8_matmul",
               "lora_": "fused_lora_matmul",
               # the weight-streaming kernel by its epilogue (its name
               # holds "gemm", the library matmuls' class)
               "W8Epi": "w8_matmul", "LoraEpi": "fused_lora_matmul",
               "decode_tick_kernel": "decode_tick"}


def _kernel_class(name: str) -> str:
    for frag, own in OWN_KERNELS.items():
        if frag in name:
            return own
    low = name.lower()
    if any(k in low for k in ("gemm", "nvjet", "xmma", "cutlass", "cublas",
                              "sm90_")):
        return "matmul"
    if "elementwise" in low or "vectorized" in low:
        return "elementwise"
    if "reduce" in low:
        return "reduce"
    return "other"


def _busy_us(device_events) -> float:
    """The union of the device events' intervals, in us."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in device_events)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def _device_busy(torch, step, steps: int, classify=_kernel_class):
    """(device-busy seconds, host wall seconds, {class: device seconds},
    {kernel name: device seconds}) of ``steps`` train steps under
    torch.profiler: busy is the union of the trace's CUDA kernel and copy
    intervals, and the classes (``classify`` of a kernel's name; by
    default the port's kernels, matrix products, elementwise and reduction
    kernels and the rest; or ``classify.split(device events, all
    events)``, which returns the classes itself) split the device time;
    (None, wall, {}, {}) when the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        wall = time.perf_counter() - t0
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = _busy_us(device)
    classes, names = {}, {}
    split = getattr(classify, "split", None)
    if split is not None:
        classes = split(device, prof.events())
    for e in device:
        t = e.time_range.elapsed_us() * 1e-6
        if split is None:
            c = classify(e.name)
            classes[c] = classes.get(c, 0.0) + t
        names[e.name] = names.get(e.name, 0.0) + t
    if busy <= 0:
        return None, wall, {}, {}
    return busy * 1e-6, wall, classes, names


def _timed_steps(torch, ops, eng, batch, steps, want, label, exact=False):
    """``steps`` train steps of ``eng`` on ``batch``, each read back
    (``loss.item()``), every step's launches checked against ``want``
    ({kernel: launches a step}; with ``exact`` no other kernel may
    launch). Returns (losses, host walls in s, {kernel: launches over the
    steps}, peak GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    launches = dict.fromkeys(ops.KERNEL_WRAPPERS, 0)
    for i in range(steps):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        losses.append(eng.train_batch(*batch).item())
        walls.append(time.perf_counter() - t0)
        got = ops.launch_counts()
        for name, n in want.items():
            check(got[name] == n, f"{label}: step {i} launched {name} "
                                  f"{got[name]} times, want {n}")
        if exact:
            others = {k: n for k, n in got.items() if n and k not in want}
            check(not others, f"{label}: step {i}: unexpected launches "
                              f"{others}")
        for name in launches:
            launches[name] += got[name]
    check(all(x == x and abs(x) < 1e4 for x in losses),
          f"{label}: non-finite loss {losses}")
    return losses, walls, launches, \
        torch.cuda.max_memory_allocated() / 2 ** 30


def _step_device(torch, eng, fn, prof_steps, passes, repeats,
                 classify=_kernel_class):
    """Device time of one step (or eval pass) ``fn`` of ``eng``: on its
    graphs, CUDA events around ``passes`` calls enqueued back to back
    (``_replayed_ms``); eager, the busy time of ``torch.profiler``'s trace.
    Both report the profiler's busy time and its split by kernel class
    (``classify``) over ``prof_steps`` calls (the trace of a graph replay
    included)."""
    graphed = eng._use_graphs()
    replayed = _replayed_ms(torch, fn, passes, repeats) if graphed else None
    busy, prof_wall, classes, names = _device_busy(
        torch, lambda: fn().item(), prof_steps, classify)
    busy_ms = None if busy is None else busy / prof_steps * 1e3
    return dict(
        device_ms=replayed if graphed else busy_ms,
        device_ms_from="cuda events around back-to-back replays"
        if graphed else "torch.profiler busy time",
        profiled_busy_ms=busy_ms,
        busy_share_profiled=None if busy is None else busy / prof_wall,
        device_ms_by_class={c: t / prof_steps * 1e3 for c, t in sorted(
            classes.items(), key=lambda kv: -kv[1])},
        top_kernels_ms={n[:80]: t / prof_steps * 1e3 for n, t in sorted(
            names.items(), key=lambda kv: -kv[1])[:10]})


def _train_cell(torch, ops, eng, batch, *, steps, warmup, want, label,
                flops, tokens, examples=None, prof_steps=2, passes=3,
                repeats=3, exact=False):
    """One training cell on ``eng`` (graphed unless ``eng.graphs`` is
    False): :func:`_timed_steps`, then the step's device time
    (:func:`_step_device`) and the rates: ms per step (median host wall
    of the steps after ``warmup``: a graphed cell's first two steps are
    its warm-up and its capture), tokens/s, examples/s, MFU over the
    ``flops`` of a step, busy share (device over host ms), peak memory,
    replays and captures."""
    losses, walls, launches, peak = _timed_steps(
        torch, ops, eng, batch, steps, want, label, exact)
    step_s = _median(walls[warmup:])
    dev = _step_device(torch, eng, lambda: eng.train_batch(*batch),
                       prof_steps, passes, repeats)
    res = dict(graphs=eng._use_graphs(), losses=losses,
               step_walls_s=walls, ms_per_step=step_s * 1e3,
               tokens_per_s=tokens / step_s,
               mfu=flops / step_s / BF16_FLOPS,
               peak_memory_gib=peak,
               device_ms_per_step=dev.pop("device_ms"), **dev,
               replays=dict(eng.replays), captures=eng.captures,
               launches=launches, launches_per_step=want)
    if examples is not None:
        res["examples_per_s"] = examples / step_s
    res["busy_share"] = (None if res["device_ms_per_step"] is None
                         else res["device_ms_per_step"] / res["ms_per_step"])
    res["host_wall_over_device"] = (
        None if res["device_ms_per_step"] is None
        else res["ms_per_step"] / res["device_ms_per_step"])
    if res["graphs"]:
        check(eng.captures >= 1 and eng.replays["train"] >= steps - 1,
              f"{label}: {eng.replays['train']} replays, {eng.captures} "
              f"captures over {steps} steps: the graphs did not run")
    else:
        check(eng.captures == 0, f"{label}: the eager twin captured")
    log(f"{label}: " + json.dumps(res))
    return res


def _twins(label, graphed, eager):
    """A graphed cell against its eager twin: the same launches every
    step; the losses of the same steps (the same weights and batch)
    compared bit for bit (reported). Returns both and the ratios."""
    check(graphed["launches"] == eager["launches"],
          f"{label}: launches with graphs {graphed['launches']} != eager "
          f"{eager['launches']}")
    n = min(len(graphed["losses"]), len(eager["losses"]))
    out = dict(graphs=graphed, eager=eager,
               losses_bitwise_equal=graphed["losses"][:n]
               == eager["losses"][:n],
               ms_per_step_graphs_over_eager=graphed["ms_per_step"]
               / eager["ms_per_step"],
               peak_gib_graphs_minus_eager=graphed["peak_memory_gib"]
               - eager["peak_memory_gib"])
    log(f"{label}, graphs / eager: " + json.dumps(
        {k: v for k, v in out.items() if k not in ("graphs", "eager")}))
    return out


def _free(torch):
    gc.collect()                        # an engine holds a cycle
    torch.cuda.empty_cache()


def train(torch, ops):
    """Phase 7: 8 Llama-3-8B-wide layers, the graphed engine and its
    eager twin (``graphs = False``), each from the same seeded weights
    and fresh AdamW state."""
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama3_8b_config)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ParallelEngine

    cfg = llama3_8b_config(num_hidden_layers=TRAIN_LAYERS)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, seed=0)      # on the card, seeded
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_tensors = len(list(model.parameters()))
    log(f"train model: llama3-8b width, {TRAIN_LAYERS} layers, {n_params} "
        f"params bf16 ({n_tensors} tensors) + AdamW fp32 moments and master "
        f"weights, made on the card in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(7)
    tok = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1),
                        generator=gen, device="cuda")
    ids, labels = tok[:, :-1].contiguous(), tok[:, 1:].contiguous()
    # per step: each flash kernel once per layer, RMSNorm twice per layer
    # plus the final norm, AdamW once per parameter tensor
    want = {"flash_fwd": TRAIN_LAYERS, "flash_bwd_dq": TRAIN_LAYERS,
            "flash_bwd_dkv": TRAIN_LAYERS, "rms_norm": 2 * TRAIN_LAYERS + 1,
            "fused_adamw": n_tensors}
    tokens = TRAIN_B * TRAIN_S
    embed = model.model.embed_tokens.weight.numel()
    n_nonembed = n_params - embed
    H, D = cfg.num_attention_heads, cfg.head_dim
    attn_flops = 6 * TRAIN_LAYERS * H * D * TRAIN_S * tokens
    flops = 6 * n_nonembed * tokens + attn_flops
    cells = {}
    for mode in ("graphs", "eager"):
        model.reset_parameters(0)
        opt = AdamW(learning_rate=3e-4, parameters=model.named_parameters(),
                    weight_decay=0.01, multi_precision=True,
                    grad_clip=ClipGradByGlobalNorm(1.0))
        eng = ParallelEngine(model, optimizer=opt)
        eng.graphs = mode == "graphs"
        c = cells[mode] = _train_cell(
            torch, ops, eng, (ids, labels), steps=TRAIN_STEPS,
            warmup=TRAIN_WARMUP, want=want,
            label=f"train llama3-8b (8 layers, {mode})", flops=flops,
            tokens=tokens)
        check(c["losses"][-1] < c["losses"][0], f"train ({mode}): the "
              f"loss did not fall over {TRAIN_STEPS} steps: {c['losses']}")
        del eng, opt
        _free(torch)
    res = dict(layers=TRAIN_LAYERS, batch=TRAIN_B, seq=TRAIN_S,
               params=n_params, params_nonembed=n_nonembed,
               mfu_formula="(6 * N_nonembed * T + 6 * L * H * D * S * T) / "
                           "step_s / 989e12, N_nonembed = params - embedding "
                           "table, T = B * S tokens, causal attention "
                           "forward + backward",
               flops_per_step=flops,
               **_twins("train llama3-8b (8 layers)", cells["graphs"],
                        cells["eager"]),
               launches=cells["graphs"]["launches"])
    del model
    _free(torch)
    return res


# --------------------------------------------------------------- phase 8
def train_end_to_end(torch, ops, fa):
    """2 layers at full width, one fixed batch: forward + backward with
    the kernels, with the plain versions (bf16), and with the plain
    versions on an fp32 copy of the same weights; then three AdamW steps
    of both bf16 paths from the same seeded weights, a fresh seeded batch
    each, held against each other in loss and in the change of the fp32
    master weights, with the limits shown to reject two planted faults."""
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama3_8b_config)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ParallelEngine

    cfg = llama3_8b_config(num_hidden_layers=E2E_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(8)
    tok = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1),
                        generator=gen, device="cuda")
    ids, labels = tok[:, :-1].contiguous(), tok[:, 1:].contiguous()

    def grads(m, mode):
        ops.set_kernel_mode(mode)
        for p in m.parameters():
            p.requires_grad_(True)
            p.grad = None
        loss = m(ids, labels)
        loss.backward()
        ops.set_kernel_mode("auto")
        out = {n: p.grad.float() for n, p in m.named_parameters()}
        for p in m.parameters():
            p.grad = None
        return loss.item(), out

    torch.backends.cuda.matmul.allow_tf32 = False
    model = LlamaForCausalLM(cfg, seed=1)
    lk, gk = grads(model, "auto")
    lp, gp = grads(model, "reference")
    m32 = LlamaForCausalLM(dataclasses.replace(cfg, dtype="float32"),
                           device="cuda")
    with torch.no_grad():
        for p32, p16 in zip(m32.parameters(), model.parameters()):
            p32.copy_(p16)                  # exact widening of bf16
    lf, gf = grads(m32, "reference")
    del m32, model
    # The kernels round to bf16 in other places than the plain versions
    # (p before PV against the running max, summation order); neither bf16
    # path is exact. The fp32 run of the same weights is: the kernels'
    # loss and gradients may not be farther from it than the plain bf16
    # path's, by more than DRIFT_RATIO, per tensor (rms) and over all.
    per = {}
    sk = sp = 0.0
    for n in gf:
        dk2 = (gk[n] - gf[n]).square().sum().item()
        dp2 = (gp[n] - gf[n]).square().sum().item()
        sk += dk2
        sp += dp2
        per[n] = (dk2 / max(dp2, 1e-300)) ** 0.5
    worst_name = max(per, key=per.get)
    res = dict(layers=E2E_LAYERS, loss_kernels=lk, loss_plain_bf16=lp,
               loss_fp32=lf,
               loss_drift_ratio=abs(lk - lf) / max(abs(lp - lf), 1e-30),
               grad_drift_ratio_all=(sk / sp) ** 0.5,
               grad_drift_ratio_worst=per[worst_name],
               grad_drift_worst_tensor=worst_name,
               grad_drift_ratio_median=sorted(per.values())[len(per) // 2],
               grad_rms_fp32=(sum(g.square().sum().item()
                                  for g in gf.values())
                              / sum(g.numel() for g in gf.values())) ** 0.5)
    del gk, gp, gf
    gc.collect()
    torch.cuda.empty_cache()
    check(res["loss_drift_ratio"] <= DRIFT_RATIO,
          f"train end to end: the kernels' loss is "
          f"{res['loss_drift_ratio']:.3g} x as far from fp32 as the plain "
          f"bf16 path's (limit {DRIFT_RATIO})")
    for key in ("grad_drift_ratio_all", "grad_drift_ratio_worst"):
        check(res[key] <= DRIFT_RATIO, f"train end to end: {key} "
              f"{res[key]:.3g} > {DRIFT_RATIO} ({worst_name})")

    # Three steps, each on a fresh seeded batch: random tokens keep every
    # step's loss near ln(vocab), so each step's loss gap is measured
    # against a loss of one size (one memorised batch drove it to 1e-3 by
    # step 3). The steps are compared in loss (per step, relative) and in
    # what they did to the weights: the change of the fp32 master weights
    # over the three steps, |W_kernels - W_plain| / |W_plain - W_0| over
    # all tensors, which sees a fault of the backward or of the update that
    # moves the loss little.
    stok = torch.randint(0, cfg.vocab_size, (3, TRAIN_B, TRAIN_S + 1),
                         generator=gen, device="cuda")
    batches = [(t[:, :-1].contiguous(), t[:, 1:].contiguous()) for t in stok]
    w0 = dict(LlamaForCausalLM(cfg, seed=1).named_parameters())

    def steps(mode, fault=None):
        ops.set_kernel_mode(mode)
        m = LlamaForCausalLM(cfg, seed=1)
        opt = AdamW(learning_rate=3e-4, parameters=m.named_parameters(),
                    weight_decay=0.01, multi_precision=True,
                    grad_clip=ClipGradByGlobalNorm(1.0))
        eng = ParallelEngine(m, optimizer=opt)
        if fault == "bias_step1":       # bias correction stuck at step 1
            upd = opt.update
            opt.update = lambda items, lr, step: upd(items, lr, 1)
        with (_mask_shifted(fa, 1) if fault == "mask+1"
              else contextlib.nullcontext()):
            losses = [eng.train_batch(i, lb).item() for i, lb in batches]
        ops.set_kernel_mode("auto")
        masters = {n: s["master_weight"]
                   for n, s in opt._accumulators.items()}
        del eng, opt, m
        gc.collect()                    # the engine holds a cycle
        torch.cuda.empty_cache()
        return losses, masters

    def held_against(losses, masters, ref_losses, ref_masters):
        """(largest per-step relative loss gap, master-weight change gap
        over all tensors, the worst tensor's gap and its name)."""
        d2 = s2 = 0.0
        per = {}
        for n, w in ref_masters.items():
            dn = (masters[n] - w).square().sum().item()
            sn = (w - w0[n].float()).square().sum().item()
            d2, s2 = d2 + dn, s2 + sn
            per[n] = (dn / max(sn, 1e-300)) ** 0.5
        worst = max(per, key=per.get)
        return dict(step_loss_rel_gap=max(abs(a - b) / abs(b) for a, b in
                                          zip(losses, ref_losses)),
                    update_gap=(d2 / s2) ** 0.5,
                    update_gap_worst=per[worst],
                    update_gap_worst_tensor=worst)

    sp_, wp = steps("reference")
    sk_, wk = steps("auto")
    res.update(step_losses_kernels=sk_, step_losses_plain_bf16=sp_,
               **held_against(sk_, wk, sp_, wp))
    del wk
    mutants = {}
    for fault in ("mask+1", "bias_step1"):
        sm, wm = steps("reference", fault)
        mutants[fault] = dict(step_losses=sm,
                              **held_against(sm, wm, sp_, wp))
        del wm
    res["mutants"] = mutants
    del wp, w0
    gc.collect()
    torch.cuda.empty_cache()
    log("train end_to_end kernels vs plain vs fp32: " + json.dumps(res))
    check(all(x == x for x in sk_ + sp_), "train end to end: non-finite loss")
    check(res["step_loss_rel_gap"] <= STEP_LOSS_REL,
          f"train end to end: three AdamW steps of the kernels and the plain "
          f"bf16 path differ by {res['step_loss_rel_gap']:.3g} of the loss "
          f"(limit {STEP_LOSS_REL})")
    check(res["update_gap"] <= UPDATE_GAP,
          f"train end to end: the kernels' three steps changed the master "
          f"weights {res['update_gap']:.3g} (relative) away from the plain "
          f"bf16 path's (limit {UPDATE_GAP})")
    for fault, m in mutants.items():
        check(m["update_gap"] > UPDATE_GAP,
              f"train end to end: the update limit passes the planted fault "
              f"{fault} ({m['update_gap']:.3g})")
    return res


# -------------------------------------------------------------- phase 18
# the long-context training cell (phases 18-20): Llama-3-8B width, 8
# layers, one sequence of 16384 tokens (the JAX package's tuned streaming
# regime and profiled step) and of 32768 under remat (its 8B recipe's
# length), max_position_embeddings raised to the longest, as bench.py does
# (depth 8 and 6 / 4 steps before phase 32 took the time; every check
# kept)
LONG_LAYERS, LONG_S, LONG_REMAT_S = 4, 16384, 32768
LONG_STEPS, LONG_WARMUP = 4, 2
REMAT_STEPS, REMAT_WARMUP = 3, 1
LONG_POLICIES = ("nothing", "save_attn", "save_attn_mlp", "save_qkv_attn",
                 "dots")
LOOP_FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
STREAM_FLASH = ("flash_fwd_stream", "flash_bwd_dq_stream",
                "flash_bwd_dkv_stream")


def _lse_ratio(lse, ref, Sk):
    """LSE per row against its tolerance: both sides sum the same fp32
    exponentials in other orders; Sk terms bound the relative error of the
    sum by Sk * 2^-24 (phase 6)."""
    return (lse - ref).abs() / (Sk * 2.0 ** -24 + 2.0 ** -20 * ref.abs())


def kernel_flash_stream(torch, fa, fac, ops):
    """Phase 18: the streaming kernels (rows 2, 5, 6) through the dispatch
    at Sk > 8192, against the plain versions with phase 6's tolerances."""
    from torch.nn import functional as F

    B, H, KV, D = 1, 32, 8, 128
    s = 1.0 / D ** 0.5
    g = torch.Generator(device="cuda").manual_seed(18)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(
            torch.bfloat16)

    cases = {n: [] for n in STREAM_FLASH}
    # (Sq, Sk, causal, timed): the training shape; no causal mask; a
    # ragged last tile with Sq < Sk (bottom-right alignment); the remat
    # cell's shape (2048 query tiles a dK/dV block, the longest offsets)
    for Sq, Sk, causal, timed in ((LONG_S, LONG_S, True, True),
                                  (12288, 12288, False, True),
                                  (8192 + 64, LONG_S + 64, True, False),
                                  (LONG_REMAT_S, LONG_REMAT_S, True, False)):
        q, k, v = rnd(B, H, Sq, D), rnd(B, KV, Sk, D), rnd(B, KV, Sk, D)
        do = rnd(B, H, Sq, D)
        ops.reset_launch_counts()
        out, lse = fa._flash_fwd_bhsd(q, k, v, causal, s)
        ref, rlse = fa._flash_fwd_plain(q, k, v, causal, s)
        delta = (do.float() * ref.float()).sum(-1)
        got = dict(o=out, **dict(zip(("dq", "dk", "dv"), fa._flash_bwd_bhsd(
            q, k, v, do, rlse, delta, causal, s))))
        counts = ops.launch_counts()
        want = dict(zip(("dq", "dk", "dv"), fa._flash_bwd_plain(
            q, k, v, do, rlse, delta, causal, s)), o=ref)
        torch.cuda.synchronize()
        check(_repeatable(torch, lambda: fac.flash_fwd_stream_cuda(
            q, k, v, causal, s), (out, lse))
              and _repeatable(torch, lambda: fac.flash_bwd_dq_stream_cuda(
                  q, k, v, do, rlse, delta, causal, s), got["dq"])
              and _repeatable(torch, lambda: fac.flash_bwd_dkv_stream_cuda(
                  q, k, v, do, rlse, delta, causal, s), (got["dk"],
                                                         got["dv"])),
              f"flash stream Sq={Sq} Sk={Sk}: a second launch gave other "
              f"bits")
        check(all(counts[n] == 1 for n in STREAM_FLASH)
              and all(counts[n] == 0 for n in LOOP_FLASH),
              f"flash stream Sq={Sq} Sk={Sk}: the dispatch launched "
              f"{ {n: counts[n] for n in LOOP_FLASH + STREAM_FLASH} }")
        rms = {n: _rms(v) if n == "o" else _rms(w) for n, w in want.items()}
        ratios = {n: _row_ratio(x, want[n], rms[n]).max().item()
                  for n, x in got.items()}
        ratios["lse"] = _lse_ratio(lse, rlse, Sk).max().item()
        for n, w in ratios.items():
            check(bool(torch.isfinite(got.get(n, lse).float()).all()),
                  f"flash stream Sq={Sq} Sk={Sk}: {n} non-finite")
            check(w <= 1.0, f"flash stream Sq={Sq} Sk={Sk} causal={causal}: "
                            f"{n} off by {w:.3g} x its tolerance")
        errs = {n: (x.float() - want[n].float()).abs().max().item()
                for n, x in got.items()}
        errs["lse"] = (lse - rlse).abs().max().item()
        base = dict(B=B, H=H, KV=KV, D=D, Sq=Sq, Sk=Sk, causal=causal,
                    bitwise_repeatable=True)
        mutants = {}
        if causal and Sq == Sk == LONG_S:
            # the tolerances reject the causal mask one key off, forward
            # (O) and backward (the mutant's whole plain pipeline)
            for d in (1, -1):
                with _mask_shifted(fa, d):
                    mo, ml = fa._flash_fwd_plain(q, k, v, True, s)
                    mg = fa._flash_bwd_plain(
                        q, k, v, do, ml, (do.float() * mo.float()).sum(-1),
                        True, s)
                mutants[f"mask{d:+d}"] = {
                    n: _row_ratio(x, want[n], rms[n]).max().item()
                    for n, x in zip(("o", "dq", "dk", "dv"), (mo,) + mg)}
                del mo, ml, mg
                for n, w in mutants[f"mask{d:+d}"].items():
                    check(w > 1.0, f"flash stream: the tolerance passes the "
                                   f"mask{d:+d} fault in {n} ({w:.3g})")
        pairs = _visible_pairs(Sq, Sk) if causal else Sq * Sk
        io = 2 * (2 * q.numel() + k.numel() + v.numel())
        bounds = {"flash_fwd_stream": bound_ms(io + 4 * lse.numel(),
                                              4 * D * B * H * pairs,
                                              BF16_FLOPS),
                  "flash_bwd_dq_stream": bound_ms(
                      io + 8 * lse.numel() + 2 * q.numel(),
                      6 * D * B * H * pairs, BF16_FLOPS),
                  "flash_bwd_dkv_stream": bound_ms(
                      io + 8 * lse.numel() + 2 * (k.numel() + v.numel()),
                      8 * D * B * H * pairs, BF16_FLOPS)}
        keys = {"flash_fwd_stream": ("o", "lse"), "flash_bwd_dq_stream":
                ("dq",), "flash_bwd_dkv_stream": ("dk", "dv")}
        for name in STREAM_FLASH:
            case = dict(base, max_abs_err=max(errs[n] for n in keys[name]),
                        max_abs_errs={n: errs[n] for n in keys[name]},
                        worst_err_over_tol={n: ratios[n]
                                            for n in keys[name]})
            if name == "flash_fwd_stream":
                case["mutants"] = {m: r["o"] for m, r in mutants.items()}
            else:
                case["mutants"] = {m: {n: r[n] for n in keys[name]}
                                   for m, r in mutants.items()}
            case["bound_ms"], case["bound_by"] = bounds[name]
            cases[name].append(case)
        if timed:
            fwd = cases["flash_fwd_stream"][-1]
            mask = {"is_causal": True} if causal else {}

            def lib_fwd():
                return F.scaled_dot_product_attention(q, k, v, enable_gqa=True,
                                                      **mask)

            fwd.update(ms=time_ms(lambda: fac.flash_fwd_stream_cuda(
                q, k, v, causal, s), 5),
                plain_ms=time_ms(lambda: fa._flash_fwd_plain(q, k, v, causal,
                                                             s), 1),
                library_ms=time_ms(lib_fwd, 5))
        if timed and causal:
            lib = sdpa_backward_ms(torch, q, k, v, do, 3, is_causal=True)
            plain_bwd = time_ms(lambda: fa._flash_bwd_plain(
                q, k, v, do, rlse, delta, True, s), 1)
            for name, fn in (
                    ("flash_bwd_dq_stream",
                     lambda: fac.flash_bwd_dq_stream_cuda(
                         q, k, v, do, rlse, delta, True, s)),
                    ("flash_bwd_dkv_stream",
                     lambda: fac.flash_bwd_dkv_stream_cuda(
                         q, k, v, do, rlse, delta, True, s))):
                cases[name][-1].update(ms=time_ms(fn, 5), plain_ms=plain_bwd,
                                       **lib)
        for name in STREAM_FLASH:
            log(f"kernel {name} Sq={Sq} Sk={Sk} causal={causal} bf16: "
                + json.dumps(cases[name][-1]))
        del q, k, v, do, out, lse, ref, rlse, delta, got, want
        gc.collect()
        torch.cuda.empty_cache()
    return cases


# -------------------------------------------------------------- phase 19
def _long_batch(torch, gen, vocab, S):
    tok = torch.randint(0, vocab, (1, S + 1), generator=gen, device="cuda")
    return tok[:, :-1].contiguous(), tok[:, 1:].contiguous()


def train_long(torch, ops):
    """Phase 19: the long-context training cells, one model and optimizer
    for all, each cell from the same seeded weights and fresh optimizer
    state: (a) S = 16384 without remat, (b) S = 32768 under
    remat_policy="nothing", (c) S = 16384, one step under each policy,
    whose losses must equal (a)'s first bit for bit (remat changes what is
    kept, not what is computed)."""
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama3_8b_config)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ParallelEngine

    L = LONG_LAYERS
    cfg = llama3_8b_config(num_hidden_layers=L,
                           max_position_embeddings=LONG_REMAT_S)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, seed=0)
    opt = AdamW(learning_rate=3e-4, parameters=model.named_parameters(),
                weight_decay=0.01, multi_precision=True,
                grad_clip=ClipGradByGlobalNorm(1.0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_tensors = len(list(model.parameters()))
    n_nonembed = n_params - model.model.embed_tokens.weight.numel()
    H, D = cfg.num_attention_heads, cfg.head_dim
    log(f"train long model: llama3-8b width, {L} layers, {n_params} params "
        f"bf16, max_position_embeddings {cfg.max_position_embeddings}, made "
        f"in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(19)
    batches = {S: _long_batch(torch, gen, cfg.vocab_size, S)
               for S in (LONG_S, LONG_REMAT_S)}
    launches = dict.fromkeys(ops.KERNEL_WRAPPERS, 0)

    def cell(S, steps, warmup, remat, policy, graphs=True, timed=True):
        model.reset_parameters(0)
        opt._accumulators.clear()
        _free(torch)
        eng = ParallelEngine(model, optimizer=opt, remat=remat,
                             remat_policy=policy)
        eng.graphs = graphs
        batch = batches[S]
        # per step: the streaming kernels and never the loop ones; under
        # remat the forward kernel runs again in each layer's recompute
        # (no policy can save what a ctypes kernel makes, as no JAX policy
        # saves the Pallas call), and so does RMSNorm, but for the final
        # norm outside the layers
        want = {"flash_fwd_stream": 2 * L if remat else L,
                "flash_bwd_dq_stream": L, "flash_bwd_dkv_stream": L,
                "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                "rms_norm": 4 * L + 1 if remat else 2 * L + 1,
                "fused_adamw": n_tensors}
        flops = 6 * n_nonembed * S + 6 * L * H * D * S * S
        label = (f"train long S={S} remat={policy if remat else None} "
                 f"({'graphs' if graphs else 'eager'})")
        if timed:
            # one profiled step, two replays back to back for the events
            res = _train_cell(torch, ops, eng, batch, steps=steps,
                              warmup=warmup, want=want, label=label,
                              flops=flops, tokens=S, prof_steps=1,
                              passes=2, repeats=1)
            # only the streaming entry points ran (checked): the shared
            # kernel bodies' time is theirs
            rename = dict(zip(LOOP_FLASH, STREAM_FLASH))
            res["device_ms_by_class"] = {
                rename.get(c, c): t
                for c, t in res["device_ms_by_class"].items()}
        else:
            losses, walls, _, peak = _timed_steps(torch, ops, eng, batch,
                                                  steps, want, label)
            res = dict(losses=losses, step_walls_s=walls,
                       ms_per_step=_median(walls[warmup:]) * 1e3,
                       peak_memory_gib=peak, launches_per_step=want)
        res.update(seq=S, batch=1, layers=L, remat=remat,
                   remat_policy=policy if remat else None,
                   compute_bound_ms=flops / BF16_FLOPS * 1e3)
        if graphs and timed:        # the main path's counted steps
            for name in launches:
                launches[name] += res["launches"][name]
        del eng
        _free(torch)
        return res

    mfu_formula = ("(6 * N_nonembed * S + 6 * L * H * D * S * S) / step_s / "
                   "989e12, B = 1, the model's operations (a recompute's "
                   "are not counted), causal attention forward + backward")
    res = dict(params=n_params, params_nonembed=n_nonembed,
               mfu_formula=mfu_formula)
    for key, S, steps, warmup, remat, policy in (
            ("no_remat", LONG_S, LONG_STEPS, LONG_WARMUP, False, None),
            ("remat", LONG_REMAT_S, REMAT_STEPS, REMAT_WARMUP, True,
             "nothing")):
        graphed = cell(S, steps, warmup, remat, policy)
        res[key] = graphed
        res[key + "_eager"] = cell(S, steps, warmup, remat, policy,
                                   graphs=False)
        res[key + "_twins"] = {k: v for k, v in _twins(
            f"train long {key}", graphed, res[key + "_eager"]).items()
            if k not in ("graphs", "eager")}
        ls = graphed["losses"]
        check(ls[-1] < ls[0], f"train long {key}: the loss did not fall: "
                              f"{ls}")
    # (c) one step a policy: a graphed engine's first step is its warm-up,
    # run eagerly
    res["policies"] = {p: cell(LONG_S, 1, 0, True, p, timed=False)
                       for p in LONG_POLICIES}
    first = res["no_remat"]["losses"][0]
    for p, c in res["policies"].items():
        check(c["losses"][0] == first, f"train long: the first loss under "
              f"{p} {c['losses'][0]} differs from no remat's {first}")
    peaks = {p: c["peak_memory_gib"] for p, c in res["policies"].items()}
    # (c)'s steps run eagerly: against (a)'s eager twin
    peaks["no_remat"] = res["no_remat_eager"]["peak_memory_gib"]
    log(f"train long S={LONG_S} per policy: " + json.dumps(
        {p: dict(ms_per_step=c["ms_per_step"],
                 peak_memory_gib=c["peak_memory_gib"], losses=c["losses"])
         for p, c in res["policies"].items()}))
    # peak memory orders as the policies save: each at most 1 % above the
    # next, and dots below no remat
    order = [("nothing", "save_attn"), ("save_attn", "save_attn_mlp"),
             ("save_attn", "save_qkv_attn"), ("save_attn_mlp", "dots"),
             ("save_qkv_attn", "dots")]
    for a, b in order:
        check(peaks[a] <= 1.01 * peaks[b], f"train long: peak memory under "
              f"{a} {peaks[a]:.3f} GiB > {b} {peaks[b]:.3f} GiB + 1 %")
    check(peaks["dots"] < peaks["no_remat"], f"train long: peak memory "
          f"under dots {peaks['dots']:.3f} GiB >= no remat "
          f"{peaks['no_remat']:.3f} GiB")
    res["peak_memory_gib_by_policy"] = peaks
    res["launches"] = launches
    del opt, model, batches
    gc.collect()
    torch.cuda.empty_cache()
    return res


# -------------------------------------------------------------- phase 20
def train_long_end_to_end(torch, ops):
    """Phase 20: 2 layers at full width, S = 16384, one forward + backward
    with the kernels (twice), with the kernels under remat_policy="dots",
    with the plain versions in bf16 and with the plain versions on an fp32
    copy. The kernels' loss and gradients may be at most DRIFT_RATIO as
    far from fp32 as the plain bf16 path's; the remat run must equal the
    kernels' run bit for bit."""
    from paddle_tpu_torch.distributed.fleet.recompute import remat_layers
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama3_8b_config)

    L = E2E_LAYERS
    cfg = llama3_8b_config(num_hidden_layers=L,
                           max_position_embeddings=LONG_S)
    gen = torch.Generator(device="cuda").manual_seed(20)
    ids, labels = _long_batch(torch, gen, cfg.vocab_size, LONG_S)

    def grads(m, mode, policy=None):
        """(loss, {name: grad in the parameter's dtype}, launches)"""
        ops.set_kernel_mode(mode)
        for p in m.parameters():
            p.requires_grad_(True)
            p.grad = None
        ops.reset_launch_counts()
        # the per-layer scope ParallelEngine(remat=True, remat_policy=)
        # opens for this model
        with (remat_layers(policy) if policy else contextlib.nullcontext()):
            loss = m(ids, labels)
        loss.backward()
        counts = ops.launch_counts()
        ops.set_kernel_mode("auto")
        out = {n: p.grad for n, p in m.named_parameters()}
        for p in m.parameters():
            p.grad = None
        return loss.item(), out, counts

    torch.backends.cuda.matmul.allow_tf32 = False
    model = LlamaForCausalLM(cfg, seed=2)
    lk, gk, ck = grads(model, "auto")
    lk2, gk2, _ = grads(model, "auto")
    lr_, gr, cr = grads(model, "auto", "dots")
    for counts, fwd in ((ck, L), (cr, 2 * L)):
        check(counts["flash_fwd_stream"] == fwd
              and counts["flash_bwd_dq_stream"] == L
              and counts["flash_bwd_dkv_stream"] == L
              and all(counts[n] == 0 for n in LOOP_FLASH),
              f"train long end to end: flash launches {counts}")
    # recompute replays the same kernels and products on the same inputs:
    # the remat step must be the plain step bit for bit. The one admissible
    # exception is a product shown to differ between two runs of the step
    # without remat; its spread is then the limit
    det = lk2 == lk and all(torch.equal(gk2[n], gk[n]) for n in gk)
    diff_remat = sorted(n for n in gk if not torch.equal(gr[n], gk[n]))
    res = dict(layers=L, seq=LONG_S, loss_kernels=lk,
               loss_kernels_rerun=lk2, loss_kernels_remat_dots=lr_,
               kernel_step_deterministic=det,
               remat_bitwise_equal=lr_ == lk and not diff_remat,
               remat_tensors_differing=diff_remat)
    if det:
        check(res["remat_bitwise_equal"], f"train long end to end: the "
              f"remat step differs from the kernels' step (loss {lr_} vs "
              f"{lk}; tensors {diff_remat})")
    else:
        spread = {n: (gk2[n].float() - gk[n].float()).abs().max().item()
                  for n in gk}
        off = {n: (gr[n].float() - gk[n].float()).abs().max().item()
               for n in gk}
        res.update(rerun_spread=spread, remat_off=off)
        check(abs(lr_ - lk) <= abs(lk2 - lk)
              and all(off[n] <= spread[n] for n in gk),
              f"train long end to end: the remat step is farther from the "
              f"kernels' step than two runs of it are: {off} vs {spread}")
    gk = {n: g.float() for n, g in gk.items()}
    del gk2, gr
    lp, gp, _ = grads(model, "reference")
    gp = {n: g.float() for n, g in gp.items()}
    m32 = LlamaForCausalLM(dataclasses.replace(cfg, dtype="float32"),
                           device="cuda")
    with torch.no_grad():
        for p32, p16 in zip(m32.parameters(), model.parameters()):
            p32.copy_(p16)
    del model
    lf, gf, _ = grads(m32, "reference")
    del m32
    per = {}
    sk = sp = 0.0
    for n in gf:
        dk2 = (gk[n] - gf[n]).square().sum().item()
        dp2 = (gp[n] - gf[n]).square().sum().item()
        sk, sp = sk + dk2, sp + dp2
        per[n] = (dk2 / max(dp2, 1e-300)) ** 0.5
    worst = max(per, key=per.get)
    res.update(loss_plain_bf16=lp, loss_fp32=lf,
               loss_drift_ratio=abs(lk - lf) / max(abs(lp - lf), 1e-30),
               grad_drift_ratio_all=(sk / sp) ** 0.5,
               grad_drift_ratio_worst=per[worst],
               grad_drift_worst_tensor=worst)
    del gk, gp, gf
    gc.collect()
    torch.cuda.empty_cache()
    log("train long end_to_end kernels vs remat vs plain vs fp32: "
        + json.dumps(res))
    check(res["loss_drift_ratio"] <= DRIFT_RATIO,
          f"train long end to end: the kernels' loss is "
          f"{res['loss_drift_ratio']:.3g} x as far from fp32 as the plain "
          f"bf16 path's (limit {DRIFT_RATIO})")
    for key in ("grad_drift_ratio_all", "grad_drift_ratio_worst"):
        check(res[key] <= DRIFT_RATIO, f"train long end to end: {key} "
              f"{res[key]:.3g} > {DRIFT_RATIO} ({worst})")
    return res


# -------------------------------------------------------------- phase 21
# ERNIE-3.0 base finetune (phases 21-23): the repo's recipe (BASELINE
# config 2, tools/model_benchmark.py's bench_ernie): 12 layers, hidden
# 768, 12 heads of 64, vocab 40000, B = 32 x S = 128, dropout 0.1 / 0.1,
# AdamW lr 5e-5; and S = 512 with attention dropout 0, which takes the
# flash kernels (rows 1, 3, 4) at head dim 64
ERNIE_B, ERNIE_S, ERNIE_LONG_S = 32, 128, 512
ERNIE_STEPS, ERNIE_WARMUP = 10, 2
ERNIE_LAYERS, ERNIE_H, ERNIE_D = 12, 12, 64
# LayerNorms a forward: the embeddings' one and two a layer
ERNIE_LN = 2 * ERNIE_LAYERS + 1


def _ln_case(torch, g, rows, D, dtype):
    """LayerNorm inputs whose rows have means of either sign and several
    scales (a residual stream's rows do), so that a variance taken about 0
    instead of about the mean shows."""
    mean = torch.randn(rows, 1, generator=g, device="cuda")
    scale = 0.5 + 1.5 * torch.rand(rows, 1, generator=g, device="cuda")
    x = (mean + scale * torch.randn(rows, D, generator=g, device="cuda")).to(
        dtype)
    w = (1 + 0.1 * torch.randn(D, generator=g, device="cuda")).to(dtype)
    b = (0.1 * torch.randn(D, generator=g, device="cuda")).to(dtype)
    return x, w, b


def _ln_mutant(torch, x, w, b, eps, fault):
    """The plain LayerNorm with one planted fault, in its own rounding:
    the bias left out, or the variance taken about 0 (E[x^2])."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    if fault == "var_about_0":
        var = xf.square().mean(-1, keepdim=True)
    else:
        var = (xf - mu).square().mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * w.float()
    if fault != "no_bias":
        out = out + b.float()
    return out.to(x.dtype)


def _ln_ratio(y, ref, x, w, dtype):
    """Per element: |y - ref| against one rounding step of the output (one
    bf16 step, 2^-7 of the value; 16 fp32 ulps, 2^-20) plus what the order
    of the fp32 sums moves the row's mean, in units of the normalised
    output: kernel and plain version each sum D terms with an error of at
    most ~32 ulps of sum|x| (a lane's 24 serial adds and the 5 shuffle
    levels; the plain version's vectorised pairwise sum), so 2^-18 of
    mean|x| / std(x) a row, times |w|."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    shift = xf.abs().mean(-1, keepdim=True) / (
        (xf - mu).square().mean(-1, keepdim=True).sqrt() + 1e-30)
    r = ref.float()
    rel = 2.0 ** -7 if dtype == "bf16" else 2.0 ** -20
    tol = rel * r.abs() + 2.0 ** -18 * shift * w.float().abs()
    return (y.float() - r).abs() / tol


def kernel_layer_norm(torch, fused_norm):
    """Phase 21: row 8 against its plain version in bf16 and fp32 at
    ERNIE's B x S rows (S = 128 and 512), at 8 rows and at 4096 x 4096,
    with the tolerance shown to reject two planted faults; times beside
    the plain version and ``torch.nn.functional.layer_norm``."""
    from torch.nn import functional as F

    g = torch.Generator(device="cuda").manual_seed(21)
    eps = 1e-12                   # ERNIE's embedding norm: the hardest eps
    cases = []
    for rows, D in ((ERNIE_B * ERNIE_S, 768), (ERNIE_B * ERNIE_LONG_S, 768),
                    (8, 768), (4096, 4096)):
        for name, dtype in (("bf16", torch.bfloat16),
                            ("fp32", torch.float32)):
            x, w, b = _ln_case(torch, g, rows, D, dtype)
            y = fused_norm.layer_norm_cuda(x, w, b, eps)
            ref = fused_norm._ln_ref(x, w, b, eps)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(y.float()).all()),
                  f"layer_norm {rows}x{D} {name}: non-finite")
            worst = _ln_ratio(y, ref, x, w, name).max().item()
            check(worst <= 1.0, f"layer_norm {rows}x{D} {name}: an element "
                                f"is off by {worst:.3g} x its tolerance")
            mutants = {}
            for fault in ("no_bias", "var_about_0"):
                r = _ln_ratio(_ln_mutant(torch, x, w, b, eps, fault), ref,
                              x, w, name)
                mutants[fault] = dict(worst_err_over_tol=r.max().item(),
                                      elements_failed=(r > 1.0).float()
                                      .mean().item())
                check(r.max().item() > 1.0, f"layer_norm {rows}x{D} {name}: "
                                            f"the tolerance passes the "
                                            f"{fault} fault")
            es = x.element_size()
            bnd, by = bound_ms(2 * rows * D * es + 2 * D * es, 8 * rows * D,
                               FP32_FLOPS)
            case = dict(
                rows=rows, dim=D, dtype=name, eps=eps,
                max_abs_err=(y.float() - ref.float()).abs().max().item(),
                worst_err_over_tol=worst, mutants=mutants,
                ms=time_ms(lambda: fused_norm.layer_norm_cuda(x, w, b, eps),
                           200),
                plain_ms=time_ms(lambda: fused_norm._ln_ref(x, w, b, eps),
                                 50),
                bound_ms=bnd, bound_by=by,
                library_ms=time_ms(lambda: F.layer_norm(x, (D,), w, b, eps),
                                   200))
            log(f"kernel layer_norm rows={rows}x{D} {name}: "
                + json.dumps(case))
            cases.append(case)
            del x, w, b, y, ref
    return cases


# -------------------------------------------------------------- phase 22
def _drop_last_key(torch, fa, q, k, v, do=None):
    """The plain flash versions with the last key left out: the planted
    fault of the non-causal checks (phase 6 moves the causal mask), in the
    plain versions' own rounding. (O, LSE), or (dQ, dK, dV) with ``do``,
    dK and dV zero at the dropped key."""
    s = 1.0 / q.shape[-1] ** 0.5
    kk, vv = k[:, :, :-1].contiguous(), v[:, :, :-1].contiguous()
    o, lse = fa._flash_fwd_plain(q, kk, vv, False, s)
    if do is None:
        return o, lse
    delta = (do.float() * o.float()).sum(-1)
    dq, dk, dv = fa._flash_bwd_plain(q, kk, vv, do, lse, delta, False, s)
    pad = torch.nn.functional.pad
    return dq, pad(dk, [0, 0, 0, 1]), pad(dv, [0, 0, 0, 1])


def kernel_flash_d64(torch, fa, fac):
    """Phase 22: the flash forward, dQ and dK/dV kernels at head dim 64,
    without the causal mask, at ERNIE's B = 32, H = 12 and S in {128, 512},
    against the plain versions with phase 6's per-row tolerances and a
    planted fault (the last key dropped); times beside SDPA."""
    from torch.nn import functional as F

    B, H, D = ERNIE_B, ERNIE_H, ERNIE_D
    s = 1.0 / D ** 0.5
    g = torch.Generator(device="cuda").manual_seed(22)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(
            torch.bfloat16)

    fwd_cases, bwd_cases = [], []
    for S in (ERNIE_S, ERNIE_LONG_S):
        q, k, v, do = (rnd(B, H, S, D) for _ in range(4))
        out, lse = fac.flash_fwd_cuda(q, k, v, False, s)
        ref, rlse = fa._flash_fwd_plain(q, k, v, False, s)
        delta = (do.float() * ref.float()).sum(-1)
        dq = fac.flash_bwd_dq_cuda(q, k, v, do, rlse, delta, False, s)
        dk, dv = fac.flash_bwd_dkv_cuda(q, k, v, do, rlse, delta, False, s)
        rdq, rdk, rdv = fa._flash_bwd_plain(q, k, v, do, rlse, delta, False,
                                            s)
        torch.cuda.synchronize()
        got = {"o": out, "dq": dq, "dk": dk, "dv": dv}
        want = {"o": ref, "dq": rdq, "dk": rdk, "dv": rdv}
        scale_of = {n: _rms(v) if n == "o" else _rms(want[n]) for n in got}
        ratios = {n: _row_ratio(x, want[n], scale_of[n]).max().item()
                  for n, x in got.items()}
        ratios["lse"] = _lse_ratio(lse, rlse, S).max().item()
        for n, w_ in ratios.items():
            check(bool(torch.isfinite(got.get(n, lse).float()).all()),
                  f"flash d64 S={S}: {n} non-finite")
            check(w_ <= 1.0, f"flash d64 S={S}: {n} off by {w_:.3g} x its "
                             f"tolerance")
        check(_repeatable(torch, lambda: fac.flash_fwd_cuda(
            q, k, v, False, s), (out, lse))
              and _repeatable(torch, lambda: fac.flash_bwd_dq_cuda(
                  q, k, v, do, rlse, delta, False, s), dq)
              and _repeatable(torch, lambda: fac.flash_bwd_dkv_cuda(
                  q, k, v, do, rlse, delta, False, s), (dk, dv)),
              f"flash d64 S={S}: a second launch gave other bits")
        mo, _ = _drop_last_key(torch, fa, q, k, v)
        mut = {"o": _row_ratio(mo, ref, scale_of["o"]).max().item()}
        for n, x in zip(("dq", "dk", "dv"),
                        _drop_last_key(torch, fa, q, k, v, do)):
            mut[n] = _row_ratio(x, want[n], scale_of[n]).max().item()
        for n, w_ in mut.items():
            check(w_ > 1.0, f"flash d64 S={S}: the tolerance passes the "
                            f"dropped-key fault in {n} ({w_:.3g})")
        errs = {n: (x.float() - want[n].float()).abs().max().item()
                for n, x in got.items()}
        pairs = S * S
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * lse.numel()
        bnd, by = bound_ms(nbytes, 4 * D * B * H * pairs, BF16_FLOPS)
        fcase = dict(B=B, H=H, KV=H, D=D, Sq=S, Sk=S, causal=False,
                     max_abs_err=errs["o"], worst_err_over_tol=ratios["o"],
                     lse_worst_err_over_tol=ratios["lse"],
                     mutants={"drop_last_key": mut["o"]},
                     bitwise_repeatable=True,
                     ms=time_ms(lambda: fac.flash_fwd_cuda(q, k, v, False, s),
                                20),
                     plain_ms=time_ms(lambda: fa._flash_fwd_plain(
                         q, k, v, False, s), 2),
                     bound_ms=bnd, bound_by=by,
                     library_ms=time_ms(
                         lambda: F.scaled_dot_product_attention(q, k, v), 20))
        log(f"kernel flash_fwd d64 S={S} B={B} bf16: " + json.dumps(fcase))
        fwd_cases.append(fcase)
        lib = sdpa_backward_ms(torch, q, k, v, do, 10)
        plain_bwd = time_ms(lambda: fa._flash_bwd_plain(
            q, k, v, do, rlse, delta, False, s), 2)
        io = 2 * (2 * q.numel() + k.numel() + v.numel()) + 8 * lse.numel()
        for name, products, outs, keys, fn in (
                ("flash_bwd_dq", 3, dq.numel(), ("dq",),
                 lambda: fac.flash_bwd_dq_cuda(q, k, v, do, rlse, delta,
                                               False, s)),
                ("flash_bwd_dkv", 4, dk.numel() + dv.numel(), ("dk", "dv"),
                 lambda: fac.flash_bwd_dkv_cuda(q, k, v, do, rlse, delta,
                                                False, s))):
            bnd, by = bound_ms(io + 2 * outs, 2 * products * D * B * H * pairs,
                               BF16_FLOPS)
            case = dict(B=B, H=H, KV=H, D=D, S=S, causal=False,
                        max_abs_err=max(errs[n] for n in keys),
                        max_abs_errs={n: errs[n] for n in keys},
                        worst_err_over_tol={n: ratios[n] for n in keys},
                        mutants={"drop_last_key": {n: mut[n] for n in keys}},
                        bitwise_repeatable=True,
                        ms=time_ms(fn, 20), plain_ms=plain_bwd,
                        bound_ms=bnd, bound_by=by, **lib)
            log(f"kernel {name} d64 S={S} B={B} bf16: " + json.dumps(case))
            bwd_cases.append((name, case))
        del q, k, v, do, got, want
    # the tile edges at head dim 64, both GQA group sizes
    for KV in (H, H // 4):
        f, b = _flash_edges(torch, fa, fac, rnd, H, KV, D)
        fwd_cases += f
        bwd_cases += b
    gc.collect()
    torch.cuda.empty_cache()
    return fwd_cases, bwd_cases


# -------------------------------------------------------------- phase 23
def _ernie_config(**kw):
    from paddle_tpu_torch.models.ernie import ErnieConfig

    return ErnieConfig(**{**dict(
        vocab_size=40000, hidden_size=768, num_hidden_layers=ERNIE_LAYERS,
        num_attention_heads=ERNIE_H, intermediate_size=3072,
        max_position_embeddings=2048), **kw})


def _ernie_batch(torch, gen, vocab, S):
    ids = torch.randint(0, vocab, (ERNIE_B, S), generator=gen, device="cuda")
    labels = torch.randint(0, 2, (ERNIE_B,), generator=gen, device="cuda")
    return ids, labels


def _ernie_flops(n_nonembed, S):
    """(6 * N_nonembed * T + 12 * L * H * D * S * T): the weight products
    forward and backward and the non-causal attention products (QK^T and
    PV, 2 * 2 * S * D a token a head, x3 with the backward)."""
    T = ERNIE_B * S
    return 6 * n_nonembed * T + 12 * ERNIE_LAYERS * ERNIE_H * ERNIE_D * S * T


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def train_ernie(torch, ops):
    """Phase 23 (a, b, c): ERNIE-3.0 base finetune on the card, seeded
    random weights, ``model.bfloat16()``, AdamW lr 5e-5 with fp32 master
    weights as phase 7: (a) the recipe, B = 32, S = 128, dropout 0.1 / 0.1
    (attention takes the SDPA reference: its dropout rate keeps it off the
    flash path, as in the JAX package); (b) S = 512 with attention dropout
    0 (the flash kernels at head dim 64); (c) the eval forward
    (``eval_batch``) of each model at its shape. Each cell on the graphed
    engine and on its eager twin, a model of the same seed (weights and
    dropout masks); every step's launches are read and checked."""
    from paddle_tpu_torch.models.ernie import ErnieForSequenceClassification
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ParallelEngine

    gen = torch.Generator(device="cuda").manual_seed(23)
    results = {}
    launches = dict.fromkeys(ops.KERNEL_WRAPPERS, 0)
    for cell, S, attn_drop in (("a", ERNIE_S, 0.1),
                               ("b", ERNIE_LONG_S, 0.0)):
        cfg = _ernie_config(attention_probs_dropout_prob=attn_drop)
        ids, labels = _ernie_batch(torch, gen, cfg.vocab_size, S)
        flash = 0 if attn_drop else ERNIE_LAYERS
        cells, evals = {}, {}
        for mode in ("graphs", "eager"):
            t0 = time.perf_counter()
            model = ErnieForSequenceClassification(cfg, num_classes=2,
                                                   seed=0)
            model.bfloat16()
            opt = AdamW(learning_rate=5e-5,
                        parameters=model.named_parameters(),
                        multi_precision=True)
            eng = ParallelEngine(model, optimizer=opt, loss_fn=model.loss_fn)
            eng.graphs = mode == "graphs"
            torch.cuda.synchronize()
            n_params = sum(p.numel() for p in model.parameters())
            n_tensors = len(list(model.parameters()))
            emb = model.ernie.embeddings
            n_nonembed = n_params - sum(
                t.weight.numel() for t in (emb.word_embeddings,
                                           emb.position_embeddings,
                                           emb.token_type_embeddings))
            log(f"ernie model ({cell}, {mode}): {n_params} params bf16 "
                f"({n_tensors} tensors, {n_nonembed} outside the embedding "
                f"tables) + AdamW fp32 state, made on the card in "
                f"{time.perf_counter() - t0:.1f} s")
            want = {"layer_norm": ERNIE_LN, "flash_fwd": flash,
                    "flash_bwd_dq": flash, "flash_bwd_dkv": flash,
                    "fused_adamw": n_tensors}
            model.train()
            flops = _ernie_flops(n_nonembed, S)
            c = cells[mode] = _train_cell(
                torch, ops, eng, (ids, labels), steps=ERNIE_STEPS,
                warmup=ERNIE_WARMUP, want=want,
                label=f"train ernie ({cell}) B={ERNIE_B} S={S} ({mode})",
                flops=flops, tokens=ERNIE_B * S, examples=ERNIE_B,
                passes=5, repeats=3, exact=True)
            c.update(cell=cell, batch=ERNIE_B, seq=S, layers=ERNIE_LAYERS,
                     hidden_dropout=cfg.hidden_dropout_prob,
                     attention_dropout=attn_drop, params=n_params,
                     params_nonembed=n_nonembed,
                     mfu_formula="(6 * N_nonembed * T + 12 * L * H * D * S "
                                 "* T) / step_s / 989e12, T = B * S, "
                                 "non-causal attention",
                     compute_bound_ms=flops / BF16_FLOPS * 1e3,
                     flops_per_step=flops)
            # the first update lifts the loss (AdamW's first step moves
            # every weight by ~lr at once); it must fall from there: the
            # last four steps' mean below the first four's
            ls = c["losses"]
            check(sum(ls[-4:]) < sum(ls[:4]),
                  f"ernie ({cell}, {mode}): the loss did not fall over "
                  f"{ERNIE_STEPS} steps: {ls}")
            if mode == "graphs":
                for name in launches:
                    launches[name] += c["launches"][name]

            # (c) the eval forward at this cell's shape: no dropout, so
            # attention takes the flash kernels at S = 128 too
            model.eval()
            ev_want = {"layer_norm": ERNIE_LN, "flash_fwd": ERNIE_LAYERS}
            walls = []
            for i in range(ERNIE_STEPS):
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                loss = eng.eval_batch(ids, labels).item()
                walls.append(time.perf_counter() - t0)
                got = ops.launch_counts()
                check({k: n for k, n in got.items() if n} == ev_want,
                      f"ernie eval S={S} ({mode}) pass {i}: launches {got}, "
                      f"want {ev_want}")
                if mode == "graphs":
                    for name in launches:
                        launches[name] += got[name]
            check(loss == loss, f"ernie eval S={S}: loss {loss}")
            ev_s = _median(walls[ERNIE_WARMUP:])
            dev = _step_device(torch, eng,
                               lambda: eng.eval_batch(ids, labels), 2, 5, 3)
            ev = dict(cell="c", seq=S, batch=ERNIE_B, graphs=eng.graphs,
                      ms_per_forward=ev_s * 1e3,
                      tokens_per_s=ERNIE_B * S / ev_s,
                      examples_per_s=ERNIE_B / ev_s,
                      mfu=flops / 3 / ev_s / BF16_FLOPS,
                      device_ms_per_forward=dev.pop("device_ms"), **dev,
                      replays=dict(eng.replays), captures=eng.captures,
                      launches_per_forward=ev_want, loss=loss)
            ev["busy_share"] = (None if ev["device_ms_per_forward"] is None
                                else ev["device_ms_per_forward"]
                                / ev["ms_per_forward"])
            if mode == "graphs":
                check(eng.replays["eval"] >= ERNIE_STEPS - 1,
                      f"ernie eval S={S}: {eng.replays['eval']} replays")
            log(f"eval ernie S={S} ({mode}): " + json.dumps(ev))
            evals[mode] = ev
            del eng, opt, model
            _free(torch)
        results[cell] = _twins(f"train ernie ({cell})", cells["graphs"],
                               cells["eager"])
        results[f"c{S}"] = dict(graphs=evals["graphs"], eager=evals["eager"])
        del ids, labels
    results["launches"] = launches
    return results


# the drift check's batch: 4 x the recipe's, so that the per-example
# losses and the eval logits held below are 128 and 256 values (the
# recipe's 32 examples give its 2-class head too few for a ratio of two
# rounding errors to settle); gradients are held over every tensor and
# tensor by tensor where a tensor has at least DRIFT_MIN_NUMEL elements
DRIFT_B = 128
DRIFT_MIN_NUMEL = 65536


def ernie_end_to_end(torch, ops):
    """Phase 23 (drift): 2 layers at full width, dropout 0, B = DRIFT_B at
    S = 128 and 512 (both take the flash and LayerNorm kernels): the
    per-example losses and every gradient with the kernels and with the
    plain versions in bf16, and with the plain versions on an fp32 copy of
    the same weights, under phase 8's rule; the eval outputs (the encoder's
    sequence output and the logits) under phase 5's."""
    import copy

    from paddle_tpu_torch.models.ernie import ErnieForSequenceClassification
    from paddle_tpu_torch.nn import functional as F

    cfg = _ernie_config(num_hidden_layers=E2E_LAYERS, hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0)
    gen = torch.Generator(device="cuda").manual_seed(24)
    torch.backends.cuda.matmul.allow_tf32 = False
    m32 = ErnieForSequenceClassification(cfg, seed=1)
    m16 = copy.deepcopy(m32).bfloat16()
    with torch.no_grad():
        for p32, p16 in zip(m32.parameters(), m16.parameters()):
            p32.copy_(p16)                  # exact widening of bf16

    def run(m, mode, ids, labels):
        ops.set_kernel_mode(mode)
        m.train()
        for p in m.parameters():
            p.requires_grad_(True)
            p.grad = None
        per_example = F.cross_entropy(m(ids), labels, reduction="none")
        per_example.mean().backward()
        grads = {n: p.grad.float() for n, p in m.named_parameters()
                 if p.grad is not None}
        for p in m.parameters():
            p.grad = None
        m.eval()
        with torch.no_grad():
            seq, pooled = m.ernie(ids)
            logits = m.classifier(pooled)
        ops.set_kernel_mode("auto")
        return (per_example.detach().float(), grads, seq.float(),
                logits.float())

    def rms(t):
        return t.square().mean().sqrt().item()

    out = {}
    for S in (ERNIE_S, ERNIE_LONG_S):
        ids = torch.randint(0, cfg.vocab_size, (DRIFT_B, S), generator=gen,
                            device="cuda")
        labels = torch.randint(0, 2, (DRIFT_B,), generator=gen,
                               device="cuda")
        lk, gk, sk, zk = run(m16, "auto", ids, labels)
        lp, gp, sp, zp = run(m16, "reference", ids, labels)
        lf, gf, sf, zf = run(m32, "reference", ids, labels)
        per = {}
        tk = tp = 0.0
        for n in gf:
            dk2 = (gk[n] - gf[n]).square().sum().item()
            dp2 = (gp[n] - gf[n]).square().sum().item()
            tk, tp = tk + dk2, tp + dp2
            per[n] = (dk2 / max(dp2, 1e-300)) ** 0.5
        held = {n: r for n, r in per.items()
                if gf[n].numel() >= DRIFT_MIN_NUMEL}
        worst = max(held, key=held.get)
        res = dict(S=S, B=DRIFT_B, layers=E2E_LAYERS,
                   loss_kernels=lk.mean().item(),
                   loss_plain_bf16=lp.mean().item(),
                   loss_fp32=lf.mean().item(),
                   loss_drift_ratio=rms(lk - lf) / rms(lp - lf),
                   mean_loss_drift_ratio=abs((lk - lf).mean().item())
                   / max(abs((lp - lf).mean().item()), 1e-30),
                   grad_drift_ratio_all=(tk / tp) ** 0.5,
                   grad_drift_ratio_worst=held[worst],
                   grad_drift_worst_tensor=worst,
                   grad_drift_ratio_median=_median(list(held.values())),
                   small_tensor_ratios={n: r for n, r in per.items()
                                        if n not in held})
        for what, (k, p, f) in (("seq_out", (sk, sp, sf)),
                                ("logits", (zk, zp, zf))):
            res[what] = dict(
                drift_ratio_max=(k - f).abs().max().item()
                / (p - f).abs().max().item(),
                drift_ratio_rms=rms(k - f) / rms(p - f),
                gap_fraction=rms(k - p) / rms(f),
                kernels_vs_fp32_rms=rms(k - f), plain_vs_fp32_rms=rms(p - f),
                rms=rms(f))
        log(f"ernie end_to_end S={S} kernels vs plain vs fp32: "
            + json.dumps(res))
        for key in ("loss_drift_ratio", "grad_drift_ratio_all",
                    "grad_drift_ratio_worst"):
            check(res[key] <= DRIFT_RATIO, f"ernie end to end S={S}: {key} "
                  f"{res[key]:.3g} > {DRIFT_RATIO} ({worst})")
        # phase 5's rule in full on the sequence output (B x S x 768
        # values); on the 256 logits the rms ratio and the gap (their
        # largest error is one draw of a few hundred)
        for what, keys in (("seq_out", ("drift_ratio_max",
                                        "drift_ratio_rms")),
                           ("logits", ("drift_ratio_rms",))):
            for key in keys:
                check(res[what][key] <= DRIFT_RATIO,
                      f"ernie end to end S={S}: eval {what} {key} "
                      f"{res[what][key]:.3g} > {DRIFT_RATIO}")
            check(res[what]["gap_fraction"] <= GAP_FRACTION,
                  f"ernie end to end S={S}: eval {what} gap "
                  f"{res[what]['gap_fraction']:.3g} > {GAP_FRACTION}")
        out[S] = res
        del gk, gp, gf, sk, sp, sf
        gc.collect()
        torch.cuda.empty_cache()
    del m32, m16
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -------------------------------------------------------------- phase 27
PARITY_STEPS = 4
# phase 27's limit on the graphed ERNIE (a) step: its host wall (the call
# to the loss read back) over its device time, the serving graphs' limit
# (phase 24)
TRAIN_GRAPH_WALL_RATIO = GRAPH_WALL_RATIO


def _snapshot(eng):
    """Device copies of every parameter and optimizer slot of ``eng``."""
    out = {n: p.detach().clone() for n, p in eng.named}
    for n, slots in eng.optimizer._accumulators.items():
        for k, t in slots.items():
            out[f"{n}.{k}"] = t.detach().clone()
    return out


def _parity_cell(torch, ops, label, make, batch, timed=False, check_fn=None):
    """``PARITY_STEPS`` steps of an eager engine and of a graphed one, each
    from ``make()`` (the same seeded weights, fresh optimizer state): the
    losses, the parameters and every optimizer slot must be equal bit for
    bit, and the launches too; else the largest difference is named. With
    ``timed``, the graphed step's host wall (median of 8 steps read back)
    over its device time (events around 5 replays) is measured."""
    out, snaps = {}, {}
    for mode in ("eager", "graphs"):
        eng = make()
        eng.graphs = mode == "graphs"
        ops.reset_launch_counts()
        losses = [eng.train_batch(*batch).item()
                  for _ in range(PARITY_STEPS)]
        out[mode] = dict(losses=losses, launches={
            k: n for k, n in ops.launch_counts().items() if n},
            replays=dict(eng.replays), captures=eng.captures)
        if check_fn is not None:
            out[mode].update(check_fn(eng))
        snaps[mode] = _snapshot(eng)
        if mode == "graphs":
            check(eng.captures == 1 and eng.replays["train"]
                  == PARITY_STEPS - 1, f"phase 27 {label}: "
                  f"{eng.replays['train']} replays, {eng.captures} captures")
            if timed:
                walls = []
                for _ in range(8):
                    t0 = time.perf_counter()
                    eng.train_batch(*batch).item()
                    walls.append(time.perf_counter() - t0)
                dev = _replayed_ms(torch, lambda: eng.train_batch(*batch),
                                   5, 3)
                out["graphed_wall_ms"] = _median(walls) * 1e3
                out["graphed_device_ms"] = dev
                out["wall_over_device"] = out["graphed_wall_ms"] / dev
        del eng
        _free(torch)
    diffs = {}
    for k, a in snaps["graphs"].items():
        b = snaps["eager"][k]
        if not torch.equal(a, b):
            diffs[k] = (a.float() - b.float()).abs().max().item()
    worst = max(diffs, key=diffs.get) if diffs else None
    out.update(losses_bitwise_equal=out["graphs"]["losses"]
               == out["eager"]["losses"],
               tensors=len(snaps["eager"]), tensors_differing=len(diffs),
               max_abs_diff=diffs.get(worst, 0.0), worst_tensor=worst)
    del snaps
    _free(torch)
    log(f"phase 27 {label}: " + json.dumps(out))
    check(out["graphs"]["launches"] == out["eager"]["launches"],
          f"phase 27 {label}: launches differ, graphs "
          f"{out['graphs']['launches']} eager {out['eager']['launches']}")
    check(out["losses_bitwise_equal"] and not diffs,
          f"phase 27 {label}: graphed and eager steps differ: losses "
          f"{out['graphs']['losses']} vs {out['eager']['losses']}, "
          f"{len(diffs)} tensors, largest |diff| {out['max_abs_diff']:.3g} "
          f"in {worst}")
    return out


def _dropout_model(torch):
    """A model of one checkpointed layer that draws from the default CUDA
    generator (a dropout mask on a product): phase 27's check that a
    region's recompute draws its forward's mask, eagerly and in a graph.
    Each run of the layer keeps a copy of its mask in ``seen`` (a graph's
    copies are refilled by every replay), taken before the op that saves
    it for the backward: the recompute stops early after that op."""
    from paddle_tpu_torch.distributed.fleet.recompute import layer_checkpoint

    class DropoutModel(torch.nn.Module):
        def __init__(self):
            super().__init__()
            g = torch.Generator(device="cuda").manual_seed(27)
            self.w = torch.nn.Parameter((0.03 * torch.randn(
                1024, 1024, generator=g, device="cuda")).bfloat16())
            self.seen = []

        def layer(self, x):
            h = x @ self.w
            keep = torch.rand(h.shape, device=h.device) >= 0.1
            self.seen.append(keep.clone())
            return h * keep / 0.9

        def forward(self, x, y):
            run = layer_checkpoint()
            h = self.layer(x) if run is None else run(self.layer, x)
            return (h.float() - y.float()).square().mean()

    return DropoutModel()


def train_graph_parity(torch, ops):
    """Phase 27: the graphed engine against the eager one (``graphs =
    False``), 4 steps each from the same weights and seeds, bit for bit
    (:func:`_parity_cell`): (a) Llama-3-8B width, 2 layers, B = 2 x S =
    2048, ``ClipGradByGlobalNorm``, ``grad_accum=2``, ``LinearWarmup`` ->
    ``CosineAnnealingDecay``; (b) ERNIE (a), dropout 0.1 / 0.1, with the
    graphed step's host wall over its device time held to
    TRAIN_GRAPH_WALL_RATIO; (c) Llama as (a) under ``remat=True,
    remat_policy="dots"``; (d) a checkpointed dropout layer under
    ``remat_policy="nothing"``: each recompute draws its forward's mask."""
    from paddle_tpu_torch.models.ernie import ErnieForSequenceClassification
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama3_8b_config)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW, lr
    from paddle_tpu_torch.parallel import ParallelEngine

    res = {}
    cfg = llama3_8b_config(num_hidden_layers=E2E_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(27)
    tok = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1),
                        generator=gen, device="cuda")
    llama_batch = (tok[:, :-1].contiguous(), tok[:, 1:].contiguous())

    def llama(**kw):
        def make():
            m = LlamaForCausalLM(cfg, seed=3)
            sched = lr.LinearWarmup(lr.CosineAnnealingDecay(3e-4, T_max=10),
                                    warmup_steps=2, start_lr=3e-5,
                                    end_lr=3e-4)
            opt = AdamW(learning_rate=sched,
                        parameters=m.named_parameters(), weight_decay=0.01,
                        multi_precision=True,
                        grad_clip=ClipGradByGlobalNorm(1.0))
            return ParallelEngine(m, optimizer=opt, **kw)
        return make

    res["llama_clip_accum2_schedule"] = _parity_cell(
        torch, ops, "(a) llama clip grad_accum=2 schedule",
        llama(grad_accum=2), llama_batch)

    ecfg = _ernie_config(attention_probs_dropout_prob=0.1)
    ernie_batch = _ernie_batch(torch, gen, ecfg.vocab_size, ERNIE_S)

    def ernie():
        m = ErnieForSequenceClassification(ecfg, num_classes=2, seed=0)
        m.bfloat16()
        opt = AdamW(learning_rate=5e-5, parameters=m.named_parameters(),
                    multi_precision=True)
        return ParallelEngine(m, optimizer=opt, loss_fn=m.loss_fn)

    e = res["ernie_a_dropout"] = _parity_cell(
        torch, ops, "(b) ernie (a) dropout 0.1 / 0.1", ernie, ernie_batch,
        timed=True)
    check(e["wall_over_device"] <= TRAIN_GRAPH_WALL_RATIO,
          f"phase 27: the graphed ERNIE (a) step's host wall "
          f"{e['graphed_wall_ms']:.3f} ms is {e['wall_over_device']:.3f} x "
          f"its device time (limit {TRAIN_GRAPH_WALL_RATIO})")

    res["llama_remat_dots"] = _parity_cell(
        torch, ops, "(c) llama remat dots", llama(remat=True,
                                                  remat_policy="dots"),
        llama_batch)

    x = torch.randn(256, 1024, generator=gen, device="cuda").bfloat16()
    y = torch.randn(256, 1024, generator=gen, device="cuda").bfloat16()

    def dropout_model():
        m = _dropout_model(torch)
        return ParallelEngine(m, optimizer=AdamW(
            learning_rate=1e-3, parameters=m.named_parameters(),
            multi_precision=True), remat=True, remat_policy="nothing")

    def masks_equal(eng):
        # the last run's forward and recompute copies (a graph's: the
        # capture's two, refilled by the last replay)
        fwd, rec = eng.model.seen[-2:]
        return dict(recompute_equals_forward=bool(torch.equal(fwd, rec)),
                    dropped_share=(~fwd).float().mean().item())

    d = res["dropout_remat"] = _parity_cell(
        torch, ops, "(d) checkpointed dropout, remat nothing",
        dropout_model, (x, y), check_fn=masks_equal)
    for mode in ("eager", "graphs"):
        check(d[mode]["recompute_equals_forward"], f"phase 27 (d) {mode}: "
              f"the recompute drew another dropout mask than the forward")
        check(0.05 < d[mode]["dropped_share"] < 0.15,
              f"phase 27 (d) {mode}: dropped share "
              f"{d[mode]['dropped_share']:.3f}, want ~0.1")
    log("phase 27, graphed against eager training: " + json.dumps(res))
    return res


# -------------------------------------------------------------- phase 32
# the finetune phase: Llama-3-8B at full width and depth, LoRA rank 8 on
# the seven default targets (alpha 16), B = 2 x 2048 tokens, one fixed
# seeded batch; phase 4's prompts served through the trained adapter
FT_LAYERS, FT_B, FT_S, FT_STEPS, FT_WARMUP = 32, 2, 2048, 8, 2
FT_RANK, FT_ALPHA, FT_LR, FT_SEED = 8, 16.0, 2e-4, 32
FT_SERVE_LENS = (100, 256, 517, 1000)
FT_NEW = 24
# (c): 3 graphed steps (warm-up, capture, replay); (d) at 6 layers (2.36e9
# elements, still past 2^31 in one launch; phase 7's 8 until phase 38
# needed the time); (e) phase 19's cell, S = 16384 on its layers; (f) at 2
# layers
OFF_STEPS, FLAT_LAYERS, OA_S, AMP_LAYERS = 3, 6, 16384, 2
# (c)'s full offloaded finetune: at most this depth (all 32 layers pinned
# 59.8 GiB in 32.4 s, 12 layers 27.3 GiB in 13.5 s; 8 paid for phase 35's
# time, 4 for phase 38's)
OFF_FULL_LAYERS = 4
# host memory the offloaded cell leaves free beside its pinned moments
OFF_HOST_MARGIN = 16 * 2 ** 30


def _ft_want(L, n_tensors, remat=True):
    """Launches a training step makes: the flash forward again in each
    layer's recompute, RMSNorm twice a layer (and again in the recompute)
    plus the final norm, AdamW once a trained tensor (or once, flat)."""
    return {"flash_fwd": 2 * L if remat else L, "flash_bwd_dq": L,
            "flash_bwd_dkv": L, "rms_norm": 4 * L + 1 if remat
            else 2 * L + 1, "fused_adamw": n_tensors}


def _ft_batch(torch, vocab, B, S, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tok = torch.randint(0, vocab, (B, S + 1), generator=gen, device="cuda")
    return tok[:, :-1].contiguous(), tok[:, 1:].contiguous()


def _base_unchanged(torch, model, seed):
    """Every non-LoRA parameter of ``model`` equal, bit for bit, to what
    ``reset_parameters(seed)`` draws: the draws made again one tensor at a
    time in the same order from the same generator. Returns the count."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = 0
    for name, p in model.named_parameters():
        if name.endswith(("lora_A", "lora_B")):
            continue
        ref = torch.empty_like(p)
        if name.endswith("norm.weight"):
            ref.fill_(1.0)
        else:
            ref.normal_(0.0, 0.02, generator=g)
        check(torch.equal(ref, p), f"phase 32 (a): base weight {name} "
                                   f"changed in training")
        n += 1
        del ref
    return n


def _unwrapped(model):
    """The LoRA wraps of ``model`` taken off (the plain projections put
    back, nothing merged): [(owner, attribute, wrap)], to put back."""
    from paddle_tpu_torch.nn.lora import LoRALinear

    wraps = [(m, k, c) for m in model.modules()
             for k, c in list(m._modules.items())
             if isinstance(c, LoRALinear)]
    for m, k, c in wraps:
        setattr(m, k, c.base)
    return wraps


def finetune_lora(torch, ops):
    """Phase 32 (a): the LoRA finetune at full width and depth; returns
    (result, model)."""
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama3_8b_config)
    from paddle_tpu_torch.nn.lora import lora_parameters
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ParallelEngine

    cfg = llama3_8b_config(lora_rank=FT_RANK, lora_alpha=FT_ALPHA)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, seed=FT_SEED)
    torch.cuda.synchronize()
    factors = lora_parameters(model)
    n_factors = sum(p.numel() for p in factors)
    n_params = sum(p.numel() for p in model.parameters()) - n_factors
    n_nonembed = n_params - model.model.embed_tokens.weight.numel()
    log(f"phase 32 (a) model: llama3-8b, {FT_LAYERS} layers, {n_params} "
        f"base params bf16 (frozen), LoRA rank {FT_RANK} on 7 targets: "
        f"{len(factors)} fp32 factors, {n_factors} elements, made in "
        f"{time.perf_counter() - t0:.1f} s")
    ids, labels = _ft_batch(torch, cfg.vocab_size, FT_B, FT_S, 33)
    opt = AdamW(learning_rate=FT_LR, parameters=factors)
    eng = ParallelEngine(model, optimizer=opt, remat=True,
                         remat_policy="dots")
    check(len(eng.trained) == len(factors), "phase 32 (a): the engine "
          "trains more than the factors")
    tokens = FT_B * FT_S
    L, H, D = FT_LAYERS, cfg.num_attention_heads, cfg.head_dim
    # the projections: forward 2NT, the gradient into the frozen base's
    # input 2NT (no weight gradient), the dots policy's recompute saves
    # the products; causal attention forward, recompute and backward
    flops = 4 * n_nonembed * tokens + 8 * L * H * D * FT_S * tokens
    want = _ft_want(L, len(factors))
    ops.reset_launch_counts()
    res = _train_cell(torch, ops, eng, (ids, labels), steps=FT_STEPS,
                      warmup=FT_WARMUP, want=want,
                      label="phase 32 (a) lora finetune llama3-8b "
                            "(32 layers)", flops=flops, tokens=tokens,
                      prof_steps=1, passes=2, repeats=1)
    ls = res["losses"]
    check(ls[-1] < ls[0], f"phase 32 (a): the loss did not fall: {ls}")
    # the learning rate moves without a new capture
    caps = eng.captures
    opt.set_lr(FT_LR / 2)
    lr_loss = eng.train_batch(ids, labels).item()
    check(eng.captures == caps and float(eng._lr_dev) == torch.tensor(
        FT_LR / 2, dtype=torch.float32).item(),
          "phase 32 (a): set_lr recaptured or did not reach the device")
    moved = sum(int(bool((p != 0).any())) for p in factors
                if p.shape[0] == FT_RANK)
    check(moved == len(factors) // 2, f"phase 32 (a): {moved} of "
          f"{len(factors) // 2} lora_B factors moved")
    res.update(layers=L, batch=FT_B, seq=FT_S, rank=FT_RANK,
               alpha=FT_ALPHA, base_params=n_params,
               base_params_nonembed=n_nonembed, factor_params=n_factors,
               factor_tensors=len(factors), remat_policy="dots",
               loss_after_set_lr=lr_loss,
               mfu_formula="(4 * N_nonembed * T + 8 * L * H * D * S * T) / "
                           "step_s / 989e12: the frozen projections' "
                           "forward and input gradient (no weight "
                           "gradient), causal attention's forward, "
                           "recompute and backward; the LoRA factors' "
                           "products and the recomputed projections are "
                           "not counted",
               flops_per_step=flops,
               optimizer_state_bytes=sum(
                   t.numel() * 4 for s in opt._accumulators.values()
                   for t in s.values()),
               base_weights_unchanged=_base_unchanged(torch, model,
                                                      FT_SEED),
               lora_b_moved=moved)
    del eng, opt
    _free(torch)
    return res, model


def finetune_serve(torch, ops, model, tmp):
    """Phase 32 (b): the trained adapter exported, loaded and served
    through the paged server on the unmerged base (fused LoRA, row 12;
    paged attention, row 11), against ``merge_lora``'s model served
    plain; the fused LoRA kernel at the trained factors against its plain
    twin."""
    import dataclasses as dc

    from paddle_tpu_torch.inference.lora import (AdapterRegistry,
                                                 LoRAConfig)
    from paddle_tpu_torch.inference.serving import GenerationServer
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.nn import lora as tl
    from paddle_tpu_torch.ops.fused_lora_cuda import fused_lora_matmul_cuda

    cfg = model.cfg
    path = os.path.join(tmp, "adapter.npz")
    t0 = time.perf_counter()
    tl.export_adapter(model, path)
    state = tl.load_adapter(path)
    reg = AdapterRegistry()
    reg.register("tuned", state)
    t_export = time.perf_counter() - t0
    prompts, _ = phase4_traffic(cfg)
    prompts = [prompts[PHASE4_LENS.index(n)] for n in FT_SERVE_LENS]
    kw = dict(cache="paged", max_batch=len(prompts), max_len=MAX_LEN,
              block_size=BLOCK_SIZE, prefill_chunk=PREFILL_CHUNK)
    wraps = _unwrapped(model)

    def run(srv, adapter):
        rids = [srv.submit(p, max_new_tokens=FT_NEW, adapter=adapter)
                for p in prompts]
        out = srv.run()
        return [out[r][len(p):] for r, p in zip(rids, prompts)]

    srv = GenerationServer(model, lora=LoRAConfig(reg, max_live_adapters=1,
                                                  max_rank=FT_RANK), **kw)
    run(srv, "tuned")                   # the graphs' warm-up and capture
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = run(srv, "tuned")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    check(launches["fused_lora_matmul"] > 0 and
          launches["paged_attention"] > 0, f"phase 32 (b): the adapter "
          f"was not served through rows 11 and 12: {launches}")
    # row 12 at the trained factors: the pool's page of "tuned", layer 5
    pool = srv._lora
    page = pool.acquire("tuned")
    g = torch.Generator(device="cuda").manual_seed(32)
    kernel = {}
    ai = torch.full((MAX_BATCH,), page, dtype=torch.int32, device="cuda")
    factors = pool.layer_factors(ai)[5]
    layer = model.model.layers[5]
    for t, w in (("q", layer.self_attn.q_proj.weight),
                 ("gate", layer.mlp.gate_proj.weight),
                 ("down", layer.mlp.down_proj.weight)):
        pooled = factors[t]
        K = w.shape[0]
        x = torch.randn(MAX_BATCH, 1, K, generator=g, device="cuda").to(
            torch.bfloat16)
        out = fused_lora_matmul_cuda(x, w, pooled.a, pooled.b, pooled.scale,
                                     pooled.layer, pooled.aidx)
        Ag, Bg, sg = pooled.gather()
        ref = tl._lora_plain(x, w, Ag, Bg, sg)
        mag = (x.float().abs() @ w.float().abs()
               + torch.bmm(torch.bmm(x.float(), Ag).abs(), Bg.abs())
               * sg[:, None, None])
        worst = _el_ratio(out, ref, mag, K).max().item()
        check(worst <= 1.0, f"phase 32 (b): fused LoRA {t} at the trained "
                            f"factors off by {worst:.3g} x its tolerance")
        delta = tl.bgmv(x, pooled).float().abs().max().item()
        kernel[t] = dict(max_abs_err=(out.float() - ref.float()).abs()
                         .max().item(), worst_err_over_tol=worst,
                         max_abs_delta=delta)
        del x, out, ref, mag
    pool.release(page)
    del srv, pool
    _free(torch)
    for m, k, c in wraps:
        setattr(m, k, c)
    model.merge_lora()
    ref_srv = GenerationServer(model, **kw)
    run(ref_srv, None)
    want = run(ref_srv, None)
    del ref_srv
    _free(torch)
    same = sum(a == b for a, b in zip(got, want))
    res = dict(prompts=list(FT_SERVE_LENS), new_tokens=FT_NEW,
               export_load_register_s=t_export, adapter_file_bytes=
               os.path.getsize(path), requests_identical=same,
               requests=len(prompts), serve_wall_s=wall,
               tokens_per_s=len(prompts) * FT_NEW / wall,
               launches=launches, fused_lora_at_trained_factors=kernel)
    if same < len(prompts):
        # phase 31's near-tie rule on an fp32 copy of the merged weights
        torch.backends.cuda.matmul.allow_tf32 = False
        m32 = LlamaForCausalLM(dc.replace(cfg, dtype="float32", lora_rank=0),
                               device="cuda")
        with torch.no_grad():
            for p32, p16 in zip(m32.parameters(), model.parameters()):
                p32.copy_(p16)
        err = _logit_error(
            torch, ops, lambda ids: model.head(model.model(ids))[0],
            lambda ids: m32.head(m32.model(ids))[0], prompts[:2])
        tie = 2 * err
        same_, rows, ok = near_ties(
            torch, ops, m32, [p + a for p, a in zip(prompts, got)],
            [p + b for p, b in zip(prompts, want)], tie)
        res.update(kernels_vs_fp32_max=err, near_tie_bound=tie,
                   differing=rows, near_ties_within_bound=ok)
        del m32
        _free(torch)
        check(ok, f"phase 32 (b): the adapter's tokens differ from the "
                  f"merged model's outside the near-tie bound {tie}: {rows}")
    log("phase 32 (b) serve the trained adapter: " + json.dumps(res))
    return res


def _copy_rates(torch, nbytes=2 ** 30, repeats=3):
    """Pinned host <-> device copy rates (GB/s, best of ``repeats``) of an
    ``nbytes`` buffer, each way alone."""
    from paddle_tpu_torch.graphs import pinned_zeros

    host = pinned_zeros((nbytes,), torch.uint8)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    rates = {}
    for name, fn in (("h2d", lambda: dev.copy_(host, non_blocking=True)),
                     ("d2h", lambda: host.copy_(dev, non_blocking=True))):
        best = float("inf")
        for _ in range(repeats):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            best = min(best, a.elapsed_time(b) / 1e3)
        rates[name] = nbytes / best / 1e9
    del host, dev
    return rates


def _host_memory():
    """(MemAvailable bytes, ``ulimit -l`` as text)."""
    avail = None
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                avail = int(line.split()[1]) * 1024
    p = subprocess.run(["bash", "-c", "ulimit -l"], capture_output=True,
                       text=True, timeout=30)
    return avail, p.stdout.strip()


def _snapshot_params(torch, named, host=False):
    return {n: (p.detach().cpu() if host else p.detach().clone())
            for n, p in named}


def finetune_offload(torch, ops):
    """Phase 32 (c): ``offload_opt_state`` — at 2 layers, 3 steps against
    the resident engine, parameters and moments bit for bit; then the
    full finetune (every parameter) at ``OFF_FULL_LAYERS`` layers, or the
    deepest depth below it whose moments fit in pinned host memory, 3
    graphed steps."""
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama3_8b_config)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ParallelEngine

    res = {}
    cfg2 = llama3_8b_config(num_hidden_layers=2)
    ids2, labels2 = _ft_batch(torch, cfg2.vocab_size, 1, FT_S, 34)
    runs = {}
    for mode in ("resident", "offloaded"):
        m = LlamaForCausalLM(cfg2, seed=3)
        opt = AdamW(learning_rate=1e-4, parameters=m.named_parameters())
        eng = ParallelEngine(m, optimizer=opt, remat=True,
                             remat_policy="nothing",
                             offload_opt_state=mode == "offloaded")
        losses = [eng.train_batch(ids2, labels2).item()
                  for _ in range(OFF_STEPS)]
        runs[mode] = (losses, _snapshot_params(torch, eng.named),
                      {n: {k: v.to("cuda") for k, v in s.items()}
                       for n, s in opt._accumulators.items()},
                      eng.captures)
        del eng, opt, m
        _free(torch)
    (rl, rp, rs, _), (ol, op, os_, caps) = runs["resident"], \
        runs["offloaded"]
    check(caps == 1, f"phase 32 (c): the offloaded engine captured {caps} "
                     f"graphs")
    check(rl == ol, f"phase 32 (c): offloaded losses {ol} != resident {rl}")
    bad = [n for n in rp if not torch.equal(rp[n], op[n])] + \
        [f"{n}.{k}" for n in rs for k in rs[n]
         if not torch.equal(rs[n][k], os_[n][k])]
    check(not bad, f"phase 32 (c): offloaded parameters or moments differ "
                   f"from the resident run's: {bad[:5]}")
    res["two_layers"] = dict(losses=ol, bitwise_equal=True,
                             tensors_compared=len(rp) + sum(
                                 len(s) for s in rs.values()))
    del runs, rp, op, rs, os_
    _free(torch)

    # the full finetune at the deepest depth that fits
    avail, memlock = _host_memory()
    full = llama3_8b_config()
    per_layer = (2 * full.hidden_size * (full.hidden_size + full.hidden_size
                                         // full.num_attention_heads
                                         * full.num_key_value_heads)
                 + 3 * full.hidden_size * full.intermediate_size
                 + 2 * full.hidden_size)
    fixed = 2 * full.vocab_size * full.hidden_size + full.hidden_size
    depth = OFF_FULL_LAYERS
    while depth > 1 and 8 * (fixed + depth * per_layer) + OFF_HOST_MARGIN \
            > avail:
        depth -= 1
    reason = (f"MemAvailable {avail / 2 ** 30:.1f} GiB, ulimit -l "
              f"{memlock}: {depth} layers need "
              f"{8 * (fixed + depth * per_layer) / 2 ** 30:.1f} GiB pinned "
              f"(8 bytes of AdamW moments a parameter) + a "
              f"{OFF_HOST_MARGIN / 2 ** 30:.0f} GiB margin")
    log(f"phase 32 (c) offloaded full finetune depth {depth}: {reason}")
    rates = _copy_rates(torch)
    cfg = llama3_8b_config(num_hidden_layers=depth)
    model = LlamaForCausalLM(cfg, seed=4)
    opt = AdamW(learning_rate=1e-5, parameters=model.named_parameters())
    t0 = time.perf_counter()
    eng = ParallelEngine(model, optimizer=opt, remat=True,
                         remat_policy="nothing", offload_opt_state=True)
    t_pin = time.perf_counter() - t0
    off = eng._offload
    ids, labels = _ft_batch(torch, cfg.vocab_size, FT_B, FT_S, 35)
    n_tensors = len(eng.trained)
    want = _ft_want(depth, n_tensors)
    losses, walls, launches, peak = _timed_steps(
        torch, ops, eng, (ids, labels), OFF_STEPS, want,
        f"phase 32 (c) offloaded full finetune ({depth} layers)")
    check(eng.captures == 1 and eng.replays["train"] == OFF_STEPS - 1,
          f"phase 32 (c): {eng.captures} captures, {eng.replays} replays")
    # one profiled step: its busy time and classes (a replay timed with
    # events would cost another 3 s step)
    busy, prof_wall, classes, _ = _device_busy(
        torch, lambda: eng.train_batch(ids, labels).item(), 1)
    dev = dict(device_ms=None if busy is None else busy * 1e3,
               device_ms_from="torch.profiler busy time of one replay",
               busy_share_profiled=None if busy is None else busy / prof_wall,
               device_ms_by_class={c: t * 1e3 for c, t in sorted(
                   classes.items(), key=lambda kv: -kv[1])})
    moved = off.bytes_per_step()
    bound_s = max(moved / (rates["h2d"] * 1e9), moved / (rates["d2h"] * 1e9))
    step_s = walls[-1]
    res["full"] = dict(
        layers=depth, depth_reason=reason, params=sum(
            p.numel() for _, p in eng.trained), tensors=n_tensors,
        pinned_host_gib=off.host_bytes / 2 ** 30,
        staging_gib=off.staging_bytes / 2 ** 30, window=off.window,
        setup_s=t_pin, losses=losses, step_walls_s=walls,
        ms_per_step=step_s * 1e3, tokens_per_s=FT_B * FT_S / step_s,
        peak_memory_gib=peak, copy_gb_per_s=rates,
        bytes_each_way_per_step=moved,
        pcie_bound_ms=bound_s * 1e3,
        pcie_bound_formula="moment bytes each way a step / the slower "
                           "direction's measured pinned copy rate (the two "
                           "directions overlap)",
        step_over_pcie_bound=step_s / bound_s, launches_per_step=want,
        **dev)
    check(all(x == x for x in losses), f"phase 32 (c): non-finite loss "
                                       f"{losses}")
    log("phase 32 (c) offload_opt_state: " + json.dumps(res))
    del eng, opt, model, off
    _free(torch)
    return res


def finetune_flat(torch, ops):
    """Phase 32 (d): the flat multi-tensor AdamW (``PT_MT_ADAMW=1``) at
    ``FLAT_LAYERS`` layers (past 2^31 elements): 3 graphed steps,
    parameters bit for bit the per-tensor path's; AdamW device ms and
    launches a step both ways; the flat launch against its byte bound."""
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama3_8b_config)
    from paddle_tpu_torch.ops.fused_adamw import fused_adamw_update
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ParallelEngine

    cfg = llama3_8b_config(num_hidden_layers=FLAT_LAYERS)
    ids, labels = _ft_batch(torch, cfg.vocab_size, FT_B, FT_S, 36)
    res, params = {}, {}
    for mode in ("per_tensor", "flat"):
        os.environ["PT_MT_ADAMW"] = "1" if mode == "flat" else "0"
        try:
            model = LlamaForCausalLM(cfg, seed=5)
            opt = AdamW(learning_rate=1e-4,
                        parameters=model.named_parameters())
            eng = ParallelEngine(model, optimizer=opt)
        finally:
            os.environ.pop("PT_MT_ADAMW", None)
        n = len(eng.trained)
        want = _ft_want(FLAT_LAYERS, 1 if mode == "flat" else n,
                        remat=False)
        losses, walls, launches, peak = _timed_steps(
            torch, ops, eng, (ids, labels), OFF_STEPS, want,
            f"phase 32 (d) {mode} AdamW ({FLAT_LAYERS} layers)")
        params[mode] = {k: p.detach().cpu() for k, p in eng.named}
        dev = _step_device(torch, eng, lambda: eng.train_batch(ids, labels),
                           1, 1, 1)
        res[mode] = dict(losses=losses, ms_per_step=walls[-1] * 1e3,
                         peak_memory_gib=peak,
                         adamw_launches_per_step=want["fused_adamw"],
                         adamw_device_ms=dev["device_ms_by_class"].get(
                             "fused_adamw"), **dev)
        if mode == "flat":
            mt = opt._accumulators["__mt__"]
            numel = mt["p"].numel()
            check(numel >= 2 ** 31, f"phase 32 (d): the flat state has "
                                    f"{numel} elements, under 2^31")
            scal = opt._begin(torch.tensor(1e-4, device="cuda"),
                              torch.tensor(OFF_STEPS + 9, device="cuda"))
            ms = time_ms(lambda: fused_adamw_update(
                mt["p"], opt._mt_grad, mt["moment1"], mt["moment2"],
                scalars=scal, b1=opt._beta1, b2=opt._beta2,
                eps=opt._epsilon, decay=opt._wd_coeff), 3)
            nbytes = numel * (2 + 4 + 8 + 2 + 8)
            b, by = bound_ms(nbytes, 15 * numel, FP32_FLOPS)
            res["flat_launch"] = dict(rows=numel // 512, cols=512,
                                      elements=numel, ms=ms, bound_ms=b,
                                      bound_by=by, plain_ms=None,
                                      plain_note="not measured: the plain "
                                      "update's fp32 temporaries of the "
                                      "whole model do not fit beside it")
        del eng, opt, model
        _free(torch)
    bad = [k for k in params["flat"]
           if not torch.equal(params["flat"][k], params["per_tensor"][k])]
    check(not bad, f"phase 32 (d): flat AdamW parameters differ from the "
                   f"per-tensor path's: {bad[:5]}")
    res["flat_launch"]["library_ms"], res["flat_launch"]["library_note"] = \
        _flat_adamw_library_ms(torch, cfg)
    check(res["flat"]["losses"] == res["per_tensor"]["losses"],
          "phase 32 (d): flat losses differ from per-tensor")
    res["bitwise_equal"] = True
    log("phase 32 (d) flat AdamW: " + json.dumps(res))
    del params
    return res


def _flat_adamw_library_ms(torch, cfg):
    """Row 10's library yardstick at the flat shape: one step of
    ``torch.optim.AdamW(fused=True)`` over the same tensors (the model's
    parameter shapes), fp32 parameters and gradients as phase 6's
    yardstick, timed with events after two warm-up steps (the first makes
    the moments). Returns (ms, what was measured), or (None, why not)
    when the 16 bytes an element do not fit the free device memory."""
    from paddle_tpu_torch.models.convert import param_shapes

    shapes = list(param_shapes(cfg).values())
    numel = sum(math.prod(s) for s in shapes)
    need = 16 * numel + 2 ** 30
    free = torch.cuda.mem_get_info()[0]
    if free < need:
        return None, (f"not measured: {len(shapes)} fp32 tensors of "
                      f"{numel} elements need {need / 2 ** 30:.1f} GiB with "
                      f"gradients and moments, {free / 2 ** 30:.1f} free")
    g = torch.Generator(device="cuda").manual_seed(37)
    ws = []
    for shape in shapes:
        w = torch.randn(shape, generator=g, device="cuda").mul_(0.02)
        w.requires_grad_()
        w.grad = torch.randn(shape, generator=g, device="cuda").mul_(1e-3)
        ws.append(w)
    opt = torch.optim.AdamW(ws, lr=1e-4, weight_decay=0.01, fused=True)
    ms = event_ms(torch, opt.step, 3)
    del opt, ws
    _free(torch)
    return ms, (f"torch.optim.AdamW(fused=True), one step over the same "
                f"{len(shapes)} tensors ({numel} elements), fp32 "
                f"parameters and gradients")


def finetune_offload_attn(torch, ops):
    """Phase 32 (e): ``remat_policy="offload_attn"`` at phase 19's S =
    16384 on its layers against ``"nothing"`` and ``"dots"``: 3 graphed
    steps each from the same weights; losses and parameters bit for bit
    ``"nothing"``'s (the host copies are the values the recompute makes
    again: tolerance 0); peak memory and ms a step."""
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama3_8b_config)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ParallelEngine

    cfg = llama3_8b_config(num_hidden_layers=LONG_LAYERS,
                           max_position_embeddings=OA_S)
    gen = torch.Generator(device="cuda").manual_seed(37)
    batch = _long_batch(torch, gen, cfg.vocab_size, OA_S)
    model = LlamaForCausalLM(cfg, seed=6)
    res, final = {}, {}
    for policy in ("nothing", "offload_attn", "dots"):
        model.reset_parameters(6)
        opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters())
        eng = ParallelEngine(model, optimizer=opt, remat=True,
                             remat_policy=policy)
        want = {"flash_fwd_stream": 2 * LONG_LAYERS,
                "flash_bwd_dq_stream": LONG_LAYERS,
                "flash_bwd_dkv_stream": LONG_LAYERS,
                "rms_norm": 4 * LONG_LAYERS + 1,
                "fused_adamw": len(eng.trained)}
        losses, walls, _, peak = _timed_steps(
            torch, ops, eng, batch, OFF_STEPS, want,
            f"phase 32 (e) S={OA_S} remat {policy}")
        res[policy] = dict(losses=losses, ms_per_step=walls[-1] * 1e3,
                           peak_memory_gib=peak,
                           host_anchor_gib=eng.host_stash.nbytes / 2 ** 30)
        if policy != "dots":
            final[policy] = _snapshot_params(torch, eng.named, host=True)
        del eng, opt
        _free(torch)
    check(res["offload_attn"]["host_anchor_gib"] > 0 and
          len(res) == 3, "phase 32 (e): no anchor went to the host")
    check(res["offload_attn"]["losses"] == res["nothing"]["losses"],
          f"phase 32 (e): offload_attn losses "
          f"{res['offload_attn']['losses']} != nothing's "
          f"{res['nothing']['losses']}")
    diff = max((final["offload_attn"][n].float() - final["nothing"][n]
                .float()).abs().max().item() for n in final["nothing"])
    res["param_max_abs_diff_vs_nothing"] = diff
    res["tolerance"] = 0.0
    check(diff == 0.0, f"phase 32 (e): offload_attn parameters differ from "
                       f"nothing's by {diff}")
    log("phase 32 (e) offload_attn: " + json.dumps(res))
    del model, final, batch
    _free(torch)
    return res


def finetune_amp(torch, ops):
    """Phase 32 (f): AMP O2 (``decorate``: bf16 parameters, fp32 master
    weights) with ``GradScaler`` at 2 layers, eager: the loss falls; two
    planted inf gradients skip their steps (parameters bit for bit) and
    halve the scale after ``decr_every_n_nan_or_inf`` = 2 bad steps."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama3_8b_config)
    from paddle_tpu_torch.optimizer import AdamW

    cfg = llama3_8b_config(num_hidden_layers=AMP_LAYERS, dtype="float32")
    model = LlamaForCausalLM(cfg, seed=7)
    for p in model.parameters():
        p.requires_grad_(True)
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters())
    model, opt = amp.decorate(model, opt, level="O2")
    check(all(p.dtype == torch.bfloat16 for p in model.parameters()),
          "phase 32 (f): decorate O2 left an fp32 parameter")
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 14,
                            decr_every_n_nan_or_inf=2)
    ids, labels = _ft_batch(torch, cfg.vocab_size, 1, FT_S, 38)
    plant = (2, 3)
    losses, scales, skipped = [], [], []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for k in range(6):
        with amp.auto_cast(level="O2"):
            loss = model(ids, labels)
        scaler.scale(loss).backward()
        if k in plant:
            model.model.layers[0].mlp.up_proj.weight.grad.fill_(float("inf"))
        before = model.model.layers[1].self_attn.q_proj.weight.detach() \
            .clone()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        same = torch.equal(before,
                           model.model.layers[1].self_attn.q_proj.weight)
        losses.append(loss.item())
        scales.append(scaler.state_dict()["scale"])
        skipped.append(same)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    check(skipped == [k in plant for k in range(6)], f"phase 32 (f): the "
          f"skipped steps {skipped}, want the planted ones {plant}")
    check(scales[1] == 2.0 ** 14 and scales[2] == 2.0 ** 14 and
          scales[3] == 2.0 ** 13, f"phase 32 (f): scales {scales}")
    check(losses[-1] < losses[0], f"phase 32 (f): the loss did not fall: "
                                  f"{losses}")
    masters = {s["master_weight"].dtype for s in opt._accumulators.values()}
    check(masters == {torch.float32}, f"phase 32 (f): master weights "
                                      f"{masters}")
    check(launches["fused_adamw"] > 0 and launches["flash_fwd"] > 0,
          f"phase 32 (f): launches {launches}")
    res = dict(layers=AMP_LAYERS, level="O2", losses=losses, scales=scales,
               skipped=skipped, planted_inf_at=list(plant),
               master_weight_dtype="float32", wall_s=wall,
               launches=launches)
    log("phase 32 (f) amp O2 + GradScaler: " + json.dumps(res))
    del model, opt
    _free(torch)
    return res


def finetune(torch, ops):
    """Phase 32: the rest of the training side at full width (see the
    module docstring); returns the results and the launches of the main
    path ((a)'s steps and (b)'s counted serving run)."""
    t0 = time.perf_counter()
    res = {}
    part_s = {}
    lora, model = finetune_lora(torch, ops)
    res["a"] = lora
    part_s["a"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        res["b"] = finetune_serve(torch, ops, model, tmp)
    del model
    _free(torch)
    part_s["b"] = time.perf_counter() - t0 - sum(part_s.values())
    launches = dict(lora["launches"])
    for k, n in res["b"]["launches"].items():
        launches[k] = launches.get(k, 0) + n
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "rms_norm",
              "fused_adamw", "paged_attention", "fused_lora_matmul"):
        check(launches.get(k, 0) > 0, f"phase 32: {k} was not launched on "
                                      f"the finetune path")
    for key, fn in (("c", finetune_offload), ("d", finetune_flat),
                    ("e", finetune_offload_attn), ("f", finetune_amp)):
        res[key] = fn(torch, ops)
        part_s[key] = time.perf_counter() - t0 - sum(part_s.values())
    res["launches"] = launches
    res["part_s"] = part_s
    res["phase_s"] = time.perf_counter() - t0
    log(f"phase 32: {res['phase_s']:.1f} s, {card_line()}")
    return res


# -------------------------------------------------------------- phase 33
# ResNet-50 / CIFAR-10, BASELINE config 1 (BASELINE.md:20): the cell of
# tools/model_benchmark.py:114-140 (resnet50(num_classes=10), B = 32 x 3 x
# 224 x 224, Momentum, cross_entropy, ParallelEngine) with the recipe of
# examples/resnet_cifar10.py:36-39 (momentum 0.9, weight decay 5e-4,
# CosineAnnealingDecay(0.1)); (b) and (c) at B = 256, the per-GPU batch of
# ResNet-50 recipes on an 80 GB card; (e) at B = 4 against the CPU
VISION_B, VISION_BIG_B, VISION_CHECK_B = 32, 256, 4
VISION_SIZE, VISION_STEPS = 224, 8
# the scheduler's period in steps (the engine steps it once a batch)
VISION_T_MAX = 16
# dense TF32 peak of one H100 SXM (NVIDIA's H100 datasheet, no sparsity):
# the fp32 cells' convolutions run in TF32 (cudnn.allow_tf32, PyTorch's
# default); the AMP cell divides by BF16_FLOPS
TF32_FLOPS = 495e12
# (e): the card's fp32 logits (TF32 off) against the port on the CPU on
# the same weights and images, the largest |difference| over the largest
# |logit|, and the losses' relative gap. The port's fp32 ResNet-50 stays
# within 1e-4 of its fp64 run at the CPU tests' smaller shapes (B = 4 at
# 224 x 224 normalises 196 values a channel in the last stage, better
# conditioned still); the limit leaves 10x that
VISION_CPU_TOL = 1e-3


# (b)'s BatchNorm on bf16 activations (cuDNN's mixed-dtype kernels on the
# card) against the port on the CPU, which the CPU tests hold to the JAX
# package: one training BatchNorm2D forward and backward at the first
# stage's width. Both compute in fp32 and round to bf16, so the outputs
# and the input's gradients may differ by a bf16 rounding (2^-8 of the
# largest; the limits leave 2x and 4x that), the fp32 running statistics
# by fp32 summation order
VISION_BN_SHAPE = (8, 256, 56, 56)
VISION_BN_TOL = dict(out=2 ** -7, mean=1e-5, variance=1e-5, x_grad=2 ** -6)


def _vision_class(name: str) -> str:
    """ResNet's kernel classes: convolutions (cuDNN's kernels, the GEMMs
    it runs 1 x 1 convolutions as, its layout transforms; the fc's small
    product lands here too), BatchNorm, pooling, elementwise (ReLU, the
    residual adds, casts, the optimizer's update) and the rest
    (reductions, the loss)."""
    low = name.lower()
    if any(k in low for k in ("bn_fw", "bn_bw", "batch_norm", "batchnorm")):
        return "batch_norm"
    if "pool" in low:
        return "pooling"
    if any(k in low for k in ("conv", "fprop", "dgrad", "wgrad", "implicit",
                              "nchw", "nhwc", "cudnn", "gemm", "nvjet",
                              "xmma", "cutlass", "cublas", "sm90_",
                              "sm80_")):
        return "conv"
    if "elementwise" in low or "vectorized" in low:
        return "elementwise"
    if "reduce" in low:
        return "reduce"
    return "other"


def _conv_fc_flops(torch, model, x) -> int:
    """2 x the multiply-adds of every ``Conv2D`` and ``Linear`` in one
    eval forward of ``x`` (the running statistics are left as they are)."""
    from paddle_tpu_torch.nn import Conv2D, Linear

    total = [0]

    def conv(layer, inp, out):
        w = layer.weight
        total[0] += 2 * out.numel() * w.shape[1] * math.prod(w.shape[2:])

    def fc(layer, inp, out):
        total[0] += 2 * out.numel() * layer.weight.shape[0]

    hooks = [m.register_forward_post_hook(conv if isinstance(m, Conv2D)
                                          else fc)
             for m in model.sublayers() if isinstance(m, (Conv2D, Linear))]
    was = model.training
    model.eval()
    with torch.no_grad():
        model(x)
    model.train(was)
    for h in hooks:
        h.remove()
    return total[0]


def _vision_snapshot(eng):
    """Device copies of the parameters, the velocities and the
    BatchNorm statistics."""
    out = _snapshot(eng)
    for n, b in eng.model.named_buffers():
        out[n] = b.detach().clone()
    return out


def _vision_cell(torch, ops, eng, batch, label, flops, peak, images,
                 want=None, classify=_vision_class):
    """VISION_STEPS steps of ``eng``, each read back, each launching the
    port's kernels ``want`` says ({kernel: launches a step}) and no other
    (phase 33's path launches none); a snapshot of the state after them;
    then the step's device time and its split by ``classify``. The loss
    must fall. Returns (the cell, the snapshot)."""
    want = want or {}
    losses, walls, launches, peak_gib = _timed_steps(
        torch, ops, eng, batch, VISION_STEPS, want, label, exact=True)
    snap = _vision_snapshot(eng)
    step_s = _median(walls[2:])
    dev = _step_device(torch, eng, lambda: eng.train_batch(*batch), 2, 3, 3,
                       classify)
    res = dict(graphs=eng._use_graphs(), losses=losses, step_walls_s=walls,
               ms_per_step=step_s * 1e3, images_per_s=images / step_s,
               flops_per_step=flops, peak_flops=peak,
               mfu=flops / step_s / peak,
               compute_bound_ms=flops / peak * 1e3,
               peak_memory_gib=peak_gib,
               device_ms_per_step=dev.pop("device_ms"), **dev,
               replays=dict(eng.replays), captures=eng.captures,
               launches=launches, launches_per_step=want)
    res["busy_share"] = (None if res["device_ms_per_step"] is None
                         else res["device_ms_per_step"] / res["ms_per_step"])
    if res["graphs"]:
        check(eng.captures == 1 and eng.replays["train"] >= VISION_STEPS - 2,
              f"{label}: {eng.replays['train']} replays, {eng.captures} "
              f"captures: the graphs did not run")
    else:
        check(eng.captures == 0, f"{label}: the eager twin captured")
    # the recipe's first update lifts the loss of a random network (lr 0.1
    # with no warm-up); it must fall from there: the last three steps'
    # mean below the first three's
    res["loss_fell"] = sum(losses[-3:]) < sum(losses[:3])
    check(res["loss_fell"],
          f"{label}: the loss did not fall over {VISION_STEPS} steps: "
          f"{losses}")
    log(f"{label}: " + json.dumps(res))
    return res, snap


def _vision_optimizer_ms(torch, model):
    """Device ms of the Momentum update alone over the model's 161
    parameters (fp32 clones, gradients of their shapes; graph-timed): the
    optimizer's share of the elementwise class."""
    from paddle_tpu_torch.optimizer import Momentum

    g = torch.Generator(device="cuda").manual_seed(330)
    triples = [(n, p.detach().clone(), torch.randn(
        p.shape, generator=g, device="cuda") * 1e-3)
        for n, p in model.named_parameters()]
    opt = Momentum(learning_rate=0.1, momentum=0.9, weight_decay=5e-4)
    lr = torch.tensor(0.1, device="cuda")
    step = torch.tensor(1, dtype=torch.int32, device="cuda")
    return time_ms(lambda: opt.update(triples, lr, step), 10)


def _vision_bn_bf16(torch):
    """The largest difference, over the largest value, of the card's and
    the CPU's bf16 BatchNorm: output, running mean and variance, the
    input's gradient."""
    from paddle_tpu_torch.nn import BatchNorm2D

    g = torch.Generator().manual_seed(335)
    x = (torch.randn(VISION_BN_SHAPE, generator=g) * 2 + 1).bfloat16()
    dy = torch.randn(VISION_BN_SHAPE, generator=g)
    got = {}
    for dev in ("cuda", "cpu"):
        bn = BatchNorm2D(VISION_BN_SHAPE[1], device=dev)
        xd = x.to(dev).requires_grad_()
        y = bn(xd)
        (y.float() * dy.to(dev)).sum().backward()
        check(y.dtype == xd.grad.dtype == torch.bfloat16
              and bn._mean.dtype == torch.float32,
              f"phase 33 (b) BatchNorm bf16 on {dev}: output {y.dtype}, "
              f"gradient {xd.grad.dtype}, statistics {bn._mean.dtype}")
        got[dev] = [t.detach().float().cpu()
                    for t in (y, bn._mean, bn._variance, xd.grad)]
    return {k: ((c - h).abs().max() / h.abs().max()).item()
            for k, c, h in zip(VISION_BN_TOL, got["cuda"], got["cpu"])}


def vision(torch, ops, keep=None):
    """Phase 33: ResNet-50 training and eval on the card through the
    framework core and the convolutional layer surface (see the module
    docstring): (a) fp32 B = 32, graphed and its eager twin bit for bit
    under deterministic cuDNN; (b) AMP O1 bf16 at B = 256, graphed; (c) the
    eval forward at B = 256 on (a)'s running statistics, graphed; (d)
    ``save`` / ``load`` / ``set_state_dict`` into a fresh model: (c)'s
    logits bit for bit; (e) B = 4 fp32 (TF32 off) against the port on the
    CPU."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum, lr
    from paddle_tpu_torch.parallel import ParallelEngine
    from paddle_tpu_torch.vision.models import resnet50

    t0 = time.perf_counter()
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32)
    cudnn.deterministic, cudnn.benchmark = True, False
    flags = dict(cudnn_allow_tf32=cudnn.allow_tf32,
                 matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
                 cudnn_deterministic=True, cudnn_benchmark=False,
                 cudnn_version=cudnn.version())
    log("phase 33 settings: " + json.dumps(flags) + f", TF32 peak "
        f"{TF32_FLOPS:.3g}, bf16 peak {BF16_FLOPS:.3g} (dense), "
        f"{card_line()}")
    res = dict(settings=flags)
    try:
        def make(seed):
            g = torch.Generator(device="cuda").manual_seed(seed)
            model = resnet50(num_classes=10, generator=g,
                             device="cuda")
            opt = Momentum(learning_rate=lr.CosineAnnealingDecay(
                0.1, T_max=VISION_T_MAX), momentum=0.9, weight_decay=5e-4,
                parameters=model.parameters())
            return model, opt, ParallelEngine(model, optimizer=opt,
                                              loss_fn=F.cross_entropy)

        g = torch.Generator(device="cuda").manual_seed(33)
        x = torch.randn(VISION_B, 3, VISION_SIZE, VISION_SIZE, generator=g,
                        device="cuda")
        y = torch.randint(0, 10, (VISION_B,), generator=g,
                          device="cuda")
        model_a, opt_a, eng_a = make(33)
        n_params = sum(p.numel() for p in model_a.parameters())
        n_bufs = len(model_a.buffers())
        fwd_flops = _conv_fc_flops(torch, model_a, x[:1])
        res["model"] = dict(params=n_params, parameter_tensors=len(
            model_a.parameters()), buffers=n_bufs,
            forward_flops_per_image=fwd_flops,
            flops_formula="3 x (2 x MACs of every conv and the fc) a "
                          "training image, from their shapes")
        log("phase 33 model: " + json.dumps(res["model"]))
        check(n_bufs == 106 and len(model_a.parameters()) == 161,
              f"phase 33: resnet50 has {len(model_a.parameters())} "
              f"parameters and {n_bufs} buffers, want 161 and 106")
        before = {n: b.detach().clone() for n, b in model_a.named_buffers()}

        # (a) fp32, graphed and its eager twin
        res["a"], snap = _vision_cell(
            torch, ops, eng_a, (x, y), f"phase 33 (a) resnet50 fp32 "
            f"B={VISION_B} (graphs)", 3 * fwd_flops * VISION_B, TF32_FLOPS,
            VISION_B)
        moved = sum(not torch.equal(snap[n], before[n]) for n in before)
        res["a"]["bn_buffers_moved"] = moved
        check(moved == n_bufs, f"phase 33 (a): {n_bufs - moved} BatchNorm "
                               f"buffers did not move")
        model_e, _, eng_e = make(33)
        eng_e.graphs = False
        res["a_eager"], snap_e = _vision_cell(
            torch, ops, eng_e, (x, y), f"phase 33 (a) resnet50 fp32 "
            f"B={VISION_B} (eager)", 3 * fwd_flops * VISION_B, TF32_FLOPS,
            VISION_B)
        diffs = [k for k in snap if not torch.equal(snap[k], snap_e[k])]
        res["a_bitwise"] = dict(
            losses_equal=res["a"]["losses"] == res["a_eager"]["losses"],
            tensors=len(snap), tensors_differing=len(diffs),
            first_differing=diffs[:3])
        log("phase 33 (a) graphs against eager: "
            + json.dumps(res["a_bitwise"]))
        check(res["a_bitwise"]["losses_equal"] and not diffs,
              f"phase 33 (a): graphed and eager steps differ: "
              f"{res['a_bitwise']}")
        res["optimizer_ms_per_step"] = _vision_optimizer_ms(torch, model_a)
        del model_e, eng_e, snap, snap_e
        _free(torch)

        # (b) AMP O1 bf16 at B = 256, graphed
        gb = torch.Generator(device="cuda").manual_seed(34)
        xb = torch.randn(VISION_BIG_B, 3, VISION_SIZE, VISION_SIZE,
                         generator=gb, device="cuda")
        yb = torch.randint(0, 10, (VISION_BIG_B,), generator=gb,
                           device="cuda")
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            model_b, _, eng_b = make(34)
            seen = {}

            def conv1_dtype(layer, inp, out):
                seen["conv1"] = out.dtype

            hook = model_b.conv1.register_forward_post_hook(conv1_dtype)
            model_b.eval()
            with torch.no_grad():
                dt = model_b(xb[:2]).dtype
            model_b.train()
            hook.remove()
            check(seen["conv1"] == torch.bfloat16 and dt == torch.bfloat16,
                  f"phase 33 (b): under O1 conv1 gave {seen['conv1']} and "
                  f"the logits {dt}, want bfloat16")
            bn_err = _vision_bn_bf16(torch)
            res["b_batch_norm_bf16_against_cpu"] = dict(
                shape=list(VISION_BN_SHAPE), err_over_max=bn_err,
                tolerance=VISION_BN_TOL)
            log("phase 33 (b) BatchNorm bf16, card against CPU: "
                + json.dumps(res["b_batch_norm_bf16_against_cpu"]))
            check(all(bn_err[k] <= VISION_BN_TOL[k] for k in bn_err),
                  f"phase 33 (b): the card's bf16 BatchNorm is off the "
                  f"CPU's: {bn_err} (limits {VISION_BN_TOL})")
            res["b"], _ = _vision_cell(
                torch, ops, eng_b, (xb, yb), f"phase 33 (b) resnet50 AMP "
                f"O1 bf16 B={VISION_BIG_B} (graphs)",
                3 * fwd_flops * VISION_BIG_B, BF16_FLOPS, VISION_BIG_B)
        del model_b, eng_b
        _free(torch)

        # (c) eval on (a)'s running statistics at B = 256, graphed
        model_a.eval()
        logits_of = lambda logits, label: logits       # noqa: E731
        eng_c = ParallelEngine(model_a, optimizer=opt_a, loss_fn=logits_of)
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(VISION_STEPS):
            t1 = time.perf_counter()
            logits_c = eng_c.eval_batch(xb, yb)
            logits_c.float().sum().item()
            walls.append(time.perf_counter() - t1)
        ev_s = _median(walls[2:])
        dev = _step_device(torch, eng_c,
                           lambda: eng_c.eval_batch(xb, yb).float().sum(),
                           2, 3, 3, _vision_class)
        ev_flops = fwd_flops * VISION_BIG_B
        res["c"] = dict(ms_per_forward=ev_s * 1e3,
                        images_per_s=VISION_BIG_B / ev_s,
                        mfu=ev_flops / ev_s / TF32_FLOPS,
                        compute_bound_ms=ev_flops / TF32_FLOPS * 1e3,
                        peak_memory_gib=torch.cuda.max_memory_allocated()
                        / 2 ** 30,
                        device_ms_per_forward=dev.pop("device_ms"), **dev,
                        replays=dict(eng_c.replays), captures=eng_c.captures)
        res["c"]["busy_share"] = (None if res["c"]["device_ms_per_forward"]
                                  is None else res["c"][
                                      "device_ms_per_forward"]
                                  / res["c"]["ms_per_forward"])
        check(eng_c.captures == 1 and eng_c.replays["eval"]
              >= VISION_STEPS - 2, f"phase 33 (c): {eng_c.replays} replays, "
                                   f"{eng_c.captures} captures")
        check(bool(torch.isfinite(logits_c).all()) and tuple(logits_c.shape)
              == (VISION_BIG_B, 10), "phase 33 (c): eval logits not finite "
                                     "or of the wrong shape")
        logits_c = logits_c.clone()
        if keep is not None:         # phase 34 (c) reads these logits
            keep["eval_batch"] = (logits_c.clone(), yb.clone())
        log("phase 33 (c) eval resnet50 fp32 B=256 (graphs): "
            + json.dumps(res["c"]))

        # (d) save, load, set_state_dict into a fresh model: (c) bit for bit
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "resnet50.pdparams")
            t1 = time.perf_counter()
            paddle.save(model_a.state_dict(), path)
            t2 = time.perf_counter()
            sd = paddle.load(path, device="cuda")
            t3 = time.perf_counter()
            nbytes = os.path.getsize(path)
        fresh = resnet50(num_classes=10, device="cuda",
                         generator=torch.Generator(
                             device="cuda").manual_seed(99))
        missing, unexpected = fresh.set_state_dict(sd)
        check(len(sd) == 267 and not missing and not unexpected
              and all(t.device == x.device for t in sd.values()),
              f"phase 33 (d): {len(sd)} entries, missing {missing[:3]}, "
              f"unexpected {unexpected[:3]}")
        fresh.eval()
        eng_d = ParallelEngine(fresh, optimizer=Momentum(
            0.1, parameters=fresh.parameters()), loss_fn=logits_of)
        for _ in range(3):            # warm-up, capture, replay
            logits_d = eng_d.eval_batch(xb, yb)
        same = bool(torch.equal(logits_d, logits_c))
        res["d"] = dict(entries=len(sd), file_bytes=nbytes,
                        save_s=t2 - t1, load_s=t3 - t2,
                        logits_bitwise_equal=same,
                        max_abs_diff=(logits_d - logits_c).abs().max()
                        .item())
        log("phase 33 (d) save / load / set_state_dict: "
            + json.dumps(res["d"]))
        check(same, f"phase 33 (d): the loaded model's eval logits differ "
                    f"from (c)'s by up to {res['d']['max_abs_diff']:.3g}")
        del eng_c, eng_d, fresh, sd, logits_d, logits_c
        _free(torch)

        # (e) fp32 with TF32 off against the port on the CPU
        cudnn.allow_tf32 = False
        state = model_a.state_dict()
        card = resnet50(num_classes=10, device="cuda",
                        generator=torch.Generator(
                            device="cuda").manual_seed(98))
        card.set_state_dict(state)
        host = resnet50(num_classes=10, device="cpu")
        host.set_state_dict({k: v.cpu() for k, v in state.items()})
        xe, ye = x[:VISION_CHECK_B], y[:VISION_CHECK_B]
        with torch.no_grad():
            lc = card(xe)
            loss_c = F.cross_entropy(lc, ye).item()
            t1 = time.perf_counter()
            lh = host(xe.cpu())
            cpu_s = time.perf_counter() - t1
            loss_h = F.cross_entropy(lh, ye.cpu()).item()
        cudnn.allow_tf32 = saved[2]
        err = ((lc.cpu() - lh).abs().max() / lh.abs().max()).item()
        gap = abs(loss_c - loss_h) / abs(loss_h)
        res["e"] = dict(batch=VISION_CHECK_B, tf32=False, train_mode=True,
                        logits_err_over_max=err, loss_card=loss_c,
                        loss_cpu=loss_h, loss_rel_gap=gap,
                        tolerance=VISION_CPU_TOL, cpu_forward_s=cpu_s)
        log("phase 33 (e) card fp32 against the CPU: " + json.dumps(res["e"]))
        check(err <= VISION_CPU_TOL and gap <= VISION_CPU_TOL,
              f"phase 33 (e): the card's logits are {err:.3g} of the "
              f"largest off the CPU's, the loss {gap:.3g} (limit "
              f"{VISION_CPU_TOL})")
        del card, host, model_a, eng_a, opt_a
    finally:
        cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32 = saved
    _free(torch)
    res["phase_s"] = time.perf_counter() - t0
    log(f"phase 33: {res['phase_s']:.1f} s, {card_line()}")
    return res


# -------------------------------------------------------------- phase 34
# the tensor functions and the rest of the framework core on the card,
# at the widths tools/op_benchmark.py:28-67 uses on the TPU branch:
# (2048, 2048) bf16 and fp32 for elementwise work, reductions, sort,
# search, scatter and gather; int32 / int64 for logic and bitwise; linalg
# at 512 x 512 fp32 (well conditioned: A / sqrt(n) + 2 I, and B B^T / n +
# I). Each family runs on the card and on the port on the CPU on the same
# inputs; integer, logic, search and index results must be equal, floating
# ones within the row's limit, the largest |card - CPU| over the largest
# |CPU| value. The limits, each about 8x or more what the phase read on
# an H100 80GB HBM3 at 700 W (PERF.md): one op of fp32 arithmetic
# (another libm, FMA contraction) 1e-6 (read: 1.2e-7, tanh); fp32
# reductions, scans and
# products over 2048 values 1e-5 (7.3e-7, cumsum); bf16 results (both
# sides compute in fp32 and round once) 2^-7 (read: 0), bf16 reductions
# and products 2^-6 (2.1e-3, the product); cuSOLVER and cuBLAS against
# LAPACK and the CPU's BLAS on the well-conditioned matrices 1e-3 (1.9e-4,
# eigvalsh). Random draws: the mean and variance of 4M draws within 6
# standard errors (read: at most 1.6), and paddle.seed repeats a draw bit
# for bit
TENSOR_N = 2048
TENSOR_LINALG_N = 512
TENSOR_K = 6.0
TOL_F32, TOL_F32_RED, TOL_BF16, TOL_BF16_RED, TOL_LINALG = (
    1e-6, 1e-5, 2 ** -7, 2 ** -6, 1e-3)
# (b): tools/op_benchmark.py:36-67 at its TPU sizes, and the flash cell
OPS_N, OPS_LN_ROWS, OPS_VOCAB, OPS_EMB = 2048, 32, 32000, 512
OPS_FLASH = dict(B=4, H=16, KV=8, S=2048, D=128)
# (c): top-1 / top-5 over phase 33 (c)'s B = 256 eval logits
TENSOR_TOPK = 5
# (d): C3's B = 1 step on 3 x 32 x 32 (layer4 1 x 1), the card (TF32 off)
# and the port on the CPU in fp32, each against the port's fp64 step on
# the CPU: BatchNorm over 1-16 values a channel amplifies fp32 rounding
# (the card read 3.5e-3 of the largest value off the CPU's fp32
# statistics on an H100, PERF.md), so each running statistic of the
# card must lie as close to fp64 as the CPU's fp32 one does, within
# TENSOR_C3_FACTOR, plus
# TENSOR_C3_FLOOR of the statistic's norm (Frobenius norms; the CPU
# tests' yardstick, tests/test_torch_resnet.py)
TENSOR_C3_FACTOR, TENSOR_C3_FLOOR = 4.0, 1e-5
# (b): each op against its plain version (reference kernel mode) on the
# same inputs, the largest difference over the largest value: row 1's
# bf16 output within two bf16 roundings, row 8's fp32 within 1e-5; the
# other ops run the same code in both modes
OPS_TOL = {"flash_attention_causal_gqa": 2 ** -6, "layer_norm": 1e-5}


def _leaves(v):
    if isinstance(v, (list, tuple)):
        return [x for a in v for x in _leaves(a)]
    return [v]


def _rel_err(torch, card, host) -> float:
    """The largest |card - host| over the largest |host| (inf when the
    dtypes, shapes or NaN positions differ; 0 or inf for integer and bool
    results: equal or not)."""
    worst = 0.0
    for c, h in zip(_leaves(card), _leaves(host), strict=True):
        if not isinstance(h, torch.Tensor):
            worst = max(worst, 0.0 if c == h else math.inf)
            continue
        c = c.detach().cpu()
        if c.dtype != h.dtype or c.shape != h.shape:
            return math.inf
        if not (h.is_floating_point() or h.is_complex()):
            worst = max(worst, 0.0 if torch.equal(c, h) else math.inf)
            continue
        c, h = c.to(torch.complex128 if h.is_complex() else torch.float64), \
            h.to(torch.complex128 if h.is_complex() else torch.float64)
        if not torch.equal(torch.isnan(c), torch.isnan(h)):
            return math.inf
        c, h = c.nan_to_num(0.0), h.nan_to_num(0.0)
        if h.numel():
            scale = h.abs().max().item() or 1.0
            worst = max(worst, (c - h).abs().max().item() / scale)
    return worst


def _tensor_families(torch, pt, g):
    """{family: [(label, fn, args, limit)]}: every input made on the CPU
    from ``g``; ``limit`` 0 means equal."""
    n, m = TENSOR_N, TENSOR_LINALG_N

    def randn(*shape):
        return torch.randn(shape, generator=g)

    a, b = randn(n, n), randn(n, n)
    pos = a.abs() + 0.5
    a16, b16, pos16 = a.bfloat16(), b.bfloat16(), pos.bfloat16()
    i32 = torch.randint(-1000, 1000, (n, n), generator=g, dtype=torch.int32)
    sign = torch.where(torch.rand(n, n, generator=g) > 0.5, 1, -1)
    j32 = (torch.randint(1, 50, (n, n), generator=g) * sign).int()
    i64, j64 = i32.long(), j32.long()
    ties = torch.randint(0, 16, (n, n), generator=g).float()
    rows = torch.randint(0, n, (n,), generator=g)
    uniq = torch.randperm(n, generator=g)[:256]
    cols = torch.rand(n, n, generator=g).argsort(1)[:, :64]
    mask = torch.rand(n, n, generator=g) > 0.5
    srt = torch.sort(randn(n), stable=True).values
    small = torch.randint(0, 100, (n * n,), generator=g)
    A = randn(m, m) / math.sqrt(m) + 2 * torch.eye(m)
    Bm = randn(m, m)
    spd = Bm @ Bm.T / m + torch.eye(m)
    rhs = randn(m, 16)
    x_cd, y_cd = randn(m, 64), randn(256, 64)
    E, R, BF, BR = TOL_F32, TOL_F32_RED, TOL_BF16, TOL_BF16_RED
    L = TOL_LINALG
    math_rows = [
        ("add fp32", pt.add, (a, b), E), ("add bf16", pt.add, (a16, b16), BF),
        ("multiply bf16", pt.multiply, (a16, b16), BF),
        ("divide fp32", pt.divide, (a, pos), E),
        ("divide int32", pt.divide, (i32, j32), E),
        ("floor_divide int32", pt.floor_divide, (i32, j32), 0),
        ("mod int64", pt.mod, (i64, j64), 0),
        ("pow fp32", pt.pow, (pos, 2.5), E),
        ("exp fp32", pt.exp, (a,), E), ("exp bf16", pt.exp, (a16,), BF),
        ("log fp32", pt.log, (pos,), E), ("sqrt bf16", pt.sqrt, (pos16,), BF),
        ("tanh fp32", pt.tanh, (a,), E), ("sigmoid bf16", pt.sigmoid, (a16,),
                                          BF),
        ("erf fp32", pt.erf, (a,), E), ("maximum fp32", pt.maximum, (a, b), 0),
        ("clip fp32", lambda x: pt.clip(x, -0.5, 0.5), (a,), 0),
        ("scale fp32", lambda x: pt.scale(x, 2.0, 1.0, False), (a,), E),
        ("lerp fp32", lambda x, y: pt.lerp(x, y, 0.3), (a, b), E),
        ("sum fp32", lambda x: pt.sum(x, axis=-1), (a,), R),
        ("sum bf16", lambda x: pt.sum(x, axis=-1), (a16,), BR),
        ("sum int32", lambda x: pt.sum(x, axis=0), (i32,), 0),
        ("mean fp32", lambda x: pt.mean(x, axis=0), (a,), R),
        ("max fp32", lambda x: pt.max(x, axis=1), (a,), 0),
        ("logsumexp fp32", lambda x: pt.logsumexp(x, axis=-1), (a,), R),
        ("cumsum fp32", lambda x: pt.cumsum(x, axis=1), (a,), R),
        ("cummax fp32", lambda x: pt.cummax(x, axis=1), (ties,), 0),
        ("count_nonzero", lambda x: pt.count_nonzero(x, axis=1), (i32,), 0),
        ("any bool", lambda x: pt.any(x, axis=0), (mask,), 0),
        ("isfinite fp32", pt.isfinite, (pt.log(a),), 0),
        # M = N = 512, K = 2048: the CPU's bf16 product at 2048^3 takes
        # seconds; the op suite (b) times the full one
        ("matmul fp32", pt.matmul, (a[:512], b[:, :512]), R),
        ("matmul bf16", pt.matmul, (a16[:512], b16[:, :512]), BR),
    ]
    manipulation_rows = [
        ("gather fp32", pt.gather, (a, rows), 0),
        ("gather bf16 axis 1", lambda x, i: pt.gather(x, i, axis=1),
         (a16, rows), 0),
        ("index_select", lambda x, i: pt.index_select(x, i, axis=1),
         (a, uniq), 0),
        ("take_along_axis", lambda x, i: pt.take_along_axis(x, i, 1),
         (a, cols), 0),
        ("put_along_axis", lambda x, i, v: pt.put_along_axis(x, i, v, 1),
         (a, cols, b[:, :64]), 0),
        ("scatter", pt.scatter, (a, uniq, b[:256]), 0),
        ("scatter overwrite=False", lambda x, i, u: pt.scatter(
            x, i, u, overwrite=False), (a, uniq, b[:256]), 0),
        ("index_add", lambda x, i, v: pt.index_add(x, i, 0, v),
         (a, rows[:512], b[:512]), E),
        ("scatter_nd_add", pt.scatter_nd_add,
         (a, torch.stack([rows, rows.flip(0)], 1), b[0]), E),
        ("masked_fill", lambda x, mk: pt.masked_fill(x, mk, -1.0),
         (a16, mask), 0),
        ("masked_select", pt.masked_select, (a, mask), 0),
        ("flip", lambda x: pt.flip(x, [0, 1]), (a,), 0),
        ("roll", lambda x: pt.roll(x, [3, -5], axis=[0, 1]), (a,), 0),
        ("tile", lambda x: pt.tile(x[:64], [2, 1]), (a,), 0),
        ("repeat_interleave", lambda x: pt.repeat_interleave(
            x[:256], 2, axis=0), (a16,), 0),
        ("pad reflect", lambda x: pt.pad(x[None, None], [2, 3, 1, 4],
                                         mode="reflect"), (a,), 0),
        ("unique int64", lambda x: pt.unique(x, return_inverse=True,
                                             return_counts=True), (small,), 0),
        ("unique_consecutive", lambda x: pt.unique_consecutive(
            x, return_counts=True), (torch.sort(small).values,), 0),
        ("strided_slice", lambda x: pt.strided_slice(
            x, [0, 1], [5, 2040], [2000, 3], [3, -7]), (a,), 0),
        ("concat / split", lambda x, y: pt.split(pt.concat([x, y], 1),
                                                 [n // 2, -1], axis=1),
         (a16, b16), 0),
    ]
    logic_rows = [
        ("equal int32", pt.equal, (i32, j32), 0),
        ("less_than int64", pt.less_than, (i64, j64), 0),
        ("bitwise_and int32", pt.bitwise_and, (i32, j32), 0),
        ("bitwise_xor int64", pt.bitwise_xor, (i64, j64), 0),
        ("bitwise_not int32", pt.bitwise_not, (i32,), 0),
        ("left_shift int32", pt.bitwise_left_shift, (i32, j32.abs() % 8), 0),
        ("right_shift int64", pt.bitwise_right_shift, (i64, j64.abs() % 8),
         0),
        ("logical_xor", pt.logical_xor, (mask, i32 > 0), 0),
        ("isclose fp32", pt.isclose, (a, a + 1e-6 * b), 0),
        ("allclose fp32", pt.allclose, (a, a.clone()), 0),
        ("equal_all int64", pt.equal_all, (i64, i64.clone()), 0),
    ]
    search_rows = [
        ("argmax fp32", lambda x: pt.argmax(x, axis=1), (a,), 0),
        ("argmin bf16", lambda x: pt.argmin(x, axis=0), (a16,), 0),
        ("argsort ties", lambda x: pt.argsort(x, axis=1, descending=True),
         (ties,), 0),
        ("sort bf16", lambda x: pt.sort(x, axis=0), (a16,), 0),
        ("topk ties", lambda x: pt.topk(x, TENSOR_TOPK), (ties,), 0),
        ("topk bf16 smallest", lambda x: pt.topk(x, 8, largest=False),
         (a16,), 0),
        ("kthvalue ties", lambda x: pt.kthvalue(x, 7), (ties,), 0),
        ("searchsorted", pt.searchsorted, (srt, a), 0),
        ("bucketize right", lambda x, s: pt.bucketize(x, s, right=True),
         (a, srt), 0),
        ("nonzero", pt.nonzero, (mask,), 0),
        ("where", pt.where, (mask, a, b), 0),
        ("index_fill", lambda x, i: pt.index_fill(x, i, 1, -2.0),
         (a, uniq), 0),
    ]
    stat_rows = [
        ("var fp32", lambda x: pt.var(x, axis=1), (a,), R),
        ("std fp32 biased", lambda x: pt.std(x, axis=0, unbiased=False),
         (a,), R),
        ("median fp32", lambda x: pt.median(x, axis=1), (a,), 0),
        ("nanmedian fp32", lambda x: pt.nanmedian(x, axis=0),
         (pt.where(mask, a, a * float("nan")),), 0),
        ("quantile fp32", lambda x: pt.quantile(x, [0.1, 0.5, 0.9], axis=1),
         (a,), E),
        ("histogram", lambda x: pt.histogram(x, bins=100), (a,), 0),
        ("bincount", pt.bincount, (small,), 0),
        ("cov fp32", lambda x: pt.cov(x[:64]), (a,), R),
        ("numel", pt.numel, (a,), 0),
    ]
    linalg_rows = [
        ("inv", pt.linalg.inv, (A,), L),
        ("solve", pt.linalg.solve, (A, rhs), L),
        ("slogdet", pt.linalg.slogdet, (A,), L),
        ("cholesky", pt.linalg.cholesky, (spd,), L),
        ("eigvalsh", pt.linalg.eigvalsh, (spd,), L),
        ("svdvals", pt.linalg.svdvals, (A,), L),
        ("qr |R|", lambda x: pt.abs(pt.linalg.qr(x, mode="r")), (A,), L),
        ("lstsq", lambda x, y: pt.linalg.lstsq(x, y)[0], (A, rhs), L),
        ("pinv", pt.linalg.pinv, (A,), L),
        ("lu_unpack P L U", lambda x: pt.matmul(pt.matmul(
            *pt.linalg.lu_unpack(*pt.linalg.lu(x))[:2]),
            pt.linalg.lu_unpack(*pt.linalg.lu(x))[2]), (A,), L),
        ("triangular_solve", lambda x, y: pt.linalg.triangular_solve(
            pt.triu(x), y), (A, rhs), L),
        ("matrix_norm fro", pt.linalg.matrix_norm, (A,), L),
        ("norm p=3", lambda x: pt.linalg.norm(x, p=3, axis=1), (A,), R),
        ("cond", pt.linalg.cond, (spd,), L),
        ("matrix_exp", lambda x: pt.linalg.matrix_exp(x * 0.05), (Bm,), L),
        ("cdist", pt.linalg.cdist, (x_cd, y_cd), R),
        ("matmul 512", pt.matmul, (A, Bm), R),
        ("einsum", lambda x, y: pt.einsum("ij,kj->ik", x, y), (A, Bm), R),
    ]
    return {"math": math_rows, "manipulation": manipulation_rows,
            "logic": logic_rows, "search": search_rows, "stat": stat_rows,
            "linalg": linalg_rows}


def _tensor_random(torch, pt):
    """Moments of 4M draws on the card (within TENSOR_K standard errors:
    of the mean sigma / sqrt(n), of the variance sqrt(mu4 - sigma^4) /
    sqrt(n)) and ``paddle.seed`` repeating each draw bit for bit."""
    n = TENSOR_N * TENSOR_N
    shape = [TENSOR_N, TENSOR_N]
    cu = dict(device="cuda")
    full = lambda v: torch.full(shape, v, device="cuda")  # noqa: E731
    rows = [  # (name, draw, mean, variance, fourth central moment)
        ("rand", lambda: pt.rand(shape, **cu), 0.5, 1 / 12, 1 / 80),
        ("uniform", lambda: pt.uniform(shape, min=-2.0, max=3.0, **cu), 0.5,
         25 / 12, 625 / 80),
        ("randn", lambda: pt.randn(shape, **cu), 0.0, 1.0, 3.0),
        ("gaussian", lambda: pt.gaussian(shape, mean=1.0, std=2.0, **cu),
         1.0, 4.0, 48.0),
        ("normal tensors", lambda: pt.normal(full(1.0), full(0.5)), 1.0,
         0.25, 3 * 0.0625),
        ("bernoulli", lambda: pt.bernoulli(full(0.3)), 0.3, 0.21,
         0.21 * (1 - 3 * 0.21)),
        ("poisson", lambda: pt.poisson(full(3.0)), 3.0, 3.0, 3.0 * 10),
        ("standard_gamma", lambda: pt.standard_gamma(full(2.5)), 2.5, 2.5,
         3 * 2.5 * 4.5),
        ("exponential_", lambda: pt.exponential_(torch.empty(
            shape, device="cuda"), 2.0), 0.5, 0.25, 9 / 16),
        ("randint", lambda: pt.randint(-3, 5, shape, **cu), 0.5, 63 / 12,
         63 * 185 / 240),
        ("binomial", lambda: pt.binomial(full(10).long(), full(0.4)), 4.0,
         2.4, 2.4 * (1 + 3 * 8 * 0.24)),
    ]
    out = {}
    for name, draw, mean, var, mu4 in rows:
        pt.seed(34)
        v = draw()
        pt.seed(34)
        again = draw()
        check(v.is_cuda and torch.equal(v, again),
              f"phase 34 (a) random {name}: paddle.seed did not repeat the "
              f"draw on the card")
        d = v.double()
        got_m, got_v = d.mean().item(), d.var(correction=0).item()
        se_m, se_v = math.sqrt(var / n), math.sqrt((mu4 - var * var) / n)
        out[name] = dict(mean=got_m, want_mean=mean,
                         mean_se=abs(got_m - mean) / se_m, var=got_v,
                         want_var=var, var_se=abs(got_v - var) / se_v)
        check(out[name]["mean_se"] <= TENSOR_K
              and out[name]["var_se"] <= TENSOR_K,
              f"phase 34 (a) random {name}: {out[name]} (limit {TENSOR_K} "
              f"standard errors)")
    p = torch.tensor([0.2, 0.3, 0.5], device="cuda")
    pt.seed(34)
    v = pt.multinomial(p, n)
    freqs = [(v == c).double().mean().item() for c in range(3)]
    out["multinomial"] = dict(freqs=freqs, se=[
        abs(f - q) / math.sqrt(q * (1 - q) / n)
        for f, q in zip(freqs, (0.2, 0.3, 0.5))])
    check(max(out["multinomial"]["se"]) <= TENSOR_K,
          f"phase 34 (a) random multinomial: {out['multinomial']}")
    a = pt.uniform(shape, seed=5, **cu)
    check(torch.equal(a, pt.uniform(shape, seed=5, **cu)),
          "phase 34 (a) random: uniform(seed=5) did not repeat on the card")
    return out


def _tensor_containers(torch, pt):
    """TensorArray and SelectedRows on the card against the CPU."""
    from paddle_tpu_torch.framework import SelectedRows, TensorArray

    g = torch.Generator().manual_seed(341)
    parts = [torch.randn(64, 128, generator=g) for _ in range(4)]
    rows = torch.randint(0, 512, (4096,), generator=g)
    value = torch.randint(-8, 8, (4096, 128), generator=g).float()
    got = {}
    for dev in ("cuda", "cpu"):
        ta = TensorArray(device=dev)
        for k, p in enumerate(parts):
            ta.write(3 - k, p.to(dev))
        sr = SelectedRows(rows.to(dev), value.to(dev), 512)
        merged = sr.merge()
        got[dev] = (ta.stack(1), sr.to_dense(), merged.rows, merged.value)
    return _rel_err(torch, got["cuda"], got["cpu"])


def _ops_suite(torch, ops, pt):
    """(b): tools/op_benchmark.py's suite through the port's public API on
    the card, each op once with the launch counts from 0 (rows 1 and 8
    must launch), then each timed (graph-timed device ms)."""
    from paddle_tpu_torch.ops.flash_attention import flash_attention

    F = pt.nn.functional
    g = torch.Generator(device="cuda").manual_seed(342)
    n = OPS_N
    a = torch.randn(n, n, generator=g, device="cuda").bfloat16()
    b = torch.randn(n, n, generator=g, device="cuda").bfloat16()
    img = torch.randn(8, 64, 56, 56, generator=g, device="cuda")
    conv = pt.nn.Conv2D(64, 128, 3, padding=1, device="cuda")
    x3 = torch.randn(OPS_LN_ROWS, n, generator=g, device="cuda")
    ln = pt.nn.LayerNorm(n, device="cuda")
    with torch.no_grad():        # a random affine, not the identity
        ln.weight.copy_(torch.rand(n, generator=g, device="cuda") + 0.5)
        ln.bias.copy_(torch.randn(n, generator=g, device="cuda"))
    ids = torch.randint(0, OPS_VOCAB, (8, 512), generator=g, device="cuda",
                        dtype=torch.int32)
    emb = pt.nn.Embedding(OPS_VOCAB, OPS_EMB, device="cuda")
    fl = OPS_FLASH
    q = torch.randn(fl["B"], fl["H"], fl["S"], fl["D"], generator=g,
                    device="cuda").bfloat16()
    k = torch.randn(fl["B"], fl["KV"], fl["S"], fl["D"], generator=g,
                    device="cuda").bfloat16()
    v = torch.randn(fl["B"], fl["KV"], fl["S"], fl["D"], generator=g,
                    device="cuda").bfloat16()
    suite = {
        "matmul": (lambda: pt.matmul(a, b), f"({n},{n})x({n},{n}) bf16"),
        "conv2d_3x3": (lambda: conv(img), "(8,64,56,56)->128ch fp32"),
        "softmax": (lambda: F.softmax(x3, axis=-1), f"(32,{n}) fp32"),
        "layer_norm": (lambda: ln(x3), f"(32,{n}) fp32"),
        "embedding": (lambda: emb(ids), "(8,512) of 32000x512"),
        "reduce_sum": (lambda: pt.sum(a, axis=-1), f"({n},{n}) bf16"),
        "flash_attention_causal_gqa": (
            lambda: flash_attention(q, k, v, True),
            "B4 H16/8 S2048 D128 bf16"),
    }
    with torch.no_grad():
        ops.reset_launch_counts()
        outs = {name: fn() for name, (fn, _) in suite.items()}
        torch.cuda.synchronize()
        launches = {k2: c for k2, c in ops.launch_counts().items() if c}
        for name, out in outs.items():
            check(bool(torch.isfinite(out.float()).all()),
                  f"phase 34 (b) {name}: output not finite")
        res = {name: dict(shape=shape, ms=time_ms(fn, 20))
               for name, (fn, shape) in suite.items()}
        # the reference each op is held to: the plain version (reference
        # kernel mode) on the same inputs
        ops.set_kernel_mode("reference")
        try:
            ref = {name: fn() for name, (fn, _) in suite.items()}
        finally:
            ops.set_kernel_mode("auto")
        for name in suite:
            diff = (outs[name].float() - ref[name].float()).abs().max()
            res[name]["max_abs_err"] = diff.item()
            res[name]["err_over_max"] = (
                diff / ref[name].float().abs().max()).item()
            check(res[name]["err_over_max"] <= OPS_TOL.get(name, 0.0),
                  f"phase 34 (b) {name}: {res[name]['err_over_max']:.3g} "
                  f"of the largest off its plain version (limit "
                  f"{OPS_TOL.get(name, 0.0)})")
        # row 8 at (32, 2048) against the library's LayerNorm
        res["layer_norm"]["library_ms"] = time_ms(
            lambda: torch.nn.functional.layer_norm(x3, (n,), ln.weight,
                                                   ln.bias, 1e-5), 20)
        res["layer_norm"]["plain_ms"] = time_ms(
            lambda: ops.fused_norm._ln_ref(x3, ln.weight, ln.bias, 1e-5), 20)
        nbytes = 2 * x3.numel() * 4 + 2 * n * 4
        res["layer_norm"]["bound_ms"], res["layer_norm"]["bound_by"] = \
            bound_ms(nbytes, 8 * x3.numel(), 67e12)
    for row in ("flash_fwd", "layer_norm"):
        check(launches.get(row, 0) > 0,
              f"phase 34 (b): row {row} was not launched ({launches})")
    return res, launches


def _eval_metrics(torch, pt, logits, labels):
    """top-1 and top-5 accuracy through paddle.topk / equal / cast / mean /
    argmax, on the logits' device."""
    top1 = pt.mean(pt.cast(pt.equal(pt.argmax(logits, axis=1), labels),
                           "float32"))
    _, idx = pt.topk(logits, TENSOR_TOPK, axis=1)
    hit = pt.any(pt.equal(idx, pt.unsqueeze(labels, 1)), axis=1)
    top5 = pt.mean(pt.cast(hit, "float32"))
    return top1, top5


def _resnet_step(torch, pt, dev, state, x, y, graphs=False, dtype=None):
    """An engine over ResNet-50 on ``dev`` (in ``dtype``, fp32 by
    default) from ``state``, with phase 33's recipe (Momentum,
    cross_entropy; fp64 takes torch's cross_entropy, the port's computes
    in fp32); returns (engine, model)."""
    from paddle_tpu_torch.models.convert import layer_params_from_jax
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.parallel import ParallelEngine
    from paddle_tpu_torch.vision.models import resnet50

    model = resnet50(num_classes=10, device=dev)
    layer_params_from_jax(state, model)
    loss_fn = pt.nn.functional.cross_entropy
    if dtype is not None and dtype != torch.float32:
        model.to(dtype=dtype)
        loss_fn = torch.nn.functional.cross_entropy
    eng = ParallelEngine(model, optimizer=Momentum(
        learning_rate=0.1, momentum=0.9, weight_decay=5e-4,
        parameters=model.parameters()), loss_fn=loss_fn)
    eng.graphs = graphs
    return eng, model


def _timed_step(torch, eng, x, y):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = eng.train_batch(x, y)
    loss_v = loss.item()
    torch.cuda.synchronize()
    return loss_v, time.perf_counter() - t0


def tensor_api(torch, ops, eval_batch=None):
    """Phase 34: the tensor functions and the rest of the framework core
    on the card (see the module docstring): (a) each family on CUDA against
    the port on the CPU; (b) the op-level suite through the public API,
    rows 1 and 8 launched; (c) ResNet-50's top-1 / top-5 on phase 33 (c)'s
    B = 256 logits (``eval_batch``; with None, a seeded ResNet-50's eval
    logits) on the card and on the CPU, equal; (d) FLAGS_check_nan_inf on
    an eager ResNet-50 step, C3 at B = 1 on 3 x 32 x 32, C2 and AMP's
    product hooks."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.vision.models import resnet50

    t0 = time.perf_counter()
    res = dict(card=card_line())
    # (a) families on the card against the CPU
    g = torch.Generator().manual_seed(34)
    fams = _tensor_families(torch, pt, g)
    res["a"] = {}
    for fam, rows in fams.items():
        t1 = time.perf_counter()
        errs = {}
        for label, fn, args, limit in rows:
            host = fn(*args)
            card = fn(*(x.to("cuda") if isinstance(x, torch.Tensor) else x
                        for x in args))
            check(all(c.is_cuda for c in _leaves(card)
                      if isinstance(c, torch.Tensor)),
                  f"phase 34 (a) {fam} {label}: a result left the card")
            err = _rel_err(torch, card, host)
            errs[label] = dict(err=err, limit=limit)
            check(err <= limit, f"phase 34 (a) {fam} {label}: card against "
                                f"CPU {err:.3g} (limit {limit})")
        torch.cuda.synchronize()
        res["a"][fam] = dict(rows=errs, seconds=time.perf_counter() - t1)
        log(f"phase 34 (a) {fam}: " + json.dumps(res["a"][fam]))
    res["a"]["random"] = _tensor_random(torch, pt)
    log("phase 34 (a) random: " + json.dumps(res["a"]["random"]))
    res["a"]["containers_err"] = _tensor_containers(torch, pt)
    check(res["a"]["containers_err"] == 0.0,
          f"phase 34 (a) containers: card against CPU "
          f"{res['a']['containers_err']}")
    _free(torch)

    # (b) the op-level suite
    res["b"], res["launches"] = _ops_suite(torch, ops, pt)
    log(f"phase 34 (b) op suite, {res['card']}: " + json.dumps(res["b"]))
    log("phase 34 (b) launches: " + json.dumps(res["launches"]))
    _free(torch)

    # (c) ResNet-50's eval metrics on the card and on the CPU
    if eval_batch is None:
        gm = torch.Generator(device="cuda").manual_seed(343)
        model = resnet50(num_classes=10, generator=gm, device="cuda").eval()
        xb = torch.randn(VISION_BIG_B, 3, VISION_SIZE, VISION_SIZE,
                         generator=gm, device="cuda")
        with torch.no_grad():
            logits = model(xb)
        labels = torch.randint(0, 10, (VISION_BIG_B,), generator=gm,
                               device="cuda")
        del model, xb
    else:
        logits, labels = eval_batch
    card = _eval_metrics(torch, pt, logits, labels)
    host = _eval_metrics(torch, pt, logits.cpu(), labels.cpu())
    res["c"] = dict(batch=int(logits.shape[0]), top1=card[0].item(),
                    top5=card[1].item(), top1_cpu=host[0].item(),
                    top5_cpu=host[1].item(),
                    logits="phase 33 (c)" if eval_batch is not None
                    else "a seeded resnet50, eval")
    log("phase 34 (c) eval metrics: " + json.dumps(res["c"]))
    check(card[0].is_cuda and [t.item() for t in card]
          == [t.item() for t in host],
          f"phase 34 (c): the card's top-1 / top-5 {res['c']} differ from "
          f"the CPU's")
    _free(torch)

    # (d) FLAGS_check_nan_inf on an eager ResNet-50 step at B = 32
    gd = torch.Generator().manual_seed(344)
    ref_model = resnet50(num_classes=10, generator=gd, device="cpu")
    state = {n: t.detach().numpy() for n, t in
             list(ref_model.named_parameters())
             + list(ref_model.named_buffers())}
    gx = torch.Generator(device="cuda").manual_seed(345)
    x = torch.randn(VISION_B, 3, VISION_SIZE, VISION_SIZE, generator=gx,
                    device="cuda")
    y = torch.randint(0, 10, (VISION_B,), generator=gx, device="cuda")
    eng, model = _resnet_step(torch, pt, "cuda", state, x, y)
    _timed_step(torch, eng, x, y)                      # warm-up
    off = [_timed_step(torch, eng, x, y) for _ in range(2)]
    pt.set_flags({"FLAGS_check_nan_inf": True})
    try:
        on = [_timed_step(torch, eng, x, y) for _ in range(2)]
        pt.set_flags({"FLAGS_check_nan_inf": False})
        with torch.no_grad():
            model.layer2[1].bn2.weight.view(-1)[0] = float("inf")
        pt.set_flags({"FLAGS_check_nan_inf": True})
        raised = None
        try:
            eng.train_batch(x, y)
        except FloatingPointError as e:
            raised = str(e)
        # a graphed engine refuses to run under the flag
        geng, _ = _resnet_step(torch, pt, "cuda", state, x, y, graphs=True)
        try:
            geng.train_batch(x, y)
            refused = None
        except RuntimeError as e:
            refused = str(e)
    finally:
        pt.set_flags({"FLAGS_check_nan_inf": False})
    res["d_nan_inf"] = dict(
        batch=VISION_B, eager_step_s_off=[s for _, s in off],
        eager_step_s_on=[s for _, s in on], losses_on=[l for l, _ in on],
        planted="layer2.1.bn2.weight[0] = inf", raised=raised,
        graphed_refused=refused)
    log(f"phase 34 (d) FLAGS_check_nan_inf, {res['card']}: "
        + json.dumps(res["d_nan_inf"]))
    check(all(math.isfinite(l) for l, _ in off + on),
          f"phase 34 (d): a clean step's loss is not finite "
          f"({res['d_nan_inf']})")
    check(raised is not None and "NaN/Inf detected in output of op" in raised,
          f"phase 34 (d): the planted Inf did not raise FloatingPointError "
          f"({raised})")
    check(refused is not None and "FLAGS_check_nan_inf" in refused,
          f"phase 34 (d): the graphed engine ran under the flag ({refused})")
    del eng, model, geng
    _free(torch)

    # (d) C3: one step at B = 1 on 3 x 32 x 32: the card and the CPU in
    # fp32, each against the CPU's fp64 step
    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        g1 = torch.Generator().manual_seed(346)
        x1 = torch.randn(1, 3, 32, 32, generator=g1)
        y1 = torch.tensor([3])
        bufs = {}
        for dev, dt in (("cuda", torch.float32), ("cpu", torch.float32),
                        ("cpu", torch.float64)):
            eng, model = _resnet_step(torch, pt, dev, state, x1, y1,
                                      dtype=dt)
            loss = eng.train_batch(x1.to(dev, dt), y1.to(dev)).item()
            bufs[dev, dt] = (loss, {n: t.detach().cpu().double() for n, t
                                    in model.named_buffers()})
            del eng, model
    finally:
        cudnn.allow_tf32 = saved
    f64 = bufs["cpu", torch.float64][1]
    worst = (0.0, None)
    for n, ref in f64.items():
        scale = ref.norm().item()
        noise = (bufs["cpu", torch.float32][1][n] - ref).norm().item()
        err = (bufs["cuda", torch.float32][1][n] - ref).norm().item()
        bound = TENSOR_C3_FACTOR * noise + TENSOR_C3_FLOOR * scale
        worst = max(worst, (err / bound if err else 0.0, n))
    card_cpu = max((((bufs["cuda", torch.float32][1][n] - b).abs().max()
                     / b.abs().max().clamp_min(1e-30)).item(), n)
                   for n, b in bufs["cpu", torch.float32][1].items())
    res["d_c3"] = dict(
        batch=1, size=32, tf32=False,
        loss_card=bufs["cuda", torch.float32][0],
        loss_cpu=bufs["cpu", torch.float32][0],
        loss_cpu_fp64=bufs["cpu", torch.float64][0],
        card_over_fp32_noise=worst[0], worst_buffer=worst[1],
        card_vs_cpu_err_over_max=card_cpu[0], card_vs_cpu_worst=card_cpu[1],
        factor=TENSOR_C3_FACTOR, floor=TENSOR_C3_FLOOR)
    log("phase 34 (d) C3 B=1 32x32 step, card against CPU: "
        + json.dumps(res["d_c3"]))
    check(worst[0] <= 1.0 and math.isfinite(res["d_c3"]["loss_card"]),
          f"phase 34 (d) C3: {res['d_c3']}")

    # (d) C2: a bf16 state dict saved from the card loads as bf16
    sd = {n: t.to("cuda", torch.bfloat16) for n, t in
          ref_model.state_dict().items()}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "resnet50_bf16.pdparams")
        pt.save(sd, path)
        back = pt.load(path, device="cuda")
        nbytes = os.path.getsize(path)
    same = all(back[n].dtype == torch.bfloat16 and back[n].is_cuda
               and torch.equal(back[n].view(torch.int16), t.view(torch.int16))
               for n, t in sd.items())
    res["d_c2"] = dict(entries=len(sd), file_bytes=nbytes, bf16_bitwise=same)
    log("phase 34 (d) C2 bf16 save / load: " + json.dumps(res["d_c2"]))
    check(same and len(back) == len(sd),
          "phase 34 (d) C2: the bf16 state dict did not load back as bf16 "
          "bit for bit")

    # (d) AMP's product hooks on CUDA inputs
    p32 = torch.randn(64, 128, device="cuda")
    q32 = torch.randn(128, 32, device="cuda")
    with amp.auto_cast(level="O1"):
        dts = dict(matmul=pt.matmul(p32, q32).dtype,
                   mm=pt.mm(p32, q32).dtype,
                   bmm=pt.bmm(p32[None], q32[None]).dtype)
    res["d_amp"] = {k: str(v) for k, v in dts.items()}
    log("phase 34 (d) AMP O1 products: " + json.dumps(res["d_amp"]))
    check(all(d == torch.bfloat16 for d in dts.values()),
          f"phase 34 (d) AMP: {res['d_amp']}")
    del ref_model, sd, back
    _free(torch)
    res["phase_s"] = time.perf_counter() - t0
    log(f"phase 34: {res['phase_s']:.1f} s, {card_line()}")
    return res


# -------------------------------------------------------------- phase 35
# BASELINE config 5, the OCR pair (PP-OCRv4 det + rec), through the
# recurrent layers, CTC and the rest of nn: (a) CRNN + CTC training at
# tools/model_benchmark.py:190-229's recipe (CRNN(10, in_channels=1),
# hidden 96, B = 64 x 1 x 32 x 96, labels of 5 digits in 1..10, Adam(1e-3),
# ParallelEngine(loss_fn=None, remat=False): the model computes its own
# loss); (b) DBNet training at a detector's real input size, B = 16 x 3 x
# 640 x 640 (the crop and per-card batch of PaddleOCR's DB training config
# det_mv3_db.yml), db_loss over seeded shrink and threshold maps; (c) the
# card against the port on the CPU (TF32 off); (d) the new functional ops
# on the card against the CPU, ctc_loss timed beside torch's F.ctc_loss
# (a yardstick: never on the path); (e) one eval forward of each vision
# family at its native size
OCR_B, OCR_H, OCR_W, OCR_LABEL = 64, 32, 96, 5
DB_B, DB_SIZE = 16, 640
OCR_CHECK_B, DB_CHECK_B, DB_CHECK_SIZE = 4, 2, 160
# (d): the recurrent layers at CRNN's widths, 2 layers, bidirectional
RNN_T, RNN_B, RNN_IN, RNN_H = 24, 64, 256, 96
# (e): each family at its native input, B = 2
ZOO = (("LeNet", 28, 1), ("alexnet", 224, 3), ("vgg11", 224, 3),
       ("mobilenet_v1", 224, 3), ("mobilenet_v2", 224, 3),
       ("mobilenet_v3_small", 224, 3), ("squeezenet1_1", 224, 3),
       ("shufflenet_v2_x1_0", 224, 3), ("densenet121", 224, 3),
       ("googlenet", 224, 3), ("inception_v3", 299, 3))
ZOO_B = 2
# (c)-(e) limits: the largest |card - CPU| over the largest |CPU| value,
# TF32 off. Phase 33 (e)'s 1e-3 (ResNet-50's logits read 2.9e-6) is the
# starting point for every comparison; the greedy CTC decodes must be
# equal
OCR_CPU_TOL = 1e-3
# (c)'s Adam step, row 10 against its plain version from the same state,
# moments, gradients and [lr, 1/bc1, 1/bc2], each rounding every operation
# to nearest in fp32 in one order. Limits of the largest |CPU| value, and
# each parameter within 4 fp32 spacings of the step's largest operand or
# result. Measured on an H100 80GB HBM3 at 700 W: moments bit for bit, the
# parameters 7.9e-8 (CRNN) and 1.0e-7 (DBNet) of the largest apart, each
# within 2 spacings (which operation rounds otherwise is not isolated);
# 1.3e-5 of the largest change (so the change is not held to a share of
# itself) and 64 spacings of a result near zero (nor to that)
ADAM_CPU_TOL = dict(params=1e-6, param_ulps=4.0, moment1=1e-6,
                    moment2=1e-6)
# (c): CRNN's decodes are compared on a freshly seeded CRNN over this many
# images (the trained one emits only blanks after VISION_STEPS steps)
OCR_DECODE_B = 16


# the ATen products whose kernels are the OCR step's "matmul" class
PRODUCT_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
               "aten::mv", "aten::addmv")


class _SiteSplit:
    """The OCR step's kernel classes by launch site: a kernel that an ATen
    product (``PRODUCT_OPS``: CRNN's LSTM products and its head; DBNet has
    none) or a convolution (any op named ``*convolution*``, forward or
    backward) launched is "matmul" or "conv" whatever its name; any other
    by phase 33's name classes, the port's own kernels (row 10) first.
    An eager trace lists under each op the kernels it launched; a graph
    replay's kernels have no op, so each takes the split its name had in
    the eager twin's trace (run that first, on the same instance)."""

    def __init__(self):
        self.seen = {}          # kernel name -> {class: seconds}, eager

    @staticmethod
    def _site(op):
        while op is not None:
            if op.name in PRODUCT_OPS:
                return "matmul"
            if "convolution" in op.name:
                return "conv"
            op = op.cpu_parent
        return None

    @staticmethod
    def _by_name(name):
        for frag, own in OWN_KERNELS.items():
            if frag in name:
                return own
        cls = _vision_class(name)
        # a library product kernel that no product or convolution launched
        return "other" if cls == "conv" else cls

    def split(self, device, events):
        from torch.autograd import DeviceType

        # the kernels each op of this trace launched, by launch site
        here = {}
        for e in events:
            if e.device_type != DeviceType.CPU or not e.kernels:
                continue
            site = self._site(e)
            for k in e.kernels:
                c = site or self._by_name(k.name)
                d = here.setdefault(k.name, {})
                d[c] = d.get(c, 0.0) + k.duration
        for name, d in here.items():
            seen = self.seen.setdefault(name, {})
            for c, t in d.items():
                seen[c] = seen.get(c, 0.0) + t
        classes = {}
        for e in device:
            t = e.time_range.elapsed_us() * 1e-6
            shares = here.get(e.name) or self.seen.get(e.name) or {
                self._by_name(e.name): 1.0}
            total = sum(shares.values())
            for c, s in shares.items():
                classes[c] = classes.get(c, 0.0) + t * s / total
        return classes


def _rnn_flops(layers, directions, T, B, inputs, H, gates):
    """2 x the multiply-adds of a recurrent layer's products over T steps:
    each step x W_ih^T and h W_hh^T, gates x H columns."""
    return sum(2 * directions * T * B * gates * H * (i + H) for i in inputs)


def _ocr_model(torch, kind, seed, device="cuda"):
    """A seeded CRNN (config 5's rec) or DBNet, wrapped to compute its own
    loss (``.net`` the model)."""
    from paddle_tpu_torch.nn import Layer
    from paddle_tpu_torch.vision import models as vm

    g = torch.Generator(device=device).manual_seed(seed)

    class WithLoss(Layer):
        def __init__(self, net):
            super().__init__()
            self.net = net

        def forward(self, x, *targets):
            out = self.net(x)
            if kind == "crnn":
                return vm.crnn_ctc_loss(out, *targets)
            return vm.db_loss(out["maps"], *targets)

    net = vm.CRNN(10, in_channels=1, generator=g, device=device) \
        if kind == "crnn" else vm.DBNet(generator=g, device=device)
    return WithLoss(net)


def _ocr_make(torch, kind, seed):
    """:func:`_ocr_model` on the card with its Adam(1e-3) and its
    ParallelEngine(loss_fn=None, remat=False), the recipe's."""
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel import ParallelEngine

    model = _ocr_model(torch, kind, seed)
    opt = Adam(learning_rate=1e-3, parameters=model.parameters())
    return model, ParallelEngine(model, optimizer=opt, loss_fn=None,
                                 remat=False)


def _ocr_batch(torch, kind, seed, B, size=None, device="cuda"):
    g = torch.Generator(device=device).manual_seed(seed)
    if kind == "crnn":
        return (torch.rand(B, 1, OCR_H, OCR_W, generator=g, device=device),
                torch.randint(1, 11, (B, OCR_LABEL), generator=g,
                              device=device, dtype=torch.int32),
                torch.full((B,), OCR_LABEL, dtype=torch.int32,
                           device=device))
    S = size

    def draw(lo=0.0, hi=1.0):
        return torch.rand(B, S, S, generator=g, device=device) * (hi - lo) \
            + lo

    return (torch.rand(B, 3, S, S, generator=g, device=device),
            (draw() > 0.7).float(), (draw() > 0.1).float(),
            draw(0.3, 0.7), (draw() > 0.5).float())


def _ocr_cell(torch, ops, kind, batch, label, graphs, flops, images,
              split):
    """Phase 33's cell (:func:`_vision_cell`) on a fresh seeded engine,
    graphed or its eager twin, its device time split by launch site
    (``split``, a :class:`_SiteSplit`): row 10 launched once a trainable
    parameter each step (the model's own count, which the engine's and
    the optimizer's must equal) and no other kernel of §6; every BatchNorm
    statistic must move. Returns (the cell, the snapshot, the engine)."""
    model, eng = _ocr_make(torch, kind, 35)
    eng.graphs = graphs
    n_train = sum(1 for p in model.parameters()
                  if getattr(p, "trainable", True))
    check(n_train == len(eng.trained) == len(eng.optimizer._accumulators),
          f"{label}: the model has {n_train} trainable parameters, the "
          f"engine trains {len(eng.trained)}, Adam keeps "
          f"{len(eng.optimizer._accumulators)} moments")
    before = {n: b.detach().clone() for n, b in model.named_buffers()}
    res, snap = _vision_cell(torch, ops, eng, batch, label, flops,
                             TF32_FLOPS, images, {"fused_adamw": n_train},
                             split)
    moved = sum(not torch.equal(snap[n], before[n]) for n in before)
    res.update(trainable_tensors=n_train, bn_buffers=len(before),
               bn_buffers_moved=moved)
    check(moved == len(before), f"{label}: {len(before) - moved} BatchNorm "
                                f"buffers did not move")
    return res, snap, eng


def _ocr_twins(torch, ops, kind, batch, label, flops, images):
    """The eager twin, then the graphed cell (VISION_STEPS steps each; the
    replays' classes take the eager trace's launch sites), bit for bit:
    losses, parameters, both Adam moments and the BatchNorm statistics.
    Returns (the record, the graphed engine)."""
    split = _SiteSplit()
    eager, snap_e, _ = _ocr_cell(torch, ops, kind, batch,
                                 f"{label} (eager)", False, flops, images,
                                 split)
    res, snap, eng = _ocr_cell(torch, ops, kind, batch,
                               f"{label} (graphs)", True, flops, images,
                               split)
    diffs = [k for k in snap if not torch.equal(snap[k], snap_e[k])]
    bitwise = dict(losses_equal=res["losses"] == eager["losses"],
                   tensors=len(snap), tensors_differing=len(diffs),
                   first_differing=diffs[:3])
    log(f"{label} graphs against eager: " + json.dumps(bitwise))
    check(bitwise["losses_equal"] and not diffs,
          f"{label}: graphed and eager steps differ: {bitwise}")
    check(res["launches"] == eager["launches"],
          f"{label}: launches {res['launches']} != eager "
          f"{eager['launches']}")
    return dict(graphs=res, eager=eager, bitwise=bitwise,
                ms_per_step_graphs_over_eager=res["ms_per_step"]
                / eager["ms_per_step"]), eng


def _err(torch, card, host) -> float:
    """The largest |card - host| over the largest |host| value."""
    c = card.detach().float().cpu()
    h = host.detach().float()
    return ((c - h).abs().max() / h.abs().max().clamp_min(1e-30)).item()


def _greedy_ctc(logits):
    """examples/ocr_recognition.py:57-67's decode: each step's argmax, runs
    collapsed, blanks (0) dropped."""
    out = []
    for row in logits.argmax(-1).tolist():
        seq, prev = [], 0
        for t in row:
            if t != 0 and t != prev:
                seq.append(t)
            prev = t
        out.append(seq)
    return out


def _adam_against_cpu(torch, eng, grads):
    """One Adam step at the recipe's hyperparameters (lr 1e-3, decay 0,
    fp32 parameters, no master) over every trained tensor, from the
    engine's parameters and both moments after its steps, at its step
    count + 1, on the gradients ``grads`` ({name: CPU tensor}): row 10's
    wrapper on the card against its plain version on the CPU, both given
    the CPU's [lr, 1/bc1, 1/bc2] (the card's fp32 powers may round
    otherwise; whether they do is reported). Returns the largest |card -
    CPU| over the largest |CPU| of the parameters and of each moment, the
    largest elementwise difference of the parameters in fp32 spacings of
    the largest of the parameter before the step, the change and the
    result (``param_ulps``), and, unchecked, the largest difference of the
    step's change over its largest."""
    from paddle_tpu_torch.ops.fused_adamw import (adamw_scalars,
                                                  fused_adamw_update)

    opt = eng.optimizer
    b1, b2, eps = opt._beta1, opt._beta2, opt._epsilon
    step = eng._step_count + 1
    scalars = {dev: adamw_scalars(1e-3, step, torch.tensor(
        [b1, b2], dtype=torch.float32, device=dev)) for dev in ("cuda", "cpu")}
    errs = dict(params=0.0, param_ulps=0.0, moment1=0.0, moment2=0.0)
    update = 0.0
    for n, p in eng.trained:
        out = {}
        for dev in ("cuda", "cpu"):
            q = p.detach().to(dev, copy=True)
            m, v = (opt._accumulators[n][k].to(dev, copy=True)
                    for k in ("moment1", "moment2"))
            g = grads.get(n)
            g = torch.zeros_like(q) if g is None else g.to(dev)
            fused_adamw_update(q, g, m, v, scalars=scalars["cpu"].to(dev),
                               b1=b1, b2=b2, eps=eps, decay=0.0)
            out[dev] = (q, m, v)
        p0 = p.detach().cpu()
        (qc, mc, vc), (qh, mh, vh) = out["cuda"], out["cpu"]
        errs["params"] = max(errs["params"], _err(torch, qc, qh))
        # elementwise, in fp32 spacings of the largest of the parameter
        # before the step, the change and the result (near a zero crossing
        # the result is far smaller than the others)
        big = torch.maximum(torch.maximum(p0.abs(), (qh - p0).abs()),
                            qh.abs())
        spacing = torch.nextafter(big, torch.tensor(math.inf)) - big
        errs["param_ulps"] = max(errs["param_ulps"], (
            (qc.cpu() - qh).abs() / spacing).max().item())
        update = max(update, _err(torch, qc.cpu() - p0, qh - p0))
        errs["moment1"] = max(errs["moment1"], _err(torch, mc, mh))
        errs["moment2"] = max(errs["moment2"], _err(torch, vc, vh))
    return dict(step=step, tensors=len(eng.trained), err_over_max=errs,
                limits=ADAM_CPU_TOL, update_err_over_max=update,
                scalars_card_equal_cpu=torch.equal(
                    scalars["cuda"].cpu(), scalars["cpu"]))


def _ocr_against_cpu(torch, kind, eng, batch):
    """(c): one train-mode forward, loss and backward of the engine's
    model on the card (TF32 off) and of the port on the CPU holding its
    state: the loss, every gradient and the BatchNorm statistics the
    forward leaves; one Adam step from the engine's state and moments on
    both (:func:`_adam_against_cpu`); the eval outputs. CRNN: the greedy
    decodes and each step's argmax of a freshly seeded CRNN (the trained
    one decodes every image to blanks), which must be equal and not all
    blank."""
    card_model = eng.model
    host_model = _ocr_model(torch, kind, 0, device="cpu")
    card_state = {k: v.detach().cpu() for k, v in
                  card_model.state_dict().items()}
    host_model.set_state_dict(card_state)
    res = dict(kind=kind)
    losses, grads, bufs = {}, {}, {}
    for dev, m in (("cuda", card_model), ("cpu", host_model)):
        m.train()
        m.clear_gradients()
        b = [t.to(dev) for t in batch]
        loss = m(*b)
        loss.backward()
        losses[dev] = loss.item()
        grads[dev] = {n: p.grad for n, p in m.named_parameters()}
        bufs[dev] = dict(m.named_buffers())
    res["loss_card"], res["loss_cpu"] = losses["cuda"], losses["cpu"]
    res["loss_rel_gap"] = abs(losses["cuda"] - losses["cpu"]) / abs(
        losses["cpu"])
    res["grad_err_over_max"] = max(_err(torch, grads["cuda"][n], g)
                                   for n, g in grads["cpu"].items())
    res["bn_err_over_max"] = max(_err(torch, bufs["cuda"][n], b)
                                 for n, b in bufs["cpu"].items())
    res["adam"] = _adam_against_cpu(torch, eng, grads["cpu"])
    card_model.clear_gradients()
    outs = {}
    for dev, m in (("cuda", card_model), ("cpu", host_model)):
        m.eval()
        with torch.no_grad():
            o = m.net(batch[0].to(dev))
        outs[dev] = o if kind == "crnn" else o["maps"]
        m.train()
    res["eval_err_over_max"] = _err(torch, outs["cuda"], outs["cpu"])
    if kind == "crnn":
        res["decode"] = _decodes_against_cpu(torch)
    res["tolerance"] = OCR_CPU_TOL
    log(f"phase 35 (c) {kind} card against the CPU: " + json.dumps(res))
    for k in ("loss_rel_gap", "grad_err_over_max", "bn_err_over_max",
              "eval_err_over_max"):
        check(res[k] <= OCR_CPU_TOL, f"phase 35 (c) {kind}: {k} {res[k]:.3g}"
                                     f" over the limit {OCR_CPU_TOL}")
    for k, err in res["adam"]["err_over_max"].items():
        check(err <= ADAM_CPU_TOL[k], f"phase 35 (c) {kind}: Adam's step "
                                      f"{k} {err:.3g} over the limit "
                                      f"{ADAM_CPU_TOL[k]}")
    return res


def _decodes_against_cpu(torch):
    """CRNN's eval logits, their per-step argmax and greedy decodes on the
    card against the CPU, on a freshly seeded CRNN and OCR_DECODE_B
    images: every argmax equal, every decode equal, not all blank."""
    card = _ocr_model(torch, "crnn", 352).net
    host = _ocr_model(torch, "crnn", 0, device="cpu").net
    host.set_state_dict({k: v.detach().cpu()
                         for k, v in card.state_dict().items()})
    x = _ocr_batch(torch, "crnn", 353, OCR_DECODE_B, device="cpu")[0]
    card.eval()
    host.eval()
    with torch.no_grad():
        oc, oh = card(x.cuda()).cpu(), host(x)
    card_dec, host_dec = _greedy_ctc(oc), _greedy_ctc(oh)
    top2 = oh.topk(2, -1).values
    res = dict(images=OCR_DECODE_B, err_over_max=_err(torch, oc, oh),
               step_argmax_equal_share=(oc.argmax(-1) == oh.argmax(-1))
               .float().mean().item(),
               non_blank_step_share=(oh.argmax(-1) != 0).float().mean()
               .item(),
               min_top2_margin_over_max=((top2[..., 0] - top2[..., 1]).min()
                                         / oh.abs().max()).item(),
               decodes_equal=card_dec == host_dec, decodes=card_dec[:4])
    check(res["non_blank_step_share"] > 0, "phase 35 (c) crnn: the seeded "
                                           "CRNN decodes only blanks: the "
                                           "decode check would be vacuous")
    check(res["step_argmax_equal_share"] == 1.0 and res["decodes_equal"],
          f"phase 35 (c) crnn: the card's argmax or greedy decodes differ "
          f"from the CPU's: {res}")
    check(res["err_over_max"] <= OCR_CPU_TOL,
          f"phase 35 (c) crnn: the fresh CRNN's logits are "
          f"{res['err_over_max']:.3g} off the CPU's")
    return res


def _ops_against_cpu(torch):
    """(d): the recurrent layers (2 layers, bidirectional, T = 24, B = 64
    at CRNN's widths), ctc_loss and its gradient, and interpolate in every
    mode up and down, on the card against the port on the CPU; ctc_loss
    timed against torch's F.ctc_loss on the same inputs."""
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.nn import functional as F

    g = torch.Generator().manual_seed(351)
    res = {}
    x = torch.randn(RNN_B, RNN_T, RNN_IN, generator=g)
    for name in ("LSTM", "GRU", "SimpleRNN"):
        host = getattr(pnn, name)(RNN_IN, RNN_H, num_layers=2,
                                  direction="bidirect", device="cpu")
        card = getattr(pnn, name)(RNN_IN, RNN_H, num_layers=2,
                                  direction="bidirect", device="cuda")
        card.set_state_dict(host.state_dict())
        outs = {}
        for dev, layer in (("cuda", card), ("cpu", host)):
            xd = x.to(dev).clone().requires_grad_()
            out, st = layer(xd)
            out.square().sum().backward()
            st = st if isinstance(st, tuple) else (st,)
            outs[dev] = [out, *st, xd.grad]
        keys = ("out", "h", "c", "x_grad") if name == "LSTM" else \
            ("out", "h", "x_grad")
        res[name] = {k: _err(torch, c, h) for k, c, h in
                     zip(keys, outs["cuda"], outs["cpu"])}
    # ctc: CRNN's step shapes (T = 23, B = 64, 11 classes, 5 labels)
    T, B, C = OCR_W // 4 - 1, OCR_B, 11
    logits = torch.randn(T, B, C, generator=g)
    labels = torch.randint(1, C, (B, OCR_LABEL), generator=g)
    in_len = torch.full((B,), T, dtype=torch.long)
    in_len[::4] = T - 3                      # rows that stop early
    lab_len = torch.randint(1, OCR_LABEL + 1, (B,), generator=g)
    ctc = {}
    for dev in ("cpu", "cuda"):
        lg = logits.to(dev).clone().requires_grad_()
        loss = F.ctc_loss(lg, labels.to(dev), in_len.to(dev),
                          lab_len.to(dev), reduction="none")
        loss.sum().backward()
        ctc[dev] = (loss, lg.grad)
    res["ctc_loss"] = dict(loss=_err(torch, ctc["cuda"][0], ctc["cpu"][0]),
                           grad=_err(torch, ctc["cuda"][1], ctc["cpu"][1]))
    args = (labels.cuda(), in_len.cuda(), lab_len.cuda())
    with torch.no_grad():
        lib = torch.nn.functional.ctc_loss(
            torch.log_softmax(logits.cuda(), -1), *args, reduction="none",
            zero_infinity=False)
    res["ctc_loss"]["against_torch_ctc"] = _err(torch, lib, ctc["cpu"][0])
    # each timed body on a leaf of its own (a leaf whose autograd node an
    # earlier graph on the default stream keeps alive breaks a capture)
    lg = logits.cuda().clone().requires_grad_()
    lg_lib = logits.cuda().clone().requires_grad_()

    def ours():
        loss = F.ctc_loss(lg, *args, reduction="none")
        torch.autograd.grad(loss.sum(), lg)

    def library():
        loss = torch.nn.functional.ctc_loss(torch.log_softmax(lg_lib, -1),
                                            *args, reduction="none")
        torch.autograd.grad(loss.sum(), lg_lib)

    res["ctc_loss"].update(
        ms_graphed=time_ms(ours, 20), ms_eager=event_ms(torch, ours, 10),
        torch_ctc_loss_ms_eager=event_ms(torch, library, 10),
        shape=dict(T=T, B=B, C=C, L=OCR_LABEL),
        timed="forward + backward of the summed per-row losses")
    # interpolate: every mode, up and down, 3-, 4- and 5-D
    cases = [("nearest", 4, (13, 21)), ("nearest", 4, (5, 7)),
             ("bilinear", 4, (40, 48)), ("bilinear", 4, (9, 11)),
             ("bicubic", 4, (40, 48)), ("bicubic", 4, (9, 11)),
             ("bilinear_align", 4, (40, 11)), ("linear", 3, (50,)),
             ("linear", 3, (11,)), ("trilinear", 5, (12, 9, 20)),
             ("area", 4, (7, 7)), ("nearest", 5, (3, 9, 13))]
    shapes = {3: (4, 8, 24), 4: (4, 8, 24, 24), 5: (2, 4, 6, 12, 10)}
    res["interpolate"] = {}
    for mode, nd, size in cases:
        src = torch.randn(shapes[nd], generator=g)
        kw = dict(size=list(size), mode=mode.replace("_align", ""),
                  align_corners=mode.endswith("_align"),
                  data_format={3: "NCW", 4: "NCHW", 5: "NCDHW"}[nd])
        res["interpolate"][f"{mode} {nd}-D {list(size)}"] = _err(
            torch, F.interpolate(src.cuda(), **kw), F.interpolate(src, **kw))
    worst = max([v for r in (res["LSTM"], res["GRU"], res["SimpleRNN"],
                             res["interpolate"]) for v in r.values()]
                + [res["ctc_loss"]["loss"], res["ctc_loss"]["grad"],
                   res["ctc_loss"]["against_torch_ctc"]])
    res["worst_err_over_max"] = worst
    res["tolerance"] = OCR_CPU_TOL
    log("phase 35 (d) functional ops, card against the CPU: "
        + json.dumps(res))
    check(worst <= OCR_CPU_TOL, f"phase 35 (d): an op is {worst:.3g} of "
                                f"its largest value off the CPU (limit "
                                f"{OCR_CPU_TOL}): {res}")
    return res


def _zoo_against_cpu(torch):
    """(e): one eval forward of each family at its native size, B = 2, on
    the card (TF32 off) against the port on the CPU on the same weights and
    images."""
    from paddle_tpu_torch.vision import models as vm

    res = {}
    g = torch.Generator().manual_seed(353)
    for name, size, ch in ZOO:
        t0 = time.perf_counter()
        card = getattr(vm, name)(num_classes=1000, device="cuda",
                                 generator=torch.Generator(
                                     device="cuda").manual_seed(354))
        host = getattr(vm, name)(num_classes=1000, device="cpu")
        host.set_state_dict({k: v.cpu() for k, v in
                             card.state_dict().items()})
        card.eval()
        host.eval()
        x = torch.randn(ZOO_B, ch, size, size, generator=g)
        with torch.no_grad():
            oc = card(x.cuda())
            oh = host(x)
        if isinstance(oc, tuple):               # GoogLeNet's aux heads
            oc, oh = torch.cat(oc, -1), torch.cat(oh, -1)
        res[name] = dict(size=size, err_over_max=_err(torch, oc, oh),
                         params=sum(p.numel() for p in card.parameters()),
                         s=time.perf_counter() - t0)
        del card, host
    worst = max(r["err_over_max"] for r in res.values())
    log("phase 35 (e) zoo eval, card against the CPU: " + json.dumps(res))
    check(worst <= OCR_CPU_TOL, f"phase 35 (e): a family's logits are "
                                f"{worst:.3g} of the largest off the CPU "
                                f"(limit {OCR_CPU_TOL})")
    return dict(families=res, worst_err_over_max=worst,
                tolerance=OCR_CPU_TOL)


def ocr(torch, ops):
    """Phase 35: BASELINE config 5 (the OCR pair) through the recurrent
    layers, CTC and the rest of ``nn`` (see the module docstring): (a)
    CRNN + CTC and (b) DBNet training, graphed and their eager twins bit
    for bit under deterministic cuDNN, row 10 once a trainable parameter a
    step; (c) both against the port on the CPU; (d) the recurrent layers,
    ctc_loss and interpolate against the CPU, ctc_loss timed beside
    F.ctc_loss; (e) the vision zoo's eval forwards against the CPU."""
    from paddle_tpu_torch.vision import models as vm

    t0 = time.perf_counter()
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32)
    cudnn.deterministic, cudnn.benchmark = True, False
    flags = dict(cudnn_allow_tf32=cudnn.allow_tf32,
                 matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
                 cudnn_deterministic=True, cudnn_benchmark=False)
    log("phase 35 settings: " + json.dumps(flags) + f", TF32 peak "
        f"{TF32_FLOPS:.3g} (dense), {card_line()}")
    res = dict(settings=flags)
    try:
        # (a) CRNN + CTC at config 5's recipe
        batch = _ocr_batch(torch, "crnn", 350, OCR_B)
        probe = vm.CRNN(10, in_channels=1, device="cuda")
        T = OCR_W // 4 - 1
        flops = 3 * (_conv_fc_flops(torch, probe, batch[0][:1]) * OCR_B
                     + _rnn_flops(2, 2, T, OCR_B, (256, 192), 96, 4))
        res["model_crnn"] = dict(
            params=sum(p.numel() for p in probe.parameters()),
            parameter_tensors=len(probe.parameters()),
            buffers=len(probe.buffers()), steps_T=T,
            flops_per_step=flops,
            flops_formula="3 x (2 x MACs of the convs, the head and the "
                          "LSTM's products) a training batch")
        del probe
        res["a"], crnn_eng = _ocr_twins(
            torch, ops, "crnn", batch, f"phase 35 (a) crnn+ctc B={OCR_B}",
            flops, OCR_B)
        _free(torch)
        # (b) DBNet at 640 x 640, B = 16
        dbatch = _ocr_batch(torch, "dbnet", 360, DB_B, DB_SIZE)
        probe = vm.DBNet(device="cuda")
        flops = 3 * _conv_fc_flops(torch, probe, dbatch[0][:1]) * DB_B
        res["model_dbnet"] = dict(
            params=sum(p.numel() for p in probe.parameters()),
            parameter_tensors=len(probe.parameters()),
            buffers=len(probe.buffers()), flops_per_step=flops)
        del probe
        res["b"], db_eng = _ocr_twins(
            torch, ops, "dbnet", dbatch, f"phase 35 (b) dbnet B={DB_B} "
            f"{DB_SIZE}x{DB_SIZE}", flops, DB_B)
        del dbatch
        _free(torch)
        # (c) against the port on the CPU, TF32 off
        cudnn.allow_tf32 = False
        res["c"] = dict(
            crnn=_ocr_against_cpu(torch, "crnn", crnn_eng,
                                  [t[:OCR_CHECK_B] for t in batch]),
            dbnet=_ocr_against_cpu(torch, "dbnet", db_eng, _ocr_batch(
                torch, "dbnet", 361, DB_CHECK_B, DB_CHECK_SIZE)))
        del crnn_eng, db_eng
        _free(torch)
        # (d) the functional ops; (e) the zoo
        res["d"] = _ops_against_cpu(torch)
        res["e"] = _zoo_against_cpu(torch)
    finally:
        cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32 = saved
    _free(torch)
    res["launches"] = dict(
        crnn_per_step=res["a"]["graphs"]["launches_per_step"],
        dbnet_per_step=res["b"]["graphs"]["launches_per_step"])
    res["phase_s"] = time.perf_counter() - t0
    log(f"phase 35: {res['phase_s']:.1f} s, {card_line()}")
    return res


# --------------------------------------------------------------- phase 36
# (a) BASELINE config 1 as examples/resnet_cifar10.py runs it: --model
# resnet50 (BASELINE.md's model), --batch 64, one epoch of the synthetic
# Cifar10 (2048 images: 32 steps, 32 eval batches), fit(num_workers=2)
HAPI_MODEL, HAPI_B, HAPI_WORKERS = "resnet50", 64, 2
CIFAR_MEAN, CIFAR_STD = [0.4914, 0.4822, 0.4465], [0.247, 0.243, 0.262]
# (b) LeNet on MNIST with Adam (row 10 once a trainable parameter a
# step), as tests/test_models_e2e.py drives the hapi API
MNIST_B = 64
MNIST_MEAN, MNIST_STD = [0.1307], [0.3081]
# (c) detection shapes: an FPN level (stride 16 of an 800 x 1088 image)
# with 512 RoIs at 7 x 7 (psroi_pool at 490 channels: R-FCN's 10 classes
# x 49 bins), the CPU holding the first VOPS_CHECK_ROIS RoIs (each RoI's
# output and its share of the gradient are its own); deformable
# convolution at a ResNet stage-2 map, 3 x 3; one YOLOv3 head (13 x 13, 3
# anchors, 80 classes) at B = 8 with 16 ground-truth slots
VOPS_FEAT, VOPS_SCALE = (2, 256, 50, 68), 1 / 16
VOPS_PS_C, VOPS_ROIS, VOPS_CHECK_ROIS = 490, 512, 64
VOPS_DEFORM = (2, 64, 56, 56)
YOLO_N, YOLO_HW, YOLO_CLASSES, YOLO_GT = 8, 13, 80, 16
YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                156, 198, 373, 326]
# (c) limit of every floating op: the largest |card - CPU| over the
# largest |CPU| value (fp32, TF32 off: gathers and the same products);
# the host ops (NMS family, proposals, FPN routing, prior boxes) read the
# card's tensors back and must give the CPU's results exactly. Each limit
# is shown to reject a planted fault (the op on the CPU with one input or
# setting off)
VOPS_TOL = 1e-4
# (d) the token reader: Llama-3-8B's B x S over a seeded file of int32
# tokens (~64 M: 256 MB) in a temporary directory
TOKEN_B, TOKEN_S, TOKEN_FILE_TOKENS, TOKEN_BATCHES = 2, 2048, 64 * 2 ** 20, 256
TOKEN_VOCAB = 128256


class _WorkerProbe:
    """A map-style dataset around another, checking in every
    ``__getitem__`` that it runs in a DataLoader worker process (not the
    main process, not the loader's thread fallback) and that the worker
    has no CUDA: a sample read anywhere else raises, and the loader ships
    the error to the parent. Module-level, so that a ``forkserver``
    worker unpickles it by reference."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        import torch
        from paddle_tpu_torch.io import get_worker_info

        if get_worker_info() is None:
            raise RuntimeError("a sample was read outside a DataLoader "
                               "worker process")
        if torch.cuda.is_initialized() or torch.cuda._is_in_bad_fork():
            raise RuntimeError("a DataLoader worker has CUDA up")
        return self.dataset[idx]


def _fit_clock(paddle):
    """A callback timing ``fit``: each train step's host ms (batch begin
    to end), the ms before it spent waiting on the loader (the previous
    step's end, or the train's begin, to its begin), the train and eval
    walls, the losses and the eval logs."""
    class Clock(paddle.callbacks.Callback):
        def __init__(self):
            super().__init__()
            self.steps, self.waits, self.losses = [], [], []
            self.eval_logs, self.t_end = {}, None
            self.train_s = self.eval_s = None

        def on_train_begin(self, logs=None):
            self.t_train = self.t_end = time.perf_counter()

        def on_train_batch_begin(self, step, logs=None):
            self.t_begin = time.perf_counter()
            self.waits.append((self.t_begin - self.t_end) * 1e3)

        def on_train_batch_end(self, step, logs=None):
            self.t_end = time.perf_counter()
            self.steps.append((self.t_end - self.t_begin) * 1e3)
            self.losses.append(logs["loss"])

        def on_eval_begin(self, logs=None):
            self.train_s = time.perf_counter() - self.t_train
            self.t_eval = time.perf_counter()

        def on_train_end(self, logs=None):
            if self.train_s is None:                # no eval data
                self.train_s = time.perf_counter() - self.t_train

        def on_eval_end(self, logs=None):
            self.eval_s = time.perf_counter() - self.t_eval
            self.eval_logs = dict(logs or {})

    return Clock()


def _json_logs(logs):
    """``fit`` / ``evaluate`` logs as plain floats (the metrics give numpy
    scalars)."""
    return {k: ([float(x) for x in v] if isinstance(v, (list, tuple))
                else float(v)) for k, v in logs.items()}


def _no_fallback(caught, label):
    """The loader's fallback chain warned nothing: its batches came from
    the worker processes."""
    said = [str(w.message) for w in caught
            if "falling back" in str(w.message)
            or "retrying with fork" in str(w.message)]
    check(not said, f"{label}: the DataLoader fell back: {said}")


def _busy_share(torch, fn):
    """(device-busy s, host wall s) of ``fn()``: busy is the union of the
    kernel and copy intervals of a CUDA-only profiler trace (no CPU
    events: a trace of every eager op of a ResNet-50 epoch takes longer
    to read than the epoch, and costs the host time a step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = _busy_us(e for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    check(busy > 0, "phase 36: the profiler traced no device time")
    return busy * 1e-6, wall


def _loader_rate(torch, loader) -> float:
    """Images a second of one pass over ``loader`` (host wall)."""
    t0 = time.perf_counter()
    n = sum(int(x.shape[0]) for x, _ in loader)
    return n / (time.perf_counter() - t0)


def start_loader_server():
    """Start the DataLoader workers' forkserver now (phase 36's loaders
    take ``forkserver``: CUDA is up by then), preloading the port as the
    loader does, so that the server's start, which imports torch and the
    port, overlaps the phases before it; a pool then forks its workers
    from it. It exits with this process."""
    import multiprocessing as mp
    from multiprocessing import forkserver

    from paddle_tpu_torch.io import worker_pool

    mp.get_context("forkserver").set_forkserver_preload(
        [worker_pool.__name__])
    t0 = time.perf_counter()
    forkserver.ensure_running()
    log(f"loader forkserver started in {time.perf_counter() - t0:.1f} s")


def hapi_cifar(torch, ops):
    """(a): BASELINE config 1 through ``paddle.Model`` as
    examples/resnet_cifar10.py writes it, its datasets behind
    :class:`_WorkerProbe`."""
    import warnings

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.vision import models, transforms
    from paddle_tpu_torch.vision.datasets import Cifar10

    T = transforms
    tfm = T.Compose([T.RandomHorizontalFlip(), T.ToTensor(),
                     T.Normalize(CIFAR_MEAN, CIFAR_STD)])
    eval_tfm = T.Compose([T.ToTensor(), T.Normalize(CIFAR_MEAN, CIFAR_STD)])
    train_ds = Cifar10(mode="train", transform=tfm)
    eval_ds = Cifar10(mode="test", transform=eval_tfm)

    def build():
        net = getattr(models, HAPI_MODEL)(num_classes=10)   # on the card
        model = paddle.Model(net)
        sched = optimizer.lr.CosineAnnealingDecay(0.1, T_max=1)
        opt = optimizer.Momentum(learning_rate=sched, momentum=0.9,
                                 parameters=net.parameters(),
                                 weight_decay=5e-4)
        model.prepare(opt, nn.CrossEntropyLoss(), Accuracy())
        return net, model, sched

    torch.manual_seed(36)
    net, model, _ = build()
    init = {k: v.detach().clone() for k, v in net.state_dict().items()}
    fed = []                      # the batches fit gave train_batch
    fit_train_batch = model.train_batch

    def recording(inputs, labels=None, update=True):
        fed.append((inputs, labels))
        return fit_train_batch(inputs, labels, update)
    model.train_batch = recording
    clock = _fit_clock(paddle)
    label = f"phase 36 (a) {HAPI_MODEL} B={HAPI_B}"
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        # under a CUDA-only trace: the device's busy share of the run
        busy, fit_s = _busy_share(torch, lambda: model.fit(
            _WorkerProbe(train_ds), _WorkerProbe(eval_ds), epochs=1,
            batch_size=HAPI_B, log_freq=10, num_workers=HAPI_WORKERS,
            callbacks=[clock]))
    _no_fallback(caught, label)
    del model.train_batch
    steps = len(clock.losses)
    check(steps == len(train_ds) // HAPI_B == len(fed),
          f"{label}: {steps} train steps")
    check(all(math.isfinite(x) for x in clock.losses),
          f"{label}: a loss is not finite: {clock.losses}")
    # the hand loop: train_batch over the same batches from the same
    # state, the scheduler stepped after each as fit's LRScheduler does
    net2, model2, sched2 = build()
    net2.set_state_dict(init)
    hand = []
    for inputs, labels in fed:
        hand.append(model2.train_batch(inputs, labels)[0][0])
        sched2.step()
    torch.cuda.synchronize()
    same_params = all(torch.equal(a, b) for a, b in
                      zip(net.parameters(), net2.parameters()))
    check(hand == clock.losses and same_params,
          f"{label}: fit against a hand loop of train_batch: losses equal "
          f"{hand == clock.losses}, parameters equal {same_params}")
    del net2, model2, fed
    # the loader alone, and two workers' batches against one process's
    loader = paddle.io.DataLoader
    rates = {w: _loader_rate(torch, loader(
        train_ds, batch_size=HAPI_B, shuffle=True, num_workers=w))
        for w in (0, HAPI_WORKERS)}
    one = list(loader(eval_ds, batch_size=HAPI_B))
    two = list(loader(_WorkerProbe(eval_ds), batch_size=HAPI_B,
                      num_workers=HAPI_WORKERS))
    same = len(one) == len(two) and all(
        torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        for a, b in zip(one, two))
    check(same, f"{label}: two workers' eval batches differ from one "
                f"process's")
    steps_ms = sorted(clock.steps)
    res = dict(
        steps=steps, images=steps * HAPI_B, fit_s=fit_s,
        train_s=clock.train_s, eval_s=clock.eval_s,
        fit_images_per_s=steps * HAPI_B / clock.train_s,
        # the first batch waits for the workers (the forkserver's first
        # start imports torch and the port)
        fit_images_per_s_after_first_batch=(steps - 1) * HAPI_B / (
            clock.train_s - (clock.waits[0] + clock.steps[0]) / 1e3),
        ms_per_step_median=steps_ms[steps // 2],
        loader_wait_ms_per_step=sum(clock.waits[1:]) / max(steps - 1, 1),
        loader_wait_first_ms=clock.waits[0],
        device_busy_share=busy / fit_s,
        eval=_json_logs(clock.eval_logs),
        loss_first=clock.losses[0], loss_last=clock.losses[-1],
        fit_equals_hand_loop=True, worker_batches_equal=True,
        loader_images_per_s={str(w): r for w, r in rates.items()},
        workers=HAPI_WORKERS, batch=HAPI_B, model=HAPI_MODEL)
    log(f"{label}: " + json.dumps(res))
    return res


def hapi_mnist(torch, ops):
    """(b): ``paddle.Model(LeNet())`` on MNIST with Adam (row 10 once a
    trainable parameter a step), then evaluate, predict, save / load,
    summary, and one train_batch on the card against the CPU."""
    import types
    import warnings

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.vision import transforms as T
    from paddle_tpu_torch.vision.datasets import MNIST
    from paddle_tpu_torch.vision.models import LeNet

    label = f"phase 36 (b) LeNet MNIST B={MNIST_B}"
    tfm = T.Compose([T.ToTensor(), T.Normalize(MNIST_MEAN, MNIST_STD)])
    train_ds, test_ds = (MNIST(mode=m, transform=tfm)
                         for m in ("train", "test"))

    def build(seed):
        torch.manual_seed(seed)
        net = LeNet()                                      # on the card
        model = paddle.Model(net)
        opt = optimizer.Adam(learning_rate=1e-3,
                             parameters=net.parameters())
        model.prepare(opt, nn.CrossEntropyLoss(), Accuracy(topk=(1, 2)))
        return net, model, opt

    net, model, opt = build(37)
    trainable = sum(1 for p in net.parameters()
                    if getattr(p, "trainable", True))
    per_step = []

    class Count(paddle.callbacks.Callback):
        def on_train_batch_begin(self, step, logs=None):
            ops.reset_launch_counts()

        def on_train_batch_end(self, step, logs=None):
            per_step.append(ops.launch_counts())

    clock = _fit_clock(paddle)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        model.fit(_WorkerProbe(train_ds), epochs=1, batch_size=MNIST_B,
                  verbose=0, num_workers=HAPI_WORKERS,
                  callbacks=[Count(), clock])
    _no_fallback(caught, label)
    for i, got in enumerate(per_step):
        others = {k: n for k, n in got.items() if n and k != "fused_adamw"}
        check(got["fused_adamw"] == trainable and not others,
              f"{label}: step {i} launched fused_adamw "
              f"{got['fused_adamw']} times (want {trainable}), others "
              f"{others}")
    check(all(math.isfinite(x) for x in clock.losses),
          f"{label}: a loss is not finite")
    ev = model.evaluate(test_ds, batch_size=MNIST_B)
    pred = model.predict(test_ds, batch_size=MNIST_B, stack_outputs=True)
    check(len(pred) == 1 and pred[0].shape == (len(test_ds), 10)
          and _finite(pred[0]), f"{label}: predict gave "
                                  f"{[p.shape for p in pred]}")
    # save / load: a fresh model's eval logits bit for bit
    x = next(iter(paddle.io.DataLoader(test_ds, batch_size=MNIST_B)))[0]
    net.eval()
    with torch.no_grad():
        want = net(x.to("cuda"))
    with tempfile.TemporaryDirectory() as d:
        model.save(os.path.join(d, "lenet"))
        net2, model2, _ = build(38)
        model2.load(os.path.join(d, "lenet"))
    net2.eval()
    with torch.no_grad():
        got = net2(x.to("cuda"))
    check(torch.equal(got, want), f"{label}: eval logits after save / "
                                  f"load differ")
    summ = model.summary()
    numel = sum(p.numel() for p in net.parameters())
    check(summ == {"total_params": numel, "trainable_params": numel},
          f"{label}: summary {summ}, {numel} parameters")
    # one train_batch from the trained state on the card against the CPU
    # (TF32 off): the loss and every gradient, then phase 35's Adam step
    # (row 10 against its plain version) on the CPU's gradients
    cpu_net = LeNet(device="cpu")
    cpu_net.set_state_dict({k: v.detach().cpu() for k, v in
                            net.state_dict().items()})
    xb, yb = next(iter(paddle.io.DataLoader(train_ds, batch_size=MNIST_B)))
    card_loss = model.train_batch([xb], yb, update=False)[0][0]
    cpu_net.train()
    host_loss = nn.CrossEntropyLoss()(cpu_net(xb), yb)
    host_loss.backward()
    grad_err = max(_err(torch, p.grad, q.grad) for p, q in
                   zip(net.parameters(), cpu_net.parameters()))
    shim = types.SimpleNamespace(optimizer=opt, _step_count=opt._global_step,
                                 trained=opt._parameter_list)
    adam = _adam_against_cpu(torch, shim, {
        n: q.grad.detach() for (n, _), q in zip(opt._parameter_list,
                                                cpu_net.parameters())})
    opt.clear_grad()
    loss_gap = abs(card_loss - host_loss.item()) / abs(host_loss.item())
    check(loss_gap <= OCR_CPU_TOL and grad_err <= OCR_CPU_TOL,
          f"{label}: card against CPU: loss {loss_gap:.3g}, gradients "
          f"{grad_err:.3g} (limit {OCR_CPU_TOL})")
    for k, err in adam["err_over_max"].items():
        check(err <= ADAM_CPU_TOL[k], f"{label}: Adam's step {k} {err:.3g} "
                                      f"over the limit {ADAM_CPU_TOL[k]}")
    steps = len(clock.losses)
    res = dict(steps=steps, trainable_parameters=trainable,
               launches_per_step=trainable,
               launches=sum(s["fused_adamw"] for s in per_step),
               fit_images_per_s=steps * MNIST_B / clock.train_s,
               ms_per_step_median=sorted(clock.steps)[steps // 2],
               loader_wait_ms_per_step=sum(clock.waits[1:]) / max(
                   steps - 1, 1),
               loss_first=clock.losses[0], loss_last=clock.losses[-1],
               eval=_json_logs(ev), predict_shape=list(pred[0].shape),
               save_load_bit_for_bit=True, summary=summ,
               card_vs_cpu=dict(loss_rel_gap=loss_gap,
                                grad_err_over_max=grad_err,
                                tolerance=OCR_CPU_TOL),
               adam=adam)
    log(f"{label}: " + json.dumps(res))
    return res


def _finite(a) -> bool:
    import numpy as np

    return bool(np.isfinite(a).all())


def _vops_inputs(torch):
    """(c)'s seeded inputs on the card: the FPN level, its RoIs (two
    images, sizes 8-400 px, some past the image), the deformable maps and
    offsets, the YOLO head and its ground truth, the detection boxes and
    scores of the host ops."""
    import numpy as np

    rng = np.random.RandomState(36)
    N, C, H, W = VOPS_FEAT
    ih, iw = H / VOPS_SCALE, W / VOPS_SCALE

    def boxes(n, h, w, lo=8.0, hi=400.0):
        xy = rng.rand(n, 2) * np.array([w, h]) * 0.9
        wh = lo + rng.rand(n, 2) * (hi - lo)
        return np.concatenate([xy, xy + wh], 1).astype(np.float32)

    f32 = dict(device="cuda", dtype=torch.float32)

    def t(a, **kw):
        return torch.as_tensor(a, **(kw or f32))

    dn, dc, dh, dw = VOPS_DEFORM
    S = 3                                # anchors of the YOLO head
    inp = dict(
        feat=t(rng.randn(N, C, H, W)),
        ps_feat=t(rng.randn(N, VOPS_PS_C, H, W)),
        rois=t(boxes(VOPS_ROIS, ih, iw)),
        rois_num=t([VOPS_ROIS // 2, VOPS_ROIS - VOPS_ROIS // 2],
                   device="cuda", dtype=torch.int32),
        dx=t(rng.randn(dn, dc, dh, dw)),
        dw=t(rng.randn(dc, dc, 3, 3) * 0.05),
        db=t(rng.randn(dc) * 0.1),
        doff=t(rng.randn(dn, 2 * 9, dh, dw) * 1.5),
        dmask=t(rng.rand(dn, 9, dh, dw)),
        yolo_x=t(rng.randn(YOLO_N, S * (5 + YOLO_CLASSES), YOLO_HW,
                           YOLO_HW)),
        yolo_img=t(np.tile([[416, 416]], (YOLO_N, 1)), device="cuda",
                   dtype=torch.int32),
        gt_box=t(np.concatenate([rng.rand(YOLO_N, YOLO_GT, 2) * 0.8 + 0.1,
                                 rng.rand(YOLO_N, YOLO_GT, 2) * 0.4 + 0.02],
                                -1)),
        gt_label=t(rng.randint(0, YOLO_CLASSES, (YOLO_N, YOLO_GT)),
                   device="cuda", dtype=torch.int32),
        priors=t(boxes(1000, 1.0, 1.0, 0.02, 0.3)),
        targets=t(boxes(64, 1.0, 1.0, 0.02, 0.3)),
        pvar=t(np.tile([[0.1, 0.1, 0.2, 0.2]], (1000, 1))),
        det_boxes=t(boxes(1000, 800, 1088, 16, 300)),
        det_scores=t(rng.rand(1000)),
        det_cats=t(rng.randint(0, 8, 1000), device="cuda",
                   dtype=torch.int64),
        mnms_boxes=t(np.stack([boxes(400, 1.0, 1.0, 0.02, 0.3)
                               for _ in range(2)])),
        mnms_scores=t(rng.rand(2, 8, 400)),
        rpn_scores=t(rng.rand(2, 3, H, W)),
        rpn_deltas=t(rng.randn(2, 12, H, W) * 0.2),
        rpn_img=t([[ih, iw], [ih, iw]]),
        rpn_anchors=t(boxes(H * W * 3, ih, iw, 16, 256).reshape(H, W, 3, 4)),
        rpn_var=t(np.ones((H, W, 3, 4))),
    )
    return inp


def _vops_cases(V):
    """(c)'s cases: (name, the op on its inputs, the inputs' names in
    :func:`_vops_inputs`, the positions differentiated, the planted fault:
    the op on the same inputs with one of them or a setting off)."""
    def shifted(b):
        return b + 16.0                  # one cell of the FPN level

    roi = dict(output_size=7, spatial_scale=VOPS_SCALE)
    mask = [6, 7, 8]                     # the 13 x 13 head's anchors

    def yloss(x, g, l, **kw):
        kw = dict(dict(use_label_smooth=True, ignore_thresh=0.7), **kw)
        return V.yolo_loss(x, g, l, YOLO_ANCHORS, mask, YOLO_CLASSES,
                           kw["ignore_thresh"], 32,
                           use_label_smooth=kw["use_label_smooth"])

    dpad = dict(stride=1, padding=1)
    cases = [
        ("roi_align", lambda f, b, n: V.roi_align(f, b, n, **roi),
         ["feat", "rois", "rois_num"], (0,),
         lambda f, b, n: V.roi_align(f, shifted(b), n, **roi)),
        ("roi_pool", lambda f, b, n: V.roi_pool(f, b, n, **roi),
         ["feat", "rois", "rois_num"], (0,),
         lambda f, b, n: V.roi_pool(f, shifted(b), n, **roi)),
        ("psroi_pool", lambda f, b, n: V.psroi_pool(f, b, n, **roi),
         ["ps_feat", "rois", "rois_num"], (0,),
         lambda f, b, n: V.psroi_pool(f, shifted(b), n, **roi)),
        ("deform_conv2d_v1",
         lambda x, o, w, b: V.deform_conv2d(x, o, w, b, **dpad),
         ["dx", "doff", "dw", "db"], (0, 1, 2),
         # the centre tap's offsets dropped
         lambda x, o, w, b: V.deform_conv2d(
             x, o * _tap_keep(o, 4), w, b, **dpad)),
        ("deform_conv2d_v2",
         lambda x, o, w, b, m: V.deform_conv2d(x, o, w, b, mask=m, **dpad),
         ["dx", "doff", "dw", "db", "dmask"], (0, 1, 2, 4),
         lambda x, o, w, b, m: V.deform_conv2d(
             x, o, w, b, mask=m.clamp(min=0.5), **dpad)),
        ("yolo_box", lambda x, im: V.yolo_box(
            x, im, YOLO_ANCHORS[12:], YOLO_CLASSES, 0.01, 32),
         ["yolo_x", "yolo_img"], (0,),
         lambda x, im: V.yolo_box(x, im, YOLO_ANCHORS[6:12], YOLO_CLASSES,
                                  0.01, 32)),
        # the fault: another head's anchors (the 26 x 26 one's)
        ("yolo_loss", yloss, ["yolo_x", "gt_box", "gt_label"], (0,),
         lambda x, g, l: V.yolo_loss(x, g, l, YOLO_ANCHORS, [3, 4, 5],
                                     YOLO_CLASSES, 0.7, 32)),
        ("box_coder_encode", lambda p, v, t: V.box_coder(p, v, t),
         ["priors", "pvar", "targets"], (),
         lambda p, v, t: V.box_coder(p, v.flip(-1), t)),
        ("box_coder_decode", lambda p, v, t: V.box_coder(
            p, v, _deltas(t, p), "decode_center_size"),
         ["priors", "pvar", "targets"], (),
         lambda p, v, t: V.box_coder(p, v.flip(-1), _deltas(t, p),
                                     "decode_center_size")),
        ("prior_box", lambda f: V.prior_box(
            f, torch_zeros_like_image(f), [32.0, 64.0], [64.0, 128.0],
            [2.0], flip=True, clip=True),
         ["feat"], (), lambda f: V.prior_box(
             f, torch_zeros_like_image(f), [32.0, 64.0], [64.0, 128.0],
             [2.0], flip=True, clip=True, offset=0.4)),
        ("nms", lambda b, s, c: V.nms(b, 0.5, s, c, top_k=300),
         ["det_boxes", "det_scores", "det_cats"], (),
         lambda b, s, c: V.nms(b, 0.45, s, c, top_k=300)),
        ("matrix_nms", lambda b, s: V.matrix_nms(
            b, s, 0.05, 0.05, 200, 100, return_index=True),
         ["mnms_boxes", "mnms_scores"], (),
         lambda b, s: V.matrix_nms(b, s, 0.05, 0.05, 200, 100,
                                   use_gaussian=True, return_index=True)),
        ("generate_proposals", lambda s, d, im, a, v: V.generate_proposals(
            s, d, im, a, v, 2000, 300, 0.7, 1.0, return_rois_num=True),
         ["rpn_scores", "rpn_deltas", "rpn_img", "rpn_anchors", "rpn_var"],
         (), lambda s, d, im, a, v: V.generate_proposals(
             s, d, im, a, v, 2000, 300, 0.6, 1.0, return_rois_num=True)),
        ("distribute_fpn_proposals", lambda b, n: V.distribute_fpn_proposals(
            b, 2, 5, 4, 224, rois_num=n),
         ["rois", "rois_num"], (),
         lambda b, n: V.distribute_fpn_proposals(b, 2, 5, 4, 200,
                                                 rois_num=n)),
    ]
    return cases


def _deltas(t, p):
    """Decode deltas (targets, priors, 4): each target's box, scaled to
    a delta's size, against every prior."""
    return t[:, None, :].expand(-1, p.shape[0], 4) * 0.1


def torch_zeros_like_image(f):
    """An image tensor (N, 3, H / scale, W / scale) for prior_box (only its
    shape is read)."""
    return f.new_zeros(f.shape[0], 3, int(f.shape[2] / VOPS_SCALE),
                       int(f.shape[3] / VOPS_SCALE))


def _tap_keep(o, tap):
    """A multiplier of the offsets (N, 2 · 9, Ho, Wo) that drops one tap's
    (its y and x set to 0)."""
    keep = o.new_ones(1, o.shape[1], 1, 1)
    keep[:, 2 * tap:2 * tap + 2] = 0
    return keep


def _flat_outputs(out):
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _flat_outputs(o)]
    return [] if out is None else [out]


def _vops_err(torch, card, host):
    """(worst float error over the largest |CPU| value, every exact output
    equal) of one op's outputs."""
    worst, exact = 0.0, True
    for c, h in zip(_flat_outputs(card), _flat_outputs(host)):
        if tuple(c.shape) != tuple(h.shape):
            return math.inf, False
        if h.is_floating_point() and h.numel():
            worst = max(worst, _err(torch, c, h))
        elif not torch.equal(c.cpu(), h):
            exact = False
    return worst, exact


def vision_ops_against_cpu(torch):
    """(c): every ``vision.ops`` op on the card against the port on the
    CPU at detection shapes (forward, and the gradient of the sum for the
    differentiated inputs), each limit shown to reject a planted fault,
    and each op's device ms (forward; forward + backward where
    differentiated) at the full shapes."""
    from paddle_tpu_torch.vision import ops as V

    inp = _vops_inputs(torch)
    chk = slice(0, VOPS_CHECK_ROIS)
    out = {}
    for name, fn, keys, diff, fault in _vops_cases(V):
        card_in = [inp[k] for k in keys]
        # the RoI ops on the CPU hold the first RoIs (of image 0)
        if "rois" in keys and name != "distribute_fpn_proposals":
            check_in = [v[chk] if k == "rois" else
                        (v.new_tensor([VOPS_CHECK_ROIS, 0]) if k ==
                         "rois_num" else v) for k, v in zip(keys, card_in)]
        else:
            check_in = card_in
        ms = event_ms(torch, lambda: fn(*card_in), 5)
        row = dict(ms=ms)
        if diff:
            leaves = [v.detach().clone().requires_grad_(i in diff)
                      if v.is_floating_point() else v
                      for i, v in enumerate(card_in)]

            def fwd_bwd():
                r = fn(*leaves)
                sum(o.sum() for o in _flat_outputs(r)).backward()
            row["fwd_bwd_ms"] = event_ms(torch, fwd_bwd, 3)
        results = {}
        for dev in ("cuda", "cpu"):
            args = [v.detach().to(dev).clone().requires_grad_(i in diff)
                    if v.is_floating_point() else v.to(dev)
                    for i, v in enumerate(check_in)]
            r = fn(*args)
            grads = []
            if diff:
                sum(o.sum() for o in _flat_outputs(r)).backward()
                grads = [args[i].grad for i in diff]
            results[dev] = ([o.detach() for o in _flat_outputs(r)], grads)
        host_in = [v.detach().cpu() for v in check_in]
        with torch.no_grad():
            planted = [o.detach() for o in _flat_outputs(fault(*host_in))]
        err, exact = _vops_err(torch, results["cuda"][0], results["cpu"][0])
        gerr = max((_err(torch, a, b) for a, b in
                    zip(results["cuda"][1], results["cpu"][1])), default=0.0)
        ferr, fexact = _vops_err(torch, planted, results["cpu"][0])
        row.update(err_over_max=err, grad_err_over_max=gerr, exact=exact,
                   fault_err_over_max=ferr, fault_exact=fexact,
                   limit=VOPS_TOL, shapes={k: list(v.shape) for k, v in
                                           zip(keys, card_in)})
        out[name] = row
        check(err <= VOPS_TOL and gerr <= VOPS_TOL and exact,
              f"phase 36 (c) {name}: card against the CPU {err:.3g}, "
              f"gradients {gerr:.3g}, exact outputs equal {exact} (limit "
              f"{VOPS_TOL})")
        check(ferr > VOPS_TOL or not fexact,
              f"phase 36 (c) {name}: the planted fault passes the limit "
              f"({ferr:.3g})")
    log("phase 36 (c) vision ops, card against the CPU: " + json.dumps(out))
    return out


def token_reader(torch):
    """(d): ``TokenDataLoader`` built from ``csrc/ptio.cpp`` with g++ where
    the script runs, over a seeded file of TOKEN_FILE_TOKENS int32 tokens:
    tokens a second at B x S, every batch's rows windows of the file with
    their next-token labels."""
    import numpy as np

    from paddle_tpu_torch.io import native

    t0 = time.perf_counter()
    native.get_lib()
    build_s = time.perf_counter() - t0
    stride = TOKEN_S + 1
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "tokens.bin")
        tokens = np.random.RandomState(36).randint(
            0, TOKEN_VOCAB, TOKEN_FILE_TOKENS).astype(np.int32)
        native.write_token_file(tokens, path)
        loader = native.TokenDataLoader(path, TOKEN_S, TOKEN_B,
                                        num_threads=2, seed=36)
        check(loader.native, "phase 36 (d): the token reader is not native")
        first = loader.next()
        t1 = time.perf_counter()
        batches = [loader.next() for _ in range(TOKEN_BATCHES)]
        read_s = time.perf_counter() - t1
        loader.close()
    windows = tokens[:(len(tokens) // stride) * stride].reshape(-1, stride)
    by_first = {}
    for s, tok in enumerate(windows[:, 0].tolist()):
        by_first.setdefault(tok, []).append(s)
    bad = 0
    for ids, labels in [first] + batches:
        check(ids.shape == (TOKEN_B, TOKEN_S) and ids.dtype == np.int32
              and labels.dtype == np.int64, "phase 36 (d): batch layout")
        for row, lab in zip(ids, labels):
            if not any((windows[s, :-1] == row).all()
                       and (windows[s, 1:] == lab).all()
                       for s in by_first.get(int(row[0]), ())):
                bad += 1
    check(bad == 0, f"phase 36 (d): {bad} rows are not windows of the file")
    res = dict(build_s=build_s, file_tokens=len(tokens),
               windows=len(windows), batch=[TOKEN_B, TOKEN_S],
               batches=TOKEN_BATCHES,
               tokens_per_s=TOKEN_BATCHES * TOKEN_B * TOKEN_S / read_s,
               rows_checked=TOKEN_B * (TOKEN_BATCHES + 1))
    log("phase 36 (d) token reader: " + json.dumps(res))
    return res


def hapi(torch, ops):
    """Phase 36: the data pipeline, the metrics, ``hapi.Model`` and the rest
    of ``vision`` (see the module docstring): (a) BASELINE config 1 through
    ``paddle.Model`` with two loader workers, (b) ``Model.fit`` with Adam
    (row 10), (c) ``vision.ops`` against the CPU, (d) the token reader."""
    t0 = time.perf_counter()
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    cudnn.deterministic, cudnn.benchmark = True, False
    log(f"phase 36 settings: cudnn deterministic, benchmark off; "
        f"{card_line()}")
    res, secs = {}, {}

    def part(key, fn, *a):
        t = time.perf_counter()
        res[key] = fn(*a)
        secs[key] = time.perf_counter() - t

    try:
        part("a", hapi_cifar, torch, ops)
        _free(torch)
        cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        part("b", hapi_mnist, torch, ops)
        part("c", vision_ops_against_cpu, torch)
        _free(torch)
    finally:
        (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    part("d", token_reader, torch)
    res["part_seconds"] = secs
    res["launches_per_step"] = res["b"]["launches_per_step"]
    res["phase_s"] = time.perf_counter() - t0
    log(f"phase 36: {res['phase_s']:.1f} s, {card_line()}")
    return res


# --------------------------------------------------------------- phase 37
# (d): the workers run Llama-3-8B's width at 2 layers (each worker's start
# and graph captures would otherwise dominate the phase); the slice of a
# drawn day (tools/fleet_sim.py's execute_slice, its prompts scaled to the
# card); the router tick of the SIGKILL, the scale-up and the drain
FLEET_D_LAYERS = 2
FLEET_D_SESSIONS = 12
FLEET_D_KILL_TICK = 3
# the seed of FaultPlan.fleet_chaos in (b) and of disagg_chaos in (c):
# (b) kills replica 1 at router tick 7 (ordinal 15) and flips the first
# KV payload; (c) kills the prefill replica at tick 7 (ordinal 14) and
# flips the second handoff payload
FLEET_CHAOS_SEED = 1
# the workers' device: None is the CUDA card (the spec's default)
FLEET_WORKER_DEVICE = None
FLEET_WARMUP = (list(range(1, 40)), 4)


def token_mismatches(got, want):
    """Requests whose tokens differ from the yardstick's (or are missing)."""
    return sum(1 for i, w in enumerate(want)
               if i >= len(got) or got[i] != w) + max(len(got) - len(want), 0)


def _tokens_check(got, want, label):
    """Tokens equal to the yardstick's, request for request; the same
    comparison must reject the yardstick with one token flipped."""
    bad = token_mismatches(got, want)
    check(bad == 0, f"{label}: {bad} of {len(want)} requests differ from "
                    f"the yardstick")
    flipped = [list(t) for t in want]
    flipped[-1][-1] = (flipped[-1][-1] + 1) % 128256
    check(token_mismatches(got, flipped) == 1,
          f"{label}: the token check passed a planted flipped token")
    return len(want) - bad


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else None


def _fleet_server(model, **kw):
    """A replica of phase 4's configuration over ``model`` (shared, not
    copied), its pool sized by bytes: phase 4's block count."""
    from paddle_tpu_torch.inference.serving import (GenerationServer,
                                                    kv_block_bytes)

    pool = ((MAX_BATCH * (MAX_LEN // BLOCK_SIZE) + 1)
            * kv_block_bytes(model.cfg, BLOCK_SIZE))
    srv = GenerationServer(model, cache="paged", max_batch=MAX_BATCH,
                           block_size=BLOCK_SIZE, prefill_chunk=PREFILL_CHUNK,
                           max_len=MAX_LEN, pool_bytes=pool,
                           device=model.device, **kw)
    check(srv._table_width == TABLE_WIDTH, "phase 37: block-table width")
    if model.device.type == "cuda":
        check(srv._exec.graphs, "phase 37: a replica does not graph its "
                                "passes on the card")
    return srv


class _FleetPasses:
    """Each replica's executor passes with their launches: (replica, kind,
    units, {kernel: launches}) — a pass that captures its graph counts its
    replay's launches, as every later one; the wrappers come off with
    :meth:`close`."""

    def __init__(self, ops, servers):
        self.rows = []
        self._ex = []
        for idx, srv in enumerate(servers):
            self.add(ops, idx, srv)

    def add(self, ops, idx, srv):
        ex = srv._exec
        self._ex.append(ex)
        for kind, unit in (("decode_paged", "ticks"),
                           ("chunk_prefill", None)):
            def counted(*a, _fn=getattr(ex, kind), _kind=kind, _unit=unit,
                        **k):
                before = ops.launch_counts()
                out = _fn(*a, **k)
                self.rows.append((idx, _kind, k.get(_unit, 1) if _unit
                                  else 1, {n: c - before[n] for n, c in
                                           ops.launch_counts().items()}))
                return out
            setattr(ex, kind, counted)

    def check(self, L, label):
        """Every pass of every replica launched row 11 and row 7 once a
        layer (and the final norm), and a decode tick ``stream_matmul``
        for the 7 projections of every layer and the head; returns the
        passes counted, by replica and kind."""
        want = {"decode_paged": {"paged_attention": L, "rms_norm": 2 * L + 1,
                                 "stream_matmul": 7 * L + 1},
                "chunk_prefill": {"paged_attention": L,
                                  "rms_norm": 2 * L + 1}}
        for idx, kind, units, got in self.rows:
            for name, n in want[kind].items():
                check(got[name] == n * units,
                      f"{label}: replica {idx}'s {kind} pass of {units} "
                      f"units launched {name} {got[name]} times, want "
                      f"{n * units}")
        return {f"{idx}:{kind}": sum(1 for r in self.rows
                                     if r[:2] == (idx, kind))
                for idx, kind in sorted({r[:2] for r in self.rows})}

    def close(self):
        for ex in self._ex:
            for kind in ("decode_paged", "chunk_prefill"):
                if kind in vars(ex):
                    delattr(ex, kind)


def _warm(fleet, servers):
    """Each replica's warm-up (its graphs' captures), submitted to the
    replica itself, then the fleet run to empty; the router's counters
    start after it."""
    for srv in servers:
        srv.submit(FLEET_WARMUP[0], max_new_tokens=FLEET_WARMUP[1])
    fleet.run()
    return [srv._exec.captures for srv in servers]


def _payload_log(handle):
    """Record the KV bytes of every payload admitted into ``handle``."""
    log_ = []
    orig = handle.admit_migrated

    def admit(d, **kw):
        if d["phase"] == "kv":
            log_.append(int(d["kv"]["nbytes"]))
        return orig(d, **kw)
    handle.admit_migrated = admit
    return log_


def _timed_kills(fleet):
    """Host ms of each replica kill: from the kill to the last of its
    salvaged requests admitted on a peer."""
    ms = []
    orig = fleet._kill

    def kill(rep, reason):
        t = time.perf_counter()
        orig(rep, reason)
        ms.append((time.perf_counter() - t) * 1e3)
    fleet._kill = kill
    return ms


def _decode_stats(servers, before):
    after = [s.throughput_stats() for s in servers]
    rows = [{k: a[k] - b[k] for k in a} for a, b in zip(after, before)]
    return rows


def fleet_routing(torch, ops, model, serve_res):
    """Phase 37 (a): two in-process replicas over the phase-4 model behind a
    ``FleetRouter``: phase 4's traffic, tokens against phase 4's; then the
    traffic again with replica 0 drained mid-decode."""
    from paddle_tpu_torch.inference import FleetRouter, InProcessReplica

    L = model.cfg.num_hidden_layers
    prompts, news = phase4_traffic(model.cfg)
    servers = [_fleet_server(model) for _ in range(2)]
    handles = [InProcessReplica(s) for s in servers]
    fleet = FleetRouter(handles)
    t0 = time.perf_counter()
    captures = _warm(fleet, servers)
    t_warm = time.perf_counter() - t0
    passes = _FleetPasses(ops, servers)
    before = [s.throughput_stats() for s in servers]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rids = [fleet.submit(p, max_new_tokens=m) for p, m in zip(prompts, news)]
    out = fleet.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    for name in ("paged_attention", "rms_norm", "stream_matmul"):
        check(launches[name] > 0, f"phase 37 (a): {name} never launched")
    equal = _tokens_check([out.get(r) for r in rids], serve_res["tokens"],
                          "phase 37 (a) routed")
    pass_counts = passes.check(L, "phase 37 (a)")
    rows = _decode_stats(servers, before)
    fm = fleet.fleet_metrics()
    gen = sum(news)
    dec_tok = sum(r["decode_tokens"] for r in rows)
    dec_s = sum(r["decode_s"] for r in rows)
    res = dict(
        requests=len(rids), tokens_equal=equal, wall_s=wall,
        warmup_s=t_warm, homes=[r // (1 << 32) for r in rids],
        generated_tok_s=gen / wall,
        single_generated_tok_s=gen / serve_res["wall_s"],
        fleet_decode_tok_s=dec_tok / dec_s,
        single_decode_tok_s=serve_res["decode_tok_s"],
        replicas=[dict(replica=i, routed=row["routed"], steps=row["steps"],
                       decode_trips=r["decode_trips"],
                       decode_tokens=r["decode_tokens"],
                       decode_tok_s=(r["decode_tokens"] / r["decode_s"]
                                     if r["decode_s"] else None),
                       prefill_chunks=r["prefill_chunks"])
                  for i, (row, r) in enumerate(zip(fm["replicas"], rows))],
        passes=pass_counts, launches=launches)
    # the same traffic again; replica 0 drained once requests decode
    payloads = _payload_log(handles[1])
    rids = [fleet.submit(p, max_new_tokens=m) for p, m in zip(prompts, news)]
    for _ in range(12):
        fleet.step()
    decoding = sum(1 for s in range(MAX_BATCH)
                   if servers[0]._slots[s] is not None
                   and not servers[0]._prefilling[s])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    moved = fleet.drain(0)
    drain_s = time.perf_counter() - t0
    check(moved >= 1 and payloads, "phase 37 (a): the drain moved no KV "
                                   "payload")
    out = fleet.run()
    res["drain"] = dict(
        tokens_equal=_tokens_check([out.get(r) for r in rids],
                                   serve_res["tokens"], "phase 37 (a) drain"),
        decoding_at_drain=decoding, moved=moved, kv_payloads=len(payloads),
        payload_bytes=sum(payloads), drain_ms=drain_s * 1e3,
        ms_per_request=drain_s * 1e3 / moved,
        payload_gb_s=sum(payloads) / drain_s / 1e9,
        captures_after_warmup=[s._exec.captures - c
                               for s, c in zip(servers, captures)])
    check(res["drain"]["captures_after_warmup"] == [0, 0],
          f"phase 37 (a): CUDA graphs captured after the warm-up "
          f"{res['drain']['captures_after_warmup']}")
    passes.check(L, "phase 37 (a) drain")
    passes.close()
    fleet.assert_conserved()
    return res


def fleet_chaos(torch, ops, model, serve_res):
    """Phase 37 (b): ``FaultPlan.fleet_chaos`` on a fresh pair — a
    misroute, one replica down mid-decode (salvaged from host state onto
    the survivor through the re-prefill rung) — then a fresh replica added
    and the survivor drained onto it while the plan still runs, so that
    its ``migrate_payload`` flip lands on a KV payload (the receiver's CRC
    check degrades it to re-prefill)."""
    from paddle_tpu_torch.faults import FaultInjector, FaultPlan
    from paddle_tpu_torch.inference import FleetRouter, InProcessReplica
    from paddle_tpu_torch.inference.fleet import REPLICA_DEAD

    L = model.cfg.num_hidden_layers
    prompts, news = phase4_traffic(model.cfg)
    servers = [_fleet_server(model) for _ in range(2)]
    inj = FaultInjector(FaultPlan.fleet_chaos(FLEET_CHAOS_SEED, replicas=2))
    inj.enabled = False
    fleet = FleetRouter([InProcessReplica(s) for s in servers], faults=inj)
    _warm(fleet, servers)
    kills = _timed_kills(fleet)
    passes = _FleetPasses(ops, servers)
    inj.enabled = True
    ops.reset_launch_counts()
    rids = [fleet.submit(p, max_new_tokens=m) for p, m in zip(prompts, news)]
    ticks = 0
    while REPLICA_DEAD not in fleet.replica_states():
        check(fleet.step() > 0, "phase 37 (b): the run ended before the "
                                "scripted kill")
        ticks += 1
    dead = fleet.replica_states().index(REPLICA_DEAD)
    salvaged = fleet.fleet_metrics()["migrated_requests"]
    # the autoscaler's primitives: a fresh replica joins, the survivor
    # drains onto it (its KV payloads pass the migrate_payload site)
    fresh = _fleet_server(model)              # fresh: captures in the run
    idx = fleet.add_replica(fresh)
    passes.add(ops, idx, fresh)
    survivor = 1 - dead
    moved = fleet.drain(survivor)
    out = fleet.run()
    fm = fleet.fleet_metrics()
    equal = _tokens_check([out.get(r) for r in rids], serve_res["tokens"],
                          "phase 37 (b) chaos")
    reprefills = fresh.telemetry.registry.counter(
        "serving_swap_reprefills", "").total()
    check(fm["deaths"] == 1, f"phase 37 (b): fleet_deaths {fm['deaths']}")
    check(fm["quarantined"] == 0, "phase 37 (b): requests quarantined")
    check(fm["misroutes"] >= 1, "phase 37 (b): no misroute fired")
    check(fm["migrate_corruptions"] == 1 and reprefills >= 1,
          f"phase 37 (b): the payload flip was not counted "
          f"(fleet {fm['migrate_corruptions']}, receiver {reprefills})")
    launches = ops.launch_counts()
    passes.check(L, "phase 37 (b)")
    passes.close()
    fleet.assert_conserved()
    return dict(tokens_equal=equal, token_mismatches=len(rids) - equal,
                fleet_deaths=fm["deaths"], quarantined=fm["quarantined"],
                misroutes=fm["misroutes"], kill_tick=ticks,
                killed_replica=dead, salvaged_requests=salvaged,
                kill_to_readmitted_ms=kills[0], drained_onto_fresh=moved,
                migrate_corruptions=fm["migrate_corruptions"],
                receiver_reprefills=int(reprefills), fired=inj.fired,
                launches=launches)


def fleet_disagg(torch, ops, model, serve_res):
    """Phase 37 (c): one ``role="prefill"`` and one ``role="decode"``
    replica; phase 4's traffic handed off request by request; then the
    traffic again under ``FaultPlan.disagg_chaos`` (the prefill replica
    killed mid-chunk, its prompts salvaged onto the decode class; a
    handoff payload flipped)."""
    from paddle_tpu_torch.faults import FaultInjector, FaultPlan
    from paddle_tpu_torch.inference import FleetRouter, InProcessReplica

    L = model.cfg.num_hidden_layers
    prompts, news = phase4_traffic(model.cfg)
    servers = [_fleet_server(model, role="prefill"),
               _fleet_server(model, role="decode")]
    handles = [InProcessReplica(s) for s in servers]
    inj = FaultInjector(FaultPlan.disagg_chaos(FLEET_CHAOS_SEED))
    inj.enabled = False
    fleet = FleetRouter(handles, faults=inj)
    # the decode replica prefills too (salvaged prompts): both warm both
    for srv in servers:
        srv.submit(FLEET_WARMUP[0], max_new_tokens=FLEET_WARMUP[1])
    fleet.run()
    passes = _FleetPasses(ops, servers)
    payloads = _payload_log(handles[1])
    lat0 = len(fleet._migration_lat)
    h0 = fleet.fleet_metrics()["handoff_requests"]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rids = [fleet.submit(p, max_new_tokens=m) for p, m in zip(prompts, news)]
    out = fleet.run()
    wall = time.perf_counter() - t0
    fm = fleet.fleet_metrics()
    equal = _tokens_check([out.get(r) for r in rids], serve_res["tokens"],
                          "phase 37 (c) disaggregated")
    handoffs = fm["handoff_requests"] - h0
    check(handoffs == len(rids), f"phase 37 (c): {handoffs} handoffs for "
                                 f"{len(rids)} requests")
    check(all(fleet._home[r] == 1 for r in rids),
          "phase 37 (c): a request finished off the decode class")
    lat = [x * 1e3 for x in fleet._migration_lat[lat0:]]
    launches = ops.launch_counts()
    pass_counts = passes.check(L, "phase 37 (c)")
    check(not any(r[:2] == (0, "decode_paged") for r in passes.rows),
          "phase 37 (c): a decode pass ran on the prefill replica")
    check(servers[0].throughput_stats()["decode_trips"] == 0,
          "phase 37 (c): the prefill replica ran a decode trip")
    res = dict(tokens_equal=equal, handoffs=handoffs, wall_s=wall,
               handoff_ms_p50=_pct(lat, 0.5), handoff_ms_p99=_pct(lat, 0.99),
               handoff_samples=len(lat), kv_payloads=len(payloads),
               bytes_per_handoff=sum(payloads) / max(len(payloads), 1),
               generated_tok_s=sum(news) / wall, passes=pass_counts,
               launches=launches)
    # the same traffic under the disaggregated chaos plan
    kills = _timed_kills(fleet)
    inj.enabled = True
    rids = [fleet.submit(p, max_new_tokens=m) for p, m in zip(prompts, news)]
    out = fleet.run()
    fm = fleet.fleet_metrics()
    res["chaos"] = dict(
        tokens_equal=_tokens_check([out.get(r) for r in rids],
                                   serve_res["tokens"],
                                   "phase 37 (c) disaggregated chaos"),
        states=fleet.replica_states(), deaths=fm["deaths"],
        migrate_corruptions=fm["migrate_corruptions"],
        quarantined=fm["quarantined"], fired=inj.fired,
        kill_to_readmitted_ms=kills[0] if kills else None)
    check(fleet.replica_states() == ["dead", "live"] and fm["deaths"] == 1,
          f"phase 37 (c): the prefill replica was not killed "
          f"({fleet.replica_states()})")
    check(fm["quarantined"] == 0, "phase 37 (c): requests quarantined")
    passes.check(L, "phase 37 (c) chaos")
    passes.close()
    fleet.assert_conserved()
    return res


def _worker_spec(cfg, device):
    from paddle_tpu_torch.inference.serving import kv_block_bytes

    return {"model": {"config": dataclasses.asdict(cfg), "seed": 0},
            "server": dict(cache="paged", max_batch=MAX_BATCH,
                           block_size=BLOCK_SIZE,
                           prefill_chunk=PREFILL_CHUNK, max_len=MAX_LEN,
                           pool_bytes=(MAX_BATCH * (MAX_LEN // BLOCK_SIZE)
                                       + 1) * kv_block_bytes(cfg,
                                                             BLOCK_SIZE)),
            "device": device}


def fingerprints_equal(worker, parent):
    return worker == parent


def fleet_process(torch, ops, cfg):
    """Phase 37 (d): ``tools/fleet_sim.py``'s execute_slice on worker
    processes: a slice of a drawn day through two ``SubprocessReplica``
    workers (Llama-3-8B's width at 2 layers), a ``FleetAutoscaler``
    scripted through one scale-up and one drain, one SIGKILL mid-decode;
    the yardstick the same slice on one in-process server of that
    configuration."""
    import concurrent.futures

    from paddle_tpu_torch.fleetsim import (DayTrafficSpec, VirtualClock,
                                           draw_day, materialize_session,
                                           replay_slice)
    from paddle_tpu_torch.inference import (ElasticAutoscaler,
                                            FleetAutoscaler, FleetRouter,
                                            SubprocessReplica)
    from paddle_tpu_torch.inference.autoscale import AutoscalePolicy
    from paddle_tpu_torch.inference.replica_worker import weights_fingerprint
    from paddle_tpu_torch.inference.serving import GenerationServer
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    dcfg = dataclasses.replace(cfg, num_hidden_layers=FLEET_D_LAYERS)
    spec = _worker_spec(dcfg, FLEET_WORKER_DEVICE)
    n = FLEET_D_SESSIONS
    day = DayTrafficSpec(sessions=64, seed=0, shared_prefix_tokens=32,
                         prompt_ladder=(64, 128, 256), longtail_frac=0.0,
                         max_new_ladder=(8, 16, 24))
    trace = draw_day(day)

    # the yardstick: the slice on one in-process server, same weights
    twin = LlamaForCausalLM(dcfg, device=FLEET_WORKER_DEVICE, seed=0)
    srv = GenerationServer(twin, device=twin.device, **spec["server"])
    reqs = [materialize_session(trace, i, max_len=MAX_LEN) for i in range(n)]
    trids = [srv.submit(list(r.prompt), max_new_tokens=r.max_new,
                        tenant=r.tenant) for r in reqs]
    tout = srv.run()
    want = [tout[r] for r in trids]
    parent_fp = weights_fingerprint(twin)
    del srv, twin
    gc.collect()
    torch.cuda.empty_cache()

    # three fresh workers started together: two for the fleet, one for
    # the autoscaler's scale-up
    starts = {}

    def start(i):
        t = time.perf_counter()
        h = SubprocessReplica(spec)
        starts[i] = time.perf_counter() - t
        return h

    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        handles = list(pool.map(start, range(3)))
    try:
        for h in handles:
            check(fingerprints_equal(h.weights_fingerprint, parent_fp),
                  f"phase 37 (d): worker {h.pid}'s weights fingerprint "
                  f"differs from the parent's")
            check(h.device.startswith("cuda"),
                  f"phase 37 (d): a worker came up on {h.device}")
        bad_fp = format(int(parent_fp, 16) + 1, "064x")
        check(not fingerprints_equal(handles[0].weights_fingerprint,
                                     bad_fp),
              "phase 37 (d): the fingerprint check passed a planted fault")
        # RPC round trip: ping
        rtt = []
        for _ in range(200):
            t = time.perf_counter()
            handles[0].ping()
            rtt.append((time.perf_counter() - t) * 1e6)
        clock = VirtualClock()
        fleet = FleetRouter(handles[:2], clock=clock)
        kills = _timed_kills(fleet)
        # one replica a scale-up: the spare worker started beside the two
        engine = ElasticAutoscaler(400.0, policy=AutoscalePolicy(
            max_replicas=4, max_step_up=1, up_cooldown_s=0.0,
            down_cooldown_s=0.0))
        spare = [handles[2]]
        scaler = FleetAutoscaler(fleet, engine, spawn=spare.pop)
        killed = []

        def on_tick(tick, now, submitted):
            if tick == FLEET_D_KILL_TICK and not killed:
                killed.append(sum(1 for r, home in fleet._home.items()
                                  if home == 0 and r not in fleet._results))
                handles[0].kill_process()       # a real SIGKILL mid-decode
            elif tick == FLEET_D_KILL_TICK + 2:
                scaler.control(now, demand_tok_s=1e6)
            elif tick == FLEET_D_KILL_TICK + 6:
                scaler.control(now, demand_tok_s=1.0)

        for h in handles:
            h.launch_counts(reset=True)
        stats0 = [h.throughput_stats() for h in handles]
        t0 = time.perf_counter()
        out = replay_slice(trace, fleet, sessions=n, clock=clock,
                           compress=20000.0, tick_s=1.0, max_len=MAX_LEN,
                           on_tick=on_tick)
        wall = time.perf_counter() - t0
        got = [out["results"].get(r) for r in out["rids"]]
        equal = _tokens_check(got, want, "phase 37 (d) worker processes")
        fm = fleet.fleet_metrics()
        ups = sum(1 for d in engine.events if d.action == "up")
        downs = sum(1 for d in engine.events if d.action == "down")
        check(fm["deaths"] >= 1 and kills, "phase 37 (d): the SIGKILL was "
                                           "not detected")
        check(ups == 1 and downs == 1, f"phase 37 (d): {ups} scale-ups and "
                                       f"{downs} drains")
        check(fm["quarantined"] == 0, "phase 37 (d): requests quarantined")
        # each live worker's launches against its passes (row 11 and row 7
        # once a layer a pass, stream_matmul 7 a layer and the head a tick;
        # the added replica may be drained before it serves)
        wl, L, worker_passes = {}, FLEET_D_LAYERS, []
        for h, st0 in zip(handles[1:], stats0[1:]):
            got = h.launch_counts()
            st = {k: v - st0[k] for k, v in h.throughput_stats().items()}
            passes = st["decode_ticks"] + st["prefill_chunks"]
            worker_passes.append(passes)
            want = {"paged_attention": L * passes,
                    "rms_norm": (2 * L + 1) * passes,
                    "stream_matmul": (7 * L + 1) * st["decode_ticks"]}
            for name, k in want.items():
                check(got[name] == k,
                      f"phase 37 (d): worker {h.pid} launched {name} "
                      f"{got[name]} times in {passes} passes, want {k}")
                wl[name] = wl.get(name, 0) + got[name]
        for name in ("paged_attention", "rms_norm", "stream_matmul"):
            check(wl[name] > 0, f"phase 37 (d): the workers never "
                                f"launched {name}")
        res = dict(sessions=n, tokens_equal=equal, wall_s=wall,
                   worker_start_s=[starts[i] for i in range(3)],
                   rpc_round_trip_us_p50=_pct(rtt, 0.5),
                   rpc_round_trip_us_p99=_pct(rtt, 0.99),
                   killed_with_requests=killed[0] if killed else None,
                   salvage_ms=kills[0], deaths=fm["deaths"],
                   migrated_requests=fm["migrated_requests"],
                   scale_ups=ups, scale_downs=downs,
                   states=fleet.replica_states(), ticks=out["ticks"],
                   weights_fingerprint=parent_fp[:16],
                   worker_passes=worker_passes, worker_launches=wl)
    finally:
        for h in handles:
            h.close()
    return res


def fleet(torch, ops, model, serve_res):
    """Phase 37: the serving fleet on the card (see the module
    docstring)."""
    res = {}
    t = time.perf_counter()
    for name, fn in (("a", fleet_routing), ("b", fleet_chaos),
                     ("c", fleet_disagg)):
        res[name] = fn(torch, ops, model, serve_res)
        gc.collect()
        torch.cuda.empty_cache()
        res[name]["seconds"] = time.perf_counter() - t
        log(f"phase 37 ({name}): " + json.dumps(res[name]))
        t = time.perf_counter()
    res["d"] = fleet_process(torch, ops, model.cfg)
    res["d"]["seconds"] = time.perf_counter() - t
    log("phase 37 (d): " + json.dumps(res["d"]))
    launches = {}
    for key in ("a", "b", "c"):
        for k, v in res[key].pop("launches").items():
            launches[k] = launches.get(k, 0) + v
    res["launches"] = launches
    return res



# phase 38: the autotuner. (b)'s workload (the JAX tool's defaults: 16
# requests of 32 new tokens on the short prompt ladder, seed 0) and trial
# budget; (d) serves phase 4's first MK_KNOB_REQUESTS requests
TUNE_REQUESTS, TUNE_NEW, TUNE_BUDGET = 16, 32, 6
MK_KNOB_REQUESTS = 6
# (b)'s probe of the token gate: the reference config with one knob
# changed — the prefill's geometry (block size, chunk), whose products'
# rounding had never been compared
GATE_PROBE = ({"block_size": 8}, {"block_size": 32}, {"prefill_chunk": 32},
              {"prefill_chunk": 128})
# the kernels' times in PERF.md section 6 at the shapes (a) sweeps (the
# card's earlier runs, H100 80GB HBM3 at 700 W), printed beside the
# default geometry's time
PERF6_MS = {"rms_norm 8x4096": 0.00214, "rms_norm 4096x4096": 0.0265,
            "layer_norm 4096x768": 0.00701,
            "paged_attention decode_all_long": 0.03777,
            "paged_attention verify_5": 0.01552,
            "paged_attention_int8 verify_5": 0.01653,
            "decode_tick W=1 (full depth)": 8.749}


def _bits(torch, t):
    """A tensor's bits as host numpy: the sweep's bitwise gate."""
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.view(torch.int16)
    return t.detach().cpu().numpy()


def _sweep_cell(torch, label, op, run, candidates=None, cache=None,
                exact=True, iters=20, flush=None, **kw):
    """``sweep_kernel_geometry`` over one cell: ``run(geometry)`` launches
    the kernel under a candidate and returns its output; each candidate's
    device ms (a CUDA graph of ``iters`` calls, each after a rewrite of
    ``flush`` when given: the kernel's own phase's timing), its bits
    against the default's, the winner and its speed-up are logged.
    ``exact``: every candidate is a schedule change only, so each must give
    the default's bits (a rejection fails the phase). Returns (result dict,
    winner's output)."""
    from paddle_tpu_torch.autotune import sweep_kernel_geometry

    outs = {}

    def measure(geom):
        key = json.dumps(geom.asdict(), sort_keys=True)
        out = run(geom)
        torch.cuda.synchronize()
        outs[key] = out
        ms = time_ms(lambda: run(geom), iters, flush)
        return _bits(torch, out), ms / 1e3

    lines = []
    res = sweep_kernel_geometry(measure, op, candidates=candidates,
                                cache=cache, log=lines.append, **kw)
    for ln in lines:
        log(f"phase 38 (a) {label}: {ln}")
    trials = [dict(geometry=t.geometry, ms=t.seconds * 1e3, exact=t.exact,
                   accepted=t.accepted) for t in res.trials]
    if exact:
        check(all(t.exact for t in res.trials),
              f"phase 38 (a) {label}: a schedule's output differs from the "
              f"default's: " + json.dumps([t for t in trials
                                           if not t["exact"]]))
    out = dict(cell=label, op=op, trials=trials, winner=res.winner,
               winner_index=res.winner_index, speedup=res.speedup,
               default_ms=trials[0]["ms"],
               rejected=[t["geometry"] for t in trials if not t["exact"]])
    return out, outs[json.dumps(res.winner, sort_keys=True)]


def autotune_sweeps(torch, ops, model, cache):
    """Phase 38 (a): ``sweep_kernel_geometry`` on the card for each cell —
    paged attention (fp, int8) at decode (B = 8, W = 1, every row at 2047
    keys) and at the verify window (W = 5), RMSNorm at 8 x 4096 and 4096 x
    4096 and LayerNorm at 4096 x 768 (bf16), fused LoRA at rank 8 at
    decode, the fused CE forward at phase 7's shape, flash attention's one
    Hopper candidate, and the megakernel's prefetch depth as a full-depth
    tick at W = 1. Each winner against its plain twin within its row's
    tolerance; the serving cells' winners go into ``cache``."""
    from paddle_tpu_torch.autotune import kernel_geometry as kg
    from paddle_tpu_torch.nn import lora as tl
    from paddle_tpu_torch.ops import decode_megakernel as mk
    from paddle_tpu_torch.ops import fused_ce, fused_norm
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops.decode_megakernel_cuda import decode_tick_cuda

    pac = importlib.import_module(PAGED_WRAPPERS)
    cfg = model.cfg
    kind = kg.local_device_kind()
    H, KV, D, hid = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim, cfg.hidden_size)
    g = torch.Generator(device="cuda").manual_seed(38)
    # each cell timed as its row's phase times it: paged attention and
    # fused LoRA 50 calls behind a rewrite of this (inputs cold in device
    # memory, phases 3 and 10), the norms 200 (phases 2 and 21)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    cells = []
    # paged attention: fp and int8 pools, decode and the verify window
    for quant in (False, True):
        wrapper = pac.paged_attention_int8_cuda if quant else \
            pac.paged_attention_cuda
        plain_fn = pa.paged_verify_attention_q if quant else \
            pa.paged_verify_attention
        for form, B, W, pos in (("decode_all_long", MAX_BATCH, 1,
                                 [MAX_LEN - 1] * MAX_BATCH),
                                ("verify_5", MAX_BATCH, MK_VERIFY_W,
                                 [1000, 511, 509, 255, 37, 700, 13, 128])):
            q, kp, vp, tables, posv = _paged_case(torch, g, B, W, H, KV, D,
                                                  BLOCK_SIZE, pos,
                                                  TABLE_WIDTH)
            if quant:
                kq, ks = pa.quantize_block_kv(kp)
                vq, vs = pa.quantize_block_kv(vp)
                args = (q, kq, ks, vq, vs, tables, posv)
                rms_v = pa.dequantize_block_kv(vq[1:], vs[1:]).square() \
                    .mean().sqrt().item()
            else:
                args = (q, kp, vp, tables, posv)
                rms_v = vp[1:].float().square().mean().sqrt().item()
            label = f"paged_attention{'_int8' if quant else ''} {form}"
            cell, win = _sweep_cell(
                torch, label, "paged_attention",
                lambda geom: wrapper(*args, geometry=geom), iters=50,
                flush=flush,
                cache=cache if form == "decode_all_long" else None,
                dtype="int8" if quant else "bfloat16", key=D,
                quantized=quant, shape=dict(head_dim=D, block_size=BLOCK_SIZE,
                                            window=W, rep=H // KV,
                                            blocks=TABLE_WIDTH))
            ops.set_kernel_mode("reference")
            ref = plain_fn(*args)
            ops.set_kernel_mode("auto")
            cell["winner_err_over_tol"] = _row_ratio(win, ref,
                                                     rms_v).max().item()
            check(cell["winner_err_over_tol"] <= 1.0,
                  f"phase 38 (a) {label}: the winner is off its plain twin "
                  f"by {cell['winner_err_over_tol']:.3g} x the tolerance")
            cell["config"] = pac.kernel_config(
                max(c["geometry"]["kv_block_depth"] for c in cell["trials"]))
            cell["perf6_ms"] = PERF6_MS.get(label)
            cells.append(cell)
            del args, q, kp, vp
    # the norms: RMSNorm (row 7) at decode and at 4096 rows, LayerNorm (row
    # 8) at ERNIE's shape
    for name, rows, width in (("rms_norm", MAX_BATCH, hid),
                              ("rms_norm", 4096, hid),
                              ("layer_norm", 4096, 768)):
        x = torch.randn(rows, width, generator=g, device="cuda").to(
            torch.bfloat16)
        w = (1 + 0.1 * torch.randn(width, generator=g, device="cuda")).to(
            torch.bfloat16)
        b = (0.1 * torch.randn(width, generator=g, device="cuda")).to(
            torch.bfloat16)
        if name == "rms_norm":
            def run(geom, x=x, w=w):
                return fused_norm.rms_norm_cuda(x, w, cfg.rms_norm_eps, geom)
            ref = fused_norm._rms_ref(x, w, cfg.rms_norm_eps)
        else:
            def run(geom, x=x, w=w, b=b):
                return fused_norm.layer_norm_cuda(x, w, b, 1e-12, geom)
            ref = fused_norm._ln_ref(x, w, b, 1e-12)
        label = f"{name} {rows}x{width}"
        cell, win = _sweep_cell(
            torch, label, "fused_norm", run, iters=200,
            cache=cache if rows != 4096 or width != hid else None,
            dtype="bfloat16", key=width,
            shape=dict(rows_total=rows, width=width))
        if name == "rms_norm":
            tol = 2.0 ** -7 * ref.float().abs() + 1e-6
            cell["winner_err_over_tol"] = ((win.float() - ref.float()).abs()
                                           / tol).max().item()
        else:
            cell["winner_err_over_tol"] = _ln_ratio(win, ref, x, w,
                                                    "bf16").max().item()
        check(cell["winner_err_over_tol"] <= 1.0,
              f"phase 38 (a) {label}: the winner is off its plain twin")
        cell["perf6_ms"] = PERF6_MS.get(label)
        cells.append(cell)
    # fused LoRA at rank 8, decode (q's shape): rank padding on the host
    R, K, N = LORA_MAX_RANK, hid, hid
    x = torch.randn(MAX_BATCH, 1, K, generator=g, device="cuda").to(
        torch.bfloat16)
    w = (0.02 * torch.randn(K, N, generator=g, device="cuda")).to(
        torch.bfloat16)
    A = 0.02 * torch.randn(4, 2, K, R, generator=g, device="cuda")
    Bf = 0.02 * torch.randn(4, 2, R, N, generator=g, device="cuda")
    s = torch.tensor([0.0, 2.0, 1.0, 0.5], device="cuda")
    ai = torch.tensor([1, 2, 3, 0, 1, 0, 3, 2], dtype=torch.int32,
                      device="cuda")
    pooled = tl.PooledFactors(A, Bf, s, 1, ai)
    cell, win = _sweep_cell(
        torch, "fused_lora rank 8 decode", "fused_lora",
        lambda geom: tl.lora_matmul(x, w, pooled, geometry=geom), iters=50,
        flush=flush, cache=cache, exact=False, dtype="bfloat16", key=R,
        shape=dict(seq=1, in_dim=K, out_dim=N, rank=R))
    ref = tl._lora_plain(x, w, *pooled.gather())
    Ag, Bg, sg = pooled.gather()
    mag = (x.float().abs() @ w.float().abs()
           + torch.bmm(torch.bmm(x.float(), Ag).abs(), Bg.abs())
           * sg[:, None, None])
    cell["winner_err_over_tol"] = _el_ratio(win, ref, mag, K).max().item()
    check(cell["winner_err_over_tol"] <= 1.0,
          "phase 38 (a) fused_lora: the winner is off its plain twin")
    cells.append(cell)
    # the fused CE forward at phase 7's shape: rows sub-tiles of the
    # logits product (the library's product picks its kernel by M: the
    # gate decides, and what it rejects is reported)
    T = TRAIN_B * TRAIN_S
    h = (0.5 * torch.randn(T, hid, generator=g, device="cuda")).to(
        torch.bfloat16)
    wv = (0.02 * torch.randn(hid, cfg.vocab_size, generator=g,
                             device="cuda")).to(torch.bfloat16)
    labels = torch.randint(0, cfg.vocab_size, (T,), generator=g,
                           device="cuda")
    chunk = min(cfg.ce_chunk_size, T)
    with torch.no_grad():
        cell, win = _sweep_cell(
            torch, f"fused_ce {T}x{hid}x{cfg.vocab_size}", "fused_ce",
            lambda geom: fused_ce.fused_linear_cross_entropy(
                h, wv, labels, chunk_size=chunk, geometry=geom), iters=2,
            cache=cache, exact=False, dtype="bfloat16", key=hid,
            shape=dict(rows_total=chunk, hidden=hid, vocab=cfg.vocab_size))
    cells.append(cell)
    del h, wv
    # flash attention: the Hopper model keeps its one (default) schedule
    # (block_q / block_kv wait for ROADMAP A9c)
    from paddle_tpu_torch.ops.flash_attention_cuda import flash_fwd_cuda

    qf = torch.randn(1, H, 2048, D, generator=g, device="cuda").to(
        torch.bfloat16)
    kf = torch.randn(1, KV, 2048, D, generator=g, device="cuda").to(
        torch.bfloat16)
    cell, _ = _sweep_cell(
        torch, "flash_attention 2048", "flash_attention",
        lambda geom: flash_fwd_cuda(qf, kf, kf, True, D ** -0.5)[0],
        cache=cache, dtype="bfloat16", key=D,
        shape=dict(head_dim=D, seq_q=2048, seq_k=2048))
    check(len(cell["trials"]) == 1, "flash attention: a non-default "
                                    "schedule among the Hopper candidates")
    cells.append(cell)
    # the megakernel's prefetch depth: a full-depth tick at W = 1
    L = cfg.num_hidden_layers
    weights = mk.stack_layer_weights(model)
    xt, pools, tables, posv, cosr, sinr = _tick_inputs(torch, model, g, L, 1)
    cands, refused = [], {}
    for depth in (2, 1, 4):
        geom = mk.MegakernelGeometry(prefetch_depth=depth)
        errs = geom.hopper_errors(intermediate=cfg.intermediate_size,
                                  rows=MAX_BATCH)
        if errs:
            refused[depth] = errs
        else:
            cands.append(geom)
    with torch.no_grad():
        cell, win = _sweep_cell(
            torch, "decode_tick W=1 (full depth)", "megakernel",
            lambda geom: decode_tick_cuda(
                xt, pools, tables, posv, weights, cosr, sinr,
                eps=cfg.rms_norm_eps, stages=geom.ring_stages(),
                ffn_steps=geom.ffn_steps()), iters=5,
            candidates=cands, dtype="bfloat16", key=hid)
    cell["refused"] = {str(k): v for k, v in refused.items()}
    cell["perf6_ms"] = PERF6_MS.get("decode_tick W=1 (full depth)")
    cells.append(cell)
    del pools, weights
    gc.collect()
    torch.cuda.empty_cache()
    return cells


def _traffic_tokens(torch, srv, spec, warm: int = 2):
    """Serve a workload as a TrialRunner does (warm-up requests from the
    disjoint stream, then the measured traffic): (tokens fingerprint,
    graphs captured after the warm-up, generated tokens, outputs in
    order)."""
    from paddle_tpu_torch.autotune import (draw_traffic, submit_traffic,
                                           tokens_fingerprint,
                                           warmup_traffic)

    submit_traffic(srv, warmup_traffic(spec, warm))
    srv.run()
    before = srv._exec.captures
    handed = submit_traffic(srv, draw_traffic(spec).requests)
    results = srv.run()
    outs = [list(results.get(rid, [])) for rid in handed]
    new = sum(len(o) - len(r.prompt) for o, r in zip(outs, handed.values()))
    return (tokens_fingerprint(outs), srv._exec.captures - before, new,
            outs)


def autotune_search(torch, ops, model, cache, tmpdir):
    """Phase 38 (b) and (c): the seeded search over the card's servers
    (the default-config reference trial first), its profile written with
    (a)'s cache, and ``GenerationServer(profile=)`` on (b)'s workload."""
    from paddle_tpu_torch.autotune import (SHORT_PROMPT_LADDER, TrialRunner,
                                           TunedProfile, WorkloadSpec,
                                           autotune, engine_space,
                                           install_geometry_cache,
                                           local_device_kind)
    from paddle_tpu_torch.inference.serving import GenerationServer

    wl = WorkloadSpec(requests=TUNE_REQUESTS, max_new=TUNE_NEW,
                      prompt_ladder=SHORT_PROMPT_LADDER, seed=0)
    runner = TrialRunner(model, wl, max_batch=MAX_BATCH)
    # the space the card can serve: cp bounded by the cards, the kernel
    # tier's megakernel geometry by the Hopper model at this model's width
    space = engine_space(max_len=runner.max_len,
                         devices=torch.cuda.device_count(),
                         model_cfg=model.cfg, max_batch=MAX_BATCH)
    install_geometry_cache(None)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    lines = []
    prof, trials = autotune(runner, budget=TUNE_BUDGET, seed=0, space=space,
                            geometry_cache=cache, log=lines.append)
    search_s = time.perf_counter() - t0
    for ln in lines:
        log(f"phase 38 (b): {ln}")
    ref = trials[0]
    check(ref.index == 0 and ref.rung == "full" and
          ref.config == space.default(), "phase 38 (b): the reference trial "
                                         "is not the default config first")
    by_knob = {}
    rows = []
    for t in trials:
        rows.append(dict(index=t.index, rung=t.rung, fingerprint=t.fingerprint,
                         tok_s=t.features.tok_s, accepted=t.accepted,
                         reject_reason=t.reject_reason,
                         predicted_tok_s=t.predicted_tok_s,
                         recompiles=t.features.recompiles,
                         knobs={k: v for k, v in t.config.items()
                                if v != ref.config[k]}))
        if not t.accepted:
            for k in rows[-1]["knobs"] or ("(none: the default config)",):
                kind = (t.reject_reason or "").split(":")[0]
                by_knob.setdefault(k, {}).setdefault(kind, 0)
                by_knob[k][kind] += 1
    win = trials[prof.search["winner_trial"]]
    # the token gate knob by knob: the reference config with one knob
    # changed, on the search's short rung against the reference config on
    # the same rung
    short = wl.truncated(max(2, wl.requests // 4))
    ref_short = runner.run(ref.config, workload=short)[1]
    probe = {}
    for knobs in GATE_PROBE:
        cfg = space.validate(dict(ref.config, **knobs))
        fv, fp, findings = runner.run(cfg, workload=short)
        probe[",".join(f"{k}={v}" for k, v in knobs.items())] = dict(
            tokens_equal=fp == ref_short, tok_s=fv.tok_s,
            findings=[f["kind"] for f in findings])
    path = os.path.join(tmpdir, "profile.json")
    prof.save(path)
    res_b = dict(trials=rows, rejections_by_knob=by_knob,
                 gate_by_single_knob=probe,
                 winner_trial=win.index, winner_config=win.fingerprint,
                 winner_tok_s=win.features.tok_s,
                 reference_tok_s=ref.features.tok_s,
                 winner_over_reference=win.features.tok_s
                 / max(ref.features.tok_s, 1e-9),
                 search_s=search_s,
                 peak_memory_over_model_gb=(torch.cuda.max_memory_allocated()
                                            - base_mem) / 2 ** 30,
                 profile_geometry_fingerprint=cache.fingerprint(),
                 device_kind=local_device_kind(),
                 memory_after_search_gb=(torch.cuda.memory_allocated()
                                         - base_mem) / 2 ** 30)
    check(res_b["memory_after_search_gb"] < 1.0,
          "phase 38 (b): the trials' servers were not freed")
    log("phase 38 (b) search: " + json.dumps(res_b))

    # (c): the profile, applied by GenerationServer(profile=)
    srv = GenerationServer(model, max_batch=MAX_BATCH,
                           max_len=runner.max_len, profile=path,
                           device=model.device)
    fp, captured, new, _ = _traffic_tokens(torch, srv, wl)
    srv.telemetry_snapshot()
    gauge = srv.telemetry.registry.get("serving_kernel_geometry")
    sources = {op: src for op, (_, src) in srv.kernel_geometry.items()}
    for op, src in sources.items():
        check(gauge is not None and gauge.value(op=op, source=src) == 1.0,
              f"phase 38 (c): no serving_kernel_geometry gauge for {op}")
        check(src == "profile", f"phase 38 (c): {op} resolved {src!r}, "
                                f"not the profile's cache")
    snap = srv.snapshot()
    install_geometry_cache(None)
    plain_prof = TunedProfile.from_dict(dict(TunedProfile.load(path)
                                             .to_dict(), kernel_geometry=None))
    other = GenerationServer(model, max_batch=MAX_BATCH,
                             max_len=runner.max_len, profile=plain_prof,
                             device=model.device)
    try:
        other.restore(snap)
        refused = None
    except ValueError as e:
        refused = str(e)
    check(refused is not None and "kernel_geometry" in refused,
          f"phase 38 (c): a snapshot restored into a server of another "
          f"geometry ({refused})")
    other.close()
    srv.close()
    install_geometry_cache(None)
    res_c = dict(tokens_fingerprint=fp, reference_fingerprint=ref.tokens_fp,
                 winner_fingerprint=win.tokens_fp,
                 captures_after_warmup=captured, new_tokens=new,
                 sources=sources, restore_refused=refused,
                 geometry={op: g.asdict()
                           for op, (g, _) in srv.kernel_geometry.items()})
    log("phase 38 (c) profile=: " + json.dumps(res_c))
    check(fp == ref.tokens_fp, "phase 38 (c): the profile server's tokens "
                               "differ from the reference trial's")
    check(captured == 0, f"phase 38 (c): {captured} graphs captured after "
                         f"the warm-up")
    return res_b, res_c


def autotune_megakernel(torch, ops, model, phase4_tokens, count):
    """Phase 38 (d): phase 4's first requests through kernels="megakernel"
    at the default geometry, at prefetch depth 1 (the default's tokens, bit
    for bit) and at ffn_tile 1024 (a tick within row 13's tolerance of its
    plain twin sliced alike; the tokens equal, or the first difference and
    its logit gap). ``count()`` takes the launch counters after each
    serving cell."""
    from paddle_tpu_torch.ops import decode_megakernel as mk
    from paddle_tpu_torch.ops.decode_megakernel_cuda import decode_tick_cuda

    prompts, news = phase4_traffic(model.cfg)
    traffic = (prompts[:MK_KNOB_REQUESTS], news[:MK_KNOB_REQUESTS])
    ref4 = phase4_tokens[:MK_KNOB_REQUESTS]
    cells = {}
    for name, geom in (("default", mk.MegakernelGeometry()),
                       ("prefetch_depth=1",
                        mk.MegakernelGeometry(prefetch_depth=1)),
                       ("ffn_tile=1024", mk.MegakernelGeometry(
                           ffn_tile=1024))):
        res = serve_megakernel(torch, ops, model, ref4,
                               label=f"phase 38 (d) megakernel {name}",
                               traffic=traffic, mk_geometry=geom)
        count()
        cells[name] = res
    d = {}
    base = cells["default"]["tokens"]
    for name, res in cells.items():
        bd = res.pop("breakdown")
        toks = res.pop("tokens")
        first = None
        for i, (a, b) in enumerate(zip(toks, base)):
            if a != b:
                first = (i, next((j for j in range(min(len(a), len(b)))
                                  if a[j] != b[j]), min(len(a), len(b))))
                break
        d[name] = dict(tokens_equal_default=toks == base,
                       first_difference=first,
                       tick_device_ms=bd["decode_window"]["device_ms"],
                       decode_tok_s=res.get("decode_tok_s"),
                       launches=res["launches"].get("decode_tick"))
        if first is not None and first[1] < min(len(toks[first[0]]),
                                                len(base[first[0]])):
            i, n = first
            with torch.no_grad():
                ctx = torch.tensor([base[i][:n]], device="cuda")
                lg = model(ctx)[0, -1].float()
            d[name]["logit_gap"] = (lg[base[i][n]] - lg[toks[i][n]]).item()
    check(d["prefetch_depth=1"]["tokens_equal_default"],
          "phase 38 (d): prefetch_depth 1 changed the megakernel's tokens")
    # the ffn_tile tick against its plain twin sliced alike, W = 1,
    # MK_CHECK_LAYERS layers
    g = torch.Generator(device="cuda").manual_seed(381)
    L = MK_CHECK_LAYERS
    view = _layers_view(model, L)
    weights = mk.stack_layer_weights(view)
    x, pools, tables, pos, cosr, sinr = _tick_inputs(torch, model, g, L, 1)
    geom = mk.MegakernelGeometry(ffn_tile=1024)
    with torch.no_grad():
        out = decode_tick_cuda(x, [p.clone() for p in pools], tables, pos,
                               weights, cosr, sinr, eps=model.cfg.rms_norm_eps,
                               stages=geom.ring_stages(),
                               ffn_steps=geom.ffn_steps())
        twin = mk._tick_plain(x, [p.clone() for p in pools], tables, pos,
                              weights, cosr, sinr,
                              eps=model.cfg.rms_norm_eps, ffn_tile=1024)
    ratio = (_row_ratio(out, twin, _rms(twin)) / (2 * L)).max().item()
    d["ffn_tile=1024"]["tick_err_over_tol"] = ratio
    log("phase 38 (d) megakernel knobs: " + json.dumps(d))
    check(ratio <= 1.0, f"phase 38 (d): the ffn_tile tick is off its plain "
                        f"twin by {ratio:.3g} x row 13's tolerance")
    return d


def autotune_phase(torch, ops, model, serve_res):
    """Phase 38: the autotuner on the card over phase 4's model. Returns
    the readings; the launches of (a)-(d) in "launches"."""
    from paddle_tpu_torch.autotune import GeometryCache, local_device_kind

    out = {}
    launches = {}

    def count():
        # add the launches since the last reset (a serving cell of (d)
        # resets the counters at its start: each is counted after it)
        for name, n in ops.launch_counts().items():
            launches[name] = launches.get(name, 0) + n
        ops.reset_launch_counts()

    t = time.perf_counter()
    cache = GeometryCache()
    ops.reset_launch_counts()
    out["a"] = autotune_sweeps(torch, ops, model, cache)
    count()
    out["a_seconds"] = time.perf_counter() - t
    out["cache_fingerprint"] = cache.fingerprint()
    out["device_kind"] = local_device_kind()
    log("phase 38 (a) cache: " + json.dumps(
        dict(fingerprint=out["cache_fingerprint"],
             device_kind=out["device_kind"], entries=cache.to_dict()[
                 "entries"])))
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out["b"], out["c"] = autotune_search(torch, ops, model, cache, tmp)
    count()
    out["bc_seconds"] = time.perf_counter() - t
    t = time.perf_counter()
    out["d"] = autotune_megakernel(torch, ops, model, serve_res["tokens"],
                                   count)
    count()
    out["d_seconds"] = time.perf_counter() - t
    out["launches"] = launches
    for k in ("a", "bc", "d"):
        log(f"phase 38 ({k}) seconds: {out[k + '_seconds']:.1f}")
    return out


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "paddle_tpu_torch")):
        print(f"FAIL: no paddle_tpu_torch package beside {__file__}: run "
              f"the script from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama3_8b_config)
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import flash_attention_cuda as fac
    from paddle_tpu_torch.ops import fused_adamw as fw
    from paddle_tpu_torch.ops import fused_norm
    from paddle_tpu_torch.ops import paged_attention as pa

    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"(compiled {_build.BUILD_INFO['compiled']})")
    for line in _build.BUILD_INFO["log"].splitlines():
        if "registers" in line or "spill" in line or "==" in line:
            log("  " + line.strip())
    start_loader_server()
    if sys.argv[1:] == ["--only", "tick"]:
        # a diagnostic run: the build and phase 13 alone, no final line
        model = LlamaForCausalLM(llama3_8b_config())
        kernel_decode_tick(torch, ops, model)
        log("decode_tick kernel (per instantiation): "
            + json.dumps(decode_tick_build(_build)))
        log(f"partial run (phase 13 only): {time.perf_counter() - t_start:.1f}"
            f" s")
        return 0
    if sys.argv[1:] == ["--only", "spec"]:
        # a diagnostic run: the build, phase 3's paged attention (the
        # verify form at W = 5 among its cases), phase 4 and phase 26
        # alone, no final line
        kernel_paged_attention(torch, ops, pa, llama3_8b_config())
        model = LlamaForCausalLM(llama3_8b_config())
        serve_res, _, srv = serve(torch, ops, model)
        del srv
        log_spec(serve_spec(torch, ops, model, serve_res["tokens"]))
        log(f"partial run (phases 3, 4, 26 only): "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if sys.argv[1:] == ["--only", "invariance"]:
        # a diagnostic run: the build, phase 28 and phase 26 (with phase 4,
        # its random-prompt yardstick), no final line
        log("weight-streaming kernels: "
            + json.dumps(stream_gemm_build(_build)))
        batch_invariance(torch, ops)
        model = LlamaForCausalLM(llama3_8b_config())
        serve_res, _, srv = serve(torch, ops, model)
        del srv
        log_spec(serve_spec(torch, ops, model, serve_res["tokens"]))
        log(f"partial run (phases 28, 4, 26 only): "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if sys.argv[1:] == ["--only", "sched"]:
        # a diagnostic run: the build and phase 29 alone, no final line
        model = LlamaForCausalLM(llama3_8b_config())
        scheduling(torch, ops, model)
        log(f"partial run (phase 29 only): "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if sys.argv[1:] == ["--only", "recovery"]:
        # a diagnostic run: the build and phase 30 alone, no final line
        model = LlamaForCausalLM(llama3_8b_config())
        rec = recovery_serving(torch, ops, model, here)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        rec_train = recovery_train(torch, ops)
        for name, r in rec.items():
            log(f"phase 30 {name}: " + json.dumps(r))
        log("phase 30 (e) engine: " + json.dumps(rec_train))
        log(f"partial run (phase 30 only): "
            f"{time.perf_counter() - t_start:.1f} s")
        log(card)
        return 0
    if sys.argv[1:] == ["--only", "train_graph"]:
        # a diagnostic run: the build, phase 6's AdamW kernel, the
        # graphed training cells of phases 7 and 23 and phase 27 alone,
        # no final line
        kernel_adamw(torch, fw, ops)
        train_graph_parity(torch, ops)
        train(torch, ops)
        train_ernie(torch, ops)
        log(f"partial run (phases 6 AdamW, 7, 23, 27 only): "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if sys.argv[1:] == ["--only", "dense"]:
        # a diagnostic run: the build, phase 4 (the paged tokens phase 31
        # compares with) and phase 31 alone, no final line
        model = LlamaForCausalLM(llama3_8b_config())
        serve_res, _, srv = serve(torch, ops, model)
        del srv
        dense_res = dense_generation(torch, ops, model, serve_res["tokens"])
        model.quantize_int8()
        dense_res["int8"] = dense_int8(torch, ops, model)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        dense_res["gpt"] = gpt_generation(torch, ops)
        log_dense(dense_res, serve_res)
        log(f"partial run (phases 4, 31 only): "
            f"{time.perf_counter() - t_start:.1f} s")
        log(card)
        return 0
    if sys.argv[1:] == ["--only", "finetune"]:
        # a diagnostic run: the build, phase 6's AdamW kernel and phase 32
        # alone, no final line
        kernel_adamw(torch, fw, ops)
        fin = finetune(torch, ops)
        log("phase 32: " + json.dumps(fin))
        log(f"partial run (phase 32 only): {time.perf_counter() - t_start:.1f}"
            f" s")
        log(card)
        return 0
    if sys.argv[1:] == ["--only", "vision"]:
        # a diagnostic run: the build and phase 33 alone, no final line
        vis = vision(torch, ops)
        log("phase 33 (vision): " + json.dumps(vis))
        log(f"partial run (phase 33 only): {time.perf_counter() - t_start:.1f}"
            f" s")
        log(card)
        return 0
    if sys.argv[1:] == ["--only", "tensor"]:
        # a diagnostic run: the build and phase 34 alone (its (c) on a
        # seeded ResNet-50's eval logits), no final line
        log("phase 34 (tensor): " + json.dumps(tensor_api(torch, ops)))
        log(f"partial run (phase 34 only): {time.perf_counter() - t_start:.1f}"
            f" s")
        log(card)
        return 0
    if sys.argv[1:] == ["--only", "ocr"]:
        # a diagnostic run: the build and phase 35 alone, no final line
        log("phase 35 (ocr): " + json.dumps(ocr(torch, ops)))
        log(f"partial run (phase 35 only): {time.perf_counter() - t_start:.1f}"
            f" s")
        log(card)
        return 0
    if sys.argv[1:] == ["--only", "hapi"]:
        # a diagnostic run: the build and phase 36 alone, no final line
        log("phase 36 (hapi): " + json.dumps(hapi(torch, ops)))
        log(f"partial run (phase 36 only): {time.perf_counter() - t_start:.1f}"
            f" s")
        log(card)
        return 0
    if sys.argv[1:] == ["--only", "fleet"]:
        # a diagnostic run: the build, phase 4 (the tokens phase 37 holds
        # the fleet to) and phase 37 alone, no final line
        model = LlamaForCausalLM(llama3_8b_config())
        serve_res, _, srv = serve(torch, ops, model)
        del srv
        log("phase 37 (fleet): " + json.dumps(fleet(torch, ops, model,
                                                     serve_res)))
        log(f"partial run (phases 4, 37 only): "
            f"{time.perf_counter() - t_start:.1f} s")
        log(card)
        return 0
    if sys.argv[1:] == ["--only", "autotune"]:
        # a diagnostic run: the build, phase 4 (the model and tokens phase
        # 38 uses) and phase 38 alone, no final line
        model = LlamaForCausalLM(llama3_8b_config())
        serve_res, _, srv = serve(torch, ops, model)
        del srv
        t38 = time.perf_counter()
        at = autotune_phase(torch, ops, model, serve_res)
        log("phase 38 (autotune): " + json.dumps(
            {k: v for k, v in at.items() if k != "launches"}))
        log("phase 38 launches: " + json.dumps(at["launches"]))
        log(f"phase 38: {time.perf_counter() - t38:.1f} s; partial run "
            f"(phases 4, 38 only): {time.perf_counter() - t_start:.1f} s")
        log(card)
        return 0
    if sys.argv[1:] == ["--only", "serve"]:
        # a diagnostic run: the build and phases 4, 14, 24 and 25 alone, no
        # final line
        model = LlamaForCausalLM(llama3_8b_config())
        serve_res, _, srv = serve(torch, ops, model)
        del srv
        mk_res = serve_megakernel(torch, ops, model, serve_res["tokens"])
        eager_twin("bf16", serve_res, serve(
            torch, ops, model, label="serve llama3-8b paged (eager)",
            graphs=False)[0])
        eager_twin("bf16 megakernel", mk_res, serve_megakernel(
            torch, ops, model, serve_res["tokens"], graphs=False))
        log("graphed bf16 tick, host wall over device: "
            f"{graphed_tick_check(serve_res):.4f}")
        serve_windows(torch, ops, model, serve_res, mk_res)
        log(f"partial run (phases 4, 14, 24, 25 only): "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0
    # each phase group's end, seconds into the run
    marks = [("build", time.perf_counter() - t_start)]

    def mark(name):
        marks.append((name, time.perf_counter() - t_start))
        log(f"phase group {name} ended at {marks[-1][1]:.1f} s")

    fwd_build = flash_fwd_build(_build, fac)
    log("flash forward kernel (registers a thread at launch; consumers "
        "setmaxnreg to consumer_registers): " + json.dumps(fwd_build))
    bwd_build = flash_bwd_build(_build, fac)
    log("flash backward kernels (registers a thread at launch; "
        "consumers setmaxnreg to consumer_registers): "
        + json.dumps(bwd_build))
    stream_build = stream_gemm_build(_build)
    log("weight-streaming kernels (w8_matmul, fused LoRA; block_cols: W "
        "columns a block): " + json.dumps(stream_build))
    paged_build = paged_attention_build(_build)
    log("paged attention kernel (per pool type): " + json.dumps(paged_build))
    tick_build = decode_tick_build(_build)
    log("decode_tick kernel (per instantiation; registers a thread at "
        "launch, consumers setmaxnreg to consumer_registers): "
        + json.dumps(tick_build))

    cfg = llama3_8b_config()
    rms_cases = kernel_rms_norm(torch, fused_norm, cfg)
    attn_cases = kernel_paged_attention(torch, ops, pa, cfg)
    # phase 28: the decode and verify products, batch-invariant
    inv_res = batch_invariance(torch, ops)
    mark("phases 2-3, 28 (kernels, batch invariance)")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg)   # on the card, seeded
    torch.cuda.synchronize()
    log(f"model: llama3-8b {sum(p.numel() for p in model.parameters())} "
        f"params bf16, made on the card in {time.perf_counter() - t0:.1f} s")
    serve_res, prompt, srv4 = serve(torch, ops, model)
    e2e = end_to_end(torch, ops, model, prompt)
    mark("phases 4-5 (serve, end to end)")
    del srv4                    # its pools would count in the next peaks
    gc.collect()
    torch.cuda.empty_cache()
    # phase 24 (with each cell below): the same traffic, graphs off
    graph_cmp = {"bf16": eager_twin("bf16", serve_res, serve(
        torch, ops, model, label="serve llama3-8b paged (eager)",
        graphs=False)[0])}
    graph_cmp["bf16"]["graphed_tick_wall_over_device"] = graphed_tick_check(
        serve_res)
    mark("phase 24 bf16 eager twin")

    # phases 13-15, the whole-tick kernel, while the bf16 model is on the
    # card
    mk_cases = kernel_decode_tick(torch, ops, model)
    mk_res = serve_megakernel(torch, ops, model, serve_res["tokens"])
    graph_cmp["bf16 megakernel"] = eager_twin(
        "bf16 megakernel", mk_res, serve_megakernel(
            torch, ops, model, serve_res["tokens"], graphs=False))
    e2e_mk = end_to_end(torch, ops, model, prompt,
                        label="end_to_end megakernel", megakernel=True)
    mark("phases 13-15 (megakernel)")
    # phase 16, int8 KV pools under the bf16 model: per layer, then
    # through the whole-tick kernel
    kv8_res = serve_int8_kv(torch, ops, model, megakernel=False)
    sched_ref = {"bf16": serve_res["tokens"], "bf16 megakernel":
                 mk_res["tokens"], "int8-kv": kv8_res["tokens"]}
    graph_cmp["int8-kv"] = eager_twin("int8-kv", kv8_res, serve_int8_kv(
        torch, ops, model, megakernel=False, graphs=False))
    kv8_mk_res = serve_int8_kv(torch, ops, model, megakernel=True)
    sched_ref["int8-kv megakernel"] = kv8_mk_res["tokens"]
    graph_cmp["int8-kv megakernel"] = eager_twin(
        "int8-kv megakernel", kv8_mk_res, serve_int8_kv(
            torch, ops, model, megakernel=True, graphs=False))
    _shared_tokens(kv8_mk_res, kv8_res.pop("tokens"),
                   "serve int8-kv megakernel vs per layer")
    kv8_res.pop("prompts")
    e2e_kv8_mk = end_to_end(torch, ops, model, prompt,
                            label="end_to_end int8-kv megakernel",
                            kv_quant="int8", megakernel=True)
    mark("phase 16 (int8 KV)")
    # phase 25: tick_window = 4
    w4_res, w4_mk_res, window_res = serve_windows(torch, ops, model,
                                                  serve_res, mk_res)
    mark("phase 25 (windows)")
    # phase 26: speculative serving
    spec_res = serve_spec(torch, ops, model, serve_res["tokens"])
    mark("phase 26 (speculative)")
    # phase 29: priority scheduling and swap preemption
    yardsticks = {}
    sched_res = scheduling(torch, ops, model, sched_ref, yardsticks)
    mark("phase 29 (scheduling)")
    # phase 30 (a)-(d): observability and recovery, the bf16 model; its
    # overload references are phase 29's yardsticks (the same traffic on a
    # pool that never runs dry)
    rec_res = recovery_serving(torch, ops, model, here, sched_ref,
                               over={k: yardsticks[k] for k in (
                                   "bf16", "int8-kv", "bf16 megakernel")})
    mark("phase 30 (a)-(d) (recovery)")
    # phase 31 (a), (b): dense-cache serving and generate, the bf16 model
    dense_res = dense_generation(torch, ops, model, serve_res["tokens"])
    mark("phase 31 (a), (b) (dense)")
    # phase 37: the serving fleet over the bf16 model (phase 4's tokens)
    fleet_res = fleet(torch, ops, model, serve_res)
    mark("phase 37 (fleet)")
    # phase 38: the autotuner over the bf16 model (phase 4's tokens)
    at_res = autotune_phase(torch, ops, model, serve_res)
    mark("phase 38 (autotune)")

    # phases 9-12, while the bf16 serving model is on the card
    w8_cases = kernel_w8(torch, ops)
    attn8_cases = kernel_paged_attention_int8(torch, ops, pa, cfg)
    lora_cases = kernel_fused_lora(torch, ops, cfg)
    lora_res, _, lora_srv = serve_lora(torch, ops, model)
    graph_cmp["lora"] = eager_twin("lora", lora_res, serve_lora(
        torch, ops, model, graphs=False)[0])
    e2e_lora = end_to_end(torch, ops, model, prompt, label="end_to_end lora",
                          lora=(lora_srv._lora,
                                lora_srv._lora.acquire("a1")))
    # the rows on a1, a2 (the pool's two live pages) and no adapter
    pages = [lora_srv._lora.acquire(n) for n in ("a1", "a2")] + [0]
    lora_rows = (lora_srv._lora, [pages[i % 3] for i in range(MAX_BATCH)])
    lora_b8 = {name: verify_decode_b8(torch, ops, model, name, lora=lora_rows,
                                      megakernel=mega)
               for name, mega in (("lora", False), ("lora megakernel",
                                                    True))}
    del lora_srv
    gc.collect()
    torch.cuda.empty_cache()
    mark("phases 9-12 (int8 / LoRA kernels, LoRA serving)")
    # phase 17, the LoRA cell through the whole-tick kernel
    lora_mk_res, _, lora_srv = serve_lora(torch, ops, model, megakernel=True)
    graph_cmp["lora megakernel"] = eager_twin(
        "lora megakernel", lora_mk_res, serve_lora(
            torch, ops, model, megakernel=True, graphs=False)[0])
    _shared_tokens(lora_mk_res, lora_res["tokens"],
                   "serve lora megakernel vs per layer")
    e2e_lora_mk = end_to_end(torch, ops, model, prompt,
                             label="end_to_end lora megakernel",
                             lora=(lora_srv._lora,
                                   lora_srv._lora.acquire("a1")),
                             megakernel=True)
    del lora_srv
    gc.collect()
    torch.cuda.empty_cache()
    int8_res, _ = serve_int8(torch, ops, model)
    graph_cmp["int8"] = eager_twin("int8", int8_res, serve_int8(
        torch, ops, model, graphs=False)[0])
    int8_spec = serve_spec_int8(torch, ops, model)
    e2e_int8 = end_to_end(torch, ops, model, prompt, label="end_to_end int8",
                          kv_quant="int8")
    # phase 31 (b), int8 weights
    dense_res["int8"] = dense_int8(torch, ops, model)
    mark("phases 17, 11, 31 int8 (LoRA megakernel, int8)")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    # phase 31 (c): GPT-2 small
    dense_res["gpt"] = gpt_generation(torch, ops)
    mark("phase 31 (c) (GPT-2)")

    fwd_cases, bwd_cases = kernel_flash(torch, fa, fac, ops)
    adamw_cases = kernel_adamw(torch, fw, ops)
    mark("phase 6 (flash, AdamW kernels)")
    train_res = train(torch, ops)
    train_e2e = train_end_to_end(torch, ops, fa)
    mark("phases 7-8 (train)")
    # phases 18-20, long-context training through the streaming kernels
    stream_cases = kernel_flash_stream(torch, fa, fac, ops)
    long_res = train_long(torch, ops)
    long_e2e = train_long_end_to_end(torch, ops)
    mark("phases 18-20 (long context)")
    # phases 21-23, ERNIE-3.0 base finetune: LayerNorm (row 8), the flash
    # kernels at head dim 64, the finetune and its drift check
    ln_cases = kernel_layer_norm(torch, fused_norm)
    fwd64_cases, bwd64_cases = kernel_flash_d64(torch, fa, fac)
    ernie_res = train_ernie(torch, ops)
    ernie_e2e = ernie_end_to_end(torch, ops)
    mark("phases 21-23 (ERNIE)")
    # phase 27: the graphed training step against the eager one
    parity = train_graph_parity(torch, ops)
    mark("phase 27 (graph parity)")
    # phase 30 (e): the engine's telemetry and its retried step
    rec_train = recovery_train(torch, ops)
    mark("phase 30 (e) (engine telemetry)")
    # phase 32: LoRA finetune at full depth, served; offloaded optimizer
    # state; flat AdamW; offload_attn; AMP
    fin_res = finetune(torch, ops)
    mark("phase 32 (finetune)")
    # phase 33: ResNet-50 through the framework core and the layer surface
    eval_keep = {}
    vis_res = vision(torch, ops, eval_keep)
    mark("phase 33 (vision)")
    # phase 34: the tensor functions and the framework core; the op-level
    # suite (rows 1 and 8); phase 33 (c)'s eval metrics; the repairs
    tensor_res = tensor_api(torch, ops, eval_keep.pop("eval_batch"))
    mark("phase 34 (tensor)")
    # phase 35: BASELINE config 5 (CRNN + CTC, DBNet) through the recurrent
    # layers and the rest of nn; the vision zoo
    ocr_res = ocr(torch, ops)
    mark("phase 35 (ocr)")
    # phase 36: the data pipeline, the metrics, hapi.Model and the rest of
    # vision: BASELINE config 1 through Model.fit with two loader workers,
    # LeNet with Adam (row 10), vision.ops, the token reader
    hapi_res = hapi(torch, ops)
    mark("phase 36 (hapi)")

    def entry(name, source, replaces, cases, launches, **extra):
        main_case = cases[0]      # the main path's shape
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launches,
                    max_abs_err=max(c["max_abs_err"] for c in cases),
                    ms=main_case["ms"], plain_ms=main_case["plain_ms"],
                    bound_ms=main_case["bound_ms"],
                    bound_by=main_case["bound_by"],
                    library_ms=main_case["library_ms"], cases=cases, **extra)

    csrc = "paddle_tpu_torch/ops/csrc/"
    flash = "paddle_tpu/ops/flash_attention.py:"
    spec_cells = spec_res["cells"]
    tl = train_res["launches"]
    kernels = [
        entry("paged_attention", csrc + "paged_attention.cu",
              "paddle_tpu/ops/paged_attention_pallas.py:253", attn_cases,
              serve_res["launches"]["paged_attention"],
              build=paged_build["bf16"],
              spec_launches=spec_cells["ngram"]["launches"][
                  "paged_attention"]),
        entry("rms_norm", csrc + "rms_norm.cu",
              "paddle_tpu/ops/fused_norm.py:84", rms_cases,
              serve_res["launches"]["rms_norm"],
              train_launches=tl["rms_norm"],
              spec_launches=spec_cells["ngram"]["launches"]["rms_norm"]),
        entry("flash_fwd", csrc + "flash_attention.cu", flash + "488",
              fwd_cases, tl["flash_fwd"], build=fwd_build["D=128"],
              op_suite_launches=tensor_res["launches"].get("flash_fwd", 0),
              draft_model_launches=spec_cells["draft model"]["launches"][
                  "flash_fwd"]),
        entry("flash_bwd_dq", csrc + "flash_attention_bwd.cu",
              flash + "628",
              [c for n, c in bwd_cases if n == "flash_bwd_dq"],
              tl["flash_bwd_dq"],
              build=bwd_build["D=128"]["flash_bwd_dq"]),
        entry("flash_bwd_dkv", csrc + "flash_attention_bwd.cu",
              flash + "646",
              [c for n, c in bwd_cases if n == "flash_bwd_dkv"],
              tl["flash_bwd_dkv"],
              build=bwd_build["D=128"]["flash_bwd_dkv"]),
        entry("fused_adamw", csrc + "fused_adamw.cu",
              "paddle_tpu/ops/fused_adamw.py:167", adamw_cases,
              tl["fused_adamw"]),
        # rows 2, 5, 6, with their launches in phase 19's counted steps
        *(entry(name, csrc + src, flash + line,
                stream_cases[name], long_res["launches"][name], **extra)
          for name, src, line, extra in (
              ("flash_fwd_stream", "flash_attention.cu", "189",
               dict(build=fwd_build["D=128"])),
              ("flash_bwd_dq_stream", "flash_attention_bwd.cu", "352", {}),
              ("flash_bwd_dkv_stream", "flash_attention_bwd.cu", "376",
               {}))),
        # row 8 and rows 1, 3, 4 at head dim 64, with their launches in
        # phase 23's counted steps and eval passes
        entry("layer_norm", csrc + "layer_norm.cu",
              "paddle_tpu/ops/fused_norm.py:128", ln_cases,
              ernie_res["launches"]["layer_norm"],
              op_suite_launches=tensor_res["launches"].get("layer_norm", 0),
              op_suite_case=tensor_res["b"]["layer_norm"]),
        entry("flash_fwd_d64", csrc + "flash_attention.cu", flash + "488",
              fwd64_cases, ernie_res["launches"]["flash_fwd"],
              build=fwd_build["D=64"]),
        *(entry(f"{name}_d64", csrc + "flash_attention_bwd.cu",
                flash + line, [c for n, c in bwd64_cases if n == name],
                ernie_res["launches"][name],
                build=bwd_build["D=64"][name])
          for name, line in (("flash_bwd_dq", "628"),
                             ("flash_bwd_dkv", "646"))),
        entry("w8_matmul", csrc + "w8_matmul.cu", "paddle_tpu/ops/int8.py:80",
              w8_cases, int8_res["launches"]["w8_matmul"],
              build=stream_build["w8_matmul"]),
        entry("paged_attention_int8", csrc + "paged_attention.cu",
              "paddle_tpu/ops/paged_attention_pallas.py:253", attn8_cases,
              int8_res["launches"]["paged_attention_int8"],
              build=paged_build["int8"]),
        entry("fused_lora_matmul", csrc + "fused_lora.cu",
              "paddle_tpu/ops/paged_attention_pallas.py:343", lora_cases,
              lora_res["launches"]["fused_lora_matmul"],
              build=stream_build["fused_lora"]),
        # the port's own kernel: no TPU counterpart (XLA runs these
        # products in the JAX package); launches a decode tick and a
        # verify window per layer (7 projections a layer and the head)
        entry("stream_matmul", csrc + "stream_matmul.cu",
              "none: paddle_tpu/models/llama.py leaves these products to "
              "XLA", inv_res["bf16"],
              serve_res["launches"]["stream_matmul"],
              launches_per_tick=7 * cfg.num_hidden_layers + 1,
              launches_per_window=7 * cfg.num_hidden_layers + 1,
              spec_launches=spec_cells["ngram"]["launches"]["stream_matmul"],
              megakernel_launches=mk_res["launches"]["stream_matmul"],
              build=stream_build["stream_matmul"]),
    ]
    # row 13, each variant of the tick with the launches of its serving
    # cell (the int8 variant's cases include the "tile" mode, the LoRA
    # variant's the int8 pools with LoRA)
    for name, cases, res in (
            ("decode_tick", mk_cases["fp"], mk_res),
            ("decode_tick_int8", mk_cases["int8"] + mk_cases["int8_tile"],
             kv8_mk_res),
            ("decode_tick_lora", mk_cases["lora"] + mk_cases["int8_lora"],
             lora_mk_res)):
        extra = ({} if name != "decode_tick" else dict(
            spec_launches=spec_cells["ngram megakernel"]["launches"][
                "decode_tick"]))
        kernels.append(entry(
            name, csrc + "decode_megakernel.cu",
            "paddle_tpu/ops/decode_megakernel.py:845", cases,
            res["launches"]["decode_tick"], **extra,
            per_layer_kernels_ms=cases[0]["per_layer_kernels_ms"],
            library_note=cases[0]["library_note"], build=tick_build[
                {"decode_tick": "fp", "decode_tick_int8": "int8",
                 "decode_tick_lora": "fp_lora"}[name]]))
    # phase 30's launches (its serving half and its engine) beside each
    # kernel's main-path count, and phase 31's (the bf16 dense server, the
    # int8 one, GPT-2's generate)
    dense_launches = dict(dense_res["launches"])
    dense_launches["w8_matmul"] = dense_res["int8"]["launches"]["w8_matmul"]
    gl = dense_res["gpt"]["launches"]
    dense_launches.update(layer_norm=gl.get("layer_norm", 0),
                          flash_fwd_d64=gl.get("flash_fwd", 0))
    for k in kernels:
        k["recovery_launches"] = (rec_res["launches"].get(k["name"], 0)
                                  + rec_train["launches"].get(k["name"], 0))
        k["dense_launches"] = dense_launches.get(k["name"], 0)
        # phase 37 (a)-(c): the in-process fleet's replica passes
        k["fleet_launches"] = fleet_res["launches"].get(k["name"], 0)
        # phase 38 (a)-(d): the sweeps, the search's trials, the profile
        # server and the megakernel's knobs; (a)'s cells of the kernel (its
        # schedules: the default's ms, the winner and its speed-up)
        k["autotune_launches"] = at_res["launches"].get(k["name"], 0)
        prefix = {"paged_attention": "paged_attention ",
                  "paged_attention_int8": "paged_attention_int8 ",
                  "rms_norm": "rms_norm ", "layer_norm": "layer_norm ",
                  "fused_lora_matmul": "fused_lora ",
                  "decode_tick": "decode_tick "}.get(k["name"])
        if prefix is not None:
            k["geometry_cells"] = [
                dict(cell=c["cell"], default_ms=c["default_ms"],
                     winner=c["winner"], speedup=c["speedup"],
                     candidates=len(c["trials"]),
                     bitwise_equal=sum(t["exact"] for t in c["trials"]))
                for c in at_res["a"] if c["cell"].startswith(prefix)]
        # phase 32's main path: (a)'s counted steps, (b)'s served run
        k["finetune_launches"] = fin_res["launches"].get(k["name"], 0)
        if k["name"] == "fused_adamw":
            # row 10's new launch shapes: the whole model's flat state in
            # one launch; a parameter's moments streamed from the host
            k["flat_case"] = fin_res["d"]["flat_launch"]
            k["flat_launches_per_step"] = 1
            k["offloaded_device_ms_per_step"] = fin_res["c"]["full"][
                "device_ms_by_class"].get("fused_adamw")
            # phase 35's main path: one launch a trainable parameter a
            # step of CRNN's and DBNet's graphed cells
            k["ocr_launches_per_step"] = ocr_res["launches"]
            k["ocr_launches"] = {
                cell: ocr_res[cell]["graphs"]["launches"]["fused_adamw"]
                for cell in ("a", "b")}
            # (c): one step at CRNN's and DBNet's shapes against the
            # plain version on the CPU
            k["ocr_step_err_over_max"] = {
                m: ocr_res["c"][m]["adam"]["err_over_max"]
                for m in ("crnn", "dbnet")}
            # phase 36 (b)'s main path: Model.fit over LeNet with Adam, one
            # launch a trainable parameter a step; one step against the
            # plain version on the CPU
            k["hapi_launches_per_step"] = hapi_res["launches_per_step"]
            k["hapi_launches"] = hapi_res["b"]["launches"]
            k["hapi_step_err_over_max"] = hapi_res["b"]["adam"][
                "err_over_max"]
    # the run's serving, breakdown, end-to-end and training readings once
    # more, so that they stand in the last lines of the output beside the
    # kernels
    for label, res, e in (("serve llama3-8b paged", serve_res, e2e),
                          ("serve llama3-8b paged megakernel", mk_res,
                           e2e_mk),
                          ("serve llama3-8b paged int8-kv", kv8_res, None),
                          ("serve llama3-8b paged int8-kv megakernel",
                           kv8_mk_res, e2e_kv8_mk),
                          ("serve llama3-8b paged lora", lora_res, e2e_lora),
                          ("serve llama3-8b paged lora megakernel",
                           lora_mk_res, e2e_lora_mk),
                          ("serve llama3-8b paged int8", int8_res, e2e_int8),
                          (f"serve llama3-8b paged W={WINDOW}", w4_res, None),
                          (f"serve llama3-8b paged megakernel W={WINDOW}",
                           w4_mk_res, None)):
        breakdown = res.pop("breakdown")
        res.pop("tokens", None)
        res.pop("prompts", None)
        log(f"{label}: " + json.dumps(res))
        log("pass breakdown (host vs device): " + json.dumps(breakdown))
        if e is not None:
            log("end_to_end kernels vs plain vs fp32: " + json.dumps(e))
    log_spec(spec_res)
    log("phase 26 (b) LoRA at B = 8: " + json.dumps(lora_b8))
    log("phase 26 int8 weights: " + json.dumps(int8_spec))
    log("phase 28, batch invariance: " + json.dumps(
        {k: v for k, v in inv_res.items() if k != "bf16"}))
    for name, r in sched_res.items():
        log(f"phase 29 {name}: " + json.dumps(r))
    log("phase 24, graphs on / off: " + json.dumps(graph_cmp))
    log(f"phase 25, sampled W = {WINDOW}: "
        + json.dumps(window_res))
    log("train llama3-8b (8 layers): " + json.dumps(train_res))
    log("train end_to_end kernels vs plain vs fp32: " + json.dumps(train_e2e))
    log("train long (phase 19): " + json.dumps(long_res))
    log("train long end_to_end kernels vs remat vs plain vs fp32: "
        + json.dumps(long_e2e))
    for key in ("a", "b", f"c{ERNIE_S}", f"c{ERNIE_LONG_S}"):
        log(f"ernie ({key}): " + json.dumps(ernie_res[key]))
    log("ernie end_to_end kernels vs plain vs fp32: "
        + json.dumps(ernie_e2e))
    log("phase 27, graphed against eager training: " + json.dumps(parity))
    for name, r in rec_res.items():
        log(f"phase 30 {name}: " + json.dumps(r))
    log("phase 30 (e) engine: " + json.dumps(rec_train))
    log_dense(dense_res, serve_res)
    log("phase 32 (finetune): " + json.dumps(fin_res))
    log("phase 33 (vision): " + json.dumps(vis_res))
    log("phase 34 (tensor): " + json.dumps(tensor_res))
    log("phase 35 (ocr): " + json.dumps(ocr_res))
    log("phase 36 (hapi): " + json.dumps(hapi_res))
    log("phase 37 (fleet): " + json.dumps(fleet_res))
    log("phase 38 (autotune): " + json.dumps(
        {k: v for k, v in at_res.items() if k != "launches"}))
    prev = 0.0
    for name, at in marks:
        log(f"phase time {name}: {at - prev:.1f} s")
        prev = at
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
