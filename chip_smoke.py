"""Quickest proof that the PyTorch/CUDA port runs on the card.

Run from the repository root on a machine with one CUDA device:

    python3 chip_smoke.py

It imports the port (``src/repro_torch``) and nothing of JAX or of the
JAX package, and runs these phases; any failure exits non-zero before the
last line is printed.

1. Device and build: prints the card's name and power limit (nvidia-smi),
   then compiles every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, all started together), with registers, spills
   and shared memory per kernel, and the SASS opcode census of B8's
   tensor-core kernel (conversion instructions among them).
2. Kernel phase: each kernel at the shapes its paths give it against its
   plain PyTorch version on the same inputs — B1 quantize (bf16 serving
   shards and the fp32 master shards of training), B2 dequantize, and the
   qgZ kernels B3 reorder-quantize, B4 dequant-reduce-requantize and B5
   dequant-reduce (every flat group of qwen3-0.6b and of the 8-layer
   gemma3-4b with N = 1 — gemma3's embedding is 671,088,640 elements, its
   fp32 shard 2.7 GB, past 2^31 bytes —, the reorder
   shape (Y, X, L) = (2, 8, 1,966,336), N = 8 at one layer group, and the
   chain a rank of phase 6's 2 x 2 world runs at a layer group: B3 on (2,
   2, 3,932,928), B4 and B5 at N = 2) all bit-identical; B8 dequant-GEMM
   within fp32 rtol 1e-5, atol 1e-5·max|out| (summation order), at the
   head's decode (T = 4) and prefill (T = 1) shapes, the paged engine's
   (T = 32, a prefill chunk; T = 20, a speculative verify at 4 slots),
   the broadcast layout (NB = 1) and edge inputs
   (T 1-9 and 17, N 1, 31 and 4,097, (K, NB) (64, 1), (1024, 4) and (4096,
   16); rows of all -128 and all +-127; scales +-0, subnormal, 3.4e38, inf
   and NaN, with NaN and inf where the plain version has them; bf16 and
   fp32 x, weights rounded to bf16 or not), two launches bit-identical, and
   beside its time cuBLAS's bf16 product on the already-dequantized weights
   (a yardstick the port never calls) — with its median time (CUDA events, L2
   flushed before every launch, warm-up excluded), the plain version's time
   and the least time the card could take (bytes over 3.35 TB/s or
   operations over the type's peak, whichever is larger); for B3 and B4
   also the effective GB/s and the share of the bound, and the time of a
   plain ``copy_`` that moves the kernel's payload bytes (B3: reads every
   32-byte sector of its bf16 input and writes its INT4 payload; B4: its
   payload in and out; B5 at the 2 x 2 path's N = 2: as many bytes read
   and written as it moves), then B3 and B4 at edge shapes (1, 3 and 4,097
   quant blocks, every block size, N up to 11, INT4/INT8, fp32/bf16, u
   fields, zero, half-way and raw-payload inputs), all bit-identical.
   Then the flash
   pair: B6 forward and B7 backward in bf16 (the tensor-core kernels) at
   the training path's shape (B 8, S 2048, H 16, K 8, hd 128, causal)
   and at five small shapes that reach what the path does not (window 300
   with softcap 30, non-causal, Sq < S, hd 16 and 64, GQA groups 1, 2 and
   4), against the plain versions (element by element,
   ``repro_torch.testing.flash_bars``: out within 2^-7 of its row's sum
   p|v|/l plus one bf16 ulp, m and l within 2e-5; dq, dk, dv within one
   bf16 ulp plus 3e-5; and the out bar must be one that a kv tile dropped
   or counted twice in the last q tile would exceed), and at (B 1, S
   1024) in fp32 (the FFMA kernels) at the reference's bars (2e-5
   forward, 3e-5 backward), plain causal and with a window and a softcap;
   two launches on the same inputs must give the same bits.  Beside their
   times: SDPA's at the same shape (forward, and backward), a yardstick
   that the port never calls, and both routes' times at (B 1, S 1024).
3. Engine phase: qwen3-0.6b at full width (d 1024, vocab 151936) cut to
   ``CUT_LAYERS`` = 7 of its 28 layers (to keep the script inside its
   time; phase 13 serves all 28), bf16 weights from a seeded generator, on
   ``ServeEngine(n_slots=4, kv_len=2048)``: six greedy requests (prompts
   7, 33, 120, 257, 600 and 1500 tokens — the last prefills in the 2048
   bucket, through the chunked attention path — 32 new tokens each, so
   slots recycle).  Checks that every request finishes, that each
   request's first-token logits match its own standalone raw prefill,
   that each of the engine's batched decode steps matches the request
   decoded alone on the engine's own tokens (teacher-forced), and that
   every kernel's launch count over the run is > 0 and equals what the
   code issues per model call; prints greedy agreement, TTFT, decode
   tokens/s and ms per decode step.
3b. Paged serving phase, on phase 3's model, params and prompts:
   ``ServeEngine(pool="paged", n_slots=4, kv_len=2048, page_size=16)``
   (chunks of 32).  The six requests: every one finishes, each
   request's first-token logits within ``LOGIT_ATOL`` of its raw prefill
   and each paged decode step held by phase 3's rule against the request
   alone, teacher-forced on the engine's tokens (rows of phase 3's alone
   runs reused where the token streams agree, recomputed from the first
   token that differs), B1, B2 and B8 launched per-call x model calls.
   The prefix wave: three prompts sharing 512 tokens (suffixes of 40,
   120 and 200), the second and third submitted once the first has
   finished its prefill: at least 2 hits reusing 1,024 tokens; the first
   prompt resubmitted after it retired must give bit-identical
   first-token logits; every refcount 0 after the drain.  Speculative
   decoding (``spec_tokens=4``) of the first four prompts, self-drafted
   (mean accepted > 1) and by qwen3-0.6b's widths at 4 layers (seed 1),
   every verify row that produced a token held by the same rule, and the
   launches of both models.  Prints TTFT, ms per decode step and
   tokens/s beside the slab engine's, the tokens a target step under
   each drafter, the arenas' bytes and the phase's seconds.
4. Train-parity phase: qwen3-0.6b widths at 2 layers and a vocabulary of
   8192 (4 unembedding chunks), fp32 compute, full ZeRO++: one
   ``loss_and_grads`` on the card (kernels) and on the CPU (plain
   versions) from the same parameters, of a batch of 2 × 256 with plain
   attention and of 2 × 512 with ``attn_impl="pallas"`` (through B6/B7),
   each held to the rule the CPU tests hold the port to against the
   reference (loss within 1e-5; a gradient element beyond rtol 1e-5 /
   atol 1e-6 only by at most one INT4 step of its block, in fewer than 1
   of 1,000 elements), with the step read on both sides' block scales,
   which must agree to rtol 1e-5.  The CPU halves of this phase's and
   phases 10 and 12's parity steps run in a process of their own from
   the script's start (``ParityCPU``, ``PARITY_THREADS`` threads), beside
   the kernel, parity and single-card training phases; the serving
   phases (3, 3b, 10's and 12's engines, then 11 and 13), whose time goes
   to the host, start only after it has ended.
5. Train phase: ``repro_torch.launch.train.train_loop`` at full width
   (28 layers, bf16 compute, fp32 master and moments, full ZeRO++ on a
   one-rank ("data", "model") world), 8 steps of ``SyntheticLM`` batches
   of 8 × 2048 tokens at a constant lr of 3e-4, first with ``--attn
   pallas`` (this slice's path: every layer's attention through the flash
   kernels), then with ``--attn xla`` from the same seed on the same
   batches.  Checks finite losses, the last step's loss below the first's
   by ``LOSS_DROP``, the two runs' step-1 losses within
   ``ROUTE_LOSS_ATOL``, and that every step launches each of B1–B5
   exactly once per flat group and, under pallas, B6 twice and B7 once
   per layer; prints step time (p50 of steps 2–8), tokens/s, peak memory
   and one profiled step (device busy share, device kernels, the flash
   kernels' and each of B1–B5's device ms, top device ops) of each run.
   The pallas run has its telemetry on (``--metrics-dir`` into a
   temporary directory, ``--obs-gate``): its ``BENCH_runtime.json`` must
   be written with a passing comm gate and no byte counted (world 1);
   then ``OVERHEAD_STEPS`` steps with telemetry on (a registry installed,
   the step's span, counters and histogram, a flush with fsync) alternate
   with as many steps with it off, and ``overhead_gate``'s reading of
   what telemetry costs when on is printed (not gated: a wall-clock bar
   would fail on noise).
6. Multi-rank train phase: the same pallas run (seed, batches, lr) on a
   2 x 2 ("data", "model") world, four rank processes sharing the card
   over a gloo group (``repro_torch.launch.mesh.spawn``, kernels built
   once before the ranks start), ``MR_STEPS`` steps at the default
   prefetch ring (depth 1: layer i+1's gathers in flight under layer i's
   compute), then ``MR_SYNC_STEPS`` steps of the synchronous schedule
   (``--prefetch 0``) in the same ranks: each rank holds its shard of the
   same global parameters and reads 2 of the 8 rows, so hpZ re-gathers
   over the intra pair and qgZ's B3/B4 run at N = X = 2, B5 at N = Y = 2.
   Checks that every rank agrees on the summed losses, the step-1 loss is
   within ``MR_LOSS1_ATOL`` of phase 5's pallas run, every loss is finite
   and within ``MR_REL`` of that run's at the same step, the last below
   the first, the synchronous losses equal the ring's first ones bit for
   bit, and every rank launches each of B1–B5 once per flat group, B6
   twice and B7 once per layer each step at both depths; prints, per
   depth, each rank's step time (p50 from step 2), peak memory and
   launches, and rank 0's profiled step: host wall, its device busy time
   and the host time inside the gloo collectives, and that time split by
   collective label (the ``zero.*``/``other`` ranges around each issue
   and each ``.wait``).  Both runs have the launcher's telemetry on
   (``--metrics-dir``, ``--obs-gate``): every rank gates its wire bytes
   per label at every step (the ``comm.<label>.bytes`` counters) against
   the port's projection at 1 % and checks that the ranks agree, and a
   miss fails the rank; prints them in MiB a rank a step beside the
   projection, and the paper's Table-1 volumes of qwen3-0.6b
   (``zeropp.comm_volume_per_step``) with their cut.  The synchronous
   run saves a checkpoint after its last step (``--ckpt-dir
   --ckpt-every``: every rank its shard file); phase 11 restores it.
   Phases 6, 7 and 8 run in one spawn of the four ranks (one start and
   one warm-up for their seven runs); each is checked as set out here.
7. Sequence-parallel phase: the 2 x 2 world at a global batch of
   ``SP_BATCH`` x 2048, which covers only ``data``: each rank holds one
   row's half of the sequence (1,024 tokens), ``mha`` all-gathers K/V
   over the intra pair and reduce-scatters their cotangents, and the
   flash kernels stay out (the reference's rule for a sharded sequence;
   ``--attn pallas`` takes the chunked route), ``SP_STEPS`` steps at the
   default ring.  Checks the step-1 loss within ``MR_LOSS1_ATOL`` of a
   world-1 ``--attn xla`` step on the same rows from the same seed (run
   first, in this process), losses finite and falling, every rank
   launching each of B1–B5 once per flat group and no flash kernel each
   step, and the wire bytes as phase 6 (``other`` now carries the K/V
   gathers and reduce-scatters); prints what phase 6 prints.
8. Knob phase: the paper's ablation knobs on the 2 x 2 world (qwen3-0.6b
   full width, --attn pallas, batch 8, phase 6's seed, batches and lr),
   ``KNOB_STEPS`` steps of each in phase 6's ranks, passed to
   ``train_loop`` as ``ZeroConfig`` overrides: ``qgz_2hop=False`` (the
   1-hop all-to-all: B1 and B5 at N = 4, no B3/B4), ``qgz_bits=8`` (B3/B4/
   B5 at INT8), ``qwz_blocked=False`` (one scale a shard, plain PyTorch:
   no B1/B2) and ``hpz_axes=("data", "model")`` (hpZ over the world).
   Each run's gate passes on every rank with the reference projection's
   MiB a rank a step (``KNOB_MIB``) to the byte, and every rank's bytes by
   interconnect tier (``comm.tier.<tier>.bytes``) sum to its labels' at
   every step (printed by tier beside the labels; so are phases 6, 7 and
   9's); the 1-hop's bytes on the slow tier (``data``) exceed the 2-hop's
   of phase 6 and its fast-tier bytes fall short of them, the ordering of
   the reference's ``per_tier_wire`` at this shape; losses are finite; the
   step-1 and step-2 losses hold phase 6's as the note at ``KNOBS`` says;
   every rank's launches per step are what its config issues; under
   ``qwz_blocked=False`` every rank's gather of a layer group on the card
   equals ``quantize_global`` / ``dequantize_global`` of every shard on
   the host, bit for bit.
9. Multi-pod phase: the 2 x 2 x 2 ("pod", "data", "model") world, eight
   rank processes of qwen3-0.6b at full width cut to ``CUT_LAYERS`` = 7
   of its 28 layers, on the one card, batch 8
   (one row a rank), --attn pallas: ``MP_STEPS`` steps at the default
   config (qgZ's inter hop over ("pod", "data"): B5 at N = 4), then
   ``MP_HPZ_STEPS`` with ``hpz_axes=("data", "model")`` (one pod), in one
   spawn.  The gate on every rank (``MP_MIB``, ``MP_HPZ_MIB``), finite
   losses, the step-1 loss within ``MR_LOSS1_ATOL`` of a world-1 run of
   the same cut model on the same rows (run first, in this process) and
   the hpZ run's equal to the default's; prints each rank's
   step times and peak, and rank 0's profiled step (host wall, device
   busy share, gloo host time by label).

10. gemma3-4b phases (head dim 256, 5 local : 1 global layers), on the
   full width cut to ``GEMMA_LAYERS`` = 8 layers (one period and a rem
   group of 2 local layers): after the flash phase, B6/B7 at hd 256 in
   bf16 at q (2, 4096, 8, 256), k/v (2, 4096, 4, 256), causal with the
   local layers' window of 1024 and without, held as phase 2 holds hd
   128 and timed beside the bound (the window's pairs only), the plain
   versions and SDPA (with the backend it took), and in fp32 at (1,
   1024, 8/4, 256), plain causal and with window 300 and softcap 30, at
   2e-5 / 3e-5, two launches bit-identical; B8 at gemma3's head chunk (T
   4, N 65,536, K 2560); B1-B5 at its flat groups in phase 2. After
   phase 5: phase 3 on the 8-layer model
   (prompts 7, 300, 1100 and 1500, the last two wrapping the 1024-slot
   rings at prefill, each prefilled at its exact length); phase 4's rule
   on a 3-layer ("local", "attn") stack of gemma3's widths, vocab 8192,
   batch 1 x ``GEMMA_PARITY_SEQ`` under --attn pallas; and
   ``train_loop`` on the 8-layer model (bf16, full ZeRO++, world 1,
   --attn pallas, batch 2 x 4096, 6 steps at lr 3e-4): finite losses,
   the last below the first, B6 twice and B7 once a layer and B1-B5 once
   a flat group (the rem group included) every step; step p50, tokens/s,
   peak memory and a profiled step.  The build report's per-kernel lines
   give every hd-256 instantiation's registers, spills and shared
   memory.
11. Checkpoint phase (after phase 6; qwen3-0.6b at full width, --attn
   pallas, phase 5's seed, batch and lr; ``shutil.disk_usage`` of the
   checkpoints' temporary directory printed first, ``CKPT_FREE_GB``
   required, every checkpoint deleted after its use): a world of 1
   restores phase 6's 2 x 2 checkpoint (four shard files, one manifest;
   each rank's save time printed) through ``--ckpt-dir`` and runs to step
   ``MR_STEPS``, each loss within ``CKPT_REL_ELASTIC`` of phase 6's; then
   ``train_loop`` takes ``CKPT_STEPS`` steps at world 1 and saves fp32
   (``--ckpt-every``), the same state is saved INT8 (under
   ``CKPT_INT8_SIZE`` of the fp32 directory), both restore into fresh
   tensors on the card (fp32 bit-identical to the saved state, every INT8
   parameter block within absmax/127 · 0.6 + 1e-8); the next step from
   the in-memory state twice and from the fp32 restore must be
   bit-identical (or, if the in-memory step does not repeat, the restore
   within its spread), and the INT8 restore's next two losses within
   ``CKPT_REL_INT8`` of the fp32 restore's; save, restore and fsync
   seconds and sizes printed.  ``ServeEngine.from_checkpoint`` boots from
   the INT8 checkpoint and serves phase 3's first four prompts greedily
   to the tokens of an engine given ``load_global`` -> ``fit_to`` -> bf16
   of it (first prefill logits bit-identical); a gemma3-4b engine refuses
   it.  The restored steps and the booted engine count as paths of
   B1-B8.
12. qwen2-vl-72b phase (QKV bias, M-RoPE, embedding inputs: the
   reference's vlm backbone, the frontend stubbed), at full width (d
   8192, 64/8 heads of 128, d_ff 29,568, vocab 152,064) cut to
   ``QWEN2VL_LAYERS`` = 2 of its 80 layers (3.0 B parameters, 48 GB of
   fp32 state at world 1).  In phase 2: B1-B5 at its layer group
   (877,684,736 elements) and an unembedding chunk, bit-identical; B8 at
   its head (T 4, N 25,344, K 8192) beside cuBLAS; the bf16 flash cases
   of starcoder2-3b's (H 24 / K 2, hd 128) and musicgen-large's (H 32 / K
   32, hd 64) attention; after the gemma3 flash phase, B6/B7 in bf16 at
   (4, 2048, 64/8, 128) causal (a GQA group of 8) held as FLASH_SHAPE,
   timed beside SDPA.  After the gemma3 train phase: ``train_loop`` (bf16,
   full ZeRO++, world 1, --attn pallas) for 4 steps of 4 x 2048 stub
   embeddings and (t, t // 16, t % 16) positions (the stub's 4.98 GB
   table drawn on a host thread from the script's start): finite losses,
   the last below the first, launches ``step_launches`` (no embedding
   group); step p50, tokens/s, peak memory, a profiled step.  Phase 4's
   rule on 1 layer of its widths (vocab 4,096, 1 x 512, --attn pallas,
   biases seeded nonzero).  The reference's serving consistency check at
   full width through ``serve/steps.py`` in fp32: prefill of 124
   positions plus 4 decode steps against one prefill of 128, relative
   2e-2 and the same argmax; then the bf16 path (B8 in the head) at 4
   rows, its decode step timed and profiled.
13. Sharded serving phase (after phase 11, booted from its world-1 INT8
   checkpoint): four ranks of a 2 x 2 world over gloo, qwen3-0.6b at
   full width, ``ServeEngine.from_checkpoint(mesh=)`` (each rank its
   shard of every buffer) serving phase 3's first four prompts,
   ``CKPT_MAX_NEW`` greedy tokens each, through the slab engine (slots
   over "data", each slot's cache sequence over "model": B8 at 2 rows a
   rank) and the paged engine (page 16, chunks of 32, each page's tokens
   over "model").  Every rank must emit the same tokens, launch B1, B2
   and B8 as its calls add up to, and count a call's qwZ bytes at the
   training forward's 546.025 MiB; every logits row rank 0 saw is held
   against the world-1 model on the same checkpoint teacher-forced
   (phase 3's rule).  Prints ms a decode tick, TTFT, tokens/s, MiB a
   rank a call by label and rank 0's profiled decode step.  Phase 2 also
   times B1 on a rank's layer-group shard there (3,932,928 elements)
   and B8 at T = 2.
14. MoE phase: deepseek-moe-16b (d 2048, 16/16 heads of 128, 64 routed
   experts top-6 in 4 chunks of 16, 2 shared, moe_ff 1408, vocab 102,400)
   at full width cut to ``MOE_LAYERS`` = 4 of its 28 layers (2.77 B
   parameters).  In phase 2: B1-B5 at its layer group, its expert chunk
   (138,412,032 elements) and its unembedding chunk, bit-identical; B8 at
   its head (T 4, N 25,600, K 2048); after the qwen2-vl flash phase B6/B7
   in bf16 at (4, 2048, 16/16, 128) causal, held and timed as the others.
   After the qwen2-vl parity step: ``train_loop`` (bf16, full ZeRO++,
   world 1, ring depth 1, --attn pallas) for ``MOE_TRAIN_STEPS`` steps of
   4 x 2048 (the layer ring, each layer's expert-chunk ring, the
   routing-ahead chunk-0 gather and the hpZ nested recompute): finite
   losses, the last below the first, finite ``moe_aux``, every step's
   launches what ``comm_events`` counts (B1/B2 a qwZ gather, B3-B5 a
   reduce) with B6 twice and B7 once a layer; step p50, tokens/s, peak
   memory and a profiled step (the expert GEMMs' device ms under
   ``aten::bmm``); then ``MOE_SYNC_STEPS`` steps at ``--prefetch 0``
   whose losses must equal the ring's bit for bit.  Phase 4's rule on
   deepseek-moe-16b reduced (vocab 8192, 2 x 512 under --attn pallas),
   with every router call's expert indices equal on the card and the CPU.
   After the qwen2-vl serving phase: phase 3 on the cut model in bf16
   (4 slots, kv_len 2048, phase 3's first four prompts, ``MOE_MAX_NEW``
   tokens each), each request's router margins alone printed.
15. SSM phase: mamba2-130m at full width and depth (24 ``ssd`` layers,
   d 768, d_inner 1536, 24 heads of 64, state 128, chunk 128, vocab
   50,280: 167,555,520 parameters) and recurrentgemma-2b at full width
   (d 2560, ``rec``/``rec``/``local`` with 10/1 heads of 256, window 2048,
   d_ff 7680, vocab 256,000) cut to ``RG_LAYERS`` = 8 of its 26 layers
   (two periods and the two-layer rem group: 2,008,174,080 parameters).
   In phase 2: B1-B5 at their layer groups (3,763,712 and 256,952,320
   elements), bit-identical; B8 at their heads (T 4; N 12,570, K 768 and
   N 64,000, K 2560) beside cuBLAS; after the moe flash phase B6/B7 in
   bf16 at (2, 4096, 10/1, 256) causal under the 2048 window (a GQA
   group of 10), held and timed beside SDPA.  After the moe parity step:
   ``train_loop`` (bf16, full ZeRO++, world 1, --attn pallas) on mamba2
   at ``SSM_TRAIN["mamba2"]`` (8 x 2048, 4 steps, chunk 128: where the
   reference's segment sum overflows its gradient) and on recurrentgemma
   (``--layers 8``) at 2 x 4096, 3 steps (the window bites): finite
   losses, the last below the first, every gradient of one more
   ``loss_and_grads`` finite, every step's launches ``step_launches`` (B1-
   B5 a flat group, B6/B7 on the ``local`` layers only); step p50,
   tokens/s, peak memory and a profiled step.  Phase 4's rule on each at
   full width cut in depth (mamba2 2 layers, 2 x 512; recurrentgemma one
   period, 1 x 2048; vocab 8192 in 4 chunks).  After the moe engine:
   phase 3 on each in bf16 (4 slots, kv_len 2048, ``SSM_MAX_NEW`` tokens
   a request; mamba2 on phase 3's six prompts, 257 among them, which the
   SSD scans in 257 one-token chunks, recurrentgemma on the first four),
   every prompt prefilled at its exact length.
16. Supervisor phase (after phase 13, once phase 11's checkpoints are
   deleted; ``check_disk`` first): ``train/elastic.Supervisor`` on
   qwen3-0.6b at full width cut to ``CUT_LAYERS`` = 7, --attn pallas,
   batch 8 x 2048, phase 5's seed and lr (the supervisor's warmup-cosine
   schedule), fp32 checkpoints (about 5.1 GB each, in the checkpoints'
   temporary directory, deleted after): (a) the oracle, ``SUP_STEPS``
   steps, no checkpoint dir; (b) the same with async checkpoints every
   ``SUP_EVERY`` steps and a death injected at step ``SUP_DIE``: one
   restart from the newest committed checkpoint (the one in flight at the
   death is abandoned), every loss bit-identical to the oracle's, or, if
   the first attempt's steps (the oracle's steps run again from the same
   seed) differ from the oracle's, each replayed loss within that spread;
   prints each write's seconds, each ``submit`` stall, the steps
   overlapped, step p50 with a write in flight against none, the
   checkpoint resumed from, the restore seconds, the time to recover
   (from the death to the end of the first replayed step) and the peak
   memory against the oracle's; (c) a live reshard world 1 -> 1 x 2 at
   step 2 -> world 1 at step 4 (the two ranks share the card over gloo,
   the state handed over in shared host memory), no checkpoint dir: steps
   0-1 bit-identical to the oracle's, every loss within ``SUP_REL``, each
   reshard's seconds printed.  (b) and (c) count as paths of B1-B7, their
   launches every step's ``step_launches``.

Every phase prints its seconds. The kernel phase also holds B1-B5 at the
knobs' shapes and widths (``knob_kernel_phase``): the INT8 qgZ chain of
a 2 x 2 rank at a layer group, B5 at N = 4 (the 2 x 2 x 2 inter hop),
the 1-hop's B1 on (4, L) INT4 slices and its B5 over 4 contributions,
and B5 with ``init`` (the quantized ring's dequantize-and-add), each
bit-identical and timed.

The line before the last is the kernels' JSON record (every kernel: its
launches on each path — B1, B2 and B8 on ``serve_paged``,
``serve_spec``, ``serve_sharded`` and ``serve_sharded_paged`` too —, its
error against the plain version, its time, the plain version's, its
bound and, for B6/B7, SDPA's; B6/B7 at hd 256 as
``flash_fwd_hd256``/``flash_bwd_hd256``, the same wrappers and counters
on the gemma3 path; at GQA 8 as ``flash_fwd_gqa8``/``flash_bwd_gqa8``
and B8 at K 8192 as ``dequant_matmul_k8192`` on the qwen2-vl paths;
at deepseek-moe-16b's shape as ``flash_fwd_moe``/``flash_bwd_moe`` and
B8 at K 2048 as ``dequant_matmul_k2048`` on the MoE paths, ``train_moe``,
``train_moe_sync`` and ``serve_moe``; at recurrentgemma-2b's (GQA 10
under the window) as ``flash_fwd_recurrentgemma``/``flash_bwd_recurrentgemma``
on ``train_recurrentgemma``, B8 at its head and mamba2-130m's as
``dequant_matmul_recurrentgemma`` and ``dequant_matmul_mamba2`` on
``serve_recurrentgemma`` and ``serve_mamba2``; B1-B5's records carry
qwen2-vl's, deepseek-moe-16b's, mamba2-130m's and recurrentgemma-2b's
group shapes in their extras); the
whole run's seconds come before it; the last line is ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import itertools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.core.quant import QuantConfig  # noqa: E402
from repro_torch.core.zeropp import (ZeroConfig,  # noqa: E402
                                     comm_volume_per_step)
from repro_torch.kernels import dequant_matmul as dm  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused_dequant_reduce_quant as fq  # noqa: E402
from repro_torch.kernels import platform, ref  # noqa: E402
from repro_torch.kernels import quant_block as qb  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.obs.metrics import Registry, set_registry  # noqa: E402
from repro_torch.obs.report import overhead_gate  # noqa: E402
from repro_torch.obs.trace import Tracer, annotate, get_tracer  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.testing import flash_bars  # noqa: E402
from repro_torch.testing.quant_edges import (  # noqa: E402
    B8_EDGE_SCALES, dequant_matmul_close, dequant_matmul_edges, edge_rows,
    same_bits)
from repro_torch.serve import ServeEngine, steps  # noqa: E402
from repro_torch.train.policy import make_policy  # noqa: E402
from repro_torch.train.trainer import build_train_step  # noqa: E402

HBM_BYTES_S = 3.35e12          # H100 SXM rated memory bandwidth
F32_OPS_S = 67e12              # fp32 outside the tensor cores
BF16_OPS_S = 989e12            # bf16 dense tensor-core peak
FLUSH_BYTES = 256 << 20        # > 50 MB L2: every timed launch starts cold

PROMPTS = (7, 33, 120, 257, 600, 1500)
MAX_NEW = 32
N_SLOTS, KV_LEN = 4, 2048
# the paged serving phase (after phase 3, on its model, params and
# prompts): the page size (the chunk is the engine's default, 2 pages);
# the prefix wave, PREFIX_LEN shared tokens and a suffix of its own for
# each prompt, PREFIX_NEW tokens each; speculative decoding of the first
# N_SLOTS prompts, SPEC_TOKENS drafts a round, self-drafted and by
# qwen3-0.6b's widths at DRAFT_LAYERS layers
PAGE_SIZE = 16
PAGED_CHUNK = min(KV_LEN, 2 * PAGE_SIZE)       # the engine's default chunk
PREFIX_LEN, PREFIX_SUFFIXES, PREFIX_NEW = 512, (40, 120, 200), 8
SPEC_TOKENS, DRAFT_LAYERS = 4, 4
# first-token logits, engine (bucket-padded prefill inside a batch of
# requests) vs the request's own unpadded prefill: both bf16 end to end
# through 28 layers, different sequence lengths (and, for the 1500-token
# prompt, the chunked vs the dense attention path), so the rounding of
# every activation differs; logits are ~N(0, 1) at this init
LOGIT_ATOL = 0.25
# decode logits, engine (one batched step over all slots) vs the request
# alone at the same position, fed the engine's own tokens: bf16 again, and
# cuBLAS picks its GEMM kernel by the batch's row count, so the summation
# order differs between M = 4 and M = 1
DECODE_ATOL = 0.25
# flat group sizes of qwen3-0.6b on the training path: one layer group,
# the embedding, one unembedding chunk and the head norm
LAYER_N = 15_730_944
PATH_NS = (LAYER_N, 155_582_464, 38_895_616, 1024)
REORDER_SHAPE = (2, 8, 1_966_336)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 8, 2048, 8, 3e-4
# the training path's attention: (B, S, H, K, hd) of qwen3-0.6b at 8 x 2048
FLASH_SHAPE = (8, 2048, 16, 8, 128)
# the fp32 checks of the flash pair, at the reference's own bars
FLASH_F32_SHAPE = (1, 1024, 16, 8, 128)
FLASH_WINDOW, FLASH_SOFTCAP = 300, 30.0
# bf16 cases the path shape does not reach: (B, Sq, S, H, K, hd, causal,
# window, softcap)
FLASH_BF16_CASES = (
    (1, 1024, 1024, 16, 8, 128, True, FLASH_WINDOW, FLASH_SOFTCAP),
    (1, 1024, 1024, 16, 8, 128, False, 0, 0.0),     # non-causal
    (1, 512, 1024, 16, 8, 128, True, 0, 0.0),       # Sq < S
    (1, 1024, 1024, 16, 16, 16, True, 0, 0.0),      # hd 16, GQA 1
    (1, 1024, 1024, 16, 4, 64, True, 0, 0.0),       # hd 64, GQA 4
    (1, 1024, 1024, 24, 2, 128, True, 0, 0.0),      # starcoder2-3b: GQA 12
    (1, 1024, 1024, 32, 32, 64, True, 0, 0.0),      # musicgen-large: MHA
)
FLASH_TILE = fa.TILE          # the kernels' q and kv tile
# gemma3-4b (head dim 256, 5 local : 1 global): full width cut to 8 layers
# (one period and a rem group of 2 local layers; 34 layers' fp32 state
# would not fit the card at world 1); its attention at batch 2 x 4096
GEMMA_LAYERS = 8
GEMMA_WINDOW = 1024
GEMMA_FLASH_SHAPE = (2, 4096, 8, 4, 256)
GEMMA_F32_SHAPE = (1, 1024, 8, 4, 256)
GEMMA_TRAIN_BATCH, GEMMA_TRAIN_SEQ, GEMMA_TRAIN_STEPS = 2, 4096, 6
GEMMA_PARITY_SEQ = 2048
# the last two prompts are longer than the window: their rings wrap at
# prefill
GEMMA_PROMPTS = (7, 300, 1100, 1500)
# qwen2-vl-72b (QKV bias, M-RoPE, embedding inputs; 64 query heads over 8
# KV heads of 128, d 8192, d_ff 29,568, vocab 152,064): full width cut to
# QWEN2VL_LAYERS layers, 877,684,736 parameters each, and the
# 1,245,708,288-element unembedding (no embedding): 3.0 B parameters,
# 48.0 GB of fp32 master, gradient and moments at world 1.  Its attention
# at the training batch (4 x 2048); the parity step at 1 layer, a vocabulary
# of 4,096 and 1 x 512; serving: prefill(P) + n decode steps against
# prefill(P + n) (the reference's consistency check, relative bar 2e-2,
# checks.py:666), then a bf16 decode step timed at QWEN2VL_DECODE_ROWS rows
QWEN2VL_LAYERS = 2
QWEN2VL_FLASH_SHAPE = (4, 2048, 64, 8, 128)
QWEN2VL_TRAIN_BATCH, QWEN2VL_TRAIN_SEQ, QWEN2VL_TRAIN_STEPS = 4, 2048, 4
QWEN2VL_PARITY_VOCAB, QWEN2VL_PARITY_SEQ = 4096, 512
QWEN2VL_PROMPT, QWEN2VL_EXTRA, QWEN2VL_SERVE_REL = 124, 4, 2e-2
QWEN2VL_DECODE_ROWS, QWEN2VL_DECODE_STEPS = 4, 8
# deepseek-moe-16b (d 2048, 16/16 heads of 128, 64 routed experts top-6 in
# 4 chunks of 16, 2 shared, moe_ff 1408, vocab 102,400): full width cut to
# MOE_LAYERS of its 28 layers, 587.9 M parameters each (an expert chunk
# 138,412,032), and the 419.4 M of embedding and unembedding: 2.77 B
# parameters, 44 GB of fp32 master, moments and gradients at world 1.
# Training at 4 x 2048 (the expert chunks through their ring, routing-ahead
# and the hpZ recompute), MOE_SYNC_STEPS of the synchronous schedule held
# bit for bit against it; its attention; the parity step at reduced width
# (2 x 512 under --attn pallas); the slab engine on phase 3's first four
# prompts, MOE_MAX_NEW tokens each
MOE_LAYERS = 4
MOE_FLASH_SHAPE = (4, 2048, 16, 16, 128)
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = 4, 2048, 4
MOE_SYNC_STEPS = 2
MOE_PROMPTS, MOE_MAX_NEW = PROMPTS[:4], 16
MOE_PARITY_ROWS, MOE_PARITY_SEQ = 2, 512
# mamba2-130m at full width and depth, recurrentgemma-2b at full width cut
# to RG_LAYERS (26 layers' fp32 state, 3.55 B parameters x 16 B, is 56.8
# GB before activations): training (rows, seq, steps), the parity step
# (layers, rows, seq; vocab 8192 in 4 chunks), the serving prompts, and
# recurrentgemma's attention at its training batch (GQA 10 under the
# window)
RG_LAYERS = 8
SSM_TRAIN = {"mamba2": (8, 2048, 4), "recurrentgemma": (2, 4096, 3)}
SSM_PARITY = {"mamba2": (2, 2, 512), "recurrentgemma": (3, 1, 2048)}
SSM_PROMPTS = {"mamba2": PROMPTS, "recurrentgemma": PROMPTS[:4]}
SSM_MAX_NEW = 16
RG_FLASH_SHAPE, RG_WINDOW = (2, 4096, 10, 1, 256), 2048
# the CPU halves of the parity steps run in a process of their own from
# the script's start, on this many threads, beside the card's phases
PARITY_THREADS, PARITY_TIMEOUT_S = 4, 900
# step-1 losses of the two attention routes: bf16 through 28 layers, with
# kv tiles summed in other orders (64-wide vs 1024-wide chunks)
ROUTE_LOSS_ATOL = 1e-2
# the loss after 8 steps must lie this far below the first step's: half
# the drop an H100 read over these 8 steps (0.2045)
LOSS_DROP = 0.1
# the multi-rank train phase: (Y, X) world, steps; its step-1 loss against
# the world-1 pallas run's (the same global parameters and batch: only the
# per-rank GEMM shapes and the loss's four-way sum differ), and every later
# step's within the reference's ZeRO++-vs-baseline bar (checks.py:361).
# "Falling" is the last step's loss below the first's, as phase 5 reads
# it: on these batches the world-1 loss rises at step 3 (12.4128 ->
# 12.4308 on an H100)
MR_MESH, MR_STEPS = (2, 2), 4
MR_LOSS1_ATOL, MR_REL = 1e-3, 0.05
MR_TIMEOUT_S = 600
# the same world's synchronous schedule (--prefetch 0), held bit for bit
# against the ring's first steps
MR_SYNC_STEPS = 2
# the world-1 serving phases (3 and 3b) and the 2 x 2 x 2 phase run
# qwen3-0.6b at full width cut to CUT_LAYERS, a quarter of its 28 layers,
# to keep the script inside its time: phases 3 and 3b hold every stream
# against the same cut model alone, phase 9 its step-1 loss against a
# world-1 run of the cut model, run here first.  Phase 6, the
# sequence-parallel phase, the knobs and the checkpoints keep the 28
# layers (the sequence-parallel phase's loss did not fall over its 3 steps
# at 7 layers on an H100: 12.4214, 12.3965, 12.4461)
CUT_LAYERS = 7
# the sequence-parallel phase: a global batch of 2 rows on 2 x 2 (the
# sequence over "model", 1,024 tokens a rank), steps
SP_BATCH, SP_STEPS = 2, 3
# its qgZ shapes: a layer group's shard at world 4 (15,731,712 / 4)
MR_L = 3_932_928
# the knob phase: the paper's ablation knobs (ZeroConfig overrides, as
# make_policy keywords) at 2 x 2, KNOB_STEPS steps each in one spawn, each
# held to the reference projection's MiB a rank a step (qwen3-0.6b at
# prefetch 0).  Their step-1 losses: the three knobs that change only the
# backward (qgZ's format and hops, hpZ's group) run the same forward as
# phase 6, so their step-1 loss must equal phase 6's bit for bit; the
# non-blocked qwZ gather changes the forward's weights (one scale a shard
# instead of one a block of 256), so its step-1 loss is held to phase 6's
# step-1 bar, MR_LOSS1_ATOL of phase 6's.  Every knob's step 2 is held to
# the same 1e-3 of phase 6's step 2: the H100 read at most 8.4e-4 (the
# non-blocked gather; INT8 qgZ 4.7e-4, the 1-hop 1.4e-4, the pod-wide hpZ
# 0), so the bar sits just above what the knobs move the loss by.  The
# non-blocked gather runs in plain PyTorch on the card, so each of its
# ranks also holds its gather of a layer group, bit for bit, against
# quantize_global / dequantize_global of every rank's shard on the host.
KNOB_STEPS = 2
KNOBS = {"qgz_1hop": dict(qgz_2hop=False), "qgz_int8": dict(qgz_bits=8),
         "qwz_nonblocked": dict(qwz_blocked=False),
         "hpz_world": dict(hpz_axes=("data", "model"))}
KNOB_MIB = {
    "qgz_1hop": {"zero.qwz_gather": 546.025, "zero.hpz_gather": 716.833,
                 "zero.qgz_reduce1hop": 277.213},
    "qgz_int8": {"zero.qwz_gather": 546.025, "zero.hpz_gather": 716.833,
                 "zero.qgz_reduce": 546.025},
    "qwz_nonblocked": {"zero.qwz_gather": 537.625,
                       "zero.hpz_gather": 716.833,
                       "zero.qgz_reduce": 277.213},
    "hpz_world": {"zero.qwz_gather": 546.025, "zero.hpz_gather": 1075.25,
                  "zero.qgz_reduce": 277.213}}
# the sharded serving phase (after phase 11, booted from its world-1 INT8
# checkpoint): qwen3-0.6b at full width on four ranks of a (2, 2) world,
# the slab engine's slots over "data" and each slot's cache sequence over
# "model", then the paged engine (the batch whole, each page's tokens over
# "model"); phase 3's first N_SLOTS prompts, CKPT_MAX_NEW tokens each.  A
# call gathers every flat group once, as the training forward does: the
# same qwZ MiB a rank (KNOB_MIB's 546.025 at 2 x 2); B1's input is a
# rank's shard of each group, MR_L at a layer group
SHARD_MESH, SHARD_TIMEOUT_S = (2, 2), 900
SHARD_QWZ_MIB = 546.025
# the 2 x 2 x 2 ("pod", "data", "model") world: eight ranks on the one
# card, one row each, MP_STEPS at the default config, then MP_HPZ_STEPS
# with the secondary group widened to a pod; the MiB a rank a step of the
# reference projection
MP_MESH, MP_STEPS, MP_HPZ_STEPS = (2, 2, 2), 3, 2
# at CUT_LAYERS (the reference's step_wire_by_label of its comm_events, the
# port's to the byte; at 28 layers 637.055, 716.861, 323.428 and 1075.292)
MP_MIB = {"zero.qwz_gather": 357.05, "zero.hpz_gather": 401.779,
          "zero.qgz_reduce": 181.272}
MP_HPZ_MIB = dict(MP_MIB, **{"zero.hpz_gather": 602.669})
# the checkpoint phase: qwen3-0.6b at full width, --attn pallas, phase 5's
# seed, batch and lr: CKPT_STEPS steps at world 1 through the launcher's
# loop, saved fp32 (--ckpt-every), then saved INT8, both restored; the
# reference's bars: the INT8 directory under CKPT_INT8_SIZE of the fp32
# one (checks.py:545), every restored parameter block within absmax/127 ·
# 0.6 + 1e-8 (:559), the INT8 restore's next two losses within
# CKPT_REL_INT8 of the fp32 restore's (:571); phase 6's synchronous run
# saves after its step 2 and a world of 1 continues from it within
# CKPT_REL_ELASTIC of phase 6's losses (:428).  The engine booted from the
# INT8 checkpoint serves the first N_SLOTS prompts of phase 3,
# CKPT_MAX_NEW tokens each.  The checkpoints' directory must have
# CKPT_FREE_GB free (9.0 GB a fp32 checkpoint of params, m and v)
CKPT_STEPS = 2
CKPT_INT8_SIZE, CKPT_REL_INT8, CKPT_REL_ELASTIC = 0.35, 0.05, 0.02
CKPT_FREE_GB = 25
CKPT_MAX_NEW = 16
# the supervisor phase (after phase 13; CUT_LAYERS, --attn pallas, fp32
# checkpoints of ~5.1 GB): SUP_STEPS steps, a checkpoint every SUP_EVERY,
# a death at SUP_DIE; the live reshard plan and its loss bar (the
# reference's, checks.py:1357)
SUP_STEPS, SUP_EVERY, SUP_DIE = 6, 2, 5
SUP_RESHARD = {2: (1, 2), 4: (1, 1)}
SUP_REL = 2e-2
# phase 5's telemetry-overhead reading: steps with telemetry on
# alternating with as many with it off (printed, not gated: a wall-clock
# bar would fail on noise)
OVERHEAD_STEPS = 4
# the quant kernels by their CUDA function names (profiles, build report)
QUANT_KERNELS = {"quantize_kernel": "B1 quantize",
                 "dequantize_kernel": "B2 dequantize",
                 "quantize_reordered_kernel": "B3 quantize_reordered",
                 "dequant_reduce_quant_kernel": "B4 dequant_reduce_quant",
                 "dequant_reduce_kernel": "B5 dequant_reduce",
                 "dequant_matmul_tc_kernel": "B8 dequant_matmul",
                 "dequant_matmul_kernel": "B8 dequant_matmul"}
# B8: the head's decode and prefill shapes (T rows, one vocab chunk, NB =
# d/256 scale groups), the broadcast layout (NB = 1) and the paged
# engine's row counts; then edge shapes
B8_PATH = ((4, 37984, 1024, 4), (1, 37984, 1024, 4), (3, 4096, 64, 1),
           (2, 37984, 1024, 4),           # a rank's rows, sharded decode
           (32, 37984, 1024, 4),          # a paged prefill chunk
           (20, 37984, 1024, 4),          # a speculative verify, 4 x 5
           (4, 65536, 2560, 10),          # gemma3-4b's head chunk, decode
           (4, 25344, 8192, 32),          # qwen2-vl-72b's, decode (K 8192)
           (4, 25600, 2048, 8),           # deepseek-moe-16b's, decode
           (4, 12570, 768, 3),            # mamba2-130m's, decode
           (4, 64000, 2560, 10))          # recurrentgemma-2b's, decode
B8_EDGE_T = (*range(1, 10), 17)
B8_EDGE_N = (1, 31, 4097)
B8_EDGE_KNB = ((64, 1), (1024, 4), (4096, 16))
# the SASS opcodes the census reports (conversions first)
SASS_OPS = ("I2F", "I2FP", "F2F", "F2FP", "F2I", "FRND", "PRMT", "LOP3",
            "IADD3", "SHF", "IMAD", "FADD", "FMUL", "FFMA", "HMMA", "LDS",
            "LDG")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def device_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def median_ms(fn, flush: torch.Tensor, n: int = 15, warmup: int = 3) -> float:
    """Median device time of fn() over n launches, each from a cold L2."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(bytes_moved: float, ops: float, ops_rate: float):
    return bound_mixed(bytes_moved, ((ops, ops_rate),))


def bound_mixed(bytes_moved: float, work) -> tuple:
    """As :func:`bound`, for work ((ops, rate), ...) of several types."""
    t_b = bytes_moved / HBM_BYTES_S
    t_o = sum(ops / rate for ops, rate in work)
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


# ---------------------------------------------------------------- kernels

def kernel_phase(flush: torch.Tensor) -> dict:
    dev = "cuda"
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    cfg = QuantConfig(bits=8, block_size=256)
    rec = {}

    # B1 / B2 at every flat-shard shape of the paths (all (1, N) rows, bf16,
    # INT8, block 256): the head norm, one layer group, one unembedding
    # chunk (serving feeds it to the dequant-GEMM, training dequantizes
    # it) and the embedding of qwen3-0.6b, then gemma3-4b's groups (up to
    # 671 M elements)
    q_err = d_err = 0.0
    vl_layer, vl_chunk = qwen2_vl_group_sizes()[:2]
    groups = path_group_sizes()
    shard = {}
    for n in (1024, 15_730_944, 38_895_616, 155_582_464,
              *gemma3_group_sizes(), vl_layer, vl_chunk, MR_L,
              *(n for sizes in groups.values() for n in sizes.values())):
        x = torch.randn(1, n, generator=g, device=dev).to(torch.bfloat16)
        p, s = qb.quantize(x, cfg)
        pp, sp = quant.quantize_blockwise(x, cfg)
        err = max((p.int() - pp.int()).abs().max().item(),
                  (s - sp).abs().max().item())
        q_err = max(q_err, err)
        if not (torch.equal(p, pp) and torch.equal(s, sp)):
            fail(f"B1 quantize (1, {n}) differs from its plain version "
                 f"(max abs err {err})")
        del pp, sp
        nb = n // 256
        q_ms = median_ms(lambda: qb.quantize(x, cfg), flush)
        q_plain = median_ms(lambda: quant.quantize_blockwise(x, cfg), flush,
                            n=5)
        q_bound = bound(2 * n + n + 4 * nb, 5 * n, F32_OPS_S)
        print(f"B1 quantize   (1, {n}) bf16->int8: bit-identical; "
              f"kernel {q_ms:.4f} ms, plain {q_plain:.4f} ms, "
              f"bound {q_bound[0]:.4f} ms ({q_bound[1]})", flush=True)
        if n == 15_730_944:   # the per-layer shape: 28 launches per call
            rec["quantize_blockwise"] = dict(ms=q_ms, plain_ms=q_plain,
                                             bound=q_bound, shape=(1, n))
        if n in (vl_layer, vl_chunk):
            rec.setdefault("qwen2_vl", {})[("quantize_blockwise", n)] = dict(
                ms=q_ms, plain_ms=q_plain, bound_ms=q_bound[0],
                shape=[1, n], dtype="bf16")
        for path, key in _path_keys(groups, n):   # the MoE's, the SSMs'
            rec.setdefault(path, {})[("quantize_blockwise",
                                      key + "_bf16")] = dict(
                ms=q_ms, plain_ms=q_plain, bound_ms=q_bound[0],
                shape=[1, n])
        if n == MR_L:     # a rank's layer-group shard at 2 x 2 (serving)
            shard["serve_shard_w4"] = dict(
                ms=q_ms, plain_ms=q_plain, bound_ms=q_bound[0],
                bound_by=q_bound[1], shape=[1, n], dtype="bf16")
        d = qb.dequantize(p, s, cfg, torch.bfloat16)
        dp = quant.dequantize_blockwise(p, s, cfg, torch.bfloat16)
        err = (d.float() - dp.float()).abs().max().item()
        d_err = max(d_err, err)
        if not torch.equal(d, dp):
            fail(f"B2 dequantize (1, {n}) differs from its plain version "
                 f"(max abs err {err})")
        del d, dp
        d_ms = median_ms(lambda: qb.dequantize(p, s, cfg, torch.bfloat16),
                         flush)
        d_plain = median_ms(lambda: quant.dequantize_blockwise(
            p, s, cfg, torch.bfloat16), flush, n=5)
        d_bound = bound(n + 4 * nb + 2 * n, n, F32_OPS_S)
        print(f"B2 dequantize (1, {n}) int8->bf16: bit-identical; "
              f"kernel {d_ms:.4f} ms, plain {d_plain:.4f} ms, "
              f"bound {d_bound[0]:.4f} ms ({d_bound[1]})", flush=True)
        if n == 15_730_944:
            rec["dequantize_blockwise"] = dict(
                ms=d_ms, plain_ms=d_plain, bound=d_bound, shape=(1, n))
        if n in (vl_layer, vl_chunk):
            rec["qwen2_vl"][("dequantize_blockwise", n)] = dict(
                ms=d_ms, plain_ms=d_plain, bound_ms=d_bound[0],
                shape=[1, n])
        for path, key in _path_keys(groups, n):
            rec[path][("dequantize_blockwise", key)] = dict(
                ms=d_ms, plain_ms=d_plain, bound_ms=d_bound[0],
                shape=[1, n])
        del x, p, s

    # small INT4 and stochastic-rounding (u field) cases, bit-identical
    for bits, dtype, with_u in ((4, torch.bfloat16, False),
                                (4, torch.float32, True),
                                (8, torch.bfloat16, True)):
        c = QuantConfig(bits=bits, block_size=256)
        x = torch.randn(3, 8192, generator=g, device=dev).to(dtype)
        u = torch.rand(3, 8192, generator=g, device=dev) if with_u else None
        p, s = qb.quantize(x, c, u)
        pp, sp = quant.quantize_blockwise(x, c, u)
        d = qb.dequantize(p, s, c, torch.bfloat16)
        dp = quant.dequantize_blockwise(p, s, c, torch.bfloat16)
        q_err = max(q_err, (p.int() - pp.int()).abs().max().item(),
                    (s - sp).abs().max().item())
        d_err = max(d_err, (d.float() - dp.float()).abs().max().item())
        if not (torch.equal(p, pp) and torch.equal(s, sp)
                and torch.equal(d, dp)):
            fail(f"B1/B2 INT{bits} {dtype} u={with_u} differ from plain")
    print("B1/B2 INT4, f32 input and u-field cases: bit-identical",
          flush=True)

    rec["quantize_blockwise"].setdefault("extra", {}).update(shard)
    rec["dequant_matmul"] = b8_kernel_phase(g, flush)
    rec["quantize_blockwise"]["max_abs_err"] = q_err
    rec["dequantize_blockwise"]["max_abs_err"] = d_err
    torch.cuda.synchronize()
    return rec


def b8_kernel_phase(g, flush: torch.Tensor) -> dict:
    """B8 at the serving head's shapes (B8_PATH), then at edge inputs
    (``testing.quant_edges.dequant_matmul_edges``), against the plain
    version; two launches must give the same bits.  Times the decode and
    prefill shapes beside the plain version, the bound and cuBLAS's bf16
    product on the already-dequantized weights."""
    dev = "cuda"
    rec, errs = {}, []
    extra = {"library_call": "torch.matmul of bf16 x and the weights "
                             "dequantized to bf16 beforehand (cuBLAS), a "
                             "yardstick the port never calls"}
    for T, N, K, NB in B8_PATH:
        x = torch.randn(T, K, generator=g, device=dev).to(torch.bfloat16)
        w = torch.randint(-127, 128, (N, K), generator=g, device=dev,
                          dtype=torch.int8)
        sc = torch.rand(N, NB, generator=g, device=dev) * 0.01
        before = platform.LAUNCHES["dequant_matmul"]
        out = dm.dequant_matmul(x, w, sc)
        n_launch = platform.LAUNCHES["dequant_matmul"] - before
        want = ref.dequant_matmul_ref(x, w, sc)
        if not torch.isfinite(out).all():
            fail("B8 produced non-finite values")
        # the tensor-core route: one launch per 8 rows of x, per 1,024 of K
        if n_launch != -(-T // 8) * -(-K // 1024):
            fail(f"B8 T={T} K={K}: {n_launch} launches counted")
        err = (out - want).abs().max().item()
        tol = 1e-5 * want.abs().max().item()
        if not torch.allclose(out, want, rtol=1e-5, atol=tol):
            fail(f"B8 T={T} N={N} K={K} NB={NB}: max err {err} > tol")
        if not same_bits(dm.dequant_matmul(x, w, sc), out):
            fail(f"B8 T={T} N={N} K={K} NB={NB}: two launches differ")
        errs.append(err)
        line = f"B8 dequant_matmul T={T} N={N} K={K} NB={NB}: max abs err " \
               f"{err:.3e} (tol rtol 1e-5, atol {tol:.3e}), two calls " \
               f"bit-identical, {n_launch} launches a call"
        if NB > 1:
            ms = median_ms(lambda: dm.dequant_matmul(x, w, sc), flush)
            plain = median_ms(lambda: ref.dequant_matmul_ref(x, w, sc),
                              flush, n=5)
            b8 = bound(N * K + 4 * N * NB + 2 * T * K + 4 * T * N,
                       2 * T * N * K, BF16_OPS_S)
            # the yardstick: cuBLAS on weights already dequantized to bf16
            # (it reads them at 2 bytes each, twice B8's weight bytes)
            wbf = (w.reshape(N, NB, K // NB).float() * sc.unsqueeze(-1)
                   ).reshape(N, K).to(torch.bfloat16)
            lib = median_ms(lambda: x @ wbf.T, flush)
            del wbf
            line += f"; kernel {ms:.4f} ms ({100 * b8[0] / ms:.1f}% of the " \
                    f"bound, {(N * K + 4 * N * NB) / ms / 1e6:.1f} GB/s of " \
                    f"weights and scales), plain {plain:.4f} ms, bound " \
                    f"{b8[0]:.4f} ms ({b8[1]}), cuBLAS bf16 x @ W_bf16.T on " \
                    f"dequantized weights {lib:.4f} ms"
            if (T, N, K) == (4, 65536, 2560):   # gemma3-4b's head, beside it
                extra["gemma3_t4"] = dict(ms=ms, plain_ms=plain,
                                          bound_ms=b8[0], library_ms=lib,
                                          shape=[T, N, K, NB])
            elif (T, K) == (4, 8192):  # qwen2-vl-72b's head (K 8192)
                extra["qwen2_vl_t4"] = dict(
                    ms=ms, plain_ms=plain, bound_ms=b8[0], bound_by=b8[1],
                    library_ms=lib, shape=[T, N, K, NB], max_abs_err=err)
            elif (T, K) == (4, 2048):  # deepseek-moe-16b's head (K 2048)
                extra["deepseek_moe_t4"] = dict(
                    ms=ms, plain_ms=plain, bound_ms=b8[0], bound_by=b8[1],
                    library_ms=lib, shape=[T, N, K, NB], max_abs_err=err)
            elif (T, K) == (4, 768) or N == 64000:   # the SSM phase's heads
                key = "mamba2_t4" if K == 768 else "recurrentgemma_t4"
                extra[key] = dict(
                    ms=ms, plain_ms=plain, bound_ms=b8[0], bound_by=b8[1],
                    library_ms=lib, shape=[T, N, K, NB], max_abs_err=err)
            elif T == 4:              # the decode step's: the record's
                rec.update(ms=ms, plain_ms=plain, bound=b8,
                           shape=(T, N, K, NB), library_ms=lib)
                # one 16-row tile alone (one warp's dependent steps: the
                # latency under every warp's tile) and a PyTorch read of
                # W's bytes
                one = median_ms(lambda: dm.dequant_matmul(x, w[:16], sc[:16]),
                                flush)
                read = median_ms(lambda: w.view(torch.float32).sum(), flush)
                extra.update(one_tile_ms=one, read_w_ms=read)
                line += f"; one 16-row tile {one:.4f} ms; torch sum over W's " \
                        f"{N * K:,} bytes (read once) {read:.4f} ms"
            else:   # prefill's (T 1), a paged chunk's (32), a verify's (20)
                extra[f"t{T}"] = dict(ms=ms, plain_ms=plain, bound_ms=b8[0],
                                      bound_by=b8[1], library_ms=lib,
                                      shape=[T, N, K, NB], max_abs_err=err,
                                      launches_per_call=n_launch)
        print(line, flush=True)
        del x, w, sc, out, want
    n_edge = 0
    for T, N, (K, NB) in itertools.product(B8_EDGE_T, B8_EDGE_N,
                                           B8_EDGE_KNB):
        for x_dtype, compute in ((torch.bfloat16, torch.bfloat16),
                                 (torch.float32, torch.bfloat16),
                                 (torch.float32, torch.float32)):
            # unrounded, a 3.4e38 scale gives finite weights whose products
            # overflow in an order-dependent way: left out there
            scales = B8_EDGE_SCALES if compute == torch.bfloat16 else tuple(
                v for v in B8_EDGE_SCALES if v != 3.4e38)
            x, w, sc = dequant_matmul_edges(g, T, N, K, NB, x_dtype, scales)
            out = dm.dequant_matmul(x, w, sc, compute)
            want = ref.dequant_matmul_ref(x, w, sc, compute)
            holds, err, atol = dequant_matmul_close(out, want)
            if not holds:
                fail(f"B8 edge T={T} N={N} K={K} NB={NB} x {x_dtype} compute "
                     f"{compute}: differs from its plain version (max abs "
                     f"err {err}, atol {atol}, NaN {int(out.isnan().sum())} "
                     f"vs {int(want.isnan().sum())}, inf "
                     f"{int(out.isinf().sum())} vs {int(want.isinf().sum())})")
            if not same_bits(dm.dequant_matmul(x, w, sc, compute), out):
                fail(f"B8 edge T={T} N={N} K={K} NB={NB}: two launches differ")
            errs.append(err)
            n_edge += 1
    print(f"B8 edge holds: {n_edge} cases (T {B8_EDGE_T}, N {B8_EDGE_N}, "
          f"(K, NB) {B8_EDGE_KNB}; bf16 x, fp32 x, weights rounded to bf16 or "
          f"not; rows of all -128 and all +-127, scales {B8_EDGE_SCALES}): "
          f"NaN and inf where the plain version has them, finite values "
          f"within rtol 1e-5 / atol 1e-5·max|finite|, two launches "
          f"bit-identical each", flush=True)
    rec.update(max_abs_err=max(errs), extra=extra)
    return rec


def sass_census(name: str, pattern: str) -> None:
    """Print, for each kernel of ``csrc/<name>.cu`` whose mangled name
    matches ``pattern``, its SASS instruction count and the counts of
    SASS_OPS (``cuobjdump -sass`` of the built library)."""
    exe = Path(platform.nvcc()).with_name("cuobjdump")
    r = subprocess.run([str(exe), "-sass", str(platform._lib_path(name))],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        fail(f"cuobjdump -sass {name}: {r.stderr.strip()}")
    for block in re.split(r"\n\s*Function : ", r.stdout)[1:]:
        fn = block.split("\n", 1)[0].strip()
        m = re.search(pattern, fn)
        if not m:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?"
                         r"([A-Z][A-Z0-9]*)", block)
        counts = {op: ops.count(op) for op in SASS_OPS}
        print(f"    SASS {fn[m.start():m.end()]}: {len(ops)} instructions; "
              + ", ".join(f"{op} {n}" for op, n in counts.items()),
              flush=True)


def _err(a, b) -> float:
    """Max abs difference of two tensors, read as integers or floats."""
    if not a.is_floating_point():
        a, b = a.int(), b.int()
    return (a.float() - b.float()).abs().max().item() if a.numel() else 0.0


def _same(name, shape, got, want) -> float:
    """Fail unless the kernel's outputs equal the plain version's bit for
    bit; return the max abs error read from the compared tensors."""
    err = max(_err(g, w) for g, w in zip(got, want))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        fail(f"{name} {shape} differs from its plain version (max abs err "
             f"{err})")
    return err


def qgz_kernel_phase(flush: torch.Tensor) -> dict:
    """B1 on fp32 master shards and the qgZ kernels B3, B4, B5, each at
    every flat group of the training paths (N = 1; qwen3-0.6b's, then
    gemma3-4b's, whose fp32 shards pass 2^31 bytes), B3 at a reordering
    shape, B4/B5 at N = 8, and the chain a rank of the 2 x 2 world runs at
    a layer group (B3 on (2, 2, L), B4 and B5 at N = 2); bit-identical to
    the plain versions."""
    dev = "cuda"
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    c8, c4 = QuantConfig(8, 256), QuantConfig(4, 256)
    rec = {}
    errs = {"quantize_reordered": 0.0, "dequant_reduce_quant": 0.0,
            "dequant_reduce": 0.0}

    def timed(name, n, fn, plain, nbytes, ops):
        ms = median_ms(fn, flush)
        plain_ms = median_ms(plain, flush, n=5)
        b = bound(nbytes, ops, F32_OPS_S)
        print(f"{name} n={n}: bit-identical; kernel {ms:.4f} ms "
              f"({nbytes / ms / 1e6:.1f} GB/s, {100 * b[0] / ms:.1f}% of the "
              f"bound), plain {plain_ms:.4f} ms, bound {b[0]:.4f} ms "
              f"({b[1]})", flush=True)
        return dict(ms=ms, plain_ms=plain_ms, bound=b)

    vl_layer, vl_chunk = qwen2_vl_group_sizes()[:2]
    groups = path_group_sizes()
    for n in (*PATH_NS, *gemma3_group_sizes(), vl_layer, vl_chunk,
              *(n for sizes in groups.values() for n in sizes.values())):
        nb = n // 256
        # B1: the qwZ quantize of an fp32 master shard (training)
        x = torch.randn(1, n, generator=g, device=dev) * 0.02
        b1_err = _same("B1 quantize f32", (1, n), qb.quantize(x, c8),
                       quant.quantize_blockwise(x, c8))
        r = timed("B1 quantize f32->int8", n, lambda: qb.quantize(x, c8),
                  lambda: quant.quantize_blockwise(x, c8),
                  4 * n + n + 4 * nb, 5 * n)
        if n == LAYER_N:
            rec["quantize_blockwise_f32"] = dict(r, shape=(1, n))
        rec.setdefault("quantize_blockwise_f32", {})
        rec["quantize_blockwise_f32"]["max_abs_err"] = max(
            b1_err, rec["quantize_blockwise_f32"].get("max_abs_err", 0.0))
        del x
        # B3: the bf16 gradient of the group, quantized to INT4 (Y = X = 1)
        gr = (torch.randn(1, 1, n, generator=g, device=dev) * 1e-3).to(
            torch.bfloat16)
        p3 = qb.quantize_reordered(gr, c4)
        errs["quantize_reordered"] = max(errs["quantize_reordered"], _same(
            "B3 quantize_reordered", (1, 1, n), p3,
            ref.quantize_reordered_ref(gr, c4)))
        r3 = timed("B3 quantize_reordered bf16->int4", n,
                   lambda: qb.quantize_reordered(gr, c4),
                   lambda: ref.quantize_reordered_ref(gr, c4),
                   2 * n + n // 2 + 4 * nb, 5 * n)
        # what the memory system gives B3's 4:1 stream with no arithmetic:
        # one 8-byte word of every 32-byte sector of the input (so every
        # input byte crosses from memory) into the payload's n/2 bytes
        src = gr.view(torch.int64).reshape(-1)[::4]
        dst = torch.empty(src.shape, dtype=torch.int64, device=dev)
        cp = median_ms(lambda: dst.copy_(src), flush)
        print(f"  copy_ of B3's {2 * n:,} input bytes into {n // 2:,} "
              f"payload bytes: {cp:.4f} ms ({2.5 * n / cp / 1e6:.1f} GB/s), "
              f"{100 * cp / r3['ms']:.1f}% of B3's time", flush=True)
        del gr, src, dst
        # B4 then B5 on that payload, N = 1, as the 2-hop reduce runs them
        pay, sc = p3[0].reshape(1, -1), p3[1].reshape(1, -1)
        p4 = fq.dequant_reduce_quant(pay, sc, c4, c4)
        errs["dequant_reduce_quant"] = max(
            errs["dequant_reduce_quant"],
            _same("B4 dequant_reduce_quant", (1, n), p4,
                  ref.dequant_reduce_quant_ref(pay, sc, c4, c4)))
        r4 = timed("B4 dequant_reduce_quant N=1 int4->int4", n,
                   lambda: fq.dequant_reduce_quant(pay, sc, c4, c4),
                   lambda: ref.dequant_reduce_quant_ref(pay, sc, c4, c4),
                   2 * (n // 2 + 4 * nb), 8 * n)
        # what the memory system gives the same bytes with no arithmetic
        dst = torch.empty_like(pay)
        cp = median_ms(lambda: dst.copy_(pay), flush)
        print(f"  copy_ of B4's {n // 2:,} payload bytes in and out: {cp:.4f} "
              f"ms ({n / cp / 1e6:.1f} GB/s), {100 * cp / r4['ms']:.1f}% of B4's "
              f"time", flush=True)
        del dst
        pay5, sc5 = p4[0].reshape(1, -1), p4[1].reshape(1, -1)
        out = fq.dequant_reduce(pay5, sc5, c4)
        errs["dequant_reduce"] = max(errs["dequant_reduce"], _same(
            "B5 dequant_reduce", (1, n), (out,),
            (ref.dequant_reduce_ref(pay5, sc5, c4),)))
        r5 = timed("B5 dequant_reduce N=1 int4->f32", n,
                   lambda: fq.dequant_reduce(pay5, sc5, c4),
                   lambda: ref.dequant_reduce_ref(pay5, sc5, c4),
                   n // 2 + 4 * nb + 4 * n, 3 * n)
        if n == LAYER_N:
            rec["quantize_reordered"] = dict(r3, shape=(1, 1, n))
            rec["dequant_reduce_quant"] = dict(r4, shape=(1, n // 2))
            rec["dequant_reduce"] = dict(r5, shape=(1, n // 2))
        if n in (vl_layer, vl_chunk):
            vl = rec.setdefault("qwen2_vl", {})
            for name, r_, shape in (
                    ("quantize_blockwise_f32", r, [1, n]),
                    ("quantize_reordered", r3, [1, 1, n]),
                    ("dequant_reduce_quant", r4, [1, n // 2]),
                    ("dequant_reduce", r5, [1, n // 2])):
                vl[(name, n)] = dict(ms=r_["ms"], plain_ms=r_["plain_ms"],
                                     bound_ms=r_["bound"][0], shape=shape)
        for path, key in _path_keys(groups, n):   # the MoE's, the SSMs'
            for name, r_, shape, tag in (
                    ("quantize_blockwise", r, [1, n], "_f32"),
                    ("quantize_reordered", r3, [1, 1, n], ""),
                    ("dequant_reduce_quant", r4, [1, n // 2], ""),
                    ("dequant_reduce", r5, [1, n // 2], "")):
                rec.setdefault(path, {})[(name, key + tag)] = \
                    dict(ms=r_["ms"], plain_ms=r_["plain_ms"],
                         bound_ms=r_["bound"][0], shape=shape)
        del p3, p4, pay, sc, pay5, sc5, out

    # B3 where a wrong index would show: Y, X > 1, with and without a u field
    gr = (torch.randn(*REORDER_SHAPE, generator=g, device=dev) * 1e-3).to(
        torch.bfloat16)
    Y, X, L = REORDER_SHAPE
    u = torch.rand(X, Y, L, generator=g, device=dev)
    for field in (None, u):
        errs["quantize_reordered"] = max(errs["quantize_reordered"], _same(
            "B3 quantize_reordered", REORDER_SHAPE,
            qb.quantize_reordered(gr, c4, field),
            ref.quantize_reordered_ref(gr, c4, field)))
    n = Y * X * L
    timed(f"B3 quantize_reordered {REORDER_SHAPE}", n,
          lambda: qb.quantize_reordered(gr, c4),
          lambda: ref.quantize_reordered_ref(gr, c4),
          2 * n + n // 2 + 4 * (n // 256), 5 * n)
    del gr, u

    # B4 / B5 with N = 8 contributions (the paper's node) at a layer group
    n, N = LAYER_N, 8
    nb = n // 256
    x8 = torch.randn(N, n, generator=g, device=dev) * 1e-3
    pay, sc = quant.quantize_blockwise(x8, c4)
    del x8
    u = torch.rand(n, generator=g, device=dev)
    for field in (None, u):
        errs["dequant_reduce_quant"] = max(
            errs["dequant_reduce_quant"],
            _same("B4 dequant_reduce_quant", (N, n), fq.dequant_reduce_quant(
                pay, sc, c4, c4, field),
                  ref.dequant_reduce_quant_ref(pay, sc, c4, c4, field)))
    errs["dequant_reduce"] = max(errs["dequant_reduce"], _same(
        "B5 dequant_reduce", (N, n), (fq.dequant_reduce(pay, sc, c4),),
        (ref.dequant_reduce_ref(pay, sc, c4),)))
    timed("B4 dequant_reduce_quant N=8", n,
          lambda: fq.dequant_reduce_quant(pay, sc, c4, c4),
          lambda: ref.dequant_reduce_quant_ref(pay, sc, c4, c4),
          N * (n // 2 + 4 * nb) + n // 2 + 4 * nb, (2 * N + 6) * n)
    timed("B5 dequant_reduce N=8", n, lambda: fq.dequant_reduce(pay, sc, c4),
          lambda: ref.dequant_reduce_ref(pay, sc, c4),
          N * (n // 2 + 4 * nb) + 4 * n, (2 * N + 1) * n)
    del pay, sc, u

    # the 2 x 2 world's chain at a layer group, as a rank runs it: B3 on
    # its (Y, X, L) gradient, B4 over the X = 2 contributions it receives,
    # B5 over the Y = 2 of the second hop
    y, x = MR_MESH
    n, m = y * x * MR_L, y * MR_L
    gr = (torch.randn(y, x, MR_L, generator=g, device=dev) * 1e-3).to(
        torch.bfloat16)
    p3 = qb.quantize_reordered(gr, c4)
    errs["quantize_reordered"] = max(errs["quantize_reordered"], _same(
        "B3 quantize_reordered", (y, x, MR_L), p3,
        ref.quantize_reordered_ref(gr, c4)))
    timed(f"B3 quantize_reordered {(y, x, MR_L)}", n,
          lambda: qb.quantize_reordered(gr, c4),
          lambda: ref.quantize_reordered_ref(gr, c4),
          2 * n + n // 2 + 4 * (n // 256), 5 * n)
    pay, sc = p3[0].reshape(x, -1), p3[1].reshape(x, -1)
    p4 = fq.dequant_reduce_quant(pay, sc, c4, c4)
    errs["dequant_reduce_quant"] = max(errs["dequant_reduce_quant"], _same(
        "B4 dequant_reduce_quant", (x, m), p4,
        ref.dequant_reduce_quant_ref(pay, sc, c4, c4)))
    timed(f"B4 dequant_reduce_quant N={x}", m,
          lambda: fq.dequant_reduce_quant(pay, sc, c4, c4),
          lambda: ref.dequant_reduce_quant_ref(pay, sc, c4, c4),
          x * (m // 2 + 4 * (m // 256)) + m // 2 + 4 * (m // 256),
          (2 * x + 6) * m)
    pay5, sc5 = p4[0].reshape(y, -1), p4[1].reshape(y, -1)
    errs["dequant_reduce"] = max(errs["dequant_reduce"], _same(
        "B5 dequant_reduce", (y, MR_L), (fq.dequant_reduce(pay5, sc5, c4),),
        (ref.dequant_reduce_ref(pay5, sc5, c4),)))
    r5 = timed(f"B5 dequant_reduce N={y}", MR_L,
               lambda: fq.dequant_reduce(pay5, sc5, c4),
               lambda: ref.dequant_reduce_ref(pay5, sc5, c4),
               y * (MR_L // 2 + 4 * (MR_L // 256)) + 4 * MR_L,
               (2 * y + 1) * MR_L)
    # what the memory system gives B5's bytes with no arithmetic: a copy_
    # that reads and writes as many bytes as B5 does (its N payloads and
    # scales in, its fp32 sums out), in one launch
    nin = y * (MR_L // 2 + 4 * (MR_L // 256))
    src = torch.empty((nin + 4 * MR_L) // 2, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    cp = median_ms(lambda: dst.copy_(src), flush)
    print(f"  copy_ of B5's N={y} bytes ({nin:,} read, {4 * MR_L:,} "
          f"written: {src.numel():,} bytes in and out): {cp:.4f} ms "
          f"({2 * src.numel() / cp / 1e6:.1f} GB/s), {100 * cp / r5['ms']:.1f}"
          f"% of B5's time", flush=True)
    rec["dequant_reduce"]["extra"] = {"n2_ms": r5["ms"], "n2_copy_ms": cp,
                                      "n2_bound_ms": r5["bound"][0]}
    del gr, p3, pay, sc, p4, pay5, sc5, src, dst
    for k, e in qgz_edge_holds(g).items():
        errs[k] = max(errs[k], e)
    for k, e in errs.items():
        rec[k]["max_abs_err"] = e
    torch.cuda.synchronize()
    return rec


def qgz_edge_holds(g) -> dict:
    """B3 and B4 against their plain versions where the redesigned tiling
    (1,024 elements a warp, 32 a lane) and arithmetic could slip: 1, 3 and
    4,097 quant blocks (a warp or tile part full), every block size, INT4
    and INT8 in and out, fp32 and bf16 inputs, (Y, X) = (1, 1) and (2, 3),
    N in {1, 2, 3, 8, 11} (11 takes the generic loop), with and without a
    u field, an all-zero block, half-way points and their neighbours, and
    raw random payload bytes (nibble 0x8, byte -128).  Bit-identical."""
    errs = {"quantize_reordered": 0.0, "dequant_reduce_quant": 0.0}
    n_b3 = n_b4 = 0
    for block in qb._QUANT_BLOCKS:
        for nb in (1, 3, 4097):
            L = nb * block
            for (Y, X), bits, dtype in itertools.product(
                    ((1, 1), (2, 3)), (4, 8), (torch.float32, torch.bfloat16)):
                if nb == 4097 and (Y, X) != (1, 1):
                    continue
                cfg = QuantConfig(bits, block)
                x = edge_rows(g, Y * X, L, block, bits, dtype).reshape(
                    Y, X, L)
                u = torch.rand(X, Y, L, generator=g, device="cuda")
                for field in (None, u):
                    errs["quantize_reordered"] = max(
                        errs["quantize_reordered"],
                        _same("B3 edge", (Y, X, L, block, bits, dtype,
                                          field is not None),
                              qb.quantize_reordered(x, cfg, field),
                              ref.quantize_reordered_ref(x, cfg, field)))
                    n_b3 += 1
        for N, bits_in, bits_out in itertools.product(
                (1, 2, 3, 8, 11), (4, 8), (4, 8)):
            for nb in (1, 3, 4097):
                if nb == 4097 and (bits_in, bits_out) != (4, 4):
                    continue
                C = nb * block
                cin, cout = QuantConfig(bits_in, block), QuantConfig(
                    bits_out, block)
                quantized = quant.quantize_blockwise(
                    edge_rows(g, N, C, block, bits_in, torch.float32), cin)
                raw = (torch.randint(-128, 128, quantized[0].shape,
                                     generator=g, device="cuda",
                                     dtype=torch.int8),
                       torch.rand(quantized[1].shape, generator=g,
                                  device="cuda"))
                u = torch.rand(C, generator=g, device="cuda")
                for (p, sc), field in itertools.product((quantized, raw),
                                                        (None, u)):
                    errs["dequant_reduce_quant"] = max(
                        errs["dequant_reduce_quant"],
                        _same("B4 edge", (N, C, block, bits_in, bits_out,
                                          field is not None),
                              fq.dequant_reduce_quant(p, sc, cin, cout,
                                                      field),
                              ref.dequant_reduce_quant_ref(p, sc, cin, cout,
                                                           field)))
                    n_b4 += 1
    print(f"B3/B4 edge holds: {n_b3} B3 and {n_b4} B4 launches "
          f"bit-identical (1, 3 and 4097 blocks, blocks "
          f"{qb._QUANT_BLOCKS}, N 1/2/3/8/11, INT4/INT8, fp32/bf16, u "
          f"fields, zero, half-way and raw-payload inputs)", flush=True)
    return errs


def knob_kernel_phase(flush: torch.Tensor) -> dict:
    """B1-B5 at the shapes and bit widths the knobs and the 2 x 2 x 2
    world give them, each bit-identical to its plain version and timed
    (median of 15, L2 flushed) beside its bound: the INT8 qgZ chain of a
    2 x 2 rank at a layer group (B3 on (2, 2, L) INT8, B4 and B5 at N =
    2); B5 at N = 4, the 2 x 2 x 2 world's inter hop at a layer group;
    the 1-hop at 2 x 2 (B1 on its (4, L) INT4 slices of the bf16
    gradient, B5 over the 4 contributions: the reference's sum compiles
    to B5's FMA chain); and B5 with ``init``, the quantized ring's
    dequantize-and-add, at the edge shapes and a layer group.  Returns
    {kernel: extra record keys}."""
    dev = "cuda"
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    c8, c4 = QuantConfig(8, 256), QuantConfig(4, 256)
    out = {k: {} for k in ("quantize_blockwise", "quantize_reordered",
                           "dequant_reduce_quant", "dequant_reduce")}
    errs = {k: 0.0 for k in out}

    def hold(name, key, shape, got, want, fn, plain, nbytes, ops):
        errs[name] = max(errs[name], _same(key, shape, got, want))
        ms = median_ms(fn, flush)
        plain_ms = median_ms(plain, flush, n=5)
        b = bound(nbytes, ops, F32_OPS_S)
        print(f"{key} {shape}: bit-identical; kernel {ms:.4f} ms "
              f"({100 * b[0] / ms:.1f}% of the bound), plain {plain_ms:.4f} "
              f"ms, bound {b[0]:.4f} ms ({b[1]})", flush=True)
        return ms, b[0]

    def record(name, tag, ms_bound):
        out[name][f"{tag}_ms"], out[name][f"{tag}_bound_ms"] = ms_bound

    # the INT8 chain at the 2 x 2 world's layer group
    y, x = MR_MESH
    n, m = y * x * MR_L, y * MR_L
    gr = (torch.randn(y, x, MR_L, generator=g, device=dev) * 1e-3).to(
        torch.bfloat16)
    p3 = qb.quantize_reordered(gr, c8)
    record("quantize_reordered", "int8_2x2", hold(
        "quantize_reordered", "B3 quantize_reordered INT8", (y, x, MR_L), p3,
        ref.quantize_reordered_ref(gr, c8),
        lambda: qb.quantize_reordered(gr, c8),
        lambda: ref.quantize_reordered_ref(gr, c8),
        2 * n + n + 4 * (n // 256), 5 * n))
    pay, sc = p3[0].reshape(x, -1), p3[1].reshape(x, -1)
    p4 = fq.dequant_reduce_quant(pay, sc, c8, c8)
    record("dequant_reduce_quant", "int8_n2", hold(
        "dequant_reduce_quant", "B4 dequant_reduce_quant INT8", (x, m), p4,
        ref.dequant_reduce_quant_ref(pay, sc, c8, c8),
        lambda: fq.dequant_reduce_quant(pay, sc, c8, c8),
        lambda: ref.dequant_reduce_quant_ref(pay, sc, c8, c8),
        x * (m + 4 * (m // 256)) + m + 4 * (m // 256), (2 * x + 6) * m))
    pay5, sc5 = p4[0].reshape(y, -1), p4[1].reshape(y, -1)
    record("dequant_reduce", "int8_n2", hold(
        "dequant_reduce", "B5 dequant_reduce INT8", (y, MR_L),
        (fq.dequant_reduce(pay5, sc5, c8),),
        (ref.dequant_reduce_ref(pay5, sc5, c8),),
        lambda: fq.dequant_reduce(pay5, sc5, c8),
        lambda: ref.dequant_reduce_ref(pay5, sc5, c8),
        y * (MR_L + 4 * (MR_L // 256)) + 4 * MR_L, (2 * y + 1) * MR_L))
    # the same B5 on freshly quantized INT8 inputs of the same shape
    pay5, sc5 = quant.quantize_blockwise(
        torch.randn(y, MR_L, generator=g, device=dev) * 1e-3, c8)
    record("dequant_reduce", "int8_n2_fresh", hold(
        "dequant_reduce", "B5 dequant_reduce INT8, quantized inputs",
        (y, MR_L), (fq.dequant_reduce(pay5, sc5, c8),),
        (ref.dequant_reduce_ref(pay5, sc5, c8),),
        lambda: fq.dequant_reduce(pay5, sc5, c8),
        lambda: ref.dequant_reduce_ref(pay5, sc5, c8),
        y * (MR_L + 4 * (MR_L // 256)) + 4 * MR_L, (2 * y + 1) * MR_L))
    del gr, p3, pay, sc, p4, pay5, sc5
    # B5 at N = 4: the 2 x 2 x 2 world's inter hop at a layer group
    world = int(np.prod(MP_MESH))
    L8 = Model(get_config("qwen3-0.6b"), ZeroConfig(), world=world,
               device="cpu").param_shapes()["blocks"][1] // world
    N = world // MP_MESH[-1]
    pay, sc = quant.quantize_blockwise(
        torch.randn(N, L8, generator=g, device=dev) * 1e-3, c4)
    record("dequant_reduce", "n4_2x2x2", hold(
        "dequant_reduce", "B5 dequant_reduce N=4", (N, L8),
        (fq.dequant_reduce(pay, sc, c4),), (ref.dequant_reduce_ref(
            pay, sc, c4),),
        lambda: fq.dequant_reduce(pay, sc, c4),
        lambda: ref.dequant_reduce_ref(pay, sc, c4),
        N * (L8 // 2 + 4 * (L8 // 256)) + 4 * L8, (2 * N + 1) * L8))
    del pay, sc
    # the 1-hop at 2 x 2: B1 on the (W, L) slices, B5 over W contributions
    W = y * x
    gr = (torch.randn(W, MR_L, generator=g, device=dev) * 1e-3).to(
        torch.bfloat16)
    p1 = qb.quantize(gr, c4)
    record("quantize_blockwise", "onehop_4xL", hold(
        "quantize_blockwise", "B1 quantize 1-hop bf16->int4", (W, MR_L), p1,
        quant.quantize_blockwise(gr, c4), lambda: qb.quantize(gr, c4),
        lambda: quant.quantize_blockwise(gr, c4),
        2 * W * MR_L + W * MR_L // 2 + 4 * (W * MR_L // 256),
        5 * W * MR_L))
    pay, sc = p1
    record("dequant_reduce", "onehop_n4", hold(
        "dequant_reduce", "B5 dequant_reduce 1-hop N=4", (W, MR_L),
        (fq.dequant_reduce(pay, sc, c4),), (ref.dequant_reduce_ref(
            pay, sc, c4),),
        lambda: fq.dequant_reduce(pay, sc, c4),
        lambda: ref.dequant_reduce_ref(pay, sc, c4),
        W * (MR_L // 2 + 4 * (MR_L // 256)) + 4 * MR_L,
        (2 * W + 1) * MR_L))
    del gr, p1, pay, sc
    # B5 with init (the ring's hop: one contribution added to an fp32
    # slice in one FMA), every block size, INT4 and INT8, edge rows
    n_init = 0
    for block in qb._QUANT_BLOCKS:
        for nb, bits, N in itertools.product((1, 3, 4097), (4, 8), (1, 3)):
            cfg = QuantConfig(bits, block)
            C = nb * block
            p, sc = quant.quantize_blockwise(
                edge_rows(g, N, C, block, bits, torch.float32), cfg)
            init = torch.randn(C, generator=g, device=dev)
            errs["dequant_reduce"] = max(errs["dequant_reduce"], _same(
                "B5 dequant_reduce init", (N, C, block, bits),
                (fq.dequant_reduce(p, sc, cfg, init),),
                (ref.dequant_reduce_ref(p, sc, cfg, init),)))
            n_init += 1
    pay, sc = quant.quantize_blockwise(
        torch.randn(1, MR_L, generator=g, device=dev) * 1e-3, c4)
    init = torch.randn(MR_L, generator=g, device=dev) * 1e-3
    record("dequant_reduce", "ring_hop", hold(
        "dequant_reduce", "B5 dequant_reduce init (ring hop)", (1, MR_L),
        (fq.dequant_reduce(pay, sc, c4, init),),
        (ref.dequant_reduce_ref(pay, sc, c4, init),),
        lambda: fq.dequant_reduce(pay, sc, c4, init),
        lambda: ref.dequant_reduce_ref(pay, sc, c4, init),
        MR_L // 2 + 4 * (MR_L // 256) + 8 * MR_L, 3 * MR_L))
    print(f"B5 with init: {n_init} edge launches bit-identical (1, 3 and "
          f"4097 blocks, blocks {qb._QUANT_BLOCKS}, INT4/INT8, N 1 and 3)",
          flush=True)
    for k, e in errs.items():
        out[k]["knob_max_abs_err"] = e
    torch.cuda.synchronize()
    return out


# ------------------------------------------------------------------ flash

def _flash_inputs(g, shape, dtype, Sq=None):
    """q, k, v, dO for (B, S, H, K, hd); q and dO of Sq rows (default S)."""
    B, S, H, K, hd = shape
    return [torch.randn(B, n_s, n, hd, generator=g, device="cuda").to(dtype)
            for n_s, n in ((Sq or S, H), (S, K), (S, K), (Sq or S, H))]


def _max_err(got, want) -> float:
    """Max abs difference of two tensors, in fp32."""
    return (got.float() - want.float()).abs().max().item()


def _causal_pairs(S: int) -> int:
    return S * (S + 1) // 2


def _dropped_tile_reading(q, k, v, want, bar, scale: float) -> tuple:
    """How far out the causal forward of the last q tile moves, in units
    of B6's bar, when its diagonal kv tile is dropped or counted twice:
    the fault a kv loop that ends one tile early, or repeats one, makes.
    Dense fp32 plain attention on those rows, with each key weighted 1, 0
    or 2; returns (max |Δ|/bar dropped, max |Δ|/bar doubled)."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    rows = slice(S - FLASH_TILE, S)
    qg = q[:, rows].float().reshape(B, FLASH_TILE, K, H // K, hd)
    lg = torch.einsum("bqkrd,bskd->bkrqs", qg, k.float()) * scale
    pos = torch.arange(S, device=q.device)
    lg = lg.masked_fill(pos[None, :] > pos[rows, None], ref.NEG_INF)
    p = torch.exp(lg - lg.amax(dim=-1, keepdim=True))
    tile = (pos >= S - FLASH_TILE).float()

    def attend(weight):
        pw = p * weight
        o = torch.einsum("bkrqs,bskd->bqkrd", pw / pw.sum(-1, keepdim=True),
                         v.float())
        return o.reshape(B, FLASH_TILE, H, hd)
    good = attend(torch.ones_like(tile))
    return tuple(((attend(1 + c * tile) - good).abs() / bar[:, rows]).max()
                 .item() for c in (-1.0, 1.0))


def _hold_bf16(tag: str, q, k, v, do, kw: dict):
    """B6/B7 in bf16 (the tensor-core kernels) against their plain
    versions on the same inputs, element by element: out within what the
    two sides' bf16 roundings of p and of out can account for
    (testing/flash_bars.py: 2^-7 of the row's sum p|v|/l plus one ulp), m
    and l within 2e-5 (fp32 sums in another order); dq/dk/dv from the
    kernel's own saved (out, m, l), fp32 inside both (the reference's fp32
    bar, 3e-5) plus one bf16 ulp for the rounding.  Two launches on the
    same inputs must give the same bits (no atomics).  Returns ((out, m,
    l), the plain out, its bar, the forward's and the backward's max abs
    error)."""
    out, m, l = fa.flash_fwd(q, k, v, **kw)
    want = ref.flash_fwd_ref(q, k, v, **kw)
    bar = flash_bars.out_bar(q, k, v, want[0], **kw)
    r_out, e_out = flash_bars.worst(out, want[0], bar)
    if not torch.isfinite(out).all() or r_out > 1:
        fail(f"B6 {tag}: out differs from its plain version beyond its "
             f"per-element bar ({r_out:.3f} x the bar, max abs err {e_out})")
    for name, a, b in (("m", m, want[1]), ("l", l, want[2])):
        if not torch.allclose(a, b, rtol=2e-5, atol=2e-5):
            fail(f"B6 {tag}: {name} differs from its plain version beyond "
                 f"2e-5 (max abs err {_max_err(a, b)})")
    fwd_err = max(e_out, *(_max_err(a, b) for a, b in
                           ((m, want[1]), (l, want[2]))))
    grads = fa.flash_bwd(q, k, v, out, m, l, do, **kw)
    wgrads = ref.flash_bwd_ref(q, k, v, out, m, l, do, **kw)
    bwd_err, bwd_read = 0.0, []
    for name, a, b in zip(("dq", "dk", "dv"), grads, wgrads):
        r, e = flash_bars.worst(a, b, flash_bars.grad_bar(b))
        bwd_err = max(bwd_err, e)
        bwd_read.append(f"{name} {e:.3e} ({r:.3f} x bar)")
        if not torch.isfinite(a).all() or r > 1:
            fail(f"B7 {tag}: {name} differs from its plain version beyond "
                 f"its per-element bar ({r:.3f} x the bar, max abs err {e})")
    del wgrads
    again = fa.flash_fwd(q, k, v, **kw)
    if not all(torch.equal(a, b) for a, b in zip(again, (out, m, l))):
        fail(f"B6 {tag}: two launches on the same inputs differ")
    again = fa.flash_bwd(q, k, v, out, m, l, do, **kw)
    if not all(torch.equal(a, b) for a, b in zip(again, grads)):
        fail(f"B7 {tag}: two launches on the same inputs differ")
    print(f"B6/B7 {tag} bf16: out max abs err {e_out:.3e} ({r_out:.3f} x "
          f"its per-element bar), m/l within 2e-5; B7 max abs err "
          f"{', '.join(bwd_read)}; both bit-identical across two launches",
          flush=True)
    return (out, m, l), want[0], bar, fwd_err, bwd_err


def flash_kernel_phase(flush: torch.Tensor) -> dict:
    """B6/B7 against their plain versions: bf16 (tensor cores) at the
    training path's shape and at small shapes that reach window, softcap,
    non-causal, Sq < S, hd 16/64 and GQA 1/2/4; fp32 (FFMA) at a smaller
    shape (plain causal, and with window and softcap); two launches bit
    for bit; times against the bound and SDPA, and both routes at (1,
    1024)."""
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are on: the plain fp32 versions would not be fp32")
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    rec = {}
    B, S, H, K, hd = FLASH_SHAPE
    q, k, v, do = _flash_inputs(g, FLASH_SHAPE, torch.bfloat16)
    kw = dict(scale=hd ** -0.5, causal=True)
    print("bars: out 2^-7 x (sum p|v|/l + |out|) x 1.01; dq/dk/dv 2^-7 x "
          "1.01 x |grad| + 3e-5 x (1 + |grad|)", flush=True)
    (out, m, l), want, bar, fwd_err, bwd_err = _hold_bf16(
        f"{FLASH_SHAPE} causal", q, k, v, do, kw)
    fault = _dropped_tile_reading(q, k, v, want, bar, kw["scale"])
    del want, bar
    print(f"B6 bar's reach, plain fp32 rows {S - FLASH_TILE}..{S - 1}: the "
          f"diagonal kv tile dropped reads {fault[0]:.2f} x the bar, counted "
          f"twice {fault[1]:.2f} x", flush=True)
    if min(fault) <= 1:
        fail(f"B6's bar would not catch a dropped or doubled kv tile: "
             f"{fault}")
    for Bc, Sq, Sc, Hc, Kc, hdc, causal, window, softcap in FLASH_BF16_CASES:
        cq, ck, cv, cdo = _flash_inputs(g, (Bc, Sc, Hc, Kc, hdc),
                                        torch.bfloat16, Sq=Sq)
        ckw = dict(scale=hdc ** -0.5, causal=causal, window=window,
                   softcap=softcap)
        tag = (f"(B {Bc}, Sq {Sq}, S {Sc}, H {Hc}, K {Kc}, hd {hdc}) "
               f"causal {causal} window {window} softcap {softcap}")
        res = _hold_bf16(tag, cq, ck, cv, cdo, ckw)
        fwd_err, bwd_err = max(fwd_err, res[3]), max(bwd_err, res[4])
        del res, cq, ck, cv, cdo

    # times at the path shape
    pairs = B * H * _causal_pairs(S)
    prod = 2 * hd * pairs                     # one causal product
    qb, kb = B * S * H * hd * 2, B * S * K * hd * 2
    b6 = bound_mixed(2 * qb + 2 * kb + 8 * B * H * S,
                     ((2 * prod, BF16_OPS_S),))
    # B7: QK^T and dO.V^T on bf16 inputs, and dl.K, p^T.dO, dl^T.Q with p
    # and dl as bf16 hi + lo pairs: 2 tensor-core products each
    n_prod = 2 + 3 * 2
    b7_bytes = 4 * qb + 4 * kb + 8 * B * H * S
    b7 = bound_mixed(b7_bytes, ((n_prod * prod, BF16_OPS_S),))
    print(f"B7 bound: max(bytes {b7_bytes:.4g} / {HBM_BYTES_S:.4g} B/s = "
          f"{b7_bytes / HBM_BYTES_S * 1e3:.4f} ms, (2 + 3 x 2) = {n_prod} "
          f"bf16 products x {prod:.4g} FLOP / {BF16_OPS_S:.4g} FLOP/s = "
          f"{n_prod * prod / BF16_OPS_S * 1e3:.4f} ms) = {b7[0]:.4f} ms",
          flush=True)
    f_ms = median_ms(lambda: fa.flash_fwd(q, k, v, **kw), flush)
    f_plain = median_ms(lambda: ref.flash_fwd_ref(q, k, v, **kw), flush, n=5)
    b_ms = median_ms(lambda: fa.flash_bwd(q, k, v, out, m, l, do, **kw),
                     flush)
    b_plain = median_ms(lambda: ref.flash_bwd_ref(q, k, v, out, m, l, do,
                                                  **kw), flush, n=5)
    if f_ms < b6[0] or b_ms < b7[0]:
        fail(f"a flash kernel reads faster than its bound: B6 {f_ms} < "
             f"{b6[0]} or B7 {b_ms} < {b7[0]} ms")
    # the library's causal GQA attention, as a yardstick only: SDPA on
    # (B, heads, S, hd) views; its backward takes p and dS in bf16, the
    # pair's as hi + lo pairs (fp32-level products)
    sq, sk, sv = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    sdo = do.transpose(1, 2)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            sq, sk, sv, is_causal=True, enable_gqa=True)
    with torch.no_grad():
        lib_f = median_ms(sdpa, flush)
    so = sdpa()
    lib_b = median_ms(lambda: torch.autograd.grad(
        so, (sq, sk, sv), sdo, retain_graph=True), flush)
    lib_fb = median_ms(lambda: torch.autograd.grad(
        sdpa(), (sq, sk, sv), sdo), flush)
    del so, sq, sk, sv, sdo
    print(f"B6 flash_fwd {FLASH_SHAPE} bf16 causal: kernel {f_ms:.4f} ms "
          f"({100 * b6[0] / f_ms:.1f} % of its bound), plain {f_plain:.4f} "
          f"ms, bound {b6[0]:.4f} ms ({b6[1]}), SDPA {lib_f:.4f} ms",
          flush=True)
    print(f"B7 flash_bwd {FLASH_SHAPE} bf16 causal: kernel {b_ms:.4f} ms "
          f"({100 * b7[0] / b_ms:.1f} % of its bound; dsum reduction, dq "
          f"kernel, dk/dv kernel), plain {b_plain:.4f} ms, bound "
          f"{b7[0]:.4f} ms ({b7[1]}), SDPA backward {lib_b:.4f} ms (forward "
          f"+ backward {lib_fb:.4f} ms)", flush=True)
    rec["flash_fwd"] = dict(ms=f_ms, plain_ms=f_plain, bound=b6,
                            shape=FLASH_SHAPE, max_abs_err=fwd_err,
                            library_ms=lib_f)
    rec["flash_bwd"] = dict(ms=b_ms, plain_ms=b_plain, bound=b7,
                            shape=FLASH_SHAPE, max_abs_err=bwd_err,
                            library_ms=lib_b)
    del q, k, v, do, out, m, l

    # both routes at (1, 1024), causal: fp32 (FFMA) and bf16 (tensor cores)
    kw = dict(scale=FLASH_F32_SHAPE[-1] ** -0.5, causal=True)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = _flash_inputs(g, FLASH_F32_SHAPE, dtype)
        out, m, l = fa.flash_fwd(q, k, v, **kw)
        t_f = median_ms(lambda: fa.flash_fwd(q, k, v, **kw), flush)
        t_b = median_ms(lambda: fa.flash_bwd(q, k, v, out, m, l, do, **kw),
                        flush)
        name = "f32" if dtype == torch.float32 else "bf16"
        print(f"B6/B7 {FLASH_F32_SHAPE} {name} causal: forward {t_f:.4f} "
              f"ms, backward {t_b:.4f} ms", flush=True)
        rec["flash_fwd"][f"{name}_1024_ms"] = t_f
        rec["flash_bwd"][f"{name}_1024_ms"] = t_b
        del q, k, v, do, out, m, l

    # fp32 at the reference's bars: plain causal, then window + softcap
    for extra in ({}, dict(window=FLASH_WINDOW, softcap=FLASH_SOFTCAP)):
        q, k, v, do = _flash_inputs(g, FLASH_F32_SHAPE, torch.float32)
        kw = dict(scale=FLASH_F32_SHAPE[-1] ** -0.5, causal=True, **extra)
        got = fa.flash_fwd(q, k, v, **kw)
        want = ref.flash_fwd_ref(q, k, v, **kw)
        for name, a, b in zip(("out", "m", "l"), got, want):
            if not torch.allclose(a, b, rtol=2e-5, atol=2e-5):
                fail(f"B6 f32 {extra} {name}: beyond 2e-5 (max abs err "
                     f"{_max_err(a, b)})")
        grads = fa.flash_bwd(q, k, v, *got, do, **kw)
        wgrads = ref.flash_bwd_ref(q, k, v, *got, do, **kw)
        for name, a, b in zip(("dq", "dk", "dv"), grads, wgrads):
            if not torch.allclose(a, b, rtol=3e-5, atol=3e-5):
                fail(f"B7 f32 {extra} {name}: beyond 3e-5 (max abs err "
                     f"{_max_err(a, b)})")
        again = fa.flash_bwd(q, k, v, *got, do, **kw)
        if not all(torch.equal(a, b) for a, b in zip(again, grads)):
            fail(f"B7 f32 {extra}: two launches differ")
        errs = [_max_err(a, b) for a, b in zip((*got, *grads),
                                                     (*want, *wgrads))]
        print(f"B6/B7 {FLASH_F32_SHAPE} f32 causal {extra or ''}: out/m/l "
              f"max abs err {max(errs[:3]):.3e} (rtol/atol 2e-5), dq/dk/dv "
              f"{max(errs[3:]):.3e} (3e-5)", flush=True)
    torch.cuda.synchronize()
    return rec


# ----------------------------------------------------------------- engine

def engine_phase(cfg=None, prompt_lens=PROMPTS, max_new: int = MAX_NEW,
                 margins: bool = False) -> dict:
    """Phase 3 on ``cfg`` (default qwen3-0.6b at full width cut to
    CUT_LAYERS; the gemma3 phase passes its 8-layer stack, the MoE phase
    its cut deepseek-moe-16b) with prompts of ``prompt_lens`` tokens,
    ``max_new`` tokens each; with ``margins`` (MoE) the smallest router
    margin of each request alone is printed, and of the step where a
    stream misses the bar.  Returns the run's launches, and what the paged
    phase reuses: the model, its params, the prompts and the engine's stats."""
    cfg = cfg or cut_config()
    z = ZeroConfig(dp_axes=("model",))            # qwZ on, world 1, bf16
    model = Model(cfg, z, world=1, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    params = model.init_params(g)
    n_params = sum(int(np.prod(s)) for s in model.param_shapes().values())
    print(f"engine: {cfg.name} full width ({cfg.n_layers} layers: "
          f"{model.n_periods} x {model.period}"
          f"{f' + {model.rem_kinds}' if model.rem else ''}, d "
          f"{cfg.d_model}, vocab {cfg.vocab}), {n_params} flat params bf16, "
          f"{model.unemb_chunks} head chunks", flush=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in prompt_lens]

    # warm-up (library load, cuBLAS handles, allocator) outside the count
    warm = ServeEngine(model, params, n_slots=1, kv_len=KV_LEN)
    warm.submit(prompts[0], max_new_tokens=2)
    warm.run(max_steps=10)
    torch.cuda.synchronize()

    cap = Capture()
    eng = ServeEngine(model, params, n_slots=N_SLOTS, kv_len=KV_LEN,
                      observer=cap)
    uids = cap.submit(eng, prompts, max_new)
    torch.cuda.synchronize()
    platform.reset_launches()
    t0 = time.perf_counter()
    res = eng.run(max_steps=1000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(platform.LAUNCHES)

    for u, n in zip(uids, prompt_lens):
        if eng.status[u] != "done" or len(res[u]) != max_new:
            fail(f"request {u} (prompt {n}) did not finish: "
                 f"{eng.status[u]}, {len(res[u])} tokens")
    check_launches("engine", launches, cap, model)
    print(f"engine: {len(uids)} requests done, {cap.count('prefill')} "
          f"prefills + {cap.count('decode')} batched decode steps in "
          f"{wall:.3f} s; launches {launches} (= the sum of each call's "
          f"{per_call_launches(model)})", flush=True)

    # each request alone: raw prefill at its exact length, then decode
    # teacher-forced on the engine's own tokens, so every one of the
    # engine's batched decode steps is held against the same request run
    # alone at the same positions
    holds = []
    for u, p in zip(uids, prompts):
        toks = res[u]
        if margins:
            with Routes() as routes:
                want = teacher_forced(model, params, p, toks)
        else:
            want = teacher_forced(model, params, p, toks)
        h = hold_stream(f"request {u} (prompt {len(p)})",
                        cap.stream(u, len(toks)), want, toks)
        holds.append(h)
        print(f"  request {u} prompt {len(p):5d}: first-token logits max "
              f"abs diff {h['first']:.4f}; teacher-forced decode logits max "
              f"abs diff {h['dec']:.4f}; greedy agreement "
              f"{h['agree']}/{max_new}", flush=True)
        if margins:
            # the router calls alone: per model call one a layer
            per = model.n_periods
            steps_m = [min(routes.margins[i:i + per])
                       for i in range(0, len(routes.margins), per)]
            print(f"    router margins alone: smallest {min(steps_m):.3e}; "
                  f"at the step of the largest logits diff (step "
                  f"{h['worst']}): {steps_m[h['worst']]:.3e}", flush=True)
    check_holds("engine: batched decode", holds)
    profile_decode(steps.build_decode_step(model).fn, params,
                   eng.pool.caches,
                   [len(p) for p in prompts[:N_SLOTS]])
    if model.rem or model.period != ("attn",):
        rings = [c["k"].shape[-3] if "k" in c else
                 f"state {tuple(c['h'].shape[2:])} fp32 + conv "
                 f"{tuple(c['conv'].shape[2:])}"
                 for c in eng.pool.caches["blocks"]]
        print(f"engine: every prompt prefilled at its exact length "
              f"({cap.count('prefill')} prefills); pool cache per block of "
              f"the period {rings} (local rings of the window, recurrent "
              f"states a slot), kv_len {KV_LEN}", flush=True)
    st = eng.stats()
    print(f"engine: first-token logits vs standalone prefill max abs diff "
          f"{max(h['first'] for h in holds):.4f} (bar {LOGIT_ATOL})",
          flush=True)
    print(f"engine: TTFT p50 {st['ttft_ms']['p50']:.2f} ms (p90 "
          f"{st['ttft_ms']['p90']:.2f}), decode {st['tok_per_s']:.1f} tok/s,"
          f" {st['tok_latency_ms']['p50']:.3f} ms per decode step (p50)",
          flush=True)
    del eng, warm
    return {"launches": launches, "model": model, "params": params,
            "prompts": prompts, "stats": st}


class Capture:
    """An engine's observer: ``calls`` is each model call's kind with the
    rows of x it passed through the head (B·T), ``rows[uid][p]`` the fp32
    logits row of the target at the token in position p, from the
    request's last prompt position on (a later verify overwrites a
    rejected round's rows)."""

    def __init__(self):
        self.calls, self.rows, self.lens = [], {}, {}

    def submit(self, eng, prompts, max_new: int) -> list:
        uids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        self.lens.update((u, len(p)) for u, p in zip(uids, prompts))
        return uids

    def __call__(self, kind: str, rows: list, logits: torch.Tensor) -> None:
        self.calls.append((kind, logits.shape[0] * logits.shape[1]))
        if kind.startswith("draft"):
            return
        for uid, r, p in rows:
            last = self.lens[uid] - 1
            js = [last - p] if kind == "prefill" else \
                range(logits.shape[1])
            for j in js:
                if 0 <= j < logits.shape[1] and p + j >= last:
                    self.rows.setdefault(uid, {})[p + j] = \
                        logits[r, j].float().clone()

    def count(self, *kinds: str) -> int:
        return sum(k in kinds for k, _ in self.calls)

    def stream(self, uid: int, n: int) -> list:
        """The rows that produced the request's n tokens, in order."""
        return [self.rows[uid][self.lens[uid] - 1 + j] for j in range(n)]


def per_call_launches(model, rows: int = 1) -> dict:
    """B1, B2 and B8 launches of one serving model call whose head takes
    ``rows`` rows of x: qwZ gathers of the embedding, every layer group (a
    period, and the rem group) and the head norm (quantize + dequantize
    each) and of every unembedding chunk (quantize only, consumed by one
    dequant-GEMM each, which launches once per 8 rows of x and per 1,024
    of K = d_model: csrc/dequant_matmul.cu's kMaxTile and kTcSlab); an
    MoE model also gathers each layer's expert chunks (chunk 0 by the
    routing-ahead gather where the rings are on)."""
    groups = 1 + model.n_periods + int(model.rem > 0) + 1
    if model.is_moe:
        groups += model.n_periods * model.cfg.expert_chunks
    b8 = -(-rows // 8) * -(-model.cfg.d_model // 1024)
    return {"quantize_blockwise": groups + model.unemb_chunks,
            "dequantize_blockwise": groups,
            "dequant_matmul": model.unemb_chunks * b8}


def check_launches(tag: str, launches: dict, cap: Capture, model,
                   dmodel=None) -> None:
    """B1, B2 and B8 launched exactly as the calls ``cap`` saw add up to,
    per call of the target and (kinds ``draft*``) of the drafter."""
    want = {k: 0 for k in per_call_launches(model)}
    for kind, rows in cap.calls:
        m = dmodel if kind.startswith("draft") else model
        for k, n in per_call_launches(m, rows).items():
            want[k] += n
    for k, n in want.items():
        if launches[k] <= 0 or launches[k] != n:
            fail(f"{tag}: {k} launched {launches[k]} times, expected {n} "
                 f"over {len(cap.calls)} model calls")


def teacher_forced(model, params, prompt, toks) -> list:
    """The request alone through the raw slab steps, fed ``toks``: row j is
    the (V,) fp32 logits that predict ``toks[j]`` (the last position of a
    raw prefill of ``prompt``, then one raw decode step per token)."""
    dev = model.device
    ps = steps.build_prefill_step(model, device=dev.type)
    ds = steps.build_decode_step(model, device=dev.type)
    logits, caches = ps.fn(params, {"tokens": torch.from_numpy(
        prompt[None, :]).long().to(dev)})
    rows = [logits[0, -1].float()]
    if not torch.isfinite(rows[0]).all() or \
            rows[0].shape != (model.cfg.vocab,):
        fail("standalone prefill logits bad")
    caches = steps.pad_prefill_caches(model, caches, KV_LEN)
    for j in range(1, len(toks)):
        lg, caches = ds.fn(params, caches,
                           {"tokens": torch.tensor([[toks[j - 1]]],
                                                   device=dev)},
                           torch.tensor([len(prompt) + j - 1], device=dev))
        rows.append(lg[0, -1].float())
    return rows


def hold_stream(tag: str, rows: list, want: list, toks: list) -> dict:
    """Hold an engine's logits rows (row j produced ``toks[j]``) against
    the request alone (``want``): row 0 within LOGIT_ATOL, the later rows
    within DECODE_ATOL; the witness is how far each row lies from the
    alone row one position behind (what a one-position slip would give);
    greedy tokens where the alone top-2 gap exceeds 2·DECODE_ATOL;
    ``worst``: the step of the largest decode difference."""
    err0 = (rows[0] - want[0]).abs().max().item()
    if err0 > LOGIT_ATOL:
        fail(f"{tag}: first-token logits differ from the request alone by "
             f"{err0} > {LOGIT_ATOL}")
    h = {"n": len(toks), "first": err0, "dec": 0.0, "shift": float("inf"),
         "agree": int(int(want[0].argmax()) == toks[0]), "decisive": 0,
         "decisive_agree": 0, "worst": 0}
    for j in range(1, len(toks)):
        d = (rows[j] - want[j]).abs().max().item()
        if d > h["dec"]:
            h["dec"], h["worst"] = d, j
        h["shift"] = min(h["shift"],
                         (rows[j] - want[j - 1]).abs().max().item())
        same = int(int(want[j].argmax()) == toks[j])
        h["agree"] += same
        top2 = torch.topk(want[j], 2).values
        if (top2[0] - top2[1]).item() > 2 * DECODE_ATOL:
            h["decisive"] += 1
            h["decisive_agree"] += same
    return h


def check_holds(tag: str, holds: list) -> None:
    """Fail unless every held stream lies within DECODE_ATOL of its
    request alone, the witness tells a one-position slip from rounding,
    and every decisive greedy token agrees; prints the summary."""
    dec = max(h["dec"] for h in holds)
    shift = min(h["shift"] for h in holds)
    agree = sum(h["agree"] for h in holds)
    decisive = sum(h["decisive"] for h in holds)
    decisive_agree = sum(h["decisive_agree"] for h in holds)
    total = sum(h["n"] for h in holds)
    print(f"{tag} vs each request alone (teacher-forced): logits max abs "
          f"diff {dec:.4f} (bar {DECODE_ATOL}); a one-position slip would "
          f"differ by at least {shift:.4f}; greedy agreement "
          f"{agree}/{total}, {decisive_agree}/{decisive} where the top-2 "
          f"gap exceeds {2 * DECODE_ATOL}", flush=True)
    if dec > DECODE_ATOL:
        fail(f"{tag}: logits differ from the request alone by {dec} > "
             f"{DECODE_ATOL}")
    if shift <= DECODE_ATOL:
        fail(f"{tag}: the check cannot tell a one-position slip ({shift}) "
             f"from rounding ({DECODE_ATOL})")
    if decisive_agree != decisive:
        fail(f"{tag}: greedy tokens differ at {decisive - decisive_agree} "
             f"decisive steps")


# ----------------------------------------------------------- paged serving

def paged_run(tag: str, model, params, prompts, max_new: int,
              **kw) -> tuple:
    """A paged engine (``kw``: its drafter) on ``prompts``, all submitted
    at once, ``max_new`` greedy tokens each; fails unless every request
    finishes and B1, B2 and B8 launched as each model's calls add up to.
    Returns (engine, capture, uids, launches, wall seconds)."""
    cap = Capture()
    eng = ServeEngine(model, params, n_slots=N_SLOTS, kv_len=KV_LEN,
                      pool="paged", page_size=PAGE_SIZE, observer=cap, **kw)
    uids = cap.submit(eng, prompts, max_new)
    torch.cuda.synchronize()
    platform.reset_launches()
    t0 = time.perf_counter()
    res = eng.run(max_steps=4000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(platform.LAUNCHES)
    for u, p in zip(uids, prompts):
        if eng.status[u] != "done" or len(res[u]) != max_new:
            fail(f"{tag}: request {u} (prompt {len(p)}) did not finish: "
                 f"{eng.status[u]}, {len(res[u])} tokens")
    check_launches(tag, launches, cap, model,
                   kw["draft"][0] if "draft" in kw else None)
    return eng, cap, uids, launches, wall


def paged_phase(ctx: dict) -> tuple:
    """The paged serving phase on phase 3's model, params and prompts
    (``ctx``): a plain paged run, the prefix-cache wave and its
    bit-identical resubmission, and speculative decoding under two
    drafters; every engine's logits rows held against the request alone
    (phase 3's rule).  Returns the launches of the paged path (plain run
    and wave) and of the speculative path."""
    t_phase = time.perf_counter()
    model, params, prompts = ctx["model"], ctx["params"], ctx["prompts"]
    cfg = model.cfg

    def hold(tag, eng, cap, uids, idx):
        holds = []
        for u, i in zip(uids, idx):
            toks, P = eng.results[u], len(prompts[i])
            holds.append(hold_stream(
                f"{tag} request {u} (prompt {P})", cap.stream(u, len(toks)),
                teacher_forced(model, params, prompts[i], toks), toks))
        check_holds(tag, holds)
        print(f"{tag}: first-token logits vs the request's raw prefill max "
              f"abs diff {max(h['first'] for h in holds):.4f} (bar "
              f"{LOGIT_ATOL})", flush=True)

    def add(total, launches):
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n

    # warm-up: the paged shapes (a chunk, a decode tick) outside the count
    paged_run("paged warm-up", model, params, prompts[:1], 2)
    # 1. the plain paged run on phase 3's requests
    eng, cap, uids, launches, wall = paged_run(
        "paged serving", model, params, prompts, MAX_NEW)
    st = eng.stats()
    paged_launches = dict(launches)
    print(f"paged serving: {len(uids)} requests done, "
          f"{st['prefill_chunks']} prefill chunks of {PAGED_CHUNK} + "
          f"{cap.count('decode')} batched decode steps in {wall:.3f} s; "
          f"launches {launches} (= the sum of each call's: a chunk "
          f"{per_call_launches(model, PAGED_CHUNK)}, a decode step "
          f"{per_call_launches(model, N_SLOTS)})", flush=True)
    hold("paged serving: batched decode", eng, cap, uids,
         range(len(prompts)))
    arena = eng.pool.arena_bytes()
    slab = ctx["stats"]
    print(f"paged serving: TTFT p50 {st['ttft_ms']['p50']:.2f} ms (p90 "
          f"{st['ttft_ms']['p90']:.2f}), {st['tok_latency_ms']['p50']:.3f} "
          f"ms per decode step (p50), decode {st['tok_per_s']:.1f} tok/s; "
          f"the slab engine on the same requests: TTFT p50 "
          f"{slab['ttft_ms']['p50']:.2f} ms (p90 "
          f"{slab['ttft_ms']['p90']:.2f}), "
          f"{slab['tok_latency_ms']['p50']:.3f} ms per decode step, "
          f"{slab['tok_per_s']:.1f} tok/s; page arena {arena} bytes "
          f"({eng.pool.n_pages} pages of {PAGE_SIZE}), "
          f"pool {st['pool']}", flush=True)
    del eng, cap

    # 2. the prefix cache: three prompts sharing PREFIX_LEN tokens, the
    # second and third submitted once the first has registered its pages
    # (at the end of its prefill), then the first again after it retired
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, cfg.vocab, PREFIX_LEN)
    wave = [np.concatenate([prefix, rng.integers(0, cfg.vocab, n)]).astype(
        np.int32) for n in PREFIX_SUFFIXES]
    cap = Capture()
    eng = ServeEngine(model, params, n_slots=N_SLOTS, kv_len=KV_LEN,
                      pool="paged", page_size=PAGE_SIZE, observer=cap)
    torch.cuda.synchronize()
    platform.reset_launches()
    u0, = cap.submit(eng, wave[:1], PREFIX_NEW)
    while not eng.results[u0]:
        eng.step()
    later = cap.submit(eng, wave[1:], PREFIX_NEW)
    eng.run(max_steps=1000)
    hits = eng.pool.utilization()
    again, = cap.submit(eng, wave[:1], PREFIX_NEW)
    eng.run(max_steps=1000)
    torch.cuda.synchronize()
    launches = dict(platform.LAUNCHES)
    check_launches("prefix wave", launches, cap, model)
    add(paged_launches, launches)
    for u in [u0, *later, again]:
        if eng.status[u] != "done" or len(eng.results[u]) != PREFIX_NEW:
            fail(f"prefix wave: request {u} did not finish")
    u = eng.pool.utilization()
    print(f"prefix wave: prompts {[len(w) for w in wave]} sharing "
          f"{PREFIX_LEN} tokens: prefix_hits {hits['prefix_hits']}, "
          f"prefix_tokens_reused {hits['prefix_tokens_reused']}; the first "
          f"prompt again after it retired: "
          f"{u['prefix_tokens_reused'] - hits['prefix_tokens_reused']} "
          f"tokens reused; {eng.stats()['prefill_chunks']} prefill chunks "
          f"in all", flush=True)
    if hits["prefix_hits"] < 2 or \
            hits["prefix_tokens_reused"] < 2 * PREFIX_LEN:
        fail(f"prefix wave: {hits['prefix_hits']} hits reusing "
             f"{hits['prefix_tokens_reused']} tokens, expected >= 2 and >= "
             f"{2 * PREFIX_LEN}")
    cold, hit = cap.stream(u0, 1)[0], cap.stream(again, 1)[0]
    diff = (cold - hit).abs().max().item()
    print(f"prefix wave: the prefix hit's first-token logits vs the cold "
          f"run's: {'bit-identical' if torch.equal(cold, hit) else 'DIFFER'}"
          f" (max abs diff {diff})", flush=True)
    if not torch.equal(cold, hit):
        fail(f"prefix wave: the prefix hit's first-token logits differ from "
             f"the cold run's by {diff}")
    if (eng.pool.refcount != 0).any():
        fail(f"prefix wave: refcounts {eng.pool.refcount.max()} after the "
             f"drain")
    del eng, cap

    # 3. speculative decoding on the first N_SLOTS prompts: self-drafted,
    # then an independent drafter (qwen3-0.6b's widths at DRAFT_LAYERS
    # layers, seed 1)
    dmodel = Model(dataclasses.replace(cfg, n_layers=DRAFT_LAYERS),
                   model.zcfg, world=1, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    spec_launches: dict = {}
    idx = range(N_SLOTS)
    for tag, draft in (("self-drafted", (model, params)),
                       (f"{DRAFT_LAYERS}-layer drafter",
                        (dmodel, dmodel.init_params(g)))):
        tag = f"speculative ({tag}, spec_tokens {SPEC_TOKENS})"
        eng, cap, uids, launches, wall = paged_run(
            tag, model, params, [prompts[i] for i in idx], MAX_NEW,
            draft=draft, spec_tokens=SPEC_TOKENS)
        add(spec_launches, launches)
        hold(tag, eng, cap, uids, idx)
        st = eng.stats()
        acc = st["spec_accepted"]
        # tokens after the first, over the target's verify steps (each
        # verifies every active row)
        per_step = sum(len(eng.results[u]) - 1 for u in uids) / \
            cap.count("verify")
        print(f"{tag}: {len(uids)} requests in {wall:.3f} s, "
              f"{cap.count('verify')} verify steps, "
              f"{cap.count('draft', 'draft_prefill')} drafter calls; tokens a row a target step: mean {acc['mean']:.3f} "
              f"(p50 {acc['p50']}, cap {SPEC_TOKENS}); {per_step:.3f} "
              f"tokens emitted a target step over all rows; "
              f"{st['tok_latency_ms']['p50']:.3f} ms per round (p50), "
              f"{st['tok_per_s']:.1f} tok/s; arenas "
              f"{eng.pool.arena_bytes()} + {eng.draft_pool.arena_bytes()} "
              f"bytes", flush=True)
        if draft[0] is model and not acc["mean"] > 1.0:
            fail(f"{tag}: mean accepted {acc['mean']} <= 1")
        del eng, cap, draft
    del dmodel
    gc.collect()
    torch.cuda.empty_cache()
    print(f"paged phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return paged_launches, spec_launches


def _int4_level(x: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """x's level on its block's INT4 grid (0 where the block is all 0)."""
    return torch.where(step > 0, torch.round(x / torch.where(step > 0, step,
                                                             1)), 0)


def _grads_within_one_int4_step(got: dict, want: dict) -> tuple:
    """The card's gradients against the CPU's, both out of qgZ's INT4
    reduce: every element within rtol 1e-5 / atol 1e-6 of ``want``, or at
    most one INT4 step of its 256-block away, the latter in fewer than 1
    of 1,000.  This is the CPU tests' rule (``_within_int4_step`` in
    ``tests/test_torch_train.py``), with one INT4 step read as one level:
    a block's step is its absmax / 7 on each side, the two sides' steps
    differ by fp32 rounding, and every element must sit on its block's
    grid on both sides (within 1e-5 of a step) at levels at most one
    apart.  With equal steps that is the CPU tests' bound; a block that
    is 0 on one side must be 0 on the other.  The steps must agree as the
    blocks' absmax elements (level 7) must: at rtol 1e-5 / atol 1e-6 on
    7·step."""
    n_far = n = n_loose = 0
    worst = 0.0
    for k in want:      # on the card's device: the same IEEE arithmetic
        a = got[k].detach().float().reshape(-1, 256)
        b = want[k].detach().to(a.device, torch.float32).reshape(-1, 256)
        sa = a.abs().amax(dim=1, keepdim=True) / 7
        sb = b.abs().amax(dim=1, keepdim=True) / 7
        ds = (7 * (sa - sb)).abs()
        if not bool((ds <= 1e-6 + 1e-5 * 7 * sb).all()):
            fail(f"grad {k}: a block's INT4 step differs beyond rtol 1e-5 / "
                 f"atol 1e-6 on its absmax")
        n_loose += int((ds > 1e-5 * 7 * sb).sum())
        d = (a - b).abs()
        worst = max(worst, d.max().item())
        far = d > 1e-6 + 1e-5 * b.abs()
        la, lb = _int4_level(a, sa), _int4_level(b, sb)
        on_grid = ((a - la * sa).abs() <= 1e-5 * sa) & (
            (b - lb * sb).abs() <= 1e-5 * sb)
        if not bool((on_grid & ((la - lb).abs() <= 1)).all()):
            fail(f"grad {k}: an element is off by more than one INT4 step")
        n_far += int(far.sum())
        n += a.numel()
    if n_far >= n / 1000:
        fail(f"{n_far} of {n} gradient elements beyond rtol 1e-5 / atol 1e-6")
    return n_far, n, worst, n_loose


def step_launches(cfg, model, attn: str) -> dict:
    """Kernel launches one training step issues: each of B1-B5 once per
    flat group (embedding where the model has one, layer groups — a
    period of the pattern each, and the leftover layers' rem group —,
    head norm, unembedding chunks),
    none of B8, and under --attn pallas B6 twice per attention layer (the
    forward and the layer's recompute) and B7 once.  The knobs move B1-B5:
    non-blocked
    qwZ quantizes in plain PyTorch (no B1, no B2, as the reference
    computes it outside its kernels); the 1-hop qgZ runs B1 and B5 once
    per group and no B3 or B4.  An MoE model's gathers and reduces are
    those its ``comm_events`` count (the expert chunks', the routing-ahead
    gather's), B1 and B2 once per qwZ gather, B3-B5 once per reduce."""
    groups = (int(model.embed_spec is not None) + model.n_periods
              + int(model.rem > 0) + 1 + model.unemb_chunks)
    z = model.zcfg
    reduces = groups
    if model.is_moe:
        ev = model.comm_events()
        groups = int(sum(e["count"] for e in ev
                         if e["kind"] == "fwd_gather"
                         or (e["kind"] == "bwd_gather" and not z.hpz)))
        reduces = int(sum(e["count"] for e in ev
                          if e["kind"] == "grad_reduce"))
    qwz = int(z.qwz and z.qwz_blocked)
    two_hop = int(z.qgz and z.qgz_2hop)
    want = {k: groups for k in platform.LAUNCHES}
    want["quantize_blockwise"] = groups * qwz + reduces * int(
        z.qgz and not z.qgz_2hop)
    want["dequantize_blockwise"] = groups * qwz
    want["quantize_reordered"] = want["dequant_reduce_quant"] = \
        reduces * two_hop
    want["dequant_reduce"] = reduces * int(z.qgz)
    want["dequant_matmul"] = 0
    # the flash pair runs on the attention layers only (none in an ssd
    # stack, one in three of recurrentgemma's)
    kinds = model.period * model.n_periods + model.rem_kinds
    n_attn = sum(k in ("attn", "local", "moe") for k in kinds) \
        if attn == "pallas" else 0
    want["flash_fwd"] = 2 * n_attn
    want["flash_bwd"] = n_attn
    return want


def parity_cases() -> dict:
    """name -> (cfg, attn, rows, seq, bias_seed) of every parity step:
    qwen3-0.6b's widths at 2 layers and a vocabulary of 8192 in 4 chunks
    (2 x 256 plain, 2 x 512 under --attn pallas: the flash kernels need S
    a multiple of 512, the reference's rule), gemma3-4b's (phase 10),
    qwen2-vl-72b's (phase 12), deepseek-moe-16b's (phase 14), mamba2-130m's
    and recurrentgemma-2b's (phase 15)."""
    q = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=2,
                            vocab=8192, unemb_chunks=4)
    g = dataclasses.replace(get_config("gemma3-4b"), n_layers=3,
                            pattern=("local", "attn"), vocab=8192,
                            unemb_chunks=4)
    v = dataclasses.replace(get_config("qwen2-vl-72b"), n_layers=1,
                            vocab=QWEN2VL_PARITY_VOCAB, unemb_chunks=4)
    ssm = {name: (dataclasses.replace(cfg, n_layers=SSM_PARITY[name][0],
                                      vocab=8192, unemb_chunks=4),
                  "pallas", *SSM_PARITY[name][1:], None)
           for name, cfg in ssm_configs().items()}
    return {"qwen3_xla": (q, "xla", 2, 256, None),
            "qwen3_pallas": (q, "pallas", 2, 512, None),
            "gemma3": (g, "pallas", 1, GEMMA_PARITY_SEQ, None),
            "qwen2_vl": (v, "pallas", 1, QWEN2VL_PARITY_SEQ, 3),
            "moe": (moe_parity_config(), "pallas", MOE_PARITY_ROWS,
                    MOE_PARITY_SEQ, None), **ssm}


class Routes:
    """While open, records every ``models.moe.route_topk`` call's expert
    indices (on the host) and its smallest top-k margin: the gap between a
    token's k-th and (k+1)-th router probability."""

    def __enter__(self):
        from repro_torch.models import moe as moe_lib
        self.mod, self.real = moe_lib, moe_lib.route_topk
        self.idx, self.margins = [], []

        def rec(logits, top_k, norm_topk=True):
            gates, idx = self.real(logits, top_k, norm_topk)
            p = torch.softmax(logits.float(), dim=-1).sort(
                dim=-1, descending=True).values
            self.idx.append(idx.cpu())
            self.margins.append(
                (p[:, top_k - 1] - p[:, top_k]).min().item())
            return gates, idx
        moe_lib.route_topk = rec
        return self

    def __exit__(self, *exc):
        self.mod.route_topk = self.real


def parity_run(cfg, attn: str, rows: int, seq: int, bias_seed, dev: str
               ) -> tuple:
    """One full-ZeRO++ ``loss_and_grads`` of ``cfg`` in fp32 on ``dev``
    from the seeded parameters (drawn on the host; ``bias_seed``: the QKV
    biases drawn nonzero from it) and batch (rows x seq): (loss, grads,
    seconds, launches, model)."""
    from repro_torch.data.synthetic import SyntheticLM
    pol = make_policy(cfg, variant="zeropp", param_dtype=torch.float32,
                      compute_dtype=torch.float32, reduce_dtype=torch.float32)
    cpu_model = Model(cfg, pol.zcfg, device="cpu")
    params = cpu_model.init_params(torch.Generator().manual_seed(0),
                                   dtype=torch.float32)
    if bias_seed is not None:
        _seed_biases(cpu_model, params, bias_seed)
    model = cpu_model if dev == "cpu" else Model(cfg, pol.zcfg, device=dev)
    lm = SyntheticLM(vocab=cfg.vocab, seq_len=seq, seed=7)
    st = build_train_step(model, AdamWConfig(), device=dev, attn_impl=attn)
    batch = train_launch.device_batch(cfg, lm, 0, rows, 1, dev)
    p = {k: v.to(dev) for k, v in params.items()}
    platform.reset_launches()
    t0 = time.perf_counter()
    with Routes() as routes:
        loss, _, grads = st.loss_and_grads(p, batch)
    secs = time.perf_counter() - t0
    return float(loss), grads, secs, dict(platform.LAUNCHES), model, routes


def parity_cpu_main(outdir: str) -> None:
    """The CPU half of every parity step, in a process of its own (on
    PARITY_THREADS threads) beside the card's phases: each case's loss,
    gradients and seconds (an MoE case's also its routing) saved to
    ``outdir/<name>.pt`` when done.  It
    runs at the lowest scheduling priority, so that the card's phases
    beside it keep the host's cores they ask for."""
    os.nice(19)
    torch.set_num_threads(PARITY_THREADS)
    for name, case in parity_cases().items():
        loss, grads, secs, _, _, routes = parity_run(*case, "cpu")
        tmp = os.path.join(outdir, name + ".tmp")
        torch.save({"loss": loss, "grads": grads, "secs": secs,
                    "routes": routes.idx}, tmp)
        os.replace(tmp, os.path.join(outdir, name + ".pt"))
        del grads


class ParityCPU:
    """The CPU halves of the parity steps, computed by ``parity_cpu_main``
    in a spawned process from the script's start; :meth:`get` waits for
    one (failing if the process died) and hands it over, :meth:`close`
    waits for the process to end after its last case."""

    def __init__(self):
        import torch.multiprocessing as tmp
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_parity_")
        self.proc = tmp.get_context("spawn").Process(
            target=parity_cpu_main, args=(self.dir,), daemon=True)
        self.proc.start()

    def get(self, name: str) -> dict:
        path = os.path.join(self.dir, name + ".pt")
        deadline = time.monotonic() + PARITY_TIMEOUT_S
        t0 = time.perf_counter()
        while not os.path.exists(path):
            if self.proc.exitcode not in (None, 0):
                fail(f"the CPU parity process died (exit code "
                     f"{self.proc.exitcode}) before {name}")
            if time.monotonic() > deadline:
                fail(f"the CPU parity step {name} did not finish in "
                     f"{PARITY_TIMEOUT_S} s")
            time.sleep(0.5)
        waited = time.perf_counter() - t0
        out = torch.load(path)
        os.remove(path)
        out["waited"] = waited
        return out

    def close(self) -> None:
        t0 = time.perf_counter()
        self.proc.join(PARITY_TIMEOUT_S)
        if self.proc.exitcode != 0:
            fail(f"the CPU parity process ended with exit code "
                 f"{self.proc.exitcode}")
        shutil.rmtree(self.dir, ignore_errors=True)
        print(f"CPU parity process ended ({time.perf_counter() - t0:.1f} s "
              f"waited)", flush=True)


PARITY = None        # main's ParityCPU


def train_parity_phase() -> None:
    """One loss_and_grads of the full ZeRO++ step on the card and on the
    CPU, same fp32 parameters and batch (qwen3-0.6b widths, 2 layers,
    vocab 8192 in 4 chunks, fp32 compute): batch 2 x 256 with plain
    attention, and 2 x 512 with --attn pallas (the flash kernels need S a
    multiple of 512, the reference's rule)."""
    for name in ("qwen3_xla", "qwen3_pallas"):
        parity_step(name)


def parity_step(name: str) -> None:
    """Parity case ``name`` (``parity_cases``): one full-ZeRO++
    ``loss_and_grads`` in fp32 on the card, held to phase 4's rule against
    the CPU's from the same parameters and batch (``PARITY``'s, computed
    beside the earlier phases); the card's launches must be
    ``step_launches``."""
    cfg, attn, rows, seq, bias_seed = parity_cases()[name]
    out, secs = {}, {}
    loss, grads, secs["cuda"], launches, model, routes = parity_run(
        cfg, attn, rows, seq, bias_seed, "cuda")
    out["cuda"] = (loss, grads)
    want = step_launches(cfg, model, attn)
    if launches != want:
        fail(f"train parity --attn {attn}: launches {launches}, expected "
             f"{want}")
    cpu = PARITY.get(name)
    out["cpu"], secs["cpu"] = (cpu["loss"], cpu["grads"]), cpu["secs"]
    dl = abs(out["cuda"][0] - out["cpu"][0])
    if not (np.isfinite(out["cuda"][0]) and dl <= 1e-5):
        fail(f"train parity --attn {attn}: loss {out['cuda'][0]} (card) "
             f"vs {out['cpu'][0]} (CPU)")
    n_far, n, worst, n_loose = _grads_within_one_int4_step(
        out["cuda"][1], out["cpu"][1])
    extra = f" window {cfg.window}," if "local" in cfg.pattern else ""
    if model.is_moe:
        same = len(routes.idx) == len(cpu["routes"]) and all(
            torch.equal(a, b) for a, b in zip(routes.idx, cpu["routes"]))
        print(f"train parity {cfg.name}: routing of {len(routes.idx)} "
              f"router calls (forward and recompute, {cfg.n_experts} experts "
              f"top-{cfg.top_k}) {'equal' if same else 'DIFFERENT'} on the "
              f"card and the CPU; smallest top-k margin "
              f"{min(routes.margins):.3e}", flush=True)
        if not same:
            fail(f"train parity {cfg.name}: the card routes differently")
        extra += (f" {cfg.n_experts} experts top-{cfg.top_k} in "
                  f"{cfg.expert_chunks} chunks,")
    if cfg.qkv_bias:
        extra += " QKV bias seeded nonzero,"
    if cfg.mrope:
        extra += " M-RoPE (t, t // 16, t % 16),"
    if cfg.embed_inputs:
        extra += " stub embeddings,"
    print(f"train parity --attn {attn} ({cfg.name}: {cfg.n_layers} layers "
          f"of {cfg.pattern},{extra} d {cfg.d_model}, hd {cfg.d_head}, vocab "
          f"{cfg.vocab}, batch {rows} x {seq}, fp32): loss card "
          f"{out['cuda'][0]:.6f} vs CPU {out['cpu'][0]:.6f} (|diff| "
          f"{dl:.2e} <= 1e-5); grads: {n_far} of {n} elements beyond rtol "
          f"1e-5 / atol 1e-6, max abs diff {worst:.3e}, none beyond one INT4 "
          f"step; {n_loose} blocks' steps apart by more than rtol 1e-5 "
          f"(within atol 1e-6 on 7·step); card {secs['cuda']:.1f} s, CPU "
          f"{secs['cpu']:.1f} s, waited {cpu['waited']:.1f} s for it",
          flush=True)


def train_phase(attn: str) -> tuple:
    """The full-width ZeRO++ training run through the launcher's loop, with
    the attention route ``attn``.  Returns (launches over the run, the
    losses)."""
    metrics_dir = tempfile.mkdtemp(prefix="chip_smoke_obs_") \
        if attn == "pallas" else None
    args = train_launch.parser().parse_args([
        "--arch", "qwen3-0.6b", "--batch", str(TRAIN_BATCH), "--seq",
        str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS), "--lr", str(TRAIN_LR),
        "--lr-schedule", "constant", "--device", "cuda", "--attn", attn]
        + (["--metrics-dir", metrics_dir, "--obs-gate"] if metrics_dir
           else []))
    # earlier phases' tensors (the engine holds itself in a cycle) must not
    # count in this run's peak
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    platform.reset_launches()
    res = train_launch.train_loop(args)
    launches = dict(platform.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    built = res["built"]
    cfg, model = built.arch, built.model
    per_step = step_launches(cfg, model, attn)
    for i, c in enumerate(res["launches"]):
        if c != per_step:
            fail(f"train --attn {attn} step {i}: launches {c}, expected "
                 f"{per_step}")
    losses = res["losses"]
    if not all(np.isfinite(losses)):
        fail(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0] - LOSS_DROP:
        fail(f"loss did not fall by {LOSS_DROP}: {losses}")
    p50 = statistics.median(res["step_s"][1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    tag = f"train --attn {attn}"
    print(f"{tag}: {cfg.name} full width ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, vocab {cfg.vocab}), {model.n_params()} params "
          f"fp32 master + fp32 moments, full ZeRO++ (qwZ INT8, hpZ, qgZ "
          f"INT4 2-hop) on a one-rank world, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, constant lr {TRAIN_LR}", flush=True)
    print(f"{tag}: losses {[round(x, 4) for x in losses]} (drop "
          f"{losses[0] - losses[-1]:.4f}, bar {LOSS_DROP}); entropy bound "
          f"{res['entropy_bound']:.4f}", flush=True)
    print(f"{tag}: step p50 (steps 2-{TRAIN_STEPS}) {p50 * 1e3:.1f} ms, "
          f"{tokens / p50:,.0f} tokens/s, first step "
          f"{res['step_s'][0] * 1e3:.1f} ms; peak memory "
          f"{peak / 2 ** 30:.2f} GiB (max_memory_allocated); launches per "
          f"step {per_step} x {TRAIN_STEPS} steps", flush=True)
    batch = train_launch.device_batch(cfg, built.lm, TRAIN_STEPS,
                                      TRAIN_BATCH, 1, model.device)
    profile_step(lambda: built.step.fn(res["params"], res["opt"], batch),
                 f"{tag} step")
    if metrics_dir:
        telemetry_check(tag, metrics_dir, res)
        shutil.rmtree(metrics_dir)
        overhead_reading(tag, built.step.fn, res["params"], res["opt"],
                         batch)
    return launches, losses


# ----------------------------------------------------------------- gemma3

def gemma3_config():
    """gemma3-4b at full width, cut in depth only: one period of 5 local
    and 1 attn layers and a rem group of 2 local layers."""
    return dataclasses.replace(get_config("gemma3-4b"), n_layers=GEMMA_LAYERS)


def gemma3_group_sizes() -> tuple:
    """Elements of the 8-layer gemma3-4b's flat groups at world 1, each a
    (1, N) row of B1-B5 on its training path: the embedding, the period,
    the rem group, one unembedding chunk and the head norm."""
    cfg = gemma3_config()
    shapes = Model(cfg, make_policy(cfg, variant="zeropp").zcfg,
                   device="cuda").param_shapes()
    return (shapes["embed"][0], shapes["blocks"][1], shapes["rem"][0],
            shapes["unemb"][1], shapes["head"][0])


def _window_pairs(S: int, window: int) -> int:
    """(q, k) pairs a causal sliding window of ``window`` keeps in S rows."""
    if not window or window >= S:
        return _causal_pairs(S)
    return window * (window + 1) // 2 + (S - window) * window


def _sdpa_backend(fn) -> str:
    """The backend SDPA took, read from the device kernels one call ran."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = " ".join(e.name for e in prof.events()).lower()
    for key, backend in (("cudnn", "cudnn"), ("flash", "flash"),
                         ("fmha", "efficient"), ("efficient", "efficient")):
        if key in names:
            return backend
    return "math"


def gemma3_flash_phase(flush: torch.Tensor) -> dict:
    """B6/B7 at head dim 256, gemma3-4b's training shape (q (2, 4096, 8,
    256), k/v (2, 4096, 4, 256)), in bf16: causal with the local layers'
    window of 1024 and without (the global layer), each held against the
    plain versions at testing/flash_bars.py and twice with the same bits,
    timed beside its bound, the plain version and SDPA (with the backend
    it took); then the fp32 route at (1, 1024, 8/4, 256), plain causal
    and with window 300 and softcap 30, at 2e-5 / 3e-5 and timed."""
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    B, S, H, K, hd = GEMMA_FLASH_SHAPE
    q, k, v, do = _flash_inputs(g, GEMMA_FLASH_SHAPE, torch.bfloat16)
    qb, kb = B * S * H * hd * 2, B * S * K * hd * 2
    rec = {}
    fwd_err = bwd_err = 0.0
    for window in (GEMMA_WINDOW, 0):
        kw = dict(scale=hd ** -0.5, causal=True, window=window)
        tag = f"{GEMMA_FLASH_SHAPE} hd 256 causal window {window}"
        (out, m, l), want, bar, fe, be = _hold_bf16(tag, q, k, v, do, kw)
        fwd_err, bwd_err = max(fwd_err, fe), max(bwd_err, be)
        del want, bar
        prod = 2 * hd * B * H * _window_pairs(S, window)
        b6 = bound_mixed(2 * qb + 2 * kb + 8 * B * H * S,
                         ((2 * prod, BF16_OPS_S),))
        b7 = bound_mixed(4 * qb + 4 * kb + 8 * B * H * S,
                         (((2 + 3 * 2) * prod, BF16_OPS_S),))
        f_ms = median_ms(lambda: fa.flash_fwd(q, k, v, **kw), flush)
        b_ms = median_ms(lambda: fa.flash_bwd(q, k, v, out, m, l, do, **kw),
                         flush)
        f_plain = median_ms(lambda: ref.flash_fwd_ref(q, k, v, **kw), flush,
                            n=3, warmup=1)
        b_plain = median_ms(lambda: ref.flash_bwd_ref(
            q, k, v, out, m, l, do, **kw), flush, n=3, warmup=1)
        if f_ms < b6[0] or b_ms < b7[0]:
            fail(f"hd 256 window {window}: a flash kernel reads faster than "
                 f"its bound (B6 {f_ms} < {b6[0]} or B7 {b_ms} < {b7[0]})")
        # the library's attention on the same inputs, a yardstick only
        sq, sk, sv = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        sdo = do.transpose(1, 2)
        pos = torch.arange(S, device="cuda")
        band = ((pos[:, None] >= pos[None, :])
                & (pos[:, None] - pos[None, :] < window)) if window else None

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=band, is_causal=band is None,
                enable_gqa=True)
        with torch.no_grad():
            lib_f = median_ms(sdpa, flush)
            backend = _sdpa_backend(sdpa)
        so = sdpa()
        lib_b = median_ms(lambda: torch.autograd.grad(
            so, (sq, sk, sv), sdo, retain_graph=True), flush)
        del so, sq, sk, sv, sdo, band
        print(f"B6 flash_fwd {tag} bf16: kernel {f_ms:.4f} ms "
              f"({100 * b6[0] / f_ms:.1f} % of its bound), plain "
              f"{f_plain:.4f} ms, bound {b6[0]:.4f} ms ({b6[1]}), SDPA "
              f"({backend}) {lib_f:.4f} ms", flush=True)
        print(f"B7 flash_bwd {tag} bf16: kernel {b_ms:.4f} ms "
              f"({100 * b7[0] / b_ms:.1f} % of its bound), plain "
              f"{b_plain:.4f} ms, bound {b7[0]:.4f} ms ({b7[1]}), SDPA "
              f"({backend}) backward {lib_b:.4f} ms", flush=True)
        key = "local" if window else "global"
        for name, ms, plain, bnd, lib in (
                ("flash_fwd_hd256", f_ms, f_plain, b6, lib_f),
                ("flash_bwd_hd256", b_ms, b_plain, b7, lib_b)):
            r = rec.setdefault(name, {"extra": {"sdpa_backend": backend}})
            if window:          # the record: the local layers' shape
                r.update(ms=ms, plain_ms=plain, bound=bnd, library_ms=lib,
                         shape=GEMMA_FLASH_SHAPE + (window,))
            r["extra"][key] = dict(ms=ms, plain_ms=plain, bound_ms=bnd[0],
                                   library_ms=lib, window=window)
        del out, m, l
    del q, k, v, do

    # the fp32 (FFMA) route at hd 256, at the reference's bars
    for extra in ({}, dict(window=FLASH_WINDOW, softcap=FLASH_SOFTCAP)):
        q, k, v, do = _flash_inputs(g, GEMMA_F32_SHAPE, torch.float32)
        kw = dict(scale=hd ** -0.5, causal=True, **extra)
        got = fa.flash_fwd(q, k, v, **kw)
        want = ref.flash_fwd_ref(q, k, v, **kw)
        for name, a, b in zip(("out", "m", "l"), got, want):
            if not torch.allclose(a, b, rtol=2e-5, atol=2e-5):
                fail(f"B6 f32 hd 256 {extra} {name}: beyond 2e-5 (max abs "
                     f"err {_max_err(a, b)})")
        grads = fa.flash_bwd(q, k, v, *got, do, **kw)
        wgrads = ref.flash_bwd_ref(q, k, v, *got, do, **kw)
        for name, a, b in zip(("dq", "dk", "dv"), grads, wgrads):
            if not torch.allclose(a, b, rtol=3e-5, atol=3e-5):
                fail(f"B7 f32 hd 256 {extra} {name}: beyond 3e-5 (max abs "
                     f"err {_max_err(a, b)})")
        if not (all(torch.equal(a, b) for a, b in
                    zip(fa.flash_fwd(q, k, v, **kw), got))
                and all(torch.equal(a, b) for a, b in zip(
                    fa.flash_bwd(q, k, v, *got, do, **kw), grads))):
            fail(f"B6/B7 f32 hd 256 {extra}: two launches differ")
        errs = [_max_err(a, b) for a, b in zip((*got, *grads),
                                                     (*want, *wgrads))]
        fwd_err, bwd_err = max(fwd_err, *errs[:3]), max(bwd_err, *errs[3:])
        t_f = median_ms(lambda: fa.flash_fwd(q, k, v, **kw), flush)
        t_b = median_ms(lambda: fa.flash_bwd(q, k, v, *got, do, **kw), flush)
        print(f"B6/B7 {GEMMA_F32_SHAPE} f32 causal {extra or ''}: out/m/l "
              f"max abs err {max(errs[:3]):.3e} (rtol/atol 2e-5), dq/dk/dv "
              f"{max(errs[3:]):.3e} (3e-5), both bit-identical across two "
              f"launches; forward {t_f:.4f} ms, backward {t_b:.4f} ms",
              flush=True)
        tag = "f32_window_softcap" if extra else "f32"
        rec["flash_fwd_hd256"]["extra"][tag + "_ms"] = t_f
        rec["flash_bwd_hd256"]["extra"][tag + "_ms"] = t_b
        del q, k, v, do, got, want, grads, wgrads
    rec["flash_fwd_hd256"]["max_abs_err"] = fwd_err
    rec["flash_bwd_hd256"]["max_abs_err"] = bwd_err
    torch.cuda.synchronize()
    return rec


def gemma3_parity_phase() -> None:
    """Phase 4's rule on gemma3-4b's widths: pattern ("local", "attn") at
    3 layers (one period and a rem layer), vocab 8192, window 1024, fp32,
    batch 1 x GEMMA_PARITY_SEQ under --attn pallas (B6/B7 at hd 256 on
    the card, their plain versions on the CPU)."""
    parity_step("gemma3")


def gemma3_train_phase() -> dict:
    """``train_loop`` on the 8-layer full-width gemma3-4b: bf16 compute,
    full ZeRO++ at world 1, --attn pallas, batch 2 x 4096, 6 steps at a
    constant lr 3e-4.  Finite losses, the last below the first, every
    step's launches ``step_launches`` (B6 2x and B7 1x a layer, B1-B5
    once a flat group, rem included); prints step p50, tokens/s, peak
    memory and one profiled step.  Returns the run's launches."""
    cfg = gemma3_config()
    args = train_launch.parser().parse_args([
        "--batch", str(GEMMA_TRAIN_BATCH), "--seq", str(GEMMA_TRAIN_SEQ),
        "--steps", str(GEMMA_TRAIN_STEPS), "--lr", str(TRAIN_LR),
        "--lr-schedule", "constant", "--device", "cuda", "--attn", "pallas",
        "--log-every", "0"])
    args.arch = cfg
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    platform.reset_launches()
    res = train_launch.train_loop(args)
    launches = dict(platform.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    built = res["built"]
    model = built.model
    per_step = step_launches(cfg, model, "pallas")
    for i, c in enumerate(res["launches"]):
        if c != per_step:
            fail(f"gemma3 train step {i}: launches {c}, expected {per_step}")
    losses = res["losses"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"gemma3 train: losses not finite and falling: {losses}")
    p50 = statistics.median(res["step_s"][1:])
    tokens = GEMMA_TRAIN_BATCH * GEMMA_TRAIN_SEQ
    tag = "train gemma3-4b --attn pallas"
    print(f"{tag}: full width (d {cfg.d_model}, vocab {cfg.vocab}, hd "
          f"{cfg.d_head}, window {cfg.window}), {cfg.n_layers} layers "
          f"({model.n_periods} x {model.period} + rem "
          f"{model.rem_kinds}), {model.n_params()} params fp32 "
          f"master + fp32 moments, full ZeRO++ on a one-rank world, batch "
          f"{GEMMA_TRAIN_BATCH} x {GEMMA_TRAIN_SEQ}, constant lr {TRAIN_LR}",
          flush=True)
    print(f"{tag}: losses {[round(x, 4) for x in losses]} (drop "
          f"{losses[0] - losses[-1]:.4f}); entropy bound "
          f"{res['entropy_bound']:.4f}", flush=True)
    print(f"{tag}: step p50 (steps 2-{GEMMA_TRAIN_STEPS}) {p50 * 1e3:.1f} "
          f"ms, {tokens / p50:,.0f} tokens/s, first step "
          f"{res['step_s'][0] * 1e3:.1f} ms; peak memory "
          f"{peak / 2 ** 30:.2f} GiB (max_memory_allocated); launches per "
          f"step {per_step}", flush=True)
    batch = train_launch.device_batch(built.arch, built.lm, GEMMA_TRAIN_STEPS,
                                      GEMMA_TRAIN_BATCH, 1, model.device)
    profile_step(lambda: built.step.fn(res["params"], res["opt"], batch),
                 f"{tag} step")
    del res, built, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ qwen2-vl

def qwen2_vl_config():
    """qwen2-vl-72b at full width, cut in depth only (QWEN2VL_LAYERS of
    80 layers: 80 layers' fp32 state is 1.15 TB)."""
    return dataclasses.replace(get_config("qwen2-vl-72b"),
                               n_layers=QWEN2VL_LAYERS)


def qwen2_vl_group_sizes() -> tuple:
    """Elements of the cut qwen2-vl-72b's flat groups at world 1, each a
    (1, N) row of B1-B5 on its training path: one layer group, one
    unembedding chunk and the head norm (no embedding: the stub feeds
    embeddings)."""
    cfg = qwen2_vl_config()
    shapes = Model(cfg, make_policy(cfg, variant="zeropp").zcfg,
                   device="cuda").param_shapes()
    if "embed" in shapes:
        fail("qwen2-vl-72b has an embedding group")
    return shapes["blocks"][1], shapes["unemb"][1], shapes["head"][0]


def stub_table_thread():
    """The frontend stub's (152,064 x 8,192) fp32 table, drawn on a host
    thread while the earlier phases run (numpy's draws release the GIL):
    1.25 B normal draws, the reference's bits, kept by
    ``data.synthetic.stub_table`` for every later batch."""
    import threading
    from repro_torch.data.synthetic import stub_table
    cfg = get_config("qwen2-vl-72b")
    t = threading.Thread(target=stub_table, args=(cfg.vocab, cfg.d_model),
                         daemon=True)
    t.start()
    return t


def _seed_biases(model, params: dict, seed: int) -> None:
    """Draw every ``bq``/``bk``/``bv`` entry of the layer groups from
    N(0, 0.5²) (the init leaves them 0, which would not test the bias
    path), in place."""
    g = torch.Generator(device=params["blocks"].device)
    g.manual_seed(seed)
    spec = model.period_spec
    for name, _ in spec.entries:
        if name.split(".")[-1] in ("bq", "bk", "bv"):
            off, n = spec.offsets[name]
            rows = params["blocks"][:, off:off + n]
            rows.copy_(0.5 * torch.randn(rows.shape, generator=g,
                                         device=rows.device))


def qwen2_vl_flash_phase(flush: torch.Tensor) -> dict:
    """B6/B7 in bf16 at qwen2-vl-72b's training shape (q (4, 2048, 64,
    128), k/v (4, 2048, 8, 128): a GQA group of 8, dk/dv summed over 8
    heads) (``path_flash_phase``)."""
    return path_flash_phase(QWEN2VL_FLASH_SHAPE, "GQA 8", "gqa8", 12, flush)


def moe_flash_phase(flush: torch.Tensor) -> dict:
    """B6/B7 in bf16 at deepseek-moe-16b's training shape (q/k/v (4, 2048,
    16, 128): GQA group 1) (``path_flash_phase``)."""
    return path_flash_phase(MOE_FLASH_SHAPE, "deepseek-moe-16b, GQA 1",
                            "moe", 13, flush)


def path_flash_phase(shape, what: str, key: str, seed: int,
                     flush: torch.Tensor, window: int = 0) -> dict:
    """B6/B7 in bf16 at a training path's shape (B, S, H, K, hd), causal
    (under a sliding ``window`` where > 0), held as phase 2 holds
    FLASH_SHAPE and twice with the same bits, timed beside the bound, the
    plain versions and SDPA; the records
    ``flash_fwd_<key>``/``flash_bwd_<key>``."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    B, S, H, K, hd = shape
    q, k, v, do = _flash_inputs(g, shape, torch.bfloat16)
    kw = dict(scale=hd ** -0.5, causal=True)
    if window:
        kw["window"] = window
    tag = f"{shape} causal{f' window {window}' if window else ''} ({what})"
    (out, m, l), want, bar, fe, be = _hold_bf16(tag, q, k, v, do, kw)
    del want, bar
    prod = 2 * hd * B * H * _window_pairs(S, window)
    qb_, kb_ = B * S * H * hd * 2, B * S * K * hd * 2
    b6 = bound_mixed(2 * qb_ + 2 * kb_ + 8 * B * H * S,
                     ((2 * prod, BF16_OPS_S),))
    b7 = bound_mixed(4 * qb_ + 4 * kb_ + 8 * B * H * S,
                     (((2 + 3 * 2) * prod, BF16_OPS_S),))
    f_ms = median_ms(lambda: fa.flash_fwd(q, k, v, **kw), flush)
    b_ms = median_ms(lambda: fa.flash_bwd(q, k, v, out, m, l, do, **kw),
                     flush)
    f_plain = median_ms(lambda: ref.flash_fwd_ref(q, k, v, **kw), flush,
                        n=3, warmup=1)
    b_plain = median_ms(lambda: ref.flash_bwd_ref(q, k, v, out, m, l, do,
                                                  **kw), flush, n=3, warmup=1)
    if f_ms < b6[0] or b_ms < b7[0]:
        fail(f"{what}: a flash kernel reads faster than its bound (B6 "
             f"{f_ms} < {b6[0]} or B7 {b_ms} < {b7[0]})")
    sq, sk, sv = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    sdo = do.transpose(1, 2)
    pos = torch.arange(S, device="cuda")
    band = ((pos[:, None] >= pos[None, :])
            & (pos[:, None] - pos[None, :] < window)) if window else None

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=band, is_causal=band is None,
            enable_gqa=H != K)
    with torch.no_grad():
        lib_f = median_ms(sdpa, flush)
        backend = _sdpa_backend(sdpa)
    so = sdpa()
    lib_b = median_ms(lambda: torch.autograd.grad(
        so, (sq, sk, sv), sdo, retain_graph=True), flush)
    del so, sq, sk, sv, sdo, band
    print(f"B6 flash_fwd {tag} bf16: kernel {f_ms:.4f} ms "
          f"({100 * b6[0] / f_ms:.1f} % of its bound), plain {f_plain:.4f} "
          f"ms, bound {b6[0]:.4f} ms ({b6[1]}), SDPA ({backend}) "
          f"{lib_f:.4f} ms", flush=True)
    print(f"B7 flash_bwd {tag} bf16: kernel {b_ms:.4f} ms "
          f"({100 * b7[0] / b_ms:.1f} % of its bound), plain {b_plain:.4f} "
          f"ms, bound {b7[0]:.4f} ms ({b7[1]}), SDPA ({backend}) backward "
          f"{lib_b:.4f} ms", flush=True)
    del q, k, v, do, out, m, l
    torch.cuda.synchronize()
    extra = {"sdpa_backend": backend}
    return {f"flash_fwd_{key}": dict(ms=f_ms, plain_ms=f_plain, bound=b6,
                                     library_ms=lib_f, max_abs_err=fe,
                                     shape=shape, extra=extra),
            f"flash_bwd_{key}": dict(ms=b_ms, plain_ms=b_plain, bound=b7,
                                     library_ms=lib_b, max_abs_err=be,
                                     shape=shape, extra=extra)}


def qwen2_vl_train_phase(table) -> dict:
    """``train_loop`` on the cut qwen2-vl-72b: bf16 compute, full ZeRO++
    at world 1, --attn pallas, batch 4 x 2048 of the stub's embeddings
    and (t, t // 16, t % 16) positions, QWEN2VL_TRAIN_STEPS steps at a
    constant lr 3e-4.  Finite losses, the last below the first, every
    step's launches ``step_launches`` (no embedding group); prints step
    p50, tokens/s, peak memory and one profiled step.  ``table``: the
    stub table's drawing thread, joined first.  Returns the run's
    launches."""
    t0 = time.perf_counter()
    table.join()
    print(f"qwen2-vl stub table ready ({time.perf_counter() - t0:.1f} s "
          f"waited)", flush=True)
    cfg = qwen2_vl_config()
    args = train_launch.parser().parse_args([
        "--batch", str(QWEN2VL_TRAIN_BATCH), "--seq", str(QWEN2VL_TRAIN_SEQ),
        "--steps", str(QWEN2VL_TRAIN_STEPS), "--lr", str(TRAIN_LR),
        "--lr-schedule", "constant", "--device", "cuda", "--attn", "pallas",
        "--log-every", "0"])
    args.arch = cfg
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    platform.reset_launches()
    res = train_launch.train_loop(args)
    launches = dict(platform.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    built = res["built"]
    model = built.model
    if "embed" in res["params"] or model.embed_spec is not None:
        fail("qwen2-vl train: an embedding group exists")
    per_step = step_launches(cfg, model, "pallas")
    for i, c in enumerate(res["launches"]):
        if c != per_step:
            fail(f"qwen2-vl train step {i}: launches {c}, expected "
                 f"{per_step}")
    losses = res["losses"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"qwen2-vl train: losses not finite and falling: {losses}")
    p50 = statistics.median(res["step_s"][1:])
    tokens = QWEN2VL_TRAIN_BATCH * QWEN2VL_TRAIN_SEQ
    total = torch.cuda.get_device_properties(0).total_memory
    tag = "train qwen2-vl-72b --attn pallas"
    print(f"{tag}: full width (d {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.d_head}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab} in {model.unemb_chunks} chunks; QKV bias, M-RoPE, "
          f"embedding inputs), {cfg.n_layers} of 80 layers, "
          f"{model.n_params()} params fp32 master + fp32 moments, full "
          f"ZeRO++ on a one-rank world, batch {QWEN2VL_TRAIN_BATCH} x "
          f"{QWEN2VL_TRAIN_SEQ} (stub embeddings and positions), constant "
          f"lr {TRAIN_LR}", flush=True)
    print(f"{tag}: losses {[round(x, 4) for x in losses]} (drop "
          f"{losses[0] - losses[-1]:.4f}); entropy bound "
          f"{res['entropy_bound']:.4f}", flush=True)
    print(f"{tag}: step p50 (steps 2-{QWEN2VL_TRAIN_STEPS}) "
          f"{p50 * 1e3:.1f} ms, {tokens / p50:,.0f} tokens/s, first step "
          f"{res['step_s'][0] * 1e3:.1f} ms; peak memory "
          f"{peak / 2 ** 30:.2f} GiB of {total / 2 ** 30:.2f} GiB "
          f"(max_memory_allocated); launches per step {per_step}",
          flush=True)
    batch = train_launch.device_batch(built.arch, built.lm,
                                      QWEN2VL_TRAIN_STEPS,
                                      QWEN2VL_TRAIN_BATCH, 1, model.device)
    profile_step(lambda: built.step.fn(res["params"], res["opt"], batch),
                 f"{tag} step")
    del res, built, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def qwen2_vl_parity_phase() -> None:
    """Phase 4's rule on qwen2-vl-72b's widths: 1 layer, vocab 4,096 in 4
    chunks, fp32, batch 1 x 512 under --attn pallas (B6/B7 at GQA 8 on
    the card, their plain versions on the CPU), the QKV biases seeded
    nonzero, the stub's positions (three different streams)."""
    parity_step("qwen2_vl")


def _vl_inputs(batch: dict, sl) -> dict:
    """The model inputs of ``batch`` at the positions ``sl``."""
    return {"embeds": batch["embeds"][:, sl],
            "positions": batch["positions"][:, :, sl]}


def qwen2_vl_serve_phase() -> dict:
    """The reference's serving consistency check (checks.py:607) at full
    width through ``serve/steps.py``, fp32 compute: prefill of P =
    QWEN2VL_PROMPT positions, then QWEN2VL_EXTRA teacher-forced decode
    steps (the stub's embeddings and positions of each), against one
    prefill of P + n: max |diff| / max |logits| under QWEN2VL_SERVE_REL and
    the same argmax.  Then the bf16 serving path (weights bf16, the head
    through B8) on QWEN2VL_DECODE_ROWS rows: a prefill and
    QWEN2VL_DECODE_STEPS decode steps, each timed.  Returns the bf16
    path's launches."""
    from repro_torch.data.synthetic import SyntheticLM, make_batch
    cfg = qwen2_vl_config()
    P, n = QWEN2VL_PROMPT, QWEN2VL_EXTRA
    cap = P + n
    lm = SyntheticLM(vocab=cfg.vocab, seq_len=P + max(n,
                                                      QWEN2VL_DECODE_STEPS),
                     seed=9)
    host = make_batch(cfg, lm, 0, QWEN2VL_DECODE_ROWS)
    batch = {"embeds": torch.from_numpy(host["embeds"]).cuda(),
             "positions": torch.from_numpy(host["positions"]).long().cuda()}
    f32 = make_policy(cfg, param_dtype=torch.float32,
                      compute_dtype=torch.float32).zcfg
    model = Model(cfg, f32, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    params = model.init_params(gen, dtype=torch.float32)
    _seed_biases(model, params, 22)
    ps = steps.build_prefill_step(model)
    ds = steps.build_decode_step(model)
    rows = slice(0, 2)
    two = {k: v[:, rows] if k == "positions" else v[rows]
           for k, v in batch.items()}
    want, _ = ps.fn(params, _vl_inputs(two, slice(0, cap)))
    got, caches = ps.fn(params, _vl_inputs(two, slice(0, P)))
    caches = steps.pad_prefill_caches(model, caches, cap)
    for t in range(P, cap):
        got, caches = ds.fn(params, caches, _vl_inputs(two, slice(t, t + 1)),
                            torch.full((2,), t, device="cuda"))
    want, got = want.float(), got.float()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        fail("qwen2-vl serving: non-finite logits")
    rel = ((got - want).abs().max() / (want.abs().max() + 1e-9)).item()
    same = bool((got.argmax(-1) == want.argmax(-1)).all())
    print(f"serve qwen2-vl-72b ({cfg.n_layers} layers, full width, fp32): "
          f"prefill({P}) + {n} decode steps vs prefill({cap}): max |diff| / "
          f"max |logits| {rel:.3e} (bar {QWEN2VL_SERVE_REL}), argmax "
          f"{'equal' if same else 'DIFFERENT'}", flush=True)
    if not (rel < QWEN2VL_SERVE_REL and same):
        fail(f"qwen2-vl prefill/decode mismatch: rel {rel}, argmax equal "
             f"{same}")
    del model, params, caches, want, got, ps, ds
    gc.collect()
    torch.cuda.empty_cache()

    # the bf16 serving path: qwZ INT8 gathers, the head through B8
    model = Model(cfg, make_policy(cfg).zcfg, device="cuda")
    gen.manual_seed(21)
    params = model.init_params(gen, dtype=torch.float32)
    _seed_biases(model, params, 22)
    params = {k: v.to(torch.bfloat16) for k, v in params.items()}
    ps = steps.build_prefill_step(model)
    ds = steps.build_decode_step(model)
    B = QWEN2VL_DECODE_ROWS
    platform.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = ps.fn(params, _vl_inputs(batch, slice(0, P)))
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t0) * 1e3
    caches = steps.pad_prefill_caches(model, caches,
                                      P + QWEN2VL_DECODE_STEPS)
    dec_ms = []
    for t in range(P, P + QWEN2VL_DECODE_STEPS):
        step = _vl_inputs(batch, slice(t, t + 1))
        pos = torch.full((B,), t, device="cuda")
        t0 = time.perf_counter()
        logits, caches = ds.fn(params, caches, step, pos)
        torch.cuda.synchronize()
        dec_ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(platform.LAUNCHES)
    if not torch.isfinite(logits).all():
        fail("qwen2-vl bf16 decode: non-finite logits")
    if launches["dequant_matmul"] <= 0:
        fail("qwen2-vl bf16 decode: the head did not launch B8")
    print(f"serve qwen2-vl-72b bf16 ({B} rows): prefill {P} positions "
          f"{pre_ms:.1f} ms, decode step p50 (steps 2-"
          f"{QWEN2VL_DECODE_STEPS}) {statistics.median(dec_ms[1:]):.1f} ms "
          f"(host wall, synchronized), launches {launches}", flush=True)
    profile_step(lambda: ds.fn(params, caches, step, pos),
                 f"qwen2-vl decode step, {B} rows at position {t}", n=3)
    del model, params, caches, logits
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------- MoE

def moe_config():
    """deepseek-moe-16b at full width, cut in depth only (MOE_LAYERS of 28
    layers: 28 layers' fp32 state is 262 GB)."""
    return dataclasses.replace(get_config("deepseek-moe-16b"),
                               n_layers=MOE_LAYERS)


def moe_parity_config():
    """The parity step's model: deepseek-moe-16b reduced (d 64, 4/2 heads
    of 16, 8 experts top-2 in 2 chunks, 1 shared expert), vocab 8192 in 4
    chunks."""
    return get_config("deepseek-moe-16b").reduced(vocab=8192,
                                                  unemb_chunks=4)


def moe_group_sizes() -> dict:
    """Elements of the cut deepseek-moe-16b's flat groups at world 1, each
    a (1, N) row of B1-B5 on its paths: a layer group (attention, router,
    shared experts), an expert chunk (16 experts) and an unembedding
    chunk."""
    cfg = moe_config()
    shapes = Model(cfg, ZeroConfig(), device="cuda").param_shapes()
    return {"blocks": shapes["blocks"][1],
            "expert_chunk": shapes["experts"][2],
            "unemb_chunk": shapes["unemb"][1]}


def path_group_sizes() -> dict:
    """path -> {group: elements} of the flat groups whose B1-B5 rows ride
    in the records' extras as ``<path>_<group>``: deepseek-moe-16b's
    (``moe_group_sizes``), and the layer group of mamba2-130m (24 of
    them) and of the cut recurrentgemma-2b (a (rec, rec, local) period)."""
    out = {"deepseek_moe": moe_group_sizes()}
    for name, cfg in ssm_configs().items():
        shapes = Model(cfg, ZeroConfig(), device="cuda").param_shapes()
        out[name] = {"blocks": shapes["blocks"][1]}
    return out


def _path_keys(groups: dict, n: int) -> list:
    """The (path, group) pairs of ``path_group_sizes`` whose size is n."""
    return [(path, key) for path, sizes in groups.items()
            for key, size in sizes.items() if size == n]


def _moe_train_run(cfg, steps: int, prefetch: int) -> tuple:
    """``train_loop`` on the cut deepseek-moe-16b at ring depth
    ``prefetch`` for ``steps`` steps (bf16, full ZeRO++, world 1, --attn
    pallas, MOE_TRAIN_BATCH x MOE_TRAIN_SEQ, constant lr): (result, the
    run's launches, peak bytes)."""
    args = train_launch.parser().parse_args([
        "--batch", str(MOE_TRAIN_BATCH), "--seq", str(MOE_TRAIN_SEQ),
        "--steps", str(steps), "--lr", str(TRAIN_LR), "--lr-schedule",
        "constant", "--device", "cuda", "--attn", "pallas", "--prefetch",
        str(prefetch), "--log-every", "0"])
    args.arch = cfg
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    platform.reset_launches()
    res = train_launch.train_loop(args)
    return res, dict(platform.LAUNCHES), torch.cuda.max_memory_allocated()


def moe_train_phase() -> tuple:
    """``train_loop`` on the cut deepseek-moe-16b: MOE_TRAIN_STEPS steps at
    the default ring depth 1 (the layer ring, each layer's expert-chunk
    ring, the routing-ahead chunk-0 gather and the hpZ nested recompute
    all run on the one-rank ("data", "model") world), then MOE_SYNC_STEPS
    steps of the synchronous schedule (--prefetch 0) from the same seed
    and batches, whose losses must equal the ring's bit for bit.  Finite
    losses, the last below the first, finite ``moe_aux``; every step's
    launches ``step_launches`` (B1-B5 as ``comm_events`` counts the
    gathers and reduces, B6 twice and B7 once a layer); prints step p50,
    tokens/s, peak memory and one profiled step (device busy share, the
    expert GEMMs' ms, B1-B5 and the flash kernels).  Returns both runs'
    launches."""
    cfg = moe_config()
    res, launches, peak = _moe_train_run(cfg, MOE_TRAIN_STEPS, 1)
    built = res["built"]
    model = built.model
    per_step = step_launches(cfg, model, "pallas")
    for i, c in enumerate(res["launches"]):
        if c != per_step:
            fail(f"moe train step {i}: launches {c}, expected {per_step}")
    losses, aux = res["losses"], res["moe_aux"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"moe train: losses not finite and falling: {losses}")
    if len(aux) != len(losses) or not all(np.isfinite(aux)):
        fail(f"moe train: moe_aux not finite: {aux}")
    p50 = statistics.median(res["step_s"][1:])
    tokens = MOE_TRAIN_BATCH * MOE_TRAIN_SEQ
    total = torch.cuda.get_device_properties(0).total_memory
    tag = "train deepseek-moe-16b --attn pallas"
    print(f"{tag}: full width (d {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.d_head}, {cfg.n_experts} experts "
          f"top-{cfg.top_k} in {cfg.expert_chunks} chunks of "
          f"{model.expert_spec.padded_size:,}, {cfg.n_shared} shared, moe_ff "
          f"{cfg.moe_ff}, vocab {cfg.vocab} in {model.unemb_chunks} chunks), "
          f"{cfg.n_layers} of 28 layers, {model.n_params()} params "
          f"({model.n_active_params()} active a token) fp32 master + fp32 "
          f"moments, full ZeRO++ on a one-rank world at ring depth 1, batch "
          f"{MOE_TRAIN_BATCH} x {MOE_TRAIN_SEQ}, constant lr {TRAIN_LR}",
          flush=True)
    print(f"{tag}: losses {[round(x, 4) for x in losses]} (drop "
          f"{losses[0] - losses[-1]:.4f}); moe_aux "
          f"{[round(x, 4) for x in aux]}; entropy bound "
          f"{res['entropy_bound']:.4f}", flush=True)
    print(f"{tag}: step p50 (steps 2-{MOE_TRAIN_STEPS}) {p50 * 1e3:.1f} ms, "
          f"{tokens / p50:,.0f} tokens/s, first step "
          f"{res['step_s'][0] * 1e3:.1f} ms; peak memory "
          f"{peak / 2 ** 30:.2f} GiB of {total / 2 ** 30:.2f} GiB "
          f"(max_memory_allocated); launches per step {per_step}",
          flush=True)
    batch = train_launch.device_batch(built.arch, built.lm, MOE_TRAIN_STEPS,
                                      MOE_TRAIN_BATCH, 1, model.device)
    profile_step(lambda: built.step.fn(res["params"], res["opt"], batch),
                 f"{tag} step", ops=("aten::bmm",))
    del res, built, batch, model
    # the synchronous schedule: the same losses, bit for bit
    sync, sync_launches, _ = _moe_train_run(cfg, MOE_SYNC_STEPS, 0)
    want = step_launches(cfg, sync["built"].model, "pallas")
    for i, c in enumerate(sync["launches"]):
        if c != want:
            fail(f"moe train --prefetch 0 step {i}: launches {c}, expected "
                 f"{want}")
    same = sync["losses"] == losses[:MOE_SYNC_STEPS]
    print(f"{tag} --prefetch 0: losses {sync['losses']} vs ring depth 1 "
          f"{losses[:MOE_SYNC_STEPS]}: {'bit-identical' if same else 'DIFFERENT'}"
          f"; step p50 {statistics.median(sync['step_s']) * 1e3:.1f} ms; "
          f"launches per step {want}", flush=True)
    if not same:
        fail("moe train: the synchronous schedule's losses differ from the "
             "ring's")
    del sync
    gc.collect()
    torch.cuda.empty_cache()
    return launches, sync_launches


def moe_parity_phase() -> None:
    """Phase 4's rule on deepseek-moe-16b reduced (``moe_parity_config``),
    fp32, MOE_PARITY_ROWS x MOE_PARITY_SEQ under --attn pallas, at ring
    depth 1: the loss, the gradients, and every router call's expert
    indices equal on the card and the CPU."""
    parity_step("moe")


def moe_serve_phase() -> dict:
    """Phase 3 on the cut deepseek-moe-16b in bf16: the slab engine (4
    slots, kv_len 2048) on MOE_PROMPTS, MOE_MAX_NEW greedy tokens each
    (prefill at each prompt's own length, decode drop-free at
    ``serve_capacity``; the serving ring with its routing-ahead gather),
    held by phase 3's teacher-forced rule against each request alone;
    where a step misses it, the router margin of that step is printed.
    Returns the run's launches."""
    out = engine_phase(moe_config(), MOE_PROMPTS, MOE_MAX_NEW,
                       margins=True)
    launches = out["launches"]
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------- SSM

def ssm_configs() -> dict:
    """mamba2-130m at full width and depth; recurrentgemma-2b at full
    width cut to RG_LAYERS (two (rec, rec, local) periods and the two-layer
    rem group)."""
    return {"mamba2": get_config("mamba2-130m"),
            "recurrentgemma": dataclasses.replace(
                get_config("recurrentgemma-2b"), n_layers=RG_LAYERS)}


def rg_flash_phase(flush: torch.Tensor) -> dict:
    """B6/B7 in bf16 at recurrentgemma-2b's training shape (q (2, 4096, 10,
    256), k/v (2, 4096, 1, 256): a GQA group of 10) causal under its
    2048 window (``path_flash_phase``)."""
    return path_flash_phase(RG_FLASH_SHAPE, "recurrentgemma-2b, GQA 10",
                            "recurrentgemma", 14, flush, window=RG_WINDOW)


def ssm_train_phase(name: str) -> dict:
    """``train_loop`` on ``ssm_configs()[name]`` (bf16, full ZeRO++, world
    1, --attn pallas, constant lr) at ``SSM_TRAIN[name]``: finite losses,
    the last below the first, every step's launches ``step_launches``
    (B6/B7 on the ``local`` layers only); then one more
    ``loss_and_grads`` whose every gradient must be finite; prints step
    p50, tokens/s, peak memory and one profiled step.  Returns the run's
    launches."""
    cfg = ssm_configs()[name]
    rows, seq, n_steps = SSM_TRAIN[name]
    args = train_launch.parser().parse_args([
        "--arch", cfg.name, "--batch", str(rows), "--seq", str(seq),
        "--steps", str(n_steps), "--lr", str(TRAIN_LR), "--lr-schedule",
        "constant", "--device", "cuda", "--attn", "pallas", "--log-every",
        "0"] + (["--layers", str(cfg.n_layers)]
                if cfg != get_config(cfg.name) else []))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    platform.reset_launches()
    res = train_launch.train_loop(args)
    launches = dict(platform.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    built = res["built"]
    model = built.model
    if built.arch != cfg:
        fail(f"{name} train: the launcher built {built.arch}, not {cfg}")
    per_step = step_launches(cfg, model, "pallas")
    for i, c in enumerate(res["launches"]):
        if c != per_step:
            fail(f"{name} train step {i}: launches {c}, expected {per_step}")
    losses = res["losses"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"{name} train: losses not finite and falling: {losses}")
    batch = train_launch.device_batch(built.arch, built.lm, n_steps, rows, 1,
                                      model.device)
    _, _, grads = built.step.loss_and_grads(res["params"], batch)
    bad = [k for k, g in grads.items() if not torch.isfinite(g).all()]
    if bad:
        fail(f"{name} train: non-finite gradients in {bad}")
    gmax = max(g.abs().max().item() for g in grads.values())
    del grads
    p50 = statistics.median(res["step_s"][1:])
    total = torch.cuda.get_device_properties(0).total_memory
    tag = f"train {cfg.name} --attn pallas"
    extra = (f"d_inner {cfg.d_inner}, {cfg.ssm_heads} heads of "
             f"{cfg.ssm_headdim}, state {cfg.ssm_state}, chunk "
             f"{cfg.ssm_chunk}" if "ssd" in cfg.pattern else
             f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.d_head}, window "
             f"{cfg.window}, rnn width {cfg.d_rnn}, d_ff {cfg.d_ff}")
    print(f"{tag}: full width (d {cfg.d_model}, {extra}, vocab {cfg.vocab} "
          f"in {model.unemb_chunks} chunks), {cfg.n_layers} of "
          f"{get_config(cfg.name).n_layers} layers ({model.n_periods} x "
          f"{model.period}{f' + rem {model.rem_kinds}' if model.rem else ''}),"
          f" {model.n_params()} params fp32 master + fp32 moments, full "
          f"ZeRO++ on a one-rank world, batch {rows} x {seq}, constant lr "
          f"{TRAIN_LR}", flush=True)
    print(f"{tag}: losses {[round(x, 4) for x in losses]} (drop "
          f"{losses[0] - losses[-1]:.4f}); entropy bound "
          f"{res['entropy_bound']:.4f}; one more step's gradients all finite "
          f"(max |g| {gmax:.3e})", flush=True)
    print(f"{tag}: step p50 (steps 2-{n_steps}) {p50 * 1e3:.1f} ms, "
          f"{rows * seq / p50:,.0f} tokens/s, first step "
          f"{res['step_s'][0] * 1e3:.1f} ms; peak memory "
          f"{peak / 2 ** 30:.2f} GiB of {total / 2 ** 30:.2f} GiB "
          f"(max_memory_allocated); launches per step {per_step}",
          flush=True)
    profile_step(lambda: built.step.fn(res["params"], res["opt"], batch),
                 f"{tag} step")
    del res, built, batch, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def ssm_parity_phase() -> None:
    """Phase 4's rule on mamba2-130m and recurrentgemma-2b at full width
    cut in depth (``SSM_PARITY``), fp32, under --attn pallas."""
    for name in SSM_PARITY:
        parity_step(name)


def ssm_serve_phase(name: str) -> dict:
    """Phase 3 on ``ssm_configs()[name]`` in bf16: the slab engine (4
    slots, kv_len 2048) on ``SSM_PROMPTS[name]``, SSM_MAX_NEW greedy tokens
    each, every prompt prefilled at its exact length, held by phase 3's
    teacher-forced rule against each request alone.  Returns the run's
    launches."""
    out = engine_phase(ssm_configs()[name], SSM_PROMPTS[name], SSM_MAX_NEW)
    launches = out["launches"]
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def telemetry_check(tag: str, metrics_dir: str, res: dict) -> None:
    """The run's ``--metrics-dir`` output: ``BENCH_runtime.json`` written,
    its comm gate passed, no byte counted at world 1, a step count and a
    wall histogram of the run's length."""
    path = Path(metrics_dir) / "BENCH_runtime.json"
    if not path.exists():
        fail(f"{tag}: --metrics-dir wrote no {path.name}")
    doc = json.loads(path.read_text())["runtime"]
    m = doc["metrics"]
    sent = {k: v for k, v in m.items() if k.startswith("comm.")}
    if not (doc["gate"]["ok"] and doc["ranks_agree"]) or sent \
            or m.get("train.steps") != TRAIN_STEPS \
            or res["comm_steps"] != [{}] * TRAIN_STEPS:
        fail(f"{tag}: telemetry {doc['gate']}, comm counters {sent}, steps "
             f"{m.get('train.steps')}")
    w = m["train.step.wall_ms"]
    print(f"{tag}: --metrics-dir: {path.name} written, gate "
          f"{'PASS' if doc['gate']['ok'] else 'FAIL'} (labels "
          f"{sorted(doc['gate']['comm']['labels'])}, 0 bytes at world 1), "
          f"{m['train.steps']} steps, step wall p50 {w['p50']:.1f} ms",
          flush=True)


def overhead_reading(tag: str, fn, params, opt, batch) -> None:
    """What telemetry costs when it is on: OVERHEAD_STEPS steps as
    ``--metrics-dir`` runs them (a registry installed, so the kernel seam
    counts every call's route; the step's tracer span; then
    ``train.record_step``: counters, histogram and a flush with fsync to a
    temporary log) alternating with as many steps with telemetry off (the
    process registry, the disabled tracer), and ``overhead_gate`` on their
    medians: printed, not gated (the comm gate is the gate)."""
    d = tempfile.mkdtemp(prefix="chip_smoke_overhead_")
    reg, tracer = Registry(), Tracer(str(Path(d) / "events.jsonl"))
    on_s, off_s = [], []
    try:
        for i in range(2 * OVERHEAD_STEPS):
            on = i % 2 == 1
            old = set_registry(reg) if on else None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with annotate("train.step"), \
                    (tracer if on else get_tracer()).span("train.step",
                                                          step=i):
                metrics = fn(params, opt, batch)
                torch.cuda.synchronize()
            if on:
                train_launch.record_step(reg, tracer, i,
                                         time.perf_counter() - t0, metrics,
                                         {})
                set_registry(old)
            (on_s if on else off_s).append(time.perf_counter() - t0)
    finally:
        tracer.close()
        shutil.rmtree(d)
    g = overhead_gate(off_s, on_s)
    print(f"{tag}: telemetry on vs off, {OVERHEAD_STEPS} alternating steps "
          f"each: median {g['median_disabled_s'] * 1e3:.1f} vs "
          f"{g['median_enabled_s'] * 1e3:.1f} ms ({100 * g['rel_overhead']:+.2f}"
          f" %; overhead_gate at 2 %: {'pass' if g['ok'] else 'over'}, not "
          f"gated)", flush=True)


def _run_spec(run) -> dict:
    """A multi-rank run: an argv list, or {"argv", "zero": ZeroConfig
    overrides (the paper's knobs), "profile": whether rank 0 profiles a
    step after the run (default True), "layers": the arch's depth cut to
    this many layers (default: its own)}."""
    return run if isinstance(run, dict) else {"argv": run}


def multirank_rank(rank: int, world: int, runs: list) -> list:
    """One rank of a multi-rank phase (a spawned process on device 0): for
    each run of ``runs`` in turn (:func:`_run_spec`), the launcher's loop,
    then one profiled step on rank 0 (the other ranks make the same
    calls).  Returns what the host checks, one dict per run."""
    outs = []
    for run in runs:
        spec = _run_spec(run)
        args = train_launch.parser().parse_args(spec["argv"])
        if spec.get("layers"):       # a depth cut of the arch
            args.arch = dataclasses.replace(get_config(args.arch),
                                            n_layers=spec["layers"])
        torch.cuda.reset_peak_memory_stats()
        res = train_launch.train_loop(args, overrides=spec.get("zero"))
        built = res["built"]
        z, rs = built.model.zcfg, built.step.run_spec
        batch = train_launch.device_batch(built.arch, built.lm, args.steps,
                                          args.batch, 1, built.model.device)
        prof = None
        if spec.get("profile", True):
            prof = profile_step(
                lambda: built.step.fn(res["params"], res["opt"], batch),
                f"multi-rank train step, rank {rank} of {world}, mesh "
                f"{args.mesh}, batch {args.batch}, sequence over "
                f"{rs.seq_axes}, prefetch {z.prefetch}, overrides "
                f"{spec.get('zero') or {}}", show=rank == 0)
        # a sharded sequence keeps the flash kernels out (mha's rule)
        per_step = step_launches(built.arch, built.model,
                                 "xla" if rs.seq_axes else args.attn)
        # the non-blocked qwZ gather on the card against the host's
        # quantize_global / dequantize_global of the same shards
        nb_err = (_nonblocked_gather_err(res["params"]["blocks"][0], z)
                  if not z.qwz_blocked else None)
        outs.append({"losses": res["losses"], "step_s": res["step_s"],
                     "nonblocked_err": nb_err,
                     "launches": res["launches"], "want": per_step,
                     "comm": res["comm_steps"], "tiers": res["tier_steps"],
                     "save_s": res["save_s"], "gate": res["gate"],
                     "agree": res["ranks_agree"],
                     "peak": res["peak_bytes"], "profile": prof,
                     "prefetch": z.prefetch, "seq_axes": rs.seq_axes,
                     "shard": built.model.param_shapes()["blocks"][1]
                     // world})
        del res, built, batch
        gc.collect()
        torch.cuda.empty_cache()
    return outs


def _nonblocked_gather_err(shard: torch.Tensor, z: ZeroConfig) -> float:
    """This rank's non-blocked qwZ gather of ``shard`` (a layer group's
    fp32 master shard on the card, ``zeropp.fwd_gather``: one scale a
    shard, the world's payloads and scales gathered) against every rank's
    shard quantized and dequantized on the host, shard by shard, in
    ``compute_dtype``: the largest |difference| (0: bit-identical)."""
    import torch.distributed as dist
    from repro_torch.core import quant, zeropp
    got = zeropp.fwd_gather(shard, z).cpu()
    host = shard.cpu()
    shards = [torch.empty_like(host) for _ in range(dist.get_world_size())]
    dist.all_gather(shards, host)
    want = torch.cat([quant.dequantize_global(
        *quant.quantize_global(s, z.qwz_bits), z.qwz_bits, z.compute_dtype)
        for s in shards])
    if got.dtype != want.dtype or got.shape != want.shape:
        return float("inf")
    return float((got.float() - want.float()).abs().max())


def _mr_argv(batch: int, steps: int, *extra, mesh=MR_MESH) -> list:
    """A multi-rank run's argv, with the launcher's telemetry and its
    strict gate on (``--metrics-dir`` a temporary directory that
    ``_mr_spawn`` removes)."""
    return ["--arch", "qwen3-0.6b", "--batch", str(batch), "--seq",
            str(TRAIN_SEQ), "--steps", str(steps), "--lr", str(TRAIN_LR),
            "--lr-schedule", "constant", "--device", "cuda", "--attn",
            "pallas", "--mesh", "x".join(map(str, mesh)), "--metrics-dir",
            tempfile.mkdtemp(prefix="chip_smoke_obs_"), "--obs-gate",
            *extra]


def _metrics_dir(run) -> str:
    argv = _run_spec(run)["argv"]
    return argv[argv.index("--metrics-dir") + 1]


def _mr_spawn(runs: list, tag: str, mesh=MR_MESH) -> list:
    """Spawn the ``mesh`` world (default 2 x 2) on ``runs``; check every
    rank's launches per step and that the ranks agree on the losses;
    returns, per run, every rank's result."""
    from repro_torch.launch import mesh as mesh_lib
    world = int(np.prod(mesh))
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        ranks = mesh_lib.spawn(multirank_rank, world, runs, device="cuda",
                               timeout=MR_TIMEOUT_S)
        for run in runs:
            d = Path(_metrics_dir(run))
            if not (d / "BENCH_runtime.json").exists():
                fail(f"{tag}: rank 0 wrote no BENCH_runtime.json in {d}")
    finally:
        for run in runs:
            shutil.rmtree(_metrics_dir(run))
    print(f"{tag}: spawn to exit {time.perf_counter() - t0:.1f} s",
          flush=True)
    y, x = world // mesh[-1], mesh[-1]
    lay = ZeroConfig().align(y * x) // (y * x)
    per_run = [[r[i] for r in ranks] for i in range(len(runs))]
    for i, outs in enumerate(per_run):
        for r, out in enumerate(outs):
            if out["shard"] % lay:
                fail(f"{tag} rank {r}: layer shard {out['shard']} is not a "
                     f"multiple of {lay} (ZeroConfig.align({y * x}))")
            for j, c in enumerate(out["launches"]):
                if c != out["want"]:
                    fail(f"{tag} run {i} rank {r} step {j}: launches {c}, "
                         f"expected {out['want']}")
        if any(out["losses"] != outs[0]["losses"] for out in outs):
            fail(f"{tag}: ranks disagree on the summed losses "
                 f"{[out['losses'] for out in outs]}")
    return per_run


def tier_mib(tiers: dict) -> dict:
    """A rank's step by tier ({tier: bytes, "<tier>.other": bytes}) as
    {tier: MiB less ``other``'s share}, the ``zero.*`` bytes a tier."""
    return {k: (b - tiers.get(k + ".other", 0)) / 2 ** 20
            for k, b in tiers.items() if "." not in k}


def wire_report(tag: str, outs: list, want_mib: dict = None) -> None:
    """The launcher's comm gate as every rank reports it (``--obs-gate``:
    each step's wire bytes per label within 1 % of the port's projection
    for this world, ``other`` reported and not projected, and the ranks
    agreeing; a miss has already failed the rank): checked once more
    here, then printed in MiB a rank a step, measured / projected.  With
    ``want_mib`` ({label: MiB, 3 decimals}, the reference projection's)
    every rank's bytes must equal the projection to the byte and the
    projection must read those MiB.  The same bytes by interconnect tier
    (``comm.tier.<tier>.bytes``) must sum to the labels' on every rank at
    every step; rank 0's first step is printed by tier."""
    for r, out in enumerate(outs):
        if not (out["gate"]["ok"] and out["agree"]):
            fail(f"{tag} rank {r}: comm gate {out['gate']}, ranks agree "
                 f"{out['agree']}")
        for j, (c, t) in enumerate(zip(out["comm"], out["tiers"])):
            if train_launch.tier_total(t) != sum(c.values()):
                fail(f"{tag} rank {r} step {j}: tiers {t} do not sum to the "
                     f"labels {c}")
    rows = outs[0]["gate"]["comm"]["labels"]
    projected = {k: row["projected"] for k, row in rows.items()
                 if k != "other"}
    exact = all(s.get(k, 0) == b for out in outs for s in out["comm"]
                for k, b in projected.items())
    if want_mib is not None:
        mib = {k: round(b / 2 ** 20, 3) for k, b in projected.items()}
        if not exact or mib != want_mib:
            fail(f"{tag}: projection {mib} MiB (want {want_mib}), every "
                 f"rank equal to it to the byte: {exact}")
    c = outs[0]["comm"][0]
    print(f"{tag}: wire MiB a rank a step, measured / projected: " + ", ".join(
        f"{k} {c.get(k, 0) / 2 ** 20:.3f} / {b / 2 ** 20:.3f}"
        for k, b in sorted(projected.items()))
        + f", other {c.get('other', 0):,.0f} B (not projected); the "
        + f"launcher's gate passed on all {len(outs)} ranks, which agree "
        + "at every step, "
        + ("equal to the projection to the byte" if exact
           else "within 1 % of the projection"), flush=True)
    t = outs[0]["tiers"][0]
    print(f"{tag}: by tier, MiB a rank a step less other: " + ", ".join(
        f"{k} {v:.3f}" for k, v in tier_mib(t).items())
        + "; other " + ", ".join(f"{k} {b:,.0f} B" for k, b in t.items()
                                 if k.endswith(".other"))
        + f"; the tiers sum to the labels on all {len(outs)} ranks at every "
        + "step", flush=True)


def _mr_report(tag: str, outs: list, rows: int) -> dict:
    """Print each rank's step p50, peak and launches and rank 0's profiled
    step; returns the launches summed over the ranks and the run."""
    tokens = rows * TRAIN_SEQ
    n = len(outs[0]["losses"])
    for r, out in enumerate(outs):
        p50 = statistics.median(out["step_s"][1:])
        print(f"{tag} rank {r}: step p50 (steps 2-{n}) {p50 * 1e3:.1f} ms "
              f"({tokens / p50:,.0f} tokens/s for the world), first step "
              f"{out['step_s'][0] * 1e3:.1f} ms; peak memory "
              f"{out['peak'] / 2 ** 30:.2f} GiB (max_memory_allocated); "
              f"launches per step {out['want']} x {n} steps", flush=True)
    prof = outs[0]["profile"]
    if prof is None:
        return {k: sum(sum(c[k] for c in out["launches"]) for out in outs)
                for k in platform.LAUNCHES}
    print(f"{tag}: rank 0's profiled step: host wall {prof['wall']:.1f} ms, "
          f"its device busy {prof['busy']:.1f} ms "
          f"({100 * prof['busy'] / prof['wall']:.1f}%), gloo collectives "
          f"{prof['gloo']:.1f} ms of host time "
          f"({100 * prof['gloo'] / prof['wall']:.1f}%)", flush=True)
    return {k: sum(sum(c[k] for c in out["launches"]) for out in outs)
            for k in platform.LAUNCHES}


def multirank_runs(ckpt_dir: str) -> list:
    """Phase 6's runs: MR_STEPS steps at the default prefetch ring (depth
    1), then MR_SYNC_STEPS at --prefetch 0, which saves a checkpoint into
    ``ckpt_dir`` after its last step (``--ckpt-every``: every rank its own
    shard file)."""
    return [_mr_argv(TRAIN_BATCH, MR_STEPS),
            _mr_argv(TRAIN_BATCH, MR_SYNC_STEPS, "--prefetch", "0",
                     "--ckpt-dir", ckpt_dir, "--ckpt-every",
                     str(MR_SYNC_STEPS))]


def multirank_phase(world1_losses: list, ring: list, sync: list) -> tuple:
    """qwen3-0.6b at full width on a Y x X = 2 x 2 world: four rank
    processes sharing the card over a gloo group, full ZeRO++ under --attn
    pallas, the world-1 pallas phase's seed, batches and lr, the runs of
    ``multirank_runs`` (every rank's results: ``ring``, ``sync``).  Holds
    the ring's losses against that phase's (``world1_losses``), the
    synchronous run's against the ring's first steps bit for bit, and
    every rank's launches; returns the launches summed over the ranks, of
    the ring run and of the synchronous run, the ring's losses, its rank
    0's first step by tier and every rank's save seconds."""
    y, x = MR_MESH
    tag = f"train {y}x{x}"
    if ring[0]["prefetch"] != 1 or sync[0]["prefetch"] != 0:
        fail(f"{tag}: prefetch {ring[0]['prefetch']} / {sync[0]['prefetch']}"
             f", expected 1 / 0")
    print(f"{tag}: {y * x} ranks (Y {y} inter x X {x} intra) sharing one "
          f"card over gloo, qwen3-0.6b full width, full ZeRO++ (qwZ INT8, "
          f"hpZ on the intra pair, qgZ INT4 2-hop: B3/B4 at N = {x}, B5 at "
          f"N = {y}), --attn pallas, global batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} ({TRAIN_BATCH // (y * x)} rows a rank), constant lr "
          f"{TRAIN_LR}; layer shard {ring[0]['shard']:,} a rank; the "
          f"prefetch ring at depth 1, then {MR_SYNC_STEPS} steps of the "
          f"synchronous schedule (--prefetch 0)", flush=True)
    losses = ring[0]["losses"]
    ref = world1_losses[:MR_STEPS]
    d1 = abs(losses[0] - ref[0])
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
    print(f"{tag}: losses {[round(v, 4) for v in losses]} vs world 1 "
          f"{[round(v, 4) for v in ref]}: step 1 |diff| {d1:.2e} (bar "
          f"{MR_LOSS1_ATOL}), relative {[f'{v:.2e}' for v in rel]} (bar "
          f"{MR_REL})", flush=True)
    sl = sync[0]["losses"]
    print(f"{tag}: --prefetch 0 losses {sl!r} vs the ring's first "
          f"{MR_SYNC_STEPS} {losses[:MR_SYNC_STEPS]!r}: "
          f"{'bit-identical' if sl == losses[:MR_SYNC_STEPS] else 'DIFFER'}",
          flush=True)
    if not all(np.isfinite(losses)):
        fail(f"{tag}: non-finite loss {losses}")
    if not d1 <= MR_LOSS1_ATOL:
        fail(f"{tag}: step-1 loss {losses[0]} vs world 1's {ref[0]}")
    if not losses[-1] < losses[0]:
        fail(f"{tag}: the loss did not fall over the run {losses}")
    if not max(rel) < MR_REL:
        fail(f"{tag}: losses beyond {MR_REL} of world 1's")
    if sl != losses[:MR_SYNC_STEPS]:
        fail(f"{tag}: the synchronous schedule's losses {sl} are not the "
             f"ring's {losses[:MR_SYNC_STEPS]}")
    wire_report(f"{tag} prefetch 1", ring)
    wire_report(f"{tag} prefetch 0", sync)
    cfg = get_config("qwen3-0.6b")
    n = Model(cfg, ZeroConfig.local(), device="cpu").n_params()
    v = comm_volume_per_step(n, ZeroConfig())
    print(f"{tag}: Table 1 for qwen3-0.6b ({n:,} params): ZeRO-3 "
          f"{v['baseline_total'] / 2 ** 20:.3f} MiB a step (3M), ZeRO++ "
          f"{v['total'] / 2 ** 20:.3f} MiB (qwZ {v['fwd_allgather'] / 2 ** 20:.3f}"
          f" + hpZ {v['bwd_allgather']} + qgZ "
          f"{v['grad_reduce'] / 2 ** 20:.3f}): a {v['reduction_factor']:.3f}x "
          f"cut", flush=True)
    return (_mr_report(f"{tag} prefetch 1", ring, TRAIN_BATCH),
            _mr_report(f"{tag} prefetch 0", sync, TRAIN_BATCH), losses,
            ring[0]["tiers"][0], [out["save_s"] for out in sync])


def cut_config():
    """qwen3-0.6b at full width, cut to CUT_LAYERS layers."""
    return dataclasses.replace(get_config("qwen3-0.6b"), n_layers=CUT_LAYERS)


def cut_world1_losses() -> list:
    """The world-1 pallas run of the cut model (phase 5's seed, batches and
    lr, MP_STEPS steps), the 2 x 2 x 2 phase's step-1 reference."""
    args = train_launch.parser().parse_args([
        "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--steps",
        str(MP_STEPS), "--lr", str(TRAIN_LR), "--lr-schedule", "constant",
        "--device", "cuda", "--attn", "pallas", "--log-every", "0"])
    args.arch = cut_config()
    gc.collect()
    torch.cuda.empty_cache()
    res = train_launch.train_loop(args)
    per_step = step_launches(res["built"].arch, res["built"].model, "pallas")
    if any(c != per_step for c in res["launches"]):
        fail(f"world 1 at {CUT_LAYERS} layers: launches {res['launches']}, "
             f"expected {per_step}")
    losses = res["losses"]
    print(f"world 1, qwen3-0.6b at {CUT_LAYERS} of its 28 layers, --attn "
          f"pallas, batch {TRAIN_BATCH} x {TRAIN_SEQ}: losses {losses!r}",
          flush=True)
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return losses


def seq_parallel_run() -> list:
    """Phase 7's run: the 2 x 2 world at a global batch of SP_BATCH rows,
    SP_STEPS steps at the default ring."""
    return _mr_argv(SP_BATCH, SP_STEPS)


def seq_world1_loss() -> float:
    """The world-1 --attn xla step on phase 7's rows from the same seed:
    phase 7's step-1 reference."""
    args = train_launch.parser().parse_args([
        "--arch", "qwen3-0.6b", "--batch", str(SP_BATCH), "--seq",
        str(TRAIN_SEQ), "--steps", "1", "--lr", str(TRAIN_LR),
        "--lr-schedule", "constant", "--device", "cuda", "--attn", "xla",
        "--log-every", "0"])
    gc.collect()
    torch.cuda.empty_cache()
    one = train_launch.train_loop(args)["losses"][0]
    gc.collect()
    torch.cuda.empty_cache()
    return one


def seq_parallel_phase(one: float, outs: list) -> dict:
    """The 2 x 2 world at a global batch of SP_BATCH rows (``outs``: every
    rank's results of ``seq_parallel_run``): the batch covers only
    ``data``, so every rank holds one row's half of the sequence (1,024
    tokens) and ``mha`` gathers K/V over the intra pair; --attn pallas
    (which a sharded sequence keeps out of the flash kernels, the
    reference's rule).  Its step-1 loss is held against ``one``
    (``seq_world1_loss``); returns the launches summed over the ranks."""
    y, x = MR_MESH
    tag = f"train {y}x{x} sequence-parallel"
    if outs[0]["seq_axes"] != ("model",):
        fail(f"{tag}: the sequence went over {outs[0]['seq_axes']}, "
             f"expected ('model',)")
    losses = outs[0]["losses"]
    d1 = abs(losses[0] - one)
    print(f"{tag}: 4 ranks, qwen3-0.6b full width, full ZeRO++, --attn "
          f"pallas, global batch {SP_BATCH} x {TRAIN_SEQ}: rows over data, "
          f"the sequence over {outs[0]['seq_axes']} (1 row x "
          f"{TRAIN_SEQ // x} tokens a rank), prefetch {outs[0]['prefetch']}"
          f"; losses {[round(v, 4) for v in losses]}; step 1 vs world 1 "
          f"--attn xla on the same rows {one:.6f}: |diff| {d1:.2e} (bar "
          f"{MR_LOSS1_ATOL})", flush=True)
    if not all(np.isfinite(losses)):
        fail(f"{tag}: non-finite loss {losses}")
    if not d1 <= MR_LOSS1_ATOL:
        fail(f"{tag}: step-1 loss {losses[0]} vs world 1's {one}")
    if not losses[-1] < losses[0]:
        fail(f"{tag}: the loss did not fall over the run {losses}")
    wire_report(tag, outs)
    return _mr_report(tag, outs, SP_BATCH)


def knob_runs() -> list:
    """Phase 8's runs: KNOB_STEPS steps of each of KNOBS (ZeroConfig
    overrides through ``train_loop(overrides=)``, as the reference's
    convergence benchmark passes them to make_policy), unprofiled."""
    return [{"argv": _mr_argv(TRAIN_BATCH, KNOB_STEPS), "zero": over,
             "profile": False} for over in KNOBS.values()]


def knob_phase(losses_2x2: list, tiers_2x2: dict, per_run: list) -> dict:
    """The paper's ablation knobs on the 2 x 2 world: qwen3-0.6b at full
    width, --attn pallas, batch 8, phase 6's seed, batches and lr
    (``per_run``: every rank's results of ``knob_runs``).  Each run's
    launcher gate must pass on every rank with the reference projection's
    MiB (KNOB_MIB) to the byte, its losses be finite, and its step-1 and
    step-2 losses hold phase 6's (``losses_2x2``) as the KNOBS note says.
    The 1-hop qgZ's bytes on the slow tier (``data``) must exceed, and its
    bytes on the fast tier (``model``) fall short of, the 2-hop's of phase
    6 (``tiers_2x2``), as the reference's ``per_tier_wire`` orders them at
    this shape (``tests/test_torch_wire.py``).  Returns {path: launches
    summed over the ranks}."""
    y, x = MR_MESH
    tag = f"train {y}x{x} knobs"
    out = {}
    for (name, over), outs in zip(KNOBS.items(), per_run):
        losses = outs[0]["losses"]
        t = f"{tag} {name} {over}"
        grad_side = name != "qwz_nonblocked"
        diff = [abs(a - b) for a, b in zip(losses, losses_2x2)]
        print(f"{t}: losses {losses!r} vs phase 6's {losses_2x2[:KNOB_STEPS]!r}"
              f": step 1 {'bit-identical' if losses[0] == losses_2x2[0] else 'differs'}"
              f" (bar: {'bit-identical' if grad_side else MR_LOSS1_ATOL}), "
              f"|diff| {[f'{v:.2e}' for v in diff]} (bar {MR_LOSS1_ATOL})",
              flush=True)
        if not all(np.isfinite(losses)):
            fail(f"{t}: non-finite loss {losses}")
        if grad_side and losses[0] != losses_2x2[0]:
            fail(f"{t}: step-1 loss {losses[0]!r} is not phase 6's "
                 f"{losses_2x2[0]!r}: the knob moved the forward")
        if not max(diff) <= MR_LOSS1_ATOL:
            fail(f"{t}: losses beyond {MR_LOSS1_ATOL} of phase 6's")
        if not grad_side:
            errs = [out["nonblocked_err"] for out in outs]
            print(f"{t}: each rank's non-blocked gather of layer group 0 on "
                  f"the card vs quantize_global / dequantize_global of "
                  f"every shard on the host: max |diff| {errs} (bar: "
                  f"bit-identical)", flush=True)
            if any(e != 0.0 for e in errs):
                fail(f"{t}: the non-blocked gather differs from "
                     f"quantize_global / dequantize_global: {errs}")
        wire_report(t, outs, KNOB_MIB[name])
        if name == "qgz_1hop":
            one, two = tier_mib(outs[0]["tiers"][0]), tier_mib(tiers_2x2)
            print(f"{t}: the 1-hop's MiB a rank a step by tier {one} vs the "
                  f"2-hop's (phase 6) {two}: slow tier (data) "
                  f"{one['data'] / two['data']:.3f}x, fast tier (model) "
                  f"{one['model'] / two['model']:.3f}x", flush=True)
            if not (one["data"] > two["data"] and one["model"] < two["model"]):
                fail(f"{t}: the 1-hop does not move bytes from the fast tier "
                     f"to the slow one: {one} vs {two}")
        out[f"train_{y}x{x}_{name}"] = _mr_report(t, outs, TRAIN_BATCH)
    return out


def multipod_phase(world1_losses: list) -> tuple:
    """The 2 x 2 x 2 ("pod", "data", "model") world: eight rank processes
    of qwen3-0.6b at full width cut to CUT_LAYERS, sharing the card over
    gloo, --attn pallas, batch 8 (one row a rank), phase 5's seed,
    batches and lr:
    MP_STEPS steps at the default config (hpZ on the intra pair, qgZ's
    inter hop over ("pod", "data"): B5 at N = 4), then MP_HPZ_STEPS with
    ``hpz_axes=("data", "model")`` (the secondary group one pod), in one
    spawn.  The gate on every rank (MP_MIB, MP_HPZ_MIB), finite losses,
    the step-1 loss within MR_LOSS1_ATOL of world 1's on the same rows and
    model (``world1_losses``: ``cut_world1_losses``) and the hpZ run's
    equal to the default's bit for bit (the same forward); prints each
    rank's steps and peak and rank 0's profiled step (wall, busy share,
    gloo time by label). Returns the launches summed over the ranks of
    both runs.
    """
    tag = "train " + "x".join(map(str, MP_MESH))
    base, hpz = _mr_spawn(
        [{"argv": _mr_argv(TRAIN_BATCH, MP_STEPS, mesh=MP_MESH),
          "layers": CUT_LAYERS},
         {"argv": _mr_argv(TRAIN_BATCH, MP_HPZ_STEPS, mesh=MP_MESH),
          "zero": {"hpz_axes": ("data", "model")}, "profile": False,
          "layers": CUT_LAYERS}],
        tag, mesh=MP_MESH)
    losses, hl = base[0]["losses"], hpz[0]["losses"]
    d1 = abs(losses[0] - world1_losses[0])
    print(f"{tag}: 8 ranks (pod 2 x data 2 x model 2) sharing one card over "
          f"gloo, qwen3-0.6b full width at {CUT_LAYERS} of its 28 layers, "
          f"full ZeRO++ (hpZ on the model "
          f"pair, qgZ's inter hop over (pod, data): B5 at N = 4), --attn "
          f"pallas, global batch {TRAIN_BATCH} x {TRAIN_SEQ} (1 row a "
          f"rank); losses {[round(v, 4) for v in losses]}, step 1 vs world "
          f"1 {world1_losses[0]:.6f}: |diff| {d1:.2e} (bar "
          f"{MR_LOSS1_ATOL}); hpz_axes=('data', 'model') losses {hl!r}",
          flush=True)
    if not all(np.isfinite(losses + hl)):
        fail(f"{tag}: non-finite loss {losses} {hl}")
    if not d1 <= MR_LOSS1_ATOL:
        fail(f"{tag}: step-1 loss {losses[0]} vs world 1's "
             f"{world1_losses[0]}")
    if hl[0] != losses[0]:
        fail(f"{tag}: the pod-wide hpZ run's step-1 loss {hl[0]!r} is not "
             f"the default's {losses[0]!r}")
    wire_report(tag, base, MP_MIB)
    wire_report(f"{tag} hpz_axes=('data', 'model')", hpz, MP_HPZ_MIB)
    report = _mr_report(tag, base, TRAIN_BATCH)
    labels = base[0]["profile"]["labels"]
    print(f"{tag}: rank 0's gloo host time by label (issue + wait, ms): "
          + ", ".join(f"{k} {labels.get(k, 0.0) + labels.get(k + '.wait', 0.0):.1f}"
                      for k in sorted({k.removesuffix('.wait')
                                       for k in labels})), flush=True)
    return report, _mr_report(f"{tag} hpz_axes=('data', 'model')", hpz,
                              TRAIN_BATCH)


# ------------------------------------------------------------- checkpoints

def _dir_bytes(path: str) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def _with_fsync_clock(fn):
    """``fn()`` with ``os.fsync`` timed: (its result, the seconds spent in
    fsync calls)."""
    real, spent = os.fsync, [0.0]

    def timed(fd):
        t0 = time.perf_counter()
        real(fd)
        spent[0] += time.perf_counter() - t0
    os.fsync = timed
    try:
        return fn(), spent[0]
    finally:
        os.fsync = real


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _max_diff(a: dict, b: dict) -> float:
    """The largest |a - b| over every buffer of two params dicts."""
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def _states_equal(a: dict, b: dict) -> bool:
    from repro_torch.train.state import flatten_state
    fa, fb = flatten_state(a), flatten_state(b)
    return fa.keys() == fb.keys() and all(
        fa[k].device == fb[k].device and torch.equal(fa[k], fb[k])
        for k in fa)


def check_disk(root: str) -> None:
    du = shutil.disk_usage(root)
    print(f"checkpoint: {root}: {du.free / 1e9:.1f} GB free of "
          f"{du.total / 1e9:.1f} GB (shutil.disk_usage)", flush=True)
    if du.free < CKPT_FREE_GB * 1e9:
        fail(f"checkpoint: {root} has {du.free / 1e9:.1f} GB free, the "
             f"checkpoint phase needs {CKPT_FREE_GB} GB")


def checkpoint_phase(root: str, losses_pallas: list) -> dict:
    """World 1, qwen3-0.6b at full width, --attn pallas, phase 5's seed,
    batch and lr: CKPT_STEPS steps through the launcher's loop saving an
    fp32 checkpoint (--ckpt-every), an INT8 save of the same state, both
    restored into fresh tensors on the card; step CKPT_STEPS + 1 from the
    in-memory state twice and from the fp32 restore (bit-identical, or
    the restore within the in-memory spread), the INT8 restore's blocks and
    next two losses at the reference's bars; then ``ServeEngine.
    from_checkpoint`` on the INT8 checkpoint against an engine given
    ``load_global`` -> ``fit_to`` -> bf16 of it in memory.  Returns the
    launches of the restored steps and of the booted engine's run, and the
    INT8 checkpoint's path (kept) with the world-1 model and params booted
    from it, for the sharded serving phase."""
    from repro_torch.train.state import (ZeroState, fit_to, load_global,
                                         read_manifest)
    tag = "checkpoint world 1"
    d32, d8 = Path(root) / "w1_fp32", Path(root) / "w1_int8"
    args = train_launch.parser().parse_args([
        "--arch", "qwen3-0.6b", "--batch", str(TRAIN_BATCH), "--seq",
        str(TRAIN_SEQ), "--steps", str(CKPT_STEPS), "--lr", str(TRAIN_LR),
        "--lr-schedule", "constant", "--device", "cuda", "--attn", "pallas",
        "--log-every", "0", "--ckpt-dir", str(d32), "--ckpt-every",
        str(CKPT_STEPS), "--ckpt-format", "fp32"])
    gc.collect()
    torch.cuda.empty_cache()
    res, fsync32 = _with_fsync_clock(lambda: train_launch.train_loop(args))
    built, params, opt = res["built"], res["params"], res["opt"]
    model, mesh = built.model, built.mesh
    p32 = d32 / f"ckpt_{CKPT_STEPS}"
    print(f"{tag}: {CKPT_STEPS} steps of phase 5's run (losses "
          f"{res['losses']!r}; phase 5 {losses_pallas[:CKPT_STEPS]!r}: "
          f"{'bit-identical' if res['losses'] == losses_pallas[:CKPT_STEPS] else 'differ'}"
          f"), saved by --ckpt-every {CKPT_STEPS}: {p32.name}", flush=True)
    st = ZeroState(model, mesh, params, opt, step=CKPT_STEPS,
                   meta={"world": 1, "arch": built.arch.name,
                         "data_cursor": CKPT_STEPS})
    t0 = time.perf_counter()
    p8, fsync8 = _with_fsync_clock(lambda: st.save(str(d8), fmt="int8"))
    save8 = time.perf_counter() - t0
    b32, b8 = _dir_bytes(p32), _dir_bytes(p8)
    man = read_manifest(p8)
    print(f"{tag}: fp32 save {res['save_s'][0]:.2f} s (fsync "
          f"{fsync32:.2f} s), {b32 / 1e9:.3f} GB; INT8 save {save8:.2f} s "
          f"(fsync {fsync8:.2f} s), {b8 / 1e9:.3f} GB: {b8 / b32:.4f} of "
          f"the fp32 one (bar {CKPT_INT8_SIZE}); {model.n_params():,} "
          f"params, padded buffers {sum(int(np.prod(v.shape)) for v in params.values()):,}",
          flush=True)
    if not b8 < CKPT_INT8_SIZE * b32:
        fail(f"{tag}: the INT8 checkpoint is {b8 / b32:.4f} of the fp32 one")
    if man["format"] != "int8_blockwise" or not all(
            v["quantized"] for v in man["layout"].values()
            if not v["replicated"]):
        fail(f"{tag}: the INT8 checkpoint stores a buffer raw: "
             f"{man['layout']}")
    t0 = time.perf_counter()
    r32 = ZeroState.restore(model, mesh, str(d32))
    torch.cuda.synchronize()
    load32 = time.perf_counter() - t0
    t0 = time.perf_counter()
    r8 = ZeroState.restore(model, mesh, str(d8))
    torch.cuda.synchronize()
    load8 = time.perf_counter() - t0
    if r32.step != CKPT_STEPS or r32.meta["world"] != 1:
        fail(f"{tag}: restored step {r32.step}, meta {r32.meta}")
    if not _states_equal({"p": r32.params, "o": r32.opt},
                         {"p": params, "o": opt}):
        fail(f"{tag}: the fp32 restore is not the saved state bit for bit "
             f"on the card")
    worst = 0.0
    for k, want in params.items():
        got = r8.params[k]
        if got.device.type != "cuda":
            fail(f"{tag}: the INT8 restore placed {k} on {got.device}")
        n = want.shape[-1]
        wb = want.reshape(*want.shape[:-1], n // 256, 256)
        bound = wb.abs().amax(-1, keepdim=True) / 127.0 * 0.6 + 1e-8
        ratio = float(((got.reshape(wb.shape) - wb).abs() / bound).max())
        worst = max(worst, ratio)
    print(f"{tag}: restores into fresh tensors on the card: fp32 "
          f"{load32:.2f} s (bit-identical to the saved state), INT8 "
          f"{load8:.2f} s (every parameter block within "
          f"{worst:.4f} of its bound absmax/127 * 0.6 + 1e-8)", flush=True)
    if worst > 1.0:
        fail(f"{tag}: an INT8-restored block exceeds its bound ({worst})")
    # step CKPT_STEPS + 1: twice from the in-memory state, once from the
    # fp32 restore
    batch = train_launch.device_batch(built.arch, built.lm, CKPT_STEPS,
                                      TRAIN_BATCH, 1, model.device)
    twin = _clone({"p": params, "o": opt})
    fn = built.step.fn
    la = float(fn(params, opt, batch)["loss"])
    lb = float(fn(twin["p"], twin["o"], batch)["loss"])
    platform.reset_launches()
    lr = float(fn(r32.params, r32.opt, batch)["loss"])
    launches = dict(platform.LAUNCHES)
    same = la == lb and _states_equal(params, twin["p"])
    spread = 0.0 if same else _max_diff(params, twin["p"])
    d_restored = _max_diff(params, r32.params)
    print(f"{tag}: step {CKPT_STEPS + 1} twice from the in-memory state: "
          f"losses {la!r} / {lb!r}, "
          + ("bit-identical" if same else
             f"params differ by up to {spread:.3e} (the card's step does not "
             f"repeat bit for bit)")
          + f"; from the fp32 restore: loss {lr!r}, params differ by "
          f"{d_restored:.3e}", flush=True)
    if same and (lr != la or d_restored != 0.0):
        fail(f"{tag}: the restored step differs from the in-memory one")
    if not same and (abs(lr - la) > abs(lb - la) or d_restored > spread):
        fail(f"{tag}: the restored step is outside the in-memory spread")
    del twin
    gc.collect()
    lf = [lr, float(fn(r32.params, r32.opt, train_launch.device_batch(
        built.arch, built.lm, CKPT_STEPS + 1, TRAIN_BATCH, 1,
        model.device))["loss"])]
    del r32
    gc.collect()
    torch.cuda.empty_cache()
    lq = [float(fn(r8.params, r8.opt, train_launch.device_batch(
        built.arch, built.lm, i, TRAIN_BATCH, 1, model.device))["loss"])
        for i in (CKPT_STEPS, CKPT_STEPS + 1)]
    rel = [abs(a - b) / abs(b) for a, b in zip(lq, lf)]
    print(f"{tag}: the next two losses from the INT8 restore {lq!r} vs the "
          f"fp32 restore's {lf!r}: relative {[f'{v:.2e}' for v in rel]} "
          f"(bar {CKPT_REL_INT8})", flush=True)
    if not max(rel) < CKPT_REL_INT8:
        fail(f"{tag}: INT8-restored losses beyond {CKPT_REL_INT8}")
    del res, built, params, opt, st, r8, batch
    gc.collect()
    torch.cuda.empty_cache()
    serve, model1, params1 = serve_boot(p8)
    shutil.rmtree(d32)
    return {"train_ckpt": launches, "serve_ckpt": serve}, (p8, model1,
                                                          params1)


def serve_boot(path: Path) -> dict:
    """``ServeEngine.from_checkpoint`` on the INT8 checkpoint ``path``
    against an engine given ``load_global`` -> ``fit_to`` -> bf16 of it:
    the same bf16 params, the first N_SLOTS prompts of phase 3 served
    greedily to the same tokens, the first prefill's logits bit-identical;
    a model of another arch refuses the checkpoint.  Returns the booted
    engine's launches over its run, and its world-1 model and params
    (bf16 of ``fit_to`` of ``load_global``: the sharded phase's
    reference)."""
    from repro_torch.train.state import fit_to, load_global
    tag = "checkpoint serving boot"
    cfg = get_config("qwen3-0.6b")
    model = Model(cfg, ZeroConfig(dp_axes=("model",)), world=1,
                  device="cuda")
    t0 = time.perf_counter()
    eng = ServeEngine.from_checkpoint(model, str(path), n_slots=N_SLOTS,
                                      kv_len=KV_LEN)
    torch.cuda.synchronize()
    boot = time.perf_counter() - t0
    _, tree, meta = load_global(str(path), prefix="params")
    shapes = model.param_shapes()
    mem = {k: torch.from_numpy(fit_to(v, shapes[k])).to("cuda",
                                                         torch.bfloat16)
           for k, v in tree["params"].items()}
    del tree
    if not _states_equal(eng.params, mem):
        fail(f"{tag}: the booted params are not bf16 of fit_to of "
             f"load_global")
    plain = ServeEngine(model, mem, n_slots=N_SLOTS, kv_len=KV_LEN)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in PROMPTS[:N_SLOTS]]
    toks, first = [], []
    for i, e in enumerate((eng, plain)):
        def keep_first(kind, rows, logits, i=i):
            if kind == "prefill" and len(first) == i:
                first.append(logits.clone())
        e.observer = keep_first
        uids = [e.submit(p, max_new_tokens=CKPT_MAX_NEW) for p in prompts]
        torch.cuda.synchronize()
        platform.reset_launches()
        res = e.run(max_steps=1000)
        torch.cuda.synchronize()
        if i == 0:
            launches = dict(platform.LAUNCHES)
        toks.append([res[u] for u in uids])
    print(f"{tag}: ServeEngine.from_checkpoint (INT8, meta {meta}) booted in "
          f"{boot:.2f} s; {len(prompts)} prompts ({PROMPTS[:N_SLOTS]} tokens) "
          f"x {CKPT_MAX_NEW} greedy tokens: "
          f"{'the same tokens' if toks[0] == toks[1] else 'DIFFERENT tokens'}"
          f" as the in-memory engine, first prefill logits "
          f"{'bit-identical' if torch.equal(first[0], first[1]) else 'DIFFER'}",
          flush=True)
    if toks[0] != toks[1] or not torch.equal(first[0], first[1]):
        fail(f"{tag}: the booted engine serves differently")
    if any(len(t) != CKPT_MAX_NEW for t in toks[0]):
        fail(f"{tag}: a request did not finish: {toks[0]}")
    other = Model(gemma3_config(), ZeroConfig(dp_axes=("model",)), world=1,
                  device="cuda")
    try:
        ServeEngine.from_checkpoint(other, str(path), n_slots=1,
                                    kv_len=KV_LEN)
    except ValueError as e:
        print(f"{tag}: a {other.cfg.name} engine refuses it: {e}",
              flush=True)
    else:
        fail(f"{tag}: a {other.cfg.name} engine booted from a "
             f"{cfg.name} checkpoint")
    del eng, plain
    gc.collect()
    torch.cuda.empty_cache()
    return launches, model, mem


def sharded_serve_rank(rank: int, world: int, path: str, prompts: list,
                       cfg) -> dict:
    """One rank of the sharded serving phase (a spawned process on device
    0): ``ServeEngine.from_checkpoint(mesh=)`` on the INT8 checkpoint
    ``path``, the slab engine (slots over "data", the cache sequence over
    "model"), then the paged engine on the same params (each page's tokens
    over "model"), ``prompts`` with CKPT_MAX_NEW greedy tokens each; B1,
    B2 and B8 launched as every call adds up to on this rank (the slab
    decode's head runs on this rank's rows); rank 0 profiles a slab
    decode step (the others make the same calls).  Returns, per pool, the
    tokens, statuses, launches and their expectation, the wire bytes by
    label, the engine's stats and, from rank 0, every stream's logits
    rows."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    mesh = mesh_lib.make_mesh(SHARD_MESH)
    model = Model(cfg, make_policy(cfg, mesh.axes, mesh=mesh).zcfg,
                  world=world, device="cuda")
    b_world = mesh.sizes["data"]
    out, params, slab = {}, None, None
    for pool in ("slab", "paged"):
        cap = Capture()
        kw = dict(n_slots=N_SLOTS, kv_len=KV_LEN, mesh=mesh,
                  kv_axes=("model",), observer=cap, device="cuda")
        if pool == "slab":
            kw["batch_axes"] = ("data",)
        else:
            kw.update(pool="paged", page_size=PAGE_SIZE,
                      chunk_size=PAGED_CHUNK)
        t0 = time.perf_counter()
        eng = ServeEngine.from_checkpoint(model, path, **kw) \
            if params is None else ServeEngine(model, params, **kw)
        boot = time.perf_counter() - t0
        params = eng.params
        uids = cap.submit(eng, prompts, CKPT_MAX_NEW)
        torch.cuda.synchronize()
        dist.barrier()
        platform.reset_launches()
        sent = train_launch.comm_bytes()
        t0 = time.perf_counter()
        res = eng.run(max_steps=2000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want = {k: 0 for k in per_call_launches(model)}
        for kind, rows in cap.calls:
            r = rows // b_world if pool == "slab" and kind == "decode" \
                else rows
            for k, n in per_call_launches(model, r).items():
                want[k] += n
        st = eng.stats()
        o = {"tokens": [res[u] for u in uids],
             "status": [eng.status[u] for u in uids],
             "launches": {k: platform.LAUNCHES[k] for k in want},
             "want": want, "calls": len(cap.calls),
             "kinds": {k: cap.count(k) for k in ("prefill", "decode")},
             "comm": train_launch.comm_since(sent), "wall": wall,
             "boot": boot, "ttft_p50": st["ttft_ms"]["p50"],
             "tick_p50": st["tok_latency_ms"]["p50"],
             "tok_per_s": st["tok_per_s"]}
        if rank == 0:
            o["rows"] = [torch.stack(cap.stream(u, len(res[u]))).cpu()
                         .numpy() for u in uids]
        out[pool] = o
        if pool == "slab":
            slab = eng
    decode = steps.build_decode_step(model, device="cuda", mesh=mesh,
                                     batch_axes=("data",),
                                     kv_axes=("model",)).fn
    batch = {"tokens": torch.zeros((N_SLOTS, 1), dtype=torch.long,
                                   device="cuda")}
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                       device="cuda")
    out["profile"] = profile_step(
        lambda: decode(params, slab.pool.caches, batch, pos),
        f"sharded decode step, rank {rank} of {world} (2 x 2: rows over "
        f"data, cache sequence over model), {N_SLOTS} slots",
        n=1, show=rank == 0)
    return out


def sharded_serve_phase(path: Path, model, params) -> dict:
    """Sharded serving: four ranks of a 2 x 2 world boot from the world-1
    INT8 checkpoint ``path`` (the elastic cut: each its shard of every buffer)
    and serve phase 3's first N_SLOTS prompts through the slab and then the
    paged engine (``sharded_serve_rank``).  Every rank must emit the same
    tokens and statuses, and launch B1, B2 and B8 as its calls add up to; every
    logits row rank 0 saw is held against the world-1 engine's model on the
    same checkpoint, teacher-forced on the sharded engine's tokens (phase 3's
    DECODE_ATOL rule, decisive tokens equal: ``model`` and ``params``, the
    world-1 engine's); a call's qwZ bytes a rank must be the training forward's
    at 2 x 2.  Prints ms a decode tick, TTFT, tokens/s, rank 0's busy share and
    the MiB a rank a call by label.  Returns the launches summed over the
    ranks, per engine."""
    from repro_torch.launch import mesh as mesh_lib
    tag = "sharded serving 2x2"
    t_phase = time.perf_counter()
    cfg = model.cfg
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in PROMPTS[:N_SLOTS]]
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = mesh_lib.spawn(sharded_serve_rank, int(np.prod(SHARD_MESH)),
                           str(path), prompts, cfg, device="cuda",
                           timeout=SHARD_TIMEOUT_S)
    print(f"{tag}: spawn to exit {time.perf_counter() - t0:.1f} s",
          flush=True)
    out = {}
    for pool in ("slab", "paged"):
        outs = [r[pool] for r in ranks]
        o = outs[0]
        for r, x in enumerate(outs):
            if x["tokens"] != o["tokens"] or x["status"] != o["status"]:
                fail(f"{tag} {pool}: rank {r}'s streams differ from rank "
                     f"0's")
            if any(x["launches"][k] != n or n <= 0
                   for k, n in x["want"].items()):
                fail(f"{tag} {pool} rank {r}: launches {x['launches']}, "
                     f"expected {x['want']} over {x['calls']} calls")
        if o["status"] != ["done"] * N_SLOTS or any(
                len(t) != CKPT_MAX_NEW for t in o["tokens"]):
            fail(f"{tag} {pool}: requests did not finish: {o['status']}")
        holds = []
        for i, (p, toks) in enumerate(zip(prompts, o["tokens"])):
            want = teacher_forced(model, params, p, toks)
            rows = [torch.from_numpy(x).to("cuda") for x in o["rows"][i]]
            holds.append(hold_stream(f"{tag} {pool} request {i + 1} "
                                     f"(prompt {len(p)})", rows, want, toks))
        check_holds(f"{tag}: {pool} engine", holds)
        mib = {k: b / o["calls"] / 2 ** 20 for k, b in o["comm"].items()}
        print(f"{tag}: {pool} engine on 4 ranks, {o['calls']} model calls "
              f"({o['kinds']['prefill']} prefill, {o['kinds']['decode']} "
              f"decode) in {o['wall']:.3f} s (boot {o['boot']:.2f} s): "
              f"{o['tick_p50']:.3f} ms a decode tick (p50), TTFT p50 "
              f"{o['ttft_p50']:.2f} ms, {o['tok_per_s']:.1f} tok/s; MiB a "
              f"rank a call: " + ", ".join(f"{k} {v:.3f}"
                                           for k, v in sorted(mib.items()))
              + f"; launches a rank {o['launches']} (as counted, every "
              f"rank)", flush=True)
        if round(mib.get("zero.qwz_gather", 0), 3) != SHARD_QWZ_MIB:
            fail(f"{tag} {pool}: qwZ {mib.get('zero.qwz_gather')} MiB a "
                 f"rank a call, the training forward's {SHARD_QWZ_MIB}")
        out["serve_sharded" if pool == "slab" else "serve_sharded_paged"] = {
            k: sum(x["launches"].get(k, 0) for x in outs)
            for k in platform.LAUNCHES}
    prof = ranks[0]["profile"]
    print(f"{tag}: rank 0's profiled decode step: host wall "
          f"{prof['wall']:.1f} ms, device busy {prof['busy']:.1f} ms "
          f"({100 * prof['busy'] / prof['wall']:.1f}%), gloo "
          f"{prof['gloo']:.1f} ms of host time "
          f"({100 * prof['gloo'] / prof['wall']:.1f}%)", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{tag} phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def elastic_phase(ckpt_dir: str, losses_2x2: list, save_s: list) -> dict:
    """Phase 6's synchronous 2 x 2 run saved after its step MR_SYNC_STEPS
    (four rank processes, four shard files, one manifest): a world of 1
    restores it through the launcher's loop (--ckpt-dir) and runs to step
    MR_STEPS; each loss within CKPT_REL_ELASTIC of phase 6's at the same
    step.  Returns the launches of the restored run."""
    from repro_torch.train.state import read_manifest
    tag = "checkpoint 2x2 -> 1"
    path = Path(ckpt_dir) / f"ckpt_{MR_SYNC_STEPS}"
    man = read_manifest(str(path))
    files = sorted(f.name for f in path.iterdir())
    print(f"{tag}: phase 6's --prefetch 0 run saved {path.name} at 2 x 2: "
          f"{files}, {_dir_bytes(path) / 1e9:.3f} GB, each rank's save "
          f"{[round(s[0], 2) for s in save_s]} s", flush=True)
    if man["num_processes"] != 4 or len(man["shard_files"]) != 4 or \
            files != sorted(man["shard_files"] + ["manifest.json"]):
        fail(f"{tag}: expected four shard files and a manifest: {files}")
    args = train_launch.parser().parse_args([
        "--arch", "qwen3-0.6b", "--batch", str(TRAIN_BATCH), "--seq",
        str(TRAIN_SEQ), "--steps", str(MR_STEPS), "--lr", str(TRAIN_LR),
        "--lr-schedule", "constant", "--device", "cuda", "--attn", "pallas",
        "--log-every", "0", "--ckpt-dir", ckpt_dir])
    gc.collect()
    torch.cuda.empty_cache()
    platform.reset_launches()
    t0 = time.perf_counter()
    res = train_launch.train_loop(args)
    wall = time.perf_counter() - t0
    launches = dict(platform.LAUNCHES)
    want = losses_2x2[MR_SYNC_STEPS:MR_STEPS]
    rel = [abs(a - b) / abs(b) for a, b in zip(res["losses"], want)]
    print(f"{tag}: a world of 1 restored step {res['start']} (saved world "
          f"{res['restored']['world']}) and ran to step {MR_STEPS} in "
          f"{wall:.2f} s: losses {res['losses']!r} vs phase 6's {want!r}, "
          f"relative {[f'{v:.2e}' for v in rel]} (bar {CKPT_REL_ELASTIC})",
          flush=True)
    if res["start"] != MR_SYNC_STEPS or res["restored"]["world"] != 4:
        fail(f"{tag}: restored at step {res['start']}, meta "
             f"{res['restored']}")
    if len(rel) != MR_STEPS - MR_SYNC_STEPS or not max(rel) < CKPT_REL_ELASTIC:
        fail(f"{tag}: losses beyond {CKPT_REL_ELASTIC} of phase 6's")
    per_step = step_launches(res["built"].arch, res["built"].model, "pallas")
    if any(c != per_step for c in res["launches"]):
        fail(f"{tag}: launches {res['launches']}, expected {per_step}")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt_dir)
    return launches


# ----------------------------------------------------------- supervisor

def _sup_config(**kw):
    from repro_torch.train.elastic import ElasticConfig
    return ElasticConfig(arch=cut_config(), reduced=False, mesh=(1, 1),
                         steps=SUP_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                         lr=TRAIN_LR, device="cuda", attn="pallas", **kw)


def _sup_run(tag: str, cfg, **kw) -> tuple:
    """One supervised run of ``cfg`` from a clean card: (its result, the
    peak device memory it took, its launches)."""
    from repro_torch.train.elastic import Supervisor
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    platform.reset_launches()
    t0 = time.perf_counter()
    out = Supervisor(cfg, **kw).run_supervised()
    wall = time.perf_counter() - t0
    launches = dict(platform.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"{tag}: {wall:.1f} s, status {out['status']}, final step "
          f"{out['final_step']}, losses {[out['losses'][i] for i in range(SUP_STEPS)]!r}",
          flush=True)
    if out["status"] != "complete" or out["final_step"] != SUP_STEPS:
        fail(f"{tag}: ended {out['status']} at step {out['final_step']}")
    if not all(np.isfinite(list(out["losses"].values()))):
        fail(f"{tag}: non-finite losses {out['losses']}")
    return out, peak, launches


def _p50_ms(xs) -> str:
    return f"{statistics.median(xs) * 1e3:.1f} ms ({len(xs)} steps)" \
        if xs else "none"


def supervisor_phase(root: str) -> dict:
    """Phase 16: the elastic supervisor's oracle, its async checkpoints
    through a death, and a live reshard onto a 1 x 2 world and back.
    Returns the launches of (b) and (c)."""
    from repro_torch.testing.faults import StepFaults
    tag = "supervisor"
    check_disk(root)
    t_phase = time.perf_counter()
    cfg0 = _sup_config()
    oracle, peak0, _ = _sup_run(f"{tag} (a) oracle", cfg0)
    want = [oracle["losses"][i] for i in range(SUP_STEPS)]
    built_arch = cut_config()
    model = Model(built_arch, make_policy(built_arch, ("data", "model")).zcfg,
                  device="cpu")
    per_step = step_launches(built_arch, model, "pallas")
    print(f"{tag}: qwen3-0.6b full width at {CUT_LAYERS} of its 28 layers, "
          f"{model.n_params():,} params (fp32 master + fp32 moments), "
          f"--attn pallas, batch {TRAIN_BATCH} x {TRAIN_SEQ}, warmup-cosine "
          f"from lr {TRAIN_LR}; launches per step {per_step}", flush=True)

    # (b) async checkpoints and a death
    d = Path(root) / "supervisor"
    died, peak_b, launches_b = _sup_run(
        f"{tag} (b) death at step {SUP_DIE}",
        _sup_config(ckpt_dir=str(d), ckpt_every=SUP_EVERY),
        faults=StepFaults({SUP_DIE: "die"}))
    if died["restarts"] != 1 or died["fired"] != [(SUP_DIE, "die")]:
        fail(f"{tag} (b): restarts {died['restarts']}, fired "
             f"{died['fired']}")
    steps = died["steps"]
    cut = next(k for k in range(1, len(steps))
               if steps[k][0] <= steps[k - 1][0])
    first, replay = steps[:cut], steps[cut:]
    resumed = replay[0][0]
    spread = max(abs(loss - want[i]) for i, loss, _, _ in first)
    got = [died["losses"][i] for i in range(SUP_STEPS)]
    same = got == want
    print(f"{tag} (b): resumed from ckpt_{resumed} (the newest committed; "
          f"the first attempt ran steps {[s[0] for s in first]}, the "
          f"replay steps {[s[0] for s in replay]}); losses vs the oracle's: "
          + ("bit-identical" if same else
             f"differ by up to {max(abs(a - b) for a, b in zip(got, want)):.3e}"
             f" (the first attempt's in-memory spread {spread:.3e})"),
          flush=True)
    if spread == 0.0 and not same:
        fail(f"{tag} (b): the replayed losses differ from the oracle's "
             f"{got} vs {want}")
    if spread > 0.0 and max(abs(a - b) for a, b in zip(got, want)) > spread:
        fail(f"{tag} (b): a replayed loss is outside the in-memory spread")
    if launches_b != {k: n * len(steps) for k, n in per_step.items()}:
        fail(f"{tag} (b): launches {launches_b}, expected {per_step} x "
             f"{len(steps)} steps")
    for k, w in enumerate(died["writers"]):
        print(f"{tag} (b): writer {k + 1}: submitted {w['submitted']}, "
              f"committed {w['completed']}, abandoned {w['abandoned']}, "
              f"failed {w['failed']}, steps overlapped "
              f"{w['steps_overlapped']}; each write "
              f"{[round(x, 2) for x in w['write_s']]} s, each submit's "
              f"stall {[round(x, 3) for x in w['submit_s']]} s", flush=True)
    if [w["failed"] for w in died["writers"]] != [0, 0]:
        fail(f"{tag} (b): a write failed: {died['writers']}")
    busy = [s[2] for s in steps if s[3]]
    idle = [s[2] for s in steps if not s[3]]
    print(f"{tag} (b): step p50 with a write in flight at its end "
          f"{_p50_ms(busy)}, with none {_p50_ms(idle)} (the oracle's "
          f"{_p50_ms([s[2] for s in oracle['steps'][1:]])}); restore "
          f"{[round(x, 2) for x in died['restore_s']]} s; time to recover "
          f"(the death to the end of the first replayed step) "
          f"{[round(x, 2) for x in died['recover_s']]} s; peak memory "
          f"{peak_b / 2 ** 30:.2f} GiB against the oracle's "
          f"{peak0 / 2 ** 30:.2f} GiB (max_memory_allocated)", flush=True)
    shutil.rmtree(d)

    # (c) a live reshard: world 1 -> 1 x 2 -> world 1
    rs, _, _ = _sup_run(f"{tag} (c) reshard {SUP_RESHARD}", cfg0,
                        reshard_plan=dict(SUP_RESHARD))
    launches_c = rs["launches"]
    rel = [abs(rs["losses"][i] - w) / abs(w) for i, w in enumerate(want)]
    print(f"{tag} (c): resharded {rs['resharded']}, each in "
          f"{[round(x, 2) for x in rs['reshard_s']]} s (the old world's stop "
          f"to the state placed on the new); steps 0-1 "
          f"{'bit-identical' if rel[:2] == [0.0, 0.0] else 'DIFFER'}; "
          f"relative to the oracle {[f'{x:.2e}' for x in rel]} (bar "
          f"{SUP_REL})", flush=True)
    if rs["resharded"] != [(2, 1, 2), (4, 2, 1)]:
        fail(f"{tag} (c): resharded {rs['resharded']}")
    if rel[:2] != [0.0, 0.0] or not max(rel) < SUP_REL:
        fail(f"{tag} (c): losses {rs['losses']} vs the oracle's {want}")
    # steps 0-1 and 4-5 here, 2-3 on each of the two ranks
    if launches_c != {k: n * (SUP_STEPS + 2) for k, n in per_step.items()}:
        fail(f"{tag} (c): launches {launches_c}, expected {per_step} x "
             f"{SUP_STEPS + 2} rank steps")
    print(f"supervisor phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"train_elastic": launches_b, "train_elastic_reshard": launches_c}


def profile_decode(decode, params, caches, positions) -> None:
    """Where a batched decode step's time goes (see profile_step)."""
    batch = {"tokens": torch.zeros((N_SLOTS, 1), dtype=torch.long,
                                   device="cuda")}
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    profile_step(lambda: decode(params, caches, batch, pos),
                 f"decode step, {N_SLOTS} slots at positions {positions}",
                 n=3)


def profile_step(step, what: str, n: int = 1, show: bool = True,
                 ops: tuple = ()):
    """Host wall per ``step()`` (synchronized, no profiler, after one
    warm-up call), then device busy time, device kernels, the host time of
    the gloo collectives (their ``gloo:*`` spans, copies to and from the
    card included), the device time under each of the PyTorch ``ops``
    (e.g. ``aten::bmm``: the MoE expert GEMMs, forward and backward) and
    the top device ops per step from torch.profiler over n more calls.
    Returns {"wall", "busy", "gloo"} in ms per step.
    With ``show`` False it only makes the same calls (a rank whose peers
    are profiled must match their collectives) and returns None."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n * 1e3
    if not show:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        return None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    events = prof.events()
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / n
    by_name: dict = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3 / n
    gloo: dict = {}
    labels: dict = {}       # the collectives' issue and .wait ranges
    for e in events:
        ms = e.time_range.elapsed_us() / 1e3 / n
        if e.name.startswith("gloo:"):
            gloo[e.name] = gloo.get(e.name, 0.0) + ms
        elif e.name.startswith(("zero.", "other")):
            labels[e.name] = labels.get(e.name, 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    flash = {re.search(r"::(flash_\w+)", k).group(1): ms
             for k, ms in by_name.items() if "::flash_" in k}
    print(f"profile ({what}): host wall {wall:.3f} ms/step, device busy "
          f"{busy:.3f} ms/step ({100 * busy / wall:.1f}% of the wall), "
          f"{len(dev) / n:.0f} device kernels/step", flush=True)
    if gloo:
        print(f"  gloo collectives {sum(gloo.values()):.3f} ms/step of host "
              f"time ({100 * sum(gloo.values()) / wall:.1f}% of the wall): "
              + ", ".join(f"{k} {ms:.3f}" for k, ms in sorted(gloo.items())),
              flush=True)
        names = sorted({k[:-len(".wait")] if k.endswith(".wait") else k
                        for k in labels})
        print("  by label, host ms/step in issue / in .wait: " + ", ".join(
            f"{k} {labels.get(k, 0.0):.3f} / {labels.get(k + '.wait', 0.0):.3f}"
            for k in names), flush=True)
    if flash:
        print(f"  flash kernels {sum(flash.values()):.3f} ms/step: "
              + ", ".join(f"{k} {ms:.3f}" for k, ms in flash.items()),
              flush=True)
    quant_ms = {b: 0.0 for b in QUANT_KERNELS.values()}
    for k, ms in by_name.items():
        m = re.search(r"::(\w+_kernel)[<(]", k)
        if m and m.group(1) in QUANT_KERNELS:
            quant_ms[QUANT_KERNELS[m.group(1)]] += ms
    if any(quant_ms.values()):
        print(f"  quant kernels {sum(quant_ms.values()):.3f} ms/step: "
              + ", ".join(f"{b} {ms:.3f}" for b, ms in quant_ms.items()),
              flush=True)
    if ops:
        avg = {a.key: a for a in prof.key_averages()}
        dt = {op: (getattr(avg[op], "device_time_total", None) or
                   getattr(avg[op], "cuda_time_total", 0.0)) / 1e3 / n
              if op in avg else 0.0 for op in ops}
        print("  device ms/step under " + ", ".join(
            f"{op} {ms:.3f} ({100 * ms / busy:.1f}% of busy)"
            for op, ms in dt.items()), flush=True)
    for name, ms in top:
        print(f"  {ms:9.3f} ms/step  {name[:90]}", flush=True)
    return {"wall": wall, "busy": busy, "gloo": sum(gloo.values()),
            "labels": labels}


def _template_args(mangled: str) -> str:
    """'13__nv_bfloat16Li4E' -> 'bf16, 4'; 'Li4ELi4ELi1ELi2E' -> '4, 4, 1, 2'."""
    out = mangled.replace("13__nv_bfloat16", "bf16,")
    out = re.sub(r"^f(?=L|$)", "f32,", out)
    out = re.sub(r"Lb([01])E?", lambda m: " round " + ("true" if m.group(1)
                                                        == "1" else "false"),
                 out)
    return re.sub(r"Li(\d+)E", r" \1,", out).strip(" ,").replace(",,", ",")


def timed(name: str, fn, *args):
    """``fn(*args)``, printing its seconds as "<name> phase: X s"."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"{name} phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs the card")
    print(device_line(), flush=True)
    global PARITY
    t0 = time.perf_counter()
    table = stub_table_thread()
    PARITY = ParityCPU()
    logs = platform.build()
    print(f"built {sorted(logs) or 'nothing (up to date)'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(b) for b in
                     re.findall(r"(\d+) bytes spill stores", log))
        print(f"  {name}.cu: {len(regs)} kernels, at most {max(regs)} "
              f"registers per thread, {spills} bytes spilled", flush=True)
    # per kernel of the flash sources (the others report their maximum)
    for src, dt in (("flash_attention", "f32"), ("flash_attention_tc", "bf16")):
        smem = getattr(platform.library(src, {}), f"repro_flash_{dt}_smem")
        for fn, hd, spill, regs in re.findall(
                r"Compiling entry function '\S*?\d(flash_\w+?_kernel)ILi"
                r"(\d+)E.*?(\d+) bytes spill stores.*?Used (\d+) registers",
                logs.get(src, ""), re.S):
            which = 0 if "fwd" in fn else 1 if "dq" in fn else 2
            print(f"    {fn}<{dt}, hd {hd}>: {regs} registers, {spill} bytes "
                  f"spilled, {smem(which, int(hd))} bytes of shared memory",
                  flush=True)
    # per instantiation of the qgZ stream kernels B3 and B4
    for src in ("quant_block", "fused_dequant_reduce_quant"):
        for fn, targs, spill, regs, rest in re.findall(
                r"Compiling entry function '\S*?\d(quantize_reordered_kernel|"
                r"dequant_reduce_quant_kernel)I(\w+?)EEv.*?(\d+) bytes spill "
                r"stores.*?Used (\d+) registers([^\n]*)", logs.get(src, ""),
                re.S):
            smem = re.search(r"(\d+) bytes smem", rest)
            print(f"    {fn}<{_template_args(targs)}>: {regs} registers, "
                  f"{spill} bytes spilled, {smem.group(1) if smem else 0} "
                  f"bytes of static shared memory", flush=True)
    # B8: the tensor-core kernel (the serving path's) and each FFMA
    # instantiation (x dtype, x rows a pass, bf16 round), then the
    # tensor-core kernel's SASS (what it issues per weight)
    for fn, spill, regs in re.findall(
            r"Compiling entry function '\S*?(dequant_matmul_tc_kernel|"
            r"dequant_matmul_kernelI\w+?EEv)"
            r".*?(\d+) bytes spill stores.*?Used (\d+) registers",
            logs.get("dequant_matmul", ""), re.S):
        m = re.match(r"dequant_matmul_kernelI(\w+?)EEv", fn)
        name = (f"dequant_matmul_kernel<{_template_args(m.group(1))}>"
                if m else fn)
        print(f"    {name}: {regs} registers, {spill} bytes spilled",
              flush=True)
    sass_census("dequant_matmul", r"dequant_matmul_tc_kernel")
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rec = timed("kernel", kernel_phase, flush)
    vl_kernels = rec.pop("qwen2_vl")
    # B1-B5 at deepseek-moe-16b's, mamba2-130m's and recurrentgemma-2b's
    # groups, by path
    path_kernels = {path: rec.pop(path) for path in path_group_sizes()}
    qgz = timed("qgZ kernel", qgz_kernel_phase, flush)
    vl_kernels.update(qgz.pop("qwen2_vl"))
    for path, kernels in path_kernels.items():
        kernels.update(qgz.pop(path))
    rec.update(qgz)
    for name, extra in timed("knob kernel", knob_kernel_phase, flush).items():
        rec[name].setdefault("extra", {}).update(extra)
    rec["quantize_blockwise"]["max_abs_err"] = max(
        rec["quantize_blockwise"]["max_abs_err"],
        rec["quantize_blockwise_f32"]["max_abs_err"])
    rec.update(timed("flash kernel", flash_kernel_phase, flush))
    rec.update(timed("gemma3 flash kernel", gemma3_flash_phase, flush))
    rec.update(timed("qwen2-vl flash kernel", qwen2_vl_flash_phase, flush))
    rec.update(timed("moe flash kernel", moe_flash_phase, flush))
    rec.update(timed("recurrentgemma flash kernel", rg_flash_phase, flush))
    del flush
    by_path = {}
    # the device-bound phases first, beside the CPU parity process; the
    # host-bound serving phases once it has ended
    timed("train parity", train_parity_phase)
    # this slice's path, then the plain-attention run beside it (same seed
    # and batches) so that one call shows both step times
    by_path["train"], losses_pallas = timed("train pallas", train_phase,
                                            "pallas")
    by_path["train_xla"], losses_xla = timed("train xla", train_phase, "xla")
    loss_pallas, loss_xla = losses_pallas[0], losses_xla[0]
    print(f"train: step-1 loss --attn pallas {loss_pallas:.6f} vs --attn "
          f"xla {loss_xla:.6f} (|diff| {abs(loss_pallas - loss_xla):.2e}, "
          f"bar {ROUTE_LOSS_ATOL})", flush=True)
    if not abs(loss_pallas - loss_xla) <= ROUTE_LOSS_ATOL:
        fail("the two attention routes' step-1 losses differ beyond "
             f"{ROUTE_LOSS_ATOL}")
    # gemma3-4b and qwen2-vl-72b (QKV bias, M-RoPE, embedding inputs):
    # the parity steps and the training runs
    timed("gemma3 parity", gemma3_parity_phase)
    by_path["train_gemma3"] = timed("gemma3 train", gemma3_train_phase)
    by_path["train_qwen2_vl"] = timed("qwen2-vl train", qwen2_vl_train_phase,
                                      table)
    timed("qwen2-vl parity", qwen2_vl_parity_phase)
    # deepseek-moe-16b: the expert chunks' rings, routing-ahead and the hpZ
    # recompute; then its parity step
    by_path["train_moe"], by_path["train_moe_sync"] = timed(
        "moe train", moe_train_phase)
    timed("moe parity", moe_parity_phase)
    # mamba2-130m and recurrentgemma-2b: the SSD and RG-LRU scans in
    # training, then their parity steps
    for name in ssm_configs():
        by_path[f"train_{name}"] = timed(f"{name} train", ssm_train_phase,
                                         name)
    timed("ssm parity", ssm_parity_phase)
    # that was the last parity case: the serving phases below, whose time
    # goes to the host, do not share it with the CPU parity process
    PARITY.close()
    serve3 = timed("engine", engine_phase)
    by_path["serve"] = serve3["launches"]
    by_path["serve_paged"], by_path["serve_spec"] = paged_phase(serve3)
    del serve3
    by_path["serve_gemma3"] = timed("gemma3 engine", engine_phase,
                                    gemma3_config(), GEMMA_PROMPTS)[
        "launches"]
    by_path["serve_qwen2_vl"] = timed("qwen2-vl serve", qwen2_vl_serve_phase)
    by_path["serve_moe"] = timed("moe engine", moe_serve_phase)
    for name in ssm_configs():
        by_path[f"serve_{name}"] = timed(f"{name} engine", ssm_serve_phase,
                                         name)
    gc.collect()
    torch.cuda.empty_cache()
    # the same run on four ranks of a 2 x 2 world, at the default ring
    # depth and at the synchronous schedule, which saves a checkpoint
    ckpt_root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        check_disk(ckpt_root)
        mr_ckpt = str(Path(ckpt_root) / "mr")
        # phases 6, 7 and 8 in one spawn of the 2 x 2 world: one start and
        # one warm-up of the four ranks for their seven runs
        t_mr = time.perf_counter()
        sp_one = seq_world1_loss()
        per_run = _mr_spawn(multirank_runs(mr_ckpt) + [seq_parallel_run()]
                            + knob_runs(), "train 2x2 (phases 6-8)")
        (by_path["train_2x2"], by_path["train_2x2_sync"], losses_2x2,
         tiers_2x2, mr_save_s) = multirank_phase(losses_pallas,
                                                 *per_run[:2])
        by_path["train_2x2_seq"] = seq_parallel_phase(sp_one, per_run[2])
        by_path.update(knob_phase(losses_2x2, tiers_2x2, per_run[3:]))
        print(f"multi-rank phase (6-8): {time.perf_counter() - t_mr:.1f} s",
              flush=True)
        # checkpoints: phase 6's 2 x 2 checkpoint restored at world 1, then
        # world 1's fp32 and INT8 checkpoints, their restores and the
        # engine booted from INT8
        t_ck = time.perf_counter()
        by_path["train_ckpt_2x2_to_1"] = elastic_phase(mr_ckpt, losses_2x2,
                                                       mr_save_s)
        ck_paths, (p8, model1, params1) = checkpoint_phase(ckpt_root,
                                                           losses_pallas)
        by_path.update(ck_paths)
        print(f"checkpoint phase: {time.perf_counter() - t_ck:.1f} s",
              flush=True)
        # this slice's path: the world-1 INT8 checkpoint booted on four
        # ranks of a 2 x 2 world, slab and paged engines, held against the
        # world-1 model booted from it
        by_path.update(sharded_serve_phase(p8, model1, params1))
        del model1, params1
        shutil.rmtree(Path(p8).parent)
        # this slice's path: the elastic supervisor (phase 11's
        # checkpoints are gone: its own take their room)
        by_path.update(supervisor_phase(ckpt_root))
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    # the 2 x 2 x 2 world
    by_path["train_2x2x2"], by_path["train_2x2x2_hpz"] = timed(
        "multi-pod", multipod_phase, timed("world 1 cut", cut_world1_losses))

    # each kernel's path(s): it must have launched in every one of them
    quant_train = ("train", "train_xla", "train_gemma3", "train_qwen2_vl",
                   "train_moe", "train_moe_sync", "train_mamba2",
                   "train_recurrentgemma", "train_2x2",
                   "train_2x2_sync", "train_ckpt", "train_ckpt_2x2_to_1",
                   "train_2x2_seq", "train_2x2_qgz_int8",
                   "train_2x2_hpz_world", "train_2x2x2", "train_2x2x2_hpz",
                   "train_elastic", "train_elastic_reshard")
    flash = ("train", "train_2x2", "train_2x2_sync", "train_ckpt",
             "train_ckpt_2x2_to_1", "train_elastic",
             "train_elastic_reshard") + tuple(
        f"train_2x2_{k}" for k in KNOB_MIB) + ("train_2x2x2",
                                                "train_2x2x2_hpz")
    serve = ("serve", "serve_paged", "serve_spec", "serve_gemma3",
             "serve_qwen2_vl", "serve_moe", "serve_mamba2",
             "serve_recurrentgemma", "serve_ckpt", "serve_sharded",
             "serve_sharded_paged")
    paths = {"quantize_blockwise": serve + ("train_2x2_qgz_1hop",)
             + quant_train,
             "dequantize_blockwise": serve + ("train_2x2_qgz_1hop",)
             + quant_train,
             "quantize_reordered": quant_train + ("train_2x2_qwz_nonblocked",),
             "dequant_reduce_quant": quant_train
             + ("train_2x2_qwz_nonblocked",),
             "dequant_reduce": quant_train + tuple(
                 f"train_2x2_{k}" for k in KNOB_MIB),
             "dequant_matmul": serve,
             "flash_fwd": flash,
             "flash_bwd": flash,
             # the same wrappers and counters at head dim 256: the gemma3
             # path runs no other
             "flash_fwd_hd256": ("train_gemma3",),
             "flash_bwd_hd256": ("train_gemma3",),
             # and at qwen2-vl-72b's GQA group of 8 (64 / 8 heads), and B8
             # at its K 8192
             "flash_fwd_gqa8": ("train_qwen2_vl",),
             "flash_bwd_gqa8": ("train_qwen2_vl",),
             "dequant_matmul_k8192": ("serve_qwen2_vl",),
             # and at deepseek-moe-16b's (16 / 16 heads of 128), and B8 at
             # its K 2048
             "flash_fwd_moe": ("train_moe", "train_moe_sync"),
             "flash_bwd_moe": ("train_moe", "train_moe_sync"),
             "dequant_matmul_k2048": ("serve_moe",),
             # and at recurrentgemma-2b's (10 / 1 heads of 256 under the
             # 2048 window, its local layers only), and B8 at its head and
             # mamba2-130m's
             "flash_fwd_recurrentgemma": ("train_recurrentgemma",),
             "flash_bwd_recurrentgemma": ("train_recurrentgemma",),
             "dequant_matmul_mamba2": ("serve_mamba2",),
             "dequant_matmul_recurrentgemma": ("serve_recurrentgemma",)}
    counter = {"flash_fwd_hd256": "flash_fwd", "flash_bwd_hd256": "flash_bwd",
               "flash_fwd_gqa8": "flash_fwd", "flash_bwd_gqa8": "flash_bwd",
               "dequant_matmul_k8192": "dequant_matmul",
               "flash_fwd_moe": "flash_fwd", "flash_bwd_moe": "flash_bwd",
               "dequant_matmul_k2048": "dequant_matmul",
               "flash_fwd_recurrentgemma": "flash_fwd",
               "flash_bwd_recurrentgemma": "flash_bwd",
               "dequant_matmul_mamba2": "dequant_matmul",
               "dequant_matmul_recurrentgemma": "dequant_matmul"}
    for name, ps in paths.items():
        for pth in ps:
            if by_path[pth][counter.get(name, name)] <= 0:
                fail(f"{name} was not launched on the {pth} path")
    cu = "src/repro_torch/kernels/csrc/"
    srcs = {"quantize_blockwise": (cu + "quant_block.cu",
                                   "src/repro/kernels/quant_block.py:106"),
            "dequantize_blockwise": (cu + "quant_block.cu",
                                     "src/repro/kernels/quant_block.py:170"),
            "quantize_reordered": (cu + "quant_block.cu",
                                   "src/repro/kernels/quant_block.py:217"),
            "dequant_reduce_quant": (
                cu + "fused_dequant_reduce_quant.cu",
                "src/repro/kernels/fused_dequant_reduce_quant.py:104"),
            "dequant_reduce": (
                cu + "fused_dequant_reduce_quant.cu",
                "src/repro/kernels/fused_dequant_reduce_quant.py:73"),
            "dequant_matmul": (cu + "dequant_matmul.cu",
                               "src/repro/kernels/dequant_matmul.py:58"),
            "flash_fwd": (cu + "flash_attention_tc.cu",
                          "src/repro/kernels/flash_attention.py:76"),
            "flash_bwd": (cu + "flash_attention_tc.cu",
                          "src/repro/kernels/flash_attention.py:194"),
            "flash_fwd_hd256": (cu + "flash_attention_tc.cu",
                                "src/repro/kernels/flash_attention.py:76"),
            "flash_bwd_hd256": (cu + "flash_attention_tc.cu",
                                "src/repro/kernels/flash_attention.py:194"),
            "flash_fwd_gqa8": (cu + "flash_attention_tc.cu",
                               "src/repro/kernels/flash_attention.py:76"),
            "flash_bwd_gqa8": (cu + "flash_attention_tc.cu",
                               "src/repro/kernels/flash_attention.py:194"),
            "dequant_matmul_k8192": (cu + "dequant_matmul.cu",
                                     "src/repro/kernels/dequant_matmul.py:58"),
            "flash_fwd_moe": (cu + "flash_attention_tc.cu",
                              "src/repro/kernels/flash_attention.py:76"),
            "flash_bwd_moe": (cu + "flash_attention_tc.cu",
                              "src/repro/kernels/flash_attention.py:194"),
            "dequant_matmul_k2048": (cu + "dequant_matmul.cu",
                                     "src/repro/kernels/dequant_matmul.py:58"),
            "flash_fwd_recurrentgemma": (
                cu + "flash_attention_tc.cu",
                "src/repro/kernels/flash_attention.py:76"),
            "flash_bwd_recurrentgemma": (
                cu + "flash_attention_tc.cu",
                "src/repro/kernels/flash_attention.py:194"),
            "dequant_matmul_mamba2": (
                cu + "dequant_matmul.cu",
                "src/repro/kernels/dequant_matmul.py:58"),
            "dequant_matmul_recurrentgemma": (
                cu + "dequant_matmul.cu",
                "src/repro/kernels/dequant_matmul.py:58")}
    # B8 at K 8192 is its own entry; B1-B5 at qwen2-vl-72b's layer group
    # and unembedding chunk ride in their records' extras
    k8 = rec["dequant_matmul"]["extra"]["qwen2_vl_t4"]
    rec["dequant_matmul_k8192"] = dict(
        k8, bound=(k8["bound_ms"], k8["bound_by"]),
        extra={"library_call": rec["dequant_matmul"]["extra"][
            "library_call"]})
    for name, head in (("dequant_matmul_k2048", "deepseek_moe_t4"),
                       ("dequant_matmul_mamba2", "mamba2_t4"),
                       ("dequant_matmul_recurrentgemma",
                        "recurrentgemma_t4")):
        r = rec["dequant_matmul"]["extra"][head]
        rec[name] = dict(r, bound=(r["bound_ms"], r["bound_by"]),
                         extra={"library_call": rec["dequant_matmul"][
                             "extra"]["library_call"]})
    # B1-B5 at deepseek-moe-16b's layer group, expert chunk and
    # unembedding chunk, and at mamba2-130m's and recurrentgemma-2b's layer
    # groups, ride in their records' extras
    for path, kernels in path_kernels.items():
        for (name, key), r in kernels.items():
            rec[name].setdefault("extra", {})[f"{path}_{key}"] = r
    vl_layer, vl_chunk = qwen2_vl_group_sizes()[:2]
    for (name, n), r in vl_kernels.items():
        key = "blocks" if n == vl_layer else "unemb_chunk"
        tag = {"quantize_blockwise": "_bf16",
               "quantize_blockwise_f32": "_f32"}.get(name, "")
        rec[name.replace("_f32", "")].setdefault("extra", {})[
            f"qwen2_vl_{key}{tag}"] = r
    kernels = []
    for name, (src, replaces) in srcs.items():
        r = rec[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": sum(by_path[p][counter.get(name, name)]
                                        for p in paths[name]),
                        "launches_by_path": {
                            p: by_path[p][counter.get(name, name)]
                            for p in paths[name]},
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                        "bound_by": r["bound"][1],
                        "library_ms": r.get("library_ms"),
                        "shape": list(r["shape"]), **r.get("extra", {})})
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} "
          f"s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
