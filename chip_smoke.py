#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):

1. the card's name and power limit, torch and CUDA versions;
2. build every CUDA kernel of the port from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, started together) and print, for each
   instantiation, the registers and spills ``ptxas -v`` reports; fail on
   a spill in any head-dim-256 build, and unless the bf16 builds the
   main path runs (the tree-verify split kernel at head dims 128 and 256
   in its paged, windowed and dense forms and at 64 in its paged and
   dense forms (zamba2-1.2b's shared block), and its merge, K3 at (64,
   64), (80, 80) (hubert-xlarge's encoder), (128, 128), (256, 256) and
   (192, 128), each at the key tile the committed autotuner cache
   resolves (every key-tile instance's line is printed), every K5
   instance (its split sweep over bf16 and fp32 pools at (512, 64) and
   (64, 16), windowed or not, and its merges), K6's bf16 chunk kernel
   and scan at chunk 64 and their fp32 builds at chunks 16 and 64) and every
   instance of the backward kernels (K6's increment and gradient pass,
   bf16 and fp32, at chunks 16 and 64, its carry and du reduction; K3's
   dK/dV and dQ kernels at each bf16 and each fp32 build, the partials'
   sum) are each found in the report and show no spill; then fail unless
   ``cuobjdump -sass`` finds tensor-core instructions (``HMMA`` or
   ``HGMMA``) in every bf16 and fp32 build of K3 (bf16 on wgmma, its
   SASS holding ``HGMMA`` and the TMA load ``UTMALDG``; fp32 in 3xTF32), of
   its backward's dK/dV and dQ kernels, of K6's backward's increment and
   gradient pass (bf16 and fp32), of the tree-verify split
   kernel (bf16 and fp32: its fp32 builds run 3xTF32 too, and the D=64
   ones the main path runs, with the fp32 merges, must show no spill), of
   K5's split sweep (bf16 and fp32, windowed or not) and of K6's two
   kernels (bf16 and fp32; the models
   past 64 query rows per kv head add no instantiation: row groups are a grid
   axis of the D=128 builds), the D = 64 ones and K3's (80, 80) among
   them;
3. hold each kernel against its plain PyTorch version on the card, fp32
   with TF32 off (atol = rtol = 1e-4) and bf16 (atol = rtol = 2e-2), and
   time the kernel, its plain version and ``scaled_dot_product_attention``
   (a yardstick the port never calls) beside the least time the card
   needs for the same work (fp32 tree verify and K3 also beside the
   3xTF32 bound, with each launch's µs and blocks; each fp32 tree-verify
   case also against its plain version run in fp64, the difference
   printed) (kernel and SDPA: device time of calls queued
   back to back behind a sleep kernel, ``device_ms``; the kernel's wrapper
   call with its host work and the plain version: CUDA events around
   back-to-back calls, ``time_ms``):
   a. K1, paged tree verify, at minitron-4b head shapes (B=4, Hq=24,
      Hkv=8, D=128, block 16, T=16 and T=5): ragged lengths, NULL holes
      below ``cache_len``, block 0 poisoned with 0, +-1e4, NaN and inf
      (outputs must be bitwise equal);
   b. K1 at gemma3-1b head shapes (Hq=4, Hkv=1, D=256; the prefix layer);
      and at vicuna-tiny's (B=4, 4 over 4 heads of 64, T=16, block 16,
      lens 32/48/64/80 and 0/37/300/500; the paper's fp32 loop), two
      identical calls bitwise equal in each;
   c. K4, windowed paged verify, at gemma3-1b head shapes (B=4, block 16,
      T=16 and T=5, lens 0/37/700/1500, NULL holes, windows 0 and 512):
      outputs bitwise equal with block 0 poisoned and with every pool
      position at or behind ``cache_len - 512`` poisoned, and K4 at
      window 0 bitwise equal to K1;
   c'. the tree-verify kernel's split: K1 (minitron-4b heads), K4
      (gemma3-1b heads, window 512) and K2 (minitron-4b heads) with the
      split forced to one split over the capacity, to the planner's and
      to 16, against their plain versions, and two identical calls
      bitwise equal (the merge uses no atomics); K1 over a pool of
      128-position blocks bitwise equal to K2 over the same keys (one
      split rule for every block size);
   d. K3, prefill attention, at gemma3-1b and minitron-4b head shapes,
      S in {37, 300, 1536}, windows 0 and 512; and at deepseek-v2-lite's
      MLA prefill (16 heads over 16, q/k 192 and v 128 at their own
      widths, scale 1/sqrt(192), S=1536) against ``blocked_attention``,
      timed unpadded; then K3's chunk form (a query offset and
      ``kv_valid_len``): C = 256 rows at offsets 0, 256 and 1280 over a
      view of 2048 keys valid to offset + C, fp32 and bf16, at gemma3-1b's
      heads (windows 512 and 0), minitron-4b's and the MLA widths, against
      its plain version; poison (NaN, inf, +-1e4) past ``kv_valid_len``
      must change no bit, and the chunk's rows must equal the same rows
      of one whole-prefill call on the same operands bit for bit; each
      dtype at offset 1280 timed against its bound and SDPA with a
      boolean (C, view) mask; each fp32 timing also beside the 3xTF32
      bound (its operations at 495 / 3 TFLOP/s) with each launch's µs
      and blocks;
   e. K5, absorbed-MLA paged verify (split sweep + merge), at
      deepseek-v2-lite shapes (B=4, 16 heads, latent 512, rope 64, block
      16, T=16, lens 0/37/700/1500, NULL holes): fp32 throughout, then
      bf16 pools, with block 0 poisoned (outputs bitwise equal), the
      split forced to one split, the planner's and 16 (two identical
      calls bitwise equal at each); fp32 (3xTF32) also against the plain
      version in fp64, with the margin worst err / (atol + rtol |ref|),
      and timed beside the 3xTF32 bound with each launch's µs and
      blocks; the windowed form (q_pos = cache_len + depth) at windows
      512 and 1, fp32 and bf16, against its plain version at the
      planner's split and 16, bitwise equal under poison in the NULL
      block and behind the window and across two identical calls, and
      timed; window 0 bitwise equal to the unwindowed call; SDPA on the
      gathered view (Dk 576, Dv 512, a boolean mask) as the yardstick;
   f. K6, chunked decay linear attention, at rwkv6-1.6b shapes (B=1,
      32 heads, dk = dv = 64, chunk 64): S in {37, 300, 1536}, with and
      without an initial state, strong-decay cases (log-decay down to
      -20 a step; S=300 and 1536) and a B=2 case, and in fp32 also at
      reduced rwkv6-1.6b's 4 heads and chunk 16 (S 9, 40 and, B=2 with
      strong decay, 300); output and final state; each fp32 case's
      margin, the worst err / (atol + rtol |ref|), printed, and two
      identical fp32 calls bitwise equal; one chunk launch and one scan
      launch a call; a
      length-masked pad tail
      (k = 0, w = 0 past the real length) bitwise equal to the
      exact-length call; no PyTorch call computes it (no yardstick); and
      across a chunk boundary: two calls of 768 tokens, the second from
      the first's final state, against one call of 1536 (K6's tolerance;
      whether bitwise is printed); then six strong-decay fp32 draws at
      S=1536 with an initial state from numpy seeds (``K6_STRONG_SEEDS``,
      which ``scripts/k6_f32_error_sources.py --draws`` runs through
      JAX's fp32 path on the CPU) against the plain version and the fp64
      recurrence, every margin printed, the kernel's against fp64 at most
      the plain fp32 version's plus one;
   g. K2, dense tree verify, at minitron-4b shapes (B=4, 24 q over 8 kv
      heads, D=128, dense S=512, lens 0/37/144/300, T=16 and T=5) and at
      gemma3-1b's global-layer shapes (4 over 1, D=256, S=1536, lens
      0/37/700/1500), and at vicuna-tiny's (T=16, S=640, 3b's lens):
      cache positions at or past ``cache_len`` poisoned with 0, +-1e4,
      NaN and inf, and two identical calls (outputs bitwise equal); SDPA
      on the dense cache with a boolean mask as the yardstick;
   h. K1 at deepseek-v2-lite's prefix-layer shapes (B=4, 16 q over 16 kv
      heads, D=128, T=5, lens 0/37/700/1500), timed;
   i. the tree-verify kernel past 64 query rows per kv head: K1 and K2 at
      starcoder2-7b (36 q over 4 kv heads: 144 rows at T=16, three row
      groups), qwen2.5-32b (40 over 8: 80) and chameleon-34b (64 over 8:
      128) head shapes, D=128, B=4, T=16, lens 0/37/700/1500 (NULL holes
      for K1, dense S=1536 for K2), fp32 and bf16 against their plain
      versions; block 0 (K1) or every position at or past ``cache_len``
      (K2) poisoned with 0, +-1e4, NaN and inf (bitwise equal); the split
      forced to one split, the planner's and 16, two identical calls
      bitwise equal; the first 4 query heads of each kv head out of the
      full call bitwise equal to a call on those heads alone at the same
      split (row groups share nothing); bf16 timed beside its bound with
      the keys read once (and, printed beside it, once per row group, as
      the kernel reads them) and SDPA; and in bf16 at the split of each
      of the planner's two candidate rules (a split column of B*Hkv
      blocks, or of B*Hkv times the row groups), both timed;
   j. zamba2-1.2b's shared attention block: K1 (B=4, 32 q over 32 kv
      heads, D=64, a chain of T=5, block 16, lens 0/37/700/1500, NULL
      holes) and K2 at the same heads over a dense S=1536, fp32 and bf16
      against their plain versions, block 0 (K1) or every position at or
      past ``cache_len`` (K2) poisoned and two identical calls bitwise,
      bf16 timed beside its bound and SDPA; K3 at (64, 64), 32 over 32,
      window 0, S in {37, 300, 1536} and its chunk form (C=256 at offset
      1280 over 2048 keys), as in d;
   k. K3 at hubert-xlarge's encoder heads (16 over 16, D=80,
      bidirectional), S in {37, 300, 1536}, fp32 and bf16 (the (80, 80)
      build of each) against its plain version;
      poison (0, +-1e4, NaN, inf) in memory past the sequence changes no
      bit; bf16 also against the plain version in fp32 on the same bf16
      operands: relative L2 error at most 5e-3, and K3's output 1% off
      failing that bound; each dtype at S=1536 timed beside its bound (4
      S^2 D H flops at its peak) and non-causal SDPA;
   l. the autotuner (``kernels/autotune.py``): every key of
      ``required_keys()`` (K3's key tile, at each registry config's
      build, heads and mask) swept at S=1536, each candidate first held
      against its plain version (bf16, 2e-2; a causal one also a chunk's
      rows == the whole prefill's), then timed in turns over 7 rounds
      (device time, medians); one JSON line of the winners and the µs
      per candidate with the card and its power limit; then ``check`` of
      the committed ``results/autotune.cuda.json`` (a missing key fails
      the run; a winner that differs from this sweep's is printed, not
      failed: timing noise);
   m. the backward kernels (``csrc/linear_attn_chunk_bwd.cu``,
      ``csrc/flash_attention_bwd.cu``; no TPU kernel had one) against
      their plain versions in fp32 on the same operands
      (``ref.py::decay_attention_chunked_bwd``, ``kernel.py::
      flash_attention_bwd_plain``), at training's shapes: K6 at rwkv6-1.6b
      (B=1, 32 heads, chunk 64, u; S=1024 and 500 in bf16, 500 in fp32;
      fp32 also at 4 heads, chunk 16: S=40, and S=300 at B=2 with strong
      decay),
      K3 at gemma3-1b's (256, 256) 4/1 with windows 512 and 0,
      zamba2-1.2b's (64, 64) 32/32, deepseek's (192, 128) 16/16 at MLA's
      scale, (128, 128) 16/16, hubert's (80, 80) 16/16 bidirectional (bf16,
      S=1024) and fp32 at D=64, 256, (80, 80) and (192, 128) (S=512):
      every gradient within
      relative L2 1e-4 (fp32) or 5e-3 (bf16), one off by 1% on its odd
      channels past that bound, two identical calls bitwise equal; K3's
      forward output bitwise the same with and without its log-sum-exp
      pointer, the log-sum-exp within 1e-3 of its plain version; each
      timed (device time of the backward's launches) beside its bound
      (``op_cost.k6_bwd_charge``, ``flash_bwd_charge``), its plain
      version and, for K3, SDPA's backward alone (``torch.autograd.grad``
      of one SDPA output, graph retained), and each of its launches timed
      on its own with the blocks of its grid (``launch_split``: K3's
      dQ with delta, dK/dV and the partials' sum, in either dtype; K6's
      increment, carry, gradient pass and du, or in fp32 its
      scan, gradient pass and du);
4. tiny fp32 parity (every phase runs in the autotuner's mode ``on``
   under the committed cache; phases 4-6 print the winners each model
   resolves): ``minitron-4b.reduced()``, a reduced gemma3-1b
   whose 16-token window binds, ``deepseek-v2-lite-16b.reduced()`` and
   ``rwkv6-1.6b.reduced()``, Hydra++ served through the paged engine
   (K1, K4, K5, K3; K6 on every bucket-padded prefill of rwkv6, with a
   preemption), equal the port's dense ``generate()`` (which runs K2 on
   the window-0 GQA layers: so paged == dense holds K1 against K2); and
   so do the same paged engines with chunked prefill at chunk 8 and 16
   (every K3 call in its chunk form; rwkv6's chunk snapped to its scan's
   16); then the head-preserving narrow forms of starcoder2-7b,
   qwen2.5-32b, chameleon-34b and deepseek-moe-16b (``configs.
   head_preserving``: the published head counts, 2 layers, d_model 256,
   head_dim 64; 144, 80, 128 and 16 query rows per kv head), paged engine
   == dense ``generate()``, whole prompts and in chunks of 8; then
   ``zamba2-1.2b.reduced()`` (shared, mamba 1, shared, mamba 1) and its
   5-layer form with the block every 2 layers, with a preemption, whole
   prompts and in chunks of 16 (K1, K2, K3 on the shared block);
5. full width, bf16, random weights drawn on the card from a seeded
   ``torch.Generator``; for each model one verify step paged against
   dense from the same prefill (prefill through K3, then through K3's
   plain version; with K3, argmax must agree on at least 14 of the 16
   tree positions), then the paged engine serves 8 requests with every kernel
   launch counted (each tree-verify or K5 call also launches its merge,
   each K6 call its scan, counted apart, printed, and required equal to
   the first launches):
   - minitron-4b: prompts 64-256, 32 new tokens, max_batch 4, block 16,
     max_len 512, pool half the dense footprint; 33 K1 launches per
     decode step (32 layers + the prefix layer) and 33 K3 launches per
     prefill;
   - gemma3-1b: prompts 600-1500 (every context passes the 512 window),
     32 new tokens, max_batch 4, block 16, max_len 2048, pool half the
     dense footprint; 26 K4 + 1 K1 launches per decode step and 27 K3
     launches per prefill, re-prefills after a preemption included;
   - minitron-4b again through the continuous (dense) engine: 33 K2
     launches per decode step and 33 K3 per prefill;
   - the dense verify of the paged-vs-dense pair check launches K2 once
     per window-0 GQA layer: 32 at minitron-4b, 4 at gemma3-1b;
   - rwkv6-1.6b (24 layers, d 2048, 32 wkv heads of 64, ~1.38B
     parameters): one prefill through K6 and one through its plain
     version from the same prompt; every layer's K6 call held against
     the plain version on the same operands (final state to a relative
     1e-3, output to a relative norm 3e-3 and within 2e-2; each must
     fail a K6 whose output or state is 1% off), then the two runs'
     final wkv states,
     first tokens and one chain verify step's logits printed (an argmax
     may differ only in a near tie); then the gemma3-1b traffic through
     the paged engine, 24 K6 launches per prefill (re-prefills
     included) and no kernel launch in a decode step;
   - deepseek-v2-lite-16b (MLA + MoE, ~15.7B parameters; the earlier
     models are freed first): the same traffic as gemma3-1b; 27 K5 + 1
     K1 launches per decode step and 28 K3 launches per prefill.  Top-k
     routing amplifies rounding layer by layer, so its verify step is
     held at full width with depth cut (fp32 at 5 layers: relative
     logit difference 1e-4 and every argmax; bf16 at 2 layers: 0.01 and
     14 of 16; each must fail a K5 whose output is 1% off) and printed
     as a reading at full depth;
   - the rest of the attention registry, one model at a time, each at
     full width and full depth with gemma3-1b's traffic, its weights,
     draft heads and fp32 unembedding printed: starcoder2-7b (33 K1
     launches per decode step, at 144 rows per kv head, and 33 K3 per
     prefill), qwen2.5-32b (QKV bias; 65 and 65, 80 rows), chameleon-34b
     (token ids; 49 and 49, 128 rows; ~75 GB of weights), each with the
     paged-vs-dense verify check (K2 at the same rows on every layer);
     deepseek-moe-16b (GQA under the DeepSeek MoE; 29 and 29) held as
     deepseek-v2-lite is, a K1 1% off the planted fault;
   - zamba2-1.2b (38 Mamba2 layers, d 2048, 64 SSD heads of 64, d_state
     64, and 7 invocations of one shared attention + MLP block, 32 heads
     of 64; ~1.2B parameters), gemma3-1b's traffic at full depth: one
     chain verify step paged (K1 on the 7 invocations) against dense (K2
     on them) from the same prefill, bitwise equal; each of that
     prefill's 7 K3 calls against its plain version on its own operands
     (2e-2); the bf16 prefill through K3 against one through its plain
     version, a reading only (random weights carry bf16 rounding through
     the 38 recurrent layers to a relative logit difference near 1, past
     telling a right K3 from a wrong one; phase 5b holds it in fp32);
     7 K1 launches per decode step, 7 K3 per prefill, no K6;
5b. chunked prefill at full width through the paged engine (chunk 256, a
   budget of one chunk a step), phase 5's requests, against phase 5's
   whole-prompt joins (streams token-identical printed, with both runs'
   TTFT, p99 ITL and tok/s), every launch counted per decode step and per
   chunk:
   - gemma3-1b: 27 K3 launches per chunk, all in the chunk form; the
     logits of the last 16 positions of a 1000-token prompt prefilled in
     chunks held against one whole prefill (max |diff| / max |logit| <=
     0.1, argmax agreement >= 14 of 16);
   - rwkv6-1.6b: 24 K6 launches per chunk, each from the carried state;
     the chunked prefill's logits held in fp32 at full width (relative
     1e-3, every argmax) at the 16 positions after each chunk boundary
     and the last 16, a chunked prefill that drops its carried state
     failing that bound; in bf16 a reading (random weights amplify bf16
     rounding layer by layer);
   - zamba2-1.2b: 7 K3 launches per chunk (the chunk form), the SSD
     from the carried state; held in fp32 as rwkv6 is, the planted fault
     a chunked prefill that drops its carried conv window; bf16 a
     reading; and in fp32 one whole prefill through K3 against one
     through its plain version, at the same positions and bound, a K3
     1% off failing it;
   - deepseek-v2-lite-16b at 2 layers, the MoE check's bf16 depth
     (widths kept): whole-prompt joins, then chunks; 3 K3 launches (the
     (192, 128) form) per chunk; a chunk boundary changes which tokens
     overflow an expert's capacity, so its logits are a reading;
6. the async window and the captured step, for each model of phase 5 at
   full width: three replays of the captured step (one CUDA graph of the
   whole decode step) from a state of 4 joined prompts, each bitwise
   equal to the eager step from the same state (``emitted``,
   ``n_emitted``, ``cache_len``, ``last_token``, ``last_hidden``); then
   phase 5's requests through the paged engine in four modes, in turns,
   three times (the synchronous eager loop, ``inflight=2`` eager,
   ``inflight=2`` captured, the engines' default, and ``inflight=1``
   captured), one engine per mode kept across its serves: every stream
   token-identical to the synchronous eager loop's, no block left in use
   (gemma3-1b's pool preempts under ``inflight=2``), launches per capture
   equal to phase 5's per-step counts and one replay a step, and a serve
   fed by a generator source reusing the one capture; each mode's step
   time, tok/s, TTFT, p99 ITL, ``host_stall_s`` and ``read_wait_s`` per
   turn, and the device's idle share under the graph (a traced serve's
   device time over its wall time) printed beside the card's name and
   power limit; the four models of the rest of the registry in two
   modes, the synchronous eager loop and the default, one turn each, with
   the peak memory of the phase; zamba2-1.2b in the four modes, one
   turn.  Three models run this phase at a cut depth, from weights of
   their own (widths kept): deepseek-v2-lite-16b at 2 layers (phase
   5b's), zamba2-1.2b at 12 layers (two invocations of the shared
   block), rwkv6-1.6b at 12 layers (to keep the script inside its time
   limit).  Phases 4, 5, 5b and 5c serve through the engines' defaults
   (``inflight=2``, the step captured): the decode step's launches are
   counted at its capture and its eager warm-up, its replays by the
   capture;
5c. sampled decoding at full width, bf16, through the engines' defaults
   (async, the step captured) with JAX's defaults (typical acceptance, τ
   0.7, ε 0.15): gemma3-1b's and rwkv6-1.6b's phase 5 traffic through the
   paged engine under ``criterion="typical"``, and minitron-4b's through
   the continuous engine with ``use_speculative=False`` (tokens drawn at
   τ): launches per capture and per prefill equal to phase 5's greedy
   counts (26 K4 + 1 K1 at gemma3-1b, none at rwkv6-1.6b; 32 K2 a step at
   minitron-4b's autoregressive step), no block left in use; a second
   serve with the same seed gives the same streams; at ``max_batch=1``
   two requests in turn give the same streams in the four loop modes of
   phase 6; three replays of the sampled step captured as a CUDA graph
   are bitwise equal to the eager step from the same state and the same
   generator state; tok/s, tokens per step, the mean accepted length,
   TTFT and p99 ITL printed beside phase 5's greedy figures.  Once, the
   sampler itself: 2^20 Gumbel-max draws over one logit row of 1024 at
   τ 0.7 from an engine's generator, eagerly and replayed inside a CUDA
   graph (a replay bitwise equal to the eager draw from the same
   generator state, two replays different), each passing a chi-square
   test against ``softmax(logits / τ)`` over the bins with p > 1e-3 (p
   value above 1e-4), and draws that ignore τ failing it;
5d. hubert-xlarge (48 layers, d 1280, 16 heads of 80, FFN 5120, 504
   targets; ~1.26B parameters drawn on the card) at full width over
   frames (2, 1500, 1280), 30 s of audio at 50 frames a second: one bf16
   encoder forward makes 48 K3 launches, all bidirectional at (80, 80),
   timed with its peak memory; in a second forward each K3 call is held
   against its plain version on its own operands (2e-2) and against the
   plain version in fp32 on the same bf16 operands (relative L2 error at
   most 5e-3, K3's output 1% off failing it); then in fp32 one
   forward through K3 against one through its plain version: relative
   logit difference at most 1e-4 and every argmax over the 504 targets
   at 64 positions, and K3's output 1% off failing that bound;
5e. training: (i) gemma3-1b in bf16 at full width through the train
   launcher's own ``main`` (``--full-config --steps 3 --batch 1
   --seq-len 1024``): 26 K3 launches a step, every one through K3's
   autograd wrapper (``grad_launches``) and each with one call of the
   backward kernels (``bwd_launches``), finite losses, step time,
   tokens/s and peak memory printed; then three steps on one repeated
   batch (learning rate 0, 1e-3, 5e-4), whose loss must fall from the
   second step to the third; where a step's time goes (forward,
   backward, K3's backward calls, update; the backward kernels' device
   time in a traced step); (ii) gemma3-1b's Hydra++ heads (4 heads, 4
   MLP layers, prefix attention), ``distill``, the bf16 base frozen, B=2,
   S=512, 3 steps of ``train_heads``: 27 K3 launches a step (26 without a
   gradient, the prefix layer's under autograd), the base params bitwise
   unchanged and without a ``.grad``; step time and peak memory printed;
   (iii) in fp32 at full width, B=1, S=512, one ``head_train_loss``
   through K3 against one with K3's plain version swapped in: the loss's
   relative difference and each draft leaf's gradient's relative L2
   difference within ``GRAD_CHECK_BOUND``, a K3 1% off at the prefix layer
   failing them, and so a K3 whose backward's dk is 1% off on its odd
   channels; (iv) vicuna-tiny in fp32 through
   ``scripts/torch_train_tiny.py``'s recipe (``training/tiny.py::
   train_tiny``, into a directory under ``build/``): 300 base steps and
   300 Medusa and 300 Hydra head steps (``data``) on the synthetic
   corpus, each variant's acceptance length above its untrained heads'
   (their order printed), the three checkpoints loaded back into fresh
   params bitwise equal to the trained trees, the Hydra heads on four
   eval prompts of 32 tokens and 48 new tokens through ``generate`` and
   the paged engine (``default_tree(16, 4, 4)``, greedy), the streams
   equal, the mean accepted length printed beside the untrained heads'; the
   port's example ``examples/torch_train_hydra_pp.py`` on the same base
   checkpoint (its ``CKPT`` pointed at the phase's directory; the base
   restored, not retrained): Medusa and Hydra heads (``data``) and
   Hydra++ (4 MLP layers, prefix attention, ``distill``) trained 300 steps
   each, each variant's mean accepted length above the untrained heads',
   their order printed (the paper's Fig. 2); then
   ``measure_rank_acc``, ``grow_trees`` and ``select_tree``, the chosen
   tree's size and expected length printed;
5f. EAGLE: (i) minitron-4b in bf16 at full width, a K=4 chain, prompts of
   600, 900, 1200 and 1500 tokens one at a time: 33 K3 launches a prefill
   (32 layers and the EAGLE layer), then 32 new tokens through
   ``eagle_spec_step``, 37 K2 launches a step (32 verify, 4 draft, 1
   rebuild) and as many merges, each K2 call of each prompt's first step
   held against its plain version (2e-2); step time and tokens/s printed;
   (ii) the same in fp32: the EAGLE greedy stream equals the
   autoregressive greedy stream for each prompt's first 16 tokens, a
   divergence passing only at a near tie (top-2 logit gap below 1e-4),
   which is printed; (iii) vicuna-tiny: an EAGLE layer trained 300 steps
   on 5e(iv)'s base, as ``benchmarks/bench_fig10_eagle.py`` trains it,
   its mean accepted length printed beside the trained Hydra heads';
5g. base training of the recurrent and MoE archs, bf16 at full width,
   random weights drawn on the card, 3 steps of (1, 1024) tokens each:
   (i) rwkv6-1.6b at full depth through the train launcher's own ``main``
   (``--full-config``): 24 K6 launches (and scans) a step, every one
   through K6's autograd wrapper (``grad_launches``) and each with one
   call of its backward kernels (``bwd_launches``), u's reduction among
   them (``bwd_du_launches``), and
   where a step's time goes (as 5e(i)); (ii) zamba2-1.2b
   the same way: 7 K3 launches at (64, 64) a step, all under autograd
   (its SSD is plain PyTorch, as JAX's is jnp); each then three steps on
   one repeated batch (learning rate 0, 1e-3, 5e-4), whose loss must fall
   from the second step to the third; (iii) deepseek-v2-lite-16b and
   deepseek-moe-16b cut to 2 layers (the dense first layer and one MoE
   layer) through the launcher's ``make_train_step``: 2 K3 launches a
   step under autograd ((192, 128) and (128, 128)), the router's
   ``aux`` finite and above 0 each step; step time, tokens/s, peak
   memory and losses printed for each; (iv) rwkv6-1.6b in fp32 at full
   width, 2 layers, B=1, S=500: one ``lm_loss`` through K6 against one
   with K6's plain version swapped in, the loss's relative difference and
   each base leaf's gradient's relative L2 difference within
   ``K6_GRAD_BOUND``, a K6 whose odd output channels are 1% off failing
   them (a uniform scale would cancel in RWKV6's GroupNorm), and so a K6
   whose backward's dk is 1% off on its odd channels;
5h. the port's serving examples at their default steps, vicuna-tiny in
   fp32 (``training/tiny.py``'s checkpoints in a fresh directory under
   ``build/``): ``examples/torch_quickstart.py`` (its accepted length and
   its speculative and autoregressive step counts, the greedy outputs
   identical), ``examples/torch_serve_spec.py`` (AR, Medusa, Hydra and
   Hydra++ through the continuous, paged and bucketed engines, their
   rows; the three engines' greedy streams equal in each mode) and
   ``examples/torch_tree_search.py`` (tok/s per tree and the chosen
   size, the checkpoints restored, not retrained);
7. the dry run against the card (``repro_torch/launch/{dryrun,specs,
   op_cost,roofline}.py``): (a) started once phase 2 has built the
   kernels, in a process group of its own with no card visible, ``python
   -m repro_torch.launch.dryrun --all --host --jobs 4`` counts one step of
   each of the ten archs at each of the four input shapes on ``meta``
   beside phases 3-5h; here every pair must be ``ok``, or ``skip`` with
   JAX's reason, none ``error``, one line a pair (flops by dtype, bytes,
   argument and peak live GiB, the compute and memory terms, the
   bottleneck), and the sweep's own time and the wait for it printed;
   after it, in the same process group, ``scripts/torch_opt_sweep.py``
   sweeps the four padded archs (``pad_q_heads_to=16``) at the four
   shapes on ``pod16x16``: ``ok`` or ``skip`` as JAX's reason says, none
   ``error``, each padded pair's argument bytes and useful flops ratio
   printed;
   (b) for phase 6's models (minitron-4b, gemma3-1b, rwkv6-1.6b, and
   deepseek-v2-lite-16b at its 2 layers), weights drawn on the card: the
   bytes the specs give for params, draft params and the decode state
   (B=4, the workload's max_len) equal what the port allocates, exactly,
   and the counter's peak live bytes of one eager paged decode step (and
   minitron-4b's dense one) within 10% of the card's
   ``max_memory_allocated`` growth over it; (c) the counter's roofline
   ``t_roof = max(compute, bytes / HBM)`` of the same step on ``meta``
   against its device time on the card (traced device busy of the
   captured paged step from 4 joined prompts, a replay; of the eager
   dense-cache step ``launch/specs.py::make_serve_step`` at minitron-4b;
   of the eager prefill ``make_prefill_step`` of 1536 tokens at gemma3-1b
   and rwkv6-1.6b): ``0 < t_roof / t_meas <= 1.05``, and each kernel
   call's charge equal to the bound phase 3's function gives for its
   shape at that capacity; (d) gemma3-1b with ``pad_q_heads_to=16`` (16
   q heads over the one kv head of 256, G=16) at full width and depth,
   bf16, random weights, Hydra++ heads: K3 at 16 over 1 (256, 256), K1
   and K4 at T=16 (256 query rows, four row groups) against their plain
   versions in both dtypes (as phase 3, timed, printed beside the
   unpadded gemma3-1b's), the argument bytes against the specs, phase 5's
   requests through the paged engine (whole prefills, the captured step,
   every launch counted), a replay bitwise equal to the eager step, and
   7(c)'s roofline on the captured decode step and the prefill;
8. a JSON line with each kernel's numbers (the launches of phases 5e-5h
   added to K3's, K2's and K6's entries, with ``grad_launches``, those
   under autograd, and ``launches_5g``, K3's in 5g by build) (K3's chunk form as its own
   entry, ``flash_attention_chunk``; K1 and K2 at each model past 64 rows
   per kv head as entries of their own, ``tree_attention_paged@<arch>``,
   with the launches of that model's phase 5 and the bound with keys read
   once per row group beside ``bound_ms``; K1, K2 and K3 at zamba2-1.2b's
   shared block, ``...@zamba2-1.2b``; K3 at hubert-xlarge's encoder,
   ``flash_attention@hubert-xlarge``, with phase 5d's launches; the
   backward kernels as ``linear_attn_chunk_bwd`` and
   ``flash_attention_bwd``, with phase 3m's numbers at rwkv6-1.6b's
   (1, 1024) and gemma3-1b's window-512 layer and the ``bwd_launches`` of
   phases 5e-5h; their ``replaces`` names the JAX function whose gradient
   they compute; K3's fp32 builds as ``flash_attention@fp32`` and
   ``flash_attention_bwd@fp32``, with the fp32 launches (backward calls)
   of phases 5-5h, the 3xTF32 bound beside the CUDA-core one, and each
   case's µs, bounds, plain and SDPA times and launches' µs and blocks;
   the tree-verify kernel's fp32 builds as ``tree_attention_paged@fp32``,
   ``tree_attention_dense@fp32`` and
   ``tree_attention_paged_windowed@fp32``, with the fp32 launches of
   phases 4-5h (vicuna-tiny's serves among them; each form must have
   some), the same per-case numbers and the fp64 difference; K6's fp32
   builds as ``linear_attn_chunk@fp32`` and ``linear_attn_chunk_bwd@fp32``,
   with the fp32 calls of phases 4-5h (each must have some), those of
   their kernel checks (3f, 3m) apart, each launch's µs and blocks and
   the forward's worst margin ``tol_ratio``; K5's fp32 build as
   ``mla_attention_paged@fp32``, with the fp32 launches of phases 4-5h
   (it must have some), both bounds, its fp64 difference and margins,
   each launch's µs and blocks and the windowed cases; K1, K4 and K3 at
   the padded gemma3-1b as ``...@gemma3-1b-pad16``, with 7(d)'s
   launches; the fp32 K6 entry also has each strong draw's margins),
   then the result line.
   ``[time]`` lines give each phase's seconds.

The script stands alone: it puts ``src/`` on ``sys.path`` itself, and it
fails (without a result line) where CUDA is missing or the package is not
beside it.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
# the card's name and power limit, as nvidia-smi gives them (set by main)
CARD = ""

TOLS = (("float32", 1e-4), ("bfloat16", 2e-2))
POISONS = (0.0, 1e4, -1e4, math.nan, math.inf)


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters: int = 50) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events around
    ``iters`` calls after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn()`` in ms, without the host's time between
    launches: a sleep kernel holds the stream while ``iters`` calls are
    queued behind it (the sleep lasts at least twice their measured
    enqueue time), so the CUDA events around them time the device running
    them back to back.  ``fn`` must not synchronise with the host."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # clock64 ticks at <= 2 GHz on an H100: 2e9 cycles a second at least
    torch.cuda._sleep(int(2e9 * max(2e-3, 2 * enqueue_s)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def launch_split(fn, expect_ms: float = None, iters: int = 10,
                 tries: int = 3) -> dict:
    """Each kernel that ``fn()`` launches: {name (template arguments, no
    namespace): (mean device µs a call, blocks of its grid)}, read from
    the kernel events of a ``torch.profiler`` trace of ``iters`` calls
    after a warm-up (the device's own start and end of each launch).  A
    kernel launched twice a call counts both in its µs.  The profiler has
    been seen to drop kernel events from a trace: given ``expect_ms``,
    the call's device time, a trace whose launches add up to less than
    80% of it is taken again, up to ``tries`` times in all."""
    for _ in range(tries):
        split = _trace_split(fn, iters)
        total_ms = 1e-3 * sum(us for us, _ in split.values())
        if expect_ms is None or total_ms >= 0.8 * expect_ms:
            break
    return split


def _trace_split(fn, iters: int) -> dict:
    """One trace of ``launch_split``."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    path = SRC.parent / "build" / "launch_split.trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    split = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        name = re.sub(r"\(anonymous namespace\)::|^void ", "", e["name"])
        name = name.split("(", 1)[0]
        grid = e.get("args", {}).get("grid", [0])
        us, blocks = split.get(name, (0.0, 0))
        split[name] = (us + e["dur"] / iters, math.prod(grid))
    return split


def split_text(split: dict) -> str:
    """``launch_split``'s launches as one line: name, µs, blocks."""
    return ", ".join(f"{name} {us:.1f}us x{blocks} blocks"
                     for name, (us, blocks) in split.items())


def cycle(sets):
    """A function returning the operand sets in turn."""
    it = iter(range(10 ** 9))
    return lambda: sets[next(it) % len(sets)]


# each kernel template's parameter names, in order, as the lines of
# ``ptxas_lines`` and ``sass_tensor_cores`` print them: a type prints as
# "bf16" or "f32" (after the name, if any), an int as "name=value", a bool
# as its name where true
KERNEL_PARAMS = {
    "tree_attention_split_kernel": ("", "D", "windowed", "dense"),
    "tree_attention_merge_kernel": ("", "dense"),
    "flash_attention_kernel": ("", "DQK", "DV", "KN"),
    "mla_attention_split_kernel": ("kv", "DL", "DR", "windowed"),
    "mla_attention_merge_kernel": ("DL",),
    "linear_attn_chunk_kernel": ("", "C"),
    "linear_attn_scan_kernel": ("", "C"),
    "linear_attn_bwd_inc_kernel": ("C",),
    "linear_attn_bwd_inc_f32_kernel": ("C",),
    "linear_attn_bwd_chunk_f32_kernel": ("C",),
    "linear_attn_bwd_carry_kernel": (),
    "linear_attn_bwd_chunk_tc_kernel": ("C",),
    "linear_attn_bwd_du_kernel": (),
    "flash_bwd_kv_kernel": ("DQK", "DV"),
    "flash_bwd_kv_wgmma_kernel": ("DQK", "DV"),
    "flash_bwd_q_wgmma_kernel": ("DQK", "DV"),
    "flash_bwd_sum_kernel": ("",),
    "flash_bwd_q_kernel": ("DQK", "DV"),
    "flash_bwd_kv_f32_kernel": ("DQK", "DV"),
    "flash_bwd_q_f32_kernel": ("DQK", "DV"),
}


def kernel_name(symbol: str):
    """A kernel instantiation's readable name from its mangled symbol
    (``tree_attention_split_kernel<bf16, D=256, windowed>``; a kernel that
    is no template by its name alone), or None.  A name is found with its
    length before it, as the mangling writes it (the anonymous namespace's
    hash may end in a digit and hold underscores and digits itself)."""
    import re

    m = next((m for m in (re.search(rf"{len(n)}({n})([IE])", symbol)
                          for n in KERNEL_PARAMS) if m), None)
    if m is None:
        return None
    if m.group(2) == "E":
        return m.group(1) if not KERNEL_PARAMS[m.group(1)] else None
    rest, args = symbol[m.end():], []
    for pname in KERNEL_PARAMS[m.group(1)]:
        t = re.match(r"13__nv_bfloat16|f|Li(-?\d+)E|Lb([01])E", rest)
        if not t:
            return None
        rest = rest[t.end():]
        if t.group(0) in ("f", "13__nv_bfloat16"):
            dt = "f32" if t.group(0) == "f" else "bf16"
            args.append(f"{pname} {dt}" if pname else dt)
        elif t.group(1) is not None:
            args.append(f"{pname}={t.group(1)}")
        elif t.group(2) == "1":
            args.append(pname)
    return f"{m.group(1)}<{', '.join(args)}>"


def ptxas_lines(report: str) -> list:
    """One line per kernel instantiation of a ``ptxas -v`` report: its
    name (``kernel_name``), registers, stack frame and spills."""
    out, name, frame = [], None, ""
    for ln in report.splitlines():
        if "Function properties for" in ln:
            name = kernel_name(ln.split("Function properties for", 1)[1])
        elif name and "stack frame" in ln:
            frame = ln.strip()
        elif name and "registers" in ln:
            regs = ln.split("Used", 1)[1].split(",")[0].strip()
            out.append(f"{name}: {regs}; {frame}")
            name = None
    return out


def sass_tensor_cores(lib_path, ops=("HMMA", "HGMMA")) -> dict:
    """{kernel name: whether its SASS holds one of ``ops`` (by default a
    tensor-core instruction, HMMA or HGMMA)}, from ``cuobjdump -sass`` of
    a built library."""
    from repro_torch.kernels import build

    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    found, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = kernel_name(ln.split("Function :", 1)[1].strip())
            if name:
                found[name] = False
        elif name and any(op in ln for op in ops):
            found[name] = True
    return found


def assert_bitwise(outs, what: str) -> None:
    import torch

    torch.cuda.synchronize()
    for o in outs[1:]:
        if not torch.equal(o, outs[0]):
            raise AssertionError(f"{what}: outputs are not bitwise equal")


def compare(out, ref, tol: float, what: str) -> float:
    """Max abs error of the kernel against its plain version; raises past
    the tolerance or on a non-finite output."""
    import torch

    if not torch.isfinite(out).all():
        raise AssertionError(f"{what}: output not finite")
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol,
                               msg=lambda m: f"{what}: {m}")
    return (out.float() - ref.float()).abs().max().item()


# ---------------------------------------------------------------------------
# phase 3a-c: paged verify kernels K1 and K4 against their plain versions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PagedCase:
    """Head shapes, slot lengths, NULL holes and table width of a run."""
    hq: int
    hkv: int
    d: int
    lens: tuple
    holes: tuple          # (slot, logical block) entries punched to NULL
    m: int                # table entries per slot
    bs: int = 16


# minitron-4b heads, max_len 512; gemma3-1b heads, max_len 1536
MINITRON = PagedCase(24, 8, 128, (0, 37, 144, 300), ((2, 3), (3, 0)), 32)
GEMMA3 = PagedCase(4, 1, 256, (0, 37, 700, 1500),
                   ((2, 20), (3, 70), (3, 0)), 96)
WINDOW = 512
# the full-width paged-vs-dense verify check: at most 2 of the 16 tree
# positions may take another argmax (random weights give near ties)
MIN_ARGMAX_AGREEMENT = 14 / 16
# the bf16 builds the main path runs, as ``kernel_name`` names them; each
# must be found in the ptxas report without a spill.  The tree-verify
# split kernel: zamba2-1.2b's shared-block K1 and K2 (D=64), minitron-4b's
# K1 and K2 (D=128) and deepseek's prefix K1, gemma3-1b's K4 and prefix
# K1 (D=256) and its dense verify's K2; K3 at zamba2-1.2b's (64),
# hubert-xlarge's (80), minitron-4b's, gemma3-1b's and deepseek's MLA
# widths
TREE_VERIFY_BUILDS = frozenset({
    "tree_attention_split_kernel<bf16, D=64>",
    "tree_attention_split_kernel<bf16, D=64, dense>",
    "tree_attention_split_kernel<bf16, D=128>",
    "tree_attention_split_kernel<bf16, D=256>",
    "tree_attention_split_kernel<bf16, D=256, windowed>",
    "tree_attention_split_kernel<bf16, D=128, dense>",
    "tree_attention_split_kernel<bf16, D=256, dense>",
    "tree_attention_merge_kernel<bf16>",
    "tree_attention_merge_kernel<bf16, dense>"}) | frozenset(
    # the fp32 builds (3xTF32) the main path runs, all at D=64: vicuna-tiny's
    # K1 and K2 in phases 5e(iv) and 5h, and every form in phase 4's fp32
    # parity (each reduced config has heads of 64), and their merges
    [f"tree_attention_split_kernel<f32, D=64{form}>"
     for form in ("", ", windowed", ", dense")]
    + ["tree_attention_merge_kernel<f32>",
       "tree_attention_merge_kernel<f32, dense>"])
def k3_builds() -> frozenset:
    """K3's bf16 instances the main path runs: each build at the key tile
    each required key (a registry config's call of it) resolves under the
    committed autotuner cache."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.flash_attention.ops import resolve_key_tile

    tile = lambda s: resolve_key_tile(s["dqk"], s["dv"], s["hq"], s["hkv"],
                                      bool(s["causal"]))
    return frozenset(
        f"flash_attention_kernel<bf16, DQK={s['dqk']}, DV={s['dv']}, "
        f"KN={tile(s)}>" for _, s in autotune.required_keys().values())


# every K5 instance: its split sweep over bf16 pools (deepseek-v2-lite's
# serving) and fp32 ones (3xTF32; phase 4's reduced deepseek runs (64, 16))
# at both widths, windowed or not, and its merges; K6's chunk kernel and
# scan in bf16 at rwkv6-1.6b's chunk of 64, and their fp32 builds (3xTF32)
# at both chunks (the reduced configs' 16)
MLA_BUILDS = frozenset(
    f"mla_attention_split_kernel<kv {dt}, DL={dl}, DR={dr}{form}>"
    for dt in ("bf16", "f32") for dl, dr in ((512, 64), (64, 16))
    for form in ("", ", windowed")) | frozenset(
    f"mla_attention_merge_kernel<DL={dl}>" for dl in (512, 64))
K6_BUILDS = frozenset({"linear_attn_chunk_kernel<bf16, C=64>",
                       "linear_attn_scan_kernel<bf16, C=64>"} | {
    f"linear_attn_{k}_kernel<f32, C={c}>" for k in ("chunk", "scan")
    for c in (16, 64)})


def bwd_builds() -> frozenset:
    """Every instance of the backward kernels (K6's increment and
    gradient pass in bf16 and in fp32, its carry, du's reduction;
    K3's dQ (writing delta), dK/dV and the partials' sum at each bf16 and
    each fp32 build): each must be found without a spill."""
    from repro_torch.kernels.flash_attention.kernel import DIMS, F32_DIMS

    k6 = {f"linear_attn_bwd_{k}_kernel<C={c}>" for k in (
        "inc", "chunk_tc", "inc_f32", "chunk_f32") for c in (16, 64)}
    k3 = {"flash_bwd_sum_kernel<bf16>", "flash_bwd_sum_kernel<f32>"}
    for dqk, dv in DIMS:
        kv = dqk % 64 == dv % 64 == 0          # the builds on wgmma
        q = kv and dqk <= 192
        k3 |= {f"flash_bwd_kv{'_wgmma' * kv}_kernel<DQK={dqk}, DV={dv}>",
               f"flash_bwd_q{'_wgmma' * q}_kernel<DQK={dqk}, DV={dv}>"}
    for dqk, dv in F32_DIMS:
        k3 |= {f"flash_bwd_kv_f32_kernel<DQK={dqk}, DV={dv}>",
               f"flash_bwd_q_f32_kernel<DQK={dqk}, DV={dv}>"}
    return frozenset(k6 | k3 | {"linear_attn_bwd_du_kernel",
                                "linear_attn_bwd_carry_kernel"})


# the builds that must run on the tensor cores (SASS check): every build
# whose name starts so, and at least one of each (K3's fp32 builds too:
# their products run in 3xTF32)
TENSOR_CORE_KERNELS = ("tree_attention_split_kernel<bf16",
                       "tree_attention_split_kernel<f32",
                       "flash_attention_kernel<bf16",
                       "flash_attention_kernel<f32",
                       "flash_bwd_kv_f32_kernel<", "flash_bwd_q_f32_kernel<",
                       "mla_attention_split_kernel<kv bf16",
                       "mla_attention_split_kernel<kv f32",
                       "linear_attn_chunk_kernel<bf16",
                       "linear_attn_scan_kernel<bf16",
                       "linear_attn_chunk_kernel<f32",
                       "linear_attn_scan_kernel<f32",
                       "flash_bwd_kv_kernel<", "flash_bwd_kv_wgmma_kernel<",
                       "flash_bwd_q_kernel<", "flash_bwd_q_wgmma_kernel<",
                       "linear_attn_bwd_inc_kernel<",
                       "linear_attn_bwd_chunk_tc_kernel<",
                       "linear_attn_bwd_inc_f32_kernel<",
                       "linear_attn_bwd_chunk_f32_kernel<")
# the wrappers' second counters: each call of a two-launch kernel also
# launches its merge (tree verify, K5) or its scan (K6)
SECOND_COUNTERS = ("merge_launches", "scan_launches")


def paged_inputs(c: PagedCase, T: int, dtype, seed: int,
                 poison: float = 0.0, chain: bool = False):
    """K1 operands on the card (model layout) and the verify positions
    ``cache_len + depth`` K4 takes besides; the candidate tree is
    ``default_tree(T, 4, 4)``, or with ``chain`` a chain of T (the
    recurrent families' speculation)."""
    import torch
    from repro_torch.core.trees import chain_tree, default_tree

    B = len(c.lens)
    table = torch.zeros((B, c.m), dtype=torch.int32)
    nxt = 1
    for b, n in enumerate(c.lens):
        need = -(-(n + T) // c.bs)
        table[b, :need] = torch.arange(nxt, nxt + need, dtype=torch.int32)
        nxt += need
    for b, j in c.holes:
        table[b, j] = 0
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)
    pool_k, pool_v = r(nxt, c.bs, c.hkv, c.d), r(nxt, c.bs, c.hkv, c.d)
    pool_k[0] = poison
    pool_v[0] = poison
    tree = chain_tree(T - 1) if chain else default_tree(T, 4, 4)
    lens = torch.tensor(c.lens, dtype=torch.int32, device="cuda")
    q_pos = lens[:, None] + torch.as_tensor(tree.depth, device="cuda")[None]
    return (r(B, T, c.hq, c.d), pool_k, pool_v, r(B, T, c.hkv, c.d),
            r(B, T, c.hkv, c.d),
            torch.as_tensor(tree.ancestor_mask, device="cuda"), lens,
            table.cuda()), q_pos.to(torch.int32)


def poison_behind_window(args, window: int, fill: float, pools=(1, 2)):
    """A copy of the operands with every pool position at or behind
    ``cache_len - window`` of each slot set to ``fill``: the pools are
    ``args[i]`` for i in ``pools`` (K1's K and V; K5's latent and rope
    key: 2, 3), cache_len and the block table the last two."""
    args = list(args)
    lens, table = args[-2], args[-1]
    for i in pools:
        args[i] = args[i].clone()
    bs = args[pools[0]].shape[1]
    tbl = table.cpu()
    for b, n in enumerate(lens.tolist()):
        for p in range(0, n - window + 1):
            blk = int(tbl[b, p // bs])
            if blk != 0:
                for i in pools:
                    args[i][blk, p % bs] = fill
    return tuple(args)


def paged_charge_of(c: PagedCase, T: int, dtype_name: str, table,
                    window: int = 0, reads: int = 1):
    """The work of one call: the cache positions this run's data needs
    (below cache_len, in a real block and, with a window, within reach of
    the root row at cache_len), each read once (``reads`` times: once per
    row group, what the kernel does past 64 rows), plus q, tree K/V and
    the output, and the operations on those keys
    (``op_cost.paged_charge``)."""
    from repro_torch.launch.op_cost import paged_charge

    tbl = table.cpu()
    keys = []
    for b, n in enumerate(c.lens):
        lo = max(0, n - window + 1) if window > 0 else 0
        keys.append(sum(1 for p in range(lo, n)
                        if int(tbl[b, p // c.bs]) != 0))
    B = len(c.lens)
    return paged_charge(B, T, c.hq, c.hkv, c.d, dtype_name, keys, B * c.m,
                        window, reads)


def paged_bound(c: PagedCase, T: int, dtype_name: str, table,
                window: int = 0, reads: int = 1) -> tuple:
    """Least time for one call (``paged_charge_of``): its bytes over the
    HBM rate against its operations at the rate of their type."""
    from repro_torch.launch.op_cost import bound_ms

    return bound_ms(paged_charge_of(c, T, dtype_name, table, window, reads))


def fp64_err(out, plain, *args) -> float:
    """Max abs difference of an fp32 kernel output from its plain version
    run in fp64 on the same operands (cast up)."""
    import torch

    a64 = [a.double() if torch.is_tensor(a) and a.dtype == torch.float32
           else a for a in args]
    return (out.double() - plain(*a64)).abs().max().item()


def paged_sdpa_args(c: PagedCase, args, q_pos=None, window: int = 0):
    """The gathered view + boolean mask SDPA takes (built outside the
    timed call), with the window folded into the mask."""
    import torch

    q, pool_k, pool_v, tk, tv, tm, lens, table = args
    B, T = q.shape[:2]
    S = c.m * c.bs
    t = table.long()
    ck = pool_k[t].reshape(B, S, c.hkv, c.d)
    cv = pool_v[t].reshape(B, S, c.hkv, c.d)
    pos = torch.arange(S, device="cuda")
    valid = (t != 0).repeat_interleave(c.bs, 1) & (pos[None] < lens[:, None])
    G = c.hq // c.hkv
    k = torch.cat([ck, tk], 1).transpose(1, 2).repeat_interleave(G, 1)
    v = torch.cat([cv, tv], 1).transpose(1, 2).repeat_interleave(G, 1)
    # NULL holes hold garbage: zero them so masked-out NaN cannot leak
    keep = torch.cat([valid, torch.ones(B, T, dtype=torch.bool,
                                        device="cuda")], 1)
    k = torch.where(keep[:, None, :, None], k, 0)
    v = torch.where(keep[:, None, :, None], v, 0)
    mask = torch.cat([valid[:, None, :].expand(B, T, S),
                      tm[None].expand(B, T, T)], 2)
    if window > 0:
        abs_kv = torch.cat([pos[None].expand(B, S),
                            lens[:, None] + torch.arange(T, device="cuda")],
                           1)
        mask = mask & (q_pos[:, :, None] - abs_kv[:, None, :] < window)
    return q.transpose(1, 2).contiguous(), k, v, mask[:, None]


def _time_paged(c, T, dtype, dtype_name, kernel, plain, window=0,
                chain: bool = False) -> dict:
    """Kernel (split sweep + merge) and SDPA device times, the plain
    version's time and the wrapper call's time with its host work
    (``call_ms``), over 32 operand sets (more than the 50 MB L2 holds, as
    a step's layers cycle through their pools)."""
    import torch.nn.functional as F

    sets = [paged_inputs(c, T, dtype, seed=100 + i, chain=chain)
            for i in range(32)]
    pick = cycle(sets)
    ms = device_ms(lambda: kernel(*pick()))
    call_ms = time_ms(lambda: kernel(*pick()))
    plain_ms = time_ms(lambda: plain(*pick()), iters=5)
    sd = cycle([paged_sdpa_args(c, a, qp, window) for a, qp in sets[:8]])

    def sdpa():
        q, k, v, mask = sd()
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    lib_ms = device_ms(sdpa)
    charge = paged_charge_of(c, T, dtype_name, sets[0][0][-1], window)
    bound_ms, bound_by = paged_bound(c, T, dtype_name, sets[0][0][-1], window)
    rec = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)
    if dtype_name == "float32":
        f32_extras(rec, charge, lambda: kernel(*pick()))
    return rec


def fp64_text(rec: dict) -> str:
    """An fp32 record's difference from the plain version in fp64."""
    return (f" (fp64 plain: {rec['err_fp64']:.3e})" if "err_fp64" in rec
            else "")


def check_k1(c: PagedCase, tag: str, Ts=(16, 5)) -> dict:
    """K1 against its plain version at the head shapes of ``c`` (fp32
    also against the plain version in fp64), timed."""
    import torch
    from repro_torch.kernels.tree_attention import ops
    from repro_torch.kernels.tree_attention.kernel import (
        tree_attention_paged_plain)

    record = {}
    for dtype_name, tol in TOLS:
        dtype = getattr(torch, dtype_name)
        for T in Ts:
            outs = []
            for poison in POISONS:
                args, _ = paged_inputs(c, T, dtype, seed=T, poison=poison)
                outs.append(ops.tree_attention_paged_bshd(*args))
            outs.append(ops.tree_attention_paged_bshd(*args))
            assert_bitwise(outs, f"K1 {tag} {dtype_name} T={T}: poisoned "
                                 "NULL block, two calls")
            err = compare(outs[0], tree_attention_paged_plain(*args), tol,
                          f"K1 {tag} {dtype_name} T={T}")
            rec = dict(max_abs_err=err, **_time_paged(
                c, T, dtype, dtype_name,
                lambda *a: ops.tree_attention_paged_bshd(*a[0]),
                lambda *a: tree_attention_paged_plain(*a[0])))
            if dtype_name == "float32":
                rec["err_fp64"] = fp64_err(outs[0], tree_attention_paged_plain,
                                           *args)
            record[(dtype_name, T)] = rec
            log(f"[k1 {tag}] {dtype_name} T={T}: max_abs_err={err:.3e}"
                f"{fp64_text(rec)} kernel={rec['ms'] * 1e3:.1f}us "
                f"(call {rec['call_ms'] * 1e3:.1f}us) "
                f"bound={rec['bound_ms'] * 1e3:.2f}us ({rec['bound_by']}) "
                f"plain={rec['plain_ms'] * 1e3:.1f}us "
                f"sdpa={rec['library_ms'] * 1e3:.1f}us{f32_text(rec)}")
    return record


def check_k4(c: PagedCase = GEMMA3, Ts=(16, 5), tag: str = "") -> dict:
    """K4 against its plain version, its poisoning invariants and its
    bitwise identity with K1 at window 0, at each of ``Ts``."""
    import torch
    from repro_torch.kernels.attention_template import ops as wops
    from repro_torch.kernels.attention_template.ref import (
        tree_attention_paged_windowed_plain)
    from repro_torch.kernels.tree_attention import ops

    label = f"k4 {tag}".strip()
    record = {}
    for dtype_name, tol in TOLS:
        dtype = getattr(torch, dtype_name)
        for T in Ts:
            for w in (WINDOW, 0):
                what = f"K4 {tag} {dtype_name} T={T} window={w}".replace(
                    "  ", " ")
                outs = []
                for poison in POISONS:
                    args, q_pos = paged_inputs(c, T, dtype, seed=T,
                                               poison=poison)
                    outs.append(wops.tree_attention_paged_windowed_bshd(
                        *args, q_pos, w))
                assert_bitwise(outs, f"{what}: poisoned NULL block")
                if w > 0:
                    far = [wops.tree_attention_paged_windowed_bshd(
                        *poison_behind_window(args, w, f), q_pos, w)
                        for f in (math.nan, math.inf, -1e4)]
                    assert_bitwise([outs[0]] + far,
                                   f"{what}: poison behind the window")
                else:
                    assert_bitwise([outs[0],
                                    ops.tree_attention_paged_bshd(*args)],
                                   f"{what}: K4 against K1")
                err = compare(outs[0], tree_attention_paged_windowed_plain(
                    *args, q_pos, w), tol, what)
                assert_bitwise([outs[0], wops.tree_attention_paged_windowed_bshd(
                    *args, q_pos, w)], f"{what}: two identical calls")
                rec = dict(max_abs_err=err, **_time_paged(
                    c, T, dtype, dtype_name,
                    lambda a, qp: wops.tree_attention_paged_windowed_bshd(
                        *a, qp, w),
                    lambda a, qp: tree_attention_paged_windowed_plain(
                        *a, qp, w), window=w))
                if dtype_name == "float32":
                    rec["err_fp64"] = fp64_err(
                        outs[0], lambda *a: tree_attention_paged_windowed_plain(
                            *a, w), *args, q_pos)
                record[(dtype_name, T, w)] = rec
                log(f"[{label}] {dtype_name} T={T} window={w}: "
                    f"max_abs_err={err:.3e}{fp64_text(rec)} "
                    f"kernel={rec['ms'] * 1e3:.1f}us "
                    f"(call {rec['call_ms'] * 1e3:.1f}us) "
                    f"bound={rec['bound_ms'] * 1e3:.2f}us "
                    f"({rec['bound_by']}) "
                    f"plain={rec['plain_ms'] * 1e3:.1f}us "
                    f"sdpa={rec['library_ms'] * 1e3:.1f}us{f32_text(rec)}")
    log(f"[{label}] poisoned NULL block and poison behind the window: "
        "bitwise equal; K4 at window 0 == K1 bitwise")
    return record


def _forced_splits(run, ref, cap: int, planned: int, tol: float,
                   what: str) -> list:
    """``run(split_len)`` at one split over ``cap`` positions, the
    planner's and 16 against ``ref``, two identical calls bitwise equal at
    each; returns the three errors."""
    errs = []
    for n in (-(-cap // 16) * 16, planned, 16):
        outs = [run(n), run(n)]
        assert_bitwise(outs, f"{what} split {n}: two identical calls")
        errs.append(compare(outs[0], ref, tol, f"{what} split {n}"))
    return errs


def check_splits() -> None:
    """The tree-verify kernel with its split forced to one split over the
    capacity, to the planner's and to 16: K1 at minitron-4b heads, K4 at
    gemma3-1b heads (window 512), K2 at minitron-4b heads, each against
    its plain version; and two identical calls bitwise equal."""
    import torch
    from repro_torch.kernels.attention_template import ops as wops
    from repro_torch.kernels.attention_template.ref import (
        tree_attention_paged_windowed_plain)
    from repro_torch.kernels.tree_attention import dense_ops, ops
    from repro_torch.kernels.tree_attention.kernel import (
        tree_attention_dense_plain, tree_attention_paged_plain)
    from repro_torch.kernels.tree_attention.split import plan_split_len

    c2 = K2_CASES["minitron"]
    for dtype_name, tol in TOLS:
        dtype = getattr(torch, dtype_name)
        a1, _ = paged_inputs(MINITRON, 16, dtype, seed=7, poison=math.nan)
        a4, qp = paged_inputs(GEMMA3, 16, dtype, seed=8, poison=math.nan)
        a2 = dense_inputs(c2, 16, dtype, seed=9, poison=math.nan)
        cases = (
            ("K1 minitron", MINITRON.m * MINITRON.bs,
             plan_split_len(len(MINITRON.lens), MINITRON.hkv),
             lambda n: ops.tree_attention_paged_bshd(*a1, split_len=n),
             tree_attention_paged_plain(*a1)),
            ("K4 gemma3 window 512", GEMMA3.m * GEMMA3.bs,
             plan_split_len(len(GEMMA3.lens), GEMMA3.hkv),
             lambda n: wops.tree_attention_paged_windowed_bshd(
                 *a4, qp, WINDOW, split_len=n),
             tree_attention_paged_windowed_plain(*a4, qp, WINDOW)),
            ("K2 minitron", c2.s, plan_split_len(len(c2.lens), c2.hkv),
             lambda n: dense_ops.tree_attention_bshd(*a2, split_len=n),
             # masked_attention multiplies masked weights by the values:
             # it is held on the unpoisoned operands
             tree_attention_dense_plain(*dense_inputs(c2, 16, dtype,
                                                      seed=9))),
        )
        for what, cap, planned, run, ref in cases:
            errs = _forced_splits(run, ref, cap, planned, tol,
                                  f"{what} {dtype_name}")
            log(f"[split] {what} {dtype_name}: splits (capacity, planner "
                f"{planned}, 16) max_abs_err "
                + " / ".join(f"{e:.3e}" for e in errs)
                + "; two identical calls bitwise equal")
        # one split rule for every block size: K1 over 128-position pool
        # blocks splits at the planner's 64, inside the blocks, as K2 over
        # the same keys as a dense cache does, so the two fold alike
        c128 = dataclasses.replace(MINITRON, holes=(), m=4, bs=128)
        a128, _ = paged_inputs(c128, 16, dtype, seed=10, poison=math.nan)
        q, pool_k, pool_v, tk, tv, tm, lens, table = a128
        view = lambda pool: pool[table.long()].reshape(
            len(c128.lens), c128.m * c128.bs, c128.hkv, c128.d).contiguous()
        paged = ops.tree_attention_paged_bshd(*a128)
        dense = dense_ops.tree_attention_bshd(q, view(pool_k), view(pool_v),
                                              tk, tv, tm, lens)
        assert_bitwise([paged, dense], f"K1 block 128 against K2 "
                                       f"{dtype_name}")
        log(f"[split] K1 at block 128 == K2 over the same keys, "
            f"{dtype_name}, minitron heads, T=16: bitwise equal")


# ---------------------------------------------------------------------------
# phase 3d: the prefill kernel K3 against its plain version
# ---------------------------------------------------------------------------

K3_HEADS = {"gemma3-1b": (4, 1, 256), "minitron-4b": (24, 8, 128)}


def check_k3(heads: dict = K3_HEADS, windows=(WINDOW, 0)) -> dict:
    """K3 against its plain version at each of ``heads`` ({model: (Hq,
    Hkv, D)}), S in {37, 300, 1536}, each of ``windows``; timed at S=1536
    (and minitron-4b's S=300)."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_plain)

    record = {}
    for model, (hq, hkv, d) in heads.items():
        for dtype_name, tol in TOLS:
            dtype = getattr(torch, dtype_name)
            for S in (37, 300, 1536):
                for w in windows:
                    g = torch.Generator(device="cuda").manual_seed(S + w)
                    mk = lambda h: torch.randn(
                        (1, S, h, d), generator=g, device="cuda").to(dtype)
                    q, k, v = mk(hq), mk(hkv), mk(hkv)
                    out = ops.flash_attention_bshd(q, k, v, window=w)
                    what = f"K3 {model} {dtype_name} S={S} window={w}"
                    err = compare(out, flash_attention_plain(
                        q, k, v, window=w), tol, what)
                    rec = dict(max_abs_err=err)
                    if S == 1536 or (model == "minitron-4b" and S == 300):
                        rec.update(_time_k3(q, k, v, w, dtype_name))
                    record[(model, dtype_name, S, w)] = rec
                    log(f"[k3] {model} {dtype_name} S={S} window={w}: "
                        f"max_abs_err={err:.3e}" + (
                            f" kernel={rec['ms'] * 1e3:.1f}us "
                            f"(call {rec['call_ms'] * 1e3:.1f}us) "
                            f"bound={rec['bound_ms'] * 1e3:.2f}us "
                            f"({rec['bound_by']}) "
                            f"plain={rec['plain_ms'] * 1e3:.1f}us "
                            f"sdpa={rec['library_ms'] * 1e3:.1f}us"
                            + f32_text(rec) if "ms" in rec else ""))
    return record


def k3_bound(B: int, S: int, hq: int, hkv: int, dqk: int, dv: int,
             dtype_name: str, window: int, causal: bool) -> tuple:
    """Least time for one whole-prefill K3 call: q, k, v and the output,
    each once, against the admitted (query, key) pairs
    (``op_cost.flash_charge``)."""
    from repro_torch.launch.op_cost import bound_ms, flash_charge, k3_pairs

    return bound_ms(flash_charge(B, S, S, hq, hkv, dqk, dv, dtype_name,
                                 k3_pairs(S, window, causal)))


# fp32 work done as three TF32 passes on the tensor cores (495 TFLOP/s):
# the fp32 K3 builds' rate, beside the CUDA cores' 67 TFLOP/s that
# ``op_cost`` charges fp32 at
TF32X3_FLOPS = 495e12 / 3


def tf32x3_bound_ms(c) -> float:
    """The least ms of a charge whose operations run as 3xTF32: the larger
    of its bytes over the HBM rate and its flops at ``TF32X3_FLOPS``."""
    from repro_torch.launch.mesh import HBM_BW

    return 1e3 * max(c.nbytes / HBM_BW, c.flops / TF32X3_FLOPS)


def f32_extras(rec: dict, charge, run) -> dict:
    """An fp32 K3 record's 3xTF32 bound and its launches' µs and blocks
    (``launch_split`` of ``run``), beside its CUDA-core bound."""
    rec["bound_3xtf32_ms"] = tf32x3_bound_ms(charge)
    rec["split"] = launch_split(run, rec["ms"])
    return rec


def f32_text(rec: dict) -> str:
    """An fp32 record's 3xTF32 bound and launches, for its log line."""
    if "bound_3xtf32_ms" not in rec:
        return ""
    return (f" bound_3xtf32={rec['bound_3xtf32_ms'] * 1e3:.2f}us; "
            f"launches: {split_text(rec['split'])}")


def _time_k3(q, k, v, w: int, dtype_name: str, causal: bool = True) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_plain)

    B, S, hq, d = q.shape
    hkv = k.shape[2]
    kw = dict(window=w, causal=causal)
    ms = device_ms(lambda: ops.flash_attention_bshd(q, k, v, **kw))
    call_ms = time_ms(lambda: ops.flash_attention_bshd(q, k, v, **kw))
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, **kw),
                         iters=5)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    if w > 0:
        i = torch.arange(S, device="cuda")
        diff = i[:, None] - i[None, :]
        mask = (diff >= 0) & (diff < w)
        lib = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
    else:
        lib = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)
    lib_ms = device_ms(lib)
    bound_ms, bound_by = k3_bound(B, S, hq, hkv, d, d, dtype_name, w, causal)
    rec = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=bound_ms, bound_by=bound_by)
    if dtype_name == "float32":
        from repro_torch.launch.op_cost import flash_charge, k3_pairs

        f32_extras(rec, flash_charge(B, S, S, hq, hkv, d, d, dtype_name,
                                     k3_pairs(S, w, causal)),
                   lambda: ops.flash_attention_bshd(q, k, v, **kw))
    return rec


# deepseek-v2-lite-16b's MLA widths: 16 heads, nope 128 + rope 64 for q/k,
# 128 for v, latent rank 512
MLA_HEADS, MLA_NOPE, MLA_ROPE, MLA_V, MLA_LAT = 16, 128, 64, 128, 512
MLA_SCALE = 1.0 / math.sqrt(MLA_NOPE + MLA_ROPE)

# K3's chunk form: C query rows at each offset over a cache view of
# K3_VIEW keys, valid to offset + C; (model, Hq, Hkv, Dqk, Dv, window)
K3_CHUNK, K3_VIEW, K3_CHUNK_OFFSETS = 256, 2048, (0, 256, 1280)
K3_CHUNK_CASES = (("gemma3-1b", 4, 1, 256, 256, WINDOW),
                  ("gemma3-1b", 4, 1, 256, 256, 0),
                  ("minitron-4b", 24, 8, 128, 128, 0),
                  ("deepseek MLA", MLA_HEADS, MLA_HEADS, MLA_NOPE + MLA_ROPE,
                   MLA_V, 0))


def check_k3_chunk(cases=K3_CHUNK_CASES, offsets=K3_CHUNK_OFFSETS) -> dict:
    """K3's chunk form (``q_off``, ``kv_valid_len``) against its plain
    version at each of ``cases`` (``K3_CHUNK_CASES``), fp32 and bf16, C =
    256 rows at each of ``offsets`` (0, 256, 1280) over a view of 2048
    keys valid to
    ``q_off + C``: outputs bitwise unchanged when every key past
    ``kv_valid_len`` is poisoned (NaN, inf, +-1e4), and the chunk's rows
    bitwise equal to the same rows of one whole-prefill call on the same
    operands (the offsets are multiples of the query tile, and key tiles
    start at absolute multiples of the key tile).  Each dtype at offset
    1280 is timed against its bound (the admitted pairs' operations, the
    keys they read) and one SDPA call with a boolean (C, view) mask."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_plain)

    record = {}
    C, S = K3_CHUNK, K3_VIEW
    for model, hq, hkv, dk, dv, w in cases:
        scale = 1.0 / math.sqrt(dk)
        for dtype_name, tol in TOLS:
            dtype = getattr(torch, dtype_name)
            g = torch.Generator(device="cuda").manual_seed(hq + dk + w)
            mk = lambda h, d: torch.randn((1, S, h, d), generator=g,
                                          device="cuda").to(dtype)
            q, k, v = mk(hq, dk), mk(hkv, dk), mk(hkv, dv)
            whole = ops.flash_attention_bshd(q, k, v, window=w, scale=scale)
            for q_off in offsets:
                n = q_off + C
                qc = q[:, q_off:n].contiguous()
                kvl = torch.full((1,), n, dtype=torch.int32, device="cuda")
                call = lambda kk, vv: ops.flash_attention_bshd(
                    qc, kk, vv, window=w, scale=scale, q_off=q_off,
                    kv_valid_len=kvl)
                before = (ops.launches, ops.chunk_launches)
                out = call(k, v)
                if (ops.launches - before[0],
                        ops.chunk_launches - before[1]) != (1, 1):
                    raise AssertionError("K3 chunk form: not one launch "
                                         "counted as a chunk launch")
                what = (f"K3 chunk {model} {dtype_name} q_off={q_off} "
                        f"window={w}")
                err = compare(out, flash_attention_plain(
                    qc, k, v, window=w, scale=scale, q_off=q_off,
                    kv_valid_len=kvl), tol, what)
                outs = [out]
                for fill in POISONS[1:]:
                    kp, vp = k.clone(), v.clone()
                    kp[:, n:], vp[:, n:] = fill, fill
                    outs.append(call(kp, vp))
                assert_bitwise(outs, what + " (poison past kv_valid_len)")
                rows = whole[:, q_off:n]
                bitwise = torch.equal(out, rows)
                diff = (out.float() - rows.float()).abs().max().item()
                if not bitwise:
                    raise AssertionError(f"{what}: rows differ from the "
                                         f"whole prefill's by {diff:.3e}")
                rec = dict(max_abs_err=err, whole_bitwise=bitwise,
                           whole_diff=diff)
                if q_off == K3_CHUNK_OFFSETS[-1]:
                    rec.update(_time_k3_chunk(qc, k, v, q_off, kvl, w, scale,
                                              dtype_name))
                record[(model, dtype_name, q_off, w)] = rec
                log(f"[k3 chunk] {model} {dtype_name} C={C} q_off={q_off} "
                    f"view={S} window={w}: max_abs_err={err:.3e}; poison "
                    f"past kv_valid_len bitwise; rows == whole prefill's "
                    f"bitwise={bitwise} (max diff {diff:.3e})" + (
                        f" kernel={rec['ms'] * 1e3:.1f}us "
                        f"(call {rec['call_ms'] * 1e3:.1f}us) "
                        f"bound={rec['bound_ms'] * 1e3:.2f}us "
                        f"({rec['bound_by']}) "
                        f"plain={rec['plain_ms'] * 1e3:.1f}us "
                        f"sdpa={rec['library_ms'] * 1e3:.1f}us"
                        + f32_text(rec) if "ms" in rec else ""))
    return record


def _time_k3_chunk(qc, k, v, q_off: int, kvl, w: int, scale: float,
                   dtype_name: str) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_plain)
    from repro_torch.launch import op_cost

    C, hq, dk = qc.shape[1:]
    S, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    kw = dict(window=w, scale=scale, q_off=q_off, kv_valid_len=kvl)
    ms = device_ms(lambda: ops.flash_attention_bshd(qc, k, v, **kw))
    call_ms = time_ms(lambda: ops.flash_attention_bshd(qc, k, v, **kw))
    plain_ms = time_ms(lambda: flash_attention_plain(qc, k, v, **kw),
                       iters=5)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (qc, k, v))
    i = q_off + torch.arange(C, device="cuda")[:, None]
    j = torch.arange(S, device="cuda")[None, :]
    mask = (j <= i) & (j < q_off + C)
    if w > 0:
        mask &= i - j < w
    lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=hq != hkv))
    pairs, keys = op_cost.chunk_rows(q_off, C, w)
    charge = op_cost.flash_charge(1, C, keys, hq, hkv, dk, dv, dtype_name,
                                  pairs)
    bound_ms, bound_by = op_cost.bound_ms(charge)
    rec = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=bound_ms, bound_by=bound_by)
    if dtype_name == "float32":
        f32_extras(rec, charge,
                   lambda: ops.flash_attention_bshd(qc, k, v, **kw))
    return rec


def check_k3_mla(S: int = 1536) -> dict:
    """K3 at deepseek's MLA prefill: q/k (192) and v (128) at their own
    widths, 16 heads over 16 kv heads (G = 1), scale 1/sqrt(192), through
    the port's prefill helper, against ``blocked_attention``; then the K3
    call timed at its own widths (the (192, 128) build in either dtype,
    fp32 in 3xTF32), unpadded."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_plain)
    from repro_torch.models import attention
    from repro_torch.models.layers import blocked_attention

    record = {}
    H, dk, dv = MLA_HEADS, MLA_NOPE + MLA_ROPE, MLA_V
    pos = torch.arange(S, device="cuda")
    ai = attention.AttnInputs(q_pos=pos[None], cache_k=None, cache_v=None,
                              cache_len=None, tree_mask=None, window=0,
                              causal=True)
    for dtype_name, tol in TOLS:
        dtype = getattr(torch, dtype_name)
        g = torch.Generator(device="cuda").manual_seed(S)
        mk = lambda d: torch.randn((1, S, H, d), generator=g,
                                   device="cuda").to(dtype)
        q, k, v = mk(dk), mk(dk), mk(dv)
        out = attention._mla_prefill_attention(q, k, v, ai, MLA_SCALE)
        what = f"K3 MLA prefill {dtype_name} S={S}"
        err = compare(out, blocked_attention(q, k, v, pos[None], pos,
                                             scale=MLA_SCALE), tol, what)
        ms = device_ms(lambda: ops.flash_attention_bshd(
            q, k, v, scale=MLA_SCALE))
        call_ms = time_ms(lambda: ops.flash_attention_bshd(
            q, k, v, scale=MLA_SCALE))
        plain_ms = time_ms(lambda: flash_attention_plain(
            q, k, v, scale=MLA_SCALE), iters=5)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=MLA_SCALE))
        bound_ms, bound_by = k3_bound(1, S, H, H, dk, dv, dtype_name, 0,
                                      True)
        rec = dict(max_abs_err=err, ms=ms, call_ms=call_ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                   bound_by=bound_by)
        if dtype_name == "float32":
            from repro_torch.launch.op_cost import flash_charge, k3_pairs

            f32_extras(rec, flash_charge(1, S, S, H, H, dk, dv, dtype_name,
                                         k3_pairs(S, 0, True)),
                       lambda: ops.flash_attention_bshd(q, k, v,
                                                        scale=MLA_SCALE))
        record[dtype_name] = rec
        log(f"[k3 mla] {dtype_name} S={S} heads={H} D={dk}/{dv} unpadded: "
            f"max_abs_err={err:.3e} kernel={ms * 1e3:.1f}us "
            f"(call {call_ms * 1e3:.1f}us) bound={bound_ms * 1e3:.2f}us "
            f"({bound_by}) plain={plain_ms * 1e3:.1f}us "
            f"sdpa={lib_ms * 1e3:.1f}us" + f32_text(rec))
    return record


# ---------------------------------------------------------------------------
# phase 3e: the absorbed-MLA paged verify kernel K5 against its plain version
# ---------------------------------------------------------------------------

# deepseek-v2-lite heads, 4 slots, max_len 1536, NULL holes below cache_len
MLA_CASE = PagedCase(MLA_HEADS, 1, MLA_LAT + MLA_ROPE, (0, 37, 700, 1500),
                     ((2, 20), (3, 70), (3, 0)), 96)
# reduced deepseek-v2-lite-16b (``reduced()``: 4 heads, latent 64, rope 16,
# nope 32, the tree of 8), the K5 build phase 4's fp32 parity runs, at
# MLA_CASE's slots and NULL holes
MLA_REDUCED_WIDTHS = (64, 16)
MLA_REDUCED_CASE = dataclasses.replace(MLA_CASE, hq=4, d=sum(MLA_REDUCED_WIDTHS))
MLA_REDUCED_T = 8
MLA_REDUCED_SCALE = 1.0 / math.sqrt(32 + 16)


def mla_inputs(c: PagedCase, T: int, dtype, seed: int, poison: float = 0.0,
               widths: tuple = (MLA_LAT, MLA_ROPE)):
    """K5 operands on the card (model layout) at latent and rope
    ``widths``: q fp32, pools and tree latents in ``dtype``."""
    import torch
    from repro_torch.core.trees import default_tree

    B = len(c.lens)
    table = torch.zeros((B, c.m), dtype=torch.int32)
    nxt = 1
    for b, n in enumerate(c.lens):
        need = -(-(n + T) // c.bs)
        table[b, :need] = torch.arange(nxt, nxt + need, dtype=torch.int32)
        nxt += need
    for b, j in c.holes:
        table[b, j] = 0
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device="cuda")
    dl, dr = widths
    pool_lat = r(nxt, c.bs, dl).to(dtype)
    pool_rope = r(nxt, c.bs, dr).to(dtype)
    pool_lat[0] = poison
    pool_rope[0] = poison
    tree = default_tree(T, 4, 4)
    return (r(B, T, c.hq, dl), r(B, T, c.hq, dr), pool_lat,
            pool_rope, r(B, T, dl).to(dtype), r(B, T, dr).to(dtype),
            torch.as_tensor(tree.ancestor_mask, device="cuda"),
            torch.tensor(c.lens, dtype=torch.int32, device="cuda"),
            table.cuda())


def mla_charge_of(c: PagedCase, T: int, dtype_name: str, table):
    """The work of one K5 call: the cache positions this run's data needs
    (below cache_len, in a real block), each read once, plus q, the tree
    latents and the output, and (r + rd) + r multiply-adds per admitted
    (head, row, key), the T tree keys included (``op_cost.mla_charge``)."""
    from repro_torch.launch.op_cost import mla_charge

    tbl = table.cpu()
    keys = [sum(1 for p in range(n) if int(tbl[b, p // c.bs]) != 0)
            for b, n in enumerate(c.lens)]
    B = len(c.lens)
    return mla_charge(B, T, c.hq, MLA_LAT, MLA_ROPE, dtype_name, keys,
                      B * c.m)


def mla_bound(c: PagedCase, T: int, dtype_name: str, table) -> tuple:
    """Least time for one K5 call (``mla_charge_of``): its bytes over the
    HBM rate against its operations at the rate of their type."""
    from repro_torch.launch.op_cost import bound_ms

    return bound_ms(mla_charge_of(c, T, dtype_name, table))


def mla_sdpa_args(c: PagedCase, args):
    """The gathered view SDPA takes (K = [latent || rope], V = latent, one
    kv head, a boolean mask), built outside the timed call, in the pools'
    type."""
    import torch

    ql, qr, pl, pr, tl, trp, tm, lens, table = args
    B, T = ql.shape[:2]
    S = c.m * c.bs
    t = table.long()
    pos = torch.arange(S, device="cuda")
    valid = (t != 0).repeat_interleave(c.bs, 1) & (pos[None] < lens[:, None])
    keep = torch.cat([valid, torch.ones(B, T, dtype=torch.bool,
                                        device="cuda")], 1)[:, :, None]
    lat = torch.where(keep, torch.cat([pl[t].reshape(B, S, -1), tl], 1), 0)
    rope = torch.where(keep, torch.cat([pr[t].reshape(B, S, -1), trp], 1), 0)
    k = torch.cat([lat, rope], -1)[:, None]                 # (B,1,S+T,576)
    q = torch.cat([ql, qr], -1).transpose(1, 2).to(pl.dtype).contiguous()
    mask = torch.cat([valid[:, None, :].expand(B, T, S),
                      tm[None].expand(B, T, T)], 2)[:, None]
    return q, k, lat[:, None].contiguous(), mask


# K5's windowed form: windows held against the plain version in 3e (no
# configuration runs windowed MLA; JAX's wrapper takes the hook)
MLA_WINDOWS = (512, 1)


def mla_q_pos(c: PagedCase, T: int):
    """The verify positions ``cache_len + depth`` of ``mla_inputs``'s
    tree, (B, T) int32 on the card."""
    import torch
    from repro_torch.core.trees import default_tree

    depth = torch.as_tensor(default_tree(T, 4, 4).depth, device="cuda")
    lens = torch.tensor(c.lens, dtype=torch.int32, device="cuda")
    return (lens[:, None] + depth[None]).to(torch.int32)


def check_k5(c: PagedCase = MLA_CASE, T: int = 16,
             widths: tuple = (MLA_LAT, MLA_ROPE), scale: float = MLA_SCALE,
             timed: bool = True) -> dict:
    """K5 at latent and rope ``widths`` against its plain version: fp32
    and bf16 pools, block 0 poisoned (bitwise equal outputs); the split
    forced to one split over the capacity, to the planner's and to 16,
    each against the plain version and two identical calls bitwise
    equal; fp32 also against the plain version in fp64, with its margin
    err / (atol + rtol |ref|); the windowed form at ``MLA_WINDOWS``
    against its plain version (poison in the NULL block and behind the
    window, two identical calls and the forced split of 16, bitwise or
    within the tolerance), window 0 bitwise the unwindowed call; then,
    if ``timed``, kernel, plain and SDPA times, fp32 beside the 3xTF32
    bound with each launch's µs and blocks, and the windowed form's
    times."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.mla_attention import ops
    from repro_torch.kernels.mla_attention.ref import (
        mla_attention_paged_plain)
    from repro_torch.kernels.tree_attention.split import plan_mla_split_len

    kernel = lambda *a, **kw: ops.mla_attention_paged_bshd(
        *a, scale=scale, **kw)
    plain = lambda *a, **kw: mla_attention_paged_plain(*a, scale=scale, **kw)
    planned = plan_mla_split_len(len(c.lens), c.hq, T, *widths)
    q_pos = mla_q_pos(c, T)
    record = {}
    for dtype_name, tol in TOLS:
        dtype = getattr(torch, dtype_name)
        f32 = dtype == torch.float32
        what = f"K5 {dtype_name} {c.hq} heads {widths} T={T}"
        outs = []
        for poison in POISONS:
            args = mla_inputs(c, T, dtype, seed=T, poison=poison,
                              widths=widths)
            outs.append(kernel(*args))
        assert_bitwise(outs, f"{what}: poisoned NULL block")
        ref = plain(*args)
        err = compare(outs[0], ref, tol, what)
        errs = []
        for n in (-(-c.m * c.bs // 16) * 16, planned, 16):
            pair = [kernel(*args, split_len=n), kernel(*args, split_len=n)]
            assert_bitwise(pair, f"{what} split {n}: two identical calls")
            errs.append(compare(pair[0], ref, tol, f"{what} split {n}"))
        log(f"[k5] {what}: splits (capacity, planner {planned}, 16) "
            f"max_abs_err " + " / ".join(f"{e:.3e}" for e in errs)
            + "; two identical calls bitwise equal")
        rec = dict(max_abs_err=max([err] + errs))
        if f32:
            ref64 = plain(*(a.double() if a.dtype == torch.float32 else a
                            for a in args))
            rec.update(err_fp64=(outs[0].double() - ref64).abs().max().item(),
                       tol_ratio=tol_ratio(outs[0], ref, tol),
                       tol_ratio_fp64=tol_ratio(outs[0], ref64, tol))
            log(f"[k5] {what}: max_abs_err {err:.3e} (forced splits "
                f"{max(errs):.3e}), against the plain version in fp64 "
                f"{rec['err_fp64']:.3e}; worst err/(atol + rtol |ref|) "
                f"{rec['tol_ratio']:.3f}, against fp64 "
                f"{rec['tol_ratio_fp64']:.3f} (passes at <= 1)")
        # the windowed form
        off = kernel(*args, q_pos=q_pos, window=0)
        assert_bitwise([outs[0], off], f"{what}: window 0 against the "
                                       "unwindowed call")
        windowed = {}
        for w in MLA_WINDOWS:
            ww = f"{what} window={w}"
            wouts = [kernel(*mla_inputs(c, T, dtype, seed=T, poison=f,
                                        widths=widths),
                            q_pos=q_pos, window=w) for f in POISONS]
            wouts += [kernel(*args, q_pos=q_pos, window=w)]
            wouts += [kernel(*poison_behind_window(args, w, f, pools=(2, 3)),
                             q_pos=q_pos, window=w)
                      for f in (math.nan, math.inf)]
            assert_bitwise(wouts, f"{ww}: poisoned NULL block, poison behind "
                                  "the window, two identical calls")
            wref = plain(*args, q_pos=q_pos, window=w)
            werr = compare(wouts[0], wref, tol, ww)
            pair = [kernel(*args, q_pos=q_pos, window=w, split_len=16)
                    for _ in range(2)]
            assert_bitwise(pair, f"{ww} split 16: two identical calls")
            werr = max(werr, compare(pair[0], wref, tol, f"{ww} split 16"))
            windowed[w] = dict(max_abs_err=werr)
            if f32:
                windowed[w]["tol_ratio"] = tol_ratio(wouts[0], wref, tol)
            log(f"[k5] {ww}: max_abs_err={werr:.3e} (planner's split and "
                "16)" + (f", worst err/(atol + rtol |ref|) "
                         f"{windowed[w]['tol_ratio']:.3f}" if f32 else "")
                + "; poison in the NULL block and behind the window, two "
                  "identical calls: bitwise equal")
        rec["windowed"] = windowed
        record[(dtype_name, T)] = rec
        if not timed:
            continue
        sets = [mla_inputs(c, T, dtype, seed=100 + i) for i in range(32)]
        pick = cycle(sets)
        ms = device_ms(lambda: kernel(*pick()))
        plain_ms = time_ms(lambda: plain(*pick()), iters=5)
        sd = cycle([mla_sdpa_args(c, a) for a in sets[:8]])

        def sdpa():
            q, k, v, mask = sd()
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=MLA_SCALE, enable_gqa=True)

        lib_ms = device_ms(sdpa)
        bound_ms, bound_by = mla_bound(c, T, dtype_name, sets[0][-1])
        rec.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        if f32:
            f32_extras(rec, mla_charge_of(c, T, dtype_name, sets[0][-1]),
                       lambda: kernel(*pick()))
        for w in MLA_WINDOWS:
            windowed[w]["ms"] = device_ms(
                lambda: kernel(*pick(), q_pos=q_pos, window=w))
        log(f"[k5] {dtype_name} T={T} ({CARD}): max_abs_err="
            f"{rec['max_abs_err']:.3e}{fp64_text(rec)} "
            f"kernel={ms * 1e3:.1f}us bound={bound_ms * 1e3:.2f}us "
            f"({bound_by}) plain={plain_ms * 1e3:.1f}us "
            f"sdpa={lib_ms * 1e3:.1f}us; windowed "
            + ", ".join(f"{w}: {windowed[w]['ms'] * 1e3:.1f}us"
                        for w in MLA_WINDOWS) + f32_text(rec))
    log(f"[k5] {c.hq} heads {widths} T={T}: poisoned NULL block bitwise "
        "equal; window 0 == the unwindowed call bitwise")
    return record


# ---------------------------------------------------------------------------
# phase 3f: the chunked decay linear attention kernel K6
# ---------------------------------------------------------------------------

# rwkv6-1.6b's wkv heads and chunk
K6_HEADS, K6_DIM, K6_CHUNK = 32, 64, 64
# reduced rwkv6-1.6b's (``reduced()``: 4 heads of 64, chunk 16; phase 4's
# fp32 parity runs it), fp32: (S, initial state, strong decay, B)
K6_REDUCED_HEADS, K6_REDUCED_CHUNK = 4, 16
K6_REDUCED_CASES = ((9, False, False, 1), (40, True, False, 1),
                    (40, True, False, 2), (300, True, True, 2))
# the fp32 K6 calls of the kernel checks (3f's, 3m's), apart from the
# main path's (phases 4-5h), for the JSON line
K6_F32_CALLS = {}
# the real lengths of the pad-tail check and the bucket each is padded to
K6_PAD_TAILS = ((37, 64), (37, 128), (300, 320), (1500, 1536))


def k6_inputs(S: int, dtype, seed: int, *, init: bool, strong: bool = False,
              B: int = 1, H: int = K6_HEADS):
    """K6 operands on the card at rwkv6-1.6b shapes (B=1 and its 32 heads
    unless given): r, k, v in ``dtype``; log-decay, bonus and initial
    state fp32.  ``strong`` draws log-decays down to -20 a step
    (tests/test_kernels.py's strong-decay regime)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (B, S, H, K6_DIM)
    r = lambda *s_: torch.randn(s_, generator=g, device="cuda")
    w = torch.clamp_min(-torch.exp(r(*shape) * 1.5 + 1.0), -20.0) if strong \
        else -torch.exp(r(*shape) * 0.5)
    s0 = r(B, H, K6_DIM, K6_DIM) * 0.1 if init else None
    return (r(*shape).to(dtype), r(*shape).to(dtype), r(*shape).to(dtype), w,
            r(H, K6_DIM) * 0.1, s0)


def k6_bound(S: int, elt: int) -> tuple:
    """Least time for one K6 call at B=1 (``op_cost.k6_charge``): r, k,
    v read and o written in their type, the log-decay, both states and u
    in fp32, each once; against the least fp32 operations over the exact
    chunked forms (fp32), or the larger of the exponentials on the SFUs
    and the state products on the tensor cores (bf16)."""
    from repro_torch.launch.op_cost import bound_ms, k6_charge

    return bound_ms(k6_charge(1, S, K6_HEADS, K6_DIM,
                              "float32" if elt == 4 else "bfloat16"))


def tol_ratio(out, ref, tol: float) -> float:
    """The worst err / (tol + tol |ref|) over the elements:
    ``compare``'s margin (it passes at <= 1)."""
    d = (out.double() - ref.double()).abs()
    return (d / (tol + tol * ref.double().abs())).max().item()


def check_k6() -> dict:
    """K6 against its plain version: output and final state, fp32 and
    bf16, with and without an initial state, strong decay, two sequences
    (the engines prefill one at a time; ``generate()`` takes a batch), in
    fp32 also at reduced rwkv6-1.6b's 4 heads and chunk 16 (phase 4's
    build), each fp32 case's margin (``tol_ratio``) printed and two
    identical fp32 calls bitwise equal; the pad tail bitwise; then kernel
    and plain times at S=1536."""
    import torch
    from repro_torch.kernels.linear_attn_chunk import ops
    from repro_torch.kernels.linear_attn_chunk.ref import (
        decay_attention_chunked)

    record = {}
    f32_calls = ops.f32_launches
    for dtype_name, tol in TOLS:
        dtype = getattr(torch, dtype_name)
        cases = [(S, init, False, 1, K6_HEADS, K6_CHUNK)
                 for S in (37, 300, 1536) for init in (False, True)] + [
            (300, True, True, 1, K6_HEADS, K6_CHUNK),
            (1536, True, True, 1, K6_HEADS, K6_CHUNK),
            (300, True, False, 2, K6_HEADS, K6_CHUNK)]
        if dtype == torch.float32:
            cases += [(*c, K6_REDUCED_HEADS, K6_REDUCED_CHUNK)
                      for c in K6_REDUCED_CASES]
        for S, init, strong, B, H, C in cases:
            what = (f"K6 {dtype_name} B={B} S={S} init={init}"
                    f"{' strong decay' if strong else ''}"
                    f"{'' if C == K6_CHUNK else f' {H} heads chunk {C}'}")
            args = k6_inputs(S, dtype, seed=S + 7 * strong + B, init=init,
                             strong=strong, B=B, H=H)
            before = (ops.launches, ops.scan_launches)
            o, st = ops.linear_attn_bshd(*args, chunk=C)
            if (ops.launches - before[0], ops.scan_launches - before[1]) \
                    != (1, 1):
                raise AssertionError(f"{what}: not one chunk launch and "
                                     "one scan")
            ref_o, ref_st = decay_attention_chunked(*args, chunk=C)
            err = max(compare(o, ref_o, tol, what + " output"),
                      compare(st, ref_st, tol, what + " final state"))
            key = (dtype_name, S, init, strong, B) if C == K6_CHUNK \
                else (dtype_name, S, init, strong, B, H, C)
            record[key] = dict(max_abs_err=err)
            if dtype != torch.float32:
                log(f"[k6] {what}: max_abs_err={err:.3e}")
                continue
            ratio = max(tol_ratio(o, ref_o, tol), tol_ratio(st, ref_st, tol))
            o2, st2 = ops.linear_attn_bshd(*args, chunk=C)
            assert_bitwise([torch.cat([o.flatten(), st.flatten()]),
                            torch.cat([o2.flatten(), st2.flatten()])],
                           what + ", two identical calls")
            record[key]["tol_ratio"] = ratio
            log(f"[k6] {what}: max_abs_err={err:.3e} worst err/(atol + "
                f"rtol |ref|)={ratio:.3f} (passes at <= 1); two identical "
                "calls bitwise equal")
        for n, padded in K6_PAD_TAILS:
            r, k, v, w, u, s0 = k6_inputs(padded, dtype, seed=n, init=True)
            real = [t[:, :n].contiguous() for t in (r, k, v, w)]
            o, st = ops.linear_attn_bshd(*real, u, s0, chunk=K6_CHUNK)
            tail = torch.arange(padded, device="cuda")[None, :, None,
                                                       None] < n
            o_m, st_m = ops.linear_attn_bshd(
                r, torch.where(tail, k, 0.0), v, torch.where(tail, w, 0.0),
                u, s0, chunk=K6_CHUNK)
            torch.cuda.synchronize()
            if not (torch.equal(o_m[:, :n], o) and torch.equal(st_m, st)):
                raise AssertionError(f"K6 {dtype_name}: a masked pad tail "
                                     f"{n} -> {padded} changes the result")
        log(f"[k6] {dtype_name}: masked pad tails "
            f"{[f'{n}->{p}' for n, p in K6_PAD_TAILS]}: bitwise equal")
        sets = [k6_inputs(1536, dtype, seed=200 + i, init=True)
                for i in range(4)]
        pick = cycle(sets)
        ms = device_ms(lambda: ops.linear_attn_bshd(*pick(), chunk=K6_CHUNK))
        plain_ms = time_ms(lambda: decay_attention_chunked(
            *pick(), chunk=K6_CHUNK), iters=5)
        bound_ms, bound_by = k6_bound(1536, 2 if dtype_name != "float32"
                                      else 4)
        rec = record[(dtype_name, 1536, True, False, 1)]
        rec.update(ms=ms, plain_ms=plain_ms, library_ms=None,
                   bound_ms=bound_ms, bound_by=bound_by,
                   split=launch_split(lambda: ops.linear_attn_bshd(
                       *pick(), chunk=K6_CHUNK), ms))
        log(f"[k6] {dtype_name} S=1536 ({CARD}): kernel={ms * 1e3:.1f}us "
            f"bound={bound_ms * 1e3:.2f}us ({bound_by}) "
            f"plain={plain_ms * 1e3:.1f}us (no library call); launches: "
            f"{split_text(rec['split'])}")
    K6_F32_CALLS["3f forward"] = ops.f32_launches - f32_calls
    log(f"[k6] fp32 K6 calls in phase 3f (checks and timing): "
        f"{K6_F32_CALLS['3f forward']}")
    return record


def check_k6_boundary(S: int = 1536) -> None:
    """K6 across a chunk boundary, as a chunked prefill runs it: two calls
    (the first S/2 tokens, then the next S/2 from the first call's final
    state) against one call over S, within K6's tolerance; prints whether
    the two are bitwise equal."""
    import torch
    from repro_torch.kernels.linear_attn_chunk import ops

    half = S // 2
    for dtype_name, tol in TOLS:
        r, k, v, w, u, s0 = k6_inputs(S, getattr(torch, dtype_name),
                                      seed=77, init=True)
        o, st = ops.linear_attn_bshd(r, k, v, w, u, s0, chunk=K6_CHUNK)
        first = [t[:, :half].contiguous() for t in (r, k, v, w)]
        second = [t[:, half:].contiguous() for t in (r, k, v, w)]
        o1, st1 = ops.linear_attn_bshd(*first, u, s0, chunk=K6_CHUNK)
        o2, st2 = ops.linear_attn_bshd(*second, u, st1, chunk=K6_CHUNK)
        o12 = torch.cat([o1, o2], dim=1)
        what = f"K6 {dtype_name} S={S} in two calls of {half}"
        err = max(compare(o12, o, tol, what + " output"),
                  compare(st2, st, tol, what + " final state"))
        bitwise = torch.equal(o12, o) and torch.equal(st2, st)
        log(f"[k6 boundary] {what} from the carried state against one "
            f"call: max_abs_err={err:.3e} bitwise={bitwise}")


# 3f's strong-decay draws at rwkv6-1.6b's shapes (B=1, 32 heads of 64,
# S=1536, chunk 64, an initial state), from numpy seeds, so that
# ``scripts/k6_f32_error_sources.py --draws`` runs JAX's fp32 path on the
# same operands on the CPU; 3f's own cases above stay as they were
K6_STRONG_SEEDS = (1001, 1002, 1003, 1004, 1005, 1006)
K6_STRONG_S = 1536


def k6_numpy_draw(seed: int, S: int = K6_STRONG_S, H: int = K6_HEADS,
                  B: int = 1) -> tuple:
    """K6 operands as fp32 numpy arrays (r, k, v, log-decay, u, initial
    state) from ``numpy.random.default_rng(seed)``: r, k, v ~ N(0, 1),
    the log-decay max(-exp(1.5 n + 1), -20) (the strong-decay regime of
    ``k6_inputs``), u and the initial state 0.1 n."""
    import numpy as np

    rs = np.random.default_rng(seed)
    n = lambda *s_: rs.standard_normal(s_, dtype=np.float32)
    shape = (B, S, H, K6_DIM)
    r, k, v = n(*shape), n(*shape), n(*shape)
    w = np.maximum(-np.exp(n(*shape) * np.float32(1.5) + np.float32(1.0)),
                   np.float32(-20.0))
    return (r, k, v, w, n(H, K6_DIM) * np.float32(0.1),
            n(B, H, K6_DIM, K6_DIM) * np.float32(0.1))


def k6_recurrence_fp64(r, k, v, w, u, s0):
    """The token recurrence in fp64 on the operands' device:
    o_t = r_t S + (r_t . u k_t) v_t, S <- diag(exp w_t) S + k_t v_t^T;
    returns (o, final state)."""
    import torch

    r, k, v, w, u = (t.double() for t in (r, k, v, w, u))
    B, S, H, d = k.shape
    state = (torch.zeros((B, H, d, v.shape[-1]), dtype=torch.float64,
                         device=k.device) if s0 is None else s0.double())
    outs = []
    for i in range(S):
        o = torch.einsum("bhd,bhde->bhe", r[:, i], state)
        outs.append(o + (r[:, i] * u * k[:, i]).sum(-1, keepdim=True)
                    * v[:, i])
        state = state * torch.exp(w[:, i])[..., None] + \
            k[:, i, :, :, None] * v[:, i, :, None, :]
    return torch.stack(outs, 1), state


def check_k6_strong_draws() -> dict:
    """fp32 K6 on each of ``K6_STRONG_SEEDS``' draws against its plain
    version and against the fp64 recurrence: each margin err / (atol +
    rtol |ref|) logged, the plain fp32 version's against fp64 beside it.
    Under strong decay the plain fp32 version is itself several
    tolerances from fp64, so the kernel against it is a reading (one draw
    of six reads a margin past 1: PERF.md, PR 32); what is held is the
    kernel against fp64, which may stray no further than the plain fp32
    version does plus one tolerance."""
    import torch
    from repro_torch.kernels.linear_attn_chunk import ops
    from repro_torch.kernels.linear_attn_chunk.ref import (
        decay_attention_chunked)

    tol = dict(TOLS)["float32"]
    record = {}
    f32_calls = ops.f32_launches
    for seed in K6_STRONG_SEEDS:
        args = [torch.from_numpy(a).cuda() for a in k6_numpy_draw(seed)]
        what = (f"K6 float32 strong decay, numpy seed {seed} (B=1 "
                f"S={K6_STRONG_S} {K6_HEADS} heads, initial state)")
        o, st = ops.linear_attn_bshd(*args, chunk=K6_CHUNK)
        ref_o, ref_st = decay_attention_chunked(*args, chunk=K6_CHUNK)
        ex_o, ex_st = k6_recurrence_fp64(*args)
        err = max((o - ref_o).abs().max().item(),
                  (st - ref_st).abs().max().item())
        rec = dict(
            max_abs_err=err,
            tol_ratio=max(tol_ratio(o, ref_o, tol),
                          tol_ratio(st, ref_st, tol)),
            err_fp64=max((o.double() - ex_o).abs().max().item(),
                         (st.double() - ex_st).abs().max().item()),
            tol_ratio_fp64=max(tol_ratio(o, ex_o, tol),
                               tol_ratio(st, ex_st, tol)),
            plain_err_fp64=max((ref_o.double() - ex_o).abs().max().item(),
                               (ref_st.double() - ex_st).abs().max().item()),
            plain_tol_ratio_fp64=max(tol_ratio(ref_o, ex_o, tol),
                                     tol_ratio(ref_st, ex_st, tol)))
        record[seed] = rec
        log(f"[k6 draws] {what} ({CARD}): against plain fp32 "
            f"max_abs_err={err:.3e} margin {rec['tol_ratio']:.3f}; against "
            f"the fp64 recurrence: kernel {rec['err_fp64']:.3e} margin "
            f"{rec['tol_ratio_fp64']:.3f}, plain fp32 "
            f"{rec['plain_err_fp64']:.3e} margin "
            f"{rec['plain_tol_ratio_fp64']:.3f} (a margin: the worst err / "
            f"(atol + rtol |ref|) at {tol:g})")
        if rec["tol_ratio"] > 1:
            ratio = (o.double() - ref_o.double()).abs() / (
                tol + tol * ref_o.double().abs())
            at = tuple(int(i) for i in torch.unravel_index(
                ratio.argmax(), ratio.shape))
            log(f"[k6 draws] seed {seed}: output {at} past the tolerance "
                f"against plain fp32: kernel {o[at].item():.7e}, plain "
                f"{ref_o[at].item():.7e}, fp64 {ex_o[at].item():.7e}")
        if not all(math.isfinite(v) for v in rec.values()) or \
                rec["tol_ratio_fp64"] > rec["plain_tol_ratio_fp64"] + 1:
            raise AssertionError(
                f"{what}: the kernel's margin against fp64 "
                f"{rec['tol_ratio_fp64']:.3f} exceeds the plain fp32 "
                f"version's {rec['plain_tol_ratio_fp64']:.3f} by more than "
                "one tolerance")
        del args, o, st, ref_o, ref_st, ex_o, ex_st
    K6_F32_CALLS["3f strong draws"] = ops.f32_launches - f32_calls
    return record


# ---------------------------------------------------------------------------
# phase 3g: the dense tree-verify kernel K2; 3h: K1 at deepseek's prefix
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DenseCase:
    """Head shapes, slot lengths and cache length of a K2 run."""
    hq: int
    hkv: int
    d: int
    lens: tuple
    s: int


K2_CASES = {"minitron": DenseCase(24, 8, 128, (0, 37, 144, 300), 512),
            "gemma3": DenseCase(4, 1, 256, (0, 37, 700, 1500), 1536)}
# vicuna-tiny's verify (the paper's fp32 loop, 5e(iv) and 5h): B=4, 4 q
# over 4 kv heads of 64, T=16, block 16, short and mixed lengths, a table
# of 40 blocks (K1) or a dense cache of 640 positions (K2)
VICUNA_LENS = {"lens 32-80": (32, 48, 64, 80), "lens 0-500": (0, 37, 300, 500)}
VICUNA_K1 = {tag: PagedCase(4, 4, 64, lens, (), 40)
             for tag, lens in VICUNA_LENS.items()}
VICUNA_K2 = {f"vicuna-tiny {tag}": DenseCase(4, 4, 64, lens, 640)
             for tag, lens in VICUNA_LENS.items()}


def dense_inputs(c: DenseCase, T: int, dtype, seed: int,
                 poison: float = 0.0, chain: bool = False):
    """K2 operands on the card (model layout); every cache position at or
    past ``cache_len`` holds ``poison``; the tree as ``paged_inputs``
    makes it."""
    import torch
    from repro_torch.core.trees import chain_tree, default_tree

    B = len(c.lens)
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s_: torch.randn(s_, generator=g, device="cuda").to(dtype)
    ck, cv = r(B, c.s, c.hkv, c.d), r(B, c.s, c.hkv, c.d)
    lens = torch.tensor(c.lens, dtype=torch.int32, device="cuda")
    past = (torch.arange(c.s, device="cuda")[None] >= lens[:, None])
    ck[past] = poison
    cv[past] = poison
    tree = chain_tree(T - 1) if chain else default_tree(T, 4, 4)
    return (r(B, T, c.hq, c.d), ck, cv, r(B, T, c.hkv, c.d),
            r(B, T, c.hkv, c.d),
            torch.as_tensor(tree.ancestor_mask, device="cuda"), lens)


def dense_charge_of(c: DenseCase, T: int, dtype_name: str, reads: int = 1):
    """The work of one K2 call: each slot's keys below cache_len read once
    (``reads`` times: once per row group), plus q, the tree K/V and the
    output, and the operations on those keys and the tree
    (``op_cost.dense_charge``)."""
    from repro_torch.launch.op_cost import dense_charge

    return dense_charge(len(c.lens), T, c.hq, c.hkv, c.d, dtype_name,
                        c.lens, reads)


def dense_bound(c: DenseCase, T: int, dtype_name: str,
                reads: int = 1) -> tuple:
    """Least time for one K2 call (``dense_charge_of``)."""
    from repro_torch.launch.op_cost import bound_ms

    return bound_ms(dense_charge_of(c, T, dtype_name, reads))


def dense_sdpa_args(c: DenseCase, args):
    """The dense cache with the tree written in at [cache_len, cache_len +
    T), as the serving path holds it, and the verify mask, for SDPA
    (built outside the timed call)."""
    import torch

    q, ck, cv, tk, tv, tm, lens = args
    B, T = q.shape[:2]
    ck, cv = ck.clone(), cv.clone()
    pos = torch.arange(c.s, device="cuda")
    for b, n in enumerate(c.lens):
        ck[b, n:n + T] = tk[b]
        cv[b, n:n + T] = tv[b]
    j = pos[None] - lens[:, None].long()
    in_tree = (j >= 0) & (j < T)
    tree_bit = tm[:, j.clamp(0, T - 1)].permute(1, 0, 2)
    mask = (j < 0)[:, None, :] | (in_tree[:, None, :] & tree_bit)
    return (q.transpose(1, 2).contiguous(), ck.transpose(1, 2).contiguous(),
            cv.transpose(1, 2).contiguous(), mask[:, None])


def check_k2(cases=None, Ts=(16, 5)) -> dict:
    """K2 against its plain version (``masked_attention`` under the
    verify mask; fp32 also in fp64) at each of ``cases`` (default
    ``K2_CASES``), bitwise invariance under poison at or past cache_len
    and across two identical calls, then kernel, plain and SDPA times."""
    import torch
    from repro_torch.kernels.tree_attention import dense_ops
    from repro_torch.kernels.tree_attention.kernel import (
        tree_attention_dense_plain)

    record = {}
    for tag, c in (cases or K2_CASES).items():
        for dtype_name, tol in TOLS:
            dtype = getattr(torch, dtype_name)
            for T in Ts:
                what = f"K2 {tag} D={c.d} {dtype_name} T={T}"
                outs = [dense_ops.tree_attention_bshd(
                    *dense_inputs(c, T, dtype, seed=T, poison=f))
                    for f in POISONS]
                # masked_attention multiplies masked weights by the values:
                # it is held on the unpoisoned (zero) operands
                args = dense_inputs(c, T, dtype, seed=T)
                outs.append(dense_ops.tree_attention_bshd(*args))
                assert_bitwise(outs, f"{what}: poison at or past cache_len, "
                                     "two calls")
                err = compare(outs[0], tree_attention_dense_plain(*args), tol,
                              what)
                rec = dict(max_abs_err=err,
                           **_time_dense(c, T, dtype, dtype_name))
                if dtype_name == "float32":
                    rec["err_fp64"] = fp64_err(
                        outs[0], tree_attention_dense_plain, *args)
                record[(tag, dtype_name, T)] = rec
                log(f"[k2] {tag} D={c.d} {dtype_name} T={T}: "
                    f"max_abs_err={err:.3e}{fp64_text(rec)} "
                    f"kernel={rec['ms'] * 1e3:.1f}us "
                    f"(call {rec['call_ms'] * 1e3:.1f}us) "
                    f"bound={rec['bound_ms'] * 1e3:.2f}us "
                    f"({rec['bound_by']}) "
                    f"plain={rec['plain_ms'] * 1e3:.1f}us "
                    f"sdpa={rec['library_ms'] * 1e3:.1f}us{f32_text(rec)}")
    log("[k2] poison at or past cache_len and two identical calls: bitwise "
        "equal")
    return record


def _time_dense(c: DenseCase, T: int, dtype, dtype_name: str,
                chain: bool = False) -> dict:
    """K2 (split sweep + merge) and SDPA device times, the plain version's
    time and the wrapper call's time with its host work (``call_ms``),
    over 32 operand sets, beside the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.tree_attention import dense_ops
    from repro_torch.kernels.tree_attention.kernel import (
        tree_attention_dense_plain)

    sets = [dense_inputs(c, T, dtype, seed=100 + i, chain=chain)
            for i in range(32)]
    pick = cycle(sets)
    ms = device_ms(lambda: dense_ops.tree_attention_bshd(*pick()))
    call_ms = time_ms(lambda: dense_ops.tree_attention_bshd(*pick()))
    plain_ms = time_ms(lambda: tree_attention_dense_plain(*pick()), iters=5)
    sd = cycle([dense_sdpa_args(c, a) for a in sets[:8]])

    def sdpa():
        q, k, v, mask = sd()
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)

    lib_ms = device_ms(sdpa)
    bound_ms, bound_by = dense_bound(c, T, dtype_name)
    rec = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=bound_ms, bound_by=bound_by)
    if dtype_name == "float32":
        f32_extras(rec, dense_charge_of(c, T, dtype_name),
                   lambda: dense_ops.tree_attention_bshd(*pick()))
    return rec


# deepseek-v2-lite's Hydra++ prefix layer: GQA 16 over 16, D=128, T=5
DEEPSEEK_PREFIX = PagedCase(16, 16, 128, (0, 37, 700, 1500), (), 96)


def check_k1_prefix(c: PagedCase = DEEPSEEK_PREFIX, T: int = 5) -> dict:
    """K1 at deepseek's prefix-layer shapes, bf16: held against its plain
    version, then timed beside its bound and SDPA."""
    import torch
    from repro_torch.kernels.tree_attention import ops
    from repro_torch.kernels.tree_attention.kernel import (
        tree_attention_paged_plain)

    args, _ = paged_inputs(c, T, torch.bfloat16, seed=T)
    err = compare(ops.tree_attention_paged_bshd(*args),
                  tree_attention_paged_plain(*args), 2e-2,
                  "K1 deepseek prefix bf16")
    rec = dict(max_abs_err=err, **_time_paged(
        c, T, torch.bfloat16, "bfloat16",
        lambda *a: ops.tree_attention_paged_bshd(*a[0]),
        lambda *a: tree_attention_paged_plain(*a[0])))
    log(f"[k1 deepseek prefix] bfloat16 T={T}: max_abs_err={err:.3e} "
        f"kernel={rec['ms'] * 1e3:.1f}us "
        f"(call {rec['call_ms'] * 1e3:.1f}us) "
        f"bound={rec['bound_ms'] * 1e3:.2f}us ({rec['bound_by']}) "
        f"plain={rec['plain_ms'] * 1e3:.1f}us "
        f"sdpa={rec['library_ms'] * 1e3:.1f}us")
    return rec


# ---------------------------------------------------------------------------
# phase 3i: the tree-verify kernel past 64 query rows per kv head
# ---------------------------------------------------------------------------

# the head groupings whose G*T rows at T = 16 take more than one row group
# (starcoder2-7b 144, qwen2.5-32b 80, chameleon-34b 128), D = 128, at
# gemma3-1b's contexts and holes
ROW_HOLES = ((2, 20), (3, 70), (3, 0))
ROW_CASES = {arch: PagedCase(hq, hkv, 128, (0, 37, 700, 1500), ROW_HOLES, 96)
             for arch, hq, hkv in (("starcoder2-7b", 36, 4),
                                   ("qwen2.5-32b", 40, 8),
                                   ("chameleon-34b", 64, 8))}
ROW_SUBSET = 4            # query heads per kv head of the head-subset call


def check_head_subset(run, q, hkv: int, split_len: int, what: str) -> None:
    """The first ``ROW_SUBSET`` query heads of each kv head (at T = 16 the
    first row group) out of a full call ``run(q, split_len)`` equal, bit
    for bit, a call on those heads alone at the same split: row groups
    share nothing."""
    B, T, Hq, D = q.shape
    G = Hq // hkv
    pick = lambda x: x.reshape(B, T, hkv, G, D)[:, :, :, :ROW_SUBSET] \
        .reshape(B, T, hkv * ROW_SUBSET, D).contiguous()
    assert_bitwise([pick(run(q, split_len)), run(pick(q), split_len)],
                   f"{what}: the first {ROW_SUBSET} heads of each kv head "
                   "against a call on them alone")


def time_split_rules(c: PagedCase, dc: DenseCase, T: int,
                     groups: int) -> dict:
    """K1 and K2 in bf16 at the split of each of two rules, a split column
    of B*Hkv blocks or of B*Hkv*groups (a row group counted as a block),
    device times over 32 operand sets in turns (a, b, a, b); returns
    {"K1"/"K2": {split_len: ms}} and prints both."""
    import torch
    from repro_torch.kernels.tree_attention import dense_ops, ops
    from repro_torch.kernels.tree_attention.split import plan_split_len

    B = len(c.lens)
    splits = sorted({plan_split_len(B, c.hkv),
                     plan_split_len(B, c.hkv * groups)})
    psets = [paged_inputs(c, T, torch.bfloat16, seed=200 + i)[0]
             for i in range(32)]
    dsets = [dense_inputs(dc, T, torch.bfloat16, seed=200 + i)
             for i in range(32)]
    runs = {"K1": (cycle(psets), ops.tree_attention_paged_bshd),
            "K2": (cycle(dsets), dense_ops.tree_attention_bshd)}
    out = {}
    for key, (pick, fn) in runs.items():
        ms = {n: [] for n in splits}
        for _ in range(2):
            for n in splits:
                ms[n].append(device_ms(lambda: fn(*pick(), split_len=n)))
        out[key] = {n: sum(v) / len(v) for n, v in ms.items()}
        log(f"[rows] {key} {c.hq}/{c.hkv} heads bfloat16 T={T} by split "
            f"(B*Hkv {B * c.hkv}, row groups {groups}): " + ", ".join(
                f"{n}: {t * 1e3:.2f}us" for n, t in out[key].items()))
    return out


def check_rows(T: int = 16) -> dict:
    """K1 and K2 at ``ROW_CASES``'s head groupings, fp32 and bf16 against
    their plain versions; poison (block 0 for K1, positions at or past
    cache_len for K2) changes no bit; the split forced to one, the
    planner's and 16, two identical calls bitwise equal; the head-subset
    rows bitwise; then bf16 timed beside its bound (keys read once, and
    once per row group, as the kernel reads them) and SDPA, and at the
    split of each rule ``time_split_rules`` compares."""
    import torch
    from repro_torch.kernels.tree_attention import dense_ops, ops
    from repro_torch.kernels.tree_attention.kernel import (
        tree_attention_dense_plain, tree_attention_paged_plain)
    from repro_torch.kernels.tree_attention.split import row_groups

    record = {}
    for arch, c in ROW_CASES.items():
        rows = (c.hq // c.hkv) * T
        groups = row_groups(rows)
        dc = DenseCase(c.hq, c.hkv, c.d, c.lens, 1536)
        for dtype_name, tol in TOLS:
            dtype = getattr(torch, dtype_name)
            what = f"K1 {arch} ({rows} rows) {dtype_name}"
            outs = []
            for poison in POISONS:
                args, _ = paged_inputs(c, T, dtype, seed=T, poison=poison)
                outs.append(ops.tree_attention_paged_bshd(*args))
            assert_bitwise(outs, f"{what}: poisoned NULL block")
            ref = tree_attention_paged_plain(*args)
            planned = ops.planned_split_len(args[0], c.hkv)
            err1 = max(compare(outs[0], ref, tol, what), *_forced_splits(
                lambda n: ops.tree_attention_paged_bshd(*args, split_len=n),
                ref, c.m * c.bs, planned, tol, what))
            check_head_subset(
                lambda q, n: ops.tree_attention_paged_bshd(q, *args[1:],
                                                           split_len=n),
                args[0], c.hkv, planned, what)
            what2 = f"K2 {arch} ({rows} rows) {dtype_name}"
            douts = [dense_ops.tree_attention_bshd(
                *dense_inputs(dc, T, dtype, seed=T, poison=f))
                for f in POISONS]
            assert_bitwise(douts, f"{what2}: poison at or past cache_len")
            # masked_attention multiplies masked weights by the values:
            # it is held on the unpoisoned (zero) operands
            dargs = dense_inputs(dc, T, dtype, seed=T)
            dref = tree_attention_dense_plain(*dargs)
            err2 = max(compare(douts[0], dref, tol, what2), *_forced_splits(
                lambda n: dense_ops.tree_attention_bshd(*dargs, split_len=n),
                dref, dc.s, planned, tol, what2))
            check_head_subset(
                lambda q, n: dense_ops.tree_attention_bshd(q, *dargs[1:],
                                                           split_len=n),
                dargs[0], c.hkv, planned, what2)
            e64 = {}
            if dtype_name == "float32":
                e64 = {"K1": fp64_err(outs[0], tree_attention_paged_plain,
                                      *args),
                       "K2": fp64_err(douts[0], tree_attention_dense_plain,
                                      *dargs)}
            for key, err in (("K1", err1), ("K2", err2)):
                record[(arch, key, dtype_name)] = dict(
                    max_abs_err=err, rows=rows, groups=groups,
                    split_len=planned)
                if key in e64:
                    record[(arch, key, dtype_name)]["err_fp64"] = e64[key]
            fp64 = (f" (fp64 plain: K1 {e64['K1']:.3e}, K2 {e64['K2']:.3e})"
                    if e64 else "")
            log(f"[rows] {arch} {c.hq} q over {c.hkv} kv heads, {rows} rows "
                f"({groups} row groups), {dtype_name} T={T}: K1 "
                f"max_abs_err={err1:.3e}, K2 max_abs_err={err2:.3e}{fp64}; "
                f"poison, splits (capacity, planner {planned}, 16), two "
                f"identical calls and the first {ROW_SUBSET} heads of each "
                "kv head alone: bitwise")
        table = paged_inputs(c, T, torch.bfloat16, seed=T)[0][-1]
        timed = {
            "K1": _time_paged(c, T, torch.bfloat16, "bfloat16",
                              lambda *a: ops.tree_attention_paged_bshd(*a[0]),
                              lambda *a: tree_attention_paged_plain(*a[0])),
            "K2": _time_dense(dc, T, torch.bfloat16, "bfloat16")}
        per_group = {"K1": paged_bound(c, T, "bfloat16", table,
                                       reads=groups)[0],
                     "K2": dense_bound(dc, T, "bfloat16", reads=groups)[0]}
        split_ms = time_split_rules(c, dc, T, groups)
        for key, rec in timed.items():
            record[(arch, key, "bfloat16")].update(
                rec, bound_per_group_ms=per_group[key],
                split_ms=split_ms[key])
            log(f"[rows] {key} {arch} bfloat16 T={T} ({rows} rows): "
                f"kernel={rec['ms'] * 1e3:.1f}us "
                f"(call {rec['call_ms'] * 1e3:.1f}us) "
                f"bound={rec['bound_ms'] * 1e3:.2f}us ({rec['bound_by']}; "
                f"keys once per row group: "
                f"{per_group[key] * 1e3:.2f}us) "
                f"plain={rec['plain_ms'] * 1e3:.1f}us "
                f"sdpa={rec['library_ms'] * 1e3:.1f}us")
    return record


# ---------------------------------------------------------------------------
# phase 3j: K1, K2 and K3 at zamba2-1.2b's shared attention block
# ---------------------------------------------------------------------------

# the shared block's heads: 32 q over 32 kv heads of 64 (G = 1), a chain
# of T = 5 (padded to 8 by the wrappers), gemma3-1b's contexts and holes
ZAMBA2 = "zamba2-1.2b"
ZAMBA2_CASE = PagedCase(32, 32, 64, (0, 37, 700, 1500), ROW_HOLES, 96)
ZAMBA2_T = 5


def check_zamba2_kernels() -> dict:
    """K1 and K2 at the shared block's verify (``ZAMBA2_CASE``, K2 over a
    dense S = 1536), fp32 and bf16 against their plain versions: block 0
    (K1) or every position at or past cache_len (K2) poisoned with 0,
    +-1e4, NaN and inf, bitwise; two identical calls bitwise; bf16 timed
    beside its bound and SDPA.  Then K3 at (64, 64), 32 over 32, window 0:
    whole prefills at S in {37, 300, 1536} and the chunk form (C = 256 at
    offset 1280 over 2048 keys) against their plain versions (the chunk's
    rows bitwise equal to the whole call's, poison past kv_valid_len
    bitwise), bf16 timed beside its bound and SDPA.  Returns {("K1" |
    "K2", dtype): record, "K3": check_k3's, "K3 chunk": its chunk
    records}."""
    import torch
    from repro_torch.kernels.tree_attention import dense_ops, ops
    from repro_torch.kernels.tree_attention.kernel import (
        tree_attention_dense_plain, tree_attention_paged_plain)

    c, T = ZAMBA2_CASE, ZAMBA2_T
    dc = DenseCase(c.hq, c.hkv, c.d, c.lens, 1536)
    record = {}
    for dtype_name, tol in TOLS:
        dtype = getattr(torch, dtype_name)
        what = f"K1 {ZAMBA2} ({c.hq}/{c.hkv} heads, D={c.d}) {dtype_name}"
        outs = []
        for poison in POISONS:
            args, _ = paged_inputs(c, T, dtype, seed=T, poison=poison,
                                   chain=True)
            outs.append(ops.tree_attention_paged_bshd(*args))
        outs.append(ops.tree_attention_paged_bshd(*args))
        assert_bitwise(outs, f"{what}: poisoned NULL block, two calls")
        err1 = compare(outs[0], tree_attention_paged_plain(*args), tol, what)
        what2 = f"K2 {ZAMBA2} ({c.hq}/{c.hkv} heads, D={c.d}) {dtype_name}"
        douts = [dense_ops.tree_attention_bshd(
            *dense_inputs(dc, T, dtype, seed=T, poison=f, chain=True))
            for f in POISONS]
        # masked_attention multiplies masked weights by the values: it is
        # held on the unpoisoned (zero) operands
        dargs = dense_inputs(dc, T, dtype, seed=T, chain=True)
        douts.append(dense_ops.tree_attention_bshd(*dargs))
        assert_bitwise(douts, f"{what2}: poison at or past cache_len, two "
                              "calls")
        err2 = compare(douts[0], tree_attention_dense_plain(*dargs), tol,
                       what2)
        record[("K1", dtype_name)] = dict(max_abs_err=err1)
        record[("K2", dtype_name)] = dict(max_abs_err=err2)
        fp64 = ""
        if dtype_name == "float32":
            record[("K1", dtype_name)]["err_fp64"] = fp64_err(
                outs[0], tree_attention_paged_plain, *args)
            record[("K2", dtype_name)]["err_fp64"] = fp64_err(
                douts[0], tree_attention_dense_plain, *dargs)
            fp64 = (f" (fp64 plain: K1 "
                    f"{record[('K1', dtype_name)]['err_fp64']:.3e}, K2 "
                    f"{record[('K2', dtype_name)]['err_fp64']:.3e})")
        log(f"[zamba2] {c.hq} q over {c.hkv} kv heads, D={c.d}, chain T={T}, "
            f"{dtype_name}: K1 max_abs_err={err1:.3e}, K2 "
            f"max_abs_err={err2:.3e}{fp64}; poison and two identical calls "
            "bitwise")
    timed = {
        "K1": _time_paged(c, T, torch.bfloat16, "bfloat16",
                          lambda *a: ops.tree_attention_paged_bshd(*a[0]),
                          lambda *a: tree_attention_paged_plain(*a[0]),
                          chain=True),
        "K2": _time_dense(dc, T, torch.bfloat16, "bfloat16", chain=True)}
    for key, rec in timed.items():
        record[(key, "bfloat16")].update(rec)
        log(f"[zamba2] {key} bfloat16 T={T}: kernel={rec['ms'] * 1e3:.1f}us "
            f"(call {rec['call_ms'] * 1e3:.1f}us) "
            f"bound={rec['bound_ms'] * 1e3:.2f}us ({rec['bound_by']}) "
            f"plain={rec['plain_ms'] * 1e3:.1f}us "
            f"sdpa={rec['library_ms'] * 1e3:.1f}us")
    record["K3"] = check_k3({ZAMBA2: (c.hq, c.hkv, c.d)}, windows=(0,))
    record["K3 chunk"] = check_k3_chunk(
        ((ZAMBA2, c.hq, c.hkv, c.d, c.d, 0),),
        offsets=(K3_CHUNK_OFFSETS[-1],))
    return record


# ---------------------------------------------------------------------------
# phase 3k: K3 at hubert-xlarge's encoder heads
# ---------------------------------------------------------------------------

HUBERT = "hubert-xlarge"
HUBERT_HEADS = (16, 16, 80)       # 16 q over 16 kv heads of 80
# bf16 K3 at (80, 80) against its plain version in fp32 on the same bf16
# operands: the relative L2 error ||out - ref|| / ||ref|| is bf16's
# rounding of P and of the output, each about 2^-9 / sqrt(3) = 1.1e-3;
# K3's output off by K5_OFF reads about 1e-2 and must fail
K3_BF16_REL_BOUND = 5e-3


def rel_l2(out, ref) -> float:
    """||out - ref|| / ||ref|| over every element, in fp32."""
    import torch

    ref = ref.float()
    return float(torch.linalg.vector_norm(out.float() - ref)
                 / torch.linalg.vector_norm(ref))


def k3_bf16_rel(out, q, k, v, what: str, **kw) -> tuple:
    """The relative L2 error of K3's bf16 ``out`` against
    ``flash_attention_plain`` in fp32 on the bf16 operands ``q, k, v``;
    raises past ``K3_BF16_REL_BOUND``, or if ``out`` off by ``K5_OFF``
    stays within it (the check could not see a kernel 1% off).  Returns
    (that error, the fp32 plain output)."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_plain)

    ref = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    rel, off = rel_l2(out, ref), rel_l2(out.float() * K5_OFF, ref)
    if not rel <= K3_BF16_REL_BOUND < off:
        raise AssertionError(
            f"{what}: relative L2 error against the fp32 plain version "
            f"{rel:.3e}, off by {K5_OFF} {off:.3e} (bound "
            f"{K3_BF16_REL_BOUND}: the first within, the second past it)")
    return rel, ref


def check_k3_hubert(S_all=(37, 300, 1536), pad: int = 64) -> dict:
    """K3 bidirectional at ``HUBERT_HEADS``, fp32 and bf16 (the (80, 80)
    build of each, unpadded), against its plain version.  The operands are the first S rows of buffers of S + ``pad``
    rows (B = 1, so the view is contiguous): the rows past the sequence
    are poisoned with 0, +-1e4, NaN and inf, which must change no bit.
    bf16 is also held against the plain version in fp32 on its operands
    (``k3_bf16_rel``), beside the bf16 plain version's reading (not held),
    and each dtype timed at the longest S beside its bound and non-causal
    SDPA.
    Returns {(dtype, S): record}."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_plain)

    hq, hkv, d = HUBERT_HEADS
    record = {}
    for dtype_name, tol in TOLS:
        dtype = getattr(torch, dtype_name)
        for S in S_all:
            g = torch.Generator(device="cuda").manual_seed(S + 80)
            bufs = [torch.randn((1, S + pad, h, d), generator=g,
                                device="cuda").to(dtype)
                    for h in (hq, hkv, hkv)]
            q, k, v = (b[:, :S] for b in bufs)
            out = ops.flash_attention_bshd(q, k, v, causal=False)
            what = f"K3 {HUBERT} {dtype_name} S={S} bidirectional"
            plain = flash_attention_plain(q, k, v, causal=False)
            err = compare(out, plain, tol, what)
            rec = dict(max_abs_err=err)
            if dtype_name == "bfloat16":
                rel, ref = k3_bf16_rel(out, q, k, v, what, causal=False)
                rec.update(rel=rel, plain_rel=rel_l2(plain, ref))
            outs = [out]
            for fill in POISONS:
                for b in bufs:
                    b[:, S:] = fill
                outs.append(ops.flash_attention_bshd(q, k, v, causal=False))
            assert_bitwise(outs, f"{what}: poison past the sequence")
            if S == max(S_all):
                rec.update(_time_k3(q, k, v, 0, dtype_name, causal=False))
            record[(dtype_name, S)] = rec
            log(f"[k3 hubert] {hq} over {hkv} heads, D={d}, {dtype_name} "
                f"S={S}, bidirectional: max_abs_err={err:.3e}, poison past "
                f"the sequence bitwise" + (
                    f"; relative L2 error against the fp32 plain version "
                    f"{rec['rel']:.3e} (the bf16 plain version "
                    f"{rec['plain_rel']:.3e}; bound {K3_BF16_REL_BOUND}, K3 "
                    f"off by {K5_OFF} failing it)"
                    if "rel" in rec else "") + (
                    f"; kernel={rec['ms'] * 1e3:.1f}us "
                    f"(call {rec['call_ms'] * 1e3:.1f}us) "
                    f"bound={rec['bound_ms'] * 1e3:.2f}us "
                    f"({rec['bound_by']}) plain={rec['plain_ms'] * 1e3:.1f}us "
                    f"sdpa={rec['library_ms'] * 1e3:.1f}us" + f32_text(rec)
                    if "ms" in rec else ""))
    return record


# ---------------------------------------------------------------------------
# phase 3m: the backward kernels of K6 and K3 against their plain versions
# ---------------------------------------------------------------------------

# relative L2 bounds of a backward kernel's gradients against its plain
# version in fp32 on the same operands: fp32 1e-4, bf16 5e-3 (the bound of
# K3's bf16 output, K3_BF16_REL_BOUND); each gradient off by K5_OFF on its
# odd channels must fail them
BWD_REL = {"float32": 1e-4, "bfloat16": 5e-3}
# K6 at rwkv6-1.6b's training shapes, B=1: (dtype, S)
K6_BWD_CASES = (("bfloat16", 1024), ("bfloat16", 500), ("float32", 500))
# and in fp32 at reduced rwkv6-1.6b's 4 heads, chunk 16 (phase 4's build),
# checked, not timed: (S, strong decay, B)
K6_BWD_REDUCED = ((40, False, 1), (300, True, 2))
# K3 at the training builds: (model, dtype, Hq, Hkv, Dqk, Dv, window,
# causal, scale), bf16 at S = K3_BWD_S, fp32 at 512 (its own builds,
# 3xTF32)
K3_BWD_S = 1024
K3_BWD_CASES = (
    ("gemma3-1b", "bfloat16", 4, 1, 256, 256, WINDOW, True, None),
    ("gemma3-1b", "bfloat16", 4, 1, 256, 256, 0, True, None),
    ("zamba2-1.2b", "bfloat16", 32, 32, 64, 64, 0, True, None),
    ("deepseek-v2-lite-16b", "bfloat16", 16, 16, 192, 128, 0, True,
     MLA_SCALE),
    ("deepseek-moe-16b", "bfloat16", 16, 16, 128, 128, 0, True, None),
    ("hubert-xlarge", "bfloat16", 16, 16, 80, 80, 0, False, None),
    ("fp32 D=64", "float32", 4, 4, 64, 64, 0, True, None),
    ("fp32 D=256", "float32", 4, 1, 256, 256, WINDOW, True, None),
    ("fp32 (80, 80)", "float32", 16, 16, 80, 80, 0, False, None),
    ("fp32 (192, 128)", "float32", 16, 16, 192, 128, 0, True, MLA_SCALE),
)


def _hold_grads(what: str, names, got, again, want, dtype_name: str):
    """Each gradient finite, bitwise equal across two identical calls,
    within ``BWD_REL`` of its plain version, and past it when off by
    ``K5_OFF`` on its odd channels.  Returns (max abs error, largest
    relative L2 error)."""
    import torch

    torch.cuda.synchronize()
    bound, err, worst = BWD_REL[dtype_name], 0.0, 0.0
    for name, a, b, ref in zip(names, got, again, want):
        if not torch.isfinite(a).all():
            raise AssertionError(f"{what}: {name} not finite")
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: {name} differs between two "
                                 "identical calls")
        off = a.float().clone()
        off[..., 1::2] *= K5_OFF
        rel, rel_off = rel_l2(a, ref), rel_l2(off, ref)
        if not rel <= bound < rel_off:
            raise AssertionError(
                f"{what}: {name} relative L2 error {rel:.3e} against the "
                f"plain version, {rel_off:.3e} off by {K5_OFF} on its odd "
                f"channels (bound {bound}: the first within, the second "
                "past it)")
        err = max(err, (a.float() - ref.float()).abs().max().item())
        worst = max(worst, rel)
    return err, worst


def _sdpa_bwd_ms(q, k, v, do, w: int, causal: bool, scale):
    """Device time of ``scaled_dot_product_attention``'s backward alone
    (a yardstick the port never calls): its forward is run once with q, k,
    v requiring a gradient, then ``torch.autograd.grad`` of that output,
    the graph retained, is timed by ``device_ms``.  None (with the reason
    printed) where SDPA refuses the shapes."""
    import torch
    import torch.nn.functional as F

    S = q.shape[1]
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    kw = dict(scale=scale, enable_gqa=True)
    if w > 0:
        i = torch.arange(S, device="cuda")
        diff = i[:, None] - i[None, :]
        kw["attn_mask"] = (diff >= 0) & (diff < w)
    else:
        kw["is_causal"] = causal
    try:
        with torch.enable_grad():
            o = F.scaled_dot_product_attention(qt, kt, vt, **kw)
            return device_ms(lambda: torch.autograd.grad(
                o, (qt, kt, vt), dot, retain_graph=True), iters=10)
    except RuntimeError as e:
        log(f"[3m] SDPA's backward refused {tuple(q.shape)}: {e}")
        return None


def check_backward() -> dict:
    """Phase 3m: K6's and K3's backward kernels against their plain
    versions (``ref.py::decay_attention_chunked_bwd``, ``kernel.py::
    flash_attention_bwd_plain``) in fp32 on the same operands, at
    training's shapes, two identical calls bitwise equal, a gradient 1%
    off failing the bound; K3's forward output bitwise the same with and
    without its log-sum-exp pointer; each kernel timed beside its bound,
    its plain version and, for K3, SDPA's backward."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as k3k
    from repro_torch.kernels.flash_attention import ops as k3
    from repro_torch.kernels.linear_attn_chunk import ops as k6
    from repro_torch.kernels.linear_attn_chunk import ref as k6r
    from repro_torch.launch.op_cost import (bound_ms, flash_bwd_charge,
                                            k3_pairs, k6_bwd_charge)

    record = {}
    f32 = lambda t: None if t is None else t.float()
    f32_calls = k6.f32_bwd_launches
    cases = [(dtype_name, S, False, 1, K6_HEADS, K6_CHUNK)
             for dtype_name, S in K6_BWD_CASES] + [
        ("float32", S, strong, B, K6_REDUCED_HEADS, K6_REDUCED_CHUNK)
        for S, strong, B in K6_BWD_REDUCED]
    for dtype_name, S, strong, B, H, C in cases:
        dtype = getattr(torch, dtype_name)
        r, k, v, w, u, _ = k6_inputs(S, dtype, seed=S + 11, init=False,
                                     strong=strong, B=B, H=H)
        do = torch.randn(v.shape, generator=torch.Generator(
            device="cuda").manual_seed(S), device="cuda").to(dtype)
        args = (r, k, v, w, u, None)
        _, _, states = k6._forward(*args, C, states=True)
        run = lambda: k6._backward(*args, states, do, None, C)
        got, again = run(), run()

        def plain():
            rf, kf, vf = f32(r), f32(k), f32(v)
            st = k6r.chunk_states(kf, vf, w, None, C)
            return k6r.decay_attention_chunked_bwd(
                rf, kf, vf, w, u, st, do.float(), None, chunk=C)

        what = (f"K6 backward {dtype_name} S={S}"
                + ("" if C == K6_CHUNK else f" B={B}"
                   f"{' strong decay' if strong else ''} {H} heads"))
        err, rel = _hold_grads(what, ("dr", "dk", "dv", "dw", "du",
                                      "d_initial_state"),
                               got, again, plain(), dtype_name)
        rec = dict(max_abs_err=err, rel_l2=rel)
        if C != K6_CHUNK:
            record[("K6", dtype_name, S, B, H, C)] = rec
            log(f"[3m] {what} (chunk {C}, u, no state cotangent): "
                f"max_abs_err={err:.3e} rel_l2={rel:.3e} (bound "
                f"{BWD_REL[dtype_name]}), bitwise twice")
            continue
        rec["ms"] = device_ms(run)
        rec["split"] = launch_split(run, rec["ms"])
        rec["plain_ms"] = time_ms(plain, iters=3)
        rec["library_ms"] = None
        rec["bound_ms"], rec["bound_by"] = bound_ms(k6_bwd_charge(
            1, S, K6_HEADS, K6_DIM, dtype_name, u=True))
        record[("K6", dtype_name, S)] = rec
        log(f"[3m] {what} (32 heads of 64, chunk {K6_CHUNK}, u, no state "
            f"cotangent; {CARD}): max_abs_err={err:.3e} rel_l2={rel:.3e} "
            f"(bound {BWD_REL[dtype_name]}), bitwise twice; "
            f"kernels={rec['ms'] * 1e3:.1f}us bound="
            f"{rec['bound_ms'] * 1e3:.2f}us ({rec['bound_by']}) "
            f"plain={rec['plain_ms'] * 1e3:.1f}us (no library call); "
            f"launches: {split_text(rec['split'])}")
    K6_F32_CALLS["3m backward"] = k6.f32_bwd_launches - f32_calls
    log(f"[3m] fp32 K6 backward calls in phase 3m (checks and timing): "
        f"{K6_F32_CALLS['3m backward']}")
    for model, dtype_name, hq, hkv, dqk, dv, w, causal, scale in \
            K3_BWD_CASES:
        dtype = getattr(torch, dtype_name)
        S = K3_BWD_S if dtype == torch.bfloat16 else 512
        g = torch.Generator(device="cuda").manual_seed(S + dqk + w)
        mk = lambda h, d: torch.randn((1, S, h, d), generator=g,
                                      device="cuda").to(dtype)
        q, k, v, do = mk(hq, dqk), mk(hkv, dqk), mk(hkv, dv), mk(hq, dv)
        kw = dict(causal=causal, window=w, scale=scale)
        lse = torch.empty((1, hq, S), device="cuda")
        out = k3._forward(q, k, v, lse=lse, **kw)
        if not torch.equal(out, k3._forward(q, k, v, **kw)):
            raise AssertionError(f"K3 {model} {dtype_name}: the output's "
                                 "bits change with the log-sum-exp pointer")
        run = lambda: k3._backward(q, k, v, out, lse, do, **kw)
        got, again = run(), run()
        qf, kf, vf = f32(q), f32(k), f32(v)
        lse32 = k3k.flash_attention_lse_plain(qf, kf, **kw)
        out32 = k3k.flash_attention_plain(qf, kf, vf, **kw)
        lse_err = (lse - lse32).abs().max().item()
        if not lse_err <= 1e-3:
            raise AssertionError(f"K3 {model} {dtype_name}: log-sum-exp "
                                 f"{lse_err:.3e} off its plain version")
        plain = lambda: k3k.flash_attention_bwd_plain(qf, kf, vf, out32,
                                                      lse32, do.float(),
                                                      **kw)
        what = (f"K3 backward {model} {dtype_name} ({hq} q over {hkv} kv "
                f"heads, {dqk}/{dv}) S={S} window={w} "
                f"{'causal' if causal else 'bidirectional'}")
        err, rel = _hold_grads(what, ("dq", "dk", "dv"), got, again,
                               plain(), dtype_name)
        rec = dict(max_abs_err=err, rel_l2=rel, lse_err=lse_err)
        rec["ms"] = device_ms(run)
        rec["split"] = launch_split(run, rec["ms"])
        rec["plain_ms"] = time_ms(plain, iters=3)
        rec["library_ms"] = _sdpa_bwd_ms(q, k, v, do, w, causal, scale)
        charge = flash_bwd_charge(1, S, hq, hkv, dqk, dv, dtype_name,
                                  k3_pairs(S, w, causal))
        rec["bound_ms"], rec["bound_by"] = bound_ms(charge)
        if dtype_name == "float32":
            rec["bound_3xtf32_ms"] = tf32x3_bound_ms(charge)
        record[("K3", model, dtype_name, w)] = rec
        sdpa = ("refused" if rec["library_ms"] is None
                else f"{rec['library_ms'] * 1e3:.1f}us")
        log(f"[3m] {what} ({CARD}): max_abs_err={err:.3e} rel_l2="
            f"{rel:.3e} (bound {BWD_REL[dtype_name]}), lse max err "
            f"{lse_err:.2e}, forward bits unchanged by the lse pointer, "
            f"bitwise twice; kernels={rec['ms'] * 1e3:.1f}us bound="
            f"{rec['bound_ms'] * 1e3:.2f}us ({rec['bound_by']}) "
            + (f"bound_3xtf32={rec['bound_3xtf32_ms'] * 1e3:.2f}us "
               if "bound_3xtf32_ms" in rec else "")
            + f"plain={rec['plain_ms'] * 1e3:.1f}us sdpa backward={sdpa}; "
            f"launches: {split_text(rec['split'])}")
    return record


# ---------------------------------------------------------------------------
# phase 3l: the autotuner's sweep, and the committed winner cache
# ---------------------------------------------------------------------------

SWEEP_OUT = SRC.parent / "build" / "autotune.sweep.cuda.json"


def check_autotune() -> dict:
    """Sweep every required key (each candidate held against its plain
    version first: a wrong one raises), print the winners and µs per
    candidate as one JSON line, then check the committed cache: a missing
    key fails, a winner other than this sweep's is printed.  Returns the
    sweep's entries."""
    from repro_torch.kernels import autotune, autotune_cache_path

    payload = autotune.sweep(log=lambda m: log(f"[3l] {m}"))
    SWEEP_OUT.parent.mkdir(parents=True, exist_ok=True)
    SWEEP_OUT.write_text(json.dumps(payload, indent=1, sort_keys=True))
    log(json.dumps({"autotune_sweep": {
        k: {"winner": {n: v for n, v in e.items() if n != "sweep_us"},
            "us": e["sweep_us"]} for k, e in payload["entries"].items()},
        "card": payload["card"], "torch": payload["torch"],
        "cuda": payload["cuda"]}))
    committed = autotune_cache_path()
    missing = autotune.missing_keys(committed)
    if missing:
        raise AssertionError(f"the committed cache {committed} misses "
                             f"{missing}")
    with open(committed) as f:
        data = json.load(f)
    differ = []
    for key, fresh in payload["entries"].items():
        old = {n: v for n, v in data["entries"][key].items()
               if n != "sweep_us"}
        new = {n: v for n, v in fresh.items() if n != "sweep_us"}
        if old != new:
            differ.append(f"{key}: committed {old} ({data['card']}), this "
                          f"sweep {new}")
    log(f"[3l] check: {committed} covers all {len(payload['entries'])} "
        f"required keys (swept on {data['card']}); winners that differ "
        f"from this sweep ({CARD}; timing noise, not a failure): "
        + ("; ".join(differ) if differ else "none"))
    return payload["entries"]


def log_resolved(cfg, phase: str) -> None:
    """The winners ``cfg``'s tuned calls resolve (mode and cache in
    force)."""
    from repro_torch import kernels
    from repro_torch.kernels import autotune

    mode = os.environ.get(kernels.AUTOTUNE_ENV, "on")
    log(f"[{phase}] {cfg.name} resolves (autotune mode {mode}): "
        f"{autotune.resolve_calls(cfg)}")


# ---------------------------------------------------------------------------
# phase 4: tiny fp32 parity, paged engine (kernels) == dense generate()
# ---------------------------------------------------------------------------


def kernel_counters():
    """The launch counters of every kernel wrapper, by kernel name.  A
    launch recorded into the captured step's CUDA graph counts once, at
    capture; ``CapturedStep.replays`` counts the replays."""
    from repro_torch import kernels

    return kernels.counter_modules()


def check_tiny_parity(base, lens, budgets=(12, 14, 8, 10, 13, 9),
                      num_blocks: int = 6, chunks=(8, 16)) -> None:
    import numpy as np
    import torch
    from repro_torch.configs import tree_for
    from repro_torch.core.heads import init_draft_params
    from repro_torch.core.speculative import PAD_TOKEN, generate
    from repro_torch.models.model import group_has_window, init_params
    from repro_torch.serving.engine import PagedSpeculativeEngine, Request

    log_resolved(base, "4")
    counters = kernel_counters()
    # the kernels of the paged engine, and of the dense generate() it is
    # held against: K2 on the window-0 GQA layers (the Hydra++ prefix
    # layer at least) of an attention model; an RWKV6 model launches K6
    # on every prefill and no kernel in a decode step
    if base.block_kind == "rwkv6":
        used, dense_used = ("linear_attn_chunk",), ("linear_attn_chunk",)
    else:
        dense_used = ("tree_attention_dense", "flash_attention")
        if base.mla:       # K5 on the base layers, K1 on the prefix layer
            used = ("mla_attention_paged", "tree_attention_paged")
        elif group_has_window(base, 0, base.n_layers):
            used = ("tree_attention_paged_windowed",)
        else:
            used = ("tree_attention_paged",)
        used = (*used, "flash_attention")
    # the reduced vocabulary, and 16 tokens so random heads get accepted
    for cfg in (base, dataclasses.replace(base, vocab_size=16)):
        params = init_params(cfg, seed=0, device="cuda")
        dp = init_draft_params(cfg, seed=1, device="cuda")
        tree = tree_for(cfg)
        rs = np.random.RandomState(0)
        reqs, refs = [], []
        for mod in counters.values():
            mod.launches = 0
        for n, budget in zip(lens, budgets):
            prompt = rs.randint(0, cfg.vocab_size, n).astype(np.int32)
            t, _, _ = generate(params, dp, cfg, tree,
                               torch.as_tensor(prompt, device="cuda")[None]
                               .long(), max_new_tokens=budget, max_len=128)
            row = [int(x) for x in t[0].tolist() if x != PAD_TOKEN]
            refs.append(row[:budget])
            reqs.append(Request(prompt=prompt, max_new_tokens=budget))
        dense_counts = {k: m.launches for k, m in counters.items()}
        for name in dense_used:
            if dense_counts[name] == 0:
                raise AssertionError(f"tiny parity {cfg.name}: dense "
                                     f"generate() never launched {name}")
        for mod in counters.values():
            mod.launches = 0
        eng = PagedSpeculativeEngine(params, dp, cfg, tree, max_len=128,
                                     block_size=16, num_blocks=num_blocks)
        st = eng.serve(reqs, max_batch=4)
        for r, ref in zip(reqs, refs):
            if r.output != ref:
                raise AssertionError(f"tiny parity {cfg.name} "
                                     f"(V={cfg.vocab_size}): paged "
                                     f"{r.output} != dense {ref}")
        counts = {k: m.launches for k, m in counters.items()}
        for name in used:
            if counts[name] == 0:
                raise AssertionError(f"tiny parity {cfg.name} never "
                                     f"launched {name}")
        if base.block_kind in ("rwkv6", "mamba2") and st.preemptions == 0:
            raise AssertionError(f"tiny parity {cfg.name}: the pool forced "
                                 "no preemption (no re-prefill was held)")
        log(f"[tiny] {cfg.name} V={cfg.vocab_size}: paged engine == dense "
            f"generate() for {len(reqs)} requests; steps={st.steps} "
            f"tok/step={st.tokens_per_step:.2f} "
            f"preemptions={st.preemptions} launches={counts}; dense "
            f"generate() launches={dense_counts}")
        # chunked prefill through the same paged engine: the chunks run
        # K3's chunk form (attention; zamba2's shared block) or K6 from the
        # carried state (rwkv6)
        k3 = counters["flash_attention"]
        prefill_kernel = ("linear_attn_chunk" if base.block_kind == "rwkv6"
                          else "flash_attention")
        for chunk in chunks:
            for mod in counters.values():
                mod.launches = 0
            k3.chunk_launches = 0
            creqs = [Request(prompt=r.prompt.copy(),
                             max_new_tokens=r.max_new_tokens) for r in reqs]
            eng = PagedSpeculativeEngine(params, dp, cfg, tree, max_len=128,
                                         block_size=16, num_blocks=num_blocks,
                                         prefill_chunk=chunk)
            cst = eng.serve(creqs, max_batch=4)
            for r, ref in zip(creqs, refs):
                if r.output != ref:
                    raise AssertionError(
                        f"tiny parity {cfg.name} (V={cfg.vocab_size}), "
                        f"chunk {chunk}: paged {r.output} != dense {ref}")
            counts = {k: m.launches for k, m in counters.items()}
            if counts[prefill_kernel] == 0 or (
                    prefill_kernel == "flash_attention"
                    and k3.chunk_launches != counts["flash_attention"]):
                raise AssertionError(
                    f"tiny parity {cfg.name}, chunk {chunk}: prefill "
                    f"kernel launches {counts} (K3 chunk form "
                    f"{k3.chunk_launches})")
            log(f"[tiny] {cfg.name} V={cfg.vocab_size} chunked prefill "
                f"(chunk {eng.prefill_chunk}): paged engine == dense "
                f"generate() for {len(creqs)} requests; "
                f"chunks={cst.prefill_chunks} preemptions={cst.preemptions} "
                f"launches={counts} (K3 chunk form {k3.chunk_launches})")


# ---------------------------------------------------------------------------
# phase 5: full width, through the paged engine
# ---------------------------------------------------------------------------


def _verify_pair(params, dp, cfg, P: int, S: int):
    """Paged and dense verify logits of one full-width verify forward,
    from the same prefill of P tokens into a cache of S, and the K2
    launches of the dense one."""
    import torch
    from repro_torch.configs import tree_for
    from repro_torch.core.heads import draft_tree_tokens
    from repro_torch.core.speculative import init_decode_state
    from repro_torch.core.trees import device_arrays
    from repro_torch.kernels.tree_attention import dense_ops
    from repro_torch.models.model import forward

    tree = tree_for(cfg)
    g = torch.Generator(device="cuda").manual_seed(5)
    prompt = torch.randint(0, cfg.vocab_size, (1, P), generator=g,
                           device="cuda")
    st = init_decode_state(params, dp, cfg, prompt, S)
    tokens, _ = draft_tree_tokens(dp, cfg, params, tree, st.last_hidden,
                                  st.last_token)
    ta = device_arrays(tree, prompt.device)
    pos = st.cache_len[:, None] + ta["depth"][None]
    nb = S // 16
    table = torch.arange(1, nb + 1, dtype=torch.int32, device="cuda")[None]
    pools = []
    for group in st.cache:                 # (L, 1, S, tail...) per array
        if "k" not in group:               # recurrent state: per slot in
            pools.append(group)            # both layouts (verify reads it)
            continue
        pool = {}
        for k, v in group.items():
            pool[k] = torch.zeros((v.shape[0], nb + 1, 16) + v.shape[3:],
                                  dtype=v.dtype, device="cuda")
            pool[k][:, 1:] = v[:, 0].reshape(v.shape[0], nb, 16,
                                             *v.shape[3:])
        pools.append(pool)
    k2_before = dense_ops.launches
    dense = forward(params, cfg, tokens, pos, mode="verify", cache=st.cache,
                    cache_len=st.cache_len, tree_mask=ta["mask"])
    k2 = dense_ops.launches - k2_before
    paged = forward(params, cfg, tokens, pos, mode="verify", cache=pools,
                    cache_len=st.cache_len, tree_mask=ta["mask"],
                    block_table=table)
    return paged.logits[0], dense.logits[0], k2


def _paged_vs_dense(paged, dense) -> tuple:
    """(max relative logit difference, argmax agreement, margins).  At a
    position where the argmax differs, its margin is dense's lead of its
    choice over paged's, in units of that position's largest paged-vs-dense
    logit difference: below 1, the two choices are a near tie that the
    difference can flip."""
    diff = (paged - dense).abs()
    rel = (diff.max() / dense.abs().max()).item()
    pa, da = paged.argmax(-1), dense.argmax(-1)
    agree = (pa == da).float().mean().item()
    lead = dense.gather(-1, da[:, None]) - dense.gather(-1, pa[:, None])
    margins = [round(m, 3) for m in
               (lead[:, 0] / diff.max(-1).values)[pa != da].tolist()]
    return rel, agree, margins


def check_full_verify(params, dp, cfg, P: int, S: int) -> int:
    """One full-width verify forward, paged (K1/K4) against dense (K2 on
    the window-0 layers, plain windowed attention on the others), from the
    same prefill: first through K3 (the serving path, held to
    ``MIN_ARGMAX_AGREEMENT``), then through K3's plain version, logged
    only, which shows whether K3's cache moves the agreement.  The dense
    forward must launch K2 once per window-0 layer; returns the K2
    launches of the first."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_plain
    from repro_torch.models import attention

    k2_expected = sum(cfg.window_for_layer(i) == 0
                      for i in range(cfg.n_layers))
    for prefill in ("K3", "plain"):
        kernel_fn = attention.flash_attention_bshd
        if prefill == "plain":
            attention.flash_attention_bshd = flash_attention_plain
        try:
            paged, dense, k2 = _verify_pair(params, dp, cfg, P, S)
        finally:
            attention.flash_attention_bshd = kernel_fn
        if k2 != k2_expected:
            raise AssertionError(f"{cfg.name}: the dense verify launched K2 "
                                 f"{k2} times, not {k2_expected}")
        if not torch.isfinite(paged).all():
            raise AssertionError(f"{cfg.name}: full-width paged logits not "
                                 "finite")
        rel, agree, margins = _paged_vs_dense(paged, dense)
        log(f"[full] {cfg.name} verify paged vs dense (prompt {P}, prefill "
            f"through {prefill}; dense K2 launches {k2}): max rel logit "
            f"diff={rel:.3e} argmax agreement={agree:.3f} margins={margins}")
        if rel > 0.1:
            raise AssertionError(f"paged and dense verify disagree: rel {rel}")
        if prefill == "K3" and agree < MIN_ARGMAX_AGREEMENT:
            raise AssertionError(f"paged and dense verify argmax agree on "
                                 f"{agree:.3f} of the tree only")
    return k2_expected


def check_zamba2_verify(params, dp, cfg, P: int, S: int) -> int:
    """zamba2 at full width: one chain verify step paged (K1 on the shared
    block's invocations) against dense (K2 on them), from the same
    prefill through K3, must be bitwise equal (the Mamba2 groups are per
    slot in both layouts and run the same operations); the dense verify
    launches K2 once per invocation.  Each of that prefill's K3 calls is
    held against the plain version on the same operands (the
    invocation's real activations), within bf16's 2e-2.  Then the same
    prefill through K3's plain version, read against the K3 one (random
    weights amplify bf16 rounding through the 38 recurrent layers to a
    relative logit difference near 1, where every margin is a near tie,
    so it cannot tell a right K3 from a wrong one;
    ``check_k3_prefill_fp32`` holds it end to end): it fails only on a
    logit that is not finite or an argmax that differs beyond a near
    tie.  Returns the K2 launches of the pair."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_plain
    from repro_torch.models import attention
    from repro_torch.models.model import group_program

    k2_expected = sum(kind == "shared_attn" for kind, _ in group_program(cfg))
    kernel_fn = attention.flash_attention_bshd
    errs = []

    def held(q, k, v, **kw):
        out = kernel_fn(q, k, v, **kw)
        errs.append(compare(out, flash_attention_plain(q, k, v, **kw), 2e-2,
                            f"{cfg.name} K3 call {len(errs)} of the prefill"))
        return out

    attention.flash_attention_bshd = held
    try:
        paged, dense, k2 = _verify_pair(params, dp, cfg, P, S)
    finally:
        attention.flash_attention_bshd = kernel_fn
    if len(errs) != k2_expected:
        raise AssertionError(f"{cfg.name}: the prefill called K3 "
                             f"{len(errs)} times, not {k2_expected}")
    if k2 != k2_expected:
        raise AssertionError(f"{cfg.name}: the dense verify launched K2 "
                             f"{k2} times, not {k2_expected}")
    if not torch.isfinite(paged).all() or not torch.equal(paged, dense):
        rel = _paged_vs_dense(paged, dense)[0]
        raise AssertionError(f"{cfg.name}: paged and dense verify are not "
                             f"bitwise equal (max rel diff {rel:.3e})")
    attention.flash_attention_bshd = flash_attention_plain
    try:
        plain = _verify_pair(params, dp, cfg, P, S)[1]
    finally:
        attention.flash_attention_bshd = kernel_fn
    rel, agree, margins = _paged_vs_dense(dense, plain)
    log(f"[full] {cfg.name} verify paged vs dense (prompt {P}, chain "
        f"T={ZAMBA2_T}, dense K2 launches {k2}): bitwise equal; the "
        f"prefill's {len(errs)} K3 calls against the plain version on their "
        f"own operands: max abs err {max(errs):.3e} (bound 2e-2 + 2e-2 "
        f"|ref|); the prefill through K3 vs through its plain version (a "
        f"reading; held in fp32 in phase 5b): max rel "
        f"logit diff={rel:.3e} argmax agreement={agree:.3f} "
        f"margins={margins}")
    if not torch.isfinite(plain).all() or any(m >= 1 for m in margins):
        raise AssertionError(f"{cfg.name}: the plain-K3 prefill's verify "
                             f"logits are not finite or an argmax differs "
                             f"beyond a near tie: {margins}")
    return k2


# (dtype, layers, max relative logit difference, least argmax agreement)
# of the depth-cut paged-vs-dense verify checks of an MoE model.  The bf16
# bound sits between deepseek-v2-lite's clean reading (7.2e-3-7.3e-3) and
# what a K5 1% off gives without a routing flip (1.4e-2), so the planted
# fault fails it whether or not a flip amplifies it
MOE_VERIFY_CHECKS = (("float32", 5, 1e-4, 1.0),
                     ("bfloat16", 2, 0.01, MIN_ARGMAX_AGREEMENT))
# each check must also fail a paged kernel (K5 under MLA, K1 under GQA)
# whose output is off by this factor
K5_OFF = 0.99


def check_moe_verify(arch: str, P: int, S: int) -> None:
    """Paged (K5 or K1) against dense verify of an MoE model at full
    width, depth cut as ``MOE_VERIFY_CHECKS`` says.  Top-k routing with a
    capacity is discontinuous: a rounding difference of the attention
    output can flip an expert choice or which token overflows, and each
    layer adds such flips, so at full depth in bf16 the difference
    outgrows what a wrong kernel gives at shallow depth.  At 2 layers (the
    dense layer and one MoE layer) the bf16 serving path (bf16 pools, the
    bf16 kernel) is held tightly; in fp32 at 5 layers the two paths must
    agree to rounding.  Each check is run again with the paged kernel's
    output (K5 under MLA, K1 under GQA: deepseek-moe-16b) scaled by
    ``K5_OFF`` and must then fail its bound."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.heads import init_draft_params
    from repro_torch.models import attention
    from repro_torch.models.model import init_params

    name = ("mla_attention_paged_bshd" if get_config(arch).mla
            else "tree_attention_paged_bshd")
    kernel = getattr(attention, name)
    for dtype, n_layers, max_rel, min_agree in MOE_VERIFY_CHECKS:
        cfg = dataclasses.replace(get_config(arch), n_layers=n_layers,
                                  dtype=dtype)
        params = init_params(cfg, seed=0, device="cuda")
        dp = init_draft_params(cfg, seed=1, device="cuda")
        paged, dense, _ = _verify_pair(params, dp, cfg, P, S)
        finite = bool(torch.isfinite(paged).all())
        rel, agree, margins = _paged_vs_dense(paged, dense)
        setattr(attention, name,
                lambda *a, **kw: kernel(*a, **kw) * K5_OFF)
        try:
            rel_off = _paged_vs_dense(
                *_verify_pair(params, dp, cfg, P, S)[:2])[0]
        finally:
            setattr(attention, name, kernel)
        log(f"[full] {cfg.name} {dtype}, {n_layers} layers, verify paged vs "
            f"dense (prompt {P}): max rel logit diff={rel:.3e} argmax "
            f"agreement={agree:.3f} margins={margins}; with {name}'s "
            f"output x{K5_OFF}: {rel_off:.3e}")
        del params, dp, paged, dense
        gc.collect()
        torch.cuda.empty_cache()
        if not (finite and rel <= max_rel and agree >= min_agree):
            raise AssertionError(f"{cfg.name} {dtype}, {n_layers} layers: "
                                 f"paged and dense verify disagree: rel "
                                 f"{rel} (bound {max_rel}), agreement "
                                 f"{agree} (least {min_agree}), finite "
                                 f"{finite}")
        if rel_off <= max_rel:
            raise AssertionError(f"{cfg.name} {dtype}, {n_layers} layers: "
                                 f"{name} {K5_OFF}x off reads {rel_off}, "
                                 f"within the bound {max_rel}")


def log_moe_verify(params, dp, cfg, P: int, S: int) -> None:
    """The full-depth bf16 paged-vs-dense verify step of an MoE model,
    printed as a reading (agreement and near-tie leads); only a logit
    that is not finite fails it.  ``check_moe_verify`` holds the path."""
    import torch

    paged, dense, _ = _verify_pair(params, dp, cfg, P, S)
    if not torch.isfinite(paged).all():
        raise AssertionError(f"{cfg.name}: full-width paged logits not "
                             "finite")
    rel, agree, margins = _paged_vs_dense(paged, dense)
    log(f"[full] {cfg.name} verify paged vs dense (prompt {P}, prefill "
        f"through K3; a reading): max rel logit diff={rel:.3e} argmax "
        f"agreement={agree:.3f} margins={margins}")


# a full-width prefill's K6 calls against the plain version on the same
# operands: final state max |diff| / max |ref|, output ||diff|| / ||ref||
K6_LAYER_STATE_REL, K6_LAYER_OUT_REL = 1e-3, 3e-3
# the per-layer check must fail a K6 whose output or state is off by this
K6_OFF = 0.99


def _k6_layers(params, dp, cfg, prompt, P: int, off_o: float = 1.0,
               off_state: float = 1.0) -> tuple:
    """Prefill ``prompt`` through K6, each layer's K6 call repeated by the
    plain version on the same operands (the layer's real activations).
    ``off_o``/``off_state`` scale K6's outputs, a planted fault.  Returns
    (the decode state, per layer (state rel, output rel, whether the
    output is finite and within bf16's elementwise 2e-2))."""
    from repro_torch.core.speculative import init_decode_state
    from repro_torch.kernels.linear_attn_chunk.ref import (
        decay_attention_chunked)
    from repro_torch.models import ssm

    kernel_fn = ssm.linear_attn_bshd
    errs = []

    def both(*args, **kw):
        o, st = kernel_fn(*args, **kw)
        if off_o != 1.0 or off_state != 1.0:
            o, st = o * off_o, st * off_state
        ref_o, ref_st = decay_attention_chunked(*args, **kw)
        ref_o, diff = ref_o.float(), o.float() - ref_o.float()
        close = bool((diff.abs() <= 2e-2 + 2e-2 * ref_o.abs()).all())
        rel = lambda a, b: (a / b).nan_to_num(math.inf).item()
        errs.append((rel((st - ref_st).abs().max(), ref_st.abs().max()),
                     rel(diff.norm(), ref_o.norm()), close))
        return o, st

    ssm.linear_attn_bshd = both
    try:
        state = init_decode_state(params, dp, cfg, prompt, P + 8)
    finally:
        ssm.linear_attn_bshd = kernel_fn
    return state, errs


def _k6_layers_hold(errs, n_layers: int) -> bool:
    return (len(errs) == n_layers and all(close for *_, close in errs)
            and max(e[0] for e in errs) <= K6_LAYER_STATE_REL
            and max(e[1] for e in errs) <= K6_LAYER_OUT_REL)


def check_rwkv_prefill(params, dp, cfg, P: int) -> None:
    """One full-width RWKV6 prefill of P tokens through K6 and one
    through its plain version, from the same prompt.

    Held: on the K6 run, every layer's K6 call is repeated by the plain
    version on the same operands (the layer's real activations), and
    the two must agree: the final state to a relative
    ``K6_LAYER_STATE_REL`` (max), the output to ``K6_LAYER_OUT_REL``
    (norm) and within bf16's elementwise 2e-2.  Two control runs scale
    K6's output, then its final state, by ``K6_OFF``; each must fail
    that check.  Read, printed: the two runs' final wkv states layer by
    layer, their first tokens and one chain verify step's logits, where
    bf16 rounding differences of each layer's output feed the next layer
    and grow with depth (random weights); these fail only if not finite,
    or if an argmax differs beyond a near tie (a lead of 1 or more in
    units of that position's largest logit difference)."""
    import torch
    from repro_torch.configs import tree_for
    from repro_torch.core.heads import draft_tree_tokens
    from repro_torch.core.speculative import init_decode_state
    from repro_torch.core.trees import device_arrays
    from repro_torch.kernels.linear_attn_chunk.ref import (
        decay_attention_chunked)
    from repro_torch.models import ssm
    from repro_torch.models.model import forward

    tree = tree_for(cfg)
    ta = device_arrays(tree, "cuda")
    g = torch.Generator(device="cuda").manual_seed(5)
    prompt = torch.randint(0, cfg.vocab_size, (1, P), generator=g,
                           device="cuda")
    states = {}
    states["K6"], errs = _k6_layers(params, dp, cfg, prompt, P)
    worst = [max(e[i] for e in errs) for i in (0, 1)]
    n_close = sum(e[2] for e in errs)
    off = {f"{what} x{K6_OFF}": _k6_layers(params, dp, cfg, prompt, P,
                                             **{kw: K6_OFF})[1]
           for what, kw in (("output", "off_o"), ("state", "off_state"))}
    log(f"[full] {cfg.name} prefill of {P}: K6 against its plain version on "
        f"each layer's own inputs ({len(errs)} layers): final state max rel "
        f"diff {worst[0]:.3e} (bound {K6_LAYER_STATE_REL}), output rel "
        f"norm diff {worst[1]:.3e} (bound {K6_LAYER_OUT_REL}), {n_close} "
        f"layers' outputs within 2e-2; with K6's "
        + "; ".join(f"{what}: {max(e[0] for e in es):.3e} / "
                    f"{max(e[1] for e in es):.3e}"
                    for what, es in off.items()))
    if not _k6_layers_hold(errs, cfg.n_layers):
        raise AssertionError(f"{cfg.name}: K6 and its plain version disagree "
                             f"on a layer's inputs: {errs}")
    for what, es in off.items():
        if _k6_layers_hold(es, cfg.n_layers):
            raise AssertionError(f"{cfg.name}: a K6 with its {what} passes "
                                 "the per-layer check")
    ssm_fn = ssm.linear_attn_bshd
    ssm.linear_attn_bshd = decay_attention_chunked
    try:
        states["plain"] = init_decode_state(params, dp, cfg, prompt, P + 8)
    finally:
        ssm.linear_attn_bshd = ssm_fn

    k6, plain = states["K6"], states["plain"]
    wk, wp = k6.cache[0]["wkv_state"], plain.cache[0]["wkv_state"]
    layer_rel = [((a - b).abs().max() / b.abs().max()).item()
                 for a, b in zip(wk, wp)]
    first = [(st.last_hidden.float() @ params["unembed_f32"])[0]
             for st in (k6, plain)]
    tokens, _ = draft_tree_tokens(dp, cfg, params, tree, k6.last_hidden,
                                  k6.last_token)
    pos = k6.cache_len[:, None] + ta["depth"][None]
    verify = [forward(params, cfg, tokens, pos, mode="verify",
                      cache=st.cache, cache_len=st.cache_len,
                      tree_mask=ta["mask"]).logits[0]
              for st in (k6, plain)]
    _, _, margins0 = _paged_vs_dense(first[0][None], first[1][None])
    rel, agree, margins = _paged_vs_dense(*verify)
    log(f"[full] {cfg.name} prefill of {P} through K6 vs through its plain "
        f"version (a reading): final wkv state rel diff by layer "
        f"{[round(r, 4) for r in layer_rel]}; first token "
        f"{int(k6.last_token[0])} vs {int(plain.last_token[0])} (margins "
        f"{margins0}); chain verify (T={tree.size}) max rel logit diff "
        f"{rel:.3e} argmax agreement {agree:.3f} margins {margins}")
    if not all(torch.isfinite(t).all() for t in (wk, *verify)):
        raise AssertionError(f"{cfg.name}: prefill states or logits not "
                             "finite")
    if any(m >= 1 for m in margins0 + margins):
        raise AssertionError(f"{cfg.name}: an argmax differs beyond a near "
                             f"tie: {margins0} / {margins}")


@dataclasses.dataclass(frozen=True)
class Workload:
    arch: str
    prompts: tuple        # prompt length range [lo, hi]
    max_len: int
    verify: dict          # engine -> {kernel name: launches per decode step}
    prefill: dict         # kernel name -> launches per prefill
    check_prompt: int     # the full-width check's prompt
    # phase 5b, chunked prefill through the paged engine: (layers, or None
    # for full depth; {kernel: launches per decode step}; {kernel:
    # launches per chunk}), or None
    chunked: tuple = None
    # phase 6: the loop modes served, by name (None: all of ``MODES``),
    # and the turns (None: ``MODE_REPS``)
    modes: tuple = None
    mode_reps: int = None
    # phase 6 and its replay check at a cut depth, from weights of their
    # own: (layers, {kernel: launches per decode step}), or None for the
    # full-depth weights
    modes_cut: tuple = None
    # phase 5c, sampled decoding: (engine, use_speculative, {kernel:
    # launches per decode step}, {kernel: launches per prefill}), or None
    sampled: tuple = None


# phase 5b's chunk and per-step prefill budget (one chunk)
PREFILL_CHUNK = 256

WORKLOADS = (
    # phase 5c: the autoregressive step (no draft heads, no prefix layer)
    # on the dense cache, K2 on each of the 32 layers
    Workload("minitron-4b", (64, 256), 512,
             {"paged": {"tree_attention_paged": 33},
              "continuous": {"tree_attention_dense": 33}},
             {"flash_attention": 33}, 100,
             sampled=("continuous", False, {"tree_attention_dense": 32},
                      {"flash_attention": 33})),
    Workload("gemma3-1b", (600, 1500), 2048,
             {"paged": {"tree_attention_paged_windowed": 26,
                        "tree_attention_paged": 1}},
             {"flash_attention": 27}, 1000,
             (None, {"tree_attention_paged_windowed": 26,
                     "tree_attention_paged": 1}, {"flash_attention": 27}),
             sampled=("paged", True, {"tree_attention_paged_windowed": 26,
                                      "tree_attention_paged": 1},
                      {"flash_attention": 27})),
    # phase 6 at 12 layers: the script's time limit
    Workload("rwkv6-1.6b", (600, 1500), 2048, {"paged": {}},
             {"linear_attn_chunk": 24}, 1000,
             (None, {}, {"linear_attn_chunk": 24}),
             modes_cut=(12, {}),
             sampled=("paged", True, {}, {"linear_attn_chunk": 24})),
    # chunked, and phase 6, at the bf16 depth of the MoE verify check: 2
    # layers (the dense one and one MoE layer) + the prefix layer
    Workload("deepseek-v2-lite-16b", (600, 1500), 2048,
             {"paged": {"mla_attention_paged": 27,
                        "tree_attention_paged": 1}},
             {"flash_attention": 28}, 1000,
             (2, {"mla_attention_paged": 2, "tree_attention_paged": 1},
              {"flash_attention": 3}),
             modes_cut=(2, {"mla_attention_paged": 2,
                            "tree_attention_paged": 1})),
    # the rest of the attention registry at gemma3-1b's traffic: GQA past
    # 64 query rows per kv head (144, 80 and 128 at T = 16) and GQA under
    # the DeepSeek MoE; K1 on every layer and the prefix layer, K3 on every
    # prefill; phase 6 in the synchronous eager loop and the default, once
    *(Workload(arch, (600, 1500), 2048,
               {"paged": {"tree_attention_paged": layers + 1}},
               {"flash_attention": layers + 1}, 1000,
               modes=("sync eager", "async captured"), mode_reps=1)
      for arch, layers in (("starcoder2-7b", 32), ("qwen2.5-32b", 64),
                           ("chameleon-34b", 48), ("deepseek-moe-16b", 28))),
    # zamba2's 38 Mamba2 layers between 7 invocations of the shared block:
    # K1 on each invocation a step, K3 on each a prefill, no K6; chunked at
    # full depth; phase 6 in the four modes, once, at 12 layers (two
    # invocations)
    Workload(ZAMBA2, (600, 1500), 2048, {"paged": {"tree_attention_paged": 7}},
             {"flash_attention": 7}, 1000,
             (None, {"tree_attention_paged": 7}, {"flash_attention": 7}),
             mode_reps=1, modes_cut=(12, {"tree_attention_paged": 2})),
)


def _add(total: dict, counts: dict) -> None:
    for k, n in counts.items():
        total[k] = total.get(k, 0) + n


def _nbytes(tree) -> int:
    """The bytes of every tensor of a nested dict/list/tuple (None
    holds none)."""
    if tree is None:
        return 0
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def serve_full_width(wl: Workload) -> tuple:
    """Serve 8 requests of ``wl`` at full width through each of its
    engines (phase 5), then chunked through the paged engine (phase 5b),
    then phase 6; returns the kernels' launch counts of these runs and
    the K2 launches of the paged-vs-dense verify check (0 for an MoE
    model, whose check at full depth is a reading)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.heads import init_draft_params
    from repro_torch.models.model import init_params

    cfg = get_config(wl.arch)
    gc.collect()                           # the previous model's tensors
    torch.cuda.empty_cache()
    S_check = -(-(wl.check_prompt + 64) // 256) * 256
    launches = {}
    if cfg.moe:
        check_moe_verify(wl.arch, wl.check_prompt, S_check)
    if wl.chunked and wl.chunked[0] is not None:
        _add(launches, serve_chunked_cut(wl))
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    dp = init_draft_params(cfg, seed=1, device="cuda")
    torch.cuda.synchronize()
    unembed = params["unembed_f32"].numel() * 4
    log(f"[full] {cfg.name}: {cfg.n_params / 1e9:.2f}B params ({cfg.dtype}), "
        f"{cfg.n_layers} layers (full depth, the config's widths), "
        f"initialised on the card in {time.perf_counter() - t0:.1f}s: "
        f"weights {(_nbytes(params) - unembed) / 1e9:.2f} GB, draft heads "
        f"and prefix layer {_nbytes(dp) / 1e9:.2f} GB, fp32 unembedding "
        f"{unembed / 1e9:.2f} GB; allocated "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB of the card's "
        f"{torch.cuda.get_device_properties(0).total_memory / 2 ** 30:.2f}")
    log_resolved(cfg, "full")
    pair_k2 = 0
    t_sub = time.perf_counter()

    def lap(what: str) -> None:
        nonlocal t_sub
        log(f"[time] {cfg.name} {what}: {time.perf_counter() - t_sub:.0f}s")
        t_sub = time.perf_counter()

    if cfg.moe:
        log_moe_verify(params, dp, cfg, wl.check_prompt, S_check)
    elif cfg.block_kind == "rwkv6":
        check_rwkv_prefill(params, dp, cfg, wl.check_prompt)
    elif cfg.block_kind == "mamba2":
        pair_k2 = check_zamba2_verify(params, dp, cfg, wl.check_prompt,
                                      S_check)
    else:
        pair_k2 = check_full_verify(params, dp, cfg, wl.check_prompt,
                                    S_check)
    lap("full-width verify check")
    runs = {}
    for engine in wl.verify:
        counts, outs, st = serve_engine(wl, cfg, params, dp, engine,
                                        wl.verify[engine], wl.prefill)
        runs[engine] = (outs, st)
        _add(launches, counts)
    lap("phase 5 serves")
    if wl.chunked and wl.chunked[0] is None:
        _add(launches, serve_chunked(wl, cfg, params, dp, runs["paged"]))
        lap("phase 5b")
    if wl.modes_cut is None:
        check_replay_step(wl, cfg, params, dp)
        serve_modes(wl, cfg, params, dp, wl.verify["paged"], CARD)
        lap("phase 6")
    if wl.sampled:
        _add(launches, serve_sampled(wl, cfg, params, dp, runs))
        lap("phase 5c")
    del params, dp
    gc.collect()
    torch.cuda.empty_cache()
    if wl.modes_cut is not None:
        serve_modes_cut(wl)
        lap(f"phase 6 at {wl.modes_cut[0]} layers")
    return launches, pair_k2


def serve_modes_cut(wl: Workload) -> None:
    """Phase 6 and its replay check at full width with depth cut to
    ``wl.modes_cut[0]`` layers, from weights of their own."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.heads import init_draft_params
    from repro_torch.models.model import init_params

    layers, per_step = wl.modes_cut
    cfg = dataclasses.replace(get_config(wl.arch), n_layers=layers)
    params = init_params(cfg, seed=0, device="cuda")
    dp = init_draft_params(cfg, seed=1, device="cuda")
    check_replay_step(wl, cfg, params, dp)
    serve_modes(wl, cfg, params, dp, per_step, CARD)
    del params, dp
    gc.collect()
    torch.cuda.empty_cache()


def serve_chunked_cut(wl: Workload) -> dict:
    """Phase 5b of an MoE model at full width with depth cut to
    ``wl.chunked[0]`` layers: the unchunked paged engine, then the chunked
    one, from the same weights."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.heads import init_draft_params
    from repro_torch.models.model import init_params

    layers, per_step, per_chunk = wl.chunked
    cfg = dataclasses.replace(get_config(wl.arch), n_layers=layers)
    params = init_params(cfg, seed=0, device="cuda")
    dp = init_draft_params(cfg, seed=1, device="cuda")
    launches = {}
    counts, outs, st = serve_engine(wl, cfg, params, dp, "paged", per_step,
                                    {"flash_attention": layers + 1})
    _add(launches, counts)
    _add(launches, serve_chunked(wl, cfg, params, dp, (outs, st)))
    del params, dp
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# phase 5b's chunked-vs-whole prefill bounds (max relative logit
# difference, least argmax agreement), phase 5's for a dense model; an
# MoE model's and the recurrent models' bf16 comparisons are readings (a
# chunk boundary moves MoE capacity; rwkv6 and zamba2 at random weights
# amplify bf16 rounding layer by layer), and those two are held in fp32
# instead
CHUNKED_BOUND = (0.1, MIN_ARGMAX_AGREEMENT)
RECURRENT_FP32_CHUNKED_BOUND = (1e-3, 1.0)
# the planted fault of the fp32 check: the carried state a chunked
# prefill drops (zeroed before every chunk); rwkv6 all of it, zamba2 the
# Mamba2 conv window alone
RECURRENT_DROPS = {"rwkv6": ("wkv_state", "shift_tm", "shift_cm"),
                   "mamba2": ("conv_win",)}


def serve_chunked(wl: Workload, cfg, params, dp, unchunked) -> dict:
    """Phase 5b: the chunked prefill's last 16 prompt positions against the
    unchunked prefill's (held for an attention model without MoE; for
    rwkv6 held in fp32 at full width, where dropping the carried state
    must fail the bound, and read in bf16), then the paged engine with
    ``PREFILL_CHUNK`` and a budget of one chunk over phase 5's requests,
    against the unchunked run ``unchunked`` = (outputs, stats)."""
    _, per_step, per_chunk = wl.chunked
    recurrent = cfg.block_kind in RECURRENT_DROPS
    check_chunked_logits(params, cfg, wl.check_prompt,
                         None if cfg.moe or recurrent else CHUNKED_BOUND)
    if recurrent:
        check_recurrent_chunked_fp32(cfg, wl.check_prompt)
    counts, outs, st = serve_engine(wl, cfg, params, dp, "paged", per_step,
                                    per_chunk=per_chunk,
                                    prefill_chunk=PREFILL_CHUNK)
    base_outs, base = unchunked
    same = sum(a == b for a, b in zip(outs, base_outs))
    log(f"[5b] {cfg.name} ({cfg.n_layers} layers) paged engine, chunk "
        f"{PREFILL_CHUNK} budget {PREFILL_CHUNK} against whole-prompt "
        f"joins: {same} of {len(outs)} streams token-identical; ttft "
        f"{st.mean_ttft_s * 1e3:.1f} vs {base.mean_ttft_s * 1e3:.1f}ms, "
        f"p99_itl {st.p99_itl_s * 1e3:.1f} vs {base.p99_itl_s * 1e3:.1f}ms, "
        f"tok/s {st.tokens_per_s:.1f} vs {base.tokens_per_s:.1f}, step "
        f"{st.mean_step_s * 1e3:.1f} vs {base.mean_step_s * 1e3:.1f}ms")
    return counts


def check_recurrent_chunked_fp32(cfg, P: int) -> None:
    """A recurrent model (rwkv6, zamba2) at full width in fp32: the
    chunked prefill (K6 or the Mamba2 SSD from the carried state, zamba2's
    shared block through K3's chunk form) held against one whole prefill
    at ``RECURRENT_FP32_CHUNKED_BOUND`` at the 16 positions after each
    chunk boundary (where the carried state, token shift or conv window
    act) and the last 16; the same with ``RECURRENT_DROPS``'s keys zeroed
    before every chunk (a chunk that does not carry them) must fail it."""
    import torch
    from repro_torch.models.model import init_params

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = init_params(cfg32, seed=0, device="cuda")
    C = -(-PREFILL_CHUNK // cfg.ssm.chunk_size) * cfg.ssm.chunk_size
    rows = sorted({b + i for b in range(C, P, C) for i in range(16)
                   if b + i < P} | set(range(P - 16, P)))
    bound = RECURRENT_FP32_CHUNKED_BOUND
    check_chunked_logits(params, cfg32, P, bound, rows)
    if cfg.block_kind == "mamba2":
        check_k3_prefill_fp32(params, cfg32, P, rows)
    drop = RECURRENT_DROPS[cfg.block_kind]
    rel, agree = check_chunked_logits(params, cfg32, P, None, rows,
                                      drop_keys=drop)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if rel <= bound[0] and agree >= bound[1]:
        raise AssertionError(f"{cfg32.name}: a chunked prefill that drops "
                             f"its carried {drop} reads rel {rel}, argmax "
                             f"{agree}: within the bound")


def check_k3_prefill_fp32(params, cfg, P: int, rows) -> None:
    """zamba2 at full width in fp32: one whole prefill through K3 (the
    shared block's invocations) against one through K3's plain version,
    held at ``RECURRENT_FP32_CHUNKED_BOUND`` at ``rows`` (the bf16
    comparison of phase 5 diverges too far through the 38 Mamba2 layers
    to tell a right K3 from a wrong one); the same with K3's output off by
    ``K5_OFF`` (a planted fault) must fail it."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_plain
    from repro_torch.models import attention
    from repro_torch.models.model import forward

    g = torch.Generator(device="cuda").manual_seed(P + 1)
    tokens = torch.randint(0, cfg.vocab_size, (1, P), generator=g,
                           device="cuda")
    pos = torch.arange(P, device="cuda")[None]
    kernel_fn = attention.flash_attention_bshd

    def logits(fn):
        attention.flash_attention_bshd = fn
        try:
            h = forward(params, cfg, tokens, pos, mode="full",
                        want_logits=False).hidden[0, rows]
        finally:
            attention.flash_attention_bshd = kernel_fn
        return h.float() @ params["unembed_f32"]

    plain = logits(flash_attention_plain)
    bound = RECURRENT_FP32_CHUNKED_BOUND
    for what, fn in (("K3", kernel_fn),
                     (f"K3 off by {K5_OFF}",
                      lambda *a, **kw: kernel_fn(*a, **kw) * K5_OFF)):
        lk = logits(fn)
        rel, agree, margins = _paged_vs_dense(lk, plain)
        held = bool(torch.isfinite(lk).all()) and rel <= bound[0] \
            and agree >= bound[1]
        log(f"[5b] {cfg.name} ({cfg.n_layers} layers, {cfg.dtype}) whole "
            f"prefill of {P} tokens through {what} against one through "
            f"K3's plain version, {len(rows)} positions: max rel logit "
            f"diff={rel:.3e} argmax agreement={agree:.3f} margins={margins} "
            f"(bound {bound[0]}, {bound[1]:.3f})")
        if held != (what == "K3"):
            raise AssertionError(f"{cfg.name}: the fp32 prefill through "
                                 f"{what} reads rel {rel}, argmax {agree}: "
                                 f"{'outside' if what == 'K3' else 'within'}"
                                 " the bound")


def check_chunked_logits(params, cfg, P: int, bound, rows=None,
                         drop_keys=()) -> tuple:
    """The logits at prompt positions ``rows`` (default the last 16) of a
    P-token prompt prefilled in chunks of ``PREFILL_CHUNK`` (K3's chunk
    form, K6 or the Mamba2 SSD from the carried state) against one whole
    prefill.  ``bound`` = (max |diff| / max |logit|, least argmax
    agreement), or None for a reading that fails only on a logit that is
    not finite.  ``drop_keys``: recurrent state keys zeroed before every
    chunk (a planted fault).  Returns (relative difference, argmax
    agreement)."""
    import torch
    from repro_torch.models.model import forward, init_cache

    C = PREFILL_CHUNK
    if cfg.block_kind in RECURRENT_DROPS:
        C = -(-C // cfg.ssm.chunk_size) * cfg.ssm.chunk_size
    rows = list(range(P - 16, P)) if rows is None else rows
    g = torch.Generator(device="cuda").manual_seed(P)
    S = -(-P // C) * C
    tokens = torch.zeros((1, S), dtype=torch.long, device="cuda")
    tokens[0, :P] = torch.randint(0, cfg.vocab_size, (P,), generator=g,
                                  device="cuda")
    whole = forward(params, cfg, tokens[:, :P],
                    torch.arange(P, device="cuda")[None], mode="full",
                    want_logits=False).hidden[0, rows]
    cache = init_cache(cfg, 1, S, "cuda")
    full = lambda x: torch.full((1,), x, dtype=torch.int32, device="cuda")
    hs = []
    for start in range(0, S, C):
        for group in cache:
            for key, arr in group.items():
                if key in drop_keys:
                    arr.zero_()
        hs.append(forward(params, cfg, tokens[:, start:start + C],
                          torch.arange(start, start + C, device="cuda")[None],
                          mode="full", cache=cache, cache_len=full(start),
                          valid_len=full(min(max(P - start, 0), C)),
                          want_logits=False).hidden[0])
    chunked = torch.cat(hs)[rows]
    w = params["unembed_f32"]
    lc, lw = chunked.float() @ w, whole.float() @ w
    finite = bool(torch.isfinite(lc).all())
    rel, agree, margins = _paged_vs_dense(lc, lw)
    what = ("a reading" if bound is None
            else f"bound {bound[0]}, {bound[1]:.3f}")
    where = (f"last {len(rows)} positions" if rows == list(range(P - 16, P))
             else f"{len(rows)} positions: 16 after each chunk boundary and "
                  "the last 16")
    log(f"[5b] {cfg.name} ({cfg.n_layers} layers, {cfg.dtype}) prefill of "
        f"{P} tokens in chunks of {C}"
        + (f" dropping its carried {'/'.join(drop_keys)}" if drop_keys
           else "") + " against one "
        f"whole prefill, {where}: max rel logit diff={rel:.3e} "
        f"argmax agreement={agree:.3f} margins={margins} ({what})")
    if not finite:
        raise AssertionError(f"{cfg.name}: chunked prefill logits not finite")
    if bound is not None and (rel > bound[0] or agree < bound[1]):
        raise AssertionError(f"{cfg.name}: chunked and whole prefill "
                             f"disagree: rel {rel}, argmax agreement {agree}")
    return rel, agree


SERVE_BATCH, SERVE_BUDGET, SERVE_REQUESTS, BLOCK = 4, 32, 8, 16


def make_engine(wl: Workload, cfg, params, dp, engine: str, **kw):
    """The engine phases 5-6 serve ``wl`` through ("paged": a pool half the
    dense footprint; "continuous"); ``kw`` goes to the engine (inflight,
    capture_step, prefill_chunk)."""
    from repro_torch.configs import tree_for
    from repro_torch.serving.engine import (PagedSpeculativeEngine,
                                            SpeculativeEngine)

    tree = tree_for(cfg)
    if engine == "paged":
        usable = int(0.5 * SERVE_BATCH * wl.max_len) // BLOCK
        return PagedSpeculativeEngine(params, dp, cfg, tree,
                                      max_len=wl.max_len, block_size=BLOCK,
                                      num_blocks=usable + 1, **kw)
    return SpeculativeEngine(params, dp, cfg, tree, max_len=wl.max_len, **kw)


def workload_requests(wl: Workload, cfg) -> list:
    """Phase 5's 8 requests of ``wl`` (the same in every run)."""
    import numpy as np
    from repro_torch.serving.engine import Request

    rs = np.random.RandomState(0)
    lo, hi = wl.prompts
    return [Request(prompt=rs.randint(0, cfg.vocab_size,
                                      rs.randint(lo, hi + 1)).astype(np.int32),
                    max_new_tokens=SERVE_BUDGET)
            for _ in range(SERVE_REQUESTS)]


def check_capture(name: str, eng, st, per_step: dict) -> int:
    """The captured step's counts: its capture launched ``per_step``'s
    kernels once each (and each second launch as often), nothing else,
    and it was replayed once a step, warm-up included.  Returns the eager
    runs of the step the launch counters saw: the capture's eager warm-up
    and the capture itself (2), or every step when the engine runs
    eagerly."""
    cap = eng.captured
    if cap is None:
        return st.steps + st.warmup_steps
    want = {k: 0 for k in cap.launches}
    for k, n in per_step.items():
        want[k] = n
        for attr in SECOND_COUNTERS:
            if f"{k} {attr}" in want:
                want[f"{k} {attr}"] = n
    if cap.launches != want:
        raise AssertionError(f"{name}: launches per capture {cap.launches} "
                             f"!= {want}")
    if st.captures != 1 or cap.replays != st.steps + st.warmup_steps:
        raise AssertionError(f"{name}: {st.captures} captures, "
                             f"{cap.replays} replays for {st.steps} steps "
                             f"+ {st.warmup_steps} warm-up")
    return 2


def serve_engine(wl: Workload, cfg, params, dp, engine: str, per_step: dict,
                 per_prefill: dict = None, *, per_chunk: dict = None,
                 prefill_chunk: int = 0, engine_kw: dict = None) -> tuple:
    """Serve 8 requests of ``wl`` through ``engine`` ("paged" or
    "continuous"; chunked prefill when ``prefill_chunk``) as a user would
    (the async loop, the step captured as one CUDA graph), counting every
    kernel launch of the run against ``per_step`` launches a decode step
    (at the capture and its eager warm-up; the replays are counted by the
    capture) and ``per_prefill`` a whole-prompt prefill (``per_chunk`` a
    chunk).  ``engine_kw`` goes to the engine (phase 5c: the sampling
    arguments).  Returns (launch counts, the requests' outputs, the
    engine's stats)."""
    import torch
    from repro_torch import kernels

    eng = make_engine(wl, cfg, params, dp, engine,
                      prefill_chunk=prefill_chunk, **(engine_kw or {}))
    reqs = workload_requests(wl, cfg)
    budget, max_batch = SERVE_BUDGET, SERVE_BATCH
    lo, hi = wl.prompts
    counters = kernel_counters()
    k3 = counters["flash_attention"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()                 # count the main path only
    st = eng.serve(reqs, max_batch=max_batch)
    torch.cuda.synchronize()
    counts = {k: m.launches for k, m in counters.items()}
    # each tree-verify or K5 call launches its split sweep (counted) and a
    # merge, each K6 call its chunk kernel (counted) and a scan
    merges = {f"{k} {attr}": getattr(m, attr) for k, m in counters.items()
              for attr in SECOND_COUNTERS if hasattr(m, attr)}
    if any(n != counts[k.split()[0]] for k, n in merges.items()):
        raise AssertionError(f"{cfg.name}: second launches {merges} != "
                             f"first launches {counts}")
    for r in reqs:
        if len(r.output) != budget or not all(0 <= t < cfg.vocab_size
                                              for t in r.output):
            raise AssertionError(f"bad output: {len(r.output)} tokens")
    steps = check_capture(f"{cfg.name} {engine}", eng, st, per_step)
    prefills = len(reqs) + st.preemptions
    if engine == "paged" and eng._alloc.blocks_in_use:
        raise AssertionError(f"{cfg.name}: {eng._alloc.blocks_in_use} "
                             "blocks in use after the serve")
    expect = {k: 0 for k in counters}
    for k, n in per_step.items():
        expect[k] += n * steps
    per, times = ((per_chunk, st.prefill_chunks) if prefill_chunk
                  else (per_prefill, prefills))
    for k, n in per.items():
        expect[k] += n * times
    if counts != expect:
        raise AssertionError(f"{cfg.name}: kernel launches {counts} != "
                             f"{expect} ({steps} steps, {prefills} "
                             f"prefills, {st.prefill_chunks} chunks)")
    # every K3 call of a chunked run is the chunk form, of a whole-prompt
    # run none
    if k3.chunk_launches != (counts["flash_attention"] if prefill_chunk
                             else 0):
        raise AssertionError(f"{cfg.name}: {k3.chunk_launches} K3 chunk-form "
                             f"launches of {counts['flash_attention']}")
    counts["flash_attention_chunk"] = k3.chunk_launches
    chunking = (f"chunk={eng.prefill_chunk} chunks={st.prefill_chunks} "
                f"(per chunk {per_chunk}) " if prefill_chunk
                else f"(per prefill {per_prefill}) ")
    sampling = (f"criterion={eng.criterion} speculative="
                f"{eng.use_speculative} " if engine_kw else "")
    log(f"[full] {cfg.name} {engine} engine {sampling}served {len(reqs)} "
        f"requests x "
        f"{budget} tokens (prompts {lo}-{hi}): steps={st.steps} "
        f"(+{st.warmup_steps} "
        f"warm-up; {eng.captured.replays} replays of one captured step, "
        f"inflight {eng.inflight}) tok/step={st.tokens_per_step:.3f} "
        f"tok/s={st.tokens_per_s:.1f} step={st.mean_step_s * 1e3:.1f}ms "
        f"ttft={st.mean_ttft_s * 1e3:.1f}ms "
        f"p99_itl={st.p99_itl_s * 1e3:.1f}ms "
        f"host_stall={st.host_stall_s * 1e3:.1f}ms wall={st.wall_s:.2f}s "
        f"preemptions={st.preemptions} prefills={prefills} "
        + (f"peak_blocks={st.peak_blocks_in_use}/{st.num_blocks - 1} "
           if engine == "paged" else "") +
        f"max_memory_allocated="
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f}GiB "
        f"launches={counts} (per step {per_step}) {chunking}"
        f"second launches={merges}")
    outs = [list(r.output) for r in reqs]
    del eng
    return counts, outs, st


# ---------------------------------------------------------------------------
# phase 6: the async window and the captured step
# ---------------------------------------------------------------------------

# (name, inflight, capture_step): the synchronous eager loop, the async
# window alone, the window with the step captured as one CUDA graph (the
# default), and the captured step alone; served in turns MODE_REPS times
MODES = (("sync eager", 1, False), ("async eager", 2, False),
         ("async captured", 2, True), ("sync captured", 1, True))
MODE_REPS = 3


def _clone(x):
    """A deep copy of a pool state's tensors (NamedTuples, lists, dicts)."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_clone(v) for v in x]
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_clone(v) for v in x))
    return x


def joined_paged_state(wl: Workload, cfg, params, dp) -> tuple:
    """(paged pool state, host block table): phase 5's first 4 prompts of
    ``wl`` joined into a pool of ``SERVE_BATCH`` slots of ``wl.max_len``
    positions in blocks of ``BLOCK``, each slot owning its own blocks."""
    import numpy as np
    import torch
    from repro_torch.serving.paged import init_paged_state, paged_join_slot

    B, M = SERVE_BATCH, wl.max_len // BLOCK
    table = (1 + np.arange(B * M, dtype=np.int32)).reshape(B, M)
    state = init_paged_state(params, dp, cfg, B, 1 + B * M, BLOCK, "cuda")
    for si, r in enumerate(workload_requests(wl, cfg)[:B]):
        n = len(r.prompt)
        prompt = torch.zeros(-(-n // 32) * 32, dtype=torch.long)
        prompt[:n] = torch.from_numpy(r.prompt)
        paged_join_slot(params, dp, cfg, state, prompt.cuda(), n, si,
                        torch.as_tensor(table[si], device="cuda"))
    return state, table


def check_replay_step(wl: Workload, cfg, params, dp, steps: int = 3,
                      sampling: dict = None) -> None:
    """One captured step replayed against the eager step from the same
    state: phase 5's first 4 prompts joined into a paged pool, three
    steps over 3 of the 4 rows; ``emitted``, ``n_emitted``, ``cache_len``,
    ``last_token`` and the next step's ``last_hidden`` must be bitwise
    equal after each.  ``sampling`` (phase 5c: ``use_speculative``,
    ``criterion``, ``temperature``, ``epsilon``, ``seed``): the step
    samples from a CUDA generator registered with the graph; each eager
    step starts from the generator state its replay started from, must
    leave it where the replay left it, and a replay must move it."""
    import numpy as np
    import torch
    from repro_torch.configs import tree_for
    from repro_torch.serving.graph import CapturedStep, step_in_place
    from repro_torch.serving.paged import (paged_autoregressive_step,
                                           paged_spec_decode_step)

    tree = tree_for(cfg)
    state, table = joined_paged_state(wl, cfg, params, dp)
    B = SERVE_BATCH
    eager = _clone(state)
    sampling = dict(sampling or {})
    spec = sampling.pop("use_speculative", True)
    gen = None
    if sampling:
        gen = torch.Generator(device="cuda").manual_seed(sampling.pop("seed"))
        sampling["generator"] = gen

    def step(st, active, tbl):
        if spec:
            return paged_spec_decode_step(params, dp, cfg, tree, st, tbl,
                                          active=active, **sampling)
        return paged_autoregressive_step(
            params, cfg, st, tbl, active=active, greedy=False,
            temperature=sampling["temperature"], generator=gen)

    rng0 = None if gen is None else gen.get_state()
    cap = CapturedStep(step, state, B, table.shape, generator=gen)
    if gen is not None and not torch.equal(gen.get_state(), rng0):
        raise AssertionError(f"{cfg.name}: the capture moved the generator")
    active = np.array([True, True, False, True])
    dev_active = torch.as_tensor(active, device="cuda")
    dev_table = torch.as_tensor(table, device="cuda")
    for k in range(steps):
        rng = None if gen is None else gen.get_state()
        e1, n1 = (t.clone() for t in cap(active, table))
        if gen is not None:
            after = gen.get_state()
            if torch.equal(after, rng):
                raise AssertionError(f"{cfg.name}: replay {k} drew nothing")
            gen.set_state(rng)
        e2, n2 = step_in_place(step, eager, dev_active, dev_table)
        torch.cuda.synchronize()
        if gen is not None and not torch.equal(gen.get_state(), after):
            raise AssertionError(f"{cfg.name}: the eager step {k} moved the "
                                 "generator elsewhere than its replay")
        for name, a, b in (("emitted", e1, e2), ("n_emitted", n1, n2),
                           ("cache_len", state.cache_len, eager.cache_len),
                           ("last_token", state.last_token, eager.last_token),
                           ("last_hidden", state.last_hidden,
                            eager.last_hidden)):
            if not torch.equal(a, b):
                raise AssertionError(f"{cfg.name}: replayed step {k} "
                                     f"differs from the eager step in {name}")
    tag = "[6]" if gen is None else (
        f"[5c] sampled ({'typical' if spec else 'autoregressive'}, from the "
        "same generator state)")
    log(f"{tag} {cfg.name}: {steps} replays of the captured step bitwise "
        f"equal to the eager steps from the same state (emitted, n_emitted, "
        f"cache_len, last_token, last_hidden); launches per capture "
        f"{ {k: n for k, n in cap.launches.items() if n} }")
    del cap, state, eager
    gc.collect()
    torch.cuda.empty_cache()


def serve_once(eng, wl: Workload, cfg, source: bool = False) -> dict:
    """One serve of phase 5's requests (``source``: the first half
    submitted, the rest through a generator source); this serve's numbers
    (the engine's stats accumulate across serves) and outputs."""
    import numpy as np

    st = eng.stats
    before = dict(steps=st.steps, tokens=st.tokens, wall=st.wall_s,
                  stall=st.host_stall_s, wait=st.read_wait_s,
                  step_s=len(st.step_s), ttft=len(st.ttft_s),
                  itl=len(st.itl_s), preempt=st.preemptions)
    reqs = workload_requests(wl, cfg)
    if source:
        half = len(reqs) // 2
        for r in reqs[:half]:
            eng.submit(r)
        eng.serve(source=iter(reqs[half:]), max_batch=SERVE_BATCH)
    else:
        eng.serve(reqs, max_batch=SERVE_BATCH)
    steps = st.steps - before["steps"]
    wall = st.wall_s - before["wall"]
    tokens = st.tokens - before["tokens"]
    itl = st.itl_s[before["itl"]:]
    return {"steps": steps, "tokens": tokens, "wall_s": wall,
            "tok_s": tokens / wall,
            "step_ms": float(np.mean(st.step_s[before["step_s"]:])) * 1e3,
            "interval_ms": wall / max(steps, 1) * 1e3,
            "host_stall_s": st.host_stall_s - before["stall"],
            "read_wait_s": st.read_wait_s - before["wait"],
            "ttft_ms": float(np.mean(st.ttft_s[before["ttft"]:])) * 1e3,
            "p99_itl_ms": float(np.percentile(itl, 99)) * 1e3,
            "preemptions": st.preemptions - before["preempt"],
            "blocks_left": eng._alloc.blocks_in_use,
            "outs": [list(r.output) for r in reqs]}


def device_busy_s(fn, n: int) -> float:
    """Device busy seconds of one ``fn()``: kernel and copy durations of
    ``n`` calls under ``torch.profiler``, over ``n`` (one stream, so they
    add up to the busy time).  The durations are summed over the raw
    trace (``kineto_results``): building the profiler's Python event tree
    over a serve of captured steps (thousands of kernels a replay) and
    eager prefills takes minutes."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    busy_ns = sum(e.duration_ns()
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA)
    return busy_ns / 1e9 / n


def traced_busy(eng, wl: Workload, cfg) -> tuple:
    """One serve under ``torch.profiler`` (``device_busy_s``): (device
    busy seconds, the traced serve's numbers)."""
    runs = []
    busy = device_busy_s(lambda: runs.append(serve_once(eng, wl, cfg)), 1)
    return busy, runs[0]


def serve_modes(wl: Workload, cfg, params, dp, per_step: dict,
                smi: str) -> None:
    """Phase 6: phase 5's requests through the paged engine in each of
    ``MODES``, in turns, ``MODE_REPS`` times, one engine per mode kept
    across its serves.  Every stream must equal the synchronous eager
    loop's token for token, no block may stay in use (a preemption under
    ``inflight=2`` included), each captured engine must hold one capture
    that launches ``per_step``'s kernels and is replayed once a step, and
    a serve fed by a generator source must reuse it.  Prints each mode's
    step time and tok/s per turn, the async loop's stall and read wait,
    and the device's idle share under the graph."""
    import numpy as np
    import torch

    modes = [m for m in MODES if wl.modes is None or m[0] in wl.modes]
    reps = wl.mode_reps or MODE_REPS
    torch.cuda.reset_peak_memory_stats()
    engines = {name: make_engine(wl, cfg, params, dp, "paged",
                                 inflight=inflight, capture_step=capture)
               for name, inflight, capture in modes}
    runs = {name: [] for name in engines}
    for _ in range(reps):
        for name, eng in engines.items():
            runs[name].append(serve_once(eng, wl, cfg))
    ref = runs["sync eager"][0]["outs"]
    for name, rs in runs.items():
        for run in rs:
            same = sum(a == b for a, b in zip(run["outs"], ref))
            if same != len(ref):
                raise AssertionError(f"{cfg.name} {name}: {same} of "
                                     f"{len(ref)} streams equal the "
                                     "synchronous eager loop's")
            if run["blocks_left"]:
                raise AssertionError(f"{cfg.name} {name}: "
                                     f"{run['blocks_left']} blocks in use "
                                     "after the serve")
    for name, inflight, capture in modes:
        if capture:
            check_capture(f"{cfg.name} {name}", engines[name],
                          engines[name].stats, per_step)
    eng = engines["async captured"]
    cap = eng.captured
    fed = serve_once(eng, wl, cfg, source=True)
    if fed["outs"] != ref or eng.stats.captures != 1 \
            or eng.captured is not cap or fed["blocks_left"]:
        raise AssertionError(f"{cfg.name}: a serve fed by a generator "
                             f"source took {eng.stats.captures} captures "
                             "or changed a stream")
    preempted = sum(r["preemptions"] for r in runs["async captured"])
    for name, rs in runs.items():
        log(f"[6] {cfg.name} {name} ({smi}): step "
            f"{[round(r['step_ms'], 2) for r in rs]} ms (dispatch to read), "
            f"wall/step {[round(r['interval_ms'], 2) for r in rs]} ms, tok/s "
            f"{[round(r['tok_s'], 1) for r in rs]}, ttft "
            f"{[round(r['ttft_ms'], 1) for r in rs]} ms, p99 itl "
            f"{[round(r['p99_itl_ms'], 1) for r in rs]} ms, host_stall "
            f"{[round(r['host_stall_s'], 4) for r in rs]} s, read_wait "
            f"{[round(r['read_wait_s'], 3) for r in rs]} s, steps "
            f"{rs[0]['steps']}, steps_in_flight "
            f"{engines[name].stats.steps_in_flight}, preemptions "
            f"{rs[0]['preemptions']}")
    busy, traced = traced_busy(eng, wl, cfg)
    untraced = float(np.mean([r["wall_s"] for r in runs["async captured"]]))
    log(f"[6] {cfg.name} async captured, traced ({smi}): device busy "
        f"{busy * 1e3:.1f} ms over {traced['steps']} steps "
        f"({busy / max(traced['steps'], 1) * 1e3:.2f} ms a step, prefills "
        f"included) in a serve of {traced['wall_s'] * 1e3:.1f} ms traced, "
        f"{untraced * 1e3:.1f} ms untraced: idle share "
        f"{1 - busy / traced['wall_s']:.3f} traced, "
        f"{1 - busy / untraced:.3f} against the untraced wall")
    log(f"[6] {cfg.name}: every stream of the {len(modes)} modes x "
        f"{reps} turns and of a generator-fed serve equal to the "
        f"synchronous eager loop's; one capture per captured engine, "
        f"{cap.replays if cap else 0} replays; {preempted} preemptions under "
        "inflight=2, no block left in use; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB allocated, "
        f"{torch.cuda.max_memory_reserved() / 2 ** 30:.2f} GiB reserved "
        "(weights, the engines' pools and the captured steps' graph pools)")
    del engines, eng, cap
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5c: sampled decoding at full width
# ---------------------------------------------------------------------------

# JAX's defaults (repro/serving/engine.py): typical acceptance, τ 0.7, ε 0.15
SAMPLING = dict(criterion="typical", temperature=0.7, epsilon=0.15, seed=0)
# a chi-square test of the sampler passes above this p-value
CHI2_P_FLOOR = 1e-4


def serve_sampled(wl: Workload, cfg, params, dp, greedy_runs: dict) -> dict:
    """Phase 5c for ``wl``: phase 5's requests through ``wl.sampled``'s
    engine under ``SAMPLING`` (the engines' defaults otherwise): launches
    per capture and per prefill as ``wl.sampled`` says (sampling adds
    none of the port's kernels), no block left; a second serve with the
    same seed gives the same streams; at ``max_batch=1`` two requests in
    turn give the same streams in the four ``MODES``; three replays of
    the sampled step bitwise equal to the eager step from the same state
    and generator state.  Prints the serve's numbers beside phase 5's
    greedy ones (``greedy_runs``: engine -> (outputs, stats)).  Returns
    the first serve's launch counts."""
    import numpy as np

    engine, spec, per_step, per_prefill = wl.sampled
    kw = dict(SAMPLING, use_speculative=spec)
    counts, outs, st = serve_engine(wl, cfg, params, dp, engine, per_step,
                                    per_prefill, engine_kw=kw)
    again = serve_engine(wl, cfg, params, dp, engine, per_step, per_prefill,
                         engine_kw=kw)[1]
    if again != outs:
        raise AssertionError(f"{cfg.name}: two sampled serves with one seed "
                             "gave different streams")
    two = workload_requests(wl, cfg)[:2]
    streams = {}
    for name, inflight, capture in MODES:
        eng = make_engine(wl, cfg, params, dp, engine, inflight=inflight,
                          capture_step=capture, **kw)
        reqs = [dataclasses.replace(r, output=[]) for r in two]
        eng.serve(reqs, max_batch=1)
        if engine == "paged" and eng._alloc.blocks_in_use:
            raise AssertionError(f"{cfg.name} {name}: blocks left in use")
        streams[name] = [r.output for r in reqs]
        del eng
    if any(v != streams["sync eager"] for v in streams.values()):
        raise AssertionError(f"{cfg.name}: at max_batch=1 the sampled "
                             f"streams differ across the loop modes")
    check_replay_step(wl, cfg, params, dp, sampling=kw)
    g_st = greedy_runs[engine][1]
    what = "typical" if spec else "autoregressive, sampled"
    emit, g_emit = (float(np.mean(x.accept_lengths)) for x in (st, g_st))
    log(f"[5c] {cfg.name} {engine} engine ({CARD}), {what}, τ "
        f"{SAMPLING['temperature']} ε {SAMPLING['epsilon']}: tok/s="
        f"{st.tokens_per_s:.1f} tok/step={st.tokens_per_step:.3f} (over the "
        f"batch) emitted per row a step={emit:.3f} (mean accepted "
        f"{emit - 1:.3f}) ttft={st.mean_ttft_s * 1e3:.1f}ms "
        f"p99_itl={st.p99_itl_s * 1e3:.1f}ms steps={st.steps}; phase 5 "
        f"greedy (speculative) on this engine: tok/s={g_st.tokens_per_s:.1f} "
        f"tok/step={g_st.tokens_per_step:.3f} emitted per row a "
        f"step={g_emit:.3f} ttft={g_st.mean_ttft_s * 1e3:.1f}ms "
        f"p99_itl={g_st.p99_itl_s * 1e3:.1f}ms steps={g_st.steps}; a second "
        f"serve with the seed gave the same streams; at max_batch=1 the "
        f"four loop modes gave the same streams")
    return counts


def chi_square_p(draws, probs) -> tuple:
    """(p-value, statistic, degrees of freedom) of ``draws``' counts
    against ``probs`` over the bins with p > 1e-3, the rest lumped into
    one bin; the p-value by the Wilson-Hilferty approximation."""
    import numpy as np

    counts = np.bincount(draws, minlength=probs.shape[0]).astype(np.float64)
    big = probs > 1e-3
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(probs[big], probs[~big].sum()) * draws.size
    keep = exp > 0
    stat = float(((obs[keep] - exp[keep]) ** 2 / exp[keep]).sum())
    k = int(keep.sum()) - 1
    z = (((stat / k) ** (1 / 3) - (1 - 2 / (9 * k)))
         / math.sqrt(2 / (9 * k)))
    return 0.5 * math.erfc(z / math.sqrt(2)), stat, k


def check_sampler(gen, V: int = 1024, log2_draws: int = 20,
                  temperature: float = 0.7) -> None:
    """2^``log2_draws`` Gumbel-max draws (``sample_categorical``) over one
    logit row of ``V`` at ``temperature`` from ``gen`` (a CUDA generator,
    seeded as an engine's is), eagerly and replayed inside a CUDA graph
    registered with it: a replay equals the eager draw from the same
    generator state bit for bit, two replays differ, and both sets pass a
    chi-square test against ``softmax(logits / temperature)`` (p above
    ``CHI2_P_FLOOR``); draws that ignore the temperature must fail it."""
    import torch
    from repro_torch.core.verify import sample_categorical

    g = torch.Generator(device="cuda").manual_seed(V)
    logits = torch.randn(V, generator=g, device="cuda") * 1.5
    probs = torch.softmax(logits.double() / temperature, -1).cpu().numpy()
    rows = 1 << 16
    reps = (1 << log2_draws) // rows
    scaled = (logits / temperature).expand(rows, V)
    flat = logits.expand(rows, V)
    eager = [sample_categorical(scaled, gen) for _ in range(reps)]
    rng = gen.get_state()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sample_categorical(scaled, gen)
    torch.cuda.current_stream().wait_stream(side)
    gen.set_state(rng)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph):
        out = sample_categorical(scaled, gen)
    graph.replay()
    first = out.clone()
    gen.set_state(rng)
    if not torch.equal(first, sample_categorical(scaled, gen)):
        raise AssertionError("a replayed draw differs from the eager draw "
                             "from the same generator state")
    captured = [first]
    for _ in range(reps - 1):
        graph.replay()
        captured.append(out.clone())
    if torch.equal(captured[0], captured[1]):
        raise AssertionError("two replays of the sampler drew the same")
    ignoring = [sample_categorical(flat, gen) for _ in range(reps)]
    results = {}
    for what, draws in (("eager", eager), ("captured", captured),
                        ("temperature ignored", ignoring)):
        p, stat, k = chi_square_p(torch.cat(draws).cpu().numpy(), probs)
        results[what] = p
        log(f"[5c] sampler ({CARD}), {what}: {rows * reps} draws over "
            f"V={V} at τ {temperature}: chi-square {stat:.1f} on {k} "
            f"degrees of freedom, p={p:.3e} (passes above {CHI2_P_FLOOR})")
    if not (results["eager"] > CHI2_P_FLOOR
            and results["captured"] > CHI2_P_FLOOR
            and results["temperature ignored"] < CHI2_P_FLOOR):
        raise AssertionError(f"sampler chi-square check: {results}")
    del graph


# ---------------------------------------------------------------------------
# phase 5d: hubert-xlarge's encoder at full width
# ---------------------------------------------------------------------------

# frames (B, S): 30 s of audio at HuBERT's 50 frames a second, two clips
HUBERT_FRAMES = (2, 1500)
# the fp32 forward through K3 against its plain version: max relative
# logit difference, least argmax agreement, at HUBERT_ROWS positions
HUBERT_FP32_BOUND = (1e-4, 1.0)
HUBERT_ROWS = 32                  # per clip: 64 positions in all


def check_hubert() -> dict:
    """Phase 5d: hubert-xlarge at full width, random bf16 weights drawn on
    the card, frames ``HUBERT_FRAMES``.  One encoder forward with the
    launch counters set to 0 before and read after: 48 K3 launches, every
    one bidirectional at (80, 80), nothing else; timed, with its peak
    memory.  A second forward holds each K3 call against its plain version
    on its own operands (2e-2), and against the plain version in fp32 on
    the same bf16 operands (``k3_bf16_rel``).  Then in fp32 one forward
    through K3 against one through its plain version at ``HUBERT_ROWS``
    positions of each clip, held at ``HUBERT_FP32_BOUND``; K3's output
    off by ``K5_OFF`` must fail it.  Returns {"launches": K3 launches of
    the counted forward, "ms": its time, "max_abs_err" and "rel": the
    per-call checks' largest errors}."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_plain
    from repro_torch.models import attention
    from repro_torch.models.model import forward, init_params

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(HUBERT)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[5d] {cfg.name}: {cfg.n_params / 1e9:.2f}B params ({cfg.dtype}), "
        f"{cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.resolved_head_dim}, FFN {cfg.d_ff}, {cfg.vocab_size} targets; "
        f"weights {_nbytes(params) / 1e9:.2f} GB (the fp32 head included) "
        f"drawn on the card in {time.perf_counter() - t0:.1f}s")
    B, S = HUBERT_FRAMES
    g = torch.Generator(device="cuda").manual_seed(S)
    frames = torch.randn((B, S, cfg.d_model), generator=g, device="cuda")
    pos = torch.arange(S, device="cuda").expand(B, S)
    counters = kernel_counters()
    forward(params, cfg, frames, pos)             # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()                        # count the main path only
    t0 = time.perf_counter()
    out = forward(params, cfg, frames, pos)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = kernels.launch_counts()
    expect = {k: 0 for k in counts}
    expect["flash_attention"] = cfg.n_layers
    if counts != expect:
        raise AssertionError(f"{cfg.name}: launches {counts} != {expect}")
    if out.logits.shape != (B, S, cfg.vocab_size) \
            or not torch.isfinite(out.logits).all():
        raise AssertionError(f"{cfg.name}: logits {tuple(out.logits.shape)} "
                             "not finite or misshapen")
    log(f"[5d] {cfg.name} bf16 encoder forward over frames ({B}, {S}, "
        f"{cfg.d_model}) ({CARD}): {ms:.1f} ms, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB allocated; "
        f"launches {counters['flash_attention'].launches} K3 (all "
        f"bidirectional at (80, 80)), none of the other kernels: {counts}")
    kernel_fn = attention.flash_attention_bshd
    errs, rels = [], []

    def held(q, k, v, **kw):
        if kw.get("causal", True) or q.shape[-1] != 80:
            raise AssertionError(f"{cfg.name}: a K3 call that is causal or "
                                 f"not at head dim 80: {kw}")
        o = kernel_fn(q, k, v, **kw)
        what = f"{cfg.name} K3 call {len(errs)}"
        errs.append(compare(o, flash_attention_plain(q, k, v, **kw), 2e-2,
                            what))
        rels.append(k3_bf16_rel(o, q, k, v, what, **kw)[0])
        return o

    attention.flash_attention_bshd = held
    try:
        forward(params, cfg, frames, pos, want_logits=False)
    finally:
        attention.flash_attention_bshd = kernel_fn
    if len(errs) != cfg.n_layers:
        raise AssertionError(f"{cfg.name}: {len(errs)} K3 calls held")
    log(f"[5d] {cfg.name}: each of the {len(errs)} K3 calls of a bf16 "
        f"forward against its plain version on its own operands: max abs "
        f"err {max(errs):.3e} (bound 2e-2 + 2e-2 |ref|); against the plain "
        f"version in fp32 on the same bf16 operands: relative L2 error "
        f"{min(rels):.3e} to {max(rels):.3e} (bound {K3_BF16_REL_BOUND}, "
        f"each call's output off by {K5_OFF} failing it)")
    del params, out
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = init_params(cfg32, seed=0, device="cuda")
    rows = torch.linspace(0, S - 1, HUBERT_ROWS, device="cuda").long()

    def logits(fn):
        attention.flash_attention_bshd = fn
        try:
            h = forward(params, cfg32, frames, pos,
                        want_logits=False).hidden[:, rows]
        finally:
            attention.flash_attention_bshd = kernel_fn
        return h.reshape(-1, cfg.d_model).float() @ params["unembed_f32"]

    plain = logits(flash_attention_plain)
    bound = HUBERT_FP32_BOUND
    for what, fn in (("K3", kernel_fn),
                     (f"K3 off by {K5_OFF}",
                      lambda *a, **kw: kernel_fn(*a, **kw) * K5_OFF)):
        lk = logits(fn)
        rel, agree, margins = _paged_vs_dense(lk, plain)
        ok = bool(torch.isfinite(lk).all()) and rel <= bound[0] \
            and agree >= bound[1]
        log(f"[5d] {cfg.name} fp32 forward through {what} against one "
            f"through K3's plain version, {lk.shape[0]} positions: max rel "
            f"logit diff={rel:.3e} argmax agreement={agree:.3f} "
            f"margins={margins} (bound {bound[0]}, {bound[1]:.3f})")
        if ok != (what == "K3"):
            raise AssertionError(f"{cfg.name}: the fp32 forward through "
                                 f"{what} reads rel {rel}, argmax {agree}: "
                                 f"{'outside' if what == 'K3' else 'within'}"
                                 " the bound")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": counts["flash_attention"], "ms": ms,
            "max_abs_err": max(errs), "rel": max(rels)}


# ---------------------------------------------------------------------------
# phase 5e: training at full width
# ---------------------------------------------------------------------------

TRAIN_ARCH = "gemma3-1b"
# the launcher's base steps: gemma3-1b, bf16, 3 steps of (1, 1024) tokens
TRAIN_ARGV = ["--arch", TRAIN_ARCH, "--full-config", "--steps", "3",
              "--batch", "1", "--seq-len", "1024"]
HEADS_BATCH = (2, 512)            # 5e(ii): Hydra++ head steps, B and S
GRAD_CHECK_S = 512                # 5e(iii): the fp32 gradient check, B=1
# 5e(iii)'s bounds on (the loss's relative difference, each draft leaf's
# gradient's relative L2 difference) of a head_train_loss through K3
# against one through its plain version, set from the clean reading
# (NVIDIA H100 80GB HBM3, 700 W): the loss equal bit for bit (its bound is
# 8 fp32 ulps), the gradients 1.77e-6 (the bound 5.6x that); a K3 1% off at
# the prefix layer read 1.50e-6 and 8.67e-3, failing both
GRAD_CHECK_BOUND = (1e-6, 1e-5)
# 5f: EAGLE (K = 4 chain) at minitron-4b, prompts one at a time
EAGLE_ARCH = "minitron-4b"
EAGLE_K = 4
EAGLE_PROMPTS = (600, 900, 1200, 1500)
EAGLE_NEW = 32                    # 5f(i), bf16
EAGLE_NEW_FP32 = 16               # 5f(ii), against autoregressive
NEAR_TIE = 1e-4                   # a top-2 logit gap below it is a near tie


def _counts_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _k3_counts(n: int, n_grad: int) -> dict:
    """K3's launch counts for ``n`` whole-prefill calls, ``n_grad`` of them
    under autograd, each of which also makes one backward call."""
    out = {"flash_attention": n}
    if n_grad:
        out.update({f"flash_attention {c}": n_grad for c in (
            "grad_launches", "bwd_launches")})
    return out


def _expect_counts(what: str, counts: dict, want: dict) -> None:
    """``counts`` (nonzero launch counters) must be exactly ``want``."""
    got = {k: n for k, n in counts.items() if n}
    if got != want:
        raise AssertionError(f"{what}: launches {got} != {want}")


def train_full_width() -> dict:
    """Phase 5e (i)-(iii) at gemma3-1b: the launcher's base steps, Hydra++
    head steps, the fp32 gradient check.  Returns the launch counts."""
    import contextlib
    import io

    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.distill import head_train_loss
    from repro_torch.core.heads import init_draft_params
    from repro_torch.data.synthetic import MarkovSpec, sample_corpus
    from repro_torch.kernels.flash_attention import kernel as k3k
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_plain
    from repro_torch.launch import train
    from repro_torch.models import attention
    from repro_torch.models.model import init_params
    from repro_torch.training import trainer
    from repro_torch.training.optim import init_adamw
    from repro_torch.training.pytree import tree_leaves

    total = {}
    cfg = get_config(TRAIN_ARCH)
    # (i) base training through the launcher's own main
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()                        # count the main path only
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        history = train.main(TRAIN_ARGV)
    counts = kernels.launch_counts()
    for line in out.getvalue().splitlines():
        log(f"[5e] {line}")
    steps = len(history)
    n3 = cfg.n_layers * steps
    _expect_counts(f"5e(i) {cfg.name} base steps", counts,
                   _k3_counts(n3, n3))
    _add(total, counts)
    losses = [loss for loss, _ in history]
    later = [s for _, s in history[1:]]
    step_ms = 1e3 * sum(later) / len(later)
    tokens = 1024
    log(f"[5e] (i) {cfg.name} bf16 base training through the launcher, "
        f"{steps} steps of (1, 1024) ({CARD}): losses {losses}, "
        f"{step_ms:.1f} ms a step after the first, "
        f"{tokens / step_ms * 1e3:.0f} tokens/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB allocated; "
        f"{cfg.n_layers} K3 launches a step, all through the autograd "
        f"wrapper: {counts['flash_attention']} launches, "
        f"{counts['flash_attention grad_launches']} under autograd, "
        f"{counts['flash_attention bwd_launches']} of the backward kernels")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"5e(i): losses {losses} not finite")
    # the same step on a repeated batch at a learning rate that moves
    # bf16 weights: step 0's rate is 0 (the warm-up's first), so the loss
    # must fall from the second step to the third
    gc.collect()
    torch.cuda.empty_cache()
    params = init_params(cfg, seed=0, device="cuda")
    tc = trainer.TrainConfig(peak_lr=1e-3, warmup=1, total_steps=3,
                             log_every=1)
    batch = torch.as_tensor(sample_corpus(
        MarkovSpec(vocab_size=cfg.vocab_size, seed=0), 1, 1024),
        device="cuda")
    kernels.reset_counts()
    rep = []
    step = trainer.make_base_train_step(cfg, tc)
    opt = init_adamw(params)
    for _ in range(3):
        params, opt, m = step(params, opt, batch)
        rep.append(float(m["loss"]))
    counts = kernels.launch_counts()
    _expect_counts("5e(i) repeated batch", counts,
                   _k3_counts(3 * cfg.n_layers, 3 * cfg.n_layers))
    _add(total, counts)
    log(f"[5e] (i) {cfg.name} bf16, one batch repeated, lr 0 then 1e-3 "
        f"then 5e-4: losses {rep}")
    if not (all(math.isfinite(x) for x in rep) and rep[2] < rep[1]):
        raise AssertionError(f"5e(i): losses {rep} do not fall on a "
                             "repeated batch")
    del params, opt, m
    log(f"[5e] (i) {cfg.name} bf16, where a step of (1, 1024) goes "
        f"({CARD}): {_step_breakdown(cfg)}")
    # (ii) Hydra++ head training, the bf16 base frozen
    gc.collect()
    torch.cuda.empty_cache()
    base = init_params(cfg, seed=0, device="cuda")
    dp = init_draft_params(cfg, seed=1, device="cuda")
    snapshot = [p.clone() for p in tree_leaves(base)]
    B, S = HEADS_BATCH
    data = sample_corpus(MarkovSpec(vocab_size=cfg.vocab_size, seed=0),
                         3 * B, S)
    batches = [data[i * B:(i + 1) * B] for i in range(3)]
    stamps = []

    def stamp(line):
        stamps.append(time.perf_counter())        # the line waits for the step
        log(f"[5e] {line}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    t0 = time.perf_counter()
    trainer.train_heads(dp, base, cfg, trainer.TrainConfig(
        total_steps=3, warmup=1, log_every=1), batches, objective="distill",
        log=stamp)
    counts = kernels.launch_counts()
    n_prefix = 1
    _expect_counts(f"5e(ii) {cfg.name} Hydra++ head steps", counts,
                   _k3_counts(3 * (cfg.n_layers + n_prefix), 3 * n_prefix))
    _add(total, counts)
    for a, b in zip(snapshot, tree_leaves(base)):
        if not torch.equal(a, b) or b.grad is not None:
            raise AssertionError("5e(ii): a base param changed or holds a "
                                 "gradient")
    ms = [1e3 * (b - a) for a, b in zip([t0] + stamps, stamps)]
    log(f"[5e] (ii) {cfg.name} Hydra++ heads ({cfg.draft.n_heads} heads, "
        f"{cfg.draft.n_mlp_layers} MLP layers, prefix attention), distill, "
        f"frozen bf16 base, B={B} S={S}, 3 steps of train_heads ({CARD}): "
        f"{ms[1]:.1f} and {ms[2]:.1f} ms a step after the first "
        f"({ms[0]:.1f}), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB allocated; "
        f"{cfg.n_layers + n_prefix} K3 launches a step ({n_prefix} under "
        f"autograd); the base params bitwise unchanged, no .grad")
    del base, dp, snapshot
    # (iii) the fp32 gradient check at full width
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    base = init_params(cfg32, seed=0, device="cuda")
    dp = init_draft_params(cfg32, seed=1, device="cuda")
    toks = torch.as_tensor(sample_corpus(
        MarkovSpec(vocab_size=cfg.vocab_size, seed=0), 1, GRAD_CHECK_S,
        seed=2), device="cuda")
    kernel_fn = attention.flash_attention_bshd
    launch_bwd = k3k.launch_bwd

    def off_at_prefix(*a, **kw):      # the prefix layer is the grad call
        o = kernel_fn(*a, **kw)
        return o * K5_OFF if torch.is_grad_enabled() else o

    def dk_off(*a, **kw):             # the backward's dk, odd channels
        rc = launch_bwd(*a, **kw)
        a[7][..., 1::2] *= K5_OFF
        return rc

    def run(fn, bwd=launch_bwd):
        attention.flash_attention_bshd = fn
        k3k.launch_bwd = bwd
        try:
            loss, _, grads = trainer.value_and_grad(
                lambda d: head_train_loss(d, base, cfg32, toks,
                                          objective="distill"), dp)
        finally:
            attention.flash_attention_bshd = kernel_fn
            k3k.launch_bwd = launch_bwd
        return float(loss), tree_leaves(grads)

    before = dict(kernels.launch_counts())
    ref_loss, ref_grads = run(flash_attention_plain)
    for what, fn, bwd in (
            ("K3", kernel_fn, launch_bwd),
            (f"K3 off by {K5_OFF} at the prefix layer", off_at_prefix,
             launch_bwd),
            (f"K3 with its backward's dk off by {K5_OFF} on the odd "
             "channels", kernel_fn, dk_off)):
        loss, grads = run(fn, bwd)
        lrel = abs(loss - ref_loss) / abs(ref_loss)
        grel = max(rel_l2(a, b) for a, b in zip(grads, ref_grads))
        ok = lrel <= GRAD_CHECK_BOUND[0] and grel <= GRAD_CHECK_BOUND[1]
        log(f"[5e] (iii) {cfg.name} fp32 head_train_loss (distill, B=1, "
            f"S={GRAD_CHECK_S}) through {what} against one through K3's "
            f"plain version: loss rel diff {lrel:.3e}, largest draft-leaf "
            f"gradient rel L2 diff {grel:.3e} over {len(grads)} leaves "
            f"(bounds {GRAD_CHECK_BOUND[0]}, {GRAD_CHECK_BOUND[1]})")
        if ok != (what == "K3"):
            raise AssertionError(f"5e(iii): {what} reads loss {lrel}, "
                                 f"grads {grel}: "
                                 f"{'outside' if what == 'K3' else 'within'}"
                                 " the bounds")
    _add(total, _counts_delta(before, kernels.launch_counts()))
    del base, dp
    gc.collect()
    torch.cuda.empty_cache()
    return total


def _mean_accept(toks_acc) -> float:
    return float(toks_acc.float().mean())


def _stream(row, n: int) -> list:
    from repro_torch.core.speculative import PAD_TOKEN

    return [int(x) for x in row.tolist() if x != PAD_TOKEN][:n]


def _load_example(name: str = "torch_train_hydra_pp",
                  folder: str = "examples"):
    """``<folder>/<name>.py`` of the repository as a module."""
    import importlib.util

    path = SRC.parent / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def train_tiny_end_to_end() -> dict:
    """Phase 5e(iv) and 5f(iii): vicuna-tiny in fp32 through
    ``scripts/torch_train_tiny.py``'s recipe (``tiny.train_tiny``: the
    base, Medusa and Hydra heads, their checkpoints), the checkpoints
    restored bitwise, the example's three variants on the same base, the
    trained Hydra heads served, and an EAGLE layer.  Returns the launch
    counts."""
    import contextlib
    import io
    import shutil
    import tempfile

    import torch
    from repro_torch import kernels
    from repro_torch.core import tree_search
    from repro_torch.core.eagle import (eagle_spec_step, eagle_train_loss,
                                        init_eagle_decode_state,
                                        init_eagle_params)
    from repro_torch.core.heads import init_draft_params
    from repro_torch.core.speculative import generate
    from repro_torch.core.trees import chain_tree, default_tree
    from repro_torch.models.model import add_unembed_f32, init_params
    from repro_torch.serving.engine import PagedSpeculativeEngine, Request
    from repro_torch.training import tiny, trainer
    from repro_torch.training.checkpoint import load_checkpoint
    from repro_torch.training.optim import init_adamw
    from repro_torch.training.pytree import tree_leaves

    total = {}
    train_steps, n_new = tiny.TINY_STEPS, tiny.TINY_NEW
    before = dict(kernels.launch_counts())
    # scripts/torch_train_tiny.py's recipe (training/tiny.py::train_tiny)
    # into a directory of its own: the 300-step base and Medusa and Hydra
    # heads, checkpointed, each one's acceptance length
    (SRC.parent / "build").mkdir(exist_ok=True)
    ckdir = Path(tempfile.mkdtemp(dir=SRC.parent / "build"))
    run = tiny.train_tiny(train_steps, ckpt_dir=str(ckdir), device="cuda",
                          log=lambda s: log(f"[5e] {s}"))
    cfg, pipe = run.cfg, tiny.tiny_pipeline(run.cfg)
    tree = default_tree(*tiny.TINY_TREE)
    B, P = tiny.TINY_PROMPTS
    prompts = torch.as_tensor(pipe.eval_batch(B)[:, :P], device="cuda").long()
    drafts = {kind: dataclasses.replace(
        cfg, draft=tiny.DRAFT_VARIANTS[kind][0]) for kind in tiny.TINY_KINDS}
    untrained = {}
    for kind, ck in drafts.items():
        _, _, acc0 = generate(run.params, init_draft_params(
            ck, seed=1, device="cuda"), ck, tree, prompts,
            max_new_tokens=n_new, max_len=512)
        untrained[kind] = _mean_accept(acc0)
    log(f"[5e] (iv) scripts/torch_train_tiny.py's recipe, vicuna-tiny fp32 "
        f"({CARD}): {train_steps} base steps in {run.seconds['base']:.1f}s, "
        + ", ".join(f"{train_steps} {k} head steps in {run.seconds[k]:.1f}s"
                    for k in tiny.TINY_KINDS)
        + "; acceptance length (4 prompts of 32, 48 new tokens, "
        "default_tree(16, 4, 4), greedy) "
        + ", ".join(f"{k} {a:.3f} (steps {n}; untrained heads "
                    f"{untrained[k]:.3f})" for k, (a, n) in run.accept.items())
        + "; order " + " > ".join(sorted(run.accept,
                                         key=lambda k: -run.accept[k][0]))
        + " (the paper's Fig. 2: hydra > medusa; a reading)")
    if not all(run.accept[k][0] > untrained[k] for k in run.accept):
        raise AssertionError(f"5e(iv): train_tiny's heads {run.accept} do "
                             f"not beat the untrained heads' {untrained}")
    # its checkpoints, loaded into fresh params, equal the trees it trained
    c2 = drafts["hydra"]
    params2 = add_unembed_f32(load_checkpoint(
        str(ckdir / "base_tiny"), init_params(cfg, seed=5, device="cuda")),
        cfg)
    restored = {kind: load_checkpoint(
        str(ckdir / f"heads_{kind}_tiny"),
        init_draft_params(ck, seed=6, device="cuda"))
        for kind, ck in drafts.items()}
    for a, b in zip(tree_leaves(run.params) + sum(
            (tree_leaves(run.drafts[k]) for k in drafts), []),
            tree_leaves(params2) + sum(
                (tree_leaves(restored[k]) for k in drafts), [])):
        if not torch.equal(a, b):
            raise AssertionError("5e(iv): a checkpointed leaf came back "
                                 "changed")
    dp2 = restored["hydra"]
    # the paper's three variants through the port's example, on the base
    # checkpoint train_tiny saved (the example's CKPT points at a copy of
    # it under the name the example reads)
    shutil.copytree(ckdir / "base_tiny", ckdir / "base")
    example = _load_example()
    example.CKPT = str(ckdir)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rows = example.main(["--device", "cuda"])
    t_variants = time.perf_counter() - t0
    for line in out.getvalue().splitlines():
        if not line.startswith(("[base", "[heads")):
            log(f"[5e] {line}")
    shutil.rmtree(ckdir)
    order = " > ".join(sorted(rows, key=lambda k: -rows[k][0]))
    log(f"[5e] (iv) examples/torch_train_hydra_pp.py on the same base "
        f"({CARD}): three variants trained {train_steps} steps each in "
        f"{t_variants:.1f}s; mean accepted length "
        + ", ".join(f"{k} {a:.3f}" for k, (a, _) in rows.items())
        + f" (untrained hydra heads {untrained['hydra']:.3f}); order {order} "
        "(the paper's Fig. 2: hydra++ > hydra > medusa; a reading)")
    if "base: restored from checkpoint" not in out.getvalue():
        raise AssertionError("5e(iv): the example did not restore the base "
                             "checkpoint")
    if not all(a > untrained["hydra"] for a, _ in rows.values()):
        raise AssertionError(f"5e(iv): a trained variant {rows} does not "
                             f"beat the untrained heads' "
                             f"{untrained['hydra']:.3f}")
    toks, steps, acc = generate(params2, dp2, c2, tree, prompts,
                                max_new_tokens=n_new, max_len=512)
    want = [_stream(toks[b], n_new) for b in range(B)]
    reqs = [Request(prompt=prompts[b].cpu().numpy().astype("int32"),
                    max_new_tokens=n_new) for b in range(B)]
    eng = PagedSpeculativeEngine(params2, dp2, c2, tree, max_len=512)
    st = eng.serve(reqs, max_batch=B)
    for b, r in enumerate(reqs):
        if r.output != want[b]:
            raise AssertionError(f"5e(iv): paged engine {r.output} != "
                                 f"generate() {want[b]}")
    _, _, acc_chain = generate(params2, dp2, c2, chain_tree(EAGLE_K),
                               prompts, max_new_tokens=n_new, max_len=512)
    log(f"[5e] (iv) checkpoints saved and loaded bitwise; {B} eval prompts "
        f"of {P}, {n_new} new tokens, default_tree(16, 4, 4), greedy: "
        f"generate() == the paged engine; mean accepted length "
        f"{_mean_accept(acc):.3f} trained ({untrained['hydra']:.3f} "
        f"untrained heads), chain of {EAGLE_K}: "
        f"{_mean_accept(acc_chain):.3f}; engine tokens/step "
        f"{st.tokens_per_step:.3f}")
    rank_acc = tree_search.measure_rank_acc(
        params2, dp2, c2, torch.as_tensor(pipe.eval_batch(), device="cuda"))
    trees = tree_search.grow_trees(rank_acc, n_max=64)
    best = tree_search.select_tree(trees, rank_acc)
    log(f"[5e] (iv) tree search: rank-0 acceptance per head "
        f"{[round(float(x), 3) for x in rank_acc[:, 0]]}; {len(trees)} "
        f"nested trees; chosen tree of {best.size} nodes, expected accepted "
        f"length {tree_search.expected_accept_length(best, rank_acc):.3f}")
    # 5f(iii): an EAGLE layer on the same base, as bench_fig10_eagle.py
    # trains it
    ep = init_eagle_params(cfg, seed=9, device="cuda")
    opt = init_adamw(ep)
    etc = trainer.TrainConfig(peak_lr=1e-3, warmup=30,
                              total_steps=train_steps)
    t0 = time.perf_counter()
    for i, batch in enumerate(pipe.train_batches(train_steps)):
        batch = torch.as_tensor(batch, device="cuda")
        _, em, grads = trainer.value_and_grad(
            lambda e: eagle_train_loss(e, params2, cfg, batch), ep)
        ep, opt, _ = trainer.apply_update(grads, opt, ep, etc)
        if i % 100 == 0 or i == train_steps - 1:
            log(f"[5f] eagle {i}: loss={float(em['loss']):.3f} "
                f"acc={float(em['acc']):.3f}")
    t_eagle = time.perf_counter() - t0
    state = init_eagle_decode_state(params2, ep, cfg, prompts, 512)
    produced, n_steps, acc_sum = 1, 0, 0.0
    while produced < n_new:
        res = eagle_spec_step(params2, ep, cfg, EAGLE_K, state)
        state = res.state
        produced += int(res.n_emitted.min())
        acc_sum += float(res.n_emitted.float().mean())
        n_steps += 1
    log(f"[5f] (iii) vicuna-tiny EAGLE layer trained {train_steps} steps in "
        f"{t_eagle:.1f}s ({CARD}); mean accepted length (chain of "
        f"{EAGLE_K}, greedy, the same {B} prompts): EAGLE "
        f"{acc_sum / n_steps:.3f} vs trained Hydra heads "
        f"{_mean_accept(acc_chain):.3f} on the chain, "
        f"{_mean_accept(acc):.3f} on default_tree(16, 4, 4) (paper Fig. 10, "
        f"a reading)")
    _add(total, _counts_delta(before, kernels.launch_counts()))
    del run, params2, dp2, restored, ep
    gc.collect()
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phase 5h: the port's serving examples on the card
# ---------------------------------------------------------------------------

EXAMPLES_CKPT = SRC.parent / "build" / "ckpt_examples"


def run_examples() -> dict:
    """Phase 5h: quickstart, serve_spec and tree_search through their own
    ``main`` at their default steps, the checkpoints of ``training/
    tiny.py`` in a fresh directory; returns the launch counts."""
    import contextlib
    import io
    import shutil

    from repro_torch import kernels
    from repro_torch.training import tiny

    shutil.rmtree(EXAMPLES_CKPT, ignore_errors=True)
    tiny.CKPT_DIR = str(EXAMPLES_CKPT)
    kernels.reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        qs = _load_example("torch_quickstart").main([])
    log(f"[5h] examples/torch_quickstart.py ({CARD}): 150 base and 150 "
        f"Hydra head steps, then 48 new tokens for 2 prompts: "
        f"accept_len={qs['accept_len']:.3f}, speculative "
        f"{qs['spec_steps']} steps against autoregressive "
        f"{qs['ar_steps']} ({qs['ar_steps'] / max(qs['spec_steps'], 1):.2f}x "
        f"fewer), greedy outputs identical: {qs['same']}; "
        f"{time.perf_counter() - t0:.1f}s")
    if not qs["same"] or qs["spec_steps"] >= qs["ar_steps"]:
        raise AssertionError(f"quickstart: {qs}")
    t0 = time.perf_counter()
    buf = io.StringIO()
    mod = _load_example("torch_serve_spec")
    with contextlib.redirect_stdout(buf):
        runs = mod.main([])
    for line in buf.getvalue().splitlines():
        if " steps=" in line or "greedy streams" in line:
            log(f"[5h] {line}")
    for m in mod.MODES:
        base = runs[(m, "continuous")][1]
        for e in mod.ENGINES:
            if runs[(m, e)][1] != base:
                raise AssertionError(f"serve_spec {m}: the {e} engine's "
                                     "greedy streams differ from the "
                                     "continuous engine's")
            if runs[(m, e)][0].tokens <= 0:
                raise AssertionError(f"serve_spec {m} {e}: no token")
    log(f"[5h] examples/torch_serve_spec.py ({CARD}): the three engines' "
        f"greedy streams equal in each of {mod.MODES}; "
        f"{time.perf_counter() - t0:.1f}s with training")
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ts = _load_example("torch_tree_search").main([])
    if "heads_hydra_data: restored from checkpoint" not in buf.getvalue():
        raise AssertionError("tree_search retrained the heads")
    log(f"[5h] examples/torch_tree_search.py ({CARD}): tok/s per tree "
        + ", ".join(f"T={n}: {v:.1f} (accept {ts['accept'][n]:.2f})"
                    for n, v in ts["tok_s"].items())
        + f"; selected tree size {ts['selected']} (checkpoints restored); "
        f"{time.perf_counter() - t0:.1f}s")
    counts = kernels.launch_counts()
    log(f"[5h] launches of the three examples: "
        f"{ {k: v for k, v in counts.items() if v} }")
    return counts


# ---------------------------------------------------------------------------
# phase 5g: base training of the recurrent and MoE archs
# ---------------------------------------------------------------------------

# (i)-(ii): the launcher's base steps at full depth, bf16, 3 steps of
# (1, 1024) tokens
RECURRENT_TRAIN = ("rwkv6-1.6b", ZAMBA2)
# (iii): both DeepSeek MoE archs at full width, cut to 2 layers (the dense
# first layer and one MoE layer, ~1.0B params): at full depth 16B params
# and their fp32 AdamW moments need ~250 GB
MOE_TRAIN = ("deepseek-v2-lite-16b", "deepseek-moe-16b")
MOE_TRAIN_LAYERS = 2
TRAIN_TOKENS = (1, 1024)
# (iv): the fp32 gradient check through K6: rwkv6-1.6b at full width, 2
# layers, B=1, S=500 (not a chunk multiple: the tail pad runs)
K6_GRAD_LAYERS = 2
K6_GRAD_S = 500
# (iv)'s bounds on (the loss's relative difference, each base leaf's
# gradient's relative L2 difference) of an lm_loss through K6 against one
# through its plain version, set from the clean reading (NVIDIA H100 80GB
# HBM3, 700 W): the loss equal bit for bit, the gradients 5.44e-6 (the
# bound 5.5x that); K6 with its odd output channels 1% off read 1.34e-5
# and 2.03e-2, failing both
K6_GRAD_BOUND = (1e-6, 3e-5)


def k6_grad_setup():
    """(iv)'s model and data: rwkv6-1.6b in fp32 at ``K6_GRAD_LAYERS``
    layers, its weights from seed 0, one sequence of ``K6_GRAD_S`` tokens.
    Returns (cfg, params, step), ``step()`` the loss and its gradient by
    ``trainer.value_and_grad`` of ``lm_loss``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.distill import lm_loss
    from repro_torch.data.synthetic import MarkovSpec, sample_corpus
    from repro_torch.models.model import init_params
    from repro_torch.training import trainer

    cfg = dataclasses.replace(get_config("rwkv6-1.6b"), dtype="float32",
                              n_layers=K6_GRAD_LAYERS)
    params = init_params(cfg, seed=0, device="cuda")
    toks = torch.as_tensor(sample_corpus(
        MarkovSpec(vocab_size=cfg.vocab_size, seed=0), 1, K6_GRAD_S,
        seed=2), device="cuda")
    return cfg, params, lambda: trainer.value_and_grad(
        lambda p: lm_loss(p, cfg, toks), params)
# K3's launches in 5g by arch and build, for the JSON line
K3_BUILDS_5G = {ZAMBA2: "(64, 64)", "deepseek-v2-lite-16b": "(192, 128)",
                "deepseek-moe-16b": "(128, 128)"}
K3_LAUNCHES_5G = {}


def _train_launches(cfg, steps: int) -> dict:
    """The kernel launches ``steps`` base steps of ``cfg`` must make, every
    one under autograd: K6 (and its scan) a layer at RWKV6, K3 a shared-
    block invocation at zamba2, K3 an attention layer otherwise; each of
    them also makes one backward call (K6's reducing u's gradient too)."""
    from repro_torch.models.model import group_program

    if cfg.block_kind == "rwkv6":
        n = cfg.n_layers * steps
        return {f"linear_attn_chunk{c}": n for c in (
            "", " scan_launches", " grad_launches", " bwd_launches",
            " bwd_du_launches")}
    n = steps * sum(n for kind, n in group_program(cfg)
                    if kind.startswith("attn_stack") or kind == "shared_attn")
    return _k3_counts(n, n)


def _step_line(what: str, steps_s: list, peak_gib: float) -> str:
    later = steps_s[1:] or steps_s
    step_ms = 1e3 * sum(later) / len(later)
    tokens = TRAIN_TOKENS[0] * TRAIN_TOKENS[1]
    return (f"{what}, {len(steps_s)} steps of {TRAIN_TOKENS} ({CARD}): "
            f"{step_ms:.1f} ms a step after the first, "
            f"{tokens / step_ms * 1e3:.0f} tokens/s, peak memory "
            f"{peak_gib:.2f} GiB allocated")


def _repeated_batch(cfg, total: dict) -> list:
    """Three base steps on one batch at learning rates 0, 1e-3 and 5e-4:
    the loss must fall from the second step to the third."""
    import torch
    from repro_torch import kernels
    from repro_torch.data.synthetic import MarkovSpec, sample_corpus
    from repro_torch.models.model import init_params
    from repro_torch.training import trainer
    from repro_torch.training.optim import init_adamw

    gc.collect()
    torch.cuda.empty_cache()
    params = init_params(cfg, seed=0, device="cuda")
    tc = trainer.TrainConfig(peak_lr=1e-3, warmup=1, total_steps=3,
                             log_every=1)
    batch = torch.as_tensor(sample_corpus(
        MarkovSpec(vocab_size=cfg.vocab_size, seed=0), *TRAIN_TOKENS),
        device="cuda")
    step = trainer.make_base_train_step(cfg, tc)
    opt = init_adamw(params)
    kernels.reset_counts()
    rep = []
    for _ in range(3):
        params, opt, m = step(params, opt, batch)
        rep.append(float(m["loss"]))
    counts = kernels.launch_counts()
    _expect_counts(f"5g {cfg.name} repeated batch", counts,
                   _train_launches(cfg, 3))
    _add(total, counts)
    _add(K3_LAUNCHES_5G, {cfg.name: counts.get("flash_attention", 0)})
    if not (all(math.isfinite(x) for x in rep) and rep[2] < rep[1]):
        raise AssertionError(f"5g {cfg.name}: losses {rep} do not fall on a "
                             "repeated batch")
    del params, opt, m
    return rep


def _step_breakdown(cfg) -> str:
    """``step_numbers`` as one line."""
    n = step_numbers(cfg)
    return (f"forward {n['forward_ms']:.1f} ms, backward "
            f"{n['backward_ms']:.1f} ms (of it {n['kernel']}'s autograd "
            f"backward {n['wrapper_bwd_ms']:.1f} ms wall over "
            f"{n['wrapper_bwd_calls']} calls), update {n['update_ms']:.1f} "
            f"ms; one untraced step {n['untraced_ms']:.1f} ms; one traced "
            f"step: device busy {n['busy_ms']:.1f} ms, of it the backward "
            f"kernels {n['bwd_kernels_ms']:.1f} ms ({n['traced_ms']:.1f} ms "
            f"wall traced), idle share {n['idle']:.1%} against the untraced "
            "step")


def step_numbers(cfg) -> dict:
    """Where one base step's time goes (a repeated batch, after a warm-up
    step): the forward, the backward and, inside it, the kernel wrapper's
    autograd backward calls (K6's at RWKV6, K3's otherwise: the backward
    kernels and their allocations; CUDA-synchronised wall times), the
    update; then the wall time of one untraced step, and the device busy
    time over one traced step, with the backward kernels' share of it
    (every CUDA kernel whose name holds ``_bwd_``), whose idle share is
    taken against the untraced step's wall time (the profiler slows the
    host)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.distill import lm_loss
    from repro_torch.data.synthetic import MarkovSpec, sample_corpus
    from repro_torch.kernels.flash_attention import ops as k3
    from repro_torch.kernels.linear_attn_chunk import ops as k6
    from repro_torch.models.model import init_params, refresh_unembed_f32
    from repro_torch.training import trainer
    from repro_torch.training.optim import init_adamw
    from repro_torch.training.pytree import tree_leaves, tree_unflatten

    fn_cls, kernel = ((k6.LinearAttnChunk, "K6") if cfg.block_kind == "rwkv6"
                      else (k3.FlashAttention, "K3"))
    gc.collect()
    torch.cuda.empty_cache()
    params = init_params(cfg, seed=0, device="cuda")
    opt = init_adamw(params)
    tc = trainer.TrainConfig(peak_lr=1e-3, warmup=1, total_steps=3)
    batch = torch.as_tensor(sample_corpus(
        MarkovSpec(vocab_size=cfg.vocab_size, seed=0), *TRAIN_TOKENS),
        device="cuda")
    step = trainer.make_base_train_step(cfg, tc)
    params, opt, _ = step(params, opt, batch)               # warm-up
    bwd_s = []
    backward = fn_cls.backward

    def timed(ctx, *grads):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = backward(ctx, *grads)
        torch.cuda.synchronize()
        bwd_s.append(time.perf_counter() - t)
        return out

    leaves = tree_leaves(params)
    stamps = [time.perf_counter()]
    fn_cls.backward = staticmethod(timed)
    try:
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss, _ = lm_loss(params, cfg, batch)
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            grads = torch.autograd.grad(loss, leaves)
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
    finally:
        fn_cls.backward = backward
        for p in leaves:
            p.requires_grad_(False)
    params, opt, _ = trainer.apply_update(tree_unflatten(params, list(grads)),
                                          opt, params, tc)
    refresh_unembed_f32(params, cfg)
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    del grads, loss
    t = time.perf_counter()
    params, opt, _ = step(params, opt, batch)
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    busy = bwd_dev = 0.0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            busy += 1e-9 * e.duration_ns()
            if "_bwd_" in e.name():
                bwd_dev += 1e-9 * e.duration_ns()
    ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    del params, opt, m
    return {"kernel": kernel, "forward_ms": ms[0], "backward_ms": ms[1],
            "wrapper_bwd_ms": 1e3 * sum(bwd_s),
            "wrapper_bwd_calls": len(bwd_s), "update_ms": ms[2],
            "untraced_ms": 1e3 * untraced, "busy_ms": 1e3 * busy,
            "bwd_kernels_ms": 1e3 * bwd_dev, "traced_ms": 1e3 * wall,
            "idle": 1 - busy / untraced}


def train_recurrent_and_moe() -> dict:
    """Phase 5g: rwkv6-1.6b and zamba2-1.2b at full depth through the
    train launcher, both DeepSeek MoE archs at 2 layers through
    ``make_train_step``, the fp32 gradient check through K6.  Returns the
    launch counts."""
    import contextlib
    import io

    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels.linear_attn_chunk import kernel as k6k
    from repro_torch.kernels.linear_attn_chunk.ref import \
        decay_attention_chunked
    from repro_torch.launch import train
    from repro_torch.models import ssm
    from repro_torch.models.model import init_params
    from repro_torch.training.optim import init_adamw
    from repro_torch.training.pytree import tree_leaves

    total = {}
    # (i)-(ii) the launcher's own main at full depth
    for arch in RECURRENT_TRAIN:
        cfg = get_config(arch)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()                    # count the main path only
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            history = train.main(["--arch", arch, "--full-config", "--steps",
                                  "3", "--batch", str(TRAIN_TOKENS[0]),
                                  "--seq-len", str(TRAIN_TOKENS[1])])
        counts = kernels.launch_counts()
        for line in out.getvalue().splitlines():
            log(f"[5g] {line}")
        want = _train_launches(cfg, len(history))
        _expect_counts(f"5g {arch} base steps", counts, want)
        _add(total, counts)
        _add(K3_LAUNCHES_5G, {arch: counts.get("flash_attention", 0)})
        losses = [loss for loss, _ in history]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"5g {arch}: losses {losses} not finite")
        per_step = {k: n // len(history) for k, n in want.items()}
        what = (f"{arch} bf16 base training through the launcher at full "
                f"depth ({cfg.n_layers} layers)")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[5g] {_step_line(what, [s for _, s in history], peak)}; "
            f"losses {losses}; launches a step {per_step}, all under "
            "autograd")
        rep = _repeated_batch(cfg, total)
        log(f"[5g] {arch} bf16, one batch repeated, lr 0 then 1e-3 then "
            f"5e-4: losses {rep}")
        if cfg.block_kind == "rwkv6":
            log(f"[5g] {arch} bf16, where a step of {TRAIN_TOKENS} goes "
                f"({CARD}): {_step_breakdown(cfg)}")
    # (iii) the MoE archs at 2 layers through make_train_step
    for arch in MOE_TRAIN:
        cfg = dataclasses.replace(get_config(arch), n_layers=MOE_TRAIN_LAYERS)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, seed=0, device="cuda")
        n_params = sum(p.numel() for p in tree_leaves(params))
        opt = init_adamw(params)
        step = train.make_train_step(cfg)
        batches = train.make_batches(cfg, *TRAIN_TOKENS, 3, "cuda")
        kernels.reset_counts()
        losses, auxes, secs = [], [], []
        for batch in batches:
            ts = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))           # waits for the step
            secs.append(time.perf_counter() - ts)
            auxes.append(float(m["aux"]))
        counts = kernels.launch_counts()
        _expect_counts(f"5g {arch} base steps", counts,
                       _train_launches(cfg, len(batches)))
        _add(total, counts)
        _add(K3_LAUNCHES_5G, {arch: counts["flash_attention"]})
        what = (f"{arch} bf16 base training at full width, "
                f"{MOE_TRAIN_LAYERS} layers ({n_params / 1e9:.2f}B params)")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[5g] {_step_line(what, secs, peak)}; "
            f"losses {losses}; router aux {auxes}; "
            f"{counts['flash_attention'] // len(batches)} K3 launches a step,"
            " all under autograd")
        if not (all(math.isfinite(x) for x in losses)
                and all(math.isfinite(a) and a > 0 for a in auxes)):
            raise AssertionError(f"5g {arch}: losses {losses}, aux {auxes}: "
                                 "not finite, or an aux not above 0")
        del params, opt, m
    # (iv) the fp32 gradient check through K6
    gc.collect()
    torch.cuda.empty_cache()
    cfg32, params, step = k6_grad_setup()
    kernel_fn = ssm.linear_attn_bshd
    launch_bwd = k6k.launch_bwd

    def dk_off(*a, **kw):             # the backward's dk, odd channels
        rc = launch_bwd(*a, **kw)
        a[9][..., 1::2] *= K5_OFF
        return rc

    def plain(r, k, v, w_log, u=None, initial_state=None, *, chunk=64):
        return decay_attention_chunked(r, k, v, w_log, u, initial_state,
                                       chunk=chunk)

    def off(*a, **kw):
        # GroupNorm normalises each head per token, so a uniform scale of
        # the output would cancel: scale the odd channels alone
        o, st = kernel_fn(*a, **kw)
        scale = torch.ones(o.shape[-1], device=o.device)
        scale[1::2] = K5_OFF
        return o * scale, st

    def run(fn, bwd=launch_bwd):
        ssm.linear_attn_bshd = fn
        k6k.launch_bwd = bwd
        try:
            loss, _, grads = step()
        finally:
            ssm.linear_attn_bshd = kernel_fn
            k6k.launch_bwd = launch_bwd
        return float(loss), tree_leaves(grads)

    before = dict(kernels.launch_counts())
    ref_loss, ref_grads = run(plain)
    for what, fn, bwd in (
            ("K6", kernel_fn, launch_bwd),
            (f"K6 with its odd output channels off by {K5_OFF}", off,
             launch_bwd),
            (f"K6 with its backward's dk off by {K5_OFF} on the odd "
             "channels", kernel_fn, dk_off)):
        loss, grads = run(fn, bwd)
        lrel = abs(loss - ref_loss) / abs(ref_loss)
        grel = max(rel_l2(a, b) for a, b in zip(grads, ref_grads)
                   if float(torch.linalg.vector_norm(b.float())) > 0)
        ok = lrel <= K6_GRAD_BOUND[0] and grel <= K6_GRAD_BOUND[1]
        log(f"[5g] (iv) rwkv6-1.6b fp32 lm_loss ({K6_GRAD_LAYERS} layers, "
            f"B=1, S={K6_GRAD_S}) through {what} against one through K6's "
            f"plain version: loss rel diff {lrel:.3e}, largest base-leaf "
            f"gradient rel L2 diff {grel:.3e} over {len(grads)} leaves "
            f"(bounds {K6_GRAD_BOUND[0]}, {K6_GRAD_BOUND[1]})")
        if ok != (what == "K6"):
            where = "outside" if what == "K6" else "within"
            raise AssertionError(f"5g(iv): {what} reads loss {lrel}, grads "
                                 f"{grel}: {where} the bounds")
    counts = _counts_delta(before, kernels.launch_counts())
    n = 3 * K6_GRAD_LAYERS                # three runs through the kernel
    if any(counts.get(f"linear_attn_chunk {c}") != n for c in (
            "grad_launches", "bwd_launches")):
        raise AssertionError(f"5g(iv): launches {counts}: K6 and its "
                             "backward were not launched under autograd "
                             "in each layer of each run")
    _add(total, counts)
    del params, step
    gc.collect()
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phase 5f: EAGLE at full width
# ---------------------------------------------------------------------------


def _top2_gap(params, cfg, context) -> float:
    """The top-2 logit gap of the next token after ``context`` (1-d)."""
    import torch
    from repro_torch.models.model import forward

    with torch.no_grad():
        out = forward(params, cfg, context[None],
                      torch.arange(context.shape[0], device="cuda")[None],
                      want_logits=False)
        lg = out.hidden[0, -1].float() @ params["unembed_f32"]
    top = torch.topk(lg, 2).values
    return float(top[0] - top[1])


def eagle_full_width() -> dict:
    """Phase 5f (i)-(ii) at minitron-4b.  Returns the launch counts."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.eagle import (eagle_spec_step,
                                        init_eagle_decode_state,
                                        init_eagle_params)
    from repro_torch.core.speculative import generate
    from repro_torch.core.trees import chain_tree
    from repro_torch.kernels.tree_attention.kernel import \
        tree_attention_dense_plain
    from repro_torch.models import attention
    from repro_torch.models.model import init_params

    total = {}
    cfg = get_config(EAGLE_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    params = init_params(cfg, seed=0, device="cuda")
    ep = init_eagle_params(cfg, seed=9, device="cuda")
    rs = np.random.RandomState(0)
    prompts = [torch.as_tensor(rs.randint(0, cfg.vocab_size, P),
                               device="cuda").long() for P in EAGLE_PROMPTS]
    kernel_fn = attention.tree_attention_bshd
    errs = []

    def held(*a, **kw):
        o = kernel_fn(*a, **kw)
        errs.append(compare(o, tree_attention_dense_plain(*a), 2e-2,
                            f"5f K2 call {len(errs)}"))
        return o

    per_step = cfg.n_layers + EAGLE_K + 1
    step_s, step_tok = [], []
    for prompt in prompts:
        P = prompt.shape[0]
        kernels.reset_counts()                    # count the main path only
        state = init_eagle_decode_state(params, ep, cfg, prompt[None],
                                        P + 2 * EAGLE_NEW)
        counts = kernels.launch_counts()
        _expect_counts(f"5f(i) prefill of {P}", counts,
                       {"flash_attention": cfg.n_layers + 1})
        _add(total, counts)
        produced, i = 1, 0
        while produced < EAGLE_NEW:
            kernels.reset_counts()
            if i == 0:
                attention.tree_attention_bshd = held
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                res = eagle_spec_step(params, ep, cfg, EAGLE_K, state)
                n = int(res.n_emitted.min())
            finally:
                attention.tree_attention_bshd = kernel_fn
            dt = time.perf_counter() - t0
            counts = kernels.launch_counts()
            _expect_counts(f"5f(i) step {i} at {P}", counts, {
                "tree_attention_dense": per_step,
                "tree_attention_dense merge_launches": per_step})
            _add(total, counts)
            if i > 0:                             # the first held its checks
                step_s.append(dt)
                step_tok.append(int(res.n_emitted.sum()))
            produced += n
            state = res.state
            i += 1
        if not torch.isfinite(state.last_hidden.float()).all():
            raise AssertionError("5f(i): hidden state not finite")
    if len(errs) != len(prompts) * per_step:
        raise AssertionError(f"5f(i): {len(errs)} K2 calls held")
    ms = 1e3 * sum(step_s) / len(step_s)
    log(f"[5f] (i) {cfg.name} bf16 EAGLE (K={EAGLE_K}) on prompts of "
        f"{EAGLE_PROMPTS} tokens, one at a time ({CARD}): "
        f"{cfg.n_layers + 1} K3 launches a prefill, {per_step} K2 a step "
        f"({cfg.n_layers} verify, {EAGLE_K} draft, 1 rebuild) and as many "
        f"merges; each K2 call of each prompt's first step against its "
        f"plain version: max abs err {max(errs):.3e} (2e-2); "
        f"{ms:.2f} ms a step (B=1), {sum(step_tok) / sum(step_s):.1f} "
        f"tokens/s over the {len(step_s)} steps after each prompt's first")
    del params, ep
    gc.collect()
    torch.cuda.empty_cache()
    # (ii) fp32: the EAGLE greedy stream equals the autoregressive one
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = init_params(cfg32, seed=0, device="cuda")
    ep = init_eagle_params(cfg32, seed=9, device="cuda")
    before = dict(kernels.launch_counts())
    ties = []
    for prompt in prompts:
        P = prompt.shape[0]
        state = init_eagle_decode_state(params, ep, cfg32, prompt[None],
                                        P + 2 * EAGLE_NEW_FP32)
        got = [int(state.last_token[0])]
        while len(got) < EAGLE_NEW_FP32:
            res = eagle_spec_step(params, ep, cfg32, EAGLE_K, state)
            got += _stream(res.emitted[0], int(res.n_emitted[0]))
            state = res.state
        got = got[:EAGLE_NEW_FP32]
        ar, _, _ = generate(params, None, cfg32, chain_tree(EAGLE_K),
                            prompt[None], max_new_tokens=EAGLE_NEW_FP32,
                            max_len=P + 2 * EAGLE_NEW_FP32,
                            use_speculative=False)
        want = _stream(ar[0], EAGLE_NEW_FP32)
        if got != want:
            k = next(j for j, (x, y) in enumerate(zip(got, want)) if x != y)
            ctx = torch.cat([prompt, torch.as_tensor(want[:k],
                                                     device="cuda")])
            gap = _top2_gap(params, cfg32, ctx)
            ties.append((P, k, gap))
            log(f"[5f] (ii) prompt of {P}: EAGLE and autoregressive part "
                f"at token {k} ({got[k]} vs {want[k]}), top-2 logit gap "
                f"{gap:.3e}")
            if gap >= NEAR_TIE:
                raise AssertionError(f"5f(ii): EAGLE {got} != "
                                     f"autoregressive {want}, not at a "
                                     "near tie")
    _add(total, _counts_delta(before, kernels.launch_counts()))
    log(f"[5f] (ii) {cfg.name} fp32: the EAGLE greedy stream equals the "
        f"autoregressive greedy stream for the first {EAGLE_NEW_FP32} "
        f"tokens of {len(prompts) - len(ties)} of {len(prompts)} prompts; "
        f"near ties (top-2 gap < {NEAR_TIE}): {ties or 'none'}")
    del params, ep
    gc.collect()
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phase 7: the dry run against the card
# ---------------------------------------------------------------------------

DRYRUN_OUT = SRC.parent / "build" / "dryrun_torch"
DRYRUN_OPT_OUT = SRC.parent / "build" / "dryrun_torch_opt"
DRYRUN_JOBS = 4                   # the sweep's processes, beside the card's
# phase 7(b)-(c): phase 6's models, deepseek-v2-lite-16b at phase 6's depth
DRYRUN_MODELS = (("minitron-4b", None), ("gemma3-1b", None),
                 ("rwkv6-1.6b", None), ("deepseek-v2-lite-16b", 2))
PEAK_LIVE_TOL = 0.10              # counted peak live vs the card's growth
SHARE_MAX = 1.05                  # t_roof / t_meas above it: a count is wrong
DRYRUN_PREFILL_S = 1536
TRACED_STEPS = 5


def padded_archs() -> list:
    """The archs ``scripts/torch_opt_sweep.py`` pads (JAX's rule)."""
    return _load_example("torch_opt_sweep", "scripts").padded_archs()


def start_dryrun_sweep() -> tuple:
    """Phase 7(a), started once the kernels are built: ``python -m
    repro_torch.launch.dryrun --all --host``, then the opt sweep
    (``scripts/torch_opt_sweep.py``) of the padded archs on ``pod16x16``
    (the unpadded archs' opt records equal their baseline ones), one after
    the other in a process group of their own, with no card visible
    (every step runs on ``meta``), beside the phases on the card;
    (process, start time, log path)."""
    import shlex

    for d in (DRYRUN_OUT, DRYRUN_OPT_OUT):
        d.mkdir(parents=True, exist_ok=True)
        for f in d.glob("*.json"):
            f.unlink()
    log_path = DRYRUN_OUT / "sweep.log"
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    base = [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
            "--host", "--jobs", str(DRYRUN_JOBS), "--out-dir",
            str(DRYRUN_OUT)]
    opt = [sys.executable, str(SRC.parent / "scripts" / "torch_opt_sweep.py"),
           "--jobs", str(DRYRUN_JOBS), "--out-dir", str(DRYRUN_OPT_OUT)]
    for arch in padded_archs():
        opt += ["--arch", arch]
    cmd = (f"{shlex.join(base)}; rc=$?; {shlex.join(opt)} > "
           f"{shlex.quote(str(DRYRUN_OPT_OUT / 'sweep.log'))} 2>&1 || rc=1; "
           "exit $rc")
    with open(log_path, "w") as out:
        proc = subprocess.Popen(["sh", "-c", cmd], stdout=out,
                                stderr=subprocess.STDOUT, env=env,
                                start_new_session=True)
    return proc, time.perf_counter(), log_path


def stop_process_group(proc) -> None:
    """Kill ``proc``'s process group (the sweep and its pool) if alive."""
    import signal

    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
    proc.wait()


def finish_dryrun_sweep(proc, t0: float, log_path) -> dict:
    """Phase 7(a): wait for the sweep; every (arch, shape) pair of the ten
    archs and four shapes must be ``ok``, or ``skip`` with the reason
    ``launch/specs.py::skip_reason`` gives (JAX's, held equal by
    ``tests/test_torch_dryrun.py``), none ``error``; one line a pair."""
    from repro_torch.configs import INPUT_SHAPES, get_config, list_configs
    from repro_torch.launch.dryrun import line
    from repro_torch.launch.specs import skip_reason

    t_wait = time.perf_counter()
    rc = proc.wait(timeout=900)
    waited = time.perf_counter() - t_wait
    text = log_path.read_text()
    opt_path = DRYRUN_OPT_OUT / "sweep.log"
    opt_text = opt_path.read_text() if opt_path.exists() else ""
    done = [ln for ln in text.splitlines() if ln.startswith("[dryrun] done")]
    opt_done = [ln for ln in opt_text.splitlines()
                if ln.startswith("[opt_sweep] done")]
    if rc != 0 or not done or not opt_done:
        raise AssertionError(f"the dry-run sweeps exited {rc}: "
                             f"{text[-3000:]}\n{opt_text[-3000:]}")
    n = {"ok": 0, "skip": 0}
    for arch in (a for a in list_configs() if a != "vicuna-tiny"):
        for shape in INPUT_SHAPES:
            path = DRYRUN_OUT / f"{arch}__{shape}__host1x1.json"
            rec = json.loads(path.read_text())
            log("[7a] " + line(rec).removeprefix("[dryrun] "))
            reason = skip_reason(get_config(arch), shape)
            want = "skip" if reason else "ok"
            if rec["status"] != want or rec.get("reason") != reason:
                why = rec.get("reason") or rec.get("error")
                raise AssertionError(f"{arch} x {shape}: {rec['status']} "
                                     f"({why}), expected {want}")
            n[want] += 1
    log(f"[7a] the dry run of 10 archs x 4 shapes on the host mesh, on "
        f"meta beside phases 3-5h ({DRYRUN_JOBS} processes): {n['ok']} ok, "
        f"{n['skip']} skip, 0 error; {done[-1].split(' in ')[-1]} of its "
        f"own, started {t_wait - t0:.0f}s before phase 7 waited "
        f"{waited:.1f}s for it")
    sweep = _load_example("torch_opt_sweep", "scripts")
    opt = {"ok": 0, "skip": 0}
    for arch in padded_archs():
        cfg = sweep.opt_config(get_config(arch))
        for shape in INPUT_SHAPES:
            path = DRYRUN_OPT_OUT / f"{arch}__{shape}__{sweep.MESH}.json"
            rec = json.loads(path.read_text())
            reason = skip_reason(cfg, shape)
            want = "skip" if reason else "ok"
            if rec["status"] != want or rec.get("reason") != reason:
                why = rec.get("reason") or rec.get("error")
                raise AssertionError(f"opt sweep {arch} x {shape}: "
                                     f"{rec['status']} ({why}), expected "
                                     f"{want}")
            opt[want] += 1
            if want == "ok":
                log(f"[7a] opt {arch} (q heads {cfg.n_heads} -> "
                    f"{cfg.n_heads_padded} over {cfg.n_kv_heads}) x {shape} "
                    f"[{sweep.MESH}]: argument bytes per device "
                    f"{rec['argument_bytes']}, useful_flops_ratio "
                    f"{rec['useful_flops_ratio']:.4f}, counted flops "
                    f"{rec['counted_flops']:.4e}, {rec['n_ops']} ops")
    log(f"[7a] the opt sweep (scripts/torch_opt_sweep.py, pad_q_heads_to="
        f"16) of the padded archs {padded_archs()} x 4 shapes on "
        f"{sweep.MESH}, after the host sweep in its process group: "
        f"{opt['ok']} ok, {opt['skip']} skip, 0 error; "
        f"{opt_done[-1].split(' in ')[-1].split(' (')[0]} of its own")
    n["opt"] = opt
    return n


def count_on_meta(fn):
    """The op counter over ``fn()`` on meta operands (once uncounted
    first: the tree's index arrays are made once a process)."""
    from repro_torch.launch.op_cost import OpCounter

    fn()
    with OpCounter() as oc:
        fn()
    return oc


def check_argument_bytes(cfg, params, dp, max_len: int) -> None:
    """Phase 7(b): the bytes the specs give on the host mesh for params,
    draft params and the decode state at (``SERVE_BATCH``, ``max_len``)
    equal those the port allocates on the card (the engines' own
    allocations: ``init_params``, ``init_draft_params``, the continuous
    engine's ``init_pool_state``), exactly."""
    from repro_torch.core.speculative import init_pool_state
    from repro_torch.distributed.sharding import (params_shardings,
                                                  sharded_bytes)
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_host_mesh

    host, B = make_host_mesh(), SERVE_BATCH
    ps, ds = specs.param_structs(cfg), specs.draft_param_structs(cfg)
    st = specs.decode_state_structs(cfg, B, max_len, "prefix" in ds)
    hd = cfg.resolved_head_dim
    spec_bytes = {
        "params": sharded_bytes(ps, params_shardings(ps, host, head_dim=hd),
                                host),
        "draft params": sharded_bytes(
            ds, params_shardings(ds, host, head_dim=hd), host),
        "decode state": sharded_bytes(
            st, specs.decode_state_shardings(cfg, host, st, B), host)}
    state = init_pool_state(params, dp, cfg, B, max_len, "cuda")
    real = {"params": _nbytes(params), "draft params": _nbytes(dp),
            "decode state": _nbytes(state)}
    del state
    if spec_bytes != real:
        raise AssertionError(f"{cfg.name}: argument bytes from the specs "
                             f"{spec_bytes} != allocated {real}")
    log(f"[7b] {cfg.name}: argument bytes from the specs equal the card's "
        f"allocations: " + ", ".join(f"{k} {v}" for k, v in real.items()))


def check_charges(oc, what: str) -> int:
    """Phase 7(c): each kernel call the counter charged equals the bound
    phase 3's function gives for the same shape at the same capacity."""
    import torch
    from repro_torch.launch.op_cost import bound_ms

    for name, c, shape in oc.kernels:
        B, T, dt = shape.get("B"), shape.get("T"), shape["dtype"]
        if name in ("tree_attention_paged", "tree_attention_paged_windowed",
                    "mla_attention_paged"):
            M, bs = shape["table_entries"] // B, shape["block_size"]
            table = torch.arange(1, 1 + B * M, dtype=torch.int32).reshape(B, M)
            if name == "mla_attention_paged":
                pc = PagedCase(shape["H"], 1, shape["r"] + shape["rd"],
                               (M * bs,) * B, (), M, bs)
                want = mla_bound(pc, T, dt, table)
            else:
                pc = PagedCase(shape["Hq"], shape["Hkv"], shape["D"],
                               (M * bs,) * B, (), M, bs)
                want = paged_bound(pc, T, dt, table, shape["window"])
        elif name == "tree_attention_dense":
            want = dense_bound(DenseCase(shape["Hq"], shape["Hkv"],
                                         shape["D"], tuple(shape["keys"]),
                                         shape["keys"][0]), T, dt)
        elif name == "flash_attention" and not shape["chunk"]:
            want = k3_bound(B, shape["Sq"], shape["Hq"], shape["Hkv"],
                            shape["dqk"], shape["dv"], dt, shape["window"],
                            shape["causal"])
        elif name == "linear_attn_chunk" and (
                B, shape["H"], shape["d"]) == (1, K6_HEADS, K6_DIM):
            want = k6_bound(shape["S"], 4 if dt == "float32" else 2)
        else:
            raise AssertionError(f"{what}: no phase-3 bound for {name} "
                                 f"{shape}")
        if bound_ms(c) != want:
            raise AssertionError(f"{what}: {name} {shape} charged "
                                 f"{bound_ms(c)}, phase 3's bound {want}")
    return len(oc.kernels)


def roofline_case(what: str, oc, busy_s: float) -> dict:
    """Phase 7(c): t_roof = max(compute, bytes / HBM) from the counter
    against the card's device busy time of the same step; fails unless
    0 < t_roof / t_meas <= ``SHARE_MAX`` or a kernel charge differs from
    phase 3's bound."""
    n = check_charges(oc, what)
    share = oc.t_roof_s / busy_s
    flops = ", ".join(f"{k} {v:.4e}" for k, v in sorted(oc.flops.items()))
    kernels = {k: v["calls"] for k, v in oc.kernel_summary().items()}
    log(f"[7c] {what}: counted flops {flops}, bytes {oc.bytes:.4e}; "
        f"compute {oc.compute_s * 1e3:.4f} ms, memory "
        f"{oc.memory_s * 1e3:.4f} ms -> t_roof {oc.t_roof_s * 1e3:.4f} ms "
        f"({'compute' if oc.compute_s > oc.memory_s else 'memory'}); "
        f"t_meas {busy_s * 1e3:.4f} ms (traced device busy); share "
        f"{share:.4f}; {n} kernel charges {kernels} equal phase 3's bounds "
        f"({CARD})")
    if not 0 < share <= SHARE_MAX:
        raise AssertionError(f"{what}: t_roof / t_meas = {share:.4f} is "
                             f"outside (0, {SHARE_MAX}]")
    return {"share": share, "t_roof_ms": oc.t_roof_s * 1e3,
            "t_meas_ms": busy_s * 1e3}


def check_peak_live(what: str, oc, growth: int) -> float:
    """Phase 7(b): the counter's peak live bytes of one eager step within
    ``PEAK_LIVE_TOL`` of the card's ``max_memory_allocated`` growth over
    the same step."""
    rel = abs(oc.peak_live_bytes - growth) / growth
    log(f"[7b] {what}: peak live bytes counted on meta "
        f"{oc.peak_live_bytes} ({oc.peak_live_bytes / 2 ** 20:.2f} MiB), "
        f"the card's max_memory_allocated growth {growth} "
        f"({growth / 2 ** 20:.2f} MiB): {rel:.2%} apart")
    if rel > PEAK_LIVE_TOL:
        raise AssertionError(f"{what}: peak live bytes {oc.peak_live_bytes} "
                             f"vs the card's {growth}: {rel:.2%} > "
                             f"{PEAK_LIVE_TOL:.0%}")
    return rel


def eager_growth(fn) -> int:
    """Bytes ``max_memory_allocated`` grows by over one ``fn()`` (after a
    warm-up call), its result held until measured."""
    import torch

    fn()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    growth = torch.cuda.max_memory_allocated() - base
    del out
    return growth


def dryrun_paged_decode(wl: Workload, cfg, params, dp) -> dict:
    """Phase 7(b)-(c) on phase 6's paged decode step from 4 joined
    prompts: peak live bytes of the eager step, then the captured step's
    device busy per replay against the counter's roofline."""
    import numpy as np
    import torch
    from repro_torch.configs import tree_for
    from repro_torch.launch import specs
    from repro_torch.serving.graph import CapturedStep
    from repro_torch.serving.paged import (init_paged_state,
                                           paged_spec_decode_step)

    tree = tree_for(cfg)
    state, table = joined_paged_state(wl, cfg, params, dp)
    B, M = table.shape
    active = np.ones(B, dtype=bool)

    def step(st, act, tbl):
        return paged_spec_decode_step(params, dp, cfg, tree, st, tbl,
                                      active=act)

    growth = eager_growth(lambda: step(
        state, torch.as_tensor(active, device="cuda"),
        torch.as_tensor(table, device="cuda")))
    cap = CapturedStep(step, state, B, table.shape)
    busy = device_busy_s(lambda: cap(active, table), TRACED_STEPS)
    del cap, state
    mp, md = specs.param_structs(cfg), specs.draft_param_structs(cfg)
    mstate = init_paged_state(mp, md, cfg, B, 1 + B * M, BLOCK, "meta")
    mtable = torch.empty((B, M), dtype=torch.int32, device="meta")
    mactive = torch.empty((B,), dtype=torch.bool, device="meta")
    oc = count_on_meta(lambda: paged_spec_decode_step(
        mp, md, cfg, tree, mstate, mtable, active=mactive))
    what = (f"{cfg.name} ({cfg.n_layers} layers) paged decode step (B={B}, "
            f"max_len {wl.max_len}, block {BLOCK}, captured)")
    rec = roofline_case(what, oc, busy)
    rec["peak_rel"] = check_peak_live(f"{cfg.name} eager paged decode step",
                                      oc, growth)
    return rec


def dryrun_dense_decode(wl: Workload, cfg, params, dp) -> dict:
    """Phase 7(c) on the dry run's own decode step
    (``launch/specs.py::make_serve_step``, the dense cache, K2) from 4
    joined prompts, eager, traced."""
    import torch
    from repro_torch.configs import tree_for
    from repro_torch.core.speculative import init_pool_state, join_slot
    from repro_torch.launch import specs

    B, tree = SERVE_BATCH, tree_for(cfg)
    state = init_pool_state(params, dp, cfg, B, wl.max_len, "cuda")
    for si, r in enumerate(workload_requests(wl, cfg)[:B]):
        n = len(r.prompt)
        prompt = torch.zeros(-(-n // 32) * 32, dtype=torch.long)
        prompt[:n] = torch.from_numpy(r.prompt)
        state = join_slot(params, dp, cfg, state, prompt.cuda(), n, si)
    serve = specs.make_serve_step(cfg, tree)
    growth = eager_growth(lambda: serve(params, dp, state))
    busy = device_busy_s(lambda: serve(params, dp, state), TRACED_STEPS)
    del state
    mp, md = specs.param_structs(cfg), specs.draft_param_structs(cfg)
    mstate = specs.decode_state_structs(cfg, B, wl.max_len, "prefix" in md)
    oc = count_on_meta(lambda: serve(mp, md, mstate))
    rec = roofline_case(f"{cfg.name} dense-cache decode step, make_serve_step "
                        f"(B={B}, max_len {wl.max_len}, eager)", oc, busy)
    rec["peak_rel"] = check_peak_live(f"{cfg.name} eager dense decode step",
                                      oc, growth)
    return rec


def dryrun_prefill(cfg, params) -> dict:
    """Phase 7(c) on the dry run's prefill step (``launch/specs.py::
    make_prefill_step``) of one prompt of ``DRYRUN_PREFILL_S`` tokens,
    eager, traced."""
    import torch
    from repro_torch.launch import specs

    S = DRYRUN_PREFILL_S
    prefill = specs.make_prefill_step(cfg, S + 64)
    g = torch.Generator(device="cuda").manual_seed(S)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, S), generator=g,
                                     device="cuda", dtype=torch.int32)}
    growth = eager_growth(lambda: prefill(params, batch))
    busy = device_busy_s(lambda: prefill(params, batch), 3)
    mp = specs.param_structs(cfg)
    oc = count_on_meta(lambda: prefill(mp, specs.batch_structs(cfg, 1, S)))
    rec = roofline_case(f"{cfg.name} prefill step, make_prefill_step (B=1, "
                        f"S={S}, eager)", oc, busy)
    rel = abs(oc.peak_live_bytes - growth) / growth
    log(f"[7b] {cfg.name} eager prefill step (a reading): peak live bytes "
        f"counted on meta {oc.peak_live_bytes}, the card's growth {growth}: "
        f"{rel:.2%} apart")
    return rec


def dryrun_against_card() -> dict:
    """Phase 7(b)-(c): for each of ``DRYRUN_MODELS``, from weights drawn
    on the card, the argument bytes, the paged decode step (and, at
    minitron-4b, the dense-cache decode step; at gemma3-1b and rwkv6-1.6b
    the prefill) counted on meta against the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.heads import init_draft_params
    from repro_torch.models.model import init_params

    cases = {}
    for arch, layers in DRYRUN_MODELS:
        wl = next(w for w in WORKLOADS if w.arch == arch)
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        params = init_params(cfg, seed=0, device="cuda")
        dp = init_draft_params(cfg, seed=1, device="cuda")
        check_argument_bytes(cfg, params, dp, wl.max_len)
        cases[f"{arch} paged decode"] = dryrun_paged_decode(wl, cfg, params,
                                                            dp)
        if arch == "minitron-4b":
            cases[f"{arch} dense decode"] = dryrun_dense_decode(
                wl, cfg, params, dp)
        if arch in ("gemma3-1b", "rwkv6-1.6b"):
            cases[f"{arch} prefill"] = dryrun_prefill(cfg, params)
        del params, dp
        gc.collect()
        torch.cuda.empty_cache()
    log("[7] " + json.dumps({"card": CARD, "cases": cases}))
    return cases


# phase 7(d): gemma3-1b with its query heads padded to 16, as JAX's opt
# sweep (scripts/opt_sweep.py, pad_q_heads_to=16) runs it: JAX's padded
# heads are real heads, so this is another model, 16 q heads over the one
# kv head of 256 (G=16: 256 query rows a kv head in a verify step of 16,
# four row groups in K1 and K4; K3's (256, 256) build at 16 over 1),
# served at full width and depth, bf16, random weights, Hydra++ heads
PAD_ARCH, PAD_TO = "gemma3-1b", 16
PAD_NAME = f"{PAD_ARCH}-pad{PAD_TO}"
GEMMA3_PAD = dataclasses.replace(GEMMA3, hq=PAD_TO)


def _us_pair(rec: dict, base: dict) -> str:
    return (f"{rec['ms'] * 1e3:.1f}us (bound {rec['bound_ms'] * 1e3:.2f}us "
            f"{rec['bound_by']}; unpadded {base['ms'] * 1e3:.1f}us, bound "
            f"{base['bound_ms'] * 1e3:.2f}us)")


def serve_padded(k1_base: dict, k4_base: dict, k3_base: dict) -> dict:
    """Phase 7(d): K3, K4 and K1 at the padded shapes against their plain
    versions (``TOLS``; timed, logged beside the unpadded gemma3-1b's
    ``k1_base``, ``k4_base``, ``k3_base`` records of phase 3), then the
    padded model on the card: argument bytes against the specs, phase 5's
    8 requests through the paged engine (whole prefills, the captured
    decode step, every launch counted), one captured step replayed
    bitwise against the eager step, and the counter's roofline against
    the captured decode step and the prefill (7(c)).  Returns the records
    and the serve's launch counts."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.heads import init_draft_params
    from repro_torch.models.model import init_params

    cfg = dataclasses.replace(get_config(PAD_ARCH), pad_q_heads_to=PAD_TO,
                              name=PAD_NAME)
    k3 = check_k3({PAD_NAME: (cfg.n_heads_padded, cfg.n_kv_heads,
                              cfg.resolved_head_dim)})
    k1 = check_k1(GEMMA3_PAD, f"{PAD_NAME} D=256", Ts=(16,))
    k4 = check_k4(GEMMA3_PAD, Ts=(16,), tag=PAD_NAME)
    for dt, _ in TOLS:
        pairs = [("K1 T=16", k1[(dt, 16)], k1_base[(dt, 16)])]
        pairs += [(f"K4 T=16 window {w}", k4[(dt, 16, w)],
                   k4_base[(dt, 16, w)]) for w in (WINDOW, 0)]
        pairs += [(f"K3 S=1536 window {w}", k3[(PAD_NAME, dt, 1536, w)],
                   k3_base[(PAD_ARCH, dt, 1536, w)]) for w in (WINDOW, 0)]
        log(f"[7d] {PAD_NAME} {dt} ({CARD}), device time at 16 over 1 heads "
            f"against gemma3-1b's 4 over 1: "
            + "; ".join(f"{what} {_us_pair(rec, base)}"
                        for what, rec, base in pairs))
    wl = next(w for w in WORKLOADS if w.arch == PAD_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    params = init_params(cfg, seed=0, device="cuda")
    dp = init_draft_params(cfg, seed=1, device="cuda")
    log(f"[7d] {PAD_NAME}: {cfg.n_layers} layers, q heads {cfg.n_heads} -> "
        f"{cfg.n_heads_padded} over {cfg.n_kv_heads} kv head of "
        f"{cfg.resolved_head_dim}; weights {_nbytes(params) / 1e9:.2f} GB, "
        f"draft heads and prefix layer {_nbytes(dp) / 1e9:.2f} GB")
    log_resolved(cfg, "7d")
    check_argument_bytes(cfg, params, dp, wl.max_len)
    counts, _, _ = serve_engine(wl, cfg, params, dp, "paged",
                                wl.verify["paged"], wl.prefill)
    check_replay_step(wl, cfg, params, dp)
    roof = {"paged decode": dryrun_paged_decode(wl, cfg, params, dp),
            "prefill": dryrun_prefill(cfg, params)}
    del params, dp
    gc.collect()
    torch.cuda.empty_cache()
    log("[7d] " + json.dumps({"card": CARD, "model": PAD_NAME,
                              "launches": counts, "cases": roof}))
    return {"k1": k1, "k4": k4, "k3": k3, "launches": counts,
            "roofline": roof}


def padded_entries(entry, padded: dict) -> list:
    """The JSON line's entries of the padded gemma3-1b (7(d)): K1, K4 and
    K3 at 16 over 1 heads, each with its launches in the padded serve."""
    out = []
    for kname, source, replaces, rec, recs, case in (
            ("tree_attention_paged", "tree_attention_paged.cu",
             "src/repro/kernels/tree_attention/kernel.py:63",
             padded["k1"][("bfloat16", 16)], padded["k1"],
             "16 q over 1 kv head, D=256, T=16 (256 rows, 4 row groups)"),
            ("tree_attention_paged_windowed", "tree_attention_paged.cu",
             "src/repro/kernels/attention_template/ops.py:37",
             padded["k4"][("bfloat16", 16, WINDOW)], padded["k4"],
             f"16 q over 1 kv head, D=256, T=16, window {WINDOW}"),
            ("flash_attention", "flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:23",
             padded["k3"][(PAD_NAME, "bfloat16", 1536, WINDOW)],
             padded["k3"],
             f"16 q over 1 kv head, (256, 256), S=1536, window {WINDOW}")):
        err = max(r["max_abs_err"] for key, r in recs.items()
                  if "bfloat16" in key)
        e = entry(kname, f"src/repro_torch/csrc/{source}", replaces, rec,
                  err)
        e.update(name=f"{kname}@{PAD_NAME}",
                 launches=padded["launches"][kname], case=case,
                 max_abs_err_fp32=max(r["max_abs_err"]
                                      for key, r in recs.items()
                                      if "float32" in key))
        out.append(e)
    return out


def f32_entries(entry, main_launches, k3, k3_mla, k3_chunk, zk, hk,
                bwd) -> list:
    """The JSON line's fp32 K3 entries: the forward (3d, 3j, 3k and the
    MLA and chunk cases) and the backward (3m), each with its launches on
    the main path (phases 5-5h), its CUDA-core and 3xTF32 bounds and, per
    case, each launch's µs and blocks."""
    fwd = {f"{m} S={S} window={w}": r for (m, dt, S, w), r in k3.items()
           if dt == "float32" and "ms" in r}
    fwd.update({f"{ZAMBA2} S={S} window={w}": r
                for (_, dt, S, w), r in zk["K3"].items()
                if dt == "float32" and "ms" in r})
    fwd.update({f"{HUBERT} S={S} bidirectional": r
                for (dt, S), r in hk.items() if dt == "float32" and "ms" in r})
    fwd["deepseek MLA (192, 128) S=1536"] = k3_mla["float32"]
    chunks = {**k3_chunk, **zk["K3 chunk"]}
    fwd.update({f"{m} chunk C={K3_CHUNK} q_off={o} window={w}": r
                for (m, dt, o, w), r in chunks.items()
                if dt == "float32" and "ms" in r})
    back = {f"{key[1]} S=512 window={key[3]}": r for key, r in bwd.items()
            if key[0] == "K3" and key[2] == "float32"}

    def cases(recs):
        return {what: {"us": 1e3 * r["ms"], "bound_ms": r["bound_ms"],
                       "bound_3xtf32_ms": r["bound_3xtf32_ms"],
                       "plain_ms": r["plain_ms"],
                       "library_ms": r["library_ms"],
                       "max_abs_err": r["max_abs_err"],
                       "launches": {k: {"us": us, "blocks": n} for k, (us, n)
                                    in r["split"].items()}}
                for what, r in recs.items()}

    out = []
    for name, source, replaces, main, recs, n in (
            ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:23",
             fwd["gemma3-1b S=1536 window=0"], fwd, main_launches[0]),
            ("flash_attention_bwd",
             "src/repro_torch/csrc/flash_attention_bwd.cu",
             "src/repro/models/layers.py:102",
             back[f"fp32 D=256 S=512 window={WINDOW}"], back,
             main_launches[1])):
        e = entry("flash_attention", source, replaces, main,
                  max(r["max_abs_err"] for r in recs.values()))
        e.update(name=f"{name}@fp32", launches=n,
                 bound_3xtf32_ms=main["bound_3xtf32_ms"],
                 note="the fp32 builds: every product in 3xTF32 on the "
                      "tensor cores; launches of an fp32 build (backward: "
                      "calls) in phases 5-5h", cases=cases(recs))
        out.append(e)
    return out


def k6_f32_entries(entry, f32_counts, k6, bwd, draws) -> list:
    """The JSON line's fp32 K6 entries (3xTF32): the forward at S=1536
    (3f) and the backward at S=500 (3m), each with the fp32 calls of
    phases 4-5h, those of its kernel check apart, and each launch's µs
    and blocks; the forward with its cases' worst margin and each strong
    draw's margins against plain fp32 and fp64 (``draws``)."""
    out = []
    for name, source, replaces, rec, errs, n, checks in (
            ("linear_attn_chunk", "src/repro_torch/csrc/linear_attn_chunk.cu",
             "src/repro/kernels/linear_attn_chunk/kernel.py:74",
             k6[("float32", 1536, True, False, 1)],
             [r["max_abs_err"] for key, r in k6.items()
              if key[0] == "float32"], f32_counts[0],
             K6_F32_CALLS["3f forward"]
             + K6_F32_CALLS["3f strong draws"]),
            ("linear_attn_chunk_bwd",
             "src/repro_torch/csrc/linear_attn_chunk_bwd.cu",
             "src/repro/models/ssm.py:67", bwd[("K6", "float32", 500)],
             [r["max_abs_err"] for key, r in bwd.items()
              if key[:2] == ("K6", "float32")], f32_counts[1],
             K6_F32_CALLS["3m backward"])):
        e = dict(entry("linear_attn_chunk", source, replaces, rec,
                       max(errs)), name=f"{name}@fp32", launches=n)
        e.update(note="the fp32 builds: every product in 3xTF32 on the "
                      "tensor cores; calls of an fp32 build in phases "
                      "4-5h",
                 calls_in_kernel_check=checks,
                 split={k: {"us": us, "blocks": b}
                        for k, (us, b) in rec["split"].items()})
        if name == "linear_attn_chunk":
            e["tol_ratio"] = max(r["tol_ratio"] for key, r in k6.items()
                                 if key[0] == "float32")
            e["strong_draws"] = {
                str(seed): {k: r[k] for k in (
                    "tol_ratio", "tol_ratio_fp64", "plain_tol_ratio_fp64")}
                for seed, r in draws.items()}
        out.append(e)
    return out


def tree_f32_entries(entry, f32_counts, k1s, k4, k2s) -> list:
    """The JSON line's fp32 tree-verify entries (3xTF32): K1 (3a-b and
    vicuna-tiny's cases), K2 (3g, vicuna-tiny's too) and K4 (3c), each
    with the fp32 launches of phases 4-5h, its main case's numbers and,
    per case, µs, bounds, plain and SDPA times, errors (against the plain
    version and its fp64 run) and each launch's µs and blocks."""
    def cases(recs):
        return {what: {"us": 1e3 * r["ms"], "bound_ms": r["bound_ms"],
                       "bound_3xtf32_ms": r["bound_3xtf32_ms"],
                       "plain_ms": r["plain_ms"],
                       "library_ms": r["library_ms"],
                       "max_abs_err": r["max_abs_err"],
                       "err_fp64": r["err_fp64"],
                       "launches": {k: {"us": us, "blocks": n} for k, (us, n)
                                    in r["split"].items()}}
                for what, r in recs.items()}

    k1 = {f"{tag} T={T}": r for tag, recs in k1s.items()
          for (dt, T), r in recs.items() if dt == "float32"}
    k2 = {f"{tag} T={T}": r for (tag, dt, T), r in k2s.items()
          if dt == "float32"}
    k4 = {f"gemma3 T={T} window={w}": r for (dt, T, w), r in k4.items()
          if dt == "float32"}
    out = []
    for name, replaces, main, recs in (
            ("tree_attention_paged",
             "src/repro/kernels/tree_attention/kernel.py:63",
             k1["minitron D=128 T=16"], k1),
            ("tree_attention_dense",
             "src/repro/kernels/tree_attention/kernel.py:47",
             k2["minitron T=16"], k2),
            ("tree_attention_paged_windowed",
             "src/repro/kernels/attention_template/ops.py:37",
             k4[f"gemma3 T=16 window={WINDOW}"], k4)):
        e = entry(name, "src/repro_torch/csrc/tree_attention_paged.cu",
                  replaces, main, max(r["max_abs_err"] for r in recs.values()))
        e.update(name=f"{name}@fp32", launches=f32_counts[name],
                 bound_3xtf32_ms=main["bound_3xtf32_ms"],
                 err_fp64=max(r["err_fp64"] for r in recs.values()),
                 note="the fp32 build: both products in 3xTF32 on the tensor "
                      "cores; launches of the fp32 build in phases 4-5h "
                      "(vicuna-tiny's serves among them)", cases=cases(recs))
        out.append(e)
    return out


def k5_f32_entry(entry, f32_count: int, k5) -> dict:
    """The JSON line's fp32 K5 entry (3xTF32): phase 3e's T=16 case with
    the fp32 launches of phases 4-5h, both bounds, its errors (against the
    plain version, its fp64 run, and the margin), each launch's µs and
    blocks, the windowed cases, and the reduced deepseek case (the build
    phase 4 runs; errors only)."""
    rec, red = k5[("float32", 16)], k5[("float32", MLA_REDUCED_T)]
    errs = [r["max_abs_err"] for r in (rec, red)] + [
        w["max_abs_err"] for r in (rec, red) for w in r["windowed"].values()]
    e = entry("mla_attention_paged",
              "src/repro_torch/csrc/mla_attention_paged.cu",
              "src/repro/kernels/attention_template/ops.py:70", rec, max(errs))
    cases = {f"deepseek 16 heads (512, 64) T=16 window={w}": {
        "us": 1e3 * r["ms"], "max_abs_err": r["max_abs_err"],
        "tol_ratio": r["tol_ratio"]} for w, r in rec["windowed"].items()}
    reduced = (f"reduced deepseek {MLA_REDUCED_CASE.hq} heads "
               f"{MLA_REDUCED_WIDTHS} T={MLA_REDUCED_T}")
    cases[reduced] = {k: red[k] for k in ("max_abs_err", "err_fp64",
                                          "tol_ratio", "tol_ratio_fp64")}
    cases.update({f"{reduced} window={w}": r
                  for w, r in red["windowed"].items()})
    e.update(name="mla_attention_paged@fp32", launches=f32_count,
             bound_3xtf32_ms=rec["bound_3xtf32_ms"], err_fp64=rec["err_fp64"],
             tol_ratio=rec["tol_ratio"], tol_ratio_fp64=rec["tol_ratio_fp64"],
             split={k: {"us": us, "blocks": n}
                    for k, (us, n) in rec["split"].items()},
             note="the fp32 build: both products in 3xTF32 on the tensor "
                  "cores; launches of the fp32 build in phases 4-5h (phase "
                  "4's reduced deepseek-v2-lite-16b, held against the plain "
                  "version at its shapes in 3e)", cases=cases)
    return e


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no port package at {SRC}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    global CARD
    CARD = smi.splitlines()[0]
    log(CARD)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    from repro_torch.configs import get_config, head_preserving
    from repro_torch.kernels import AUTOTUNE_ENV, build
    # every phase under the committed winners (a K3 shape resolves its
    # tile once a process, at its first call)
    os.environ[AUTOTUNE_ENV] = "on"
    t0 = time.perf_counter()
    built = build.build()
    log(f"[build] {sorted(built) or 'nothing to build'} in "
        f"{time.perf_counter() - t0:.1f}s")
    main_path_builds = TREE_VERIFY_BUILDS | k3_builds() | MLA_BUILDS \
        | K6_BUILDS | bwd_builds()
    parsed = set()
    for name in sorted(build.SOURCES):
        if name in built:
            log(f"[build] {name}: {built[name][0]:.1f}s")
        for line in ptxas_lines(build.ptxas_report(name)):
            log(f"[ptxas] {line}")
            # the builds the main path runs, and every head-dim-256 build,
            # keep their accumulators in registers
            inst = line.split(":")[0]
            parsed.add(inst)
            if (inst in main_path_builds or "=256" in inst) \
                    and "0 bytes spill stores, 0 bytes spill loads" \
                    not in line:
                raise AssertionError(f"a checked build spills: {line}")
    missing = sorted(main_path_builds - parsed)
    if missing:
        raise AssertionError(f"no ptxas line parsed for {missing}: the "
                             "spill check could not run")
    tensor_cores = {}
    for name in ("tree_attention_paged", "flash_attention",
                 "mla_attention_paged", "linear_attn_chunk",
                 "flash_attention_bwd", "linear_attn_chunk_bwd"):
        tensor_cores.update(sass_tensor_cores(build.library_path(name)))
    checked = sorted(k for k in tensor_cores
                     if k.startswith(TENSOR_CORE_KERNELS))
    without = [k for k in checked if not tensor_cores[k]]
    unseen = [p for p in TENSOR_CORE_KERNELS
              if not any(k.startswith(p) for k in checked)]
    if len(checked) < 8 or without or unseen:
        raise AssertionError(f"SASS: builds without HMMA/HGMMA: "
                             f"{without}; no build of {unseen}; checked "
                             f"{checked}")
    log(f"[sass] HMMA/HGMMA in every bf16 and fp32 build of K3 and of its "
        f"backward's dK/dV and dQ kernels, the tree-verify split kernel, "
        f"K5's split sweep, K6's two kernels and its backward's increment "
        f"and gradient pass, bf16 and fp32: {checked}")
    # row groups are a grid axis: the models past 64 rows per kv head run
    # the D=128 builds above, so there is no new instantiation to check
    log("[ptxas] starcoder2-7b, qwen2.5-32b, chameleon-34b and "
        "deepseek-moe-16b run tree_attention_split_kernel<bf16, D=128> "
        "(and its dense form) and flash_attention_kernel<bf16, DQK=128, "
        "DV=128, KN=..>; zamba2-1.2b's shared block the D=64 forms and "
        "flash_attention_kernel<bf16, DQK=64, DV=64, KN=..>: all listed "
        "above without a spill")
    d64 = sorted(k for k in checked if "D=64" in k or "DQK=64" in k)
    if len(d64) < 3 or not all(tensor_cores[k] for k in d64):
        raise AssertionError(f"SASS: the D=64 builds {d64} lack HMMA")
    log(f"[sass] the D=64 builds (zamba2-1.2b's bf16, vicuna-tiny's fp32 "
        f"tree verify) on the tensor cores: {d64}")
    d80 = sorted(k for k in tensor_cores
                 if k.startswith("flash_attention_kernel<bf16, DQK=80,"))
    if len(d80) < 3 or not all(tensor_cores[k] for k in d80):
        raise AssertionError(f"SASS: K3's (80, 80) builds {d80} lack "
                             "HGMMA")
    log(f"[ptxas] hubert-xlarge's encoder runs one of {d80}, listed above "
        f"without a spill; [sass] each runs HGMMA")
    # K3's bf16 body: both products on wgmma, every load a TMA copy
    lib = build.library_path("flash_attention")
    wgmma, tma = (sass_tensor_cores(lib, (op,)) for op in ("HGMMA",
                                                           "UTMALDG"))
    k3_bf16 = sorted(k for k in wgmma
                     if k.startswith("flash_attention_kernel<bf16"))
    lacking = [k for k in k3_bf16 if not (wgmma[k] and tma[k])]
    if len(k3_bf16) < len(k3_builds()) or lacking:
        raise AssertionError(f"SASS: K3's bf16 builds without HGMMA or "
                             f"UTMALDG: {lacking} of {k3_bf16}")
    log(f"[sass] K3's bf16 builds run HGMMA (wgmma) and UTMALDG (TMA "
        f"loads): {k3_bf16}")
    log(f"[time] phase 2 (builds and their checks) done at "
        f"{time.perf_counter() - t_start:.0f}s")
    # phase 7(a) runs on the CPU beside the phases on the card
    sweep = start_dryrun_sweep()
    try:
        return run_phases(t_start, sweep)
    finally:
        stop_process_group(sweep[0])


def run_phases(t_start: float, sweep: tuple) -> int:
    """Phases 3-7 and the result lines."""
    import torch
    from repro_torch.configs import get_config, head_preserving

    k1 = check_k1(MINITRON, "minitron D=128")
    k1s = {"minitron D=128": k1, "gemma3 D=256": check_k1(GEMMA3,
                                                          "gemma3 D=256")}
    k1s.update({f"vicuna-tiny {tag}": check_k1(c, f"vicuna-tiny {tag}",
                                               Ts=(16,))
                for tag, c in VICUNA_K1.items()})
    k4 = check_k4()
    check_splits()
    k3 = check_k3()
    k3_mla = check_k3_mla()
    k3_chunk = check_k3_chunk()
    k5 = check_k5()
    k5.update(check_k5(MLA_REDUCED_CASE, MLA_REDUCED_T, MLA_REDUCED_WIDTHS,
                       MLA_REDUCED_SCALE, timed=False))
    from repro_torch.kernels.linear_attn_chunk import ops as k6_ops

    k6 = check_k6()
    check_k6_boundary()
    k6_draws = check_k6_strong_draws()
    k2 = check_k2()
    k2s = {**k2, **check_k2(VICUNA_K2, Ts=(16,))}
    check_k1_prefix()
    rows = check_rows()
    zk = check_zamba2_kernels()
    hk = check_k3_hubert()
    t_3m = time.perf_counter()
    bwd = check_backward()
    log(f"[time] phase 3m (the backward kernels): "
        f"{time.perf_counter() - t_3m:.0f}s")
    t_3l = time.perf_counter()
    check_autotune()
    log(f"[time] phase 3l (the autotuner's sweep): "
        f"{time.perf_counter() - t_3l:.0f}s")
    log(f"[time] phase 3 (kernel checks) done at "
        f"{time.perf_counter() - t_start:.0f}s")
    from repro_torch.kernels.attention_template import ops as k4_ops
    from repro_torch.kernels.tree_attention import dense_ops as k2_ops
    from repro_torch.kernels.tree_attention import ops as k1_ops

    # the fp32 tree-verify and K5 launches and fp32 K6 calls (forward,
    # backward) of phases 4-5h (the wrappers' own counters, which
    # kernels.reset_counts leaves alone)
    tree_f32 = {"tree_attention_paged": k1_ops,
                "tree_attention_paged_windowed": k4_ops,
                "tree_attention_dense": k2_ops}
    for mod in tree_f32.values():
        mod.f32_launches = 0
    k6_ops.f32_launches = k6_ops.f32_bwd_launches = 0
    from repro_torch.kernels.mla_attention import ops as k5_ops

    k5_ops.f32_launches = 0

    check_tiny_parity(dataclasses.replace(
        get_config("minitron-4b").reduced(), dtype="float32"),
        (16, 23, 32, 9, 40, 12))
    check_tiny_parity(dataclasses.replace(
        get_config("gemma3-1b").reduced(), dtype="float32",
        window_pattern=(16, 0)), (17, 23, 30, 19, 40, 21))
    check_tiny_parity(dataclasses.replace(
        get_config("deepseek-v2-lite-16b").reduced(), dtype="float32"),
        (17, 23, 30, 19, 40, 21))
    # a chain of 5 writes less scratch than a tree of 16: longer budgets
    # over a pool of 7 blocks make the slots' growth preempt
    check_tiny_parity(dataclasses.replace(
        get_config("rwkv6-1.6b").reduced(), dtype="float32"),
        (16, 23, 32, 9, 40, 12), budgets=(30,) * 6, num_blocks=8)
    # the rest of the registry at their head-preserving narrow forms (the
    # published head counts, so a verify step has 144, 80, 128 and 16
    # rows per kv head; K3's fp32 blocks are per query head at any G),
    # short prompts that make two slots share the pool, whole and in
    # chunks of 8 (two a prompt)
    for arch in ("starcoder2-7b", "qwen2.5-32b", "chameleon-34b",
                 "deepseek-moe-16b"):
        check_tiny_parity(dataclasses.replace(
            head_preserving(get_config(arch)), dtype="float32"),
            (9, 12, 10, 14), budgets=(14, 12, 13, 12), chunks=(8,))
    # zamba2: reduced() (shared, mamba 1, shared, mamba 1) and 5 layers
    # every 2 (segments 2, 2, 1: three invocations), with a preemption,
    # whole and in chunks of 16 (the scan's chunk)
    zamba2 = get_config(ZAMBA2).reduced()
    for cfg in (zamba2, dataclasses.replace(zamba2, n_layers=5,
                                            hybrid_attn_every=2)):
        check_tiny_parity(dataclasses.replace(cfg, dtype="float32"),
                          (16, 23, 32, 9, 40, 12), budgets=(30,) * 6,
                          num_blocks=8, chunks=(16,))
    log(f"[time] phase 4 (tiny fp32 parity) done at "
        f"{time.perf_counter() - t_start:.0f}s")
    from repro_torch.kernels.flash_attention import ops as k3_ops

    # the fp32 K3 launches of phases 5-5h (the wrapper's own counters,
    # which kernels.reset_counts leaves alone)
    k3_ops.f32_launches = k3_ops.f32_bwd_launches = 0
    launches, per_arch = {}, {}
    for wl in WORKLOADS:
        t_wl = time.perf_counter()
        counts, pair_k2 = serve_full_width(wl)
        _add(launches, counts)
        per_arch[wl.arch] = dict(counts, pair_k2=pair_k2)
        log(f"[time] phases 5-6 of {wl.arch}: "
            f"{time.perf_counter() - t_wl:.0f}s, done at "
            f"{time.perf_counter() - t_start:.0f}s")

    t_smp = time.perf_counter()
    check_sampler(torch.Generator(device="cuda").manual_seed(
        SAMPLING["seed"]))
    log(f"[time] phase 5c (the sampler): "
        f"{time.perf_counter() - t_smp:.0f}s, done at "
        f"{time.perf_counter() - t_start:.0f}s")
    t_hub = time.perf_counter()
    hubert = check_hubert()
    log(f"[time] phase 5d ({HUBERT}): {time.perf_counter() - t_hub:.0f}s, "
        f"done at {time.perf_counter() - t_start:.0f}s")
    # phases 5e-5g: their K3, K2 and K6 launches join those entries
    for what, phase in (("5e (i)-(iii) (gemma3-1b training)",
                         train_full_width),
                        ("5e (iv) and 5f (iii) (vicuna-tiny end to end)",
                         train_tiny_end_to_end),
                        ("5f (i)-(ii) (EAGLE at minitron-4b)",
                         eagle_full_width),
                        ("5g (rwkv6-1.6b, zamba2-1.2b and the MoE archs "
                         "training)", train_recurrent_and_moe),
                        ("5h (the serving examples)", run_examples)):
        t_ph = time.perf_counter()
        _add(launches, phase())
        log(f"[time] phase {what}: {time.perf_counter() - t_ph:.0f}s, "
            f"done at {time.perf_counter() - t_start:.0f}s")

    f32_main = (k3_ops.f32_launches, k3_ops.f32_bwd_launches)
    k6_f32 = (k6_ops.f32_launches, k6_ops.f32_bwd_launches)
    log(f"[5] fp32 K6 calls in phases 4-5h: {k6_f32[0]} forward, "
        f"{k6_f32[1]} backward (the kernel checks besides: "
        f"{K6_F32_CALLS})")
    if not all(k6_f32):
        raise AssertionError(f"fp32 K6 was never launched in phases 4-5h: "
                             f"{k6_f32} (forward, backward)")
    tree_f32_counts = {k: m.f32_launches for k, m in tree_f32.items()}
    log(f"[5] fp32 tree-verify launches in phases 4-5h: {tree_f32_counts}")
    if not all(tree_f32_counts.values()):
        raise AssertionError(f"an fp32 tree-verify form was never launched "
                             f"in phases 4-5h: {tree_f32_counts}")
    k5_f32 = k5_ops.f32_launches
    log(f"[5] fp32 K5 launches in phases 4-5h: {k5_f32}")
    if not k5_f32:
        raise AssertionError("fp32 K5 was never launched in phases 4-5h")
    t_7 = time.perf_counter()
    finish_dryrun_sweep(*sweep)
    dryrun_against_card()
    log(f"[time] phase 7 (the dry run against the card): "
        f"{time.perf_counter() - t_7:.0f}s, done at "
        f"{time.perf_counter() - t_start:.0f}s")
    t_7d = time.perf_counter()
    padded = serve_padded(k1s["gemma3 D=256"], k4, k3)
    log(f"[time] phase 7(d) ({PAD_NAME}): {time.perf_counter() - t_7d:.0f}s, "
        f"done at {time.perf_counter() - t_start:.0f}s")

    def entry(name, source, replaces, rec, err):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": err, "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"]}

    kernels = [
        entry("tree_attention_paged",
              "src/repro_torch/csrc/tree_attention_paged.cu",
              "src/repro/kernels/tree_attention/kernel.py:63",
              k1[("bfloat16", 16)],
              max(k1[("bfloat16", T)]["max_abs_err"] for T in (16, 5))),
        entry("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention/kernel.py:23",
              k3[("gemma3-1b", "bfloat16", 1536, WINDOW)],
              max([r["max_abs_err"] for key, r in k3.items()
                   if key[1] == "bfloat16"]
                  + [k3_mla["bfloat16"]["max_abs_err"]])),
        entry("flash_attention_chunk",
              "src/repro_torch/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention/kernel.py:23",
              k3_chunk[("gemma3-1b", "bfloat16", K3_CHUNK_OFFSETS[-1],
                        WINDOW)],
              max(r["max_abs_err"] for key, r in k3_chunk.items()
                  if key[1] == "bfloat16")),
        entry("tree_attention_paged_windowed",
              "src/repro_torch/csrc/tree_attention_paged.cu",
              "src/repro/kernels/attention_template/ops.py:37",
              k4[("bfloat16", 16, WINDOW)],
              max(r["max_abs_err"] for key, r in k4.items()
                  if key[0] == "bfloat16")),
        entry("mla_attention_paged",
              "src/repro_torch/csrc/mla_attention_paged.cu",
              "src/repro/kernels/attention_template/ops.py:70",
              k5[("bfloat16", 16)],
              max(r["max_abs_err"] for key, r in k5.items()
                  if key[0] == "bfloat16")),
        entry("tree_attention_dense",
              "src/repro_torch/csrc/tree_attention_paged.cu",
              "src/repro/kernels/tree_attention/kernel.py:47",
              k2[("minitron", "bfloat16", 16)],
              max(r["max_abs_err"] for key, r in k2.items()
                  if key[1] == "bfloat16")),
        entry("linear_attn_chunk", "src/repro_torch/csrc/linear_attn_chunk.cu",
              "src/repro/kernels/linear_attn_chunk/kernel.py:74",
              k6[("bfloat16", 1536, True, False, 1)],
              max(r["max_abs_err"] for key, r in k6.items()
                  if key[0] == "bfloat16")),
    ]
    # the backward kernels (phase 3m), each an entry of its own: no TPU
    # kernel; "replaces" names the JAX function whose gradient it computes,
    # and its launches are those of the main path's training (5e-5h)
    for name, source, replaces, rec, errs in (
            ("linear_attn_chunk_bwd",
             "src/repro_torch/csrc/linear_attn_chunk_bwd.cu",
             "src/repro/models/ssm.py:67", bwd[("K6", "bfloat16", 1024)],
             [r["max_abs_err"] for key, r in bwd.items()
              if key[0] == "K6" and key[1] == "bfloat16"]),
            ("flash_attention_bwd",
             "src/repro_torch/csrc/flash_attention_bwd.cu",
             "src/repro/models/layers.py:102",
             bwd[("K3", "gemma3-1b", "bfloat16", WINDOW)],
             [r["max_abs_err"] for key, r in bwd.items()
              if key[0] == "K3" and key[2] == "bfloat16"])):
        fwd = name.removesuffix("_bwd")
        e = dict(entry(fwd, source, replaces, rec, max(errs)), name=name)
        e.update(launches=launches.get(f"{fwd} bwd_launches", 0),
                 split={k: {"us": us, "blocks": n}
                        for k, (us, n) in rec["split"].items()},
                 tpu_kernel=None,
                 note=f"the gradient of the JAX function at {replaces} "
                      "(no TPU kernel had a backward)",
                 rel_l2_vs_fp32=max(r["rel_l2"] for key, r in bwd.items()
                                    if key[0] == ("K6" if "linear" in name
                                                  else "K3")
                                    and "bfloat16" in key))
        kernels.append(e)
    # the launches under autograd (5e, 5g), and K3's in 5g by build
    for e in kernels:
        if e["name"] in ("flash_attention", "linear_attn_chunk"):
            e["grad_launches"] = launches.get(f"{e['name']} grad_launches", 0)
    k3_entry = next(e for e in kernels if e["name"] == "flash_attention")
    k3_entry["launches_5g"] = {f"{arch} {build}": K3_LAUNCHES_5G[arch]
                               for arch, build in K3_BUILDS_5G.items()}
    # K1 and K2 past 64 rows per kv head, one row each per model: launches
    # of that model's paged serve (K1) and paged-vs-dense check (K2)
    for arch in ROW_CASES:
        for kname, key, replaces, count in (
                ("tree_attention_paged", "K1",
                 "src/repro/kernels/tree_attention/kernel.py:63",
                 per_arch[arch]["tree_attention_paged"]),
                ("tree_attention_dense", "K2",
                 "src/repro/kernels/tree_attention/kernel.py:47",
                 per_arch[arch]["pair_k2"])):
            rec = rows[(arch, key, "bfloat16")]
            e = entry(kname, "src/repro_torch/csrc/tree_attention_paged.cu",
                      replaces, rec, rec["max_abs_err"])
            e.update(name=f"{kname}@{arch}", launches=count,
                     case=f"{arch} heads, {rec['rows']} rows per kv head "
                          f"({rec['groups']} row groups), T=16",
                     bound_per_group_ms=rec["bound_per_group_ms"])
            kernels.append(e)
    # K1, K2 and K3 at zamba2-1.2b's shared block (head dim 64, G = 1):
    # K1 and K3 launches of its phase 5-6 serves, K2 of its pair check
    for kname, rec, replaces, count, err in (
            ("tree_attention_paged", zk[("K1", "bfloat16")],
             "src/repro/kernels/tree_attention/kernel.py:63",
             per_arch[ZAMBA2]["tree_attention_paged"],
             zk[("K1", "bfloat16")]["max_abs_err"]),
            ("tree_attention_dense", zk[("K2", "bfloat16")],
             "src/repro/kernels/tree_attention/kernel.py:47",
             per_arch[ZAMBA2]["pair_k2"],
             zk[("K2", "bfloat16")]["max_abs_err"]),
            ("flash_attention", zk["K3"][(ZAMBA2, "bfloat16", 1536, 0)],
             "src/repro/kernels/flash_attention/kernel.py:23",
             per_arch[ZAMBA2]["flash_attention"],
             max(r["max_abs_err"] for key, r in zk["K3"].items()
                 if key[1] == "bfloat16"))):
        source = ("src/repro_torch/csrc/flash_attention.cu"
                  if kname == "flash_attention"
                  else "src/repro_torch/csrc/tree_attention_paged.cu")
        e = entry(kname, source, replaces, rec, err)
        e.update(name=f"{kname}@{ZAMBA2}", launches=count,
                 case=("32 q over 32 kv heads, D=64, S=1536, window 0"
                       if kname == "flash_attention" else
                       f"32 q over 32 kv heads, D=64, chain T={ZAMBA2_T}"))
        kernels.append(e)
    # K3 at hubert-xlarge's encoder (16 over 16 heads of 80, both ways):
    # the launches of phase 5d's counted forward
    e = entry("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention/kernel.py:23",
              hk[("bfloat16", 1536)],
              max(r["max_abs_err"] for key, r in hk.items()
                  if key[0] == "bfloat16"))
    e.update(name=f"flash_attention@{HUBERT}", launches=hubert["launches"],
             case="16 q over 16 kv heads, D=80, S=1536, bidirectional",
             rel_l2_vs_fp32=max([hubert["rel"]] + [
                 r["rel"] for r in hk.values() if "rel" in r]))
    kernels.append(e)
    kernels += f32_entries(entry, f32_main, k3, k3_mla, k3_chunk, zk, hk, bwd)
    kernels += tree_f32_entries(entry, tree_f32_counts, k1s, k4, k2s)
    kernels += k6_f32_entries(entry, k6_f32, k6, bwd, k6_draws)
    kernels.append(k5_f32_entry(entry, k5_f32, k5))
    kernels += padded_entries(entry, padded)
    log(json.dumps({"kernels": kernels}))
    log(f"[time] total {time.perf_counter() - t_start:.0f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
