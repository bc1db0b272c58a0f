#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero when it fails:

  1. device  — the card's name and power limit (``nvidia-smi``),
  2. build   — the prefill, matmul, flash-attention and SSD-scan kernel
               libraries from ``src/repro_torch/kernels/{prefill,matmul,
               flash_attention,mamba_scan}/csrc`` (one nvcc each, sm_90a, all
               started together), with the build seconds,
  3. kernels — K1 (``prefill_flash``) and K2 (``cache_cast``) held against
               their plain torch versions on the card: K1 through
               ``prefill_attention``, the op the model calls, at every
               bucket the serve phase pads to (and 48, 768, head_dim 16),
               and in bf16 at tile edges (S of 1, 17, 63, 65, 127 and 129,
               group 1, 2, 4 and 8, D 16 to 128), and at the new serves'
               groups (1: 16 heads, 4: 32 over 8, 48: one KV head) and the
               remaining configs' (Qwen2-VL's group 8, 32 q heads, D 128;
               SeamlessM4T's group 1, D 64) (S 129 and 512, bf16 and f32,
               timed at S 512); K1's bf16 tensor-core
               kernel's registers, spills and shared memory from the
               build's ``-Xptxas -v`` report and its ``HMMA`` count from
               ``cuobjdump -sass`` (no spill, HMMA > 0), and its f32 kernel's
               (K4's f32 forward body; no spill); then both timed at the
               serve path's shapes beside the plain version, PyTorch's own
               call for the same function, and the card's bound, and K1 in
               f32 at phase 4's shape beside SDPA in f32, and K2 also at k
               and v (2, 32768, 128), 100.7 MB, bit for bit ``.to``, its
               registers and spills for every pair of types (no spill) (K1
               and SDPA, K2 and ``.to`` also by their kernels' device time,
               ``device_ms``, taken in phase 15, after the serve phases),
  4. model   — full-width Qwen2-1.5B in f32 from ``Model.init(seed)``:
               prefill logits on the kernel path against ``use_pallas=False``
               for one prompt of length 100 (bucket 128), greedy first tokens
               equal; the cache is stored in bf16, so K2 runs on this path,
  5. serve   — full-width bf16 Qwen2-1.5B serving 8 seeded requests through
               ``Cluster("fast=2.0^prefill,slow=1.0x4^decode").serve``: every
               request completes with 16 tokens, 8 KV handoffs, and K1 runs
               once per layer per prefill (8 x 28 launches); the wall time
               is split into the engines' prefill, insert and step calls
               and the control plane around them.  The inputs K1 got on
               this path, one set per bucket, are kept and K1 is held
               against its plain version on them afterwards.  Every serve
               phase runs the engines' compiled route (``DecodeEngine``'s
               decode step and each prefill bucket captured as CUDA graphs
               from their second call, ``serve/compiled.py``); phases 5,
               14, 17 and 22 serve their requests once more through
               ``compile_steps=False`` engines, the model loaded (after the
               compiled route in 5 and 17, before it in 14 and 22): every
               request's tokens and the launches equal (else fail); the
               first three decode steps' logits (warm-up, capture +
               replay, replay) against the eager route's, bitwise
               expected; host ms a decode step (the mean, and the median
               from each engine's fourth step on) and a prefill, tokens/s,
               graphs captured, capture seconds and graph-pool bytes.
               Phases 5 and 14 then prefill one prompt three times on one
               engine (eager, capture + replay, replay): logits and caches
               bitwise equal, K1 (K5) counted 3 x layers; phase 5 takes
               each route's busy share from a profiled repeat of it (14
               and 17 the compiled route's),
  6. matmul  — K3 (``matmul``) through ``kernels.matmul.ops.matmul`` against
               its plain version in f32 and bf16 at the shapes of the
               reference's kernel sweep and the paper path's (2, 1000, 1000),
               (1000, 1000, 1000) and (2, 4096, 4096); every 2-row slice of a
               1000-square product and 64 seeded row offsets at n = 4096
               equal K3's full product bit for bit (the slices run the
               8-column strip tile for M <= 16, the full products the
               64 x 64 tile); both tiles' registers, shared memory and
               spills from the build's ``-Xptxas -v`` report (a spill
               fails); K3 timed at the three path shapes beside its plain
               version, ``torch.matmul`` and the card's bound (device times
               in phase 15),
  7. paper   — the quickstart on the card: the paper's 9-machine fleet
               multiplies two 1000-square f32 matrices three times through
               ``Cluster.simulate(MatmulJob(..., matmul_fn=ops.matmul))``:
               exactly 3 x 500 K3 launches, the product bitwise equal to
               K3's single-device product and within the f32 tolerance of
               ``torch.matmul``; again under ``kill:sp1@25%`` (bitwise
               equal) and once at n = 4096 (2048 launches); the shares, the
               host wall split, the card's busy share (a repeat of each run
               under ``torch.profiler``: kernel time over wall time), and
               the Fig-3 table,
  8. wallclock — the bench_wallclock flow: on fleet 4:3:2:1 the sim's
               predicted speedup against the speedup the wall-clock backend
               measures on the card, steady and under ``halve:w0@50%``
               (within 0.35, the halved run below the steady one), the
               unit op on the backend's compiled route (CUDA graphs, the
               reference's ``jax.jit``); then the unit op's two routes at
               sides 2048 and 256, with a worker stream and without: a
               grain's chain of 37 ops (after a first grain, which
               captures a worker's own chain) is 37 graph launches,
               bitwise the eager route's (``compile_op=False``), and each
               route's calibrated ``unit_s``; then a 1000-square
               ``MatmulJob`` on that backend (``wallclock[1d]``, bitwise
               equal to K3's product),
  9. serve under the wall-clock backend — 4 requests of 8 new tokens through
               phase 5's fleet with ``backend="wallclock"``,
 10. K4      — flash attention's forward (``flash_attention_fwd``) and its two
               backward kernels (``flash_attention_bwd_dq``,
               ``flash_attention_bwd_dkdv``) through the autograd function the
               model calls, against the plain version (forward) and autograd
               through it (backward), f32 and bf16, causal and not, at the
               reference's kernel-test shapes, Sq != Skv, ragged S, the x30
               logits and the training path's q (16, 1024, 128), k/v (2,
               1024, 128), then at tile edges (Sq and Skv of 1, 17, 63, 65,
               127 and 129, group 1, 2, 4, 8 and 48, D 16 to 128; their bf16
               gradients against autograd through the plain version in f32
               on the same values); the backward bitwise equal over two
               runs; the kernels' registers, spills and shared memory from
               the build's ``-Xptxas -v`` report and their ``HMMA`` count
               from ``cuobjdump -sass``, bf16 (forward, dQ, dK/dV on the
               tensor cores, the reduction) and f32 (``flash_fwd_f32_kernel``
               on the CUDA cores, the body K1's f32 kernel shares,
               ``flash_dq_tf32_kernel`` and
               ``flash_dkdv_tf32_kernel`` with three TF32 products a
               product, ``flash_dkdv_reduce_kernel<float>``): a spill fails,
               so does no HMMA in a tensor-core kernel; each kernel timed at
               the path's shape beside the plain version, PyTorch's SDPA
               (forward; backward) and the card's bound, in bf16 and in f32
               beside SDPA in f32 with TF32 off (the f32 backward's bound:
               its score chain at 67 TFLOP/s, its other products three times
               over at the TF32 rate; also every operation at 67 TFLOP/s as
               earlier runs counted; device times in phase 15, dK/dV's with
               its reduction); then at SeamlessM4T-medium's shapes (16
               heads of 64, non-causal: Sq = Skv = 512, and Sq 64 over Skv
               512, the training cross-attention's), bf16 and f32, forward
               and backward against the plain version and autograd at
               GRAD_TOL, timed beside the plain version, SDPA and the bound;
               and so at Qwen2-VL-7B's training shape (q (32, 1024, 128)
               over k/v (4, 1024, 128), causal, bf16),
 11. train   — full-width Qwen2-1.5B training at seq 1024: one f32 grain's
               loss and gradients on the kernel path, compiled (the first
               call eager, the second captured as a CUDA graph and
               replayed, the third replayed: the three bitwise equal),
               against ``use_pallas=False`` (loss rtol 1e-4, each gradient
               leaf within relative Frobenius error 1e-3); the launcher's
               HDP flow in bf16, ``Cluster("4:3:2:1").train`` for 3 steps of
               8 grains under ``halve:pod0@1:25%`` on the compiled route
               (the grain gradient and the AdamW update captured and
               replayed), then again on the eager route
               (``compile_steps=False``): losses and every parameter leaf
               (a SHA-256 per leaf) equal on both routes; per route losses
               finite, shares, migrations, sim-clock step times, the host
               wall split into grain gradients, combine, AdamW and control
               plane, host ms of each warm-up, capture and replay, graphs
               captured, capture seconds and pool bytes, peak memory, the
               card's busy share and its 12 costliest kernels in a profiled
               fourth step (after an unprofiled third of the same trainer);
               the same 2 steps static and adaptive, compiled, with
               bitwise-equal parameters (a SHA-256 per leaf); 2 steps on
               the wall-clock backend, compiled.  K4's launches equal the
               prediction in every run, the replays' counted as the eager
               calls': per grain, 2 x 28 forwards (forward and remat
               recompute) and 28 of each backward kernel,
 12. K5      — the SSD chunked scan (``ssd_scan``) through ``ssd``, the op
               the model calls, against the same op with K5's plain version
               in its place and against the sequential oracle, f32 and bf16,
               at the reference's kernel-test shapes, chunks 16/32/64/96,
               S = 90 and dt x 100 (finite); at the serving path's shape
               (xdt (80, 512, 64), B/C (1, 512, 128), chunk 256) checked and
               bitwise equal over two runs (f32 also against the sequential
               oracle); both kernels at the edges of their tiles (S of 1 to
               257, P of 8 to 72, N of 4 to 128, groups of 1 to 80 heads;
               f32 also P 10 and N 7), their own output against the plain
               version and the sequential oracle; their registers, spills
               and shared memory and the bf16 kernel's ``HMMA`` count (no
               spill, HMMA > 0 in bf16); timed at the path's shape beside
               its plain version and the card's bound (no PyTorch call
               computes the scan, so there is no library time; device time
               in phase 15), and its f32 kernel (``ssd_scan_f32_kernel``,
               f32 FMAs) at phase 13's shape (xdt (80, 128, 64), B/C (1,
               128, 128), chunk 256); at Jamba's shape (xdt (128, 512, 64),
               B/C (1, 512, 16), chunk 256; N 16 pads to 32 in bf16) in
               bf16 and f32 against its plain version, bitwise over two
               runs, bf16 timed; its backward (``ssd_scan_bwd``: five
               kernels a call, ``ssd_bwd_sums_*``, ``ssd_bwd_pass_kernel``,
               ``ssd_bwd_local_*``, ``ssd_bwd_dla_kernel`` and
               ``ssd_bwd_reduce_kernel``, ``*`` ``mma_kernel`` in bf16 and
               ``kernel`` in f32) against its plain version
               (``ssd_scan_bwd_plain``) at GRAD_TOL in bf16 and f32, at
               Mamba2-2.7B's training shape (xdt (80, 1024, 64), B/C (1,
               1024, 128), chunk 256; two draws, the second with the final
               state's gradient), Jamba's, a ragged last chunk, three
               groups, la down to -50 a step (f32 also within relative
               Frobenius error 1e-4 of the f64 recurrence's gradients), and
               the chunk-parallel grid's edges (16 chunks, 264 head rows,
               P 32 and 48, N 16, 64 and 100, chunks of 64 and 128, up to 8
               groups), bitwise over two runs in each dtype, its kernels'
               registers, spills, shared memory and HMMA count (no spill;
               HMMA in the bf16 kernels, none in the f32 ones), timed at
               the training shape beside its plain version and the bound
               (``k5_bwd_bound_ms``; no PyTorch call computes the scan's
               gradient; device time, and each kernel's, in phase 15),
 13. mamba model — full-width Mamba2-2.7B in f32 from ``Model.init(seed)``:
               prefill of one prompt of length 100 (bucket 128) on the kernel
               path against ``use_pallas=False``: logits within the f32
               tolerance, greedy first tokens equal, every period's final
               SSM state within tolerance, 64 K5 launches,
 14. mamba serve — full-width bf16 Mamba2-2.7B through phase 5's fleet:
               phase 5's prompt lengths (tokens drawn from its vocabulary),
               16 new tokens each: every request completes with 16 in-vocab
               tokens, 8 handoffs, K5 launched exactly 8 x 64 times; the
               host wall split, tokens/s and the card's busy share in a
               profiled repeat; K5 held against its plain version on the
               inputs it got from each bucket,
 27. mamba train — Mamba2-2.7B trained on the kernel route (K5's forward
               twice a layer a grain, forward and remat recompute, and its
               backward once): (b) one f32 grain at its published widths cut
               to MAMBA_TRAIN_F32_LAYERS layers against ``use_pallas=False``
               (loss rtol 1e-4, every gradient leaf within GRAD_TOL); (c)
               phase 11.2's flow on bf16 Mamba2-2.7B (d_model 2560, 80 heads
               of 64, d_state 128) whole (MAMBA_TRAIN_LAYERS, 64 layers):
               3 steps of 8 grains of 1024 tokens under
               ``halve:pod0@1:25%``, compiled then eager, losses, every
               parameter leaf and the launches equal, tokens/s, host ms of
               a replayed grain, the busy share of a steady step; each
               route's peak (at most MAMBA_TRAIN_PEAK_GB), graph pools, a
               gradient tree's bytes and the most grains waiting at once
               (run after phase 14),
 16. moe model — Qwen1.5-MoE (``qwen2-moe-a2.7b``) in f32 at its published
               widths, depth cut to 4 of 24 layers (14.3 B parameters are
               57 GB in f32), from ``Model.init(seed)``: prefill of one
               prompt of length 100 (bucket 128) on the kernel path (K1 in
               f32, the cache stored in bf16 by K2) against
               ``use_pallas=False``: logits within the f32 tolerance, the
               bf16 caches within the bf16 tolerance of the plain route's,
               greedy first tokens equal, K1 and K2 once a layer; one
               layer's ``apply_moe`` with capacities that drop nothing
               against ``apply_moe_dense`` within the f32 tolerance,
 17. moe serve — full-width bf16 Qwen1.5-MoE, all 24 layers (60 routed
               experts of 1408, top-4, a shared expert of 5632; the router
               in f32), through phase 5's fleet, prompt lengths and token
               budget: every request completes with 16 in-vocab tokens, 8
               handoffs, K1 once a layer a prefill (8 x 24, group 1); the
               host wall split, tokens/s, the card's busy share in a
               profiled repeat; K1 held against its plain version on the
               inputs it got,
 18. moe capacity — the flow of ``examples/moe_homogenized.py`` on one
               full-width bf16 Qwen1.5-MoE layer and 4096 tokens: uniform
               capacities, capacities homogenized over the example's expert
               perfs (repeated over the 60 experts) and over a skewed
               router's observed top-1 load (``capacity_per_expert``); for
               each, the assignments dropped and the largest over the
               smallest expert finish time (capacity over perf, or over the
               observed load); ``apply_moe``'s device time under each in
               phase 15; homogenized capacities must even out the finish
               times,
 19. qwen3 serve — full-width bf16 Qwen3-8B (36 layers, ``qk_norm``, K1 at
               group 4) through phase 5's fleet, as phase 17,
 20. granite cut — Granite-34B in bf16 at its published widths, depth cut
               to 16 of 88 layers (93.9 GB whole): prompts of 100 and 500
               tokens prefilled into one ``DecodeEngine`` and decoded to 8
               tokens each; K1 at group 48 (one KV head for 48 q heads)
               once a layer a prefill, held against its plain version on
               the inputs it got,
 21. jamba cut — Jamba-v0.1 in bf16 at its published widths, depth cut to
               one period of 8 layers (102.9 GB whole): as phase 20, with
               K5 (128 heads of 64, N 16) once a mamba layer a prefill and
               K1 (group 4) once, each held against its plain version on
               the inputs it got,
 22. deepseek cut — DeepSeek-V2 in bf16 at its published widths (MLA:
               128 heads, q_lora 1536, kv_lora 512, rope 64; 160 routed
               experts top-6 and 2 shared), depth cut to the dense first
               layer and 4 MoE layers (472 GB whole), through phase 5's
               fleet, prompt lengths and token budget: 16 in-vocab tokens a
               request, 8 handoffs of MLACaches (16 cache writes: the
               prefix layer and the stacked periods), no kernel launched
               (MLA is plain einsums, as in the reference); the handoff's
               bytes a token against a GQA cache of the same heads; the
               absorbed decode's logits at position 100 against the
               decompressed prefill's over 101 tokens: printed in bf16 at
               this cut, and held within the f32 tolerance (greedy tokens
               equal) in f32 at the published widths cut to the dense first
               layer and one MoE layer,
 23. qwen2-vl — Qwen2-VL-7B (embeds input, M-RoPE): in f32 cut to 4 of 28
               layers, a prefill of seeded embeddings whose position
               streams differ (4 text, an 8 x 8 image block, text) on the
               kernel path (K1 in f32, group 8, D 128, once a layer)
               against ``use_pallas=False``, logits within the f32
               tolerance and greedy first tokens equal; then whole in bf16
               (28 layers): four prompts prefilled (K1 once a layer each,
               held against its plain version on the inputs it got) and 16
               batched decode steps with embeds input, tokens/s,
 24. seamless — SeamlessM4T-medium (enc-dec, 12 + 12 layers, LayerNorm):
               in f32 at full width and depth, ``encode`` of 512 seeded
               frames (K4 non-causal once an encoder layer) and a prefill
               of a 100-token target prompt (K1 at group 1, D 64, once a
               decoder layer) against ``use_pallas=False``: encoder memory,
               logits and cross caches within the f32 tolerance, greedy
               first tokens equal; then in bf16 four requests, each a
               prefill (which encodes) into a lane of one cache from
               ``init_cache(4, max_seq, cross_seq=512)``, then 16 batched
               decode steps; K4 (forward and backward) and K1 held against
               their plain versions on the inputs they got, tokens/s,
 28. train single — bf16 training through ``train_single`` (the
               launcher's ``--mode single``) at the published widths from
               ``init(SEED)``: Qwen2-VL-7B cut to QWEN2VL_TRAIN_LAYERS on one
               1024-token sequence of embeddings with M-RoPE streams that
               differ; SeamlessM4T-medium whole on the launcher's batch (512
               frames, 512 target tokens) and 64 targets over the same
               frames, in turn (two graphs); DeepSeek-V2 at its dense first
               layer and one MLA + MoE layer on tokens.  First the f32 cuts
               (Qwen2-VL at 4 layers, SeamlessM4T at 4 + 4 at both shapes):
               one step's loss and every gradient leaf on the kernel route
               within GRAD_TOL of ``use_pallas=False``.  Then each bf16 model
               on the compiled route and the eager route in turn, 3 steps
               and one more of each batch shape (DeepSeek: 3 steps, eager
               first, each route a process of its own): losses, every
               parameter leaf
               (SHA-256) and K4's launches equal on both routes, K4's
               launches as predicted (forward twice, dQ and dK/dV once a
               layer a step; none on DeepSeek's path); tokens/s, a steady
               step's seconds, the peak, the graph pool, K4's share of a
               steady compiled step's kernels (a profiled step); K4 held at
               TOL / GRAD_TOL against its plain version on every input shape
               the paths gave it.  A DeepSeek route that runs out of the
               card's memory prints the allocation it stopped at,
 25. distribution — the sharded steps (``sharding/apply.py``) on a (1, 1)
               ("data", "model") mesh over NCCL at world size 1: (a) one
               ``fsdp_tp`` train step of full-width bf16 Qwen2-1.5B on
               phase 11's batch (8 grains of one 1024-token sequence)
               against ``make_train_step`` from the same init, loss,
               parameters and moments bitwise equal (SHA-256 per leaf),
               seconds and peaks of both; (b) a prefill of four prompts
               (K1 once a layer) and 16 decode steps, sharded against
               unsharded, logits and caches bitwise equal, tokens equal;
               (c) phase 11's f32 grain under ``remat_policy="dots"``
               against the default policy, within the f32 tolerance, both
               peaks; (e) two HDP steps of phase 11's fleet reading
               ``MemmapSource`` grains from a ``.npy`` the phase writes,
               each grain the file's window; then, in processes of their
               own and all at once, (d) the dry run (``launch/dryrun.py``,
               a fake process group of 256 ranks) of Qwen2-1.5B at
               decode_32k and of (a)'s step on one device, its predicted
               peak beside (a)'s measured one, (f) the train CLI under
               ``--tuned``, and (g) the four examples, train_hetero cut
               to 50 of its 200 steps (EXAMPLE_ARGV)
               (``chip_smoke.py --example <name>``: the example's report,
               K4's forward, dQ and dK/dV against their plain versions on
               the inputs the example gave K4, at TOL / GRAD_TOL, then its
               kernels' launches);
               phases 27, 16-24, 28, 25 and 26 run in that order, after
               phase 14 and before phase 15; each frees its model at its end
               and prints its peak memory, and phases 22-28 their seconds,
 26. tensor-parallel — the sharded steps tensor-parallel over the mesh's
               ``model`` axis, at model 2 and 4 on a (1, m) mesh, the ranks
               in processes of their own (``chip_smoke.py --tp-rank``): on
               one card over ``launch/shared_pg.py``'s backend ``"shared"``
               (each group's mailboxes in the card's memory, opened through
               CUDA IPC; ``shared_reduce_kernel`` and
               ``shared_gather_kernel`` read them on each rank's stream;
               each rank prints its mailbox bytes, at most 256 MiB, and
               per-op calls, bytes, host seconds and chunks; before (d) at
               model 4 a probe times the all-gather the staged backend
               took 1.15-1.38 s for, 0.54 GB a rank over pairs of ranks,
               best of 3, and the two kernels at one chunk against their
               plain versions; a ``[transport]`` line gives them in the
               kernels line's keys); over NCCL where
               there are m cards; the backend and world size printed.
               (a) f32 Qwen2-1.5B cut to 4 of 28 layers,
               ``fsdp_tp``, its cache in bf16: one train step of phase 11's
               f32 grain against ``make_train_step`` from the same init
               (loss, every parameter leaf and both moments within the f32
               tolerance), a prefill of four prompts and 16 decode steps
               (logits within the f32 tolerance, tokens equal); (c) (a)'s
               train step under ``seq_parallel``, the same checks; at model
               2 also (b) the whole model in bf16: phase 11's (8, 1024)
               batch through one train step and the four prompts with 16
               decode steps against phase 25's unsharded steps: the loss
               within the bf16 tolerance, the first step's logits within
               relative Frobenius error 2e-2 (elementwise, two unsharded
               bf16 routes, kernel and plain, already differ past the bf16
               tolerance at 28 layers; both spreads printed), the tokens
               reported; K4 and K1 launched at the local heads (q (8, S,
               128) over one KV head at model 2, (4, S, 128) at model 4)
               and held against their plain versions on the inputs they
               got; seconds and peaks a rank (not a tensor-parallel speed
               where the ranks share a card); then the MoE and Mamba layers
               split, each bf16 case held to an unsharded run the
               main process takes first and frees (the ranks then init the
               model one at a time, each keeping its shards): (d)
               Qwen1.5-MoE expert-parallel at model 2 and 4 (30 and 15
               experts a rank), whole in bf16 at model 2 (on four ranks
               (j) serves it whole) (the four prompts, 4 decode
               steps, capacity drops as configured: at the first MoE
               layer at most 5 % of the prefill's tokens routed to other
               experts than the unsharded's, each layer's count printed
               beside the unsharded plain route's; the prefill's and the
               first step's logits within relative Frobenius error 0.5,
               as the routes' recorded spread at full depth allows:
               ``scripts/bf16_depth_spread.py``; tokens reported) and in f32
               cut to 4 of 24 layers (1 at model 4) (the prompts and 4 decode steps
               within the f32 tolerance, tokens equal, and one train step
               of phase 11's f32 grain: the loss, every parameter leaf and
               both moments, the router's printed, within the f32
               tolerance); (e) the same f32 checks of Qwen1.5-MoE cut to
               one layer at model 8, expert-TP (60 experts do not divide
               8: each rank every expert at 176 of 1408); (f) Mamba2-2.7B
               at model 2 and 4 (40 and 20 heads a rank, K5 on them),
               in bf16 cut to 2 of 64 layers, where two unsharded routes
               still agree, on phase 13's prompt and 4 decode steps, held
               as (b) (relative Frobenius error 2e-2), the first step's
               tokens among the unsharded step's 5 most likely, and in f32
               cut to 4 layers (K5's f32 kernel, and its backward in the
               train step: twice K5's forward and once its backward a
               layer on each rank's heads); (g) Jamba cut to one period at
               model 2, every
               layer split, bf16 as (d); (h) DeepSeek-V2 in f32 at model 2
               and 4 (64 and 32 MLA heads a rank, the latent cache split
               on its sequence and never gathered: no cache view in the
               decode), cut to its dense first layer and one MoE layer for
               the four prompts and 4 decode steps, and to the dense
               layer alone (zero periods) for one train step of phase 11's
               f32 grain, each against the unsharded step (logits, loss,
               every leaf and both moments within the f32 tolerance,
               tokens equal); (i) SeamlessM4T-medium's cross-attention
               split (8 and 4 heads a rank, the cross cache on its
               sequence, never gathered): in f32 cut to 4 encoder and 4
               decoder layers, the four prompts over 512 seeded frames
               each and 4 decode steps, and one train step of 64 target
               tokens over 512 frames (K4 forward, dQ and dK/dV on each
               rank's cross heads, non-causal, Sq 64 over Skv 512, held
               against the plain version), the f32 checks of (h); at model
               2 also whole in bf16, held as (f) (relative Frobenius error
               2e-2: on an H100 the unsharded routes differ by 8.0e-3 at
               its 12 layers, ``scripts/bf16_depth_spread.py``); (j)
               Qwen1.5-MoE on a (data 2, model 2) mesh of the four ranks
               (world 4 only), expert-parallel, each data rank half of
               every expert's capacity slots and the shared expert on its
               own rows: whole in bf16 (the four prompts, 2 a data rank,
               and TP_DATA_DECODE_STEPS decode step) held as (d) against
               (d)'s unsharded run, and in f32 cut to 4 layers (the prompts and 4 decode
               steps, and one train step of two of phase 11's f32 grains,
               one a data rank, held as (d)'s); the serves under the
               ``tp`` policy (no weight gathered over the data axis
               through the host), the train step under ``fsdp_tp``;
               each rank's routed and
               shared expert FLOPs in the f32 prefill (FlopCounterMode)
               printed beside (d)'s at (1, 2), each exactly half; K5 held
               against its plain version on the inputs each rank gave it;
               ((d)-(j) decode TP_DECODE_STEPS steps, (a)-(c) 16);
               then K1 and K4 in bf16 at model 2's local heads, K1 (bf16) and K4
               (f32) at Qwen1.5-MoE's, K5 (bf16) at Mamba2-2.7B's, K1
               (bf16) at SeamlessM4T's decoder and K4 (bf16, f32) at its
               cross-attention's local heads timed beside their plain
               versions, SDPA and the bound,
 15. device  — each kernel's device time (the profiler's kernel durations)
               beside PyTorch's call for the same function: K1 and SDPA at
               phase 3's sweep and in f32 at phase 4's shape, K2 and
               ``.to`` at both shapes, K3 and ``torch.matmul`` at the three
               path shapes, K4's kernels in bf16 and f32 and SDPA's forward and
               backward, K5 in bf16 and in f32 at phase 13's shape, K1 at
               the new groups and the remaining configs' shapes, K4 at
               SeamlessM4T's shapes in bf16 and f32 beside SDPA's forward
               and backward, K5 at Jamba's shape, ``apply_moe`` under
               phase 18's three capacity sets, K1 and K4 at phase 26's
               local heads (Qwen2-1.5B's, Qwen1.5-MoE's and
               SeamlessM4T's, K4 at its cross-attention's), K5 at its
               Mamba2-2.7B local heads, K5's backward at the training
               shape in bf16 and f32; after
               every serve phase, so
               no profiler session of these precedes phases 5 and 14, and
               in a process of its own (``chip_smoke.py --device-times``,
               seeded inputs of the same shapes).  Every profiler session
               starts its launches 20 ms in (``PROFILE_LEAD_S``): the
               profiler drops device events stamped before the session
               began, and CUPTI's stamps read early, the more so the
               longer a process has loaded the card.

Phases 4, 5, 7, 8, 9, 11, 13, 14, 16, 17, 19-26, 27 and 28 are the main path:
the kernels' launch counts are set to 0 just before each of their runs and
read just after it; the ``kernels`` line gives each kernel's launches in all
and by run.  A line before the card's holds the whole run's wall time.  The
next-to-last line is the ``kernels`` JSON object; a line before it holds the
card's name and power limit; the last line is ``{"ok": true, "device":
{...}}``.  Without CUDA, or without the repository's ``src/repro_torch``
beside this file, it exits with code 2 and prints no result.  Imports
neither JAX nor the JAX package.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import hashlib
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

#: H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and ops/s by type
#: (``tf32``: the tensor cores' TF32 rate).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
                  "tf32": 495e12}

TOL = {"bfloat16": (2e-2, 2e-2), "float32": (5e-4, 5e-5)}   # (rtol, atol)
#: K4's gradients against autograd through the plain version: f32 loosened
#: from the forward's 5e-4 / 5e-5 (the backward sums 2-3 products per
#: element in another order than autograd does); bf16 as the forward.
GRAD_TOL = {"bfloat16": (2e-2, 2e-2), "float32": (1e-3, 1e-4)}
SEED = 0
N_LAYERS = 28
#: The training phase: grains of one 1024-token sequence, 8 grains a step.
TRAIN_SEQ = 1024
TRAIN_GRAINS = 8
K4_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkdv")
#: K4's launches per grain of the training path, by kernel: per layer the
#: forward runs twice (forward, then its recompute under remat) and each
#: backward kernel once.
K4_PER_GRAIN = {"flash_attention_fwd": 2 * N_LAYERS,
                "flash_attention_bwd_dq": N_LAYERS,
                "flash_attention_bwd_dkdv": N_LAYERS}
#: K4's device kernels by dtype, by name: in bf16 the forward, dQ and dK/dV
#: on the tensor cores; in f32 the forward on the CUDA cores (the body K1's
#: f32 kernel shares), dQ and dK/dV
#: with their products on the tensor cores as three TF32 products; in both
#: dK/dV per q head, then the sum over the group into the dtype.
K4_BF16_KERNELS = ("flash_fwd_mma_kernel", "flash_dq_mma_kernel",
                   "flash_dkdv_mma_kernel", "flash_dkdv_reduce_kernel")
K4_F32_KERNELS = ("flash_fwd_f32_kernel", "flash_dq_tf32_kernel",
                  "flash_dkdv_tf32_kernel", "flash_dkdv_reduce_kernel")
#: K1 in f32 at phase 4's shape (bucket 128, Qwen2-1.5B's 16 padded q heads
#: over 2 KV heads, D 128): (q heads, KV heads, S, D).
K1_F32_SHAPE = (16, 2, 128, 128)
#: K5 in f32 at phase 13's shape (bucket 128, Mamba2-2.7B's 80 heads of 64,
#: one group of N 128): (heads, groups, S, P, N, chunk).
K5_F32_SHAPE = (80, 1, 128, 64, 128, 256)
#: K2 at a long prompt's shape, where the bytes outweigh a launch: k and v
#: (2 KV heads, 32768 tokens, D 128), f32 -> bf16, 100.7 MB moved.
K2_LARGE_SHAPE = (2, 32768, 128)
#: Host seconds between the start of a profiler session and the first
#: launch it must record.  The profiler drops device events stamped before
#: its session began, and the card's kernel timestamps, brought to the
#: host's clock by CUPTI, read early: by up to a millisecond in a young
#: process, by tens of milliseconds after a minute of load
#: (scripts/profiler_probe.py).  Every session here starts its launches
#: this long after it, in a young process for the device times (phase 15).
PROFILE_LEAD_S = 0.02
#: Bytes of a leaf that ``leaf_digests`` hashes as one piece.
DIGEST_PIECE = 1 << 28
#: Milliseconds of calls a ``time_ms`` loop holds at most (at 20 calls a
#: loop, every kernel of the port up to 1 ms a call).
TIME_LOOP_MS = 20.0
#: Side of the wall-clock backend's unit op ``tanh(h @ x)`` on the card: at
#: 2048 one f32 product is about 17 GFLOP, far above a launch's cost, so the
#: measured chains are device time (the default 96 is sized for a CPU).
WALLCLOCK_SIDE = 2048
#: The unit op's two routes timed side by side (phase 8): at WALLCLOCK_SIDE,
#: where the product dominates, and at this side, where launches do; each
#: calibrated over UNIT_OP_REPS ops, and the routes' chains of
#: UNIT_OP_CHAIN ops compared bit for bit.
WALLCLOCK_SMALL_SIDE = 256
UNIT_OP_REPS = 200
UNIT_OP_CHAIN = 37
#: K1 at the new serves' groups, bf16 at S = 512, D 128: (q heads, KV
#: heads) of Qwen1.5-MoE (group 1), Qwen3-8B and Jamba (group 4) and
#: Granite-34B (group 48).
K1_GROUP_SHAPES = ((16, 16), (32, 8), (48, 1))
#: K5 at Jamba's shape: 128 SSD heads of 64 on one group of N 16 (padded to
#: 32 in bf16), S = 512 (the largest bucket), chunk 256: (heads, groups, S,
#: P, N, chunk).
K5_JAMBA_SHAPE = (128, 1, 512, 64, 16, 256)
#: K5's backward at Mamba2-2.7B's training shape: 80 heads of 64 on one
#: group of N 128, one TRAIN_SEQ-token grain, chunk 256: (heads, groups, S,
#: P, N, chunk).
K5_BWD_SHAPE = (80, 1, TRAIN_SEQ, 64, 128, 256)
#: K5's backward kernels: the five a call launches at the
#: training shape, in each dtype.
K5_BWD_BUILDS = {
    "bfloat16": ("ssd_bwd_sums_mma_kernel<8>", "ssd_bwd_pass_kernel",
                 "ssd_bwd_local_mma_kernel<8>", "ssd_bwd_dla_kernel",
                 "ssd_bwd_reduce_kernel<bf16>"),
    "float32": ("ssd_bwd_sums_kernel<128>", "ssd_bwd_pass_kernel",
                "ssd_bwd_local_kernel<128>", "ssd_bwd_dla_kernel",
                "ssd_bwd_reduce_kernel<float>")}
#: (heads, groups, S, P, N, chunk) at the edges of K5's backward grid.
K5_BWD_GRID_EDGES = ((2, 1, 4096, 64, 128, 256), (3, 3, 4096, 32, 16, 64),
                     (264, 4, 256, 32, 16, 64), (8, 2, 1000, 48, 64, 128),
                     (160, 8, 300, 64, 100, 128))
#: The Mamba training phase (27): the f32 grain of Mamba2-2.7B at its
#: published widths cut to this many of its 64 layers, and the depth of the
#: bf16 ``Cluster.train`` run: the whole model.  Its peak is the
#: combine's: 5.4 GB of bf16 parameters, 21.6 GB of f32 moments, the folded
#: sum and the grain graph's gradients (5.4 GB each), and 5.4 GB for each
#: grain the combine holds waiting (at most 5 at once under this phase's
#: scenario), 68 GB in all.  Beside it the graph pool reserves 8.4 GB, 19.2
#: GB before each period's gradients went into the stacked gradient as the
#: backward left the period (``models/parallel.py::stacked_periods``) and
#: ``global_norm`` widened a slice at a time, not a stacked leaf (3.4 GB):
#: with those blocks reserved, 64 and 60 layers ran out of memory in this
#: phase (``scripts/mamba_train_depth.py --snapshot`` names the owners).
MAMBA_TRAIN_F32_LAYERS = 4
MAMBA_TRAIN_LAYERS = 64
#: Phase 27's bound on each route's ``torch.cuda.max_memory_allocated``.
MAMBA_TRAIN_PEAK_GB = 75.0
#: Depth cuts at the published widths: Qwen1.5-MoE in f32 (14.3 B
#: parameters are 57 GB in f32) and Granite-34B in bf16 (93.9 GB whole).
MOE_F32_LAYERS = 4
GRANITE_LAYERS = 16
#: The moe_capacity phase: one full-width Qwen1.5-MoE layer in bf16 on
#: MOE_TOKENS tokens, with the expert perfs of examples/moe_homogenized.py
#: (8 experts, a 2.5x spread) repeated over the 60 experts.
MOE_TOKENS = 4096
MOE_EXAMPLE_PERFS = (1.0, 1.0, 0.9, 0.8, 0.7, 0.6, 0.5, 0.4)
#: K1 on the remaining configs' prefill paths, bf16 at S = 512: Qwen2-VL's
#: 28 q heads padded to 32 over 4 KV heads (group 8, D 128) and
#: SeamlessM4T's decoder (16 heads, group 1, D 64): (q heads, KV heads, D).
K1_REMAINING_SHAPES = ((32, 4, 128), (16, 16, 64))
#: K4 at SeamlessM4T-medium's shapes (16 heads of 64), non-causal: the
#: encoder's self-attention over 512 frames and the decoder's training
#: cross-attention of 64 target tokens over them: (Sq, Skv).
K4_SEAMLESS_SHAPES = ((512, 512), (64, 512))
#: K4 at Qwen2-VL-7B's training shape (phase 28): 28 q heads padded to 32
#: over 4 KV heads (group 8), one TRAIN_SEQ sequence, D 128, causal, bf16:
#: (q heads, KV heads, S, D).
K4_QWEN2VL_SHAPE = (32, 4, TRAIN_SEQ, 128)
SEAMLESS_HEADS, SEAMLESS_D, SEAMLESS_FRAMES = 16, 64, 512
#: Depth cuts at the published widths: DeepSeek-V2 in bf16 to its dense
#: first layer and 4 MoE layers (236 B parameters are 472 GB in bf16), and
#: Qwen2-VL's f32 check to 4 of 28 layers.
DEEPSEEK_LAYERS = 5
#: DeepSeek-V2's absorbed decode held against its decompressed prefill in
#: f32 at the published widths, cut to the dense first layer and one MoE
#: layer (21 GB in f32).
DEEPSEEK_F32_LAYERS = 2
QWEN2VL_F32_LAYERS = 4
#: The remaining configs' runs: four prompts of phase 5's lengths, 16
#: decode steps each, batched in one cache.
REMAINING_LENGTHS = (20, 90, 300, 500)
#: The port's examples (``src/repro_torch/examples``), run by phase 25 in
#: processes of their own (``chip_smoke.py --example <name>``).
EXAMPLES = ("quickstart", "serve_hetero", "train_hetero", "moe_homogenized")
#: Cuts of the examples' defaults, to keep the smoke near half its time
#: limit: train_hetero runs 50 of its 200 steps (100 until phase 26 took
#: the MoE and Mamba cases).
EXAMPLE_ARGV = {"train_hetero": ["--steps", "50"]}
# Phase 25's dry run of (a)'s step: the sharded train step of full-width
# Qwen2-1.5B under fsdp_tp at (a)'s batch on a (1, 1) mesh, in a fake
# process group; argv: global batch, sequence length.  A JSON last line.
DRY_RUN_ONE = """
import dataclasses, json, sys
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.dryrun import measure
from repro_torch.launch.mesh import HW, debug_mesh_shape
shape = dataclasses.replace(SHAPES["train_4k"], global_batch=int(sys.argv[1]),
                            seq_len=int(sys.argv[2]))
m = measure(get_config("qwen2-1.5b", sharding_policy="fsdp_tp"), shape,
            debug_mesh_shape(1, 1))
m["compute_s"] = m["flops"] / HW["peak_flops_bf16"]
m["memory_s"] = m["bytes"] / HW["hbm_bw"]
print(json.dumps(m))
"""
SEAMLESS_LENGTHS = (5, 20, 40, 90)
DECODE_STEPS = 16
#: Phase 28: bf16 training through ``train_single`` (the launcher's
#: ``--mode single``) of the configs whose batches are not tokens and of
#: DeepSeek-V2's MLA + MoE layer, each route TRAIN_SINGLE_STEPS steps of
#: one TRAIN_SEQ-token sequence and one more of each batch shape (profiled
#: on the compiled route).  The training state is 12 bytes a parameter:
#: bf16 weights and gradients, two f32 moments (``optim/adamw.py``).
TRAIN_SINGLE_STEPS = 3
#: Qwen2-VL-7B's depth in training: its embeddings and unembedding hold
#: 1.090 B parameters, each layer 0.237 B (q heads padded to 32), so 13.1 GB
#: of state and 2.84 GB a layer; all 28 layers would be 92.6 GB.  The
#: eager route decides the cut: its update makes a new parameter tree
#: beside the old one and the gradients, and at 18 layers it ran out of
#: the card's memory (83.03 GB at its peak) where the compiled route
#: peaked at 67.06 GB; at 16 both routes fit.  ``python3
#: scripts/mamba_train_depth.py --arch qwen2-vl-7b --layers ...`` trains
#: each depth's steps in a process of its own and prints its peak or where
#: it ran out of memory.
QWEN2VL_TRAIN_LAYERS = 16
#: SeamlessM4T-medium's two target lengths over SEAMLESS_FRAMES frames: the
#: launcher's own split of TRAIN_SEQ (``train_batch_specs``) and 64, the
#: cross-attention's Sq 64 over Skv 512; the f32 check's cut, encoder and
#: decoder layers.
SEAMLESS_TRAIN_TARGETS = (TRAIN_SEQ // 2, 64)
SEAMLESS_TRAIN_F32_LAYERS = 4
#: DeepSeek-V2's dense first layer and one MLA + MoE layer (160 experts of
#: 1536 and 2 shared): 5.359 B parameters, 64.3 GB of training state in
#: bf16.  No smaller cut keeps an MLA + MoE layer.  Each route runs in a
#: process of its own (``chip_smoke.py --train-route``), the eager one
#: first, on the default allocator: a route that runs out of the card's
#: memory prints the allocation it stopped at and does not fail the
#: phase.
DEEPSEEK_TRAIN_LAYERS = 2
#: Phase 26: the tensor-parallel steps at these sizes of the ``model``
#: axis (mesh (1, m)), each with the cases its ranks run (the module
#: docstring's letters): Qwen2-1.5B's f32 check cut to TP_F32_LAYERS of its
#: 28 layers ((a), (c)) and whole in bf16 ((b), model 2 only); Qwen1.5-MoE
#: expert-parallel ((d): 30 and 15 experts a rank; bf16 at model 2 only) and expert-TP ((e), one
#: layer at model 8: 60 experts do not divide 8); Mamba2-2.7B ((f): 40 and
#: 20 heads a rank); Jamba cut to one period ((g), model 2 only);
#: DeepSeek-V2's MLA ((h): 64 and 32 heads a rank) and SeamlessM4T-medium's
#: cross-attention ((i): 8 and 4 heads a rank; bf16 at model 2 only);
#: Qwen1.5-MoE on the (data, model) mesh TP_DATA_MESH ((j), world 4 only:
#: 30 experts a rank, each data rank half of every expert's slots).
TP_RUNS = ((2, "abcdfghi"), (4, "acdfhij"), (8, "e"))
TP_DATA_MESH = (2, 2)
TP_F32_LAYERS = 4
TP_ETP_LAYERS = 1
#: (d)'s f32 cut at model 4, cut from MOE_F32_LAYERS to make room for (j)
#: (the same expert-parallel route as at model 2, at 15 experts a rank).
TP_MOE_M4_F32_LAYERS = 1
#: (f): phase 13's prompt (100 tokens in a bucket of 128), the f32 check
#: cut to TP_MAMBA_F32_LAYERS of Mamba2-2.7B's 64 layers.
TP_MAMBA_PROMPT, TP_MAMBA_BUCKET = 100, 128
TP_MAMBA_F32_LAYERS = 4
#: The ranks init a model one at a time where their whole copies together
#: would pass this many bytes (each keeps its shards after).
TP_STAGGER_BYTES = 40e9
#: Phase 26's bf16 cases.  Two unsharded routes of one bf16 model (kernel
#: and plain: the same sums in other orders) drift apart with depth
#: (``scripts/bf16_depth_spread.py``, PERF.md section 6: Mamba2-2.7B
#: 2.5e-3 at 1 layer, 6.3e-3 at 2, 1.4e-2 at 4, 0.72 at 64; Qwen1.5-MoE's
#: routing already differs for 1 % of the prompts' tokens at its first
#: layer and for 62 % at its 24th).  (f) cuts Mamba2-2.7B to
#: TP_MAMBA_BF16_LAYERS of its 64 layers, where they still agree, and is
#: held as (b), at relative Frobenius error 2e-2, with the first decode
#: step's tokens among the unsharded step's TP_TOP_TOKENS most likely.  (d)
#: and (g) keep their depth and their capacity drops: the first MoE layer's
#: routing is held (at most TP_ROUTE_FLIPS of the prefill's tokens with
#: other top-k experts than the unsharded's; each MoE layer's count is
#: printed beside the plain route's), and the logits within relative
#: Frobenius error TP_BF16_LIMIT (the routes' recorded spreads at these
#: depths: 0.13-0.25 sharded, 0.02-0.29 the plain route).
TP_MAMBA_BF16_LAYERS = 2
#: Decode steps of the serves of (d)-(i) and of their unsharded runs
#: ((a)-(c) take DECODE_STEPS, as phase 25's references do): each step's
#: collectives cross the host, and (d)'s 16 bf16 steps over Qwen1.5-MoE's
#: 24 layers took 37 s at model 4.  The checks read the prefill's and
#: each step's logits and tokens.
TP_DECODE_STEPS = 4
#: (j)'s bf16 decode steps, cut to make room for its f32 train step,
#: whose ``fsdp_tp`` weights cross the host to the other data rank at
#: each pass (the checks read the prefill's and the first step's logits).
TP_DATA_DECODE_STEPS = 1
TP_TOP_TOKENS = 5
TP_BF16_LIMIT = 0.5
TP_ROUTE_FLIPS = 0.05
#: K1 and K4 at the tensor-parallel steps' local heads at model 2 (Qwen2-
#: 1.5B's 16 padded q heads and 2 KV heads, split two ways): K1 on the
#: serve's 512-token bucket, K4 on one 1024-token training sequence:
#: (q heads, KV heads, S).
K1_TP_SHAPE = (8, 1, 512)
K4_TP_SHAPE = (8, 1, TRAIN_SEQ)
#: K1 (bf16, the serve's prefill) and K4 (f32, the train step) at
#: Qwen1.5-MoE's local heads at model 2 (16 heads, 16 KV heads, split two
#: ways), and K5 (bf16) at Mamba2-2.7B's (80 heads of 64 split two ways,
#: one group of N 128) on (f)'s prompt bucket: (q heads, KV heads, S) and
#: (heads, groups, S, P, N, chunk).
K1_TP_MOE_SHAPE = (8, 8, 512)
K4_TP_MOE_SHAPE = (8, 8, TRAIN_SEQ)
K5_TP_SHAPE = (40, 1, TP_MAMBA_BUCKET, 64, 128, 256)
#: (h): DeepSeek-V2 at its published widths in f32, where MLA's split is
#: held (its absorbed and decompressed forms already differ in bf16): the
#: serve at DEEPSEEK_F32_LAYERS (the dense first layer and one MoE layer),
#: the train step through the dense first layer alone (zero periods, about
#: 22 GB with its gradients and moments).  MLA launches no kernel.
TP_DEEPSEEK_TRAIN_LAYERS = 1
#: (i): SeamlessM4T-medium in f32 cut to TP_SEAMLESS_F32_LAYERS encoder
#: and decoder layers (a train step of TP_SEAMLESS_TARGET target tokens
#: over SEAMLESS_FRAMES frames, the four prompts and TP_DECODE_STEPS decode
#: steps over one SEAMLESS_FRAMES memory each), and whole in bf16 at model
#: 2 (the prompts and decode steps).
TP_SEAMLESS_F32_LAYERS = 4
TP_SEAMLESS_TARGET = 64
#: K1 at SeamlessM4T's decoder local heads at model 2 (16 heads of 64
#: split two ways) on the prompts' bucket, and K4 at its cross-attention's
#: (the train step's 64 target tokens over 512 frames): (q heads, KV
#: heads, S, D) and (heads, Sq, Skv, D).
K1_TP_SEAMLESS_SHAPE = (8, 8, 512, SEAMLESS_D)
K4_TP_SEAMLESS_SHAPE = (8, TP_SEAMLESS_TARGET, SEAMLESS_FRAMES, SEAMLESS_D)


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 20, reps: int = 7,
            warmup: int = 5) -> float:
    """Milliseconds per call on the card: the median over ``reps`` loops of
    ``iters`` calls, each loop timed by CUDA events, after warm-up.  A call
    slower than TIME_LOOP_MS / ``iters`` (the plain versions, milliseconds
    a call) gets fewer calls a loop, at least one, and two warm-up calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    once = start.elapsed_time(end)
    if once * iters > TIME_LOOP_MS:
        iters, warmup = max(1, int(TIME_LOOP_MS / once)), 0
    for _ in range(max(warmup - 2, 0)):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(reps):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    return sorted(per_call)[reps // 2]


def device_ms_by_kernel(torch, fn, iters: int = 20,
                        warmup: int = 5) -> dict[str, float]:
    """Device milliseconds per call of each kernel (and copy) that ``iters``
    calls launch, by name, as CUPTI records them through ``torch.profiler``,
    over ``iters``.  The first call starts PROFILE_LEAD_S after the session
    does."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_LEAD_S)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {r.key: r.self_device_time_total / 1e3 / iters
            for r in prof.key_averages() if r.device_type == DeviceType.CUDA}


def device_ms(torch, fn, iters: int = 20, warmup: int = 5) -> float:
    """Device milliseconds per call: the durations of the kernels (and
    copies) that ``iters`` calls launch, summed (``device_ms_by_kernel``).
    Unlike ``time_ms`` it leaves out the host's gaps between launches,
    which set ``time_ms`` where a call's host work outlasts its kernels."""
    return sum(device_ms_by_kernel(torch, fn, iters, warmup).values())


def check_close(torch, name, got, want, dtype_name, tol=TOL) -> float:
    rtol, atol = tol[dtype_name]
    g, w = got.detach().float(), want.detach().float()
    err = (g - w).abs()
    if not torch.isfinite(g).all():
        fail(f"{name}: non-finite values")
    bad = err > atol + rtol * w.abs()
    if bad.any():
        fail(f"{name}: {int(bad.sum())} elements outside rtol {rtol} / "
             f"atol {atol}, max abs err {float(err.max()):.3e}")
    # An empty leaf (a stack of zero periods) has no error.
    return float(err.max()) if err.numel() else 0.0


@contextlib.contextmanager
def keep_inputs(module, name):
    """Wrap ``module.<name>(*tensors, **kwargs)`` while the block runs and
    keep a copy of the first tensors and keyword arguments it gets for each
    shape of its first two arguments, dtype of its first and ``causal``
    keyword (where given)."""
    kept = {}
    saved = getattr(module, name)

    @functools.wraps(saved)
    def call(*args, **kwargs):
        key = (tuple(args[0].shape), tuple(args[1].shape), args[0].dtype)
        if "causal" in kwargs:
            key += (kwargs["causal"],)
        if key not in kept:
            kept[key] = (tuple(a.clone() for a in args), dict(kwargs))
        return saved(*args, **kwargs)

    setattr(module, name, call)
    try:
        yield kept
    finally:
        setattr(module, name, saved)


@contextlib.contextmanager
def keep_routes(rows: int):
    """The top-k experts (on the host) that each MoE layer's router gives a
    batch of ``rows`` tokens (a prefill's), in call order, while the block
    runs."""
    from repro_torch.models import moe

    saved, kept = moe._route, []

    @functools.wraps(saved)
    def route(p, m, xt):
        out = saved(p, m, xt)
        if xt.shape[0] == rows:
            kept.append(out[2].cpu())
        return out

    moe._route = route
    try:
        yield kept
    finally:
        moe._route = saved


@contextlib.contextmanager
def expert_flops():
    """The FLOPs (``FlopCounterMode``) of the routed and of the shared
    expert products of the capacity-routed MoE layers (``apply_moe``:
    prefill and training, not the decode's ``apply_moe_dense``) while the
    block runs: ``{"routed": n, "shared": n}``."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import moe, transformer

    counts = {"routed": 0, "shared": 0}
    real_apply, real_mlp = transformer.apply_moe, moe._expert_mlp
    inside = [False]

    def apply(*args, **kwargs):
        inside[0] = True
        try:
            return real_apply(*args, **kwargs)
        finally:
            inside[0] = False

    def mlp(x, w_gate, *args, **kwargs):
        if not inside[0]:
            return real_mlp(x, w_gate, *args, **kwargs)
        with FlopCounterMode(display=False) as fc:
            y = real_mlp(x, w_gate, *args, **kwargs)
        counts["routed" if w_gate.ndim == 3 else "shared"] += \
            fc.get_total_flops()
        return y

    transformer.apply_moe, moe._expert_mlp = apply, mlp
    try:
        yield counts
    finally:
        transformer.apply_moe, moe._expert_mlp = real_apply, real_mlp


def route_flips(got, want) -> list[int]:
    """For each MoE layer of two ``keep_routes`` records: the tokens whose
    top-k expert sets differ."""
    return [int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
            for a, b in zip(got, want, strict=True)]


@contextlib.contextmanager
def wall_split(cls, names):
    """Calls and host seconds spent in each method ``cls.<name>`` while the
    block runs.  ``DecodeEngine.prefill`` and ``.step`` end by copying logits
    to the host, which waits for the device, so the host clock around them
    covers their device work; ``insert`` only enqueues its cache copy."""
    spent = {n: [0, 0.0] for n in names}
    saved = {n: getattr(cls, n) for n in names}

    def timed(name, fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[name][0] += 1
                spent[name][1] += time.perf_counter() - t
        return call

    for n in names:
        setattr(cls, n, timed(n, saved[n]))
    try:
        yield spent
    finally:
        for n in names:
            setattr(cls, n, saved[n])


@contextlib.contextmanager
def step_log(cls, stats: dict, keep: int = 3):
    """While the block runs, the host logits of each engine's first
    ``keep`` decode steps (``cls._decode_logits``: on the compiled route the
    warm-up, the capture and its replay, a replay), by engine name, in
    ``log["decode"]``, and the host seconds of every decode step from its
    inputs to its logits on the host, in ``log["step_s"]``; ``stats``
    (``serve.compiled.STATS``) set to 0 before the block and copied into
    ``log["graphs"]`` after it."""
    log = {"decode": {}, "step_s": {}, "graphs": {}}
    saved = cls._decode_logits
    for key in stats:
        stats[key] = 0

    @functools.wraps(saved)
    def call(self, toks, pos):
        t0 = time.perf_counter()
        lg = saved(self, toks, pos)
        log["step_s"].setdefault(self.name, []).append(
            time.perf_counter() - t0)
        seq = log["decode"].setdefault(self.name, [])
        if len(seq) < keep:
            seq.append(lg.copy())
        return lg

    cls._decode_logits = call
    try:
        yield log
    finally:
        cls._decode_logits = saved
        log["graphs"] = dict(stats)


def flash_bound_ms(bh: int, s: int, d: int, hkv_rows: int, itemsize: int,
                   dtype_name: str) -> tuple[float, str]:
    """Least time for causal prefill attention: q, k, v read once, out
    written once; 4*D operations per (query, visible key) pair."""
    nbytes = itemsize * d * s * (2 * bh + 2 * hkv_rows)
    ops = 4 * d * bh * s * (s + 1) // 2
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def matmul_bound_ms(m: int, k: int, n: int, itemsize: int,
                    dtype_name: str) -> tuple[float, str]:
    """Least time for (m, k) @ (k, n): x and y read once, the product
    written once; 2 m k n operations."""
    nbytes = itemsize * (m * k + k * n + m * n)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * m * k * n / PEAK_OPS_PER_S[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def k5_bound_ms(bh: int, bg: int, s: int, p: int, n: int, chunk: int,
                itemsize: int, dtype_name: str) -> tuple[float, str]:
    """Least time for K5 on (BH, S, P) xdt with (BG, S, N) B and C: xdt,
    la (f32), B and C read once, y and the f32 (BH, P, N) state written
    once; 2 operations per multiply-add of the products a chunk of length c
    needs: the causal half of the Gram C Bᵀ (c (c + 1) / 2 pairs of N, once
    per group: it does not depend on the head), its decayed product with
    xdt (the same pairs, P wide, per head), the state update (c P N per
    head) and, after the first chunk, the inter-chunk term C h₀ᵀ (c P N per
    head; the first chunk's h₀ is 0, so no program needs it there), at the
    type's peak (f32: FMAs at 67 TFLOP/s, as the f32 kernel runs them).
    The elementwise decay terms are not counted."""
    nbytes = itemsize * (2 * bh * s * p + 2 * bg * s * n) + 4 * bh * s \
        + 4 * bh * p * n
    ops = 0
    for c0 in range(0, s, chunk):
        c = min(chunk, s - c0)
        pairs = c * (c + 1) // 2
        ops += 2 * (bg * pairs * n + bh * pairs * p
                    + (2 if c0 else 1) * bh * c * p * n)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def k5_bwd_bound_ms(bh: int, bg: int, s: int, p: int, n: int, chunk: int,
                    itemsize: int, dtype_name: str,
                    dstate: bool) -> tuple[float, str]:
    """Least time for K5's backward on (BH, S, P) xdt and dy with (BG, S,
    N) B and C: xdt, dy, B, C, la (f32) and, when given, the f32 (BH, P, N)
    dstate read once, dxdt, dla (f32), dB and dC written once; 2 operations
    per multiply-add of the products a chunk of length c needs: the causal
    half of the Gram C Bᵀ (c (c + 1) / 2 pairs of N, once per group), and
    per head M = dY Xᵀ and dx's decayed product (the same pairs, P wide
    each), dB's and dC's (N wide each); then c P N per head for each state
    term the data needs: dh B_j and dhᵀ x_j (dx, dB) where the state leaving
    the chunk has a gradient (every chunk but the last, which has one only
    with dstate), h_inᵀ dy_i (dC) and the entering state's gradient where a
    chunk has a state entering it (after the first), and the forward's
    state chain for every chunk before the last, at the type's peak.  The
    elementwise decays and the dla sums are not counted."""
    nbytes = itemsize * (3 * bh * s * p + 4 * bg * s * n) + 8 * bh * s \
        + (4 * bh * p * n if dstate else 0)
    ops = 0
    for c0 in range(0, s, chunk):
        c = min(chunk, s - c0)
        last = c0 + c >= s
        pairs = c * (c + 1) // 2
        state_terms = (0 if last and not dstate else 2) + (2 if c0 else 0) \
            + (0 if last else 1)
        ops += 2 * (bg * pairs * n + bh * pairs * (2 * p + 2 * n)
                    + state_terms * bh * c * p * n)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def k4_bound_ms(bh: int, bhkv: int, sq: int, skv: int, d: int, itemsize: int,
                dtype_name: str, causal: bool, part: str) -> tuple[float, str]:
    """Least time for K4's forward (``part`` 'fwd') or one backward kernel
    ('dq', 'dkdv'): each input read once, each output written once;
    operations per visible (query, key) pair: 4 D for the forward (scores,
    P V), 6 D for dQ (scores, dP, dS K), 8 D for dK/dV (scores, dP, P^T dO,
    dS^T Q), at the type's peak.  The row statistics (lse, rowsum(dO * O))
    are f32.

    The f32 forward is counted as its kernel runs it: both products (the
    score chain and P V, 2 D each) as f32 FMAs at 67 TFLOP/s.  The f32
    backward is counted as its kernels run it: the score chain
    (2 D a pair) in f32 FMAs at 67 TFLOP/s, and the other products (4 D
    for dQ, 6 D for dK/dV) on the tensor cores as three TF32 products each,
    so 3x their operations at 495 TFLOP/s.  The two units run at once, so
    the operations' time is the larger of the two, and the bound the larger
    of that and the bytes' time.  Counted all at 67 TFLOP/s instead, as
    when the f32 backward ran on the CUDA cores, the path's shape gives
    dQ 0.0963 ms and dK/dV 0.1283 ms: 3x and 3.3x this bound."""
    per_row = bh * (sum(min(i + 1, skv) for i in range(sq)) if causal
                    else sq * skv)
    q_elems, kv_elems, rows = bh * sq * d, bhkv * skv * d, bh * sq
    nbytes, ops = {
        "fwd": (itemsize * (2 * q_elems + 2 * kv_elems) + 4 * rows, 4),
        "dq": (itemsize * (4 * q_elems + 2 * kv_elems) + 8 * rows, 6),
        "dkdv": (itemsize * (2 * q_elems + 4 * kv_elems) + 8 * rows, 8),
    }[part]
    t_bytes = nbytes / HBM_BYTES_PER_S
    if dtype_name == "float32" and part != "fwd":
        t_ops = max(2 * d * per_row / PEAK_OPS_PER_S["float32"],
                    3 * (ops - 2) * d * per_row / PEAK_OPS_PER_S["tf32"])
    else:
        t_ops = ops * d * per_row / PEAK_OPS_PER_S[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


@contextlib.contextmanager
def train_split(torch, loop):
    """Calls and host seconds spent, while the block runs, in each grain
    (``_GrainGradExecutor.execute``: the batch, forward, backward, and the
    wait for the loss), in the combine (``_PrefixCombine.add``, nested in
    the grain) and in AdamW (``HDPTrainer._apply_update``: the update on
    either route, a compiled one's warm-up, capture or replay), and the
    host seconds of each training step (``HDPTrainer.step``); ``calls``
    keeps each grain's and each update's seconds in call order;
    ``waiting`` the most grains a combine held waiting at once.  The
    combine and AdamW only enqueue their work, so their timed calls end in
    ``torch.cuda.synchronize()``, from outside any capture."""
    spent = {"grain": [0, 0.0], "combine": [0, 0.0], "adamw": [0, 0.0],
             "steps": [], "calls": {"grain": [], "adamw": []}, "waiting": 0}
    saved = [(loop._GrainGradExecutor, "execute"),
             (loop._PrefixCombine, "add"), (loop.HDPTrainer, "_apply_update"),
             (loop.HDPTrainer, "step")]
    saved = [(owner, name, getattr(owner, name)) for owner, name in saved]

    def timed(key, fn, sync):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                if sync:
                    torch.cuda.synchronize()
                dt = time.perf_counter() - t
                if key == "combine":
                    spent["waiting"] = max(spent["waiting"], args[0].most)
                if key == "steps":
                    spent["steps"].append(dt)
                else:
                    spent[key][0] += 1
                    spent[key][1] += dt
                    if key in spent["calls"]:
                        spent["calls"][key].append(dt)
        return call

    for (owner, name, fn), key, sync in zip(
            saved, ("grain", "combine", "adamw", "steps"),
            (False, True, True, False), strict=True):
        setattr(owner, name, timed(key, fn, sync))
    try:
        yield spent
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def leaf_digests(torch, tree_leaves, tree) -> list[str]:
    """A SHA-256 digest of each leaf's bytes, in leaf order: of the bytes,
    or for a leaf of more than DIGEST_PIECE bytes, of its pieces' SHA-256
    digests in order; the pieces hashed eight at a time (the copies to the
    host and ``hashlib`` release the interpreter's lock: a full-width
    model's leaves took seconds one by one)."""
    pieces = []                        # (leaf index, its bytes' piece)
    leaves = tree_leaves(tree)
    for i, leaf in enumerate(leaves):
        raw = leaf.detach().contiguous().reshape(-1).view(torch.uint8)
        for lo in range(0, max(raw.numel(), 1), DIGEST_PIECE):
            pieces.append((i, raw[lo:lo + DIGEST_PIECE]))
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        digests = list(pool.map(
            lambda piece: hashlib.sha256(piece[1].cpu().numpy()).digest(),
            pieces))
    parts: list[list[bytes]] = [[] for _ in leaves]
    for (i, _), d in zip(pieces, digests, strict=True):
        parts[i].append(d)
    return [p[0].hex() if len(p) == 1 else hashlib.sha256(b"".join(p))
            .hexdigest() for p in parts]


def vl_positions(torch, dev, n: int, bucket: int):
    """(1, 3, bucket) M-RoPE ids of a prompt of ``n`` embeddings: 4 text
    tokens, an 8 x 8 image block (one temporal id; h and w over its rows
    and columns), then text from max + 1; pad positions go on counting.
    A prompt shorter than that is text (three equal streams)."""
    t, hh, w = [], [], []
    if n >= 4 + 64:
        t, hh, w = list(range(4)), list(range(4)), list(range(4))
        for r in range(8):
            for c in range(8):
                t.append(4), hh.append(4 + r), w.append(4 + c)
    nxt = max(t + hh + w, default=-1) + 1
    rest = list(range(nxt, nxt + bucket - len(t)))
    return torch.tensor([[t + rest, hh + rest, w + rest]],
                        dtype=torch.int32, device=dev)


def train_single_batches(torch, cfg, dev) -> list[dict]:
    """Phase 28's batches on ``dev``, one a step: TRAIN_SINGLE_STEPS steps
    and a last one (profiled on the compiled route) of each shape.
    Qwen2-VL: one TRAIN_SEQ sequence of seeded embeddings with M-RoPE
    positions whose streams differ (``vl_positions``: text, an 8 x 8 image
    block, text), seeded targets; SeamlessM4T: the launcher's own batch
    (``train_batch_specs(cfg, 1, TRAIN_SEQ)``: SEAMLESS_FRAMES frames and as
    many target tokens) and, in turn with it, the same frames with its
    first SEAMLESS_TRAIN_TARGETS[1] targets; token configs: one sequence of
    ``batch_from_grains``."""
    import numpy as np

    from repro_torch.configs.shapes import train_batch_specs
    from repro_torch.data import GrainSpec, SyntheticSource, batch_from_grains
    from repro_torch.models.layers import dtype_of

    n = TRAIN_SINGLE_STEPS + 1
    if cfg.is_enc_dec:
        whole = train_batch_specs(cfg, 1, TRAIN_SEQ, device=dev)
        short = {k: v if k == "src_embeds"
                 else v[:, :SEAMLESS_TRAIN_TARGETS[1]].contiguous()
                 for k, v in whole.items()}
        return [(whole, short)[i % 2] for i in range(2 * n)]
    if cfg.input_mode == "embeds":
        rng = np.random.default_rng(SEED)
        one = {"embeds": torch.as_tensor(
                   rng.standard_normal((1, TRAIN_SEQ, cfg.d_model)),
                   dtype=dtype_of(cfg.compute_dtype), device=dev),
               "positions": vl_positions(torch, dev, TRAIN_SEQ, TRAIN_SEQ),
               "targets": torch.as_tensor(
                   rng.integers(0, cfg.vocab_size, (1, TRAIN_SEQ)),
                   dtype=torch.int32, device=dev),
               "loss_mask": torch.ones((1, TRAIN_SEQ), device=dev)}
        return [one] * n
    spec = GrainSpec(1, TRAIN_SEQ, cfg.vocab_size)
    one = batch_from_grains(SyntheticSource(spec, seed=SEED), 0, [0], spec,
                            device=dev)
    return [one] * n


def train_single_route(torch, cfg, batches, compile_steps: bool,
                       profile_from: int | None = None,
                       kernels=()) -> dict:
    """``train_single`` of ``cfg``'s model from ``init(SEED)`` over
    ``batches`` (one a step) on one route, after freeing what the process
    no longer holds: each step's loss, tokens and grad norm, host seconds
    (to the step's metrics on the host, the first step with the init) and
    the memory allocated after it, the peak memory, the graphs' captures,
    seconds and pool bytes, the leaves' digests after the last step
    (``leaf_digests``); from ``profile_from`` on the steps run under
    ``torch.profiler``, and their host wall, the card's busy seconds and
    those in the kernels named by ``kernels`` (``profile_sums``) are kept.
    On running out of the card's memory, the error's first line and the
    allocations instead (``oom``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import Model
    from repro_torch.serve import compiled
    from repro_torch.train import train_single
    from repro_torch.tree import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats0 = dict(compiled.STATS)
    marks, box = [], {}

    def batch_fn(step: int) -> dict:
        if step == profile_from:
            torch.cuda.synchronize()
            box["prof"] = profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA])
            box["prof"].__enter__()
            time.sleep(PROFILE_LEAD_S)
            box["t0"] = time.perf_counter()
        return batches[step]

    def log_fn(step: int, metrics: dict) -> None:
        marks.append(time.perf_counter())
        held.append(torch.cuda.memory_allocated() / 1e9)

    out = {"route": "compiled" if compile_steps else "eager",
           "steps": len(batches)}
    held = []
    t0 = time.perf_counter()
    try:
        state, hist = train_single(
            Model(cfg), len(batches), batch_fn, log_every=1, seed=SEED,
            log_fn=log_fn, compile_steps=compile_steps)
        torch.cuda.synchronize()
    except (torch.OutOfMemoryError, RuntimeError) as err:
        if "out of memory" not in str(err):
            raise
        out["oom"] = {"error": " ".join(str(err).split())[:600],
                      "allocated_gb": torch.cuda.memory_allocated() / 1e9,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "steps_done": len(marks), "held_gb": held}
        return out
    finally:
        if "prof" in box:
            box["prof"].__exit__(None, None, None)
    times = [b - a for a, b in zip([t0] + marks, marks)]
    out.update(
        loss=[h["loss"] for h in hist], tokens=[h["tokens"] for h in hist],
        grad_norm=[h["grad_norm"] for h in hist], step_s=times,
        held_gb=held, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
        card_gb=torch.cuda.mem_get_info()[1] / 1e9,
        graphs={k: compiled.STATS[k] - stats0[k] for k in stats0},
        params=sum(leaf.numel() for leaf in tree_leaves(state.params)))
    t0 = time.perf_counter()
    out["digests"] = leaf_digests(torch, tree_leaves, state.params)
    out["digest_s"] = time.perf_counter() - t0
    if "prof" in box:
        busy, mine = profile_sums(box["prof"], kernels, top=8)
        out["profiled"] = {"steps": len(batches) - profile_from,
                           "wall_s": marks[-1] - box["t0"], "busy_s": busy,
                           "kernel_s": mine}
    del state, hist
    gc.collect()
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def grain_split(client_cls, matmul_fn):
    """Host seconds spent in ``matmul_fn`` (K3's launches: checks, output
    allocation, the launch) and in ``client_cls.matmul_block`` (one grain:
    its launch plus the wait for the card) while the block runs.  Yields
    the timed ``matmul_fn`` to hand to the job and the running totals."""
    spent = {"launches": 0, "launch_s": 0.0, "grains": 0, "grain_s": 0.0}
    saved = client_cls.__dict__["matmul_block"]

    def timed_fn(x, y):
        t = time.perf_counter()
        try:
            return matmul_fn(x, y)
        finally:
            spent["launches"] += 1
            spent["launch_s"] += time.perf_counter() - t

    def timed_block(*args):
        t = time.perf_counter()
        try:
            return saved.__func__(*args)
        finally:
            spent["grains"] += 1
            spent["grain_s"] += time.perf_counter() - t

    client_cls.matmul_block = staticmethod(timed_block)
    try:
        yield timed_fn, spent
    finally:
        client_cls.matmul_block = saved


def card_busy(torch, run, kernels=("matmul_kernel", "matmul_strip_kernel"),
              top: int = 0) -> tuple[float, float, float]:
    """Run ``run()`` under ``torch.profiler`` with CUDA tracing; return its
    host wall seconds (profiler overhead included), the card's seconds in
    every kernel (and copy) it ran and in the kernels whose names hold one
    of ``kernels`` (K3 by default; ``profile_sums``)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_LEAD_S)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    return (wall_s,) + profile_sums(prof, kernels, top)


def profile_sums(prof, kernels, top: int = 0) -> tuple[float, float]:
    """The card's seconds in every kernel (and copy) of a finished
    ``torch.profiler`` session and in the kernels whose names hold one of
    ``kernels`` (durations as CUPTI records them).  Only the device's own
    events are summed: a CPU op's row repeats the device time of the
    kernels it launched.  They are read from the session's raw events:
    ``key_averages()`` gives the same sums, but over a serve's events it
    takes far longer than the serve (``scripts/profiler_cost.py`` times
    both).  ``top`` > 0 also prints that many kernels with the most device
    time."""
    from torch.autograd import DeviceType

    by_name: dict[str, list] = {}        # kernel name -> [calls, ns]
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            row = by_name.setdefault(e.name(), [0, 0])
            row[0] += 1
            row[1] += e.duration_ns()
    busy = sum(ns for _, ns in by_name.values()) / 1e9
    mine = sum(ns for name, (_, ns) in by_name.items()
               if any(k in name for k in kernels)) / 1e9
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    for name, (n, ns) in ranked[:top]:
        print(f"[profile] {ns / 1e9:.4f} s in {n} calls: {name[:110]}",
              flush=True)
    for name, (n, ns) in ranked if top else ():
        if any(k in name for k in kernels):
            print(f"[profile] of those: {ns / 1e9:.4f} s in {n} calls: "
                  f"{name[:80]}", flush=True)
    return busy, mine


def print_busy(card, label, wall_s, busy_s, k3_s, unprofiled_s,
               tag="paper", kernel="K3") -> None:
    print(f"[{tag}] {card}: {label}, profiled repeat: {wall_s:.4f} s wall, "
          f"card busy {busy_s:.4f} s ({kernel} {k3_s:.4f} s, other kernels "
          f"{busy_s - k3_s:.4f} s): busy {busy_s / wall_s:.4f}, idle "
          f"{1 - busy_s / wall_s:.4f}; the same kernel time over the "
          f"unprofiled run's {unprofiled_s:.4f} s: busy "
          f"{busy_s / unprofiled_s:.4f}, idle {1 - busy_s / unprofiled_s:.4f}",
          flush=True)


def kernel_build_report(log_text: str, sass_text: str,
                        names: tuple[str, ...]) -> dict[str, dict]:
    """Per instantiation of the kernels in ``names`` (``name<D>`` for an
    int template argument, ``name<float>`` or ``name<bf16>`` for a dtype,
    ``name<float, D>`` or ``name<half, D>`` for both, ``name<D, float>``
    or ``name<D, bf16>`` for both the other way round, ``name<float,
    bf16>`` and the like for two dtypes):
    registers, static shared memory, spill bytes and stack frame from an
    ``nvcc -Xptxas -v`` report, and the count of ``HMMA`` (tensor-core)
    instructions in its SASS from ``cuobjdump -sass``."""
    def key(mangled):
        for n in names:
            if n in mangled:
                d = re.search(n + r"I(f|6__half)Li(\d+)E", mangled)
                if d:
                    t = "float" if d.group(1) == "f" else "half"
                    return f"{n}<{t}, {d.group(2)}>"
                d = re.search(n + r"ILi(\d+)E(f|13__nv_bfloat16)E", mangled)
                if d:
                    t = "float" if d.group(2) == "f" else "bf16"
                    return f"{n}<{d.group(1)}, {t}>"
                d = re.search(n + r"ILi(\d+)E", mangled)
                if d:
                    return f"{n}<{d.group(1)}>"
                types = {"f": "float", "6__half": "half",
                         "13__nv_bfloat16": "bf16"}
                d = re.search(n + r"I(f|6__half|13__nv_bfloat16)"
                              r"(f|6__half|13__nv_bfloat16|S1_)E", mangled)
                if d:
                    t_in = types[d.group(1)]
                    return f"{n}<{t_in}, {types.get(d.group(2), t_in)}>"
                if re.search(n + r"IfE", mangled):
                    return f"{n}<float>"
                if re.search(n + r"I13__nv_bfloat16E", mangled):
                    return f"{n}<bf16>"
                return n
        return None

    report, cur = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = key(m.group(1))
            if cur:
                report[cur] = {"hmma": 0}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            report[cur].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[cur]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            report[cur]["static_smem_bytes"] = int(m.group(1))
    cur = None
    for line in sass_text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = key(m.group(1))
            continue
        if cur in report and re.search(r"\bHMMA\b", line):
            report[cur]["hmma"] += 1
    return report


def build_report(build_logs, lib, path, names, smem_bytes,
                 main=None) -> dict[str, dict]:
    """``kernel_build_report`` of the kernels in ``names`` from library
    ``lib`` (built at ``path`` by this run), with each instantiation's
    dynamic shared memory (``smem_bytes(name, int argument)``) added; fails
    if one of them spills, or if the instantiation the path runs is
    missing or, for a tensor-core kernel, has no ``HMMA``.  ``main`` maps a
    name to that instantiation and whether it must hold ``HMMA``; by
    default ``name<128>`` (the head dim) with ``HMMA``, else ``name``
    without."""
    if lib not in build_logs:
        fail(f"no ptxas report for {lib} (the library was not built by this "
             f"run)")
    from repro_torch.kernels.build import nvcc_path
    sass = subprocess.run(
        [os.path.join(os.path.dirname(nvcc_path()), "cuobjdump"), "-sass",
         path], capture_output=True, text=True, timeout=300, check=True).stdout
    report = kernel_build_report(build_logs[lib], sass, names)
    for name, info in sorted(report.items()):
        head_dim = re.search(r"<(\d+),", name) or re.search(r"(\d+)>$", name)
        info["smem_bytes"] = smem_bytes(name, int(head_dim.group(1))) \
            if head_dim else 0
        if info.get("spill_stores", 1) or info.get("spill_loads", 1):
            fail(f"{name} spills registers: {json.dumps(info)}")
    for n in names:
        key, hmma = (main or {}).get(n) or (
            (f"{n}<128>", True) if f"{n}<128>" in report else (n, False))
        if key not in report:
            fail(f"no {key} in the ptxas report of {lib}")
        if hmma and report[key]["hmma"] == 0:
            fail(f"{key} has no HMMA instruction in its SASS")
    return report


def moe_capacity_case(torch, dev):
    """The moe_capacity phase's seeded inputs, the same in phase 15's
    process: one full-width bf16 Qwen1.5-MoE layer (``init_moe``, its
    router in f32), x of MOE_TOKENS tokens, the same layer with the
    example's skewed router (``router + skew * arange(E)``, skew drawn at
    0.02, its largest multiplier the example's 7), the perfs, the skewed
    router's observed top-1 load, and the capacities: uniform, homogenized
    over the perfs, and homogenized over the load (``capacity_per_expert``)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config("qwen2-moe-a2.7b")
    m = cfg.moe
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = moe.init_moe(gen, cfg)
    x = (torch.randn((8, MOE_TOKENS // 8, cfg.d_model), generator=gen,
                     device=dev) * 0.5).to(torch.bfloat16)
    skew = torch.randn((cfg.d_model, m.n_routed), generator=gen,
                       device=dev) * 0.02
    ramp = torch.arange(m.n_routed, device=dev) * (7.0 / (m.n_routed - 1))
    skewed = dict(params, router=params["router"] + skew * ramp)
    perfs = np.resize(np.asarray(MOE_EXAMPLE_PERFS), m.n_routed)
    top1 = torch.argmax(x.reshape(-1, cfg.d_model).float() @ skewed["router"],
                        dim=-1)
    load = np.maximum(np.bincount(top1.cpu().numpy(), minlength=m.n_routed),
                      1).astype(float)
    caps = {"uniform": moe.capacity_per_expert(MOE_TOKENS, m),
            "perf": moe.capacity_per_expert(MOE_TOKENS, m, expert_perfs=perfs),
            "load": moe.capacity_per_expert(MOE_TOKENS, m, expert_perfs=load)}
    return cfg, params, skewed, x, perfs, load, caps


def library_attention(torch, q, k, v):
    """PyTorch's own causal GQA attention on the same inputs, as a
    yardstick for K1 only (the port never calls it)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = q[None], k[None], v[None]
    return lambda: sdpa(q4, k4, v4, is_causal=True, enable_gqa=True)


def device_times() -> dict[str, dict[str, float]]:
    """Phase 15, run in a process of its own: each kernel's device time
    (``device_ms``) and that of PyTorch's call for the same function, on
    seeded inputs of the shapes the main path gives it, keyed as the rows
    of ``main`` are."""
    import torch

    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.mamba_scan import mamba_scan as k5
    from repro_torch.kernels.matmul.ops import matmul as k3_matmul
    from repro_torch.kernels.prefill import prefill as pf

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    def pair(fn, lib_fn):
        return {"device_ms": device_ms(torch, fn),
                "library_device_ms": device_ms(torch, lib_fn)}

    out = {}
    for s in (16, 32, 64, 128, 256, 512):
        q = rand((16, s, 128), torch.bfloat16)
        k, v = rand((2, s, 128), torch.bfloat16), rand((2, s, 128),
                                                      torch.bfloat16)
        out[f"k1_{s}"] = pair(lambda: pf.prefill_flash(q, k, v, group=8),
                              library_attention(torch, q, k, v))
    hq, hkv, s1, d1 = K1_F32_SHAPE
    q = rand((hq, s1, d1), torch.float32)
    k, v = rand((hkv, s1, d1), torch.float32), rand((hkv, s1, d1),
                                                   torch.float32)
    out["k1_f32"] = pair(lambda: pf.prefill_flash(q, k, v, group=hq // hkv),
                         library_attention(torch, q, k, v))
    k32, v32 = rand((2, 128, 128), torch.float32), rand((2, 128, 128),
                                                        torch.float32)
    out["k2"] = pair(lambda: pf.cache_cast(k32, v32, torch.bfloat16),
                     lambda: (k32.to(torch.bfloat16), v32.to(torch.bfloat16)))
    kl, vl = rand(K2_LARGE_SHAPE, torch.float32), rand(K2_LARGE_SHAPE,
                                                       torch.float32)
    out["k2_large"] = pair(lambda: pf.cache_cast(kl, vl, torch.bfloat16),
                           lambda: (kl.to(torch.bfloat16),
                                    vl.to(torch.bfloat16)))
    del kl, vl
    for m, kk, n in ((2, 1000, 1000), (1000, 1000, 1000), (2, 4096, 4096)):
        x = rand((m, kk), torch.float32).mul_(kk ** -0.25)
        y = rand((kk, n), torch.float32).mul_(kk ** -0.25)
        out[f"k3_{m}_{kk}_{n}"] = pair(lambda: k3_matmul(x, y),
                                       lambda: torch.matmul(x, y))
        del x, y
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dname, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        q = rand((16, TRAIN_SEQ, 128), dt)
        k, v = rand((2, TRAIN_SEQ, 128), dt), rand((2, TRAIN_SEQ, 128), dt)
        dout = rand(q.shape, dt)
        _, lse, out32 = fa.flash_attention_fwd(q, k, v, group=8)
        _, drow = fa.flash_attention_bwd_dq(q, k, v, out32, lse, dout,
                                            group=8)
        leaves = [t[None].clone().requires_grad_(True) for t in (q, k, v)]
        lib_out = sdpa(*leaves, is_causal=True, enable_gqa=True)
        lib_bwd = device_ms(torch, lambda: torch.autograd.grad(
            lib_out, leaves, dout[None], retain_graph=True))
        out[f"k4_fwd_{dname}"] = pair(
            lambda: fa.flash_attention_fwd(q, k, v, group=8),
            library_attention(torch, q, k, v))
        out[f"k4_dq_{dname}"] = {
            "device_ms": device_ms(torch, lambda: fa.flash_attention_bwd_dq(
                q, k, v, out32, lse, dout, group=8)),
            "library_device_ms": lib_bwd}
        out[f"k4_dkdv_{dname}"] = {
            "device_ms": device_ms(torch, lambda: fa.flash_attention_bwd_dkdv(
                q, k, v, lse, dout, drow, group=8)),
            "library_device_ms": lib_bwd}
    # K5 at the serving path's shape, with phase 12's input recipe.
    x = rand((80, 512, 64), torch.float32)
    dtv = rand((80, 512), torch.float32).abs() * 0.1 + 0.01
    xdt = (x * dtv[..., None]).to(torch.bfloat16)
    la = dtv * -(rand((80,), torch.float32).abs() + 0.1)[:, None]
    bg, cg = rand((1, 512, 128), torch.bfloat16), rand((1, 512, 128),
                                                       torch.bfloat16)
    out["k5"] = {"device_ms": device_ms(torch, lambda: k5.ssd_scan(
        xdt, la, bg, cg, chunk=256, rep=80))}
    # K5 in f32 at phase 13's shape.
    h, g, s5, p5, n5, chunk = K5_F32_SHAPE
    dtv = rand((h, s5), torch.float32).abs() * 0.1 + 0.01
    xdt = rand((h, s5, p5), torch.float32) * dtv[..., None]
    la = dtv * -(rand((h,), torch.float32).abs() + 0.1)[:, None]
    bg, cg = rand((g, s5, n5), torch.float32), rand((g, s5, n5),
                                                   torch.float32)
    out["k5_f32"] = {"device_ms": device_ms(torch, lambda: k5.ssd_scan(
        xdt, la, bg, cg, chunk=chunk, rep=h // g))}
    # K1 at the new serves' groups, and K5 at Jamba's shape in bf16.
    for hq, hkv in K1_GROUP_SHAPES:
        q = rand((hq, 512, 128), torch.bfloat16)
        k, v = rand((hkv, 512, 128), torch.bfloat16), rand((hkv, 512, 128),
                                                          torch.bfloat16)
        out[f"k1_group_{hq // hkv}"] = pair(
            lambda: pf.prefill_flash(q, k, v, group=hq // hkv),
            library_attention(torch, q, k, v))
    h, g, s5, p5, n5, chunk = K5_JAMBA_SHAPE
    x = rand((h, s5, p5), torch.float32)
    dtv = rand((h, s5), torch.float32).abs() * 0.1 + 0.01
    xdt = (x * dtv[..., None]).to(torch.bfloat16)
    la = dtv * -(rand((h,), torch.float32).abs() + 0.1)[:, None]
    bg, cg = rand((g, s5, n5), torch.bfloat16), rand((g, s5, n5),
                                                     torch.bfloat16)
    out["k5_jamba"] = {"device_ms": device_ms(torch, lambda: k5.ssd_scan(
        xdt, la, bg, cg, chunk=chunk, rep=h // g))}
    del x, dtv, xdt, la, bg, cg
    # K1 on the remaining configs' prefill paths; K4 at SeamlessM4T's
    # non-causal shapes, forward and backward, beside SDPA's.
    for hq, hkv, d in K1_REMAINING_SHAPES:
        q = rand((hq, 512, d), torch.bfloat16)
        k, v = rand((hkv, 512, d), torch.bfloat16), rand((hkv, 512, d),
                                                        torch.bfloat16)
        out[f"k1_{hq}_{hkv}_{d}"] = pair(
            lambda: pf.prefill_flash(q, k, v, group=hq // hkv),
            library_attention(torch, q, k, v))
    # K1 (bf16) at SeamlessM4T's decoder local heads of phase 26, and K4
    # at its cross-attention's (the last key below).
    hq, hkv, s, d = K1_TP_SEAMLESS_SHAPE
    q = rand((hq, s, d), torch.bfloat16)
    k, v = rand((hkv, s, d), torch.bfloat16), rand((hkv, s, d),
                                                  torch.bfloat16)
    out["k1_tp_seamless"] = pair(
        lambda: pf.prefill_flash(q, k, v, group=hq // hkv),
        library_attention(torch, q, k, v))
    h4, sq4, skv4, d = K4_TP_SEAMLESS_SHAPE
    shapes = [(SEAMLESS_HEADS, sq, skv, f"k4_seamless_{sq}_{skv}")
              for sq, skv in K4_SEAMLESS_SHAPES]
    for h, sq, skv, name in shapes + [(h4, sq4, skv4, "k4_tp_cross")]:
        for dname, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            q = rand((h, sq, d), dt)
            k, v = rand((h, skv, d), dt), rand((h, skv, d), dt)
            dout = rand(q.shape, dt)
            _, lse, out32 = fa.flash_attention_fwd(q, k, v, causal=False)
            _, drow = fa.flash_attention_bwd_dq(q, k, v, out32, lse, dout,
                                                causal=False)
            leaves = [t[None].clone().requires_grad_(True) for t in (q, k, v)]
            lib_out = sdpa(*leaves, is_causal=False)
            lib_bwd = device_ms(torch, lambda: torch.autograd.grad(
                lib_out, leaves, dout[None], retain_graph=True))
            key = f"{name}_{dname}"
            out[f"{key}_fwd"] = pair(
                lambda: fa.flash_attention_fwd(q, k, v, causal=False),
                lambda: sdpa(q[None], k[None], v[None], is_causal=False))
            out[f"{key}_dq"] = {
                "device_ms": device_ms(torch, lambda: fa.flash_attention_bwd_dq(
                    q, k, v, out32, lse, dout, causal=False)),
                "library_device_ms": lib_bwd}
            out[f"{key}_dkdv"] = {
                "device_ms": device_ms(
                    torch, lambda: fa.flash_attention_bwd_dkdv(
                        q, k, v, lse, dout, drow, causal=False)),
                "library_device_ms": lib_bwd}
    # apply_moe on the moe_capacity phase's layer under each capacity set.
    from repro_torch.models.moe import apply_moe
    cfg, params, skewed, x, _, _, caps = moe_capacity_case(torch, dev)
    for key, p in (("uniform", params), ("perf", params), ("load", skewed)):
        c = torch.as_tensor(caps[key], device=dev)
        out[f"moe_{key}"] = {"device_ms": device_ms(
            torch, lambda: apply_moe(p, cfg, x, c), iters=5)}
    del params, skewed, x
    # K1 and K4 (bf16) at the tensor-parallel steps' local heads (phase 26).
    hq, hkv, s = K1_TP_SHAPE
    q = rand((hq, s, 128), torch.bfloat16)
    k, v = rand((hkv, s, 128), torch.bfloat16), rand((hkv, s, 128),
                                                    torch.bfloat16)
    out["k1_tp"] = pair(lambda: pf.prefill_flash(q, k, v, group=hq // hkv),
                        library_attention(torch, q, k, v))
    hq, hkv, s = K4_TP_SHAPE
    q = rand((hq, s, 128), torch.bfloat16)
    k, v = rand((hkv, s, 128), torch.bfloat16), rand((hkv, s, 128),
                                                    torch.bfloat16)
    dout = rand(q.shape, torch.bfloat16)
    _, lse, out32 = fa.flash_attention_fwd(q, k, v, group=hq // hkv)
    _, drow = fa.flash_attention_bwd_dq(q, k, v, out32, lse, dout,
                                        group=hq // hkv)
    leaves = [t[None].clone().requires_grad_(True) for t in (q, k, v)]
    lib_out = sdpa(*leaves, is_causal=True, enable_gqa=True)
    lib_bwd = device_ms(torch, lambda: torch.autograd.grad(
        lib_out, leaves, dout[None], retain_graph=True))
    out["k4_tp_fwd"] = pair(
        lambda: fa.flash_attention_fwd(q, k, v, group=hq // hkv),
        library_attention(torch, q, k, v))
    out["k4_tp_dq"] = {
        "device_ms": device_ms(torch, lambda: fa.flash_attention_bwd_dq(
            q, k, v, out32, lse, dout, group=hq // hkv)),
        "library_device_ms": lib_bwd}
    out["k4_tp_dkdv"] = {
        "device_ms": device_ms(torch, lambda: fa.flash_attention_bwd_dkdv(
            q, k, v, lse, dout, drow, group=hq // hkv)),
        "library_device_ms": lib_bwd}
    # K4 (bf16) at Qwen2-VL-7B's training shape (phase 28).
    hq, hkv, s, d = K4_QWEN2VL_SHAPE
    q = rand((hq, s, d), torch.bfloat16)
    k, v = rand((hkv, s, d), torch.bfloat16), rand((hkv, s, d),
                                                  torch.bfloat16)
    dout = rand(q.shape, torch.bfloat16)
    _, lse, out32 = fa.flash_attention_fwd(q, k, v, group=hq // hkv)
    _, drow = fa.flash_attention_bwd_dq(q, k, v, out32, lse, dout,
                                        group=hq // hkv)
    leaves = [t[None].clone().requires_grad_(True) for t in (q, k, v)]
    lib_out = sdpa(*leaves, is_causal=True, enable_gqa=True)
    lib_bwd = device_ms(torch, lambda: torch.autograd.grad(
        lib_out, leaves, dout[None], retain_graph=True))
    out["k4_qwen2vl_fwd"] = pair(
        lambda: fa.flash_attention_fwd(q, k, v, group=hq // hkv),
        library_attention(torch, q, k, v))
    out["k4_qwen2vl_dq"] = {
        "device_ms": device_ms(torch, lambda: fa.flash_attention_bwd_dq(
            q, k, v, out32, lse, dout, group=hq // hkv)),
        "library_device_ms": lib_bwd}
    out["k4_qwen2vl_dkdv"] = {
        "device_ms": device_ms(torch, lambda: fa.flash_attention_bwd_dkdv(
            q, k, v, lse, dout, drow, group=hq // hkv)),
        "library_device_ms": lib_bwd}
    # K1 (bf16) and K4 (f32) at Qwen1.5-MoE's local heads, K5 (bf16) at
    # Mamba2-2.7B's (phase 26).
    hq, hkv, s = K1_TP_MOE_SHAPE
    q = rand((hq, s, 128), torch.bfloat16)
    k, v = rand((hkv, s, 128), torch.bfloat16), rand((hkv, s, 128),
                                                    torch.bfloat16)
    out["k1_tp_moe"] = pair(lambda: pf.prefill_flash(q, k, v,
                                                     group=hq // hkv),
                            library_attention(torch, q, k, v))
    hq, hkv, s = K4_TP_MOE_SHAPE
    q = rand((hq, s, 128), torch.float32)
    k, v = rand((hkv, s, 128), torch.float32), rand((hkv, s, 128),
                                                   torch.float32)
    dout = rand(q.shape, torch.float32)
    _, lse, out32 = fa.flash_attention_fwd(q, k, v, group=hq // hkv)
    _, drow = fa.flash_attention_bwd_dq(q, k, v, out32, lse, dout,
                                        group=hq // hkv)
    leaves = [t[None].clone().requires_grad_(True) for t in (q, k, v)]
    lib_out = sdpa(*leaves, is_causal=True, enable_gqa=True)
    lib_bwd = device_ms(torch, lambda: torch.autograd.grad(
        lib_out, leaves, dout[None], retain_graph=True))
    out["k4_tp_moe_fwd"] = pair(
        lambda: fa.flash_attention_fwd(q, k, v, group=hq // hkv),
        library_attention(torch, q, k, v))
    out["k4_tp_moe_dq"] = {
        "device_ms": device_ms(torch, lambda: fa.flash_attention_bwd_dq(
            q, k, v, out32, lse, dout, group=hq // hkv)),
        "library_device_ms": lib_bwd}
    out["k4_tp_moe_dkdv"] = {
        "device_ms": device_ms(torch, lambda: fa.flash_attention_bwd_dkdv(
            q, k, v, lse, dout, drow, group=hq // hkv)),
        "library_device_ms": lib_bwd}
    h, g, s5, p5, n5, chunk = K5_TP_SHAPE
    dtv = rand((h, s5), torch.float32).abs() * 0.1 + 0.01
    xdt = (rand((h, s5, p5), torch.float32) * dtv[..., None]).to(
        torch.bfloat16)
    la = dtv * -(rand((h,), torch.float32).abs() + 0.1)[:, None]
    bg, cg = rand((g, s5, n5), torch.bfloat16), rand((g, s5, n5),
                                                     torch.bfloat16)
    out["k5_tp"] = {"device_ms": device_ms(torch, lambda: k5.ssd_scan(
        xdt, la, bg, cg, chunk=chunk, rep=h // g))}
    # K5's backward at Mamba2-2.7B's training shape (phase 12), bf16 and
    # f32.
    h, g, s5, p5, n5, chunk = K5_BWD_SHAPE
    for dname, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        dtv = rand((h, s5), torch.float32).abs() * 0.1 + 0.01
        xdt = (rand((h, s5, p5), torch.float32) * dtv[..., None]).to(dt)
        la = dtv * -(rand((h,), torch.float32).abs() + 0.1)[:, None]
        bg, cg = rand((g, s5, n5), dt), rand((g, s5, n5), dt)
        dy = rand((h, s5, p5), dt)
        by_kernel = device_ms_by_kernel(torch, lambda: k5.ssd_scan_bwd(
            xdt, la, bg, cg, dy, None, chunk=chunk, rep=h // g))
        out[f"k5_bwd_{dname}"] = {
            "device_ms": sum(by_kernel.values()),
            "device_ms_by_kernel": {
                re.search(r"(ssd_bwd_\w+?)[<(]", name).group(1)
                if "ssd_bwd_" in name else name: ms
                for name, ms in by_kernel.items()}}
    return out


def main() -> int:
    smoke_t0 = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import numpy as np

    from repro_torch.cluster import (
        Cluster,
        FleetSpec,
        MatmulJob,
        ServeJob,
        SimJob,
        TrainJob,
    )
    from repro_torch.configs import get_config
    from repro_torch.configs.paper_matmul import config as paper_config
    from repro_torch.core import ThinClient, WallclockBackend
    from repro_torch.data import GrainSpec, SyntheticSource, batch_from_grains
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.build import BUILD_DIR
    from repro_torch.kernels.mamba_scan import mamba_scan as k5
    from repro_torch.kernels.mamba_scan import ops as mamba_ops
    from repro_torch.kernels.mamba_scan.ref import (
        ssd_scan_bwd_plain,
        ssd_scan_plain,
        ssd_scan_ref,
    )
    from repro_torch.kernels.matmul import matmul as mm
    from repro_torch.kernels.matmul.ops import matmul as k3_matmul
    from repro_torch.kernels.matmul.ref import matmul_ref
    from repro_torch.kernels.prefill import ops
    from repro_torch.kernels.prefill import prefill as pf
    from repro_torch.kernels.prefill.ref import cache_cast_ref, prefill_ref
    from repro_torch.launch import shared_pg
    from repro_torch.models import Model
    from repro_torch.serve import DecodeEngine, Request
    from repro_torch.serve import compiled as compiled_steps
    from repro_torch.train import loop as train_loop
    from repro_torch.train import make_grain_grad_fn
    from repro_torch.tree import tree_leaves

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # ------------------------------------------------------------ 1. device
    card = card_line()
    print(f"[device] {card}  (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda})", flush=True)

    # ------------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(5) as pool:
        for built in [pool.submit(pf.load_library), pool.submit(mm.load_library),
                      pool.submit(fa.load_library), pool.submit(k5.load_library),
                      pool.submit(shared_pg.load_library)]:
            built.result()
    build_s = time.perf_counter() - t0
    print(f"[build] prefill, matmul, flash-attention and SSD-scan kernels and "
          f"the shared backend's transport built and loaded in {build_s:.2f} "
          f"s", flush=True)
    build_logs = {}
    for lib in ("prefill", "matmul", "flash_attention", "mamba_scan",
                "shared_pg"):
        log = os.path.join(BUILD_DIR, f"{lib}.log")
        if not os.path.exists(log):          # absent when the library was cached
            continue
        with open(log) as f:
            text = f.read()
        build_logs[lib] = text
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", text)]
        spills = [int(w) for w in re.findall(r"(\d+) bytes spill stores", text)]
        print(f"[build] ptxas {lib}: {len(regs)} kernels, registers per "
              f"thread {min(regs)}..{max(regs)}, spill stores up to "
              f"{max(spills)} bytes", flush=True)

    # ----------------------------------------------------------- 3. kernels
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    # The remaining configs' kernel checks (K1 at their groups here, K4 at
    # SeamlessM4T's shapes in phase 10) draw from a generator of their own:
    # a check added here leaves every earlier check's inputs as they were.
    gen_rc = torch.Generator(device=dev)
    gen_rc.manual_seed(SEED)

    def rand_rc(shape, dtype):
        return torch.randn(shape, generator=gen_rc, device=dev,
                           dtype=torch.float32).to(dtype)

    # K1 through the op the model calls, at the serve phase's buckets (16 ..
    # 512), the clamped 48, a 768 past the largest, and head_dim 16; each
    # against use_pallas=False on the same inputs.
    k1_err = 0.0
    cases = [(16, 2, 128, s, dt, rand)
             for s in (16, 32, 48, 64, 128, 256, 512, 768)
             for dt in (torch.bfloat16, torch.float32)]
    cases += [(4, 2, 16, s, dt, rand)
              for s in (16, 48, 128) for dt in (torch.bfloat16, torch.float32)]
    cases += [(hq, hkv, 128, s, dt, rand) for hq, hkv in K1_GROUP_SHAPES
              for s in (129, 512) for dt in (torch.bfloat16, torch.float32)]
    cases += [(hq, hkv, d, s, dt, rand_rc) for hq, hkv, d in K1_REMAINING_SHAPES
              for s in (129, 512) for dt in (torch.bfloat16, torch.float32)]
    for hq, hkv, d, s, dt, draw in cases:
        q = draw((1, s, hq, d), dt)
        k, v = draw((1, s, hkv, d), dt), draw((1, s, hkv, d), dt)
        before = pf.LAUNCHES["prefill_flash"]
        out, kc, vc = ops.prefill_attention(q, k, v)
        torch.cuda.synchronize()
        ref, kr, vr = ops.prefill_attention(q, k, v, use_pallas=False)
        name = f"K1 Hq={hq} Hkv={hkv} D={d} S={s} {str(dt)[6:]}"
        if pf.LAUNCHES["prefill_flash"] != before + 1:
            fail(f"{name}: prefill_attention did not launch K1")
        err = check_close(torch, name, out, ref, str(dt)[6:])
        if not (torch.equal(kc, kr) and torch.equal(vc, vr)):
            fail(f"{name}: same-dtype cache differs from the inputs")
        k1_err = max(k1_err, err)
        print(f"[kernels] {name}: max abs err {err:.3e}", flush=True)

    # K1's bf16 tensor-core kernel as built, then at the edges of its 64-row
    # tiles: S of 1, 17, 63, 65, 127 and 129, groups 1 to 8, every D.
    k1_build = build_report(
        build_logs, "prefill", pf.load_library()._name,
        ("prefill_flash_mma_kernel",),
        lambda name, d: int(pf.load_library().prefill_smem_bytes(d, 1)))
    for name, info in sorted(k1_build.items()):
        print(f"[kernels] build {name}: {json.dumps(info)}", flush=True)
    # K1's f32/f16 kernel, K4's f32 forward body (f32_tiles.cuh): no spill.
    k1_f32_key = "prefill_flash_f32_kernel<float, 128>"
    k1_f32_build = build_report(
        build_logs, "prefill", pf.load_library()._name,
        ("prefill_flash_f32_kernel",),
        lambda name, d: int(pf.load_library().prefill_smem_bytes(d, 0)),
        main={"prefill_flash_f32_kernel": (k1_f32_key, False)})
    for name, info in sorted(k1_f32_build.items()):
        print(f"[kernels] build {name}: {json.dumps(info)}", flush=True)
    for s, hq, hkv, d in ((1, 1, 1, 16), (17, 2, 1, 128), (63, 4, 2, 32),
                          (65, 8, 1, 16), (127, 8, 1, 128), (129, 2, 2, 64),
                          (65, 4, 1, 64), (129, 16, 2, 128)):
        q = rand((1, s, hq, d), torch.bfloat16)
        k, v = rand((1, s, hkv, d), torch.bfloat16), rand((1, s, hkv, d),
                                                          torch.bfloat16)
        before = pf.LAUNCHES["prefill_flash"]
        out, _, _ = ops.prefill_attention(q, k, v)
        torch.cuda.synchronize()
        ref, _, _ = ops.prefill_attention(q, k, v, use_pallas=False)
        name = f"K1 tile edge Hq={hq} Hkv={hkv} D={d} S={s} bfloat16"
        if pf.LAUNCHES["prefill_flash"] != before + 1:
            fail(f"{name}: prefill_attention did not launch K1")
        err = check_close(torch, name, out, ref, "bfloat16")
        k1_err = max(k1_err, err)
        print(f"[kernels] {name}: max abs err {err:.3e}", flush=True)

    # K2 at the model phase's shape: (B*Hkv, bucket, D) f32 -> bf16.
    k32, v32 = rand((2, 128, 128), torch.float32), rand((2, 128, 128), torch.float32)
    kc, vc = pf.cache_cast(k32, v32, torch.bfloat16)
    torch.cuda.synchronize()
    kr, vr = cache_cast_ref(k32, v32, torch.bfloat16)
    if not (torch.equal(kc, kr) and torch.equal(vc, vr)):
        fail("K2 f32->bf16 cast is not bitwise equal to .to(bfloat16)")
    k2_err = max(float((kc.float() - kr.float()).abs().max()),
                 float((vc.float() - vr.float()).abs().max()))
    print("[kernels] K2 (2, 128, 128) f32->bf16: bitwise equal to .to()",
          flush=True)
    # K2 as built, every pair of types (a spill fails).
    k2_build = build_report(
        build_logs, "prefill", pf.load_library()._name, ("cache_cast_kernel",),
        lambda name, d: 0,
        main={"cache_cast_kernel": ("cache_cast_kernel<float, bf16>", False)})
    for name, info in sorted(k2_build.items()):
        print(f"[kernels] build {name}: {json.dumps(info)}", flush=True)
    kl, vl = rand(K2_LARGE_SHAPE, torch.float32), rand(K2_LARGE_SHAPE,
                                                       torch.float32)
    klc, vlc = pf.cache_cast(kl, vl, torch.bfloat16)
    torch.cuda.synchronize()
    if not (torch.equal(klc, kl.to(torch.bfloat16))
            and torch.equal(vlc, vl.to(torch.bfloat16))):
        fail(f"K2 f32->bf16 at {K2_LARGE_SHAPE} is not bitwise equal to "
             f".to(bfloat16)")
    del klc, vlc
    print(f"[kernels] K2 {K2_LARGE_SHAPE} f32->bf16: bitwise equal to .to()",
          flush=True)

    # Timings at the serve path's shapes: Hq=16, Hkv=2, D=128, bf16.
    # Their device times come after the serve phases (phase 10): the serve's
    # wall is not taken after a profiler session.
    k1_sweep = []
    for s in (16, 32, 64, 128, 256, 512):
        q = rand((16, s, 128), torch.bfloat16)
        k, v = rand((2, s, 128), torch.bfloat16), rand((2, s, 128), torch.bfloat16)
        lib = library_attention(torch, q, k, v)
        row = {
            "S": s,
            "ms": time_ms(torch, lambda: pf.prefill_flash(q, k, v, group=8)),
            "plain_ms": time_ms(torch, lambda: prefill_ref(q, k, v, group=8)),
            "library_ms": time_ms(torch, lib),
        }
        row["bound_ms"], row["bound_by"] = flash_bound_ms(16, s, 128, 2, 2,
                                                          "bfloat16")
        k1_sweep.append(row)
        print(f"[kernels] K1 bf16 Hq=16 Hkv=2 D=128 S={s}: "
              + json.dumps(row), flush=True)
    k1_row = k1_sweep[-1]
    hq, hkv, s1, d1 = K1_F32_SHAPE
    q = rand((hq, s1, d1), torch.float32)
    k, v = rand((hkv, s1, d1), torch.float32), rand((hkv, s1, d1),
                                                   torch.float32)
    k1_f32 = {
        "shape": [[hq, s1, d1], [hkv, s1, d1]],
        "ms": time_ms(torch, lambda: pf.prefill_flash(q, k, v,
                                                      group=hq // hkv)),
        "plain_ms": time_ms(torch, lambda: prefill_ref(q, k, v,
                                                       group=hq // hkv)),
        "library_ms": time_ms(torch, library_attention(torch, q, k, v)),
        "build": k1_f32_build[k1_f32_key]}
    k1_f32["bound_ms"], k1_f32["bound_by"] = flash_bound_ms(hq, s1, d1, hkv,
                                                            4, "float32")
    print(f"[kernels] K1 f32 Hq={hq} Hkv={hkv} D={d1} S={s1}: "
          + json.dumps({n: x for n, x in k1_f32.items() if n != "build"}),
          flush=True)
    # K1 at the new serves' groups (1, 4, 48), bf16, S 512.
    k1_groups = []
    for hq, hkv in K1_GROUP_SHAPES:
        q = rand((hq, 512, 128), torch.bfloat16)
        k, v = rand((hkv, 512, 128), torch.bfloat16), rand((hkv, 512, 128),
                                                          torch.bfloat16)
        group = hq // hkv
        row = {
            "group": group, "shape": [[hq, 512, 128], [hkv, 512, 128]],
            "ms": time_ms(torch, lambda: pf.prefill_flash(q, k, v,
                                                          group=group)),
            "plain_ms": time_ms(torch, lambda: prefill_ref(q, k, v,
                                                           group=group)),
            "library_ms": time_ms(torch, library_attention(torch, q, k, v)),
        }
        row["bound_ms"], row["bound_by"] = flash_bound_ms(hq, 512, 128, hkv,
                                                          2, "bfloat16")
        k1_groups.append(row)
        print(f"[kernels] K1 bf16 Hq={hq} Hkv={hkv} D=128 S=512: "
              + json.dumps(row), flush=True)
    # K1 on the remaining configs' prefill paths: Qwen2-VL (group 8, 32 q
    # heads, D 128) and SeamlessM4T's decoder (group 1, D 64), bf16, S 512.
    k1_remaining = []
    for hq, hkv, d in K1_REMAINING_SHAPES:
        q = rand_rc((hq, 512, d), torch.bfloat16)
        k, v = rand_rc((hkv, 512, d), torch.bfloat16), rand_rc(
            (hkv, 512, d), torch.bfloat16)
        group = hq // hkv
        row = {
            "group": group, "shape": [[hq, 512, d], [hkv, 512, d]],
            "ms": time_ms(torch, lambda: pf.prefill_flash(q, k, v,
                                                          group=group)),
            "plain_ms": time_ms(torch, lambda: prefill_ref(q, k, v,
                                                           group=group)),
            "library_ms": time_ms(torch, library_attention(torch, q, k, v)),
        }
        row["bound_ms"], row["bound_by"] = flash_bound_ms(hq, 512, d, hkv,
                                                          2, "bfloat16")
        k1_remaining.append(row)
        print(f"[kernels] K1 bf16 Hq={hq} Hkv={hkv} D={d} S=512: "
              + json.dumps(row), flush=True)
    k2_bytes = 2 * k32.numel() * (4 + 2)
    k2 = {
        "ms": time_ms(torch, lambda: pf.cache_cast(k32, v32, torch.bfloat16)),
        "plain_ms": time_ms(torch, lambda: cache_cast_ref(k32, v32,
                                                          torch.bfloat16)),
        "library_ms": time_ms(torch, lambda: (k32.to(torch.bfloat16),
                                              v32.to(torch.bfloat16))),
        "bound_ms": 1e3 * k2_bytes / HBM_BYTES_PER_S,
    }
    print(f"[kernels] K2 f32->bf16 (2, 128, 128) x2: {json.dumps(k2)}",
          flush=True)
    k2_large = {
        "shape": list(K2_LARGE_SHAPE),
        "ms": time_ms(torch, lambda: pf.cache_cast(kl, vl, torch.bfloat16)),
        "plain_ms": time_ms(torch, lambda: cache_cast_ref(kl, vl,
                                                          torch.bfloat16)),
        "library_ms": time_ms(torch, lambda: (kl.to(torch.bfloat16),
                                              vl.to(torch.bfloat16))),
        "bound_ms": 1e3 * 2 * kl.numel() * (4 + 2) / HBM_BYTES_PER_S,
        "bound_by": "bytes"}
    print(f"[kernels] K2 f32->bf16 {K2_LARGE_SHAPE} x2: "
          f"{json.dumps(k2_large)}", flush=True)
    del kl, vl

    # Launches of each main-path run, by run: every count is set to 0 just
    # before the run and read just after it.
    counters = (pf.LAUNCHES, mm.LAUNCHES, fa.LAUNCHES, k5.LAUNCHES)
    by_path: dict[str, dict[str, int]] = {}

    def zero_counts() -> None:
        for c in counters:
            for key in c:
                c[key] = 0

    def read_counts(path: str) -> dict[str, int]:
        by_path[path] = {key: n for c in counters for key, n in c.items()}
        return by_path[path]

    def k1_on_seen(tag: str, seen) -> float:
        """K1 against its plain version on the inputs a path gave it."""
        err = 0.0
        for (qs, _, dt), ((q, k, v), kw) in sorted(seen.items(),
                                                    key=lambda kv: kv[0][0]):
            name = f"K1 on {tag} inputs q {qs} group {kw['group']} {str(dt)[6:]}"
            out, _, _ = pf.prefill_flash(q, k, v, group=kw["group"])
            torch.cuda.synchronize()
            ref, _, _ = prefill_ref(q, k, v, group=kw["group"])
            e = check_close(torch, name, out, ref, str(dt)[6:])
            err = max(err, e)
            print(f"[{tag}] {name}: max abs err {e:.3e}", flush=True)
        return err

    def k5_on_seen(tag: str, seen) -> float:
        """K5 against its plain version on the inputs a path gave it."""
        err = 0.0
        for (xs, _, dt), ((xdt, la, bg, cg), kw) in sorted(
                seen.items(), key=lambda kv: kv[0][0]):
            name = f"K5 on {tag} inputs xdt {xs} {str(dt)[6:]} chunk {kw['chunk']}"
            y, hf = k5.ssd_scan(xdt, la, bg, cg, **kw)
            torch.cuda.synchronize()
            ry, rh = ssd_scan_plain(
                xdt, la, torch.repeat_interleave(bg, kw["rep"], 0),
                torch.repeat_interleave(cg, kw["rep"], 0), chunk=kw["chunk"])
            e = max(check_close(torch, f"{name} y", y, ry, str(dt)[6:]),
                    check_close(torch, f"{name} state", hf, rh, str(dt)[6:]))
            err = max(err, e)
            print(f"[{tag}] {name}: max abs err {e:.3e}", flush=True)
        return err

    # The engine's two routes: compiled (the default: its decode step and
    # prefill buckets captured as CUDA graphs, ``serve/compiled.py``) and
    # eager (``compile_steps=False``).
    fleet_spec = "fast=2.0^prefill,slow=1.0x4^decode"

    def route_result(reqs, wall_s: float, spent: dict, log: dict,
                     launches: dict) -> dict:
        """One serve's figures: tokens by request, wall, host ms a decode
        step and a prefill (``wall_split``), the first decode steps' logits
        and the graph counts (``step_log``), the kernels' launches."""
        n_tok = sum(len(r.out_tokens) for r in reqs)
        (n_pre, pre_s), (n_step, step_s) = spent["prefill"], spent["step"]
        # A decode step from its fourth on: on the compiled route a replay.
        later = sorted(t for seq in log["step_s"].values() for t in seq[3:])
        return {"tokens": [list(r.out_tokens) for r in reqs],
                "wall_s": wall_s, "tokens_per_s": n_tok / wall_s,
                "steps": n_step, "step_ms": 1e3 * step_s / max(n_step, 1),
                "later_ms": 1e3 * later[len(later) // 2] if later else 0.0,
                "prefill_ms": 1e3 * pre_s / max(n_pre, 1),
                "decode": log["decode"], "graphs": log["graphs"],
                "launches": dict(launches)}

    def eager_job(job: ServeJob, model, params) -> ServeJob:
        """``job`` on engines of the eager route."""
        def make(spec):
            return DecodeEngine(model, params, max_batch=spec.concurrency,
                                max_seq=job.max_seq, name=spec.name,
                                compile_steps=False)

        return dataclasses.replace(job, model=None, params=None,
                                   engine_factory=make)

    def eager_serve(path: str, job: ServeJob, model, params) -> dict:
        """``job``'s requests once more, the model already loaded, through
        engines on the eager route; its launches counted as ``path``."""
        j = eager_job(job, model, params)
        torch.cuda.synchronize()
        zero_counts()
        with wall_split(DecodeEngine, ("prefill", "insert", "step")) as spent, \
                step_log(DecodeEngine, compiled_steps.STATS) as log:
            t0 = time.perf_counter()
            Cluster(fleet_spec).serve(j)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        return route_result(j.requests, wall_s, spent, log, read_counts(path))

    def compare_routes(tag: str, fast: dict, slow: dict) -> None:
        """The compiled route against the eager route on one fleet serve:
        every request's tokens equal (else fail), and the kernels' launches;
        the decode logits' difference by step (bitwise expected), host ms a
        decode step and a prefill, tokens/s, graphs captured, capture
        seconds and graph-pool bytes printed."""
        for rid, (a, b) in enumerate(zip(fast["tokens"], slow["tokens"],
                                         strict=True)):
            if a != b:
                fail(f"{tag}: request {rid}'s tokens differ: compiled route "
                     f"{a}, eager route {b}")
        if fast["launches"] != slow["launches"]:
            fail(f"{tag}: launches differ: compiled {fast['launches']}, "
                 f"eager {slow['launches']}")
        g = fast["graphs"]
        if g["captures"] < 1 or slow["graphs"]["captures"]:
            fail(f"{tag}: {g['captures']} graphs captured on the compiled "
                 f"route, {slow['graphs']['captures']} on the eager route")
        diffs: dict[int, float] = {}
        for name, seq in fast["decode"].items():
            for i, (a, b) in enumerate(zip(seq, slow["decode"].get(name, ()))):
                diffs[i] = max(diffs.get(i, 0.0), float(np.abs(a - b).max()))
        if len(diffs) < 3:
            fail(f"{tag}: {len(diffs)} decode steps compared, expected 3")
        worst = max(diffs.values())
        print(f"[{tag}] {card}: compiled route against eager route: the "
              f"tokens of all {len(fast['tokens'])} requests equal, launches "
              f"equal {json.dumps({k: n for k, n in fast['launches'].items() if n})}"
              f"; decode logits max abs diff (over the engines) at step 1 "
              f"(the warm-up) {diffs[0]:.3e}, step 2 (capture + replay) "
              f"{diffs[1]:.3e}, step 3 (replay) {diffs[2]:.3e}: "
              f"{'bitwise equal' if worst == 0 else 'NOT bitwise equal'}; "
              f"host ms a decode step {fast['step_ms']:.3f} compiled, "
              f"{slow['step_ms']:.3f} eager ({fast['steps']} / "
              f"{slow['steps']} steps; the median of the steps from each "
              f"engine's fourth on, inputs to logits on the host: "
              f"{fast['later_ms']:.3f} / {slow['later_ms']:.3f}); host ms "
              f"a prefill "
              f"{fast['prefill_ms']:.3f} / {slow['prefill_ms']:.3f}; "
              f"tokens/s {fast['tokens_per_s']:.2f} compiled, "
              f"{slow['tokens_per_s']:.2f} eager ({fast['wall_s']:.3f} / "
              f"{slow['wall_s']:.3f} s); graphs captured {g['captures']}, "
              f"replays {g['replays']}, capture {g['capture_s']:.3f} s, "
              f"graph pools {g['pool_bytes']} bytes", flush=True)

    def prefill_thrice(tag: str, path: str, model, params, prompt,
                       key: str, per_prefill: int) -> None:
        """One engine prefills ``prompt`` three times (eager warm-up,
        capture + replay, replay): logits, first tokens and caches bitwise
        equal across the three, and ``key``'s kernel counted
        ``per_prefill`` times each."""
        engine = DecodeEngine(model, params, max_batch=1, max_seq=1024,
                              name=f"{tag}-prefill")
        seen, saved = [], engine._prefill_logits

        def prefill_logits(toks, last_pos):
            lg, caches = saved(toks, last_pos)
            seen.append(lg.copy())
            return lg, caches

        engine._prefill_logits = prefill_logits
        handoffs, secs = [], []
        torch.cuda.synchronize()
        zero_counts()
        for i in range(3):
            t0 = time.perf_counter()
            handoffs.append(engine.prefill(Request(
                rid=i, prompt=list(prompt), max_new_tokens=2)))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        n = read_counts(path)[key]
        bucket = handoffs[0].bucket
        if engine._prefills[bucket].graph is None:
            fail(f"{tag}: the bucket-{bucket} prefill was not captured")
        if n != 3 * per_prefill:
            fail(f"{tag}: {key} launched {n} times over three prefills, "
                 f"expected {3 * per_prefill}")
        leaves = [tree_leaves(h.caches) for h in handoffs]
        if not all(np.array_equal(seen[0], lg) for lg in seen[1:]) or \
                len({h.first_token for h in handoffs}) != 1:
            fail(f"{tag}: the three prefills' logits differ")
        if not all(torch.equal(a, b) for other in leaves[1:]
                   for a, b in zip(leaves[0], other, strict=True)):
            fail(f"{tag}: the three prefills' caches differ")
        print(f"[{tag}] {card}: one prompt of {len(prompt)} tokens prefilled "
              f"three times by one engine (bucket {bucket}: eager warm-up, "
              f"capture + replay, replay): logits and {len(leaves[0])} cache "
              f"leaves bitwise equal, first token {handoffs[0].first_token}; "
              f"{key} launched {n} times ({per_prefill} a prefill); host ms "
              f"{', '.join(f'{1e3 * s:.3f}' for s in secs)}", flush=True)
        del handoffs, leaves, engine

    # ------------------------------------------------ 4. model (main path)
    zero_counts()
    cfg32 = get_config("qwen2-1.5b", param_dtype="float32",
                       compute_dtype="float32", cache_dtype="bfloat16")
    model = Model(cfg32)
    plain = Model(dataclasses.replace(cfg32, use_pallas=False))
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize()
    print(f"[model] {cfg32.name} f32 init on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(SEED)
    L, bucket = 100, 128
    toks = np.zeros((1, bucket), np.int64)
    toks[0, :L] = rng.integers(0, cfg32.vocab_size, L)
    batch = {"tokens": torch.as_tensor(toks, device=dev)}
    with torch.no_grad():
        lk, ck = model.prefill(params, batch, last_pos=L - 1)
        lp, cp = plain.prefill(params, batch, last_pos=L - 1)
    torch.cuda.synchronize()
    if tuple(lk.shape) != (1, 1, cfg32.padded_vocab):
        fail(f"model: logits shape {tuple(lk.shape)}")
    model_err = check_close(torch, "model prefill logits (kernel vs plain)",
                            lk, lp, "float32")
    kcache = ck["periods"]["pos0"]["self"].k
    if kcache.dtype != torch.bfloat16 or \
            cp["periods"]["pos0"]["self"].k.dtype != torch.float32:
        fail("model: the kernel branch must return the cache in the cache "
             "dtype and the plain branch uncast")
    tok_k = int(lk[0, 0, :cfg32.vocab_size].argmax())
    tok_p = int(lp[0, 0, :cfg32.vocab_size].argmax())
    if tok_k != tok_p:
        fail(f"model: greedy first tokens differ ({tok_k} vs {tok_p})")
    print(f"[model] prefill L={L} (bucket {bucket}): logits max abs err "
          f"{model_err:.3e}, greedy first token {tok_k} on both paths",
          flush=True)
    read_counts("model")
    del params, lk, lp, ck, cp, kcache
    torch.cuda.empty_cache()

    # ------------------------------------------------ 5. serve (main path)
    cfg = get_config("qwen2-1.5b")
    model = Model(cfg)
    params = model.init(SEED)
    lengths = (5, 20, 40, 90, 150, 300, 420, 500)    # buckets 16 .. 512
    requests = [
        Request(rid=i, prompt=[int(t) for t in rng.integers(0, cfg.vocab_size, n)],
                max_new_tokens=16)
        for i, n in enumerate(lengths)
    ]
    cluster = Cluster(fleet_spec)
    torch.cuda.synchronize()
    zero_counts()
    with wall_split(DecodeEngine, ("prefill", "insert", "step")) as spent, \
            keep_inputs(ops, "_prefill_call") as seen, \
            step_log(DecodeEngine, compiled_steps.STATS) as log:
        t0 = time.perf_counter()
        rep = cluster.serve(ServeJob(requests, model=model, params=params,
                                     max_seq=1024))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    counts = read_counts("serve")
    k1_serve = counts["prefill_flash"]
    fast = route_result(requests, wall_s, spent, log, counts)
    m = rep.metrics
    for r in requests:
        if not r.done or len(r.out_tokens) != 16:
            fail(f"serve: request {r.rid} done={r.done} with "
                 f"{len(r.out_tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.out_tokens):
            fail(f"serve: request {r.rid} emitted a token outside the vocab")
    if m.get("mode") != "disaggregated" or m["n_handoffs"] != len(requests):
        fail(f"serve: mode {m.get('mode')}, {m.get('n_handoffs')} handoffs")
    if k1_serve != len(requests) * N_LAYERS:
        fail(f"serve: K1 launched {k1_serve} times, expected "
             f"{len(requests) * N_LAYERS}")
    n_tok = sum(len(r.out_tokens) for r in requests)
    split = {k: v["mean"] for k, v in m["ttft_split"].items() if k != "n"}
    print(f"[serve] {card}: {len(requests)} requests, {n_tok} tokens in "
          f"{wall_s:.3f} s wall -> {n_tok / wall_s:.2f} tokens/s; "
          f"{m['n_handoffs']} handoffs; K1 launches {k1_serve}; "
          f"TTFT split (sim-clock s, mean) {json.dumps(split)}", flush=True)
    engine_s = sum(sec for _, sec in spent.values())
    print("[serve] host wall split: " + ", ".join(
        f"{name} {n} calls {sec:.3f} s" for name, (n, sec) in spent.items())
        + f", the rest (control plane) {wall_s - engine_s:.3f} s", flush=True)

    # K1 against its plain version on the inputs the serve path gave it.
    buckets = sorted(key[0][1] for key in seen)
    if buckets != [16, 32, 64, 128, 256, 512]:
        fail(f"serve: K1 saw buckets {buckets}, expected 16 .. 512")
    k1_err = max(k1_err, k1_on_seen("serve", seen))
    del seen

    # The compiled route against the eager one, the model loaded (compiled
    # first here; the order alternates over the phases), then one prompt
    # prefilled three times, and the compiled route's busy share.
    def serve_job() -> ServeJob:
        return ServeJob([Request(rid=r.rid, prompt=list(r.prompt),
                                 max_new_tokens=16) for r in requests],
                        model=model, params=params, max_seq=1024)

    slow = eager_serve("serve_eager", serve_job(), model, params)
    compare_routes("serve", fast, slow)
    prefill_thrice("serve", "serve_prefill3", model, params,
                   requests[3].prompt, "prefill_flash", N_LAYERS)
    # Each route's busy share, from a profiled repeat of each.
    print_busy(card, "8 requests x 16 tokens, compiled route", *card_busy(
        torch, lambda: Cluster(fleet_spec).serve(serve_job()),
        kernels=("prefill_flash",), top=6), wall_s, tag="serve",
        kernel="K1")
    print_busy(card, "8 requests x 16 tokens, eager route", *card_busy(
        torch, lambda: Cluster(fleet_spec).serve(eager_job(
            serve_job(), model, params)), kernels=("prefill_flash",)),
        slow["wall_s"], tag="serve", kernel="K1")

    # ------------------------------------------------------------ 6. matmul
    def unit_rand(shape, k, dtype=torch.float32):
        # Entries of scale k**-0.25 give products of order one at any depth k.
        return rand(shape, torch.float32).mul_(k ** -0.25).to(dtype)

    # The reference's kernel sweep (tests/test_kernels.py), then the path's.
    sweep = [(8, 128, 128), (256, 512, 256), (100, 70, 36), (1, 1, 1),
             (513, 129, 257)]
    sweep += [tuple(int(v) for v in np.random.default_rng(s).integers(1, 97, 3))
              for s in range(14)]
    sweep += [(1, 1, 1), (96, 96, 96), (1, 96, 1), (96, 1, 96), (95, 33, 17),
              (64, 32, 96)]
    path_shapes = [(2, 1000, 1000), (1000, 1000, 1000), (2, 4096, 4096)]
    k3_err = {"float32": 0.0, "bfloat16": 0.0}
    for mm_, kk, nn in sweep + path_shapes:
        for dt in (torch.float32, torch.bfloat16):
            dname = str(dt)[6:]
            x, y = unit_rand((mm_, kk), kk, dt), unit_rand((kk, nn), kk, dt)
            name = f"K3 ({mm_}, {kk}) @ ({kk}, {nn}) {dname}"
            before = mm.LAUNCHES["matmul"]
            out = k3_matmul(x, y)
            torch.cuda.synchronize()
            if mm.LAUNCHES["matmul"] != before + 1:
                fail(f"{name}: ops.matmul did not launch K3")
            if out.dtype != dt or tuple(out.shape) != (mm_, nn):
                fail(f"{name}: got {out.dtype} {tuple(out.shape)}")
            err = check_close(torch, name, out, matmul_ref(x, y), dname)
            k3_err[dname] = max(k3_err[dname], err)
            if (mm_, kk, nn) in path_shapes:
                print(f"[matmul] {name}: max abs err {err:.3e}", flush=True)
    print(f"[matmul] K3 against its plain version at {len(sweep + path_shapes)}"
          f" shapes: max abs err f32 {k3_err['float32']:.3e}, bf16 "
          f"{k3_err['bfloat16']:.3e}", flush=True)

    # Row-slice invariance, bitwise: the TDA's 2-row grains.
    x, y = unit_rand((1000, 1000), 1000), unit_rand((1000, 1000), 1000)
    full = k3_matmul(x, y)
    bad = [lo for lo in range(0, 1000, 2)
           if not torch.equal(k3_matmul(x[lo:lo + 2], y), full[lo:lo + 2])]
    x, y = unit_rand((4096, 4096), 4096), unit_rand((4096, 4096), 4096)
    full = k3_matmul(x, y)
    offsets = [int(o) for o in np.random.default_rng(SEED).integers(0, 4095, 64)]
    bad += [lo for lo in offsets
            if not torch.equal(k3_matmul(x[lo:lo + 2], y), full[lo:lo + 2])]
    if bad:
        fail(f"K3: 2-row slices at rows {bad[:8]} differ from the full product")
    print("[matmul] K3 row slices: all 500 two-row slices of a 1000-square "
          "product and 64 seeded offsets at n = 4096 bitwise equal to the "
          "full product", flush=True)
    del x, y, full

    # K3's two tiles as built: registers, static shared memory, spills.
    k3_build = build_report(
        build_logs, "matmul", mm.load_library()._name,
        ("matmul_strip_kernel", "matmul_kernel"), lambda name, d: 0,
        main={n: (f"{n}<float>", False) for n in ("matmul_strip_kernel",
                                                  "matmul_kernel")})
    for name, info in sorted(k3_build.items()):
        print(f"[matmul] build {name}: {json.dumps(info)}", flush=True)

    k3_rows = []
    for mm_, kk, nn in path_shapes:
        x, y = unit_rand((mm_, kk), kk), unit_rand((kk, nn), kk)
        row = {
            "shape": [mm_, kk, nn],
            "ms": time_ms(torch, lambda: k3_matmul(x, y)),
            # The plain version loops over k in Python: few, long calls.
            "plain_ms": time_ms(torch, lambda: matmul_ref(x, y), iters=2,
                                reps=3, warmup=1),
            "library_ms": time_ms(torch, lambda: torch.matmul(x, y)),
        }
        row["bound_ms"], row["bound_by"] = matmul_bound_ms(mm_, kk, nn, 4,
                                                           "float32")
        k3_rows.append(row)
        print(f"[matmul] {card}: K3 f32 ({mm_}, {kk}) @ ({kk}, {nn}): "
              + json.dumps(row), flush=True)
    del x, y

    # ------------------------------------------------- 7. paper (main path)
    paper = paper_config()
    n = max(paper.sizes)
    fleet = FleetSpec.from_perfs(paper.machines, prefix="sp")
    a, b = unit_rand((n, n), n), unit_rand((n, n), n)
    single = k3_matmul(a, b)           # K3's single-device product
    torch.cuda.synchronize()
    n_grains = -(-n // 2)
    cluster = Cluster(fleet)
    with grain_split(ThinClient, k3_matmul) as (k3_timed, spent):
        zero_counts()
        t0 = time.perf_counter()
        rep = cluster.simulate(MatmulJob(a, b, n_jobs=3, matmul_fn=k3_timed))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        k3_paper = read_counts("paper")["matmul"]
    if k3_paper != 3 * n_grains:
        fail(f"paper: K3 launched {k3_paper} times, expected {3 * n_grains}")
    if not torch.equal(rep.artifact, single):
        fail("paper: the distributed product differs from K3's single-device "
             "product")
    paper_err = check_close(torch, "paper product vs torch.matmul",
                            rep.artifact, a @ b, "float32")
    print(f"[paper] {card}: {fleet}, n = {n} f32, 3 jobs: {k3_paper} K3 "
          f"launches, product bitwise equal to K3's single-device product, "
          f"max_abs_err vs torch.matmul {rep.metrics['max_abs_err']:.3e}; "
          f"{wall_s:.3f} s wall; grains per provider "
          f"{json.dumps(rep.shares())}; sim time per job "
          f"{[round(p.sim_time_s, 4) for p in rep.phases]} s, quality "
          f"{[round(p.quality, 4) for p in rep.phases]}", flush=True)
    print(f"[paper] host wall split: K3 launches {spent['launches']} calls "
          f"{spent['launch_s']:.3f} s, waits for the card "
          f"{spent['grain_s'] - spent['launch_s']:.3f} s, the rest (control "
          f"plane) {wall_s - spent['grain_s']:.3f} s", flush=True)
    print_busy(card, f"n = {n}, 3 jobs", *card_busy(torch, lambda: Cluster(
        fleet).simulate(MatmulJob(a, b, n_jobs=3, matmul_fn=k3_matmul))),
        wall_s)

    zero_counts()
    rep = Cluster(fleet).simulate(MatmulJob(a, b, matmul_fn=k3_matmul),
                                  scenario="kill:sp1@25%")
    torch.cuda.synchronize()
    k3_kill = read_counts("paper_kill")["matmul"]
    if k3_kill != n_grains or not torch.equal(rep.artifact, single):
        fail(f"paper under kill:sp1@25%: {k3_kill} K3 launches, bitwise "
             f"equal {torch.equal(rep.artifact, single)}")
    print(f"[paper] kill:sp1@25%: {k3_kill} K3 launches, product bitwise "
          f"equal; grains per provider {json.dumps(rep.shares())}", flush=True)

    n4 = 4096
    a4, b4 = unit_rand((n4, n4), n4), unit_rand((n4, n4), n4)
    single4 = k3_matmul(a4, b4)
    torch.cuda.synchronize()
    with grain_split(ThinClient, k3_matmul) as (k3_timed, spent):
        zero_counts()
        t0 = time.perf_counter()
        rep = Cluster(fleet).simulate(MatmulJob(a4, b4, matmul_fn=k3_timed))
        torch.cuda.synchronize()
        wall4_s = time.perf_counter() - t0
        k3_4096 = read_counts("paper_4096")["matmul"]
    if k3_4096 != n4 // 2 or not torch.equal(rep.artifact, single4):
        fail(f"paper n = {n4}: {k3_4096} K3 launches, bitwise equal "
             f"{torch.equal(rep.artifact, single4)}")
    check_close(torch, f"paper n = {n4} vs torch.matmul", rep.artifact,
                a4 @ b4, "float32")
    print(f"[paper] {card}: n = {n4} f32, 1 job: {k3_4096} K3 launches in "
          f"{wall4_s:.3f} s wall, product bitwise equal to K3's, max_abs_err "
          f"vs torch.matmul {rep.metrics['max_abs_err']:.3e}", flush=True)
    print(f"[paper] n = {n4} host wall split: K3 launches {spent['launches']} "
          f"calls {spent['launch_s']:.3f} s, waits for the card "
          f"{spent['grain_s'] - spent['launch_s']:.3f} s, the rest (control "
          f"plane) {wall4_s - spent['grain_s']:.3f} s", flush=True)
    print_busy(card, f"n = {n4}, 1 job", *card_busy(torch, lambda: Cluster(
        fleet).simulate(MatmulJob(a4, b4, matmul_fn=k3_matmul))), wall4_s)
    del a4, b4, single4, rep

    def fig3(k: int, homogenize: bool) -> float:
        return Cluster(fleet.take(k), homogenize=homogenize, adaptive=False,
                       priors="spec").simulate(SimJob(size=800)).measured_speedup

    het = [fig3(k, False) for k in range(1, len(fleet) + 1)]
    hom = [fig3(k, True) for k in range(1, len(fleet) + 1)]
    print("[paper] Fig-3 (size 800, sim clock): workers | equal-split | "
          "homogenized", flush=True)
    for k, (e, h) in enumerate(zip(het, hom, strict=True), start=1):
        print(f"[paper] {k:7d} | {e:6.2f} | {h:6.2f}", flush=True)
    print(f"[paper] max equal-split {max(het):.2f} (paper: 2.8), max "
          f"homogenized {max(hom):.2f} (paper: 3.6)", flush=True)

    # ----------------------------- 8. wallclock (the bench_wallclock flow)
    spec = FleetSpec.parse("4:3:2:1", prefix="w")
    band, measured = 0.35, {}
    for label, sc in (("steady", None), ("halving", f"halve:{spec.names[0]}@50%")):
        job = SimJob(size=96)
        sim = Cluster(spec, priors="spec", default_profile="local").simulate(
            job, scenario=sc)
        wb = WallclockBackend(side=WALLCLOCK_SIDE)
        t0 = time.perf_counter()
        wc = Cluster(spec, priors="spec", backend=wb).simulate(job, scenario=sc)
        wall_s = time.perf_counter() - t0
        pred, meas = sim.predicted_speedup, wc.measured_speedup
        rel_err = abs(meas - pred) / pred
        measured[label] = meas
        print(f"[wallclock] {card}: {label} [{sc or 'no fault'}] sim "
              f"predicted {pred:.4f}x vs measured {meas:.4f}x (rel_err "
              f"{rel_err:.4f}, band {band}); sim-measured "
              f"{sim.measured_speedup:.4f}x; side {wb.side}, unit_s "
              f"{wb.unit_s:.4e} s; {wall_s:.3f} s wall; "
              f"{wc.metrics['wallclock']}", flush=True)
        if wc.backend != "wallclock[1d]":
            fail(f"wallclock: backend label {wc.backend}")
        if rel_err > band:
            fail(f"wallclock {label}: rel_err {rel_err:.4f} outside {band}")
    if measured["halving"] >= measured["steady"]:
        fail(f"wallclock: halved run measured {measured['halving']:.4f}x, "
             f"not below the steady {measured['steady']:.4f}x")

    # The unit op's routes in one process: on the compiled route (the
    # default) each op of a grain's chain is one graph launch, and the
    # chain ends in the eager route's bits (compile_op=False), with one
    # worker stream (overlap) and without; each route's calibrated unit_s
    # at both sides.
    from repro_torch.core import SimWorker

    unit_s = {}
    for side in (WALLCLOCK_SIDE, WALLCLOCK_SMALL_SIDE):
        for overlap in (False, True):
            ends = {}
            for compile_op in (True, False):
                wb = WallclockBackend(side=side, overlap=overlap,
                                      compile_op=compile_op,
                                      calibration_reps=UNIT_OP_REPS)
                if not overlap:
                    unit_s[f"{side}_{'graph' if compile_op else 'eager'}"] = \
                        wb.unit_s
                worker = SimWorker("w0", 12 / UNIT_OP_CHAIN)
                # Two grains: in overlap mode the first captures the
                # worker's own chain; the second is counted.
                for grain in range(2):
                    replays0 = compiled_steps.STATS["replays"]
                    handle = wb.launch(None, worker, grain, 1.0, 0.0)
                    if handle.done is not None:
                        handle.done.synchronize()
                    torch.cuda.synchronize()
                replays = compiled_steps.STATS["replays"] - replays0
                if handle.k != UNIT_OP_CHAIN or replays != (
                        UNIT_OP_CHAIN if compile_op else 0):
                    fail(f"wallclock unit op (side {side}, overlap "
                         f"{overlap}, compile_op {compile_op}): {handle.k} "
                         f"ops, {replays} graph launches")
                ends[compile_op] = handle.value.clone()
                del wb, handle
            if not torch.equal(ends[True], ends[False]):
                fail(f"wallclock unit op (side {side}, overlap {overlap}): "
                     f"the graph route's chain differs from the eager one's")
        print(f"[wallclock] {card}: side {side}: a chain of {UNIT_OP_CHAIN} "
              f"unit ops is {UNIT_OP_CHAIN} graph launches on the compiled "
              f"route, bitwise the eager route's (with and without a worker "
              f"stream); unit_s over {UNIT_OP_REPS} ops: graph "
              f"{unit_s[f'{side}_graph']:.4e} s, eager "
              f"{unit_s[f'{side}_eager']:.4e} s (eager / graph "
              f"{unit_s[f'{side}_eager'] / unit_s[f'{side}_graph']:.3f})",
              flush=True)

    wb = WallclockBackend(side=WALLCLOCK_SIDE)
    zero_counts()
    t0 = time.perf_counter()
    rep = Cluster(spec, backend=wb).simulate(MatmulJob(a, b,
                                                       matmul_fn=k3_matmul))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    k3_wc = read_counts("wallclock")["matmul"]
    if rep.backend != "wallclock[1d]" or k3_wc != n_grains or \
            not torch.equal(rep.artifact, single):
        fail(f"wallclock MatmulJob: {rep.backend}, {k3_wc} K3 launches, "
             f"bitwise equal {torch.equal(rep.artifact, single)}")
    print(f"[wallclock] {card}: MatmulJob n = {n} on {rep.backend}: {k3_wc} "
          f"K3 launches, product bitwise equal to K3's; measured speedup "
          f"{rep.measured_speedup:.4f}x (predicted {rep.predicted_speedup:.4f}"
          f"x); grains per worker {json.dumps(rep.shares())}; {wall_s:.3f} s "
          f"wall; {rep.metrics['wallclock']}", flush=True)
    del a, b, single, rep

    # ------------------ 9. serve under the wall-clock backend (main path)
    wc_requests = [
        Request(rid=i, prompt=[int(t) for t in rng.integers(0, cfg.vocab_size, n)],
                max_new_tokens=8)
        for i, n in enumerate((20, 90, 150, 300))
    ]
    cluster = Cluster("fast=2.0^prefill,slow=1.0x4^decode", backend="wallclock")
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    rep = cluster.serve(ServeJob(wc_requests, model=model, params=params,
                                 max_seq=1024))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    k1_wc = read_counts("serve_wallclock")["prefill_flash"]
    for r in wc_requests:
        if not r.done or len(r.out_tokens) != 8:
            fail(f"serve wallclock: request {r.rid} done={r.done} with "
                 f"{len(r.out_tokens)} tokens")
    if rep.backend != "wallclock[1d]" or k1_wc != len(wc_requests) * N_LAYERS:
        fail(f"serve wallclock: backend {rep.backend}, K1 launches {k1_wc}")
    n_tok = sum(len(r.out_tokens) for r in wc_requests)
    print(f"[serve-wallclock] {card}: {len(wc_requests)} requests, {n_tok} "
          f"tokens in {wall_s:.3f} s wall -> {n_tok / wall_s:.2f} tokens/s "
          f"on {rep.backend}; {rep.metrics['n_handoffs']} handoffs; K1 "
          f"launches {k1_wc}", flush=True)

    del cluster, rep, model, params
    gc.collect()
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 10. K4
    # K4's forward and backward against their plain versions on the card
    # (the forward directly, the backward against autograd through it): the
    # reference's kernel-test shapes (tests/test_kernels.py: causal and not,
    # GQA, the x30-magnitude logits), Sq != Skv both ways, ragged S, and
    # the training path's q (16, 1024, 128), k/v (2, 1024, 128).
    def k4_inputs(b, sq, skv, hq, hkv, d, dt, mag=1.0, draw=rand):
        q = (draw((b * hq, sq, d), torch.float32) * mag).to(dt)
        k = (draw((b * hkv, skv, d), torch.float32) * mag).to(dt)
        return q, k, draw((b * hkv, skv, d), dt)

    # The kernels as built, bf16 and f32: registers, spills, shared memory,
    # and HMMA instructions in their SASS (a spill fails; so does no HMMA in
    # a kernel whose products run on the tensor cores: all but the f32
    # forward, whose products are f32 FMAs, and the reductions).
    k4_build = {}
    for dtype_code, names in ((1, K4_BF16_KERNELS), (0, K4_F32_KERNELS)):
        reduce_key = "flash_dkdv_reduce_kernel<{}>".format(
            "bf16" if dtype_code else "float")
        k4_build.update(build_report(
            build_logs, "flash_attention", fa.load_library()._name, names,
            lambda name, d, c=dtype_code, n=names: int(
                fa.load_library().flash_attention_smem_bytes(
                    n.index(name.split("<")[0]), d, c)),
            main={"flash_dkdv_reduce_kernel": (reduce_key, False),
                  "flash_fwd_f32_kernel": ("flash_fwd_f32_kernel<128>",
                                           False)}))
    for name, info in sorted(k4_build.items()):
        print(f"[k4] build {name}: {json.dumps(info)}", flush=True)

    k4_err = {"fwd": 0.0, "dq": 0.0, "dkdv": 0.0}
    k4_cases = [(2, 128, 128, 4, 2, 64, 1.0), (1, 256, 256, 2, 2, 32, 1.0),
                (2, 64, 64, 4, 1, 16, 1.0), (1, 64, 64, 1, 1, 16, 30.0),
                (1, 40, 72, 4, 2, 16, 1.0), (1, 130, 48, 4, 2, 64, 1.0),
                (1, 100, 100, 4, 2, 16, 1.0), (1, 1024, 1024, 16, 2, 128, 1.0)]
    # Tile edges of the 64-row tiles and 32-query steps: every Sq and Skv of
    # 1, 17, 63, 65, 127 and 129, Sq above and below Skv, groups 1 to 8, and
    # every compiled D; and group 48 (Granite-34B's one KV head for 48 q
    # heads, dK/dV's f32 partials of 48 heads a KV row).  Their bf16
    # gradients are held against autograd through the plain version in f32
    # on the same bf16 values: on bf16 leaves the plain version rounds each
    # q head's dK and dV to bf16 before summing the group, which at Skv = 1
    # and group 8 alone misses the exact gradient by more than the
    # tolerance (tests/test_torch_flash_attention.py shows it).
    k4_edge_cases = [(1, 1, 1, 1, 1, 16, 1.0), (1, 1, 129, 2, 1, 32, 1.0),
                     (1, 129, 1, 8, 1, 64, 1.0), (1, 17, 17, 2, 1, 128, 1.0),
                     (2, 63, 65, 4, 2, 32, 1.0), (1, 65, 63, 8, 1, 16, 1.0),
                     (1, 127, 129, 8, 1, 128, 1.0),
                     (1, 129, 127, 2, 2, 64, 1.0),
                     (1, 65, 127, 2, 1, 16, 1.0), (1, 129, 17, 4, 2, 128, 1.0),
                     (1, 128, 128, 48, 1, 128, 1.0), (1, 65, 129, 48, 1, 64, 1.0)]
    n_checked = 0
    for b, sq, skv, hq, hkv, d, mag in k4_cases + k4_edge_cases:
        exact_grads = (b, sq, skv, hq, hkv, d, mag) in k4_edge_cases
        for causal in (True, False):
            for dt in (torch.float32, torch.bfloat16):
                dname = str(dt)[6:]
                name = (f"K4 b={b} Sq={sq} Skv={skv} Hq={hq} Hkv={hkv} D={d}"
                        f"{' x30' if mag != 1.0 else ''} "
                        f"{'causal' if causal else 'full'} {dname}")
                group = hq // hkv
                q, k, v = k4_inputs(b, sq, skv, hq, hkv, d, dt, mag)
                dout = rand(q.shape, dt)
                leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
                before = dict(fa.LAUNCHES)
                out = fa.flash_attention(*leaves, causal=causal, group=group)
                grads = torch.autograd.grad(out, leaves, dout)
                torch.cuda.synchronize()
                if any(fa.LAUNCHES[n] != before[n] + 1 for n in K4_KERNELS):
                    fail(f"{name}: the forward and backward did not launch "
                         f"each K4 kernel once")
                ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
                ref = flash_attention_ref(*ref_leaves, causal=causal,
                                          group=group)
                ref_grads = torch.autograd.grad(ref, ref_leaves, dout)
                if exact_grads:
                    ref_leaves = [t.float().requires_grad_(True)
                                  for t in (q, k, v)]
                    ref_grads = torch.autograd.grad(
                        flash_attention_ref(*ref_leaves, causal=causal,
                                            group=group),
                        ref_leaves, dout.float())
                k4_err["fwd"] = max(k4_err["fwd"], check_close(
                    torch, f"{name} out", out, ref, dname))
                k4_err["dq"] = max(k4_err["dq"], check_close(
                    torch, f"{name} dq", grads[0], ref_grads[0], dname,
                    GRAD_TOL))
                for which, g, r in zip("kv", grads[1:], ref_grads[1:],
                                       strict=True):
                    k4_err["dkdv"] = max(k4_err["dkdv"], check_close(
                        torch, f"{name} d{which}", g, r, dname, GRAD_TOL))
                n_checked += 1
    print(f"[k4] forward and backward against their plain versions in "
          f"{n_checked} cases ({4 * len(k4_edge_cases)} at tile edges): max "
          f"abs err out {k4_err['fwd']:.3e}, dq "
          f"{k4_err['dq']:.3e}, dk/dv {k4_err['dkdv']:.3e}", flush=True)

    # The path's shape: the backward twice on the same inputs, bitwise.
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = k4_inputs(1, TRAIN_SEQ, TRAIN_SEQ, 16, 2, 128, dt)
        _, lse, out32 = fa.flash_attention_fwd(q, k, v, group=8)
        dout = rand(q.shape, dt)
        first = fa.flash_attention_bwd(q, k, v, out32, lse, dout, group=8)
        again = fa.flash_attention_bwd(q, k, v, out32, lse, dout, group=8)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(first, again,
                                                     strict=True)):
            fail(f"K4 backward {dt}: two runs on the same inputs differ")
    print("[k4] backward at q (16, 1024, 128), k/v (2, 1024, 128), bf16 and "
          "f32: two runs bitwise equal (dq, dk, dv)", flush=True)

    # Timings at the path's shape, in bf16 and on the f32 route (the f32
    # grain check's flash_fwd_f32_kernel, flash_dq_tf32_kernel and
    # flash_dkdv_tf32_kernel), beside the plain versions, PyTorch's SDPA (a
    # yardstick only: the port never calls it; TF32 off) and the bound.
    sdpa = torch.nn.functional.scaled_dot_product_attention
    k4_timed = {}
    for dt, dname, itemsize in ((torch.bfloat16, "bf16", 2),
                                (torch.float32, "f32", 4)):
        q, k, v = k4_inputs(1, TRAIN_SEQ, TRAIN_SEQ, 16, 2, 128, dt)
        _, lse, out32 = fa.flash_attention_fwd(q, k, v, group=8)
        dout = rand(q.shape, dt)
        _, drow = fa.flash_attention_bwd_dq(q, k, v, out32, lse, dout,
                                            group=8)
        plain_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        plain_out = flash_attention_ref(*plain_leaves, group=8)
        lib_leaves = [t[None].clone().requires_grad_(True) for t in (q, k, v)]
        lib_out = sdpa(*lib_leaves, is_causal=True, enable_gqa=True)

        def lib_fwd_bwd():
            o = sdpa(*lib_leaves, is_causal=True, enable_gqa=True)
            return torch.autograd.grad(o, lib_leaves, dout[None])

        plain_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
            plain_out, plain_leaves, dout, retain_graph=True))
        lib_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
            lib_out, lib_leaves, dout[None], retain_graph=True))
        rows = {
            "fwd": {"ms": time_ms(torch, lambda: fa.flash_attention_fwd(
                        q, k, v, group=8)),
                    "plain_ms": time_ms(torch, lambda: flash_attention_ref(
                        q, k, v, group=8)),
                    "library_ms": time_ms(torch, library_attention(
                        torch, q, k, v))},
            "dq": {"ms": time_ms(torch, lambda: fa.flash_attention_bwd_dq(
                       q, k, v, out32, lse, dout, group=8)),
                   "plain_ms": plain_bwd_ms, "library_ms": lib_bwd_ms},
            "dkdv": {"ms": time_ms(torch, lambda: fa.flash_attention_bwd_dkdv(
                         q, k, v, lse, dout, drow, group=8)),
                     "plain_ms": plain_bwd_ms, "library_ms": lib_bwd_ms},
        }
        for part, row in rows.items():
            row["bound_ms"], row["bound_by"] = k4_bound_ms(
                16, 2, TRAIN_SEQ, TRAIN_SEQ, 128, itemsize,
                {"bf16": "bfloat16", "f32": "float32"}[dname], True, part)
        k4_timed[dname] = rows
        bwd_ms = time_ms(torch, lambda: fa.flash_attention_bwd(
            q, k, v, out32, lse, dout, group=8))
        print(f"[k4] {card}: {dname} backward (dq then dk/dv) {bwd_ms:.5f} "
              f"ms; plain backward {plain_bwd_ms:.5f} ms; SDPA backward "
              f"{lib_bwd_ms:.5f} ms, SDPA forward+backward "
              f"{time_ms(torch, lib_fwd_bwd):.5f} ms", flush=True)
        del q, k, v, out32, lse, dout, drow, plain_leaves, plain_out
        del lib_leaves, lib_out
    del first, again
    k4_rows, k4_f32 = k4_timed["bf16"], k4_timed["f32"]
    for rows, names, out_type in ((k4_rows, K4_BF16_KERNELS, "bf16"),
                                  (k4_f32, K4_F32_KERNELS, "float")):
        rows["fwd"]["build"] = {names[0]: k4_build[f"{names[0]}<128>"]}
        rows["dq"]["build"] = {names[1]: k4_build[f"{names[1]}<128>"]}
        rows["dkdv"]["build"] = {
            names[2]: k4_build[f"{names[2]}<128>"],
            names[3]: k4_build[f"{names[3]}<{out_type}>"]}
    for dname, rows in k4_timed.items():
        for part, row in rows.items():
            print(f"[k4] {card}: {part} {dname} q (16, 1024, 128) k/v (2, "
                  f"1024, 128) causal: " + json.dumps(row), flush=True)

    # K4 at SeamlessM4T-medium's shapes (16 heads of 64), non-causal: the
    # encoder's Sq = Skv = 512 and the training cross-attention's Sq 64 over
    # Skv 512; forward, dQ and dK/dV against the plain version and autograd
    # through it, bf16 and f32; then timed beside the plain version, SDPA
    # (non-causal) and the bound (device times in phase 15).
    k4_seamless = {}
    h, d = SEAMLESS_HEADS, SEAMLESS_D
    for sq, skv in K4_SEAMLESS_SHAPES:
        for dt, dname, itemsize in ((torch.bfloat16, "bf16", 2),
                                    (torch.float32, "f32", 4)):
            name = f"K4 seamless Sq={sq} Skv={skv} H={h} D={d} full {dname}"
            q, k, v = k4_inputs(1, sq, skv, h, h, d, dt, draw=rand_rc)
            dout = rand_rc(q.shape, dt)
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            before = dict(fa.LAUNCHES)
            out = fa.flash_attention(*leaves, causal=False)
            grads = torch.autograd.grad(out, leaves, dout)
            torch.cuda.synchronize()
            if any(fa.LAUNCHES[n] != before[n] + 1 for n in K4_KERNELS):
                fail(f"{name}: the forward and backward did not launch each "
                     f"K4 kernel once")
            ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            ref = flash_attention_ref(*ref_leaves, causal=False)
            ref_grads = torch.autograd.grad(ref, ref_leaves, dout)
            dtn = str(dt)[6:]
            errs = {"fwd": check_close(torch, f"{name} out", out, ref, dtn),
                    "dq": check_close(torch, f"{name} dq", grads[0],
                                      ref_grads[0], dtn, GRAD_TOL),
                    "dkdv": max(check_close(torch, f"{name} d{w}", g, r, dtn,
                                            GRAD_TOL)
                                for w, g, r in zip("kv", grads[1:],
                                                   ref_grads[1:],
                                                   strict=True))}
            for part, e in errs.items():
                k4_err[part] = max(k4_err[part], e)
            _, lse, out32 = fa.flash_attention_fwd(q, k, v, causal=False)
            _, drow = fa.flash_attention_bwd_dq(q, k, v, out32, lse, dout,
                                                causal=False)
            plain_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            plain_out = flash_attention_ref(*plain_leaves, causal=False)
            lib_leaves = [t[None].clone().requires_grad_(True)
                          for t in (q, k, v)]
            lib_out = sdpa(*lib_leaves, is_causal=False)
            plain_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
                plain_out, plain_leaves, dout, retain_graph=True))
            lib_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
                lib_out, lib_leaves, dout[None], retain_graph=True))
            rows = {
                "fwd": {"ms": time_ms(torch, lambda: fa.flash_attention_fwd(
                            q, k, v, causal=False)),
                        "plain_ms": time_ms(torch, lambda: flash_attention_ref(
                            q, k, v, causal=False)),
                        "library_ms": time_ms(torch, lambda: sdpa(
                            q[None], k[None], v[None], is_causal=False))},
                "dq": {"ms": time_ms(torch, lambda: fa.flash_attention_bwd_dq(
                           q, k, v, out32, lse, dout, causal=False)),
                       "plain_ms": plain_bwd_ms, "library_ms": lib_bwd_ms},
                "dkdv": {"ms": time_ms(
                             torch, lambda: fa.flash_attention_bwd_dkdv(
                                 q, k, v, lse, dout, drow, causal=False)),
                         "plain_ms": plain_bwd_ms, "library_ms": lib_bwd_ms},
            }
            for part, row in rows.items():
                row["max_abs_err"] = errs[part]
                row["bound_ms"], row["bound_by"] = k4_bound_ms(
                    h, h, sq, skv, d, itemsize,
                    {"bf16": "bfloat16", "f32": "float32"}[dname], False,
                    part)
                print(f"[k4] {card}: seamless {part} {dname} q ({h}, {sq}, "
                      f"{d}) k/v ({h}, {skv}, {d}) non-causal: "
                      + json.dumps(row), flush=True)
            k4_seamless[f"{sq}_{skv}_{dname}"] = rows
            del q, k, v, dout, leaves, out, grads, ref_leaves, ref, ref_grads
            del out32, lse, drow, plain_leaves, plain_out, lib_leaves, lib_out

    # K4 at Qwen2-VL-7B's training shape (phase 28), causal, group 8, bf16:
    # forward, dQ and dK/dV against the plain version and autograd through
    # it, then timed beside the plain version, SDPA and the bound (device
    # times in phase 15).
    hq, hkv, sq, d = K4_QWEN2VL_SHAPE
    grp = hq // hkv
    name = f"K4 qwen2-vl q ({hq}, {sq}, {d}) k/v ({hkv}, {sq}, {d}) causal bf16"
    q, k, v = k4_inputs(1, sq, sq, hq, hkv, d, torch.bfloat16, draw=rand_rc)
    dout = rand_rc(q.shape, torch.bfloat16)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention(*leaves, group=grp)
    grads = torch.autograd.grad(out, leaves, dout)
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = flash_attention_ref(*ref_leaves, group=grp)
    ref_grads = torch.autograd.grad(ref, ref_leaves, dout)
    errs = {"fwd": check_close(torch, f"{name} out", out, ref, "bfloat16"),
            "dq": check_close(torch, f"{name} dq", grads[0], ref_grads[0],
                              "bfloat16", GRAD_TOL),
            "dkdv": max(check_close(torch, f"{name} d{w}", g, r, "bfloat16",
                                    GRAD_TOL)
                        for w, g, r in zip("kv", grads[1:], ref_grads[1:],
                                           strict=True))}
    for part, e in errs.items():
        k4_err[part] = max(k4_err[part], e)
    _, lse, out32 = fa.flash_attention_fwd(q, k, v, group=grp)
    _, drow = fa.flash_attention_bwd_dq(q, k, v, out32, lse, dout, group=grp)
    plain_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    plain_out = flash_attention_ref(*plain_leaves, group=grp)
    lib_leaves = [t[None].clone().requires_grad_(True) for t in (q, k, v)]
    lib_out = sdpa(*lib_leaves, is_causal=True, enable_gqa=True)
    plain_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
        plain_out, plain_leaves, dout, retain_graph=True))
    lib_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
        lib_out, lib_leaves, dout[None], retain_graph=True))
    k4_qwen2vl = {
        "fwd": {"ms": time_ms(torch, lambda: fa.flash_attention_fwd(
                    q, k, v, group=grp)),
                "plain_ms": time_ms(torch, lambda: flash_attention_ref(
                    q, k, v, group=grp)),
                "library_ms": time_ms(torch, lambda: sdpa(
                    q[None], k[None], v[None], is_causal=True,
                    enable_gqa=True))},
        "dq": {"ms": time_ms(torch, lambda: fa.flash_attention_bwd_dq(
                   q, k, v, out32, lse, dout, group=grp)),
               "plain_ms": plain_bwd_ms, "library_ms": lib_bwd_ms},
        "dkdv": {"ms": time_ms(torch, lambda: fa.flash_attention_bwd_dkdv(
                     q, k, v, lse, dout, drow, group=grp)),
                 "plain_ms": plain_bwd_ms, "library_ms": lib_bwd_ms},
    }
    for part, row in k4_qwen2vl.items():
        row["max_abs_err"] = errs[part]
        row["shape"] = [[hq, sq, d], [hkv, sq, d]]
        row["bound_ms"], row["bound_by"] = k4_bound_ms(
            hq, hkv, sq, sq, d, 2, "bfloat16", True, part)
        print(f"[k4] {card}: qwen2-vl {part} bf16 q ({hq}, {sq}, {d}) k/v "
              f"({hkv}, {sq}, {d}) causal: " + json.dumps(row), flush=True)
    del q, k, v, dout, leaves, out, grads, ref_leaves, ref, ref_grads
    del out32, lse, drow, plain_leaves, plain_out, lib_leaves, lib_out

    # ------------------------------------------- 11. train (the main path)
    def check_k4_launches(path: str, n_grains: int) -> dict[str, int]:
        counts = read_counts(path)
        want = {n: c * n_grains for n, c in K4_PER_GRAIN.items()}
        got = {n: counts[n] for n in K4_KERNELS}
        if got != want:
            fail(f"{path}: K4 launches {got}, predicted {want}")
        return got

    # 11.1 One grain of full-width Qwen2-1.5B in f32: loss and gradients on
    # the kernel path against use_pallas=False on the card.  The grain is
    # compiled: three calls (the eager warm-up, the capture and its replay,
    # a replay) give the same bits, and the third is held against the plain
    # route.
    cfg32 = get_config("qwen2-1.5b", param_dtype="float32",
                       compute_dtype="float32")
    model = Model(cfg32)
    plain = Model(dataclasses.replace(cfg32, use_pallas=False))
    params = model.init(SEED)
    spec = GrainSpec(1, TRAIN_SEQ, cfg32.vocab_size)
    batch = batch_from_grains(SyntheticSource(spec, seed=SEED), 0, [0], spec,
                              device=dev)
    grain_fn = make_grain_grad_fn(model)
    torch.cuda.synchronize()
    zero_counts()
    grain_k_s, first = [], None
    for call in range(3):
        t0 = time.perf_counter()
        (loss_k, _), grads_k = grain_fn(params, batch)
        torch.cuda.synchronize()
        grain_k_s.append(time.perf_counter() - t0)
        outs = [loss_k] + tree_leaves(grads_k)
        if first is None:
            first = [x.clone() for x in outs]
        elif not all(torch.equal(a, b) for a, b in zip(outs, first,
                                                       strict=True)):
            fail(f"train f32 grain: compiled call {call + 1} differs from "
                 f"the first (eager) call's bits")
    del first, outs
    (step,) = grain_fn.steps
    if step.graph is None:
        fail("train f32 grain: no graph captured by the second call")
    check_k4_launches("train_f32", 3)
    t0 = time.perf_counter()
    (loss_p, _), grads_p = make_grain_grad_fn(plain)(params, batch)
    torch.cuda.synchronize()
    grain_p_s = time.perf_counter() - t0
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    if not (loss_rel <= 1e-4 and torch.isfinite(loss_k)):
        fail(f"train f32 grain: loss {float(loss_k)} on the kernel path vs "
             f"{float(loss_p)} plain (rel err {loss_rel:.3e} > 1e-4)")
    worst = (0.0, None)
    for i, (gk, gp) in enumerate(zip(tree_leaves(grads_k),
                                     tree_leaves(grads_p), strict=True)):
        rel = float(torch.linalg.vector_norm((gk - gp).float())
                    / torch.linalg.vector_norm(gp.float()).clamp_min(1e-30))
        if not rel <= 1e-3:
            fail(f"train f32 grain: gradient leaf {i} {tuple(gk.shape)} "
                 f"relative Frobenius error {rel:.3e} > 1e-3")
        if rel >= worst[0]:
            worst = (rel, (i, tuple(gk.shape)))
    print(f"[train] {card}: one f32 grain of {cfg32.name} (28 layers, "
          f"d_model 1536, vocab 151936), seq {TRAIN_SEQ}: loss "
          f"{float(loss_k):.6f} kernel path vs {float(loss_p):.6f} plain (rel "
          f"err {loss_rel:.3e}); worst gradient leaf relative Frobenius "
          f"error {worst[0]:.3e} (leaf {worst[1]}); compiled, three calls "
          f"bitwise equal; K4 launches over the three "
          f"{json.dumps(by_path['train_f32'])}; host s with the wait: kernel "
          f"path eager warm-up {grain_k_s[0]:.3f}, capture + replay "
          f"{grain_k_s[1]:.3f} (capture {step.capture_s:.3f}, pool "
          f"{step.pool_bytes / 1e9:.3f} GB), replay {grain_k_s[2]:.3f}; "
          f"plain (eager warm-up) {grain_p_s:.3f}", flush=True)
    del model, plain, params, batch, grads_k, grads_p, loss_k, loss_p
    del grain_fn, step
    gc.collect()
    torch.cuda.empty_cache()

    # 11.2 The launcher's HDP flow in bf16: Cluster("4:3:2:1").train with a
    # mid-step straggler, 3 steps of 8 grains, on the compiled route, then
    # on the eager route: the same losses and parameter bits.  Each route's
    # trainer then takes a third, unprofiled step and a fourth under the
    # profiler (steady state: on the compiled route every grain and the
    # update replay).
    cfg = get_config("qwen2-1.5b")
    model = Model(cfg)
    fleet = FleetSpec.parse("4:3:2:1", prefix="pod")
    scenario = f"halve:{fleet.names[0]}@1:25%"
    n_hdp = 3 * TRAIN_GRAINS

    def train_job(steps: int, compile_steps: bool = True) -> TrainJob:
        return TrainJob(model, steps=steps, grains=TRAIN_GRAINS,
                        seq_len=TRAIN_SEQ, compile_steps=compile_steps)

    def hdp_routes(tag: str, model, path: str, check, busy_kernels,
                   kernel: str) -> dict:
        """The flow above on ``model`` (bf16, seq TRAIN_SEQ): the runs
        ``path`` (compiled) and ``path + "_eager"``, each one's launches
        held by ``check(run, n_hdp)``; per route the steps' losses, shares
        and sim-clock times, the host wall split, host ms a grain and an
        update call, graphs, tokens/s, peak memory and the busy share of a
        steady step (``kernel``'s time: the device kernels whose names hold
        one of ``busy_kernels``); both routes' losses, grad norms and every
        parameter leaf (SHA-256) equal.  Returns each route's figures."""
        name = model.cfg.name
        hdp = {}
        for compile_steps in (True, False):
            route = "compiled" if compile_steps else "eager"
            run = path if compile_steps else f"{path}_eager"
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            graphs0 = dict(compiled_steps.STATS)
            with train_split(torch, train_loop) as spent:
                t0 = time.perf_counter()
                rep = Cluster(fleet).train(
                    TrainJob(model, steps=3, grains=TRAIN_GRAINS,
                             seq_len=TRAIN_SEQ, compile_steps=compile_steps),
                    scenario=scenario)
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t0
            graphs = {k: compiled_steps.STATS[k] - graphs0[k]
                      for k in graphs0}
            launches = check(run, n_hdp)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            trainer = rep.artifact
            losses = [p.metrics["loss"] for p in rep.phases]
            if len(losses) != 3 or not all(np.isfinite(x) for x in losses):
                fail(f"{tag} hdp ({route}): losses {losses}")
            if compile_steps and (
                    graphs["captures"] < 2 or trainer._update is None
                    or trainer._update.graph is None
                    or not all(s.graph is not None
                               for s in trainer._grad_fn.steps)):
                fail(f"{tag} hdp: {graphs['captures']} graphs captured; the "
                     f"grain gradient and the update must both be")
            if not compile_steps and graphs["captures"]:
                fail(f"{tag} hdp (eager): the eager route captured a graph")
            for p in rep.phases:
                print(f"[{tag}] {route} step {p.index}: loss "
                      f"{p.metrics['loss']:.6f}, grad norm "
                      f"{p.metrics['grad_norm']:.4f}, shares "
                      f"{json.dumps(dict(p.shares))}, migrated "
                      f"{p.n_migrated}, steals {p.metrics['n_steals']}, "
                      f"sim-clock step time {p.sim_time_s:.4f} s, quality "
                      f"{p.quality:.4f}", flush=True)
            grain_s = spent["grain"][1] - spent["combine"][1]
            rest_s = wall_s - spent["grain"][1] - spent["adamw"][1]
            print(f"[{tag}] {card}: {route} route, {fleet} {scenario}, "
                  f"{len(rep.phases)} steps x {TRAIN_GRAINS} grains of bf16 "
                  f"{name} ({model.cfg.n_layers} layers) at seq "
                  f"{TRAIN_SEQ}: {wall_s:.3f} s wall "
                  f"({n_hdp * TRAIN_SEQ / wall_s:.1f} tokens/s); {kernel} "
                  f"launches {json.dumps(launches)}; peak memory "
                  f"{peak_gb:.2f} GB (torch.cuda.max_memory_allocated)",
                  flush=True)
            grad_gb = sum(x.numel() * x.element_size() for x in
                          tree_leaves(rep.artifact.state.params)) / 1e9
            print(f"[{tag}] {card}: {route} route memory: peak "
                  f"{peak_gb:.2f} GB (torch.cuda.max_memory_allocated), "
                  f"graph pools {graphs['pool_bytes'] / 1e9:.3f} GB, one "
                  f"gradient tree {grad_gb:.3f} GB, at most "
                  f"{spent['waiting']} grains waiting at once in a step "
                  f"(the combine keeps every waiting grain on the card)",
                  flush=True)
            print(f"[{tag}] {route} host wall split: grain gradients "
                  f"{spent['grain'][0]} calls {grain_s:.3f} s, combine "
                  f"{spent['combine'][0]} calls {spent['combine'][1]:.3f} s, "
                  f"AdamW {spent['adamw'][0]} calls "
                  f"{spent['adamw'][1]:.3f} s, the rest (control plane) "
                  f"{rest_s:.3f} s; per step "
                  f"{[round(x, 4) for x in spent['steps']]} s (the "
                  f"combine's and AdamW's calls end in a synchronize)",
                  flush=True)
            gms = [round(1e3 * x, 3) for x in spent["calls"]["grain"]]
            ums = [round(1e3 * x, 3) for x in spent["calls"]["adamw"]]
            replay_grain = None
            if compile_steps:
                replay_grain = float(np.median(gms[2:]))
                print(f"[{tag}] {card}: compiled route: "
                      f"{graphs['captures']} graphs captured in "
                      f"{graphs['capture_s']:.3f} s, pool "
                      f"{graphs['pool_bytes'] / 1e9:.3f} GB, "
                      f"{graphs['replays']} replays; host ms a grain with "
                      f"its wait (warm-up, capture + replay, then replays; "
                      f"the combine's synchronize included): {gms}; a "
                      f"replayed grain {replay_grain:.3f} ms (median); host "
                      f"ms an update (warm-up, capture + replay, replay) "
                      f"{ums}: a replayed update {ums[2]:.3f} ms",
                      flush=True)
            else:
                print(f"[{tag}] eager route: host ms a grain with its wait "
                      f"{gms}; an update {ums}", flush=True)
            hdp[route] = {
                "grad_gb": grad_gb, "waiting": spent["waiting"],
                "pool_gb": graphs["pool_bytes"] / 1e9,
                "loss": losses,
                "grad_norm": [p.metrics["grad_norm"] for p in rep.phases],
                "digests": leaf_digests(torch, tree_leaves,
                                        trainer.state.params),
                "wall_s": wall_s, "peak_gb": peak_gb,
                "tokens_s": n_hdp * TRAIN_SEQ / wall_s,
                "replay_grain_ms": replay_grain, "launches": launches}
            # A third step unprofiled and a fourth profiled, the same
            # trainer.
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.step(3)
            torch.cuda.synchronize()
            steady_s = time.perf_counter() - t0
            prof = card_busy(torch, lambda: trainer.step(4),
                             kernels=busy_kernels, top=12)
            print_busy(card, f"{route} route, a steady step of "
                       f"{TRAIN_GRAINS} grains", *prof, steady_s, tag=tag,
                       kernel=kernel)
            hdp[route].update(steady_s=steady_s, busy=prof[1] / prof[0],
                              kernel_s=prof[2])
            del rep, trainer
        fast, slow = hdp["compiled"], hdp["eager"]
        for key in ("loss", "grad_norm", "digests", "launches"):
            if fast[key] != slow[key]:
                fail(f"{tag} hdp: the compiled and eager routes' {key} "
                     f"differ")
        print(f"[{tag}] compiled vs eager, 3 steps under {scenario}: all "
              f"{len(fast['digests'])} parameter leaves bitwise equal "
              f"(SHA-256), losses {fast['loss']} equal, {kernel} launches "
              f"equal; wall {fast['wall_s']:.3f} s vs {slow['wall_s']:.3f} "
              f"s ({fast['tokens_s']:.1f} vs {slow['tokens_s']:.1f} "
              f"tokens/s), peak {fast['peak_gb']:.2f} GB vs "
              f"{slow['peak_gb']:.2f} GB", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        return hdp

    hdp_routes("train", model, "train_hdp", check_k4_launches,
               K4_BF16_KERNELS, "K4")

    # 11.3 The same 2 steps, static and adaptive: bitwise-equal parameters,
    # compared by a hash of each leaf's bytes.
    runs = {}
    for adaptive in (False, True):
        path = "train_adaptive" if adaptive else "train_static"
        zero_counts()
        rep = Cluster(fleet, adaptive=adaptive).train(train_job(2),
                                                      scenario=scenario)
        torch.cuda.synchronize()
        check_k4_launches(path, 2 * TRAIN_GRAINS)
        runs[adaptive] = {
            "loss": [p.metrics["loss"] for p in rep.phases],
            "grad_norm": [p.metrics["grad_norm"] for p in rep.phases],
            "migrated": [p.n_migrated for p in rep.phases],
            "shares": [dict(p.shares) for p in rep.phases],
            "digests": leaf_digests(torch, tree_leaves,
                                    rep.artifact.state.params),
        }
        del rep
        gc.collect()
        torch.cuda.empty_cache()
    st, ad = runs[False], runs[True]
    for key in ("loss", "grad_norm", "digests"):
        if st[key] != ad[key]:
            fail(f"train: static and adaptive {key} differ")
    print(f"[train] static vs adaptive, compiled route, 2 steps under "
          f"{scenario}: all "
          f"{len(ad['digests'])} parameter leaves bitwise equal (SHA-256), "
          f"losses {ad['loss']} equal; shares static {st['shares']} "
          f"(migrated {st['migrated']}), adaptive {ad['shares']} (migrated "
          f"{ad['migrated']})", flush=True)

    # 11.4 Two steps on the wall-clock backend.
    zero_counts()
    t0 = time.perf_counter()
    rep = Cluster(fleet, backend="wallclock").train(train_job(2))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    check_k4_launches("train_wallclock", 2 * TRAIN_GRAINS)
    losses = [p.metrics["loss"] for p in rep.phases]
    if rep.backend != "wallclock[1d]" or not all(np.isfinite(x)
                                                 for x in losses):
        fail(f"train wallclock: backend {rep.backend}, losses {losses}")
    busy = {w: round(t.busy_s, 4) for w, t in rep.worker_timelines.items()}
    print(f"[train-wallclock] {card}: 2 steps on {rep.backend}, compiled "
          f"route: losses "
          f"{losses}; event-clock step times "
          f"{[round(p.sim_time_s, 4) for p in rep.phases]} s (the unit-op "
          f"chains; each grain's measured gradient seconds go to its "
          f"worker's busy time and heartbeats, as in the reference), busy s "
          f"per worker {json.dumps(busy)}, shares "
          f"{[dict(p.shares) for p in rep.phases]}; {wall_s:.3f} s wall",
          flush=True)
    del rep, model
    gc.collect()
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 12. K5
    # ssd's kernel route against the same op with K5's plain version in
    # K5's place, and against the sequential oracle: the reference's kernel
    # test shapes (tests/test_kernels.py) in f32 and bf16, chunk invariance,
    # a non-divisible S and the dt x 100 decay; then the serving path's
    # shape, checked and timed.
    def ssd_inputs(b, s, h, p, g, n, dt):
        x = rand((b, s, h, p), dt)
        dtv = (rand((b, s, h), torch.float32).abs() * 0.1 + 0.01).to(dt)
        a = -rand((h,), torch.float32).abs() - 0.1
        return (x, dtv, a, rand((b, s, g, n), dt), rand((b, s, g, n), dt),
                rand((h,), torch.float32))

    def ssd_flat(x, dtv, a, bm, cm):
        """K5's inputs, B and C per group, and B and C repeated per head
        (the plain version's interface)."""
        b, s, h, p = x.shape
        g, n = bm.shape[2], bm.shape[3]
        xdt = (x * dtv[..., None]).transpose(1, 2).reshape(b * h, s, p)
        la = (dtv * a[None, None, :]).transpose(1, 2).reshape(b * h, s)
        bg, cg = (t.transpose(1, 2).reshape(b * g, s, n) for t in (bm, cm))
        bf, cf = (torch.repeat_interleave(t, h // g, 0) for t in (bg, cg))
        return xdt.contiguous(), la.contiguous(), bg, cg, bf, cf

    def ssd_unflat(y, hf, x, d):
        b, s, h, p = x.shape
        y = y.reshape(b, h, s, p).transpose(1, 2) + \
            x * d[None, None, :, None].to(x.dtype)
        return y, hf.reshape(b, h, p, hf.shape[-1])

    k5_err = 0.0
    k5_cases = [(shape, 32, dt) for shape in ((2, 96, 4, 16, 2, 8),
                                              (1, 64, 2, 8, 1, 16))
                for dt in (torch.float32, torch.bfloat16)]
    k5_cases += [((1, 96, 2, 8, 1, 4), chunk, torch.float32)
                 for chunk in (16, 32, 64, 96)]
    k5_cases += [((1, 90, 2, 8, 1, 4), 32, dt)
                 for dt in (torch.float32, torch.bfloat16)]
    for shape, chunk, dt in k5_cases:
        dname = str(dt)[6:]
        name = f"K5 (b, s, h, p, g, n) {shape} chunk {chunk} {dname}"
        x, dtv, a, bm, cm, d = ssd_inputs(*shape, dt)
        before = k5.LAUNCHES["ssd_scan"]
        y, hf = mamba_ops.ssd(x, dtv, a, bm, cm, d, chunk=chunk)
        torch.cuda.synchronize()
        if k5.LAUNCHES["ssd_scan"] != before + 1:
            fail(f"{name}: ssd did not launch K5")
        xdt, la, _, _, bf, cf = ssd_flat(x, dtv, a, bm, cm)
        ry, rh = ssd_unflat(*ssd_scan_plain(xdt, la, bf, cf, chunk=chunk),
                            x, d)
        gy, gh = ssd_unflat(*ssd_scan_ref(xdt, la, bf, cf), x, d)
        err = max(check_close(torch, f"{name} y", y, ry, dname),
                  check_close(torch, f"{name} state", hf, rh, dname))
        check_close(torch, f"{name} y vs the sequential oracle", y, gy, dname)
        check_close(torch, f"{name} state vs the sequential oracle", hf, gh,
                    dname)
        k5_err = max(k5_err, err)
        print(f"[k5] {name}: max abs err {err:.3e} (plain version); within "
              f"tolerance of the sequential oracle", flush=True)
    x, dtv, a, bm, cm, d = ssd_inputs(1, 256, 2, 8, 1, 4, torch.float32)
    y, hf = mamba_ops.ssd(x, dtv * 100.0, a, bm, cm, d, chunk=64)
    torch.cuda.synchronize()
    if not (torch.isfinite(y).all() and torch.isfinite(hf).all()):
        fail("K5 dt x 100: non-finite output")
    print("[k5] dt x 100 (S 256, chunk 64): y and state finite", flush=True)

    # The serving path's shape: 80 heads of P 64 on one group of N 128, S
    # = 512 (the largest bucket) in chunks of 256.
    K5_PATH = (1, 512, 80, 64, 1, 128)
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt)[6:]
        x, dtv, a, bm, cm, _ = ssd_inputs(*K5_PATH, dt)
        xdt, la, bg, cg, bf, cf = ssd_flat(x, dtv, a, bm, cm)
        y, hf = k5.ssd_scan(xdt, la, bg, cg, chunk=256, rep=80)
        again = k5.ssd_scan(xdt, la, bg, cg, chunk=256, rep=80)
        torch.cuda.synchronize()
        if not (torch.equal(y, again[0]) and torch.equal(hf, again[1])):
            fail(f"K5 path shape {dname}: two runs differ")
        ry, rh = ssd_scan_plain(xdt, la, bf, cf, chunk=256)
        err = max(check_close(torch, f"K5 path shape {dname} y", y, ry,
                              dname),
                  check_close(torch, f"K5 path shape {dname} state", hf, rh,
                              dname))
        oracle = ""
        if dt == torch.float32:
            gy, gh = ssd_scan_ref(xdt, la, bf, cf)
            check_close(torch, "K5 path shape f32 y vs the sequential "
                        "oracle", y, gy, dname)
            check_close(torch, "K5 path shape f32 state vs the sequential "
                        "oracle", hf, gh, dname)
            oracle = "; within tolerance of the sequential oracle"
            del gy, gh
        k5_err = max(k5_err, err)
        print(f"[k5] xdt (80, 512, 64), B/C (1, 512, 128), chunk 256 "
              f"{dname}: max abs err {err:.3e}; two runs bitwise equal"
              f"{oracle}", flush=True)
    # K5's kernels at the edges of their tiles (bf16: 128-row query and
    # 64-row key tiles; f32: 64-row query and key tiles; both: a 64-column P
    # tile, N padded to 32, 64 or 128, chunks cut short, groups of 1 to 80
    # heads; f32 also P = 10 and N = 7, staged by plain loads): their own
    # output, before the op adds the D skip, against the plain version and
    # the sequential oracle.  (b, s, h, p, g, n, chunk)
    k5_edges = [(1, 70, 2, 10, 1, 7, 32, torch.float32)]
    k5_edges += [edge + (dt,) for dt in (torch.bfloat16, torch.float32)
                 for edge in (
            (1, 1, 80, 64, 1, 128, 256), (1, 17, 2, 8, 2, 16, 16),
            (1, 63, 4, 16, 2, 32, 32), (1, 65, 8, 32, 1, 64, 64),
            (1, 255, 80, 64, 1, 128, 256), (1, 257, 4, 64, 2, 128, 256),
            (2, 65, 2, 24, 2, 48, 32), (1, 257, 8, 40, 1, 100, 128),
            (1, 129, 2, 72, 1, 128, 64), (1, 90, 4, 8, 2, 4, 32))]
    for b_, s_, h_, p_, g_, n_, chunk, dt in k5_edges:
        dname = str(dt)[6:]
        name = (f"K5 {dname} tile edge (b, s, h, p, g, n) ({b_}, {s_}, "
                f"{h_}, {p_}, {g_}, {n_}) chunk {chunk}")
        e_x, e_dt, e_a, e_b, e_c, _ = ssd_inputs(b_, s_, h_, p_, g_, n_, dt)
        e_xdt, e_la, e_bg, e_cg, e_bf, e_cf = ssd_flat(e_x, e_dt, e_a, e_b,
                                                       e_c)
        before = k5.LAUNCHES["ssd_scan"]
        y, hf = k5.ssd_scan(e_xdt, e_la, e_bg, e_cg, chunk=chunk,
                            rep=h_ // g_)
        torch.cuda.synchronize()
        if k5.LAUNCHES["ssd_scan"] != before + 1:
            fail(f"{name}: ssd_scan did not launch K5")
        ry, rh = ssd_scan_plain(e_xdt, e_la, e_bf, e_cf, chunk=chunk)
        gy, gh = ssd_scan_ref(e_xdt, e_la, e_bf, e_cf)
        err = max(check_close(torch, f"{name} y", y, ry, dname),
                  check_close(torch, f"{name} state", hf, rh, dname))
        check_close(torch, f"{name} y vs the sequential oracle", y, gy,
                    dname)
        check_close(torch, f"{name} state vs the sequential oracle", hf, gh,
                    dname)
        k5_err = max(k5_err, err)
        print(f"[k5] {name}: max abs err {err:.3e} (plain version); within "
              f"tolerance of the sequential oracle", flush=True)
    del e_x, e_dt, e_a, e_b, e_c, e_xdt, e_la, e_bg, e_cg, e_bf, e_cf

    # K5's kernels as built: bf16 on the tensor cores (its template
    # argument the padded N / 16), f32 on the CUDA cores (the padded N).
    k5_lib = k5.load_library()

    def k5_smem(name, arg):
        """Dynamic shared memory at chunk 256 of an instantiation (``arg``
        its template argument)."""
        if "bwd" not in name:
            return int(k5_lib.ssd_scan_smem_bytes(
                *((1, 16 * arg) if "mma" in name else (0, arg)), 256))
        which = {"ssd_bwd_sums_kernel": 0, "ssd_bwd_sums_mma_kernel": 1,
                 "ssd_bwd_local_kernel": 2, "ssd_bwd_local_mma_kernel": 3}
        base = name.split("<")[0]
        if base not in which:
            return 0
        n = 16 * arg if "mma" in name else arg
        return int(k5_lib.ssd_scan_bwd_smem_bytes(which[base], n, 256))

    # The backward's kernels by name, each at an instantiation the training
    # shape runs (HMMA in the bf16 ones).
    bwd_main = {k.split("<")[0]: (k, "mma" in k)
                for ks in K5_BWD_BUILDS.values() for k in ks}
    k5_build = build_report(
        build_logs, "mamba_scan", k5_lib._name,
        ("ssd_scan_mma_kernel", "ssd_scan_f32_kernel") + tuple(bwd_main),
        k5_smem,
        main={"ssd_scan_mma_kernel": ("ssd_scan_mma_kernel<8>", True),
              "ssd_scan_f32_kernel": ("ssd_scan_f32_kernel<128>", False),
              **bwd_main})
    k5_build["ssd_bwd_dla_kernel"]["smem_bytes"] = int(
        k5_lib.ssd_scan_bwd_smem_bytes(4, 128, 256))
    for name, info in k5_build.items():
        if "bwd" in name and "mma" not in name and info["hmma"]:
            fail(f"{name}, an f32 kernel of K5's backward, has "
                 f"{info['hmma']} HMMA instructions")
    for name, info in sorted(k5_build.items()):
        if "bwd" not in name:
            print(f"[k5] build {name} (shared memory at chunk 256): "
                  f"{json.dumps(info)}", flush=True)

    k5_row = {
        "ms": time_ms(torch, lambda: k5.ssd_scan(xdt, la, bg, cg, chunk=256,
                                                 rep=80)),
        "plain_ms": time_ms(torch, lambda: ssd_scan_plain(xdt, la, bf, cf,
                                                          chunk=256)),
        "library_ms": None,     # no single PyTorch call computes the scan
    }
    k5_row["bound_ms"], k5_row["bound_by"] = k5_bound_ms(80, 1, 512, 64, 128,
                                                         256, 2, "bfloat16")
    k5_row["build"] = k5_build["ssd_scan_mma_kernel<8>"]
    print(f"[k5] {card}: bf16 xdt (80, 512, 64), B/C (1, 512, 128), chunk "
          f"256: " + json.dumps(k5_row), flush=True)
    del x, dtv, a, bm, cm, xdt, la, bg, cg, bf, cf, y, hf, again, ry, rh
    # K5's f32 kernel at phase 13's shape (its device time in phase 15).
    h5, g5, s5, p5, n5, c5 = K5_F32_SHAPE
    x, dtv, a, bm, cm, _ = ssd_inputs(1, s5, h5, p5, g5, n5, torch.float32)
    xdt, la, bg, cg, bf, cf = ssd_flat(x, dtv, a, bm, cm)
    k5_f32 = {
        "shape": [[h5, s5, p5], [g5, s5, n5]], "chunk": c5,
        "ms": time_ms(torch, lambda: k5.ssd_scan(xdt, la, bg, cg, chunk=c5,
                                                 rep=h5 // g5)),
        "plain_ms": time_ms(torch, lambda: ssd_scan_plain(xdt, la, bf, cf,
                                                          chunk=c5)),
        "library_ms": None, "build": k5_build["ssd_scan_f32_kernel<128>"]}
    k5_f32["bound_ms"], k5_f32["bound_by"] = k5_bound_ms(
        h5, g5, s5, p5, n5, c5, 4, "float32")
    print(f"[k5] {card}: f32 xdt ({h5}, {s5}, {p5}), B/C ({g5}, {s5}, {n5}), "
          f"chunk {c5}: " + json.dumps({k: v for k, v in k5_f32.items()
                                        if k != "build"}), flush=True)
    del x, dtv, a, bm, cm, xdt, la, bg, cg, bf, cf
    # K5 at Jamba's shape (128 heads of 64, N 16), bf16 and f32: against
    # its plain version, bitwise over two runs; bf16 timed.
    hj, gj, sj, pj, nj, cj = K5_JAMBA_SHAPE
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt)[6:]
        x, dtv, a, bm, cm, _ = ssd_inputs(1, sj, hj, pj, gj, nj, dt)
        xdt, la, bg, cg, bf, cf = ssd_flat(x, dtv, a, bm, cm)
        y, hf = k5.ssd_scan(xdt, la, bg, cg, chunk=cj, rep=hj // gj)
        again = k5.ssd_scan(xdt, la, bg, cg, chunk=cj, rep=hj // gj)
        torch.cuda.synchronize()
        if not (torch.equal(y, again[0]) and torch.equal(hf, again[1])):
            fail(f"K5 Jamba shape {dname}: two runs differ")
        ry, rh = ssd_scan_plain(xdt, la, bf, cf, chunk=cj)
        err = max(check_close(torch, f"K5 Jamba shape {dname} y", y, ry,
                              dname),
                  check_close(torch, f"K5 Jamba shape {dname} state", hf, rh,
                              dname))
        k5_err = max(k5_err, err)
        print(f"[k5] xdt ({hj}, {sj}, {pj}), B/C ({gj}, {sj}, {nj}), chunk "
              f"{cj} {dname}: max abs err {err:.3e}; two runs bitwise equal",
              flush=True)
    k5_jamba = {
        "shape": [[hj, sj, pj], [gj, sj, nj]], "chunk": cj,
        "ms": time_ms(torch, lambda: k5.ssd_scan(xdt, la, bg, cg, chunk=cj,
                                                 rep=hj // gj)),
        "plain_ms": time_ms(torch, lambda: ssd_scan_plain(xdt, la, bf, cf,
                                                          chunk=cj)),
        "library_ms": None,
        "build": k5_build["ssd_scan_mma_kernel<2>"]}     # N 16 pads to 32
    k5_jamba["bound_ms"], k5_jamba["bound_by"] = k5_bound_ms(
        hj, gj, sj, pj, nj, cj, 2, "bfloat16")
    print(f"[k5] {card}: bf16 xdt ({hj}, {sj}, {pj}), B/C ({gj}, {sj}, "
          f"{nj}), chunk {cj}: " + json.dumps(
              {k: v for k, v in k5_jamba.items() if k != "build"}),
          flush=True)
    del x, dtv, a, bm, cm, xdt, la, bg, cg, bf, cf, y, hf, again, ry, rh

    # K5's backward (``ssd_scan_bwd``: ``ssd_scan_bwd_kernel``, then
    # ``ssd_bwd_reduce_kernel`` for dB and dC per group) against its plain
    # version (``ssd_scan_bwd_plain``) at GRAD_TOL, bf16 and f32: Mamba2's
    # training shape over two seeds (the second with the final state's
    # gradient), Jamba's (N 16, 128 heads a group), a ragged last chunk
    # and several groups, la down to -50 a step (in f32 also every
    # gradient within 1e-4 of the f64 recurrence's, as a relative Frobenius
    # error: elementwise the f32 chunked algorithm misses that recurrence at
    # such decays, tests/test_torch_mamba_scan_bwd.py); bitwise over two
    # runs at the training shape; its kernels' registers, spills and shared
    # memory; timed at the training shape (device time in phase 15).  The
    # inputs come from a generator of their own.
    gen_bwd = torch.Generator(device=dev)
    gen_bwd.manual_seed(SEED + 19)

    def bwd_case(bh, g, s, p, n, dt, la_floor=None):
        def draw(shape):
            return torch.randn(shape, generator=gen_bwd, device=dev)
        dtv = draw((bh, s)).abs() * 0.1 + 0.01
        la = dtv * -(draw((bh,)).abs() + 0.1)[:, None]
        if la_floor is not None:
            la = la * (la_floor / la.min())
        xdt = (draw((bh, s, p)) * dtv[..., None]).to(dt)
        return (xdt, la, draw((g, s, n)).to(dt), draw((g, s, n)).to(dt),
                draw((bh, s, p)).to(dt), draw((bh, p, n)))

    hb, gb, sb, pb, nb, cb = K5_BWD_SHAPE
    hj, gj, sj, pj, nj, cj = K5_JAMBA_SHAPE
    k5b_err = 0.0
    k5b_cases = [((hb, gb, sb, pb, nb, cb), dt, seed, None)
                 for dt in (torch.bfloat16, torch.float32) for seed in (0, 1)]
    k5b_cases += [(shape, dt, 1, floor)
                  for dt in (torch.bfloat16, torch.float32)
                  for shape, floor in (((hj, gj, sj, pj, nj, cj), None),
                                       ((4, 1, 300, 64, 128, 256), None),
                                       ((6, 3, 129, 64, 100, 64), None),
                                       ((4, 1, 300, 64, 128, 256), -50.0))]
    # The chunk-parallel grid's edges: 16 chunks, head rows far
    # below and above the card's 132 SMs, P 32 and 48, N 16, 64 and 100,
    # chunks of 64 and 128 with a ragged last one, 2 to 8 groups.
    k5b_cases += [(shape, dt, 1, None)
                  for dt in (torch.bfloat16, torch.float32)
                  for shape in K5_BWD_GRID_EDGES]
    for (h_, g_, s_, p_, n_, c_), dt, seed, floor in k5b_cases:
        dname = str(dt)[6:]
        xdt, la, bm, cm, dy, dstate = bwd_case(h_, g_, s_, p_, n_, dt, floor)
        dstate = dstate if seed else None
        name = (f"K5 backward {dname} xdt ({h_}, {s_}, {p_}), B/C ({g_}, "
                f"{s_}, {n_}), chunk {c_}, seed {seed}"
                + (", with dstate" if seed else "")
                + (f", la down to {floor}" if floor else ""))
        before = k5.LAUNCHES["ssd_scan_bwd"]
        got = k5.ssd_scan_bwd(xdt, la, bm, cm, dy, dstate, chunk=c_,
                              rep=h_ // g_)
        torch.cuda.synchronize()
        if k5.LAUNCHES["ssd_scan_bwd"] != before + 1:
            fail(f"{name}: ssd_scan_bwd did not launch its kernels")
        want = ssd_scan_bwd_plain(xdt, la, bm, cm, dy, dstate, chunk=c_,
                                  rep=h_ // g_)
        err = max(check_close(torch, f"{name} {part}", g, w, dname,
                              GRAD_TOL)
                  for part, g, w in zip(("dxdt", "dla", "db", "dc"), got,
                                        want, strict=True))
        k5b_err = max(k5b_err, err)
        oracle = ""
        if floor and dt == torch.float32:
            # Autograd through the sequential recurrence, all in f64.
            leaves = [t.double().requires_grad_(True)
                      for t in (xdt, la, bm, cm)]
            y, hf = ssd_scan_ref(leaves[0], leaves[1], *(
                torch.repeat_interleave(t, h_ // g_, 0) for t in leaves[2:]))
            ((y * dy.double()).sum() + (hf * dstate.double()).sum()).backward()
            rel = [float(torch.linalg.vector_norm(g.double() - w.grad)
                         / torch.linalg.vector_norm(w.grad))
                   for g, w in zip(got, leaves, strict=True)]
            if not max(rel) <= 1e-4:
                fail(f"{name}: relative Frobenius errors {rel} against the "
                     f"f64 recurrence, above 1e-4")
            oracle = (f"; against the f64 recurrence relative Frobenius "
                      f"errors {[f'{r:.2e}' for r in rel]}")
            del leaves, y, hf
        print(f"[k5] {name}: max abs err {err:.3e} against the plain "
              f"backward (GRAD_TOL){oracle}", flush=True)
    for dt in (torch.bfloat16, torch.float32):
        xdt, la, bm, cm, dy, _ = bwd_case(hb, gb, sb, pb, nb, dt)
        first = k5.ssd_scan_bwd(xdt, la, bm, cm, dy, None, chunk=cb, rep=hb)
        again = k5.ssd_scan_bwd(xdt, la, bm, cm, dy, None, chunk=cb, rep=hb)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b)
                   for a, b in zip(first, again, strict=True)):
            fail(f"K5 backward {str(dt)[6:]} at the training shape: two "
                 f"runs differ")
        del first, again
        print(f"[k5] backward {str(dt)[6:]} at the training shape: two runs "
              f"bitwise equal", flush=True)
    for name, info in sorted(k5_build.items()):
        if "bwd" in name:
            print(f"[k5] build {name} (shared memory at chunk 256): "
                  f"{json.dumps(info)}", flush=True)
    k5_bwd = {}
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt)[6:]
        xdt, la, bm, cm, dy, _ = bwd_case(hb, gb, sb, pb, nb, dt)
        row = {"shape": [[hb, sb, pb], [gb, sb, nb]], "chunk": cb,
               "ms": time_ms(torch, lambda: k5.ssd_scan_bwd(
                   xdt, la, bm, cm, dy, None, chunk=cb, rep=hb // gb)),
               "plain_ms": time_ms(torch, lambda: ssd_scan_bwd_plain(
                   xdt, la, bm, cm, dy, None, chunk=cb, rep=hb // gb)),
               # No PyTorch call computes the scan's gradient.
               "library_ms": None,
               "kernels": list(K5_BWD_BUILDS[dname]),
               "build": {k: k5_build[k] for k in K5_BWD_BUILDS[dname]}}
        row["bound_ms"], row["bound_by"] = k5_bwd_bound_ms(
            hb, gb, sb, pb, nb, cb, dt.itemsize, dname, False)
        k5_bwd[dname] = row
        print(f"[k5] {card}: backward {dname} xdt ({hb}, {sb}, {pb}), B/C "
              f"({gb}, {sb}, {nb}), chunk {cb}: " + json.dumps(
                  {k: v for k, v in row.items() if k != "build"}),
              flush=True)
    del xdt, la, bm, cm, dy, dstate, got, want

    # ----------------------------------- 13. mamba model, f32 (main path)
    cfgm32 = get_config("mamba2-2.7b", param_dtype="float32",
                        compute_dtype="float32")
    model = Model(cfgm32)
    plain = Model(dataclasses.replace(cfgm32, use_pallas=False))
    n_mamba = cfgm32.n_layers
    zero_counts()
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize()
    print(f"[mamba-model] {cfgm32.name} f32 init on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    mrng = np.random.default_rng(SEED)
    L, bucket = 100, 128
    toks = np.zeros((1, bucket), np.int64)
    toks[0, :L] = mrng.integers(0, cfgm32.vocab_size, L)
    batch = {"tokens": torch.as_tensor(toks, device=dev)}
    with torch.no_grad():
        lk, ck = model.prefill(params, batch, last_pos=L - 1)
        torch.cuda.synchronize()
        k5_model = read_counts("mamba_model")["ssd_scan"]
        lp, cp = plain.prefill(params, batch, last_pos=L - 1)
    torch.cuda.synchronize()
    if k5_model != n_mamba:
        fail(f"mamba model: K5 launched {k5_model} times, expected "
             f"{n_mamba}")
    if tuple(lk.shape) != (1, 1, cfgm32.padded_vocab):
        fail(f"mamba model: logits shape {tuple(lk.shape)}")
    mamba_err = check_close(torch, "mamba prefill logits (kernel vs plain)",
                            lk, lp, "float32")
    sk, sp = ck["periods"]["pos0"]["self"], cp["periods"]["pos0"]["self"]
    if tuple(sk.state.shape) != (n_mamba, 1, 80, 64, 128):
        fail(f"mamba model: state shape {tuple(sk.state.shape)}")
    state_err = [check_close(torch, f"mamba period {t} final state",
                             sk.state[t], sp.state[t], "float32")
                 for t in range(n_mamba)]
    if not torch.equal(sk.conv, sp.conv):
        fail("mamba model: conv windows differ (computed outside K5)")
    tok_k = int(lk[0, 0, :cfgm32.vocab_size].argmax())
    tok_p = int(lp[0, 0, :cfgm32.vocab_size].argmax())
    if tok_k != tok_p:
        fail(f"mamba model: greedy first tokens differ ({tok_k} vs {tok_p})")
    print(f"[mamba-model] prefill L={L} (bucket {bucket}), {n_mamba} layers: "
          f"logits max abs err {mamba_err:.3e}; every period's final state "
          f"within tolerance (max abs err {max(state_err):.3e}, period "
          f"{state_err.index(max(state_err))}); conv windows equal; greedy "
          f"first token {tok_k} on both paths; K5 launches {k5_model}",
          flush=True)
    del model, plain, params, lk, lp, ck, cp, sk, sp
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------ 14. mamba serve, bf16 (main path)
    # Phase 5's fleet, prompt lengths and token budget on full-width bf16
    # Mamba2-2.7B; the prompts are drawn from its vocabulary.
    cfgm = get_config("mamba2-2.7b")
    model = Model(cfgm)
    params = model.init(SEED)
    prompts = [[int(t) for t in mrng.integers(0, cfgm.vocab_size, n)]
               for n in lengths]

    def mamba_job() -> ServeJob:
        return ServeJob([Request(rid=i, prompt=list(p), max_new_tokens=16)
                         for i, p in enumerate(prompts)],
                        model=model, params=params, max_seq=1024)

    # The eager route first here (the order alternates over the phases).
    slow = eager_serve("mamba_serve_eager", mamba_job(), model, params)
    job = mamba_job()
    torch.cuda.synchronize()
    zero_counts()
    with wall_split(DecodeEngine, ("prefill", "insert", "step")) as spent, \
            keep_inputs(mamba_ops, "_ssd_kernel_call") as seen, \
            step_log(DecodeEngine, compiled_steps.STATS) as log:
        t0 = time.perf_counter()
        rep = Cluster(fleet_spec).serve(job)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    counts = read_counts("mamba_serve")
    k5_serve = counts["ssd_scan"]
    fast = route_result(job.requests, wall_s, spent, log, counts)
    m = rep.metrics
    for r in job.requests:
        if not r.done or len(r.out_tokens) != 16:
            fail(f"mamba serve: request {r.rid} done={r.done} with "
                 f"{len(r.out_tokens)} tokens")
        if not all(0 <= t < cfgm.vocab_size for t in r.out_tokens):
            fail(f"mamba serve: request {r.rid} emitted a token outside the "
                 f"vocab")
    if m.get("mode") != "disaggregated" or m["n_handoffs"] != len(prompts):
        fail(f"mamba serve: mode {m.get('mode')}, {m.get('n_handoffs')} "
             f"handoffs")
    if k5_serve != len(prompts) * n_mamba:
        fail(f"mamba serve: K5 launched {k5_serve} times, expected "
             f"{len(prompts) * n_mamba}")
    n_tok = sum(len(r.out_tokens) for r in job.requests)
    split = {k: v["mean"] for k, v in m["ttft_split"].items() if k != "n"}
    print(f"[mamba-serve] {card}: {len(prompts)} requests of bf16 "
          f"{cfgm.name} ({n_mamba} layers, d_model {cfgm.d_model}), {n_tok} "
          f"tokens in {wall_s:.3f} s wall -> {n_tok / wall_s:.2f} tokens/s; "
          f"{m['n_handoffs']} handoffs; K5 launches {k5_serve}; TTFT split "
          f"(sim-clock s, mean) {json.dumps(split)}", flush=True)
    engine_s = sum(sec for _, sec in spent.values())
    print("[mamba-serve] host wall split: " + ", ".join(
        f"{name} {n} calls {sec:.3f} s" for name, (n, sec) in spent.items())
        + f", the rest (control plane) {wall_s - engine_s:.3f} s", flush=True)

    # K5 against its plain version on the inputs the serve path gave it.
    buckets = sorted(key[0][1] for key in seen)
    if buckets != [16, 32, 64, 128, 256, 512]:
        fail(f"mamba serve: K5 saw buckets {buckets}, expected 16 .. 512")
    k5_err = max(k5_err, k5_on_seen("mamba-serve", seen))
    compare_routes("mamba-serve", fast, slow)
    prefill_thrice("mamba-serve", "mamba_serve_prefill3", model, params,
                   prompts[3], "ssd_scan", n_mamba)
    del seen, rep, job, fast, slow
    gc.collect()
    torch.cuda.empty_cache()
    print_busy(card, "8 requests x 16 tokens", *card_busy(
        torch, lambda: Cluster(fleet_spec).serve(mamba_job()),
        kernels=("ssd_scan_f32_kernel", "ssd_scan_mma_kernel"), top=8), wall_s,
        tag="mamba-serve", kernel="K5")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------- 27. mamba train, bf16 (main path)
    # Mamba2-2.7B trained on the kernel route: K5's forward twice a layer a
    # grain (the forward, then its recompute under remat) and its backward
    # once.  (b) One f32 grain cut to MAMBA_TRAIN_F32_LAYERS layers against
    # use_pallas=False; (c) phase 11.2's flow on the bf16 model at its
    # published widths and MAMBA_TRAIN_LAYERS layers.
    def check_k5_launches(path: str, n_grains: int,
                          n_layers: int) -> dict[str, int]:
        counts = read_counts(path)
        want = {"ssd_scan": 2 * n_layers * n_grains,
                "ssd_scan_bwd": n_layers * n_grains}
        got = {n: counts[n] for n in want}
        if got != want:
            fail(f"{path}: K5 launches {got}, predicted {want}")
        return got

    phase_t0 = time.perf_counter()
    cfgt32 = get_config("mamba2-2.7b", n_layers=MAMBA_TRAIN_F32_LAYERS,
                        param_dtype="float32", compute_dtype="float32")
    model = Model(cfgt32)
    plain = Model(dataclasses.replace(cfgt32, use_pallas=False))
    params = model.init(SEED)
    spec = GrainSpec(1, TRAIN_SEQ, cfgt32.vocab_size)
    batch = batch_from_grains(SyntheticSource(spec, seed=SEED), 0, [0], spec,
                              device=dev)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    (loss_k, _), grads_k = make_grain_grad_fn(model, compile_steps=False)(
        params, batch)
    torch.cuda.synchronize()
    grain_k_s = time.perf_counter() - t0
    k5_train = check_k5_launches("mamba_train_f32", 1, MAMBA_TRAIN_F32_LAYERS)
    t0 = time.perf_counter()
    (loss_p, _), grads_p = make_grain_grad_fn(plain, compile_steps=False)(
        params, batch)
    torch.cuda.synchronize()
    grain_p_s = time.perf_counter() - t0
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    if not (loss_rel <= 1e-4 and torch.isfinite(loss_k)):
        fail(f"mamba train f32 grain: loss {float(loss_k)} on the kernel "
             f"route vs {float(loss_p)} plain (rel err {loss_rel:.3e} > "
             f"1e-4)")
    leaf_err, leaf_rel = 0.0, (0.0, None)
    for i, (gk, gp) in enumerate(zip(tree_leaves(grads_k),
                                     tree_leaves(grads_p), strict=True)):
        leaf_err = max(leaf_err, check_close(
            torch, f"mamba train f32 gradient leaf {i} {tuple(gk.shape)}",
            gk, gp, "float32", GRAD_TOL))
        rel = float(torch.linalg.vector_norm((gk - gp).float())
                    / torch.linalg.vector_norm(gp.float()).clamp_min(1e-30))
        if rel >= leaf_rel[0]:
            leaf_rel = (rel, (i, tuple(gk.shape)))
    print(f"[mamba-train] {card}: one f32 grain of {cfgt32.name} "
          f"({MAMBA_TRAIN_F32_LAYERS} of 64 layers, d_model "
          f"{cfgt32.d_model}, 80 heads of 64, d_state 128), seq "
          f"{TRAIN_SEQ}: loss {float(loss_k):.6f} kernel route vs "
          f"{float(loss_p):.6f} plain (rel err {loss_rel:.3e}); every "
          f"gradient leaf within GRAD_TOL (max abs err {leaf_err:.3e}; worst "
          f"relative Frobenius error {leaf_rel[0]:.3e}, leaf {leaf_rel[1]}); "
          f"K5 launches {json.dumps(k5_train)}; host s with the wait: "
          f"kernel route {grain_k_s:.3f}, plain {grain_p_s:.3f}", flush=True)
    del model, plain, params, batch, grads_k, grads_p, loss_k, loss_p
    gc.collect()
    torch.cuda.empty_cache()
    model = Model(get_config("mamba2-2.7b", n_layers=MAMBA_TRAIN_LAYERS))
    mamba_hdp = hdp_routes(
        "mamba-train", model, "mamba_train_hdp",
        lambda path, n: check_k5_launches(path, n, MAMBA_TRAIN_LAYERS),
        ("ssd_scan_mma_kernel", "ssd_bwd_"), "K5")
    for route, r in mamba_hdp.items():
        if r["peak_gb"] > MAMBA_TRAIN_PEAK_GB:
            fail(f"mamba train ({route}): peak {r['peak_gb']:.2f} GB over "
                 f"{MAMBA_TRAIN_PEAK_GB} GB")
    print(f"[mamba-train] {card}: bf16 {model.cfg.name} at "
          f"{MAMBA_TRAIN_LAYERS} of 64 layers: compiled "
          f"{mamba_hdp['compiled']['tokens_s']:.1f} tokens/s, "
          f"a replayed grain {mamba_hdp['compiled']['replay_grain_ms']:.3f} "
          f"host ms, busy {mamba_hdp['compiled']['busy']:.4f} of a steady "
          f"step, peak {mamba_hdp['compiled']['peak_gb']:.2f} GB; eager "
          f"{mamba_hdp['eager']['tokens_s']:.1f} tokens/s, busy "
          f"{mamba_hdp['eager']['busy']:.4f}, peak "
          f"{mamba_hdp['eager']['peak_gb']:.2f} GB; phase "
          f"{time.perf_counter() - phase_t0:.1f} s", flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # Phases 16-21 (run here, before phase 15's device times): the MoE,
    # Qwen3, Granite and Jamba paths.  Each frees its model at its end and
    # prints its peak memory.
    from repro_torch.models import moe
    from repro_torch.tree import tree_map

    def peak(tag: str) -> None:
        """Free what the phase dropped; print its peak memory."""
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[{tag}] {card}: peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
              f"(torch.cuda.max_memory_allocated over the phase)", flush=True)

    def init_model(tag: str, cfg, cut: str = ""):
        """``Model(cfg).init(SEED)`` on the card, with its size printed."""
        torch.cuda.reset_peak_memory_stats()
        print(f"[{tag}] begins {time.perf_counter() - smoke_t0:.1f} s into the "
              f"run, {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated",
              flush=True)
        model = Model(cfg)
        t0 = time.perf_counter()
        params = model.init(SEED)
        torch.cuda.synchronize()
        n = sum(t.numel() for t in tree_leaves(params))
        nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
        print(f"[{tag}] {cfg.name} {cfg.param_dtype}: {cfg.n_layers} layers, "
              f"d_model {cfg.d_model}, {cfg.n_heads} q heads over "
              f"{cfg.n_kv_heads} KV heads{cut}; {n / 1e9:.3f} B parameters, "
              f"{nbytes / 1e9:.2f} GB, init on the card in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        return model, params

    def n_mixers(cfg, mixer: str) -> int:
        return sum(s.mixer == mixer for s in cfg.layer_pattern) * cfg.n_periods

    def serve_fleet(tag: str, path: str, cfg, model, params,
                    eager: str = ""):
        """Phase 5's fleet, prompt lengths and token budget on ``model``
        (prompts drawn from its vocabulary): every request completes with
        16 in-vocab tokens, 8 handoffs, K1 once per attention layer per
        prefill; the host wall split; K1 against its plain version on the
        inputs the path gave it.  ``eager`` "before" or "after": the
        requests also through the eager route, before or after the
        compiled one, the two held equal (``compare_routes``).  Returns
        (job factory, wall s, K1 err)."""
        prng = np.random.default_rng(SEED)
        prompts = [[int(t) for t in prng.integers(0, cfg.vocab_size, n)]
                   for n in lengths]

        def job() -> ServeJob:
            return ServeJob([Request(rid=i, prompt=list(p), max_new_tokens=16)
                             for i, p in enumerate(prompts)],
                            model=model, params=params, max_seq=1024)

        if eager == "before":
            slow = eager_serve(f"{path}_eager", job(), model, params)
        j = job()
        torch.cuda.synchronize()
        zero_counts()
        with wall_split(DecodeEngine, ("prefill", "insert", "step")) as spent, \
                keep_inputs(ops, "_prefill_call") as seen, \
                step_log(DecodeEngine, compiled_steps.STATS) as log:
            t0 = time.perf_counter()
            rep = Cluster(fleet_spec).serve(j)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        counts = read_counts(path)
        k1 = counts["prefill_flash"]
        m = rep.metrics
        for r in j.requests:
            if not r.done or len(r.out_tokens) != 16:
                fail(f"{tag}: request {r.rid} done={r.done} with "
                     f"{len(r.out_tokens)} tokens")
            if not all(0 <= t < cfg.vocab_size for t in r.out_tokens):
                fail(f"{tag}: request {r.rid} emitted a token outside the "
                     f"vocab")
        if m.get("mode") != "disaggregated" or m["n_handoffs"] != len(prompts):
            fail(f"{tag}: mode {m.get('mode')}, {m.get('n_handoffs')} "
                 f"handoffs")
        if k1 != len(prompts) * n_mixers(cfg, "attn"):
            fail(f"{tag}: K1 launched {k1} times, expected "
                 f"{len(prompts) * n_mixers(cfg, 'attn')}")
        n_tok = sum(len(r.out_tokens) for r in j.requests)
        group = cfg.n_q_heads // cfg.n_kv_heads
        print(f"[{tag}] {card}: {len(prompts)} requests of bf16 {cfg.name} "
              f"({cfg.n_layers} layers, d_model {cfg.d_model}), {n_tok} "
              f"tokens in {wall_s:.3f} s wall -> {n_tok / wall_s:.2f} "
              f"tokens/s; {m['n_handoffs']} handoffs; K1 launches {k1} at "
              f"group {group} ({cfg.n_q_heads} q heads)", flush=True)
        engine_s = sum(sec for _, sec in spent.values())
        print(f"[{tag}] host wall split: " + ", ".join(
            f"{name} {n} calls {sec:.3f} s" for name, (n, sec) in spent.items())
            + f", the rest (control plane) {wall_s - engine_s:.3f} s",
            flush=True)
        err = k1_on_seen(tag, seen)
        if eager:
            fast = route_result(j.requests, wall_s, spent, log, counts)
            if eager == "after":
                slow = eager_serve(f"{path}_eager", job(), model, params)
            compare_routes(tag, fast, slow)
        return job, wall_s, err

    def engine_run(tag: str, path: str, cfg, model, params):
        """Two prompts (100 and 500 tokens: buckets 128 and 512) prefilled
        and inserted into one DecodeEngine, then decoded to 8 tokens each:
        in-vocab tokens, K1 once per attention layer and K5 once per mamba
        layer per prefill, both against their plain versions on the inputs
        the path gave them.  Returns the largest K1 and K5 errors."""
        prng = np.random.default_rng(SEED)
        reqs = [Request(rid=i, prompt=[int(t) for t in prng.integers(
            0, cfg.vocab_size, n)], max_new_tokens=8)
            for i, n in enumerate((100, 500))]
        engine = DecodeEngine(model, params, max_batch=len(reqs), max_seq=1024)
        torch.cuda.synchronize()
        zero_counts()
        with wall_split(DecodeEngine, ("prefill", "insert", "step")) as spent, \
                keep_inputs(ops, "_prefill_call") as seen1, \
                keep_inputs(mamba_ops, "_ssd_kernel_call") as seen5:
            t0 = time.perf_counter()
            for r in reqs:
                engine.insert(engine.prefill(r))
            engine.run_until_drained()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        counts = read_counts(path)
        for r in reqs:
            if not r.done or len(r.out_tokens) != 8:
                fail(f"{tag}: request {r.rid} done={r.done} with "
                     f"{len(r.out_tokens)} tokens")
            if not all(0 <= t < cfg.vocab_size for t in r.out_tokens):
                fail(f"{tag}: request {r.rid} emitted a token outside the "
                     f"vocab")
        want = {"prefill_flash": len(reqs) * n_mixers(cfg, "attn"),
                "ssd_scan": len(reqs) * n_mixers(cfg, "mamba")}
        got = {key: counts[key] for key in want}
        if got != want:
            fail(f"{tag}: launches {got}, expected {want}")
        group = cfg.n_q_heads // cfg.n_kv_heads
        print(f"[{tag}] {card}: prefill + insert of prompts of 100 and 500 "
              f"tokens, then {engine.steps} decode steps to 8 tokens each, "
              f"in {wall_s:.3f} s wall; tokens {[r.out_tokens for r in reqs]}"
              f"; K1 launches {got['prefill_flash']} at group {group}, K5 "
              f"launches {got['ssd_scan']}", flush=True)
        print(f"[{tag}] host wall split: " + ", ".join(
            f"{name} {n} calls {sec:.3f} s" for name, (n, sec) in spent.items()),
            flush=True)
        return k1_on_seen(tag, seen1), k5_on_seen(tag, seen5)

    # --------------------------------- 16. MoE model, f32 (main path)
    # Qwen1.5-MoE at its published widths in f32, depth cut to
    # MOE_F32_LAYERS of 24 layers (14.3 B parameters are 57 GB in f32):
    # prefill logits and caches on the kernel route (K1 in f32; the cache
    # stored in bf16, so K2 runs) against use_pallas=False; then one layer's
    # capacity-routed apply_moe, with capacities that drop nothing, against
    # the dropless apply_moe_dense.
    cfgq32 = get_config("qwen2-moe-a2.7b", n_layers=MOE_F32_LAYERS,
                        param_dtype="float32", compute_dtype="float32",
                        cache_dtype="bfloat16")
    model, params = init_model("moe-model", cfgq32, f" (cut from 24 to "
                               f"{MOE_F32_LAYERS} layers)")
    plain = Model(dataclasses.replace(cfgq32, use_pallas=False))
    qrng = np.random.default_rng(SEED)
    L, bucket = 100, 128
    toks = np.zeros((1, bucket), np.int64)
    toks[0, :L] = qrng.integers(0, cfgq32.vocab_size, L)
    batch = {"tokens": torch.as_tensor(toks, device=dev)}
    zero_counts()
    with torch.no_grad():
        lk, ck = model.prefill(params, batch, last_pos=L - 1)
        torch.cuda.synchronize()
        moe_counts = read_counts("moe_model")
        lp, cp = plain.prefill(params, batch, last_pos=L - 1)
    torch.cuda.synchronize()
    want = {"prefill_flash": cfgq32.n_layers, "cache_cast": cfgq32.n_layers}
    if {key: moe_counts[key] for key in want} != want:
        fail(f"moe model: launches {moe_counts}, expected {want}")
    if tuple(lk.shape) != (1, 1, cfgq32.padded_vocab):
        fail(f"moe model: logits shape {tuple(lk.shape)}")
    moe_err = check_close(torch, "moe prefill logits (kernel vs plain)", lk,
                          lp, "float32")
    kk, kp = ck["periods"]["pos0"]["self"], cp["periods"]["pos0"]["self"]
    if kk.k.dtype != torch.bfloat16 or kp.k.dtype != torch.float32:
        fail("moe model: the kernel branch must return the cache in the cache "
             "dtype and the plain branch uncast")
    cache_err = max(check_close(torch, f"moe prefill cache {name} (bf16 "
                                f"kernel cache vs plain)", getattr(kk, name),
                                getattr(kp, name).to(torch.bfloat16),
                                "bfloat16")
                    for name in ("k", "v"))
    tok_k = int(lk[0, 0, :cfgq32.vocab_size].argmax())
    tok_p = int(lp[0, 0, :cfgq32.vocab_size].argmax())
    if tok_k != tok_p:
        fail(f"moe model: greedy first tokens differ ({tok_k} vs {tok_p})")
    print(f"[moe-model] prefill L={L} (bucket {bucket}), {MOE_F32_LAYERS} "
          f"layers: logits max abs err {moe_err:.3e} (f32 tolerance); bf16 "
          f"caches max abs err {cache_err:.3e} against the plain route's "
          f"rounded to bf16 (bf16 tolerance); greedy first token {tok_k} on "
          f"both paths; launches K1 {moe_counts['prefill_flash']}, K2 "
          f"{moe_counts['cache_cast']}", flush=True)
    del lk, lp, ck, cp, kk, kp
    # apply_moe with capacities that drop nothing (capacity factor E / k:
    # every expert can take every token) against apply_moe_dense, on layer
    # 0's experts, f32, 128 tokens.
    layer = tree_map(lambda t: t[0], params["stack"]["periods"]["pos0"]["moe"])
    nodrop = dataclasses.replace(cfgq32, moe=dataclasses.replace(
        cfgq32.moe, capacity_factor=cfgq32.moe.n_routed / cfgq32.moe.top_k))
    xm = rand((1, 128, cfgq32.d_model), torch.float32) * 0.5
    with torch.no_grad():
        routed, aux = moe.apply_moe(layer, nodrop, xm)
        dense, _ = moe.apply_moe_dense(layer, cfgq32, xm)
    torch.cuda.synchronize()
    moe_dense_err = check_close(torch, "apply_moe without drops vs "
                                "apply_moe_dense", routed, dense, "float32")
    print(f"[moe-model] one layer's apply_moe with capacities that drop "
          f"nothing vs apply_moe_dense (60 experts, top-4, 128 tokens, f32): "
          f"max abs err {moe_dense_err:.3e}; aux {float(aux):.6f}", flush=True)
    del model, plain, params, layer, xm, routed, dense
    peak("moe-model")

    # ---------------------------------- 17. MoE serve, bf16 (main path)
    # Qwen1.5-MoE at full width, all 24 layers, through phase 5's fleet.
    cfgq = get_config("qwen2-moe-a2.7b")
    model, params = init_model("moe-serve", cfgq)
    if params["stack"]["periods"]["pos0"]["moe"]["router"].dtype != \
            torch.float32:
        fail("moe serve: the router must stay f32 under bf16 params")
    moe_job, moe_wall, err = serve_fleet("moe-serve", "moe_serve", cfgq, model,
                                         params, eager="after")
    k1_err = max(k1_err, err)
    gc.collect()
    print_busy(card, "8 requests x 16 tokens", *card_busy(
        torch, lambda: Cluster(fleet_spec).serve(moe_job()),
        kernels=("prefill_flash",), top=8), moe_wall, tag="moe-serve",
        kernel="K1")
    del model, params, moe_job
    peak("moe-serve")

    # ------------------ 18. MoE capacity (the paper's technique per expert)
    # The flow of examples/moe_homogenized.py on one full-width bf16
    # Qwen1.5-MoE layer and MOE_TOKENS tokens: capacities uniform and
    # homogenized (capacity_per_expert over the example's perfs; over a
    # skewed router's observed load), the tokens each drops and the largest
    # over the smallest expert finish time (capacity over perf; on the
    # skewed router the perf is the observed load, as a proxy); apply_moe
    # under each (its device time in phase 15).
    torch.cuda.reset_peak_memory_stats()
    cfgc, p_moe, p_skew, x_moe, perfs, load, caps = moe_capacity_case(
        torch, dev)
    mc = cfgc.moe
    cap_max = max((int(np.ceil(mc.capacity_factor * MOE_TOKENS * mc.top_k
                               / mc.n_routed * 2)) + 7) // 8 * 8, 8)

    def dropped(p, c) -> int:
        """Assignments past min(capacity, cap_max) of their expert: ranks
        run 0, 1, ... in token order, so an expert with n assignments keeps
        min(n, capacity, cap_max)."""
        _, _, experts = moe._route(p, mc, x_moe.reshape(-1, cfgc.d_model))
        n = torch.bincount(experts.reshape(-1),
                           minlength=mc.n_routed).cpu().numpy()
        return int(np.maximum(n - np.minimum(c, cap_max), 0).sum())

    capacity_rows = {}
    for key, p, basis in (("uniform", p_moe, perfs), ("perf", p_moe, perfs),
                          ("uniform_skewed", p_skew, load),
                          ("load", p_skew, load)):
        c = caps["uniform" if key == "uniform_skewed" else key]
        ft = c / basis
        with torch.no_grad():
            out, aux = moe.apply_moe(p, cfgc, x_moe, c)
        torch.cuda.synchronize()
        if tuple(out.shape) != tuple(x_moe.shape) or \
                not torch.isfinite(out).all():
            fail(f"moe capacity {key}: output {tuple(out.shape)} not finite")
        capacity_rows[key] = {
            "capacities": [int(v) for v in c], "dropped": dropped(p, c),
            "assignments": MOE_TOKENS * mc.top_k,
            "finish_imbalance": float(ft.max() / ft.min()),
            "worst_finish": float(ft.max()), "aux": float(aux)}
        print(f"[moe-capacity] {key}: capacities {capacity_rows[key]['capacities']}; "
              f"{capacity_rows[key]['dropped']} of {MOE_TOKENS * mc.top_k} "
              f"assignments dropped; finish time (capacity / "
              f"{'perf' if basis is perfs else 'observed load'}) largest over "
              f"smallest {capacity_rows[key]['finish_imbalance']:.4f}, worst "
              f"{capacity_rows[key]['worst_finish']:.2f}", flush=True)
    if not (capacity_rows["perf"]["finish_imbalance"]
            < capacity_rows["uniform"]["finish_imbalance"]):
        fail("moe capacity: homogenized capacities do not even out the "
             "finish times")
    print(f"[moe-capacity] observed top-1 load of the skewed router: "
          f"{[int(v) for v in load]}", flush=True)
    del p_moe, p_skew, x_moe, out, p
    peak("moe-capacity")

    # ------------------------------- 19. Qwen3-8B serve, bf16 (main path)
    # qk_norm on the card, K1 at group 4: full width, all 36 layers.
    cfg3 = get_config("qwen3-8b")
    model, params = init_model("qwen3-serve", cfg3)
    _, _, err = serve_fleet("qwen3-serve", "qwen3_serve", cfg3, model, params)
    k1_err = max(k1_err, err)
    del model, params
    peak("qwen3-serve")

    # --------------------------- 20. Granite-34B, cut, bf16 (main path)
    # Its published widths, depth cut to GRANITE_LAYERS of 88 layers (the
    # whole model is 93.9 GB in bf16): K1 at group 48 (one KV head).
    cfgg = get_config("granite-34b", n_layers=GRANITE_LAYERS)
    model, params = init_model("granite-cut", cfgg, f" (cut from 88 to "
                               f"{GRANITE_LAYERS} layers)")
    err, _ = engine_run("granite-cut", "granite_cut", cfgg, model, params)
    k1_err = max(k1_err, err)
    del model, params
    peak("granite-cut")

    # --------------------------- 21. Jamba-v0.1, cut, bf16 (main path)
    # Its published widths, depth cut to one period of 8 layers (the whole
    # model is 102.9 GB in bf16): mamba (K5 at 128 heads of 64, N 16),
    # attention (K1 at group 4) and MoE in one model.
    cfgj = get_config("jamba-v0.1-52b", n_layers=8)
    model, params = init_model("jamba-cut", cfgj, " (cut from 32 to 8 "
                               "layers: one period)")
    err1, err5 = engine_run("jamba-cut", "jamba_cut", cfgj, model, params)
    k1_err, k5_err = max(k1_err, err1), max(k5_err, err5)
    del model, params
    peak("jamba-cut")

    # Phases 22-24: the remaining configs (MLA, embeds input with M-RoPE,
    # enc-dec), each at its published widths, each timed, freed at its end
    # and its peak memory printed.
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.prefill.ops import length_bucket
    from repro_torch.models.mla import MLACache
    from repro_torch.serve import engine as engine_mod

    def fill_lane(cache: dict, caches: dict, lane: int) -> None:
        """A prefill's batch-1 caches into lane ``lane`` of a decode cache,
        as ``DecodeEngine.insert`` writes a handoff (``serve/engine._put``):
        self and cross caches, periods (lane axis 1) and prefix layers (0)."""
        for key, full in cache["periods"].items():
            for kind, part in caches["periods"][key].items():
                engine_mod._put(full[kind], part, 1, lane)
        for full, part in zip(cache.get("prefix", ()),
                              caches.get("prefix", ())):
            for kind in part:
                engine_mod._put(full[kind], part[kind], 0, lane)

    def k4_on_seen(tag: str, seen) -> None:
        """K4's forward, dQ and dK/dV against their plain version and
        autograd through it on the inputs a path gave K4 (``k4_check_seen``,
        at TOL and GRAD_TOL), into ``k4_err``."""
        for part, e in k4_check_seen(torch, seen, tag, f"[{tag}] ").items():
            k4_err[part] = max(k4_err[part], e)

    def greedy(logits, vocab: int) -> list[int]:
        return logits[:, -1, :vocab].float().argmax(-1).tolist()

    # --------------------------- 22. DeepSeek-V2, cut, bf16 (main path)
    # Its published widths (128 heads, MLA q_lora 1536 / kv_lora 512 / rope
    # 64, 160 routed experts top-6 of 1536 and 2 shared), depth cut to the
    # dense first layer and DEEPSEEK_LAYERS - 1 MoE layers, served through
    # phase 5's fleet: each handoff carries MLACaches (the prefix layer's
    # through lane axis 0).  MLA is plain einsums in the reference, and its
    # q/k head dim of 192 is not one of K4's: no kernel runs on this path.
    phase_t0 = time.perf_counter()
    cfgd = get_config("deepseek-v2-236b", n_layers=DEEPSEEK_LAYERS)
    model, params = init_model("deepseek-cut", cfgd, f" (cut from 60 to "
                               f"{DEEPSEEK_LAYERS} layers: the dense first "
                               f"layer and {DEEPSEEK_LAYERS - 1} MoE layers)")
    puts = []
    saved_put = engine_mod._put

    def counting_put(full, part, batch_axis, idx):
        puts.append(type(full).__name__)
        return saved_put(full, part, batch_axis, idx)

    engine_mod._put = counting_put
    try:
        serve_fleet("deepseek-cut", "deepseek_cut", cfgd,
                    model, params, eager="before")
    finally:
        engine_mod._put = saved_put
    launched = {key: n for path in ("deepseek_cut", "deepseek_cut_eager")
                for key, n in by_path[path].items() if n}
    if launched:
        fail(f"deepseek cut: kernels launched on an MLA path: {launched}")
    # Two serves wrote handoffs: the eager route's and the compiled one's.
    want_puts = 2 * len(lengths) * (1 + len(cfgd.layer_pattern))
    if puts != ["MLACache"] * want_puts:
        fail(f"deepseek cut: handoff cache writes {puts}, expected "
             f"{want_puts} MLACache writes")
    # The absorbed decode against the decompressed form: decode_step at
    # position t after a prefill of t tokens, against a prefill's
    # last-token logits over t + 1 tokens, both prefills with MoE
    # capacities that drop nothing (the decode's MoE is dropless).  In bf16
    # at this cut the two forms' roundings differ by about 1 % of a layer's
    # output, and at the fourth MoE layer that moved token t's top-6
    # experts (scripts/mla_absorbed_check.py), so the bf16 difference is
    # printed, and the two forms are held together in f32 at the published
    # widths, cut to the dense first layer and one MoE layer
    # (DEEPSEEK_F32_LAYERS), within the f32 tolerance.
    drng = np.random.default_rng(SEED)
    t_pos = 100
    toks = torch.as_tensor(drng.integers(0, cfgd.vocab_size, (1, t_pos + 1)),
                           device=dev)

    def absorbed_vs_decompressed(cfg, params):
        """(decode_step logits at t_pos, prefill's over t_pos + 1 tokens,
        the t_pos-token prefill's caches)."""
        nodrop = Model(dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_routed / cfg.moe.top_k)))
        with torch.no_grad():
            whole, _ = nodrop.prefill(params, {"tokens": toks})
            _, pre = nodrop.prefill(params, {"tokens": toks[:, :t_pos]})
            cache = nodrop.init_cache(1, 2 * t_pos)
            fill_lane(cache, pre, 0)
            step, _ = nodrop.decode_step(params, cache, toks[:, t_pos:],
                                         t_pos)
        torch.cuda.synchronize()
        return step, whole, pre

    step, whole, pre = absorbed_vs_decompressed(cfgd, params)
    bf16_diff = float((step - whole).abs().max())
    # The handoff's bytes a token: the prefill's MLACache against a GQA
    # cache of the same 128 heads (k and v of 128 each), per layer.
    c0 = pre["prefix"][0]["self"]
    if not isinstance(c0, MLACache):
        fail(f"deepseek cut: the prefix layer's cache is {type(c0)}")
    mla_bytes = (c0.c_kv.shape[-1] * c0.c_kv.element_size()
                 + c0.k_rope.shape[-1] * c0.k_rope.element_size())
    gqa_bytes = 2 * cfgd.n_kv_heads * cfgd.head_dim * c0.c_kv.element_size()
    latent = (c0.c_kv.shape[-1], c0.k_rope.shape[-1], str(c0.c_kv.dtype)[6:])
    del model, params, pre, c0, whole, step
    peak("deepseek-cut")
    cfgd32 = get_config("deepseek-v2-236b", n_layers=DEEPSEEK_F32_LAYERS,
                        param_dtype="float32", compute_dtype="float32")
    model, params = init_model("deepseek-f32", cfgd32, f" (cut from 60 to "
                               f"{DEEPSEEK_F32_LAYERS} layers: the dense "
                               f"first layer and one MoE layer)")
    zero_counts()
    step, whole, _ = absorbed_vs_decompressed(cfgd32, params)
    launched = {key: n for key, n in read_counts("deepseek_f32").items() if n}
    if launched:
        fail(f"deepseek f32: kernels launched on an MLA path: {launched}")
    absorbed_err = check_close(
        torch, "deepseek f32: absorbed decode vs decompressed prefill logits",
        step, whole, "float32")
    tok_a, tok_d = greedy(step, cfgd.vocab_size), greedy(whole,
                                                         cfgd.vocab_size)
    if tok_a != tok_d:
        fail(f"deepseek f32: greedy tokens differ ({tok_a} vs {tok_d})")
    print(f"[deepseek-cut] {card}: no kernel runs on this path (MLA is plain "
          f"einsums, as in the reference); {len(puts)} MLACache handoff "
          f"writes (2 serves x {len(lengths)} handoffs x "
          f"{1 + len(cfgd.layer_pattern)}: "
          f"the prefix layer and the stacked periods); handoff {mla_bytes} "
          f"bytes a token a layer ({latent[0]} + {latent[1]} {latent[2]} "
          f"values) against {gqa_bytes} for a GQA cache of "
          f"{cfgd.n_kv_heads} heads of {cfgd.head_dim} "
          f"({gqa_bytes / mla_bytes:.1f}x), {mla_bytes * cfgd.n_layers} bytes "
          f"a token over the {cfgd.n_layers} layers; absorbed decode at "
          f"position {t_pos} vs the decompressed prefill over {t_pos + 1} "
          f"tokens: bf16 at {cfgd.n_layers} layers logits max abs diff "
          f"{bf16_diff:.3e} (not held: rounding moves MoE routing), f32 at "
          f"{DEEPSEEK_F32_LAYERS} layers {absorbed_err:.3e} (f32 tolerance), "
          f"greedy token {tok_a[0]} on both; phase "
          f"{time.perf_counter() - phase_t0:.1f} s", flush=True)
    del model, params, whole, step
    peak("deepseek-f32")

    # ------------- 23. Qwen2-VL, embeds input with M-RoPE (main path)
    # 23.1 f32 at the published widths, depth cut to QWEN2VL_F32_LAYERS:
    # prefill on the kernel path (K1 in f32, group 8, D 128) against
    # use_pallas=False, with streams that differ (an image block).
    phase_t0 = time.perf_counter()
    cfgv32 = get_config("qwen2-vl-7b", n_layers=QWEN2VL_F32_LAYERS,
                        param_dtype="float32", compute_dtype="float32")
    model, params = init_model("qwen2vl-model", cfgv32, f" (cut from 28 to "
                               f"{QWEN2VL_F32_LAYERS} layers)")
    plain = Model(dataclasses.replace(cfgv32, use_pallas=False))
    vrng = np.random.default_rng(SEED)
    L, bucket = 100, 128
    emb = torch.zeros((1, bucket, cfgv32.d_model), device=dev)
    emb[0, :L] = torch.as_tensor(vrng.standard_normal((L, cfgv32.d_model)),
                                 dtype=torch.float32, device=dev)
    vpos = vl_positions(torch, dev, L, bucket)
    if torch.equal(vpos[0, 0], vpos[0, 1]):
        fail("qwen2-vl model: the position streams do not differ")
    batch = {"embeds": emb, "positions": vpos}
    zero_counts()
    with torch.no_grad():
        lk, _ = model.prefill(params, batch, last_pos=L - 1)
        torch.cuda.synchronize()
        vl_counts = read_counts("qwen2vl_model")
        lp, _ = plain.prefill(params, batch, last_pos=L - 1)
    torch.cuda.synchronize()
    if vl_counts["prefill_flash"] != cfgv32.n_layers:
        fail(f"qwen2-vl model: K1 launched {vl_counts['prefill_flash']} "
             f"times, expected {cfgv32.n_layers}")
    vl_err = check_close(torch, "qwen2-vl prefill logits (kernel vs plain)",
                         lk, lp, "float32")
    tok_k, tok_p = greedy(lk, cfgv32.vocab_size), greedy(lp,
                                                         cfgv32.vocab_size)
    if tok_k != tok_p:
        fail(f"qwen2-vl model: greedy first tokens differ ({tok_k} vs "
             f"{tok_p})")
    print(f"[qwen2vl-model] prefill of {L} embeddings (4 text, an 8 x 8 "
          f"image block, text; bucket {bucket}), M-RoPE sections "
          f"{cfgv32.mrope_sections}, {QWEN2VL_F32_LAYERS} layers: logits max "
          f"abs err {vl_err:.3e} (f32 tolerance); greedy first token "
          f"{tok_k[0]} on both paths; K1 launches "
          f"{vl_counts['prefill_flash']} (f32, group "
          f"{cfgv32.n_q_heads // cfgv32.n_kv_heads}, {cfgv32.n_q_heads} q "
          f"heads, D {cfgv32.head_dim}); phase "
          f"{time.perf_counter() - phase_t0:.1f} s", flush=True)
    del model, plain, params, emb, batch, lk, lp
    peak("qwen2vl-model")

    # 23.2 bf16, whole (28 layers): four prompts of embeddings prefilled
    # (K1 once a layer each), their caches in one 4-lane cache, then
    # DECODE_STEPS batched decode steps with embeds input (each new token's
    # row of the embedding table; the (B, 3, 1) positions given are the
    # M-RoPE continuation, which the decode does not read, as the
    # reference).
    phase_t0 = time.perf_counter()
    cfgv = get_config("qwen2-vl-7b")
    model, params = init_model("qwen2vl-serve", cfgv)
    max_seq = 1024
    prompts = [torch.as_tensor(vrng.standard_normal((n, cfgv.d_model)),
                               dtype=torch.bfloat16, device=dev)
               for n in REMAINING_LENGTHS]
    table = params["embed"]["table"]
    zero_counts()
    with keep_inputs(ops, "_prefill_call") as seen, torch.no_grad():
        t0 = time.perf_counter()
        cache = model.init_cache(len(prompts), max_seq)
        toks, nxt = [], []
        for i, e in enumerate(prompts):
            n = e.shape[0]
            bucket = length_bucket(n, max_seq)
            x = torch.zeros((1, bucket, cfgv.d_model), dtype=torch.bfloat16,
                            device=dev)
            x[0, :n] = e
            p3 = vl_positions(torch, dev, n, bucket)
            lg, c = model.prefill(params, {"embeds": x, "positions": p3},
                                  last_pos=n - 1)
            fill_lane(cache, c, i)
            toks.append(greedy(lg, cfgv.vocab_size))
            nxt.append(int(p3[0, :, :n].max()) + 1)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        pos = torch.as_tensor(REMAINING_LENGTHS, device=dev)
        for step in range(DECODE_STEPS):
            e = table[torch.as_tensor([t[-1] for t in toks], device=dev)]
            p3 = (torch.as_tensor(nxt, device=dev) + step)[:, None, None] \
                .expand(len(prompts), 3, 1)
            lg, cache = model.decode_step(params, cache, {
                "embeds": e[:, None], "positions": p3}, pos + step)
            for t, nt in zip(toks, greedy(lg, cfgv.vocab_size), strict=True):
                t.append(nt)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    vl_counts = read_counts("qwen2vl_serve")
    want = len(prompts) * cfgv.n_layers
    if vl_counts["prefill_flash"] != want:
        fail(f"qwen2-vl serve: K1 launched {vl_counts['prefill_flash']} "
             f"times, expected {want}")
    for t in toks:
        if len(t) != DECODE_STEPS + 1 or not all(
                0 <= x < cfgv.vocab_size for x in t):
            fail(f"qwen2-vl serve: tokens {t}")
    n_tok = sum(len(t) for t in toks)
    print(f"[qwen2vl-serve] {card}: {len(prompts)} prompts of "
          f"{list(REMAINING_LENGTHS)} embeddings prefilled, then "
          f"{DECODE_STEPS} batched decode steps with embeds input: {n_tok} "
          f"tokens in {wall_s:.3f} s wall -> {n_tok / wall_s:.2f} tokens/s "
          f"(prefills {prefill_s:.3f} s, decode steps "
          f"{wall_s - prefill_s:.3f} s); K1 launches "
          f"{vl_counts['prefill_flash']} at group "
          f"{cfgv.n_q_heads // cfgv.n_kv_heads} ({cfgv.n_q_heads} q heads); "
          f"first tokens {[t[:4] for t in toks]}", flush=True)
    k1_err = max(k1_err, k1_on_seen("qwen2vl-serve", seen))
    print(f"[qwen2vl] phase {time.perf_counter() - phase_t0:.1f} s",
          flush=True)
    del model, params, prompts, table, cache, seen, lg, c, x, e
    peak("qwen2vl-serve")

    # ------------------------ 24. SeamlessM4T-medium, enc-dec (main path)
    # 24.1 f32 at full width and depth: encode SEAMLESS_FRAMES seeded frames
    # (K4 non-causal, once an encoder layer), then prefill a target prompt
    # (the prefill encodes again, as the reference's does; K1 at group 1,
    # D 64, once a decoder layer) against use_pallas=False.
    phase_t0 = time.perf_counter()
    cfgs32 = get_config("seamless-m4t-medium", param_dtype="float32",
                        compute_dtype="float32")
    model, params = init_model("seamless-model", cfgs32, f" (encoder "
                               f"{cfgs32.encoder.n_layers} layers, vocab "
                               f"{cfgs32.vocab_size} padded to "
                               f"{cfgs32.padded_vocab})")
    plain = Model(dataclasses.replace(cfgs32, use_pallas=False))
    srng = np.random.default_rng(SEED)
    n_enc = cfgs32.encoder.n_layers
    src = torch.as_tensor(srng.standard_normal(
        (1, SEAMLESS_FRAMES, cfgs32.d_model)), dtype=torch.float32,
        device=dev)
    L, bucket = 100, 128
    tgt = torch.zeros((1, bucket), dtype=torch.int64, device=dev)
    tgt[0, :L] = torch.as_tensor(srng.integers(0, cfgs32.vocab_size, L),
                                 device=dev)
    batch = {"src_embeds": src, "tgt_tokens": tgt}
    zero_counts()
    with torch.no_grad():
        mem_k = model.encode(params, src)
        torch.cuda.synchronize()
        if fa.LAUNCHES["flash_attention_fwd"] != n_enc:
            fail(f"seamless model: encode launched K4 "
                 f"{fa.LAUNCHES['flash_attention_fwd']} times, expected "
                 f"{n_enc}")
        lk, ck = model.prefill(params, batch, last_pos=L - 1)
        torch.cuda.synchronize()
        s_counts = read_counts("seamless_model")
        mem_p = plain.encode(params, src)
        lp, cp = plain.prefill(params, batch, last_pos=L - 1)
    torch.cuda.synchronize()
    want = {"flash_attention_fwd": 2 * n_enc,
            "prefill_flash": cfgs32.n_layers}
    if {key: s_counts[key] for key in want} != want:
        fail(f"seamless model: launches {s_counts}, expected {want}")
    mem_err = check_close(torch, "seamless encoder memory (kernel vs plain)",
                          mem_k, mem_p, "float32")
    s_err = check_close(torch, "seamless prefill logits (kernel vs plain)",
                        lk, lp, "float32")
    cross_err = max(check_close(
        torch, f"seamless cross cache {name} (kernel vs plain)",
        getattr(ck["periods"]["pos0"]["cross"], name),
        getattr(cp["periods"]["pos0"]["cross"], name), "float32")
        for name in ("k", "v"))
    tok_k, tok_p = greedy(lk, cfgs32.vocab_size), greedy(lp,
                                                         cfgs32.vocab_size)
    if tok_k != tok_p:
        fail(f"seamless model: greedy first tokens differ ({tok_k} vs "
             f"{tok_p})")
    print(f"[seamless-model] encode of {SEAMLESS_FRAMES} frames: memory max "
          f"abs err {mem_err:.3e}; prefill of {L} target tokens (bucket "
          f"{bucket}): logits max abs err {s_err:.3e}, cross caches "
          f"{cross_err:.3e} (f32 tolerance); greedy first token {tok_k[0]} "
          f"on both paths; launches K4 forward "
          f"{s_counts['flash_attention_fwd']} (non-causal, {n_enc} an "
          f"encode), K1 {s_counts['prefill_flash']} (f32, group 1, D "
          f"{cfgs32.head_dim}); phase {time.perf_counter() - phase_t0:.1f} s",
          flush=True)
    del model, plain, params, src, batch, mem_k, mem_p, lk, lp, ck, cp
    peak("seamless-model")

    # 24.2 bf16: four requests, each a prefill (which encodes its seeded
    # frames) into lane i of one cache from init_cache(4, max_seq,
    # cross_seq=SEAMLESS_FRAMES) (the cross cache the memory's exact
    # length: a longer one would attend to its zero rows, as in the
    # reference), then DECODE_STEPS batched decode steps.
    phase_t0 = time.perf_counter()
    cfgs = get_config("seamless-m4t-medium")
    model, params = init_model("seamless-serve", cfgs)
    srcs = [torch.as_tensor(srng.standard_normal(
        (1, SEAMLESS_FRAMES, cfgs.d_model)), dtype=torch.bfloat16,
        device=dev) for _ in SEAMLESS_LENGTHS]
    prompts = [srng.integers(0, cfgs.vocab_size, n) for n in SEAMLESS_LENGTHS]
    zero_counts()
    with keep_inputs(ops, "_prefill_call") as seen1, \
            keep_inputs(flash_ops, "_flash_call") as seen4, torch.no_grad():
        t0 = time.perf_counter()
        cache = model.init_cache(len(prompts), max_seq,
                                 cross_seq=SEAMLESS_FRAMES)
        toks = []
        for i, (sx, pr) in enumerate(zip(srcs, prompts, strict=True)):
            n = len(pr)
            tgt = torch.zeros((1, length_bucket(n, max_seq)),
                              dtype=torch.int64, device=dev)
            tgt[0, :n] = torch.as_tensor(pr, device=dev)
            lg, c = model.prefill(params, {"src_embeds": sx,
                                           "tgt_tokens": tgt}, last_pos=n - 1)
            fill_lane(cache, c, i)
            toks.append(greedy(lg, cfgs.vocab_size))
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        pos = torch.as_tensor(SEAMLESS_LENGTHS, device=dev)
        for step in range(DECODE_STEPS):
            last = torch.as_tensor([[t[-1]] for t in toks], device=dev)
            lg, cache = model.decode_step(params, cache, last, pos + step)
            for t, nt in zip(toks, greedy(lg, cfgs.vocab_size), strict=True):
                t.append(nt)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    s_counts = read_counts("seamless_serve")
    want = {"flash_attention_fwd": len(prompts) * cfgs.encoder.n_layers,
            "prefill_flash": len(prompts) * cfgs.n_layers}
    if {key: s_counts[key] for key in want} != want:
        fail(f"seamless serve: launches {s_counts}, expected {want}")
    for t in toks:
        if len(t) != DECODE_STEPS + 1 or not all(
                0 <= x < cfgs.vocab_size for x in t):
            fail(f"seamless serve: tokens {t}")
    n_tok = sum(len(t) for t in toks)
    print(f"[seamless-serve] {card}: {len(prompts)} requests ("
          f"{SEAMLESS_FRAMES} frames each, target prompts of "
          f"{list(SEAMLESS_LENGTHS)} tokens) prefilled, then {DECODE_STEPS} "
          f"batched decode steps: {n_tok} tokens in {wall_s:.3f} s wall -> "
          f"{n_tok / wall_s:.2f} tokens/s (prefills with their encodes "
          f"{prefill_s:.3f} s, decode steps {wall_s - prefill_s:.3f} s); "
          f"launches K4 forward {s_counts['flash_attention_fwd']} (non-causal"
          f"), K1 {s_counts['prefill_flash']} (group 1, D {cfgs.head_dim}); "
          f"first tokens {[t[:4] for t in toks]}", flush=True)
    k1_err = max(k1_err, k1_on_seen("seamless-serve", seen1))
    k4_on_seen("seamless-serve", seen4)
    print(f"[seamless] phase {time.perf_counter() - phase_t0:.1f} s",
          flush=True)
    del model, params, srcs, cache, seen1, seen4, lg, c
    peak("seamless-serve")

    # -------- 28. bf16 training of Qwen2-VL, SeamlessM4T and DeepSeek-V2
    # through train_single (main path).  Each at its published widths from
    # init(SEED): Qwen2-VL-7B cut to QWEN2VL_TRAIN_LAYERS on embeddings with
    # M-RoPE streams that differ, SeamlessM4T-medium whole at two target
    # lengths (two graphs in one BatchSteps), DeepSeek-V2 at its dense first
    # layer and one MLA + MoE layer on tokens.  First the f32 cuts on the
    # kernel route against use_pallas=False (one step's loss and every
    # gradient leaf); then each bf16 model on the compiled route and the
    # eager one in turn, each freed before the next: losses, every
    # parameter leaf (SHA-256) and K4's launches equal on both; K4 held
    # against its plain version on every input shape the routes gave it.
    from repro_torch.models.config import EncoderConfig

    phase_t0 = time.perf_counter()
    print(f"[train-single] begins {phase_t0 - smoke_t0:.1f} s into the run, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated",
          flush=True)

    def k4_train_launches(cfg, steps: int) -> dict[str, int]:
        """K4's launches in ``steps`` training steps: each attention layer
        (encoder self-attention, decoder self- and cross-attention) runs
        the forward twice (the forward and its recompute under remat) and
        each backward kernel once."""
        n = cfg.n_layers * (2 if cfg.is_enc_dec else 1) + (
            cfg.encoder.n_layers if cfg.is_enc_dec else 0)
        return {"flash_attention_fwd": 2 * n * steps,
                "flash_attention_bwd_dq": n * steps,
                "flash_attention_bwd_dkdv": n * steps}

    def check_k4_train(path: str, cfg, steps: int) -> dict[str, int]:
        counts = read_counts(path)
        got = {key: counts[key] for key in K4_KERNELS}
        want = k4_train_launches(cfg, steps)
        if got != want:
            fail(f"{path}: K4 launches {got}, predicted {want}")
        others = {key: n for key, n in counts.items()
                  if n and key not in K4_KERNELS}
        if others:
            fail(f"{path}: kernels other than K4 launched: {others}")
        return got

    def f32_check(tag: str, cfg, batches) -> None:
        """One step's loss and every gradient leaf of ``cfg`` (f32) on the
        kernel route against use_pallas=False, on each batch shape."""
        model = Model(cfg)
        plain = Model(dataclasses.replace(cfg, use_pallas=False))
        params = model.init(SEED)
        shapes = {}
        for b in batches:
            shapes.setdefault(tuple(tuple(v.shape) for v in b.values()), b)
        for i, batch in enumerate(shapes.values()):
            zero_counts()
            with keep_inputs(flash_ops, "_flash_call") as seen:
                t0 = time.perf_counter()
                (loss_k, _), grads_k = make_grain_grad_fn(
                    model, compile_steps=False)(params, batch)
                torch.cuda.synchronize()
                grain_k_s = time.perf_counter() - t0
            launches = check_k4_train(f"{tag.replace('-', '_')}_f32_{i}",
                                      cfg, 1)
            t0 = time.perf_counter()
            (loss_p, _), grads_p = make_grain_grad_fn(
                plain, compile_steps=False)(params, batch)
            torch.cuda.synchronize()
            grain_p_s = time.perf_counter() - t0
            loss_err = check_close(torch, f"{tag} f32 loss", loss_k, loss_p,
                                   "float32", GRAD_TOL)
            leaf_err, leaf_rel = 0.0, (0.0, None)
            for i, (gk, gp) in enumerate(zip(tree_leaves(grads_k),
                                             tree_leaves(grads_p),
                                             strict=True)):
                leaf_err = max(leaf_err, check_close(
                    torch, f"{tag} f32 gradient leaf {i} {tuple(gk.shape)}",
                    gk, gp, "float32", GRAD_TOL))
                rel = float(torch.linalg.vector_norm((gk - gp).float())
                            / torch.linalg.vector_norm(gp.float())
                            .clamp_min(1e-30))
                if rel >= leaf_rel[0]:
                    leaf_rel = (rel, (i, tuple(gk.shape)))
            print(f"[{tag}] {card}: one f32 step of {cfg.name} cut to "
                  f"{cfg.n_layers} layers"
                  + (f" (+ {cfg.encoder.n_layers} encoder layers)"
                     if cfg.is_enc_dec else "")
                  + f", batch {json.dumps({k: list(v.shape) for k, v in batch.items()})}"
                  f": loss {float(loss_k):.6f} kernel route vs "
                  f"{float(loss_p):.6f} plain (abs err {loss_err:.3e}); "
                  f"every gradient leaf within GRAD_TOL (max abs err "
                  f"{leaf_err:.3e}; worst relative Frobenius error "
                  f"{leaf_rel[0]:.3e}, leaf {leaf_rel[1]}); K4 launches "
                  f"{json.dumps(launches)}; host s with the wait: kernel "
                  f"route {grain_k_s:.3f}, plain {grain_p_s:.3f}", flush=True)
            k4_on_seen(f"{tag}-f32", seen)
            del grads_k, grads_p, loss_k, loss_p, seen
        del model, plain, params
        gc.collect()
        torch.cuda.empty_cache()

    def train_paths(tag: str, cfg, path: str) -> dict:
        """``train_single_route`` of bf16 ``cfg`` compiled, then eager; the
        checks and figures above.  Returns each route's figures."""
        batches = train_single_batches(torch, cfg, dev)
        n_shapes = len({tuple(tuple(v.shape) for v in b.values())
                        for b in batches})
        steady = slice(2 * n_shapes, TRAIN_SINGLE_STEPS * n_shapes)
        runs = {}
        for compile_steps in (True, False):
            run = path if compile_steps else f"{path}_eager"
            zero_counts()
            with keep_inputs(flash_ops, "_flash_call") as seen:
                r = train_single_route(
                    torch, cfg, batches, compile_steps,
                    TRAIN_SINGLE_STEPS * n_shapes if compile_steps else None,
                    K4_BF16_KERNELS)
            if "oom" in r:
                fail(f"{tag} ({r['route']}): out of the card's memory: "
                     f"{json.dumps(r['oom'])}")
            r["launches"] = check_k4_train(run, cfg, len(batches))
            if not (all(np.isfinite(x) for x in r["loss"])
                    and r["launches"]["flash_attention_bwd_dq"] > 0):
                fail(f"{tag} ({r['route']}): losses {r['loss']}, launches "
                     f"{r['launches']}")
            graphs = r["graphs"]
            if compile_steps != (graphs["captures"] == n_shapes):
                fail(f"{tag} ({r['route']}): {graphs['captures']} graphs "
                     f"captured for {n_shapes} batch shapes")
            tok = sum(r["tokens"][steady])
            r["steady_s"] = sum(r["step_s"][steady])
            r["tokens_s"] = tok / r["steady_s"]
            print(f"[{tag}] {card}: {r['route']} route, bf16 {cfg.name} ("
                  f"{cfg.n_layers} layers"
                  + (f" + {cfg.encoder.n_layers} encoder layers"
                     if cfg.is_enc_dec else "")
                  + f", {r['params'] / 1e9:.3f} B parameters), "
                  f"{len(batches)} steps of {n_shapes} batch shape(s): "
                  f"losses {[round(x, 6) for x in r['loss']]}, host s a step "
                  f"(the first with the init; warm-up, capture + replay, "
                  f"replays) {[round(x, 4) for x in r['step_s']]}; a steady "
                  f"step {r['steady_s'] / n_shapes:.4f} s -> "
                  f"{r['tokens_s']:.1f} tokens/s; peak {r['peak_gb']:.2f} "
                  f"GB (torch.cuda.max_memory_allocated), reserved at most "
                  f"{r['reserved_gb']:.2f} GB of the card's "
                  f"{r['card_gb']:.2f}; graphs "
                  f"{graphs['captures']} captured in "
                  f"{graphs['capture_s']:.3f} s, pool "
                  f"{graphs['pool_bytes'] / 1e9:.3f} GB, "
                  f"{graphs['replays']} replays; K4 launches "
                  f"{json.dumps(r['launches'])}; the leaves' digests "
                  f"{r['digest_s']:.1f} s", flush=True)
            if "profiled" in r:
                pr = r["profiled"]
                print_busy(card, f"{r['route']} route, {pr['steps']} steady "
                           f"step(s)", pr["wall_s"], pr["busy_s"],
                           pr["kernel_s"], r["steady_s"], tag=tag,
                           kernel="K4")
                print(f"[{tag}] K4's share of the steady compiled step's "
                      f"kernels: {pr['kernel_s'] / max(pr['busy_s'], 1e-30):.4f}",
                      flush=True)
            if not compile_steps:
                k4_on_seen(tag, seen)
            del seen
            runs[r["route"]] = r
        fast, slow = runs["compiled"], runs["eager"]
        for key in ("loss", "grad_norm", "digests", "launches"):
            if fast[key] != slow[key]:
                fail(f"{tag}: the compiled and eager routes' {key} differ")
        print(f"[{tag}] compiled vs eager, {len(batches)} steps: all "
              f"{len(fast['digests'])} parameter leaves bitwise equal "
              f"(SHA-256), losses equal, K4 launches equal; tokens/s "
              f"{fast['tokens_s']:.1f} vs {slow['tokens_s']:.1f}, peak "
              f"{fast['peak_gb']:.2f} GB vs {slow['peak_gb']:.2f} GB",
              flush=True)
        return runs

    # 28.1 Qwen2-VL-7B: f32 at QWEN2VL_F32_LAYERS, then bf16 at
    # QWEN2VL_TRAIN_LAYERS (K4 q (32, 1024, 128) over k/v (4, 1024, 128),
    # causal, in every layer).
    cfg_v = get_config("qwen2-vl-7b", n_layers=QWEN2VL_F32_LAYERS,
                       param_dtype="float32", compute_dtype="float32")
    f32_check("qwen2vl-train", cfg_v, train_single_batches(torch, cfg_v, dev))
    train_runs = {"qwen2vl": train_paths(
        "qwen2vl-train", get_config("qwen2-vl-7b",
                                    n_layers=QWEN2VL_TRAIN_LAYERS),
        "qwen2vl_train")}
    peak("qwen2vl-train")

    # 28.2 SeamlessM4T-medium: f32 at 4 + 4 layers, then bf16 whole; K4 in
    # the encoder's self-attention (non-causal), the decoder's (causal) and
    # the cross-attention, D 64 over 16 heads.
    cfg_s = get_config("seamless-m4t-medium",
                       n_layers=SEAMLESS_TRAIN_F32_LAYERS,
                       encoder=EncoderConfig(
                           n_layers=SEAMLESS_TRAIN_F32_LAYERS),
                       param_dtype="float32", compute_dtype="float32")
    f32_check("seamless-train", cfg_s, train_single_batches(torch, cfg_s, dev))
    train_runs["seamless"] = train_paths(
        "seamless-train", get_config("seamless-m4t-medium"), "seamless_train")
    peak("seamless-train")

    # 28.3 DeepSeek-V2 at its dense first layer and one MLA + MoE layer, on
    # tokens: the capacity-routed MoE backward over 160 experts.  No kernel
    # runs (MLA's q/k head dim of 192 is not one of K4's; MLA is plain
    # einsums, as in the reference).  Each route in a process of its own,
    # the eager one first, on the default allocator: until ``global_norm``
    # summed a slice at a time, its f32 copy of an expert-sized gradient
    # leaf (4.69 GiB) made both routes run out there, and they ran on
    # expandable segments.
    t0 = time.perf_counter()
    ds = {}
    for route in ("eager", "compiled"):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--train-route",
             "deepseek-v2-236b", str(DEEPSEEK_TRAIN_LAYERS), route],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            fail(f"deepseek train ({route}): exit {proc.returncode}: "
                 f"{proc.stderr[-3000:]}")
        ds.update(json.loads(proc.stdout.strip().splitlines()[-1]))
    for route, r in ds.items():
        by_path[f"deepseek_train_{route}"] = r["launches"]
        if any(r["launches"].values()):
            fail(f"deepseek train ({route}): kernels launched on an MLA "
                 f"path: {r['launches']}")
        if "oom" in r:
            print(f"[deepseek-train] {card}: {route} route ran out of the "
                  f"card's memory: {json.dumps(r['oom'])}", flush=True)
            continue
        if not all(np.isfinite(x) for x in r["loss"]):
            fail(f"deepseek train ({route}): losses {r['loss']}")
        print(f"[deepseek-train] {card}: {route} route, bf16 deepseek-v2-236b "
              f"({DEEPSEEK_TRAIN_LAYERS} layers: the dense first and one MLA "
              f"+ MoE layer, {r['params'] / 1e9:.3f} B parameters), "
              f"{r['steps']} steps of one {TRAIN_SEQ}-token sequence: losses "
              f"{[round(x, 6) for x in r['loss']]}, host s a step "
              f"{[round(x, 4) for x in r['step_s']]} -> "
              f"{TRAIN_SEQ / r['step_s'][-1]:.1f} tokens/s at the last; "
              f"peak {r['peak_gb']:.2f} GB, reserved at most "
              f"{r['reserved_gb']:.2f} GB of the card's {r['card_gb']:.2f}; "
              f"graphs "
              f"{r['graphs']['captures']} captured, pool "
              f"{r['graphs']['pool_bytes'] / 1e9:.3f} GB; no kernel "
              f"launched", flush=True)
    if "oom" not in ds.get("eager", {"oom": 1}) and \
            "oom" not in ds.get("compiled", {"oom": 1}):
        for key in ("loss", "grad_norm", "digests"):
            if ds["eager"][key] != ds["compiled"][key]:
                fail(f"deepseek train: the compiled and eager routes' {key} "
                     f"differ")
        print(f"[deepseek-train] compiled vs eager: all "
              f"{len(ds['eager']['digests'])} parameter leaves bitwise "
              f"equal (SHA-256), losses equal", flush=True)
    train_runs["deepseek"] = ds
    print(f"[deepseek-train] processes {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(f"[train-single] phase {time.perf_counter() - phase_t0:.1f} s",
          flush=True)

    # ------------------------------------- 25. distribution (main path)
    # The sharded steps of sharding/apply.py on a (1, 1) ("data", "model")
    # mesh over NCCL at world size 1, where every collective is the
    # identity: each sharded step must give the unsharded step's bits.
    import torch.distributed as dist

    from repro_torch.data import MemmapSource
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding import Policy
    from repro_torch.sharding.apply import (
        distribute_tree,
        local_tree,
        make_sharded_decode_step,
        make_sharded_prefill_step,
        make_sharded_train_step,
    )
    from repro_torch.train import (
        HDPConfig,
        HDPTrainer,
        Pod,
        TrainState,
        init_train_state,
        make_decode_step,
        make_prefill_step,
        make_train_step,
    )

    phase_t0 = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    mesh = make_debug_mesh(1, 1, device_type="cuda")
    cfgd = dataclasses.replace(get_config("qwen2-1.5b"),
                               sharding_policy="fsdp_tp")
    model = Model(cfgd)
    policy = Policy(cfgd, mesh)
    spec1 = GrainSpec(1, TRAIN_SEQ, cfgd.vocab_size)
    batch = batch_from_grains(SyntheticSource(spec1, seed=SEED), 0,
                              list(range(TRAIN_GRAINS)), spec1, device=dev)

    # 25.1 (a) One train step of phase 11's batch (8 grains of one
    # 1024-token sequence), unsharded then sharded, each from init(SEED).
    def train_once(sharded: bool) -> dict:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = init_train_state(model.init(SEED))
        if sharded:
            state = TrainState(
                params=distribute_tree(state.params,
                                       policy.param_specs(state.params), mesh),
                opt=distribute_tree(state.opt, policy.opt_specs(state.params),
                                    mesh))
            step = make_sharded_train_step(model, mesh)
            b = distribute_tree(batch, policy.batch_specs(batch), mesh)
        else:
            step, b = make_train_step(model), batch
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        state, met = step(state, b)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        path = "dist_train" if sharded else "dist_train_unsharded"
        check_k4_launches(path, 1)
        out = {"loss": float(met["loss"]), "grad_norm": float(
            met["grad_norm"]), "s": secs,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        for key, tree in (("params", state.params), ("m", state.opt["m"]),
                          ("v", state.opt["v"])):
            out[key] = leaf_digests(torch, tree_leaves, local_tree(tree))
        del state, met
        return out

    plain_run = train_once(False)
    shard_run = train_once(True)
    for key in ("loss", "grad_norm", "params", "m", "v"):
        if shard_run[key] != plain_run[key]:
            fail(f"distribution: the sharded train step's {key} differs from "
                 f"the unsharded step's")
    print(f"[distribution] {card}: one train step of bf16 {cfgd.name} "
          f"(fsdp_tp on a (1, 1) mesh, NCCL at world size 1), batch "
          f"{tuple(batch['tokens'].shape)}: loss {shard_run['loss']:.6f} and "
          f"grad norm {shard_run['grad_norm']:.6f} equal, all "
          f"{len(shard_run['params'])} parameter leaves and both moments "
          f"bitwise equal (SHA-256); step s with the wait: sharded "
          f"{shard_run['s']:.3f}, unsharded {plain_run['s']:.3f}; peak memory "
          f"sharded {shard_run['peak_gb']:.2f} GB, unsharded "
          f"{plain_run['peak_gb']:.2f} GB (torch.cuda.max_memory_allocated); "
          f"K4 launches {json.dumps(by_path['dist_train'])}", flush=True)

    # 25.2 (b) Prefill of 4 prompts of REMAINING_LENGTHS (right-padded to
    # 512), then DECODE_STEPS greedy decode steps (each row from its last
    # prompt token), sharded against unsharded.
    gc.collect()
    torch.cuda.empty_cache()
    params = model.init(SEED)
    sparams = distribute_tree(params, policy.param_specs(params), mesh)
    prng = np.random.default_rng(SEED)
    bucket = 512
    tokens = torch.zeros((len(REMAINING_LENGTHS), bucket), dtype=torch.int32,
                         device=dev)
    for i, n in enumerate(REMAINING_LENGTHS):
        tokens[i, :n] = torch.as_tensor(prng.integers(0, cfgd.vocab_size, n),
                                        dtype=torch.int32, device=dev)
    pbatch = {"tokens": tokens}
    zero_counts()
    with keep_inputs(ops, "_prefill_call") as seen:
        lg_u, c_u = make_prefill_step(model)(params, pbatch)
        torch.cuda.synchronize()
    read_counts("dist_prefill_unsharded")
    zero_counts()
    lg_s, c_s = make_sharded_prefill_step(model, mesh)(
        sparams, distribute_tree(pbatch, policy.batch_specs(pbatch), mesh))
    torch.cuda.synchronize()
    k1_dist = read_counts("dist_prefill")["prefill_flash"]
    if k1_dist != N_LAYERS:
        fail(f"distribution: the sharded prefill launched K1 {k1_dist} "
             f"times, expected {N_LAYERS}")
    if not torch.equal(lg_s.to_local(), lg_u) or leaf_digests(
            torch, tree_leaves, local_tree(c_s)) != leaf_digests(
            torch, tree_leaves, c_u):
        fail("distribution: the sharded prefill's logits or caches differ")
    k1_err = max(k1_err, k1_on_seen("distribution", seen))

    def long_cache(caches):
        big = model.init_cache(len(REMAINING_LENGTHS), 2 * bucket)
        for b_leaf, s_leaf in zip(tree_leaves(big), tree_leaves(caches),
                                  strict=True):
            b_leaf.narrow(2, 0, bucket).copy_(s_leaf)
        return big

    caches_u = long_cache(c_u)
    caches_s = distribute_tree(long_cache(local_tree(c_s)),
                               policy.cache_specs(caches_u), mesh)
    del c_u, c_s, lg_u, lg_s
    last = torch.as_tensor([n - 1 for n in REMAINING_LENGTHS], device=dev)
    inp = tokens[torch.arange(len(REMAINING_LENGTHS), device=dev), last][:,
                                                                          None]
    dstep, sdstep = make_decode_step(model), make_sharded_decode_step(model,
                                                                      mesh)
    toks_u, toks_s = [], []
    inp_u = inp_s = inp
    t0 = time.perf_counter()
    for i in range(DECODE_STEPS):
        pos = (last + i).to(torch.int32)
        lg_u, caches_u = dstep(params, caches_u, inp_u, pos)
        lg_s, caches_s = sdstep(
            sparams, caches_s, distribute_tree(inp_s, policy.batch_specs(
                inp_s), mesh), distribute_tree(pos, policy.batch_specs(pos),
                                               mesh))
        lg_s = lg_s.to_local()
        if not torch.equal(lg_s, lg_u):
            fail(f"distribution: decode step {i}: the sharded logits differ")
        if i == 0:          # phase 26's reference for (b)
            logits0_u = lg_u[:, 0].float()
        inp_u = lg_u[:, 0, :cfgd.vocab_size].argmax(-1, keepdim=True).to(
            torch.int32)
        inp_s = lg_s[:, 0, :cfgd.vocab_size].argmax(-1, keepdim=True).to(
            torch.int32)
        toks_u.append(inp_u[:, 0].tolist())
        toks_s.append(inp_s[:, 0].tolist())
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    if toks_s != toks_u or leaf_digests(torch, tree_leaves, local_tree(
            caches_s)) != leaf_digests(torch, tree_leaves, caches_u):
        fail("distribution: the sharded decode's tokens or caches differ")
    print(f"[distribution] {card}: prefill of {len(REMAINING_LENGTHS)} "
          f"prompts of {list(REMAINING_LENGTHS)} tokens (padded to {bucket}; "
          f"K1 {k1_dist} launches) and {DECODE_STEPS} decode steps, sharded "
          f"against unsharded: logits and caches bitwise equal, tokens equal "
          f"(first {[t[:4] for t in zip(*toks_s)]}); both decodes "
          f"{decode_s:.3f} s", flush=True)
    # Phase 26's yardstick for (b): the unsharded decode's first step on
    # the plain route (use_pallas=False), against the kernel route's.
    plain = Model(dataclasses.replace(cfgd, use_pallas=False))
    _, c_p = make_prefill_step(plain)(params, pbatch)
    lg_p, _ = make_decode_step(plain)(params, long_cache(c_p), inp, last.to(
        torch.int32))
    logits0_plain = lg_p[:, 0].float()
    del params, sparams, caches_u, caches_s, lg_u, lg_s, seen, plain, c_p
    del lg_p

    # 25.3 (c) Phase 11's one f32 grain again under remat_policy="dots"
    # against the default policy.
    cfg32 = get_config("qwen2-1.5b", param_dtype="float32",
                       compute_dtype="float32")
    spec32 = GrainSpec(1, TRAIN_SEQ, cfg32.vocab_size)
    gbatch = batch_from_grains(SyntheticSource(spec32, seed=SEED), 0, [0],
                               spec32, device=dev)
    remat = {}
    for pol_name in ("nothing", "dots"):
        m32 = Model(dataclasses.replace(cfg32, remat_policy=pol_name))
        gc.collect()
        torch.cuda.empty_cache()
        p32 = m32.init(SEED)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        (loss, _), grads = make_grain_grad_fn(m32)(p32, gbatch)
        torch.cuda.synchronize()
        check_k4_launches(f"dist_remat_{pol_name}", 1)
        remat[pol_name] = (loss, grads,
                           torch.cuda.max_memory_allocated() / 1e9)
        del p32, m32
    (l_n, g_n, pk_n), (l_d, g_d, pk_d) = remat["nothing"], remat["dots"]
    check_close(torch, "dots loss", l_d, l_n, "float32")
    for i, (a, b) in enumerate(zip(tree_leaves(g_d), tree_leaves(g_n),
                                   strict=True)):
        check_close(torch, f"dots gradient leaf {i}", a, b, "float32")
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(g_d),
                                                  tree_leaves(g_n)))
    print(f"[distribution] {card}: remat_policy='dots' on one f32 grain of "
          f"{cfg32.name}: loss {float(l_d):.6f} vs {float(l_n):.6f} "
          f"('nothing'), gradients within the f32 tolerance (bitwise equal: "
          f"{same}); peak memory dots {pk_d:.2f} GB, nothing {pk_n:.2f} GB",
          flush=True)
    del remat, g_n, g_d, l_n, l_d, gbatch, grads, a, b

    # 25.4 (e) MemmapSource: two HDP steps of phase 11's fleet, each grain
    # read from a .npy of tokens the phase writes.
    class _Served(MemmapSource):
        """Keeps every grain it serves."""

        def __init__(self, path, spec):
            super().__init__(path, spec)
            self.served = {}

        def grain(self, step, gid):
            out = super().grain(step, gid)
            self.served[(step, gid)] = out
            return out

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tokens.npy")
        stream = np.random.default_rng(SEED).integers(
            0, cfgd.vocab_size, 64 * TRAIN_SEQ + 1).astype(np.int32)
        np.save(path, stream)
        fleet = FleetSpec.parse("4:3:2:1", prefix="pod")
        trainer = HDPTrainer(model, [Pod(w.name, w.perf)
                                     for w in fleet.workers],
                             HDPConfig(total_grains=TRAIN_GRAINS,
                                       grain_spec=spec1, seed=SEED))
        trainer.source = _Served(path, spec1)
        zero_counts()
        t0 = time.perf_counter()
        history = trainer.run(2)
        torch.cuda.synchronize()
        mm_s = time.perf_counter() - t0
        check_k4_launches("dist_memmap", 2 * TRAIN_GRAINS)
        served = trainer.source.served
        del trainer
    n_win = (len(stream) - 1) // TRAIN_SEQ
    for (step, gid), g in served.items():
        w = (step * 1_000_003 + gid) % n_win
        if not np.array_equal(g[0], stream[w * TRAIN_SEQ:
                                           (w + 1) * TRAIN_SEQ + 1]):
            fail(f"distribution: memmap grain ({step}, {gid}) is not the "
                 f"file's window {w}")
    losses = [h["loss"] for h in history]
    if sorted(served) != [(s, g) for s in range(2)
                          for g in range(TRAIN_GRAINS)] or not all(
            np.isfinite(x) for x in losses):
        fail(f"distribution: memmap run served {sorted(served)}, losses "
             f"{losses}")
    print(f"[distribution] {card}: MemmapSource, {fleet}: 2 HDP steps of "
          f"{TRAIN_GRAINS} grains of bf16 {cfgd.name} at seq {TRAIN_SEQ}, "
          f"every grain the file's window ({len(served)} grains from "
          f"{n_win} windows of a {stream.nbytes / 1e6:.3f} MB .npy): losses "
          f"{[round(x, 6) for x in losses]}, {mm_s:.3f} s wall", flush=True)
    del model, batch
    peak("distribution")

    # 25.5 (d, f, g) In processes of their own, all at once: the dry run
    # (a fake process group must not share a process with NCCL) at
    # decode_32k on the 256-device mesh and of (a)'s step on one device;
    # the train CLI under --tuned; the four examples.
    env = dict(os.environ, PYTHONPATH=SRC)
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {
            "dryrun": [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", "qwen2-1.5b", "--shape", "decode_32k",
                       "--mesh", "single", "--out", tmp],
            "dryrun_one": [sys.executable, "-c", DRY_RUN_ONE,
                           str(TRAIN_GRAINS), str(TRAIN_SEQ)],
            "tuned": [sys.executable, "-m", "repro_torch.launch.train",
                      "--tuned", "--mode", "hdp", "--steps", "2", "--seq",
                      "64", "--grains", "4"],
        }
        for name in EXAMPLES:
            jobs[f"example_{name}"] = [sys.executable, os.path.abspath(
                __file__), "--example", name]
        t0 = time.perf_counter()
        procs = {name: subprocess.Popen(cmd, cwd=HERE, env=env, text=True,
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE)
                 for name, cmd in jobs.items()}
        outs = {}
        try:
            for name, p in procs.items():
                outs[name] = p.communicate(timeout=600)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        sub_s = time.perf_counter() - t0
        for name, p in procs.items():
            if p.returncode != 0:
                fail(f"distribution: {' '.join(jobs[name][1:])} exited "
                     f"{p.returncode}: {outs[name][1][-3000:]}")
        with open(os.path.join(
                tmp, "qwen2-1.5b__decode_32k__single.json")) as f:
            dry = json.load(f)
    line = next(ln for ln in outs["dryrun"][0].splitlines()
                if ln.startswith("  ok "))
    print(f"[distribution] dry run {' '.join(jobs['dryrun'][3:-2])}: "
          f"{line.split('ok', 1)[1].strip()}", flush=True)
    if dry["n_devices"] != 256 or dry["status"] != "run":
        fail(f"distribution: dry run {dry['status']} on "
             f"{dry.get('n_devices')} devices")
    dry_one = json.loads(outs["dryrun_one"][0].splitlines()[-1])
    print(f"[distribution] {card}: the dry run of (a)'s step on one device "
          f"({dry_one['run_s']:.1f} s): predicted peak "
          f"{dry_one['peak_bytes'] / 1e9:.2f} GB on the plain path "
          f"(chunked attention) against (a)'s measured "
          f"{shard_run['peak_gb']:.2f} GB on the kernel path (K4), two "
          f"programs; predicted step flops {dry_one['flops']:.4e}, compute "
          f"term {dry_one['compute_s']:.4f} s, memory term "
          f"{dry_one['memory_s']:.4f} s against the measured "
          f"{shard_run['s']:.3f} s", flush=True)
    tuned = [ln for ln in outs["tuned"][0].splitlines()
             if ln.startswith("tuned env profile applied:")]
    if not tuned:
        fail("distribution: --tuned printed no applied keys")
    print(f"[distribution] train CLI --tuned: {tuned[0]}", flush=True)
    for name in EXAMPLES:
        lines = outs[f"example_{name}"][0].splitlines()
        last = json.loads(lines[-1])
        by_path[f"example_{name}"] = counts = last["launches"]
        for ln in lines[:-1]:
            print(f"[example {name}] {ln}", flush=True)
        print(f"[example {name}] launches {json.dumps(counts)}", flush=True)
        k4_runs = sum(counts[n] for n in K4_KERNELS)
        if k4_runs and not last["k4_cases"]:
            fail(f"distribution: example {name} launched K4 {k4_runs} times "
                 f"and kept none of its inputs")
        for part, e in last["k4_err"].items():
            k4_err[part] = max(k4_err[part], e)
    # serve_hetero's requests enter through submit (prompts fed through
    # decode steps), as the reference's: it runs no prefill and no kernel.
    for name, kernel in (("quickstart", "matmul"),
                         ("train_hetero", "flash_attention_fwd")):
        if not by_path[f"example_{name}"][kernel]:
            fail(f"distribution: example {name} launched no {kernel}")
    print(f"[distribution] subprocesses (two dry runs, the --tuned CLI, four "
          f"examples, together) {sub_s:.1f} s; phase "
          f"{time.perf_counter() - phase_t0:.1f} s", flush=True)
    dist.destroy_process_group()

    # ------------------------------------------- 26. tensor-parallel (main path)
    # The sharded steps tensor-parallel over a (1, m) mesh: ranks in
    # processes of their own (``chip_smoke.py --tp-rank``), on the one card
    # over ``launch/shared_pg.py``'s backend (mailboxes in the card's memory
    # opened through CUDA IPC, its two kernels reading them on each rank's
    # stream; each rank's counters and mailbox bytes printed, and a probe
    # of the staged backend's slowest all-gather before (d)); NCCL across
    # cards where there are m of them.  Against
    # the unsharded steps: (a) and (c) on rank 0, (b) here against phase
    # 25's unsharded bf16 train step and decode of the same batch, prompts
    # and init.
    tp = tensor_parallel(torch, card, {"loss": plain_run["loss"],
                                       "logits0": logits0_u,
                                       "logits0_plain": logits0_plain,
                                       "tokens": toks_u}, by_path)
    tp_runs, k1_tp, k4_tp = tp["runs"], tp["k1"], tp["k4"]
    k1_moe, k4_moe, k5_tp = tp["k1_moe"], tp["k4_moe"], tp["k5"]
    k1_seamless_tp, k4_cross_tp = tp["k1_seamless"], tp["k4_cross"]
    k1_err, k5_err = max(k1_err, tp["k1_err"]), max(k5_err, tp["k5_err"])
    for part, e in tp["k4_err"].items():
        k4_err[part] = max(k4_err[part], e)

    # ------------------------------------------------------ 15. device times
    # Each kernel's device time (the profiler's kernel durations, which
    # leave out the host's gaps between launches) beside PyTorch's call for
    # the same function, after every serve phase, in a process of its own
    # on seeded inputs of the path's shapes.
    dev_times = json.loads(subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--device-times"],
        capture_output=True, text=True, timeout=600,
        check=True).stdout.strip().splitlines()[-1])
    for row in k1_sweep:
        row.update(dev_times[f"k1_{row['S']}"])
    k2.update(dev_times["k2"])
    k2_large.update(dev_times["k2_large"])
    for row in k3_rows:
        row.update(dev_times["k3_{}_{}_{}".format(*row["shape"])])
    for dname, rows in (("bf16", k4_rows), ("f32", k4_f32)):
        for part, row in rows.items():
            row.update(dev_times[f"k4_{part}_{dname}"])
    k5_row.update(dev_times["k5"])
    k1_f32.update(dev_times["k1_f32"])
    k5_f32.update(dev_times["k5_f32"])
    for row in k1_groups:
        row.update(dev_times[f"k1_group_{row['group']}"])
        print(f"[device] K1 bf16 group {row['group']} q {row['shape'][0]}, "
              f"k/v {row['shape'][1]}: {row['device_ms']:.6f} ms, SDPA "
              f"{row['library_device_ms']:.6f} ms (bound "
              f"{row['bound_ms']:.6f} ms)", flush=True)
    for row in k1_remaining:
        (hq, _, d), (hkv, _, _) = row["shape"]
        row.update(dev_times[f"k1_{hq}_{hkv}_{d}"])
        print(f"[device] K1 bf16 group {row['group']} q {row['shape'][0]}, "
              f"k/v {row['shape'][1]}: {row['device_ms']:.6f} ms, SDPA "
              f"{row['library_device_ms']:.6f} ms (bound "
              f"{row['bound_ms']:.6f} ms)", flush=True)
    for key, rows in k4_seamless.items():
        for part, row in rows.items():
            row.update(dev_times[f"k4_seamless_{key}_{part}"])
            print(f"[device] K4 seamless {key} {part}: "
                  f"{row['device_ms']:.6f} ms, SDPA "
                  f"{'forward' if part == 'fwd' else 'whole backward'} "
                  f"{row['library_device_ms']:.6f} ms (bound "
                  f"{row['bound_ms']:.6f} ms)", flush=True)
    for part, row in k4_qwen2vl.items():
        row.update(dev_times[f"k4_qwen2vl_{part}"])
        print(f"[device] K4 qwen2-vl {part}: {row['device_ms']:.6f} ms, "
              f"SDPA {'forward' if part == 'fwd' else 'whole backward'} "
              f"{row['library_device_ms']:.6f} ms (bound "
              f"{row['bound_ms']:.6f} ms)", flush=True)
    k1_tp.update(dev_times["k1_tp"])
    k1_moe.update(dev_times["k1_tp_moe"])
    k1_seamless_tp.update(dev_times["k1_tp_seamless"])
    print(f"[device] K1 bf16 at SeamlessM4T's tensor-parallel decoder local "
          f"heads q {k1_seamless_tp['shape'][0]}, k/v "
          f"{k1_seamless_tp['shape'][1]}: {k1_seamless_tp['device_ms']:.6f} "
          f"ms, SDPA {k1_seamless_tp['library_device_ms']:.6f} ms (bound "
          f"{k1_seamless_tp['bound_ms']:.6f} ms)", flush=True)
    for dname, rows in k4_cross_tp.items():
        for part, row in rows.items():
            row.update(dev_times[f"k4_tp_cross_{dname}_{part}"])
            print(f"[device] K4 {dname} {part} at SeamlessM4T's tensor-"
                  f"parallel cross-attention local heads q {row['shape'][0]},"
                  f" k/v {row['shape'][1]}, non-causal: "
                  f"{row['device_ms']:.6f} ms, SDPA "
                  f"{'forward' if part == 'fwd' else 'whole backward'} "
                  f"{row['library_device_ms']:.6f} ms (bound "
                  f"{row['bound_ms']:.6f} ms)", flush=True)
    k5_tp.update(dev_times["k5_tp"])
    for part, row in k4_moe.items():
        row.update(dev_times[f"k4_tp_moe_{part}"])
        print(f"[device] K4 f32 {part} at Qwen1.5-MoE's tensor-parallel "
              f"local heads q {row['shape'][0]}, k/v {row['shape'][1]}: "
              f"{row['device_ms']:.6f} ms, SDPA f32 "
              f"{'forward' if part == 'fwd' else 'whole backward'} "
              f"{row['library_device_ms']:.6f} ms (bound "
              f"{row['bound_ms']:.6f} ms)", flush=True)
    print(f"[device] K1 bf16 at Qwen1.5-MoE's tensor-parallel local heads q "
          f"{k1_moe['shape'][0]}, k/v {k1_moe['shape'][1]}: "
          f"{k1_moe['device_ms']:.6f} ms, SDPA "
          f"{k1_moe['library_device_ms']:.6f} ms (bound "
          f"{k1_moe['bound_ms']:.6f} ms)", flush=True)
    print(f"[device] K5 bf16 at Mamba2-2.7B's tensor-parallel local heads "
          f"xdt {k5_tp['shape'][0]}, B/C {k5_tp['shape'][1]}: "
          f"{k5_tp['device_ms']:.6f} ms (bound {k5_tp['bound_ms']:.6f} ms)",
          flush=True)
    for part, row in k4_tp.items():
        row.update(dev_times[f"k4_tp_{part}"])
        print(f"[device] K4 bf16 {part} at the tensor-parallel local heads "
              f"q {row['shape'][0]}, k/v {row['shape'][1]}: "
              f"{row['device_ms']:.6f} ms, SDPA "
              f"{'forward' if part == 'fwd' else 'whole backward'} "
              f"{row['library_device_ms']:.6f} ms (bound "
              f"{row['bound_ms']:.6f} ms)", flush=True)
    print(f"[device] K1 bf16 at the tensor-parallel local heads q "
          f"{k1_tp['shape'][0]}, k/v {k1_tp['shape'][1]}: "
          f"{k1_tp['device_ms']:.6f} ms, SDPA "
          f"{k1_tp['library_device_ms']:.6f} ms (bound "
          f"{k1_tp['bound_ms']:.6f} ms)", flush=True)
    for dname in ("bf16", "f32"):
        row = k5_bwd["bfloat16" if dname == "bf16" else "float32"]
        row.update(dev_times[f"k5_bwd_{dname}"])
        print(f"[device] K5 backward {dname} xdt {row['shape'][0]}, B/C "
              f"{row['shape'][1]}: {row['device_ms']:.6f} ms (bound "
              f"{row['bound_ms']:.6f} ms); by kernel "
              + json.dumps(row["device_ms_by_kernel"]), flush=True)
    k5_jamba.update(dev_times["k5_jamba"])
    print(f"[device] K5 bf16 Jamba xdt {k5_jamba['shape'][0]}, B/C "
          f"{k5_jamba['shape'][1]}: {k5_jamba['device_ms']:.6f} ms (bound "
          f"{k5_jamba['bound_ms']:.6f} ms)", flush=True)
    for key in ("uniform", "perf", "load"):
        capacity_rows[key]["apply_moe_device_ms"] = \
            dev_times[f"moe_{key}"]["device_ms"]
        print(f"[device] apply_moe bf16, {MOE_TOKENS} tokens, {key} "
              f"capacities: {dev_times[f'moe_{key}']['device_ms']:.6f} ms",
              flush=True)
    for s, row in zip((16, 32, 64, 128, 256, 512), k1_sweep, strict=True):
        print(f"[device] K1 bf16 Hq=16 Hkv=2 D=128 S={s}: "
              f"{row['device_ms']:.6f} ms, SDPA {row['library_device_ms']:.6f}"
              f" ms", flush=True)
    print(f"[device] K2 f32->bf16 (2, 128, 128) x2: {k2['device_ms']:.6f} ms, "
          f".to {k2['library_device_ms']:.6f} ms", flush=True)
    k2_share = k2_large["bound_ms"] / k2_large["device_ms"]
    print(f"[device] K2 f32->bf16 {K2_LARGE_SHAPE} x2: "
          f"{k2_large['device_ms']:.6f} ms, .to "
          f"{k2_large['library_device_ms']:.6f} ms (bound "
          f"{k2_large['bound_ms']:.6f} ms, {k2_share:.3f} of it)",
          flush=True)
    for row in k3_rows:
        print(f"[device] K3 f32 {row['shape']}: {row['device_ms']:.6f} ms, "
              f"torch.matmul {row['library_device_ms']:.6f} ms", flush=True)
    for dname, rows in (("bf16", k4_rows), ("f32", k4_f32)):
        for part, row in rows.items():
            print(f"[device] K4 {part} {dname} q (16, 1024, 128) k/v (2, "
                  f"1024, 128): {row['device_ms']:.6f} ms, SDPA "
                  f"{row['library_device_ms']:.6f} ms", flush=True)
    for dname, rows in (("bf16", k4_rows), ("f32", k4_f32)):
        print(f"[device] K4 {dname} backward, dQ + dK/dV (with its "
              f"reduction): "
              f"{rows['dq']['device_ms'] + rows['dkdv']['device_ms']:.6f} ms, "
              f"SDPA's whole backward {rows['dq']['library_device_ms']:.6f} "
              f"ms", flush=True)
    print(f"[device] K5 bf16 xdt (80, 512, 64), B/C (1, 512, 128): "
          f"{k5_row['device_ms']:.6f} ms", flush=True)
    print(f"[device] K1 f32 q {k1_f32['shape'][0]}, k/v "
          f"{k1_f32['shape'][1]}: {k1_f32['device_ms']:.6f} ms, SDPA f32 "
          f"{k1_f32['library_device_ms']:.6f} ms", flush=True)
    print(f"[device] K5 f32 xdt {k5_f32['shape'][0]}, B/C "
          f"{k5_f32['shape'][1]}: {k5_f32['device_ms']:.6f} ms (bound "
          f"{k5_f32['bound_ms']:.6f} ms)", flush=True)

    per_kernel = {key: {path: counts[key] for path, counts in by_path.items()}
                  for key in by_path["model"]}
    launches = {key: sum(n.values()) for key, n in per_kernel.items()}
    for key, count in launches.items():
        if count == 0:
            fail(f"kernel {key} was not launched on the main path")
    print(f"[main path] launches by run: {json.dumps(per_kernel)}", flush=True)

    src = "src/repro_torch/kernels/prefill/csrc/prefill.cu"
    k3_row = k3_rows[0]
    kernels = {"kernels": [
        {"name": "prefill_flash", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/prefill/prefill.py:119",
         "launches": launches["prefill_flash"],
         "launches_by_path": per_kernel["prefill_flash"], "max_abs_err": k1_err,
         "ms": k1_row["ms"], "plain_ms": k1_row["plain_ms"],
         "bound_ms": k1_row["bound_ms"], "bound_by": k1_row["bound_by"],
         "library_ms": k1_row["library_ms"], "device_ms": k1_row["device_ms"],
         "library_device_ms": k1_row["library_device_ms"],
         "build": k1_build["prefill_flash_mma_kernel<128>"], "f32": k1_f32,
         "at_new_groups": k1_groups, "at_remaining_configs": k1_remaining,
         "tensor_parallel": dict(k1_tp, shapes_by_size={
             w: r["k1_shapes"] for w, r in tp_runs.items()}),
         "tensor_parallel_moe": k1_moe,
         "tensor_parallel_seamless": k1_seamless_tp},
        {"name": "cache_cast", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/prefill/prefill.py:145",
         "launches": launches["cache_cast"],
         "launches_by_path": per_kernel["cache_cast"], "max_abs_err": k2_err,
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": "bytes",
         "library_ms": k2["library_ms"], "device_ms": k2["device_ms"],
         "library_device_ms": k2["library_device_ms"], "large": k2_large,
         "build": k2_build["cache_cast_kernel<float, bf16>"]},
        {"name": "matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/matmul/csrc/matmul.cu",
         "replaces": "src/repro/kernels/matmul/matmul.py:66",
         "launches": launches["matmul"],
         "launches_by_path": per_kernel["matmul"],
         "max_abs_err": max(k3_err.values()), "shape": k3_row["shape"],
         "ms": k3_row["ms"], "plain_ms": k3_row["plain_ms"],
         "bound_ms": k3_row["bound_ms"], "bound_by": k3_row["bound_by"],
         "library_ms": k3_row["library_ms"], "device_ms": k3_row["device_ms"],
         "library_device_ms": k3_row["library_device_ms"],
         "at_path_shapes": k3_rows,
         "build": k3_build["matmul_strip_kernel<float>"]},
    ] + [
        {"name": name, "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:108",
         "launches": launches[name], "launches_by_path": per_kernel[name],
         "max_abs_err": k4_err[part], "shape": [[16, TRAIN_SEQ, 128],
                                                [2, TRAIN_SEQ, 128]],
         "ms": k4_rows[part]["ms"], "plain_ms": k4_rows[part]["plain_ms"],
         "bound_ms": k4_rows[part]["bound_ms"],
         "bound_by": k4_rows[part]["bound_by"],
         "library_ms": k4_rows[part]["library_ms"],
         "device_ms": k4_rows[part]["device_ms"],
         "library_device_ms": k4_rows[part]["library_device_ms"],
         "build": k4_rows[part].get("build"), "f32": k4_f32[part],
         "seamless": {key: rows[part] for key, rows in k4_seamless.items()},
         "qwen2vl_train": k4_qwen2vl[part],
         "train_single": {
             model: {route: {k: v for k, v in r.items() if k != "digests"}
                     for route, r in runs.items()}
             for model, runs in train_runs.items()},
         "tensor_parallel": dict(k4_tp[part], shapes_by_size={
             w: r["k4_shapes"] for w, r in tp_runs.items()}),
         "tensor_parallel_moe_f32": k4_moe[part],
         "tensor_parallel_cross": {dname: rows[part] for dname, rows
                                   in k4_cross_tp.items()}}
        for name, part in zip(K4_KERNELS, ("fwd", "dq", "dkdv"), strict=True)
    ] + [
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu",
         "replaces": "src/repro/kernels/mamba_scan/mamba_scan.py:85",
         "launches": launches["ssd_scan"],
         "launches_by_path": per_kernel["ssd_scan"], "max_abs_err": k5_err,
         "shape": [[80, 512, 64], [1, 512, 128]],
         "ms": k5_row["ms"], "plain_ms": k5_row["plain_ms"],
         "bound_ms": k5_row["bound_ms"], "bound_by": k5_row["bound_by"],
         "library_ms": k5_row["library_ms"], "device_ms": k5_row["device_ms"],
         "build": k5_row["build"], "f32": k5_f32, "jamba": k5_jamba,
         "tensor_parallel": dict(k5_tp, shapes_by_size={
             w: r["k5_shapes"] for w, r in tp_runs.items()})},
        {"name": "ssd_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu",
         # The reference's kernel route has no VJP: this is the gradient
         # its plain route's autodiff takes of K5's function.
         "replaces": "src/repro/kernels/mamba_scan/mamba_scan.py:85",
         "launches": launches["ssd_scan_bwd"],
         "launches_by_path": per_kernel["ssd_scan_bwd"],
         "max_abs_err": k5b_err, "shape": k5_bwd["bfloat16"]["shape"],
         "ms": k5_bwd["bfloat16"]["ms"],
         "plain_ms": k5_bwd["bfloat16"]["plain_ms"],
         "bound_ms": k5_bwd["bfloat16"]["bound_ms"],
         "bound_by": k5_bwd["bfloat16"]["bound_by"],
         "library_ms": None,
         "device_ms": k5_bwd["bfloat16"]["device_ms"],
         "kernels": k5_bwd["bfloat16"]["kernels"],
         "device_ms_by_kernel": k5_bwd["bfloat16"]["device_ms_by_kernel"],
         "build": k5_bwd["bfloat16"]["build"], "f32": k5_bwd["float32"],
         "mamba_train": {route: {k: v for k, v in r.items()
                                 if k != "digests"}
                         for route, r in mamba_hdp.items()}},
    ]}
    print(f"[moe-capacity] {card}: " + json.dumps(
        {key: {k: v for k, v in row.items() if k != "capacities"}
         for key, row in capacity_rows.items()}), flush=True)
    print(f"[smoke] {card}: whole run {time.perf_counter() - smoke_t0:.1f} s "
          f"wall, the kernels' build included", flush=True)
    print(f"[card] {card}")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def k4_check_seen(torch, seen, tag: str, prefix: str) -> dict:
    """K4's forward, dQ and dK/dV against their plain version and autograd
    through it on the first inputs of each shape a path gave K4 (a
    ``keep_inputs`` record), at TOL / GRAD_TOL; the largest errors."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    k4_err = {"fwd": 0.0, "dq": 0.0, "dkdv": 0.0}
    for (qs, ks, dt, *_), ((q, k, v), kw) in sorted(seen.items(),
                                                 key=lambda kv: kv[0][0]):
        dname = str(dt)[6:]
        case = (f"K4 on {tag} inputs q {qs} k {ks} "
                f"{'causal' if kw['causal'] else 'full'} {dname}")
        dout = torch.randn(qs, generator=gen, device="cuda",
                           dtype=torch.float32).to(dt)
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        out = fa.flash_attention(*leaves, **kw)
        grads = torch.autograd.grad(out, leaves, dout)
        torch.cuda.synchronize()
        refs = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        ref = flash_attention_ref(*refs, **kw)
        ref_grads = torch.autograd.grad(ref, refs, dout)
        errs = {"fwd": check_close(torch, f"{case} out", out, ref, dname),
                "dq": check_close(torch, f"{case} dq", grads[0],
                                  ref_grads[0], dname, GRAD_TOL),
                "dkdv": max(check_close(torch, f"{case} d{which}", g, r,
                                        dname, GRAD_TOL)
                            for which, g, r in zip("kv", grads[1:],
                                                   ref_grads[1:],
                                                   strict=True))}
        print(f"{prefix}{case}: max abs err out {errs['fwd']:.3e}, dq "
              f"{errs['dq']:.3e}, dk/dv {errs['dkdv']:.3e}", flush=True)
        k4_err = {part: max(k4_err[part], e) for part, e in errs.items()}
    return k4_err


def k1_check_seen(torch, seen, tag: str, prefix: str) -> float:
    """K1 against its plain version on the first inputs of each shape a
    path gave it (a ``keep_inputs`` record); the largest error."""
    from repro_torch.kernels.prefill import prefill as pf
    from repro_torch.kernels.prefill.ref import prefill_ref

    err = 0.0
    for (qs, _, dt), ((q, k, v), kw) in sorted(seen.items(),
                                                key=lambda kv: kv[0][0]):
        name = f"K1 on {tag} inputs q {qs} group {kw['group']} {str(dt)[6:]}"
        out, _, _ = pf.prefill_flash(q, k, v, group=kw["group"])
        torch.cuda.synchronize()
        ref, _, _ = prefill_ref(q, k, v, group=kw["group"])
        e = check_close(torch, name, out, ref, str(dt)[6:])
        err = max(err, e)
        print(f"{prefix}{name}: max abs err {e:.3e}", flush=True)
    return err


def tensor_parallel(torch, card: str, tp_ref: dict, by_path: dict) -> dict:
    """Phase 26 (see the module docstring): the unsharded bf16 runs that
    (d), (f) and (g) are held to, each model whole on the card in turn and
    freed; the ranks of each size in TP_RUNS in processes of their own,
    their checks, (b) against ``tp_ref`` (phase 25's unsharded bf16 loss,
    first decode step's logits and tokens), (d), (f) and (g) against those
    runs, each rank's launches into ``by_path``; then K1 and K4 at model
    2's local heads of Qwen2-1.5B and of Qwen1.5-MoE, and K5 at Mamba2-
    2.7B's, timed.  Returns the runs, the timed rows and the K1/K4/K5
    checks' largest errors."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.mamba_scan import mamba_scan as k5
    from repro_torch.kernels.mamba_scan.ref import ssd_scan_plain
    from repro_torch.kernels.matmul import matmul as mm
    from repro_torch.kernels.prefill import prefill as pf
    from repro_torch.kernels.prefill.ref import prefill_ref
    from repro_torch.models import Model

    dev = torch.device("cuda")
    k1_err = k5_err = 0.0
    k4_err = {"fwd": 0.0, "dq": 0.0, "dkdv": 0.0}
    phase_t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[tensor-parallel] begins with {torch.cuda.memory_allocated() / 1e9:.2f} "
          f"GB allocated in this process", flush=True)
    n_cards = torch.cuda.device_count()
    # The ranks share the card: expandable segments keep each one's cache
    # from holding memory that its next, larger tensors cannot reuse.
    env = dict(os.environ, PYTHONPATH=SRC,
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")

    # The unsharded bf16 runs of (d), (f) and (g), taken first, each model
    # freed before the next and before the ranks start: the MoE whole is
    # 28.6 GB, and the ranks on the card take their shares of it after.
    counters = (pf.LAUNCHES, mm.LAUNCHES, fa.LAUNCHES, k5.LAUNCHES)
    refs = {}
    for key, cfg, lengths, bucket in tp_bf16_cases():
        torch.cuda.reset_peak_memory_stats()
        model = Model(cfg)
        params = model.init(SEED)
        tokens, last = tp_prompts(torch, dev, cfg.vocab_size, lengths, bucket)
        src = (tp_src(torch, dev, cfg, len(lengths)) if cfg.is_enc_dec
               else None)
        for c in counters:
            for name in c:
                c[name] = 0
        steps = TP_DECODE_STEPS
        t0 = time.perf_counter()
        with keep_routes(tokens.numel()) as routes:
            plg, logits, toks = tp_serve(torch, model, params, tokens, last,
                                         src=src, steps=steps)
            torch.cuda.synchronize()
        by_path[f"tp_ref_{key}"] = {name: n for c in counters
                                    for name, n in c.items()}
        refs[key] = {"prefill": plg.cpu(), "logits0": logits[0].cpu(),
                     "tokens": toks, "routes": routes, "rows": tokens.numel(),
                     "layers": cfg.n_layers, "vocab": cfg.vocab_size,
                     "s": time.perf_counter() - t0,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        # The plain route (no kernel) on the same weights: two unsharded
        # bf16 routes' own spread, printed beside the sharded run's.
        with keep_routes(tokens.numel()) as proutes:
            pplg, plogits, ptoks = tp_serve(torch, Model(dataclasses.replace(
                cfg, use_pallas=False)), params, tokens, last, src=src,
                steps=steps)
        refs[key]["plain"] = {"prefill": pplg.cpu(),
                              "logits0": plogits[0].cpu(), "tokens": ptoks,
                              "routes": proutes}
        del pplg, plogits
        print(f"[tensor-parallel] {card}: ({key[0]}) unsharded {cfg.name} "
              f"bf16, {cfg.n_layers} layers: a prefill of {len(lengths)} "
              f"prompt(s) ({list(lengths)} tokens, bucket {bucket}) and "
              f"{steps} decode steps in {refs[key]['s']:.3f} s, peak "
              f"{refs[key]['peak_gb']:.2f} GB; launches "
              f"{json.dumps(by_path[f'tp_ref_{key}'])}", flush=True)
        del model, params, plg, logits, src
        gc.collect()
        torch.cuda.empty_cache()

    def run_ranks(args_of, world: int, timeout: int):
        """``world`` processes of this script, rank r with ``args_of(r,
        port)``; (return codes, outputs)."""
        port = free_port()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__)] + args_of(r, port),
            cwd=HERE, env=env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE) for r in range(world)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout))
        except subprocess.TimeoutExpired:
            outs += [("", "timed out")] * (world - len(outs))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return [p.returncode for p in procs], outs

    tp_runs, transport = {}, {"launches": {}, "ranks": {}}
    d_flops = None
    for world, what in TP_RUNS:
        backend = "nccl" if n_cards >= world else "shared"
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "rank0.pt")
            rcs, outs = run_ranks(lambda r, port: [
                "--tp-rank", str(r), str(world), str(port), backend, what,
                path], world, 900)
            bad = [f"rank {r} exited {rc}: {err[-2000:]}"
                   for r, (rc, (_, err)) in enumerate(zip(rcs, outs,
                                                          strict=True))
                   if rc != 0]
            if bad:
                fail(f"tensor-parallel m={world} ({backend}): "
                     + "\n".join(bad))
            res = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
            saved = torch.load(path)
        for line in outs[0][0].strip().splitlines()[:-1]:
            print(line, flush=True)
        head = res[0]
        for r, rr in enumerate(res):
            for run, counts in rr["launches"].items():
                by_path[f"{run}_r{r}"] = counts
        k1_err = max(k1_err, head["k1_err"])
        for part, e in head["k4_err"].items():
            k4_err[part] = max(k4_err[part], e)
        if "a" in what:
            k4_train = {n: head["launches"][f"tp{world}_f32_a_train"][n]
                        for n in K4_KERNELS}
            want = {n: c * TP_F32_LAYERS // N_LAYERS
                    for n, c in K4_PER_GRAIN.items()}
            if k4_train != want:
                fail(f"tensor-parallel m={world}: K4 launches {k4_train} in "
                     f"(a)'s train step, predicted {want}")
            for run, kernel in (("serve", "prefill_flash"),
                                ("prefill_bf16_cache", "prefill_flash"),
                                ("prefill_bf16_cache", "cache_cast")):
                n = head["launches"][f"tp{world}_f32_{run}"][kernel]
                if n != TP_F32_LAYERS:
                    fail(f"tensor-parallel m={world}: {kernel} {n} launches in "
                         f"(a)'s {run}, expected {TP_F32_LAYERS}")
            print(f"[tensor-parallel] {card}: m={world} over {backend!r}, "
                  f"world size {world}, mesh (1, {world}): (a) f32 "
                  f"qwen2-1.5b cut to {TP_F32_LAYERS} of {N_LAYERS} layers, "
                  f"fsdp_tp: one train step of a (1, {TRAIN_SEQ}) grain, loss "
                  f"{head['a_loss']:.6f} against the unsharded "
                  f"{head['a_loss_unsharded']:.6f}, all {head['leaves']} "
                  f"parameter leaves and both moments within the f32 tolerance; "
                  f"(c) the same under seq_parallel: loss {head['c_loss']:.6f}, "
                  f"the same checks; a prefill of {len(REMAINING_LENGTHS)} "
                  f"prompts and {DECODE_STEPS} decode steps: logits within the "
                  f"f32 tolerance (max abs err {head['f32_logits_err']:.3e}), "
                  f"tokens equal (first "
                  f"{[t[:4] for t in zip(*head['f32_tokens'])]}); the prefill "
                  f"with its cache in bf16 (K2 on the local KV heads): logits "
                  f"within the f32 tolerance (max abs err "
                  f"{head['bf16_cache_logits_err']:.3e}), caches within the "
                  f"bf16 tolerance ({head['bf16_cache_err']:.3e}); K1 at "
                  f"{head['k1_shapes']}, K4 at {head['k4_shapes']}; train step "
                  f"s (a) {head['a_s']:.3f}, (c) {head['c_s']:.3f}", flush=True)
        if "b" in what:
            check_close(torch, f"tensor-parallel m={world} (b) loss",
                        torch.tensor(head["b_loss"]),
                        torch.tensor(tp_ref["loss"]), "bfloat16")
            # At 28 bf16 layers two orders of the same sums already differ
            # past the bf16 tolerance elementwise (the unsharded kernel and
            # plain routes, printed beside it), so the logits are held by
            # their relative Frobenius error, at the bf16 rtol.
            ref = tp_ref["logits0"].cpu()
            lg_b = saved["logits0"]
            rel = float(torch.linalg.vector_norm(lg_b - ref)
                        / torch.linalg.vector_norm(ref))
            if not rel <= TOL["bfloat16"][0]:
                fail(f"tensor-parallel m={world} (b): the first decode "
                     f"step's logits off the unsharded by relative "
                     f"Frobenius error {rel:.3e}")

            def spread(a, b):
                err = (a - b).abs()
                rtol, atol = TOL["bfloat16"]
                return (f"max abs err {float(err.max()):.3e}, "
                        f"{int((err > atol + rtol * b.abs()).sum())} of "
                        f"{b.numel()} outside rtol {rtol} / atol {atol}")

            pairs = [(a, b) for ra, rb in zip(head["b_tokens"],
                                              tp_ref["tokens"], strict=True)
                     for a, b in zip(ra, rb, strict=True)]
            first_diff = next((i for i, (ra, rb) in enumerate(zip(
                head["b_tokens"], tp_ref["tokens"])) if ra != rb), None)
            print(f"[tensor-parallel] {card}: m={world} (b) bf16 "
                  f"qwen2-1.5b whole ({N_LAYERS} layers), fsdp_tp: one "
                  f"train step of phase 11's ({TRAIN_GRAINS}, {TRAIN_SEQ}) "
                  f"batch, loss {head['b_loss']:.6f} against the unsharded "
                  f"{tp_ref['loss']:.6f} (bf16 tolerance); "
                  f"{len(REMAINING_LENGTHS)} prompts and {DECODE_STEPS} "
                  f"decode steps: the first step's logits against the "
                  f"unsharded: relative Frobenius error {rel:.3e} (at most "
                  f"{TOL['bfloat16'][0]}), elementwise "
                  f"{spread(lg_b, ref)}; the unsharded plain route against "
                  f"its kernel route: "
                  f"{spread(tp_ref['logits0_plain'].cpu(), ref)}; tokens: "
                  f"{sum(a == b for a, b in pairs)} of {len(pairs)} equal to "
                  f"the unsharded's, the first difference at decode step "
                  f"{first_diff} (sharded first "
                  f"{[t[:4] for t in zip(*head['b_tokens'])]}, unsharded "
                  f"{[t[:4] for t in zip(*tp_ref['tokens'])]}); train step "
                  f"{head['b_s']:.3f} s, peak {head['b_peak_gb']:.2f} GB a "
                  f"rank, serve {head['b_serve_s']:.3f} s", flush=True)
        k5_err = max([k5_err] + [rr["k5_err"] for rr in res])
        for case in "defghij":
            if case in what:
                tp_case_report(torch, card, world, case, res, saved, refs)
        if "d" in what and world == 2:
            d_flops = [rr["d"]["f32"]["expert_flops"] for rr in res]
        if "j" in what:
            moe_split_flops(card, d_flops,
                            [rr["j"]["f32"]["expert_flops"] for rr in res])
        if backend == "shared":
            transport_report(card, world, res, by_path, transport)
        peaks = [round(rr["peak_gb"], 2) for rr in res]
        print(f"[tensor-parallel] {card}: m={world}: rank seconds "
              f"{[round(rr['s'], 1) for rr in res]}, peaks {peaks} GB "
              f"(torch.cuda.max_memory_allocated a rank)"
              + ("; the ranks share one card, their collectives through "
                 "mailboxes in its memory: these are not a tensor-parallel "
                 "speed" if backend != "nccl" else ""), flush=True)
        tp_runs[world] = {"backend": backend, "what": what,
                          "k1_shapes": head["k1_shapes"],
                          "k4_shapes": head["k4_shapes"],
                          "k5_shapes": head["k5_shapes"],
                          "rank_s": [round(rr["s"], 1) for rr in res],
                          "peaks_gb": [round(rr["peak_gb"], 2) for rr in res]}
    if transport["ranks"]:
        line = transport_kernels(transport)
        print(f"[transport] {card}: " + json.dumps(line), flush=True)
        for row in line["transport_kernels"]:
            if not row["launches"]:
                fail(f"tensor-parallel: {row['name']} was not launched on "
                     f"the sharded runs")
    print(f"[tensor-parallel] ran model sizes "
          f"{[(w, r['backend']) for w, r in tp_runs.items()]}; phase "
          f"{time.perf_counter() - phase_t0:.1f} s", flush=True)

    # K1 and K4 at the tensor-parallel steps' local heads (model 2), timed
    # beside their plain versions, SDPA and the bound (device times in
    # phase 15).
    gen_tp = torch.Generator(device=dev).manual_seed(SEED + 26)

    def rand_tp(shape, dtype):
        return torch.randn(shape, generator=gen_tp, device=dev,
                           dtype=torch.float32).to(dtype)

    def k1_row(hq, hkv, s_tp, dt, d=128):
        q = rand_tp((hq, s_tp, d), dt)
        k, v = rand_tp((hkv, s_tp, d), dt), rand_tp((hkv, s_tp, d), dt)
        row = {"shape": [[hq, s_tp, d], [hkv, s_tp, d]],
               "ms": time_ms(torch, lambda: pf.prefill_flash(
                   q, k, v, group=hq // hkv)),
               "plain_ms": time_ms(torch, lambda: prefill_ref(
                   q, k, v, group=hq // hkv)),
               "library_ms": time_ms(torch, library_attention(torch, q, k,
                                                              v))}
        row["bound_ms"], row["bound_by"] = flash_bound_ms(
            hq, s_tp, d, hkv, q.element_size(), str(dt)[6:])
        return row

    def k4_rows(hq, hkv, s_tp, dt, d=128, skv=None, causal=True):
        skv = skv or s_tp
        q = rand_tp((hq, s_tp, d), dt)
        k, v = rand_tp((hkv, skv, d), dt), rand_tp((hkv, skv, d), dt)
        dout = rand_tp(q.shape, dt)
        kw = {"group": hq // hkv, "causal": causal}
        _, lse, out32 = fa.flash_attention_fwd(q, k, v, **kw)
        _, drow = fa.flash_attention_bwd_dq(q, k, v, out32, lse, dout, **kw)
        plain_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        plain_out = flash_attention_ref(*plain_leaves, **kw)
        lib_leaves = [t[None].clone().requires_grad_(True) for t in (q, k, v)]
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            *lib_leaves, is_causal=causal, enable_gqa=True)
        plain_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
            plain_out, plain_leaves, dout, retain_graph=True))
        lib_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
            lib_out, lib_leaves, dout[None], retain_graph=True))
        rows = {
            "fwd": {"ms": time_ms(torch, lambda: fa.flash_attention_fwd(
                        q, k, v, **kw)),
                    "plain_ms": time_ms(torch, lambda: flash_attention_ref(
                        q, k, v, **kw)),
                    "library_ms": time_ms(
                        torch, library_attention(torch, q, k, v) if causal
                        else lambda: torch.nn.functional.
                        scaled_dot_product_attention(
                            q[None], k[None], v[None], is_causal=False,
                            enable_gqa=True))},
            "dq": {"ms": time_ms(torch, lambda: fa.flash_attention_bwd_dq(
                       q, k, v, out32, lse, dout, **kw)),
                   "plain_ms": plain_bwd_ms, "library_ms": lib_bwd_ms},
            "dkdv": {"ms": time_ms(
                         torch, lambda: fa.flash_attention_bwd_dkdv(
                             q, k, v, lse, dout, drow, **kw)),
                     "plain_ms": plain_bwd_ms, "library_ms": lib_bwd_ms}}
        for part, row in rows.items():
            row["shape"] = [[hq, s_tp, d], [hkv, skv, d]]
            row["causal"] = causal
            row["bound_ms"], row["bound_by"] = k4_bound_ms(
                hq, hkv, s_tp, skv, d, q.element_size(), str(dt)[6:],
                causal, part)
        return rows

    k1_tp = k1_row(*K1_TP_SHAPE, torch.bfloat16)
    k4_tp = k4_rows(*K4_TP_SHAPE, torch.bfloat16)
    print(f"[tensor-parallel] {card}: K1 bf16 at the local heads "
          + json.dumps(k1_tp) + "; K4 bf16 " + json.dumps(k4_tp), flush=True)
    # K1 (bf16, the serve's prefill) and K4 (f32, the train step) at
    # Qwen1.5-MoE's local heads at model 2 (16 heads of 128, one KV head
    # each, split two ways).
    k1_moe = k1_row(*K1_TP_MOE_SHAPE, torch.bfloat16)
    k4_moe = k4_rows(*K4_TP_MOE_SHAPE, torch.float32)
    print(f"[tensor-parallel] {card}: K1 bf16 at Qwen1.5-MoE's local heads "
          + json.dumps(k1_moe) + "; K4 f32 " + json.dumps(k4_moe), flush=True)
    # K5 at Mamba2-2.7B's local heads at model 2 (its 80 heads split two
    # ways), bf16 at (f)'s prompt bucket, with phase 15's input recipe.
    h, g, s5, p5, n5, chunk = K5_TP_SHAPE
    dtv = rand_tp((h, s5), torch.float32).abs() * 0.1 + 0.01
    xdt = (rand_tp((h, s5, p5), torch.float32) * dtv[..., None]).to(
        torch.bfloat16)
    la = dtv * -(rand_tp((h,), torch.float32).abs() + 0.1)[:, None]
    bg, cg = rand_tp((g, s5, n5), torch.bfloat16), rand_tp((g, s5, n5),
                                                           torch.bfloat16)
    bf, cf = (torch.repeat_interleave(t, h // g, 0) for t in (bg, cg))
    k5_tp = {"shape": [[h, s5, p5], [g, s5, n5]], "chunk": chunk,
             "ms": time_ms(torch, lambda: k5.ssd_scan(
                 xdt, la, bg, cg, chunk=chunk, rep=h // g)),
             "plain_ms": time_ms(torch, lambda: ssd_scan_plain(
                 xdt, la, bf, cf, chunk=chunk)),
             "library_ms": None}
    k5_tp["bound_ms"], k5_tp["bound_by"] = k5_bound_ms(
        h, g, s5, p5, n5, chunk, 2, "bfloat16")
    print(f"[tensor-parallel] {card}: K5 bf16 at Mamba2-2.7B's local heads "
          + json.dumps(k5_tp), flush=True)
    del dtv, xdt, la, bg, cg, bf, cf
    # K1 (bf16) at SeamlessM4T's decoder local heads, and K4 (bf16 and f32)
    # at its cross-attention's, non-causal, Sq 64 over Skv 512 (model 2).
    hq, hkv, s1, d1 = K1_TP_SEAMLESS_SHAPE
    k1_seamless = k1_row(hq, hkv, s1, torch.bfloat16, d1)
    h4, sq4, skv4, d4 = K4_TP_SEAMLESS_SHAPE
    k4_cross = {dname: k4_rows(h4, h4, sq4, dt, d4, skv4, causal=False)
                for dname, dt in (("bf16", torch.bfloat16),
                                  ("f32", torch.float32))}
    print(f"[tensor-parallel] {card}: K1 bf16 at SeamlessM4T's decoder local "
          f"heads " + json.dumps(k1_seamless) + "; K4 at its cross-attention's"
          f" local heads " + json.dumps(k4_cross), flush=True)
    return {"runs": tp_runs, "k1": k1_tp, "k4": k4_tp, "k1_moe": k1_moe,
            "k4_moe": k4_moe, "k5": k5_tp, "k1_seamless": k1_seamless,
            "k4_cross": k4_cross, "k1_err": k1_err, "k4_err": k4_err,
            "k5_err": k5_err}


def moe_split_flops(card: str, whole: list, split: list) -> None:
    """Phase 26 (j): each rank's FLOPs in the routed and the shared expert
    products of the f32 prefill (``expert_flops``) at TP_DATA_MESH beside
    those of (d) at (1, 2) on the same prompts; each must be half the
    count of the rank of (d) that holds the same experts."""
    nm = TP_DATA_MESH[1]
    if whole is None:
        fail("tensor-parallel (j): (d) did not run at model 2 before it")
    ratios = [{kind: n / whole[r % nm][kind] for kind, n in got.items()}
              for r, got in enumerate(split)]
    print(f"[tensor-parallel] {card}: (j) the f32 prefill's expert FLOPs a "
          f"rank (FlopCounterMode), routed / shared: at "
          f"{TP_DATA_MESH} {[[c['routed'], c['shared']] for c in split]}, "
          f"(d) at (1, {nm}) {[[c['routed'], c['shared']] for c in whole]}; "
          f"ratios {ratios} (expected 0.5)", flush=True)
    for r, ratio in enumerate(ratios):
        if any(v != 0.5 for v in ratio.values()):
            fail(f"tensor-parallel (j): rank {r}'s expert FLOPs {split[r]}, "
                 f"not half of (d)'s {whole[r % nm]}")


def transport_report(card: str, world: int, res: list, by_path: dict,
                     transport: dict) -> None:
    """Phase 26, each size over the shared backend: each rank's mailbox
    bytes (fails above DEVICE_BYTES_MAX) and per-op counters, the probe's
    line, and the transport kernels' launches over the size's runs into
    ``transport``."""
    from repro_torch.launch import shared_pg

    for r, rr in enumerate(res):
        t = rr["transport"]
        peak = t["mailbox_peak_bytes"]["cuda"]
        if peak > shared_pg.DEVICE_BYTES_MAX:
            fail(f"tensor-parallel m={world} rank {r}: {peak} B of device "
                 f"mailboxes, more than {shared_pg.DEVICE_BYTES_MAX}")
        ops = {op: {"calls": c["calls"], "bytes": c["bytes"],
                    "s": round(c["seconds"], 6), "chunks": c["chunks"]}
               for op, c in sorted(t["ops"].items())}
        print(f"[tensor-parallel] {card}: m={world} rank {r} transport "
              f"'shared': device mailboxes {peak / 2**20:.0f} MiB at most "
              f"(host {t['mailbox_peak_bytes']['cpu'] / 2**20:.0f} MiB); "
              f"per op (calls, bytes in, host s inside, chunks) "
              + json.dumps(ops), flush=True)
        transport["ranks"][(world, r)] = ops
        if "transport_probe" in rr:
            transport.setdefault("probe", rr["transport_probe"])
    for key, counts in by_path.items():
        if key.startswith(f"tp{world}_") and "shared_reduce" in counts:
            for name in shared_pg.LAUNCHES:
                transport["launches"][name] = \
                    transport["launches"].get(name, 0) + counts[name]
    probe = transport.get("probe")
    if world == 4 and probe is not None:
        print(f"[tensor-parallel] {card}: m=4 transport probe: all-gather of "
              f"{probe['bytes_a_rank'] / 1e9:.3f} GB a rank over pairs of "
              f"ranks in {probe['best_s']:.6f} s over 'shared' (best of "
              f"{TRANSPORT_PROBE_REPS}: {probe['s']}), against the staged "
              f"backend's gloo 1.15-1.38 s and pinned copies 0.04-0.07 s "
              f"(NVIDIA H100 80GB HBM3, 700.00 W)",
              flush=True)


def transport_kernels(transport: dict) -> dict:
    """The shared backend's two kernels (not TPU kernels), in the keys of
    the kernels line: launches on phase 26's sharded runs, the probe's
    times and checks at one chunk."""
    probe = transport.get("probe", {})
    rows = []
    for name, part in (("shared_reduce", "reduce"),
                       ("shared_gather", "gather")):
        row = probe.get(part, {})
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/launch/csrc/shared_pg.cu",
            "replaces": "none: not a TPU kernel (the transport between "
                        "ranks that share the card)",
            "launches": transport["launches"].get(name, 0),
            "max_abs_err": row.get("max_abs_err"), "ms": row.get("ms"),
            "plain_ms": row.get("plain_ms"), "bound_ms": row.get("bound_ms"),
            "bound_by": "bytes", "library_ms": row.get("library_ms"),
            "bytes": row.get("bytes")})
    return {"transport_kernels": rows}


def tp_bf16_cases():
    """Phase 26's bf16 cases that the main process holds to an unsharded
    run: (key, config, prompt lengths, bucket)."""
    sys.path.insert(0, SRC)
    from repro_torch.configs import get_config

    return (("d_bf16", get_config("qwen2-moe-a2.7b"), REMAINING_LENGTHS, 512),
            ("f_bf16", get_config("mamba2-2.7b",
                                  n_layers=TP_MAMBA_BF16_LAYERS),
             (TP_MAMBA_PROMPT,), TP_MAMBA_BUCKET),
            ("g_bf16", get_config("jamba-v0.1-52b", n_layers=8),
             REMAINING_LENGTHS, 512),
            ("i_bf16", get_config("seamless-m4t-medium"), REMAINING_LENGTHS,
             512))


def tp_case_report(torch, card: str, world: int, case: str, res: list,
                   saved: dict, refs: dict) -> None:
    """Phase 26's case (d)-(j) at world size ``world``: its bf16 run (rank
    0's, in ``saved``) against the unsharded run in ``refs`` ((j) against
    (d)'s), the prefill's and the first decode step's logits by relative
    Frobenius error, (f) and (i) at the bf16 rtol (as (b)) with the first
    step's tokens among the unsharded step's TP_TOP_TOKENS most likely,
    (d), (g) and (j) within TP_BF16_LIMIT with the first MoE layer's
    routing held (TP_ROUTE_FLIPS); the f32 checks' errors rank 0 took;
    each rank's seconds and peaks."""
    label = {"d": "Qwen1.5-MoE, expert-parallel", "e": "Qwen1.5-MoE, "
             "expert-TP", "f": "Mamba2-2.7B, split heads",
             "g": "Jamba-v0.1 cut to one period, every layer split",
             "h": "DeepSeek-V2, MLA split heads and the latent cache's "
                  "sequence (MoE expert-parallel)",
             "i": "SeamlessM4T-medium, cross-attention split heads and the "
                  "cross cache's sequence",
             "j": f"Qwen1.5-MoE on a (data, model) {TP_DATA_MESH} mesh, "
                  f"expert-parallel, each data rank half of every expert's "
                  f"capacity slots"}[case]
    head = res[0][case]
    parts = []
    if "bf16" in head:
        key = f"{case}_bf16"
        # (j) is held to (d)'s unsharded run: the same model and prompts.
        got, ref = saved[key], refs["d_bf16" if case == "j" else key]
        limit = TOL["bfloat16"][0] if case in "fi" else TP_BF16_LIMIT

        def rel(a, b):
            return float(torch.linalg.vector_norm(a - b)
                         / torch.linalg.vector_norm(b))

        def same(a, b):
            # (j) may decode fewer steps than the run it is held to.
            b = b[:len(a)]
            pairs = [(x, y) for ra, rb in zip(a, b, strict=True)
                     for x, y in zip(ra, rb, strict=True)]
            return f"{sum(x == y for x, y in pairs)} of {len(pairs)}"

        # The vocabulary's logits (the padded rows' -1e30 would swamp the
        # norm).
        v = ref["vocab"]
        rels = {name: rel(got[name][..., :v], ref[name][..., :v])
                for name in ("prefill", "logits0")}
        plain = {name: rel(ref["plain"][name][..., :v], ref[name][..., :v])
                 for name in ("prefill", "logits0")}
        flips = route_flips(got["routes"], ref["routes"])
        routing = (
            f"; tokens (of {ref['rows']}) whose top-k experts differ from "
            f"the unsharded's, by MoE layer of the prefill: {flips} (the "
            f"plain route's {route_flips(ref['plain']['routes'], ref['routes'])}"
            f"; the first layer's at most {TP_ROUTE_FLIPS:.0%})"
            if flips else "")
        b = head["bf16"]
        parts.append(
            f"bf16, {ref['layers']} layers: local {json.dumps(b['local'])}; "
            f"against the unsharded, relative Frobenius error: the prefill's "
            f"logits {rels['prefill']:.3e}, the first decode step's "
            f"{rels['logits0']:.3e} (at most {limit}; the unsharded plain "
            f"route against its kernel route: {plain['prefill']:.3e}, "
            f"{plain['logits0']:.3e}){routing}; "
            f"tokens {same(got['tokens'], ref['tokens'])} equal to the "
            f"unsharded's (the plain route's "
            f"{same(ref['plain']['tokens'], ref['tokens'])}; sharded first "
            f"{[t[:4] for t in zip(*got['tokens'])]}); staggered init "
            f"{b['init_s']:.1f} s, serve {b['serve_s']:.3f} s (the unsharded "
            f"{ref['s']:.3f} s), serve peaks "
            f"{[round(r[case]['bf16']['serve_peak_gb'], 2) for r in res]} GB "
            f"a rank (the unsharded {ref['peak_gb']:.2f})")
    if "f32" in head:
        f = head["f32"]
        router = (f"; the router's leaf {f['router_err']['parameter']:.3e}, "
                  f"its moments {f['router_err']['first moment']:.3e} / "
                  f"{f['router_err']['second moment']:.3e}"
                  if f.get("router_err") else "")
        parts.append(
            f"f32: local {json.dumps(f['local'])}; a prefill and "
            f"{TP_DECODE_STEPS} decode steps: logits within the f32 tolerance "
            f"(prefill {f['prefill_err']:.3e}, decode {f['logits_err']:.3e}), "
            f"tokens equal; one train step of {f['train_batch']}: loss "
            f"{f['loss']:.6f} against the unsharded {f['loss_unsharded']:.6f}"
            f", all {f['leaves']} parameter leaves and both moments within the "
            f"f32 tolerance (max abs err {f['max_err']:.3e}){router}; "
            f"caches gathered over model in the sharded decode "
            f"{f['cache_gathers']}; serve "
            f"{f['serve_s']:.3f} s, train step {f['train_s']:.3f} s; peaks "
            f"serve {[round(r[case]['f32']['serve_peak_gb'], 2) for r in res]}"
            f", train {[round(r[case]['f32']['train_peak_gb'], 2) for r in res]}"
            f" GB a rank")
    print(f"[tensor-parallel] {card}: m={world} ({case}) {label}: "
          + "; ".join(parts) + f"; {head['s']:.1f} s", flush=True)
    if "bf16" in head:
        for name, r in rels.items():
            if not r <= limit:
                fail(f"tensor-parallel m={world} ({case}): the {name} logits "
                     f"off the unsharded by relative Frobenius error {r:.3e}, "
                     f"past {limit}")
        top = ref["logits0"][..., :v].topk(TP_TOP_TOKENS, dim=-1).indices
        if case in "fi" and not all(t in row for t, row in zip(
                got["tokens"][0], top.tolist(), strict=True)):
            fail(f"tensor-parallel m={world} ({case}): the first decode step's "
                 f"tokens {got['tokens'][0]}, not all among the unsharded "
                 f"step's {TP_TOP_TOKENS} most likely {top.tolist()}")
        if flips and not flips[0] <= TP_ROUTE_FLIPS * ref["rows"]:
            fail(f"tensor-parallel m={world} ({case}): {flips[0]} of "
                 f"{ref['rows']} tokens routed to other experts than the "
                 f"unsharded's at the first MoE layer")


def k5_check_seen(torch, seen, tag: str, prefix: str) -> float:
    """K5 against its plain version on the first inputs of each shape a
    path gave it (a ``keep_inputs`` record); the largest error."""
    from repro_torch.kernels.mamba_scan import mamba_scan as k5
    from repro_torch.kernels.mamba_scan.ref import ssd_scan_plain

    err = 0.0
    for (xs, _, dt), ((xdt, la, bg, cg), kw) in sorted(
            seen.items(), key=lambda kv: kv[0][0]):
        name = (f"K5 on {tag} inputs xdt {xs} {str(dt)[6:]} chunk "
                f"{kw['chunk']}")
        y, hf = k5.ssd_scan(xdt, la, bg, cg, **kw)
        torch.cuda.synchronize()
        ry, rh = ssd_scan_plain(
            xdt, la, torch.repeat_interleave(bg, kw["rep"], 0),
            torch.repeat_interleave(cg, kw["rep"], 0), chunk=kw["chunk"])
        e = max(check_close(torch, f"{name} y", y, ry, str(dt)[6:]),
                check_close(torch, f"{name} state", hf, rh, str(dt)[6:]))
        err = max(err, e)
        print(f"{prefix}{name}: max abs err {e:.3e}", flush=True)
    return err


def tp_prompts(torch, dev, vocab: int, lengths, bucket: int):
    """Seeded prompts of ``lengths`` tokens, zero-padded into one (n,
    ``bucket``) batch, and each prompt's last index."""
    import numpy as np

    prng = np.random.default_rng(SEED)
    tokens = torch.zeros((len(lengths), bucket), dtype=torch.int32,
                         device=dev)
    for i, n in enumerate(lengths):
        tokens[i, :n] = torch.as_tensor(prng.integers(0, vocab, n),
                                        dtype=torch.int32, device=dev)
    return tokens, torch.as_tensor([n - 1 for n in lengths], device=dev)


def tp_src(torch, dev, cfg, n: int):
    """Seeded source frames for ``n`` prompts of an enc-dec model: (n,
    SEAMLESS_FRAMES, d) in its compute dtype."""
    import numpy as np

    return torch.as_tensor(np.random.default_rng(SEED + 1).standard_normal(
        (n, SEAMLESS_FRAMES, cfg.d_model)), device=dev).to(
        getattr(torch, cfg.compute_dtype))


def tp_serve(torch, model, params, tokens, last, mesh=None, policy=None,
             src=None, steps: int = DECODE_STEPS):
    """A prefill of ``tokens``, then ``steps`` greedy decode steps in a
    cache twice the bucket, each row from its prompt's last token; sharded
    over ``mesh`` when ``policy`` is given.  An enc-dec model encodes
    ``src`` in the prefill, and decodes over a cross cache of its length.
    Returns the prefill's logits (its last position), each step's logits
    (f32) and each step's tokens."""
    from repro_torch.sharding.apply import (
        distribute_tree,
        full_tree,
        make_sharded_decode_step,
        make_sharded_prefill_step,
    )
    from repro_torch.train import make_decode_step, make_prefill_step
    from repro_torch.tree import tree_leaves

    n, bucket = tokens.shape
    pbatch = ({"tokens": tokens} if src is None else
              {"src_embeds": src, "tgt_tokens": tokens})
    if policy is None:
        plg, caches = make_prefill_step(model)(params, pbatch)
    else:
        plg, caches = make_sharded_prefill_step(model, mesh)(
            params, distribute_tree(pbatch, policy.batch_specs(pbatch), mesh))
        plg, caches = plg.full_tensor(), full_tree(caches)
    big = model.init_cache(n, 2 * bucket,
                           cross_seq=None if src is None else src.shape[1])
    for b_leaf, s_leaf in zip(tree_leaves(big), tree_leaves(caches),
                              strict=True):
        # An attention or latent cache grows on the sequence (its first
        # dimension that differs); a Mamba layer's conv window and state
        # and a cross cache keep their shapes.
        dim = next((i for i, (x, y) in enumerate(zip(b_leaf.shape,
                                                     s_leaf.shape))
                    if x != y), None)
        (b_leaf if dim is None else b_leaf.narrow(dim, 0, bucket)).copy_(
            s_leaf)
    del caches
    if policy is None:
        step = make_decode_step(model)
    else:
        big = distribute_tree(big, policy.cache_specs(big), mesh)
        step = make_sharded_decode_step(model, mesh)
    logits, toks = [], []
    inp = tokens[torch.arange(n, device=tokens.device), last][:, None]
    for i in range(steps):
        pos = (last + i).to(torch.int32)
        if policy is None:
            lg, big = step(params, big, inp, pos)
        else:
            lg, big = step(params, big, distribute_tree(
                inp, policy.batch_specs(inp), mesh), distribute_tree(
                pos, policy.batch_specs(pos), mesh))
            lg = lg.full_tensor()
        logits.append(lg[:, 0].float())
        inp = lg[:, 0, :model.cfg.vocab_size].argmax(-1, keepdim=True).to(
            torch.int32)
        toks.append(inp[:, 0].tolist())
    return plg[:, -1].float(), logits, toks


def own_shards(tree):
    """``tree``'s DTensors, each local shard in storage of its own:
    ``distribute_tree`` cuts a shard of the first dimension as a view,
    which keeps the whole tensor alive, and ranks that share one card
    cannot each keep a whole model."""
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import tree_map

    def own(d):
        local = d.to_local()
        if local.untyped_storage().nbytes() == \
                local.numel() * local.element_size():
            return d
        return DTensor.from_local(local.clone(), d.device_mesh, d.placements,
                                  run_check=False, shape=d.shape,
                                  stride=d.stride())

    return tree_map(own, tree)


#: Phase 26's transport probe: the staged backend's timed all-gather, 128 Mi
#: f32 (0.54 GB) a rank over pairs of ranks at world 4; best of
#: TRANSPORT_PROBE_REPS.
TRANSPORT_PROBE_ELEMS = 128 * 2**20
TRANSPORT_PROBE_REPS = 3


def shared_probe(torch, dist, rank: int, world: int, tag: str) -> dict:
    """Phase 26 before (d): the all-gather timed over the staged backend
    (gloo 1.15-1.38 s, pinned copies 0.04-0.07 s on an NVIDIA H100 80GB
    HBM3 at 700 W), over the shared
    backend, each half checked against its rank's seeded input; then, on
    rank 0 while the others wait, ``shared_reduce_kernel`` (4 slots) and
    ``shared_gather_kernel`` (4 segments) at the probe's chunk of one slot,
    each against its plain version, timed beside one PyTorch call for the
    same function and the bound (bytes over HBM_BYTES_PER_S)."""
    from repro_torch.launch import shared_pg

    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    group = pairs[rank // 2]
    n = TRANSPORT_PROBE_ELEMS

    def seeded(r):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 2600 + r)
        return torch.randn(n, generator=gen, device="cuda")

    x = seeded(rank)
    y = torch.empty(2 * n, device="cuda")
    secs = []
    for _ in range(TRANSPORT_PROBE_REPS):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        dist.all_gather_into_tensor(y, x, group=group)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    first = rank // 2 * 2
    if not all(torch.equal(y[i * n:(i + 1) * n], seeded(first + i))
               for i in range(2)):
        fail(f"{tag} the probe's all-gather differs from the ranks' inputs")
    chunks = -(-x.numel() * x.element_size() // shared_pg.SLOT_BYTES)
    del x, y
    dist.destroy_process_group(group)
    res = {"bytes_a_rank": n * 4, "s": secs, "best_s": min(secs),
           "chunks": chunks}
    if rank == 0:
        count = shared_pg.SLOT_BYTES // 4
        gen = torch.Generator(device="cuda").manual_seed(SEED + 2610)
        rows = torch.randn(4, count, generator=gen, device="cuda")
        slots = list(rows)
        out = torch.empty(count, device="cuda")
        shared_pg.shared_reduce(slots, out, "sum")
        want = shared_pg.reduce_plain(slots, "sum")
        torch.cuda.synchronize()
        nbytes = 5 * shared_pg.SLOT_BYTES
        res["reduce"] = {
            "n": 4, "count": count, "dtype": "float32",
            "bitwise": bool(torch.equal(out, want)),
            "max_abs_err": float((out - want).abs().max()),
            "ms": time_ms(torch, lambda: shared_pg.shared_reduce(
                slots, out, "sum")),
            "plain_ms": time_ms(torch, lambda: shared_pg.reduce_plain(
                slots, "sum")),
            "library_ms": time_ms(torch, lambda: torch.sum(rows, 0)),
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}
        segs = [r.view(torch.uint8) for r in rows]
        whole = torch.empty(4 * shared_pg.SLOT_BYTES, dtype=torch.uint8,
                            device="cuda")
        dsts = list(whole.chunk(4))
        shared_pg.shared_gather(segs, dsts)
        torch.cuda.synchronize()
        ok = bool(torch.equal(whole, rows.view(torch.uint8).reshape(-1)))
        nbytes = 2 * 4 * shared_pg.SLOT_BYTES
        res["gather"] = {
            "segments": 4, "bytes_a_segment": shared_pg.SLOT_BYTES,
            "bitwise": ok, "max_abs_err": 0.0 if ok else float("inf"),
            "ms": time_ms(torch, lambda: shared_pg.shared_gather(segs, dsts)),
            "plain_ms": time_ms(torch, lambda: shared_pg.gather_plain(
                segs, dsts)),
            "library_ms": time_ms(torch, lambda: torch.cat(segs, out=whole)),
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}
        for name in ("reduce", "gather"):
            if not res[name]["bitwise"]:
                fail(f"{tag} shared_{name}_kernel differs from its plain "
                     f"version: {res[name]}")
        del rows, out, want, whole, segs, dsts, slots
        torch.cuda.empty_cache()
        print(f"{tag} transport probe: an all-gather of "
              f"{n * 4 / 1e9:.3f} GB a rank over pairs of ranks (staged: "
              f"gloo 1.15-1.38 s, pinned copies 0.04-0.07 s) over 'shared' "
              f"in {min(secs):.6f} s (best of "
              f"{TRANSPORT_PROBE_REPS}: {[round(t, 6) for t in secs]}), "
              f"{chunks} chunks of {shared_pg.SLOT_BYTES} B; at one chunk: "
              f"shared_reduce_kernel (4 slots, f32) {res['reduce']['ms']:.6f}"
              f" ms (plain {res['reduce']['plain_ms']:.6f}, torch.sum "
              f"{res['reduce']['library_ms']:.6f}, bound "
              f"{res['reduce']['bound_ms']:.6f}), shared_gather_kernel (4 "
              f"segments) {res['gather']['ms']:.6f} ms (plain "
              f"{res['gather']['plain_ms']:.6f}, torch.cat "
              f"{res['gather']['library_ms']:.6f}, bound "
              f"{res['gather']['bound_ms']:.6f}); both bitwise their plain "
              f"versions", flush=True)
    dist.barrier()
    return res


def run_tp_rank(rank: int, world: int, port: int, backend: str, what: str,
                out_path: str) -> int:
    """One rank of phase 26: the sharded steps (``sharding/apply.py``),
    tensor-parallel over a (1, ``world``) mesh on the card, ``backend``
    between the ranks.  (a) f32 Qwen2-1.5B cut to TP_F32_LAYERS layers,
    ``fsdp_tp``: one train step of phase 11's f32 grain, (c) the same step
    under ``seq_parallel``, a prefill of four prompts and DECODE_STEPS
    decode steps, and the prefill again with its cache stored in bf16 (K2
    on the local KV heads); rank 0 then runs the unsharded steps from the
    same init and holds every loss, parameter leaf, moment and logit within
    the f32 tolerance, tokens equal, the bf16 caches within the bf16
    tolerance.  (b) the whole model in bf16: one train step of phase 11's
    (8, 1024) batch, four prompts and DECODE_STEPS decode steps.  (d)-(g)
    the MoE and Mamba cases (``moe_mamba``).  ``what`` holds the letters of
    the cases to run (TP_RUNS).  Rank 0 saves the bf16 runs' logits and
    tokens to ``out_path`` for the main process, which holds them against
    the unsharded runs.  Then K1 and K4 (rank 0) and K5 (every rank)
    against their plain versions on the inputs the sharded runs gave them.
    Its last line: the launches of each run and the checks' largest
    errors."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import (
        DTensor,
        Replicate,
        Shard,
        distribute_tensor,
    )

    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(rank % torch.cuda.device_count())
    if backend == "shared":
        from repro_torch.launch import shared_pg
        shared_pg.register()
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    from repro_torch.configs import get_config
    from repro_torch.data import GrainSpec, SyntheticSource, batch_from_grains
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.mamba_scan import mamba_scan as k5
    from repro_torch.kernels.mamba_scan import ops as mamba_ops
    from repro_torch.kernels.matmul import matmul as mm
    from repro_torch.kernels.prefill import ops
    from repro_torch.kernels.prefill import prefill as pf
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import Model
    from repro_torch.models.config import EncoderConfig
    from repro_torch.sharding import Policy
    from repro_torch.sharding import apply as sharding_apply
    from repro_torch.sharding.apply import (
        distribute_tree,
        full_tree,
        make_sharded_prefill_step,
        make_sharded_train_step,
    )
    from repro_torch.optim.adamw import AdamWConfig, adamw_update, global_norm
    from repro_torch.train import (
        TrainState,
        init_train_state,
        make_grain_grad_fn,
        make_prefill_step,
        make_train_step,
    )
    from repro_torch.sharding.policy import is_spec, to_placements
    from repro_torch.tree import (
        tree_flatten,
        tree_leaves,
        tree_map,
        tree_paths,
        tree_unflatten,
    )

    dev = torch.device("cuda")
    tag = f"[tensor-parallel m={world} rank {rank}]"
    mesh = make_debug_mesh(1, world, device_type="cuda")
    counters = (pf.LAUNCHES, mm.LAUNCHES, fa.LAUNCHES, k5.LAUNCHES)
    if backend == "shared":
        # The transport's kernels, counted over each run as the model's.
        counters += (shared_pg.LAUNCHES,)
    launches: dict[str, dict[str, int]] = {}

    def zero_counts() -> None:
        for c in counters:
            for key in c:
                c[key] = 0

    def read_counts(path: str) -> dict[str, int]:
        launches[path] = {key: n for c in counters for key, n in c.items()}
        return launches[path]

    def grain_batch(cfg, grains):
        spec = GrainSpec(1, TRAIN_SEQ, cfg.vocab_size)
        return batch_from_grains(SyntheticSource(spec, seed=SEED), 0, grains,
                                 spec, device=dev)

    def sharded_state(model, policy):
        st = init_train_state(model.init(SEED))
        return TrainState(
            params=distribute_tree(st.params, policy.param_specs(st.params),
                                   mesh),
            opt=distribute_tree(st.opt, policy.opt_specs(st.params), mesh))

    tokens, last = tp_prompts(torch, dev, get_config("qwen2-1.5b").vocab_size,
                              REMAINING_LENGTHS, 512)

    def serve(model, params, policy):
        """A prefill of the four prompts, then DECODE_STEPS greedy steps in
        a cache twice the bucket: sharded when ``policy`` is given."""
        return tp_serve(torch, model, params, tokens, last,
                        None if policy is None else mesh, policy)[1:]

    out: dict = {"rank": rank, "world": world, "backend": backend}
    seen1, seen4, seen5 = {}, {}, {}
    saved: dict = {}          # rank 0's bf16 results, for the main process
    t_phase = time.perf_counter()

    def staggered(fn):
        """``fn()`` on one rank at a time, a barrier after each: the ranks
        share one card and must not each hold a whole model at once."""
        res = None
        gc.collect()
        torch.cuda.empty_cache()
        for r in range(world):
            if r == rank:
                res = fn()
                gc.collect()
                torch.cuda.empty_cache()
            dist.barrier()
        return res

    def shards(model, policy, park: int = 0):
        """This rank's shards of the model's seeded init (one rank at a
        time where the ranks' whole models together would pass
        TP_STAGGER_BYTES), and the seconds the ranks took.  Each whole
        leaf is freed as soon as its shard is cut: a rank holds the
        whole model and one leaf's shard at most.  ``park``: the first
        ``park`` ranks keep their shards in host memory until every rank
        has cut its own, so that the last rank's whole model meets fewer
        shards on the card (replicas over a data axis hold too much for
        it to meet them all)."""
        meta = model.abstract_params()
        specs = tree_flatten(policy.param_specs(meta), is_leaf=is_spec)[0]
        parked = rank < park
        cudart = torch.cuda.cudart() if parked else None

        def init():
            leaves, treedef = tree_flatten(model.init(SEED))
            out = []
            for i, spec in enumerate(specs):
                leaf, leaves[i] = leaves[i], None
                d = own_shards(distribute_tensor(
                    leaf, mesh, to_placements(spec, mesh),
                    src_data_rank=None))
                if parked:
                    # Page-locked while parked (registered, not the
                    # caching host allocator's: it is released after).
                    local = d.to_local()
                    host = torch.empty(local.shape, dtype=local.dtype)
                    if host.numel():
                        cudart.cudaHostRegister(
                            host.data_ptr(),
                            host.numel() * host.element_size(), 0)
                    d = (host.copy_(local), d.placements, d.shape,
                         d.stride())
                out.append(d)
                del leaf, d
            return treedef, out

        whole = sum(t.numel() * t.element_size() for t in tree_leaves(meta))
        t0 = time.perf_counter()
        treedef, out = (staggered(init) if world * whole > TP_STAGGER_BYTES
                        else init())
        if parked:
            hosts, out = out, []
            for host, pl, shape, stride in hosts:
                out.append(DTensor.from_local(
                    host.to(dev), mesh, pl, run_check=False, shape=shape,
                    stride=stride))
                if host.numel():
                    cudart.cudaHostUnregister(host.data_ptr())
            del hosts
        return tree_unflatten(treedef, out), time.perf_counter() - t0

    def split_shapes(cfg, sp) -> dict:
        """Each split layer's local key leaves: an MoE layer's experts (or
        their width), a Mamba layer's heads, an MLA layer's (the prefix
        layer's too) and a cross-attention layer's heads, for the checks
        and the report; fails where one is not split over ``model``."""
        got = {}
        nm = mesh.size(1)
        layers = [(f"prefix{i}", layer, 0) for i, layer in
                  enumerate(sp["stack"].get("prefix", ()))]
        layers += [(key, layer, 1)
                   for key, layer in sp["stack"]["periods"].items()]
        for key, layer, lead in layers:
            for kind, leaf in (("mla", "wuq"), ("cross", "wq")):
                if kind in layer:
                    shp = list(layer[kind][leaf].to_local().shape[lead:])
                    if shp[1] * nm != cfg.n_q_heads:
                        fail(f"{tag} {key} {kind} heads {shp}, not split")
                    got[f"{key}.{kind}.{leaf}"] = shp
            if lead == 0:
                continue
            if "moe" in layer:
                w_gate = layer["moe"]["w_gate"]
                shp = list(w_gate.to_local().shape[1:])
                e, f = cfg.moe.n_routed, cfg.moe.d_expert
                # ``fsdp_tp`` on a data axis of more than one rank stores
                # ``d_model`` split over it too.
                d = cfg.d_model // (mesh.size(0) if isinstance(
                    w_gate.placements[0], Shard) else 1)
                want = ([e // nm, d, f] if e % nm == 0
                        else [e, d, f // nm])
                if shp != want:
                    fail(f"{tag} {key} experts {shp}, expected {want}")
                got[f"{key}.moe.w_gate"] = shp
            if "mamba" in layer:
                shp = list(layer["mamba"]["wdt"].to_local().shape[1:])
                if shp[1] * nm != cfg.ssm.n_heads(cfg.d_model):
                    fail(f"{tag} {key} Mamba heads {shp}, not split")
                got[f"{key}.mamba.wdt"] = shp
        return got

    def want_launches(counts: dict, want: dict, what_run: str) -> None:
        got = {key: counts[key] for key in want}
        if got != want:
            fail(f"{tag} {what_run}: launches {got}, expected {want}")

    def serve_case(key: str, cfg, tokens, last, want: dict, src=None,
                   gathers=None, flops: bool = False,
                   steps: int = TP_DECODE_STEPS, park: int = 0) -> dict:
        """``cfg``'s model sharded: a prefill (of an enc-dec model, over
        ``src``) and ``steps`` decode steps, the caches a decode step
        gathers over ``model`` counted (``gathers``: the count required;
        ``flops``: the prefill's expert products' FLOPs, ``expert_flops``;
        ``park``: ``shards``').
        In f32 rank 0 then holds the prefill's and every step's logits
        within the f32 tolerance of the unsharded run, tokens equal; in
        bf16 it keeps them for the main process, which holds them against
        the unsharded run it took first."""
        model, policy = Model(cfg), Policy(cfg, mesh)
        sp, init_s = shards(model, policy, park)
        res = {"init_s": init_s, "local": split_shapes(cfg, sp)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        views, real_view = [0], sharding_apply._cache_view

        def counted_view(*a, **k):
            views[0] += 1
            return real_view(*a, **k)

        sharding_apply._cache_view = counted_view
        try:
            with keep_inputs(ops, "_prefill_call") as s1, \
                    keep_inputs(flash_ops, "_flash_call") as s4, \
                    keep_inputs(mamba_ops, "_ssd_kernel_call") as s5, \
                    keep_routes(tokens.numel()) as routes, \
                    (expert_flops() if flops else contextlib.nullcontext(
                        )) as counted:
                t0 = time.perf_counter()
                plg, logits, toks = tp_serve(
                    torch, model, sp, tokens, last, mesh, policy, src,
                    steps)
                torch.cuda.synchronize()
                res["serve_s"] = time.perf_counter() - t0
        finally:
            sharding_apply._cache_view = real_view
        if flops:
            res["expert_flops"] = counted
        res["serve_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        res["cache_gathers"] = views[0]
        if gathers is not None and views[0] != gathers:
            fail(f"{tag} ({key}): the sharded decode gathered {views[0]} "
                 f"caches over model, expected {gathers}")
        want_launches(read_counts(f"tp{world}_{key}_serve"), want,
                      f"({key}) serve")
        seen1.update(s1)
        seen4.update(s4)
        seen5.update(s5)
        res["tokens"] = toks
        del sp
        gc.collect()
        torch.cuda.empty_cache()
        if cfg.param_dtype != "float32":
            if rank == 0:
                saved[key] = {"prefill": plg.cpu(), "logits0": logits[0].cpu(),
                              "tokens": toks, "routes": routes}
        elif rank == 0:
            t0 = time.perf_counter()
            zero_counts()
            params = model.init(SEED)
            uplg, ulogits, utoks = tp_serve(torch, model, params, tokens,
                                            last, src=src, steps=steps)
            res["serve_check_s"] = time.perf_counter() - t0
            read_counts(f"tp{world}_{key}_unsharded_serve")
            res["prefill_err"] = check_close(
                torch, f"{tag} ({key}) prefill logits", plg, uplg, "float32")
            res["logits_err"] = max(
                check_close(torch, f"{tag} ({key}) decode step {i} logits",
                            g, r, "float32")
                for i, (g, r) in enumerate(zip(logits, ulogits, strict=True)))
            if toks != utoks:
                fail(f"{tag} ({key}): sharded tokens {toks} differ from the "
                     f"unsharded {utoks}")
            del params
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
        return res

    def train_case(key: str, cfg, want: dict, batch=None) -> dict:
        """One sharded train step of ``cfg``'s model on phase 11's f32
        grain; rank 0 keeps every leaf of the new parameters and moments on
        the host, then runs the unsharded step from the same init (the
        other ranks have freed theirs) and holds the loss, every leaf and
        both moments within the f32 tolerance, the router's among them."""
        model, policy = Model(cfg), Policy(cfg, mesh)
        sp, init_s = shards(model, policy)
        opt = {"m": tree_map(lambda d: torch.zeros_like(
                   d, dtype=torch.float32), sp),
               "v": tree_map(lambda d: torch.zeros_like(
                   d, dtype=torch.float32), sp),
               "step": distribute_tensor(
                   torch.zeros((), dtype=torch.int32, device=dev), mesh,
                   [Replicate()] * mesh.ndim, src_data_rank=None)}
        state = TrainState(params=sp, opt=opt)
        del sp, opt
        if batch is None:
            batch = grain_batch(cfg, [0])
        sbatch = distribute_tree(batch, policy.batch_specs(batch), mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        with keep_inputs(flash_ops, "_flash_call") as s4:
            t0 = time.perf_counter()
            state, met = make_sharded_train_step(model, mesh)(state, sbatch)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
        res = {"train_init_s": init_s, "train_s": train_s,
               "train_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "loss": float(met["loss"]),
               "train_batch": (
                   f"{batch['targets'].shape[1]} target tokens over "
                   f"{batch['src_embeds'].shape[1]} frames"
                   if "src_embeds" in batch else
                   f"a {tuple(batch['targets'].shape)} grain")}
        want_launches(read_counts(f"tp{world}_{key}_train"), want,
                      f"({key}) train")
        seen4.update(s4)
        names = ("parameter", "first moment", "second moment")
        trees = (state.params, state.opt["m"], state.opt["v"])
        t0 = time.perf_counter()
        host = {n: [d.to_local().cpu() for d in tree_leaves(tree)]
                for n, tree in zip(names, trees, strict=True)}
        placements = [d.placements for d in tree_leaves(state.params)]
        del state, trees
        gc.collect()
        torch.cuda.empty_cache()
        res["copy_s"] = time.perf_counter() - t0

        def own(t, pl):
            """This rank's chunk of the whole ``t`` at placements ``pl``."""
            coord = mesh.get_coordinate()
            for i, p in enumerate(pl):
                if isinstance(p, Shard):
                    t = t.chunk(mesh.size(i), p.dim)[coord[i]]
            return t

        def check() -> None:
            # The unsharded step as ``make_train_step`` takes it (the loss
            # gradient, then ``adamw_update``), its update leaf by leaf (the
            # whole update of the f32 MoE cut holds the parameters, the
            # gradients, both moments and the new parameters at once, 58
            # GB), each leaf's new value, moments included, held against
            # this rank's shard of it.
            params = model.init(SEED)
            paths = tree_paths(params)
            zero_counts()
            (_, umet), grads = make_grain_grad_fn(model)(params, batch)
            read_counts(f"tp{world}_{key}_unsharded_train")
            check_close(torch, f"{tag} ({key}) loss", met["loss"],
                        umet["loss"], "float32")
            opt_cfg = AdamWConfig()
            scale = torch.clamp(opt_cfg.clip_norm / torch.clamp(
                global_norm(grads), min=1e-9), max=1.0)
            leaf_cfg = dataclasses.replace(opt_cfg, clip_norm=float("inf"))
            step0 = torch.zeros((), dtype=torch.int32, device=dev)
            errs = {}
            for i, (p_i, g_i, pl) in enumerate(zip(
                    tree_leaves(params), tree_leaves(grads), placements,
                    strict=True)):
                mv = {"m": [torch.zeros(p_i.shape, dtype=torch.float32,
                                        device=dev)],
                      "v": [torch.zeros(p_i.shape, dtype=torch.float32,
                                        device=dev)], "step": step0}
                new_p, new_mv, _ = adamw_update(
                    [g_i.to(torch.float32) * scale], mv, [p_i], leaf_cfg)
                for name, want_leaf in zip(names, (new_p[0], new_mv["m"][0],
                                                   new_mv["v"][0]),
                                           strict=True):
                    errs[name, i] = check_close(
                        torch, f"{tag} ({key}) {name} leaf {i}",
                        host[name][i].to(dev), own(want_leaf, pl), "float32")
                del new_p, new_mv, mv
            router = [i for i, p in enumerate(paths) if ("key", "router") in p]
            res.update(leaves=len(paths), max_err=max(errs.values()),
                       loss_unsharded=float(umet["loss"]),
                       router_err={n: max(errs[n, i] for i in router)
                                   for n in names} if router else None)

        # Each rank in turn: the unsharded step beside one rank's state.
        t0 = time.perf_counter()
        staggered(check)
        res["train_check_s"] = time.perf_counter() - t0
        host.clear()
        gc.collect()
        torch.cuda.empty_cache()
        return res

    def split_layers(cases) -> None:
        """Phase 26's MoE, Mamba, MLA and cross-attention cases (d)-(j) on
        this rank: each result under ``out[case]``.  (j) runs on a
        TP_DATA_MESH mesh of the same ranks: ``mesh`` is rebound for it,
        and the cases' functions read it from this scope."""
        nonlocal mesh
        k4 = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
              "flash_attention_bwd_dkdv": 0}

        def k4_train(n_layers):
            return {"flash_attention_fwd": 2 * n_layers,
                    "flash_attention_bwd_dq": n_layers,
                    "flash_attention_bwd_dkdv": n_layers}

        moe_tokens = tp_prompts(torch, dev, get_config(
            "qwen2-moe-a2.7b").vocab_size, REMAINING_LENGTHS, 512)
        bf16 = {key: cfg for key, cfg, _, _ in tp_bf16_cases()}
        for case in cases:
            t0 = time.perf_counter()
            if case in ("d", "e"):
                n = (TP_ETP_LAYERS if case == "e" else MOE_F32_LAYERS
                     if world == 2 else TP_MOE_M4_F32_LAYERS)
                cfg32 = get_config("qwen2-moe-a2.7b", n_layers=n,
                                   param_dtype="float32",
                                   compute_dtype="float32")
                res = {}
                # Whole in bf16 at model 2; on four ranks (j) serves it
                # whole, on the (data 2, model 2) mesh.
                if case == "d" and world == 2:
                    res["bf16"] = serve_case(
                        "d_bf16", bf16["d_bf16"], *moe_tokens,
                        {"prefill_flash": 24, "ssd_scan": 0})
                # (d) at model 2 counts its prefill's expert FLOPs, which
                # (j) halves over its data ranks.
                res["f32"] = serve_case(f"{case}_f32", cfg32, *moe_tokens,
                                        {"prefill_flash": n, "ssd_scan": 0},
                                        flops=case == "d" and world == 2)
                res["f32"].update(train_case(f"{case}_f32", cfg32,
                                             k4_train(n)))
            elif case == "j":
                # Qwen1.5-MoE on (data 2, model 2): the prompts 2 a data
                # rank, the train step on two of phase 11's f32 grains, one
                # a data rank; each data rank computes half of every
                # expert's capacity slots and the shared expert on its own
                # rows.  The serves take the ``tp`` policy (each data rank
                # a replica of its ``model`` shard): under ``fsdp_tp``
                # every layer's weights cross the host to the other data
                # rank at each pass, and the bf16 serve took 186.9 s, the
                # f32 one 77.1 s.  Three bf16 half-models and a whole one
                # did not fit on the card together, so the first rank
                # parks its shards on the host while the others init.
                # The train step keeps ``fsdp_tp``: four ranks' f32 states
                # fit on the card only so.
                outer, mesh = mesh, make_debug_mesh(*TP_DATA_MESH,
                                                    device_type="cuda")
                try:
                    n = MOE_F32_LAYERS
                    cfg32 = get_config("qwen2-moe-a2.7b", n_layers=n,
                                       param_dtype="float32",
                                       compute_dtype="float32")
                    res = {"bf16": serve_case(
                        "j_bf16", dataclasses.replace(
                            bf16["d_bf16"], sharding_policy="tp"),
                        *moe_tokens, {"prefill_flash": 24, "ssd_scan": 0},
                        steps=TP_DATA_DECODE_STEPS, park=1)}
                    res["f32"] = serve_case(
                        "j_f32", dataclasses.replace(cfg32,
                                                     sharding_policy="tp"),
                        *moe_tokens, {"prefill_flash": n, "ssd_scan": 0},
                        flops=True)
                    res["f32"].update(train_case(
                        "j_f32", cfg32, k4_train(n),
                        grain_batch(cfg32, [0, 1])))
                finally:
                    mesh = outer
            elif case == "f":
                cfgm = bf16["f_bf16"]
                prompt = tp_prompts(torch, dev, cfgm.vocab_size,
                                    (TP_MAMBA_PROMPT,), TP_MAMBA_BUCKET)
                cfgm32 = get_config("mamba2-2.7b", n_layers=TP_MAMBA_F32_LAYERS,
                                    param_dtype="float32",
                                    compute_dtype="float32")
                res = {"bf16": serve_case("f_bf16", cfgm, *prompt,
                                          {"ssd_scan": cfgm.n_layers}),
                       "f32": serve_case("f_f32", cfgm32, *prompt,
                                         {"ssd_scan": TP_MAMBA_F32_LAYERS})}
                res["f32"].update(train_case(
                    "f_f32", cfgm32, dict(
                        k4, ssd_scan=2 * TP_MAMBA_F32_LAYERS,
                        ssd_scan_bwd=TP_MAMBA_F32_LAYERS)))
            elif case == "g":
                cfgj = bf16["g_bf16"]
                res = {"bf16": serve_case(
                    "g_bf16", cfgj,
                    *tp_prompts(torch, dev, cfgj.vocab_size, REMAINING_LENGTHS,
                                512), {"prefill_flash": 1, "ssd_scan": 7})}
            elif case == "h":
                # MLA launches no kernel (plain einsums, as in the
                # reference); no cache is gathered over ``model``.
                cfgd = get_config("deepseek-v2-236b",
                                  n_layers=DEEPSEEK_F32_LAYERS,
                                  param_dtype="float32",
                                  compute_dtype="float32")
                none = dict(k4, prefill_flash=0, ssd_scan=0)
                res = {"f32": serve_case(
                    "h_f32", cfgd, *tp_prompts(
                        torch, dev, cfgd.vocab_size, REMAINING_LENGTHS, 512),
                    none, gathers=0)}
                res["f32"].update(train_case("h_f32", dataclasses.replace(
                    cfgd, n_layers=TP_DEEPSEEK_TRAIN_LAYERS), none))
            else:
                # K4 once an encoder layer in a prefill (the encoder), K1
                # once a decoder layer; in training K4 forward (twice: the
                # checkpoint), dQ and dK/dV on each encoder layer's
                # self-attention and each decoder layer's self- and
                # cross-attention, on this rank's heads.
                n = TP_SEAMLESS_F32_LAYERS
                cfgs = get_config("seamless-m4t-medium", n_layers=n,
                                  encoder=EncoderConfig(n_layers=n),
                                  param_dtype="float32",
                                  compute_dtype="float32")
                prompts = tp_prompts(torch, dev, cfgs.vocab_size,
                                     REMAINING_LENGTHS, 512)
                res = {}
                if world == 2:               # bf16 whole at model 2 only
                    full = bf16["i_bf16"]
                    res["bf16"] = serve_case(
                        "i_bf16", full, *prompts,
                        {"prefill_flash": full.n_layers,
                         "flash_attention_fwd": full.encoder.n_layers},
                        src=tp_src(torch, dev, full, len(REMAINING_LENGTHS)),
                        gathers=0)
                res["f32"] = serve_case(
                    "i_f32", cfgs, *prompts,
                    {"prefill_flash": n, "flash_attention_fwd": n},
                    src=tp_src(torch, dev, cfgs, len(REMAINING_LENGTHS)),
                    gathers=0)
                srng = np.random.default_rng(SEED + 2)
                tgt = torch.as_tensor(srng.integers(
                    0, cfgs.vocab_size, (1, TP_SEAMLESS_TARGET + 1)),
                    dtype=torch.int32, device=dev)
                batch = {"src_embeds": tp_src(torch, dev, cfgs, 1),
                         "tgt_tokens": tgt[:, :-1].contiguous(),
                         "targets": tgt[:, 1:].contiguous(),
                         "loss_mask": torch.ones(
                             (1, TP_SEAMLESS_TARGET), dtype=torch.float32,
                             device=dev)}
                res["f32"].update(train_case("i_f32", cfgs, k4_train(3 * n),
                                             batch))
            res["s"] = time.perf_counter() - t0
            out[case] = res
            print(f"{tag} ({case}) {res['s']:.1f} s: " + json.dumps(
                {run: {k: round(v, 2) for k, v in r.items()
                       if k.endswith("_s")}
                 for run, r in res.items() if isinstance(r, dict)}),
                flush=True)

    if backend == "shared" and world == 4:
        # Before (d): the staged backend's timed all-gather (0.54 GB a
        # rank, pairs of ranks at world 4) over the shared backend, and the
        # transport's kernels at its chunk; the counters start after it.
        out["transport_probe"] = shared_probe(torch, dist, rank, world, tag)
        shared_pg.COUNTERS.clear()
    split_layers([case for case in "defghij" if case in what])
    if "a" in what:
        # (a), (c): f32, TP_F32_LAYERS layers, sharded.
        cfg32 = dataclasses.replace(
            get_config("qwen2-1.5b", param_dtype="float32",
                       compute_dtype="float32", sharding_policy="fsdp_tp"),
            n_layers=TP_F32_LAYERS)
        model16 = Model(dataclasses.replace(cfg32, cache_dtype="bfloat16"))
        batch32 = grain_batch(cfg32, [0])
        runs = {}
        with keep_inputs(ops, "_prefill_call") as s1, \
                keep_inputs(flash_ops, "_flash_call") as s4:
            for key, cfg in (("a", cfg32),
                             ("c", dataclasses.replace(cfg32,
                                                       seq_parallel=True))):
                model = Model(cfg)
                policy = Policy(cfg, mesh)
                state = sharded_state(model, policy)
                sbatch = distribute_tree(batch32, policy.batch_specs(batch32),
                                         mesh)
                torch.cuda.synchronize()
                zero_counts()
                t0 = time.perf_counter()
                state, met = make_sharded_train_step(model, mesh)(state, sbatch)
                torch.cuda.synchronize()
                out[f"{key}_s"] = time.perf_counter() - t0
                read_counts(f"tp{world}_f32_{key}_train")
                runs[key] = (met, full_tree(state.params),
                             full_tree(state.opt["m"]), full_tree(state.opt["v"]))
                del state
            model = Model(cfg32)
            policy = Policy(cfg32, mesh)
            params = model.init(SEED)
            sparams = distribute_tree(params, policy.param_specs(params), mesh)
            zero_counts()
            sharded_serve = serve(model, sparams, policy)
            read_counts(f"tp{world}_f32_serve")
            pbatch = {"tokens": tokens}
            zero_counts()
            lg16, c16 = make_sharded_prefill_step(model16, mesh)(
                sparams, distribute_tree(pbatch, policy.batch_specs(pbatch),
                                         mesh))
            torch.cuda.synchronize()
            read_counts(f"tp{world}_f32_prefill_bf16_cache")
            lg16, c16 = lg16.full_tensor(), full_tree(c16)
            seen1.update(s1)
            seen4.update(s4)
        del sparams
        if rank == 0:
            zero_counts()
            want, umet = make_train_step(model)(init_train_state(params),
                                                batch32)
            for key, (met, p, m1, v1) in runs.items():
                check_close(torch, f"tensor-parallel ({key}) loss", met["loss"],
                            umet["loss"], "float32")
                for name, got, ref in (("parameter", p, want.params),
                                       ("first moment", m1, want.opt["m"]),
                                       ("second moment", v1, want.opt["v"])):
                    for i, (g, r) in enumerate(zip(tree_leaves(got),
                                                   tree_leaves(ref),
                                                   strict=True)):
                        check_close(torch, f"tensor-parallel ({key}) {name} "
                                    f"leaf {i}", g, r, "float32")
                out[f"{key}_loss"] = float(met["loss"])
            out["a_loss_unsharded"] = float(umet["loss"])
            out["leaves"] = len(tree_leaves(want.params))
            del want
            logits_u, toks_u = serve(model, params, None)
            out["f32_logits_err"] = max(
                check_close(torch, f"tensor-parallel (a) decode step {i} logits",
                            g, r, "float32")
                for i, (g, r) in enumerate(zip(sharded_serve[0], logits_u,
                                               strict=True)))
            if sharded_serve[1] != toks_u:
                fail(f"tensor-parallel (a): sharded tokens {sharded_serve[1]} "
                     f"differ from the unsharded {toks_u}")
            out["f32_tokens"] = toks_u
            ulg16, uc16 = make_prefill_step(model16)(params, {"tokens": tokens})
            read_counts(f"tp{world}_f32_unsharded")
            out["bf16_cache_logits_err"] = check_close(
                torch, "tensor-parallel (a) prefill logits, bf16 cache", lg16,
                ulg16, "float32")
            out["bf16_cache_err"] = max(
                check_close(torch, f"tensor-parallel (a) bf16 cache leaf {i}", g,
                            r, "bfloat16")
                for i, (g, r) in enumerate(zip(tree_leaves(c16),
                                               tree_leaves(uc16), strict=True)))
            del uc16, ulg16
        del runs, params, model, model16, sharded_serve, c16, lg16
        gc.collect()
        torch.cuda.empty_cache()

        if "b" in what:
            # (b): the whole model in bf16, sharded.
            cfgb = dataclasses.replace(get_config("qwen2-1.5b"),
                                       sharding_policy="fsdp_tp")
            model = Model(cfgb)
            policy = Policy(cfgb, mesh)
            batch = grain_batch(cfgb, list(range(TRAIN_GRAINS)))
            with keep_inputs(ops, "_prefill_call") as s1, \
                    keep_inputs(flash_ops, "_flash_call") as s4:
                state = sharded_state(model, policy)
                sbatch = distribute_tree(batch, policy.batch_specs(batch), mesh)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                zero_counts()
                t0 = time.perf_counter()
                state, met = make_sharded_train_step(model, mesh)(state, sbatch)
                torch.cuda.synchronize()
                out["b_s"] = time.perf_counter() - t0
                out["b_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
                read_counts(f"tp{world}_bf16_train")
                out["b_loss"] = float(met["loss"])
                del state
                gc.collect()
                torch.cuda.empty_cache()
                params = model.init(SEED)
                sparams = distribute_tree(params, policy.param_specs(params),
                                          mesh)
                del params
                zero_counts()
                t0 = time.perf_counter()
                logits_b, toks_b = serve(model, sparams, policy)
                torch.cuda.synchronize()
                out["b_serve_s"] = time.perf_counter() - t0
                read_counts(f"tp{world}_bf16_serve")
                seen1.update(s1)
                seen4.update(s4)
            out["b_tokens"] = toks_b
            if rank == 0:
                saved["logits0"] = logits_b[0].cpu()
            del sparams, logits_b
    out["s"] = time.perf_counter() - t_phase
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["k1_shapes"] = sorted([list(k[0]), list(k[1]), str(k[2])[6:]]
                              for k in seen1)
    out["k4_shapes"] = sorted([list(k[0]), list(k[1]), str(k[2])[6:]]
                              for k in seen4)
    if rank == 0:
        out["k1_err"] = k1_check_seen(torch, seen1, "tensor-parallel",
                                      f"{tag} ")
        out["k4_err"] = k4_check_seen(torch, seen4, "tensor-parallel",
                                      f"{tag} ")
    out["k5_shapes"] = sorted([list(k[0]), list(k[1]), str(k[2])[6:]]
                              for k in seen5)
    # Every rank holds K5 against its plain version on the inputs its
    # heads gave it.
    out["k5_err"] = k5_check_seen(torch, seen5, "tensor-parallel", f"{tag} ")
    if rank == 0:
        torch.save(saved, out_path)
    out["launches"] = launches
    if backend == "shared":
        out["transport"] = shared_pg.stats()
    dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


def run_train_route(arch: str, layers: int, routes: str) -> int:
    """Phase 28's routes in a process of their own: ``train_single_route``
    of bf16 ``arch`` cut to ``layers`` layers on TRAIN_SINGLE_STEPS steps
    of ``train_single_batches``, on each route of ``routes`` (``eager``,
    ``compiled``, comma-separated) in turn; a line for each, then a last
    line of each route's figures with its kernels' launches."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.mamba_scan import mamba_scan as k5
    from repro_torch.kernels.matmul import matmul as mm
    from repro_torch.kernels.prefill import prefill as pf

    counters = (pf.LAUNCHES, mm.LAUNCHES, fa.LAUNCHES, k5.LAUNCHES)
    cfg = get_config(arch, n_layers=layers)
    batches = train_single_batches(torch, cfg, torch.device("cuda"))
    out = {}
    for route in routes.split(","):
        for c in counters:
            for key in c:
                c[key] = 0
        r = train_single_route(torch, cfg, batches[:TRAIN_SINGLE_STEPS],
                               route == "compiled")
        r["launches"] = {key: n for c in counters for key, n in c.items()}
        out[route] = r
        print(f"[train-route] {arch} at {layers} layers, {route}: "
              + json.dumps({k: v for k, v in r.items() if k != "digests"}),
              flush=True)
    print(json.dumps(out))
    return 0


def run_example(name: str) -> int:
    """Run the port's example ``name`` on the card; its report, then K4's
    forward and backward against their plain versions on the first inputs
    of each shape the example gave it, then a last line with its kernels'
    launches and K4's errors."""
    import importlib

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.mamba_scan import mamba_scan as k5
    from repro_torch.kernels.matmul import matmul as mm
    from repro_torch.kernels.prefill import prefill as pf

    counters = (pf.LAUNCHES, mm.LAUNCHES, fa.LAUNCHES, k5.LAUNCHES)
    module = importlib.import_module(f"repro_torch.examples.{name}")
    for c in counters:
        for key in c:
            c[key] = 0
    t0 = time.perf_counter()
    with keep_inputs(flash_ops, "_flash_call") as seen:
        module.main(EXAMPLE_ARGV.get(name, []))
    torch.cuda.synchronize()
    print(f"{time.perf_counter() - t0:.3f} s wall on {card_line()}")
    launches = {key: n for c in counters for key, n in c.items()}
    k4_err = k4_check_seen(torch, seen, f"example {name}", "")
    print(json.dumps({"launches": launches, "k4_cases": len(seen),
                      "k4_err": k4_err}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--device-times"]:
        print(json.dumps(device_times()))
        sys.exit(0)
    if sys.argv[1:2] == ["--example"] and len(sys.argv) == 3:
        sys.exit(run_example(sys.argv[2]))
    if sys.argv[1:2] == ["--train-route"] and len(sys.argv) == 5:
        sys.exit(run_train_route(sys.argv[2], int(sys.argv[3]),
                                 sys.argv[4]))
    if sys.argv[1:2] == ["--tp-rank"] and len(sys.argv) == 8:
        sys.exit(run_tp_rank(int(sys.argv[2]), int(sys.argv[3]),
                             int(sys.argv[4]), *sys.argv[5:8]))
    sys.exit(main())
