#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it against itself.

    python3 chip_smoke.py

Needs one CUDA card and exits non-zero without one. It builds the port's
five kernel libraries from ``src/repro_torch/csrc`` (one nvcc each, started
together, into ``build/repro_torch/``), then, printing one JSON object per
line:

1. ``env``: torch/CUDA versions and the card's name and power limit;
2. ``build``: seconds for each library's nvcc build and the compiler's
   register report (a wgmma serialization warning fails the run, and so
   does a spill in a flash backward kernel);
   ``tensor_cores``: the tensor-core instructions of each kernel, from
   the libraries' machine code (the int8 P2M kernels, A's two and fused,
   single-chip and with the chip axis, must run s8 IMMA, no other P2M
   kernel IMMA, and none HMMA: the
   float32 MACs use no TF32; every ``flash_wgmma_kernel`` instance, each
   (D, Dv) pair with and without a window (``flash_wgmma_kernel<256,
   true>`` and MLA's ``flash_wgmma_kernel<192, false>`` among them), runs
   HGMMA and no HMMA, and so do the flash backward's four bf16 kernels
   (``flash_bwd_dq_wgmma_kernel<D>`` and ``flash_bwd_dkdv_wgmma_kernel<D>``
   at D 80 and 128); the float32 flash kernel, the RG-LRU scan's three
   instances, the sLSTM kernel's two and the flash backward's float32
   dq and dk / dv kernels run neither);
3. one ``kernel`` line per kernel and geometry: the serving shape
   (16, 32, 32, 3) -> (4096, 32), three odd geometries (one at C 48) and
   the paper's ImageNet frame size (16, 224, 224, 3) -> (200704, 32). Each
   of the seven kernels (f32 A, B, f32 fused, int8 A, int8 fused,
   explicit-patch A, legacy fused) is held against its plain PyTorch
   version on the same card tensors (u at atol 3e-6, theta at rtol 1e-5,
   draws by the word-boundary rule) and against its siblings bit for bit
   (fused at a pinned theta == A -> B at both precisions; on power-of-two
   grid inputs int8 == f32; explicit A == implicit A; legacy at A's theta
   == pinned fused), and timed (device time between two CUDA events, median
   of 30, and beside it the kernel's own duration from ``torch.profiler``)
   beside its plain version (median of 30, of 5 at the ImageNet size), its
   bound (the statistics counted as the one set the function returns, not
   the kernel's partial rows) and, where one PyTorch call computes the same
   function, that call. The three kernel A lines and the legacy line name
   the path that ran (``tile_path``: ``warp-owned`` tiles or
   ``block-shared`` ones, as the library's ``p2m_phase_a_warp_tiles`` and
   ``p2m_conv_warp_tiles`` choose at that N);
4. ``engine``: full-width vgg16 at CIFAR-10 geometry, seeded random weights:
   ``classify`` on 16 frames and ``stream`` of 4 batches of 16 on the f32
   path, with every kernel's launch count read from that run alone; the
   classify result is held against the same engine on the CPU: the
   frontend maps by their draw rule, then the backbone layer by layer on
   the card and on the CPU from the CPU's map (a binary unit may differ
   only where its z lies within 4 float32 ulps of its threshold), then
   the probs at atol 1e-3 on the frames where no activation differed;
5. ``profile``: device time of a classify step by kernel family, and of
   each frontend kernel in it (kernel A and B per launch inside the step);
6. ``baseline``: the double-conv baseline at the serving shape (explicit
   kernel A over an im2col matrix for theta, then ``ops.p2m_conv``), held
   against the exact f32 path bit for bit, with its own launch counts;
7. ``engine_int8``: the same vgg16 engine with a port tile table that picks
   int8 at (4096, 27, 32), with its own launch counts and CPU comparison,
   and its ``profile`` line (int8 kernel A's device ms inside the step);
8. ``autotune``: the port's search at the serving shape (data, no check);
   ``frontends`` lines: the plain-PyTorch backends ``ideal``, ``analog``
   (Fig. 8 flips on at 0.01 / 0.01) and ``device`` through
   ``SensorFrontend`` on the card. At the serving shape (16, 32, 32, 3)
   each is held against the same call on the CPU from the same inputs and
   key: its threefry words and uniforms bit for bit, theta and the Hoyer
   loss at rtol 1e-5, the V_CONV stats at atol 1e-5, a binary activation
   differing only where z lies within 4 float32 ulps of the Hoyer
   threshold (ideal, analog) or a uniform within 1e-6 of its P_sw
   (device), in at most 1e-3 of the elements. At ImageNet (16, 224, 224,
   3), on the card only: the device backend's words at the first and last
   2^20 of its 51.4 M counters against the CPU's, and its activation rate
   within 5 binomial sigma of the mean majority probability of its P_sw.
   Each is timed (event pair, median of 30, of 5 at ImageNet) beside the
   ``cuda`` backend's call at the same shape, with its peak memory;
   ``engine_device`` (and ``engine_device_steady``): the vgg16 engine of
   phase 4 with ``backend="device"``, classify and a 4-batch stream (every
   step exact), no kernel launched (every P2M wrapper's count 0), the
   classify and every stream step held against the same engine on the
   CPU as in phase 4, and its walls;
9. ``flash`` lines: the flash-attention kernels at granite-8b's prefill
   (B 4, S 2048, H 32, Hkv 8, D 128, bf16, causal), at stablelm-3b's (B 4
   and B 1, S 2048, H 32, MHA, D 80, bf16, causal), four odd ones (S 77
   MHA D 64 bf16; S 256 non-causal float32, ``flash_ffma_kernel``; S 1000
   GQA, a ragged tail; S 130 D 32 non-causal bf16) and granite-8b's
   prefill traffic at bf16 D 32 and 16 and in float32 at D 128 and 16
   (every bf16 line ``flash_wgmma_kernel``), each held against its plain
   version on the same card tensors (max-abs 2e-2 for bf16 outputs, 2e-5
   for float32, and the row gate below), timed beside its plain version,
   its bound (bytes, the products and one exponential a visible pair on
   the special-function units) and ``scaled_dot_product_attention``, and
   naming the kernel symbol a profiled call shows ran; three windowed
   lines: recurrentgemma-2b's prefill (B 4, S 2048, H 10, Hkv 1, D 256,
   bf16, causal, window 2048, which masks nothing there), the same at B 1,
   S 8192 (where it masks) and S 1000 D 64 GQA with a window of 300 (a
   ragged tail through an instance that existed before the window), the
   yardstick SDPA with the window's boolean mask (``masked_library_ms``;
   where the window masks nothing the yardstick is causal SDPA without it,
   which computes the same function: ``causal_library_ms``), and
   beside each the kernel without the window (``unwindowed_ms``; a call
   whose window hides no key runs that instance itself); two lines at the
   MoE models' prefills: deepseek-v2's MLA (B 4, S 2048, H 128, qk 192
   over v 128, ``flash_wgmma_kernel<192, false>``; its yardstick the first
   SDPA backend that takes Dv != D, named in ``library_backend``) and
   kimi-k2's (H 64 over 8, D 112), each with its instance's HGMMA count;
   three at whisper-base's prefill (B 16, H 8, D 64, bf16: the encoder's
   1500 frames non-causal, the decoder's 224-token prompt causal, and the
   cross-attention of the 224 queries over the 1500 frames, Sq != Sk,
   non-causal) and two of the float32 kernel at unequal lengths (Sq 8
   over Sk 24 at D 16, reduced whisper-base's cross block; Sq 130 over Sk
   1500 at D 64), each bound counted at Sq x Sk;
   ``rglru_scan``: the
   RG-LRU scan kernel at recurrentgemma-2b's prefill (B 4, S 2048, R
   2560, a near 1) against its plain version (an associative scan) at
   1e-5, timed beside it and its bound (bytes: a and b read, h written);
   ``rglru_scan_gated``: its gated instance at the same shape in bf16 (the
   gates' float32 tail fused in front, h written in bf16 and the last h
   in float32) bit for bit against the unfused chain (tail, ``rglru_scan``,
   cast) on the same card tensors and against its plain version (h_last at
   1e-5, hs within one bf16 ulp), timed beside its plain version, its
   bound and the unfused chain (``unfused_chain_ms``); ``slstm_scan``: the
   sLSTM recurrence kernel at xlstm-350m's prefill (B 4, S 2048, 4 heads
   of 256, bf16 weights), at the same shape with float32 weights and at
   head dim 16 (float32 weights), hs and the last carry against its plain
   version (the reference's step looped in PyTorch ops) at 1e-4, timed
   (event pairs, median of 30; the profiler's own duration; ``us_per_step``)
   beside the plain loop (one run), its bound (the products' FFMAs or the
   bytes), with the launch's ``design`` (cluster, blocks, the SMs its
   blocks ran on, rows a cluster, shared memory a block, the clusters the
   card holds at once); then as a decode step runs it: 4 one-token steps
   chained through a drawn carry that the kernel advances in place, each
   step's h and carry against the plain version at 1e-4, one step timed
   beside its bound (``decode_us``, ``decode_bound_us``);
10. ``lm``: full-width, full-depth granite-8b, then stablelm-3b (head dim
   80), then recurrentgemma-2b (26 layers: 18 RG-LRU, 8 local attention at
   head dim 256 with a 2048-key window, 3.55 B parameters), with seeded
   bf16 weights drawn on the card (each model's freed before the next),
   each ``ServingEngine.generate`` of a (4, 2048) prompt for 32
   new tokens, with its launch counts (one flash launch an attention
   layer, every one the model's one ``flash_wgmma_kernel`` instance, one
   ``rglru_scan_gated`` an RG-LRU layer and no ``rglru_scan``, no P2M
   kernel), finite logits, token ids in
   range, and the prefill logits held against a ``forward(mode="train")``
   of the prompt (teacher forcing); then the steady generate times, peak
   memory and the flash and scan kernels' shares of prefill device time
   (``lm_profile``); then deepseek-v2 at 6 layers (its dense first layer +
   5 MoE layers of 160 experts, top-6, 2 shared, MLA: every width, expert
   and the capacity factor kept, depth cut: ``cut``) and kimi-k2 at 2
   layers (dense + 1 MoE layer of 384 experts, top-8), the same way (one
   flash launch a layer: ``flash_wgmma_kernel<192, false>`` /
   ``<112, false>``), with the peak memory of the weights' draw
   (``init_peak_memory_gb``), the prefill's MoE stages by device time
   (route, dispatch, expert products, combine: profiler ranges around the
   port's functions) and the LM head over every prompt position alone;
   ``lm_xlstm``: xlstm-350m at full width and depth (21 mLSTM and 3 sLSTM
   layers, d 1024, 4 heads of 256, no attention) the same way: one
   ``slstm_cluster_kernel<__nv_bfloat16, 4>`` launch an sLSTM layer in the
   prefill and in each decode step (96 a generate) and no flash launch,
   its ``lm_profile`` with the prefill split into the mLSTM layers'
   chunkwise ops and projections, the sLSTM kernel and the sLSTM layers'
   projections (profiler ranges) and the rest; whisper-base
   (``lm_whisper``: 6 encoder and 6 decoder layers, d 512, 8 heads of 64,
   vocab 51,865) at full width and depth on 16 clips of 1500 seeded
   frame embeddings (the audio frontend is a stub), a 224-token prompt
   and 32 new tokens: 18 flash launches of ``flash_wgmma_kernel<64,
   false>`` a prefill (6 encoder, 6 decoder self, 6 cross at Sq != Sk)
   and none a decode step, teacher forcing over the same frames, the
   prefill by stage (encoder, decoder, the rest: profiler ranges) and one
   layer's plain cross-attention decode over the 1500 cached rows alone;
11. ``lm_vs_cpu``: granite-8b at full width but 2 layers (a depth cut: the
   CPU engine at 36 layers would take minutes), the card's engine against
   the CPU engine on a (1, 128) prompt and 8 new tokens, with its flash
   launch count; ``lm_stablelm``: the same check for stablelm-3b (head dim
   80, the wgmma kernel) at full width, 2 layers; ``lm_rg_vs_cpu``: the
   same for recurrentgemma-2b at full width, 3 layers (one period of its
   pattern: rglru, rglru, local_attn); ``lm_rg_ring``: recurrentgemma-2b
   at full width, 3 layers, a (2, 3072) prompt past its window and 8 new
   tokens: each decode step's logits (the ring cache) against a card
   ``forward(mode="train")`` over the prompt and the tokens so far, at
   the teacher-forcing tolerance; ``lm_mla_vs_cpu`` / ``lm_kimi_vs_cpu``:
   deepseek-v2 and kimi-k2 at full width, 2 layers (dense + MoE; kimi-k2's
   experts cut to 64 on both sides so that the host holds the layer),
   card against CPU as above, where a token whose top-k set differs must
   sit at a near tie (2 bf16 ulps) and a compared position routed
   differently leaves the comparison (counted); ``lm_xlstm_vs_cpu``:
   xlstm-350m at full width, 8 layers (one period of its pattern: 7 mLSTM,
   1 sLSTM), card against CPU as above on a 512-token prompt (two of the
   mLSTM's 256-row chunks, so the carry between chunks is compared);
   ``lm_whisper_vs_cpu``: whisper-base at full width and depth, card
   against CPU on 2 clips of 1500 frames and a 64-token prompt;
   ``lm_moe_routing``: one
   deepseek-v2 MoE layer at full width on a seeded 4 x 2048 bf16 input,
   card against CPU: the share of tokens whose top-k sets differ, each
   such token's CPU gap at the k-th logit (within 2 bf16 ulps), the
   output's max-abs on the tokens routed alike (LM_CPU_TOL), and each
   stage's event-pair ms on the card;
12. LM training: ``flash_bwd`` lines, the flash backward kernel
   (``csrc/flash_attention_bwd.cu``: a dq pass then a dk / dv pass,
   ``flash_bwd_dq_wgmma_kernel<D>`` and ``flash_bwd_dkdv_wgmma_kernel<D>``
   in bf16, warp-specialised wgmma fed by TMA, with the layout the library
   reports as ``design``; ``flash_bwd_*_kernel<float, 16>`` in float32) at
   stablelm-3b's
   step (B 4, S 2048, 32 heads of 80, bf16, causal), granite-8b's (32
   heads over 8 of 128) and the reduced configs' float32 D 16 (B 8, S
   128, 4 heads): dq, dk and dv against the plain version (autograd
   through the plain forward in float32) on the same card tensors, each
   gradient row's largest error over its RMS within 0.1 (bf16) / 1e-4
   (float32) over the rows above 1e-3 of the largest RMS, two launches
   bit for bit equal, every kernel it launches named
   from a profile, timed beside the plain version, the bound (five
   products of D a visible pair, one exponential, each operand once) and
   the backward of ``scaled_dot_product_attention`` (torch.autograd; the
   port never calls it); ``lm_train``: ``Trainer.fit`` on stablelm-3b at
   full width and depth (2.8 B bf16 parameters, seeded), the default
   ``OptimizerConfig`` (AdamW, float32 moments), ``TokenStream`` batches
   of 4 x 2048, remat "full", 5 steps one ``fit`` call each (no
   checkpoint: 34 GB of state), 64 forward and 32 backward flash launches
   a step, finite losses near ln(vocab), the step walls, the device ms of
   one more step by family (profiler), peak memory; ``lm_train_d128``:
   one step of granite-8b at full width, 2 layers, 4 x 2048 (the D 128
   backward's launches); ``lm_train_vs_cpu``: one AdamW step (lr 1e-3,
   no warmup) of stablelm-3b at full width, 2 layers, 2 x 256 tokens,
   bf16, card against CPU from the same weights and batch: loss within
   2e-3 and gradient norm within 2e-2 relative, every updated weight
   within 2 lr (1 + wd |w|) + a bf16 ulp and over lr apart in at most 2%
   of a leaf; ``lm_sample``: sampled ``generate`` (temperature 0.8, key
   3) card against CPU, reduced glm4-9b in float32 and stablelm-3b at full
   width, 2 layers, in bf16: each row's tokens equal, or differing first
   where the CPU's top-2 margin of the Gumbel-perturbed scaled logits is
   within twice the logits' limit over T; ``lm_train_tiny``: ``python -m
   repro_torch.launch.train --arch stablelm-3b --scale tiny --steps 5``
   on the card (float32, D 16; its checkpoints under build/, a second
   run resuming with no step) against the same command on the CPU, the
   losses within 1e-4 relative;
13. ``train``: full-width vgg16 (P2M 3x3 stride 2 to 32 channels, 13
   binary convs) at CIFAR-10 geometry, seeded weights, trained through
   the ``analog`` backend by ``repro_torch.train.vision.fit`` for 20 SGD
   steps on batches of 64 ``ImageStream`` frames: finite losses, no P2M
   kernel launched; the median step wall, the device ms of one step
   (event pair behind a long sleep, and the kernels' own time by family
   from ``torch.profiler``), the host's time to queue ten steps beside
   the time the device takes to run them, peak memory; the trained
   weights evaluated through ``analog``, ``device`` and ``cuda`` (kernels
   A and B launched, and nothing else); ``train_vs_cpu``: one step with
   the Fig. 8 flips on, card vs CPU stage by stage from the CPU's inputs
   and cotangents (the flip words bit for bit, z within a propagated
   rounding bound, maps by it, EMA stats and gradients held to the CPU's
   float64 result, TF32 in the backward visibly off it), and the whole
   step's loss;
14. the lifetime phases, on the variation phases' calibrated chip aging
   under BENCH_lifetime.json's drift profile: ``engine_lifetime`` (the
   vgg16 engine with ``VisionEngine(drift=, schedule=SchedulePolicy(
   period_frames=64, cal_iters=12), calibration_frames=)``, a classify and
   a stream of 8 batches of 16 through ``cuda``: A, B and fused launch
   with the aged (4, C) rows, no refresh launches a kernel, the age ends at
   the frames served, the refreshes fire on the period, the merge rules
   hold; the same engine on the CPU: ages and refresh frames equal, every
   step's aged rows within 1e-6 relative to max(|row|, 1), each trim within
   8 bisection steps, the classify and a replay at the final age by
   phase 4's rules on the step's aged chip; the stale trim against a
   refresh at 1e5 frames) and ``engine_lifetime_steady`` (the aging
   classify's wall beside the plain calibrated engine's, in turns, and
   what an aging step adds); ``lifetime_kernel`` lines (A, B and fused on
   the aged rows at 3e2 and 1e5 frames against their plain versions: B's
   and fused's draws and B's V_CONV min / max bit for bit, the fused kernel
   at A's theta equal to A -> B);
   ``fleet_lifetime`` (``rate_error_vs_age`` of 48 chips at 8 ages on the
   card, its wall and peak memory, time to failure stale and refreshed;
   a CPU twin of 4 chips at 3 ages: trims within 8 steps, errors within
   2e-5 of the CPU's chain at the card's trims); ``accuracy_lifetime``
   (``accuracy_vs_age`` of one chip at two ages through ``device``, card
   vs CPU, and the maintenance energy per frame);
15. the fleet phases (``repro_torch.serving.FleetEngine``): ``fleet_kernel``
   lines, the five fleet instances (kernels A f32 and int8, B, fused f32
   and int8 with the chip axis as a grid dimension) at G 4 at the serving
   shape and (``fleet_kernel_odd``) at a per-chip N of 126, each (a)
   against its plain version (the single-chip plain version a chip at a
   time: u at 3e-6, theta at rtol 1e-5, draws by the word-boundary rule,
   fused at A's theta equal to A -> B) and (b) every chip row against the
   single-chip kernel on that chip bit for bit, timed beside the plain
   version, four single-chip launches of the same work, the bound and
   (kernel A) cuDNN / ``torch._int_mm`` over all G * B frames, with the
   kernel's own ``torch.profiler`` duration (the keys' copy left out);
   ``fleet_step_kernels``: a G 4 step's kernels beside four single-chip
   launches of each; ``fleet``:
   vgg16 on 8 chips of BENCH_fleet.json's variation and drift profiles
   (birth calibration on 16 frames, sweeps of 2 chips every 64 frames, 4
   chips a step, 6 stream rounds of one 16-frame request a chip), its
   launches from that run alone, the int8 fleet path the same way; (c) a
   G 4 step launches one A and one B (exact) or one fused kernel, as a G 1
   step does; (d) a one-chip fleet equals ``VisionEngine`` bit for bit
   (labels, probs, ``theta_used``, ``stream_fused``), nominal and on a
   sampled, calibrated, aging chip; (e) a G 4 step's frontend draws equal
   four single-chip engines' and their labels and probs (1e-3) where no
   backbone unit flips between the batchings; (f) a 2-chip fleet card vs
   CPU over 5 rounds and their sweeps (trims within 8 bisection steps, the
   same chips refreshed, ages and counters equal); (g) ``save`` then
   ``load`` into a fresh engine resumes bit for bit; a deferred exact
   step's dispatch returns with the step still in flight behind a long
   sleep kernel (no host sync); with the step wall
   and frames/s at ``chips_per_step`` 1, 2, 4 and 8, a sweep's wall and
   peak memory;
16. the variation phases, on a sampled chip (BENCH_variation.json's
   profile at sigma 1.0, chip 3): ``calibrate`` (16 frames on the card and
   on the CPU, the trims within 8 bisection steps, the rate errors and
   walls); ``engine_variation`` / ``engine_variation_device`` (the vgg16
   engine of phase 4 on that chip with ``VisionEngine(calibration=)``,
   through ``cuda``, A / B / fused launched with the chip's (4, C) rows,
   and through ``device``; each held against the CPU engine as in phase
   4) and a ``variation`` line of their steady walls beside the nominal
   engine's; ``variation_kernel`` lines: kernel B and both fused kernels
   with random (4, C) rows, a random (4, N_pix, C) per-pixel map and a map
   constant across pixels, at the serving shape and ImageNet (draws by the
   word-boundary rule against the plain versions, V partials within 1e-5,
   the constant map bit for bit the rows' outputs; event-pair and profiler
   ms beside the bound of each layout); ``yield``: ``yield_sweep`` of 64
   chips at sigma 0.1, 0.5 and 1.0 on the card against the CPU (yield
   fractions equal, error figures at rtol 1e-5 above 4 ulps of 1, read
   margin within 1e-6 V) and its walls;
17. ``obs`` (``repro_torch.obs``, run last, in a process of its own:
   ``python3 chip_smoke.py --obs-phase``):
   the vgg16 engine of phase 4 streaming 8 batches of 16 at microbatch 8,
   on the cuda path's fused stream and pinned to the deferred exact path,
   once with ``obs=None`` and once with an ``Obs``: the same launches (each
   path's kernels launched), labels, probs, ``theta_used`` and
   ``stream_fused`` bit for bit, the spans counted, the same device
   kernels and copies, name by name, in a ``torch.profiler`` profile of
   a 2-batch stream of each (the spans' device-side annotations left out;
   up to 3 pairs of profiles, as the tracer now and then drops an event)
   and the ``stream`` / ``microbatch`` span names in the instrumented one;
   a deferred exact microbatch queued behind a ~0.1 s sleep kernel returns
   from its dispatch with its event not done and in under half the sleep,
   and its probe latches a latency that covers the rest of the sleep; an
   obs-enabled ``FleetEngine`` of 4 chips (BENCH_fleet.json's profiles,
   pinned exact and on the fused stream): its events, drain gauges,
   counters and spans; ``python -m repro_torch.obs smoke`` in a
   subprocess, exit 0. Recorded, with no limit: the merged batch walls of
   an async stream with obs, a ``sync_timing=True`` one with obs and an
   async one without obs, in turns; the p50 / p95 / p99 of the async
   engine's ``serving_microbatch_wall_ms``; the host's dispatch time of a
   deferred exact step with and without obs (behind a sleep, in turns);
18. ``census`` lines (``repro_torch.analysis.census``; after ``obs``, in
   a process of its own: ``python3 chip_smoke.py --census-phase``), one an
   entry: the ten entry points of the op census at their census shapes
   (the four
   frontend backends, the exact and fused stream steps, the fleet step at
   G 1 and 2, the int8 fused step, the vgg_tiny train step) and the
   full-width vgg16 ``classify`` of 16 frames at f32 and at int8, each
   run once on the CPU under the dispatch census and once on the card
   under ``torch.profiler``: the port's launches (the wrappers' counts
   and the port's kernels in the profile, by symbol) equal the CPU
   census's kernel calls, ``fleet.g2`` launches what ``fleet.g1`` does,
   ``frontend.cuda`` launches no cuDNN kernel and no GEMM, every
   device-to-host copy of a call is a host read the CPU census counts,
   an undeferred fleet step makes its two host syncs, the structural
   rules hold; with each line the cuDNN / GEMM kernels, all device events
   and the host syncs (reported, not pinned);
19. ``seconds``: the wall time of the build, the kernel lines, the vision
   phases, the frontend backends' phases, the flash lines, the LM phases,
   the LM training phases, the train phase, the lifetime phases, the
   fleet phases, the variation phases, the obs phase and the census
   phase;
20. the card's ``nvidia-smi`` line, the ``kernels`` summary line (each
   kernel's launches from its own path's run, the fleet rows' from the
   ``fleet`` and int8 fleet paths; one flash row per served head dim: D
   128 with granite-8b's launches, D 80 with stablelm-3b's, D 256 with
   recurrentgemma-2b's, (192, 128) with deepseek-v2's, D 112 with
   kimi-k2's and D 64 with whisper-base's, timed at its encoder's
   geometry; the ``rglru_scan`` and ``rglru_scan_gated`` rows
   with recurrentgemma-2b's: 0 for the ungated instance, which its
   prefill never launches, and one an RG-LRU layer for the gated one; the
   ``slstm_scan`` row with xlstm-350m's; the three flash backward rows
   with ``lm_train``'s (D 80), ``lm_train_d128``'s and
   ``lm_train_tiny``'s (float32 D 16)),
   and last the
   ``{"ok": true, "device": ...}`` line.

Any failed check raises, so the exit code is non-zero.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12          # non-tensor-core float32 (the kernels use FFMA)
INT8_OPS = 1979e12          # dense int8 tensor-core peak (the int8 MACs)
BF16_OPS = 989e12           # dense bf16 tensor-core peak (attention, bf16)
# the special-function unit: 16 exponentials (ex2) a clock on each SM of
# Hopper, at the card's maximum SM clock (nvidia-smi reads both the clock
# and, through torch, the SM count); attention takes one a visible pair
EX2_PER_CLOCK_SM = 16
# rough per-element operation counts of the elementwise stages, used only
# for the operation side of the bound (the byte side dominates)
EPILOGUE_A_OPS = 12         # two curves, subtract, z, clip, two partial sums
DEVICE_CHAIN_OPS = 60       # chan rows, voltage map, logit fit, sigmoid,
                            # majority polynomial, draw hash and compare
REPS = 30

SERVING = dict(batch=16, h=32, w=32, kernel=3, stride=2, c=32)
ODD_GEOMETRIES = (dict(batch=4, h=16, w=16, kernel=3, stride=1, c=32),
                  dict(batch=4, h=13, w=11, kernel=5, stride=3, c=32),
                  dict(batch=4, h=16, w=16, kernel=3, stride=1, c=48))
# the same layer at the paper's ImageNet frame size (P2MConfig, paper
# §2.4.4): 200,704 patch rows, where the bound is real work
IMAGENET = dict(batch=16, h=224, w=224, kernel=3, stride=2, c=32)
# the plain versions take 0.3-3.2 ms each there (PERF.md §6), so they are
# timed over five runs, not REPS
IMAGENET_PLAIN_REPS = 5
REPLACES = {
    "p2m_phase_a_implicit":
        "src/repro/kernels/p2m_conv.py:255 (p2m_phase_a_implicit_pallas)",
    "p2m_phase_b": "src/repro/kernels/p2m_conv.py:417 (p2m_phase_b_pallas)",
    "p2m_fused_stream":
        "src/repro/kernels/p2m_conv.py:531 (p2m_fused_stream_pallas)",
    "p2m_phase_a_implicit_q8":
        "src/repro/kernels/p2m_conv.py:718 (p2m_phase_a_implicit_q8_pallas)",
    "p2m_fused_stream_q8":
        "src/repro/kernels/p2m_conv.py:816 (p2m_fused_stream_q8_pallas)",
    "p2m_phase_a": "src/repro/kernels/p2m_conv.py:138 (p2m_phase_a_pallas)",
    "p2m_conv": "src/repro/kernels/p2m_conv.py:963 (p2m_conv_pallas)",
    "flash_attention":
        "src/repro/kernels/flash_attention.py:72 (flash_attention_pallas)",
}
SOURCE = "src/repro_torch/csrc/p2m_kernels.cu"
# the device symbol each P2M wrapper launches (the profiler's event names)
KERNEL_SYMBOLS = {
    "p2m_phase_a_implicit": "phase_a_kernel<(anonymous namespace)::"
                            "ImplicitRows, (anonymous namespace)::MacF32>",
    "p2m_phase_b": "phase_b_kernel",
    "p2m_fused_stream": "fused_stream_kernel<(anonymous namespace)::"
                        "ImplicitRows, (anonymous namespace)::MacF32>",
    "p2m_phase_a_implicit_q8": "phase_a_kernel<(anonymous namespace)::"
                               "ImplicitRows, (anonymous namespace)::"
                               "MacQ8Mma>",
    "p2m_fused_stream_q8": "fused_stream_kernel<(anonymous namespace)::"
                           "ImplicitRows, (anonymous namespace)::MacQ8Mma>",
    "p2m_phase_a": "phase_a_kernel<(anonymous namespace)::ExplicitRows",
    "p2m_conv": "legacy_conv_kernel",
}
# kernel A (f32 and int8) and the legacy kernel on warp-owned tiles launch
# kernels of their own
WARP_TILE_SYMBOLS = {
    "p2m_phase_a_implicit": "phase_a_warp_kernel<(anonymous namespace)::"
                            "ImplicitRows>",
    "p2m_phase_a": "phase_a_warp_kernel<(anonymous namespace)::"
                   "ExplicitRows>",
    "p2m_phase_a_implicit_q8": "phase_a_q8_warp_kernel",
    "p2m_conv": "legacy_warp_kernel",
}
# the kernels the three wrappers launch for the (4, N_pix, C) per-pixel chip
# map (kernels of their own beside the (4, C) ones above)
PIXEL_SYMBOLS = {name: KERNEL_SYMBOLS[name].replace("_kernel", "_pix_kernel")
                 for name in ("p2m_phase_b", "p2m_fused_stream",
                              "p2m_fused_stream_q8")}
FLASH_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
# the kernels each main path launches; every other wrapper must launch 0
# times on that path
PATH_KERNELS = {
    "engine": ("p2m_phase_a_implicit", "p2m_phase_b", "p2m_fused_stream"),
    "engine_int8": ("p2m_phase_a_implicit_q8", "p2m_phase_b",
                    "p2m_fused_stream_q8"),
    "baseline": ("p2m_phase_a", "p2m_conv"),
    "lm": ("flash_attention",),
    # the hybrid: local attention through flash, RG-LRU through the scan
    # with its gates fused (never the ungated instance)
    "lm_rg": ("flash_attention", "rglru_scan_gated"),
    # xLSTM: the sLSTM recurrence in prefill and decode, no attention
    "lm_xlstm": ("slstm_scan",),
    # the encoder-decoder: the encoder's, the decoder's and the cross
    # attention through flash (at Sq != Sk), decode in plain ops
    "lm_whisper": ("flash_attention",),
    # the device backend runs one cuDNN conv and plain PyTorch: no kernel
    "engine_device": (),
    # a sampled, calibrated chip: its (4, C) rows in B and the fused kernel
    "engine_variation": ("p2m_phase_a_implicit", "p2m_phase_b",
                         "p2m_fused_stream"),
    "engine_variation_device": (),
    # the calibrated chip aging: its rows, new every step, in B and fused
    "engine_lifetime": ("p2m_phase_a_implicit", "p2m_phase_b",
                        "p2m_fused_stream"),
    # a fleet of chips, G a step: the chip axis's kernels, f32 and int8
    "fleet": ("p2m_phase_a_implicit_fleet", "p2m_phase_b_fleet",
              "p2m_fused_stream_fleet"),
    "fleet_int8": ("p2m_phase_a_implicit_q8_fleet", "p2m_phase_b_fleet",
                   "p2m_fused_stream_q8_fleet"),
    # the phase 4 engine with obs: the fused stream, and pinned exact
    "engine_obs": ("p2m_phase_a_implicit", "p2m_phase_b",
                   "p2m_fused_stream"),
    "engine_obs_exact": ("p2m_phase_a_implicit", "p2m_phase_b"),
}
SERVING_KEY = (4096, 27, 32)    # (N, K, C) of 16 frames 32x32x3, k3 s2
# the plain-PyTorch frontend backends; analog with its Fig. 8 flips on
FRONTEND_BACKENDS = ("ideal", "analog", "device")
ANALOG_NOISE = 0.01
# card vs CPU for those backends: theta and the Hoyer loss relative, the
# V_CONV stats absolute; a binary activation may differ only where z lies
# within 4 float32 ulps (relative) of the Hoyer threshold (ideal, analog)
# or one of a neuron's uniforms within DRAW_EDGE of its P_sw (device), in
# at most MAX_EDGE_FRAC of the elements
FRONTEND_RTOL = 1e-5
V_CONV_ATOL = 1e-5
THRESHOLD_ULPS_REL = 4 * 1.1920928955078125e-07
DRAW_EDGE = 1e-6
MAX_EDGE_FRAC = 1e-3
# counters of the device backend's words compared at ImageNet (at each end)
WORD_CHECK = 1 << 20
# the device backend's activation rate against the analytic majority
RATE_SIGMAS = 5.0
# the variation phases: BENCH_variation.json's profile at sigma scale 1.0,
# chip 3; the calibration bisection's steps and window (the trim is held
# card vs CPU within 8 of its steps); the yield sweep's fleet and sigmas
VARIATION_CHIP = 3
CAL_ITERS, CAL_SPAN = 16, 2.0
YIELD_CHIPS, YIELD_SIGMAS = 64, (0.1, 0.5, 1.0)
# the error figures at rtol 1e-5 above a floor of 4 float32 ulps of 1: a
# fail rate is 1 - q of a majority probability q near 1, so an ulp of q
# (card and CPU transcendentals differ by ulps) is an ulp of 1 in it
YIELD_RTOL, YIELD_ATOL = 1e-5, 4 * 2.0 ** -23
YIELD_MARGIN_ATOL_V = 1e-6

# flash attention: the LM serving geometry (granite-8b prefill of 4 x 2048
# tokens), stablelm-3b's prefill at head dim 80 (the `lm` generate's batch
# of 4 and batch 1), four odd ones and granite-8b's prefill traffic at the
# narrow bf16 heads and in float32
FLASH_SERVING = dict(batch=4, seq=2048, heads=32, kv_heads=8, head_dim=128,
                     dtype="bfloat16", causal=True)
FLASH_D80_SERVING = dict(batch=4, seq=2048, heads=32, kv_heads=32,
                         head_dim=80, dtype="bfloat16", causal=True)
FLASH_NARROW_TOY = dict(batch=2, seq=130, heads=4, kv_heads=1, head_dim=32,
                        dtype="bfloat16", causal=False)
FLASH_F32_TOY = dict(batch=2, seq=256, heads=8, kv_heads=2, head_dim=128,
                     dtype="float32", causal=False)
# where the narrow and float32 kernels do real work: B 4, S 2048, H 32/8,
# causal (D 16 is what every reduced config launches, in float32)
FLASH_B4 = {"narrow_d32_b4": {**FLASH_SERVING, "head_dim": 32},
            "narrow_d16_b4": {**FLASH_SERVING, "head_dim": 16},
            "f32_d128_b4": {**FLASH_SERVING, "dtype": "float32"},
            "f32_d16_b4": {**FLASH_SERVING, "head_dim": 16,
                           "dtype": "float32"}}
FLASH_ODD = (FLASH_D80_SERVING,
             dict(batch=1, seq=2048, heads=32, kv_heads=32, head_dim=80,
                  dtype="bfloat16", causal=True),    # stablelm-3b, batch 1
             dict(batch=2, seq=77, heads=4, kv_heads=4, head_dim=64,
                  dtype="bfloat16", causal=True),
             FLASH_F32_TOY,
             dict(batch=1, seq=1000, heads=32, kv_heads=8, head_dim=128,
                  dtype="bfloat16", causal=True),
             FLASH_NARROW_TOY, *FLASH_B4.values())
# recurrentgemma-2b's prefill at D 256 (10 heads over 1 kv head) with its
# 2048-key window, which masks nothing at S 2048; the same where the window
# masks (B 1, S 8192: a quarter of the causal pairs); and a ragged tail
# through an instance that existed before the window (D 64, window 300)
FLASH_RG_SERVING = dict(batch=4, seq=2048, heads=10, kv_heads=1,
                        head_dim=256, dtype="bfloat16", causal=True,
                        window=2048)
FLASH_WINDOWED = (FLASH_RG_SERVING, {**FLASH_RG_SERVING, "batch": 1,
                                     "seq": 8192},
                  dict(batch=1, seq=1000, heads=32, kv_heads=8, head_dim=64,
                       dtype="bfloat16", causal=True, window=300))
# deepseek-v2's MLA prefill (B 4, S 2048, 128 heads after the latent's
# expansion, qk 192 = 128 nope + 64 rope over v 128: flash_wgmma_kernel<192,
# false>) and kimi-k2's (64 heads over 8 at D 112)
FLASH_MLA_SERVING = dict(batch=4, seq=2048, heads=128, kv_heads=128,
                         head_dim=192, v_dim=128, dtype="bfloat16",
                         causal=True)
FLASH_KIMI_SERVING = dict(batch=4, seq=2048, heads=64, kv_heads=8,
                          head_dim=112, dtype="bfloat16", causal=True)
FLASH_MOE = (FLASH_MLA_SERVING, FLASH_KIMI_SERVING)
# whisper-base's prefill (B 16, 8 heads of 64, bf16): the encoder's
# self-attention over its 1500 frames (non-causal; 11 x 128 + 92 rows, so
# the last q and kv tiles are ragged at once), the decoder's over the
# 224-token prompt (causal) and its cross-attention of the prompt over the
# frames (non-causal, Sq != Sk: ``kv_seq``); then flash_ffma_kernel at
# unequal lengths: reduced whisper-base's cross geometry (Sq 8 over Sk 24,
# D 16) and a larger ragged pair (Sq 130 over Sk 1500, D 64)
FLASH_WHISPER_ENCODER = dict(batch=16, seq=1500, heads=8, kv_heads=8,
                             head_dim=64, dtype="bfloat16", causal=False)
FLASH_WHISPER = (FLASH_WHISPER_ENCODER,
                 {**FLASH_WHISPER_ENCODER, "seq": 224, "causal": True},
                 {**FLASH_WHISPER_ENCODER, "seq": 224, "kv_seq": 1500})
FLASH_UNEQUAL_F32 = (dict(batch=2, seq=8, kv_seq=24, heads=4, kv_heads=4,
                          head_dim=16, dtype="float32", causal=False),
                     dict(batch=16, seq=130, kv_seq=1500, heads=8,
                          kv_heads=8, head_dim=64, dtype="float32",
                          causal=False))
# kernel vs plain: bf16 output rounding (one ulp is 2^-8 relative) plus a
# different summation order; float32: the summation order alone
FLASH_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# beside it, the largest error of an output row over that row's RMS: late
# causal rows average ~S keys and are small (|out| ~ S^-0.5), so a fault
# confined to them could hide under the absolute limit. Another kv tile order
# (the plain version at 32, 128 or S) stays under it, one kv tile dropped from
# the last rows lies 10x above it (tests/test_torch_flash.py).
FLASH_ROW_TOL = {"bfloat16": 1e-1, "float32": 1e-4}
LM_ARCH = "granite-8b"
LM_D80_ARCH = "stablelm-3b"     # head dim 80: flash_wgmma_kernel<80, false>
# the hybrid: RG-LRU layers (the scan kernel) and local attention at head
# dim 256 with a 2048-key window (flash_wgmma_kernel<256, true>)
LM_RG_ARCH = "recurrentgemma-2b"
LM_RG_LAYERS = 3                # one period of its pattern: the depth cut
LM_RG_RING_PROMPT = 3072        # of lm_rg_ring: past the window
# the RG-LRU scan at recurrentgemma-2b's prefill, against its plain version
# (an associative scan): two float32 summation orders of h up to ~5 differ
# by ~2.3e-6 (the CPU, in float64, at S 2048 with a up to 1 - 6e-8)
RGLRU_SERVING = dict(batch=4, seq=2048, width=2560)
RGLRU_TOL = 1e-5
RGLRU_SOURCE = "src/repro_torch/csrc/rglru_scan.cu"
RGLRU_REPLACES = ("none (no TPU kernel): src/repro/models/recurrent.py:97 "
                  "(jax.lax.associative_scan in rglru_apply)")
# the gated instance at the same shape in recurrentgemma-2b's compute dtype:
# r and i sigmoids, u normal, c = -8 softplus(lam) in [-0.8, -0.008] (a in
# (0.45, 1): the carry matters); equal to the unfused chain (the tail,
# rglru_scan, the cast) bit for bit, and against its plain version h_last
# at RGLRU_TOL and hs within one bf16 ulp (or RGLRU_TOL where that is
# larger: the two scans' h differ by up to ~3e-6 before the rounding)
RGLRU_GATED_DTYPE = "bfloat16"
RGLRU_GATED_REPLACES = (
    "none (no TPU kernel): src/repro/models/recurrent.py:62-71 and 102 "
    "(_rglru_gates' float32 tail as XLA elementwise ops, then "
    "jax.lax.associative_scan in rglru_apply)")
# the sLSTM recurrence at xlstm-350m's prefill (B 4, S 2048, 4 heads of 256,
# bf16 weights), at that shape with float32 weights (128 KB of them a block)
# and at the reduced configs' head dim 16 (float32 weights), against its
# plain version (the reference's step looped in PyTorch ops): the kernel's
# dot sums dh float32 products in order, as cuBLAS sums the plain
# version's at these shapes (the two agree bit for bit); a cuBLAS that
# summed in another order would move |pre| ~1e-7 a step, and the
# stabilized recurrence (|h| <= 1, f_s <= 1) keeps that far under 1e-4
# over S 2048
SLSTM_SERVING = dict(batch=4, seq=2048, heads=4, head_dim=256,
                     w_dtype="bfloat16")
SLSTM_F32 = dict(SLSTM_SERVING, w_dtype="float32")
SLSTM_NARROW = dict(batch=4, seq=2048, heads=4, head_dim=16,
                    w_dtype="float32")
SLSTM_TOL = 1e-4
# the plain loop is ~60 k launches, 1.3-2.2 s, a call: timed once (its
# spread does not matter beside its ~75x gap to the kernel)
SLSTM_PLAIN_REPS = 1
# the decode check: one-token steps chained through one carry, in place
SLSTM_DECODE_STEPS = 4
# the sLSTM kernel's name, and the one before the cluster design (a port
# that scripts/lm_ab.py runs may be older)
SLSTM_KERNELS = ("slstm_cluster_kernel", "slstm_scan_kernel")
SLSTM_SOURCE = "src/repro_torch/csrc/slstm_scan.cu"
SLSTM_REPLACES = ("none (no TPU kernel): src/repro/models/recurrent.py:312 "
                  "(jax.lax.scan of _slstm_step, :267-286, in slstm_apply)")
# xlstm-350m (21 mLSTM + 3 sLSTM layers, no attention) at full width and
# depth; its card-vs-CPU phase at one period of its pattern (8 layers) ...
LM_XLSTM_ARCH = "xlstm-350m"
LM_XLSTM_CPU_LAYERS = 8
# ... on a prompt of two of the mLSTM's 256-row chunks (the carry between
# chunks compared card against CPU)
LM_XLSTM_CPU_PROMPT = 512
# the mixers' stages of an xLSTM prefill, each timed on the device as a
# profiler range (the sLSTM kernel by its own name)
XLSTM_STAGES = {"mlstm_layers": "mlstm_apply",
                "mlstm_chunk_ops": "_mlstm_chunk_step",
                "slstm_layers": "slstm_apply"}
# the MoE models at full width, every expert, top-k and capacity factor,
# cut in depth only (neither fits one 80 GB card whole): deepseek-v2 at its
# dense first layer + 5 MoE layers (about 42.5 GB of bf16 weights), kimi-k2
# at its dense first layer + 1 MoE layer (about 40 GB); their card-vs-CPU
# phases at 2 layers, kimi-k2's experts cut to 64 on both sides so that the
# host holds the layer
LM_MLA_ARCH, LM_MLA_LAYERS = "deepseek-v2-236b", 6
LM_KIMI_ARCH, LM_KIMI_LAYERS = "kimi-k2-1t-a32b", 2
LM_KIMI_CPU_EXPERTS = 64
# the MoE stages of a prefill, each timed on the device as a profiler range
# (the expert products are cuBLAS kernels like every other matmul)
MOE_STAGES = {"route": "moe_route", "dispatch": "_moe_dispatch",
              "experts": "_expert_ffn", "combine": "_moe_combine"}
LM_BATCH, LM_PROMPT, LM_NEW = 4, 2048, 32
# whisper-base (6 encoder + 6 decoder layers, d 512, 8 heads of 64) at full
# width and depth: 16 clips of 1500 frame embeddings (the audio frontend is
# a stub in both packages), a 224-token prompt and 32 new tokens, 256 of
# the published model's 448 text positions; its card-vs-CPU phase at full
# depth, 2 clips and a 64-token prompt
LM_WHISPER_ARCH = "whisper-base"
LM_WHISPER_BATCH, LM_WHISPER_PROMPT = 16, 224
LM_WHISPER_CPU_BATCH, LM_WHISPER_CPU_PROMPT = 2, 64
# the stages of an encoder-decoder prefill, each timed on the device as a
# profiler range (the rest: the embedding, the final norm and the LM head)
WHISPER_STAGES = {"encoder": "_run_encoder", "decoder": "_run_decoder"}
# prefill logits vs a train-mode forward of the same prompt: the same
# kernels on the same inputs, so equal up to bf16 rounding of the logits
# (|logit| < 8 here, one bf16 ulp there is 2^-5)
LM_TEACHER_TOL = 0.0625
# the card's engine vs the CPU engine at 2 layers: every activation is
# rounded to bf16 after sums taken in another order on each side; four
# bf16 ulps at |logit| < 8
LM_CPU_TOL = 0.125


def emit(kind: str, **fields) -> None:
    print(json.dumps({"phase": kind, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def nvidia_smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def device_ms(fn, device, reps: int = REPS,
              sleep_cycles: int = 2_000_000, warmup: int = 3) -> float:
    """Median device time of ``fn()`` in ms over ``reps`` runs after
    ``warmup`` untimed ones. On a card each run is queued behind a sleep
    kernel (~1 ms by default), so the event pair brackets the device work
    and not Python's enqueue time."""
    import torch
    if device.type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(sleep_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


# the kernel of torch.cuda._sleep, which brackets each profiled run
MARKER = "spin_kernel"


def is_marker(evt) -> bool:
    return MARKER in evt.key


def profile_session(run, cuda: bool = True, cpu: bool = True,
                    tries: int = 6, expect=None):
    """``(profile, run())``: ``run()`` inside a torch.profiler session that
    kept all of its device events, as far as can be seen. The tracer now and
    then drops a session's device events, all of them, those from its
    start or those of the kernel between the markers, so ``run()`` is
    bracketed by two short marker kernels (``MARKER``; readers skip them
    with ``is_marker``), and a session that did not keep both, or (with
    ``expect``, a text or a tuple of texts) kept no device event whose
    name holds it, or one of them, or (with ``expect`` a dict of text, or
    tuple of texts, to count) fewer than that count of events whose name
    holds the text, or one of the texts, for one of its keys, runs
    ``run()`` again, up to ``tries`` sessions, with one ``run()`` outside
    the profiler before each retry (late in a long process three sessions
    in a row once dropped a flash kernel's events, and one session kept 31
    of a prefill's 32 flash launches; 120 sessions of a fresh process
    dropped none); after that the last session is returned, and a check
    that reads it fails. ``cuda=False`` traces the CPU alone, once."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = ([ProfilerActivity.CPU] if cpu else []) + (
        [ProfilerActivity.CUDA] if cuda else [])
    expect = ({expect: 1} if isinstance(expect, str) else
              dict(expect) if isinstance(expect, dict) else
              dict.fromkeys(expect or (), 1))
    for attempt in range(tries if cuda else 1):
        if attempt:
            run()
        if cuda:
            torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            if cuda:
                torch.cuda._sleep(1000)
            out = run()
            if cuda:
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()
        kept = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        if not cuda or (sum(e.count for e in kept if is_marker(e)) == 2
                        and all(sum(e.count for e in kept
                                    if any(t in e.key for t in
                                           ((x,) if isinstance(x, str)
                                            else x)))
                                >= n for x, n in expect.items())):
            break
    return prof, out


def event_us(evt) -> float:
    """A profiler event's own device time in us."""
    us = getattr(evt, "self_device_time_total", None)
    return getattr(evt, "self_cuda_time_total", 0.0) if us is None else us


def profiled_ms(fn, symbol: str, n: int = 20, copies: bool = False):
    """The kernel's own device duration per launch, from torch.profiler:
    ``fn()`` n times; every device event must be a kernel whose name holds
    ``symbol`` (so the time is that kernel's and nothing else's), or with
    ``copies`` a host-to-device copy of the call's operands, left out. The
    time is over the events the profiler kept; None (not measured) if
    every session of ``profile_session`` kept none."""
    import torch
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    prof, _ = profile_session(lambda: [fn() for _ in range(n)], cpu=False)
    total, count = 0.0, 0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA or is_marker(evt) or (
                copies and evt.key.startswith("Memcpy HtoD")):
            continue
        check(symbol in evt.key, f"{evt.key[:80]} ran beside {symbol}")
        total += event_us(evt)
        count += evt.count
    return total / 1e3 / count if count else None


def ex2_per_s() -> float:
    """Exponentials a second of the special-function units of card 0 at
    its maximum SM clock."""
    import torch
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    mhz = float(res.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return EX2_PER_CLOCK_SM * sms * mhz * 1e6


def bound(bytes_moved: float, ops: float, int8_ops: float = 0.0,
          bf16_ops: float = 0.0, exps: float = 0.0) -> tuple:
    """Least time in ms: bytes over the memory rate against the float32
    operations over the FFMA peak plus the int8 MACs over the int8 peak
    plus the bf16 tensor-core operations over the bf16 peak, or against the
    exponentials over the special-function units' rate (``ex2_per_s``),
    which run beside those units, where that is longer."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = (ops / FP32_FLOPS + int8_ops / INT8_OPS
             + bf16_ops / BF16_OPS) * 1e3
    if exps:
        t_ops = max(t_ops, exps / ex2_per_s() * 1e3)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def visible_pairs(s: int, causal: bool, window: int = 0,
                  kv_seq: int = 0) -> int:
    """(q, kv) pairs one head of length s attends to: row i sees the keys
    j <= i (causal) with i - j < window (a window > 0); non-causal without
    a window, every one of ``kv_seq`` keys (s where 0)."""
    if not causal:
        if window <= 0:
            return s * (kv_seq or s)
        # row i sees j in (i - window, s): min(s, s - i + window - 1) keys
        return sum(min(s, s - i + window - 1) for i in range(s))
    w = s if window <= 0 else min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def flash_work(geom: dict) -> dict:
    """What one flash call at ``geom`` must do: every visible (q, kv) pair
    (inside the window, where the geometry has one) takes a product of D
    multiply-adds (the score) and one of Dv (the output; Dv is
    ``v_dim``, D where the geometry has none) and one exponential; each
    input is read once and the output written once (q and o at ``seq``
    rows, k and v at ``kv_seq``, ``seq`` where the geometry has none).
    With the bound (``bound``)."""
    b, s, h, hkv, d = (geom[x] for x in ("batch", "seq", "heads",
                                         "kv_heads", "head_dim"))
    dv, sk = geom.get("v_dim", d), geom.get("kv_seq", s)
    pairs = b * h * visible_pairs(s, geom["causal"], geom.get("window", 0),
                                  sk)
    size = 2 if geom["dtype"] == "bfloat16" else 4
    work = dict(flops=2 * pairs * (d + dv), exps=pairs,
                bytes=(b * s * h + b * sk * hkv) * (d + dv) * size)
    if geom["dtype"] == "bfloat16":
        t, by = bound(work["bytes"], 0.0, bf16_ops=work["flops"],
                      exps=pairs)
    else:
        t, by = bound(work["bytes"], work["flops"], exps=pairs)
    return {**work, "bound_ms": t, "bound_by": by}


def check_path_counts(counts: dict, path: str, kernels=None) -> None:
    """The kernels of ``path`` (or ``kernels``) launched, and no other
    wrapper did."""
    for name, cnt in counts.items():
        if name in (kernels or PATH_KERNELS[path]):
            check(cnt >= 1, f"{name} was not launched on the {path} path")
        else:
            check(cnt == 0, f"{name} launched {cnt} times on the {path} path")


def max_abs(a, b) -> float:
    return float((a - b).abs().max())


def row_rel_err(out, ref) -> float:
    """Largest over the rows (last axis) of max |out - ref| / RMS(ref)."""
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs().amax(dim=-1)
    rms = ref.square().mean(dim=-1).sqrt().clamp_min(1e-30)
    return float((diff / rms).max())


def assert_draws(acts, q, bits, max_frac: float = 1e-3) -> int:
    """Word-boundary rule: draws that differ from ``bits * 2^-16 < q`` must
    be rare and sit within one uint16 word of q. Returns the mismatches."""
    import torch
    expected = (bits.to(torch.float32) * (1.0 / 65536) < q).to(torch.float32)
    mismatch = acts != expected
    n = int(mismatch.sum())
    check(n <= max(8, max_frac * acts.numel()),
          f"{n} draw mismatches: beyond word-boundary noise")
    if n:
        near = (q.double() * 65536.0 - bits.double()).abs() <= 1.0
        check(not bool((mismatch & ~near).any()),
              "draw mismatch away from the uint16 word boundary")
    return n


def frontend_edges(backend: str, fcfg, params, frames, key):
    """Where a binary activation of ``backend`` may differ between two
    devices, from the CPU's stages of that backend (``backends._stages``):
    ideal / analog where z lies within 4 float32 ulps of the Hoyer
    threshold, device where one of a neuron's uniforms lies within
    ``DRAW_EDGE`` of its switching probability (each MTJ's, at the chip's
    corners where ``fcfg`` or ``params`` hold a chip). ``fcfg`` is the
    ``FrontendConfig``."""
    import torch
    from repro_torch import prng
    from repro_torch.core import hoyer
    from repro_torch.frontend import backends
    st = backends._stages(backend, fcfg, params, frames)
    if backend == "device":
        p_dev = st["p_dev"]
        unif = prng.uniform(key, tuple(p_dev.shape))
        return ((unif - p_dev).abs() < DRAW_EDGE).any(dim=-1)
    v_th = params["v_th"]
    z = st["u"] / torch.clamp(v_th, min=1e-6)
    thr = float(hoyer.effective_threshold(st["u"], v_th))
    return (z - thr).abs() <= THRESHOLD_ULPS_REL * max(abs(thr), 1.0)


def assert_edge_mismatches(acts, ref, allowed) -> int:
    """Binary maps that may differ only where ``allowed``, in at most
    ``MAX_EDGE_FRAC`` of the elements. Returns the mismatches."""
    mismatch = acts.cpu() != ref.cpu()
    n = int(mismatch.sum())
    check(n <= MAX_EDGE_FRAC * acts.numel(),
          f"{n} activation mismatches: beyond edge noise")
    check(not bool((mismatch & ~allowed).any()),
          "an activation differs away from its edge")
    return n


def grid_inputs(gen, k: int, c: int, b: int, h: int, w: int):
    """Power-of-two grid operands: integer * 2^-9 weights with +-127 pinned
    in every channel (every packed int8 scale is exactly 2^-9) and frames on
    the 1/128 grid, so both MACs are exact at either precision."""
    import torch
    w_int = torch.randint(-126, 127, (k, k, 3, c), generator=gen)
    w_int[0, 0, 0, :], w_int[0, 0, 1, :] = 127, -127
    frames = torch.randint(0, 128, (b, h, w, 3), generator=gen) / 128.0
    return w_int.to(torch.float32) * 2.0 ** -9, frames.to(torch.float32)


def kernel_checks(geom: dict, device) -> dict:
    """Hold the seven kernels against their plain versions and each other at
    one geometry, on operands drawn from a fixed seed. Returns the operands,
    the kernels' outputs that later checks compare, each kernel's checks
    and its largest error against its plain version."""
    import torch
    from repro_torch import prng
    from repro_torch.core import p2m
    from repro_torch.kernels import blocking, ops
    from repro_torch.kernels import p2m_conv as pk

    gen = torch.Generator().manual_seed(7)
    b, h, w, k, s, c = (geom[x] for x in ("batch", "h", "w", "kernel",
                                          "stride", "c"))
    images = torch.rand((b, h, w, 3), generator=gen).to(device)
    wt = torch.randn((k, k, 3, c), generator=gen) * (2.0 / (k * k * 3)) ** 0.5
    wq = p2m.quantize_weights(wt, 4).to(device)
    wm = pk.pack_phase_weights(wq.reshape(k * k * 3, c)).contiguous()
    v_th = torch.ones((), device=device)
    key = prng.fold_in(prng.PRNGKey(3), 5)
    ho, wo = blocking.conv_out_hw(h, s), blocking.conv_out_hw(w, s)
    n, kk = b * ho * wo, k * k * 3
    tag = f"{b}x{h}x{w}x3 k{k} s{s} -> ({n}, {c})"
    kw = dict(kernel=k, stride=s)
    bits = pk.draw_bits(key, n, c, device=device)

    def theta_rel(hp, hp_p):
        t, t_p = (pk.combine_hoyer_partials(x, v_th) for x in (hp, hp_p))
        return abs(float(t) - float(t_p)) / abs(float(t_p))

    # kernel A
    u, hp = pk.p2m_phase_a_implicit(images, wm, v_th, **kw)
    u_p, hp_p = pk.p2m_phase_a_implicit_plain(images, wm, v_th, **kw)
    err_u = max_abs(u, u_p)
    theta = pk.combine_hoyer_partials(hp, v_th)
    check(err_u <= 3e-6, f"kernel A u error {err_u} > 3e-6 at {tag}")
    rel_theta = theta_rel(hp, hp_p)
    check(rel_theta <= 1e-5, f"kernel A theta rel error {rel_theta} at {tag}")

    # kernel B on A's u and theta
    acts, vp = pk.p2m_phase_b(u, theta, key)
    q, v = pk.device_chain_q(u, theta, None)
    acts_p, vp_p = pk.p2m_phase_b_plain(u, theta, key)
    flips_b = assert_draws(acts, q, bits)
    v_k = pk.combine_v_conv_partials(vp, n, c)
    v_p = pk.combine_v_conv_partials(vp_p, n, c)
    for name in v_k:
        check(abs(float(v_k[name]) - float(v_p[name])) <= 1e-5,
              f"kernel B {name} differs at {tag}")

    # fused kernel at the exact path's theta: A -> B bit for bit
    acts_f, hf, vf, rf = pk.p2m_fused_stream(images, wm, v_th, theta, key,
                                             **kw)
    check(torch.equal(acts_f, acts), f"pinned-theta fused != A -> B at {tag}")
    theta_f = pk.combine_hoyer_partials(hf, v_th)
    check(torch.equal(theta_f, theta), f"fused fresh theta != A's at {tag}")
    check(torch.equal(rf.sum(0), acts_f.sum(0)), f"fused rates wrong at {tag}")
    acts_fp = pk.p2m_fused_stream_plain(images, wm, v_th, theta, key, **kw)[0]
    flips_f = assert_draws(acts_f, pk.device_chain_q(u_p, theta, None)[0],
                           bits)

    # int8 kernel A, on uniform and on 1/256-grid frames (x * 128 lands on
    # .5 there: the kernel must round half to even, as the plain version)
    w8, dq = ops.quantize_frontend_weights(wm)
    u8, hp8 = pk.p2m_phase_a_implicit_q8(images, w8, dq, v_th, **kw)
    u8_p, hp8_p = pk.p2m_phase_a_implicit_q8_plain(images, w8, dq, v_th, **kw)
    err_u8 = max_abs(u8, u8_p)
    rel_theta8 = theta_rel(hp8, hp8_p)
    check(err_u8 <= 3e-6, f"int8 kernel A u error {err_u8} > 3e-6 at {tag}")
    check(rel_theta8 <= 1e-5, f"int8 kernel A theta rel error {rel_theta8}")
    img256 = (torch.randint(0, 257, (b, h, w, 3), generator=gen)
              / 256.0).to(torch.float32).to(device)
    ug, hg = pk.p2m_phase_a_implicit_q8(img256, w8, dq, v_th, **kw)
    ug_p, hg_p = pk.p2m_phase_a_implicit_q8_plain(img256, w8, dq, v_th, **kw)
    err_u8_grid = max_abs(ug, ug_p)
    rel_theta8_grid = theta_rel(hg, hg_p)
    check(err_u8_grid <= 3e-6 and rel_theta8_grid <= 1e-5,
          f"int8 kernel A on 1/256-grid frames: u {err_u8_grid}, theta "
          f"{rel_theta8_grid} at {tag}")
    theta8 = pk.combine_hoyer_partials(hp8, v_th)

    # int8 fused at the int8 theta: int8 A -> B bit for bit
    acts8, _ = pk.p2m_phase_b(u8, theta8, key)
    acts8_f, hf8, _, rf8 = pk.p2m_fused_stream_q8(images, w8, dq, v_th,
                                                  theta8, key, **kw)
    check(torch.equal(acts8_f, acts8),
          f"pinned-theta int8 fused != int8 A -> B at {tag}")
    check(torch.equal(pk.combine_hoyer_partials(hf8, v_th), theta8),
          f"int8 fused fresh theta != int8 A's at {tag}")
    check(torch.equal(rf8.sum(0), acts8_f.sum(0)),
          f"int8 fused rates wrong at {tag}")
    acts8_fp = pk.p2m_fused_stream_q8_plain(images, w8, dq, v_th, theta8, key,
                                            **kw)[0]
    flips_f8 = assert_draws(acts8_f, pk.device_chain_q(u8_p, theta8,
                                                       None)[0], bits)

    # power-of-two grid: int8 == f32, u and fused draws bit for bit
    wg, img_g = grid_inputs(gen, k, c, b, h, w)
    wmg = pk.pack_phase_weights(wg.reshape(kk, c)).to(device).contiguous()
    img_g = img_g.to(device)
    w8g, dqg = ops.quantize_frontend_weights(wmg)
    u32g = pk.p2m_phase_a_implicit(img_g, wmg, v_th, **kw)[0]
    u8g = pk.p2m_phase_a_implicit_q8(img_g, w8g, dqg, v_th, **kw)[0]
    check(torch.equal(u8g, u32g), f"grid inputs: int8 u != f32 u at {tag}")
    th7 = torch.tensor(0.7, device=device)
    check(torch.equal(
        pk.p2m_fused_stream_q8(img_g, w8g, dqg, v_th, th7, key, **kw)[0],
        pk.p2m_fused_stream(img_g, wmg, v_th, th7, key, **kw)[0]),
        f"grid inputs: int8 fused draws != f32 fused draws at {tag}")

    # explicit kernel A == implicit kernel A; legacy at A's theta == fused
    patches = ops.im2col(images, k, s).contiguous()
    ue, he = pk.p2m_phase_a(patches, wm, v_th)
    check(torch.equal(ue, u) and torch.equal(he, hp),
          f"explicit kernel A != implicit kernel A at {tag}")
    ue_p, he_p = pk.p2m_phase_a_plain(patches, wm, v_th)
    err_ue = max_abs(ue, ue_p)
    rel_theta_e = theta_rel(he, he_p)
    check(err_ue <= 3e-6 and rel_theta_e <= 1e-5,
          f"explicit kernel A: u {err_ue}, theta {rel_theta_e} at {tag}")
    acts_l = pk.p2m_conv(patches, wm, theta, key)
    check(torch.equal(acts_l, acts_f),
          f"legacy kernel at A's theta != pinned-theta fused at {tag}")
    acts_lp = pk.p2m_conv_plain(patches, wm, theta, key)
    flips_l = assert_draws(acts_l, pk.device_chain_q(ue_p, theta, None)[0],
                           bits)

    checks = {
        "p2m_phase_a_implicit": dict(max_abs_err_u=err_u,
                                     theta_rel_err=rel_theta),
        "p2m_phase_b": dict(draw_mismatches=flips_b,
                            v_conv={k_: float(v_) for k_, v_ in v_k.items()}),
        "p2m_fused_stream": dict(draw_mismatches_vs_plain=flips_f,
                                 pinned_theta_equals_two_kernel=True),
        "p2m_phase_a_implicit_q8": dict(
            max_abs_err_u=err_u8, theta_rel_err=rel_theta8,
            grid256_max_abs_err_u=err_u8_grid,
            grid256_theta_rel_err=rel_theta8_grid,
            pow2_grid_u_equals_f32=True),
        "p2m_fused_stream_q8": dict(draw_mismatches_vs_plain=flips_f8,
                                    pinned_theta_equals_two_kernel=True,
                                    pow2_grid_draws_equal_f32=True),
        "p2m_phase_a": dict(max_abs_err_u=err_ue, theta_rel_err=rel_theta_e,
                            equals_implicit_a=True),
        "p2m_conv": dict(draw_mismatches_vs_plain=flips_l,
                         equals_pinned_theta_fused=True),
    }
    errors = {"p2m_phase_a_implicit": err_u,
              "p2m_phase_b": max_abs(acts, acts_p),
              "p2m_fused_stream": max_abs(acts_f, acts_fp),
              "p2m_phase_a_implicit_q8": err_u8,
              "p2m_fused_stream_q8": max_abs(acts8_f, acts8_fp),
              "p2m_phase_a": err_ue, "p2m_conv": max_abs(acts_l, acts_lp)}
    return dict(tag=tag, images=images, wm=wm, w8=w8, dq=dq, v_th=v_th,
                key=key, kw=kw, theta=theta, theta8=theta8, u=u, u8=u8,
                patches=patches, acts_f=acts_f, acts8_f=acts8_f,
                checks=checks, errors=errors)


def kernel_phase(geom: dict, device, plain_reps: int = REPS):
    """Check the seven kernels at one geometry (``kernel_checks``) and time
    each beside its plain version (median of ``plain_reps``), its bound and,
    where one PyTorch call computes the same function, that call; returns
    one summary row per kernel."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import p2m
    from repro_torch.kernels import blocking, cuda_lib
    from repro_torch.kernels import p2m_conv as pk

    x = kernel_checks(geom, device)
    h, w, k, s, c = (geom[n_] for n_ in ("h", "w", "kernel", "stride", "c"))
    images, wm, w8, dq, v_th, key, kw, theta, theta8, u, patches = (
        x[n_] for n_ in ("images", "wm", "w8", "dq", "v_th", "key", "kw",
                         "theta", "theta8", "u", "patches"))
    n, kk = u.shape[0], k * k * 3

    # device times and bounds (each input read once, each output written
    # once; operations: the MACs plus the per-element estimates above). The
    # statistics count as one set, what the function returns: the Hoyer
    # sums (2), the V stats (3) and the per-channel draw counts (C). How
    # many partial rows a kernel writes on the way is its own layout choice
    # and no part of the least time.
    f32 = 4
    img_bytes, w_bytes = images.numel() * f32, wm.numel() * f32
    w8_bytes = w8.numel() + dq.numel() * f32
    chan_bytes = 4 * c * f32
    out_bytes = n * c * f32
    macs = 2 * n * kk * 2 * c                       # multiply + add, 2C cols
    epi_a, chain = EPILOGUE_A_OPS * n * c, DEVICE_CHAIN_OPS * n * c
    hoyer_bytes, v_bytes, rate_bytes = 2 * f32, 3 * f32, c * f32
    a_bytes = img_bytes + w_bytes + f32 + out_bytes + hoyer_bytes
    b_bytes = out_bytes * 2 + chan_bytes + f32 + v_bytes
    fu_stats = hoyer_bytes + v_bytes + rate_bytes
    fu_bytes = (img_bytes + w_bytes + chan_bytes + 2 * f32 + out_bytes
                + fu_stats)
    a8_bytes = img_bytes + w8_bytes + f32 + out_bytes + hoyer_bytes
    fu8_bytes = (img_bytes + w8_bytes + chan_bytes + 2 * f32 + out_bytes
                 + fu_stats)
    patch_bytes = patches.numel() * f32
    ae_bytes = patch_bytes + w_bytes + f32 + out_bytes + hoyer_bytes
    l_bytes = patch_bytes + w_bytes + chan_bytes + f32 + out_bytes

    (pt, pb), (pl, pr) = blocking.same_pads(h, w, k, s)
    img_nchw = F.pad(images.permute(0, 3, 1, 2), (pl, pr, pt, pb)).contiguous()
    w_oihw = wm.reshape(k, k, 3, 2 * c).permute(3, 2, 0, 1).contiguous()

    def conv_library():
        # the yardstick for A: one cuDNN conv of the padded frames with the
        # packed 2C weights, TF32 off — the matmul part only
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            F.conv2d(img_nchw, w_oihw, stride=s)

    # the yardstick for int8 A: torch._int_mm of the quantized patch matrix
    # with K zero-padded to a multiple of 32, as it requires
    kpad = -(-kk // 32) * 32
    xq_pad = torch.zeros((n, kpad), dtype=torch.int8, device=device)
    xq_pad[:, :kk] = p2m.quantize_acts_q8(patches)
    w8_pad = torch.zeros((kpad, 2 * c), dtype=torch.int8, device=device)
    w8_pad[:kk] = w8

    def int_mm_library():
        torch._int_mm(xq_pad, w8_pad)

    def matmul_library():
        # the yardstick for explicit A: the patch matmul alone, TF32 off
        torch.matmul(patches, wm)

    # the path each kernel A and the legacy kernel take at this N, as the
    # library chooses it
    p2m_lib = cuda_lib.load()
    f32_a_warp = p2m_lib.p2m_phase_a_warp_tiles(n, 0)
    tile_paths = {name: "warp-owned" if warp else "block-shared"
                  for name, warp in (
                      ("p2m_phase_a_implicit", f32_a_warp),
                      ("p2m_phase_a", f32_a_warp),
                      ("p2m_phase_a_implicit_q8",
                       p2m_lib.p2m_phase_a_warp_tiles(n, 1)),
                      ("p2m_conv", p2m_lib.p2m_conv_warp_tiles(n)))}

    rows = []
    for name, fn, plain, lib, nbytes, ops_f32, ops_i8 in (
            ("p2m_phase_a_implicit",
             lambda: pk.p2m_phase_a_implicit(images, wm, v_th, **kw),
             lambda: pk.p2m_phase_a_implicit_plain(images, wm, v_th, **kw),
             conv_library, a_bytes, macs + epi_a, 0),
            ("p2m_phase_b", lambda: pk.p2m_phase_b(u, theta, key),
             lambda: pk.p2m_phase_b_plain(u, theta, key), None, b_bytes,
             chain, 0),
            ("p2m_fused_stream",
             lambda: pk.p2m_fused_stream(images, wm, v_th, theta, key, **kw),
             lambda: pk.p2m_fused_stream_plain(images, wm, v_th, theta, key,
                                               **kw),
             None, fu_bytes, macs + epi_a + chain, 0),
            ("p2m_phase_a_implicit_q8",
             lambda: pk.p2m_phase_a_implicit_q8(images, w8, dq, v_th, **kw),
             lambda: pk.p2m_phase_a_implicit_q8_plain(images, w8, dq, v_th,
                                                      **kw),
             int_mm_library, a8_bytes, epi_a, macs),
            ("p2m_fused_stream_q8",
             lambda: pk.p2m_fused_stream_q8(images, w8, dq, v_th, theta8, key,
                                            **kw),
             lambda: pk.p2m_fused_stream_q8_plain(images, w8, dq, v_th,
                                                  theta8, key, **kw),
             None, fu8_bytes, epi_a + chain, macs),
            ("p2m_phase_a", lambda: pk.p2m_phase_a(patches, wm, v_th),
             lambda: pk.p2m_phase_a_plain(patches, wm, v_th),
             matmul_library, ae_bytes, macs + epi_a, 0),
            ("p2m_conv", lambda: pk.p2m_conv(patches, wm, theta, key),
             lambda: pk.p2m_conv_plain(patches, wm, theta, key), None,
             l_bytes, macs + chain, 0)):
        t_bound, by = bound(nbytes, ops_f32, ops_i8)
        lib_ms, lib_error = None, None
        if lib is not None:
            try:
                lib_ms = device_ms(lib, device)
            except RuntimeError as exc:      # a yardstick only, never a check
                lib_error = str(exc).splitlines()[0]
        row = {"name": name, "route": "cuda", "source": SOURCE,
               "replaces": REPLACES[name], "launches": 0,
               "max_abs_err": x["errors"][name],
               "ms": device_ms(fn, device),
               "plain_ms": device_ms(plain, device, plain_reps),
               "bound_ms": t_bound, "bound_by": by, "library_ms": lib_ms}
        rows.append(row)
        symbol = KERNEL_SYMBOLS[name]
        if tile_paths.get(name) == "warp-owned":
            symbol = WARP_TILE_SYMBOLS.get(name, symbol)
        emit("kernel", geometry=x["tag"], **{k_: v_ for k_, v_ in row.items()
                                         if k_ != "launches"},
             profiler_ms=profiled_ms(fn, symbol),
             bound_us=t_bound * 1e3, bytes=nbytes, fp32_ops=ops_f32,
             int8_ops=ops_i8, library_error=lib_error,
             **({"tile_path": tile_paths[name]} if name in tile_paths else {}),
             **x["checks"][name])
    return rows


def compare_with_cpu(cfg, params, frames, out, stream_outs, device,
                     precision: str, backend: str = "cuda"):
    """The same engine on the CPU, step by step: the classify and, off the
    ``cuda`` backend, every stream step (a ``cuda`` stream runs fused at a
    carried theta and is checked by the kernel lines). In each step the
    frontend draws by the word-boundary rule (``cuda``) or the edge rule
    (``ideal`` / ``analog`` / ``device``), then the probs on the frames
    where every frontend activation agrees and no backbone unit flipped
    (``backbone_flips``). ``params`` are the engine's, a programmed trim
    included. Returns the comparison."""
    import torch
    from repro_torch import prng
    from repro_torch.core import p2m
    from repro_torch.frontend import SensorFrontend
    from repro_torch.kernels import ops
    from repro_torch.kernels import p2m_conv as pk
    from repro_torch.models import params as mparams
    from repro_torch.serving import VisionEngine

    from repro_torch.frontend import backends

    cpu = torch.device("cpu")
    params_cpu = mparams.to_device(params, cpu)
    engine_cpu = VisionEngine(cfg, params_cpu, backend=backend, seed=0,
                              device=cpu)
    # the chip rows the cuda backend serves (a CPU-sampled chip: ulps from
    # the card's), None for the nominal chip
    chan_cpu = backends._chip_rows(cfg.frontend, params_cpu["p2m"], cpu)
    steps = [(frames[0], out, engine_cpu.classify(frames[0]))]
    if backend != "cuda":
        batches = frames[1:1 + len(stream_outs)]
        steps += zip(batches, stream_outs, engine_cpu.stream(batches))
    fe = SensorFrontend(cfg.frontend)
    rows = []
    for j, (x, o, o_cpu) in enumerate(steps):
        key = prng.fold_in(prng.PRNGKey(0), j)    # the engine's frame key
        acts_dev, aux_dev = fe(params["p2m"], x.to(device), key=key,
                               mode=backend)
        acts_cpu, aux_cpu = fe(params_cpu["p2m"], x, key=key, mode=backend)
        if backend == "cuda":
            wq = p2m.quantize_weights(params_cpu["p2m"]["w"], 4)
            wm = pk.pack_phase_weights(wq.reshape(27, 32))
            v_th = params_cpu["p2m"]["v_th"]
            if precision == "int8":
                w8, dq = ops.quantize_frontend_weights(wm)
                u_cpu, _ = pk.p2m_phase_a_implicit_q8_plain(
                    x, w8, dq, v_th, kernel=3, stride=2)
            else:
                u_cpu, _ = pk.p2m_phase_a_implicit_plain(x, wm, v_th,
                                                         kernel=3, stride=2)
            q_cpu = pk.device_chain_q(u_cpu, aux_cpu["theta"], chan_cpu)[0]
            bits = pk.draw_bits(key, u_cpu.shape[0], 32)
            flips = assert_draws(acts_dev.cpu().reshape(-1, 32), q_cpu, bits)
        else:
            flips = assert_edge_mismatches(
                acts_dev, acts_cpu, frontend_edges(backend, cfg.frontend,
                                                   params_cpu["p2m"], x, key))
        equal = (acts_dev.cpu() == acts_cpu).reshape(x.shape[0], -1).all(1)
        flipped, layers, max_ulps = backbone_flips(cfg, params, params_cpu,
                                                   acts_cpu, device)
        same = equal & ~flipped
        probs_err = float((o["probs"].cpu() - o_cpu["probs"])[same].abs()
                          .max()) if bool(same.any()) else None
        step = "classify" if j == 0 else f"stream step {j}"
        check(probs_err is None or probs_err <= 1e-3,
              f"{step}: probs differ from the CPU engine by {probs_err}")
        check(int(same.sum()) >= 12,
              f"{step}: frontend or backbone differs on most frames")
        rows.append(dict(frontend_draw_mismatches=flips,
                         frames_with_equal_frontend=int(equal.sum()),
                         backbone_unit_flips=layers,
                         backbone_flip_max_ulps=max_ulps,
                         frames_with_backbone_flips=int(flipped.sum()),
                         frames_compared=int(same.sum()),
                         max_probs_err_on_those=probs_err,
                         labels_equal=int((o["labels"].cpu()
                                           == o_cpu["labels"]).sum()),
                         theta_dev=float(aux_dev["theta"]),
                         theta_cpu=float(aux_cpu["theta"])))
    return {**rows[0], "stream_steps": rows[1:]}


def backbone_flips(cfg, params, params_cpu, acts_cpu, device):
    """The vgg backbone layer by layer on the card and on the CPU, every
    layer fed the CPU's input on both sides (from the CPU's frontend map).
    A binary unit may differ only where its raw z lies within 4 float32
    ulps of its per-example threshold on the CPU, where convs that sum in
    another order may put it on either side (the rule of
    ``tests/test_torch_vision.py``); anywhere else is a fault. The card's
    engine fed the same map runs exactly these layers wherever no unit
    flipped. Returns (a bool per frame: a unit flipped, the flips of each
    layer that had any, the largest distance of a flipped unit's z from
    its threshold in float32 ulps of max(|thr|, 1))."""
    import torch
    from repro_torch.models import vision
    check(cfg.arch.startswith("vgg"), f"backbone_flips: {cfg.arch}")
    bits = cfg.weight_bits
    x = acts_cpu.permute(0, 3, 1, 2)
    flipped = torch.zeros(x.shape[0], dtype=torch.bool)
    layers, max_ulps = {}, 0.0
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                     allow_tf32=False):
        for name, pools in vision.vgg_stages(cfg):
            x = vision.pooled(x, pools)
            if name == "head":
                break
            lp_cpu = params_cpu["layers"][name]
            out = vision._conv_apply(lp_cpu, x, 1, bits)[0]
            out_dev = vision._conv_apply(params["layers"][name],
                                         x.to(device), 1, bits)[0].cpu()
            z, _, thr = vision._spike_terms(
                lp_cpu, vision._conv_bn(lp_cpu, x, 1, bits)[0])
            diff = out_dev != out
            dist = (z - thr).abs() / thr.abs().clamp(min=1.0)
            check(not bool((diff & (dist > THRESHOLD_ULPS_REL)).any()),
                  f"backbone {name}: a binary unit differs on the card "
                  "away from its threshold")
            flipped |= diff.reshape(diff.shape[0], -1).any(dim=1)
            if bool(diff.any()):
                layers[name] = int(diff.sum())
                max_ulps = max(max_ulps, float(dist[diff].max())
                               / torch.finfo(torch.float32).eps)
            x = out
    return flipped, layers, max_ulps


def vision_engine(device, cfg=None, **engine_kw):
    """Full-width vgg16 at CIFAR-10 geometry (``cfg``, by default the
    nominal chip's) with seeded random weights, five seeded batches of 16
    frames, and an engine over them: returns (cfg, params, frames,
    engine)."""
    import torch
    from repro_torch.models import vision
    from repro_torch.serving import VisionEngine

    cfg = cfg or vision.VisionConfig()   # vgg16, CIFAR-10 geometry
    params = vision.init_params(0, cfg, device=device)
    gen = torch.Generator().manual_seed(11)
    frames = [torch.rand((16, 32, 32, 3), generator=gen) for _ in range(5)]
    engine = VisionEngine(cfg, params, seed=0, device=device, microbatch=16,
                          **engine_kw)
    return cfg, params, frames, engine


def engine_run(device, path: str, cfg=None, **engine_kw):
    """Full-width vgg16 (``vision_engine``'s ``cfg``) through classify and a
    4-batch stream, the launch counts read from that run alone; then the
    CPU comparison and the steady-state walls. Emits one ``path`` line and
    one ``<path>_steady`` line; returns (counts, engine, frames), the
    engine's ``steady_classify_ms`` set to its steady classify wall."""
    import torch
    from repro_torch.kernels import cuda_lib
    from repro_torch.serving import VisionEngine

    backend = engine_kw.get("backend", "cuda")
    cfg, params, frames, engine = vision_engine(device, cfg, **engine_kw)
    cuda_lib.reset_launch_counts()
    out = engine.classify(frames[0])
    stream_outs = list(engine.stream(frames[1:]))
    counts = cuda_lib.launch_counts()
    if device.type == "cuda":
        check_path_counts(counts, path)
    for o in [out, *stream_outs]:
        check(tuple(o["probs"].shape) == (16, 10), "probs shape")
        check(bool(torch.isfinite(o["probs"]).all()), "non-finite probs")
        check(abs(float(o["probs"].sum()) - 16.0) < 1e-3, "probs not normed")
    if backend == "cuda":
        check(engine.fused_step_count >= 1, "no fused stream step ran")
    else:   # off the cuda backend every stream step is exact
        check(engine.fused_step_count == 0
              and all("stream_fused" not in o for o in stream_outs),
              f"a {backend} stream step ran fused")
    precision = "int8" if path == "engine_int8" else "f32"
    vs_cpu = compare_with_cpu(cfg, engine.params, frames, out, stream_outs,
                              device, precision, backend)

    emit(path, model="vgg16", batch=16, backend=backend,
         precision=precision if backend == "cuda" else None,
         launches=counts, classify_wall_ms=out["wall_ms"],
         classify_throughput_fps=out["throughput_fps"],
         stream_wall_ms=[o["wall_ms"] for o in stream_outs],
         stream_fused=[float(o.get("stream_fused", 0.0))
                       for o in stream_outs],
         fused_step_count=engine.fused_step_count,
         fused_fallback_count=engine.fused_fallback_count,
         theta=float(out["theta"]), p2m_sparsity=float(out["p2m_sparsity"]),
         vs_cpu=vs_cpu)

    # steady-state walls after the counted run (the first steps above
    # include cuDNN's first-use set-up)
    walls = [engine.classify(frames[0])["wall_ms"] for _ in range(20)]
    engine_s = VisionEngine(cfg, params, seed=0, device=device, microbatch=16,
                            fused_theta_tol=1e9, **engine_kw)
    steady_ms = statistics.median(walls)
    steps = list(engine_s.stream([frames[1]] * 21))[1:]
    step_key = ("fused_step_wall_ms_median" if backend == "cuda"
                else "stream_step_wall_ms_median")
    emit(f"{path}_steady", model="vgg16", batch=16, backend=backend,
         precision=precision if backend == "cuda" else None,
         classify_wall_ms_median=steady_ms,
         classify_fps_median=16 / (steady_ms / 1e3),
         **{step_key: statistics.median(o["wall_ms"] for o in steps)},
         fused_steps=engine_s.fused_step_count)
    engine.steady_classify_ms = steady_ms
    return counts, engine, frames


def engine_int8_phase(device):
    """The int8 serving path: a port tile table written with int8 at the
    serving key, loaded by ``VisionEngine(tile_table=...)``; then its
    ``profile`` line."""
    from repro_torch.kernels import autotune
    table = os.path.join(ROOT, "build", "repro_torch", "smoke_tiles_int8.json")
    os.makedirs(os.path.dirname(table), exist_ok=True)
    autotune.clear()
    autotune.put(*SERVING_KEY, autotune.TileChoice(fused=True,
                                                   precision="int8"))
    autotune.save_table(table)
    autotune.clear()
    counts, engine, frames = engine_run(device, "engine_int8",
                                        tile_table=table)
    check(autotune.lookup(*SERVING_KEY).precision == "int8",
          "the int8 table was not in force")
    profile_phase(engine, frames, device, "int8")
    return counts


def baseline_phase(device):
    """The double-conv baseline at the serving shape: explicit kernel A over
    a materialised im2col matrix for theta, then the legacy kernel through
    ``ops.p2m_conv``. Held against the exact f32 path, which it must equal
    bit for bit; returns its launch counts."""
    import torch
    from repro_torch import prng
    from repro_torch.core import p2m
    from repro_torch.kernels import cuda_lib, ops
    from repro_torch.kernels import p2m_conv as pk
    from repro_torch.models import vision

    cfg = vision.VisionConfig()
    params = vision.init_params(0, cfg, device=device)["p2m"]
    frames = torch.rand((16, 32, 32, 3), generator=torch.Generator()
                        .manual_seed(13)).to(device)
    key = prng.fold_in(prng.PRNGKey(0), 1)
    wq = p2m.quantize_weights(params["w"], 4)
    wm = pk.pack_phase_weights(wq.reshape(27, 32)).contiguous()
    v_th = params["v_th"]

    def step():
        patches = ops.im2col(frames, 3, 2).contiguous()
        _, hp = pk.p2m_phase_a(patches, wm, v_th)
        theta = pk.combine_hoyer_partials(hp, v_th)
        return ops.p2m_conv(frames, wq, theta, key), theta

    cuda_lib.reset_launch_counts()
    acts, theta = step()
    counts = cuda_lib.launch_counts()
    check_path_counts(counts, "baseline")
    acts_x, aux_x = ops.p2m_frontend(frames, wq, v_th, key, precision="f32")
    check(torch.equal(theta, aux_x["theta"]), "baseline theta != exact theta")
    check(torch.equal(acts, acts_x), "baseline draws != exact path draws")
    emit("baseline", shape=list(SERVING_KEY), launches=counts,
         equals_exact_path=True,
         step_device_ms=device_ms(step, device),
         exact_path_device_ms=device_ms(
             lambda: ops.p2m_frontend(frames, wq, v_th, key,
                                      precision="f32"), device))
    return counts


def autotune_phase(device, smi: str):
    """The port's search at the serving shape: data, not a check."""
    import torch
    from repro_torch import prng
    from repro_torch.core import p2m
    from repro_torch.kernels import autotune
    from repro_torch.models import vision

    cfg = vision.VisionConfig()
    params = vision.init_params(0, cfg, device=device)["p2m"]
    frames = torch.rand((16, 32, 32, 3), generator=torch.Generator()
                        .manual_seed(17)).to(device)
    wq = p2m.quantize_weights(params["w"], 4)
    choice, report = autotune.autotune_frontend(
        frames, wq, params["v_th"], prng.PRNGKey(2), repeats=30, store=False)
    emit("autotune", shape=list(SERVING_KEY), choice=choice.to_json(),
         report_ms=report, nvidia_smi=smi)


def variation_config():
    """vgg16 at CIFAR-10 geometry on a sampled chip: the profile of
    BENCH_variation.json ("profile") at sigma scale 1.0, chip
    ``VARIATION_CHIP``."""
    from repro_torch.models import vision
    from repro_torch.variation import VariationConfig
    with open(os.path.join(ROOT, "BENCH_variation.json")) as f:
        profile = json.load(f)["profile"]
    return vision.VisionConfig(variation=VariationConfig(**profile),
                               chip_id=VARIATION_CHIP)


def variation_phase(device, smi: str, nominal_steady_ms: float):
    """A sampled chip calibrated and served on the card. ``calibrate`` on
    16 frames on the card and on the CPU (trims within 8 bisection steps;
    the card's walls); then ``VisionEngine(calibration=)`` with the
    ``cuda`` backend (``engine_variation``: A, B and fused launch, the
    steps held against the CPU engine) and with the ``device`` backend
    (``engine_variation_device``), each through ``engine_run``; one
    ``variation`` line with both steady classify walls beside the nominal
    engine's of the same run."""
    import torch
    from repro_torch.models import params as mparams
    from repro_torch.models import vision
    from repro_torch.variation import calibrate

    from repro_torch.kernels import autotune

    # the int8 phase's table is still in force: serve the f32 path
    autotune.clear()
    cpu = torch.device("cpu")
    cfg = variation_config()
    params = vision.init_params(0, cfg, device=device)
    frames = torch.rand((16, 32, 32, 3), generator=torch.Generator()
                        .manual_seed(23))
    kw = dict(chip_id=VARIATION_CHIP, iters=CAL_ITERS, span=CAL_SPAN)
    walls = []
    for _ in range(3):      # the first call samples the chip and warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        art = calibrate(params["p2m"], cfg.p2m, cfg.variation, frames,
                        device=device, **kw)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    art_cpu = calibrate(mparams.to_device(params["p2m"], cpu), cfg.p2m,
                        cfg.variation, frames, device=cpu, **kw)
    cpu_wall = (time.perf_counter() - t0) * 1e3
    check(art.trim.device.type == device.type, "the trim left the card")
    trim_err = max_abs(art.trim.cpu(), art_cpu.trim)
    lsb = CAL_SPAN / 2 ** CAL_ITERS
    check(trim_err <= 8 * lsb,
          f"card trim off the CPU's by {trim_err / lsb} bisection steps")
    err = {k: (float(getattr(art, k).max()), float(getattr(art_cpu, k).max()))
           for k in ("rate_err_before", "rate_err_after")}
    check(err["rate_err_after"][0] < err["rate_err_before"][0],
          f"the trim did not reduce the rate error: {err}")
    emit("calibrate", model="vgg16", chip_id=VARIATION_CHIP, frames=16,
         iters=CAL_ITERS, span=CAL_SPAN, trim_max_abs_err_vs_cpu=trim_err,
         trim_err_steps=trim_err / lsb,
         rate_err_before_max=err["rate_err_before"][0],
         rate_err_after_max=err["rate_err_after"][0],
         rate_err_before_max_cpu=err["rate_err_before"][1],
         rate_err_after_max_cpu=err["rate_err_after"][1],
         calibrate_wall_ms=walls, calibrate_cpu_wall_ms=cpu_wall,
         nvidia_smi=smi)
    _, engine, _ = engine_run(device, "engine_variation", cfg=cfg,
                              calibration=art)
    check(engine.params["p2m"]["cal_trim"].device.type == device.type,
          "the served trim is not on the card")
    _, engine_d, _ = engine_run(device, "engine_variation_device", cfg=cfg,
                                backend="device", calibration=art)
    emit("variation", model="vgg16", chip_id=VARIATION_CHIP,
         cuda_steady_classify_ms=engine.steady_classify_ms,
         device_steady_classify_ms=engine_d.steady_classify_ms,
         nominal_cuda_steady_classify_ms=nominal_steady_ms, nvidia_smi=smi)


def variation_kernels_phase(geom: dict, device) -> None:
    """Kernel B and both fused kernels with the chip operand in each layout
    at one geometry: random (4, C) rows, a random (4, N_pix, C) per-pixel
    map and that map constant across pixels (the rows at every pixel).
    Draws against the plain versions by the word-boundary rule, V partials
    within 1e-5 of the plain ones (kernel B) and of kernel B's on the same
    u (fused), the constant map equal to the (4, C) rows bit for bit; each
    kernel and layout timed (event pair and ``torch.profiler``) beside its
    bound, the per-pixel bound with the map's bytes read once. One
    ``variation_kernel`` line each."""
    import torch
    from repro_torch import prng
    from repro_torch.kernels import blocking, ops
    from repro_torch.kernels import p2m_conv as pk

    gen = torch.Generator().manual_seed(29)
    b, h, w, k, s, c = (geom[x] for x in ("batch", "h", "w", "kernel",
                                          "stride", "c"))
    images = torch.rand((b, h, w, 3), generator=gen).to(device)
    wt = torch.randn((k * k * 3, c), generator=gen) * (2.0 / (k * k * 3)) ** 0.5
    wm = pk.pack_phase_weights(wt).to(device).contiguous()
    w8, dq = ops.quantize_frontend_weights(wm)
    v_th = torch.ones((), device=device)
    key = prng.fold_in(prng.PRNGKey(31), 1)
    kw = dict(kernel=k, stride=s)
    n_pix = blocking.conv_out_hw(h, s) * blocking.conv_out_hw(w, s)
    u, hp = pk.p2m_phase_a_implicit(images, wm, v_th, **kw)
    u8, hp8 = pk.p2m_phase_a_implicit_q8(images, w8, dq, v_th, **kw)
    theta = pk.combine_hoyer_partials(hp, v_th)
    theta8 = pk.combine_hoyer_partials(hp8, v_th)
    n = u.shape[0]
    bits = pk.draw_bits(key, n, c, device=device)

    def rows_of(*shape):
        z = [torch.randn(shape, generator=gen) for _ in range(4)]
        return torch.stack([1.0 + 0.1 * z[0], 0.05 * z[1], 1.0 + 0.1 * z[2],
                            0.3 * z[3]]).to(device).contiguous()

    rows = rows_of(c)
    layouts = {"rows": rows, "pixel": rows_of(n_pix, c),
               "const": rows[:, None, :].expand(4, n_pix, c).contiguous()}
    f32 = 4
    img_bytes, out_bytes = images.numel() * f32, n * c * f32
    w_bytes, w8_bytes = wm.numel() * f32, w8.numel() + dq.numel() * f32
    stats = (2 + 3 + c) * f32
    macs = 2 * n * (k * k * 3) * 2 * c
    epi_a, chain = EPILOGUE_A_OPS * n * c, DEVICE_CHAIN_OPS * n * c
    kernels = {
        "p2m_phase_b": (lambda ch: pk.p2m_phase_b(u, theta, key, chan=ch),
                        u, theta, lambda cb: 2 * out_bytes + cb + 4 * f32,
                        chain, 0),
        "p2m_fused_stream": (
            lambda ch: pk.p2m_fused_stream(images, wm, v_th, theta, key, ch,
                                           **kw),
            u, theta,
            lambda cb: img_bytes + w_bytes + cb + 2 * f32 + out_bytes + stats,
            macs + epi_a + chain, 0),
        "p2m_fused_stream_q8": (
            lambda ch: pk.p2m_fused_stream_q8(images, w8, dq, v_th, theta8,
                                              key, ch, **kw),
            u8, theta8,
            lambda cb: img_bytes + w8_bytes + cb + 2 * f32 + out_bytes + stats,
            epi_a + chain, macs)}
    tag = f"{b}x{h}x{w}x3 k{k} s{s} -> ({n}, {c}), N_pix {n_pix}"
    for name, (fn, uu, th, nbytes, ops_f32, ops_i8) in kernels.items():
        outs = {}
        for layout, chan in layouts.items():
            out = outs[layout] = fn(chan)
            acts = out[0]
            q, v = pk.device_chain_q(uu, th, chan)
            flips = assert_draws(acts, q, bits)
            vp = out[1] if name == "p2m_phase_b" else out[2]
            v_k = pk.combine_v_conv_partials(vp, n, c)
            if name == "p2m_phase_b":
                v_ref = pk.combine_v_conv_partials(pk._v_partials(v), n, c)
            else:
                # the fused kernel at A's theta is A -> B with the same chan
                acts_b, vp_b = pk.p2m_phase_b(uu, th, key, chan=chan)
                check(torch.equal(acts, acts_b),
                      f"{name} {layout}: fused != A -> B at {tag}")
                check(torch.equal(out[3].sum(0), acts.sum(0)),
                      f"{name} {layout}: rates wrong at {tag}")
                v_ref = pk.combine_v_conv_partials(vp_b, n, c)
            v_err = max(abs(float(v_k[x]) - float(v_ref[x])) for x in v_k)
            check(v_err <= 1e-5, f"{name} {layout}: V partials off by "
                  f"{v_err} at {tag}")
            row = {"geometry": tag, "kernel": name, "layout": layout,
                   "draw_mismatches_vs_plain": flips,
                   "v_conv_max_abs_err": v_err}
            if layout == "const":
                check(all(torch.equal(x, y)
                          for x, y in zip(out, outs["rows"])),
                      f"{name}: constant per-pixel map != (4, C) rows at "
                      f"{tag}")
                row["equals_rows_bit_for_bit"] = True
            else:
                moved = nbytes(chan.numel() * f32)
                t_bound, by = bound(moved, ops_f32, ops_i8)
                symbol = (PIXEL_SYMBOLS if layout == "pixel"
                          else KERNEL_SYMBOLS)[name]
                row.update(ms=device_ms(lambda: fn(chan), device),
                           profiler_ms=profiled_ms(lambda: fn(chan), symbol),
                           bound_ms=t_bound, bound_by=by, bytes=moved,
                           kernel_symbol=symbol)
            emit("variation_kernel", **row)


def yield_phase(device, smi: str):
    """``yield_sweep`` of YIELD_CHIPS chips at YIELD_SIGMAS on the card (the
    chips drawn as one stack) against the CPU's: yield fractions equal, the
    error figures at rtol 1e-5 (above 4 ulps of 1), the read margin within
    1e-6 V."""
    import torch
    from repro_torch.variation import yield_sweep

    vcfg = variation_config().variation
    walls = []
    for _ in range(2):          # the first call warms the allocator
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = yield_sweep(vcfg, YIELD_SIGMAS, YIELD_CHIPS, 32, device=device)
        walls.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    rows_cpu = yield_sweep(vcfg, YIELD_SIGMAS, YIELD_CHIPS, 32,
                           device=torch.device("cpu"))
    cpu_wall = (time.perf_counter() - t0) * 1e3
    for r, rc in zip(rows, rows_cpu):
        for k in ("yield_fraction", "yield_fraction_calibrated"):
            check(r[k] == rc[k], f"yield sigma {r['sigma_scale']}: {k} "
                  f"{r[k]} on the card, {rc[k]} on the CPU")
        check(abs(r["read_margin_min_mv"] - rc["read_margin_min_mv"]) * 1e-3
              <= YIELD_MARGIN_ATOL_V, f"read margin: {r} vs {rc}")
        for k in ("fail_worst", "fail_mean", "false_worst", "false_mean",
                  "fail_worst_cal", "false_worst_cal"):
            check(abs(r[k] - rc[k]) <= YIELD_RTOL * abs(rc[k]) + YIELD_ATOL,
                  f"yield sigma {r['sigma_scale']}: {k} {r[k]} vs {rc[k]}")
    emit("yield", chips=YIELD_CHIPS, sigmas=list(YIELD_SIGMAS), rows=rows,
         sweep_wall_ms=walls, cpu_sweep_wall_ms=cpu_wall, nvidia_smi=smi)


# --- sensor lifetime: an aging chip served and refreshed on the card -------

LIFETIME_BATCH = 16
LIFETIME_STREAM = 8         # stream batches of LIFETIME_BATCH after classify
LIFETIME_POLICY = dict(period_frames=64, cal_iters=12)
LIFETIME_STEADY = 20        # steady classifies, aging and plain in turns
# the aged kernel operands: two ages and the reference test's trim
LIFETIME_KERNEL_AGES = (3e2, 1e5)
LIFETIME_STALE_AGE = 10 ** 5
# the fleet grid of BENCH_lifetime.json's bench: 48 chips, 32 calibration
# frames, these ages; the CPU twin runs its first chips at three of them
FLEET_CHIPS, FLEET_FRAMES = 48, 32
FLEET_AGES = (0.0, 3e2, 1e3, 1e4, 3e4, 1e5, 3e5, 1e6)
FLEET_CPU_CHIPS, FLEET_CPU_AGES = 4, (3e2, 1e4, 1e6)
# card vs CPU: the (4, C) rows of an aged chip (the chips drawn on each
# side, within ulps; the age's log1p / sin are the same float32 host
# values on both) relative to max(|row|, 1); a rate error evaluated at the
# same trim (means of 262,144 rows summed in another order, u and theta
# from convs that sum in another order)
LIFETIME_ROWS_TOL = 1e-6
FLEET_ERR_ATOL = 2e-5
ACCURACY_AGES = (0.0, 1e5)
MAINTENANCE_PERIOD = 1e4


def lifetime_config():
    """BENCH_lifetime.json's drift profile (``drift_profile``) as the
    port's ``DriftConfig``, and its rate-error budget."""
    from repro_torch.lifetime import DriftConfig
    with open(os.path.join(ROOT, "BENCH_lifetime.json")) as f:
        bench = json.load(f)
    return DriftConfig(**bench["drift_profile"]), bench["rate_err_budget"]


def aged_rows(engine, age: int, trim):
    """The (4, C) rows an aging engine serves at ``age`` with ``trim``."""
    from repro_torch.variation.chip import channel_operands
    st = engine.lifetime
    return channel_operands(engine._evolve(st.chip0, st.maps, age), trim)


def lifetime_run(engine, frames, device):
    """One classify, then a stream of the other batches, one step each
    (microbatch = batch). Before each step the engine's age and trim are
    read; each refresh is timed and its launch counts read around it.
    Returns (outputs, [(age, trim) before each step], the refreshes'
    walls in ms, launches during refreshes, the steps' host-clock walls)."""
    from repro_torch.kernels import cuda_lib
    sched, st = engine._scheduler, engine.lifetime
    solve = sched.recalibrate
    refresh_ms, refresh_launches = [], []

    def timed(chip):
        before = sum(cuda_lib.launch_counts().values())
        sync(device)
        t0 = time.perf_counter()
        trim = solve(chip)
        sync(device)
        refresh_ms.append((time.perf_counter() - t0) * 1e3)
        refresh_launches.append(sum(cuda_lib.launch_counts().values())
                                - before)
        return trim

    sched.recalibrate = timed
    states, outs, walls = [], [], []
    stream = engine.stream(frames[1:])
    for j in range(len(frames)):
        states.append((st.age_frames, st.trim.clone()))
        sync(device)
        t0 = time.perf_counter()
        outs.append(engine.classify(frames[0]) if j == 0 else next(stream))
        sync(device)
        walls.append((time.perf_counter() - t0) * 1e3)
    check(next(stream, None) is None, "the stream yielded more batches")
    sched.recalibrate = solve
    return outs, states, refresh_ms, refresh_launches, walls


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


def lifetime_engine_phase(device, smi: str, cfg, params, art, cal_frames,
                          dcfg):
    """``engine_lifetime``: full-width vgg16 on the sampled, calibrated
    chip, aging under ``dcfg`` and refreshed every
    ``LIFETIME_POLICY["period_frames"]`` frames, served through ``cuda``:
    one classify and a stream of ``LIFETIME_STREAM`` batches, counted (A,
    B and fused launch; no refresh launches a P2M kernel). The age ends at
    the frames served, the refreshes fire exactly on the period, the trim
    stays on the card, the merge rules hold on the outputs. The same
    engine on the CPU from the same seed: ages and refresh frames equal,
    the aged rows of every step within ``LIFETIME_ROWS_TOL`` at the same
    trim, each refreshed trim within 8 bisection steps; the classify (age
    0) and a replay at the final age against the CPU by
    ``compare_with_cpu``'s rules, fed the step's aged chip and the card's
    trim. Then the steady walls (aging classify and the plain calibrated
    engine's, in turns), what an aging step adds (``_aged_params`` and the
    monitor's copy), and the stale trim against a refresh at 1e5 frames.
    Returns the engine."""
    import torch
    from repro_torch import prng
    from repro_torch.kernels import cuda_lib
    from repro_torch.lifetime import SchedulePolicy
    from repro_torch.models import params as mparams
    from repro_torch.serving import VisionEngine
    from repro_torch.serving.vision import _merge_outputs

    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(41)
    frames = [torch.rand((LIFETIME_BATCH, 32, 32, 3), generator=gen)
              for _ in range(1 + LIFETIME_STREAM)]
    policy = SchedulePolicy(**LIFETIME_POLICY)
    kw = dict(backend="cuda", seed=0, microbatch=LIFETIME_BATCH, drift=dcfg,
              schedule=policy, calibration_frames=cal_frames)
    engine = VisionEngine(cfg, params, device=device, calibration=art, **kw)
    cuda_lib.reset_launch_counts()
    outs, states, refresh_ms, refresh_launches, walls = lifetime_run(
        engine, frames, device)
    counts = cuda_lib.launch_counts()
    if device.type == "cuda":
        check_path_counts(counts, "engine_lifetime")
    check(all(n == 0 for n in refresh_launches),
          f"a refresh launched P2M kernels: {refresh_launches}")
    st = engine.lifetime
    served = LIFETIME_BATCH * len(frames)
    check(st.age_frames == served == outs[-1]["lifetime_age_frames"],
          f"age {st.age_frames} after {served} frames")
    last, fired = 0, []
    for j in range(len(frames)):       # the periodic policy, step by step
        age = LIFETIME_BATCH * (j + 1)
        if age - last >= policy.period_frames:
            last = age
            fired.append(j)
    check(st.recal_count == len(fired) == len(refresh_ms)
          and [j for j, o in enumerate(outs)
               if o["lifetime_recal_fired"] == 1.0] == fired,
          f"refreshes at steps {fired} expected, {st.recal_count} fired")
    check(st.trim.device.type == device.type, "the trim left the card")
    for o in outs:
        check(tuple(o["probs"].shape) == (LIFETIME_BATCH, 10)
              and bool(torch.isfinite(o["probs"]).all()), "probs")
    merged = _merge_outputs(outs[1:], [LIFETIME_BATCH] * LIFETIME_STREAM)
    for k in ("lifetime_age_frames", "lifetime_recal_count",
              "lifetime_recal_energy_pj", "lifetime_rate_err"):
        check(merged[k] == outs[-1][k], f"merged {k} is not the last value")
    check(merged["lifetime_recal_fired"] == max(
        o["lifetime_recal_fired"] for o in outs[1:]) == 1.0,
        "merged refresh event")
    check(engine.fused_step_count >= 1, "no fused stream step ran")
    run = dict(recal_count=st.recal_count,
               fused_step_count=engine.fused_step_count,
               fused_fallback_count=engine.fused_fallback_count)

    # the same engine on the CPU, the same seed and trim
    params_cpu = mparams.to_device(engine.params, cpu)
    engine_cpu = VisionEngine(cfg, params_cpu, device=cpu, **kw)
    outs_cpu, states_cpu, _, _, _ = lifetime_run(engine_cpu, frames, cpu)
    check([a for a, _ in states] == [a for a, _ in states_cpu]
          and engine_cpu.lifetime.age_frames == st.age_frames,
          "ages differ from the CPU engine's")
    check([o["lifetime_recal_fired"] for o in outs]
          == [o["lifetime_recal_fired"] for o in outs_cpu],
          "refresh frames differ from the CPU engine's")
    lsb = policy.cal_span / 2 ** policy.cal_iters
    rows_err, trim_steps = 0.0, []
    for (age, trim), (_, trim_cpu) in zip(states, states_cpu):
        rows = aged_rows(engine, age, trim).cpu()
        rows_cpu = aged_rows(engine_cpu, age, trim.cpu())
        rows_err = max(rows_err, float(((rows - rows_cpu).abs()
                                        / rows_cpu.abs().clamp(min=1.0))
                                       .max()))
        trim_steps.append(max_abs(trim.cpu(), trim_cpu) / lsb)
    check(rows_err <= LIFETIME_ROWS_TOL,
          f"aged rows off the CPU's by {rows_err}")
    trim_steps.append(max_abs(st.trim.cpu(), engine_cpu.lifetime.trim) / lsb)
    check(max(trim_steps) <= 8,
          f"refreshed trims off the CPU's by {max(trim_steps)} steps")
    for j, o in enumerate(outs):
        check(o["lifetime_recal_count"] == outs_cpu[j]["lifetime_recal_count"]
              and o["lifetime_recal_energy_pj"]
              == outs_cpu[j]["lifetime_recal_energy_pj"],
              f"step {j}: refresh count or energy differs from the CPU's")

    # the classify at age 0 and a replay of its key at the final age, each
    # by compare_with_cpu's rules on the step's aged chip and card trim
    def step_params(age, trim):
        return {**engine.params, "p2m": {
            **engine.params["p2m"],
            "chip": engine._evolve(st.chip0, st.maps, age), "cal_trim": trim}}

    vs_cpu = compare_with_cpu(cfg, step_params(*states[0]), frames, outs[0],
                              [], device, "f32")
    replay = engine.classify(frames[0], key=prng.fold_in(prng.PRNGKey(0), 0))
    check(st.age_frames == served and "lifetime_age_frames" not in replay,
          "a replay aged the chip")
    vs_cpu_replay = compare_with_cpu(cfg, step_params(st.age_frames, st.trim),
                                     frames, replay, [], device, "f32")

    # steady walls: the aging classify (its refreshes left out) and the
    # plain calibrated engine of engine_variation, in turns
    plain = VisionEngine(cfg, params, device=device, backend="cuda", seed=0,
                         microbatch=LIFETIME_BATCH, calibration=art)
    for e in (engine, plain):
        e.classify(frames[1])
    aging_ms, plain_ms, aging_step_ms = [], [], []
    for _ in range(LIFETIME_STEADY):
        sync(device)
        t0 = time.perf_counter()
        o = engine.classify(frames[1])
        sync(device)
        if o["lifetime_recal_fired"] == 0.0:
            aging_ms.append((time.perf_counter() - t0) * 1e3)
            aging_step_ms.append(o["wall_ms"])
        sync(device)
        t0 = time.perf_counter()
        plain.classify(frames[1])
        sync(device)
        plain_ms.append((time.perf_counter() - t0) * 1e3)
    aged_ms, observe_ms = [], []
    rates = outs[-1]["channel_rates"]
    for _ in range(LIFETIME_STEADY):
        sync(device)
        t0 = time.perf_counter()
        engine._aged_params()
        sync(device)
        t1 = time.perf_counter()
        engine._scheduler.observe(rates)
        observe_ms.append((time.perf_counter() - t1) * 1e3)
        aged_ms.append((t1 - t0) * 1e3)

    # stale trim against a refresh, at 1e5 frames
    st.age_frames = LIFETIME_STALE_AGE
    aged = engine._evolve(st.chip0, st.maps, st.age_frames)
    sched = engine._scheduler
    err_stale = sched.rate_error(aged, st.trim)
    err_fresh = sched.rate_error(aged, sched.recalibrate(aged))
    check(err_stale > 2.0 * err_fresh,
          f"at {LIFETIME_STALE_AGE} frames the refresh left rate error "
          f"{err_fresh} against the stale trim's {err_stale}")

    emit("engine_lifetime", model="vgg16", batch=LIFETIME_BATCH,
         chip_id=VARIATION_CHIP, drift=dataclasses.asdict(dcfg),
         policy=LIFETIME_POLICY, launches=counts,
         refresh_launches=refresh_launches, ages=[a for a, _ in states],
         refresh_steps=fired, **run,
         recal_energy_pj=outs[-1]["lifetime_recal_energy_pj"],
         energy_per_refresh_pj=sched.recal_energy_pj,
         rate_err=[o["lifetime_rate_err"] for o in outs],
         rows_max_rel_err_vs_cpu=rows_err, trim_steps_vs_cpu=trim_steps,
         step_wall_ms=walls, step_engine_wall_ms=[o["wall_ms"] for o in outs],
         refresh_wall_ms=refresh_ms,
         refresh_wall_ms_median=statistics.median(refresh_ms),
         vs_cpu=vs_cpu, vs_cpu_replay_at_final_age=vs_cpu_replay,
         rate_error_stale=err_stale, rate_error_refreshed=err_fresh,
         stale_age_frames=LIFETIME_STALE_AGE, nvidia_smi=smi)
    emit("engine_lifetime_steady", model="vgg16", batch=LIFETIME_BATCH,
         aging_classify_wall_ms_median=statistics.median(aging_ms),
         aging_classify_step_wall_ms_median=statistics.median(aging_step_ms),
         variation_classify_wall_ms_median=statistics.median(plain_ms),
         aged_params_ms_median=statistics.median(aged_ms),
         observe_ms_median=statistics.median(observe_ms),
         steps_timed=len(aging_ms), nvidia_smi=smi)
    return engine


def lifetime_kernels_phase(device, engine, params) -> None:
    """Kernels A, B and fused on the aging engine's chip at
    ``LIFETIME_KERNEL_AGES`` with the trim ``linspace(-0.1, 0.1, C)``, at
    the serving shape: A against its plain version (u at 3e-6, theta at
    1e-5); B on A's u against its plain version, the draws and the V_CONV
    min / max bit for bit, the mean within 1e-5 (summed in another
    order); the fused kernel at A's theta equal to A -> B and to its plain
    version's draws bit for bit. One ``lifetime_kernel`` line an age."""
    import torch
    from repro_torch import prng
    from repro_torch.core import p2m
    from repro_torch.kernels import p2m_conv as pk

    gen = torch.Generator().manual_seed(43)
    images = torch.rand((LIFETIME_BATCH, 32, 32, 3), generator=gen).to(device)
    wq = p2m.quantize_weights(params["p2m"]["w"], 4)
    wm = pk.pack_phase_weights(wq.reshape(27, 32)).contiguous()
    v_th = params["p2m"]["v_th"]
    key = prng.fold_in(prng.PRNGKey(47), 1)
    kw = dict(kernel=3, stride=2)
    u, hp = pk.p2m_phase_a_implicit(images, wm, v_th, **kw)
    u_p, hp_p = pk.p2m_phase_a_implicit_plain(images, wm, v_th, **kw)
    theta = pk.combine_hoyer_partials(hp, v_th)
    theta_p = pk.combine_hoyer_partials(hp_p, v_th)
    err_u = max_abs(u, u_p)
    rel_theta = abs(float(theta) - float(theta_p)) / abs(float(theta_p))
    check(err_u <= 3e-6 and rel_theta <= 1e-5,
          f"kernel A on the served weights: u {err_u}, theta {rel_theta}")
    n, c = u.shape
    trim = torch.linspace(-0.1, 0.1, c, device=device)
    for age in LIFETIME_KERNEL_AGES:
        chan = aged_rows(engine, age, trim).contiguous()
        acts, vp = pk.p2m_phase_b(u, theta, key, chan=chan)
        acts_p, vp_p = pk.p2m_phase_b_plain(u, theta, key, chan=chan)
        check(torch.equal(acts, acts_p),
              f"kernel B's draws != its plain version's at {age} frames")
        v_k = pk.combine_v_conv_partials(vp, n, c)
        v_p = pk.combine_v_conv_partials(vp_p, n, c)
        check(all(torch.equal(v_k[x], v_p[x])
                  for x in ("v_conv_min", "v_conv_max")),
              f"kernel B's V_CONV min / max != the plain ones at {age}")
        v_err = abs(float(v_k["v_conv_mean"]) - float(v_p["v_conv_mean"]))
        check(v_err <= 1e-5, f"kernel B V mean off by {v_err} at {age}")
        fused = pk.p2m_fused_stream(images, wm, v_th, theta, key, chan, **kw)
        check(torch.equal(fused[0], acts),
              f"fused at A's theta != A -> B with the aged rows at {age}")
        check(torch.equal(fused[3].sum(0), acts.sum(0)), "fused rates")
        fused_p = pk.p2m_fused_stream_plain(images, wm, v_th, theta, key,
                                            chan, **kw)
        check(torch.equal(fused[0], fused_p[0]),
              f"fused draws != its plain version's at {age} frames")
        emit("lifetime_kernel", age_frames=age, shape=[n, 27, c],
             a_max_abs_err_u=err_u, a_theta_rel_err=rel_theta,
             b_draws_equal_plain=True, b_v_min_max_equal_plain=True,
             b_v_conv_mean_abs_err=v_err, fused_equals_a_then_b=True,
             fused_draws_equal_plain=True,
             activation_rate=float(acts.mean()))


FLEET_KW = dict(iters=12, span=2.0)


def fleet_frames():
    import torch
    return torch.rand((FLEET_FRAMES, 32, 32, 3),
                      generator=torch.Generator().manual_seed(53))


def fleet_cpu_twin(cfg, params, dcfg):
    """The fleet surfaces of the first ``FLEET_CPU_CHIPS`` chips at
    ``FLEET_CPU_AGES`` on the CPU, and their wall in ms."""
    import torch
    from repro_torch.lifetime import fleet
    t0 = time.perf_counter()
    twin = fleet.fleet_surfaces(params["p2m"], cfg.p2m, cfg.variation, dcfg,
                                fleet_frames(), FLEET_CPU_AGES,
                                FLEET_CPU_CHIPS, device=torch.device("cpu"),
                                **FLEET_KW)
    return twin, (time.perf_counter() - t0) * 1e3


def fleet_lifetime_phase(device, smi: str, cfg, params, dcfg, budget: float,
                         twin_future):
    """``rate_error_vs_age``'s surfaces of ``FLEET_CHIPS`` chips at
    ``FLEET_AGES`` (``iters`` 12, ``FLEET_FRAMES`` calibration frames,
    vgg16's P2M weights) on the card, timed, with its peak memory;
    ``time_to_failure`` stale and refreshed at the budget (the refreshed
    survivors at least the stale ones). Against the CPU twin
    (``fleet_cpu_twin``, run beside the card's phases): the birth and
    refreshed trims within 8 bisection steps, and the card's errors within
    ``FLEET_ERR_ATOL`` of the CPU's chain at the card's trims (the twin's
    own errors where its trims equal the card's bit for bit)."""
    import torch
    from repro_torch.lifetime import (evolve_chip, fleet, sample_drift_maps,
                                      time_to_failure)
    from repro_torch.variation.calibrate import channel_rates
    from repro_torch.variation.chip import sample_chips

    cpu = torch.device("cpu")
    vcfg, pcfg = cfg.variation, cfg.p2m
    frames = fleet_frames()
    kw = FLEET_KW
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sync(device)
    t0 = time.perf_counter()
    surf = fleet.fleet_surfaces(params["p2m"], pcfg, vcfg, dcfg, frames,
                                FLEET_AGES, FLEET_CHIPS, device=device, **kw)
    host = {k: surf[k].cpu().numpy() for k in fleet.SURFACES}
    wall = (time.perf_counter() - t0) * 1e3
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else None)
    ttf = {tag: time_to_failure(host[f"err_{tag}_worst"], FLEET_AGES, budget)
           for tag in ("stale", "recal")}
    check(ttf["recal"]["survivor_fraction"]
          >= ttf["stale"]["survivor_fraction"],
          f"refreshing lost survivors: {ttf}")

    t_cpu = time.perf_counter()
    k_cpu = FLEET_CPU_CHIPS
    twin, twin_ms = twin_future.result()
    lsb = kw["span"] / 2 ** kw["iters"]
    idx = [FLEET_AGES.index(a) for a in FLEET_CPU_AGES]
    trim0 = surf["trim0"][:k_cpu].cpu()
    trim_t = surf["trim_t"][idx, :k_cpu].cpu()
    trim_steps = max(max_abs(trim0, twin["trim0"]),
                     max_abs(trim_t, twin["trim_t"])) / lsb
    check(trim_steps <= 8, f"fleet trims off the CPU's by {trim_steps} steps")
    chain = {}

    def cpu_errors(age, trim):
        """|rate - target| of the CPU's chain at a card trim."""
        if not chain:
            chain["ops"] = fleet._calibration_operands(
                params["p2m"]["w"].cpu(), params["p2m"]["v_th"].cpu(),
                frames, pcfg)
            ids = list(range(k_cpu))
            c, n = pcfg.out_channels, pcfg.mtj.n_redundant
            chain["chips"] = (sample_chips(vcfg, c, n, ids, device=cpu),
                              sample_drift_maps(dcfg, c, n, ids, device=cpu))
        u, theta, ref = chain["ops"]
        aged = evolve_chip(*chain["chips"], age, dcfg=dcfg)
        return (channel_rates(u, theta, aged, trim, pcfg) - ref).abs()

    err_gap, evaluated = 0.0, 0
    for j, (i, a) in enumerate(zip(idx, FLEET_CPU_AGES)):
        for tag, card_trim, cpu_trim in (("stale", trim0, twin["trim0"]),
                                         ("recal", trim_t[j],
                                          twin["trim_t"][j])):
            if torch.equal(card_trim, cpu_trim):
                cpu_err = {s_: twin[f"err_{tag}_{s_}"][:, j]
                           for s_ in ("mean", "worst")}
            else:
                err = cpu_errors(a, card_trim)
                cpu_err = {"mean": err.mean(-1), "worst": err.amax(-1)}
                evaluated += 1
            for stat, val in cpu_err.items():
                card = torch.from_numpy(host[f"err_{tag}_{stat}"][:k_cpu, i])
                err_gap = max(err_gap, max_abs(card, val))
    cpu_ms = (time.perf_counter() - t_cpu) * 1e3
    check(err_gap <= FLEET_ERR_ATOL,
          f"fleet rate errors off the CPU's chain by {err_gap}")
    emit("fleet_lifetime", chips=FLEET_CHIPS, frames=FLEET_FRAMES,
         ages=list(FLEET_AGES), iters=kw["iters"], budget=budget,
         rows=[{"age_frames": a, **{k: float(host[k][:, i].mean())
                                    for k in fleet.SURFACES}}
               for i, a in enumerate(FLEET_AGES)],
         time_to_failure=ttf, wall_ms=wall, peak_bytes=peak,
         cpu_chips=k_cpu, cpu_ages=list(FLEET_CPU_AGES),
         cpu_twin_wall_ms=twin_ms, cpu_wait_and_check_ms=cpu_ms,
         trim_steps_vs_cpu=trim_steps, err_max_abs_vs_cpu=err_gap,
         cpu_chain_evaluations_at_card_trims=evaluated, nvidia_smi=smi)


def accuracy_lifetime_phase(device, smi: str, cfg, params, dcfg,
                            cal_frames, engine) -> None:
    """``accuracy_vs_age``: one chip at ``ACCURACY_AGES``, one batch of 16,
    through ``device`` on the card and on the CPU. The threefry words are
    the same on both, so a frame's label may differ only where a draw's
    uniform or a backbone unit sits on an edge: at most one frame of the
    16 an eval. Then the maintenance energy per frame at
    ``MAINTENANCE_PERIOD`` beside the frontend energy of a frame."""
    import dataclasses as dc
    import torch
    from repro_torch import prng
    from repro_torch.core import energy
    from repro_torch.lifetime import accuracy_vs_age

    gen = torch.Generator().manual_seed(59)
    batch = {"image": torch.rand((LIFETIME_BATCH, 32, 32, 3), generator=gen),
             "label": torch.arange(LIFETIME_BATCH) % 10}
    cfg0 = dataclasses.replace(cfg, variation=None)
    kw = dict(vcfg=cfg.variation, dcfg=dcfg, ages=ACCURACY_AGES, n_chips=1,
              calibration_frames=cal_frames, key=prng.PRNGKey(61),
              cal_iters=12)
    sync(device)
    t0 = time.perf_counter()
    rows = accuracy_vs_age(params, cfg0, [batch], device=device, **kw)
    sync(device)
    wall = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    rows_cpu = accuracy_vs_age(params, cfg0, [batch],
                               device=torch.device("cpu"), **kw)
    cpu_wall = (time.perf_counter() - t0) * 1e3
    worst = max(abs(r[k] - rc[k]) * LIFETIME_BATCH for r, rc in
                zip(rows, rows_cpu) for k in ("acc_stale", "acc_recal"))
    check([r["age_frames"] for r in rows] == list(ACCURACY_AGES)
          and worst <= 1.0, f"accuracy_vs_age: {rows} vs {rows_cpu}")
    spec = engine._frame_spec()
    fe = energy.frontend_energy_ours(spec)
    maint = energy.maintenance_energy_per_frame_pj(
        spec, recal_period_frames=MAINTENANCE_PERIOD,
        n_cal_frames=FLEET_FRAMES, bisection_iters=12)
    emit("accuracy_lifetime", model="vgg16", rows=rows, rows_cpu=rows_cpu,
         frames_differing_max=worst, wall_ms=wall, cpu_wall_ms=cpu_wall,
         frontend_energy_ours_pj=fe, maintenance_per_frame_pj=maint,
         maintenance_period_frames=MAINTENANCE_PERIOD,
         maintenance_overhead_fraction=maint / fe, nvidia_smi=smi)


def lifetime_phase(device, smi: str):
    """The lifetime phases on ``variation_config()``'s calibrated chip
    aging under ``lifetime_config()``: ``engine_lifetime`` (and
    ``_steady``), ``lifetime_kernel`` lines, ``fleet_lifetime`` and
    ``accuracy_lifetime``."""
    import torch
    from repro_torch.kernels import autotune
    from repro_torch.models import params as mparams
    from repro_torch.models import vision
    from repro_torch.variation import calibrate

    autotune.clear()          # the f32 path
    cfg = variation_config()
    dcfg, budget = lifetime_config()
    params = vision.init_params(0, cfg, device=device)
    cal_frames = torch.rand((LIFETIME_BATCH, 32, 32, 3),
                            generator=torch.Generator().manual_seed(37))
    art = calibrate(params["p2m"], cfg.p2m, cfg.variation, cal_frames,
                    chip_id=VARIATION_CHIP, iters=CAL_ITERS, span=CAL_SPAN,
                    device=device)
    # the fleet's CPU twin runs beside the card's phases (its ops release
    # the interpreter lock); its result is read in fleet_lifetime_phase
    with ThreadPoolExecutor(1) as pool:
        twin = pool.submit(fleet_cpu_twin, cfg,
                           mparams.to_device(params, torch.device("cpu")),
                           dcfg)
        engine = lifetime_engine_phase(device, smi, cfg, params, art,
                                       cal_frames, dcfg)
        lifetime_kernels_phase(device, engine, params)
        fleet_lifetime_phase(device, smi, cfg, params, dcfg, budget, twin)
    accuracy_lifetime_phase(device, smi, cfg, params, dcfg, cal_frames,
                            engine)


# --- fleet serving (``repro_torch.serving.FleetEngine``) -------------------

FLEET_G = 4                # chips of a fleet kernel call and of a step
FLEET_SIZE = 8             # chips of the served fleet
FLEET_BATCH = 16           # frames of a request, one microbatch
FLEET_ROUNDS = 6           # stream rounds of the fleet's main path
FLEET_POLICY = dict(period_frames=64)
FLEET_REFRESH = 2          # refresh_per_sweep
FLEET_CURVE = (1, 2, 4, 8)  # chips_per_step of the throughput curve
FLEET_CURVE_ROUNDS = 8
FLEET_CPU_ROUNDS = 5       # rounds of the 2-chip card vs CPU fleet
# a sleep kernel (~0.1 s) queued before a deferred step: a host sync in
# the step's dispatch would wait it out
FLEET_SLEEP_CYCLES = 200_000_000
# kernel checks at the serving shape and at a per-chip N that is not a
# multiple of the 16-row tile (3 x 7 x 6 = 126 rows)
FLEET_ODD = dict(batch=3, h=13, w=11, kernel=3, stride=2, c=32)
# the five fleet wrappers and the single-chip wrapper each is held to
FLEET_WRAPPERS = {
    "p2m_phase_a_implicit_fleet": "p2m_phase_a_implicit",
    "p2m_phase_a_implicit_q8_fleet": "p2m_phase_a_implicit_q8",
    "p2m_phase_b_fleet": "p2m_phase_b",
    "p2m_fused_stream_fleet": "p2m_fused_stream",
    "p2m_fused_stream_q8_fleet": "p2m_fused_stream_q8",
}
# birth calibration's bisection steps and a sweep's (SchedulePolicy's
# default cal_iters), the window of both
FLEET_BIRTH_ITERS, FLEET_REFRESH_ITERS = 16, 12


def fleet_config():
    """vgg16 at CIFAR-10 geometry with BENCH_fleet.json's
    ``variation_profile`` armed, and its ``drift_profile``."""
    from repro_torch.lifetime import DriftConfig
    from repro_torch.models import vision
    from repro_torch.variation import VariationConfig
    with open(os.path.join(ROOT, "BENCH_fleet.json")) as f:
        bench = json.load(f)
    return (vision.VisionConfig(
        variation=VariationConfig(**bench["variation_profile"])),
        DriftConfig(**bench["drift_profile"]))


def fleet_kernel_checks(geom: dict, g: int, device) -> dict:
    """The five fleet instances on G chips' operands drawn from a fixed
    seed (each chip its own random (4, C) rows and key): (a) against their
    plain versions (u at 3e-6, theta at rtol 1e-5, draws by the
    word-boundary rule, V stats within 1e-5; the fused kernels at A's theta
    equal to A -> B, their fresh theta A's, their rates the draw counts);
    (b) each chip row against the single-chip kernel on that chip's
    operands, bit for bit (u, Hoyer partials, theta, acts, V, rate
    partials). Returns the operands and the errors."""
    import torch
    from repro_torch import prng
    from repro_torch.core import p2m
    from repro_torch.kernels import ops
    from repro_torch.kernels import p2m_conv as pk

    gen = torch.Generator().manual_seed(61)
    b, h, w, k, s, c = (geom[x] for x in ("batch", "h", "w", "kernel",
                                          "stride", "c"))
    images = torch.rand((g, b, h, w, 3), generator=gen).to(device)
    wt = torch.randn((k, k, 3, c), generator=gen) * (2.0 / (k * k * 3)) ** 0.5
    wq = p2m.quantize_weights(wt, 4).to(device)
    wm = pk.pack_phase_weights(wq.reshape(k * k * 3, c)).contiguous()
    w8, dq = ops.quantize_frontend_weights(wm)
    v_th = torch.ones((), device=device)
    chan = torch.stack([torch.stack([
        1.0 + 0.1 * torch.randn(c, generator=gen),
        0.05 * torch.randn(c, generator=gen),
        1.0 + 0.1 * torch.randn(c, generator=gen),
        0.3 * torch.randn(c, generator=gen)]) for _ in range(g)]).to(device)
    keys = [prng.fold_in(prng.PRNGKey(3), 100 + i) for i in range(g)]
    kw = dict(kernel=k, stride=s)
    tag = f"G {g} x {b}x{h}x{w}x3 k{k} s{s} -> ({g}, ?, {c})"

    u, hp = pk.p2m_phase_a_implicit_fleet(images, wm, v_th, **kw)
    u8, hp8 = pk.p2m_phase_a_implicit_q8_fleet(images, w8, dq, v_th, **kw)
    theta = pk.combine_fleet_hoyer_partials(hp, v_th)
    theta8 = pk.combine_fleet_hoyer_partials(hp8, v_th)
    acts_b, vp = pk.p2m_phase_b_fleet(u, theta, keys, chan=chan)
    acts_b8, _ = pk.p2m_phase_b_fleet(u8, theta8, keys, chan=chan)
    f32 = pk.p2m_fused_stream_fleet(images, wm, v_th, theta, keys, chan, **kw)
    q8 = pk.p2m_fused_stream_q8_fleet(images, w8, dq, v_th, theta8, keys,
                                      chan, **kw)
    n = u.shape[1]
    tag = tag.replace("?", str(n))

    # (a) against the plain versions
    u_p, hp_p = pk.p2m_phase_a_implicit_fleet_plain(images, wm, v_th, **kw)
    u8_p, hp8_p = pk.p2m_phase_a_implicit_q8_fleet_plain(images, w8, dq,
                                                         v_th, **kw)
    err_u, err_u8 = max_abs(u, u_p), max_abs(u8, u8_p)
    check(err_u <= 3e-6 and err_u8 <= 3e-6,
          f"fleet kernel A u errors {err_u}, {err_u8} at {tag}")
    rel = lambda t, t_p: float(((t - t_p).abs() / t_p.abs()).max())
    rel_theta = rel(theta, pk.combine_fleet_hoyer_partials(hp_p, v_th))
    rel_theta8 = rel(theta8, pk.combine_fleet_hoyer_partials(hp8_p, v_th))
    check(rel_theta <= 1e-5 and rel_theta8 <= 1e-5,
          f"fleet theta rel errors {rel_theta}, {rel_theta8} at {tag}")
    b_p = pk.p2m_phase_b_fleet_plain(u, theta, keys, chan=chan)
    f32_p = pk.p2m_fused_stream_fleet_plain(images, wm, v_th, theta, keys,
                                            chan, **kw)
    q8_p = pk.p2m_fused_stream_q8_fleet_plain(images, w8, dq, v_th, theta8,
                                              keys, chan, **kw)
    flips = {"b": 0, "f32": 0, "q8": 0}
    v_k = pk.combine_fleet_v_conv_partials(vp, n, c)
    v_p = pk.combine_fleet_v_conv_partials(b_p[1], n, c)
    for stat in v_k:
        check(float((v_k[stat] - v_p[stat]).abs().max()) <= 1e-5,
              f"fleet kernel B {stat} differs from the plain at {tag}")
    for i in range(g):
        bits = pk.draw_bits(keys[i], n, c, device=device)
        q = pk.device_chain_q(u_p[i], theta[i], chan[i])[0]
        q_8 = pk.device_chain_q(u8_p[i], theta8[i], chan[i])[0]
        flips["b"] += assert_draws(acts_b[i], q, bits)
        flips["f32"] += assert_draws(f32[0][i], q, bits)
        flips["q8"] += assert_draws(q8[0][i], q_8, bits)
    check(torch.equal(f32[0], acts_b) and torch.equal(q8[0], acts_b8),
          f"pinned-theta fleet fused != fleet A -> B at {tag}")
    check(torch.equal(pk.combine_fleet_hoyer_partials(f32[1], v_th), theta)
          and torch.equal(pk.combine_fleet_hoyer_partials(q8[1], v_th),
                          theta8), f"fleet fused fresh theta != A's at {tag}")
    check(torch.equal(f32[3].sum(1), f32[0].sum(1))
          and torch.equal(q8[3].sum(1), q8[0].sum(1)),
          f"fleet fused rates wrong at {tag}")

    # (b) each chip row against the single-chip call on that chip
    for i in range(g):
        ui, hpi = pk.p2m_phase_a_implicit(images[i], wm, v_th, **kw)
        u8i, hp8i = pk.p2m_phase_a_implicit_q8(images[i], w8, dq, v_th, **kw)
        thi = pk.combine_hoyer_partials(hpi, v_th)
        th8i = pk.combine_hoyer_partials(hp8i, v_th)
        same = [torch.equal(u[i], ui), torch.equal(hp[i], hpi),
                torch.equal(u8[i], u8i), torch.equal(hp8[i], hp8i),
                torch.equal(theta[i], thi), torch.equal(theta8[i], th8i)]
        same += [torch.equal(x, y) for x, y in zip(
            (acts_b[i], vp[i]), pk.p2m_phase_b(ui, thi, keys[i],
                                               chan=chan[i]))]
        same += [torch.equal(x[i], y) for x, y in zip(f32, pk.p2m_fused_stream(
            images[i], wm, v_th, thi, keys[i], chan[i], **kw))]
        same += [torch.equal(x[i], y) for x, y in zip(
            q8, pk.p2m_fused_stream_q8(images[i], w8, dq, v_th, th8i,
                                       keys[i], chan[i], **kw))]
        check(all(same), f"fleet chip row {i} != its single-chip call at "
              f"{tag}: {same}")
    errors = {"p2m_phase_a_implicit_fleet": err_u,
              "p2m_phase_a_implicit_q8_fleet": err_u8,
              "p2m_phase_b_fleet": max_abs(acts_b, b_p[0]),
              "p2m_fused_stream_fleet": max_abs(f32[0], f32_p[0]),
              "p2m_fused_stream_q8_fleet": max_abs(q8[0], q8_p[0])}
    return dict(tag=tag, images=images, wm=wm, w8=w8, dq=dq, v_th=v_th,
                chan=chan, keys=keys, kw=kw, u=u, u8=u8, theta=theta,
                theta8=theta8, n=n, errors=errors,
                checks=dict(theta_rel_err=rel_theta,
                            theta_rel_err_int8=rel_theta8,
                            draw_mismatches=flips,
                            chip_rows_equal_single_chip_calls=True))


def fleet_kernel_phase(device) -> list:
    """``fleet_kernel`` lines: the five fleet instances checked at G 4 at
    the serving shape and at a per-chip N that is not a multiple of 16
    (``fleet_kernel_checks``), then timed at the serving shape beside
    their plain versions, four single-chip launches of the same work, the
    bound (each input read once: the weights once, every chip's frames,
    rows, theta and key; every output written once; G times the
    single-chip operations) and, for kernel A, the library's call over all
    G * B frames. Returns the summary rows (launches filled in later)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import p2m
    from repro_torch.kernels import blocking, cuda_lib
    from repro_torch.kernels import p2m_conv as pk

    odd = fleet_kernel_checks(FLEET_ODD, FLEET_G, device)
    emit("fleet_kernel_odd", geometry=odd["tag"], errors=odd["errors"],
         **odd["checks"])
    x = fleet_kernel_checks(SERVING, FLEET_G, device)
    g, n = FLEET_G, x["n"]
    images, wm, w8, dq, v_th, chan, keys, kw, u, u8, theta, theta8 = (
        x[k_] for k_ in ("images", "wm", "w8", "dq", "v_th", "chan", "keys",
                         "kw", "u", "u8", "theta", "theta8"))
    b, h, w, k, s, c = (SERVING[k_] for k_ in ("batch", "h", "w", "kernel",
                                               "stride", "c"))
    kk = k * k * 3
    f32 = 4
    img_bytes = images.numel() * f32
    w_bytes, w8_bytes = wm.numel() * f32, w8.numel() + dq.numel() * f32
    out_bytes = g * n * c * f32
    chan_bytes, key_bytes = chan.numel() * f32, g * 8
    macs = 2 * g * n * kk * 2 * c
    epi_a, chain = EPILOGUE_A_OPS * g * n * c, DEVICE_CHAIN_OPS * g * n * c
    stats = g * (2 + 3 + c) * f32
    work = {
        "p2m_phase_a_implicit_fleet": (img_bytes + w_bytes + f32 + out_bytes
                                       + g * 2 * f32, macs + epi_a, 0),
        "p2m_phase_a_implicit_q8_fleet": (img_bytes + w8_bytes + f32
                                          + out_bytes + g * 2 * f32, epi_a,
                                          macs),
        "p2m_phase_b_fleet": (2 * out_bytes + chan_bytes + g * f32
                              + key_bytes + g * 3 * f32, chain, 0),
        "p2m_fused_stream_fleet": (img_bytes + w_bytes + chan_bytes
                                   + g * f32 + f32 + key_bytes + out_bytes
                                   + stats, macs + epi_a + chain, 0),
        "p2m_fused_stream_q8_fleet": (img_bytes + w8_bytes + chan_bytes
                                      + g * f32 + f32 + key_bytes + out_bytes
                                      + stats, epi_a + chain, macs),
    }
    calls = {
        "p2m_phase_a_implicit_fleet": (
            lambda: pk.p2m_phase_a_implicit_fleet(images, wm, v_th, **kw),
            lambda: pk.p2m_phase_a_implicit_fleet_plain(images, wm, v_th,
                                                        **kw),
            lambda i: pk.p2m_phase_a_implicit(images[i], wm, v_th, **kw)),
        "p2m_phase_a_implicit_q8_fleet": (
            lambda: pk.p2m_phase_a_implicit_q8_fleet(images, w8, dq, v_th,
                                                     **kw),
            lambda: pk.p2m_phase_a_implicit_q8_fleet_plain(images, w8, dq,
                                                           v_th, **kw),
            lambda i: pk.p2m_phase_a_implicit_q8(images[i], w8, dq, v_th,
                                                 **kw)),
        "p2m_phase_b_fleet": (
            lambda: pk.p2m_phase_b_fleet(u, theta, keys, chan=chan),
            lambda: pk.p2m_phase_b_fleet_plain(u, theta, keys, chan=chan),
            lambda i: pk.p2m_phase_b(u[i], theta[i], keys[i], chan=chan[i])),
        "p2m_fused_stream_fleet": (
            lambda: pk.p2m_fused_stream_fleet(images, wm, v_th, theta, keys,
                                              chan, **kw),
            lambda: pk.p2m_fused_stream_fleet_plain(images, wm, v_th, theta,
                                                    keys, chan, **kw),
            lambda i: pk.p2m_fused_stream(images[i], wm, v_th, theta[i],
                                          keys[i], chan[i], **kw)),
        "p2m_fused_stream_q8_fleet": (
            lambda: pk.p2m_fused_stream_q8_fleet(images, w8, dq, v_th,
                                                 theta8, keys, chan, **kw),
            lambda: pk.p2m_fused_stream_q8_fleet_plain(
                images, w8, dq, v_th, theta8, keys, chan, **kw),
            lambda i: pk.p2m_fused_stream_q8(images[i], w8, dq, v_th,
                                             theta8[i], keys[i], chan[i],
                                             **kw)),
    }
    # the library yardsticks of kernel A over all G * B frames: one cuDNN
    # conv (TF32 off) and torch._int_mm of the quantized patch rows
    (pt, pb), (pl, pr) = blocking.same_pads(h, w, k, s)
    frames_all = images.reshape(g * b, h, w, 3)
    img_nchw = F.pad(frames_all.permute(0, 3, 1, 2),
                     (pl, pr, pt, pb)).contiguous()
    w_oihw = wm.reshape(k, k, 3, 2 * c).permute(3, 2, 0, 1).contiguous()

    def conv_library():
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            F.conv2d(img_nchw, w_oihw, stride=s)

    kpad = -(-kk // 32) * 32
    xq_pad = torch.zeros((g * n, kpad), dtype=torch.int8, device=device)
    xq_pad[:, :kk] = p2m.quantize_acts_q8(
        pk._gather_patches(frames_all, k, s))
    w8_pad = torch.zeros((kpad, 2 * c), dtype=torch.int8, device=device)
    w8_pad[:kk] = w8
    libraries = {"p2m_phase_a_implicit_fleet": conv_library,
                 "p2m_phase_a_implicit_q8_fleet":
                     lambda: torch._int_mm(xq_pad, w8_pad)}
    # the kernel each launches: kernel A's warp-owned tiles from the
    # library's crossover over all G * n rows (n a multiple of 16 here)
    p2m_lib = cuda_lib.load()
    fleet_rows = "(anonymous namespace)::FleetRows"
    symbols = {
        "p2m_phase_a_implicit_fleet":
            f"phase_a_warp_kernel<{fleet_rows}>"
            if p2m_lib.p2m_phase_a_warp_tiles(g * n, 0)
            else f"phase_a_kernel<{fleet_rows}",
        "p2m_phase_a_implicit_q8_fleet":
            "phase_a_q8_fleet_warp_kernel"
            if p2m_lib.p2m_phase_a_warp_tiles(g * n, 1)
            else f"phase_a_kernel<{fleet_rows}",
        "p2m_phase_b_fleet": "phase_b_fleet_kernel",
        "p2m_fused_stream_fleet": f"fused_stream_kernel<{fleet_rows}, "
                                  "(anonymous namespace)::MacF32>",
        "p2m_fused_stream_q8_fleet": f"fused_stream_kernel<{fleet_rows}, "
                                     "(anonymous namespace)::MacQ8Mma>"}
    rows, single_x4 = [], {}
    for name, (fn, plain, single) in calls.items():
        nbytes, ops_f32, ops_i8 = work[name]
        t_bound, by = bound(nbytes, ops_f32, ops_i8)
        lib = libraries.get(name)
        row = {"name": name, "route": "cuda", "source": SOURCE,
               "replaces": REPLACES[FLEET_WRAPPERS[name]], "launches": 0,
               "max_abs_err": x["errors"][name], "ms": device_ms(fn, device),
               "plain_ms": device_ms(plain, device),
               "bound_ms": t_bound, "bound_by": by,
               "library_ms": device_ms(lib, device) if lib else None}
        rows.append(row)
        single_x4[name] = device_ms(lambda: [single(i) for i in range(g)],
                                    device)
        emit("fleet_kernel", geometry=x["tag"],
             **{k_: v_ for k_, v_ in row.items() if k_ != "launches"},
             profiler_ms=profiled_ms(fn, symbols[name], copies=True),
             kernel=symbols[name],
             single_chip_x4_ms=single_x4[name], bound_us=t_bound * 1e3,
             bytes=nbytes, fp32_ops=ops_f32, int8_ops=ops_i8, **x["checks"])
    # a G 4 step's P2M kernels (exact: A then B; fused) beside four
    # single-chip launches of each
    ms = {r["name"]: r["ms"] for r in rows}
    steps = {"exact_f32": ("p2m_phase_a_implicit_fleet", "p2m_phase_b_fleet"),
             "exact_int8": ("p2m_phase_a_implicit_q8_fleet",
                            "p2m_phase_b_fleet"),
             "fused_f32": ("p2m_fused_stream_fleet",),
             "fused_int8": ("p2m_fused_stream_q8_fleet",)}
    emit("fleet_step_kernels", chips=g, **{
        step: dict(fleet_ms=sum(ms[n_] for n_ in names),
                   single_chip_x4_ms=sum(single_x4[n_] for n_ in names))
        for step, names in steps.items()})
    return rows


def fleet_engine(cfg, params, dcfg, cal, device, sweep: bool = True,
                 **engine_kw):
    """``FleetEngine`` on ``cfg``'s chips aging under ``dcfg``, birth
    calibration on ``cal``, one request of ``FLEET_BATCH`` frames a
    microbatch, and (``sweep``) a sweep of ``FLEET_REFRESH`` chips after
    every ``FLEET_POLICY`` period."""
    from repro_torch.lifetime import SchedulePolicy
    from repro_torch.serving import FleetEngine, FleetSweepPolicy
    policy = (FleetSweepPolicy(policy=SchedulePolicy(**FLEET_POLICY),
                               refresh_per_sweep=FLEET_REFRESH,
                               auto=engine_kw.pop("auto", True))
              if sweep else None)
    return FleetEngine(cfg, params, seed=0, device=device,
                       microbatch=FLEET_BATCH, drift=dcfg, sweep=policy,
                       calibration_frames=cal, **engine_kw)


def fleet_rounds(n_rounds: int, chips, seed: int):
    """``n_rounds`` request batches: one ``FLEET_BATCH``-frame request a
    chip each."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    return [[(cid, torch.rand((FLEET_BATCH, 32, 32, 3), generator=gen))
             for cid in chips] for _ in range(n_rounds)]


def step_launches(engine, batch) -> tuple:
    """The P2M launches of serving one batch: (exact-step counts of a new
    stream's first batch, fused-step counts of its second)."""
    from repro_torch.kernels import cuda_lib
    counts = []
    stream = engine.stream([batch, batch])
    for _ in range(2):
        cuda_lib.reset_launch_counts()
        next(stream)
        counts.append({k: v for k, v in cuda_lib.launch_counts().items()
                       if v})
    return tuple(counts)


def backbone_batch_flips(cfg, params, acts, device):
    """The vgg backbone layer by layer over all G * B frames of ``acts``
    (G, B, H', W', C) and a chip's B frames at a time, every layer fed the
    batched run's input: a binary unit may differ only where its z lies
    within 4 float32 ulps of its per-example threshold (convs of another
    batch sum in another order). Returns a bool per frame (G * B): a unit
    flipped."""
    import torch
    from repro_torch.models import vision
    g, b = acts.shape[:2]
    bits = cfg.weight_bits
    x = acts.reshape(g * b, *acts.shape[2:]).permute(0, 3, 1, 2)
    flipped = torch.zeros(g * b, dtype=torch.bool, device=device)
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                     allow_tf32=False):
        for name, pools in vision.vgg_stages(cfg):
            x = vision.pooled(x, pools)
            if name == "head":
                break
            lp = params["layers"][name]
            out = vision._conv_apply(lp, x, 1, bits)[0]
            per_chip = torch.cat([vision._conv_apply(lp, x[i * b:(i + 1) * b],
                                                     1, bits)[0]
                                  for i in range(g)])
            z, _, thr = vision._spike_terms(lp, vision._conv_bn(lp, x, 1,
                                                                bits)[0])
            diff = per_chip != out
            dist = (z - thr).abs() / thr.abs().clamp(min=1.0)
            check(not bool((diff & (dist > THRESHOLD_ULPS_REL)).any()),
                  f"backbone {name}: a unit differs between batchings away "
                  "from its threshold")
            flipped |= diff.reshape(g * b, -1).any(dim=1)
            x = out
    return flipped


def fleet_phase(device, smi: str) -> tuple:
    """``fleet``: ``FleetEngine`` serving ``FLEET_SIZE`` vgg16 chips of
    BENCH_fleet.json's profiles (birth calibration on 16 frames, sweeps of
    ``FLEET_REFRESH`` every ``FLEET_POLICY`` frames, ``FLEET_G`` chips a
    step) through ``FLEET_ROUNDS`` stream rounds of one 16-frame request a
    chip, its launches read from that run; the int8 fleet path the same
    way; then the checks (c) to (g) of the module docstring and the walls.
    Returns (f32 path counts, int8 path counts)."""
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.frontend import SensorFrontend
    from repro_torch.kernels import autotune, cuda_lib
    from repro_torch.models import params as mparams
    from repro_torch.models import vision
    from repro_torch.serving import VisionEngine
    from repro_torch.variation import calibrate

    autotune.clear()             # the f32 path
    cfg, dcfg = fleet_config()
    params = vision.init_params(0, cfg, device=device)
    cal = torch.rand((16, 32, 32, 3),
                     generator=torch.Generator().manual_seed(67))
    chips = list(range(FLEET_SIZE))
    rounds = fleet_rounds(FLEET_ROUNDS, chips, 71)

    # the main path: launch counts from the stream alone
    engine = fleet_engine(cfg, params, dcfg, cal, device,
                          chips_per_step=FLEET_G)
    for cid in chips:
        engine.add_chip(cid)
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    sync(device)
    t0 = time.perf_counter()
    outs = list(engine.stream(rounds))
    sync(device)
    main_ms = (time.perf_counter() - t0) * 1e3
    counts = cuda_lib.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    check_path_counts(counts, "fleet")
    check(engine.fused_step_count >= 1, "no fused fleet step ran")
    check(engine.sweep_count >= 1 and int(engine.state.recal_count.sum())
          >= FLEET_REFRESH, "no sweep refreshed a chip")
    for outs_r in outs:
        for o in outs_r:
            check(tuple(o["probs"].shape) == (FLEET_BATCH, 10)
                  and bool(torch.isfinite(o["probs"]).all())
                  and abs(float(o["probs"].sum()) - FLEET_BATCH) < 1e-3,
                  "fleet probs malformed")
    check([int(a) for a in engine.state.age_frames]
          == [FLEET_ROUNDS * FLEET_BATCH] * FLEET_SIZE, "fleet ages")

    # the int8 fleet path: a table picking int8 at the per-chip key
    autotune.put(*SERVING_KEY, autotune.TileChoice(precision="int8"))
    engine8 = fleet_engine(cfg, params, dcfg, cal, device, sweep=False,
                           chips_per_step=FLEET_G)
    for cid in chips[:FLEET_G]:
        engine8.add_chip(cid)
    cuda_lib.reset_launch_counts()
    list(engine8.stream(fleet_rounds(2, chips[:FLEET_G], 73)))
    counts8 = cuda_lib.launch_counts()
    check_path_counts(counts8, "fleet_int8")
    autotune.clear()

    # (c) launches per step: a G 4 step and a G 1 step alike
    per_step = {}
    for g in (FLEET_G, 1):
        fe = fleet_engine(cfg, params, dcfg, cal, device, sweep=False,
                          chips_per_step=g)
        per_step[g] = step_launches(fe, fleet_rounds(1, chips[:g], 79)[0])
    want = ({"p2m_phase_a_implicit_fleet": 1, "p2m_phase_b_fleet": 1},
            {"p2m_fused_stream_fleet": 1})
    check(per_step[FLEET_G] == per_step[1] == want,
          f"launches per fleet step: {per_step}")

    # an exact step dispatches without a host sync: behind a long sleep
    # kernel the deferred step is still in flight when its dispatch returns
    fe = fleet_engine(cfg, params, dcfg, cal, device, sweep=False,
                      chips_per_step=FLEET_G, fused_stream=False)
    (group,) = fe._group(fe._plan(fleet_rounds(1, chips[:FLEET_G], 81)[0]))
    fe._run_step(group, defer=True)[1].wait()   # the allocator's blocks
    sync(device)
    torch.cuda._sleep(FLEET_SLEEP_CYCLES)
    t0 = time.perf_counter()
    _, probe = fe._run_step(group, defer=True)
    dispatch_ms = (time.perf_counter() - t0) * 1e3
    in_flight = probe is not None and not probe.poll()
    drained_ms = probe.wait() * 1e3 if probe is not None else None
    check(in_flight, "a deferred exact fleet step waited for the device "
          f"(dispatch {dispatch_ms} ms)")

    # (d) a one-chip fleet against VisionEngine, bit for bit: the nominal
    # chip, and a sampled, calibrated, aging one
    stream = [torch.cat([r[0][1], r[1][1]]) for r in rounds[:3]]
    one_chip = {}
    cfg_nom = vision.VisionConfig()
    chip_cfg = dataclasses.replace(cfg, chip_id=3)
    art = calibrate(params["p2m"], cfg.p2m, cfg.variation, cal, chip_id=3,
                    device=device)
    for name, ve, fe in (
            ("nominal",
             VisionEngine(cfg_nom, params, seed=0, device=device,
                          microbatch=FLEET_BATCH),
             fleet_engine(cfg_nom, params, None, None, device, sweep=False)),
            ("sampled_calibrated_aging",
             VisionEngine(chip_cfg, params, seed=0, device=device,
                          microbatch=FLEET_BATCH, calibration=art,
                          drift=dcfg),
             fleet_engine(cfg, params, dcfg, cal, device, sweep=False))):
        cid = 3
        fe.add_chip(cid)
        if name != "nominal":
            check(torch.equal(fe.state.trim[0], art.trim),
                  "birth trim != calibrate's on the card")
        equal = []
        for ov, (of,) in zip(ve.stream(stream),
                             fe.stream([[(cid, x)] for x in stream])):
            equal.append(all(torch.equal(torch.as_tensor(ov[k_]),
                                         torch.as_tensor(of[k_]))
                             for k_ in ("labels", "probs", "theta_used",
                                        "stream_fused")))
        check(all(equal), f"one-chip fleet != VisionEngine ({name}): {equal}")
        one_chip[name] = dict(steps=len(equal),
                              fused_steps=fe.fused_step_count)

    # (e) a G 4 step against four single-chip engines on the same chips
    fe = fleet_engine(cfg, params, dcfg, cal, device, sweep=False,
                      chips_per_step=FLEET_G)
    batch = fleet_rounds(1, chips[:FLEET_G], 83)[0]
    for cid, _ in batch:
        fe.add_chip(cid)
    chips_g, trims_g = fe._gather_operands(list(range(FLEET_G)),
                                           np.zeros(FLEET_G))
    key0 = prng.fold_in(prng.PRNGKey(0), 0)
    frames_g = torch.stack([x for _, x in batch]).to(device)
    pp = {**params["p2m"], "chip": chips_g, "cal_trim": trims_g}
    acts_g, aux_g = SensorFrontend(cfg.frontend).fleet(
        pp, frames_g, keys=[key0] * FLEET_G)
    outs_g = fe.serve(batch)
    flipped = backbone_batch_flips(cfg, params, acts_g, device).reshape(
        FLEET_G, FLEET_BATCH)
    vs_single = []
    for i, (cid, x) in enumerate(batch):
        art_i = calibrate(params["p2m"], cfg.p2m, cfg.variation, cal,
                          chip_id=cid, device=device)
        ve = VisionEngine(dataclasses.replace(cfg, chip_id=cid), params,
                          seed=0, device=device, microbatch=FLEET_BATCH,
                          calibration=art_i, drift=dcfg)
        acts_s, aux_s = SensorFrontend(ve.cfg.frontend)(
            ve._aged_params()["p2m"], x.to(device), key=key0)
        (o_s,) = list(ve.stream([x]))
        check(torch.equal(acts_g[i], acts_s)
              and torch.equal(aux_g["theta"][i], aux_s["theta"]),
              f"fleet chip {cid}: frontend draws != its own engine's")
        keep = ~flipped[i]
        err = float((outs_g[i]["probs"] - o_s["probs"])[keep].abs().max()
                    ) if bool(keep.any()) else None
        check(err is None or err <= 1e-3,
              f"fleet chip {cid}: probs differ from its engine by {err}")
        check(torch.equal(outs_g[i]["labels"][keep], o_s["labels"][keep]),
              f"fleet chip {cid}: labels differ from its engine's")
        vs_single.append(dict(chip=cid, frames_with_backbone_flips=int(
            flipped[i].sum()), max_probs_err=err))

    # (f) a 2-chip fleet on the card against the CPU, sweeps between rounds
    cpu = torch.device("cpu")
    twins = [fleet_engine(cfg, p_, dcfg, cal, dev, auto=False,
                          chips_per_step=2)
             for p_, dev in ((params, device),
                             (mparams.to_device(params, cpu), cpu))]
    reports = [[], []]
    for batch in fleet_rounds(FLEET_CPU_ROUNDS, chips[:2], 89):
        for side, fe_ in enumerate(twins):
            fe_.serve(batch)
            reports[side].append(fe_.run_sweep())
    st_d, st_c = (fe_.state for fe_ in twins)
    check([r["refreshed"] for r in reports[0]]
          == [r["refreshed"] for r in reports[1]]
          and any(r["refreshed"] for r in reports[0]),
          f"card vs CPU sweeps: {reports}")
    for leaf in ("age_frames", "frame_count", "recal_count",
                 "last_recal_frame"):
        check(np.array_equal(getattr(st_d, leaf), getattr(st_c, leaf)),
              f"card vs CPU fleet {leaf}")
    # each trim within 8 steps of its last solve (birth or a sweep's)
    lsb = np.array([CAL_SPAN / 2 ** (FLEET_REFRESH_ITERS if r
                                     else FLEET_BIRTH_ITERS)
                    for r in st_d.recal_count])[:, None]
    trim_err = (st_d.trim.cpu() - st_c.trim).abs().numpy()
    far = trim_err > 8 * lsb
    flat = 0
    if bool(far.any()):
        # a channel whose rate is flat at its target: the two trims' rates
        # on the CPU's chain
        from repro_torch.core import hoyer
        from repro_torch.core import p2m as p2m_core
        from repro_torch.variation.calibrate import channel_rates
        pc = twins[1].params["p2m"]
        u = p2m_core.hardware_conv(cal, pc["w"], cfg.p2m)
        th = hoyer.effective_threshold(u, pc["v_th"]) * pc["v_th"]
        for slot in np.nonzero(far.any(axis=1))[0]:
            chip_c, _ = twins[1]._gather_operands(
                [slot], np.array([st_c.last_recal_frame[slot]], np.float64))
            r_d, r_c = (channel_rates(u, th, chip_c, t_[slot][None].cpu(),
                                      cfg.p2m)[0]
                        for t_ in (st_d.trim, st_c.trim))
            gap = (r_d - r_c).abs().numpy()[far[slot]]
            check(bool((gap <= 2e-5).all()),
                  f"card vs CPU trim of chip {slot} off by "
                  f"{trim_err[slot].max()} where its rate is not flat")
            flat += int(far[slot].sum())

    # (g) a warm restart on the card: save, load into a fresh engine, both
    # serve the same continuation bit for bit
    ckpt = os.path.join(ROOT, "build", "fleet_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    engine.save(ckpt)
    restarted = fleet_engine(cfg, params, dcfg, cal, device,
                             chips_per_step=FLEET_G)
    restarted.load(ckpt)
    cont = fleet_rounds(2, chips, 97)
    resumed = []
    for batch in cont:
        for a, b in zip(engine.serve(batch), restarted.serve(batch)):
            resumed.append(all(torch.equal(torch.as_tensor(a[k_]),
                                           torch.as_tensor(b[k_]))
                               for k_ in ("labels", "probs",
                                          "lifetime_age_frames",
                                          "lifetime_recal_count")))
    check(all(resumed) and torch.equal(engine.state.trim,
                                       restarted.state.trim),
          f"restarted fleet diverged: {resumed}")

    # walls: a step at each chips_per_step over the same 8 chips (sweeps
    # off), and a forced sweep of FLEET_REFRESH chips
    curve = []
    for cps in FLEET_CURVE:
        fe = fleet_engine(cfg, params, dcfg, cal, device, sweep=False,
                          chips_per_step=cps)
        for cid in chips:
            fe.add_chip(cid)
        walls = []
        for j, batch in enumerate(fleet_rounds(FLEET_CURVE_ROUNDS + 1, chips,
                                               101)):
            sync(device)
            t0 = time.perf_counter()
            fe.serve(batch) if j else list(fe.stream([batch]))
            sync(device)
            walls.append((time.perf_counter() - t0) * 1e3)
        steps = -(-FLEET_SIZE // cps)
        round_ms = statistics.median(walls[1:])
        curve.append(dict(chips_per_step=cps, steps_per_round=steps,
                          round_wall_ms=round_ms,
                          step_wall_ms=round_ms / steps,
                          frames_per_s=FLEET_SIZE * FLEET_BATCH
                          / (round_ms / 1e3),
                          fused_steps=fe.fused_step_count))
    sweep_walls = []
    for _ in range(3):
        sync(device)
        t0 = time.perf_counter()
        engine.run_sweep(force=True)
        sync(device)
        sweep_walls.append((time.perf_counter() - t0) * 1e3)
    emit("fleet", model="vgg16", chips=FLEET_SIZE, chips_per_step=FLEET_G,
         microbatch=FLEET_BATCH, rounds=FLEET_ROUNDS, nvidia_smi=smi,
         launches=counts, launches_int8=counts8,
         launches_per_step={str(g): [dict(c_) for c_ in per_step[g]]
                            for g in per_step},
         main_path_wall_ms=main_ms,
         fused_step_count=engine.fused_step_count,
         fused_fallback_count=engine.fused_fallback_count,
         sweeps=engine.sweep_count,
         refreshes=[int(r) for r in engine.state.recal_count],
         one_chip_vs_vision_engine=one_chip, vs_single_engines=vs_single,
         card_vs_cpu=dict(rounds=FLEET_CPU_ROUNDS,
                          refreshed=[r["refreshed"] for r in reports[0]],
                          max_trim_err=float(trim_err.max()),
                          flat_channels_beyond_8_steps=flat),
         restart_bit_identical=True,
         deferred_step=dict(dispatch_ms=dispatch_ms, drained_ms=drained_ms,
                            in_flight_at_return=in_flight),
         throughput=curve,
         sweep_wall_ms=sweep_walls, peak_memory_gb=peak_gb)
    return counts, counts8


# --- training: the vision train step (``repro_torch.train.vision``) --------

TRAIN_BATCH = 64          # the reference example's batch
TRAIN_STEPS = 20
TRAIN_LR = 3e-3
TRAIN_EVAL_BATCHES = 4
TRAIN_NOISE = 0.01        # the Fig. 8 flips of the card-vs-CPU step
# card vs CPU, one step: the loss and the BN running stats relative; each
# layer's gradient as max |card - exact| over the RMS of the exact one
# (float32 convs and reductions that sum in another order; cuDNN's
# backward algorithms are not deterministic)
TRAIN_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
# TF32 in the backward moves a layer's gradient by ~1e-3 of its RMS off
# the gated card gradient; the check asks for at least this much in some
# layer
TF32_VISIBLE = 1e-4
# a sleep queued before a timed step, so that the event pair brackets the
# device work of a host-bound step (~200 ms at 1.98 GHz; the host takes
# ~60 ms to queue a step)
TRAIN_SLEEP_CYCLES = 400_000_000
# the kernels the cuda eval of the trained weights launches
TRAIN_EVAL_KERNELS = ("p2m_phase_a_implicit", "p2m_phase_b")


def train_stages(cfg):
    """The vgg training forward as a chain of stages ``(name, params path,
    pools)``: the frontend, then ``vision.vgg_stages`` (each binary conv,
    the head). A stage's input is the previous stage's output (frames for
    the frontend), max-pooled ``pools`` times (``train_stage``), so every
    output is a map of units and its cotangent is theirs."""
    from repro_torch.models import vision
    check(cfg.arch.startswith("vgg"), f"train_stages: {cfg.arch}")
    return [("p2m", ("p2m",), 0)] + [
        (name, ("head",) if name == "head" else ("layers", name), pools)
        for name, pools in vision.vgg_stages(cfg)]


def train_stage(cfg, name: str, pools: int, p, x, key, frozen=None):
    """One stage of ``train_stages``: ``(out, hoyer term or None, EMA
    stats or None)``; chained with one key they are ``vision.forward(...,
    train=True)``. A binary conv is ``vision._conv_apply(train=True)``'s
    two steps, BN then ``hoyer_spike``; ``frozen`` (NCHW, bool) holds the
    gradient of those units' BN output at zero."""
    import torch
    from repro_torch.core import hoyer
    from repro_torch.frontend import SensorFrontend
    from repro_torch.models import vision
    x = vision.pooled(x, pools)
    if name == "p2m":
        acts, aux = SensorFrontend(cfg.frontend)(p, x, key=key)
        return acts.permute(0, 3, 1, 2), aux["hoyer_loss"], None
    if name == "head":
        return x.mean(dim=(2, 3)) @ p["w"] + p["b"], None, None
    y, stats = vision._conv_bn(p, x, 1, cfg.weight_bits, train=True,
                               bn_momentum=cfg.bn_momentum)
    if frozen is not None:
        y = torch.where(frozen, y.detach(), y)
    return (*hoyer.hoyer_spike(y, p["v_th"]), stats)


def _sub(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def train_chain(cfg, params, batch, key):
    """The stages chained from the batch, each stage's input a leaf, with
    cuDNN's TF32 off: returns the stage inputs and ``(out, hoyer, stats)``
    results, each output's cotangent in the training loss (the NLL plus
    ``hoyer_coeff`` times every Hoyer term; None for the head's) and the
    loss."""
    import torch
    from repro_torch.models import vision
    xs, res = [], []
    x = batch["image"]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for name, path, pools in train_stages(cfg):
            leaf = x.detach().requires_grad_(name != "p2m")
            res.append(train_stage(cfg, name, pools, _sub(params, path),
                                   leaf, key))
            xs.append(leaf)
            x = res[-1][0]
        loss = vision.nll(x, batch["label"]) + cfg.hoyer_coeff * sum(
            r[1] for r in res if r[1] is not None)
        cots = torch.autograd.grad(loss, xs[1:])
    return xs, res, list(cots) + [None], loss.detach()


def stage_pre(cfg, name: str, pools: int, p, x):
    """A binary stage's pre-spike map from its input: ``(z, thr, bound)``,
    z NCHW, its global Hoyer threshold, and per unit the distance within
    which a device that sums in another order may put z. A conv of depth K
    summed in another order (or through cuDNN's transforms) is off by ~
    sqrt(K) float32 ulps of the sum of its |terms| S; BN (train mode, live
    stats) scales that by a = |bn_scale| / sqrt(var + eps) / v_th, which
    reaches 316 / v_th in a channel of near-constant conv values, and the
    mean carries its own ulps: bound = 4 sqrt(K) eps a (S + |mu|) + 4 eps
    max(|z|, 1). The frontend: a = 1 / v_th, mu = 0, K = k * k * C_in."""
    import torch
    from repro_torch.core import hoyer
    from repro_torch.core import p2m as p2m_core
    from repro_torch.frontend import backends
    from repro_torch.models import vision
    x = vision.pooled(x, pools)
    v_th = torch.clamp(p["v_th"], min=1e-6)
    if name == "p2m":
        pc = cfg.p2m
        wq = p2m_core.quantize_weights(p["w"], pc.weight_bits)
        u = backends._stages("analog", cfg.frontend, p, x)["u"]
        z = (u / v_th).permute(0, 3, 1, 2)
        s = p2m_core.phase_conv(x, wq.abs(), pc.stride).permute(0, 3, 1, 2)
        a, mu = 1.0 / v_th, 0.0
    else:
        wq = p2m_core.quantize_weights(p["w"], cfg.weight_bits)
        conv = vision._conv_same(x, wq, 1)
        s = vision._conv_same(x.abs(), wq.abs(), 1)
        mu = vision._channel(torch.mean(conv, dim=(0, 2, 3)))
        var = torch.mean(torch.square(conv - mu), dim=(0, 2, 3))
        z = vision._conv_bn(p, x, 1, cfg.weight_bits, train=True)[0] / v_th
        a = vision._channel(p["bn_scale"].abs() / torch.sqrt(var + 1e-5)
                            / v_th)
        mu = mu.abs()
    depth = math.prod(wq.shape[:3])
    eps = THRESHOLD_ULPS_REL / 4
    bound = (4 * math.sqrt(depth) * eps * a * (s + mu)
             + THRESHOLD_ULPS_REL * z.abs().clamp(min=1.0))
    return z, float(hoyer.hoyer_extremum(hoyer.clip01(z))), bound


def _rel_err(ref, got) -> float:
    """max |got - ref| over the RMS of ref (float64)."""
    ref, got = ref.detach().double().cpu(), got.detach().double().cpu()
    rms = float(ref.pow(2).mean().sqrt())
    err = float((got - ref).abs().max())
    return err / rms if rms > 0 else err


def _exact_params(p, bits: int):
    """A stage's params in float64 for its exact result, the weights
    quantized in float32 first: a weight on a rounding boundary of the
    4-bit grid may round the other way in float64, which would make
    another function, not a more exact one."""
    from repro_torch.core import p2m as p2m_core
    out = {k: v.double() for k, v in p.items()}
    if bits:
        out["w"] = p2m_core.quantize_weights(p["w"], bits).double()
    return out


def held(exact, cpu, dev, tol: float) -> dict:
    """The card's float32 result against the exact one (the CPU's float64)
    within ``tol``, beside the CPU's float32 one, each as ``_rel_err``."""
    e_dev, e_cpu = _rel_err(exact, dev), _rel_err(exact, cpu)
    return dict(dev=e_dev, cpu=e_cpu, ok=e_dev <= tol)


def stage_vjp(cfg, name, pools, p, x, key, cot, coeff, tf32: bool,
              frozen=None):
    """One stage's parameter gradients from a given input and output
    cotangent ``cot`` and ``coeff`` for its Hoyer term (the head: ``cot``
    are the labels, and the NLL is differentiated), the forward with TF32
    off and the backward with cuDNN's TF32 ``tf32``, ``frozen`` as in
    ``train_stage``: ``(result, {leaf: gradient})``."""
    import torch
    from repro_torch.models import vision
    live = {k: v.detach().requires_grad_(True) for k, v in p.items()
            if isinstance(v, torch.Tensor) and v.is_floating_point()}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        res = train_stage(cfg, name, pools, {**p, **live}, x, key, frozen)
    if name == "head":
        outs, grads_out = [vision.nll(res[0], cot)], None
    else:
        outs, grads_out = [res[0], res[1]], [cot, torch.full_like(res[1],
                                                                  coeff)]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=tf32):
        grads = torch.autograd.grad(outs, list(live.values()),
                                    grad_outputs=grads_out, allow_unused=True)
    return res, {k: g for k, g in zip(live, grads) if g is not None}


def train_vs_cpu(cfg, params, batch, key, device) -> dict:
    """One training step of ``cfg`` (the Fig. 8 flips on) on the card
    against the CPU, from the same params, batch and key:

    * the flip words (``split(key)``'s two keys over the map) bit for bit;
    * stage by stage, each fed the CPU's input: the pre-spike z within
      ``stage_pre``'s bound of the CPU's and the threshold at
      ``TRAIN_RTOL``; the binary maps (the frontend's flips are the same
      words) may differ only at units whose z lies within that bound plus
      the thresholds' distance of the threshold; the EMA stats and every
      leaf's gradient from the CPU's cotangent, each held to the exact
      result (the CPU's float64 stage) by ``held``: within
      ``TRAIN_RTOL`` / ``TRAIN_GRAD_TOL`` of its RMS; at units within the
      bound of the straight-through window's edges 0 and 1 the cotangent
      is zeroed on every side and a binary conv's BN output passes no
      gradient, the Hoyer term's neither (there the spike's window, the
      clip's and |z|'s gradients jump, and two sums in another order, or
      float64, may pass them differently: a channel whose batch mean is
      one of its conv values puts a set of units at z = 0 in float64 and
      +-1e-7 in float32, and live BN stats amplify a near-constant
      channel's rounding up to 316x);
    * TF32: the same stage gradients with cuDNN's TF32 on in the backward
      must move away from the gated card gradients of the same leaves (by
      ``TF32_VISIBLE`` in some leaf), and a whole step with it away from
      ``value_and_grad``'s;
    * the whole step (``make_step``): its loss, and each layer's new BN
      stats over their RMS, at ``TRAIN_RTOL`` when the card's own chain
      spiked every unit as the CPU's did (a flip moves everything
      downstream of it)."""
    import torch
    from repro_torch import prng
    from repro_torch.models import params as mparams
    from repro_torch.models import vision
    from repro_torch.train import vision as loop

    cpu = torch.device("cpu")
    params_cpu = mparams.to_device(params, cpu)
    batch_cpu = {k: v.cpu() for k, v in batch.items()}
    stages = train_stages(cfg)
    xs, res_cpu, cots, loss_chain_cpu = train_chain(cfg, params_cpu,
                                                    batch_cpu, key)
    # the frontend's flip words, card vs CPU
    shape = tuple(res_cpu[0][0].permute(0, 2, 3, 1).shape)
    n_words = 0
    for k, shp in frontend_words("analog", key, shape):
        check(torch.equal(prng.random_bits(k, shp, device).cpu(),
                          prng.random_bits(k, shp)),
              "train: the card's flip words differ from the CPU's")
        n_words += math.prod(shp)
    rows, worst, worst_tf32, masked = {}, 0.0, 0.0, 0
    for (name, path, pools), x, cot in zip(stages, xs, cots):
        p_cpu, p_dev = _sub(params_cpu, path), _sub(params, path)
        row = {}
        x_dev = x.detach().to(device)
        if name != "head":
            # the pre-spike map on each side from the CPU's input: z
            # within its bound, the thresholds at TRAIN_RTOL; a unit may
            # spike differently only within z's bound plus the
            # thresholds' distance of the CPU's threshold, and pass its
            # gradient differently only within the bound of 0 or 1
            with torch.no_grad(), torch.backends.cudnn.flags(
                    enabled=True, allow_tf32=False):
                z, thr, bound = stage_pre(cfg, name, pools, p_cpu,
                                          x.detach())
                z_dev, thr_dev, _ = stage_pre(cfg, name, pools, p_dev,
                                              x_dev)
            dz = float(((z_dev.cpu() - z).abs() / bound).max())
            dthr = abs(thr_dev - thr)
            check(dz <= 1.0, f"train {name}: z off the CPU's by {dz} of "
                  "its bound")
            check(dthr <= TRAIN_RTOL * abs(thr),
                  f"train {name}: threshold off the CPU's by {dthr}")
            at_thr = (z - thr).abs() <= bound + dthr
            at_edge = (z.abs() <= bound) | ((z - 1.0).abs() <= bound)
            row.update(z_err_over_bound=dz, threshold=thr,
                       threshold_abs_err=dthr,
                       window_edge_units=int(at_edge.sum()))
            masked += int(at_edge.sum())
            cot = torch.where(at_edge, 0.0, cot)
        else:
            cot = batch_cpu["label"]
        # a binary conv's edge units pass no Hoyer gradient either: there
        # the clip's and |z|'s gradients jump (0, 1/2, 1), and float64
        # puts z = 0 where float32 rounds it to +-1e-7
        frozen = at_edge if name not in ("p2m", "head") else None
        cot_dev = cot.to(device)
        fz_dev = None if frozen is None else frozen.to(device)
        r_ref, g_ref = stage_vjp(cfg, name, pools, p_cpu, x.detach(), key,
                                 cot, cfg.hoyer_coeff, False, frozen)
        bits = {"p2m": cfg.p2m.weight_bits, "head": 0}.get(
            name, cfg.weight_bits)
        r_64, g_64 = stage_vjp(cfg, name, pools, _exact_params(p_cpu, bits),
                               x.detach().double(), key, cot.double()
                               if cot.is_floating_point() else cot,
                               cfg.hoyer_coeff, False, frozen)
        r_dev, g_dev = stage_vjp(cfg, name, pools, p_dev, x_dev, key,
                                 cot_dev, cfg.hoyer_coeff, False, fz_dev)
        _, g_tf32 = stage_vjp(cfg, name, pools, p_dev, x_dev, key, cot_dev,
                              cfg.hoyer_coeff, True, fz_dev)
        if name != "head":
            row["map_mismatches"] = assert_edge_mismatches(
                r_dev[0].detach(), r_ref[0].detach(), at_thr)
        if name not in ("p2m", "head"):
            for k in ("bn_mean", "bn_var"):
                h = held(r_64[2][k], r_ref[2][k], r_dev[2][k], TRAIN_RTOL)
                check(h["ok"], f"train {name}: {k} off the exact one by "
                      f"{h['dev']} (the CPU's float32 {h['cpu']})")
                row[f"{k}_rel_err"] = h
        if name == "head":
            h = held(vision.nll(r_64[0], cot), vision.nll(r_ref[0], cot),
                     vision.nll(r_dev[0], cot_dev), TRAIN_RTOL)
            check(h["ok"], f"train: the head's NLL is off by {h}")
            row["nll_rel_err"] = h
        check(g_ref.keys() == g_dev.keys() == g_tf32.keys() == g_64.keys(),
              f"train {name}: gradient leaves {sorted(g_dev)}")
        row["grad_rel_err"] = {k: held(g_64[k], g_ref[k], g_dev[k],
                                       TRAIN_GRAD_TOL) for k in g_ref}
        # TF32 against the gated card gradient of the same leaf
        row["grad_rel_err_tf32"] = {k: _rel_err(g_dev[k], g_tf32[k])
                                    for k in g_ref}
        for k, h in row["grad_rel_err"].items():
            check(h["ok"], f"train {name}: the {k} gradient is off the "
                  f"exact one by {h['dev']} (the CPU's float32 {h['cpu']})")
        worst = max([worst, *(h["dev"] for h in row["grad_rel_err"].values())])
        worst_tf32 = max([worst_tf32, *row["grad_rel_err_tf32"].values()])
        rows[name] = row
    check(worst_tf32 >= TF32_VISIBLE,
          f"train: TF32 in the backward moved no gradient ({worst_tf32}); "
          "the check cannot tell the gated backward from it")

    # the whole step on each side, and the card's step with TF32 on
    new_dev, loss_dev, _ = loop.make_step(cfg, TRAIN_LR)(params, batch, key)
    new_cpu, loss_cpu, _ = loop.make_step(cfg, TRAIN_LR)(params_cpu,
                                                         batch_cpu, key)
    _, _, g_gated = loop.value_and_grad(params, batch, cfg, key)
    live = {path: t.detach().requires_grad_(True)
            for path, t in loop._leaves(params)}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        loss_t, _ = vision.loss_fn(loop._replace(params, live), batch, cfg,
                                   key)
        g_t = torch.autograd.grad(loss_t, list(live.values()),
                                  allow_unused=True)
    step_tf32 = max(_rel_err(g_gated[k], g) for k, g in zip(live, g_t)
                    if g is not None)
    check(step_tf32 >= TF32_VISIBLE, "train: a step with TF32 in the "
          f"backward is within {step_tf32} of the gated step")
    # the card's own chain: did it spike every unit as the CPU's did?
    _, res_own, _, _ = train_chain(cfg, params, batch, key)
    own_flips = sum(int((a[0].detach().cpu() != b[0].detach()).sum())
                    for a, b in zip(res_own[:-1], res_cpu[:-1]))
    loss_rel = abs(float(loss_dev) - float(loss_cpu)) / abs(float(loss_cpu))
    # the stages chained are the training forward: the CPU's chain gives
    # the CPU step's loss
    chain_rel = abs(float(loss_chain_cpu) - float(loss_cpu)) / abs(
        float(loss_cpu))
    check(chain_rel <= TRAIN_RTOL,
          f"train: the stages' loss is off the step's by {chain_rel}")
    stats_rel = max(_rel_err(_sub(new_cpu, ("layers", n))[k],
                             _sub(new_dev, ("layers", n))[k])
                    for n, _, _ in stages[1:-1]
                    for k in ("bn_mean", "bn_var"))
    if own_flips == 0:
        check(loss_rel <= TRAIN_RTOL, f"train: step loss off by {loss_rel}")
        check(stats_rel <= TRAIN_RTOL,
              f"train: step BN stats off by {stats_rel}")
    return dict(flip_words_equal=n_words, stages=rows,
                max_grad_rel_err=worst, max_grad_rel_err_tf32=worst_tf32,
                window_edge_units_masked=masked,
                step_loss=float(loss_dev), step_loss_cpu=float(loss_cpu),
                step_loss_rel_err=loss_rel, step_bn_stats_rel_err=stats_rel,
                own_chain_unit_flips=own_flips,
                whole_step_compared=own_flips == 0,
                step_grad_rel_diff_tf32_vs_gated=step_tf32,
                chain_loss_rel_err=chain_rel)


def trained_kernel_checks(cfg, params, images, key, device) -> dict:
    """Kernels A and B on the trained P2M weights at one eval batch's
    shape, as the ``cuda`` eval calls them, against their plain versions on
    the same inputs (``kernel_checks``' rules): u at 3e-6, theta at 1e-5
    relative, B's draws by the word-boundary rule and its V_CONV stats at
    1e-5. Names the kernel A symbol the library chose at that N."""
    import torch
    from repro_torch.core import p2m
    from repro_torch.kernels import cuda_lib, ops
    from repro_torch.kernels import p2m_conv as pk
    pcfg = cfg.p2m
    kw = dict(kernel=pcfg.kernel_size, stride=pcfg.stride)
    wq = p2m.quantize_weights(params["p2m"]["w"], pcfg.weight_bits)
    images, wm, (b, ho, wo, c), prec = ops._prepare(images, wq, **kw,
                                                    precision=None)
    check(prec == "f32", f"train eval: the cuda eval resolved {prec}")
    v_th = params["p2m"]["v_th"].to(torch.float32).contiguous()
    n = b * ho * wo
    u, hp = pk.p2m_phase_a_implicit(images, wm, v_th, **kw)
    u_p, hp_p = pk.p2m_phase_a_implicit_plain(images, wm, v_th, **kw)
    err_u = max_abs(u, u_p)
    theta = pk.combine_hoyer_partials(hp, v_th)
    theta_p = pk.combine_hoyer_partials(hp_p, v_th)
    rel_theta = abs(float(theta) - float(theta_p)) / abs(float(theta_p))
    check(err_u <= 3e-6, f"train eval: kernel A u error {err_u} > 3e-6")
    check(rel_theta <= 1e-5,
          f"train eval: kernel A theta rel error {rel_theta}")
    acts, vp = pk.p2m_phase_b(u, theta, key)
    acts_p, vp_p = pk.p2m_phase_b_plain(u, theta, key)
    q, _ = pk.device_chain_q(u, theta, None)
    flips = assert_draws(acts, q, pk.draw_bits(key, n, c, device=device))
    v_k = pk.combine_v_conv_partials(vp, n, c)
    v_p = pk.combine_v_conv_partials(vp_p, n, c)
    v_err = max(abs(float(v_k[k]) - float(v_p[k])) for k in v_k)
    check(v_err <= 1e-5, f"train eval: kernel B V_CONV off by {v_err}")
    warp = cuda_lib.load().p2m_phase_a_warp_tiles(n, 0)
    name = "p2m_phase_a_implicit"
    return dict(rows=n, channels=c,
                a_symbol=(WARP_TILE_SYMBOLS if warp else KERNEL_SYMBOLS)[name],
                a_max_abs_err_u=err_u, a_theta_rel_err=rel_theta,
                b_draw_mismatches=flips, b_max_abs_err=max_abs(acts, acts_p),
                b_v_conv_abs_err=v_err,
                activation_rate=float(acts.float().mean()))


def train_phase(device, smi: str):
    """Full-width vgg16 (P2M 3x3 stride 2 to 32 channels, 13 binary
    convs) at CIFAR-10 geometry, seeded weights, trained through the
    ``analog`` backend: ``fit`` for ``TRAIN_STEPS`` steps of
    ``ImageStream`` batches of ``TRAIN_BATCH``, with no P2M kernel
    launched; one step card vs CPU with the Fig. 8 flips on
    (``train_vs_cpu``); the trained weights evaluated through ``analog``,
    ``device`` and ``cuda`` (kernels A and B launched, then held against
    their plain versions on its first batch: ``trained_kernel_checks``).
    Emits ``train`` and ``train_vs_cpu`` lines."""
    import dataclasses as dc

    import torch
    from torch.autograd import DeviceType
    from repro_torch import prng
    from repro_torch.core import p2m
    from repro_torch.data import ImageStream
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import vision
    from repro_torch.train import vision as loop

    cfg = vision.VisionConfig(frontend_backend="analog")   # vgg16
    params = vision.init_params(0, cfg, device=device)
    stream = ImageStream(global_batch=TRAIN_BATCH, seed=0, device=device)
    marks, history = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    trained = loop.fit(params, cfg, stream, TRAIN_STEPS, lr=TRAIN_LR,
                       key=prng.PRNGKey(1), log_every=1,
                       log_fn=lambda s: marks.append(time.perf_counter()),
                       history=history)
    counts_train = cuda_lib.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    walls = [(b - a) * 1e3 for a, b in zip([t0] + marks[:-1], marks)]
    check(len(history) == TRAIN_STEPS
          and all(math.isfinite(h["loss"]) for h in history),
          f"train: non-finite losses {history}")
    check(all(n == 0 for n in counts_train.values()),
          f"train: the train steps launched P2M kernels {counts_train}")
    leaves = loop._leaves(trained)
    check(all(bool(torch.isfinite(t).all()) and t.device.type == "cuda"
              for _, t in leaves), "train: non-finite or moved weights")
    batch = stream.next_batch()
    step = loop.make_step(cfg, TRAIN_LR)
    step_ms = device_ms(lambda: step(trained, batch, prng.PRNGKey(3)),
                        device, reps=5, sleep_cycles=TRAIN_SLEEP_CYCLES)
    # where one step's device time goes (the convs, forward and backward,
    # and the rest), from torch.profiler
    prof, _ = profile_session(lambda: step(trained, batch, prng.PRNGKey(3)))
    step_fam, step_top = device_breakdown(prof, VISION_FAMILIES, n_top=8)
    step_events = sum(1 for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and not is_marker(e))
    # ten steps queued back to back: the host's time to queue them against
    # the time until the device has run them (equal: the host is the
    # bottleneck, the device waits on it)
    torch.cuda.synchronize()
    t_q = time.perf_counter()
    for _ in range(10):
        step(trained, batch, prng.PRNGKey(3))
    queue_ms = (time.perf_counter() - t_q) * 1e3 / 10
    torch.cuda.synchronize()
    done_ms = (time.perf_counter() - t_q) * 1e3 / 10

    evals = {}
    for backend in ("analog", "device", "cuda"):
        ev = ImageStream(global_batch=TRAIN_BATCH, seed=99, device=device)
        cuda_lib.reset_launch_counts()
        acc, n = loop.evaluate(trained, cfg, ev, TRAIN_EVAL_BATCHES,
                               backend=backend,
                               key=None if backend == "analog"
                               else prng.PRNGKey(2))
        counts = cuda_lib.launch_counts()
        for name, cnt in counts.items():
            if backend == "cuda" and name in TRAIN_EVAL_KERNELS:
                check(cnt >= TRAIN_EVAL_BATCHES,
                      f"train eval: {name} launched {cnt} times")
            else:
                check(cnt == 0, f"train eval {backend}: {name} launched "
                      f"{cnt} times")
        evals[backend] = dict(accuracy=acc, examples=n,
                              launches={k: v for k, v in counts.items()
                                        if v})
    # the kernels of the cuda eval held against their plain versions on
    # its first batch, with the trained weights (after the counts above)
    ev = ImageStream(global_batch=TRAIN_BATCH, seed=99, device=device)
    eval_kernels = trained_kernel_checks(
        cfg, trained, ev.next_batch()["image"],
        prng.fold_in(prng.PRNGKey(2), 0), device)
    emit("train", model="vgg16", batch=TRAIN_BATCH, steps=TRAIN_STEPS,
         backend="analog", lr=TRAIN_LR,
         first_step_wall_ms=walls[0],
         step_wall_ms_median=statistics.median(walls[1:]),
         step_wall_ms=walls, step_device_ms=step_ms,
         step_device_ms_by_family=step_fam, step_top_device_events=step_top,
         step_device_events=step_events,
         step_host_queue_ms=queue_ms, step_queued_wall_ms=done_ms,
         peak_bytes=peak, launches_train=counts_train,
         loss_first=history[0]["loss"], loss_last=history[-1]["loss"],
         acc_last=history[-1]["acc"],
         p2m_sparsity_last=history[-1]["p2m_sparsity"],
         eval=evals, eval_kernels=eval_kernels, nvidia_smi=smi)

    # one step card vs CPU with the Fig. 8 flips on, from the trained
    # weights (their BN stats are no longer the init's)
    cfg_noise = dataclasses.replace(cfg, p2m=p2m.P2MConfig(
        noise_p_fail=TRAIN_NOISE, noise_p_false=TRAIN_NOISE))
    emit("train_vs_cpu", model="vgg16", batch=TRAIN_BATCH,
         noise=TRAIN_NOISE,
         **train_vs_cpu(cfg_noise, trained, batch,
                        prng.fold_in(prng.PRNGKey(1), TRAIN_STEPS), device))


def frontend_words(backend: str, key, acts_shape):
    """The (key, shape) of every threefry draw ``backend`` makes."""
    from repro_torch import prng
    from repro_torch.core import mtj
    if backend == "device":
        return [(key, tuple(acts_shape) + (mtj.DEFAULT_MTJ.n_redundant,))]
    if backend == "analog":
        return [(k, tuple(acts_shape)) for k in prng.split(key)]
    return []


def frontend_vs_cpu(backend, fe, params, params_cpu, frames_cpu, key,
                    acts, aux, device) -> dict:
    """One backend on the card against the same call on the CPU: the
    random words bit for bit, theta / Hoyer loss / V_CONV stats at their
    tolerances, the binary map by the edge rule."""
    import torch
    from repro_torch import prng
    acts_cpu, aux_cpu = fe(params_cpu, frames_cpu, key=key, mode=backend)
    n_words = 0
    for k, shape in frontend_words(backend, key, acts.shape):
        check(torch.equal(prng.random_bits(k, shape, device).cpu(),
                          prng.random_bits(k, shape)),
              f"{backend}: card words differ from the CPU's")
        check(torch.equal(prng.uniform(k, shape, device).cpu(),
                          prng.uniform(k, shape)),
              f"{backend}: card uniforms differ from the CPU's")
        n_words += math.prod(shape)
    rel = {k: abs(float(aux[k]) - float(aux_cpu[k]))
           / max(abs(float(aux_cpu[k])), 1e-30)
           for k in ("theta", "hoyer_loss") if float(aux_cpu[k]) != 0.0}
    for k, r in rel.items():
        check(r <= FRONTEND_RTOL, f"{backend}: {k} off the CPU's by {r}")
    v_err = {k: abs(float(aux[k]) - float(aux_cpu[k]))
             for k in ("v_conv_mean", "v_conv_min", "v_conv_max")}
    check(max(v_err.values()) <= V_CONV_ATOL,
          f"{backend}: V_CONV stats off the CPU's: {v_err}")
    flips = assert_edge_mismatches(
        acts, acts_cpu, frontend_edges(backend, fe.cfg, params_cpu,
                                       frames_cpu, key))
    return dict(words_equal=n_words, rel_err=rel, v_conv_abs_err=v_err,
                mismatches=flips)


def frontend_imagenet_checks(backend, fe, params, frames, key, acts,
                             device) -> dict:
    """At ImageNet, on the card alone: the device backend's words at the
    first and last ``WORD_CHECK`` counters against the CPU's, and its
    activation rate against the mean majority probability of its P_sw."""
    import torch
    from repro_torch import prng
    from repro_torch.core import mtj
    from repro_torch.frontend import backends
    if backend != "device":
        return {}
    pcfg = fe.cfg.p2m
    ((k, shape),) = frontend_words(backend, key, acts.shape)
    n = math.prod(shape)
    words = prng.random_bits(k, shape, device).reshape(-1)
    for start in (0, n - WORD_CHECK):
        check(torch.equal(words[start:start + WORD_CHECK].cpu(),
                          prng.counter_words(k, start, start + WORD_CHECK)),
              f"device words at counters {start}.. differ from the CPU's")
    del words
    # the nominal chip: each of a neuron's MTJs at its P_sw
    p_sw = backends._stages(backend, fe.cfg, params, frames)["p_dev"][..., 0]
    q = mtj.majority_activation_probability(
        p_sw, pcfg.mtj.n_redundant, pcfg.mtj.majority).double()
    expected = float(q.mean())
    sigma = float(torch.sqrt(torch.sum(q * (1.0 - q)))) / q.numel()
    rate = float(acts.double().mean())
    z = (rate - expected) / sigma
    check(abs(z) <= RATE_SIGMAS, f"device activation rate {rate} is {z} "
          f"binomial sigma off the majority probability {expected}")
    return dict(words_checked=2 * WORD_CHECK, words_total=n,
                activation_rate=rate, majority_probability_mean=expected,
                rate_sigma=sigma, rate_z=z)


def frontends_phase(device, smi: str):
    """The ``ideal``, ``analog`` (Fig. 8 flips on) and ``device`` backends
    through ``SensorFrontend`` on the card: at the serving shape held
    against the CPU from the same inputs and key, at ImageNet checked on
    the card (words at both ends, the device rate); each timed (event pair,
    median of ``REPS`` / ``IMAGENET_PLAIN_REPS``) beside the ``cuda``
    backend's call at the same shape, with its peak memory. One
    ``frontends`` line per backend and shape."""
    import torch
    from repro_torch import prng
    from repro_torch.core import p2m
    from repro_torch.frontend import FrontendConfig, SensorFrontend

    cpu = torch.device("cpu")
    pcfg = p2m.P2MConfig(noise_p_fail=ANALOG_NOISE,
                         noise_p_false=ANALOG_NOISE)
    # the cuda backend's line of comparison runs the f32 kernels
    fe = SensorFrontend(FrontendConfig(p2m=pcfg, precision="f32"))
    params_cpu = fe.init(torch.Generator().manual_seed(0), device=cpu)
    params = {k: v.to(device) for k, v in params_cpu.items()}
    key = prng.fold_in(prng.PRNGKey(4), 2)
    for name, geom, reps in (("serving", SERVING, REPS),
                             ("imagenet", IMAGENET, IMAGENET_PLAIN_REPS)):
        shape = (geom["batch"], geom["h"], geom["w"], 3)
        frames_cpu = torch.rand(shape, generator=torch.Generator()
                                .manual_seed(19))
        frames = frames_cpu.to(device)
        cuda_ms = device_ms(lambda: fe(params, frames, key=key, mode="cuda"),
                            device, reps)
        for backend in FRONTEND_BACKENDS:
            def call():
                return fe(params, frames, key=key, mode=backend)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            acts, aux = call()
            torch.cuda.synchronize()
            first_wall = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated()
            check(acts.device.type == device.type, f"{backend} left the card")
            check(tuple(acts.shape) == (geom["batch"], geom["h"] // 2,
                                        geom["w"] // 2, geom["c"]),
                  f"{backend}: activation shape {tuple(acts.shape)}")
            check(bool(((acts == 0) | (acts == 1)).all()),
                  f"{backend}: activations are not binary")
            check(all(bool(torch.isfinite(torch.as_tensor(v)).all())
                      for v in aux.values()), f"{backend}: non-finite aux")
            if name == "serving":
                checks = frontend_vs_cpu(backend, fe, params, params_cpu,
                                         frames_cpu, key, acts, aux, device)
            else:
                checks = frontend_imagenet_checks(backend, fe, params,
                                                  frames, key, acts, device)
            emit("frontends", backend=backend, shape=list(shape),
                 geometry=name, ms=device_ms(call, device, reps), reps=reps,
                 cuda_backend_ms=cuda_ms, first_call_wall_ms=first_wall,
                 peak_bytes=peak, allocated_before_bytes=before,
                 sparsity=float(aux["sparsity"]), theta=float(aux["theta"]),
                 nvidia_smi=smi, **checks)
            del acts, aux


def device_breakdown(prof, families, n_top: int = 0):
    """Device ms of a profile by family, and the ``n_top`` device events
    with the most time. Only device-side events (kernels, copies) count:
    the CPU ops that launched them carry the same time and are skipped, and
    so are the device-side copies of ``stage_spans``' ranges.
    ``families``: (name, substrings of the lower-case event name) pairs,
    the first match wins; the rest is ``other``."""
    from torch.autograd import DeviceType
    fam = {name: 0.0 for name, _ in families}
    fam["other"] = 0.0
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA or is_marker(evt) \
                or evt.key.startswith(SPAN_PREFIXES):
            continue
        us = event_us(evt)
        if not us:
            continue
        key = evt.key.lower()
        name = next((f for f, subs in families
                     if any(x in key for x in subs)), "other")
        fam[name] += us / 1e3
        rows.append((us / 1e3, evt.count, evt.key[:90]))
    rows.sort(reverse=True)
    return fam, [{"ms": ms, "count": n, "name": name}
                 for ms, n, name in rows[:n_top]]


VISION_FAMILIES = (("frontend_kernels", ("phase_a_kernel", "phase_b_kernel",
                                         "fused_stream_kernel",
                                         "phase_b_pix_kernel",
                                         "fused_stream_pix_kernel",
                                         "legacy_conv_kernel",
                                         "phase_a_warp_kernel",
                                         "phase_a_q8_warp_kernel",
                                         "legacy_warp_kernel")),
                   ("backbone_conv", ("conv", "xmma", "gemm", "implicit",
                                      "cudnn")))
LM_FAMILIES = (("flash_attention", ("flash_wgmma_kernel",
                                     "flash_ffma_kernel")),
               ("rglru_scan", ("rglru_scan_kernel",)),
               ("slstm_scan", SLSTM_KERNELS),
               ("matmul", ("gemm", "gemv", "cutlass", "xmma", "sm90",
                           "nvjet")))


# the kernels of a classify step (the exact path) at each precision, and
# the fused kernel of a stream's later steps
STEP_KERNELS = {"f32": ("p2m_phase_a_implicit", "p2m_phase_b"),
                "int8": ("p2m_phase_a_implicit_q8", "p2m_phase_b")}
FUSED_KERNEL = {"f32": "p2m_fused_stream", "int8": "p2m_fused_stream_q8"}


def kernel_event_ms(prof, symbol: str):
    """Device ms per launch of the kernels in a profile whose name holds
    ``symbol``; None (not measured) where the profile kept none."""
    from torch.autograd import DeviceType
    evts = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and symbol in e.key]
    count = sum(e.count for e in evts)
    return sum(event_us(e) for e in evts) / 1e3 / count if count else None


def step_kernel_ms(prof, precision: str) -> dict:
    """Device ms per launch of each kernel of a ``precision`` classify step
    in a profile of such steps, where each starts cold between the
    backbone's kernels (the kernel lines time it back to back)."""
    return {name: kernel_event_ms(prof, KERNEL_SYMBOLS[name])
            for name in STEP_KERNELS[precision]}


def profile_phase(engine, frames, device, precision: str = "f32"):
    """Device time of one classify and one fused stream step, by family,
    and of each frontend kernel in the classify (a kernel launched between
    the backbone's kernels, not back to back as the kernel lines time it);
    ``precision`` is the one the engine's tile table picks."""
    cuda = device.type == "cuda"
    prof_c, _ = profile_session(
        lambda: engine.classify(frames[0]), cuda,
        expect=KERNEL_SYMBOLS[STEP_KERNELS[precision][0]])
    prof_s, _ = profile_session(
        lambda: list(engine.stream([frames[1], frames[1]])), cuda)
    fam_c, events = device_breakdown(prof_c, VISION_FAMILIES, n_top=10 ** 6)
    frontend = dict(VISION_FAMILIES)["frontend_kernels"]
    emit("profile", precision=precision, classify_device_ms=fam_c,
         classify_frontend_kernel_ms={
             e["name"]: e["ms"] for e in events
             if any(x in e["name"].lower() for x in frontend)},
         classify_kernel_in_step_ms=step_kernel_ms(prof_c, precision),
         stream_fused_kernel_in_step_ms=kernel_event_ms(
             prof_s, KERNEL_SYMBOLS[FUSED_KERNEL[precision]]),
         stream_exact_plus_fused_device_ms=device_breakdown(
             prof_s, VISION_FAMILIES)[0])


def sdpa_backend_ms(q, k, v, causal: bool, device):
    """Where q's and v's widths differ (MLA): the first of SDPA's fused
    backends that takes the call (flash, cuDNN, memory-efficient), else
    the math one, and its event-pair ms; ("none", None) where no backend
    takes it. q, k, v in SDPA's (B, H, S, D) layout, MHA."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    import torch.nn.functional as F
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        def call():
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=causal)
        try:
            call()
        except RuntimeError:   # this backend does not take the call
            continue
        return backend.name.lower(), device_ms(call, device)
    return "none", None


def flash_operands(geom: dict, device):
    """q, k, v of a flash geometry, from seed 23 (the flash lines' and
    ``--flash-symbols``'s inputs); k and v ``kv_seq`` rows long where the
    geometry has it."""
    import torch
    b, s, h, hkv, d = (geom[x] for x in ("batch", "seq", "heads",
                                         "kv_heads", "head_dim"))
    dv, sk = geom.get("v_dim", d), geom.get("kv_seq", s)
    gen = torch.Generator().manual_seed(23)
    return tuple(torch.randn(shape, generator=gen).to(
        device=device, dtype=getattr(torch, geom["dtype"]))
        for shape in ((b, s, h, d), (b, sk, hkv, d), (b, sk, hkv, dv)))


def flash_symbols_main(geom_json: str) -> int:
    """``python3 chip_smoke.py --flash-symbols GEOM``: the flash kernels a
    profiler session of one call at the JSON geometry records in this
    fresh process, as one JSON list (on the libraries ``main`` built): the
    forward's, or with ``"backward": true`` in GEOM the backward's
    (``flash_attention_bwd`` on ``flash_bwd_operands``)."""
    import torch
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import flash_attention as fa
    geom = json.loads(geom_json)
    if geom.get("backward"):
        q, k, v, do = flash_bwd_operands(geom, torch.device("cuda"))
        key = "flash_bwd_"
        expect = fa.backward_symbols(q.dtype, geom["head_dim"])

        def kernel():
            return fa.flash_attention_bwd(q, k, v, do, causal=geom["causal"])
    else:
        q, k, v = flash_operands(geom, torch.device("cuda"))
        key = expect = "flash"

        def kernel():
            return fa.flash_attention(q, k, v, causal=geom["causal"],
                                      window=geom.get("window", 0))

    kernel()
    prof, _ = profile_session(kernel, cpu=False, expect=expect)
    print(json.dumps(sorted({e.key for e in prof.key_averages()
                             if key in e.key})), flush=True)
    return 0


def flash_symbols_in_child(geom: dict) -> list:
    """The flash kernels a profiler session in a fresh process records at
    ``geom`` (``--flash-symbols``; the backward's with ``"backward":
    true``). Late in this long script every session of one flash line once
    kept the marker kernels and lost the flash kernel's events (kimi-k2's
    prefill, six sessions in a row), where a fresh process records that
    call's kernel; the census's ``collect_in_child`` is the same remedy."""
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--flash-symbols", json.dumps(geom)],
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    check(res.returncode == 0,
          f"--flash-symbols failed:\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.splitlines()[-1])


def flash_phase(geom: dict, device, hgmma=None):
    """The flash-attention kernel at one geometry: held against its plain
    version on the same card tensors and timed beside it, its bound and
    ``scaled_dot_product_attention`` (at a value dim ``v_dim`` other than
    the head dim, the backend that takes it, named). ``hgmma``: the
    instance's HGMMA count from the library's machine code, to report.
    Returns the summary row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    b, s, h, hkv, d = (geom[x] for x in ("batch", "seq", "heads",
                                         "kv_heads", "head_dim"))
    dv, sk = geom.get("v_dim", d), geom.get("kv_seq", s)
    dtype, causal = getattr(torch, geom["dtype"]), geom["causal"]
    window = geom.get("window", 0)
    q, k, v = flash_operands(geom, device)
    tag = (f"B{b} S{s}" + (f"/{sk}" if sk != s else "") + f" H{h}/{hkv} D{d}"
           + (f"/{dv}" if dv != d else "")
           + f" {geom['dtype']} {'causal' if causal else 'full'}"
           + (f" window {window}" if window else ""))
    symbol = (fa.kernel_symbol(dtype, d, window, sk, v_dim=dv) if dv != d
              else fa.kernel_symbol(dtype, d, window, sk))

    def kernel(causal=causal, window=window):
        return fa.flash_attention(q, k, v, causal=causal, window=window)

    prof, out = profile_session(kernel, cpu=False, expect="flash")
    ran = sorted({e.key for e in prof.key_averages() if "flash" in e.key})
    symbols_from = "session"
    if not ran:   # every session here lost it: a fresh process's profiler
        ran, symbols_from = flash_symbols_in_child(geom), "child"
    check(len(ran) == 1 and symbol in ran[0],
          f"flash kernels {ran} ran at {tag}, want {symbol} alone")
    plain = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    err = max_abs(out.float(), plain.float())
    row_err = row_rel_err(out, plain)
    check(bool(torch.isfinite(out).all()), f"non-finite flash output at {tag}")
    check(err <= FLASH_TOL[geom["dtype"]],
          f"flash kernel vs plain max-abs {err} > "
          f"{FLASH_TOL[geom['dtype']]} at {tag}")
    check(row_err <= FLASH_ROW_TOL[geom["dtype"]],
          f"flash kernel vs plain row error / row RMS {row_err} > "
          f"{FLASH_ROW_TOL[geom['dtype']]} at {tag}")

    work = flash_work(geom)
    flops, t_bound, by = work["flops"], work["bound_ms"], work["bound_by"]
    # SDPA's yardstick of a window: a boolean mask of the visible pairs
    mask = None
    if window:
        i = torch.arange(s, device=device)
        mask = (i[:, None] - i[None, :]) < window
        if causal:
            mask &= i[:, None] >= i[None, :]

    def sdpa():
        F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=h != hkv)

    lib_ms, lib_error, backend = None, None, "default"
    if dv != d:
        backend, lib_ms = sdpa_backend_ms(q.transpose(1, 2),
                                          k.transpose(1, 2),
                                          v.transpose(1, 2), causal, device)
    else:
        try:
            lib_ms = device_ms(sdpa, device)
        except (RuntimeError, TypeError) as exc:   # a yardstick only
            lib_error = str(exc).splitlines()[0]
    # a window no shorter than S masks nothing: causal SDPA without the
    # mask then computes the same function, on its fused path, and is the
    # row's yardstick (the masked call's time stays beside it)
    causal_library_ms = device_ms(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=h != hkv),
        device) if causal and window >= s else None
    row = {"name": "flash_attention", "route": "cuda",
           "source": FLASH_SOURCE, "replaces": REPLACES["flash_attention"],
           "launches": 0, "max_abs_err": err,
           "ms": device_ms(kernel, device),
           "plain_ms": device_ms(lambda: fa.flash_attention_plain(
               q, k, v, causal=causal, window=window), device),
           "bound_ms": t_bound, "bound_by": by,
           "library_ms": (lib_ms if causal_library_ms is None
                          else causal_library_ms),
           "profiler_ms": profiled_ms(kernel, symbol)}
    # the causal skip, seen in time: the same inputs without the mask; and
    # the window's skip: the same inputs causal without the window
    full_ms = device_ms(lambda: kernel(causal=False, window=0),
                        device) if causal else None
    unwindowed_ms = device_ms(lambda: kernel(window=0),
                              device) if window else None
    # the instance's design as the library reports it (q and kv rows a
    # tile, K/V stages, the consumers' turns, work from a counter, chained
    # work items)
    design = fa.design(dtype, d, v_dim=dv)
    emit("flash", geometry=tag, kernel=symbol, symbols_from=symbols_from,
         hgmma=hgmma, design=design,
         library_backend=backend, tolerance=FLASH_TOL[geom["dtype"]],
         row_rel_err=row_err, row_tolerance=FLASH_ROW_TOL[geom["dtype"]],
         **{k_: v_ for k_, v_ in row.items() if k_ != "launches"},
         flops=flops, bytes=work["bytes"], exps=work["exps"],
         library_error=lib_error,
         achieved_tflops=flops / (row["ms"] * 1e-3) / 1e12,
         noncausal_ms=full_ms, unwindowed_ms=unwindowed_ms,
         causal_library_ms=causal_library_ms,
         masked_library_ms=lib_ms if window else None)
    return row


def rglru_phase(device):
    """The RG-LRU scan kernel at recurrentgemma-2b's prefill (B 4, S 2048, R
    2560; a near 1, so the carry is most of h), held against its plain
    version on the same card tensors and timed beside it and its bound.
    Returns the summary row."""
    import torch
    from repro_torch.kernels import rglru_scan as rs

    b, s, r = (RGLRU_SERVING[x] for x in ("batch", "seq", "width"))
    gen = torch.Generator().manual_seed(37)
    sp = torch.rand(r, generator=gen) * 0.099 + 0.001    # softplus(lam)
    a = torch.exp(-8 * sp * torch.rand(b, s, r, generator=gen))
    x = torch.sqrt(1 - a * a) * torch.randn(b, s, r, generator=gen)
    a, x = a.to(device), x.to(device)
    out = rs.rglru_scan(a, x)
    plain = rs.rglru_scan_plain(a, x)
    err = max_abs(out, plain)
    carry = max_abs(x, plain)      # what a scan without its carry misses
    check(bool(torch.isfinite(out).all()), "non-finite rglru_scan output")
    check(err <= RGLRU_TOL, f"rglru_scan vs plain max-abs {err} > "
          f"{RGLRU_TOL}")
    check(carry > 100 * RGLRU_TOL, f"the carry is {carry}: a is not near 1")
    moved = 3 * b * s * r * 4            # a and b read, h written, float32
    t_bound, by = bound(moved, 2 * b * s * r)
    row = {"name": "rglru_scan", "route": "cuda", "source": RGLRU_SOURCE,
           "replaces": RGLRU_REPLACES, "launches": 0, "max_abs_err": err,
           "ms": device_ms(lambda: rs.rglru_scan(a, x), device),
           "plain_ms": device_ms(lambda: rs.rglru_scan_plain(a, x), device),
           "bound_ms": t_bound, "bound_by": by, "library_ms": None,
           "profiler_ms": profiled_ms(lambda: rs.rglru_scan(a, x),
                                      rs.kernel_symbol())}
    emit("rglru_scan", geometry=f"B{b} S{s} R{r} float32",
         kernel=rs.kernel_symbol(), tolerance=RGLRU_TOL,
         carry_max_abs=carry, bytes=moved,
         library_note="no single PyTorch call computes a linear recurrence",
         achieved_tb_per_s=moved / (row["ms"] * 1e-3) / 1e12,
         **{k_: v_ for k_, v_ in row.items() if k_ != "launches"})
    return row


def rglru_gated_phase(device):
    """The gated scan instance at recurrentgemma-2b's prefill (B 4, S 2048,
    R 2560, bf16): held bit for bit against the unfused chain it replaces
    (``rglru_ab``, ``rglru_scan``, the cast) on the same card tensors and
    against its plain version, timed beside both and its bound. Returns the
    summary row."""
    import torch
    from repro_torch.kernels import rglru_scan as rs

    b, s, r = (RGLRU_SERVING[x] for x in ("batch", "seq", "width"))
    dtype = getattr(torch, RGLRU_GATED_DTYPE)
    gen = torch.Generator().manual_seed(43)
    rg, ig = (torch.sigmoid(torch.randn(b, s, r, generator=gen)).to(
        device=device, dtype=dtype) for _ in range(2))
    u = torch.randn(b, s, r, generator=gen).to(device=device, dtype=dtype)
    c = (-0.008 - 0.792 * torch.rand(r, generator=gen)).to(device)

    def chain():
        h = rs.rglru_scan(*rs.rglru_ab(rg, ig, u, c))
        return h.to(dtype), h[:, -1]

    hs, h_last = rs.rglru_scan_gated(rg, ig, u, c)
    hs_c, last_c = chain()
    check(torch.equal(hs, hs_c) and torch.equal(h_last, last_c),
          "rglru_scan_gated != the unfused chain (tail, rglru_scan, cast)")
    hs_p, last_p = rs.rglru_scan_gated_plain(rg, ig, u, c)
    err_last = max_abs(h_last, last_p)
    # one ulp of the bf16 value (8 significant bits), or RGLRU_TOL
    _, exp2 = torch.frexp(torch.maximum(hs.float().abs(),
                                        hs_p.float().abs()))
    ulp = torch.ldexp(torch.ones_like(hs_p.float()), exp2 - 8)
    err_hs = max_abs(hs.float(), hs_p.float())
    over = (hs.float() - hs_p.float()).abs() - torch.clamp(ulp,
                                                           min=RGLRU_TOL)
    check(bool(torch.isfinite(hs).all() and torch.isfinite(h_last).all()),
          "non-finite rglru_scan_gated output")
    check(err_last <= RGLRU_TOL, f"rglru_scan_gated h_last vs plain max-abs "
          f"{err_last} > {RGLRU_TOL}")
    check(float(over.max()) <= 0, f"rglru_scan_gated hs vs plain: "
          f"{float(over.max())} past one {RGLRU_GATED_DTYPE} ulp")
    a_c, b_c = rs.rglru_ab(rg, ig, u, c)
    carry = max_abs(b_c, rs.rglru_scan_plain(a_c, b_c))
    check(carry > 100 * RGLRU_TOL, f"the carry is {carry}: a is not near 1")
    n = b * s * r
    # r, i, u read and hs written in bf16, c read, h_last written
    moved = 4 * n * hs.element_size() + 4 * r + 4 * b * r
    # per element 2 exponentials and ~10 float32 operations (the gates'
    # 7, the scan's FMA)
    t_bound, by = bound(moved, 10 * n, exps=2 * n)
    symbol = rs.kernel_symbol(dtype)
    row = {"name": "rglru_scan_gated", "route": "cuda",
           "source": RGLRU_SOURCE, "replaces": RGLRU_GATED_REPLACES,
           "launches": 0, "max_abs_err": err_last,
           "ms": device_ms(lambda: rs.rglru_scan_gated(rg, ig, u, c),
                           device),
           "plain_ms": device_ms(lambda: rs.rglru_scan_gated_plain(
               rg, ig, u, c), device),
           "bound_ms": t_bound, "bound_by": by, "library_ms": None,
           "profiler_ms": profiled_ms(
               lambda: rs.rglru_scan_gated(rg, ig, u, c), symbol)}
    emit("rglru_scan_gated", geometry=f"B{b} S{s} R{r} {RGLRU_GATED_DTYPE}",
         kernel=symbol, tolerance=RGLRU_TOL, equal_to_unfused_chain=True,
         hs_max_abs_vs_plain=err_hs, carry_max_abs=carry, bytes=moved,
         unfused_chain_ms=device_ms(chain, device),
         library_note="no single PyTorch call computes a linear recurrence",
         achieved_tb_per_s=moved / (row["ms"] * 1e-3) / 1e12,
         **{k_: v_ for k_, v_ in row.items() if k_ != "launches"})
    return row


def slstm_work(geom: dict, carry_in: bool = False) -> dict:
    """What one sLSTM call at ``geom`` must do: the four float32
    pre-activations and r and b read once (and the carry, where one is
    given, as in a decode step; a prefill starts it at zero), hs and the
    last carry written once; per element of hs the four products' dh FMAs
    a gate and ~20 float32 operations of the gates' chain. With the bound
    (``bound``: FFMA peak or bytes)."""
    b, s, h, dh = (geom[x] for x in ("batch", "seq", "heads", "head_dim"))
    w_size = 2 if geom["w_dtype"] == "bfloat16" else 4
    n = b * s * h * dh
    carry = 4 * b * h * dh * 4
    moved = 5 * n * 4 + 4 * (h * dh * dh + h * dh) * w_size \
        + carry * (2 if carry_in else 1)
    ops = 2 * 4 * n * dh + 20 * n
    t, by = bound(moved, ops)
    return dict(bytes=moved, flops=ops, bound_ms=t, bound_by=by)


def slstm_operands(geom: dict, device, seed: int):
    """x_g normal, r_g at the spec's init (0.5 / sqrt(h dh)) and b_g normal
    / 2 in the geometry's weight dtype."""
    import torch
    b, s, h, dh = (geom[x] for x in ("batch", "seq", "heads", "head_dim"))
    w_dtype = getattr(torch, geom["w_dtype"])
    gen = torch.Generator().manual_seed(seed)
    xs = [torch.randn(b, s, h, dh, generator=gen).to(device)
          for _ in range(4)]
    rs_ = [(0.5 / (h * dh) ** 0.5 * torch.randn(h, dh, dh, generator=gen))
           .to(device=device, dtype=w_dtype) for _ in range(4)]
    bs = [(0.5 * torch.randn(h, dh, generator=gen)).to(device=device,
                                                       dtype=w_dtype)
          for _ in range(4)]
    return xs, rs_, bs


def slstm_decode(geom: dict, device, rs_, bs) -> dict:
    """The kernel as a decode step runs it: SLSTM_DECODE_STEPS chained
    one-token calls at ``geom``'s batch, heads and head dim from a drawn
    carry (c normal, n >= 0.5, h in (-1, 1), m normal), the kernel
    advancing the carry in place, the plain version a copy of it. Each
    step's h and carry are held at SLSTM_TOL, and the carry must come back
    as the very tensors given; then one step is timed beside its bound."""
    import torch
    from repro_torch.kernels import slstm_scan as ss

    b, h, dh = (geom[x] for x in ("batch", "heads", "head_dim"))
    one = dict(geom, seq=SLSTM_DECODE_STEPS)
    xs = slstm_operands(one, device, 43 + dh)[0]
    gen = torch.Generator().manual_seed(47 + dh)
    draw = [torch.randn(b, h, dh, generator=gen) for _ in range(4)]
    carry = (draw[0], 0.5 + draw[1].abs(), torch.tanh(draw[2]), draw[3])
    carry = tuple(t.to(device) for t in carry)
    mine = tuple(t.clone() for t in carry)
    ptrs = [t.data_ptr() for t in mine]
    errs = []
    for t in range(SLSTM_DECODE_STEPS):
        x_t = [x[:, t:t + 1].contiguous() for x in xs]
        hs, out = ss.slstm_scan(x_t, rs_, bs, mine)
        check([o.data_ptr() for o in out] == ptrs,
              "slstm_scan did not advance the given carry in place")
        hs_p, carry = ss.slstm_scan_plain(x_t, rs_, bs, carry)
        errs.append(max([max_abs(hs, hs_p)]
                        + [max_abs(a, b_) for a, b_ in zip(mine, carry)]))
        check(bool(torch.isfinite(hs).all()),
              "non-finite slstm_scan decode output")
    check(max(errs) <= SLSTM_TOL, f"slstm_scan decode vs plain max-abs "
          f"per step {errs} > {SLSTM_TOL}")
    x_1 = [x[:, :1].contiguous() for x in xs]
    work = slstm_work(dict(geom, seq=1), carry_in=True)
    ms = device_ms(lambda: ss.slstm_scan(x_1, rs_, bs, mine), device)
    return dict(decode_steps=SLSTM_DECODE_STEPS,
                decode_max_abs_per_step=errs, decode_us=ms * 1e3,
                decode_bound_us=work["bound_ms"] * 1e3,
                decode_bound_by=work["bound_by"],
                decode_over_bound=ms / work["bound_ms"])


def slstm_design(geom: dict, device, xs, rs_, bs) -> dict:
    """What a call at ``geom`` launches: ``design``'s cluster, blocks, rows
    a cluster (a row group) and shared memory a block, the library's own
    report of it (which must agree) with the clusters the card holds at
    once, and the distinct SMs the blocks of one launch ran on."""
    import torch
    from repro_torch.kernels import slstm_scan as ss
    w_dtype = rs_[0].dtype
    want = ss.design(geom["batch"], geom["heads"], geom["head_dim"],
                     w_dtype)
    lib = ss.library_design(geom["batch"], geom["heads"], geom["head_dim"],
                            w_dtype)
    check(all(lib[k] == v for k, v in want.items() if k != "grid"),
          f"the library's sLSTM design {lib} is not design()'s {want}")
    sm_ids = torch.full((want["blocks"],), -1, dtype=torch.int32,
                        device=device)
    ss.slstm_scan(xs, rs_, bs, sm_ids=sm_ids)
    ids = sm_ids.cpu()
    check(bool((ids >= 0).all()), f"a block reported no SM: {ids}")
    return dict(cluster=want["cluster"], cols=want["cols"],
                blocks=want["blocks"], sms=len(set(ids.tolist())),
                rows=want["rows"], slots=want["slots"],
                groups=want["groups"], threads=want["threads"],
                smem_bytes=want["smem_bytes"],
                max_active_clusters=lib["max_active_clusters"])


def slstm_phase(geom: dict, device):
    """The sLSTM recurrence kernel at ``geom`` against its plain version on
    the same card tensors (hs and the last carry at SLSTM_TOL), timed
    beside it and its bound, with its design (``slstm_design``), and as a
    decode step runs it (``slstm_decode``). Returns the summary row."""
    import torch
    from repro_torch.kernels import slstm_scan as ss

    b, s, h, dh = (geom[x] for x in ("batch", "seq", "heads", "head_dim"))
    xs, rs_, bs = slstm_operands(geom, device, 41 + dh)
    hs, last = ss.slstm_scan(xs, rs_, bs)
    hs_p, last_p = ss.slstm_scan_plain(xs, rs_, bs)
    err_hs = max_abs(hs, hs_p)
    err_carry = max(max_abs(a, b_) for a, b_ in zip(last, last_p))
    err = max(err_hs, err_carry)
    check(bool(torch.isfinite(hs).all()), "non-finite slstm_scan output")
    check(err <= SLSTM_TOL, f"slstm_scan vs plain max-abs {err} > "
          f"{SLSTM_TOL}")
    decode = slstm_decode(geom, device, rs_, bs)
    design = slstm_design(geom, device, xs, rs_, bs)
    work = slstm_work(geom)
    symbol = ss.kernel_symbol(rs_[0].dtype, b)
    # (the comparison's plain call above was the plain version's warm-up)
    row = {"name": "slstm_scan", "route": "cuda", "source": SLSTM_SOURCE,
           "replaces": SLSTM_REPLACES, "launches": 0, "max_abs_err": err,
           "ms": device_ms(lambda: ss.slstm_scan(xs, rs_, bs), device),
           "plain_ms": device_ms(lambda: ss.slstm_scan_plain(xs, rs_, bs),
                                 device, reps=SLSTM_PLAIN_REPS, warmup=0),
           "bound_ms": work["bound_ms"], "bound_by": work["bound_by"],
           "library_ms": None,
           "profiler_ms": profiled_ms(lambda: ss.slstm_scan(xs, rs_, bs),
                                      symbol)}
    emit("slstm_scan", geometry=f"B{b} S{s} H{h} dh{dh} "
         f"weights {geom['w_dtype']}", kernel=symbol, tolerance=SLSTM_TOL,
         hs_max_abs=err_hs, carry_max_abs=err_carry, bytes=work["bytes"],
         flops=work["flops"], plain_reps=SLSTM_PLAIN_REPS,
         library_note="no single PyTorch call computes the sLSTM recurrence",
         achieved_tflop_per_s=work["flops"] / (row["ms"] * 1e-3) / 1e12,
         us_per_step=row["ms"] * 1e3 / s, design=design,
         **decode, **{k_: v_ for k_, v_ in row.items() if k_ != "launches"})
    return row


def _lm_prompts(cfg, batch: int, length: int, seed: int):
    import torch
    return torch.randint(0, cfg.vocab_size, (batch, length),
                         generator=torch.Generator().manual_seed(seed),
                         dtype=torch.int32)


def _lm_frames(cfg, batch: int, seed: int, device):
    """An encoder-decoder's encoder input, (batch, encoder_seq, d_model)
    frame embeddings drawn from a seeded normal distribution on ``device``
    (as the reference's launcher draws them; the audio frontend is a stub),
    or None for a decoder-only config."""
    import torch
    if not cfg.is_encdec:
        return None
    return torch.randn((batch, cfg.encoder_seq, cfg.d_model),
                       generator=torch.Generator(device).manual_seed(seed),
                       device=device)


def scan_wrapper() -> str:
    """The scan wrapper an RG-LRU layer's prefill launches: the gated
    instance, or, in a port from before it (scripts/lm_ab.py runs the LM
    phase on older versions), the ungated one."""
    from repro_torch.kernels import rglru_scan as rs
    return ("rglru_scan_gated" if hasattr(rs, "rglru_scan_gated")
            else "rglru_scan")


def lm_launches(cfg, new_tokens: int) -> dict:
    """The kernel launches of one generate of ``new_tokens`` tokens of
    ``cfg``: in the prefill one flash launch an attention layer (global,
    local or MLA; an encoder-decoder's encoder layers too, and its decoder
    layers' cross-attention), one gated scan an RG-LRU layer and one sLSTM
    launch an sLSTM layer; in each of the ``new_tokens - 1`` decode steps
    one sLSTM launch an sLSTM layer and nothing else; the MoE none (plain
    products)."""
    mixers = [mx for mx, _ in cfg.layer_kinds()]
    cross = cfg.encoder_layers + len(mixers) if cfg.is_encdec else 0
    want = {"flash_attention": sum(mx in ("attn", "local_attn", "mla")
                                   for mx in mixers) + cross,
            scan_wrapper(): mixers.count("rglru"),
            "slstm_scan": mixers.count("slstm") * new_tokens}
    return {k: v for k, v in want.items() if v}


def lm_symbol(cfg, seq: int = LM_PROMPT):
    """The flash instance every attention layer of ``cfg`` launches at a
    prompt of ``seq`` tokens (a local layer's with the config's window,
    where that hides a key); None for a model without attention."""
    import inspect
    from repro_torch.kernels import flash_attention as fa
    if not {"attn", "local_attn", "mla"} & set(cfg.block_pattern):
        return None
    if "mla" in cfg.block_pattern:     # qk: nope + rope columns; v: nope
        dh = cfg.resolved_head_dim
        return fa.kernel_symbol(cfg.dtype, dh + cfg.rope_head_dim, v_dim=dh)
    if "local_attn" in cfg.block_pattern:
        # (scripts/lm_ab.py runs this on older versions, whose window
        # picked the instance whatever the length)
        if "seq" in inspect.signature(fa.kernel_symbol).parameters:
            return fa.kernel_symbol(cfg.dtype, cfg.resolved_head_dim,
                                    cfg.window, seq)
        return fa.kernel_symbol(cfg.dtype, cfg.resolved_head_dim, cfg.window)
    # (no window argument: scripts/lm_ab.py runs this on older versions)
    return fa.kernel_symbol(cfg.dtype, cfg.resolved_head_dim)


# the profiler ranges of ``stage_spans``: the MoE stages, the xLSTM mixers
SPAN_PREFIXES = ("moe:", "xlstm:", "whisper:")


@contextlib.contextmanager
def stage_spans(module, stages: dict, prefix: str):
    """For the length of the block, each function of ``module`` named in
    ``stages`` (``{stage: function name}``) runs inside a profiler range
    ``<prefix>:<stage>``, whose device time (``stage_ms``) is that of the
    kernels it launched (a nested range's kernels count in both)."""
    import torch
    saved = {name: getattr(module, fn) for name, fn in stages.items()}

    def spanned(name, fn):
        def call(*args, **kwargs):
            with torch.profiler.record_function(f"{prefix}:{name}"):
                return fn(*args, **kwargs)
        return call

    for name, fn in stages.items():
        setattr(module, fn, spanned(name, saved[name]))
    try:
        yield
    finally:
        for name, fn in stages.items():
            setattr(module, fn, saved[name])


def stage_ms(prof, stages: dict, prefix: str) -> dict:
    """Device ms of the kernels launched inside each ``<prefix>:<stage>``
    range of a profile taken under ``stage_spans``."""
    from torch.autograd import DeviceType
    out = {name: 0.0 for name in stages}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CPU \
                and evt.key.startswith(f"{prefix}:"):
            out[evt.key[len(prefix) + 1:]] += evt.device_time_total / 1e3
    return out


def lm_phase(device, smi: str, arch: str = LM_ARCH, path: str = "lm",
             layers: int = 0, batch: int = LM_BATCH, prompt: int = LM_PROMPT,
             new_tokens: int = LM_NEW):
    """``arch`` at full width and depth (or ``layers`` layers: a depth
    cut) through ``ServingEngine.generate`` of ``batch`` prompts of
    ``prompt`` tokens for ``new_tokens`` (an encoder-decoder's with seeded
    frame embeddings, ``_lm_frames``), the launch counts read from that
    run alone (checked against ``path``'s kernels and ``lm_launches``);
    returns them."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import lm
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.engine import pad_prefill_cache

    cfg = get_arch(arch)
    cut = None
    if layers:
        cut = f"depth {cfg.num_layers} -> {layers}"
        cfg = dataclasses.replace(cfg, num_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(0, cfg, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(t.numel() for t in _leaves(params))
    prompts = _lm_prompts(cfg, batch, prompt, 29).to(device)
    frames = _lm_frames(cfg, batch, 37, device)
    # (scripts/lm_ab.py runs this on older versions, whose engine takes no
    # encoder input)
    enc = {} if frames is None else {"encoder_embeddings": frames}
    engine = ServingEngine(cfg, params, max_len=prompt + new_tokens,
                           device=device)

    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    tokens = engine.generate(prompts, new_tokens, **enc)
    counts = cuda_lib.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    first = dict(engine.stats)
    # (a port from before the gated scan launches the ungated one)
    check_path_counts(counts, path, tuple(
        scan_wrapper() if k_ == "rglru_scan_gated" else k_
        for k_ in PATH_KERNELS[path]))
    want = lm_launches(cfg, new_tokens)
    check({k_: v_ for k_, v_ in counts.items() if v_} == want,
          f"{arch} launched {counts}, want {want} (one flash launch an "
          "attention layer, one scan an RG-LRU layer, one sLSTM launch an "
          "sLSTM layer in the prefill and in each decode step)")
    logits = engine.prefill_logits.float()
    check(tuple(tokens.shape) == (batch, new_tokens), "generated shape")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          "token ids out of range")
    check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")

    # teacher forcing: the prefill's last-position logits == a train-mode
    # forward over the prompt
    with torch.inference_mode():
        ref, _ = lm.forward(engine.params, prompts, cfg, mode="train", **enc)
    ref = ref[:, -1].float()
    tf_err = max_abs(logits, ref)
    check(tf_err <= LM_TEACHER_TOL,
          f"prefill logits vs train forward max-abs {tf_err}")
    top2 = torch.topk(ref, 2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 2 * LM_TEACHER_TOL
    check(bool((ref.argmax(-1) == tokens[:, 0].long())[sure].all()),
          "first generated token != teacher-forced argmax")

    steady = []
    for _ in range(2):
        engine.generate(prompts, new_tokens, **enc)
        steady.append(dict(engine.stats))
    # (xlstm-350m's line is named for its path; the others are "lm")
    emit("lm_xlstm" if path == "lm_xlstm" else "lm", model=arch,
         path=path, layers=cfg.num_layers, cut=cut,
         d_model=cfg.d_model,
         heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
         head_dim=cfg.resolved_head_dim, d_ff=cfg.d_ff,
         moe=dict(experts=cfg.num_experts, top_k=cfg.top_k,
                  shared=cfg.num_shared_experts,
                  capacity_factor=cfg.capacity_factor,
                  dense_d_ff=cfg.dense_d_ff,
                  mlps=[m for _, m in cfg.layer_kinds()])
         if cfg.num_experts else None,
         mla=dict(kv_lora_rank=cfg.kv_lora_rank, q_lora_rank=cfg.q_lora_rank,
                  rope_head_dim=cfg.rope_head_dim)
         if "mla" in cfg.block_pattern else None,
         encoder=dict(layers=cfg.encoder_layers, frames=cfg.encoder_seq)
         if cfg.is_encdec else None,
         mixers={mx: [k_ for k_, _ in cfg.layer_kinds()].count(mx)
                 for mx in cfg.block_pattern},
         window=cfg.window if "local_attn" in cfg.block_pattern else None,
         vocab=cfg.vocab_size, dtype=cfg.param_dtype, params=n_params,
         init_s=init_s, init_peak_memory_gb=init_peak_gb, batch=batch,
         prompt=prompt, new_tokens=new_tokens,
         launches=counts, first_run=first, steady_runs=steady,
         peak_memory_gb=peak_gb, teacher_forcing_max_abs=tf_err,
         teacher_forcing_tol=LM_TEACHER_TOL,
         teacher_forcing_checked_rows=int(sure.sum()), nvidia_smi=smi)

    # device time of one prefill by family and by kernel (and, with experts,
    # by MoE stage; in an xLSTM by mixer stage), and of one decode step
    # against its wall time (the device's idle share while decoding)
    symbol = lm_symbol(cfg, prompt)
    n_flash = want.get("flash_attention", 0)
    n_slstm = want.get("slstm_scan", 0) // new_tokens
    xlstm = bool({"mlstm", "slstm"} & set(cfg.block_pattern))
    from repro_torch.models import blocks, recurrent
    spans = (stage_spans(blocks, MOE_STAGES, "moe") if cfg.num_experts else
             stage_spans(recurrent, XLSTM_STAGES, "xlstm") if xlstm
             else stage_spans(lm, WHISPER_STAGES, "whisper") if cfg.is_encdec
             else contextlib.nullcontext())
    # (every launch the checks below count must be kept: the tracer once
    # dropped one of a prefill's 32 flash launches)
    from repro_torch.kernels import rglru_scan as rs
    scan_name = scan_wrapper()
    n_scan = want.get(scan_name, 0)
    expect = {x: n for x, n in (("flash", n_flash), (SLSTM_KERNELS, n_slstm),
                                ("rglru_scan_kernel", n_scan)) if n}
    with torch.inference_mode(), spans:
        prof, (_, cache) = profile_session(
            lambda: engine.prefill(engine.params, prompts, *enc.values()),
            expect=expect)
    fam, top = device_breakdown(prof, LM_FAMILIES, 12)
    total = sum(fam.values())
    moe_ms = stage_ms(prof, MOE_STAGES, "moe") if cfg.num_experts else None
    # the LM head over every prompt position, alone
    head = (params["embed"]["w"].T if cfg.tie_embeddings
            else params["lm_head"]["w"])
    hidden = torch.randn((batch * prompt, cfg.d_model),
                         generator=torch.Generator(device).manual_seed(3),
                         device=device, dtype=cfg.dtype)
    lm_head_ms = device_ms(lambda: hidden @ head.to(cfg.dtype), device,
                           reps=5)
    del hidden
    # every flash launch of the prefill is the serving width's one kernel
    # instance (a model without attention launches none), every scan the
    # scan kernel and every sLSTM launch the weights' dtype's instance
    from torch.autograd import DeviceType
    flash_ran = {e.key: e.count for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and "flash" in e.key}
    check((not n_flash and not flash_ran)
          or (len(flash_ran) == 1 and symbol in next(iter(flash_ran))
              and next(iter(flash_ran.values())) == n_flash),
          f"prefill flash launches {flash_ran}, want {n_flash} of {symbol}")
    slstm_ran = {e.key: e.count for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and any(name in e.key for name in SLSTM_KERNELS)}
    slstm_symbol = None
    if n_slstm:     # (a port from before the kernel has no sLSTM layer)
        import inspect
        from repro_torch.kernels import slstm_scan as ss
        # (scripts/lm_ab.py runs this on older versions, whose instance
        # the weights' dtype alone named)
        slstm_symbol = (
            ss.kernel_symbol(cfg.pdtype, batch)
            if len(inspect.signature(ss.kernel_symbol).parameters) > 1
            else ss.kernel_symbol(cfg.pdtype))
    check(sum(slstm_ran.values()) == n_slstm
          and all(slstm_symbol in key for key in slstm_ran),
          f"prefill sLSTM launches {slstm_ran}, want {n_slstm} of "
          f"{slstm_symbol}")
    # an xLSTM prefill by stage: the mLSTM layers' chunkwise ops and
    # projections, the sLSTM kernel and the sLSTM layers' projections, and
    # the rest (embedding, norms, residuals, the LM head). The profiler
    # ties a PyTorch op's kernels to the range around it, but not the
    # sLSTM kernel, launched through ctypes: the sLSTM range holds the
    # projections alone, and the kernel comes from its family
    xlstm_ms = None
    if xlstm:
        st = stage_ms(prof, XLSTM_STAGES, "xlstm")
        check(st["slstm_layers"] < fam["slstm_scan"],
              f"the sLSTM range ({st['slstm_layers']} ms) holds the kernel "
              f"({fam['slstm_scan']} ms): the split would count it twice")
        xlstm_ms = dict(
            mlstm_chunk_ops=st["mlstm_chunk_ops"],
            mlstm_projections=st["mlstm_layers"] - st["mlstm_chunk_ops"],
            slstm_kernel=fam["slstm_scan"],
            slstm_projections=st["slstm_layers"],
            rest=(total - st["mlstm_layers"] - st["slstm_layers"]
                  - fam["slstm_scan"]))
    # every scan of the prefill is the gated instance of the compute dtype
    # (in a port from before it, the one scan kernel)
    scan_symbol = (rs.kernel_symbol(cfg.dtype)
                   if scan_name == "rglru_scan_gated" else "rglru_scan_kernel")
    scan_ran = {e.key: e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and "rglru_scan_kernel" in e.key}
    scans = sum(scan_ran.values())
    check(scans == n_scan
          and all(scan_symbol in key for key in scan_ran),
          f"prefill scan launches {scan_ran}, want {n_scan} of {scan_symbol}")
    # an encoder-decoder prefill by stage: the encoder, the decoder (its
    # self-attention, cross blocks and MLPs) and the rest (the embedding,
    # the final norm, the LM head over every position)
    whisper_ms = None
    if cfg.is_encdec:
        st = stage_ms(prof, WHISPER_STAGES, "whisper")
        whisper_ms = dict(**st, rest=total - st["encoder"] - st["decoder"])
    with torch.inference_mode():
        cache = pad_prefill_cache(cfg, cache, batch, prompt + new_tokens)
        tok = tokens[:, :1]
        tok, cache = engine.decode(engine.params, cache, tok)   # warm-up
        prof_d, _ = profile_session(
            lambda: engine.decode(engine.params, cache, tok))
        # decode's cross block: one layer's plain attention of a token over
        # the cached encoder K/V (the reference's ops), alone
        cross_decode_ms = None
        if cfg.is_encdec:
            lc = cache["decoder"]["body"]["l0"]
            q1 = torch.randn((batch, 1, cfg.num_heads,
                              cfg.resolved_head_dim), device=device,
                             dtype=cfg.dtype)
            cross_decode_ms = device_ms(lambda: blocks.decode_attention(
                q1, lc["enc_k"][0], lc["enc_v"][0], cfg.encoder_seq),
                device)
    fam_d, top_d = device_breakdown(prof_d, LM_FAMILIES, 12)
    decode_device = sum(fam_d.values())
    decode_wall = statistics.median(r["decode_ms_per_token"] for r in steady)
    check(fam_d["flash_attention"] == 0.0,
          f"a decode step of {arch} ran a flash kernel")
    emit("lm_profile", model=arch, layers=cfg.num_layers,
         flash_kernel=symbol,
         flash_launches_in_prefill=n_flash, scan_launches_in_prefill=scans,
         scan_kernels_in_prefill=scan_ran,
         slstm_kernels_in_prefill=slstm_ran,
         slstm_share=fam["slstm_scan"] / total if total else None,
         prefill_xlstm_device_ms=xlstm_ms,
         prefill_device_ms=fam, prefill_device_ms_total=total,
         flash_share=fam["flash_attention"] / total if total else None,
         scan_share=fam["rglru_scan"] / total if total else None,
         prefill_moe_device_ms=moe_ms,
         prefill_encdec_device_ms=whisper_ms,
         cross_decode_attention_ms_per_layer=cross_decode_ms,
         moe_share=(sum(moe_ms.values()) / total
                    if moe_ms and total else None),
         lm_head_ms=lm_head_ms,
         prefill_top_kernels=top, decode_step_device_ms=fam_d,
         decode_step_device_ms_total=decode_device,
         decode_step_wall_ms_median=decode_wall,
         decode_device_idle_share=1.0 - decode_device / decode_wall,
         decode_top_kernels=top_d)
    del engine, params, ref, cache, head
    torch.cuda.empty_cache()
    return counts


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def bf16_ulp(x):
    """One bf16 ulp at each value of x (a float tensor): 2^(e - 8) for |x|
    in [2^(e - 1), 2^e)."""
    import torch
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


@contextlib.contextmanager
def recording_routes():
    """For the length of the block, every call of the port's MoE routing
    (``blocks.moe_route``) is logged: its router logits (float32), the
    top-k indices and the keep flags, on the host."""
    from repro_torch.models import blocks
    route = blocks.moe_route
    log = []

    def recording(logits, k, capacity):
        out = route(logits, k, capacity)
        log.append(dict(logits=logits.float().cpu(), idx=out[1].cpu(),
                        keeps=out[3].cpu(), k=k))
        return out

    blocks.moe_route = recording
    try:
        yield log
    finally:
        blocks.moe_route = route


def route_diffs(card: dict, cpu: dict) -> dict:
    """Card against CPU for one routing call: the rows whose top-k sets
    differ (``flips``), each with its gap between the k-th and the (k+1)-th
    CPU router logit and whether that lies within 2 bf16 ulps of the k-th
    logit (``near_tie``), and the rows served by another set of experts
    (``differ``: a flip, or a keep flag, since a flip moves other rows'
    places in an expert's queue, so a row may drop on one side alone; an
    order alone within the top k changes only the combine's rounding)."""
    import torch
    k = cpu["k"]
    flips = ((card["idx"].sort(-1).values != cpu["idx"].sort(-1).values)
             .any(-1).nonzero()[:, 0].tolist())
    top = cpu["logits"].sort(-1, descending=True).values
    kth = top[:, k - 1]
    gap, ulp = kth - top[:, k], bf16_ulp(kth)

    def served(log):   # (T, E): the experts that serve each row
        mask = torch.zeros(log["logits"].shape, dtype=torch.bool)
        return mask.scatter_(1, log["idx"], log["keeps"].T)

    differ = (served(card) != served(cpu)).any(-1)
    return dict(flips=[dict(row=r, gap=float(gap[r]), ulp=float(ulp[r]),
                            near_tie=bool(gap[r] <= 2 * ulp[r]))
                       for r in flips],
                differ=differ.nonzero()[:, 0].tolist(), rows=len(kth))


def lm_vs_cpu_phase(device, arch: str = LM_ARCH, phase: str = "lm_vs_cpu",
                    layers: int = 2, experts: int = 0, prompt: int = 128,
                    batch: int = 1):
    """``arch`` at full width, ``layers`` layers (and ``experts`` experts,
    where given: a cut of an MoE config on both sides): the card's engine
    against the CPU engine on ``batch`` prompts of ``prompt`` tokens (an
    encoder-decoder's with seeded frame embeddings, the same on both
    sides), with its launch counts (one flash launch an attention or MLA
    layer, an encoder layer or a cross block, one scan an RG-LRU layer,
    nothing else). Prefill logits, and the logits of every decode step fed
    the CPU's tokens, within LM_CPU_TOL; each row's greedy tokens equal up
    to the first step whose CPU top-1/top-2 margin is within twice the
    tolerance (after a divergence the contexts differ). With experts (the
    one MoE layer
    last, so that a routing reaches no other position), a token whose
    top-k set differs between card and CPU must sit at a near tie (2 bf16
    ulps), and a compared position whose own routing differs leaves the
    logits comparison (counted)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import lm
    from repro_torch.models.params import to_device
    from repro_torch.serving import ServingEngine

    full = get_arch(arch)
    over = dict(num_layers=layers)
    cut = (f"depth {full.num_layers} -> {layers}"
           if layers != full.num_layers else None)
    if experts:
        over["num_experts"] = experts
        cut += f", experts {full.num_experts} -> {experts}"
    cfg = dataclasses.replace(full, **over)
    moe = cfg.num_experts > 0
    if moe:
        check(all(m != "moe" for _, m in cfg.layer_kinds()[:-1])
              and batch == 1,
              f"{arch} at {layers} layers has an MoE layer before the last,"
              f" or a batch of {batch} (the routing comparison takes one)")
    params = lm.init_params(1, cfg, device=device)
    prompts = _lm_prompts(cfg, batch, prompt, 31)
    frames = _lm_frames(cfg, batch, 43, torch.device("cpu"))
    enc = {} if frames is None else {"encoder_embeddings": frames}
    n_new = 8
    gpu = ServingEngine(cfg, params, max_len=prompt + n_new, device=device)
    cuda_lib.reset_launch_counts()
    tok_gpu = gpu.generate(prompts, n_new, **enc).cpu()
    counts = cuda_lib.launch_counts()
    want = lm_launches(cfg, n_new)
    check({k_: v_ for k_, v_ in counts.items() if v_} == want,
          f"{arch} launches {counts}, want {want}")
    params_cpu = to_device(params, torch.device("cpu"))
    cpu = ServingEngine(cfg, params_cpu, max_len=prompt + n_new,
                        device="cpu")
    tok_cpu = cpu.generate(prompts, n_new, **enc)
    # both devices decode the CPU's tokens: the logits of every step, so the
    # decode path is compared too, and the CPU's margins
    forced, logs = [], []
    for p_, dev_ in ((params, device), (params_cpu, cpu.device)):
        with recording_routes() as log:
            forced.append(_forced_decode_logits(cfg, p_, prompts, tok_cpu,
                                                dev_, frames))
        logs.append(log)
    # per compared position (the prefill's last, then each decode step's
    # token): whether its own routing differs; every set flip a near tie
    diffs = [route_diffs(a, b) for a, b in zip(*logs)] if moe else []
    flips = [f for d_ in diffs for f in d_["flips"]]
    check(all(f["near_tie"] for f in flips),
          f"{arch}: card and CPU route a token differently away from a "
          f"near tie: {flips}")
    n_moe = sum(m == "moe" for _, m in cfg.layer_kinds())
    moved = [False] * n_new
    for c, d_ in enumerate(diffs):     # per layer: the prefill, then steps
        step = c // n_moe
        last = d_["rows"] - 1
        moved[step] |= last in d_["differ"]
    err = max_abs(gpu.prefill_logits.float().cpu(),
                  cpu.prefill_logits.float())
    check(moved[0] or err <= LM_CPU_TOL,
          f"card vs CPU prefill logits max-abs {err} > {LM_CPU_TOL}")
    # per step, the largest error over the batch's rows
    step_err = (forced[0] - forced[1]).abs().amax(dim=-1).amax(dim=0)
    step_err = step_err.tolist()
    held = [e_ for e_, m_ in zip(step_err, moved) if not m_]
    check(max(held, default=0.0) <= LM_CPU_TOL,
          f"card vs CPU decode logits max-abs {max(held, default=0.0)}")
    top2 = torch.topk(forced[1], 2, dim=-1).values
    margins = (top2[..., 0] - top2[..., 1]).tolist()     # (B, n)
    equal = []
    for r in range(batch):
        equal.append(0)
        for i in range(n_new):
            if int(tok_gpu[r, i]) != int(tok_cpu[r, i]):
                check(moved[i] or margins[r][i] <= 2 * LM_CPU_TOL,
                      f"row {r} token {i} differs at a CPU margin "
                      f"{margins[r][i]}")
                break
            equal[r] += 1
    emit(phase, model=arch, layers=layers, cut=cut,
         head_dim=cfg.resolved_head_dim,
         flash_kernel=lm_symbol(cfg, prompt), launches=counts,
         prompt=prompt, new_tokens=n_new,
         prefill_logits_max_abs=err,
         tolerance=LM_CPU_TOL, decode_logits_max_abs_per_step=step_err,
         positions_routed_differently=[i for i, m_ in enumerate(moved)
                                       if m_],
         route_flips=flips, batch=batch,
         encoder_frames=cfg.encoder_seq if cfg.is_encdec else None,
         tokens_equal_before_divergence=equal if batch > 1 else equal[0],
         tokens_gpu=tok_gpu.tolist() if batch > 1 else tok_gpu[0].tolist(),
         tokens_cpu=tok_cpu.tolist() if batch > 1 else tok_cpu[0].tolist(),
         cpu_margins=margins if batch > 1 else margins[0],
         gpu_stats=gpu.stats, cpu_stats=cpu.stats)
    del gpu, params
    torch.cuda.empty_cache()


def moe_routing_phase(device, arch: str = LM_MLA_ARCH):
    """One MoE layer of ``arch`` at full width (every expert, top-k and the
    capacity factor; seeded bf16 weights drawn on the card) on a seeded
    (4, 2048) bf16 input, card against CPU: the share of tokens whose top-k
    sets differ, each such token's gap between its k-th and (k+1)-th CPU
    router logit, which must lie within 2 bf16 ulps of that logit, and the
    layer's output max-abs on the tokens routed alike (indices and keep
    flags), within LM_CPU_TOL; with the card's stage times."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import blocks
    from repro_torch.models.params import init_tree, to_device

    cfg = get_arch(arch)
    gen = torch.Generator(device).manual_seed(5)
    params = init_tree(gen, blocks.moe_spec(cfg), device=device,
                       dtype=cfg.pdtype)
    x = torch.randn((LM_BATCH, LM_PROMPT, cfg.d_model), device=device,
                    generator=gen, dtype=torch.float32).to(cfg.dtype)
    cuda_lib.reset_launch_counts()
    with torch.inference_mode(), recording_routes() as log_card:
        out = blocks.moe_apply(params, x, cfg)
        torch.cuda.synchronize()
    check(not any(cuda_lib.launch_counts().values()),
          "the MoE layer launched a kernel of the port")
    wall_card = device_ms(lambda: blocks.moe_apply(params, x, cfg), device,
                          reps=5)
    params_cpu = to_device(params, torch.device("cpu"))
    t0 = time.perf_counter()
    with torch.inference_mode(), recording_routes() as log_cpu:
        ref = blocks.moe_apply(params_cpu, x.cpu(), cfg)
    cpu_s = time.perf_counter() - t0
    d_ = route_diffs(log_card[0], log_cpu[0])
    check(all(f["near_tie"] for f in d_["flips"]),
          f"card and CPU route tokens differently away from a near tie: "
          f"{[f for f in d_['flips'] if not f['near_tie']]}")
    alike = torch.ones(d_["rows"], dtype=torch.bool)
    alike[d_["differ"]] = False
    err = max_abs(out.float().cpu().reshape(-1, cfg.d_model)[alike],
                  ref.float().reshape(-1, cfg.d_model)[alike])
    check(err <= LM_CPU_TOL,
          f"MoE layer card vs CPU max-abs {err} on tokens routed alike")
    t, k = d_["rows"], cfg.top_k
    cap = int(math.ceil(t * k / cfg.num_experts * cfg.capacity_factor))
    # the stages alone on the card, event pairs
    with torch.inference_mode():
        logits = x.reshape(-1, cfg.d_model) @ params["router"]
        gates, _, slots, keeps = blocks.moe_route(logits, k, cap)
        buf = blocks._moe_dispatch(x.reshape(-1, cfg.d_model), slots,
                                   cfg.num_experts * cap)
        e_in = buf.reshape(cfg.num_experts, cap, -1)
        e_out = blocks._expert_ffn(params["w1"], params["w2"],
                                   params["w3"], e_in).reshape(buf.shape)
        stage_ms = {
            "router": device_ms(lambda: x.reshape(-1, cfg.d_model)
                                @ params["router"], device, reps=5),
            "route": device_ms(lambda: blocks.moe_route(logits, k, cap),
                               device, reps=5),
            "dispatch": device_ms(lambda: blocks._moe_dispatch(
                x.reshape(-1, cfg.d_model), slots, cfg.num_experts * cap),
                device, reps=5),
            "experts": device_ms(lambda: blocks._expert_ffn(
                params["w1"], params["w2"], params["w3"], e_in), device,
                reps=5),
            "combine": device_ms(lambda: blocks._moe_combine(
                e_out, slots, keeps, gates), device, reps=5)}
    emit("lm_moe_routing", model=arch, d_model=cfg.d_model,
         experts=cfg.num_experts, top_k=k, capacity=cap,
         capacity_factor=cfg.capacity_factor, tokens=t,
         dropped_assignments=int((~log_card[0]["keeps"]).sum()),
         flipped_share=len(d_["flips"]) / t, flips=d_["flips"][:50],
         routed_differently=len(d_["differ"]),
         max_abs_alike=err, tolerance=LM_CPU_TOL,
         moe_layer_device_ms=wall_card, stage_device_ms=stage_ms,
         cpu_seconds=cpu_s)
    del params, params_cpu, out, ref, buf, e_in, e_out
    torch.cuda.empty_cache()


def lm_ring_phase(device):
    """recurrentgemma-2b at full width, LM_RG_LAYERS layers (one period of
    its pattern), a prompt of LM_RG_RING_PROMPT tokens, past its 2048-key
    window: each decode step's logits (the engine's ring cache holding
    position p at slot p % 2048) against a card ``forward(mode="train")``
    over the prompt and the tokens so far, at LM_TEACHER_TOL; greedy
    tokens equal to the train forward's argmax where its top-2 margin
    exceeds twice that."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import lm
    from repro_torch.serving import ServingEngine

    cfg = dataclasses.replace(get_arch(LM_RG_ARCH), num_layers=LM_RG_LAYERS)
    params = lm.init_params(2, cfg, device=device)
    batch, n_new, s = 2, 8, LM_RG_RING_PROMPT
    prompts = _lm_prompts(cfg, batch, s, 41).to(device)
    engine = ServingEngine(cfg, params, max_len=s + n_new, device=device)
    cuda_lib.reset_launch_counts()
    tokens = engine.generate(prompts, n_new)
    counts = cuda_lib.launch_counts()
    want = lm_launches(cfg, n_new)
    check({k_: v_ for k_, v_ in counts.items() if v_} == want,
          f"ring launches {counts}, want {want}")
    ring = engine.prefill(params, prompts)[1]["decoder"]["body"]["l2"]
    check(ring["mixer"]["k"].shape[1] == cfg.window,
          f"the local layer's prefill cache holds "
          f"{ring['mixer']['k'].shape[1]} rows, want the {cfg.window} slots")
    decoded = _forced_decode_logits(cfg, params, prompts, tokens, device)
    errs, sure_ok = [], 0
    with torch.inference_mode():
        for i in range(n_new):
            seq = torch.cat([prompts, tokens[:, :i].to(prompts.dtype)], 1)
            ref = lm.forward(params, seq, cfg, mode="train")[0][:, -1]
            ref = ref.float().cpu()
            errs.append(max_abs(decoded[:, i], ref))
            top2 = torch.topk(ref, 2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > 2 * LM_TEACHER_TOL
            check(bool((ref.argmax(-1) == tokens[:, i].long().cpu())[sure]
                       .all()), f"ring token {i} != the train forward's")
            sure_ok += int(sure.sum())
    check(max(errs) <= LM_TEACHER_TOL,
          f"ring decode logits vs train forward max-abs {max(errs)} > "
          f"{LM_TEACHER_TOL}")
    emit("lm_rg_ring", model=LM_RG_ARCH, layers=LM_RG_LAYERS,
         cut=f"depth {get_arch(LM_RG_ARCH).num_layers} -> {LM_RG_LAYERS}",
         window=cfg.window, prompt=s, batch=batch, new_tokens=n_new,
         flash_kernel=lm_symbol(cfg, s), launches=counts,
         logits_max_abs_per_step=errs, tolerance=LM_TEACHER_TOL,
         checked_tokens=sure_ok, stats=engine.stats)
    del engine, params
    torch.cuda.empty_cache()


def _forced_decode_logits(cfg, params, prompts, tokens, device,
                          frames=None):
    """Last-position logits of the prefill (over the encoder's ``frames``,
    where given) and of each decode step fed ``tokens[:, i]``, float32 on
    the host: (B, n, vocab)."""
    import torch
    from repro_torch.models import lm
    from repro_torch.serving.engine import make_prefill_step, pad_prefill_cache

    n = tokens.shape[1]
    enc = () if frames is None else (frames.to(device),)
    with torch.inference_mode():
        last, cache = make_prefill_step(cfg)(params, prompts.to(device),
                                             *enc)
        cache = pad_prefill_cache(cfg, cache, prompts.shape[0],
                                  prompts.shape[1] + n)
        out = [last.float().cpu()]
        for i in range(n - 1):
            logits, cache = lm.forward(params, tokens[:, i:i + 1].to(device),
                                       cfg, mode="decode", cache=cache)
            out.append(logits[:, -1].float().cpu())
    return torch.stack(out, dim=1)


# the obs phase: the phase 4 engine streaming OBS_BATCHES batches of 16 at
# microbatch OBS_MICROBATCH; the sleep kernel ahead of the deferred step
# (about 0.1 s at the H100's SM clock) and ahead of each timed dispatch
OBS_BATCHES, OBS_MICROBATCH = 8, 8
OBS_SLEEP_CYCLES = 200_000_000
OBS_HOST_SLEEP_CYCLES = 20_000_000
OBS_HOST_REPS = 10
OBS_WALL_TURNS = 3
OBS_FLEET_ROUNDS = 3


# the spans a VisionEngine stream opens: in a profile each is also a
# device-side user annotation over the kernels it launched
OBS_SPANS = ("stream", "microbatch")


# profiles of the two streams taken until their device events agree: the
# tracer now and then drops an event of a long session (profile_session),
# while a kernel obs added would show in every pair
OBS_PROFILE_PAIRS = 3
# batches of the profiled stream: a shorter session than the counted one
# (a session of ~9,600 device events lost one or two of them)
OBS_PROFILED_BATCHES = 2


def profiled_kernels(prof) -> dict:
    """{name: count} of a profile's device events that are kernels or
    copies (the markers and the spans' device-side annotations left
    out)."""
    from torch.autograd import DeviceType
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not is_marker(e)
            and e.key not in OBS_SPANS}


def profiled_pair(plain, instr, batches) -> tuple:
    """Profiles of one more stream of each engine, taken in pairs until
    their kernels and copies agree: (plain counts, instrumented counts,
    the instrumented profile's event names, each pair's differing
    events)."""
    diffs = []
    for _ in range(OBS_PROFILE_PAIRS):
        prof_p, _ = profile_session(lambda: list(plain.stream(batches)))
        prof_o, _ = profile_session(lambda: list(instr.stream(batches)))
        k_p, k_o = profiled_kernels(prof_p), profiled_kernels(prof_o)
        diffs.append({k[:60]: (k_p.get(k, 0), k_o.get(k, 0))
                      for k in set(k_p) | set(k_o)
                      if k_p.get(k, 0) != k_o.get(k, 0)})
        if k_p == k_o:
            break
    return k_p, k_o, {e.key for e in prof_o.key_averages()}, diffs


def obs_stream_pair(cfg, params, batches, device, fused_stream):
    """The same stream through ``VisionEngine`` with ``obs=None`` and with
    an ``Obs``, each engine's launches read from its run alone; returns
    ((engine, outs, counts) without obs, the same with obs, the Obs)."""
    import repro_torch.obs as obs_mod
    from repro_torch.kernels import cuda_lib
    from repro_torch.serving import VisionEngine
    obs = obs_mod.Obs()
    runs = []
    for o in (None, obs):
        eng = VisionEngine(cfg, params, seed=0, device=device,
                           microbatch=OBS_MICROBATCH,
                           fused_stream=fused_stream, obs=o)
        cuda_lib.reset_launch_counts()
        outs = list(eng.stream(batches))
        runs.append((eng, outs, cuda_lib.launch_counts()))
    return runs[0], runs[1], obs


def obs_phase(device, smi: str) -> None:
    """``obs``: the telemetry slice on the card (module docstring, phase
    16). Checks that obs adds no launch, no kernel and no changed bit to
    the stream, that a deferred exact step leaves the host free behind a
    long sleep kernel, the obs-enabled fleet's instruments and the CLI
    smoke; records the walls of async, synchronous and uninstrumented
    streams, the microbatch latency quantiles and obs's host cost."""
    import torch
    import repro_torch.obs as obs_mod
    from repro_torch.models import vision
    from repro_torch.serving import VisionEngine

    cfg = vision.VisionConfig()          # phase 4's vgg16
    params = vision.init_params(0, cfg, device=device)
    gen = torch.Generator().manual_seed(13)
    batches = [torch.rand((16, 32, 32, 3), generator=gen).to(device)
               for _ in range(OBS_BATCHES)]
    keys = ("labels", "probs", "theta_used", "stream_fused")

    # (a) obs=None against obs, on the cuda path's fused stream and pinned
    # to the deferred exact path: the same launches, the same outputs bit
    # for bit, the same device kernels in a profile of one more stream,
    # and the spans' names in that profile
    paths = {}
    for path, fused in (("engine_obs", None), ("engine_obs_exact", False)):
        (plain, outs_p, n_p), (instr, outs_o, n_o), obs = obs_stream_pair(
            cfg, params, batches, device, fused)
        check_path_counts(n_o, path)
        check(n_o == n_p, f"{path}: launches with obs {n_o}, without {n_p}")
        same = [all(torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k]))
                    for k in keys) for a, b in zip(outs_p, outs_o)]
        check(len(same) == OBS_BATCHES and all(same),
              f"{path}: obs changed an output: {same}")
        spans = obs.summary()["spans"]
        n_micro = OBS_BATCHES * (16 // OBS_MICROBATCH)
        check(spans.get("microbatch") == n_micro
              and spans.get("stream") == OBS_BATCHES
              and spans.get("microbatch_ready", 0)
              == (n_micro if fused is False else 0),
              f"{path}: spans {spans}")
        k_p, k_o, names, diffs = profiled_pair(
            plain, instr, batches[:OBS_PROFILED_BATCHES])
        check(k_p == k_o and sum(k_p.values()) > 0,
              f"{path}: device events (without obs, with obs) {diffs}")
        check(set(OBS_SPANS) <= names,
              f"{path}: span names missing from the profile")
        paths[path] = dict(launches=n_o,
                           profiled_device_events=sum(k_o.values()),
                           profile_pair_diffs=diffs,
                           fused_steps=instr.fused_step_count,
                           fallbacks=instr.fused_fallback_count,
                           spans=spans)

    # (b) a deferred exact microbatch queued behind a long sleep kernel:
    # its dispatch returns with the step in flight, and the probe latches
    # a latency that covers the rest of the sleep
    eng = VisionEngine(cfg, params, seed=0, device=device,
                       microbatch=OBS_MICROBATCH, fused_stream=False,
                       obs=obs_mod.Obs())
    x = batches[0][:OBS_MICROBATCH]
    list(eng.stream([batches[0]]))               # the allocator's blocks
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(OBS_SLEEP_CYCLES)
    end.record()
    torch.cuda.synchronize()
    sleep_ms = start.elapsed_time(end)
    t_enq = time.perf_counter()
    torch.cuda._sleep(OBS_SLEEP_CYCLES)
    t0 = time.perf_counter()
    eng._classify(x, None, advance=True, fused=False, defer=True)
    dispatch_ms = (time.perf_counter() - t0) * 1e3
    probe = eng._batch_probes[-1]
    in_flight = not probe.poll()
    latency_ms = probe.wait() * 1e3
    gap_ms = (probe.t0 - t_enq) * 1e3
    eng._pending.drain()
    eng._batch_probes.clear()
    check(in_flight and dispatch_ms < sleep_ms / 2,
          f"a deferred exact step waited for the device (dispatch "
          f"{dispatch_ms} ms behind a {sleep_ms} ms sleep)")
    check(latency_ms >= sleep_ms - gap_ms,
          f"the probe latched {latency_ms} ms, before the {sleep_ms} ms "
          f"sleep ({gap_ms} ms of it before dispatch) was over")

    # (c) the host time obs adds to a deferred exact step: its dispatch
    # timed behind a sleep (the host never waits), obs=None and obs in
    # turns
    host = {"none": [], "obs": []}
    engines = {"none": VisionEngine(cfg, params, seed=0, device=device,
                                    microbatch=OBS_MICROBATCH,
                                    fused_stream=False),
               "obs": VisionEngine(cfg, params, seed=0, device=device,
                                   microbatch=OBS_MICROBATCH,
                                   fused_stream=False, obs=obs_mod.Obs())}
    for e in engines.values():
        list(e.stream([batches[0]]))
    for _ in range(OBS_HOST_REPS):
        for name in ("none", "obs", "obs", "none"):
            e = engines[name]
            torch.cuda.synchronize()
            torch.cuda._sleep(OBS_HOST_SLEEP_CYCLES)
            t0 = time.perf_counter()
            e._classify(x, None, advance=True, fused=False, defer=True)
            host[name].append((time.perf_counter() - t0) * 1e3)
            e._pending.drain()
            e._batch_probes.clear()
    host_ms = {k: statistics.median(v) for k, v in host.items()}

    # (d) the merged batch walls: async with obs, sync_timing with obs and
    # async without obs, on the exact path, in turns
    obs_async = obs_mod.Obs()
    modes = {"async_obs": dict(obs=obs_async),
             "sync_timing_obs": dict(obs=obs_mod.Obs(), sync_timing=True),
             "async_no_obs": {}}
    wall_engines = {m: VisionEngine(cfg, params, seed=0, device=device,
                                    microbatch=OBS_MICROBATCH,
                                    fused_stream=False, **kw)
                    for m, kw in modes.items()}
    for e in wall_engines.values():
        list(e.stream(batches[:2]))
    obs_async.registry = obs_mod.MetricsRegistry()   # steady walls only
    walls = {m: [] for m in modes}
    order = list(modes)
    for turn in range(OBS_WALL_TURNS):
        for m in (order if turn % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            walls[m] += [o["wall_ms"]
                         for o in wall_engines[m].stream(batches)]
    hist = obs_async.registry.histogram("serving_microbatch_wall_ms")
    check(hist.count == OBS_WALL_TURNS * OBS_BATCHES * 2,
          f"{hist.count} microbatch latencies recorded")

    # (e) the obs-enabled fleet at FLEET_G chips: join, serve (pinned to
    # the deferred exact path, and on the default fused stream), a forced
    # sweep, a leave, save and load
    fleet = obs_fleet_checks(device)

    # (f) the CLI smoke in its own process, on this card
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "repro_torch.obs", "smoke",
                          "--out", os.path.join(ROOT, "build", "obs_smoke")],
                         env=env, capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    smoke_s = time.perf_counter() - t0
    check(res.returncode == 0,
          f"python -m repro_torch.obs smoke: {res.stdout[-2000:]}"
          f"{res.stderr[-2000:]}")

    med = {m: statistics.median(v) for m, v in walls.items()}
    emit("obs", model="vgg16", batch=16, microbatch=OBS_MICROBATCH,
         batches=OBS_BATCHES, nvidia_smi=smi, paths=paths,
         deferred_step=dict(sleep_ms=sleep_ms, dispatch_ms=dispatch_ms,
                            in_flight_at_return=in_flight,
                            latency_ms=latency_ms,
                            sleep_before_dispatch_ms=gap_ms),
         host_dispatch_ms_median=host_ms,
         host_ms_added_by_obs=host_ms["obs"] - host_ms["none"],
         batch_wall_ms_median=med,
         batch_wall_ms=walls,
         microbatch_wall_ms=dict(count=hist.count, p50=hist.quantile(0.5),
                                 p95=hist.quantile(0.95),
                                 p99=hist.quantile(0.99)),
         fleet=fleet, cli_smoke_seconds=smoke_s,
         cli_smoke_last_line=res.stdout.strip().splitlines()[-1])


def obs_fleet_checks(device) -> dict:
    """An obs-enabled ``FleetEngine`` of ``FLEET_G`` chips on
    BENCH_fleet.json's profiles (see ``obs_phase`` (e)); returns its
    instruments."""
    import torch
    import repro_torch.obs as obs_mod
    from repro_torch.models import vision

    cfg, dcfg = fleet_config()
    params = vision.init_params(0, cfg, device=device)
    cal = torch.rand((16, 32, 32, 3),
                     generator=torch.Generator().manual_seed(67))
    chips = list(range(FLEET_G))
    rounds = fleet_rounds(OBS_FLEET_ROUNDS, chips, 97)
    out = {}
    for name, fused in (("exact", False), ("auto", None)):
        obs = obs_mod.Obs()
        fe = fleet_engine(cfg, params, dcfg, cal, device, auto=False,
                          chips_per_step=FLEET_G, fused_stream=fused,
                          obs=obs)
        for cid in chips:
            fe.add_chip(cid)
        for batch in rounds:
            fe.serve(batch)
        fe.run_sweep(force=True)
        fe.remove_chip(chips[-1])
        ckpt = os.path.join(ROOT, "build", f"obs_fleet_{name}")
        shutil.rmtree(ckpt, ignore_errors=True)
        fe.save(ckpt)
        fleet_engine(cfg, params, dcfg, cal, device, auto=False,
                     chips_per_step=FLEET_G, obs=obs).load(ckpt)
        summ = obs.summary()
        ev, m = summ["events"], summ["metrics"]
        val = lambda k: m[k]["value"]
        # the load re-registers the chips left
        check(ev.get("fleet_join") == 2 * FLEET_G - 1
              and ev.get("fleet_leave") == ev.get("fleet_sweep")
              == ev.get("checkpoint_save") == ev.get("checkpoint_load") == 1,
              f"fleet events ({name}): {ev}")
        check(val("fleet_drains_total") == OBS_FLEET_ROUNDS
              and val("fleet_steps_total") == OBS_FLEET_ROUNDS
              and m["fleet_step_wall_ms"]["count"] == OBS_FLEET_ROUNDS
              and val("serving_frames_total")
              == OBS_FLEET_ROUNDS * FLEET_G * FLEET_BATCH
              and val("fleet_sweeps_total") == 1
              and val("fleet_chips_refreshed_total") == FLEET_REFRESH
              and val("fleet_size") == FLEET_G - 1
              and val("fleet_drain_wall_ms") >= 0.0,
              f"fleet instruments ({name}): {m}")
        probed = OBS_FLEET_ROUNDS if fused is False else 0
        check(val("fleet_probes_drained_total") == probed
              and val("fleet_probe_high_water") == min(probed, 1)
              and summ["spans"].get("step_ready", 0) == probed,
              f"fleet probes ({name}): {m}")
        if fused is None:
            check(m.get("serving_fused_steps_total", {}).get("value", 0)
                  >= 1, "no fused fleet step recorded")
        check(summ["spans"].get("recal_solve_fleet") == 1,
              f"fleet sweep span ({name}): {summ['spans']}")
        out[name] = dict(events=ev, spans=summ["spans"], metrics={
            k: (v["value"] if v["type"] != "histogram"
                else {q: v[q] for q in ("count", "p50", "p95", "p99")})
            for k, v in m.items()})
    return out


def phase_subprocess(flag: str) -> None:
    """A profiling phase in a process of its own (``--obs-phase``,
    ``--census-phase``), after every profiler session of this one: a
    session late in a long process drops more device events, and with the
    ``obs`` or the ``census`` phase before them (in this process, or in a
    child) the flash lines' sessions dropped every flash kernel event. Its
    lines are printed here; a failure there fails here."""
    res = subprocess.run([sys.executable, os.path.abspath(__file__), flag],
                         capture_output=True, text=True, timeout=900,
                         cwd=ROOT)
    sys.stdout.write(res.stdout)
    sys.stdout.flush()
    check(res.returncode == 0,
          f"the {flag} phase failed:\n{res.stderr[-4000:]}")


def phase_main(flag: str) -> int:
    """``python3 chip_smoke.py --obs-phase`` / ``--census-phase``: that
    phase alone, on the libraries ``main`` built."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    build_libraries()
    PHASES[flag](torch.device("cuda"), nvidia_smi_line())
    return 0


# the served vgg16 classify of the census lines: the engine lines' batch,
# at each precision of the serving path
CENSUS_CLASSIFY = {"classify.vgg16_f32": "f32", "classify.vgg16_int8": "int8"}
# host syncs of an undeferred fleet step: before its dispatch and after it
FLEET_STEP_SYNCS = 2


def census_classify_entry(precision: str, device):
    """``classify`` of the full-width vgg16 engine (seeded weights, 16
    frames, a fixed key) at ``precision`` (the tile table's choice at the
    serving key), on ``device``."""
    import torch
    from repro_torch import prng
    from repro_torch.kernels import autotune
    from repro_torch.models import vision
    from repro_torch.serving import VisionEngine

    cfg = vision.VisionConfig()
    params = vision.init_params(0, cfg, device=device)
    frames = torch.rand((16, 32, 32, 3), generator=torch.Generator()
                        .manual_seed(11)).to(device)
    engine = VisionEngine(cfg, params, seed=0, device=device, microbatch=16)
    key = prng.PRNGKey(2)

    def run():
        autotune.clear()
        autotune.put(*SERVING_KEY, autotune.TileChoice(precision=precision))
        return engine.classify(frames, key=key)

    return run


def census_phase(device, smi: str) -> None:
    """The analysis layer's census on the card: every entry point of
    ``repro_torch.analysis.census`` at its census shape, and the served
    vgg16 ``classify`` at f32 and int8, each once on the CPU under the
    dispatch census and once on the card under ``torch.profiler``. One
    ``census`` line an entry; the port's launches (the wrappers' counts and
    the port's kernels in the profile) must equal the CPU census's kernel
    calls, ``fleet.g2`` must launch what ``fleet.g1`` does, the ADC-less
    ``frontend.cuda`` step no cuDNN convolution and no product, and every
    device-to-host copy of a step must be a host read the CPU census
    counts (``host_sync``). The fleet step's two host syncs (a step that is
    not deferred synchronizes before its dispatch and after it,
    ``serving/fleet.py``) and the fused step's read of its fresh theta are
    pinned, not hidden. The tile table is cleared for the census and
    restored after it."""
    import torch
    from repro_torch.analysis import census
    from repro_torch.kernels import autotune

    saved = dict(autotune._TABLE)
    try:
        autotune.clear()
        cpu = census.collect()
        card = census.collect(device=device)
        for name, precision in CENSUS_CLASSIFY.items():
            cpu[name] = census.op_census(
                census_classify_entry(precision, torch.device("cpu")))
            card[name] = census.card_census(
                census_classify_entry(precision, device))
    finally:
        autotune._TABLE.clear()
        autotune._TABLE.update(saved)
    # the structural rules; the budget file pins the CPU census under the
    # torch version it was written with, which this machine may not run
    fails = census.card_failures(cpu, card) + census.structural_failures(cpu)
    for name in sorted(card):
        emit("census", entry=name, kernel_calls=cpu[name]["kernels"],
             cpu_ops=cpu[name]["ops"], cpu_flops=cpu[name]["flops"],
             card=card[name], nvidia_smi=smi)
        if card[name]["dtoh_copies"] != cpu[name]["ops"]["host_sync"]:
            fails.append(f"{name}: {card[name]['dtoh_copies']} device-to-host"
                         " copies on the card, "
                         f"{cpu[name]['ops']['host_sync']} host reads in the "
                         "CPU census")
    for g in ("fleet.g1", "fleet.g2"):
        if card[g]["host_syncs"] != FLEET_STEP_SYNCS:
            fails.append(f"{g}: {card[g]['host_syncs']} host syncs, the "
                         f"undeferred fleet step makes {FLEET_STEP_SYNCS}")
    for name, precision in CENSUS_CLASSIFY.items():
        want = {n: 1 for n in STEP_KERNELS[precision]}
        if card[name]["launches"] != want:
            fails.append(f"{name}: launched {card[name]['launches']}, the "
                         f"{precision} classify launches {want}")
    check(not fails, "census: " + "; ".join(fails))


# ---------------------------------------------------------------------------
# LM training: the flash backward kernel, a Trainer on stablelm-3b at full
# width and depth, card against CPU, sampled decoding
# ---------------------------------------------------------------------------

FLASH_BWD_SOURCE = "src/repro_torch/csrc/flash_attention_bwd.cu"
FLASH_BWD_REPLACES = (
    "none (no TPU kernel): the Pallas kernel of "
    "src/repro/kernels/flash_attention.py:72 has no backward; the "
    "reference trains through XLA's autodiff of "
    "src/repro/models/blocks.py:63 (flash_attention) under "
    "jax.value_and_grad, src/repro/train/loop.py:49-52")
# the backward's instances at the geometries that train them: stablelm-3b's
# step (B 4, S 2048, 32 heads of 80), granite-8b's (32 heads over 8 of 128)
# and the reduced configs' float32 D 16 at the tiny launcher's batch (8 x
# 128, 4 heads)
FLASH_BWD_GEOMS = {
    "bf16_d80": dict(batch=4, seq=2048, heads=32, kv_heads=32, head_dim=80,
                     dtype="bfloat16", causal=True),
    "bf16_d128": dict(batch=4, seq=2048, heads=32, kv_heads=8, head_dim=128,
                      dtype="bfloat16", causal=True),
    "f32_d16": dict(batch=8, seq=128, heads=4, kv_heads=4, head_dim=16,
                    dtype="float32", causal=True),
}
# kernel vs plain (autograd through the plain forward in float32), as the
# forward's row gate: the largest error of a gradient row (dq, dk, dv over
# D) over that row's RMS; a row whose RMS is under 1e-3 of the largest
# row's is held over the largest row's RMS instead (a causal q tile's
# first rows have a gradient at ~0: dS = P (dP - delta) cancels exactly
# for a query that sees one key, and then it is rounding on both sides,
# which over its own RMS read 4.8e23). float32: the summation order;
# bf16: both sides round the gradients to bf16 (2^-8 each; the plain
# version takes its gradient in float32: on the CPU at S 130, D 128, the
# kernel's arithmetic lies 0.013 from the float64 gradient);
# tests/test_torch_cuda.py holds the same limits
FLASH_BWD_TOL = {"bfloat16": 0.1, "float32": 1e-4}
GRAD_ROW_FLOOR = 1e-3
# stablelm-3b trained at full width and depth: the default OptimizerConfig
# (AdamW, float32 moments, lr 3e-4 after 100 warmup steps), TokenStream
# batches of 4 x 2048, remat "full", no checkpoint written (34 GB of state)
LM_TRAIN_ARCH, LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = (
    "stablelm-3b", 4, 2048, 5)
# granite-8b at full width cut to 2 layers (its D 128 backward's launches),
# one step
LM_TRAIN_D128_ARCH, LM_TRAIN_D128_LAYERS = "granite-8b", 2
# the card-vs-CPU step: stablelm-3b at full width, 2 layers, 2 x 256
# tokens, bf16 on both sides, one AdamW step at lr 1e-3 without warmup
# (a step that moves a bf16 weight: the default's first lr, 3e-6, is under
# a bf16 ulp of the weights). Gates, about 10x the readings on an H100
# 80GB HBM3 at 700 W (loss 9.4e-6, grad norm 4.2e-5 relative): the loss
# within 1e-4 relative, the gradient norm within 5e-4; each leaf's
# gradient, before the optimizer, within 2e-2 of its norm (Frobenius;
# the readings 4.5e-3 .. 8.5e-3, the worst the stacked mixer wq; a dq or
# dk off by a constant factor moves wq / wk by that factor); an updated
# weight may differ by at most 2 lr (1 + wd |w|) + one bf16 ulp (Adam's
# first step is lr g / |g|: a g near 0 may take either sign), and by more
# than lr (half such a flip) in at most 2% of a leaf's entries
LM_TRAIN_CPU_LAYERS, LM_TRAIN_CPU_BATCH, LM_TRAIN_CPU_SEQ = 2, 2, 256
LM_TRAIN_CPU_LR = 1e-3
LM_TRAIN_LOSS_RTOL, LM_TRAIN_GNORM_RTOL = 1e-4, 5e-4
LM_TRAIN_GRAD_RTOL = 2e-2
LM_TRAIN_MOVED_FRAC = 0.02
# sampled decoding card vs CPU: reduced glm4-9b (float32) and stablelm-3b
# at full width, 2 layers (bf16), temperature 0.8 from key 3; a token may
# differ only where the CPU's top-2 margin of the Gumbel-perturbed scaled
# logits is within twice the logits' card-vs-CPU limit over T (float32:
# 1e-4), and the rows are compared up to their first differing token
LM_SAMPLE_T = 0.8
LM_SAMPLE_F32_TOL = 1e-4
LM_TRAIN_FAMILIES = (("flash_forward", ("flash_wgmma_kernel",
                                        "flash_ffma_kernel")),
                     ("flash_backward", ("flash_bwd_",)),
                     ("matmul", ("gemm", "gemv", "cutlass", "xmma", "sm90",
                                 "nvjet")))


def flash_bwd_work(geom: dict) -> dict:
    """What the gradient at ``geom`` must do: five products of D
    multiply-adds a visible pair (S and dP recomputed, dV, dK, dQ) and one
    exponential; q, k, v and do read once, dq, dk and dv written once.
    With the bound."""
    b, s, h, hkv, d = (geom[x] for x in ("batch", "seq", "heads",
                                         "kv_heads", "head_dim"))
    pairs = b * h * visible_pairs(s, geom["causal"])
    size = 2 if geom["dtype"] == "bfloat16" else 4
    work = dict(flops=2 * 5 * pairs * d, exps=pairs,
                bytes=(3 * b * s * h + 4 * b * s * hkv) * d * size)
    if geom["dtype"] == "bfloat16":
        t, by = bound(work["bytes"], 0.0, bf16_ops=work["flops"],
                      exps=pairs)
    else:
        t, by = bound(work["bytes"], work["flops"], exps=pairs)
    return {**work, "bound_ms": t, "bound_by": by}


def grad_row_err(got, ref) -> float:
    """The largest over the rows (last axis) of max |got - ref| over the
    row's RMS(ref) where that RMS is above GRAD_ROW_FLOOR of the largest
    row's, and over the largest row's RMS where it is not: every row is
    held, a gradient row at ~0 on its absolute error."""
    import torch
    got, ref = got.float(), ref.float()
    rms = ref.square().mean(dim=-1).sqrt()
    top = rms.max()
    if float(top) == 0.0:          # a gradient that is 0 everywhere
        return float((got - ref).abs().max())
    scale = torch.where(rms > GRAD_ROW_FLOOR * top, rms, top)
    return float(((got - ref).abs().amax(dim=-1) / scale).max())


def grad_fro_err(got, ref) -> float:
    """||got - ref|| / ||ref|| (Frobenius), reported beside the gate."""
    got, ref = got.float(), ref.float()
    return float((got - ref).norm() / ref.norm().clamp_min(1e-30))


def flash_bwd_operands(geom: dict, device):
    """q, k, v of a flash geometry (``flash_operands``) and the upstream
    gradient do, from seed 29."""
    import torch
    q, k, v = flash_operands(geom, device)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(29)
                     ).to(device=device, dtype=q.dtype)
    return q, k, v, do


def flash_bwd_phase(name: str, device) -> dict:
    """The flash backward kernel at one geometry: held against its plain
    version (autograd through the plain forward in float32) on the same card
    tensors, the two kernels it launches named from a profile, timed
    beside its plain version, its bound and the backward of
    ``scaled_dot_product_attention`` (torch.autograd, the library's
    yardstick; the port never calls it). Returns the summary row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    geom = FLASH_BWD_GEOMS[name]
    b, s, h, hkv, d = (geom[x] for x in ("batch", "seq", "heads",
                                         "kv_heads", "head_dim"))
    dtype, causal = getattr(torch, geom["dtype"]), geom["causal"]
    q, k, v, do = flash_bwd_operands(geom, device)
    symbols = fa.backward_symbols(dtype, d)

    def kernel():
        return fa.flash_attention_bwd(q, k, v, do, causal=causal)

    prof, got = profile_session(kernel, cpu=False, expect=symbols)
    ran = sorted({e.key for e in prof.key_averages() if "flash_bwd" in e.key})
    symbols_from = "session"
    if not all(any(sym in r for r in ran) for sym in symbols):
        # every session here lost one of them (the dq pass's, once, while
        # it kept the dk / dv pass's): a fresh process's profiler
        ran = flash_symbols_in_child(dict(geom, backward=True))
        symbols_from = "child"
    check(len(ran) == len(symbols) and all(any(sym in r for r in ran)
                                           for sym in symbols),
          f"flash backward kernels {ran} ran, want {symbols}")
    ref = fa.flash_attention_bwd_plain(q, k, v, do, causal=causal)
    errs = {n_: grad_row_err(g_, r_)
            for n_, g_, r_ in zip(("dq", "dk", "dv"), got, ref)}
    fro = {n_: grad_fro_err(g_, r_)
           for n_, g_, r_ in zip(("dq", "dk", "dv"), got, ref)}
    err = max(max_abs(g_.float(), r_.float()) for g_, r_ in zip(got, ref))
    check(all(bool(torch.isfinite(g_).all()) for g_ in got),
          f"non-finite flash gradient at {name}")
    check(max(errs.values()) <= FLASH_BWD_TOL[geom["dtype"]],
          f"flash backward vs plain {errs} > "
          f"{FLASH_BWD_TOL[geom['dtype']]} at {name}")
    check(all(torch.equal(a, b_) for a, b_ in zip(got, kernel())),
          f"flash backward not deterministic at {name}")
    work = flash_bwd_work(geom)
    # SDPA's backward (the library yardstick): its forward once, then the
    # gradient of the same upstream gradient, timed alone
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    lib_ms, lib_error = None, None
    try:
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                            enable_gqa=h != hkv)
        dot = do.transpose(1, 2)
        lib_ms = device_ms(lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot, retain_graph=True), device)
    except (RuntimeError, TypeError) as exc:     # a yardstick only
        lib_error = str(exc).splitlines()[0]
    plain_reps = 3 if s >= 1024 else REPS
    row = {"name": f"flash_attention_bwd_{name}", "route": "cuda",
           "source": FLASH_BWD_SOURCE, "replaces": FLASH_BWD_REPLACES,
           "launches": 0, "max_abs_err": err,
           "ms": device_ms(kernel, device),
           "plain_ms": device_ms(lambda: fa.flash_attention_bwd_plain(
               q, k, v, do, causal=causal), device, reps=plain_reps,
               warmup=1),
           "bound_ms": work["bound_ms"], "bound_by": work["bound_by"],
           "library_ms": lib_ms}
    emit("flash_bwd", geometry=name, kernels=symbols, symbols_ran=ran,
         symbols_from=symbols_from, design=fa.backward_design(dtype, d),
         **geom, grad_row_rel_err=errs, grad_fro_rel_err=fro,
         tolerance=FLASH_BWD_TOL[geom["dtype"]], row_floor=GRAD_ROW_FLOOR,
         **{k_: v_ for k_, v_ in row.items() if k_ != "launches"},
         flops=work["flops"], bytes=work["bytes"], exps=work["exps"],
         library="torch.autograd of scaled_dot_product_attention",
         library_error=lib_error,
         achieved_tflops=work["flops"] / (row["ms"] * 1e-3) / 1e12,
         times_bound=row["ms"] / work["bound_ms"])
    del prof, got, ref
    torch.cuda.empty_cache()
    return row


def _train_run(cfg, batch: int, seq: int, device, opt=None):
    """A Trainer (no checkpoints) on ``cfg`` with its stream of ``batch``
    x ``seq`` tokens on ``device``, and its initial params and optimizer
    state (seeded weights drawn on the device)."""
    from repro_torch.configs.base import OptimizerConfig, RunConfig
    from repro_torch.data import TokenStream
    from repro_torch.models import lm
    from repro_torch.train import Trainer

    run = RunConfig(arch=cfg, optimizer=opt or OptimizerConfig(),
                    log_every=1)
    stream = TokenStream(cfg.vocab_size, seq, batch, seed=5, device=device)
    trainer = Trainer(run, stream, device=device, checkpoints=False)
    params, opt_state, start = trainer.restore_or_init(
        lambda: lm.init_params(0, cfg, device=device))
    check(start == 0, "a Trainer without checkpoints restored one")
    return trainer, params, opt_state


def lm_train_phase(device, smi: str) -> dict:
    """``Trainer.fit`` on stablelm-3b at full width and depth: LM_TRAIN_STEPS
    steps of AdamW on TokenStream batches, every attention forward and
    backward through the hand-written kernels (launches counted over the
    run: the forward twice a layer a step under remat, the backward once),
    the step walls, the device time of one more step by kernel family, the
    peak memory and the losses (finite, near ln(vocab) at random
    weights). Returns the launch counts."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import flash_attention as fa

    cfg = get_arch(LM_TRAIN_ARCH)
    check(cfg.remat == "full", f"{cfg.name} remat {cfg.remat}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer, params, opt = _train_run(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                                      device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    walls = []
    cuda_lib.reset_launch_counts()
    for step in range(LM_TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt, _ = trainer.fit(params, opt, step, step + 1)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    counts = cuda_lib.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_layers = cfg.num_layers
    want = {"flash_attention": 2 * n_layers * LM_TRAIN_STEPS,
            "flash_attention_bwd": n_layers * LM_TRAIN_STEPS}
    check({k_: v_ for k_, v_ in counts.items() if v_} == want,
          f"{cfg.name} training launched {counts}, want {want}")
    losses = [h_["loss"] for h_ in trainer.history]
    check(len(losses) == LM_TRAIN_STEPS
          and all(math.isfinite(x) for x in losses)
          and all(h_["skipped"] == 0 for h_ in trainer.history)
          and abs(losses[0] - math.log(cfg.vocab_size)) < 1.0,
          f"{cfg.name} losses {losses}")
    check(int(opt.step) == LM_TRAIN_STEPS, f"optimizer step {int(opt.step)}")
    # one more step, profiled: device time by family (the session retried
    # while it keeps no event of the port's kernels, which the tracer drops
    # now and then late in a long process; then "not measured")
    prof, _ = profile_session(lambda: trainer.fit(
        params, opt, LM_TRAIN_STEPS, LM_TRAIN_STEPS + 1), tries=3,
        expect=fa.backward_symbols(cfg.dtype, cfg.resolved_head_dim))
    fam, top = device_breakdown(prof, LM_TRAIN_FAMILIES, n_top=8)
    if not fam["flash_backward"]:
        fam, top = None, None
    busy = sum(fam.values()) if fam else None
    step_flops = 6 * n_params * LM_TRAIN_BATCH * LM_TRAIN_SEQ
    emit("lm_train", model=cfg.name, layers=n_layers, d_model=cfg.d_model,
         heads=cfg.num_heads, head_dim=cfg.resolved_head_dim,
         params=n_params, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ,
         remat=cfg.remat, optimizer=dataclasses.asdict(trainer.run.optimizer),
         steps=LM_TRAIN_STEPS, init_s=init_s, step_walls_s=walls,
         steady_step_s=statistics.median(walls[1:]),
         tokens_per_s=LM_TRAIN_BATCH * LM_TRAIN_SEQ
         / statistics.median(walls[1:]),
         model_flops_per_step=step_flops,
         device_ms_by_family=fam, device_ms=busy, top_kernels=top,
         launches=counts,
         flash_forward_per_step=counts["flash_attention"] // LM_TRAIN_STEPS,
         flash_backward_per_step=(counts["flash_attention_bwd"]
                                  // LM_TRAIN_STEPS),
         kernels=[fa.kernel_symbol(cfg.dtype, cfg.resolved_head_dim),
                  *fa.backward_symbols(cfg.dtype, cfg.resolved_head_dim)],
         peak_memory_gb=peak_gb, losses=losses,
         grad_norms=[h_["grad_norm"] for h_ in trainer.history],
         lrs=[h_["lr"] for h_ in trainer.history], nvidia_smi=smi)
    del trainer, params, opt, prof
    torch.cuda.empty_cache()
    return counts


def lm_train_d128_phase(device) -> dict:
    """One Trainer step of granite-8b at full width cut to 2 layers (4 x
    2048 tokens): its attention's forward and backward at head dim 128
    (GQA 32 over 8) through the kernels. Returns the launch counts."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import cuda_lib

    full = get_arch(LM_TRAIN_D128_ARCH)
    cfg = dataclasses.replace(full, num_layers=LM_TRAIN_D128_LAYERS)
    trainer, params, opt = _train_run(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                                      device)
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    params, opt, _ = trainer.fit(params, opt, 0, 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = cuda_lib.launch_counts()
    n = cfg.num_layers
    want = {"flash_attention": 2 * n, "flash_attention_bwd": n}
    check({k_: v_ for k_, v_ in counts.items() if v_} == want,
          f"{cfg.name} training launched {counts}, want {want}")
    loss = trainer.history[-1]["loss"]
    check(math.isfinite(loss), f"{cfg.name} loss {loss}")
    emit("lm_train_d128", model=cfg.name,
         cut=f"depth {full.num_layers} -> {n}", head_dim=128,
         kv_heads=cfg.num_kv_heads, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ,
         step_wall_s=wall, loss=loss, launches=counts)
    del trainer, params, opt
    torch.cuda.empty_cache()
    return counts


def _step_from(cfg, params, batch, ocfg, device):
    """One AdamW step of ``cfg`` on ``device`` from copies of ``params``:
    (new params, the step's gradient, metrics as floats), the trees on the
    host. The gradient is read by hooks on the leaves the step
    differentiates, as ``make_train_step`` hands it to the optimizer."""
    from repro_torch.models import lm
    from repro_torch.models.params import to_device
    from repro_torch.optim.optimizer import init_opt_state, leafwise
    from repro_torch.train import make_train_step

    import torch
    cpu = torch.device("cpu")
    grads = {}

    def loss_fn(live, b_):
        for path, t in _named_leaves(live):
            t.register_hook(lambda g, path=path: grads.__setitem__(
                path, g.to(cpu)))
        return lm.lm_loss(live, b_, cfg)

    # the step updates in place: a copy even on the host
    p = leafwise(lambda t: t.to(device, copy=True), params)
    b = {k_: v_.to(device) for k_, v_ in batch.items()}
    new, _, m = make_train_step(cfg, ocfg, loss_fn=loss_fn)(
        p, init_opt_state(p, ocfg), b)
    return (to_device(new, cpu), grads,
            {k_: float(v_) for k_, v_ in m.items()})


def lm_train_vs_cpu_phase(device) -> None:
    """One AdamW step of stablelm-3b at full width cut to 2 layers on the
    card and on the CPU, from the same bf16 weights and TokenStream batch:
    loss, gradient norm and updated weights within the LM_TRAIN_* gates;
    the card's launches (one forward per layer, twice under remat, one
    backward)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.data import TokenStream
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import lm

    full = get_arch(LM_TRAIN_ARCH)
    cfg = dataclasses.replace(full, num_layers=LM_TRAIN_CPU_LAYERS)
    ocfg = OptimizerConfig(lr=LM_TRAIN_CPU_LR, warmup_steps=0)
    params = lm.init_params(3, cfg)               # on the host
    batch = TokenStream(cfg.vocab_size, LM_TRAIN_CPU_SEQ,
                        LM_TRAIN_CPU_BATCH, seed=9, device="cpu").next_batch()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    card, g_card, m_card = _step_from(cfg, params, batch, ocfg, device)
    card_s = time.perf_counter() - t0
    counts = cuda_lib.launch_counts()
    n = cfg.num_layers
    want = {"flash_attention": 2 * n, "flash_attention_bwd": n}
    check({k_: v_ for k_, v_ in counts.items() if v_} == want,
          f"card step launched {counts}, want {want}")
    t0 = time.perf_counter()
    cpu, g_cpu, m_cpu = _step_from(cfg, params, batch, ocfg,
                                   torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    loss_rel = abs(m_card["loss"] - m_cpu["loss"]) / abs(m_cpu["loss"])
    gnorm_rel = abs(m_card["grad_norm"] - m_cpu["grad_norm"]) / abs(
        m_cpu["grad_norm"])
    check(loss_rel <= LM_TRAIN_LOSS_RTOL,
          f"card vs CPU loss {m_card['loss']} vs {m_cpu['loss']}")
    check(gnorm_rel <= LM_TRAIN_GNORM_RTOL,
          f"card vs CPU grad norm {m_card['grad_norm']} vs "
          f"{m_cpu['grad_norm']}")
    lr, wd = m_cpu["lr"], ocfg.weight_decay
    leaves_ = []
    check(sorted(g_card) == sorted(g_cpu),
          f"gradients of {sorted(g_card)} read on the card, "
          f"{sorted(g_cpu)} on the CPU")
    for (path, c_), (_, g_), (_, w_) in zip(_named_leaves(cpu),
                                            _named_leaves(card),
                                            _named_leaves(params)):
        # the gradient, before the optimizer (Adam's first step is about
        # lr sign(g): the weights alone cannot see its size)
        zero = torch.zeros(w_.shape)      # a leaf the loss does not reach
        gc_ = g_cpu.get(path, zero).float()
        gg_ = g_card.get(path, zero).float()
        grad_rel = float((gg_ - gc_).norm() / gc_.norm().clamp_min(1e-30))
        diff = (g_.float() - c_.float()).abs()
        ulp = bf16_ulp(c_.float())
        limit = 2 * lr * (1 + wd * float(w_.float().abs().max())) \
            + float(ulp.max())
        moved = float((diff > lr).float().mean())
        leaves_.append({"leaf": path, "grad_rel": grad_rel,
                        "grad_norm_cpu": float(gc_.norm()),
                        "max_abs": float(diff.max()),
                        "frac_over_lr": moved,
                        "frac_over_ulp": float((diff > ulp).float().mean())})
        check(grad_rel <= LM_TRAIN_GRAD_RTOL,
              f"card vs CPU gradient of {path}: {grad_rel} relative "
              f"(limit {LM_TRAIN_GRAD_RTOL})")
        check(float(diff.max()) <= limit and moved <= LM_TRAIN_MOVED_FRAC,
              f"card vs CPU updated {path}: max {float(diff.max())} "
              f"(limit {limit}), {moved} of it over lr")
    worst = max(leaves_, key=lambda r: r["grad_rel"])
    emit("lm_train_vs_cpu", model=cfg.name,
         cut=f"depth {full.num_layers} -> {n}", batch=LM_TRAIN_CPU_BATCH,
         seq=LM_TRAIN_CPU_SEQ, lr=lr, launches=counts,
         loss_gpu=m_card["loss"], loss_cpu=m_cpu["loss"], loss_rel=loss_rel,
         grad_norm_gpu=m_card["grad_norm"], grad_norm_cpu=m_cpu["grad_norm"],
         grad_norm_rel=gnorm_rel, loss_rtol=LM_TRAIN_LOSS_RTOL,
         grad_norm_rtol=LM_TRAIN_GNORM_RTOL,
         grad_rel_worst={"leaf": worst["leaf"], "rel": worst["grad_rel"]},
         grad_rtol=LM_TRAIN_GRAD_RTOL,
         moved_frac_limit=LM_TRAIN_MOVED_FRAC, leaves=leaves_,
         gpu_step_s=card_s, cpu_step_s=cpu_s)
    torch.cuda.empty_cache()


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _named_leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def _sampled_on(cfg, params, prompts, n_new, device):
    from repro_torch import prng
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(cfg, params, max_len=prompts.shape[1] + n_new,
                        temperature=LM_SAMPLE_T, device=device)
    return eng.generate(prompts, n_new, rng=prng.PRNGKey(3)).cpu()


def lm_sample_phase(device) -> None:
    """Sampled decoding (temperature LM_SAMPLE_T, key 3) card against CPU:
    reduced glm4-9b in float32 and stablelm-3b at full width, 2 layers, in
    bf16. Each row's tokens equal up to the first that differs, and that
    one only where the CPU's top-2 margin of the perturbed logits (the
    logits of each step fed the CPU's tokens, over T, plus the step's
    Gumbel noise) is within the limit; the first token is the prefill's
    argmax."""
    import torch
    from repro_torch import prng
    from repro_torch.configs import get_arch
    from repro_torch.configs.reduced import reduced
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import lm
    from repro_torch.serving.engine import gumbel

    cases = (("glm4-9b (reduced)", reduced(get_arch("glm4-9b")), 4, 32, 16,
              LM_SAMPLE_F32_TOL),
             ("stablelm-3b (full width, 2 layers)",
              dataclasses.replace(get_arch(LM_TRAIN_ARCH), num_layers=2), 2,
              64, 8, LM_CPU_TOL))
    for tag, cfg, batch, prompt, n_new, tol in cases:
        params = lm.init_params(4, cfg)
        prompts = _lm_prompts(cfg, batch, prompt, 41)
        cuda_lib.reset_launch_counts()
        tok_gpu = _sampled_on(cfg, params, prompts, n_new, device)
        counts = cuda_lib.launch_counts()
        check(counts["flash_attention"] == cfg.num_layers,
              f"{tag}: {counts}")
        tok_cpu = _sampled_on(cfg, params, prompts, n_new, "cpu")
        logits = _forced_decode_logits(cfg, params, prompts, tok_cpu,
                                       torch.device("cpu"))
        margins = []
        for i in range(n_new):
            x = logits[:, i]
            if i:      # step i - 1 of decode draws with fold_in(rng, i - 1)
                x = x / LM_SAMPLE_T + gumbel(
                    prng.fold_in(prng.PRNGKey(3), i - 1), tuple(x.shape))
            top2 = torch.topk(x, 2, dim=-1).values
            margins.append((top2[:, 0] - top2[:, 1]).tolist())
        limit = 2 * tol / LM_SAMPLE_T
        equal = []
        for r in range(batch):
            equal.append(n_new)
            for i in range(n_new):
                if int(tok_gpu[r, i]) != int(tok_cpu[r, i]):
                    check(margins[i][r] <= limit,
                          f"{tag} row {r} token {i} differs at a CPU "
                          f"margin {margins[i][r]} > {limit}")
                    equal[r] = i
                    break
        greedy = _lm_greedy(cfg, params, prompts, n_new)
        emit("lm_sample", model=tag, dtype=str(cfg.dtype), batch=batch,
             prompt=prompt, new_tokens=n_new, temperature=LM_SAMPLE_T,
             tokens_equal_before_divergence=equal, margin_limit=limit,
             min_cpu_margin=min(min(m_) for m_ in margins),
             tokens_gpu=tok_gpu.tolist(), tokens_cpu=tok_cpu.tolist(),
             tokens_greedy_cpu=greedy.tolist(), launches=counts)


def _lm_greedy(cfg, params, prompts, n_new):
    from repro_torch.serving import ServingEngine
    return ServingEngine(cfg, params, max_len=prompts.shape[1] + n_new,
                         device="cpu").generate(prompts, n_new)


def lm_train_tiny_phase(device) -> dict:
    """``python -m repro_torch.launch.train --arch stablelm-3b --scale tiny
    --steps 5`` on the card (the reduced config, float32, head dim 16;
    checkpoints under build/, resumed by a second run that trains no
    step) against the same command with ``--device cpu``: the logged
    losses within 1e-4 relative. Returns the card run's launch counts."""
    import torch
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch import train as launch_train

    ckpt = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = ["--arch", LM_TRAIN_ARCH, "--scale", "tiny", "--steps", "5",
            "--ckpt-dir"]
    printed = io.StringIO()     # the launcher's own report stays off stdout
    with contextlib.redirect_stdout(printed):
        cuda_lib.reset_launch_counts()
        card = launch_train.main(argv + [os.path.join(ckpt, "gpu")])
        counts = cuda_lib.launch_counts()
        again = launch_train.main(argv + [os.path.join(ckpt, "gpu")])
        cpu = launch_train.main(argv + [os.path.join(ckpt, "cpu"),
                                        "--device", "cpu"])
    shutil.rmtree(ckpt, ignore_errors=True)
    layers = 2            # the reduced config's depth, remat "none"
    want = {"flash_attention": 5 * layers, "flash_attention_bwd": 5 * layers}
    check({k_: v_ for k_, v_ in counts.items() if v_} == want,
          f"tiny launcher launched {counts}, want {want}")
    lg = [h_["loss"] for h_ in card.history]
    lc = [h_["loss"] for h_ in cpu.history]
    check(len(lg) == len(lc) == 5 and again.history == []
          and all(abs(a - b_) <= 1e-4 * abs(b_) for a, b_ in zip(lg, lc)),
          f"tiny launcher losses card {lg} vs CPU {lc}")
    emit("lm_train_tiny", command="python -m repro_torch.launch.train "
         + " ".join(argv[:-1]), losses_gpu=lg, losses_cpu=lc,
         launches=counts, resumed_steps=len(again.history))
    torch.cuda.empty_cache()
    return counts


def spilled_kernels(log, key: str) -> list:
    """The kernels whose name holds ``key`` that nvcc's ``-Xptxas -v`` log
    (its lines) reports with spill stores or loads."""
    out, name = [], None
    for line in log:
        found = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?(\S+?)'?( for|$)", line.strip())
        if found:
            name = found.group(1)
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill and name and key in name and (int(spill.group(1))
                                               or int(spill.group(2))):
            out.append(name)
    return sorted(set(out))


def build_libraries() -> dict:
    """Build every kernel library at once (one nvcc each); returns
    ``{name: (path, seconds)}``."""
    from repro_torch.kernels import cuda_lib

    def one(lib):
        t0 = time.perf_counter()
        path = cuda_lib.build(lib)
        return path, time.perf_counter() - t0

    with ThreadPoolExecutor(len(cuda_lib.LIBRARIES)) as pool:
        futures = {lib.name: pool.submit(one, lib)
                   for lib in cuda_lib.LIBRARIES}
        return {name: f.result() for name, f in futures.items()}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_arch

    device = torch.device("cuda")
    # the library yardsticks and the plain versions' matmuls in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi_line()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], nvidia_smi=smi,
         device=torch.cuda.get_device_name(0),
         tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         matmul_precision=torch.get_float32_matmul_precision())
    from repro_torch.kernels import cuda_lib
    t0 = time.perf_counter()
    built = build_libraries()
    build_s = time.perf_counter() - t0
    for name, (lib_path, lib_s) in built.items():
        log = lib_path.with_suffix(".log").read_text().splitlines()
        serialized = [ln.strip() for ln in log if "serialized" in ln]
        emit("build", library=name, seconds=lib_s, wall_seconds=build_s,
             path=str(lib_path.relative_to(ROOT)),
             ptxas=[ln.strip() for ln in log
                    if "Used" in ln or "spill" in ln or "Compiling" in ln],
             wgmma_serialized=serialized)
        # ptxas C7513/C7514: a register of an in-flight wgmma is touched,
        # so every wgmma waits for the one before (the overlap is lost)
        check(not serialized, f"{name}: ptxas serialized the wgmmas")
        # the flash backward's kernels hold their accumulators (and the
        # wgmma kernels their A fragments) in registers under setmaxnreg: a
        # spill would put them in memory
        spills = spilled_kernels(log, "flash_bwd_")
        check(not spills, f"{name}: ptxas spilled in {spills}")
    # the int8 kernels' MAC (int8 A, block-shared and warp-owned, and int8
    # fused in both chip layouts) runs on the s8 tensor cores; no other P2M
    # kernel runs IMMA, and none HMMA (the float32 MACs use no TF32)
    census = cuda_lib.tensor_core_census(built["p2m"][0])
    imma = {k: v for k, v in census.items() if v != (0, 0)}
    # four single-chip int8 kernels and three of the chip axis
    check(len(imma) == 7 and all("MacQ8Mma" in k for k in imma)
          and sorted("fused_stream" in k for k in imma)
          == [False] * 4 + [True] * 3
          and sum("FleetRows" in k for k in imma) == 3
          and all(i >= 1 and h_ == 0 for i, h_ in imma.values()),
          f"tensor-core instructions in the P2M library: {imma}")
    emit("tensor_cores", library="p2m", kernels=len(census),
         imma_hmma={k: list(v) for k, v in imma.items()})
    # every flash_wgmma_kernel instance (each (D, Dv) pair, with and
    # without a window: flash_wgmma_kernel<256, true> among them) runs wgmma
    # (HGMMA) and no mma.sync (HMMA); the float32 kernel runs neither (IEEE
    # FFMA, no TF32); the RG-LRU scan neither
    from repro_torch.kernels import flash_attention as fa
    flash = cuda_lib.tensor_core_census(built["flash_attention"][0],
                                        ("HMMA", "HGMMA"))
    wgmma = {k: v for k, v in flash.items() if "flash_wgmma_kernel" in k}
    ffma = {k: v for k, v in flash.items() if "flash_ffma_kernel" in k}
    d256 = [k for k in wgmma if "ILi256ELb1E" in k]
    check(len(wgmma) == 2 * len(fa.HEAD_DIM_PAIRS[torch.bfloat16])
          and len(ffma) == 2 * len(fa.HEAD_DIM_PAIRS[torch.float32])
          and len(flash) == len(wgmma) + len(ffma) and len(d256) == 1
          and all(h_ == 0 and g_ >= 1 for h_, g_ in wgmma.values())
          and all(v == (0, 0) for v in ffma.values()),
          f"tensor-core instructions in the flash library: {flash}")
    emit("tensor_cores", library="flash_attention", kernels=len(flash),
         d256_window_instance=d256[0], hmma_hgmma={
             k: list(v) for k, v in flash.items()})
    # the scan's three instances: ungated float32, gated float32 and bf16
    scan = cuda_lib.tensor_core_census(built["rglru_scan"][0],
                                       ("HMMA", "HGMMA"))
    check(len(scan) == 3 and all(v == (0, 0) for v in scan.values()),
          f"tensor-core instructions in the scan library: {scan}")
    emit("tensor_cores", library="rglru_scan", kernels=len(scan),
         hmma_hgmma={k: list(v) for k, v in scan.items()})
    # the sLSTM kernel's eight instances (float32 and bf16 weights, row
    # groups of 1, 2, 4 and 8 rows): float32 FMAs, no tensor-core
    # instruction
    slstm = cuda_lib.tensor_core_census(built["slstm_scan"][0],
                                        ("HMMA", "HGMMA"))
    check(len(slstm) == 8
          and all("slstm_cluster_kernel" in k for k in slstm)
          and all(v == (0, 0) for v in slstm.values()),
          f"tensor-core instructions in the sLSTM library: {slstm}")
    emit("tensor_cores", library="slstm_scan", kernels=len(slstm),
         hmma_hgmma={k: list(v) for k, v in slstm.items()})

    # the flash backward's six kernels (a dq and a dk / dv kernel for each
    # of its three instances): the four bf16 ones run wgmma (HGMMA) and no
    # mma.sync (HMMA), the two float32 ones IEEE FFMA, no tensor-core
    # instruction
    bwd = cuda_lib.tensor_core_census(built["flash_attention_bwd"][0],
                                      ("HMMA", "HGMMA"))
    bwd_wgmma = {k: v for k, v in bwd.items() if "wgmma_kernel" in k}
    check(len(bwd) == 6 and all("flash_bwd_" in k for k in bwd)
          and len(bwd_wgmma) == 4
          and all(h_ == 0 and g_ >= 1 for h_, g_ in bwd_wgmma.values())
          and all(v == (0, 0) for k, v in bwd.items() if k not in bwd_wgmma),
          f"tensor-core instructions in the flash backward library: {bwd}")
    emit("tensor_cores", library="flash_attention_bwd", kernels=len(bwd),
         hmma_hgmma={k: list(v) for k, v in bwd.items()})

    t_kernels = time.perf_counter()
    rows = kernel_phase(SERVING, device)
    for geom in ODD_GEOMETRIES:
        kernel_phase(geom, device)
    kernel_phase(IMAGENET, device, plain_reps=IMAGENET_PLAIN_REPS)
    t_vision = time.perf_counter()
    # the f32 path: the table holds no entry yet, so the frontend runs f32
    counts, engine, frames = engine_run(device, "engine")
    profile_phase(engine, frames, device)
    counts_base = baseline_phase(device)
    counts_int8 = engine_int8_phase(device)
    autotune_phase(device, smi)
    t_frontends = time.perf_counter()
    frontends_phase(device, smi)
    engine_run(device, "engine_device", backend="device")
    t_flash = time.perf_counter()
    flash_row = flash_phase(FLASH_SERVING, device)
    odd_rows = [flash_phase(geom, device) for geom in FLASH_ODD]
    flash_d80_row = odd_rows[FLASH_ODD.index(FLASH_D80_SERVING)]
    window_rows = [flash_phase(geom, device) for geom in FLASH_WINDOWED]
    flash_d256_row = window_rows[FLASH_WINDOWED.index(FLASH_RG_SERVING)]
    # deepseek-v2's (192, 128) and kimi-k2's 112, each with its instance's
    # HGMMA count from the machine code
    moe_rows = [flash_phase(geom, device, hgmma=next(
        g_ for k_, (_, g_) in wgmma.items()
        if f"ILi{geom['head_dim']}ELb0E" in k_)) for geom in FLASH_MOE]
    # whisper-base's three prefill geometries (the cross-attention at Sq !=
    # Sk), then the float32 kernel at unequal lengths
    whisper_rows = [flash_phase(geom, device) for geom in FLASH_WHISPER]
    for geom in FLASH_UNEQUAL_F32:
        flash_phase(geom, device)
    scan_row = rglru_phase(device)
    gated_row = rglru_gated_phase(device)
    slstm_row = slstm_phase(SLSTM_SERVING, device)
    slstm_phase(SLSTM_F32, device)
    slstm_phase(SLSTM_NARROW, device)
    bwd_rows = {name: flash_bwd_phase(name, device)
                for name in FLASH_BWD_GEOMS}
    # every served head dim runs the Hopper kernel; lm_phase checks that
    # every prefill launch was the instance named here (MLA's qk width);
    # xlstm-350m has no attention
    for arch in (LM_ARCH, LM_D80_ARCH, LM_RG_ARCH, LM_MLA_ARCH,
                 LM_KIMI_ARCH, LM_WHISPER_ARCH):
        cfg_ = get_arch(arch)
        d = cfg_.resolved_head_dim + (cfg_.rope_head_dim
                                      if "mla" in cfg_.block_pattern else 0)
        check(lm_symbol(cfg_).startswith(f"flash_wgmma_kernel<{d}, "),
              f"{arch} (head dim {d}) is not served by flash_wgmma_kernel")
    t_lm = time.perf_counter()
    counts_lm = lm_phase(device, smi)
    counts_d80 = lm_phase(device, smi, LM_D80_ARCH)
    counts_rg = lm_phase(device, smi, LM_RG_ARCH, "lm_rg")
    counts_mla = lm_phase(device, smi, LM_MLA_ARCH, layers=LM_MLA_LAYERS)
    counts_kimi = lm_phase(device, smi, LM_KIMI_ARCH, layers=LM_KIMI_LAYERS)
    counts_xlstm = lm_phase(device, smi, LM_XLSTM_ARCH, "lm_xlstm")
    counts_whisper = lm_phase(device, smi, LM_WHISPER_ARCH, "lm_whisper",
                              batch=LM_WHISPER_BATCH,
                              prompt=LM_WHISPER_PROMPT)
    lm_vs_cpu_phase(device)
    lm_vs_cpu_phase(device, LM_D80_ARCH, "lm_stablelm")
    lm_vs_cpu_phase(device, LM_RG_ARCH, "lm_rg_vs_cpu", LM_RG_LAYERS)
    lm_vs_cpu_phase(device, LM_MLA_ARCH, "lm_mla_vs_cpu")
    lm_vs_cpu_phase(device, LM_KIMI_ARCH, "lm_kimi_vs_cpu",
                    experts=LM_KIMI_CPU_EXPERTS)
    lm_vs_cpu_phase(device, LM_XLSTM_ARCH, "lm_xlstm_vs_cpu",
                    LM_XLSTM_CPU_LAYERS, prompt=LM_XLSTM_CPU_PROMPT)
    lm_vs_cpu_phase(device, LM_WHISPER_ARCH, "lm_whisper_vs_cpu",
                    get_arch(LM_WHISPER_ARCH).num_layers,
                    prompt=LM_WHISPER_CPU_PROMPT, batch=LM_WHISPER_CPU_BATCH)
    moe_routing_phase(device)
    lm_ring_phase(device)
    t_lm_train = time.perf_counter()
    counts_train = lm_train_phase(device, smi)
    counts_train_d128 = lm_train_d128_phase(device)
    lm_train_vs_cpu_phase(device)
    lm_sample_phase(device)
    counts_train_tiny = lm_train_tiny_phase(device)
    t_train = time.perf_counter()
    train_phase(device, smi)
    t_lifetime = time.perf_counter()
    lifetime_phase(device, smi)
    t_fleet = time.perf_counter()
    fleet_rows = fleet_kernel_phase(device)
    counts_fleet, counts_fleet8 = fleet_phase(device, smi)
    # last: their 12 profiler sessions come after the flash lines', which
    # fail if every session drops the kernel's events (the tracer drops
    # more of them late in a long process); theirs return "not measured"
    t_variation = time.perf_counter()
    variation_phase(device, smi, engine.steady_classify_ms)
    for geom in (SERVING, IMAGENET):
        variation_kernels_phase(geom, device)
    yield_phase(device, smi)
    # last, and in a process of its own: no profiler session of this
    # process follows it
    t_obs = time.perf_counter()
    phase_subprocess("--obs-phase")
    t_census = time.perf_counter()
    phase_subprocess("--census-phase")
    t_end = time.perf_counter()
    # wall seconds of each group of phases, and from the build to here
    emit("seconds", build=build_s, kernels=t_vision - t_kernels,
         vision=t_frontends - t_vision, frontends=t_flash - t_frontends,
         flash=t_lm - t_flash, lm=t_lm_train - t_lm,
         lm_train=t_train - t_lm_train,
         train=t_lifetime - t_train, lifetime=t_fleet - t_lifetime,
         fleet=t_variation - t_fleet,
         variation=t_obs - t_variation, obs=t_census - t_obs,
         census=t_end - t_census,
         total=t_end - t0)
    own_path = {**{n_: counts for n_ in PATH_KERNELS["engine"]},
                **{n_: counts_base for n_ in PATH_KERNELS["baseline"]},
                **{n_: counts_int8 for n_ in PATH_KERNELS["engine_int8"]
                   if n_ != "p2m_phase_b"}}
    for row in rows:
        row["launches"] = own_path[row["name"]][row["name"]]
    # the fleet rows: the f32 path's (kernel B's too) and the int8 path's
    for row in fleet_rows:
        name = row["name"]
        row["launches"] = (counts_fleet if name in PATH_KERNELS["fleet"]
                           else counts_fleet8)[name]
    rows += fleet_rows
    # one flash row per served head dim, its launches from its own model's
    # generate (the wrapper's count is one for every head dim; D 64's row
    # timed at whisper-base's encoder geometry, the most work of its three);
    # the scan's from recurrentgemma-2b's
    for row, n_launch, d in ((flash_row, counts_lm, 128),
                             (flash_d80_row, counts_d80, 80),
                             (flash_d256_row, counts_rg, 256),
                             (moe_rows[0], counts_mla, "192_v128"),
                             (moe_rows[1], counts_kimi, 112),
                             (whisper_rows[0], counts_whisper, 64)):
        rows.append({**row, "name": f"flash_attention_bf16_d{d}",
                     "launches": n_launch["flash_attention"]})
    # the scans': the gated instance's from recurrentgemma-2b's, which
    # never launches the ungated one (0 there)
    rows.append({**scan_row, "launches": counts_rg["rglru_scan"]})
    rows.append({**gated_row, "launches": counts_rg["rglru_scan_gated"]})
    # the sLSTM kernel's from xlstm-350m's (3 in the prefill, 3 in each
    # decode step)
    rows.append({**slstm_row, "launches": counts_xlstm["slstm_scan"]})
    # the flash backward's: D 80 from stablelm-3b's training run, D 128
    # from granite-8b's 2-layer step, float32 D 16 from the tiny launcher
    for name, n_launch in (("bf16_d80", counts_train),
                           ("bf16_d128", counts_train_d128),
                           ("f32_d16", counts_train_tiny)):
        rows.append({**bwd_rows[name],
                     "launches": n_launch["flash_attention_bwd"]})
    print(smi, flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for r in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


PHASES = {"--obs-phase": obs_phase, "--census-phase": census_phase}


if __name__ == "__main__":
    flag = sys.argv[1] if len(sys.argv) > 1 else None
    if flag == "--flash-symbols":
        sys.exit(flash_symbols_main(sys.argv[2]))
    sys.exit(phase_main(flag) if flag in PHASES else main())
