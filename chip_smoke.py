#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --fd-timing-from DIR/src

The second form times only flash_decode, from the package under DIR/src
(another checkout: ``git archive <rev> src | tar -x -C DIR``), at the
kernels phase's timing shapes, inputs and clock: run it on two trees in
turns for a before and after of the kernel.

Phases, one JSON line each; any failure raises and the exit code is non-zero:

1. env      nvidia-smi's card name and power limit, torch and CUDA versions.
2. build    builds the four kernels from their CUDA sources with nvcc, one
            nvcc per source, started together (into build/kernels/), and
            reports the seconds and ptxas' report of each (registers,
            spills, wgmma serialisation warnings).
3. kernels  holds flash_decode against its plain PyTorch version on the
            card (FD_TOL: f32 within 1e-4, bf16 within 1e-3 + 1e-2 of the
            plain value): first the shapes of the encoder-decoder and VLM
            decodes (FD_MODEL_TIMING: internvl2-1b's (8, 14 heads over 2,
            64, S 1280), a GQA group of 7, ragged; whisper-small's cross
            read (8, 12, 12, 64, 1500), every row at 1500), then the
            reference package's three test shapes,
            zamba2's head dim 80 (2,32,32,80,80,1024) and a row of 32768 on
            one kv head (2,8,1,128,128,32768: the merge takes several
            passes) in f32 and bf16, the serving shape B=8 H=12 K=4 d=64
            S=2048 in bf16 and a ragged S=1000, each with per-row lengths
            in [1, S] (1 and S included) and a NaN-poisoned tail past each
            row's length, each called twice (the outputs must be equal bit
            for bit); the call captured in two CUDA graphs on one stream and
            replayed with two cases in turn, an eager call between; then at
            the serving shape and at command-r-35b's per-layer decode (B=8
            H=64 K=8 d=128 S=8192, three caches) a check, the times of
            kernel (graph replay and eager), plain version and one library
            call (scaled_dot_product_attention, a yardstick the port never
            calls) against the least time the card could take (and the
            same at FD_MODEL_TIMING's two shapes, and for the log-sum-exp
            form at FD_LSE_TIMING's block of a long_500k cache), and what
            the check reads for two planted faults (one CTA's partial dropped,
            which it must see; P rounded to bf16 before P.V); and the
            schedule's span, grid and CTAs per SM.
4. combine  holds allreduce_combine against its plain version: the
            reference's test shapes (4,1024) (3,4096) (8,8192) x sum/max/min
            x f32/bf16/int32 at 1e-2, the sync's own shapes ((2, 2,500,000)
            f32 and int32), an odd L, a view at an unaligned offset, a NaN in
            one part (max/min must give NaN) and int32 sums (exact); then
            times kernel, plain version and torch.sum(x, 0, dtype=float32)
            (a yardstick the port never calls) at (2, 2,500,000) f32.
5. matmul   holds matmul_tile (the paper's section 7 MatMul accelerator)
            against its plain version through repro_torch.kernels.matmul,
            TF32 off, and asserts which variant (launches_by_variant) ran
            each shape: the wgmma descriptor check (one TMA stage, one
            warpgroup, 64x256x64 random, bf16 and f16); the reference's
            four test shapes (bk 128) in f32, bf16 and f16 (ffma, wgmma);
            three shapes its tile contract takes that no 128-wide tile
            divides (ffma, and mma_sync in 16 bits: no row is 16-byte
            aligned); shapes where TMA zero-fills every edge, through the
            tile variant_for picks and the 128x256 one (wgmma); the exact
            K=2048 sweep of ones (ffma; wgmma and mma_sync in bf16 and
            f16); the five exanest-lm-100m projections at 4096 tokens (bk
            256), f32 and bf16; all at the reference's tolerances (f32 rtol
            1e-3 atol 8e-3, bf16/f16 2e-2 / 0.16); that the shapes the
            contract refuses raise before any launch. Prints
            matmul_accel_rows for the H100 (roofline/paper.py), then runs
            the section 7 path: 1024^3, 4096^3 and 8192^3 in bf16 and f32
            through the entry point, the launch counters read around them
            (bf16 through wgmma, f32 through ffma), each held against the
            plain version; then times kernel, mma_sync at the same bf16
            shapes (through _launch), plain version and torch.matmul (a
            yardstick the port never calls) at those shapes beside the
            bound, TFLOP/s, the share of the peak and GFLOP/s per W of the
            power limit, and the bf16 projections beside torch.matmul.
6. serve    full-width exanest-lm-100m in bf16 with random weights from
            torch.Generator seed 0, ServeEngine(slots=8, window=2048), 16
            requests with prompt lengths 64-1024 (numpy seed 0) and 32 new
            tokens each. Checks 16/16 done with every token in the
            vocabulary, that flash_decode launched once per layer per
            decode_step, and the kernel against the plain version on the
            engine's own layer-0 cache taken mid-run. The mean rows fed a
            token and the mean context a decode_step attends come after the
            timed window from the engine's schedule of these prompts
            (serve_schedule, held to the engine's decode_step count).
7. profile  8 of the engine's decode_step calls under torch.profiler:
            device time per step by kernel, flash_decode's kernels per step
            (one launch a layer) and the device's idle share (the trace goes
            to chiprun_out/decode_step_trace.json).
8. dp       data-parallel training on this one card: four processes
            (torch.multiprocessing, spawn) form a 2x2 mesh (pod=2 inter,
            data=2 intra) over a gloo group (NCCL refuses two ranks on one
            GPU), all on cuda:0; gloo moves CUDA tensors through host
            memory, while every reduction of the hierarchical and compressed
            syncs runs in allreduce_combine on the card in each rank. Each
            rank takes its quarter of a global batch of 8 (seq 512) and runs
            Trainer.make_step for 2 steps each of flat, hierarchical and
            compressed (CompressedSync). Checks (a) combine launches per
            step equal the bucket plan's count, (b) parameters bitwise equal
            across ranks after every step, (c) one 5,000,000-element bucket
            per rank through each strategy against its plain version (the
            float64 mean to 1e-5 for flat and hierarchical, the compressed
            algorithm in numpy float32 to 1e-6), (d) each strategy's
            first-step gradient, as the sync hands it to AdamW, against its
            plain version on the four ranks' gradients gathered to rank 0,
            and (flat, hierarchical) against the gradient of one
            single-process step at global batch 8 (DP_GRAD_TOL); that
            step's loss and parameters against the first hierarchical
            step's to 2e-2. Then the Trainer's default strategy, "auto"
            (the collective planner per bucket), for 2 steps each: (e)
            exact: the plan {"hierarchical": 25} (AUTO_PLANS, as the CPU
            tests hold it against the reference's planner), 50 combine
            launches a step, parameters bitwise equal across ranks, and the
            first step's synced gradient and parameters equal to the
            hierarchical run's bit for bit wherever the rank's local
            gradients were (else DP_GRAD_TOL against them); (f) with
            allow_lossy: {"compressed": 25}, 75 launches a step, the
            first-step gradient against the compressed algorithm in numpy
            float32 (no error feedback on this path) at DP_GRAD_TOL; (g)
            sync_gradients(strategy="auto") on 5,000,000 + 1,000 float32
            per rank: the plan ["hierarchical", "flat"], 2 launches, the
            float64 mean of the four ranks to 1e-5. Each reports the
            planner's host time per sync_gradients call: plan_buckets,
            which each call runs once, timed alone (perf_counter). The
            ranks' first-step gradients are gathered once for each input
            that differs on some rank, and the phase reports its time by
            section on rank 0.
9. train    repro_torch.launch.train.main on full-width exanest-lm-100m in
            bf16: batch 8, seq 512, 30 steps, run_with_recovery with its
            step-0 checkpoint (under chiprun_out/, checked, then deleted).
            lr 1e-3. Checks every loss finite and the loss falling (the
            mean of the last 5 at least 0.2 nats under the mean of the
            first 5); reports ms per step, tokens/s, peak memory.
10. train_profile  3 train steps under torch.profiler (device busy vs wall,
            top kernels), and the wall time of the step's parts timed alone:
            lm_loss forward+backward, the 12 layers' flash attention
            forward+backward, the AdamW update.
11. ssd_kernel  full-width mamba2-2.7b (bf16, random weights drawn on
            the card from torch.Generator("cuda") seed 0, built by
            Trainer.init_state), then
            ssd_scan against its plain version (the sequential recurrence)
            on the card, asserting the variant of every check
            (launches_by_variant): the reference package's three test
            shapes plus one at the layer's head width, f32 through ffma
            (rtol 1e-4, atol 1e-3) and bf16 through mma_sync (rtol 6e-2,
            atol 6e-1, and against ssd_chunked_tc, the plain version of its
            rounding, to SSD_TC_TIGHT); a ragged l=1000 through the model's
            route (padding to the chunk), f32 and bf16; and the full-width
            shape from layer 0's real (x, dt, A, B, C) on the train batch:
            mma_sync (the route) against ssd_chunked_tc, the model's bf16
            ssd_chunked and its float32 form, ffma (through _launch, on the
            same bf16 inputs) against the float32 form (SSD_FULL_TOL); then
            times mma_sync, ffma on the same bf16 inputs and the plain
            version at that shape, in turns, each beside the least time the
            card could take for the variant that ran, and profiles both
            variants (device ms per launch of each of their CUDA kernels).
12. ssm_train  Trainer.make_step on that model: batch 2 x seq 4096, 20
            steps (SSM_TRAIN), AdamW lr 6e-4, SyntheticTokens seed 0, no
            checkpoint.
            Checks every loss finite, the mean loss of 8 held-out batches
            falling by SSM_TRAIN's min_drop, and ssd_scan launched 64 x
            (forward + recompute) times per step, all through mma_sync;
            reports ms per step, tokens/s, peak memory.
13. ssm_train_profile  1 more step under torch.profiler: device
            busy, kernels per step, top kernels, ssd_scan's share and
            device ms per launch.
14. ssm_decode  prefill of 2 x 1023 tokens (a ragged length, through the
            kernel), one decode_step of token 1024 from its states, against
            the last logits of the full 1024-token prefill: in the model's
            float32 twin on the same weights at 3e-2 (as
            tests/test_models_smoke.py::test_ssm_decode_matches_prefill),
            and in bf16 within the bf16 prefill's own distance from the
            float32 one, plus 3e-2.
15. hybrid_train  full-width zamba2-2.7b (HybridLM: 54 Mamba-2 layers of
            d_state 64 in 9 groups of 6, each group followed by the one
            shared attention + gated-GELU block, 32 heads of 80; bf16,
            random weights drawn on the card from torch.Generator("cuda")
            seed 0, built by Trainer.init_state, after the Mamba-2 model is
            freed): ssd_scan
            at the hybrid's layer shape from its first layer's real inputs
            (mma_sync against ssd_chunked_tc and the float32 form, ffma
            against the float32 form, SSD_FULL_TOL), then ssm_train's run
            and gates on it: 2 x 4096, 12 steps (HYBRID_TRAIN), the
            held-out drop, ssd_scan launched 54 x (forward + recompute) =
            108 times per step, all mma_sync; ms per step, tokens/s, peak
            memory.
16. hybrid_train_profile  1 step under torch.profiler (device busy, top
            kernels, ssd_scan's share and device ms per launch beside its
            bound at the hybrid's layer shape) and the plain
            flash_attention's share of a step at head dim 80, timed alone
            (9 uses x forward, recompute and backward).
17. hybrid_decode  prefill of 2 x 1023 tokens, the caches copied into a
            1024 window, one decode_step of token 1024 against the last
            logits of the full 1024-token prefill, gated as ssm_decode;
            flash_decode's (80, 80) instance launched 9 times (once per
            group) per decode_step in bf16 and in float32, ssd_scan in the
            prefills by variant (mma_sync in bf16, ffma in float32), and
            the kernel against its plain version at FD_TOL on group 0's own
            bf16 cache (one row at 1024, one at 613).
18. moe_train  full-width granite-moe-1b-a400m (LM with 24 MoE layers: 32
            experts, top 8, expert FFN 512, 16 heads over 8 KV heads of 64;
            bf16, random weights drawn on the card from
            torch.Generator("cuda") seed 0, built by Trainer.init_state
            after the hybrid is freed): Trainer.make_step, batch 4 x seq
            2048, 20 AdamW steps, SyntheticTokens seed 0, gated on held-out
            batches as ssm_train (MOE_TRAIN); every loss finite, no
            flash_decode launch in training; ms per step, tokens/s, peak
            memory, and
            the dropped share of routed slots per layer in steps 0 and 19
            (moe.drop_log over the forward pass).
19. moe_train_profile  1 more step under torch.profiler (shapes
            recorded): device busy against wall, the top kernels, and
            device time split by moe_profile_split into flash attention,
            the expert bmms, the pack/un-pack scatters and gathers, the
            rest of the MoE layer and everything else.
20. moe_decode  batch 1: prefill of 511 tokens, one decode_step of token
            512, against the last logits of the full 512-token prefill, in
            bf16 and the float32 twin, gated as ssm_decode unless the full
            prefill dropped a slot of the last token (both prefills have
            expert capacity 200; the per-layer kept counts of the two
            prefills say whether it did, and the line reports it);
            flash_decode's (64, 64) instance launched 24 times (once per
            layer) per decode_step; the kernel against its plain version at
            FD_TOL on layer 0's own bf16 cache (the row at 512, and at 317).
21. moe_serve  ServeEngine(slots=8, window=2048) on the first 3 of the
            trained layers (MOE_SERVE_LAYERS, full width), 16 requests of
            64-512 prompt tokens (MOE_SERVE_PROMPTS, numpy seed 0) and 32
            new tokens each: 16/16 done, tokens in the vocabulary, 3
            flash_decode launches per decode_step; ms per decode_step and
            tokens/s.
22. moe_ep  expert parallelism over data on this one card: four processes
            (spawn) on a 2x2 mesh (pod, data) over gloo, granite at full
            width and 2 layers, a global batch of 8 x 512. all_to_all moves
            bytes through host memory (gloo; staged explicitly). Checks (a)
            each rank's apply_moe output on layer 0's normed input equals
            emulate_ep (the same body, the all_to_all a transpose of the
            stacked buffers) on the four ranks' gathered inputs bit for
            bit, exact and (b) int8 (a2a_quant), and that two faults
            planted in the emulated exchange (MOE_EP_FAULTS) read as
            unequal; (c) two
            Trainer.make_step steps with EP and the default "auto" sync:
            losses finite, parameters bitwise equal across ranks after each
            step, combine launched as the plan says.
23. ds_train  full-width deepseek-v3-671b (MLA: 128 heads, q_lora 1536,
            kv_lora 512, nope 128, rope 64, v 128; d_ff 18432; experts of
            2048, top 8, one shared, sigmoid router; vocab 129280; bf16)
            cut to 2 layers (1 dense, 1 MoE) with its MTP head and 16
            experts (ds_configs), random weights drawn on the card from
            torch.Generator("cuda") seed 0, after every earlier model is
            freed: the train step's peak reckoned on the meta tree
            (ds_train_peak_gb, under DS_PEAK_LIMIT_GB), then
            Trainer(donate=True).make_step, 2 x 2048, 20 AdamW steps at lr
            2.2e-4 (DS_TRAIN), gated on held-out batches as moe_train;
            the main and MTP losses per step, both finite; no
            flash_decode launch; ms per step, tokens/s, peak memory, the
            dropped share of routed slots of the trunk's MoE layer and
            the MTP block's at the first and last step.
24. ds_train_profile  1 more step under torch.profiler: device busy
            against wall, the top kernels, device time split by
            ds_profile_split into MLA's flash attention, the MoE layers,
            the MTP block's other ops and everything else.
25. ds_mla  the serving model (2 layers, all 256 experts, no MTP head:
            13.94 B parameters, drawn on the card; the draw's time beside
            the host's rate is in ds_serve's line), layer 0's MLA alone in
            float32: the expanded prefill of 1024 tokens against the
            absorbed mla_decode of token 1024 over the cache of the first
            1023, within DS_MLA_TOL of the largest output; W_UV planted
            from wkv_b's nope columns must read as a failure.
26. ds_decode  batch 1: prefill of 511 tokens, one decode_step of token
            512, against the last logits of the 512-token prefill, in bf16
            and the float32 twin (the same weights widened in place after
            the bf16 runs, and narrowed back), at capacity factors 1.25
            and 6.0 (DS_DECODE_NO_DROP_CF), gated as moe_decode; no
            flash_decode launch (MLA's decode is float32 einsums).
27. ds_serve  ServeEngine(slots=8, window=1024), 16 requests of 64-512
            prompt tokens (numpy seed 0), 32 new tokens each: 16/16 done,
            tokens in the vocabulary, no flash_decode launch; ms per
            decode_step, tokens/s and a decode_step profile (idle share).
28. shard  the port's sharding on this one card: eight processes (spawn)
            on a (pod 2, data 2, model 2) mesh over gloo, all on cuda:0
            (SHARD). (a) full-width exanest-lm-100m (bf16, random weights
            from torch.Generator seed 0, drawn whole on every rank, each
            keeping its param_specs blocks): 1 sharded Trainer step of a
            global batch 8 x 512 (2 rows a batch rank), TP over model (6 of
            12 heads, 2 of 4 KV heads, 1024 of 2048 MLP columns), ZeRO-3
            over data (each layer's data shards gathered at its entry), the
            sync of sync_sharded_gradients. Gates: step 0's loss and every
            updated leaf, gathered on rank 0, against one unsharded step on
            the card from the same parameters and batch at the reference's
            2e-2 (SHARD_STEP_TOL), the synced gradients at SHARD_GRAD_TOL;
            the sharded optimizer against the unsharded AdamW on the same
            (gathered) synced gradients: each leaf's update at
            SHARD_UPDATE_TOL, the gradient norm at SHARD_NORM_TOL; each
            rank's parameter and moment bytes equal the reckoning from
            param_specs/opt_state_specs, the leaves sharded over data and
            model a quarter each; combine launched per step per rank as
            shard_expected_combines reckons from the layout and the sync
            plan; every block equal bit for bit on the ranks that hold it,
            replicated leaves equal on all eight. (b) sharded prefill of 512
            tokens at batch 8, then 16 decode_steps: 2 KV heads a rank, 12
            flash_decode launches a decode_step a rank; the logits against
            the unsharded model's prefill and decode within SHARD_BF16_TOL;
            the kernel against its plain version on each rank's own layer-0
            cache at FD_TOL. (d) the trained state saved from (data 2,
            model 4) blocks (gathered, rank 0 writes) and restored onto
            (data 4, model 2) by elastic_reshard: every leaf equal bit for
            bit. (a) also: each rank's collective bytes a step by kind
            (core.collectives.counting on the real transport) equal the dry
            run's reckoning of that rank on meta exactly, and its step's
            peak within DRYRUN_BAND of the dry run's; then a second step
            twice from the same state and batch, with seq_shard (the
            residual stream cut over model between blocks) and without:
            the loss, every synced gradient and updated leaf bit for bit,
            combine launches as reckoned for both, the seq_shard peak not
            above the other's. (c) granite-moe-1b-a400m at full width cut
            to 2 layers, layer 0's MoE layer on its normed input (global
            batch 8 x 512): 16 of 32 experts a rank (EP over data), 256 of
            512 expert
            columns (TP over model), one forward and backward; the routes
            equal emulate_ep's (EP with a model axis of 1) on the gathered
            tokens, the output, input gradient and parameter gradients
            within SHARD_BF16_TOL. (e) every other family on the same
            ranks (SHARD_FAMILIES), each at full width with its depth cut:
            mamba2-2.7b (2 layers; 40 of 80 heads a rank, 64 of 128 d_state
            columns of wB/wC), zamba2-2.7b (12 layers: 2 groups, the shared
            block twice, 16 of 32 heads), deepseek-v3-671b (its first 2
            layers, both dense; MLA's absorbed decode with 256 of 512
            latent and 32 of 64 rope columns a rank), whisper-small (2 + 2 layers, 6 of 12
            heads, 1,500 frames) and internvl2-1b (2 layers, 7 of 14 query
            heads over 1 of 2 KV heads, 256 patches): one sharded Trainer
            step (not deepseek's: SHARD_FAMILIES says why) against the
            unsharded step on the same weights (loss and every updated
            leaf at SHARD_STEP_TOL, the synced gradients at
            SHARD_GRAD_TOL beyond twice the bf16 model's own distance from
            its float32 twin, SHARD_GRAD_FLOOR), prefill then 16
            decode_steps under keep_gathered against the unsharded model's
            logits, and each rank's caches against their block of the
            unsharded caches (SHARD_BF16_TOL beyond twice that distance),
            each on the four
            pod-0 ranks in turn; bytes a
            rank (parameters, moments, caches) against the specs'
            reckoning; launches a rank as reckoned: combine a step
            (shard_expected_combines), ssd_scan per SSM layer and step,
            flash_decode per attention layer and decode_step; the kernels
            on each rank's own inputs (ssd_scan on its first layer's SSD,
            flash_decode on its caches). (f) zamba2-2.7b as (e) cuts it
            over the whole long_500k window at batch 1 (SEQ_DECODE): the
            caches' 524,288 positions split over data (262,144 and 16 of
            32 KV heads a rank), drawn from seeds block by block, 4
            decode_steps under keep_gathered across the blocks' boundary,
            each rank attending its block through flash_decode's lse form
            and the parts merged over data by combine; gates: the lse form
            twice a step and combine as the dry run reckons this rank's
            cut cell, every step's collective bytes by op the dry run's
            (weight gathers aside: keep_gathered makes them once), logits
            and caches against rank 0's unsharded decode on the whole
            caches (SHARD_BF16_TOL beyond twice its distance from its
            float32 twin), the lse form against its plain version on each
            rank's own block, an empty block included.
29. whisper_train  full-width whisper-small (EncDecLM: 12 encoder and 12
            decoder layers, d_model 768, 12 heads of 64, GELU, LayerNorm,
            learned positions, vocab 51,865; 0.30 B parameters; bf16,
            random weights drawn on the card from torch.Generator seed 0):
            Trainer.make_step, 8 rows of 448 decoder tokens over 1,500 stub
            frames each, 16 AdamW steps (WHISPER_TRAIN), gated on held-out
            batches as ssm_train; every loss finite, no flash_decode launch;
            ms per step, frames/s, tokens/s, peak memory.
30. whisper_decode  batch 1: prefill of 1,500 frames and 63 tokens, one
            decode_step of token 64 against the 64-token prefill, gated as
            hybrid_decode (bf16 and the float32 twin); then 8 rows of 1,500
            frames and 16-63 prompt tokens, each prefilled alone into a
            448-row window, 32 greedy decode_steps: 24 flash_decode
            launches a decode_step (12 self, 12 cross over all 1,500
            encoder rows), tokens in the vocabulary, ms per decode_step;
            the kernel against its plain version on the phase's layer-0
            cross cache (8, 1500, 12, 64) and self cache at FD_TOL.
31. vlm_train  full-width internvl2-1b (LM with the patch prefix: Qwen2-
            0.5B's 24 layers, d_model 896, 14 heads over 2 KV heads of 64,
            QKV bias, RoPE 1e6, vocab 151,655; 0.63 B; bf16, drawn on the
            card): 4 rows of 256 stub patches and 2,048 tokens, 16 steps
            (VLM_TRAIN), gated and reported as whisper_train.
32. vlm_decode  batch 1: prefill of 256 patches and 511 tokens, one
            decode_step at pos 767 against the prefill of 768 positions,
            gated as whisper_decode; then 8 rows of 256 patches and 64-511
            tokens, each prefilled alone into a 256 + 1,024 window, 32
            greedy decode_steps: 24 flash_decode launches a decode_step
            (group size 7); the kernel on the layer-0 cache at FD_TOL.
33. exanet_model  the port's copy of the ExaNet interconnect model prints
            its own figures beside the paper's (EXANET_PAPER): Table 2's
            0-byte MPI latency per path, the 4 MB osu_bw link utilisation
            of a 16G and a 10G link and the section 4.7 accelerator's
            allreduce gain at 16-128 ranks. Simulated microseconds of the
            prototype, not readings of this card; the CPU tests hold them
            equal to the reference's.
34. exanet_sim  the simulator's compiled replays through the torch scan
            lane (get_scan_engine("torch"), float64 on the card) against
            the numpy lane (EXANET): (a) a binomial broadcast and a
            recursive-doubling allreduce at 4,096 ranks (one per MPSoC, a
            scaled torus) over the 23 sizes 1 B - 4 MB, one
            run_schedule_many each, timed in turns numpy, torch, torch,
            numpy (wall seconds per grid, sends/s); (b) run_program_
            scenarios of cg_iteration(64, 70000, 30.0) over 1,024 seeded
            compute and byte scale columns, check=8 against the
            interpreter on the torch lane (numpy held to it), timed in
            turns, then one torch
            sweep under torch.profiler (device-busy share, copies). Gates:
            latencies and clocks of both lanes within 1e-9 relative in
            (a) and in every column of (b), and scans ran on the torch
            lane (the broadcast has no contending acquires at one rank per
            MPSoC, so it runs none on either lane).
35. exanet_apps  the studies on the MPI layer (SIM_STUDIES): table3()
            beside the paper's Table 3 (simulated efficiencies, not card
            readings) under tests/test_exanet_paper_validation.py's
            assertions (512-rank cells within 0.5 points, 2-rank within 7,
            every efficiency at least 68.5% at 2-512 ranks, HPCG's strong
            comm share, the DDR contention factor, the halo congestion
            simulated); each app's weak iteration at 512 ranks over 32
            seeded scenario columns; the interference curve of
            halo3d(32, 65536, 50 us) beside background_stream(32, 12,
            131072) under interleave_qfdb at loads 0-4 (the app's
            efficiency must not rise with the load); the IP overlay's
            closed-form throughput and RTT against the paper's.
36. serve_sim  ServeSim(deepseek-7b, 512 ranks): build_table(mc=3,
            rng=512) on both lanes; Poisson replays of 320 requests at
            LOAD_FRACS of the backlog capacity from the torch lane's table
            (quantiles, goodput, knee), whose knee must equal the numpy
            table's; serve_step_calibration of phase 6's ms per decode_step
            at its mean live rows and mean context against the bound at
            roofline/hw.py's H100 peaks (finite and at least 1: the
            prediction is a bound).
37. train_sim  TrainSim(exanest-lm-100m, 512 ranks, seq 2048, 50 GFLOP/s
            a rank): speedup_row's 64-member family on both lanes, the
            blocking and overlapped pair of scaling_row on the torch lane
            (within 1e-9 of numpy; overlapped within [critical path,
            blocking]), and plan_train_sync at 16 ranks on both lanes
            (check=1 on the torch lane; the same chosen candidate, the
            same flip, step_us within 1e-9). In 35-37 each app sweep,
            interference curve, step table and family runs first with
            checked columns (re-run on the interpreter) on the torch lane,
            then unchecked in the turns numpy,
            torch, torch, numpy (wall seconds per lane), then once on the
            torch lane under torch.profiler (the device's busy share);
            gates: the lanes within 1e-9 relative in every latency and
            clock, and the torch lane ran scans.
38. dryrun  the dry run (repro_torch.launch.dryrun: the step traced on
            meta tensors as one mesh rank) held against the card's own
            steps: the train phase's step (exanest-lm-100m, 8 x 512, one
            rank, Trainer's functional step) run once more on the card:
            the dry run's FLOPs equal FlopCounterMode's over that step
            exactly, its peak within DRYRUN_BAND of the step's
            torch.cuda.max_memory_allocated (less what the card held
            beside the step's arguments); ds_train's donated step (phase
            23's peak over its run, and ds_train_peak_gb's meta-tree
            reckoning) against the dry run's peak in the same band; phase
            28 (a)'s gates, reported here: each rank's collective bytes a
            step by kind equal the dry run's reckoning of that rank
            exactly, its peak in the band, the seq_shard step bit for bit;
            then full-width cells on the production meshes, one a family
            (DRYRUN_CELLS), one line each with trace_s.
39. cg      the conjugate-gradient example (repro_torch.examples.cg_solver,
            the counterpart of the reference's examples/cg_solver.py: the
            paper's miniFE/HPCG class; CG): (a) one rank, n = 1024 (1.07e9
            points, 4.29 GB a vector), the eigenvector right-hand side, 120
            iterations: the error against the analytic solution under the
            reference's 5e-2, the residual finite,
            torch.cuda.max_memory_allocated within DRYRUN_BAND of the dry
            run's counters' peak for the same solve on meta, ms per
            iteration beside its least bytes (CG_PASSES f32 passes of the
            grid) at 3.35 TB/s. (b) eight gloo ranks on the card, slabs of
            a 512^3 grid over data (64 x 512 x 512 a rank, 1 MB faces): the
            eigenvector b for 120 iterations and a torch.Generator(0) b for
            5; each rank's x within 1e-4 of max|x| of its rows of the
            one-rank solve of the same b on the card (the gathered x, slab
            by slab), combine launched 1 + 2 iters times a rank a solve
            (every dot product's partials summed by combine), ppermute's
            bytes 2 (iters + 1) faces a rank, the residual the same on
            every rank; the kernel against its plain version on the CG's
            own (8, 1) partials; wall ms of a pdot, a halo exchange and
            the same exchange of host copies of the faces (gloo alone).
            (c) the five examples' mains on the card (cg_solver at n = 32,
            quickstart, allreduce_accel_demo, serve_lm, train_lm --small
            --steps 12), each ending "OK".

Then one {"kernels": [...]} line, nvidia-smi's name/power line, and last
{"ok": true, "device": {...}}. Needs torch with CUDA and nvcc; writes the
same lines to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import datetime
import functools
import gc
import hashlib
import io
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
TPU_SRC = "src/repro/kernels/flash_decode/kernel.py:55"
KERNEL_SRC = "src/repro_torch/kernels/flash_decode/csrc/flash_decode.cu"
COMBINE_TPU_SRC = "src/repro/kernels/allreduce_combine/kernel.py:33"
COMBINE_SRC = "src/repro_torch/kernels/allreduce_combine/csrc/combine.cu"
SSD_TPU_SRC = "src/repro/kernels/ssd_scan/kernel.py:67"
SSD_SRC = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
MM_TPU_SRC = "src/repro/kernels/matmul_tile/kernel.py:40"
MM_SRC = "src/repro_torch/kernels/matmul_tile/csrc/matmul_tile.cu"
#: the reference's matmul test shapes (M, N, K), checked with bk 128
MM_TEST_SHAPES = ((128, 128, 128), (256, 128, 512), (384, 256, 256),
                  (128, 384, 640))
#: exanest-lm-100m's projections at 8 x 512 tokens: (name, N, K), bk 256
#: (the default bk 512 does not divide K = 768)
MM_PROJ_M = 8 * 512
MM_PROJ = (("q/out", 768, 768), ("k/v", 256, 768), ("gate/up", 2048, 768),
           ("down", 768, 2048), ("logits", 32000, 768))
#: shapes the reference's contract takes that no 128-wide tile divides
#: (M, N, K): depth 301 (element-wise loads in every dtype), 100 cubed
#: (16-byte vectors in f32 only), N = 100
MM_EDGE_SHAPES = ((128, 128, 301), (100, 100, 100), (256, 100, 512))
#: shapes through wgmma where TMA zero-fills an edge (M, N, K, bk): all
#: three ragged; one row; N = 640 (half a 256-wide tile, through the
#: 128x256 tile as well as the one variant_for picks)
MM_WGMMA_EDGE_SHAPES = ((72, 120, 200, 512), (1, 128, 512, 512),
                        (384, 640, 1024, 512))
#: the reference's kernel tolerances (tests/test_kernels.py), (rtol, atol):
#: |kernel - plain| <= atol + rtol |plain|
MM_TOL = {torch.float32: (1e-3, 8e-3), torch.bfloat16: (2e-2, 0.16),
          torch.float16: (2e-2, 0.16)}
#: the section 7 timings: the headline entry of the kernels line
MM_HEADLINE = ((4096, 4096, 4096), torch.bfloat16)
SERVE_SHAPE = dict(B=8, H=12, K=4, dk=64, dv=64, S=2048)
#: flash_decode's timing shapes, each with the number of distinct caches the
#: timed calls take in turn (so each finds its cache cold in the 50 MB L2):
#: the serving shape (eight caches, ~134 MB, as a decode step's twelve
#: layers), and command-r-35b's per-layer decode (64 heads on 8 kv heads of
#: 128; ~134 MB live of ~268 MB a cache, three caches) where the stream, not
#: the fixed costs, sets the time
FD_TIMING = {"serving": (SERVE_SHAPE, 8),
             "long": (dict(B=8, H=64, K=8, dk=128, dv=128, S=8192), 3)}
#: the lse form's timing shape (decode_attn(..., lse=True)): one rank's
#: block of zamba2-2.7b's long_500k caches in phase 28 (f), batch 1, 16 of
#: 32 heads, 262,144 of 524,288 positions, head dim 80, bf16, every
#: position live; two caches (1.34 GB each) taken in turn
FD_LSE_TIMING = (dict(B=1, H=16, K=16, dk=80, dv=80, S=262_144), 2)
#: the shapes the encoder-decoder and VLM decodes give flash_decode, checked
#: in f32 and bf16 and timed in bf16 like FD_TIMING's, with the number of
#: caches taken in turn and whether every row is at its full length:
#: internvl2-1b's decode (14 heads over 2 KV heads: a GQA group of 7, one
#: row tile of 7 of ROW_TILE's 8; a 256 + 1,024 window, ragged lengths; 5.2
#: MB a cache, so 16 caches as a step's 24 layers read ~126 MB), and
#: whisper-small's cross read (12 heads over 12, all 1,500 encoder rows of
#: every row; 36.9 MB a cache, 4 caches as a step's 12 layers read 442 MB)
FD_MODEL_TIMING = {
    "internvl_decode": (dict(B=8, H=14, K=2, dk=64, dv=64, S=1280), 16,
                        False),
    "whisper_cross": (dict(B=8, H=12, K=12, dk=64, dv=64, S=1500), 4, True)}
#: flash_decode against its plain version, (atol, rtol): |kernel - plain|
#: <= atol + rtol |plain|. f32 differs by summation order only; bf16 may
#: differ by one step of the bf16 output (at most 2^-7 of it) where the two
#: float32 results round apart, and by no more
FD_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-3, 1e-2)}
FD_TOL_TEXT = ("|kernel - plain| <= atol + rtol |plain|: f32 atol 1e-4, "
               "bf16 atol 1e-3 rtol 1e-2")
#: the intra reduce of one 5,000,000-element bucket on a 2-rank intra axis
COMBINE_TIMING_SHAPE = (2, 2_500_000)
#: lr 1e-3: the launcher's default 3e-3 suits the reduced config, and at
#: full width's 12 layers it first drives the loss up. min_drop, in nats,
#: between the means of the first and the last five losses: the per-batch
#: noise is ~0.15 nats; the reduced config (launch.train --reduced, same
#: batch, seq, steps and lr) drops by ~2 nats on the CPU (PERF.md)
TRAIN = dict(batch=8, seq=512, steps=30, lr=1e-3, min_drop=0.2)
DP = dict(world=4, mesh=(2, 2), global_batch=8, seq=512, steps=2)
#: the plans strategy="auto" must make on the dp mesh (pod 2, data 2), as
#: tests/test_torch_grad_sync.py holds them against the reference's planner:
#: full-width exanest-lm-100m's 124,668,672 parameters in 25 buckets of at
#: most 20,000,000 B, exact (check e) and lossy (check f); and check (g)'s
#: tree of 5,000,000 + 1,000 float32, buckets of 20,000,000 B and 4,000 B
AUTO_PLANS = {False: ["hierarchical"] * 25, True: ["compressed"] * 25}
MIXED_TREE = {"a": 5_000_000, "b": 1_000}
MIXED_PLAN = ["hierarchical", "flat"]
#: check (c)'s limits, relative to the largest |element| of the plain
#: version: a float64 mean for the exact strategies, the same float32 steps
#: for compressed (as tests/test_torch_grad_sync.py holds it on the CPU)
BUCKET_TOL = {"flat": 1e-5, "hierarchical": 1e-5, "compressed": 1e-6}
#: check (d)'s limits on each sync's first-step gradient (what it hands
#: AdamW), per leaf, as grad_errors reads them. "plain": every strategy
#: against its plain version on the four ranks' gathered gradients (the
#: float64 mean for the exact strategies; CompressedSync's first call in
#: numpy float32), rounded to the sync's output dtypes; a dropped bucket
#: reads 1.0 on its leaves, swapped shards ~1.4, a missing division by the
#: world size 3.0. "single": the exact strategies against one single-process
#: step's gradient at the global batch, which differs by bf16 rounding in
#: another batch split. compressed is only read against it: its int8 codes,
#: one scale per shard of a bucket, are lossy by design (PERF.md)
DP_GRAD_TOL = {"plain": 1e-3, "single": 0.1}
#: the Mamba-2 train phase. The loss gate reads the mean loss of 8 fixed
#: held-out batches (steps eval_steps, never trained on) before and after
#: the steps, the schedule decayed over them: with 2 sequences per batch one
#: batch's loss moves by up to 0.5 nats after a few steps, up or down,
#: which hides the fall a few steps give at full depth. lr 6e-4: at 3e-4 a
#: held-out batch rose. min_drop is half the mean drop of the first run at
#: lr 6e-4 (0.139 nats; every one of the 8 batches fell, by 0.053-0.180).
#: 20 steps: at 12 and 16 the drop is 0.078 and 0.083, one batch up by
#: 0.25-0.32 nats, too near the gate; at 20, 0.146 (PERF.md section 2)
SSM_TRAIN = dict(batch=2, seq=4096, steps=20, lr=6e-4, warmup=4,
                 eval_steps=(10_000, 10_008), min_drop=0.07)
#: the hybrid train phase: SSM_TRAIN's gate on 12 steps, to keep the run
#: short (drops 0.272 at 12 and 0.114 at 20 on an H100 80GB HBM3, 700 W;
#: PERF.md section 2)
HYBRID_TRAIN = dict(SSM_TRAIN, steps=12)
#: mma_sync against ssd_chunked_tc, max|got - want| / max|want| over y and
#: over the final state: both round at the same places; the cumsum's order
#: and exp differ by a few float32 ulps, which now and then flips the bf16
#: rounding of an M, decay or entering-state element: one bf16 ulp of that
#: element times its partner, and with N(0, 1) inputs |C.B| reaches ~40 and
#: |x dt| ~3, so a single flip can move y by up to ~1e-2 of its largest
#: value. Measured at most 2.5e-3 (ref-shape-3, on an H100 80GB HBM3, 700 W)
SSD_TC_TIGHT = 1e-2
#: the full-width check, in the same measure, by (variant, form).
#: mma_sync against ssd_chunked_tc: SSD_TC_TIGHT (9.0e-4 on the layer's real
#: inputs, on an H100 80GB HBM3 at 700 W). Against the model's bf16
#: ssd_chunked, which rounds where the kernel rounds but for one rounding of
#: each decay x x·dt product of the chunk states (2^-9 of it; at most
#: 3.0e-3 on the CPU tests' shapes): 1e-2. Against the float32 form (no
#: rounding to bf16 at all): the reference's bf16 kernel bound 6e-2. ffma
#: on the same bf16 inputs against the float32 form (its own arithmetic in
#: another order: cumsums, exponentials and sums of up to 256 products,
#: ~1e-6 relative): 1e-3
SSD_FULL_TOL = {("mma_sync", "tc"): SSD_TC_TIGHT,
                ("mma_sync", "bfloat16"): 1e-2,
                ("mma_sync", "float32"): 6e-2,
                ("ffma", "float32"): 1e-3}
#: the granite-moe-1b-a400m phases. Training is batch 4 x 2048 (8192
#: tokens a step, as the SSM cells), 20 AdamW steps, gated on held-out
#: batches as SSM_TRAIN is (8 batches of 4 x 2048, never trained on).
#: min_drop is SSM_TRAIN's; this model's fall was not known before its first
#: run (PERF.md section 6)
MOE_TRAIN = dict(batch=4, seq=2048, steps=20, lr=6e-4, warmup=4,
                 eval_steps=(10_000, 10_008), min_drop=0.07)
#: batch-1 decode against prefill: a 512-token prompt (both prefills, 511
#: and 512 tokens, have an expert capacity of 200)
MOE_DECODE_LEN = 512
#: ... and at a capacity factor where no expert can fill: each token sends
#: an expert at most one slot, and ceil(T * 8 / 32 * 2^2) = T slots hold
#: all T tokens
MOE_DECODE_NO_DROP_CF = 2.0
#: moe_serve's prompt lengths, numpy seed 0: 64-512 tokens. At 64-1024 the
#: phase's 2,373 host-bound decode_steps took 239.4-289.9 s, and the whole
#: script 828.9 s without the deepseek phases and 981.8 s with them (PERF.md
#: section 2)
MOE_SERVE_PROMPTS = (64, 512)
#: moe_serve's depth: the first 3 of the 24 trained layers, full width. At
#: 24 layers the phase took 171.3-176.4 s (1,440 host-bound decode_steps,
#: ~101 ms each) and the whole script 952.2 s once the shard phase came; at
#: 12, 80.4-117.3 s, and the whole script 1,058.9 s once the whisper and
#: VLM phases came; at 6, 31.9-71.4 s, and the whole script 1,202.9 s on a
#: slow host once the shard phase took every family (PERF.md section 2)
MOE_SERVE_LAYERS = 3
#: expert parallelism on four ranks of this one card: full width at
#: reduced depth, a global batch of 8 x 512
MOE_EP = dict(world=4, mesh=(2, 2), n_layers=2, global_batch=8, seq=512,
              steps=2)
#: (a), (b): each rank's EP output must equal emulate_ep's on the four
#: ranks' gathered inputs bit for bit: the two run the same body on the
#: same bytes. Two faults planted in pod 0's emulated exchange (its two
#: ranks' blocks swapped; one (token, choice) slot dropped) must each read
#: as unequal; their max|got - want| / max|want| is reported
MOE_EP_FAULTS = ("blocks_swapped", "one_slot_dropped")
#: deepseek-v3-671b at its own widths (d_model 7168, 128 heads, MLA q_lora
#: 1536 / kv_lora 512 / nope 128 / rope 64 / v 128, d_ff 18432, experts of
#: 2048 top 8 with one shared expert of 2048, sigmoid router, vocab 129280,
#: bf16), cut in depth to 2 layers: 1 dense (the config's 3 would leave no
#: MoE layer) and 1 MoE. Serving keeps all 256 experts and drops the MTP
#: head, which no serving step reads (arXiv:2412.19437 section 2.2): 13.94 B
#: parameters, 27.9 GB in bf16
DS_SERVE_CUT = dict(n_layers=2, n_dense_layers=1, mtp_depth=0)
#: training keeps the MTP head (depth 1) and cuts the experts to 16 (top 8,
#: shared expert and sigmoid router kept): 4.26 B parameters, float32 AdamW
#: moments. The functional update holds the old and the new state at once
#: (a reckoned ~112 GB, ds_train_peak_gb), so the step is donated
#: (Trainer(donate=True): the same arithmetic written in place), which
#: keeps the reckoned peak under DS_PEAK_LIMIT_GB. Gated as MOE_TRAIN, on
#: 2 x 2048, at DeepSeek-V3's own peak lr, 2.2e-4 (arXiv:2412.19437
#: section 4.2): at MOE_TRAIN's 6e-4 the d_model-7168 model diverged, the
#: MTP loss 12.5 -> 52.0 by step 7, held-out +1.66 nats (PERF.md section 6)
DS_TRAIN_EXPERTS = 16
DS_TRAIN = dict(batch=2, seq=2048, steps=20, lr=2.2e-4, warmup=4,
                eval_steps=(10_000, 10_008), min_drop=0.07)
DS_PEAK_LIMIT_GB = 75.0
#: ds_mla: layer 0's MLA alone in float32, the expanded prefill of
#: DS_MLA_LEN tokens against the absorbed decode of its last token over
#: the cache of the others: max|decode - prefill's last row| / max|prefill's
#: last row| within DS_MLA_TOL (the two orders of the same float32 products)
DS_MLA_LEN = 1024
DS_MLA_TOL = 1e-4
#: ds_decode as moe_decode: batch 1, 511 + 1 tokens, at the config's
#: capacity factor and at one where no expert can fill: a token sends an
#: expert at most one slot, and ceil(T * 8 / 256 * cf^2) >= T needs cf^2 >=
#: 32: at 6.0 an expert holds 1.125 T slots
DS_DECODE_LEN = 512
DS_DECODE_NO_DROP_CF = 6.0
#: ds_serve: the serve cell's 16 requests and 32 new tokens, prompts of
#: 64-512 tokens (numpy seed 0) in a 1024-token window
DS_SERVE = dict(slots=8, window=1024, requests=16, prompt=(64, 512), new=32)
LINES: list[dict] = []


#: phase 28 (shard): eight gloo ranks on this one card as a (pod 2, data 2,
#: model 2) mesh, the reference's test_distributed.py mesh. (a) full-width
#: exanest-lm-100m, global batch 8 x 512, 1 sharded step at lr 1e-3 from
#: step 1 (warmup 1); (b) prefill of 512 tokens then 16 decode steps at
#: batch 8; (c) granite's MoE layer 0 at full width, model cut to 2 layers,
#: on layer 0's normed input of a global batch 8 x 512; (d) the state after
#: (a) saved on (data 2, model 4), restored onto (data 4, model 2)
SHARD = dict(world=8, mesh=(2, 2, 2), arch="exanest-lm-100m",
             global_batch=8, seq=512, steps=1, lr=1e-3, prompt=512,
             decode=16, moe_arch="granite-moe-1b-a400m", moe_layers=2,
             reshard=((2, 4), (4, 2)))
#: (a) the reference's own tolerance for a sharded step against the
#: unsharded one (tests/test_distributed.py:121): the loss within 2e-2,
#: every updated leaf within rtol = atol = 2e-2. (b) and (c) in bf16 at 3e-2
#: (rtol and atol), the reference's bf16 model tolerance and
#: decode_readings' margin
SHARD_STEP_TOL = 2e-2
SHARD_BF16_TOL = 3e-2
#: (a)'s synced gradients against the unsharded step's, per leaf, relative
#: to the leaf's largest value: 5e-2, about 13 bf16 ulps there. Both are
#: bf16 (the sharded one rounded per rank before its sums over data and
#: pod, the unsharded one once); a missing or doubled sum reads 0.5 or more
SHARD_GRAD_TOL = 5e-2
#: (a)'s sharded optimizer against the unsharded AdamW run on the sharded
#: step's own synced gradients (gathered) from the same parameters: the
#: same arithmetic but for the order of the gradient norm's float32 sum.
#: Each leaf's ||p1 - p1_unsharded|| / ||p1_unsharded - p0|| within 1e-2
#: (a missing or doubled update reads 1; a bf16 rounding that flips at
#: the norm's last bits moves one element by one ulp), and the norm within
#: 1e-4 (a replicated leaf counted twice adds its whole share)
SHARD_UPDATE_TOL = 1e-2
SHARD_NORM_TOL = 1e-4
#: (e) reads the unsharded bf16 model's own error: its float32 twin (the
#: same weights widened) runs beside it, and each reading allows that
#: distance on top of its tolerance, as decode_readings does for the SSM
#: decodes, once for each of the two bf16 runs (both round at every
#: layer, the sharded one more often: each sum over model rounds its
#: parts, so the two can stand apart by the sum of their distances from
#: the twin; the unsharded run's stands for both): a synced gradient
#: within SHARD_GRAD_TOL of the leaf's largest value plus twice the leaf's
#: largest bf16-against-float32 distance; logits and caches within
#: SHARD_BF16_TOL plus twice theirs. Read against the tolerance alone,
#: zamba2's 12 layers read 1.24-2.16 on logits and caches and 0.16 on
#: gradients in a first run, whisper's 0.09-0.11 on gradients; mamba2's 2
#: layers 0.18-0.32 and 0.02. With one distance allowed, whisper's
#: decoder.attn.wo read 0.058 (its error 7.1e-4, its bf16 distance
#: 3.4e-4, its largest value 6.3e-3).
#: The key biases (bk) of attention without rotary positions have an exact
#: gradient of zero (every score of a query shifts by q·bk, which the
#: softmax removes; a rotated bk shifts each key's score differently):
#: both sides hold rounding noise only (whisper's three, in a CPU
#: rehearsal at reduced size: 2.6e-4 to 3.9e-4 of the tree's largest
#: gradient, 0.71-0.79 of their own largest value apart), so each side's
#: largest value is held under 1e-3 of the tree's largest gradient
SHARD_GRAD_FLOOR = 1e-3
#: phase 28 (e): the other families on the same eight ranks, each at full
#: width from its config with its depth cut, a global batch of 8 rows,
#: weights drawn on the card from torch.Generator seed 0: (label, arch,
#: cuts, decoder tokens a row, whether a sharded train step runs).
#: deepseek-v3-671b keeps its own first two layers, both dense (the config
#: has 3), and no MTP head, which no decode_step reads: MLA is what it
#: brings, and MoE under EP + TP is (c)'s (on identical inputs: through a
#: model, bf16 sums over model that round apart flip a route at a near-tie
#: of the top 8 of 16 experts, which read 2.23 on data rank 1's rows in a
#: first run with one MoE layer). Its sharded train step does not fit: a
#: rank's quarter of its 3.0 B parameters with float32 moments is 7.5 GB,
#: 60 GB for eight ranks, and the embedding and head each rank gathers
#: whole (1.85 GB each) and the unsharded step beside them pass the card's
#: 80 GB (its sharded step is held on the CPU,
#: tests/test_torch_sharded_step.py)
SHARD_FAMILIES = (
    ("mamba2", "mamba2-2.7b", {"n_layers": 2}, 512, True),
    ("hybrid", "zamba2-2.7b", {"n_layers": 12}, 512, True),
    ("mla", "deepseek-v3-671b", {"n_layers": 2, "n_dense_layers": 2,
                                 "mtp_depth": 0}, 512, False),
    ("encdec", "whisper-small", {"n_layers": 2, "n_encoder_layers": 2}, 448,
     True),
    ("vlm", "internvl2-1b", {"n_layers": 2}, 256, True),
)
#: (e)'s decode_steps after a prefill of the row's other tokens
SHARD_FAMILY_DECODE = 16
#: (e)'s ranks draw their full trees at once while they fit in this many GB
#: of the card together, else in waves
SHARD_DRAW_GB = 16.0
#: phase 28 (f): zamba2-2.7b at full width with its depth cut as (e) cuts
#: it (12 layers: 2 groups, the shared attention block twice), decoding one
#: token a step at batch 1 over the whole long_500k window on the same eight
#: ranks: the batch does not divide the batch axes, so cache_specs puts the
#: KV caches' 524,288 positions over data (262,144 a rank) and their 32 KV
#: heads over model (16 a rank). Prefilling 524,288 tokens through the f32
#: flash attention is out of reach, so the caches and SSM states are drawn
#: from torch.Generator seeds, one for each (leaf, group, block as
#: cache_specs cuts it): each rank draws its own blocks, and rank 0's whole
#: twin (10.7 GB of K/V) is their concatenation. 4 decode_steps from
#: position 262,142: data 0's block partial (262,143 live) then full, data
#: 1's empty twice, then partial (1, then 2 live)
SEQ_DECODE = dict(arch="zamba2-2.7b", cut={"n_layers": 12}, window=524_288,
                  pos=262_142, steps=4, seed=31_000)
#: phase 38's full-width cells on the production meshes, one a family:
#: (label, arch, shape, multi_pod); decode cells (a few seconds each on
#: the host: no flash-attention block loop) and Mamba-2's long_500k
DRYRUN_CELLS = (
    ("dense", "deepseek-7b", "decode_32k", False),
    ("moe", "granite-moe-1b-a400m", "decode_32k", False),
    ("mla", "deepseek-v3-671b", "decode_32k", True),
    ("ssm", "mamba2-2.7b", "long_500k", False),
    ("hybrid", "zamba2-2.7b", "decode_32k", False),
    ("encdec", "whisper-small", "decode_32k", False),
    ("vlm", "internvl2-1b", "decode_32k", True),
)
#: the dry run's peak against a step's measured one: within 10% of the
#: measured peak or 256 MiB, whichever is larger (the caching allocator's
#: rounding, cuBLAS workspaces and the CUDA context's own allocations are
#: not the step's tensors). A reading outside the band is a fault of the
#: reckoning, to be repaired there
DRYRUN_BAND = (0.10, 256 * 2 ** 20)

#: phases 29-32, the encoder-decoder and VLM families at full width (bf16,
#: weights drawn on the card from torch.Generator("cuda") seed 0). Training
#: is gated as SSM_TRAIN on 8 held-out batches (eval_steps, never trained
#: on), the schedule decayed over the steps. whisper-small: 8 rows of 448
#: decoder tokens (Whisper's text context) over 1,500 stub frames each;
#: internvl2-1b: 4 rows of 256 patches and 2,048 tokens. lr 6e-4: at 1e-3
#: the held-out mean fell 0.080, -0.049 and 0.025 nats in whisper's 16, 24
#: and 32 steps (train losses swinging 11.08-11.82), and 0.050 in
#: internvl's 16 (-0.002 at step 12); at 6e-4 and 16 steps whisper fell
#: 0.102 and internvl 0.195, every internvl batch by 0.14-0.25
#: (scripts/family_lr_probe.py on an H100 80GB HBM3, 700 W; PERF.md
#: section 6). min_drop is half of whisper's drop there, as SSM_TRAIN's
#: rule; internvl keeps MOE_TRAIN's
WHISPER_TRAIN = dict(batch=8, seq=448, steps=16, lr=6e-4, warmup=4,
                     eval_steps=(10_000, 10_008), min_drop=0.05)
VLM_TRAIN = dict(batch=4, seq=2048, steps=16, lr=6e-4, warmup=4,
                 eval_steps=(10_000, 10_008), min_drop=0.07)
#: whisper_decode: 8 rows, each prefilled alone (1,500 frames and a prompt
#: of 16-63 tokens, numpy seed 0), the self caches copied into a 448-row
#: window, then 32 greedy decode_steps; batch-1 decode against prefill at
#: 63 + 1 tokens
WHISPER_DECODE = dict(batch=8, prompt=(16, 63), window=448, steps=32,
                      check_len=64)
#: vlm_decode: batch-1 decode against prefill at 256 patches + 511 + 1
#: tokens (pos 767); then 8 rows of 256 patches and a prompt of 64-511
#: tokens (numpy seed 0), each prefilled alone, in a 256 + 1,024 window,
#: 32 greedy decode_steps
VLM_DECODE = dict(check_len=512, batch=8, prompt=(64, 511), window=1280,
                  steps=32)
#: the simulator's phase. (a) the reference's scan-lane comparison
#: (benchmarks/collectives_sweep.py:engine_rows): a binomial broadcast and a
#: recursive-doubling allreduce at 4,096 ranks, one per MPSoC, each over the
#: 23 OSU sizes 1 B - 4 MB in one batched replay; (b) one scenario sweep of
#: cg_iteration at 64 ranks over 1,024 seeded compute and byte scale
#: columns (as tests/test_batch_engine.py draws them), 8 of them checked
#: against the interpreter. Both lanes' replays agree within ``tol``
EXANET = dict(ranks=4096, sizes=tuple(1 << i for i in range(23)),
              min_wall_s=1.0, prog=(64, 70000, 30.0), columns=1024,
              check=8, seed=27, tol=1e-9)
#: the paper's figures the model is held to: Table 2's 0-byte MPI latency
#: per path (us), section 6.1.2's link utilisation at 4 MB and section
#: 6.1.5's accelerator gain per rank count (tests/test_exanet_paper_
#: validation.py pins the model to these)
EXANET_PAPER = {"table2_us": {"intra_fpga": 1.17, "intra_qfdb_sh": 1.293,
                              "mezz_sh": 1.579, "mezz_mh(2)": 2.0,
                              "mezz_mh(3)": 2.111,
                              "inter_mezz(3,1,2)": 2.555},
                "link_utilisation": {"16G": 0.819, "10G": 0.643},
                "accel_gain": {16: 0.834, 32: 0.862, 64: 0.871, 128: 0.879}}
#: phases 35-37, the studies and the simulators on both scan lanes, at the
#: sizes the reference's sweeps call real. exanet_apps: each app's weak
#: iteration at the paper's 512 ranks over 32 scenario columns, compute
#: x0.9-1.1 and bytes x0.8-1.2 (benchmarks/apps_sweep.py), and
#: faults_sweep.py's interference block (halo3d(32, 65536, 50 us) beside
#: background_stream(32, 12, 131072) on shared QFDBs). serve_sim: deepseek-7b
#: at 512 ranks with the spec's defaults, a table of mc 3 draws, Poisson
#: replays of 320 requests (prompts 256, outputs 24) at serve_sweep.py's
#: LOAD_FRACS of the backlog capacity, the knee at 0.95 of the offered rate.
#: train_sim: exanest-lm-100m at 512 ranks (train_sweep.py's MODELS[0]),
#: speedup_row's 64-member family of one 8-bucket candidate (seed 7), the
#: blocking/overlapped pair of scaling_row, and plan_train_sync at 16 ranks.
#: ``check`` columns of the torch lane's first call re-run on the
#: interpreter; the lanes agree within ``tol``
SIM_STUDIES = dict(
    app_ranks=512, app_columns=32, app_seed=512, app_check=3,
    interference=dict(n_app=32, face=65536, compute_us=50.0, n_bg=32,
                      iters=12, nbytes=131072, check=2),
    loads=(0.0, 0.5, 1.0, 2.0, 4.0),
    serve=dict(arch="deepseek-7b", nranks=512), serve_mc=3, serve_check=4,
    serve_requests=320, serve_seed=512000, prompt_mean=256, out_mean=24,
    load_fracs=(0.3, 0.5, 0.7, 0.85, 1.0, 1.2), knee_frac=0.95,
    train=dict(arch="exanest-lm-100m", nranks=512, seq_len=2048,
               batch_per_rank=1, rank_gflops=50.0),
    family=64, family_seed=7, family_check=2,
    plan_ranks=16, plan=dict(generations=1, survivors=2, children=2,
                             check=1, seed=0),
    tol=1e-9)

#: phase 39, the conjugate-gradient example (repro_torch.examples.
#: cg_solver, the reference's examples/cg_solver.py): (a) one rank on an
#: n^3 grid whose five vectors (b, x, r, p, Ap) fill about a quarter of the
#: card, HPCG's rule for a problem's size, the reference's 120 iterations;
#: (b) ``ranks`` gloo ranks of the card on slabs of a ``rank_n``^3 grid (64
#: planes of 512 x 512 a rank, 1 MB faces), the eigenvector right-hand side
#: for ``iters`` and a torch.Generator(seed) one for ``seeded_iters``, each
#: held against the one-rank solve of the same b within ``tol`` of its
#: largest value; ``reps`` calls each of a pdot and a halo exchange timed
CG = dict(n=1024, iters=120, ranks=8, rank_n=512, seeded_iters=5, seed=0,
          tol=1e-4, reps=20)
#: the least bytes of one CG iteration, in f32 passes over the grid: A(p)
#: reads p and writes Ap; p.Ap reads both; x += alpha p and r -= alpha Ap
#: read two and write one each; r.r reads r; p = r + beta p reads two and
#: writes one
CG_PASSES = 14

T_START = time.perf_counter()


def emit(obj: dict) -> None:
    if "phase" in obj:          # seconds since the start, for the time budget
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    LINES.append(obj)
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


@functools.cache
def warmup_stream() -> torch.cuda.Stream:
    """One side stream for every warm-up: cuBLAS keeps a workspace for each
    stream it has run on, and a new stream per timing would leave one
    allocated per timed library call for the rest of the run."""
    return torch.cuda.Stream()


def time_ms(fn, reps: int = 48, batches: int = 7) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls captured in a CUDA
    graph, replayed ``batches`` times between CUDA events; the median replay
    over ``reps``. A graph replay has no host work between launches, so this
    is the time on the card, not the Python wrapper's. The graph is captured
    on the stream the warm-up ran on, so what a wrapper keeps per stream
    (cuBLAS's workspace, flash_decode's tickets) exists before capture."""
    side = warmup_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):   # where the warm-up ran
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def time_auto_ms(fn, target_ms: float = 30.0) -> float:
    """:func:`time_ms` with as many calls per graph as fill about
    ``target_ms`` (1 to 48), from one eager call timed first."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    once = start.elapsed_time(end)
    return time_ms(fn, reps=max(1, min(48, int(target_ms / max(once, 1e-3)))))


def card_peaks() -> tuple[float, float, float]:
    """(device-memory bytes/s, bf16 tensor-core FLOP/s, float32 FLOP/s) of
    the card, from the port's roofline/hw.py (NVIDIA's H100 SXM figures)."""
    from repro_torch.roofline.hw import H100, H100_PEAK_F32_FLOPS
    return H100.hbm_bw, H100.peak_bf16_flops, H100_PEAK_F32_FLOPS


def power_limit_w(smi: str) -> float | None:
    """The power limit in W from nvidia-smi's "name, limit" line."""
    m = re.search(r"([\d.]+)\s*W\s*$", smi)
    return float(m[1]) if m else None


def time_eager_ms(fn, reps: int = 200) -> float:
    """Wall time of one eager ``fn()`` call, host work included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def ptxas_report(log: str) -> list[str]:
    """``kernel<template args>: registers, shared memory`` per compiled
    kernel, from nvcc's -Xptxas=-v output; empty when the library was
    already built. Spills are listed when there are any."""
    out, entry = [], "?"
    dtypes = {"13__nv_bfloat16": "bf16", "f": "f32", "i": "i32"}
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            # ...fd_split_kernelI13__nv_bfloat16Li64ELi64EE...
            m = re.search(r"(fd_[a-z]+_kernel)I(13__nv_bfloat16|f)((?:Li\d+E)+)",
                          ln)
            # ...combine_kernelILi0EfLb1EE...: <op, dtype, vectorized>
            c = re.search(r"combine_kernelILi(\d)E(13__nv_bfloat16|f|i)Lb(\d)E",
                          ln)
            # ...ssd_output_kernelI13__nv_bfloat16E..., ...ssd_pass_kernel...;
            # mma_sync: ...ssd_tc_state_kernelEPK13__nv_bfloat16...,
            # ...ssd_tc_output_kernelILi64EEv... (<head dim>)
            sd = re.search(r"(ssd_(?:tc_)?[a-z]+_kernel)(?:I(13__nv_bfloat16|f|"
                           r"Li\d+)E)?", ln)
            # ...mm16_kernelI13__nv_bfloat16Lb1EE..., ...mm32_kernelILb0EE...
            mm = re.search(r"(mm16_kernel|mm32_kernel)I(13__nv_bfloat16|6__half)?"
                           r"Lb(\d)E", ln)
            # ...mm_wgmma_kernelI6__halfLi128ELi256ELi4EE...: <T, BM, BN,
            # stages>; ...mm_wgmma_probe_kernelI13__nv_bfloat16EE...
            wg = re.search(r"(mm_wgmma_(?:probe_)?kernel)I(13__nv_bfloat16|"
                           r"6__half)((?:Li\d+E)*)", ln)
            if m:
                dims = ",".join(re.findall(r"Li(\d+)E", m[3]))
                entry = f"{m[1]}<{dtypes[m[2]]},{dims}>"
            elif c:
                op = ("sum", "max", "min")[int(c[1])]
                entry = (f"combine_kernel<{op},{dtypes[c[2]]},"
                         f"{'vec' if c[3] == '1' else 'scalar'}>")
            elif sd:
                arg = sd[2] and (f"p={sd[2][2:]}" if sd[2].startswith("Li")
                                 else dtypes[sd[2]])
                entry = sd[1] + (f"<{arg}>" if arg else "")
            elif mm:
                kind = {"13__nv_bfloat16": "bf16,", "6__half": "f16,",
                        None: ""}[mm[2]]
                entry = (f"{mm[1]}<{kind}"
                         f"{'vec' if mm[3] == '1' else 'scalar'}>")
            elif wg:
                dims = "".join("," + d for d in re.findall(r"Li(\d+)E", wg[3]))
                kind = "bf16" if wg[2] == "13__nv_bfloat16" else "f16"
                entry = f"{wg[1]}<{kind}{dims}>"
            else:
                entry = ln.strip()
        elif "Used" in ln:
            out.append(f"{entry}: {ln.split(':', 1)[1].strip()}")
        elif ("spill" in ln and "0 bytes spill stores, 0 bytes spill loads"
              not in ln) or "Performance Loss" in ln:
            out.append(f"{entry}: {ln.strip()}")
    return out


def device_kernels(prof, steps: int, skip: tuple[str, ...] = ()
                   ) -> list[tuple[str, float, float]]:
    """(name, device ms per step, launches per step) of every CUDA-side
    entry of the profile, longest first; ``skip`` names profiler ranges
    (record_function) whose device-side spans are not kernels."""
    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.key in skip:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels.append((e.key, us / 1e3 / steps, e.count / steps))
    if not kernels:
        raise AssertionError("the profiler traced no device time")
    return sorted(kernels, key=lambda x: -x[1])


def profile_summary(prof, steps: int, wall_s: float, smi: str) -> dict:
    """Device time per decode step by kernel, from the profiler's CUDA-side
    entries; the idle share is the wall time no kernel ran."""
    kernels = device_kernels(prof, steps)
    busy = sum(ms for _, ms, _ in kernels)
    wall_ms = wall_s / steps * 1e3
    fd_ms = sum(ms for name, ms, _ in kernels if "fd_" in name)
    fd_n = sum(n for name, _, n in kernels if "fd_" in name)
    return {"phase": "profile", "steps": steps, "ms_per_step_wall": wall_ms,
            "device_busy_ms_per_step": busy, "idle_share": 1 - busy / wall_ms,
            "kernels_per_step": sum(n for *_, n in kernels),
            "flash_decode_ms_per_step": fd_ms,
            "flash_decode_kernels_per_step": fd_n,
            "top": [[name[:80], ms, n] for name, ms, n in kernels[:8]],
            "card": smi}


def make_case(B, H, K, dk, dv, S, dtype, seed, full: bool = False):
    """q, k, v on the card; lengths per row in [1, S] with 1 and S present
    (``full``: every row at S, as a cross cache is read); NaN past each
    row's length in the kernel's copy of k and v."""
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    q = torch.from_numpy(rng.standard_normal((B, H, dk), np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, K, dk), np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, K, dv), np.float32))
    q, k, v = (t.to(dev, dtype) for t in (q, k, v))
    lengths = rng.integers(1, S + 1, B)
    lengths[0] = 1
    if B > 1:
        lengths[1] = S
    if full:
        lengths[:] = S
    lengths = torch.from_numpy(lengths.astype(np.int32)).to(dev)
    live = torch.arange(S, device=dev)[None, :] < lengths[:, None].long()
    kp = k.masked_fill(~live[:, :, None, None], float("nan"))
    vp = v.masked_fill(~live[:, :, None, None], float("nan"))
    return q, k, v, kp, vp, lengths


def make_case_on_card(B, H, K, dk, dv, S, dtype, seed, full: bool = False):
    """make_case's tensors drawn on the card from torch.Generator ``seed``
    (a cache of 1.34 GB takes seconds to draw on the host): q, k, v,
    lengths per row in [1, S] (``full``: every row at S), and the kernel's
    copies of k and v with NaN past each row's length (k and v themselves
    where every row is full)."""
    gen = torch.Generator("cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for shape in ((B, H, dk), (B, S, K, dk), (B, S, K, dv)))
    lengths = (torch.full((B,), S, dtype=torch.int32, device="cuda") if full
               else torch.randint(1, S + 1, (B,), generator=gen,
                                  device="cuda", dtype=torch.int32))
    if full:
        return q, k, v, k, v, lengths
    dead = ~(torch.arange(S, device="cuda")[None, :]
             < lengths[:, None].long())[:, :, None, None]
    return (q, k, v, k.masked_fill(dead, float("nan")),
            v.masked_fill(dead, float("nan")), lengths)


def fd_reading(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / (atol + rtol |want|) at FD_TOL of want's dtype: at
    most 1 passes; inf where got is not finite or the shapes differ."""
    atol, rtol = FD_TOL[want.dtype]
    if got.shape != want.shape or not bool(torch.isfinite(got).all().item()):
        return float("inf")
    g, w = got.float(), want.float()
    return ((g - w).abs() / (atol + rtol * w.abs())).max().item()


def fd_plain_masked(q, k, v, live, p_dtype=None) -> torch.Tensor:
    """The plain decode attention over the positions ``live`` (B, K, S)
    marks, per kv head; with ``p_dtype`` the softmax weights are rounded to
    it before P.V. For readings of planted faults only."""
    B, H, dk = q.shape
    _, S, K, dv = v.shape
    qg = q.reshape(B, K, H // K, dk).float()
    s = torch.einsum("bgrh,bkgh->bgrk", qg, k.float()) * dk ** -0.5
    p = torch.softmax(s.masked_fill(~live[:, :, None, :], -1e30), dim=-1)
    if p_dtype is not None:
        p = p.to(p_dtype).float()
    out = torch.einsum("bgrk,bkgd->bgrd", p, v.float())
    return out.reshape(B, H, dv).to(q.dtype)


def fd_planted(fd, case, n_ctas: int) -> dict:
    """What the bf16 check reads for two planted faults on one case, against
    the plain version: (a) the partial of one CTA dropped (the middle
    segment of the unit that the most CTAs share, kernel.schedule's), which
    it must see (reading > 1); (b) P rounded to bf16 before P.V, as a
    kernel with one bf16 operand for P would compute (reported only)."""
    q, k, v, _, _, lengths = case
    B, H, _ = q.shape
    _, S, K, _ = k.shape
    rep = H // K
    segs = fd.schedule(lengths.tolist(), B, K, fd.row_tiles(rep), n_ctas)
    by_unit: dict[tuple, list] = {}
    for _, b, g, tile, start, end in segs:
        by_unit.setdefault((b, g, tile), []).append((start, end))
    (b, g, _), spans = max(by_unit.items(), key=lambda kv: len(kv[1]))
    if len(spans) < 2:
        raise AssertionError("no unit is shared by two CTAs at this shape")
    start, end = spans[len(spans) // 2]
    live = (torch.arange(S, device=q.device)[None, None, :]
            < lengths[:, None, None].long()).expand(B, K, S)
    want = fd_plain_masked(q, k, v, live)
    dropped_live = live.clone()
    dropped_live[b, g, start:end] = False
    dropped = fd_plain_masked(q, k, v, dropped_live)
    rounded = fd_plain_masked(q, k, v, live, torch.bfloat16)
    out = {}
    for name, got in (("partial_dropped", dropped), ("p_in_bf16", rounded)):
        out[name] = {"reading": fd_reading(got, want),
                     "max_abs_err": (got.float() - want.float()).abs()
                     .max().item()}
    out["partial_dropped"].update(row=b, kv_head=g, positions=[start, end],
                                  ctas_of_unit=len(spans))
    if not out["partial_dropped"]["reading"] > 1:
        raise AssertionError(f"the flash_decode check cannot see a dropped "
                             f"partial: {out}")
    return out


def fd_graph_check(decode_attn, ref) -> dict:
    """decode_attn captured twice, in two CUDA graphs on one stream, on
    static buffers at the serving shape, after one eager call on that stream
    made its tickets and scratch (so no zeroing is captured: every replay
    rests on the kernel setting its tickets back to 0). The second graph is
    replayed first, then the two in turns with an eager call on the stream
    between, with two cases (q, the NaN-poisoned caches, lengths) copied in
    by turns; each output held against the plain version."""
    sv = SERVE_SHAPE
    cases = [make_case(sv["B"], sv["H"], sv["K"], sv["dk"], sv["dv"], sv["S"],
                       torch.bfloat16, 40 + j) for j in range(2)]
    static = [torch.empty_like(t) for t in (cases[0][0], cases[0][3],
                                            cases[0][4], cases[0][5])]

    def load(case):
        q, _, _, kp, vp, lengths = case
        for dst, src in zip(static, (q, kp, vp, lengths)):
            dst.copy_(src)

    load(cases[0])
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        decode_attn(*static)
    torch.cuda.current_stream().wait_stream(stream)
    graphs, outs = [], []
    for _ in range(2):
        graphs.append(torch.cuda.CUDAGraph())
        with torch.cuda.graph(graphs[-1], stream=stream):
            outs.append(decode_attn(*static))
    steps = (("graph 1", 0), ("graph 0", 1), ("eager", 0), ("graph 0", 0),
             ("graph 1", 1), ("eager", 1))
    readings = []
    for what, j in steps:
        q, k, v, _, _, lengths = cases[j]
        load(cases[j])
        torch.cuda.synchronize()
        if what == "eager":
            with torch.cuda.stream(stream):
                out = decode_attn(*static)
        else:
            g = int(what[-1])
            graphs[g].replay()
            out = outs[g]
        want = ref(q, k, v, lengths)
        torch.cuda.synchronize()
        readings.append(fd_reading(out, want))
    if not max(readings) <= 1:
        raise AssertionError(f"flash_decode in CUDA graphs: readings "
                             f"{readings} over {[s[0] for s in steps]} "
                             f"({FD_TOL_TEXT})")
    return {"steps": [s[0] for s in steps], "reading": readings,
            "tol": FD_TOL_TEXT}


def fd_timing(label, shape, n_sets, decode_attn, ref, hbm_bytes, hbm,
              peak, full: bool = False, case=make_case) -> dict:
    """flash_decode at one timing shape in bf16, ragged lengths from
    ``case`` (make_case; ``full``: every row at S), n_sets distinct caches
    taken in turn: the kernel (CUDA-graph
    replay and eager), the plain version and one library call
    (scaled_dot_product_attention, a yardstick the port never calls) beside
    the least time the card could take. The first case, NaN-poisoned past
    each row's length, is held against the plain version first."""
    B, H, K, dk, dv, S = (shape[x] for x in ("B", "H", "K", "dk", "dv", "S"))
    first = case(B, H, K, dk, dv, S, torch.bfloat16, 30, full)
    q, k, v, kp, vp, lengths = first
    got = decode_attn(q, kp, vp, lengths)
    want = ref(q, k, v, lengths)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    reading = fd_reading(got, want)
    if not reading <= 1:
        raise AssertionError(f"flash_decode disagrees at the {label} timing "
                             f"shape: reading {reading} > 1 ({FD_TOL_TEXT})")
    del kp, vp, got, want
    sets = [(q, k, v)] + [case(B, H, K, dk, dv, S, torch.bfloat16, 30 + j,
                               full)[:3] for j in range(1, n_sets)]
    del first
    turn = {"i": 0}

    def nxt():
        turn["i"] = (turn["i"] + 1) % len(sets)
        return sets[turn["i"]]

    kernel_ms = time_ms(lambda: decode_attn(*nxt(), lengths))
    kernel_eager_ms = time_eager_ms(lambda: decode_attn(*nxt(), lengths))
    plain_ms = time_ms(lambda: ref(*nxt(), lengths), reps=4)
    mask = (torch.arange(S, device="cuda")[None, :]
            < lengths[:, None].long())[:, None, None, :]

    def library_call():
        q, k, v = nxt()
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)

    try:
        library_ms = time_ms(library_call, reps=16)
        library_note = "scaled_dot_product_attention(enable_gqa=True, bool mask)"
    except TypeError as exc:          # a torch without enable_gqa
        library_ms, library_note = None, f"not available: {exc}"
    lens = lengths.cpu().tolist()
    nbytes = hbm_bytes(lens, H, K, dk, dv, dtype_bytes=2)
    flops = sum(lens) * H * 2 * (dk + dv)
    bytes_ms, ops_ms = nbytes / hbm * 1e3, flops / peak * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    return {"shape": shape, "lengths": lens, "caches": n_sets,
            "check_max_err": err, "check_reading": reading,
            "kernel_ms": kernel_ms,
            "kernel_eager_ms": kernel_eager_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library": library_note,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_bytes": nbytes, "bound_flops": flops,
            "share_of_bound": bound_ms / kernel_ms,
            "achieved_GBps": nbytes / (kernel_ms * 1e-3) / 1e9}


# ------------------------------------------------------------ combine checks
def combine_checks() -> list[dict]:
    """allreduce_combine against its plain version on the card."""
    from repro_torch.kernels.allreduce_combine import kernel as ck
    from repro_torch.kernels.allreduce_combine.ops import combine_parts
    from repro_torch.kernels.allreduce_combine.ref import combine_ref
    dev = torch.device("cuda")
    results = []

    def check(label, x, op, tol, exact=False, nan_at=None):
        before = ck.launches
        got = combine_parts(x, op=op)
        want = combine_ref(x, op)
        torch.cuda.synchronize()
        if ck.launches != before + 1:
            raise AssertionError(f"combine {label}: no kernel launch")
        live = torch.ones_like(got, dtype=torch.bool)
        nan_ok = True
        if nan_at is not None:
            nan_ok = bool(torch.isnan(got[nan_at]).item())
            live[nan_at] = False
        diff = (got[live].double() - want[live].double()).abs()
        err = diff.max().item() if diff.numel() else 0.0
        ok = (nan_ok and bool(torch.isfinite(got[live].float()).all().item())
              and err <= tol and (not exact or err == 0.0))
        results.append({"case": label, "op": op,
                        "dtype": str(x.dtype).split(".")[-1],
                        "shape": list(x.shape), "vectorized": ck.vectorized(x),
                        "max_err": err, "tol": tol,
                        "bitwise": bool(torch.equal(got[live], want[live])),
                        "ok": ok})
        if not ok:
            emit({"phase": "combine", "checks": results})
            raise AssertionError(f"combine disagrees on {label} {op}: err "
                                 f"{err} > {tol} (nan kept: {nan_ok})")

    rng = np.random.default_rng(40)
    for shape in ((4, 1024), (3, 4096), (8, 8192)):
        x32 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                               * 8).to(dev)
        for dtype in (torch.float32, torch.bfloat16, torch.int32):
            for op in ("sum", "max", "min"):
                check(f"jax-test-{shape[0]}x{shape[1]}", x32.to(dtype), op,
                      1e-2)
    P, L = COMBINE_TIMING_SHAPE
    bucket = torch.from_numpy(rng.standard_normal((P, L)).astype(
        np.float32)).to(dev)
    check("intra-bucket", bucket, "sum", 1e-2)
    codes = torch.from_numpy(rng.integers(-254, 255, (P, L)).astype(
        np.int32)).to(dev)
    check("inter-codes", codes, "sum", 0.0, exact=True)
    odd = torch.from_numpy(rng.standard_normal((3, 1001)).astype(
        np.float32)).to(dev, torch.bfloat16)
    check("odd-L", odd, "sum", 1e-2)
    flat = torch.from_numpy(rng.standard_normal(2 * 4099 + 1).astype(
        np.float32)).to(dev)
    view = flat[1:].view(2, 4099)
    if ck.vectorized(view):
        raise AssertionError("the unaligned view took the vector path")
    for op in ("sum", "max", "min"):
        check("unaligned-view", view, op, 1e-2)
    nan = torch.from_numpy(rng.standard_normal((4, 4096)).astype(
        np.float32)).to(dev)
    nan[2, 1234] = float("nan")
    for dtype in (torch.float32, torch.bfloat16):
        for op in ("max", "min"):
            check("nan-planted", nan.to(dtype), op, 1e-2, nan_at=1234)
    big = torch.from_numpy(rng.integers(-(1 << 21), 1 << 21, (8, 8193))
                           .astype(np.int32)).to(dev)
    check("int32-exact", big, "sum", 0.0, exact=True)
    want = big.cpu().numpy().sum(0, dtype=np.int64)
    if not np.array_equal(combine_parts(big, op="sum").cpu().numpy(), want):
        raise AssertionError("int32 combine sum is not the exact integer sum")
    return results


# ------------------------------------------------------------- matmul phase
def matmul_phase(smi: str) -> tuple[list[dict], dict]:
    """Phase 5: matmul_tile against its plain version, the section 7 path
    through the public entry point, and its timings. Returns the lines to
    emit and the kernel's entry of the kernels line."""
    from repro_torch.kernels import matmul
    from repro_torch.kernels.matmul_tile import kernel as mk
    from repro_torch.kernels.matmul_tile.ref import matmul_ref
    from repro_torch.roofline.hw import H100
    from repro_torch.roofline.paper import SHAPES, matmul_accel_rows
    dev = torch.device("cuda")
    hbm, bf16_peak, f32_peak = card_peaks()
    gen = torch.Generator("cuda").manual_seed(100)
    results = []

    def inputs(M, N, K, dtype):
        return (torch.randn((M, K), device=dev, generator=gen).to(dtype),
                torch.randn((K, N), device=dev, generator=gen).to(dtype))

    def compare(label, a, b, got, exact=None):
        rtol, atol = MM_TOL[a.dtype]
        want = matmul_ref(a, b).float()
        diff = (got.float() - want).abs()
        excess = (diff - rtol * want.abs()).max().item()
        err = diff.max().item()
        ok = (got.dtype == a.dtype and got.shape == want.shape
              and bool(torch.isfinite(got).all().item()) and excess <= atol
              and (exact is None or bool((got.float() == exact).all().item())))
        results.append({"case": label, "dtype": str(a.dtype)[6:],
                        "mnk": [a.shape[0], b.shape[1], a.shape[1]],
                        "vectorized": mk.vectorized(a, b, got),
                        "max_err": err, "excess_over_rtol": excess,
                        "rtol": rtol, "atol": atol, "ok": ok})
        if not ok:
            emit({"phase": "matmul", "checks": results})
            raise AssertionError(f"matmul_tile disagrees on {label} "
                                 f"{a.dtype}: excess {excess} > {atol}")

    def launched(run):
        """run()'s result and the one variant it launched."""
        before = dict(mk.launches_by_variant)
        got = run()
        torch.cuda.synchronize()
        ran = [v for v, n in mk.launches_by_variant.items()
               if n != before[v]]
        if len(ran) != 1 or mk.launches_by_variant[ran[0]] != \
                before[ran[0]] + 1:
            raise AssertionError(f"expected one launch, got {ran}")
        return got, ran[0]

    def check(label, a, b, bk, want_variant, exact=None, tile=None):
        if tile is None:
            got, ran = launched(lambda: matmul(a, b, bk=bk))
        else:
            got, ran = launched(lambda: mk._launch(a, b, want_variant, tile))
        if ran != want_variant:
            raise AssertionError(f"matmul {label} {a.dtype} launched {ran}, "
                                 f"not {want_variant}")
        compare(label, a, b, got, exact)
        results[-1]["variant"] = ran
        results[-1]["tile"] = tile or mk.variant_for(a, b, got)[1]

    def aligned_variant(dtype):
        """The variant a shape with 16-byte rows runs."""
        return "ffma" if dtype == torch.float32 else "wgmma"

    # the descriptor check: one TMA stage and one warpgroup, random inputs
    for dtype in (torch.bfloat16, torch.float16):
        a, b = inputs(64, 256, 64, dtype)
        compare("wgmma-descriptor-probe-64x256x64", a, b,
                mk.wgmma_probe(a, b))
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for M, N, K in MM_TEST_SHAPES:
            check(f"jax-test-{M}x{N}x{K}", *inputs(M, N, K, dtype), 128,
                  aligned_variant(dtype))
        for M, N, K in MM_EDGE_SHAPES:   # no 16-bit row is 16-byte aligned
            check(f"edge-{M}x{N}x{K}", *inputs(M, N, K, dtype), 512,
                  "ffma" if dtype == torch.float32 else "mma_sync")
    for dtype in (torch.bfloat16, torch.float16):
        for M, N, K, bk in MM_WGMMA_EDGE_SHAPES:
            ab = inputs(M, N, K, dtype)
            check(f"wgmma-edge-{M}x{N}x{K}", *ab, bk, "wgmma")
            check(f"wgmma-edge-{M}x{N}x{K}", *ab, bk, "wgmma",
                  tile=(128, 256))
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        ones = (torch.ones((128, 2048), device=dev, dtype=dtype),
                torch.ones((2048, 128), device=dev, dtype=dtype))
        check("ones-K2048", *ones, 256, aligned_variant(dtype), exact=2048.0)
        if dtype != torch.float32:
            check("ones-K2048", *ones, 256, "mma_sync", exact=2048.0,
                  tile=mk.TILE)
    for dtype in (torch.float32, torch.bfloat16):
        for name, N, K in MM_PROJ:
            check(f"exanest-lm-100m-{name}", *inputs(MM_PROJ_M, N, K, dtype),
                  256, aligned_variant(dtype))
    # what the contract refuses raises on the card too, before any launch
    refused = {}
    z = torch.zeros((MM_PROJ_M, 2560), device=dev, dtype=torch.bfloat16)
    for label, a, b in (
            ("K=768, default bk 512", z[:, :768], torch.zeros(
                (768, 768), device=dev, dtype=torch.bfloat16)),
            ("N=10576 (mamba2 in_proj), default bn 128", z, torch.zeros(
                (2560, 10576), device=dev, dtype=torch.bfloat16)),
            ("K mismatch", z, torch.zeros((768, 768), device=dev,
                                          dtype=torch.bfloat16))):
        before = mk.launches
        try:
            matmul(a.contiguous(), b)
        except ValueError as exc:
            refused[label] = str(exc)
        else:
            raise AssertionError(f"matmul took {label}")
        if mk.launches != before:
            raise AssertionError(f"matmul launched on {label}")
    del z

    # the section 7 path: the evaluation's products through the public
    # entry point, the counter read just around them; each result is then
    # held against the plain version (which launches nothing)
    rows = matmul_accel_rows(H100)
    torch.cuda.synchronize()
    mk.launches = 0
    mk.launches_by_variant.update(dict.fromkeys(mk.VARIANTS, 0))
    path = []
    for dtype in (torch.bfloat16, torch.float32):
        for M, N, K in SHAPES:
            a, b = inputs(M, N, K, dtype)
            before = mk.launches
            by_variant = dict(mk.launches_by_variant)
            c = matmul(a, b)
            torch.cuda.synchronize()
            ran = [v for v, n in mk.launches_by_variant.items()
                   if n != by_variant[v]]
            path.append((M, N, K, dtype, mk.launches - before, ran))
            compare(f"section7-{M}^3", a, b, c)
            del a, b, c
    launches = mk.launches
    path_by_variant = dict(mk.launches_by_variant)
    if launches != len(path) or any(n != 1 for *_, n, _ in path):
        raise AssertionError(f"the section 7 path launched matmul_tile "
                             f"{[n for *_, n, _ in path]} times")
    for M, N, K, dtype, _, ran in path:
        if ran != [aligned_variant(dtype)]:
            raise AssertionError(f"section 7 {M}^3 {dtype} launched {ran}")

    # timings at the section 7 shapes: kernel, plain version, torch.matmul
    limit_w = power_limit_w(smi)
    timings = []
    for dtype in (torch.bfloat16, torch.float32):
        peak = bf16_peak if dtype == torch.bfloat16 else f32_peak
        for M, N, K in SHAPES:
            a, b = inputs(M, N, K, dtype)
            flops = 2 * M * N * K
            nbytes = a.element_size() * (M * K + K * N + M * N)
            out = torch.empty((M, N), dtype=dtype, device=dev)
            variant, tile = mk.variant_for(a, b, out)
            kernel_ms = time_auto_ms(lambda: matmul(a, b))
            # the Ampere-form variant at the same shape, for comparison
            mma_sync_ms = (None if dtype == torch.float32 else time_auto_ms(
                lambda: mk._launch(a, b, "mma_sync", out=out)))
            plain_ms = time_auto_ms(lambda: matmul_ref(a, b))
            library_ms = time_auto_ms(lambda: torch.matmul(a, b))
            bytes_ms, ops_ms = nbytes / hbm * 1e3, flops / peak * 1e3
            gflops = flops / (kernel_ms * 1e-3) / 1e9
            timings.append({
                "mnk": [M, N, K], "dtype": str(dtype)[6:],
                "variant": variant, "tile": list(tile),
                "kernel_ms": kernel_ms, "mma_sync_ms": mma_sync_ms,
                "mma_sync_share_of_peak": None if mma_sync_ms is None
                else flops / (mma_sync_ms * 1e-3) / peak,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "library": "torch.matmul(a, b), TF32 off",
                "bound_ms": max(bytes_ms, ops_ms), "bound_bytes": nbytes,
                "bound_flops": flops,
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "peak_flops": peak, "TFLOPs": gflops / 1e3,
                "share_of_peak": gflops * 1e9 / peak,
                "library_TFLOPs": flops / (library_ms * 1e-3) / 1e12,
                "library_share_of_peak": flops / (library_ms * 1e-3) / peak,
                "plain_share_of_peak": flops / (plain_ms * 1e-3) / peak,
                "kernel_over_library": kernel_ms / library_ms,
                "GFLOPs_per_W_of_power_limit":
                    None if limit_w is None else gflops / limit_w})
            del a, b, out
    # exanest-lm-100m's projections at 4096 tokens in bf16, beside the
    # library (no model op calls the kernel; these are measurements only)
    proj = []
    for name, N, K in MM_PROJ:
        a, b = inputs(MM_PROJ_M, N, K, torch.bfloat16)
        flops = 2 * MM_PROJ_M * N * K
        nbytes = 2 * (MM_PROJ_M * K + K * N + MM_PROJ_M * N)
        kernel_ms = time_auto_ms(lambda: matmul(a, b, bk=256))
        library_ms = time_auto_ms(lambda: torch.matmul(a, b))
        proj.append({"name": name, "mnk": [MM_PROJ_M, N, K],
                     "tile": list(mk.wgmma_tile(MM_PROJ_M, N, K)),
                     "kernel_ms": kernel_ms, "library_ms": library_ms,
                     "bound_ms": max(nbytes / hbm, flops / bf16_peak) * 1e3,
                     "share_of_peak":
                         flops / (kernel_ms * 1e-3) / bf16_peak})
        del a, b
    torch.cuda.empty_cache()
    from repro_torch.core.exanet.params import DEFAULT
    lines = [
        {"phase": "matmul_accel_rows", "spec": H100.name,
         "rows": [list(r) for r in rows]},
        {"phase": "matmul", "checks": results, "refused": refused,
         "section7_path": {"entry": "repro_torch.kernels.matmul",
                           "launches": launches,
                           "launches_by_variant": path_by_variant,
                           "calls": [[M, N, K, str(d)[6:], n, ran]
                                     for M, N, K, d, n, ran in path]},
         "timings": timings, "projections_bf16": proj,
         "power_limit_W": limit_w,
         "paper_fpga": {"GFLOPs": DEFAULT.mm_measured_gflops,
                        "GFLOPs_per_W": DEFAULT.mm_gflops_per_watt,
                        "note": "the paper's HLS accelerator at 300 MHz; "
                                "the card's GFLOP/s per W above is per W "
                                "of its power limit, not of measured draw"},
         "card": smi}]
    head = next(t for t in timings if t["mnk"] == list(MM_HEADLINE[0])
                and t["dtype"] == str(MM_HEADLINE[1])[6:])
    entry = {"name": "matmul_tile", "route": "cuda", "source": MM_SRC,
             "replaces": MM_TPU_SRC, "launches": launches,
             "max_abs_err": max(r["max_err"] for r in results),
             "variant": head["variant"], "ms": head["kernel_ms"],
             "mma_sync_ms": head["mma_sync_ms"], "plain_ms": head["plain_ms"],
             "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
             "library_ms": head["library_ms"],
             "launches_by_variant": path_by_variant,
             "tol": "|kernel - plain| <= atol + rtol |plain|: f32 rtol 1e-3 "
                    "atol 8e-3, bf16/f16 rtol 2e-2 atol 0.16",
             "path": "matmul (the section 7 products through "
                     "repro_torch.kernels.matmul)",
             "timing_shape": head["mnk"] + [head["dtype"]]}
    return lines, entry


# ------------------------------------------------------------------ dp phase
def _digest(tree) -> str:
    from repro_torch import tree as tree_util
    h = hashlib.sha256()
    for name, t in tree_util.named_leaves(tree):
        h.update(name.encode())
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def plain_compressed_bucket(parts: list, mesh: tuple[int, int]) -> np.ndarray:
    """The compressed sync of one bucket written out in numpy float32, from
    the ranks' buckets in rank order on a (pod, data) mesh: the data-axis
    sums, each padded to a multiple of the data size and cut into shards;
    one scale per (pod, shard) and int8 codes, the codes summed over the
    pods and dequantized by the mean of the scales; divided by the world."""
    n_pod, n_data = mesh
    n = parts[0].size
    pad = (-n) % n_data
    pods = [np.pad(sum(parts[p * n_data:(p + 1) * n_data]), (0, pad))
            for p in range(n_pod)]
    w = pods[0].size // n_data
    out = []
    for i in range(n_data):
        shards = [x[i * w:(i + 1) * w] for x in pods]
        scales = [np.maximum(np.abs(x).max() / np.float32(127.0),
                             np.float32(1e-20)) for x in shards]
        q = sum(np.round(x / sc).astype(np.int32)
                for x, sc in zip(shards, scales))
        out.append(q.astype(np.float32) * (sum(scales) / np.float32(n_pod)))
    return np.concatenate(out)[:n] / np.float32(n_pod * n_data)


def plain_compressed_sync(parts: list, leaf_sizes: list[int], per: int,
                          mesh: tuple[int, int], *,
                          error_feedback: bool = True) -> np.ndarray:
    """CompressedSync's first call written out in numpy float32, from each
    rank's flat gradient (the sync's leaf order, leaves of ``leaf_sizes``
    elements): each leaf rounded to int8 steps of its own scale (the error
    feedback's residual is still 0), then plain_compressed_bucket on each
    bucket of ``per`` elements. ``error_feedback=False`` leaves out the
    per-leaf rounding: ``sync_gradients``' compressed buckets alone, as
    strategy="auto" with allow_lossy runs them (no error feedback)."""
    hats = []
    for g in parts:
        if not error_feedback:
            hats.append(g)
            continue
        hat, off = np.empty_like(g), 0
        for n in leaf_sizes:
            x = g[off:off + n]
            sc = np.maximum(np.abs(x).max() / np.float32(127.0),
                            np.float32(1e-20))
            hat[off:off + n] = np.round(x / sc) * sc
            off += n
        hats.append(hat)
    return np.concatenate([
        plain_compressed_bucket([h[lo:lo + per] for h in hats], mesh)
        for lo in range(0, hats[0].size, per)])


def grad_errors(got, want, bucket_bytes: int) -> dict:
    """``got`` against ``want`` (gradient trees): the norm of the difference
    relative to the norm of ``want``, per leaf and per bucket of the sync's
    plan, worst first; the absolute norm where ``want``'s is 0."""
    from repro_torch import tree as tree_util
    from repro_torch.parallel.grad_sync import flatten_to_buckets

    def rel(a, b):
        a, b = a.float().cpu(), b.float().cpu()
        d = (a - b).norm().item()
        n = b.norm().item()
        return d / n if n > 0 else d

    leaves = [(name, rel(a, b)) for (name, a), (_, b) in zip(
        tree_util.named_leaves(got), tree_util.named_leaves(want))]
    ga, _ = flatten_to_buckets(got, bucket_bytes)
    gb, _ = flatten_to_buckets(want, bucket_bytes)
    buckets = [rel(a, b) for a, b in zip(ga, gb)]
    worst = max(leaves, key=lambda x: x[1])
    return {"worst_leaf": worst[0], "worst_leaf_rel": worst[1],
            "worst_bucket_rel": max(buckets), "buckets_rel": buckets,
            "tree_rel": rel(torch.cat([a.reshape(-1) for a in ga]),
                            torch.cat([b.reshape(-1) for b in gb]))}


def dp_worker(rank: int, port: int, out_dir: str) -> None:
    """One rank of the dp phase (run by torch.multiprocessing, spawn)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    from repro_torch import tree as tree_util
    from repro_torch.configs import get
    from repro_torch.core.comm import CommPolicy
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels.allreduce_combine import kernel as ck
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.parallel.grad_sync import (CompressedSync, bucket_sizes,
                                                combine_launches_per_sync,
                                                flatten_to_buckets,
                                                plan_buckets, sync_gradients,
                                                unflatten_from_buckets)
    from repro_torch.train.loop import Trainer
    from repro_torch.train.optimizer import AdamWConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    world = DP["world"]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=600))
    sections: dict = {}
    t_lap = [time.perf_counter()]

    def lap(name):
        """Seconds since the last lap, kept under ``name``."""
        now = time.perf_counter()
        sections[name] = now - t_lap[0]
        t_lap[0] = now

    try:
        mesh = make_mesh(DP["mesh"], ("pod", "data"), device=dev)
        cfg = get("exanest-lm-100m")
        model = build_model(cfg)
        opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=1, decay_steps=10)
        state0 = Trainer(model, opt_cfg, device=dev).init_state(
            torch.Generator().manual_seed(0))
        data = SyntheticTokens(cfg, batch=DP["global_batch"], seq=DP["seq"],
                               device=dev)
        per = DP["global_batch"] // world
        bucket_bytes = CommPolicy().bucket_bytes(world)

        def local(i):
            return {k: v[rank * per:(rank + 1) * per]
                    for k, v in data.batch_at(i).items()}

        # what each sync takes and hands the optimizer on its first step,
        # kept for check (d)
        inputs: dict = {}
        synced: dict = {}

        def capture(sync, key):
            def fn(grads):
                out = sync(grads)
                if key not in synced:
                    inputs[key], synced[key] = grads, out
                return out
            return fn

        buckets = bucket_sizes(state0["params"], bucket_bytes)
        rec: dict = {"rank": rank, "coords": mesh.coords,
                     "buckets": len(buckets), "bucket_elems": buckets[:2],
                     "steps": {}}

        def timed_plan(tree, lossy):
            """plan_buckets on ``tree`` with the default policy, as each
            sync_gradients(strategy="auto") call runs it once, and its host
            time in ms (perf_counter)."""
            t = time.perf_counter()
            plan = plan_buckets(tree, mesh, allow_lossy=lossy)
            return plan, (time.perf_counter() - t) * 1e3

        def run(label, step, want):
            """DP["steps"] steps of ``step`` from state0: checks (a) and (b)
            on each; returns the mean loss and the parameters after the
            first."""
            state, first = state0, None
            for i in range(DP["steps"]):
                torch.cuda.synchronize()
                ck.launches = 0
                t0 = time.perf_counter()
                state, m = step(state, local(i))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = ck.launches
                losses = [None] * world
                dist.all_gather_object(losses, float(m["loss"]))
                digests = [None] * world
                dist.all_gather_object(digests, _digest(state["params"]))
                rec["steps"][f"{label}-{i}"] = {
                    "combine_launches": launches, "expected": want,
                    "loss_mean": float(np.mean(losses)), "wall_s": wall,
                    "params_equal_across_ranks": len(set(digests)) == 1}
                if launches != want:
                    raise AssertionError(f"rank {rank} {label} step {i}: "
                                         f"{launches} combine launches, "
                                         f"expected {want}")
                if len(set(digests)) != 1:
                    raise AssertionError(f"{label} step {i}: parameters "
                                         "differ across ranks")
                if i == 0:
                    first = (float(np.mean(losses)), state["params"])
            return first

        lap("setup")
        first = {}
        for strategy in ("flat", "hierarchical", "compressed"):
            tr = Trainer(model, opt_cfg, mesh=mesh, sync_strategy=strategy,
                         device=dev)
            sync = (CompressedSync(mesh, mean_over=world)
                    if strategy == "compressed" else tr.make_sync())
            first[strategy] = run(
                strategy, tr.make_step(sync_fn=capture(sync, strategy)),
                combine_launches_per_sync(mesh, [strategy] * len(buckets)))
        first_hier = first["hierarchical"]
        lap("named_runs")
        # (e), (f): the Trainer's default strategy, "auto", exact and lossy;
        # the plan is the list the sync runs, its launches are gated by run
        for label, lossy in (("auto", False), ("auto_lossy", True)):
            timed = [timed_plan(state0["params"], lossy) for _ in range(3)]
            plan = timed[0][0]
            if plan != AUTO_PLANS[lossy]:
                raise AssertionError(f"{label}: planned "
                                     f"{collections.Counter(plan)}, "
                                     f"expected {AUTO_PLANS[lossy]}")
            tr = Trainer(model, opt_cfg, mesh=mesh, device=dev,
                         allow_lossy=lossy)
            if tr.sync_strategy != "auto":
                raise AssertionError("Trainer's default sync strategy "
                                     f"is {tr.sync_strategy!r}")
            first[label] = run(
                label, tr.make_step(sync_fn=capture(tr.make_sync(), label)),
                combine_launches_per_sync(mesh, plan))
            rec[f"{label}_plan"] = dict(collections.Counter(plan))
            rec[f"{label}_planner_ms"] = [ms for _, ms in timed]
        lap("auto_runs")
        # (g) a mixed plan: one hierarchical bucket, one flat
        rng = np.random.default_rng(70 + rank)
        mixed = {k: torch.from_numpy(rng.standard_normal(n).astype(
            np.float32)).to(dev) for k, n in MIXED_TREE.items()}
        plan, plan_ms = timed_plan(mixed, False)
        if plan != MIXED_PLAN:
            raise AssertionError(f"mixed tree planned {plan}, expected "
                                 f"{MIXED_PLAN}")
        torch.cuda.synchronize()
        ck.launches = 0
        mixed_out = sync_gradients(mixed, mesh, strategy="auto",
                                   mean_over=world)
        torch.cuda.synchronize()
        mixed_launches = ck.launches
        want = combine_launches_per_sync(mesh, plan)
        rec["mixed"] = {"plan": plan, "combine_launches": mixed_launches,
                        "expected": want, "planner_ms": plan_ms}
        if mixed_launches != want:
            raise AssertionError(f"rank {rank} mixed sync: {rec['mixed']}")
        flat_in = torch.cat([mixed[k].cpu() for k in sorted(mixed)])
        flat_out = torch.cat([mixed_out[k].cpu() for k in sorted(mixed)])
        ins = ([torch.empty_like(flat_in) for _ in range(world)]
               if rank == 0 else None)
        dist.gather(flat_in, ins, dst=0)
        if rank == 0:
            want_mean = sum(x.numpy().astype(np.float64) for x in ins) / world
            rel = float(np.abs(flat_out.numpy() - want_mean).max()
                        / np.abs(want_mean).max())
            rec["mixed"].update({"elements": int(flat_in.numel()),
                                 "max_rel_err": rel, "tol": 1e-5,
                                 "plain": "float64 mean of the four ranks"})
            if not rel <= 1e-5:
                raise AssertionError(f"mixed auto sync off the float64 mean "
                                     f"by {rel}")
        lap("mixed")
        # (c) one bucket through each strategy against its plain version
        n = bucket_bytes // 4
        x = torch.from_numpy(np.random.default_rng(50 + rank)
                             .standard_normal(n).astype(np.float32))
        got = {}
        for strategy in ("flat", "hierarchical", "compressed"):
            ck.launches = 0
            got[strategy] = sync_gradients({"g": x.to(dev)}, mesh,
                                           strategy=strategy,
                                           mean_over=world)["g"].cpu()
            torch.cuda.synchronize()
            rec[f"bucket_check_launches_{strategy}"] = ck.launches
        xs = [torch.empty_like(x) for _ in range(world)] if rank == 0 else None
        dist.gather(x, xs, dst=0)
        if rank == 0:
            parts = [t.numpy() for t in xs]
            plain = {"flat": sum(p.astype(np.float64) for p in parts) / world,
                     "compressed": plain_compressed_bucket(parts,
                                                           DP["mesh"])}
            plain["hierarchical"] = plain["flat"]
            rec["bucket_check"] = {}
            for strategy, tol in BUCKET_TOL.items():
                want = plain[strategy]
                rel = float(np.abs(got[strategy].numpy() - want).max()
                            / np.abs(want).max())
                rec["bucket_check"][strategy] = {
                    "elements": n, "max_rel_err": rel, "tol": tol,
                    "plain": "float64 mean of the four ranks' buckets"
                    if strategy != "compressed" else
                    "the compressed algorithm in numpy float32"}
                if not rel <= tol:
                    raise AssertionError(f"{strategy} sync of one bucket off "
                                         f"its plain version by {rel}")
        lap("bucket_check")
        # (d) each sync's first-step gradient against its plain version on
        # the four ranks' gathered gradients, and against one single-process
        # step's at the global batch; that step's loss and parameters
        # against the first hierarchical step's
        if rank == 0:
            single = Trainer(model, opt_cfg, device=dev).make_step(
                sync_fn=capture(lambda g: g, "single"))
            s1, m1 = single(state0, data.batch_at(0))
        leaf_sizes = [t.numel() for t in tree_util.leaves(state0["params"])]
        # (e) auto against hierarchical on this rank: the same plan and the
        # same arithmetic, so equal inputs must give equal bits
        def bitwise(a, b):
            return all(torch.equal(x, y) for x, y in zip(
                tree_util.leaves(a), tree_util.leaves(b)))

        same = {"inputs": bitwise(inputs["auto"], inputs["hierarchical"]),
                "synced": bitwise(synced["auto"], synced["hierarchical"]),
                "params": bitwise(first["auto"][1], first_hier[1])}
        every = [None] * world
        dist.all_gather_object(every, same)
        rec["auto_vs_hierarchical_bitwise"] = every
        if same["inputs"] and not (same["synced"] and same["params"]):
            raise AssertionError(f"rank {rank}: auto and hierarchical took "
                                 "the same gradient and plan but differ: "
                                 f"{same}")
        # auto is held against its plain version only where some rank's
        # bits differ from hierarchical's (else its errors are
        # hierarchical's, to the bit)
        bit_equal = all(r["inputs"] and r["synced"] for r in every)
        lap("single_step")
        # the four ranks' first-step gradients are gathered to rank 0 once
        # for each distinct input: a sync whose input equals, on every rank,
        # one gathered before reuses its parts and its plain versions
        gathered: list = []             # [(key, the ranks' flat grads)]
        plains: dict = {}               # (gathered index, kind) -> flat
        grads, rec["gathered_from"] = {}, {}
        for k in ("flat", "hierarchical", "compressed", "auto_lossy") + (
                () if bit_equal else ("auto",)):
            mine = [bitwise(inputs[k], inputs[j]) for j, _ in gathered]
            alike = [None] * world
            dist.all_gather_object(alike, mine)
            src = next((i for i in range(len(gathered))
                        if all(m[i] for m in alike)), None)
            if src is None:
                flat_g = torch.cat([g.float().reshape(-1) for g in
                                    tree_util.leaves(inputs[k])]).cpu()
                parts = ([torch.empty_like(flat_g) for _ in range(world)]
                         if rank == 0 else None)
                dist.gather(flat_g, parts, dst=0)
                src = len(gathered)
                gathered.append((k, parts and [t.numpy() for t in parts]))
                del flat_g, parts
            rec["gathered_from"][k] = gathered[src][0]
            if rank != 0:
                continue
            parts = gathered[src][1]
            lossy = k in ("compressed", "auto_lossy")
            kind = k if lossy else "mean"
            if (src, kind) not in plains:
                plains[src, kind] = (plain_compressed_sync(
                    parts, leaf_sizes, bucket_bytes // 4, DP["mesh"],
                    error_feedback=k == "compressed") if lossy else
                    (sum(p.astype(np.float64) for p in parts)
                     / world).astype(np.float32))
            _, spec = flatten_to_buckets(synced[k], bucket_bytes)
            plain = unflatten_from_buckets(
                [torch.from_numpy(plains[src, kind])], spec)
            grads[k] = {
                "plain": grad_errors(synced[k], plain, bucket_bytes),
                "single": grad_errors(synced[k], synced["single"],
                                      bucket_bytes)}
            if k == "auto":
                grads[k]["hierarchical"] = grad_errors(
                    synced[k], synced["hierarchical"], bucket_bytes)
            del parts, plain
        del gathered, plains
        if rank == 0:
            loss_err = abs(float(m1["loss"]) - first_hier[0])
            worst = 0.0
            for (name, a), (_, b) in zip(tree_util.named_leaves(s1["params"]),
                                         tree_util.named_leaves(first_hier[1])):
                d = ((a.float() - b.float()).abs()
                     - 2e-2 * b.float().abs()).max().item()
                worst = max(worst, d)
            rec["single_check"] = {"loss_single": float(m1["loss"]),
                                   "loss_dp_mean": first_hier[0],
                                   "loss_abs_err": loss_err,
                                   "param_excess_over_rtol": worst,
                                   "tol": 2e-2, "grads": grads,
                                   "grad_tol": DP_GRAD_TOL}
            print(json.dumps({"dp_bucket_check": rec["bucket_check"],
                              "dp_single_check": rec["single_check"]}),
                  flush=True)
            if not (loss_err < 2e-2 and worst <= 2e-2):
                raise AssertionError(f"DP step vs single step: loss err "
                                     f"{loss_err}, param excess {worst}")
            # auto against hierarchical: bit for bit where both took the
            # same gradients (above); else to DP_GRAD_TOL's "plain" limit
            if not bit_equal:
                got = grads["auto"]["hierarchical"]["worst_leaf_rel"]
                if not got <= DP_GRAD_TOL["plain"]:
                    raise AssertionError(f"auto's first-step gradient off "
                                         f"hierarchical's by {got}")
            for k, e in grads.items():
                for against, tol in DP_GRAD_TOL.items():
                    got = e[against]["worst_leaf_rel"]
                    if (against == "plain" or k not in ("compressed",
                                                        "auto_lossy")) \
                            and not got <= tol:
                        raise AssertionError(
                            f"{k} sync's first-step gradient vs the "
                            f"{against} version: leaf {e[against]['worst_leaf']}"
                            f" off by {got} > {tol}")
        lap("first_step_checks")
        rec["section_s"] = sections
        (Path(out_dir) / f"dp_rank{rank}.json").write_text(json.dumps(rec))
        dist.barrier()
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------- Mamba-2 phases
def layer_ssd_inputs(cfg, embed, layer, tokens):
    """The (x, dt, A, B, C) of the first Mamba-2 ``layer`` (its parameter
    tree) on ``tokens``, as mamba2_forward makes them: embedding, ln1,
    projections, causal convs, softplus."""
    from repro_torch.models import ssm
    from repro_torch.models.layers import apply_norm, embed_tokens
    s, d_in, nh, _ = ssm._dims(cfg)
    with torch.no_grad():
        h = apply_norm(layer["ln1"], embed_tokens(embed, tokens, cfg), cfg)
        _, xc, Bc, Cc, dtr, _ = ssm._project(layer["ssm"], h, cfg)
        Bsz, L = tokens.shape
        x = xc.reshape(Bsz, L, nh, s.head_dim).contiguous()
        B = Bc.reshape(Bsz, L, s.n_groups, s.d_state).contiguous()
        C = Cc.reshape(Bsz, L, s.n_groups, s.d_state).contiguous()
        dt = ssm._softplus(dtr.float() + layer["ssm"]["dt_bias"]).contiguous()
        A = (-torch.exp(layer["ssm"]["A_log"])).contiguous()
    return x, dt, A, B, C


def ssd_case(b, l, h, p, n, dtype, seed):
    """Random SSD inputs on the card, drawn as the reference's test draws
    them (dt post-softplus, A = -exp(0.3 N))."""
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    x = torch.from_numpy(rng.standard_normal((b, l, h, p), np.float32))
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((b, l, h), np.float32)))
    A = -torch.exp(torch.from_numpy(rng.standard_normal(h).astype(
        np.float32)) * 0.3)
    B, C = (torch.from_numpy(rng.standard_normal((b, l, 1, n), np.float32))
            for _ in range(2))
    return (x.to(dev, dtype), dt.to(dev), A.to(dev), B.to(dev, dtype),
            C.to(dev, dtype))


def ssd_checks(model, params, tokens) -> tuple[list[dict], tuple]:
    """ssd_scan against its plain version and the chunked forms on the
    card; returns the checks and layer 0's inputs (the timing shape)."""
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_tc, ssd_ref
    from repro_torch.models import ssm
    results = []
    want_variant = {torch.float32: "ffma", torch.bfloat16: "mma_sync"}

    def fail(msg):
        emit({"phase": "ssd_kernel", "checks": results})
        raise AssertionError(msg)

    def rel(got, want):
        return ((got - want).abs().max() / want.abs().max()).item()

    # (b, l, h, p, n, chunk): the reference's three test shapes, then the
    # layer's head width (80 heads of 64, d_state 128, chunk 256)
    shapes = [(2, 128, 8, 16, 16, 32), (1, 256, 4, 32, 64, 64),
              (2, 64, 16, 16, 32, 64), (1, 512, 80, 64, 128, 256)]
    for i, (b, l, h, p, n, chunk) in enumerate(shapes):
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 6e-2)):
            x, dt, A, B, C = ssd_case(b, l, h, p, n, dtype, 80 + i)
            variant = want_variant[dtype]
            before = dict(sk.launches_by_variant)
            y, st = sk.ssd_scan(x, dt, A, B, C, chunk=chunk)
            y_r, st_r = ssd_ref(x, dt, A, B, C)
            tight = None
            if variant == "mma_sync":
                y_t, st_t = ssd_chunked_tc(x, dt, A, B, C, chunk)
                tight = max(rel(y, y_t), rel(st, st_t))
            torch.cuda.synchronize()
            ran = {k: v - before[k] for k, v in sk.launches_by_variant.items()}
            # the reference's form: |got - want| <= tol |want| + 10 tol
            excess = max(((y - y_r).abs() - tol * y_r.abs()).max().item(),
                         ((st - st_r).abs() - tol * st_r.abs()).max().item())
            err = max((y - y_r).abs().max().item(),
                      (st - st_r).abs().max().item())
            ok = (ran == {k: int(k == variant) for k in ran}
                  and excess <= 10 * tol
                  and (tight is None or tight <= SSD_TC_TIGHT)
                  and bool(torch.isfinite(y).all().item()))
            results.append({"case": f"ref-shape-{i}", "shape": [b, l, h, p, n],
                            "chunk": chunk, "dtype": str(dtype)[6:],
                            "variant": variant, "ran": ran,
                            "max_err": err, "excess_over_rtol": excess,
                            "rtol": tol, "atol": 10 * tol,
                            "rel_err_vs_ssd_chunked_tc": tight,
                            "tight_tol": SSD_TC_TIGHT if tight is not None
                            else None, "ok": ok})
            if not ok:
                fail(f"ssd_scan disagrees with ssd_ref at {shapes[i]} "
                     f"{dtype}: excess {excess} > {10 * tol}, against "
                     f"ssd_chunked_tc {tight}, or ran {ran} (not {variant})")
    # a ragged length through the model's route: padded to 4 chunks of 256
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 6e-2)):
        x, dt, A, B, C = ssd_case(1, 1000, 8, 64, 128, dtype, 90)
        variant = want_variant[dtype]
        before = sk.launches_by_variant[variant]
        y, st = ssm.ssd(x, dt, A, B, C, 256)
        y_r, st_r = ssd_ref(x, dt, A, B, C)
        torch.cuda.synchronize()
        excess = max(((y - y_r).abs() - tol * y_r.abs()).max().item(),
                     ((st - st_r).abs() - tol * st_r.abs()).max().item())
        ok = (sk.launches_by_variant[variant] == before + 1
              and y.shape == y_r.shape and excess <= 10 * tol)
        results.append({"case": "route-ragged-l1000",
                        "shape": [1, 1000, 8, 64, 128], "chunk": 256,
                        "dtype": str(dtype)[6:], "variant": variant,
                        "max_err": (y - y_r).abs().max().item(),
                        "excess_over_rtol": excess, "rtol": tol,
                        "atol": 10 * tol, "ok": ok})
        if not ok:
            fail(f"the route disagrees at l=1000 {dtype}: excess {excess}")
    # full width, from layer 0's real inputs on the train batch
    from repro_torch import tree as tree_util
    x, dt, A, B, C = layer_ssd_inputs(
        model.cfg, params["embed"],
        tree_util.tree_map(lambda t: t[0], params["stack"]), tokens)
    chunk = model.cfg.ssm.chunk
    before = sk.launches_by_variant["mma_sync"]
    outs = {"mma_sync": ssm.ssd(x, dt, A, B, C, chunk)}
    launched = {"mma_sync": sk.launches_by_variant["mma_sync"] - before}
    before = sk.launches_by_variant["ffma"]
    outs["ffma"] = sk._launch(x, dt, A, B, C, chunk=chunk, variant="ffma")
    launched["ffma"] = sk.launches_by_variant["ffma"] - before
    forms = {"tc": lambda: ssd_chunked_tc(x, dt, A, B, C, chunk),
             "bfloat16": lambda: ssm.ssd_chunked(x, dt, A, B, C, chunk),
             "float32": lambda: ssm.ssd_chunked(x.float(), dt, A, B.float(),
                                                C.float(), chunk)}
    form_names = {"tc": "ssd_chunked_tc", "bfloat16": "ssd_chunked (bf16)",
                  "float32": "ssd_chunked (float32)"}
    for form, make in forms.items():
        y_c, st_c = make()        # one full-width form alive at a time
        for variant, (y, st) in outs.items():
            tol = SSD_FULL_TOL.get((variant, form))
            if tol is None:
                continue
            err = max(rel(y, y_c), rel(st, st_c))
            ok = launched[variant] == 1 and err <= tol
            results.append({"case": f"layer0-full-width-{variant}-vs-{form}",
                            "form": form_names[form], "variant": variant,
                            "shape": list(x.shape) + [B.shape[-1]],
                            "chunk": chunk, "dtype": str(x.dtype)[6:],
                            "max_err": (y - y_c).abs().max().item(),
                            "max_abs_y": y_c.abs().max().item(),
                            "rel_err_y": rel(y, y_c),
                            "rel_err_state": rel(st, st_c),
                            "tol": tol, "ok": ok})
            if not ok:
                fail(f"ssd_scan {variant} vs {form_names[form]} at full "
                     f"width: {err} > {tol} (launched {launched})")
        del y_c, st_c
    del outs
    return results, (x, dt, A, B, C)


def ssd_train_phase(phase: str, train: dict, model, state, step_fn, data,
                    smi: str, **extra) -> dict:
    """``train``'s steps (SSM_TRAIN, HYBRID_TRAIN) of ``step_fn`` on a
    Mamba-2 model (the ssm_train and hybrid_train phases): every loss
    finite, the mean loss of the
    held-out batches falling by min_drop, and ssd_scan launched (forward +
    recompute) once a layer each per step, all through mma_sync, counted
    from 0 over the steps. ``state`` (the train state dict) advances in
    place: its entries are replaced each step, so no reference to an
    earlier step's parameters or moments outlives it. Emits the phase's
    line (with ``extra``) and returns it."""
    from repro_torch import tree as tree_util
    from repro_torch.kernels.ssd_scan import kernel as sk
    cfg = model.cfg
    held = [data.batch_at(i) for i in range(*train["eval_steps"])]

    def held_loss(params):
        with torch.no_grad():
            return [float(model.loss_fn(params, b)) for b in held]

    held_before = held_loss(state["params"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.launches = 0
    sk.launches_by_variant.update(dict.fromkeys(sk.launches_by_variant, 0))
    losses, walls, per_step = [], [], []
    t_run = time.perf_counter()
    for i in range(train["steps"]):
        before = sk.launches
        t = time.perf_counter()
        new, metrics = step_fn(state, data.batch_at(i))
        state.update(new)
        del new
        losses.append(float(metrics["loss"]))       # waits for the step
        walls.append(time.perf_counter() - t)
        per_step.append(sk.launches - before)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    train_launches = sk.launches
    train_by_variant = dict(sk.launches_by_variant)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    held_after = held_loss(state["params"])
    drop = float(np.mean(held_before) - np.mean(held_after))
    steady_ms = float(np.mean(walls[1:])) * 1e3
    tokens = train["batch"] * train["seq"]
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    want = 2 * cfg.n_layers
    line = {"phase": phase, "arch": cfg.name, "dtype": cfg.dtype,
            "params": sum(t.numel() for t in
                          tree_util.leaves(state["params"])),
            "entry": "Trainer.make_step", **train, "losses": losses,
            "first5_mean": first5, "last5_mean": last5,
            "held_out_losses_before": held_before,
            "held_out_losses_after": held_after, "held_out_mean_drop": drop,
            "threshold": f"held_out_mean_drop >= {train['min_drop']}",
            "wall_s": run_s, "step_wall_ms": [w * 1e3 for w in walls],
            "ms_per_step_wall": steady_ms,
            "tok_per_s": tokens / (steady_ms / 1e3), "peak_mem_GB": peak_gb,
            "ssd_scan_launches": train_launches,
            "ssd_scan_launches_per_step": per_step,
            "ssd_scan_launches_by_variant": train_by_variant,
            "expected_per_step": f"{cfg.n_layers} layers x (forward + "
                                 f"recompute) = {want}, all mma_sync",
            **extra, "card": smi}
    emit(line)
    if any(n_ != want for n_ in per_step):
        raise AssertionError(f"ssd_scan launched {per_step} times per step; "
                             f"expected {want}")
    if train_by_variant != {"ffma": 0, "mma_sync": train_launches}:
        raise AssertionError(f"ssd_scan ran {train_by_variant} in training; "
                             "expected every launch through mma_sync")
    if not all(np.isfinite(losses + held_before + held_after)):
        raise AssertionError(f"a {phase} loss is not finite: {losses}, "
                             f"held-out {held_before} -> {held_after}")
    if not drop >= train["min_drop"]:
        raise AssertionError(f"the {phase} loss did not fall: held-out "
                             f"batches {held_before} -> {held_after}")
    return line


def ssd_train_profile(phase: str, state, step_fn, data, acts,
                      steady_ms: float, ssd_launches: int, smi: str,
                      **extra) -> None:
    """One more train step under torch.profiler, ``state`` advanced in
    place as in :func:`ssd_train_phase`: device busy against wall,
    kernels per step, the top kernels and ssd_scan's share, and its device
    time per launch over the ``ssd_launches`` a step makes. Emits the
    phase's line (with ``extra``)."""
    n_prof = 1
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(n_prof):
            state.update(step_fn(state, data.batch_at(100 + i))[0])
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    kernels = device_kernels(prof, n_prof)
    del prof
    busy = sum(ms for _, ms, _ in kernels)
    ssd_ms = sum(ms for name, ms, _ in kernels if "ssd_" in name)
    wall_ms = prof_wall / n_prof * 1e3
    line = {"phase": phase, "steps": n_prof,
            "ms_per_step_wall_profiled": wall_ms,
            "device_busy_ms_per_step": busy, "idle_share": 1 - busy / wall_ms,
            "idle_share_vs_unprofiled_wall": 1 - busy / steady_ms,
            "kernels_per_step": sum(n_ for *_, n_ in kernels),
            "ssd_scan_ms_per_step": ssd_ms,
            "ssd_scan_share_of_busy": ssd_ms / busy,
            "ssd_scan_ms_per_launch": ssd_ms / ssd_launches,
            "top": [[name[:80], ms, n_] for name, ms, n_ in kernels[:12]],
            **extra, "card": smi}
    emit(line)


def decode_readings(full16, lg16, full32, lg32) -> tuple[bool, dict]:
    """The decode-against-prefill gate of the ssm_decode and hybrid_decode
    phases, on the last logits of a full prefill (``full*``) and of a
    decode step after a prefill one token shorter (``lg*``), in bf16 and in
    the float32 twin: float32 within 3e-2 (rtol and atol, as
    tests/test_models_smoke.py); bf16 within the bf16 prefill's own
    distance from the float32 one, plus 3e-2. Returns (ok, readings)."""
    err32 = (lg32 - full32).abs().max().item()
    excess32 = ((lg32 - full32).abs() - 3e-2 * full32.abs()).max().item()
    noise16 = (full16 - full32).abs().max().item()
    err16 = (lg16 - full16).abs().max().item()
    ok = (bool(torch.isfinite(lg16).all().item())
          and bool(torch.isfinite(lg32).all().item())
          and excess32 <= 3e-2 and err16 <= noise16 + 3e-2)
    return ok, {
        "float32": {"max_abs_err": err32, "excess_over_rtol": excess32,
                    "rtol": 3e-2, "atol": 3e-2,
                    "max_abs_logit": full32.abs().max().item()},
        "bfloat16": {"decode_vs_own_prefill_max_abs": err16,
                     "decode_vs_own_prefill_mean_abs":
                         (lg16 - full16).abs().mean().item(),
                     "prefill_vs_float32_max_abs": noise16,
                     "decode_vs_float32_max_abs":
                         (lg16 - full32).abs().max().item(),
                     "limit": "decode_vs_own_prefill <= "
                              "prefill_vs_float32 + 3e-2"}}


def ssm_phases(smi: str, acts) -> dict:
    """Phases 11-14 on full-width mamba2-2.7b; returns ssd_scan's entry of
    the kernels line."""
    from repro_torch import tree as tree_util
    from repro_torch.configs import get
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan.ops import ssd_bound, ssd_cost
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    from repro_torch.models import build_model
    from repro_torch.train.loop import Trainer
    from repro_torch.train.optimizer import AdamWConfig
    cfg = get("mamba2-2.7b")
    model = build_model(cfg)
    tr = Trainer(model, AdamWConfig(lr=SSM_TRAIN["lr"],
                                    warmup_steps=SSM_TRAIN["warmup"],
                                    decay_steps=SSM_TRAIN["steps"]),
                 device="cuda")
    t0 = time.perf_counter()
    state = tr.init_state(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    data = SyntheticTokens(cfg, batch=SSM_TRAIN["batch"],
                           seq=SSM_TRAIN["seq"], seed=0, device="cuda")

    # ------------------------------------------------------ 11. ssd_kernel
    results, (x, dt, A, B, C) = ssd_checks(model, state["params"],
                                           data.batch_at(0)["tokens"])
    b, l, h, p = x.shape
    n, chunk = B.shape[-1], cfg.ssm.chunk
    other = ssd_case(b, l, h, p, n, x.dtype, 91)
    sets = [(x, dt, A, B, C), other]      # 2 x ~100 MB of inputs, in turn
    turn = {"i": 0}

    def nxt():
        turn["i"] = (turn["i"] + 1) % len(sets)
        return sets[turn["i"]]

    variant = sk.variant_for(x.dtype, p, n, chunk)
    if variant != "mma_sync":
        raise AssertionError(f"the layer's bf16 SSD would run {variant}")

    def run(v):
        return lambda: sk._launch(*nxt(), chunk=chunk, variant=v)

    # in turns: mma_sync, ffma on the same bf16 inputs, plain, ffma, mma_sync
    tc_ms = [time_ms(run("mma_sync"), reps=8)]
    ffma_ms = [time_ms(run("ffma"), reps=8)]
    plain_ms = time_ms(lambda: ssd_ref(*nxt()), reps=1, batches=3)
    ffma_ms.append(time_ms(run("ffma"), reps=8))
    tc_ms.append(time_ms(run("mma_sync"), reps=8))
    kernel_ms = statistics.median(tc_ms)
    kernel_eager_ms = time_eager_ms(lambda: sk.ssd_scan(*nxt(), chunk=chunk),
                                    reps=20)
    # device ms per launch of each CUDA kernel of each variant. The profiler
    # records only some launches of so short a window (on an H100: none of
    # the first variant's without the wait, one of four with it), so each
    # kernel's time is divided by its own recorded count
    kernel_split_ms, kernel_split_launches = {}, {}
    for v in sk.VARIANTS:
        with torch.profiler.profile(activities=acts) as prof:
            time.sleep(0.2)
            for _ in range(4):
                run(v)()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and "ssd_" in e.key):
                key = e.key.split("::")[-1].split("(")[0]
                us = getattr(e, "self_device_time_total", None)
                if us is None:
                    us = e.self_cuda_time_total
                kernel_split_ms[key] = us / 1e3 / e.count
                kernel_split_launches[key] = e.count
        del prof
    nbytes, flops = ssd_cost(b, l, h, p, n, chunk, x.element_size())
    bound_ms, bound_by = ssd_bound(b, l, h, p, n, chunk, x.element_size(),
                                   variant)
    ffma_bound_ms, ffma_bound_by = ssd_bound(b, l, h, p, n, chunk,
                                             x.element_size(), "ffma")
    emit({"phase": "ssd_kernel", "arch": cfg.name, "checks": results,
          "launches_by_variant": dict(sk.launches_by_variant),
          "init_state_s": init_s,
          "timing_shape": {"b": b, "l": l, "h": h, "p": p, "n": n,
                           "chunk": chunk, "dtype": str(x.dtype)[6:]},
          "variant": variant, "kernel_ms": kernel_ms,
          "kernel_ms_turns": tc_ms, "kernel_eager_ms": kernel_eager_ms,
          "ffma_ms": statistics.median(ffma_ms), "ffma_ms_turns": ffma_ms,
          "kernel_split_ms": kernel_split_ms,
          "kernel_split_launches": kernel_split_launches,
          "ffma_over_kernel": statistics.median(ffma_ms) / kernel_ms,
          "ref_ms": plain_ms, "library_ms": None,
          "library": "no single PyTorch call computes the SSD scan",
          "bound_ms": bound_ms, "bound_by": bound_by,
          "bound_share": bound_ms / kernel_ms,
          "ffma_bound_ms": ffma_bound_ms, "ffma_bound_by": ffma_bound_by,
          "bound_bytes": nbytes, "bound_flops": flops,
          "achieved_TFLOPs": flops / (kernel_ms * 1e-3) / 1e12,
          "achieved_GBs": nbytes / (kernel_ms * 1e-3) / 1e9,
          "ptxas": ptxas_report(_build.build_logs.get("ssd_scan", "")),
          "card": smi})
    del sets, other, x, dt, A, B, C
    torch.cuda.empty_cache()

    # ------------------------------------------------------- 12. ssm_train
    step_fn = tr.make_step()
    train = ssd_train_phase("ssm_train", SSM_TRAIN, model, state, step_fn,
                            data, smi)
    train_launches = train["ssd_scan_launches"]
    train_by_variant = train["ssd_scan_launches_by_variant"]

    # ----------------------------------------------- 13. ssm_train_profile
    ssd_train_profile("ssm_train_profile", state, step_fn, data, acts,
                      train["ms_per_step_wall"], 2 * cfg.n_layers, smi)

    # ------------------------------------------------------ 14. ssm_decode
    # the model in bf16 and its float32 twin on the same weights (bf16
    # widens to float32 exactly): in float32 the decode must continue the
    # prefill to the reference's 3e-2. In bf16 the 64 layers' roundings
    # (GEMMs of 2 x 1023 rows and of 2 rows round differently) move the
    # logits further than 3e-2, so there the decode's distance from its own
    # prefill is held to the bf16 prefill's distance from the float32 one,
    # plus 3e-2: no larger than what bf16 rounding alone does to the
    # prefill (PERF.md section 6)
    params = state["params"]
    del state
    torch.cuda.empty_cache()
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    params32 = tree_util.tree_map(lambda t: t.float(), params)
    toks = data.batch_at(300)["tokens"][:, :1024]

    def decode_vs_prefill(m, p):
        with torch.no_grad():
            full, _ = m.prefill(p, {"tokens": toks})
            _, states = m.prefill(p, {"tokens": toks[:, :1023]})
            lg, _ = m.decode_step(p, states, {"token": toks[:, 1023],
                                              "pos": torch.tensor(1023)})
        return full, lg

    before = sk.launches
    by_variant = dict(sk.launches_by_variant)
    full16, lg16 = decode_vs_prefill(model, params)
    full32, lg32 = decode_vs_prefill(model32, params32)
    torch.cuda.synchronize()
    prefill_launches = sk.launches - before
    prefill_by_variant = {k: v - by_variant[k]
                          for k, v in sk.launches_by_variant.items()}
    agree, readings = decode_readings(full16, lg16, full32, lg32)
    ok = (agree and prefill_launches == 4 * cfg.n_layers
          and prefill_by_variant == {"ffma": 2 * cfg.n_layers,
                                     "mma_sync": 2 * cfg.n_layers})
    emit({"phase": "ssm_decode", "arch": cfg.name, "batch": 2,
          "prefill_len": 1023, "full_len": 1024, **readings,
          "prefill_ssd_launches": prefill_launches,
          "prefill_ssd_launches_by_variant": prefill_by_variant,
          "ok": ok, "card": smi})
    if not ok:
        raise AssertionError(f"ssm decode disagrees with the full prefill: "
                             f"{readings} (launches {prefill_launches}, "
                             f"{prefill_by_variant})")
    del params, params32, full16, full32, lg16, lg32
    torch.cuda.empty_cache()
    return {"name": "ssd_scan", "route": "cuda", "source": SSD_SRC,
            "replaces": SSD_TPU_SRC, "launches": train_launches,
            "max_abs_err": max(r["max_err"] for r in results
                               if not r["case"].startswith("layer0")),
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "tol": "reference form: f32 rtol 1e-4 atol 1e-3, bf16 rtol 6e-2 "
                   f"atol 6e-1; bf16 against ssd_chunked_tc {SSD_TC_TIGHT} "
                   "of the largest value",
            "path": "ssm_train", "variant": variant,
            "launches_by_variant": train_by_variant,
            "ffma_ms": statistics.median(ffma_ms),
            "ffma_bound_ms": ffma_bound_ms,
            "launches_per_train_step": train_launches / SSM_TRAIN["steps"]}


def hybrid_ssd_checks(model, params, tokens) -> list[dict]:
    """ssd_scan at the hybrid's layer shape (h 80, p 64, d_state 64, chunk
    256), from the first Mamba-2 layer's real inputs on the train batch:
    mma_sync (the bf16 route) against ssd_chunked_tc and the float32
    chunked form, ffma (the float32 route) against the float32 form, at
    SSD_FULL_TOL, asserting the variant each ran."""
    from repro_torch import tree as tree_util
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_tc
    from repro_torch.models import ssm
    cfg = model.cfg
    chunk = cfg.ssm.chunk
    x, dt, A, B, C = layer_ssd_inputs(
        cfg, params["embed"],
        tree_util.tree_map(lambda t: t[0, 0], params["groups"]), tokens)
    wide = (x.float(), dt, A, B.float(), C.float())
    forms = {"tc": lambda: ssd_chunked_tc(x, dt, A, B, C, chunk),
             "float32": lambda: ssm.ssd_chunked(*wide, chunk)}
    results = []
    for variant, inputs, against in (("mma_sync", (x, dt, A, B, C),
                                      ("tc", "float32")),
                                     ("ffma", wide, ("float32",))):
        before = dict(sk.launches_by_variant)
        with torch.no_grad():
            y, st = ssm.ssd(*inputs, chunk)
        torch.cuda.synchronize()
        ran = {k: v - before[k] for k, v in sk.launches_by_variant.items()}
        for form in against:
            y_c, st_c = forms[form]()
            tol = SSD_FULL_TOL[(variant, form)]
            rel_y = ((y - y_c).abs().max() / y_c.abs().max()).item()
            rel_st = ((st - st_c).abs().max() / st_c.abs().max()).item()
            ok = (ran == {k: int(k == variant) for k in ran}
                  and max(rel_y, rel_st) <= tol)
            results.append({"case": f"hybrid-layer0-{variant}-vs-{form}",
                            "shape": list(x.shape) + [B.shape[-1]],
                            "chunk": chunk, "variant": variant, "ran": ran,
                            "max_err": (y - y_c).abs().max().item(),
                            "rel_err_y": rel_y, "rel_err_state": rel_st,
                            "tol": tol, "ok": ok})
            if not ok:
                emit({"phase": "hybrid_train", "ssd_checks": results})
                raise AssertionError(f"ssd_scan {variant} at the hybrid's "
                                     f"shape vs {form}: {rel_y}, {rel_st} > "
                                     f"{tol}, or ran {ran}")
            del y_c, st_c
    return results


def hybrid_phases(smi: str, acts) -> dict:
    """Phases 15-17 on full-width zamba2-2.7b (HybridLM); returns the
    hybrid's readings of ssd_scan and flash_decode for the kernels line."""
    from repro_torch import tree as tree_util
    from repro_torch.configs import get
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.kernels.flash_decode.ops import decode_attn
    from repro_torch.kernels.flash_decode.ref import decode_attention_ref
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan.ops import ssd_bound
    from repro_torch.models import HybridLM, build_model, ssm
    from repro_torch.models.attention import flash_attention
    from repro_torch.train.loop import Trainer
    from repro_torch.train.optimizer import AdamWConfig
    cfg = get("zamba2-2.7b")
    model = build_model(cfg)
    if not isinstance(model, HybridLM):
        raise AssertionError(f"build_model gave {type(model).__name__}")
    G = model.n_groups
    tr = Trainer(model, AdamWConfig(lr=HYBRID_TRAIN["lr"],
                                    warmup_steps=HYBRID_TRAIN["warmup"],
                                    decay_steps=HYBRID_TRAIN["steps"]),
                 device="cuda")
    t0 = time.perf_counter()
    state = tr.init_state(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    data = SyntheticTokens(cfg, batch=HYBRID_TRAIN["batch"],
                           seq=HYBRID_TRAIN["seq"], seed=0, device="cuda")

    # ---------------------------------------------------- 15. hybrid_train
    ssd_checks = hybrid_ssd_checks(model, state["params"],
                                   data.batch_at(0)["tokens"])
    step_fn = tr.make_step()
    train = ssd_train_phase("hybrid_train", HYBRID_TRAIN, model, state,
                            step_fn, data, smi, groups=G,
                            group_size=model.group_size, init_state_s=init_s,
                            ssd_checks=ssd_checks)
    ssd_entry = {"path": "hybrid_train",
                 "launches": train["ssd_scan_launches"],
                 "launches_per_train_step":
                     train["ssd_scan_launches"] / HYBRID_TRAIN["steps"],
                 "launches_by_variant": train["ssd_scan_launches_by_variant"],
                 "checks": ssd_checks}

    # -------------------------------------------- 16. hybrid_train_profile
    # the shared block's attention (plain flash_attention, 32 heads of 80)
    # timed alone at the step's shape: per use a forward, its recompute in
    # backward and the backward, times the G uses (wall, host included)
    B, S = HYBRID_TRAIN["batch"], HYBRID_TRAIN["seq"]
    hd = cfg.resolved_head_dim
    g = torch.Generator("cuda").manual_seed(71)
    qkv = [torch.randn((B, S, n, hd), device="cuda", generator=g)
           .bfloat16().requires_grad_(True)
           for n in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads)]
    dout = torch.randn((B, S, cfg.n_heads, hd), device="cuda",
                       generator=g).bfloat16()

    def attn_part():
        for _ in range(G):
            with torch.no_grad():
                flash_attention(*qkv, causal=True, q_chunk=cfg.q_chunk,
                                kv_chunk=cfg.kv_chunk)
            flash_attention(*qkv, causal=True, q_chunk=cfg.q_chunk,
                            kv_chunk=cfg.kv_chunk).backward(dout)

    attn_ms = time_eager_ms(attn_part, reps=2)
    del qkv, dout
    steady_ms = train["ms_per_step_wall"]
    _, _, nh, _ = ssm._dims(cfg)
    s_ = cfg.ssm
    bound_ms, bound_by = ssd_bound(B, S, nh, s_.head_dim, s_.d_state,
                                   s_.chunk, 2, "mma_sync")
    ssd_train_profile(
        "hybrid_train_profile", state, step_fn, data, acts, steady_ms,
        2 * cfg.n_layers, smi,
        ssd_scan_launch_shape={"b": B, "l": S, "h": nh, "p": s_.head_dim,
                               "n": s_.d_state, "chunk": s_.chunk},
        ssd_scan_launch_bound_ms=bound_ms, ssd_scan_launch_bound_by=bound_by,
        flash_attention_ms_per_step_alone=attn_ms,
        flash_attention_share_of_step=attn_ms / steady_ms,
        flash_attention_timed=f"{G} uses x (forward + recompute + "
                              f"backward), (B, S, H, hd) = ({B}, {S}, "
                              f"{cfg.n_heads}, {hd}) bf16, wall")

    # --------------------------------------------------- 17. hybrid_decode
    # prefill then decode against the full prefill, as ssm_decode; the
    # decode step runs the shared block once per group, each on its own KV
    # cache (copied from the shorter prefill into a 1024 window)
    params = state["params"]
    del state, train, step_fn, tr
    gc.collect()
    torch.cuda.empty_cache()
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    params32 = tree_util.tree_map(lambda t: t.float(), params)
    toks = data.batch_at(300)["tokens"][:, :1024]

    def decode_vs_prefill(m, p):
        with torch.no_grad():
            full, _ = m.prefill(p, {"tokens": toks})
            _, caches = m.prefill(p, {"tokens": toks[:, :1023]})
            cache = m.init_cache(2, 1024, device="cuda")
            for dst, src in zip(tree_util.leaves(cache["ssm"]),
                                tree_util.leaves(caches["ssm"])):
                dst.copy_(src)
            for name in ("k", "v"):
                cache["attn"][name][:, :, :1023] = caches["attn"][name]
            del caches
            before = fd.launches
            lg, _ = m.decode_step(p, cache, {"token": toks[:, 1023],
                                             "pos": torch.tensor(1023)})
            torch.cuda.synchronize()
        return full, lg, cache, fd.launches - before

    before = sk.launches
    by_variant = dict(sk.launches_by_variant)
    full16, lg16, cache16, fd16 = decode_vs_prefill(model, params)
    k0 = cache16["attn"]["k"][0].clone()
    v0 = cache16["attn"]["v"][0].clone()
    del cache16
    full32, lg32, cache32, fd32 = decode_vs_prefill(model32, params32)
    del cache32
    prefill_launches = sk.launches - before
    prefill_by_variant = {k: v - by_variant[k]
                          for k, v in sk.launches_by_variant.items()}
    agree, readings = decode_readings(full16, lg16, full32, lg32)
    # the kernel against its plain version on group 0's own bf16 cache,
    # one row at its full 1024 and one ragged
    lengths = torch.tensor([1024, 613], dtype=torch.int32, device="cuda")
    q0 = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, cfg.n_heads, hd), np.float32)).cuda().bfloat16()
    before_check = fd.launches
    got = decode_attn(q0, k0, v0, lengths)
    want = decode_attention_ref(q0, k0, v0, lengths)
    torch.cuda.synchronize()
    cache_reading = fd_reading(got, want)
    ok = (agree and fd16 == G and fd32 == G
          and fd.launches == before_check + 1 and cache_reading <= 1
          and prefill_launches == 4 * cfg.n_layers
          and prefill_by_variant == {"ffma": 2 * cfg.n_layers,
                                     "mma_sync": 2 * cfg.n_layers})
    line = {"phase": "hybrid_decode", "arch": cfg.name, "batch": 2,
            "prefill_len": 1023, "full_len": 1024, **readings,
            "flash_decode_launches_per_decode_step": {"bfloat16": fd16,
                                                      "float32": fd32},
            "expected_per_decode_step": f"{G} (one per group), (80, 80)",
            "prefill_ssd_launches": prefill_launches,
            "prefill_ssd_launches_by_variant": prefill_by_variant,
            "group0_cache_check": {
                "shape": [2, cfg.n_heads, cfg.n_kv_heads, hd, hd, 1024],
                "lengths": lengths.tolist(),
                "max_err": (got.float() - want.float()).abs().max().item(),
                "reading": cache_reading, "tol": FD_TOL_TEXT},
            "ok": ok, "card": smi}
    emit(line)
    if not ok:
        raise AssertionError(f"hybrid decode: {readings}; flash_decode "
                             f"{fd16} / {fd32} launches per decode_step "
                             f"(expected {G}), group-0 cache reading "
                             f"{cache_reading}; ssd_scan {prefill_by_variant}")
    del params, params32, full16, full32, lg16, lg32, k0, v0
    gc.collect()
    torch.cuda.empty_cache()
    return {"ssd_scan": ssd_entry,
            "flash_decode": {
                "path": "hybrid_decode", "launches": fd16 + fd32,
                "launches_per_decode_step": fd16, "head_dim": hd,
                "max_abs_err": line["group0_cache_check"]["max_err"],
                "reading": cache_reading}}


# ------------------------------------------------------------- MoE phases
def moe_profile_split(prof, steps: int, n_experts: int,
                      attr: str = "self_device_time_total") -> dict:
    """Device ms per step of the MoE train step's parts, from the profile's
    op tree (``record_shapes`` on; the step run with ``apply_moe`` and
    ``flash_attention`` inside ranges of their names). Each op's own kernel
    time goes to the first rule it meets, walking from the op up its
    ancestors: ``flash_attention`` (its range in forward and recompute, its
    ``_FlashBackward`` node); ``expert_bmm`` (an ``aten::bmm`` whose first
    input holds ``n_experts`` matrices: forward, recompute and backward);
    ``pack_unpack`` (index, index_put, gather, scatter, cumsum and one_hot
    ops inside the ``apply_moe`` range, and the ``IndexBackward0`` and
    ``IndexPutBackward0`` nodes, whose kernels are their adjoints; the
    embedding's gather backward is one of the latter); ``moe_other`` (the
    rest inside the range: router, sort, where, the activation, the
    combine's adds); ``other`` (everything else: projections, norms,
    lm_loss, the rest of the backward, AdamW). ``attr`` is the time read
    (device time; the CPU tests read CPU time)."""
    index_ops = ("aten::index", "aten::index_put", "aten::gather",
                 "aten::scatter", "aten::cumsum", "aten::one_hot")
    parts = dict.fromkeys(("flash_attention", "expert_bmm", "pack_unpack",
                           "moe_other", "other"), 0.0)

    def part_of(e) -> str:
        in_moe = False
        node = e
        while node is not None:
            name = node.name
            if name == "flash_attention" or name.endswith(": _FlashBackward"):
                return "flash_attention"
            if name == "aten::bmm" and node.input_shapes and \
                    node.input_shapes[0][:1] == [n_experts]:
                return "expert_bmm"
            if name == "moe.apply_moe":
                in_moe = True
                break
            if name.startswith("autograd::engine::evaluate_function: "):
                if name.endswith((": IndexBackward0", ": IndexPutBackward0")):
                    return "pack_unpack"
                return "other"
            node = node.cpu_parent
        if in_moe:
            node = e
            while node is not None and node.name != "moe.apply_moe":
                if node.name.startswith(index_ops):
                    return "pack_unpack"
                node = node.cpu_parent
            return "moe_other"
        return "other"

    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or \
                e.name in MOE_LABELS:
            continue                 # a range's own time is its span
        us = getattr(e, attr)
        if us > 0:
            parts[part_of(e)] += us / 1e3 / steps
    return parts


#: the profiler ranges the moe_train_profile phase puts around the MoE layer
#: and flash attention
MOE_LABELS = ("moe.apply_moe", "flash_attention")


def _labelled(fn, label: str):
    """``fn`` inside a profiler range named ``label``."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)
    return run


def logged_prefill(model, params, tokens):
    """``model.prefill`` with ``moe.drop_log`` on: (logits, caches, the
    slots each MoE layer's experts kept, in layer order)."""
    from repro_torch.models import moe
    moe.drop_log = []
    try:
        with torch.no_grad():
            lg, caches = model.prefill(params, {"tokens": tokens})
        log = moe.drop_log
    finally:
        moe.drop_log = None
    return lg, caches, [(routed, int(kept)) for routed, kept in log]


def moe_decode_vs_prefill(model, params, toks, n_moe: int):
    """Batch 1: the last logits of a prefill of ``toks`` (1, S) and of one
    ``decode_step`` of token S after a prefill of S - 1 (its caches copied
    into an S window). Returns (full logits, decode logits, the decode's
    caches, flash_decode launches of the decode_step, the last token's
    kept slots per MoE layer, whether either prefill dropped a slot). The
    last token's kept slots are kept(S) - kept(S-1): its own where tokens
    0..S-2 route alike in both prefills (float32; bf16 products round
    otherwise at the two shapes, and a route can flip at a near-tie)."""
    from repro_torch import tree as tree_util
    from repro_torch.kernels.flash_decode import kernel as fd
    S = toks.shape[1]
    full, _, log_full = logged_prefill(model, params, toks)
    _, caches, log_short = logged_prefill(model, params, toks[:, :S - 1])
    if len(log_full) != n_moe or len(log_short) != n_moe:
        raise AssertionError(f"{len(log_full)} / {len(log_short)} MoE layer "
                             f"calls in a prefill; expected {n_moe}")
    cache = model.init_cache(1, S, device=toks.device)
    for dst, src in zip(tree_util.leaves(cache), tree_util.leaves(caches)):
        dst[:, :, :S - 1] = src
    del caches
    before = fd.launches
    with torch.no_grad():
        lg, _ = model.decode_step(params, cache, {
            "token": toks[:, S - 1], "pos": torch.tensor(S - 1)})
    torch.cuda.synchronize()
    last_kept = [a - b for (_, a), (_, b) in zip(log_full, log_short)]
    any_drop = any(kept != routed for routed, kept in log_full + log_short)
    return full, lg, cache, fd.launches - before, last_kept, any_drop


def serve_profile(model, params, eng, pos0, acts, n_prof: int = 8) -> dict:
    """Where a ``decode_step``'s time goes: the engine's call on its cache
    at the mid-run positions ``pos0``, logits back to the host, ``n_prof``
    calls traced: device busy against wall, kernels and host ops."""
    batch = {"token": torch.zeros(eng.slots, dtype=torch.int32,
                                  device="cuda"),
             "pos": torch.from_numpy(pos0).cuda()}

    def one_step():
        with torch.no_grad():
            lg, _ = model.decode_step(params, eng.cache, batch)
        lg[:, 0].float().cpu()

    for _ in range(3):
        one_step()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            one_step()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    kernels = device_kernels(prof, n_prof)
    host = sorted(((e.key, e.self_cpu_time_total / 1e3 / n_prof,
                    e.count / n_prof) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda x: -x[1])
    del prof
    busy = sum(ms for _, ms, _ in kernels)
    step_ms = prof_wall / n_prof * 1e3
    return {"steps": n_prof, "ms_per_step_wall_profiled": step_ms,
            "device_busy_ms_per_step": busy,
            "idle_share": 1 - busy / step_ms,
            "kernels_per_step": sum(n_ for *_, n_ in kernels),
            "top": [[name[:80], ms, n_] for name, ms, n_ in kernels[:8]],
            "host_top_self_ms": [[name[:60], ms, n_]
                                 for name, ms, n_ in host[:10]]}


def _gather_cpu(t: torch.Tensor) -> list[torch.Tensor]:
    """Every rank's ``t`` (one shape on all ranks), in rank order, back on
    ``t``'s device: all_gather of its bytes through host memory."""
    import torch.distributed as dist
    b = t.detach().contiguous().cpu().view(torch.uint8)
    out = [torch.empty_like(b) for _ in range(dist.get_world_size())]
    dist.all_gather(out, b)
    return [o.view(t.dtype).to(t.device) for o in out]


def ep_planted(moe, p, xs, cfg, want) -> dict:
    """Pod 0's data group run as ``moe.emulate_ep`` runs it, with a fault
    planted in its exchange (MOE_EP_FAULTS), against ``want`` (emulate_ep
    on ``xs``, the four ranks' rows): per fault, whether the two are equal
    bit for bit and max|got - want| / max|want|. The exchange is a
    transpose of the (ranks, ep, cap, ...) buffers, as in emulate_ep."""
    B, S, d = xs.shape
    xt = xs.reshape(2, 2, -1, d)[0]             # pod 0: ranks 0 and 1
    want0 = want[:B // 2].reshape(xt.shape)

    def swapped(t):          # each rank's two received blocks change places
        return t.transpose(0, 1).flip(1).contiguous()

    def dropped(t):          # the first slot rank 1 sends rank 0 arrives
        t = t.transpose(0, 1).contiguous()     # marked empty (metadata 0)
        if t.dtype == torch.int64:
            t[0, 1, 0] = 0
        return t

    out = {}
    for name, fn in zip(MOE_EP_FAULTS, (swapped, dropped)):
        y = moe._moe_body(xt, p["router"], p["w_gate"], p["w_up"],
                          p["w_out"], cfg, fn)
        err = (y.float() - want0.float()).abs().max().item()
        out[name] = {"bitwise_equal": bool(torch.equal(y, want0)),
                     "rel_err": err / want0.float().abs().max().item()}
    return out


def moe_ep_worker(rank: int, port: int, out_dir: str) -> None:
    """One rank of the moe_ep phase (run by torch.multiprocessing, spawn)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    from repro_torch import tree as tree_util
    from repro_torch.configs import get
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels.allreduce_combine import kernel as ck
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model, moe
    from repro_torch.models.layers import apply_norm, embed_tokens
    from repro_torch.parallel.ctx import make_parallel_ctx
    from repro_torch.parallel.grad_sync import (combine_launches_per_sync,
                                                plan_buckets)
    from repro_torch.train.loop import Trainer
    from repro_torch.train.optimizer import AdamWConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    world = MOE_EP["world"]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=600))
    try:
        mesh = make_mesh(MOE_EP["mesh"], ("pod", "data"), device=dev)
        pctx = make_parallel_ctx(mesh)
        cfg = dataclasses.replace(get("granite-moe-1b-a400m"),
                                  n_layers=MOE_EP["n_layers"])
        model = build_model(cfg)
        tr = Trainer(model, AdamWConfig(lr=6e-4, warmup_steps=1,
                                        decay_steps=10),
                     pctx=pctx, mesh=mesh, device=dev)
        state = tr.init_state(torch.Generator().manual_seed(0))
        data = SyntheticTokens(cfg, batch=MOE_EP["global_batch"],
                               seq=MOE_EP["seq"], device=dev)
        per = MOE_EP["global_batch"] // world

        def local(i):
            return {k: v[rank * per:(rank + 1) * per]
                    for k, v in data.batch_at(i).items()}

        rec: dict = {"rank": rank, "coords": mesh.coords,
                     "ep_size": moe.ep_size(pctx, cfg), "checks": {},
                     "steps": {}}
        # (a), (b): layer 0's MoE layer on its normed input
        layer0 = tree_util.tree_map(lambda t: t[0],
                                    state["params"]["moe_stack"])
        x = apply_norm(layer0["ln2"], embed_tokens(
            state["params"]["embed"], local(0)["tokens"], cfg), cfg)
        xs = torch.cat(_gather_cpu(x))
        for label, quant in (("exact", False), ("int8", True)):
            c = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, a2a_quant=quant))
            with torch.no_grad():
                moe.apply_moe(layer0["ffn"], x, c, pctx)       # warm-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                y = moe.apply_moe(layer0["ffn"], x, c, pctx)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                ys = torch.cat(_gather_cpu(y))
                if rank == 0:
                    want = moe.emulate_ep(layer0["ffn"], xs, c, ep=2, pods=2)
                    err = (ys.float() - want.float()).abs().max().item()
                    rel = err / want.float().abs().max().item()
                    planted = ep_planted(moe, layer0["ffn"], xs, c, want)
                    tok = x.shape[0] * x.shape[1]
                    cap = max(1, math.ceil(tok * c.moe.top_k / 2
                                           * c.moe.capacity_factor))
                    slot = c.d_model * (1 if quant else 2) + (4 if quant
                                                              else 0)
                    equal = bool(torch.equal(ys, want))
                    rec["checks"][label] = {
                        "max_abs_err": err, "rel_err": rel,
                        "bitwise_equal": equal, "planted": planted,
                        "ok": bool(equal and not any(
                            f["bitwise_equal"] for f in planted.values())),
                        "layer_wall_ms_rank0": wall * 1e3,
                        "wire_bytes_per_layer_forward_rank0":
                            2 * 2 * cap * slot}
        del xs
        # (c): two Trainer steps with EP, the default "auto" sync
        plan = plan_buckets(state["params"], mesh)
        want_launches = combine_launches_per_sync(mesh, plan)
        rec["plan"] = dict(collections.Counter(plan))
        step = tr.make_step()
        for i in range(MOE_EP["steps"]):
            torch.cuda.synchronize()
            ck.launches = 0
            t0 = time.perf_counter()
            state, m = step(state, local(i))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = ck.launches
            losses = [None] * world
            dist.all_gather_object(losses, float(m["loss"]))
            digests = [None] * world
            dist.all_gather_object(digests, _digest(state["params"]))
            rec["steps"][str(i)] = {
                "combine_launches": launches, "expected": want_launches,
                "losses": losses, "wall_s": wall,
                "params_equal_across_ranks": len(set(digests)) == 1}
        (Path(out_dir) / f"moe_ep_rank{rank}.json").write_text(json.dumps(rec))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def moe_phases(smi: str, acts) -> dict:
    """Phases 18-22 on full-width granite-moe-1b-a400m (LM with 24 MoE
    layers); returns its readings of flash_decode and combine for the
    kernels line."""
    from repro_torch import tree as tree_util
    from repro_torch.configs import get
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels.allreduce_combine import kernel as ck
    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.kernels.flash_decode.ops import decode_attn
    from repro_torch.kernels.flash_decode.ref import decode_attention_ref
    from repro_torch.models import LM, build_model, moe
    from repro_torch.models import attention as attn_mod
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train.loop import Trainer
    from repro_torch.train.optimizer import AdamWConfig
    cfg = get("granite-moe-1b-a400m")
    model = build_model(cfg)
    if not isinstance(model, LM):
        raise AssertionError(f"granite: build_model gave "
                             f"{type(model).__name__}")
    L, k = cfg.n_layers, cfg.moe.top_k
    mt = MOE_TRAIN
    tr = Trainer(model, AdamWConfig(lr=mt["lr"], warmup_steps=mt["warmup"],
                                    decay_steps=mt["steps"]), device="cuda")
    t0 = time.perf_counter()
    state = tr.init_state(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_util.leaves(state["params"]))
    data = SyntheticTokens(cfg, batch=mt["batch"], seq=mt["seq"], seed=0,
                           device="cuda")
    held = [data.batch_at(i) for i in range(*mt["eval_steps"])]

    def held_loss(params):
        with torch.no_grad():
            return [float(model.loss_fn(params, b)) for b in held]

    # ------------------------------------------------------ 18. moe_train
    held_before = held_loss(state["params"])
    step_fn = tr.make_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fd.launches = 0
    losses, walls, dropped = [], [], {}
    t_run = time.perf_counter()
    for i in range(mt["steps"]):
        record = i in (0, mt["steps"] - 1)
        if record:
            moe.drop_log = []
        t = time.perf_counter()
        new, metrics = step_fn(state, data.batch_at(i))
        state.update(new)
        del new
        losses.append(float(metrics["loss"]))       # waits for the step
        walls.append(time.perf_counter() - t)
        if record:
            log, moe.drop_log = moe.drop_log, None
            if len(log) != 2 * L:
                raise AssertionError(f"{len(log)} MoE layer calls in a "
                                     f"step; expected {L} x (forward + "
                                     "recompute)")
            # the forward, layer by layer (the recompute follows in reverse)
            dropped[i] = [1 - int(kept) / routed for routed, kept in log[:L]]
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    train_fd = fd.launches
    peak_bytes = torch.cuda.max_memory_allocated()
    peak_gb = peak_bytes / 1e9
    held_after = held_loss(state["params"])
    drop = float(np.mean(held_before) - np.mean(held_after))
    steady_ms = float(np.mean(walls[1:])) * 1e3
    tokens = mt["batch"] * mt["seq"]
    first, last = min(dropped), max(dropped)
    emit({"phase": "moe_train", "arch": cfg.name, "dtype": cfg.dtype,
          "params": n_params, "entry": "Trainer.make_step", **mt,
          "experts": cfg.moe.n_experts, "top_k": k,
          "losses": losses,
          "first5_mean": float(np.mean(losses[:5])),
          "last5_mean": float(np.mean(losses[-5:])),
          "held_out_losses_before": held_before,
          "held_out_losses_after": held_after, "held_out_mean_drop": drop,
          "threshold": f"held_out_mean_drop >= {mt['min_drop']}",
          "wall_s": run_s, "init_state_s": init_s,
          "step_wall_ms": [w * 1e3 for w in walls],
          "ms_per_step_wall": steady_ms,
          "tok_per_s": tokens / (steady_ms / 1e3), "peak_mem_GB": peak_gb,
          "dropped_share_per_layer": {f"step{first}": dropped[first],
                                      f"step{last}": dropped[last]},
          "dropped_share_mean": {f"step{first}": float(np.mean(
              dropped[first])), f"step{last}": float(np.mean(dropped[last]))},
          "flash_decode_launches": train_fd, "card": smi})
    if train_fd:
        raise AssertionError(f"flash_decode launched {train_fd} times in "
                             "training")
    if not all(np.isfinite(losses + held_before + held_after)):
        raise AssertionError(f"a moe_train loss is not finite: {losses}, "
                             f"held-out {held_before} -> {held_after}")
    if not drop >= mt["min_drop"]:
        raise AssertionError(f"the moe_train loss did not fall: held-out "
                             f"batches {held_before} -> {held_after}")

    # ---------------------------------------------- 19. moe_train_profile
    n_prof = 1
    saved = moe.apply_moe, attn_mod.flash_attention
    moe.apply_moe = _labelled(saved[0], "moe.apply_moe")
    attn_mod.flash_attention = _labelled(saved[1], "flash_attention")
    try:
        with torch.profiler.profile(activities=acts,
                                    record_shapes=True) as prof:
            t0 = time.perf_counter()
            for i in range(n_prof):
                state.update(step_fn(state, data.batch_at(100 + i))[0])
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
    finally:
        moe.apply_moe, attn_mod.flash_attention = saved
    kernels = device_kernels(prof, n_prof, skip=MOE_LABELS)
    split = moe_profile_split(prof, n_prof, cfg.moe.n_experts)
    del prof
    busy = sum(ms for _, ms, _ in kernels)
    wall_ms = prof_wall / n_prof * 1e3
    emit({"phase": "moe_train_profile", "steps": n_prof,
          "ms_per_step_wall_profiled": wall_ms,
          "device_busy_ms_per_step": busy, "idle_share": 1 - busy / wall_ms,
          "idle_share_vs_unprofiled_wall": 1 - busy / steady_ms,
          "kernels_per_step": sum(n_ for *_, n_ in kernels),
          "split_ms_per_step": split,
          "split_share_of_busy": {p: ms / busy for p, ms in split.items()},
          "split_attributed_ms": sum(split.values()),
          "split_rules": "moe_profile_split's docstring",
          "top": [[name[:80], ms, n_] for name, ms, n_ in kernels[:15]],
          "card": smi})

    # ---------------------------------------------------- 20. moe_decode
    # batch 1: prefill(S-1) then decode equals prefill(S) when both
    # prefills give the experts the same capacity (MOE_DECODE_LEN) and
    # prefill(S) kept every slot of the last token; the two prefills' kept
    # counts (moe.drop_log) tell whether it did
    params = state["params"]
    del state, step_fn, tr, held
    gc.collect()
    torch.cuda.empty_cache()
    S = MOE_DECODE_LEN
    toks = data.batch_at(300)["tokens"][:1, :S]
    params32 = tree_util.tree_map(lambda t: t.float(), params)

    cf_runs, layer0 = {}, None
    for cf in (cfg.moe.capacity_factor, MOE_DECODE_NO_DROP_CF):
        c16 = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
        c32 = dataclasses.replace(c16, dtype="float32")
        full16, lg16, cache16, fd16, kept16, any16 = moe_decode_vs_prefill(
            build_model(c16), params, toks, L)
        if layer0 is None:
            layer0 = (cache16["moe"]["k"][0].clone(),
                      cache16["moe"]["v"][0].clone())
        del cache16
        full32, lg32, cache32, fd32, kept32, any32 = moe_decode_vs_prefill(
            build_model(c32), params32, toks, L)
        del cache32
        agree, readings = decode_readings(full16, lg16, full32, lg32)
        dropped = any(n != k for n in kept16 + kept32)
        cf_runs[str(cf)] = {
            "decode_agrees": agree, **readings,
            "last_token_dropped": dropped,
            "last_token_slots_kept_per_layer": {"bfloat16": kept16,
                                                "float32": kept32},
            "a_prefill_dropped_a_slot": {"bfloat16": any16,
                                         "float32": any32},
            "flash_decode_launches_per_decode_step": {"bfloat16": fd16,
                                                      "float32": fd32},
            "ok": bool((agree or dropped)
                       and fd16 == L and fd32 == L
                       and torch.isfinite(lg16).all().item()
                       and torch.isfinite(lg32).all().item())}
        del full16, full32, lg16, lg32
    del params32
    # the kernel against its plain version on layer 0's own bf16 cache, the
    # row at its full length and again ragged
    kk, vv = (torch.cat([t, t]) for t in layer0)
    lengths = torch.tensor([S, 317], dtype=torch.int32, device="cuda")
    hd = cfg.resolved_head_dim
    q0 = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, cfg.n_heads, hd), np.float32)).cuda().bfloat16()
    before_check = fd.launches
    got = decode_attn(q0, kk, vv, lengths)
    want = decode_attention_ref(q0, kk, vv, lengths)
    torch.cuda.synchronize()
    cache_reading = fd_reading(got, want)
    no_drop = cf_runs[str(MOE_DECODE_NO_DROP_CF)]
    ok = (all(r["ok"] for r in cf_runs.values())
          and not any(no_drop["a_prefill_dropped_a_slot"].values())
          and not no_drop["last_token_dropped"] and no_drop["decode_agrees"]
          and fd.launches == before_check + 1 and cache_reading <= 1)
    fd_decode = sum(sum(r["flash_decode_launches_per_decode_step"].values())
                    for r in cf_runs.values())
    line = {"phase": "moe_decode", "arch": cfg.name, "batch": 1,
            "prefill_len": S - 1, "full_len": S,
            "by_capacity_factor": cf_runs,
            "gate": "decode_agrees (as ssm_decode) unless the full prefill "
                    "dropped a slot of the last token (kept(S) - kept(S-1) "
                    "< top_k in a layer); at capacity factor "
                    f"{MOE_DECODE_NO_DROP_CF} no expert can fill: neither "
                    "prefill may drop a slot, and decode must agree",
            "expected_per_decode_step": f"{L} (one per layer), (64, 64)",
            "layer0_cache_check": {
                "shape": [2, cfg.n_heads, cfg.n_kv_heads, hd, hd, S],
                "lengths": lengths.tolist(),
                "max_err": (got.float() - want.float()).abs().max().item(),
                "reading": cache_reading, "tol": FD_TOL_TEXT},
            "ok": ok, "card": smi}
    emit(line)
    if not ok:
        raise AssertionError(f"moe decode: {cf_runs}; layer-0 cache "
                             f"reading {cache_reading}")
    del kk, vv, layer0

    # ----------------------------------------------------- 21. moe_serve
    # the first MOE_SERVE_LAYERS trained layers at full width
    Ls = MOE_SERVE_LAYERS
    scfg = dataclasses.replace(cfg, n_layers=Ls)
    smodel = build_model(scfg)
    sparams = dict(params, moe_stack=tree_util.tree_map(
        lambda t: t[:Ls], params["moe_stack"]))
    warm = ServeEngine(smodel, sparams, slots=2, window=64, device="cuda")
    warm.submit([1, 2, 3], max_new_tokens=2)
    warm.run_until_idle()
    del warm
    eng = ServeEngine(smodel, sparams, slots=8, window=2048, device="cuda")
    rng = np.random.default_rng(0)
    lo, hi = MOE_SERVE_PROMPTS
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(lo, hi + 1, 16)]
    torch.cuda.synchronize()
    fd.launches = 0
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=32) for p in prompts]
    eng.run_until_idle(max_steps=16)          # mid-decode of the first wave
    k0 = eng.cache["moe"]["k"][0].clone()
    v0 = eng.cache["moe"]["v"][0].clone()
    pos0 = eng.pos.copy()
    eng.run_until_idle(max_steps=100000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    serve_fd, calls = fd.launches, eng.decode_calls
    outs = [eng.result(r) for r in rids]
    done = sum(o is not None and len(o) == 32 for o in outs)
    n_tok = sum(len(o or []) for o in outs)
    prompt_tok = sum(len(p) for p in prompts)
    # the kernel against its plain version at the shape the engine gives
    # it: layer 0's cache (8, 2048, 8, 64) mid-run, group size 2, the
    # engine's ragged lengths
    lens0 = torch.from_numpy(
        np.minimum(pos0 + 1, 2048).astype(np.int32)).cuda()
    q_serve = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8, cfg.n_heads, hd), np.float32)).cuda().bfloat16()
    got = decode_attn(q_serve, k0, v0, lens0)
    want = decode_attention_ref(q_serve, k0, v0, lens0)
    serve_check = {"shape": [8, cfg.n_heads, cfg.n_kv_heads, hd, hd, 2048],
                   "lengths": lens0.cpu().tolist(),
                   "max_err": (got.float() - want.float()).abs().max().item(),
                   "reading": fd_reading(got, want), "tol": FD_TOL_TEXT}
    del k0, v0, got, want
    step_profile = serve_profile(smodel, sparams, eng, pos0, acts)
    emit({"phase": "moe_serve", "arch": cfg.name, "dtype": cfg.dtype,
          "reduced": f"n_layers={Ls} (full width; the first {Ls} of the "
                     f"{L} trained layers)",
          "weights": "after moe_train's 20 steps and the profile's",
          "slots": 8, "window": 2048,
          "requests": 16, "done": done, "prompt_tokens": prompt_tok,
          "new_tokens": n_tok, "decode_step_calls": calls,
          "flash_decode_launches": serve_fd, "wall_s": wall,
          "ms_per_decode_step": wall / calls * 1e3,
          "tok_per_s": (prompt_tok + n_tok) / wall,
          "new_tok_per_s": n_tok / wall,
          "engine_cache_check": serve_check,
          "first_tokens": outs[0][:8] if outs[0] else None,
          "decode_step_profile": step_profile, "card": smi})
    if done != 16:
        raise AssertionError(f"moe_serve: served {done}/16 requests")
    if not all(0 <= t < cfg.vocab_size for o in outs for t in o):
        raise AssertionError("moe_serve: a token lies outside the vocabulary")
    if serve_fd != Ls * calls or calls == 0:
        raise AssertionError(f"moe_serve: flash_decode launched {serve_fd} "
                             f"times over {calls} decode_step calls; "
                             f"expected {Ls} per call")
    if not serve_check["reading"] <= 1:
        raise AssertionError(f"moe_serve: flash_decode on the engine's cache: "
                             f"reading {serve_check['reading']} > 1 "
                             f"({FD_TOL_TEXT})")
    del eng, params, model, sparams, smodel
    gc.collect()
    torch.cuda.empty_cache()

    # -------------------------------------------------------- 22. moe_ep
    for f in OUT.glob("moe_ep_rank*.json"):
        f.unlink()
    t0 = time.perf_counter()
    torch.multiprocessing.start_processes(
        moe_ep_worker, args=(free_port(), str(OUT)), nprocs=MOE_EP["world"],
        join=True, start_method="spawn")
    ep_wall = time.perf_counter() - t0
    ranks = [json.loads((OUT / f"moe_ep_rank{r}.json").read_text())
             for r in range(MOE_EP["world"])]
    r0 = ranks[0]
    ep_launches = sum(s["combine_launches"] for s in r0["steps"].values())
    emit({"phase": "moe_ep", "arch": cfg.name,
          "reduced": f"n_layers={MOE_EP['n_layers']} (full width)",
          "mesh": {"pod": 2, "data": 2}, "backend": "gloo",
          "device_per_rank": "cuda:0",
          "transport": "all_to_all stages CUDA tensors through host memory "
                       "explicitly (moe.all_to_all), as bytes; the "
                       "gradient sync as the dp phase's",
          "global_batch": MOE_EP["global_batch"], "seq": MOE_EP["seq"],
          "ep_size": [r["ep_size"] for r in ranks],
          "coords": [r["coords"] for r in ranks],
          "emulation_checks": r0["checks"], "plan": r0["plan"],
          "steps": {r["rank"]: r["steps"] for r in ranks},
          "combine_launches_rank0": ep_launches, "wall_s": ep_wall,
          "card": smi})
    bad = [label for label, c in r0["checks"].items() if not c["ok"]]
    if bad or sorted(r0["checks"]) != ["exact", "int8"]:
        raise AssertionError(f"moe_ep: EP against emulate_ep failed {bad}: "
                             f"{r0['checks']}")
    if any(r["ep_size"] != 2 for r in ranks):
        raise AssertionError("moe_ep: a rank did not run EP over data")
    for r in ranks:
        for i, s in r["steps"].items():
            if s["combine_launches"] != s["expected"]:
                raise AssertionError(f"moe_ep rank {r['rank']} step {i}: "
                                     f"{s['combine_launches']} combine "
                                     f"launches, expected {s['expected']}")
            if not s["params_equal_across_ranks"]:
                raise AssertionError(f"moe_ep step {i}: parameters differ "
                                     "across ranks")
            if not all(np.isfinite(s["losses"])):
                raise AssertionError(f"moe_ep step {i}: losses {s['losses']}")
    if ep_launches == 0:
        raise AssertionError("combine never launched on the moe_ep path")
    return {"flash_decode": {
                "path": "moe_serve", "launches": serve_fd,
                "launches_per_decode_step": serve_fd / calls,
                "decode_check_launches": fd_decode,
                "max_abs_err": serve_check["max_err"],
                "reading": serve_check["reading"],
                "checked_on": "moe_serve's layer-0 cache, "
                              f"lengths {serve_check['lengths']}",
                "moe_decode_check": {
                    "max_abs_err": line["layer0_cache_check"]["max_err"],
                    "reading": cache_reading}},
            "combine": {"path": "moe_ep (rank 0)", "launches": ep_launches,
                        "launches_per_synced_step":
                            ep_launches / MOE_EP["steps"]}}


def ds_configs():
    """(serving config, training config) of deepseek-v3-671b at full width
    (DS_SERVE_CUT, DS_TRAIN_EXPERTS)."""
    from repro_torch.configs import get
    cfg = dataclasses.replace(get("deepseek-v3-671b"), **DS_SERVE_CUT)
    train = dataclasses.replace(cfg, mtp_depth=1, moe=dataclasses.replace(
        cfg.moe, n_experts=DS_TRAIN_EXPERTS))
    return cfg, train


def ds_train_peak_gb(model, opt_cfg, donate: bool) -> float:
    """The train step's reckoned peak in GB from the meta tree: parameters,
    gradients (the parameters' dtype) and optimizer state live through the
    step; the functional update also holds new parameters and state beside
    the old until it returns, with ~5 float32 copies of the leaf it works
    on, a donated one ~3 (``adamw_update``'s temporaries). Activations are
    left out (each trunk layer is recomputed in backward)."""
    from repro_torch import tree as tree_util
    from repro_torch.train.optimizer import adamw_init
    params = model.init(torch.Generator(), device="meta")

    def nbytes(tree):
        return sum(t.numel() * t.element_size()
                   for t in tree_util.leaves(tree))

    p_b, o_b = nbytes(params), nbytes(adamw_init(params, opt_cfg))
    leaf_b = 4 * max(t.numel() for t in tree_util.leaves(params))
    if donate:
        return (2 * p_b + o_b + 3 * leaf_b) / 1e9
    return (3 * p_b + 2 * o_b + 5 * leaf_b) / 1e9


#: the profiler ranges ds_train_profile puts around flash attention, the MoE
#: layer and the MTP loss, innermost first
DS_LABELS = ("flash_attention", "moe.apply_moe", "mtp")


def ds_profile_split(prof, steps: int,
                     attr: str = "self_device_time_total") -> dict:
    """Device ms per step of the deepseek train step in four parts: MLA's
    ``flash_attention``, the MoE layers (the trunk's and the MTP block's),
    the MTP block's other ops (its projection, norms, MLA projections and
    its loss) and everything else. An op's own kernel time goes to the
    innermost of the ranges DS_LABELS it runs in (forward, and the
    recompute of checkpointed layers); a backward node goes where the
    forward op that made it ran, matched by (thread, sequence number), as
    the profiler records both. ``attr`` is the time read (device time; a
    CPU rehearsal reads CPU time)."""
    cpu = torch.autograd.DeviceType.CPU
    parts = {"flash_attention": 0.0, "moe": 0.0, "mtp_other": 0.0,
             "other": 0.0}
    names = {"flash_attention": "flash_attention", "moe.apply_moe": "moe",
             "mtp": "mtp_other"}

    def in_range(e):
        node = e
        while node is not None:
            if node.name in DS_LABELS:
                return names[node.name]
            node = node.cpu_parent
        return None

    events = [e for e in prof.events() if e.device_type == cpu]
    made_in = {}
    for e in events:
        if e.sequence_nr >= 0 and "Backward" not in e.name \
                and not e.name.startswith("autograd::"):
            part = in_range(e)
            if part is not None:
                made_in.setdefault((e.thread, e.sequence_nr), part)

    def part_of(e):
        node = e
        while node is not None:
            if node.name in DS_LABELS:
                return names[node.name]
            if "Backward" in node.name and node.sequence_nr >= 0:
                fwd = getattr(node, "fwd_thread", None)
                key = (node.thread if fwd is None else fwd, node.sequence_nr)
                return made_in.get(key, "other")
            node = node.cpu_parent
        return "other"

    for e in events:
        if e.name in DS_LABELS:
            continue                 # a range's own time is its span
        us = getattr(e, attr)
        if us > 0:
            parts[part_of(e)] += us / 1e3 / steps
    return parts


def _widen_(tree: dict, slots: list | None = None) -> list:
    """Every bf16 leaf of ``tree`` widened to float32 in place, one leaf at
    a time (the old copy of one leaf at most lives beside the new tree);
    returns the (dict, key) slots it changed, for :func:`_narrow_`."""
    slots = [] if slots is None else slots
    for key, val in tree.items():
        if isinstance(val, dict):
            _widen_(val, slots)
        elif val is not None and val.dtype == torch.bfloat16:
            tree[key] = val.float()
            slots.append((tree, key))
            del val
    return slots


def _narrow_(slots: list) -> None:
    """Undo :func:`_widen_`: the widened leaves back to bf16, exactly."""
    for tree, key in slots:
        tree[key] = tree[key].bfloat16()


def ds_phases(smi: str, acts) -> dict:
    """Phases 23-27 on full-width deepseek-v3-671b, cut in depth
    (ds_configs); returns the deepseek path's launches of every kernel for
    the kernels line (all 0: MLA's decode is float32 einsums, as in the
    reference)."""
    from repro_torch import tree as tree_util
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels.allreduce_combine import kernel as ck
    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.kernels.matmul_tile import kernel as mk
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.models import LM, build_model, moe
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.layers import apply_norm, embed_tokens
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train.loop import Trainer
    from repro_torch.train.optimizer import AdamWConfig
    dev = "cuda"
    kmods = {"flash_decode": fd, "allreduce_combine": ck, "ssd_scan": sk,
             "matmul_tile": mk}
    for m in kmods.values():
        m.launches = 0
    cfg, tcfg = ds_configs()
    model, tmodel = build_model(cfg), build_model(tcfg)
    if not isinstance(model, LM):
        raise AssertionError(f"deepseek: build_model gave "
                             f"{type(model).__name__}")

    def gen():
        return torch.Generator(dev).manual_seed(0)

    # ------------------------------------------------------- 23. ds_train
    dt_ = DS_TRAIN
    opt_cfg = AdamWConfig(lr=dt_["lr"], warmup_steps=dt_["warmup"],
                          decay_steps=dt_["steps"])
    reckoned = {"donated": ds_train_peak_gb(tmodel, opt_cfg, True),
                "functional": ds_train_peak_gb(tmodel, opt_cfg, False)}
    if reckoned["donated"] >= DS_PEAK_LIMIT_GB:
        raise AssertionError(f"ds_train: reckoned peak {reckoned} GB")
    tr = Trainer(tmodel, opt_cfg, device=dev, donate=True)
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    state = tr.init_state(gen())
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_util.leaves(state["params"]))
    data = SyntheticTokens(tcfg, batch=dt_["batch"], seq=dt_["seq"], seed=0,
                           device=dev)
    held = [data.batch_at(i) for i in range(*dt_["eval_steps"])]

    def held_loss(params):
        with torch.no_grad():
            return [float(tmodel.loss_fn(params, b)) for b in held]

    mtp_seen = []
    mtp_orig = LM._mtp_loss

    def mtp_recorded(self, *args, **kwargs):
        out = mtp_orig(self, *args, **kwargs)
        mtp_seen.append(out.detach())
        return out

    held_before = held_loss(state["params"])
    step_fn = tr.make_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fd.launches = 0
    losses, main_l, mtp_l, walls, dropped = [], [], [], [], {}
    n_moe = tcfg.n_layers - tcfg.n_dense_layers + tcfg.mtp_depth
    LM._mtp_loss = mtp_recorded
    try:
        t_run = time.perf_counter()
        for i in range(dt_["steps"]):
            record = i in (0, dt_["steps"] - 1)
            if record:
                moe.drop_log = []
            mtp_seen.clear()
            t = time.perf_counter()
            new, metrics = step_fn(state, data.batch_at(i))
            state.update(new)
            del new
            losses.append(float(metrics["loss"]))     # waits for the step
            walls.append(time.perf_counter() - t)
            mtp_l.append(float(mtp_seen[0]))
            main_l.append(losses[-1] - 0.3 * mtp_l[-1])
            if record:
                log, moe.drop_log = moe.drop_log, None
                # forward: the trunk's MoE layer, then the MTP block's; the
                # trunk's recompute follows in backward
                if len(log) != n_moe + 1:
                    raise AssertionError(f"{len(log)} MoE layer calls in a "
                                         "step; expected the trunk's "
                                         "forward and recompute and the "
                                         "MTP block's forward")
                dropped[i] = [1 - int(kept) / routed
                              for routed, kept in log[:n_moe]]
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run
    finally:
        LM._mtp_loss = mtp_orig
        moe.drop_log = None
    train_fd = fd.launches
    peak_bytes = torch.cuda.max_memory_allocated()
    peak_gb = peak_bytes / 1e9
    held_after = held_loss(state["params"])
    drop = float(np.mean(held_before) - np.mean(held_after))
    steady_ms = float(np.mean(walls[1:])) * 1e3
    tokens = dt_["batch"] * dt_["seq"]
    first, last = min(dropped), max(dropped)
    emit({"phase": "ds_train", "arch": tcfg.name, "dtype": tcfg.dtype,
          "reduced": "n_layers=2 (1 dense, 1 MoE), mtp_depth=1, "
                     f"n_experts={DS_TRAIN_EXPERTS} (full width)",
          "params": n_params, "entry": "Trainer.make_step", **dt_,
          "optimizer": "AdamW, float32 moments, donated step",
          "reckoned_peak_GB": reckoned, "experts": tcfg.moe.n_experts,
          "top_k": tcfg.moe.top_k, "losses": losses, "main_losses": main_l,
          "mtp_losses": mtp_l,
          "held_out_losses_before": held_before,
          "held_out_losses_after": held_after, "held_out_mean_drop": drop,
          "threshold": f"held_out_mean_drop >= {dt_['min_drop']}",
          "wall_s": run_s, "init_state_s": init_s,
          "step_wall_ms": [w * 1e3 for w in walls],
          "ms_per_step_wall": steady_ms,
          "tok_per_s": tokens / (steady_ms / 1e3), "peak_mem_GB": peak_gb,
          "dropped_share_per_moe_layer": {
              "layers": ["moe_stack.0", "mtp.block"],
              f"step{first}": dropped[first], f"step{last}": dropped[last]},
          "flash_decode_launches": train_fd, "card": smi})
    if train_fd:
        raise AssertionError(f"flash_decode launched {train_fd} times in "
                             "ds_train")
    if not all(np.isfinite(main_l + mtp_l + held_before + held_after)):
        raise AssertionError(f"a ds_train loss is not finite: main {main_l},"
                             f" mtp {mtp_l}, held-out {held_before} -> "
                             f"{held_after}")
    if not drop >= dt_["min_drop"]:
        raise AssertionError(f"the ds_train loss did not fall: held-out "
                             f"batches {held_before} -> {held_after}")

    # ----------------------------------------------- 24. ds_train_profile
    n_prof = 1
    saved = moe.apply_moe, attn_mod.flash_attention
    moe.apply_moe = _labelled(saved[0], "moe.apply_moe")
    attn_mod.flash_attention = _labelled(saved[1], "flash_attention")
    LM._mtp_loss = _labelled(mtp_orig, "mtp")
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(n_prof):
                state.update(step_fn(state, data.batch_at(100 + i))[0])
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
    finally:
        moe.apply_moe, attn_mod.flash_attention = saved
        LM._mtp_loss = mtp_orig
    split = ds_profile_split(prof, n_prof)
    kernels = device_kernels(prof, n_prof, skip=DS_LABELS)
    del prof
    busy = sum(ms for _, ms, _ in kernels)
    wall_ms = prof_wall / n_prof * 1e3
    emit({"phase": "ds_train_profile", "steps": n_prof,
          "ms_per_step_wall_profiled": wall_ms,
          "device_busy_ms_per_step": busy, "idle_share": 1 - busy / wall_ms,
          "idle_share_vs_unprofiled_wall": 1 - busy / steady_ms,
          "kernels_per_step": sum(n_ for *_, n_ in kernels),
          "split_ms_per_step": split,
          "split_share_of_busy": {p: ms / busy for p, ms in split.items()},
          "split_attributed_ms": sum(split.values()),
          "split_rules": "ds_profile_split's docstring",
          "top": [[name[:80], ms, n_] for name, ms, n_ in kernels[:15]],
          "card": smi})
    del state, step_fn, tr, held, data
    gc.collect()
    torch.cuda.empty_cache()

    # --------------------------------------------------------- 25. ds_mla
    t0 = time.perf_counter()
    params = model.init(gen(), device=dev)
    torch.cuda.synchronize()
    serve_init_s = time.perf_counter() - t0
    n_serve = sum(t.numel() for t in tree_util.leaves(params))
    # the weight draw: the card's generator against the host's one stream
    # (the phases before draw on the host: torch.Generator() seed 0)
    probe = 1 << 27
    t0 = time.perf_counter()
    torch.randn(probe, generator=torch.Generator().manual_seed(0))
    host_rate = probe / (time.perf_counter() - t0)
    draw = {"serving_params": n_serve, "on_card_s": serve_init_s,
            "host_draws_per_s": host_rate,
            "host_s_for_serving_params": n_serve / host_rate,
            "host_RAM_GB": os.sysconf("SC_PAGE_SIZE")
            * os.sysconf("SC_PHYS_PAGES") / 1e9,
            "largest_leaf_float32_GB": 4 * max(
                t.numel() for t in tree_util.leaves(params)) / 1e9}
    c32 = dataclasses.replace(cfg, dtype="float32")
    m = cfg.mla
    L0 = tree_util.tree_map(lambda t: t[0], params["dense_stack"])
    p0 = tree_util.tree_map(lambda t: t.float(), L0["attn"])
    S = DS_MLA_LEN
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, S))).to(dev)
    with torch.no_grad():
        h = apply_norm(L0["ln1"], embed_tokens(params["embed"], toks, cfg),
                       cfg).float()
        y_full, _ = attn_mod.mla_attention(
            p0, h, c32, positions=torch.arange(S, device=dev)[None])
        _, pre = attn_mod.mla_attention(
            p0, h[:, :S - 1], c32,
            positions=torch.arange(S - 1, device=dev)[None])
        want = y_full[:, S - 1:]

        def absorbed(p):
            cache = {n: torch.nn.functional.pad(c, (0, 0, 0, 1))
                     for n, c in pre.items()}
            y, _ = attn_mod.mla_decode(p, h[:, S - 1:], c32, cache,
                                       torch.tensor(S - 1, device=dev))
            return y

        def reading(y):
            return ((y - want).abs().max() / want.abs().max()).item()

        got = absorbed(p0)
        nope = m.qk_nope_head_dim
        bad = dict(p0, wkv_b=torch.cat([p0["wkv_b"][..., :nope],
                                        p0["wkv_b"][..., :nope]], -1))
        planted = reading(absorbed(bad))
    mla_reading = reading(got)
    mla_ok = mla_reading <= DS_MLA_TOL and planted > DS_MLA_TOL
    emit({"phase": "ds_mla", "arch": cfg.name, "layer": "dense_stack.0",
          "dtype": "float32", "heads": cfg.n_heads,
          "dims": dataclasses.asdict(m), "prefill_len": S,
          "decode_pos": S - 1,
          "max_abs_err": (got - want).abs().max().item(),
          "max_abs_out": want.abs().max().item(),
          "reading": mla_reading, "tol": DS_MLA_TOL,
          "planted_fault": {"what": "W_UV taken from wkv_b's nope columns",
                            "reading": planted,
                            "read_as_failure": planted > DS_MLA_TOL},
          "ok": mla_ok, "card": smi})
    if not mla_ok:
        raise AssertionError(f"ds_mla: absorbed decode reads {mla_reading} "
                             f"(tol {DS_MLA_TOL}); planted fault reads "
                             f"{planted}")
    del p0, h, y_full, pre, want, got, bad, L0

    # ------------------------------------------------------ 26. ds_decode
    # batch 1: prefill(S-1) then decode equals prefill(S) when both
    # prefills give the experts the same capacity and prefill(S) kept every
    # slot of the last token (moe.drop_log says whether it did)
    S = DS_DECODE_LEN
    k = cfg.moe.top_k
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, S))).to(dev)

    cfs = (cfg.moe.capacity_factor, DS_DECODE_NO_DROP_CF)
    runs = {}
    t0 = time.perf_counter()
    for dtype in ("bfloat16", "float32"):
        if dtype == "float32":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            widened = _widen_(params)             # the bf16 values, widened
        for cf in cfs:
            c = dataclasses.replace(cfg, dtype=dtype, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cf))
            full, lg, _, n_fd, kept, any_drop = moe_decode_vs_prefill(
                build_model(c), params, toks, 1)
            runs[dtype, cf] = full, lg, n_fd, kept, any_drop
        if dtype == "float32":
            twin_peak = torch.cuda.max_memory_allocated() / 1e9
            _narrow_(widened)                     # back, exactly
            del widened
            gc.collect()
            torch.cuda.empty_cache()
    decode_s = time.perf_counter() - t0
    cf_runs = {}
    for cf in cfs:
        full16, lg16, fd16, kept16, any16 = runs["bfloat16", cf]
        full32, lg32, fd32, kept32, any32 = runs["float32", cf]
        agree, readings = decode_readings(full16, lg16, full32, lg32)
        dropped_last = any(n != k for n in kept16 + kept32)
        cf_runs[str(cf)] = {
            "decode_agrees": agree, **readings,
            "last_token_dropped": dropped_last,
            "last_token_slots_kept": {"bfloat16": kept16, "float32": kept32},
            "a_prefill_dropped_a_slot": {"bfloat16": any16,
                                         "float32": any32},
            "flash_decode_launches_per_decode_step": {"bfloat16": fd16,
                                                      "float32": fd32},
            "ok": bool((agree or dropped_last) and fd16 == 0 and fd32 == 0
                       and torch.isfinite(lg16).all().item()
                       and torch.isfinite(lg32).all().item())}
    del runs
    no_drop = cf_runs[str(DS_DECODE_NO_DROP_CF)]
    ok = (all(r["ok"] for r in cf_runs.values())
          and not any(no_drop["a_prefill_dropped_a_slot"].values())
          and not no_drop["last_token_dropped"] and no_drop["decode_agrees"])
    emit({"phase": "ds_decode", "arch": cfg.name, "batch": 1,
          "prefill_len": S - 1, "full_len": S, "wall_s": decode_s,
          "float32_twin_peak_GB": twin_peak,
          "by_capacity_factor": cf_runs,
          "gate": "decode_agrees (as ssm_decode) unless the full prefill "
                  "dropped a slot of the last token; at capacity factor "
                  f"{DS_DECODE_NO_DROP_CF} no expert can fill: neither "
                  "prefill may drop a slot, and decode must agree; "
                  "flash_decode launches 0 (MLA's absorbed decode is "
                  "float32 einsums)",
          "ok": ok, "card": smi})
    if not ok:
        raise AssertionError(f"ds_decode: {cf_runs}")

    # ------------------------------------------------------- 27. ds_serve
    sv = DS_SERVE
    warm = ServeEngine(model, params, slots=2, window=64, device=dev)
    warm.submit([1, 2, 3], max_new_tokens=2)
    warm.run_until_idle()
    del warm
    eng = ServeEngine(model, params, slots=sv["slots"], window=sv["window"],
                      device=dev)
    rng = np.random.default_rng(0)
    lo, hi = sv["prompt"]
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(lo, hi + 1, sv["requests"])]
    torch.cuda.synchronize()
    fd.launches = 0
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=sv["new"]) for p in prompts]
    eng.run_until_idle(max_steps=16)          # mid-decode of the first wave
    pos0 = eng.pos.copy()
    eng.run_until_idle(max_steps=100000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    serve_fd, calls = fd.launches, eng.decode_calls
    outs = [eng.result(r) for r in rids]
    done = sum(o is not None and len(o) == sv["new"] for o in outs)
    n_tok = sum(len(o or []) for o in outs)
    prompt_tok = sum(len(p) for p in prompts)
    step_profile = serve_profile(model, params, eng, pos0, acts)
    emit({"phase": "ds_serve", "arch": cfg.name, "dtype": cfg.dtype,
          "reduced": "n_layers=2 (1 dense, 1 MoE of 256 experts), "
                     "mtp_depth=0 (full width)",
          "params": n_serve, "weight_draw": draw,
          "slots": sv["slots"], "window": sv["window"],
          "requests": sv["requests"], "done": done,
          "prompt_tokens": prompt_tok, "new_tokens": n_tok,
          "decode_step_calls": calls, "flash_decode_launches": serve_fd,
          "wall_s": wall, "ms_per_decode_step": wall / calls * 1e3,
          "tok_per_s": (prompt_tok + n_tok) / wall,
          "new_tok_per_s": n_tok / wall,
          "first_tokens": outs[0][:8] if outs[0] else None,
          "decode_step_profile": step_profile, "card": smi})
    if done != sv["requests"]:
        raise AssertionError(f"ds_serve: served {done}/{sv['requests']} "
                             "requests")
    if not all(0 <= t < cfg.vocab_size for o in outs for t in o):
        raise AssertionError("ds_serve: a token lies outside the vocabulary")
    if serve_fd or calls == 0:
        raise AssertionError(f"ds_serve: flash_decode launched {serve_fd} "
                             f"times over {calls} decode_step calls; "
                             "expected 0")
    del eng, params, model, tmodel
    gc.collect()
    torch.cuda.empty_cache()
    launches = {name: m.launches for name, m in kmods.items()}
    if any(launches.values()):
        raise AssertionError(f"a kernel launched on the deepseek path: "
                             f"{launches}")
    out = {name: {"path": "ds_train, ds_decode, ds_serve", "launches": n}
           for name, n in launches.items()}
    # the donated step's peak over the run, less what the card held before
    # the state was drawn; and the meta-tree reckoning of it
    out["train_peak"] = {"bytes": peak_bytes - base,
                         "reckoned_GB": reckoned["donated"]}
    return out


# ------------------------------------------------------------- 28. shard
def _close_reading(got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """max |got - want| / (tol * max(1, max|want|) + tol |want|): at most 1
    passes (rtol = tol, atol = tol of the leaf's scale)."""
    g, w = got.float(), want.float()
    scale = max(1.0, w.abs().max().item()) if w.numel() else 1.0
    if not w.numel():
        return 0.0
    return ((g - w).abs() / (tol * scale + tol * w.abs())).max().item()


def _update_reading(got: torch.Tensor, want: torch.Tensor,
                    before: torch.Tensor) -> dict:
    """A sharded optimizer step's result ``got`` against ``want``, the
    unsharded AdamW's from the same parameters ``before`` and the same
    gradients: ``update_rel`` = ||got - want|| / ||want - before|| (0 where
    neither moved, inf where only ``got`` did; a missing or doubled update
    reads 1), and the share of elements ``want`` moved."""
    g, w, b = got.double(), want.double(), before.double()
    step = torch.linalg.vector_norm(w - b).item()
    diff = torch.linalg.vector_norm(g - w).item()
    return {"update_rel": (diff / step if step else
                           0.0 if diff == 0 else math.inf),
            "moved_share": (w != b).double().mean().item()}


def _block_combines(cfg, pctx, kind: str, over_data) -> dict:
    """``combine`` launches one call of a block of ``kind`` makes on each
    rank in a sharded train step. Attention blocks: a sum over model after
    attention (and after a decoder's cross-attention) and after the MLP in
    forward, the attention's (and the cross-attention's) again in the
    recompute (the MLP's sum is the block's last op and nothing backward
    reads comes after it, so the non-reentrant checkpoint stops its
    recompute before it), a sum over model in backward at each entry (the
    copies' adjoint: one for the queries and K/V, three under ``mha_ize``;
    the cross-attention's query and its K/V from the encoder output; the
    MLP's). Mamba-2 blocks: the gated norm's sum of squares and
    ``out_proj``'s sum in forward, the norm's again in the recompute
    (``out_proj``'s is last), and in backward the entry's copy, the norm's
    copy and the reduce-scatters of B and C gathered over model. Then one
    reduce-scatter over data in backward for each leaf sharded over data
    (the block's leaves are gathered at each call)."""
    from repro_torch.models.attention import _mha_ize, gqa_tp
    from repro_torch.models.layers import mlp_tp, tp_active
    from repro_torch.models.transformer import layer_specs
    zero = over_data(layer_specs(cfg, kind, pctx))
    if kind == "ssm":
        tp = int(tp_active(pctx))
        return {"forward": 2 * tp, "recompute": tp, "backward": 4 * tp,
                "zero": zero}
    attn, mlp = int(gqa_tp(cfg, pctx)), int(mlp_tp(cfg.d_ff, pctx))
    kv = 2 if _mha_ize(cfg, pctx.tp_size) else 0
    cross = attn if kind == "decoder" else 0
    return {"forward": attn + cross + mlp, "recompute": attn + cross,
            "backward": attn * (1 + kv) + cross * (2 + kv) + mlp,
            "zero": zero}


def _tree_bytes(tree) -> int:
    from repro_torch import tree as tree_util
    return sum(t.numel() * t.element_size() for t in tree_util.leaves(tree)
               if isinstance(t, torch.Tensor) and t.is_cuda)


def step_peak_start(on_card: bool, args) -> int | None:
    """Before a step: the peak reset, and the bytes the card holds besides
    the step's arguments ``args`` (what :func:`step_peak` subtracts), so a
    step's peak counts what the dry run counts: its arguments and what it
    allocates. None off the card."""
    if not on_card:
        return None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() - _tree_bytes(args)


def step_peak(on_card: bool, other: int | None) -> int | None:
    """After a step: ``torch.cuda.max_memory_allocated()`` less what
    :func:`step_peak_start` found besides the step's arguments."""
    if not on_card:
        return None
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - other


def within_band(reckoned: int, measured: int) -> bool:
    """DRYRUN_BAND: the dry run's peak within 10% of the measured one or
    256 MiB, whichever is larger."""
    return abs(reckoned - measured) <= max(DRYRUN_BAND[0] * measured,
                                           DRYRUN_BAND[1])


def shard_block_calls(model) -> list[tuple[str, int]]:
    """(block kind, calls a step) of ``model``'s trunk: a hybrid's shared
    block once a group, an encoder-decoder's two stacks."""
    cfg = model.cfg
    name = type(model).__name__
    if name == "SSMLM":
        return [("ssm", cfg.n_layers)]
    if name == "HybridLM":
        return [("ssm", cfg.n_layers), ("dense", model.n_groups)]
    if name == "EncDecLM":
        return [("encoder", cfg.encdec.n_encoder_layers),
                ("decoder", cfg.n_layers)]
    if cfg.moe is not None:
        raise ValueError(f"{cfg.name}: no reckoning for MoE layers")
    return [("dense", cfg.n_layers)]


def shard_expected_combines(model, pctx, plan: list, n_pod: int) -> dict:
    """``combine`` launches one sharded train step of ``model`` makes on
    each rank, from its layout alone: its blocks' (:func:`_block_combines`
    per call, :func:`shard_block_calls`), one reduce-scatter over data in
    backward for each top leaf sharded over data (the embedding's), the
    sync's plan of the leaves replicated over data and one sum over pod per
    bucket of the rest, the gradient norm and the loss's mean over the
    batch ranks, one each."""
    from repro_torch.models.transformer import top_specs
    from repro_torch.parallel.grad_sync import combine_launches_per_sync
    from repro_torch.parallel.sharding import is_spec, spec_axes
    from repro_torch import tree as tree_util

    def over_data(tree):
        return sum("data" in {a for e in s for a in spec_axes(e)}
                   for s in tree_util.leaves(tree, is_leaf=is_spec))

    parts = {"tp_forward": 0, "tp_recompute": 0, "tp_backward": 0,
             "zero_reduce_scatter": over_data(top_specs(model.cfg, pctx))}
    for kind, calls in shard_block_calls(model):
        blk = _block_combines(model.cfg, pctx, kind, over_data)
        parts["tp_forward"] += calls * blk["forward"]
        parts["tp_recompute"] += calls * blk["recompute"]
        parts["tp_backward"] += calls * blk["backward"]
        parts["zero_reduce_scatter"] += calls * blk["zero"]
    parts.update({"sync_replicated_plan": combine_launches_per_sync(
        pctx.mesh, plan), "sync_pod_buckets": n_pod, "grad_norm": 1,
        "loss_mean": 1})
    parts["total"] = sum(parts.values())
    return parts


def shard_family_config(arch: str, cut: dict):
    """``arch`` at full width with SHARD_FAMILIES' ``cut``."""
    from repro_torch.configs import get
    cfg = get(arch)
    kw = dict(cut)
    if "n_experts" in kw:
        kw["moe"] = dataclasses.replace(cfg.moe, n_experts=kw.pop("n_experts"))
    if "n_encoder_layers" in kw:
        kw["encdec"] = dataclasses.replace(
            cfg.encdec, n_encoder_layers=kw.pop("n_encoder_layers"))
    return dataclasses.replace(cfg, **kw)


def _window(cache, n: int):
    """``cache`` with room for ``n`` more positions: attention KV and MLA's
    latent grow along their sequence dim; SSM and conv states and whisper's
    cross K/V do not."""
    import torch.nn.functional as F
    from repro_torch import tree as tree_util

    def grow(name, t):
        parts = name.split(".")
        if parts[0] in ("conv", "ssm", "cross"):
            return t
        pad = (0, 0, 0, n) if parts[-1] in ("c_kv", "k_rope") else \
            (0, 0, 0, 0, 0, n)
        return F.pad(t, pad).contiguous()

    return tree_util.unflatten(cache, [grow(k, t) for k, t in
                                       tree_util.named_leaves(cache)])


def _cut_cache(name: str, t: torch.Tensor, spec, mesh,
               coords: dict) -> torch.Tensor:
    """The block of a whole cache leaf the rank at ``coords`` holds:
    ``spec`` from cache_specs; whisper's cross K/V by rows and KV heads
    (cache_specs reads them by their shape as an SSM state, (B, h, ...)
    with S_enc as h; ROADMAP.md R13)."""
    from repro_torch.parallel.sharding import Sharding, Spec
    if name.startswith("cross"):
        spec = Spec(None, ("pod", "data"), None, "model", None)
    return t[Sharding(mesh, spec).slices(t.shape, coords)]


def _drawn_blocks(model, rank: int, mesh, pctx, dev) -> tuple:
    """(this rank's parameter blocks, ``draw``, the meta tree, its specs'
    leaves, the wave): ``draw()`` gives the full tree, drawn on the card
    from torch.Generator seed 0, which each rank cuts to its blocks by
    ``param_specs``; the ranks draw in waves while the trees fit
    SHARD_DRAW_GB together."""
    import torch.distributed as dist

    from repro_torch import tree as tree_util
    from repro_torch.parallel.sharding import Sharding, is_spec, param_specs

    def draw():
        return model.init(torch.Generator(dev).manual_seed(0), device=dev)

    world = dist.get_world_size()
    meta = model.init(None, device="meta")
    spec_l = tree_util.leaves(param_specs(meta, model.cfg, pctx),
                              is_leaf=is_spec)
    size = sum(t.numel() * t.element_size() for t in tree_util.leaves(meta))
    wave = max(1, min(world, int(SHARD_DRAW_GB * 1e9 // size)))
    params = None
    for first in range(0, world, wave):
        if first <= rank < first + wave:
            full = draw()
            params = tree_util.unflatten(full, [
                Sharding(mesh, sp).shard(t)
                for sp, t in zip(spec_l, tree_util.leaves(full))])
            del full
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    return params, draw, meta, spec_l, wave


def shard_family(fam: tuple, rank: int, mesh, pctx, dev) -> dict:
    """Phase 28 (e) for one of SHARD_FAMILIES on this rank: its readings
    (train, decode, bytes, launches, the kernels on its own inputs, and,
    on the pod-0 ranks, the unsharded run's readings of its blocks)."""
    import torch.distributed as dist

    from repro_torch import tree as tree_util
    from repro_torch.config import ShapeConfig
    from repro_torch.data.pipeline import SyntheticTokens, shard_batch
    from repro_torch.kernels.allreduce_combine import kernel as ck
    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.models import build_model, ssm
    from repro_torch.parallel.grad_sync import plan_sharded_sync
    from repro_torch.parallel.sharding import (Sharding, cache_specs, is_spec,
                                               opt_state_specs, param_specs)
    from repro_torch.parallel.tensor_parallel import keep_gathered
    from repro_torch.train.loop import Trainer, shardings_of
    from repro_torch.train.optimizer import AdamWConfig, adamw_init

    label, arch, cut, seq, train = fam
    on_card = dev.type == "cuda"
    cfg = shard_family_config(arch, cut)
    model = build_model(cfg)
    world = dist.get_world_size()
    n_patch = cfg.vision.n_patches if cfg.vision is not None else 0
    prompt, nd = seq - SHARD_FAMILY_DECODE, SHARD_FAMILY_DECODE

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def nbytes(tree):
        return sum(t.numel() * t.element_size()
                   for t in tree_util.leaves(tree))

    def reckoned(tree, sp):
        return sum(t.numel() * t.element_size()
                   // math.prod(Sharding(mesh, s).parts(t.shape))
                   for t, s in zip(tree_util.leaves(tree),
                                   tree_util.leaves(sp, is_leaf=is_spec)))

    params, draw, meta, spec_l, wave = _drawn_blocks(model, rank, mesh, pctx,
                                                     dev)
    batch = SyntheticTokens(cfg, batch=SHARD["global_batch"], seq=seq,
                            seed=29, device=dev).batch_at(0)
    local = shard_batch(batch, pctx)
    n_ssm = cfg.n_layers if cfg.ssm is not None else 0
    out = {"arch": arch, "cut": cut, "seq": seq, "patches": n_patch,
           "wave": wave, "ssm_layers": n_ssm}
    opt_cfg = AdamWConfig(lr=SHARD["lr"], warmup_steps=1, decay_steps=10)
    out["bytes"] = {"params": nbytes(params),
                    "params_reckoned": reckoned(meta, param_specs(
                        meta, cfg, pctx)),
                    "params_full": nbytes(meta)}

    # ---- (a) one sharded train step
    p1 = g1 = None
    if train:
        tr = Trainer(model, opt_cfg, pctx=pctx, device=dev)
        state = {"params": params, "opt": adamw_init(params, opt_cfg)}
        meta_opt = adamw_init(meta, opt_cfg)
        out["bytes"].update({
            "moments": nbytes(state["opt"]),
            "moments_reckoned": reckoned(meta_opt, opt_state_specs(
                meta_opt, meta, cfg, pctx))})
        plan, n_pod = plan_sharded_sync(params, shardings_of(model, pctx),
                                        mesh)
        want = shard_expected_combines(model, pctx, plan, n_pod)
        seen = {}
        sync_fn = tr.make_sync()

        def capture(g):
            seen["g"] = sync_fn(g)
            return seen["g"]

        step = tr.make_step(sync_fn=capture)
        sync()
        dist.barrier()
        ck.launches = sk.launches = fd.launches = 0
        t0 = time.perf_counter()
        state, m = step(state, local)
        sync()
        wall = time.perf_counter() - t0
        p1, g1 = state["params"], seen["g"]
        digest = _digest(p1)
        rep = _digest({n: t for (n, t), sp in zip(
            tree_util.named_leaves(p1), spec_l) if not any(sp)})
        every = [None] * world
        dist.all_gather_object(every, (mesh.coords, digest, rep))
        by_block: dict = {}
        for c, dg, _ in every:
            by_block.setdefault((c["data"], c["model"]), set()).add(dg)
        out["train"] = {
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "wall_s": wall, "combine_launches": ck.launches,
            "expected_combines": want, "plan": dict(collections.Counter(plan)),
            "ssd_scan_launches": sk.launches,
            "flash_decode_launches": fd.launches,
            "blocks_equal_across_pods": all(len(v) == 1
                                            for v in by_block.values()),
            "replicated_equal_everywhere": len({r for *_, r in every}) == 1,
            "leaves_moved": sum(not torch.equal(a, b) for a, b in zip(
                tree_util.leaves(p1), tree_util.leaves(params))),
            "leaves_n": len(spec_l)}
        del state, seen

    # ---- (b) sharded prefill, then decode_steps, the gathers kept
    ssd_in = []
    ssd_route = ssm.ssd

    def first_ssd(*a):
        if not ssd_in:
            ssd_in.extend(t.detach().clone() if torch.is_tensor(t) else t
                          for t in a)
        return ssd_route(*a)

    toks = local["tokens"]
    ssm.ssd = first_ssd
    try:
        with torch.no_grad(), keep_gathered():
            sync()
            dist.barrier()
            ck.launches = sk.launches = fd.launches = 0
            t0 = time.perf_counter()
            lg, caches = model.prefill(params, {**local,
                                                "tokens": toks[:, :prompt]},
                                       pctx)
            sync()
            prefill_s = time.perf_counter() - t0
            prefill_ssd, prefill_combine = sk.launches, ck.launches
            caches = _window(caches, nd)
            sync()
            dist.barrier()
            ck.launches = fd.launches = 0
            t0 = time.perf_counter()
            outs = [lg]
            for i in range(nd):
                lg, caches = model.decode_step(
                    params, caches, {"token": toks[:, prompt + i],
                                     "pos": n_patch + prompt + i}, pctx)
                outs.append(lg)
            sync()
            dec_s = time.perf_counter() - t0
            dec_fd, dec_combine = fd.launches, ck.launches
    finally:
        ssm.ssd = ssd_route
    logits = torch.cat(outs, dim=1)
    window = n_patch + seq
    cmeta = model.init_cache(SHARD["global_batch"], window, device="meta")
    cspecs = cache_specs(cmeta, cfg, ShapeConfig(
        "decode", window, SHARD["global_batch"], "decode"), pctx)
    cspec_of = dict(zip((n for n, _ in tree_util.named_leaves(cmeta)),
                        tree_util.leaves(cspecs, is_leaf=is_spec)))
    out["bytes"].update({"caches": nbytes(caches),
                         "caches_reckoned": reckoned(cmeta, cspecs),
                         "caches_full": nbytes(cmeta)})
    out["decode"] = {
        "prefill_tokens": n_patch + prompt, "decode_steps": nd,
        "prefill_s": prefill_s, "ms_per_decode_step": dec_s / nd * 1e3,
        "prefill_ssd_scan_launches": prefill_ssd,
        "prefill_combine_launches": prefill_combine,
        "flash_decode_launches": dec_fd,
        "flash_decode_per_decode_step": dec_fd / nd,
        "combine_per_decode_step": dec_combine / nd,
        "finite": bool(torch.isfinite(logits).all().item()),
        "local_caches": {k: list(t.shape) for k, t in
                         tree_util.named_leaves(caches)}}
    if cfg.mla is not None:
        lat = caches["dense"]
        out["decode"]["latent_share"] = (lat["c_kv"].shape[-1]
                                         / cfg.mla.kv_lora_rank)
        out["decode"]["rope_share"] = (lat["k_rope"].shape[-1]
                                       / cfg.mla.qk_rope_head_dim)
    if cfg.ssm is not None:
        st = caches["ssm"]["ssm"] if "attn" in caches else caches["ssm"]
        out["decode"]["ssm_state_heads"] = int(st.shape[-3])
        out["ssm_heads"] = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim

    # the kernels on this rank's own inputs, against their plain versions
    checks = {}
    if on_card and ssd_in:
        from repro_torch.kernels.ssd_scan.ref import ssd_chunked_tc
        x, dt, A, B, C, chunk = ssd_in
        pad = -x.shape[1] % chunk
        if pad:
            x, B, C = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                       for t in (x, B, C))
            dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        ins = [t.contiguous() for t in (x, dt, A, B, C)]
        y, st = sk.ssd_scan(*ins, chunk=chunk)
        y_t, st_t = ssd_chunked_tc(*ins, chunk)
        sync()

        def rel(a, b):
            return ((a - b).abs().max() / b.abs().max()).item()

        checks["ssd_scan"] = {"shape": list(x.shape) + [B.shape[-1]],
                              "chunk": chunk, "variant": sk.variant_for(
                                  x.dtype, x.shape[3], B.shape[3], chunk),
                              "rel_err_vs_ssd_chunked_tc": max(
                                  rel(y, y_t), rel(st, st_t)),
                              "tol": SSD_TC_TIGHT}
    if on_card:
        S = n_patch + seq
        lengths = torch.tensor([S, S // 2], dtype=torch.int32, device=dev)
        kv = {}
        if "attn" in caches:
            kv["attn"] = (caches["attn"]["k"][0], caches["attn"]["v"][0],
                          lengths)
        if "self" in caches:
            kv["self"] = (caches["self"]["k"][0], caches["self"]["v"][0],
                          lengths)
            k0, v0 = caches["cross"][0][0], caches["cross"][1][0]
            kv["cross"] = (k0, v0, torch.full_like(lengths, k0.shape[1]))
        if "dense" in caches and "k" in caches["dense"]:
            kv["dense"] = (caches["dense"]["k"][0], caches["dense"]["v"][0],
                           lengths)
        H = cfg.n_heads // pctx.tp_size
        for name, (k, v, ln) in kv.items():
            checks[f"flash_decode_{name}"] = cache_check(
                290 + rank, H, k.contiguous(), v.contiguous(), ln)
    out["kernel_checks"] = checks

    # ---- the unsharded model (the others' freed gathers handed back to
    # the card first): on rank 0, its float32 twin and its bf16 decode,
    # against which every rank's decode is read there; then its bf16 step
    # on the pod-0 ranks in turns, each reading its own blocks (a pod-1
    # rank's are its pod-0 twin's, bit for bit: blocks_equal_across_pods)
    if on_card:
        torch.cuda.empty_cache()
    every = [None] * world if rank == 0 else None
    dist.gather_object((mesh.coords, logits.cpu(), {
        n: t.cpu() for n, t in tree_util.named_leaves(caches)}), every, dst=0)
    noise = [None]
    if rank == 0:
        noise[0], want, c16 = shard_family_twin(
            model, draw, dev, batch, prompt, nd, n_patch, opt_cfg, train)
        out["unsharded_decode"] = shard_decode_readings(
            every, want, c16, noise[0], cspec_of, mesh, pctx)
        out["bf16_noise"] = {"logits": noise[0]["logits"],
                             "caches": noise[0]["caches"]}
        del every, want, c16
        if on_card:
            torch.cuda.empty_cache()
    dist.broadcast_object_list(noise, src=0)
    out["unsharded_step"] = None
    for r in range(world):
        if not train or mesh.coords_of(r)["pod"] != 0:
            continue
        if rank == r:
            out["unsharded_step"] = shard_step_readings(
                model, draw, dev, batch, opt_cfg, p1, g1, spec_l, mesh,
                noise[0]["grads"])
            if on_card:
                torch.cuda.empty_cache()
        dist.barrier()
    return out


def _noisy_reading(got: torch.Tensor, want: torch.Tensor, noise: float,
                   tol: float) -> float:
    """max |got - want| / (2 noise + tol max(1, max|want|) + tol |want|):
    at most 1 passes. ``noise`` is the unsharded bf16 model's own largest
    distance from its float32 twin there, allowed for each of the two bf16
    runs (SHARD_GRAD_FLOOR's comment)."""
    g, w = got.float(), want.float()
    scale = max(1.0, w.abs().max().item())
    return ((g - w).abs() / (2 * noise + tol * scale + tol * w.abs())
            ).max().item()


def _unsharded_step(model, params, opt_cfg, batch, dev):
    """(state, metrics, gradients) of one unsharded Trainer step."""
    from repro_torch.train.loop import Trainer
    from repro_torch.train.optimizer import adamw_init
    seen = {}

    def capture(g):
        seen["g"] = g
        return g

    state, metrics = Trainer(model, opt_cfg, device=dev).make_step(
        sync_fn=capture)({"params": params,
                          "opt": adamw_init(params, opt_cfg)}, batch)
    return state, metrics, seen["g"]


def _unsharded_decode(model, params, batch, prompt: int, nd: int,
                      n_patch: int):
    """(logits (B, 1 + nd, V), caches) of the whole batch's prefill of
    ``prompt`` tokens then ``nd`` decode_steps."""
    with torch.no_grad():
        lg, c = model.prefill(params, {**batch, "tokens":
                                       batch["tokens"][:, :prompt]})
        c = _window(c, nd)
        outs = [lg]
        for i in range(nd):
            lg, c = model.decode_step(params, c, {
                "token": batch["tokens"][:, prompt + i],
                "pos": n_patch + prompt + i})
            outs.append(lg)
    return torch.cat(outs, dim=1), c


def shard_family_twin(model, draw, dev, batch, prompt, nd, n_patch,
                      opt_cfg, train) -> tuple[dict, torch.Tensor, dict]:
    """The unsharded bf16 model's own error, once a family: the largest
    distance from its float32 twin (the same weights widened) of each
    gradient leaf of one step, of the decode's logits and of each cache
    leaf (SHARD_GRAD_FLOOR's comment); and the bf16 decode's logits and
    caches, on the whole batch."""
    from repro_torch import tree as tree_util
    from repro_torch.models import build_model

    def dist_(a, b):
        return {n: (x.float() - y.float()).abs().max().item() for (n, x), y
                in zip(tree_util.named_leaves(a), tree_util.leaves(b))}

    model32 = build_model(dataclasses.replace(model.cfg, dtype="float32"))
    full = draw()
    noise = {}
    if train:
        _, _, g16 = _unsharded_step(model, full, opt_cfg, batch, dev)
        slots = _widen_(full)
        _, _, g32 = _unsharded_step(model32, full, opt_cfg, batch, dev)
        _narrow_(slots)
        noise["grads"] = dist_(g16, g32)
        del g16, g32
    l16, c16 = _unsharded_decode(model, full, batch, prompt, nd, n_patch)
    _widen_(full)
    l32, c32 = _unsharded_decode(model32, full, batch, prompt, nd, n_patch)
    noise["logits"] = (l16.float() - l32).abs().max().item()
    noise["caches"] = dist_(c16, c32)
    return noise, l16, c16


def shard_decode_readings(every: list, want: torch.Tensor, c16: dict,
                          noise: dict, cspec_of: dict, mesh, pctx) -> dict:
    """Every rank's decode (``every``: (coords, logits, named caches)) against
    its rows of the unsharded bf16 decode's logits ``want`` and its block of
    the caches ``c16``: SHARD_BF16_TOL beyond twice the bf16 model's own
    distance from its float32 twin (``noise``)."""
    from repro_torch import tree as tree_util
    per = SHARD["global_batch"] // pctx.dp_size
    whole = dict(tree_util.named_leaves(c16))
    out = {}
    for r, (coords, lg, mine) in enumerate(every):
        row = coords["pod"] * mesh.shape["data"] + coords["data"]
        w = want[row * per:(row + 1) * per]
        lg = lg.to(w.device)
        reads = {}
        for n, t in whole.items():
            blk = _cut_cache(n, t, cspec_of[n], mesh, coords)
            reads[n] = {"reading": _noisy_reading(
                mine[n].to(t.device), blk, noise["caches"][n],
                SHARD_BF16_TOL), "max_abs_err": (mine[n].to(t.device).float()
                                                 - blk.float()).abs().max()
                .item()}
        out[r] = {"logits_reading": _noisy_reading(lg, w, noise["logits"],
                                                   SHARD_BF16_TOL),
                  "logits_max_abs_err": (lg.float() - w.float()).abs().max()
                  .item(),
                  "max_abs_logit": w.abs().max().item(),
                  "cache_readings": reads}
    return out


def shard_step_readings(model, draw, dev, batch, opt_cfg, p1, g1, spec_l,
                        mesh, grad_noise: dict) -> dict:
    """This rank's blocks of one sharded step against the unsharded bf16
    step on the whole batch: the loss, the updated leaves (SHARD_STEP_TOL)
    and the synced gradients (SHARD_GRAD_TOL of each leaf's largest value
    beyond twice the bf16 model's own distance from its float32 twin
    there, ``grad_noise``; unrotated key biases against SHARD_GRAD_FLOOR
    of the tree's largest gradient)."""
    from repro_torch import tree as tree_util
    from repro_torch.parallel.sharding import Sharding

    cfg = model.cfg
    full = draw()
    s0, m0, g16 = _unsharded_step(model, full, opt_cfg, batch, dev)
    del full
    top = max(t.float().abs().max().item() for t in tree_util.leaves(g16))
    reads = {}
    for (n, a), g, sp, b, gb in zip(
            tree_util.named_leaves(p1), tree_util.leaves(g1), spec_l,
            tree_util.leaves(s0["params"]), tree_util.leaves(g16)):
        sh = Sharding(mesh, sp)
        err = (g.float() - sh.shard(gb).float()).abs().max().item()
        own = gb.float().abs().max().item()
        r = reads[n] = {"param": _close_reading(a, sh.shard(b),
                                                SHARD_STEP_TOL),
                        "grad_max_abs_err": err, "grad_max": own,
                        "grad_bf16_noise": grad_noise[n]}
        if n.endswith(".bk") and (cfg.pos_embedding != "rope"
                                  or ".xattn." in n):
            r["zero_grad_share"] = max(own, g.float().abs().max().item()) / top
        else:
            r["grad_rel"] = max(0.0, err - 2 * grad_noise[n]) / max(own, 1e-30)
    rel = {n: r["grad_rel"] for n, r in reads.items() if "grad_rel" in r}
    return {"loss_unsharded": float(m0["loss"]),
            "worst_param_reading": max(r["param"] for r in reads.values()),
            "worst_grad_rel": max(rel.values()),
            "worst_grad_leaf": max(rel, key=rel.get),
            "worst_zero_grad_share": max(
                (r["zero_grad_share"] for r in reads.values()
                 if "zero_grad_share" in r), default=0.0),
            "leaves": reads}


def _seq_blocks(t, spec, mesh, seed: int, dev, coords=None):
    """A cache leaf ``t`` (meta; a leading group dim) drawn block by block
    as ``spec`` cuts it, one torch.Generator seed a block (``seed``, the
    group and the block's index): with ``coords`` only the block that rank
    holds, (G, *local); else the whole leaf, every block in its place."""
    import itertools

    from repro_torch.parallel.sharding import Sharding
    sh = Sharding(mesh, spec)
    parts = sh.parts(t.shape)
    local = sh.local_shape(t.shape)

    def block(g, index, into=None):
        # drawn into a contiguous tensor of the block's shape (the same
        # values wherever it lies)
        n = 0
        for i, p in zip(index, parts):
            n = n * p + i
        gen = torch.Generator(dev).manual_seed(seed + 1000 * g + n)
        if into is None:
            into = torch.empty(local[1:], dtype=t.dtype, device=dev)
        return into.normal_(generator=gen)

    if coords is not None:
        index = sh.block_index(coords, t.dim())
        out = torch.empty(local, dtype=t.dtype, device=dev)
        for g in range(t.shape[0]):
            block(g, index, out[g])
        return out
    whole = torch.empty(t.shape, dtype=t.dtype, device=dev)
    for index in itertools.product(*(range(p) for p in parts)):
        at = tuple(slice(i * n, (i + 1) * n) for i, n in zip(index, local))
        for g in range(t.shape[0]):
            whole[g][at[1:]] = block(g, index)
    return whole


def _lse_check(fd, q, k, v, lengths) -> dict:
    """flash_decode's log-sum-exp form on one rank's cache block against
    its plain version: ``out`` (float32) and ``lse`` read at FD_TOL of the
    inputs' dtype, a row of length 0 exactly 0 and -inf."""
    from repro_torch.kernels.flash_decode.ref import decode_attention_ref
    got, lse = fd.flash_decode(q, k, v, lengths, lse=True)
    want, want_lse = decode_attention_ref(q, k, v, lengths, lse=True)
    if q.is_cuda:
        torch.cuda.synchronize()
    atol, rtol = FD_TOL[q.dtype]
    live = lengths > 0
    empty_ok = bool((got[~live] == 0).all() and
                    torch.isneginf(lse[~live]).all())

    def reading(a, b):
        if not a.numel():
            return 0.0
        if not bool(torch.isfinite(a).all()):
            return math.inf
        return ((a - b).abs() / (atol + rtol * b.abs())).max().item()

    return {"lengths": lengths.tolist(),
            "out_max_abs_err": (got - want).abs().max().item(),
            "out_reading": reading(got[live], want[live]),
            "lse_reading": reading(lse[live], want_lse[live]),
            "empty_rows_exact": empty_ok, "tol": FD_TOL_TEXT}


def shard_seq_decode(rank: int, mesh, pctx, dev) -> dict:
    """Phase 28 (f) on this rank (SEQ_DECODE): the sharded decode over
    caches split over data, its launches and collective bytes against the
    dry run's reckoning of this rank for the same cut cell, the kernel's
    lse form on the rank's own block; rank 0's unsharded bf16 decode on the
    whole twin and its float32 twin's distance, and every rank's logits and
    caches read against them."""
    import torch.distributed as dist

    from repro_torch import tree as tree_util
    from repro_torch.config import ShapeConfig
    from repro_torch.core import collectives
    from repro_torch.kernels.allreduce_combine import kernel as ck
    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model
    from repro_torch.parallel.sharding import Sharding, cache_specs, is_spec
    from repro_torch.parallel.tensor_parallel import keep_gathered

    sd = SEQ_DECODE
    on_card = dev.type == "cuda"
    world = dist.get_world_size()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    cfg = shard_family_config(sd["arch"], sd["cut"])
    model = build_model(cfg)
    S, n, pos0 = sd["window"], sd["steps"], sd["pos"]
    shape = ShapeConfig("long_500k", S, 1, "decode")
    ctx = dataclasses.replace(pctx, decode_shape=(1, S))
    t_draw = time.perf_counter()
    params, draw, _, _, _ = _drawn_blocks(model, rank, mesh, pctx, dev)
    cmeta = model.init_cache(1, S, device="meta")
    cspecs = tree_util.leaves(cache_specs(cmeta, cfg, shape, pctx),
                              is_leaf=is_spec)
    seeds = [sd["seed"] + 100_000 * i for i in range(len(cspecs))]
    caches = tree_util.unflatten(cmeta, [
        _seq_blocks(t, sp, mesh, seed, dev, mesh.coords)
        for t, sp, seed in zip(tree_util.leaves(cmeta), cspecs, seeds)])
    sync()
    draw_s = time.perf_counter() - t_draw
    toks = torch.from_numpy(np.random.default_rng(sd["seed"]).integers(
        0, cfg.vocab_size, n)).to(dev)
    local = {k: list(t.shape) for k, t in tree_util.named_leaves(caches)}

    # ---- the sharded decode: counts set to 0 just before, read just after
    outs, wires = [], []
    sync()
    dist.barrier()
    ck.launches = fd.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad(), keep_gathered():
        for i in range(n):
            with collectives.counting() as wire:
                lg, caches = model.decode_step(params, caches, {
                    "token": toks[i:i + 1], "pos": pos0 + i}, ctx)
            outs.append(lg)
            wires.append(wire)
    sync()
    wall = time.perf_counter() - t0
    fd_n, ck_n = fd.launches, ck.launches
    logits = torch.cat(outs, dim=1)

    # ---- this rank's reckoning by the dry run: the same cut cell
    cell, meta = dryrun.lower_cell(cfg, shape, False,
                                   mesh_shape=SHARD["mesh"], rank=rank)
    dry = dryrun.analyze(cell, meta)
    out = {"arch": sd["arch"], "cut": sd["cut"], "window": S, "pos": pos0,
           "steps": n, "draw_s": draw_s, "local_caches": local,
           "ms_per_decode_step": wall / n * 1e3,
           "flash_decode_launches": fd_n, "combine_launches": ck_n,
           "finite": bool(torch.isfinite(logits).all().item()),
           "wire_by_step": [{"bytes": w["bytes"], "by_op": w["by_op"]}
                            for w in wires],
           "dryrun": {"bytes": {k: dry["collective_bytes"][k]
                                for k in collectives.KINDS},
                      "by_op": dry["collective_bytes"]["by_op"],
                      "kernels": dry["kernels"],
                      "trace_s": dry["trace_s"]}}

    # ---- the kernel's lse form on this rank's own block of group 0, at
    # the local lengths of the first and the last step, the ranks in turns
    # (the plain version widens the 1.3 GB block to float32)
    blk = ctx.kv_seq_block(caches["attn"]["k"].shape[2])
    start = 0 if blk is None else blk[0]
    S_l = caches["attn"]["k"].shape[2]
    H_l = cfg.n_heads // pctx.tp_size
    q = torch.from_numpy(np.random.default_rng(sd["seed"] + rank)
                         .standard_normal((1, H_l, cfg.resolved_head_dim),
                                          np.float32)).to(dev, torch.bfloat16)
    out["kernel_checks"] = []
    for r in range(world):
        if r == rank:
            k0 = caches["attn"]["k"][0].contiguous()
            v0 = caches["attn"]["v"][0].contiguous()
            for p in (pos0, pos0 + n - 1):
                ln = torch.tensor([min(max(p + 1 - start, 0), S_l)],
                                  dtype=torch.int32, device=dev)
                out["kernel_checks"].append(
                    _lse_check(fd, q, k0, v0, ln) if on_card
                    else {"lengths": ln.tolist()})
            del k0, v0
            if on_card:
                torch.cuda.empty_cache()
        dist.barrier()

    # ---- rank 0: the unsharded decode on the whole twin (bf16), then its
    # float32 twin from the same draw (the K/V widened in place: the
    # positions the bf16 run wrote are written again before they are read)
    payload = [None]
    if rank == 0:
        whole = tree_util.unflatten(cmeta, [
            _seq_blocks(t, sp, mesh, seed, dev)
            for t, sp, seed in zip(tree_util.leaves(cmeta), cspecs, seeds)])
        states0 = [t.clone() for t in tree_util.leaves(whole["ssm"])]
        full = draw()

        def run(m, p, c):
            res = []
            with torch.no_grad():
                for i in range(n):
                    lg, c = m.decode_step(p, c, {"token": toks[i:i + 1],
                                                 "pos": pos0 + i})
                    res.append(lg)
            return torch.cat(res, dim=1).float()

        def new_part(c):
            # what the steps change: the written K/V rows, the states
            return {k: (t[:, :, pos0:pos0 + n] if k.startswith("attn")
                        else t).clone()
                    for k, t in tree_util.named_leaves(c)}

        l16 = run(model, full, whole)
        c16 = new_part(whole)
        _widen_(whole["attn"])
        whole["ssm"] = tree_util.unflatten(   # the states as drawn, widened
            whole["ssm"], [t.float() for t in states0])
        del states0
        _widen_(full)
        model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
        l32 = run(model32, full, whole)
        c32 = new_part(whole)
        del whole, full
        if on_card:
            torch.cuda.empty_cache()
        payload[0] = {
            "logits": l16.cpu(), "caches": {k: t.cpu() for k, t in
                                            c16.items()},
            "noise": {"logits": (l16 - l32).abs().max().item(),
                      "caches": {k: (c16[k].float() - c32[k].float()).abs()
                                 .max().item() for k in c16}}}
        del c16, c32
    dist.broadcast_object_list(payload, src=0)
    ref = payload[0]
    noise = ref["noise"]
    out["bf16_noise"] = noise
    out["logits_reading"] = _noisy_reading(logits.cpu(), ref["logits"],
                                           noise["logits"], SHARD_BF16_TOL)
    out["logits_max_abs_err"] = (logits.cpu().float() - ref["logits"]).abs(
        ).max().item()

    # ---- this rank's caches against its blocks of the unsharded ones,
    # the ranks in turns: the rows the steps wrote here against the
    # unsharded run's rows, every other K/V row bit for bit as drawn; the
    # states against the unsharded run's final ones
    reads = {}
    for r in range(world):
        if r != rank:
            dist.barrier()
            continue
        for (k, t), tm, sp, seed in zip(tree_util.named_leaves(caches),
                                        tree_util.leaves(cmeta), cspecs,
                                        seeds):
            at = Sharding(mesh, sp).slices(tm.shape, mesh.coords)
            if k.startswith("attn"):
                got_rows = [(i, pos0 + i - at[2].start) for i in range(n)
                            if 0 <= pos0 + i - at[2].start < t.shape[2]]
                steps = [i for i, _ in got_rows]
                rows = [p for _, p in got_rows]
                want_rows = ref["caches"][k][
                    (slice(None), slice(None), steps) + at[3:]].to(dev)
                drawn = _seq_blocks(tm, sp, mesh, seed, dev, mesh.coords)
                drawn[:, :, rows] = t[:, :, rows]
                same = bool(torch.equal(drawn, t))
                del drawn
                got, want = t[:, :, rows], want_rows
            else:
                same = True
                got, want = t, ref["caches"][k][at].to(dev)
            reading = _noisy_reading(got, want, noise["caches"][k],
                                     SHARD_BF16_TOL) if got.numel() else 0.0
            reads[k] = {"reading": reading if same else math.inf,
                        "unwritten_rows_as_drawn": same,
                        "max_abs_err": (got.float() - want.float()).abs()
                        .max().item() if got.numel() else 0.0}
        if on_card:
            torch.cuda.empty_cache()
        dist.barrier()
    out["cache_readings"] = reads
    del caches, params
    if on_card:
        torch.cuda.empty_cache()
    return out


def shard_worker(rank: int, port: int, out_dir: str,
                 dev_name: str = "cuda") -> None:
    """One rank of the shard phase (run by torch.multiprocessing, spawn)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    import torch.nn.functional as F

    from repro_torch import tree as tree_util
    from repro_torch.checkpoint.store import save_checkpoint
    from repro_torch.configs import get
    from repro_torch.core import collectives
    from repro_torch.data.pipeline import SyntheticTokens, shard_batch
    from repro_torch.kernels.allreduce_combine import kernel as ck
    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.kernels.flash_decode.ops import decode_attn
    from repro_torch.kernels.flash_decode.ref import decode_attention_ref
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model, moe
    from repro_torch.models.layers import apply_norm, embed_tokens
    from repro_torch.models.transformer import layer_specs
    from repro_torch.parallel.ctx import make_parallel_ctx
    from repro_torch.parallel.grad_sync import plan_sharded_sync
    from repro_torch.parallel.sharding import (Sharding, Spec, gather_tree,
                                               is_spec, opt_state_specs,
                                               param_specs, spec_axes)
    from repro_torch.parallel.tensor_parallel import (gather_dims,
                                                      keep_gathered,
                                                      sum_across)
    from repro_torch.runtime.fault import elastic_reshard
    from repro_torch.train.loop import Trainer, shardings_of
    from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                             adamw_update)

    on_card = dev_name == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(0)
    dev = torch.device(dev_name, 0) if on_card else torch.device("cpu")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=SHARD["world"], rank=rank,
                            timeout=datetime.timedelta(seconds=600))
    t_lap = [time.perf_counter()]
    sections: dict = {}

    def lap(name):
        now = time.perf_counter()
        sections[name] = now - t_lap[0]
        t_lap[0] = now

    try:
        mesh = make_mesh(SHARD["mesh"], ("pod", "data", "model"), device=dev)
        pctx = make_parallel_ctx(mesh)
        rec: dict = {"rank": rank, "coords": mesh.coords}
        lap("mesh")
        cfg = get(SHARD["arch"])
        model = build_model(cfg)
        opt_cfg = AdamWConfig(lr=SHARD["lr"], warmup_steps=1, decay_steps=10)
        tr = Trainer(model, opt_cfg, pctx=pctx, device=dev)
        # drawn on the card (the host's one stream is slow for 8 ranks at
        # once); the same seed on every rank gives every rank the same tree
        full = {"params": model.init(torch.Generator(dev).manual_seed(0),
                                     device=dev)}
        full["opt"] = adamw_init(full["params"], opt_cfg)
        state = tr.shard_state(full)
        specs = param_specs(full["params"], cfg, pctx)
        ospecs = opt_state_specs(full["opt"], full["params"], cfg, pctx)
        lap("init")

        # bytes a rank holds against the reckoning from the specs
        def nbytes(tree):
            return sum(t.numel() * t.element_size()
                       for t in tree_util.leaves(tree))

        def reckoned(tree, sp):
            tot = 0
            for t, s in zip(tree_util.leaves(tree),
                            tree_util.leaves(sp, is_leaf=is_spec)):
                tot += (t.numel() * t.element_size()
                        // math.prod(Sharding(mesh, s).parts(t.shape)))
            return tot

        both = [(t, s) for t, s in zip(
            tree_util.leaves(full["params"]),
            tree_util.leaves(specs, is_leaf=is_spec))
            if {"data", "model"} <= {a for e in s for a in spec_axes(e)}]
        both_local = [t for t, s in zip(
            tree_util.leaves(state["params"]),
            tree_util.leaves(specs, is_leaf=is_spec))
            if {"data", "model"} <= {a for e in s for a in spec_axes(e)}]
        rec["bytes"] = {
            "params": nbytes(state["params"]),
            "params_reckoned": reckoned(full["params"], specs),
            "params_full": nbytes(full["params"]),
            "moments": nbytes(state["opt"]),
            "moments_reckoned": reckoned(full["opt"], ospecs),
            "moments_full": nbytes(full["opt"]),
            "data_model_leaves": len(both),
            "data_model_share": (sum(t.numel() for t in both_local)
                                 / max(1, sum(t.numel() for t, _ in both)))}

        # ---- (a) sharded train steps
        data = SyntheticTokens(cfg, batch=SHARD["global_batch"],
                               seq=SHARD["seq"], device=dev)
        shardings = shardings_of(model, pctx)
        plan, n_pod = plan_sharded_sync(state["params"], shardings, mesh)
        want = shard_expected_combines(model, pctx, plan, n_pod)
        rec["plan"] = dict(collections.Counter(plan))
        rec["pod_buckets"] = n_pod
        rec["expected_combines"] = want
        seen = {}
        sync_fn = tr.make_sync()

        def capture(g):
            seen["g"] = sync_fn(g)
            return seen["g"]

        step = tr.make_step(sync_fn=capture)
        rec["steps"] = []
        for i in range(SHARD["steps"]):
            batch = data.batch_at(i)
            local_b = shard_batch(batch, pctx)
            sync()
            dist.barrier()
            ck.launches = 0
            other = step_peak_start(on_card, (state, local_b))
            t0 = time.perf_counter()
            with collectives.counting() as wire:
                state, m = step(state, local_b)
            sync()
            wall = time.perf_counter() - t0
            launches = ck.launches
            rec["steps"].append({"loss": float(m["loss"]), "wall_s": wall,
                                 "combine_launches": launches,
                                 "wire_bytes": dict(wire["bytes"]),
                                 "peak_bytes": step_peak(on_card, other)})
            if i == 0:
                p1 = gather_tree(state["params"], specs, mesh)
                g1 = gather_tree(seen["g"], specs, mesh)
                if rank == 0:
                    ref_tr = Trainer(model, opt_cfg, device=dev)
                    got0 = {}

                    def cap0(g):
                        got0["g"] = g
                        return g

                    s0, m0 = ref_tr.make_step(sync_fn=cap0)(full, batch)
                    # the unsharded AdamW on the sharded step's own synced
                    # gradients: what the sharded optimizer must have done
                    p1e, _, me = adamw_update(g1, full["opt"],
                                              full["params"], opt_cfg)
                    sync()
                    reads = {}
                    for (n, a), (_, b), (_, ga), (_, gb), (_, e), (_, w0) \
                            in zip(tree_util.named_leaves(p1),
                                   tree_util.named_leaves(s0["params"]),
                                   tree_util.named_leaves(g1),
                                   tree_util.named_leaves(got0["g"]),
                                   tree_util.named_leaves(p1e),
                                   tree_util.named_leaves(full["params"])):
                        reads[n] = {
                            "param": _close_reading(a, b, SHARD_STEP_TOL),
                            "param_max_abs": (a.float() - b.float()).abs()
                            .max().item(),
                            "grad_rel": ((ga.float() - gb.float()).abs().max()
                                         / gb.float().abs().max()
                                         .clamp(min=1e-30)).item(),
                            **_update_reading(a, e, w0)}
                    rec["step0"] = {
                        "loss_sharded": float(m["loss"]),
                        "loss_unsharded": float(m0["loss"]),
                        "grad_norm_sharded": float(m["grad_norm"]),
                        "grad_norm_gathered": float(me["grad_norm"]),
                        "grad_norm_rel": abs(float(m["grad_norm"])
                                             / float(me["grad_norm"]) - 1),
                        "leaves": reads,
                        "worst_param_reading": max(r["param"]
                                                   for r in reads.values()),
                        "worst_grad_rel": max(r["grad_rel"]
                                              for r in reads.values()),
                        "worst_update_rel": max(r["update_rel"]
                                                for r in reads.values()),
                        "leaves_moved": sum(r["moved_share"] > 0
                                            for r in reads.values()),
                        "leaves_n": len(reads)}
                    del s0, got0, p1e
                del p1, g1
            # a block is held by the ranks that differ only by pod: bit for
            # bit the same there; replicated leaves the same on every rank
            digest = _digest(state["params"])
            rep = _digest({n: t for (n, t), s in zip(
                tree_util.named_leaves(state["params"]),
                tree_util.leaves(specs, is_leaf=is_spec)) if not any(s)})
            both_d = [None] * SHARD["world"]
            dist.all_gather_object(both_d, (mesh.coords, digest, rep))
            by_block: dict = {}
            for c, dg, _ in both_d:
                by_block.setdefault((c["data"], c["model"]), set()).add(dg)
            rec["steps"][-1]["blocks_equal_across_pods"] = all(
                len(v) == 1 for v in by_block.values())
            rec["steps"][-1]["replicated_equal_everywhere"] = len(
                {r for *_, r in both_d}) == 1
        lap("train")

        # ---- (a) seq_shard: one step with the residual stream cut over
        # model between blocks, beside the same step without it, from the
        # same state and batch
        local_b = shard_batch(data.batch_at(SHARD["steps"]), pctx)
        seq_runs = {}
        for on in (False, True):
            tr_s = Trainer(model, opt_cfg, device=dev,
                           pctx=dataclasses.replace(pctx, seq_shard=on))
            got_s, sync_s = {}, tr_s.make_sync()

            def cap_s(g, sync_s=sync_s, got_s=got_s):
                got_s["g"] = sync_s(g)
                return got_s["g"]

            step_s = tr_s.make_step(sync_fn=cap_s)
            sync()
            dist.barrier()
            ck.launches = 0
            other = step_peak_start(on_card, (state, local_b))
            with collectives.counting() as wire:
                new_s, m_s = step_s(state, local_b)
            sync()
            seq_runs[on] = {"loss": m_s["loss"], "grads": got_s["g"],
                            "params": new_s["params"],
                            "combine_launches": ck.launches,
                            "peak_bytes": step_peak(on_card, other),
                            "wire": wire}
            del new_s
        off_s, on_s = seq_runs[False], seq_runs[True]

        def bitwise(a, b):
            return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in
                       zip(tree_util.leaves(a), tree_util.leaves(b),
                           strict=True))

        rec["seq_shard"] = {
            "loss": [float(off_s["loss"]), float(on_s["loss"])],
            "loss_equal": torch.equal(off_s["loss"], on_s["loss"]),
            "grads_equal": bitwise(off_s["grads"], on_s["grads"]),
            "params_equal": bitwise(off_s["params"], on_s["params"]),
            "combine_launches": [off_s["combine_launches"],
                                 on_s["combine_launches"]],
            "peak_bytes": [off_s["peak_bytes"], on_s["peak_bytes"]],
            "wire_bytes": [dict(off_s["wire"]["bytes"]),
                           dict(on_s["wire"]["bytes"])],
            "seq_gather_bytes": on_s["wire"]["by_op"].get("seq_gather", 0)}
        del seq_runs, off_s, on_s
        # this rank's reckoning by the dry run, on meta: the same steps
        # (Trainer's functional step, the same mesh rank), off and on
        from repro_torch.config import ShapeConfig
        from repro_torch.launch import dryrun
        shp = ShapeConfig("shard_a", SHARD["seq"], SHARD["global_batch"],
                          "train")
        rec["dryrun"] = {}
        for on in (False, True):
            cell, meta = dryrun.lower_cell(
                cfg, shp, False, {"seq_shard": on}, mesh_shape=SHARD["mesh"],
                rank=rank, donate=False)
            r_ = dryrun.analyze(cell, meta)
            rec["dryrun"]["on" if on else "off"] = {
                "wire_bytes": {k: r_["collective_bytes"][k]
                               for k in collectives.KINDS},
                "by_op": r_["collective_bytes"]["by_op"],
                "peak_bytes": r_["memory"]["peak_bytes"],
                "combine_calls": r_["kernels"]["combine"]["calls"],
                "trace_s": r_["trace_s"]}
        lap("seq_shard_and_dryrun")

        # ---- (b) sharded prefill, then decode
        pr, nd = SHARD["prompt"], SHARD["decode"]
        toks = SyntheticTokens(cfg, batch=SHARD["global_batch"],
                               seq=pr + nd, seed=5, device=dev).batch_at(0)
        local = shard_batch(toks, pctx)["tokens"]
        with torch.no_grad(), keep_gathered():
            lg, caches = model.prefill(state["params"],
                                       {"tokens": local[:, :pr]}, pctx)
            caches = tree_util.tree_map(lambda t: F.pad(
                t, (0, 0, 0, 0, 0, nd)).contiguous(), caches)
            sync()
            fd.launches = 0
            t0 = time.perf_counter()
            outs = [lg]
            for i in range(nd):
                lg, caches = model.decode_step(
                    state["params"], caches,
                    {"token": local[:, pr + i], "pos": pr + i}, pctx)
                outs.append(lg)
            sync()
            dec_wall = time.perf_counter() - t0
            fd_launches = fd.launches
            logits = torch.cat(outs, dim=1)
            # the kernel on this rank's own layer-0 cache, against its plain
            # version (rows at the full length and at 300)
            k0, v0 = caches["dense"]["k"][0], caches["dense"]["v"][0]
            g = torch.Generator(device=dev).manual_seed(28 + rank)
            B_l, K_l = k0.shape[0], k0.shape[2]
            q = torch.randn((B_l, K_l * (cfg.n_heads // cfg.n_kv_heads),
                             k0.shape[3]), generator=g, device=dev
                            ).to(k0.dtype)
            lengths = torch.tensor([pr + nd, 300][:B_l], dtype=torch.int32,
                                   device=dev)
            got = decode_attn(q, k0, v0, lengths)
            want_fd = decode_attention_ref(q, k0, v0, lengths)
            sync()
        rec["decode"] = {
            "local_cache": list(caches["dense"]["k"].shape),
            "flash_decode_launches": fd_launches,
            "launches_per_decode_step": fd_launches / nd,
            "ms_per_decode_step": dec_wall / nd * 1e3,
            "cache_check": {"max_abs_err": (got.float() - want_fd.float())
                            .abs().max().item(),
                            "reading": fd_reading(got, want_fd),
                            "lengths": lengths.tolist()}}
        all_logits = [None] * SHARD["world"]
        dist.all_gather_object(all_logits, (mesh.coords, logits.cpu()))
        full_params = gather_tree(state["params"], specs, mesh)
        if rank == 0:
            with torch.no_grad():
                lg, c0 = model.prefill(full_params, {"tokens":
                                                     toks["tokens"][:, :pr]})
                c0 = tree_util.tree_map(lambda t: F.pad(
                    t, (0, 0, 0, 0, 0, nd)).contiguous(), c0)
                outs = [lg]
                for i in range(nd):
                    lg, c0 = model.decode_step(full_params, c0, {
                        "token": toks["tokens"][:, pr + i], "pos": pr + i})
                    outs.append(lg)
                ref_logits = torch.cat(outs, dim=1).cpu()
            per = SHARD["global_batch"] // pctx.dp_size
            reading, err = 0.0, 0.0
            for c, lgt in all_logits:
                row = c["pod"] * mesh.shape["data"] + c["data"]
                w = ref_logits[row * per:(row + 1) * per]
                reading = max(reading, _close_reading(lgt, w,
                                                      SHARD_BF16_TOL))
                err = max(err, (lgt.float() - w.float()).abs().max().item())
            rec["decode"]["logits_vs_unsharded"] = {
                "reading": reading, "max_abs_err": err,
                "max_abs_logit": ref_logits.abs().max().item()}
            del c0
        del caches, full_params
        lap("decode")

        # ---- (d) elastic reshard of the trained state
        m1 = make_mesh(SHARD["reshard"][0], ("data", "model"), device=dev)
        m2 = make_mesh(SHARD["reshard"][1], ("data", "model"), device=dev)
        whole = {"params": gather_tree(state["params"], specs, mesh),
                 "opt": gather_tree(state["opt"], ospecs, mesh)}

        def layout(m):
            c = make_parallel_ctx(m)
            sp = {"params": param_specs(whole["params"], cfg, c),
                  "opt": opt_state_specs(whole["opt"], whole["params"], cfg,
                                         c)}
            return tree_util.unflatten(whole, [
                Sharding(m, x) for x in tree_util.leaves(sp,
                                                         is_leaf=is_spec)])

        def cut(shs):
            return tree_util.unflatten(whole, [
                s.shard(t) for s, t in zip(
                    tree_util.leaves(shs,
                                     is_leaf=lambda x: isinstance(x,
                                                                  Sharding)),
                    tree_util.leaves(whole))])

        sh1, sh2 = layout(m1), layout(m2)
        ckpt = Path(out_dir) / "shard_ckpt"
        t0 = time.perf_counter()
        save_checkpoint(str(ckpt), 3, cut(sh1), shardings=sh1)
        save_s = time.perf_counter() - t0
        tmpl = tree_util.tree_map(lambda t: torch.empty(
            t.shape, dtype=t.dtype, device="meta"), whole)
        t0 = time.perf_counter()
        restored = elastic_reshard(str(ckpt), 3, tmpl, sh2)
        restore_s = time.perf_counter() - t0
        want2 = cut(sh2)
        equal = all(a.dtype == b.dtype and a.device == b.device
                    and torch.equal(a, b) for a, b in zip(
                        tree_util.leaves(restored), tree_util.leaves(want2)))
        rec["reshard"] = {"from": dict(m1.shape), "to": dict(m2.shape),
                          "leaves": len(tree_util.leaves(want2)),
                          "bitwise_equal": equal, "save_s": save_s,
                          "restore_s": restore_s,
                          "local_bytes": nbytes(restored)}
        del whole, restored, want2, state, full
        dist.barrier()
        if rank == 0:
            shutil.rmtree(ckpt, ignore_errors=True)
        lap("reshard")

        # ---- (c) granite's MoE layer: EP over data, TP over model
        mcfg = dataclasses.replace(get(SHARD["moe_arch"]),
                                   n_layers=SHARD["moe_layers"])
        mmodel = build_model(mcfg)
        mfull = mmodel.init(torch.Generator(dev).manual_seed(0), device=dev)
        layer0 = tree_util.tree_map(lambda t: t[0], mfull["moe_stack"])
        mtoks = SyntheticTokens(mcfg, batch=SHARD["global_batch"],
                                seq=SHARD["seq"], device=dev).batch_at(0)
        with torch.no_grad():
            x_all = apply_norm(layer0["ln2"], embed_tokens(
                mfull["embed"], mtoks["tokens"], mcfg), mcfg)
        del mfull
        gy = torch.Generator(device=dev).manual_seed(29)
        dy_all = torch.randn(x_all.shape, generator=gy, device=dev)
        per = SHARD["global_batch"] // pctx.dp_size
        row = mesh.coords["pod"] * mesh.shape["data"] + mesh.coords["data"]
        rows = slice(row * per, (row + 1) * per)
        fspecs = layer_specs(mcfg, "moe", pctx)["ffn"]
        names = [n for n, _ in tree_util.named_leaves(layer0["ffn"])]
        fspec = dict(zip(names, tree_util.leaves(fspecs, is_leaf=is_spec)))

        def store(n):
            s = fspec[n]
            if n in ("w_gate", "w_up", "w_out"):
                return Sharding(mesh, s)            # experts: as stored
            return Sharding(mesh, Spec(*(None if e == "data" else e
                                         for e in s)))  # as _unfsdp leaves

        lay = {n: store(n) for n in names}
        p = tree_util.unflatten(layer0["ffn"], [
            lay[n].shard(t).requires_grad_(True)
            for n, t in tree_util.named_leaves(layer0["ffn"])])
        x = x_all[rows].clone().requires_grad_(True)
        ids = []
        route_orig = moe.route

        def route_rec(*a):
            out = route_orig(*a)
            ids.append(out[1].detach())
            return out

        moe.route = route_rec
        try:
            sync()
            ck.launches = 0
            t0 = time.perf_counter()
            y = moe.apply_moe(p, x, mcfg, pctx)
            (y.float() * dy_all[rows]).sum().backward()
            sync()
            moe_wall = time.perf_counter() - t0
            moe_launches = ck.launches
        finally:
            moe.route = route_orig
        grads = {}
        for n, t in tree_util.named_leaves(p):
            gfull = gather_dims(t.grad, lay[n], range(t.dim()))
            expert = n in ("w_gate", "w_up", "w_out")
            grads[n] = sum_across(gfull, mesh.group(
                "pod" if expert else ("pod", "data")))
        mine = (mesh.coords, y.detach().cpu(), x.grad.cpu(), ids[0].cpu())
        every = [None] * SHARD["world"]
        dist.all_gather_object(every, mine)
        rec["moe"] = {"local_experts": int(p["w_gate"].shape[0]),
                      "local_expert_hidden": int(p["w_gate"].shape[2]),
                      "combine_launches": moe_launches,
                      "wall_ms_fwd_bwd": moe_wall * 1e3}
        if rank == 0:
            pf = tree_util.tree_map(lambda t: t.detach().clone()
                                    .requires_grad_(True), layer0["ffn"])
            xf = x_all.clone().requires_grad_(True)
            eids = []

            def route_emul(*a):
                out = route_orig(*a)
                eids.append(out[1].detach())
                return out

            moe.route = route_emul
            try:
                yf = moe.emulate_ep(pf, xf, mcfg, ep=mesh.shape["data"],
                                    pods=mesh.shape["pod"])
            finally:
                moe.route = route_orig
            (yf.float() * dy_all).sum().backward()
            same_routes, ry, rdx = True, 0.0, 0.0
            for c, yy, dx, rid in every:
                r_ = c["pod"] * mesh.shape["data"] + c["data"]
                sl = slice(r_ * per, (r_ + 1) * per)
                same_routes &= bool(torch.equal(
                    rid[0], eids[c["pod"]][c["data"]].cpu()))
                ry = max(ry, _close_reading(yy, yf[sl].detach().cpu(),
                                            SHARD_BF16_TOL))
                rdx = max(rdx, _close_reading(dx, xf.grad[sl].cpu(),
                                              SHARD_BF16_TOL))
            rg = {n: _close_reading(grads[n], t.grad, SHARD_BF16_TOL)
                  for n, t in tree_util.named_leaves(pf)}
            rec["moe"].update({"routes_equal": same_routes,
                               "y_reading": ry, "dx_reading": rdx,
                               "grad_readings": rg})
        lap("moe")

        # ---- (e) the other families
        del mmodel, layer0, p, x, x_all, dy_all, grads, y
        if rank == 0:
            del pf, xf, yf
        if on_card:
            torch.cuda.empty_cache()
        rec["families"] = {}
        for fam in SHARD_FAMILIES:
            rec["families"][fam[0]] = shard_family(fam, rank, mesh, pctx,
                                                   dev)
            if on_card:
                torch.cuda.empty_cache()
            lap(fam[0])
            # what has run so far, should a later family fail
            (Path(out_dir) / f"shard_rank{rank}.partial.json").write_text(
                json.dumps({**rec, "sections_s": sections}))
        # ---- (f) zamba2-2.7b over the long_500k window, its caches split
        # over data
        rec["seq_decode"] = shard_seq_decode(rank, mesh, pctx, dev)
        lap("seq_decode")
        rec["sections_s"] = sections
        (Path(out_dir) / f"shard_rank{rank}.json").write_text(
            json.dumps(rec))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def shard_phase(smi: str) -> dict:
    """Phase 28: spawn the eight ranks, read their records, emit the line,
    hold the gates; returns the readings of combine and flash_decode for the
    kernels line."""
    from repro_torch.configs import get
    for f in OUT.glob("shard_rank*.json"):
        f.unlink()
    t0 = time.perf_counter()
    # eight ranks share the card: blocks freed by one family are reused by
    # the next without stranding reserved memory between them
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        torch.multiprocessing.start_processes(
            shard_worker, args=(free_port(), str(OUT)),
            nprocs=SHARD["world"], join=True, start_method="spawn")
    finally:
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    wall = time.perf_counter() - t0
    ranks = [json.loads((OUT / f"shard_rank{r}.json").read_text())
             for r in range(SHARD["world"])]
    r0 = ranks[0]
    want = r0["expected_combines"]["total"]
    emit({"phase": "shard", "arch": SHARD["arch"],
          "mesh": dict(zip(("pod", "data", "model"), SHARD["mesh"])),
          "backend": "gloo", "device_per_rank": "cuda:0",
          "global_batch": SHARD["global_batch"], "seq": SHARD["seq"],
          "coords": [r["coords"] for r in ranks],
          "bytes_per_rank": {r["rank"]: r["bytes"] for r in ranks},
          "plan": r0["plan"], "pod_buckets": r0["pod_buckets"],
          "expected_combines_per_step": r0["expected_combines"],
          "steps": {r["rank"]: r["steps"] for r in ranks},
          "step0": {k: v for k, v in r0["step0"].items() if k != "leaves"},
          "step0_leaves": r0["step0"]["leaves"],
          "decode": {r["rank"]: r["decode"] for r in ranks},
          "moe": {r["rank"]: r["moe"] for r in ranks},
          "reshard": {r["rank"]: r["reshard"] for r in ranks},
          "seq_shard": {r["rank"]: r["seq_shard"] for r in ranks},
          "dryrun": {r["rank"]: r["dryrun"] for r in ranks},
          "sections_s_rank0": r0["sections_s"], "wall_s": wall,
          "tolerances": {"step": SHARD_STEP_TOL, "bf16": SHARD_BF16_TOL,
                         "grad": SHARD_GRAD_TOL, "update": SHARD_UPDATE_TOL,
                         "norm": SHARD_NORM_TOL,
                         "flash_decode": FD_TOL_TEXT},
          "card": smi})
    bad = []
    s0 = r0["step0"]
    if not abs(s0["loss_sharded"] - s0["loss_unsharded"]) < SHARD_STEP_TOL:
        bad.append(f"(a) step-0 loss {s0['loss_sharded']} against "
                   f"{s0['loss_unsharded']}")
    if s0["worst_param_reading"] > 1 or s0["worst_grad_rel"] > SHARD_GRAD_TOL:
        bad.append(f"(a) updated leaves (reading {s0['worst_param_reading']})"
                   f" or synced gradients ({s0['worst_grad_rel']})")
    if (s0["worst_update_rel"] > SHARD_UPDATE_TOL
            or s0["grad_norm_rel"] > SHARD_NORM_TOL
            or s0["leaves_moved"] < s0["leaves_n"] // 2):
        bad.append(f"(a) the sharded AdamW against the unsharded one on the "
                   f"same gradients: update {s0['worst_update_rel']}, norm "
                   f"{s0['grad_norm_rel']}, {s0['leaves_moved']} of "
                   f"{s0['leaves_n']} leaves moved")
    for r in ranks:
        b = r["bytes"]
        if (b["params"] != b["params_reckoned"]
                or b["moments"] != b["moments_reckoned"]
                or b["data_model_share"] != 0.25):
            bad.append(f"(a) rank {r['rank']} bytes {b}")
        for i, s in enumerate(r["steps"]):
            if s["combine_launches"] != want:
                bad.append(f"(a) rank {r['rank']} step {i}: "
                           f"{s['combine_launches']} combine launches, "
                           f"the plan says {want}")
            if not (s["blocks_equal_across_pods"]
                    and s["replicated_equal_everywhere"]
                    and math.isfinite(s["loss"])):
                bad.append(f"(a) rank {r['rank']} step {i}: {s}")
        bad += shard_dryrun_gates(r, want)
        d = r["decode"]
        if (d["local_cache"][3] != 2 or d["launches_per_decode_step"]
                != get(SHARD["arch"]).n_layers
                or d["cache_check"]["reading"] > 1):
            bad.append(f"(b) rank {r['rank']}: {d}")
        if not r["reshard"]["bitwise_equal"]:
            bad.append(f"(d) rank {r['rank']}: {r['reshard']}")
        m = r["moe"]
        if m["local_experts"] != 16 or m["local_expert_hidden"] != 256 \
                or m["combine_launches"] == 0:
            bad.append(f"(c) rank {r['rank']}: {m}")
    lv = r0["decode"]["logits_vs_unsharded"]
    if lv["reading"] > 1:
        bad.append(f"(b) logits against the unsharded decode: {lv}")
    m0 = r0["moe"]
    if not (m0["routes_equal"] and m0["y_reading"] <= 1
            and m0["dx_reading"] <= 1
            and max(m0["grad_readings"].values()) <= 1):
        bad.append(f"(c) against emulate_ep: {m0}")
    fam_lines = {}
    for label, *_ in SHARD_FAMILIES:
        fams = [r["families"][label] for r in ranks]
        bad += shard_family_gates(label, fams, ranks)
        fam_lines[label] = {
            "arch": fams[0]["arch"], "cut": fams[0]["cut"],
            "seq": fams[0]["seq"], "patches": fams[0]["patches"],
            "bytes_rank0": fams[0]["bytes"],
            "train": {r["rank"]: f.get("train") for r, f in
                      zip(ranks, fams)},
            "decode": {r["rank"]: f["decode"] for r, f in zip(ranks, fams)},
            "kernel_checks": {r["rank"]: f["kernel_checks"]
                              for r, f in zip(ranks, fams)},
            "unsharded_decode": fams[0]["unsharded_decode"],
            "unsharded_step": {r["rank"]: f["unsharded_step"] for r, f in
                               zip(ranks, fams)
                               if f["unsharded_step"] is not None},
            "bf16_noise": fams[0]["bf16_noise"],
            "section_s_rank0": r0["sections_s"][label]}
    emit({"phase": "shard_families", "families": fam_lines,
          "decode_steps": SHARD_FAMILY_DECODE,
          "tolerances": {"step": SHARD_STEP_TOL, "grad": SHARD_GRAD_TOL,
                         "key_bias_grad": SHARD_GRAD_FLOOR,
                         "bf16": SHARD_BF16_TOL, "ssd_scan": SSD_TC_TIGHT,
                         "flash_decode": FD_TOL_TEXT},
          "card": smi})
    bad += shard_seq_decode_gates(ranks)
    sq0 = r0["seq_decode"]
    emit({"phase": "shard_seq_decode", **{k: sq0[k] for k in (
        "arch", "cut", "window", "pos", "steps", "bf16_noise")},
          "ranks": {r["rank"]: {k: v for k, v in r["seq_decode"].items()
                                if k not in ("arch", "cut", "window", "pos",
                                             "steps", "bf16_noise")}
                    for r in ranks},
          "section_s_rank0": r0["sections_s"]["seq_decode"],
          "tolerances": {"bf16": SHARD_BF16_TOL,
                         "flash_decode": FD_TOL_TEXT},
          "card": smi})
    if bad:
        raise AssertionError("shard: " + "; ".join(bad))
    steps = len(r0["steps"])
    f0 = [r0["families"][label] for label, *_ in SHARD_FAMILIES]
    fam_combine = sum((f.get("train") or {}).get("combine_launches", 0)
                      + f["decode"]["prefill_combine_launches"]
                      + round(f["decode"]["combine_per_decode_step"]
                              * f["decode"]["decode_steps"]) for f in f0)
    fam_fd = sum(f["decode"]["flash_decode_launches"] for f in f0)
    fam_ssd = sum((f.get("train") or {}).get("ssd_scan_launches", 0)
                  + f["decode"]["prefill_ssd_scan_launches"] for f in f0)
    by_fam = {label: f for (label, *_), f in zip(SHARD_FAMILIES, f0)}
    return {"dryrun": {"steps": {r["rank"]: [s["peak_bytes"] for s in
                                             r["steps"]] for r in ranks},
                       "wire_bytes": r0["steps"][0]["wire_bytes"],
                       "seq_shard": {r["rank"]: r["seq_shard"]
                                     for r in ranks},
                       "reckoned": {r["rank"]: r["dryrun"] for r in ranks}},
            "combine": {
                "path": "shard (rank 0): TP sums, ZeRO reduce-scatters, "
                        "sync, norm, loss; every family's step and decode; "
                        "(f)'s merges over data",
                "launches": sum(s["combine_launches"] for s in r0["steps"])
                + sum(r0["seq_shard"]["combine_launches"]) + fam_combine
                + sq0["combine_launches"],
                "launches_per_step": want, "steps": steps,
                "moe_layer_fwd_bwd": m0["combine_launches"],
                "seq_decode_per_decode_step": sq0["combine_launches"]
                / sq0["steps"],
                "families": {k: {"train_step": (f.get("train") or {}).get(
                    "combine_launches"), "prefill": f["decode"][
                    "prefill_combine_launches"], "per_decode_step": f[
                    "decode"]["combine_per_decode_step"]}
                    for k, f in by_fam.items()}},
            "flash_decode": {
                "path": "shard decode (rank 0, 2 of 4 KV heads); every "
                        "family's decode on the rank's heads; (f) the lse "
                        "form on the rank's block of zamba2-2.7b's long_500k "
                        "caches",
                "launches": r0["decode"]["flash_decode_launches"] + fam_fd
                + sq0["flash_decode_launches"],
                "launches_per_decode_step":
                    r0["decode"]["launches_per_decode_step"],
                "reading": r0["decode"]["cache_check"]["reading"],
                "max_abs_err": r0["decode"]["cache_check"]["max_abs_err"],
                "seq_decode": {
                    "lse_launches_per_decode_step":
                        sq0["flash_decode_launches"] / sq0["steps"],
                    "checks": {r["rank"]: r["seq_decode"]["kernel_checks"]
                               for r in ranks}},
                "families": {k: {"per_decode_step": f["decode"][
                    "flash_decode_per_decode_step"], "checks": {
                    n: c for n, c in f["kernel_checks"].items()
                    if n.startswith("flash_decode")}}
                    for k, f in by_fam.items()}},
            "ssd_scan": {
                "path": "shard (rank 0): mamba2-2.7b and zamba2-2.7b on 40 "
                        "of 80 heads, a train step and a prefill",
                "launches": fam_ssd,
                "families": {k: {"train_step": (f.get("train") or {}).get(
                    "ssd_scan_launches"), "prefill": f["decode"][
                    "prefill_ssd_scan_launches"], "check": f[
                    "kernel_checks"].get("ssd_scan")}
                    for k, f in by_fam.items() if f["ssm_layers"]}}}


def shard_dryrun_gates(r: dict, want: int) -> list[str]:
    """Phase 28 (a)'s seq_shard step and dry-run gates on one rank's
    record: the seq_shard step's loss, synced gradients and updated
    parameters bit for bit the step without it, both with ``want``
    combine launches and the seq_shard peak not above the other; every
    counted step's collective bytes by kind equal to the dry run's
    reckoning of this rank exactly, its peak within DRYRUN_BAND."""
    bad, who = [], f"(a) rank {r['rank']}"
    q, dry = r["seq_shard"], r["dryrun"]
    if not (q["loss_equal"] and q["grads_equal"] and q["params_equal"]):
        bad.append(f"{who} seq_shard step not bit for bit: {q}")
    if q["combine_launches"] != [want, want] or \
            dry["on"]["combine_calls"] != want or \
            dry["off"]["combine_calls"] != want:
        bad.append(f"{who} seq_shard combine launches "
                   f"{q['combine_launches']} (dry run {dry}), reckoned "
                   f"{want}")
    if q["seq_gather_bytes"] <= 0:
        bad.append(f"{who} seq_shard gathered no stream")
    peaks = [(f"step {i}", s["wire_bytes"], s["peak_bytes"], "off")
             for i, s in enumerate(r["steps"])]
    peaks += [("seq_shard off", q["wire_bytes"][0], q["peak_bytes"][0],
               "off"),
              ("seq_shard on", q["wire_bytes"][1], q["peak_bytes"][1],
               "on")]
    for name, wire, peak, key in peaks:
        if wire != dry[key]["wire_bytes"]:
            bad.append(f"{who} {name}: collective bytes {wire}, the dry "
                       f"run's {dry[key]['wire_bytes']}")
        if peak is not None and not within_band(dry[key]["peak_bytes"],
                                                peak):
            bad.append(f"{who} {name}: peak {peak} B, the dry run's "
                       f"{dry[key]['peak_bytes']} B")
    if q["peak_bytes"][0] is not None and \
            q["peak_bytes"][1] > q["peak_bytes"][0]:
        bad.append(f"{who} seq_shard peak {q['peak_bytes']}")
    return bad


def shard_family_gates(label: str, fams: list, ranks: list) -> list[str]:
    """The gates of phase 28 (e) for one family, over every rank's record:
    what failed, as text."""
    bad = []
    for r, f in zip(ranks, fams):
        who = f"(e) {label} rank {r['rank']}"
        b, d, n_ssm = f["bytes"], f["decode"], f["ssm_layers"]
        if b["params"] != b["params_reckoned"] or \
                b["caches"] != b["caches_reckoned"] or \
                b.get("moments") != b.get("moments_reckoned"):
            bad.append(f"{who}: bytes {b}")
        t = f.get("train")
        if t is not None:
            if (t["combine_launches"] != t["expected_combines"]["total"]
                    or t["ssd_scan_launches"] != 2 * n_ssm
                    or t["flash_decode_launches"]
                    or not math.isfinite(t["loss"])
                    or not (t["blocks_equal_across_pods"]
                            and t["replicated_equal_everywhere"])
                    or t["leaves_moved"] < t["leaves_n"] // 2):
                bad.append(f"{who} train step: " + json.dumps(
                    {k: v for k, v in t.items() if k != "plan"}))
        attn = {"mamba2": 0, "hybrid": 2, "mla": 0, "encdec": 4,
                "vlm": 2}[label]
        if (d["prefill_ssd_scan_launches"] != n_ssm
                or d["flash_decode_per_decode_step"] != attn
                or not d["finite"]
                or d.get("latent_share", 0.5) != 0.5
                or d.get("rope_share", 0.5) != 0.5
                or (n_ssm and d["ssm_state_heads"] * SHARD["mesh"][2]
                    != f["ssm_heads"])):
            bad.append(f"{who} decode: {d}")
        for name, c in f["kernel_checks"].items():
            over = (c["rel_err_vs_ssd_chunked_tc"] > c["tol"]
                    if name == "ssd_scan" else c["reading"] > 1)
            if over:
                bad.append(f"{who} {name}: {c}")
        ud = fams[0]["unsharded_decode"][str(r["rank"])]
        if ud["logits_reading"] > 1 or max(
                c["reading"] for c in ud["cache_readings"].values()) > 1:
            bad.append(f"{who} against the unsharded decode: {ud}")
        s = f["unsharded_step"]
        if t is not None and s is not None:
            if not (abs(t["loss"] - s["loss_unsharded"]) < SHARD_STEP_TOL
                    and s["worst_param_reading"] <= 1
                    and s["worst_grad_rel"] <= SHARD_GRAD_TOL
                    and s["worst_zero_grad_share"] <= SHARD_GRAD_FLOOR):
                bad.append(f"{who} against the unsharded step: loss "
                           f"{t['loss']} / {s['loss_unsharded']}, param "
                           f"{s['worst_param_reading']}, grad "
                           f"{s['worst_grad_rel']} ({s['worst_grad_leaf']}), "
                           f"key biases {s['worst_zero_grad_share']}")
    stepped = sum(f["unsharded_step"] is not None for f in fams)
    if len(fams[0]["unsharded_decode"]) != len(fams) or stepped != (
            4 if fams[0].get("train") else 0):
        bad.append(f"(e) {label}: the unsharded decode read "
                   f"{len(fams[0]['unsharded_decode'])} ranks, the step "
                   f"{stepped}")
    return bad


def shard_seq_decode_gates(ranks: list) -> list[str]:
    """The gates of phase 28 (f) over every rank's record: what failed, as
    text. Per rank: flash_decode's lse form launched twice a decode_step
    (the shared block's two uses) and combine as often as the dry run
    reckons for this rank's cut cell; every step's collective bytes by op
    the dry run's, but for the weight gathers, which keep_gathered makes
    once (the first step) where the dry run's one step makes them every
    use; the merge's bytes on every step; the local K/V block 262,144
    positions of 16 heads; logits and caches against the unsharded decode
    (SHARD_BF16_TOL beyond twice the bf16 run's distance from its float32
    twin); the kernel on the rank's own block, empty rows exact."""
    from repro_torch.configs import get
    bad = []
    for r in ranks:
        f, who = r["seq_decode"], f"(f) rank {r['rank']}"
        dry, n = f["dryrun"], f["steps"]
        kern = dry["kernels"]
        fd_calls = kern.get("flash_decode_lse", {}).get("calls", 0)
        if (fd_calls != 2 or "flash_decode" in kern
                or f["flash_decode_launches"] != n * fd_calls):
            bad.append(f"{who}: {f['flash_decode_launches']} flash_decode "
                       f"launches in {n} steps, the dry run {kern}")
        if f["combine_launches"] != n * kern["combine"]["calls"]:
            bad.append(f"{who}: {f['combine_launches']} combine launches in "
                       f"{n} steps, the dry run {kern['combine']}")
        want = {k: v for k, v in dry["by_op"].items() if k != "weight_gather"}
        for i, w in enumerate(f["wire_by_step"]):
            got = {k: v for k, v in w["by_op"].items() if k != "weight_gather"}
            if (got != want or w["by_op"].get("kv_seq_merge", 0) <= 0
                    or (w["by_op"].get("weight_gather", 0) > 0) != (i == 0)
                    or w["bytes"]["all_to_all"] != dry["bytes"]["all_to_all"]
                    or w["bytes"]["all_reduce"] != dry["bytes"]["all_reduce"]):
                bad.append(f"{who} step {i}: collective bytes {w}, the dry "
                           f"run's {dry['by_op']}")
        if f["local_caches"]["attn.k"][2:4] != [
                SEQ_DECODE["window"] // SHARD["mesh"][1],
                get(SEQ_DECODE["arch"]).n_kv_heads // SHARD["mesh"][2]]:
            bad.append(f"{who}: local caches {f['local_caches']}")
        if not f["finite"] or f["logits_reading"] > 1 or max(
                c["reading"] for c in f["cache_readings"].values()) > 1:
            bad.append(f"{who} against the unsharded decode: logits "
                       f"{f['logits_reading']}, caches "
                       f"{f['cache_readings']}")
        for c in f["kernel_checks"]:
            if "out_reading" in c and not (
                    c["out_reading"] <= 1 and c["lse_reading"] <= 1
                    and c["empty_rows_exact"]):
                bad.append(f"{who} flash_decode lse form: {c}")
    lens = {c["lengths"][0] for r in ranks
            for c in r["seq_decode"]["kernel_checks"]}
    if 0 not in lens or SEQ_DECODE["window"] // SHARD["mesh"][1] not in lens:
        bad.append(f"(f) the kernel checks' lengths {sorted(lens)} miss the "
                   "empty or the full block")
    return bad


# ------------------------------------------------ encoder-decoder and VLM
def family_train_phase(phase: str, train: dict, model, state, step_fn, data,
                       smi: str, **extra) -> dict:
    """``train``'s steps of ``step_fn`` (the whisper_train and vlm_train
    phases): every loss finite, the mean loss of the held-out batches
    falling by min_drop, and no flash_decode launch (training attends
    through the plain flash_attention). ``state`` advances in place, as in
    :func:`ssd_train_phase`. Emits the phase's line (with ``extra``) and
    returns it."""
    from repro_torch import tree as tree_util
    from repro_torch.kernels.flash_decode import kernel as fd
    cfg = model.cfg
    held = [data.batch_at(i) for i in range(*train["eval_steps"])]

    def held_loss(params):
        with torch.no_grad():
            return [float(model.loss_fn(params, b)) for b in held]

    held_before = held_loss(state["params"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fd.launches = 0
    losses, walls = [], []
    t_run = time.perf_counter()
    for i in range(train["steps"]):
        t = time.perf_counter()
        new, metrics = step_fn(state, data.batch_at(i))
        state.update(new)
        del new
        losses.append(float(metrics["loss"]))       # waits for the step
        walls.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    train_fd = fd.launches
    peak_bytes = torch.cuda.max_memory_allocated()
    peak_gb = peak_bytes / 1e9
    held_after = held_loss(state["params"])
    drop = float(np.mean(held_before) - np.mean(held_after))
    steady_s = float(np.mean(walls[1:]))
    rows = train["batch"]
    rates = {"tok_per_s": rows * train["seq"] / steady_s}
    if cfg.encdec is not None:
        rates["frames_per_s"] = rows * cfg.encdec.encoder_seq / steady_s
    if cfg.vision is not None:
        rates["patches_per_s"] = rows * cfg.vision.n_patches / steady_s
    line = {"phase": phase, "arch": cfg.name, "dtype": cfg.dtype,
            "params": sum(t.numel() for t in
                          tree_util.leaves(state["params"])),
            "entry": "Trainer.make_step", **train, "losses": losses,
            "held_out_losses_before": held_before,
            "held_out_losses_after": held_after, "held_out_mean_drop": drop,
            "threshold": f"held_out_mean_drop >= {train['min_drop']}",
            "wall_s": run_s, "step_wall_ms": [w * 1e3 for w in walls],
            "ms_per_step_wall": steady_s * 1e3, **rates,
            "peak_mem_GB": peak_gb, "flash_decode_launches": train_fd,
            **extra, "card": smi}
    emit(line)
    if train_fd:
        raise AssertionError(f"{phase}: flash_decode launched {train_fd} "
                             "times in training")
    if not all(np.isfinite(losses + held_before + held_after)):
        raise AssertionError(f"a {phase} loss is not finite: {losses}, "
                             f"held-out {held_before} -> {held_after}")
    if not drop >= train["min_drop"]:
        raise AssertionError(f"the {phase} loss did not fall: held-out "
                             f"batches {held_before} -> {held_after}")
    return line


def into_window(cache, caches, row: int | None = None) -> None:
    """Copy the caches of a prefill (leaves (L, b, s, ...)) into the
    window ``cache`` (leaves (L, B, S, ...), s <= S): into every row, or
    into row ``row`` from a batch-1 prefill. A cross cache (s = S_enc)
    fills its leaf."""
    from repro_torch import tree as tree_util
    for dst, src in zip(tree_util.leaves(cache), tree_util.leaves(caches),
                        strict=True):
        n = src.shape[2]
        if row is None:
            dst[:, :, :n] = src
        else:
            dst[:, row, :n] = src[:, 0]


def family_decode_check(model, model32, params, params32, inputs: dict,
                        S: int) -> tuple[bool, dict, int]:
    """Batch 1: the last logits of a prefill of ``inputs`` (tokens (1, S)
    and the frames or patches) against one decode_step of token S - 1 after
    a prefill of S - 1 tokens, its caches copied into a window one longer
    (``pos`` counts a VLM's patches), in bf16 and in the float32 twin,
    gated by :func:`decode_readings` as hybrid_decode. Returns (ok,
    readings, flash_decode launches of the bf16 decode_step)."""
    from repro_torch.kernels.flash_decode import kernel as fd
    n_pre = model.cfg.vision.n_patches if model.cfg.vision else 0
    toks = inputs["tokens"][:, :S]
    rest = {k: v for k, v in inputs.items() if k != "tokens"}
    out, launches = [], []
    for m, p in ((model, params), (model32, params32)):
        with torch.no_grad():
            full, _ = m.prefill(p, {"tokens": toks, **rest})
            _, caches = m.prefill(p, {"tokens": toks[:, :S - 1], **rest})
            cache = m.init_cache(1, n_pre + S, device="cuda")
            into_window(cache, caches)
            del caches
            before = fd.launches
            lg, _ = m.decode_step(p, cache, {
                "token": toks[:, S - 1], "pos": torch.tensor(n_pre + S - 1)})
            torch.cuda.synchronize()
        launches.append(fd.launches - before)
        out += [full, lg]
        del cache
    ok, readings = decode_readings(*out)
    readings["flash_decode_launches"] = {"bfloat16": launches[0],
                                         "float32": launches[1]}
    return ok, readings, launches[0]


def family_serve_decode(model, params, row_inputs: list[dict], window: int,
                        steps: int) -> dict:
    """Rows of different prompt lengths, each prefilled alone and copied
    into row b of a ``window`` cache, then ``steps`` greedy decode_steps of
    the whole batch at per-row positions (a VLM's count its patches). The
    counter is set to 0 just before the decode_steps and read after them.
    Returns the readings, the layer-0 caches and the final positions."""
    from repro_torch.kernels.flash_decode import kernel as fd
    cfg = model.cfg
    n_pre = cfg.vision.n_patches if cfg.vision else 0
    B = len(row_inputs)
    cache = model.init_cache(B, window, device="cuda")
    first = torch.empty(B, dtype=torch.int64, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for b, inp in enumerate(row_inputs):
            lg, caches = model.prefill(params, inp)
            into_window(cache, caches, b)
            first[b] = lg[0, -1].argmax()
            del caches
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pos = torch.tensor([n_pre + inp["tokens"].shape[1] for inp in
                        row_inputs], dtype=torch.int64, device="cuda")
    tok, toks, walls = first, [], []
    fd.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(steps):
            t = time.perf_counter()
            lg, _ = model.decode_step(params, cache, {"token": tok,
                                                      "pos": pos})
            tok = lg[:, -1].argmax(-1)
            toks.append(tok.cpu())                  # waits for the step
            walls.append(time.perf_counter() - t)
            pos = pos + 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fd.launches
    toks = torch.stack(toks, 1)
    return {"rows": B, "window": window, "decode_steps": steps,
            "prompt_tokens": [int(inp["tokens"].shape[1])
                              for inp in row_inputs],
            "prefill_s": prefill_s, "decode_wall_s": wall,
            "ms_per_decode_step": float(np.mean(walls[1:])) * 1e3,
            "new_tok_per_s": B * steps / wall,
            "flash_decode_launches": launches,
            "flash_decode_launches_per_decode_step": launches / steps,
            "tokens_in_vocab": bool(((toks >= 0)
                                     & (toks < cfg.vocab_size)).all()),
            "first_tokens": toks[0, :8].tolist(),
            "cache": cache, "end_pos": pos}


def cache_check(q_seed: int, H: int, k, v, lengths) -> dict:
    """flash_decode against its plain version on a model's own bf16 cache
    (k, v (B, S, K, hd)) at per-row ``lengths``, a random query of ``H``
    heads, read at FD_TOL."""
    from repro_torch.kernels.flash_decode.ops import decode_attn
    from repro_torch.kernels.flash_decode.ref import decode_attention_ref
    B, S, K, hd = k.shape
    q = torch.from_numpy(np.random.default_rng(q_seed).standard_normal(
        (B, H, hd), np.float32)).cuda().bfloat16()
    lengths = lengths.to(torch.int32)
    got = decode_attn(q, k, v, lengths)
    want = decode_attention_ref(q, k, v, lengths)
    torch.cuda.synchronize()
    return {"shape": [B, H, K, hd, hd, S], "lengths": lengths.tolist(),
            "max_err": (got.float() - want.float()).abs().max().item(),
            "reading": fd_reading(got, want), "tol": FD_TOL_TEXT}


def whisper_phases(smi: str) -> dict:
    """Phases 29-30 on full-width whisper-small (EncDecLM); returns its
    readings of flash_decode for the kernels line."""
    from repro_torch import tree as tree_util
    from repro_torch.configs import get
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models import EncDecLM, build_model
    from repro_torch.train.loop import Trainer
    from repro_torch.train.optimizer import AdamWConfig
    cfg = get("whisper-small")
    model = build_model(cfg)
    if not isinstance(model, EncDecLM):
        raise AssertionError(f"whisper: build_model gave "
                             f"{type(model).__name__}")
    L, S_enc = cfg.n_layers, cfg.encdec.encoder_seq
    wt = WHISPER_TRAIN
    tr = Trainer(model, AdamWConfig(lr=wt["lr"], warmup_steps=wt["warmup"],
                                    decay_steps=wt["steps"]), device="cuda")
    t0 = time.perf_counter()
    state = tr.init_state(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    data = SyntheticTokens(cfg, batch=wt["batch"], seq=wt["seq"], seed=0,
                           device="cuda")

    # --------------------------------------------------- 29. whisper_train
    family_train_phase("whisper_train", wt, model, state, tr.make_step(),
                       data, smi, encoder_layers=cfg.encdec.n_encoder_layers,
                       decoder_layers=L, frames=S_enc, init_state_s=init_s)

    # -------------------------------------------------- 30. whisper_decode
    params = state["params"]
    del state, tr
    gc.collect()
    torch.cuda.empty_cache()
    wd = WHISPER_DECODE
    batch = data.batch_at(300)
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    params32 = tree_util.tree_map(lambda t: t.float(), params)
    agree, readings, fd_check = family_decode_check(
        model, model32, params, params32,
        {"tokens": batch["tokens"][:1], "frames": batch["frames"][:1]},
        wd["check_len"])
    del params32, model32
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(0)
    lo, hi = wd["prompt"]
    lens = rng.integers(lo, hi + 1, wd["batch"])
    more = SyntheticTokens(cfg, batch=wd["batch"], seq=hi, seed=1,
                           device="cuda").batch_at(0)
    rows = [{"tokens": more["tokens"][b:b + 1, :int(n)],
             "frames": more["frames"][b:b + 1]} for b, n in enumerate(lens)]
    run = family_serve_decode(model, params, rows, wd["window"], wd["steps"])
    cache, end = run.pop("cache"), run.pop("end_pos")
    full = torch.full((wd["batch"],), S_enc, device="cuda")
    checks = {"cross": cache_check(4, cfg.n_heads, cache["cross"][0][0],
                                   cache["cross"][1][0], full),
              "self": cache_check(5, cfg.n_heads, cache["self"]["k"][0],
                                  cache["self"]["v"][0], end)}
    del cache
    want = 2 * L
    ok = (agree and fd_check == want and run["tokens_in_vocab"]
          and run["flash_decode_launches"] == want * wd["steps"]
          and all(c["reading"] <= 1 for c in checks.values()))
    line = {"phase": "whisper_decode", "arch": cfg.name, "dtype": cfg.dtype,
            "frames": S_enc,
            "decode_check": {"batch": 1, "prefill_len": wd["check_len"] - 1,
                             "full_len": wd["check_len"], "agrees": agree,
                             **readings},
            **run,
            "expected_per_decode_step": f"{want} ({L} self + {L} cross), "
                                        "(64, 64)",
            "layer0_cache_checks": checks, "ok": ok, "card": smi}
    emit(line)
    if not ok:
        raise AssertionError(f"whisper decode: {readings}; flash_decode "
                             f"{run['flash_decode_launches']} launches in "
                             f"{wd['steps']} decode_steps, {fd_check} in the "
                             f"check (expected {want} each); cache checks "
                             f"{checks}")
    del params, model, data, batch, more
    gc.collect()
    torch.cuda.empty_cache()
    return {"path": "whisper_decode", "launches": run["flash_decode_launches"],
            "launches_per_decode_step":
                run["flash_decode_launches_per_decode_step"],
            "decode_check_launches": sum(
                readings["flash_decode_launches"].values()),
            "max_abs_err": max(c["max_err"] for c in checks.values()),
            "reading": max(c["reading"] for c in checks.values()),
            "checked_on": "whisper_decode's layer-0 cross cache (all 1,500 "
                          "rows) and self cache"}


def vlm_phases(smi: str) -> dict:
    """Phases 31-32 on full-width internvl2-1b (LM with the patch prefix);
    returns its readings of flash_decode for the kernels line."""
    from repro_torch import tree as tree_util
    from repro_torch.configs import get
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models import LM, build_model
    from repro_torch.train.loop import Trainer
    from repro_torch.train.optimizer import AdamWConfig
    cfg = get("internvl2-1b")
    model = build_model(cfg)
    if not isinstance(model, LM):
        raise AssertionError(f"internvl: build_model gave "
                             f"{type(model).__name__}")
    L, n_pre = cfg.n_layers, cfg.vision.n_patches
    vt = VLM_TRAIN
    tr = Trainer(model, AdamWConfig(lr=vt["lr"], warmup_steps=vt["warmup"],
                                    decay_steps=vt["steps"]), device="cuda")
    t0 = time.perf_counter()
    state = tr.init_state(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    data = SyntheticTokens(cfg, batch=vt["batch"], seq=vt["seq"], seed=0,
                           device="cuda")

    # ------------------------------------------------------ 31. vlm_train
    family_train_phase("vlm_train", vt, model, state, tr.make_step(), data,
                       smi, patches=n_pre, layers=L,
                       positions_per_row=n_pre + vt["seq"],
                       init_state_s=init_s)

    # ----------------------------------------------------- 32. vlm_decode
    params = state["params"]
    del state, tr
    gc.collect()
    torch.cuda.empty_cache()
    vd = VLM_DECODE
    batch = data.batch_at(300)
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    params32 = tree_util.tree_map(lambda t: t.float(), params)
    agree, readings, fd_check = family_decode_check(
        model, model32, params, params32,
        {"tokens": batch["tokens"][:1], "patches": batch["patches"][:1]},
        vd["check_len"])
    del params32, model32
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(0)
    lo, hi = vd["prompt"]
    lens = rng.integers(lo, hi + 1, vd["batch"])
    more = SyntheticTokens(cfg, batch=vd["batch"], seq=hi, seed=1,
                           device="cuda").batch_at(0)
    rows = [{"tokens": more["tokens"][b:b + 1, :int(n)],
             "patches": more["patches"][b:b + 1]}
            for b, n in enumerate(lens)]
    run = family_serve_decode(model, params, rows, vd["window"], vd["steps"])
    cache, end = run.pop("cache"), run.pop("end_pos")
    check = cache_check(6, cfg.n_heads, cache["dense"]["k"][0],
                        cache["dense"]["v"][0], end)
    del cache
    ok = (agree and fd_check == L and run["tokens_in_vocab"]
          and run["flash_decode_launches"] == L * vd["steps"]
          and check["reading"] <= 1)
    line = {"phase": "vlm_decode", "arch": cfg.name, "dtype": cfg.dtype,
            "patches": n_pre,
            "decode_check": {"batch": 1, "prefill_len": n_pre
                             + vd["check_len"] - 1,
                             "full_len": n_pre + vd["check_len"],
                             "decode_pos": n_pre + vd["check_len"] - 1,
                             "agrees": agree, **readings},
            **run,
            "expected_per_decode_step": f"{L} (one per layer), (64, 64), "
                                        f"rep {cfg.n_heads // cfg.n_kv_heads}",
            "layer0_cache_check": check, "ok": ok, "card": smi}
    emit(line)
    if not ok:
        raise AssertionError(f"vlm decode: {readings}; flash_decode "
                             f"{run['flash_decode_launches']} launches in "
                             f"{vd['steps']} decode_steps, {fd_check} in the "
                             f"check (expected {L} each); cache check "
                             f"{check}")
    del params, model, data, batch, more
    gc.collect()
    torch.cuda.empty_cache()
    return {"path": "vlm_decode", "launches": run["flash_decode_launches"],
            "launches_per_decode_step":
                run["flash_decode_launches_per_decode_step"],
            "decode_check_launches": sum(
                readings["flash_decode_launches"].values()),
            "max_abs_err": check["max_err"], "reading": check["reading"],
            "checked_on": "vlm_decode's layer-0 cache, group size 7"}


def _max_rel(got, want) -> float:
    """Largest |got - want| / |want| over two arrays (0 where both are 0)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.abs(got - want)
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.max(np.where(diff == 0, 0.0, diff / np.abs(want))))


def _lane_turns(fn, min_wall_s: float) -> dict:
    """Seconds per call of ``fn(lane)`` for the numpy and torch lanes, in
    the turns numpy, torch, torch, numpy (each turn repeats the call until
    ``min_wall_s`` has passed); the faster turn of each lane, and the last
    result of each."""
    secs = {"numpy": [], "torch": []}
    out = {}
    for lane in ("numpy", "torch", "torch", "numpy"):
        runs, t0 = 0, time.perf_counter()
        while True:
            out[lane] = fn(lane)
            runs += 1
            wall = time.perf_counter() - t0
            if wall >= min_wall_s:
                break
        secs[lane].append(wall / runs)
    return {"s": {k: min(v) for k, v in secs.items()},
            "turns_s": secs, "out": out}


def exanet_sim_phase(smi: str, acts, device: str = "cuda") -> dict:
    """Phases 33-34: the ExaNet simulator's model figures, then its compiled
    replays through the torch scan lane on the card against the numpy
    lane (EXANET)."""
    from repro_torch.core.exanet import scan_engine as se
    from repro_torch.core.exanet.allreduce_accel import (
        accel_allreduce_latency)
    from repro_torch.core.exanet.mpi import ExanetMPI
    from repro_torch.core.exanet.params import DEFAULT, scaled_params
    from repro_torch.core.exanet.schedules import (BinomialBroadcast,
                                                   RecursiveDoublingAllreduce)
    from repro_torch.core.program import cg_iteration

    t_phase = time.perf_counter()
    eng = se.get_scan_engine("torch")
    if eng.device.type != device:
        raise AssertionError(f"the torch scan lane runs on {eng.device}")

    # -- 33. the model's figures: simulated microseconds, not card readings
    mpi = ExanetMPI()
    paths = mpi.topo.table1_paths()
    table2 = {name: {"simulated_us": mpi.net.mpi_latency(
                  0, mpi.topo.route(*paths[name])), "paper_us": paper}
              for name, paper in EXANET_PAPER["table2_us"].items()}
    c = DEFAULT.cores_per_mpsoc
    util = {"16G": mpi.osu_bw(4 << 20, 0, c) / 16.0,
            "10G": mpi.osu_bw(4 << 20, 0, c * DEFAULT.fpgas_per_qfdb) / 10.0}
    mpi1 = ExanetMPI(ranks_per_mpsoc=1)
    gain = {n: max(1 - accel_allreduce_latency(s, n) / mpi1.allreduce_sw(s, n)
                   for s in (4, 64, 256, 1024, 4096))
            for n in EXANET_PAPER["accel_gain"]}
    emit({"phase": "exanet_model",
          "units": "simulated microseconds and shares of the ExaNeSt "
                   "prototype's model, not readings of this card",
          "table2_0B_mpi_latency": table2,
          "osu_bw_4MB_link_utilisation": {
              k: {"simulated": v, "paper": EXANET_PAPER["link_utilisation"][k]}
              for k, v in util.items()},
          "accel_allreduce_gain": {
              n: {"simulated": v, "paper": EXANET_PAPER["accel_gain"][n]}
              for n, v in gain.items()},
          "accel_gain_max": max(gain.values())})

    # -- 34a. the engine comparison at 4,096 ranks over the size grid
    n, grid, tol = EXANET["ranks"], EXANET["sizes"], EXANET["tol"]
    big = ExanetMPI(scaled_params((n - 1) * c + 1), ranks_per_mpsoc=1)
    rows = {}
    for coll, sched, sends in (
            ("bcast", BinomialBroadcast(), n - 1),
            ("allreduce", RecursiveDoublingAllreduce(),
             n * (n.bit_length() - 1))):
        t0 = time.perf_counter()
        big.run_schedule_many(sched, grid, n)        # compile and bind
        compile_s = time.perf_counter() - t0
        calls0 = sum(eng.calls.values())
        big.run_schedule_many(sched, grid, n, engine="torch")  # masks up
        calls = sum(eng.calls.values()) - calls0
        turns = _lane_turns(lambda lane: big.run_schedule_many(
            sched, grid, n, engine=lane), EXANET["min_wall_s"])
        got, want = turns["out"]["torch"], turns["out"]["numpy"]
        rel = max(_max_rel(got.latency_us, want.latency_us),
                  _max_rel(got.clocks, want.clocks))
        rows[coll] = {
            "nranks": n, "grid_sizes": len(grid),
            "sends_per_grid": sends * len(grid),
            "compile_and_bind_s": compile_s,
            "torch_scan_calls_per_grid": calls,
            "wall_s_per_grid": turns["s"], "turns_s": turns["turns_s"],
            "sends_per_s": {k: sends * len(grid) / v
                            for k, v in turns["s"].items()},
            "torch_vs_numpy": turns["s"]["numpy"] / turns["s"]["torch"],
            "agreement_rel": rel}
        if not rel <= tol:
            emit({"phase": "exanet_sim", "engine_rows": rows})
            raise AssertionError(f"{coll} at {n} ranks: the torch lane "
                                 f"differs from numpy by {rel} rel > {tol}")

    # one rank per MPSoC gives the broadcast no contending acquires, so
    # its replay runs no scan on either lane; the allreduce's does
    if rows["allreduce"]["torch_scan_calls_per_grid"] == 0:
        raise AssertionError("the allreduce grid ran no torch scan")

    # -- 34b. one scenario sweep of cg_iteration over 1,024 columns
    nr, face, us = EXANET["prog"]
    prog = cg_iteration(nr, face, us)
    rng = np.random.default_rng(EXANET["seed"])
    cs = rng.uniform(0.5, 2.0, size=EXANET["columns"])
    bs = rng.uniform(0.25, 3.0, size=EXANET["columns"])
    sim = ExanetMPI()

    def sweep(lane, check=0):
        return sim.run_program_scenarios(prog, compute_scale=cs,
                                         byte_scale=bs, engine=lane,
                                         check=check)

    runs = _lanes(sweep, EXANET["check"], eng, _results_rel,
                  EXANET["min_wall_s"])
    rel, turns = runs["agreement_rel"], runs["turns"]
    if device == "cuda":
        torch.cuda.synchronize()
    calls0 = sum(eng.calls.values())
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        sweep("torch")
        if device == "cuda":
            torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    sweep_calls = sum(eng.calls.values()) - calls0
    entries = device_kernels(prof, 1)
    busy_ms = sum(ms for _, ms, _ in entries)
    copy_ms = sum(ms for name, ms, _ in entries if "Memcpy" in name)
    del prof
    sweep_row = {
        "program": f"cg_iteration({nr}, {face}, {us})",
        "columns": EXANET["columns"], "checked_columns": EXANET["check"],
        "first_call_with_check_s": runs["checked_s"],
        "wall_s_per_sweep": turns["s"], "turns_s": turns["turns_s"],
        "columns_per_s": {k: EXANET["columns"] / v
                          for k, v in turns["s"].items()},
        "torch_vs_numpy": turns["s"]["numpy"] / turns["s"]["torch"],
        "torch_scan_calls_per_sweep": sweep_calls,
        "agreement_rel": rel,
        "profiled_torch_sweep": {
            "wall_ms": prof_wall * 1e3, "device_busy_ms": busy_ms,
            "busy_share": busy_ms / (prof_wall * 1e3),
            "memcpy_ms": copy_ms, "device_ops": sum(k for *_, k in entries),
            "top": [[name[:60], ms, k] for name, ms, k in entries[:6]]}}
    line = {"phase": "exanet_sim", "lane": "torch", "device": str(eng.device),
            "engine_rows": rows, "scenario_sweep": sweep_row,
            "masks_cached": len(eng._takes_cache),
            "seconds": time.perf_counter() - t_phase, "card": smi}
    emit(line)
    if not rel <= tol:
        raise AssertionError(f"scenario sweep: the torch lane differs from "
                             f"numpy by {rel} rel > {tol}")
    if sweep_calls == 0:
        raise AssertionError("the scenario sweep ran no torch scan")
    return line


def _results_rel(got, want) -> float:
    """Largest relative gap in latency and clocks over two lists of
    program results."""
    return max(max(_max_rel(x.latency_us, y.latency_us),
                   _max_rel(x.clocks, y.clocks)) for x, y in zip(got, want))


def _scan_calls(eng) -> int:
    return sum(eng.calls.values())


def _lanes(fn, check: int, eng, rel, min_wall_s: float = 0.0) -> dict:
    """``fn("torch", check)`` once with ``check`` columns re-run on the
    interpreter (it raises past the tolerance), then ``fn(lane, 0)`` timed
    in turns (:func:`_lane_turns`). The interpreter's runs are the same
    work whichever lane is checked, so one lane is checked and numpy's
    results are held to it: ``agreement_rel`` is the larger ``rel(torch,
    numpy)`` of the checked call and of the turns. Also the checked call's
    seconds and torch scans, and the turns."""
    calls0, t0 = _scan_calls(eng), time.perf_counter()
    checked = fn("torch", check)
    checked_s = time.perf_counter() - t0
    scans = _scan_calls(eng) - calls0
    turns = _lane_turns(lambda lane: fn(lane, 0), min_wall_s)
    out = turns["out"]
    return {"checked": checked, "checked_s": {"torch": checked_s},
            "scans": scans, "turns": turns,
            "agreement_rel": max(rel(checked, out["numpy"]),
                                 rel(out["torch"], out["numpy"]))}


def _lane_row(runs: dict) -> dict:
    s = runs["turns"]["s"]
    return {"first_call_with_check_s": runs["checked_s"],
            "wall_s": s, "turns_s": runs["turns"]["turns_s"],
            "torch_vs_numpy": s["numpy"] / s["torch"],
            "torch_scan_calls": runs["scans"],
            "agreement_rel": runs["agreement_rel"]}


def _torch_lane_profile(fn, acts, eng, device: str) -> dict:
    """One torch-lane call of ``fn()`` under torch.profiler: its wall, the
    device's busy time and share, the copies and the scans it ran."""
    if device == "cuda":
        torch.cuda.synchronize()
    calls0 = _scan_calls(eng)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if device == "cuda":
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    entries = device_kernels(prof, 1)
    busy = sum(ms for _, ms, _ in entries)
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "busy_share": busy / wall_ms,
            "memcpy_ms": sum(ms for n, ms, _ in entries if "Memcpy" in n),
            "device_ops": sum(k for *_, k in entries),
            "torch_scan_calls": _scan_calls(eng) - calls0}


def _gate_lanes(phase: str, rows: dict) -> None:
    """Each row's lanes within SIM_STUDIES' tolerance, and the torch lane
    ran scans in each."""
    tol = SIM_STUDIES["tol"]
    for name, row in rows.items():
        if not row["agreement_rel"] <= tol:
            raise AssertionError(f"{phase} {name}: the torch lane differs "
                                 f"from numpy by {row['agreement_rel']} rel "
                                 f"> {tol}")
        if row["torch_scan_calls"] == 0:
            raise AssertionError(f"{phase} {name}: the torch lane ran no "
                                 "scan")


def exanet_apps_phase(smi: str, acts, eng, device: str) -> dict:
    """Phase 35: the studies on PR 27's MPI layer. Table 3 and the
    reference's assertions on it, each app's weak iteration at 512 ranks
    over seeded scenario columns, the two-tenant interference curve and
    the IP overlay's figures (SIM_STUDIES)."""
    from repro_torch.core.exanet import apps, interference, ip_overlay
    from repro_torch.core.exanet.mpi import ExanetMPI
    from repro_torch.core.program import halo3d

    S, tol = SIM_STUDIES, SIM_STUDIES["tol"]
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    table = apps.table3()
    table3_s = time.perf_counter() - t0
    # tests/test_exanet_paper_validation.py's assertions on the apps
    for app, modes in apps.PAPER_TABLE3.items():
        for mode, pts in modes.items():
            got = table[app][mode]
            if abs(got[512] - pts[512]) > 0.5 or abs(got[2] - pts[2]) > 7.0:
                raise AssertionError(f"Table 3 {app} {mode}: {got} against "
                                     f"the paper's {pts}")
    models = {name: f() for name, f in apps.ALL_APPS.items()}
    floor = {}
    for name, m in models.items():
        floor[name] = min(getattr(m, mode)(n)["efficiency"]
                          for mode in ("weak", "strong")
                          for n in (2, 8, 64, 512))
        if floor[name] < 0.685:
            raise AssertionError(f"{name}: efficiency {floor[name]} under "
                                 "the abstract's 69%")
        for mode in ("weak", "strong"):
            sim = m._simulate(mode, 512)
            closed = m._comm_closed_us(m._local_points(mode, 512), 512)
            e = m._eval(mode, 512)
            if (sim.n_sends != 512 * 6
                    or sim.n_collectives != m.allreduce_per_iter
                    or not sim.comm_us > closed
                    or not 0.0 <= e["beta"] <= e["alpha_retired"]):
                raise AssertionError(f"{name} {mode}: the halo congestion "
                                     f"is not the simulation's: {e}")
    hpcg_comm = {n: models["hpcg"].strong(n)["comm_fraction"]
                 for n in (2, 512)}
    if abs(hpcg_comm[512] - 0.224) > 0.03 or not hpcg_comm[2] < 0.02:
        raise AssertionError(f"HPCG's comm share {hpcg_comm}")
    mem = {n: 1 / apps.f_mem(n) for n in (2, 4)}
    if abs(mem[2] - 0.96) > 0.01 or abs(mem[4] - 0.89) > 0.01:
        raise AssertionError(f"memory contention {mem}")

    # each app's weak iteration at 512 ranks over seeded scenario columns
    n, cols = S["app_ranks"], S["app_columns"]
    sweeps = {}
    for name, m in models.items():
        prog, mpi = m.emit_iteration("weak", n), m.mpi_for(n)
        rng = np.random.default_rng(S["app_seed"])
        cs, bs = rng.uniform(0.9, 1.1, cols), rng.uniform(0.8, 1.2, cols)

        def sweep(lane, check, prog=prog, mpi=mpi, cs=cs, bs=bs):
            return mpi.run_program_scenarios(
                prog, compute_scale=cs, byte_scale=bs, engine=lane,
                check=check, rtol=tol)

        runs = _lanes(sweep, S["app_check"], eng, _results_rel)
        lat = [r.latency_us for r in runs["checked"]]
        sweeps[name] = {"nranks": n, "columns": cols,
                        "checked_columns": S["app_check"],
                        "latency_us": {"min": min(lat), "max": max(lat)},
                        **_lane_row(runs)}
        if name == "hpcg":
            profiled = _torch_lane_profile(lambda: sweep("torch", 0), acts,
                                           eng, device)

    # two tenants on shared QFDBs: the app's efficiency against the load
    I, loads = S["interference"], S["loads"]
    a_ranks, b_ranks = interference.interleave_qfdb(I["n_app"], I["n_bg"])
    mix = interference.merge_tenants(
        halo3d(I["n_app"], I["face"], compute_us=I["compute_us"]),
        interference.background_stream(I["n_bg"], iters=I["iters"],
                                       nbytes=I["nbytes"]),
        a_ranks, b_ranks)
    bs = interference.neighbor_load_byte_scale(mix, loads)
    imp = ExanetMPI()

    def curve(lane, check):
        return imp.run_program_scenarios(mix.program, byte_scale=bs,
                                         engine=lane, check=check, rtol=tol)

    runs = _lanes(curve, I["check"], eng, _results_rel)
    app_us = {lane: [mix.app_latency_us(r) for r in res]
              for lane, res in runs["turns"]["out"].items()}
    eff = {lane: [us[0] / t for t in us] for lane, us in app_us.items()}
    sweeps["interference"] = {
        "app": f"halo3d({I['n_app']}, {I['face']}, {I['compute_us']} us)",
        "background": f"background_stream({I['n_bg']}, {I['iters']}, "
                      f"{I['nbytes']})",
        "placement": "interleave_qfdb", "loads": list(loads),
        "app_us": app_us["torch"], "efficiency": eff,
        **_lane_row(runs)}

    overlay = {
        "udp_65507B_gbps": {
            "overlay": ip_overlay.overlay_throughput_gbps(65507),
            "baseline": ip_overlay.baseline_throughput_gbps(65507),
            "paper": {"overlay": 4.7, "baseline": 1.3}},
        "rtt_us": {"poll": ip_overlay.overlay_rtt(mode="poll"),
                   "sleep": ip_overlay.overlay_rtt(mode="sleep"),
                   "paper": {"poll": 90.0, "sleep": "about 2,200"}},
        "gap": ip_overlay.overlay_vs_native_gap()}
    line = {"phase": "exanet_apps", "device": str(eng.device),
            "units": "simulated efficiencies (percent), microseconds and "
                     "Gb/s of the ExaNeSt prototype's model, not readings "
                     "of this card; wall seconds are this host's",
            "table3": {app: {mode: {k: {"simulated": table[app][mode][k],
                                        "paper": v}
                                    for k, v in pts.items()}
                             for mode, pts in modes.items()}
                       for app, modes in apps.PAPER_TABLE3.items()},
            "table3_s": table3_s, "efficiency_floor": floor,
            "hpcg_strong_comm_fraction": hpcg_comm,
            "scenario_sweeps": sweeps, "ip_overlay": overlay,
            "profiled_torch_sweep": {"what": "hpcg", **profiled},
            "seconds": time.perf_counter() - t_phase, "card": smi}
    emit(line)
    _gate_lanes("exanet_apps", sweeps)
    for lane, e in eff.items():
        if not all(b <= a + 1e-9 for a, b in zip(e, e[1:])):
            raise AssertionError(f"interference ({lane} lane): the app's "
                                 f"efficiency rises with the load: {e}")
    ov, base = overlay["udp_65507B_gbps"]["overlay"], \
        overlay["udp_65507B_gbps"]["baseline"]
    if (abs(ov - 4.7) / 4.7 >= 0.15 or abs(base - 1.3) / 1.3 >= 0.25
            or not ov > 3 * base
            or abs(overlay["rtt_us"]["poll"] - 90.0) / 90.0 >= 0.25
            or not overlay["rtt_us"]["sleep"] > 1500.0):
        raise AssertionError(f"the IP overlay's figures {overlay}")
    return line


def _knee(traffic, spec, tab) -> dict:
    """serve_sweep.py's load grid on one step table: the backlog capacity,
    one seeded Poisson replay at each LOAD_FRACS share of it, the goodput
    and latency quantiles of each, and the knee."""
    S = SIM_STUDIES
    kw = dict(slots=spec.slots, prefill_chunk=spec.prefill_chunk,
              window=spec.window, kv_bucket=spec.kv_bucket,
              step_time=tab.lookup)
    n = 8 * spec.slots
    backlog = traffic.replay(traffic.trace_workload(
        np.zeros(n), np.full(n, S["prompt_mean"], dtype=np.int64),
        np.full(n, S["out_mean"], dtype=np.int64)), **kw)
    cap = n / float(backlog.done_us.max()) * 1e6
    rows = []
    for f in S["load_fracs"]:
        res = traffic.replay(traffic.poisson_workload(
            f * cap, S["serve_requests"], S["serve_seed"],
            prompt_tokens=S["prompt_mean"], out_tokens=S["out_mean"]), **kw)
        span = res.done_us.max() - res.arrive_us.min()
        rows.append({"load_frac": f, "offered_rps": round(f * cap, 3),
                     "goodput_rps": round(res.latency_us.size / span * 1e6,
                                          3),
                     "steps": res.n_steps,
                     "latency_us": traffic.quantiles(res.latency_us),
                     "ttft_us": traffic.quantiles(res.ttft_us)})
    knee = traffic.knee_point([r["offered_rps"] for r in rows],
                              [r["goodput_rps"] for r in rows],
                              S["knee_frac"])
    return {"capacity_rps": cap, "loads": rows, "knee_offered_rps": knee}


def serve_sim_phase(smi: str, acts, eng, device: str,
                    serve_reading: dict) -> dict:
    """Phase 36: the serving simulator's step table for deepseek-7b at 512
    ranks on both lanes, Poisson replays through it and their knee, and
    the roofline prediction beside the serve phase's measured decode_step
    (SIM_STUDIES)."""
    from repro_torch.configs import get
    from repro_torch.roofline.analysis import serve_step_calibration
    from repro_torch.roofline.hw import H100
    from repro_torch.serve import traffic
    from repro_torch.serve.sim import ServeSim, ServeSimSpec

    S, tol = SIM_STUDIES, SIM_STUDIES["tol"]
    t_phase = time.perf_counter()
    sim = ServeSim(ServeSimSpec(**S["serve"]))

    def table(lane, check):
        return sim.build_table(mc=S["serve_mc"], rng=S["serve"]["nranks"],
                               engine=lane, check=check, rtol=tol)

    runs = _lanes(table, S["serve_check"], eng,
                  lambda got, want: _max_rel(got.us, want.us))
    tab = runs["checked"]
    row = {"arch": sim.spec.arch, "nranks": sim.spec.nranks,
           "states": len(tab.states), "mc": tab.mc,
           "columns": len(tab.states) * tab.mc,
           "checked_columns": S["serve_check"],
           "step_us": {"min": float(tab.us.min()),
                       "max": float(tab.us.max())},
           **_lane_row(runs)}
    profiled = _torch_lane_profile(lambda: table("torch", 0), acts, eng,
                                   device)
    t0 = time.perf_counter()
    knee = {lane: _knee(traffic, sim.spec, tab)
            for lane, tab in runs["turns"]["out"].items()}
    replay_s = time.perf_counter() - t0

    # the simulator's roofline beside the card: the serve phase's own
    # decode_step against the bound at the card's peaks
    cfg = get("exanest-lm-100m")
    cal = serve_step_calibration(
        cfg, measured_step_us=serve_reading["ms_per_decode_step"] * 1e3,
        n_decode=serve_reading["mean_live_rows"],
        decode_kv=serve_reading["mean_context"],
        rate_flops_per_us=H100.peak_bf16_flops / 1e6,
        bw_bytes_per_us=H100.hbm_bw / 1e6)
    line = {"phase": "serve_sim", "device": str(eng.device),
            "units": "simulated microseconds of the prototype's serving "
                     "steps; wall seconds are this host's",
            "table": row, "profiled_torch_table": profiled,
            "replay": {"requests": S["serve_requests"],
                       "seed": S["serve_seed"], "wall_s_both_tables":
                           replay_s, "torch_table": knee["torch"],
                       "numpy_knee_offered_rps":
                           knee["numpy"]["knee_offered_rps"]},
            "calibration": {"arch": cfg.name, "from": "phase 6 (serve)",
                            **serve_reading, **cal,
                            "peaks": {"bf16_flops": H100.peak_bf16_flops,
                                      "hbm_bytes_per_s": H100.hbm_bw}},
            "seconds": time.perf_counter() - t_phase, "card": smi}
    emit(line)
    _gate_lanes("serve_sim", {"table": row})
    if knee["torch"]["knee_offered_rps"] != knee["numpy"]["knee_offered_rps"]:
        raise AssertionError(f"the torch lane's table gives the knee "
                             f"{knee['torch']['knee_offered_rps']}, numpy's "
                             f"{knee['numpy']['knee_offered_rps']}")
    ratio = cal["measured_over_predicted"]
    if not (math.isfinite(ratio) and ratio >= 1.0):
        raise AssertionError(f"a decode_step measured under its roofline "
                             f"bound: ratio {ratio}")
    return line


def train_sim_phase(smi: str, acts, eng, device: str) -> dict:
    """Phase 37: the train-step co-simulator for exanest-lm-100m at 512
    ranks: a 64-member candidate family on both lanes, the blocking and
    overlapped pair on the torch lane, and plan_train_sync at 16 ranks on
    both lanes (SIM_STUDIES)."""
    from repro_torch.core.planner import CollectivePlanner
    from repro_torch.train.cosim import SyncCandidate, TrainSim, TrainStepSpec

    S, tol = SIM_STUDIES, SIM_STUDIES["tol"]
    t_phase = time.perf_counter()
    sim = TrainSim(TrainStepSpec(**S["train"]))
    base = SyncCandidate(8, sim.feasible_algos()[0], 1)
    rng = np.random.default_rng(S["family_seed"])
    fam = [base]
    while len(fam) < S["family"]:
        m = sim.mutate(dataclasses.replace(base), rng)
        if m.family() == base.family() and m not in fam:
            fam.append(m)
    t0 = time.perf_counter()
    sim.cost_candidates([base])          # compile and bind the family
    warm_s = time.perf_counter() - t0

    def cost(lane, check):
        return sim.cost_candidates(fam, engine=lane, check=check, rtol=tol)

    runs = _lanes(cost, S["family_check"], eng, _max_rel)
    us = runs["checked"]
    row = {"arch": sim.spec.arch, "nranks": sim.spec.nranks,
           "candidates": len(fam), "family": list(base.family()),
           "checked_columns": S["family_check"], "compile_and_bind_s":
               warm_s, "step_us": {"min": float(us.min()),
                                   "max": float(us.max())},
           **_lane_row(runs)}
    profiled = _torch_lane_profile(lambda: cost("torch", 0), acts, eng,
                                   device)

    # scaling_row's pair on the torch lane, against numpy: overlap lies
    # between the critical path and the blocking step
    over = SyncCandidate(8, sim.feasible_algos()[0], 2)
    block = dataclasses.replace(over, overlap_depth=0)
    t0 = time.perf_counter()
    bl, ov = sim.cost_candidates([block, over], engine="torch")
    pair_rel = _max_rel([bl, ov], sim.cost_candidates([block, over]))
    lb = sim.lower_bound_us(over)
    pair = {"candidate": dataclasses.astuple(over),
            "blocking_step_us": float(bl), "overlapped_step_us": float(ov),
            "lower_bound_us": lb, "overlap_gain": float((bl - ov) / bl),
            "agreement_rel": pair_rel, "wall_s": time.perf_counter() - t0}

    # the planner's hillclimb at 16 ranks on both lanes: the torch lane's
    # costs with their check columns, numpy's plan held to that one
    psim = TrainSim(TrainStepSpec(**{**S["train"],
                                     "nranks": S["plan_ranks"]}))
    plans, plan_s = {}, {}
    for lane in ("torch", "numpy"):
        kw = S["plan"] if lane == "torch" else {**S["plan"], "check": 0}
        t0 = time.perf_counter()
        plans[lane] = CollectivePlanner(psim.machine).plan_train_sync(
            psim, engine=lane, **kw)
        plan_s[lane] = time.perf_counter() - t0
    plan_rel = _max_rel(plans["torch"].step_us, plans["numpy"].step_us)
    plan = {"nranks": S["plan_ranks"], **S["plan"], "checked_lane": "torch",
            "wall_s": plan_s,
            "chosen": {k: dataclasses.astuple(p.chosen)
                       for k, p in plans.items()},
            "step_us": {k: p.step_us for k, p in plans.items()},
            "baseline": dataclasses.astuple(plans["numpy"].baseline),
            "baseline_step_us": plans["numpy"].baseline_step_us,
            "flipped": {k: p.flipped for k, p in plans.items()},
            "margin": plans["numpy"].margin,
            "evaluated": plans["numpy"].evaluated, "agreement_rel": plan_rel}
    line = {"phase": "train_sim", "device": str(eng.device),
            "units": "simulated microseconds of the prototype's train "
                     "steps; wall seconds are this host's",
            "family": row, "profiled_torch_family": profiled,
            "scaling_pair_torch": pair, "plan": plan,
            "seconds": time.perf_counter() - t_phase, "card": smi}
    emit(line)
    _gate_lanes("train_sim", {"family": row})
    if not pair_rel <= tol:
        raise AssertionError(f"the pair: the torch lane differs from numpy "
                             f"by {pair_rel} rel > {tol}")
    if not lb * (1 - tol) <= ov <= bl:
        raise AssertionError(f"the overlapped step {ov} us lies outside "
                             f"[{lb}, {bl}]")
    if (plan["chosen"]["torch"] != plan["chosen"]["numpy"]
            or plans["torch"].flipped != plans["numpy"].flipped
            or not plan_rel <= tol):
        raise AssertionError(f"the lanes plan differently: {plan}")
    return line


def sim_studies_phases(smi: str, acts, serve_reading: dict,
                       device: str = "cuda") -> dict:
    """Phases 35-37 on the torch scan lane (get_scan_engine("torch"))
    against the numpy lane."""
    from repro_torch.core.exanet import scan_engine as se
    eng = se.get_scan_engine("torch")
    if eng.device.type != device:
        raise AssertionError(f"the torch scan lane runs on {eng.device}")
    return {"exanet_apps": exanet_apps_phase(smi, acts, eng, device),
            "serve_sim": serve_sim_phase(smi, acts, eng, device,
                                         serve_reading),
            "train_sim": train_sim_phase(smi, acts, eng, device)}


def serve_schedule(prompt_lens, new_tokens: int, slots: int,
                   window: int) -> tuple[list[int], list[int]]:
    """The decode_step calls that ServeEngine makes for requests of these
    prompt lengths submitted at once, each generating ``new_tokens`` (no
    eos): admission into free slots, one batched-prefill call per prompt
    index, then one call per active slot per engine step. Per call, the
    rows fed a token; per row, the context it attends."""
    queue = collections.deque(prompt_lens)
    active, pos = [0] * slots, [0] * slots
    rows, contexts = [], []

    def feed(live):
        rows.append(len(live))
        contexts.extend(min(pos[s] + 1, window) for s in live)
        for s in live:
            pos[s] += 1

    while queue or any(active):
        admitted = []
        for s in range(slots):
            if not active[s] and queue:
                admitted.append((s, queue.popleft()))
                active[s], pos[s] = new_tokens, 0
        for k in range(max((n for _, n in admitted), default=0)):
            feed([s for s, n in admitted if k < n])
        for s in range(slots):
            if active[s]:
                active[s] -= 1
                if active[s]:
                    feed([s])
                else:
                    pos[s] = 0
    return rows, contexts


def cg_worker(rank: int, port: int, out_dir: str) -> None:
    """One rank of phase 39 (b) (run by torch.multiprocessing, spawn): the
    CG on its slab of the ``data`` mesh, each solve's combine launches and
    ppermute bytes counted from 0, its x against the one-rank solve's rows
    (written by cg_phase), the kernel on the CG's own partials, a pdot and
    a halo exchange timed."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    from repro_torch.core import collectives
    from repro_torch.examples import cg_solver
    from repro_torch.kernels.allreduce_combine import kernel as ck
    from repro_torch.kernels.allreduce_combine.ops import combine_parts
    from repro_torch.kernels.allreduce_combine.ref import combine_ref
    from repro_torch.launch.mesh import make_mesh

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    k, n = CG["ranks"], CG["rank_n"]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=k, rank=rank,
                            timeout=datetime.timedelta(seconds=600))
    out = Path(out_dir)
    rec: dict = {"rank": rank}
    try:
        mesh = make_mesh((k,), ("data",), device=dev)
        group = mesh.group("data")
        lo, hi = rank * n // k, (rank + 1) * n // k
        seeded = torch.randn((n, n, n), device=dev, generator=torch.Generator(
            dev).manual_seed(CG["seed"]))[lo:hi].clone()
        rhs = {"eigen": (cg_solver.eigen_rhs(n, (lo, hi), device=dev),
                         CG["iters"]),
               "seeded": (seeded, CG["seeded_iters"])}
        one = json.loads((out / "cg_one.json").read_text())
        for label, (b, iters) in rhs.items():
            solve = cg_solver.make_cg(mesh, n, iters)
            solve.pdot(b, b)                  # gloo's connections, cuBLAS
            dist.barrier()
            torch.cuda.synchronize()
            ck.launches = 0
            with collectives.counting() as c:
                t0 = time.perf_counter()
                x, res = solve(b)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            launches = ck.launches
            want = torch.from_numpy(np.array(np.load(
                out / f"cg_one_{label}.npy", mmap_mode="r")[lo:hi])).to(dev)
            rec[label] = {
                "iters": iters, "wall_s": wall, "residual": float(res),
                "combine_launches": launches,
                "ppermute_bytes": c["bytes"].get("ppermute", 0),
                "ppermute_ops": c["ops"].get("ppermute", 0),
                "all_gather_bytes": c["bytes"]["all_gather"],
                "max_abs_diff_vs_one_rank": (x - want).abs().max().item(),
                "one_rank_max_abs_x": one[label]["max_abs_x"]}
            del want
        # the kernel on the CG's own partials: a pdot's (k, 1) gathered f32
        checks = []
        for u, v in ((x, x), (b, x)):
            parts = collectives.all_gather_stack(
                torch.vdot(u.reshape(-1), v.reshape(-1)).reshape(1), group)
            got, plain = combine_parts(parts), combine_ref(parts)
            checks.append({"shape": list(parts.shape),
                           "err": (got - plain).abs().max().item(),
                           "bitwise": bool(torch.equal(got, plain))})
        rec["kernel_check"] = checks
        u = rhs["eigen"][0]
        solve = cg_solver.make_cg(mesh, n, 0)
        # the same exchange on host copies of the slab's faces: gloo alone
        faces = u[[0, -1]].cpu()
        host = cg_solver.make_cg(make_mesh((k,), ("data",), device="cpu"),
                                 n, 0)
        for name, fn in (("pdot", lambda: solve.pdot(u, u)),
                         ("halo_exchange", lambda: solve.halo_exchange(u)),
                         ("halo_exchange_host",
                          lambda: host.halo_exchange(faces))):
            fn()
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CG["reps"]):
                fn()
            torch.cuda.synchronize()
            rec[f"{name}_ms"] = (time.perf_counter() - t0) / CG["reps"] * 1e3
        (out / f"cg_rank{rank}.json").write_text(json.dumps(rec))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def cg_phase(smi: str) -> dict:
    """Phase 39 (see the module docstring): emits the cg line; raises on a
    failed gate. Returns the combine launches of (b) on rank 0."""
    from repro_torch.examples import (allreduce_accel_demo, cg_solver,
                                      quickstart, serve_lm, train_lm)
    from repro_torch.launch.dryrun import DryCounters
    t_phase = time.perf_counter()
    hbm = card_peaks()[0]
    bad = []
    # (a) one rank: the peak reckoned on meta by the dry run's counters
    n, iters = CG["n"], CG["iters"]
    dry = {}
    for it in (0, 2):
        with DryCounters() as dry[it]:
            cg_solver.make_cg(None, n, it, device="meta")(
                cg_solver.eigen_rhs(n, device="meta"))
    reckoned = dry[2].peak
    cg_solver.make_cg(None, 64, 2, device="cuda")(
        cg_solver.eigen_rhs(64, device="cuda"))      # cuBLAS, the allocator
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    b = cg_solver.eigen_rhs(n, device="cuda")
    walls = {}
    for it in (0, iters):
        solve = cg_solver.make_cg(None, n, it, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, res = solve(b)
        torch.cuda.synchronize()
        walls[it] = time.perf_counter() - t0
        if it != iters:
            del x, res              # not held through the next solve
    peak = torch.cuda.max_memory_allocated() - held
    residual = float(res)
    err = cg_solver.analytic_error(x, b, n)
    del x, res, b, solve
    ms_iter = (walls[iters] - walls[0]) / iters * 1e3
    least_bytes = CG_PASSES * n ** 3 * 4
    one = {"n": n, "iters": iters, "points": n ** 3,
           "vector_GB": n ** 3 * 4 / 1e9, "residual": residual,
           "rel_err_vs_analytic": err, "solve_s": walls[iters],
           "setup_s": walls[0], "ms_per_iteration": ms_iter,
           "least_bytes_per_iteration": least_bytes,
           "bound_ms_per_iteration": least_bytes / hbm * 1e3,
           "share_of_bound": least_bytes / hbm * 1e3 / ms_iter,
           "eager_bytes_per_iteration_meta": (
               dry[2].bytes_accessed - dry[0].bytes_accessed) // 2,
           "peak_bytes": peak, "reckoned_peak_bytes": reckoned,
           "held_before_bytes": held}
    if not (err < 5e-2 and math.isfinite(residual)):
        bad.append(f"(a) n={n}: rel_err_vs_analytic {err}, residual "
                   f"{residual}")
    if not within_band(reckoned, peak):
        bad.append(f"(a) peak {peak} B against the reckoned {reckoned} B")
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the one-rank solves the ranks are held against, then the ranks
    rn = CG["rank_n"]
    cg_dir = ROOT / "build" / "cg"
    shutil.rmtree(cg_dir, ignore_errors=True)
    cg_dir.mkdir(parents=True)
    one_rank = {}
    gen = torch.Generator("cuda").manual_seed(CG["seed"])
    for label, b, it in (
            ("eigen", cg_solver.eigen_rhs(rn, device="cuda"), CG["iters"]),
            ("seeded", torch.randn((rn,) * 3, device="cuda", generator=gen),
             CG["seeded_iters"])):
        x, res = cg_solver.make_cg(None, rn, it, device="cuda")(b)
        np.save(cg_dir / f"cg_one_{label}.npy", x.cpu().numpy())
        one_rank[label] = {"max_abs_x": x.abs().max().item(),
                           "residual": float(res)}
        del x, res, b
    (cg_dir / "cg_one.json").write_text(json.dumps(one_rank))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    torch.multiprocessing.start_processes(
        cg_worker, args=(free_port(), str(cg_dir)), nprocs=CG["ranks"],
        join=True, start_method="spawn")
    ranks_wall = time.perf_counter() - t0
    ranks = [json.loads((cg_dir / f"cg_rank{r}.json").read_text())
             for r in range(CG["ranks"])]
    shutil.rmtree(cg_dir)
    face = rn * rn * 4
    for r in ranks:
        for label in ("eigen", "seeded"):
            q = r[label]
            it = q["iters"]
            lim = CG["tol"] * q["one_rank_max_abs_x"]
            if not q["max_abs_diff_vs_one_rank"] <= lim:
                bad.append(f"(b) rank {r['rank']} {label}: x "
                           f"{q['max_abs_diff_vs_one_rank']} from the "
                           f"one-rank solve > {lim}")
            if q["combine_launches"] != 1 + 2 * it:
                bad.append(f"(b) rank {r['rank']} {label}: "
                           f"{q['combine_launches']} combine launches, "
                           f"not {1 + 2 * it}")
            if q["ppermute_bytes"] != 2 * (it + 1) * face:
                bad.append(f"(b) rank {r['rank']} {label}: ppermute bytes "
                           f"{q['ppermute_bytes']}, not "
                           f"{2 * (it + 1) * face}")
            if (not math.isfinite(q["residual"])
                    or q["residual"] != ranks[0][label]["residual"]):
                bad.append(f"(b) rank {r['rank']} {label}: residual "
                           f"{q['residual']}")
        for c in r["kernel_check"]:
            if not c["err"] <= 1e-2:
                bad.append(f"(b) rank {r['rank']}: combine on the CG's "
                           f"partials {c}")
    r0 = ranks[0]
    ranks_line = {
        "ranks": CG["ranks"], "mesh": {"data": CG["ranks"]},
        "backend": "gloo (faces and partials through host memory)",
        "n": rn, "slab": [rn // CG["ranks"], rn, rn], "face_bytes": face,
        "one_rank": one_rank, "wall_s": ranks_wall,
        "solves": {label: {
            "iters": r0[label]["iters"], "wall_s_rank0": r0[label]["wall_s"],
            "ms_per_iteration_rank0": r0[label]["wall_s"]
            / r0[label]["iters"] * 1e3,
            "residual": r0[label]["residual"],
            "combine_launches_per_rank": [r[label]["combine_launches"]
                                          for r in ranks],
            "ppermute_bytes_per_rank": [r[label]["ppermute_bytes"]
                                        for r in ranks],
            "max_abs_diff_vs_one_rank": max(
                r[label]["max_abs_diff_vs_one_rank"] for r in ranks),
            "limit": CG["tol"] * r0[label]["one_rank_max_abs_x"]}
            for label in ("eigen", "seeded")},
        "kernel_check_rank0": r0["kernel_check"],
        "pdot_ms": [r["pdot_ms"] for r in ranks],
        "halo_exchange_ms": [r["halo_exchange_ms"] for r in ranks],
        "halo_exchange_host_ms": [r["halo_exchange_host_ms"]
                                  for r in ranks]}

    emit({"phase": "cg", "one_rank": one, "ranks": ranks_line,
          "host_s": time.perf_counter() - t_phase, "card": smi})

    # (c) the examples' entry points on the card
    t_examples = time.perf_counter()
    examples = {}
    for name, fn in (
            ("cg_solver", lambda: cg_solver.main([])),
            ("quickstart", lambda: quickstart.main([])),
            ("allreduce_accel_demo", lambda: allreduce_accel_demo.main([])),
            ("serve_lm", lambda: serve_lm.main([])),
            ("train_lm", lambda: train_lm.main(["--small", "--steps",
                                                "12"]))):
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                fn()
            last = buf.getvalue().rstrip().splitlines()[-1]
        except Exception as e:      # the line is emitted; the gate raises
            traceback.print_exc()
            last = f"{type(e).__name__}: {e}"
        examples[name] = {"wall_s": time.perf_counter() - t0, "last": last}
        if not last.endswith("OK"):
            bad.append(f"(c) {name}: {last}")
    emit({"phase": "cg_examples", "examples": examples,
          "host_s": time.perf_counter() - t_examples, "card": smi})
    if bad:
        raise AssertionError("cg: " + "; ".join(bad))
    return {"combine_launches": sum(r0[label]["combine_launches"]
                                    for label in ("eigen", "seeded"))}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------- main
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get
    from repro_torch.kernels import _build
    from repro_torch.kernels.allreduce_combine import kernel as ck
    from repro_torch.kernels.allreduce_combine.ops import combine_parts
    from repro_torch.kernels.allreduce_combine.ref import combine_ref
    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.kernels.flash_decode.ops import decode_attn, hbm_bytes
    from repro_torch.kernels.flash_decode.ref import decode_attention_ref
    from repro_torch.kernels.matmul_tile import kernel as mk
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.launch import train as launch_train
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()
    OUT.mkdir(exist_ok=True)

    # ------------------------------------------------------------- 1. env
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": kind,
          "sms": torch.cuda.get_device_properties(0).multi_processor_count})

    # ----------------------------------------------------------- 2. build
    def timed_build(mod):
        t = time.perf_counter()
        mod.build()
        return time.perf_counter() - t

    kmods = (("flash_decode", fd), ("allreduce_combine", ck),
             ("ssd_scan", sk), ("matmul_tile", mk))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(kmods)) as pool:
        futs = {name: pool.submit(timed_build, mod) for name, mod in kmods}
        build_s = {name: f.result() for name, f in futs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "seconds_each": build_s,
          "library": {name: str(_build.library_path(name, mod.SOURCES)
                                .relative_to(ROOT))
                      for name, mod in kmods},
          "ptxas": {name: ptxas_report(_build.build_logs.get(name, ""))
                    for name, _ in kmods}})

    # --------------------------------------------------------- 3. kernels
    cases = [  # (label, B, H, K, dk, dv, S)
        ("jax-test-1", 2, 8, 2, 64, 64, 512),
        ("jax-test-2", 1, 4, 4, 128, 128, 1024),
        ("jax-test-3", 2, 8, 1, 64, 128, 256),
        ("head-dim-80", 2, 32, 32, 80, 80, 1024),   # zamba2's shared block
        ("head-dim-16", 4, 4, 2, 16, 16, 64),   # the serve_lm example's model
    ]
    # a row of 32768 on one kv head: its unit is shared by more CTAs than
    # one pass of the merge stages, so the merge runs in several passes
    cases.append(("long-row", 2, 8, 1, 128, 128, 32768))
    # the shapes of the encoder-decoder and VLM decodes first: internvl's
    # GQA group of 7 is the first on the card that is no power of two
    checks = []
    dims = ("B", "H", "K", "dk", "dv", "S")
    for i, (label, (shape, _, full)) in enumerate(FD_MODEL_TIMING.items()):
        for dtype in (torch.float32, torch.bfloat16):
            checks.append((label, *(shape[x] for x in dims), dtype, 50 + i,
                           full))
    for i, (label, B, H, K, dk, dv, S) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            checks.append((label, B, H, K, dk, dv, S, dtype, 10 + i, False))
    sv = SERVE_SHAPE
    checks.append(("serving", sv["B"], sv["H"], sv["K"], sv["dk"], sv["dv"],
                   sv["S"], torch.bfloat16, 20, False))
    checks.append(("ragged-S1000", sv["B"], sv["H"], sv["K"], sv["dk"],
                   sv["dv"], 1000, torch.bfloat16, 21, False))
    results = []
    for label, B, H, K, dk, dv, S, dtype, seed, full in checks:
        q, k, v, kp, vp, lengths = make_case(B, H, K, dk, dv, S, dtype, seed,
                                             full)
        got = decode_attn(q, kp, vp, lengths)
        again = decode_attn(q, kp, vp, lengths)
        want = decode_attention_ref(q, k, v, lengths)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        reading = fd_reading(got, want)
        same = torch.equal(got, again)
        # the most CTAs that share one unit, against one merge pass
        rep_ = H // K
        n_ctas = fd._grid(0, fd._DTYPE_CODE[dtype], dk, dv, B, K, rep_, S)
        per_unit: dict[tuple, int] = {}
        for _, b, g, tile, _, _ in fd.schedule(
                lengths.tolist(), B, K, fd.row_tiles(rep_), n_ctas):
            per_unit[b, g, tile] = per_unit.get((b, g, tile), 0) + 1
        ctas_of_unit = max(per_unit.values())
        chunk = fd.merge_chunk(dtype, dk, dv, min(rep_, fd.ROW_TILE))
        ok = reading <= 1 and same and (label != "long-row"
                                        or ctas_of_unit > chunk)
        results.append({"case": label, "dtype": str(dtype).split(".")[-1],
                        "shape": [B, H, K, dk, dv, S],
                        "lengths": "all S" if full else "ragged, 1 and S",
                        "max_err": err,
                        "reading": reading, "bitwise_repeat": same,
                        "grid_ctas": n_ctas, "most_ctas_of_a_unit":
                        ctas_of_unit, "merge_pass_partials": chunk,
                        "ok": ok})
        if not ok:
            emit({"phase": "kernels", "checks": results})
            raise AssertionError(f"flash_decode disagrees on {label}: "
                                 f"reading {reading} > 1 ({FD_TOL_TEXT}), "
                                 f"or two calls differ (bitwise equal: "
                                 f"{same}), or no unit needs two merge "
                                 f"passes ({ctas_of_unit} CTAs, {chunk} a "
                                 "pass)")
    graph = fd_graph_check(decode_attn, decode_attention_ref)
    hbm, bf16_peak, f32_peak = card_peaks()
    timings = {name: fd_timing(name, shape, n_sets, decode_attn,
                               decode_attention_ref, hbm_bytes, hbm,
                               bf16_peak)
               for name, (shape, n_sets) in FD_TIMING.items()}
    model_timings = {name: fd_timing(name, shape, n_sets, decode_attn,
                                     decode_attention_ref, hbm_bytes, hbm,
                                     bf16_peak, full)
                     for name, (shape, n_sets, full)
                     in FD_MODEL_TIMING.items()}
    # the lse form: its float32 output against the plain version's rounded
    # to bf16 (FD_TOL of bf16); its bound counts that output and the lse
    lse_timing = fd_timing(
        "seq_block", *FD_LSE_TIMING,
        lambda q, k, v, n: decode_attn(q, k, v, n, lse=True)[0],
        lambda q, k, v, n: decode_attention_ref(q, k, v, n, lse=True)[0]
        .to(q.dtype), functools.partial(hbm_bytes, lse=True), hbm,
        bf16_peak, True, make_case_on_card)
    planted = {}
    for name, (shape, _) in FD_TIMING.items():
        B, H, K, dk, dv, S = (shape[x] for x in ("B", "H", "K", "dk", "dv",
                                                 "S"))
        planted[name] = fd_planted(fd, make_case(
            B, H, K, dk, dv, S, torch.bfloat16, 30),
            fd._grid(0, 1, dk, dv, B, K, H // K, S))
    fd_serve = timings["serving"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bps = fd._blocks_per_sm(0, 1, sv["dk"], sv["dv"], sv["B"])
    emit({"phase": "kernels", "checks": results, "tol": FD_TOL_TEXT,
          "graph_replay": graph, "timings": timings,
          "model_timings": model_timings, "lse_timing": lse_timing,
          "planted_faults": planted,
          "schedule": {"span": fd.SPAN, "row_tile": fd.ROW_TILE,
                       "blocks_per_sm": bps,
                       "grid_ctas": fd.grid_ctas(
                           sv["B"], sv["K"], sv["H"] // sv["K"], sv["S"],
                           sms, bps)},
          "card": smi})

    # --------------------------------------------------------- 4. combine
    c_results = combine_checks()
    P, L = COMBINE_TIMING_SHAPE
    # eight distinct (2, 2.5M) f32 inputs (160 MB) in turn: cold in L2, as
    # the sync's buckets arrive
    c_sets = [torch.randn((P, L), device="cuda",
                          generator=torch.Generator("cuda").manual_seed(60 + j))
              for j in range(8)]
    c_turn = {"i": 0}

    def c_nxt():
        c_turn["i"] = (c_turn["i"] + 1) % len(c_sets)
        return c_sets[c_turn["i"]]

    c_ms = time_ms(lambda: combine_parts(c_nxt(), op="sum"))
    c_eager_ms = time_eager_ms(lambda: combine_parts(c_nxt(), op="sum"))
    c_plain_ms = time_ms(lambda: combine_ref(c_nxt(), "sum"))
    c_lib_ms = time_ms(lambda: torch.sum(c_nxt(), 0, dtype=torch.float32))
    c_bytes = (P + 1) * L * 4
    c_bytes_ms = c_bytes / hbm * 1e3
    c_ops_ms = (P - 1) * L / f32_peak * 1e3
    c_bound_ms = max(c_bytes_ms, c_ops_ms)
    c_max_err = max(r["max_err"] for r in c_results)
    emit({"phase": "combine", "checks": c_results,
          "all_bitwise": all(r["bitwise"] for r in c_results),
          "timing_shape": [P, L], "kernel_us": c_ms * 1e3,
          "kernel_eager_us": c_eager_ms * 1e3, "ref_us": c_plain_ms * 1e3,
          "library_us": c_lib_ms * 1e3,
          "library": "torch.sum(x, 0, dtype=torch.float32)",
          "bound_us": c_bound_ms * 1e3, "bound_bytes": c_bytes,
          "achieved_GBps": c_bytes / (c_ms * 1e-3) / 1e9, "card": smi})
    del c_sets

    # ---------------------------------------------------------- 5. matmul
    mm_lines, mm_entry = matmul_phase(smi)
    for line in mm_lines:
        emit(line)

    # ----------------------------------------------------------- 6. serve
    cfg = get("exanest-lm-100m")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    warm = ServeEngine(model, params, slots=2, window=64, device="cuda")
    warm.submit([1, 2, 3], max_new_tokens=2)
    warm.run_until_idle()
    del warm
    eng = ServeEngine(model, params, slots=8, window=2048, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(64, 1025, 16)]
    torch.cuda.synchronize()
    fd.launches = 0
    ck.launches = 0
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=32) for p in prompts]
    eng.run_until_idle(max_steps=16)          # mid-decode of the first wave
    k0 = eng.cache["dense"]["k"][0].clone()
    v0 = eng.cache["dense"]["v"][0].clone()
    pos0 = eng.pos.copy()
    eng.run_until_idle(max_steps=100000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fd.launches
    calls = eng.decode_calls
    outs = [eng.result(r) for r in rids]
    done = sum(o is not None and len(o) == 32 for o in outs)
    if done != 16:
        raise AssertionError(f"served {done}/16 requests")
    if not all(0 <= t < cfg.vocab_size for o in outs for t in o):
        raise AssertionError("a generated token lies outside the vocabulary")
    if launches != cfg.n_layers * calls or calls == 0:
        raise AssertionError(f"flash_decode launched {launches} times over "
                             f"{calls} decode_step calls; expected "
                             f"{cfg.n_layers} per call")
    lens0 = torch.from_numpy(np.minimum(pos0 + 1, 2048).astype(np.int32)).cuda()
    q0 = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8, cfg.n_heads, cfg.resolved_head_dim), np.float32)).cuda().bfloat16()
    got = decode_attn(q0, k0, v0, lens0)
    want = decode_attention_ref(q0, k0, v0, lens0)
    cache_err = (got.float() - want.float()).abs().max().item()
    cache_reading = fd_reading(got, want)
    if not cache_reading <= 1:
        raise AssertionError(f"flash_decode on the engine's cache: reading "
                             f"{cache_reading} > 1 ({FD_TOL_TEXT})")
    n_tok = sum(len(o) for o in outs)
    prompt_tok = sum(len(p) for p in prompts)
    # rows fed a token and the context each attends, per decode_step (the
    # serve_sim phase sets the simulator's roofline beside this phase)
    live_rows, contexts = serve_schedule([len(p) for p in prompts], 32,
                                         eng.slots, eng.window)
    if len(live_rows) != calls:
        raise AssertionError(f"the engine made {calls} decode_step calls, "
                             f"its schedule {len(live_rows)}")
    serve_reading = {"ms_per_decode_step": wall / calls * 1e3,
                     "mean_live_rows": sum(live_rows) / len(live_rows),
                     "mean_context": sum(contexts) / len(contexts)}
    emit({"phase": "serve", "arch": cfg.name, "dtype": cfg.dtype,
          "slots": 8, "window": 2048, "requests": 16, "done": done,
          "prompt_tokens": prompt_tok, "new_tokens": n_tok,
          "decode_step_calls": calls, "flash_decode_launches": launches,
          "wall_s": wall, **serve_reading,
          "tok_per_s": (prompt_tok + n_tok) / wall,
          "new_tok_per_s": n_tok / wall,
          "engine_cache_check": {"lengths": lens0.cpu().tolist(),
                                 "max_err": cache_err,
                                 "reading": cache_reading,
                                 "tol": FD_TOL_TEXT},
          "first_tokens": outs[0][:8], "card": smi})

    # --------------------------------------------------------- 7. profile
    # where a decode_step's time goes: the engine's own call (decode_step on
    # its cache at the mid-run positions, logits back to the host), traced
    batch = {"token": torch.zeros(8, dtype=torch.int32, device="cuda"),
             "pos": torch.from_numpy(pos0).cuda()}

    def one_step():
        lg, _ = model.decode_step(params, eng.cache, batch)
        lg[:, 0].float().cpu()

    for _ in range(3):
        one_step()
    torch.cuda.synchronize()
    n_prof = 8
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            one_step()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    emit(profile_summary(prof, n_prof, prof_wall, smi))
    prof.export_chrome_trace(str(OUT / "decode_step_trace.json"))
    del eng, params, prof
    torch.cuda.empty_cache()

    # -------------------------------------------------------------- 8. dp
    for f in OUT.glob("dp_rank*.json"):
        f.unlink()
    t0 = time.perf_counter()
    torch.multiprocessing.start_processes(
        dp_worker, args=(free_port(), str(OUT)), nprocs=DP["world"],
        join=True, start_method="spawn")
    dp_wall = time.perf_counter() - t0
    ranks = [json.loads((OUT / f"dp_rank{r}.json").read_text())
             for r in range(DP["world"])]
    r0 = ranks[0]
    dp_launches = sum(s["combine_launches"] for s in r0["steps"].values())
    for r in ranks:
        for key, s in r["steps"].items():
            if s["combine_launches"] != s["expected"]:
                raise AssertionError(f"rank {r['rank']} {key}: combine "
                                     f"launches {s['combine_launches']}")
    if dp_launches == 0:
        raise AssertionError("combine never launched on the dp path")
    emit({"phase": "dp", "arch": "exanest-lm-100m", "mesh": {"pod": 2,
                                                             "data": 2},
          "backend": "gloo", "device_per_rank": "cuda:0",
          "transport": "gloo moves CUDA tensors through host memory; every "
                       "reduction of the hierarchical and compressed syncs "
                       "runs in allreduce_combine on the card in each rank",
          "global_batch": DP["global_batch"], "seq": DP["seq"],
          "buckets": r0["buckets"], "bucket_elems": r0["bucket_elems"],
          "steps": r0["steps"], "bucket_check": r0["bucket_check"],
          "bucket_check_launches": {
              k: r0[f"bucket_check_launches_{k}"]
              for k in ("flat", "hierarchical", "compressed")},
          "single_check": r0["single_check"],
          "first_step_gathered_from": r0["gathered_from"],
          "auto": {"plans": {k: r0[f"{k}_plan"]
                             for k in ("auto", "auto_lossy")},
                   "planner_ms_per_sync": {
                       k: r0[f"{k}_planner_ms"]
                       for k in ("auto", "auto_lossy")},
                   "vs_hierarchical_bitwise":
                       r0["auto_vs_hierarchical_bitwise"],
                   "mixed": r0["mixed"]},
          "coords": [r["coords"] for r in ranks],
          "combine_launches_rank0": dp_launches,
          "combine_launches_all_ranks": sum(
              s["combine_launches"] for r in ranks
              for s in r["steps"].values()),
          "wall_s": dp_wall,
          "rank0_section_s": r0["section_s"], "card": smi})
    dp_steps = sum(1 for k in r0["steps"] if not k.startswith("flat"))

    # ----------------------------------------------------------- 9. train
    ckpt = OUT / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    fd.launches = 0
    ck.launches = 0
    run = launch_train.main([
        "--arch", "exanest-lm-100m", "--steps", str(TRAIN["steps"]),
        "--batch", str(TRAIN["batch"]), "--seq", str(TRAIN["seq"]),
        "--lr", str(TRAIN["lr"]), "--ckpt-dir", str(ckpt),
        "--device", "cuda"])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = run["losses"]
    manifest = json.loads((ckpt / "step-00000000" / "manifest.json")
                          .read_text())
    n_leaves = len(manifest["leaves"])
    shutil.rmtree(ckpt)                 # ~1.5 GB: not brought back
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    steady_ms = run["steady_s_per_step"] * 1e3
    tokens = TRAIN["batch"] * TRAIN["seq"]
    emit({"phase": "train", "arch": cfg.name, "dtype": cfg.dtype,
          "entry": "repro_torch.launch.train.main", **TRAIN,
          "losses": losses, "first5_mean": first5, "last5_mean": last5,
          "threshold": f"last5_mean <= first5_mean - {TRAIN['min_drop']}",
          "wall_s": run["wall_s"], "ms_per_step_wall": steady_ms,
          "tok_per_s": tokens / (steady_ms / 1e3),
          "peak_mem_GB": peak_gb, "ckpt_step0_leaves": n_leaves,
          "flash_decode_launches": fd.launches,
          "combine_launches": ck.launches, "card": smi})
    if not all(np.isfinite(losses)):
        raise AssertionError(f"a train loss is not finite: {losses}")
    if not last5 <= first5 - TRAIN["min_drop"]:
        raise AssertionError(f"the loss did not fall: mean of the first 5 "
                             f"{first5}, of the last 5 {last5}")
    state = run.pop("state")

    # -------------------------------------------------- 10. train_profile
    from repro_torch import tree as tree_util
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models.attention import flash_attention
    from repro_torch.models.layers import lm_loss
    from repro_torch.train.loop import Trainer
    from repro_torch.train.optimizer import AdamWConfig, adamw_update
    tr = Trainer(model, AdamWConfig(lr=TRAIN["lr"], warmup_steps=6,
                                    decay_steps=TRAIN["steps"]), device="cuda")
    data = SyntheticTokens(cfg, batch=TRAIN["batch"], seq=TRAIN["seq"],
                           device="cuda")
    step_fn = tr.make_step()
    st = state
    for i in range(2):
        st, _ = step_fn(st, data.batch_at(100 + i))
    torch.cuda.synchronize()
    n_prof = 3
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(n_prof):
            st, _ = step_fn(st, data.batch_at(200 + i))
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    kernels = device_kernels(prof, n_prof)
    busy = sum(ms for _, ms, _ in kernels)
    wall_ms = prof_wall / n_prof * 1e3
    del prof

    # the step's parts, each timed alone (wall, host work included)
    p = st["params"]
    B, Sq = TRAIN["batch"], TRAIN["seq"]
    g = torch.Generator("cuda").manual_seed(70)
    h = torch.randn((B, Sq - 1, cfg.d_model), device="cuda", generator=g
                    ).bfloat16().requires_grad_(True)
    tgt = data.batch_at(0)["labels"][:, 1:]
    head = p["embed"]["head"].detach().requires_grad_(True)

    def loss_part():
        lm_loss({"head": head}, h, tgt, cfg).backward()

    qkv = [torch.randn((B, Sq, n, cfg.resolved_head_dim), device="cuda",
                       generator=g).bfloat16().requires_grad_(True)
           for n in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads)]
    dout = torch.randn((B, Sq, cfg.n_heads, cfg.resolved_head_dim),
                       device="cuda", generator=g).bfloat16()

    def attn_part():
        for _ in range(cfg.n_layers):
            out = flash_attention(*qkv, causal=True, q_chunk=cfg.q_chunk,
                                  kv_chunk=cfg.kv_chunk)
            out.backward(dout)

    grads = tree_util.tree_map(lambda t: torch.randn(
        t.shape, device="cuda", generator=g).to(t.dtype) * 1e-3, p)

    def opt_part():
        adamw_update(grads, st["opt"], p, tr.opt_cfg)

    with torch.no_grad():
        opt_ms = time_eager_ms(opt_part, reps=10)
    loss_ms = time_eager_ms(loss_part, reps=10)
    attn_ms = time_eager_ms(attn_part, reps=5)
    emit({"phase": "train_profile", "steps": n_prof,
          "ms_per_step_wall_profiled": wall_ms,
          "device_busy_ms_per_step": busy, "idle_share": 1 - busy / wall_ms,
          "idle_share_vs_unprofiled_wall": 1 - busy / steady_ms,
          "kernels_per_step": sum(n for *_, n in kernels),
          "top": [[name[:80], ms, n] for name, ms, n in kernels[:10]],
          "parts_ms_wall": {"lm_loss_fwd_bwd": loss_ms,
                            "flash_attention_fwd_bwd_12_layers": attn_ms,
                            "adamw_update": opt_ms},
          "parts_share_of_step": {"lm_loss_fwd_bwd": loss_ms / steady_ms,
                                  "flash_attention_fwd_bwd_12_layers":
                                      attn_ms / steady_ms,
                                  "adamw_update": opt_ms / steady_ms},
          "card": smi})
    del st, state, p, grads, qkv, h, head, run, model
    torch.cuda.empty_cache()

    # ------------------------------------------------ 11-14. Mamba-2 phases
    ssd_entry = ssm_phases(smi, acts)

    # ----------------------------------------------- 15-17. hybrid phases
    # the Mamba-2 model, its optimizer state and caches are gone with
    # ssm_phases' frame; the peak is read anew for zamba2
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    hybrid = hybrid_phases(smi, acts)
    ssd_entry["hybrid"] = hybrid["ssd_scan"]

    # -------------------------------------------------- 18-22. MoE phases
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    moe_readings = moe_phases(smi, acts)

    # ------------------------------------------- 23-27. deepseek phases
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ds = ds_phases(smi, acts)
    ssd_entry["deepseek"] = ds["ssd_scan"]
    mm_entry["deepseek"] = ds["matmul_tile"]

    # ------------------------------------------------------------ 28. shard
    gc.collect()
    torch.cuda.empty_cache()
    shard = shard_phase(smi)
    ssd_entry["shard"] = shard["ssd_scan"]
    ssd_entry["launches_by_path"] = {"ssm_train": ssd_entry["launches"],
                                     "shard": shard["ssd_scan"]["launches"]}
    ssd_entry["launches"] += shard["ssd_scan"]["launches"]

    # ------------------------------------- 29-32. whisper and VLM phases
    gc.collect()
    torch.cuda.empty_cache()
    whisper = whisper_phases(smi)
    vlm = vlm_phases(smi)

    # --------------------------------------------- 33-34. the simulator
    gc.collect()
    torch.cuda.empty_cache()
    exanet_sim_phase(smi, acts)

    # ------------------------- 35-37. the studies and the simulators
    sim_studies_phases(smi, acts, serve_reading)

    # ----------------------------------------------------------- 38. dryrun
    gc.collect()
    torch.cuda.empty_cache()
    dryrun_phase(smi, ds["train_peak"], shard["dryrun"])

    # --------------------------------------------------------------- 39. cg
    gc.collect()
    torch.cuda.empty_cache()
    cg = cg_phase(smi)

    # ---------------------------------------------------------- summary
    emit({"phase": "done", "total_s": time.perf_counter() - t_start})
    emit({"kernels": [{
        "name": "flash_decode", "route": "cuda", "source": KERNEL_SRC,
        "replaces": TPU_SRC, "launches": launches + shard["flash_decode"][
            "launches"] + whisper["launches"] + vlm["launches"],
        "max_abs_err": max(r["max_err"] for r in results),
        "ms": fd_serve["kernel_ms"], "plain_ms": fd_serve["plain_ms"],
        "bound_ms": fd_serve["bound_ms"], "bound_by": fd_serve["bound_by"],
        "library_ms": fd_serve["library_ms"], "tol": FD_TOL_TEXT,
        "max_reading": max(r["reading"] for r in results), "path": "serve",
        "launches_per_decode_step": launches / calls,
        "hybrid": hybrid["flash_decode"], "moe": moe_readings["flash_decode"],
        "deepseek": ds["flash_decode"], "shard": shard["flash_decode"],
        "whisper": whisper, "vlm": vlm,
        "launches_by_path": {"serve": launches,
                             "shard": shard["flash_decode"]["launches"],
                             "whisper_decode": whisper["launches"],
                             "vlm_decode": vlm["launches"]},
        "model_timings": {name: {x: model_timings[name][x] for x in (
            "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "share_of_bound")} for name in model_timings},
        "long": {x: timings["long"][x] for x in (
            "kernel_ms", "kernel_eager_ms", "plain_ms", "bound_ms",
            "library_ms", "share_of_bound")},
        "lse_seq_block": {x: lse_timing[x] for x in (
            "shape", "kernel_ms", "kernel_eager_ms", "plain_ms", "bound_ms",
            "bound_bytes", "library_ms", "share_of_bound",
            "check_reading")}}, {
        "name": "allreduce_combine", "route": "cuda", "source": COMBINE_SRC,
        "replaces": COMBINE_TPU_SRC,
        "launches": dp_launches + shard["combine"]["launches"]
        + cg["combine_launches"],
        "max_abs_err": c_max_err, "ms": c_ms, "plain_ms": c_plain_ms,
        "bound_ms": c_bound_ms,
        "bound_by": "bytes" if c_bytes_ms >= c_ops_ms else "operations",
        "library_ms": c_lib_ms, "tol": 1e-2, "path": "dp (rank 0)",
        "launches_per_synced_step": dp_launches / max(dp_steps, 1),
        "moe_ep": moe_readings["combine"],
        "deepseek": ds["allreduce_combine"], "shard": shard["combine"],
        "launches_by_path": {"dp": dp_launches,
                             "shard": shard["combine"]["launches"],
                             "cg": cg["combine_launches"]}},
        ssd_entry, mm_entry]})
    (OUT / "chip_smoke.json").write_text(json.dumps(LINES, indent=1))
    print(smi, flush=True)
    # the card this run used: every phase runs on cuda:0 alone
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": 1}}), flush=True)
    return 0


def dryrun_phase(smi: str, ds_peak: dict, shard_dry: dict) -> dict:
    """Phase 38 (see the module docstring): emits the dryrun line and one
    dryrun_cell line a DRYRUN_CELLS entry; raises on a failed gate."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.config import ShapeConfig
    from repro_torch.configs import get
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import adamw_init
    t0 = time.perf_counter()
    bad = []
    # the train phase's step: reckoned on meta, then run on the card
    cfg = get("exanest-lm-100m")
    shp = ShapeConfig("train", TRAIN["seq"], TRAIN["batch"], "train")
    cell, meta = dryrun.lower_cell(cfg, shp, False, mesh_shape=(),
                                   donate=False)
    dry = dryrun.analyze(cell, meta)
    model = build_model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0),
                        device="cuda")
    opt = adamw_init(params, dryrun._opt_config(cfg))
    batch = SyntheticTokens(cfg, batch=TRAIN["batch"], seq=TRAIN["seq"],
                            device="cuda").batch_at(0)
    fn = cell.make_fn()
    fn(params, opt, batch)          # first call: workspaces, kernels built
    other = step_peak_start(True, (params, opt, batch))
    fn(params, opt, batch)
    peak = step_peak(True, other)
    with FlopCounterMode(display=False) as fc:
        fn(params, opt, batch)
    torch.cuda.synchronize()
    card_flops = fc.get_total_flops()
    del params, opt, batch, model
    torch.cuda.empty_cache()
    train = {"cell": "exanest-lm-100m 8 x 512, one rank, functional step",
             "flops": dry["flops"], "card_flops": card_flops,
             "peak_bytes": dry["memory"]["peak_bytes"],
             "card_peak_bytes": peak, "trace_s": dry["trace_s"]}
    if card_flops != dry["flops"]:
        bad.append(f"train: FLOPs {dry['flops']} against the card's "
                   f"{card_flops}")
    if not within_band(dry["memory"]["peak_bytes"], peak):
        bad.append(f"train: peak {dry['memory']['peak_bytes']} B against "
                   f"the card's {peak} B")
    # ds_train's donated step
    _, tcfg = ds_configs()
    cell, meta = dryrun.lower_cell(
        tcfg, ShapeConfig("ds_train", DS_TRAIN["seq"], DS_TRAIN["batch"],
                          "train"), False, mesh_shape=())
    ds = dryrun.analyze(cell, meta)
    ds_line = {"cell": "deepseek-v3-671b cut (ds_configs), 2 x 2048, one "
                       "rank, donated step",
               "peak_bytes": ds["memory"]["peak_bytes"],
               "card_peak_bytes": ds_peak["bytes"],
               "meta_tree_reckoned_bytes": round(ds_peak["reckoned_GB"]
                                                 * 1e9),
               "flops": ds["flops"], "trace_s": ds["trace_s"]}
    for key in ("card_peak_bytes", "meta_tree_reckoned_bytes"):
        if not within_band(ds["memory"]["peak_bytes"], ds_line[key]):
            bad.append(f"ds_train: peak {ds['memory']['peak_bytes']} B "
                       f"against {key} {ds_line[key]} B")
    r0 = shard_dry["reckoned"][0]
    shard_line = {"cell": "exanest-lm-100m 8 x 512 on (2, 2, 2), each rank",
                  "wire_bytes_step0_rank0": shard_dry["wire_bytes"],
                  "dry_wire_bytes_rank0": r0["off"]["wire_bytes"],
                  "peak_bytes": {r: [d["off"]["peak_bytes"],
                                     d["on"]["peak_bytes"]]
                                 for r, d in shard_dry["reckoned"].items()},
                  "card_peak_bytes_steps": shard_dry["steps"],
                  "seq_shard": {r: {k: q[k] for k in (
                      "loss_equal", "grads_equal", "params_equal",
                      "combine_launches", "peak_bytes", "seq_gather_bytes")}
                      for r, q in shard_dry["seq_shard"].items()},
                  "trace_s_rank0": [r0["off"]["trace_s"],
                                    r0["on"]["trace_s"]]}
    cells = {}
    for label, arch, shape, multi in DRYRUN_CELLS:
        r = dryrun.run_cell(arch, shape, multi)
        line = {"phase": "dryrun_cell", "family": label,
                **{k: r[k] for k in ("arch", "shape", "mesh", "trace_s",
                                     "memory", "fits_h100", "flops",
                                     "bytes_accessed", "collective_bytes",
                                     "kernels", "roofline")}}
        emit(line)
        cells[label] = {k: r[k] for k in ("trace_s", "fits_h100")}
    host_s = time.perf_counter() - t0
    emit({"phase": "dryrun", "band": {"relative": DRYRUN_BAND[0],
                                      "bytes": DRYRUN_BAND[1]},
          "train": train, "ds_train": ds_line, "shard_a": shard_line,
          "cells": cells, "host_s": host_s,
          "reckoned_against": "roofline/hw.py H100 (data sheet, 700 W)",
          "card": smi})
    if bad:
        raise AssertionError("dryrun: " + "; ".join(bad))
    return {"host_s": host_s}


def fd_timing_from(src: Path) -> int:
    """The second form of the script: flash_decode from the package under
    ``src`` at FD_TIMING's shapes, one JSON line each, then nvidia-smi's
    name and power limit."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src.resolve()))
    from repro_torch.kernels.flash_decode.ops import decode_attn, hbm_bytes
    from repro_torch.kernels.flash_decode.ref import decode_attention_ref

    hbm, bf16_peak, _ = card_peaks()
    for name, (shape, n_sets) in FD_TIMING.items():
        emit({"fd_timing": name, "src": str(src), **fd_timing(
            name, shape, n_sets, decode_attn, decode_attention_ref,
            hbm_bytes, hbm, bf16_peak)})
    print(nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--fd-timing-from"] and len(sys.argv) == 3:
        sys.exit(fd_timing_from(Path(sys.argv[2])))
    sys.exit(main())
