"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--out DIR]
    python3 chip_smoke.py --cards N
                                        (N cards: only the multi-card phases)

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. env      torch / CUDA versions and the card (nvidia-smi name, power limit).
2. build    compile every kernel from danerf_tpu_torch/kernels/csrc (nvcc,
            sm_90a, all sources at once); one line of each kernel's
            registers, shared memory and spills (-Xptxas -v; K1, K2 and K5
            with their dynamic shared memory; the tile and dW pass of K3,
            K4, K6-K9 and of their f32 variants apart); the full reports go
            to DIR/build.log.
3. kernels  at full width (default NeRFConfig: 8x256, bf16) on seeded inputs,
            each kernel against its plain PyTorch version on the card,
            within fused_render.PLAIN_TOL, at 4093 rays (a ragged tile) and
            at one 65,536-ray chunk: K2 with want_field at 64 samples
            (medium's coarse pass) and without at 32 (preview), K5 at
            64 + 64 with z_f from sample_pdf of K2's weights; at 4093 rays
            the shapes of csrc/field_sm90.cuh's tile (tile_shapes: K2 at S =
            32, 48, 64, 100, 128 with and without its field, K5 at 64 + 64,
            64 + 16, 128 + 128 with and without the appearance projection,
            two calls bit for bit); K1 (csrc/field_sm90.cuh's row tile) on
            the points of 4093 x 32 = 130,976 rows (ragged), and of 65,536
            and 131,072 rows (the coarse and fine evaluations of a 1024-ray
            batch), with and without the appearance projection, two calls
            bit for bit, and at 130,976 rows with the softplus density
            activation (a model of its own); and
            render_rays' fused route against its reference route and its
            per-sample kernel route (K1) on 512 rays.
4. bwd      the backward and training kernels against their plain versions
            at 37 rays (19 blocks, so a lost or doubled block shows) and at
            the 1024-ray training batch: K3 with every cotangent seeded
            non-zero, want_field on and off; K4 and K7 with a seeded target
            (K4's field_c from K2, z_f from sample_pdf); K6 with every
            cotangent seeded and a coarse/fine tie in z; K8 with seeded
            per-row cotangents at 2,400 rows (19 tiles) and 131,072.
            Per-ray (per-row) outputs and the loss by max abs error, each
            parameter gradient by relative Frobenius error; K3, K7 and K8
            twice, which must agree bit for bit.
4a. bwd_shapes  K3, K7, K4 and K6 (csrc/field_bwd_sm90.cuh) at every shape
            their tile takes, at 37 rays, the 1024-ray batch and 4093 rays:
            K3 at S = 32, 48, 64, 100, 128 with every cotangent and g_field,
            without g_field, with only g_rgb, and at S = 64 with every
            cotangent null (exact zeros); K7 at the same S, seeded targets;
            K4 at Sc + Sf = 64 + 64, 64 + 16, 64 + 48, 128 + 128; K6 at the
            same with a coarse/fine tie under every cotangent, the
            white-background pattern (g_rgb, g_acc), only g_rgb and none
            (exact zeros); all with the appearance projection packed as
            zeros at 64 (+ 64); two calls bit for bit; the shapes K3, K4,
            K6, K7, K8 and K9 refuse; run again on the time model after
            4b.
4b. time_kernels  the has_time variants (use_time, 6 time levels: the
            encoded time at the first and the skip layers, kx = 80) on a
            model of their own, each ray's (row's) time uniform in [0, 1]:
            K2 (want_field) and K5 at 4093 rays and on a 65,536-ray chunk,
            and at tile_shapes' shapes; K3 and K6 (every cotangent; K6 with a coarse/fine tie) at 37
            rays and at B = 1024, K4 and K7 at 37 rays, K1 at 4,093 and
            130,976 rows and K8 at 37, 129 and 2,400 rows, against their
            plain versions.
4c. hier_onepass  K9, the one-kernel hierarchical training step, and its
            has_time variant on the time model, against their plain
            versions at 37 rays and at B = 1024, at Sc + Sf = 64 + 64,
            64 + 16, 128 + 128, 48 + 32 and 32 + 64 (seeded targets,
            uniforms from importance_uniforms); both MSEs, every gradient
            and demb; two calls agree bit for bit.
4d. f32_kernels  the f32 configuration (use_bf16=False) of the forward
            kernels, K2, K5 and K1 on csrc/field_f32_sm90.cuh (3xTF32
            wgmma; K1 on its row tiles), with and without time, against their f32 plain versions (TF32 off, the
            flags printed) within fused_render.PLAIN_TOL_F32 at the shapes
            tile_shapes takes and up to a 65,536-ray chunk and 131,072 rows;
            beside each the bf16 kernel's error against the same f32 plain
            outputs, at least F32_GAIN = 16 times the f32 kernel's.
4e. f32_path  an 800x800 medium frame of render_path with use_bf16=False
            (exactly 10 f32 K2 and 10 f32 K5 launches, its ms, beside the
            bf16 frame), render_rays' per-sample route on a chunk (2 f32
            K1), both again on the time model at t = 0.5 (the has_time
            variants), and the f32 kernels' and plain versions' ms on a
            chunk (K1 at 131,072 rows), with and without time, beside their
            bounds: K2 and K5 at TF32's dense rate, three products a MAC
            (also FP32's FFMA bound and the GB of weights each streams from
            L2), K1 at the same two; then where the f32 and bf16
            frames' time goes outside the kernels: render_frame alone (its
            host issue time and its ms to the device's end), the PNG and
            npy writes render_path adds, pack_params, and the host time of
            one K2 and one K5 launch.
4f. f32_bwd  the f32 configuration of the backward and training kernels,
            K3, K7, K4 and K6 on csrc/field_bwd_f32_sm90.cuh (3xTF32
            wgmma, relu gates from an FFMA gate pass), against
            their f32 plain versions (TF32 off) within
            fused_render.PLAIN_TOL_F32_BWD at 37 rays, B = 1024 and 4093
            rays (where a relu gate flips: the plain version on the CPU,
            cpu_referee): K3 and K7 at S = 32, 48, 64, 100, 128 (K3 with every
            cotangent and g_field, without g_field, and every cotangent
            null: exact zeros), K4 and K6 at 64 + 64, 64 + 16, 64 + 48,
            128 + 128 (K6 with a coarse/fine tie under every cotangent and
            the white-background pattern); the has_time variants on the
            time model at 37 rays and B = 1024; two calls bit for bit;
            beside each the bf16 kernel's error against the same f32 plain
            outputs, at least F32_GAIN times the f32 kernel's; the shapes
            the bf16 kernels refuse refused in f32 too; then K8
            (csrc/mlp_bwd_f32.cu) at 37, 4,093, 65,536 and 131,072 rows and
            K9 (csrc/hier_onepass_f32.cu) at Sc + Sf = 64 + 64, 64 + 16,
            128 + 128, 48 + 32 and 32 + 64 at 37 rays and B = 1024, with
            and without time, the same way (K9's gradients within
            grad_rel_k9, its losses and demb within the tight keys); the
            four's ms at B = 1024 (also with time) and at 8,192 rays x 64,
            K1 and K8 at 65,536 and 131,072 rows and K9 at B = 1024 (also
            with time) beside their bounds (the backward kernels at
            3xTF32's, tf32x3_bwd_bound, K1 at FP32's, each with the other
            beside) and the plain versions' ms.
4g. f32_train  f32 training through the library entry points (no CLI
            flag, as in the JAX CLI): one f32 step of 64 + 64, coarse-only,
            white background, use_time, per sample (two f32 K1, two f32
            K8) and in one kernel (one f32 K9) at B = 1024 through the
            kernels against the plain step (exactly the f32 launches, none
            of a bf16 kernel; the loss and gradients within
            PLAIN_TOL_F32_BWD's loss and step_grad_rel, the parameters after
            one Adam step); 10 chained f32 steps against 10 eager ones bit
            for bit on 64 + 64, coarse-only, white background, per sample
            and in one kernel; train() for 100 f32 steps of 64 + 64 (one
            f32 K2, K4, K3 a step) and 100 per sample (two f32 K1, two f32
            K8 a step), each with a rising PSNR and a checkpoint;
            evaluate() with the embedding fit on the 64 + 64 checkpoint
            (2 100x100 views, each fit step an f32 K2, K5, K6, K3), each
            view within 0.1 dB PSNR of the plain route on the card.
5. step     one training step at B = 1024 on each training path (64 + 64;
            coarse only, num_importance=0; 64 + 64 on a white background;
            64 + 64 per sample, use_fused_train=False; 64 + 64 with
            use_time; 64 + 64 in one kernel, use_hier_onepass), each built
            twice from the same module, table, batch and draws: through the
            kernels and through their plain versions; the launches, loss,
            every gradient and the parameters after one Adam step compared;
            the one-kernel step also against the 64 + 64 step through K2,
            K4 and K3.
6. render   the serving path: a seeded full-width model saved as a
            reference-format .pt, rendered by `cli.main render` (two
            400x400 medium frames, then one preview frame); launch counts
            are zeroed just before each and read just after.
6a. chained  several steps a call (make_train_step, steps_per_call=10: the
            steps captured once as a CUDA graph, one replay a call): for
            each training path at B = 1024 on a pool of 20 random 100x100
            images, from one seeded state (5 warm-up steps of 64 rays), 10
            replayed steps against 10 eager steps, bit for bit: parameters,
            table, Adam's moments and step counts, the rate, StepLR, each
            step's metrics and the generator's next draw, with exactly the
            path's launches per step on both; on 64 + 64 also 3 replays
            against 30 eager steps with scheduler_step_size=7 (rate changes
            inside a replay), and train() for 40 steps (a checkpoint every
            20) against 20 steps, a resume and 20 more (the final
            checkpoints and the rows of steps 21-40).
7. train    the training paths through `cli.main train` on the procedural
            scene (its static form rendered once and loaded from the PNGs
            of its nerf_synthetic layout, scene_path; the time-varying
            form rendered by each run; 5 warm-up steps of 64 rays, then
            1024, 10 steps a call:
            one graph replay a full chunk), launch counts zeroed just before
            each run: 200 steps of 64 + 64 with --checkpoint_every 100
            (exactly one K2, K4 and K3 launch a step, plus one K2 and one
            K5 for each checkpoint's validation render; render_000100.png
            and training_curves.png must decode; then --resume to 250
            steps, exactly the launches of 50 steps, rows 201-250 appended;
            then `render` of the final checkpoint), 100 steps of
            `--num_importance 0` (one K7 a step and nothing else), 100 steps
            of `--white_background` (one K2, K5, K6 and K3 a step); then 100
            steps of the per-sample route, which has no CLI flag (nor has
            the JAX CLI): train() with use_fused_train=False (two K1 and two
            K8 a step and nothing else); 100 steps of `--use_time` on the
            time-varying scene (one K2, K5, K6 and K3 a step, the has_time
            variants; then `render --use_time --animate_time` of its
            checkpoint, two 400x400 medium frames); 100 steps of
            use_hier_onepass, which has no CLI flag either, through train()
            (one K9 a step and nothing else); one metrics.jsonl row a step,
            finite losses and a rising PSNR.
7e. eval    `cli.main eval` on the checkpoints of 7 (64 + 64, white
            background, use_time; 100x100 procedural views): --max_views 2
            of --split val with and without --optimize_embeddings (the
            test-time fit: 50 Adam steps on one appearance embedding, the
            model frozen, each step K2, K5 forward and K6, K3 backward, one
            CUDA-graph replay a view), of --split train, and a fit under
            --num_importance 0 (K2, K3); exactly those launches plus one K2
            and one K5 a frame chunk (zeroed just before each run, read
            just after); per view within 0.1 dB PSNR and 0.005 SSIM of the
            same command with --no_pallas on the card; one view's graph fit
            equal to its eager fit bit for bit.
7h. native  (after 7f) whether the native shader tool builds on this host
            (danerf_tpu_torch/native ensure_built into build/shader_processor/)
            and runs, and why not (cmake, a build tool, a compiler, libpng,
            libjpeg: what was found, the configure's last words; with all of
            them present a failed build fails the phase); if it runs, the
            three default shaders on a 200x200 K2/K5 frame and its depth;
            the fx fallback on the card against the CPU within
            fx.effects.levels_apart.
7f. loaders the port's decoders on the committed fixtures
            (tests/data_torch/, README.md there), each equal to the sha256
            of PIL's output stored beside them, with their host ms (median
            of 3): the baseline frame.jpg and the Lanczos downscale by 8 of
            the fixture RGBA PNG; progressive JPEGs (frame.jpg's pixels,
            4:2:0 with restarts; gray); an 800x800 picture baseline and
            progressive, side by side; a 4-bit palette PNG with tRNS, a
            16-bit RGBA, an Adam7 RGB and a 2-bit gray PNG (read_png, and
            read_rgb against PIL's convert("RGB")); a custom-format scene of
            frame.jpg and a PNG through load_dataset.  Then, at full width:
            train() (no CLI has a dataset-type flag) for 50 steps on a
            custom scene of the progressive JPEGs and the palette and Adam7
            PNGs (exactly one K2, K4, K3 a step, a rising PSNR), evaluate()
            of its checkpoint on the val view with the embedding fit (one K2
            and K5 for the view, K2, K5, K6, K3 a fit step), within EVAL_TOL
            of use_kernels off; `cli.main train` for 30 steps on a Blender
            scene of the 16-bit RGBA, Adam7 and palette PNGs (PIL's alphas
            in the dataset, one K2, K4, K3 a step).  7e and 7f run before
            any torch.profiler window.
7h. jax_checkpoint  the JAX package's own checkpoint directory, read on
            the card's host without JAX (tests/data_torch/jax_run/: Orbax,
            OCDBT + zarr v2 + zstd, the default widths after 3 steps):
            read_jax_checkpoint's every leaf against the JAX
            restore_checkpoint's sha256 and its read time (median of 3,
            warm cache, with the card's name and power limit); `cli.main
            render --checkpoint <dir>` of one 800x800 medium frame (exactly
            10 K2 and 10 K5); a 200x200 frame of it, the kernel route
            against the plain route within SLICE_TOL; `cli.main train
            --resume` in a copy of its save directory, 20 more steps
            (exactly 20 K2, K4 and K3; iteration 23, a finite loss, Adam's
            count continued).  After 7f, before any timing phase.
7i. full_scale  the reference-native study's scripts at the scale-down
            FULL_SCALE_FLAGS (200x200, 10 + 2 views, 2000 steps, 4 frames):
            one 200x200 view of the device ground truth against the numpy
            path within one level; `python -m
            danerf_tpu_torch.examples.full_scale`, then measure_io_overlap
            on its output; exactly one K2, K4, K3 a step and one K2 + K5 a
            chunk of the validation renders, eval and the spiral; every
            numeric key of examples/full_scale_report_v5e.json in the
            port's report, its val PSNR above FULL_SCALE_PSNR_FLOOR, Adam's
            rate at each checkpoint StepLR's; the spiral, Fog and Toon
            Shader mp4s decoded to their frame counts; the study again from
            FULL_SCALE_SEED2 (another init digest, a live density head, the
            same launches, val PSNR above the floor); the JAX run's initial
            parameters (examples/jax_init_seed0.npz) read without JAX into
            the default-width model, every leaf equal to the file's, its
            density probe on the card equal to the CPU's; the scale-down
            from them (`--init-npz` on 100 training views, the table's
            rows: the same launches, val PSNR above the floor); of the
            model it trained, a live probe on the card and the CPU, K2 and
            K5 at one 200x200 view's rays against their plain versions
            within TRAINED_TOL_FACTOR x PLAIN_TOL, and the view through
            exactly one K2 and one K5, its mean accumulation above 0 (its
            difference from the plain route recorded).  After 7h.
7j. parity  the parity study (danerf_tpu_torch/examples/parity_study.py)
            through parity_study.run at PARITY_SEEDS alive seeds x
            PARITY_ITERS steps of every arm on the 160x160 procedural
            scene: the launches of each run read from zero (none on the
            reference arms, whose trainer is plain PyTorch in f32, and on
            framework_paired_hier_xla32, use_kernels=False; one K7 a step
            on the coarse arms; one K2, K4, K3 a step on the 64 + 64 arms;
            the f32 variants on the f32 arms; one K2 (+ K5) a val view),
            every val PSNR above PARITY_PSNR_FLOOR, the reference init's
            dead set over seeds 0-11 on the card equal to the JAX study's
            (examples/parity_runs/dead_rates.json), and the reference
            trainer on the card against the CPU over PARITY_DRIFT_STEPS
            steps from one init and stream within PARITY_DRIFT_TOL (its
            CPU side in a process of its own, beside the arms), and the
            same run with TF32 on beyond it.  The framework_paired arms
            are the framework arms' runs (init_model draws the torch
            init).  After 7i.
7a. fx      the depth-aware effects (danerf_tpu_torch/fx/, plain PyTorch
            ops, no kernel of their own): each of the 14 with and without
            depth on a seeded 800x800 frame and depth, on the card against
            the port on the CPU with the same draws, within
            fx.effects.levels_apart's tolerance (1 level; 0.1% of the pixels
            where a threshold decides), under PyTorch's default TF32 flags
            (restored after); then each effect's CUDA-event ms at 800x800
            (median of 10 after a warm-up call).  7a-7d run before any
            torch.profiler window.
7b. serve_fx  `cli.main render --effect Fog --create_video`, then --effect
            Hologram: two 400x400 medium frames each from the smoke
            checkpoint; every file, the video (hotdog_render.mp4, MPEG-4
            Part 2) read back by check_video (frame count, rate, I-VOP
            every 12th frame, every plane equal to the encoder's
            reconstruction of the PNGs, each plane's mean PSNR against
            the PNGs' own 4:2:0 planes 35 dB or more), exactly one K2 and
            one K5 a chunk (launch counts zeroed
            just before each, read just after).
7c. spiral_fx  the reference's pipeline through the CLI: `spiral` (12 frames
            at 200x200, grayscale depth on frames 0 and 10, chair_spiral.mp4;
            one K2 and one K5 a frame), `effects` on its output (all 14: Fog
            on the 2 depth frames, the rest on 12, an <effect>.mp4 each),
            `preview` (Fog at 3 values of fog_start, manifest.json), `video`
            into sp.mp4 and sp.avi (XVID); every video through check_video.
7c'. video  the video encoder on the card's host: a 26-frame 800x800
            aligned spiral rendered by the smoke model, create_video_from_
            images of its PNGs (ms a frame with the PNG reads), the encoder
            alone (ms a frame, I-VOPs and P-VOPs apart), where its time goes
            (cProfile), the .mp4 through check_video; a line of its ms a
            frame with the card's name and power limit.
7d. serve_timing  an 800x800 medium frame: render_frame alone (median of
            3), the serial frame loop (render, fetch, two PNG encodes, one
            frame after another), render_path, which overlaps the fetch and
            the encodes with the next frame, without an effect, with Fog and
            with Toon Shader (ms a frame over 4 frames after a warm-up
            call; without an effect also over 12), the aligned spiral's ms
            a frame, and apply_effect_to_frames' timings (load, device,
            write) over it.
7g. eval_timing  evaluate() on 2 seeded random 800x800 views (the
            procedural poses) with the seeded model: ms a view without and
            with the fit (each call captures the fit once), the fit alone
            eager and as a graph replay (median of 3), render_frame beside
            render plus score; then one torch.profiler window of a replayed
            and of an eager fit (device-busy ms, idle share).
8. timing   CUDA-event times of every kernel and its plain version, each
            beside its bound: K2 (want_field) and K5 on a 65,536-ray chunk,
            K3, K4, K6, K7 and K9 on a chunk and at B = 1024 (plain versions
            at B = 1024; K9 beside K2 + K4 + K3), K1 at 65,536 and 131,072
            rows and on a chunk's 4,194,304 sample rows, K8 at 65,536 and
            131,072 rows; an 800x800 medium frame end to end (median of
            three after a warm-up frame; exactly 10 K2 and 10 K5 launches a
            frame and no other kernel); the training step of each path at
            B = 1024 (median of 50 synchronised steps) with its rays/s and
            its kernels' share, and the device time by kernel over 10 steps
            (torch.profiler) of the 64 + 64, the coarse-only, the
            white-background, the per-sample and the K9 step; beside each,
            the chained step (10 steps a replay: median, min and max of 20
            synchronised replays over 10, rays/s, a replay's CUDA-event
            time, the graph's pool, and a torch.profiler window of 3
            replays with its idle share); then the same
            for use_time: the has_time K2/K5 on the chunk, K3-K7 and K9 at
            B = 1024 and K1/K8 at 131,072 rows with their plain versions, an
            800x800 medium frame at t = 0.5, and the use_time step,
            profiled; then (f32_step_timing) the f32 64 + 64, coarse-only,
            white-background, per-sample and one-kernel steps beside the
            bf16 64 + 64 one, eager and chained,
            each with its profiler windows (device busy, idle share).  K3, K4, K6 and K7 at the batch are
            also broken down
            by kernel (tile, dW pass) beside torch.matmul over the same dW
            products (dw_cublas_ms, a yardstick only), and each profiled
            step by part (their tile, their dW pass, the rest).
9. data parallelism (danerf_tpu_torch/parallel/mesh.py), after every
   profiler window of 8: hier_dp, `cli.main train --coordinator_address
   auto --mesh_data 0` as torchrun starts one rank (an NCCL group of one,
   a 1 x 1 mesh; 100 steps of 64 + 64 with --checkpoint_every 100: exactly
   one K2, K4 and K3 a step plus the validation render's K2 and K5, rising
   PSNR); dist_step, on a world-size-1 NCCL group of this process: for
   64 + 64, coarse-only and per sample, 10 chained sharded steps (one
   replay, the flat all-reduce captured with them) against 10 chained
   make_train_step steps bit for bit with the path's launches, one f32
   64 + 64 sharded step against one f32 make_train_step step, then the two
   64 + 64 steps timed in turns (20 replays each) with a profiler window of
   3 replays each; dist_frame: render_frame(mesh=) of an 800x800 medium
   frame against render_frame bit for bit (10 K2, 10 K5), and
   make_sharded_render on a 65,536-ray chunk against render_rays'
   per-sample route bit for bit (2 K1), with their ms; dist_two_ranks: two
   processes of this script on the one card on gloo (3 eager sharded
   64 + 64 steps at a global B = 1024, a 200x200 sharded frame, the
   --mesh_model 2 module-route forward), each against the same work in one
   process within TWO_RANK_TOL; a failure in either child fails the run.
   With --cards N (N > 1) the script runs env, build and only this last
   phase, as dist_cards: N ranks on NCCL, one card each, the same checks,
   plus the chained step at B = 1024 and N x 1024 and the 800x800 frame
   timed against one card, and the tensor-parallel kernel-route step
   (N/2 x 2 mesh) chained against eager, bit for bit; then (N > 2)
   render_subset: `cli.main render --mesh_data 2` on N NCCL ranks (the
   mesh over the first 2, the others idle) against one process, the rgb
   PNGs within 1 level, the raw depth within TWO_RANK_TOL (the viridis
   depth PNGs within one colormap step), only rank 0 writing.
10. frame_profile  the last profiler window: 4e's 800x800 medium frame,
   f32 and bf16, render_frame under torch.profiler (device busy ms, the
   window's ms, idle share, device ms by kernel).
Before the last line it prints the card's name and power limit and the
{"kernels": [...]} record (each kernel with its has_time variant's numbers
under "has_time"; K2, K5, K3 and K6 with the launches of 7e's kernel-route
runs under "eval_launches"; K2-K6 with those of 7f's fixture scenes under
"loaders_launches"; K2-K5 with those of 7h's frame and resumed training
under "jax_checkpoint_launches"; K2-K5 with those of 7i's study under
"full_scale_launches"; K2-K5, K7 and their f32 variants with those of 7j's
study under "parity_launches"; K2, K4 and K3 with those of hier_dp under
"dp_train_launches", K2 and K5 with a sharded frame's, K1 with a sharded
chunk's; the f32 variants of K2, K5 and K1 after the nine, with the
launches of 4e's f32 frames and per-sample routes, the has_time variants'
from the time model's; then those of K3, K4, K6 and K7, with the launches
of 4g's f32 train() run (K3, K4), evaluate fit (K6) and coarse-only chained
run (K7), the has_time variants' from its f32 use_time step; then those of K8
and K9, with the launches of 4g's f32 per-sample and one-kernel chained runs,
their has_time variants held and timed but driven by no run); the last line
is the ok record.  Exits non-zero,
printing no result, when CUDA is unavailable.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time


_START = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase's line also gets the seconds since the
    script started (wall_s), so each phase's share of the run shows."""
    if "phase" in obj:
        obj = {**obj, "wall_s": time.perf_counter() - _START}
    print(json.dumps(obj), flush=True)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------- bounds

PEAK_BF16 = 989e12     # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)
PEAK_FP32 = 67e12      # H100 SXM FP32 FLOP/s outside the tensor cores (the f32 kernels' FFMA)
PEAK_TF32 = 495e12     # H100 SXM dense TF32 FLOP/s (the f32 K2 and K5: 3xTF32 wgmma)
PEAK_BYTES = 3.35e12   # H100 SXM HBM3 bytes/s

# the kernel route of a whole render_rays against the plain route, max abs
# error of each output (phase_kernels, the f32 per-sample route, jax_checkpoint)
SLICE_TOL = {"rgb": 5e-3, "acc": 5e-3, "depth": 2e-2}


def field_macs(cfg):
    """(MACs per sample, MACs per ray) of the field: the per-ray part is the
    appearance projection, which depends only on the ray's embedding.  With
    use_time the encoded time enters the first and the skip layers."""
    h, half = cfg.hidden_dim, cfg.hidden_dim // 2
    per_sample = 0
    pos_in = cfg.pos_enc_dim + (cfg.time_enc_dim if cfg.use_time else 0)
    k = pos_in
    for i in range(cfg.num_layers):
        if i in cfg.skip_connect_layers and i > 0:
            k = h + pos_in
        per_sample += k * h
        k = h
    per_sample += h + (h + cfg.dir_enc_dim) * half + half * 3
    return per_sample, cfg.appearance_dim * half


def bwd_macs(cfg):
    """MACs per sample of the transposed chain after the forward: every
    weight once for dW (the appearance projection per sample, as the JAX
    kernel's dotT_a over the sample rows), plus the hidden part of each
    d_in except the first layer's (trunk layers 1.., dir, rgb, density)."""
    h, half = cfg.hidden_dim, cfg.hidden_dim // 2
    per_sample, per_ray = field_macs(cfg)
    d_w = per_sample + per_ray
    d_in = (cfg.num_layers - 1) * h * h + half * h + 3 * half + h
    return d_w + d_in


def bound_ms(flop, bytes_moved, peak=PEAK_BF16):
    t_ops, t_bytes = flop / peak, bytes_moved / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def bound(cfg, rays, samples, bytes_moved, backward=False):
    """The least time for a kernel over rays x samples: the forward field,
    plus the transposed chain when ``backward`` (K3 recomputes the forward,
    K4 runs it once; both then run the chain: ~3 forward units), and demb's
    per-ray E x half MACs; at the bf16 tensor-core rate, or with
    ``cfg.use_bf16`` off at FP32's (the f32 kernels multiply on the CUDA
    cores; tf32x3_bound is the f32 K2 and K5's)."""
    per_sample, per_ray = field_macs(cfg)
    macs = per_sample * rays * samples + per_ray * rays
    if backward:
        macs += bwd_macs(cfg) * rays * samples + per_ray * rays
    return bound_ms(2.0 * macs, bytes_moved, PEAK_BF16 if cfg.use_bf16 else PEAK_FP32)


def tf32x3_bound(cfg, rays, samples, bytes_moved):
    """The least time of the f32 K2 or K5 over rays x samples: the trunk and
    dir-layer MACs three TF32 tensor-core products each (3xTF32) at TF32's
    dense rate, the heads' and the appearance term's on the CUDA cores at
    FP32's, or the bytes at HBM's, whichever is longest."""
    h, half = cfg.hidden_dim, cfg.hidden_dim // 2
    per_sample, per_ray = field_macs(cfg)
    heads = h + 3 * half
    t_tc = 3 * 2.0 * (per_sample - heads) * rays * samples / PEAK_TF32
    t_cc = 2.0 * (heads * rays * samples + per_ray * rays) / PEAK_FP32
    t_bytes = bytes_moved / PEAK_BYTES
    return (max(t_tc, t_cc, t_bytes) * 1e3,
            "bytes" if t_bytes >= max(t_tc, t_cc) else "operations")


def tf32x3_bwd_bound(cfg, rays, samples, bytes_moved, gate_pass=False):
    """The least time of the f32 K3 or K4 (or, as a yardstick, any f32
    backward kernel) over rays x samples: ``bound(backward=True)``'s MACs
    (the forward field, then the transposed chain: field_macs + bwd_macs,
    demb per ray) with the trunk and dir-layer products, their transposes
    and their dW three TF32 tensor-core products each (3xTF32) at TF32's
    dense rate, the heads' and the appearance term's (forward, dW and d_in)
    on the CUDA cores at FP32's, or the bytes at HBM's, whichever is
    longest.  gate_pass (K3, K4): the CUDA cores also run the forward field
    once in f32 FFMA for the relu gates (csrc/field_bwd_f32_sm90.cuh)."""
    h, half = cfg.hidden_dim, cfg.hidden_dim // 2
    per_sample, per_ray = field_macs(cfg)
    heads = h + 3 * half
    rows = rays * samples
    tc = 2 * (per_sample - heads) + (cfg.num_layers - 1) * h * h + half * h
    cc = (bwd_macs(cfg) + per_sample) - tc + (per_sample if gate_pass else 0)
    t_tc = 3 * 2.0 * tc * rows / PEAK_TF32
    t_cc = 2.0 * (cc * rows + (3 if gate_pass else 2) * per_ray * rays) / PEAK_FP32
    t_bytes = bytes_moved / PEAK_BYTES
    return (max(t_tc, t_cc, t_bytes) * 1e3,
            "bytes" if t_bytes >= max(t_tc, t_cc) else "operations")


def weight_stream_gb(packed, tiles):
    """The GB the f32 K2/K5 stream from L2 into their weight ring: every
    trunk and dir-layer weight's TF32 hi and lo (8 bytes) once a tile.  No
    L2 rate is measured, so no bound is drawn from it; kernel_ab.py
    --ablate weight_stream times the tile without it."""
    n_w = sum(n * k for name, (_, (n, k)) in packed.mat_at.items()
              if name not in ("wapp", "wrgb"))
    return tiles * 8 * n_w / 1e9


def cuda_ms(fn, iters, warmup=1):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- inputs

def make_model(cfg, seed, device):
    import torch

    from danerf_tpu_torch.models.nerf import NeRF

    model = NeRF(cfg, torch.Generator().manual_seed(seed))
    return model.to(device).eval().requires_grad_(False)


def make_rays(n, cfg, seed, device, samples=None, perturb=True):
    """Rays from a radius-4 sphere aimed near the origin, their stratified
    depths (``samples`` per ray, jittered when ``perturb``) and per-ray
    embeddings."""
    import torch

    from danerf_tpu_torch.ops.sampling import sample_stratified

    g = torch.Generator(device=device).manual_seed(seed)
    o = torch.randn(n, 3, generator=g, device=device)
    o = 4.0 * o / o.norm(dim=-1, keepdim=True)
    d = -o / 4.0 + 0.3 * torch.randn(n, 3, generator=g, device=device)
    d = d / d.norm(dim=-1, keepdim=True)
    emb = torch.randn(n, cfg.appearance_dim, generator=g, device=device)
    z, _ = sample_stratified(o, d, cfg.near, cfg.far, samples or cfg.num_samples, perturb, g)
    return o, d, emb, z


def sample_rows(rays, cfg, seed, device, samples):
    """The per-sample route's rows for ``rays`` seeded rays of ``samples``
    stratified depths: flat points o + z d, and each row's direction and
    embedding (its ray's)."""
    o, d, emb, z = make_rays(rays, cfg, seed, device, samples=samples)

    def per_row(t):
        return t[:, None, :].expand(-1, samples, -1).reshape(-1, t.shape[-1]).contiguous()

    return (o[:, None, :] + z[..., None] * d[:, None, :]).reshape(-1, 3), per_row(d), per_row(emb)


# ---------------------------------------------------------------- phases

def phase_env():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi})
    return smi


def ptxas_resources(log):
    """Registers, static shared memory and spills from a source's ``nvcc
    -Xptxas -v`` output (the most registers and static shared memory of its
    functions, the spills summed over them)."""
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    spills = [(int(a), int(b)) for a, b in
              re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
    smem = [int(m) for m in re.findall(r"(\d+) bytes smem", log)]
    return {"registers": max(regs, default=None), "static_smem": max(smem, default=0),
            "spill_stores": sum(a for a, _ in spills), "spill_loads": sum(b for _, b in spills)}


def function_resources(log, name):
    """ptxas_resources of the functions of ``log`` whose mangled name holds
    ``name``."""
    blocks = re.split(r"(?=ptxas info\s*: Compiling entry function)", log)
    return ptxas_resources("".join(b for b in blocks if name in b.split("\n", 1)[0]))


def shared_fragment_sets(sass):
    """The pipelined loops in ``cuobjdump -sass`` output whose two A
    fragment sets are one register set: consecutive HGMMA commit groups
    (each ended by the HGMMA marked gsb0) of a function that read the same
    A registers, the second followed by ``WARPGROUP.DEPBAR.LE gsb0, 0x1``
    (the first still in flight), so the next slice's fragment loads
    overwrite registers the tensor cores are still reading
    (csrc/field_f32_sm90.cuh mma_slices).  Returns [(function, address)]."""
    found, func, groups, cur = [], None, [], set()
    pending = None  # (function, address, the group's A registers) until its wait
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func, groups, cur, pending = m.group(1), [], set(), None
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if not m or func is None:
            continue
        addr, ins = m.groups()
        if "HGMMA" in ins:
            regs = re.findall(r"\bR(\d+)\b", ins)
            if len(regs) >= 3:   # an A operand in registers (acc, A, ..., acc)
                cur.add(int(regs[1]))
            if "gsb0" in ins:
                groups.append(frozenset(cur))
                pending = (func, addr, groups[-2] == groups[-1]) if len(groups) > 1 else None
                cur = set()
        elif "WARPGROUP.DEPBAR" in ins and pending is not None:
            if pending[2] and re.search(r"gsb0,\s*0x1\b", ins):
                found.append(pending[:2])
            pending = None
    return found


# The f32 backward libraries, all on csrc/field_bwd_f32_sm90.cuh's 3xTF32 tile.
TF32_BWD_LIBS = ("march_bwd_f32", "merged_train_f32", "merged_bwd_f32", "march_train_f32",
                 "mlp_bwd_f32", "hier_onepass_f32")


def phase_build(out_dir):
    """Build every kernel; one line with each one's registers, shared
    memory and spills (K1, K2 and K5, ``csrc/field_sm90.cuh``, take dynamic
    shared memory, which ptxas does not report: it is read from the
    library)."""
    from danerf_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build(force=True)
    secs = time.perf_counter() - t0
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        for name, log in logs.items():
            f.write(f"==== {name}.cu\n{log}\n")
    res = {n: ptxas_resources(log) for n, log in logs.items()}
    for n in ("march", "merged", "mlp_fwd", "march_f32", "merged_f32", "mlp_fwd_f32"):
        res[n]["dynamic_smem"] = int(_build.load(n).danerf_tile_smem_bytes())
    # the f32 K1, K2, K5 (csrc/field_f32_sm90.cuh), K3, K4, K6-K9 (csrc/
    # field_bwd_f32_sm90.cuh): their TF32 wgmma in SASS
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for n in ("march_f32", "merged_f32", "mlp_fwd_f32") + TF32_BWD_LIBS:
        if os.path.exists(cuobjdump):
            sass = subprocess.run([cuobjdump, "-sass", str(_build._lib_path(n))],
                                  capture_output=True, text=True, timeout=120).stdout
            ops = re.findall(r"HGMMA\.(\w+)\.F32\.TF32", sass)
            res[n]["hgmma_tf32"] = {"count": len(ops), "shapes": sorted(set(ops))}
            shared = shared_fragment_sets(sass)
            res[n]["pipelined_loops_sharing_a_fragment_set"] = len(shared)
            if shared:
                raise AssertionError(f"{n}: a pipelined wgmma loop reads one fragment set in "
                                     f"flight and rewrites it: {shared}")
        else:
            res[n]["hgmma_tf32"] = "no cuobjdump on this host"
    # K3, K4, K6, K7, K8 and K9 (csrc/field_bwd_sm90.cuh): the tile kernel and
    # the dW pass apart, each with its dynamic shared memory
    for n in ("march_bwd", "merged_train", "merged_bwd", "march_train", "mlp_bwd",
              "hier_onepass"):
        lib = _build.load(n)
        tile = "hier_tile90" if n == "hier_onepass" else "bwd_tile90"
        for fn, key, smem in ((tile, "tile", lib.danerf_bwd_tile_smem_bytes),
                              ("dw90_kernel", "dw_pass", lib.danerf_dw90_smem_bytes)):
            res[n][key] = {**function_resources(logs[n], fn), "dynamic_smem": int(smem())}
    # the f32 K3, K4, K6-K9 (csrc/field_bwd_f32_sm90.cuh): the tile
    # kernel (K9: its fine row set's and both chains', and its coarse row
    # set's), the wgmma dW pass and the gate pass (dynamic shared memory) and
    # the narrow jobs' FFMA pass (static) apart
    for n in TF32_BWD_LIBS:
        lib = _build.load(n)
        tiles = ((("hier_fine32", "tile"), ("hier_coarse32", "coarse_tile"))
                 if n == "hier_onepass_f32" else (("bwd_tile32", "tile"),))
        for fn, key, smem in tuple((fn, key, lib.danerf_bwd_tf32_tile_smem_bytes)
                                   for fn, key in tiles) + (
                ("dw_t32_kernel", "dw_pass", lib.danerf_bwd_tf32_dw_smem_bytes),):
            res[n][key] = {**function_resources(logs[n], fn), "dynamic_smem": int(smem())}
        res[n]["narrow_dw_pass"] = function_resources(logs[n], "dw32_kernel")
        res[n]["gate_pass"] = {**function_resources(logs[n], "gate_pass32"),
                               "dynamic_smem": int(lib.danerf_bwd_tf32_gate_smem_bytes())}
    emit({"phase": "build", "seconds": secs, "built": sorted(logs), "resources": res})


def output_errs(got, want, keys):
    """{output: max abs error} of ``keys`` ("field": its rgb, and its
    sigma, which is unbounded, relative to max(1, |sigma|))."""
    out = {}
    for k in keys:
        if k == "field":
            out["field_rgb"] = max_err(got[k][:, :3], want[k][:, :3])
            out["field_sigma"] = float(((got[k][:, 3] - want[k][:, 3])
                                        / want[k][:, 3].abs().clamp_min(1.0)).abs().max())
        else:
            out[k] = max_err(got[k], want[k])
    return out


def compare(errs, failures, tag, got, want, keys, tol=None):
    """Record the max abs error of each output against ``tol`` (PLAIN_TOL)."""
    from danerf_tpu_torch.kernels.fused_render import PLAIN_TOL

    tol = PLAIN_TOL if tol is None else tol
    for name, e in output_errs(got, want, keys).items():
        errs[f"{tag}.{name}"] = e
        if not math.isfinite(e) or e > tol[name]:
            failures.append(f"{tag}.{name}: {e} > {tol[name]}")


def tile_shapes(cfg, model, device, errs, failures, tag, with_time):
    """K2 and K5 at the shapes field_sm90.cuh's tile takes, against their
    plain versions at 4093 rays (a ragged last tile): K2 at S = 32, 48, 64,
    100, 128 (1 to 4 rays a 128-row tile, rays that straddle its two
    warpgroups or fill both), with and without its field; K5 at Sc + Sf =
    64 + 64, 64 + 16, 128 + 128 (2, 8 and 1 rays a tile), with the
    appearance projection and packed as zeros.  ``tag`` is "" or "t" (the
    time model, each ray's time uniform in [0, 1]).  Two calls must agree
    bit for bit."""
    import torch

    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.kernels.fused_mlp import pack_params
    from danerf_tpu_torch.ops.sampling import sample_pdf

    n, same = 4093, True
    packs = (("", pack_params(model, cfg)), ("_noapp", pack_params(model, cfg, appearance=False)))
    for s in (32, 48, 64, 100, 128):
        o, d, emb, z = make_rays(n, cfg, seed=10 + s, device=device, samples=s)
        t = (torch.rand(n, 1, generator=torch.Generator(device=device).manual_seed(s),
                        device=device) if with_time else None)
        for wf in (True, False):
            args = (packs[0][1], cfg, o, d, emb, z, t)
            want = fr.march_plain(*args, want_field=wf)
            got, again = fr.march_cuda(*args, want_field=wf), fr.march_cuda(*args, want_field=wf)
            torch.cuda.synchronize()
            compare(errs, failures, f"K2{tag}@{n}x{s}{'_field' if wf else ''}", got, want,
                    ["rgb", "depth", "acc", "weights"] + (["field"] if wf else []))
            same &= all(bool(torch.equal(got[k], again[k])) for k in got)
    for sc, sf in ((64, 64), (64, 16), (128, 128)):
        o, d, emb, z = make_rays(n, cfg, seed=20 + sf, device=device, samples=sc)
        g = torch.Generator(device=device).manual_seed(sc + sf)
        t = torch.rand(n, 1, generator=g, device=device) if with_time else None
        for app, pk in packs:
            e = emb if app == "" else torch.zeros_like(emb)
            coarse = fr.march_plain(pk, cfg, o, d, e, z, t, want_field=True)
            z_f = sample_pdf(z, coarse["weights"], sf, True, rand=g)
            args = (pk, cfg, o, d, e, z, coarse["field"], z_f, t)
            want = fr.merged_plain(*args)
            got, again = fr.merged_cuda(*args), fr.merged_cuda(*args)
            torch.cuda.synchronize()
            compare(errs, failures, f"K5{tag}@{n}x{sc}+{sf}{app}", got, want,
                    ["rgb", "depth", "acc", "weights", "z_vals"])
            same &= all(bool(torch.equal(got[k], again[k])) for k in got)
    if not same:
        failures.append(f"K2{tag}/K5{tag} gave different results on the same inputs")


def refusals(cfg, packed, device):
    """The shapes the backward tile's kernels refuse: K3 and K7 at S = 129;
    K4 and K6 at Sc + Sf = 64 + 129, 200 + 64 and where the merge arrays
    pass their limit (126 + 16), as on the old tile, while 125 + 16 is
    taken; and S or Sf = 0, which the old tile divided by; K8 and K1 with
    an embedding of 24 (their appearance products step K by 16; the f32
    K8 and K1, row_app4, take it) and of 6 (row_app4 steps K by 4); K9 at
    Sc + Sf = 129 + 64, 64 + 129, 0 + 64 and 64 + 0, as on its first tile.
    In f32 (cfg.use_bf16 off) the same, on the f32 kernels.  Returns what
    went otherwise."""
    import torch

    from danerf_tpu_torch.kernels import fused_mlp as fm
    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.kernels.fused_mlp import pack_params
    from danerf_tpu_torch.ops.sampling import importance_uniforms

    n, out = 37, []
    o, d, emb, z = make_rays(n, cfg, seed=95, device=device, samples=129)
    g = torch.Generator(device=device).manual_seed(95)
    target = torch.rand(n, 3, generator=g, device=device)
    field = fr.march_plain(packed, cfg, o, d, emb, z[:, :64], want_field=True)["field"]
    calls = {}
    for s in (0, 129):
        zs = z[:, :s].contiguous()
        calls[f"K3@{s}"] = lambda zs=zs: fr.march_bwd_cuda(packed, cfg, o, d, emb, zs, None,
                                                           None, None, None)
        calls[f"K7@{s}"] = lambda zs=zs: fr.march_train_cuda(packed, cfg, o, d, emb, zs, target)
    for sc, sf in ((64, 129), (200, 64), (64, 0), (126, 16), (125, 16)):
        zc = torch.sort(torch.rand(n, sc, generator=g, device=device) * 4 + 2, dim=-1)[0]
        fc = field[:, :, :1].expand(-1, -1, sc).contiguous()
        zf = torch.sort(torch.rand(n, sf, generator=g, device=device) * 4 + 2, dim=-1)[0]
        args = (packed, cfg, o, d, emb, zc, fc, zf)
        calls[f"K4@{sc}+{sf}"] = lambda a=args: fr.merged_train_cuda(*a, target)
        calls[f"K6@{sc}+{sf}"] = lambda a=args: fr.merged_bwd_cuda(*a, target, None, None, None)
    x, dr, _ = sample_rows(1, cfg, 96, device, n)
    for e in (24, 6):
        ce = cfg.replace(appearance_dim=e)
        pe, emb_e = pack_params(make_model(ce, 0, device), ce), torch.randn(
            n, e, generator=g, device=device)
        calls[f"K8@E{e}"] = lambda ce=ce, pe=pe, emb_e=emb_e: fm.fused_bwd_cuda(
            pe, ce, x, dr, emb_e, target, target[:, :1])
        calls[f"K1@E{e}"] = lambda ce=ce, pe=pe, emb_e=emb_e: fm.fused_fwd_cuda(
            pe, ce, x, dr, emb_e)
    for sc, sf in ((129, 64), (64, 129), (0, 64), (64, 0)):
        u = importance_uniforms((n,), sf, True, rand=g, device=device)
        calls[f"K9@{sc}+{sf}"] = lambda zc=z[:, :sc].contiguous(), u=u: fr.hier_onepass_cuda(
            packed, cfg, o, d, emb, zc, u, target)
    for name, call in calls.items():
        taken = name.endswith("125+16") or (name.endswith("@E24") and not cfg.use_bf16)
        try:
            call()
            torch.cuda.synchronize()
            if not taken:
                out.append(f"{name} was taken; it must be refused")
        except RuntimeError as exc:
            if taken or "a width this kernel does not take" not in str(exc):
                out.append(f"{name}: {exc}")
    return out


def phase_bwd_shapes(cfg, model, device, tag):
    """K3, K7, K4 and K6 at every shape csrc/field_bwd_sm90.cuh's tile takes,
    against their plain versions at 37 rays (a lost or doubled CTA shows),
    at the 1024-ray batch and at 4093 rays (a ragged last tile): K3 at S =
    32, 48, 64, 100, 128 with every cotangent and g_field, without g_field,
    and with only g_rgb (the null ones read as zeros), and at S = 64 with
    every cotangent null (all outputs exactly zero); K7 at the same S with
    seeded targets; K4 at Sc + Sf = 64 + 64, 64 + 16, 64 + 48, 128 + 128;
    K6 at the same Sc + Sf with a coarse/fine tie, under every cotangent,
    the white-background pattern (g_rgb and g_acc), only g_rgb and none
    (all outputs exactly zero); all four at 64 (+ 64) samples with the
    appearance projection packed as zeros.  ``tag`` is "" or "t" (the time
    model, each ray's time uniform in [0, 1]).  Two calls must agree bit
    for bit.  Without time, the shapes they refuse (``refusals``).  Returns
    the worst per-ray abs error of each kernel."""
    import torch

    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.kernels.fused_mlp import pack_params
    from danerf_tpu_torch.ops.sampling import sample_pdf

    tol = fr.PLAIN_TOL
    packs = {"": pack_params(model, cfg), "_noapp": pack_params(model, cfg, appearance=False)}
    errs, grad_rel, failures, same = {}, {}, [], True
    check, check_grads = checks(errs, grad_rel, failures, model)

    def equal(a, b):
        return all(bool(torch.equal(x, y)) for x, y in zip(a, b))

    def zero(name, *outs):
        check(f"{name}.zero", max(float(x.abs().max()) for x in outs), 0.0)

    for n in (37, cfg.batch_size, 4093):
        for s in (32, 48, 64, 100, 128):
            o, d, emb, z = make_rays(n, cfg, seed=70 + s, device=device, samples=s)
            g = torch.Generator(device=device).manual_seed(n + s)
            t = torch.rand(n, 1, generator=g, device=device) if cfg.use_time else None
            g_rgb, g_depth, g_acc, g_w, g_field = _cotangents(n, s, g, device)
            cases = {"_field": (g_rgb, g_depth, g_acc, g_w, g_field),
                     "": (g_rgb, g_depth, g_acc, g_w, None),
                     "_rgb_only": (g_rgb, None, None, None, None)}
            if s == 64:
                cases["_null"] = (None,) * 5
                cases["_field_noapp"] = cases["_field"]
            for case, cot in cases.items():
                pk = packs["_noapp" if case.endswith("noapp") else ""]
                e = torch.zeros_like(emb) if case.endswith("noapp") else emb
                name = f"K3{tag}@{n}x{s}{case}"
                gk, dk = fr.march_bwd_cuda(pk, cfg, o, d, e, z, *cot, t=t)
                gk2, dk2 = fr.march_bwd_cuda(pk, cfg, o, d, e, z, *cot, t=t)
                same &= equal((gk.mats, gk.vecs, dk), (gk2.mats, gk2.vecs, dk2))
                if case == "_null":
                    torch.cuda.synchronize()
                    zero(name, gk.mats, gk.vecs, dk)
                    continue
                gp, dp = fr.march_bwd_plain(pk, cfg, o, d, e, z, *cot, t=t)
                torch.cuda.synchronize()
                check_grads(name, gk, gp)
                check(f"{name}.demb", max_err(dk, dp), tol["demb"])
            target = torch.rand(n, 3, generator=g, device=device)
            for app in (("", "_noapp") if s == 64 else ("",)):
                pk = packs[app]
                e = torch.zeros_like(emb) if app else emb
                args = (pk, cfg, o, d, e, z, target, t)
                name = f"K7{tag}@{n}x{s}{app}"
                got, again = fr.march_train_cuda(*args), fr.march_train_cuda(*args)
                lp, gp, dp = fr.march_train_plain(*args)
                torch.cuda.synchronize()
                lk, gk, dk = got
                same &= equal((lk, gk.mats, gk.vecs, dk),
                              (again[0], again[1].mats, again[1].vecs, again[2]))
                check_grads(name, gk, gp)
                check(f"{name}.loss", abs(float(lk) - float(lp)), tol["loss"])
                check(f"{name}.demb", max_err(dk, dp), tol["demb_k4"])
        for sc, sf in ((64, 64), (64, 16), (64, 48), (128, 128)):
            o, d, emb, z = make_rays(n, cfg, seed=80 + sf, device=device, samples=sc)
            g = torch.Generator(device=device).manual_seed(n + sc + sf)
            t = torch.rand(n, 1, generator=g, device=device) if cfg.use_time else None
            target = torch.rand(n, 3, generator=g, device=device)
            for app in (("", "_noapp") if (sc, sf) == (64, 64) else ("",)):
                pk = packs[app]
                e = torch.zeros_like(emb) if app else emb
                coarse = fr.march_plain(pk, cfg, o, d, e, z, t, want_field=True)
                z_f = sample_pdf(z, coarse["weights"], sf, True, rand=g)
                args = (pk, cfg, o, d, e, z, coarse["field"], z_f, target, t)
                name = f"K4{tag}@{n}x{sc}+{sf}{app}"
                got, again = fr.merged_train_cuda(*args), fr.merged_train_cuda(*args)
                lp, gp, dp, fp = fr.merged_train_plain(*args)
                torch.cuda.synchronize()
                lk, gk, dk, fk = got
                same &= equal((lk, gk.mats, gk.vecs, dk, fk),
                              (again[0], again[1].mats, again[1].vecs, again[2], again[3]))
                check_grads(name, gk, gp)
                check(f"{name}.loss", abs(float(lk) - float(lp)), tol["loss"])
                check(f"{name}.demb", max_err(dk, dp), tol["demb_k4"])
                check(f"{name}.g_field", max_err(fk, fp), tol["g_field"])
                # K6 on the same coarse field, with a coarse/fine tie
                z_t = _tie(z, z_f)
                c6 = _cotangents(n, sc + sf, g, device)[:4]
                cases = {"": c6, "_white": (c6[0], None, c6[2], None),
                         "_rgb_only": (c6[0], None, None, None), "_null": (None,) * 4}
                for case, cot in (cases.items() if not app else [("", c6)]):
                    name = f"K6{tag}@{n}x{sc}+{sf}{app}{case}"
                    args = (pk, cfg, o, d, e, z, coarse["field"], z_t, *cot)
                    gk, dk, fk = fr.merged_bwd_cuda(*args, t=t)
                    gk2, dk2, fk2 = fr.merged_bwd_cuda(*args, t=t)
                    same &= equal((gk.mats, gk.vecs, dk, fk), (gk2.mats, gk2.vecs, dk2, fk2))
                    if case == "_null":
                        torch.cuda.synchronize()
                        zero(name, gk.mats, gk.vecs, dk, fk)
                        continue
                    gp, dp, fp = fr.merged_bwd_plain(*args, t=t)
                    torch.cuda.synchronize()
                    check_grads(name, gk, gp)
                    check(f"{name}.demb", max_err(dk, dp), tol["demb"])
                    check(f"{name}.g_field", max_err(fk, fp), tol["g_field_k6"])
    if not same:
        failures.append(f"K3{tag}/K7{tag}/K4{tag}/K6{tag} gave different results on the same "
                        "inputs")
    if not cfg.use_time:
        failures += refusals(cfg, packs[""], device)
    emit({"phase": "bwd_shapes", "use_time": cfg.use_time, "rays": [37, cfg.batch_size, 4093],
          "max_abs_err": errs, "grad_rel": grad_rel, "deterministic": same,
          "failures": failures})
    if failures:
        raise AssertionError("K3/K7/K4/K6 disagree with their plain versions: "
                             + "; ".join(failures))
    return {kern: max(v for k, v in errs.items() if k.startswith(kern))
            for kern in ("K3", "K4", "K6", "K7")}


def phase_kernels(cfg, model, device):
    """Each kernel against its plain version at the shapes the main path
    gives it: 4093 rays (a ragged tile) and one full 65,536-ray chunk; K2 with
    want_field at 64 samples (medium) and without at 32 (preview); K5 at
    64 + 64 with z_f from sample_pdf of K2's weights; K1 at the rows of the
    per-sample route.  Returns the max abs errors per kernel and the chunk's
    inputs for the timing phase."""
    import torch

    from danerf_tpu_torch.kernels import fused_mlp as fm
    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.kernels.fused_mlp import pack_params
    from danerf_tpu_torch.ops.sampling import sample_pdf
    from danerf_tpu_torch.render.renderer import render_rays

    packed = pack_params(model, cfg)
    errs, failures = {}, []
    preview_s = max(int(cfg.num_samples * 0.5), 1)
    chunk = None
    for n, seed in ((4093, 1), (cfg.render_chunk, 4)):
        o, d, emb, z = make_rays(n, cfg, seed=seed, device=device)
        want_f = fr.march_plain(packed, cfg, o, d, emb, z, want_field=True)
        got_f = fr.march_cuda(packed, cfg, o, d, emb, z, want_field=True)
        torch.cuda.synchronize()
        compare(errs, failures, f"K2_field@{n}", got_f, want_f,
                ["rgb", "depth", "acc", "weights", "field"])
        _, _, _, z32 = make_rays(n, cfg, seed=seed, device=device, samples=preview_s,
                                 perturb=False)
        want = fr.march_plain(packed, cfg, o, d, emb, z32)
        got = fr.march_cuda(packed, cfg, o, d, emb, z32)
        torch.cuda.synchronize()
        compare(errs, failures, f"K2@{n}x{preview_s}", got, want,
                ["rgb", "depth", "acc", "weights"])
        if n == 4093:
            want = fr.march_plain(packed, cfg, o, d, emb, z)
            got = fr.march_cuda(packed, cfg, o, d, emb, z)
            torch.cuda.synchronize()
            compare(errs, failures, f"K2@{n}", got, want, ["rgb", "depth", "acc", "weights"])

        g = torch.Generator(device=device).manual_seed(seed + 1)
        z_f = sample_pdf(z, want_f["weights"], cfg.num_importance, True, rand=g)
        want_m = fr.merged_plain(packed, cfg, o, d, emb, z, want_f["field"], z_f)
        got_m = fr.merged_cuda(packed, cfg, o, d, emb, z, want_f["field"], z_f)
        torch.cuda.synchronize()
        compare(errs, failures, f"K5@{n}", got_m, want_m,
                ["rgb", "depth", "acc", "weights", "z_vals"])
        mean_acc = float(want_f["acc"].mean())
        del want_f, got_f, want, got, want_m, got_m
        chunk = (o, d, emb, z, z_f, None)
    tile_shapes(cfg, model, device, errs, failures, "", with_time=False)

    # K1 on flat points: the samples of 4093 rays x 32 (130,976 rows, a
    # ragged tile), and the coarse (65,536) and fine (131,072) evaluations
    # of a 1024-ray batch; with and without the appearance projection; two
    # calls bit for bit; and at 130,976 rows on a model with the softplus
    # density activation
    no_app = pack_params(model, cfg, appearance=False)
    cfg_sp = cfg.replace(density_activation="softplus")
    packed_sp = pack_params(make_model(cfg_sp, seed=7, device=device), cfg_sp)
    for rays, s_per, seed in ((4093, 32, 1), (1024, 64, 2), (1024, 128, 3)):
        x, dr, er = sample_rows(rays, cfg, seed, device, s_per)
        n = x.shape[0]
        runs = [("", cfg, packed, er), ("_noapp", cfg, no_app, torch.zeros_like(er))]
        if rays == 4093:
            runs.append(("_softplus", cfg_sp, packed_sp, er))
        for tag, c, pk, e in runs:
            rk, sk = fm.fused_fwd_cuda(pk, c, x, dr, e)
            rk2, sk2 = fm.fused_fwd_cuda(pk, c, x, dr, e)
            rp, sp = fm.fused_fwd_plain(pk, c, x, dr, e)
            torch.cuda.synchronize()
            checks = {"field_rgb": max_err(rk, rp),
                      "field_sigma": max_err((sk - sp) / sp.abs().clamp_min(1.0), 0 * sp)}
            for name, e_ in checks.items():
                errs[f"K1@{n}{tag}.{name}"] = e_
                if not math.isfinite(e_) or e_ > fr.PLAIN_TOL[name]:
                    failures.append(f"K1@{n}{tag}.{name}: {e_} > {fr.PLAIN_TOL[name]}")
            errs[f"K1@{n}{tag}.sigma"] = max_err(sk, sp)
            if not (torch.equal(rk, rk2) and torch.equal(sk, sk2)):
                failures.append(f"K1@{n}{tag}: two calls differ")
        del x, dr, er, rk, sk, rk2, sk2, rp, sp
    del packed_sp

    # the fused route against the reference route (module forward at every
    # sample: nerf_apply's encoding form, sin(2^i (o + z d)) whose f32
    # rounding 2^9 amplifies, and bf16 density matmul; sorted union) and
    # against the per-sample kernel route (K1 at every sample; sorted union)
    n = 512
    o, d, emb = (x[:n] for x in chunk[:3])
    with torch.no_grad():
        ker = render_rays(model, cfg, o, d, emb, perturb=False, fused_composite=True)
        routes = {"render_rays": render_rays(model, cfg.replace(use_kernels=False), o, d, emb,
                                             perturb=False, fused_composite=False),
                  "render_rays_per_sample": render_rays(model, cfg, o, d, emb, perturb=False,
                                                        fused_composite=False)}
    torch.cuda.synchronize()
    for route, ref in routes.items():
        for k, t in SLICE_TOL.items():
            e = max_err(ker[k], ref[k])
            errs[f"{route}.{k}"] = e
            if not math.isfinite(e) or e > t:
                failures.append(f"{route}.{k}: {e} > {t}")

    emit({"phase": "kernels", "rays": [4093, cfg.render_chunk],
          "k1_rows": [4093 * 32, 65536, 131072], "max_abs_err": errs,
          "tolerance": {**fr.PLAIN_TOL, **{f"render_rays.{k}": v for k, v in SLICE_TOL.items()}},
          "mean_acc": mean_acc, "failures": failures})
    if failures:
        raise AssertionError("kernel disagrees with its plain version: " + "; ".join(failures))
    # the kernels record takes absolute errors (field_sigma's is relative)
    worst = {kern: max(v for k, v in errs.items()
                       if k.startswith(kern) and not k.endswith("field_sigma"))
             for kern in ("K1", "K2", "K5")}
    return worst, chunk


def _cotangents(n, s, g, device):
    """Seeded non-zero cotangents of K2's outputs: rgb, depth, acc, weights,
    field."""
    import torch

    return (torch.randn(n, 3, generator=g, device=device),
            torch.randn(n, generator=g, device=device),
            torch.randn(n, generator=g, device=device),
            0.1 * torch.randn(n, s, generator=g, device=device),
            0.1 * torch.randn(n, 4, s, generator=g, device=device))


def _tie(z, z_f):
    """z_f with its sixth depth set to each ray's eighth coarse depth, sorted:
    a coarse/fine tie (the merge puts the coarse sample first)."""
    import torch

    z_f = z_f.clone()
    z_f[:, 5] = z[:, 7]
    return torch.sort(z_f, dim=-1).values


def checks(errs, grad_rel, failures, model):
    """(check, check_grads): record a max abs error (in ``errs``) or each
    parameter gradient's relative Frobenius error against the kernel's plain
    version (the worst in ``grad_rel``) and append to ``failures`` what is
    over its limit or not finite."""
    from danerf_tpu_torch.kernels import fused_render as fr

    limit_g = fr.PLAIN_TOL["grad_rel"]

    def check(name, err, limit):
        errs[name] = err
        if not math.isfinite(err) or err > limit:
            failures.append(f"{name}: {err} > {limit}")

    def check_grads(tag, got, want):
        rel = fr.grad_rel_errors(got, want, model)
        worst = max(rel, key=rel.get)
        grad_rel[tag] = {"worst": rel[worst], "param": worst}
        if not math.isfinite(rel[worst]) or rel[worst] > limit_g:
            failures.append(f"{tag}.grad_rel {worst}: {rel[worst]} > {limit_g}")

    return check, check_grads


def phase_bwd(cfg, model, device):
    """The backward and training kernels against their plain versions at 37
    rays and at the 1024-ray batch: K3 (every cotangent seeded, want_field on
    and off), K4 and K7 (seeded targets), K6 (every cotangent seeded,
    weights in merged order, a coarse/fine tie in z); K8 at 37, 129 (one
    tile and one row), 2,400 (19 tiles, the last ragged), 65,536 and
    131,072 rows (a 1024-ray batch's coarse and fine rows), with the
    appearance projection and packed as zeros (a zero embedding).  K3, K7
    and K8 run twice and must agree bit for bit.
    Returns the max abs error of each kernel's per-ray (per-row) outputs
    (and loss) for the kernels record."""
    import torch

    from danerf_tpu_torch.kernels import fused_mlp as fm
    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.kernels.fused_mlp import PackedGrads, pack_params
    from danerf_tpu_torch.ops.sampling import sample_pdf

    tol = fr.PLAIN_TOL
    packed = pack_params(model, cfg)
    sa = cfg.num_samples + cfg.num_importance
    errs, grad_rel, failures, deterministic, drop = {}, {}, [], {"K3": True, "K7": True}, {}
    check, check_grads = checks(errs, grad_rel, failures, model)

    def same(a, b):
        return bool(torch.equal(a.mats, b.mats) and torch.equal(a.vecs, b.vecs))

    def dropped(kern, got, want, first=2, **first_block):
        """What losing the first block (2 rays at 64 samples; K8: 128 rows)
        does: the summed gradients' relative change, and the block's per-ray
        (per-row) outputs, which would be missing."""
        eff = fr.grad_rel_errors(got, want, model)
        drop[kern] = {"grad_rel_min": min(eff.values()), "grad_rel_max": max(eff.values()),
                      **{k: float(v[:first].abs().max()) for k, v in first_block.items()}}

    for n, seed in ((37, 11), (cfg.batch_size, 12)):
        o, d, emb, z = make_rays(n, cfg, seed=seed, device=device)
        g = torch.Generator(device=device).manual_seed(seed + 100)
        *cot, g_field = _cotangents(n, cfg.num_samples, g, device)
        for want_field in (True, False):
            gf = g_field if want_field else None
            tag = f"K3{'_field' if want_field else ''}@{n}"
            gk, dk = fr.march_bwd_cuda(packed, cfg, o, d, emb, z, *cot, gf)
            gk2, _ = fr.march_bwd_cuda(packed, cfg, o, d, emb, z, *cot, gf)
            gp, dp = fr.march_bwd_plain(packed, cfg, o, d, emb, z, *cot, gf)
            torch.cuda.synchronize()
            deterministic["K3"] &= same(gk, gk2)
            check_grads(tag, gk, gp)
            check(f"{tag}.demb", max_err(dk, dp), tol["demb"])
            if n == 37 and want_field:
                gd, _ = fr.march_bwd_plain(packed, cfg, o[2:], d[2:], emb[2:], z[2:],
                                           *(c[2:] for c in cot), gf[2:])
                dropped("K3", gd, gp, demb=dp)
        coarse = fr.march_cuda(packed, cfg, o, d, emb, z, want_field=True)
        z_f = sample_pdf(z, coarse["weights"], cfg.num_importance, True, rand=g)
        target = torch.rand(n, 3, generator=g, device=device)
        lk, gk, dk, fk = fr.merged_train_cuda(packed, cfg, o, d, emb, z, coarse["field"], z_f,
                                              target)
        lp, gp, dp, fp = fr.merged_train_plain(packed, cfg, o, d, emb, z, coarse["field"], z_f,
                                               target)
        torch.cuda.synchronize()
        check_grads(f"K4@{n}", gk, gp)
        check(f"K4@{n}.loss", abs(float(lk) - float(lp)), tol["loss"])
        check(f"K4@{n}.demb", max_err(dk, dp), tol["demb_k4"])
        check(f"K4@{n}.g_field", max_err(fk, fp), tol["g_field"])
        errs[f"K4@{n}.g_field_scale"] = float(fp.abs().max())

        # K7: the coarse-only loss and its gradients
        lk, gk, dk = fr.march_train_cuda(packed, cfg, o, d, emb, z, target)
        lk2, gk2, dk2 = fr.march_train_cuda(packed, cfg, o, d, emb, z, target)
        lp, gp, dp = fr.march_train_plain(packed, cfg, o, d, emb, z, target)
        torch.cuda.synchronize()
        deterministic["K7"] &= (same(gk, gk2) and bool(torch.equal(lk, lk2))
                                and bool(torch.equal(dk, dk2)))
        check_grads(f"K7@{n}", gk, gp)
        check(f"K7@{n}.loss", abs(float(lk) - float(lp)), tol["loss"])
        check(f"K7@{n}.demb", max_err(dk, dp), tol["demb_k4"])
        errs[f"K7@{n}.demb_scale"] = float(dp.abs().max())
        if n == 37:
            # the other rays' terms, still over 3R
            _, gd, _ = fr.march_train_plain(packed, cfg, o[2:], d[2:], emb[2:], z[2:], target[2:])
            f = (n - 2) / n
            dropped("K7", PackedGrads(gd.mats * f, gd.vecs * f, gd.packed), gp, demb=dp)

        # K6: the merged composite's VJP, every cotangent non-zero
        z_t = _tie(z, z_f)
        c6 = (torch.randn(n, 3, generator=g, device=device),
              torch.randn(n, generator=g, device=device),
              torch.randn(n, generator=g, device=device),
              0.1 * torch.randn(n, sa, generator=g, device=device))
        gk, dk, fk = fr.merged_bwd_cuda(packed, cfg, o, d, emb, z, coarse["field"], z_t, *c6)
        gp, dp, fp = fr.merged_bwd_plain(packed, cfg, o, d, emb, z, coarse["field"], z_t, *c6)
        torch.cuda.synchronize()
        check_grads(f"K6@{n}", gk, gp)
        check(f"K6@{n}.demb", max_err(dk, dp), tol["demb"])
        check(f"K6@{n}.g_field", max_err(fk, fp), tol["g_field_k6"])
        errs[f"K6@{n}.g_field_scale"] = float(fp.abs().max())
        if n == 37:
            gd, _, _ = fr.merged_bwd_plain(packed, cfg, o[2:], d[2:], emb[2:], z[2:],
                                           coarse["field"][2:], z_t[2:], *(c[2:] for c in c6))
            dropped("K6", gd, gp, demb=dp, g_field=fp)
        del coarse

    # K8: the per-sample field's backward under seeded per-row cotangents,
    # at 37 and 129 rows (below one tile, one tile and a row), 2,400 (19
    # tiles, the last ragged), and the 65,536 and 131,072 rows of a 1024-ray
    # batch's coarse and fine evaluations; with the appearance projection
    # and packed as zeros (a zero embedding)
    deterministic["K8"] = True
    packed_noapp = pack_params(model, cfg, appearance=False)
    for n, seed in ((37, 15), (129, 16), (2400, 13), (cfg.batch_size * cfg.num_samples, 17),
                    (2 * cfg.batch_size * cfg.num_samples, 14)):
        x, dr, er = (t[:n] for t in sample_rows(-(-n // cfg.num_samples), cfg, seed, device,
                                                cfg.num_samples))
        g = torch.Generator(device=device).manual_seed(seed + 100)
        g_rgb = torch.randn(n, 3, generator=g, device=device)
        g_sig = torch.randn(n, 1, generator=g, device=device)
        for app, pk, e in (("", packed, er), ("_noapp", packed_noapp, torch.zeros_like(er))):
            gk, dk = fm.fused_bwd_cuda(pk, cfg, x, dr, e, g_rgb, g_sig)
            gk2, dk2 = fm.fused_bwd_cuda(pk, cfg, x, dr, e, g_rgb, g_sig)
            gp, dp = fm.fused_bwd_plain(pk, cfg, x, dr, e, g_rgb, g_sig)
            torch.cuda.synchronize()
            deterministic["K8"] &= same(gk, gk2) and bool(torch.equal(dk, dk2))
            check_grads(f"K8@{n}{app}", gk, gp)
            check(f"K8@{n}{app}.demb", max_err(dk, dp), tol["demb_k8"])
            errs[f"K8@{n}{app}.demb_scale"] = float(dp.abs().max())
            if n == 2400 and not app:
                gd, _ = fm.fused_bwd_plain(pk, cfg, x[128:], dr[128:], e[128:], g_rgb[128:],
                                           g_sig[128:])
                dropped("K8", gd, gp, first=128, demb=dp)
            del gk, gk2, gp, dk, dk2, dp
    for kern, ok in deterministic.items():
        if not ok:
            failures.append(f"{kern} gave different results on the same inputs")
    emit({"phase": "bwd", "rays": [37, cfg.batch_size], "max_abs_err": errs,
          "grad_rel": grad_rel, "dropped_block_effect_at_37": drop,
          "deterministic": deterministic,
          "tolerance": {k: tol[k] for k in ("grad_rel", "demb", "demb_k4", "g_field",
                                            "g_field_k6", "loss", "demb_k8")},
          "failures": failures})
    if failures:
        raise AssertionError("backward kernel disagrees with its plain version: "
                             + "; ".join(failures))
    return {kern: max(v for k, v in errs.items() if k.startswith(kern) and "scale" not in k)
            for kern in ("K3", "K4", "K6", "K7", "K8")}


def phase_time_kernels(cfg, model, device):
    """The has_time variants (use_time: the encoded time at the first and
    the skip layers, kx = 80) against their plain versions, each ray's (each
    row's) time uniform in [0, 1]: K2 with want_field and K5 (z_f from
    sample_pdf) at 4093 rays and on one 65,536-ray chunk; K3 (every
    cotangent, g_field) and K6 (every cotangent, a coarse/fine tie) at 37
    rays and at the 1024-ray batch; K4 and K7 (seeded targets) at 37 rays;
    K1 at 4093 x 32 = 130,976 rows (ragged) and K8 at 37, 129 and 2,400
    rows (19 tiles).  Returns the worst abs error per kernel and the chunk's inputs
    (with t) for the timing phase."""
    import torch

    from danerf_tpu_torch.kernels import fused_mlp as fm
    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.kernels.fused_mlp import pack_params
    from danerf_tpu_torch.ops.sampling import sample_pdf

    tol = fr.PLAIN_TOL
    packed = pack_params(model, cfg)
    errs, grad_rel, failures = {}, {}, []
    check, check_grads = checks(errs, grad_rel, failures, model)

    def times(n, seed):
        return torch.rand(n, 1, generator=torch.Generator(device=device).manual_seed(seed),
                          device=device)

    chunk = None
    for n, seed in ((4093, 41), (cfg.render_chunk, 44)):
        o, d, emb, z = make_rays(n, cfg, seed=seed, device=device)
        t = times(n, seed + 1)
        want_f = fr.march_plain(packed, cfg, o, d, emb, z, t, want_field=True)
        got_f = fr.march_cuda(packed, cfg, o, d, emb, z, t, want_field=True)
        torch.cuda.synchronize()
        compare(errs, failures, f"K2t_field@{n}", got_f, want_f,
                ["rgb", "depth", "acc", "weights", "field"])
        g = torch.Generator(device=device).manual_seed(seed + 2)
        z_f = sample_pdf(z, want_f["weights"], cfg.num_importance, True, rand=g)
        want_m = fr.merged_plain(packed, cfg, o, d, emb, z, want_f["field"], z_f, t)
        got_m = fr.merged_cuda(packed, cfg, o, d, emb, z, want_f["field"], z_f, t)
        torch.cuda.synchronize()
        compare(errs, failures, f"K5t@{n}", got_m, want_m,
                ["rgb", "depth", "acc", "weights", "z_vals"])
        del want_f, got_f, want_m, got_m
        chunk = (o, d, emb, z, z_f, t)
    tile_shapes(cfg, model, device, errs, failures, "t", with_time=True)

    for n, seed in ((37, 51), (cfg.batch_size, 52)):
        o, d, emb, z = make_rays(n, cfg, seed=seed, device=device)
        t = times(n, seed + 1)
        g = torch.Generator(device=device).manual_seed(seed + 100)
        *cot, g_field = _cotangents(n, cfg.num_samples, g, device)
        gk, dk = fr.march_bwd_cuda(packed, cfg, o, d, emb, z, *cot, g_field, t=t)
        gp, dp = fr.march_bwd_plain(packed, cfg, o, d, emb, z, *cot, g_field, t=t)
        torch.cuda.synchronize()
        check_grads(f"K3t_field@{n}", gk, gp)
        check(f"K3t_field@{n}.demb", max_err(dk, dp), tol["demb"])
        coarse = fr.march_cuda(packed, cfg, o, d, emb, z, t, want_field=True)
        z_f = sample_pdf(z, coarse["weights"], cfg.num_importance, True, rand=g)
        z_t = _tie(z, z_f)
        c6 = (torch.randn(n, 3, generator=g, device=device),
              torch.randn(n, generator=g, device=device),
              torch.randn(n, generator=g, device=device),
              0.1 * torch.randn(n, cfg.num_samples + cfg.num_importance, generator=g,
                                device=device))
        gk, dk, fk = fr.merged_bwd_cuda(packed, cfg, o, d, emb, z, coarse["field"], z_t, *c6,
                                        t=t)
        gp, dp, fp = fr.merged_bwd_plain(packed, cfg, o, d, emb, z, coarse["field"], z_t, *c6,
                                         t=t)
        torch.cuda.synchronize()
        check_grads(f"K6t@{n}", gk, gp)
        check(f"K6t@{n}.demb", max_err(dk, dp), tol["demb"])
        check(f"K6t@{n}.g_field", max_err(fk, fp), tol["g_field_k6"])
        if n == 37:
            # K4 and K7 take t too, though no route of either package reaches them with it
            target = torch.rand(n, 3, generator=g, device=device)
            lk, gk, dk, fk = fr.merged_train_cuda(packed, cfg, o, d, emb, z, coarse["field"],
                                                  z_f, target, t)
            lp, gp, dp, fp = fr.merged_train_plain(packed, cfg, o, d, emb, z, coarse["field"],
                                                   z_f, target, t)
            torch.cuda.synchronize()
            check_grads(f"K4t@{n}", gk, gp)
            check(f"K4t@{n}.loss", abs(float(lk) - float(lp)), tol["loss"])
            check(f"K4t@{n}.demb", max_err(dk, dp), tol["demb_k4"])
            check(f"K4t@{n}.g_field", max_err(fk, fp), tol["g_field"])
            lk, gk, dk = fr.march_train_cuda(packed, cfg, o, d, emb, z, target, t)
            lp, gp, dp = fr.march_train_plain(packed, cfg, o, d, emb, z, target, t)
            torch.cuda.synchronize()
            check_grads(f"K7t@{n}", gk, gp)
            check(f"K7t@{n}.loss", abs(float(lk) - float(lp)), tol["loss"])
            check(f"K7t@{n}.demb", max_err(dk, dp), tol["demb_k4"])
        del coarse

    # K1 on the samples of 4093 rays x 32 (130,976 rows, a ragged tile) and
    # on its first 4,093 rows (32 tiles, the last ragged), K8 at 37, 129 and
    # 2,400 rows (19 tiles), each row with its own time
    x, dr, er = sample_rows(4093, cfg, 61, device, 32)
    t = times(x.shape[0], 62)
    for n in (4093, x.shape[0]):
        rk, sk = fm.fused_fwd_cuda(packed, cfg, x[:n], dr[:n], er[:n], t[:n])
        rp, sp = fm.fused_fwd_plain(packed, cfg, x[:n], dr[:n], er[:n], t[:n])
        torch.cuda.synchronize()
        check(f"K1t@{n}.field_rgb", max_err(rk, rp), tol["field_rgb"])
        check(f"K1t@{n}.field_sigma", max_err((sk - sp) / sp.abs().clamp_min(1.0), 0 * sp),
              tol["field_sigma"])
    for n, seed in ((37, 64), (129, 65), (2400, 63)):
        g = torch.Generator(device=device).manual_seed(seed)
        g_rgb = torch.randn(n, 3, generator=g, device=device)
        g_sig = torch.randn(n, 1, generator=g, device=device)
        rows = (x[:n], dr[:n], er[:n], g_rgb, g_sig, t[:n])
        gk, dk = fm.fused_bwd_cuda(packed, cfg, *rows)
        gp, dp = fm.fused_bwd_plain(packed, cfg, *rows)
        torch.cuda.synchronize()
        check_grads(f"K8t@{n}", gk, gp)
        check(f"K8t@{n}.demb", max_err(dk, dp), tol["demb_k8"])
    emit({"phase": "time_kernels", "time_enc_levels": cfg.time_enc_levels,
          "rays": [4093, cfg.render_chunk, 37, cfg.batch_size], "k1_rows": [4093, 4093 * 32],
          "k8_rows": [37, 129, 2400], "max_abs_err": errs, "grad_rel": grad_rel,
          "failures": failures})
    if failures:
        raise AssertionError("has_time kernel disagrees with its plain version: "
                             + "; ".join(failures))
    # the kernels record takes absolute errors (field_sigma's is relative)
    worst = {kern: max(v for k, v in errs.items()
                       if k.startswith(kern + "t") and not k.endswith("field_sigma"))
             for kern in ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8")}
    return worst, chunk


def phase_hier_onepass(cfg, model, cfg_t, model_t, device):
    """K9, the one-kernel hierarchical training step, and its has_time
    variant on the time model (which no route reaches) against their plain
    versions: at 37 rays (19 CTAs at 64 + 64, so a lost or doubled CTA
    shows) and at the 1024-ray batch, at Sc + Sf = 64 + 64, 64 + 16,
    128 + 128, 48 + 32 and 32 + 64 (2, 2, 1, 2 and 2 rays a tile: the fine
    rows fewer than, as many as and more than the coarse ones); seeded
    targets, uniforms from importance_uniforms (each ray's time uniform in
    [0, 1]).  Both MSEs, every gradient and demb; two calls on the same
    inputs must agree bit for bit.  Returns the worst abs error of each
    variant's per-ray outputs and losses for the kernels record."""
    import torch

    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.kernels.fused_mlp import pack_params
    from danerf_tpu_torch.ops.sampling import importance_uniforms

    tol = fr.PLAIN_TOL
    errs, grad_rel, failures, deterministic = {}, {}, [], True
    cases = []
    for tag, c, m, seed in (("K9", cfg, model, 71), ("K9t", cfg_t, model_t, 73)):
        for k, (sc, sf) in enumerate(((64, 64), (64, 16), (128, 128), (48, 32), (32, 64))):
            for n in (37, cfg.batch_size):
                # 64 + 64 keeps its seeds: 71 and 72 at 37 and 1024 rays, 73 with time
                s = seed + (n != 37) if k == 0 else 200 + 10 * k + (n != 37) + 5 * (tag == "K9t")
                cases.append((tag, c.replace(num_samples=sc, num_importance=sf), m, n, s))
    for tag, c, m, n, seed in cases:
        check, check_grads = checks(errs, grad_rel, failures, m)
        packed = pack_params(m, c)
        o, d, emb, z = make_rays(n, c, seed=seed, device=device)
        g = torch.Generator(device=device).manual_seed(seed + 100)
        u = importance_uniforms((n,), c.num_importance, True, rand=g, device=device)
        target = torch.rand(n, 3, generator=g, device=device)
        t = torch.rand(n, 1, generator=g, device=device) if c.use_time else None
        args = (packed, c, o, d, emb, z, u, target, t)
        k, k2 = fr.hier_onepass_cuda(*args), fr.hier_onepass_cuda(*args)
        p = fr.hier_onepass_plain(*args)
        torch.cuda.synchronize()
        flat = lambda r: (r[0], r[1], r[2].mats, r[2].vecs, r[3])  # noqa: E731
        deterministic &= all(bool(torch.equal(a, b)) for a, b in zip(flat(k), flat(k2)))
        name = f"{tag}@{n}x{c.num_samples}+{c.num_importance}"
        check_grads(name, k[2], p[2])
        check(f"{name}.loss_fine", abs(float(k[0]) - float(p[0])), tol["loss_k9"])
        check(f"{name}.loss_coarse", abs(float(k[1]) - float(p[1])), tol["loss_k9"])
        check(f"{name}.demb", max_err(k[3], p[3]), tol["demb_k9"])
        errs[f"{name}.demb_scale"] = float(p[3].abs().max())
        errs[f"{name}.loss"] = [float(k[0]), float(k[1])]
    if not deterministic:
        failures.append("K9 gave different results on the same inputs")
    emit({"phase": "hier_onepass", "rays": [37, cfg.batch_size],
          "samples": sorted({f"{c.num_samples}+{c.num_importance}" for _, c, *_ in cases}),
          "max_abs_err": errs, "grad_rel": grad_rel, "deterministic": deterministic,
          "tolerance": {k: tol[k] for k in ("grad_rel", "loss_k9", "demb_k9")},
          "failures": failures})
    if failures:
        raise AssertionError("K9 disagrees with its plain version: " + "; ".join(failures))
    return {kern: max(v for key, v in errs.items()
                      if key.startswith(kern + "@") and not key.endswith(("scale", ".loss")))
            for kern in ("K9", "K9t")}


# The least factor by which the f32 kernels' error against the f32 plain
# versions must undercut the bf16 kernels' against the same outputs (max abs
# over rgb, weights, depth and the field, at each shape): a tile that rounds
# to bf16 or to one TF32 pass (~8x finer than bf16) somewhere does not reach it.
F32_GAIN = 16.0


def phase_f32_kernels(cfg, model, cfg_t, model_t, device):
    """The f32 variants (use_bf16=False) of K2, K5 and K1 (csrc/field_f32_sm90.cuh,
    3xTF32), without and with time, against their f32 plain versions on the card
    (TF32 off, the flags printed) within fused_render.PLAIN_TOL_F32, at the
    shapes tile_shapes holds the bf16 kernels to and up to a chunk: K2 at 37
    rays x 64 and 4093 rays x S = 32, 48, 64, 100, 128 with and without its
    field, and on a 65,536-ray chunk (64 with the field, medium's coarse
    pass; 32, preview); K5 at 37 rays x 64 + 64, 4093 x 64 + 64, 64 + 16,
    128 + 128 with and without the appearance projection, and the chunk's
    64 + 64 (z_f from sample_pdf of the plain coarse weights); K1 at 37,
    128, 129, 4093 x 32 = 130,976, 65,536 and 131,072 rows, with and
    without the appearance projection, and rows 5..133 of the 131,072 alone
    (other tiles, another grid) bit for bit as in the whole call.  Beside
    each, the bf16 kernel's error against the same f32 plain outputs; the
    f32 one must be at least F32_GAIN times smaller.  Two calls agree bit
    for bit.  Returns the worst abs error of each kernel and variant, and
    the worst ratio."""
    import torch

    from danerf_tpu_torch.kernels import fused_mlp as fm
    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.kernels.fused_mlp import pack_params
    from danerf_tpu_torch.ops.sampling import sample_pdf

    tol = fr.PLAIN_TOL_F32
    flags = {"matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
             "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
             "float32_matmul_precision": torch.get_float32_matmul_precision()}
    if flags["matmul.allow_tf32"] or flags["float32_matmul_precision"] != "highest":
        raise AssertionError(f"the f32 plain versions must run in full f32: {flags}")
    errs, bf16_errs, ratios, failures, same = {}, {}, {}, [], True
    R = cfg.render_chunk

    def held(name, keys, want, got, got16, again):
        nonlocal same
        torch.cuda.synchronize()
        compare(errs, failures, name, got, want, keys, tol)
        e16 = output_errs(got16, want, keys)
        bf16_errs.update({f"{name}.{k}": v for k, v in e16.items()})
        ratio_keys = [k for k in e16 if k not in ("acc", "z_vals")]
        worst32 = max(errs[f"{name}.{k}"] for k in ratio_keys)
        worst16 = max(e16[k] for k in ratio_keys)
        ratios[name] = worst16 / worst32 if worst32 > 0 else math.inf
        if not ratios[name] >= F32_GAIN:
            failures.append(f"{name}: f32 error {worst32} only {ratios[name]}x below the bf16 "
                            f"kernel's {worst16}")
        if again is not None:
            same &= all(bool(torch.equal(got[k], again[k])) for k in got)

    for tag, c16, m in (("", cfg, model), ("t", cfg_t, model_t)):
        c = c16.replace(use_bf16=False)
        packs = {"": (pack_params(m, c), pack_params(m, c16)),
                 "_noapp": (pack_params(m, c, appearance=False),
                            pack_params(m, c16, appearance=False))}
        pk, pk16 = packs[""]

        def rays(n, s, seed):
            o, d, emb, z = make_rays(n, c, seed=seed, device=device, samples=s)
            t = (torch.rand(n, 1, generator=torch.Generator(device=device).manual_seed(seed + 7),
                            device=device) if c.use_time else None)
            return o, d, emb, z, t

        k2_shapes = [(37, 64, (True, False)), (4093, 32, (True, False)),
                     (4093, 48, (True, False)), (4093, 64, (True, False)),
                     (4093, 100, (True, False)), (4093, 128, (True, False)),
                     (R, 64, (True,)), (R, 32, (False,))]
        for n, s, fields in k2_shapes:
            o, d, emb, z, t = rays(n, s, 300 + s + (n == R))
            for wf in fields:
                want = fr.march_plain(pk, c, o, d, emb, z, t, want_field=wf)
                got = fr.march_cuda(pk, c, o, d, emb, z, t, want_field=wf)
                got16 = fr.march_cuda(pk16, c16, o, d, emb, z, t, want_field=wf)
                again = fr.march_cuda(pk, c, o, d, emb, z, t, want_field=wf) if n == 4093 else None
                held(f"K2f32{tag}@{n}x{s}{'_field' if wf else ''}",
                     ["rgb", "depth", "acc", "weights"] + (["field"] if wf else []),
                     want, got, got16, again)
                del want, got, got16, again
        for n, sc, sf, apps in ((37, 64, 64, ("",)), (4093, 64, 64, ("", "_noapp")),
                                (4093, 64, 16, ("", "_noapp")), (4093, 128, 128, ("", "_noapp")),
                                (R, 64, 64, ("",))):
            o, d, emb, z, t = rays(n, sc, 400 + sc + sf + (n == R))
            g = torch.Generator(device=device).manual_seed(sc + sf)
            for app in apps:
                p32, p16 = packs[app]
                e = emb if app == "" else torch.zeros_like(emb)
                coarse = fr.march_plain(p32, c, o, d, e, z, t, want_field=True)
                z_f = sample_pdf(z, coarse["weights"], sf, True, rand=g)
                args = (o, d, e, z, coarse["field"], z_f, t)
                want = fr.merged_plain(p32, c, *args)
                got = fr.merged_cuda(p32, c, *args)
                got16 = fr.merged_cuda(p16, c16, *args)
                again = fr.merged_cuda(p32, c, *args) if n == 4093 else None
                held(f"K5f32{tag}@{n}x{sc}+{sf}{app}",
                     ["rgb", "depth", "acc", "weights", "z_vals"], want, got, got16, again)
                del coarse, want, got, got16, again
        for n_rays, s_per, seed in ((37, 1, 500), (128, 1, 504), (129, 1, 505),
                                    (4093, 32, 501), (1024, 64, 502), (1024, 128, 503)):
            x, dr, er = sample_rows(n_rays, c, seed, device, s_per)
            n = x.shape[0]
            t = (torch.rand(n, 1, generator=torch.Generator(device=device).manual_seed(seed),
                            device=device) if c.use_time else None)
            for app in ("", "_noapp"):
                p32, p16 = packs[app]
                e = er if app == "" else torch.zeros_like(er)
                out = {}
                for key, (pp, cc) in {"want": (p32, c), "got": (p32, c), "got16": (p16, c16),
                                      "again": (p32, c)}.items():
                    fn = fm.fused_fwd_plain if key == "want" else fm.fused_fwd_cuda
                    rgb, sigma = fn(pp, cc, x, dr, e, t)
                    out[key] = {"field": torch.cat([rgb, sigma], dim=-1)[:, :, None]}
                held(f"K1f32{tag}@{n}{app}", ["field"], out["want"], out["got"],
                     out["got16"], out["again"])
                if n == 131072 and app == "":
                    part = slice(5, 134)
                    rgb, sigma = fm.fused_fwd_cuda(p32, c, x[part], dr[part], e[part],
                                                   None if t is None else t[part])
                    same &= bool(torch.equal(torch.cat([rgb, sigma], dim=-1)[:, :, None],
                                             out["got"]["field"][part]))
                del out
    if not same:
        failures.append("an f32 kernel gave different results on the same inputs")
    worst = {f"{k}{tag}": max(v for key, v in errs.items()
                              if key.startswith(f"{k}f32{tag}@")
                              and not key.endswith("field_sigma"))
             for k in ("K1", "K2", "K5") for tag in ("", "t")}
    emit({"phase": "f32_kernels", "flags": flags, "max_abs_err": errs,
          "bf16_kernel_max_abs_err_vs_f32_plain": bf16_errs,
          "bf16_over_f32_error_ratio": ratios, "worst_ratio": min(ratios.values()),
          "tolerance": tol, "least_ratio": F32_GAIN, "deterministic": same,
          "failures": failures})
    if failures:
        raise AssertionError("f32 kernel disagrees with its plain version: "
                             + "; ".join(failures))
    return worst, min(ratios.values())


def frame_call(model, cfg, emb, side, device, quality="medium"):
    """render_frame as render_path calls it for frame 0 of a one-frame
    circle path at ``quality`` (seed 0): a function of no arguments."""
    import numpy as np
    import torch

    from danerf_tpu_torch.config import RENDER_PRESETS
    from danerf_tpu_torch.render.renderer import render_frame
    from danerf_tpu_torch.viz.paths import camera_path

    preset = RENDER_PRESETS[quality]
    c2w = camera_path("circle", 1, cfg.scene, 2.0, (-0.5, 0.5))[0]
    focal = 0.5 * side / np.tan(0.5 * 0.6911)
    n_samples = max(int(cfg.num_samples * preset["samples_scale"]), 1)
    n_importance = cfg.num_importance if preset["importance"] else 0
    return lambda: render_frame(
        model, cfg, c2w, side, side, focal, appearance_embedding=emb, n_samples=n_samples,
        n_importance=n_importance, perturb=preset["perturb"], chunk=preset["chunk"],
        generator=torch.Generator(device=device).manual_seed(0), device=device)


def frame_breakdown(model, cfg, emb, side, device, path_ms, rays, reps=3):
    """Where one medium render_path frame's time goes outside its kernels,
    with no profiler window open (best of ``reps`` each): render_frame
    alone (frame_call), its host time until it returns (issue_ms) and until
    the device is done (frame_ms); pack_params, which it runs once a frame
    (synchronised); the host time of one K2 (want_field) and one K5 launch
    on ``rays`` (o, d, emb, z, field, z_f of a chunk) while the device is
    busy, 10 back to back with no wait; and ``path_ms`` - frame_ms, what
    render_path adds to it: the copy back and the PNG and npy writes of the
    one frame, which no next frame hides."""
    import torch

    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.kernels.fused_mlp import pack_params

    frame = frame_call(model, cfg, emb, side, device)
    issue, whole, pack = [], [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame()
        issue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        whole.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        pk = pack_params(model, cfg, appearance=True)
        torch.cuda.synchronize()
        pack.append((time.perf_counter() - t0) * 1e3)
    o, d, e, z, field, z_f = rays
    host = {}
    for name, launch in (
            ("k2", lambda: fr.march_cuda(pk, cfg, o, d, e, z, want_field=True)),
            ("k5", lambda: fr.merged_cuda(pk, cfg, o, d, e, z, field, z_f))):
        launch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            launch()
        host[name] = (time.perf_counter() - t0) * 1e3 / 10
        torch.cuda.synchronize()
    return {"render_frame_issue_ms": min(issue), "render_frame_ms": min(whole),
            "render_path_minus_frame_ms": path_ms - min(whole), "pack_params_ms": min(pack),
            "host_ms_per_launch": host}


def phase_f32_path(cfg, model, cfg_t, model_t, out_dir, device, side=800):
    """The f32 serving path on the card, through the library entry point
    (no CLI flag reaches use_bf16 in either package): one 800x800 medium
    frame of render_path with use_bf16=False, launch counts zeroed just
    before and read just after (exactly 10 f32 K2 and 10 f32 K5 launches,
    nothing else), its ms, and its rgb and raw depth beside the bf16
    frame's (another numeric, so a loose bound: the field's bf16 rounding
    and the importance samples it moves); then render_rays' per-sample
    route on a 65,536-ray chunk with use_bf16=False (exactly 2 f32 K1
    launches, make_sharded_render's route), within PLAIN_TOL's render_rays
    bound of the fused f32 route on the same rays.  The same two runs on
    the time model at t = 0.5 drive the has_time variants (the frame: 10
    + 10, each launch counted apart; the route: 2 K1).  Then CUDA-event times
    of the f32 kernels and their plain versions beside their bounds: K2
    (want_field) and K5 on a chunk at TF32's rate (tf32x3_bound; also FP32's
    FFMA bound and the GB of their weight stream, weight_stream_gb), K1 at
    131,072 rows at the same two, without and with time.  Last, where the
    f32 and bf16 frames' time goes outside the kernels (frame_breakdown)."""
    import numpy as np
    import torch

    from danerf_tpu_torch.config import RENDER_PRESETS
    from danerf_tpu_torch.data.png import read_png
    from danerf_tpu_torch.kernels import fused_mlp as fm
    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.kernels.fused_mlp import pack_params
    from danerf_tpu_torch.ops.sampling import sample_pdf
    from danerf_tpu_torch.render.frames import render_path
    from danerf_tpu_torch.render.renderer import render_rays

    c32 = cfg.replace(use_bf16=False)
    emb0 = torch.randn(cfg.appearance_dim, generator=torch.Generator().manual_seed(3))
    runs = {}
    for name, m, c, t_frame in (("f32", model, c32, None), ("bf16", model, cfg, None),
                                ("f32_time", model_t, cfg_t.replace(use_bf16=False), 0.5)):
        run_dir = os.path.join(out_dir, f"f32_frame_{name}")
        fr.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        written = render_path(m, c, run_dir, appearance_embedding=emb0, num_frames=1,
                              quality="medium", width=side, height=side, raw_output=True,
                              save_depth=True, seed=0, time=t_frame, device=device)
        torch.cuda.synchronize()
        runs[name] = {"ms": (time.perf_counter() - t0) * 1e3, "launches": dict(fr.LAUNCHES),
                      "rgb": read_png(written[0]).astype(np.int32),
                      "depth": np.load(os.path.join(run_dir, "raw", "depth_000.npy"))}
    chunks = math.ceil(side * side / RENDER_PRESETS["medium"]["chunk"])
    want = {k: chunks if k in ("march_f32", "merged_f32") else 0 for k in fr.LAUNCHES}
    for name in ("f32", "f32_time"):
        if runs[name]["launches"] != want:
            raise AssertionError(f"{name} frame launches {runs[name]['launches']}, "
                                 f"expected {want}")
        depth = runs[name]["depth"]
        if depth.shape != (side, side) or not np.isfinite(depth).all():
            raise AssertionError(f"{name} frame depth {depth.shape} not finite")
    depth = runs["f32"]["depth"]
    vs_bf16 = {"rgb_max_levels": int(np.abs(runs["f32"]["rgb"] - runs["bf16"]["rgb"]).max()),
               "rgb_mean_levels": float(np.abs(runs["f32"]["rgb"] - runs["bf16"]["rgb"]).mean()),
               "depth_max_abs": float(np.abs(depth - runs["bf16"]["depth"]).max())}
    # the bf16 field's rgb differs by <= 1.5e-3 (f32_kernels); importance
    # samples placed by its coarse weights move a pixel further
    if vs_bf16["rgb_mean_levels"] > 0.5 or vs_bf16["rgb_max_levels"] > 16:
        raise AssertionError(f"the f32 frame is far from the bf16 frame: {vs_bf16}")

    # the per-sample route (K1 f32 at the coarse samples and at the union),
    # without and with time
    n = cfg.render_chunk
    k1_launches, route_err = {}, {}
    for tag, m, c in (("", model, c32), ("t", model_t, cfg_t.replace(use_bf16=False))):
        o, d, emb, _ = make_rays(n, c, seed=600, device=device)
        t = torch.full((n, 1), 0.5, device=device) if c.use_time else None
        with torch.no_grad():
            fused = render_rays(m, c, o, d, emb, t=t, perturb=False, fused_composite=True)
            fr.reset_launch_counts()
            per_sample = render_rays(m, c, o, d, emb, t=t, perturb=False,
                                     fused_composite=False)
            torch.cuda.synchronize()
        k1_launches[tag] = dict(fr.LAUNCHES)
        want = {k: 2 if k == "mlp_fwd_f32" else 0 for k in fr.LAUNCHES}
        if k1_launches[tag] != want:
            raise AssertionError(f"per-sample f32 route{tag} launches {k1_launches[tag]}, "
                                 f"expected {want}")
        route_err[tag] = {k: max_err(per_sample[k], fused[k]) for k in ("rgb", "acc", "depth")}
        bad = [k for k, v in route_err[tag].items() if not v <= SLICE_TOL[k]]
        if bad:
            raise AssertionError(f"per-sample f32 route{tag} vs fused f32 route: "
                                 f"{route_err[tag]}")
        del fused, per_sample, o, d, emb, t

    timing, bound_by = {}, {}
    for tag, c16, m in (("", cfg, model), ("t", cfg_t, model_t)):
        c = c16.replace(use_bf16=False)
        pk = pack_params(m, c)
        R, S, Sf = c.render_chunk, c.num_samples, c.num_importance
        o, d, emb, z = make_rays(R, c, seed=610, device=device)
        t = torch.rand(R, 1, device=device) if c.use_time else None
        field = fr.march_plain(pk, c, o, d, emb, z, t, want_field=True)
        z_f = sample_pdf(z, field["weights"], Sf, True,
                         rand=torch.Generator(device=device).manual_seed(611))
        field = field["field"]
        w_bytes = pk.mats.numel() * 4 + pk.vecs.numel() * 4
        w_split = w_bytes + pk.mats_tf32.numel() * 4   # K1, K2, K5: also the TF32 halves
        e, nt = c.appearance_dim, int(t is not None)
        k2_bytes = 4 * R * (3 + 3 + e + S + nt) + 4 * R * (3 + 1 + 1 + S + 4 * S) + w_split
        k5_bytes = (4 * R * (3 + 3 + e + S + 4 * S + Sf + nt)
                    + 4 * R * (3 + 1 + 1 + 2 * (S + Sf)) + w_split)
        timing[f"k2{tag}_ms"] = cuda_ms(
            lambda: fr.march_cuda(pk, c, o, d, emb, z, t, want_field=True), 3)
        timing[f"k2{tag}_plain_ms"] = cuda_ms(
            lambda: fr.march_plain(pk, c, o, d, emb, z, t, want_field=True), 3)
        # K2 and K5: 3xTF32 on the tensor cores; beside it FP32's FFMA bound
        # (the tile before this one's) and the GB of the weight stream
        timing[f"k2{tag}_bound_ms"], bound_by[f"k2{tag}"] = tf32x3_bound(c, R, S, k2_bytes)
        timing[f"k2{tag}_ffma_bound_ms"], _ = bound(c, R, S, k2_bytes)
        timing[f"k2{tag}_weight_stream_gb"] = weight_stream_gb(pk, math.ceil(R / min(128 // S, 8)))
        timing[f"k5{tag}_ms"] = cuda_ms(
            lambda: fr.merged_cuda(pk, c, o, d, emb, z, field, z_f, t), 3)
        timing[f"k5{tag}_plain_ms"] = cuda_ms(
            lambda: fr.merged_plain(pk, c, o, d, emb, z, field, z_f, t), 3)
        timing[f"k5{tag}_bound_ms"], bound_by[f"k5{tag}"] = tf32x3_bound(c, R, Sf, k5_bytes)
        timing[f"k5{tag}_ffma_bound_ms"], _ = bound(c, R, Sf, k5_bytes)
        timing[f"k5{tag}_weight_stream_gb"] = weight_stream_gb(pk, math.ceil(R / min(128 // Sf, 8)))
        del o, d, emb, z, field, z_f
        x, dr, er = sample_rows(c.batch_size, c, 612, device, S + Sf)
        rows = x.shape[0]
        tr = torch.rand(rows, 1, device=device) if c.use_time else None
        timing[f"k1{tag}_131072_ms"] = cuda_ms(lambda: fm.fused_fwd_cuda(pk, c, x, dr, er, tr), 10)
        timing[f"k1{tag}_131072_plain_ms"] = cuda_ms(
            lambda: fm.fused_fwd_plain(pk, c, x, dr, er, tr), 5)
        # K1 as K2 and K5: 3xTF32, FP32's FFMA bound beside
        k1_bytes = 4 * rows * (3 + 3 + e + nt) + 4 * rows * (3 + 1) + w_split
        timing[f"k1{tag}_131072_bound_ms"], bound_by[f"k1{tag}"] = tf32x3_bound(c, rows, 1,
                                                                                k1_bytes)
        timing[f"k1{tag}_131072_ffma_bound_ms"], _ = bound(c, rows, 1, k1_bytes)
        del x, dr, er

    # where each frame's time goes outside its 10 + 10 kernels
    breakdown = {}
    for name, c in (("f32", c32), ("bf16", cfg)):
        R = c.render_chunk
        o, d, emb, z = make_rays(R, c, seed=610, device=device)
        pk = pack_params(model, c)
        coarse = fr.march_cuda(pk, c, o, d, emb, z, want_field=True)
        field = coarse["field"]
        z_f = sample_pdf(z, coarse["weights"], c.num_importance, True,
                         rand=torch.Generator(device=device).manual_seed(611))
        breakdown[name] = frame_breakdown(model, c, emb0, side, device, runs[name]["ms"],
                                          (o, d, emb, z, field, z_f))
        del o, d, emb, z, coarse, field, z_f
    breakdown["f32"]["kernels_ms"] = chunks * (timing["k2_ms"] + timing["k5_ms"])
    report = {"phase": "f32_path", "frame": {
        "side": side, "quality": "medium", "render_path_ms": runs["f32"]["ms"],
        "launches": runs["f32"]["launches"], "bf16_render_path_ms": runs["bf16"]["ms"],
        "bf16_launches": runs["bf16"]["launches"], "vs_bf16_frame": vs_bf16,
        "derived_ms": chunks * (timing["k2_ms"] + timing["k5_ms"]),
        "bound_ms": chunks * (timing["k2_bound_ms"] + timing["k5_bound_ms"]),
        "ffma_bound_ms": chunks * (timing["k2_ffma_bound_ms"] + timing["k5_ffma_bound_ms"]),
        "outside_kernels": breakdown},
        "time_frame": {"t": 0.5, "render_path_ms": runs["f32_time"]["ms"],
                       "launches": runs["f32_time"]["launches"],
                       "derived_ms": chunks * (timing["k2t_ms"] + timing["k5t_ms"]),
                       "bound_ms": chunks * (timing["k2t_bound_ms"] + timing["k5t_bound_ms"])},
        "per_sample_route": {"rays": n, "launches": k1_launches[""],
                             "vs_fused_f32_route": route_err[""]},
        "per_sample_route_time": {"rays": n, "t": 0.5, "launches": k1_launches["t"],
                                  "vs_fused_f32_route": route_err["t"]},
        "timing": timing, "bound_by": bound_by}
    emit(report)
    return {"frame_launches": runs["f32"]["launches"], "k1_launches": k1_launches[""],
            "time_frame_launches": runs["f32_time"]["launches"],
            "time_k1_launches": k1_launches["t"], "timing": timing, "bound_by": bound_by}


def f32_bwd_bytes(cfg, packed, n, sc, sf):
    """Bytes K3, K4, K6 and K7 must move for n rays (sc coarse or march
    samples, sf fine ones): inputs read once, outputs written once, the f32
    weights read (transposed and as packed) and the f32 gradients written
    once."""
    e, nt, sa = cfg.appearance_dim, int(cfg.use_time), sc + sf
    wg = 4 * (3 * packed.mats.numel() + 2 * packed.vecs.numel())
    return {"k3": 4 * n * (3 + 3 + e + sc + nt + 3 + 1 + 1 + sc + 4 * sc) + 4 * n * e + wg,
            "k4": 4 * n * (3 + 3 + e + sc + 4 * sc + sf + 3 + nt) + 4 * n * (e + 4 * sc) + 4 + wg,
            "k6": (4 * n * (3 + 3 + e + sc + 4 * sc + sf + nt + 3 + 1 + 1 + sa)
                   + 4 * n * (e + 4 * sc) + wg),
            "k7": 4 * n * (3 + 3 + e + sc + 3 + nt) + 4 * n * e + 4 + wg}


def cpu_referee(fn, packed_cpu, cfg, device, *args, **kw):
    """A plain version run on the CPU (another f32 summation order) on CPU
    copies of the card's inputs, its outputs back on the card: the second
    f32 evaluation an f32 kernel is held to where a relu gate of the first
    lies on a rounding boundary (PLAIN_TOL_F32_BWD's comment)."""
    import torch

    from danerf_tpu_torch.kernels.fused_mlp import PackedGrads

    def cpu(x):
        return x.cpu() if isinstance(x, torch.Tensor) else x

    def back(x):
        if isinstance(x, PackedGrads):
            return PackedGrads(x.mats.to(device), x.vecs.to(device), x.packed)
        if isinstance(x, (tuple, list)):
            return type(x)(back(v) for v in x)
        return x.to(device) if isinstance(x, torch.Tensor) else x

    return back(fn(packed_cpu, cfg, *(cpu(a) for a in args),
                   **{k: cpu(v) for k, v in kw.items()}))


def phase_f32_bwd(cfg, model, cfg_t, model_t, device):
    """The f32 variants (use_bf16=False, csrc/field_bwd_f32_sm90.cuh) of
    K3, K7, K4 and K6 against their f32 plain versions on the card (TF32 off)
    within fused_render.PLAIN_TOL_F32_BWD, at 37 rays (a lost block shows),
    the 1024-ray batch and 4093 rays (a ragged last tile), at every shape
    the tile takes: K3 and K7 at S = 32, 48, 64, 100, 128 (K3 with every
    cotangent and g_field, without g_field, and at S = 64 with every
    cotangent null: exact zeros); K4 and K6 at Sc + Sf = 64 + 64, 64 + 16,
    64 + 48, 128 + 128 (K6 with a coarse/fine tie under every cotangent and
    the white-background pattern, g_rgb and g_acc); the has_time variants
    on the time model at 37 rays and the batch (S = 64, 64 + 64); the
    shapes the bf16 kernels refuse (refusals) refused by the f32 kernels
    too.  K8 at
    37, 4,093, 65,536 and 131,072 rows and K9 at Sc + Sf = 64 + 64, 64 + 16,
    128 + 128, 48 + 32 and 32 + 64 at 37 rays and the batch, both with and
    without time (K8 also with an embedding of 24 at 37 and 4,093 rows,
    which the bf16 K8 refuses: the bf16 plain version's error beside it):
    K9's gradients within grad_rel_k9 (it draws its
    importance depths from its own f32 coarse weights), its two losses
    within the loss key and its demb within demb_k4.  Two calls agree bit
    for bit.  Beside each, the bf16 kernel's error against
    the same f32 plain outputs (each gradient's relative Frobenius error,
    and demb): the f32 kernel's must be at least F32_GAIN times smaller.
    Where the kernel's gradients are off the card's plain version by more
    than the limit, the plain version also runs on the CPU (cpu_referee)
    and the kernel is held to that evaluation instead; both gaps and the
    two plain runs' own are reported (a relu gate on an f32 rounding
    boundary flips between summation orders).
    Then CUDA-event times of the four at B = 1024 and at 8,192 rays x 64
    beside their bounds (3xTF32's with the gate pass, tf32x3_bwd_bound, and
    FP32's FFMA bound beside) and their plain versions', with K2 and K5 f32
    at the batch (the rest of the f32 steps' kernels); of K1 and K8 at the
    batch's 65,536 and 131,072 rows and
    of K9 at the batch (K8 and K9 at 3xTF32's bound with their gate passes,
    K1 at 3xTF32's, FFMA's beside each; the has_time variants at
    131,072 rows and the batch).  Returns (worst abs error of
    each kernel and variant, the worst ratio, the times, their bound_by)."""
    import torch

    from danerf_tpu_torch.kernels import fused_mlp as fm
    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.kernels.fused_mlp import pack_params
    from danerf_tpu_torch.ops.sampling import importance_uniforms, sample_pdf

    tol = fr.PLAIN_TOL_F32_BWD
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("the f32 plain versions must run in full f32")
    errs, grad_rel, bf16, ratios, failures, same = {}, {}, {}, {}, [], True
    referee = {}

    def rel(got, want, m):
        r = fr.grad_rel_errors(got, want, m)
        return max(r.values()) if r else 0.0

    def held(name, m, got, again, got16, want, keys, want_cpu, grad_key="grad_rel"):
        """got/again/got16/want: (grads, *per-ray outputs) in ``keys``
        order (each key a tolerance key, or (label, tolerance key)); the f32
        kernel against want within tol (the gradients within
        tol[grad_key]; past it, against want_cpu(), the plain version on
        the CPU), bit for bit against again, its worst error F32_GAIN
        below the bf16 kernel's."""
        nonlocal same
        torch.cuda.synchronize()
        same &= all(bool(torch.equal(getattr(a, "mats", a), getattr(b, "mats", b)))
                    and bool(torch.equal(getattr(a, "vecs", a), getattr(b, "vecs", b)))
                    for a, b in zip(got, again))
        g32, glim = rel(got[0], want[0], m), tol[grad_key]
        if g32 > glim:
            w2 = want_cpu()
            referee[name] = {"card_plain": g32, "cpu_plain": rel(got[0], w2[0], m),
                             "plain_vs_plain": rel(w2[0], want[0], m)}
            want = w2
            g32 = referee[name]["cpu_plain"]
        g16 = rel(got16[0], want[0], m)
        grad_rel[name], bf16[f"{name}.grad_rel"] = g32, g16
        if not math.isfinite(g32) or g32 > glim:
            failures.append(f"{name}.grad_rel: {g32} > {glim}")
        pairs = [(g32, g16)]
        for key, a, a16, w in zip(keys, got[1:], got16[1:], want[1:]):
            label, key = key if isinstance(key, tuple) else (key, key)
            e, e16 = max_err(a, w), max_err(a16, w)
            errs[f"{name}.{label}"], bf16[f"{name}.{label}"] = e, e16
            limit = tol[key]
            if not math.isfinite(e) or e > limit:
                failures.append(f"{name}.{label}: {e} > {limit}")
            if key.startswith("demb"):
                pairs.append((e, e16))
        worst32, worst16 = max(a for a, _ in pairs), max(b for _, b in pairs)
        ratios[name] = worst16 / worst32 if worst32 > 0 else math.inf
        if not ratios[name] >= F32_GAIN:
            failures.append(f"{name}: f32 error {worst32} only {ratios[name]}x below the bf16 "
                            f"kernel's {worst16}")

    def zero(name, *outs):
        torch.cuda.synchronize()
        e = max(float(x.abs().max()) for x in outs)
        errs[f"{name}.zero"] = e
        if e != 0.0:
            failures.append(f"{name}: every cotangent null, an output {e} != 0")

    for tag, c16, m in (("", cfg, model), ("t", cfg_t, model_t)):
        c = c16.replace(use_bf16=False)
        p32, p16 = pack_params(m, c), pack_params(m, c16)
        pcpu = pack_params(m, c, device="cpu")
        sizes = (37, c.batch_size, 4093) if tag == "" else (37, c.batch_size)
        march_s = (32, 48, 64, 100, 128) if tag == "" else (64,)
        merged_s = ((64, 64), (64, 16), (64, 48), (128, 128)) if tag == "" else ((64, 64),)
        for n in sizes:
            for s in march_s:
                o, d, emb, z = make_rays(n, c, seed=700 + s, device=device, samples=s)
                g = torch.Generator(device=device).manual_seed(n + s + 700)
                t = torch.rand(n, 1, generator=g, device=device) if c.use_time else None
                *cot, g_field = _cotangents(n, s, g, device)
                cases = {"_field": (*cot, g_field), "": (*cot, None)}
                for case, ct in cases.items():
                    name = f"K3f32{tag}@{n}x{s}{case}"

                    def k3(pk, cc, ct=ct):
                        return fr.march_bwd_cuda(pk, cc, o, d, emb, z, *ct, t=t)
                    held(name, m, k3(p32, c), k3(p32, c), k3(p16, c16),
                         fr.march_bwd_plain(p32, c, o, d, emb, z, *ct, t=t), ["demb"],
                         lambda ct=ct: cpu_referee(fr.march_bwd_plain, pcpu, c, device, o, d,
                                                   emb, z, *ct, t=t))
                if s == 64:
                    name = f"K3f32{tag}@{n}x{s}_null"
                    gk, dk = fr.march_bwd_cuda(p32, c, o, d, emb, z, None, None, None, None,
                                               t=t)
                    zero(name, gk.mats, gk.vecs, dk)
                target = torch.rand(n, 3, generator=g, device=device)
                name = f"K7f32{tag}@{n}x{s}"

                def k7(pk, cc):
                    lk, gk, dk = fr.march_train_cuda(pk, cc, o, d, emb, z, target, t)
                    return gk, lk, dk
                lp, gp, dp = fr.march_train_plain(p32, c, o, d, emb, z, target, t)

                def k7_cpu():
                    lc, gc, dc = cpu_referee(fr.march_train_plain, pcpu, c, device, o, d, emb,
                                             z, target, t)
                    return gc, lc, dc
                held(name, m, k7(p32, c), k7(p32, c), k7(p16, c16), (gp, lp, dp),
                     ["loss", "demb_k4"], k7_cpu)
                del o, d, emb, z, cot, g_field
            for sc, sf in merged_s:
                o, d, emb, z = make_rays(n, c, seed=800 + sc + sf, device=device, samples=sc)
                g = torch.Generator(device=device).manual_seed(n + sc + sf + 800)
                t = torch.rand(n, 1, generator=g, device=device) if c.use_time else None
                target = torch.rand(n, 3, generator=g, device=device)
                coarse = fr.march_plain(p32, c, o, d, emb, z, t, want_field=True)
                z_f = sample_pdf(z, coarse["weights"], sf, True, rand=g)
                field = coarse["field"]
                name = f"K4f32{tag}@{n}x{sc}+{sf}"

                def k4(pk, cc):
                    lk, gk, dk, fk = fr.merged_train_cuda(pk, cc, o, d, emb, z, field, z_f,
                                                          target, t)
                    return gk, lk, dk, fk
                lp, gp, dp, fp = fr.merged_train_plain(p32, c, o, d, emb, z, field, z_f,
                                                       target, t)

                def k4_cpu():
                    lc, gc, dc, fc = cpu_referee(fr.merged_train_plain, pcpu, c, device, o, d,
                                                 emb, z, field, z_f, target, t)
                    return gc, lc, dc, fc
                held(name, m, k4(p32, c), k4(p32, c), k4(p16, c16), (gp, lp, dp, fp),
                     ["loss", "demb_k4", "g_field"], k4_cpu)
                z_t = _tie(z, z_f)
                c6 = _cotangents(n, sc + sf, g, device)[:4]
                for case, ct in {"": c6, "_white": (c6[0], None, c6[2], None)}.items():
                    name = f"K6f32{tag}@{n}x{sc}+{sf}{case}"

                    def k6(pk, cc, ct=ct):
                        return fr.merged_bwd_cuda(pk, cc, o, d, emb, z, field, z_t, *ct, t=t)
                    held(name, m, k6(p32, c), k6(p32, c), k6(p16, c16),
                         fr.merged_bwd_plain(p32, c, o, d, emb, z, field, z_t, *ct, t=t),
                         ["demb", "g_field_k6"],
                         lambda ct=ct: cpu_referee(fr.merged_bwd_plain, pcpu, c, device, o, d,
                                                   emb, z, field, z_t, *ct, t=t))
                del o, d, emb, z, coarse, field, z_f, z_t, c6
        if tag == "":
            failures += [f"f32 {f}" for f in refusals(c, p32, device)]

    # K8 in f32 (independent rows, each with its cotangents; demb per row)
    # and K9 in f32 (the one-kernel 64 + 64 step and four other shapes; its
    # gradients within grad_rel_k9: it draws its importance depths from its
    # own f32 coarse weights), with and without time
    for tag, c16, m in (("", cfg, model), ("t", cfg_t, model_t)):
        c = c16.replace(use_bf16=False)
        p32, p16 = pack_params(m, c), pack_params(m, c16)
        pcpu = pack_params(m, c, device="cpu")
        for n in (37, 4093, 65536, 131072):
            x, dr, er = (v[:n].contiguous() for v in sample_rows(-(-n // 64), c, 830 + n % 97,
                                                                 device, 64))
            g = torch.Generator(device=device).manual_seed(n + 830)
            g_rgb = torch.randn(n, 3, generator=g, device=device)
            g_sig = torch.randn(n, 1, generator=g, device=device)
            t = torch.rand(n, 1, generator=g, device=device) if c.use_time else None

            def k8(pk, cc):
                return fm.fused_bwd_cuda(pk, cc, x, dr, er, g_rgb, g_sig, t)
            held(f"K8f32{tag}@{n}", m, k8(p32, c), k8(p32, c), k8(p16, c16),
                 fm.fused_bwd_plain(p32, c, x, dr, er, g_rgb, g_sig, t), ["demb"],
                 lambda: cpu_referee(fm.fused_bwd_plain, pcpu, c, device, x, dr, er, g_rgb,
                                     g_sig, t))
            del x, dr, er, g_rgb, g_sig
        if tag == "":
            # an embedding of 24, which the bf16 K8 refuses (its appearance
            # product steps K by 16) and the f32 tile takes (row_app4 steps
            # by 4): the bf16 plain version's error beside
            c24 = c.replace(appearance_dim=24)
            m24 = make_model(c24, 0, device)
            p24, p24_16 = pack_params(m24, c24), pack_params(m24, c24.replace(use_bf16=True))
            for n in (37, 4093):
                x, dr, _ = (v[:n].contiguous() for v in sample_rows(-(-n // 64), c24, 880 + n % 97,
                                                                    device, 64))
                g = torch.Generator(device=device).manual_seed(n + 880)
                er = torch.randn(n, 24, generator=g, device=device)
                g_rgb = torch.randn(n, 3, generator=g, device=device)
                g_sig = torch.randn(n, 1, generator=g, device=device)
                args = (x, dr, er, g_rgb, g_sig)
                held(f"K8f32@E24@{n}", m24, fm.fused_bwd_cuda(p24, c24, *args),
                     fm.fused_bwd_cuda(p24, c24, *args),
                     fm.fused_bwd_plain(p24_16, c24.replace(use_bf16=True), *args),
                     fm.fused_bwd_plain(p24, c24, *args), ["demb"],
                     lambda: cpu_referee(fm.fused_bwd_plain, pack_params(m24, c24, device="cpu"),
                                         c24, device, *args))
            del x, dr, er, g_rgb, g_sig, m24, p24, p24_16
        for k, (sc, sf) in enumerate(((64, 64), (64, 16), (128, 128), (48, 32), (32, 64))):
            cs = c.replace(num_samples=sc, num_importance=sf)
            for n in (37, c.batch_size):
                o, d, emb, z = make_rays(n, cs, seed=850 + 10 * k + (n != 37), device=device)
                g = torch.Generator(device=device).manual_seed(860 + 10 * k + n)
                u = importance_uniforms((n,), sf, True, rand=g, device=device)
                target = torch.rand(n, 3, generator=g, device=device)
                t = torch.rand(n, 1, generator=g, device=device) if c.use_time else None
                args = (o, d, emb, z, u, target, t)

                def k9(pk, cc):
                    lf, lc, gk, dk = fr.hier_onepass_cuda(pk, cc, *args)
                    return gk, lf, lc, dk

                def k9_plain(out):
                    lf, lc, gk, dk = out
                    return gk, lf, lc, dk
                held(f"K9f32{tag}@{n}x{sc}+{sf}", m, k9(p32, cs), k9(p32, cs),
                     k9(p16, cs.replace(use_bf16=True)),
                     k9_plain(fr.hier_onepass_plain(p32, cs, *args)),
                     [("loss_fine", "loss"), ("loss_coarse", "loss"), ("demb", "demb_k4")],
                     lambda: k9_plain(cpu_referee(fr.hier_onepass_plain, pcpu, cs, device,
                                                  *args)),
                     grad_key="grad_rel_k9")
                del o, d, emb, z, u, target
    if not same:
        failures.append("an f32 backward kernel gave different results on the same inputs")

    # times at B = 1024 and at 8,192 rays (the has_time variants at B =
    # 1024), beside the FP32 bound (K2's: tf32x3_bound)
    timing, bound_by = {}, {}
    sc, sf = c.num_samples, c.num_importance
    for tag, c16, m, sizes in (("", cfg, model, (c.batch_size, 8192)),
                               ("t", cfg_t, model_t, (c.batch_size,))):
        c = c16.replace(use_bf16=False)
        p32 = pack_params(m, c)
        for n in sizes:
            o, d, emb, z = make_rays(n, c, seed=795, device=device)
            g = torch.Generator(device=device).manual_seed(796)
            t = torch.rand(n, 1, generator=g, device=device) if c.use_time else None
            *cot, g_field = _cotangents(n, sc, g, device)
            target = torch.rand(n, 3, generator=g, device=device)
            coarse = fr.march_cuda(p32, c, o, d, emb, z, t, want_field=True)
            z_f = sample_pdf(z, coarse["weights"], sf, True, rand=g)
            field = coarse["field"]
            c6 = (cot[0], cot[1], cot[2],
                  0.1 * torch.randn(n, sc + sf, generator=g, device=device))
            del coarse
            calls = {
                "k3": (lambda: fr.march_bwd_cuda(p32, c, o, d, emb, z, *cot, g_field, t=t),
                       lambda: fr.march_bwd_plain(p32, c, o, d, emb, z, *cot, g_field, t=t)),
                "k4": (lambda: fr.merged_train_cuda(p32, c, o, d, emb, z, field, z_f, target, t),
                       lambda: fr.merged_train_plain(p32, c, o, d, emb, z, field, z_f, target,
                                                     t)),
                "k6": (lambda: fr.merged_bwd_cuda(p32, c, o, d, emb, z, field, z_f, *c6, t=t),
                       lambda: fr.merged_bwd_plain(p32, c, o, d, emb, z, field, z_f, *c6, t=t)),
                "k7": (lambda: fr.march_train_cuda(p32, c, o, d, emb, z, target, t),
                       lambda: fr.march_train_plain(p32, c, o, d, emb, z, target, t)),
            }
            nbytes = f32_bwd_bytes(c, p32, n, sc, sf)
            samples = {"k3": sc, "k4": sf, "k6": sf, "k7": sc}
            for k, (kern, plain) in calls.items():
                timing[f"{k}{tag}_{n}_ms"] = cuda_ms(kern, 5 if n == 8192 else 10)
                timing[f"{k}{tag}_{n}_plain_ms"] = cuda_ms(plain, 2 if n == 8192 else 5)
                # on the tensor cores (3xTF32) with the gate pass's FFMA
                # forward; FP32's FFMA bound beside
                timing[f"{k}{tag}_{n}_bound_ms"], bound_by[k + tag] = tf32x3_bwd_bound(
                    c, n, samples[k], nbytes[k], gate_pass=True)
                timing[f"{k}{tag}_{n}_ffma_bound_ms"] = bound(c, n, samples[k], nbytes[k],
                                                              backward=True)[0]
            # K2 and K5 f32 at the batch, the rest of the 64 + 64 and white
            # steps' kernels
            e = c.appearance_dim
            timing[f"k2{tag}_{n}_ms"] = cuda_ms(
                lambda: fr.march_cuda(p32, c, o, d, emb, z, t, want_field=True), 10)
            timing[f"k2{tag}_{n}_bound_ms"], _ = tf32x3_bound(
                c, n, sc, 4 * n * (3 + 3 + e + sc) + 4 * n * (3 + 1 + 1 + 5 * sc)
                + 12 * p32.mats.numel())
            timing[f"k5{tag}_{n}_ms"] = cuda_ms(
                lambda: fr.merged_cuda(p32, c, o, d, emb, z, field, z_f, t), 10)
            timing[f"k5{tag}_{n}_bound_ms"], _ = tf32x3_bound(
                c, n, sf, 4 * n * (3 + 3 + e + 5 * sc + sf + int(c.use_time))
                + 4 * n * (3 + 1 + 1 + 2 * (sc + sf)) + 12 * p32.mats.numel())
            del o, d, emb, z, cot, g_field, target, field, z_f, c6, calls
        # K1 and K8 at the rows of the batch's coarse and fine evaluations
        # (the f32 per-sample step's), K9 at the batch (the f32 one-kernel
        # step's)
        n = c.batch_size
        e, nt = c.appearance_dim, int(c.use_time)
        wg = 4 * (3 * p32.mats.numel() + 2 * p32.vecs.numel())
        for rows in ((n * sc, n * (sc + sf)) if tag == "" else (n * (sc + sf),)):
            x, dr, er = sample_rows(n, c, 797, device, rows // n)
            g = torch.Generator(device=device).manual_seed(798)
            g_rgb = torch.randn(rows, 3, generator=g, device=device)
            g_sig = torch.randn(rows, 1, generator=g, device=device)
            t = torch.rand(rows, 1, generator=g, device=device) if c.use_time else None
            timing[f"k1{tag}_{rows}_ms"] = cuda_ms(
                lambda: fm.fused_fwd_cuda(p32, c, x, dr, er, t), 10)
            # 3xTF32 (csrc/field_f32_sm90.cuh): the packed weights and their
            # split halves read, 12 bytes a weight, as K5's; FFMA's bound beside
            k1_bytes = (4 * rows * (3 + 3 + e + nt) + 4 * rows * 4 + 12 * p32.mats.numel()
                        + 4 * p32.vecs.numel())
            timing[f"k1{tag}_{rows}_bound_ms"], bound_by["k1" + tag] = tf32x3_bound(
                c, rows, 1, k1_bytes)
            timing[f"k1{tag}_{rows}_ffma_bound_ms"] = bound(c, rows, 1, k1_bytes)[0]
            timing[f"k8{tag}_{rows}_ms"] = cuda_ms(
                lambda: fm.fused_bwd_cuda(p32, c, x, dr, er, g_rgb, g_sig, t), 10)
            timing[f"k8{tag}_{rows}_plain_ms"] = cuda_ms(
                lambda: fm.fused_bwd_plain(p32, c, x, dr, er, g_rgb, g_sig, t), 3)
            k8_bytes = 4 * rows * (3 + 3 + e + nt + 3 + 1) + 4 * rows * e + wg
            timing[f"k8{tag}_{rows}_bound_ms"], bound_by["k8" + tag] = tf32x3_bwd_bound(
                c, rows, 1, k8_bytes, gate_pass=True)
            timing[f"k8{tag}_{rows}_ffma_bound_ms"] = bound(c, rows, 1, k8_bytes,
                                                            backward=True)[0]
            del x, dr, er, g_rgb, g_sig
        o, d, emb, z = make_rays(n, c, seed=799, device=device)
        g = torch.Generator(device=device).manual_seed(800)
        u = importance_uniforms((n,), sf, True, rand=g, device=device)
        target = torch.rand(n, 3, generator=g, device=device)
        t = torch.rand(n, 1, generator=g, device=device) if c.use_time else None
        timing[f"k9{tag}_{n}_ms"] = cuda_ms(
            lambda: fr.hier_onepass_cuda(p32, c, o, d, emb, z, u, target, t), 10)
        timing[f"k9{tag}_{n}_plain_ms"] = cuda_ms(
            lambda: fr.hier_onepass_plain(p32, c, o, d, emb, z, u, target, t), 3)
        k9_bytes = 4 * n * (3 + 3 + e + sc + sf + 3 + nt) + 4 * n * e + 8 + wg
        timing[f"k9{tag}_{n}_bound_ms"], bound_by["k9" + tag] = tf32x3_bwd_bound(
            c, n, sc + sf, k9_bytes, gate_pass=True)
        timing[f"k9{tag}_{n}_ffma_bound_ms"] = bound(c, n, sc + sf, k9_bytes, backward=True)[0]
        del o, d, emb, z, u, target
    worst = {f"{k}{tag}": max(v for key, v in errs.items()
                              if key.startswith(f"{k}f32{tag}@") and not key.endswith(".zero"))
             for k in ("K3", "K4", "K6", "K7", "K8", "K9") for tag in ("", "t")}
    emit({"phase": "f32_bwd", "rays": [37, cfg.batch_size, 4093], "max_abs_err": errs,
          "grad_rel": grad_rel, "bf16_kernel_err_vs_f32_plain": bf16,
          "bf16_over_f32_error_ratio": ratios, "worst_ratio": min(ratios.values()),
          "tolerance": tol, "least_ratio": F32_GAIN, "deterministic": same,
          "cpu_referee": referee, "timing": timing, "bound_by": bound_by,
          "failures": failures})
    if failures:
        raise AssertionError("f32 backward kernel disagrees with its plain version: "
                             + "; ".join(failures))
    return worst, min(ratios.values()), timing, bound_by


def phase_f32_train(cfg, model, out_dir, device):
    """f32 training on the card (use_bf16=False; no CLI flag reaches it in
    either package, the library entry points do): one step of 64 + 64,
    coarse-only, white background, use_time, per sample (two f32 K1 and two
    f32 K8) and in one kernel (one f32 K9) at B = 1024 through the kernels
    against the same step through their plain versions (step_runs: exactly
    the f32 launches and none of a bf16 kernel; the loss within
    PLAIN_TOL_F32_BWD's loss, the gradients within its step_grad_rel, the
    parameters after one Adam step);
    10 chained f32 steps against 10 eager ones bit for bit on 64 + 64,
    coarse-only, white background, per sample and in one kernel; train()
    for 100 f32 steps of 64 + 64 and 100 per sample on the procedural
    scene (phase_train: one f32 K2, K4, K3 a step, or two f32 K1 and two
    f32 K8; finite losses, a rising PSNR, a checkpoint); then evaluate()
    with the embedding fit on the 64 + 64 checkpoint (100x100 views, 2
    views; 50 fit steps a view, each an f32 K2, K5, K6 and K3), exactly
    those launches, each view within EVAL_TOL of the same call on the plain
    route (use_kernels=False) on the card.
    Returns the launches of each run."""
    import numpy as np
    import torch

    from danerf_tpu_torch.config import NeRFConfig
    from danerf_tpu_torch.data.dataset import load_dataset
    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.train.evaluate import evaluate
    from danerf_tpu_torch.utils.checkpoint import load_model

    tol = fr.PLAIN_TOL_F32_BWD
    failures = []
    steps, _, _ = step_runs(cfg, model, device, F32_PATHS, lambda c: tol["loss"],
                            tol["step_grad_rel"], failures)
    chained = {}
    for path in ("hier_f32", "coarse_f32", "white_f32", "per_sample_f32", "hier_onepass_f32"):
        over, per_step = F32_PATHS[path]
        pcfg = cfg.replace(**over)
        chained[path] = chained_vs_eager(pcfg, timing_scene(pcfg), device, 10, 1, per_step)
        r = chained[path]
        if r["differences"] or r["launches_wrong"] or not r["finite"]:
            failures.append(f"chained {path}: {r['differences']} {r['launches_wrong']} "
                            f"finite={r['finite']}")
    if failures:
        emit({"phase": "f32_train", "steps": steps, "chained": chained, "failures": failures})
        raise AssertionError("f32 training disagrees: " + "; ".join(failures))
    train_launches = phase_train(out_dir, "hier_f32", 100, render=False)
    per_sample_launches = phase_train(out_dir, "per_sample_f32", 100, render=False)

    c32 = NeRFConfig(dataset_path=scene_path(out_dir), use_bf16=False)
    ds = load_dataset(c32, "val")
    m, _, _, c32 = load_model(os.path.join(out_dir, "train_hier_f32", "checkpoint_final.pt"),
                              c32, "cuda")
    m.requires_grad_(False)
    evals = {}
    for route, c in (("kernel", c32), ("plain", c32.replace(use_kernels=False))):
        fr.reset_launch_counts()
        t0 = time.perf_counter()
        res = evaluate(m, c, ds, max_views=EVAL_VIEWS, optimize_embeddings=True,
                       opt_steps=EVAL_OPT_STEPS, device="cuda")
        torch.cuda.synchronize()
        evals[route] = {"seconds": time.perf_counter() - t0, "launches": dict(fr.LAUNCHES),
                        "psnr": [v["psnr"] for v in res["per_view"]],
                        "ssim": [v["ssim"] for v in res["per_view"]]}
    fit = {"march_f32": 1, "merged_f32": 1, "merged_bwd_f32": 1, "march_bwd_f32": 1}
    want = {k: EVAL_VIEWS * (EVAL_OPT_STEPS * fit.get(k, 0)
                             + (1 if k in ("march_f32", "merged_f32") else 0))
            for k in fr.LAUNCHES}
    if evals["kernel"]["launches"] != want:
        failures.append(f"f32 evaluate launches {evals['kernel']['launches']}, expected {want}")
    if any(evals["plain"]["launches"].values()):
        failures.append(f"f32 evaluate on the plain route launched {evals['plain']['launches']}")
    delta = {"psnr_db": max(abs(a - b) for a, b in zip(evals["kernel"]["psnr"],
                                                        evals["plain"]["psnr"])),
             "ssim": max(abs(a - b) for a, b in zip(evals["kernel"]["ssim"],
                                                     evals["plain"]["ssim"]))}
    if not (all(np.isfinite(evals["kernel"]["psnr"]))
            and all(delta[k] <= EVAL_TOL[k] for k in delta)):
        failures.append(f"f32 evaluate: kernel {evals['kernel']}, plain {evals['plain']}")
    emit({"phase": "f32_train", "rays": cfg.batch_size, "steps": steps, "chained": chained,
          "train_launches": train_launches, "evaluate": evals, "evaluate_max_delta": delta,
          "tolerance": {"loss": tol["loss"], "step_grad_rel": tol["step_grad_rel"],
                        "eval": EVAL_TOL},
          "failures": failures})
    if failures:
        raise AssertionError("f32 training disagrees: " + "; ".join(failures))
    return {"train": train_launches, "per_sample_train": per_sample_launches,
            "eval": evals["kernel"]["launches"],
            **{f"{p}_chained": launches_of(F32_PATHS[f"{p}_f32"][1], 10)
               for p in ("coarse", "per_sample", "hier_onepass")},
            "time_step": steps["time_f32"]["launches"]}


def phase_f32_step_timing(cfg, device, f32_timing, tt):
    """The f32 64 + 64, coarse-only, white-background, per-sample and
    one-kernel steps (use_bf16=False) at B = 1024 beside the bf16 64 + 64
    step, each through step_timing (eager and chained, 10 steps a replay,
    each with its torch.profiler windows: device busy, idle share, and
    kernel_part's breakdown: each f32 step's 3xTF32 tiles, t32_tile (the
    64 + 64 step's K3 and K4, the coarse-only step's K7, the white step's
    K6 and K3, the per-sample step's K8, the one-kernel step's K9), apart
    from their gate passes, t32_gate_pass, their wgmma dW passes,
    t32_dw_pass, and their narrow jobs and row sums, bwd32_dw_pass; the
    per-sample step's two f32 K1, k1_f32), with the f32 kernels' times and bound from phase_f32_bwd (K2, K3, K4, K5,
    K6, K7 at the batch; K1 and K8 at its 65,536 and 131,072 rows; K9 at
    the batch) and the bf16 ones' from phase_train_timing."""
    n = cfg.batch_size
    rows = (n * cfg.num_samples, n * (cfg.num_samples + cfg.num_importance))
    f32_kernels = {"hier_f32": ("k2_1024", "k3_1024", "k4_1024"),
                   "coarse_f32": ("k7_1024",),
                   "white_f32": ("k2_1024", "k5_1024", "k6_1024", "k3_1024"),
                   "per_sample_f32": tuple(f"k{k}_{r}" for k in (1, 8) for r in rows),
                   "hier_onepass_f32": (f"k9_{n}",)}
    steps = {path: step_timing(cfg.replace(**F32_PATHS[path][0]), device, f32_timing, kerns,
                               profile=True) for path, kerns in f32_kernels.items()}
    steps["hier"] = step_timing(cfg, device, tt, ("k2_batch", "k3_batch", "k4_batch"),
                                profile=True)
    keys = ("chained_ms_per_step_median", "chained_profile_device_busy_ms_per_step",
            "chained_profile_idle_share", "step_ms_median", "step_bound_ms")
    split = {}
    for path in f32_kernels:
        parts = steps[path]["chained_profile_breakdown_ms_per_step"]
        split[path] = {"gate_pass_ms": parts.get("t32_gate_pass", 0.0),
                       "tile_ms": parts.get("t32_tile", 0.0),
                       "dw_ms": parts.get("t32_dw_pass", 0.0) + parts.get("bwd32_dw_pass", 0.0),
                       "k1_ms": parts.get("k1_f32", 0.0), "rest_ms": parts.get("rest", 0.0)}
    emit({"phase": "f32_step_timing", "rays": cfg.batch_size, "steps": steps,
          "f32_chained_split_ms_per_step": split,
          "f32_over_bf16": {k: steps["hier_f32"][k] / steps["hier"][k] for k in keys
                            if k != "chained_profile_idle_share"}})


def native_tools():
    """What the native tool's build needs, as found on this host: cmake, a
    build tool, a C++ compiler, libpng and libjpeg (header and library)."""
    import ctypes.util
    import shutil

    return {"cmake": shutil.which("cmake"),
            "build_tool": shutil.which("ninja") or shutil.which("make"),
            "c++": shutil.which("c++") or shutil.which("g++") or shutil.which("clang++"),
            "libpng": (ctypes.util.find_library("png") if os.path.exists("/usr/include/png.h")
                       else None),
            "libjpeg": (ctypes.util.find_library("jpeg")
                        if os.path.exists("/usr/include/jpeglib.h") else None)}


def phase_native(cfg, model, out_dir, device, side=200):
    """The native shader bridge (danerf_tpu_torch/native/bridge.py) on the
    card's host: whether the tool builds here (ensure_built into
    build/shader_processor/) and, if not, why (the tools and libraries
    found, the configure's last words); a failed build with cmake, a build
    tool, a compiler and both libraries present fails the phase.  If it
    builds, the three default shaders run on a 200x200 medium frame of
    K2/K5 and its depth (passthrough returns the frame).  Either way the fx
    fallback runs on the card, each default shader on that frame held to
    the same fallback on the CPU within fx.effects.levels_apart."""
    import numpy as np
    import torch

    from danerf_tpu_torch.fx.effects import levels_apart
    from danerf_tpu_torch.native import bridge as nb
    from danerf_tpu_torch.render.renderer import render_frame
    from danerf_tpu_torch.viz.paths import camera_path

    tools = native_tools()
    failures = []
    t0 = time.perf_counter()
    binary = nb.ensure_built(os.path.join(nb.BUILD_DIR, "shader_processor"))
    report = {"phase": "native", "tools": tools, "built": binary is not None,
              "build_s": time.perf_counter() - t0}
    report["missing"] = [k for k, v in tools.items() if v is None]
    if binary is not None:
        # a binary built elsewhere may not load here (its libraries missing)
        probe = subprocess.run([binary, "--list-effects"], capture_output=True, text=True,
                               timeout=60)
        report["runs"] = probe.returncode == 0
        if not report["runs"]:
            report["run_error"] = (probe.stdout + probe.stderr)[-1500:]
            binary = None
    elif tools["cmake"]:
        probe = subprocess.run(["cmake", "-S", nb._NATIVE_DIR, "-B",
                                os.path.join(out_dir, "native_probe")],
                               capture_output=True, text=True, timeout=300)
        report["configure_exit"] = probe.returncode
        report["configure_tail"] = (probe.stdout + probe.stderr)[-1500:]
    if binary is None and not report["missing"]:
        failures.append("cmake, a build tool, a compiler, libpng and libjpeg are present, "
                        "but the native tool did not build and run")

    c2w = camera_path("circle", 2, cfg.scene)[0]
    rgb, depth, _ = render_frame(model, cfg, c2w, side, side, 0.5 * side / math.tan(0.5 * 0.6911),
                                 perturb=False, device=device)
    img = (rgb.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
    depth = depth.cpu().numpy()
    d01 = (depth - depth.min()) / (depth.max() - depth.min() + 1e-6)
    shaders = {"default.frag": "Original", "toon.frag": "Toon Shader", "fog.frag": "Fog"}
    if binary is not None:
        import warnings

        bridge = nb.ShaderBridge(binary_path=binary, shader_dir=os.path.join(out_dir, "shaders"),
                                 auto_build=False, device=device)
        native = {}
        for name in shaders:
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = bridge.apply_shader(img, depth, name)
            if caught:   # the bridge fell back: the tool did not run
                failures.append(f"native {name}: {caught[0].message}")
            native[name] = {"ms": (time.perf_counter() - t0) * 1e3, "shape": list(out.shape),
                            "levels_from_input": int(np.abs(out[..., :3].astype(int)
                                                            - img).max())}
            if out.dtype != np.uint8 or out.shape[:2] != img.shape[:2]:
                failures.append(f"native {name}: {out.dtype} {out.shape}")
        if native["default.frag"]["levels_from_input"] != 0:
            failures.append("native passthrough changed the frame")
        report["native"] = native
    fallback = {}
    bridges = [nb.ShaderBridge(binary_path=os.path.join(out_dir, "no_binary"),
                               shader_dir=os.path.join(out_dir, f"shaders_fallback{i}"),
                               auto_build=False, device=dev) for i, dev in enumerate((device,
                                                                                      "cpu"))]
    for name, fx in shaders.items():
        got = bridges[0].apply_shader(img, d01, name)
        want = bridges[1].apply_shader(img, d01, name)
        fallback[name] = levels_apart(fx, got, want)
        if not fallback[name]["ok"]:
            failures.append(f"fallback {name} on the card vs the CPU: {fallback[name]}")
    report.update({"fallback_cuda_vs_cpu": fallback, "failures": failures})
    emit(report)
    if failures:
        raise AssertionError("native: " + "; ".join(failures))
    return report


def phase_render_subset(cfg, model, out_dir, world=4, data=2, side=200, device="cuda"):
    """`cli.main render --mesh_data 2` on ``world`` NCCL ranks, one card
    each: the mesh lies over the first 2 ranks (the JAX CLI renders on the
    first D devices), the others take no share and write nothing.  Held to
    the same command in this process on one card: the rgb PNGs within 1
    level, the raw depth within TWO_RANK_TOL, and the viridis depth PNGs
    within one step of the colormap (a depth that differs by TWO_RANK_TOL
    can cross into the next of its 256 entries); only rank 0's directory
    exists."""
    import numpy as np
    import torch

    from danerf_tpu_torch.cli.main import main as cli_main
    from danerf_tpu_torch.data.png import read_png
    from danerf_tpu_torch.viz.depth import _VIRIDIS

    ckpt = os.path.join(out_dir, "subset_model.pt")
    table = torch.randn(4, cfg.appearance_dim, generator=torch.Generator().manual_seed(3))
    torch.save({"model_state_dict": {k: v.cpu() for k, v in model.state_dict().items()},
                "appearance_embeddings": table, "iteration": 0}, ckpt)
    argv = ["render", "--checkpoint", ckpt, "--frames", "2", "--width", str(side), "--height",
            str(side), "--quality", "medium", "--save_depth", "--device", str(device), "--seed",
            "0"]
    dirs = [os.path.join(out_dir, f"subset_rank{r}") for r in range(world)]
    port = free_port()
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", "danerf_tpu_torch.cli.main", *argv,
                               "--output_dir", dirs[r], "--coordinator_address",
                               f"127.0.0.1:{port}", "--num_processes", str(world),
                               "--process_id", str(r), "--mesh_data", str(data)],
                              cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    children_s = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"render --mesh_data {data}: rank {r} exited "
                                 f"{p.returncode}:\n{log[-4000:]}")
    one = os.path.join(out_dir, "subset_one")
    cli_main(argv + ["--output_dir", one])
    failures = [f"rank {r} wrote {dirs[r]}" for r in range(1, world) if os.path.exists(dirs[r])]
    names = sorted(os.listdir(one))
    if sorted(os.listdir(dirs[0])) != names:
        failures.append(f"rank 0 wrote {sorted(os.listdir(dirs[0]))}, one process {names}")
    levels, depth_err = {"rgb": 0, "depth": 0}, 0.0
    for i in range(2):
        for kind in levels:
            name = f"{kind}_{i:03d}.png"
            levels[kind] = max(levels[kind], int(np.abs(
                read_png(os.path.join(dirs[0], name)).astype(int)
                - read_png(os.path.join(one, name)).astype(int)).max()))
        depth_err = max(depth_err, float(np.abs(
            np.load(os.path.join(dirs[0], "raw", f"depth_{i:03d}.npy"))
            - np.load(os.path.join(one, "raw", f"depth_{i:03d}.npy"))).max()))
    colormap_step = int(np.abs(np.diff((_VIRIDIS * 255).astype(np.uint8).astype(int),
                                       axis=0)).max())
    if levels["rgb"] > 1:
        failures.append(f"rgb PNGs {levels['rgb']} levels from one process's")
    if levels["depth"] > colormap_step:
        failures.append(f"depth PNGs {levels['depth']} levels from one process's, more than "
                        f"one colormap step ({colormap_step})")
    if not depth_err <= TWO_RANK_TOL["frame_depth"]:
        failures.append(f"raw depth {depth_err} > {TWO_RANK_TOL['frame_depth']}")
    emit({"phase": "render_subset", "world_size": world, "mesh_data": data,
          "device": str(device), "png_max_levels": levels, "colormap_step": colormap_step,
          "depth_max_abs": depth_err, "depth_limit": TWO_RANK_TOL["frame_depth"],
          "children_s_incl_start": children_s, "failures": failures})
    if failures:
        raise AssertionError("render --mesh_data below the ranks: " + "; ".join(failures))


@contextlib.contextmanager
def plain_route():
    """Route the autograd Functions through the plain versions on the card
    (for the step-parity phase only; the port itself never does this)."""
    from danerf_tpu_torch.kernels import fused_mlp as fm
    from danerf_tpu_torch.kernels import fused_render as fr

    names = ("_march_fwd", "_march_bwd", "_march_train", "_merged_fwd", "_merged_bwd",
             "_merged_train", "_hier_onepass")
    saved = {n: getattr(fr, n) for n in names}
    saved_fm = {n: getattr(fm, n) for n in ("_field_fwd", "_field_bwd")}
    fm._field_fwd = lambda pk, c, x, d, e, t: fm.fused_fwd_plain(pk, c, x, d, e, t)
    fm._field_bwd = lambda pk, c, x, d, e, t, gr, gs: fm.fused_bwd_plain(pk, c, x, d, e, gr, gs,
                                                                         t)
    fr._march_fwd = lambda pk, c, o, d, e, z, t, wf: fr.march_plain(pk, c, o, d, e, z, t, wf)
    fr._march_bwd = lambda pk, c, o, d, e, z, t, cot: fr.march_bwd_plain(pk, c, o, d, e, z,
                                                                         *cot, t=t)
    fr._march_train = lambda pk, c, *a: fr.march_train_plain(pk, c, *a)
    fr._merged_fwd = lambda pk, c, *a: fr.merged_plain(pk, c, *a)
    fr._merged_bwd = lambda pk, c, o, d, e, zc, fc, zf, t, cot: fr.merged_bwd_plain(
        pk, c, o, d, e, zc, fc, zf, *cot, t=t)
    fr._merged_train = lambda pk, c, *a: fr.merged_train_plain(pk, c, *a)
    fr._hier_onepass = lambda pk, c, *a: fr.hier_onepass_plain(pk, c, *a)
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(fr, n, f)
        for n, f in saved_fm.items():
            setattr(fm, n, f)


# The training paths: config changes, and the launches of one step.
PATHS = {
    "hier": ({}, {"march": 1, "march_bwd": 1, "merged_train": 1}),
    "coarse": ({"num_importance": 0}, {"march_train": 1}),
    "white": ({"white_background": True},
              {"march": 1, "merged": 1, "merged_bwd": 1, "march_bwd": 1}),
    "per_sample": ({"use_fused_train": False}, {"mlp_fwd": 2, "mlp_bwd": 2}),
    "time": ({"use_time": True}, {"march": 1, "merged": 1, "merged_bwd": 1, "march_bwd": 1}),
    "hier_onepass": ({"use_hier_onepass": True}, {"hier_onepass": 1}),
}


# The f32 configuration (use_bf16=False) of six of them: config changes and
# the launches of one step (the f32 variants of K2, K5, K3, K4, K6, K7; K1
# and K8; K9).
F32_PATHS = {
    "hier_f32": ({"use_bf16": False}, {"march_f32": 1, "march_bwd_f32": 1,
                                        "merged_train_f32": 1}),
    "coarse_f32": ({"use_bf16": False, "num_importance": 0}, {"march_train_f32": 1}),
    "white_f32": ({"use_bf16": False, "white_background": True},
                  {"march_f32": 1, "merged_f32": 1, "merged_bwd_f32": 1, "march_bwd_f32": 1}),
    "time_f32": ({"use_bf16": False, "use_time": True},
                 {"march_f32": 1, "merged_f32": 1, "merged_bwd_f32": 1, "march_bwd_f32": 1}),
    "per_sample_f32": ({"use_bf16": False, "use_fused_train": False},
                       {"mlp_fwd_f32": 2, "mlp_bwd_f32": 2}),
    "hier_onepass_f32": ({"use_bf16": False, "use_hier_onepass": True},
                         {"hier_onepass_f32": 1}),
}
ALL_PATHS = {**PATHS, **F32_PATHS}


def launches_of(per_step, steps=1):
    from danerf_tpu_torch.kernels import fused_render as fr

    return {k: per_step.get(k, 0) * steps for k in fr.LAUNCHES}


def step_runs(cfg, model, device, paths, loss_tol, grad_tol, failures):
    """One training step at B = 1024 on each of ``paths`` (name: (config
    changes, launches a step)), each built twice from the same module,
    table, batch and draws: through the kernels and through their plain
    versions; launches, loss (``loss_tol(cfg)``), every gradient
    (``grad_tol``) and the parameters after one Adam step compared (the
    use_time paths on a model of their own and the batch's per-ray times).
    Returns the report and each path's kernel run."""
    import copy

    import torch

    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.train.trainer import compute_loss_and_grads, make_optimizer

    n, n_img = cfg.batch_size, 4
    o, d, _, _ = make_rays(n, cfg, seed=21, device=device)
    g = torch.Generator(device=device).manual_seed(22)
    batch = {"rays_o": o, "rays_d": d, "rgb": torch.rand(n, 3, generator=g, device=device),
             "img_idx": torch.randint(0, n_img, (n,), generator=g, device=device)}
    draws = (torch.rand(n, cfg.num_samples, generator=g, device=device),
             torch.rand(n, cfg.num_importance, generator=g, device=device))
    table0 = torch.randn(n_img, cfg.appearance_dim, generator=g, device=device)
    times = torch.rand(n, 1, generator=g, device=device)
    names = [nm for nm, _ in model.named_parameters()] + ["appearance"]
    report, kernel_runs = {}, {}
    for path, (over, per_step) in paths.items():
        pcfg = cfg.replace(**over)
        pdraws = draws if pcfg.num_importance > 0 else draws[:1]
        base, pbatch = model, batch
        if pcfg.use_time:
            base, pbatch = make_model(pcfg, seed=0, device=device), {**batch, "t": times}
        runs = {}
        for route in ("kernel", "plain"):
            m = copy.deepcopy(base).requires_grad_(True)
            table = torch.nn.Parameter(table0.clone())
            params = list(m.parameters()) + [table]
            opt, sched = make_optimizer(pcfg, params)
            before = [p.detach().clone() for p in params]
            fr.reset_launch_counts()
            with plain_route() if route == "plain" else contextlib.nullcontext():
                opt.zero_grad(set_to_none=True)
                loss, aux = compute_loss_and_grads(m, table, pcfg, pbatch, draws=pdraws)
                grads = [p.grad.detach().clone() for p in params]
                opt.step()
                sched.step()
            torch.cuda.synchronize()
            runs[route] = {"loss": float(loss), **{k: float(v) for k, v in aux.items()},
                           "grads": grads, "delta": [p.detach() - b for p, b in zip(params, before)],
                           "launches": dict(fr.LAUNCHES)}
        k, p = runs["kernel"], runs["plain"]
        kernel_runs[path] = k
        if k["launches"] != launches_of(per_step):
            failures.append(f"{path}: kernel step launches {k['launches']}")
        if any(p["launches"].values()):
            failures.append(f"{path}: plain step launched kernels {p['launches']}")
        report[path] = {**step_diff(path, k, p, names, pcfg, loss_tol(pcfg), failures,
                                    grad_tol),
                        "launches": k["launches"]}
    return report, kernel_runs, names


def phase_step(cfg, model, device):
    """One training step at B = 1024 on each training path (64 + 64; coarse
    only; 64 + 64 on a white background; 64 + 64 per sample, K1/K8; 64 + 64
    with use_time, the has_time K2/K5/K6/K3 on a model of its own and the
    batch's per-ray times; 64 + 64 in one kernel, use_hier_onepass, K9),
    through the kernels and through their plain versions (step_runs).  The
    K9 step is also held against the 64 + 64 step through K2, K4 and K3 on
    the same draws."""
    from danerf_tpu_torch.kernels import fused_render as fr

    tol = fr.PLAIN_TOL
    failures = []
    report, kernel_runs, names = step_runs(
        cfg, model, device, PATHS,
        lambda c: tol["loss_k9" if c.use_hier_onepass else "loss"], tol["grad_rel"], failures)
    # one kernel (K9) against three (K2, K4, K3), the same step and draws
    report["hier_onepass"]["vs_two_kernel_step"] = step_diff(
        "hier_onepass vs hier", kernel_runs["hier_onepass"], kernel_runs["hier"], names, cfg,
        tol["loss_k9"], failures)
    emit({"phase": "step", "rays": cfg.batch_size, **report, "failures": failures})
    if failures:
        raise AssertionError("kernel step disagrees with the plain step: " + "; ".join(failures))


def step_diff(what, k, p, names, cfg, loss_tol, failures, grad_tol=None):
    """Two runs of one step (loss, aux, gradients, parameter updates), the
    loss held to ``loss_tol``, the gradients to ``grad_tol`` (PLAIN_TOL's
    grad_rel by default); what is over goes to ``failures``."""
    from danerf_tpu_torch.kernels import fused_render as fr

    grad_tol = fr.PLAIN_TOL["grad_rel"] if grad_tol is None else grad_tol
    grad_rel = {nm: float((a - b).norm() / b.norm()) for nm, a, b in
                zip(names, k["grads"], p["grads"]) if float(b.norm()) > 0}
    upd_rel = {nm: float((a - b).norm() / b.norm()) for nm, a, b in
               zip(names, k["delta"], p["delta"]) if float(b.norm()) > 0}
    param_abs = max(max_err(a, b) for a, b in zip(k["delta"], p["delta"]))
    loss_err = abs(k["loss"] - p["loss"])
    if not math.isfinite(loss_err) or loss_err > loss_tol:
        failures.append(f"{what}: loss: {loss_err} > {loss_tol}")
    worst = max(grad_rel, key=grad_rel.get)
    if not math.isfinite(grad_rel[worst]) or grad_rel[worst] > grad_tol:
        failures.append(f"{what}: grad {worst}: {grad_rel[worst]} > {grad_tol}")
    # Adam's first step moves each element by at most lr, so the two runs'
    # parameters differ by at most 2 lr, reached where a gradient element
    # near 0 changes sign between them
    if not math.isfinite(param_abs) or param_abs > 2 * cfg.learning_rate * (1 + 1e-3):
        failures.append(f"{what}: parameters after one Adam step: {param_abs}")
    return {"loss": [k["loss"], p["loss"]], "loss_err": loss_err,
            **{a: [k[a], p[a]] for a in ("mse", "coarse_mse") if a in k},
            "grad_rel_worst": {"param": worst, "err": grad_rel[worst]},
            "update_rel_worst": max(upd_rel.values()), "param_max_abs_diff": param_abs}


def timing_scene(cfg):
    """The training phases' pool: 20 random 100x100 images on a circle of
    cameras (capture times 0..1 under use_time)."""
    import numpy as np

    from danerf_tpu_torch.data.dataset import RayDataset
    from danerf_tpu_torch.viz.paths import camera_path

    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, size=(20, 100, 100, 3), dtype=np.uint8)
    c2ws = np.stack([np.asarray(c, np.float32) for c in camera_path("circle", 20, cfg.scene)])
    return RayDataset(imgs, imgs[..., 0], c2ws, 138.9, cfg.near, cfg.far,
                      times=np.linspace(0.0, 1.0, 20, dtype=np.float32) if cfg.use_time else None)


def train_state(cfg, ds, device, seed=0):
    """A fresh training state from ``seed``: module, table, Adam, StepLR,
    generator and the pool."""
    import torch

    from danerf_tpu_torch.train.trainer import init_model, make_optimizer

    model, table = init_model(cfg, ds.n_images, seed, device)
    opt, sched = make_optimizer(cfg, list(model.parameters()) + [table])
    gen = torch.Generator(device=device).manual_seed(seed)
    return model, table, opt, sched, gen, ds.device_arrays(cfg.white_background, device=device)


def state_diff(a, b):
    """What differs, bit for bit, between two training states (module,
    table, Adam's moments and step counts, the rate, StepLR, and the
    generators' next draw, which this consumes)."""
    import torch

    (ma, ta, oa, sa, ga), (mb, tb, ob, sb, gb) = a, b
    diff = [n for (n, p), q in zip(ma.named_parameters(), mb.parameters())
            if not torch.equal(p, q)]
    if not torch.equal(ta, tb):
        diff.append("appearance")
    pa, pb = list(ma.parameters()) + [ta], list(mb.parameters()) + [tb]
    for i, (p, q) in enumerate(zip(pa, pb)):
        for k in ("step", "exp_avg", "exp_avg_sq"):
            if not torch.equal(oa.state[p][k], ob.state[q][k]):
                diff.append(f"adam[{i}].{k}")
    if not torch.equal(oa.param_groups[0]["lr"], ob.param_groups[0]["lr"]):
        diff.append("lr")
    if sa.last_epoch != sb.last_epoch:
        diff.append("steplr")
    if not torch.equal(torch.rand(16, generator=ga, device=ga.device),
                       torch.rand(16, generator=gb, device=gb.device)):
        diff.append("generator next draw")
    return diff


def chained_vs_eager(cfg, ds, device, k, calls, per_step):
    """From one seeded state, 5 warm-up steps of 64 rays (train's), then
    ``calls`` calls of ``k`` steps as one graph replay (make_train_step,
    steps_per_call=k) against calls * k eager steps (steps_per_call=1):
    returns the differences (state_diff, then each step's metrics), the
    launches of both runs against the path's, and the graph's pool."""
    import torch

    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.train.trainer import make_train_step

    runs = {}
    for mode, per_call in (("chained", k), ("eager", 1)):
        model, table, opt, sched, gen, pool = train_state(cfg, ds, device)
        warm = make_train_step(model, table, opt, sched, pool, cfg, ds.height, ds.width,
                               ds.focal, 64, gen, 1)
        for _ in range(5):
            warm()
        step = make_train_step(model, table, opt, sched, pool, cfg, ds.height, ds.width,
                               ds.focal, None, gen, per_call)
        fr.reset_launch_counts()
        out = [step() for _ in range(calls * k // per_call)]
        torch.cuda.synchronize()
        runs[mode] = {"state": (model, table, opt, sched, gen), "launches": dict(fr.LAUNCHES),
                      "metrics": {n: torch.cat([m[n] for m in out]) for n in out[0]},
                      "pool_bytes": getattr(step, "pool_bytes", None)}
    c, e = runs["chained"], runs["eager"]
    diff = state_diff(c["state"], e["state"])
    diff += [f"metric {n}" for n in e["metrics"]
             if not torch.equal(c["metrics"][n], e["metrics"][n])]
    want = launches_of(per_step, calls * k)
    bad_launches = {m: r["launches"] for m, r in runs.items() if r["launches"] != want}
    finite = all(bool(torch.isfinite(v).all()) for v in c["metrics"].values())
    return {"steps": calls * k, "differences": diff, "launches_wrong": bad_launches,
            "finite": finite, "graph_pool_bytes": c["pool_bytes"],
            "loss_first_last": [float(c["metrics"]["loss"][0]),
                                float(c["metrics"]["loss"][-1])]}


def resume_vs_straight(cfg, ds, device, out_dir):
    """train() for 40 steps with a checkpoint every 20 (10 steps a call)
    against 20 steps, a resume, and 20 more: the final checkpoints bit for
    bit (module, table, Adam, StepLR, the generator's state) and the rows of
    steps 21-40."""
    import shutil

    import torch

    from danerf_tpu_torch.train.trainer import train

    dirs = {m: os.path.join(out_dir, f"chained_resume_{m}") for m in ("straight", "split")}
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)

    def run(d, n, resume=False):
        train(cfg, ds, save_dir=d, num_iterations=n, checkpoint_every=20, device=device,
              progress=False, resume=resume, log_path=os.path.join(d, "metrics.jsonl"))

    run(dirs["straight"], 40)
    run(dirs["split"], 20)
    run(dirs["split"], 40, resume=True)
    a, b = (torch.load(os.path.join(d, "checkpoint_final.pt"), map_location="cpu",
                       weights_only=False) for d in dirs.values())
    diff = [k for k, v in a["model_state_dict"].items()
            if not torch.equal(v, b["model_state_dict"][k])]
    for key in ("appearance_embeddings", "generator_state"):
        if not torch.equal(a[key], b[key]):
            diff.append(key)
    sa, sb = a["optimizer_state_dict"], b["optimizer_state_dict"]
    diff += [f"adam[{i}].{k}" for i, st in sa["state"].items() for k, v in st.items()
             if not torch.equal(v, sb["state"][i][k])]
    for key in ("param_groups",):
        if sa[key] != sb[key]:
            diff.append(f"adam {key}")
    if a["scheduler_state_dict"] != b["scheduler_state_dict"]:
        diff.append("steplr")

    def rows(d):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            return [{k: v for k, v in json.loads(line).items() if k != "t"} for line in f]

    ra, rb = rows(dirs["straight"]), rows(dirs["split"])
    if [r["step"] for r in rb] != list(range(1, 41)) or ra[20:] != rb[20:]:
        diff.append("rows 21-40")
    return {"iteration": [a["iteration"], b["iteration"]], "differences": diff}


def phase_chained(cfg, device, out_dir, k=10):
    """Several steps a call on the card: for each training path at B = 1024,
    from one seeded state, ``k`` steps as one replay of a captured CUDA
    graph against ``k`` eager steps, bit for bit (parameters and table,
    Adam's moments and step counts, the rate, StepLR, each step's metrics,
    the generator's next draw), with exactly the path's launches per step
    on both; on the 64 + 64 path also 3 replays against 30 eager steps with
    scheduler_step_size=7 (the rate changes inside a replay), and train()
    for 40 steps (a checkpoint every 20) against 20, a resume and 20 more."""
    report, failures = {}, []
    for path, (over, per_step) in PATHS.items():
        pcfg = cfg.replace(**over)
        report[path] = chained_vs_eager(pcfg, timing_scene(pcfg), device, k, 1, per_step)
    report["rate_boundary"] = chained_vs_eager(cfg.replace(scheduler_step_size=7),
                                               timing_scene(cfg), device, k, 3,
                                               PATHS["hier"][1])
    for name, r in report.items():
        if r["differences"] or r["launches_wrong"] or not r["finite"]:
            failures.append(f"{name}: {r['differences']} {r['launches_wrong']} "
                            f"finite={r['finite']}")
    report["resume"] = resume_vs_straight(cfg, timing_scene(cfg), device, out_dir)
    if report["resume"]["differences"] or report["resume"]["iteration"] != [40, 40]:
        failures.append(f"resume: {report['resume']}")
    emit({"phase": "chained", "steps_per_call": k, "rays": cfg.batch_size, **report,
          "failures": failures})
    if failures:
        raise AssertionError("chained steps differ from eager steps: " + "; ".join(failures))


def phase_render(cfg, model, out_dir):
    import numpy as np
    import torch

    from danerf_tpu_torch.cli.main import main as cli_main
    from danerf_tpu_torch.kernels import fused_render as fr

    ckpt = os.path.join(out_dir, "smoke_model.pt")
    table = torch.randn(4, cfg.appearance_dim, generator=torch.Generator().manual_seed(3))
    torch.save({"model_state_dict": {k: v.cpu() for k, v in model.state_dict().items()},
                "appearance_embeddings": table, "iteration": 0}, ckpt)

    size, frames = 400, 2
    chunks = -(-size * size // cfg.render_chunk)
    runs = {}
    for quality, n_frames in (("medium", frames), ("preview", 1)):
        run_dir = os.path.join(out_dir, f"render_{quality}")
        argv = ["render", "--checkpoint", ckpt, "--output_dir", run_dir,
                "--frames", str(n_frames), "--width", str(size), "--height", str(size),
                "--quality", quality, "--save_depth", "--device", "cuda", "--seed", "0"]
        fr.reset_launch_counts()
        t0 = time.perf_counter()
        written = cli_main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(fr.LAUNCHES)
        for i in range(n_frames):
            for name in (f"rgb_{i:03d}.png", f"depth_{i:03d}.png", f"raw/depth_{i:03d}.npy"):
                if not os.path.exists(os.path.join(run_dir, name)):
                    raise AssertionError(f"{quality}: {name} was not written")
            depth = np.load(os.path.join(run_dir, f"raw/depth_{i:03d}.npy"))
            if depth.shape != (size, size) or not np.isfinite(depth).all():
                raise AssertionError(f"{quality}: depth {i} bad: {depth.shape}")
        want = {"march": chunks * n_frames,
                "merged": chunks * n_frames if quality != "preview" else 0}
        if counts["march"] < want["march"] or (
                quality != "preview" and counts["merged"] < want["merged"]):
            raise AssertionError(f"{quality}: launches {counts}, expected at least {want}")
        runs[quality] = {"frames": len(written), "seconds": secs, "launches": counts,
                         "chunks_per_frame": chunks}
    emit({"phase": "render", "size": size, **runs})
    return runs["medium"]["launches"]


TRAIN_FLAGS = {"hier": [], "coarse": ["--num_importance", "0"], "white": ["--white_background"],
               "per_sample": [], "time": ["--use_time"], "hier_onepass": [], "hier_f32": [],
               "per_sample_f32": [],
               # data-parallel 64 + 64 over every rank of a torchrun group
               "hier_dp": ["--coordinator_address", "auto", "--mesh_data", "0"]}
# The routes with no CLI flag (nor has the JAX CLI one), trained through train()
API_PATHS = ("per_sample", "hier_onepass", "hier_f32", "per_sample_f32")


def scene_path(out_dir, timed=False):
    """The --dataset_path of the runs on the procedural scene.  Its static
    form is rendered once on the host (its 20 train views ~20 s) and
    written in the nerf_synthetic layout (save_blender_scene: the uint8
    images and alphas as RGBA PNGs, so they load back exactly), which every
    later run loads; the time-varying form (use_time), whose per-view times
    that layout does not carry, is a path that holds no scene, which
    load_dataset renders anew (its 16 views ~4 s)."""
    from danerf_tpu_torch.config import NeRFConfig
    from danerf_tpu_torch.data.blender import save_blender_scene
    from danerf_tpu_torch.data.synthetic import make_synthetic_scene

    if timed:
        return os.path.join(out_dir, "no_scene")
    cfg, root = NeRFConfig(), os.path.join(out_dir, "scene_png")
    scene = os.path.join(root, cfg.scene)
    for split in ("train", "val"):
        if not os.path.exists(os.path.join(scene, f"transforms_{split}.json")):
            save_blender_scene(make_synthetic_scene(split, near=cfg.near, far=cfg.far, seed=0),
                               scene, split)
    return root


def train_api(argv, over):
    """A route's entry point where it has no CLI flag (the per-sample route,
    use_fused_train=False; the one-kernel step, use_hier_onepass=True; the
    f32 configuration, use_bf16=False):
    ``train(cfg.replace(**over), dataset)``, the config and dataset built as
    `cli.main train` builds them from ``argv``'s flags."""
    from danerf_tpu_torch.cli.main import _train_config, build_parser
    from danerf_tpu_torch.data.dataset import load_dataset
    from danerf_tpu_torch.train.trainer import train

    args = build_parser().parse_args(argv)
    cfg = _train_config(args).replace(**over)
    return train(cfg, load_dataset(cfg, "train"), save_dir=args.save_dir, resume=args.resume,
                 num_iterations=args.iters, seed=args.seed, device=args.device,
                 checkpoint_every=args.checkpoint_every,
                 log_path=os.path.join(args.save_dir, "metrics.jsonl"))


def phase_train(out_dir, path, iters, render, every=None, resume_to=None):
    """A training path through its entry point: `cli.main train` (for the
    routes without a flag ``train_api``) for ``iters`` steps on the
    procedural scene (its time-varying form under --use_time), 10 steps a
    call (the default steps_per_call: one graph replay a full chunk), with
    exactly the path's kernel launches per step, one metrics.jsonl row a
    step, finite losses and a rising PSNR.  With ``every``
    (--checkpoint_every) each checkpoint's validation render (one K2 and
    one K5 launch: the 100x100 view is one chunk) is counted too, and
    render_000100.png and training_curves.png must decode; with
    ``resume_to`` the run is then resumed (--resume) to that step, with
    exactly the path's launches for the steps added and their rows
    appended.  Then, when ``render``, `render` of the final checkpoint: a
    100x100 preview frame, or for the time path two 400x400 medium frames
    with --use_time --animate_time (t = 0, then 1)."""
    import shutil

    import numpy as np
    import torch

    from danerf_tpu_torch.cli.main import main as cli_main
    from danerf_tpu_torch.data.png import read_png
    from danerf_tpu_torch.kernels import fused_render as fr

    warmup = 5
    kind = path.removesuffix("_dp")   # the launches of a data-parallel step: its path's
    save = os.path.join(out_dir, f"train_{path}")
    shutil.rmtree(save, ignore_errors=True)          # metrics.jsonl appends
    scene = scene_path(out_dir, path == "time")
    argv = ["train", "--density_bias_init", "0.5", "--save_dir", save, "--device", "cuda",
            "--seed", "0", "--dataset_path", scene, *TRAIN_FLAGS[path]]
    if every:
        argv += ["--checkpoint_every", str(every)]

    def run(n, *flags):
        fr.reset_launch_counts()
        t0 = time.perf_counter()
        if path in API_PATHS:
            train_api([*argv, "--iters", str(n), *flags], over)
        else:
            cli_main([*argv, "--iters", str(n), *flags])
        torch.cuda.synchronize()
        return time.perf_counter() - t0, dict(fr.LAUNCHES)

    over, per_step = ALL_PATHS[kind]

    def val_renders(first, last):
        n = sum(1 for s in range(first + 1, last + 1) if every and s % every == 0)
        f32 = "" if over.get("use_bf16", True) else "_f32"
        return {f"march{f32}": n, f"merged{f32}": n if over.get("num_importance", 1) else 0}

    secs, counts = run(iters)
    want = launches_of(per_step, iters)
    for k, v in val_renders(0, iters).items():
        want[k] += v
    if counts != want:
        raise AssertionError(f"train {path}: launches {counts}, expected {want}")
    with open(os.path.join(save, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    if [r["step"] for r in rows] != list(range(1, iters + 1)):
        raise AssertionError(f"train {path}: metrics.jsonl does not hold one row per step")
    if not all(math.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"train {path}: a logged loss is not finite")
    first = float(np.mean([r["psnr"] for r in rows[warmup:warmup + 20]]))
    last = float(np.mean([r["psnr"] for r in rows[-20:]]))
    if not last > first:
        raise AssertionError(f"train {path}: PSNR did not rise ({first} -> {last})")
    ckpt = os.path.join(save, "checkpoint_final.pt")
    if not os.path.exists(ckpt):
        raise AssertionError(f"train {path}: checkpoint_final.pt was not written")
    pngs = {}
    if every:
        for name, shape in (("render_000100.png", (100, 200, 3)),
                            ("training_curves.png", (400, 1000, 3))):
            img = read_png(os.path.join(save, name))
            if img.shape != shape or img.std() == 0:
                raise AssertionError(f"train {path}: {name} decodes to {img.shape}, "
                                     f"std {img.std()}")
            pngs[name] = list(img.shape)
    resumed = None
    if resume_to:
        r_secs, r_counts = run(resume_to, "--resume")
        r_want = launches_of(per_step, resume_to - iters)
        for k, v in val_renders(iters, resume_to).items():
            r_want[k] += v
        if r_counts != r_want:
            raise AssertionError(f"train {path} --resume: launches {r_counts}, "
                                 f"expected {r_want}")
        with open(os.path.join(save, "metrics.jsonl")) as f:
            r_rows = [json.loads(line) for line in f]
        if [r["step"] for r in r_rows] != list(range(1, resume_to + 1)):
            raise AssertionError(f"train {path} --resume: the rows are not 1..{resume_to}")
        it = torch.load(ckpt, map_location="cpu", weights_only=False)["iteration"]
        if it != resume_to or not all(math.isfinite(r["loss"]) for r in r_rows):
            raise AssertionError(f"train {path} --resume: final checkpoint at {it}")
        resumed = {"to": resume_to, "seconds": r_secs, "launches": r_counts,
                   "loss_last": r_rows[-1]["loss"],
                   "psnr_mean_last20": float(np.mean([r["psnr"] for r in r_rows[-20:]]))}
    rendered = None
    if render:
        render_dir = os.path.join(out_dir, f"render_trained_{path}")
        if path == "time":
            size, frames, flags = 400, 2, ["--quality", "medium", "--use_time", "--animate_time"]
        else:
            size, frames, flags = 100, 1, ["--quality", "preview"]
        fr.reset_launch_counts()
        written = cli_main(["render", "--checkpoint", ckpt, "--output_dir", render_dir,
                            "--frames", str(frames), "--width", str(size), "--height",
                            str(size), "--device", "cuda", "--dataset_path", scene, *flags])
        torch.cuda.synchronize()
        if len(written) != frames or not all(os.path.exists(w) for w in written):
            raise AssertionError(f"render of the trained {path} checkpoint wrote {written}")
        if path == "time" and min(fr.LAUNCHES["march"], fr.LAUNCHES["merged"]) < 3 * frames:
            raise AssertionError(f"time render: launches {fr.LAUNCHES}, expected 3 K2 and 3 "
                                 "K5 a frame")
        rendered = {"frames": written, "size": size, "flags": flags,
                    "launches": dict(fr.LAUNCHES)}
    emit({"phase": "train", "path": path, "flags": TRAIN_FLAGS[path], "iters": iters,
          "checkpoint_every": every, "seconds_incl_scene": secs, "launches": counts,
          "loss_first": rows[0]["loss"], "loss_last": rows[-1]["loss"],
          "psnr_mean_first20_after_warmup": first, "psnr_mean_last20": last,
          "pngs": pngs, "resumed": resumed, "render": rendered})
    return counts


def phase_timing(cfg, model, device, chunk, frame_t=None):
    """K2 (want_field) and K5 on the 65,536-ray chunk and their plain
    versions, each beside its bound, and one 800x800 medium frame (median of
    three after a warm-up frame); with use_time the chunk carries each ray's
    time and the frame renders at ``frame_t``."""
    import torch

    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.kernels.fused_mlp import pack_params
    from danerf_tpu_torch.render.renderer import render_frame
    from danerf_tpu_torch.viz.paths import camera_path

    R, S = cfg.render_chunk, cfg.num_samples
    packed = pack_params(model, cfg)
    o, d, emb, z, z_f, t = chunk
    field = fr.march_cuda(packed, cfg, o, d, emb, z, t, want_field=True)["field"]

    k2 = cuda_ms(lambda: fr.march_cuda(packed, cfg, o, d, emb, z, t, want_field=True), 5, 2)
    k5 = cuda_ms(lambda: fr.merged_cuda(packed, cfg, o, d, emb, z, field, z_f, t), 5, 2)
    k2_plain = cuda_ms(lambda: fr.march_plain(packed, cfg, o, d, emb, z, t, want_field=True), 3)
    k5_plain = cuda_ms(lambda: fr.merged_plain(packed, cfg, o, d, emb, z, field, z_f, t), 3)

    w_bytes = packed.mats.numel() * 2 + packed.vecs.numel() * 4
    e, nt = cfg.appearance_dim, int(t is not None)
    k2_bytes = 4 * R * (3 + 3 + e + S + nt) + 4 * R * (3 + 1 + 1 + S + 4 * S) + w_bytes
    sa = S + cfg.num_importance
    k5_bytes = (4 * R * (3 + 3 + e + S + 4 * S + cfg.num_importance + nt)
                + 4 * R * (3 + 1 + 1 + sa + sa) + w_bytes)
    k2_bound, k2_by = bound(cfg, R, S, k2_bytes)
    k5_bound, k5_by = bound(cfg, R, cfg.num_importance, k5_bytes)

    side = 800
    c2w = camera_path("circle", 2, cfg.scene)[0]
    focal = 0.5 * side / math.tan(0.5 * 0.6911)
    emb0 = emb[0]

    def frame():
        gen = torch.Generator(device=device).manual_seed(6)
        return render_frame(model, cfg, c2w, side, side, focal, appearance_embedding=emb0,
                            perturb=True, t=frame_t, generator=gen, device=device)

    frame()
    torch.cuda.synchronize()
    # host-clock times spread more than device times: report the median of 3
    frame_ms = []
    for _ in range(3):
        fr.reset_launch_counts()
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    frame_launches = dict(fr.LAUNCHES)
    chunks = side * side / R
    # the frame's 640,000 rays in 10 chunks: one K2 and one K5 each, nothing else
    want_launches = {k: (math.ceil(chunks) if k in ("march", "merged") else 0)
                     for k in frame_launches}
    if frame_launches != want_launches:
        raise AssertionError(f"800x800 medium frame launched {frame_launches}, "
                             f"expected {want_launches}")
    timing = {"chunk_rays": R, "k2_ms": k2, "k5_ms": k5, "k2_plain_ms": k2_plain,
              "k5_plain_ms": k5_plain, "k2_bound_ms": k2_bound, "k5_bound_ms": k5_bound,
              "frame_800_medium_derived_ms": chunks * (k2 + k5),
              "frame_800_medium_measured_ms": sorted(frame_ms)[1],
              "frame_800_medium_each_ms": frame_ms,
              "frame_800_medium_launches": frame_launches,
              "frame_800_medium_bound_ms": chunks * (k2_bound + k5_bound)}
    emit({"phase": "timing", "use_time": cfg.use_time, "frame_t": frame_t, **timing})
    return timing, (k2_by, k5_by)


def kernel_part(name):
    """The part of a step a device kernel belongs to: the tile kernel of K3,
    K4, K6, K7, K8 or K9 (csrc/field_bwd_sm90.cuh), their dW pass (the
    wgmma blocks, the narrow jobs, the reductions), the tile (K9's two tile
    kernels), the wgmma dW pass and the gate pass of the f32 K3, K4, K6-K9
    (csrc/field_bwd_f32_sm90.cuh) and their narrow dW jobs' FFMA pass and
    row sums (bwd_f32_parts.cuh), the f32 K1 (csrc/mlp_fwd_f32.cu), or the
    rest."""
    if "mlp_fwd_f32" in name:
        return "k1_f32"
    if "bwd_tile90" in name or "hier_tile90" in name:
        return "bwd90_tile"
    if any(k in name for k in ("dw90_", "dw_kernel<64>", "dw_reduce<64>", "reduce_slots")):
        return "bwd90_dw_pass"
    if any(k in name for k in ("bwd_tile32", "hier_coarse32", "hier_fine32")):
        return "t32_tile"
    if "dw_t32_" in name:
        return "t32_dw_pass"
    if "gate_pass32" in name:
        return "t32_gate_pass"
    if any(k in name for k in ("dw32_", "sum_slots32")):
        return "bwd32_dw_pass"
    return "rest"


def dw_pass_timing(cfg, packed, device, calls):
    """K3, K4, K6 and K7 at the batch broken down by torch.profiler (device
    ms per call of each kernel they launch, and by kernel_part), and torch.matmul
    over the same d_pre^T @ input products at the batch's 65,536 rows as a
    yardstick (``dw_cublas_ms``; nothing on any path calls it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from danerf_tpu_torch.kernels.fused_mlp import enc_widths

    out = {}
    for k in ("k3", "k4", "k6", "k7"):
        calls[k][0]()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                calls[k][0]()
            torch.cuda.synchronize()
        kern, parts = {}, {}
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue
            ms = ev.self_device_time_total / 1e3 / 5
            kern[ev.key[:60]] = ms
            parts[kernel_part(ev.key)] = parts.get(kernel_part(ev.key), 0.0) + ms
        out[k] = {"kernels_ms": kern, "parts_ms": parts}
    rows = cfg.batch_size * cfg.num_samples
    kx, kd = enc_widths(cfg)
    L, hid, half = packed.num_layers, cfg.hidden_dim, cfg.hidden_dim // 2
    g = torch.Generator(device=device).manual_seed(90)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=device).to(torch.bfloat16)

    dpre, h = rnd(L, rows, hid), rnd(L, rows, hid)
    ddir, dapp, happ = rnd(rows, half), rnd(rows, half), rnd(rows, half)
    encx, encd = rnd(rows, kx), rnd(rows, kd)
    embr, drgb = rnd(rows, cfg.appearance_dim), rnd(rows, 16)
    skips = [i for i in cfg.skip_connect_layers if 0 < i < L]
    products = ([(dpre[i], h[i - 1]) for i in range(1, L)] + [(ddir, h[L - 1])]
                + [(dpre[i], encx) for i in [0] + skips]
                + [(ddir, encd), (dapp, embr), (drgb, happ)])
    out["dw_cublas_ms"] = cuda_ms(lambda: [torch.matmul(a.t(), b) for a, b in products], 10)
    out["dw_cublas_products"] = len(products)
    del dpre, h, products
    return out


def profile_steps(step, n_prof=10):
    """Device time by kernel over ``n_prof`` steps (torch.profiler, CUPTI):
    the top kernels, the device's busy ms a step and the profiled wall ms a
    step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_prof
    kernels = sorted(((ev.key, ev.self_device_time_total / 1e3 / n_prof, ev.count / n_prof)
                      for ev in prof.key_averages()
                      # kernels and copies; a user range (Optimizer.step#...) on the
                      # device timeline spans others and would count them twice
                      if ev.device_type == DeviceType.CUDA
                      and not getattr(ev, "is_user_annotation", False)
                      and not ev.key.startswith("Optimizer.")),
                     key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    breakdown = {}
    for name, ms, _ in kernels:
        breakdown[kernel_part(name)] = breakdown.get(kernel_part(name), 0.0) + ms
    return {"profile_ms_per_step": [[k[0][:70], k[1], k[2]] for k in kernels[:14]],
            "profile_breakdown_ms_per_step": breakdown,
            "profile_device_busy_ms_per_step": busy_ms, "profile_wall_ms_per_step": wall_ms,
            "profile_idle_share": 1.0 - busy_ms / wall_ms}


def phase_frame_profile(cfg, model, device, side=800):
    """One 800x800 medium frame's render_frame (frame_call), f32 and bf16,
    under torch.profiler after a warm call: the device's busy ms, the
    frame's ms in the window and its idle share, and the device ms by
    kernel.  The last profiler window of the run, so it slows no timing
    after it (PERF.md §7); f32_path's frame_breakdown times the same frames
    without one."""
    import torch

    emb0 = torch.randn(cfg.appearance_dim, generator=torch.Generator().manual_seed(3))
    report = {"phase": "frame_profile", "side": side, "quality": "medium"}
    for name, c in (("f32", cfg.replace(use_bf16=False)), ("bf16", cfg)):
        frame = frame_call(model, c, emb0, side, device)
        frame()
        torch.cuda.synchronize()
        prof = profile_steps(frame, n_prof=1)
        report[name] = {"device_busy_ms": prof["profile_device_busy_ms_per_step"],
                        "wall_ms": prof["profile_wall_ms_per_step"],
                        "idle_share": prof["profile_idle_share"],
                        "device_ms_by_kernel": prof["profile_ms_per_step"]}
    emit(report)
    return report


def phase_train_timing(cfg, model, device, chunk):
    """The training kernels (K3, K4, K6, K7, K9) on the 65,536-ray chunk and
    at the 1024-ray batch, their plain versions at the batch; K1 and K8 at
    the per-sample route's rows of a batch (K1 also on the chunk's), with
    their plain versions; and the training step of each path at B = 1024
    (median of 50 synchronised steps) with a torch.profiler breakdown of the
    64 + 64, the coarse-only, the white-background, the per-sample and the
    one-kernel (K9) step.
    With use_time (the has_time variants, each ray's or row's time uniform
    in [0, 1]): every kernel at the batch (K1/K8 at 131,072 rows) and the
    use_time step, profiled."""
    import torch

    from danerf_tpu_torch.kernels import fused_mlp as fm
    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.kernels.fused_mlp import pack_params
    from danerf_tpu_torch.ops.sampling import importance_uniforms, sample_pdf

    packed = pack_params(model, cfg)
    sc, sf, e = cfg.num_samples, cfg.num_importance, cfg.appearance_dim
    sa, nt = sc + sf, int(cfg.use_time)
    w_bytes = packed.mats.numel() * 2 + packed.vecs.numel() * 4
    g_bytes = (packed.mats.numel() + packed.vecs.numel()) * 4
    # bytes each kernel must move: inputs read once, outputs written once
    ray_bytes = {
        "k3": lambda n: 4 * n * (3 + 3 + e + sc + nt + 3 + 1 + 1 + sc + 4 * sc) + 4 * n * e,
        "k4": lambda n: (4 * n * (3 + 3 + e + sc + 4 * sc + sf + 3 + nt) + 4 * n * (e + 4 * sc)
                         + 4),
        "k6": lambda n: (4 * n * (3 + 3 + e + sc + 4 * sc + sf + nt + 3 + 1 + 1 + sa)
                         + 4 * n * (e + 4 * sc)),
        "k7": lambda n: 4 * n * (3 + 3 + e + sc + 3 + nt) + 4 * n * e + 4,
        "k9": lambda n: 4 * n * (3 + 3 + e + sc + sf + 3 + nt) + 4 * n * e + 8,
    }
    # the samples a ray at which each runs the field and its transposed chain
    samples = {"k3": sc, "k4": sf, "k6": sf, "k7": sc, "k9": sc + sf}

    out, bound_by = {}, {}
    g = torch.Generator(device=device).manual_seed(31)

    def times(n):
        return torch.rand(n, 1, generator=g, device=device) if cfg.use_time else None

    shapes = [("batch", make_rays(cfg.batch_size, cfg, seed=32, device=device)
               + (None, times(cfg.batch_size)))]
    if not cfg.use_time:
        shapes.insert(0, ("chunk", chunk))
    for tag, (o, d, emb, z, z_f, t) in shapes:
        n = o.shape[0]
        *cot, g_field = _cotangents(n, sc, g, device)
        coarse = fr.march_cuda(packed, cfg, o, d, emb, z, t, want_field=True)
        if z_f is None:
            z_f = sample_pdf(z, coarse["weights"], sf, True, rand=g)
        field = coarse["field"]
        target = torch.rand(n, 3, generator=g, device=device)
        c6 = (cot[0], cot[1], cot[2], 0.1 * torch.randn(n, sa, generator=g, device=device))
        u = importance_uniforms((n,), sf, True, rand=g, device=device)
        del coarse
        calls = {
            "k3": (lambda: fr.march_bwd_cuda(packed, cfg, o, d, emb, z, *cot, g_field, t=t),
                   lambda: fr.march_bwd_plain(packed, cfg, o, d, emb, z, *cot, g_field, t=t)),
            "k4": (lambda: fr.merged_train_cuda(packed, cfg, o, d, emb, z, field, z_f, target,
                                                t),
                   lambda: fr.merged_train_plain(packed, cfg, o, d, emb, z, field, z_f, target,
                                                 t)),
            "k6": (lambda: fr.merged_bwd_cuda(packed, cfg, o, d, emb, z, field, z_f, *c6, t=t),
                   lambda: fr.merged_bwd_plain(packed, cfg, o, d, emb, z, field, z_f, *c6,
                                               t=t)),
            "k7": (lambda: fr.march_train_cuda(packed, cfg, o, d, emb, z, target, t),
                   lambda: fr.march_train_plain(packed, cfg, o, d, emb, z, target, t)),
            "k9": (lambda: fr.hier_onepass_cuda(packed, cfg, o, d, emb, z, u, target, t),
                   lambda: fr.hier_onepass_plain(packed, cfg, o, d, emb, z, u, target, t)),
        }
        iters = 3 if tag == "chunk" else 20
        for k, (kern, plain) in calls.items():
            out[f"{k}_{tag}_ms"] = cuda_ms(kern, iters)
            out[f"{k}_{tag}_bound_ms"], bound_by[k] = bound(
                cfg, n, samples[k], ray_bytes[k](n) + w_bytes + g_bytes, backward=True)
            if tag == "batch":
                out[f"{k}_batch_plain_ms"] = cuda_ms(plain, 5)
        if tag == "batch":
            out["k2_batch_ms"] = cuda_ms(
                lambda: fr.march_cuda(packed, cfg, o, d, emb, z, t, want_field=True), iters)
            out["k5_batch_ms"] = cuda_ms(
                lambda: fr.merged_cuda(packed, cfg, o, d, emb, z, field, z_f, t), iters)
            k2_bytes = (4 * n * (3 + 3 + e + sc + nt) + 4 * n * (3 + 1 + 1 + sc + 4 * sc)
                        + w_bytes)
            out["k2_batch_bound_ms"], _ = bound(cfg, n, sc, k2_bytes)
            k5_bytes = (4 * n * (3 + 3 + e + sc + 4 * sc + sf + nt)
                        + 4 * n * (3 + 1 + 1 + sa + sa) + w_bytes)
            out["k5_batch_bound_ms"], _ = bound(cfg, n, sf, k5_bytes)
            if not cfg.use_time:
                out["bwd90_parts"] = dw_pass_timing(cfg, packed, device, calls)
        del cot, g_field, field, target, c6, u, calls

    # K1 and K8 at the rows of a 1024-ray batch's coarse (65,536) and fine
    # (131,072) evaluations, and K1 on a render chunk's sample rows
    # (65,536 rays x 64 = 4,194,304); bytes: inputs once, outputs once
    k1_bytes = lambda n: 4 * n * (3 + 3 + e + nt) + 4 * n * (3 + 1) + w_bytes
    k8_bytes = lambda n: 4 * n * (3 + 3 + e + nt + 3 + 1) + 4 * n * e + w_bytes + g_bytes
    row_sets = {"131072": sample_rows(cfg.batch_size, cfg, 34, device, sc + sf)}
    if not cfg.use_time:
        row_sets = {"65536": sample_rows(cfg.batch_size, cfg, 33, device, sc), **row_sets,
                    "chunk": sample_rows(cfg.render_chunk, cfg, 35, device, sc)}
    for tag, (x, dr, er) in row_sets.items():
        n = x.shape[0]
        t = times(n)
        out[f"k1_{tag}_ms"] = cuda_ms(lambda: fm.fused_fwd_cuda(packed, cfg, x, dr, er, t),
                                      3 if tag == "chunk" else 20)
        out[f"k1_{tag}_plain_ms"] = cuda_ms(lambda: fm.fused_fwd_plain(packed, cfg, x, dr, er,
                                                                       t),
                                            2 if tag == "chunk" else 5)
        out[f"k1_{tag}_bound_ms"], bound_by["k1"] = bound(cfg, n, 1, k1_bytes(n))
        if tag != "chunk":
            g_rgb = torch.randn(n, 3, generator=g, device=device)
            g_sig = torch.randn(n, 1, generator=g, device=device)
            out[f"k8_{tag}_ms"] = cuda_ms(
                lambda: fm.fused_bwd_cuda(packed, cfg, x, dr, er, g_rgb, g_sig, t), 10)
            out[f"k8_{tag}_plain_ms"] = cuda_ms(
                lambda: fm.fused_bwd_plain(packed, cfg, x, dr, er, g_rgb, g_sig, t), 3)
            out[f"k8_{tag}_bound_ms"], bound_by["k8"] = bound(cfg, n, 1, k8_bytes(n),
                                                              backward=True)
        del x, dr, er
    del row_sets

    # the kernels of a step, and their bound, at B = 1024
    white = ("k2_batch", "k5_batch", "k6_batch", "k3_batch")
    step_kernels = ({"time": white} if cfg.use_time else
                    {"hier": ("k2_batch", "k3_batch", "k4_batch"), "coarse": ("k7_batch",),
                     "white": white,
                     "per_sample": ("k1_65536", "k1_131072", "k8_65536", "k8_131072"),
                     "hier_onepass": ("k9_batch",)})
    steps = {path: step_timing(cfg.replace(**PATHS[path][0]), device, out, kerns,
                               profile=path in ("hier", "coarse", "white", "per_sample",
                                                "time", "hier_onepass"))
             for path, kerns in step_kernels.items()}
    emit({"phase": "train_timing", "use_time": cfg.use_time, "batch": cfg.batch_size,
          "chunk_rays": chunk[0].shape[0], **out, "steps": steps})
    return out, bound_by


def step_timing(cfg, device, kernel_ms, kernels, profile):
    """The training step of ``cfg`` at B = 1024 on timing_scene's pool:
    the median of 50 synchronised eager steps after 5 warm-up steps, its
    rays/s, the share of ``kernels`` (keys of ``kernel_ms``, the step's
    kernels timed alone) and their summed bound; then the chained step (10
    steps a call, one graph replay): the median, min and max of 20
    synchronised replays, each over 10, its rays/s, one replay's device time
    by CUDA events, and the graph's pool; with ``profile`` torch.profiler
    windows of 10 eager steps and of 3 replays."""
    import numpy as np
    import torch

    from danerf_tpu_torch.train.trainer import make_train_step, train_step

    ds = timing_scene(cfg)
    model, table, opt, sched, gen, pool = train_state(cfg, ds, device)

    def step():
        return train_step(model, table, opt, sched, pool, cfg, 100, 100, ds.focal, None, gen)

    for _ in range(5):
        step()
    torch.cuda.synchronize()
    times = []
    for _ in range(50):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = float(np.median(times))
    kern_ms = sum(kernel_ms[f"{k}_ms"] for k in kernels)
    out = {"step_ms_median": step_ms, "step_ms_min": min(times), "step_ms_max": max(times),
           "rays_per_s": cfg.batch_size / (step_ms / 1e3), "kernels": kernels,
           "kernel_share": kern_ms / step_ms,
           "step_bound_ms": sum(kernel_ms[f"{k}_bound_ms"] for k in kernels)}
    if profile:
        out.update(profile_steps(step))

    k = 10
    chained = make_train_step(model, table, opt, sched, pool, cfg, 100, 100, ds.focal, None,
                              gen, k)
    chained()
    torch.cuda.synchronize()
    reps = []
    for _ in range(20):
        t0 = time.perf_counter()
        chained()
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t0) * 1e3 / k)
    chained_ms = float(np.median(reps))
    out.update({"chained_steps_per_call": k, "chained_ms_per_step_median": chained_ms,
                "chained_ms_per_step_min": min(reps), "chained_ms_per_step_max": max(reps),
                "chained_rays_per_s": cfg.batch_size / (chained_ms / 1e3),
                "chained_replay_event_ms": cuda_ms(chained, 5),
                "graph_pool_bytes": chained.pool_bytes})
    if profile:
        prof = profile_steps(chained, n_prof=3)
        out.update({"chained_profile_ms_per_replay": prof["profile_ms_per_step"],
                    "chained_profile_breakdown_ms_per_step": {
                        n: v / k for n, v in prof["profile_breakdown_ms_per_step"].items()},
                    "chained_profile_device_busy_ms_per_step":
                        prof["profile_device_busy_ms_per_step"] / k,
                    "chained_profile_wall_ms_per_step": prof["profile_wall_ms_per_step"] / k,
                    "chained_profile_idle_share": prof["profile_idle_share"]})
    return out


# ---------------------------------------------------------------- effects

def fx_inputs(side, seed):
    """A seeded uint8 frame and a depth map in [0, 1] with smooth structure,
    a step at a third of the width and a little noise (on the host)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    img = torch.randint(0, 256, (side, side, 3), generator=g, dtype=torch.uint8)
    yy, xx = torch.meshgrid(torch.arange(side), torch.arange(side), indexing="ij")
    depth = 0.45 + 0.25 * torch.sin(xx / 7.0) * torch.cos(yy / 5.0)
    depth = depth + 0.05 * torch.rand(side, side, generator=g) + 0.2 * (xx >= side // 3)
    return img, depth.clamp(0, 1)


def event_ms(fn, iters=10):
    """Median and each of ``iters`` CUDA-event times of ``fn`` after a
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2], times


def phase_fx(device, side=800):
    """Each of the 14 effects, with and without depth, on a seeded 800x800
    frame and depth: on the card and, with the same draws, through the port
    on the CPU, within effects.levels_apart's tolerance, under PyTorch's
    default TF32 flags (cuDNN on, matmul off; restored after); then each
    effect's time on the card (with depth, its noise drawn on the card):
    median of 10 CUDA-event times after a warm-up call."""
    import torch

    from danerf_tpu_torch.fx.effects import EFFECTS, apply_effect, draw_noise, levels_apart

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        img, depth = fx_inputs(side, 11)
        img_d, depth_d = img.to(device), depth.to(device)
        held, failures = {}, []
        for name in EFFECTS:
            for tag, dep, dep_d in (("depth", depth, depth_d), ("no_depth", None, None)):
                draws = draw_noise(name, img.shape, torch.Generator().manual_seed(12), "cpu")
                want = apply_effect(name, img, dep, draws=draws, device="cpu")
                got = apply_effect(name, img_d, dep_d, draws=draws)
                if got.device.type != "cuda" or got.dtype != torch.uint8:
                    failures.append(f"{name} {tag}: {got.device} {got.dtype}")
                apart = levels_apart(name, got, want)
                held[f"{name} / {tag}"] = apart
                if not apart["ok"]:
                    failures.append(f"{name} {tag}: {apart}")
        ms = {}
        for name in EFFECTS:
            gen = torch.Generator(device=device).manual_seed(13)
            ms[name], _ = event_ms(lambda: apply_effect(name, img_d, depth_d, generator=gen))
        flags = {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
                 "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    emit({"phase": "fx", "size": side, "tf32_flags": flags, "held": held, "ms": ms,
          "failures": failures})
    if failures:
        raise AssertionError("effects on the card differ from the CPU: " + "; ".join(failures))
    return ms


def serve_launches(counts, want_k2k5):
    """The render's launches: exactly ``want_k2k5`` K2 and K5, nothing else."""
    want = {k: (want_k2k5 if k in ("march", "merged") else 0) for k in counts}
    if counts != want:
        raise AssertionError(f"launches {counts}, expected {want}")


# dB, each decoded plane against the PNGs' own Y, Cb, Cr (the colour format's
# loss apart: saturated scanlines lose ~6 dB of RGB PSNR to 4:2:0 alone)
VIDEO_PSNR_FLOOR = 35.0


def check_video(path, pngs, fps):
    """A video the port wrote (MPEG-4 Part 2), decoded with the port's
    reader: one frame a PNG at ``fps``, every plane equal to the encoder's
    reconstruction of the PNGs (encoded again here), an I-VOP every 12th
    frame and P-VOPs between, and each plane's mean PSNR against the PNGs'
    own 4:2:0 planes at least VIDEO_PSNR_FLOOR; the RGB PSNR against the
    PNGs, and that of the 4:2:0 conversion alone, are reported."""
    import numpy as np

    from danerf_tpu_torch.data.png import read_png
    from danerf_tpu_torch.viz import mpeg4
    from danerf_tpu_torch.viz.video import decode_video, idct_for

    def psnr(a, b):
        err = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
        return float(10 * np.log10(255.0 ** 2 / max(err, 1e-12)))

    planes, keys, got_fps = decode_video(path)
    want = [read_png(p) for p in pngs]
    if len(planes) != len(want) or got_fps != fps:
        raise AssertionError(f"{path}: {len(planes)} frames at {got_fps} fps, expected "
                             f"{len(want)} at {fps}")
    if keys != [i % mpeg4.GOP == 0 for i in range(len(want))]:
        raise AssertionError(f"{path}: I-VOPs at {[i for i, k in enumerate(keys) if k]}")
    enc = mpeg4.Encoder(want[0].shape[1], want[0].shape[0], fps, idct=idct_for(path))
    per_plane, rgb, fmt = [], [], []
    for i, (got, png) in enumerate(zip(planes, want)):
        enc.encode(png)
        if not all(np.array_equal(a, b) for a, b in zip(got, enc.reconstruction())):
            raise AssertionError(f"{path}: frame {i} is not the encoder's reconstruction")
        own = mpeg4.rgb_to_yuv420(png)
        per_plane.append([psnr(a, b) for a, b in zip(got, own)])
        rgb.append(psnr(mpeg4.yuv420_to_rgb(*got), png))
        fmt.append(psnr(mpeg4.yuv420_to_rgb(*own), png))
    planes_db = np.mean(per_plane, axis=0)
    if planes_db.min() < VIDEO_PSNR_FLOOR:
        raise AssertionError(f"{path}: mean PSNR of Y, Cb, Cr {planes_db.round(2).tolist()} dB "
                             f"against the PNGs' planes, below {VIDEO_PSNR_FLOOR}")
    return {"shape": [len(want), *want[0].shape], "psnr_yuv_db": planes_db.tolist(),
            "psnr_rgb_db": float(np.mean(rgb)), "psnr_rgb_420_alone_db": float(np.mean(fmt)),
            "bytes": os.path.getsize(path)}


def phase_serve_fx(cfg, out_dir, device, size=400):
    """render --effect Fog --create_video, then --effect Hologram, each two
    400x400 medium frames from the smoke checkpoint: every file, the video
    read back against the PNGs, and exactly one K2 and one K5 a chunk."""
    import numpy as np
    import torch

    from danerf_tpu_torch.cli.main import main as cli_main
    from danerf_tpu_torch.data.png import read_png
    from danerf_tpu_torch.kernels import fused_render as fr

    ckpt = os.path.join(out_dir, "smoke_model.pt")
    frames = 2
    chunks = -(-size * size // cfg.render_chunk)
    plain = [read_png(os.path.join(out_dir, "render_medium", f"rgb_{i:03d}.png"))
             for i in range(frames)]
    runs = {}
    for effect in ("Fog", "Hologram"):
        run_dir = os.path.join(out_dir, f"serve_fx_{effect.lower()}")
        argv = ["render", "--checkpoint", ckpt, "--output_dir", run_dir, "--frames",
                str(frames), "--width", str(size), "--height", str(size), "--quality",
                "medium", "--save_depth", "--effect", effect, "--create_video", "--fps", "24",
                "--device", str(device), "--seed", "0"]
        fr.reset_launch_counts()
        t0 = time.perf_counter()
        written = cli_main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(fr.LAUNCHES)
        serve_launches(counts, chunks * frames)
        for i in range(frames):
            for name in (f"rgb_{i:03d}.png", f"depth_{i:03d}.png", f"raw/depth_{i:03d}.npy"):
                if not os.path.exists(os.path.join(run_dir, name)):
                    raise AssertionError(f"{effect}: {name} was not written")
        # render's default --scene, hotdog, names the video
        shape = check_video(os.path.join(run_dir, "hotdog_render.mp4"), written, 24)
        got = [read_png(p) for p in written]
        if effect == "Fog" and min(int(g.min()) for g in got) < 178:
            raise AssertionError("Fog: a pixel below 0.7 x 255 (fog lets at most 30% through)")
        if any(np.array_equal(g, p) for g, p in zip(got, plain)):
            raise AssertionError(f"{effect}: a frame equals the unaffected render")
        runs[effect] = {"frames": len(written), "seconds": secs, "launches": counts,
                        "video": shape}
    emit({"phase": "serve_fx", "size": size, **runs})
    return runs


def phase_spiral_fx(cfg, out_dir, device, n=12, size=200):
    """The reference's pipeline through the CLI on the card: spiral (12
    frames at 200x200, depth on frames 0 and 10, its video), effects on its
    output (all 14: Fog on the 2 depth frames, the rest on 12, a video
    each), preview (fog_start at three values), video."""
    import json as _json

    import torch

    from danerf_tpu_torch.cli.main import main as cli_main
    from danerf_tpu_torch.data.png import read_png
    from danerf_tpu_torch.fx.effects import EFFECTS
    from danerf_tpu_torch.kernels import fused_render as fr

    ckpt = os.path.abspath(os.path.join(out_dir, "smoke_model.pt"))
    work = os.path.join(out_dir, "spiral_fx")
    os.makedirs(work, exist_ok=True)
    chunks = -(-size * size // cfg.render_chunk)
    report = {}
    with contextlib.chdir(work):
        fr.reset_launch_counts()
        t0 = time.perf_counter()
        written = cli_main(["spiral", "--checkpoint", ckpt, "--output_dir", "sp", "--frames",
                            str(n), "--width", str(size), "--height", str(size), "--fps", "30",
                            "--device", str(device), "--seed", "0"])
        torch.cuda.synchronize()
        report["spiral_seconds"] = time.perf_counter() - t0
        counts = dict(fr.LAUNCHES)
        serve_launches(counts, chunks * n)
        report["spiral_launches"] = counts
        depth = sorted(f for f in os.listdir("output/sp") if f.startswith("depth_"))
        if depth != ["depth_0000.png", "depth_0010.png"] or len(written) != n:
            raise AssertionError(f"spiral wrote {len(written)} frames, depth {depth}")
        if read_png("output/sp/depth_0000.png").shape != (size, size):
            raise AssertionError("spiral depth is not a grayscale frame")
        # spiral's default --scene, chair, names the video
        report["spiral_video"] = check_video("output/sp/chair_spiral.mp4", written, 30)

        t0 = time.perf_counter()
        names = cli_main(["effects", "--input_dir", "output/sp", "--device", str(device)])
        report["effects_seconds"] = time.perf_counter() - t0
        if names != list(EFFECTS):
            raise AssertionError(f"effects ran {names}")
        report["effects_frames"] = {}
        for name in names:
            slug = name.lower().replace(" ", "_")
            outs = sorted(os.path.join("output/sp_effects", slug, f)
                          for f in os.listdir(os.path.join("output/sp_effects", slug)))
            if len(outs) != (2 if name == "Fog" else n):
                raise AssertionError(f"effects {name}: {len(outs)} frames")
            check_video(f"output/sp_effects/{slug}.mp4", outs, 60)
            report["effects_frames"][name] = len(outs)

        with open("spec.json", "w") as f:
            _json.dump({"effects": [{"name": "Fog", "sweep": {"fog_start": [0.0, 0.2, 0.4]}}]},
                       f)
        previews = cli_main(["preview", "--image", "output/sp/frame_0000.png", "--depth",
                             "output/sp/depth_0000.png", "--spec", "spec.json", "--output_dir",
                             "pv", "--device", str(device)])
        with open("pv/manifest.json") as f:
            manifest = _json.load(f)
        if len(previews) != 3 or [m["params"]["fog_start"] for m in manifest] != [0.0, 0.2, 0.4]:
            raise AssertionError(f"preview wrote {previews}, manifest {manifest}")
        report["previews"] = [os.path.basename(p) for p in previews]

        cli_main(["video", "--input_dir", "output/sp", "--output", "sp.mp4", "--pattern",
                  "frame_*.png", "--fps", "30"])
        report["video"] = check_video("sp.mp4", written, 30)
        cli_main(["video", "--input_dir", "output/sp", "--output", "sp.avi", "--pattern",
                  "frame_*.png", "--fps", "30"])
        report["video_avi"] = check_video("sp.avi", written, 30)
    emit({"phase": "spiral_fx", "frames": n, "size": size, **report})
    return report


def phase_video(cfg, model, out_dir, device, smi, side=800, frames=26):
    """The video encoder on the card's host at 800x800: an aligned spiral
    of ``frames`` (26: an I-VOP at 0, 12 and 24) rendered by the model,
    then create_video_from_images of its PNGs into an .mp4 (ms a frame,
    the PNG reads included), the encoder alone on the decoded frames (ms
    a frame, the I-VOPs and P-VOPs apart), where its time goes (cProfile
    over a second pass, the functions above 2% of it), and the file checked
    by ``check_video``."""
    import cProfile
    import pstats

    import numpy as np

    from danerf_tpu_torch.data.png import read_png
    from danerf_tpu_torch.render.frames import render_aligned_spiral
    from danerf_tpu_torch.viz import mpeg4
    from danerf_tpu_torch.viz.video import create_video_from_images

    work = os.path.join(out_dir, "video")
    t0 = time.perf_counter()
    written = render_aligned_spiral(model, cfg, work, num_frames=frames, height=side,
                                    width=side, make_video=False, device=device)
    render_ms = (time.perf_counter() - t0) * 1e3 / frames
    path = os.path.join(work, "spiral.mp4")
    t0 = time.perf_counter()
    create_video_from_images(work, path, pattern="frame_*.png", fps=30)
    video_ms = (time.perf_counter() - t0) * 1e3 / frames
    imgs = [read_png(p) for p in written]
    enc = mpeg4.Encoder(side, side, 30)
    each = []
    for img in imgs:
        t0 = time.perf_counter()
        enc.encode(img)
        each.append((time.perf_counter() - t0) * 1e3)
    keys = [i % mpeg4.GOP == 0 for i in range(frames)]
    prof = cProfile.Profile()
    enc = mpeg4.Encoder(side, side, 30)
    prof.enable()
    for img in imgs:
        enc.encode(img)
    prof.disable()
    stats = pstats.Stats(prof).stats
    total = sum(tt for _, _, tt, _, _ in stats.values())
    where = {f"{name}:{line}": round(ct * 1e3 / frames, 3)
             for (fname, line, name), (_, _, _, ct, _) in stats.items()
             if fname.endswith("mpeg4.py") and ct > 0.02 * total}
    check = check_video(path, written, 30)
    report = {"size": side, "frames": frames, "card": smi,
              "render_ms_per_frame": render_ms,
              "create_video_ms_per_frame": video_ms,
              "encode_ms_per_frame": float(np.mean(each)),
              "encode_i_vop_ms": float(np.mean([e for e, k in zip(each, keys) if k])),
              "encode_p_vop_ms": float(np.mean([e for e, k in zip(each, keys) if not k])),
              "encode_ms_each": each, "profile_ms_per_frame": where, "file": check}
    emit({"phase": "video", **report})
    print(f"video encoder {side}x{side}: {report['encode_ms_per_frame']:.3f} ms a frame "
          f"(I-VOP {report['encode_i_vop_ms']:.3f}, P-VOP {report['encode_p_vop_ms']:.3f}; "
          f"with the PNG reads {video_ms:.3f}) on the host of {smi}", flush=True)
    return report


def phase_serve_timing(cfg, model, out_dir, device, side=800, frames=4):
    """One 800x800 medium frame four ways, in one call: render_frame alone
    (median of 3 after a warm-up frame); the frame loop as it was before
    the I/O overlap (render, fetch, two PNG encodes, one frame after
    another: ms a frame over ``frames``); render_path, which overlaps the
    fetch and the encodes with the next frame (ms a frame over ``frames``
    after a warm-up call of one frame), without an effect, with Fog and with
    Toon Shader, and without an effect over 3 x ``frames``; then
    apply_effect_to_frames' timings (Toon Shader) over an aligned spiral of
    ``frames`` 800x800 frames."""
    import numpy as np
    import torch

    from danerf_tpu_torch.fx.batch import apply_effect_to_frames
    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.render.frames import render_aligned_spiral, render_path
    from danerf_tpu_torch.render.renderer import render_frame
    from danerf_tpu_torch.viz.depth import colorize_depth
    from danerf_tpu_torch.viz.paths import camera_path
    from danerf_tpu_torch.viz.png import write_png

    emb = torch.randn(cfg.appearance_dim, generator=torch.Generator().manual_seed(3))
    focal = 0.5 * side / np.tan(0.5 * 0.6911)
    c2ws = camera_path("circle", frames, cfg.scene)
    chunks = -(-side * side // cfg.render_chunk)
    work = os.path.join(out_dir, "serve_timing")

    def frame(i):
        gen = torch.Generator(device=device).manual_seed(i)
        return render_frame(model, cfg, c2ws[i % frames], side, side, focal,
                            appearance_embedding=emb, perturb=True, generator=gen,
                            device=device)

    frame(0)
    torch.cuda.synchronize()
    alone = []
    for i in range(3):
        t0 = time.perf_counter()
        frame(i)
        torch.cuda.synchronize()
        alone.append((time.perf_counter() - t0) * 1e3)

    serial_dir = os.path.join(work, "serial")
    os.makedirs(serial_dir, exist_ok=True)
    t0 = time.perf_counter()
    for i in range(frames):
        gen = torch.Generator(device=device).manual_seed(i)
        rgb, depth, _ = render_frame(model, cfg, c2ws[i], side, side, focal,
                                     appearance_embedding=emb, perturb=True,
                                     generator=gen, device=device)
        rgb_u8 = (rgb * 255.0).clamp(0, 255).to(torch.uint8).cpu().numpy()
        depth_np = depth.cpu().numpy()
        write_png(os.path.join(serial_dir, f"rgb_{i:03d}.png"), rgb_u8)
        write_png(os.path.join(serial_dir, f"depth_{i:03d}.png"), colorize_depth(depth_np))
    serial = (time.perf_counter() - t0) * 1e3 / frames

    paths = {}
    # the last frame's PNGs are written after its render: over ``frames``
    # frames that tail is part of each frame's ms; 3 x ``frames`` without an
    # effect shows the steady state
    for effect, n in ((None, frames), ("Fog", frames), ("Toon Shader", frames),
                      (None, 3 * frames)):
        tag = f"{effect or 'none'} x {n}"
        run_dir = os.path.join(work, tag.lower().replace(" ", "_"))
        kw = dict(appearance_embedding=emb, quality="medium", width=side, height=side,
                  effect=effect, device=device)
        render_path(model, cfg, run_dir + "_warm", num_frames=1, **kw)
        fr.reset_launch_counts()
        t0 = time.perf_counter()
        written = render_path(model, cfg, run_dir, num_frames=n, **kw)
        ms = (time.perf_counter() - t0) * 1e3 / n
        counts = dict(fr.LAUNCHES)
        serve_launches(counts, chunks * n)
        if len(written) != n:
            raise AssertionError(f"render_path {tag}: {len(written)} frames")
        paths[tag] = {"ms_per_frame": ms, "launches": counts}

    spiral_dir = os.path.join(work, "spiral")
    fr.reset_launch_counts()
    t0 = time.perf_counter()
    render_aligned_spiral(model, cfg, spiral_dir, appearance_embedding=emb, num_frames=frames,
                          height=side, width=side, make_video=False, device=device)
    spiral_ms = (time.perf_counter() - t0) * 1e3 / frames
    spiral_launches = dict(fr.LAUNCHES)
    serve_launches(spiral_launches, chunks * frames)
    batch = {}
    apply_effect_to_frames(spiral_dir, os.path.join(work, "batch", "toon_shader"),
                           "Toon Shader", make_video=False, timings=batch, device=device)
    if batch["frames"] != frames:
        raise AssertionError(f"apply_effect_to_frames timed {batch}")
    report = {"size": side, "frames": frames, "render_frame_ms": sorted(alone)[1],
              "render_frame_each_ms": alone,
              "serial_loop_ms_per_frame": serial, "render_path": paths,
              "spiral_ms_per_frame": spiral_ms, "spiral_launches": spiral_launches,
              "batch_toon_shader": batch}
    emit({"phase": "serve_timing", **report})
    return report


# Each eval run of phase_eval: (checkpoint's training path, flags beyond
# --checkpoint/--max_views/--device).
EVAL_RUNS = (("hier", ["--split", "val"]),
             ("hier", ["--split", "val", "--optimize_embeddings"]),
             ("hier", ["--split", "train"]),
             ("hier", ["--split", "val", "--optimize_embeddings", "--num_importance", "0"]),
             ("white", ["--split", "val", "--white_background"]),
             ("white", ["--split", "val", "--white_background", "--optimize_embeddings"]),
             ("white", ["--split", "train", "--white_background"]),
             ("time", ["--split", "val", "--use_time"]),
             ("time", ["--split", "val", "--use_time", "--optimize_embeddings"]),
             ("time", ["--split", "train", "--use_time"]))
EVAL_VIEWS = 2
EVAL_OPT_STEPS = 50
# per view, the kernel route against the plain route (--no_pallas) on the card
EVAL_TOL = {"psnr_db": 0.1, "ssim": 0.005}


def eval_launches(flags, views, size=100):
    """The launches of `eval` over ``views`` views of size x size: one K2 and
    one K5 a chunk of the frame (K2 alone under --num_importance 0); with
    --optimize_embeddings also, a view, EVAL_OPT_STEPS x (K2 + K5 + K6 +
    K3) of the fit (K2 + K3 under --num_importance 0)."""
    from danerf_tpu_torch.kernels import fused_render as fr

    chunks = -(-size * size // 65536)
    coarse = "--num_importance" in flags and flags[flags.index("--num_importance") + 1] == "0"
    frame = {"march": chunks} if coarse else {"march": chunks, "merged": chunks}
    step = ({"march": 1, "march_bwd": 1} if coarse
            else {"march": 1, "merged": 1, "merged_bwd": 1, "march_bwd": 1})
    fit = EVAL_OPT_STEPS if "--optimize_embeddings" in flags else 0
    return {k: views * (frame.get(k, 0) + fit * step.get(k, 0)) for k in fr.LAUNCHES}


def phase_eval(out_dir):
    """`cli.main eval` on the checkpoints phase_train wrote (64 + 64, white
    background, use_time; the procedural scene, 100x100 views): --max_views
    2 of --split val with and without --optimize_embeddings (the fit: 50
    Adam steps a view, one CUDA-graph replay), of --split train (each view
    its own embedding), and a fit under --num_importance 0.  Each run with
    exactly its launches (eval_launches; zeroed just before, read just
    after) and, per view, within EVAL_TOL of the same command with
    --no_pallas on the card, which launches nothing.  Then one view's
    graph fit against its eager fit, bit for bit, and the fit's launches
    per replay."""
    import numpy as np
    import torch

    from danerf_tpu_torch.cli.main import main as cli_main
    from danerf_tpu_torch.config import NeRFConfig
    from danerf_tpu_torch.data.dataset import load_dataset
    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.train.evaluate import EmbeddingFit, _target, left_half_rays, fit_seed
    from danerf_tpu_torch.utils.checkpoint import load_model

    runs, totals = [], {k: 0 for k in fr.LAUNCHES}
    for path, flags in EVAL_RUNS:
        ckpt = os.path.join(out_dir, f"train_{path}", "checkpoint_final.pt")
        argv = ["eval", "--checkpoint", ckpt, "--dataset_path",
                scene_path(out_dir, path == "time"), "--max_views",
                str(EVAL_VIEWS), "--device", "cuda", *flags]
        fr.reset_launch_counts()
        t0 = time.perf_counter()
        got = cli_main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(fr.LAUNCHES)
        want = eval_launches(flags, EVAL_VIEWS)
        if counts != want:
            raise AssertionError(f"eval {path} {flags}: launches {counts}, expected {want}")
        for k, v in counts.items():
            totals[k] += v
        fr.reset_launch_counts()
        plain = cli_main([*argv, "--no_pallas"])
        torch.cuda.synchronize()
        if any(fr.LAUNCHES.values()):
            raise AssertionError(f"eval --no_pallas launched {fr.LAUNCHES}")
        deltas = []
        for g, p in zip(got["per_view"], plain["per_view"]):
            d = {"psnr_db": abs(g["psnr"] - p["psnr"]), "ssim": abs(g["ssim"] - p["ssim"])}
            if not (np.isfinite(g["psnr"]) and all(d[k] <= EVAL_TOL[k] for k in d)):
                raise AssertionError(f"eval {path} {flags}: view {g['view']} kernel {g}, "
                                     f"plain {p}")
            deltas.append(d)
        want_protocol = ("left-half-optimized, right-half-scored"
                         if "--optimize_embeddings" in flags else "full-image")
        if got["protocol"] != want_protocol or got["n_views"] != EVAL_VIEWS:
            raise AssertionError(f"eval {path} {flags}: {got['protocol']}, {got['n_views']}")
        runs.append({"path": path, "flags": flags, "seconds": secs, "launches": counts,
                     "psnr": [v["psnr"] for v in got["per_view"]],
                     "ssim": [v["ssim"] for v in got["per_view"]],
                     "plain_psnr": [v["psnr"] for v in plain["per_view"]],
                     "plain_ssim": [v["ssim"] for v in plain["per_view"]],
                     "max_delta": {k: max(d[k] for d in deltas) for k in EVAL_TOL}})

    # one view's fit as a graph replay against the same fit run eagerly
    cfg = NeRFConfig(dataset_path=scene_path(out_dir))
    ds = load_dataset(cfg, "val")
    model, _, _, cfg = load_model(os.path.join(out_dir, "train_hier", "checkpoint_final.pt"),
                                  cfg, "cuda")
    model.requires_grad_(False)
    dev = torch.device("cuda")
    rays_o, rays_d = left_half_rays(ds.c2ws[0], ds.height, ds.width, ds.focal, dev)
    gt = torch.from_numpy(ds.images[0]).to(dev)
    target = _target(gt, None)[:, :ds.width // 2].reshape(-1, 3)
    fits = {}
    for graph in (True, False):
        fit = EmbeddingFit(model, cfg, rays_o.shape[0], EVAL_OPT_STEPS, device=dev, graph=graph)
        idx = torch.randint(0, rays_o.shape[0], (EVAL_OPT_STEPS, fit.batch), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(fit_seed(0, 0)))
        fr.reset_launch_counts()
        fits[graph] = (fit(rays_o, rays_d, target, idx), fit(rays_o, rays_d, target, idx))
        torch.cuda.synchronize()
        fits[f"launches_{graph}"] = dict(fr.LAUNCHES)
    (g1, g2), (e1, e2) = fits[True], fits[False]
    if not (torch.equal(g1, e1) and torch.equal(g2, e2) and torch.equal(g1, g2)):
        raise AssertionError(f"graph fit {g1.tolist()} != eager fit {e1.tolist()}")
    per_fit = eval_launches(["--optimize_embeddings"], 1, size=0)
    for graph in (True, False):
        want = {k: 2 * v for k, v in per_fit.items()}
        if fits[f"launches_{graph}"] != want:
            raise AssertionError(f"fit (graph={graph}) launches {fits[f'launches_{graph}']}, "
                                 f"expected {want}")
    emit({"phase": "eval", "views": EVAL_VIEWS, "opt_steps": EVAL_OPT_STEPS, "tol": EVAL_TOL,
          "runs": runs, "launches_total": totals, "graph_fit_equals_eager_fit": True,
          "fit_embedding_norm": float(g1.norm()), "launches_per_fit": per_fit})
    return totals


def eval_timing_scene(side, views, seed=0):
    """A RayDataset of ``views`` seeded random side x side images on the
    procedural scene's first poses (the content does not matter for time)."""
    import numpy as np

    from danerf_tpu_torch.data.dataset import RayDataset
    from danerf_tpu_torch.data.synthetic import SYNTHETIC_FOV, make_synthetic_scene

    poses = make_synthetic_scene(split="val", n_images=views, height=8, width=8,
                                 n_samples=4).c2ws
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (views, side, side, 3), dtype=np.uint8)
    return RayDataset(imgs, np.full((views, side, side), 255, np.uint8), poses,
                      float(0.5 * side / np.tan(0.5 * SYNTHETIC_FOV)), 2.0, 6.0, "val")


def phase_eval_timing(cfg, model, device, side=800, views=2):
    """evaluate() at side x side on the seeded model, in one call: ms a view
    over ``views`` views (after a warm-up call of one view) without and
    with the embedding fit (each call captures the fit once and replays it
    a view); the fit alone, eagerly and as a graph replay (median of 3
    after a warm-up), and a replay's device-busy ms over one torch.profiler
    window (after the other timings: a window slows later eager launches,
    PERF.md section 7); render_frame alone and with the score
    (_score_view) beside it."""
    import torch

    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.render.renderer import render_frame
    from danerf_tpu_torch.train.evaluate import EmbeddingFit, _score_view, left_half_rays
    from danerf_tpu_torch.train.evaluate import evaluate

    ds = eval_timing_scene(side, views)
    table = torch.randn(views, cfg.appearance_dim, generator=torch.Generator().manual_seed(5))
    chunks = -(-side * side // cfg.render_chunk)
    per_view = {}
    for fit in (False, True):
        evaluate(model, cfg, ds, appearance=table, max_views=1, optimize_embeddings=fit,
                 device=device)
        fr.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = evaluate(model, cfg, ds, appearance=table, optimize_embeddings=fit,
                       device=device)
        ms = (time.perf_counter() - t0) * 1e3 / views
        want = {k: views * (chunks + (EVAL_OPT_STEPS if fit else 0))
                if k in ("march", "merged") else
                views * EVAL_OPT_STEPS if fit and k in ("merged_bwd", "march_bwd") else 0
                for k in fr.LAUNCHES}
        if dict(fr.LAUNCHES) != want:
            raise AssertionError(f"eval_timing fit={fit}: launches {fr.LAUNCHES}, "
                                 f"expected {want}")
        per_view["fit" if fit else "no_fit"] = {"ms_per_view": ms, "psnr": res["psnr"],
                                               "launches": dict(fr.LAUNCHES)}

    dev = torch.device(device)
    rays_o, rays_d = left_half_rays(ds.c2ws[0], side, side, ds.focal, dev)
    target = torch.rand(rays_o.shape[0], 3, generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev)
    idx = torch.randint(0, rays_o.shape[0], (EVAL_OPT_STEPS, 1024), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(2))
    fit_ms = {}
    fits = {}
    for graph in (False, True):
        fit = EmbeddingFit(model, cfg, rays_o.shape[0], EVAL_OPT_STEPS, device=dev, graph=graph)
        fits[graph] = fit
        fit(rays_o, rays_d, target, idx)
        each = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit(rays_o, rays_d, target, idx)
            torch.cuda.synchronize()
            each.append((time.perf_counter() - t0) * 1e3)
        fit_ms["graph" if graph else "eager"] = {"ms": sorted(each)[1], "each_ms": each}

    c2w = ds.c2ws[0]
    gt = torch.from_numpy(ds.images[0]).to(dev)
    emb = table[0].to(dev)

    def frame():
        return render_frame(model, cfg, c2w, side, side, ds.focal, appearance_embedding=emb,
                            perturb=False, device=dev)

    def frame_scored():
        rgb, _, _ = frame()
        return _score_view(rgb, gt, side // 2, False)

    frame_ms = {}
    for name, fn in (("render_frame", frame), ("render_and_score", frame_scored)):
        fn()
        each = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            each.append((time.perf_counter() - t0) * 1e3)
        frame_ms[name] = {"ms": sorted(each)[1], "each_ms": each}
    busy = {name: profile_steps(lambda f=fits[g]: f(rays_o, rays_d, target, idx), n_prof=1)
            for name, g in (("graph", True), ("eager", False))}
    report = {"size": side, "views": views, "opt_steps": EVAL_OPT_STEPS, "batch": 1024,
              "evaluate": per_view, "fit": fit_ms, "frame": frame_ms,
              "fit_device_busy_ms": {k: v["profile_device_busy_ms_per_step"]
                                     for k, v in busy.items()},
              "fit_idle_share": {k: v["profile_idle_share"] for k, v in busy.items()},
              "fit_profile": {k: v["profile_ms_per_step"][:8] for k, v in busy.items()}}
    emit({"phase": "eval_timing", **report})
    return report


# The fixtures of the loaders phase beside frame.jpg / frame_rgba.png, each
# with the digests of PIL's pixels (tests/data_torch/README.md says how each
# was made): what read_png or read_jpeg gives under its own name, and a PNG's
# convert("RGB") (read_rgb) under "NAME rgb"
LOADER_FIXTURES = ("frame_progressive.jpg", "gray_progressive.jpg", "picture_800.jpg",
                   "picture_800_progressive.jpg", "palette_trns.png", "rgba16.png",
                   "adam7_rgb.png", "gray2.png")
# the custom scene (three frames to train on, the last to validate on) and the
# Blender scene of the fixtures
LOADER_CUSTOM = ("frame_progressive.jpg", "palette_trns.png", "gray_progressive.jpg",
                 "adam7_rgb.png")
LOADER_BLENDER = ("rgba16.png", "adam7_rgb.png", "palette_trns.png")
LOADER_TRAIN_ITERS = {"custom": 50, "blender": 30, "formats": 50}
# tests/data_torch/formats/: BMP, Netpbm, TIFF, GIF and WebP (lossless, and
# lossy with and without ALPH) files, each with the digests (dtype, shape,
# sha256) of PIL's opened array under its name, of its convert("RGB") under
# "NAME rgb" and, for a depth map, of the JAX preview's depth array under
# "NAME depth" (tests/test_torch_images.py format_fixture_bytes says how each
# was made); the 800x800 picture as LZW + predictor TIFF, GIF and lossless
# WebP, and picture_800.jpg's pixels as lossy WebP, are timed beside
# picture_800.jpg
FORMATS_DIR = os.path.join("tests", "data_torch", "formats")
FORMAT_FIXTURES = ("frame.bmp", "frame_rle8.bmp", "frame_565.bmp", "frame.ppm", "gray16.pgm",
                   "frame_lzw.tif", "frame_tiled.tif", "gray16_mm.tif", "frame.gif",
                   "frame_interlaced.gif", "frame.webp", "frame_rgba.webp",
                   "picture_800_lzw.tif", "picture_800.gif", "picture_800.webp",
                   "frame_lossy.webp", "frame_lossy_rgba.webp", "picture_800_lossy.webp")
FORMAT_DEPTHS = ("depth.jpg", "depth_palette.png", "depth_1bit.png", "depth.gif",
                 "depth_lossy.webp")
FORMAT_800 = ("picture_800_lzw.tif", "picture_800.gif", "picture_800.webp",
              "picture_800_lossy.webp")
# the custom scene of the new formats (six frames to train on, the last to
# validate on) and the picture the depth maps go with
FORMAT_CUSTOM = ("frame_rle8.bmp", "frame_tiled.tif", "frame_interlaced.gif", "frame.ppm",
                 "frame_lossy.webp", "frame_lossy_rgba.webp", "frame.webp")
FORMAT_PICTURE = "frame.bmp"


def _digest(a, typed=False):
    """{shape, sha256} of an array's bytes (with ``typed``, its dtype too)."""
    import hashlib

    import numpy as np

    a = np.ascontiguousarray(a)
    d = {"shape": list(a.shape), "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
    return {"dtype": a.dtype.str, **d} if typed else d


def _median_ms(fn, reps=3):
    each = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        each.append((time.perf_counter() - t0) * 1e3)
    return out, sorted(each)[reps // 2], each


def _loader_rows(save, iters, warmup=5):
    """metrics.jsonl of a run: one row a step, finite losses; the PSNR means
    of the first and last quarter after the warm-up."""
    import numpy as np

    with open(os.path.join(save, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    if [r["step"] for r in rows] != list(range(1, iters + 1)):
        raise AssertionError(f"loaders: {save}/metrics.jsonl does not hold one row a step")
    if not all(math.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"loaders: a logged loss of {save} is not finite")
    q = (iters - warmup) // 4
    return {"loss_first": rows[0]["loss"], "loss_last": rows[-1]["loss"],
            "psnr_first": float(np.mean([r["psnr"] for r in rows[warmup:warmup + q]])),
            "psnr_last": float(np.mean([r["psnr"] for r in rows[-q:]]))}


def _fixture_scene_poses(n):
    from danerf_tpu_torch.data.synthetic import make_synthetic_scene

    return make_synthetic_scene(split="train", n_images=n, height=8, width=8,
                                n_samples=4).c2ws


def phase_loaders(out_dir):
    """The port's own loaders on the card's host (no imaging library there).

    Each committed fixture (tests/data_torch/) decoded and held against the
    sha256 of PIL's pixels stored beside it (pil_digests.json, computed
    where PIL is), with its ms (median of 3): the baseline frame.jpg (4:2:0,
    a restart interval), the fixture RGBA PNG and its Lanczos downscale by
    8, and LOADER_FIXTURES: progressive JPEGs (frame.jpg's pixels, 4:2:0
    with restarts; gray), an 800x800 picture baseline and progressive (the
    two decodes side by side), a 4-bit palette PNG with tRNS, a 16-bit
    RGBA, an Adam7 RGB and a 2-bit gray PNG (read_png, and read_rgb against
    PIL's convert("RGB")).  A custom scene of frame.jpg and a PNG through
    load_dataset, as before.  Then two entry points at full width on
    scenes of those files (the procedural scene's poses):

    - the library's train() (neither CLI has a dataset-type flag) on a
      custom scene of the progressive JPEGs and the palette and Adam7 PNGs
      (dataset_type="custom"; its images equal PIL's digests), 50 steps of
      64 + 64: exactly one K2, K4 and K3 launch a step, finite losses, a
      rising PSNR; then evaluate() of its checkpoint on the val view with
      the embedding fit (one K2 and one K5 for the view, K2, K5, K6 and K3
      a fit step), within EVAL_TOL of the same call with use_kernels off;
    - the same train() and evaluate() on a custom scene of an RLE8 BMP, a
      tiled planar Deflate TIFF, an interlaced GIF, a PPM, a lossy RGB and
      a lossy RGBA WebP and a lossless WebP (``_format_loaders``, which
      first decodes every fixture of tests/data_torch/formats/ through the
      one reader against PIL's digests with its ms, and afterwards loads a
      JPEG, a palette PNG, a 1-bit PNG, a GIF and a lossy WebP depth map to
      the JAX preview's depth arrays and runs `preview` on the card with
      each);
    - `cli.main train` on a Blender scene (transforms_train.json) of the
      16-bit RGBA, Adam7 and palette + tRNS PNGs, 30 steps: the frames'
      alphas in the dataset (PIL's), exactly one K2, K4 and K3 a step,
      finite losses.

    Returns the launches of the five runs."""
    import shutil

    import numpy as np
    import torch

    from danerf_tpu_torch.cli.main import main as cli_main
    from danerf_tpu_torch.config import NeRFConfig
    from danerf_tpu_torch.data.custom import read_rgb
    from danerf_tpu_torch.data.dataset import load_dataset
    from danerf_tpu_torch.data.jpeg import read_jpeg
    from danerf_tpu_torch.data.png import read_png
    from danerf_tpu_torch.data.resize import lanczos_resize
    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.viz.png import write_png

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data_torch")
    with open(os.path.join(data, "pil_digests.json")) as f:
        stored = json.load(f)
    jpg, png = os.path.join(data, "frame.jpg"), os.path.join(data, "frame_rgba.png")

    def held(key, out):
        got = _digest(out)
        if got != stored[key]:
            raise AssertionError(f"loaders: {key} gives {got}, PIL {stored[key]}")

    rgba = read_png(png)
    report = {}
    for name, key, fn in (
            ("jpeg_decode", "frame.jpg", lambda: read_jpeg(jpg)),
            ("png_decode", None, lambda: read_png(png)),
            ("lanczos_8", "frame_rgba.png lanczos 8",
             lambda: lanczos_resize(rgba, rgba.shape[1] // 8, rgba.shape[0] // 8))):
        out, ms, each = _median_ms(fn)
        if key is not None:
            held(key, out)
        report[name] = {"ms": ms, "each_ms": each, "shape": list(out.shape),
                        "held_against_pil": key is not None}
    fixtures = {}
    for name in LOADER_FIXTURES:
        path = os.path.join(data, name)
        read = read_jpeg if name.endswith(".jpg") else read_png
        out, ms, each = _median_ms(lambda: read(path))
        held(name, out)
        fixtures[name] = {"ms": ms, "each_ms": each, "shape": list(out.shape),
                          "dtype": str(out.dtype)}
        if name.endswith(".png"):
            held(f"{name} rgb", read_rgb(path))
    report["fixtures"] = fixtures
    base, prog = (fixtures[f"picture_800{s}.jpg"]["ms"] for s in ("", "_progressive"))
    report["decode_800x800"] = {"baseline_ms": base, "progressive_ms": prog,
                                "progressive_over_baseline": prog / base}

    scene = os.path.join(out_dir, "custom_scene")
    shutil.rmtree(scene, ignore_errors=True)
    images = os.path.join(scene, "images")
    os.makedirs(images)
    shutil.copy(jpg, os.path.join(images, "a.jpg"))
    shutil.copy(jpg, os.path.join(images, "c.jpg"))
    rgb = read_jpeg(jpg)[::-1].copy()
    write_png(os.path.join(images, "b.png"), rgb)
    frames = [{"file_path": n, "transform_matrix": np.eye(4).tolist()}
              for n in ("a.jpg", "b.png", "c.jpg")]
    with open(os.path.join(scene, "transforms.json"), "w") as f:
        json.dump({"camera_angle_x": 0.6911, "frames": frames}, f)
    cfg = NeRFConfig(dataset_type="custom", dataset_path=images)
    t0 = time.perf_counter()
    train_ds = load_dataset(cfg, "train")
    val = load_dataset(cfg, "val")
    load_ms = (time.perf_counter() - t0) * 1e3
    if (train_ds.images.shape != (2,) + tuple(stored["frame.jpg"]["shape"])
            or not np.array_equal(train_ds.images[1], rgb) or val.n_images != 1
            or not np.array_equal(val.images[0], train_ds.images[0])
            or not (train_ds.alphas == 255).all()):
        raise AssertionError(f"loaders: the custom scene loads as {train_ds.images.shape}")
    report["custom_scene"] = {"train": list(train_ds.images.shape),
                              "val": list(val.images.shape), "focal": train_ds.focal,
                              "load_ms": load_ms}

    per_step = PATHS["hier"][1]
    launches = {}
    # the library's train() on a custom scene of the progressive JPEGs and
    # the palette and Adam7 PNGs, then evaluate() with the fit
    report["custom_train"], launches["custom_train"], launches["custom_eval"] = \
        _train_custom_scene(data, LOADER_CUSTOM, os.path.join(out_dir, "custom_fixture"),
                            LOADER_TRAIN_ITERS["custom"],
                            lambda name, img: held(name if name.endswith(".jpg")
                                                   else f"{name} rgb", img))
    # the same on a custom scene of BMP, TIFF, GIF, PPM, lossy and lossless WebP
    # frames; every new fixture decoded on this host against PIL's digests;
    # the depth maps the JAX preview reads through PIL, through `preview`
    report["formats"], fmt_launches = _format_loaders(out_dir)
    launches.update(fmt_launches)

    # `cli.main train` on a Blender scene of the 16-bit RGBA, Adam7 and
    # palette + tRNS PNGs
    root = os.path.join(out_dir, "blender_fixture_scene")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "fixtures", "train"))
    frames = []
    for i, (name, c2w) in enumerate(zip(LOADER_BLENDER, _fixture_scene_poses(3))):
        shutil.copy(os.path.join(data, name), os.path.join(root, "fixtures", "train",
                                                           f"r_{i}.png"))
        frames.append({"file_path": f"./train/r_{i}",
                       "transform_matrix": np.asarray(c2w).tolist()})
    with open(os.path.join(root, "fixtures", "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": 0.6911, "frames": frames}, f)
    ds = load_dataset(NeRFConfig(dataset_path=root, scene="fixtures"), "train")
    for i, name in enumerate(LOADER_BLENDER):
        want_px = read_png(os.path.join(data, name))
        held(name, np.concatenate([ds.images[i], ds.alphas[i][..., None]], -1)
             if want_px.shape[-1] == 4 else ds.images[i])
        if want_px.shape[-1] != 4 and not (ds.alphas[i] == 255).all():
            raise AssertionError(f"loaders: Blender frame {name} has alphas below 255")
    if not (ds.alphas < 255).any():
        raise AssertionError("loaders: no alpha of the Blender scene reached the dataset")
    iters = LOADER_TRAIN_ITERS["blender"]
    save = os.path.join(out_dir, "train_blender_fixtures")
    shutil.rmtree(save, ignore_errors=True)
    fr.reset_launch_counts()
    t0 = time.perf_counter()
    cli_main(["train", "--dataset_path", root, "--scene", "fixtures", "--iters", str(iters),
              "--save_dir", save, "--device", "cuda", "--seed", "0", "--density_bias_init",
              "0.5"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches["blender_train"] = dict(fr.LAUNCHES)
    if launches["blender_train"] != launches_of(per_step, iters):
        raise AssertionError(f"loaders: Blender train launches {launches['blender_train']}, "
                             f"expected {launches_of(per_step, iters)}")
    report["blender_train"] = {"frames": list(LOADER_BLENDER), "iters": iters,
                               "seconds": secs, "launches": launches["blender_train"],
                               "alpha_below_255_share": float((ds.alphas < 255).mean()),
                               **_loader_rows(save, iters)}
    emit({"phase": "loaders", **report})
    return launches


def _train_custom_scene(data, names, root, iters, held):
    """The library's train() (neither CLI has a dataset-type flag) on a
    custom scene of the fixtures ``names`` in ``data`` (the procedural
    scene's poses; the last frame validates), 64 + 64 at full width:
    exactly one K2, K4 and K3 launch a step, finite losses, a rising PSNR;
    then evaluate() of its checkpoint on the val view with the embedding
    fit (one K2 and one K5 for the view, K2, K5, K6 and K3 a fit step),
    within EVAL_TOL of the same call with use_kernels off.  ``held(name,
    image)`` checks each loaded frame.  Returns (report, train launches,
    evaluate launches)."""
    import shutil

    import numpy as np
    import torch

    from danerf_tpu_torch.config import NeRFConfig
    from danerf_tpu_torch.data.dataset import load_dataset
    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.train.evaluate import evaluate
    from danerf_tpu_torch.train.trainer import train
    from danerf_tpu_torch.utils.checkpoint import load_model

    per_step = PATHS["hier"][1]
    shutil.rmtree(root, ignore_errors=True)
    images = os.path.join(root, "scene", "images")
    os.makedirs(images)
    frames = []
    for name, c2w in zip(names, _fixture_scene_poses(len(names))):
        shutil.copy(os.path.join(data, name), os.path.join(images, name))
        frames.append({"file_path": name, "transform_matrix": np.asarray(c2w).tolist()})
    with open(os.path.join(root, "scene", "transforms.json"), "w") as f:
        json.dump({"camera_angle_x": 0.6911, "frames": frames}, f)
    cfg = NeRFConfig(dataset_type="custom", dataset_path=images, density_bias_init=0.5)
    t0 = time.perf_counter()
    ds, val = load_dataset(cfg, "train"), load_dataset(cfg, "val")
    load_ms = (time.perf_counter() - t0) * 1e3
    for img, name in zip([*ds.images, *val.images], names):
        held(name, img)
    save = os.path.join(root, "train")
    fr.reset_launch_counts()
    t0 = time.perf_counter()
    train(cfg, ds, save_dir=save, num_iterations=iters, seed=0, device="cuda",
          log_path=os.path.join(save, "metrics.jsonl"))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    train_launches = dict(fr.LAUNCHES)
    if train_launches != launches_of(per_step, iters):
        raise AssertionError(f"loaders: custom train() on {names} launches {train_launches}, "
                             f"expected {launches_of(per_step, iters)}")
    rows = _loader_rows(save, iters)
    if not rows["psnr_last"] > rows["psnr_first"]:
        raise AssertionError(f"loaders: custom train() on {names}: PSNR did not rise {rows}")
    model, _, _, mcfg = load_model(os.path.join(save, "checkpoint_final.pt"), cfg, "cuda")
    model.requires_grad_(False)
    evals = {}
    for route, c in (("kernel", mcfg), ("plain", mcfg.replace(use_kernels=False))):
        fr.reset_launch_counts()
        res = evaluate(model, c, val, max_views=1, optimize_embeddings=True,
                       opt_steps=EVAL_OPT_STEPS, device="cuda")
        torch.cuda.synchronize()
        evals[route] = {"launches": dict(fr.LAUNCHES), "psnr": res["per_view"][0]["psnr"],
                        "ssim": res["per_view"][0]["ssim"], "protocol": res["protocol"]}
    chunks = -(-val.height * val.width // mcfg.render_chunk)
    want = {k: v + (chunks if k in ("march", "merged") else 0)
            for k, v in eval_launches(["--optimize_embeddings"], 1, size=0).items()}
    delta = {k: abs(evals["kernel"][k.split("_")[0]] - evals["plain"][k.split("_")[0]])
             for k in EVAL_TOL}
    if (evals["kernel"]["launches"] != want or any(evals["plain"]["launches"].values())
            or not math.isfinite(evals["kernel"]["psnr"])
            or not all(delta[k] <= EVAL_TOL[k] for k in EVAL_TOL)):
        raise AssertionError(f"loaders: evaluate on the custom scene of {names}: {evals}, "
                             f"expected launches {want}, within {EVAL_TOL}")
    report = {"frames": list(names), "load_ms": load_ms, "shape": list(ds.images.shape),
              "iters": iters, "seconds": secs, "launches": train_launches, **rows,
              "evaluate": evals, "evaluate_delta": delta, "tol": EVAL_TOL}
    return report, train_launches, evals["kernel"]["launches"]


def _format_loaders(out_dir):
    """The one image reader (data/images.py) on this host, which has no
    imaging library: every fixture of FORMATS_DIR through read_array and
    read_rgb against PIL's digests (dtype included), read_array's ms (median
    of 3) beside the 800x800 JPEG's; the custom scene of FORMAT_CUSTOM
    through train() and evaluate() (``_train_custom_scene``); each of the
    FORMAT_DEPTHS depth maps through load_depth against the JAX preview's
    depth array and through `preview` on the card with Fog (depth-aware).
    Returns (report, launches)."""
    import shutil

    from danerf_tpu_torch.cli.main import main as cli_main
    from danerf_tpu_torch.data.images import read_array, read_rgb
    from danerf_tpu_torch.data.jpeg import read_jpeg
    from danerf_tpu_torch.fx.batch import load_depth

    root = os.path.dirname(os.path.abspath(__file__))
    data = os.path.join(root, FORMATS_DIR)
    with open(os.path.join(data, "pil_digests.json")) as f:
        stored = json.load(f)

    def held(key, out):
        got = _digest(out, typed=True)
        if got != stored[key]:
            raise AssertionError(f"loaders: {key} gives {got}, PIL {stored[key]}")

    report, decodes = {}, {}
    for name in FORMAT_FIXTURES + FORMAT_DEPTHS:
        path = os.path.join(data, name)
        out, ms, each = _median_ms(lambda: read_array(path))
        held(name, out)
        held(f"{name} rgb", read_rgb(path))
        decodes[name] = {"ms": ms, "each_ms": each, "shape": list(out.shape),
                         "dtype": str(out.dtype)}
    report["decodes"] = decodes
    jpg = os.path.join(root, "tests", "data_torch", "picture_800.jpg")
    _, jpeg_ms, _ = _median_ms(lambda: read_jpeg(jpg))
    report["decode_800x800"] = {"jpeg_baseline_ms": jpeg_ms, **{
        name: {"ms": decodes[name]["ms"], "over_jpeg": decodes[name]["ms"] / jpeg_ms}
        for name in FORMAT_800}}

    launches = {}
    report["custom_train"], launches["formats_train"], launches["formats_eval"] = \
        _train_custom_scene(data, FORMAT_CUSTOM, os.path.join(out_dir, "custom_formats"),
                            LOADER_TRAIN_ITERS["formats"],
                            lambda name, img: held(f"{name} rgb", img))

    prev = os.path.join(out_dir, "preview_depths")
    shutil.rmtree(prev, ignore_errors=True)
    os.makedirs(prev)
    spec = os.path.join(prev, "spec.json")
    with open(spec, "w") as f:
        json.dump({"effects": [{"name": "Fog", "sweep": {"fog_start": [0.0, 0.4]}}]}, f)
    depths = {}
    for name in FORMAT_DEPTHS:
        path = os.path.join(data, name)
        d = load_depth(path)
        held(f"{name} depth", d)
        out = os.path.join(prev, name.replace(".", "_"))
        t0 = time.perf_counter()
        cli_main(["preview", "--image", os.path.join(data, FORMAT_PICTURE), "--depth", path,
                  "--spec", spec, "--output_dir", out, "--device", "cuda"])
        secs = time.perf_counter() - t0
        pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
        if len(pngs) != 2:
            raise AssertionError(f"loaders: preview with the depth map {name} wrote {pngs}")
        depths[name] = {"min": float(d.min()), "max": float(d.max()), "shape": list(d.shape),
                        "preview_s": secs, "previews": pngs}
    report["depths"] = depths
    return report, launches


# ---------------------------------------------------------------- JAX checkpoint

JAX_CHECKPOINT = os.path.join("tests", "data_torch", "jax_run", "checkpoint_000003")
JAX_RESUME_STEPS = 20


def phase_jax_checkpoint(out_dir, smi):
    """The JAX package's own checkpoint directory on the card's host, which
    has no JAX, orbax, tensorstore, zstd or msgpack library: the committed
    full-width fixture (JAX_CHECKPOINT: Orbax, an OCDBT store of zarr v2
    arrays with zstd chunks, 3 steps of the default widths; written by
    tests/data_torch/write_jax_checkpoint.py).

    - read_jax_checkpoint: every leaf held bit for bit against the sha256
      the JAX restore_checkpoint gave (jax_checkpoint_digests.json), the
      read timed (median of 3, warm file cache, on the card's host);
    - `cli.main render --checkpoint <dir>`: one 800x800 medium frame,
      exactly 10 K2 and 10 K5 and nothing else;
    - a 200x200 frame of the same model (render_frame), the kernel route
      against the plain route within SLICE_TOL;
    - `cli.main train --resume` in a copy of the fixture's save directory
      on its scene (make_synthetic_scene, 5 views at 16x16, written as a
      Blender scene): JAX_RESUME_STEPS more steps (the 2 warm-up steps of
      64 rays left, then 18 of B = 1024; 64 + 64), exactly one K2, K4 and
      K3 a step; its checkpoint at iteration 3 + 20, a finite loss, Adam's
      step count continued from the fixture's count."""
    import hashlib

    import numpy as np
    import torch

    from danerf_tpu_torch.cli.main import main as cli_main
    from danerf_tpu_torch.config import NeRFConfig
    from danerf_tpu_torch.data.blender import save_blender_scene
    from danerf_tpu_torch.data.dataset import scene_intrinsics
    from danerf_tpu_torch.data.synthetic import make_synthetic_scene
    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.render.renderer import render_frame
    from danerf_tpu_torch.utils.checkpoint import load_model, read_jax_checkpoint
    from danerf_tpu_torch.viz.paths import camera_path

    root = os.path.dirname(os.path.abspath(__file__))
    fixture = os.path.join(root, JAX_CHECKPOINT)
    with open(os.path.join(root, "tests", "data_torch", "jax_checkpoint_digests.json")) as f:
        digests = json.load(f)
    (tree, meta), read_ms, each = _median_ms(lambda: read_jax_checkpoint(fixture))
    leaves = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, prefix + [str(k)])
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, prefix + [str(i)])
        else:
            leaves[".".join(prefix)] = np.asarray(node)

    walk(tree, [])
    wrong = [name for name, d in digests["leaves"].items()
             if name not in leaves or leaves[name].dtype.name != d["dtype"]
             or list(leaves[name].shape) != d["shape"]
             or hashlib.sha256(leaves[name].tobytes()).hexdigest() != d["sha256"]]
    if wrong or sorted(leaves) != sorted(digests["leaves"]) or meta != digests["meta"]:
        raise AssertionError(f"jax_checkpoint: leaves {wrong} (of {len(leaves)}) differ from "
                             "the JAX restore_checkpoint's digests")
    store = os.path.join(fixture, "state")
    file_bytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(store)
                     for f in fs)
    report = {"read": {"ms": read_ms, "each_ms": each, "leaves": len(leaves),
                       "decoded_bytes": sum(x.nbytes for x in leaves.values()),
                       "file_bytes": file_bytes, "held_bit_for_bit": True, "card": smi}}

    # one 800x800 medium frame through `cli.main render --checkpoint <dir>`
    side = 800
    run_dir = os.path.join(out_dir, "jax_render")
    shutil.rmtree(run_dir, ignore_errors=True)
    fr.reset_launch_counts()
    t0 = time.perf_counter()
    written = cli_main(["render", "--checkpoint", fixture, "--output_dir", run_dir,
                        "--frames", "1", "--width", str(side), "--height", str(side),
                        "--quality", "medium", "--save_depth", "--device", "cuda", "--seed", "0",
                        "--dataset_path", os.path.join(out_dir, "no_scene")])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(fr.LAUNCHES)
    want = launches_of({"march": 10, "merged": 10})
    depth = np.load(os.path.join(run_dir, "raw", "depth_000.npy"))
    if counts != want or len(written) != 1 or depth.shape != (side, side) \
            or not np.isfinite(depth).all():
        raise AssertionError(f"jax_checkpoint render: launches {counts} (expected {want}), "
                             f"{written}, depth {depth.shape}")
    report["render_800"] = {"seconds": secs, "launches": counts, "quality": "medium"}

    # a 200x200 frame of the same model: the kernel route against the plain one
    cfg = NeRFConfig()
    model, table, _, cfg = load_model(fixture, cfg, "cuda")
    model.requires_grad_(False)
    intr = scene_intrinsics(cfg.replace(dataset_path=os.path.join(out_dir, "no_scene")))
    c2w = camera_path("circle", 1, cfg.scene)[0]
    frames = {}
    for route, c in (("kernel", cfg), ("plain", cfg.replace(use_kernels=False))):
        fr.reset_launch_counts()
        with torch.no_grad():
            rgb, dep, acc = render_frame(model, c, c2w, 200, 200, intr.focal * 200 / intr.width,
                                         appearance_embedding=table[0], device="cuda")
        torch.cuda.synchronize()
        frames[route] = ({"rgb": rgb, "depth": dep, "acc": acc}, dict(fr.LAUNCHES))
    errs = {k: max_err(frames["kernel"][0][k], frames["plain"][0][k]) for k in SLICE_TOL}
    mean_acc = float(frames["kernel"][0]["acc"].mean())
    if (not all(math.isfinite(errs[k]) and errs[k] <= t for k, t in SLICE_TOL.items())
            or any(frames["plain"][1].values()) or not frames["kernel"][1]["march"]
            or not mean_acc > 0.01):
        raise AssertionError(f"jax_checkpoint frame: kernel against plain {errs} > {SLICE_TOL}"
                             f", launches {frames['kernel'][1]} / {frames['plain'][1]}, "
                             f"mean acc {mean_acc}")
    report["frame_200"] = {"max_abs_err": errs, "tolerance": SLICE_TOL, "mean_acc": mean_acc,
                           "launches": frames["kernel"][1]}

    # `cli.main train --resume` in a copy of the fixture's save directory
    scene = os.path.join(out_dir, "jax_scene")
    shutil.rmtree(scene, ignore_errors=True)
    spec = digests["scene"]
    save_blender_scene(make_synthetic_scene("train", n_images=spec["n_images"],
                                            height=spec["height"], width=spec["width"],
                                            near=cfg.near, far=cfg.far, seed=0),
                       os.path.join(scene, "fixture"), "train")
    save = os.path.join(out_dir, "jax_resume")
    shutil.rmtree(save, ignore_errors=True)
    shutil.copytree(os.path.dirname(fixture), save)
    steps = digests["steps"]
    iters = steps + JAX_RESUME_STEPS
    count = int(np.asarray(tree["opt_state"][0]["count"]))
    fr.reset_launch_counts()
    t0 = time.perf_counter()
    cli_main(["train", "--dataset_path", scene, "--scene", "fixture", "--iters", str(iters),
              "--resume", "--save_dir", save, "--checkpoint_every", "0", "--device", "cuda",
              "--seed", "0", "--density_bias_init", str(digests["config"]["density_bias_init"])])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(fr.LAUNCHES)
    want = launches_of(PATHS["hier"][1], JAX_RESUME_STEPS)
    ckpt = torch.load(os.path.join(save, "checkpoint_final.pt"), map_location="cpu",
                      weights_only=False)
    adam = sorted({float(s["step"]) for s in ckpt["optimizer_state_dict"]["state"].values()})
    rows = [json.loads(line) for line in open(os.path.join(save, "metrics.jsonl"))]
    if (counts != want or ckpt["iteration"] != iters or adam != [count + JAX_RESUME_STEPS]
            or [r["step"] for r in rows] != list(range(steps + 1, iters + 1))
            or not all(math.isfinite(r["loss"]) for r in rows)):
        raise AssertionError(f"jax_checkpoint resume: launches {counts} (expected {want}), "
                             f"iteration {ckpt['iteration']}, Adam steps {adam} (expected "
                             f"{count} + {JAX_RESUME_STEPS}), steps {[r['step'] for r in rows]}")
    report["resume"] = {"from_iteration": steps, "to_iteration": ckpt["iteration"],
                        "adam_count_from": count, "adam_count_to": adam[0], "seconds": secs,
                        "launches": counts, "loss_first_last": [rows[0]["loss"],
                                                                rows[-1]["loss"]],
                        "warmup_steps_of_64_rays": max(0, 5 - steps)}
    emit({"phase": "jax_checkpoint", **report})
    return {"render_800": report["render_800"]["launches"], "resume": counts}


# The full-scale study's scale-down: the JAX package's own
# (.claude/skills/verify/SKILL.md) through the port's scripts
FULL_SCALE_FLAGS = ["--size", "200", "--train-views", "10", "--val-views", "2",
                    "--iters", "2000", "--frames", "4"]
# below the first run's val PSNR on the card, 26.00 dB (PERF.md gives both)
FULL_SCALE_PSNR_FLOOR = 24.0
# the second seed of the scale-down: one whose density head is live on its
# scene (density_alive_probe; seeds 1, 4 and 7 are born dead there)
FULL_SCALE_SEED2 = 3
# K2 and K5 on the model the JAX init trains at the scale-down, against
# their plain versions: PLAIN_TOL (set on seeded untrained models) times
# this factor.  The trained field is sharp and bf16 rounding moves its
# sigma a little further: K2's field_sigma and depth read 1.05x and 1.03x
# PLAIN_TOL on an H100 80GB HBM3 at 700 W (PERF.md); a kernel that writes
# zeros or wrong samples errs by orders more
TRAINED_TOL_FACTOR = 2.0


def numeric_keys(tree, prefix=()):
    """The key paths of a report's numbers (a list of numbers counts as one)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from numeric_keys(v, prefix + (k,))
    elif isinstance(tree, (int, float)) and not isinstance(tree, bool):
        yield prefix
    elif isinstance(tree, list) and tree and all(isinstance(v, (int, float)) for v in tree):
        yield prefix


def phase_full_scale(out_dir, smi):
    """The reference-native study's scripts on the card at the scale-down
    FULL_SCALE_FLAGS (`python -m danerf_tpu_torch.examples.full_scale`,
    then `measure_io_overlap` on its output):

    - one 200x200 view of the device ground truth (make_synthetic_scene
      backend="torch") within one level of the float64 numpy path, the
      pixels a level apart counted;
    - the launches of each stage, read from zero as phase_train reads them:
      one K2, K4, K3 a training step and one K2 + K5 a chunk of each
      validation render (one a checkpoint), of eval and of the spiral;
    - every numeric key of the committed JAX report
      (examples/full_scale_report_v5e.json) in the port's, its val PSNR
      above FULL_SCALE_PSNR_FLOOR, Adam's rate at each checkpoint StepLR's;
    - the spiral's, Fog's and Toon Shader's mp4s decoded by read_video to
      their frame counts;
    - the study again from FULL_SCALE_SEED2: another init (its digest), a
      live density head, the same launches, val PSNR above the floor;
    - the JAX run's initial parameters, and the scale-down from them
      (phase_full_scale_jax_init)."""
    import numpy as np
    import torch

    from danerf_tpu_torch.config import NeRFConfig
    from danerf_tpu_torch.data.synthetic import make_synthetic_scene
    from danerf_tpu_torch.examples import full_scale, measure_io_overlap
    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.viz.video import read_video

    flags = dict(zip(FULL_SCALE_FLAGS[::2], map(int, FULL_SCALE_FLAGS[1::2])))
    size, frames, iters = flags["--size"], flags["--frames"], flags["--iters"]
    views = {}
    for backend in ("torch", "numpy"):
        t0 = time.perf_counter()
        views[backend] = make_synthetic_scene("val", n_images=1, height=size, width=size,
                                              backend=backend, device="cuda")
        views[backend + "_s"] = time.perf_counter() - t0
    gt = {}
    for k in ("images", "alphas"):
        d = np.abs(getattr(views["torch"], k).astype(np.int16)
                   - getattr(views["numpy"], k).astype(np.int16))
        gt[k] = {"max_levels": int(d.max()), "pixels_apart": int((d > 0).sum()),
                 "values": int(d.size)}
    if max(v["max_levels"] for v in gt.values()) > 1:
        raise AssertionError(f"full_scale: the device ground truth against numpy {gt}")

    run_dir = os.path.join(out_dir, "full_scale")
    report_path = os.path.join(out_dir, "full_scale_report.json")
    fr.reset_launch_counts()
    t0 = time.perf_counter()
    full_scale.main([*FULL_SCALE_FLAGS, "--out", run_dir, "--report", report_path,
                     "--device", "cuda"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(fr.LAUNCHES)
    t0 = time.perf_counter()
    measure_io_overlap.main([run_dir, report_path, "--device", "cuda"])
    remeasure_s = time.perf_counter() - t0
    with open(report_path) as f:
        report = json.load(f)

    chunks = -(-size * size // NeRFConfig().render_chunk)
    renders = iters // full_scale.CHECKPOINT_EVERY
    want = {"train": launches_of({**PATHS["hier"][1], "march": 1}, iters),
            "eval": launches_of({"march": chunks, "merged": chunks}, flags["--val-views"]),
            "spiral": launches_of({"march": chunks, "merged": chunks}, frames)}
    want["train"]["march"] += renders
    want["train"]["merged"] += renders
    want = {k: {n: c for n, c in v.items() if c} for k, v in want.items()}
    got = {k: report[k]["launches"] for k in want}
    total = {n: sum(v.get(n, 0) for v in want.values()) for n in fr.LAUNCHES}
    if got != want or counts != total:
        raise AssertionError(f"full_scale: launches {got} (in all {counts}), expected {want}")
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples",
                           "full_scale_report_v5e.json")) as f:
        have = set(numeric_keys(report))
        missing = ["/".join(k) for k in numeric_keys(json.load(f)) if k not in have]
    psnr = report["eval"]["val_psnr"]
    if missing or not psnr > FULL_SCALE_PSNR_FLOOR \
            or not report["train"]["lr_at_checkpoints"]["all_match"]:
        raise AssertionError(f"full_scale: report lacks {missing}, val PSNR {psnr} (floor "
                             f"{FULL_SCALE_PSNR_FLOOR}), rates "
                             f"{report['train']['lr_at_checkpoints']}")
    videos = {}
    for name, n in (("spiral/lego_spiral.mp4", frames), ("fog.mp4", -(-frames // 10)),
                    ("toon_shader.mp4", frames)):
        shape = read_video(os.path.join(run_dir, name))[0].shape
        if shape != (n, size, size, 3):
            raise AssertionError(f"full_scale: {name} decodes to {shape}, expected {n} frames")
        videos[name] = list(shape)

    # a second seed: another init and batch stream, the same launches
    report2_path = os.path.join(out_dir, "full_scale_report_seed2.json")
    fr.reset_launch_counts()
    full_scale.main([*FULL_SCALE_FLAGS, "--seed", str(FULL_SCALE_SEED2), "--out",
                     os.path.join(out_dir, "full_scale_seed2"), "--report", report2_path,
                     "--device", "cuda"])
    torch.cuda.synchronize()
    counts2 = dict(fr.LAUNCHES)
    with open(report2_path) as f:
        report2 = json.load(f)
    got2 = {k: report2[k]["launches"] for k in want}
    psnr2 = report2["eval"]["val_psnr"]
    if (got2 != want or counts2 != total or report2["seed"] != FULL_SCALE_SEED2
            or report2["init"]["sha256"] == report["init"]["sha256"]
            or not report2["init"]["density_alive"] > 0.0 or not psnr2 > FULL_SCALE_PSNR_FLOOR):
        raise AssertionError(f"full_scale seed {FULL_SCALE_SEED2}: launches {got2} (expected "
                             f"{want}), init {report2['init']} against seed 0's "
                             f"{report['init']}, val PSNR {psnr2}")
    jax_init = phase_full_scale_jax_init(out_dir, size, want, total)
    emit({"phase": "full_scale", "card": smi, "flags": FULL_SCALE_FLAGS,
          "seed2": {"seed": FULL_SCALE_SEED2, "init": report2["init"], "val_psnr": psnr2,
                    "val_ssim": report2["eval"]["val_ssim"],
                    "final_train_psnr": report2["train"]["final_train_psnr"],
                    "seed0": {"init": report["init"], "val_psnr": psnr}},
          "jax_init": jax_init,
          "ground_truth_200": {"levels_apart": gt, "device_s": views["torch_s"],
                               "numpy_s": views["numpy_s"]},
          "seconds": secs, "remeasure_seconds": remeasure_s, "launches": got,
          "videos": videos, "psnr_floor": FULL_SCALE_PSNR_FLOOR,
          "report": {k: report[k] for k in ("data", "train", "eval", "spiral", "effects_seconds",
                                            "effects_breakdown", "io_overlap_remeasure")}})
    return counts


def phase_full_scale_jax_init(out_dir, size, want, total):
    """The JAX run's initial parameters (the committed
    danerf_tpu_torch/examples/jax_init_seed0.npz) on the card's host, which
    has no JAX: read with numpy, put into the default-width model (every
    leaf equal to the file's, the weights transposed), its density probe
    on a 200x200 scene on the card equal to the CPU's (0.0: the head is
    born dead on the study's scene, as on the CPU).  Then the scale-down
    FULL_SCALE_FLAGS from it (`full_scale --init-npz` on the file's 100
    training views, one an appearance row, as in the full study): seed 0's
    launches (``want``, in all ``total``), val PSNR above the floor.  On
    the model it trained: a head the probe reads as live, on the card and
    on the CPU within 1e-4 relative (they sum the f32 layers in other
    orders); K2 (with its field) and K5 at one 200x200 view's 40,000 rays,
    each against its plain version on the same inputs within
    TRAINED_TOL_FACTOR x PLAIN_TOL (a kernel that wrote zeros would fail); and
    the view through render_frame, exactly one K2 and one K5, its mean
    accumulation above 0.  The view's difference from the plain route
    (module forward at every sample, nerf_apply's encoding form) is
    recorded, not bounded: on a trained model its depth differs by up to
    ~0.2 at edge pixels, where the fine depths, drawn from coarse weights
    that the two routes round apart, land apart."""
    import numpy as np
    import torch

    from danerf_tpu_torch.benchmarks.reference_init import density_alive_probe
    from danerf_tpu_torch.config import NeRFConfig
    from danerf_tpu_torch.data.synthetic import make_synthetic_scene
    from danerf_tpu_torch.examples import full_scale
    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.kernels.fused_mlp import pack_params
    from danerf_tpu_torch.ops.rays import generate_rays
    from danerf_tpu_torch.ops.sampling import sample_pdf, sample_stratified
    from danerf_tpu_torch.render.renderer import render_frame
    from danerf_tpu_torch.train.trainer import init_model, load_jax_params
    from danerf_tpu_torch.utils.checkpoint import load_model
    from danerf_tpu_torch.utils.convert import read_params_npz

    t0 = time.perf_counter()
    tree = read_params_npz(full_scale.JAX_INIT)
    read_s = time.perf_counter() - t0
    if any(m.split(".")[0] in ("jax", "jaxlib", "danerf_tpu") for m in sys.modules):
        raise AssertionError("full_scale jax_init: JAX or danerf_tpu is imported")
    cfg = NeRFConfig(use_bf16=True)
    n_images = tree["appearance"].shape[0]
    model, table = init_model(cfg, n_images, 0, "cuda")
    load_jax_params(model, table, tree)
    sd = model.state_dict()
    layers = [(f"pts_linears.{i}", layer) for i, layer in enumerate(tree["model"]["trunk"])]
    layers += [(port, tree["model"][jx]) for jx, port in
               (("density", "density_head"), ("dir", "dir_linear"), ("rgb", "rgb_linear"),
                ("appearance_proj", "appearance_projection"))]
    leaves = [pair for name, layer in layers for pair in
              ((sd[f"{name}.weight"], layer["w"].T), (sd[f"{name}.bias"], layer["b"]))]
    leaves.append((table, tree["appearance"]))
    unequal = sum(not np.array_equal(t.detach().cpu().numpy(), a) for t, a in leaves)
    scene = make_synthetic_scene("train", n_images=2, height=size, width=size,
                                 backend="torch", device="cuda")

    def probes(m):
        card = density_alive_probe(m, cfg, scene.images.shape, scene.c2ws, scene.focal)
        cpu = density_alive_probe(m.cpu(), cfg, scene.images.shape, scene.c2ws, scene.focal)
        m.cuda()
        return {"card": card, "cpu": cpu}

    born = probes(model)
    if unequal or born["card"] != born["cpu"]:
        raise AssertionError(f"full_scale jax_init: {unequal} leaves unequal, probe {born}")

    run_dir = os.path.join(out_dir, "full_scale_jax_init")
    report_path = os.path.join(out_dir, "full_scale_report_jax_init.json")
    fr.reset_launch_counts()
    full_scale.main([*FULL_SCALE_FLAGS, "--train-views", str(n_images), "--init-npz",
                     full_scale.JAX_INIT, "--out", run_dir, "--report", report_path,
                     "--device", "cuda"])
    torch.cuda.synchronize()
    counts = dict(fr.LAUNCHES)
    with open(report_path) as f:
        report = json.load(f)
    got = {k: report[k]["launches"] for k in want}
    psnr = report["eval"]["val_psnr"]
    if (got != want or counts != total
            or report["init"]["from"] != os.path.basename(full_scale.JAX_INIT)
            or not psnr > FULL_SCALE_PSNR_FLOOR):
        raise AssertionError(f"full_scale jax_init: launches {got} (expected {want}), init "
                             f"{report['init']}, val PSNR {psnr}")

    model, table, _, cfg = load_model(os.path.join(run_dir, "checkpoints",
                                                   "checkpoint_final.pt"), cfg, "cuda")
    model.requires_grad_(False)
    trained = probes(model)
    emb = table[0].detach().cuda()

    # K2 and K5 on the same inputs as their plain versions
    c2w = torch.as_tensor(scene.c2ws[0], dtype=torch.float32, device="cuda")
    o, d = generate_rays(size, size, scene.focal, c2w)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    embs = emb.reshape(1, -1).expand(o.shape[0], -1).contiguous()
    z, _ = sample_stratified(o, d, cfg.near, cfg.far, cfg.num_samples, False, None)
    packed = pack_params(model, cfg)
    with torch.no_grad():
        want_f = fr.march_plain(packed, cfg, o, d, embs, z, want_field=True)
        got_f = fr.march_cuda(packed, cfg, o, d, embs, z, want_field=True)
        z_f = sample_pdf(z, want_f["weights"], cfg.num_importance, False)
        want_m = fr.merged_plain(packed, cfg, o, d, embs, z, want_f["field"], z_f)
        got_m = fr.merged_cuda(packed, cfg, o, d, embs, z, want_f["field"], z_f)
    torch.cuda.synchronize()
    errs, failures = {}, []
    tol = {k: TRAINED_TOL_FACTOR * v for k, v in fr.PLAIN_TOL.items()}
    compare(errs, failures, "K2", got_f, want_f, ["rgb", "depth", "acc", "weights", "field"], tol)
    compare(errs, failures, "K5", got_m, want_m, ["rgb", "depth", "acc", "weights", "z_vals"], tol)
    del want_f, got_f, want_m, got_m

    frames = {}
    for route, c in (("kernel", cfg), ("plain", cfg.replace(use_kernels=False))):
        fr.reset_launch_counts()
        with torch.no_grad():
            rgb, dep, acc = render_frame(model, c, scene.c2ws[0], size, size, scene.focal,
                                         appearance_embedding=emb, device="cuda")
        torch.cuda.synchronize()
        frames[route] = ({"rgb": rgb, "depth": dep, "acc": acc}, dict(fr.LAUNCHES))
    route = {k: max_err(frames["kernel"][0][k], frames["plain"][0][k]) for k in SLICE_TOL}
    route["depth_pixels_beyond_slice_tol"] = int(
        ((frames["kernel"][0]["depth"] - frames["plain"][0]["depth"]).abs()
         > SLICE_TOL["depth"]).sum())
    launched = {k: v for k, v in frames["kernel"][1].items() if v}
    mean_acc = float(frames["kernel"][0]["acc"].mean())
    finite = all(bool(torch.isfinite(t).all()) for t in frames["kernel"][0].values())
    if (failures or not trained["card"] > 0.0
            or abs(trained["card"] - trained["cpu"]) > 1e-4 * abs(trained["cpu"])
            or launched != {"march": 1, "merged": 1} or any(frames["plain"][1].values())
            or not finite or not mean_acc > 0.0):
        raise AssertionError(f"full_scale jax_init: {failures}, trained probe {trained}, "
                             f"launches {frames['kernel'][1]} / {frames['plain'][1]}, mean "
                             f"acc {mean_acc}, kernel route against plain route {route}")
    return {"npz": os.path.basename(full_scale.JAX_INIT), "read_s": read_s,
            "values": int(sum(a.size for _, a in leaves)), "leaves": len(leaves),
            "density_alive": {"born": born, "trained": trained}, "val_psnr": psnr,
            "final_train_psnr": report["train"]["final_train_psnr"],
            "launches": launched, "max_abs_err": errs, "tolerance": tol,
            "kernel_route_against_plain_route": route, "mean_acc": mean_acc}


# The parity study's scale-down (danerf_tpu_torch/examples/parity_study.py):
# every arm at PARITY_SEEDS alive seeds x PARITY_ITERS steps on the 160x160
# scene; the reference trainer's card-against-CPU drift over
# PARITY_DRIFT_STEPS steps, its max relative loss drift held to
# PARITY_DRIFT_TOL: 10x the sound run's reading and 1/5 of a control run's
# with TF32 on (parity_tf32_control), 1.9e-6 and 1.09e-4 on an H100 80GB
# HBM3 at 700 W (PERF.md)
PARITY_ITERS = 300
PARITY_SEEDS = 2
PARITY_DRIFT_STEPS = 50
PARITY_DRIFT_TOL = 2e-5
# below every val PSNR the study reaches at 300 steps (a run that never
# trains stays near 10 dB)
PARITY_PSNR_FLOOR = 15.0
# one training step's launches of each arm, and one eval chunk's (a 160x160
# view is one chunk); the reference arms and xla32 launch nothing
PARITY_LAUNCHES = {
    "framework": ({"march_train": 1}, {"march": 1}),
    "framework_paired": ({"march_train": 1}, {"march": 1}),
    "framework_f32": ({"march_train_f32": 1}, {"march_f32": 1}),
    "framework_hier": (PATHS["hier"][1], {"march": 1, "merged": 1}),
    "framework_paired_hier": (PATHS["hier"][1], {"march": 1, "merged": 1}),
    "framework_paired_hier_f32p": (F32_PATHS["hier_f32"][1], {"march_f32": 1, "merged_f32": 1}),
}


def parity_tf32_control(drift: dict) -> float:
    """The control of the drift bound: the reference trainer on the card
    over the drift run's steps, from its init and numpy stream, with TF32
    on (the trainer's TF32 check lifted for this run alone); its max
    relative loss drift against the CPU side at every 10th step
    (``loss_trace_torch_every10``).  A bound that this reading does not
    exceed would not see the card's arithmetic change."""
    from unittest import mock

    import numpy as np
    import torch

    from danerf_tpu_torch.benchmarks import torch_reference
    from danerf_tpu_torch.config import NeRFConfig
    from danerf_tpu_torch.data.blender import load_blender_scene
    from danerf_tpu_torch.examples.parity_study import SCENE

    ds = load_blender_scene(SCENE, "train")
    # parity_equivalence.run's configuration of a coarse run
    cfg = NeRFConfig().replace(num_importance=0, use_kernels=False, use_bf16=False,
                               near=ds.near, far=ds.far)
    saved = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
    torch.set_float32_matmul_precision("high")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with mock.patch.object(torch_reference, "check_f32_highest", lambda dev: None):
            _, _, mses = torch_reference.train_reference(
                cfg, ds.images.astype(np.float32) / 255.0, ds.c2ws, ds.focal, drift["iters"],
                seed=drift["seed"], log_every=10 ** 9, device="cuda")
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cuda.matmul.allow_tf32 = saved[1]
    cpu = np.asarray(drift["loss_trace_torch_every10"])
    card = np.asarray(mses[::10])
    return float(np.max(np.abs(card - cpu) / np.maximum(np.abs(cpu), 1e-12)))


def phase_parity(out_dir, smi):
    """The parity study through `parity_study.run`, every arm at PARITY_SEEDS
    alive seeds x PARITY_ITERS steps on examples/procedural_scene (160x160),
    from an empty cache:

    - the launches read from zero as phase_train reads them, each run's
      training and eval apart: none for the reference arms (the reference
      trainer, plain PyTorch in f32, and its eval with use_kernels=False)
      and for framework_paired_hier_xla32 (use_kernels=False in f32); one
      K7 a step for the coarse arms, one K2, K4, K3 a step for the 64 + 64
      arms (their f32 variants for framework_f32 and _f32p); one K2 (+ K5)
      a val view in eval; the sum over the runs equal to the phase's count;
    - every val PSNR above PARITY_PSNR_FLOOR;
    - the reference init's dead set over seeds 0-11 on the card equal to
      examples/parity_runs/dead_rates.json's, and the reference arm's dead
      seeds equal to it over the seeds probed;
    - the reference trainer on the card against the CPU over
      PARITY_DRIFT_STEPS steps from one init and numpy stream
      (benchmarks/parity_equivalence.py in a process of its own, started
      first so that its CPU side runs beside the arms), the max relative
      loss drift within PARITY_DRIFT_TOL, and the same run with TF32 on
      (parity_tf32_control) beyond it.

    The framework_paired arms are the framework arms' runs
    (parity_study.SAME_AS): their launches are checked and not counted
    twice."""
    import torch

    from danerf_tpu_torch.benchmarks import dead_rate_probe
    from danerf_tpu_torch.examples import parity_study
    from danerf_tpu_torch.kernels import fused_render as fr

    root = os.path.join(out_dir, "parity")
    shutil.rmtree(root, ignore_errors=True)
    runs_dir = os.path.join(root, "runs")
    drift_path = os.path.join(root, "equivalence_drift.json")
    os.makedirs(root)
    t0 = time.perf_counter()
    drift_log = os.path.join(root, "equivalence_drift.log")
    with open(drift_log, "w") as log:
        drift_proc = subprocess.Popen(
            [sys.executable, "-m", "danerf_tpu_torch.benchmarks.parity_equivalence", "--iters",
             str(PARITY_DRIFT_STEPS), "--out", drift_path, "--device", "cuda"],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=log,
            stderr=subprocess.STDOUT)
    try:
        fr.reset_launch_counts()
        report = parity_study.run(iters=PARITY_ITERS, seeds=PARITY_SEEDS,
                                  hier_seeds=PARITY_SEEDS, f32_seeds=PARITY_SEEDS,
                                  abl_seeds=PARITY_SEEDS, out=os.path.join(root, "report.json"),
                                  runs_dir=runs_dir, device="cuda")
        torch.cuda.synchronize()
        counts = dict(fr.LAUNCHES)
        study_s = time.perf_counter() - t0
        dead = dead_rate_probe.run(12, out=None, device="cuda")
        drift_proc.wait(timeout=600)
    finally:
        if drift_proc.poll() is None:
            drift_proc.kill()
            drift_proc.wait()
    if drift_proc.returncode != 0:
        with open(drift_log) as f:
            raise AssertionError(f"parity: the drift run failed:\n{f.read()[-3000:]}")
    with open(drift_path) as f:
        drift = json.load(f)

    failures, total, per_arm = [], {}, {}
    for arm, runs in report["runs"].items():
        step, chunk = PARITY_LAUNCHES.get(arm, ({}, {}))
        for r in runs:
            want = {"train": {k: v * r["steps"] for k, v in step.items()},
                    "eval": {k: v * len(r["per_view"]) for k, v in chunk.items()}}
            if r["launches"] != want:
                failures.append(f"{arm} seed {r['seed']}: launches {r['launches']}, "
                                f"expected {want}")
            if arm in parity_study.SAME_AS:
                continue
            for part in want.values():
                for k, v in part.items():
                    total[k] = total.get(k, 0) + v
            if not r["val_psnr"] > PARITY_PSNR_FLOOR:
                failures.append(f"{arm} seed {r['seed']}: val PSNR {r['val_psnr']}")
        per_arm[arm] = {"n": len(runs), "seeds": [r["seed"] for r in runs],
                        "dead": report["dead_seeds"][arm],
                        "psnr": [r["val_psnr"] for r in runs],
                        "seconds_per_seed": report["seconds_per_seed"].get(arm),
                        "launches_per_seed": runs[0]["launches"] if runs else None}
        if len(runs) != PARITY_SEEDS:
            failures.append(f"{arm}: {len(runs)} alive seeds")
    if {k: v for k, v in counts.items() if v} != total:
        failures.append(f"launches in all {counts}, the runs' sum {total}")
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples",
                           "parity_runs", "dead_rates.json")) as f:
        jax_dead = json.load(f)["torch_dead_seeds"]
    if dead["torch_dead_seeds"] != [s for s in jax_dead if s < 12]:
        failures.append(f"dead set over 0-11 {dead['torch_dead_seeds']}, the JAX study's "
                        f"{jax_dead}")
    probed = max(report["dead_seeds"]["reference"] + [r["seed"] for r in
                                                      report["runs"]["reference"]]) + 1
    if report["dead_seeds"]["reference"] != [s for s in jax_dead if s < probed]:
        failures.append(f"reference dead seeds {report['dead_seeds']['reference']}")
    worst = drift["rel_drift_full"]["max"]
    if not (math.isfinite(worst) and worst <= PARITY_DRIFT_TOL):
        failures.append(f"card-against-CPU drift {worst} over {PARITY_DRIFT_STEPS} steps "
                        f"(bound {PARITY_DRIFT_TOL})")
    control = parity_tf32_control(drift)
    if not control > PARITY_DRIFT_TOL:
        failures.append(f"the TF32 control's drift {control} does not exceed the bound "
                        f"{PARITY_DRIFT_TOL}")
    result = {"phase": "parity", "card": smi, "iters": PARITY_ITERS, "study_seconds": study_s,
              "arms": per_arm, "launches": {k: v for k, v in counts.items() if v},
              "deltas": {k: {"delta": report[k]["delta"], "ci95": report[k]["ci95"]}
                         for k in report if k.startswith("delta")},
              "dead_0_11": dead["torch_dead_seeds"],
              "drift": {"steps": PARITY_DRIFT_STEPS, "bound": PARITY_DRIFT_TOL,
                        "rel_drift_full": drift["rel_drift_full"],
                        "log_mse_correlation_full": drift["log_mse_correlation_full"],
                        "tf32_control_max_every10": control,
                        "torch_seconds": drift["torch_seconds"],
                        "mirror_seconds": drift["mirror_seconds"], "sides": drift["sides"]},
              "psnr_floor": PARITY_PSNR_FLOOR, "failures": failures}
    emit(result)
    if failures:
        raise AssertionError(f"parity: {failures}")
    return counts


# ---------------------------------------------------------------- parallel

def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def torchrun_env():
    """The environment torchrun gives the one process of a one-card run
    (world size 1), which `--coordinator_address auto` reads."""
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()), "RANK": "0",
           "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dp_vs_single(cfg, ds, device, mesh, k, per_step):
    """From one seeded state, 5 warm-up steps of 64 rays, then one call of
    ``k`` steps as one graph replay: make_sharded_train_step over ``mesh``
    (world size 1) against make_train_step; the differences bit for bit
    (state_diff, each step's metrics), the launches of both against the
    path's, and both steps (to time them)."""
    import torch

    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.parallel import make_sharded_train_step
    from danerf_tpu_torch.train.trainer import make_train_step

    runs = {}
    for mode in ("sharded", "single"):
        model, table, opt, sched, gen, pool = train_state(cfg, ds, device)

        def make(n, bs):
            if mode == "sharded":
                return make_sharded_train_step(model, table, opt, sched, pool, cfg, mesh,
                                               ds.height, ds.width, ds.focal, bs, gen, n)
            return make_train_step(model, table, opt, sched, pool, cfg, ds.height, ds.width,
                                   ds.focal, bs, gen, n)

        warm = make(1, 64)
        for _ in range(5):
            warm()
        step = make(k, None)
        fr.reset_launch_counts()
        out = step()
        torch.cuda.synchronize()
        runs[mode] = {"state": (model, table, opt, sched, gen), "launches": dict(fr.LAUNCHES),
                      "metrics": out, "step": step}
    a, b = runs["sharded"], runs["single"]
    diff = state_diff(a["state"], b["state"])
    diff += [f"metric {n}" for n in b["metrics"]
             if not torch.equal(a["metrics"][n], b["metrics"][n])]
    want = launches_of(per_step, k)
    bad = {m: r["launches"] for m, r in runs.items() if r["launches"] != want}
    n_flat = sum(p.numel() for p in a["state"][0].parameters()) + a["state"][1].numel()
    return {"steps": k, "differences": diff, "launches_wrong": bad,
            "launches": a["launches"], "flat_allreduce_floats": n_flat + len(a["metrics"]),
            "loss_first_last": [float(a["metrics"]["loss"][0]),
                                float(a["metrics"]["loss"][-1])]}, a["step"], b["step"]


def phase_dist_step(cfg, device, mesh, k=10):
    """Data-parallel training on a world-size-1 NCCL group: for the 64 + 64,
    the coarse-only and the per-sample path, 10 chained sharded steps (one
    graph replay, the flat all-reduce captured with them) against 10
    chained make_train_step steps, bit for bit, with exactly the path's
    launches, and one f32 (use_bf16=False) 64 + 64 sharded step against one
    f32 make_train_step step; then on 64 + 64 both steps timed in turns (20 synchronised
    replays each, ms a step) and a torch.profiler window of 3 replays each
    (device busy, idle share): the difference is the all-reduce's cost."""
    import numpy as np
    import torch

    report, failures, steps = {}, [], {}
    for path, kk in (("hier", k), ("coarse", k), ("per_sample", k), ("hier_f32", 1)):
        over, per_step = ALL_PATHS[path]
        pcfg = cfg.replace(**over)
        report[path], *steps[path] = dp_vs_single(pcfg, timing_scene(pcfg), device, mesh, kk,
                                                  per_step)
        if report[path]["differences"] or report[path]["launches_wrong"]:
            failures.append(f"{path}: {report[path]}")
    sharded, single = steps["hier"]
    times = {"sharded": [], "single": []}
    for _ in range(20):
        for mode, step in (("single", single), ("sharded", sharded)):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times[mode].append((time.perf_counter() - t0) * 1e3 / k)
    timing = {}
    for mode, step in (("single", single), ("sharded", sharded)):
        prof = profile_steps(step, n_prof=3)
        timing[mode] = {"ms_per_step_median": float(np.median(times[mode])),
                        "ms_per_step_min": min(times[mode]),
                        "ms_per_step_max": max(times[mode]),
                        "rays_per_s": cfg.batch_size / (float(np.median(times[mode])) / 1e3),
                        "replay_event_ms": cuda_ms(step, 5),
                        "device_busy_ms_per_step": prof["profile_device_busy_ms_per_step"] / k,
                        "idle_share": prof["profile_idle_share"],
                        "top_kernels_ms_per_replay": prof["profile_ms_per_step"][:8]}
    timing["sharded_over_single"] = (timing["sharded"]["ms_per_step_median"]
                                     / timing["single"]["ms_per_step_median"])
    emit({"phase": "dist_step", "world_size": 1, "backend": "nccl", "steps_per_call": k,
          "rays": cfg.batch_size, **report, "timing_64_64": timing, "failures": failures})
    if failures:
        raise AssertionError("sharded steps differ from make_train_step: " + "; ".join(failures))
    return report


def phase_dist_frame(cfg, model, device, mesh, side=800):
    """The sharded frame on a world-size-1 NCCL group: render_frame(mesh=)
    of an 800x800 medium frame (64 + 64, jittered from a seeded generator)
    against render_frame, bit for bit, with exactly 10 K2 and 10 K5
    launches; make_sharded_render on one 65,536-ray chunk against
    render_rays' per-sample route, bit for bit, with exactly 2 K1 launches;
    the ms of each (median of 3 after a warm-up call, in turns)."""
    import numpy as np
    import torch

    from danerf_tpu_torch.config import RENDER_PRESETS
    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.parallel.mesh import make_sharded_render
    from danerf_tpu_torch.render.renderer import render_frame, render_rays
    from danerf_tpu_torch.viz.paths import camera_path

    emb = torch.randn(cfg.appearance_dim, generator=torch.Generator().manual_seed(3))
    focal = 0.5 * side / np.tan(0.5 * 0.6911)
    c2w = camera_path("circle", 4, cfg.scene)[1]

    def frame(m):
        gen = torch.Generator(device=device).manual_seed(7)
        return render_frame(model, cfg, c2w, side, side, focal, appearance_embedding=emb,
                            perturb=True, chunk=RENDER_PRESETS["medium"]["chunk"],
                            generator=gen, device=device, mesh=m)

    failures = []
    fr.reset_launch_counts()
    got = frame(mesh)
    torch.cuda.synchronize()
    frame_launches = dict(fr.LAUNCHES)
    want = frame(None)
    frame_equal = all(torch.equal(a, b) for a, b in zip(got, want))
    n_chunks = -(-side * side // RENDER_PRESETS["medium"]["chunk"])
    if frame_launches != launches_of({"march": n_chunks, "merged": n_chunks}):
        failures.append(f"sharded frame launches {frame_launches}")
    if not frame_equal:
        failures.append("sharded frame != render_frame: max "
                        f"{max(max_err(a, b) for a, b in zip(got, want))}")
    frame_ms = {"sharded": [], "single": []}
    for _ in range(3):
        for mode, m in (("single", None), ("sharded", mesh)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame(m)
            torch.cuda.synchronize()
            frame_ms[mode].append((time.perf_counter() - t0) * 1e3)

    n = cfg.render_chunk
    o, d, e, _ = make_rays(n, cfg, seed=31, device=device)
    render = make_sharded_render(cfg, mesh, 256, 256, cfg.num_samples, cfg.num_importance)
    with torch.no_grad():
        fr.reset_launch_counts()
        got_r = render(model, o, d, e)
        torch.cuda.synchronize()
        render_launches = dict(fr.LAUNCHES)

        def plain_route():
            out = render_rays(model, cfg, o, d, e, perturb=False, fused_composite=False)
            return out["rgb"], out["depth"], out["acc"]

        want_r = plain_route()
        render_equal = all(torch.equal(a, b) for a, b in zip(got_r, want_r))
        render_ms = {"sharded": cuda_ms(lambda: render(model, o, d, e), 3),
                     "render_rays": cuda_ms(plain_route, 3)}
    if render_launches != launches_of({"mlp_fwd": 2}):
        failures.append(f"make_sharded_render launches {render_launches}")
    if not render_equal:
        failures.append("make_sharded_render != render_rays: max "
                        f"{max(max_err(a, b) for a, b in zip(got_r, want_r))}")
    report = {"frame": {"side": side, "equal": frame_equal, "launches": frame_launches,
                        "ms_median": {m: float(np.median(v)) for m, v in frame_ms.items()},
                        "ms": frame_ms},
              "sharded_render": {"rays": n, "samples": [cfg.num_samples, cfg.num_importance],
                                 "equal": render_equal, "launches": render_launches,
                                 "ms": render_ms}}
    emit({"phase": "dist_frame", "world_size": 1, "backend": "nccl", **report,
          "failures": failures})
    if failures:
        raise AssertionError("the sharded frame disagrees: " + "; ".join(failures))
    return report


# The two-rank phase's bars (gloo on one card, the same f32 work in other
# sums): the first step's gradients summed over two half batches, per
# parameter by relative Frobenius error (a sum in place of the mean would be
# 0.5); each step's loss relatively; the parameters after 3 Adam steps at
# most 2 lr apart a step (Adam moves an element by at most ~lr, and an
# element whose gradient is near 0 may change sign between the two); the
# frame at the JAX sharded frame's bars (tests/test_parallel.py: rgb and
# acc 1e-5, depth 1e-4): its kernels compute each ray alone on the same
# jitter, but PyTorch's per-ray reductions (the direction's norm, the CDF's
# sums) may take another order for half the rays (measured on the H100:
# 6.2e-6); the tensor-parallel forward (bf16 inputs rounded at the same
# places, the row-parallel partial sums in another order) at PLAIN_TOL's
# field limits.
TWO_RANK_TOL = {"grad_rel": 1e-3, "loss_rel": 1e-4, "frame_rgb_acc": 1e-5, "frame_depth": 1e-4}


def two_rank_inputs(cfg, device):
    """What both ranks and the single-process reference start from: the
    training state, the frame's model, camera and embedding, the points of
    the tensor-parallel forward."""
    import numpy as np
    import torch

    from danerf_tpu_torch.viz.paths import camera_path

    ds = timing_scene(cfg)
    g = torch.Generator(device=device).manual_seed(41)
    x = torch.randn(4096, 3, generator=g, device=device)
    d = torch.randn(4096, 3, generator=g, device=device)
    d = d / d.norm(dim=-1, keepdim=True)
    emb = torch.randn(4096, cfg.appearance_dim, generator=g, device=device)
    return {"ds": ds, "state": train_state(cfg, ds, device), "c2w": camera_path("circle", 4,
                                                                                cfg.scene)[1],
            "focal": 0.5 * 200 / np.tan(0.5 * 0.6911), "points": (x, d, emb),
            "frame_emb": torch.randn(cfg.appearance_dim,
                                     generator=torch.Generator().manual_seed(3))}


def two_rank_work(cfg, device, mesh=None, tp_mesh=None):
    """3 eager 64 + 64 steps at B = 1024 (sharded over ``mesh`` when given),
    a 200x200 medium frame, and the module-route forward (tensor-parallel
    over ``tp_mesh`` when given): losses, the first step's gradients, the
    parameters after, the frame, rgb/sigma and the wall ms of the steps."""
    import torch

    from danerf_tpu_torch.parallel import make_sharded_train_step
    from danerf_tpu_torch.parallel.mesh import TPNeRF
    from danerf_tpu_torch.render.renderer import render_frame
    from danerf_tpu_torch.train.trainer import make_train_step

    inp = two_rank_inputs(cfg, device)
    ds = inp["ds"]
    model, table, opt, sched, gen, pool = inp["state"]
    if mesh is None:
        step = make_train_step(model, table, opt, sched, pool, cfg, ds.height, ds.width,
                               ds.focal, None, gen, 1)
    else:
        step = make_sharded_train_step(model, table, opt, sched, pool, cfg, mesh, ds.height,
                                       ds.width, ds.focal, None, gen, 1)
    params = list(model.parameters()) + [table]
    losses, grads = [], None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(3):
        losses.append(float(step()["loss"][0]))
        if i == 0:
            grads = [p.grad.detach().clone() for p in params]
    steps_ms = (time.perf_counter() - t0) * 1e3 / 3
    fmodel = make_model(cfg, seed=0, device=device)
    gen_f = torch.Generator(device=device).manual_seed(7)
    frame = render_frame(fmodel, cfg, inp["c2w"], 200, 200, inp["focal"],
                         appearance_embedding=inp["frame_emb"], perturb=True, chunk=65536,
                         generator=gen_f, device=device, mesh=mesh)
    mcfg = cfg.replace(use_kernels=False)
    net = make_model(mcfg, seed=0, device=device)
    if tp_mesh is not None:
        net = TPNeRF(net, tp_mesh)
    with torch.no_grad():
        rgb, sigma = net(*inp["points"])
    return {"losses": losses, "grads": [g.cpu() for g in grads],
            "params": [p.detach().cpu() for p in params],
            "frame": [f.cpu() for f in frame], "rgb": rgb.cpu(), "sigma": sigma.cpu(),
            "steps_ms": steps_ms}


def card_timing(cfg, device, mesh, world, side=800):
    """The chained 64 + 64 step (10 steps a replay; over ``mesh`` when
    given, else one process) at a global batch of B = 1024 and of world x
    1024 (each rank's block 1024 rays): the median, min and max ms a step
    of 20 synchronised replays after the capture, and rays/s; and the
    800x800 medium frame (median of 3 after a warm-up call)."""
    import numpy as np
    import torch

    from danerf_tpu_torch.parallel import make_sharded_train_step
    from danerf_tpu_torch.render.renderer import render_frame
    from danerf_tpu_torch.train.trainer import make_train_step

    out = {}
    ds = timing_scene(cfg)
    for b in (cfg.batch_size, world * cfg.batch_size):
        model, table, opt, sched, gen, pool = train_state(cfg, ds, device)
        if mesh is None:
            step = make_train_step(model, table, opt, sched, pool, cfg, ds.height, ds.width,
                                   ds.focal, b, gen, 10)
        else:
            step = make_sharded_train_step(model, table, opt, sched, pool, cfg, mesh, ds.height,
                                           ds.width, ds.focal, b, gen, 10)
        step()
        torch.cuda.synchronize()
        reps = []
        for _ in range(20):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            reps.append((time.perf_counter() - t0) * 1e3 / 10)
        ms = float(np.median(reps))
        out[f"step_B{b}"] = {"ms_per_step_median": ms, "ms_per_step_min": min(reps),
                             "ms_per_step_max": max(reps), "rays_per_s": b / (ms / 1e3)}
    inp = two_rank_inputs(cfg, device)
    fmodel = make_model(cfg, seed=0, device=device)
    focal = 0.5 * side / np.tan(0.5 * 0.6911)
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_frame(fmodel, cfg, inp["c2w"], side, side, focal,
                     appearance_embedding=inp["frame_emb"], perturb=True, chunk=65536,
                     generator=torch.Generator(device=device).manual_seed(7), device=device,
                     mesh=mesh)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out[f"frame_{side}_medium_ms"] = float(np.median(times[1:]))
    return out


def tp_chained_vs_eager(cfg, device, tp_mesh, k=10):
    """The tensor-parallel step on the kernel route (the trunk gathered
    each step, NCCL in the captured graph): one call of ``k`` steps as a
    graph replay against ``k`` eager steps from one seeded state, bit for
    bit on this rank's shards (state_diff) and metrics, with the 64 + 64
    launches; returns this rank's differences."""
    import torch

    from danerf_tpu_torch.kernels import fused_render as fr
    from danerf_tpu_torch.parallel import make_sharded_train_step, shard_train_state

    ds = timing_scene(cfg)
    runs = {}
    for per_call, calls in ((k, 1), (1, k)):
        model, table, opt, sched, gen, pool = train_state(cfg, ds, device)
        model, table, opt, sched = shard_train_state(model, table, opt, sched, gen, tp_mesh,
                                                     tensor_parallel=True)
        step = make_sharded_train_step(model, table, opt, sched, pool, cfg, tp_mesh, ds.height,
                                       ds.width, ds.focal, None, gen, per_call)
        fr.reset_launch_counts()
        out = [step() for _ in range(calls)]
        torch.cuda.synchronize()
        runs[per_call] = ((model, table, opt, sched, gen), dict(fr.LAUNCHES),
                          {n: torch.cat([m[n] for m in out]) for n in out[0]})
    (sa, la, ma), (sb, lb, mb) = runs[k], runs[1]
    diff = state_diff(sa, sb) + [f"metric {n}" for n in mb if not torch.equal(ma[n], mb[n])]
    want = launches_of(PATHS["hier"][1], k)
    if la != want or lb != want:
        diff.append(f"launches {la} {lb}")
    return diff


def dist_child(rank: int, world: int, port: int, out_dir: str, backend: str) -> int:
    """One rank of phase_dist_ranks: on gloo every rank shares the one
    card, on NCCL each takes its own (rank % cards)."""
    import torch
    import torch.distributed as dist

    from danerf_tpu_torch.config import NeRFConfig
    from danerf_tpu_torch.parallel import initialize_distributed, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert initialize_distributed(f"127.0.0.1:{port}", world, rank, backend=backend)
    device = torch.device("cuda")
    cfg = NeRFConfig(density_bias_init=0.5)
    mesh = make_mesh(data=world, model=1)
    tp_mesh = make_mesh(data=world // 2, model=2)
    got = two_rank_work(cfg, device, mesh=mesh, tp_mesh=tp_mesh)
    if backend == "nccl":
        got["timing"] = card_timing(cfg, device, mesh, world)
        n_diff = torch.tensor([len(tp_chained_vs_eager(cfg, device, tp_mesh))], device=device)
        dist.all_reduce(n_diff)
        got["tp_chained_differences_all_ranks"] = int(n_diff)
    if rank == 0:
        torch.save(got, os.path.join(out_dir, f"ranks_{world}.pt"))
    dist.destroy_process_group()
    return 0


def phase_dist_ranks(cfg, device, out_dir, world=2, backend="gloo"):
    """``world`` processes of this script, one rank each: on gloo all on
    the one card (NCCL refuses two ranks on one card; phase dist_two_ranks),
    on NCCL one card each (phase dist_cards, ``--cards``).  Each rank runs 3
    eager sharded 64 + 64 steps at a global B = 1024, a 200x200 sharded
    frame and the --mesh_model 2 module-route forward, held against the
    same work in this process without a mesh within TWO_RANK_TOL; on NCCL
    also the chained step's and the 800x800 frame's times (against this
    process's on one card, timed after the ranks exit) and the
    tensor-parallel kernel-route step chained against eager, bit for bit.
    A failure in any rank fails the phase.  Gloo times are no speed figure
    (the ranks share one card and gloo copies through the host)."""
    import torch

    from danerf_tpu_torch.kernels import fused_render as fr

    child_dir = os.path.join(out_dir, f"ranks_{backend}_{world}")
    os.makedirs(child_dir, exist_ok=True)
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dist-child",
                               str(r), str(world), str(port), child_dir, backend],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    children_s = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"dist ranks: rank {r} exited {p.returncode}:\n{log[-4000:]}")
    got = torch.load(os.path.join(child_dir, f"ranks_{world}.pt"), weights_only=False)
    want = two_rank_work(cfg, device)
    names = [n for n, _ in make_model(cfg, 0, "cpu").named_parameters()] + ["appearance"]
    grad_rel = {n: float((a - b).norm() / b.norm()) for n, a, b in
                zip(names, got["grads"], want["grads"]) if float(b.norm()) > 0}
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    param_abs = max(max_err(a, b) for a, b in zip(got["params"], want["params"]))
    frame_err = [max_err(a, b) for a, b in zip(got["frame"], want["frame"])]
    rgb_err = max_err(got["rgb"], want["rgb"])
    sigma_err = float(((got["sigma"] - want["sigma"]).abs()
                       / want["sigma"].abs().clamp_min(1.0)).max())
    tol = fr.PLAIN_TOL
    checks = {"grad_rel_worst": (max(grad_rel.values()), TWO_RANK_TOL["grad_rel"]),
              "loss_rel": (loss_rel, TWO_RANK_TOL["loss_rel"]),
              "param_max_abs": (param_abs, 3 * 2 * cfg.learning_rate * (1 + 1e-3)),
              "frame_rgb_max_abs": (frame_err[0], TWO_RANK_TOL["frame_rgb_acc"]),
              "frame_depth_max_abs": (frame_err[1], TWO_RANK_TOL["frame_depth"]),
              "frame_acc_max_abs": (frame_err[2], TWO_RANK_TOL["frame_rgb_acc"]),
              "tp_rgb_max_abs": (rgb_err, tol["field_rgb"]),
              "tp_sigma_rel": (sigma_err, tol["field_sigma"])}
    failures = [f"{k}: {v} > {lim}" for k, (v, lim) in checks.items()
                if not (math.isfinite(v) and v <= lim)]
    report = {"phase": "dist_two_ranks" if backend == "gloo" else "dist_cards",
              "world_size": world, "backend": backend,
              "cards": 1 if backend == "gloo" else world,
              "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()},
              "grad_rel_worst_param": max(grad_rel, key=grad_rel.get),
              "losses": {"ranks": got["losses"], "one_process": want["losses"]},
              "steps_ms_each_ranks": got["steps_ms"],
              "steps_ms_each_one_process": want["steps_ms"],
              "children_s_incl_start": children_s}
    if backend == "nccl":
        report["tp_chained_differences_all_ranks"] = got["tp_chained_differences_all_ranks"]
        if got["tp_chained_differences_all_ranks"]:
            failures.append("tensor-parallel chained steps differ from eager steps")
        report["timing_ranks"] = got["timing"]
        report["timing_one_card"] = card_timing(cfg, device, None, world)
    report["failures"] = failures
    emit(report)
    if failures:
        raise AssertionError("the ranks disagree with one process: " + "; ".join(failures))
    return checks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                  "build", "chip_smoke"),
                    help="directory for the build log, checkpoint and frames")
    ap.add_argument("--cards", type=int, default=1,
                    help="with N > 1: only the multi-card phases over N cards on NCCL")
    # one rank of phase_dist_ranks (the script starts the ranks)
    ap.add_argument("--dist-child", nargs=5, metavar=("RANK", "WORLD", "PORT", "DIR", "BACKEND"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU", file=sys.stderr)
        return 2
    import danerf_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    if args.dist_child:
        rank, world, port, out, backend = args.dist_child
        return dist_child(int(rank), int(world), int(port), out, backend)

    from danerf_tpu_torch.config import NeRFConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    device = torch.device("cuda")

    smi = phase_env()
    phase_build(args.out)
    # Full width, seeded random weights; the density bias is shifted alive so
    # the composite is not vacuous (relu heads can be born dead).
    cfg = NeRFConfig(density_bias_init=0.5)
    if args.cards > 1:
        if torch.cuda.device_count() < args.cards:
            raise AssertionError(f"--cards {args.cards}: {torch.cuda.device_count()} cards")
        phase_dist_ranks(cfg, device, args.out, args.cards, "nccl")
        if args.cards > 2:
            phase_render_subset(cfg, make_model(cfg, seed=0, device=device), args.out,
                                args.cards)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    model = make_model(cfg, seed=0, device=device)
    errs, chunk = phase_kernels(cfg, model, device)
    errs.update(phase_bwd(cfg, model, device))
    for k, v in phase_bwd_shapes(cfg, model, device, "").items():
        errs[k] = max(errs[k], v)
    # the time-conditioned model (use_time, 6 time levels): the has_time variants
    cfg_t = cfg.replace(use_time=True)
    model_t = make_model(cfg_t, seed=0, device=device)
    errs_t, chunk_t = phase_time_kernels(cfg_t, model_t, device)
    for k, v in phase_bwd_shapes(cfg_t, model_t, device, "t").items():
        errs_t[k] = max(errs_t[k], v)
    errs_k9 = phase_hier_onepass(cfg, model, cfg_t, model_t, device)
    # the f32 configuration (use_bf16=False) of the forward kernels, and its
    # serving path, timed before any profiler window
    errs_f32, f32_ratio = phase_f32_kernels(cfg, model, cfg_t, model_t, device)
    f32 = phase_f32_path(cfg, model, cfg_t, model_t, args.out, device)
    # f32 training: the backward kernels K3, K4, K6, K7 in f32, then the
    # training paths and evaluate's fit through them
    errs_f32b, f32b_ratio, f32b_timing, f32b_bound_by = phase_f32_bwd(cfg, model, cfg_t,
                                                                      model_t, device)
    f32_train = phase_f32_train(cfg, model, args.out, device)
    phase_step(cfg, model, device)
    launches = phase_render(cfg, model, args.out)
    phase_chained(cfg, device, args.out)
    train_launches = {"hier": phase_train(args.out, "hier", 200, render=True, every=100,
                                          resume_to=250),
                      "coarse": phase_train(args.out, "coarse", 100, render=False),
                      "white": phase_train(args.out, "white", 100, render=False),
                      "per_sample": phase_train(args.out, "per_sample", 100, render=False),
                      "time": phase_train(args.out, "time", 100, render=True),
                      "hier_onepass": phase_train(args.out, "hier_onepass", 100, render=False)}
    # evaluation on those checkpoints (K2, K5 a frame chunk; the fit's K2, K5,
    # K6, K3 a step), before any torch.profiler window
    eval_counts = phase_eval(args.out)
    loader_counts = phase_loaders(args.out)
    # the JAX package's checkpoint directory: read, rendered, resumed
    jax_counts = phase_jax_checkpoint(args.out, smi)
    # the full-scale study's scripts at its scale-down (K2, K4, K3 a step;
    # K2, K5 a chunk of the validation renders, eval and the spiral)
    full_scale_counts = phase_full_scale(args.out, smi)
    # the parity study's scale-down: every arm through parity_study.run (K7;
    # K2, K4, K3; their f32 variants; none on the reference and xla32 arms)
    parity_counts = phase_parity(args.out, smi)
    phase_native(cfg, model, args.out, device)
    # the depth-aware effects and the renders that feed them, timed before
    # any torch.profiler window (phase_train_timing's): timed after one, the
    # effects' eager launches have run up to 2.3x slower on the H100
    phase_fx(device)
    phase_serve_fx(cfg, args.out, device)
    phase_spiral_fx(cfg, args.out, device)
    phase_video(cfg, model, args.out, device, smi)
    phase_serve_timing(cfg, model, args.out, device)
    phase_eval_timing(cfg, model, device)
    timing, bound_by = phase_timing(cfg, model, device, chunk)
    tt, tt_bound_by = phase_train_timing(cfg, model, device, chunk)
    timing_t, bound_by_t = phase_timing(cfg_t, model_t, device, chunk_t, frame_t=0.5)
    tt_t, tt_bound_by_t = phase_train_timing(cfg_t, model_t, device, chunk_t)
    phase_f32_step_timing(cfg, device, f32b_timing, tt)
    # data parallelism (parallel/mesh.py): 64 + 64 through `cli.main train
    # --coordinator_address auto --mesh_data 0` as torchrun runs one rank
    # (its NCCL group of one; one K2, K4, K3 a step and one K2, K5 for the
    # validation render), then on a world-size-1 NCCL group of this process
    # the sharded steps and frames against the unsharded ones, then two
    # ranks on gloo
    with torchrun_env():
        train_launches["hier_dp"] = phase_train(args.out, "hier_dp", 100, render=False,
                                                every=100)
    import torch.distributed as dist

    from danerf_tpu_torch.parallel import make_mesh

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    mesh = make_mesh()
    phase_dist_step(cfg, device, mesh)
    dist_frame = phase_dist_frame(cfg, model, device, mesh)
    dist.destroy_process_group()
    phase_dist_ranks(cfg, device, args.out)
    # the last profiler window: the f32 and bf16 frames, device busy and idle
    phase_frame_profile(cfg, model, device)

    def train_kernel(name, key, source, replaces, path, counter):
        # a training kernel at the batch (B = 1024 rays, 64 + 64), its
        # launches from its path's training run
        return {"name": name, "route": "cuda",
                "source": f"danerf_tpu_torch/kernels/csrc/{source}",
                "replaces": f"danerf_tpu/kernels/fused_render.py:{replaces}",
                "launches": train_launches[path][counter], "max_abs_err": errs[key.upper()],
                "ms": tt[f"{key}_batch_ms"], "plain_ms": tt[f"{key}_batch_plain_ms"],
                "bound_ms": tt[f"{key}_batch_bound_ms"], "bound_by": tt_bound_by[key],
                "library_ms": None}

    kernels = [
        {"name": "K2 ray march (want_field)", "route": "cuda",
         "source": "danerf_tpu_torch/kernels/csrc/march.cu",
         "replaces": "danerf_tpu/kernels/fused_render.py:155",
         "launches": launches["march"], "max_abs_err": errs["K2"],
         "ms": timing["k2_ms"], "plain_ms": timing["k2_plain_ms"],
         "bound_ms": timing["k2_bound_ms"], "bound_by": bound_by[0], "library_ms": None},
        {"name": "K5 merged composite", "route": "cuda",
         "source": "danerf_tpu_torch/kernels/csrc/merged.cu",
         "replaces": "danerf_tpu/kernels/fused_render.py:757",
         "launches": launches["merged"], "max_abs_err": errs["K5"],
         "ms": timing["k5_ms"], "plain_ms": timing["k5_plain_ms"],
         "bound_ms": timing["k5_bound_ms"], "bound_by": bound_by[1], "library_ms": None},
        train_kernel("K3 ray-march backward (want_field)", "k3", "march_bwd.cu", 212, "hier",
                     "march_bwd"),
        train_kernel("K4 merged fine pass + MSE + backward", "k4", "merged_train.cu", 831,
                     "hier", "merged_train"),
        train_kernel("K6 merged-composite backward", "k6", "merged_bwd.cu", 779, "white",
                     "merged_bwd"),
        train_kernel("K7 coarse march + MSE + backward", "k7", "march_train.cu", 449, "coarse",
                     "march_train"),
    ]
    # K1 and K8 at the 131,072 rows of the per-sample step's fine evaluation,
    # their launches from the per-sample training run
    for name, key, source, line, counter in (
            ("K1 per-sample field", "k1", "mlp_fwd.cu", 231, "mlp_fwd"),
            ("K8 per-sample field backward", "k8", "mlp_bwd.cu", 249, "mlp_bwd")):
        kernels.append({"name": name, "route": "cuda",
                        "source": f"danerf_tpu_torch/kernels/csrc/{source}",
                        "replaces": f"danerf_tpu/kernels/fused_mlp.py:{line}",
                        "launches": train_launches["per_sample"][counter],
                        "max_abs_err": errs[key.upper()], "ms": tt[f"{key}_131072_ms"],
                        "plain_ms": tt[f"{key}_131072_plain_ms"],
                        "bound_ms": tt[f"{key}_131072_bound_ms"], "bound_by": tt_bound_by[key],
                        "library_ms": None})
    # the has_time variant of each kernel: K2/K5 on the chunk, the others at
    # the batch (K1/K8 at 131,072 rows); launches from the use_time training
    # run, which no K1, K4, K7 or K8 serves (K4 and K7: no route of either
    # package; K1 and K8: the per-sample route with time, not driven here)
    for rec, key in zip(kernels, ("k2", "k5", "k3", "k4", "k6", "k7", "k1", "k8")):
        counter = {"k2": "march", "k5": "merged", "k3": "march_bwd", "k4": "merged_train",
                   "k6": "merged_bwd", "k7": "march_train", "k1": "mlp_fwd",
                   "k8": "mlp_bwd"}[key]
        if key in ("k2", "k5"):
            at = {"ms": timing_t[f"{key}_ms"], "plain_ms": timing_t[f"{key}_plain_ms"],
                  "bound_ms": timing_t[f"{key}_bound_ms"],
                  "bound_by": bound_by_t[0 if key == "k2" else 1], "at": "65,536-ray chunk"}
        else:
            shape = "131072" if key in ("k1", "k8") else "batch"
            at = {"ms": tt_t[f"{key}_{shape}_ms"], "plain_ms": tt_t[f"{key}_{shape}_plain_ms"],
                  "bound_ms": tt_t[f"{key}_{shape}_bound_ms"], "bound_by": tt_bound_by_t[key],
                  "at": "131,072 rows" if shape == "131072" else "1024-ray batch"}
        rec["variants_held"] = ["without time", "has_time"]
        rec["has_time"] = {"launches": train_launches["time"][counter],
                           "max_abs_err": errs_t[key.upper()], **at}
    # K9 at the batch, its launches from the use_hier_onepass training run,
    # beside the three kernels it replaces (K2 + K4 + K3) at the batch and on
    # the chunk, timed in this call; its has_time variant (reached by no
    # route, as in the JAX package) at the batch of the time model
    k9 = {"name": "K9 one-kernel hierarchical training step", "route": "cuda",
          "source": "danerf_tpu_torch/kernels/csrc/hier_onepass.cu",
          "replaces": "danerf_tpu/kernels/fused_render.py:1303",
          "launches": train_launches["hier_onepass"]["hier_onepass"],
          "max_abs_err": errs_k9["K9"], "ms": tt["k9_batch_ms"],
          "plain_ms": tt["k9_batch_plain_ms"], "bound_ms": tt["k9_batch_bound_ms"],
          "bound_by": tt_bound_by["k9"], "library_ms": None,
          "ms_and_two_kernel_ms": {
              "batch": [tt["k9_batch_ms"], tt["k2_batch_ms"] + tt["k4_batch_ms"]
                        + tt["k3_batch_ms"]],
              "chunk": [tt["k9_chunk_ms"], timing["k2_ms"] + tt["k4_chunk_ms"]
                        + tt["k3_chunk_ms"]]},
          "variants_held": ["without time", "has_time"],
          "has_time": {"launches": train_launches["time"]["hier_onepass"],
                       "max_abs_err": errs_k9["K9t"], "ms": tt_t["k9_batch_ms"],
                       "plain_ms": tt_t["k9_batch_plain_ms"],
                       "bound_ms": tt_t["k9_batch_bound_ms"], "bound_by": tt_bound_by_t["k9"],
                       "at": "1024-ray batch"}}
    kernels.append(k9)
    # the eval phase's launches (all its kernel-route runs) of the four
    # kernels the test-time fit and the frame run
    for rec in kernels:
        counter = {"K2": "march", "K5": "merged", "K3": "march_bwd",
                   "K6": "merged_bwd"}.get(rec["name"][:2])
        if counter:
            rec["eval_launches"] = eval_counts[counter]
    # the loaders phase's runs on the fixture scenes: train() on the custom
    # scene and `cli.main train` on the Blender scene (K2, K4, K3), evaluate()
    # with the fit on the custom scene's val view (K2, K5, K6, K3)
    for rec in kernels:
        counter = {"K2": "march", "K3": "march_bwd", "K4": "merged_train", "K5": "merged",
                   "K6": "merged_bwd"}.get(rec["name"][:2])
        if counter:
            rec["loaders_launches"] = {run: c[counter] for run, c in loader_counts.items()}
    # the jax_checkpoint phase's runs from the JAX package's checkpoint
    # directory: the 800x800 frame (K2, K5) and the resumed training (K2, K4,
    # K3)
    for rec in kernels:
        counter = {"K2": "march", "K3": "march_bwd", "K4": "merged_train",
                   "K5": "merged"}.get(rec["name"][:2])
        if counter and "f32" not in rec["name"]:
            rec["jax_checkpoint_launches"] = {run: c[counter] for run, c in jax_counts.items()}
    # the full_scale phase's run of the study's scripts (K2, K4, K3, K5)
    for rec in kernels:
        counter = {"K2": "march", "K3": "march_bwd", "K4": "merged_train",
                   "K5": "merged"}.get(rec["name"][:2])
        if counter and "f32" not in rec["name"]:
            rec["full_scale_launches"] = full_scale_counts[counter]
    # data parallelism: the launches of the data-parallel training run (K2,
    # K4, K3), of a sharded 800x800 frame on the one rank (K2, K5) and of
    # make_sharded_render's 65,536-ray chunk (K1)
    for rec in kernels:
        key = rec["name"][:2]
        counter = {"K2": "march", "K4": "merged_train", "K3": "march_bwd"}.get(key)
        if counter:
            rec["dp_train_launches"] = train_launches["hier_dp"][counter]
        if key in ("K2", "K5"):
            rec["sharded_frame_launches_per_rank"] = dist_frame["frame"]["launches"][
                "march" if key == "K2" else "merged"]
        if key == "K1":
            rec["sharded_render_launches_per_chunk"] = dist_frame["sharded_render"][
                "launches"]["mlp_fwd"]
    # the f32 variants (use_bf16=False) of K2, K5 and K1: launches from the
    # f32 800x800 frames (K2, K5) and the f32 per-sample routes (K1), without
    # and with time; times on a chunk (K1 at 131,072 rows, also at 65,536)
    # beside their bounds at 3xTF32's (csrc/field_f32_sm90.cuh) with FP32's
    # FFMA bound beside
    for name, key, source, line, counter, path, path_t in (
            ("K2 ray march (want_field), f32", "k2", "march_f32.cu",
             "fused_render.py:155", "march_f32", "frame_launches", "time_frame_launches"),
            ("K5 merged composite, f32", "k5", "merged_f32.cu", "fused_render.py:757",
             "merged_f32", "frame_launches", "time_frame_launches"),
            ("K1 per-sample field, f32", "k1", "mlp_fwd_f32.cu", "fused_mlp.py:231",
             "mlp_fwd_f32", "k1_launches", "time_k1_launches")):
        tm = f32["timing"]
        at = "_131072" if key == "k1" else ""
        extra = {"ffma_bound_ms": tm[f"{key}{at}_ffma_bound_ms"]}
        if key == "k1":
            extra["at_65536_rows"] = {k: f32b_timing[f"k1_65536_{k}"]
                                      for k in ("ms", "bound_ms", "ffma_bound_ms")}
        kernels.append({
            "name": name, "route": "cuda", "source": f"danerf_tpu_torch/kernels/csrc/{source}",
            "replaces": f"danerf_tpu/kernels/{line}", "launches": f32[path][counter],
            "max_abs_err": errs_f32[key.upper()], "ms": tm[f"{key}{at}_ms"],
            "plain_ms": tm[f"{key}{at}_plain_ms"], "bound_ms": tm[f"{key}{at}_bound_ms"],
            "bound_by": f32["bound_by"][key], "library_ms": None, **extra,
            "config": "use_bf16=False", "bf16_over_f32_error_ratio_worst": f32_ratio,
            "variants_held": ["without time", "has_time"],
            "has_time": {"launches": f32[path_t][counter],
                         "max_abs_err": errs_f32[key.upper() + "t"],
                         "ms": tm[f"{key}t{at}_ms"], "plain_ms": tm[f"{key}t{at}_plain_ms"],
                         "bound_ms": tm[f"{key}t{at}_bound_ms"],
                         "bound_by": f32["bound_by"][key + "t"],
                         "at": "131,072 rows" if key == "k1" else "65,536-ray chunk"}})
    # the f32 variants (use_bf16=False) of K3, K4, K6 and K7: launches from
    # the f32 train() run (K3, K4), the f32 evaluate fit (K6) and the f32
    # coarse-only chained run (K7); the has_time variants' from the f32
    # use_time step (K4 and K7: no route reaches them with time); times at
    # B = 1024 and at 8,192 rays beside their bound (3xTF32,
    # csrc/field_bwd_f32_sm90.cuh) at 3xTF32's with FP32's FFMA bound beside
    for name, key, source, line, counter, launches in (
            ("K3 ray-march backward (want_field), f32", "k3", "march_bwd_f32.cu", 212,
             "march_bwd_f32", f32_train["train"]),
            ("K4 merged fine pass + MSE + backward, f32", "k4", "merged_train_f32.cu", 831,
             "merged_train_f32", f32_train["train"]),
            ("K6 merged-composite backward, f32", "k6", "merged_bwd_f32.cu", 779,
             "merged_bwd_f32", f32_train["eval"]),
            ("K7 coarse march + MSE + backward, f32", "k7", "march_train_f32.cu", 449,
             "march_train_f32", f32_train["coarse_chained"])):
        tm = f32b_timing
        kernels.append({
            "name": name, "route": "cuda", "source": f"danerf_tpu_torch/kernels/csrc/{source}",
            "replaces": f"danerf_tpu/kernels/fused_render.py:{line}",
            "launches": launches[counter], "max_abs_err": errs_f32b[key.upper()],
            "ms": tm[f"{key}_1024_ms"], "plain_ms": tm[f"{key}_1024_plain_ms"],
            "bound_ms": tm[f"{key}_1024_bound_ms"], "bound_by": f32b_bound_by[key],
            "ffma_bound_ms": tm[f"{key}_1024_ffma_bound_ms"],
            "library_ms": None, "config": "use_bf16=False", "at": "1024-ray batch",
            "bf16_over_f32_error_ratio_worst": f32b_ratio,
            "at_8192_rays": {"ms": tm[f"{key}_8192_ms"], "plain_ms": tm[f"{key}_8192_plain_ms"],
                             "bound_ms": tm[f"{key}_8192_bound_ms"],
                             "ffma_bound_ms": tm[f"{key}_8192_ffma_bound_ms"]},
            "variants_held": ["without time", "has_time"],
            "has_time": {"launches": f32_train["time_step"][counter],
                         "max_abs_err": errs_f32b[key.upper() + "t"],
                         "ms": tm[f"{key}t_1024_ms"], "plain_ms": tm[f"{key}t_1024_plain_ms"],
                         "bound_ms": tm[f"{key}t_1024_bound_ms"],
                         "ffma_bound_ms": tm[f"{key}t_1024_ffma_bound_ms"],
                         "bound_by": f32b_bound_by[key + "t"], "at": "1024-ray batch"}})
    # the f32 variants of K8 and K9 (3xTF32, csrc/field_bwd_f32_sm90.cuh):
    # launches from the f32 per-sample and one-kernel chained runs (10 steps
    # each); K8 at the 131,072 rows of the per-sample step's fine evaluation
    # (also at its 65,536 coarse rows), K9 at B = 1024, beside 3xTF32's
    # bound and FP32's FFMA bound; their has_time variants are held and
    # timed, and no run here drives them (K8's: the per-sample route with
    # time; K9's: no route, as in the JAX package)
    n = cfg.batch_size
    for name, key, source, line, counter, at, run in (
            ("K8 per-sample field backward, f32", "k8", "mlp_bwd_f32.cu", "fused_mlp.py:249",
             "mlp_bwd_f32", "131072", "per_sample_chained"),
            ("K9 one-kernel hierarchical training step, f32", "k9", "hier_onepass_f32.cu",
             "fused_render.py:1303", "hier_onepass_f32", str(n), "hier_onepass_chained")):
        tm = f32b_timing
        rec = {"name": name, "route": "cuda", "source": f"danerf_tpu_torch/kernels/csrc/{source}",
               "replaces": f"danerf_tpu/kernels/{line}", "launches": f32_train[run][counter],
               "max_abs_err": errs_f32b[key.upper()], "ms": tm[f"{key}_{at}_ms"],
               "plain_ms": tm[f"{key}_{at}_plain_ms"], "bound_ms": tm[f"{key}_{at}_bound_ms"],
               "bound_by": f32b_bound_by[key],
               "ffma_bound_ms": tm[f"{key}_{at}_ffma_bound_ms"], "library_ms": None,
               "config": "use_bf16=False",
               "at": "131,072 rows" if key == "k8" else "1024-ray batch",
               "bf16_over_f32_error_ratio_worst": f32b_ratio,
               "variants_held": ["without time", "has_time"],
               "has_time": {"launches": 0, "max_abs_err": errs_f32b[key.upper() + "t"],
                            "ms": tm[f"{key}t_{at}_ms"], "plain_ms": tm[f"{key}t_{at}_plain_ms"],
                            "bound_ms": tm[f"{key}t_{at}_bound_ms"],
                            "bound_by": f32b_bound_by[key + "t"],
                            "at": "131,072 rows" if key == "k8" else "1024-ray batch"}}
        if key == "k8":
            rec["at_65536_rows"] = {"ms": tm["k8_65536_ms"], "plain_ms": tm["k8_65536_plain_ms"],
                                    "bound_ms": tm["k8_65536_bound_ms"],
                                    "ffma_bound_ms": tm["k8_65536_ffma_bound_ms"]}
        kernels.append(rec)
    # the parity phase's study (K2, K3, K4, K5, K7 and their f32 variants)
    for rec in kernels:
        counter = {"K2": "march", "K3": "march_bwd", "K4": "merged_train", "K5": "merged",
                   "K7": "march_train"}.get(rec["name"][:2])
        if counter:
            rec["parity_launches"] = parity_counts.get(
                counter + ("_f32" if "f32" in rec["name"] else ""), 0)
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
