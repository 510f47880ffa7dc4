"""Drive the PyTorch port's production SAE train step, one training job
around it, inference, extraction, interpretation, trait discovery,
interactive interpretability, contrib's analysis of runs and its notebook
drivers after it, on one CUDA card (and its multi-process training on two
ranks).

    python3 chip_smoke.py

Phases, one output line or more each, in order; any failure raises and the
script exits non-zero:

1. device    -- a CUDA card must be present (no CPU fallback); prints its name
                and the `nvidia-smi` name and power limit.
2. build     -- compiles saev_tpu_torch/csrc/*.cu with nvcc (ops/_build.py),
                one nvcc for each source, all started together; the wgmma
                products (K2's and K7's `prefix_wgmma_kernel`, K3's, K4's,
                and P1's `encode_stats_wgmma_kernel`) must hold wgmma (HGMMA)
                and TMA loads (UTMALDG) in their SASS, no mma.sync (HMMA),
                and no spills in ptxas's report, and P1's no ptxas report of
                serialized wgmma;
                K2's and K7's resident CTAs an SM are logged, and K1's, P1's,
                K5's and K6's registers and spills (their wide route's too);
                K1's streamed kernel at the production width may use at most
                126 registers and P1's product at most P1_REGISTERS, neither
                spilling (K6 runs
                K1's select); P3's and P4's kernels (csrc/kth_ops.cu,
                streamed and one CTA a row) log their registers and may not
                spill; P2's product
                (`gouter_wgmma_kernel`) must hold HGMMA, no HMMA, no spills,
                and the multicast form of the TMA load
                (UTMALDG.2D.MULTICAST).
3. parity    -- each kernel against its plain PyTorch version on the same
                CUDA tensors at the production shape (batch 16384, d_sae
                16384, d_model 1024, k 32, 10 prefixes), plus edge cases; K1
                with the count of rows that took its whole-row fallback
                (rows 0, 3 and 4 of the production batch: zeros, ties over
                twice the candidate buffer, -0.0 over half the row; none of
                the Gaussian rows); K6 also against K1's kth and P4's exact
                modes, streamed and one CTA a row, with the count of rows
                that took its whole-row fallback (K1's rows); K5 at the
                dense (16384 x 16384) and both subspace rungs' shapes (16384
                x 1024 and 16384 x 4096), k_aux 512, under masks that leave
                the dead columns (819, 5%; 3276, 20%, on the wide rung;
                pinned at -1e6 as bench.py pins them) as a prefix and
                scattered, fewer than k, none and all; K3's dA bit for bit, on
                both cut sets and on 64, 65 and 128 cuts (1024 rows); K4's
                dW within rel-norm 1e-4 and the same bits in two calls, on
                the same five cut sets; K2 and K7 at 65 and 128 cuts against
                their plain versions; K2 (E, xhat, loss, the same bits in
                two calls), K3 and K4 also at batch 16384 on the wide steps'
                shapes: d_sae 65536 with 10 sampled cuts and d_sae 16384
                with 65. No card call of a parity case runs a plain version
                (a spy on them).
   wide      -- K1, K6 (k 32 and 512) and K5 (k 512) at 16384 x 65536 and
                16384 x 131072, where their wrappers take csrc/kth_wide.cu
                (K1 and K6 a thread block cluster a row, K5 the group route
                up to 32768 unmasked columns and the cluster past them), on
                the parity phase's edge rows, bit for bit against their plain
                versions (K1's and K6's rows 0 and 4 take the whole-row
                fallback at k 32; K6's at k 512 are K1's there), K5 under 5%,
                40% and 60% of the columns unmasked as a prefix and
                scattered, none, fewer than k and all, its fallback rows
                logged (none); then timed against their plain versions,
                torch.topk and their byte bounds, K5 also at 40% and 60%
                unmasked and none masked, with the sector bound of its
                scattered masks. Then the walk, at 512 x 266240 (past the
                cluster route's 8 slices): K1, K6 and K5 the same way.
4. reference -- the step on the card (kernel path, matmul_precision
                "default": bf16 operands with f32 results) against the same
                step on the CPU (plain f32 path) at a small shape: the
                warm-up step (also at d_model 64, which the Matryoshka
                kernels take padded to 128), and the AuxK step, dense and
                subspace, with 1/16 of the latents pinned dead; K1-K4 launch
                once a step and SAE; the card's encoder product against the
                bf16 algebra of its operands on the CPU. Then a Relu sweep
                (L1 4e-4 and 1e-3; K2-K4 launch) and a BatchTopK sweep (k 8,
                AuxK 64, momenta 0.1 and 0.3, 1/16 pinned dead; K2-K5
                launch), each against the CPU within 1e-2, BatchTopK's
                threshold too. First it logs how far "default" products lie
                from the exact sum by K.
5. slice     -- the warm-up train step (TopK 32 + Matryoshka 10, Adam,
                aux_enabled=False) at full width: 5 steps of one SAE and 2 of
                a two-SAE sweep, then one step at batch 1000 (padded to the
                kernels' 128-row tile) held to the same step on the CPU, its
                encoder product to the bf16 algebra on the CPU, counting
                kernel launches.
   wide steps -- the step at shapes the card refused before: d_sae 65536
                (TopK 32, AuxK 512, Matryoshka 10, Adam; warm, tight rung and
                dense, 5% of the latents pinned dead), d_sae 131072 dense
                with 30% dead (K5 past 32768 unmasked columns, on the
                cluster route) and the production
                shape with 65 prefixes (warm), each held to the CPU's f32
                step at batch 1024 (1e-2, L0 and n_dead equal, no plain
                version run), then 3 steps at batch 16384: ms/step and peak
                memory.
6. steady    -- the step router (`make_step_router`) over the AuxK step at
                full width, from aux_from_step - 1, on states with 5%, 2%, 20%
                and 40% of the latents pinned dead, at n_sae 1 and 2: the
                variant sequence (warm, dense until the first readout, then
                the rung that holds n_dead), n_dead, launches per step, and
                subspace aux against dense aux from one state: the tight rung
                at 5% dead, the wide rung at 20%. Those two check steps are
                not counted as the path's launches.
7. metrics   -- the log-step metrics (`make_metrics_fn`) once at full width on
                the two-SAE state at 5% dead.
8. timing    -- each kernel's time against its plain version's; K1 also by
                the profiler, with the count of rows that fell back (on
                Gaussian rows and on the two-SAE state's pre-activations);
                K2's, K3's and K4's launches by the profiler, at both cut sets, each
                beside its own bound (K2 and K4 also beside their dense
                floor), and a cuBLAS product of each one's main term as a
                yardstick (K2: f @ W with bf16 operands).
9. benches   -- the kernel-level entry points (saev_tpu_torch/scripts) at the
                production shape: first K7, P1, P2, P3 and P4 held to their
                plain versions (K7 also bit for bit to K2's xhat and E, with
                both cut sets of the parity phase; P2 also to K2 with the JAX
                script's limits; P1's statistics bit for bit to K1 on P1's
                own h, with the rows that took its exact route; P4's exact
                modes bit for bit to torch.topk and K6, on
                the script's rows and on edge rows), P4's tensor-core count
                found in mxu's SASS alone, and the pass loops of P4's modes
                and P3 read from the SASS (instructions and the longest
                register chain a key); then the entry points' own
                measured work, counted: kprof's profile of K6, K7, K3 and K4,
                P2 against K2, P1's fused-against-two-pass A/B and its time
                split (the profiler's two launches, and clock64 stamps in a
                copy of its source: `select_probe.p1_phases`, also on rows
                ascending in column order), P3 at 32, 16
                and 8 passes against K6, P4's five modes against K6 and the
                library's k-th value; then each new kernel timed against its
                plain version, P4 also in each mode and P3 at 32, 16 and 8
                passes, and P1 beside its two-call yardstick (the bf16
                encoder, `modeling._linear_bias(..., "default")`, then K1,
                each timed). It logs the sha256 of P2's and K2's outputs
                on the P2 script's operands and of K7's on kprof's, to hold
                their bits across commits.
10. profile  -- torch.profiler over the warm, tight-rung and dense steps at
                full width (warm and tight also at n_sae 2): wall and device
                ms/step, the device's idle share and the 15 kernels that take
                the most device time, K2's, K3's and K4's products among
                them.

11. job      -- one training job of the port (`framework.train.worker_fn`)
                at the production width, n_sae 2 (lr 4e-4 and 1e-3): shards
                written with the port's ShardWriter into a temporary root
                (train 1024 x 256 tokens, val 128 x 256; each row Gaussian on
                16 of 16384 random directions, plus noise), read through the
                shuffled loader (its shard I/O route logged), datapoint
                init, 12 steps (warm, then AuxK from step 2 as the router
                picks), checkpoints every 4 steps, the local JSONL run
                recorder, eval on 2 batches at "highest" and the SAE files.
                Requires K1-K6 launched and no plain version, the log step's
                normalized MSE (full reconstruction) down from the first log
                to the last, eval L0 32 (ties at the 32nd value kept) and
                normalized MSE below 1, the files bit for bit the trained
                params, the step-12 checkpoint alone left. Logs the loop's
                steady ms/step beside the step alone at n_sae 2, the
                loader's rows/s, eval's s/batch and the job's peak memory.
12. inference -- the port's inference (`framework.inference.worker_fn`) on
                the job's two SAE files, over the job's val shards (32768
                rows, the set its eval read whole), then its train shards
                (262144 rows, 16 batches of 16384). Requires K6 launched
                once per SAE and batch and no plain version, the five files
                written and a second call writing nothing, one batch's CSR
                equal to `scipy.sparse.csr_array` of that batch's dense f
                (recomputed on the card, copied whole), token_acts' mean nnz
                a row in [32, 32.001], and on the val shards sparsity and
                mean_values equal to the eval's freqs and mean_values within
                1e-4 relative (where finite), metrics.json's normalized MSE
                within 1e-4 of the eval's. Logs tokens/s, seconds a batch
                split into loader wait, forward, compaction and host
                assembly, and peak memory.
13. interpret -- the interpretation layer, while the job's SAE files
                exist: (1) the inference example's `run`
                (`saev_tpu_torch.examples.inference`) on CLIP ViT-L/14 from a
                random OpenCLIP checkpoint (257 positions, as the extract
                phase builds it), the job's first SAE file at layer -2, one
                synthetic 300 x 260 PNG drawn with numpy, select "max", k 5:
                K6 launched once (256 rows x 16384, TopK 32) and no plain
                version, five 224 x 224 heatmaps, f_x bit for bit the same
                forward with K6's plain version on the card and agreeing
                with the CPU's f32 SAE forward on the same activations
                (`topk_vs_cpu`: a latent kept on one side only is a tie
                within the two products' rounding, and the other entries
                are within INTERP_REL_MSE relative MSE); logs what "filtered" selects, and by
                CUDA events the Recorder call, the SAE forward and the
                host's compositing, cold (that run) and warm (a second
                run), and K6 at the example's shape against its plain
                version, the library and its bound; (2) Grad-CAM's `run`
                (`saev_tpu_torch.scripts.gradcam`) on the same checkpoint and
                image, gradcam, gradcam++ and eigencam at "default" (bf16
                products forward and backward, through
                `modeling._Matmul`): tap gradients finite and not zero, no
                saev kernel; the tap gradient within GRADCAM_REL rel-norm of
                "highest"'s from the same tap (and, logged, from its own
                tap); CUDA events time the forward to the tap,
                `forward_from` and the backward; logs whether
                torch.mm(..., out_dtype=) has a derivative here; (3) the
                example's `demo` on the card (the fake backend's extraction,
                a d_sae 64 SAE: K6 once, three heatmaps). First it logs
                whether Pillow, matplotlib, scikit-learn and pandas import
                (it needs Pillow alone, and stops naming it without it).
                Then the job's root is removed.
14. activations -- Relu and BatchTopK at full width: K2-K4 held to their
                plain versions on a Relu layer's dense latents (about half
                nonzero) first, then two sweeps of 2 SAEs, 4 steps each, on
                `make_train_step`: BatchTopK (k 32, AuxK 512 in the tight
                subspace, momenta 0.1 and 0.3, 1/16 of the latents pinned
                dead) and Relu (L1 4e-4 and 1e-3). Requires K2-K4 (and K5 for
                BatchTopK) launched once a step and SAE and no plain
                version, every stat and parameter finite, BatchTopK's mean L0
                in [32, 32 + 4/B] and its new threshold (1 - m) * old + m *
                (least positive kept value, read from the step's f). Logs
                ms/step, peak memory and the batch-global k-th value's time.
15. muon     -- Muon (`optim="muon"`) at the steady phase's shape, n_sae 2,
                "default", the tight rung with 5% of the latents pinned dead:
                first 3 steps of a small 2-SAE sweep (d_model 128, d_sae
                2048; warm-up and AuxK subspace with 1/16 dead) against the
                CPU's f32 step within 1e-2, l0 and n_dead equal, K1-K4 (and
                K5 with AuxK) once a step and SAE; then 1 + 5 steps at full
                width (K1-K5 once a step and SAE; CUDA events): ms/step,
                Newton-Schulz ms a call and peak memory; then the first
                step's Newton-Schulz inputs (both leaves of both SAEs)
                iterated in f32 on the card against f64 on the card
                (NS_REL), the CPU's f32 iteration beside it.
16. high     -- matmul_precision "high" (bf16x3 on the card), Adam, the
                muon phase's shapes: the small sweep against the CPU's f32
                step within HIGH_STEP_REL (mse, loss, grad_norm), l0 and
                n_dead equal, K6 (and K5 with AuxK) once a step and SAE and
                K1-K4 never; the encoder's product at full width within
                HIGH_REL of f64 and HIGH_GAIN times closer than "default",
                timed beside the bf16 and f32 products; then 1 + 5 steps at
                full width (K6 and K5 once a step and SAE, K1-K4 never):
                ms/step and peak memory.
17. extract  -- activation extraction at full width, in a temporary root
                that it removes: 272 synthetic 5 s clips (int16 .wav, 32
                kHz) in BirdCLEF 2025's layout, 16 of them under a non-Aves
                label, and a random timm-layout Bird-MAE-Large checkpoint
                (d_model 1024, 24 layers, 16 heads; `torch.save`), through
                `framework.shards.cli` on "cuda" (batch 64, taps at layers
                11 and 23 on norm2, 3 acts files). Requires ShardInfo to
                validate, the 16 clips filtered out, the first batch's shard
                rows bit for bit a second card forward and within BF16_REL
                rel-norm of the CPU's float32 forward (2 clips), and the
                shuffled loader's batch of layer 23 equal to the shard rows.
                Logs clips/s, tokens/s, a batch split into loader wait (wav
                read and filterbank), forward, the copy to the host and the
                write, and peak memory. Then CLIP ViT-L/14 (a random
                OpenCLIP checkpoint through `convert.from_openclip`) and
                DINOv3 ViT-L/16 (random params; one batch also on two
                grids) through `Recorder` on Gaussian patch tokens at batch
                128, each within BF16_REL of its float32 forward on the
                card, and bit for bit the taps of the dense products' route
                before `modeling._Matmul` (one `_mm_bf16` call each):
                images/s and peak memory. Then (a) the same
                `framework.shards.cli` config at `multi_layout`'s ranks
                (one card a rank over NCCL with 2 cards or more, else 2
                ranks on cuda:0 over gloo: a record, not a speedup), each
                rank its own batches (`parallel.batch_spans`), spawned with
                a limit (EXTRACT_RANKS_LIMIT) and, as torchrun spawns its
                workers, OMP_NUM_THREADS=1: the second directory bit for
                bit the first (every file, the file list), each rank's
                forwards its share of the batches; logs clips/s at 1 and W
                ranks and each rank's loader wait, forward and write; and
                (b) DINOv2 ViT-L/14 with 4 registers from a random torch.hub
                checkpoint with the released 1 + 37 x 37 position table,
                resized onto the 16 x 16 grid by `vit.interpolate_pos`'s
                numpy bicubic with Pillow blocked from import, through
                `Recorder` as CLIP's and DINOv3's.
                Launches no saev kernel; logs whether Pillow and pandas
                are importable (it needs neither).
18. multi    -- training over torch.distributed (`multi_layout`): one
                rank (process) a card over NCCL where there are 2 cards or
                more, up to 4, else 2 ranks on cuda:0 over gloo (logged),
                spawned after the kernels are built, with a limit
                (MULTI_LIMIT) past which they count as stalled and are
                killed. At the steady phase's shape (n_sae 2, or one a rank,
                the tight AuxK rung, 5% pinned dead), from one seeded
                state and 3 seeded global batches of which each rank takes
                its share: (a) the data-parallel step (n_data = ranks) held to the
                one-rank step in this process (stats within
                MULTI_DATA_STAT_REL, params within MULTI_DATA_PARAM_REL
                rel-norm, n_dead equal); (b) the sweep-parallel step
                (sweep_parallel = ranks, one SAE a rank, the rows gathered) bit
                for bit the one-rank sweep; (c) BatchTopK (k 32, momenta 0.1
                and 0.3, ...) at n_data = ranks, its moved threshold within
                MULTI_THRESHOLD_REL of the one-rank step's; (d) `worker_fn`
                over the ranks on shards written here (a train and a val shard
                a rank), checkpoints every 2 steps, stopped on every rank
                once step 2's is written, resumed to step 4, eval, the SAE
                files: rank 0 writes every checkpoint and each file once and
                the others none, the files load with `nn.load` bit for bit
                the trained params, eval L0 32; (e) feature-parallel
                training (feature_parallel = ranks, one SAE, TopK 32, AuxK
                512, 5% pinned dead, Adam) through `make_step_router` from
                one step before AuxK starts: warm, dense, then the tight
                rung, 3 steps; (f) the same at d_sae 65536 (the one-rank
                step's threshold takes the wide route, csrc/kth_wide.cu,
                a shard of 32768 or fewer the narrow one); one Muon step
                under (e)'s layout. Each held to the one-rank step from the
                same state and batches: every step's TopK threshold bit for
                bit K6 (or its wide route) on the whole rows the feature
                group gathers, and the first step's bit for bit the
                one-rank step's where the pre-activations are the same
                bits; n_dead and the route equal; stats within
                MULTI_FEATURE_STAT_REL and params within
                MULTI_FEATURE_PARAM_REL rel-norm. Before the ranks start,
                K1's threshold entry is held bit for bit to K1 on the same
                rows (at (e)'s shard and through the wide route) and to
                its plain version, and the candidate step of the sharded
                threshold (csrc/kth_shard.cu) to its plain version. Each
                rank's cohort is the same bits as the others', K1-K5 launch
                on every rank in (a) and (b), K2-K5 in (c), K1-K6 in (d),
                K1's threshold entry, K3-K7 and the candidate step in (e)
                and (f) and K2 not, no plain version runs. Logs each case's
                ms/step on every rank beside the one-rank step's, the ms of
                the data step's gradient all-reduce and of the sweep group's
                row gather, and the feature group's base all-reduce and
                candidate gathers.

19. tdiscovery -- trait discovery at ViT-L/14 width (d_model 1024, d_sae
                16384), in a temporary root that it removes: (a) probe1d's
                `Sparse1DProbe` fit on the card over a seeded CSR x of
                1,048,576 tokens x 16384 latents, 32 nonzeros a row (33.5M
                events) and 10 classes with planted (latent, class) pairs,
                at the `Config` defaults (class slab 8, max_iter 30, 4096 MiB):
                a second fit the same bits; 16 sampled pairs (the planted
                ones, the empty latent, drawn ones) within rtol 1e-3 and
                atol 1e-4 of `Reference1DProbe` (float64 numpy, 8 host
                threads); `loss_matrix_with_aux`'s counts integers, equal to
                numpy's on those pairs; logs the fit's wall seconds, each LM
                iteration's ms (CUDA events), n_iter_ by slab and peak
                memory. (b) `SparseAutoencoderScorer.transform` of a random
                schema-5 TopK-32 SAE file over 3 batches of 16384 rows: K6
                at 16384 x 16384, f_x bit for bit the forward with K6's
                plain version; logs ms a batch and the forward alone, and K6
                on the scorer's h against its plain version, the library and
                its bound. (c) `python -m saev_tpu_torch.tdiscovery`
                baseline::train (k-means, k 4096, eval on the test shards),
                baseline::inference on both splits, probe1d and metrics, on
                labelled shards of the port's writer (128 + 64 images of 256
                tokens, labels.bin), then `fishvista.evaluation.worker_fn`
                with method sae (K6) and kmeans (the trained run): every
                artifact loaded back; logs each command's seconds. (d) the
                k-means step alone at 16384 x 1024 x 16384: its inertia
                within 1e-5 of float64 distances on the card, the share of
                assignments off the float64 argmin, ms a step. K6 launched
                once a scored batch and nothing else, no plain version.

20. interactive_interp -- contrib's interactive interpretability at
                ViT-L/14 width (d_model 1024, 256 tokens an image, ADE20K's
                151 classes), in a temporary root that it removes: labelled
                shards of the port's writer (512 train images, 256 val
                images: 4 ordered batches of 16384), a schema-5 TopK-32 SAE
                at d_sae 16384 whose first 302 latents read and write the
                clusters the tokens are drawn around. (a) semseg: `train`
                of 6 probes (3 lr x 2 wd) at batch 4096 over 131072 tokens,
                each probe's loss falling from the first step to the last,
                and the `train` subcommand; `validate` (host numpy) on 8
                images; `visuals`; `quantify` with all three methods, twice,
                the same CSV; `interactive` (8 examples). (b) semprobe
                `score` on 64 images, two tasks. (c) the [CLS] probe grid
                (2 lr x 2 wd, a TOML sweep) on [CLS] shards of an image
                folder of 3 classes. (d) FishVista's `supervised` grid at
                its 10 classes. (e) birdsong's `trace_report(out_dir=None)`
                on a random Bird-MAE-Large checkpoint with channel 295
                planted, 2 clips: found on the card and on the CPU, the
                card's dominance and channel means within BF16_REL of the
                CPU's. K6 launched exactly as the encodes call it (one a
                batch, one an embedded example), no plain version; a
                batch's f_x agreeing with the CPU's f32 forward on its
                first 2048 rows (`topk_vs_cpu`, 1e-4). Logs each step's seconds,
                the probe step's ms, an encode batch's ms split into K6 and
                the rest, and K6 at 16384 x 16384 and 256 x 16384 against
                its plain version, the library and its bound, each beside
                the card's name and power limit.

21. contrib_host -- contrib's host-side analysis on runs that the port's
                inference writes on the card at ViT-L/14 width (d_model
                1024, d_sae 16384, TopK 32), in a temporary root that phase
                22 reuses: two splits of 64 images of 256 tokens (4 classes
                named as Heliconius subspecies, labels.bin, an
                ImgSegFolder of 8 x 8 PNGs and masks as the shards' dataset,
                a random OpenCLIP ViT-L/14 file as their model), two runs
                (the second one's latents the first's permuted), inference
                at batch 4096 on both splits of both (K6 once a batch, 16
                batches). Then on the host: the card's token_acts agreeing
                with the CPU's f32 encode on 2048 rows (`topk_vs_cpu`,
                1e-4);
                cls::train where scikit-learn imports (else its ImportError,
                and a nearest-mean linear head written in cls::train's
                checkpoint format), cls::eval (accuracy at least 0.75) and
                cls::audit (the planted latents grounded in their classes);
                mimics' tasks, scoring on both runs (the same best
                separations), consistency (1 with the permuted witness),
                checkpoint discovery and the scores browser; clsview's and
                the audit's frames (pandas), the audit battery where
                matplotlib imports. Logs each step's wall seconds and K6's
                launch count; its line before its last names the modules it
                ran and those it could not import.

22. contrib_last -- the last of contrib, in phase 21's root (which phase
                23 reads, then main removes) at Bird-MAE-Large's width
                (d_model 1024, 24 layers, 256 content tokens a clip): (a) 64 synthetic
                BirdCLEF clips, 16 with a 10 kHz tone over time patches
                10-12, a random Bird-MAE-Large checkpoint with channel 295
                planted (phase 20(e)'s plant), `framework.shards.cli` at
                layer 11 (16384 rows), a TopK-32 SAE at d_sae 16384 whose
                latent 7 reads the tone's direction (measured from the
                shards: the tone's patches against the other clips'),
                inference at batch 4096 (K6 once a batch), then
                `birdsong.visuals`, `make_html --embed`, `browse` and
                `stats` (against phase 21's validation shards): latent 7's
                top clips all planted, its time clip the tone's window,
                channel 295 the first outlier, a card a latent on the page;
                the card's token_acts agreeing with the CPU's f32 encode
                on 2048 rows (`topk_vs_cpu`, 1e-4). (b) on phase 21's runs:
                `runs.load_df`, `results` over seeded Result JSONs,
                `logparse` over the stats log of a probe1d fit on the card,
                `fishbase` (the planted latents best for their parts),
                `mimicry` (pair counts; the harvest of the nearest-mean
                head where scikit-learn is missing), `figplots` and
                `ablations` tables, and their figures where matplotlib
                imports (else their ImportError). (c) `extract_tol` over a
                TreeOfLife store of phase 21's images (the HDF5 read where
                h5py imports, else its ImportError), `tdiscovery.visuals`
                on r1 (the shards' random OpenCLIP ViT-L/14 checkpoint,
                written now) and `make_gallery` over its images. (d)
                `format_ade20k`, `format_fishvista`, `materialize`,
                `parse_environment` and `push_dinov3 --dry-run` (phase
                21's and b1's SAE files loaded on the card). K6 launched
                once an inference batch and no plain version; logs each
                step's seconds, the extraction's clips/s, and the modules
                that ran and the packages that could not be imported.
23. notebooks -- contrib's 21 notebook drivers that reach the JAX package,
                as the port's copies (saev_tpu_torch/{birdsong,tdiscovery}/
                notebooks, saev_tpu_torch/mimics/exps), in one process that
                runs each as `python <file>` runs it (`runpy`, with its
                environment and working directory) over phases 21's and
                22's root: the runs' token_acts (K6 inferred them on the
                card), shards and images, and what the phase writes from
                them in root/nb (a summary and a JSONL tracker from each
                run's inference, study runs and a k-means baseline run
                beside r1 and r2, seeded probe metrics). birdset runs its
                channel trace (BIRDSET_TRACE=1) on the card at
                Bird-MAE-Large width from phase 22's checkpoint and must
                print channel 295; every driver runs to its end with
                contrib's printed markers, or stops on the ImportError of
                a package this machine lacks (matplotlib, scikit-learn)
                after printing what comes before it; logs each driver's
                seconds. Launches no kernel: the drivers' process counts
                every kernel's launches from 0 and must read none.

Kernel launches are counted per driven path (slice, wide steps, steady,
metrics, benches, job, inference, interpret, activations, muon, high, multi: each rank's
counts, summed; tdiscovery; interactive_interp; contrib_host; contrib_last;
notebooks, in its drivers' process): every count is set to 0 just before
the path and read just after.

The line before the last is {"kernels": [...]} with every number measured or
computed in this run: besides ms and plain_ms, each kernel's bound_ms (the
larger of its bytes over the card's memory rate and its operations over the
peak rate of their type; bound_by names which) and library_ms (one PyTorch
call computing the same function, null where there is none; lib_ms repeats
it); P1's entry adds yardstick_ms, the two calls it fuses. The last line
is {"ok": true, "device": {...}}.
"""

import contextlib
import dataclasses
import datetime
import hashlib
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

B, D_MODEL, D_SAE, TOP_K, N_PREFIXES, GROUP = 16384, 1024, 16384, 32, 10, 1024
K_AUX, TIGHT, WIDE = 512, 1024, 4096  # AuxK k and subspace_cap_ladder(16384, 512)
N_DEAD_5 = int(D_SAE * 0.05)  # 819 latents: bench.py's dead set
N_DEAD_20 = int(D_SAE * 0.20)  # 3276 latents: the wide rung's case
RAGGED_B = 1000  # a batch that is not a multiple of the kernels' 128-row tile
WIDE_S = (65536, 131072)  # rows wider than the narrow select kernels' 32768 columns
WALK_B, WALK_S = 512, 266240  # rows past the cluster route's 8 slices of 32768: the walk
D_SAE_WIDE = 65536  # the "64x" dictionary at d_model 1024
D_SAE_HUGE, DEAD_HUGE = 131072, 0.3  # the "128x" dictionary's dense step: K5 past 32768 unmasked columns
N_PREFIXES_MANY = 65  # past 64 prefixes, as fault ROADMAP §3.6 reproduces it
REFERENCE_B = 1024  # the batch at which a full-width step is held to the CPU's
# Nonzeros a row of the parity phase's production f (10% of d_sae 16384, and
# a tenth more for the draw): up to there K2's loss is held to its plain
# version's within 1e-5 (`_k2_case`). Past it (d_sae 65536 at 6553 a row, a
# Relu layer's latents at 8192) the loss is held within K2_DENSE_LOSS_REL
# and the kernel's xhat within K2_DENSE_DRIFT rel-norm of the f64 product:
# each about 2-3x the largest value an H100 gave (loss 1.51e-5, xhat
# 2.28e-5, both at d_sae 65536), and the drift bound half the 1e-4 that
# holds xhat to the plain version.
PRODUCTION_NNZ_ROW = 0.11 * 16384
K2_DENSE_LOSS_REL = 5e-5
K2_DENSE_DRIFT = 5e-5
K2_NAMES = ("prefix_wgmma_kernel", "sum_partials_kernel")  # K2's two launches
K3_NAMES = ("build_da_vec_kernel", "dgrad_wgmma_kernel")  # K3's two launches
K4_NAMES = ("wgrad_wgmma_kernel", "wgrad_combine_kernel")  # K4's two launches
WGMMA_PRODUCTS = ("prefix_wgmma_kernel", "dgrad_wgmma_kernel", "wgrad_wgmma_kernel")
P2_PRODUCT = "gouter_wgmma_kernel"
P1_PRODUCT = "encode_stats_wgmma_kernel"
# K1 (streamed rows, and one CTA a row), P1 (x rounded, the product), K5, K6
# (streamed rows, and one CTA a row), the wide route's walk, K5's list, K1's
# cluster and K5's group route (csrc/kth_wide.cu), K1's threshold entry and
# the sharded threshold's candidates
SELECT_KERNELS = ("topk_stats_stream_kernel", "topk_stats_kernel", "encode_round_kernel", P1_PRODUCT,
                  "kth_masked_kernel", "kth_stream_kernel", "kth_kernel", "wide_row_kernel", "compact_mask_kernel",
                  "wide_cluster_kernel", "wide_masked_group_kernel",
                  "topk_given_stream_kernel", "topk_given_kernel", "kth_candidates_kernel")
# Registers K1's streamed kernel may not exceed at the production width,
# where two 256-thread CTAs share an SM (its count before K6 took K1's
# select), and P1's product, two 128-thread CTAs an SM (its count when it
# came to Hopper, the exact route holding 128 keys a thread).
P1_REGISTERS = 252
SELECT_REGISTERS = {"topk_stats_stream_kernelILi64ELi256E": 126, P1_PRODUCT: P1_REGISTERS}
# ptxas's report that it serializes a kernel's wgmma (a branch it cannot
# prove warp-uniform, among others).
WGMMA_SERIALIZED = "wgmma.mma_async instructions are serialized"
# P4's and P3's kernels (csrc/kth_ops.cu), streamed and one CTA a row: no
# instantiation may spill.
PASS_KERNELS = ("kth_ops_stream_kernel", "kth_ops_kernel", "count_loop_stream_kernel", "count_loop_kernel")
# The plain versions the kernel wrappers take on a CPU tensor: no card call
# may reach one (`plain_spy`).
PLAIN_VERSIONS = (
    ("cuda_topk", "_topk_stats_plain"), ("cuda_kth", "_kth_plain"), ("cuda_kth", "_kth_masked_plain"),
    ("cuda_kth", "_kth_candidates_plain"),
    ("cuda_matryoshka", "grouped_prefix_err_plain"), ("cuda_matryoshka", "grouped_matmul_dgrad_plain"),
    ("cuda_matryoshka", "grouped_matmul_wgrad_plain"), ("cuda_matryoshka", "grouped_prefix_base_plain"),
)
WARM_KERNELS = ("topk_stats", "grouped_prefix_err", "grouped_matmul_dgrad", "grouped_matmul_wgrad")
SEED = 0

KERNELS = {
    "topk_stats": ("saev_tpu_torch/csrc/topk_stats.cu", "saev_tpu/ops/pallas_topk.py:136"),
    "grouped_prefix_err": ("saev_tpu_torch/csrc/prefix_fwd.cu", "saev_tpu/ops/pallas_matryoshka.py:161"),
    "grouped_matmul_dgrad": ("saev_tpu_torch/csrc/dgrad.cu", "saev_tpu/ops/pallas_matryoshka.py:287"),
    "grouped_matmul_wgrad": ("saev_tpu_torch/csrc/wgrad.cu", "saev_tpu/ops/pallas_matryoshka.py:424"),
    "kth_value_masked": ("saev_tpu_torch/csrc/kth_masked.cu", "saev_tpu/ops/pallas_topk.py:248"),
    "kth_value": ("saev_tpu_torch/csrc/kth.cu", "saev_tpu/ops/pallas_topk.py:50"),
    "grouped_prefix_base": ("saev_tpu_torch/csrc/prefix_fwd.cu", "saev_tpu/ops/pallas_matryoshka.py:46"),
    "encode_stats": ("saev_tpu_torch/csrc/encode_stats.cu", "scripts/proto_encode_stats.py:31"),
    "grouped_prefix_err_gouter": ("saev_tpu_torch/csrc/prefix_gouter.cu", "scripts/proto_gouter.py:41"),
    "count_loop": ("saev_tpu_torch/csrc/kth_ops.cu", "scripts/microbench_kth.py:39"),
    "kth_ops": ("saev_tpu_torch/csrc/kth_ops.cu", "scripts/proto_kth_ops.py:55"),
}
BENCH_KERNELS = ("grouped_prefix_base", "encode_stats", "grouped_prefix_err_gouter", "count_loop", "kth_ops")

# NVIDIA H100 SXM data sheet peaks at 700 W: memory bytes/s, dense bf16
# tensor-core and f32 CUDA-core operations/s.
HBM_BYTES_S, BF16_OPS_S, F32_OPS_S = 3.35e12, 989e12, 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def wrappers() -> dict:
    from saev_tpu_torch.ops import cuda_kth, cuda_topk
    from saev_tpu_torch.ops import cuda_matryoshka as cm
    from saev_tpu_torch.scripts import microbench_kth, proto_encode_stats, proto_gouter, proto_kth_ops

    return {
        "topk_stats": cuda_topk.topk_stats_cuda,
        "grouped_prefix_err": cm.grouped_prefix_err,
        "grouped_matmul_dgrad": cm.grouped_matmul_dgrad,
        "grouped_matmul_wgrad": cm.grouped_matmul_wgrad,
        "kth_value_masked": cuda_kth.kth_value_masked_cuda,
        "kth_value": cuda_kth.kth_value_cuda,
        "grouped_prefix_base": cm.grouped_prefix_base,
        "encode_stats": proto_encode_stats.encode_stats,
        "grouped_prefix_err_gouter": proto_gouter.grouped_prefix_err_gouter,
        "count_loop": microbench_kth.count_loop,
        "kth_ops": proto_kth_ops.kth_ops,
    }


def helper_wrappers() -> dict:
    """K1's threshold entry and the sharded threshold's candidate step
    (csrc/kth_shard.cu), which feature-parallel training launches: counted
    apart from the eleven (`helper_counts`)."""
    from saev_tpu_torch.ops import cuda_kth, cuda_topk

    return {"topk_stats_given": cuda_topk.topk_stats_given_cuda, "kth_candidates": cuda_kth.kth_candidates_cuda}


@contextlib.contextmanager
def plain_spy():
    """Counts, for the duration, each call of a plain version that a kernel
    wrapper would take on a CPU tensor; yields the counts by name (empty
    while none runs)."""
    import importlib

    calls, saved = {}, []
    for mod_name, fn_name in PLAIN_VERSIONS:
        mod = importlib.import_module(f"saev_tpu_torch.ops.{mod_name}")
        real = getattr(mod, fn_name)

        def spy(*args, real=real, key=f"{mod_name}.{fn_name}", **kwargs):
            calls[key] = calls.get(key, 0) + 1
            return real(*args, **kwargs)

        saved.append((mod, fn_name, real))
        setattr(mod, fn_name, spy)
    try:
        yield calls
    finally:
        for mod, fn_name, real in saved:
            setattr(mod, fn_name, real)


def reset_counts() -> None:
    for fn in (wrappers() | helper_wrappers()).values():
        fn.launches = 0


def helper_counts() -> dict:
    return {k: fn.launches for k, fn in helper_wrappers().items()}


def counts() -> dict:
    return {k: fn.launches for k, fn in wrappers().items()}


def rel_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equal f32 tensors, -0.0 and +0.0 taken as one value (adding
    +0.0 turns -0.0 into +0.0 and leaves every other value as it is)."""
    return torch.equal((a + 0.0).view(torch.int32), (b + 0.0).view(torch.int32))


def topk_vs_cpu(f_card, h_card, f_cpu, h_cpu) -> dict:
    """A TopK forward's f_x on the card against the CPU's f32 forward of the
    same rows, with each side's pre-activations h (numpy or CPU tensors of
    one shape). The two products round apart, so a latent at a row's k-th
    value may be kept on one side only. Such a swap is a tie and not another
    selection when the latent's CPU pre-activation lies within 2 d of the
    CPU's k-th kept value, d the row's largest |h_card - h_cpu|: each side's
    k-th value moves by at most d, and so does each entry.

    Returns the relative MSE over all entries ("rel_mse") and over those
    both sides keep or both drop ("rel_agree"), the rows with another
    support ("rows_swapped"), the largest swap gap over its bound 2 d
    ("gap_ratio", 0 without a swap; above 1 is not a tie), and the kept
    entries of f_card that differ from h_card ("h_mismatch"; 0 when h_card
    is the product the card's forward thresholded)."""
    f_card, h_card, f_cpu, h_cpu = (np.asarray(a, dtype=np.float64) for a in (f_card, h_card, f_cpu, h_cpu))
    kept_card, kept_cpu = f_card != 0, f_cpu != 0
    rel = lambda g, w: float(((g - w) ** 2).sum() / max((w**2).sum(), 1e-300))  # noqa: E731
    agree = kept_card == kept_cpu
    swap = ~agree
    gap_ratio = 0.0
    if swap.any():
        kth_cpu = np.where(kept_cpu, h_cpu, np.inf).min(axis=1, keepdims=True)
        bound = 2 * np.abs(h_card - h_cpu).max(axis=1, keepdims=True)
        gap = np.abs(h_cpu - kth_cpu)
        gap_ratio = float(np.max(np.where(swap, gap / np.maximum(bound, 1e-300), 0.0)))
    return {"rel_mse": rel(f_card, f_cpu), "rel_agree": rel(f_card[agree], f_cpu[agree]),
            "rows_swapped": int(swap.any(axis=1).sum()), "gap_ratio": gap_ratio,
            "h_mismatch": int((kept_card & (f_card != h_card)).sum())}


def require_topk_agrees(what: str, cmp: dict, bound: float) -> None:
    """The card's f_x agrees with the CPU's (topk_vs_cpu's `cmp`): h_card is
    the product the card thresholded, every swap is a tie, and the relative
    MSE over the entries both sides keep or drop is within `bound`."""
    require(cmp["h_mismatch"] == 0, f"{what}: {cmp['h_mismatch']} kept entries of f_x differ from the card's "
                                    f"pre-activations recomputed at the same shape")
    require(cmp["gap_ratio"] <= 1.0, f"{what}: a latent kept on one side only lies {cmp['gap_ratio']:.3g} times the "
                                     f"rounding bound from the CPU's k-th value: another selection, not a tie")
    require(cmp["rel_agree"] <= bound, f"{what}: f_x {cmp['rel_agree']:.3g} relative MSE from the CPU's f32 forward "
                                       f"over the entries both keep or drop (bound {bound})")


def topk_note(cmp: dict, bound: float) -> str:
    return (f"{cmp['rel_agree']:.3g} relative MSE from the CPU's f32 forward over the entries both keep or drop "
            f"(bound {bound}), {cmp['rel_mse']:.3g} over all; {cmp['rows_swapped']} rows with another TopK support, "
            f"every swap a tie (gap at most {cmp['gap_ratio']:.3g} of the rounding bound)")


def kth_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over the entries where b is finite (-inf rows excluded)."""
    fin = torch.isfinite(b)
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def card_and_limit() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on a GPU")
    name = torch.cuda.get_device_name(0)
    smi = card_and_limit()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {name}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)
    return name


def phase_build(verbose: bool = False) -> None:
    from saev_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build(verbose=verbose)
    _build.lib()
    log(f"build: {path.name} in {time.perf_counter() - t0:.1f} s")
    sass = _build.dump_sass()
    ptxas = _build.ptxas_log().read_text()
    for fragment in WGMMA_PRODUCTS + (P2_PRODUCT, P1_PRODUCT):
        res = _build.ptxas_resources(ptxas, fragment)
        require(len(res) > 0, f"build: no {fragment} in ptxas's report")
        for name, r in res.items():
            require(r.get("spill_stores") == 0 and r.get("spill_loads") == 0, f"build: {name} spills: {r}")
            log(f"build ptxas {name}: {r['registers']} registers, no spills")
    for fragment in SELECT_KERNELS:
        res = _build.ptxas_resources(ptxas, fragment)
        require(len(res) > 0, f"build: no {fragment} in ptxas's report")
        for name, r in res.items():
            log(f"build ptxas {name}: {r['registers']} registers, stack frame {r.get('stack_frame')}, "
                f"spill stores {r.get('spill_stores')}, spill loads {r.get('spill_loads')}")
    for fragment in PASS_KERNELS:
        res = _build.ptxas_resources(ptxas, fragment)
        require(len(res) == (30 if fragment.startswith("kth_ops") else 6),
                f"build: {len(res)} instantiations of {fragment} in ptxas's report")
        for name, r in res.items():
            require(r.get("spill_stores") == 0 and r.get("spill_loads") == 0, f"build: {name} spills: {r}")
        log(f"build ptxas {fragment}, no spills; registers: "
            + ", ".join(f"{name[name.index(fragment) + len(fragment):].split('EE')[0]} {r['registers']}"
                        for name, r in sorted(res.items())))
    for fragment, most in SELECT_REGISTERS.items():
        res = _build.ptxas_resources(ptxas, fragment)
        require(len(res) > 0, f"build: no {fragment} in ptxas's report")
        for name, r in res.items():
            require(r["registers"] <= most and r.get("spill_stores") == 0 and r.get("spill_loads") == 0,
                    f"build: {name} {r}: more than {most} registers, or spills")
    serialized = [line for line in ptxas.splitlines() if WGMMA_SERIALIZED in line]
    for line in serialized:
        log(f"build ptxas: {line.strip()}")
    require(not any(P1_PRODUCT in line for line in serialized), f"build: ptxas serializes {P1_PRODUCT}'s wgmma")
    ctas = [_build.lib().saev_prefix_occupancy(mode) for mode in range(3)]
    require(all(n >= 1 for n in ctas), f"build: K2's and K7's resident CTAs an SM {ctas}")
    log(f"build: prefix_wgmma_kernel (K2, K7 f32, K7 bf16) resident CTAs an SM {ctas}")
    for fragment in (K2_NAMES[0],) + K3_NAMES + K4_NAMES + (P2_PRODUCT, P1_PRODUCT):
        found = _build.function_opcodes(sass, fragment)
        require(len(found) > 0, f"build: no {fragment} in the library's SASS")
        for name, ops in found.items():
            if fragment in WGMMA_PRODUCTS + (P2_PRODUCT, P1_PRODUCT):
                require(ops["HGMMA"] > 0 and ops["UTMALDG"] > 0 and ops["HMMA"] == 0,
                        f"build: {name} has HGMMA {ops['HGMMA']}, UTMALDG {ops['UTMALDG']}, "
                        f"HMMA {ops['HMMA']}: not a wgmma product on TMA loads")
            log(f"build SASS {name}: {sum(ops.values())} instructions, HGMMA {ops['HGMMA']}, "
                f"UTMALDG {ops['UTMALDG']}, HMMA {ops['HMMA']}, LDG {ops['LDG']}, STG {ops['STG']}")
    # P2 loads its half of each W stage once and multicasts it to both CTAs
    # of its cluster: the multicast form of the TMA load must be there.
    for name, forms in _build.function_forms(sass, P2_PRODUCT).items():
        loads = {f: n for f, n in forms.items() if f.startswith("UTMALDG")}
        require("UTMALDG.2D.MULTICAST" in loads, f"build: {name} has no multicast TMA load: {loads}")
        log(f"build SASS {name}: TMA loads {loads}")


def _gen(device="cuda") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(SEED)


def _k1_fallbacks(h: torch.Tensor, k: int) -> int:
    """How many rows of h take K1's whole-row fallback."""
    from saev_tpu_torch.ops import cuda_topk

    fallback = torch.zeros(1, dtype=torch.int32, device="cuda")
    cuda_topk.topk_stats_cuda(h, k, fallback)
    return int(fallback)


def _k1_case(h: torch.Tensor, k: int, what: str, fallbacks: int) -> float:
    """K1 against its plain version; `fallbacks` rows of h must take the
    whole-row bisection, the rest the candidate filter."""
    from saev_tpu_torch.ops import cuda_topk, topk

    fallback = torch.zeros(1, dtype=torch.int32, device="cuda")
    with plain_spy() as plain:
        got = cuda_topk.topk_stats_cuda(h, k, fallback)
        torch.cuda.synchronize()
    require(not plain, f"K1 {what}: the card call ran plain versions {plain}")
    want = topk._topk_stats_plain(h, k)
    torch.cuda.synchronize()
    require(int(fallback) == fallbacks, f"K1 {what}: {int(fallback)} rows fell back, expected {fallbacks}")
    require(torch.equal(got.kth, want.kth), f"K1 {what}: kth differs")
    require(torch.equal(got.f, want.f), f"K1 {what}: f differs")
    require(torch.equal(got.live, want.live), f"K1 {what}: live differs")
    require(torch.equal(got.l0, want.l0), f"K1 {what}: l0 differs")
    l1_rel = float(((got.l1 - want.l1).abs() / want.l1.abs().clamp_min(1e-30)).max())
    require(l1_rel <= 1e-6, f"K1 {what}: l1 rel err {l1_rel:.3g} > 1e-6")
    err = max(max_abs(got.kth, want.kth), max_abs(got.f, want.f), max_abs(got.l1, want.l1))
    log(f"parity K1 {what}: kth/f/live/l0 equal, l1 max rel {l1_rel:.3g}; {int(fallback)} of {h.shape[0]} rows "
        f"took the whole-row fallback, {h.shape[0] - int(fallback)} the candidate filter")
    return err


def _k1_inputs(s: int = D_SAE, b: int = B) -> torch.Tensor:
    h = torch.randn((b, s), generator=_gen(), device="cuda")
    h[0] = 0.0  # all tied at zero
    h[1] = -h[1].abs()  # all negative
    h[2] = -h[2].abs()
    h[2, :5] = 1.0 + torch.arange(5, device="cuda")  # fewer than k positive
    h[3, :2048] = 7.0  # ties across the boundary, over twice K1's candidate buffer
    h[4, ::2] = -0.0  # signed zeros beside positives
    h[4, 1::2] = -h[4, 1::2].abs()
    h[4, 1:40:2] = 0.5
    return h


def _k6_case(h: torch.Tensor, k: int, what: str, fallbacks: int) -> float:
    """K6 bit for bit against its plain version, K1's kth and P4's exact
    modes (where P4 takes the width); `fallbacks` rows of h (K1's) must take
    its whole-row bisection."""
    from saev_tpu_torch.ops import cuda_kth, cuda_topk, topk
    from saev_tpu_torch.scripts import proto_kth_ops

    fallback = torch.zeros(1, dtype=torch.int32, device="cuda")
    with plain_spy() as plain:
        got = cuda_kth.kth_value_cuda(h, k, fallback)
        k1 = cuda_topk.topk_stats_cuda(h, k).kth
        torch.cuda.synchronize()
    require(not plain, f"K6 {what}: the card call ran plain versions {plain}")
    want = topk._kth_plain(h, min(k, h.shape[1]))
    modes = proto_kth_ops.EXACT if h.shape[1] <= proto_kth_ops.MAX_S else ()
    p4 = {mode: proto_kth_ops.kth_ops(h, min(k, h.shape[1]), mode) for mode in modes}
    torch.cuda.synchronize()
    require(same_bits(got, want), f"K6 {what}: differs from its plain version")
    require(torch.equal(got, k1), f"K6 {what}: differs from K1's kth")
    for mode, v in p4.items():
        require(torch.equal(got, v), f"K6 {what}: differs from P4's {mode}")
    require(int(fallback) == fallbacks, f"K6 {what}: {int(fallback)} rows fell back, expected {fallbacks}")
    if h.shape[1] > cuda_kth.NARROW_S:
        from saev_tpu_torch.ops import _build

        ctas = _build.lib().saev_wide_cluster_ctas(h.shape[1])
        form = f"kth_wide.cu, {f'a cluster of {ctas} CTAs a row' if ctas else 'the walk'}"
    else:
        form = "streamed" if h.shape[1] % 4 == 0 else "one CTA a row"
    log(f"parity K6 {what} k {k} ({form}): kth bitwise equal to the plain version, K1's kth and P4's "
        f"{', '.join(p4) or '(none: P4 takes 32768 columns at most)'}; {int(fallback)} of {h.shape[0]} rows "
        f"took the whole-row fallback")
    return kth_err(got, want)


def _k5_inputs(s: int, n_dead: int = N_DEAD_5, b: int = B) -> torch.Tensor:
    """(b, s) with the first n_dead columns pinned as bench.py pins dead
    latents: bias -1e6, where f32 values lie 0.0625 apart and many tie."""
    h = torch.randn((b, s), generator=_gen(), device="cuda")
    h[:, :n_dead] = h[:, :n_dead] * 4.0 - 1e6
    return h


def _k5_masks(s: int, n_dead: int, d_sae: int = D_SAE) -> dict:
    cols = torch.arange(s, device="cuda")
    scattered = torch.zeros(s, dtype=torch.bool, device="cuda")
    scattered[torch.randperm(s, generator=_gen(), device="cuda")[:n_dead]] = True
    return {
        f"{n_dead} dead ({n_dead / d_sae:.0%})": cols < n_dead,
        f"{n_dead} dead, scattered": scattered,
        f"{K_AUX - 3} unmasked (< k)": cols < K_AUX - 3,
        "all masked": torch.zeros(s, dtype=torch.bool, device="cuda"),
        "none masked": torch.ones(s, dtype=torch.bool, device="cuda"),
    }


def _k5_cases(s: int, n_dead: int = N_DEAD_5, d_sae: int = D_SAE) -> float:
    from saev_tpu_torch.ops import cuda_kth, topk

    h = _k5_inputs(s, n_dead)
    err = 0.0
    for what, mask in _k5_masks(s, n_dead, d_sae).items():
        with plain_spy() as plain:
            got = cuda_kth.kth_value_masked_cuda(h, mask, K_AUX)
            torch.cuda.synchronize()
        require(not plain, f"K5 {B}x{s} {what}: the card call ran plain versions {plain}")
        want = topk._kth_masked_plain(h, mask, K_AUX)
        torch.cuda.synchronize()
        require(same_bits(got, want), f"K5 {B}x{s} {what}: differs from its plain version")
        n_inf = int(torch.isneginf(got).sum())
        if int(mask.sum()) < K_AUX:
            require(n_inf == B, f"K5 {B}x{s} {what}: {n_inf} of {B} rows are -inf, expected all")
        err = max(err, kth_err(got, want))
        log(f"parity K5 {B}x{s} k {K_AUX} mask {what}: bitwise equal, {n_inf} rows -inf, "
            f"median kth {float(got.median()):.4f}")
    return err


def _grouped_operands(s: int = D_SAE):
    """Seeded operands of the Matryoshka kernels at batch B and d_sae s:
    f (10% of the latents nonzero, bf16), W (bf16), x and b_dec."""
    g = _gen()
    f = (torch.randn((B, s), generator=g, device="cuda")
         * (torch.rand((B, s), generator=g, device="cuda") < 0.1)).to(torch.bfloat16)
    w = (torch.randn((s, D_MODEL), generator=g, device="cuda") / 32).to(torch.bfloat16)
    x = torch.randn((B, D_MODEL), generator=g, device="cuda")
    b_dec = torch.randn((D_MODEL,), generator=g, device="cuda") * 0.1
    return f, w, x, b_dec


def _matryoshka_inputs():
    from saev_tpu_torch.nn import objectives

    f, w, x, b_dec = _grouped_operands()
    rng = np.random.default_rng(SEED)
    sampled = objectives.sample_prefixes(D_SAE, N_PREFIXES, rng=rng)
    # m = 0 (p < g), two cuts in one group, r = 0 (p on a boundary), p = d_sae.
    hand = np.asarray([100, 700, 1024, 2048, 5000, 5001, 9000, 12288, 15000, D_SAE], np.int32)
    return f, w, x, b_dec, {"sampled": sampled, "hand-set": hand}


def _cuts(p: np.ndarray):
    pt = torch.from_numpy(p).to("cuda")
    m = torch.div(pt, GROUP, rounding_mode="floor").to(torch.int32).contiguous()
    return m, (pt - m * GROUP).to(torch.int32).contiguous()


def _k2_case(f, w, x, b_dec, iu, m, r, what: str) -> tuple[float, torch.Tensor]:
    """K2 against its plain version: the same bits in two calls, xhat within
    rel-norm 1e-4, E (bf16) within 1e-2 and the loss within rel 1e-5, both
    of the plain version's loss and of the f64 sum of the kernel's own E.
    Past the production operands' nonzeros a row (PRODUCTION_NNZ_ROW: at
    d_sae 65536, and on a Relu layer's dense latents) the loss is held to
    the plain version's within K2_DENSE_LOSS_REL, and xhat's drift from an
    f64 product of 1024 rows within K2_DENSE_DRIFT: the card's f32 sums of
    bf16 products drift from the exact sum with the number of terms
    (`product_drift`), which moves bf16(E) and so the loss. The log sets
    that drift beside the plain version's and cuBLAS's bf16 product's with
    f32 result on the same rows. Returns the max abs error and the kernel's
    E."""
    from saev_tpu_torch.ops import cuda_matryoshka as cm

    with plain_spy() as plain:
        e, xhat, loss = cm.grouped_prefix_err(f, w, x, b_dec, iu, m, r, group_size=GROUP)
        e2, _, loss2 = cm.grouped_prefix_err(f, w, x, b_dec, iu, m, r, group_size=GROUP)
        torch.cuda.synchronize()
    require(not plain, f"K2 {what}: the card call ran plain versions {plain}")
    require(torch.equal(loss, loss2) and torch.equal(e, e2), f"K2 {what}: not bitwise reproducible")
    del e2
    own = sum(float(((ej.double() * float(iu)) ** 2).sum()) for ej in e)
    own_rel = abs(float(loss) - own) / own
    require(own_rel <= 1e-5, f"K2 {what}: loss rel err {own_rel:.3g} > 1e-5 against the sum of its own E")
    pe, pxhat, ploss = cm.grouped_prefix_err_plain(f, w, x, b_dec, iu, m, r, group_size=GROUP)
    torch.cuda.synchronize()
    loss_rel = abs(float(loss) - float(ploss)) / abs(float(ploss))
    drift = ""
    nnz_row = float((f != 0).sum()) / f.shape[0]
    if nnz_row <= PRODUCTION_NNZ_ROW:
        require(loss_rel <= 1e-5, f"K2 {what}: loss rel err {loss_rel:.3g} > 1e-5")
    else:
        from saev_tpu_torch.nn import modeling

        require(loss_rel <= K2_DENSE_LOSS_REL, f"K2 {what}: loss rel err {loss_rel:.3g} > {K2_DENSE_LOSS_REL}")
        exact = f[:1024].double() @ w.double()
        parts, drifts = [], {}
        for name, got in (("kernel", xhat[:1024]), ("plain", pxhat[:1024]), ("cuBLAS", modeling._mm_bf16(f[:1024], w))):
            d = got.double() - exact
            drifts[name] = float(d.norm() / exact.norm())
            parts.append(f"{name} rel-norm {drifts[name]:.3g}, "
                         f"signed {float((d * exact.sign()).sum() / exact.abs().sum()):.3g}")
        drift = f"; {nnz_row:.0f} nonzeros a row: xhat against an f64 product (1024 rows): " + ", ".join(parts)
        del exact
        require(drifts["kernel"] <= K2_DENSE_DRIFT,
                f"K2 {what}: xhat rel-norm {drifts['kernel']:.3g} against the f64 product > {K2_DENSE_DRIFT}")
    r_xhat, r_e = rel_norm(xhat, pxhat), rel_norm(e, pe)
    require(r_xhat <= 1e-4, f"K2 {what}: xhat rel-norm {r_xhat:.3g} > 1e-4")
    require(r_e <= 1e-2, f"K2 {what}: E rel-norm {r_e:.3g} > 1e-2")
    log(f"parity K2 {what} ({e.shape[0]} cuts, {e.shape[1]} rows): loss rel {loss_rel:.3g} against the plain "
        f"version, {own_rel:.3g} against its own E (bitwise repeatable), xhat rel-norm {r_xhat:.3g}, E rel-norm "
        f"{r_e:.3g}{drift}")
    return max(max_abs(xhat, pxhat), max_abs(e, pe)), e


def _grouped_cases(f, w, x, b_dec, iu, p: np.ndarray, what: str, errs: dict, df_dtype=torch.bfloat16) -> None:
    """K2, K3 and K4 on one cut set p against their plain versions
    (`_k2_case`, `_k3_case`, `_k4_case`), K3 and K4 on K2's E with the
    loss's scale; raises errs' entries to their max abs errors."""
    m, r = _cuts(p)
    k2_err, e = _k2_case(f, w, x, b_dec, iu, m, r, what)
    errs["grouped_prefix_err"] = max(errs["grouped_prefix_err"], k2_err)
    scale = torch.full((1,), 2.0 / (f.shape[0] * len(p) * D_MODEL), device="cuda")
    k3_err, da = _k3_case(w, e, m, r, scale, what, df_dtype)
    errs["grouped_matmul_dgrad"] = max(errs["grouped_matmul_dgrad"], k3_err)
    errs["grouped_matmul_wgrad"] = max(errs["grouped_matmul_wgrad"], _k4_case(f, da, e, m, r, scale, what))


def _k3_case(w, e, m, r, scale, what: str, df_dtype=torch.bfloat16) -> tuple[float, torch.Tensor]:
    """K3 against its plain version: dA bit for bit, df (bf16, or f32 as
    the Relu and BatchTopK steps take it) within rel-norm 1e-2 (f32 sums in
    another order). Returns the max abs error and the kernel's dA."""
    from saev_tpu_torch.ops import cuda_matryoshka as cm

    with plain_spy() as plain:
        df, da = cm.grouped_matmul_dgrad(w, e, m, r, scale, group_size=GROUP, df_dtype=df_dtype)
        torch.cuda.synchronize()
    require(not plain, f"K3 {what}: the card call ran plain versions {plain}")
    pdf, pda = cm.grouped_matmul_dgrad_plain(w, e, m, r, scale, group_size=GROUP, df_dtype=df_dtype)
    torch.cuda.synchronize()
    n_diff = int((da.view(torch.int16) != pda.view(torch.int16)).sum())
    require(n_diff == 0, f"K3 {what}: dA differs from its plain version at {n_diff} entries")
    r_df = rel_norm(df, pdf)
    require(r_df <= 1e-2, f"K3 {what}: df rel-norm {r_df:.3g} > 1e-2")
    log(f"parity K3 {what} ({e.shape[0]} cuts, {e.shape[1]} rows): dA bitwise equal, df rel-norm {r_df:.3g}")
    return max_abs(df, pdf), da


def _k4_case(f, da, e, m, r, scale, what: str) -> float:
    """K4 against its plain version: dW within rel-norm 1e-4 (f32 sums in
    another order), the same bits in a second call. Returns the max abs
    error."""
    from saev_tpu_torch.ops import cuda_matryoshka as cm

    with plain_spy() as plain:
        dw = cm.grouped_matmul_wgrad(f, da, e, m, r, scale, group_size=GROUP)
        dw2 = cm.grouped_matmul_wgrad(f, da, e, m, r, scale, group_size=GROUP)
        torch.cuda.synchronize()
    require(not plain, f"K4 {what}: the card call ran plain versions {plain}")
    pdw = cm.grouped_matmul_wgrad_plain(f, da, e, m, r, scale, group_size=GROUP)
    torch.cuda.synchronize()
    require(same_bits(dw, dw2), f"K4 {what}: dW differs between two calls")
    r_dw = rel_norm(dw, pdw)
    require(r_dw <= 1e-4, f"K4 {what}: dW rel-norm {r_dw:.3g} > 1e-4")
    log(f"parity K4 {what} ({e.shape[0]} cuts, {e.shape[1]} rows): dW rel-norm {r_dw:.3g}, bitwise repeatable")
    return max_abs(dw, pdw)


def phase_parity() -> dict:
    from saev_tpu_torch.ops import cuda_matryoshka as cm

    errs = {name: 0.0 for name in KERNELS}
    h = _k1_inputs()
    fell = [i for i in range(8) if _k1_fallbacks(h[i:i + 1], TOP_K)]
    require(fell == [0, 3, 4], f"K1: edge rows {fell} took the fallback, expected [0, 3, 4]")
    log(f"parity K1: of the edge rows 0-7, rows {fell} take the whole-row fallback (zeros; 2048 ties at 7.0; "
        f"-0.0 over half the row), the rest the candidate filter")
    errs["topk_stats"] = _k1_case(h, TOP_K, "production", len(fell))
    errs["topk_stats"] = max(errs["topk_stats"], _k1_case(h[:256].contiguous(), D_SAE, "k = d_sae", 256))
    # At 1000 and 1001 columns every edge row fits the 1024-key buffer.
    errs["topk_stats"] = max(errs["topk_stats"], _k1_case(h[:256, :1000].contiguous(), TOP_K, "ragged row 1000", 0))
    errs["topk_stats"] = max(errs["topk_stats"], _k1_case(h[:256, :1001].contiguous(), TOP_K,
                                                          "ragged row 1001 (scalar loads and stores)", 0))
    errs["kth_value"] = max(
        _k6_case(h, TOP_K, "production", len(fell)),
        _k6_case(h[:256].contiguous(), D_SAE, "k = d_sae", 256),
        _k6_case(h[:256, :1000].contiguous(), TOP_K, "ragged row 1000", 0),
        _k6_case(h[:256, :1001].contiguous(), TOP_K, "ragged row 1001", 0),
    )
    del h
    torch.cuda.empty_cache()
    errs["kth_value_masked"] = max(_k5_cases(D_SAE), _k5_cases(WIDE, N_DEAD_20), _k5_cases(TIGHT))
    torch.cuda.empty_cache()

    f, w, x, b_dec, cut_sets = _matryoshka_inputs()
    iu = (1.0 / x.abs().max().clamp_min(1e-12)).reshape(1)
    for what, p in cut_sets.items():
        _grouped_cases(f, w, x, b_dec, iu, p, f"{what} cuts {p.tolist()}", errs)
    # K3 and K4 at 64 cuts (about four in each group), 65 and 128 on the
    # first 1024 rows; K2 and K7 at 65 and 128 against their plain versions
    # too.
    n = 1024
    for j in (64, N_PREFIXES_MANY, 128):
        p = np.sort(np.random.default_rng(SEED + j).choice(np.arange(1, D_SAE), j - 1, replace=False))
        m, r = _cuts(np.append(p, D_SAE).astype(np.int32))
        e, xhat, loss = cm.grouped_prefix_err(f[:n], w, x[:n], b_dec, iu, m, r, group_size=GROUP)
        if j > 64:
            pe, pxhat, ploss = cm.grouped_prefix_err_plain(f[:n], w, x[:n], b_dec, iu, m, r, group_size=GROUP)
            base, _ = cm.grouped_prefix_base(f[:n], w, m, r, group_size=GROUP)
            pbase, _ = cm.grouped_prefix_base_plain(f[:n], w, m, r, group_size=GROUP)
            rels = (rel_norm(e, pe), rel_norm(xhat, pxhat), abs(float(loss) - float(ploss)) / abs(float(ploss)),
                    rel_norm(base, pbase))
            require(rels[0] <= 1e-2 and rels[1] <= 1e-4 and rels[2] <= 1e-5 and rels[3] <= 1e-4,
                    f"K2/K7 {j} cuts: E, xhat, loss, base rel errs {rels}")
            log(f"parity K2 and K7 {j} cuts ({n} rows): E rel-norm {rels[0]:.3g}, xhat {rels[1]:.3g}, loss rel "
                f"{rels[2]:.3g}, K7 base {rels[3]:.3g}")
            del pe, pxhat, base, pbase
        scale = torch.full((1,), 2.0 / (n * j * D_MODEL), device="cuda")
        k3_err, da = _k3_case(w, e, m, r, scale, f"{j} cuts")
        errs["grouped_matmul_dgrad"] = max(errs["grouped_matmul_dgrad"], k3_err)
        k4_err = _k4_case(f[:n], da, e, m, r, scale, f"{j} cuts")
        errs["grouped_matmul_wgrad"] = max(errs["grouped_matmul_wgrad"], k4_err)
        del e, da
    del f, w, x, b_dec
    torch.cuda.empty_cache()
    _grouped_full_batch(errs)
    return errs


def _grouped_full_batch(errs: dict) -> None:
    """K2, K3 and K4 at batch 16384 on the other shapes the wide steps phase
    trains: d_sae 65536 with the 10 cuts sample_prefixes gives (64 groups),
    and d_sae 16384 with 65."""
    from saev_tpu_torch.nn import objectives

    rng = np.random.default_rng(SEED + 1)
    for s, j in ((D_SAE_WIDE, N_PREFIXES), (D_SAE, N_PREFIXES_MANY)):
        f, w, x, b_dec = _grouped_operands(s)
        iu = (1.0 / x.abs().max().clamp_min(1e-12)).reshape(1)
        p = objectives.sample_prefixes(s, j, rng=rng)
        _grouped_cases(f, w, x, b_dec, iu, p, f"d_sae {s} sampled", errs)
        del f, w, x, b_dec
        torch.cuda.empty_cache()


def _k5_wide_masks(s: int) -> dict:
    """K5's masks on the wide route: 5%, 40% and 60% of the columns unmasked
    as a prefix and scattered, none masked, fewer than k unmasked and all
    masked."""
    cols = torch.arange(s, device="cuda")
    masks = {}
    for frac in (0.05, 0.4, 0.6):
        n = int(s * frac)
        scattered = torch.zeros(s, dtype=torch.bool, device="cuda")
        scattered[torch.randperm(s, generator=_gen(), device="cuda")[:n]] = True
        masks[f"{n} unmasked ({frac:.0%}, prefix)"] = cols < n
        masks[f"{n} unmasked ({frac:.0%}, scattered)"] = scattered
    masks["none masked"] = torch.ones(s, dtype=torch.bool, device="cuda")
    masks[f"{K_AUX - 3} unmasked (< k)"] = cols < K_AUX - 3
    masks["all masked"] = torch.zeros(s, dtype=torch.bool, device="cuda")
    return masks


def _k5_route(s: int, n: int) -> str:
    """K5's route on a row of s > 32768 with n unmasked columns."""
    from saev_tpu_torch.ops import _build

    if n <= 32768:
        return "group route"
    return "cluster route" if _build.lib().saev_wide_cluster_ctas(s) else "walk"


def _sector_bytes(b: int, mask: torch.Tensor) -> int:
    """The bytes of the 32-byte sectors of b f32 rows that hold a column the
    (S,) mask leaves unmasked: what a gather of those columns reads."""
    m = torch.nn.functional.pad(mask, (0, -mask.numel() % 8)).view(-1, 8).any(1)
    return b * int(m.sum()) * 32


def _k5_wide_cases(h: torch.Tensor) -> float:
    """K5 at k_aux on h's wide rows under `_k5_wide_masks`, bit for bit
    against its plain version with no plain version run by the card's call,
    -inf where fewer than k columns are unmasked; h's rows are Gaussian (with
    pinned dead columns), so no row may take the whole-row fallback."""
    from saev_tpu_torch.ops import cuda_kth, topk

    b, s = h.shape
    err = 0.0
    for what, mask in _k5_wide_masks(s).items():
        n = int(mask.sum())
        fallback = torch.zeros(1, dtype=torch.int32, device="cuda")
        with plain_spy() as plain:
            got = cuda_kth.kth_value_masked_cuda(h, mask, K_AUX, fallback)
            torch.cuda.synchronize()
        require(not plain, f"K5 {b}x{s} {what}: the card call ran plain versions {plain}")
        want = topk._kth_masked_plain(h, mask, K_AUX)
        torch.cuda.synchronize()
        require(same_bits(got, want), f"K5 {b}x{s} {what}: differs from its plain version")
        n_inf = int(torch.isneginf(got).sum())
        if n < K_AUX:
            require(n_inf == b, f"K5 {b}x{s} {what}: {n_inf} of {b} rows are -inf, expected all")
        require(int(fallback) == 0, f"K5 {b}x{s} {what}: {int(fallback)} rows took the whole-row fallback")
        err = max(err, kth_err(got, want))
        log(f"parity K5 {b}x{s} k {K_AUX} mask {what} ({_k5_route(s, n)}): bitwise equal, {n_inf} rows -inf, "
            f"{int(fallback)} rows took the whole-row fallback, median kth {float(got.median()):.4f}")
    return err


def _walk_cases() -> float:
    """K1, K6 and K5 at WALK_B x WALK_S, past the cluster route's 8 slices,
    where csrc/kth_wide.cu walks each row (`wide_row_kernel`): the parity
    phase's edge rows (rows 0 and 4 take the whole-row fallback) and K5's
    wide masks, bit for bit against their plain versions."""
    from saev_tpu_torch.ops import _build

    what = f"{WALK_B}x{WALK_S} (the walk)"
    require(_build.lib().saev_wide_cluster_ctas(WALK_S) == 0, f"{what}: a cluster route")
    h = _k1_inputs(WALK_S, WALK_B)
    fell = [i for i in range(8) if _k1_fallbacks(h[i:i + 1], TOP_K)]
    require(fell == [0, 4], f"K1 {what}: edge rows {fell} took the fallback, expected [0, 4]")
    err = max(_k1_case(h, TOP_K, what, len(fell)), _k6_case(h, TOP_K, what, len(fell)))
    del h
    torch.cuda.empty_cache()
    return max(err, _k5_wide_cases(_k5_inputs(WALK_S, int(WALK_S * 0.05), WALK_B)))


def phase_wide() -> dict:
    """K1, K6 and K5 on rows wider than their narrow kernels hold
    (csrc/kth_wide.cu: K1 and K6 on the cluster route, K5 on the group route
    up to 32768 unmasked columns and on the cluster route past them), at
    16384 x 65536 and x 131072, bit for bit against their plain versions
    with no plain version run by the card's call: K1 at k 32, K6 at k 32 and
    k_aux 512 on Gaussian rows with the parity phase's edge rows (rows 0 and
    4 overflow the candidate buffers and bisect the whole row at k 32; K6's
    rows at k_aux are K1's), K5 at k_aux 512 under `_k5_wide_masks`, no row
    falling back. Then each one's time against its plain version, torch.topk
    and its byte bound, K5 also at 40% and 60% of the columns unmasked and
    none masked, held bitwise, with no row falling back, beside the bound of
    the 32-byte sectors a gather of the unmasked columns would read. Then
    the walk past 8 slices (`_walk_cases`). Returns the timed rows by
    width."""
    from saev_tpu_torch.ops import _build, cuda_kth, cuda_topk, topk

    errs, times = {}, {}
    for s in WIDE_S:
        ctas, clusters = _build.lib().saev_wide_cluster_ctas(s), _build.lib().saev_wide_clusters(s)
        require(ctas >= 2 and clusters >= 1, f"K1 {B}x{s}: cluster route {ctas} CTAs, {clusters} clusters")
        log(f"wide {B}x{s}: K1, K6 and K5 past 32768 unmasked columns on the cluster route, {ctas} CTAs a cluster "
            f"({s // ctas} columns a CTA), {clusters} clusters resident; K5 on the group route up to 32768")
        h = _k1_inputs(s)
        fell = [i for i in range(8) if _k1_fallbacks(h[i:i + 1], TOP_K)]
        require(fell == [0, 4], f"K1 {B}x{s}: edge rows {fell} took the fallback, expected [0, 4]")
        fell_aux = [i for i in range(8) if _k1_fallbacks(h[i:i + 1], K_AUX)]
        log(f"wide {B}x{s}: at k {K_AUX} K1's select sends edge rows {fell_aux} to the whole-row bisection")
        errs[s] = max(_k1_case(h, TOP_K, f"{B}x{s}", len(fell)),
                      _k6_case(h, TOP_K, f"{B}x{s}", len(fell)),
                      _k6_case(h, K_AUX, f"{B}x{s}", len(fell_aux)))
        del h
        torch.cuda.empty_cache()
        n_dead = int(s * 0.05)
        errs[s] = max(errs[s], _k5_wide_cases(_k5_inputs(s, n_dead)))
        torch.cuda.empty_cache()

        h = torch.randn((B, s), generator=_gen(), device="cuda")
        stats = cuda_topk.topk_stats_cuda(h, TOP_K)
        row = {"topk_stats": timed(_time(lambda: cuda_topk.topk_stats_cuda(h, TOP_K), 5),
                                   _time(lambda: topk._topk_stats_plain(h, TOP_K), 2),
                                   bound((h, *stats), h.numel(), F32_OPS_S))}
        del stats
        row["kth_value"] = timed(_time(lambda: cuda_kth.kth_value_cuda(h, TOP_K), 5),
                                 _time(lambda: topk._kth_plain(h, TOP_K), 2),
                                 _selection_bound(h, h[:, :1]), library_kth_ms(h, TOP_K, f"K6 {B}x{s}"))
        mask = torch.arange(s, device="cuda") < n_dead
        row["kth_value_masked"] = timed(_time(lambda: cuda_kth.kth_value_masked_cuda(h, mask, K_AUX), 5),
                                        _time(lambda: topk._kth_masked_plain(h, mask, K_AUX), 2),
                                        bound((B * n_dead * 4, mask, h[:, :1]), B * n_dead, F32_OPS_S))
        # A yardstick, not K5's library entry: its mask here is a prefix, so
        # the library's k-th value over the columns it selects is K5's value.
        library_kth_ms(h[:, :n_dead], K_AUX, f"K5's selected columns {B}x{s} (wide route)")
        for k, r in row.items():
            log_timing(k, r, f" {B}x{s} (wide route), k {K_AUX if k == 'kth_value_masked' else TOP_K}")
        masks = _k5_wide_masks(s)
        for what in [w for w in masks if "40%" in w or "60%" in w or w == "none masked"]:
            m = masks[what]
            n = int(m.sum())
            fallback = torch.zeros(1, dtype=torch.int32, device="cuda")
            with plain_spy() as plain:
                got = cuda_kth.kth_value_masked_cuda(h, m, K_AUX, fallback)
                torch.cuda.synchronize()
            require(not plain, f"K5 {B}x{s} {what}: the card call ran plain versions {plain}")
            require(same_bits(got, topk._kth_masked_plain(h, m, K_AUX)), f"K5 {B}x{s} {what}: differs")
            require(int(fallback) == 0, f"K5 {B}x{s} {what}: {int(fallback)} rows took the whole-row fallback")
            sector = bound((_sector_bytes(B, m), m, h[:, :1]), B * n, F32_OPS_S)["bound_ms"]
            log_timing("kth_value_masked", timed(_time(lambda: cuda_kth.kth_value_masked_cuda(h, m, K_AUX), 5),
                                                 _time(lambda: topk._kth_masked_plain(h, m, K_AUX), 2),
                                                 bound((B * n * 4, m, h[:, :1]), B * n, F32_OPS_S)),
                       f" {B}x{s} (wide route, {_k5_route(s, n)}), k {K_AUX}, {what}, bitwise equal, "
                       f"{int(fallback)} rows fell back; sector bound {sector:.3f} ms")
        times[s] = row
        del h
        torch.cuda.empty_cache()
    errs[WALK_S] = _walk_cases()
    torch.cuda.empty_cache()
    return times


def _hp(n_sae: int, device) -> dict:
    return {
        "lr": torch.full((n_sae,), 4e-4, device=device) * (1 + torch.arange(n_sae, device=device)),
        "n_lr_warmup": torch.full((n_sae,), 2.0, device=device),
        "grad_clip": torch.ones((n_sae,), device=device),
        "sparsity_coeff": torch.zeros((n_sae,), device=device),
        "aux_alpha": torch.full((n_sae,), 1 / 32, device=device) * (1 + torch.arange(n_sae, device=device)),
    }


def _pin_dead(ts, n_dead: int) -> None:
    """Pin the first n_dead latents of every SAE dead, as bench.py does
    (bench.py:72-81): encoder bias -1e6 and counters at 1 << 30."""
    ts.params["b_enc"][:, :n_dead] = -1e6
    ts.obj_state["toks_since_active"][:, :n_dead] = 1 << 30


@contextlib.contextmanager
def encoder_spy(rows: int = 256):
    """Wraps the step's encoder (modeling._linear_bias) for the duration and
    keeps, in the list it yields, the first card call's precision and the
    first `rows` rows of its x and h, with W and b, on the CPU."""
    from saev_tpu_torch.nn import modeling

    real, seen = modeling._linear_bias, []

    def spy(x, w, b, precision):
        out = real(x, w, b, precision)
        if out.is_cuda and not seen:
            seen.append((x[:rows].detach().cpu(), w.detach().cpu(), b.detach().cpu(), precision,
                         out[:rows].detach().cpu()))
        return out

    modeling._linear_bias = spy
    try:
        yield seen
    finally:
        modeling._linear_bias = real


# The card's bf16 product with f32 accumulation against the same algebra on
# the CPU (f32 sums of the exact bf16 products): the sums run in another
# order, and the tensor cores do not round every f32 add to nearest, so the
# card's sums drift from the exact one with K (`product_drift` logs it: on
# an H100 about 1e-6 at K 1024 and 3.5e-6 at K 16384, the CPU's about 1e-7).
# 1e-5 holds the encoder (K = d_model) and is a hundredth of what rounding
# the operands to bf16 moves.
ENCODER_REL = 1e-5


def check_encoder(seen: list, what: str) -> str:
    """The card's encoder product at "default" against bf16(x) @ bf16(W) + b
    on the CPU (rel-norm ENCODER_REL) and not the f32 product, over the
    latents whose bias is not pinned at -1e6: there the sum lies on f32's
    grid of 0.0625, which hides the product's low bits."""
    require(len(seen) == 1, f"{what}: the step's encoder never ran on the card")
    x, w, b, precision, h = seen[0]
    require(precision == "default", f"{what}: the step's encoder ran at {precision!r}")
    cols = b.abs() < 1e3
    h, w, b = h[:, cols], w[:, cols], b[cols]
    r16 = rel_norm(h, x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float() + b)
    r32 = rel_norm(h, x @ w + b)
    require(r16 <= ENCODER_REL, f"{what}: encoder rel-norm {r16:.3g} against the bf16 algebra > {ENCODER_REL}")
    require(r32 > 1e-4, f"{what}: encoder rel-norm {r32:.3g} against the f32 product: not bf16 operands")
    return (f"encoder h ({h.shape[0]} rows, {h.shape[1]} latents not pinned) against the bf16 algebra on the "
            f"CPU rel-norm {r16:.3g}, against f32 {r32:.3g}")


def _to(ts, device):
    from saev_tpu_torch.framework import train

    return train.SweepState(*(train._tree_map(lambda t: t.to(device), v) for v in ts))


def product_drift() -> None:
    """How far the card's "default" products lie from the exact (f64) sum of
    their bf16 operands, by the length K of the sums, beside the CPU's f32
    sums of the same operands: a measurement, the reason for ENCODER_REL."""
    from saev_tpu_torch.nn import modeling

    g = torch.Generator().manual_seed(SEED)
    parts = []
    for m, k, n in ((256, 128, 2048), (256, 1024, 2048), (256, 2048, 256), (256, 16384, 256)):
        a = torch.randn((m, k), generator=g).to(torch.bfloat16).float()
        b = torch.randn((k, n), generator=g).to(torch.bfloat16).float()
        exact = a.double() @ b.double()
        card = modeling.matmul(a.cuda(), b.cuda(), "default").cpu().double()
        parts.append(f"K {k}: card {float((card - exact).norm() / exact.norm()):.3g}, "
                     f"CPU f32 {float(((a @ b).double() - exact).norm() / exact.norm()):.3g}")
    log('reference products at "default" against the exact sum of their bf16 operands, rel-norm: '
        + "; ".join(parts))


def phase_reference() -> None:
    """Kernel path on the card against the plain f32 path on the CPU, from
    one state and batch at a small shape (bf16 against f32: rel 1e-2): the
    warm-up step, at d_model 128 and 64, then the AuxK step in its dense and
    subspace forms with 1/16 of the latents pinned dead. K1-K4 must launch
    once a step and SAE; each step's encoder product on the card is held to
    the bf16 algebra of its operands on the CPU."""
    from saev_tpu_torch.framework import train
    from saev_tpu_torch.nn import modeling, objectives

    product_drift()
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.normal(size=(256, 128)).astype(np.float32))
    pf = torch.from_numpy(np.stack([objectives.sample_prefixes(2048, 4, rng=rng) for _ in range(2)]))
    obj = objectives.Matryoshka(n_prefixes=4)
    warm_cfg = modeling.SparseAutoencoderConfig(d_model=128, d_sae=2048, activation=modeling.TopK(top_k=8))
    aux_cfg = modeling.SparseAutoencoderConfig(
        d_model=128, d_sae=2048, activation=modeling.TopK(top_k=8, aux=modeling.AuxK(k_aux=64))
    )
    # A d_model that is not a multiple of the kernels' 128-column tile: the
    # kernel path pads it (ops/matryoshka.py).
    narrow_cfg = modeling.SparseAutoencoderConfig(d_model=64, d_sae=2048, activation=modeling.TopK(top_k=8))
    n_dead = 2048 // 16
    cases = (
        ("warm-up", warm_cfg, 0, dict(aux_enabled=False), ("mse", "l1", "loss", "grad_norm")),
        ("warm-up, d_model 64", narrow_cfg, 0, dict(aux_enabled=False), ("mse", "l1", "loss", "grad_norm")),
        ("AuxK dense, none dead", aux_cfg, 0, {}, ("mse", "l1", "loss", "grad_norm")),
        ("AuxK dense", aux_cfg, n_dead, {}, ("mse", "aux", "loss", "grad_norm")),
        ("AuxK subspace cap 128", aux_cfg, n_dead, dict(aux_subspace_cap=128), ("mse", "aux", "loss", "grad_norm")),
    )
    for what, cfg, dead, variant, keys in cases:
        ts_cpu = train.init_sweep_state(cfg, 2, torch.Generator().manual_seed(SEED), device="cpu")
        _pin_dead(ts_cpu, dead)
        ts_gpu = _to(ts_cpu, "cuda")
        step = train.make_train_step(cfg, obj, n_steps=100, **variant)
        xc = x[:, :cfg.d_model].contiguous()
        before = counts()
        worst = dict.fromkeys(keys, 0.0)
        for i in range(3):
            ts_cpu, s_cpu = step(ts_cpu, xc, pf, _hp(2, "cpu"))
            with encoder_spy() as seen:
                ts_gpu, s_gpu = step(ts_gpu, xc.cuda(), pf.cuda(), _hp(2, "cuda"))
            enc = check_encoder(seen, f"reference {what} step {i}")
            for key in keys:
                a, b = s_gpu[key].cpu(), s_cpu[key]
                rel = float(((a - b).abs() / b.abs()).max())
                require(rel <= 1e-2, f"reference {what} step {i}: {key} rel err {rel:.3g} > 1e-2")
                worst[key] = max(worst[key], rel)
            for key in ("l0", "n_dead"):
                require(torch.equal(s_gpu[key].cpu(), s_cpu[key]), f"reference {what} step {i}: {key} differs")
            require(s_cpu["n_dead"].tolist() == [dead, dead], f"reference {what}: n_dead {s_cpu['n_dead'].tolist()}")
            require((s_gpu["aux"] > 0).tolist() == [dead > 0] * 2, f"reference {what}: aux {s_gpu['aux'].tolist()}")
        rose = {k: counts()[k] - before[k] for k in WARM_KERNELS}
        require(rose == dict.fromkeys(WARM_KERNELS, 6), f"reference {what}: launches {rose}, expected 6 each")
        for key, v in ts_gpu.params.items():
            require(bool(torch.isfinite(v).all()), f"reference {what}: param {key} not finite")
        log(f"reference {what}: 3 steps of a 2-SAE sweep (d_model {cfg.d_model}, d_sae 2048, batch 256, "
            f"{dead} dead) agree with the CPU plain path; last mse {s_gpu['mse'].tolist()}, "
            f"aux {s_gpu['aux'].tolist()} (CPU {s_cpu['aux'].tolist()}); worst rel errs "
            + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()) + f"; last step's {enc}")
    _reference_activations(x, pf, obj)


def _reference_activations(x: torch.Tensor, pf: torch.Tensor, obj) -> None:
    """Relu (L1 4e-4 and 1e-3) and BatchTopK (k 8, AuxK 64 dense, momenta 0.1
    and 0.3, 1/16 of the latents pinned dead) sweeps of 2 SAEs: 3 steps on
    the card (kernel path, "default") against the CPU's plain f32 step from
    one state, every loss term, grad_norm and BatchTopK's threshold within
    rel 1e-2, n_dead equal; K2-K4 (and K5 for BatchTopK) launch once a step
    and SAE, K1 never."""
    from saev_tpu_torch.framework import train
    from saev_tpu_torch.nn import modeling

    cases = (
        ("Relu", modeling.Relu(), 0, {"sparsity_coeff": (4e-4, 1e-3)}, ("mse", "sparsity", "l1", "loss", "grad_norm"),
         WARM_KERNELS[1:]),
        ("BatchTopK", modeling.BatchTopK(top_k=8, aux=modeling.AuxK(k_aux=64)), 2048 // 16, {"momentum": (0.1, 0.3)},
         ("mse", "aux", "l0", "loss", "grad_norm"), WARM_KERNELS[1:] + ("kth_value_masked",)),
    )
    for what, act, dead, over, keys, kernels in cases:
        cfg = modeling.SparseAutoencoderConfig(d_model=128, d_sae=2048, activation=act)
        ts_cpu = train.init_sweep_state(cfg, 2, torch.Generator().manual_seed(SEED), device="cpu")
        _pin_dead(ts_cpu, dead)
        ts_gpu = _to(ts_cpu, "cuda")
        step = train.make_train_step(cfg, obj, n_steps=100)
        hps = {dev: _hp(2, dev) | {k: torch.tensor(v, device=dev) for k, v in over.items()} for dev in ("cpu", "cuda")}
        before = counts()
        worst = dict.fromkeys(keys + ("threshold",), 0.0)
        for i in range(3):
            ts_cpu, s_cpu = step(ts_cpu, x, pf, hps["cpu"])
            with plain_spy() as plain:
                ts_gpu, s_gpu = step(ts_gpu, x.cuda(), pf.cuda(), hps["cuda"])
                torch.cuda.synchronize()
            require(not plain, f"reference {what} step {i}: the card's step ran plain versions {plain}")
            pairs = [(k, s_gpu[k].cpu(), s_cpu[k]) for k in keys]
            if what == "BatchTopK":
                pairs.append(("threshold", ts_gpu.sae_state["threshold"].cpu(), ts_cpu.sae_state["threshold"]))
            for key, a, b in pairs:
                rel = float(((a - b).abs() / b.abs()).max())
                require(rel <= 1e-2, f"reference {what} step {i}: {key} rel err {rel:.3g} > 1e-2")
                worst[key] = max(worst[key], rel)
            require(torch.equal(s_gpu["n_dead"].cpu(), s_cpu["n_dead"]) and s_cpu["n_dead"].tolist() == [dead] * 2,
                    f"reference {what} step {i}: n_dead {s_gpu['n_dead'].tolist()}, CPU {s_cpu['n_dead'].tolist()}")
        rose = {k: counts()[k] - before[k] for k in KERNELS}
        want = dict.fromkeys(KERNELS, 0) | dict.fromkeys(kernels, 6)
        require(rose == want, f"reference {what}: launches {rose}, expected {want}")
        for key, v in ts_gpu.params.items():
            require(bool(torch.isfinite(v).all()), f"reference {what}: param {key} not finite")
        log(f"reference {what}: 3 steps of a 2-SAE sweep (d_model 128, d_sae 2048, batch 256, {dead} dead) agree "
            f"with the CPU plain path; last mse {s_gpu['mse'].tolist()}, l0 {s_gpu['l0'].tolist()} (CPU "
            f"{s_cpu['l0'].tolist()}), threshold {ts_gpu.sae_state['threshold'].tolist()} (CPU "
            f"{ts_cpu.sae_state['threshold'].tolist()}); worst rel errs "
            + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))


def phase_slice() -> dict:
    from saev_tpu_torch.framework import train
    from saev_tpu_torch.nn import modeling, objectives

    cfg = modeling.SparseAutoencoderConfig(
        d_model=D_MODEL, d_sae=D_SAE, activation=modeling.TopK(top_k=TOP_K)
    )
    obj = objectives.Matryoshka(n_prefixes=N_PREFIXES)
    step = train.make_train_step(cfg, obj, n_steps=6000, optim="adam", aux_enabled=False)
    rng = np.random.default_rng(SEED)
    xs = [torch.from_numpy(rng.normal(size=(B, D_MODEL)).astype(np.float32)).to("cuda") for _ in range(2)]
    fns = wrappers()
    results = {}
    reset_counts()
    for n_sae, n_steps in ((1, 5), (2, 2)):
        ts = train.init_sweep_state(cfg, n_sae, _gen(), "cuda")
        prefixes = torch.from_numpy(
            np.stack([objectives.sample_prefixes(D_SAE, N_PREFIXES, rng=rng) for _ in range(n_sae)])
        ).to("cuda")
        hp = _hp(n_sae, "cuda")
        before = {k: fn.launches for k, fn in fns.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(n_steps):
            t0 = time.perf_counter()
            ts, stats = step(ts, xs[i % 2], prefixes, hp)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            for key, v in stats.items():
                require(bool(torch.isfinite(v.float()).all()), f"slice: stat {key} not finite: {v}")
            l0 = stats["l0"].tolist()
            # Threshold TopK keeps ties, so an exact f32 tie at a row's k-th
            # value adds 1/B to the mean; allow at most a few such rows.
            require(all(TOP_K <= v <= TOP_K + 4 / B for v in l0), f"slice: mean L0 {l0} is not {TOP_K}")
        for key, v in ts.params.items():
            require(bool(torch.isfinite(v).all()), f"slice: param {key} not finite")
        for k, fn in fns.items():
            rose = fn.launches - before[k]
            want = n_sae * n_steps if k in WARM_KERNELS else 0
            require(rose == want, f"slice: {k} launched {rose} times, expected {want}")
        ms = 1e3 * statistics.median(times[1:] if len(times) > 2 else times)
        peak = torch.cuda.max_memory_allocated() / 2**30
        results[n_sae] = {"ms": ms, "peak_gib": peak}
        log(f"slice n_sae={n_sae}: {n_steps} steps, median {ms:.2f} ms/step "
            f"({B / (ms / 1e3):.1f} patches/s), step times ms {[round(t * 1e3, 2) for t in times]}, "
            f"peak {peak:.2f} GiB, last mse {stats['mse'].tolist()}, l0 {stats['l0'].tolist()}, "
            f"launches {[fn.launches - before[k] for k, fn in fns.items()]}")
        del ts, stats
        torch.cuda.empty_cache()
    _ragged_step(cfg, step, rng)
    return counts(), results


def _ragged_step(cfg, step, rng) -> None:
    """One warm step of one SAE at batch RAGGED_B, which the Matryoshka
    kernels take padded to their 128-row tile, against the same step on the
    CPU (plain f32 path) from the same state: bf16 against f32, rel 1e-2, and
    L0 equal; its encoder product against the bf16 algebra on the CPU. K1-K4
    must launch once each."""
    from saev_tpu_torch.framework import train
    from saev_tpu_torch.nn import objectives

    x = torch.from_numpy(rng.normal(size=(RAGGED_B, D_MODEL)).astype(np.float32))
    prefixes = torch.from_numpy(objectives.sample_prefixes(D_SAE, N_PREFIXES, rng=rng)[None])
    ts_cpu = train.init_sweep_state(cfg, 1, torch.Generator().manual_seed(SEED), device="cpu")
    ts_gpu = _to(ts_cpu, "cuda")
    before = counts()
    with encoder_spy() as seen:
        ts_gpu, s_gpu = step(ts_gpu, x.cuda(), prefixes.cuda(), _hp(1, "cuda"))
    torch.cuda.synchronize()
    enc = check_encoder(seen, f"slice batch {RAGGED_B}")
    rose = {k: v - before[k] for k, v in counts().items()}
    want = dict.fromkeys(KERNELS, 0) | dict.fromkeys(WARM_KERNELS, 1)
    require(rose == want, f"slice batch {RAGGED_B}: launches {rose}, expected {want}")
    ts_cpu, s_cpu = step(ts_cpu, x, prefixes, _hp(1, "cpu"))
    rels = {}
    for key in ("mse", "l1", "loss", "grad_norm"):
        a, b = s_gpu[key].cpu(), s_cpu[key]
        rels[key] = float(((a - b).abs() / b.abs()).max())
        require(rels[key] <= 1e-2, f"slice batch {RAGGED_B}: {key} rel err {rels[key]:.3g} > 1e-2")
    require(torch.equal(s_gpu["l0"].cpu(), s_cpu["l0"]), f"slice batch {RAGGED_B}: l0 differs")
    for key, v in ts_gpu.params.items():
        require(bool(torch.isfinite(v).all()), f"slice batch {RAGGED_B}: param {key} not finite")
    log(f"slice batch {RAGGED_B}: one step through K1-K4 (batch padded to 1024) agrees with the CPU plain "
        f"path: mse {s_gpu['mse'].tolist()} (CPU {s_cpu['mse'].tolist()}), rel errs "
        + ", ".join(f"{k} {v:.3g}" for k, v in rels.items()) + f"; {enc}")

def _held_step(cfg, obj, variant: dict, n_dead: int, what: str, rng) -> str:
    """One step of one SAE at batch REFERENCE_B on the card against the same
    step on the CPU (plain f32 path) from one state with n_dead latents
    pinned: the loss terms within 1e-2 (bf16 against f32), L0 and n_dead
    equal, and no plain version of a kernel run by the card's step."""
    from saev_tpu_torch.framework import train
    from saev_tpu_torch.nn import objectives

    x = torch.from_numpy(rng.normal(size=(REFERENCE_B, cfg.d_model)).astype(np.float32))
    prefixes = torch.from_numpy(objectives.sample_prefixes(cfg.d_sae, obj.n_prefixes, rng=rng)[None])
    step = train.make_train_step(cfg, obj, n_steps=6000, **variant)
    ts_cpu = train.init_sweep_state(cfg, 1, torch.Generator().manual_seed(SEED), device="cpu")
    _pin_dead(ts_cpu, n_dead)
    ts_gpu = _to(ts_cpu, "cuda")
    with plain_spy() as plain:
        ts_gpu, s_gpu = step(ts_gpu, x.cuda(), prefixes.cuda(), _hp(1, "cuda"))
        torch.cuda.synchronize()
    require(not plain, f"{what}: the card's step ran plain versions {plain}")
    ts_cpu, s_cpu = step(ts_cpu, x, prefixes, _hp(1, "cpu"))
    keys = ("mse", "l1", "loss", "grad_norm") + (("aux",) if n_dead and variant.get("aux_enabled", True) else ())
    rels = {}
    for key in keys:
        a, b = s_gpu[key].cpu(), s_cpu[key]
        rels[key] = float(((a - b).abs() / b.abs()).max())
        require(rels[key] <= 1e-2, f"{what}: {key} rel err {rels[key]:.3g} > 1e-2")
    for key in ("l0", "n_dead"):
        require(torch.equal(s_gpu[key].cpu(), s_cpu[key]), f"{what}: {key} differs")
    for key, v in ts_gpu.params.items():
        require(bool(torch.isfinite(v).all()), f"{what}: param {key} not finite")
    return (f"{what}: one step at batch {REFERENCE_B} agrees with the CPU plain path, L0 {s_gpu['l0'].tolist()} "
            f"and n_dead {s_gpu['n_dead'].tolist()} equal, rel errs " + ", ".join(f"{k} {v:.3g}" for k, v in rels.items()))


def _timed_steps(cfg, obj, variant: dict, n_dead: int, what: str, want: dict) -> dict:
    """Three steps of one SAE at full batch from a state with n_dead latents
    pinned, each launching `want`: the median of the last two ms/step (host
    clock, each step ending in a synchronize) and the peak memory."""
    from saev_tpu_torch.framework import train
    from saev_tpu_torch.nn import objectives

    rng = np.random.default_rng(SEED + 3)
    x = torch.from_numpy(rng.normal(size=(B, cfg.d_model)).astype(np.float32)).to("cuda")
    prefixes = torch.from_numpy(objectives.sample_prefixes(cfg.d_sae, obj.n_prefixes, rng=rng)[None]).to("cuda")
    step = train.make_train_step(cfg, obj, n_steps=6000, **variant)
    ts = train.init_sweep_state(cfg, 1, _gen(), "cuda")
    _pin_dead(ts, n_dead)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        before = counts()
        t0 = time.perf_counter()
        ts, stats = step(ts, x, prefixes, _steady_hp(1))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        rose = {k: v - before[k] for k, v in counts().items()}
        require(rose == want, f"{what}: launches {rose}, expected {want}")
        for key, v in stats.items():
            require(bool(torch.isfinite(v.float()).all()), f"{what}: stat {key} not finite: {v}")
        require(all(TOP_K <= v <= TOP_K + 4 / B for v in stats["l0"].tolist()), f"{what}: L0 {stats['l0'].tolist()}")
    ms, peak = statistics.median(times[1:]), torch.cuda.max_memory_allocated() / 2**30
    log(f"{what}: median {ms:.2f} ms/step ({B / (ms / 1e3):.1f} patches/s), step times ms "
        f"{[round(t, 2) for t in times]}, peak {peak:.2f} GiB, n_dead {stats['n_dead'].tolist()}")
    del ts, stats
    torch.cuda.empty_cache()
    return {"ms": ms, "peak_gib": peak}


def _huge_dense():
    """d_sae 131072's dense step (d_model 1024, TopK 32, AuxK 512,
    Matryoshka 10, Adam) with 30% of the latents pinned dead: its config,
    objective and dead count. Its AuxK select (K5) takes 39321 unmasked
    columns, past the group route's 32768 and every rung of the ladder."""
    from saev_tpu_torch.nn import modeling, objectives

    cfg = modeling.SparseAutoencoderConfig(d_model=D_MODEL, d_sae=D_SAE_HUGE, activation=modeling.TopK(top_k=TOP_K))
    n_dead = int(D_SAE_HUGE * DEAD_HUGE)
    require(n_dead > 32768 and n_dead > objectives.subspace_cap_ladder(D_SAE_HUGE, K_AUX)[-1],
            f"wide steps: {n_dead} dead of {D_SAE_HUGE} would not take the dense step's cluster route")
    return cfg, objectives.Matryoshka(n_prefixes=N_PREFIXES), n_dead


def time_huge_dense_step() -> dict:
    """d_sae 131072's dense step (`_huge_dense`) timed at batch B by
    `_timed_steps`, K1-K4 and K5 once a step. `scripts/route_probe.py
    --step` times each tree's step with it."""
    cfg, obj, n_dead = _huge_dense()
    want = dict.fromkeys(KERNELS, 0) | dict.fromkeys(WARM_KERNELS, 1) | {"kth_value_masked": 1}
    return _timed_steps(cfg, obj, {}, n_dead, f"wide step d_sae {D_SAE_HUGE} dense, {n_dead} dead (K5 past 32768 "
                        f"unmasked columns)", want)


def phase_wide_steps():
    """The train step at shapes the card refused before (fault ROADMAP
    §3.6): d_sae 65536 at d_model 1024 (TopK 32, AuxK 512, Matryoshka 10,
    Adam), in the warm, tight-rung and dense variants from a state with 5%
    of the latents pinned dead; d_sae 131072's dense step with 30% pinned
    dead, whose AuxK select (K5, 39321 unmasked columns) takes the cluster
    route; and the production shape with 65 prefixes (warm). Each is held to
    the CPU's f32 step at batch 1024, then timed at batch 16384. Returns the
    launch counts of the path and the timings."""
    from saev_tpu_torch.nn import modeling, objectives

    wide = modeling.SparseAutoencoderConfig(d_model=D_MODEL, d_sae=D_SAE_WIDE, activation=modeling.TopK(top_k=TOP_K))
    obj = objectives.Matryoshka(n_prefixes=N_PREFIXES)
    tight = objectives.subspace_cap_ladder(D_SAE_WIDE, K_AUX)[0]
    n_dead = int(D_SAE_WIDE * 0.05)
    require(n_dead <= tight, f"wide steps: {n_dead} dead above the tight rung's cap {tight}")
    variants = {"warm": dict(aux_enabled=False), f"tight (cap {tight})": dict(aux_subspace_cap=tight), "dense": {}}
    many = modeling.SparseAutoencoderConfig(d_model=D_MODEL, d_sae=D_SAE, activation=modeling.TopK(top_k=TOP_K))
    obj_many = objectives.Matryoshka(n_prefixes=N_PREFIXES_MANY)
    rng = np.random.default_rng(SEED + 2)
    results = {}
    once = dict.fromkeys(KERNELS, 0) | dict.fromkeys(WARM_KERNELS, 1)
    reset_counts()
    for name, variant in variants.items():
        log(_held_step(wide, obj, variant, n_dead, f"wide step d_sae {D_SAE_WIDE} {name}", rng))
    for name, variant in variants.items():
        want = once | ({} if name == "warm" else {"kth_value_masked": 1})
        results[f"d_sae {D_SAE_WIDE} {name}"] = _timed_steps(
            wide, obj, variant, n_dead, f"wide step d_sae {D_SAE_WIDE} {name}, {n_dead} dead", want)
    huge, obj_huge, n_dead_huge = _huge_dense()
    log(_held_step(huge, obj_huge, {}, n_dead_huge, f"wide step d_sae {D_SAE_HUGE} dense", rng))
    results[f"d_sae {D_SAE_HUGE} dense"] = time_huge_dense_step()
    wide_route = counts()
    log(f"wide steps: launches at d_sae {D_SAE_WIDE} and {D_SAE_HUGE}, K1's and K5's rows on the wide route "
        f"(csrc/kth_wide.cu): K1 {wide_route['topk_stats']}, K5 {wide_route['kth_value_masked']}, "
        f"K6 {wide_route['kth_value']}")
    reset_counts()
    log(_held_step(many, obj_many, dict(aux_enabled=False), 0, f"step {N_PREFIXES_MANY} prefixes warm", rng))
    results[f"{N_PREFIXES_MANY} prefixes warm"] = _timed_steps(
        many, obj_many, dict(aux_enabled=False), 0, f"step {N_PREFIXES_MANY} prefixes warm", once)
    return {k: wide_route[k] + v for k, v in counts().items()}, results


# (fraction of latents pinned dead, the variant of each step from
# aux_from_step - 1): the warm step, the dense step while no aux_risk readout
# exists, then the narrowest rung that holds n_dead (tight 1024, wide 4096)
# or the dense step above it.
STEADY_RUNS = (
    (0.05, ["warm", "dense"] + ["tight"] * 6),
    (0.02, ["warm", "dense", "tight"]),
    (0.20, ["warm", "dense", "wide", "wide"]),
    (0.40, ["warm", "dense", "dense", "dense"]),
)
# Fraction dead -> the ladder rung whose aux is held to the dense step's from
# one state (n_dead <= cap, so both select the same dead columns).
CHECK_RUNG = {0.05: 0, 0.20: 1}


def _steady_hp(n_sae: int) -> dict:
    """bench.py's hyperparameters (bench.py:88-95)."""
    return {
        "lr": torch.full((n_sae,), 4e-4, device="cuda"),
        "n_lr_warmup": torch.full((n_sae,), 500.0, device="cuda"),
        "grad_clip": torch.ones((n_sae,), device="cuda"),
        "sparsity_coeff": torch.zeros((n_sae,), device="cuda"),
        "aux_alpha": torch.full((n_sae,), 1 / 32, device="cuda"),
    }


def phase_steady():
    """The router over the AuxK step at full width. Returns the launch
    counts of the path, ms/step and peak GiB per (n_sae, variant), and the
    two-SAE state at 5% dead with its batch and prefixes."""
    from saev_tpu_torch.framework import train
    from saev_tpu_torch.nn import modeling, objectives

    cfg = modeling.SparseAutoencoderConfig(d_model=D_MODEL, d_sae=D_SAE, activation=modeling.TopK(top_k=TOP_K))
    require(cfg.activation.aux.k_aux == K_AUX, f"AuxK k_aux {cfg.activation.aux.k_aux}")
    obj = objectives.Matryoshka(n_prefixes=N_PREFIXES)
    rng = np.random.default_rng(SEED + 1)
    xs = [torch.from_numpy(rng.normal(size=(B, D_MODEL)).astype(np.float32)).to("cuda") for _ in range(2)]
    per_variant: dict[tuple[int, str], dict] = {}
    kept = None
    check_launches = dict.fromkeys(KERNELS, 0)
    reset_counts()
    for n_sae in (1, 2):
        prefixes = torch.from_numpy(
            np.stack([objectives.sample_prefixes(D_SAE, N_PREFIXES, rng=rng) for _ in range(n_sae)])
        ).to("cuda")
        hp = _steady_hp(n_sae)
        for frac, expected in STEADY_RUNS:
            if n_sae == 2 and frac == 0.05:
                expected = expected[:5]
            n_dead = int(D_SAE * frac)
            router = train.make_step_router(cfg, obj, n_steps=6000, batch_size=B)
            require([c for c, _ in router.step_fn_subs] == [TIGHT, WIDE],
                    f"steady: ladder {[c for c, _ in router.step_fn_subs]}")
            names = {id(router.step_fn_warm): "warm", id(router.step_fn): "dense",
                     id(router.step_fn_subs[0][1]): "tight", id(router.step_fn_subs[1][1]): "wide"}
            ts = train.init_sweep_state(cfg, n_sae, _gen(), "cuda")
            _pin_dead(ts, n_dead)
            seq, times = [], []
            start = router.aux_from_step - 1
            for i, g in enumerate(range(start, start + len(expected))):
                fn = router.step_fn_at(g)
                name = names[id(fn)]
                seq.append(name)
                before = counts()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                ts, stats = fn(ts, xs[i % 2], prefixes, hp)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated() / 2**30
                router.record_stats(g, stats)
                rose = {k: v - before[k] for k, v in counts().items()}
                want = dict.fromkeys(KERNELS, 0) | {k: n_sae for k in WARM_KERNELS}
                want.update(kth_value_masked=0 if name == "warm" else n_sae)
                require(rose == want, f"steady {frac:.0%} step {g} ({name}): launches {rose}, expected {want}")
                for key, v in stats.items():
                    require(bool(torch.isfinite(v.float()).all()), f"steady: stat {key} not finite: {v}")
                require(stats["n_dead"].tolist() == [n_dead] * n_sae,
                        f"steady {frac:.0%} step {g}: n_dead {stats['n_dead'].tolist()}, planted {n_dead}")
                require(all(TOP_K <= v <= TOP_K + 4 / B for v in stats["l0"].tolist()),
                        f"steady: mean L0 {stats['l0'].tolist()} is not {TOP_K}")
                if name != "warm":
                    require(bool((stats["aux"] > 0).all()), f"steady: aux {stats['aux'].tolist()} at {name}")
                rec = per_variant.setdefault((n_sae, name), {"ms": [], "peak_gib": 0.0})
                rec["ms"].append(dt * 1e3)
                rec["peak_gib"] = max(rec["peak_gib"], peak)
                times.append(round(dt * 1e3, 2))
            require(seq == expected, f"steady n_sae={n_sae} {frac:.0%}: variants {seq}, expected {expected}")
            for key, v in ts.params.items():
                require(bool(torch.isfinite(v).all()), f"steady: param {key} not finite")
            log(f"steady n_sae={n_sae} {frac:.0%} dead ({n_dead}): steps {start}..{start + len(seq) - 1} "
                f"ran {seq}, ms {times}, n_dead {stats['n_dead'].tolist()}, "
                f"last aux {stats['aux'].tolist()}, mse {stats['mse'].tolist()}")
            if frac in CHECK_RUNG:
                cap, sub_fn = router.step_fn_subs[CHECK_RUNG[frac]]
                before = counts()
                _, s_dense = router.step_fn(ts, xs[0], prefixes, hp)
                _, s_sub = sub_fn(ts, xs[0], prefixes, hp)
                for k, v in counts().items():
                    check_launches[k] += v - before[k]
                # Two bf16-operand products of different shapes, each summed
                # in f32 in its own order; both keep the same dead columns.
                rel = float(((s_sub["aux"] - s_dense["aux"]).abs() / s_dense["aux"].abs()).max())
                require(rel <= 1e-4, f"steady n_sae={n_sae} {frac:.0%}: cap {cap} aux rel err {rel:.3g} > 1e-4")
                log(f"steady n_sae={n_sae} {frac:.0%} dead: subspace (cap {cap}) aux {s_sub['aux'].tolist()} "
                    f"against dense {s_dense['aux'].tolist()}, rel err {rel:.3g}")
                if frac == 0.05 and n_sae == 2:
                    kept = (ts, xs[0], prefixes, n_dead)
            del ts, stats
            torch.cuda.empty_cache()
    results = {}
    for (n_sae, name), rec in sorted(per_variant.items()):
        ms = statistics.median(rec["ms"])
        results[(n_sae, name)] = {"ms": ms, "peak_gib": rec["peak_gib"], "n": len(rec["ms"])}
        log(f"steady variant {name} n_sae={n_sae}: median {ms:.2f} ms/step over {len(rec['ms'])} steps "
            f"({B / (ms / 1e3):.1f} patches/s), peak {rec['peak_gib']:.2f} GiB, ms {[round(t, 2) for t in rec['ms']]}")
    return {k: v - check_launches[k] for k, v in counts().items()}, results, kept


def phase_metrics(ts, x, prefixes, n_dead: int) -> dict:
    """The log-step metrics once at full width: K6 launches once per SAE."""
    from saev_tpu_torch.framework import train
    from saev_tpu_torch.nn import modeling

    cfg = modeling.SparseAutoencoderConfig(d_model=D_MODEL, d_sae=D_SAE, activation=modeling.TopK(top_k=TOP_K))
    metrics = train.make_metrics_fn(cfg)
    n_sae = ts.params["W_dec"].shape[0]
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = metrics(ts, x, prefixes)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    got = counts()
    want = {k: 0 for k in got} | {"kth_value": n_sae}
    require(got == want, f"metrics: launches {got}, expected {want}")
    for key, v in out.items():
        require(tuple(v.shape) == (n_sae,) and bool(torch.isfinite(v).all()), f"metrics: {key} = {v}")
    require(bool((out["dead_unit_pct"] >= n_dead / D_SAE).all()),
            f"metrics: dead_unit_pct {out['dead_unit_pct'].tolist()} below the planted {n_dead / D_SAE}")
    log(f"metrics n_sae={n_sae}: {ms:.2f} ms, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        + ", ".join(f"{k} {[round(u, 6) for u in v.tolist()]}" for k, v in out.items()))
    return got


def _time(fn, n: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def bound(parts, ops: float, peak: float) -> dict:
    """The least time the card could take for a function: the larger of the
    bytes it must move (each of `parts`, a tensor or a byte count, read or
    written once) over the memory rate, and `ops` operations over `peak`."""
    n_bytes = sum(p if isinstance(p, int) else p.numel() * p.element_size() for p in parts)
    mem_ms, op_ms = n_bytes / HBM_BYTES_S * 1e3, ops / peak * 1e3
    return {"bound_ms": max(mem_ms, op_ms), "bound_by": "bytes" if mem_ms >= op_ms else "operations"}


def timed(ms: float, plain_ms: float, bnd: dict, library_ms: float | None = None) -> dict:
    return {"ms": ms, "plain_ms": plain_ms, **bnd, "library_ms": library_ms}


def library_kth_ms(h: torch.Tensor, k: int, what: str) -> float:
    """The faster of the library calls that give each row's k-th largest
    value (torch.topk, torch.kthvalue), timed on h."""
    from saev_tpu_torch.scripts import proto_kth_ops

    lib = {name: _time(lambda fn=fn: fn(h, k), 10) for name, fn in proto_kth_ops.LIBRARY.items()}
    log(f"timing library k-th value for {what} {tuple(h.shape)} k {k}: "
        + ", ".join(f"{name} {ms:.3f} ms" for name, ms in lib.items()))
    return min(lib.values())


def _selection_bound(h: torch.Tensor, out: torch.Tensor) -> dict:
    """A selection over h: h read once, the output written once, and one
    operation an element (the least any selection does) at the f32 rate."""
    return bound((h, out), h.numel(), F32_OPS_S)


def log_timing(k: str, row: dict, what: str = "") -> None:
    lib = "none" if row["library_ms"] is None else f"{row['library_ms']:.3f} ms"
    log(f"timing {k}{what}: kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, bound "
        f"{row['bound_ms']:.3f} ms ({row['bound_by']}), library {lib}")


def phase_timing() -> dict:
    """Each kernel at the main path's shapes: kernel ms, plain ms, bound and
    library ms; K5 at the tight rung's subspace shape, and separately at the
    wide rung's and the dense shape."""
    from saev_tpu_torch.ops import cuda_kth, cuda_topk, topk
    from saev_tpu_torch.ops import cuda_matryoshka as cm

    from saev_tpu_torch.scripts import kprof

    out = {}
    h = torch.randn((B, D_SAE), generator=_gen(), device="cuda")
    stats = cuda_topk.topk_stats_cuda(h, TOP_K)
    out["topk_stats"] = timed(_time(lambda: cuda_topk.topk_stats_cuda(h, TOP_K), 10),
                              _time(lambda: topk._topk_stats_plain(h, TOP_K), 3),
                              bound((h, *stats), h.numel(), F32_OPS_S))
    rows = kprof.device_profile(lambda: cuda_topk.topk_stats_cuda(h, TOP_K), n=10, warmup=2,
                                expect=("topk_stats",))
    log("timing K1 by the profiler: " + "; ".join(f"{k[:70]} {t:.3f} ms x{c}" for k, t, c in rows[:3])
        + f"; {_k1_fallbacks(h, TOP_K)} of {B} Gaussian rows took the whole-row fallback")
    k6_fell = torch.zeros(1, dtype=torch.int32, device="cuda")
    cuda_kth.kth_value_cuda(h, TOP_K, k6_fell)
    rows = kprof.device_profile(lambda: cuda_kth.kth_value_cuda(h, TOP_K), n=10, warmup=2, expect=("kth",))
    require(int(k6_fell) == 0, f"timing K6: {int(k6_fell)} of {B} Gaussian rows took the whole-row fallback")
    log("timing K6 by the profiler: " + "; ".join(f"{k[:70]} {t:.3f} ms x{c}" for k, t, c in rows[:3])
        + f"; {int(k6_fell)} of {B} Gaussian rows took the whole-row fallback")
    out["kth_value"] = timed(_time(lambda: cuda_kth.kth_value_cuda(h, TOP_K), 10),
                             _time(lambda: topk._kth_plain(h, TOP_K), 3),
                             _selection_bound(h, stats.kth), library_kth_ms(h, TOP_K, "K6"))
    del h, stats
    masked = {}
    for s, n_dead in ((TIGHT, N_DEAD_5), (WIDE, N_DEAD_20), (D_SAE, N_DEAD_5)):
        h = _k5_inputs(s, n_dead)
        mask = torch.arange(s, device="cuda") < n_dead
        kth = cuda_kth.kth_value_masked_cuda(h, mask, K_AUX)
        # Only the unmasked columns of h need reading.
        masked[s] = timed(_time(lambda: cuda_kth.kth_value_masked_cuda(h, mask, K_AUX), 10),
                          _time(lambda: topk._kth_masked_plain(h, mask, K_AUX), 3),
                          bound((B * n_dead * 4, mask, kth), B * n_dead, F32_OPS_S))
        log_timing("kth_value_masked", masked[s], f" {B}x{s} k {K_AUX} ({n_dead} unmasked)")
        del h
    out["kth_value_masked"] = masked[TIGHT]
    # The tight rung's call on Gaussian rows, not pinned near -1e6: K5's
    # bisection starts below the common prefix of a row's least and largest
    # unmasked key, so its steps depend on how close those keys lie.
    h = torch.randn((B, TIGHT), generator=_gen(), device="cuda")
    mask = torch.arange(TIGHT, device="cuda") < N_DEAD_5
    log(f"timing kth_value_masked {B}x{TIGHT} k {K_AUX} on Gaussian rows, not pinned: kernel "
        f"{_time(lambda: cuda_kth.kth_value_masked_cuda(h, mask, K_AUX), 10):.3f} ms")
    del h
    torch.cuda.empty_cache()
    f, w, x, b_dec, cut_sets = _matryoshka_inputs()
    m, r = _cuts(cut_sets["sampled"])
    iu = (1.0 / x.abs().max()).reshape(1)
    scale = torch.full((1,), 2.0 / (B * N_PREFIXES * D_MODEL), device="cuda")
    e, xhat, loss = cm.grouped_prefix_err(f, w, x, b_dec, iu, m, r, group_size=GROUP)
    df, da = cm.grouped_matmul_dgrad(w, e, m, r, scale, group_size=GROUP, df_dtype=torch.bfloat16)
    dw = cm.grouped_matmul_wgrad(f, da, e, m, r, scale, group_size=GROUP)
    # f's zeros need no product: 2 operations for each nonzero of f and
    # column of W. dgrad's E is dense.
    sparse_ops = 2 * int((f != 0).sum()) * D_MODEL
    out["grouped_prefix_err"] = timed(
        _time(lambda: cm.grouped_prefix_err(f, w, x, b_dec, iu, m, r, group_size=GROUP), 10),
        _time(lambda: cm.grouped_prefix_err_plain(f, w, x, b_dec, iu, m, r, group_size=GROUP), 2),
        bound((f, w, x, b_dec, iu, m, r, e, xhat, loss), sparse_ops, BF16_OPS_S))
    # K3's product: the main term over every latent and each cut's remainder
    # over its r_j lanes (a cut at p_j = d_sae has r_j = 0).
    k3_ops = 2 * B * D_MODEL * (D_SAE + int(r.sum()))
    out["grouped_matmul_dgrad"] = timed(
        _time(lambda: cm.grouped_matmul_dgrad(w, e, m, r, scale, group_size=GROUP,
                                              df_dtype=torch.bfloat16), 10),
        _time(lambda: cm.grouped_matmul_dgrad_plain(w, e, m, r, scale, group_size=GROUP,
                                                    df_dtype=torch.bfloat16), 2),
        bound((w, e, m, r, scale, df, da), k3_ops, BF16_OPS_S))
    del df
    _k2_launches(f, w, x, b_dec, iu, m, r, "sampled")
    _k3_launches(w, e, m, r, scale, "sampled")
    m_h, r_h = _cuts(cut_sets["hand-set"])
    _k2_launches(f, w, x, b_dec, iu, m_h, r_h, "hand-set")
    # The walk with one snapshot, after it: what the other nine cost.
    _k2_launches(f, w, x, b_dec, iu, *_cuts(np.asarray([D_SAE], np.int32)), "d_sae only")
    e_h, _, _ = cm.grouped_prefix_err(f, w, x, b_dec, iu, m_h, r_h, group_size=GROUP)
    _k3_launches(w, e_h, m_h, r_h, scale, "hand-set")
    k4_sampled = _k4_launches(f, da, e, m, r, scale, "sampled")
    _, da_h = cm.grouped_matmul_dgrad(w, e_h, m_h, r_h, scale, group_size=GROUP, df_dtype=torch.bfloat16)
    k4_hand = _k4_launches(f, da_h, e_h, m_h, r_h, scale, "hand-set")
    log(f"timing K4 sampled over hand-set cuts: {k4_sampled / k4_hand:.3f} (device ms {k4_sampled:.3f} / "
        f"{k4_hand:.3f})")
    del e_h, da_h
    out["grouped_matmul_wgrad"] = timed(
        _time(lambda: cm.grouped_matmul_wgrad(f, da, e, m, r, scale, group_size=GROUP), 10),
        _time(lambda: cm.grouped_matmul_wgrad_plain(f, da, e, m, r, scale, group_size=GROUP), 2),
        bound((f, da, e, m, r, scale, dw), sparse_ops, BF16_OPS_S))
    for k, row in out.items():
        log_timing(k, row, f" (cuts {cut_sets['sampled'].tolist()})" if k.startswith("grouped") else "")
    return out


def _k2_launches(f, w, x, b_dec, iu, m, r, what: str) -> None:
    """K2's two launches by the profiler: the product beside the bound of
    the timing phase's K2 row (bytes: f, W, x, E and xhat once; operations:
    2 D for each nonzero of f) and beside the dense tensor-core floor of
    this design, 2 B S D at the bf16 rate; the partials' sum beside nothing
    (1024 floats). Then a cuBLAS product of f @ W with bf16 operands (f32
    out where torch has it): a yardstick of the main term, which the port
    never calls."""
    from saev_tpu_torch.nn import modeling
    from saev_tpu_torch.ops import cuda_matryoshka as cm
    from saev_tpu_torch.scripts import kprof

    rows = kprof.device_profile(lambda: cm.grouped_prefix_err(f, w, x, b_dec, iu, m, r, group_size=GROUP),
                                n=10, warmup=2, expect=K2_NAMES)
    ms = {name: sum(t for k, t, _ in rows if name in k) for name in K2_NAMES}
    require(all(v > 0 for v in ms.values()), f"timing K2 {what}: profiler rows {rows}")
    j = m.shape[0]
    prod = bound((f, w, x, b_dec, j * B * D_MODEL * 2, B * D_MODEL * 4),
                 2 * int((f != 0).sum()) * D_MODEL, BF16_OPS_S)
    dense = 2 * B * D_SAE * D_MODEL
    floor = dense / BF16_OPS_S * 1e3
    lanes = sum(int(p) % 16 for p in (m * GROUP + r).tolist())
    log(f"timing K2 {what}: prefix_wgmma_kernel {ms[K2_NAMES[0]]:.3f} ms, bound {prod['bound_ms']:.3f} "
        f"({prod['bound_by']}), dense floor {floor:.3f}, {dense / ms[K2_NAMES[0]] / 1e9:.1f} TFLOP/s dense "
        f"({j} snapshots, {lanes} correction lanes); sum_partials_kernel {ms[K2_NAMES[1]]:.4f} ms")
    if modeling.has_bf16_mm_f32():
        mm, how = (lambda: torch.mm(f, w, out_dtype=torch.float32)), "bf16 operands, f32 out"
    else:
        mm, how = (lambda: torch.mm(f, w)), "bf16 operands and out"
    mm_rows = kprof.device_profile(mm, n=10, warmup=2)
    mm_ms = kprof.total_device_ms(mm_rows)
    log(f"timing K2 {what} yardstick: cuBLAS f @ W ({how}, {B} x {D_SAE} @ {D_SAE} x {D_MODEL}): "
        f"{mm_ms:.3f} ms device, {dense / mm_ms / 1e9:.1f} TFLOP/s; kernels "
        + "; ".join(f"{k[:60]} {t:.3f} ms x{c}" for k, t, c in mm_rows))


def _k4_launches(f, da, e, m, r, scale, what: str) -> float:
    """K4's two launches by the profiler, each beside its own bound, and
    the dense tensor-core floor of its design; returns their device ms. The
    product's bound: f, dA and the E_j with a live remainder read once, dW
    and the live partials written once, against 2 D operations for each
    nonzero of f (main term) and of f's first r_j lanes of group m_j (each
    remainder). The combine's: the live partials read once and their dW
    tiles read and written once. The floor: 2 * 128 * 128 * B operations
    for each item that runs (main items and live remainders) at the bf16
    rate. Then the cuBLAS strided-batched product of the main term alone,
    f_G^T as (G, g, B) against dA as (G, B, D): a yardstick of what the card
    gives that product, which the port never calls."""
    from saev_tpu_torch.ops import cuda_matryoshka as cm
    from saev_tpu_torch.scripts import kprof

    rows = kprof.device_profile(lambda: cm.grouped_matmul_wgrad(f, da, e, m, r, scale, group_size=GROUP),
                                n=10, warmup=2, expect=K4_NAMES)
    ms = {name: sum(t for k, t, _ in rows if name in k) for name in K4_NAMES}
    require(all(v > 0 for v in ms.values()), f"timing K4 {what}: profiler rows {rows}")
    n_groups, tiles = D_SAE // GROUP, 128 * 128
    m_l, r_l = m.tolist(), r.tolist()
    rem = [j for j in range(len(m_l)) if m_l[j] < n_groups and r_l[j] > 0]
    n_live = (D_MODEL // 128) * sum(-(-r_l[j] // 128) for j in rem)
    n_main = n_groups * (GROUP // 128) * (D_MODEL // 128)
    live_tiles = (D_MODEL // 128) * len({(m_l[j], s0) for j in rem for s0 in range(0, r_l[j], 128)})
    nnz_rem = sum(int((f[:, m_l[j] * GROUP: m_l[j] * GROUP + r_l[j]] != 0).sum()) for j in rem)
    ops = 2 * D_MODEL * (int((f != 0).sum()) + nnz_rem)
    prod = bound((f, da, len(rem) * B * D_MODEL * 2, D_SAE * D_MODEL * 4, n_live * tiles * 4), ops, BF16_OPS_S)
    comb = bound((n_live * tiles * 4, 2 * live_tiles * tiles * 4), 0, F32_OPS_S)
    floor = 2 * tiles * B * (n_main + n_live) / BF16_OPS_S * 1e3
    log(f"timing K4 {what}: wgrad_wgmma_kernel {ms[K4_NAMES[0]]:.3f} ms, bound {prod['bound_ms']:.3f} "
        f"({prod['bound_by']}), dense floor {floor:.3f} ({n_main} main + {n_live} live remainder items), "
        f"{2 * tiles * B * (n_main + n_live) / ms[K4_NAMES[0]] / 1e9:.1f} TFLOP/s dense; "
        f"wgrad_combine_kernel {ms[K4_NAMES[1]]:.3f} ms, bound {comb['bound_ms']:.4f} ({comb['bound_by']}: "
        f"{live_tiles} dW tiles)")
    a = f.view(B, n_groups, GROUP).permute(1, 2, 0)
    bmm_rows = kprof.device_profile(lambda: torch.bmm(a, da.permute(1, 0, 2)), n=10, warmup=2)
    bmm_ms = kprof.total_device_ms(bmm_rows)
    log(f"timing K4 {what} yardstick: cuBLAS bmm of the main term (G {n_groups}, g {GROUP}, B {B}) @ (B, D {D_MODEL}): "
        f"{bmm_ms:.3f} ms device, {2 * B * D_SAE * D_MODEL / bmm_ms / 1e9:.1f} TFLOP/s; kernels "
        + "; ".join(f"{k[:60]} {t:.3f} ms x{c}" for k, t, c in bmm_rows))
    return sum(ms.values())


def _k3_launches(w, e, m, r, scale, what: str) -> None:
    """K3's two launches by the profiler, each beside its own bound: the dA
    build by bytes (the E_j that enter dA, m_j >= 1, read once; dA written
    once), the product by operations (2 B D (S + sum r_j)). Then the cuBLAS
    bmm of the main term alone, dA as (G, B, D) against W as (G, D, g): a
    yardstick of what the card gives that product, which the port never
    calls."""
    from saev_tpu_torch.ops import cuda_matryoshka as cm
    from saev_tpu_torch.scripts import kprof

    rows = kprof.device_profile(lambda: cm.grouped_matmul_dgrad(w, e, m, r, scale, group_size=GROUP,
                                                                 df_dtype=torch.bfloat16),
                                n=10, warmup=2, expect=K3_NAMES)
    ms = {name: sum(t for k, t, _ in rows if name in k) for name in K3_NAMES}
    require(all(v > 0 for v in ms.values()), f"timing K3 {what}: profiler rows {rows}")
    n_groups = D_SAE // GROUP
    entering = int(((m >= 1) & (m <= n_groups)).sum())
    da_bytes = B * n_groups * D_MODEL * 2
    build = bound((entering * B * D_MODEL * 2, da_bytes), 0, BF16_OPS_S)
    n_rem = int((r > 0).sum())
    ops = 2 * B * D_MODEL * (D_SAE + int(r.sum()))
    prod = bound((w, da_bytes, n_rem * B * D_MODEL * 2, B * D_SAE * 2), ops, BF16_OPS_S)
    log(f"timing K3 {what}: build_da_vec_kernel {ms[K3_NAMES[0]]:.3f} ms, bound {build['bound_ms']:.3f} "
        f"({build['bound_by']}: {entering} E_j enter dA), "
        f"{(entering * B * D_MODEL * 2 + da_bytes) / ms[K3_NAMES[0]] / 1e9:.2f} TB/s; "
        f"dgrad_wgmma_kernel {ms[K3_NAMES[1]]:.3f} ms, bound {prod['bound_ms']:.3f} ({prod['bound_by']}: "
        f"{n_rem} remainders, {int(r.sum())} lanes), {ops / ms[K3_NAMES[1]] / 1e9:.1f} TFLOP/s")
    df, da = cm.grouped_matmul_dgrad(w, e, m, r, scale, group_size=GROUP, df_dtype=torch.bfloat16)
    del df
    a = da.view(B, n_groups, D_MODEL).transpose(0, 1)
    wt = w.view(n_groups, GROUP, D_MODEL).transpose(1, 2)
    bmm_rows = kprof.device_profile(lambda: torch.bmm(a, wt), n=10, warmup=2)
    bmm_ms = kprof.total_device_ms(bmm_rows)
    log(f"timing K3 yardstick: cuBLAS bmm of the main term (G {n_groups}, B {B}, D {D_MODEL}) @ (D, g {GROUP}): "
        f"{bmm_ms:.3f} ms device, {2 * B * D_SAE * D_MODEL / bmm_ms / 1e9:.1f} TFLOP/s; kernels "
        + "; ".join(f"{k[:60]} {t:.3f} ms x{c}" for k, t, c in bmm_rows))


def _k7_case(f, w, x, b_dec, iu, p: np.ndarray, what: str) -> float:
    """K7 against its plain version (rel-norm 1e-4, as K2's xhat) and against
    K2 bit for bit: the same xhat, and bf16(base_j + (b_dec - x)) = E_j; the
    bf16 base is the f32 base rounded."""
    from saev_tpu_torch.ops import cuda_matryoshka as cm

    m, r = _cuts(p)
    base, xhat = cm.grouped_prefix_base(f, w, m, r, group_size=GROUP)
    base16, xhat16 = cm.grouped_prefix_base(f, w, m, r, group_size=GROUP, base_dtype=torch.bfloat16)
    e, k2_xhat, _ = cm.grouped_prefix_err(f, w, x, b_dec, iu, m, r, group_size=GROUP)
    torch.cuda.synchronize()
    require(same_bits(xhat, k2_xhat) and same_bits(xhat16, k2_xhat), f"K7 {what}: xhat differs from K2's")
    e_from_base = (base + (b_dec - x)).to(torch.bfloat16)
    n_diff = int((e_from_base.view(torch.int16) != e.view(torch.int16)).sum())
    require(n_diff == 0, f"K7 {what}: bf16(base + b_dec - x) differs from K2's E at {n_diff} entries, "
                         f"rel-norm {rel_norm(e_from_base, e):.3g}")
    require(torch.equal(base16.view(torch.int16), base.to(torch.bfloat16).view(torch.int16)),
            f"K7 {what}: the bf16 base is not the f32 base rounded")
    del e, e_from_base, k2_xhat, xhat16
    pbase, pxhat = cm.grouped_prefix_base_plain(f, w, m, r, group_size=GROUP)
    r_base, r_xhat, r_16 = rel_norm(base, pbase), rel_norm(xhat, pxhat), rel_norm(base16, pbase)
    require(r_base <= 1e-4 and r_xhat <= 1e-4, f"K7 {what}: base {r_base:.3g} / xhat {r_xhat:.3g} rel-norm > 1e-4")
    require(r_16 <= 1e-2, f"K7 {what}: bf16 base rel-norm {r_16:.3g} > 1e-2")
    err = max(max_abs(base, pbase), max_abs(xhat, pxhat))
    log(f"parity K7 {what} cuts {p.tolist()}: base rel-norm {r_base:.3g}, xhat {r_xhat:.3g}, bf16 base "
        f"{r_16:.3g}; xhat and bf16(base + b_dec - x) bitwise equal to K2's xhat and E")
    return err


def _pass_sass() -> None:
    """P4's tensor-core count is in mxu's instantiations, every one of them
    (streamed and one CTA a row), and in no other mode's; the pass loops of
    P4's modes and of P3 at the production width, with their instructions
    and register chains a key (cuobjdump --dump-sass of the built
    library)."""
    from saev_tpu_torch.scripts import proto_kth_ops

    found = proto_kth_ops.sass_opcodes()
    hmma = proto_kth_ops.hmma_by_mode(found)
    require(all(len(v) == 12 for v in hmma.values()), f"P4 SASS: instantiations {hmma}")
    require(all(n > 0 for n in hmma["mxu"]), f"P4 SASS: an mxu instantiation has no HMMA: {hmma}")
    require(all(n == 0 for mode, v in hmma.items() if mode != "mxu" for n in v),
            f"P4 SASS: HMMA outside mxu: {hmma}")
    for kernel in proto_kth_ops.MODES + ("count_loop",):
        require(sum(found[(kernel, "stream", 64, 256)]["pass"].values()) > 0, f"SASS: no pass loop in {kernel}")
    for line in proto_kth_ops.sass_report(found):
        log("P3, P4 " + line)


def phase_benches() -> tuple[dict, dict, dict]:
    """The kernel-level entry points through their modules. Returns the
    launch counts of their measured work, and each new kernel's max abs
    error and timing row (kernel ms, plain ms, bound, library ms)."""
    from saev_tpu_torch.ops import cuda_matryoshka as cm
    from saev_tpu_torch.nn import modeling
    from saev_tpu_torch.ops import _build, cuda_topk
    from saev_tpu_torch.scripts import (digests, kprof, microbench_kth, proto_encode_stats, proto_gouter,
                                        proto_kth_ops, select_probe)

    errs = {}
    f, w, x, b_dec, cut_sets = _matryoshka_inputs()
    iu = (1.0 / x.abs().max()).reshape(1)
    errs["grouped_prefix_base"] = max(_k7_case(f, w, x, b_dec, iu, p, what) for what, p in cut_sets.items())
    gouter = {}
    for what, p in cut_sets.items():
        m, r = _cuts(p)
        gouter[what] = proto_gouter.check(dict(f=f, w=w, x=x, b_dec=b_dec, inv_upper=iu, m=m, r=r))
    del f, w, x, b_dec
    torch.cuda.empty_cache()

    g_inp = proto_gouter.inputs()
    gouter["proto_gouter inputs"] = proto_gouter.check(g_inp)
    for what, res in gouter.items():
        log(f"parity P2 {what}: against K2 E rel-norm {res['e_rel_k2']:.3g} (mismatch frac "
            f"{res['e_mismatch_frac_k2']:.3g}), err_full rel-norm {res['err_rel_k2']:.3g}, loss rel "
            f"{res['loss_rel_k2']:.3g}; against plain E {res['e_rel']:.3g}, err_full {res['err_rel']:.3g}, "
            f"loss {res['loss_rel']:.3g}; bitwise repeatable")
    errs["grouped_prefix_err_gouter"] = max(res["max_abs"] for res in gouter.values())
    p2_out = proto_gouter.grouped_prefix_err_gouter(*(g_inp[k] for k in ("f", "w", "x", "b_dec", "inv_upper", "m", "r")))
    log(f"P2 sha256 of e, err_full, loss on proto_gouter's operands: {digests.output_digest(*p2_out)}")
    del p2_out
    k2_out = cm.grouped_prefix_err(*(g_inp[k] for k in ("f", "w", "x", "b_dec", "inv_upper", "m", "r")))
    log(f"K2 sha256 of e, xhat, loss on proto_gouter's operands: {digests.output_digest(*k2_out)}")
    del k2_out
    e_inp = proto_encode_stats.inputs()
    res = proto_encode_stats.check(e_inp)
    errs["encode_stats"] = res["h_max_abs"]
    log(f"parity P1 {B}x{D_MODEL} -> {D_SAE}, k {TOP_K}: h rel-norm {res['h_rel']:.3g}, max abs "
        f"{res['h_max_abs']:.3g}; kth, f, live ({res['n_live']}), l0 bitwise equal to K1 and to its plain "
        f"version on P1's own h, l1 within 1e-6; {res['exact_rows']} of {B} rows took the exact route")
    m_inp = microbench_kth.inputs()
    microbench_kth.check(m_inp)
    errs["count_loop"] = 0.0  # the counts are equal, or check raised
    log(f"parity P3 {B}x{D_SAE}, {list(microbench_kth.PASSES)} passes: counts equal to the plain version")
    p_inp = proto_kth_ops.inputs()
    n_rows = proto_kth_ops.check(p_inp)
    errs["kth_ops"] = 0.0  # bit for bit, or check raised
    log(f"parity P4 {B}x{D_SAE}, k {TOP_K}, and edge rows with k 32, 1, {D_SAE} and ragged "
        f"{proto_kth_ops.RAGGED} ({n_rows} rows): every mode bitwise equal to its plain version; "
        f"{', '.join(proto_kth_ops.EXACT)} bitwise equal to torch.topk and K6")
    _pass_sass()
    k_inp = kprof.inputs()
    k7_out = cm.grouped_prefix_base(k_inp["f"], k_inp["w"], k_inp["m"], k_inp["r"], group_size=GROUP)
    log(f"K7 sha256 of base, xhat on kprof's operands: {digests.output_digest(*k7_out)}")
    del k7_out
    torch.cuda.synchronize()

    reset_counts()
    runs = {f"kprof {k}": rows for k, rows in kprof.profile_kernels(k_inp, n=5, warmup=1).items()}
    runs |= proto_gouter.timing(g_inp, n=5, warmup=1)
    p1_runs = proto_encode_stats.ab(e_inp, n=5, warmup=1)
    runs |= p1_runs
    runs |= microbench_kth.passes(m_inp, n=5, warmup=1)
    runs |= proto_kth_ops.timing(p_inp, n=5, warmup=1)
    torch.cuda.synchronize()
    got = counts()
    for k in BENCH_KERNELS:
        require(got[k] > 0, f"benches: kernel {k} was never launched")
    for name, rows in runs.items():
        require(len(rows) > 0, f"benches: the profiler reported no device time for {name}")
        log("bench " + kprof.report(name, rows))
    log(f"benches: launches {got}")
    p1_rows = p1_runs["fused P1"]
    p1_dev = kprof.total_device_ms(p1_rows)
    log("bench P1 split by the profiler: " + ", ".join(f"{name} {ms:.4f} ms ({100 * ms / p1_dev:.1f}%)"
                                                        for name, ms, _ in p1_rows))
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        for line in select_probe.p1_phases(pathlib.Path(tmp)):
            log("bench " + line)

    times = {}
    kf, kw, km, kr = k_inp["f"], k_inp["w"], k_inp["m"], k_inp["r"]
    base, xhat = cm.grouped_prefix_base(kf, kw, km, kr, group_size=GROUP)
    times["grouped_prefix_base"] = timed(
        _time(lambda: cm.grouped_prefix_base(kf, kw, km, kr, group_size=GROUP), 10),
        _time(lambda: cm.grouped_prefix_base_plain(kf, kw, km, kr, group_size=GROUP), 2),
        bound((kf, kw, km, kr, base, xhat), 2 * int((kf != 0).sum()) * D_MODEL, BF16_OPS_S))
    del base, xhat
    g_args = tuple(g_inp[k] for k in ("f", "w", "x", "b_dec", "inv_upper", "m", "r"))
    g_out = proto_gouter.grouped_prefix_err_gouter(*g_args, group_size=GROUP)
    times["grouped_prefix_err_gouter"] = timed(
        _time(lambda: proto_gouter.grouped_prefix_err_gouter(*g_args, group_size=GROUP), 10),
        _time(lambda: proto_gouter.grouped_prefix_err_gouter_plain(*g_args, group_size=GROUP), 2),
        bound(g_args + g_out, 2 * int((g_inp["f"] != 0).sum()) * D_MODEL, BF16_OPS_S))
    del g_out
    ex, ewb, eb = e_inp["x"], e_inp["wb"], e_inp["b_enc"]
    e_h, e_stats = proto_encode_stats.encode_stats(ex, ewb, eb, TOP_K)
    times["encode_stats"] = timed(
        _time(lambda: proto_encode_stats.encode_stats(ex, ewb, eb, TOP_K), 10),
        _time(lambda: proto_encode_stats.encode_stats_plain(ex, ewb, eb, TOP_K), 3),
        bound((ex, ewb, eb, e_h, *e_stats), 2 * B * D_MODEL * D_SAE, BF16_OPS_S))
    del e_h, e_stats
    with torch.no_grad():  # the two calls P1 fuses, each on the same operands
        enc_ms = _time(lambda: modeling._linear_bias(ex, ewb, eb, "default"), 10)
        e_h = modeling._linear_bias(ex, ewb, eb, "default")
        k1_ms = _time(lambda: cuda_topk.topk_stats_cuda(e_h, TOP_K), 10)
    del e_h
    times["encode_stats"]["yardstick_ms"] = enc_ms + k1_ms
    log(f"timing P1 yardstick: bf16 encoder {enc_ms:.3f} ms + K1 on its h {k1_ms:.3f} ms = {enc_ms + k1_ms:.3f} ms; "
        f"P1 {times['encode_stats']['ms']:.3f} ms")
    key = m_inp["key"]
    times["count_loop"] = timed(_time(lambda: microbench_kth.count_loop(key, 32), 10),
                                _time(lambda: microbench_kth.count_loop_plain(key, 32), 3),
                                _selection_bound(key, microbench_kth.count_loop(key, 32)))
    ph = p_inp["h"]
    times["kth_ops"] = timed(_time(lambda: proto_kth_ops.kth_ops(ph, TOP_K, "prod"), 10),
                             _time(lambda: proto_kth_ops.kth_ops_plain(ph, TOP_K, "prod"), 3),
                             _selection_bound(ph, proto_kth_ops.kth_ops(ph, TOP_K, "prod")),
                             library_kth_ms(ph, TOP_K, "P4"))
    # The pass form's work: a compare and an add a key a pass.
    p4_ms = {mode: _time(lambda mode=mode: proto_kth_ops.kth_ops(ph, TOP_K, mode), 10)
             for mode in proto_kth_ops.MODES}
    log(f"timing kth_ops by mode {tuple(ph.shape)} k {TOP_K} (2 x 32 x B x S = {2 * 32 * ph.numel() / 1e9:.1f} G "
        f"compares and adds; subsar 31 passes): " + ", ".join(f"{m} {ms:.3f} ms" for m, ms in p4_ms.items()))
    p3_ms = {n: _time(lambda n=n: microbench_kth.count_loop(key, n), 10) for n in microbench_kth.PASSES}
    log(f"timing count_loop by passes {tuple(key.shape)}: "
        + ", ".join(f"{n} passes {ms:.3f} ms ({2 * n * key.numel() / 1e9:.1f} G compares and adds)"
                    for n, ms in p3_ms.items()))
    for k, row in times.items():
        log_timing(k, row)
    del k_inp, g_inp, e_inp, m_inp, p_inp
    torch.cuda.empty_cache()
    return got, errs, times


def phase_profile() -> None:
    """torch.profiler over 3 steps (after 3 warm-up steps) of the warm,
    tight-rung and dense steps at full width, n_sae 1, and of the warm and
    tight-rung steps at n_sae 2, 5% dead: wall and device ms/step, the
    device's idle share, the 15 kernels that take the most device time,
    among which K2's, K3's and K4's products must be, and the rank of each
    of their launches."""
    from torch.profiler import ProfilerActivity, profile

    from saev_tpu_torch.framework import train
    from saev_tpu_torch.nn import modeling, objectives

    cfg = modeling.SparseAutoencoderConfig(d_model=D_MODEL, d_sae=D_SAE, activation=modeling.TopK(top_k=TOP_K))
    obj = objectives.Matryoshka(n_prefixes=N_PREFIXES)
    rng = np.random.default_rng(SEED + 1)
    x = torch.from_numpy(rng.normal(size=(B, D_MODEL)).astype(np.float32)).to("cuda")
    prefixes = torch.from_numpy(
        np.stack([objectives.sample_prefixes(D_SAE, N_PREFIXES, rng=rng) for _ in range(2)])
    ).to("cuda")
    variants = {
        "warm": dict(aux_enabled=False),
        "tight": dict(aux_subspace_cap=TIGHT),
        "dense": {},
    }
    for n_sae, name in ((1, "warm"), (1, "tight"), (1, "dense"), (2, "warm"), (2, "tight")):
        step = train.make_train_step(cfg, obj, n_steps=6000, **variants[name])
        ts = train.init_sweep_state(cfg, n_sae, _gen(), "cuda")
        _pin_dead(ts, N_DEAD_5)
        hp = _steady_hp(n_sae)
        for _ in range(3):
            ts, _ = step(ts, x, prefixes[:n_sae], hp)
        torch.cuda.synchronize()
        for attempt in range(3):  # the profiler can miss a whole profile (kprof.device_profile): take it again
            if attempt:
                log(f"profile {name} n_sae={n_sae}: the profiler missed device time or K2's, K3's or K4's "
                    f"launches; taken again")
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(3):
                    ts, _ = step(ts, x, prefixes[:n_sae], hp)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / 3
            events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
            dev = sum(e.self_device_time_total for e in events) / 1e3 / 3
            if dev > 0 and all(any(k in e.key for e in events) for k in K2_NAMES + K3_NAMES + K4_NAMES):
                break
        if dev == 0:  # a measurement, not a check: report and go on
            log(f"profile {name} n_sae={n_sae}: wall {wall:.2f} ms/step; the profiler reported no device time")
            continue
        ranked = sorted(events, key=lambda e: -e.self_device_time_total)
        rank = {k: next((i + 1 for i, e in enumerate(ranked) if k in e.key), None)
                for k in K2_NAMES + K3_NAMES + K4_NAMES}
        lines = [f"profile {name} n_sae={n_sae}: wall {wall:.2f} ms/step, device kernels {dev:.2f} ms/step, "
                 f"idle {100 * (1 - dev / wall):.1f}%; K2's, K3's and K4's launches rank "
                 + ", ".join(f"{k} #{v}" for k, v in rank.items())]
        for e in ranked[:15]:
            ms = e.self_device_time_total / 1e3 / 3
            lines.append(f"  {ms:8.3f} ms/step {100 * ms / dev:5.1f}%  x{e.count // 3:<4d} {e.key[:110]}")
        log("\n".join(lines))
        require(all(rank.values()), f"profile {name} n_sae={n_sae}: K2's, K3's and K4's launches {rank}")
        require(all(rank[k] <= 15 for k in WGMMA_PRODUCTS),
                f"profile {name} n_sae={n_sae}: K2's, K3's and K4's products rank {rank}")
        del ts
        torch.cuda.empty_cache()


# The job phase: one training job of the port at the production width, from
# shards on disk: train 1024 x 256 content tokens (1 GiB of f32), val 128 x 256
# (128 MiB). Each row is a Gaussian combination of `active` of `rank` random
# directions (`signal`, its rms a coordinate) plus isotropic Gaussian noise
# (`noise`): sparse structure an SAE can learn, on which the datapoint init of
# this 16x-overcomplete TopK-32 dictionary starts below the mean baseline.
# (Rows of one dense rank-64 component plus unit noise start there too but
# leave the 12 steps nothing to learn; rank-64 rows with little noise start
# near normalized MSE 21.)
JOB = dict(batch=B, d_model=D_MODEL, d_sae=D_SAE, top_k=TOP_K, k_aux=K_AUX, n_prefixes=N_PREFIXES,
           tokens=256, train_examples=1024, val_examples=128, steps=12, val_batches=2, lrs=(4e-4, 1e-3),
           rank=16384, active=16, signal=1.0, noise=0.1)
JOB_KERNELS = WARM_KERNELS + ("kth_value_masked", "kth_value")


def _job_shards(root: pathlib.Path, n_examples: int, dims: dict, basis: torch.Tensor, seed: int) -> pathlib.Path:
    """A shard directory written with the port's ShardWriter, 128 examples a
    shard, its rows made on `basis`'s device from a seed."""
    from saev_tpu_torch.data import shards

    tokens, d_model = dims["tokens"], dims["d_model"]
    md = shards.Metadata(
        family="clip", ckpt="random", layers=(0,), content_tokens_per_example=tokens, cls_token=False,
        d_model=d_model, n_examples=n_examples, max_tokens_per_shard=tokens * 128, data="e30=", dataset=root,
    )
    md.dump(root)
    gen = torch.Generator(basis.device).manual_seed(seed)
    with shards.ShardWriter(root, md) as writer:
        for start in range(0, n_examples, 64):
            n = min(64, n_examples - start) * tokens
            codes = torch.randn((n, dims["active"]), generator=gen, device=basis.device)
            if dims["active"] < basis.shape[0]:  # each row on `active` of the basis rows
                idx = torch.randint(basis.shape[0], (n, dims["active"]), generator=gen, device=basis.device)
                codes = torch.zeros((n, basis.shape[0]), device=basis.device).scatter_(1, idx, codes)
            x = codes @ basis + dims["noise"] * torch.randn((n, d_model), generator=gen, device=basis.device)
            writer.write_batch(x.reshape(-1, 1, tokens, d_model).cpu().numpy(), start)
    return root / md.hash


def run_job(dims: dict, device: str, root: pathlib.Path) -> dict:
    """`worker_fn` on two configs that differ in lr (one cohort, n_sae 2) over
    shards written into `root`, with spies on the loop: the host time at
    which each step's batch arrives, the step variant the router picks, and
    eval's wall time. Then, in the same process, the loader alone over the
    train shards and the steady step variant alone on the job's final state.
    Returns what `phase_job` checks and reports. The CPU runs it too, at
    small `dims`."""
    import dataclasses
    import os

    from saev_tpu_torch import parallel
    from saev_tpu_torch.data import ShuffledConfig, ShuffledDataLoader, _native
    from saev_tpu_torch.framework import train
    from saev_tpu_torch.nn import modeling, objectives, serialize
    from saev_tpu_torch.utils import wandb as tracking

    shards_root, runs_root = root / "saev" / "shards", root / "saev" / "runs"
    shards_root.mkdir(parents=True)
    runs_root.mkdir(parents=True)
    t0 = time.perf_counter()
    gen = torch.Generator(device).manual_seed(SEED + 7)
    basis = torch.randn((dims["rank"], dims["d_model"]), generator=gen, device=device) * (
        dims["signal"] / dims["active"] ** 0.5)
    train_dir = _job_shards(shards_root, dims["train_examples"], dims, basis, SEED + 8)
    val_dir = _job_shards(shards_root, dims["val_examples"], dims, basis, SEED + 9)
    out = {"write_s": time.perf_counter() - t0, "route": _native.route(), "train_dir": train_dir,
           "val_dir": val_dir, "runs_root": runs_root}

    batch = dims["batch"]
    data = dict(layer=0, batch_size=batch)
    base = train.Config(
        train_data=ShuffledConfig(shards=train_dir, **data), val_data=ShuffledConfig(shards=val_dir, **data),
        n_train=dims["steps"] * batch, n_val=dims["val_batches"] * batch,
        sae=modeling.SparseAutoencoderConfig(
            d_model=dims["d_model"], d_sae=dims["d_sae"],
            activation=modeling.TopK(top_k=dims["top_k"], aux=modeling.AuxK(k_aux=dims["k_aux"])),
        ),
        objective=objectives.Matryoshka(n_prefixes=dims["n_prefixes"], dead_threshold_tokens=3 * batch),
        lr=dims["lrs"][0], n_lr_warmup=2, log_every=4, ckpt_every=4, track=True, runs_root=runs_root,
        device=device, seed=SEED,
    )
    cfgs = [base, dataclasses.replace(base, lr=dims["lrs"][1])]

    seen = {"stamps": [], "waits": [], "picks": []}
    real = {"train": train.train, "evaluate": train.evaluate, "prefetch": parallel.prefetch_to_device,
            "step_fn_at": train.StepRouter.step_fn_at, "wandb": tracking._WANDB}

    def spy_prefetch(*args, **kwargs):
        it = real["prefetch"](*args, **kwargs)
        while True:
            t = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            seen["stamps"].append(time.perf_counter())
            seen["waits"].append(seen["stamps"][-1] - t)
            yield item

    def spy_train(c):
        seen["train"] = real["train"](c)
        seen["train_stamps"], seen["train_waits"] = seen["stamps"], seen["waits"]
        seen["stamps"], seen["waits"] = [], []
        return seen["train"]

    def spy_evaluate(c, r):
        t = time.perf_counter()
        seen["eval"] = real["evaluate"](c, r)
        seen["eval_s"] = time.perf_counter() - t
        return seen["eval"]

    def spy_step_fn_at(self, global_step):
        fn = real["step_fn_at"](self, global_step)
        caps = {id(f): f"cap {c}" for c, f in self.step_fn_subs}
        seen["picks"].append("warm" if fn is self.step_fn_warm else caps.get(id(fn), "dense"))
        return fn

    cwd = os.getcwd()
    os.chdir(root)  # the local run recorder writes under ./.wandb
    train.train, train.evaluate, parallel.prefetch_to_device = spy_train, spy_evaluate, spy_prefetch
    train.StepRouter.step_fn_at = spy_step_fn_at
    tracking._WANDB = False  # the local JSONL recorder, never a network run
    try:
        with plain_spy() as plain:
            if device == "cuda":
                reset_counts()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            ids = train.worker_fn(cfgs)
            out["job_s"] = time.perf_counter() - t
            if device == "cuda":
                torch.cuda.synchronize()
                out["launches"] = counts()
                out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out["plain"] = dict(plain)
    finally:
        os.chdir(cwd)
        train.train, train.evaluate, parallel.prefetch_to_device = real["train"], real["evaluate"], real["prefetch"]
        train.StepRouter.step_fn_at = real["step_fn_at"]
        tracking._WANDB = real["wandb"]

    (rt,), _, steps = seen["train"]
    out |= {"ids": ids, "steps": steps, "picks": seen["picks"], "eval": seen["eval"],
            "eval_s_per_batch": seen["eval_s"] / dims["val_batches"]}
    # The loop's steady ms/step: the median time between two batches' arrival
    # at the step (log steps and checkpoint saves are the outliers).
    out["loop_ms"] = float(np.median(np.diff(seen["train_stamps"]))) * 1e3
    # Of it, the time the loop waits for its next batch: the loader, the copy
    # into pinned memory and the copy's launch (prefetch_to_device).
    out["wait_ms"] = float(np.median(seen["train_waits"][1:])) * 1e3
    out["mse_logs"], out["nmse_logs"] = {}, {}
    for run_id in ids:
        with open(root / ".wandb" / "saev" / run_id / "metrics.jsonl") as fd:
            rows = [r for r in map(json.loads, fd) if "loss/mse" in r]
        out["mse_logs"][run_id] = [r["loss/mse"] for r in rows]
        out["nmse_logs"][run_id] = [r["metrics/normalized_mse"] for r in rows]
    state_root = runs_root / ".train_state"
    out["ckpts"] = sorted(str(p.relative_to(state_root)) for p in state_root.glob("*/step_*"))

    # The loader alone: one epoch of the train shards.
    loader = ShuffledDataLoader(base.train_data)
    t, rows, first = time.perf_counter(), 0, None
    try:
        for b in loader:
            rows += len(b["act"])
            first = first or time.perf_counter()
            last = b
    finally:
        loader.shutdown()
    end = time.perf_counter()
    out["loader_rows_s"] = rows / (end - t)
    out["loader_rows_s_after_first"] = (rows - batch) / (end - first)
    x = torch.from_numpy(last["act"]).to(device)

    # Each SAE file against the in-memory params, and its forward.
    out["files_bitwise"] = []
    for si, run_id in enumerate(ids):
        _, params, state = serialize.load(runs_root / run_id / "checkpoint" / "sae.pt", device=device)
        mine = {k: v[si] for k, v in rt.ts.params.items()}
        with torch.no_grad():
            a, _ = modeling.forward(base.sae, params, state, x[:1024])
            b, _ = modeling.forward(base.sae, mine, state, x[:1024])
        out["files_bitwise"].append(
            all(same_bits(params[k], mine[k]) for k in mine) and all(same_bits(u, v) for u, v in zip(a, b))
        )

    # The step alone at n_sae 2: the variant of the loop's last step, on its state.
    variant = seen["picks"][-1]
    subs = {f"cap {c}": f for c, f in rt.router.step_fn_subs}
    fn = subs.get(variant) or (rt.router.step_fn_warm if variant == "warm" else rt.router.step_fn)
    prefixes = torch.from_numpy(np.stack([
        objectives.sample_prefixes(dims["d_sae"], dims["n_prefixes"], rng=np.random.default_rng(SEED + s))
        for s in range(2)
    ])).to(device)
    state = [rt.ts]

    def one():
        state[0], _ = fn(state[0], x, prefixes, rt.hp)

    out["step_variant"] = variant
    if device == "cuda":
        one()
        out["step_ms"] = _time(one, 5)
        # Eval's parts: one SAE's forward on the card (CUDA events), and the
        # host's float64 sums of a batch.
        c0 = rt.cohort.cfgs[0]
        args = [{k: v[0] for k, v in tree.items()} for tree in (rt.ts.params, rt.ts.sae_state, rt.ts.obj_state)]
        out["eval_forward_ms"] = _time(lambda: train._eval_one(c0, *args, x, prefixes[0]), 3)
    t = time.perf_counter()
    x64 = last["act"].astype(np.float64)
    float(np.sum(x64 * x64)), x64.sum(axis=0)
    out["eval_host_ms"] = (time.perf_counter() - t) * 1e3
    return out


def phase_job(root: pathlib.Path) -> dict:
    """One training job through `worker_fn` at the production width (batch
    16384, d_model 1024, d_sae 16384, TopK 32, AuxK 512, Matryoshka 10, Adam
    at "default"), n_sae 2 (lr 4e-4 and 1e-3), 12 steps with AuxK from step 2
    on, eval on 2 validation batches, checkpoints every 4 steps, logs every
    4. Requires K1-K6 launched and no plain version run, the log step's
    normalized MSE (metrics/normalized_mse) down from the first log to the
    last, eval L0 32 (a row with a tie at the 32nd value
    keeps both: at most one row in a thousand) and normalized MSE finite and
    below 1, the SAE files bit for bit the trained params (and their forwards), the
    step 12 checkpoint alone left. Logs the loop's steady ms/step beside the
    step alone, the loader's rows/s, eval's seconds a batch and the job's
    peak memory. Returns the job's output (`run_job`); its shards and runs
    stay in `root` for the inference phase."""
    out = run_job(JOB, "cuda", root)
    log(f"job: shard I/O route {out['route']}; shards written in {out['write_s']:.2f} s; worker_fn "
        f"{out['job_s']:.2f} s; {out['steps']} steps, variants {out['picks']}")
    log(f"job: launches {out['launches']}")
    require(not out["plain"], f"job: plain versions ran on the card: {out['plain']}")
    for k in JOB_KERNELS:
        require(out["launches"][k] > 0, f"job: kernel {k} was never launched")
    require(out["steps"] == JOB["steps"], f"job: {out['steps']} steps")
    for run_id, mses in out["mse_logs"].items():
        nmses = out["nmse_logs"][run_id]
        log(f"job: {run_id} at the logs: loss/mse {mses}, metrics/normalized_mse {nmses}")
        # The learning check reads the log step's full reconstruction of its
        # batch: loss/mse averages 10 sampled prefixes, mostly a few latents
        # long, and moved 2-3% between logs with the draw, above what 8
        # steps teach (PERF.md §6, PR 14).
        require(len(nmses) == 3 and nmses[-1] < nmses[0], f"job: {run_id}'s normalized MSE did not fall: {nmses}")
    n_rows = JOB["val_batches"] * JOB["batch"]
    for m in out["eval"]:
        # TopK keeps every value at or above the k-th largest, as the JAX
        # package does: a row whose k-th value ties the next keeps both. On
        # continuous f32 rows a tie is rare (about one row in 16k here).
        ties = round((m.l0 - JOB["top_k"]) * n_rows)
        log(f"job: eval l0 {m.l0} ({ties} of {n_rows} rows with a tie at the k-th value), "
            f"l1 {m.l1:.4f}, mse {m.mse:.6f}, normalized_mse {m.normalized_mse:.6f}, "
            f"n_dead {m.n_dead}, n_almost_dead {m.n_almost_dead}, n_dense {m.n_dense}")
        require(JOB["top_k"] <= m.l0 <= JOB["top_k"] + 1e-3, f"job: eval L0 {m.l0}")
        require(np.isfinite(m.normalized_mse) and m.normalized_mse < 1, f"job: normalized MSE {m.normalized_mse}")
    require(all(out["files_bitwise"]), f"job: SAE files against the trained params {out['files_bitwise']}")
    want = [f"{p.split('/')[0]}/step_{JOB['steps']:08d}" for p in out["ckpts"]]
    require(len(out["ckpts"]) == 1 and out["ckpts"] == want, f"job: step checkpoints {out['ckpts']}")
    log(f"job: loop {out['loop_ms']:.2f} ms/step steady (median; of it waiting for the batch {out['wait_ms']:.2f}) "
        f"beside the step alone ({out['step_variant']}) {out['step_ms']:.2f} ms/step at n_sae 2; loader "
        f"{out['loader_rows_s']:.0f} rows/s over an epoch ({out['loader_rows_s_after_first']:.0f} after its first "
        f"batch); eval {out['eval_s_per_batch']:.3f} s/batch (2 SAEs; one SAE's forward on the card "
        f"{out['eval_forward_ms']:.2f} ms, the host's f64 sums of a batch {out['eval_host_ms']:.2f} ms); "
        f"peak memory {out['peak_gib']:.2f} GiB")
    return out


INFER_KERNELS = ("kth_value",)


def _one_batch_csr(run_dir: pathlib.Path, shards_dir: pathlib.Path, token_acts) -> str:
    """The first batch of `shards_dir` through `infer_batch` on the card, its
    dense f copied whole to the host and made a `scipy.sparse.csr_array`,
    against rows [0, B) of the token_acts that worker_fn wrote: indptr and
    indices (and their dtypes) equal, the values bit for bit."""
    import scipy.sparse

    from saev_tpu_torch import disk
    from saev_tpu_torch.data import OrderedConfig, OrderedDataLoader
    from saev_tpu_torch.framework import inference
    from saev_tpu_torch.nn import serialize

    sae_cfg, params, state = serialize.load(disk.Run(run_dir).ckpt, device="cuda")
    loader = OrderedDataLoader(OrderedConfig(shards=shards_dir, layer=0, batch_size=B))
    try:
        batch = next(iter(loader))
    finally:
        loader.shutdown()
    x = torch.from_numpy(batch["act"]).cuda()
    f, _ = inference.infer_batch(sae_cfg, params, state, x, torch.ones(B, dtype=torch.bool, device="cuda"))
    want = scipy.sparse.csr_array(f.cpu().numpy())
    nnz = int(token_acts.indptr[B])
    got = {"indptr": token_acts.indptr[:B + 1], "indices": token_acts.indices[:nnz]}
    for name, a in got.items():
        w = getattr(want, name)
        require(a.dtype == w.dtype and np.array_equal(a, w), f"inference: token_acts' {name} is not scipy's "
                f"({a.dtype}, {w.dtype})")
    require(np.array_equal(token_acts.data[:nnz].view(np.int32), want.data.view(np.int32)),
            "inference: token_acts' values are not the dense f's")
    return f"{want.nnz} nonzeros, {int((want.data < 0).sum())} of them negative"


def phase_inference(root: pathlib.Path, job: dict) -> dict:
    """`framework.inference.worker_fn` on the job's two SAE files (TopK 32),
    over the val shards (whose whole set the job's eval read) and then the
    train shards (module doc, phase 12). Returns the path's launches."""
    import scipy.sparse

    from saev_tpu_torch import disk
    from saev_tpu_torch.data import Metadata, OrderedConfig
    from saev_tpu_torch.framework import inference

    launches = dict.fromkeys(KERNELS, 0)
    for si, run_id in enumerate(job["ids"]):
        run_dir = job["runs_root"] / run_id
        for split, shards_dir in (("val", job["val_dir"]), ("train", job["train_dir"])):
            cfg = inference.Config(run=run_dir, data=OrderedConfig(shards=shards_dir, layer=0, batch_size=B))
            reset_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with plain_spy() as plain:
                out = inference.worker_fn(cfg)
                torch.cuda.synchronize()
            got = counts()
            peak = torch.cuda.max_memory_allocated() / 2**30
            require(not plain, f"inference {split}: plain versions ran on the card: {plain}")
            want = dict.fromkeys(KERNELS, 0) | {"kth_value": out["batches"]}
            require(got == want, f"inference {split}: launches {got}, expected {want}")
            for k in KERNELS:
                launches[k] += got[k]
            fpaths = inference.Filepaths.from_run(disk.Run(run_dir), Metadata.load(shards_dir))
            require(all(p.exists() for p in fpaths), f"inference {split}: files {[p.exists() for p in fpaths]}")
            mtimes = [p.stat().st_mtime_ns for p in fpaths]
            require(inference.worker_fn(cfg) is None and [p.stat().st_mtime_ns for p in fpaths] == mtimes,
                    f"inference {split}: a second call wrote files")
            token_acts = scipy.sparse.load_npz(fpaths.token_acts)
            nnz_row = token_acts.nnz / token_acts.shape[0]
            require(token_acts.shape == (out["tokens"], JOB["d_sae"]) and
                    JOB["top_k"] <= nnz_row <= JOB["top_k"] + 1e-3, f"inference {split}: token_acts "
                    f"{token_acts.shape}, mean nnz a row {nnz_row}")
            csr = _one_batch_csr(run_dir, shards_dir, token_acts) if si == 0 and split == "val" else ""
            metrics = json.loads(fpaths.metrics.read_text())
            n = out["batches"]
            log(f"inference {run_id} {split}: {n} batches, {out['tokens']} tokens in {out['seconds']:.2f} s, "
                f"{out['tokens_per_s']:.0f} tokens/s; a batch {out['seconds'] / n:.4f} s: loader wait "
                f"{out['wait_s'] / n:.4f}, forward {out['forward_s'] / n:.4f}, compaction {out['compact_s'] / n:.4f}, "
                f"host assembly {out['host_s'] / n:.4f}; then the files {out['write_s']:.2f} s; peak {peak:.2f} GiB; "
                f"token_acts {token_acts.nnz} nonzeros "
                f"({nnz_row:.6f} a row, {token_acts.indices.dtype}), normalized_mse {metrics['normalized_mse']:.6f}"
                + (f"; batch 0's CSR equals scipy's of the dense f ({csr})" if csr else ""))
            if split != "val":
                continue
            # The job's eval read the same rows, shuffled, through the decode path.
            ev = job["eval"][si]
            load = lambda p: torch.load(p, weights_only=True).double().numpy()  # noqa: E731
            sparsity, mean_values = load(fpaths.sparsity), load(fpaths.mean_values)
            fin = np.isfinite(ev.mean_values)
            require(np.array_equal(np.isfinite(mean_values), fin), f"inference {run_id}: mean_values finite where "
                    "the eval's are not")
            rel_s = float(np.max(np.abs(sparsity - ev.freqs) / np.maximum(np.abs(ev.freqs), 1e-30)))
            rel_m = float(np.max(np.abs(mean_values[fin] - ev.mean_values[fin]) / np.abs(ev.mean_values[fin])))
            rel_n = abs(metrics["normalized_mse"] - ev.normalized_mse) / ev.normalized_mse
            require(rel_s <= 1e-4 and rel_m <= 1e-4 and rel_n <= 1e-4, f"inference {run_id}: against the job's eval "
                    f"sparsity rel {rel_s:.3g}, mean_values rel {rel_m:.3g}, normalized_mse rel {rel_n:.3g} > 1e-4")
            log(f"inference {run_id} val against the job's eval: sparsity max rel {rel_s:.3g}, mean_values max rel "
                f"{rel_m:.3g} ({int(fin.sum())} finite), normalized_mse {metrics['normalized_mse']:.8f} against "
                f"{ev.normalized_mse:.8f} (rel {rel_n:.3g})")
    return launches


# The interpret phase (module doc, phase 13): the inference example and
# Grad-CAM on CLIP ViT-L/14 from a random OpenCLIP checkpoint, the job's SAE
# files at its layer -2 (d_model 1024), one synthetic image.
INTERP_KERNELS = ("kth_value",)
INTERP_K = 5  # latents the example draws ("max")
INTERP_REL_MSE = 1e-4  # f_x on the card against the CPU's f32 SAE forward: ROADMAP's "highest" gate
# The tap gradient at "default" (bf16 products, forward and backward) against
# "highest" from the same tap, one block and the final norm after layer 22:
# the CPU model of the route gave 2.1e-3 and 2.8e-3 at this width
# (tests/test_torch_interpret.py holds the small spec to the same bound).
GRADCAM_REL = 2e-2
GRADCAM_METHODS = ("gradcam", "gradcam++", "eigencam")


def _interp_image(path: pathlib.Path) -> None:
    """A 300 x 260 RGB image drawn with numpy: a color gradient, three discs
    and noise, saved as a PNG."""
    from PIL import Image

    rng = np.random.default_rng(SEED + 31)
    h, w = 260, 300
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    img = np.stack([xx / w, yy / h, 0.5 + 0.5 * np.sin(xx / 17 + yy / 23)], axis=-1) * 200
    for cy, cx, r, col in ((80, 90, 40, (250, 40, 40)), (170, 200, 55, (30, 220, 60)), (60, 230, 25, (40, 60, 250))):
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = col
    img += rng.normal(scale=8, size=img.shape)
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(path)


@contextlib.contextmanager
def _interp_spies(seen: dict):
    """CUDA events around each call, while inside, of the example's ViT step
    (`Recorder.__call__`: the tokens' upload, the forward, the taps' copy to
    the host), its SAE forward (`sae_forward`) and its compositing
    (`save_heatmaps`, host work: the events, on an idle stream, read its wall
    time). Each call appends its ms to seen[name]."""
    from saev_tpu_torch.data import models
    from saev_tpu_torch.examples import inference as example

    real = {"vit": (models.Recorder, "__call__"), "sae": (example, "sae_forward"),
            "composite": (example, "save_heatmaps")}
    saved = {name: getattr(owner, attr) for name, (owner, attr) in real.items()}

    def timed_call(name):
        def call(*a, **kw):
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0.record()
            out = saved[name](*a, **kw)
            t1.record()
            t1.synchronize()
            seen.setdefault(name, []).append(t0.elapsed_time(t1))
            return out

        return call

    for name, (owner, attr) in real.items():
        setattr(owner, attr, timed_call(name))
    try:
        yield seen
    finally:
        for name, (owner, attr) in real.items():
            setattr(owner, attr, saved[name])


@contextlib.contextmanager
def _k6_plain():
    """While inside, K6's wrapper takes its plain version on a card tensor."""
    from saev_tpu_torch.ops import cuda_kth, topk

    real = cuda_kth.kth_value_cuda
    cuda_kth.kth_value_cuda = lambda h, k, fallback=None: topk._kth_plain(h, min(k, h.shape[-1]))
    try:
        yield
    finally:
        cuda_kth.kth_value_cuda = real


def _mm_out_dtype_backward() -> str:
    """Whether torch.mm(..., out_dtype=torch.float32) on bf16 operands has a
    derivative on this torch (the ViT's bf16 products took it before they
    went through `modeling._Matmul`)."""
    a = torch.randn(64, 64, device="cuda").to(torch.bfloat16).requires_grad_()
    b = torch.randn(64, 64, device="cuda").to(torch.bfloat16)
    try:
        torch.mm(a, b, out_dtype=torch.float32).sum().backward()
    except (RuntimeError, NotImplementedError) as err:
        return f"has no derivative ({str(err).splitlines()[0]})"
    return "has a derivative"


def phase_interpret(job: dict) -> dict:
    """The interpretation layer on the card (module doc, phase 13). Returns
    the path's launches (the example's run, then its demo), and K6's
    timing at the example's shape."""
    import importlib.util

    have = {m: importlib.util.find_spec(m) is not None for m in ("PIL", "matplotlib", "sklearn", "pandas")}
    log(f"interpret environment: Pillow importable {have['PIL']}, matplotlib {have['matplotlib']}, "
        f"scikit-learn {have['sklearn']}, pandas {have['pandas']}; the phase needs Pillow only")
    if not have["PIL"]:
        raise RuntimeError("interpret: Pillow (PIL) is not importable here; the example and Grad-CAM read and "
                           "write images with it")
    from PIL import Image

    from saev_tpu_torch.examples import inference as example
    from saev_tpu_torch.models import families, vit
    from saev_tpu_torch.nn import modeling, serialize
    from saev_tpu_torch.ops import cuda_kth, topk
    from saev_tpu_torch.scripts import gradcam, vit_route

    launches = dict.fromkeys(KERNELS, 0)
    out = {}
    t_phase = time.perf_counter()
    root = pathlib.Path(tempfile.mkdtemp(prefix="saev_interpret_"))
    try:
        preset = families.CLIP_PRESETS["ViT-L-14"]
        t0 = time.perf_counter()
        torch.save(vit_route.openclip_state_dict(preset.spec, torch.Generator().manual_seed(SEED + 30), 257),
                   root / "ViT-L-14.pt")
        ckpt = f"ViT-L-14={root / 'ViT-L-14.pt'}"
        image = root / "image.png"
        _interp_image(image)
        sae_file = job["runs_root"] / job["ids"][0] / "checkpoint" / "sae.pt"
        log(f"interpret: a random OpenCLIP ViT-L/14 checkpoint written in {time.perf_counter() - t0:.1f} s; the SAE "
            f"{sae_file.parent.parent.name} (d_model {JOB['d_model']}, d_sae {JOB['d_sae']}, TopK {JOB['top_k']})")

        # 1. The example's run, the main path: K6 once, no plain version.
        cfg = example.RunConfig(sae_ckpt=sae_file, family="clip", ckpt=ckpt, layer=-2, content_tokens=256,
                                image=image, k=INTERP_K, select="max", out=root / "heatmaps")
        seen = {}
        reset_counts()
        torch.cuda.synchronize()
        with plain_spy() as plain, _interp_spies(seen):
            t0 = time.perf_counter()
            res = example.run(cfg)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        got = counts()
        require(not plain, f"interpret run: plain versions ran on the card: {plain}")
        want = dict.fromkeys(KERNELS, 0) | {"kth_value": 1}
        require(got == want, f"interpret run: launches {got}, expected {want}")
        launches = {k: launches[k] + got[k] for k in KERNELS}
        f_x, patch_acts = res["f_x"], res["patch_acts"]
        nnz = (f_x != 0).sum(axis=1)
        require(f_x.shape == (256, JOB["d_sae"]) and bool(np.isfinite(f_x).all()) and (nnz >= JOB["top_k"]).all(),
                f"interpret run: f_x {f_x.shape}, nonzeros a row {nnz.min()}-{nnz.max()}")
        require(len(res["paths"]) == INTERP_K and all(Image.open(p).size == (224, 224) for p in res["paths"]),
                f"interpret run: heatmaps {[p.name for p in res['paths']]}")
        filtered = example.select_top_latents_filtered(f_x, k=INTERP_K)
        log(f"interpret run: {run_s:.2f} s with the ViT's and the SAE's loads; latents by max "
            f"{res['latents'].tolist()}, by filtered {filtered.tolist()}; {len(res['paths'])} heatmaps; f_x "
            f"{nnz.min()}-{nnz.max()} nonzeros a row; K6 launched once, no plain version")

        # f_x against the same forward with K6's plain version on the card,
        # and against the CPU's f32 forward.
        sae_cfg, params, state = serialize.load(sae_file, device="cuda")
        with _k6_plain():
            f_plain, _ = example.sae_forward(sae_cfg, params, state, patch_acts)
        require(same_bits(torch.from_numpy(f_x), torch.from_numpy(f_plain)),
                "interpret: f_x differs from the forward with K6's plain version")
        cpu = serialize.load(sae_file, device="cpu")
        f_cpu, _ = example.sae_forward(*cpu, patch_acts)
        x = torch.from_numpy(patch_acts).cuda()
        h = modeling._linear_bias(x, params["W_enc"], params["b_enc"], "highest")
        with torch.no_grad():
            h_cpu = modeling._linear_bias(torch.from_numpy(patch_acts), cpu[1]["W_enc"], cpu[1]["b_enc"], "highest")
        cmp = topk_vs_cpu(f_x, h.cpu(), f_cpu, h_cpu)
        require_topk_agrees("interpret", cmp, INTERP_REL_MSE)
        log(f"interpret: f_x bit for bit the forward with K6's plain version on the card; "
            f"{topk_note(cmp, INTERP_REL_MSE)}")

        # Cold (the run above) and warm (a second run) times of its parts.
        with _interp_spies(seen):
            example.run(dataclasses.replace(cfg, out=root / "heatmaps2"))
        out["example_ms"] = {k: v for k, v in seen.items()}
        log("interpret run, CUDA events, cold then warm: " + "; ".join(
            f"{k} {v[0]:.2f} then {v[1]:.2f} ms" for k, v in seen.items())
            + " (vit: the Recorder call, upload, forward and the taps' copy to the host; composite: host work, "
              f"{INTERP_K} heatmaps)")

        # K6 at the example's shape: 256 rows x 16384, k 32.
        kth = cuda_kth.kth_value_cuda(h, JOB["top_k"])
        row = timed(_time(lambda: cuda_kth.kth_value_cuda(h, JOB["top_k"]), 50),
                    _time(lambda: topk._kth_plain(h, JOB["top_k"]), 10), _selection_bound(h, kth),
                    library_kth_ms(h, JOB["top_k"], "the example's h"))
        log_timing("kth_value", row, f" at the example's {tuple(h.shape)}, k {JOB['top_k']}")
        out["kth_value"] = row
        del x, h, kth, params, state, cpu
        torch.cuda.empty_cache()

        # 2. Grad-CAM's run, all three methods at "default": no saev kernel.
        log(f"interpret: torch.mm(..., out_dtype=torch.float32) {_mm_out_dtype_backward()} on torch "
            f"{torch.__version__}; the ViT's bf16 products go through modeling._Matmul")
        for method in GRADCAM_METHODS:
            reset_counts()
            t0 = time.perf_counter()
            cam = gradcam.run(gradcam.Args(family="clip", ckpt=ckpt, image_path=image, layer=-2, content_tokens=256,
                                           method=method, out=root / f"cam_{method}.png"))
            torch.cuda.synchronize()
            cam_s = time.perf_counter() - t0
            got = counts()
            require(not any(got.values()), f"interpret gradcam {method}: saev kernels launched {got}")
            g = cam["grads"]
            require(bool(np.isfinite(g).all()) and float(np.abs(g).max()) > 0 and cam["cam"].shape == (256,)
                    and Image.open(root / f"cam_{method}.png").size == (224, 224),
                    f"interpret gradcam {method}: grads finite {bool(np.isfinite(g).all())}, max |g| "
                    f"{float(np.abs(g).max())}, cam {cam['cam'].shape}")
            log(f"interpret gradcam {method}: score {cam['score']:.4f}, |grad| max {float(np.abs(g).max()):.3g}, "
                f"cam nonzero on {int((cam['cam'] > 0).sum())} of 256 patches; {cam_s:.2f} s with the ViT's load")

        # The tap gradient at "default" against "highest": from the same tap,
        # and each from its own tap; then times of the three parts.
        model = families.Clip(ckpt)
        spec, vparams, grid = model.spec, model.params, model.preset.grid
        img_tr, _ = families.Clip.make_transforms(ckpt, 256)
        tokens = torch.from_numpy(np.asarray(img_tr(Image.open(image)))[None]).cuda()
        layer = -2 % spec.n_layers
        grads = {}
        for tap_p in ("default", "highest"):
            taps = gradcam.tap(spec, vparams, tokens, layer, grid, tap_p)
            for p in ("default", "highest"):
                (grads[tap_p, p],) = torch.autograd.grad(gradcam.score(spec, vparams, taps, layer, grid, -1, p), taps)
        same = rel_norm(grads["default", "default"], grads["default", "highest"])
        own = rel_norm(grads["default", "default"], grads["highest", "highest"])
        require(same <= GRADCAM_REL, f"interpret gradcam: the tap gradient at default is {same:.3g} from highest's "
                f"from the same tap (bound {GRADCAM_REL})")
        parts = {"forward": [], "forward_from": [], "backward": []}
        for _ in range(3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            torch.cuda.synchronize()
            ev[0].record()
            taps = gradcam.tap(spec, vparams, tokens, layer, grid)
            ev[1].record()
            s = gradcam.score(spec, vparams, taps, layer, grid, -1)
            ev[2].record()
            torch.autograd.grad(s, taps)
            ev[3].record()
            torch.cuda.synchronize()
            for i, name in enumerate(parts):
                parts[name].append(ev[i].elapsed_time(ev[i + 1]))
        out["gradcam_ms"] = parts
        with torch.no_grad():
            fwd = lambda: vit.forward(spec, vparams, tokens, (layer,), grid=grid)  # noqa: E731
            route_ms = _time(fwd, 5)
            with _dense_before():
                before_ms = _time(fwd, 5)
        log(f"interpret gradcam: the tap gradient at default against highest, rel-norm {same:.3g} from the same tap "
            f"(bound {GRADCAM_REL}), {own:.3g} each from its own tap; CUDA events, first then median of 3: "
            + "; ".join(f"{k} {v[0]:.2f} then {statistics.median(v):.2f} ms" for k, v in parts.items())
            + f" (forward: embedding and {layer + 1} blocks to the tap; forward_from: "
              f"{spec.n_layers - layer - 1} block and the final norm; backward: through it); the forward alone, "
              f"mean of 5: {route_ms:.2f} ms, {before_ms:.2f} by the route before modeling._Matmul")
        del model, vparams, tokens, taps, grads
        torch.cuda.empty_cache()

        # 3. The example's demo on the card: the fake backend's extraction
        # and a d_sae 64 SAE's forward (K6).
        reset_counts()
        with plain_spy() as plain:
            paths = example.demo(example.DemoConfig(out=root / "demo"))
            torch.cuda.synchronize()
        got = counts()
        require(not plain and len(paths) == 3 and all(p.exists() for p in paths),
                f"interpret demo: {len(paths)} heatmaps, plain versions {plain}")
        require(got == dict.fromkeys(KERNELS, 0) | {"kth_value": 1}, f"interpret demo: launches {got}")
        launches = {k: launches[k] + got[k] for k in KERNELS}
        log(f"interpret demo on the card: {len(paths)} heatmaps, K6 launched once, no plain version; the phase "
            f"{time.perf_counter() - t_phase:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = launches
    return out


def _activations_parity(errs: dict) -> None:
    """K2-K4 against their plain versions on a Relu layer's latents at the
    production shape: relu(x @ W + b), about half of them nonzero, in bf16
    as the kernel path casts them, on the sampled cuts."""
    from saev_tpu_torch.nn import objectives

    f, w, x, b_dec = _grouped_operands()
    g = _gen()
    w_enc = torch.randn((D_MODEL, D_SAE), generator=g, device="cuda") / 32
    f = torch.relu(x @ w_enc).to(torch.bfloat16)
    del w_enc
    dense = float((f != 0).float().mean())
    require(0.4 <= dense <= 0.6, f"activations: the Relu latents are {dense:.3f} nonzero")
    iu = (1.0 / x.abs().max().clamp_min(1e-12)).reshape(1)
    p = objectives.sample_prefixes(D_SAE, N_PREFIXES, rng=np.random.default_rng(SEED + 3))
    _grouped_cases(f, w, x, b_dec, iu, p, f"Relu latents ({dense:.3f} nonzero) cuts {p.tolist()}", errs,
                   df_dtype=torch.float32)
    del f, w, x, b_dec
    torch.cuda.empty_cache()


ACTIVATION_RUNS = (
    ("BatchTopK", {"momentum": (0.1, 0.3)}, D_SAE // 16, WARM_KERNELS[1:] + ("kth_value_masked",)),
    ("Relu", {"sparsity_coeff": (4e-4, 1e-3)}, 0, WARM_KERNELS[1:]),
)


def phase_activations(errs: dict) -> dict:
    """Relu and BatchTopK at full width (module doc, phase 14). Returns the
    path's launches."""
    from saev_tpu_torch.framework import train
    from saev_tpu_torch.nn import modeling, objectives
    from saev_tpu_torch.ops import topk

    _activations_parity(errs)
    obj = objectives.Matryoshka(n_prefixes=N_PREFIXES)
    rng = np.random.default_rng(SEED + 4)
    xs = [torch.from_numpy(rng.normal(size=(B, D_MODEL)).astype(np.float32)).to("cuda") for _ in range(2)]
    prefixes = torch.from_numpy(
        np.stack([objectives.sample_prefixes(D_SAE, N_PREFIXES, rng=rng) for _ in range(2)])).to("cuda")
    launches = dict.fromkeys(KERNELS, 0)
    for what, over, n_dead, kernels in ACTIVATION_RUNS:
        act = (modeling.BatchTopK(top_k=TOP_K, aux=modeling.AuxK(k_aux=K_AUX)) if what == "BatchTopK"
               else modeling.Relu())
        cfg = modeling.SparseAutoencoderConfig(d_model=D_MODEL, d_sae=D_SAE, activation=act)
        step = train.make_train_step(cfg, obj, n_steps=6000, aux_subspace_cap=TIGHT if n_dead else None)
        ts = train.init_sweep_state(cfg, 2, _gen(), "cuda")
        _pin_dead(ts, n_dead)
        hp = _hp(2, "cuda") | {k: torch.tensor(v, device="cuda") for k, v in over.items()}
        # The step's f, read by a spy on BatchTopK's activation on the first
        # and the last step (outside the timed ones): its least positive kept
        # value, and the first SAE's pre-activations for timing.
        seen, seen_h, real = [], [], modeling.batch_topk_train

        def spy(h, k, momentum, threshold, group=None, feature=None, *, real=real, seen=seen, seen_h=seen_h):
            f, new = real(h, k, momentum, threshold, group, feature)
            fd = f.detach()
            seen.append((fd[fd > 0].min(), threshold, momentum, new))
            if not seen_h:
                seen_h.append(h.detach().clone())
            return f, new

        times, thr_errs = [], []
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with plain_spy() as plain:
            for i in range(5):
                checked = what == "BatchTopK" and i in (0, 4)
                before = counts()
                seen.clear()
                modeling.batch_topk_train = spy if checked else real
                try:
                    t0 = time.perf_counter()
                    ts, stats = step(ts, xs[i % 2], prefixes, hp)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                finally:
                    modeling.batch_topk_train = real
                rose = {k: v - before[k] for k, v in counts().items()}
                want = dict.fromkeys(KERNELS, 0) | dict.fromkeys(kernels, 2)
                require(rose == want, f"activations {what} step {i}: launches {rose}, expected {want}")
                for key, v in stats.items():
                    require(bool(torch.isfinite(v.float()).all()), f"activations {what}: stat {key} not finite: {v}")
                if what != "BatchTopK":
                    continue
                l0 = stats["l0"].tolist()
                require(all(TOP_K <= v <= TOP_K + 4 / B for v in l0), f"activations BatchTopK: mean L0 {l0}")
                require(stats["n_dead"].tolist() == [n_dead] * 2 and bool((stats["aux"] > 0).all()),
                        f"activations BatchTopK: n_dead {stats['n_dead'].tolist()}, aux {stats['aux'].tolist()}")
                if not checked:
                    continue
                new = ts.sae_state["threshold"].tolist()
                require(len(seen) == 2, f"activations BatchTopK: {len(seen)} activations seen in a step")
                for si, (pos, old, m, got) in enumerate(seen):
                    pos, old, m, got = (np.float32(float(t)) for t in (pos, old, m, got))
                    want_thr = float((np.float32(1.0) - m) * old + m * pos)
                    err = abs(new[si] - want_thr) / want_thr
                    require(float(got) == new[si] and err <= 1e-6, f"activations BatchTopK step {i} SAE {si}: "
                            f"threshold {new[si]} (activation {float(got)}), recomputed {want_thr}")
                    thr_errs.append(err)
        require(not plain, f"activations {what}: plain versions ran on the card: {plain}")
        for key, v in ts.params.items():
            require(bool(torch.isfinite(v).all()), f"activations {what}: param {key} not finite")
        got = counts()
        for k in KERNELS:
            launches[k] += got[k]
        peak = torch.cuda.max_memory_allocated() / 2**30
        ms = statistics.median(times[1:4])
        extra = ""
        if seen_h:
            h = seen_h[0]
            kth_ms = _time(lambda: topk.batch_global_kth_value(h, TOP_K * B), 5)
            row_ms = _time(lambda: torch.topk(h, 4 * TOP_K, dim=1, sorted=False), 5)
            extra = (f"; threshold {ts.sae_state['threshold'].tolist()} (recomputed from the step's f, max rel "
                     f"{max(thr_errs):.3g}); batch-global k-th value {kth_ms:.3f} ms on {tuple(h.shape)}, k_total "
                     f"{TOP_K * B} (of it the per-row candidates' torch.topk {row_ms:.3f} ms)")
            del h
            seen_h.clear()
        log(f"activations {what} n_sae=2: 5 steps, ms {[round(t, 2) for t in times]}, median of steps 1-3 {ms:.2f} "
            f"ms/step ({B / (ms / 1e3):.1f} patches/s), peak {peak:.2f} GiB, last mse {stats['mse'].tolist()}, "
            f"l0 {stats['l0'].tolist()}, sparsity {stats['sparsity'].tolist()}, aux {stats['aux'].tolist()}, "
            f"launches {dict((k, got[k]) for k in kernels)}" + extra)
        del ts, stats
        torch.cuda.empty_cache()
    return launches


EXTRACT_CLIPS, EXTRACT_OTHER = 256, 16  # Aves clips kept, non-Aves clips filtered out
# Muon and "high" at full width (module doc, phases 15 and 16): the steady
# phase's shape, n_sae 2, the tight rung with 5% of the latents pinned dead.
N_SAE_FULL = 2
HIGH_REL = 3e-5  # bf16x3 against the f64 product: about 2^-16 of each operand
HIGH_GAIN = 50  # bf16x3 at least this much closer to f64 than "default"
HIGH_STEP_REL = 1e-4  # the card's "high" step against the CPU's f32 step
NS_REL = 1e-4  # f32 Newton-Schulz against f64 on the card


def rel_norm64(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-300))


def _small_reference(what: str, optim: str, precision: str, tol: float, keys: tuple, kernels: dict) -> None:
    """3 steps of a 2-SAE sweep at the reference phase's small shape
    (d_model 128, d_sae 2048, batch 256, TopK 8, Matryoshka 4) on the card
    against the CPU's plain f32 step from one state, `optim` at `precision`:
    the warm-up step, and the AuxK step in its subspace form (cap 128, k_aux
    64) with 1/16 of the latents pinned dead. `keys` within rel `tol`, l0
    and n_dead equal, no plain version run on the card, and the kernels of
    `kernels[variant]` launched once a step and SAE, the others never."""
    from saev_tpu_torch.framework import train
    from saev_tpu_torch.nn import modeling, objectives

    rng = np.random.default_rng(SEED + 31)
    x = torch.from_numpy(rng.normal(size=(256, 128)).astype(np.float32))
    pf = torch.from_numpy(np.stack([objectives.sample_prefixes(2048, 4, rng=rng) for _ in range(2)]))
    obj = objectives.Matryoshka(n_prefixes=4)
    cfg = modeling.SparseAutoencoderConfig(
        d_model=128, d_sae=2048, activation=modeling.TopK(top_k=8, aux=modeling.AuxK(k_aux=64)))
    for variant, dead, kw in (("warm-up", 0, dict(aux_enabled=False)),
                              ("AuxK subspace cap 128", 2048 // 16, dict(aux_subspace_cap=128))):
        ts_cpu = train.init_sweep_state(cfg, 2, torch.Generator().manual_seed(SEED), device="cpu", optim=optim)
        _pin_dead(ts_cpu, dead)
        ts_gpu = _to(ts_cpu, "cuda")
        step = train.make_train_step(cfg, obj, n_steps=100, optim=optim, matmul_precision=precision, **kw)
        before = counts()
        worst = dict.fromkeys(keys, 0.0)
        for i in range(3):
            ts_cpu, s_cpu = step(ts_cpu, x, pf, _hp(2, "cpu"))
            with plain_spy() as plain:
                ts_gpu, s_gpu = step(ts_gpu, x.cuda(), pf.cuda(), _hp(2, "cuda"))
                torch.cuda.synchronize()
            require(not plain, f"{what} reference {variant} step {i}: the card's step ran plain versions {plain}")
            for key in keys:
                a, b = s_gpu[key].cpu(), s_cpu[key]
                rel = float(((a - b).abs() / b.abs()).max())
                require(rel <= tol, f"{what} reference {variant} step {i}: {key} rel err {rel:.3g} > {tol}")
                worst[key] = max(worst[key], rel)
            for key in ("l0", "n_dead"):
                require(torch.equal(s_gpu[key].cpu(), s_cpu[key]), f"{what} reference {variant} step {i}: {key} "
                        f"{s_gpu[key].tolist()}, CPU {s_cpu[key].tolist()}")
            require(s_cpu["n_dead"].tolist() == [dead] * 2, f"{what} reference {variant}: n_dead {s_cpu['n_dead']}")
        rose = {k: counts()[k] - before[k] for k in KERNELS}
        want = dict.fromkeys(KERNELS, 0) | dict.fromkeys(kernels[variant], 6)
        require(rose == want, f"{what} reference {variant}: launches {rose}, expected {want}")
        for key, v in ts_gpu.params.items():
            require(bool(torch.isfinite(v).all()), f"{what} reference {variant}: param {key} not finite")
        log(f"{what} reference {variant}: 3 steps of a 2-SAE sweep (d_model 128, d_sae 2048, batch 256, {dead} "
            f"dead) agree with the CPU's f32 step within {tol}; worst rel errs "
            + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()) + f"; last mse {s_gpu['mse'].tolist()}")


def _full_width_steps(what: str, step, ts, want: dict, n: int = 5) -> dict:
    """One step, then `n` timed ones of the full-width sweep at 5% dead,
    each launching `want` and keeping L0 and n_dead: the median ms/step
    (CUDA events) and the peak memory of the timed steps; then two more
    steps under the profiler (`kprof.device_profile`): device ms a step and
    the kernels that take the most of it."""
    from saev_tpu_torch.nn import objectives
    from saev_tpu_torch.scripts import kprof

    rng = np.random.default_rng(SEED + 32)
    x = torch.from_numpy(rng.normal(size=(B, D_MODEL)).astype(np.float32)).to("cuda")
    prefixes = torch.from_numpy(np.stack([objectives.sample_prefixes(D_SAE, N_PREFIXES, rng=rng)
                                          for _ in range(N_SAE_FULL)])).to("cuda")
    hp = _steady_hp(N_SAE_FULL)
    times = []
    for i in range(n + 1):
        if i == 1:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        before = counts()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        ts, stats = step(ts, x, prefixes, hp)
        t1.record()
        torch.cuda.synchronize()
        if i:
            times.append(t0.elapsed_time(t1))
        rose = {k: v - before[k] for k, v in counts().items()}
        require(rose == want, f"{what} step {i}: launches {rose}, expected {want}")
        for key, v in stats.items():
            require(bool(torch.isfinite(v.float()).all()), f"{what} step {i}: stat {key} not finite: {v}")
        require(stats["n_dead"].tolist() == [N_DEAD_5] * N_SAE_FULL, f"{what} step {i}: n_dead {stats['n_dead']}")
        require(all(TOP_K <= v <= TOP_K + 4 / B for v in stats["l0"].tolist()), f"{what}: L0 {stats['l0'].tolist()}")
        require(bool((stats["aux"] > 0).all()), f"{what} step {i}: aux {stats['aux'].tolist()}")
    for key, v in ts.params.items():
        require(bool(torch.isfinite(v).all()), f"{what}: param {key} not finite")
    out = {"ms": statistics.median(times), "step_ms": times, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "ts": ts, "mse": stats["mse"].tolist()}
    rows = kprof.device_profile(step, (ts, x, prefixes, hp), n=2, warmup=0)
    require(bool(rows), f"{what}: the profiler recorded no device time")
    out["device_ms"] = kprof.total_device_ms(rows)
    log(f"{what} profile: {out['device_ms']:.2f} device ms/step, {len(rows)} kernel names; longest: "
        + "; ".join(f"{name[:70]} {ms:.2f} ms x{calls}" for name, ms, calls in rows[:12]))
    return out


def phase_muon() -> tuple[dict, dict]:
    """Muon at full width (module doc, phase 15). Returns the launch counts
    of its timed path and what it logs."""
    from saev_tpu_torch.framework import train
    from saev_tpu_torch.nn import modeling, objectives

    warm = WARM_KERNELS
    _small_reference("muon", "muon", "default", 1e-2, ("mse", "l1", "loss", "grad_norm"),
                     {"warm-up": warm, "AuxK subspace cap 128": warm + ("kth_value_masked",)})
    cfg = modeling.SparseAutoencoderConfig(d_model=D_MODEL, d_sae=D_SAE, activation=modeling.TopK(top_k=TOP_K))
    obj = objectives.Matryoshka(n_prefixes=N_PREFIXES)
    step = train.make_train_step(cfg, obj, n_steps=6000, optim="muon", aux_subspace_cap=TIGHT)
    ts = train.init_sweep_state(cfg, N_SAE_FULL, _gen(), "cuda", optim="muon")
    _pin_dead(ts, N_DEAD_5)
    real_ns, inputs, calls = train._newton_schulz, [], []

    def spy(g, *args, **kwargs):
        if len(inputs) < 2:
            inputs.append(g.detach().clone())
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        out = real_ns(g, *args, **kwargs)
        t1.record()
        calls.append((t0, t1))
        return out

    want = dict.fromkeys(KERNELS, 0) | dict.fromkeys(WARM_KERNELS + ("kth_value_masked",), N_SAE_FULL)
    train._newton_schulz = spy
    reset_counts()
    try:
        out = _full_width_steps("muon", step, ts, want)
    finally:
        train._newton_schulz = real_ns
    launches = counts()
    # Two calls a step: 6 steps, then at least 2 under the profiler.
    require(len(calls) >= 16 and len(calls) % 2 == 0, f"muon: {len(calls)} Newton-Schulz calls, expected 16 or more")
    ns_ms = [t0.elapsed_time(t1) for t0, t1 in calls[2:12]]
    require(int(out["ts"].opt_state["count"]) == 6 and float(out["ts"].opt_state["mu"]["W_enc"].abs().max()) > 0,
            "muon: the optimizer state did not advance")
    del out["ts"]
    torch.cuda.empty_cache()

    # The first step's Newton-Schulz inputs (the Nesterov blends of W_enc's
    # and W_dec's clipped gradients, both SAEs): f32 on the card against f64
    # on the card, and the CPU's f32 iteration of the same inputs beside it.
    errs = []
    for g in inputs:
        f32, f64 = real_ns(g), real_ns(g.double())
        cpu = real_ns(g.cpu())
        errs.append({"shape": list(g.shape), "card_f32": rel_norm64(f32, f64), "cpu_f32": rel_norm64(cpu, f64.cpu()),
                     "card_vs_cpu": rel_norm64(f32.cpu(), cpu)})
        del f32, f64, cpu
    torch.cuda.empty_cache()
    for e in errs:
        require(e["card_f32"] <= NS_REL, f"muon: f32 Newton-Schulz {e['shape']} rel-norm {e['card_f32']:.3g} from "
                f"f64 > {NS_REL} (the CPU's f32 iteration: {e['cpu_f32']:.3g})")
    out |= {"ns_ms": statistics.median(ns_ms), "ns_all_ms": ns_ms, "ns_errs": errs}
    log(f"muon n_sae={N_SAE_FULL} (batch {B}, d_model {D_MODEL}, d_sae {D_SAE}, TopK {TOP_K}, AuxK {K_AUX} tight "
        f"rung, Matryoshka {N_PREFIXES}, {N_DEAD_5} dead, \"default\"): median {out['ms']:.2f} ms/step "
        f"({B / (out['ms'] / 1e3):.1f} patches/s) over 5 steps {[round(t, 2) for t in out['step_ms']]}; "
        f"Newton-Schulz median {out['ns_ms']:.2f} ms a call (one leaf of both SAEs, "
        f"{[round(t, 2) for t in ns_ms]}); peak {out['peak_gib']:.2f} GiB; last mse {out['mse']}; f32 Newton-Schulz "
        f"against f64 on the card: " + "; ".join(
            f"{e['shape']} card {e['card_f32']:.3g}, CPU f32 {e['cpu_f32']:.3g}, card vs CPU {e['card_vs_cpu']:.3g}"
            for e in errs))
    return launches, out


def phase_high() -> tuple[dict, dict]:
    """matmul_precision "high" at full width (module doc, phase 16). Returns
    the launch counts of its timed path and what it logs."""
    from saev_tpu_torch.framework import train
    from saev_tpu_torch.nn import modeling, objectives

    _small_reference("high", "adam", "high", HIGH_STEP_REL, ("mse", "loss", "grad_norm"),
                     {"warm-up": ("kth_value",), "AuxK subspace cap 128": ("kth_value", "kth_value_masked")})
    cfg = modeling.SparseAutoencoderConfig(d_model=D_MODEL, d_sae=D_SAE, activation=modeling.TopK(top_k=TOP_K))

    # The encoder's operands at full width: bf16x3 and "default" against the
    # f64 product on the card.
    rng = np.random.default_rng(SEED + 33)
    x = torch.from_numpy(rng.normal(size=(B, D_MODEL)).astype(np.float32)).to("cuda")
    w = modeling.init(cfg, _gen(), "cuda")[0]["W_enc"]
    require(modeling._mode("high", x) == modeling.BF16X3, f"high: {modeling._mode('high', x)} on the card")
    h3 = modeling.matmul(x, w, "high")
    require(torch.equal(h3, modeling._mm_bf16x3(x, w)), "high: matmul is not the bf16x3 product")
    exact = x.double() @ w.double()
    r3, r1 = rel_norm64(h3, exact), rel_norm64(modeling.matmul(x, w, "default"), exact)
    del exact, h3
    torch.cuda.empty_cache()
    require(r3 <= HIGH_REL, f"high: bf16x3 encoder product rel-norm {r3:.3g} from f64 > {HIGH_REL}")
    require(r1 >= HIGH_GAIN * r3, f"high: \"default\" {r1:.3g} is not {HIGH_GAIN}x further from f64 than bf16x3 {r3:.3g}")
    with modeling._f32_products():
        f32_ms = _time(lambda: x @ w, 3)
    prod_ms = {"bf16x3": _time(lambda: modeling._mm_bf16x3(x, w), 3), "bf16": _time(lambda: modeling._mm_bf16(x, w), 3),
               "f32": f32_ms}
    del x, w
    torch.cuda.empty_cache()

    obj = objectives.Matryoshka(n_prefixes=N_PREFIXES)
    step = train.make_train_step(cfg, obj, n_steps=6000, matmul_precision="high", aux_subspace_cap=TIGHT)
    ts = train.init_sweep_state(cfg, N_SAE_FULL, _gen(), "cuda")
    _pin_dead(ts, N_DEAD_5)
    want = dict.fromkeys(KERNELS, 0) | dict.fromkeys(("kth_value", "kth_value_masked"), N_SAE_FULL)
    reset_counts()
    out = _full_width_steps("high", step, ts, want)
    launches = counts()
    del out["ts"]
    torch.cuda.empty_cache()
    out |= {"product_rel": r3, "default_rel": r1, "product_ms": prod_ms}
    log(f"high n_sae={N_SAE_FULL} (the muon phase's shape, Adam): median {out['ms']:.2f} ms/step "
        f"({B / (out['ms'] / 1e3):.1f} patches/s) over 5 steps {[round(t, 2) for t in out['step_ms']]}; peak "
        f"{out['peak_gib']:.2f} GiB; last mse {out['mse']}; the encoder product ({B} x {D_MODEL} x {D_SAE}) "
        f"against f64: bf16x3 {r3:.3g}, \"default\" {r1:.3g} ({r1 / r3:.0f}x); ms bf16x3 {prod_ms['bf16x3']:.3f}, "
        f"bf16 {prod_ms['bf16']:.3f}, f32 (TF32 off) {prod_ms['f32']:.3f}")
    return launches, out


EXTRACT_BATCH = 64  # clips a Bird-MAE forward
EXTRACT_PER_SHARD = 100  # examples an acts*.bin holds: 3 files for 256 clips
EXTRACT_LAYERS = (11, 23)
IMAGE_BATCH = 128
# The card's bf16 route against the float32 forward: relative norm of the
# difference over a layer's taps (tests/test_torch_vit.py's BF16_REL, from
# the route's CPU model, `python -m saev_tpu_torch.scripts.vit_route`).
BF16_REL = 2e-2
# BirdCLEF 2025's label forms: eBird codes and iNaturalist ids; one
# non-Aves label for the filter to drop.
BIRDCLEF_TAXONOMY = {"1139490": "Aves", "abethr1": "Aves", "amekes": "Aves", "barswa": "Aves", "22333": "Aves",
                     "compau": "Aves", "grekis": "Aves", "yeofly1": "Aves", "41663": "Insecta"}


def _write_birdclef(root: pathlib.Path, rng) -> None:
    """A BirdCLEF-2025-layout root: taxonomy.csv, train.csv and
    train_audio/<label>/XC<n>.wav (5 s, 32 kHz, int16, `vit_route.synth_clip`)."""
    import scipy.io.wavfile

    from saev_tpu_torch.scripts import vit_route

    aves = [k for k, v in BIRDCLEF_TAXONOMY.items() if v == "Aves"]
    other = [k for k, v in BIRDCLEF_TAXONOMY.items() if v != "Aves"]
    rows = [aves[i % len(aves)] for i in range(EXTRACT_CLIPS)] + [other[i % len(other)] for i in range(EXTRACT_OTHER)]
    rows = [rows[i] for i in rng.permutation(len(rows))]
    root.mkdir(parents=True)
    with open(root / "taxonomy.csv", "w") as fd:
        fd.write("primary_label,inat_taxon_id,scientific_name,common_name,class_name\n")
        for i, (label, cls) in enumerate(BIRDCLEF_TAXONOMY.items()):
            fd.write(f"{label},{100 + i},Genus species{i},Name {i},{cls}\n")
    with open(root / "train.csv", "w") as fd:
        fd.write("primary_label,secondary_labels,type,filename,collection,rating\n")
        for n, label in enumerate(rows):
            (root / "train_audio" / label).mkdir(parents=True, exist_ok=True)
            scipy.io.wavfile.write(root / "train_audio" / label / f"XC{n}.wav", 32_000, vit_route.synth_clip(rng))
            fd.write(f"{label},[],['call'],{label}/XC{n}.wav,XC,4.0\n")


@contextlib.contextmanager
def _extract_spies(seen: dict):
    """Times, while inside, each batch's wait on the extraction loader, the
    ViT forward (synchronized), the Recorder call around it (the tokens'
    upload, the forward, the taps' copy to the host, the token select) and
    ShardWriter's (or RowWriter's) write; keeps the first Recorder and its
    first batch."""
    from saev_tpu_torch.data import extract, models, shards
    from saev_tpu_torch.models import vit

    real_iter, real_call = extract.ThreadedDataLoader.__iter__, models.Recorder.__call__
    real_fwd, real_write = vit.forward, shards.ShardWriter.write_batch
    real_rows = shards.RowWriter.write_batch

    def it(self):
        seen["start"] = time.perf_counter()
        gen = real_iter(self)
        while True:
            t = time.perf_counter()
            try:
                batch = next(gen)
            except StopIteration:
                return
            seen["wait"].append(time.perf_counter() - t)
            yield batch

    def call(self, batch, **kw):
        if "recorder" not in seen:
            seen["recorder"], seen["first"] = self, np.array(batch)
        t = time.perf_counter()
        out = real_call(self, batch, **kw)
        seen["record"].append(time.perf_counter() - t)
        return out

    def fwd(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_fwd(*a, **kw)
        torch.cuda.synchronize()
        seen["forward"].append(time.perf_counter() - t)
        return out

    depth = []

    def timed_write(real):
        def write(self, *a, **kw):
            # A batch that crosses a shard's end writes its tail by a call of its own.
            depth.append(None)
            t = time.perf_counter()
            try:
                out = real(self, *a, **kw)
            finally:
                depth.pop()
            if not depth:
                seen["end"] = time.perf_counter()
                seen["write"].append(seen["end"] - t)
            return out

        return write

    extract.ThreadedDataLoader.__iter__, models.Recorder.__call__ = it, call
    vit.forward, shards.ShardWriter.write_batch = fwd, timed_write(real_write)
    shards.RowWriter.write_batch = timed_write(real_rows)
    try:
        yield seen
    finally:
        extract.ThreadedDataLoader.__iter__, models.Recorder.__call__ = real_iter, real_call
        vit.forward, shards.ShardWriter.write_batch = real_fwd, real_write
        shards.RowWriter.write_batch = real_rows


def _layer_errs(got: torch.Tensor, want: torch.Tensor) -> list[float]:
    """rel_norm of each layer's taps, (B, L, T, D) tensors."""
    return [rel_norm(got[:, i], want[:, i]) for i in range(got.shape[1])]


def _bird_mae_extract(root: pathlib.Path) -> dict:
    """Bird-MAE-Large through `framework.shards.cli` at full width (module
    doc, phase 17). Returns what it logs."""
    from saev_tpu_torch.data import ShuffledConfig, ShuffledDataLoader, datasets, shards
    from saev_tpu_torch.framework import shards as fshards
    from saev_tpu_torch.models import bird_mae, vit
    from saev_tpu_torch.scripts import vit_route

    rng = np.random.default_rng(SEED + 16)
    t0 = time.perf_counter()
    _write_birdclef(root / "birdclef", rng)
    spec = bird_mae.PRETRAINED_SPECS["Bird-MAE-Large"]
    require((spec.d_model, spec.n_layers, spec.n_heads) == (1024, 24, 16), f"extract: Bird-MAE-Large is {spec}")
    ckpt = root / "Bird-MAE-Large.pt"
    torch.save(vit_route.bird_mae_state_dict(spec, torch.Generator().manual_seed(SEED + 17)), ckpt)
    t_files = time.perf_counter() - t0
    shards_root = root / "saev" / "shards"
    shards_root.mkdir(parents=True)
    tokens = bird_mae.N_PATCHES + 1
    cfg = fshards.Config(
        data=datasets.BirdClef2025(root=root / "birdclef"), family="bird-mae", ckpt=f"Bird-MAE-Large={ckpt}",
        layers=EXTRACT_LAYERS, d_model=spec.d_model, content_tokens_per_example=bird_mae.N_PATCHES,
        cls_token=True, shards_root=shards_root, max_tokens_per_shard=EXTRACT_PER_SHARD * tokens * len(EXTRACT_LAYERS),
        batch_size=EXTRACT_BATCH, n_workers=8,
    )
    require(cfg.device == "cuda", f"extract: the entry point's device is {cfg.device}")
    seen = {"wait": [], "record": [], "forward": [], "write": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _extract_spies(seen):
        fshards.cli(cfg)
    t_cli = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    (shards_dir,) = [p for p in shards_root.iterdir() if p.is_dir()]
    md, info = shards.Metadata.load(shards_dir), shards.ShardInfo.load(shards_dir)
    info.validate(shards_dir)
    n_files = len(list(shards_dir.glob("acts*.bin")))
    require(md.n_examples == EXTRACT_CLIPS and sum(s.n_examples for s in info) == EXTRACT_CLIPS,
            f"extract: {md.n_examples} examples in the shards, {EXTRACT_CLIPS} Aves clips written")
    require(n_files >= 2 and len(info) == n_files, f"extract: {n_files} acts files, shards.json lists {len(info)}")
    data_cfg = md.make_data_cfg()
    require(data_cfg == cfg.data, f"extract: metadata decodes to {data_cfg}")
    kept = {label for _, _, label in datasets.get_dataset(data_cfg).samples}
    require("41663" not in kept and len(kept) == 8, f"extract: labels kept {sorted(kept)}")
    require(len(seen["forward"]) == len(seen["write"]) == -(-EXTRACT_CLIPS // EXTRACT_BATCH),
            f"extract: {len(seen['forward'])} forwards, {len(seen['write'])} writes")

    def rows(e0: int, e1: int) -> np.ndarray:
        return np.array(np.memmap(shards_dir / info[0].name, mode="r", dtype=np.float32, shape=md.shard_shape)[e0:e1])

    # The shard rows of the first batch: bit for bit a second card forward of
    # the same spectrograms, and within BF16_REL of the float32 forward on the
    # CPU for the first clips.
    recorder, first = seen["recorder"], seen["first"]
    require(first.shape == (EXTRACT_BATCH, bird_mae.TARGET_T, bird_mae.N_MELS), f"extract: batch {first.shape}")
    stored = rows(0, EXTRACT_BATCH)
    _, again = recorder(first)
    require(np.array_equal(again.view(np.int32), stored.view(np.int32)),
            "extract: a second card forward of the first batch differs from its shard rows")
    cpu_params = vit.to_device(recorder.model.params, "cpu")
    toks = torch.from_numpy(np.stack([bird_mae.spectrogram_to_tokens(fb) for fb in first[:2]]))
    t0 = time.perf_counter()
    _, f32 = vit.forward(spec, cpu_params, toks, EXTRACT_LAYERS, grid=(bird_mae.N_TIME_PATCHES, bird_mae.N_MEL_PATCHES),
                         precision="highest")
    t_cpu = time.perf_counter() - t0
    del cpu_params
    errs = _layer_errs(torch.from_numpy(stored[:2]), f32)
    require(max(errs) <= BF16_REL and bool(np.isfinite(stored).all()),
            f"extract: shard rows against the CPU's float32 forward, rel-norm by layer {errs}")

    # The port's shuffled loader reads a batch of layer 23 from the new directory.
    loader = ShuffledDataLoader(ShuffledConfig(shards=shards_dir, layer=EXTRACT_LAYERS[1], batch_size=4096,
                                               n_threads=2, buffer_size=4, batch_timeout_s=60.0, seed=SEED))
    try:
        batch = next(iter(loader))
    finally:
        loader.shutdown()
    act, ex, tok = batch["act"], batch["example_idx"], batch["token_idx"]
    eps = md.examples_per_shard
    want = np.stack([np.memmap(shards_dir / info[e // eps].name, mode="r", dtype=np.float32,
                               shape=md.shard_shape)[e % eps, 1, t + 1] for e, t in zip(ex[:256], tok[:256])])
    require(act.shape == (4096, spec.d_model) and np.array_equal(act[:256].view(np.int32), want.view(np.int32)),
            f"extract: the shuffled loader's batch {act.shape} is not the shards' rows")

    loop = seen["end"] - seen["start"]
    n = len(seen["forward"])
    out = {
        "clips_s": EXTRACT_CLIPS / loop, "tokens_s": EXTRACT_CLIPS * tokens / loop, "loop_s": loop,
        "entry_point_s": t_cli, "files_s": t_files, "peak_gib": peak, "acts_files": n_files,
        "shard_gb": sum((shards_dir / s.name).stat().st_size for s in info) / 1e9,
        "wait_ms": [round(1e3 * v, 2) for v in seen["wait"]],
        "forward_ms": [round(1e3 * v, 2) for v in seen["forward"]],
        "copy_ms": [round(1e3 * (r - f), 2) for r, f in zip(seen["record"], seen["forward"])],
        "write_ms": [round(1e3 * v, 2) for v in seen["write"]],
        "cpu_f32_s": t_cpu, "errs": errs, "cfg": cfg, "dir": shards_dir,
    }
    fwd_ms = statistics.median(out["forward_ms"][1:]) if n > 1 else out["forward_ms"][0]
    flops = 2 * EXTRACT_BATCH * tokens * 12 * spec.d_model**2 * spec.n_layers
    log(f"extract Bird-MAE-Large (d_model 1024, 24 layers, 16 heads, taps {EXTRACT_LAYERS} at norm2) through "
        f"framework.shards.cli: {EXTRACT_CLIPS} of {EXTRACT_CLIPS + EXTRACT_OTHER} clips kept (Aves), "
        f"{out['clips_s']:.1f} clips/s ({out['tokens_s']:.0f} tokens/s) over the {loop:.2f} s loop, "
        f"{t_cli:.2f} s for the entry point (model build included), {t_files:.2f} s writing the clips and "
        f"checkpoint; batch of {EXTRACT_BATCH}: loader wait ms {out['wait_ms']}, forward ms {out['forward_ms']} "
        f"(median after the first {fwd_ms:.2f} ms, {flops / fwd_ms / 1e9:.0f} TFLOP/s on the block products), "
        f"upload+copy to host+select ms {out['copy_ms']}, write ms {out['write_ms']}; {n_files} acts files, "
        f"{out['shard_gb']:.3f} GB; peak {peak:.2f} GiB; second forward bit for bit; against the CPU's float32 "
        f"forward of 2 clips ({t_cpu:.2f} s) rel-norm by layer {[f'{e:.3g}' for e in errs]}; shuffled loader "
        f"batch of layer {EXTRACT_LAYERS[1]} {act.shape} equal to the shard rows")
    return out


EXTRACT_RANKS_LIMIT = 300  # seconds the extraction ranks may take, together, before they count as stalled


def _extract_rank(rank: int, world: int, port: int, backend: str, root: str, cfg) -> None:
    """One rank of the extract phase's (a): `framework.shards.cli(cfg)`
    under torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, the
    rendezvous), so that over NCCL the CLI joins the process group itself,
    one card a rank; over gloo (NCCL takes one card a rank) the rank joins
    it here first, on cuda:0. The parent spawns it with torchrun's
    OMP_NUM_THREADS. Saves what `_extract_spies` saw to
    root/extract_rank<rank>.pt; a failure is saved there too."""
    import os
    import traceback

    from saev_tpu_torch import parallel
    from saev_tpu_torch.framework import shards as fshards

    root = pathlib.Path(root)
    out = {}
    try:
        if not torch.cuda.is_available():
            raise RuntimeError(f"extract rank {rank}: no CUDA device")
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank if backend == "nccl" else 0),
                          MASTER_ADDR="localhost", MASTER_PORT=str(port))
        if backend == "gloo":
            parallel.init_distributed(torch.device("cuda", 0), backend="gloo",
                                      timeout=datetime.timedelta(seconds=MULTI_TIMEOUT_S))
        seen = {"wait": [], "record": [], "forward": [], "write": []}
        t0 = time.perf_counter()
        with _extract_spies(seen):
            fshards.cli(cfg)
        out = {k: seen[k] for k in ("wait", "record", "forward", "write")}
        out |= {"start": seen.get("start"), "end": seen.get("end"), "cli_s": time.perf_counter() - t0,
                "device": torch.cuda.current_device()}
    except BaseException:  # noqa: BLE001 - saved for the parent, then the rank exits non-zero
        out["error"] = traceback.format_exc()
    finally:
        torch.save(out, root / f"extract_rank{rank}.pt")
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    if "error" in out:
        raise SystemExit(1)


def _same_file(a: pathlib.Path, b: pathlib.Path, chunk: int = 1 << 26) -> bool:
    size = a.stat().st_size
    if size != b.stat().st_size:
        return False
    if size == 0:
        return True
    ma, mb = np.memmap(a, mode="r", dtype=np.uint8), np.memmap(b, mode="r", dtype=np.uint8)
    return all(np.array_equal(ma[i : i + chunk], mb[i : i + chunk]) for i in range(0, size, chunk))


def _bird_mae_extract_ranks(root: pathlib.Path, one: dict) -> dict:
    """(a): `_bird_mae_extract`'s config through the CLI at `multi_layout`'s
    ranks (`_extract_rank`, spawned together, killed past
    EXTRACT_RANKS_LIMIT) into a second shards root: the directory bit for
    bit the one-rank directory, each rank's forwards its share of the
    batches. Returns what it logs."""
    import dataclasses
    import multiprocessing
    import os
    import socket

    from saev_tpu_torch import parallel
    from saev_tpu_torch.data import shards

    world, backend = multi_layout()
    shards_root = root / "ranks" / "saev" / "shards"
    shards_root.mkdir(parents=True)
    cfg = dataclasses.replace(one["cfg"], shards_root=shards_root)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_extract_rank, args=(r, world, port, backend, str(root), cfg)) for r in range(world)]
    # torchrun sets OMP_NUM_THREADS=1 for its workers where it is unset; it
    # reaches OpenBLAS as the ranks import numpy.
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = threads or "1"
    t = time.perf_counter()
    try:
        for p in procs:
            p.start()
    finally:
        if threads is None:
            del os.environ["OMP_NUM_THREADS"]
    deadline = time.monotonic() + EXTRACT_RANKS_LIMIT
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    stalled = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(30)
    spawn_s = time.perf_counter() - t
    ranks = [torch.load(root / f"extract_rank{r}.pt", weights_only=False) if (root / f"extract_rank{r}.pt").exists()
             else {"error": "no result"} for r in range(world)]
    errors = {r: res["error"] for r, res in enumerate(ranks) if "error" in res}
    require(not stalled and not errors and all(p.exitcode == 0 for p in procs),
            f"extract ranks: stalled past {EXTRACT_RANKS_LIMIT} s: {stalled}; exit codes "
            f"{[p.exitcode for p in procs]}; " + "".join(f"\n--- rank {r}\n{e}" for r, e in errors.items()))

    (got,) = [p for p in shards_root.iterdir() if p.is_dir()]
    want = one["dir"]
    names = sorted(p.name for p in want.iterdir())
    require(got.name == want.name and sorted(p.name for p in got.iterdir()) == names,
            f"extract ranks: {sorted(p.name for p in got.iterdir())} in {got.name}, one rank {names} in {want.name}")
    t0 = time.perf_counter()
    differ = [n for n in names if not _same_file(got / n, want / n)]
    t_cmp = time.perf_counter() - t0
    require(not differ, f"extract ranks: {differ} differ from the one-rank directory's")
    md = shards.Metadata.load(got)
    require(md.n_examples == EXTRACT_CLIPS, f"extract ranks: {md.n_examples} examples, {EXTRACT_CLIPS} clips")
    for r, res in enumerate(ranks):
        share = len(parallel.batch_spans(EXTRACT_CLIPS, EXTRACT_BATCH, r, world))
        require(len(res["forward"]) == len(res["write"]) == share,
                f"extract rank {r}: {len(res['forward'])} forwards, {len(res['write'])} writes, its share {share}")
    loop = max(res["end"] for res in ranks) - min(res["start"] for res in ranks)
    out = {"world": world, "backend": backend, "omp_threads": threads or "1", "clips_s": EXTRACT_CLIPS / loop,
           "loop_s": loop, "spawn_s": spawn_s,
           "ranks": [{k: [round(1e3 * v, 2) for v in res[k]] for k in ("wait", "forward", "write")}
                     | {"cli_s": res["cli_s"], "device": res["device"]} for res in ranks]}
    per_rank = "; ".join(
        f"rank {r} (cuda:{res['device']}) loader wait ms {res['wait']}, forward ms {res['forward']}, write ms "
        f"{res['write']}, entry point {res['cli_s']:.2f} s" for r, res in enumerate(out["ranks"]))
    shared = " (the ranks share one card: the times are a record, not a speedup)" if backend == "gloo" else ""
    log(f"extract ranks: Bird-MAE-Large through framework.shards.cli at {world} ranks over {backend}{shared}, "
        f"OMP_NUM_THREADS={out['omp_threads']} in the ranks as torchrun sets it (the one rank: this process's "
        f"{threads or 'unset'}): {out['clips_s']:.1f} clips/s over the {loop:.2f} s loop (first batch to last write, "
        f"every rank), against {one['clips_s']:.1f} clips/s at one rank; {per_rank}; ranks ran {spawn_s:.1f} s in all, start-up "
        f"included; the directory {got.name} bit for bit the one-rank directory ({len(names)} files, compared in "
        f"{t_cmp:.2f} s)")
    return out


@contextlib.contextmanager
def _dense_before():
    """While inside, the ViT's dense products take the route they had before
    they went through `modeling._Matmul` (for Grad-CAM's backward): one
    `modeling._mm_bf16` call, `torch.mm(..., out_dtype=)` on the card."""
    from saev_tpu_torch.models import vit
    from saev_tpu_torch.nn import modeling

    def dense(x, p, bf16):
        if bf16:
            y = modeling._mm_bf16(x.reshape(-1, x.shape[-1]), p["w"])
            return y.reshape(*x.shape[:-1], y.shape[-1]) + p["b"]
        return x @ p["w"] + p["b"]

    real, vit._dense = vit._dense, dense
    try:
        yield
    finally:
        vit._dense = real


def _image_family(what: str, model, model_f32, tokens: np.ndarray, grids: list) -> dict:
    """One image family through `Recorder` at batch IMAGE_BATCH on Gaussian
    pre-patchified tokens, against the same family at "highest" (float32
    products, TF32 off) on the card, for each grid set, and bit for bit
    against the dense products' route before `modeling._Matmul`
    (`_dense_before`); time and peak memory on the first. Returns what it
    logs."""
    from saev_tpu_torch.data import models
    from saev_tpu_torch.models import vit

    rec = models.Recorder(model, tokens.shape[1], True, EXTRACT_LAYERS)
    rec32 = models.Recorder(model_f32, tokens.shape[1], True, EXTRACT_LAYERS)
    out = {"errs": []}
    for gi, grid in enumerate(grids):
        kw = {} if grid is None else {"grid": grid}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, acts = rec(tokens, **kw)
        _, acts2 = rec(tokens, **kw)
        _, acts32 = rec32(tokens, **kw)
        require(acts.shape == (IMAGE_BATCH, len(EXTRACT_LAYERS), tokens.shape[1] + 1, model.d_model)
                and bool(np.isfinite(acts).all()), f"extract {what}: taps {acts.shape}")
        require(np.array_equal(acts.view(np.int32), acts2.view(np.int32)), f"extract {what}: two forwards differ")
        with _dense_before():
            _, acts_before = rec(tokens, **kw)
        require(np.array_equal(acts.view(np.int32), acts_before.view(np.int32)),
                f"extract {what}: the taps differ from the dense products' route before modeling._Matmul")
        errs = _layer_errs(torch.from_numpy(acts), torch.from_numpy(acts32))
        require(max(errs) <= BF16_REL, f"extract {what} grids {gi}: rel-norm by layer {errs} against float32")
        out["errs"].append(errs)
        if gi:
            continue
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        t0 = time.perf_counter()
        for _ in range(3):
            rec(tokens, **kw)
        out["recorder_ms"] = (time.perf_counter() - t0) / 3 * 1e3
        x = torch.from_numpy(tokens).to(vit.params_device(model.params))
        rope = None
        if grid is not None:
            (gh, gw), = {tuple(g) for g in grid}
            rope = tuple(torch.from_numpy(t).to(x.device) for t in vit.rope_sincos_from_periods(
                model.periods, gh, gw, model.spec.rope_normalize_coords))
        grid_arg = (1, tokens.shape[1]) if grid is not None else model.preset.grid
        out["forward_ms"] = _time(lambda: vit.forward(model.spec, model.params, x, EXTRACT_LAYERS, grid=grid_arg,
                                                      rope_sincos=rope), 3)
        del x
    log(f"extract {what} through Recorder, batch {IMAGE_BATCH} x {tokens.shape[1]} patches: "
        f"{IMAGE_BATCH / out['recorder_ms'] * 1e3:.1f} images/s with the taps' copy to the host "
        f"({out['recorder_ms']:.2f} ms a batch), forward alone {out['forward_ms']:.2f} ms "
        f"({IMAGE_BATCH / out['forward_ms'] * 1e3:.1f} images/s), peak {out['peak_gib']:.2f} GiB; against "
        f"float32 rel-norm by layer {[[f'{e:.3g}' for e in es] for es in out['errs']]}; two forwards, and the "
        f"route before modeling._Matmul, bit for bit")
    return out


@contextlib.contextmanager
def _without(package: str):
    """While inside, `package` cannot be imported, whether or not this
    machine has it: its loaded modules are set aside and a finder refuses
    it; both are undone after."""
    import importlib.abc

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] == package:
                raise ImportError(f"{package} is blocked here")
            return None

    aside = {k: sys.modules.pop(k) for k in list(sys.modules) if k.split(".")[0] == package}
    finder = Refuse()
    sys.meta_path.insert(0, finder)
    try:
        yield
    finally:
        sys.meta_path.remove(finder)
        sys.modules.update(aside)


def phase_extract() -> dict:
    """Extraction at full width (module doc, phase 17): launches no saev
    kernel. Returns what it logs."""
    import importlib.util

    from saev_tpu_torch.models import dinov3, families, vit
    from saev_tpu_torch.scripts import vit_route

    reset_counts()
    root = pathlib.Path(tempfile.mkdtemp(prefix="saev_extract_"))
    try:
        out = {"bird_mae": _bird_mae_extract(root)}
        torch.cuda.empty_cache()
        out["bird_mae_ranks"] = _bird_mae_extract_ranks(root, out["bird_mae"])
        torch.cuda.empty_cache()
        # CLIP ViT-L/14 from a random OpenCLIP checkpoint: its 257-entry
        # position table fits the 16 x 16 grid, so no interpolation.
        preset = families.CLIP_PRESETS["ViT-L-14"]
        ckpt = root / "ViT-L-14.pt"
        torch.save(vit_route.openclip_state_dict(preset.spec, torch.Generator().manual_seed(SEED + 18), 257), ckpt)
        clip = families.Clip(f"ViT-L-14={ckpt}")
        clip32 = families.Clip(f"ViT-L-14={ckpt}", params=clip.params, precision="highest")
        rng = np.random.default_rng(SEED + 19)
        toks = rng.normal(size=(IMAGE_BATCH, 256, 3 * 14 * 14)).astype(np.float32)
        out["clip"] = _image_family("CLIP ViT-L-14", clip, clip32, toks, [None])
        del clip, clip32
        torch.cuda.empty_cache()
        # DINOv3 ViT-L/16 with random params: RoPE, 4 storage tokens,
        # LayerScale, the masked K bias; one batch on two grids.
        spec = dinov3.PRETRAINED_SPECS["dinov3_vitl16"]
        params = vit_route.random_params(spec, torch.Generator(device="cuda").manual_seed(SEED + 20))
        dv3 = dinov3.Vit("dinov3_vitl16", params=params)
        dv332 = dinov3.Vit("dinov3_vitl16", params=params, precision="highest")
        toks = rng.normal(size=(IMAGE_BATCH, 256, 3 * 16 * 16)).astype(np.float32)
        uniform = np.tile(np.array([[16, 16]]), (IMAGE_BATCH, 1))
        mixed = np.array([[16, 16], [8, 32]] * (IMAGE_BATCH // 2))
        out["dinov3"] = _image_family("DINOv3 ViT-L/16", dv3, dv332, toks, [uniform, mixed])
        del dv3, dv332, params
        torch.cuda.empty_cache()
        # (b) DINOv2 ViT-L/14 with registers from a random torch.hub
        # checkpoint with the released 1 + 37 x 37 table (518 px): loading
        # resizes it onto the 16 x 16 grid by the numpy bicubic.
        arch = "dinov2_vitl14_reg"
        spec = families.DINOV2_PRESETS[arch].spec
        require((spec.d_model, spec.n_layers, spec.n_heads, spec.n_registers) == (1024, 24, 16, 4),
                f"extract: {arch} is {spec}")
        ckpt = root / f"{arch}.pt"
        torch.save(vit_route.dinov2_state_dict(spec, torch.Generator().manual_seed(SEED + 21), 1 + 37 * 37), ckpt)
        t0 = time.perf_counter()
        with _without("PIL"):
            dv2 = families.Dinov2(f"{arch}={ckpt}")
        t_load = time.perf_counter() - t0
        table = torch.load(ckpt)["pos_embed"].numpy().reshape(1 + 37 * 37, spec.d_model)
        t0 = time.perf_counter()
        want = vit.interpolate_pos(table, 1, (37, 37), (16, 16))
        t_resize = time.perf_counter() - t0
        pos = dv2.params["pos"].cpu().numpy()
        require(pos.shape == (1 + 4 + 256, spec.d_model) and np.array_equal(pos[:1], want[:1])
                and not pos[1:5].any() and np.array_equal(pos[5:], want[1:]),
                f"extract {arch}: the position table {pos.shape} is not the resized checkpoint's")
        dv232 = families.Dinov2(f"{arch}={ckpt}", params=dv2.params, precision="highest")
        toks = rng.normal(size=(IMAGE_BATCH, 256, 3 * 14 * 14)).astype(np.float32)
        out["dinov2"] = _image_family("DINOv2 ViT-L/14 reg", dv2, dv232, toks, [None])
        log(f"extract {arch}: loaded in {t_load:.2f} s with Pillow blocked from import, from a checkpoint with a "
            f"1 + 37 x 37 position table, resized onto 16 x 16 by the numpy bicubic ({t_resize * 1e3:.1f} ms over "
            f"{spec.d_model} channels)")
        del dv2, dv232
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    got = counts()
    require(not any(got.values()), f"extract: saev kernels launched {got}")
    have = {m: importlib.util.find_spec(m) is not None for m in ("PIL", "pandas")}
    log(f"extract environment: Pillow importable {have['PIL']}, pandas importable {have['pandas']}; the phase "
        f"needs neither")
    return out


# ---------------------------------------------------------------------------
# multi: training over torch.distributed, one process a rank
# ---------------------------------------------------------------------------

# The steady phase's shape (batch 16384, d_model 1024, d_sae 16384, TopK 32,
# AuxK 512 in the tight subspace with 5% of the latents pinned dead,
# Matryoshka 10, n_sae 2, "default"), 3 steps a case; the job: 4 steps of
# 16384 rows (a train epoch), checkpoints every 2, stopped on every rank once
# step 2's is written, then resumed; 2 eval batches.
MULTI = dict(batch=B, d_model=D_MODEL, d_sae=D_SAE, top_k=TOP_K, k_aux=K_AUX, n_prefixes=N_PREFIXES, cap=TIGHT,
             dead=N_DEAD_5, n_sae=2, steps=3,
             job=dict(JOB, train_examples=256, val_examples=256, steps=4, ckpt_every=2, stop_at=2))
MULTI_MAX_WORLD = 4  # ranks over NCCL, one card each, on a host with that many cards or more


def multi_layout() -> tuple[int, str]:
    """(ranks, backend) of the multi phase: one card a rank over NCCL, up to
    MULTI_MAX_WORLD of them, where there are 2 cards or more; else 2 ranks
    on cuda:0 over gloo (NCCL takes one card a rank)."""
    n_cards = torch.cuda.device_count()
    return (min(n_cards, MULTI_MAX_WORLD), "nccl") if n_cards >= 2 else (2, "gloo")


def multi_dims(world: int, dims: dict = MULTI) -> dict:
    """`dims` for `world` ranks: one SAE a rank (at least 2) and a train and
    val shard (128 examples) a rank."""
    n = max(2, world)
    return dict(dims, n_sae=n, job=dict(dims["job"], train_examples=128 * n, val_examples=128 * n))


MULTI_LIMIT = 600  # seconds the ranks may take, together, before they count as stalled
MULTI_TIMEOUT_S = 300  # seconds a collective waits for the other ranks
# The data-parallel step against the one-rank step on the same global
# batches from the same state: two halves of each product summed in another
# order (and the gradients' sum over the ranks), so the loss terms and the
# gradient's norm differ in rounding, and Adam's first steps, about lr *
# sign(g), move the entries whose gradient is near 0 apart. An H100 gave
# 2.15e-5 and 1.71e-5 (2 ranks over gloo): each bound is about 5x that.
MULTI_DATA_STAT_REL = 1e-4
MULTI_DATA_PARAM_REL = 1e-4
MULTI_THRESHOLD_REL = 1e-5  # BatchTopK's moved threshold, after each step (an H100 gave 0)
MULTI_STEP_KERNELS = WARM_KERNELS + ("kth_value_masked",)  # K1-K5
# (e) feature-parallel training at the steady phase's shape, one SAE, from
# one step before AuxK starts (warm, dense, then the tight rung); (f) the
# same at d_sae 65536, whose tight rung holds its 5% dead.
MULTI_FEATURE = dict(batch=B, d_model=D_MODEL, d_sae=D_SAE, top_k=TOP_K, k_aux=K_AUX, n_prefixes=N_PREFIXES,
                     dead=N_DEAD_5, steps=3)
MULTI_FEATURE_WIDE = dict(MULTI_FEATURE, d_sae=D_SAE_WIDE, dead=int(D_SAE_WIDE * 0.05))
MULTI_FEATURE_ROUTE = ["warm", "dense", "tight"]
# The feature-parallel step against the one-rank step: the partial products
# summed over the ranks round apart from the whole ones (and the gradient's
# norm, Muon's Gram matrices). H100s gave stats 1.83e-7 and params 6.92e-7
# with 2 ranks over gloo, stats 4.61e-6 (f) and params 7.71e-7 with 4 over
# NCCL: each bound about 4-6x the larger.
MULTI_FEATURE_STAT_REL = 2e-5
MULTI_FEATURE_PARAM_REL = 5e-6
# What (e) and (f) launch on every rank: K1's threshold entry and the
# candidate step (`helper_counts`), K3-K7; K2 and K1's own select never.
MULTI_FEATURE_KERNELS = ("grouped_matmul_dgrad", "grouped_matmul_wgrad", "kth_value_masked", "kth_value",
                         "grouped_prefix_base")
MULTI_FEATURE_HELPERS = ("topk_stats_given", "kth_candidates")
MULTI_FEATURE_CASES = ("feature", "feature_muon", "feature_wide")


def _multi_steps(dims: dict, device, mesh, case: str) -> dict:
    """`case`'s steps ("data": TopK at n_data = world; "sweep": TopK with
    the sweep split over the mesh; "batch_topk": BatchTopK, momenta 0.1,
    0.3, ..., at n_data = world) from one seeded state with dims["dead"] latents
    pinned, on seeded batches of which this rank takes its rows. The whole
    cohort's params and stats come back on every rank (`parallel.to_host`)
    with each step's ms and the launches; at world 1 it is the one-rank
    reference (mesh of one process)."""
    from saev_tpu_torch import parallel
    from saev_tpu_torch.framework import train
    from saev_tpu_torch.nn import modeling, objectives

    act = modeling.BatchTopK if case == "batch_topk" else modeling.TopK
    cfg = modeling.SparseAutoencoderConfig(
        d_model=dims["d_model"], d_sae=dims["d_sae"],
        activation=act(top_k=dims["top_k"], aux=modeling.AuxK(k_aux=dims["k_aux"])),
    )
    obj = objectives.Matryoshka(n_prefixes=dims["n_prefixes"])
    n_sae, world, rank = dims["n_sae"], parallel.process_count(), parallel.process_index()
    gen = torch.Generator(device).manual_seed(SEED + 11)
    ts = train.init_sweep_state(cfg, n_sae, gen, device)
    _pin_dead(ts, dims["dead"])
    xs = [torch.randn((dims["batch"], dims["d_model"]), generator=gen, device=device) for _ in range(dims["steps"])]
    rng = np.random.default_rng(SEED + 12)
    prefixes = torch.from_numpy(np.stack([
        objectives.sample_prefixes(dims["d_sae"], dims["n_prefixes"], rng=rng) for _ in range(n_sae)
    ])).to(device)
    hp = {
        "lr": torch.full((n_sae,), 4e-4, device=device) * (1 + torch.arange(n_sae, device=device)),
        "n_lr_warmup": torch.full((n_sae,), 2.0, device=device),
        "grad_clip": torch.ones((n_sae,), device=device),
        "sparsity_coeff": torch.zeros((n_sae,), device=device),
        "aux_alpha": torch.full((n_sae,), 1 / 32, device=device),
        "momentum": 0.1 + 0.2 * torch.arange(n_sae, device=device),
    }
    ts, hp, prefixes = (parallel.shard_sweep(mesh, t) for t in (ts, hp, prefixes))
    step = train.make_train_step(cfg, obj, n_steps=6000, aux_subspace_cap=dims["cap"], mesh=mesh)
    rows = dims["batch"] // world
    out = {"stats": [], "ms": [], "threshold": []}
    reset_counts()
    for x in xs:
        x = x[rank * rows : (rank + 1) * rows].contiguous()
        _sync(device)
        t = time.perf_counter()
        ts, stats = step(ts, parallel.shard_batch(mesh, x), prefixes, hp)
        _sync(device)
        out["ms"].append((time.perf_counter() - t) * 1e3)
        out["stats"].append(parallel.to_host(mesh, stats))
        if case == "batch_topk":
            out["threshold"].append(parallel.to_host(mesh, ts.sae_state["threshold"]))
    out["launches"] = counts()
    out["params"] = parallel.to_host(mesh, ts.params)
    return out


def _sync(device) -> None:
    torch.cuda.synchronize(device)


def _multi_collectives(dims: dict, device) -> dict:
    """ms of the two large collectives of the multi phase's steps over every
    rank, 3 each after one warm-up, each behind a barrier and timed to the
    card's end: the data-parallel step's bucket (the whole cohort's
    gradients, f32) through `parallel.all_reduce_mean`, and this rank's rows
    through `parallel.gather_rows` (the sweep group's gather)."""
    from saev_tpu_torch import parallel

    group = parallel.world_group()
    bucket = torch.ones(dims["n_sae"] * (2 * dims["d_model"] * dims["d_sae"] + dims["d_sae"] + dims["d_model"]),
                        device=device)
    rows = torch.ones((dims["batch"] // group.size, dims["d_model"]), device=device)
    out = {"bucket_mib": bucket.numel() * 4 / 2**20, "rows_mib": rows.numel() * 4 / 2**20}
    for name, fn in (("all_reduce_mean", lambda: parallel.all_reduce_mean([bucket], group)),
                     ("gather_rows", lambda: parallel.gather_rows(rows, group))):
        fn()
        out[name] = []
        for _ in range(3):
            parallel.sync()
            _sync(device)
            t = time.perf_counter()
            fn()
            _sync(device)
            out[name].append((time.perf_counter() - t) * 1e3)
    return out


def _multi_job(dims: dict, device, root: pathlib.Path, train_dir, val_dir) -> dict:
    """`worker_fn` at world = the job's processes (data-parallel), n_sae 2,
    on the shards in `root`: stopped on every rank once step
    dims["stop_at"]'s checkpoint is written, then resumed to the end, eval
    and the SAE files. Counts each rank's checkpoint and SAE file writes;
    rank 0 loads each file with `nn.load` against the trained params."""
    import dataclasses
    import os

    from saev_tpu_torch import nn, parallel
    from saev_tpu_torch.data import ShuffledConfig
    from saev_tpu_torch.framework import checkpoints, train
    from saev_tpu_torch.nn import modeling, objectives
    from saev_tpu_torch.utils import wandb as tracking

    batch = dims["batch"]
    data = dict(layer=0, batch_size=batch)
    base = train.Config(
        train_data=ShuffledConfig(shards=train_dir, **data), val_data=ShuffledConfig(shards=val_dir, **data),
        n_train=dims["steps"] * batch, n_val=dims["val_batches"] * batch,
        sae=modeling.SparseAutoencoderConfig(
            d_model=dims["d_model"], d_sae=dims["d_sae"],
            activation=modeling.TopK(top_k=dims["top_k"], aux=modeling.AuxK(k_aux=dims["k_aux"])),
        ),
        objective=objectives.Matryoshka(n_prefixes=dims["n_prefixes"], dead_threshold_tokens=batch),
        lr=dims["lrs"][0], n_lr_warmup=2, log_every=2, ckpt_every=dims["ckpt_every"], track=True,
        runs_root=root / "saev" / "runs", device=device.type, seed=SEED,
    )
    cfgs = [base, dataclasses.replace(base, lr=dims["lrs"][1])]

    class Stop(Exception):
        pass

    writes = {"state": 0, "sae": 0}
    real = {"save": checkpoints.save, "to_cpu": checkpoints._to_cpu, "dump": train.serialize.dump,
            "train": train.train, "evaluate": train.evaluate, "wandb": tracking._WANDB}
    seen = {}

    def save(runs_root, key, step, state, **kwargs):
        path = real["save"](runs_root, key, step, state, **kwargs)
        if step == dims["stop_at"] and "stopped" not in seen:
            seen["stopped"] = step
            raise Stop
        return path

    depth = [0]

    def to_cpu(state):  # called (and calls itself) where a checkpoint is written, and only there
        writes["state"] += depth[0] == 0
        depth[0] += 1
        try:
            return real["to_cpu"](state)
        finally:
            depth[0] -= 1

    def dump(*args, **kwargs):
        writes["sae"] += 1
        return real["dump"](*args, **kwargs)

    def spy_train(c):
        seen["train"] = real["train"](c)
        return seen["train"]

    def spy_evaluate(c, r):
        seen["eval"] = real["evaluate"](c, r)
        return seen["eval"]

    cwd = os.getcwd()
    os.chdir(root)  # the local run recorder writes under ./.wandb
    checkpoints.save, checkpoints._to_cpu, train.serialize.dump = save, to_cpu, dump
    train.train, train.evaluate, tracking._WANDB = spy_train, spy_evaluate, False
    out = {}
    try:
        reset_counts()
        t = time.perf_counter()
        try:
            train.worker_fn(cfgs)
        except Stop:
            pass
        out["stopped_s"] = time.perf_counter() - t
        t = time.perf_counter()
        ids = train.worker_fn([dataclasses.replace(c, resume=True) for c in cfgs])
        out["resumed_s"] = time.perf_counter() - t
        out["launches"] = counts()
    finally:
        os.chdir(cwd)
        checkpoints.save, checkpoints._to_cpu, train.serialize.dump = real["save"], real["to_cpu"], real["dump"]
        train.train, train.evaluate, tracking._WANDB = real["train"], real["evaluate"], real["wandb"]
    (rt,), _, steps = seen["train"]
    params = parallel.to_host(rt.mesh, rt.ts.params)
    out |= {"ids": ids, "steps": steps, "writes": writes, "stopped": seen.get("stopped"),
            "eval": [(m.l0, m.normalized_mse, m.n_dead) for m in seen["eval"]], "files_bitwise": [],
            "ckpts": sorted(str(p.relative_to(base.runs_root / ".train_state"))
                            for p in (base.runs_root / ".train_state").glob("*/step_*"))}
    for si, run_id in enumerate(ids):
        _, got, _ = nn.load(base.runs_root / run_id / "checkpoint" / "sae.pt", device=device)
        out["files_bitwise"].append(all(np.array_equal(got[k].cpu().numpy(), params[k][si]) for k in got))
    return out


def _bits_checksum(t: torch.Tensor, rows: int = 1024) -> list[int]:
    """Two int64 sums of an f32 tensor's bits (plain, and weighted by the
    position mod a prime), a block of rows at a time: equal sums say the
    tensors are the same bits, but for a chance collision."""
    flat = t.reshape(t.shape[0], -1)
    a = b = 0
    for start in range(0, flat.shape[0], rows):
        v = flat[start : start + rows].reshape(-1).view(torch.int32).to(torch.int64)
        pos = torch.arange(start * flat.shape[1], start * flat.shape[1] + v.numel(), device=t.device) % 1000003
        a += int(v.sum())
        b += int((v * pos).sum())
    return [a, b]


def _multi_feature(dims: dict, device, mesh, optim: str = "adam") -> dict:
    """(e), (f) and the Muon step: one seeded SAE with dims["dead"] latents
    pinned, through `make_step_router` at feature_parallel = the mesh's
    feature axis, from one step before AuxK starts, on seeded global
    batches of which this rank takes its rows. Returns each step's stats
    (the same on every rank), ms, route and TopK threshold, whether each
    threshold is bit for bit K6 (its wide route past 32768 columns) on the
    whole rows the feature group gathers, the first step's whole
    pre-activations' checksum, the launches, and the whole params. At
    world 1 the one-rank reference."""
    from saev_tpu_torch import ops, parallel
    from saev_tpu_torch.framework import train
    from saev_tpu_torch.nn import modeling, objectives
    from saev_tpu_torch.ops import cuda_kth

    cfg = modeling.SparseAutoencoderConfig(
        d_model=dims["d_model"], d_sae=dims["d_sae"],
        activation=modeling.TopK(top_k=dims["top_k"], aux=modeling.AuxK(k_aux=dims["k_aux"])),
    )
    obj = objectives.Matryoshka(n_prefixes=dims["n_prefixes"])
    world, rank = parallel.process_count(), parallel.process_index()
    gen = torch.Generator(device).manual_seed(SEED + 13)
    ts = train.init_sweep_state(cfg, 1, gen, device, optim=optim)
    _pin_dead(ts, dims["dead"])
    xs = [torch.randn((dims["batch"], dims["d_model"]), generator=gen, device=device) for _ in range(dims["steps"])]
    prefixes = torch.from_numpy(objectives.sample_prefixes(
        dims["d_sae"], dims["n_prefixes"], rng=np.random.default_rng(SEED + 14))[None]).to(device)
    hp = {"lr": torch.full((1,), 4e-4, device=device), "n_lr_warmup": torch.full((1,), 500.0, device=device),
          "grad_clip": torch.ones((1,), device=device), "sparsity_coeff": torch.zeros((1,), device=device),
          "aux_alpha": torch.full((1,), 1 / 32, device=device)}
    router = train.make_step_router(cfg, obj, 6000, dims["batch"], optim=optim, mesh=mesh)
    names = {id(router.step_fn_warm): "warm", id(router.step_fn): "dense"}
    names |= {id(fn): ("tight", "wide")[i] for i, (_, fn) in enumerate(router.step_fn_subs)}
    start = router.aux_from_step - 1
    ts = ts._replace(step=torch.full((), start, dtype=torch.int32, device=device))
    axes = parallel.latent_axes(ts, dims["d_sae"])
    ts = parallel.shard_features(mesh, ts, dims["d_sae"])
    seen, real = [], ops.topk_stats

    def spy(h, k, *, group=None):
        st = real(h, k, group=group)
        seen.append((h.detach().clone(), st.kth.clone()))
        return st

    rows = dims["batch"] // world
    out = {"stats": [], "ms": [], "route": []}
    ops.topk_stats = spy
    try:
        reset_counts()
        for i, x in enumerate(xs):
            x = x[rank * rows : (rank + 1) * rows].contiguous()
            fn = router.step_fn_at(start + i)
            out["route"].append(names[id(fn)])
            _sync(device)
            t = time.perf_counter()
            ts, stats = fn(ts, parallel.shard_batch(mesh, x), prefixes, hp)
            _sync(device)
            out["ms"].append((time.perf_counter() - t) * 1e3)
            router.record_stats(start + i, stats)
            out["stats"].append(parallel.to_host(mesh, stats))
        out["launches"], out["helpers"] = counts(), helper_counts()
    finally:
        ops.topk_stats = real
    del xs
    out["kth"], out["kth_whole"] = [], []
    for i, (h, kth) in enumerate(seen):
        whole = parallel.gather_cols(h, mesh.feature)
        want = cuda_kth.kth_value_cuda(whole, dims["top_k"])
        out["kth_whole"].append(torch.equal(kth.view(torch.int32), want.view(torch.int32)))
        out["kth"].append(kth.cpu().numpy())
        if i == 0:
            out["h0_checksum"] = _bits_checksum(whole)
        del whole, want
    seen.clear()
    out["params"] = parallel.to_host(mesh, ts.params, axes.params)
    return out


def _multi_feature_collectives(dims: dict, device, mesh) -> dict:
    """ms of the feature group's collectives in (e)'s step, 3 each after one
    warm-up, each behind a barrier and timed to the card's end: the prefix
    MSE's base all-reduce ((J, B, D) f32), the sharded threshold's bound
    (a key a row, all-reduce max) and its candidate gathers (k and k_aux a
    row, f32)."""
    from saev_tpu_torch import parallel

    base = torch.zeros((dims["n_prefixes"], dims["batch"], dims["d_model"]), device=device)
    keys = torch.zeros((dims["batch"], 1), dtype=torch.int32, device=device)
    cand = torch.zeros((dims["batch"], dims["top_k"]), device=device)
    cand_aux = torch.zeros((dims["batch"], dims["k_aux"]), device=device)
    out = {"base_mib": base.numel() * 4 / 2**20}
    for name, fn in (("base_all_reduce", lambda: parallel.all_reduce(base, "sum", mesh.feature)),
                     ("kth_bound", lambda: parallel.all_reduce(keys, "max", mesh.feature)),
                     ("kth_candidates", lambda: parallel.gather_cols(cand, mesh.feature)),
                     ("aux_candidates", lambda: parallel.gather_cols(cand_aux, mesh.feature))):
        fn()
        out[name] = []
        for _ in range(3):
            parallel.sync()
            _sync(device)
            t = time.perf_counter()
            fn()
            _sync(device)
            out[name].append((time.perf_counter() - t) * 1e3)
    return out


def _feature_kernel_parity() -> list[str]:
    """K1's threshold entry at (e)'s shard shape (2 ranks) and through the
    wide route, bit for bit K1 on the same rows (K1's kth given) and against
    its plain version; the sharded threshold's candidate step, plain and
    masked (5% of the columns, K5's bound), against its plain version as
    each row's multiset; each one's ms beside its plain version's."""
    from saev_tpu_torch.ops import cuda_kth, cuda_topk, topk

    gen, lines = _gen(), []
    for b, s in ((B, D_SAE // 2), (4096, D_SAE_WIDE)):
        h = torch.randn((b, s), generator=gen, device="cuda")
        k1 = cuda_topk.topk_stats_cuda(h, TOP_K)
        given = cuda_topk.topk_stats_given_cuda(h, k1.kth)
        plain = topk._topk_stats_plain(h, None, k1.kth)
        same_k1 = (torch.equal(given.f.view(torch.int16), k1.f.view(torch.int16)) and torch.equal(given.live, k1.live)
                   and torch.equal(given.l0, k1.l0) and torch.equal(given.l1.view(torch.int32), k1.l1.view(torch.int32)))
        l1_rel = float(((given.l1 - plain.l1).abs() / plain.l1.abs()).max())
        same_plain = (torch.equal(given.f.view(torch.int16), plain.f.view(torch.int16))
                      and torch.equal(given.live, plain.live) and torch.equal(given.l0, plain.l0))
        require(same_k1 and same_plain and l1_rel <= 1e-5,
                f"multi: K1's threshold entry at {b} x {s}: K1's bits {same_k1}, plain f, live, L0 {same_plain}, "
                f"L1 rel err {l1_rel:.3g}")
        ms = _time(lambda: cuda_topk.topk_stats_given_cuda(h, k1.kth), 10)
        k1_ms = _time(lambda: cuda_topk.topk_stats_cuda(h, TOP_K), 10)
        plain_ms = _time(lambda: topk._topk_stats_plain(h, None, k1.kth), 2)
        # h and kth read; f, live (int32 on the card), L0 and L1 written; a compare an element.
        bnd = bound((h, k1.kth, given.f, s * 4, given.l0, given.l1), h.numel(), F32_OPS_S)
        lines.append(f"multi: K1's threshold entry at {b} x {s}: f, live, L0, L1 bit for bit K1's, f, live, L0 its "
                     f"plain version's, L1 within {l1_rel:.3g}; {ms:.3f} ms against K1's {k1_ms:.3f}, plain "
                     f"{plain_ms:.3f} ms, bound {bnd['bound_ms']:.3f} ms ({bnd['bound_by']})")
        del h, k1, given, plain
    h = torch.randn((B, D_SAE // 2), generator=gen, device="cuda")
    mask = torch.rand((D_SAE // 2,), generator=gen, device="cuda") < 0.05
    for what, m, k in (("plain", None, TOP_K), ("masked", mask, K_AUX)):
        t0 = cuda_kth.kth_value_cuda(h, k) if m is None else cuda_kth.kth_value_masked_cuda(h, m, k)
        got = cuda_kth.kth_candidates_cuda(h, m, t0, k)
        want = topk._kth_candidates_plain(h, m, t0, k)
        same = torch.equal(torch.sort(got, dim=1).values.view(torch.int32),
                           torch.sort(want, dim=1).values.view(torch.int32))
        require(same, f"multi: the candidate step ({what}, k {k}) differs from its plain version")
        ms = _time(lambda: cuda_kth.kth_candidates_cuda(h, m, t0, k), 10)
        plain_ms = _time(lambda: topk._kth_candidates_plain(h, m, t0, k), 2)
        lines.append(f"multi: the candidate step ({what}, {B} x {D_SAE // 2}, k {k}) each row's multiset its plain "
                     f"version's; {ms:.3f} ms, plain {plain_ms:.3f} ms")
    for line in lines:
        log(line)
    return lines


def _multi_rank(rank: int, world: int, port: int, backend: str, root: str, dims: dict, shard_dirs: tuple) -> None:
    """One rank of the multi phase, on card `rank` over NCCL, else on cuda:0:
    joins the process group, runs every case, times the collectives, runs
    the job, and saves what it measured to root/multi_rank<rank>.pt (params,
    rank 0's only); a failure is saved there too."""
    import traceback

    from saev_tpu_torch import parallel

    root = pathlib.Path(root)
    out = {}
    try:
        if not torch.cuda.is_available():
            raise RuntimeError(f"multi rank {rank}: no CUDA device")
        device = parallel.init_distributed(
            torch.device("cuda", rank if backend == "nccl" else 0),
            backend=backend, rank=rank, world_size=world, init_method=f"tcp://localhost:{port}",
            timeout=datetime.timedelta(seconds=MULTI_TIMEOUT_S),
        )
        out["device"] = str(device)
        with plain_spy() as plain:
            out["data"] = _multi_steps(dims, device, parallel.make_mesh(), "data")
            out["sweep"] = _multi_steps(dims, device, parallel.make_mesh(sweep=world), "sweep")
            out["batch_topk"] = _multi_steps(dims, device, parallel.make_mesh(), "batch_topk")
            out["collectives"] = _multi_collectives(dims, device)
            out["job"] = _multi_job(dims["job"], device, root, *shard_dirs)
            torch.cuda.empty_cache()
            feature = parallel.make_mesh(feature=world)
            out["feature"] = _multi_feature(MULTI_FEATURE, device, feature)
            out["feature_collectives"] = _multi_feature_collectives(MULTI_FEATURE, device, feature)
            out["feature_muon"] = _multi_feature(dict(MULTI_FEATURE, steps=1), device, feature, "muon")
            torch.cuda.empty_cache()
            out["feature_wide"] = _multi_feature(MULTI_FEATURE_WIDE, device, feature)
        out["plain"] = dict(plain)
        for case in ("data", "sweep", "batch_topk") + MULTI_FEATURE_CASES:
            params = out[case].pop("params")
            out[case]["digest"] = hashlib.sha256(b"".join(params[k].tobytes() for k in sorted(params))).hexdigest()
            if rank == 0:
                out[case]["params"] = params
    except BaseException:  # noqa: BLE001 - saved for the parent, then the rank exits non-zero
        out["error"] = traceback.format_exc()
    finally:
        torch.save(out, root / f"multi_rank{rank}.pt")
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    if "error" in out:
        raise SystemExit(1)


def run_multi(root: pathlib.Path) -> dict:
    """The multi phase's work on the card: the one-rank reference of each
    case in this process, then the ranks of `multi_layout` (`_multi_rank`)
    spawned together on the job's shards, written here first. Raises if a
    rank fails, or any is still running after MULTI_LIMIT seconds (then
    every rank is killed). Returns the layout, the dims, the reference and
    each rank's results."""
    import multiprocessing
    import socket

    from saev_tpu_torch import parallel

    world, backend = multi_layout()
    dims = multi_dims(world)
    dev = torch.device("cuda")
    ref = {case: _multi_steps(dims, dev, parallel.make_mesh(), case) for case in ("data", "sweep", "batch_topk")}
    for case, fdims, optim in (("feature", MULTI_FEATURE, "adam"), ("feature_muon", dict(MULTI_FEATURE, steps=1), "muon"),
                               ("feature_wide", MULTI_FEATURE_WIDE, "adam")):
        torch.cuda.empty_cache()
        ref[case] = _multi_feature(fdims, dev, parallel.make_mesh(), optim)
    _sync(dev)
    torch.cuda.empty_cache()
    job = dims["job"]
    gen = torch.Generator(dev).manual_seed(SEED + 7)
    basis = torch.randn((job["rank"], job["d_model"]), generator=gen, device=dev) * (
        job["signal"] / job["active"] ** 0.5)
    shards_root = root / "saev" / "shards"
    shards_root.mkdir(parents=True)
    shard_dirs = (_job_shards(shards_root, job["train_examples"], job, basis, SEED + 8),
                  _job_shards(shards_root, job["val_examples"], job, basis, SEED + 9))
    del basis

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_multi_rank, args=(r, world, port, backend, str(root), dims, shard_dirs))
             for r in range(world)]
    t = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + MULTI_LIMIT
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    stalled = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(30)
    spawn_s = time.perf_counter() - t
    ranks = [torch.load(root / f"multi_rank{r}.pt", weights_only=False) if (root / f"multi_rank{r}.pt").exists()
             else {"error": "no result"} for r in range(world)]
    errors = {r: res["error"] for r, res in enumerate(ranks) if "error" in res}
    require(not stalled and not errors and all(p.exitcode == 0 for p in procs),
            f"multi: ranks stalled past {MULTI_LIMIT} s: {stalled}; exit codes {[p.exitcode for p in procs]}; "
            + "".join(f"\n--- rank {r}\n{e}" for r, e in errors.items()))
    return {"world": world, "backend": backend, "dims": dims, "ref": ref, "ranks": ranks, "spawn_s": spawn_s}


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def check_multi(out: dict) -> list[str]:
    """Holds the ranks to the one-rank reference; returns the log lines.
    Every check runs before it raises, with all that failed."""
    ref, ranks, dims, world = out["ref"], out["ranks"], out["dims"], out["world"]
    lines, failed = [], []

    def require(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)
    for case in ("data", "sweep", "batch_topk") + MULTI_FEATURE_CASES:
        digests = {r["device"]: r[case]["digest"] for r in ranks}
        require(len(set(digests.values())) == 1, f"multi {case}: the ranks' cohorts differ: {digests}")
    # (a) data-parallel: within rounding of the one-rank step.
    got, want = ranks[0]["data"], ref["data"]
    stat_err = max(_rel(g[k], w[k]) for g, w in zip(got["stats"], want["stats"])
                   for k in ("loss", "mse", "aux", "l0", "grad_norm"))
    param_err = max(rel_norm(torch.from_numpy(got["params"][k]), torch.from_numpy(want["params"][k]))
                    for k in want["params"])
    require(all(np.array_equal(g["n_dead"], w["n_dead"]) for g, w in zip(got["stats"], want["stats"])),
            "multi data: n_dead differs from the one-rank step")
    require(stat_err <= MULTI_DATA_STAT_REL and param_err <= MULTI_DATA_PARAM_REL,
            f"multi data: stats rel err {stat_err:.3g} (<= {MULTI_DATA_STAT_REL}), params rel-norm {param_err:.3g} "
            f"(<= {MULTI_DATA_PARAM_REL})")
    lines.append(f"multi data (n_data {world}): {dims['steps']} steps against the one-rank step: stats (loss, mse, "
                 f"aux, l0, grad_norm) max rel err {stat_err:.3g}, params max rel-norm {param_err:.3g}, n_dead equal")
    # (b) sweep-parallel: each SAE's bits, as in the one-rank sweep.
    got, want = ranks[0]["sweep"], ref["sweep"]
    same = {k: np.array_equal(got["params"][k].view(np.int32), want["params"][k].view(np.int32))
            for k in want["params"]}
    same_stats = all(np.array_equal(g[k], w[k]) for g, w in zip(got["stats"], want["stats"]) for k in w)
    require(all(same.values()) and same_stats, f"multi sweep: params bit for bit {same}, stats {same_stats}")
    lines.append(f"multi sweep (sweep_parallel {world}, one SAE a rank): params and stats of {dims['steps']} steps "
                 "bit for bit the one-rank sweep's")
    # (c) BatchTopK at n_data = world: the batch-global threshold.
    got, want = ranks[0]["batch_topk"], ref["batch_topk"]
    thr_err = max(_rel(g, w) for g, w in zip(got["threshold"], want["threshold"]))
    first_same = np.array_equal(got["threshold"][0], want["threshold"][0])
    require(thr_err <= MULTI_THRESHOLD_REL, f"multi batch_topk: threshold rel err {thr_err:.3g}")
    lines.append(f"multi batch_topk (n_data {world}): thresholds {[t.tolist() for t in got['threshold']]} against "
                 f"the one-rank step's, max rel err {thr_err:.3g} (first step bit for bit: {first_same})")
    # Every rank launched K1-K5 on the TopK steps, K2-K5 on BatchTopK's, and
    # no plain version.
    for r, res in enumerate(ranks):
        require(res["device"].startswith("cuda"), f"multi rank {r}: ran on {res['device']}")
        require(not res["plain"], f"multi rank {r}: plain versions ran on the card: {res['plain']}")
        for case, kernels in (("data", MULTI_STEP_KERNELS), ("sweep", MULTI_STEP_KERNELS),
                              ("batch_topk", MULTI_STEP_KERNELS[1:]), ("job", JOB_KERNELS)):
            for k in kernels:
                require(res[case]["launches"][k] > 0, f"multi rank {r} {case}: kernel {k} was never launched")
    # (d) the job: rank 0 writes, the resume, the files.
    job = dims["job"]
    for r, res in enumerate(ranks):
        j = res["job"]
        want_writes = {"state": job["steps"] // job["ckpt_every"], "sae": 2} if r == 0 else {"state": 0, "sae": 0}
        require(j["writes"] == want_writes and j["stopped"] == job["stop_at"] and j["steps"] == job["steps"],
                f"multi job rank {r}: writes {j['writes']} (want {want_writes}), stopped at {j['stopped']}, "
                f"{j['steps']} steps")
        require(len(j["ids"]) == (2 if r == 0 else 0), f"multi job rank {r}: ids {j['ids']}")
        for l0, nmse, _ in j["eval"]:
            require(job["top_k"] <= l0 <= job["top_k"] + 1e-3 and np.isfinite(nmse), f"multi job: eval {j['eval']}")
    # (e), (f) and the Muon step: feature-parallel against the one-rank step.
    for case in MULTI_FEATURE_CASES:
        got, want = ranks[0][case], ref[case]
        width = (MULTI_FEATURE_WIDE if case == "feature_wide" else MULTI_FEATURE)["d_sae"]
        require(all(all(r[case]["kth_whole"]) for r in ranks),
                f"multi {case}: a TopK threshold differs from K6 on the whole rows: "
                f"{[r[case]['kth_whole'] for r in ranks]}")
        require(all(r[case]["route"] == want["route"] for r in ranks) and all(want["kth_whole"]),
                f"multi {case}: routes {[r[case]['route'] for r in ranks]}, one rank {want['route']}")
        if case != "feature_muon":
            require(want["route"] == MULTI_FEATURE_ROUTE, f"multi {case}: one rank's route {want['route']}")
        require(all(np.array_equal(g["n_dead"], w["n_dead"]) for g, w in zip(got["stats"], want["stats"])),
                f"multi {case}: n_dead {[g['n_dead'].tolist() for g in got['stats']]}, one rank "
                f"{[w['n_dead'].tolist() for w in want['stats']]}")
        same_h = got["h0_checksum"] == want["h0_checksum"]
        rows_same = int((got["kth"][0].view(np.int32) == want["kth"][0].view(np.int32)).sum())
        require(not same_h or rows_same == len(want["kth"][0]),
                f"multi {case}: the first step's pre-activations are the one rank's bits, its threshold differs "
                f"in {len(want['kth'][0]) - rows_same} rows")
        stat_err = max(_rel(g[k], w[k]) for g, w in zip(got["stats"], want["stats"])
                       for k in ("loss", "mse", "aux", "l0", "l1", "grad_norm"))
        param_err = max(rel_norm(torch.from_numpy(got["params"][k]), torch.from_numpy(want["params"][k]))
                        for k in want["params"])
        require(stat_err <= MULTI_FEATURE_STAT_REL and param_err <= MULTI_FEATURE_PARAM_REL,
                f"multi {case}: stats rel err {stat_err:.3g} (<= {MULTI_FEATURE_STAT_REL}), params rel-norm "
                f"{param_err:.3g} (<= {MULTI_FEATURE_PARAM_REL})")
        lines.append(
            f"multi {case} (feature_parallel {world}, d_sae {width}, {len(want['route'])} steps {want['route']}): every "
            f"TopK threshold bit for bit K6 on the whole rows; the first step's pre-activations the one rank's bits "
            f"{same_h}, its threshold the one rank's in {rows_same} of {len(want['kth'][0])} rows; stats (loss, mse, "
            f"aux, l0, l1, grad_norm) max rel err {stat_err:.3g}, params max rel-norm {param_err:.3g}, n_dead "
            f"{[int(g['n_dead'][0]) for g in got['stats']]} and the route equal")
    for r, res in enumerate(ranks):
        for case in ("feature", "feature_wide"):
            for k in MULTI_FEATURE_KERNELS:
                require(res[case]["launches"][k] > 0, f"multi rank {r} {case}: kernel {k} was never launched")
            for k in MULTI_FEATURE_HELPERS:
                require(res[case]["helpers"][k] > 0, f"multi rank {r} {case}: {k} was never launched")
            require(res[case]["launches"]["grouped_prefix_err"] == 0 and res[case]["launches"]["topk_stats"] == 0,
                    f"multi rank {r} {case}: K2 or K1's select launched: {res[case]['launches']}")
    j0 = ranks[0]["job"]
    require(all(j0["files_bitwise"]) and len(j0["files_bitwise"]) == 2, f"multi job: files {j0['files_bitwise']}")
    require(len(j0["ckpts"]) == 1 and j0["ckpts"][0].endswith(f"step_{job['steps']:08d}"),
            f"multi job: checkpoints left {j0['ckpts']}")
    lines.append(f"multi job (world {world}, data-parallel): stopped at step {j0['stopped']} in {j0['stopped_s']:.1f} s, "
                 f"resumed to step {j0['steps']} with eval and files in {j0['resumed_s']:.1f} s; rank 0 wrote "
                 f"{j0['writes']['state']} checkpoints and {j0['writes']['sae']} SAE files, the others none; eval "
                 f"(l0, normalized_mse, n_dead) {j0['eval']}; files load with nn.load bit for bit")
    for line in lines:
        log(line)
    globals()["require"](not failed, "multi: " + "; ".join(failed))
    return lines


def phase_multi(root: pathlib.Path) -> dict:
    """Training over torch.distributed at the steady phase's shape
    (`multi_dims`), on the ranks of `multi_layout`: the data-parallel,
    sweep-parallel and BatchTopK steps held to the one-rank step, a
    checkpointed, stopped and resumed worker_fn job, and feature-parallel
    training (K1's threshold entry and the candidate step first held to K1
    and their plain versions); K1-K7 launched on every rank. Logs ms/step of
    each case beside the one-rank step, and the collectives' ms. Returns the
    launches, summed over the ranks, K1's threshold entry's in K1's."""
    from saev_tpu_torch.ops import _build

    _build.lib()  # built here, before the ranks start: each would build it otherwise
    _feature_kernel_parity()
    torch.cuda.empty_cache()
    world, backend = multi_layout()
    if backend == "gloo":
        log(f"multi: {torch.cuda.device_count()} card(s): {world} ranks on cuda:0 over gloo (NCCL takes one card "
            "a rank); their times share the card")
    else:
        log(f"multi: {world} ranks over NCCL, one card each")
    out = run_multi(root)
    for case in ("data", "sweep", "batch_topk") + MULTI_FEATURE_CASES:
        ref_ms = out["ref"][case]["ms"]
        log(f"multi {case}: ms/step " + "; ".join(
            f"rank {r} {[round(t, 2) for t in res[case]['ms']]}" for r, res in enumerate(out["ranks"]))
            + f"; one rank {[round(t, 2) for t in ref_ms]} ({backend}, {world} ranks)")
    for r, res in enumerate(out["ranks"]):
        c = res["collectives"]
        log(f"multi rank {r} collectives ({backend}, {world} ranks): all_reduce_mean of {c['bucket_mib']:.1f} MiB "
            f"{[round(t, 2) for t in c['all_reduce_mean']]} ms, gather_rows of {c['rows_mib']:.1f} MiB a rank "
            f"{[round(t, 2) for t in c['gather_rows']]} ms")
        c = res["feature_collectives"]
        log(f"multi rank {r} feature collectives ({backend}, {world} ranks): base all-reduce of {c['base_mib']:.1f} "
            f"MiB {[round(t, 2) for t in c['base_all_reduce']]} ms, threshold bound all-reduce "
            f"{[round(t, 3) for t in c['kth_bound']]} ms, candidate gathers (k {TOP_K}) "
            f"{[round(t, 3) for t in c['kth_candidates']]} ms, (k_aux {K_AUX}) "
            f"{[round(t, 3) for t in c['aux_candidates']]} ms")
    if backend == "gloo":
        log("multi: over gloo the ranks share one card and each collective goes through the host: the feature "
            "cases' times record the path, not a speedup")
    check_multi(out)
    log(f"multi: ranks ran {out['spawn_s']:.1f} s in all, start-up included")
    cases = ("data", "sweep", "batch_topk", "job") + MULTI_FEATURE_CASES
    given = sum(res[case]["helpers"]["topk_stats_given"] for res in out["ranks"] for case in MULTI_FEATURE_CASES)
    cand = sum(res[case]["helpers"]["kth_candidates"] for res in out["ranks"] for case in MULTI_FEATURE_CASES)
    log(f"multi: K1's threshold entry launched {given} times, the candidate step {cand}, summed over the ranks")
    launches = {k: sum(res[case]["launches"][k] for res in out["ranks"] for case in cases) for k in KERNELS}
    launches["topk_stats"] += given
    return launches


TD = dict(tokens=1 << 20, d_sae=D_SAE, nnz_row=TOP_K, n_classes=10, pairs=16, max_iter=30, d_model=D_MODEL,
          patch_tokens=256, train_images=128, test_images=64, clusters=64, centers=4096, n_train_fv=4096,
          batch=B, scorer_batches=3, kmeans_k=D_SAE)
TD_KERNELS = ("kth_value",)
# Sampled (latent, class) pairs against the dense float64 reference: the
# tolerance of tests/test_probe1d.py::test_sparse_matches_reference.
TD_REF_RTOL, TD_REF_ATOL = 1e-3, 1e-4
TD_INERTIA_REL = 1e-5  # the k-means step's inertia against float64 distances on the card


def _td_probe_data(dims: dict, seed: int):
    """A CSR x of `tokens` rows x `d_sae` latents as a TopK SAE writes it:
    `nnz_row` nonzeros a row, one in each of `nnz_row` equal bins of the
    latents at an offset drawn as floor(bin * u^3) (so latents fire at skewed
    rates), values 0.1 + Exp(1); the last latent never fires. One class a
    token out of `n_classes`: 0 with probability 1/2, else uniform, then,
    where latent c * bin fires with value v, c with probability
    sigmoid(2v - 2) (a planted pair for each class c >= 1). Returns (x,
    labels, the planted latents)."""
    import scipy.sparse

    rng = np.random.default_rng(seed)
    n, s, k, n_classes = dims["tokens"], dims["d_sae"], dims["nnz_row"], dims["n_classes"]
    width = s // k
    offsets = np.floor(width * rng.random((n, k)) ** 3).astype(np.int32)
    cols = offsets + np.arange(k, dtype=np.int32) * width
    cols[cols == s - 1] = s - 2
    vals = (0.1 + rng.exponential(size=(n, k))).astype(np.float32)
    x = scipy.sparse.csr_matrix((vals.reshape(-1), cols.reshape(-1), np.arange(0, n * k + 1, k)), shape=(n, s))
    labels = np.where(rng.random(n) < 0.5, 0, rng.integers(1, n_classes, size=n))
    planted = np.arange(1, n_classes) * width
    for c, latent in enumerate(planted, start=1):
        v = np.asarray(x[:, latent].todense()).ravel()
        hit = (v > 0) & (rng.random(n) < 1 / (1 + np.exp(-(2 * v - 2))))
        labels[hit] = c
    return x, labels.astype(np.uint8), planted


@contextlib.contextmanager
def _td_iteration_spy(ms: list):
    """CUDA events around each LM iteration of Sparse1DProbe.fit (the fit
    syncs once an iteration, so each pair of events spans one iteration's
    device work and launch gaps); appends each iteration's ms."""
    from saev_tpu_torch.tdiscovery import probe1d

    real = probe1d.Sparse1DProbe._iteration
    events = []

    def spy(self, *a, **kw):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        out = real(self, *a, **kw)
        t1.record()
        events.append((t0, t1))
        return out

    probe1d.Sparse1DProbe._iteration = spy
    try:
        yield ms
    finally:
        probe1d.Sparse1DProbe._iteration = real
        torch.cuda.synchronize()
        ms.extend(t0.elapsed_time(t1) for t0, t1 in events)


def _td_probe(dims: dict, device: str) -> dict:
    """(a) Sparse1DProbe at `dims`: two fits (the same bits), the sampled
    pairs against Reference1DProbe, the confusion counts of the sampled
    pairs against numpy's."""
    import concurrent.futures

    from saev_tpu_torch.tdiscovery import probe1d

    out = {}
    t0 = time.perf_counter()
    x, labels, planted = _td_probe_data(dims, SEED + 40)
    y = np.eye(dims["n_classes"], dtype=np.float32)[labels]
    out["data_s"] = time.perf_counter() - t0
    nnz = x.getnnz(axis=0)
    plan = probe1d.plan_memory(n_latents=dims["d_sae"], n_classes=dims["n_classes"], nnz=x.nnz,
                               n_samples=dims["tokens"], max_class_slab=8)
    log(f"tdiscovery probe data: {x.shape[0]} tokens x {x.shape[1]} latents, {x.nnz} events "
        f"({12 * x.nnz / 2**20:.0f} MiB on the device), {dims['n_classes']} classes (class shares "
        f"{np.round(np.bincount(labels) / len(labels), 3).tolist()}), latent events {nnz.min()}-{nnz.max()} "
        f"({int((nnz == 0).sum())} empty), made in {out['data_s']:.1f} s; plan: slab {plan.class_slab_size}, "
        f"chunk {plan.event_chunk_size}, {-(-x.nnz // plan.event_chunk_size)} chunks an iteration, slab state "
        f"{plan.slab_bytes / 1e6:.1f} MB")
    fits = []
    for _ in range(2):
        probe = probe1d.Sparse1DProbe(n_latents=dims["d_sae"], n_classes=dims["n_classes"],
                                      max_iter=dims["max_iter"], device=device)
        it_ms = []
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        spy = _td_iteration_spy(it_ms) if device == "cuda" else contextlib.nullcontext()
        t0 = time.perf_counter()
        with spy:
            probe.fit(x, y)
        fit_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else float("nan")
        fits.append(probe)
        log(f"tdiscovery probe fit: {fit_s:.2f} s wall, n_iter_ by slab {sorted(set(probe.n_iter_.tolist()))}, "
            f"{len(it_ms)} LM iterations" + (f" of {statistics.median(it_ms):.2f} ms median "
                                              f"({min(it_ms):.2f}-{max(it_ms):.2f}, CUDA events)" if it_ms else "")
            + f", peak {peak:.2f} GiB")
        out.setdefault("fit_s", []).append(fit_s)
        out.setdefault("iteration_ms", []).append(it_ms)
        out["peak_gib"] = peak
    a, b = fits
    require(all(np.array_equal(p.view(np.int32), q.view(np.int32)) for p, q in
                ((a.intercept_, b.intercept_), (a.coef_, b.coef_))) and np.array_equal(a.n_iter_, b.n_iter_),
            "tdiscovery probe: two fits of the same data differ")

    rng = np.random.default_rng(SEED + 41)
    live = np.flatnonzero(nnz >= 64)
    pairs = [(int(p), c) for c, p in enumerate(planted, start=1)] + [(dims["d_sae"] - 1, 3)]
    while len(pairs) < dims["pairs"]:
        pair = (int(rng.choice(live)), int(rng.integers(dims["n_classes"])))
        if pair not in pairs:
            pairs.append(pair)
    csc = x.tocsc()
    cols = {lat: np.asarray(csc[:, lat].todense()).ravel() for lat, _ in pairs}

    def ref(pair):
        lat, c = pair
        return probe1d.Reference1DProbe(max_iter=dims["max_iter"]).fit(cols[lat], y[:, c])

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        refs = list(pool.map(ref, pairs))
    worst = 0.0
    for (lat, c), r in zip(pairs, refs):
        for got, want in ((a.intercept_[lat, c], r.intercept_), (a.coef_[lat, c], r.coef_)):
            err = abs(float(got) - want)
            worst = max(worst, err / (TD_REF_ATOL + TD_REF_RTOL * abs(want)))
            require(err <= TD_REF_ATOL + TD_REF_RTOL * abs(want),
                    f"tdiscovery probe: pair ({lat}, {c}) {float(got)} against the float64 reference's {want}")
    log(f"tdiscovery probe: {len(pairs)} sampled pairs (the {len(planted)} planted, the empty latent, "
        f"{len(pairs) - len(planted) - 1} drawn) within rtol {TD_REF_RTOL}, atol {TD_REF_ATOL} of the float64 "
        f"reference (worst at {worst:.3f} of the bound; {time.perf_counter() - t0:.1f} s on 8 host threads); "
        f"planted coef_ {[round(float(a.coef_[p, c]), 3) for p, c in pairs[:len(planted)]]}")

    t0 = time.perf_counter()
    loss, tp, fp, tn, fn = a.loss_matrix_with_aux(x, y)
    out["aux_s"] = time.perf_counter() - t0
    for name, m in (("tp", tp), ("fp", fp), ("tn", tn), ("fn", fn)):
        require(bool((m == np.round(m)).all()) and bool((m >= 0).all()), f"tdiscovery probe: {name} not counts")
    require(bool(np.isfinite(loss).all()) and bool(((tp + fp + tn + fn) == dims["tokens"]).all()),
            "tdiscovery probe: loss not finite or counts not summing to the tokens")
    for lat, c in pairs:
        z = a.intercept_[lat, c] + a.coef_[lat, c] * cols[lat].astype(np.float32)
        pred, pos = z > 0, labels == c
        want = [(pred & pos).sum(), (pred & ~pos).sum(), (~pred & ~pos).sum(), (~pred & pos).sum()]
        got = [int(m[lat, c]) for m in (tp, fp, tn, fn)]
        require(got == want, f"tdiscovery probe: counts of ({lat}, {c}) {got}, numpy {want}")
    log(f"tdiscovery probe: loss_matrix_with_aux in {out['aux_s']:.2f} s; tp, fp, tn, fn integers summing to "
        f"{dims['tokens']}, equal to numpy's counts on the {len(pairs)} pairs")
    return out


def _td_sae(dims: dict, device: str, root: pathlib.Path) -> pathlib.Path:
    """A schema-5 TopK SAE file at (d_model, d_sae), random from a seed."""
    from saev_tpu_torch.nn import modeling, serialize

    cfg = modeling.SparseAutoencoderConfig(d_model=dims["d_model"], d_sae=dims["d_sae"],
                                           activation=modeling.TopK(top_k=dims["nnz_row"]))
    params, state = modeling.init(cfg, torch.Generator(device).manual_seed(SEED + 42), device=device)
    fpath = root / "sae.pt"
    serialize.dump(fpath, cfg, params, state)
    return fpath


def _td_scorer(dims: dict, device: str, sae_file: pathlib.Path) -> dict:
    """(b) SparseAutoencoderScorer.transform over `scorer_batches` batches:
    f_x bit for bit the same forward with K6's plain version."""
    from saev_tpu_torch.tdiscovery import saes

    scorer = saes.SparseAutoencoderScorer(str(sae_file), device=device)
    gen = torch.Generator().manual_seed(SEED + 43)
    xs = [torch.randn((dims["batch"], dims["d_model"]), generator=gen).numpy() for _ in range(dims["scorer_batches"])]
    out = {"transform_ms": []}
    for x in xs:
        t0 = time.perf_counter()
        f = scorer.transform(x)
        out["transform_ms"].append((time.perf_counter() - t0) * 1e3)
        nnz = (f != 0).sum(axis=1)
        require(f.shape == (dims["batch"], dims["d_sae"]) and bool(np.isfinite(f).all())
                and int(nnz.min()) >= dims["nnz_row"], f"tdiscovery scorer: f_x {f.shape}, nonzeros {nnz.min()}")
        with _k6_plain():
            f_plain = scorer.transform(x)
        require(np.array_equal(f.view(np.int32), f_plain.view(np.int32)),
                "tdiscovery scorer: f_x differs from the forward with K6's plain version")
    out["scorer"], out["x"] = scorer, xs[0]
    return out


def _td_shards(root: pathlib.Path, n_images: int, dims: dict, centers: np.ndarray, seed: int) -> pathlib.Path:
    """Labelled shards (the port's ShardWriter, labels.bin): each token a
    cluster's centre plus unit noise, its label the cluster's class (cluster
    mod n_classes) 4 times in 5, else a uniform class."""
    from saev_tpu_torch.data import shards

    tokens, d_model = dims["patch_tokens"], dims["d_model"]
    md = shards.Metadata(
        family="clip", ckpt="random", layers=(0,), content_tokens_per_example=tokens, cls_token=False,
        d_model=d_model, n_examples=n_images, max_tokens_per_shard=tokens * 64, data="e30=", dataset=root,
    )
    md.dump(root)
    rng = np.random.default_rng(seed)
    with shards.ShardWriter(root, md) as writer:
        for start in range(0, n_images, 32):
            n = min(32, n_images - start)
            cluster = rng.integers(len(centers), size=(n, tokens))
            acts = centers[cluster] + rng.standard_normal((n, tokens, d_model), dtype=np.float32)
            labels = np.where(rng.random((n, tokens)) < 0.8, cluster % dims["n_classes"],
                              rng.integers(dims["n_classes"], size=(n, tokens)))
            writer.write_batch(acts[:, None].astype(np.float32), start, labels.astype(np.uint8))
    return root / md.hash


def _td_command(root: pathlib.Path, args: list[str], limit: int = 300) -> float:
    """`python -m saev_tpu_torch.tdiscovery ARGS` in root; its seconds."""
    import os

    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(pathlib.Path(__file__).resolve().parent)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "saev_tpu_torch.tdiscovery", *args], cwd=root, env=env,
                          capture_output=True, text=True, timeout=limit)
    took = time.perf_counter() - t0
    require(proc.returncode == 0, f"tdiscovery {args[0]}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    return took


def _td_entry_points(dims: dict, device: str, root: pathlib.Path, sae_file: pathlib.Path) -> dict:
    """(c) The launcher's subcommands on labelled shards, then the FishVista
    evaluation with method sae and kmeans; every artifact loaded back."""
    import scipy.sparse

    from saev_tpu_torch import disk
    from saev_tpu_torch.data import OrderedConfig
    from saev_tpu_torch.tdiscovery import baselines
    from saev_tpu_torch.tdiscovery.fishvista import evaluation

    shards_root, runs_root = root / "saev" / "shards", root / "saev" / "runs"
    shards_root.mkdir(parents=True)
    runs_root.mkdir(parents=True)
    t0 = time.perf_counter()
    centers = (2 * np.random.default_rng(SEED + 44).standard_normal((dims["clusters"], dims["d_model"]))).astype(
        np.float32)
    train = _td_shards(shards_root, dims["train_images"], dims, centers, SEED + 45)
    test = _td_shards(shards_root, dims["test_images"], dims, centers, SEED + 46)
    out = {"shards_s": time.perf_counter() - t0, "commands_s": {}}
    batch = str(min(dims["batch"], dims["test_images"] * dims["patch_tokens"]))
    data = lambda name, d: [f"--{name}.shards", str(d), f"--{name}.layer", "0", f"--{name}.batch-size", batch]  # noqa: E731
    dev = ["--device", device]
    n_train = str(dims["train_images"] * dims["patch_tokens"])
    n_val = str(dims["test_images"] * dims["patch_tokens"])
    out["commands_s"]["baseline::train"] = _td_command(root, [
        "baseline::train", "--method", "kmeans", "--k", str(dims["centers"]), *data("train-data", train),
        "--train-data.buffer-size", "4", "val-data:config", *data("val-data", test), "--val-data.buffer-size", "4",
        "--n-train", n_train, "--n-val", n_val, "--runs-root", str(runs_root), "--seed", str(SEED), *dev])
    (run_dir,) = [p for p in runs_root.iterdir() if not p.name.startswith(".")]
    for split in (train, test):
        out["commands_s"][f"baseline::inference {split.name[:8]}"] = _td_command(root, [
            "baseline::inference", "--run", str(run_dir), *data("data", split), *dev])
    out["commands_s"]["probe1d"] = _td_command(root, [
        "probe1d", "--run", str(run_dir), "--train-shards", str(train), "--test-shards", str(test), *dev])
    out["commands_s"]["metrics"] = _td_command(root, [
        "metrics", "--run", str(run_dir), "--train-shards", str(train), "--test-shards", str(test)])

    run = disk.Run(run_dir)
    km = baselines.load(run, device=device)
    require(km.k == dims["centers"] and km.cluster_centers_.shape == (dims["centers"], dims["d_model"]),
            f"tdiscovery: baseline.pt holds {km.cluster_centers_.shape}")
    train_metrics = json.loads((run_dir / "metrics.json").read_text())
    require("eval/inertia" in train_metrics, f"tdiscovery: metrics.json {sorted(train_metrics)}")
    for split, n_img in ((train, dims["train_images"]), (test, dims["test_images"])):
        art = run.inference / split.name
        acts = scipy.sparse.load_npz(art / "token_acts.npz")
        n_tok = n_img * dims["patch_tokens"]
        require(acts.shape == (n_tok, dims["centers"]) and (np.diff(acts.tocsr().indptr) == 1).all(),
                f"tdiscovery: token_acts {acts.shape}")
        for name, shape in (("sparsity", (dims["centers"],)), ("mean_values", (dims["centers"],)),
                            ("distributions", (n_tok, 25))):
            t = torch.load(art / f"{name}.pt", weights_only=True)
            require(tuple(t.shape) == shape, f"tdiscovery: {name}.pt {tuple(t.shape)}")
        json.loads((art / "metrics.json").read_text())
        with np.load(art / "probe1d_metrics.npz") as fd:
            probe = {k: fd[k] for k in fd}
        require(sorted(probe) == ["biases", "fn", "fp", "loss", "tn", "tp", "weights"]
                and probe["loss"].shape == (dims["centers"], dims["n_classes"])
                and bool(np.isfinite(probe["loss"]).all()), f"tdiscovery: probe1d_metrics.npz {sorted(probe)}")
    trait = json.loads((run.inference / test.name / "trait_metrics.json").read_text())
    with np.load(run.inference / test.name / f"probe1d_metrics__train-{train.name}.npz") as fd:
        require(fd["top_labels"].shape[0] == dims["centers"], "tdiscovery: the metrics npz")
    out["mean_ap"] = trait["mean_ap"]

    ordered = lambda d: OrderedConfig(shards=d, layer=0, batch_size=int(batch))  # noqa: E731
    for method, kw in (("sae", dict(sae_ckpt=str(sae_file))), ("kmeans", dict(baseline_run=str(run_dir)))):
        t0 = time.perf_counter()
        res = evaluation.worker_fn(evaluation.Config(
            method=method, train_acts=ordered(train), test_acts=ordered(test), n_train=dims["n_train_fv"],
            dump_to=root / "results", seed=SEED, device=device, **kw))
        out["commands_s"][f"fishvista {method}"] = time.perf_counter() - t0
        want_k = dims["d_sae"] if method == "sae" else dims["centers"]
        require(res.n_prototypes == want_k and len(res.test_ap_per_class) == dims["n_classes"]
                and (root / "results" / f"fishvista_{method}_{want_k}.json").exists(),
                f"tdiscovery fishvista {method}: {res.n_prototypes} prototypes")
        out[f"fishvista_{method}_map"] = res.mean_ap
    log(f"tdiscovery entry points ({dims['train_images']} + {dims['test_images']} images of "
        f"{dims['patch_tokens']} tokens at d_model {dims['d_model']}, shards written in {out['shards_s']:.1f} s): "
        + "; ".join(f"{k} {v:.1f} s" for k, v in out["commands_s"].items())
        + f"; every artifact loaded; probe mAP {out['mean_ap']:.3f}, fishvista mAP sae "
          f"{out['fishvista_sae_map']:.3f}, kmeans {out['fishvista_kmeans_map']:.3f}")
    return out


def _td_kmeans_step(dims: dict, device: str) -> dict:
    """(d) The k-means step alone at (batch, d_model) x kmeans_k centres:
    its inertia against float64 distances computed on the same device, the
    share of assignments off the float64 argmin, its ms."""
    from saev_tpu_torch.tdiscovery import baselines

    gen = torch.Generator(device).manual_seed(SEED + 47)
    x = torch.randn((dims["batch"], dims["d_model"]), generator=gen, device=device)
    centers = torch.randn((dims["kmeans_k"], dims["d_model"]), generator=gen, device=device)
    with torch.no_grad():
        assign, counts, sums, inertia = baselines.kmeans_step(centers, x)
        x64, c64 = x.double(), centers.double()
        d2 = (x64**2).sum(1, keepdim=True) - 2.0 * (x64 @ c64.T) + (c64**2).sum(1)[None, :]
        min64, arg64 = d2.min(dim=1)
        inertia64 = float(min64.clamp_min(0).mean())
        off = float((assign != arg64).float().mean())
        del d2
    rel = abs(float(inertia) - inertia64) / inertia64
    require(rel <= TD_INERTIA_REL and int(counts.sum()) == dims["batch"],
            f"tdiscovery k-means: inertia {float(inertia)} against float64 {inertia64} (rel {rel:.3g})")
    out = {"inertia_rel": rel, "off_argmin": off}
    if device == "cuda":
        out["step_ms"] = _time(lambda: baselines.kmeans_step(centers, x), 5)
    return out


def run_tdiscovery(dims: dict, device: str, root: pathlib.Path) -> dict:
    """Trait discovery's device path at `dims` (module doc, phase 19): (a)
    the probe, (b) the SAE scorer, (c) the entry points, (d) the k-means
    step. The CPU runs it too, at small `dims`."""
    out = {"probe": _td_probe(dims, device)}
    sae_file = _td_sae(dims, device, root)
    out["scorer"] = _td_scorer(dims, device, sae_file)
    out["entry"] = _td_entry_points(dims, device, root, sae_file)
    out["kmeans"] = _td_kmeans_step(dims, device)
    return out


def phase_tdiscovery() -> dict:
    """Trait discovery on the card at ViT-L/14 width (module doc, phase 19).
    Returns the path's launches (K6 in the scorer and in FishVista's sae
    scoring)."""
    t_phase = time.perf_counter()
    root = pathlib.Path(tempfile.mkdtemp(prefix="saev_tdiscovery_"))
    try:
        reset_counts()
        with plain_spy() as plain:
            out = run_tdiscovery(TD, "cuda", root)
        launches = counts()
        require(not plain, f"tdiscovery: plain versions ran on the card: {plain}")
        n_batches = TD["scorer_batches"] + sum(-(-n * TD["patch_tokens"] // TD["batch"])
                                               for n in (TD["train_images"], TD["test_images"]))
        want = dict.fromkeys(KERNELS, 0) | {"kth_value": n_batches}
        require(launches == want, f"tdiscovery: launches {launches}, expected {want}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    from saev_tpu_torch.nn import modeling
    from saev_tpu_torch.ops import cuda_kth, topk

    sc, km = out["scorer"], out["kmeans"]
    scorer, x = sc.pop("scorer"), torch.from_numpy(sc.pop("x")).cuda()
    with torch.no_grad():
        fwd_ms = _time(lambda: modeling.encode(scorer.cfg, scorer.params, scorer.state, x, training=False,
                                               precision="highest"), 3)
        h = modeling._linear_bias(x, scorer.params["W_enc"], scorer.params["b_enc"], "highest")
    log(f"tdiscovery scorer: transform {statistics.median(sc['transform_ms']):.1f} ms a batch of {TD['batch']} rows "
        f"(median of {TD['scorer_batches']}: upload, forward, f_x's {TD['batch'] * TD['d_sae'] * 4 / 2**30:.0f} GiB "
        f"copy to the host), the forward alone {fwd_ms:.2f} ms (CUDA events, mean of 3); f_x bit for bit the "
        f"forward with K6's plain version; K6 launched {launches['kth_value']} times in the phase (the scorer's "
        f"{TD['scorer_batches']} batches, FishVista's sae scoring), no plain version")
    kth = cuda_kth.kth_value_cuda(h, TOP_K)
    row = timed(_time(lambda: cuda_kth.kth_value_cuda(h, TOP_K), 20), _time(lambda: topk._kth_plain(h, TOP_K), 3),
                _selection_bound(h, kth), library_kth_ms(h, TOP_K, "the scorer's h"))
    log_timing("kth_value", row, f" on the scorer's h {tuple(h.shape)}, k {TOP_K}")
    sc["forward_ms"] = fwd_ms
    log(f"tdiscovery k-means step at {TD['batch']} x {TD['d_model']} x {TD['kmeans_k']}: {km['step_ms']:.2f} ms "
        f"(CUDA events, mean of 5); inertia {km['inertia_rel']:.3g} relative from float64 distances on the card "
        f"(bound {TD_INERTIA_REL}); {100 * km['off_argmin']:.3f}% of assignments off the float64 argmin; the phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    del scorer, x, h, kth
    torch.cuda.empty_cache()
    out["launches"] = launches
    out["kth_value"] = row
    return out


# ---------------------------------------------------------------------------
# interactive_interp: semseg probes, interventions, semprobe, the [CLS] probe
# grid, FishVista's supervised skyline and Bird-MAE's channel trace
# ---------------------------------------------------------------------------

# ViT-L/14 width with ADE20K's 151 classes: 512 train and 256 val images of
# 256 content tokens (the val split is 4 ordered batches of 16384), a TopK-32
# SAE at d_sae 16384 whose first `clusters` latents read and write the
# clusters the tokens are drawn around; the probe grid 3 lr x 2 wd at batch
# 4096 over 131072 tokens.
II = dict(d_model=D_MODEL, tokens=256, n_classes=151, train_images=512, val_images=256, batch=B, d_sae=D_SAE,
          top_k=TOP_K, probe_batch=4096, clusters=302, lrs=(1e-4, 3e-4, 1e-3), wds=(1e-4, 1e-3),
          semprobe_images=64, validate_images=8, examples=8, fv_classes=10, fv_train_images=64, fv_test_images=32,
          fv_batch=4096, cls_classes=3, cls_train=32, cls_val=16, ref_rows=2048, clips=2, bad_channel=295)
II_KERNELS = ("kth_value",)
II_REL_MSE = INTERP_REL_MSE  # a batch's f_x on the card against the CPU's f32 forward


def _ii_sae(dims: dict, device: str, root: pathlib.Path, centers: np.ndarray) -> pathlib.Path:
    """A schema-5 TopK SAE file at (d_model, d_sae), random from a seed but
    for its first `clusters` latents: encoder column and decoder row j the
    unit direction of centre j."""
    from saev_tpu_torch.nn import modeling, serialize

    cfg = modeling.SparseAutoencoderConfig(d_model=dims["d_model"], d_sae=dims["d_sae"],
                                           activation=modeling.TopK(top_k=dims["top_k"]))
    params, state = modeling.init(cfg, torch.Generator(device).manual_seed(SEED + 50), device=device)
    unit = torch.from_numpy(centers / np.linalg.norm(centers, axis=1, keepdims=True)).to(device)
    params["W_enc"][:, : len(centers)] = unit.T
    params["W_dec"][: len(centers)] = unit
    fpath = root / "sae.pt"
    serialize.dump(fpath, cfg, params, state)
    return fpath


def _ii_images(root: pathlib.Path, n_classes: int, n_per: int, seed: int) -> pathlib.Path:
    """An image folder of n_classes x n_per 8 x 8 PNGs."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for c in range(n_classes):
        (root / f"class{c}").mkdir(parents=True)
        for i in range(n_per):
            Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(root / f"class{c}" / f"{i}.png")
    return root


def _ii_cls_shards(root: pathlib.Path, images: pathlib.Path, dims: dict, n_per: int, centers: np.ndarray,
                   seed: int) -> pathlib.Path:
    """[CLS] shards over `images` (its ImgFolder config in the metadata):
    each example's [CLS] row its class's centre plus unit noise, the content
    rows noise."""
    from saev_tpu_torch.data import datasets, shards

    n, tokens, d_model = dims["cls_classes"] * n_per, dims["tokens"], dims["d_model"]
    md = shards.Metadata(
        family="clip", ckpt="random", layers=(0,), content_tokens_per_example=tokens, cls_token=True,
        d_model=d_model, n_examples=n, max_tokens_per_shard=(tokens + 1) * 64,
        data=shards.encode_dataset_cfg(datasets.ImgFolder(root=images)), dataset=images,
    )
    md.dump(root)
    rng = np.random.default_rng(seed)
    with shards.ShardWriter(root, md) as writer:
        for start in range(0, n, 32):
            m = min(32, n - start)
            acts = rng.standard_normal((m, 1, tokens + 1, d_model), dtype=np.float32)
            acts[:, 0, 0] += centers[(start + np.arange(m)) // n_per]
            writer.write_batch(acts, start)
    return root / md.hash


@contextlib.contextmanager
def _ii_step_spy(seen: dict):
    """Each semseg probe step's losses and ms (CUDA events on the card)."""
    from saev_tpu_torch.interactive_interp.semseg import training

    real = training._make_step

    def make(n_classes):
        step = real(n_classes)

        def spy(params, *a):
            cuda = params["w"].is_cuda
            if cuda:
                t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0.record()
            out = step(params, *a)
            if cuda:
                t1.record()
                seen["events"].append((t0, t1))
            seen["losses"].append(out[2].cpu().numpy())
            return out

        return spy

    training._make_step = make
    try:
        yield seen
    finally:
        training._make_step = real
        if seen["events"]:
            torch.cuda.synchronize()
        seen["ms"] = [t0.elapsed_time(t1) for t0, t1 in seen.pop("events")]


def _ii_timed(out: dict, name: str, fn):
    t0 = time.perf_counter()
    res = fn()
    out.setdefault("seconds", {})[name] = time.perf_counter() - t0
    return res


def _ii_semseg(dims: dict, device: str, root: pathlib.Path, out: dict) -> dict:
    """(a) the probe grid, validate, visuals, quantify twice, the
    intervention app."""
    from saev_tpu_torch.data import OrderedConfig
    from saev_tpu_torch.interactive_interp.semseg import __main__ as semseg_main
    from saev_tpu_torch.interactive_interp.semseg import interactive, quantitative, training, validation, visuals

    sh = out["shards"]
    ordered = lambda d, b=dims["batch"]: OrderedConfig(shards=d, layer=0, batch_size=b)  # noqa: E731
    cfgs = [training.Train(shards=sh["train"], layer=0, n_classes=dims["n_classes"], learning_rate=lr,
                           weight_decay=wd, n_train=dims["train_images"] * dims["tokens"],
                           batch_size=dims["probe_batch"], seed=SEED, ckpt_path=root / "probes", device=device)
            for lr in dims["lrs"] for wd in dims["wds"]]
    require(cfgs[0].device == device and training.Train().device == "cuda", "semseg: Train's device")
    seen = {"events": [], "losses": []}
    with _ii_step_spy(seen):
        params = _ii_timed(out, "semseg train", lambda: training.train(cfgs))
    training.dump(cfgs[0].ckpt_path, cfgs, params)
    losses = np.stack(seen["losses"])
    n_steps = -(-cfgs[0].n_train // cfgs[0].batch_size)
    require(losses.shape == (n_steps, len(cfgs)) and bool(np.isfinite(losses).all())
            and bool((losses[-1] < losses[0]).all()) and params["w"].shape == (len(cfgs), dims["d_model"],
                                                                               dims["n_classes"]),
            f"semseg train: losses {losses.shape}, first {losses[0]}, last {losses[-1]}")
    out["probe_losses"], out["probe_step_ms"] = losses, seen["ms"]
    # One probe through the CLI's subcommand, in-process.
    semseg_main.train(dataclasses.replace(cfgs[-1], n_train=dims["probe_batch"], ckpt_path=root / "probe_cli"))
    require((root / "probe_cli" / "probes.npz").exists(), "semseg train subcommand: no probes.npz")

    rows = _ii_timed(out, "validate", lambda: validation.worker_fn(validation.Config(
        probe_ckpt=cfgs[0].ckpt_path, acts=ordered(sh["validate"]), n_classes=dims["n_classes"],
        dump_to=root / "validate")))
    require(len(rows) == len(cfgs) and (root / "validate" / "validation.csv").exists()
            and all(0 <= r["accuracy"] <= 1 for r in rows), f"validate: {rows}")
    out["validate_best"] = rows[0]

    proposals = _ii_timed(out, "visuals", lambda: visuals.worker_fn(visuals.Config(
        sae_ckpt=sh["sae"], acts=ordered(sh["val"]), n_classes=dims["n_classes"], dump_to=root / "visuals",
        device=device)))
    require(len(proposals) > dims["n_classes"] // 2 and (root / "visuals" / "proposed_latents.json").exists(),
            f"visuals: proposals for {len(proposals)} classes")
    out["visuals_classes"] = len(proposals)

    csvs, reports = [], None
    for run in ("a", "b"):
        reports = _ii_timed(out, f"quantify {run}", lambda run=run: quantitative.worker_fn(quantitative.Config(
            sae_ckpt=sh["sae"], probe_ckpt=cfgs[0].ckpt_path, acts=ordered(sh["val"]), n_classes=dims["n_classes"],
            dump_to=root / f"quantify_{run}", device=device)))
        csvs.append((root / f"quantify_{run}" / "results.csv").read_text())
    require(csvs[0] == csvs[1] and len(csvs[0].strip().splitlines()) == 4,
            f"quantify: two runs give different CSVs\n{csvs[0]}\n{csvs[1]}")
    out["quantify"] = {r.method: (round(r.mean_target_change, 4), round(r.mean_other_change, 4),
                                  len(r.class_results)) for r in reports}
    require(all(n > 0 and 0 <= t <= 1 and 0 <= o <= 1 for t, o, n in out["quantify"].values()),
            f"quantify: (target change, other change, classes) {out['quantify']}")

    page = _ii_timed(out, "interactive", lambda: interactive.worker_fn(interactive.Config(
        sae_ckpt=sh["sae"], head_ckpt=cfgs[0].ckpt_path, acts=ordered(sh["val"]), n_classes=dims["n_classes"],
        n_examples=dims["examples"], sparsity_max=0.05, out=root / "app.html", device=device)))
    payload = json.loads(page.read_text().split("const D = ", 1)[1].split(";\nconst P = ", 1)[0])
    require(len(payload["examples"]) == dims["examples"] and payload["candidates"]
            and len(payload["examples"][0]["fx"]) == dims["tokens"], "interactive: the payload")
    out["interactive_candidates"] = len(payload["candidates"])
    return out


def _ii_semprobe_cls_fv(dims: dict, device: str, root: pathlib.Path, out: dict) -> dict:
    """(b) semprobe's score, (c) the [CLS] probe grid, (d) FishVista's
    supervised grid."""
    from saev_tpu_torch.data import OrderedConfig
    from saev_tpu_torch.interactive_interp.classification import __main__ as cls_main
    from saev_tpu_torch.interactive_interp.semprobe import scoring
    from saev_tpu_torch.tdiscovery.fishvista import supervised

    sh = out["shards"]
    n = dims["semprobe_images"]
    labels = tuple(f"{'spots' if i % 2 else 'stripes'}-{'positive' if (i // 2) % 3 else 'negative'}" for i in range(n))
    res = _ii_timed(out, "semprobe score", lambda: scoring.score(scoring.Score(
        sae_ckpt=sh["sae"], shards=sh["semprobe"], labels=labels, threshold=1.0, dump_to=root / "semprobe",
        device=device)))
    require(set(res) == {"spots", "stripes"} and all(r["n_images"] == n // 2 for r in res.values())
            and (root / "semprobe" / "semprobe_scores.json").exists(), f"semprobe: {res}")
    out["semprobe_best_f1"] = {k: v["best_f1"] for k, v in res.items()}

    sweep = root / "cls_sweep.toml"
    sweep.write_text("learning_rate = [1e-3, 1e-4]\nweight_decay = [1e-4, 1e-3]\n")
    cls_cfg = cls_main.training.Train(train_shards=sh["cls_train"], val_shards=sh["cls_val"], layer=0,
                                      ckpt_path=root / "cls", device=device)
    _ii_timed(out, "classification train", lambda: cls_main.train(cls_cfg, sweep=sweep))
    report = json.loads((root / "cls" / "report.json").read_text())
    accs = [r["val_accuracy"] for r in report]
    require(len(report) == 4 and max(accs) > 1 / dims["cls_classes"], f"classification: val accuracies {accs}")
    out["cls_accuracy"] = accs

    ordered = lambda d: OrderedConfig(shards=d, layer=0, batch_size=dims["batch"])  # noqa: E731
    fv = _ii_timed(out, "fishvista supervised", lambda: supervised.worker_fn(supervised.Config(
        train_acts=ordered(sh["fv_train"]), test_acts=ordered(sh["fv_test"]), n_classes=dims["fv_classes"],
        n_train=dims["fv_train_images"] * dims["tokens"], batch_size=dims["fv_batch"], dump_to=root / "fishvista",
        seed=SEED, device=device)))
    require(fv["n_probes"] == 6 and len(fv["best"]["ap_per_class"]) == dims["fv_classes"]
            and np.isfinite(fv["best"]["mean_ap"]), f"fishvista supervised: {fv['best']}")
    out["fv_map"] = fv["best"]["mean_ap"]
    return out


def _ii_shards(dims: dict, device: str, root: pathlib.Path) -> dict:
    """Every input of the phase, from seeds: the labelled shards, the SAE,
    the image folders and their [CLS] shards."""
    shards_root = root / "saev" / "shards"
    shards_root.mkdir(parents=True)
    rng = np.random.default_rng(SEED + 51)
    centers = (2 * rng.standard_normal((dims["clusters"], dims["d_model"]))).astype(np.float32)
    tok = dict(patch_tokens=dims["tokens"], d_model=dims["d_model"], n_classes=dims["n_classes"])
    sh = {name: _td_shards(shards_root, dims[f"{name}_images"], tok, centers, SEED + 52 + i)
          for i, name in enumerate(("train", "val", "semprobe", "validate"))}
    fv_tok = dict(tok, n_classes=dims["fv_classes"])
    sh["fv_train"] = _td_shards(shards_root, dims["fv_train_images"], fv_tok, centers, SEED + 56)
    sh["fv_test"] = _td_shards(shards_root, dims["fv_test_images"], fv_tok, centers, SEED + 57)
    sh["sae"] = _ii_sae(dims, device, root, centers)
    cls_centers = (2 * rng.standard_normal((dims["cls_classes"], dims["d_model"]))).astype(np.float32)
    for split, n_per, seed in (("cls_train", dims["cls_train"], SEED + 58), ("cls_val", dims["cls_val"], SEED + 59)):
        images = _ii_images(root / "images" / split, dims["cls_classes"], n_per, seed)
        sh[split] = _ii_cls_shards(shards_root, images, dims, n_per, cls_centers, seed)
    return sh


def _ii_encodes(dims: dict) -> int:
    """K6 launches of the phase's encodes: one a batch of 16384 rows; the
    f_x check's batch; visuals' pass over val; quantify's two passes (an
    encode a batch for the statistics, one for the interventions); the
    intervention app's aggregate batch (its 8192-token budget) and its
    examples; semprobe's batches of whole images."""
    per = lambda n_images, batch: -(-n_images * dims["tokens"] // batch)  # noqa: E731
    val = per(dims["val_images"], dims["batch"])
    agg = min(val, -(-8192 // dims["batch"]))
    semprobe_batch = max(2048 // dims["tokens"] * dims["tokens"], dims["tokens"])
    return 1 + val + 2 * 2 * val + agg + dims["examples"] + per(dims["semprobe_images"], semprobe_batch)


def _ii_trace(dims: dict, device: str, root: pathlib.Path) -> dict:
    """(e) `trace_report(out_dir=None)` on a random Bird-MAE-Large checkpoint
    (the extract phase's) with channel `bad_channel` planted in the patch
    embedding's bias, on `clips` random clips: on `device` and on the CPU."""
    from saev_tpu_torch.birdsong import trace
    from saev_tpu_torch.models import bird_mae, convert, vit
    from saev_tpu_torch.scripts import vit_route

    spec = bird_mae.PRETRAINED_SPECS["Bird-MAE-Large"]
    # The extract phase's checkpoint, converted as loading converts it.
    params, pos = convert.from_timm(vit_route.bird_mae_state_dict(spec, torch.Generator().manual_seed(SEED + 60)),
                                    spec)
    params["pos"] = bird_mae.pos_table(spec.d_model) if pos is None else pos
    model = bird_mae.Transformer("Bird-MAE-Large", params=params, device=device)
    model.params["patch_embed"]["b"][dims["bad_channel"]] = 50.0
    cpu = bird_mae.Transformer("Bird-MAE-Large", params=vit.to_device(model.params, "cpu"), device="cpu")
    tokens = np.random.default_rng(SEED + 61).normal(size=(dims["clips"], bird_mae.N_PATCHES, 256)).astype(np.float32)
    grid = (bird_mae.N_TIME_PATCHES, bird_mae.N_MEL_PATCHES)
    t0 = time.perf_counter()
    got = trace.trace_report(model, tokens, grid)
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = trace.trace_report(cpu, tokens, grid)
    t_cpu = time.perf_counter() - t0
    require(got["channel"] == want["channel"] == dims["bad_channel"] and got["n_layers"] == spec.n_layers,
            f"birdsong trace: channel {got['channel']} on {device}, {want['channel']} on the CPU, planted "
            f"{dims['bad_channel']}")
    errs = {}
    for key in ("dominance_by_site", "chan_mean"):
        for site in trace.SITES:
            a, b = np.asarray(got[key][site], np.float64), np.asarray(want[key][site], np.float64)
            errs[f"{key} {site}"] = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
    worst = max(errs, key=errs.get)
    require(errs[worst] <= BF16_REL, f"birdsong trace: {worst} {errs[worst]} from the CPU's (bound {BF16_REL})")
    dom = np.asarray(got["dominance_by_site"]["resid"])
    require(bool((dom > 10).all()), f"birdsong trace: resid dominance {dom.min()}")
    return {"seconds": t_dev, "cpu_seconds": t_cpu, "worst": (worst, errs[worst]), "dominance_min": float(dom.min())}


def run_interactive_interp(dims: dict, device: str, root: pathlib.Path) -> dict:
    """The interactive_interp phase's path at `dims` (module doc, phase 20):
    (a) semseg, (b) semprobe, (c) classification, (d) FishVista's supervised
    grid on `device`; (e) the channel trace. The CPU runs it too, at small
    `dims`. Returns what it logs, and the f_x check's batch (card encode,
    its rows) for the CPU reference, which runs after."""
    from saev_tpu_torch import nn
    from saev_tpu_torch.data import OrderedConfig, OrderedDataLoader
    from saev_tpu_torch.interactive_interp.semseg import quantitative
    from saev_tpu_torch.nn import modeling

    out = {}
    out["shards"] = _ii_timed(out, "shards", lambda: _ii_shards(dims, device, root))
    cfg, params, state = nn.load(out["shards"]["sae"], device=device)
    dl = OrderedDataLoader(OrderedConfig(shards=out["shards"]["val"], layer=0, batch_size=dims["batch"]))
    try:
        x = np.asarray(next(iter(dl))["act"], np.float32)
    finally:
        dl.shutdown()
    with torch.no_grad():
        xd = torch.from_numpy(x).to(device)
        f = quantitative.encode_f(cfg, params, state, xd)
        h = modeling._linear_bias(xd, params["W_enc"], params["b_enc"], "highest")
    out["fx_check"] = (x[: dims["ref_rows"]], f[: dims["ref_rows"]].cpu(), h[: dims["ref_rows"]].cpu())
    _ii_semseg(dims, device, root, out)
    _ii_semprobe_cls_fv(dims, device, root, out)
    out["trace"] = _ii_timed(out, "birdsong trace", lambda: _ii_trace(dims, device, root))
    return out


def phase_interactive_interp() -> dict:
    """contrib's interactive interpretability on the card at ViT-L/14 width
    (module doc, phase 20). Returns the path's launches (K6 in every SAE
    encode) and K6's timing at the phase's two shapes."""
    from saev_tpu_torch import nn
    from saev_tpu_torch.data import OrderedConfig, OrderedDataLoader
    from saev_tpu_torch.interactive_interp.semseg import quantitative
    from saev_tpu_torch.nn import modeling
    from saev_tpu_torch.ops import cuda_kth, topk

    t_phase = time.perf_counter()
    card = card_and_limit()
    root = pathlib.Path(tempfile.mkdtemp(prefix="saev_interactive_interp_"))
    try:
        reset_counts()
        with plain_spy() as plain:
            out = run_interactive_interp(II, "cuda", root)
        launches = counts()
        require(not plain, f"interactive_interp: plain versions ran on the card: {plain}")
        want = dict.fromkeys(KERNELS, 0) | {"kth_value": _ii_encodes(II)}
        require(launches == want, f"interactive_interp: launches {launches}, expected {want}")
        # The f_x check: the card's batch against the CPU's f32 forward on its first rows.
        x, f_card, h_card = out.pop("fx_check")
        cfg, params, state = nn.load(out["shards"]["sae"], device="cpu")
        with torch.no_grad():
            f_cpu = quantitative.encode_f(cfg, params, state, torch.from_numpy(x))
            h_cpu = modeling._linear_bias(torch.from_numpy(x), params["W_enc"], params["b_enc"], "highest")
        fx_cmp = topk_vs_cpu(f_card, h_card, f_cpu, h_cpu)
        require_topk_agrees("interactive_interp", fx_cmp, II_REL_MSE)
        # An encode batch's ms split into the whole encode, K6 and the rest;
        # K6 at the phase's two shapes against its plain version, the library
        # and its bound.
        cfg, params, state = nn.load(out["shards"]["sae"], device="cuda")
        dl = OrderedDataLoader(OrderedConfig(shards=out["shards"]["val"], layer=0, batch_size=II["batch"]))
        try:
            xb = torch.from_numpy(np.asarray(next(iter(dl))["act"], np.float32)).cuda()
        finally:
            dl.shutdown()
        with torch.no_grad():
            enc_ms = _time(lambda: quantitative.encode_f(cfg, params, state, xb), 5)
            rows = {}
            for what, h in (("batch", modeling._linear_bias(xb, params["W_enc"], params["b_enc"], "highest")),
                            ("example", modeling._linear_bias(xb[: II["tokens"]], params["W_enc"], params["b_enc"],
                                                              "highest"))):
                kth = cuda_kth.kth_value_cuda(h, TOP_K)
                rows[what] = timed(_time(lambda h=h: cuda_kth.kth_value_cuda(h, TOP_K), 20),
                                   _time(lambda h=h: topk._kth_plain(h, TOP_K), 3), _selection_bound(h, kth),
                                   library_kth_ms(h, TOP_K, f"the interactive_interp {what}'s h"))
                log_timing("kth_value", rows[what], f" on the interactive_interp {what}'s h {tuple(h.shape)}, k "
                                                     f"{TOP_K} ({card})")
            del h, kth
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    k6 = rows["batch"]["ms"]
    sec = out["seconds"]
    log(f"interactive_interp ({card}): " + "; ".join(f"{k} {v:.2f} s" for k, v in sec.items()))
    log(f"interactive_interp semseg ({card}): {len(II['lrs']) * len(II['wds'])} probes, "
        f"{len(out['probe_step_ms'])} steps at batch {II['probe_batch']}, a step {statistics.median(out['probe_step_ms']):.3f} "
        f"ms median ({min(out['probe_step_ms']):.3f}-{max(out['probe_step_ms']):.3f}, CUDA events), losses "
        f"{np.round(out['probe_losses'][0], 3).tolist()} -> {np.round(out['probe_losses'][-1], 3).tolist()}; "
        f"validate best {out['validate_best']}; visuals proposed latents for {out['visuals_classes']} classes; "
        f"quantify (target change, other change, classes) {out['quantify']}, the same CSV twice; the app "
        f"{out['interactive_candidates']} candidate latents")
    log(f"interactive_interp encode ({card}): a batch of {II['batch']} rows at d_sae {II['d_sae']} {enc_ms:.3f} ms "
        f"(CUDA events, mean of 5) = K6 {k6:.3f} + the rest {enc_ms - k6:.3f} (the f32 encoder product, TF32 off, "
        f"and the mask); f_x on {II['ref_rows']} rows: {topk_note(fx_cmp, II_REL_MSE)}; K6 launched "
        f"{launches['kth_value']} times in the phase, as its encodes call it, no plain version")
    tr = out["trace"]
    log(f"interactive_interp semprobe best F1 {out['semprobe_best_f1']}; classification val accuracies "
        f"{out['cls_accuracy']}; fishvista supervised best mAP {out['fv_map']:.4f}; birdsong trace of "
        f"Bird-MAE-Large on {II['clips']} clips, channel {II['bad_channel']} planted and found on the card and "
        f"the CPU, resid dominance at least {tr['dominance_min']:.1f}, the worst of dominance and channel means "
        f"{tr['worst'][0]} {tr['worst'][1]:.3g} rel-norm from the CPU's (bound {BF16_REL}), card {tr['seconds']:.2f} "
        f"s, CPU {tr['cpu_seconds']:.2f} s; the phase {time.perf_counter() - t_phase:.1f} s ({card})")
    return {"launches": launches, "kth_value": rows, "encode_ms": enc_ms, "fx": fx_cmp}



# ---------------------------------------------------------------------------
# contrib_host: trait discovery's classification heads and grounding audit,
# and the mimics project's scores and consistency, on runs that the port's
# inference wrote on the card
# ---------------------------------------------------------------------------

# ViT-L/14 width: two splits (training, validation) of 64 images of 256
# content tokens, each image of one of 4 classes named as Heliconius
# subspecies, about half its patches the class's object (labels.bin: 0
# background, class + 1 object); two runs of a TopK-32 SAE at d_sae 16384
# whose first 4 latents read the classes' centres, the second run's latents
# the first's permuted; inference at batch 4096, 4 batches a split.
CH = dict(d_model=D_MODEL, d_sae=D_SAE, top_k=TOP_K, tokens=256, images=64, batch=4096, n_classes=4,
          ref_rows=2048, min_samples=8, max_budget=1000, clip="ViT-L-14")
CH_KERNELS = ("kth_value",)
CH_SUBSPECIES = ("lativitta_dorsal", "malleti_dorsal", "cyrbia_dorsal", "cythera_dorsal")
CH_PAIR_SPECS = ("lativitta:malleti", "cyrbia:cythera")
CH_PAIRS = (("lativitta_dorsal", "malleti_dorsal"), ("cyrbia_dorsal", "cythera_dorsal"))
# What the phase runs only where its package imports: (what, package).
CH_OPTIONAL = (("tdiscovery.classification cls::train", "sklearn"), ("tdiscovery.clsview.tree_rules", "sklearn"),
               ("tdiscovery.audit_analysis.run_battery", "matplotlib"))


class _MeanHead:
    """A linear head fit by class means (the nearest-mean discriminant:
    coef_ the class means, intercept_ minus half their squared norms), with
    the attributes and methods that cls::eval and cls::audit read from a
    scikit-learn head. The phase writes it, in cls::train's checkpoint
    format, where scikit-learn (which cls::train fits with) is not installed."""

    def __init__(self, x: np.ndarray, y: np.ndarray):
        self.classes_ = np.unique(y)
        self.coef_ = np.stack([x[y == c].mean(axis=0) for c in self.classes_]).astype(np.float64)
        self.intercept_ = -0.5 * (self.coef_**2).sum(axis=1)

    def decision_function(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(x, np.float64) @ self.coef_.T + self.intercept_

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        z = self.decision_function(x)
        e = np.exp(z - z.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)

    def predict(self, x: np.ndarray) -> np.ndarray:
        return self.classes_[self.decision_function(x).argmax(axis=1)]


def _ch_split(seg_root: pathlib.Path, shards_root: pathlib.Path, split: str, dims: dict, centers: np.ndarray,
              rng, ckpt: str) -> tuple[pathlib.Path, list[str]]:
    """One split: an ImgSegFolder of 8 x 8 PNGs and their masks (each pixel
    the image's class + 1) (the shards' dataset config; its labels.csv rows
    returned) and its shards (the port's writer, labels.bin, `ckpt` the
    model named in its metadata): an object patch its class's centre plus
    unit noise, a background patch unit noise."""
    from PIL import Image

    from saev_tpu_torch.data import datasets, shards

    n, tokens, d_model = dims["images"], dims["tokens"], dims["d_model"]
    (seg_root / "images" / split).mkdir(parents=True)
    (seg_root / "annotations" / split).mkdir(parents=True)
    rows, cls = [], np.arange(n) % dims["n_classes"]
    for i in range(n):
        stem = f"{split}{i:04d}"
        Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(seg_root / "images" / split / f"{stem}.png")
        Image.new("L", (8, 8), int(cls[i]) + 1).save(seg_root / "annotations" / split / f"{stem}.png")
        rows.append(f"{stem},{'abcdefgh'[cls[i]]},{CH_SUBSPECIES[cls[i]]}")
    md = shards.Metadata(
        family="clip", ckpt=ckpt, layers=(0,), content_tokens_per_example=tokens, cls_token=False,
        d_model=d_model, n_examples=n, max_tokens_per_shard=tokens * 32,
        data=shards.encode_dataset_cfg(datasets.ImgSegFolder(root=seg_root, split=split)), dataset=seg_root,
    )
    md.dump(shards_root)
    with shards.ShardWriter(shards_root, md) as writer:
        for start in range(0, n, 16):
            m = min(16, n - start)
            obj = rng.random((m, tokens)) < 0.5
            labels = np.where(obj, cls[start : start + m, None] + 1, 0).astype(np.uint8)
            acts = rng.standard_normal((m, tokens, d_model), dtype=np.float32)
            acts[obj] += centers[labels[obj] - 1]
            writer.write_batch(acts[:, None], start, labels)
    return shards_root / md.hash, rows


def _ch_runs(dims: dict, device: str, root: pathlib.Path, centers: np.ndarray, split_dirs: dict) -> dict:
    """r1 (the first n_classes latents read the classes' centres, the rest
    are orthogonal to them) and r2
    (r1's latents permuted by `perm`: r2's latent j is r1's perm[j]), each a
    run dir with its schema-5 SAE and config.json."""
    from saev_tpu_torch import disk
    from saev_tpu_torch.nn import modeling, serialize

    cfg = modeling.SparseAutoencoderConfig(d_model=dims["d_model"], d_sae=dims["d_sae"],
                                           activation=modeling.TopK(top_k=dims["top_k"]))
    params, state = modeling.init(cfg, torch.Generator(device).manual_seed(SEED + 70), device=device)
    unit = torch.from_numpy(centers / np.linalg.norm(centers, axis=1, keepdims=True)).to(device)
    # The other latents read nothing of the centres' span, so no class
    # shifts their pooled values: only the planted latents tell the
    # classes apart, and each task's best latents are the same twins in
    # both runs.
    basis = torch.linalg.qr(unit.T)[0]
    rest = params["W_enc"][:, len(centers) :]
    params["W_enc"][:, len(centers) :] = rest - basis @ (basis.T @ rest)
    params["W_enc"][:, : len(centers)] = unit.T
    params["W_dec"][: len(centers)] = unit
    perm = np.random.default_rng(SEED + 71).permutation(dims["d_sae"])
    p = torch.from_numpy(perm).to(device)
    permuted = {"W_enc": params["W_enc"][:, p].contiguous(), "b_enc": params["b_enc"][p],
                "W_dec": params["W_dec"][p].contiguous(), "b_dec": params["b_dec"]}
    runs_root = root / "saev" / "runs"
    runs_root.mkdir(parents=True)
    out = {"perm": perm, "runs_root": runs_root}
    for run_id, prm, layer in (("r1", params, 0), ("r2", permuted, 1)):
        run = disk.Run.new(run_id, train_shards_dir=split_dirs["training"], val_shards_dir=split_dirs["validation"],
                           runs_root=runs_root)
        serialize.dump(run.ckpt, cfg, prm, state)
        (run.run_dir / "checkpoint" / "config.json").write_text(json.dumps({
            "sae": {"d_sae": dims["d_sae"], "activation": {"key": "top-k", "top_k": dims["top_k"]}},
            "val_data": {"layer": layer}, "objective": {"n_prefixes": 1}}))
        out[run_id] = run.run_dir
    return out


def _ch_fx_check(dims: dict, run_dir: pathlib.Path, shards_dir: pathlib.Path, layer: int = 0) -> dict:
    """The card's token_acts on a split's first `ref_rows` rows (of `layer`)
    against the CPU's f32 encode of the same rows (topk_vs_cpu), the card's
    pre-activations recomputed on the inference's first batch, at its
    shape."""
    import scipy.sparse

    from saev_tpu_torch import nn
    from saev_tpu_torch.data import OrderedConfig, OrderedDataLoader
    from saev_tpu_torch.nn import modeling

    acts = scipy.sparse.load_npz(run_dir / "inference" / shards_dir.name / "token_acts.npz").tocsr()
    dl = OrderedDataLoader(OrderedConfig(shards=shards_dir, layer=layer, batch_size=dims["batch"]))
    try:
        batch = torch.from_numpy(np.asarray(next(iter(dl))["act"], np.float32))
    finally:
        dl.shutdown()
    rows = dims["ref_rows"]
    _, card, _ = nn.load(run_dir / "checkpoint" / "sae.pt", device="cuda")
    cfg, params, state = nn.load(run_dir / "checkpoint" / "sae.pt", device="cpu")
    with torch.no_grad():
        h_card = modeling._linear_bias(batch.cuda(), card["W_enc"], card["b_enc"], "highest")[:rows].cpu()
        x = batch[:rows]
        out, _ = modeling.encode(cfg, params, state, x, training=False, precision="highest")
        h_cpu = modeling._linear_bias(x, params["W_enc"], params["b_enc"], "highest")
    return topk_vs_cpu(acts[:rows].toarray(), h_card, out.f_x, h_cpu)


def _ch_timed(out: dict, name: str, fn):
    t0 = time.perf_counter()
    res = fn()
    out["seconds"][name] = time.perf_counter() - t0
    return res


def _ch_classification(dims: dict, out: dict, runs: dict, split_dirs: dict) -> dict:
    """cls::train (or, without scikit-learn, its ImportError and the phase's
    nearest-mean head in its checkpoint format), cls::eval, cls::audit."""
    import importlib.util
    import pickle

    from saev_tpu_torch import disk
    from saev_tpu_torch.tdiscovery import classification

    train, test, r1 = split_dirs["training"], split_dirs["validation"], runs["r1"]
    if importlib.util.find_spec("sklearn") is not None:
        head = classification.DecisionTree(max_depth=4)
        cfg = classification.TrainConfig(run=r1, train_shards=train, test_shards=test, cls=head)
        _ch_timed(out, "cls::train", lambda: classification.train_cli(cfg))
        out["ran"].append("tdiscovery.classification cls::train")
    else:
        head = classification.SparseLinear()
        cfg = classification.TrainConfig(run=r1, train_shards=train, test_shards=test, cls=head)
        try:
            classification.train_worker_fn(cfg)
            raise AssertionError("cls::train ran without scikit-learn")
        except ImportError as err:
            require("pip install scikit-learn" in str(err), f"cls::train's ImportError: {err}")
            out["import_errors"]["tdiscovery.classification cls::train"] = str(err)
        # cls::train's features, labels and checkpoint format, with the nearest-mean head.
        run = disk.Run(r1)

        def fit():
            x = classification._image_features(run, train, cfg.patch_agg)
            y, names = cfg.task.apply(classification.load_image_labels(train)[1][cfg.task.source_col])
            clf = _MeanHead(x[y >= 0], y[y >= 0])
            x_t = classification._image_features(run, test, cfg.patch_agg)
            y_t, _ = cfg.task.apply(classification.load_image_labels(test)[1][cfg.task.source_col], class_names=names)
            pred = clf.predict(x_t[y_t >= 0])
            header = {"cfg": dataclasses.asdict(cfg), "test_acc": float((pred == y_t[y_t >= 0]).mean()),
                      "n_classes": len(names), "class_names": names}
            fpath = classification.ckpt_fpath(run, cfg)
            with open(fpath, "wb") as fd:
                fd.write((json.dumps(header, default=str) + "\n").encode())
                pickle.dump({"classifier": clf, "test_pred": pred, "test_y": y_t[y_t >= 0]}, fd)

        _ch_timed(out, "nearest-mean head", fit)
    ckpt = classification.ckpt_fpath(disk.Run(r1), cfg)
    ev = _ch_timed(out, "cls::eval", lambda: classification.eval_worker_fn(classification.EvalConfig(
        run=r1, test_shards=test, cls=head, top_features=5)))
    require(ev["n_test"] == dims["images"] and ev["accuracy"] >= 0.75 and np.isfinite(ev["mean_ap"]),
            f"cls::eval: {ev['accuracy']} accuracy, mAP {ev['mean_ap']} on {ev['n_test']} images")
    out["ran"].append("tdiscovery.classification cls::eval")
    audit = _ch_timed(out, "cls::audit", lambda: classification.audit_worker_fn(classification.AuditConfig(
        run=r1, test_shards=test, cls_checkpoints=(ckpt,), max_budget=dims["max_budget"])))
    art = r1 / "inference" / test.name
    ap, best = np.load(art / "audit_ap_s.npy"), np.load(art / "audit_best_class_s.npy")
    planted = np.arange(dims["n_classes"])
    yields = audit["classifiers"][0]["yield_at_b"]
    # The nearest-mean head ranks the planted latents first; a tree may
    # split on any latent that the classes' centres shift.
    top3 = yields["3"] == 1.0 if isinstance(head, classification.SparseLinear) else yields["3"] >= 0
    require(audit["n_seg_classes"] == dims["n_classes"] and best[planted].tolist() == (planted + 1).tolist()
            and bool((ap[planted] > 0.5).all()) and top3 and all(0 <= v <= 1 for v in yields.values()),
            f"cls::audit: planted latents' best classes {best[planted]}, APs {ap[planted]}, yields {yields}")
    out["ran"].append("tdiscovery.classification cls::audit")
    out["cls"] = {"accuracy": ev["accuracy"], "mean_ap": ev["mean_ap"], "auc_b": audit["classifiers"][0]["auc_b"],
                  "n_features_evaluated": audit["n_features_evaluated"], "planted_ap": ap[planted].round(4).tolist(),
                  "head": type(head).__name__}
    return out


def _ch_mimics(dims: dict, out: dict, runs: dict, split_dirs: dict) -> dict:
    """tasks, scoring on both runs, consistency, checkpoint discovery and the
    scores browser."""
    from saev_tpu_torch.mimics import checkpoints, consistency, scoring, tasks, viewer
    from saev_tpu_torch.tdiscovery import classification

    test = split_dirs["validation"]
    specs, summary = _ch_timed(out, "mimics tasks", lambda: tasks.decide_task_specs(tasks.DecideTaskSpecsConfig(
        shards=test, pair_specs=CH_PAIR_SPECS, min_samples_per_class=dims["min_samples"])))
    want_tasks = sorted(f"{a}_vs_{b}" for a, b in CH_PAIRS)
    require(sorted(s.task_name for s in specs) == want_tasks and len(summary) == 2 * len(CH_PAIR_SPECS),
            f"mimics tasks: kept {[s.task_name for s in specs]} of {len(summary)}")
    out["ran"].append("mimics.tasks")
    labels = tuple(classification.load_image_labels(test)[1]["subspecies_view"])
    scores = {}
    for run_id in ("r1", "r2"):
        scores[run_id] = _ch_timed(out, f"mimics score {run_id}", lambda run_id=run_id: scoring.score_run(
            scoring.Config(run=runs[run_id], shards=test, labels=labels, pairs=CH_PAIRS,
                           min_samples=dims["min_samples"])))
    # Both sides' planted latents separate a pair fully; each run names one.
    perm = runs["perm"]
    for task in want_tasks:
        a, b = scores["r1"][task], scores["r2"][task]
        require(a["best_separation"] >= 0.99 and abs(b["best_separation"] - a["best_separation"]) <= 1e-6
                and a["best_latent"] < dims["n_classes"] and perm[b["best_latent"]] < dims["n_classes"],
                f"mimics score {task}: r1 {a['best_latent']} {a['best_separation']}, r2 {b['best_latent']} "
                f"(r1's {perm[b['best_latent']]}) {b['best_separation']}")
    out["ran"].append("mimics.scoring")
    cons = _ch_timed(out, "mimics consistency", lambda: consistency.worker_fn(consistency.Config(
        runs=(runs["r1"], runs["r2"]), shards=test, top_k=10)))
    for run_key, by_task in cons.items():
        for task, entries in by_task.items():
            top = entries[0]
            mapped = perm[top["witness_latent"]] if run_key.endswith("r1") else top["witness_latent"]
            own = top["latent"] if run_key.endswith("r1") else perm[top["latent"]]
            require(top["consistency"] >= 1 - 1e-5 and mapped == own,
                    f"mimics consistency {run_key} {task}: {top}, r1's latent {own}, the witness's {mapped}")
    out["ran"].append("mimics.consistency")
    rows = checkpoints.discover_checkpoints(checkpoints.DiscoverCheckpointsConfig(
        run_root_dpath=runs["runs_root"], shard_id=test.name, task_name="class"))
    pooled = checkpoints.pool_features(rows, per_ckpt=5)
    require(len(rows) == 1 and len(pooled) == 5 and max(pooled.values()) > 0,
            f"mimics checkpoints: {len(rows)} rows, pooled {pooled}")
    out["ran"].append("mimics.checkpoints")
    page = viewer.build_scores(viewer.ScoresConfig(runs=(runs["r1"], runs["r2"]), shards=test,
                                                   out=runs["runs_root"].parent / "scores.html"))
    require(all(t in page.read_text() for t in want_tasks), "mimics scores browser: a task is missing")
    out["ran"].append("mimics.viewer")
    out["mimics"] = {t: (scores["r1"][t]["best_latent"], round(scores["r1"][t]["best_separation"], 6)) for t in want_tasks}
    return out


def _ch_frames(dims: dict, out: dict, runs: dict) -> dict:
    """The frames over the runs (pandas): clsview's results, the audit's
    frames; with matplotlib, the audit battery; with scikit-learn, a tree's
    rules."""
    import importlib.util

    from saev_tpu_torch.tdiscovery import audit_analysis, clsview

    cls_df = _ch_timed(out, "clsview frame", lambda: clsview.load_cls_results_df([runs["r1"], runs["r2"]], per_class=True))
    require(len(cls_df) == dims["n_classes"] and cls_df["accuracy"].iloc[0] >= 0.75, f"clsview: {len(cls_df)} rows")
    out["ran"].append("tdiscovery.clsview")
    sae_df, clf_df = _ch_timed(out, "audit frames", lambda: audit_analysis.load_audit_frames([runs["r1"], runs["r2"]]))
    adf = audit_analysis.analysis_frame(clf_df)
    require(len(sae_df) == 2 and len(clf_df) == 1 and len(adf) == 1, f"audit frames: {len(sae_df)}, {len(clf_df)}")
    out["ran"].append("tdiscovery.audit_analysis frames")
    if importlib.util.find_spec("matplotlib") is not None:
        _ch_timed(out, "audit battery", lambda: audit_analysis.run_battery([runs["r1"], runs["r2"]],
                                                                           runs["runs_root"].parent / "battery"))
        out["ran"].append("tdiscovery.audit_analysis.run_battery")
    if importlib.util.find_spec("sklearn") is not None:
        from saev_tpu_torch.tdiscovery import classification

        (ckpt,) = sorted((runs["r1"] / "inference").glob("*/cls_class_*.pkl"))
        clsview.tree_rules(classification.load_classifier_checkpoint(ckpt)[1]["classifier"], list("abcd"))
        out["ran"].append("tdiscovery.clsview.tree_rules")
    return out


def run_contrib_host(dims: dict, device: str, root: pathlib.Path) -> dict:
    """The contrib_host phase's path at `dims` (module doc, phase 21):
    shards and runs, the port's inference on `device`, then the host-side
    analysis. The CPU runs it too, at small `dims`."""
    import importlib.util

    from saev_tpu_torch.data import OrderedConfig
    from saev_tpu_torch.framework import inference

    out = {"seconds": {}, "ran": [], "import_errors": {}}
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 72)
    centers = (2 * rng.standard_normal((dims["n_classes"], dims["d_model"]))).astype(np.float32)
    seg_root, shards_root = root / "data" / "butterflies", root / "saev" / "shards"
    shards_root.mkdir(parents=True)
    # The model the shards name: a random OpenCLIP checkpoint of dims["clip"]
    # at this path, which phase 22 writes before tdiscovery.visuals reads it.
    clip_ckpt = f"{dims['clip']}={root / 'clip.pt'}"
    split_dirs, rows = {}, []
    for split in ("training", "validation"):
        split_dirs[split], split_rows = _ch_split(seg_root, shards_root, split, dims, centers, rng, clip_ckpt)
        rows += split_rows
    (seg_root / "labels.csv").write_text("stem,class,subspecies_view\n" + "\n".join(rows) + "\n")
    runs = _ch_runs(dims, device, root, centers, split_dirs)
    out["seconds"]["shards and runs"] = time.perf_counter() - t0
    out["batches"] = 0
    for run_id in ("r1", "r2"):
        for split, d in split_dirs.items():
            res = _ch_timed(out, f"inference {run_id} {split}", lambda run_id=run_id, d=d: inference.worker_fn(
                inference.Config(run=runs[run_id], data=OrderedConfig(shards=d, layer=0, batch_size=dims["batch"]),
                                 device=device)))
            out["batches"] += res["batches"]
    out["ran"].append("framework.inference")
    out["runs"], out["split_dirs"] = runs, split_dirs
    out |= {"seg_root": seg_root, "clip_ckpt": clip_ckpt, "n_classes": dims["n_classes"], "tokens": dims["tokens"],
            "images": dims["images"]}
    _ch_classification(dims, out, runs, split_dirs)
    _ch_mimics(dims, out, runs, split_dirs)
    _ch_frames(dims, out, runs)
    out["missing"] = {what: pkg for what, pkg in CH_OPTIONAL if importlib.util.find_spec(pkg) is None}
    return out


def phase_contrib_host(root: pathlib.Path) -> dict:
    """contrib's host-side analysis on runs the port's inference wrote on the
    card at ViT-L/14 width (module doc, phase 21), in `root`, which phase 22
    reuses. Returns the path's launches (K6 in every inference batch) and
    its output."""
    t_phase = time.perf_counter()
    card = card_and_limit()
    reset_counts()
    with plain_spy() as plain:
        out = run_contrib_host(CH, "cuda", root)
    launches = counts()
    # The CPU's encode takes K6's plain version, so it runs after the count.
    fx_cmp = _ch_fx_check(CH, out["runs"]["r1"], out["split_dirs"]["validation"])
    torch.cuda.empty_cache()
    require(not plain, f"contrib_host: plain versions ran on the card: {plain}")
    want = dict.fromkeys(KERNELS, 0) | {"kth_value": out["batches"]}
    require(launches == want, f"contrib_host: launches {launches}, expected {want}")
    require_topk_agrees("contrib_host: token_acts", fx_cmp, INTERP_REL_MSE)
    sec = out["seconds"]
    log(f"contrib_host ({card}): " + "; ".join(f"{k} {v:.2f} s" for k, v in sec.items()))
    log(f"contrib_host ({card}): {CH['images']} + {CH['images']} images of {CH['tokens']} tokens at d_model "
        f"{CH['d_model']}, two runs of TopK-{CH['top_k']} at d_sae {CH['d_sae']}; K6 launched {launches['kth_value']} "
        f"times (one an inference batch of {CH['batch']} rows, {out['batches']} batches), no plain version; "
        f"token_acts on {CH['ref_rows']} rows: {topk_note(fx_cmp, INTERP_REL_MSE)}; cls ({out['cls']['head']} head) "
        f"{out['cls']}; mimics (best latent, separation) "
        f"{out['mimics']}, r2's the same under its permutation, consistency 1 with the permuted witness")
    for what, err in out["import_errors"].items():
        log(f"contrib_host: {what} raised ImportError as it must: {err}")
    log(f"contrib_host modules ran: {', '.join(out['ran'])}; could not import: "
        + (", ".join(f"{what} ({pkg})" for what, pkg in out["missing"].items()) or "none"))
    log(f"contrib_host: the phase {time.perf_counter() - t_phase:.1f} s ({card})")
    return {"launches": launches, "out": out}


# Phase 22 (contrib_last): Bird-MAE-Large's width (d_model 1024, 24 layers,
# 256 content tokens a clip), 64 BirdCLEF clips of which 16 carry a 10 kHz
# tone over time patches 10-12, the tap at layer 11, a TopK-32 SAE at d_sae
# 16384 whose latent 7 reads the tone's direction, inference at batch 4096;
# then phase 21's tree (its runs, shards and images) for trait discovery's
# study modules, the freshwater-fish tools and the data-prep scripts.
CL = dict(bird_arch="Bird-MAE-Large", clips=64, planted=16, layer=11, tone_t=(10, 11, 12), tone_hz=10_000.0,
          latent=7, bad_channel=295, d_sae=D_SAE, top_k=TOP_K, batch=4096, ref_rows=2048, vis_latents=3,
          probe_iter=5, n_workers=8, tol_images=8)
CL_KERNELS = ("kth_value",)
# What the phase runs only where its package imports: (what, package).
CL_OPTIONAL = (("tdiscovery.figplots figures", "matplotlib"), ("tdiscovery.ablations.fig_variant_grid", "matplotlib"),
               ("tdiscovery.logparse figures", "matplotlib"), ("freshwater_fish.extract_tol's HDF5 read", "h5py"))
CL_FISHBASE_PAGE = """<html><head><script>var x = "pelagic";</script></head><body><h1>Thunnus albacares</h1>
<div>Environment: Marine; brackish; pelagic-oceanic; oceanodromous; depth range 1 - 250 m, usually 1 - 100 m.
pH range: 6.5 - 8.0.</div></body></html>"""


def _cl_clips(root: pathlib.Path, dims: dict, rng) -> tuple[list[int], dict]:
    """A BirdCLEF-2025-layout root of `clips` 5 s clips at 32 kHz (int16
    .wav): a quiet 1-4 kHz tone and noise, and in the first `planted` of a
    seeded permutation a loud tone at `tone_hz` over the time patches
    `tone_t`. Returns the planted clips' dataset indices and the tone's
    sample window."""
    import scipy.io.wavfile

    from saev_tpu_torch.models import bird_mae

    n, sr = dims["clips"], bird_mae.SR_HZ
    planted = sorted(rng.permutation(n)[: dims["planted"]].tolist())
    t = np.arange(sr * bird_mae.CLIP_SEC) / sr
    lo = dims["tone_t"][0] * bird_mae.SAMPLES_PER_TIME_PATCH
    hi = (dims["tone_t"][-1] + 1) * bird_mae.SAMPLES_PER_TIME_PATCH
    labels = ("abethr1", "barswa", "compau", "grekis")
    (root / "train_audio").mkdir(parents=True)
    with open(root / "taxonomy.csv", "w") as fd:
        fd.write("primary_label,inat_taxon_id,scientific_name,common_name,class_name\n")
        fd.writelines(f"{label},{100 + i},Genus species{i},Name {i},Aves\n" for i, label in enumerate(labels))
    rows = []
    for i in range(n):
        x = 0.05 * np.sin(2 * np.pi * rng.uniform(1000, 4000) * t) + 0.01 * rng.standard_normal(t.size)
        if i in planted:
            x[lo:hi] += 0.5 * np.sin(2 * np.pi * dims["tone_hz"] * t[lo:hi])
        label = labels[i % len(labels)]
        (root / "train_audio" / label).mkdir(exist_ok=True)
        scipy.io.wavfile.write(root / "train_audio" / label / f"XC{i}.wav", sr, (x * 32767).astype(np.int16))
        rows.append(f"{label},[],['song'],{label}/XC{i}.wav,XC,4.0")
    (root / "train.csv").write_text("primary_label,secondary_labels,type,filename,collection,rating\n"
                                    + "\n".join(rows) + "\n")
    return planted, {"lo": lo, "hi": hi}


def _cl_extract(root: pathlib.Path, dims: dict, device: str, shards_root: pathlib.Path, out: dict) -> pathlib.Path:
    """A random timm-layout checkpoint of `bird_arch` with channel
    `bad_channel` planted in the patch embedding's bias (phase 20(e)'s
    plant), through `framework.shards.cli` at the one layer; logs clips/s
    over the loop (on the card, as phase 17 times it) or the entry point."""
    from saev_tpu_torch.data import datasets
    from saev_tpu_torch.framework import shards as fshards
    from saev_tpu_torch.models import bird_mae
    from saev_tpu_torch.scripts import vit_route

    spec = bird_mae.PRETRAINED_SPECS[dims["bird_arch"]]
    sd = vit_route.bird_mae_state_dict(spec, torch.Generator().manual_seed(SEED + 80))
    sd["patch_embed.proj.bias"][dims["bad_channel"]] = 50.0
    ckpt = root / f"{dims['bird_arch']}.pt"
    torch.save(sd, ckpt)
    del sd
    tokens = bird_mae.N_PATCHES + 1
    cfg = fshards.Config(
        data=datasets.BirdClef2025(root=root / "birdclef"), family="bird-mae", ckpt=f"{dims['bird_arch']}={ckpt}",
        layers=(dims["layer"],), d_model=spec.d_model, content_tokens_per_example=bird_mae.N_PATCHES, cls_token=True,
        shards_root=shards_root, max_tokens_per_shard=32 * tokens, batch_size=EXTRACT_BATCH,
        n_workers=dims["n_workers"], device=device)
    before = {p.name for p in shards_root.iterdir()}
    seen = {"wait": [], "record": [], "forward": [], "write": []}
    t0 = time.perf_counter()
    with _extract_spies(seen) if device == "cuda" else contextlib.nullcontext():
        fshards.cli(cfg)
    t_cli = time.perf_counter() - t0
    out["seconds"]["extraction"] = t_cli
    loop = seen["end"] - seen["start"] if device == "cuda" else t_cli
    out["extract"] = {"clips_s": dims["clips"] / loop, "loop_s": loop, "entry_point_s": t_cli,
                      "forward_ms": [round(1e3 * v, 2) for v in seen["forward"]],
                      "wait_ms": [round(1e3 * v, 2) for v in seen["wait"]]}
    (bird,) = [p for p in shards_root.iterdir() if p.is_dir() and p.name not in before]
    return bird


def _cl_tone_mel_patch(wave: np.ndarray, dims: dict) -> int:
    """The mel patch that the tone raises most within its time patches, read
    off the clip's own log-mel spectrogram."""
    from saev_tpu_torch.models import bird_mae

    fb = bird_mae.transform(wave)
    frames = np.zeros(fb.shape[0], bool)
    for t in dims["tone_t"]:
        frames[t * bird_mae.FRAMES_PER_PATCH : (t + 1) * bird_mae.FRAMES_PER_PATCH] = True
    rise = fb[frames].mean(axis=0) - fb[~frames].mean(axis=0)
    return int(rise.reshape(bird_mae.N_MEL_PATCHES, bird_mae.MELS_PER_PATCH).mean(axis=1).argmax())


def _cl_sae(dims: dict, device: str, runs_root: pathlib.Path, bird: pathlib.Path, planted: list[int]) -> dict:
    """The tone's direction: the mean of the planted clips' tone patches
    less the mean of the other clips' patches, without `bad_channel`; the
    threshold halfway between the other clips' largest projection and the
    tone patches' least. Run b1: a TopK SAE whose latent `latent` reads that
    direction, scaled so the tone's patches give at least 100 and every
    other clip's patch a negative value, and whose other latents read
    nothing of `bad_channel`."""
    from saev_tpu_torch import disk
    from saev_tpu_torch.data import IndexedConfig, IndexedDataset, Metadata, datasets
    from saev_tpu_torch.models import bird_mae
    from saev_tpu_torch.nn import modeling, serialize

    md = Metadata.load(bird)
    ds = IndexedDataset(IndexedConfig(shards=bird, layer=dims["layer"]))
    acts = ds.take(np.arange(len(ds)))["act"].reshape(dims["clips"], bird_mae.N_PATCHES, md.d_model).astype(np.float64)
    audio = datasets.get_dataset(md.make_data_cfg())
    mel = _cl_tone_mel_patch(np.asarray(audio[planted[0]]["data"], np.float32), dims)
    tone_tokens = [t * bird_mae.N_MEL_PATCHES + mel for t in dims["tone_t"]]
    others = np.setdiff1d(np.arange(dims["clips"]), planted)
    tone = acts[planted][:, tone_tokens].reshape(-1, md.d_model)
    rest = acts[others].reshape(-1, md.d_model)
    direction = tone.mean(axis=0) - rest.mean(axis=0)
    direction[dims["bad_channel"]] = 0.0
    direction /= np.linalg.norm(direction)
    lo, hi = float((rest @ direction).max()), float((tone @ direction).min())
    require(hi > lo, f"contrib_last: the tone's patches (least projection {hi}) do not stand apart from the other "
                     f"clips' (largest {lo}) at layer {dims['layer']}")
    threshold, scale = (lo + hi) / 2, 100.0 / ((hi - lo) / 2)
    cfg = modeling.SparseAutoencoderConfig(d_model=md.d_model, d_sae=dims["d_sae"],
                                           activation=modeling.TopK(top_k=dims["top_k"]))
    params, state = modeling.init(cfg, torch.Generator(device).manual_seed(SEED + 81), device=device)
    d = torch.from_numpy(direction).float().to(device)
    params["W_enc"][dims["bad_channel"]] = 0.0
    params["W_enc"][:, dims["latent"]] = scale * d
    params["b_enc"][dims["latent"]] = -scale * threshold
    params["W_dec"][dims["latent"]] = d
    run = disk.Run.new("b1", train_shards_dir=bird, val_shards_dir=bird, runs_root=runs_root)
    serialize.dump(run.ckpt, cfg, params, state)
    (run.run_dir / "checkpoint" / "config.json").write_text(json.dumps({
        "sae": {"d_sae": dims["d_sae"], "activation": {"key": "top-k", "top_k": dims["top_k"]}},
        "val_data": {"layer": dims["layer"]}, "objective": {"n_prefixes": 1}}))
    return {"run": run.run_dir, "mel_patch": mel, "separation": (lo, hi)}


def _cl_samples(fpath: pathlib.Path) -> np.ndarray:
    """A clip that birdsong.visuals wrote, as float samples."""
    import wave

    if fpath.suffix == ".ogg":
        from saev_tpu_torch.utils import vorbis

        return np.asarray(vorbis.read_ogg(fpath)[0], np.float64)
    with wave.open(str(fpath)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.float64) / 32767


def _cl_birdsong(dims: dict, device: str, root: pathlib.Path, ch: dict, out: dict) -> dict:
    """(a): clips, extraction, the SAE, inference on `device`, visuals,
    make_html --embed, browse and stats; checks the planted latent's clips
    and time clip, the outlier channel and the page."""
    import scipy.sparse

    from saev_tpu_torch import helpers
    from saev_tpu_torch.birdsong import browse, make_html, stats, visuals
    from saev_tpu_torch.data import Metadata, OrderedConfig, datasets
    from saev_tpu_torch.framework import inference
    from saev_tpu_torch.models import bird_mae

    rng = np.random.default_rng(SEED + 82)
    planted, window = _ch_timed(out, "clips", lambda: _cl_clips(root / "birdclef", dims, rng))
    bird = _cl_extract(root, dims, device, root / "saev" / "shards", out)
    out["ran"].append("framework.shards.cli (Bird-MAE)")
    sae = _ch_timed(out, "tone direction and SAE", lambda: _cl_sae(dims, device, ch["runs"]["runs_root"], bird, planted))
    b1 = sae["run"]
    res = _ch_timed(out, "inference b1", lambda: inference.worker_fn(inference.Config(
        run=b1, data=OrderedConfig(shards=bird, layer=dims["layer"], batch_size=dims["batch"]), device=device)))
    out["batches"] += res["batches"]
    out["ran"].append("framework.inference (Bird-MAE)")
    _ch_timed(out, "birdsong.visuals", lambda: visuals.worker_fn(visuals.Config(
        run=b1, shards=bird, latents=(dims["latent"],), n_latents=dims["vis_latents"], top_k=8, n_clips=4)))
    out["ran"].append("birdsong.visuals")
    art = b1 / "inference" / bird.name
    token_acts = scipy.sparse.load_npz(art / "token_acts.npz").tocsr()
    top = helpers.csr_topk(token_acts[:, [dims["latent"]]], k=8, axis=0)
    ex = top.indices[:, 0][top.values[:, 0] > 0] // bird_mae.N_PATCHES
    require(len(ex) and set(ex.tolist()) <= set(planted),
            f"birdsong: latent {dims['latent']}'s top clips {ex.tolist()} are not all planted ({planted})")
    (clip_f,) = (art / "clips" / str(dims["latent"])).glob("0_time_clip.*")
    clip = _cl_samples(clip_f)
    md = Metadata.load(bird)
    wave0 = np.asarray(datasets.get_dataset(md.make_data_cfg())[int(ex[0])]["data"], np.float64)
    e_window = float((wave0[window["lo"] : window["hi"]] ** 2).sum())
    e_clip = float((clip**2).sum())
    n_patches = len(clip) / bird_mae.SAMPLES_PER_TIME_PATCH
    require(e_clip >= 0.98 * e_window and len(dims["tone_t"]) <= n_patches <= 2 * len(dims["tone_t"]),
            f"birdsong: the time clip of clip {int(ex[0])} has {e_clip:.1f} of the window's {e_window:.1f} energy over "
            f"{n_patches} time patches")
    latents = sorted(int(p.name) for p in (art / "clips").iterdir())
    notes = root / "notes.json"
    notes.write_text(json.dumps({str(dims["latent"]): f"a {dims['tone_hz'] / 1e3:g} kHz tone"}))
    page = _ch_timed(out, "birdsong.make_html --embed", lambda: make_html.make(make_html.Config(
        run=b1, shards=bird, embed=True, notes=notes, latents=tuple(latents), out=root / "birdsong.html"))).read_text()
    cards = sum(min(4, len(set(helpers.csr_topk(token_acts[:, [f]], k=8, axis=0).indices[:, 0] // bird_mae.N_PATCHES)))
                for f in latents)
    require(page.count("<section>") == len(latents) and all(f"Latent {f}</h2>" in page for f in latents)
            and page.count('<div class="example">') == cards and "data:image/png;base64," in page,
            f"birdsong.make_html: {page.count('<section>')} sections, {page.count('<div class=\"example\">')} "
            f"cards for latents {latents} ({cards} expected)")
    out["ran"].append("birdsong.make_html")
    pages = _ch_timed(out, "birdsong.browse", lambda: browse.build_browsers([ch["runs"]["runs_root"]], root / "site"))
    require([p.name for p in pages] == [f"b1__{bird.name}.html", "index.html"], f"birdsong.browse: {pages}")
    out["ran"].append("birdsong.browse")
    report = _ch_timed(out, "birdsong.stats", lambda: stats.report(
        {"bird-mae": (bird, dims["layer"]), "image": (ch["split_dirs"]["validation"], 0)}, n=1 << 14))
    outliers = [d["dim"] for d in report["per_set"]["bird-mae"]["outlier_dims"]]
    require(outliers[:1] == [dims["bad_channel"]]
            and dims["bad_channel"] not in [d["dim"] for d in report["per_set"]["image"]["outlier_dims"]],
            f"birdsong.stats: outlier dims {outliers[:5]}, planted {dims['bad_channel']}")
    out["ran"].append("birdsong.stats")
    out["bird"] = {"dir": bird, "run": b1, "planted_top": sorted(set(ex.tolist())), "mel_patch": sae["mel_patch"],
                   "separation": sae["separation"], "time_clip_patches": n_patches, "energy": (e_clip, e_window),
                   "outliers": outliers[:3], "latents": latents, "cards": cards,
                   "norm_ratio": report["comparisons"]["bird-mae_vs_image"]["norm_ratio"]}
    return out


def _cl_probe_log(dims: dict, device: str, root: pathlib.Path, run: pathlib.Path, shards_dir: pathlib.Path):
    """A probe1d fit on `device` over a run's token_acts against the split's
    patch labels (one-hot), with the stats logger at DEBUG into a file."""
    import logging

    import scipy.sparse

    from saev_tpu_torch.data import Metadata
    from saev_tpu_torch.tdiscovery import probe1d

    x = scipy.sparse.load_npz(run / "inference" / shards_dir.name / "token_acts.npz").tocsr().astype(np.float32)
    md = Metadata.load(shards_dir)
    labels = np.fromfile(shards_dir / "labels.bin", np.uint8)[: md.n_examples * md.content_tokens_per_example]
    y = np.eye(int(labels.max()) + 1, dtype=np.float32)[labels]
    fpath = root / "probe1d.log"
    handler = logging.FileHandler(fpath)
    handler.setFormatter(logging.Formatter("[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"))
    stats_log = logging.getLogger("probe1d.stats")
    old = stats_log.level
    stats_log.setLevel(logging.DEBUG)
    stats_log.addHandler(handler)
    try:
        probe = probe1d.Sparse1DProbe(n_latents=x.shape[1], n_classes=y.shape[1], max_iter=dims["probe_iter"],
                                      device=device).fit(x, y)
    finally:
        stats_log.removeHandler(handler)
        stats_log.setLevel(old)
        handler.close()
    return fpath, probe, labels


def _cl_study(dims: dict, device: str, root: pathlib.Path, ch: dict, out: dict) -> dict:
    """(b): runs, results, logparse over a probe fit on `device`, fishbase,
    mimicry, figplots and ablations over phase 21's runs and b1."""
    import importlib.util

    import scipy.sparse

    from saev_tpu_torch.tdiscovery import ablations, figplots, fishbase, logparse, mimicry, results, runs
    from saev_tpu_torch.tdiscovery.fishvista import utils as fv_utils

    r1, r2, val = ch["runs"]["r1"], ch["runs"]["r2"], ch["split_dirs"]["validation"]
    n_classes = ch["n_classes"]
    specs = [runs.RunSpec(run=r1), runs.RunSpec(run=r2), runs.RunSpec(run=out["bird"]["run"], method="sae-audio")]
    df, skipped = _ch_timed(out, "tdiscovery.runs.load_df", lambda: runs.load_df(specs))
    nmse = f"{val.name}/normalized_mse"
    require(len(df) == 3 and not skipped and df[nmse].iloc[:2].notna().all() and (df["d_sae"] == dims["d_sae"]).all(),
            f"tdiscovery.runs: {len(df)} rows, {len(skipped)} skipped, columns {list(df.columns)[:12]}")
    out["ran"].append("tdiscovery.runs")
    rng = np.random.default_rng(SEED + 83)
    for i, method in enumerate(("sae", "random", "pca")):
        ap = rng.random(10).tolist()
        fv_utils.Result(method=method, n_prototypes=dims["d_sae"], best_prototype_per_class=rng.integers(
            0, dims["d_sae"], 10).tolist(), train_ap_per_class=rng.random(10).tolist(), test_ap_per_class=ap,
            mean_ap=float(np.mean(ap)), n_train_patches=1 << 14, n_test_patches=1 << 14, seed=i,
            extra={"layer": 0}).dump_json(root / "results" / f"fishvista_{method}.json")
    rdf = _ch_timed(out, "tdiscovery.results", lambda: results.load_results_df(root / "results"))
    table = results.map_table(rdf)
    best = results.best_latents(rdf)
    vs = results.method_vs_random(rdf)
    require(len(rdf) == 30 and len(table) == 3 and table["mAP"].is_monotonic_decreasing and len(best) == 10
            and "sae_minus_random" in vs.columns, f"tdiscovery.results: {len(rdf)} rows, map table {table}")
    out["ran"].append("tdiscovery.results")
    log_f, probe, labels = _ch_timed(out, "probe1d fit (logparse's log)", lambda: _cl_probe_log(dims, device, root, r1, val))
    events = logparse.load_events(log_f)
    summary = logparse.summarize(events)
    require(summary["n_iterations"] >= 1 and summary["n_slabs"] >= 1 and np.isfinite(summary["final_loss_mean"])
            and ("peak_device_gb" in summary) == (device == "cuda"), f"tdiscovery.logparse: {summary}")
    out["ran"].append("tdiscovery.logparse")
    # fishbase: the planted latents and 28 others, the patches' class labels
    # as body parts, each image's class as its habitat.
    cols = np.concatenate([np.arange(n_classes), rng.choice(np.arange(n_classes, dims["d_sae"]), 28, replace=False)])
    acts = scipy.sparse.load_npz(r1 / "inference" / val.name / "token_acts.npz").tocsc()[:, cols].toarray()
    tokens = ch["tokens"]
    trait = labels.reshape(-1, tokens).max(axis=1).astype(np.int32) - 1
    vocab, parts = fishbase.HABITATS[:n_classes], fishbase.PART_NAMES[: n_classes + 1]
    scored = _ch_timed(out, "tdiscovery.fishbase", lambda: fishbase.score_part_by_trait(
        acts, labels, trait, tokens, vocab=vocab, parts=parts))
    found = {(r["part"], r["target"]): r["latent"] for r in scored.table()}
    want = {(parts[c + 1], vocab[c]): c for c in range(n_classes)}
    require(all(found.get(k) == v for k, v in want.items()), f"tdiscovery.fishbase: best latents {found}")
    auc = fishbase.fast_auc(acts, labels == 1)
    require(int(auc.argmax()) == 0 and auc[0] > 0.9, f"tdiscovery.fishbase: AUC of class 1 {auc[:n_classes]}")
    out["ran"].append("tdiscovery.fishbase")
    pairs = [tuple(s.split("_")[0] for s in pair) for pair in CH_PAIRS]
    counts = mimicry.pair_counts(val, pairs)
    per = ch["images"] // n_classes
    require([(c["n_erato"], c["n_melpomene"]) for c in counts] == [(per, per), (0, 0)] * len(pairs),
            f"tdiscovery.mimicry pair counts: {counts}")
    rows = _ch_timed(out, "tdiscovery.mimicry harvest", lambda: mimicry.harvest_results(
        ch["runs"]["runs_root"], filt=mimicry.HarvestFilter(tasks=frozenset({"class"}))))
    sk = importlib.util.find_spec("sklearn") is not None
    # cls::train's tree (scikit-learn) is not a sparse-linear head; the
    # nearest-mean head that the phase writes without it is.
    require(len(rows) == (0 if sk else 1) and all(r["balanced_acc"] >= 0.75 for r in rows),
            f"tdiscovery.mimicry harvest: {[(r['run_id'], r['balanced_acc']) for r in rows]}")
    difficulty = mimicry.difficulty_table(rows)
    out["ran"].append("tdiscovery.mimicry")
    cmp = figplots.comparison_table(df, [("top-k", {"activation": "top-k"}), ("none", {"activation": "relu"})],
                                    columns=(("NMSE", nmse),), pick=nmse)
    done = ablations.completeness(df, group_cols=("activation",), expected=3)
    require(cmp["run_id"].isna().tolist() == [False, True] and done == [{"activation": "top-k", "count": 3, "expected": 3, "done": True}],
            f"figplots.comparison_table {cmp.to_dict('records')}, ablations.completeness {done}")
    out["ran"].append("tdiscovery.figplots tables, ablations tables")
    if importlib.util.find_spec("matplotlib") is not None:
        fig, fronts = figplots.fig_tradeoff(df.dropna(subset=[nmse]), x="d_sae", y=nmse, group="method")
        grid, _ = ablations.fig_variant_grid(df.dropna(subset=[nmse]), variant_col="activation", panel_rows="method",
                                             panel_cols="top_k", x="d_sae", y=nmse)
        written = figplots.save_battery({"tradeoff": fig, "variants": grid, "loss": logparse.fig_loss(
            logparse.iters_df(events))}, {"runs": cmp}, root / "battery")
        require(len(written) == 4, f"figplots.save_battery wrote {written}")
        out["ran"].append("tdiscovery.figplots, ablations and logparse figures")
    else:
        for what, fn in (("tdiscovery.figplots figures", lambda: figplots.fig_tradeoff(df)),
                         ("tdiscovery.ablations.fig_variant_grid", lambda: ablations.fig_variant_grid(df)),
                         ("tdiscovery.logparse figures", lambda: logparse.fig_loss(logparse.iters_df(events)))):
            try:
                fn()
                raise AssertionError(f"{what} ran without matplotlib")
            except ImportError as err:
                require("pip install matplotlib" in str(err), f"{what}'s ImportError: {err}")
                out["import_errors"][what] = str(err)
    out["study"] = {"probe_iterations": summary["n_iterations"], "probe_loss": summary["final_loss_mean"],
                    "fishbase": [found.get(k) for k in want], "harvest": [(r["run_id"], r["balanced_acc"]) for r in rows],
                    "difficulty": [r["task"] for r in difficulty], "n_iter": probe.n_iter_.tolist()}
    return out


def _cl_tol_store(root: pathlib.Path, images: list[pathlib.Path]) -> int:
    """A TreeOfLife-200M layout over `images` (PNG bytes): a resolved-taxa
    partition (two fish orders and a beetle), the uuid -> h5_file lookup, and
    the HDF5 file where h5py imports. Returns the fish images' count."""
    import importlib.util

    import pyarrow as pa
    import pyarrow.parquet as pq

    n = len(images)
    uuids = [f"u{i}" for i in range(n)]
    orders = ["Coleoptera" if i == n - 1 else ("Cypriniformes", "Perciformes")[i % 2] for i in range(n)]
    (root / "resolved_taxa" / "source=gbif").mkdir(parents=True)
    pq.write_table(pa.table({"uuid": uuids, "order": orders, "species": [f"Species {i % 3}" for i in range(n)]}),
                   root / "resolved_taxa" / "source=gbif" / "part0.parquet")
    (root / "lookup_tables").mkdir()
    pq.write_table(pa.table({"uuid": uuids, "h5_file": [str(root / "images0.h5")] * n}),
                   root / "lookup_tables" / "lookup0.parquet")
    if importlib.util.find_spec("h5py") is not None:
        import h5py

        with h5py.File(root / "images0.h5", "w") as fd:
            g = fd.create_group("images")
            for uuid, p in zip(uuids, images):
                g.create_dataset(uuid, data=np.frombuffer(p.read_bytes(), np.uint8))
    return n - 1


def _cl_fish(dims: dict, root: pathlib.Path, ch: dict, out: dict) -> dict:
    """(c): extract_tol over a TreeOfLife store of phase 21's images
    (without h5py, its ImportError once the parquet side has run);
    tdiscovery.visuals on r1's validation split, then make_gallery over its
    images and var.parquet."""
    import importlib.util

    import pandas as pd

    from saev_tpu_torch.freshwater_fish import extract_tol, make_gallery
    from saev_tpu_torch.models import families
    from saev_tpu_torch.scripts import vit_route
    from saev_tpu_torch.tdiscovery import visuals

    images = sorted((ch["seg_root"] / "images" / "validation").glob("*.png"))[: dims["tol_images"]]
    n_fish = _cl_tol_store(root / "tol", images)
    cfg = extract_tol.Config(order_filter=("Cypriniformes", "Perciformes"), resolved_taxa_dpath=root / "tol" / "resolved_taxa",
                             lookup_tables_dpath=root / "tol" / "lookup_tables", output_dpath=root / "fish",
                             n_workers=4, sources=("gbif",))
    pairs = extract_tol.collect_pairs(cfg)
    lookup = extract_tol.load_lookup(cfg.lookup_tables_dpath, {u for u, _ in pairs})
    require(len(pairs) == len(lookup) == n_fish, f"extract_tol: {len(pairs)} pairs, {len(lookup)} resolved")
    if importlib.util.find_spec("h5py") is not None:
        n = _ch_timed(out, "freshwater_fish.extract_tol", lambda: extract_tol.worker_fn(cfg))
        written = sorted((root / "fish").rglob("*.jpg"))
        require(n == n_fish == len(written), f"extract_tol: wrote {n} images, {len(written)} files, {n_fish} fish")
        out["ran"].append("freshwater_fish.extract_tol")
    else:
        try:
            extract_tol.worker_fn(cfg)
            raise AssertionError("extract_tol read HDF5 without h5py")
        except ImportError as err:
            require("pip install h5py" in str(err), f"extract_tol's ImportError: {err}")
            out["import_errors"]["freshwater_fish.extract_tol's HDF5 read"] = str(err)
        out["ran"].append("freshwater_fish.extract_tol (parquet filter and lookup)")
    # The shards' model family (a random OpenCLIP checkpoint of ch["clip"]):
    # tdiscovery.visuals reads its patch size and resize.
    arch, _, ckpt = ch["clip_ckpt"].partition("=")
    spec = families.CLIP_PRESETS[arch].spec
    _ch_timed(out, "clip checkpoint", lambda: torch.save(vit_route.openclip_state_dict(
        spec, torch.Generator().manual_seed(SEED + 84), ch["tokens"] + 1), ckpt))
    r1, val = ch["runs"]["r1"], ch["split_dirs"]["validation"]
    planted = tuple(range(ch["n_classes"]))
    _ch_timed(out, "tdiscovery.visuals", lambda: visuals.worker_fn(visuals.Config(
        run=r1, shards=val, latents=planted, n_latents=2, top_k=4, save_distributions=False)))
    out["ran"].append("tdiscovery.visuals")
    gcfg = make_gallery.Config(run=r1, shards=val, dataset=ch["seg_root"], split="validation", out=root / "fish.html")
    species = make_gallery.load_species(gcfg)
    art = r1 / "inference" / val.name
    cards = make_gallery.build_features(art / "images", pd.read_parquet(art / "var.parquet"), species, 80)
    by_id = {c["id"]: c for c in cards}
    require(all({im["label"] for im in by_id[c]["images"]} == {"abcdefgh"[c]} for c in planted),
            f"make_gallery: planted latents' captions {[sorted({im['label'] for im in by_id[c]['images']}) for c in planted if c in by_id]}")
    page = _ch_timed(out, "freshwater_fish.make_gallery", lambda: make_gallery.gallery(gcfg)).read_text()
    require(all(f'"id": {c},' in page for c in planted), "make_gallery: a planted latent's card is missing")
    out["ran"].append("freshwater_fish.make_gallery")
    out["fish"] = {"tol_pairs": len(pairs), "cards": len(cards), "images": sum(len(c["images"]) for c in cards)}
    return out


def _cl_dataprep(dims: dict, device: str, root: pathlib.Path, ch: dict, out: dict) -> dict:
    """(d): format_ade20k and format_fishvista on synthetic downloads,
    materialize on in-memory rows, parse_environment on a stored page, and
    push_dinov3 --dry-run, which loads phase 21's and b1's SAE files on
    `device`."""
    import scipy.sparse
    from PIL import Image

    from saev_tpu_torch.tdiscovery.scripts import (download_butterflies, format_ade20k, format_fishvista, push_dinov3,
                                                   scrape_fishbase)

    rng = np.random.default_rng(SEED + 85)
    t0 = time.perf_counter()
    ade = root / "ade"
    stems = {f"ADE_{s}_{i:03d}": ("kitchen", "beach", "street")[i % 3] for i, s in enumerate(["train", "val"] * 4)}
    for i, stem in enumerate(stems):
        split = ("training", "validation")[i % 2]
        for sub in ("images", "annotations"):
            (ade / sub / split).mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(ade / "images" / split / f"{stem}.jpg")
        Image.fromarray(rng.integers(0, 4, (8, 8), dtype=np.uint8)).save(ade / "annotations" / split / f"{stem}.png")
    (ade / "sceneCategories.txt").write_text("".join(f"{s} {v}\n" for s, v in stems.items()))
    format_ade20k.main(["format", "--src-root", str(ade), "--dump-to", str(root / "ade_seg"), "--n-threads", "4"])
    links = [p for p in (root / "ade_seg").rglob("*") if p.is_symlink()]
    require(len((root / "ade_seg" / "image_labels.txt").read_text().splitlines()) == len(stems)
            and len(links) == 2 * len(stems), f"format_ade20k: {len(links)} links")
    out["ran"].append("tdiscovery.scripts.format_ade20k")
    fv = root / "fv"
    (fv / "Images").mkdir(parents=True)
    (fv / "segmentation_masks" / "images").mkdir(parents=True)
    species = ("Thunnus albacares", "Amphiprion ocellaris", "Danio rerio")
    for k, split in enumerate(("train", "val", "test")):
        rows = [(f"f{k}{i}.jpg", species[i % 3]) for i in range(3)]
        for fname, _ in rows:
            Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(fv / "Images" / fname)
            Image.new("L", (8, 8), k).save(fv / "segmentation_masks" / "images" / f"{fname[:-4]}.png")
        for kind in ("segmentation", "classification"):
            (fv / f"{kind}_{split}.csv").write_text("filename,family,standardized_species\n"
                                                    + "".join(f"{f},Testidae,{s}\n" for f, s in rows))
    cols = ["genus", "species", *format_fishvista.HABITAT_COLS, *format_fishvista.MIGRATION_COLS, *format_fishvista.ENV_COLS]
    traits = [{"genus": "thunnus", "species": "albacares", "pelagic-oceanic": "1.0", "marine": "1.0"},
              {"genus": "amphiprion", "species": "ocellaris", "reef-associated": "1.0", "marine": "1.0"}]
    (root / "traits.csv").write_text(",".join(cols) + "\n" + "".join(",".join(t.get(c, "") for c in cols) + "\n"
                                                                    for t in traits))
    format_fishvista.segfolder(format_fishvista.Config(fv_root=fv, dump_to=root / "fv_seg", fishbase_csv=root / "traits.csv",
                                                       n_threads=4))
    format_fishvista.imgfolder(format_fishvista.Config(fv_root=fv, dump_to=root / "fv_img", n_threads=4))
    seg_rows = (root / "fv_seg" / "labels.csv").read_text().splitlines()
    require(len(seg_rows) == 1 + 6 and len(list((root / "fv_img").rglob("*.jpg"))) == 9,
            f"format_fishvista: {len(seg_rows) - 1} labelled images")
    out["ran"].append("tdiscovery.scripts.format_fishvista")
    rows = [{"stem": f"CAM{i:04d}", "subspecies": ("lativitta", "malleti")[i % 2], "view": "dorsal",
             "image": Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)),
             "mask": Image.fromarray(rng.integers(0, 3, (8, 8), dtype=np.uint8))} for i in range(4)]
    counts = download_butterflies.materialize(download_butterflies.Config(out=root / "bfly"), rows)
    require(counts == {"labels": 4, "written": 4, "skipped": 0}, f"download_butterflies.materialize: {counts}")
    out["ran"].append("tdiscovery.scripts.download_butterflies.materialize")
    env = scrape_fishbase.parse_environment(CL_FISHBASE_PAGE)
    require(env["marine"] == env["pelagic-oceanic"] == 1.0 and env["max_depth_m"] == 250.0 and env["freshwater"] == "",
            f"scrape_fishbase.parse_environment: {env}")
    out["ran"].append("tdiscovery.scripts.scrape_fishbase.parse_environment")
    out["seconds"]["formats, materialize, parse"] = time.perf_counter() - t0
    # push_dinov3: eval metrics in the offline tracker, from each run's
    # inference (L0 from token_acts, MSE a token from metrics.json).
    runs_root = ch["runs"]["runs_root"]
    layers = {"r1": 0, "r2": 1, "b1": dims["layer"]}
    for run_id in layers:
        art = runs_root / run_id / "inference" / (out["bird"]["dir"] if run_id == "b1" else ch["split_dirs"]["validation"]).name
        acts = scipy.sparse.load_npz(art / "token_acts.npz")
        metrics = json.loads((art / "metrics.json").read_text())
        rec = root / "tracker" / "saev" / run_id
        rec.mkdir(parents=True)
        (rec / "summary.json").write_text(json.dumps({"eval/l0": acts.nnz / acts.shape[0],
                                                      "eval/mse": metrics["mse_per_token"]}))
    (root / "run_ids.json").write_text(json.dumps({str(v): [k] for k, v in layers.items()}))
    staging = root / "staging"
    _ch_timed(out, "push_dinov3 --dry-run", lambda: push_dinov3.main([
        "push", "--runs-root", str(runs_root), "--run-ids", str(root / "run_ids.json"), "--tracker-root",
        str(root / "tracker"), "--staging", str(staging), "--dry-run", "--device", device]))
    manifest = json.loads((staging / "manifest.json").read_text())
    require(sorted(m["run_id"] for m in manifest) == sorted(layers)
            and all(m["sha256"] == push_dinov3.sha256_file(push_dinov3.ckpt_fpath(runs_root, m["run_id"])) for m in manifest)
            and "saev_tpu_torch.nn.load" in (staging / "README.md").read_text(),
            f"push_dinov3: staged {manifest}")
    out["ran"].append("tdiscovery.scripts.push_dinov3 --dry-run")
    return out


def run_contrib_last(dims: dict, device: str, root: pathlib.Path, ch: dict) -> dict:
    """The contrib_last phase's path at `dims` (module doc, phase 22) in
    phase 21's root, after `run_contrib_host` (its output `ch`). The CPU
    runs it too, at small `dims`."""
    import importlib.util

    out = {"seconds": {}, "ran": [], "import_errors": {}, "batches": 0}
    _cl_birdsong(dims, device, root, ch, out)
    _cl_study(dims, device, root, ch, out)
    _cl_fish(dims, root, ch, out)
    _cl_dataprep(dims, device, root, ch, out)
    out["missing"] = {what: pkg for what, pkg in CL_OPTIONAL if importlib.util.find_spec(pkg) is None}
    return out


def phase_contrib_last(root: pathlib.Path, ch: dict) -> dict:
    """The last of contrib on a Bird-MAE-Large run inferred on the card and
    on phase 21's tree (module doc, phase 22). Returns the path's launches
    (K6 in every inference batch)."""
    t_phase = time.perf_counter()
    card = card_and_limit()
    reset_counts()
    with plain_spy() as plain:
        out = run_contrib_last(CL, "cuda", root, ch)
    launches = counts()
    # The CPU's encode takes K6's plain version, so it runs after the count.
    fx_cmp = _ch_fx_check(CL, out["bird"]["run"], out["bird"]["dir"], layer=CL["layer"])
    torch.cuda.empty_cache()
    require(not plain, f"contrib_last: plain versions ran on the card: {plain}")
    want = dict.fromkeys(KERNELS, 0) | {"kth_value": out["batches"]}
    require(launches == want, f"contrib_last: launches {launches}, expected {want}")
    require_topk_agrees("contrib_last: token_acts", fx_cmp, INTERP_REL_MSE)
    sec, bird, ext = out["seconds"], out["bird"], out["extract"]
    log(f"contrib_last ({card}): " + "; ".join(f"{k} {v:.2f} s" for k, v in sec.items()))
    log(f"contrib_last ({card}): {CL['bird_arch']} (d_model 1024, 24 layers) on {CL['clips']} clips, "
        f"{CL['planted']} with a {CL['tone_hz'] / 1e3:g} kHz tone over time patches {CL['tone_t']} (mel patch "
        f"{bird['mel_patch']}), channel {CL['bad_channel']} planted; extraction at layer {CL['layer']}: "
        f"{ext['clips_s']:.1f} clips/s over the {ext['loop_s']:.2f} s loop ({ext['entry_point_s']:.2f} s the entry "
        f"point), loader wait ms {ext['wait_ms']}, forward ms {ext['forward_ms']}; the tone's projection "
        f"{bird['separation'][1]:.3f} against the other clips' {bird['separation'][0]:.3f}; TopK-{CL['top_k']} at "
        f"d_sae {CL['d_sae']}, K6 launched {launches['kth_value']} times (one an inference batch of {CL['batch']} "
        f"rows, {out['batches']} batches), no plain version; token_acts on {CL['ref_rows']} rows: "
        f"{topk_note(fx_cmp, INTERP_REL_MSE)}; latent {CL['latent']}'s top clips {bird['planted_top']} (planted), "
        f"its time clip {bird['time_clip_patches']:g} time patches, energy {bird['energy'][0]:.1f} of the window's "
        f"{bird['energy'][1]:.1f}; stats' outliers {bird['outliers']}, audio/image norm ratio "
        f"{bird['norm_ratio']:.3f}; page {len(bird['latents'])} latents, {bird['cards']} cards; study "
        f"{out['study']}; fish {out['fish']}")
    for what, err in out["import_errors"].items():
        log(f"contrib_last: {what} raised ImportError as it must: {err}")
    log(f"contrib_last modules ran: {', '.join(out['ran'])}; could not import: "
        + (", ".join(f"{what} ({pkg})" for what, pkg in out["missing"].items()) or "none"))
    log(f"contrib_last: the phase {time.perf_counter() - t_phase:.1f} s ({card})")
    return {"launches": launches, "out": out}


# Phase 23 (notebooks): contrib's 21 notebook drivers that reach the JAX
# package, as the port's copies, each run as `python <file>` runs it (one
# process, `runpy`, each driver with its environment and working directory)
# over phase 21's and 22's root: their runs, shards and token_acts (K6
# inferred them on the card), and what the phase writes from those runs
# (module doc, phase 23). Each entry:
# (the copy, what it prints before it needs an optional package, what it
# prints after, the optional packages it needs in that order). Where one is
# missing, the driver stops on the ImportError that names it and must print
# what comes before; else it runs to its end and prints all.
NB = "saev_tpu_torch/tdiscovery/notebooks"
NB_DRIVERS = {
    "birdset": ("saev_tpu_torch/birdsong/notebooks/birdset.py",
                ("== audio ==", "== image ==", "audio_vs_image", "pathological channel: ", "dominance (resid):"),
                ("saved ",), ("matplotlib",)),
    "explore": ("saev_tpu_torch/birdsong/notebooks/explore.py",
                ("tokens x", "mean L0", "latent ", "wrote galleries under", "frontier:", "render clips for:"), (), ()),
    "clips": ("saev_tpu_torch/birdsong/notebooks/clips.py", ("1 runs with clip galleries", "Wrote 2 pages"), (), ()),
    "001_actfn": (f"{NB}/001_actfn.py", ("3 runs loaded from", "top-k(k=", "frontier:"), (), ()),
    "002_ablations": (f"{NB}/002_ablations.py", ("3 runs loaded from", "mean final MSE", "mean final dead"), (), ()),
    "002_optim": (f"{NB}/002_optim.py", ("8 runs.", "adam |", "muon |"), ("saved optim_pareto_grid.png",),
                  ("matplotlib",)),
    "003_auxk": (f"{NB}/003_auxk.py", ("8 runs.", "auxk |", "no-aux |", ": train ", " eval "),
                 ("saved auxk_pareto_grid.png",), ("matplotlib",)),
    "005_butterflies": (f"{NB}/005_butterflies.py", ("8 runs, ",), ("pareto ckpts", "Saved "), ("matplotlib",)),
    "009_pe_core": (f"{NB}/009_pe_core.py", ("8 runs", "Backbones:"), ("pareto ckpts", "Saved "), ("matplotlib",)),
    "007_cambridge_sae": (f"{NB}/007_cambridge_sae.py", ("8 runs",), ("dead_frac", "Saved "), ("matplotlib",)),
    "008_pe": (f"{NB}/008_pe.py", ("2 runs with probe metrics", "purity@16="), ("Saved ",), ("matplotlib",)),
    "metrics": (f"{NB}/metrics.py", ("2 runs; models:",), ("Saved ",), ("matplotlib",)),
    "baselines": (f"{NB}/baselines.py", ("1 baseline runs, 2 SAE runs.", "k-means", "fit mse/inertia="), (), ()),
    "visuals": (f"{NB}/visuals.py", ("1 runs with galleries", "Wrote 2 pages"), (), ()),
    "007_cambridge_mimicry": (f"{NB}/007_cambridge_mimicry.py", ("lativitta dorsal vs malleti dorsal",
                                                                  "classifier checkpoints."), (), ()),
    "004_fishbase": (f"{NB}/004_fishbase.py", (), (), ()),
    "004_fishbase_cls": (f"{NB}/004_fishbase_cls.py", ("Per-class view for 'class'", "Best run for 'class'"), (), ()),
    "006_proposal_audit": (f"{NB}/006_proposal_audit.py", (), ("auc_b", "h1_layer_yield"), ("sklearn", "matplotlib")),
    "exploration": ("saev_tpu_torch/mimics/exps/001-heliconius/exploration.py", ("pooled features",), (), ()),
    "butterflies": (f"{NB}/butterflies.py", ("Saved ",), (), ()),
    "fishvista": (f"{NB}/fishvista.py", ("N=128:", "usable ratios"), ("Saved ", " patches"), ("matplotlib",)),
}
NB_LIMIT = 300  # seconds the drivers' process may take
# The study runs beside phase 21's: (run id, optimizer, AuxK, layer).
NB_STUDY = (("s1", "adam", "auxk", 0), ("s2", "muon", "auxk", 0), ("s3", "adam", "no-aux", 0),
            ("s4", "muon", "no-aux", 0), ("s5", "adam", "auxk", 1), ("s6", "muon", "auxk", 1))

NB_RUNNER = r"""
import contextlib, importlib.abc, io, json, os, pathlib, runpy, sys, time, traceback
spec = json.loads(sys.argv[1])
sys.path.insert(0, spec["repo"])
from chip_smoke import _MeanHead, counts, reset_counts


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in spec["block"]:
            raise ModuleNotFoundError(f"No module named {name!r}", name=name)


if spec["block"]:
    import importlib.util

    real_find_spec = importlib.util.find_spec
    importlib.util.find_spec = lambda name, *a: None if name.split(".")[0] in spec["block"] else real_find_spec(name, *a)
    sys.meta_path.insert(0, Block())
out = {}
reset_counts()
for name, path, env in spec["drivers"]:
    cwd = pathlib.Path(spec["cwd"]) / name
    cwd.mkdir(parents=True, exist_ok=True)
    saved = (dict(os.environ), list(sys.path), list(sys.argv))
    os.environ.update(env)
    sys.argv = [path]
    os.chdir(cwd)
    buf, res = io.StringIO(), {"exit": 0, "error": None}
    t0 = time.perf_counter()
    try:
        # A driver runs as __main__, where phase 21's pickled nearest-mean
        # head (made without scikit-learn) names its class when chip_smoke.py
        # runs as a script.
        with contextlib.redirect_stdout(buf):
            runpy.run_path(path, init_globals={"_MeanHead": _MeanHead}, run_name="__main__")
    except SystemExit as err:
        res["exit"] = 0 if err.code is None else err.code
    except Exception as err:
        res["exit"], res["error"] = 1, f"{type(err).__name__}: {err}"
        res["traceback"] = traceback.format_exc()[-3000:]
    res["seconds"], res["stdout"] = time.perf_counter() - t0, buf.getvalue()
    os.environ.clear()
    os.environ.update(saved[0])
    sys.path[:], sys.argv[:] = saved[1], saved[2]
    out[name] = res
    try:
        import matplotlib.pyplot as plt

        plt.close("all")
    except ImportError:
        pass
with open(spec["out"], "w") as fd:
    json.dump({"drivers": out, "launches": counts()}, fd)
"""


def _nb_eval(art: pathlib.Path) -> dict:
    """A run's eval on one split from its inference: L0 and dead latents from
    token_acts, the MSEs from metrics.json."""
    import scipy.sparse

    acts = scipy.sparse.load_npz(art / "token_acts.npz").tocsc()
    metrics = json.loads((art / "metrics.json").read_text())
    return {"l0": acts.nnz / acts.shape[0], "mse": metrics["mse_per_token"],
            "normalized_mse": metrics["normalized_mse"], "n_dead": int((np.diff(acts.indptr) == 0).sum())}


def _nb_probe_metrics(train_art: pathlib.Path, test_art: pathlib.Path, train_name: str, n_latents: int,
                      n_classes: int, rng) -> None:
    """probe1d_metrics.npz on both splits and the test split's
    probe1d_metrics__train-<train>.npz, from the seed (the files `tdiscovery
    probe1d` and `metrics` write)."""
    np.savez(train_art / "probe1d_metrics.npz", loss=rng.random((n_latents, n_classes)).astype(np.float32),
             weights=rng.standard_normal((n_latents, n_classes)).astype(np.float32))
    np.savez(test_art / "probe1d_metrics.npz", loss=rng.random((n_latents, n_classes)).astype(np.float32))
    np.savez(test_art / f"probe1d_metrics__train-{train_name}.npz", ap=rng.random(n_classes).astype(np.float32),
             precision=rng.random(n_classes).astype(np.float32), recall=rng.random(n_classes).astype(np.float32),
             f1=rng.random(n_classes).astype(np.float32), top_labels=rng.integers(0, n_classes, (n_latents, 20)),
             nnz_per_latent=rng.integers(0, 40, n_latents), n_pos_per_class=rng.integers(1, 64, n_classes))


def _nb_inputs(dims: dict, device: str, root: pathlib.Path, ch: dict, cl: dict) -> dict:
    """What the drivers read beyond phases 21 and 22, in root/nb: a summary
    tracker and a JSONL tracker of r1, r2 and b1 (each run's eval measured
    from its inference); two runs roots that link r1 and r2, study/ with six
    study runs beside them (optimizer and AuxK variants: config and shard
    links only, seeded summaries) and probe/ with a k-means baseline run;
    probe metrics of r1, r2 and the baseline (seeded); a two-valued column
    in phase 21's labels. Returns each driver's environment."""
    from saev_tpu_torch import disk

    nb = root / "nb"
    runs_root, val, train = ch["runs"]["runs_root"], ch["split_dirs"]["validation"], ch["split_dirs"]["training"]
    bird = cl["bird"]["dir"]
    rng = np.random.default_rng(SEED + 90)
    tracker, jsonl = nb / "tracker" / "saev", nb / "wandb" / "saev"
    study, probe = nb / "study" / "saev" / "runs", nb / "probe" / "saev" / "runs"
    for run_id, shards in (("r1", val), ("r2", val), ("b1", bird)):
        ev = _nb_eval(runs_root / run_id / "inference" / shards.name)
        (tracker / run_id).mkdir(parents=True)
        (tracker / run_id / "summary.json").write_text(json.dumps({"eval": ev, "loss": {"n_dead": ev["n_dead"]}}))
        (jsonl / run_id).mkdir(parents=True)
        config = json.loads((runs_root / run_id / "checkpoint" / "config.json").read_text()) | {"optim": "adam"}
        (jsonl / run_id / "config.json").write_text(json.dumps({"config": config, "tags": ["notebooks"]}))
        (jsonl / run_id / "metrics.jsonl").write_text(json.dumps({
            "step": 0, "_step": 0, "loss/l0": ev["l0"], "loss/mse": ev["mse"],
            "metrics/normalized_mse": ev["normalized_mse"], "loss/n_dead": ev["n_dead"]}) + "\n")
    for runs in (study, probe):
        runs.mkdir(parents=True)
        for run_id in ("r1", "r2"):
            (runs / run_id).symlink_to(pathlib.Path("..", "..", "..", "..", "saev", "runs", run_id))
    rel = pathlib.Path("..", "..", "..", "..", "..", "..", "saev", "shards")
    d_sae = dims["d_sae"]
    for run_id, optim, aux, layer in NB_STUDY:
        run = disk.Run.new(run_id, train_shards_dir=rel / train.name, val_shards_dir=rel / val.name, runs_root=study)
        act = {"key": "top-k", "top_k": dims["top_k"],
               "aux": {"key": aux, "k_aux": 512, "alpha": 0.03125} if aux == "auxk" else {"key": aux}}
        (run.run_dir / "checkpoint" / "config.json").write_text(json.dumps({
            "sae": {"d_sae": d_sae, "activation": act}, "val_data": {"layer": layer}, "objective": {"n_prefixes": 1},
            "lr": 1e-3, "optim": optim}))
        (tracker / run_id).mkdir(parents=True)
        (tracker / run_id / "summary.json").write_text(json.dumps({
            "eval": {"l0": float(dims["top_k"] * (0.5 + rng.random())), "normalized_mse": float(rng.random()),
                     "n_dead": int(rng.integers(0, d_sae // 4))}, "loss": {"n_dead": int(rng.integers(0, d_sae // 4))}}))
    # A two-valued label column for 006's heads (scikit-learn 1.8 on fits
    # liblinear's L1 head on two classes only).
    labels = (ch["seg_root"] / "labels.csv").read_text().splitlines()
    (ch["seg_root"] / "labels.csv").write_text("\n".join(
        [labels[0] + ",pair"] + [f"{row},{'ab' if row.split(',')[1] in 'ab' else 'rest'}" for row in labels[1:]]) + "\n")
    n_classes = ch["n_classes"] + 1
    for run_id in ("r1", "r2"):
        _nb_probe_metrics(runs_root / run_id / "inference" / train.name, runs_root / run_id / "inference" / val.name,
                          train.name, d_sae, n_classes, rng)
    kb1 = probe / "kb1"
    for sub in ("checkpoint", "links", "inference"):
        (kb1 / sub).mkdir(parents=True)
    for name, split in (("train-shards", train), ("val-shards", val)):
        (kb1 / "links" / name).symlink_to(rel / split.name)
        (kb1 / "inference" / split.name).mkdir()
    (kb1 / "checkpoint" / "baseline.pt").write_bytes(
        (json.dumps({"method": "kmeans", "k": 8, "metrics": {"eval/inertia": 1.5}}) + "\n").encode() + b"\0")
    _nb_probe_metrics(kb1 / "inference" / train.name, kb1 / "inference" / val.name, train.name, 8, n_classes, rng)
    out = nb / "out"
    sh = {"TD_RUNS_ROOT": str(study), "TD_TRACKER": str(tracker.parent)}
    pr = {"TD_RUNS_ROOT": str(probe), "TD_TRACKER": str(tracker.parent), "TD_SHARDS_ROOT": str(root / "saev" / "shards")}
    arch = dims["bird_arch"]
    envs = {
        "birdset": {"BIRDSET_AUDIO_SHARDS": str(bird), "BIRDSET_IMG_SHARDS": str(val),
                    "BIRDSET_AUDIO_LAYER": str(dims["layer"]), "BIRDSET_OUT": str(nb / "birdset_report.json"),
                    "BIRDSET_TRACE": "1", "BIRDSET_ARCH": f"{arch}={root / f'{arch}.pt'}"},
        "explore": {"BIRDSONG_RUN": str(runs_root / "b1"), "BIRDSONG_SHARDS": str(bird), "BIRDSONG_TRACKER": str(jsonl)},
        "clips": {"BS_RUNS_ROOTS": str(runs_root), "BS_OUT": str(out / "clips")},
        "001_actfn": {"SAEV_TRACKER": str(jsonl)},
        "002_ablations": {"SAEV_TRACKER": str(jsonl)},
        "002_optim": {"OPTIM_RUNS": str(study), "OPTIM_TRACKER": str(tracker.parent), "OPTIM_EXPECTED": "2"},
        "003_auxk": {"AUXK_RUNS": str(study), "AUXK_TRACKER": str(tracker.parent), "AUXK_EXPECTED": "2"},
        "008_pe": {**pr, "TD_OUT": str(out / "008_pe")},
        "metrics": {**pr, "TD_OUT": str(out / "metrics")},
        "baselines": {"TD_RUNS": str(probe), "TD_SHARDS": str(root / "saev" / "shards"), "TD_TRACKER": str(tracker.parent)},
        "visuals": {"TD_RUNS_ROOTS": str(runs_root), "TD_OUT": str(out / "visuals"), "TD_N_FEATURES": "8"},
        "007_cambridge_mimicry": {"MIMICRY_RUNS": str(runs_root), "MIMICRY_SHARDS": str(val)},
        "004_fishbase": {"FISHBASE_SHARDS": str(val), "FISHBASE_RUN": str(runs_root / "r1"),
                         "FISHBASE_TRAITS": str(root / "traits.csv")},
        "004_fishbase_cls": {"TD_RUNS_ROOT": str(runs_root), "TD_TRACKER": str(tracker.parent)},
        "006_proposal_audit": {"TD_RUN": str(runs_root / "r1"), "TD_TRAIN_SHARDS": str(train),
                               "TD_TEST_SHARDS": str(val), "TD_SOURCE_COL": "pair",
                               "TD_OUT": str(out / "006_proposal_audit")},
        "exploration": {"MIMICS_RUNS": str(runs_root), "MIMICS_SHARD": val.name, "MIMICS_TASK": "class",
                        "MIMICS_OUT": str(out / "exploration")},
        "butterflies": {"BF_ROOT": str(ch["seg_root"]), "BF_N": "4", "BF_OUT": str(out / "butterflies")},
        "fishvista": {"FV_ROOT": str(root / "fv_seg"), "FV_OUT": str(out / "fishvista")},
    }
    for name in ("005_butterflies", "009_pe_core", "007_cambridge_sae"):
        envs[name] = {**sh, "TD_OUT": str(out / name)}
    if device == "cpu":
        envs["birdset"]["BIRDSET_DEVICE"] = "cpu"
    return envs


def run_notebooks(dims: dict, device: str, root: pathlib.Path, ch: dict, cl: dict, block: tuple = ()) -> dict:
    """The notebooks phase's path (module doc, phase 23) in phases 21's and
    22's root, after them (their outputs `ch` and `cl`): the drivers' inputs,
    then one process that runs the 21 copies, `block` made unimportable
    there (the CPU rehearses the card's missing packages so). Returns each
    driver's stdout, exit, error and seconds, the kernels' launches in that
    process (counted from 0 before the first driver), and its seconds."""
    import os

    repo = pathlib.Path(__file__).resolve().parent
    envs = _nb_inputs(dims, device, root, ch, cl)
    spec = {"repo": str(repo), "cwd": str(root / "nb" / "cwd"), "out": str(root / "nb" / "drivers.json"),
            "block": list(block), "drivers": [[name, str(repo / f[0]), envs[name]] for name, f in NB_DRIVERS.items()]}
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(repo)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", NB_RUNNER, json.dumps(spec)], cwd=root, env=env,
                          capture_output=True, text=True, timeout=NB_LIMIT)
    took = time.perf_counter() - t0
    require(proc.returncode == 0, f"notebooks: the drivers' process exited {proc.returncode}\n{proc.stderr[-3000:]}")
    return json.loads((root / "nb" / "drivers.json").read_text()) | {"seconds": took}


def check_notebooks(out: dict, dims: dict, missing: set) -> dict:
    """Each driver ran to its end and printed its markers, or stopped on the
    ImportError of the first package it needs that is `missing`, having
    printed what comes before; birdset's trace found the planted channel.
    Returns {driver: the package it stopped on} for those that stopped."""
    stopped = {}
    for name, (_, before, after, needs) in NB_DRIVERS.items():
        res = out["drivers"][name]
        gone = [p for p in needs if p in missing]
        if gone:
            require(str(res["error"]).startswith(("ImportError", "ModuleNotFoundError"))
                    and f"No module named '{gone[0]}'" in res["error"],
                    f"notebooks: {name} must stop on the ImportError of {gone[0]}, not exit {res['exit']} "
                    f"{res['error']}\n{res.get('traceback', '')}")
            stopped[name] = gone[0]
            want = before
        else:
            require(res["exit"] == 0 and res["error"] is None,
                    f"notebooks: {name} exited {res['exit']} {res['error']}\n{res.get('traceback', '')}")
            want = before + after
        lacking = [m for m in want if m not in res["stdout"]]
        require(not lacking, f"notebooks: {name} did not print {lacking}:\n{res['stdout'][-2000:]}")
    channel = [line for line in out["drivers"]["birdset"]["stdout"].splitlines() if line.startswith("pathological")]
    require(channel == [f"pathological channel: {dims['bad_channel']}"],
            f"notebooks: birdset's trace found {channel}, planted {dims['bad_channel']}")
    return stopped


def phase_notebooks(root: pathlib.Path, ch: dict, cl: dict) -> dict:
    """contrib's 21 notebook drivers as the port's copies over phase 21's and
    22's root (module doc, phase 23); birdset's trace on the card at
    Bird-MAE-Large width. Launches no kernel (counted in the drivers'
    process)."""
    import importlib.util

    t_phase = time.perf_counter()
    card = card_and_limit()
    out = run_notebooks(CL, "cuda", root, ch, cl)
    missing = {p for p in ("sklearn", "matplotlib", "h5py") if importlib.util.find_spec(p) is None}
    stopped = check_notebooks(out, CL, missing)
    require(out["launches"] == dict.fromkeys(KERNELS, 0), f"notebooks: kernels launched {out['launches']}")
    log(f"notebooks ({card}): " + "; ".join(f"{k} {v['seconds']:.2f} s" for k, v in out["drivers"].items())
        + f"; the drivers' process {out['seconds']:.1f} s; kernel launches in it: none")
    dom = [line for line in out["drivers"]["birdset"]["stdout"].splitlines() if line.startswith("dominance")]
    log(f"notebooks ({card}): birdset's trace on the card at {CL['bird_arch']} width (d_model 1024, 24 layers) "
        f"from phase 22's checkpoint: pathological channel {CL['bad_channel']} (planted); {dom[0][:160]}")
    for name, package in stopped.items():
        log(f"notebooks: {name} stopped on the ImportError of {package}, which this machine lacks: "
            f"{out['drivers'][name]['error'][:160]}")
    log(f"notebooks: the phase {time.perf_counter() - t_phase:.1f} s ({card})")
    return out

def main() -> int:
    name = phase_device()
    phase_build()
    errs = phase_parity()
    phase_wide()
    phase_reference()
    warm_counts, _ = phase_slice()
    wide_counts, _ = phase_wide_steps()
    steady_counts, _, (ts, x, prefixes, n_dead) = phase_steady()
    metric_counts = phase_metrics(ts, x, prefixes, n_dead)
    with torch.no_grad():
        h = x @ ts.params["W_enc"][0] + ts.params["b_enc"][0]
    log(f"K1 on the two-SAE state's pre-activations ({n_dead} latents pinned dead): {_k1_fallbacks(h, TOP_K)} "
        f"of {B} rows took the whole-row fallback")
    del ts, h
    torch.cuda.empty_cache()
    times = phase_timing()
    bench_counts, bench_errs, bench_times = phase_benches()
    errs |= bench_errs
    times |= bench_times
    phase_profile()
    from saev_tpu_torch.scripts import kprof
    log(f"kprof.device_profile took {kprof.device_profile.retakes} profiles again")
    torch.cuda.empty_cache()
    root = pathlib.Path(tempfile.mkdtemp(prefix="saev_job_"))
    try:
        job = phase_job(root)
        job_counts = job["launches"]
        torch.cuda.empty_cache()
        infer_counts = phase_inference(root, job)
        torch.cuda.empty_cache()
        interp_counts = phase_interpret(job)["launches"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    act_counts = phase_activations(errs)
    torch.cuda.empty_cache()
    muon_counts, _ = phase_muon()
    torch.cuda.empty_cache()
    high_counts, _ = phase_high()
    torch.cuda.empty_cache()
    phase_extract()
    torch.cuda.empty_cache()
    root = pathlib.Path(tempfile.mkdtemp(prefix="saev_multi_"))
    try:
        multi_counts = phase_multi(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    td_counts = phase_tdiscovery()["launches"]
    torch.cuda.empty_cache()
    ii_counts = phase_interactive_interp()["launches"]
    torch.cuda.empty_cache()
    root = pathlib.Path(tempfile.mkdtemp(prefix="saev_contrib_host_"))
    try:
        ch = phase_contrib_host(root)
        ch_counts = ch["launches"]
        torch.cuda.empty_cache()
        cl = phase_contrib_last(root, ch["out"])
        cl_counts = cl["launches"]
        torch.cuda.empty_cache()
        phase_notebooks(root, ch["out"], cl["out"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    launches = {k: warm_counts[k] + wide_counts[k] + steady_counts[k] + metric_counts[k] + job_counts[k]
                + infer_counts[k] + interp_counts[k] + act_counts[k] + muon_counts[k] + high_counts[k]
                + multi_counts[k] + td_counts[k] + ii_counts[k] + ch_counts[k] + cl_counts[k]
                for k in KERNELS}
    # K7 runs on the multi path (feature-parallel training); the other bench
    # kernels only in the benches phase.
    launches |= {k: bench_counts[k] for k in BENCH_KERNELS if k != "grouped_prefix_base"}
    for path, got, kernels in (("slice", warm_counts, WARM_KERNELS),
                               ("wide steps", wide_counts, WARM_KERNELS + ("kth_value_masked",)),
                               ("steady", steady_counts, WARM_KERNELS + ("kth_value_masked",)),
                               ("metrics", metric_counts, ("kth_value",)),
                               ("job", job_counts, JOB_KERNELS),
                               ("inference", infer_counts, INFER_KERNELS),
                               ("interpret", interp_counts, INTERP_KERNELS),
                               ("activations", act_counts, WARM_KERNELS[1:] + ("kth_value_masked",)),
                               ("muon", muon_counts, WARM_KERNELS + ("kth_value_masked",)),
                               ("high", high_counts, ("kth_value", "kth_value_masked")),
                               ("multi", multi_counts, JOB_KERNELS + ("grouped_prefix_base",)),
                               ("tdiscovery", td_counts, TD_KERNELS),
                               ("interactive_interp", ii_counts, II_KERNELS),
                               ("contrib_host", ch_counts, CH_KERNELS),
                               ("contrib_last", cl_counts, CL_KERNELS),
                               ("benches", bench_counts, BENCH_KERNELS)):
        for k in kernels:
            require(got[k] > 0, f"{path}: kernel {k} was never launched")
    require(not any(high_counts[k] for k in WARM_KERNELS), f"high: K1-K4 launched {high_counts}")
    kernels = [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": errs[k], **times[k], "lib_ms": times[k]["library_ms"]}
        for k, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
