#!/usr/bin/env python3
"""End-to-end proof that the PyTorch/CUDA port (src/repro_torch) serves and
trains on one NVIDIA GPU, on its own hand-written kernels.

    python3 chip_smoke.py

Builds the CUDA kernels from the checkout's sources (nvcc, into build/, one
process per source, all at once), then runs these phases, each printing JSON
lines; any failure raises and exits non-zero:

  device        GPU name and power limit, torch/CUDA versions, kernel build
                time, and the device-to-device copy rate (printed beside each
                bound; the bounds use the data sheet's HBM3 rate, 3.35e12
                B/s, which no kernel's bytes can beat);
                then the registers and spills ptxas reported for the bf16
                tensor-core flash_attention and paged chunk bodies, the
                split-K decode body (paged pools and dense cache), the split
                combine, the matvec bodies, quant_matmul's schedules and
                ssd_scan's two kernels, and the split counts the planners
                pick for the serve shape, recurrentgemma-2b's ring,
                qwen2-0.5b's generate cache, the bf16 paged chunk (serve
                shape, C 5) and matvec_left at 16384^2, and ssd_scan's grid
                at mamba2-780m's B 2 and 4 and stencil3d's at 96^3 and
                512^3, each beside its resident blocks an SM (the library's
                occupancy query), and rglru_scan's at recurrentgemma-2b's
                (2, *, 2560) (one block a work item of 32 columns), and
                sum3d's grid at 96^3 and 512^3 beside its resident blocks;
                rglru_kernel, stencil3d_kernel and sum3d_kernel join the
                ptxas lines.
  kernels       each kernel against its plain PyTorch version at the serving
                path's shapes (Hq 14, Hkv 2, D 64, page 16, B 8, and the serve
                phase's one-row 128-token chunk; rows 1-4 also at D 128 at
                qwen2.5-3b's heads (Hq 16 / Hkv 2) and granite-8b's (Hq 32 /
                Hkv 8) in bf16 over bf16 and int8 pages: the decode, the
                one-row 128-token chunk and the verify C 5; rows 1-4, 6 and 7
                at head dim 112 and kimi-k2's heads (Hq 64 / Hkv 8): the
                decode over bf16, int8 and int4 pages, the one-row 128-token
                chunk and the verify C 5 over the same three, flash_attention
                causal at (2, 64 / 8, 512, 112) and flash_decode over a
                512-slot cache; rows 6 and 7 at the cross-attention path's
                shapes: flash_attention non-causal at whisper's encoder (1,
                20 / 20, 1500, 64) and cross prefill (4, 20 / 20, 64 vs 1500,
                64) and the vision model's (2, 64 / 8, 128 vs 6404, 128), key
                tails of 28 and 4 past the 64-key tiles, and flash_decode at
                pos Tc - 1 over (4, 20, 1500, 64) and (2, 8, 6404, 128)
                caches, with device ms beside SDPA's; the quantized attention over
                int8 and int4 pools; quant_matmul at the MLP's decode and
                chunk shapes, int8 and int4 weights), in f32
                (tolerance 2e-5) and bf16 (within one bf16 ulp of the plain
                output plus the f32 tolerance 2e-5, for outputs near 0 whose
                bf16 spacing is finer than f32 sums resolve): error, kernel
                ms, plain ms, bound ms, and one PyTorch call computing the
                same function as a yardstick (scaled_dot_product_attention
                over the densified, dequantized cache; torch.matmul on the
                dequantized weight), timed here only: the port never calls it;
                the chunk kernels and quant_matmul add the device time a call
                of the kernel and of that call (calls queued back to back),
                quant_matmul the schedule and K split it launched, and a line
                lists quant_matmul's bf16 records at w_down (M 8, K 4864,
                N 896) and at one 128-token chunk.
                The split-K paged decode also at lengths on a split boundary
                of the serve shape's plan, one past it and inside the first
                split, over dense, int8 and int4 pages, and over an aliased
                and permuted block table (rows 1-3 fork row 0: its pages, one
                private last page each, other lengths; rows 4-7 take rows
                0-3's tables in a permuted order), dense and int8 pages, the
                reordered rows bit-equal to their parents, with device ms.
                Then the dense-cache kernels at the generate phase's shapes:
                flash_attention on qwen2's prefill (8, 14, 256, 64) causal,
                the engine's (1, 14, 512, 64), a windowed case and a ragged
                (1, 14, 101, 64) (Tq * G not a multiple of 64);
                flash_decode on (8, 14, 1, 64) against (8, 2, 288, 64) caches
                at pos 0-287, one windowed, with device time beside SDPA's,
                and at the positions around its split plan's first split
                edges, with and without a window; ssd_scan at mamba2-780m's width
                (2, 512, 48, 64), N 128, a ragged T 389 and an initial state,
                the generate phase's B 4 at T 512 and 389, and T 65 (tolerance
                1e-4 f32, bf16 y one ulp + 1e-4; device ms beside the dtype's
                own bound; two runs bit-equal; no library call computes the
                scan, so its library_ms is null). Then
                recurrentgemma-2b's: rglru_scan at (2, 2600, 2560) and
                (2, 2040, 2560), from an initial state too, with device ms,
                and two chained halves bit-equal to one run (1e-5 f32, bf16
                one ulp + 1e-5 against the plain version; library_ms null:
                no single PyTorch call computes a linear recurrence
                stably); flash_attention at D 256,
                (2, 10, 2600, 256) vs (2, 1, 2600, 256), window 2048;
                flash_decode (2, 10, 1, 256) over a (2, 1, 2048, 256)
                ring before, at and after the wrap, against its plain
                version (device time beside SDPA's) and against the
                reference's ring mask, and around its split edges.
  generate      the dense-cache serve path, make_prefill(max_len) then
                make_serve_step greedily: qwen2-0.5b (B 8, prompts of 256,
                32 new tokens) and mamba2-780m (B 4, prompts of 512 and 389,
                32 new tokens) at full width in f32, kernel tokens against
                the same path with attn_impl="torch" on the card, with the
                prefill and last-step logits drift: qwen2 at 2 layers, at 12
                on the reference's init (printed, not gated: chaotic at
                depth) and at 24 rescaled (condition_attention); mamba2 at 2
                and 48 layers; recurrentgemma-2b (B 2, prompts of 2600 and
                2040: the prefill's window band and ring roll, the decode's
                wrap at 2048; 32 new tokens) at 5 layers, at 13 on the
                reference's init after a generate_sensitivity line (how far
                two plain computations drift there; printed, not gated:
                chaotic at depth, as qwen2) and at 26 rescaled. Then one
                bf16 run of each: prefill ms, step ms p50, tokens/s and
                launches per kernel, counts zeroed just before and read just
                after (the kernels line reports their sum over the cells);
                every kernel of a cell must have launched.
  generate_cross
                the cross-attention families on the dense cache,
                make_prefill(max_len)(..., batch_inputs=) then
                make_serve_step greedily: whisper-large-v3 (B 4, 1500
                seeded frames, prompts of 64, 32 new tokens) and
                llama-3.2-vision-90b (B 2, 6404 seeded image embeddings,
                prompts of 128, 16 new), every vision gate set to 1.0 (the
                reference's init sets it to 0, where tanh(0) erases the cross
                layer). f32 tokens of the kernels against attn_impl="torch"
                on the card: whisper at 2 + 2 layers (gated), 16 + 16 on the
                reference's init (printed, not gated: chaotic at depth) and
                32 + 32 rescaled (condition_attention, which reaches the
                encoder's and the cross layers' projections; gated); a
                generate_cross_sensitivity line (the plain path on the card
                against the CPU at 2 + 2 on the reference's init: cuBLAS and
                the CPU's sums drift apart there), then whisper at 2 + 2
                rescaled with int8 MLP weights against the same model on
                the CPU (quant_matmul launched; gated), vision at 5 layers
                (one group; gated). Then bf16 timed runs: whisper at full size, vision
                at full width, 10 of 100 layers (2 groups): encode ms,
                prefill ms, step ms p50, tokens/s, peak memory, launches and
                the decode step's bytes floor (decoder weights and caches at
                3.35e12 B/s, derived); each model freed before the next. A
                cross_kernels line then gives rows 6 and 7 at these shapes
                beside their launches in these runs.
  engine_exact  qwen2-0.5b at full width in f32, random weights from a
                seeded generator: six requests through ServeEngine with
                monolithic (its prefill launches flash_attention) and with
                chunked prefill, a pool small enough to preempt; greedy
                tokens must equal an unbatched Model.forward recompute on
                the plain attention (attn_impl="torch"). Run twice: at 2 layers with the reference's init,
                and at all 24 layers with the attention projections rescaled
                to their true fan-in (see condition_attention). Before it,
                three lines measure how far two plain computations of the
                same logits drift apart: the reference's init is chaotic at
                24 layers, the rescaled one is not.
  engine_exact_spec
                qwen2-0.5b at 2 layers, f32: the K 4 / S 2 speculative
                engine on the card against the plain engine on the CPU, f32
                and int8 pages; multi_step 4 against 1 on the card.
  engine_exact_branch
                qwen2-0.5b at full width, 2 layers, f32, reference init,
                page 16, monolithic and chunked prefill: best-of-n (n 4,
                prompts of 37 and 48 tokens, 12 new) equal to the CPU engine
                and branch b to a serial request at seed + b; beam (width 4,
                n 2) equal to the CPU engine, scores within 1e-4, counters
                equal, a reorder; a JSON grammar (every output parses,
                multi_step 4 equal to 1, card equal to CPU); the host tier
                (pool 58, 32 host pages, f32 and int4 pages) equal to a
                tier-less large-pool engine (f32) or to the same tiered
                engine on the CPU (int4), swapping out and prefetching,
                every promoted page byte-equal to the bytes demoted, a
                retained session's follow-up prefetching. Rows 1-4 launch.
  engine_exact_quant
                the same requests with int8 MLP weights (build_model(...,
                quantized=True)) over int8 and int4 KV pages: greedy tokens of
                the engine on the card (kernels) must equal the same engine
                with the same weights on the CPU (plain versions), in both
                prefill modes, at 2 layers (reference init) and, for int8 KV,
                at 6 layers (rescaled; 8 new tokens a request; 24 until
                engine_exact_record, autotune and serve_models were added, cut
                to keep the script's time: the CPU engine took about a minute
                a mode at 24). All three
                quantized kernels launch.
  engine_exact_record
                record_logits on qwen2-0.5b at full width, 2 layers, f32,
                reference init, the six engine_exact requests: in both
                prefill regimes the card's tokens equal the CPU engine's,
                each recorded row's argmax is its token and the rows agree
                with the CPU's within 1e-2 absolute; then
                aligned_max_logit_err of int8 and int4 pages against f32
                pages on the card, in the reference's (0, 0.75) / (0, 2.0),
                or within 1.1x the CPU engine's own error where the CPU
                already passes the bound (both printed).
  serve         the same model in bf16, chunked prefill, prefix sharing,
                max_batch 8, 16 requests, three runs on fresh engines:
                tokens/s, step and chunk times, TTFT, then a serve_summary
                line. Launch counts are zeroed just before and read just
                after each run (the serving path), and both attention
                kernels must have launched; the kernels line reports the
                first run's.
  serve_spec    the serve workload with multi_step 4 and with speculation,
                a speculative run over int8 pages, the predictable stream.
  serve_branch  the serve workload as a mix: four best-of-n requests (n 4),
                four beam groups (width 4, n 2), four JSON-grammar requests
                and four plain ones, in a pool of 56 pages with a 256-page
                host tier: tokens/s beside plain serve's, step ms p50, TTFT
                p95, peak pages beside n full copies', the fork / reorder /
                CoW and swap / prefetch counters. Every grammar output
                parses, beam results are ranked, the tier swapped and
                prefetched, the allocator conserves, rows 1 and 2 launched.
  serve_quant   the serve workload with int8 MLP weights over int8, then
                int4, KV pages, one run each, counts zeroed just before and
                read just after; the three quantized kernels must have
                launched, and the int8 pool must be >= 1.9x smaller than the
                bf16 one. The kernels line reports the int8 run's counts.
  autotune      kernels/autotune.py at the serve workload's shape (bf16,
                batch 8, its max_len), the tuning table in a fresh temporary
                directory: a cold resolve sweeps page sizes 8 / 16 / 32 (the
                decode at block_pages 1: the CUDA decode ignores the knob)
                and chunk widths of 1, 2, 4 pages at the winner (every
                candidate's us printed, the winner, its source, the sweep's
                seconds; the decode and chunk kernels launch); a warm resolve
                returns source "cached" and launches no kernel; then one
                serve run with page_size and chunk_tokens deferred to the
                tuner, whose metrics carry the tuned_* keys of the cold
                winner, its tokens/s beside plain serve's (not gated).
  serve_models  llama3.2-1b (16 layers, D 64, group 4), qwen2.5-3b (36, D
                128, group 8, untied head) and granite-8b (36, D 128, group
                4, untied head) at full size in bf16, random weights made on
                the card: each after a check at full width, 2 layers, f32 (3
                requests, 8 new tokens, chunked prefill, card tokens equal to
                the CPU engine's), one run of the serve workload with 8
                requests of 64-512 prompt tokens, 16 new each: every request
                completes, both paged kernels launch; tokens/s, step p50,
                TTFT p95, pool bytes and peak memory printed; each model is
                freed before the next.
  engine_exact_moe
                dbrx-132b and kimi-k2 at 2 layers, f32, reference init, at a
                reduced width that keeps each config's expert count, top-k,
                capacity factor, norm, head dim and GQA group (dbrx: 16
                experts top-4, layernorm, D 128, group 6, d_model 1536, d_ff
                1536; kimi: 384 top-8, rmsnorm, D 112, group 8, d_model 768,
                d_ff 384): three requests through the engine on the card and
                on the CPU, monolithic and chunked prefill over f32 pages and
                dbrx chunked over int8 pages, greedy tokens equal; the paged
                decode and chunk kernels (rows 3-4 over int8 pages) launch.
  serve_moe     dbrx-132b at full width, 8 of its 40 layers (~55 GB of bf16
                weights), and kimi-k2 at full width, 1 of its 61 layers (~39
                GB; a second would not fit with the init's f32 draw of one
                384-expert leaf), random weights made on the card, the
                serve_models workload (8 requests, 16 new tokens): every
                request completes, both paged kernels launch (D 112 for
                kimi); tokens/s, step p50, TTFT p95, pool bytes and peak
                memory printed beside the card; each model freed before the
                next. A d112_kernels line then gives the D 112 rows' numbers
                beside their launches in kimi's run.
  paper         the paper-suite kernels behind the mdspan layout dispatch
                (sum3d, stencil3d, tinymatsum static and dynamic, matvec
                right and left), each against its plain version at the
                reference's sizes (96^3, N 100k/200k of 3x3, 2048^2) and at
                HBM-filling ones (512^3, N 8M, 16384^2), sum3d and
                stencil3d and tinymatsum in bf16 too, with a library call as
                yardstick (torch.sum, torch.add, torch.mv, conv3d + pad) and,
                for sum3d, stencil3d and tinymatsum, device times beside it;
                sum3d must repeat bit for bit (matvec right and left too), and runs at
                a ragged size too (95x97x99,
                509x511x513) on inputs of mean 1, and, at 95x97x99 on a view 4
                (f32) / 2 (bf16) bytes off 16 (its scalar head and tail), on
                integers in [-3, 3] whose total it must give exactly; tinymatsum also at 8x8 (N
                1M) and on a view off 16 bytes (N 100k), with a
                tinymatsum_static_over_dynamic line (device ms) for each
                case. Then the zero-overhead comparison
                (ops.sum3d / ops.matvec on an MdSpan against the raw kernel
                call: host us and device ms per call, printed, not gated),
                and the main path: the ops dispatchers on MdSpans at the
                HBM sizes, counts zeroed just before and read just after,
                every output checked against its plain version and every
                kernel launched. Tolerances: sum3d 1e-5 * sum(|x|) (exact on
                the integer view), stencil 1e-4, tinymatsum bit-equal (the
                same f32 additions and roundings), matvec 1e-5 * sum_j |A_ij v_j| per row (sums of
                up to 16384 terms).
  train_exact   one training step on the kernels (attn_impl="auto":
                flash_attention forward with its lse, flash_attention_bwd
                backward; the scans' forward and backward kernels inside
                SSDScanFn / RGLRUScanFn) against the plain path
                (attn_impl="torch": flash_vjp.flash_attention_torch and
                autograd of ssd_torch / rglru_torch) on the card, f32, TF32
                off, the same init_params with the attention projections
                rescaled (condition_attention): llama3.2-1b's width at 2
                layers (B 2 x 512), whisper-large-v3's at 2 + 2 layers
                (448 decoder positions against 1500 frames), mamba2-780m's
                at 2 and recurrentgemma-2b's at 3 (rec, rec, local_attn),
                B 2 x 512: loss within 1e-5, every gradient leaf within
                1e-3 of its max-abs; for llama AdamW's m and v after 1 and
                3 steps at lr 0 (f32 and int8 moments) and three steps at
                lr 1e-3 (see train_exact_phase for the rules). Each
                family's kernels launch, and the scans' plain twins are
                called none of the times in the kernels' run.
  train         TrainerLoop at full width, bf16, remat on, f32 moments, 8
                steps each, checkpoints into a temporary directory with only
                the final save: llama3.2-1b (16 layers, d_model 2048, 32 /
                8 heads of 64, vocab 128256) and mamba2-780m (48 layers,
                d_model 1536, 48 heads of 64, N 128, vocab 50280) at B 4 x
                2048, recurrentgemma-2b (26 layers, d_model 2560, MQA 10 /
                1 of 256, window 2048, vocab 256000) at B 1 x 4096 (the
                batch cut from 2 to fit 80 GB; listed in the record's
                ``reduced``): step ms
                p50 (steps 2-7), tokens/s, peak memory, each step's loss
                (finite), the launches a step of the family's kernels
                (zeroed just before, read just after; no plain twin
                called), the final save's bytes and seconds, then the save
                restored and every leaf checked bit for bit against the
                state in memory.
  train_loop    the smoke configs' loops on the card (llama3.2 and mamba2):
                each learns over 12 steps, a second run resumes from its
                checkpoint, and a run with simulate_failure(at_step=5)
                restores its latest checkpoint and finishes at step 10.
  train_sharded_exact
                the sharded train step on SHARDED_W ranks (a process group
                in this process: NCCL, one rank on the one card, since
                scripts/probe_card_ranks.py found two ranks on one card
                failing) on every ("data", "model") mesh SHARDED_W allows,
                every block in one block map (core.distributed.block_map),
                for every family (SHARDED_EXACT): llama3.2-1b's width at 2
                layers, kimi-k2's 2-layer MOE_EXACT_WIDTH model (D 112),
                mamba2-780m at 2 layers, recurrentgemma-2b at 3 (rec, rec,
                local_attn), whisper-large-v3 at 2 + 2 and
                llama-3.2-vision-90b at one group of a reduced width (gate
                0.7); f32, TF32 off, B 2 x 512 (whisper 448), train_rules,
                against the port's one-device step on the card (loss within
                1e-5, every gradient leaf within 1e-3 of its max-abs, one
                AdamW step's loss and grad_norm), with each family's kernels
                (ssd_scan, ssd_scan_bwd, rglru_scan, rglru_scan_bwd,
                flash_attention, flash_attention_bwd) launched inside the
                block maps and no plain version called; kimi-k2's layer-0
                experts also through the expert-parallel block
                (apply_moe_ep) against the einsum path at capacity factor 8
                (outputs within 2e-4, gradients within 5e-3).
  train_sharded llama3.2-1b (B 4 x 2048, the final save), mamba2-780m (B 4 x
                2048) and recurrentgemma-2b (B 1 x 4096; 2048 if 4096 runs
                out of memory, listed as a cut) at full width, bf16, remat,
                f32 moments, train_rules on a (1, SHARDED_W) mesh: 6 steps
                each through TrainerLoop(model_axis=SHARDED_W); step ms p50
                of steps 2-5 beside the one-device train cell's of the same
                call, tokens/s, each rank's peak memory, the collectives'
                calls and bytes and the DTensor op dispatches and
                redistributions of one step (core.distributed's
                CollectiveCounter and DispatchCounter), each step's loss
                (finite), and the launches a step of the family's kernels.
  serve_sharded_exact
                serving on the (SHARDED_W, 1) mesh (one NCCL rank) against
                the one-device path, f32, TF32 off, serve_rules: every
                family at SHARDED_EXACT's cut through make_prefill(mesh,
                rules) + 8 greedy make_serve_step steps (B 2 x 64), tokens
                identical; the paged engine (chunked, page 16) for
                qwen2-0.5b and kimi-k2 at 2 layers, streams identical; the
                family's kernels launched inside the serving maps, no plain
                version (ops' plain versions counted while it runs).
  serve_sharded the serve workload (qwen2-0.5b, 16 requests) through
                ServeEngine(mesh, serve_rules) and llama3.2-1b's dense-cache
                generate at full width (B 8, a 4096-token prompt in a
                32768-slot cache, 32 new) through the mesh, each beside its
                one-device run of the same call (one device, mesh, mesh, one
                device), bf16: tokens identical, step p50 over the one
                device's, the idle share of 4 mesh steps (torch.profiler),
                one step's DTensor dispatches and collectives. The kernels
                phase also holds flash_decode's lse output (row 7's local
                step of the kv_seq-sharded decode) at D 64 / 112 / 128 /
                256 against decode_attention_torch(return_lse=True), at a
                negative and a past-the-end local position, its output
                bit-equal without lse, and 4 slices of llama3.2-1b's decode
                cache (B 8, 32 / 8 heads, S 32768, D 64) and of D 128 / 112
                / 256 caches (S 8192) attended at their local positions and
                merged against the unsplit kernel and the plain version,
                with the device ms of one slice's step and of the whole's
                (a seqshard_kernels line repeats them with the launches).
  dryrun        the dry run (repro_torch.launch.dryrun) in subprocesses on
                the host's CPU, on this machine's torch: its CLI for
                llama3.2-1b train_4k on pod16x16 (rank 0 of a fake world of
                256, traced at full depth, the two-probe fit beside it), its
                JSON summary and trace seconds; and the (1, 1) cells of
                train_sharded (llama3.2-1b, B 4 x 2048) and serve_sharded's
                generate (B 8, 32768 slots), whose argument bytes by group
                (params, moments, caches, inputs) must equal the local bytes
                those phases handed their steps on the card, exactly; the
                train cell's model flops (the traced matmuls, the attention's
                T x T products counted for their causal live half) over
                train_sharded's step p50: a model-flops utilisation against
                the data sheet's 989e12.
  kernels line  {"kernels": [...]} with the numbers of each of the 18
                kernels: the 15 that replace the reference's 15 Pallas
                functions, flash_attention_bwd, which replaces its
                hand-written custom_vjp backward (kernels/flash_vjp.py:94),
                and ssd_scan_bwd / rglru_scan_bwd, which replace the
                gradients its training path takes by autodiff of its scans
                (kernels/ops.py:437::ssd_jnp, models/rglru.py:88's
                associative scan); the backward kernels' launches from the
                train phase. The kernels phase holds the scans' backward
                kernels against their plain twins (ssd_bwd_torch,
                rglru_bwd_torch) at mamba2-780m's (4, 2048, 48, 64), N 128,
                and recurrentgemma-2b's (2, 4096, 2560), and at ragged t /
                T with an initial state and a final-state gradient, f32 and
                bf16, in flash_attention_bwd's rule, two runs bit-equal,
                device ms beside the twin's and the bound. The kernels phase holds
                it against the plain backward (flash_bwd_torch) at
                llama3.2-1b's (4, 32 / 8, 2048, 64) causal, (2, 16 / 2,
                1024, 128) causal, a 64-key window at D 64, whisper's cross
                shape (4, 20 / 20, 448 vs 1500, 64) non-causal, D 256 at
                (1, 8 / 1, 512, 256), recurrentgemma-2b's local attention
                (1, 10 / 1, 2600, 256) with window 2048, and a ragged (1,
                12 / 4, 777, 128) causal with q_offset a tensor (the
                forward's lse output also held against the plain
                attention's), f32 (max |err| <= 1e-4 of each
                gradient's max-abs: its sums over Tq run in another order)
                and bf16 (within one bf16 ulp of the plain value plus that
                bound), two runs bit-equal, with device ms beside the
                device ms of torch.autograd.grad through
                scaled_dot_product_attention (timed only) and the bound
                (2.5 x the forward's flops over the live pairs, or the bytes
                of q, k, v, out, dO, lse, dq, dk, dv at 3.35e12 B/s), the
                plan's splits, tiles and grids and the SHA-256 of (dq, dk,
                dv); a train_kernels line repeats its bf16 rows beside the
                train phase's launches.

Then the card's name and power limit as nvidia-smi prints them, and as the
last line {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It needs one GPU and exits non-zero without one (or without the repo).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SERVE_RUNS = 3  # serve runs in one process: the host-bound metrics spread from run to run
NOMINAL_BW = 3.35e12  # H100 SXM HBM3, bytes/s (data sheet)
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # dense, data sheet
ATTN_SOURCE = "src/repro_torch/kernels/csrc/paged_attention.cu"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
PAPER_SOURCE = "src/repro_torch/kernels/csrc/paper_suite.cu"
DECODE_SOURCE = "src/repro_torch/kernels/csrc/decode_splitk.cuh"  # every decode's split-K body
PORTED = {  # kernel -> (the TPU kernel it replaces, its source)
    "paged_decode": ("src/repro/kernels/paged_attention.py:151", DECODE_SOURCE),
    "paged_prefill_chunk": ("src/repro/kernels/paged_attention.py:575", ATTN_SOURCE),
    "paged_decode_quant": ("src/repro/kernels/paged_attention.py:387", DECODE_SOURCE),
    "paged_prefill_chunk_quant": ("src/repro/kernels/paged_attention.py:756", ATTN_SOURCE),
    "quant_matmul": ("src/repro/kernels/quant_matmul.py:57",
                     "src/repro_torch/kernels/csrc/quant_matmul.cu"),
    "sum3d": ("src/repro/kernels/sum3d.py:37", PAPER_SOURCE),
    "stencil3d": ("src/repro/kernels/stencil3d.py:59", PAPER_SOURCE),
    "tinymatsum_static": ("src/repro/kernels/tinymatsum.py:34", PAPER_SOURCE),
    "tinymatsum_dynamic": ("src/repro/kernels/tinymatsum.py:65", PAPER_SOURCE),
    "matvec_right": ("src/repro/kernels/matvec.py:33", PAPER_SOURCE),
    "matvec_left": ("src/repro/kernels/matvec.py:64", PAPER_SOURCE),
    "flash_attention": ("src/repro/kernels/flash_attention.py:104", FLASH_SOURCE),
    "flash_decode": ("src/repro/kernels/flash_attention.py:222", DECODE_SOURCE),
    "ssd_scan": ("src/repro/kernels/ssd_scan.py:85", "src/repro_torch/kernels/csrc/ssd_scan.cu"),
    "rglru_scan": ("src/repro/kernels/rglru_scan.py:50",
                   "src/repro_torch/kernels/csrc/rglru_scan.cu"),
    # no pallas_call: the reference's hand-written custom_vjp backward, which
    # its training path runs (kernels/flash_vjp.py::_bwd)
    "flash_attention_bwd": ("src/repro/kernels/flash_vjp.py:94",
                            "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"),
    # no pallas_call: the gradients the reference's training path takes by
    # autodiff of its scans (ssd_jnp, and the RG-LRU associative scan)
    "ssd_scan_bwd": ("src/repro/kernels/ops.py:437",
                     "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu"),
    "rglru_scan_bwd": ("src/repro/models/rglru.py:88",
                       "src/repro_torch/kernels/csrc/rglru_scan_bwd.cu"),
}
DENSE_PATH = ("paged_decode", "paged_prefill_chunk")
GENERATE_PATH = ("flash_attention", "flash_decode", "ssd_scan", "rglru_scan")
QUANT_PATH = ("paged_decode_quant", "paged_prefill_chunk_quant", "quant_matmul")
QUANT_KV_PATH = ("paged_decode_quant", "paged_prefill_chunk_quant")
VERIFY_C = (2, 5)  # verify widths K + 1 checked in the kernels phase
VERIFY_CURSORS = [37, 130, 255, 16] * 2  # B 8: mid-page and on page boundaries
SPEC_K, SPEC_S = 4, 2  # the speculative phases' draft length and windows a dispatch
SPEC_KEYS = ("fused_steps", "spec_windows", "spec_accepted_tokens", "accepted_tokens_per_step",
             "draft_hit_rate", "spec_rollback_tokens", "spec_backoffs")
PAPER_PATH = ("sum3d", "stencil3d", "tinymatsum_static", "tinymatsum_dynamic", "matvec_right",
              "matvec_left")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median over ``reps`` of one call timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def copy_bandwidth() -> float:
    """Device-to-device copy rate (bytes read + written per second) of a
    1 GiB buffer."""
    n = 1 << 28
    src = torch.empty(n, dtype=torch.float32, device="cuda").uniform_()
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src), reps=10)
    return 2 * src.numel() * 4 / (ms * 1e-3)


# =====================================================================================
# phase: kernels
# =====================================================================================
BF16_ATOL = 2e-5  # the f32 tolerance: near 0 the bf16 spacing is finer than f32 sums resolve


def bf16_excess(got: torch.Tensor, want: torch.Tensor):
    """(largest |got - want| in bf16 ulps of want, largest |got - want| minus
    (1 ulp + BF16_ATOL)): the second is <= 0 when every element is within one
    bf16 ulp of the plain output plus the f32 tolerance."""
    w = want.float()
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), e - 8)  # bf16: 8 significant bits
    d = (got.float() - w).abs()
    return float((d / ulp).max()), float((d - ulp - BF16_ATOL).max())


def check_and_time(name, dtype, kernel, plain, library, nbytes, flops, bw, case,
                   tolerance=None, phase="kernels", device_time=False):
    """One kernel against its plain version on the same inputs, then timed
    beside the plain version and the library call (None where no single
    PyTorch call computes the function); ``tolerance(got, want)`` ->
    (ok, description) replaces the default f32 / bf16 rule. ``device_time``
    adds the device time per call of the kernel and of the library call
    (device_ms_per_call: calls queued back to back, so a host slower than
    the kernel does not show). ``l2_resident``: the bytes fit in the card's
    L2, so timed calls after the first read from it and may beat
    ``bound_ms`` (an HBM bound)."""
    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    err = float((got.float() - want.float()).abs().max())
    if tolerance is not None:
        ok, tol = tolerance(got, want)
        extra = {}
    elif dtype == torch.float32:
        ok = bool(torch.allclose(got, want, rtol=2e-5, atol=2e-5))
        tol = "allclose rtol=atol=2e-5"
        extra = {}
    else:
        ulps, excess = bf16_excess(got, want)
        ok = excess <= 0.0
        tol = f"<= 1 bf16 ulp of the plain output + {BF16_ATOL}, elementwise"
        extra = {"max_bf16_ulps": ulps}
    t_bytes, t_ops = nbytes / NOMINAL_BW, flops / PEAK_FLOPS[dtype]
    rec = {
        "phase": phase, "kernel": name, "dtype": str(dtype).split(".")[1], **case,
        "max_abs_err": err, "tolerance": tol, "ok": ok, **extra,
        "ms": time_ms(kernel), "plain_ms": time_ms(plain, reps=5),
        "library_ms": time_ms(library, reps=10) if library is not None else None,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_ms_copy_rate": max(nbytes / bw, t_ops) * 1e3,
        "bytes": nbytes, "flops": flops,
        "l2_resident": got.is_cuda and nbytes <= torch.cuda.get_device_properties(
            got.device).L2_cache_size,
    }
    if device_time:
        rec["device_ms"] = device_ms_per_call(kernel, n=50)
        rec["library_device_ms"] = (device_ms_per_call(library, n=50)
                                    if library is not None else None)
    emit(rec)
    if not ok:
        raise AssertionError(f"{name} {case} disagrees with its plain version: {rec}")
    return rec


def densify(pool, tables):
    b, mp = tables.shape
    _, hkv, ps, d = pool.shape
    return pool[tables.long()].transpose(1, 2).reshape(b, hkv, mp * ps, d)


def sdpa(q, k, v, mask):
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)


def paged_pools(g, dtype, num, hkv, ps, d, b, max_pages, bits=(8, 4)):
    """Random K/V page pools of ``dtype`` and a permuted (b, max_pages) block
    table, the same values as intN pages (the engine's encoding) for each of
    ``bits``, and the densified caches (dequantized for intN) the SDPA
    yardstick reads: a namespace (rnd, kp, vp, bt, kd, vd, quant = {bits: (kq,
    ks, vq, vs, kd, vd, packed head dim)})."""
    from repro_torch.serving.engine import KV_DTYPES

    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)
    kp, vp = rnd(num, hkv, ps, d), rnd(num, hkv, ps, d)
    perm = torch.randperm(num - 1, generator=g, device="cuda") + 1
    bt = perm.reshape(b, max_pages).to(torch.int32).contiguous()
    quant = {}
    for nbits in bits:
        spec = KV_DTYPES[f"int{nbits}"]
        kq, vq = spec.encode_pages(kp), spec.encode_pages(vp)
        quant[nbits] = (kq["q"], kq["scale"], vq["q"], vq["scale"],
                        densify(spec.decode_pages(kq["q"], kq["scale"]).to(dtype), bt),
                        densify(spec.decode_pages(vq["q"], vq["scale"]).to(dtype), bt),
                        spec.packed_dim(d))
    return SimpleNamespace(rnd=rnd, kp=kp, vp=vp, bt=bt, kd=densify(kp, bt), vd=densify(vp, bt),
                           quant=quant)


def decode_rows(p, q, lens, dtype, bw, case):
    """Rows 1 and 3: the paged decode of ``q`` (B, Hq, 1, D) over the pools of
    ``p`` at ``lens``, dense then each intN encoding, against the plain
    versions with SDPA over the densified caches beside them ->
    {"dense" or bits: record}."""
    from repro_torch.kernels import paged_attention as pa

    b, hq, _, d = q.shape
    hkv, ps = p.kp.shape[1], p.kp.shape[2]
    esz = q.element_size()
    cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    mask = (torch.arange(p.bt.shape[1] * ps, device="cuda")[None, :] < cl[:, None])[:, None, None]
    tokens = sum(lens)
    live_pages = sum(-(-n // ps) for n in lens)
    small = 2 * q.numel() * esz + p.bt.numel() * 4 + b * 4  # q, out, tables, lengths
    recs = {"dense": check_and_time(
        "paged_decode", dtype,
        lambda: pa.paged_flash_decode(q, p.kp, p.vp, p.bt, cl),
        lambda: pa.paged_decode_attention_torch(q, p.kp, p.vp, p.bt, cl),
        lambda: sdpa(q, p.kd, p.vd, mask),
        small + 2 * tokens * hkv * d * esz, 4 * tokens * hq * d, bw, case, device_time=True,
    )}
    for bits, (kq, ks, vq, vs, kdq, vdq, dq) in p.quant.items():
        recs[bits] = check_and_time(
            "paged_decode_quant", dtype,
            lambda: pa.paged_flash_decode_quant(q, kq, ks, vq, vs, p.bt, cl, bits=bits),
            lambda: pa.paged_decode_attention_quant_torch(q, kq, ks, vq, vs, p.bt, cl,
                                                          bits=bits),
            lambda: sdpa(q, kdq, vdq, mask),
            small + 2 * tokens * hkv * dq + 2 * live_pages * hkv * 4,
            4 * tokens * hq * d, bw, {**case, "bits": bits}, device_time=True,
        )
    return recs


def chunk_rows(p, hq, c, cursors, dtype, bw, case, bits=()):
    """Rows 2 and 4: a C-token chunk a row (B = len(cursors), Hq ``hq``) over
    the pools of ``p`` past ``cursors``, dense then each of ``bits``, against
    the plain versions with SDPA over the densified past and the present
    beside them -> {"dense" or bits: record}."""
    from repro_torch.kernels import paged_attention as pa

    hkv, ps, d = p.kp.shape[1], p.kp.shape[2], p.kp.shape[3]
    esz = p.kp.element_size()
    nb = len(cursors)
    btc = p.bt[:nb].contiguous()
    qc, ck, cv = p.rnd(nb, hq, c, d), p.rnd(nb, hkv, c, d), p.rnd(nb, hkv, c, d)
    cur = torch.tensor(cursors, dtype=torch.int32, device="cuda")
    s = p.bt.shape[1] * ps
    past = torch.arange(s, device="cuda")[None, None, :] < cur[:, None, None]
    tq = torch.arange(c, device="cuda")
    present = (tq[None, :] <= tq[:, None])[None].expand(nb, c, c)
    cmask = torch.cat([past.expand(nb, c, s), present], dim=-1)[:, None]
    keys = sum(x * c + c * (c + 1) // 2 for x in cursors)
    small = (2 * qc.numel() + ck.numel() + cv.numel()) * esz + btc.numel() * 4 + nb * 4
    case = {**case, "B": nb, "C": c, "cursors": cursors}
    kcat, vcat = torch.cat([p.kd[:nb], ck], dim=2), torch.cat([p.vd[:nb], cv], dim=2)
    recs = {"dense": check_and_time(
        "paged_prefill_chunk", dtype,
        lambda: pa.paged_flash_prefill_chunk(qc, ck, cv, p.kp, p.vp, btc, cur),
        lambda: pa.paged_prefill_chunk_torch(qc, ck, cv, p.kp, p.vp, btc, cur),
        lambda: sdpa(qc, kcat, vcat, cmask),
        small + 2 * sum(cursors) * hkv * d * esz, 4 * keys * hq * d, bw, case, device_time=True,
    )}
    past_pages = sum(-(-x // ps) for x in cursors)
    for nbits in bits:
        kq, ks, vq, vs, kdq, vdq, dq = p.quant[nbits]
        kk, vv = torch.cat([kdq[:nb], ck], dim=2), torch.cat([vdq[:nb], cv], dim=2)
        recs[nbits] = check_and_time(
            "paged_prefill_chunk_quant", dtype,
            lambda: pa.paged_flash_prefill_chunk_quant(qc, ck, cv, kq, ks, vq, vs, btc, cur,
                                                       bits=nbits),
            lambda: pa.paged_prefill_chunk_quant_torch(qc, ck, cv, kq, ks, vq, vs, btc, cur,
                                                       bits=nbits),
            lambda: sdpa(qc, kk, vv, cmask),
            small + 2 * sum(cursors) * hkv * dq + 2 * past_pages * hkv * 4,
            4 * keys * hq * d, bw, {**case, "bits": nbits}, device_time=True,
        )
    return recs


def kernel_phase(bw):
    """Every kernel against its plain version at the serving shapes; returns
    kernel name -> the record the kernels line reports (bf16 at the serve
    phase's shapes; int8 pools and weights for the quantized kernels)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    B, HQ, HKV, D, PS, MAXP = 8, 14, 2, 64, 16, 128
    NUM = B * MAXP + 1
    lens = [0, 1, 16, 100, 517, 1024, 1500, 2048]  # a length-0 row, exactly one page
    # chunk C in {16, 256, 5} at B 8 with cursors 0 and > 0, and the serve
    # phase's own shape (one row, a 128-token chunk)
    chunk_cases = ((16, [0, 16, 64, 256, 512, 1024, 1536, 1792]),
                   (256, [0, 0, 128, 256, 512, 1024, 1280, 1792]),
                   (5, [0, 3, 17, 100, 517, 1024, 1500, 2000]),
                   (128, [256]))
    quant_chunk_cases = {128, 256}
    # the speculative verify window: C = K + 1 (serve_spec's K 4 gives 5) at
    # cursors mid-page and on page boundaries, over dense and intN pools
    chunk_cases += tuple((c, VERIFY_CURSORS) for c in VERIFY_C)
    base = {"Hq": HQ, "Hkv": HKV, "D": D, "page_size": PS}
    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        esz = torch.tensor([], dtype=dtype).element_size()
        name = str(dtype).split(".")[1]
        p = paged_pools(g, dtype, NUM, HKV, PS, D, B, MAXP)
        q = p.rnd(B, HQ, 1, D)
        recs = decode_rows(p, q, lens, dtype, bw, {"B": B, **base, "lens": lens})
        if dtype == torch.bfloat16:
            main["paged_decode"], main["paged_decode_quant"] = recs["dense"], recs[8]
        split_decode_checks(q, p.kp, p.vp, p.bt, p.quant, dtype, esz, bw)
        main.update(aliased_decode_checks(q, p.kp, p.vp, p.quant[8], dtype, esz, bw))
        for c, cursors in chunk_cases:
            verify = cursors is VERIFY_CURSORS
            bits = tuple(p.quant) if c in quant_chunk_cases or verify else ()
            recs = chunk_rows(p, HQ, c, cursors, dtype, bw,
                              {**base, **({"verify": True} if verify else {})}, bits)
            if dtype == torch.bfloat16 and c == 128:
                main["paged_prefill_chunk"] = recs["dense"]
                main["paged_prefill_chunk_quant"] = recs[8]
            if verify:
                main[f"verify_paged_prefill_chunk_{name}_C{c}"] = recs["dense"]
                for nbits in bits:
                    main[f"verify_paged_prefill_chunk_quant{nbits}_{name}_C{c}"] = recs[nbits]
    d128_checks(bw, g)
    main.update({f"d112:{k}": rec for k, rec in d112_checks(bw, g).items()})
    main.update({f"cross:{k}": rec for k, rec in cross_checks(bw, g).items()})
    main["quant_matmul"] = quant_matmul_checks(bw, g)
    main.update(dense_cache_checks(bw, g))
    main.update(hybrid_checks(bw, g))
    torch.cuda.synchronize()
    return main


D128_HEADS = {"qwen2.5-3b": (16, 2), "granite-8b": (32, 8)}  # config -> (Hq, Hkv), D 128


def d128_checks(bw, g):
    """Rows 1-4 at head dim 128 and the dense configs' groups (qwen2.5-3b: Hq
    16 / Hkv 2, group 8; granite-8b: Hq 32 / Hkv 8, group 4), bf16, B 8, page
    16, 128 pages a row (the serve rows' lengths), over bf16 and int8 pages:
    the decode, a 128-token chunk (one row at cursor 256, the serve shape) and
    the verify window C 5 (B 8 at VERIFY_CURSORS), each against its plain
    version at the bf16 tolerance, with bound ms and SDPA's time beside it."""
    dtype = torch.bfloat16
    B, D, PS, MAXP = 8, 128, 16, 128
    lens = [0, 1, 16, 100, 517, 1024, 1500, 2048]
    for arch, (HQ, HKV) in D128_HEADS.items():
        p = paged_pools(g, dtype, B * MAXP + 1, HKV, PS, D, B, MAXP, bits=(8,))
        base = {"config": arch, "Hq": HQ, "Hkv": HKV, "D": D, "page_size": PS}
        decode_rows(p, p.rnd(B, HQ, 1, D), lens, dtype, bw, {"B": B, **base, "lens": lens})
        for c, cursors in ((128, [256]), (5, VERIFY_CURSORS)):
            chunk_rows(p, HQ, c, cursors, dtype, bw, base, bits=(8,))


D112_HEADS = (64, 8)  # kimi-k2-1t-a32b: Hq, Hkv (group 8), head dim 112


def d112_checks(bw, g):
    """Rows 1-4, 6 and 7 at head dim 112 and kimi-k2's heads (Hq 64, Hkv 8),
    bf16: the paged decode (B 8, page 16, 128 pages a row, the serve rows'
    lengths) over bf16, int8 and int4 pages, the chunk at C 128 (one row at
    cursor 256) and the verify C 5 (B 8 at VERIFY_CURSORS) over the same
    three, flash_attention causal at (2, 64 / 8, 512, 112) and flash_decode
    over a 512-slot cache (B 8) at positions 0, 383 and 511, each against its
    plain version at the bf16 tolerance, with device ms, the bound and SDPA's
    device ms beside it. Returns {row name: record} for PERF.md's D 112
    entries (int4 ones under "<name>_int4")."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    dtype = torch.bfloat16
    B, D, PS, MAXP, (HQ, HKV) = 8, 112, 16, 128, D112_HEADS
    lens = [0, 1, 16, 100, 517, 1024, 1500, 2048]
    p = paged_pools(g, dtype, B * MAXP + 1, HKV, PS, D, B, MAXP)
    base = {"config": "kimi-k2-1t-a32b", "Hq": HQ, "Hkv": HKV, "D": D, "page_size": PS}
    recs = decode_rows(p, p.rnd(B, HQ, 1, D), lens, dtype, bw, {"B": B, **base, "lens": lens})
    out = {"paged_decode": recs["dense"], "paged_decode_quant": recs[8],
           "paged_decode_quant_int4": recs[4]}
    recs = chunk_rows(p, HQ, 128, [256], dtype, bw, base, bits=(8, 4))
    out.update({"paged_prefill_chunk": recs["dense"], "paged_prefill_chunk_quant": recs[8],
                "paged_prefill_chunk_quant_int4": recs[4]})
    chunk_rows(p, HQ, 5, VERIFY_CURSORS, dtype, bw, {**base, "verify": True}, bits=(8, 4))
    q, k, v = p.rnd(2, HQ, 512, D), p.rnd(2, HKV, 512, D), p.rnd(2, HKV, 512, D)
    out["flash_attention"] = check_and_time(
        "flash_attention", dtype, lambda: fa.flash_attention(q, k, v),
        lambda: fa.attention_torch(q, k, v),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
        (2 * q.numel() + k.numel() + v.numel()) * 2, 4 * 2 * HQ * D * _causal_keys(512, 512, 0),
        bw, {**base, "B": 2, "Tq": 512, "Tk": 512, "causal": True}, device_time=True)
    S = 512
    q, kc, vc = p.rnd(B, HQ, 1, D), p.rnd(B, HKV, S, D), p.rnd(B, HKV, S, D)
    for pos in (0, 383, S - 1):
        pos_t = torch.tensor([pos], dtype=torch.int32, device="cuda")
        live = torch.arange(S, device="cuda") <= pos
        rec = check_and_time(
            "flash_decode", dtype, lambda: fa.flash_decode(q, kc, vc, pos_t),
            lambda: fa.decode_attention_torch(q, kc, vc, pos),
            lambda: F.scaled_dot_product_attention(q, kc, vc, attn_mask=live[None, None, None],
                                                   enable_gqa=True),
            2 * q.numel() * 2 + 4 + 2 * B * HKV * (pos + 1) * D * 2, 4 * B * HQ * D * (pos + 1),
            bw, {**base, "B": B, "S": S, "pos": pos}, device_time=True)
    out["flash_decode"] = rec
    return out


# (name, B, Hq, Hkv, Tq, Tk, D): whisper-large-v3's encoder self-attention
# and its decoder's cross prefill (64-token prompts over 1500 frames), and
# llama-3.2-vision's cross prefill (128-token prompts over 6404 image
# tokens); Tk 1500 and 6404 end in a tile of 28 and 4 keys (64-key tiles)
CROSS_ATTENTION_CASES = (("whisper_encoder", 1, 20, 20, 1500, 1500, 64),
                         ("whisper_cross", 4, 20, 20, 64, 1500, 64),
                         ("vision_cross", 2, 64, 8, 128, 6404, 128))
# (name, B, Hq, Hkv, Tc, D): the cross decode, flash_decode at pos Tc - 1
CROSS_DECODE_CASES = (("whisper_cross_decode", 4, 20, 20, 1500, 64),
                      ("vision_cross_decode", 2, 64, 8, 6404, 128))
# (name, M, K, N): whisper's int8 MLP, w_up and w_down, at one decode step (B
# 4) and over the encoder's 4 x 1500 frames
CROSS_QMM_CASES = (("whisper_w_up_decode", 4, 1280, 5120),
                   ("whisper_w_down_decode", 4, 5120, 1280),
                   ("whisper_w_up_encoder", 6000, 1280, 5120),
                   ("whisper_w_down_encoder", 6000, 5120, 1280))


def cross_checks(bw, g):
    """Rows 5-7 at the cross-attention path's shapes (CROSS_ATTENTION_CASES,
    CROSS_DECODE_CASES, CROSS_QMM_CASES), f32 and bf16: flash_attention
    non-causal at Tq != Tk over key tails, flash_decode at pos Tc - 1 (every
    slot live) and quant_matmul at whisper's int8 MLP, each against its
    plain version (the kernels' tolerances), with device ms, the bound and
    the library call's device ms beside it (SDPA non-causal with no mask,
    torch.matmul). Returns {case name: the bf16 record}."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        esz = torch.tensor([], dtype=dtype).element_size()
        rnd = lambda *sh: torch.randn(*sh, generator=g, device="cuda").to(dtype)
        for name, b, hq, hkv, tq, tk, d in CROSS_ATTENTION_CASES:
            q, k, v = rnd(b, hq, tq, d), rnd(b, hkv, tk, d), rnd(b, hkv, tk, d)
            rec = check_and_time(
                "flash_attention", dtype, lambda: fa.flash_attention(q, k, v, causal=False),
                lambda: fa.attention_torch(q, k, v, causal=False),
                lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True),
                (2 * q.numel() + k.numel() + v.numel()) * esz, 4 * b * hq * tq * tk * d, bw,
                {"case": name, "B": b, "Hq": hq, "Hkv": hkv, "Tq": tq, "Tk": tk, "D": d,
                 "causal": False, "tail_keys": tk % 64}, device_time=True)
            if dtype == torch.bfloat16:
                out[name] = rec
        for name, b, hq, hkv, tc, d in CROSS_DECODE_CASES:
            q, kc, vc = rnd(b, hq, 1, d), rnd(b, hkv, tc, d), rnd(b, hkv, tc, d)
            rec = check_and_time(
                "flash_decode", dtype, lambda: fa.flash_decode(q, kc, vc, tc - 1),
                lambda: fa.attention_torch(q, kc, vc, causal=False),
                lambda: F.scaled_dot_product_attention(q, kc, vc, enable_gqa=True),
                2 * q.numel() * esz + (kc.numel() + vc.numel()) * esz, 4 * b * hq * tc * d, bw,
                {"case": name, "B": b, "Hq": hq, "Hkv": hkv, "S": tc, "D": d, "pos": tc - 1},
                device_time=True)
            if dtype == torch.bfloat16:
                out[name] = rec
        for name, m, k, n in CROSS_QMM_CASES:
            rec = quant_matmul_record(g, bw, m, k, n, 8, dtype, {"case": name})
            if dtype == torch.bfloat16:
                out[name] = rec
    return out


def split_decode_checks(q, kp, vp, bt, quant, dtype, esz, bw):
    """The split-K decode at lengths on a split boundary of the plan the
    wrapper picks for the serve shape, one past it, inside the first split,
    0 and the full table, over dense, int8 and int4 pages."""
    from repro_torch.kernels import paged_attention as pa

    b, hq, _, d = q.shape
    _, hkv, ps, _ = kp.shape
    max_pages = bt.shape[1]
    splits, pps = pa.plan_decode_splits(max_pages, b, hkv, ps, d, pa.sm_count(q.device))
    run = pps * ps
    lens = [run, run + 1, run // 2, 0, 3 * run, 3 * run + 1, 5 * run - 1, max_pages * ps][:b]
    cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    live = torch.arange(max_pages * ps, device="cuda")[None, :] < cl[:, None]
    mask = live[:, None, None, :]
    tokens, live_pages = sum(lens), sum(-(-n // ps) for n in lens)
    small = 2 * q.numel() * esz + bt.numel() * 4 + b * 4
    case = {"B": b, "Hq": hq, "Hkv": hkv, "D": d, "page_size": ps, "lens": lens,
            "splits": splits, "pages_per_split": pps, "check": "split boundaries"}
    check_and_time(
        "paged_decode", dtype,
        lambda: pa.paged_flash_decode(q, kp, vp, bt, cl),
        lambda: pa.paged_decode_attention_torch(q, kp, vp, bt, cl),
        lambda: sdpa(q, densify(kp, bt), densify(vp, bt), mask),
        small + 2 * tokens * hkv * d * esz, 4 * tokens * hq * d, bw, case)
    for bits, (kq, ks, vq, vs, kdq, vdq, dq) in quant.items():
        check_and_time(
            "paged_decode_quant", dtype,
            lambda: pa.paged_flash_decode_quant(q, kq, ks, vq, vs, bt, cl, bits=bits),
            lambda: pa.paged_decode_attention_quant_torch(q, kq, ks, vq, vs, bt, cl, bits=bits),
            lambda: sdpa(q, kdq, vdq, mask),
            small + 2 * tokens * hkv * dq + 2 * live_pages * hkv * 4,
            4 * tokens * hq * d, bw, {**case, "bits": bits})


def aliased_tables(max_pages, ps, num_pages, seed=0):
    """Block tables as best-of-n forks and beam reorders leave them, B 8: row
    0 owns its pages (its last page partly filled); rows 1-3 are forks of
    row 0 (a leading run of its pages, then one private last page each,
    different lengths); rows 4-7 take rows 0-3's tables and lengths in a
    permuted order (a beam reorder rebinds whole rows)."""
    rng = np.random.default_rng(seed)
    pool = rng.permutation(np.arange(1, num_pages))
    n0 = max_pages - 2
    tables = np.zeros((8, max_pages), np.int32)
    lens = np.zeros((8,), np.int32)
    tables[0, :n0] = pool[:n0]
    lens[0] = (n0 - 1) * ps + 5
    for r, m in zip((1, 2, 3), (n0 - 1, n0 // 2, 1)):
        tables[r, :m] = pool[:m]
        tables[r, m] = pool[n0 + r]
        lens[r] = m * ps + 1 + 3 * r
    perm = [2, 0, 3, 1]
    tables[4:], lens[4:] = tables[perm], lens[perm]
    return (torch.from_numpy(tables).cuda(), torch.from_numpy(lens).cuda(),
            [int(n) for n in lens])


def aliased_decode_checks(q, kp, vp, q8, dtype, esz, bw):
    """The split-K paged decode (rows 1 and 3) at the serve shape over an
    aliased and permuted block table (aliased_tables), over ``dtype`` pages
    and int8 pages: each against its plain version, and the rows that read
    a reordered row's table with its query bit-equal to it. Returns the
    records by name for PERF.md."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serving.engine import KV_DTYPES

    b, hq, _, d = q.shape
    num, hkv, ps, _ = kp.shape
    max_pages = 128
    bt, cl, lens = aliased_tables(max_pages, ps, num)
    qa = q.clone()
    qa[4:] = q[[2, 0, 3, 1]]
    live = torch.arange(max_pages * ps, device="cuda")[None, :] < cl[:, None]
    mask = live[:, None, None, :]
    tokens = sum(lens)
    live_pages = sum(-(-n // ps) for n in lens)
    # the bytes the function must move: each distinct page it reads, once
    distinct = len({int(p) for r in range(b) for p in bt[r, :-(-lens[r] // ps)].tolist()})
    small = 2 * qa.numel() * esz + bt.numel() * 4 + b * 4
    case = {"B": b, "Hq": hq, "Hkv": hkv, "D": d, "page_size": ps, "lens": lens,
            "table": "aliased (rows 1-3 fork row 0) and permuted (rows 4-7 = rows 2, 0, 3, 1)",
            "distinct_pages": distinct, "row_pages": live_pages}
    out = {}
    got = pa.paged_flash_decode(qa, kp, vp, bt, cl)
    if not torch.equal(got[4:], got[[2, 0, 3, 1]]):
        raise AssertionError("aliased decode: a reordered row differs from its parent row")
    out[f"aliased_paged_decode_{str(dtype).split('.')[1]}"] = check_and_time(
        "paged_decode", dtype,
        lambda: pa.paged_flash_decode(qa, kp, vp, bt, cl),
        lambda: pa.paged_decode_attention_torch(qa, kp, vp, bt, cl),
        lambda: sdpa(qa, densify(kp, bt), densify(vp, bt), mask),
        small + 2 * distinct * hkv * ps * d * esz, 4 * tokens * hq * d, bw, case,
        device_time=True)
    kq, ks, vq, vs, _, _, dq = q8
    spec = KV_DTYPES["int8"]
    kdq = densify(spec.decode_pages(kq, ks).to(dtype), bt)
    vdq = densify(spec.decode_pages(vq, vs).to(dtype), bt)
    got = pa.paged_flash_decode_quant(qa, kq, ks, vq, vs, bt, cl, bits=8)
    if not torch.equal(got[4:], got[[2, 0, 3, 1]]):
        raise AssertionError("aliased int8 decode: a reordered row differs from its parent row")
    out[f"aliased_paged_decode_quant_{str(dtype).split('.')[1]}"] = check_and_time(
        "paged_decode_quant", dtype,
        lambda: pa.paged_flash_decode_quant(qa, kq, ks, vq, vs, bt, cl, bits=8),
        lambda: pa.paged_decode_attention_quant_torch(qa, kq, ks, vq, vs, bt, cl, bits=8),
        lambda: sdpa(qa, kdq, vdq, mask),
        small + 2 * distinct * hkv * (ps * dq + 4), 4 * tokens * hq * d, bw,
        {**case, "bits": 8}, device_time=True)
    return out


def _causal_keys(tq, tk, off, window=None):
    """Live (query, key) pairs of a causal band: query i at off + i sees keys
    j <= off + i (and j > off + i - window)."""
    q_pos = torch.arange(tq)[:, None] + off
    j = torch.arange(tk)[None, :]
    live = j <= q_pos
    if window is not None:
        live &= j > q_pos - window
    return int(live.sum())


def _scan_tolerance(n_y, dtype, tol=1e-4):
    """y (the first n_y values, in the input dtype) and the f32 final state:
    f32 within rtol/atol ``tol`` (a kernel that sums in another order than
    the plain version: 1e-4 for the SSD scan's 64-step chunks, 1e-5 for the
    RG-LRU's sequential loop); bf16 y within one bf16 ulp of the plain
    output + ``tol``."""
    def tolerance(got, want):
        st_ok = bool(torch.allclose(got[n_y:], want[n_y:], rtol=tol, atol=tol))
        if dtype == torch.float32:
            return st_ok and bool(torch.allclose(got[:n_y], want[:n_y], rtol=tol, atol=tol)), \
                f"allclose rtol=atol={tol} (y and final state)"
        w = want[:n_y]
        _, e = torch.frexp(w)
        ulp = torch.ldexp(torch.ones_like(w), e - 8)
        y_ok = bool(((got[:n_y] - w).abs() <= ulp + tol).all())
        return st_ok and y_ok, f"y <= 1 bf16 ulp + {tol}; final state allclose {tol}"
    return tolerance


def ssd_flops(b, t, h, p, n, q=64):
    """Multiply-adds x 2 of the chunked SSD at the kernel's chunk q, lower
    triangles only, C . B once per (sequence, chunk) (the heads share it)."""
    flops = 0
    for c0 in range(0, t, q):
        m = min(q, t - c0)
        tri = m * (m + 1) // 2
        flops += b * (2 * tri * n + h * (2 * m * p * n + 2 * tri * p + 2 * m * p * n))
    return flops


def dense_cache_checks(bw, g):
    """flash_attention, flash_decode and ssd_scan against their plain versions
    at the generate phase's shapes: qwen2 prefill (8, 14, 256, 64) causal and
    the engine's (1, 14, 512, 64), a windowed prefill; decode (8, 14, 1, 64)
    against (8, 2, 288, 64) caches at several positions, one with a window;
    SSD (2, 512, 48, 64) with N 128 (the plain version at chunk 128), a ragged
    T 389 (plain chunk = T, the model's setting) and an initial state, the
    generate phase's own B 4 at T 512 and 389, and T 65 (one step past the
    kernel's 64-step chunk), with device ms and the dtype's own bound (bf16
    bytes, f32 operations); two runs at B 4 x 512 bit-equal. f32 and bf16.
    Returns the bf16 records at the generate phase's main shapes."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss

    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        esz = torch.tensor([], dtype=dtype).element_size()
        rnd = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)
        # (1, 101): Tq * G = 707 rows, the last 64-row block ragged
        for b, t, window in ((8, 256, None), (1, 512, None), (8, 256, 64), (1, 101, None)):
            q, k, v = rnd(b, 14, t, 64), rnd(b, 2, t, 64), rnd(b, 2, t, 64)
            keys = _causal_keys(t, t, 0, window)
            if window is None:
                library = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                 enable_gqa=True)
            else:
                live = torch.arange(t, device="cuda")
                mask = (live[None, :] <= live[:, None]) & (live[None, :] > live[:, None] - window)
                library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                                 enable_gqa=True)
            rec = check_and_time(
                "flash_attention", dtype,
                lambda: fa.flash_attention(q, k, v, window=window),
                lambda: fa.attention_torch(q, k, v, window=window), library,
                (2 * q.numel() + k.numel() + v.numel()) * esz, 4 * b * 14 * 64 * keys, bw,
                {"B": b, "Hq": 14, "Hkv": 2, "Tq": t, "Tk": t, "D": 64, "causal": True,
                 "window": window}, device_time=True)
            if dtype == torch.bfloat16 and (b, t, window) == (8, 256, None):
                main["flash_attention"] = rec
        S = 288
        q, kc, vc = rnd(8, 14, 1, 64), rnd(8, 2, S, 64), rnd(8, 2, S, 64)
        slots = torch.arange(S, device="cuda")
        decode_split_edges(q, kc, vc, dtype)
        for pos, window in ((0, None), (100, None), (271, None), (287, None), (287, 64)):
            pos_t = torch.tensor([pos], dtype=torch.int32, device="cuda")
            live = slots <= pos
            if window is not None:
                live &= slots > pos - window
            n_live = int(live.sum())
            rec = check_and_time(
                "flash_decode", dtype,
                lambda: fa.flash_decode(q, kc, vc, pos_t, window=window),
                lambda: fa.decode_attention_torch(q, kc, vc, pos, window=window),
                lambda: F.scaled_dot_product_attention(q, kc, vc, attn_mask=live[None, None, None],
                                                       enable_gqa=True),
                2 * q.numel() * esz + 4 + 2 * 8 * 2 * n_live * 64 * esz,
                4 * 8 * 14 * 64 * n_live, bw,
                {"B": 8, "Hq": 14, "Hkv": 2, "S": S, "D": 64, "pos": pos, "window": window},
                device_time=True)
            if dtype == torch.bfloat16 and (pos, window) == (271, None):
                main["flash_decode"] = rec
        for b, t, h, p, n, chunk, initial in ((2, 512, 48, 64, 128, 128, False),
                                               (2, 389, 48, 64, 128, 389, False),
                                               (2, 512, 48, 64, 128, 128, True),
                                               (4, 512, 48, 64, 128, 128, False),
                                               (4, 389, 48, 64, 128, 389, False),
                                               (1, 65, 48, 64, 128, 65, False)):
            x = rnd(b, t, h, p)
            dt = F.softplus(torch.randn(b, t, h, generator=g, device="cuda"))
            A = -torch.exp(0.3 * torch.randn(h, generator=g, device="cuda"))
            Bm, Cm = rnd(b, t, 1, n) * 0.3, rnd(b, t, 1, n) * 0.3
            s0 = torch.randn(b, h, p, n, generator=g, device="cuda") if initial else None
            flat = lambda y, s: torch.cat([y.float().flatten(), s.flatten()])
            state_bytes = b * h * p * n * 4 * (2 if initial else 1)
            rec = check_and_time(
                "ssd_scan", dtype,
                lambda: flat(*ss.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, initial_state=s0,
                                          return_final_state=True)),
                lambda: flat(*ss.ssd_torch(x, dt, A, Bm, Cm, chunk=chunk, initial_state=s0,
                                           return_final_state=True)),
                None,
                (2 * x.numel() + Bm.numel() + Cm.numel()) * esz + dt.numel() * 4 + h * 4
                + state_bytes, ssd_flops(b, t, h, p, n), bw,
                {"b": b, "t": t, "h": h, "p": p, "n": n, "plain_chunk": chunk,
                 "initial_state": initial},
                tolerance=_scan_tolerance(x.numel(), dtype), device_time=True)
            if (b, t, initial) == (4, 512, False):
                run = lambda: ss.ssd_scan(x, dt, A, Bm, Cm, return_final_state=True)
                (y1, s1), (y2, s2) = run(), run()
                same = torch.equal(y1, y2) and torch.equal(s1, s2)
                emit({"phase": "kernels", "kernel": "ssd_scan", "check": "two_runs_bit_equal",
                      "dtype": str(dtype).split(".")[1], "b": b, "t": t, "ok": same})
                if not same:
                    raise AssertionError(f"ssd_scan {dtype}: two runs differ")
            if dtype == torch.bfloat16 and (b, t, initial) == (4, 512, False):
                main["ssd_scan"] = rec
    return main


def decode_split_edges(q, kc, vc, dtype, window=64):
    """flash_decode against its plain version at the positions where the
    split-K plan for these shapes cuts the cache: 0, one before, on and one
    past the first two split edges, and S - 1, with and without a window
    (f32 2e-5, bf16 one ulp + 2e-5); one line for all of them."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa

    b, hq, _, d = q.shape
    _, hkv, s_len, _ = kc.shape
    splits, kps = pa.plan_decode_splits(s_len, b, hkv, 1, d, pa.sm_count(q.device))
    edges = sorted({min(max(p, 0), s_len - 1)
                    for p in (0, kps - 1, kps, kps + 1, 2 * kps - 1, 2 * kps, 2 * kps + 1,
                              s_len - 1)})
    worst, ok = 0.0, True
    for p in edges:
        pos_t = torch.tensor([p], dtype=torch.int32, device=q.device)
        for w in (None, window):
            good, err = _attn_close(fa.flash_decode(q, kc, vc, pos_t, window=w),
                                    fa.decode_attention_torch(q, kc, vc, p, window=w), dtype)
            worst, ok = max(worst, err), ok and good
    emit({"phase": "kernels", "kernel": "flash_decode", "check": "split edges",
          "dtype": str(dtype).split(".")[1], "B": b, "Hq": hq, "Hkv": hkv, "S": s_len, "D": d,
          "splits": splits, "keys_per_split": kps, "positions": edges, "window": window,
          "max_abs_err": worst, "ok": ok})
    if not ok:
        raise AssertionError(f"flash_decode disagrees with its plain version on a split edge "
                             f"of ({b}, {hq}, {hkv}, {s_len}, {d})")


def ring_decode_reference(q, ring_k, ring_v, pos: int, window: int):
    """The reference's windowed decode attention (its models/attention.py, an
    eager masked einsum): ring slot i holds absolute position pos - ((pos %
    S - i) mod S), live when it lies in [max(pos - window + 1, 0), pos]."""
    s = ring_k.shape[2]
    idx = torch.arange(s, device=q.device)
    abs_pos = pos - ((pos % s - idx) % s)
    live = (abs_pos >= max(pos - window + 1, 0)) & (abs_pos <= pos)
    group = q.shape[1] // ring_k.shape[1]
    kf = ring_k.float().repeat_interleave(group, dim=1)
    vf = ring_v.float().repeat_interleave(group, dim=1)
    sc = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) / math.sqrt(q.shape[-1])
    sc = torch.where(live, sc, torch.full_like(sc, -1e30))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(sc, dim=-1), vf).to(q.dtype)


def _attn_close(got, want, dtype):
    """The kernels' attention rule: f32 allclose 2e-5; bf16 within one bf16
    ulp of the other output + 2e-5. -> (ok, max |got - want|)."""
    if dtype == torch.float32:
        ok = bool(torch.allclose(got, want, rtol=2e-5, atol=2e-5))
    else:
        ok = bf16_excess(got, want)[1] <= 0.0
    return ok, float((got.float() - want.float()).abs().max())


def hybrid_checks(bw, g):
    """recurrentgemma-2b's kernels at the generate cell's shapes (B 2, prompts
    of 2600 and 2040, window 2048, MQA 10 / 1 heads of 256): rglru_scan at
    (2, 2600, 2560) and (2, 2040, 2560), from an initial state too, and two
    chained halves against one run; flash_attention at (2, 10, 2600, 256)
    vs (2, 1, 2600, 256), causal, window 2048; flash_decode (2, 10, 1, 256)
    over a full (2, 1, 2048, 256) ring at min(pos, 2047) for positions
    before, at and after the wrap, against its plain version and against the
    reference's ring mask. f32 (rglru 1e-5, attention 2e-5) and bf16 (one
    ulp + the f32 tolerance; the chained halves bit-equal, as the kernel
    runs each column's chain in t order). Returns the rglru_scan record of
    the path's own call (f32 a and b at T 2600: the model computes them in
    f32 at any dtype); the flash kernels' main records stay qwen2's."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rs

    main = {}
    B, W, HQ, D, WINDOW, S = 2, 2560, 10, 256, 2048, 2048
    for dtype in (torch.float32, torch.bfloat16):
        esz = torch.tensor([], dtype=dtype).element_size()
        rnd = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)
        for t, initial in ((2600, False), (2040, False), (2600, True)):
            a = torch.rand(B, t, W, generator=g, device="cuda").mul_(0.5).add_(0.5).to(dtype)
            x = torch.randn(B, t, W, generator=g, device="cuda")
            b = (torch.sqrt(1 - a.float() ** 2) * x).to(dtype)
            h0 = torch.randn(B, W, generator=g, device="cuda") if initial else None
            flat = lambda y, h: torch.cat([y.float().flatten(), h.flatten()])
            rec = check_and_time(
                "rglru_scan", dtype,
                lambda: flat(*rs.rglru_scan(a, b, initial_state=h0, return_final_state=True)),
                lambda: flat(*rs.rglru_torch(a, b, h0, return_final_state=True)),
                None, 3 * a.numel() * esz + B * W * 4 * (2 if initial else 1),
                2 * a.numel(), bw, {"B": B, "T": t, "W": W, "initial_state": initial},
                tolerance=_scan_tolerance(a.numel(), dtype, 1e-5), device_time=True)
            if dtype == torch.float32 and (t, initial) == (2600, False):
                main["rglru_scan"] = rec
            if t == 2600 and not initial:  # two chained halves == one run
                y_full, h_full = rs.rglru_scan(a, b, return_final_state=True)
                y1, h1 = rs.rglru_scan(a[:, :t // 2].contiguous(), b[:, :t // 2].contiguous(),
                                       return_final_state=True)
                y2, h2 = rs.rglru_scan(a[:, t // 2:].contiguous(), b[:, t // 2:].contiguous(),
                                       initial_state=h1, return_final_state=True)
                got, want = flat(torch.cat([y1, y2], 1), h2), flat(y_full, h_full)
                ok, tol = _equal(got, want)  # the chain's order: the bits of one run
                emit({"phase": "kernels", "kernel": "rglru_scan", "check": "chained halves",
                      "dtype": str(dtype).split(".")[1], "B": B, "T": t, "W": W,
                      "max_abs_err": float((got - want).abs().max()), "tolerance": tol,
                      "ok": ok})
                if not ok:
                    raise AssertionError("rglru_scan: two chained halves differ from one run")
        t = 2600
        q, k, v = rnd(B, HQ, t, D), rnd(B, 1, t, D), rnd(B, 1, t, D)
        pos = torch.arange(t, device="cuda")
        band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - WINDOW)
        check_and_time(
            "flash_attention", dtype,
            lambda: fa.flash_attention(q, k, v, window=WINDOW),
            lambda: fa.attention_torch(q, k, v, window=WINDOW),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=band, enable_gqa=True),
            (2 * q.numel() + k.numel() + v.numel()) * esz,
            4 * B * HQ * D * _causal_keys(t, t, 0, WINDOW), bw,
            {"B": B, "Hq": HQ, "Hkv": 1, "Tq": t, "Tk": t, "D": D, "causal": True,
             "window": WINDOW}, device_time=True)
        q1, rk, rv = rnd(B, HQ, 1, D), rnd(B, 1, S, D), rnd(B, 1, S, D)
        slots = torch.arange(S, device="cuda")
        decode_split_edges(q1, rk, rv, dtype)
        for p in (1000, S - 1, S, S + 23, 2 * S + 4):  # before, at and after the wrap
            last = torch.tensor([min(p, S - 1)], dtype=torch.int32, device="cuda")
            live = slots <= min(p, S - 1)
            n_live = int(live.sum())
            check_and_time(
                "flash_decode", dtype,
                lambda: fa.flash_decode(q1, rk, rv, last),
                lambda: fa.decode_attention_torch(q1, rk, rv, last),
                lambda: F.scaled_dot_product_attention(q1, rk, rv,
                                                       attn_mask=live[None, None, None],
                                                       enable_gqa=True),
                2 * q1.numel() * esz + 4 + 2 * B * n_live * D * esz,
                4 * B * HQ * D * n_live, bw,
                {"B": B, "Hq": HQ, "Hkv": 1, "S": S, "D": D, "pos": p,
                 "attended_at": min(p, S - 1), "ring": True}, device_time=True)
            ok, err = _attn_close(fa.flash_decode(q1, rk, rv, last),
                                  ring_decode_reference(q1, rk, rv, p, WINDOW), dtype)
            emit({"phase": "kernels", "kernel": "flash_decode", "check": "reference ring mask",
                  "dtype": str(dtype).split(".")[1], "pos": p, "max_abs_err": err, "ok": ok})
            if not ok:
                raise AssertionError(f"flash_decode on the ring at pos {p} disagrees with the "
                                     "reference's ring mask")
    return main


def quant_matmul_record(g, bw, m, k, n, bits, dtype, case=None):
    """quant_matmul on seeded (M, K) x and (N, K) weights quantized in
    128-blocks against its plain version, with the schedule and K split the
    wrapper launched and device ms beside torch.matmul's on the dequantized
    weight (check_and_time's record)."""
    from repro_torch.core import QuantizedAccessor, dequantize_array, quantize_array
    from repro_torch.kernels import quant_matmul as qmm

    w = torch.randn(n, k, generator=g, device="cuda") / math.sqrt(k)
    acc = QuantizedAccessor(torch.float32, bits=bits, block=128)
    bufs = quantize_array(w, acc)
    qw, sw = bufs["q"], bufs["scale"]
    esz = torch.tensor([], dtype=dtype).element_size()
    x = torch.randn(m, k, generator=g, device="cuda").to(dtype)
    wdt = dequantize_array(bufs, acc).to(dtype).t()
    qmm.quant_matmul(x, qw, sw, bits=bits)
    plan = qmm.quant_matmul.last_plan  # the plan the wrapper launched
    return check_and_time(
        "quant_matmul", dtype,
        lambda: qmm.quant_matmul(x, qw, sw, bits=bits),
        lambda: qmm.quant_matmul_torch(x, qw, sw, bits=bits),
        lambda: torch.matmul(x, wdt),
        (m * k + m * n) * esz + qw.numel() + sw.numel() * 4, 2 * m * n * k, bw,
        {**(case or {}), "M": m, "K": k, "N": n, "bits": bits, "qblock": 128,
         "schedule": plan.schedule, "splits": plan.splits, "k_per_split": plan.k_per_split},
        device_time=True,
    )


def quant_matmul_checks(bw, g):
    """quant_matmul at the MLP's serve shapes: M = 8 decode rows and one
    128-token chunk, (K, N) = (896, 4864) for w_gate/w_up and (4864, 896) for
    w_down, int8 and int4 weights in 128-blocks, each with the schedule and
    K split the wrapper launched and the device time beside torch.matmul's;
    returns the bf16 int8 record of the decode w_gate/w_up shape, and prints
    the bf16 records of w_down at M 8 and of both shapes at M 128 on one
    line."""
    out, shown = None, []
    for m, k, n in ((8, 896, 4864), (8, 4864, 896), (128, 896, 4864), (128, 4864, 896)):
        for bits in (8, 4):
            for dtype in (torch.float32, torch.bfloat16):
                rec = quant_matmul_record(g, bw, m, k, n, bits, dtype)
                if (m, k, bits, dtype) == (8, 896, 8, torch.bfloat16):
                    out = rec
                if dtype == torch.bfloat16 and (m == 128 or k == 4864):
                    shown.append({key: rec[key] for key in (
                        "M", "K", "N", "bits", "schedule", "splits", "k_per_split",
                        "max_abs_err", "ms", "device_ms", "library_ms", "library_device_ms",
                        "plain_ms", "bound_ms", "bound_by")})
    emit({"phase": "kernels", "quant_matmul_records": shown,
          "note": "bf16 x; w_down (M 8, K 4864, N 896) and one 128-token chunk"})
    return out


# =====================================================================================
# phase: paper (the paper-suite kernels behind the mdspan layout dispatch)
# =====================================================================================
PAPER_SIZES = {  # the reference's own (its benchmarks and tests), and HBM-filling ones
    "reference": dict(cube=96, ragged=(95, 97, 99), tiny_n=(100_000, 200_000), mat=2048),
    "hbm": dict(cube=512, ragged=(509, 511, 513), tiny_n=(8_000_000,), mat=16384),
}  # ragged: a sum3d size that is no multiple of a 16-byte vector or of the walk's stride
TINY_JK = (3, 3)  # the paper's tiny matrices
TINY_EXTRA = {  # (N, (J, K), elements the buffers start off 16 bytes)
    "reference": [(100_000, TINY_JK, 1)],  # a view 4 (f32) / 2 (bf16) bytes off
    "hbm": [(1_000_000, (8, 8), 0)],  # the static kernel's largest instantiation
}


def _allclose(rtol, atol):
    def tolerance(got, want):
        ok = bool(torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol))
        return ok, f"allclose rtol={rtol} atol={atol}"
    return tolerance


def _equal(got, want):
    """tinymatsum: the kernels make the plain version's f32 additions and
    roundings, so the bits must agree; rglru_scan's chained halves: the
    kernel's chain in t order gives the bits of one run."""
    return torch.equal(got, want), "torch.equal"


def _offset_view(t, elems):
    """t's values in a buffer that starts ``elems`` elements into a fresh
    allocation."""
    flat = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    flat[elems:] = t.reshape(-1)
    return flat[elems:].view(t.shape)


def _sum_tolerance(x):
    """A sum of ~1e8 terms differs from another order's by rounding that grows
    with the terms' magnitudes: |got - want| <= 1e-5 * sum(|x|). The inputs
    (``_sum_input``) have mean 1, so sum(|x|) is close to the sum itself and
    the bound is relative: a lost block partial (1/1024 of it) fails."""
    bound = 1e-5 * float(x.float().abs().sum())

    def tolerance(got, want):
        return abs(float(got) - float(want)) <= bound, f"|got - want| <= 1e-5 * sum(|x|) = {bound}"
    return tolerance


def _exact_sum(x):
    """sum3d on integers in [-3, 3] (``_sum_integers``) of at most 2^21
    elements: every partial sum is an integer below 2^24, exact in f32 in
    any order, so the kernel must equal the exact total (summed in double)."""
    if x.numel() > 2 ** 21:
        raise ValueError(f"an exact f32 sum needs n <= 2^21, got {x.numel()}")

    def tolerance(got, want):
        return bool(torch.equal(got.float(), want.float())), "exact (torch.equal with the f64 sum)"
    return tolerance


def _row_tolerance(a, v):
    """matvec: each y_i is a sum of J products, whose rounding in another
    order grows with their magnitudes: |got_i - want_i| <= 1e-5 *
    sum_j |A_ij v_j| (the sum3d rule, row by row)."""
    bound = 1e-5 * (a.float().abs() @ v.float().abs())

    def tolerance(got, want):
        ok = bool(((got.float() - want.float()).abs() <= bound).all())
        return ok, "|got_i - want_i| <= 1e-5 * sum_j |A_ij v_j|"
    return tolerance


def _randn(g, *shape, dtype=torch.float32):
    return torch.randn(*shape, generator=g, device=g.device).to(dtype)


def _sum_input(g, *shape, dtype=torch.float32):
    """Normal values of mean 1 and variance 1 (signs mixed), for the sums."""
    return (torch.randn(*shape, generator=g, device=g.device) + 1.0).to(dtype)


def _sum_integers(g, *shape, dtype=torch.float32):
    """Integers in [-3, 3], for the sums that must be exact."""
    return torch.randint(-3, 4, shape, generator=g, device=g.device).to(dtype)


def paper_checks(bw, label, g):
    """Each paper-suite kernel against its plain version at one size set
    (PAPER_SIZES[label]), timed beside it and a library call: sum3d,
    stencil3d and tinymatsum in f32 and bf16, matvec (both layouts) in f32.
    sum3d must also repeat bit for bit, and is checked at a ragged size too,
    aligned and, on integer inputs summed exactly, on a view off 16 bytes.
    tinymatsum also runs at 8 x 8 (HBM sizes) and on a view off 16 bytes
    (the reference's), with device times and each case's static / dynamic
    ratio. Returns the f32 record of each kernel (tinymatsum: the last 3 x 3
    N)."""
    import torch.nn.functional as F
    from repro_torch.kernels import matvec as mv
    from repro_torch.kernels import stencil3d as st
    from repro_torch.kernels import sum3d as sm
    from repro_torch.kernels import tinymatsum as tm

    sizes = PAPER_SIZES[label]
    recs = {}
    n3 = sizes["cube"]
    for dtype in (torch.float32, torch.bfloat16):
        esz = torch.tensor([], dtype=dtype).element_size()
        xr = _sum_input(g, *sizes["ragged"], dtype=dtype)
        check_and_time("sum3d", dtype, lambda: sm.sum3d(xr), lambda: sm.sum3d_torch(xr),
                       lambda: torch.sum(xr, dtype=torch.float32), xr.numel() * esz + 4,
                       xr.numel(), bw, {"sizes": label, "shape": list(sizes["ragged"])},
                       tolerance=_sum_tolerance(xr), phase="paper", device_time=True)
        del xr
        if label == "reference":
            # a view 4 (f32) / 2 (bf16) bytes off 16: the kernel's scalar head and
            # tail. Integers in [-3, 3], n <= 2^21: every partial sum is exact in f32
            # in any order, so the kernel must give the exact total (an element
            # dropped or added twice shows)
            xo = _offset_view(_sum_integers(g, *sizes["ragged"], dtype=dtype), 1)
            check_and_time("sum3d", dtype, lambda: sm.sum3d(xo),
                           lambda: xo.double().sum().float(),
                           lambda: torch.sum(xo, dtype=torch.float32), xo.numel() * esz + 4,
                           xo.numel(), bw, {"sizes": label, "shape": list(sizes["ragged"]),
                                            "data_ptr_mod_16": xo.data_ptr() % 16,
                                            "inputs": "integers in [-3, 3]"},
                           tolerance=_exact_sum(xo), phase="paper", device_time=True)
            del xo
        x = _sum_input(g, n3, n3, n3, dtype=dtype)
        case = {"sizes": label, "shape": [n3] * 3}
        rec = check_and_time("sum3d", dtype, lambda: sm.sum3d(x), lambda: sm.sum3d_torch(x),
                             lambda: torch.sum(x, dtype=torch.float32), x.numel() * esz + 4,
                             x.numel(), bw, case, tolerance=_sum_tolerance(x), phase="paper",
                             device_time=True)
        first, second = sm.sum3d(x), sm.sum3d(x)
        same = torch.equal(first, second)
        emit({"phase": "paper", "check": "sum3d_repeats_bit_for_bit", "sizes": label,
              "dtype": str(dtype).split(".")[1], "values": [float(first), float(second)],
              "equal": same})
        if not same:
            raise AssertionError(f"sum3d gave two results on one input: {first} {second}")
        ones = torch.ones(1, 1, 3, 3, 3, dtype=dtype, device=x.device)
        rec_st = check_and_time(
            "stencil3d", dtype, lambda: st.stencil3d(x), lambda: st.stencil3d_torch(x),
            lambda: F.pad(F.conv3d(x[None, None], ones)[0, 0], (1, 1, 1, 1, 1, 1)),
            2 * x.numel() * esz, 26 * (n3 - 2) ** 3, bw, case,
            tolerance=_allclose(1e-4, 1e-4), phase="paper", device_time=True)
        if dtype == torch.float32:
            recs["sum3d"] = rec
            recs["stencil3d"] = rec_st
        del x
        for n, jk, off in [(n, TINY_JK, 0) for n in sizes["tiny_n"]] + TINY_EXTRA[label]:
            o, s = _randn(g, n, *jk, dtype=dtype), _randn(g, n, *jk, dtype=dtype)
            if off:  # a view off 16 bytes: the kernels' scalar staging form
                o, s = _offset_view(o, off), _offset_view(s, off)
            case = {"sizes": label, "N": n, "J": jk[0], "K": jk[1], "data_ptr_mod_16":
                    o.data_ptr() % 16}
            dev = {}
            for name, fn in (("tinymatsum_static", tm.tinymatsum_static),
                             ("tinymatsum_dynamic", tm.tinymatsum_dynamic)):
                rec = check_and_time(
                    name, dtype, lambda: fn(o, s), lambda: tm.tinymatsum_torch(o, s),
                    lambda: torch.add(o, s), 3 * o.numel() * esz, o.numel(), bw, case,
                    tolerance=_equal, phase="paper", device_time=True)
                dev[name] = rec["device_ms"]
                if dtype == torch.float32 and (n, jk, off) == (sizes["tiny_n"][-1], TINY_JK, 0):
                    recs[name] = rec
            emit({"phase": "paper", "check": "tinymatsum_static_over_dynamic", **case,
                  "dtype": str(dtype).split(".")[1],
                  "device_ms_ratio": dev["tinymatsum_static"] / dev["tinymatsum_dynamic"]})
            del o, s
    m = sizes["mat"]
    a, v = _randn(g, m, m), _randn(g, m)
    at = a.t().contiguous()  # the same A stored column-major
    for name, kernel, library in (
            ("matvec_right", lambda: mv.matvec_right(a, v), lambda: torch.mv(a, v)),
            ("matvec_left", lambda: mv.matvec_left(at, v), lambda: torch.mv(at.t(), v))):
        recs[name] = check_and_time(
            name, torch.float32, kernel, lambda: mv.matvec_torch(a, v), library,
            (m * m + 2 * m) * 4, 2 * m * m, bw, {"sizes": label, "I": m, "J": m},
            tolerance=_row_tolerance(a, v), phase="paper")
    for name, kernel in (("matvec_right", lambda: mv.matvec_right(a, v)),
                         ("matvec_left", lambda: mv.matvec_left(at, v))):
        first, second = kernel(), kernel()
        same = torch.equal(first, second)
        emit({"phase": "paper", "check": f"{name}_repeats_bit_for_bit", "sizes": label,
              "equal": same})
        if not same:
            raise AssertionError(f"{name} gave two results on one input")
    emit({"phase": "paper", "check": "matvec_right_over_left", "sizes": label,
          "ms_ratio": recs["matvec_right"]["ms"] / recs["matvec_left"]["ms"]})
    return recs


def device_ms_per_call(fn, n=100, sleep_cycles=50_000_000):
    """Device time per call of ``fn``: ``n`` calls enqueued behind a sleep
    kernel, so the device runs them back to back however slow the host is."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def zero_overhead_check(g, reps=50):
    """The paper's zero-overhead claim: ops.sum3d / ops.matvec on an MdSpan
    (built by MdSpan.from_dense inside the call) against the same kernel
    called on the raw buffer, LayoutRight and LayoutLeft, at the reference's
    sizes. Host microseconds per call, alternating the two in one loop (a
    synchronize before each timed call), and device ms per call. Both must
    launch the same kernel; the times are printed, not gated."""
    from repro_torch import kernels
    from repro_torch.core import Extents, LayoutLeft, LayoutRight, MdSpan
    from repro_torch.kernels import matvec as mv
    from repro_torch.kernels import ops
    from repro_torch.kernels import sum3d as sm

    n3, m = PAPER_SIZES["reference"]["cube"], PAPER_SIZES["reference"]["mat"]
    E = Extents.fully_dynamic
    x_right = _randn(g, n3, n3, n3)
    x_left = _randn(g, n3, n3, n3).permute(2, 1, 0)  # logical view of column-major storage
    a_right, v = _randn(g, m, m), _randn(g, m)
    a_left = _randn(g, m, m).t()
    def span(t, layout):
        return MdSpan.from_dense(t, layout=layout(E(*t.shape)))

    pairs = {  # (kernel, layout) -> (the call through an MdSpan, the raw kernel call)
        ("sum3d", "right"): (lambda: ops.sum3d(span(x_right, LayoutRight)),
                             lambda: sm.sum3d(x_right)),
        ("sum3d", "left"): (lambda: ops.sum3d(span(x_left, LayoutLeft)),
                            lambda: sm.sum3d(x_left.permute(2, 1, 0))),
        ("matvec", "right"): (lambda: ops.matvec(span(a_right, LayoutRight), v),
                              lambda: mv.matvec_right(a_right, v)),
        ("matvec", "left"): (lambda: ops.matvec(span(a_left, LayoutLeft), v),
                             lambda: mv.matvec_left(a_left.t(), v)),
    }
    out = []
    for (kernel, layout), (via_mdspan, raw) in pairs.items():
        counts = []
        for fn in (via_mdspan, raw):
            kernels.reset_launch_counts()
            fn()
            counts.append(kernels.launch_counts())
        torch.cuda.synchronize()
        host = {"mdspan": [], "raw": []}
        for _ in range(reps):
            for key, fn in (("mdspan", via_mdspan), ("raw", raw)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                host[key].append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
        mds_us, raw_us = statistics.median(host["mdspan"]), statistics.median(host["raw"])
        rec = {"phase": "paper_zero_overhead", "kernel": kernel, "layout": layout,
               "same_kernel": counts[0] == counts[1] and sum(counts[0].values()) == 1,
               "host_us_mdspan": mds_us, "host_us_raw": raw_us, "host_us_diff": mds_us - raw_us,
               "device_ms_mdspan": device_ms_per_call(via_mdspan),
               "device_ms_raw": device_ms_per_call(raw), "reps": reps}
        emit(rec)
        if not rec["same_kernel"]:
            raise AssertionError(f"the MdSpan and raw calls launched different kernels: {counts}")
        out.append(rec)
    return out


def paper_main_path(g, label="hbm"):
    """The paper-suite path as a user drives it, at PAPER_SIZES[label]: the
    ops dispatchers on MdSpans (sum3d and matvec, LayoutRight and LayoutLeft
    over existing storage) and on tensors (stencil3d, tinymatsum static and
    dynamic), launch counts zeroed just before and read just after. Every
    output must agree with its plain version and every kernel must have
    launched. Returns the launch counts."""
    from repro_torch import kernels
    from repro_torch.core import Extents, LayoutLeft, LayoutRight, MdSpan
    from repro_torch.kernels import matvec as mv
    from repro_torch.kernels import ops
    from repro_torch.kernels import stencil3d as st
    from repro_torch.kernels import sum3d as sm
    from repro_torch.kernels import tinymatsum as tm

    sizes = PAPER_SIZES[label]
    E = Extents.fully_dynamic
    n3, n, m = sizes["cube"], sizes["tiny_n"][-1], sizes["mat"]
    x = _sum_input(g, n3, n3, n3)
    x_left = _sum_input(g, n3, n3, n3).permute(2, 1, 0)  # logical view of column-major storage
    o, s = _randn(g, n, *TINY_JK), _randn(g, n, *TINY_JK)
    a, v = _randn(g, m, m), _randn(g, m)
    a_left = _randn(g, m, m).t()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = {
        "sum3d_right": ops.sum3d(MdSpan.from_dense(x, layout=LayoutRight(E(n3, n3, n3)))),
        "sum3d_left": ops.sum3d(MdSpan.from_dense(x_left, layout=LayoutLeft(E(n3, n3, n3)))),
        "stencil3d": ops.stencil3d(x),
        "tinymatsum_static": ops.tinymatsum(o, s, static_extents=True),
        "tinymatsum_dynamic": ops.tinymatsum(o, s, static_extents=False),
        "matvec_right": ops.matvec(MdSpan.from_dense(a, layout=LayoutRight(E(m, m))), v),
        "matvec_left": ops.matvec(MdSpan.from_dense(a_left, layout=LayoutLeft(E(m, m))), v),
    }
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    tiny = tm.tinymatsum_torch(o, s)
    checks = {
        "sum3d_right": _sum_tolerance(x)(out["sum3d_right"], sm.sum3d_torch(x))[0],
        "sum3d_left": _sum_tolerance(x_left)(out["sum3d_left"], sm.sum3d_torch(x_left))[0],
        "stencil3d": _allclose(1e-4, 1e-4)(out["stencil3d"], st.stencil3d_torch(x))[0],
        "tinymatsum_static": _equal(out["tinymatsum_static"], tiny)[0],
        "tinymatsum_dynamic": _equal(out["tinymatsum_dynamic"], tiny)[0],
        "matvec_right": _row_tolerance(a, v)(out["matvec_right"], mv.matvec_torch(a, v))[0],
        "matvec_left": _row_tolerance(a_left, v)(out["matvec_left"],
                                                 mv.matvec_torch(a_left, v))[0],
    }
    finite = {k: bool(torch.isfinite(t).all()) for k, t in out.items()}
    rec = {"phase": "paper_main_path", "sizes": label, "cube": n3, "tiny_n": n, "mat": m,
           "agree_with_plain": checks, "finite": finite,
           "launches": {k: launches[k] for k in PAPER_PATH}, "wall_s": wall}
    emit(rec)
    if not all(checks.values()) or not all(finite.values()):
        raise AssertionError(f"the paper path disagrees with the plain versions: {rec}")
    for k in PAPER_PATH:
        if launches[k] <= 0:
            raise AssertionError(f"the paper path never launched {k}")
    return launches


def paper_phase(bw):
    """The checks at both size sets, the zero-overhead comparison, then the
    main path with its launch counts; returns (records, launches)."""
    g = torch.Generator(device="cuda").manual_seed(13)
    recs = {}
    for label in PAPER_SIZES:
        recs = paper_checks(bw, label, g)  # the HBM size set's records stand
        torch.cuda.empty_cache()
    zero_overhead_check(g)
    launches = paper_main_path(g)
    torch.cuda.empty_cache()
    return recs, launches


# =====================================================================================
# phase: generate (the dense-cache serve path)
# =====================================================================================
GEN_CELLS = {  # arch -> batch, prompt lengths (the first also for the bf16 timing), new tokens
    "qwen2-0.5b": dict(batch=8, prompts=(256,), new=32, need=("flash_attention", "flash_decode")),
    "mamba2-780m": dict(batch=4, prompts=(512, 389), new=32, need=("ssd_scan",)),
    # 2600 > the 2048 window: the prefill's window band and the ring's roll;
    # 2040 + 32: the decode crosses the ring's wrap at position 2048
    "recurrentgemma-2b": dict(batch=2, prompts=(2600, 2040), new=32,
                              need=("flash_attention", "flash_decode", "rglru_scan")),
}


def generate(model, params, prompts, n_new, attn_impl="auto", batch_inputs=None, *, mesh=None,
             rules=None, slots=None, state=None):
    """Greedy serving on the dense cache as a user drives it:
    make_prefill(max_len) then make_serve_step, one token per row per step;
    ``batch_inputs`` (whisper's frames, the vision model's image embeddings)
    goes to the prefill, which encodes it and caches its K/V. ``mesh`` and
    ``rules``: through the mesh (params then ``distribute_params``'s);
    ``slots``: the cache's capacity (default the prompt and n_new);
    ``state``, a list, receives (the step, the caches, the last token, the
    next position) to step on. Returns (tokens (B, n_new) as lists, the
    prefill's and the last step's logits, prefill seconds, per-step
    seconds)."""
    from repro_torch.serving import make_prefill, make_serve_step

    vocab, s = model.cfg.vocab, prompts.shape[1]
    prefill = make_prefill(model, mesh, rules, max_len=slots or s + n_new, attn_impl=attn_impl)
    step = make_serve_step(model, mesh, rules, attn_impl=attn_impl)
    sync = torch.cuda.synchronize if model.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    logits, caches = prefill(params, prompts, batch_inputs=batch_inputs)
    nxt = torch.argmax(logits[:, -1, :vocab], dim=-1).to(torch.int32)
    sync()
    prefill_s = time.perf_counter() - t0
    first, out, steps = logits[:, -1].float(), [nxt], []
    for i in range(n_new - 1):
        t0 = time.perf_counter()
        logits, caches = step(params, caches, nxt, s + i)
        nxt = torch.argmax(logits[:, :vocab], dim=-1).to(torch.int32)
        sync()
        steps.append(time.perf_counter() - t0)
        out.append(nxt)
    if state is not None:
        state[:] = [step, caches, nxt, s + n_new - 1]
    return torch.stack(out, dim=1).tolist(), (first, logits.float()), prefill_s, steps


def generate_model(arch, dtype, n_layers=None, smoke=False, device="cuda", conditioned=False):
    """The model at full width (``n_layers`` deep unless smoke), random weights
    from a seeded generator, rescaled by condition_attention if asked."""
    from repro_torch.models import build_model, get_config

    cfg = dataclasses.replace(get_config(arch, smoke=smoke), dtype=dtype)
    if n_layers and not smoke:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build_model(cfg, device=device)
    params = model.init_params(torch.Generator(device=device).manual_seed(0))
    if conditioned:
        condition_attention(cfg, params)
    return cfg, model, params


def generate_exact(arch, n_layers, gate, conditioned=False, smoke=False, device="cuda"):
    """f32 greedy tokens on the kernels against the same path with the plain
    versions (attn_impl="torch") on the same device, for each prompt length
    of the cell, with the prefill and last-step logits drift. ``gate``: the
    tokens must be equal (left off where the reference's init is chaotic at
    that depth: the drift and the outcome are printed all the same)."""
    from repro_torch import kernels

    cell = GEN_CELLS[arch]
    cfg, model, params = generate_model(arch, "float32", n_layers, smoke, device, conditioned)
    rng = np.random.default_rng(2)
    recs = []
    for s in cell["prompts"]:
        prompts = torch.tensor(rng.integers(0, cfg.vocab, size=(cell["batch"], s)),
                               device=model.device)
        kernels.reset_launch_counts()
        got, (pk, lk), _, _ = generate(model, params, prompts, cell["new"], "auto")
        launches = kernels.launch_counts()
        kernels.reset_launch_counts()
        want, (pp, lp), _, _ = generate(model, params, prompts, cell["new"], "torch")
        plain_launches = sum(kernels.launch_counts()[k] for k in cell["need"])
        diff = [next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), None)
                for g, w in zip(got, want)]
        rec = {"phase": "generate_exact", "model": cfg.name, "dtype": "float32",
               "n_layers": cfg.n_layers, "init": "conditioned" if conditioned else "reference",
               "batch": cell["batch"], "prompt_len": s, "new_tokens": cell["new"],
               "tokens_equal_plain": got == want, "first_differing_step": diff,
               "prefill_logits_max_abs_diff": float((pk - pp).abs().max()),
               "last_step_logits_max_abs_diff": float((lk - lp).abs().max()),
               "gated": gate, "launches": {k: launches[k] for k in cell["need"]},
               "plain_path_launches": plain_launches}
        emit(rec)
        if gate and got != want:
            raise AssertionError(f"generate {cfg.name} at {cfg.n_layers} layers: kernel tokens "
                                 f"differ from the plain path's: {diff}")
        if plain_launches:
            raise AssertionError(f"the plain path launched a kernel: {kernels.launch_counts()}")
        if device == "cuda":
            for k in cell["need"]:
                if launches[k] <= 0:
                    raise AssertionError(f"generate {cfg.name} never launched {k}")
        recs.append(rec)
    return recs


def generate_timed(arch, smoke=False, device="cuda"):
    """The cell in the config dtype (bfloat16) on the kernels: a warm-up run,
    then one run with launch counts zeroed just before and read just after;
    prefill ms, step ms p50, tokens/s, launches per kernel."""
    from repro_torch import kernels

    cell = GEN_CELLS[arch]
    cfg, model, params = generate_model(arch, "bfloat16", None, smoke, device)
    rng = np.random.default_rng(3)
    s = cell["prompts"][0]
    prompts = torch.tensor(rng.integers(0, cfg.vocab, size=(cell["batch"], s)),
                           device=model.device)
    generate(model, params, prompts, 4, "auto")  # warm-up: allocator, cuBLAS handles
    kernels.reset_launch_counts()
    toks, (first, last), prefill_s, steps = generate(model, params, prompts, cell["new"], "auto")
    launches = kernels.launch_counts()
    wall = prefill_s + sum(steps)
    rec = {"phase": "generate", "model": cfg.name, "dtype": cfg.dtype,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model, "batch": cell["batch"],
           "prompt_len": s, "new_tokens": cell["new"], "prefill_ms": prefill_s * 1e3,
           "step_ms_p50": statistics.median(steps) * 1e3, "step_ms_max": max(steps) * 1e3,
           "tokens_per_s": cell["batch"] * cell["new"] / wall, "wall_s": wall,
           "launches": {k: launches[k] for k in cell["need"]},
           "launches_per_step": {k: launches[k] / cell["new"] for k in cell["need"]}}
    emit(rec)
    finite = bool(torch.isfinite(first).all()) and bool(torch.isfinite(last).all())
    if not finite or not all(0 <= tok < cfg.vocab for row in toks for tok in row):
        raise AssertionError(f"generate {cfg.name}: non-finite logits or a token outside the "
                             "vocabulary")
    if device == "cuda":
        for k in cell["need"]:
            if launches[k] <= 0:
                raise AssertionError(f"generate {cfg.name} never launched {k}")
    return rec


# The depth of the runs on the reference's init that are printed, not gated
# (chaotic at depth): half the model's, which keeps the script's time with the
# three train cells; the gated runs keep full depth.
UNGATED_DEPTH = {"qwen2-0.5b": 12, "recurrentgemma-2b": 13, "whisper-large-v3": 16}


def generate_phase(smoke=False, device="cuda"):
    """qwen2-0.5b (24 layers), mamba2-780m (48) and recurrentgemma-2b (26) at
    full width: f32 token equality with the plain path (qwen2 at 2 layers on
    the reference's init, at UNGATED_DEPTH (12) on it (printed, not gated:
    chaotic at depth) and at 24 rescaled; mamba2 at 2 and 48 layers;
    recurrentgemma at 5 (one group and the two-rec remainder), at
    UNGATED_DEPTH (13) on the reference's init after a line of how far two
    plain computations drift there (printed, not gated: chaotic at depth, its
    MQA wk / wv drawn with std 1) and at 26 rescaled),
    then the bf16 timed runs. Returns the launch counts of the bf16 runs (the main path's),
    summed over the cells."""
    generate_exact("qwen2-0.5b", 2, True, smoke=smoke, device=device)
    generate_exact("qwen2-0.5b", UNGATED_DEPTH["qwen2-0.5b"], False, smoke=smoke, device=device)
    generate_exact("qwen2-0.5b", 24, True, conditioned=True, smoke=smoke, device=device)
    generate_exact("mamba2-780m", 2, True, smoke=smoke, device=device)
    generate_exact("mamba2-780m", 48, True, smoke=smoke, device=device)
    rg = "recurrentgemma-2b"
    generate_exact(rg, 5, True, smoke=smoke, device=device)
    if not smoke:
        prompt = np.random.default_rng(4).integers(0, 256000, size=2600).tolist()
        depth_sensitivity(prompt, UNGATED_DEPTH[rg], device=device, arch=rg)
        generate_exact(rg, UNGATED_DEPTH[rg], False, device=device)
        generate_exact(rg, 26, True, conditioned=True, device=device)
    launches = {}
    for arch in GEN_CELLS:
        for k, n in generate_timed(arch, smoke=smoke, device=device)["launches"].items():
            launches[k] = launches.get(k, 0) + n
        if device == "cuda":
            torch.cuda.empty_cache()
    return launches


# =====================================================================================
# phase: generate_cross (whisper-large-v3 and llama-3.2-vision on the dense cache)
# =====================================================================================
CROSS_NEED = ("flash_attention", "flash_decode")
CROSS_CELLS = {  # arch -> batch, prompt length, new tokens, the timed run's depth (None: full)
    "whisper-large-v3": dict(batch=4, prompt=64, new=32, timed_layers=None),
    "llama-3.2-vision-90b": dict(batch=2, prompt=128, new=16, timed_layers=10),
}
VISION_GATE = 1.0  # the reference's init sets the gate to 0: tanh(0) erases the cross layer


def cross_model(arch, dtype, n_layers=None, smoke=False, device="cuda", conditioned=False,
                quantized=False):
    """The model at full width (``n_layers`` deep unless smoke: whisper's
    encoder and decoder both, the vision model's layers), random weights from
    a seeded generator, rescaled by condition_attention if asked, every
    vision group's gate set to VISION_GATE."""
    from repro_torch.models import build_model, get_config

    cfg = dataclasses.replace(get_config(arch, smoke=smoke), dtype=dtype)
    if n_layers and not smoke:
        cfg = dataclasses.replace(cfg, n_layers=n_layers, **(
            {"n_enc_layers": n_layers} if cfg.family == "encdec" else {}))
    model = build_model(cfg, quantized=quantized, device=device)
    params = model.init_params(torch.Generator(device=device).manual_seed(0))
    if conditioned:
        condition_attention(cfg, params)
    for p in params["blocks"][0]:
        if "gate" in p:
            p["gate"].fill_(VISION_GATE)
    return cfg, model, params


def cross_inputs(cfg, cell, device, seed=5):
    """Seeded prompts (batch, prompt) of the cell and the stub frontend's
    input in the param dtype: whisper's frames (B, enc_seq, D) or the vision
    model's image embeddings (B, n_img_tokens, D)."""
    g = torch.Generator(device=device).manual_seed(seed)
    batch = cell["batch"]
    prompts = torch.randint(0, cfg.vocab, (batch, cell["prompt"]), generator=g, device=device)
    n_ctx = cfg.enc_seq if cfg.family == "encdec" else cfg.n_img_tokens
    key = "frames" if cfg.family == "encdec" else "image_embeds"
    ctx = torch.randn(batch, n_ctx, cfg.d_model, generator=g, device=device).to(cfg.param_dtype)
    return prompts, {key: ctx}


def cross_exact(arch, n_layers, gate, conditioned=False, quantized=False, smoke=False,
                device="cuda"):
    """f32 greedy tokens of make_prefill(batch_inputs=) + make_serve_step on
    the kernels against the same path with the plain versions: on the same
    device with attn_impl="torch", or, with ``quantized`` (int8 MLP weights,
    whose quant_matmul the attention switch does not reach), the same model
    and weights on the CPU. ``gate``: the tokens must be equal (off where the
    reference's init is chaotic at that depth: printed all the same).
    Returns the record, its launches counted over the kernel run."""
    from repro_torch import kernels
    from repro_torch.models import build_model

    cell = CROSS_CELLS[arch]
    cfg, model, params = cross_model(arch, "float32", n_layers, smoke, device, conditioned,
                                     quantized)
    prompts, inputs = cross_inputs(cfg, cell, model.device)
    need = CROSS_NEED + (("quant_matmul",) if quantized else ())
    kernels.reset_launch_counts()
    got, (pk, lk), _, _ = generate(model, params, prompts, cell["new"], "auto", inputs)
    launches = kernels.launch_counts()
    kernels.reset_launch_counts()
    if quantized:
        cpu = build_model(cfg, quantized=True, device="cpu")
        want, (pp, lp), _, _ = generate(cpu, _to_cpu(params), prompts.cpu(), cell["new"],
                                        "auto", _to_cpu(inputs))
        pp, lp = pp.to(pk.device), lp.to(lk.device)
        plain = "the CPU (plain versions)"
    else:
        want, (pp, lp), _, _ = generate(model, params, prompts, cell["new"], "torch", inputs)
        plain = 'attn_impl="torch" on the card'
    plain_launches = sum(kernels.launch_counts()[k] for k in CROSS_NEED)
    diff = [next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), None)
            for g, w in zip(got, want)]
    rec = {"phase": "generate_cross_exact", "model": cfg.name, "dtype": "float32",
           "n_layers": cfg.n_layers, "n_enc_layers": cfg.n_enc_layers,
           "init": "conditioned" if conditioned else "reference",
           "mlp_weights": "int8" if quantized else "float32",
           "gate": VISION_GATE if cfg.family == "vlm" else None, "against": plain,
           "batch": cell["batch"], "prompt_len": cell["prompt"], "new_tokens": cell["new"],
           "tokens_equal_plain": got == want, "first_differing_step": diff,
           "prefill_logits_max_abs_diff": float((pk - pp).abs().max()),
           "last_step_logits_max_abs_diff": float((lk - lp).abs().max()),
           "gated": gate, "launches": {k: launches[k] for k in need},
           "plain_path_launches": plain_launches}
    emit(rec)
    if gate and got != want:
        raise AssertionError(f"generate_cross {cfg.name} at {cfg.n_layers} layers: kernel "
                             f"tokens differ from the plain path's: {diff}")
    if plain_launches:
        raise AssertionError(f"the plain path launched a kernel: {kernels.launch_counts()}")
    if device == "cuda":
        for k in need:
            if launches[k] <= 0:
                raise AssertionError(f"generate_cross {cfg.name} never launched {k}")
    del model, params
    return rec


def cross_sensitivity(arch="whisper-large-v3", n_layers=2, smoke=False, device="cuda"):
    """How far two plain computations of the same f32 model drift apart with
    no kernel of this repo in either: the dense-cache path with
    attn_impl="torch" on the card (cuBLAS) and on the CPU, ``n_layers``
    deep on the reference's init, the first cell's inputs. Printed, not
    gated: it says whether a card-vs-CPU check can be token-exact there."""
    from repro_torch.models import build_model

    cell = CROSS_CELLS[arch]
    cfg, model, params = cross_model(arch, "float32", n_layers, smoke, device)
    prompts, inputs = cross_inputs(cfg, cell, model.device)
    got, (pk, _), _, _ = generate(model, params, prompts, cell["new"], "torch", inputs)
    cpu = build_model(cfg, device="cpu")
    want, (pp, _), _, _ = generate(cpu, _to_cpu(params), prompts.cpu(), cell["new"], "torch",
                                   _to_cpu(inputs))
    rec = {"phase": "generate_cross_sensitivity", "model": cfg.name, "n_layers": cfg.n_layers,
           "n_enc_layers": cfg.n_enc_layers, "init": "reference",
           "compared": 'attn_impl="torch" on the card against the CPU',
           "prefill_logits_max_abs_diff": float((pk.cpu() - pp).abs().max()),
           "tokens_equal": got == want,
           "first_differing_step": [next((j for j, (a, b) in enumerate(zip(g, w)) if a != b),
                                         None) for g, w in zip(got, want)]}
    emit(rec)
    del model, params, cpu
    return rec


def _nbytes(tree):
    from repro_torch.core.tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def cross_timed(arch, smoke=False, device="cuda", smi=None):
    """The cell in bf16 on the kernels at CROSS_CELLS' depth: a warm-up run,
    then one run with launch counts zeroed just before and read just after:
    encode ms (Model.encode_ctx alone, once before), prefill ms (the encode
    included), step ms p50, tokens/s, peak memory, launches, and the decode
    step's bytes floor at the data sheet's HBM3 rate: the decoder's weights
    (every layer, the final norm, the LM head) and the caches it reads
    (self caches at their capacity and the cross K/V), derived, not traced."""
    from repro_torch import kernels
    from repro_torch.core.tree import tree_leaves

    cell = CROSS_CELLS[arch]
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    cfg, model, params = cross_model(arch, "bfloat16", cell["timed_layers"], smoke, device)
    prompts, inputs = cross_inputs(cfg, cell, model.device, seed=6)
    generate(model, params, prompts, 4, "auto", inputs)  # warm-up: allocator, cuBLAS handles
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    model.encode_ctx(params, inputs)
    sync()
    encode_s = time.perf_counter() - t0
    kernels.reset_launch_counts()
    toks, (first, last), prefill_s, steps = generate(model, params, prompts, cell["new"], "auto",
                                                     inputs)
    launches = kernels.launch_counts()
    caches = model.init_cache(cell["batch"], cell["prompt"] + cell["new"])
    head = params["embed"]["embedding" if cfg.tie_embeddings else "lm_head"]
    floor_bytes = (_nbytes(params["blocks"]) + _nbytes(params["final_norm"]) + _nbytes(head)
                   + _nbytes(caches))
    del caches
    wall = prefill_s + sum(steps)
    from repro_torch.models import get_config
    rec = {"phase": "generate_cross", "model": cfg.name, "dtype": cfg.dtype,
           "n_layers": cfg.n_layers, "n_enc_layers": cfg.n_enc_layers,
           "cut": (None if cfg.n_layers == get_config(arch, smoke=smoke).n_layers else
                   f"{cfg.n_layers} of {get_config(arch, smoke=smoke).n_layers} layers at full "
                   f"width"),
           "d_model": cfg.d_model, "Hq": cfg.n_heads, "Hkv": cfg.n_kv_heads,
           "head_dim": cfg.head_dim, "context_tokens": cfg.enc_seq or cfg.n_img_tokens,
           "gate": VISION_GATE if cfg.family == "vlm" else None,
           "params": sum(t.numel() for t in tree_leaves(params)), "batch": cell["batch"],
           "prompt_len": cell["prompt"], "new_tokens": cell["new"],
           "encode_ms": encode_s * 1e3, "prefill_ms": prefill_s * 1e3,
           "step_ms_p50": statistics.median(steps) * 1e3, "step_ms_max": max(steps) * 1e3,
           "tokens_per_s": cell["batch"] * cell["new"] / wall, "wall_s": wall,
           "peak_memory_bytes": torch.cuda.max_memory_allocated() if device == "cuda" else None,
           "decode_floor_bytes": floor_bytes,
           "decode_floor_ms": floor_bytes / NOMINAL_BW * 1e3,
           "launches": {k: launches[k] for k in CROSS_NEED},
           "launches_per_step": {k: launches[k] / cell["new"] for k in CROSS_NEED},
           "nvidia_smi": smi}
    emit(rec)
    finite = bool(torch.isfinite(first).all()) and bool(torch.isfinite(last).all())
    if not finite or not all(0 <= tok < cfg.vocab for row in toks for tok in row):
        raise AssertionError(f"generate_cross {cfg.name}: non-finite logits or a token outside "
                             "the vocabulary")
    if device == "cuda":
        for k in CROSS_NEED:
            if launches[k] <= 0:
                raise AssertionError(f"generate_cross {cfg.name} never launched {k}")
    del model, params
    return rec


def generate_cross_phase(smoke=False, device="cuda", smi=None):
    """whisper-large-v3 (full size: 32 + 32 layers) and llama-3.2-vision-90b
    (full width, 10 of 100 layers), every vision run's gate at VISION_GATE:
    f32 token equality with the plain path (whisper at 2 + 2 layers on the
    reference's init, at UNGATED_DEPTH (16 + 16) on it (printed, not gated:
    chaotic at depth) and at 32 + 32 rescaled; after a line of how far the plain path drifts
    between the card and the CPU at 2 + 2 on the reference's init, whisper
    at 2 + 2 rescaled with int8 MLP weights against the CPU, quant_matmul
    launched; vision at 5 layers, one group), then the bf16 timed runs, each
    model freed before the next. Returns (kernel ->
    launches summed over every run on the card, the timed runs' records)."""
    import gc

    runs = [("whisper-large-v3", 2, True, False, False),
            ("whisper-large-v3", UNGATED_DEPTH["whisper-large-v3"], False, False, False),
            ("whisper-large-v3", 32, True, True, False),
            ("whisper-large-v3", 2, True, True, True),
            ("llama-3.2-vision-90b", 5, True, False, False)]
    launches, timed = {}, {}

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    def free():
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

    for arch, layers, gate, conditioned, quantized in runs:
        if quantized:
            cross_sensitivity(arch, layers, smoke, device)
            free()
        add(cross_exact(arch, layers, gate, conditioned, quantized, smoke, device)["launches"])
        free()
    for arch in CROSS_CELLS:
        timed[arch] = cross_timed(arch, smoke, device, smi)
        add(timed[arch]["launches"])
        free()
    return launches, timed


# =====================================================================================
# phases: engine_exact and serve
# =====================================================================================
def oracle_greedy(model, params, prompt, n, vocab):
    """Unbatched recompute: the whole context through Model.forward (plain
    attention: attn_impl="torch", so the oracle never runs a kernel under
    test; no paged cache), argmax of the last row, n times."""
    ctx = list(prompt)
    out = []
    for _ in range(n):
        logits, _ = model.forward(params, torch.tensor([ctx], device=model.device),
                                  attn_impl="torch")
        tok = int(torch.argmax(logits[0, -1, :vocab]))
        out.append(tok)
        ctx.append(tok)
    return out


def exact_requests(vocab, seed=0):
    """Six prompts of 31-591 tokens (lengths one short of a page boundary, so
    decode appends pages early); the first two share a 256-token prefix."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, size=256).tolist()
    prompts = [prefix + rng.integers(0, vocab, size=31).tolist(),
               prefix + rng.integers(0, vocab, size=63).tolist()]
    prompts += [rng.integers(0, vocab, size=n).tolist() for n in (591, 303, 127, 31)]
    return prompts


def _attention_params(tree):
    """Every attention parameter dict ({"wq", "wk", "wv", "wo", ...}) in a
    parameter tree (a dense layer's p["attn"], a group's p["attn"]["attn"],
    a decoder layer's p["self"] and p["cross"], a vision group's
    p["self"][i]["attn"] and p["cross"], whisper's encoder layers)."""
    if isinstance(tree, dict):
        if "wq" in tree:
            yield tree
        else:
            for v in tree.values():
                yield from _attention_params(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _attention_params(v)


def condition_attention(cfg, params):
    """Rescale wq/wk/wv/wo in place to std 1/sqrt(true fan-in). The
    reference's init draws a (d, h, k) projection with std 1/sqrt(shape[-2]),
    i.e. 1/sqrt(heads) (qwen2: wq 1/sqrt(14), wk and wv 1/sqrt(2);
    recurrentgemma: wq 1/sqrt(10), wk and wv 1) and wo (h, k, d) with
    1/sqrt(head_dim), so attention scores are huge and attention is
    near-argmax. That is chaotic at depth: f32 rounding differences between
    two correct computations flip attention choices and, by 24 layers, the
    greedy token. With the fan-in the layer really has (d_model for wq/wk/wv,
    Hq * head_dim for wo) the model stays well-conditioned, so tokens can be
    compared at full depth. The RG-LRU and MLP weights already have their
    true fan-in and stay as drawn. Every attention of the tree is rescaled:
    whisper's encoder and cross layers and the vision groups' too."""
    d, hq, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    for a in _attention_params(params):
        a["wq"].mul_(math.sqrt(hq / d))
        a["wk"].mul_(math.sqrt(hkv / d))
        a["wv"].mul_(math.sqrt(hkv / d))
        a["wo"].mul_(math.sqrt(1.0 / hq))
    return params


def depth_sensitivity(prompt, layers, conditioned=False, device="cuda", arch="qwen2-0.5b"):
    """Max |logit difference| between two plain computations of the same
    next-token logits for random f32 weights at full width and ``layers``
    depth, with the reference's init or (with ``conditioned``) after
    condition_attention: Model.forward over the prompt, and (dense)
    Model.prefill over it right-padded to a page, or (hybrid, whose final
    state padding would pollute) Model.prefill over all but the last token
    then one decode_step — other matmul shapes either way. This bounds how
    deep a token-exact check can go."""
    from repro_torch.models import build_model, get_config

    cfg = dataclasses.replace(get_config(arch), dtype="float32", n_layers=layers)
    model = build_model(cfg, device=device)
    params = model.init_params(torch.Generator(device=device).manual_seed(0))
    if conditioned:
        condition_attention(cfg, params)
    toks = torch.tensor([prompt], device=device)
    fwd, _ = model.forward(params, toks, attn_impl="torch")
    fwd = fwd[0, -1, :cfg.vocab]
    if cfg.family == "hybrid":
        n = len(prompt)
        _, caches = model.prefill(params, toks[:, :-1], max_len=n, attn_impl="torch")
        other, _ = model.decode_step(params, caches, toks[:, -1], n - 1, attn_impl="torch")
        other = other[0, :cfg.vocab]
    else:
        padded = torch.zeros((1, -(-len(prompt) // 16) * 16), dtype=toks.dtype, device=device)
        padded[0, :len(prompt)] = toks[0]
        other, _ = model.prefill(params, padded, last_index=len(prompt) - 1, attn_impl="torch")
        other = other[0, 0, :cfg.vocab]
    rec = {"phase": "generate_sensitivity" if cfg.family == "hybrid"
           else "engine_exact_sensitivity", "model": cfg.name, "n_layers": layers,
           "init": "conditioned" if conditioned else "reference", "prompt_len": len(prompt),
           "max_abs_logit_diff": float((fwd - other).abs().max()),
           "argmax_equal": int(fwd.argmax()) == int(other.argmax())}
    emit(rec)
    return rec


def run_engine(model, params, prompts, n_new, config, device):
    """One engine run of greedy requests over ``prompts`` (run_jobs): (tokens
    per request, metrics, launches, wall seconds)."""
    seqs, m, launches, wall, _ = run_jobs(
        model, params, config, device,
        [(p, dict(max_new_tokens=n_new), i) for i, p in enumerate(prompts)])
    return [seqs[i][0][0] for i in range(len(prompts))], m, launches, wall


EXACT_MODES = (("monolithic", {}), ("chunked", dict(chunked_prefill=True, chunk_tokens=128)))


def exact_config(pool_pages, kv_dtype="f32", **extra):
    from repro_torch.serving.engine import EngineConfig

    return EngineConfig(num_pages=pool_pages, page_size=16, max_batch=8, max_pages_per_seq=40,
                        kv_dtype=kv_dtype, **extra)


def exact_model(cfg_name, smoke, device, n_layers, conditioned, quantized=False):
    """The f32 model at full width (``n_layers`` deep unless smoke) with
    seeded random weights, rescaled by condition_attention if asked."""
    from repro_torch.models import build_model, get_config

    cfg = dataclasses.replace(get_config(cfg_name, smoke=smoke), dtype="float32")
    if not smoke:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build_model(cfg, quantized=quantized, device=device)
    params = model.init_params(torch.Generator(device=device).manual_seed(0))
    if conditioned:
        condition_attention(cfg, params)
    return cfg, model, params


def check_exact(rec, got, want, m, launches, need, device):
    emit(rec)
    if got != want:
        bad = [i for i in range(len(want)) if got[i] != want[i]]
        raise AssertionError(f"{rec['phase']} {rec['mode']}: tokens differ for requests {bad}")
    if m["preemptions"] < 1:
        raise AssertionError(f"{rec['phase']} {rec['mode']} never preempted: the pool is too large")
    if device == "cuda":
        for k in need:
            if launches[k] <= 0:
                raise AssertionError(f"{rec['phase']} {rec['mode']} never launched {k}")


def engine_exact_phase(cfg_name="qwen2-0.5b", smoke=False, device="cuda", pool_pages=58,
                       n_new=16, n_layers=2, conditioned=False):
    """Greedy tokens of the serving engine vs the unbatched oracle, at full
    width and ``n_layers`` depth. With the reference's init the check holds
    only at shallow depth (at 24 layers two plain computations already
    disagree, see depth_sensitivity); ``conditioned`` applies
    condition_attention so all 24 layers can be checked."""
    cfg, model, params = exact_model(cfg_name, smoke, device, n_layers, conditioned)
    prompts = exact_requests(cfg.vocab)
    t0 = time.perf_counter()
    want = [oracle_greedy(model, params, p, n_new, cfg.vocab) for p in prompts]
    oracle_s = time.perf_counter() - t0
    runs = {}
    for mode, extra in EXACT_MODES:
        got, m, launches, wall = run_engine(model, params, prompts, n_new,
                                            exact_config(pool_pages, **extra), device)
        rec = {
            "phase": "engine_exact", "mode": mode, "model": cfg.name, "dtype": "float32",
            "n_layers": cfg.n_layers, "init": "conditioned" if conditioned else "reference",
            "d_model": cfg.d_model, "requests": len(prompts),
            "prompt_lens": [len(p) for p in prompts], "new_tokens": n_new,
            "tokens_equal_oracle": got == want, "preemptions": m["preemptions"],
            "pages_shared": m["pages_shared"], "cow_copies": m["cow_copies"],
            "prefill_tokens_skipped": m["prefill_tokens_skipped"],
            "launches": {k: launches[k] for k in DENSE_PATH + ("flash_attention",)},
            "wall_s": wall, "oracle_s": oracle_s,
        }
        need = DENSE_PATH if mode == "chunked" else ("paged_decode", "flash_attention")
        check_exact(rec, got, want, m, launches, need, device)
        runs[mode] = rec
    return runs


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


def engine_exact_quant_phase(kv_dtype, cfg_name="qwen2-0.5b", smoke=False, device="cuda",
                             pool_pages=58, n_new=16, n_layers=2, conditioned=False):
    """Greedy tokens of the engine with int8 MLP weights over ``kv_dtype``
    pages on ``device`` (kernels) vs the same engine with the same weights on
    the CPU (plain versions), in both prefill modes. The oracle is the CPU
    engine and not Model.forward: quantized pages make the paged path's
    logits differ from a dense recompute by design."""
    from repro_torch.models import build_model

    cfg, model, params = exact_model(cfg_name, smoke, device, n_layers, conditioned,
                                     quantized=True)
    cpu_model = build_model(cfg, quantized=True, device="cpu")
    cpu_params = _to_cpu(params)
    prompts = exact_requests(cfg.vocab)
    runs = {}
    for mode, extra in EXACT_MODES:
        config = exact_config(pool_pages, kv_dtype, **extra)
        got, m, launches, wall = run_engine(model, params, prompts, n_new, config, device)
        t0 = time.perf_counter()
        want, m_cpu, _, _ = run_engine(cpu_model, cpu_params, prompts, n_new, config, "cpu")
        cpu_s = time.perf_counter() - t0
        first_diff = [next((j for j, (a, b) in enumerate(zip(g_i, w_i)) if a != b), None)
                      for g_i, w_i in zip(got, want)]
        rec = {
            "phase": "engine_exact_quant", "mode": mode, "model": cfg.name, "dtype": "float32",
            "weights": "int8", "kv_dtype": kv_dtype, "n_layers": cfg.n_layers,
            "init": "conditioned" if conditioned else "reference", "requests": len(prompts),
            "new_tokens": n_new, "tokens_equal_cpu_engine": got == want,
            "first_differing_token": first_diff, "preemptions": m["preemptions"],
            "preemptions_cpu": m_cpu["preemptions"], "pages_shared": m["pages_shared"],
            "cow_copies": m["cow_copies"], "kv_pool_bytes": m["kv_pool_bytes"],
            "launches": {k: launches[k] for k in QUANT_PATH + ("flash_attention",)},
            "wall_s": wall, "cpu_s": cpu_s,
        }
        need = (QUANT_PATH if mode == "chunked"
                else ("paged_decode_quant", "quant_matmul", "flash_attention"))
        check_exact(rec, got, want, m, launches, need, device)
        runs[mode] = rec
    return runs


def serve_requests(vocab, n=16, seed=1):
    """16 prompts of 64-512 tokens; four open with one 128-token system prefix."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, size=128).tolist()
    out = []
    for i in range(n):
        body = rng.integers(0, vocab, size=int(rng.integers(64, 385))).tolist()
        out.append(prefix + body if i % 4 == 0 else body)
    return out


def serve_setup(cfg_name="qwen2-0.5b", smoke=False, device="cuda", n_new=32, quantized=False,
                kv_dtype="f32", n_requests=16, n_layers=None):
    """The serve workload: the model at its config dtype (bfloat16) with
    seeded random weights (int8 MLP weights if ``quantized``), ``n_layers``
    deep if given, the ``n_requests`` prompts and the engine config
    (``kv_dtype`` pages), after a warm-up run on an engine of its own
    (allocator, cuBLAS handles)."""
    from repro_torch.models import build_model, get_config
    from repro_torch.serving import GenerationParams
    from repro_torch.serving.engine import EngineConfig, Request, ServeEngine

    cfg = get_config(cfg_name, smoke=smoke)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build_model(cfg, quantized=quantized, device=device)
    params = model.init_params(torch.Generator(device=device).manual_seed(1))
    prompts = serve_requests(cfg.vocab, n=n_requests)
    config = EngineConfig.sized_for(max(len(p) for p in prompts) + n_new, page_size=16,
                                    max_batch=8, chunked_prefill=True, chunk_tokens=128,
                                    kv_dtype=kv_dtype)
    w = SimpleNamespace(cfg=cfg, prompts=prompts, config=config, n_new=n_new, device=device,
                        weights="int8" if quantized else cfg.dtype, model=model, params=params)
    w.requests = lambda ps=prompts: [Request(i, p, GenerationParams(max_new_tokens=n_new))
                                     for i, p in enumerate(ps)]
    w.engine = lambda base=config, **kw: ServeEngine(model, params,
                                                     dataclasses.replace(base, **kw),
                                                     device=device)
    w.engine().run(w.requests(prompts[:2]))
    return w


def serve_phase(cfg_name="qwen2-0.5b", smoke=False, device="cuda", n_new=32, workload=None,
                phase="serve", need=DENSE_PATH, engine_kw=None, config=None):
    """One serving run of the workload on a fresh engine (``config`` in place
    of the workload's EngineConfig, ``engine_kw``: fields over it), launch
    counts zeroed just before and read just after; every kernel in ``need``
    must launch. The record carries the chunk widths the attention kernels
    launched at, and the autotuner's decision where it made one."""
    from repro_torch import kernels

    w = workload or serve_setup(cfg_name, smoke, device, n_new)
    cfg, prompts, n_new = w.cfg, w.prompts, w.n_new
    eng = w.engine(config or w.config, **(engine_kw or {}))
    config = eng.config
    reqs = w.requests()
    kernels.reset_launch_counts()
    with chunk_widths() as widths:
        eng.run(reqs)
    launches = kernels.launch_counts()
    m = eng.metrics()
    rec = {
        "phase": phase, "model": cfg.name, "dtype": cfg.dtype, "weights": w.weights,
        "kv_dtype": config.kv_dtype, "requests": len(prompts),
        "prompt_tokens": sum(len(p) for p in prompts), "new_tokens": n_new,
        "max_batch": config.max_batch, "chunk_tokens": config.chunk_tokens,
        **{k: m[k] for k in ("tokens_per_s", "step_ms_p50", "step_ms_p95", "chunk_ms_p50",
                             "host_overhead_ms_p50", "ttft_s_p50", "ttft_s_p95",
                             "decode_steps", "wall_s", "kv_pool_bytes",
                             "peak_pages_in_use", "pages_shared", "prefill_tokens_skipped",
                             "preemptions")},
        **{k: m[k] for k in SPEC_KEYS if k in m},
        **{k: v for k, v in m.items() if k.startswith("tuned_")},
        "launches": {k: launches[k] for k in need},
        "chunk_widths": dict(sorted(widths.items())),
    }
    if engine_kw:
        rec["engine"] = engine_kw
    emit(rec)
    rec["tokens"] = [eng.results[i].generated for i in range(len(prompts))]  # not printed
    if m["generated_tokens"] != len(prompts) * n_new or m["failed"]:
        raise AssertionError(f"{phase} phase did not complete every request: {m}")
    for seq in eng.results.values():
        if not all(0 <= t < cfg.vocab for t in seq.generated):
            raise AssertionError("a generated token lies outside the vocabulary")
    if w.device == "cuda":
        for k in need:
            if launches[k] <= 0:
                raise AssertionError(f"the {phase} path never launched {k}")
    return rec


def serve_quant_phase(dense_pool_bytes, cfg_name="qwen2-0.5b", smoke=False, device="cuda",
                      n_new=32):
    """The serve workload with int8 MLP weights over int8, then int4, KV
    pages, one run each; the int8 pool must be >= 1.9x smaller than the
    dense (bf16) pool of the same page count."""
    runs = {}
    for kv in ("int8", "int4"):
        w = serve_setup(cfg_name, smoke, device, n_new, quantized=True, kv_dtype=kv)
        rec = serve_phase(workload=w, phase="serve_quant", need=QUANT_PATH)
        rec["kv_pool_bytes_vs_dense"] = dense_pool_bytes / rec["kv_pool_bytes"]
        emit({"phase": "serve_quant_pool", "kv_dtype": kv, "kv_pool_bytes": rec["kv_pool_bytes"],
              "dense_kv_pool_bytes": dense_pool_bytes,
              "smaller_by": rec["kv_pool_bytes_vs_dense"]})
        runs[kv] = rec
    if runs["int8"]["kv_pool_bytes_vs_dense"] < 1.9:
        raise AssertionError(f"int8 pool only {runs['int8']['kv_pool_bytes_vs_dense']:.3f}x "
                             "smaller than the dense pool")
    return runs


class chunk_widths:
    """Within the block, count the C of every chunk-attention launch on the
    card, keyed "C" (dense pages) or "C q" (intN pages): ops' bindings of
    the chunk wrappers are wrapped for the block and restored after it."""

    def __enter__(self):
        from repro_torch.kernels import ops

        self.counts, self.saved = {}, {}
        for name, tag in (("paged_flash_prefill_chunk", ""),
                          ("paged_flash_prefill_chunk_quant", " q")):
            fn = getattr(ops, name)
            self.saved[name] = fn

            def counted(q, *a, _fn=fn, _tag=tag, **kw):
                if q.is_cuda:
                    key = f"{q.shape[2]}{_tag}"
                    self.counts[key] = self.counts.get(key, 0) + 1
                return _fn(q, *a, **kw)

            setattr(ops, name, counted)
        return self.counts

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        for name, fn in self.saved.items():
            setattr(ops, name, fn)
        return False


def engine_exact_spec_phase(cfg_name="qwen2-0.5b", smoke=False, device="cuda", n_layers=2,
                            n_new=16, pool_pages=160):
    """Greedy tokens of the speculative engine (spec_tokens SPEC_K, multi_step
    SPEC_S, backoff off so every plannable dispatch speculates) on ``device``
    against the plain engine (spec_tokens 0, multi_step 1) on the CPU, at full
    width and ``n_layers`` in f32 on the reference's init, over f32 and int8
    pages, monolithic prefill (so every chunk launch is a verify window);
    then the multi_step=4 engine against the multi_step=1 engine, both on
    ``device``. Launch counts are zeroed just before and read just after each
    run: the decode and chunk kernels of the pages' kind must have launched,
    the chunk kernel at C = SPEC_K + 1."""
    from repro_torch.models import build_model

    cfg, model, params = exact_model(cfg_name, smoke, device, n_layers, False)
    cpu_model = build_model(cfg, device="cpu")
    cpu_params = _to_cpu(params)
    prompts = exact_requests(cfg.vocab)
    runs = {}
    for kv in ("f32", "int8"):
        config = exact_config(pool_pages, kv)
        need = DENSE_PATH if kv == "f32" else QUANT_KV_PATH
        t0 = time.perf_counter()
        want, _, _, _ = run_engine(cpu_model, cpu_params, prompts, n_new, config, "cpu")
        cpu_s = time.perf_counter() - t0
        spec_conf = dataclasses.replace(config, spec_tokens=SPEC_K, multi_step=SPEC_S,
                                        spec_backoff=0)
        with chunk_widths() as widths:
            got, m, launches, wall = run_engine(model, params, prompts, n_new, spec_conf, device)
        plain_card, _, _, _ = run_engine(model, params, prompts, n_new, config, device)
        fused, m_fused, fused_launches, fused_wall = run_engine(
            model, params, prompts, n_new, dataclasses.replace(config, multi_step=4), device)
        rec = {
            "phase": "engine_exact_spec", "model": cfg.name, "dtype": "float32",
            "n_layers": cfg.n_layers, "init": "reference", "kv_dtype": kv,
            "requests": len(prompts), "prompt_lens": [len(p) for p in prompts],
            "new_tokens": n_new, "spec_tokens": SPEC_K, "multi_step": SPEC_S,
            "spec_tokens_equal_cpu_plain": got == want,
            "multi_step_4_tokens_equal_multi_step_1": fused == plain_card,
            "card_plain_tokens_equal_cpu_plain": plain_card == want,
            **{k: m[k] for k in SPEC_KEYS}, "fused_steps_multi_step_4": m_fused["fused_steps"],
            "launches": {k: launches[k] for k in need}, "chunk_widths": dict(widths),
            "launches_multi_step_4": {k: fused_launches[k] for k in need},
            "wall_s": wall, "wall_s_multi_step_4": fused_wall, "cpu_s": cpu_s,
        }
        emit(rec)
        if got != want:
            bad = [i for i in range(len(want)) if got[i] != want[i]]
            raise AssertionError(f"engine_exact_spec {kv}: speculative tokens differ from the "
                                 f"CPU plain engine's for requests {bad}")
        if fused != plain_card:
            raise AssertionError(f"engine_exact_spec {kv}: multi_step=4 tokens differ from "
                                 "multi_step=1")
        if m["spec_windows"] <= 0 or m_fused["fused_steps"] <= 0:
            raise AssertionError(f"engine_exact_spec {kv}: no window ran: {rec}")
        if device == "cuda":
            verify_key = f"{SPEC_K + 1}" + ("" if kv == "f32" else " q")
            if any(launches[k] <= 0 for k in need) or widths.get(verify_key, 0) <= 0:
                raise AssertionError(f"engine_exact_spec {kv}: the verify path did not launch "
                                     f"{need} at C = {SPEC_K + 1}: {rec}")
            if any(fused_launches[k] <= 0 for k in need[:1]):
                raise AssertionError(f"engine_exact_spec {kv}: multi_step=4 never launched "
                                     f"{need[0]}")
        runs[kv] = rec
    return runs


def predictable_stream_check(w, n_new=32):
    """The reference's predictable stream (tests/test_speculative.py, the
    predictable-stream test) at the workload's full width: every parameter
    zeroed but the embedding, so the logits are uniformly zero and greedy
    pins token 0. The speculative engine's tokens must equal the plain
    engine's, with accepted_tokens_per_step > 1.5."""
    from repro_torch.serving import GenerationParams
    from repro_torch.serving.engine import EngineConfig, Request, ServeEngine

    def zeroed(tree, top=True):
        if isinstance(tree, dict):
            return {k: v if top and k == "embed" else zeroed(v, False) for k, v in tree.items()}
        if isinstance(tree, list):
            return [zeroed(v, False) for v in tree]
        return torch.zeros_like(tree)

    zp = zeroed(w.params)
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    econf = EngineConfig(num_pages=64, page_size=8, max_batch=1, max_pages_per_seq=8)
    mk = lambda: [Request(0, prompt, GenerationParams(max_new_tokens=n_new))]
    plain = ServeEngine(w.model, zp, econf, device=w.device).run(mk())[0].generated
    eng = ServeEngine(w.model, zp, dataclasses.replace(econf, spec_tokens=3, multi_step=2),
                      device=w.device)
    got = eng.run(mk())[0].generated
    m = eng.metrics()
    rec = {"phase": "serve_spec_predictable", "model": w.cfg.name, "dtype": w.cfg.dtype,
           "n_layers": w.cfg.n_layers, "spec_tokens": 3, "multi_step": 2, "new_tokens": n_new,
           "tokens_equal_plain": got == plain, **{k: m[k] for k in SPEC_KEYS}}
    emit(rec)
    if got != plain or m["accepted_tokens_per_step"] <= 1.5:
        raise AssertionError(f"predictable stream: {rec}")
    return rec


def serve_spec_phase(workload, quant_workload=None, plain_tokens=None):
    """The serve workload with speculation (spec_tokens SPEC_K, multi_step
    SPEC_S) beside the same run with multi_step=4 alone, in the order fused,
    spec, spec, fused on fresh engines (host-bound metrics spread from run to
    run); acceptance on random weights is printed, not gated, and so is how
    many requests' greedy tokens equal ``plain_tokens`` (a plain serve run's:
    in bf16 the verify's chunk kernel and the one-token decode round
    differently, so a near tie may flip). Then one
    speculative run over int8 pages (``quant_workload``, rows 3-4 of the
    verify path) and the predictable stream at full width. Every run must
    complete every request and launch its path's kernels, the chunk kernel
    at C = SPEC_K + 1 in the speculative runs."""
    spec_kw = dict(spec_tokens=SPEC_K, multi_step=SPEC_S)
    order = (("multi_step_4", dict(multi_step=4)), ("spec", spec_kw), ("spec", spec_kw),
             ("multi_step_4", dict(multi_step=4)))
    runs = {}
    for label, kw in order:
        rec = serve_phase(workload=workload, phase="serve_spec", engine_kw=kw)
        runs.setdefault(label, []).append(rec)
    quant = None
    if quant_workload is not None:
        quant = serve_phase(workload=quant_workload, phase="serve_spec", need=QUANT_KV_PATH,
                            engine_kw=spec_kw)
    for rec in runs["spec"] + ([quant] if quant else []):
        key = f"{SPEC_K + 1}" + ("" if rec["kv_dtype"] == "f32" else " q")
        if workload.device == "cuda" and rec["chunk_widths"].get(key, 0) <= 0:
            raise AssertionError(f"serve_spec never verified at C = {SPEC_K + 1}: {rec}")
        if rec["spec_windows"] <= 0:
            raise AssertionError(f"serve_spec ran no speculative window: {rec}")
    summary = {"phase": "serve_spec_summary", "order": [label for label, _ in order]}
    for label, recs in runs.items():
        for k in ("tokens_per_s", "step_ms_p50", "step_ms_p95", "ttft_s_p95", "decode_steps",
                  "fused_steps") + (SPEC_KEYS[1:] if label == "spec" else ()):
            summary[f"{label}_{k}"] = [r[k] for r in recs]
        if plain_tokens is not None:
            summary[f"{label}_requests_equal_plain"] = [
                sum(a == b for a, b in zip(r["tokens"], plain_tokens)) for r in recs]
            summary[f"{label}_first_differing_token"] = [
                [next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
                 for a, b in zip(r["tokens"], plain_tokens)] for r in recs]
    emit(summary)
    predictable = predictable_stream_check(workload)
    return runs, quant, predictable


# =====================================================================================
# phases: engine_exact_branch, serve_branch
# =====================================================================================
BRANCH_SAMPLE = dict(temperature=0.8, top_k=8)
BRANCH_LENS = (37, 48)  # a shared last page partly filled (37 of 16-token pages), and aligned
KV_ROWS = ("paged_decode", "paged_prefill_chunk", "paged_decode_quant",
           "paged_prefill_chunk_quant")  # rows 1-4 of PERF.md's table


def json_grammar(vocab, n_items=3):
    """The reference's fixed JSON-array grammar over tokens 0-12 for the
    characters "[],0123456789" and eos 13: (dfa, eos, decode)."""
    from repro_torch.serving.grammar import JSON_ARRAY_CHARS, fixed_json_array_dfa

    charmap = {ch: i for i, ch in enumerate(JSON_ARRAY_CHARS)}
    eos = len(JSON_ARRAY_CHARS)
    dfa = fixed_json_array_dfa(charmap, eos, vocab, n_items=n_items)
    return dfa, eos, lambda toks: "".join(JSON_ARRAY_CHARS[t] for t in toks if t != eos)


def run_jobs(model, params, config, device, jobs, prepare=None, engine_kw=None):
    """One engine run of ``jobs`` [(prompt, GenerationParams kwargs, rid)]
    with launch counts zeroed just before and read just after: (rid ->
    [(tokens, cumulative_logprob, finish_reason)] a sequence, metrics,
    launches, wall seconds, engine). ``prepare(engine)`` runs before;
    ``engine_kw`` (a mesh and its rules) goes to ServeEngine."""
    from repro_torch import kernels
    from repro_torch.serving import GenerationParams
    from repro_torch.serving.engine import ServeEngine

    eng = ServeEngine(model, params, config, device=device, **(engine_kw or {}))
    if prepare is not None:
        prepare(eng)
    handles = {rid: eng.submit(p, GenerationParams(**g), rid=rid) for p, g, rid in jobs}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    eng.run()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    seqs = {rid: [(s.tokens, s.cumulative_logprob, s.finish_reason) for s in h.sequences]
            for rid, h in handles.items()}
    return seqs, eng.metrics(), launches, wall, eng


def _tokens_of(seqs):
    return {rid: [t for t, _, _ in v] for rid, v in seqs.items()}


def _score_gap(a, b):
    return max((abs(x[1] - y[1]) for rid in a for x, y in zip(a[rid], b[rid])), default=0.0)


def watch_tier(cache):
    """Wrap the cache's tier: each page a demotion copies is snapshotted
    (every pool leaf: intN bytes and scales) under its chain key, and each
    page a promotion lands is compared with that snapshot, byte for byte.
    Returns the list of promoted pages checked (grows during the run)."""
    from repro_torch.serving.engine.kvquant import pool_leaves

    tier, seen, checked = cache.tier, {}, []
    demote, promote = tier.demote, tier.promote

    def watched_demote(keys, dev_pages, retain_s=0.0):
        before = set(tier._index)
        n = demote(keys, dev_pages, retain_s=retain_s)
        for key, page in zip(keys, dev_pages):
            if key in tier._index and key not in before:
                seen[key] = [leaf[:, page].to("cpu", copy=True) for leaf in pool_leaves(cache.pools)]
        return n

    def watched_promote(keys, dst_pages):
        n = promote(keys, dst_pages)
        for key, page in zip(keys, dst_pages):
            got = [leaf[:, page].cpu() for leaf in pool_leaves(cache.pools)]
            if not all(torch.equal(a, b) for a, b in zip(got, seen[key])):
                raise AssertionError(f"promoted page {page} differs from the bytes demoted")
            checked.append(page)
        return n

    tier.demote, tier.promote = watched_demote, watched_promote
    return checked


def engine_exact_branch_phase(cfg_name="qwen2-0.5b", smoke=False, device="cuda", n_layers=2,
                              n_new=12):
    """Best-of-n, beam search, a JSON grammar and the host KV tier through
    the serving engine on ``device`` at full width, ``n_layers`` deep, f32,
    the reference's init, page 16, monolithic and chunked prefill. Gates:
    best-of-n (n 4, prompts of 37 and 48 tokens) equals the same engine on
    the CPU, and branch b a serial n=1 request at seed + b with the same
    rid; beam (width 4, n 2) equals the CPU engine's tokens, its scores
    within 1e-4 and its fork / reorder / CoW counters, with a reorder; every
    grammar output parses, multi_step 4 equals 1, and the card equals the
    CPU; the host tier (a pool that preempts, 32 host pages, f32 and int4
    pages) equals a tier-less large-pool engine (f32; over int4 pages, where
    a recompute re-quantizes decode-appended pages and so differs by design,
    the same tiered engine on the CPU, counters too), swaps out, prefetches
    (swap_in_pages == prefetch_hits > 0), lands every promoted page byte for
    byte as demoted, and a retained session's follow-up hits the tier. Rows
    1-4 must launch; counts are zeroed just before each run."""
    from repro_torch.models import build_model

    cfg, model, params = exact_model(cfg_name, smoke, device, n_layers, False)
    cpu_model = model if device == "cpu" else build_model(cfg, device="cpu")
    cpu_params = params if device == "cpu" else _to_cpu(params)
    rng = np.random.default_rng(25)
    prompts = [rng.integers(0, cfg.vocab, size=n).tolist() for n in BRANCH_LENS]
    dfa, eos, decode = json_grammar(cfg.vocab)
    seen_rows = {k: 0 for k in KV_ROWS}
    recs = []

    def need(rec, launches, rows):
        for k in KV_ROWS:
            seen_rows[k] += launches[k]
        rec["launches"] = {k: launches[k] for k in KV_ROWS}
        if device == "cuda" and any(launches[k] <= 0 for k in rows):
            raise AssertionError(f"engine_exact_branch {rec['part']} {rec['mode']} never "
                                 f"launched {rows}: {rec}")

    for mode, extra in EXACT_MODES:
        rows = DENSE_PATH if mode == "chunked" else DENSE_PATH[:1]
        config = exact_config(160, max_beam_width=4, grammar_states=dfa.n_states, **extra)
        base = {"phase": "engine_exact_branch", "model": cfg.name, "dtype": "float32",
                "n_layers": cfg.n_layers, "init": "reference", "mode": mode, "page_size": 16}
        # best-of-n
        jobs = [(p, dict(max_new_tokens=n_new, seed=7 + i, n=4, **BRANCH_SAMPLE), i)
                for i, p in enumerate(prompts)]
        got, m, launches, wall, _ = run_jobs(model, params, config, device, jobs)
        want, m_cpu, _, cpu_s, _ = run_jobs(cpu_model, cpu_params, config, "cpu", jobs)
        serial_equal = []
        for b in range(4):
            sj = [(p, dict(max_new_tokens=n_new, seed=7 + i + b, **BRANCH_SAMPLE), i)
                  for i, p in enumerate(prompts)]
            ser, _, _, _, _ = run_jobs(model, params, config, device, sj)
            serial_equal.append(all(got[i][b][0] == ser[i][0][0] for i in range(len(prompts))))
        rec = {**base, "part": "best_of_n", "n": 4, "prompt_lens": list(BRANCH_LENS),
               "new_tokens": n_new, "tokens_equal_cpu_engine": _tokens_of(got) == _tokens_of(want),
               "branch_b_equals_serial_seed_plus_b": serial_equal,
               "max_score_gap_vs_cpu": _score_gap(got, want),
               **{k: m[k] for k in ("branch_forks", "cow_copies", "pages_shared",
                                    "peak_pages_in_use")},
               "cpu_branch_forks": m_cpu["branch_forks"], "cpu_cow_copies": m_cpu["cow_copies"],
               "wall_s": wall, "cpu_s": cpu_s}
        need(rec, launches, rows)
        recs.append(rec)
        emit(rec)
        if not rec["tokens_equal_cpu_engine"] or not all(serial_equal):
            raise AssertionError(f"engine_exact_branch best_of_n {mode}: {rec}")
        if m["branch_forks"] != 3 * len(prompts) or m["cow_copies"] != m_cpu["cow_copies"]:
            raise AssertionError(f"engine_exact_branch best_of_n {mode} counters: {rec}")
        # beam
        jobs = [(p, dict(max_new_tokens=n_new, beam_width=4, n=2), i)
                for i, p in enumerate(prompts)]
        got, m, launches, wall, _ = run_jobs(model, params, config, device, jobs)
        want, m_cpu, _, cpu_s, _ = run_jobs(cpu_model, cpu_params, config, "cpu", jobs)
        counters = ("branch_forks", "beam_reorders", "cow_copies")
        rec = {**base, "part": "beam", "beam_width": 4, "n": 2, "new_tokens": n_new,
               "tokens_equal_cpu_engine": _tokens_of(got) == _tokens_of(want),
               "max_score_gap_vs_cpu": _score_gap(got, want),
               "ranked": all(v[0][1] >= v[-1][1] for v in got.values()),
               **{k: m[k] for k in counters}, **{f"cpu_{k}": m_cpu[k] for k in counters},
               "fused_steps": m["fused_steps"], "wall_s": wall, "cpu_s": cpu_s}
        need(rec, launches, rows)
        recs.append(rec)
        emit(rec)
        if (not rec["tokens_equal_cpu_engine"] or rec["max_score_gap_vs_cpu"] > 1e-4
                or not rec["ranked"] or m["beam_reorders"] < 1
                or any(m[k] != m_cpu[k] for k in counters)):
            raise AssertionError(f"engine_exact_branch beam {mode}: {rec}")
        # grammar
        jobs = [(p, dict(max_new_tokens=n_new, temperature=0.9, seed=s, eos_id=eos, grammar=dfa),
                 2 * i + s) for i, p in enumerate(prompts) for s in range(2)]
        got, m, launches, wall, _ = run_jobs(model, params, config, device, jobs)
        want, _, _, cpu_s, _ = run_jobs(cpu_model, cpu_params, config, "cpu", jobs)
        fused, m4, _, _, _ = run_jobs(model, params, dataclasses.replace(config, multi_step=4),
                                      device, jobs)
        outs = [decode(v[0][0]) for v in got.values()]
        parsed = []
        for text in outs:
            try:
                parsed.append(len(json.loads(text)) == 3)
            except ValueError:
                parsed.append(False)
        rec = {**base, "part": "grammar", "grammar": "fixed_json_array_dfa(3)",
               "temperature": 0.9, "outputs": outs, "all_parse": all(parsed),
               "tokens_equal_cpu_engine": _tokens_of(got) == _tokens_of(want),
               "multi_step_4_equal_1": _tokens_of(fused) == _tokens_of(got),
               "fused_steps_multi_step_4": m4["fused_steps"],
               "max_score_gap_vs_cpu": _score_gap(got, want), "wall_s": wall, "cpu_s": cpu_s}
        need(rec, launches, rows)
        recs.append(rec)
        emit(rec)
        if not (rec["all_parse"] and rec["tokens_equal_cpu_engine"]
                and rec["multi_step_4_equal_1"] and m4["fused_steps"] > 0):
            raise AssertionError(f"engine_exact_branch grammar {mode}: {rec}")
        # the host tier
        tier_prompts = exact_requests(cfg.vocab)
        tjobs = [(p, dict(max_new_tokens=16), i) for i, p in enumerate(tier_prompts)]
        for kv in ("f32", "int4"):
            kv_rows = (rows if kv == "f32" else
                       QUANT_KV_PATH if mode == "chunked" else QUANT_KV_PATH[:1])
            tconf = exact_config(58, kv, host_pool_pages=32, **extra)
            checked = []
            got, m, launches, wall, eng = run_jobs(
                model, params, tconf, device, tjobs,
                prepare=lambda e: checked.append(watch_tier(e.cache)))
            big, m_big, _, _, _ = run_jobs(model, params, exact_config(400, kv, **extra),
                                           device, tjobs)
            # intN pages: a recompute re-quantizes decode-appended pages with
            # whole-page scales, so a run that preempts differs from one that
            # never does (tier or no tier); the gate there is the same tiered
            # engine on the CPU
            cpu_equal = cpu_tier = None
            if kv != "f32":
                cpu_got, m_cpu, _, _, _ = run_jobs(cpu_model, cpu_params, tconf, "cpu", tjobs)
                cpu_equal = _tokens_of(got) == _tokens_of(cpu_got)
                cpu_tier = {k: m_cpu[k] for k in ("preemptions", "swap_out_pages",
                                                  "swap_in_pages", "prefetch_hits")}
            promoted = checked[0]
            tier_m = {k: m[k] for k in ("preemptions", "swap_out_pages", "swap_out_elided",
                                        "swap_in_pages", "prefetch_hits", "evictions",
                                        "host_pages_resident", "cow_copies")}
            eng.cache.check_conservation()
            # session retention: a finished request's pages stay on the host,
            # and a follow-up sharing its whole context prefetches them
            rconf = dataclasses.replace(tconf, retain_finished_s=600.0)
            first, _, _, _, reng = run_jobs(model, params, rconf, device, tjobs[3:4])
            follow = tier_prompts[3] + first[3][0][0] + tier_prompts[5][:9]
            hits0 = reng.cache.tier.prefetch_hits
            from repro_torch.serving import GenerationParams
            from repro_torch.serving.engine import Request

            reng.run([Request(100, follow, GenerationParams(max_new_tokens=4))])
            follow_hits = reng.cache.tier.prefetch_hits - hits0
            reng.cache.check_conservation()
            rec = {**base, "part": "host_tier", "kv_dtype": kv, "pool_pages": 58,
                   "host_pool_pages": 32, "requests": len(tjobs), "new_tokens": 16,
                   "tokens_equal_tierless_engine": _tokens_of(got) == _tokens_of(big),
                   "tierless_preemptions": m_big["preemptions"],
                   "tokens_equal_cpu_tier_engine": cpu_equal, "cpu_tier_counters": cpu_tier,
                   **tier_m,
                   "promoted_pages_checked_byte_equal": len(promoted),
                   "follow_up_prefetch_hits": follow_hits, "wall_s": wall}
            need(rec, launches, kv_rows)
            recs.append(rec)
            emit(rec)
            exact = (rec["tokens_equal_tierless_engine"] if kv == "f32" else
                     cpu_equal and all(cpu_tier[k] == m[k] for k in cpu_tier))
            if (not exact or m["preemptions"] < 1
                    or m["swap_out_pages"] <= 0
                    or not m["swap_in_pages"] == m["prefetch_hits"] > 0
                    or len(promoted) < m["prefetch_hits"] or follow_hits <= 0):
                raise AssertionError(f"engine_exact_branch host_tier {kv} {mode}: {rec}")
    emit({"phase": "engine_exact_branch", "launches_all_runs": seen_rows})
    if device == "cuda" and any(v <= 0 for v in seen_rows.values()):
        raise AssertionError(f"engine_exact_branch: rows 1-4 did not all launch: {seen_rows}")
    return recs


SERVE_BRANCH_POOL = 56  # pages of 16: small enough that the serve_branch mix preempts


def serve_branch_jobs(prompts, n_new, eos, dfa):
    """The serve cell's 16 prompts as four kinds of four: best-of-n (n 4,
    temperature 0.8), beam (width 4, n 2), a JSON grammar (temperature 0.9)
    and plain greedy; rid i takes kind (i + i // 4) % 4, so the kinds
    interleave in arrival order and each holds one of the four prompts that
    share the 128-token system prefix."""
    kinds = ("best_of_n", "beam", "grammar", "plain")
    jobs = []
    for i, p in enumerate(prompts):
        kind = kinds[(i + i // 4) % 4]
        g = {"best_of_n": dict(temperature=0.8, seed=i, n=4),
             "beam": dict(beam_width=4, n=2),
             "grammar": dict(temperature=0.9, seed=i, eos_id=eos, grammar=dfa),
             "plain": {}}[kind]
        jobs.append((p, dict(max_new_tokens=n_new, **g), i, kind))
    return jobs


def serve_branch_phase(workload, plain_serve=None, pool_pages=SERVE_BRANCH_POOL, smi=None):
    """The serve cell (the workload's model, bf16 pages, chunked prefill 128,
    prefix sharing) with a mixed batch: four best-of-n requests, four beam
    groups, four grammar requests and four plain ones, in a pool of
    ``pool_pages`` pages of 16 with a 256-page host tier. Prints tokens/s,
    step ms p50, TTFT p95, peak pages beside the pages n full copies would
    take, the fork / reorder / CoW counters and the swap and prefetch
    counters, beside the plain serve runs' tokens/s (``plain_serve``).
    Gates: every grammar output parses, each beam result is ranked, the swap
    and prefetch counters are > 0, the allocator's conservation holds, rows
    1 and 2 launched."""
    w = workload
    dfa, eos, decode = json_grammar(w.cfg.vocab)
    jobs = serve_branch_jobs(w.prompts, w.n_new, eos, dfa)
    config = dataclasses.replace(w.config, num_pages=pool_pages, host_pool_pages=256,
                                 max_beam_width=4, grammar_states=dfa.n_states)
    seqs, m, launches, wall, eng = run_jobs(w.model, w.params, config, w.device,
                                            [j[:3] for j in jobs])
    eng.cache.check_conservation()
    kind_of = {rid: kind for _, _, rid, kind in jobs}
    outs = [decode(seqs[rid][0][0]) for rid in seqs if kind_of[rid] == "grammar"]
    parsed = []
    for text in outs:
        try:
            parsed.append(len(json.loads(text)) == 3)
        except ValueError:
            parsed.append(False)
    ranked = all(v[0][1] >= v[-1][1] and len(v) == 2
                 for rid, v in seqs.items() if kind_of[rid] == "beam")
    ps = config.page_size
    full_copies = sum((g.get("beam_width") or g.get("n", 1)) * -(-(len(p) + w.n_new) // ps)
                      for p, g, _, _ in jobs)
    rec = {
        "phase": "serve_branch", "model": w.cfg.name, "dtype": w.cfg.dtype,
        "n_layers": w.cfg.n_layers, "kv_dtype": config.kv_dtype, "requests": len(jobs),
        "mix": "4 best-of-n (n 4), 4 beam (width 4, n 2), 4 JSON grammar, 4 plain",
        "prompt_tokens": sum(len(p) for p in w.prompts), "new_tokens": w.n_new,
        "max_batch": config.max_batch, "pool_pages": pool_pages, "host_pool_pages": 256,
        **{k: m[k] for k in ("tokens_per_s", "generated_tokens", "step_ms_p50", "step_ms_p95",
                             "ttft_s_p95", "host_overhead_ms_p50", "decode_steps",
                             "fused_steps", "wall_s", "peak_pages_in_use", "pages_shared",
                             "branch_forks", "beam_reorders", "cow_copies", "preemptions",
                             "swap_out_pages", "swap_out_elided", "swap_in_pages",
                             "prefetch_hits", "evictions", "host_pages_resident")},
        "full_copies_pages": full_copies,
        "plain_serve_tokens_per_s": [r["tokens_per_s"] for r in plain_serve or []],
        "grammar_outputs": outs, "grammar_all_parse": all(parsed), "beam_ranked": ranked,
        "launches": {k: launches[k] for k in DENSE_PATH}, "nvidia_smi": smi,
    }
    emit(rec)
    if not (all(parsed) and ranked):
        raise AssertionError(f"serve_branch: a grammar output did not parse or a beam "
                             f"result is not ranked: {rec}")
    if m["failed"] or any(not v for v in seqs.values()):
        raise AssertionError(f"serve_branch did not complete every request: {rec}")
    if (m["swap_out_pages"] <= 0 or m["swap_in_pages"] <= 0 or m["prefetch_hits"] <= 0
            or m["preemptions"] <= 0):
        raise AssertionError(f"serve_branch never swapped and prefetched: {rec}")
    if w.device == "cuda" and any(launches[k] <= 0 for k in DENSE_PATH):
        raise AssertionError(f"serve_branch never launched {DENSE_PATH}: {rec}")
    return rec


# =====================================================================================
# phases: engine_exact_record, autotune and serve_models
# =====================================================================================
# recorded f32 rows, card (kernels) vs CPU (plain versions), absolute: each f32
# attention kernel agrees with its plain version within 2e-5 an output, which
# two layers and the 896-wide tied head amplify (1.5e-3 measured at 2 layers,
# PERF.md §6); a misaligned or stale row differs by O(1)
RECORD_ATOL = 1e-2
RECORD_BOUNDS = {"int8": 0.75, "int4": 2.0}  # the reference's (tests/test_serving_engine.py:314)


def _record_run(model, params, prompts, n_new, config, device):
    """One recording engine run: (engine, results, launches)."""
    from repro_torch import kernels
    from repro_torch.serving import GenerationParams
    from repro_torch.serving.engine import Request, ServeEngine

    eng = ServeEngine(model, params, config, device=device)
    reqs = [Request(i, p, GenerationParams(max_new_tokens=n_new)) for i, p in enumerate(prompts)]
    kernels.reset_launch_counts()
    res = eng.run(reqs)
    return eng, res, kernels.launch_counts()


def engine_exact_record_phase(cfg_name="qwen2-0.5b", smoke=False, device="cuda", n_layers=2,
                              n_new=16, pool_pages=58):
    """record_logits at full width, ``n_layers`` deep, f32, reference init, the
    six engine_exact requests in a pool that preempts: in both prefill
    regimes the card's greedy tokens equal the CPU engine's, each recorded
    row's argmax is its token, and the rows agree with the CPU's within
    RECORD_ATOL. Then aligned_max_logit_err of int8 and int4 pages against f32
    pages (chunked prefill) on the card, in (0, bound) with the reference's
    bounds, or in (0, 1.1 x the CPU engine's own error) where the CPU already
    passes the bound; both printed."""
    from repro_torch.models import build_model
    from repro_torch.serving.engine import aligned_max_logit_err

    cfg, model, params = exact_model(cfg_name, smoke, device, n_layers, False)
    cpu_model = build_model(cfg, device="cpu")
    cpu_params = _to_cpu(params)
    prompts = exact_requests(cfg.vocab)
    runs = {}
    for mode, extra in EXACT_MODES:
        config = exact_config(pool_pages, record_logits=True, **extra)
        eng, res, launches = _record_run(model, params, prompts, n_new, config, device)
        eng_c, res_c, _ = _record_run(cpu_model, cpu_params, prompts, n_new, config, "cpu")
        got = [res[i].generated for i in range(len(prompts))]
        want = [res_c[i].generated for i in range(len(prompts))]
        rows = [(rid, n) for rid in range(len(prompts)) for n in range(n_new)]
        recorded = all(sorted(eng.logits_of[rid]) == list(range(n_new))
                       for rid in range(len(prompts)))
        argmax_ok = recorded and all(
            int(np.argmax(eng.logits_of[rid][n])) == got[rid][n] for rid, n in rows)
        err = (max(float(np.max(np.abs(eng.logits_of[rid][n] - eng_c.logits_of[rid][n])))
                   for rid, n in rows) if recorded and got == want else None)
        m = eng.metrics()
        rec = {"phase": "engine_exact_record", "mode": mode, "model": cfg.name,
               "dtype": "float32", "n_layers": cfg.n_layers, "init": "reference",
               "requests": len(prompts), "new_tokens": n_new,
               "tokens_equal_cpu_engine": got == want, "rows_recorded": recorded,
               "argmax_equals_token": argmax_ok, "max_abs_row_err_vs_cpu": err,
               "row_tolerance": f"abs <= {RECORD_ATOL}",
               "max_abs_logit_cpu": max(float(np.max(np.abs(r))) for v in eng_c.logits_of.values()
                                        for r in v.values()),
               "preemptions": m["preemptions"],
               "fused_steps": m["fused_steps"],
               "launches": {k: launches[k] for k in DENSE_PATH + ("flash_attention",)}}
        emit(rec)
        need = DENSE_PATH if mode == "chunked" else ("paged_decode", "flash_attention")
        if not (got == want and argmax_ok and err is not None and err <= RECORD_ATOL):
            raise AssertionError(f"engine_exact_record {mode}: {rec}")
        if m["preemptions"] < 1:
            raise AssertionError(f"engine_exact_record {mode} never preempted")
        if device == "cuda" and any(launches[k] <= 0 for k in need):
            raise AssertionError(f"engine_exact_record {mode} never launched {need}")
        runs[mode] = (eng, res, eng_c, res_c)
    eng_f, res_f, eng_fc, res_fc = runs["chunked"]
    chunked = dict(EXACT_MODES)["chunked"]
    for kv, bound in RECORD_BOUNDS.items():
        config = exact_config(pool_pages, kv, record_logits=True, **chunked)
        eng, res, launches = _record_run(model, params, prompts, n_new, config, device)
        eng_c, res_c, _ = _record_run(cpu_model, cpu_params, prompts, n_new, config, "cpu")
        err = aligned_max_logit_err(eng_f, eng, res_f, res)
        err_cpu = aligned_max_logit_err(eng_fc, eng_c, res_fc, res_c)
        gate = bound if err_cpu < bound else 1.1 * err_cpu
        rec = {"phase": "engine_exact_record", "mode": "chunked", "kv_dtype": kv,
               "model": cfg.name, "n_layers": cfg.n_layers, "aligned_max_logit_err": err,
               "aligned_max_logit_err_cpu": err_cpu, "reference_bound": bound, "gate": gate,
               "launches": {k: launches[k] for k in QUANT_KV_PATH}}
        emit(rec)
        if not 0 < err < gate:
            raise AssertionError(f"engine_exact_record {kv}: error outside (0, {gate}): {rec}")
        if device == "cuda" and any(launches[k] <= 0 for k in QUANT_KV_PATH):
            raise AssertionError(f"engine_exact_record {kv} never launched {QUANT_KV_PATH}")
    return runs


def autotune_phase(workload, plain_serve=None, smi=None):
    """The autotuner at the serve workload's shape (bf16, batch 8, its
    max_len), a tuning table in a fresh temporary directory: a cold resolve
    sweeps (every candidate's time printed: us a decode step per page size,
    us a token per chunk width, the winner, its source and the sweep's
    seconds; the decode and chunk kernels launch); a warm resolve reads the
    table (source "cached") and launches no kernel; then one serve run with
    the page size and chunk width deferred to the tuner (page_size=0,
    chunk_tokens=0), whose metrics carry the tuned_* keys, its tokens/s beside
    plain serve's (printed, not gated)."""
    import shutil
    import tempfile

    from repro_torch import kernels
    from repro_torch.kernels import autotune
    from repro_torch.serving.engine import EngineConfig

    w = workload
    max_len, kv = w.config.sized_max_len, w.config.kv_dtype
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_autotune_"))
    path = tmp / "autotune_cache.json"
    saved = autotune._time_decode, autotune.DEFAULT_CACHE_PATH
    timed = []
    try:
        autotune._time_decode = lambda fn, args, reps=autotune._SWEEP_REPS: (
            timed.append(saved[0](fn, args, reps)) or timed[-1])
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        cold = autotune.resolve(w.cfg, kv_dtype=kv, batch=8, seq_len=max_len, cache_path=path,
                                device=w.device)
        sweep_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
        autotune._time_decode = saved[0]
        bps = (1,) if w.device == "cuda" else autotune.BLOCK_PAGES_CANDIDATES
        points = [(ps, bp) for ps in autotune.PAGE_SIZE_CANDIDATES for bp in bps
                  if bp <= -(-max_len // ps)]
        widths = [m * cold.page_size for m in autotune.CHUNK_PAGE_MULTIPLIERS]
        rec = {"phase": "autotune", "step": "cold", "model": w.cfg.name, "dtype": w.cfg.dtype,
               "kv_dtype": kv, "batch": 8, "seq_len": max_len, "nvidia_smi": smi,
               "decode_us_per_step": {f"page_size {ps}, block_pages {bp}": t * 1e6
                                      for (ps, bp), t in zip(points, timed)},
               "chunk_us_per_token": {f"C {c}": t * 1e6 / c
                                      for c, t in zip(widths, timed[len(points):])},
               "winner": cold.as_dict(), "source": cold.source, "sweep_s": sweep_s,
               "launches": {k: launches[k] for k in DENSE_PATH}}
        emit(rec)
        if cold.source != "swept" or len(timed) != len(points) + len(widths):
            raise AssertionError(f"autotune: the cold resolve did not sweep: {rec}")
        if w.device == "cuda" and (cold.block_pages != 1
                                   or any(launches[k] <= 0 for k in DENSE_PATH)):
            raise AssertionError(f"autotune: the cold sweep did not time the kernels: {rec}")
        kernels.reset_launch_counts()
        warm = autotune.resolve(w.cfg, kv_dtype=kv, batch=8, seq_len=max_len, cache_path=path,
                                device=w.device)
        launched = {k: v for k, v in kernels.launch_counts().items() if v}
        emit({"phase": "autotune", "step": "warm", "point": warm.as_dict(),
              "kernel_launches": launched})
        if warm != dataclasses.replace(cold, source="cached") or launched:
            raise AssertionError(f"autotune: the warm resolve swept or launched: {launched}")
        autotune.DEFAULT_CACHE_PATH = path
        config = EngineConfig.sized_for(max_len, page_size=0, max_batch=8, autotune=True,
                                        chunked_prefill=True, chunk_tokens=0)
        rec = serve_phase(workload=w, phase="autotune_serve", config=config)
        emit({"phase": "autotune_serve_vs_plain", "tokens_per_s": rec["tokens_per_s"],
              "plain_serve_tokens_per_s": [r["tokens_per_s"] for r in plain_serve or []],
              "nvidia_smi": smi})
        tuned = {"tuned_page_size": cold.page_size, "tuned_block_pages": cold.block_pages,
                 "tuned_chunk_tokens": cold.chunk_tokens, "tuned_source": "cached"}
        if any(rec.get(k) != v for k, v in tuned.items()):
            raise AssertionError(f"autotune_serve did not run the tuned shapes: {rec}")
    finally:
        autotune._time_decode, autotune.DEFAULT_CACHE_PATH = saved
        shutil.rmtree(tmp, ignore_errors=True)
    return cold, rec


SERVE_MODELS = ("llama3.2-1b", "qwen2.5-3b", "granite-8b")


def model_exact_check(cfg_name, smoke=False, device="cuda", n_new=8):
    """A dense config at full width, 2 layers, f32, reference init: three
    requests (two sharing a 256-token prefix, and a 31-token one) through the
    chunked-prefill engine on the card and on the CPU, greedy token-exact;
    the chunk and decode kernels must launch."""
    from repro_torch.models import build_model

    cfg, model, params = exact_model(cfg_name, smoke, device, 2, False)
    cpu_model = build_model(cfg, device="cpu")
    cpu_params = _to_cpu(params)
    prompts = [exact_requests(cfg.vocab)[i] for i in (0, 1, 5)]
    config = exact_config(64, **dict(EXACT_MODES)["chunked"])
    got, m, launches, wall = run_engine(model, params, prompts, n_new, config, device)
    t0 = time.perf_counter()
    want, _, _, _ = run_engine(cpu_model, cpu_params, prompts, n_new, config, "cpu")
    rec = {"phase": "serve_models_exact", "model": cfg.name, "dtype": "float32",
           "n_layers": cfg.n_layers, "d_model": cfg.d_model, "Hq": cfg.n_heads,
           "Hkv": cfg.n_kv_heads, "head_dim": cfg.head_dim, "requests": len(prompts),
           "prompt_lens": [len(p) for p in prompts], "new_tokens": n_new,
           "tokens_equal_cpu_engine": got == want, "pages_shared": m["pages_shared"],
           "launches": {k: launches[k] for k in DENSE_PATH}, "wall_s": wall,
           "cpu_s": time.perf_counter() - t0}
    emit(rec)
    if got != want:
        raise AssertionError(f"serve_models: {cfg.name} tokens differ from the CPU engine's")
    if device == "cuda" and any(launches[k] <= 0 for k in DENSE_PATH):
        raise AssertionError(f"serve_models: {cfg.name} never launched {DENSE_PATH}")
    return rec


def serve_models_phase(smoke=False, device="cuda", n_new=16, n_requests=8, smi=None):
    """llama3.2-1b, qwen2.5-3b and granite-8b at full size in bf16, random
    weights made on the card: each after its 2-layer exactness check, one run
    of the serve workload (page 16, max_batch 8, chunked prefill 128, prefix
    sharing, ``n_requests`` prompts of 64-512 tokens, ``n_new`` new each),
    every request complete and both paged kernels launched; tokens/s, step
    p50, TTFT p95, the pool's bytes and the peak memory printed. Each model is
    freed before the next."""
    import gc

    from repro_torch.core.tree import tree_leaves

    out = {}
    for name in SERVE_MODELS:
        model_exact_check(name, smoke, device)
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        w = serve_setup(name, smoke, device, n_new, n_requests=n_requests)
        rec = serve_phase(workload=w, phase="serve_models")
        emit({"phase": "serve_models_summary", "model": w.cfg.name, "n_layers": w.cfg.n_layers,
              "d_model": w.cfg.d_model, "Hq": w.cfg.n_heads, "Hkv": w.cfg.n_kv_heads,
              "head_dim": w.cfg.head_dim, "vocab": w.cfg.vocab,
              "params": sum(t.numel() for t in tree_leaves(w.params)),
              **{k: rec[k] for k in ("tokens_per_s", "step_ms_p50", "ttft_s_p95",
                                     "kv_pool_bytes", "launches")},
              "peak_memory_bytes": (torch.cuda.max_memory_allocated() if device == "cuda"
                                    else None), "nvidia_smi": smi})
        out[name] = rec
        del w, rec
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


MOE_MODELS = ("dbrx-132b", "kimi-k2-1t-a32b")
# engine_exact_moe's reduced width: each config's expert count, top-k, capacity
# factor, norm, head dim and GQA group kept (dbrx: 16 experts top-4,
# layernorm, D 128, group 6; kimi: 384 top-8, rmsnorm, D 112, group 8),
# d_model, the head counts and d_ff cut so that a CPU engine run takes seconds
MOE_EXACT_WIDTH = {
    "dbrx-132b": dict(d_model=1536, n_heads=12, n_kv_heads=2, d_head=128, d_ff=1536),
    "kimi-k2-1t-a32b": dict(d_model=768, n_heads=16, n_kv_heads=2, d_head=112, d_ff=384),
}
SERVE_MOE_LAYERS = {"dbrx-132b": 8, "kimi-k2-1t-a32b": 1}  # of 40 and 61: what fits 80 GB


def engine_exact_moe_phase(smoke=False, device="cuda", n_new=8):
    """dbrx-132b and kimi-k2 at 2 layers, f32, reference init, at
    MOE_EXACT_WIDTH (smoke: the smoke configs): three requests (two sharing a
    256-token prefix, a 31-token one) through the engine on the card and on
    the CPU with monolithic and with chunked prefill over f32 pages, and
    dbrx once more chunked over int8 pages; greedy tokens equal. The paged
    decode launches in every run, the chunk kernel in the chunked ones
    (rows 3-4 over int8 pages), flash_attention in the monolithic ones."""
    from repro_torch.models import build_model, get_config

    out = {}
    for name in MOE_MODELS:
        cfg = dataclasses.replace(get_config(name, smoke=smoke), dtype="float32")
        if not smoke:
            cfg = dataclasses.replace(cfg, n_layers=2, **MOE_EXACT_WIDTH[name])
        model = build_model(cfg, device=device)
        params = model.init_params(torch.Generator(device=device).manual_seed(0))
        cpu_model, cpu_params = build_model(cfg, device="cpu"), _to_cpu(params)
        prompts = [exact_requests(cfg.vocab)[i] for i in (0, 1, 5)]
        runs = [(mode, extra, "f32") for mode, extra in EXACT_MODES]
        if name == "dbrx-132b":
            runs.append(("chunked", dict(EXACT_MODES)["chunked"], "int8"))
        for mode, extra, kv in runs:
            config = exact_config(64, kv_dtype=kv, **extra)
            got, m, launches, wall = run_engine(model, params, prompts, n_new, config, device)
            t0 = time.perf_counter()
            want, _, _, _ = run_engine(cpu_model, cpu_params, prompts, n_new, config, "cpu")
            rows = DENSE_PATH if kv == "f32" else QUANT_KV_PATH
            need = rows if mode == "chunked" else (rows[0], "flash_attention")
            rec = {"phase": "engine_exact_moe", "model": cfg.name, "mode": mode, "kv_dtype": kv,
                   "dtype": "float32", "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                   "Hq": cfg.n_heads, "Hkv": cfg.n_kv_heads, "head_dim": cfg.head_dim,
                   "d_ff": cfg.d_ff, "n_experts": cfg.n_experts, "top_k": cfg.top_k,
                   "capacity_factor": cfg.capacity_factor, "norm": cfg.norm,
                   "requests": len(prompts), "prompt_lens": [len(p) for p in prompts],
                   "new_tokens": n_new, "tokens_equal_cpu_engine": got == want,
                   "pages_shared": m["pages_shared"],
                   "launches": {k: launches[k] for k in rows + ("flash_attention",)},
                   "wall_s": wall, "cpu_s": time.perf_counter() - t0}
            emit(rec)
            if got != want:
                raise AssertionError(f"engine_exact_moe: {cfg.name} {mode} {kv}: tokens differ "
                                     f"from the CPU engine's")
            if device == "cuda" and any(launches[k] <= 0 for k in need):
                raise AssertionError(f"engine_exact_moe: {cfg.name} {mode} {kv} never "
                                     f"launched {need}")
            out[(name, mode, kv)] = rec
        del model, params, cpu_model, cpu_params
    return out


def serve_moe_phase(smoke=False, device="cuda", n_new=16, n_requests=8, smi=None):
    """dbrx-132b (8 of 40 layers) and kimi-k2 (1 of 61) at full width in
    bf16, random weights made on the card (smoke: the smoke configs at their
    depth): one run each of the serve workload as serve_models runs it; every
    request completes and both paged kernels launch (at D 112 for kimi);
    tokens/s, step p50, TTFT p95, the pool's bytes and the peak memory
    printed beside the card. Each model is freed before the next."""
    import gc

    from repro_torch.core.tree import tree_leaves
    from repro_torch.models import get_config

    out = {}
    for name, layers in SERVE_MOE_LAYERS.items():
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        w = serve_setup(name, smoke, device, n_new, n_requests=n_requests,
                        n_layers=None if smoke else layers)
        rec = serve_phase(workload=w, phase="serve_moe")
        full = get_config(name, smoke=smoke).n_layers
        emit({"phase": "serve_moe_summary", "model": w.cfg.name, "n_layers": w.cfg.n_layers,
              "cut": f"{w.cfg.n_layers} of {full} layers at full width",
              "d_model": w.cfg.d_model, "Hq": w.cfg.n_heads, "Hkv": w.cfg.n_kv_heads,
              "head_dim": w.cfg.head_dim, "n_experts": w.cfg.n_experts, "top_k": w.cfg.top_k,
              "d_ff": w.cfg.d_ff, "norm": w.cfg.norm, "vocab": w.cfg.vocab,
              "params": sum(t.numel() for t in tree_leaves(w.params)),
              **{k: rec[k] for k in ("tokens_per_s", "step_ms_p50", "ttft_s_p95",
                                     "kv_pool_bytes", "launches")},
              "peak_memory_bytes": (torch.cuda.max_memory_allocated() if device == "cuda"
                                    else None), "nvidia_smi": smi})
        out[name] = rec
        del w, rec
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


# =====================================================================================
# the training slice: flash_attention_bwd, train_exact, train, train_loop
# =====================================================================================
BWD_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
# (name, B, Hq, Hkv, Tq, Tk, D, causal, window): llama3.2-1b's training shape,
# a D 128 group of 8, a 64-key window, whisper's cross shape (448 decoder
# positions against 1500 frames: a 28-key tail), D 256's 32-row tiles, and
# recurrentgemma-2b's local attention (a group of 10 at D 256, window 2048,
# 2600 rows: the band live and a 40-row tail)
BWD_CASES = (("llama3.2-1b", 4, 32, 8, 2048, 2048, 64, True, None),
             ("d128", 2, 16, 2, 1024, 1024, 128, True, None),
             ("window64", 2, 32, 8, 1024, 1024, 64, True, 64),
             ("whisper_cross", 4, 20, 20, 448, 1500, 64, False, None),
             ("d256", 1, 8, 1, 512, 512, 256, True, None),
             ("recurrentgemma", 1, 10, 1, 2600, 2600, 256, True, 2048))
# a ragged Tq (777: a 9-row tail past the 64-row tiles, a 9-key tail past the
# 64-key tiles), q_offset passed as a tensor, at D 128's 32-row walk tiles
BWD_RAGGED = (("ragged_d128", 1, 12, 4, 777, 777, 128, True, None),)
BWD_RTOL = 1e-4  # of each gradient's max-abs: the sums over Tq (and the group) run in another order


def _grad_excess(got, want, dtype):
    """(max |got - want| / max |want|, the tolerance rule's worst excess <= 0
    when it holds): f32 max |got - want| <= 1e-4 max |want|; bf16 each
    element within one bf16 ulp of want plus that f32 bound."""
    w = want.float()
    scale = float(w.abs().max())
    d = (got.float() - w).abs()
    if dtype == torch.float32:
        return float(d.max()) / max(scale, 1e-30), float(d.max()) - BWD_RTOL * scale
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), e - 8)
    return float(d.max()) / max(scale, 1e-30), float((d - ulp - BWD_RTOL * scale).max())


def _lse_check(q, k, v, o, lse, kw, dtype):
    """The forward's lse variant (the kernel's kLse build) at D 256, which the
    train phase first runs (recurrentgemma-2b), against the plain
    ``attention_torch(return_lse=True)``: each live row's lse within 1e-5 of
    max(1, |lse|), out within ``_grad_excess``'s rule."""
    from repro_torch.kernels import flash_attention as fa

    want_o, want_lse = fa.attention_torch(q, k, v, return_lse=True, **kw)
    live = want_lse > -1e29
    lse_err = float((lse - want_lse)[live].abs().max())
    lse_ok = bool(((lse - want_lse).abs() <= 1e-5 * want_lse.abs().clamp(min=1.0))[live].all())
    out_rel, out_x = _grad_excess(o, want_o, dtype)
    return {"lse_max_abs_err": lse_err, "out_rel_err": out_rel, "ok": lse_ok and out_x <= 0,
            "tolerance": "lse within 1e-5 of max(1, |lse|) on live rows; out as the gradients"}


def bwd_checks(bw, g):
    """flash_attention_bwd against the plain backward (flash_bwd_torch) on the
    forward kernel's out and lse, at BWD_CASES and BWD_RAGGED (q_offset a
    tensor), f32 and bf16; event ms, device ms, plain ms, the bound (2.5 x
    the forward's flops over this run's live pairs at the dtype's peak; the
    bytes of q, k, v, out, dO, lse, dq, dk, dv at the data sheet's rate; the
    larger), and as the yardstick the device ms of torch.autograd.grad
    through F.scaled_dot_product_attention (its graph built once, the
    backward alone timed; a band mask for the window). Each record carries
    the plan's splits, the tiles, the grids and the resident dK/dV blocks an
    SM; the f32 llama3.2-1b record the SHA-256 of (dq, dk, dv), to hold
    against the parent's. Returns {case: the bf16 record}."""
    import hashlib

    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_vjp as fv

    out = {}
    for name, b, hq, hkv, tq, tk, d, causal, window in BWD_CASES + BWD_RAGGED:
        off = tk - tq if causal else 0
        ragged = name in {c[0] for c in BWD_RAGGED}
        live = _causal_keys(tq, tk, off, window) if causal else tq * tk
        for dtype in (torch.float32, torch.bfloat16):
            esz = torch.tensor([], dtype=dtype).element_size()
            rnd = lambda *sh: torch.randn(*sh, generator=g, device="cuda").to(dtype)  # noqa: E731
            q, k, v, do = rnd(b, hq, tq, d), rnd(b, hkv, tk, d), rnd(b, hkv, tk, d), \
                rnd(b, hq, tq, d)
            lse = torch.empty((b, hq, tq), dtype=torch.float32, device="cuda")
            o = fa.flash_attention(q, k, v, causal=causal, window=window, q_offset=off, lse=lse)
            kw = dict(causal=causal, window=window, q_offset=off)
            fwd = _lse_check(q, k, v, o, lse, kw, dtype) if d == 256 else None
            kw_kernel = dict(kw, q_offset=torch.tensor(off, dtype=torch.int32, device="cuda")
                             if ragged else off)
            kernel = lambda: fv.flash_attention_bwd(q, k, v, o, do, lse, **kw_kernel)  # noqa: E731
            plain = lambda: fv.flash_bwd_torch(q, k, v, o, do, lse, **kw)  # noqa: E731
            plan = fv.plan_for(q, k)
            got = kernel()
            torch.cuda.synchronize()
            digest = hashlib.sha256(b"".join(
                t.contiguous().view(torch.uint8).cpu().numpy().tobytes() for t in got)).hexdigest()
            want = plain()
            errs = {gname: _grad_excess(a, w, dtype)
                    for gname, a, w in zip(("dq", "dk", "dv"), got, want)}
            abs_err = max(float((a.float() - w.float()).abs().max()) for a, w in zip(got, want))
            ok = all(x <= 0 for _, x in errs.values())
            again = kernel()
            same = all(torch.equal(a, c) for a, c in zip(got, again))
            del got, want, again
            qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
            mask = None
            if window is not None:
                qp = torch.arange(tq, device="cuda")[:, None] + off
                kp = torch.arange(tk, device="cuda")[None, :]
                mask = (kp <= qp) & (kp > qp - window)
            lib_out = F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, is_causal=causal and mask is None and tq == tk,
                enable_gqa=hq != hkv)
            library = lambda: torch.autograd.grad(lib_out, (qs, ks, vs), do,  # noqa: E731
                                                  retain_graph=True)
            nbytes = (2 * q.numel() + k.numel() + v.numel() + o.numel() + do.numel() +
                      k.numel() + v.numel()) * esz + lse.numel() * 4
            flops = 2.5 * 4 * b * hq * live * d
            t_bytes, t_ops = nbytes / NOMINAL_BW, flops / PEAK_FLOPS[dtype]
            rec = {
                "phase": "kernels", "kernel": "flash_attention_bwd", "case": name,
                "dtype": str(dtype).split(".")[1], "B": b, "Hq": hq, "Hkv": hkv, "Tq": tq,
                "Tk": tk, "D": d, "causal": causal, "window": window, "tail_keys": tk % 64,
                "rel_err": {k_: e[0] for k_, e in errs.items()}, "max_abs_err": abs_err,
                "tolerance": (f"max|err| <= {BWD_RTOL} x each gradient's max-abs"
                              + ("" if dtype == torch.float32 else
                                 ", plus one bf16 ulp of the plain value, elementwise")),
                "ok": ok, "bit_equal_rerun": same,
                "ms": time_ms(kernel, reps=10), "device_ms": device_ms_per_call(kernel, n=10),
                "plain_ms": time_ms(plain, reps=3, warmup=1),
                "library_ms": time_ms(library, reps=10),
                "library_device_ms": device_ms_per_call(library, n=10),
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "flops": flops, "live_pairs": live,
                "splits": plan.splits, "kv_grid": plan.kv_grid, "dq_grid": plan.dq_grid,
                "blocks": fv.grid_blocks(b, hq, hkv, tq, tk, d, dtype, plan.splits),
                "tiles": fv.tiles(d, dtype)._asdict(), "resident_dkdv_blocks_per_sm":
                fv.blocks_per_sm(d, q.device) if dtype == torch.bfloat16 else None,
                "q_offset_tensor": ragged, "out_sha256": digest, "forward_with_lse": fwd,
            }
            emit(rec)
            if not ok or not same or (fwd is not None and not fwd["ok"]):
                raise AssertionError(f"flash_attention_bwd {name} {dtype}: {rec}")
            if dtype == torch.bfloat16:
                out[name] = rec
            del lib_out, qs, ks, vs, q, k, v, do, o, lse
    torch.cuda.empty_cache()
    return out


# (name, b, t, h, p, n, initial state and final-state gradient): mamba2-780m's
# training shape (B 4 x 2048), and a ragged t (389: a 5-step last chunk)
SSD_BWD_CASES = (("mamba2-780m", 4, 2048, 48, 64, 128, False),
                 ("ragged", 2, 389, 48, 64, 128, True))
# (name, B, T, W, initial state and final-state gradient): recurrentgemma-2b's
# width at B 2 x 4096 (its train cell runs B 1), and a ragged T (777: a 9-step
# last stage)
RGLRU_BWD_CASES = (("recurrentgemma-2b", 2, 4096, 2560, False),
                   ("ragged", 2, 777, 2560, True))


def ssd_bwd_flops(b, t, h, p, n, q=64):
    """Multiply-adds x 2 that the SSD backward needs at this t, chunk by
    chunk (qc = the chunk's steps, tri = qc (qc + 1) / 2: L, M, dCB and C . B
    are lower-triangular): per (sequence, chunk) C . B (tri n); per head the
    state and adjoint passes (2 qc p n), dy . S, x . Lam, B . Lam^T (3 qc p
    n), dM and M^T . dy (2 tri p), dCB . B and dCB^T . C (2 tri n)."""
    total = 0
    for c0 in range(0, t, q):
        qc = min(q, t - c0)
        tri = qc * (qc + 1) // 2
        total += tri * n + h * (5 * qc * p * n + 2 * tri * p + 2 * tri * n)
    return 2 * b * total


def scan_bwd_case(kind, case, dtype, g):
    """A case of SSD_BWD_CASES (kind "ssd") or RGLRU_BWD_CASES ("rglru") on
    the card in ``dtype``, its inputs drawn from generator ``g``. Returns a
    namespace: ``kernel``, ``plain`` and ``forward`` (calls of the backward
    wrapper, its plain twin and the forward kernel on these inputs),
    ``names`` (the gradients' names), ``shape``, ``initial`` (an initial state
    and a final-state gradient given), and the bound's work: ``nbytes`` (the
    inputs read once, the outputs written once) and ``flops``."""
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels import ssd_scan as ss

    esz = torch.tensor([], dtype=dtype).element_size()
    rnd = lambda *sh: torch.randn(*sh, generator=g, device="cuda")  # noqa: E731
    if kind == "ssd":
        _, b, t, h, p, n, initial = case
        x, B, C = (rnd(b, t, h, p) * 0.5).to(dtype), (rnd(b, t, 1, n) * 0.3).to(dtype), \
            (rnd(b, t, 1, n) * 0.3).to(dtype)
        dt = torch.nn.functional.softplus(rnd(b, t, h) - 1.0)
        A = -torch.exp(rnd(h) * 0.3)
        dy = rnd(b, t, h, p).to(dtype)
        s0 = rnd(b, h, p, n) * 0.2 if initial else None
        dsf = rnd(b, h, p, n) * 0.5 if initial else None
        kw = dict(initial_state=s0, d_final_state=dsf)
        states = 3 * b * h * p * n * 4 if initial else 0  # s0, dsf read; ds0 written
        return SimpleNamespace(
            kernel=lambda: ss.ssd_scan_bwd(x, dt, A, B, C, dy, **kw),
            plain=lambda: ss.ssd_bwd_torch(x, dt, A, B, C, dy, **kw),
            forward=lambda: ss.ssd_scan(x, dt, A, B, C, initial_state=s0),
            names=("dx", "ddt", "dA", "dB", "dC", "d_initial_state"),
            shape={"b": b, "t": t, "h": h, "p": p, "n": n}, initial=initial,
            nbytes=(3 * x.numel() + 2 * B.numel() + 2 * C.numel()) * esz
            + 2 * dt.numel() * 4 + 2 * h * 4 + states,
            flops=ssd_bwd_flops(b, t, h, p, n))
    _, b, t, w, initial = case
    a = torch.exp(-8.0 * torch.nn.functional.softplus(rnd(w)) *
                  torch.sigmoid(rnd(b, t, w))).to(dtype)
    bt, dy = rnd(b, t, w).to(dtype), rnd(b, t, w).to(dtype)
    h0 = rnd(b, w) if initial else None
    dhf = rnd(b, w) if initial else None
    with torch.no_grad():
        hs = rs.rglru_scan(a.float(), bt.float(), initial_state=h0)
    kw = dict(initial_state=h0, d_final_state=dhf)
    return SimpleNamespace(
        kernel=lambda: rs.rglru_scan_bwd(a, hs, dy, **kw),
        plain=lambda: rs.rglru_bwd_torch(a, hs, dy, **kw),
        forward=lambda: rs.rglru_scan(a, bt, initial_state=h0),
        names=("da", "db", "dh0"), shape={"B": b, "T": t, "W": w}, initial=initial,
        nbytes=a.numel() * (4 * esz + 4) + (3 * b * w * 4 if initial else 0),  # a, dy, h; da, db
        flops=3 * a.numel())


def _bwd_record(name, case, dtype, got, want, names, kernel, plain, nbytes, flops, extra):
    """Check a backward kernel's outputs against its plain twin's (each by
    ``_grad_excess`` at the output's own type), rerun it for bit-equality,
    time both; emit and return the record, raising on a miss."""
    errs = {k: _grad_excess(a, w, a.dtype) for k, a, w in zip(names, got, want) if a is not None}
    abs_err = max(float((a.float() - w.float()).abs().max())
                  for a, w in zip(got, want) if a is not None)
    ok = all(x <= 0 for _, x in errs.values())
    again = kernel()
    same = all(torch.equal(a, c) for a, c in zip(got, again) if a is not None)
    del again
    t_bytes, t_ops = nbytes / NOMINAL_BW, flops / PEAK_FLOPS[dtype]
    rec = {"phase": "kernels", "kernel": name, "case": case, "dtype": str(dtype).split(".")[1],
           **extra, "rel_err": {k: e[0] for k, e in errs.items()}, "max_abs_err": abs_err,
           "tolerance": f"max|err| <= {BWD_RTOL} x each gradient's max-abs, plus one bf16 ulp "
                        "of the plain value elementwise for bf16 outputs",
           "ok": ok, "bit_equal_rerun": same,
           "ms": time_ms(kernel, reps=10), "device_ms": device_ms_per_call(kernel, n=10),
           "plain_ms": time_ms(plain, reps=3, warmup=1), "library_ms": None,
           "library": "none: no PyTorch call computes this gradient",
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "flops": flops}
    emit(rec)
    if not ok or not same:
        raise AssertionError(f"{name} {case} {dtype}: {rec}")
    return rec


def scan_bwd_checks(g):
    """ssd_scan_bwd and rglru_scan_bwd against their plain twins
    (ssd_bwd_torch, rglru_bwd_torch) on the card, f32 and bf16, at
    SSD_BWD_CASES / RGLRU_BWD_CASES: every output within ``_grad_excess``'s
    rule, two runs bit-equal; event ms, device ms, the twin's ms and the
    bound (ssd: the flops of ssd_bwd_flops at the input type's peak against
    the bytes of the inputs read once and the outputs written once; rglru:
    the bytes of a, dy, h read and da, db written). No PyTorch call computes
    either gradient (library none). Returns {kernel: the record at the train
    cells' type: ssd bf16, rglru f32 (the model's a and b are f32)}."""
    out = {}
    cases = [("ssd", "ssd_scan_bwd", c) for c in SSD_BWD_CASES] + \
        [("rglru", "rglru_scan_bwd", c) for c in RGLRU_BWD_CASES]
    for kind, kernel, case in cases:
        for dtype in (torch.float32, torch.bfloat16):
            c = scan_bwd_case(kind, case, dtype, g)
            got = c.kernel()
            torch.cuda.synchronize()
            want = c.plain()
            extra = {**c.shape, "initial_state": c.initial, "d_final_state": c.initial}
            if kind == "ssd":  # the head groups, the workspaces a call, the chunk blocks an SM
                from repro_torch.kernels import ssd_scan as ss

                sh = c.shape
                extra.update({
                    "head_groups": dict(zip(("heads_a_group", "groups"),
                                            ss.bwd_head_groups(sh["b"], sh["t"], sh["h"]))),
                    "workspace_bytes": ss.bwd_workspace_bytes(sh["b"], sh["t"], sh["h"], sh["n"]),
                    "chunk_blocks_per_sm": ss.bwd_blocks_per_sm(dtype, sh["n"],
                                                                torch.device("cuda"))})
            if kind == "rglru":
                extra["bit_equal_to_plain"] = all(torch.equal(x_, y_) for x_, y_ in
                                                  zip(got, want) if x_ is not None)
            rec = _bwd_record(kernel, case[0], dtype, got, want, c.names, c.kernel, c.plain,
                              c.nbytes, c.flops, extra)
            # the train cells' types: ssd bf16, rglru f32 (the model's a and b are f32)
            if (case, dtype) in ((SSD_BWD_CASES[0], torch.bfloat16),
                                 (RGLRU_BWD_CASES[0], torch.float32)):
                out[kernel] = rec
            del got, want, c
    torch.cuda.empty_cache()
    return out


TRAIN_EXACT = {"llama3.2-1b": dict(n_layers=2, batch=2, seq=512),
               "whisper-large-v3": dict(n_layers=2, n_enc_layers=2, batch=2, seq=448),
               "mamba2-780m": dict(n_layers=2, batch=2, seq=512),
               # rec, rec, local_attn: both block kinds of the hybrid program
               "recurrentgemma-2b": dict(n_layers=3, batch=2, seq=512)}
# the kernels each family's train step runs, and the plain twins it must not call
TRAIN_KERNELS = {"ssm": ("ssd_scan", "ssd_scan_bwd"),
                 "hybrid": ("rglru_scan", "rglru_scan_bwd", "flash_attention",
                            "flash_attention_bwd")}
TRAIN_ATTN_KERNELS = ("flash_attention", "flash_attention_bwd")


def plain_twin_calls():
    """Calls so far of the scans' plain versions (forward and backward)."""
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels import ssd_scan as ss

    return {f.__name__: f.calls for f in (ss.ssd_torch, ss.ssd_bwd_torch, rs.rglru_torch,
                                          rs.rglru_bwd_torch)}
TRAIN_EXACT_RTOL = 1e-3  # of each gradient leaf's max-abs, kernels vs the plain path (f32)


def _train_batch(cfg, batch, seq, device, seed=0):
    from repro_torch.data import DataConfig, SyntheticLM

    out = {"tokens": torch.from_numpy(SyntheticLM(DataConfig(
        batch=batch, seq=seq, vocab=cfg.vocab, seed=seed)).batch_at(0)["tokens"]).to(device)}
    if cfg.family in ("encdec", "vlm"):
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        key, n = ("frames", cfg.enc_seq) if cfg.family == "encdec" else \
            ("image_embeds", cfg.n_img_tokens)
        out[key] = torch.randn(batch, n, cfg.d_model, generator=gen,
                               device=device).to(cfg.param_dtype)
    return out


def _tree_rel(a_tree, b_tree, where=None):
    """The largest max |a - b| / max |b| over the leaves of two trees (f32
    views of {"q", "scale"} leaves compared as they are); with ``where`` (a
    dict) also the path of that leaf in it."""
    from repro_torch.core.tree import tree_leaves, tree_leaves_with_path

    worst = 0.0
    for (path, a), b in zip(tree_leaves_with_path(a_tree), tree_leaves(b_tree)):
        a, b = a.float(), b.float()
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        if rel >= worst:
            worst = rel
            if where is not None:
                where["worst_leaf"] = "/".join(map(str, path))
    return worst


def _moment_flips(a_tree, b_tree, log_domain):
    """Two runs' int8 moments decoded as AdamW decodes them (v from the log
    domain) -> (the largest |a - b| less 1e-3 of the leaf's max-abs, in
    quantization steps of the larger scale, a step of v taken at its value;
    the share of elements apart by more than half a step plus that slack;
    the f32 leaves' largest relative difference; the worst element's
    values). For v the slack also takes 4 f32 ulps of the log domain at v ~
    0, about 7.6e-18: log(v + 1e-12) is f32 near -27.6, so both packages'
    encodings resolve v no finer there, and the leaves whose gradients are
    all ~1e-8 live there."""
    from repro_torch.core.accessors import QuantizedAccessor
    from repro_torch.core.distributed import dequantize_array
    from repro_torch.core.tree import tree_leaves
    from repro_torch.optim.adamw import _V_FLOOR, _V_SHIFT

    worst, flips, total, rel, where = 0.0, 0, 0, 0.0, None
    is_q = lambda x: isinstance(x, dict) and "q" in x  # noqa: E731
    for a, b in zip(tree_leaves(a_tree, is_q), tree_leaves(b_tree, is_q)):
        if not is_q(a):
            rel = max(rel, float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30))
            continue
        block = a["q"].shape[-1] // a["scale"].shape[-1]
        acc = QuantizedAccessor(torch.float32, bits=8, block=block)
        la, lb = dequantize_array(a, acc), dequantize_array(b, acc)
        step = torch.maximum(a["scale"], b["scale"]).repeat_interleave(block, dim=-1)
        if log_domain:  # v = exp(val - shift) - floor: a step is a relative change
            da = torch.clamp(torch.exp(la - _V_SHIFT) - _V_FLOOR, min=0.0)
            db = torch.clamp(torch.exp(lb - _V_SHIFT) - _V_FLOOR, min=0.0)
            step = (torch.maximum(da, db) + _V_FLOOR) * torch.expm1(step)
        else:
            da, db = la, lb
        slack = TRAIN_EXACT_RTOL * float(db.abs().max())
        if log_domain:  # 4 f32 ulps of log(v + floor) ~ -27.6 (2^-19 each), as v
            slack += 4 * _V_FLOOR * 2.0 ** -19
        apart = ((da - db).abs() - slack).clamp(min=0.0) / step
        if float(apart.max()) > worst:
            i = int(apart.argmax())
            where = {k: float(t.reshape(-1)[i]) for k, t in (
                ("a", da), ("b", db), ("qa", a["q"]), ("qb", b["q"]), ("step", step))}
            where.update(slack=slack, shape=list(a["q"].shape))
        worst = max(worst, float(apart.max()))
        flips += int((apart > 0.5).sum())
        total += apart.numel()
    return worst, flips / max(total, 1), rel, where


def train_exact_phase(device="cuda", smoke=False):
    """One train step (and three, for the moments) of the kernels
    (attn_impl="auto": flash_attention forward, flash_attention_bwd
    backward) against the plain path (attn_impl="torch": flash_attention_torch)
    on the card, the same init_params, in f32 with TF32 off: llama3.2-1b's
    width at 2 layers (B 2 x 512) and whisper-large-v3's at 2 + 2 layers
    (B 2, 448 decoder positions against 1500 frames: the non-causal Tq != Tk
    backward inside a model), mamba2-780m's at 2 layers (B 2 x 512:
    ssd_scan forward, ssd_scan_bwd backward, inside SSDScanFn) and
    recurrentgemma-2b's at 3 (rec, rec, local_attn; B 2 x 512: rglru_scan
    and rglru_scan_bwd inside RGLRUScanFn, the flash kernels at D 256), each
    family's kernels launched in the kernels' run and the scans' plain twins
    (``plain_twin_calls``) called none of the times there; the attention
    projections rescaled to their
    fan-in (``condition_attention``, as the CPU tests' weights: on the
    reference's init attention is near-argmax, and the backward through it
    parts the two paths' f32 roundings by 2.4% on a whisper leaf at 2 + 2
    layers; ``_reference_init_witness`` measures that regime beside the
    plain path against itself). Loss within 1e-5, every gradient leaf within
    1e-3 of its max-abs, grad_norm within 1e-4; for llama, m and v after 1
    and 3 steps at lr 0 (``_train_exact_moments``) within 1e-3 of their
    max-abs (f32 moments) or, decoded (v from its log domain), within k
    quantization steps plus 1e-3 of the leaf's max-abs after k steps, at most
    0.1% of elements more than half a step apart (int8 moments: a rounding
    near a half step may go either way and carries on; a gradient all but 0,
    where the two paths' f32 sums cancel, differs by more than a step of
    its own tiny v), and three steps at lr 1e-3 within 1e-4 (losses) and
    1e-3 (m and v)."""
    from repro_torch import kernels
    from repro_torch.models import build_model, get_config
    from repro_torch.train import TrainProfile, loss_and_grads

    launches = {k: 0 for k in ("flash_attention", "flash_attention_bwd", "ssd_scan",
                               "ssd_scan_bwd", "rglru_scan", "rglru_scan_bwd")}
    for arch, spec in TRAIN_EXACT.items():
        shape = {k: v for k, v in spec.items() if k not in ("batch", "seq")}
        cfg = dataclasses.replace(get_config(arch, smoke=smoke), dtype="float32",
                                  **({} if smoke else shape))
        seq = min(spec["seq"], 32) if smoke else spec["seq"]
        model = build_model(cfg, device=device)
        params = condition_attention(
            cfg, model.init_params(torch.Generator(device=device).manual_seed(0)))
        batch = _train_batch(cfg, spec["batch"], seq, device)
        res = {}
        for impl in ("auto", "torch"):
            kernels.reset_launch_counts()
            twins = plain_twin_calls()
            res[impl] = loss_and_grads(model, params, batch, TrainProfile(), impl)
            if impl == "auto":
                counts = kernels.launch_counts()
                for k in launches:
                    launches[k] += counts[k]
                run_counts = {k: counts[k] for k in TRAIN_KERNELS.get(cfg.family,
                                                                      TRAIN_ATTN_KERNELS)}
                twin_calls = {k: v - twins[k] for k, v in plain_twin_calls().items()}
        (la, ga), (lt, gt) = res["auto"], res["torch"]
        where = {}
        grad_rel = _tree_rel(ga, gt, where)
        loss_rel = abs(float(la) - float(lt)) / abs(float(lt))
        rec = {"phase": "train_exact", "arch": arch, "layers": cfg.n_layers,
               "enc_layers": cfg.n_enc_layers if cfg.family == "encdec" else None,
               "batch": spec["batch"], "seq": seq, "loss_kernels": float(la),
               "loss_plain": float(lt), "loss_rel": loss_rel, "grad_max_rel": grad_rel,
               "grad_worst_leaf": where.get("worst_leaf"),
               "tolerance": f"loss 1e-5, each gradient leaf {TRAIN_EXACT_RTOL} of its max-abs",
               "kernel_launches": run_counts, "plain_twin_calls": twin_calls}
        del res, ga, gt
        if arch == "llama3.2-1b":
            rec.update(_train_exact_moments(model, params, cfg, spec["batch"], seq, device))
        elif cfg.family == "encdec":
            rec["reference_init"] = _reference_init_witness(model, cfg, batch, device)
        emit(rec)
        if loss_rel > 1e-5 or grad_rel > TRAIN_EXACT_RTOL:
            raise AssertionError(f"train_exact {arch}: kernels and plain path disagree: {rec}")
        if device == "cuda" and (not all(run_counts.values()) or any(twin_calls.values())):
            raise AssertionError(f"train_exact {arch}: a kernel of the path did not launch, or "
                                 f"a plain twin ran: {rec}")
        del model, params, batch
        torch.cuda.empty_cache()
    if device == "cuda" and not all(launches.values()):
        raise AssertionError(f"train_exact: a kernel of the path did not launch: {launches}")
    return launches


WITNESS_RATIO = 10.0  # "of the same order": kernels-vs-plain within 10x plain-vs-plain


def _plain_grads_at_block_k(model, params, batch, block_k):
    """loss_and_grads on the plain path with attention's key blocks of
    ``block_k`` (the forward's and the backward's; 512 otherwise):
    ``ops.attention`` is pointed at it for this one call."""
    from repro_torch.kernels import flash_vjp, ops
    from repro_torch.train import TrainProfile, loss_and_grads

    def blocked(*args, **kw):
        return flash_vjp.flash_attention_torch(*args, **dict(kw, block_k=block_k))

    ops.flash_attention_torch = blocked
    try:
        return loss_and_grads(model, params, batch, TrainProfile(), "torch")[1]
    finally:
        ops.flash_attention_torch = flash_vjp.flash_attention_torch


def _reference_init_witness(model, cfg, batch, device):
    """The gradients at the reference's init (no condition_attention), where
    attention is near-argmax: the kernels against the plain path on the
    card, beside the plain path against itself, once with attention's key
    blocks of 64 in place of 512 (only attention's f32 summation order
    differs, as between the kernels and the plain path) and once on the CPU
    (every product's order differs). Each as the largest relative difference
    over the leaves and its leaf, and each gap on the kernels' worst leaf.
    If the kernels' gap is f32 rounding amplified by the regime, the plain
    path parts from itself by as much; a fault in the backward would leave
    the kernels far apart from both. Fails when the kernels' gap passes
    WITNESS_RATIO x the plain path's at block 64."""
    from repro_torch.core.tree import tree_leaves_with_path, tree_map
    from repro_torch.models import build_model
    from repro_torch.train import TrainProfile, loss_and_grads

    params = model.init_params(torch.Generator(device=device).manual_seed(0))
    grads = {impl: loss_and_grads(model, params, batch, TrainProfile(), impl)[1]
             for impl in ("auto", "torch")}
    grads["block_64"] = _plain_grads_at_block_k(model, params, batch, 64)
    on_cpu = lambda tree: tree_map(lambda t: t.to("cpu"), tree)  # noqa: E731
    grads["cpu"] = loss_and_grads(build_model(cfg, device="cpu"), on_cpu(params),
                                  on_cpu(batch), TrainProfile(), "torch")[1]
    del params

    def gaps(a, b):  # {leaf path: max |a - b| / max |b|}
        return {"/".join(map(str, path)): float((x.float().cpu() - y.float().cpu()).abs().max())
                / max(float(y.float().abs().max()), 1e-30)
                for (path, x), (_, y) in zip(tree_leaves_with_path(a),
                                             tree_leaves_with_path(b))}

    kern = gaps(grads["auto"], grads["torch"])
    block = gaps(grads["block_64"], grads["torch"])
    cpu = gaps(grads["cpu"], grads["torch"])
    del grads
    kl, bl, cl = (max(g, key=g.get) for g in (kern, block, cpu))
    out = {"kernels_vs_plain": kern[kl], "kernels_worst_leaf": kl,
           "plain_block64_vs_plain": block[bl], "block64_worst_leaf": bl,
           "block64_on_kernels_worst_leaf": block[kl],
           "plain_cpu_vs_plain": cpu[cl], "cpu_worst_leaf": cl,
           "cpu_on_kernels_worst_leaf": cpu[kl],
           "gate": f"kernels_vs_plain <= {WITNESS_RATIO} x plain_block64_vs_plain"}
    if kern[kl] > WITNESS_RATIO * block[bl]:
        emit({"phase": "train_exact", "failed": "reference_init_witness", **out})
        raise AssertionError(f"train_exact: at the reference's init the kernels part from the "
                             f"plain path by more than it parts from itself: {out}")
    return out


def _three_steps(model, params, cfg, batch, seq, device, opt, impl):
    """Three train steps from ``params`` on SyntheticLM batches 0-2: [(m, v,
    grad_norm, loss)] after steps 1 and 3."""
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainProfile, make_train_step

    step, _, specs = make_train_step(model, opt, TrainProfile(), attn_impl=impl)
    p, s, out = params, adamw_init(specs, device), []
    for i in range(3):
        p, s, m = step(p, s, _train_batch(cfg, batch, seq, device, seed=i))
        out.append((s["m"], s["v"], float(m["grad_norm"]), float(m["loss"])))
    return [out[0], out[2]]


def _train_exact_moments(model, params, cfg, batch, seq, device):
    """AdamW's m and v after 1 and 3 steps, kernels against the plain path,
    f32 and int8 moments, at lr 0: both paths then take every gradient at the
    same params. Then three steps at lr 1e-3, f32 moments: losses within
    1e-4 at each step, m and v after 3 within 1e-3 of their max-abs. (At lr
    > 0 Adam's first update is lr * sign(g); where g is all but 0, the two
    paths' roundings may pick opposite signs and the params part. On the
    conditioned weights they stay within 2e-5; on the reference's init the
    losses parted by 0.18% after three steps.)"""
    from repro_torch.optim import AdamWConfig, constant

    out = {}
    for int8 in (False, True):
        opt = AdamWConfig(lr=constant(0.0), int8_state=int8)
        runs = {impl: _three_steps(model, params, cfg, batch, seq, device, opt, impl)
                for impl in ("auto", "torch")}
        for k_steps, sa, st in zip((1, 3), runs["auto"], runs["torch"]):
            gn_rel = abs(sa[2] - st[2]) / st[2]
            key = f"{'int8' if int8 else 'f32'}_moments_after_{k_steps}"
            if int8:
                mw, mf, mr, m_at = _moment_flips(sa[0], st[0], log_domain=False)
                vw, vf, vr, v_at = _moment_flips(sa[1], st[1], log_domain=True)
                ok = (max(mw, vw) <= k_steps * 1.001 and max(mf, vf) <= 1e-3
                      and max(mr, vr) <= TRAIN_EXACT_RTOL)
                out[key] = {"m_steps_apart": mw, "v_steps_apart": vw, "m_share_apart": mf,
                            "v_share_apart": vf, "f32_leaves_rel": max(mr, vr),
                            "worst_m": m_at, "worst_v": v_at}
            else:
                mr, vr = _tree_rel(sa[0], st[0]), _tree_rel(sa[1], st[1])
                ok = max(mr, vr) <= TRAIN_EXACT_RTOL
                out[key] = {"m_rel": mr, "v_rel": vr}
            out[key].update(grad_norm_rel=gn_rel, ok=ok and gn_rel <= 1e-4)
            if not out[key]["ok"]:
                emit({"phase": "train_exact", "failed": key, **out})
                raise AssertionError(f"train_exact {key}: {out[key]}")
        del runs
    opt = AdamWConfig(lr=constant(1e-3))
    runs = {impl: _three_steps(model, params, cfg, batch, seq, device, opt, impl)
            for impl in ("auto", "torch")}
    losses = {impl: [r[3] for r in runs[impl]] for impl in runs}
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses["auto"], losses["torch"]))
    out["lr_1e-3"] = {"losses_after_1_and_3": losses, "loss_rel": loss_rel,
                      "m_rel_after_3": _tree_rel(runs["auto"][1][0], runs["torch"][1][0]),
                      "v_rel_after_3": _tree_rel(runs["auto"][1][1], runs["torch"][1][1])}
    lr_run = out["lr_1e-3"]
    if loss_rel > 1e-4 or max(lr_run["m_rel_after_3"], lr_run["v_rel_after_3"]) > \
            TRAIN_EXACT_RTOL:
        emit({"phase": "train_exact", "failed": "lr_1e-3", **out})
        raise AssertionError(f"train_exact lr 1e-3: the runs part: {lr_run}")
    return out


TRAIN_CELLS = {  # arch -> the cell: steps, batch, seq, and the configuration's source
    "llama3.2-1b": dict(steps=8, batch=4, seq=2048, source="hf:meta-llama/Llama-3.2-1B"),
    "mamba2-780m": dict(steps=8, batch=4, seq=2048, source="arXiv:2405.21060"),
    # B 2 x 4096 does not fit 80 GB on the allocator's default segments: the
    # 256000-wide loss's f32 logits and their gradient take 7.8 GiB each at
    # B 2, and the gradient's allocation failed with 20 GiB reserved but
    # unallocated. So the batch is cut to 1; T (the window band) is kept.
    "recurrentgemma-2b": dict(steps=8, batch=1, seq=4096, source="arXiv:2402.19427",
                              reduced=["batch 2 -> 1 (B 2 x 4096 runs out of 80 GB)"]),
}


def train_phase(smi, device="cuda", smoke=False, arch="llama3.2-1b"):
    """TrainerLoop at ``arch``'s full width (TRAIN_CELLS: llama3.2-1b 16
    layers, d_model 2048, 32 / 8 heads of 64, vocab 128256, B 4 x 2048;
    mamba2-780m 48 layers, d_model 1536, 48 heads of 64, N 128, vocab 50280,
    B 4 x 2048; recurrentgemma-2b 26 layers, d_model 2560, MQA 10 / 1 of 256,
    window 2048, vocab 256000, B 1 x 4096: the batch cut to fit), bf16 params, remat on, f32
    moments, 8 steps on SyntheticLM batches; the checkpoint directory a
    TemporaryDirectory and ckpt_every past the last step, so only the final
    save runs. Prints the step time p50 over steps 2-7, tokens/s, peak
    memory, each step's loss (all finite), the launches a step of the
    family's kernels (counts zeroed just before the loop, read just after),
    the final save's bytes and seconds; then restores the save and checks
    every leaf bit for bit against the state in memory. Returns the launch
    counts of the run."""
    import tempfile

    from repro_torch import kernels
    from repro_torch.core.tree import tree_leaves
    from repro_torch.runtime import RunConfig, TrainerLoop

    torch.cuda.empty_cache()
    cell = dict(TRAIN_CELLS[arch], **(dict(batch=2, seq=32) if smoke else {}))
    with tempfile.TemporaryDirectory() as ckpt_dir:
        run = RunConfig(arch=arch, smoke=smoke, steps=cell["steps"], batch=cell["batch"],
                        seq=cell["seq"], peak_lr=3e-4, warmup=2, ckpt_dir=ckpt_dir,
                        ckpt_every=10 * cell["steps"], log_every=1, remat=True, device=device)
        loop = TrainerLoop(run)
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        twins = plain_twin_calls()
        out = loop.run_loop()
        counts = kernels.launch_counts()
        twin_calls = {k: v - twins[k] for k, v in plain_twin_calls().items()}
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
        hist = out["history"]
        losses = [h["loss"] for h in hist]
        times = [h["time_s"] for h in hist[2:]]
        p50 = statistics.median(times)
        restored = loop.restore(out["final_step"])
        same = all(torch.equal(a.view(-1).view(torch.uint8) if a.dim() else a,
                               b.view(-1).view(torch.uint8) if b.dim() else b)
                   for a, b in zip(tree_leaves(restored),
                                   tree_leaves((loop.params, loop.opt_state))))
        n_leaves = len(tree_leaves(restored))
        del restored
    n = len(hist)
    cfg = loop.cfg
    need = TRAIN_KERNELS.get(cfg.family, TRAIN_ATTN_KERNELS)
    rec = {"phase": "train", "nvidia_smi": smi, "arch": arch, "source": cell["source"],
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "heads": [cfg.n_heads, cfg.n_kv_heads], "vocab": cfg.vocab, "dtype": cfg.dtype,
           "remat": True, "moments": "f32", "batch": cell["batch"], "seq": cell["seq"],
           "steps": n, "step_ms_p50_steps_2_7": p50 * 1e3,
           "step_ms": [h["time_s"] * 1e3 for h in hist],
           "tokens_per_s": cell["batch"] * cell["seq"] / p50,
           "peak_memory_bytes": peak, "losses": losses,
           "launches_per_step": {k: counts[k] / n for k in need},
           "plain_twin_calls": twin_calls, "reduced": cell.get("reduced", []),
           "final_save": loop.last_save, "restored_leaves": n_leaves,
           "restored_bit_equal": same}
    emit(rec)
    ONE_DEVICE_TRAIN[arch] = {"step_ms_p50": p50 * 1e3, "peak_memory_bytes": peak,
                              "batch": cell["batch"], "seq": cell["seq"]}
    if not all(math.isfinite(x) for x in losses) or n != cell["steps"]:
        raise AssertionError(f"train {arch}: {n} steps, losses {losses}")
    if not same:
        raise AssertionError(f"train {arch}: the restored checkpoint differs from the state in "
                             "memory")
    if device == "cuda" and (not all(counts[k] for k in need) or any(twin_calls.values())):
        raise AssertionError(f"train {arch}: a kernel of the path did not launch, or a plain "
                             f"twin ran: {counts}, {twin_calls}")
    del loop
    torch.cuda.empty_cache()
    return counts


def train_loop_phase(device="cuda", arch="llama3.2-1b"):
    """``arch``'s smoke config's trainer loop on the card, with the
    reference's runtime assertions: it learns (the mean of the last 3 of 12
    losses below the first 3's) and its last checkpoint is step 12; a second
    run resumes from it; a run with simulate_failure(at_step=5) restores its
    latest checkpoint and finishes at final_step 10."""
    import tempfile

    from repro_torch.runtime import RunConfig, TrainerLoop, simulate_failure

    kw = dict(arch=arch, smoke=True, batch=4, log_every=100, device=device)
    with tempfile.TemporaryDirectory() as d:
        loop = TrainerLoop(RunConfig(steps=12, seq=32, peak_lr=3e-3, warmup=2, ckpt_dir=d,
                                     ckpt_every=5, **kw))
        hist = loop.run_loop()["history"]
        first = statistics.mean(h["loss"] for h in hist[:3])
        last = statistics.mean(h["loss"] for h in hist[-3:])
        latest = loop.ckpt.latest()
        resumed = TrainerLoop(RunConfig(steps=14, seq=32, ckpt_dir=d, ckpt_every=5, **kw))
        steps_resumed = [h["step"] for h in resumed.run_loop()["history"]]
    with tempfile.TemporaryDirectory() as d:
        failing = TrainerLoop(RunConfig(steps=10, seq=16, ckpt_dir=d, ckpt_every=2, **kw),
                              failure_hook=simulate_failure(at_step=5).maybe_fail)
        out = failing.run_loop()
    rec = {"phase": "train_loop", "arch": f"{arch} (smoke)", "first3_loss": first,
           "last3_loss": last, "learns": last < first, "latest": latest,
           "resumed_steps": steps_resumed, "restarts": failing.restarts,
           "final_step": out["final_step"], "steps_after_failure": [h["step"] for h in
                                                                   out["history"]]}
    emit(rec)
    if not (last < first and latest == 12 and steps_resumed and steps_resumed[0] >= 12
            and failing.restarts == 1 and out["final_step"] == 10
            and any(h["step"] == 9 for h in out["history"])):
        raise AssertionError(f"train_loop: {rec}")


# the ranks of the sharded phases: 1, over NCCL. scripts/probe_card_ranks.py
# ran 2 gloo ranks ("cpu:gloo,cuda:gloo") on the one card and both died
# (PERF.md, PR 33); NCCL refuses two ranks on one GPU. A (1, 1) mesh still
# runs the placements, local_map and the kernels on the card, and sends no
# bytes between ranks.
SHARDED_W = 1
SHARDED_MESHES = sorted({(SHARDED_W, 1), (1, SHARDED_W)})
# train_sharded_exact: arch -> (the config's cut, batch, seq), f32, against the
# one-device step; every family of the reference
SHARDED_EXACT = {
    "llama3.2-1b": (dict(n_layers=2), 2, 512),
    "kimi-k2-1t-a32b": (dict(n_layers=2, capacity_factor=8.0,
                             **MOE_EXACT_WIDTH["kimi-k2-1t-a32b"]), 2, 512),
    "mamba2-780m": (dict(n_layers=2), 2, 512),
    # rec, rec, local_attn: both block kinds of the hybrid program
    "recurrentgemma-2b": (dict(n_layers=3), 2, 512),
    "whisper-large-v3": (dict(n_layers=2, n_enc_layers=2), 2, 448),
    # one group (4 self layers and the gated cross layer) at a reduced width
    # keeping the heads (64 / 8 of 128), the MLP's form and the 6404 image
    # tokens: 90B's layers at full width take ~3.4 GB each in f32, and the
    # check holds two gradient trees beside the params
    "llama-3.2-vision-90b": (dict(n_layers=5, d_model=2048, d_head=128, d_ff=4096), 2, 512),
}
SHARDED_VISION_GATE = 0.7  # the CPU tests' gate: tanh(0) would erase the cross layer
SHARDED_MOE_X = (2, 256)  # the EP block's input: B x T tokens at kimi-k2's reduced width
# train_sharded: the train cells' configurations through TrainerLoop on the
# mesh; "seqs" the sequence lengths tried in turn (a shorter one only after
# the card ran out of memory, listed as a cut)
SHARDED_CELLS = {
    "llama3.2-1b": dict(steps=6, batch=4, seqs=(2048,), source="hf:meta-llama/Llama-3.2-1B",
                        final_save=True),
    "mamba2-780m": dict(steps=6, batch=4, seqs=(2048,), source="arXiv:2405.21060",
                        final_save=False),
    "recurrentgemma-2b": dict(steps=6, batch=1, seqs=(4096, 2048), source="arXiv:2402.19427",
                              final_save=False,
                              reduced=["batch 2 -> 1 (B 2 x 4096 runs out of 80 GB, as in the "
                                       "one-device train cell)"]),
}
ATTN_PLAIN = ("flash_attention_torch", "flash_bwd_torch")
# the one-device train cells' step p50 (ms) and peak bytes, written by
# train_phase, shown beside the sharded cells of the same call
ONE_DEVICE_TRAIN = {}


@contextlib.contextmanager
def process_group(device):
    """A torch.distributed group of the SHARDED_W ranks in this process (NCCL
    on the card, gloo on the CPU) on a file store in a temporary directory."""
    import torch.distributed as dist

    if SHARDED_W != 1:
        raise NotImplementedError("more than one rank needs scripts/probe_card_ranks.py to pass "
                                  "on the card and the ranks spawned as processes")
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl" if device == "cuda" else "gloo",
                                init_method=f"file://{d}/store", world_size=SHARDED_W, rank=0)
        try:
            yield
        finally:
            dist.destroy_process_group()


def sharded_mesh(shape, device):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device, torch.arange(SHARDED_W).reshape(shape),
                      mesh_dim_names=("data", "model"))


def attn_plain_calls():
    """Calls so far of attention's plain differentiable version and its
    backward."""
    from repro_torch.kernels import flash_vjp

    return {name: getattr(flash_vjp, name).calls for name in ATTN_PLAIN}


def _allclose_excess(got, want, rtol, atol):
    """max(|got - want| - atol - rtol |want|) over the elements (<= 0: the
    reference's assert_allclose passes)."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float(((got - want).abs() - atol - rtol * want.abs()).max())


def _sharded_grads(model, params, batch, mesh, rules, profile=None):
    """loss_and_grads on ``mesh``: (loss, gradients gathered whole, the
    launches of the family's kernels, the plain versions' calls: the
    attention's and the scans' twins)."""
    from repro_torch import kernels
    from repro_torch.core.distributed import tree_distribute, tree_full
    from repro_torch.models.layers import Sharder
    from repro_torch.train import TrainProfile, loss_and_grads
    from repro_torch.train.step import place_batch

    pd = tree_distribute(params, model.param_specs(), mesh, rules)
    kernels.reset_launch_counts()
    plain = {**attn_plain_calls(), **plain_twin_calls()}
    loss, grads = loss_and_grads(model, pd, place_batch(batch, mesh, rules),
                                 profile or TrainProfile(), "auto", shard=Sharder(mesh, rules))
    counts = kernels.launch_counts()
    plain = {k: v - plain[k] for k, v in {**attn_plain_calls(), **plain_twin_calls()}.items()}
    need = TRAIN_KERNELS.get(model.cfg.family, TRAIN_ATTN_KERNELS)
    return loss.full_tensor(), tree_full(grads), {k: counts[k] for k in need}, plain


def train_sharded_exact_phase(device="cuda", smoke=False):
    """The sharded train step against the port's one-device step on the
    card (f32, TF32 off), on every mesh of SHARDED_W ranks, for every family
    (SHARDED_EXACT; smoke: the smoke configs at 32 tokens): llama3.2-1b's
    width at 2 layers (B 2 x 512), kimi-k2's MOE_EXACT_WIDTH at 2 layers
    (capacity factor 8; its layer-0 experts also go through apply_moe_ep
    against apply_moe), mamba2-780m at 2 layers, recurrentgemma-2b at 3
    (rec, rec, local_attn), whisper-large-v3 at 2 + 2 (448 positions
    against 1500 frames) and llama-3.2-vision-90b at one group (5 layers)
    of a reduced width (gate SHARDED_VISION_GATE): every block in its block
    map. The attention projections rescaled to their fan-in
    (``condition_attention``, as train_exact). Gates: the loss within 1e-5,
    each gradient leaf within TRAIN_EXACT_RTOL of its max-abs, the step's
    loss 1e-5 and grad_norm 1e-4; the family's kernels (the scans' forward
    and backward, flash_attention and its backward) launched in the sharded
    run, inside the block maps, and no plain version called. Returns the
    launches in the sharded runs, by kernel."""
    from repro_torch.core.distributed import tree_distribute
    from repro_torch.launch import train_rules
    from repro_torch.models import build_model, get_config
    from repro_torch.optim import AdamWConfig, adamw_init, constant
    from repro_torch.train import TrainProfile, loss_and_grads, make_train_step

    launches = {}
    with process_group(device):
        for arch, (cut, batch_n, seq) in SHARDED_EXACT.items():
            cfg = dataclasses.replace(get_config(arch, smoke=smoke), dtype="float32")
            if arch == "kimi-k2-1t-a32b":
                cfg = dataclasses.replace(cfg, capacity_factor=8.0)
            if not smoke:
                cfg = dataclasses.replace(cfg, **cut)
            seq = 32 if smoke else seq
            model = build_model(cfg, device=device)
            params = condition_attention(
                cfg, model.init_params(torch.Generator(device=device).manual_seed(0)))
            if cfg.family == "vlm":
                for group in params["blocks"][0]:
                    group["gate"].fill_(SHARDED_VISION_GATE)
            batch = _train_batch(cfg, batch_n, seq, device)
            want_loss, want_grads = loss_and_grads(model, params, batch, TrainProfile(), "auto")
            opt = AdamWConfig(lr=constant(1e-3))
            step, _, st_specs = make_train_step(model, opt, TrainProfile())
            _, _, want_m = step(params, adamw_init(st_specs, device), batch)
            rules = train_rules(cfg)
            for shape in SHARDED_MESHES:
                mesh = sharded_mesh(shape, device)
                loss, grads, counts, plain = _sharded_grads(model, params, batch, mesh, rules)
                where = {}
                grad_rel = _tree_rel(grads, want_grads, where)
                del grads
                loss_rel = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
                sstep, specs, sst = make_train_step(model, opt, TrainProfile(), mesh=mesh,
                                                    rules=rules)
                _, _, m = sstep(tree_distribute(params, specs, mesh, rules),
                                adamw_init(sst, device, mesh, rules), batch)
                step_rel = {k: abs(float(m[k]) - float(want_m[k])) / abs(float(want_m[k]))
                            for k in ("loss", "grad_norm")}
                for k, v in counts.items():
                    launches[k] = launches.get(k, 0) + v
                rec = {"phase": "train_sharded_exact", "arch": arch, "family": cfg.family,
                       "ranks": SHARDED_W, "mesh": list(shape), "layers": cfg.n_layers,
                       "enc_layers": cfg.n_enc_layers if cfg.family == "encdec" else None,
                       "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
                       "head_dim": cfg.head_dim, "batch": batch_n, "seq": seq,
                       "dtype": "float32", "loss_sharded": float(loss),
                       "loss_one_device": float(want_loss), "loss_rel": loss_rel,
                       "grad_max_rel": grad_rel, "grad_worst_leaf": where.get("worst_leaf"),
                       "step_rel": step_rel,
                       "tolerance": f"loss 1e-5, each gradient leaf {TRAIN_EXACT_RTOL} of its "
                                    "max-abs, the step's loss 1e-5 and grad_norm 1e-4",
                       "kernel_launches_in_block_maps": counts, "plain_calls": plain}
                emit(rec)
                if loss_rel > 1e-5 or grad_rel > TRAIN_EXACT_RTOL or step_rel["loss"] > 1e-5 \
                        or step_rel["grad_norm"] > 1e-4:
                    raise AssertionError(f"train_sharded_exact {arch} {shape}: the sharded "
                                         f"step parts from the one-device step: {rec}")
                if device == "cuda" and (not all(counts.values()) or any(plain.values())):
                    raise AssertionError(f"train_sharded_exact {arch} {shape}: a kernel of "
                                         f"the path did not launch, or a plain version ran: "
                                         f"{rec}")
            if cfg.family == "moe":
                _moe_ep_check(cfg, params, device)
            del model, params, want_grads
            torch.cuda.empty_cache()
    return launches


def _moe_ep_check(cfg, params, device):
    """Layer 0's experts through apply_moe_ep on a (1, SHARDED_W) mesh
    against apply_moe, both differentiated through sum(y * r): the
    reference's tolerances (tests/test_multidevice.py:44-46)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.core.distributed import distribute, tree_distribute
    from repro_torch.launch import train_rules
    from repro_torch.models.layers import Sharder
    from repro_torch.models.moe import apply_moe, apply_moe_ep, moe_specs

    p = params["blocks"][0][0]["moe"]
    gen = torch.Generator(device=device).manual_seed(3)
    x = torch.randn(*SHARDED_MOE_X, cfg.d_model, generator=gen, device=device)
    r = torch.randn(*SHARDED_MOE_X, cfg.d_model, generator=gen, device=device)
    pr = {k: v.detach().clone().requires_grad_() for k, v in p.items()}
    xr = x.clone().requires_grad_()
    want, _ = apply_moe(cfg, pr, xr)
    (want * r).sum().backward()
    mesh = sharded_mesh((1, SHARDED_W), device)
    rules = train_rules(cfg)
    pd = {k: v.requires_grad_() for k, v in
          tree_distribute({k: v.detach() for k, v in p.items()}, moe_specs(cfg), mesh,
                          rules).items()}
    xd = distribute(x, mesh, rules.placements(("batch", "seq", None), x.shape, mesh))
    xd.requires_grad_()
    with implicit_replication():
        got, _ = apply_moe_ep(cfg, pd, xd, Sharder(mesh, rules))
        (got * distribute(r, mesh, got.placements)).sum().backward()
    excess = {"y": _allclose_excess(got.full_tensor(), want, 2e-4, 2e-4),
              "x": _allclose_excess(xd.grad.full_tensor(), xr.grad, 5e-3, 5e-3),
              **{k: _allclose_excess(pd[k].grad.full_tensor(), pr[k].grad, 5e-3, 5e-3)
                 for k in pr}}
    rec = {"phase": "train_sharded_exact", "check": "moe_expert_parallel", "arch": cfg.name,
           "mesh": [1, SHARDED_W], "tokens": list(SHARDED_MOE_X), "d_model": cfg.d_model,
           "n_experts": cfg.n_experts, "top_k": cfg.top_k, "capacity_factor": cfg.capacity_factor,
           "allclose_excess": excess,
           "tolerance": "outputs rtol = atol = 2e-4, gradients 5e-3 (allclose)"}
    emit(rec)
    if max(excess.values()) > 0:
        raise AssertionError(f"train_sharded_exact: the expert-parallel block parts from the "
                             f"einsum path: {rec}")


def train_sharded_phase(smi, device="cuda", smoke=False, arch="llama3.2-1b"):
    """``arch``'s SHARDED_CELLS cell through TrainerLoop on a (1, SHARDED_W)
    mesh, the train cell's configuration at full width (smoke: the smoke
    config, B 2 x 32): bf16 params, remat, f32 moments, train_rules (heads,
    ffn, lru columns, SSM heads and vocab over "model"), 6 steps, each block
    in its block map; llama3.2-1b's cell ends with the final save (the
    checkpoint directory a TemporaryDirectory, ckpt_every past the last
    step, gathered whole), the others save nothing. The collectives of step
    1 are counted (CollectiveCounter: calls and input bytes by op) and so
    are its DTensor op dispatches and redistributions (DispatchCounter); the
    counters slow that step, which the p50 of steps 2-5 leaves out. Where
    the card runs out of memory at the cell's sequence length, the next of
    ``seqs`` is tried and the cut listed. Shows the one-device cell of the
    same call (ONE_DEVICE_TRAIN) beside it. Returns the launches of the run
    of the family's kernels."""
    import gc

    cell = SHARDED_CELLS[arch]
    reduced = list(cell.get("reduced", []))
    seqs = (32,) if smoke else cell["seqs"]
    for i, seq in enumerate(seqs):
        try:
            return _train_sharded_cell(smi, device, smoke, arch, cell,
                                       2 if smoke else cell["batch"], seq, reduced)
        except torch.cuda.OutOfMemoryError as e:
            if i + 1 == len(seqs):
                raise
            reduced.append(f"seq {seq} -> {seqs[i + 1]} (the sharded step ran out of memory "
                           f"at {seq}: {str(e).splitlines()[0][:160]})")
            emit({"phase": "train_sharded", "arch": arch, "out_of_memory_at_seq": seq})
        gc.collect()
        torch.cuda.empty_cache()


def _train_sharded_cell(smi, device, smoke, arch, cell, batch, seq, reduced):
    from repro_torch import kernels
    from repro_torch.core.distributed import CollectiveCounter, DispatchCounter
    from repro_torch.launch.dryrun import argument_bytes
    from repro_torch.runtime import RunConfig, TrainerLoop

    torch.cuda.empty_cache()
    counter, dispatch = CollectiveCounter(), DispatchCounter()
    with process_group(device), tempfile.TemporaryDirectory() as ckpt_dir:
        run = RunConfig(arch=arch, smoke=smoke, steps=cell["steps"], batch=batch, seq=seq,
                        peak_lr=3e-4, warmup=2, ckpt_dir=ckpt_dir,
                        ckpt_every=10 * cell["steps"], log_every=1, remat=True, device=device,
                        model_axis=SHARDED_W, final_save=cell["final_save"])
        loop = TrainerLoop(run)
        step_fn, calls, args_bytes = loop.step_fn, [], {}

        def counted(*args):
            calls.append(None)
            if len(calls) != 2:
                return step_fn(*args)
            args_bytes.update(argument_bytes(args, ("params", "moments", "inputs")))
            with counter, dispatch:
                return step_fn(*args)

        loop.step_fn = counted
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        plain = {**attn_plain_calls(), **plain_twin_calls()}
        out = loop.run_loop()
        counts = kernels.launch_counts()
        plain = {k: v - plain[k] for k, v in {**attn_plain_calls(),
                                              **plain_twin_calls()}.items()}
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
        mesh, cfg, last_save = list(loop.mesh.shape), loop.cfg, loop.last_save
        del loop
    need = TRAIN_KERNELS.get(cfg.family, TRAIN_ATTN_KERNELS)
    hist = out["history"]
    n = len(hist)
    losses = [h["loss"] for h in hist]
    p50 = statistics.median(h["time_s"] for h in hist[2:6])
    one = ONE_DEVICE_TRAIN.get(arch, {})
    rec = {"phase": "train_sharded", "nvidia_smi": smi, "arch": arch,
           "source": cell["source"], "ranks": SHARDED_W, "mesh": mesh,
           "rules": "train_rules", "layers": cfg.n_layers, "d_model": cfg.d_model,
           "heads": [cfg.n_heads, cfg.n_kv_heads], "vocab": cfg.vocab, "dtype": cfg.dtype,
           "remat": True, "moments": "f32", "batch": batch, "seq": seq,
           "reduced": reduced, "steps": n, "step_ms_p50_steps_2_5": p50 * 1e3,
           "step_ms": [h["time_s"] * 1e3 for h in hist],
           "rank_step_ms": [[t * 1e3 for t in h["rank_times_s"]] for h in hist],
           "tokens_per_s": batch * seq / p50,
           "peak_memory_bytes_per_rank": [peak], "losses": losses,
           "one_device": {"step_ms_p50": one.get("step_ms_p50"),
                          "peak_memory_bytes": one.get("peak_memory_bytes"),
                          "batch": one.get("batch"), "seq": one.get("seq")},
           "sharded_over_one_device": (p50 * 1e3 / one["step_ms_p50"]
                                       if one.get("seq") == seq else None),
           "collectives_step_1": {"calls": counter.calls, "input_bytes": counter.bytes},
           "dtensor_step_1": {"op_dispatches": dispatch.dtensor_ops,
                              "redistributions": dispatch.redistributions},
           "launches_per_step": {k: counts[k] / n for k in need},
           "plain_calls": plain, "final_save": last_save,
           "note": "one rank: the collectives run on a one-rank NCCL group and move no "
                   "bytes between ranks"}
    emit(rec)
    if arch == "llama3.2-1b":
        DRYRUN_CARD["train"] = {"batch": batch, "seq": seq, "step_ms_p50": p50 * 1e3,
                                "argument_bytes_by_group": args_bytes}
    if not all(math.isfinite(x) for x in losses) or n != cell["steps"]:
        raise AssertionError(f"train_sharded {arch}: {n} steps, losses {losses}")
    if device == "cuda" and (not all(counts[k] for k in need) or any(plain.values())):
        raise AssertionError(f"train_sharded {arch}: a kernel of the path did not launch, or a "
                             f"plain version ran: {counts}, {plain}")
    torch.cuda.empty_cache()
    return {k: counts[k] for k in need}


# =====================================================================================
# phases: serving on a mesh (the kv_seq-sharded decode's kernel rows, serve_sharded_exact,
# serve_sharded)
# =====================================================================================
SEQSHARD_SLICES = 4  # the "model" ranks the kernels phase emulates on one card
# (name, B, Hq, Hkv, S, D): llama3.2-1b's decode shape, then D 128, kimi-k2's
# D 112 heads and recurrentgemma-2b's D 256 MQA group at S 8192
SEQSHARD_CASES = (("llama3.2-1b", 8, 32, 8, 32768, 64), ("d128", 8, 32, 8, 8192, 128),
                  ("kimi-k2_d112", 8, 64, 8, 8192, 112), ("recurrentgemma-2b_d256", 8, 10, 1,
                                                                          8192, 256))
# (D, Hq, Hkv): flash_decode's lse rows, S 1024
LSE_CASES = ((64, 8, 2), (112, 64, 8), (128, 32, 8), (256, 10, 1))
SERVE_SHARDED_STEPS = 8  # serve_sharded_exact's greedy steps after the prefill
SERVE_SHARDED_PROMPT = (2, 64)  # B x T of serve_sharded_exact's prompts
SERVE_KERNELS = {"dense": ("flash_attention", "flash_decode"),
                 "moe": ("flash_attention", "flash_decode"),
                 "ssm": ("ssd_scan",), "hybrid": ("flash_attention", "flash_decode", "rglru_scan"),
                 "encdec": ("flash_attention", "flash_decode"),
                 "vlm": ("flash_attention", "flash_decode")}
# serve_sharded's llama3.2-1b dense-cache cell: B, prompt, cache slots, new tokens
SERVE_SHARDED_GEN = dict(batch=8, prompt=4096, slots=32768, new=32,
                         source="hf:meta-llama/Llama-3.2-1B")
PLAIN_SERVE = ("attention_torch", "decode_attention_torch", "paged_decode_attention_torch",
               "paged_prefill_chunk_torch", "paged_decode_attention_quant_torch",
               "paged_prefill_chunk_quant_torch", "ssd_torch", "rglru_torch")


@contextlib.contextmanager
def plain_serve_calls():
    """Counts, while entered, the calls ``kernels.ops`` makes of the serving
    kernels' plain versions (the dict it yields, by name)."""
    from repro_torch.kernels import ops

    calls, saved = {n: 0 for n in PLAIN_SERVE}, {n: getattr(ops, n) for n in PLAIN_SERVE}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    for n, fn in saved.items():
        setattr(ops, n, counted(n, fn))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


def _bf16_ulp(x):
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x.float()), e - 8)


def _merge_close(got, want, dtype, slack=None):
    """(ok, max |got - want|): f32 allclose rtol = atol = 2e-5; bf16 within one
    bf16 ulp of want + BF16_ATOL + ``slack`` (elementwise: the merged
    slices' own rounding, ``_merge_slack``), elementwise."""
    err = float((got.float() - want.float()).abs().max())
    if dtype == torch.float32:
        return bool(torch.allclose(got.float(), want.float(), rtol=2e-5, atol=2e-5)), err
    bound = _bf16_ulp(want) + BF16_ATOL + (0.0 if slack is None else slack)
    return float(((got.float() - want.float()).abs() - bound).max()) <= 0.0, err


def _merge_slack(outs, lses):
    """sum_r w_r ulp(o_r) with w_r = exp(lse_r - M) / sum exp(lse - M): the
    most the merge can inherit from each slice's output rounded to bf16
    before it (one ulp of each, twice the half ulp a rounding costs)."""
    lse = torch.stack([x.float() for x in lses])
    m = lse.amax(dim=0)
    w = torch.where(torch.isneginf(lse), torch.zeros_like(lse), torch.exp(lse - m))
    w = w / w.sum(dim=0).clamp_min(1e-30)
    return sum(w_r[..., None] * _bf16_ulp(o) for w_r, o in zip(w, outs))


def _lse_close(got, want):
    """The same -inf rows, finite rows within 1e-5 + 1e-5 |want|."""
    dead = torch.isneginf(want)
    if not torch.equal(torch.isneginf(got), dead):
        return False, float("inf")
    err = float((got[~dead] - want[~dead]).abs().max()) if bool((~dead).any()) else 0.0
    return bool(torch.allclose(got[~dead], want[~dead], rtol=1e-5, atol=1e-5)), err


def seqshard_checks(bw, g):
    """The kv_seq-sharded decode's local step on the card:
    ``flash_decode`` with its lse output (the combine's compile-time
    epilogue) against ``decode_attention_torch(return_lse=True)`` at every
    head dim, f32 and bf16, at a local position inside the slice, one before
    it (negative: zeros, lse -inf) and one past it (every slot live), and its
    output bit-equal to the decode without lse (the serving path reads as
    before); then SEQSHARD_SLICES slices of each SEQSHARD_CASES cache, each
    attended by the kernel at its local position with lse and merged
    (``core.distributed.merge_lse_parts``, the ranks' merge emulated) against
    the unsplit kernel and the plain version, at pos S - 1 and at 5 S / 8
    (the last slice dead; bf16 within one ulp + BF16_ATOL + the slices' own
    rounding, ``_merge_slack``), timed (check_and_time: the emulated step of
    all slices) with the device ms of one slice's step (slice 0, every slot
    live) and of the whole cache's.
    Returns the records by case."""
    from repro_torch.core.distributed import merge_lse_parts
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for d, hq, hkv in LSE_CASES:
            s_len = 1024
            q = torch.randn(4, hq, 1, d, generator=g, device="cuda").to(dtype)
            kc = torch.randn(4, hkv, s_len, d, generator=g, device="cuda").to(dtype)
            vc = torch.randn(4, hkv, s_len, d, generator=g, device="cuda").to(dtype)
            worst, ok, same = {"out": 0.0, "lse": 0.0}, True, True
            for pos, off in ((700, 0), (100, 512), (2000, 0), (1800, 1024)):
                pos_t = torch.tensor([pos], dtype=torch.int32, device="cuda")
                lse = torch.empty(4, hq, 1, dtype=torch.float32, device="cuda")
                got = fa.flash_decode(q, kc, vc, pos_t, key_offset=off, lse=lse)
                plain = fa.decode_attention_torch(q, kc, vc, pos, key_offset=off,
                                                  return_lse=True)
                good_o, err_o = _merge_close(got, plain[0], dtype)
                good_l, err_l = _lse_close(lse, plain[1])
                bare = fa.flash_decode(q, kc, vc, pos_t, key_offset=off)
                same = same and torch.equal(bare, got)
                ok = ok and good_o and good_l
                worst = {"out": max(worst["out"], err_o), "lse": max(worst["lse"], err_l)}
            rec = {"phase": "kernels", "kernel": "flash_decode", "check": "lse", "dtype": name,
                   "B": 4, "Hq": hq, "Hkv": hkv, "S": s_len, "D": d,
                   "positions_and_offsets": [[700, 0], [100, 512], [2000, 0], [1800, 1024]],
                   "max_abs_err": worst, "out_bit_equal_without_lse": same, "ok": ok and same,
                   "tolerance": "out as the f32 / bf16 rule; lse 1e-5 + 1e-5 |lse|, -inf rows "
                                "equal"}
            emit(rec)
            if not rec["ok"]:
                raise AssertionError(f"flash_decode's lse output disagrees: {rec}")
    for case, b, hq, hkv, s_len, d in SEQSHARD_CASES:
        for dtype in ((torch.float32, torch.bfloat16) if case == "llama3.2-1b"
                      else (torch.bfloat16,)):
            esz = torch.tensor([], dtype=dtype).element_size()
            q = torch.randn(b, hq, 1, d, generator=g, device="cuda").to(dtype)
            kc = torch.randn(b, hkv, s_len, d, generator=g, device="cuda").to(dtype)
            vc = torch.randn(b, hkv, s_len, d, generator=g, device="cuda").to(dtype)
            s_loc = s_len // SEQSHARD_SLICES
            ks = [kc[:, :, r * s_loc:(r + 1) * s_loc].contiguous() for r in range(SEQSHARD_SLICES)]
            vs = [vc[:, :, r * s_loc:(r + 1) * s_loc].contiguous() for r in range(SEQSHARD_SLICES)]
            for pos in (s_len - 1, 5 * s_len // 8):
                pos_t = torch.tensor([pos], dtype=torch.int32, device="cuda")

                def parts():
                    return [ops.decode_attention(q, ks[r], vs[r], pos_t, key_offset=r * s_loc,
                                                 return_lse=True, impl="cuda")
                            for r in range(SEQSHARD_SLICES)]

                def merged():
                    got = parts()
                    return merge_lse_parts([p[0] for p in got], [p[1] for p in got])

                first = parts()
                slack = (_merge_slack([p[0] for p in first], [p[1] for p in first])
                         if dtype == torch.bfloat16 else None)
                whole = fa.flash_decode(q, kc, vc, pos_t)
                good_w, err_w = _merge_close(merged(), whole, dtype, slack)
                n_live = pos + 1
                rec = check_and_time(
                    "flash_decode", dtype, merged,
                    lambda: fa.decode_attention_torch(q, kc, vc, pos), None,
                    2 * q.numel() * esz + 2 * b * hkv * n_live * d * esz,
                    4 * b * hq * d * n_live, bw,
                    {"check": "seq_sharded_merge", "case": case, "slices": SEQSHARD_SLICES,
                     "B": b, "Hq": hq, "Hkv": hkv, "S": s_len, "D": d, "pos": pos},
                    tolerance=lambda got, want: (
                        _merge_close(got, want, dtype, slack)[0],
                        f"f32 allclose 2e-5; bf16 one ulp of the plain output + {BF16_ATOL} + "
                        "sum_r w_r ulp(o_r) (each slice's output o_r rounds to bf16 before "
                        "the merge, w_r its weight)"),
                    phase="kernels")
                slice_ms = device_ms_per_call(
                    lambda: ops.decode_attention(q, ks[0], vs[0], pos_t, return_lse=True,
                                                 impl="cuda"), n=50)
                whole_ms = device_ms_per_call(lambda: fa.flash_decode(q, kc, vc, pos_t), n=50)
                slice_bytes = 2 * b * hkv * s_loc * d * esz  # slice 0: every slot live
                whole_bytes = 2 * b * hkv * n_live * d * esz
                rec2 = {"phase": "kernels", "kernel": "flash_decode", "check": "seq_sharded_times",
                        "case": case, "dtype": str(dtype).split(".")[1], "pos": pos,
                        "merged_vs_unsplit_kernel_max_abs_err": err_w,
                        "merged_vs_unsplit_ok": good_w,
                        "slice_device_ms": slice_ms, "whole_device_ms": whole_ms,
                        "slice_bound_ms": slice_bytes / NOMINAL_BW * 1e3,
                        "whole_bound_ms": whole_bytes / NOMINAL_BW * 1e3,
                        "whole_bytes": whole_bytes,
                        "merge_bytes_per_rank": b * hq * (d + 2) * 4}
                emit(rec2)
                if not good_w:
                    raise AssertionError(f"the merged slices part from the unsplit kernel: {rec2}")
                out[f"{case}:{rec['dtype']}:{pos}"] = {**rec, **rec2}
            del q, kc, vc, ks, vs
            torch.cuda.empty_cache()
    return out


def serve_sharded_exact_phase(device="cuda", smoke=False):
    """Serving on the (SHARDED_W, 1) mesh (one NCCL rank on the card) against
    the one-device path, f32 with TF32 off: every family at SHARDED_EXACT's
    cut (smoke: the smoke configs), seeded weights with the attention
    projections rescaled to their fan-in and the vision gate
    SHARDED_VISION_GATE, ``serve_rules`` (with FSDP on "embed" for kimi-k2,
    ``needs_fsdp_for_serving``), make_prefill(mesh, rules) over B 2 x 64 and
    SERVE_SHARDED_STEPS greedy steps: tokens identical, logits' drift
    printed; then the paged engine (chunked prefill, page 16) for qwen2-0.5b
    and kimi-k2 at 2 layers (kimi at MOE_EXACT_WIDTH, capacity factor 8): the
    mesh engine's streams equal the one-device engine's. The family's
    kernels must launch inside the serving maps and no plain version run.
    Returns the launches in the mesh runs, by kernel."""
    from repro_torch import kernels
    from repro_torch.launch import needs_fsdp_for_serving, serve_rules
    from repro_torch.models import build_model, get_config
    from repro_torch.serving import distribute_params

    launches = {}
    b, t = SERVE_SHARDED_PROMPT
    t = 16 if smoke else t
    with process_group(device):
        mesh = sharded_mesh((SHARDED_W, 1), device)
        for arch, (cut, _, _) in SHARDED_EXACT.items():
            cfg = dataclasses.replace(get_config(arch, smoke=smoke), dtype="float32")
            if arch == "kimi-k2-1t-a32b":
                cfg = dataclasses.replace(cfg, capacity_factor=8.0)
            if not smoke:
                cfg = dataclasses.replace(cfg, **cut)
            model = build_model(cfg, device=device)
            params = condition_attention(
                cfg, model.init_params(torch.Generator(device=device).manual_seed(0)))
            if cfg.family == "vlm":
                for grp in params["blocks"][0]:
                    grp["gate"].fill_(SHARDED_VISION_GATE)
            prompts, bi = serve_inputs(cfg, b, t, device)
            want, (_, want_last), _, _ = generate(model, params, prompts, SERVE_SHARDED_STEPS,
                                                  batch_inputs=bi)
            rules = serve_rules(cfg, fsdp_params=needs_fsdp_for_serving(get_config(arch)))
            pd = distribute_params(model, params, mesh, rules)
            kernels.reset_launch_counts()
            with plain_serve_calls() as plain:
                got, (_, last), _, _ = generate(model, pd, prompts, SERVE_SHARDED_STEPS,
                                                batch_inputs=bi, mesh=mesh, rules=rules)
            counts = kernels.launch_counts()
            need = SERVE_KERNELS[cfg.family]
            for k in need:
                launches[k] = launches.get(k, 0) + counts[k]
            rec = {"phase": "serve_sharded_exact", "arch": arch, "family": cfg.family,
                   "mesh": [SHARDED_W, 1], "rules": "serve_rules", "fsdp_params":
                   needs_fsdp_for_serving(get_config(arch)), "layers": cfg.n_layers,
                   "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
                   "head_dim": cfg.head_dim, "batch": b, "prompt": t,
                   "new_tokens": SERVE_SHARDED_STEPS, "dtype": "float32",
                   "tokens_equal": got == want,
                   "last_logits_max_abs_diff": float((last - want_last).abs().max()),
                   "kernel_launches_in_serving_maps": {k: counts[k] for k in need},
                   "plain_calls": {k: v for k, v in plain.items() if v}}
            emit(rec)
            if got != want:
                raise AssertionError(f"serve_sharded_exact {arch}: the mesh's tokens differ: {rec}")
            if device == "cuda" and (not all(counts[k] for k in need) or any(plain.values())):
                raise AssertionError(f"serve_sharded_exact {arch}: a kernel of the path did not "
                                     f"launch, or a plain version ran: {rec}")
            del model, params, pd
            torch.cuda.empty_cache() if device == "cuda" else None
        for arch in ("qwen2-0.5b", "kimi-k2-1t-a32b"):
            cfg = dataclasses.replace(get_config(arch, smoke=smoke), dtype="float32")
            if not smoke:
                cfg = dataclasses.replace(cfg, n_layers=2, **MOE_EXACT_WIDTH.get(arch, {}))
            if cfg.family == "moe":
                cfg = dataclasses.replace(cfg, capacity_factor=8.0)
            model = build_model(cfg, device=device)
            params = model.init_params(torch.Generator(device=device).manual_seed(0))
            prompts = exact_requests(cfg.vocab)
            jobs = [(p, dict(max_new_tokens=SERVE_SHARDED_STEPS), i) for i, p in enumerate(prompts)]
            config = exact_config(58, chunked_prefill=True, chunk_tokens=128)
            want, _, _, _, _ = run_jobs(model, params, config, device, jobs)
            rules = serve_rules(cfg, fsdp_params=needs_fsdp_for_serving(get_config(arch)))
            with plain_serve_calls() as plain:
                got, m, counts, wall, _ = run_jobs(model, params, config, device, jobs,
                                                   engine_kw=dict(mesh=mesh, rules=rules))
            need = DENSE_PATH
            for k in need:
                launches[k] = launches.get(k, 0) + counts[k]
            rec = {"phase": "serve_sharded_exact", "arch": arch, "engine": "paged",
                   "mesh": [SHARDED_W, 1], "rules": "serve_rules", "layers": cfg.n_layers,
                   "d_model": cfg.d_model, "requests": len(prompts),
                   "new_tokens": SERVE_SHARDED_STEPS, "dtype": "float32",
                   "streams_equal": _tokens_of(got) == _tokens_of(want),
                   "preemptions": m["preemptions"], "wall_s": wall,
                   "kernel_launches_in_serving_maps": {k: counts[k] for k in need},
                   "plain_calls": {k: v for k, v in plain.items() if v}}
            emit(rec)
            if _tokens_of(got) != _tokens_of(want):
                raise AssertionError(f"serve_sharded_exact {arch}: the mesh engine's streams "
                                     f"differ: {rec}")
            if device == "cuda" and (not all(counts[k] for k in need) or any(plain.values())):
                raise AssertionError(f"serve_sharded_exact {arch} (paged): a kernel of the path "
                                     f"did not launch, or a plain version ran: {rec}")
            del model, params
            torch.cuda.empty_cache() if device == "cuda" else None
    return launches


def serve_inputs(cfg, batch, prompt, device, seed=5):
    """Seeded prompts (batch, prompt) and, for whisper and the vision model,
    the stub frontend's input (``cross_inputs``; None for the other
    families)."""
    if cfg.family in ("encdec", "vlm"):
        return cross_inputs(cfg, dict(batch=batch, prompt=prompt), device, seed)
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, cfg.vocab, (batch, prompt), generator=g, device=device), None


def _busy_union_us(spans):
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def device_idle_share(fn):
    """The device's idle share of the span torch.profiler traces around
    ``fn()`` (1 - the union of its kernels' times over the span), or None
    where the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    dev = [(e.time_range.start, e.time_range.end) for e in events
           if getattr(e, "device_type", None) == cuda and not e.name.startswith("ProfilerStep")]
    if not dev or not events:
        return None
    span = max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
    return 1.0 - _busy_union_us(dev) / span if span else None


def _counted_once(fn, at, counters):
    """``fn`` whose ``at``-th call (from 1) runs inside ``counters``."""
    calls = []

    def wrapper(*a, **kw):
        calls.append(None)
        if len(calls) != at:
            return fn(*a, **kw)
        with contextlib.ExitStack() as st:
            for c in counters:
                st.enter_context(c)
            return fn(*a, **kw)
    return wrapper


def serve_sharded_phase(smi, device="cuda", smoke=False):
    """Serving through the (SHARDED_W, 1) mesh beside the one-device path of
    the same call, in the config dtype (bfloat16), runs alternating (one
    device, mesh, mesh, one device): the ``serve`` workload (qwen2-0.5b at
    full size, 16 requests, 32 new tokens) through ``ServeEngine(mesh=,
    rules=serve_rules)``, and llama3.2-1b's dense-cache generate at full
    width (SERVE_SHARDED_GEN: B 8, a 4096-token prompt in a 32768-slot
    cache, 32 new tokens) through make_prefill / make_serve_step(mesh,
    rules). Tokens identical to the one-device runs; step p50 over the
    one-device step's, the device's idle share over 4 mesh steps
    (torch.profiler), and one step's DTensor dispatches and collectives
    (DispatchCounter, CollectiveCounter). Returns the launches in the mesh
    runs."""
    from repro_torch import kernels
    from repro_torch.core.distributed import CollectiveCounter, DispatchCounter
    from repro_torch.launch import serve_rules
    from repro_torch.launch.dryrun import argument_bytes
    from repro_torch.serving import distribute_params
    from repro_torch.serving.engine import ServeEngine

    launches = {}
    w = serve_setup(smoke=smoke, device=device)
    with process_group(device):
        mesh = sharded_mesh((SHARDED_W, 1), device)
        rules = serve_rules(w.cfg)
        runs = {"one_device": [], "mesh": []}
        dispatch, coll = DispatchCounter(), CollectiveCounter()
        for kind in ("one_device", "mesh", "mesh", "one_device"):
            eng = (w.engine() if kind == "one_device" else
                   ServeEngine(w.model, w.params, w.config, device=device, mesh=mesh,
                               rules=rules))
            if kind == "mesh" and not runs["mesh"]:
                eng._step = _counted_once(eng._step, 5, (dispatch, coll))
            kernels.reset_launch_counts()
            eng.run(w.requests())
            m = eng.metrics()
            counts = kernels.launch_counts()
            if kind == "mesh":
                for k in DENSE_PATH:
                    launches[k] = launches.get(k, 0) + counts[k]
            runs[kind].append({"tokens": [eng.results[i].generated for i in range(len(w.prompts))],
                               **{k: m[k] for k in ("step_ms_p50", "tokens_per_s", "chunk_ms_p50",
                                                    "ttft_s_p95", "decode_steps")},
                               "launches": {k: counts[k] for k in DENSE_PATH}})
        same = all(r["tokens"] == runs["one_device"][0]["tokens"]
                   for r in runs["mesh"] + runs["one_device"])
        one = statistics.median(r["step_ms_p50"] for r in runs["one_device"])
        shd = statistics.median(r["step_ms_p50"] for r in runs["mesh"])
        rec = {"phase": "serve_sharded", "cell": "serve", "nvidia_smi": smi, "model": w.cfg.name,
               "dtype": w.cfg.dtype, "mesh": [SHARDED_W, 1], "rules": "serve_rules",
               "requests": len(w.prompts), "new_tokens": w.n_new, "tokens_equal": same,
               "runs": {k: [{kk: vv for kk, vv in r.items() if kk != "tokens"} for r in v]
                        for k, v in runs.items()},
               "step_ms_p50_one_device": one, "step_ms_p50_mesh": shd,
               "mesh_over_one_device": shd / one,
               "dtensor_step": {"op_dispatches": dispatch.dtensor_ops,
                                "redistributions": dispatch.redistributions},
               "collectives_step": {"calls": coll.calls, "input_bytes": coll.bytes},
               "note": "one rank: the collectives run on a one-rank NCCL group"}
        emit(rec)
        if not same:
            raise AssertionError(f"serve_sharded: the mesh engine's tokens differ: {rec}")
        if device == "cuda" and not all(runs["mesh"][0]["launches"].values()):
            raise AssertionError(f"serve_sharded: a kernel of the path did not launch: {rec}")
        del w
        torch.cuda.empty_cache() if device == "cuda" else None
        gen = SERVE_SHARDED_GEN
        cfg, model, params = generate_model("llama3.2-1b", "bfloat16", None, smoke, device)
        b, s, slots, n_new = ((2, 16, 32, 8) if smoke else
                              (gen["batch"], gen["prompt"], gen["slots"], gen["new"]))
        prompts = torch.tensor(np.random.default_rng(6).integers(0, cfg.vocab, size=(b, s)),
                               device=device)
        rules = serve_rules(cfg)
        pd = distribute_params(model, params, mesh, rules)
        res = {"one_device": [], "mesh": []}
        idle, dispatch, coll = None, DispatchCounter(), CollectiveCounter()
        for kind in ("one_device", "mesh", "mesh", "one_device"):
            on = kind == "mesh"
            kernels.reset_launch_counts()
            st = []
            toks, _, _, steps = generate(model, pd if on else params, prompts, n_new,
                                         mesh=mesh if on else None, rules=rules if on else None,
                                         slots=slots, state=st)
            step, caches, nxt, pos = st
            if on and "decode" not in DRYRUN_CARD:
                DRYRUN_CARD["decode"] = {
                    "batch": b, "seq": slots, "argument_bytes_by_group": argument_bytes(
                        (pd, caches, nxt, pos), ("params", "caches", "inputs", "inputs"))}
            counts = kernels.launch_counts()
            res[kind].append({"tokens": toks, "step_ms_p50": statistics.median(steps) * 1e3,
                              "launches": {k: counts[k] for k in GENERATE_PATH[:2]}})
            if on:
                for k in GENERATE_PATH[:2]:
                    launches[k] = launches.get(k, 0) + counts[k]
            if on and idle is None:
                with dispatch, coll:
                    step(pd, caches, nxt, pos)
                if device == "cuda":
                    idle = device_idle_share(lambda: [step(pd, caches, nxt, pos + 1 + i)
                                                      for i in range(4)])
            del caches
        same = all(r["tokens"] == res["one_device"][0]["tokens"]
                   for r in res["mesh"] + res["one_device"])
        one = statistics.median(r["step_ms_p50"] for r in res["one_device"])
        shd = statistics.median(r["step_ms_p50"] for r in res["mesh"])
        rec = {"phase": "serve_sharded", "cell": "generate", "nvidia_smi": smi,
               "model": cfg.name, "source": gen["source"], "dtype": cfg.dtype,
               "layers": cfg.n_layers, "d_model": cfg.d_model,
               "heads": [cfg.n_heads, cfg.n_kv_heads], "batch": b, "prompt": s,
               "cache_slots": slots, "new_tokens": n_new, "mesh": [SHARDED_W, 1],
               "rules": "serve_rules", "tokens_equal": same,
               "step_ms_p50_runs": {k: [r["step_ms_p50"] for r in v] for k, v in res.items()},
               "step_ms_p50_one_device": one, "step_ms_p50_mesh": shd,
               "mesh_over_one_device": shd / one, "device_idle_share_mesh_4_steps": idle,
               "dtensor_step": {"op_dispatches": dispatch.dtensor_ops,
                                "redistributions": dispatch.redistributions},
               "collectives_step": {"calls": coll.calls, "input_bytes": coll.bytes},
               "launches_mesh_run": res["mesh"][0]["launches"]}
        emit(rec)
        if not same:
            raise AssertionError(f"serve_sharded generate: the mesh's tokens differ: {rec}")
        if device == "cuda" and not all(res["mesh"][0]["launches"].values()):
            raise AssertionError(f"serve_sharded generate: a kernel did not launch: {rec}")
        del model, params, pd
        torch.cuda.empty_cache() if device == "cuda" else None
    return launches


# =====================================================================================
# phase: the dry run's cells beside the card's
# =====================================================================================
# the steps' argument bytes by group (rank 0's local tensors) and the cells'
# dims, written by train_sharded (llama3.2-1b) and serve_sharded's generate
DRYRUN_CARD = {}
DRYRUN_TIMEOUT = 240  # seconds for the dry run's subprocesses together


def train_model_flops(cost_keys, seq: int) -> float:
    """A dense train step's model flops from its traced flops by op: the
    plain attention (``kernels.flash_attention.attention_torch``) runs every
    T x T score block as a bmm, the masked ones too, where the card's
    kernels skip them; so its bmm flops count for the causal live share,
    (T + 1) / 2T, and the projections' mm flops whole. The dense model's
    only bmm are its attention's."""
    causal = (seq + 1) / (2 * seq)
    return sum(v * (causal if op == "bmm" else 1.0) for op, v in cost_keys.items())


def dryrun_phase(smi):
    """Three cells of the dry run, each in a subprocess on the host's CPU (no
    card: ``CUDA_VISIBLE_DEVICES`` empty), at once: llama3.2-1b train_4k on
    pod16x16 through the CLI (``--full``: traced at full depth, the probes'
    fit beside it), and the (1, 1) cells of the train_sharded and
    serve_sharded runs this script made on the card (DRYRUN_CARD). Their
    argument bytes by group must equal the card's; any failed cell, or a
    subprocess past DRYRUN_TIMEOUT, fails the phase."""
    tr, dec = DRYRUN_CARD["train"], DRYRUN_CARD["decode"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    base = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "llama3.2-1b", "--full"]
    with tempfile.TemporaryDirectory() as d:
        cmds = {
            "pod16x16": base + ["--shape", "train_4k", "--mesh", "single", "--out", d],
            "train_sharded": base + ["--shape", "train_4k", "--mesh-shape", "1x1", "--batch",
                                     str(tr["batch"]), "--seq", str(tr["seq"]), "--out", d],
            "serve_sharded": base + ["--shape", "decode_32k", "--mesh-shape", "1x1", "--batch",
                                     str(dec["batch"]), "--seq", str(dec["seq"]), "--out", d],
        }
        t0 = time.perf_counter()
        procs = {k: subprocess.Popen(c, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
                 for k, c in cmds.items()}
        logs, failed = {}, []
        for k, p in procs.items():
            try:
                logs[k], _ = p.communicate(timeout=max(DRYRUN_TIMEOUT - (time.perf_counter() - t0),
                                                       1))
            except subprocess.TimeoutExpired:
                p.kill()
                logs[k], _ = p.communicate()
            if p.returncode != 0:
                failed.append(k)
        wall = time.perf_counter() - t0
        if failed:
            raise AssertionError(f"dryrun: {failed} failed: "
                                 f"{ {k: logs[k][-2000:] for k in failed} }")
        cells = {k: json.loads(Path(d, name).read_text()) for k, name in (
            ("pod16x16", "llama3.2-1b__train_4k__pod16x16.json"),
            ("train_sharded", f"llama3.2-1b__train_4k_b{tr['batch']}_s{tr['seq']}__mesh1x1.json"),
            ("serve_sharded",
             f"llama3.2-1b__decode_32k_b{dec['batch']}_s{dec['seq']}__mesh1x1.json"))}
    keys = ("world", "seconds", "figures_from", "flops", "bytes_accessed", "memory",
            "argument_bytes_by_group", "collective_calls", "params_total")
    prod = cells["pod16x16"]
    emit({"phase": "dryrun", "cell": "llama3.2-1b__train_4k__pod16x16", "nvidia_smi": smi,
          "torch": torch.__version__, **{k: prod.get(k) for k in keys},
          "collectives": {op: v["count"] for op, v in prod["collectives"]["per_op"].items()},
          "moved_bytes_per_device": prod["collectives"]["moved_bytes_per_device"],
          "fit_over_full_trace_minus_1": prod["extrapolated"]["fit_over_full_trace_minus_1"],
          "wall_s": wall})
    rows = {}
    for name, card in (("train_sharded", tr), ("serve_sharded", dec)):
        cell = cells[name]
        want = card["argument_bytes_by_group"]
        got = cell["argument_bytes_by_group"]
        rows[name] = {"batch": card["batch"], "seq": card["seq"], "card": want, "dryrun": got,
                      "argument_size_in_bytes": cell["memory"]["argument_size_in_bytes"],
                      "card_sum": sum(want.values()), "trace_s": cell["seconds"]["trace"],
                      "equal": got == want
                      and cell["memory"]["argument_size_in_bytes"] == sum(want.values())}
    flops = cells["train_sharded"]["flops"]
    model_flops = train_model_flops(cells["train_sharded"]["cost_keys"], tr["seq"])
    mfu_rate = model_flops / (tr["step_ms_p50"] / 1e3)
    emit({"phase": "dryrun", "cell": "one_rank_cells", "nvidia_smi": smi, "rows": rows,
          "train_step_flops_traced": flops, "train_step_model_flops": model_flops,
          "train_sharded_step_ms_p50": tr["step_ms_p50"],
          "model_tflops_per_s": mfu_rate / 1e12,
          "peak_tflops_bf16": PEAK_FLOPS[torch.bfloat16] / 1e12,
          "mfu": mfu_rate / PEAK_FLOPS[torch.bfloat16],
          "note": "model flops over the card's step p50, a model-flops utilisation, not a "
                  "measured rate: the plain path's matmuls traced on the CPU (remat's "
                  "recompute included), its T x T attention products counted for the "
                  "causal half that is live, as the card's flash kernels skip the rest"})
    bad = [k for k, r in rows.items() if not r["equal"]]
    if bad:
        raise AssertionError(f"dryrun: argument bytes differ from the card's: "
                             f"{ {k: rows[k] for k in bad} }")
    return cells


# =====================================================================================
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: repro_torch not found next to this script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: _build.ptxas_report(name) for name in _build.SOURCES}
    new_bodies = {fn: rec for name in ("flash_attention", "paged_attention", "paper_suite",
                                       "quant_matmul", "ssd_scan", "rglru_scan",
                                       "flash_attention_bwd", "ssd_scan_bwd", "rglru_scan_bwd")
                  for fn, rec in ptxas[name].items()
                  if any(k in fn for k in ("flash_mma_kernel", "split_decode_kernel",
                                           "combine_splits_kernel", "matvec_kernel",
                                           "matvec_splits_kernel", "paged_chunk_mma_kernel",
                                           "qmm_stream_kernel", "qmm_mma_kernel",
                                           "qmm_fma_kernel", "qmm_sum_splits_kernel",
                                           "tinymatsum_static_kernel<float, (int)3, (int)3>",
                                           "tinymatsum_static_kernel<float, (int)8, (int)8>",
                                           "tinymatsum_static_kernel<__nv_bfloat16, (int)3",
                                           "tinymatsum_dynamic_kernel", "cb_kernel",
                                           "ssd_kernel", "rglru_kernel",
                                           "stencil3d_kernel", "sum3d_kernel",
                                           "dkdv_kernel", "dq_kernel", "delta_kernel",
                                           "pass_kernel", "lam_kernel", "::s_kernel<",
                                           "fold_kernel", "fold_da_kernel", "rglru_bwd_kernel"))}
    bw = copy_bandwidth()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "build_s": build_s, "built": sorted(_build.build_seconds),
          "copy_bw_bytes_per_s": bw, "nominal_bw_bytes_per_s": NOMINAL_BW,
          "ptxas": ptxas})
    emit({"phase": "device", "ptxas_new_bodies": new_bodies,
          "spills": sum(r.get("spill_stores", 0) + r.get("spill_loads", 0)
                        for r in new_bodies.values())})
    from repro_torch.kernels import matvec as mv
    from repro_torch.kernels import paged_attention as pa
    sms = pa.sm_count(torch.device("cuda"))
    for what, (pages, b, hkv, ps, d, group) in (
            ("paged decode at the serve shape (B 8, Hkv 2, 128 pages of 16, D 64)",
             (128, 8, 2, 16, 64, 7)),
            ("flash_decode over recurrentgemma-2b's ring (B 2, Hkv 1, 2048 slots, D 256, G 10)",
             (2048, 2, 1, 1, 256, 10)),
            ("flash_decode over qwen2-0.5b's generate cache (B 8, Hkv 2, 288 slots, D 64, G 7)",
             (288, 8, 2, 1, 64, 7))):
        splits, pps = pa.plan_decode_splits(pages, b, hkv, ps, d, sms)
        emit({"phase": "device", "split_plan": what, "sm_count": sms, "splits": splits,
              "pages_per_split": pps, "keys_per_split": pps * ps,
              "blocks": splits * b * hkv * -(-group // 8)})
    for what, (b, c) in (("bf16 paged chunk at the serve shape (B 1, C 128, Hq 14, Hkv 2, D 64)",
                          (1, 128)), ("bf16 paged chunk, C 5 at B 8", (8, 5))):
        splits = pa.plan_chunk_splits(b, 14, 2, c, 64, 128, 16, torch.bfloat16, sms)
        emit({"phase": "device", "split_plan": what, "sm_count": sms, "splits": splits,
              "blocks": splits * -(-c * 7 // 64) * 2 * b})
    for dt, esz in (("float32", 4), ("bfloat16", 2)):
        splits, per = mv.plan_matvec_left(16384, 16384, esz, sms)
        emit({"phase": "device", "split_plan": f"matvec_left 16384^2 {dt}", "sm_count": sms,
              "splits": splits, "cols_per_split": per,
              "blocks": splits * -(-16384 // (32 * 16 // esz))})
    from repro_torch.kernels import tinymatsum as tm
    for dt in (torch.float32, torch.bfloat16):
        o = torch.empty(8_000_000, 3, 3, dtype=dt, device="cuda")
        for static in (True, False):
            plan = tm.plan_for(o, o, o, static)
            emit({"phase": "device", "split_plan": f"tinymatsum_{'static' if static else 'dynamic'}"
                  f" N 8M 3x3 {str(dt).split('.')[1]}", "sm_count": sms, **vars(plan),
                  "smem": tm.stage_bytes(3, 3, o.element_size(), plan.bn)})
        del o
    from repro_torch.kernels import ssd_scan as ss
    for dt in (torch.float32, torch.bfloat16):
        for b in (2, 4):
            emit({"phase": "device", "split_plan": f"ssd_scan mamba2-780m B {b} "
                  f"{str(dt).split('.')[1]}", "sm_count": sms, "blocks": ss.grid_blocks(b, 48, 64),
                  "resident_blocks_per_sm": ss.blocks_per_sm(dt, 128, torch.device("cuda"))})
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels import stencil3d as st
    from repro_torch.kernels import sum3d as sm
    for dt in (torch.float32, torch.bfloat16):
        name, esz = str(dt).split(".")[1], torch.tensor([], dtype=dt).element_size()
        g = rs.GEOMETRY
        emit({"phase": "device", "split_plan": f"rglru_scan recurrentgemma-2b (2, *, 2560) {name}",
              "sm_count": sms, "grid": 2 * -(-2560 // g["columns"]),
              "ring_bytes": g["stages"] * 2 * g["steps"] * g["columns"] * esz, **g})
        for n3 in (PAPER_SIZES["reference"]["cube"], PAPER_SIZES["hbm"]["cube"]):
            x = torch.empty(n3, n3, n3, dtype=dt, device="cuda")
            plan = st.plan_for(x)
            emit({"phase": "device", "split_plan": f"stencil3d {n3}^3 {name}", "sm_count": sms,
                  "grid": [plan.tiles_k, plan.tiles_j, plan.runs], "blocks": plan.blocks,
                  "run": plan.run, "resident_blocks_per_sm":
                  st.stencil3d_blocks_per_sm(st.DTYPE_CODE[dt], x.device)})
            del x
        for n3 in (PAPER_SIZES["reference"]["cube"], PAPER_SIZES["hbm"]["cube"]):
            x = torch.empty(n3, n3, n3, dtype=dt, device="cuda")
            emit({"phase": "device", "split_plan": f"sum3d {n3}^3 {name}", "sm_count": sms,
                  "grid": sm.grid_for(x), "resident_blocks_per_sm":
                  sm.sum3d_blocks_per_sm(sm.DTYPE_CODE[dt], x.device)})
            del x
    t_phase = {}
    t0 = time.perf_counter()
    main_recs = kernel_phase(bw)
    bwd = bwd_checks(bw, torch.Generator(device="cuda").manual_seed(29))
    main_recs["flash_attention_bwd"] = bwd["llama3.2-1b"]  # the train phase's shape, bf16
    main_recs.update(scan_bwd_checks(torch.Generator(device="cuda").manual_seed(31)))
    seqshard = seqshard_checks(bw, torch.Generator(device="cuda").manual_seed(35))
    t_phase["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    paper_recs, paper_launches = paper_phase(bw)
    main_recs.update(paper_recs)
    t_phase["paper"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gen_launches = generate_phase()
    t_phase["generate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cross_launches, _ = generate_cross_phase(smi=smi)
    for k in CROSS_NEED:
        gen_launches[k] += cross_launches[k]
    emit({"phase": "cross_kernels", "nvidia_smi": smi, "rows": [
        {"name": name, "kernel": rec["kernel"], "dtype": rec["dtype"],
         "kernel_launches_generate_cross": cross_launches[rec["kernel"]],
         **{k: rec.get(k) for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "library_device_ms")}}
        for name, rec in ((k[6:], r) for k, r in main_recs.items() if k.startswith("cross:"))]})
    t_phase["generate_cross"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prompt = exact_requests(151936)[0]
    for layers, conditioned in ((2, False), (24, False), (24, True)):
        depth_sensitivity(prompt, layers, conditioned)
    engine_exact_phase(n_layers=2)
    engine_exact_phase(n_layers=24, conditioned=True)
    t_phase["engine_exact"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine_exact_spec_phase(n_layers=2)
    t_phase["engine_exact_spec"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine_exact_branch_phase(n_layers=2)
    t_phase["engine_exact_branch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine_exact_record_phase(n_layers=2)
    t_phase["engine_exact_record"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for kv in ("int8", "int4"):
        engine_exact_quant_phase(kv, n_layers=2)
    engine_exact_quant_phase("int8", n_layers=6, conditioned=True, n_new=8)
    t_phase["engine_exact_quant"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    workload = serve_setup()
    runs = [serve_phase(workload=workload) for _ in range(SERVE_RUNS)]
    serve = runs[0]
    emit({"phase": "serve_summary", "runs": SERVE_RUNS,
          **{k: [r[k] for r in runs] for k in ("tokens_per_s", "step_ms_p50", "chunk_ms_p50",
                                                "ttft_s_p95")},
          "step_ms_p50_median": statistics.median(r["step_ms_p50"] for r in runs)})
    t_phase["serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve_spec_phase(workload, serve_setup(kv_dtype="int8"), plain_tokens=serve["tokens"])
    t_phase["serve_spec"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve_branch_phase(workload, plain_serve=runs, smi=smi)
    t_phase["serve_branch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    autotune_phase(workload, plain_serve=runs, smi=smi)
    t_phase["autotune"] = time.perf_counter() - t0
    del workload
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serve_quant = serve_quant_phase(serve["kv_pool_bytes"])
    t_phase["serve_quant"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serve_models_phase(smi=smi)
    t_phase["serve_models"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine_exact_moe_phase()
    t_phase["engine_exact_moe"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serve_moe = serve_moe_phase(smi=smi)
    t_phase["serve_moe"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_exact_phase()
    t_phase["train_exact"] = time.perf_counter() - t0
    train_counts = {}
    for arch in TRAIN_CELLS:
        t0 = time.perf_counter()
        train_counts[arch] = train_phase(smi, arch=arch)
        t_phase[f"train:{arch}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for arch in ("llama3.2-1b", "mamba2-780m"):
        train_loop_phase(arch=arch)
    t_phase["train_loop"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sharded_exact = train_sharded_exact_phase()
    t_phase["train_sharded_exact"] = time.perf_counter() - t0
    sharded = {}
    for arch in SHARDED_CELLS:
        t0 = time.perf_counter()
        for k, v in train_sharded_phase(smi, arch=arch).items():
            sharded[k] = sharded.get(k, 0) + v
        t_phase[f"train_sharded:{arch}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve_sharded_exact = serve_sharded_exact_phase()
    t_phase["serve_sharded_exact"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve_sharded = serve_sharded_phase(smi)
    t_phase["serve_sharded"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dryrun_phase(smi)
    t_phase["dryrun"] = time.perf_counter() - t0
    emit({"phase": "seqshard_kernels", "nvidia_smi": smi,
          # row 7's local step of the kv_seq-sharded decode, and the launches
          # of every serving kernel inside the serving block maps
          "launches_serve_sharded": serve_sharded,
          "launches_serve_sharded_exact": serve_sharded_exact, "rows": [
              {"case": name, **{k: rec.get(k) for k in (
                  "dtype", "pos", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                  "slice_device_ms", "whole_device_ms", "slice_bound_ms", "whole_bound_ms",
                  "merged_vs_unsplit_kernel_max_abs_err", "merge_bytes_per_rank")}}
              for name, rec in seqshard.items()]})
    emit({"phase": "train_kernels", "nvidia_smi": smi,
          # rows 6, 8, 9, 14 and the scans' backward inside the block maps, on
          # each of the SHARDED_W ranks
          "launches_train_sharded": sharded, "launches_train_sharded_exact": sharded_exact,
          "rows": [
        {"case": name, "kernel": rec["kernel"], "dtype": rec["dtype"],
         "launches_train": {arch: c[rec["kernel"]] for arch, c in train_counts.items()},
         **{k: rec.get(k) for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "library_device_ms")}}
        for name, rec in [*bwd.items(), *((r["kernel"], r) for r in (
            main_recs["ssd_scan_bwd"], main_recs["rglru_scan_bwd"]))]]})
    launches = {**serve["launches"], **serve_quant["int8"]["launches"],
                **{k: paper_launches[k] for k in PAPER_PATH}, **gen_launches,
                **{k: sum(c[k] for c in train_counts.values())
                   for k in ("flash_attention_bwd", "ssd_scan_bwd", "rglru_scan_bwd")}}
    for k, v in sharded.items():  # the sharded training path's launches, on every rank
        launches[k] += v
    for counts in (serve_sharded_exact, serve_sharded):  # the serving maps' launches
        for k, v in counts.items():
            launches[k] += v
    # the D 112 rows: kernel numbers from the kernels phase, launches from
    # kimi-k2's serve_moe run (the dense-cache rows 6-7 do not run there)
    kimi = serve_moe["kimi-k2-1t-a32b"]["launches"]
    emit({"phase": "d112_kernels", "config": "kimi-k2-1t-a32b", "nvidia_smi": smi, "rows": [
        {"name": name, "launches_serve_moe": kimi.get(name.replace("_int4", "")),
         **{k: rec.get(k) for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "library_device_ms")}}
        for name, rec in ((k[5:], r) for k, r in main_recs.items() if k.startswith("d112:"))]})
    kernels = []
    for name, (replaces, source) in PORTED.items():
        rec = main_recs[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        })
    emit({"kernels": kernels, "phase_seconds": t_phase,
          "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
