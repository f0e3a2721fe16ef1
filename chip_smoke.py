#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Run from the repository root; it needs one CUDA card, the CUDA toolkit
(``nvcc``) and nothing of JAX.  It builds the port's kernels from the sources
in the checkout and drives the port end to end.  Each phase prints one JSON
line; any failure raises and the script exits non-zero.

  device      card name and count, ``nvidia-smi`` name and power limit
  build       the four kernels, their planted-fault copies and the scans'
              recurrent-only variants, every nvcc started at once: wall
              time and ``-Xptxas -v`` report per kernel
  kernel      the paged-attention kernel against its plain PyTorch version
              at the main path's shapes (qwen1.5-0.5b decode and prefill,
              qwen2.5-14b's and jamba's 40:8 and 64:8 heads of 128 in
              decode and in a 512-token prefill chunk; the chunks at 8 KV
              heads fill the card with one split, the others split each
              row's pages across blocks), f32 and bf16, with dead pages
              NaN-poisoned and one ctx=0 row, within the kernel module's
              TOLERANCE; a copy of the kernel built with a planted fault
              (an off-by-one causal mask) must fail the same check; kernel,
              plain and library (SDPA) times and the card's bound; at
              qwen1.5's 16:16 D=64 and jamba's 64:8 D=128 decode shapes
              also the kernel's log-sum-exp output (`with_lse`, the
              sequence-sharded decode's partials) against the plain
              version's within LSE_TOL, and its time beside the plain
              version's
  serve-f32   full-width, full-depth qwen1.5-0.5b (random weights from a
              seed) serves 8 requests on three engines from one set of
              weights: eager (sync, unbucketed, no graphs), bucketed with
              one CUDA graph per bucket, and the same with async dispatch;
              the three give identical greedy tokens, equal to the port's
              dense reference up to a near-tie (top-2 logit gap < 1e-3); the
              kernel ran once per layer for each phase of every tick (the
              phases a tick's bucket has rows in), counted per replay
  serve-bf16  the same entry point in bf16 with 32 requests (4 sampled at
              temperature 0.8), twice from one set of weights: on the eager
              engine and on the bucketed async graph engine (the JAX
              package's fastest configuration): tokens/s, ticks, host/device
              time, memory, ladder size, graphs captured, capture seconds
              and graph-pool bytes; then the same batch again under
              torch.profiler (device activity only) for the device's busy
              time; the graph count is what warm_start captured
  trace-bf16  serve-bf16's batch on its weights again, on a bucketed sync
              graph engine twice untraced and on a twin with a tick trace
              (`trace_path`; traces refuse async): the same ticks, paged
              attention launched as in serve-bf16 (counted per replay);
              strict replay of the file round-trips it byte for byte
              (`check_trace`) and gives the live run's tokens; tokens/s
              traced and untraced (the recorder's cost), the trace's raw
              and compacted bytes, `host_s` per tick, the `RuntimeModel`
              fitted on it at overlap 0, and measured ms per tick by kind
  sim-h100    the port's simulator on that run: the scheduler rebuilt from
              the trace's header, qwen1.5-0.5b's roofline cost model at
              pp=1 at the card's rates (`repro_torch.roofline.analysis`)
              with the fitted host term, the 32 arrivals at t = 0 with the
              output lengths they had on the card; its batches must equal
              the trace's tick for tick; predicted ms per tick and output
              tokens/s beside the measured ones, and their ratios
  moe-kernel  the fused-MoE kernel against its plain version at
              olmoe-1b-7b's serve shapes (E=64, C=88, d=2048, ff=1024), a
              ragged C=24, a small shape and a decode tick (C=88 with ~4
              live rows per expert from a seed, 2 experts empty, the rows
              past `counts` NaN, which must come out as exact zeros), f32
              and bf16, within moe_gemm.TOLERANCE; a copy whose down loop
              over ff stops one tile early must fail the same check at
              every row, and a copy that drops split TF32's two cross
              products (single TF32) at the small f32 row; kernel, plain
              and library (the torch.bmm gate/up/silu-mul/down sequence)
              times, the bound (counts-aware), and for bf16 the device gap
              between the call's two launches
  serve-olmoe-f32   full-width olmoe-1b-7b cut to 4 of 16 layers, dropless
              capacity, 4 requests on serve-f32's three engines: identical
              greedy tokens, equal to the port's dense reference (its
              expert FFN on the plain version) up to a near-tie; the MoE
              kernel ran once per layer a tick, paged attention once per
              layer and phase
  serve-olmoe-bf16  full-width olmoe-1b-7b cut to 4 of its 16 layers (the
              script's time) in bf16 at the config's capacity factor, the
              serve-bf16 batch on serve-bf16's two engines: every request
              finishes with valid tokens, launches = ticks x 4 (MoE) and 4
              per phase a tick runs (attention); tokens/s, host/device
              time, memory and the graph engine's idle share from a
              profiled rerun
  rwkv-kernel the WKV6 kernel against its plain version at rwkv6-3b's
              serve shapes (32 decode rows over a pool of 64 slots; one
              512-token prefill chunk with 300 live tokens and a carried
              state), a small ragged one and the prefill chunk again with
              decays over the serve clamp's whole range (exact 0 and 1
              among them), f32 and bf16 inputs, with a data-dependent decay,
              NaN-poisoned pool slots (fresh rows' and unowned ones, which
              must come out bit-identical) and padding rows on a live row's
              slot, within rwkv6_scan.TOLERANCE, zeros past each row's
              length.  Decode runs the recurrent form, T > 1 the chunked
              one; a copy with a planted fault in the form that serves the
              row must fail the same check (recurrent: o_t reads S_t in
              place of S_{t-1}; chunked: the entering state's decay taken
              inclusive of w_t), and at the small f32 row a copy whose
              chunked products are single TF32.  Kernel time beside the
              recurrent-only form's (`recurrent_ms`, a variant built with
              T > 1 sent to the recurrent kernel), plain time and the bound
              (no single library call computes this function)
  serve-rwkv-f32  full-width rwkv6-3b cut to 4 of 32 layers, two waves of
              4 requests on each of serve-f32's three engines (the second
              wave reuses the first's state slots): identical greedy
              tokens, equal to the port's dense reference (its scan on the
              plain version) up to a near-tie; the kernel ran once per layer
              and phase
  serve-rwkv-bf16  full-width rwkv6-3b cut to 4 of its 32 layers (to keep
              the script inside its time), bf16, the serve-bf16 batch on
              serve-bf16's two engines: every request finishes with valid
              tokens, launches = 4 per phase a tick runs;
              tokens/s, host/device time, memory and the graph engine's
              idle share from a profiled rerun
  mamba-kernel  the Mamba selective-scan kernel against its plain version
              at jamba-1.5-large-398b's serve shapes (di=16384, ds=16: 32
              decode rows over a pool of 64 slots, 28 live; one 512-token
              prefill chunk with 300 live tokens and a carried state), a
              small ragged one and the prefill chunk again with step sizes
              up to 100 (exp(dt A) exactly 0 on many channels), f32 and
              bf16 x, step sizes from 1e-3 to 3, NaN-poisoned pool slots
              (fresh rows' and unowned ones, which must come out
              bit-identical) and padding rows on a live row's slot, within
              mamba_scan.TOLERANCE, zeros past each row's length.  Decode
              runs the recurrent form, T > 1 the segmented one; a copy with
              a planted fault in the form that serves the row must fail the
              same check (recurrent: y_t reads h_{t-1}; segmented: the
              carry applied one token late).  Kernel time beside the
              recurrent-only form's (`recurrent_ms`), plain time and the bound
              (no single library call computes the selective scan)
  serve-jamba-f32  full-width jamba-1.5-large-398b cut to its first
              MAMBA_MLP and ATTN_MOE layers (47.7 GB in f32), dropless, two
              waves of 4 requests on each of serve-f32's three engines (the
              second wave reuses the first's state slots): identical greedy
              tokens, equal to the port's dense reference (its scan and
              expert FFN on the plain versions) up to a near-tie; per phase
              a tick runs the Mamba kernel ran once and paged attention
              once, per tick the MoE kernel once
  serve-jamba-bf16  full-width jamba-1.5-large-398b cut to its first
              MAMBA_MLP, MAMBA_MOE and ATTN_MOE layers (44.0 GB in bf16) at
              the config's capacity factor, the serve-bf16 batch on
              serve-bf16's two engines: every request finishes with valid
              tokens, launches = 2 per phase a tick runs (Mamba), ticks x 2
              (MoE) and 1 per phase (attention); tokens/s, host/device time,
              memory and the graph engine's idle share from a profiled rerun

  serve-router-f32  full-width qwen1.5-0.5b cut to 8 of its 24 layers (the
              script's time) in f32, two
              bucketed async graph replicas on the one card, built by
              `repro_torch.serving.build` behind the balanced router and
              served through `LLMServer`, three times from one seed: the
              serve-f32 batch with two requests live-migrated mid-decode and
              one mid-prefill by `router.migrate_request`; the same batch on
              a disaggregated pair (roles prefill, decode), every request
              handed off once; and with prefix caching, 4 requests sharing a
              1,024-token head one after the other (at least 3 prefix hits),
              then one request streamed and one aborted mid-stream through
              `HTTPFrontend` on 127.0.0.1 (an ephemeral port; its pages
              return to its replica's pool).  Every greedy token equals the
              dense reference up to a near-tie; on each replica paged
              attention ran once per layer and phase a tick runs, its graph
              count stayed what warm_start captured and its pools kept their
              addresses
  serve-router-rwkv-f32  rwkv6-3b cut to 4 layers, f32, two bucketed async
              graph replicas behind the router: 8 requests placed on
              replica 0, 3 of them stolen while waiting and 2 live-migrated
              mid-decode (their WKV, tm_x and cm_x slots move); tokens equal
              the dense reference (its scan on the plain version) up to a
              near-tie, the WKV kernel ran on both replicas
  serve-router-bf16  serve-bf16's batch through `LLMServer` in bf16, on one
              bucketed async graph replica and on two behind the balanced
              router with its rebalance plane on: output tokens/s, TTFT,
              time per output token and inter-token gaps (p50, p99), routed
              counts, stolen and migrated requests, migrated tokens, peak
              memory; measurements only

  serve-pp-f32  full-width, full-depth qwen1.5-0.5b in f32 in four
              pipeline stages of 6 layers on the one card (`--pp 4`: four
              micro-batches in flight, Token Throttling at depth 4), the
              serve-f32 batch on serve-f32's three engines: identical greedy
              tokens, equal to the dense reference up to a near-tie; paged
              attention ran 4 x 6 times for each phase a tick's bucket
              holds, counted per replay; graph count, pool and carry
              addresses unchanged by serving
  serve-pp-bf16  qwen2.5-14b (the paper's model: d 5120, 40:8 heads of
              128; 48 layers, 29.5 GB in bf16) at full width cut to 8
              layers (to keep the script inside its time), the
              serve-bf16 batch on bucketed async graph engines at pp=1 and
              at pp=4 (4 x 2 layers) from one set of weights (the pp=4
              engine's are views of the pp=1 engine's): every request
              finishes with valid tokens, launches as `_launch_want` says;
              tokens/s, ms per tick, ticks, bubble stage-ticks (a stage
              holding no micro-batch), padded rows, busy and idle share
              from a profiled rerun, capture s and peak memory

  serve-archs-f32  the archs this slice adds, at full width, f32, on
              serve-f32's three engines, two waves of 4 requests each (the
              second on the first's slots): minicpm3-4b (MLA) cut to 4 of
              62 layers, whisper-small (encoder-decoder) cut to its first
              ENC_LAYER and DEC_LAYER (of 12 + 12; the script's time) with
              1,500 encoder frames and seeded encoder inputs (the second
              wave reuses the first's slots and encoder snapshots),
              qwen2-vl-7b (M-RoPE, 28:4 heads) and internlm2-1.8b (16:8
              heads) cut to 4 layers: identical greedy tokens, equal to
              the port's dense reference up to a near-tie; paged attention
              once per layer and phase (none for MLA, which runs as plain
              PyTorch as it runs as jnp in the JAX package)
  serve-archs-bf16  serve-bf16's batch on a bucketed async graph engine in
              bf16 for qwen2-vl-7b and internlm2-1.8b at full width and
              depth, whisper-small (1,500 frames) cut to its first ENC_LAYER
              and DEC_LAYER, minicpm3-4b at full width cut to 8 of its 62
              layers, kimi-k2-1t-a32b cut to its first ATTN_MOE layer (384
              experts, 38.9 GB) and llama3.1-100b cut to 8 of its 96
              layers in four stages of 2 (~16 GB): every request finishes
              with valid tokens, launches as `_launch_want` says; tokens/s,
              ms per tick, padded rows and peak memory; busy time and
              idle share from a profiled rerun for minicpm3 and whisper
  attention-plain  the attention that runs as plain PyTorch (no Pallas
              kernel in the JAX package either), bf16 at the serve shapes:
              minicpm3-4b's MLA (absorbed form) over a decode tick and a
              512-token chunk, whisper-small's encoder self-attention and
              cross-attention (decode tick, 512-token chunk): ms, bound,
              SDPA's ms (MLA's over K/V expanded ahead of the call)
  serve-32b-bf16  qwen2.5-32b (the paper's mid-size model: d 5120, 40:8
              heads; 64 layers, 65.5 GB in bf16) at full width cut to 8
              layers (to keep the script inside its time), as
              serve-pp-bf16: pp=1,
              then pp=4 (2 layers a stage) on views of the same
              weights once the pp=1 engine's KV pool and graphs are freed;
              tokens/s, ms per tick, bubble stage-ticks, padded rows, peak
              memory, and busy time and idle share from a profiled rerun at
              pp=1

  train-f32   the GPipe train step (`distributed.pipeline.build_train_step`)
              on full-width qwen1.5-0.5b cut to 4 layers, f32, one batch of
              2 micro-batches of 1,024 tokens: at lr = 0 and aux_coef = 0
              the step's loss is the dense reference's cross-entropy within
              2e-4, at pp=1 and at pp=4 (one layer a stage); pp=4's Adam
              moments and gnorm are pp=1's (MOMENT_TOL); then the fused-MoE
              kernel under autograd (`moe_gemm.FusedMoEFFN`) at olmoe's
              training shapes (E=64, C=648: 4,096 rows, top-8, capacity
              factor 1.25; d=2048, ff=1024; ragged counts, finite garbage
              past them), f32 and bf16: dx, dWg, dWu, dWd within
              moe_gemm.GRAD_TOLERANCE of autograd through the plain version,
              a backward with the sigmoid in place of silu's derivative
              failing the same check, and in f32 the backward run on TF32
              products failing it too; the backward's time, its bound, and
              the plain version's and the torch.bmm sequence's forward +
              backward
  train-bf16  `python -m repro_torch.launch.train --arch qwen1.5-0.5b --full
              --seq 4096 --steps 16 --lr 1e-4` in process (full width and depth,
              bf16, SyntheticLM, checkpointing at steps 8 and 16; 16 steps,
              not 30, for the script's time): the loss at step 15 below
              step 0's; median ms a step over steps 5-15, tokens/s, peak
              GB, model TFLOP/s; 4 steps of the same at remat="dots"
              (each layer's weight GEMMs saved, the rest recomputed): ms
              a step and peak beside the "full" run's; then olmoe-1b-7b
              cut to 4 of 16 layers
              (~1.9 B parameters), 10 steps, the same report and the MoE
              kernel's launches: layers x M x 2 a step
              (each forward again in the backward's recomputation)
  dryrun      the dry run (`launch.dryrun`: one rank's program counted on
              the meta device) of serve-bf16's qwen tick at FULL_DIMS on
              one rank and of train-bf16's qwen step: predicted per-rank
              bytes beside `max_memory_allocated` (within 0.5x-2x), the
              bound's ms at the data sheet's rates beside the measured ms
  train-ckpt  the checkpoint train-bf16 wrote restores into a fresh tree bit
              for bit; `--resume` loads it and starts below the fresh
              run's first loss; an eager bf16 qwen engine's
              `snapshot_state` -> `restore_requests` restart finishes the
              unfinished requests with their emitted prefix kept
  train-ssm-f32  RWKV and Mamba training (`ssm.wkv6_train`,
              `ssm.selective_scan_train`): one lr-0 step of the reduced f32
              rwkv6-3b and jamba-1.5-large-398b configs at widths the
              kernels take (d = 128, heads of 64, d_state 16; jamba's 9
              layers hold all three kinds, so MAMBA_MOE and ATTN_MOE run
              `FusedMoEFFN` under autograd) and of full-width rwkv6-3b cut
              to 4 layers, 2 micro-batches of 1,024 tokens: the loss is
              the cross-entropy of `dense_forward`, which runs the Hopper
              scan kernels, within 2e-4, the weights unchanged, the scan
              kernels launched 0 times by the step; the train forms'
              outputs and gradients against autograd of the sequential
              recurrence (`models/ssm_check.py`, its GRAD_TOL) at init,
              strong (-log w to 22,026; exp(dt A) exactly 0) and no decay,
              and the planted copies (o_t reading S_t, the product of w
              as a quotient of cumulative decays, y_t reading h_{t-1})
              failing it at strong decay
  train-ssm-bf16  rwkv6-3b at full width cut to 8 of its 32 layers (to
              keep the script inside its time), bf16, T = 4,096, 10 steps at
              lr 1e-4,
              then jamba-1.5-large-398b cut to two MAMBA_MLP layers at full
              width (~3.1 B with the embedding and head), 4 steps (the
              script's time), both
              through `launch.train.train`: finite, falling losses, the
              train-bf16 report, and the scan kernels launched 0 times

  serve-ranks-f32  qwen2.5-14b at full width cut to 4 layers, f32, served
              over pp=2 x tp=2 ranks: four processes on the one card under
              gloo (`launch.ranks.spawn`, `torch_rank_jobs.serve_rank`), each
              holding one stage at its tensor shard (20:4 heads, d_ff 6,912)
              drawn from the seed as the whole tree draws it; 8 requests:
              greedy tokens equal to the single-process pp=2 engine's on
              the same weights and to the dense reference, up to a near-tie;
              the batch of every tick equal to the single-process ring's;
              paged attention launched on every rank once per layer of its
              stage for each phase a tick runs; in the same spawn the rank
              engine's state in and out: prefix caching on 4 prompts that
              share a 2-page prefix (traced: the trace replays strictly
              and equals the one-process engine's outside its timing
              fields), async dispatch, two requests moved out mid-decode
              and finished in the one-process engine and one moved in, all
              with the one-process engine's tokens; then the serving stack
              on the same shard (`ranks_f32_rank`): a spec built by
              `serving.build(spec, ranks=)` into `LLMServer` over one rank
              engine serves the batch's r0, r2 and r3, 8 tokens each
              (the one-process engine's tokens up to the dense reference's
              near-ties), then through `HTTPFrontend` on 127.0.0.1 streams
              one of 8 tokens
              (TTFT and the gaps between its tokens), aborts one
              mid-stream (its pages back in the pool), waits past the idle
              command's interval and serves one more; the spec with two
              engines on the layout behind the balanced router serves the
              8 requests, 8 tokens each, with one live-migrated mid-decode
              between them (its state bytes per rank, the routed counts);
              ms a tick per engine, the idle commands
              sent, and paged attention on every rank once per layer of its
              stage for each phase a tick of each engine runs
  serve-ranks-bf16  qwen2.5-14b at full width cut to 4 of its 48 layers
              (2 a stage; the script's time), bf16, pp=2 x tp=2 ranks,
              bucketed, eager and sync:
              serve-bf16's batch of 32 (4 at temperature 0.8, drawn by
              Gumbel-max over the vocab slices); every request finishes
              with valid tokens, launches as in serve-ranks-f32; output
              tokens/s and ms a tick beside serve-pp-bf16's pp=1 and pp=4
              rows (8 layers); per rank host, device and
              collective time, bytes a tick per hop and per TP all-reduce,
              bytes staged through host memory, peak memory.  It measures
              the protocol's cost on one shared card (the ranks' kernels
              time-slice the card, gloo stages through the host), not
              pipelining's gain
  train-ranks  qwen1.5-0.5b at full width over dp=2 x pp=2 x tp=2 = 8
              ranks on the one card (`launch.train.train_rank`): a 4-layer
              f32 cut's lr-0 loss equal to the dense cross-entropy within
              2e-4; then 12 of its 24 layers (the script's time) in bf16,
              `ring8` gradient compression, a few steps on one batch:
              finite losses that fall; the bf16 run saves a checkpoint
              across the ranks at its last step, which the parent restores
              in one process (each rank's block of every leaf equal to that
              rank's leaf), and the f32 run's weights come from a
              checkpoint the parent saved in one process, restored at the
              layout
  serve-tp-f32  tensor parallelism of every other block kind at full width
              and cut depth, f32, over ranks on the card: minicpm3-4b
              (MLA_MLP, 4 layers), rwkv6-3b (RWKV, 4 layers) and jamba's
              first MAMBA_MLP layer at tp=2 in one launch, olmoe-1b-7b
              (ATTN_MOE, 4 layers) and whisper-small (its first ENC_LAYER and
              DEC_LAYER, 1,500 encoder frames) at tp=4 in another;
              each model's one-process engine serves 4 requests first (and
              is freed), on the weights the ranks draw; the ranks' greedy
              tokens equal its tokens and the dense reference's up to a
              near-tie, the batch of every tick equal; every rank launches
              each kernel as `_launch_want` says for the batch; a second
              rwkv6-3b run moves r0's state out once it holds 3 tokens: its
              rows within `MOVE_TOL` of the one-process engine's export of
              the same request, then finished there with its tokens
  serve-tp-bf16  the jamba cut (MAMBA_MLP, MAMBA_MOE and ATTN_MOE, 44.0 GB
              in bf16) at tp=2 in the tp=2 launch, bucketed, one batch of
              16: valid tokens, launches, ms a tick, each rank's split of
              its tick into host, collectives and own-device wait, peak
              memory a rank
  train-tp    olmoe-1b-7b at full width cut to 2 layers, f32, dropless, at
              tp=4 in the tp=4 launch: the lr-0 loss against the dense
              cross-entropy within 2e-4, the fused MoE kernel launched
              under autograd at ff = 256 a rank
  serve-ep-f32  expert parallelism over `data` and the serve tick's data
              axis, in one launch of dp=2 x tp=2 = 4 ranks on the card: the
              serve-jamba-f32 cut (MAMBA_MLP and ATTN_MOE, 47.7 GB in f32)
              on that phase's weights (the rank draw is the slice of the
              whole tree's: 8 of 16 experts and ff 12,288 a rank, ~14.2 GB)
              and 8 prompts, dropless under expert parallelism (the least
              such capacity factor, `ep_dropless_cf`): the ranks' greedy
              tokens equal serve-jamba-f32's one-process engine's up to its
              dense reference's near-ties, the batch of every tick and each
              row's replica equal a host replay of the scheduler over two
              replicas' pools, every rank exchanged expert rows, and every
              rank launches each kernel as `_launch_want` says; a second
              run moves r0's KV and Mamba state out of its replica, checked
              as serve-tp-f32's rwkv6-3b move; the first run is traced: the
              trace (its header naming both replicas' pools) replays
              strictly on this host with the run's batches, each row's
              replica and its tokens; then, on the same shards,
              sequence-sharded decode at `serve_cell_dims(jamba,
              long_500k, data=2)` (one sequence's 524,288 keys, each data
              replica every other page of them, ~1.1 GB of f32 KV a rank):
              the pools filled with seeded K/V and Mamba state, 3 decode
              ticks whose attention partials (the kernel's log-sum-exp)
              merge over `data`, held to the same ticks over the whole
              sequence on every replica, logits within SEQ_TOL
  serve-ep-bf16  the kimi-k2 cut (its first ATTN_MOE layer, 384 experts,
              38.9 GB in bf16) at its published tp=2 and dp=2 (192 experts
              and ff 1,024 a rank, ~11 GB), bucketed, one batch of 16 at the
              config's capacity factor spread over both replicas: valid
              tokens, launches, ms a tick, each rank's split of its tick
              into host, collectives and own-device wait, the `ep` bytes,
              peak memory a rank
  train-ep    reduced kimi-k2 at the MoE kernel's widths (d 128, expert ff
              128 a rank), f32, dropless, at dp=2 x tp=2, lr 0: the loss
              against the dense cross-entropy within 2e-4, the fused MoE
              kernel launched under autograd at 2 local experts.  Full-width
              kimi-k2 training does not fit the card (its cut's weights
              with Adam's two f32 moments, ~3 x 38.9 GB over four ranks)

The kernel phase also holds paged attention at qwen2-vl-7b's 28:4 heads
(G = 7), internlm2-1.8b's 16:8 heads of 128 (G = 2) and qwen2.5-14b's
per-rank 20:4 heads at tp=2 (G = 5), and the moe-kernel
phase the fused MoE at kimi-k2's E=384, C=16, d=7168, ff=2048 (bf16), full
and as a decode tick with most experts empty.
The kernel phases also hold bf16 rows at one tensor rank's shapes
(`TP_ROWS`): paged attention at whisper's 3:3 heads of 64 and olmoe's 4:4
of 128 (tp=4), the fused MoE at olmoe's ff = 256 (tp=4) and jamba's
12,288 (tp=2), WKV6 at rwkv6-3b's 20 heads and the selective scan at
jamba's 8,192 channels (tp=2).
The moe-kernel phase also holds the fused MoE (bf16) at one expert-parallel
rank's shapes at dp=2 x tp=2 (`EP_ROWS`): kimi-k2's 192 local experts at
ff 1,024 (C=40, the serve-ep-bf16 prefill tick's expert capacity, and a
decode tick) and jamba's 8 at ff 12,288 (C=216).
The kernel and moe-kernel phases also hold their kernels at jamba's shapes:
paged attention decode and prefill with 64 query heads over 8 KV heads of
128, and the fused MoE (bf16) at E=16, C=88, d=8192, ff=24576, full and as
a decode tick, where the planted MoE fault drops 64 of the down sum's
24,576 terms and must fail as elsewhere.

Then a ``{"kernels": [...]}`` line, the raw ``nvidia-smi`` line, and as the
last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
# the card's HBM rate and bf16 tensor-core peak are the simulator's
# (`repro_torch.roofline.analysis`, H100 SXM data sheet): `main` sets them
# once the package is importable; the f32 and TF32 peaks and the SFU rate
# are the kernel bounds' own
HBM_BYTES_PER_S = None
PEAK_FLOPS = {"float32": 67e12,           # f32 outside the tensor cores
              "tfloat32": 495e12,         # TF32 tensor cores, dense
              "bfloat16": None}           # bf16 tensor cores, dense
# special-function units (exp2, the core of expf): 16 results per SM and
# clock (CUDA C Programming Guide, throughput table, compute capability
# 9.0) x 132 SMs x 1.98 GHz (H100 SXM boost clock)
SFU_PER_S = 16 * 132 * 1.98e9
SPIN_HZ = 1.98e9            # `torch.cuda._sleep` cycles a second (boost)
ARCH = "qwen1.5-0.5b"
LAYERS = 24
MOE_ARCH = "olmoe-1b-7b"
MOE_F32_LAYERS = 4          # depth cut of the f32 serve (full: 16)
MOE_BF16_LAYERS = 4         # and of the bf16 serve (the script's time)
RWKV_ARCH = "rwkv6-3b"
RWKV_F32_LAYERS = 4         # depth cut of the f32 serve (full: 32)
RWKV_BF16_LAYERS = 4        # and of the bf16 serve (the script's time)
JAMBA_ARCH = "jamba-1.5-large-398b"
# depth cuts of jamba (72 layers, 870 GB in bf16): the first layer of each
# kind; the f32 serve drops the MAMBA_MOE layer to fit (47.7 GB)
JAMBA_KINDS = ("mamba_mlp", "mamba_moe", "attn_moe")
JAMBA_F32_KINDS = ("mamba_mlp", "attn_moe")
PP = 4                      # pipeline stages of the serve-pp phases
PP_ARCH = "qwen2.5-14b"     # the paper's evaluation model, 29.5 GB in bf16
PP_LAYERS = 8               # serve-pp-bf16's cut of its 48 (the script's time)
MAX_NEW = 16
NEAR_TIE = 1e-3
# the engines each serve phase runs, one after the other on one set of
# weights: eager (sync, unbucketed, no graphs: the earlier slices' engine),
# then one CUDA graph per ladder bucket, sync and async (the f32 phases), or
# async (the bf16 phases: the JAX package's fastest configuration)
F32_VARIANTS = {"eager": dict(cuda_graphs=False),
                "graphs": dict(bucketed=True),
                "graphs_async": dict(bucketed=True, async_dispatch=True)}
BF16_VARIANTS = {"eager": dict(cuda_graphs=False),
                 "graphs_async": dict(bucketed=True, async_dispatch=True)}
# the device functions of the port's kernels (csrc/*.cu), as the profiler
# names them
PORT_KERNELS = ("::paged_attention_decode_kernel<",
                "::paged_attention_f32_prefill_kernel<",
                "::paged_attention_wgmma_kernel<",
                "::paged_attention_combine_kernel<",
                "::moe_wgmma_kernel<", "::moe_f32_kernel<", "::wkv6_kernel<",
                "::wkv6_chunk_state_kernel<", "::wkv6_chunk_scan_kernel(",
                "::wkv6_chunk_out_kernel<", "::mamba_scan_kernel<",
                "::mamba_segment_kernel<")


T0 = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase line also gets the seconds since the
    script started (``t_s``)."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - T0, 3)}
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls (CUDA
    events, after `warmup` calls).  The calls queue behind a spin on the
    card, so that the host has enqueued all of them before the card
    reaches the first: a call shorter than its own launch overhead is then
    timed on the card, not on the host.  When a 1 ms spin is not enough,
    the calls run once more behind a spin four times as long as the host
    took to enqueue them; a call that synchronises (the WKV and Mamba plain
    versions pick their rows on the host) can never get ahead of the card,
    and is timed with the host in it on that second run."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin, sized = 1 << 21, False          # clock cycles, ~1 ms
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_s = time.perf_counter() - t0
        end.record()
        ahead = not start.query()         # the card is still spinning
        end.synchronize()
        if ahead or sized:
            return start.elapsed_time(end) / iters
        spin = min(max(spin << 2, int(4 * host_s * SPIN_HZ)), 1 << 33)
        sized = True


# ---------------------------------------------------------------- phases

def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    out = {"phase": "device", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), "nvidia_smi": smi,
           "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(out)
    return out


PLANTED = "paged_attention_planted"


def planted_source(build) -> str:
    """The kernel's source with one planted fault: the causal mask
    ``kpos <= qpos`` becomes ``kpos < qpos``, so every row loses its own
    key, on every path alike: the decode on the CUDA cores and on the tensor
    cores, the f32 prefill and the wgmma prefill (one mask each)."""
    text = (build.CSRC / "paged_attention.cu").read_text()
    if text.count("kpos <= qp[") != 4:
        raise AssertionError("planted fault: the kernel's causal mask is no "
                             "longer where chip_smoke.py looks for it")
    return text.replace("kpos <= qp[", "kpos < qp[")


MOE_PLANTED = "moe_ffn_planted"
MOE_MARK = "const int ff_tiles = ff / bk;"


def moe_planted_source(build) -> str:
    """The MoE kernel's source with one planted fault: the down
    projection's depth loop, which walks ff, stops one tile early (64 terms
    in bf16, 32 in f32)."""
    text = (build.CSRC / "moe_ffn.cu").read_text()
    if text.count(MOE_MARK) != 1:
        raise AssertionError("planted fault: the MoE kernel's ff loop bound "
                             "is no longer where chip_smoke.py looks for it")
    return text.replace(MOE_MARK, "const int ff_tiles = ff / bk - 1;")


MOE_TF32_PLANTED = "moe_ffn_planted_tf32"
MOE_TF32_MARK = ("  mma_tf32(c, a_lo, b_hi);\n"
                 "  mma_tf32(c, a_hi, b_lo);\n")


def moe_tf32_planted_source(build) -> str:
    """The MoE kernel's source with split TF32's two cross products left
    out: every f32 product is one TF32 product, hi(a) * hi(b)."""
    text = (build.CSRC / "moe_ffn.cu").read_text()
    if text.count(MOE_TF32_MARK) != 1:
        raise AssertionError("planted fault: the MoE kernel's split-TF32 "
                             "products are no longer where chip_smoke.py "
                             "looks for them")
    return text.replace(MOE_TF32_MARK, "")


RWKV_PLANTED = "rwkv6_scan_planted"
RWKV_READ = ("      const float o = read_out(S, sm.r[t][q], vj, "
             "sm.bonus[t][q]);\n")
RWKV_STEP = "      advance_state(S, sm.w[t][q], sm.k[t][q], vj);\n"


def rwkv_planted_source(build) -> str:
    """The WKV kernel's source with one planted fault: the state advances
    before the output reads it, so o_t reads S_t in place of S_{t-1} (the
    recurrence's off-by-one)."""
    text = (build.CSRC / "rwkv6_scan.cu").read_text()
    if text.count(RWKV_READ + RWKV_STEP) != 1:
        raise AssertionError("planted fault: the WKV kernel's read and "
                             "update are no longer where chip_smoke.py looks "
                             "for them")
    return text.replace(RWKV_READ + RWKV_STEP, RWKV_STEP + RWKV_READ)


RWKV_CHUNK_PLANTED = "rwkv6_scan_planted_chunked"
RWKV_PREFIX = ("      sr[t][tid] = __fmul_rn(sr[t][tid], a);\n"
               "      a = __fmul_rn(a, sw[t][tid]);\n")


def rwkv_chunk_planted_source(build) -> str:
    """The WKV kernel's source with one planted fault in its chunked form:
    the decay that carries the chunk's entering state to token t is taken
    inclusive of w_t (a_t = prod_{m<=t} w_m in place of prod_{m<t})."""
    text = (build.CSRC / "rwkv6_scan.cu").read_text()
    if text.count(RWKV_PREFIX) != 1:
        raise AssertionError("planted fault: the WKV kernel's prefix decay is "
                             "no longer where chip_smoke.py looks for it")
    lines = RWKV_PREFIX.splitlines(keepends=True)
    return text.replace(RWKV_PREFIX, lines[1] + lines[0])


RWKV_TF32_PLANTED = "rwkv6_scan_planted_tf32"


def rwkv_tf32_planted_source(build) -> str:
    """The WKV kernel's source with split TF32's two cross products left
    out of its chunked form: every product is one TF32 product."""
    text = (build.CSRC / "rwkv6_scan.cu").read_text()
    if text.count(MOE_TF32_MARK) != 1:
        raise AssertionError("planted fault: the WKV kernel's split-TF32 "
                             "products are no longer where chip_smoke.py "
                             "looks for them")
    return text.replace(MOE_TF32_MARK, "")


# The recurrent-only form at every shape: the dispatch sends T > 1 to the
# recurrent kernel too (a built variant for the before/after times, not a
# knob of the port).
RWKV_RECURRENT = "rwkv6_scan_recurrent"
RWKV_DISPATCH = "bool chunked(int T) {\n  return T > 1;\n}"


def rwkv_recurrent_source(build) -> str:
    text = (build.CSRC / "rwkv6_scan.cu").read_text()
    if text.count(RWKV_DISPATCH) != 1:
        raise AssertionError("the WKV kernel's dispatch is no longer where "
                             "chip_smoke.py looks for it")
    return text.replace(RWKV_DISPATCH,
                        "bool chunked(int T) {\n  return false;\n}")


MAMBA_PLANTED = "mamba_scan_planted"
MAMBA_STEP = "        h[i] = fmaf(dA, h[i], __fmul_rn(dtx, sm.b[t][s]));\n"
MAMBA_READ = "        y = fmaf(sm.c[t][s], h[i], y);\n"


def mamba_planted_source(build) -> str:
    """The Mamba kernel's source with one planted fault: the read-out
    comes before the update, so y_t reads h_{t-1} in place of h_t (the
    recurrence's off-by-one)."""
    text = (build.CSRC / "mamba_scan.cu").read_text()
    if text.count(MAMBA_STEP + MAMBA_READ) != 1:
        raise AssertionError("planted fault: the Mamba kernel's update and "
                             "read-out are no longer where chip_smoke.py "
                             "looks for them")
    return text.replace(MAMBA_STEP + MAMBA_READ, MAMBA_READ + MAMBA_STEP)


MAMBA_SEG_PLANTED = "mamba_scan_planted_segmented"
MAMBA_CARRY = ("      p[i] = __fmul_rn(p[i], dA);\n"
               "      qv[u][i] = __fmul_rn(cc[i], p[i]);\n")


def mamba_seg_planted_source(build) -> str:
    """The Mamba kernel's source with one planted fault in its segmented
    form: the carry reaches token t with the decay up to t - 1 (q_t = C_t
    P_{t-1}), so it is applied one token late."""
    text = (build.CSRC / "mamba_scan.cu").read_text()
    if text.count(MAMBA_CARRY) != 1:
        raise AssertionError("planted fault: the Mamba kernel's carry decay "
                             "is no longer where chip_smoke.py looks for it")
    lines = MAMBA_CARRY.splitlines(keepends=True)
    return text.replace(MAMBA_CARRY, lines[1] + lines[0])


MAMBA_RECURRENT = "mamba_scan_recurrent"
MAMBA_DISPATCH = "bool segmented(int T) {\n  return T > 1;\n}"


def mamba_recurrent_source(build) -> str:
    """The recurrent-only form at every shape (see RWKV_RECURRENT)."""
    text = (build.CSRC / "mamba_scan.cu").read_text()
    if text.count(MAMBA_DISPATCH) != 1:
        raise AssertionError("the Mamba kernel's dispatch is no longer where "
                             "chip_smoke.py looks for it")
    return text.replace(MAMBA_DISPATCH,
                        "bool segmented(int T) {\n  return false;\n}")


def _ptxas(log: str) -> list:
    kernels = []
    for block in log.split("Compiling entry function")[1:]:
        name = re.search(r"'(\S+)'", block)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          block)
        smem = re.search(r"(\d+) bytes smem", block)
        kernels.append({
            "kernel": name.group(1) if name else "?",
            "registers": int(regs.group(1)) if regs else None,
            "static_smem": int(smem.group(1)) if smem else 0,
            "spill_stores": int(spill.group(1)) if spill else None,
            "spill_loads": int(spill.group(2)) if spill else None})
    return kernels


def phase_build(build, planted: dict) -> None:
    """Every kernel and planted copy, all nvcc processes started at once."""
    t0 = time.perf_counter()
    kernels = list(build.KERNELS)
    build.build_all([*kernels, *planted], planted)
    wall = time.perf_counter() - t0
    for name in kernels:
        emit({"phase": "build", "kernel": name,
              "nvcc_seconds": round(build.build_log[name]["seconds"], 3),
              "ptxas": _ptxas(build.build_log[name]["log"])})
    emit({"phase": "build", "wall_seconds": round(wall, 3),
          "planted_nvcc_seconds": {
              k: round(build.build_log[k]["seconds"], 3) for k in planted}})


# kernel rows at one tensor rank's shapes, run in bf16 only
TP_ROWS = ("whisper tp=4 decode", "whisper tp=4 prefill", "olmoe tp=4 decode",
           "olmoe tp=4 prefill", "olmoe tp=4 serve", "jamba tp=2 serve",
           "rwkv6-3b tp=2 decode", "rwkv6-3b tp=2 prefill",
           "jamba tp=2 decode", "jamba tp=2 prefill")
# fused-MoE rows at one expert-parallel rank's shapes (dp=2 x tp=2), bf16
# only: kimi-k2's 192 local experts at ff 1,024 (C: the serve-ep-bf16
# prefill tick's cap_e, 544 rows at top-8 and capacity factor 1.25; and a
# decode tick), jamba's 8 at ff 12,288 (C: the same tick's at top-2)
EP_ROWS = ("kimi-k2 ep dp=2 tp=2 prefill", "kimi-k2 ep dp=2 tp=2 decode tick",
           "jamba ep dp=2 tp=2 serve")


def _attention_case(S, TQ, H, KH, D, page, B, dtype, ctx, seed):
    """Inputs on the card: distinct pages per sequence, dead pages
    NaN-poisoned, q positions the last TQ positions of each context."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    P = S * B
    q = torch.randn(S, TQ, H, D, generator=g, device=DEV).to(dtype)
    kv = torch.randn(P, page, 2, KH, D, generator=g, device=DEV).to(dtype)
    tables = torch.randperm(P, generator=g, device=DEV).view(S, B)
    tables = tables.to(torch.int32).contiguous()
    ctx = torch.tensor(ctx, dtype=torch.int32, device=DEV)
    qpos = (torch.clamp(ctx, min=TQ)[:, None] - TQ
            + torch.arange(TQ, device=DEV)[None, :]).to(torch.int32)
    live = (ctx + page - 1) // page
    dead = torch.arange(B, device=DEV)[None, :] >= live[:, None]
    clean = kv.clone()
    kv[tables[dead].long()] = float("nan")
    return q, kv, clean, tables, ctx, qpos.contiguous()


def _bound(q, kv, tables, ctx, qpos, page):
    """Least time the card could take: live KV, q, out, metadata bytes at
    the HBM rate against the flops these inputs need at the dtype's peak."""
    S, TQ, H, D = q.shape
    KH = kv.shape[3]
    elt = q.element_size()
    ctx_h = ctx.cpu().long()
    qpos_h = qpos.cpu().long()
    live_pages = (ctx_h + page - 1) // page
    kv_bytes = int(ctx_h.sum()) * 2 * KH * D * elt
    meta_bytes = 4 * (S + S * TQ + int(live_pages.sum()))
    nbytes = 2 * q.numel() * elt + kv_bytes + meta_bytes
    keys = torch.minimum(ctx_h[:, None], qpos_h + 1).clamp(min=0)
    keys = keys * (ctx_h[:, None] > 0)
    flops = int(keys.sum()) * H * 4 * D
    dt = str(q.dtype).split(".")[-1]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


def _library_fn(q, clean, tables, ctx, qpos, page):
    """One SDPA call over K/V pre-gathered from the tables (the gather is
    not timed), with the same causal/context mask."""
    import torch.nn.functional as F
    S, TQ, H, D = q.shape
    KH = clean.shape[3]
    L = int(((ctx.max() + page - 1) // page).item()) * page
    nb = L // page
    kvd = clean[tables[:, :nb].long()].reshape(S, L, 2, KH, D)
    # GQA: KV heads expanded to the q heads ahead of the call (not timed)
    k = kvd[:, :, 0].transpose(1, 2).repeat_interleave(H // KH, dim=1)
    v = kvd[:, :, 1].transpose(1, 2).repeat_interleave(H // KH, dim=1)
    qt = q.transpose(1, 2).contiguous()                  # [S, H, TQ, D]
    kpos = torch.arange(L, device=DEV)
    mask = ((kpos[None, None, :] < ctx[:, None, None])
            & (kpos[None, None, :] <= qpos[:, :, None]))[:, None]
    k, v = k.contiguous(), v.contiguous()
    return lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=mask)


# the shapes at which the kernel's log-sum-exp output (`with_lse`, the
# sequence-sharded decode's partials) is held to the plain version's
LSE_SHAPES = ("qwen1.5 decode", "jamba decode")
# |lse - plain lse| on rows with ctx > 0: both take m + log(l) in f32 over
# the same scores (bf16 inputs are exact in f32), apart in summation order
# only (~1e-6 of l, and of a score's ~D products); held at 1e-4
LSE_TOL = 1e-4


def _lse_check(pa, args, plain) -> dict:
    """The kernel's output and log-sum-exp `with_lse` against the plain
    version's on the same inputs, and both calls' times."""
    out, lse = pa.paged_flash_attention(*args, with_lse=True)
    _, want = pa.paged_flash_attention_ref(*plain, with_lse=True)
    torch.cuda.synchronize()
    live = plain[3] > 0
    excess, _ = pa.excess(out, *plain)
    err = float((lse[live] - want[live]).abs().max())
    empty = bool(torch.all(lse[~live] == pa.NEG_INF))
    return {"lse_excess": excess, "lse_max_abs_err": err,
            "lse_tol": LSE_TOL, "lse_empty_rows": empty,
            "lse_ok": excess <= 1.0 and err <= LSE_TOL and empty,
            "lse_ms": time_ms(lambda: pa.paged_flash_attention(
                *args, with_lse=True), 20),
            "lse_plain_ms": time_ms(lambda: pa.paged_flash_attention_ref(
                *plain, with_lse=True), 3, warmup=1)}


def phase_kernel(pa, planted_src: str) -> list:
    rng_ctx = np.random.default_rng(7)
    decode_ctx = [int(c) for c in rng_ctx.integers(1, 2049, 32)]
    decode_ctx[0], decode_ctx[1], decode_ctx[-1] = 2048, 1, 0
    shapes = [
        # name, S, TQ, H, KH, D, page, B, ctx, seeds (f32, bf16)
        ("qwen1.5 decode", 32, 1, 16, 16, 64, 16, 128, decode_ctx, (0, 3)),
        ("qwen1.5 prefill", 1, 512, 16, 16, 64, 16, 128, [2000], (1, 4)),
        ("qwen2.5-14b decode", 32, 1, 40, 8, 128, 16, 128, decode_ctx,
         (2, 5)),
        ("jamba decode", 32, 1, 64, 8, 128, 16, 128, decode_ctx, (6, 7)),
        ("jamba prefill", 1, 512, 64, 8, 128, 16, 128, [2000], (8, 9)),
        ("qwen2.5-14b prefill", 1, 512, 40, 8, 128, 16, 128, [2000],
         (10, 11)),
        # G = 7: 7 rows padded to 16 on the tensor-core decode path; prefill
        # row tiles straddle q positions at a G not a power of two
        ("qwen2-vl-7b decode", 32, 1, 28, 4, 128, 16, 128, decode_ctx,
         (20, 21)),
        ("qwen2-vl-7b prefill", 1, 512, 28, 4, 128, 16, 128, [2000],
         (22, 23)),
        # G = 2 at D = 128: bf16 decode below 4 rows on the CUDA cores
        ("internlm2-1.8b decode", 32, 1, 16, 8, 128, 16, 128, decode_ctx,
         (24, 25)),
        ("internlm2-1.8b prefill", 1, 512, 16, 8, 128, 16, 128, [2000],
         (26, 27)),
        # qwen2.5-14b at tp=2: one tensor rank's 20 query and 4 KV heads
        ("qwen2.5-14b tp=2 decode", 32, 1, 20, 4, 128, 16, 128, decode_ctx,
         (28, 29)),
        ("qwen2.5-14b tp=2 prefill", 1, 512, 20, 4, 128, 16, 128, [2000],
         (30, 31)),
        # one tensor rank's heads (bf16 only, `TP_ROWS`): whisper-small at
        # tp=4 (3 query and 3 KV heads of 64), olmoe-1b-7b at tp=4 (4:4
        # of 128)
        ("whisper tp=4 decode", 32, 1, 3, 3, 64, 16, 128, decode_ctx,
         (32, 33)),
        ("whisper tp=4 prefill", 1, 512, 3, 3, 64, 16, 128, [2000],
         (34, 35)),
        ("olmoe tp=4 decode", 32, 1, 4, 4, 128, 16, 128, decode_ctx,
         (36, 37)),
        ("olmoe tp=4 prefill", 1, 512, 4, 4, 128, 16, 128, [2000],
         (38, 39)),
    ]
    results = []
    for d_idx, dtype in enumerate((torch.float32, torch.bfloat16)):
        atol, rtol, vtol = pa.TOLERANCE[dtype]
        for name, S, TQ, H, KH, D, page, B, ctx, seeds in shapes:
            if name in TP_ROWS and dtype != torch.bfloat16:
                continue
            q, kv, clean, tables, ctx_t, qpos = _attention_case(
                S, TQ, H, KH, D, page, B, dtype, ctx, seed=seeds[d_idx])
            out = pa.paged_flash_attention(q, kv, tables, ctx_t, qpos)
            planted = pa.launch(PLANTED, q, kv, tables, ctx_t, qpos,
                                source=planted_src)
            torch.cuda.synchronize()
            plain = (q, clean, tables, ctx_t, qpos)
            excess, err = pa.excess(out, *plain)
            planted_excess, _ = pa.excess(planted, *plain)
            live = ctx_t > 0
            zeros = bool(torch.all(out[~live] == 0))
            finite = bool(torch.isfinite(out).all())
            row = {"phase": "kernel", "shape": name,
                   "dtype": str(dtype).split(".")[-1],
                   "S": S, "TQ": TQ, "H": H, "KH": KH, "D": D, "page": page,
                   "B": B, "max_ctx": max(ctx), "max_abs_err": err,
                   "atol": atol, "rtol": rtol, "vtol": vtol,
                   "excess": excess,
                   "planted_excess": planted_excess,
                   "ctx0_rows_zero": zeros, "finite": finite}
            if not (excess <= 1.0 and zeros and finite):
                emit(row)
                raise AssertionError(f"kernel disagrees with its plain "
                                     f"version at {name} {dtype}: {row}")
            if not planted_excess > 1.0:
                emit(row)
                raise AssertionError(f"the check passes a kernel with an "
                                     f"off-by-one causal mask at {name} "
                                     f"{dtype}: {row}")
            args = (q, kv, tables, ctx_t, qpos)
            if name in LSE_SHAPES:
                row.update(_lse_check(pa, args, plain))
                if not row["lse_ok"]:
                    emit(row)
                    raise AssertionError(f"the kernel's log-sum-exp "
                                         f"disagrees with the plain "
                                         f"version's at {name} {dtype}")
            row["kernel_ms"] = time_ms(
                lambda: pa.paged_flash_attention(*args), 20)
            row["plain_ms"] = time_ms(
                lambda: pa.paged_flash_attention_ref(
                    q, clean, tables, ctx_t, qpos), 3, warmup=1)
            row["library_ms"] = time_ms(
                _library_fn(q, clean, tables, ctx_t, qpos,
                                   page), 20)
            row["library"] = ("torch SDPA over K/V pre-gathered from the "
                              "tables (gather not timed)")
            (row["bound_ms"], row["bound_by"], row["bytes"],
             row["flops"]) = _bound(q, kv, tables, ctx_t, qpos, page)
            emit(row)
            results.append(row)
            del q, kv, clean, out, planted, plain
            torch.cuda.empty_cache()
    return results


def _prompts(seed: int, n: int, vocab: int):
    rng = np.random.default_rng(seed)
    lens = [int(x) for x in rng.integers(16, 1501, n)]
    lens[0], lens[1] = 16, 1500
    return [[int(t) for t in rng.integers(0, vocab, L)] for L in lens]


def _match_reference(phase, eng, prompts, reqs, max_new, greedy_trace,
                     encs=None):
    """Every request finished with `max_new` tokens, equal to the port's
    dense reference (on an encoder-decoder's `encs`, one per prompt) up to
    its first near-tie (top-2 logit gap below NEAR_TIE).  Returns (tokens
    compared, near-ties)."""
    compared, near_ties = 0, []
    encs = encs or [None] * len(prompts)
    for i, (p, r) in enumerate(zip(prompts, reqs)):
        if not (r.is_finished and r.num_output_tokens == max_new):
            raise AssertionError(f"{phase}: request {i} did not finish")
        want, gaps = greedy_trace(eng.cfg, eng.params, p, max_new, encs[i])
        stop = next((k for k, g in enumerate(gaps) if g < NEAR_TIE), max_new)
        if stop < max_new:
            near_ties.append({"request": i, "step": stop, "gap": gaps[stop]})
        if r.output_token_ids[:stop] != want[:stop]:
            raise AssertionError(f"{phase}: request {i} (prompt {len(p)}) "
                                 f"{r.output_token_ids} != reference {want} "
                                 f"(compared {stop})")
        compared += stop
    return compared, near_ties


def phase_serve_f32(pa, build_engine, greedy_trace) -> dict:
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    prompts = _prompts(11, 8, get_config(ARCH).vocab_size)

    def serve(eng):
        reqs = [eng.add_request(p, _sampling(0.0)) for p in prompts]
        eng.drain()
        return {"reqs": reqs}

    runs, eng, last = _f32_variants(
        "serve-f32", lambda: build_engine(ARCH, device=DEV,
                                          dtype=torch.float32,
                                          cuda_graphs=False),
        serve, {"paged_flash_attention": pa})
    serve_s = time.perf_counter() - t0
    compared, near_ties = _match_reference("serve-f32", eng, prompts,
                                           last["reqs"], MAX_NEW,
                                           greedy_trace)
    out = {"phase": "serve-f32", "arch": ARCH, "layers": LAYERS,
           "requests": len(prompts), "prompt_lens": [len(p) for p in prompts],
           "max_new_tokens": MAX_NEW, "variants": runs,
           "tokens_compared": compared, "near_ties": near_ties,
           "serve_and_check_s": serve_s,
           "check_s": time.perf_counter() - t0 - serve_s}
    emit(out)
    del eng
    _free()
    return out


def _sampling(temperature):
    from repro_torch.core import SamplingParams
    return SamplingParams(max_new_tokens=MAX_NEW, temperature=temperature)


def _serve_batch(eng, prompts, encs=None) -> list:
    encs = encs or [None] * len(prompts)
    reqs = [eng.add_request(p, _sampling(0.8 if i % 8 == 7 else 0.0),
                            **({} if e is None else {"enc_embeds": e}))
            for i, (p, e) in enumerate(zip(prompts, encs))]
    eng.drain()
    torch.cuda.synchronize()
    return reqs


def _serve_measured(eng, prompts, counted: dict, phase: str,
                    variant: str, encs=None, profiled: bool = True) -> dict:
    """Serve `prompts` once for the numbers, every count of `counted` (name
    -> kernel module) set to 0 just before and read just after, which must
    be what `_launch_want` makes of the engine's ticks; check that every
    request finished with valid tokens; then serve the same batch again on
    the same engine under torch.profiler, device activity only, for the
    device's busy time (its idle share is over the unprofiled wall time of
    the same batch: the profiler slows the host, not the device), unless
    not `profiled`.  `encs`: an encoder-decoder's encoder inputs, one per
    prompt.  The engine's graph count must not move while it serves."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profile import device_time

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    graphs = eng.backend.graph_count()
    for mod in counted.values():
        mod.launches = 0
    t0 = time.perf_counter()
    reqs = _serve_batch(eng, prompts, encs)
    wall = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in counted.items()}
    st = eng.stats
    ticks, host_s, device_s = st.ticks, st.host_s, st.device_s
    phase_ticks = (st.prefill_ticks, st.decode_ticks)
    ring = {"pp": eng.cfg.plan.pp, "bubble_stage_ticks": st.bubble_stage_ticks,
            "padded_prefill": st.padded_prefill,
            "padded_decode": st.padded_decode}
    want = _launch_want(eng.cfg, ticks, *phase_ticks, counted)
    if launches != want:
        raise AssertionError(f"{phase}: launches {launches} for {ticks} "
                             f"ticks ({phase_ticks[0]} with prefill rows, "
                             f"{phase_ticks[1]} with decode rows), want "
                             f"{want}")
    vocab = eng.cfg.vocab_size
    for i, r in enumerate(reqs):
        if not (r.is_finished and r.num_output_tokens == MAX_NEW and all(
                0 <= t < vocab for t in r.output_token_ids)):
            raise AssertionError(f"{phase}: request {i} did not finish with "
                                 f"{MAX_NEW} valid tokens")
    out_tokens = sum(r.num_output_tokens for r in reqs)
    prompt_tokens = sum(len(p) for p in prompts)
    peak = torch.cuda.max_memory_allocated()

    busy_us = by_kernel = profiled_wall = None
    profiled_ticks = eng.stats.ticks
    if profiled:
        t1 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _serve_batch(eng, prompts, encs)
        profiled_wall = time.perf_counter() - t1
        busy_us, by_kernel = device_time(prof)
    if eng.backend.graph_count() != graphs:
        raise AssertionError(f"{phase}: {eng.backend.graph_count()} graphs "
                             f"after serving, {graphs} after warm_start")
    ranked = sorted((by_kernel or {}).items(), key=lambda kv: -kv[1])
    # the six largest, and the port's own kernels wherever they rank
    top = ranked[:6] + [kv for kv in ranked[6:]
                        if any(k in kv[0] for k in PORT_KERNELS)]
    backend = eng.backend
    return {"phase": phase, "variant": variant, "arch": eng.cfg.name,
            "bucketed": backend.bucketed,
            "async_dispatch": eng.loop.async_dispatch,
            "cuda_graphs": backend.graphs, "ladder": len(backend.ladder),
            "graphs_captured": graphs, "capture_s": backend.capture_s,
            "graph_pool_bytes": backend.graph_pool_bytes,
            "layers": eng.cfg.num_layers, "requests": len(reqs),
            "temperature_requests": sum(1 for i in range(len(reqs))
                                        if i % 8 == 7),
            "prompt_tokens": prompt_tokens, "output_tokens": out_tokens,
            "wall_s": wall, "output_tokens_per_s": out_tokens / wall,
            "total_tokens_per_s": (out_tokens + prompt_tokens) / wall,
            "ticks": ticks, "prefill_ticks": phase_ticks[0],
            "decode_ticks": phase_ticks[1], "ms_per_tick": wall / ticks * 1e3,
            **ring,
            "host_s": host_s, "device_s": device_s, "launches": launches,
            "max_memory_allocated": peak,
            "profiled_ticks": eng.stats.ticks - profiled_ticks,
            "profiled_wall_s": profiled_wall,
            "device_busy_s": None if busy_us is None else busy_us / 1e6,
            "device_idle_share": (None if busy_us is None
                                  else 1.0 - busy_us / 1e6 / wall),
            "device_ms_by_kernel": [{"name": k[:80], "ms": v / 1e3}
                                    for k, v in top]}


def phase_serve_bf16(pa, build_engine) -> tuple:
    """Returns the graph variant's line and its engine's `_spec`, whose
    weights the trace-bf16 phase serves again."""
    return _serve_bf16(
        lambda: build_engine(ARCH, device=DEV, dtype=torch.bfloat16,
                             cuda_graphs=False),
        {"paged_flash_attention": pa}, "serve-bf16", keep=True)


def _launch_want(cfg, ticks: int, prefill_ticks: int, decode_ticks: int,
                 counted: dict) -> dict:
    """The launches each kernel of `counted` (by wrapper name) makes in
    `ticks` ticks of which `prefill_ticks` ran a bucket with prefill rows
    and `decode_ticks` one with decode rows: paged attention and the two
    scans once per layer of theirs for each phase a tick runs, the MoE
    kernel once per MoE layer a tick.  Unbucketed (Sp=1, Sd=32) every tick
    runs both phases.  At pp = S a tick runs all S stages: their layers are
    the stage pattern S times over (padding layers past `num_layers`
    dropped)."""
    kinds = [b.kind.value for b in cfg.pattern
             for _ in range(b.repeat)] * cfg.plan.pp
    kinds = kinds[:cfg.num_layers]
    phases = prefill_ticks + decode_ticks
    want = {"paged_flash_attention": phases * sum(
                k in ("attn_mlp", "attn_moe", "dec_layer") for k in kinds),
            "fused_moe_ffn": ticks * sum(k.endswith("_moe") for k in kinds),
            "rwkv6_chunked_scan": phases * kinds.count("rwkv"),
            "mamba_chunked_scan": phases * sum(k.startswith("mamba")
                                               for k in kinds)}
    return {name: want[name] for name in counted}


def _free() -> None:
    """Return the memory of dropped engines (caches, graph pools) to the
    card."""
    gc.collect()
    torch.cuda.empty_cache()


def _spec(eng) -> tuple:
    """What a sibling of `eng` needs: (config, dims, weights, throttle,
    dtype)."""
    return (eng.cfg, eng.dims, eng.params, eng.scheduler.cfg,
            eng.backend.dtype)


def _sibling(spec: tuple, **kw):
    """An engine from `_spec`'s tuple with the engine options `kw`, built
    once the dropped engines' memory is back; returns (engine, seconds to
    build it, warm_start included)."""
    from repro_torch.runtime.engine import PipelineEngine

    cfg, dims, params, throttle, dtype = spec
    _free()
    t0 = time.perf_counter()
    eng = PipelineEngine(cfg, dims, params, throttle, device=DEV,
                         dtype=dtype, seed=0, **kw)
    return eng, time.perf_counter() - t0


def _serve_bf16(make, counted: dict, phase: str, keep: bool = False):
    """serve-bf16's batch on the eager engine `make()` builds (sync,
    unbucketed, the earlier slices' engine), then on a bucketed async
    engine replaying one CUDA graph per bucket (the JAX package's fastest
    configuration) from the same weights.  Emits one line per variant;
    returns the graph variant's line (with `keep`, and the last engine's
    `_spec`)."""
    eng = make()
    prompts = _prompts(12, 32, eng.cfg.vocab_size)
    out = {}
    for name, kw in BF16_VARIANTS.items():
        build_s = None
        if name != "eager":
            spec, eng = _spec(eng), None
            eng, build_s = _sibling(spec, **kw)
        # the profiler slows the eager engine's host ~4.6x (16.6 s against
        # 3.6 s for serve-bf16's batch): only the graph variant reruns
        out = _serve_measured(eng, prompts, counted, phase, name,
                              profiled=name != "eager")
        out["engine_build_s"] = build_s
        out["capacity_factor"] = eng.cfg.moe_capacity_factor
        out["kinds"] = [b.kind.value for b in eng.cfg.pattern]
        emit(out)
    spec = _spec(eng) if keep else None
    del eng
    _free()
    return (out, spec) if keep else out


def _f32_variants(phase: str, make, serve, counted: dict):
    """Serve with `serve(eng)` (which returns a dict holding the requests
    under "reqs") on the eager engine `make()` builds, then on graph
    engines, sync and async, from the same weights; each kernel of `counted` must launch
    as `_launch_want` says, every variant must give the same greedy
    tokens.  Returns (per-variant numbers, the last engine, what its
    `serve` returned)."""
    runs, tokens = {}, {}
    eng = make()
    for name, kw in F32_VARIANTS.items():
        build_s = None
        if name != "eager":
            spec, eng = _spec(eng), None
            eng, build_s = _sibling(spec, **kw)
        for mod in counted.values():
            mod.launches = 0
        t0 = time.perf_counter()
        res = serve(eng)
        torch.cuda.synchronize()
        st = eng.stats
        launches = {k: mod.launches for k, mod in counted.items()}
        want = _launch_want(eng.cfg, st.ticks, st.prefill_ticks,
                            st.decode_ticks, counted)
        if launches != want:
            raise AssertionError(f"{phase} {name}: launches {launches} for "
                                 f"{st.ticks} ticks, want {want}")
        runs[name] = {"ticks": st.ticks, "prefill_ticks": st.prefill_ticks,
                      "decode_ticks": st.decode_ticks, "launches": launches,
                      "graphs": eng.backend.graph_count(),
                      "ladder": len(eng.backend.ladder),
                      "engine_build_s": build_s,
                      "serve_s": time.perf_counter() - t0,
                      **{k: v for k, v in res.items()
                         if k not in ("reqs", "prompts", "encs")}}
        tokens[name] = [r.output_token_ids for r in res["reqs"]]
    if any(t != tokens["eager"] for t in tokens.values()):
        raise AssertionError(f"{phase}: the variants' greedy tokens differ: "
                             f"{tokens}")
    return runs, eng, res


# ------------------------------------------------- trace and simulator

def _tick_ms(ticks) -> list:
    """The duration (ms) of every tick of a trace but the last: the next
    tick's `now` less its own (a sync engine reads each tick's tokens back
    inside it; the simulator starts the next tick when its stage is
    free)."""
    nows = [r["now"] for r in ticks]
    return [(b - a) * 1e3 for a, b in zip(nows, nows[1:])]


def _by_kind(ticks, ms) -> dict:
    """Mean ms of the ticks whose batch holds prefill rows, and of the
    decode-only ones."""
    pre = [m for r, m in zip(ticks, ms) if r["batch"] and r["batch"]["prefill"]]
    dec = [m for r, m in zip(ticks, ms)
           if r["batch"] and not r["batch"]["prefill"]]
    return {"prefill_ticks": len(pre),
            "prefill_ms_mean": float(np.mean(pre)) if pre else None,
            "decode_only_ticks": len(dec),
            "decode_only_ms_mean": float(np.mean(dec)) if dec else None}


def phase_trace_bf16(pa, spec: tuple) -> dict:
    """serve-bf16's batch on qwen1.5-0.5b bf16 (serve-bf16's weights), on a
    bucketed sync graph engine: untraced three times, the last after the
    batch on a twin engine with `trace_path` (traces refuse async); the
    recorder's cost is the traced run's tokens/s against the mean of the
    untraced runs just before and after it (the first warms the process
    up).  The traced run must launch paged attention as `_launch_want`
    says and take the untraced run's ticks;
    strict replay of its file (`check_trace`) must round-trip byte for byte
    and give the live run's tokens.  Prints the recorder's cost in tokens/s,
    the trace's raw and compacted bytes, `host_s` per tick and the
    `RuntimeModel` fitted at overlap 0.  Returns what sim-h100 needs."""
    import tempfile

    from repro_torch.runtime.simulator import RuntimeModel
    from repro_torch.runtime.trace import (Trace, check_trace,
                                           compact_records, dumps_record,
                                           host_overhead_samples)

    counted = {"paged_flash_attention": pa}
    prompts = _prompts(12, 32, spec[0].vocab_size)

    def serve(eng, name):
        st = eng.stats
        before = (st.ticks, st.prefill_ticks, st.decode_ticks)
        for mod in counted.values():
            mod.launches = 0
        t0 = time.perf_counter()
        reqs = _serve_batch(eng, prompts)
        wall = time.perf_counter() - t0
        launches = {k: mod.launches for k, mod in counted.items()}
        ticks, prefill_ticks, decode_ticks = (
            a - b for a, b in zip((st.ticks, st.prefill_ticks,
                                   st.decode_ticks), before))
        want = _launch_want(eng.cfg, ticks, prefill_ticks, decode_ticks,
                            counted)
        if launches != want:
            raise AssertionError(f"trace-bf16 {name}: launches {launches} "
                                 f"for {st.ticks} ticks, want {want}")
        out_tokens = sum(r.num_output_tokens for r in reqs)
        if out_tokens != MAX_NEW * len(prompts):
            raise AssertionError(f"trace-bf16 {name}: {out_tokens} tokens")
        return reqs, {"ticks": ticks, "wall_s": wall,
                      "output_tokens_per_s": out_tokens / wall,
                      "ms_per_tick": wall / ticks * 1e3,
                      "launches": launches}

    plain, plain_build_s = _sibling(spec, bucketed=True)
    _, untraced_first = serve(plain, "untraced first")
    plain_reqs, untraced = serve(plain, "untraced before")
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "serve-bf16.trace.jsonl")
        eng, build_s = _sibling(spec, bucketed=True, trace_path=path)
        graphs = eng.backend.graph_count()
        reqs, traced = serve(eng, "traced")
        eng.recorder.close()
        _, untraced_after = serve(plain, "untraced after")
        del plain
        if eng.backend.graph_count() != graphs:
            raise AssertionError("trace-bf16: serving captured a graph")
        if traced["ticks"] != untraced["ticks"]:
            raise AssertionError(f"trace-bf16: {traced['ticks']} ticks "
                                 f"traced, {untraced['ticks']} untraced")
        live = {r.request_id: list(r.output_token_ids) for r in reqs}
        raw = Path(path).read_text()
        t0 = time.perf_counter()
        report = check_trace(path)        # strict replay, byte identity
        check_s = time.perf_counter() - t0
    if report.outputs() != live:
        raise AssertionError("trace-bf16: the replay's tokens differ from "
                             "the live run's")
    trace = Trace.loads(raw)
    records = [json.loads(line) for line in raw.splitlines()]
    compacted = "".join(dumps_record(r) + "\n"
                        for r in compact_records(records))
    host = np.array(host_overhead_samples(trace)) * 1e3
    fitted = RuntimeModel.fit_from_trace(trace, overlap_fraction=0.0)
    measured = _tick_ms(trace.ticks)
    greedy = [i for i in range(len(prompts)) if i % 8 != 7]
    out = {"phase": "trace-bf16", "arch": ARCH, "layers": LAYERS,
           "requests": len(prompts), "engine": "graphs sync",
           "ladder": len(eng.backend.ladder), "graphs_captured": graphs,
           "engine_build_s": build_s, "untraced_build_s": plain_build_s,
           "untraced_first": untraced_first, "untraced_before": untraced,
           "traced": traced, "untraced_after": untraced_after,
           "recorder_cost": 1.0 - traced["output_tokens_per_s"] / np.mean(
               [r["output_tokens_per_s"] for r in (untraced,
                                                   untraced_after)]),
           "untraced_spread": abs(untraced["output_tokens_per_s"]
                                  - untraced_after["output_tokens_per_s"])
           / np.mean([r["output_tokens_per_s"] for r in (untraced,
                                                         untraced_after)]),
           "greedy_tokens_equal_untraced": all(
               reqs[i].output_token_ids == plain_reqs[i].output_token_ids
               for i in greedy),
           "trace_ticks": len(trace.ticks),
           "trace_records": len(records), "trace_bytes": len(raw.encode()),
           "compact_bytes": len(compacted.encode()),
           "host_ms_per_tick": {"mean": float(host.mean()),
                                "p50": float(np.percentile(host, 50)),
                                "p90": float(np.percentile(host, 90)),
                                "max": float(host.max())},
           "fit_overhead_serial_ms": fitted.overhead_serial * 1e3,
           "fit_overhead_overlap_ms": fitted.overhead_overlap * 1e3,
           "tick_ms": {"mean": float(np.mean(measured)),
                       **_by_kind(trace.ticks, measured)},
           "check_trace_s": check_s, "replay_ticks": report.ticks,
           "replay_equals_live": True}
    emit(out)
    del eng
    _free()
    return {"trace": trace, "outputs": report.outputs(), "traced": traced,
            "runtime": fitted}


def phase_sim_h100(traced: dict) -> dict:
    """The port's simulator on trace-bf16's run: the scheduler rebuilt
    from the trace's header (the engine's caps), the roofline cost model of
    qwen1.5-0.5b at pp=1 with page-billed attention at the card's rates,
    the `RuntimeModel` fitted on the trace, and the same 32 arrivals at
    t = 0, each with the output length its request had on the card.  Its
    batches must equal the trace's tick for tick.  Prints predicted ms per
    tick and output tokens/s beside the measured ones, and their ratios;
    no bound is put on them."""
    from repro_torch.configs import get_config
    from repro_torch.roofline import analysis
    from repro_torch.runtime.simulator import PipelineSimulator, cost_model_for
    from repro_torch.runtime.trace import scheduler_from_header

    trace = traced["trace"]
    page = trace.header["kv"]["page_size"]
    cost = cost_model_for(get_config(ARCH), pp=1, page_size=page)
    sim = PipelineSimulator(scheduler_from_header(trace.header), trace.depth,
                            cost, traced["runtime"])
    sim.attach_trace(None)
    t0 = time.perf_counter()
    for rec in trace.requests:
        sim.inject_request(0.0, rec["prompt"],
                           len(traced["outputs"][rec["rid"]]))
    metrics = sim.run()
    sim_s = time.perf_counter() - t0
    simulated = sim.recorder.trace()
    names = {a["rid"]: b["rid"]           # the same admission order
             for a, b in zip(simulated.requests, trace.requests)}

    def batches(tr, rename):
        return [None if r["batch"] is None else
                ([[rename.get(e[0], e[0])] + e[1:]
                  for e in r["batch"]["prefill"]],
                 [[rename.get(e[0], e[0])] + e[1:]
                  for e in r["batch"]["decode"]]) for r in tr.ticks]

    want, got = batches(trace, {}), batches(simulated, names)
    if got != want:
        first = next((k for k, (a, b) in enumerate(zip(got, want))
                      if a != b), min(len(got), len(want)))
        raise AssertionError(f"sim-h100: {len(got)} simulated ticks, "
                             f"{len(want)} on the card; first difference "
                             f"at tick {first}")
    ticks = len(want)
    predicted = _tick_ms(simulated.ticks)
    measured = _tick_ms(trace.ticks)
    pred_ms = metrics.sim_time / ticks * 1e3
    meas_ms = traced["traced"]["ms_per_tick"]
    out_tokens = metrics.total_output_tokens
    pred_tps = out_tokens / metrics.sim_time
    meas_tps = traced["traced"]["output_tokens_per_s"]
    out = {"phase": "sim-h100", "arch": ARCH, "pp": 1, "page_size": page,
           "hbm_bytes_per_s": analysis.HBM_BW,
           "peak_flops_bf16": analysis.PEAK_FLOPS,
           "mfu": cost.mfu, "hbm_eff": cost.hbm_eff,
           "fixed_us": cost.fixed_us,
           "runtime_overhead_serial_ms":
               traced["runtime"].overhead_serial * 1e3,
           "ticks": ticks, "batches_equal": True,
           "output_tokens": out_tokens,
           "predicted_ms_per_tick": pred_ms,
           "measured_ms_per_tick": meas_ms,
           "ms_per_tick_ratio": pred_ms / meas_ms,
           "predicted_output_tokens_per_s": pred_tps,
           "measured_output_tokens_per_s": meas_tps,
           "tokens_per_s_ratio": pred_tps / meas_tps,
           "predicted": _by_kind(simulated.ticks, predicted),
           "measured": _by_kind(trace.ticks, measured),
           "simulate_s": sim_s}
    emit(out)
    return out


# ------------------------------------------------------- pipeline phases

def _pool_addresses(eng) -> dict:
    """The addresses of the engine's KV and state pools and of its ring's
    carry: the CUDA graphs replay on these very tensors."""
    out = {f"{gk}/{n}": a.data_ptr()
           for gk, grp in eng.backend.caches.items() for n, a in grp.items()}
    out.update({f"carry/{k}": a.data_ptr()
                for k, a in (eng.backend.carry or {}).items()})
    return out


def phase_serve_pp_f32(pa, build_engine, greedy_trace) -> dict:
    """serve-f32's batch on qwen1.5-0.5b in PP stages, on serve-f32's three
    engines: identical greedy tokens, equal to the dense reference up to a
    near-tie; launches per replay as `_launch_want` says at depth PP; the
    graph count and the pool and carry addresses unchanged by serving."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    prompts = _prompts(11, 8, get_config(ARCH).vocab_size)

    def serve(eng):
        graphs, pools = eng.backend.graph_count(), _pool_addresses(eng)
        reqs = [eng.add_request(p, _sampling(0.0)) for p in prompts]
        eng.drain()
        if (eng.backend.graph_count(), _pool_addresses(eng)) != (graphs,
                                                                 pools):
            raise AssertionError("serve-pp-f32: serving captured a graph or "
                                 "moved a pool")
        st = eng.stats
        return {"reqs": reqs, "bubble_stage_ticks": st.bubble_stage_ticks,
                "padded_prefill": st.padded_prefill,
                "padded_decode": st.padded_decode}

    runs, eng, last = _f32_variants(
        "serve-pp-f32", lambda: build_engine(ARCH, device=DEV,
                                             dtype=torch.float32,
                                             cuda_graphs=False, pp=PP),
        serve, {"paged_flash_attention": pa})
    if eng.cfg.plan.pp != PP or eng.scheduler.cfg.pipeline_depth != PP:
        raise AssertionError(f"serve-pp-f32: served at pp={eng.cfg.plan.pp}")
    serve_s = time.perf_counter() - t0
    compared, near_ties = _match_reference("serve-pp-f32", eng, prompts,
                                           last["reqs"], MAX_NEW,
                                           greedy_trace)
    out = {"phase": "serve-pp-f32", "arch": ARCH, "layers": LAYERS,
           "pp": PP, "layers_per_stage": eng.cfg.layers_per_stage,
           "requests": len(prompts), "prompt_lens": [len(p) for p in prompts],
           "max_new_tokens": MAX_NEW, "variants": runs,
           "tokens_compared": compared, "near_ties": near_ties,
           "serve_and_check_s": serve_s,
           "check_s": time.perf_counter() - t0 - serve_s}
    emit(out)
    del eng
    _free()
    return out


def phase_serve_pp_bf16(pa, build_engine, arch: str = PP_ARCH,
                        phase: str = "serve-pp-bf16",
                        profiled=(1, PP), layers: int = 0) -> dict:
    """`arch` at full width and depth (cut to its first `layers` when > 0)
    in bf16, serve-bf16's batch on a
    bucketed async graph engine at pp=1, then on one at pp=PP whose weights
    are views of the first's (`repartition_params`; the pp=1 engine, its
    KV pool and graphs freed first), each measured by `_serve_measured`,
    with a profiled rerun at the stage counts in `profiled`.  Returns
    {pp: its line}."""
    from repro_torch.configs import stage_config
    from repro_torch.core import ThrottleConfig
    from repro_torch.distributed.elastic import repartition_params
    from repro_torch.runtime.engine import PipelineEngine

    counted = {"paged_flash_attention": pa}
    _free()
    t0 = time.perf_counter()
    kw = dict(bucketed=True, async_dispatch=True)
    eng = _cut_engine(arch, layers, **kw) if layers else build_engine(
        arch, device=DEV, dtype=torch.bfloat16, **kw)
    build_s = time.perf_counter() - t0
    one, params = eng.cfg, eng.params
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in params.parameters())
    prompts = _prompts(12, 32, one.vocab_size)
    rows = {}
    for pp in (1, PP):
        if pp != 1:
            dims = eng.dims
            del eng
            _free()
            cfg = stage_config(one, pp)
            staged = repartition_params(params, one, cfg)
            if any(a.data_ptr() != b.data_ptr() for a, b in zip(
                    staged.parameters(), params.parameters())):
                raise AssertionError(f"{phase}: the staged weights are "
                                     f"not views of the pp=1 weights")
            t0 = time.perf_counter()
            eng = PipelineEngine(cfg, dims, staged,
                                 ThrottleConfig(pipeline_depth=pp),
                                 device=DEV, dtype=torch.bfloat16, seed=0,
                                 bucketed=True, async_dispatch=True)
            build_s = time.perf_counter() - t0
        out = _serve_measured(eng, prompts, counted, phase, f"pp{pp}",
                              profiled=pp in profiled)
        out.update(engine_build_s=build_s, weight_bytes=weight_bytes,
                   layers_per_stage=eng.cfg.layers_per_stage,
                   throttle_depth=eng.scheduler.cfg.pipeline_depth)
        emit(out)
        rows[pp] = out
    del eng, params
    _free()
    return rows


# ------------------------------------------------------------ MoE phases

def _moe_case(E, C, d, ff, dtype, seed, top_k=0):
    """Unit-variance rows (the normed hidden) and the serve path's weight
    scale (0.02), on the card.  With `top_k`, a decode tick: counts [E]
    int32 drawn as 32 decode rows x top_k routed uniformly over the experts
    (~4 a expert at olmoe's and jamba's top-k), two experts empty, and the
    rows past counts NaN; the counts are appended to the arguments."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn(E, C, d, generator=g, device=DEV).to(dtype)
    ws = [(torch.randn(*s, generator=g, device=DEV) * 0.02).to(dtype)
          for s in ((E, d, ff), (E, d, ff), (E, ff, d))]
    if not top_k:
        return [x] + ws
    rng = np.random.default_rng(seed)
    counts = rng.multinomial(32 * top_k, np.full(E, 1.0 / E))
    counts[rng.choice(E, 2, replace=False)] = 0
    counts = torch.from_numpy(np.minimum(counts, C).astype(np.int32)).to(DEV)
    dead = torch.arange(C, device=DEV)[None, :] >= counts[:, None].long()
    x[dead] = float("nan")
    return [x] + ws + [counts]


def _moe_bound(x, w_gate, w_up, w_down, counts=None):
    """Least time the card could take: the weights of the experts that hold
    any row read once, x read and out written for the live rows only, at the
    HBM rate, against 6 * (live rows) * d * ff flops at the peak of the
    operations the kernel does (bf16: the tensor cores; f32: three TF32
    tensor-core products per product, split TF32).  Without counts every
    row is live."""
    E, C, d = x.shape
    ff = w_gate.shape[2]
    elt = x.element_size()
    if counts is None:
        rows, experts = E * C, E
    else:
        rows, experts = int(counts.sum()), int((counts > 0).sum())
    nbytes = (2 * rows * d + experts * 3 * d * ff) * elt
    flops = 6 * rows * d * ff
    if x.dtype == torch.float32:
        t_ops = 3 * flops / PEAK_FLOPS["tfloat32"] * 1e3
    else:
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


def _moe_library_fn(x, w_gate, w_up, w_down, counts=None):
    """The batched-GEMM sequence of the JAX package's non-kernel path
    (models/moe.py: gate and up products, silu * mul, down product) as
    torch.bmm calls in x's dtype, rows past counts masked to zero; never
    called by the port."""
    import torch.nn.functional as F

    live = None
    if counts is not None:
        live = (torch.arange(x.shape[1], device=x.device)[None, :]
                < counts[:, None])[..., None]

    def run():
        h = F.silu(torch.bmm(x, w_gate)) * torch.bmm(x, w_up)
        out = torch.bmm(h, w_down)
        return out if live is None else torch.where(live, out, 0.0)
    return run


def _moe_excess(mg, out, args, experts: int = 4):
    """`moe_gemm.excess` a few experts at a time (each expert's rows depend
    on its own weights only), so that the check's f32 copies of jamba's
    weights stay a few GB: (worst excess, max abs err) over all."""
    E = out.shape[0]
    parts = [mg.excess(out[e:e + experts], *(a[e:e + experts] for a in args))
             for e in range(0, E, experts)]
    return max(p[0] for p in parts), max(p[1] for p in parts)


def _device_spans(fn, calls: int) -> list:
    """(start_us, end_us, name, grid) of every device activity, in order,
    of `calls` calls of `fn` after one warm call: the exported trace of a
    torch.profiler run that records the card only."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    return sorted((e["ts"], e["ts"] + e["dur"], e.get("name", ""),
                   e.get("args", {}).get("grid"))
                  for e in events if e.get("ph") == "X")


def _launch_gap_us(fn, calls: int = 3):
    """Device time from the end of the gate/up launch to the start of the
    down launch of a call of `fn`, the least over `calls` calls (None if
    the trace names no such pair)."""
    spans = [(a, b, "<true>" in name)
             for a, b, name, _ in _device_spans(fn, calls)
             if "moe_wgmma_kernel<" in name]
    gaps = [n[0] - p[1] for p, n in zip(spans, spans[1:]) if p[2] and not n[2]]
    return min(gaps) if gaps else None


def phase_moe_kernel(mg, planted_src: str, tf32_src: str) -> list:
    shapes = [
        # name, E, C, d, ff, top_k of a decode tick (0: every row live)
        ("olmoe serve", 64, 88, 2048, 1024, 0),
        ("olmoe ragged C", 64, 24, 2048, 1024, 0),
        ("small", 8, 16, 256, 256, 0),
        ("olmoe decode tick", 64, 88, 2048, 1024, 8),
        # bf16 only: 19.3 GB of weights (38.7 GB in f32).  The planted
        # fault drops one ff tile, 64 of the down sum's 24,576 terms
        ("jamba serve", 16, 88, 8192, 24576, 0),
        ("jamba decode tick", 16, 88, 8192, 24576, 2),
        # bf16 only: kimi-k2's 384 experts (33.8 GB), C = 16 from the
        # serve batch's 544 rows at top-8 and capacity factor 1.25; the
        # decode tick routes 32 x 8 rows, most experts empty
        ("kimi-k2 serve", 384, 16, 7168, 2048, 0),
        ("kimi-k2 decode tick", 384, 16, 7168, 2048, 8),
        # one tensor rank's ff columns of every expert (bf16 only,
        # `TP_ROWS`): olmoe-1b-7b at tp=4, jamba at tp=2.  The planted
        # fault drops 64 of olmoe's 256 down terms, 64 of jamba's 12,288
        ("olmoe tp=4 serve", 64, 88, 2048, 256, 0),
        ("jamba tp=2 serve", 16, 88, 8192, 12288, 0),
        # one expert-parallel rank's experts at its ff columns (`EP_ROWS`):
        # 8.5 GB (kimi-k2) and 4.8 GB (jamba) of weights
        ("kimi-k2 ep dp=2 tp=2 prefill", 192, 40, 7168, 1024, 0),
        ("kimi-k2 ep dp=2 tp=2 decode tick", 192, 8, 7168, 1024, 8),
        ("jamba ep dp=2 tp=2 serve", 8, 216, 8192, 12288, 0),
    ]
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        rtol, htol, acc = mg.TOLERANCE[dtype]
        f32 = dtype == torch.float32
        for name, E, C, d, ff, top_k in shapes:
            if (E * d * ff > 1 << 30 or name in TP_ROWS
                    or name in EP_ROWS) and f32:
                continue
            args = _moe_case(E, C, d, ff, dtype, seed=100 + len(results),
                             top_k=top_k)
            out = mg.fused_moe_ffn(*args)
            planted = mg.launch(MOE_PLANTED, *args, source=planted_src)
            torch.cuda.synchronize()
            excess, err = _moe_excess(mg, out, args)
            planted_excess, _ = _moe_excess(mg, planted, args)
            del planted
            finite = bool(torch.isfinite(out).all())
            row = {"phase": "moe-kernel", "shape": name,
                   "dtype": str(dtype).split(".")[-1], "E": E, "C": C,
                   "d": d, "ff": ff, "max_abs_err": err, "rtol": rtol,
                   "htol": htol, "acc": acc, "excess": excess,
                   "planted_excess": planted_excess, "finite": finite}
            if top_k:
                counts = args[4]
                live = (torch.arange(C, device=DEV)[None, :]
                        < counts[:, None])
                row["counts"] = counts.tolist()
                row["dead_rows_zero"] = bool((out[~live] == 0).all())
                finite = bool(torch.isfinite(out[live]).all())
                row["finite"] = finite and row["dead_rows_zero"]
            if f32:
                single = mg.launch(MOE_TF32_PLANTED, *args, source=tf32_src)
                torch.cuda.synchronize()
                row["planted_tf32_excess"] = _moe_excess(mg, single, args)[0]
                del single
            if not (excess <= 1.0 and row["finite"]):
                emit(row)
                raise AssertionError(f"MoE kernel disagrees with its plain "
                                     f"version at {name} {dtype}: {row}")
            if not planted_excess > 1.0:
                emit(row)
                raise AssertionError(f"the check passes an MoE kernel whose "
                                     f"ff loop stops one tile early at "
                                     f"{name} {dtype}: {row}")
            if f32 and name == "small" and not row["planted_tf32_excess"] > 1:
                emit(row)
                raise AssertionError(f"the check passes an MoE kernel on "
                                     f"single TF32 at {name}: {row}")
            row["kernel_ms"] = time_ms(lambda: mg.fused_moe_ffn(*args), 20)
            row["plain_ms"] = time_ms(
                lambda: mg.fused_moe_ffn_ref(*args), 3, warmup=1)
            row["library_ms"] = time_ms(_moe_library_fn(*args), 20)
            row["library"] = ("torch.bmm gate, torch.bmm up, silu * mul, "
                              "torch.bmm down (a sequence of calls)")
            (row["bound_ms"], row["bound_by"], row["bytes"],
             row["flops"]) = _moe_bound(*args)
            if not f32:
                row["launch_gap_us"] = _launch_gap_us(
                    lambda: mg.fused_moe_ffn(*args))
            emit(row)
            results.append(row)
            del args, out
            torch.cuda.empty_cache()
    return results


def _f32_engine(arch: str, layers: int = 0, kinds=()):
    """Full-width `arch` cut to its first `layers` layers (a uniform
    pattern), to the first layer of each of `kinds` (`cut_to_kinds`), or at
    full depth with neither, f32, smaller serve dims (an encoder-decoder's
    at `launch.serve.ENC_FRAMES` encoder frames); an MoE config is made
    dropless (capacity factor = number of experts), so that the serve
    matches the dense reference.  The eager engine (`_f32_variants` builds
    the graph engines from it)."""
    import dataclasses

    from repro_torch.configs import (
        BlockKind,
        BlockSpec,
        cut_to_kinds,
        get_config,
        single_stage,
    )
    from repro_torch.core import ThrottleConfig
    from repro_torch.launch.serve import ENC_FRAMES
    from repro_torch.models.serve import ServeDims
    from repro_torch.models.transformer import init_params
    from repro_torch.runtime.engine import PipelineEngine

    cfg = single_stage(get_config(arch))
    if kinds:
        cfg = cut_to_kinds(cfg, [BlockKind(k) for k in kinds])
    elif layers:
        cfg = dataclasses.replace(
            cfg, num_layers=layers,
            pattern=(BlockSpec(cfg.pattern[0].kind, layers),))
    cfg = dataclasses.replace(
        cfg, dtype="float32",
        moe_capacity_factor=(float(cfg.num_experts) if cfg.is_moe
                             else cfg.moe_capacity_factor))
    dims = ServeDims(Sp=1, C=128, Sd=8, pages=256, page=16, Bp=32, Bd=32,
                     slots=16, Te=ENC_FRAMES if cfg.is_encoder_decoder else 0)
    params = init_params(cfg, 0, dtype=torch.float32, device=DEV)
    return PipelineEngine(cfg, dims, params, ThrottleConfig(pipeline_depth=1),
                          device=DEV, dtype=torch.float32, seed=0,
                          cuda_graphs=False)


def phase_serve_olmoe_f32(pa, mg, greedy_trace) -> dict:
    from repro_torch.core import SamplingParams
    from repro_torch.models import moe as moe_lib

    max_new = 8
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    rng = np.random.default_rng(13)
    lens = [16, 300] + [int(x) for x in rng.integers(16, 301, 2)]
    vocab = get_config(MOE_ARCH).vocab_size
    prompts = [[int(t) for t in rng.integers(0, vocab, L)] for L in lens]

    def serve(eng):
        reqs = [eng.add_request(p, SamplingParams(max_new_tokens=max_new))
                for p in prompts]
        eng.drain()
        return {"reqs": reqs}

    runs, eng, last = _f32_variants(
        "serve-olmoe-f32", lambda: _f32_engine(MOE_ARCH, MOE_F32_LAYERS),
        serve,
        {"paged_flash_attention": pa, "fused_moe_ffn": mg})
    serve_s = time.perf_counter() - t0
    # the reference's expert FFN runs on the plain version, so the kernel
    # is not held against itself
    kernel_ffn = moe_lib.expert_ffn
    moe_lib.expert_ffn = mg.fused_moe_ffn_ref
    try:
        compared, near_ties = _match_reference(
            "serve-olmoe-f32", eng, prompts, last["reqs"], max_new,
            greedy_trace)
    finally:
        moe_lib.expert_ffn = kernel_ffn
    out = {"phase": "serve-olmoe-f32", "arch": MOE_ARCH,
           "layers": MOE_F32_LAYERS,
           "capacity_factor": eng.cfg.moe_capacity_factor,
           "requests": len(prompts), "prompt_lens": lens,
           "max_new_tokens": max_new, "variants": runs,
           "tokens_compared": compared, "near_ties": near_ties,
           "serve_s": serve_s, "check_s": time.perf_counter() - t0 - serve_s}
    emit(out)
    del eng
    _free()
    return out


def phase_serve_olmoe_bf16(pa, mg) -> dict:
    """serve-bf16's batch on full-width olmoe-1b-7b cut to
    MOE_BF16_LAYERS of its 16 layers."""
    return _serve_bf16(
        lambda: _cut_engine(MOE_ARCH, MOE_BF16_LAYERS, cuda_graphs=False),
        {"paged_flash_attention": pa, "fused_moe_ffn": mg},
        "serve-olmoe-bf16")


# ----------------------------------------------------------- RWKV phases

RWKV_DECAY = (-6.0, 3.0)      # log w = -exp(U(lo, hi)): ~2e-9 to ~0.998
RWKV_STRONG = (-20.0, 10.0)   # the serve clamp's whole range: exact 0 and
                              # exact 1 among them


def _rwkv_case(S, T, H, lens, fresh, n_slots, dtype, seed, decay=RWKV_DECAY):
    """Unit-normal r, k, v in `dtype`, u uniform in [0, 1), decay
    w = exp(-exp(U(*decay))), on the card.  Live rows hold distinct slots,
    and where there are padding rows (lens 0) they sit on slot 0, which a
    live row holds.  The pool is NaN except the slots of the live rows that
    carry a state."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    D = 64
    lo, hi = decay
    r, k, v = (torch.randn(S, T, H, D, generator=g, device=DEV).to(dtype)
               for _ in range(3))
    w = torch.exp(-torch.exp(torch.rand(S, T, H, D, generator=g, device=DEV)
                             * (hi - lo) + lo))
    u = torch.rand(H, D, generator=g, device=DEV)
    rng = np.random.default_rng(seed)
    live = [s for s in range(S) if lens[s] > 0]
    slots = np.zeros(S, np.int32)
    chosen = rng.choice(np.arange(1, n_slots), len(live), replace=False)
    if len(live) < S:
        chosen[0] = 0
    slots[live] = chosen
    state = torch.full((n_slots, H, D, D), float("nan"), device=DEV)
    for s in live:
        if not fresh[s]:
            state[int(slots[s])] = 3.0 * torch.randn(
                H, D, D, generator=g, device=DEV)
    ints = [torch.tensor(a, dtype=torch.int32, device=DEV)
            for a in (slots, lens, fresh)]
    return [r, k, v, w, u, state, *ints]


def _rwkv_bound(r, lens, fresh):
    """Least time the card could take, from this run's live tokens: r, k,
    v, w of the live tokens, u, the state of the live rows that carry one
    read once, every live row's state written once, the output and the
    row metadata, at the HBM rate; against ~5 D^2 f32 operations per live
    token and head (o = r.S, and S = w S + k v) at the f32 peak (the
    recurrence runs in f32 whatever the inputs' type)."""
    S, T, H, D = r.shape
    lens_h = lens.cpu().clamp(0, T)
    live = lens_h > 0
    tokens = int(lens_h.sum())
    state_bytes = H * D * D * 4
    reads = int((live & (fresh.cpu() == 0)).sum())
    nbytes = (tokens * H * D * (3 * r.element_size() + 4) + H * D * 4
              + (reads + int(live.sum())) * state_bytes
              + S * T * H * D * 4 + 3 * S * 4)
    flops = tokens * H * 5 * D * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


def phase_rwkv_kernel(wkv, planted: dict) -> list:
    """Each row runs the kernel (decode on its recurrent form, T > 1 on its
    chunked form), the planted copy of the path that serves it, for f32
    rows at T > 1 also the single-TF32 copy, and the recurrent-only form
    (`RWKV_RECURRENT`) for `recurrent_ms`."""
    shapes = [
        # name, S, T, H, lens, fresh, slots in the pool, decay
        ("rwkv6-3b decode", 32, 1, 40, [1] * 28 + [0] * 4, [0] * 32, 64,
         RWKV_DECAY),
        ("rwkv6-3b prefill", 1, 512, 40, [300], [0], 64, RWKV_DECAY),
        ("small ragged", 3, 70, 2, [70, 33, 0], [1, 0, 0], 4, RWKV_DECAY),
        ("strong decay prefill", 1, 512, 40, [300], [0], 64, RWKV_STRONG),
        # one tensor rank's 20 heads of rwkv6-3b at tp=2 (bf16 only)
        ("rwkv6-3b tp=2 decode", 32, 1, 20, [1] * 28 + [0] * 4, [0] * 32,
         64, RWKV_DECAY),
        ("rwkv6-3b tp=2 prefill", 1, 512, 20, [300], [0], 64, RWKV_DECAY),
    ]
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        f32 = dtype == torch.float32
        for name, S, T, H, lens, fresh, n, decay in shapes:
            if name in TP_ROWS and f32:
                continue
            args = _rwkv_case(S, T, H, lens, fresh, n, dtype,
                              seed=200 + len(results), decay=decay)
            before = args[5]
            rows = args[6:]

            def run(library):
                state = before.clone()
                out = wkv.launch(library, *args[:5], state, *rows,
                                 source=planted[library])
                torch.cuda.synchronize()
                return wkv.excess(out, state, *args[:5], before, *rows)[0]

            kstate = before.clone()
            out = wkv.rwkv6_chunked_scan(*args[:5], kstate, *rows)
            torch.cuda.synchronize()
            excess, err = wkv.excess(out, kstate, *args[:5], before, *rows)
            path = "recurrent" if T == 1 else "chunked"
            planted_excess = run(RWKV_PLANTED if T == 1
                                 else RWKV_CHUNK_PLANTED)
            finite = bool(torch.isfinite(out).all())
            zeros = all(not out[s, L:].any() for s, L in enumerate(lens))
            row = {"phase": "rwkv-kernel", "shape": name,
                   "dtype": str(dtype).split(".")[-1], "S": S, "T": T,
                   "H": H, "D": 64, "live_rows": sum(1 for x in lens if x),
                   "live_tokens": sum(lens), "fresh_rows": sum(fresh),
                   "slots": n, "log_w": [-float(np.exp(decay[1])),
                                         -float(np.exp(decay[0]))],
                   "w_zero": int((args[3] == 0).sum()),
                   "w_one": int((args[3] == 1).sum()), "path": path,
                   "max_abs_err": err, "acc": wkv.TOLERANCE[dtype],
                   "excess": excess, "planted_excess": planted_excess,
                   "finite": finite, "zeros_past_lens": zeros}
            if T > 1:
                row["recurrent_excess"] = run(RWKV_RECURRENT)
                if f32:
                    row["planted_tf32_excess"] = run(RWKV_TF32_PLANTED)
            if not (excess <= 1.0 and finite and zeros):
                emit(row)
                raise AssertionError(f"WKV kernel disagrees with its plain "
                                     f"version at {name} {dtype}: {row}")
            if not planted_excess > 1.0:
                emit(row)
                raise AssertionError(f"the check passes a WKV kernel with a "
                                     f"planted fault in its {path} form at "
                                     f"{name} {dtype}: {row}")
            if f32 and name == "small ragged" and \
                    not row["planted_tf32_excess"] > 1.0:
                emit(row)
                raise AssertionError(f"the check passes a WKV kernel on "
                                     f"single TF32 at {name}: {row}")
            row["kernel_ms"] = time_ms(
                lambda: wkv.rwkv6_chunked_scan(*args[:5], kstate, *rows), 20)
            row["recurrent_ms"] = time_ms(
                lambda: wkv.launch(RWKV_RECURRENT, *args[:5], kstate, *rows,
                                   source=planted[RWKV_RECURRENT]), 20)
            pstate = before.clone()
            row["plain_ms"] = time_ms(
                lambda: wkv.rwkv6_scan_ref(*args[:5], pstate, *rows), 3,
                warmup=1)
            row["library_ms"] = None
            row["library"] = "none: no single PyTorch call computes WKV6"
            (row["bound_ms"], row["bound_by"], row["bytes"],
             row["flops"]) = _rwkv_bound(args[0], args[7], args[8])
            emit(row)
            results.append(row)
            del args, before, kstate, pstate, out
            torch.cuda.empty_cache()
    return results


def _two_waves(eng, seed: int, max_new: int):
    """Serve two waves of 4 requests (prompts 16-300 tokens, two of them 16
    and 300; an encoder-decoder's with seeded encoder inputs) on `eng`, the
    second after the first has drained, so that the second wave's requests
    take over the first's state slots, which it checks.  Returns
    {"prompts", "reqs", "encs", "slots_first_wave", "slots_second_wave"}."""
    from repro_torch.core import SamplingParams
    from repro_torch.launch.serve import enc_inputs

    rng = np.random.default_rng(seed)
    vocab = eng.cfg.vocab_size
    lens = [16, 300] + [int(x) for x in rng.integers(16, 301, 6)]
    prompts = [[int(t) for t in rng.integers(0, vocab, L)] for L in lens]
    encs = [enc_inputs(eng.cfg, eng.dims, rng) for _ in prompts]
    taken = []
    get = eng.slots.get

    def record(request_id):
        slot = get(request_id)
        taken.append((request_id, slot))
        return slot

    eng.slots.get = record
    reqs = []
    for wave in (slice(0, 4), slice(4, 8)):
        reqs += [eng.add_request(p, SamplingParams(max_new_tokens=max_new),
                                 **kw)
                 for p, kw in zip(prompts[wave], encs[wave])]
        eng.drain()
    torch.cuda.synchronize()
    first = {s for rid, s in taken if rid in {r.request_id
                                             for r in reqs[:4]}}
    second = {s for rid, s in taken if rid in {r.request_id
                                              for r in reqs[4:]}}
    if not second <= first:
        raise AssertionError(f"slots {first} then {second}: the second "
                             f"wave did not reuse the first's")
    return {"prompts": prompts, "reqs": reqs,
            "encs": [kw.get("enc_embeds") for kw in encs],
            "slots_first_wave": sorted(first),
            "slots_second_wave": sorted(second)}


def phase_serve_rwkv_f32(wkv, greedy_trace) -> dict:
    """Two waves of 4 requests on one engine: the second wave's requests
    take over the first's state slots, so they hold the port to starting a
    request from zero state."""
    from repro_torch.kernels import ops

    max_new = 8
    t0 = time.perf_counter()
    runs, eng, last = _f32_variants(
        "serve-rwkv-f32", lambda: _f32_engine(RWKV_ARCH, RWKV_F32_LAYERS),
        lambda e: _two_waves(e, 17, max_new),
        {"rwkv6_chunked_scan": wkv})
    serve_s = time.perf_counter() - t0
    prompts = last["prompts"]
    # the reference's scan runs on the plain version, so the kernel is not
    # held against itself
    kernel_scan = ops.rwkv6_scan
    ops.rwkv6_scan = wkv.rwkv6_scan_ref
    try:
        compared, near_ties = _match_reference(
            "serve-rwkv-f32", eng, prompts, last["reqs"], max_new,
            greedy_trace)
    finally:
        ops.rwkv6_scan = kernel_scan
    out = {"phase": "serve-rwkv-f32", "arch": RWKV_ARCH,
           "layers": RWKV_F32_LAYERS, "requests": len(prompts),
           "prompt_lens": [len(p) for p in prompts],
           "max_new_tokens": max_new, "variants": runs,
           "tokens_compared": compared, "near_ties": near_ties,
           "serve_s": serve_s, "check_s": time.perf_counter() - t0 - serve_s}
    emit(out)
    del eng
    _free()
    return out


def _cut_engine(arch: str, layers: int, **kw):
    """A bf16 engine at FULL_DIMS for full-width `arch` cut to its first
    `layers` layers, one stage (`_train_cfg`), random weights from seed 0;
    `kw` goes to `PipelineEngine`."""
    from repro_torch.core import ThrottleConfig
    from repro_torch.launch.serve import FULL_DIMS, build_params
    from repro_torch.runtime.engine import PipelineEngine

    cfg = _train_cfg(arch, layers, "bfloat16")
    params = build_params(cfg, torch.bfloat16, torch.device(DEV))
    return PipelineEngine(cfg, FULL_DIMS, params,
                          ThrottleConfig(pipeline_depth=1), device=DEV,
                          dtype=torch.bfloat16, seed=0, **kw)


def phase_serve_rwkv_bf16(wkv, build_engine) -> dict:
    """serve-bf16's batch on full-width rwkv6-3b cut to RWKV_BF16_LAYERS
    of its 32 layers."""
    return _serve_bf16(
        lambda: _cut_engine(RWKV_ARCH, RWKV_BF16_LAYERS, cuda_graphs=False),
        {"rwkv6_chunked_scan": wkv}, "serve-rwkv-bf16")


# ---------------------------------------------------------- Mamba phases

MAMBA_DT = (1e-3, 3.0)        # decays exp(dt A) from ~1 to ~1e-21
MAMBA_STRONG = (1e-4, 100.0)  # exp(dt A) exactly 0 on many channels


def _mamba_case(S, T, di, ds, lens, fresh, n_slots, dtype, seed,
                dt_range=MAMBA_DT):
    """Unit-normal x (in `dtype`), B and C; step sizes dt log-uniform in
    `dt_range`; A = -exp(log(1..ds) + 0.3 N), on the card.  Live rows hold
    distinct slots, and where there are padding rows (lens 0) they sit on
    slot 0, which a live row holds.  The pool is NaN except the slots of
    the live rows that carry a state."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    lo, hi = np.log(dt_range)
    dt = torch.exp(torch.rand(S, T, di, generator=g, device=DEV) * (hi - lo)
                   + lo)
    x = torch.randn(S, T, di, generator=g, device=DEV).to(dtype)
    B = torch.randn(S, T, ds, generator=g, device=DEV)
    C = torch.randn(S, T, ds, generator=g, device=DEV)
    A = -torch.exp(torch.log(torch.arange(1, ds + 1, device=DEV).float())
                   + 0.3 * torch.randn(di, ds, generator=g, device=DEV))
    rng = np.random.default_rng(seed)
    live = [s for s in range(S) if lens[s] > 0]
    slots = np.zeros(S, np.int32)
    chosen = rng.choice(np.arange(1, n_slots), len(live), replace=False)
    if len(live) < S:
        chosen[0] = 0
    slots[live] = chosen
    state = torch.full((n_slots, di, ds), float("nan"), device=DEV)
    for s in live:
        if not fresh[s]:
            state[int(slots[s])] = 3.0 * torch.randn(
                di, ds, generator=g, device=DEV)
    ints = [torch.tensor(a, dtype=torch.int32, device=DEV)
            for a in (slots, lens, fresh)]
    return [dt, x, B, C, A, state, *ints]


def _mamba_bound(x, A, lens, fresh):
    """Least time the card could take, from this run's live tokens: dt and
    x of the live tokens, B and C of the live tokens, A, the state of the
    live rows that carry one read once, every live row's state written
    once, the output and the row metadata, at the HBM rate; against the
    operations: 6 f32 operations per live token, channel and state (dt*A,
    (dt*x)*B, the update's fma, the read-out's fma) at the f32 peak, and
    one exponential per live token, channel and state on the
    special-function units."""
    S, T, di = x.shape
    ds = A.shape[1]
    lens_h = lens.cpu().clamp(0, T)
    live = lens_h > 0
    tokens = int(lens_h.sum())
    state_bytes = di * ds * 4
    reads = int((live & (fresh.cpu() == 0)).sum())
    nbytes = (tokens * di * (4 + x.element_size()) + tokens * ds * 8
              + di * ds * 4 + (reads + int(live.sum())) * state_bytes
              + S * T * di * 4 + 3 * S * 4)
    flops = 6 * tokens * di * ds
    exps = tokens * di * ds
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / PEAK_FLOPS["float32"], exps / SFU_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops, exps


def phase_mamba_kernel(s6, planted: dict) -> list:
    """Each row runs the kernel (decode on its recurrent form, T > 1 on its
    segmented form), the planted copy of the path that serves it, and the
    recurrent-only form (`MAMBA_RECURRENT`) for `recurrent_ms`."""
    shapes = [
        # name, S, T, di, ds, lens, fresh, slots in the pool, dt range
        ("jamba decode", 32, 1, 16384, 16, [1] * 28 + [0] * 4, [0] * 32,
         64, MAMBA_DT),
        ("jamba prefill", 1, 512, 16384, 16, [300], [0], 64, MAMBA_DT),
        ("small ragged", 3, 70, 200, 16, [70, 33, 0], [1, 0, 0], 4,
         MAMBA_DT),
        ("strong decay prefill", 1, 512, 16384, 16, [300], [0], 64,
         MAMBA_STRONG),
        # one tensor rank's 8,192 channels of jamba at tp=2 (bf16 only)
        ("jamba tp=2 decode", 32, 1, 8192, 16, [1] * 28 + [0] * 4, [0] * 32,
         64, MAMBA_DT),
        ("jamba tp=2 prefill", 1, 512, 8192, 16, [300], [0], 64, MAMBA_DT),
    ]
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, S, T, di, ds, lens, fresh, n, dt_range in shapes:
            if name in TP_ROWS and dtype != torch.bfloat16:
                continue
            args = _mamba_case(S, T, di, ds, lens, fresh, n, dtype,
                               seed=300 + len(results), dt_range=dt_range)
            before = args[5]
            rows = args[6:]

            def run(library):
                state = before.clone()
                out = s6.launch(library, *args[:5], state, *rows,
                                source=planted[library])
                torch.cuda.synchronize()
                return s6.excess(out, state, *args[:5], before, *rows)[0]

            kstate = before.clone()
            out = s6.mamba_chunked_scan(*args[:5], kstate, *rows)
            torch.cuda.synchronize()
            excess, err = s6.excess(out, kstate, *args[:5], before, *rows)
            path = "recurrent" if T == 1 else "segmented"
            planted_excess = run(MAMBA_PLANTED if T == 1
                                 else MAMBA_SEG_PLANTED)
            finite = bool(torch.isfinite(out).all())
            zeros = all(not out[r, L:].any() for r, L in enumerate(lens))
            dA = torch.exp(args[0][..., None] * args[4])
            row = {"phase": "mamba-kernel", "shape": name,
                   "dtype": str(dtype).split(".")[-1], "S": S, "T": T,
                   "di": di, "ds": ds,
                   "live_rows": sum(1 for L in lens if L),
                   "live_tokens": sum(lens), "fresh_rows": sum(fresh),
                   "slots": n, "dt_range": list(dt_range),
                   "dA_zero": int((dA == 0).sum()), "path": path,
                   "max_abs_err": err, "acc": s6.TOLERANCE[dtype],
                   "excess": excess, "planted_excess": planted_excess,
                   "finite": finite, "zeros_past_lens": zeros}
            del dA
            if T > 1:
                row["recurrent_excess"] = run(MAMBA_RECURRENT)
            if not (excess <= 1.0 and finite and zeros):
                emit(row)
                raise AssertionError(f"Mamba kernel disagrees with its plain "
                                     f"version at {name} {dtype}: {row}")
            if not planted_excess > 1.0:
                emit(row)
                raise AssertionError(f"the check passes a Mamba kernel with a "
                                     f"planted fault in its {path} form at "
                                     f"{name} {dtype}: {row}")
            row["kernel_ms"] = time_ms(
                lambda: s6.mamba_chunked_scan(*args[:5], kstate, *rows), 20)
            row["recurrent_ms"] = time_ms(
                lambda: s6.launch(MAMBA_RECURRENT, *args[:5], kstate, *rows,
                                  source=planted[MAMBA_RECURRENT]), 20)
            pstate = before.clone()
            row["plain_ms"] = time_ms(
                lambda: s6.mamba_scan_ref(*args[:5], pstate, *rows), 3,
                warmup=1)
            row["library_ms"] = None
            row["library"] = ("none: no single PyTorch call computes the "
                              "selective scan")
            (row["bound_ms"], row["bound_by"], row["bytes"], row["flops"],
             row["exps"]) = _mamba_bound(args[1], args[4], args[7], args[8])
            emit(row)
            results.append(row)
            del args, before, kstate, pstate, out
            torch.cuda.empty_cache()
    return results


def phase_serve_jamba_f32(pa, mg, s6, greedy_trace) -> dict:
    """Full-width jamba cut to its first MAMBA_MLP and ATTN_MOE layers,
    f32, dropless, two waves of 4 requests on one engine: the second
    wave's requests take over the first's state slots."""
    from repro_torch.kernels import ops
    from repro_torch.models import moe as moe_lib

    max_new = 8
    t0 = time.perf_counter()
    runs, eng, last = _f32_variants(
        "serve-jamba-f32",
        lambda: _f32_engine(JAMBA_ARCH, kinds=JAMBA_F32_KINDS),
        lambda e: _two_waves(e, 19, max_new),
        {"mamba_chunked_scan": s6, "paged_flash_attention": pa,
         "fused_moe_ffn": mg})
    serve_s = time.perf_counter() - t0
    prompts = last["prompts"]
    # the reference's scan and expert FFN run on the plain versions, so no
    # kernel is held against itself
    kernel_scan, kernel_ffn = ops.mamba_scan, moe_lib.expert_ffn
    ops.mamba_scan = s6.mamba_scan_ref
    moe_lib.expert_ffn = mg.fused_moe_ffn_ref
    try:
        compared, near_ties = _match_reference(
            "serve-jamba-f32", eng, prompts, last["reqs"], max_new,
            greedy_trace)
    finally:
        ops.mamba_scan, moe_lib.expert_ffn = kernel_scan, kernel_ffn
    out = {"phase": "serve-jamba-f32", "arch": JAMBA_ARCH,
           "kinds": [b.kind.value for b in eng.cfg.pattern],
           "layers": eng.cfg.num_layers,
           "capacity_factor": eng.cfg.moe_capacity_factor,
           "requests": len(prompts),
           "prompt_lens": [len(p) for p in prompts],
           "max_new_tokens": max_new, "variants": runs,
           "tokens_compared": compared, "near_ties": near_ties,
           "serve_s": serve_s, "check_s": time.perf_counter() - t0 - serve_s}
    emit(out)
    # what serve-ep-f32 reuses: the same weights drawn from the seed, the
    # prompts and this engine's tokens
    out.update(cfg=eng.cfg, dims=eng.dims, prompts=prompts,
               tokens=[r.output_token_ids for r in last["reqs"]])
    del eng
    _free()
    return out


def phase_serve_jamba_bf16(pa, mg, s6, build_engine) -> dict:
    """serve-bf16's batch on full-width jamba cut to one layer of each
    block kind, at the config's capacity factor."""
    from repro_torch.configs import BlockKind

    return _serve_bf16(
        lambda: build_engine(JAMBA_ARCH, device=DEV, dtype=torch.bfloat16,
                             cut=[BlockKind(k) for k in JAMBA_KINDS],
                             cuda_graphs=False),
        {"paged_flash_attention": pa, "fused_moe_ffn": mg,
         "mamba_chunked_scan": s6}, "serve-jamba-bf16")


# ------------------------------------------------- the remaining archs

# serve-archs-f32: (arch, layers, kinds): cut to its first `layers`, or to
# the first layer of each of `kinds`; whisper-small to one ENC_LAYER and one
# DEC_LAYER of its 12 + 12 (the script's time)
WHISPER_KINDS = ("enc_layer", "dec_layer")
ARCHS_F32 = (("minicpm3-4b", 4, ()), ("whisper-small", 0, WHISPER_KINDS),
             ("qwen2-vl-7b", 4, ()), ("internlm2-1.8b", 4, ()))
KIMI_ARCH = "kimi-k2-1t-a32b"
LLAMA_ARCH = "llama3.1-100b"
LLAMA_LAYERS = 8            # of 96: ~16 GB of bf16 weights, 2 a stage at PP
# minicpm3-4b, of 62: its plain f32 MLA makes it the slowest serve at full
# depth (~70 s of ~880 in a full run of this script), cut to keep the
# script inside its time limit on the slower hosts (full depth: PERF.md §5)
MINICPM_ARCH = "minicpm3-4b"
MINICPM_BF16_LAYERS = 8
ARCHS_BF16 = ("minicpm3-4b", "whisper-small", "qwen2-vl-7b",
              "internlm2-1.8b", KIMI_ARCH, LLAMA_ARCH)
BIG_ARCH = "qwen2.5-32b"    # the paper's mid-size model, 65.5 GB in bf16
BIG_LAYERS = 8              # served cut to 8 of its 64 (the script's time)
# the archs whose attention runs (partly) as plain PyTorch: their
# serve-archs-bf16 line gets a profiled rerun for busy time and idle share
PROFILED_ARCHS = ("minicpm3-4b", "whisper-small")


def phase_serve_archs_f32(pa, greedy_trace) -> dict:
    """Each arch of ARCHS_F32 at full width (cut in depth as listed), f32,
    two waves of 4 requests on serve-f32's three engines (`_two_waves`:
    the second wave on the first's slots, whisper's with seeded encoder
    inputs at its 1,500 frames): identical greedy tokens, equal to the
    port's dense reference up to a near-tie; paged attention once per layer
    and phase (DEC_LAYER's self-attention; none for MLA)."""
    rows = {}
    for arch, layers, kinds in ARCHS_F32:
        t0 = time.perf_counter()
        runs, eng, last = _f32_variants(
            "serve-archs-f32", lambda: _f32_engine(arch, layers, kinds),
            lambda e: _two_waves(e, 23, 8), {"paged_flash_attention": pa})
        serve_s = time.perf_counter() - t0
        compared, near_ties = _match_reference(
            "serve-archs-f32", eng, last["prompts"], last["reqs"], 8,
            greedy_trace, last["encs"])
        out = {"phase": "serve-archs-f32", "arch": arch,
               "kinds": [b.kind.value for b in eng.cfg.pattern],
               "layers": eng.cfg.num_layers, "Te": eng.dims.Te,
               "requests": len(last["prompts"]),
               "prompt_lens": [len(p) for p in last["prompts"]],
               "max_new_tokens": 8, "variants": runs,
               "slots_first_wave": last["slots_first_wave"],
               "slots_second_wave": last["slots_second_wave"],
               "tokens_compared": compared, "near_ties": near_ties,
               "serve_s": serve_s,
               "check_s": time.perf_counter() - t0 - serve_s}
        emit(out)
        rows[arch] = out
        del eng, last
        _free()
    return rows


def _plain_bound(nbytes: int, flops: int) -> tuple:
    """(bound ms, "bytes" or "operations"): the larger of the bytes at the
    HBM rate and the flops at the bf16 tensor-core peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_attention_plain() -> list:
    """The attention paths that run as plain PyTorch (the JAX package runs
    them as jnp, with no Pallas kernel), timed at the serve path's bf16
    shapes: minicpm3-4b's MLA (`paged_attention_mla`, absorbed form; 40
    heads, kv_lora 256, rope 32, nope 64, v 64) over a decode tick (32
    rows, ctx up to 2,048, 128-page tables) and a 512-token prefill chunk,
    whisper-small's encoder self-attention (1,500 frames, 12 heads of 64)
    and its cross-attention for a decode tick (32 rows, each over its own
    1,500-frame snapshot) and a 512-token prefill chunk.  Each against the
    bound of its work (live keys only) and, as the library call, SDPA (for
    MLA over K and V expanded from the latent ahead of the call, not
    timed).  Outputs finite; MLA's equal to SDPA's on the expanded K/V
    within bf16 rounding (the engine phases hold the whole path to the
    dense reference)."""
    import torch.nn.functional as F

    from repro_torch.models import attention as attn

    rows = []
    g = torch.Generator(device=DEV).manual_seed(31)
    bf16 = torch.bfloat16
    H, klr, dr, dn, dv, page, B = 40, 256, 32, 64, 64, 16, 128
    rng_ctx = np.random.default_rng(7)
    decode_ctx = [int(c) for c in rng_ctx.integers(1, 2049, 32)]
    for name, S, C, ctx in (("mla decode", 32, 1, decode_ctx),
                            ("mla prefill", 1, 512, [2000])):
        q = torch.randn(S, C, H, dn + dr, generator=g, device=DEV).to(bf16)
        cache = torch.randn(S * B, page, klr + dr, generator=g,
                            device=DEV).to(bf16)
        w = (torch.randn(klr, H * (dn + dv), generator=g, device=DEV)
             * 0.06).to(bf16)
        tables = torch.randperm(S * B, generator=g, device=DEV).view(
            S, B).to(torch.int32)
        ctx_t = torch.tensor(ctx, dtype=torch.int32, device=DEV)
        qpos = (torch.clamp(ctx_t, min=C)[:, None] - C
                + torch.arange(C, device=DEV)[None, :]).to(torch.int32)
        kw = dict(kv_lora_rank=klr, qk_nope_dim=dn, v_head_dim=dv)
        out = attn.paged_attention_mla(q, cache, w, tables, ctx_t, qpos, **kw)
        # SDPA over the latent expanded into per-head K and V
        L = B * page
        lat = cache[tables.long()].reshape(S, L, klr + dr)
        kv = (lat[..., :klr] @ w).view(S, L, H, dn + dv)
        k = torch.cat([kv[..., :dn], lat[..., None, klr:].expand(
            S, L, H, dr)], dim=-1).transpose(1, 2).contiguous()
        v = kv[..., dn:].transpose(1, 2).contiguous()
        kpos = torch.arange(L, device=DEV)
        mask = ((kpos[None, None, :] < ctx_t[:, None, None])
                & (kpos[None, None, :] <= qpos[:, :, None]))[:, None]
        qt = q.transpose(1, 2).contiguous()
        want = F.scaled_dot_product_attention(qt, k, v, attn_mask=mask)
        err = float((out.float() - want.transpose(1, 2).float()).abs().max())
        keys = int(torch.minimum(ctx_t[:, None], qpos + 1).clamp(min=0)
                   .sum())
        nbytes = (q.numel() + S * C * H * dv + w.numel()
                  + int(ctx_t.sum()) * (klr + dr)) * 2
        flops = keys * H * (4 * klr + 2 * dr) + S * C * H * 2 * klr * (dn
                                                                       + dv)
        rows.append(dict(
            shape=name, rows=S * C, max_abs_err_vs_sdpa=err,
            finite=bool(torch.isfinite(out).all()),
            ms=time_ms(lambda: attn.paged_attention_mla(
                q, cache, w, tables, ctx_t, qpos, **kw), 10),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qt, k, v, attn_mask=mask), 10),
            **dict(zip(("bound_ms", "bound_by"),
                       _plain_bound(nbytes, flops)))))
        del q, cache, lat, kv, k, v, want, out
    Hw, D, Te = 12, 64, 1500
    for name, S, Tq in (("encoder self-attention", 1, Te),
                        ("cross-attention decode", 32, 1),
                        ("cross-attention prefill", 1, 512)):
        q = torch.randn(S, Tq, Hw, D, generator=g, device=DEV).to(bf16)
        k = torch.randn(S, Te, Hw, D, generator=g, device=DEV).to(bf16)
        v = torch.randn(S, Te, Hw, D, generator=g, device=DEV).to(bf16)
        out = attn.cross_attention(q, k, v)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        want = F.scaled_dot_product_attention(qt, kt, vt)
        err = float((out.float() - want.transpose(1, 2).float()).abs().max())
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
        flops = 4 * S * Tq * Te * Hw * D
        rows.append(dict(
            shape=name, rows=S * Tq, max_abs_err_vs_sdpa=err,
            finite=bool(torch.isfinite(out).all()),
            ms=time_ms(lambda: attn.cross_attention(q, k, v), 10),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt), 10),
            **dict(zip(("bound_ms", "bound_by"),
                       _plain_bound(nbytes, flops)))))
        del q, k, v, qt, kt, vt, out, want
    for row in rows:
        row = {"phase": "attention-plain", "dtype": "bfloat16", **row}
        emit(row)
        if not row["finite"] or row["max_abs_err_vs_sdpa"] > 0.05:
            raise AssertionError(f"attention-plain: {row}")
    _free()
    return rows


def _archs_engine(arch: str, build_engine):
    """The bf16 bucketed async graph engine serve-archs-bf16 measures:
    `arch` at full width and depth, kimi-k2 cut to its first ATTN_MOE
    layer (`cut_to_kinds`: 38.9 GB), llama3.1-100b cut to its first
    LLAMA_LAYERS layers in PP stages, minicpm3-4b to its first
    MINICPM_BF16_LAYERS layers."""
    import dataclasses

    from repro_torch.configs import BlockKind, BlockSpec, stage_config
    from repro_torch.core import ThrottleConfig
    from repro_torch.launch.serve import FULL_DIMS, build_params, serve_config
    from repro_torch.runtime.engine import PipelineEngine

    kw = dict(device=DEV, dtype=torch.bfloat16, bucketed=True,
              async_dispatch=True)
    if arch == KIMI_ARCH:
        return build_engine(arch, cut=[BlockKind.ATTN_MOE], **kw)
    if arch == "whisper-small":
        return build_engine(arch, cut=[BlockKind(k) for k in WHISPER_KINDS],
                            **kw)
    cuts = {LLAMA_ARCH: (LLAMA_LAYERS, PP),
            MINICPM_ARCH: (MINICPM_BF16_LAYERS, 1)}
    if arch not in cuts:
        return build_engine(arch, **kw)
    layers, pp = cuts[arch]
    cfg, dtype = serve_config(arch, dtype=torch.bfloat16)
    cfg = stage_config(dataclasses.replace(
        cfg, num_layers=layers,
        pattern=(BlockSpec(cfg.pattern[0].kind, layers),)), pp)
    params = build_params(cfg, dtype, torch.device(DEV))
    return PipelineEngine(cfg, FULL_DIMS, params,
                          ThrottleConfig(pipeline_depth=pp), seed=0, **kw)


def phase_serve_archs_bf16(pa, mg, build_engine) -> dict:
    """serve-bf16's batch (whisper's with seeded encoder inputs) on each
    arch of ARCHS_BF16 (`_archs_engine`), bf16, bucketed async graphs:
    every request finishes with valid tokens, launches as `_launch_want`
    says; tokens/s, ms per tick and peak memory; busy time and idle share
    from a profiled rerun for PROFILED_ARCHS."""
    from repro_torch.launch.serve import enc_inputs

    rows = {}
    for arch in ARCHS_BF16:
        _free()
        t0 = time.perf_counter()
        eng = _archs_engine(arch, build_engine)
        build_s = time.perf_counter() - t0
        cfg = eng.cfg
        prompts = _prompts(12, 32, cfg.vocab_size)
        encs = None
        if cfg.is_encoder_decoder:
            rng = np.random.default_rng(12)
            encs = [enc_inputs(cfg, eng.dims, rng)["enc_embeds"]
                    for _ in prompts]
        counted = {"paged_flash_attention": pa}
        if cfg.is_moe:
            counted["fused_moe_ffn"] = mg
        out = _serve_measured(eng, prompts, counted, "serve-archs-bf16",
                              "graphs_async", encs=encs,
                              profiled=arch in PROFILED_ARCHS)
        out.update(engine_build_s=build_s, Te=eng.dims.Te,
                   weight_bytes=sum(t.numel() * t.element_size()
                                    for t in eng.params.parameters()),
                   kinds=[b.kind.value for b in cfg.pattern],
                   layers_per_stage=cfg.layers_per_stage,
                   capacity_factor=cfg.moe_capacity_factor)
        emit(out)
        rows[arch] = out
        del eng
    _free()
    return rows


# ------------------------------------------------------- router phases

PREFIX_TOKENS = 1024          # the prefix-caching run's shared head: 64 pages
ROUTER_LAYERS = 8             # serve-router-f32's cut of qwen's 24 (the
                              # script's time)
ROUTER_MIGRATIONS = 2         # forced mid-decode moves (and one mid-prefill)


class _Replicas:
    """What the router phases hold each replica of `server` to: its graph
    count and pool addresses, taken now and held to `check` (imports write
    into the pools in place, and serving captures no graph), and the
    launches of `counted`'s kernels made in its own steps (its `step` is
    wrapped; the counts are set to 0 here), which must be what
    `_launch_want` makes of its ticks."""

    def __init__(self, engines, counted: dict) -> None:
        self.engines = list(engines)
        self.counted = counted
        self.graphs = [e.backend.graph_count() for e in self.engines]
        self.pools = [self._pools(e) for e in self.engines]
        self.ticks0 = [self._ticks(e) for e in self.engines]
        self.launches = [dict.fromkeys(counted, 0) for _ in self.engines]
        for mod in counted.values():
            mod.launches = 0
        for eng, acc in zip(self.engines, self.launches):
            eng.step = self._counting(eng.step, acc)

    @staticmethod
    def _pools(eng) -> dict:
        return _pool_addresses(eng)

    @staticmethod
    def _ticks(eng) -> tuple:
        st = eng.stats
        return st.ticks, st.prefill_ticks, st.decode_ticks

    def _counting(self, step, acc: dict):
        def counted_step():
            before = {k: m.launches for k, m in self.counted.items()}
            out = step()
            for k, m in self.counted.items():
                acc[k] += m.launches - before[k]
            return out
        return counted_step

    def check(self, phase: str) -> list:
        rows = []
        for i, eng in enumerate(self.engines):
            ticks = [a - b for a, b in zip(self._ticks(eng), self.ticks0[i])]
            want = _launch_want(eng.cfg, *ticks, self.counted)
            if self.launches[i] != want:
                raise AssertionError(f"{phase}: replica {i} launched "
                                     f"{self.launches[i]} in {ticks} ticks "
                                     f"(all, prefill, decode), want {want}")
            if eng.backend.graph_count() != self.graphs[i]:
                raise AssertionError(f"{phase}: replica {i} has "
                                     f"{eng.backend.graph_count()} graphs, "
                                     f"{self.graphs[i]} after warm_start")
            if self._pools(eng) != self.pools[i]:
                raise AssertionError(f"{phase}: replica {i}'s pools moved")
            rows.append({"ticks": ticks[0], "prefill_ticks": ticks[1],
                         "decode_ticks": ticks[2],
                         "launches": self.launches[i],
                         "graphs": self.graphs[i]})
        return rows


_REFERENCE = {}


def _reference(eng, prompt, max_new, greedy_trace):
    """The dense reference's (tokens, top-2 gaps) of `prompt`, computed once
    per weights (their seed makes them the same in every build)."""
    key = (eng.cfg.name, eng.cfg.num_layers, eng.cfg.dtype, tuple(prompt),
           max_new)
    if key not in _REFERENCE:
        _REFERENCE[key] = greedy_trace(eng.cfg, eng.params, prompt, max_new)
    return _REFERENCE[key]


def _check_tokens(phase, eng, prompts, tokens, max_new, greedy_trace):
    """Every request's `max_new` tokens equal the dense reference's up to
    its first near-tie (top-2 gap below NEAR_TIE).  Returns (tokens
    compared, near-ties)."""
    compared, near_ties = 0, []
    vocab = eng.cfg.vocab_size
    for i, (p, got) in enumerate(zip(prompts, tokens)):
        if len(got) != max_new or not all(0 <= t < vocab for t in got):
            raise AssertionError(f"{phase}: request {i} gave {got}")
        want, gaps = _reference(eng, p, max_new, greedy_trace)
        stop = next((k for k, g in enumerate(gaps) if g < NEAR_TIE), max_new)
        if stop < max_new:
            near_ties.append({"request": i, "step": stop, "gap": gaps[stop]})
        if got[:stop] != want[:stop]:
            raise AssertionError(f"{phase}: request {i} (prompt {len(p)}) "
                                 f"{got} != reference {want} (compared "
                                 f"{stop})")
        compared += stop
    return compared, near_ties


def _where(router, rid: str) -> int:
    return next(i for i, e in enumerate(router.replicas)
                if e.scheduler.kv.has_request(rid))


def _force_moves(srv, rids, decode_moves: int, prefill_moves: int) -> list:
    """Step `srv` until `decode_moves` requests have been live-migrated
    mid-decode and `prefill_moves` mid-prefill (prompt partly prefilled, no
    token yet), each by `router.migrate_request` to the other replica."""
    router = srv.router
    reqs = [srv._requests[r] for r in rids]
    moves = []
    for _ in range(2000):
        if not srv.has_work:
            break
        for req in reqs:
            rid = req.request_id
            if any(m["request_id"] == rid for m in moves):
                continue
            mid_prefill = (0 < req.num_prefilled
                           < req.num_effective_prompt_tokens
                           and req.num_output_tokens == 0)
            mid_decode = 2 <= req.num_output_tokens <= MAX_NEW - 4
            kind = ("prefill" if mid_prefill else
                    "decode" if mid_decode else None)
            if kind is None or sum(m["at"] == kind for m in moves) >= (
                    prefill_moves if kind == "prefill" else decode_moves):
                continue
            src = _where(router, rid)
            tokens = req.num_prefilled
            if router.migrate_request(rid, src, 1 - src):
                moves.append({"request_id": rid, "at": kind, "src": src,
                              "kv_tokens": tokens,
                              "outputs": req.num_output_tokens})
        if len(moves) == decode_moves + prefill_moves:
            return moves
        srv.step()
    raise AssertionError(f"forced moves: caught only {moves}")


def _router_stats(srv) -> dict:
    st = srv.stats()
    out = {"routed": st.routed_counts,
           "prefix_hits": [r.prefix_hits for r in st.replicas],
           "prefix_tokens_avoided": [r.prefix_tokens_avoided
                                     for r in st.replicas]}
    if srv.router is not None:
        rb = srv.router.rebalance_stats
        out.update(stolen=rb.stolen, migrated=rb.migrated,
                   migrated_tokens=rb.migrated_tokens,
                   migration_fallbacks=rb.migration_fallbacks)
    if st.disagg is not None:
        out.update(handoffs=st.disagg.handoffs,
                   handoff_tokens=st.disagg.handoff_tokens,
                   handoff_fallbacks=st.disagg.fallbacks)
    return out


def _sse(url: str, body: dict):
    """POST `body` to `url` and yield the SSE frames' JSON as they come."""
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        for line in resp:
            line = line.decode().strip()
            if line.startswith("data: "):
                yield json.loads(line[len("data: "):])


def _http_stream_and_abort(srv, prompt, greedy_trace) -> dict:
    """Through `HTTPFrontend` on 127.0.0.1 (an ephemeral port): stream one
    request to its end, its tokens equal to the dense reference's; then
    abort a long one mid-stream with DELETE from a second connection: its
    stream ends with finish_reason "abort" and its pages are back in its
    replica's pool."""
    import threading
    import urllib.request

    from repro_torch.serving import HTTPFrontend

    fe = HTTPFrontend(srv, host="127.0.0.1", port=0).start()
    try:
        url = fe.url + "/v1/generate?stream=1"
        frames = list(_sse(url, {"prompt": prompt,
                                 "max_new_tokens": MAX_NEW}))
        streamed = [f["token"] for f in frames if f["token"] is not None]
        if frames[-1]["finish_reason"] != "length":
            raise AssertionError(f"http: stream ended with {frames[-1]}")
        compared, ties = _check_tokens("serve-router-f32 http", srv.replicas[0],
                                       [prompt], [streamed], MAX_NEW,
                                       greedy_trace)
        free = [e.kv.num_free_pages for e in srv.replicas]
        victim = _sse(url, {"prompt": prompt[:200], "max_new_tokens": 400,
                            "request_id": "http-victim"})
        first = next(victim)
        where = next(i for i, e in enumerate(srv.replicas)
                     if e.kv.has_request("http-victim")
                     or "http-victim" in {r.request_id
                                          for r in e.scheduler.waiting})

        def abort():
            urllib.request.urlopen(urllib.request.Request(
                fe.url + "/v1/requests/http-victim", method="DELETE"),
                timeout=120).read()

        aborter = threading.Thread(target=abort)
        aborter.start()
        rest = [first] + list(victim)
        aborter.join(timeout=120)
        if rest[-1]["finish_reason"] != "abort":
            raise AssertionError(f"http: the aborted stream ended with "
                                 f"{rest[-1]}")
        after = [e.kv.num_free_pages for e in srv.replicas]
        if after != free or any(e.kv.has_request("http-victim")
                                for e in srv.replicas):
            raise AssertionError(f"http: free pages {free} before the "
                                 f"aborted request, {after} after it")
        return {"url_host": fe.host, "streamed_tokens": len(streamed),
                "tokens_compared": compared, "near_ties": ties,
                "aborted_after_frames": len(rest), "abort_replica": where,
                "free_pages_after_abort": after}
    finally:
        fe.shutdown()


def phase_serve_router_f32(pa, greedy_trace) -> dict:
    """Full-width qwen1.5-0.5b cut to ROUTER_LAYERS, f32, two bucketed async
    graph replicas on the card behind the balanced router, built by
    `repro_torch.serving.build`, three times from one seed: live migration,
    disaggregated hand-off, prefix caching with the HTTP frontend."""
    import dataclasses

    from repro_torch.serving import (ClusterSpec, EngineSpec, HandoffPolicy,
                                     ServeSpec, build)

    counted = {"paged_flash_attention": pa}
    engine = EngineSpec(arch=ARCH, reduced=False, bucketed=True,
                        dispatch="async")
    out = {"phase": "serve-router-f32", "arch": ARCH,
           "layers": ROUTER_LAYERS,
           "replicas": 2, "max_new_tokens": MAX_NEW}

    def run(name, spec, serve):
        t0 = time.perf_counter()
        _free()
        srv = build(spec, device=DEV, dtype=torch.float32,
                    layers=ROUTER_LAYERS)
        build_s = time.perf_counter() - t0
        watch = _Replicas(srv.replicas, counted)
        t1 = time.perf_counter()
        res = serve(srv)
        torch.cuda.synchronize()
        res.update(build_s=build_s, serve_s=time.perf_counter() - t1,
                   replicas_run=watch.check(f"serve-router-f32 {name}"),
                   capture_s=[e.backend.capture_s for e in srv.replicas],
                   **_router_stats(srv))
        srv.router.check_invariants()
        out[name] = res
        emit({"phase": "serve-router-f32", "run": name, **res})
        return srv

    def balanced(srv):
        ps = _prompts(11, 8, srv.cfg.vocab_size)
        rids = [srv.submit(p, _sampling(0.0)) for p in ps]
        moves = _force_moves(srv, rids, ROUTER_MIGRATIONS, 1)
        srv.drain()
        toks = [o.token_ids for o in srv.outputs(rids)]
        compared, ties = _check_tokens("serve-router-f32 balanced",
                                       srv.replicas[0], ps, toks, MAX_NEW,
                                       greedy_trace)
        migrated = srv.router.rebalance_stats.migrated
        if migrated != len(moves):
            raise AssertionError(f"migrated {migrated}, forced {moves}")
        return {"moves": moves, "tokens_compared": compared,
                "near_ties": ties}

    run("balanced", ServeSpec(engine=engine,
                              cluster=ClusterSpec(replicas=2)), balanced)

    def disagg(srv):
        ps = _prompts(11, 8, srv.cfg.vocab_size)
        rids = [srv.submit(p, _sampling(0.0)) for p in ps]
        srv.drain()
        toks = [o.token_ids for o in srv.outputs(rids)]
        compared, ties = _check_tokens("serve-router-f32 disagg",
                                       srv.replicas[0], ps, toks, MAX_NEW,
                                       greedy_trace)
        st = srv.stats()
        if st.disagg.handoffs != len(ps) or st.disagg.fallbacks:
            raise AssertionError(f"disagg: {st.disagg} for {len(ps)} "
                                 f"requests")
        done = {r.request_id for r in srv.replicas[1].finished}
        if not set(rids) <= done:
            raise AssertionError("disagg: a request finished off the "
                                 "decode replica")
        return {"tokens_compared": compared, "near_ties": ties}

    run("disagg", ServeSpec(engine=engine, cluster=ClusterSpec(
        replicas=2, roles=("prefill", "decode"),
        handoff=HandoffPolicy(interval=1e-4))), disagg)

    def prefix(srv):
        rng = np.random.default_rng(23)
        vocab = srv.cfg.vocab_size
        head = [int(t) for t in rng.integers(0, vocab, PREFIX_TOKENS)]
        ps = [head + [int(t) for t in rng.integers(0, vocab, n)]
              for n in (17, 40, 9, 33)]
        # one at a time: each later request finds the head cached on the
        # replica that served the first, and cache-aware routing sends it
        # there
        toks = [srv.generate(p, _sampling(0.0)).token_ids for p in ps]
        compared, ties = _check_tokens("serve-router-f32 prefix",
                                       srv.replicas[0], ps, toks, MAX_NEW,
                                       greedy_trace)
        hits = sum(r.prefix_hits for r in srv.stats().replicas)
        if hits < len(ps) - 1:
            raise AssertionError(f"prefix: {hits} hits for {len(ps)} "
                                 f"requests sharing {PREFIX_TOKENS} tokens")
        # the streamed prompt adopts half the cached head
        http = _http_stream_and_abort(srv, ps[1][:PREFIX_TOKENS // 2],
                                      greedy_trace)
        return {"prefix_tokens": PREFIX_TOKENS, "tokens_compared": compared,
                "near_ties": ties, "http": http}

    run("prefix", ServeSpec(engine=dataclasses.replace(
        engine, enable_prefix_caching=True),
        cluster=ClusterSpec(replicas=2)), prefix)
    _free()
    return out


def phase_serve_router_rwkv_f32(wkv, greedy_trace) -> dict:
    """Full-width rwkv6-3b cut to 4 layers, f32, two bucketed async graph
    replicas from one set of weights behind the router.  Every request is
    placed on replica 0; three still waiting are stolen to replica 1 (no
    state moves) and two are live-migrated mid-decode (their WKV, tm_x and
    cm_x slots move device to device)."""
    from repro_torch.core import SamplingParams
    from repro_torch.kernels import ops
    from repro_torch.runtime.router import ReplicaRouter

    max_new = 8
    t0 = time.perf_counter()
    spec = _spec(_f32_engine(RWKV_ARCH, RWKV_F32_LAYERS))
    engines = [_sibling(spec, bucketed=True, async_dispatch=True)[0]
               for _ in range(2)]
    build_s = time.perf_counter() - t0
    router = ReplicaRouter(engines)
    watch = _Replicas(engines, {"rwkv6_chunked_scan": wkv})
    rng = np.random.default_rng(29)
    vocab = engines[0].cfg.vocab_size
    lens = [16, 300] + [int(x) for x in rng.integers(16, 301, 6)]
    prompts = [[int(t) for t in rng.integers(0, vocab, n)] for n in lens]
    reqs = [engines[0].add_request(p, SamplingParams(max_new_tokens=max_new))
            for p in prompts]
    for req in reqs[-3:]:
        if not router.migrate_request(req.request_id, 0, 1):
            raise AssertionError("a waiting request was not stolen")
    moved = []
    for _ in range(2000):
        for req in reqs[:5]:
            if (len(moved) < ROUTER_MIGRATIONS
                    and req.request_id not in moved
                    and 2 <= req.num_output_tokens <= max_new - 3
                    and engines[0].kv.has_request(req.request_id)
                    and router.migrate_request(req.request_id, 0, 1)):
                moved.append(req.request_id)
        if not (router.has_work or router.busy):
            break
        router.step()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0 - build_s
    st = router.rebalance_stats
    if st.stolen != 3 or st.migrated != ROUTER_MIGRATIONS:
        raise AssertionError(f"serve-router-rwkv-f32: {st}, moved {moved}")
    replicas = watch.check("serve-router-rwkv-f32")
    if not all(r["launches"]["rwkv6_chunked_scan"] > 0 for r in replicas):
        raise AssertionError(f"the WKV kernel did not run on both "
                             f"replicas: {replicas}")
    router.check_invariants()
    # the reference's scan runs on the plain version
    kernel_scan = ops.rwkv6_scan
    ops.rwkv6_scan = wkv.rwkv6_scan_ref
    try:
        compared, ties = _check_tokens(
            "serve-router-rwkv-f32", engines[0], prompts,
            [r.output_token_ids for r in reqs], max_new, greedy_trace)
    finally:
        ops.rwkv6_scan = kernel_scan
    out = {"phase": "serve-router-rwkv-f32", "arch": RWKV_ARCH,
           "layers": RWKV_F32_LAYERS, "replicas": 2,
           "requests": len(prompts), "prompt_lens": lens,
           "max_new_tokens": max_new, "stolen": st.stolen,
           "migrated": st.migrated, "migrated_tokens": st.migrated_tokens,
           "migrated_requests": moved, "replicas_run": replicas,
           "tokens_compared": compared, "near_ties": ties,
           "build_s": build_s, "serve_s": serve_s,
           "check_s": time.perf_counter() - t0 - build_s - serve_s}
    emit(out)
    del engines, router, watch
    _free()
    return out


def _percentiles(xs) -> dict:
    xs = np.asarray(xs, float)
    return {"p50": float(np.percentile(xs, 50)),
            "p99": float(np.percentile(xs, 99))} if xs.size else {}


def phase_serve_router_bf16(pa) -> dict:
    """serve-bf16's 32-request batch through `LLMServer` in bf16, on one
    bucketed async graph replica, then on two behind the balanced router
    with its rebalance plane on (live migration allowed).  Measurements
    only: tokens/s, TTFT and inter-token latency, routing and migration
    counts, peak memory."""
    from repro_torch.serving import (ClusterSpec, EngineSpec,
                                     RebalancePolicy, ServeSpec, build)

    engine = EngineSpec(arch=ARCH, reduced=False, bucketed=True,
                        dispatch="async")
    counted = {"paged_flash_attention": pa}
    specs = {"one": ServeSpec(engine=engine),
             "two_balanced": ServeSpec(engine=engine, cluster=ClusterSpec(
                 replicas=2, rebalance=RebalancePolicy(interval=0.05)))}
    rows = {}
    for name, spec in specs.items():
        _free()
        t0 = time.perf_counter()
        srv = build(spec, device=DEV, dtype=torch.bfloat16)
        build_s = time.perf_counter() - t0
        prompts = _prompts(12, 32, srv.cfg.vocab_size)
        watch = _Replicas(srv.replicas, counted)
        stamps = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        rids = []
        for i, p in enumerate(prompts):
            rid = f"{name}-{i}"
            stamps[rid] = []
            srv.subscribe(rid, lambda d, ts=stamps[rid]: ts.append(
                time.perf_counter()) if d.token is not None else None)
            rids.append(srv.submit(p, _sampling(0.8 if i % 8 == 7 else 0.0),
                                   request_id=rid))
        srv.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        outs = srv.outputs(rids)
        vocab = srv.cfg.vocab_size
        for o in outs:
            if len(o.token_ids) != MAX_NEW or not all(
                    0 <= t < vocab for t in o.token_ids):
                raise AssertionError(f"serve-router-bf16 {name}: "
                                     f"{o.request_id} gave {o.token_ids}")
        gaps = [b - a for ts in stamps.values() for a, b in zip(ts, ts[1:])]
        out_tokens = sum(len(o.token_ids) for o in outs)
        row = {"phase": "serve-router-bf16", "run": name,
               "replicas": len(srv.replicas), "requests": len(outs),
               "output_tokens": out_tokens, "wall_s": wall,
               "output_tokens_per_s": out_tokens / wall,
               "ttft_s": _percentiles([o.metrics.ttft() for o in outs]),
               "tpot_s": _percentiles([o.metrics.tpot(len(o.token_ids))
                                       for o in outs]),
               "inter_token_s": _percentiles(gaps),
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "build_s": build_s,
               "replicas_run": watch.check(f"serve-router-bf16 {name}"),
               **_router_stats(srv)}
        if srv.router is not None:
            srv.router.check_invariants()
        emit(row)
        rows[name] = row
        del srv, watch
    _free()
    return rows


# ---------------------------------------------------------- train phases

TRAIN_SEQ = 4096            # tokens a sequence; M = 2 micro-batches of 1
TRAIN_STEPS = 16            # of qwen's bf16 run (30 until the script's time)
# Adam's rate of the bf16 runs: at the launcher's default 1e-3 (the JAX
# launcher's, sized for the reduced CPU models) full-depth qwen1.5-0.5b,
# with no warmup, rises over 30 steps in f32 as in bf16 (12.14 to 12.18
# and 12.22, `tools/train_lr_sweep.py`); at 1e-4 both fall, to 12.05
# (PERF.md)
TRAIN_LR = 1e-4
DOTS_STEPS = 4              # qwen's bf16 steps at remat="dots"
TRAIN_F32_LAYERS = 4        # qwen1.5-0.5b's depth cut of the f32 checks
TRAIN_F32_SEQ = 1024
MOE_TRAIN_LAYERS = 4        # olmoe-1b-7b cut to 4 of 16 layers (~1.9 B)
MOE_TRAIN_STEPS = 10
# the step's loss against the dense cross-entropy (the JAX package's
# bound for its pipelined loss, tests/test_multidevice.py)
TRAIN_LOSS_TOL = 2e-4
# pp=4's Adam moments against pp=1's, of each leaf's largest magnitude:
# the same products in the same order but for the embedding gradient's
# atomic adds on the card (f32 rounding, ~1e-7 of a leaf)
MOMENT_TOL = 1e-5
F32_PEAK = 67e12            # f32 FMA outside the tensor cores (no TF32)


def _train_cfg(arch: str, layers: int, dtype: str):
    """Full-width `arch` folded to one stage and cut to its first `layers`
    layers (a uniform pattern), in `dtype`."""
    import dataclasses

    from repro_torch.configs import BlockSpec, get_config, single_stage

    cfg = single_stage(get_config(arch))
    return dataclasses.replace(
        cfg, num_layers=layers, dtype=dtype,
        pattern=(BlockSpec(cfg.pattern[0].kind, layers),))


def _model_flops(cfg, tokens: int, seq: int) -> float:
    """6 N + 12 L H hd T flops a token (N: the matmul parameters a token
    uses, the layers' and the head's; for MoE the router and the top-k
    experts; L the attention layers), times `tokens`.  An RWKV or
    MAMBA_MLP layer's N is every weight matrix of its block
    (`block_param_defs`); the recurrences' own flops (~0.1% of 6 N at
    rwkv6-3b) are left out."""
    from repro_torch.configs import BlockKind
    from repro_torch.models.transformer import block_param_defs

    est = cfg.params_per_layer_estimate()
    n = cfg.d_model * cfg.padded_vocab
    attn_layers = 0
    for bs in cfg.pattern:
        if bs.kind in (BlockKind.RWKV, BlockKind.MAMBA_MLP):
            n += bs.repeat * sum(
                math.prod(shape) for shape, _ in
                block_param_defs(cfg, bs.kind).values() if len(shape) > 1)
        else:
            attn_layers += bs.repeat
            n += bs.repeat * (est["attn"] + (est["moe_active"] if cfg.is_moe
                                             else est["mlp"]))
    attn = 12 * attn_layers * cfg.num_heads * cfg.head_dim * seq
    return (6 * n + attn) * tokens


def _train_report(run: dict, cfg, seq: int, first: int = 5) -> dict:
    steps = sorted(run["step_s"][first:])
    ms = steps[len(steps) // 2] * 1e3
    return {"loss": run["loss"], "gnorm": run["gnorm"],
            "median_ms_per_step": ms,
            "steps_timed": len(run["step_s"]) - first,
            "tokens_per_s": run["tokens_per_step"] / ms * 1e3,
            "model_tflops_per_s": _model_flops(
                cfg, run["tokens_per_step"], seq) / ms * 1e-9,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def _moe_train_case(dtype, seed):
    """olmoe's training shapes: C for 4,096 rows at top-8 and capacity
    factor 1.25; ragged counts (648 down to 81 rows), finite garbage past
    them; a unit-variance output gradient."""
    from repro_torch.models.moe import capacity

    E, d, ff = 64, 2048, 1024
    C = capacity(TRAIN_SEQ, 8, E, 1.25)
    g = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn(E, C, d, generator=g, device=DEV).to(dtype)
    ws = [(torch.randn(*sh, generator=g, device=DEV) * 0.02).to(dtype)
          for sh in ((E, d, ff), (E, d, ff), (E, ff, d))]
    dout = torch.randn(E, C, d, generator=g, device=DEV).to(dtype)
    counts = torch.arange(C, C - 9 * E, -9, device=DEV, dtype=torch.int32)
    return [x] + ws + [counts], dout


def _grad_excess(mg, grads, args, dout, experts: int = 8):
    """`moe_gemm.grad_excess` a few experts at a time: (worst, max err)."""
    E = dout.shape[0]
    parts = [mg.grad_excess([g[e:e + experts] for g in grads],
                            *(a[e:e + experts] for a in args),
                            dout[e:e + experts])
             for e in range(0, E, experts)]
    return max(p[0] for p in parts), max(p[1] for p in parts)


def _moe_backward_bound(args):
    """Least time of the backward: x and dout's live rows and the three
    weights read once, dx and the three weight gradients written once, at
    the HBM rate, against 16 (live rows) d ff flops (g, u, dWd, dh, dWg,
    dWu and dx's two products, on the live rows) at the f32 peak (the
    products run in f32)."""
    x, w_gate, _, _, counts = args
    E, C, d = x.shape
    ff = w_gate.shape[2]
    elt = x.element_size()
    rows = int(counts.sum())
    nbytes = (2 * rows * d + E * C * d + 6 * E * d * ff) * elt
    flops = 16 * rows * d * ff
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_PEAK * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


def _library_fwd_bwd(args, dout):
    """The torch.bmm gate/up/silu-mul/down sequence in x's dtype, forward
    and backward by autograd (a sequence of calls; never used by the
    port)."""
    leaves = [t.detach().requires_grad_(True) for t in args[:4]]
    fwd = _moe_library_fn(*leaves, args[4])

    def run():
        return torch.autograd.grad(fwd(), leaves, dout)
    return run


def _moe_train_rows(mg, ops) -> list:
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        args, dout = _moe_train_case(dtype, seed=300 + len(rows))
        leaves = [t.detach().requires_grad_(True) for t in args[:4]]
        out = ops.fused_moe_ffn(*leaves, args[4])     # FusedMoEFFN
        if out.grad_fn is None:
            raise AssertionError("train-f32: the MoE kernel under autograd "
                                 "returned no gradient")
        grads = torch.autograd.grad(out, leaves, dout)
        del out
        excess, err = _grad_excess(mg, grads, args, dout)
        del grads
        planted = mg.fused_moe_ffn_backward(*args, dout, dsilu=torch.sigmoid)
        planted_excess, _ = _grad_excess(mg, planted, args, dout)
        del planted
        tf32_excess = None
        if dtype == torch.float32:      # the same backward on TF32 products
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                planted = mg.fused_moe_ffn_backward(*args, dout)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            tf32_excess, _ = _grad_excess(mg, planted, args, dout)
            del planted
        E, C, d = args[0].shape
        rtol, htol, acc = mg.GRAD_TOLERANCE[dtype]
        row = {"phase": "train-f32", "check": "moe-backward",
               "shape": "olmoe train", "dtype": str(dtype).split(".")[-1],
               "E": E, "C": C, "d": d, "ff": args[1].shape[2],
               "live_rows": int(args[4].sum()), "max_abs_err": err,
               "rtol": rtol, "htol": htol, "acc": acc, "excess": excess,
               "planted_excess": planted_excess,
               "planted_tf32_excess": tf32_excess}
        if not excess <= 1.0:
            emit(row)
            raise AssertionError(f"the MoE backward disagrees with autograd "
                                 f"through the plain version: {row}")
        if not planted_excess > 1.0:
            emit(row)
            raise AssertionError(f"the check passes a backward with the "
                                 f"sigmoid for silu's derivative: {row}")
        if tf32_excess is not None and not tf32_excess > 1.0:
            emit(row)
            raise AssertionError(f"the check passes an f32 backward on TF32 "
                                 f"products: {row}")
        row["backward_ms"] = time_ms(
            lambda: mg.fused_moe_ffn_backward(*args, dout), 5)
        row["fn_fwd_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
            ops.fused_moe_ffn(*leaves, args[4]), leaves, dout), 5)
        row["plain_fwd_bwd_ms"] = time_ms(
            lambda: mg.fused_moe_ffn_ref_grads(*args, dout), 3, warmup=1)
        row["library_fwd_bwd_ms"] = time_ms(_library_fwd_bwd(args, dout), 5)
        (row["backward_bound_ms"], row["backward_bound_by"], row["bytes"],
         row["flops"]) = _moe_backward_bound(args)
        emit(row)
        rows.append(row)
        del args, dout, leaves
        _free()
    return rows


def phase_train_f32(mg) -> dict:
    """The train step against the dense reference at pp=1 and pp=4, pp=4's
    moments against pp=1's, and the MoE kernel under autograd."""
    from repro_torch.configs import stage_config
    from repro_torch.data.tokens import batches
    from repro_torch.distributed.elastic import repartition_params
    from repro_torch.distributed.optimizer import AdamConfig, adam_init
    from repro_torch.distributed.pipeline import build_train_step
    from repro_torch.kernels import ops
    from repro_torch.models.reference import dense_forward
    from repro_torch.models.transformer import (
        cross_entropy,
        init_params,
        tree_items,
    )

    t0 = time.perf_counter()
    cfg = _train_cfg(ARCH, TRAIN_F32_LAYERS, "float32")
    params = init_params(cfg, 0, dtype=torch.float32, device=DEV)
    batch = next(batches(cfg.vocab_size, 2, 1, TRAIN_F32_SEQ, seed=0))
    toks = torch.as_tensor(batch["tokens"], device=DEV).reshape(
        2, TRAIN_F32_SEQ).long()
    labs = torch.as_tensor(batch["labels"], device=DEV).reshape(
        2, TRAIN_F32_SEQ).long()
    want = float(cross_entropy(dense_forward(cfg, params, toks), labs))
    runs = {}
    for pp in (1, PP):
        cfg_pp = stage_config(cfg, pp) if pp > 1 else cfg
        p = repartition_params(params, cfg, cfg_pp).trainable()
        step = build_train_step(cfg_pp, adam=AdamConfig(lr=0.0),
                                aux_coef=0.0, device=DEV)
        before = {k: t.detach().clone() for k, t in tree_items(p)}
        p, opt, m = step(p, adam_init(p), batch)
        unchanged = all(torch.equal(t.detach(), before[k])
                        for k, t in tree_items(p))
        runs[pp] = {"loss": float(m["loss"]), "gnorm": float(m["gnorm"]),
                    "unchanged_at_lr0": unchanged,
                    "m": {k: t.reshape(-1) for k, t in tree_items(opt.m)},
                    "v": {k: t.reshape(-1) for k, t in tree_items(opt.v)}}
        del p, opt, before, step
        _free()
    worst = {}
    for mom in ("m", "v"):
        worst[mom] = max(
            float((runs[PP][mom][k] - a).abs().max())
            / max(float(a.abs().max()), 1e-30)
            for k, a in runs[1][mom].items())
    out = {"phase": "train-f32", "arch": ARCH, "layers": TRAIN_F32_LAYERS,
           "seq": TRAIN_F32_SEQ, "micro_batches": 2, "dense_loss": want,
           "loss": {pp: r["loss"] for pp, r in runs.items()},
           "loss_err": {pp: abs(r["loss"] - want) for pp, r in runs.items()},
           "loss_tol": TRAIN_LOSS_TOL,
           "gnorm": {pp: r["gnorm"] for pp, r in runs.items()},
           "moment_err_pp4_vs_pp1": worst, "moment_tol": MOMENT_TOL,
           "unchanged_at_lr0": {pp: r["unchanged_at_lr0"]
                                for pp, r in runs.items()}}
    del runs, params
    _free()
    ok = (all(e <= TRAIN_LOSS_TOL for e in out["loss_err"].values())
          and all(v <= MOMENT_TOL for v in worst.values())
          and abs(out["gnorm"][PP] - out["gnorm"][1])
          <= 1e-5 * out["gnorm"][1]
          and all(out["unchanged_at_lr0"].values()))
    out["moe_backward"] = _moe_train_rows(mg, ops)
    out["s"] = time.perf_counter() - t0
    emit(out)
    if not ok:
        raise AssertionError(f"train-f32: the step disagrees: {out}")
    return out


def phase_train_bf16(mg, ckpt_dir: Path) -> dict:
    """qwen1.5-0.5b through the launcher (checkpointing into `ckpt_dir`),
    then the olmoe cut through `launch.train.train`, kernel launches
    counted from 0 around each run."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_lib

    out = {"phase": "train-bf16", "seq": TRAIN_SEQ, "micro_batches": 2}
    for m in ops.COUNTED:
        m.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = train_lib.main(["--arch", ARCH, "--full", "--seq", str(TRAIN_SEQ),
                          "--steps", str(TRAIN_STEPS), "--lr", str(TRAIN_LR),
                          "--ckpt", str(ckpt_dir),
                          "--ckpt-every", str(TRAIN_STEPS // 2)])
    launches = {m.__name__.split(".")[-1]: m.launches for m in ops.COUNTED}
    cfg = _train_cfg(ARCH, 24, "bfloat16")
    qwen = {"arch": ARCH, "layers": 24, "steps": TRAIN_STEPS,
            "s": time.perf_counter() - t0, "launches": launches,
            **_train_report(run, cfg, TRAIN_SEQ)}
    out["qwen"] = qwen
    losses = run["loss"]
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        emit(out)
        raise AssertionError(f"train-bf16: qwen's loss did not fall: "
                             f"{losses}")
    final = run["params"]
    del run
    _free()

    # remat="dots" beside qwen's "full" run above: the weight GEMMs'
    # outputs saved, the rest recomputed
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = train_lib.train(cfg, steps=DOTS_STEPS, seq=TRAIN_SEQ, lr=TRAIN_LR,
                          device=DEV, remat="dots")
    dots = {"remat": "dots", "steps": DOTS_STEPS,
            "s": time.perf_counter() - t0,
            **_train_report(run, cfg, TRAIN_SEQ, first=1)}
    qwen["remat"] = "full"
    out["qwen_dots"] = dots
    del run
    _free()
    if not all(np.isfinite(dots["loss"])):
        emit(out)
        raise AssertionError(f"train-bf16: the dots run's loss is not "
                             f"finite: {dots['loss']}")

    cfg = _train_cfg(MOE_ARCH, MOE_TRAIN_LAYERS, "bfloat16")
    for m in ops.COUNTED:
        m.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = train_lib.train(cfg, steps=MOE_TRAIN_STEPS, seq=TRAIN_SEQ,
                          lr=TRAIN_LR, device=DEV)
    launches = {m.__name__.split(".")[-1]: m.launches for m in ops.COUNTED}
    want = MOE_TRAIN_STEPS * MOE_TRAIN_LAYERS * 2 * 2
    olmoe = {"arch": MOE_ARCH, "layers": MOE_TRAIN_LAYERS,
             "steps": MOE_TRAIN_STEPS, "s": time.perf_counter() - t0,
             "launches": launches, "moe_launches_want": want,
             "moe_launches_per_step": launches["moe_gemm"] / MOE_TRAIN_STEPS,
             **_train_report(run, cfg, TRAIN_SEQ, first=2)}
    out["olmoe"] = olmoe
    del run
    _free()
    emit(out)
    if launches["moe_gemm"] != want or not all(np.isfinite(olmoe["loss"])):
        raise AssertionError(f"train-bf16: olmoe launched the MoE kernel "
                             f"{launches['moe_gemm']} times, want {want}, or "
                             f"its loss is not finite")
    return out, final


def phase_train_ckpt(final, ckpt_dir: Path, first_loss: float,
                     build_engine) -> dict:
    """The checkpoint restores bit for bit, --resume loads it, and an
    engine restarts from its snapshot."""
    from repro_torch.launch import train as train_lib
    from repro_torch.models.transformer import abstract_params, tree_items
    from repro_torch.runtime.checkpoint import load_manifest, restore_checkpoint
    from repro_torch.runtime.engine import PipelineEngine

    t0 = time.perf_counter()
    cfg = _train_cfg(ARCH, 24, "bfloat16")
    got = restore_checkpoint(str(ckpt_dir),
                             abstract_params(cfg, torch.bfloat16), device=DEV)
    mismatched = [k for (k, a), (_, b) in zip(tree_items(got),
                                              tree_items(final))
                  if not torch.equal(a.view(torch.int16),
                                     b.detach().view(torch.int16))]
    manifest = load_manifest(str(ckpt_dir))
    del got, final
    _free()
    run = train_lib.main(["--arch", ARCH, "--full", "--seq", str(TRAIN_SEQ),
                          "--steps", "2", "--lr", str(TRAIN_LR), "--ckpt",
                          str(ckpt_dir), "--resume"])
    resumed = {"resumed": run["resumed"], "loss": run["loss"],
               "fresh_first_loss": first_loss}
    del run
    _free()

    eng = build_engine(ARCH, device=DEV, dtype=torch.bfloat16,
                       cuda_graphs=False)
    prompts = _prompts(14, 4, eng.cfg.vocab_size)
    reqs = [eng.add_request(p, _sampling(0.0)) for p in prompts]
    while not any(0 < r.num_output_tokens < MAX_NEW for r in reqs):
        eng.step()
    for _ in range(3):
        eng.step()
    snap = eng.snapshot_state()
    partial = {r.request_id: list(r.output_token_ids) for r in reqs}
    spec, eng = _spec(eng), None
    eng2, _ = _sibling(spec, cuda_graphs=False)
    PipelineEngine.restore_requests(eng2, snap)
    eng2.drain()
    done = {r.request_id: r for r in eng2.finished}
    restart = {"requests": len(snap["requests"]),
               "emitted_before": {k: len(v) for k, v in partial.items()},
               "finished": sum(r.is_finished and r.num_output_tokens
                               == MAX_NEW for r in done.values()),
               "prefix_kept": all(
                   done[k].output_token_ids[:len(v)] == v
                   for k, v in partial.items() if k in done)}
    del eng2, spec
    _free()
    out = {"phase": "train-ckpt", "arch": ARCH,
           "leaves": len(manifest["leaves"]), "extra": manifest["extra"],
           "mismatched_leaves": mismatched, "resume": resumed,
           "engine_restart": restart, "s": time.perf_counter() - t0}
    emit(out)
    ok = (not mismatched and manifest["extra"] == {"step": TRAIN_STEPS - 1}
          and resumed["resumed"] and resumed["loss"][0] < first_loss
          and restart["requests"] == len(prompts)
          and restart["finished"] == len(prompts) and restart["prefix_kept"]
          and any(0 < len(v) < MAX_NEW for v in partial.values()))
    if not ok:
        raise AssertionError(f"train-ckpt failed: {out}")
    return out


# ------------------------------------------------------ train-ssm phases

SSM_F32_SEQ = 1024          # train-ssm-f32's tokens a sequence
RWKV_TRAIN_LAYERS = 4       # full-width rwkv6-3b's depth cut in f32
RWKV_BF16_TRAIN_LAYERS = 8   # and in bf16 (of 32: the script's time)
RWKV_TRAIN_STEPS = 10
JAMBA_TRAIN_LAYERS = 2      # jamba cut to two MAMBA_MLP layers (of 36)
JAMBA_TRAIN_STEPS = 4       # (8 until the script's time)
# the train forms' check: (B or S, T, H, D) for WKV6 (rwkv6-3b's head of
# 64), (S, T, di, ds) for Mamba (jamba's d_state); T = 300: four 64-token
# chunks and a partial one
WKV_CHECK = (2, 300, 4, 64)
MAMBA_CHECK = (2, 300, 256, 16)


def _counts() -> dict:
    from repro_torch.kernels import ops
    return {m.__name__.split(".")[-1]: m.launches for m in ops.COUNTED}


def _zero_counts() -> None:
    from repro_torch.kernels import ops
    for m in ops.COUNTED:
        m.launches = 0


def _ssm_reduced(arch: str):
    """`arch`'s reduced f32 config at widths the kernels take: d = 128
    (whole tiles of the MoE kernel, expert ff 128), RWKV heads of 64 and
    Mamba's d_state 16 (the scan kernels'), one stage."""
    import dataclasses

    from repro_torch.configs import get_config, make_reduced

    cfg = make_reduced(get_config(arch), d_model=128, d_ff=256)
    return dataclasses.replace(cfg.with_plan(pp=1, tp=1), dtype="float32",
                               rwkv_head_dim=64, mamba_d_state=16,
                               moe_d_ff=128 if cfg.moe_d_ff else 0)


def _lr0_step(name: str, cfg, seq: int) -> dict:
    """One lr-0 step of `cfg` in f32 against the cross-entropy of the dense
    reference on the same batch (its recurrences through the kernels)."""
    from repro_torch.data.tokens import batches
    from repro_torch.distributed.optimizer import AdamConfig, adam_init
    from repro_torch.distributed.pipeline import build_train_step
    from repro_torch.models.reference import dense_forward
    from repro_torch.models.transformer import (
        cross_entropy,
        init_params,
        tree_items,
    )

    params = init_params(cfg, 0, dtype=torch.float32, device=DEV)
    batch = next(batches(cfg.vocab_size, 2, 1, seq, seed=0))
    toks, labs = (torch.as_tensor(batch[k], device=DEV).reshape(2, seq).long()
                  for k in ("tokens", "labels"))
    _zero_counts()
    want = float(cross_entropy(dense_forward(cfg, params, toks), labs))
    dense = _counts()
    p = params.trainable()
    step = build_train_step(cfg, adam=AdamConfig(lr=0.0), aux_coef=0.0,
                            device=DEV)
    before = {k: t.detach().clone() for k, t in tree_items(p)}
    _zero_counts()
    p, _, m = step(p, adam_init(p), batch)
    row = {"config": name, "layers": min(cfg.num_layers, cfg.padded_layers),
           "d": cfg.d_model,
           "kinds": sorted({bs.kind.value for bs in cfg.pattern}),
           "seq": seq, "dense_loss": want, "loss": float(m["loss"]),
           "loss_err": abs(float(m["loss"]) - want),
           "gnorm": float(m["gnorm"]),
           "unchanged_at_lr0": all(torch.equal(t.detach(), before[k])
                                   for k, t in tree_items(p)),
           "dense_launches": dense, "step_launches": _counts()}
    del params, p, before, step
    _free()
    return row


def _grad_checks() -> list:
    """The train forms and their planted copies against the sequential
    recurrence, at each decay of `ssm_check`."""
    from repro_torch.models import ssm
    from repro_torch.models import ssm_check as sc

    forms = {"wkv": (ssm.wkv6_train, sc.sequential_wkv6, sc.wkv_case,
                     WKV_CHECK),
             "mamba": (ssm.selective_scan_train, sc.sequential_selective_scan,
                       sc.mamba_case, MAMBA_CHECK)}
    rows = []
    for i, (name, (form, seq_fn, case, shape)) in enumerate(forms.items()):
        for decay in sc.WKV_DECAYS:
            inputs = case(*shape, decay, seed=400 + i, device=DEV)
            res = sc.check(form, seq_fn, inputs)
            res["planted"] = {
                plant: sc.check(sc.planted(plant), seq_fn, inputs)["grad"]
                for plant in sc.PLANTS if plant.startswith(name)}
            rows.append({"form": name, "shape": list(shape), "decay": decay,
                         **res})
    return rows


def phase_train_ssm_f32() -> dict:
    """RWKV and Mamba training in f32: lr-0 steps against the dense
    reference, and the train forms' gradient check."""
    from repro_torch.models import ssm_check as sc

    t0 = time.perf_counter()
    steps = [_lr0_step(f"{arch} reduced", _ssm_reduced(arch), SSM_F32_SEQ)
             for arch in (RWKV_ARCH, JAMBA_ARCH)]
    steps.append(_lr0_step(
        f"{RWKV_ARCH} full width, {RWKV_TRAIN_LAYERS} layers",
        _train_cfg(RWKV_ARCH, RWKV_TRAIN_LAYERS, "float32"), SSM_F32_SEQ))
    checks = _grad_checks()
    out = {"phase": "train-ssm-f32", "micro_batches": 2,
           "loss_tol": TRAIN_LOSS_TOL, "grad_tol": sc.GRAD_TOL,
           "steps": steps, "grad_checks": checks,
           "s": time.perf_counter() - t0}
    emit(out)
    bad = [r["config"] for r in steps
           if not (r["loss_err"] <= TRAIN_LOSS_TOL and r["unchanged_at_lr0"]
                   and r["step_launches"]["rwkv6_scan"] == 0
                   and r["step_launches"]["mamba_scan"] == 0
                   and r["dense_launches"]["rwkv6_scan"]
                   + r["dense_launches"]["mamba_scan"] > 0)]
    bad += [f"{r['form']} {r['decay']}" for r in checks
            if not (r["out"] <= 1.0 and r["grad"] <= 1.0)]
    bad += [f"{r['form']} {plant} passes" for r in checks
            if r["decay"] == "strong"
            for plant, ex in r["planted"].items() if not ex > 1.0]
    if bad:
        raise AssertionError(f"train-ssm-f32 failed: {bad}")
    return out


def phase_train_ssm_bf16() -> dict:
    """rwkv6-3b at full width cut to RWKV_BF16_TRAIN_LAYERS layers, then
    the jamba cut, through `launch.train.train`, the kernels' launches
    counted from 0 around each run."""
    from repro_torch.launch import train as train_lib

    out = {"phase": "train-ssm-bf16", "seq": TRAIN_SEQ, "micro_batches": 2,
           "lr": TRAIN_LR}
    runs = (
        (RWKV_ARCH, _train_cfg(RWKV_ARCH, RWKV_BF16_TRAIN_LAYERS,
                               "bfloat16"), RWKV_TRAIN_STEPS, 3),
        (JAMBA_ARCH, _train_cfg(JAMBA_ARCH, JAMBA_TRAIN_LAYERS, "bfloat16"),
         JAMBA_TRAIN_STEPS, 2))
    for arch, cfg, steps, first in runs:
        _zero_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = train_lib.train(cfg, steps=steps, seq=TRAIN_SEQ, lr=TRAIN_LR,
                              device=DEV)
        row = {"arch": arch, "layers": cfg.num_layers,
               "kinds": sorted({bs.kind.value for bs in cfg.pattern}),
               "params": sum(t.numel() for t in run["params"].parameters()),
               "steps": steps, "s": time.perf_counter() - t0,
               "launches": _counts(), **_train_report(run, cfg, TRAIN_SEQ,
                                                      first=first)}
        out[arch] = row
        del run
        _free()
        losses = row["loss"]
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
                and row["launches"]["rwkv6_scan"] == 0
                and row["launches"]["mamba_scan"] == 0):
            emit(out)
            raise AssertionError(f"train-ssm-bf16: {arch}'s loss did not "
                                 f"fall, or a scan kernel launched: {row}")
    emit(out)
    return out


# ------------------------------------------------------------ rank phases

RANK_ARCH = PP_ARCH         # qwen2.5-14b: pp=2 x tp=2 a rank 20:4 heads
RANK_PP, RANK_TP = 2, 2
RANK_F32_LAYERS = 4
RANK_TRAIN_SEQ = 1024       # tokens a sequence, one a data rank
RANK_TRAIN_STEPS = 3
# depth cuts that keep the script inside its time: serve-ranks-bf16's
# qwen2.5-14b (of 48) and train-ranks' bf16 qwen1.5-0.5b (of 24)
RANK_BF16_LAYERS = 4
RANK_TRAIN_BF16_LAYERS = 12
# the rank engine's state in and out (serve-ranks-f32's further runs): the
# prefix run's sharing requests arrive at this step, after the first's
# prefill froze its pages; the migration run takes the first 4 prompts and
# moves r1 and r2 out at this step; a moved payload's largest error over
# its largest magnitude, against the one-process engine's export
RANK_PREFIX_ARRIVE = 8
RANK_PREFIX_TAIL = 300      # the first prefix prompt's own tokens
RANK_STATE_PROMPT = 200     # the async and migration runs' prompts, cut
RANK_STATE_MAX_NEW = 8      # tokens a request in the state runs
RANK_MOVE_STEP = 12
MOVE_TOL = 1e-3
# the serving stack over the ranks (serve-ranks-f32's spec runs, ~52 s on a
# slow host at the batch's 8 prompts and 16 tokens, hence): the one-engine
# run's first prompts (the 1,500-token one among them), the tokens a
# request in its batch, the router run and the HTTP stream, and after the
# idle wait;
# the idle command's interval (well under the launch's group timeout,
# which is its budget), the idle wait that outlasts it, the request the
# router run migrates once it holds 2 tokens, the aborted HTTP stream's
# token budget
# the batch's prompts the spec's one engine serves: r0, r2 and r3, not the
# 1,500-token r1, which the router run migrates
RANK_SPEC_ONE = (0, 2, 3)
RANK_SPEC_NEW = 8
RANK_IDLE_NEW = 4
RANK_IDLE_S = 1.0
RANK_IDLE_WAIT_S = 2.5
RANK_MIGRATE = "r1"
RANK_VICTIM_TOKENS = 400
# each launch's wall budget (spawn, rendezvous, weights, serving)
RANK_BUDGET_S = {"serve-ranks-f32": 360, "serve-ranks-bf16": 420,
                 "train-ranks": 240, "serve-tp-f32": 240,
                 "serve-tp-bf16": 240, "train-tp": 120,
                 "serve-ep-f32": 300, "serve-ep-bf16": 300, "train-ep": 120}


def _rank_cfg(arch: str, layers: int, dtype: str, pp: int, tp: int):
    """`arch` at full width (cut to `layers` when > 0) staged in `pp`
    stages, planned at `tp`."""
    import dataclasses

    from repro_torch.configs import get_config, single_stage, stage_config

    cfg = _train_cfg(arch, layers, dtype) if layers else dataclasses.replace(
        single_stage(get_config(arch)), dtype=dtype)
    return stage_config(cfg, pp).with_plan(tp=tp)


def _spawn_ranks(fn, layout, job, phase: str, budget_s: float = 0) -> list:
    """`fn(ranks, job)` on every rank of `layout`, one process each on the
    card (gloo: the ranks share it), inside the phase's wall budget (or
    `budget_s`); a rank's exception fails the phase."""
    from repro_torch.launch import ranks as rk

    budget_s = budget_s or RANK_BUDGET_S[phase]
    store = ROOT / "build" / "ranks" / phase
    shutil.rmtree(store, ignore_errors=True)
    return rk.spawn(fn, layout, (job,), backend="gloo", store_dir=str(store),
                    threads=1, timeout_s=budget_s, group_timeout_s=budget_s)


def _rank_rows(out: list, ticks: int) -> list:
    """Per rank: coordinates, the seconds of its ticks split into host
    work, collectives (transport and the wait for peers) and the wait for
    its own device work, its device compute seconds, bytes a tick per hop
    and per TP all-reduce, bytes staged, peak memory."""
    rows = []
    for o in out:
        st, tr = o["rank_stats"], o["rank_stats"]["traffic"]
        calls = tr["calls"].get("tp", 0)
        rows.append({
            "rank": o["rank"], "coords": o["coords"],
            "host_s": st["host_s"], "device_s": st["device_s"],
            "comm_s": st["comm_s"], "wait_s": st["wait_s"],
            "tick_s": st["tick_s"],
            "comm_s_by_kind": tr["seconds"],
            "hop_bytes_per_tick": tr["bytes"].get("hop", 0) / max(ticks, 1),
            "tp_bytes_per_allreduce": (tr["bytes"].get("tp", 0) / calls
                                       if calls else 0),
            "tp_bytes_per_tick": tr["bytes"].get("tp", 0) / max(ticks, 1),
            "ep_bytes_per_tick": tr["bytes"].get("ep", 0) / max(ticks, 1),
            "staged_bytes_per_tick": tr["staged_bytes"] / max(ticks, 1),
            "weight_bytes": o["weight_bytes"], "peak_bytes": o["peak_bytes"],
            "params_s": o["params_s"], "engine_s": o.get("engine_s"),
            "launches": o["launches"]})
    return rows


def _rank_launches_ok(out: list, cfg) -> dict:
    """paged attention on every rank: once per layer of its stage for each
    phase a tick runs."""
    st = out[0]["stats"]
    per_stage = cfg.layers_per_stage
    want = (st["prefill_ticks"] + st["decode_ticks"]) * per_stage
    got = {o["rank"]: o["launches"]["paged_attention"] for o in out}
    if any(n != want for n in got.values()):
        raise AssertionError(f"paged attention launched {got} times on the "
                             f"ranks, want {want} each")
    return {"want_per_rank": want, "per_rank": got}


def _flat_runs(out: list) -> list:
    """`serve_rank`'s results with ``runs``: per run, every rank's result
    with the rank's own keys."""
    base = ("rank", "coords", "weight_bytes", "params_s")
    return [[{**{k: o[k] for k in base}, **o["runs"][i]} for o in out]
            for i in range(len(out[0]["runs"]))]


def _serve_at(eng, prompts, max_new: int, arrive=None) -> list:
    """`prompts` on `eng` as `serve_rank` adds them (request ``r{i}`` at
    step ``arrive[i]``), to the end: the requests."""
    from repro_torch.core import SamplingParams

    arrive = list(arrive or [0] * len(prompts))
    reqs, steps = [None] * len(prompts), 0
    while any(a is not None for a in arrive) or eng.loop.has_work:
        for i, a in enumerate(arrive):
            if a is not None and steps >= a:
                reqs[i] = eng.add_request(prompts[i], SamplingParams(
                    max_new_tokens=max_new), request_id=f"r{i}")
                arrive[i] = None
        eng.step()
        steps += 1
    return reqs


def _move_at(eng, prompts, rid: str, n_out: int, max_new: int):
    """`prompts` on `eng`, request `rid` moved out (`launch.serve.move_out`)
    once it holds `n_out` tokens, the rest served to the end: the move."""
    from repro_torch.core import SamplingParams
    from repro_torch.launch.serve import move_out

    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=max_new),
                            request_id=f"r{i}")
            for i, p in enumerate(prompts)]
    req = reqs[int(rid[1:])]
    for _ in range(100000):
        if req.num_output_tokens >= n_out:
            moved = move_out(eng, rid)
            if moved is not None:
                eng.drain()
                return moved
        eng.step()
    raise AssertionError(f"{rid} never held {n_out} tokens out of flight")


def _payload_bytes(moved: dict) -> int:
    leaves = list(moved["kv"].values()) + list(
        moved["state"]["slot_leaves"].values())
    return sum(t.numel() * t.element_size() for t in leaves)


def _move_against(eng, prompts, moved: dict, max_new: int) -> dict:
    """A rank engine's move of one of `prompts`' requests against `eng`, a
    fresh one-process engine on the same weights: that engine's move of
    the same request at the same progress (keys, shapes, dtype, and each
    leaf's largest error over its largest magnitude), then the rank
    engine's move resumed on `eng` to the end (its tokens)."""
    from repro_torch.launch.serve import move_in

    rid = moved["request"].request_id
    n = moved["request"].num_output_tokens
    mine = _move_at(eng, prompts, rid, n, max_new)
    same, errs = True, {}
    for got, want in ((moved["kv"], mine["kv"]),
                      (moved["state"]["slot_leaves"],
                       mine["state"]["slot_leaves"])):
        same &= set(got) == set(want)
        for k, w in want.items():
            g = got.get(k)
            if g is None or g.shape != w.shape or g.dtype != w.dtype:
                same = False
                continue
            errs[k] = float((g.float() - w.float()).abs().max()
                            / w.float().abs().max().clamp_min(1e-30))
    req = move_in(eng, moved)
    eng.drain()
    return {"request": rid, "tokens_at_move": n, "same_layout": same,
            "rel_err": errs, "bytes": _payload_bytes(moved),
            "tokens": req.output_token_ids,
            "ok": same and all(e <= MOVE_TOL for e in errs.values())}


def _record_ticks(eng) -> list:
    """The entering batch of every tick of `eng`, as `serve_rank` records
    it on rank 0."""
    ticks = []
    inner = eng.backend.execute

    def execute(ring, exiting_id, now):
        b = (eng.scheduler.get_batch(ring[0][0])
             if ring[0][0] is not None else None)
        ticks.append(None if b is None else [
            [[q.request.request_id, q.start_pos, q.num_tokens]
             for q in b.prefill],
            [q.request.request_id for q in b.decode]])
        return inner(ring, exiting_id, now)

    eng.backend.execute = execute
    return ticks


def ranks_f32_rank(ranks, job: dict) -> dict:
    """serve-ranks-f32's rank function (`launch.ranks.spawn` pickles it by
    name): `torch_rank_jobs.serve_rank`'s runs, then the serving stack's two
    runs (`_spec_rank`) on the same shard."""
    from torch_rank_jobs import job_shard, serve_runs

    dev, dtype, params, keys = job_shard(ranks, job)
    runs = serve_runs(ranks, job, dev, dtype, params)
    spec = [_spec_rank(ranks, job, name, params, dev)
            for name in ("one", "router")]
    return {**keys, "runs": runs, "spec": spec}


def _counts_now() -> dict:
    from repro_torch.kernels import ops
    return {m.__name__.split(".")[-1]: m.launches for m in ops.COUNTED}


def _spec_rank(ranks, job: dict, name: str, params, dev) -> dict:
    """One spec run on this rank: rank 0 builds the server with
    `serving.build(spec, ranks=)` on the rank's shard (its counters at 0
    on every rank) and drives it (`_spec_one`, `_spec_router`); the others
    serve through `serving.build.serve_worker`.  Every rank returns its
    launches and, per engine, its rank stats."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.serving import ServeSpec
    from repro_torch.serving.build import build, serve_worker

    sj = job["spec_job"]
    spec = ServeSpec.from_json(sj[name])
    kw = dict(device=dev, dtype=torch.float32, layers=sj["layers"],
              params=params)
    if ranks.rank:
        stats = serve_worker(spec, ranks, **kw)
        return {"rank_stats": stats, "launches": _counts_now(),
                "traffic": coll.TRAFFIC.snapshot()}
    t0 = time.perf_counter()
    srv = build(spec, ranks=ranks, cuda_graphs=False, idle_s=sj["idle_s"],
                **kw)
    with srv:
        build_s = time.perf_counter() - t0
        srv.replicas[0].backend.reset_counters()
        out = (_spec_one if name == "one" else _spec_router)(srv, sj)
        torch.cuda.synchronize(dev)
        out.update(
            build_s=build_s, cfg_equal=srv.cfg == job["cfg"],
            idle_sent=srv.idle_sent,
            engines=[{"ticks": e.stats.ticks,
                      "prefill_ticks": e.stats.prefill_ticks,
                      "decode_ticks": e.stats.decode_ticks,
                      "rank_stats": e.backend.rank_stats.as_dict()}
                     for e in srv.replicas])
    out.update(launches=_counts_now(), traffic=coll.TRAFFIC.snapshot())
    return out


def _spec_batch(srv, prompts: list, max_new: int, which) -> list:
    """Prompt ``i`` of `prompts` as request ``r{i}`` for each i of
    `which`."""
    from repro_torch.core import SamplingParams

    return [srv.submit(prompts[i], SamplingParams(max_new_tokens=max_new),
                       request_id=f"r{i}") for i in which]


def _spec_one(srv, sj: dict) -> dict:
    """The spec's one rank engine: the batch to the end; then through
    `HTTPFrontend` on 127.0.0.1 one request streamed (TTFT and the gaps
    between its tokens on the client's clock), one aborted mid-stream from
    a second connection (its pages back in the pool), an idle wait past
    the idle interval, and a request served after it."""
    import threading
    import urllib.request

    from repro_torch.serving import HTTPFrontend

    t0 = time.perf_counter()
    rids = _spec_batch(srv, sj["prompts"], RANK_SPEC_NEW, RANK_SPEC_ONE)
    srv.drain()
    torch.cuda.synchronize()
    out = {"wall_s": time.perf_counter() - t0,
           "tokens": [o.token_ids for o in srv.outputs(rids)]}
    eng, prompt = srv.replicas[0], sj["prompts"][0]
    fe = HTTPFrontend(srv, host="127.0.0.1", port=0).start()
    try:
        url = fe.url + "/v1/generate"
        t1 = time.perf_counter()
        frames, at = [], []
        for f in _sse(url + "?stream=1", {"prompt": prompt,
                                          "max_new_tokens": RANK_SPEC_NEW}):
            frames.append(f)
            at.append(time.perf_counter())
        out["http"] = {
            "tokens": [f["token"] for f in frames if f["token"] is not None],
            "end": frames[-1]["finish_reason"], "ttft_s": at[0] - t1,
            "gaps_s": [b - a for a, b in zip(at, at[1:])]}
        free = eng.kv.num_free_pages
        victim = _sse(url + "?stream=1", {
            "prompt": prompt, "max_new_tokens": RANK_VICTIM_TOKENS,
            "request_id": "victim"})
        first = next(victim)

        def abort():
            urllib.request.urlopen(urllib.request.Request(
                fe.url + "/v1/requests/victim", method="DELETE"),
                timeout=120).read()

        aborter = threading.Thread(target=abort)
        aborter.start()
        rest = [first] + list(victim)
        aborter.join(timeout=120)
        out["abort"] = {"end": rest[-1]["finish_reason"],
                        "frames": len(rest),
                        "pages_back": eng.kv.num_free_pages == free
                        and not eng.kv.has_request("victim")}
        sent = srv.idle_sent
        time.sleep(sj["idle_wait"])
        out["idle"] = {"interval_s": sj["idle_s"], "wait_s": sj["idle_wait"],
                       "sent_in_wait": srv.idle_sent - sent}
        req = urllib.request.Request(url, method="POST", data=json.dumps(
            {"prompt": prompt, "max_new_tokens": RANK_IDLE_NEW}).encode())
        with urllib.request.urlopen(req, timeout=120) as resp:
            out["idle"]["tokens_after"] = json.loads(resp.read())["token_ids"]
    finally:
        fe.shutdown()
    return out


def _spec_router(srv, sj: dict) -> dict:
    """The spec's two rank engines behind the balanced router: the batch,
    `RANK_MIGRATE` live-migrated to the other engine once it holds 2
    tokens, to the end."""
    router = srv.router
    t0 = time.perf_counter()
    rids = _spec_batch(srv, sj["prompts"], RANK_SPEC_NEW,
                       range(len(sj["prompts"])))
    req = srv._requests[RANK_MIGRATE]
    moved = None
    for _ in range(100000):
        if moved is None and req.num_output_tokens >= 2:
            src = _where(router, RANK_MIGRATE)
            t1 = time.perf_counter()
            if router.migrate_request(RANK_MIGRATE, src, 1 - src):
                moved = {"src": src, "dst": 1 - src,
                         "tokens_at_move": req.num_output_tokens,
                         "s": time.perf_counter() - t1}
        if not srv.has_work:
            break
        srv.step()
    torch.cuda.synchronize()
    return {"wall_s": time.perf_counter() - t0,
            "tokens": [o.token_ids for o in srv.outputs(rids)],
            "routed": list(router.routed_counts), "moved": moved,
            "migrated": router.rebalance_stats.migrated,
            "finished_on": [sorted(r.request_id for r in e.finished)
                            for e in router.replicas]}


def _spec_checks(out: list, cfg, single: list, stops: list) -> dict:
    """serve-ranks-f32's spec runs against the one-process engine's tokens
    (up to each prompt's near-tie `stops`), and each rank's paged-attention
    launches against `_launch_want` summed over the engines."""
    runs = [o["spec"] for o in out]
    one, router = runs[0]
    row, bad = {}, []

    def same(name, got, i, n):
        k = min(stops[i], n)
        if got[:k] != single[i][:k] or len(got) != n:
            bad.append({"run": name, "request": i, "got": got,
                        "single": single[i], "compared": k})

    for k, (name, run, which) in enumerate((
            ("one", one, RANK_SPEC_ONE),
            ("router", router, range(len(single))))):
        for i, t in zip(which, run["tokens"], strict=True):
            same(name, t, i, RANK_SPEC_NEW)
        # once per layer of the rank's stage for each phase a tick runs,
        # summed over the engines
        want = cfg.layers_per_stage * sum(
            e["prefill_ticks"] + e["decode_ticks"] for e in run["engines"])
        got = {o["rank"]: o["spec"][k]["launches"]["paged_attention"]
               for o in out}
        stats = [e["rank_stats"] for e in run["engines"]]
        row[name] = {
            "engines": len(run["engines"]), "wall_s": run["wall_s"],
            "build_s": run["build_s"], "cfg_equal": run["cfg_equal"],
            "ticks": [e["ticks"] for e in run["engines"]],
            "ms_per_tick": [st["tick_s"] / max(st["ticks"], 1) * 1e3
                            for st in stats],
            "launches": {"want_per_rank": want, "per_rank": got,
                         "ok": all(n == want for n in got.values())},
            "idle_sent": run["idle_sent"]}
    h, ab, idle = one["http"], one["abort"], one["idle"]
    same("http", h["tokens"], 0, RANK_SPEC_NEW)
    same("idle", idle["tokens_after"], 0, RANK_IDLE_NEW)
    row["one"]["http"] = {"ttft_s": h["ttft_s"], "gaps_s": h["gaps_s"],
                          "mean_gap_s": float(np.mean(h["gaps_s"])),
                          "end": h["end"], "abort": ab}
    row["one"]["idle"] = idle
    row["router"].update(
        routed=router["routed"], moved=router["moved"],
        migrated=router["migrated"],
        state_bytes_per_rank=[o["spec"][1]["traffic"]["bytes"].get(
            "state", 0) for o in out])
    ok = (not bad and h["end"] == "length" and ab["end"] == "abort"
          and ab["pages_back"] and idle["sent_in_wait"] >= 1
          and router["migrated"] == 1
          and sum(router["routed"]) == len(router["tokens"]) == len(single)
          and RANK_MIGRATE in router["finished_on"][router["moved"]["dst"]]
          and all(row[n]["launches"]["ok"] and row[n]["cfg_equal"]
                  for n in ("one", "router")))
    row.update(ok=ok, bad=bad)
    return row


def phase_serve_ranks_f32(greedy_trace) -> dict:
    """serve-f32's batch on qwen2.5-14b cut to 4 layers in f32, over pp=2 x
    tp=2 ranks, against the single-process pp=2 engine on the same weights
    (tokens and the batch of every tick) and the dense reference.  In the
    same spawn, the rank engine's state in and out (`serve_rank`'s runs):
    prefix caching on prompts that share a 2-page prefix, traced; async
    dispatch on the batch; r1 and r2 moved out mid-decode, then finished
    in the parent's one-process engine; a one-process move of r3 finished
    in the rank engine (async dispatch and the moves on the batch's first
    4 prompts).  Every token equals the one-process engine's (up
    to the dense reference's first near-tie), the prefix hits equal the
    one-process prefix run's, and the rank trace replays strictly and
    equals that run's trace outside its timing fields."""
    from repro_torch.core import ThrottleConfig
    from repro_torch.launch.mesh import rank_layout
    from repro_torch.launch.serve import FULL_DIMS, move_in
    from repro_torch.models.transformer import init_params
    from repro_torch.runtime.engine import PipelineEngine
    from repro_torch.runtime.trace import Trace, replay_trace
    from repro_torch.serving import ClusterSpec, EngineSpec, ServeSpec

    phase = "serve-ranks-f32"
    t0 = time.perf_counter()
    cfg = _rank_cfg(RANK_ARCH, RANK_F32_LAYERS, "float32", RANK_PP, RANK_TP)
    one = cfg.with_plan(tp=1)
    prompts = _prompts(11, 8, cfg.vocab_size)
    throttle = ThrottleConfig(pipeline_depth=RANK_PP)
    _free()
    params = init_params(one, 0, dtype=torch.float32, device=DEV)

    def engine(**kw):
        return PipelineEngine(one, FULL_DIMS, params, throttle, device=DEV,
                              dtype=torch.float32, cuda_graphs=False, **kw)

    eng = engine()
    ticks = _record_ticks(eng)
    reqs = [eng.add_request(p, _sampling(0.0), request_id=f"r{i}")
            for i, p in enumerate(prompts)]
    eng.drain()
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    single = [r.output_token_ids for r in reqs]
    traces = [greedy_trace(one, params, p, MAX_NEW) for p in prompts]
    # the state runs' one-process side (`RANK_STATE_MAX_NEW` tokens a
    # request): the batch's first 4 prompts cut short, the prefix run
    # (traced), a move in; the weights stay for the moves' return
    n_new = RANK_STATE_MAX_NEW
    four = [p[:RANK_STATE_PROMPT] for p in prompts[:4]]
    four_single = [r.output_token_ids
                   for r in _serve_at(engine(), four, n_new)]
    four_traces = [greedy_trace(one, params, p, n_new) for p in four]
    rng = np.random.default_rng(13)
    shared = [int(t) for t in rng.integers(0, cfg.vocab_size,
                                           2 * FULL_DIMS.page)]
    pre = [shared + [int(t) for t in rng.integers(0, cfg.vocab_size, n)]
           for n in (RANK_PREFIX_TAIL, 9, 40, 3)]
    arrive = [0] + [RANK_PREFIX_ARRIVE] * 3
    store = ROOT / "build" / "ranks"
    store.mkdir(parents=True, exist_ok=True)
    one_trace, rank_trace = (str(store / f"{n}.trace.jsonl")
                             for n in ("one", "rank"))
    eng = engine(enable_prefix_caching=True, trace_path=one_trace)
    pre_single = [r.output_token_ids for r in _serve_at(eng, pre, n_new,
                                                        arrive)]
    eng.recorder.close()
    pre_hits = (eng.scheduler.stats.prefix_hits,
                eng.scheduler.stats.prefix_tokens_avoided)
    pre_traces = [greedy_trace(one, params, p, n_new) for p in pre]
    into = _move_at(engine(), four, "r3", 3, n_new)
    del eng
    _free()
    t1 = time.perf_counter()
    # the serving stack's runs: the spec of one engine and of two behind
    # the balanced router, built over the ranks on the same shard
    engine_spec = EngineSpec(arch=RANK_ARCH, reduced=False)
    spec_job = dict(
        one=ServeSpec(engine=engine_spec).to_json(),
        router=ServeSpec(engine=engine_spec,
                         cluster=ClusterSpec(replicas=2)).to_json(),
        prompts=prompts, layers=RANK_F32_LAYERS, idle_s=RANK_IDLE_S,
        idle_wait=RANK_IDLE_WAIT_S)
    job = dict(cfg=cfg, dims=FULL_DIMS, throttle=throttle, prompts=prompts,
               max_new=MAX_NEW, device=DEV, dtype="float32", seed=0,
               spec_job=spec_job,
               runs=[{},
                     dict(prompts=pre, arrive=arrive, max_new=n_new,
                          enable_prefix_caching=True, trace_out=rank_trace),
                     dict(prompts=four, max_new=n_new, async_dispatch=True),
                     dict(prompts=four, max_new=n_new,
                          export={"r1": RANK_MOVE_STEP,
                                  "r2": RANK_MOVE_STEP}),
                     dict(prompts=[], max_new=n_new, imports=[into])])
    raw = _spawn_ranks(ranks_f32_rank, rank_layout(1, RANK_PP, RANK_TP),
                       job, phase)
    runs = _flat_runs(raw)
    ranks_s = time.perf_counter() - t1
    out = runs[0]
    head = out[0]

    def stop_of(gaps):
        return next((k for k, g in enumerate(gaps) if g < NEAR_TIE),
                    MAX_NEW)

    compared, near_ties, bad = 0, [], []
    for i, ((want, gaps), mine, got) in enumerate(zip(traces, single,
                                                      head["tokens"])):
        stop = stop_of(gaps)
        if stop < MAX_NEW:
            near_ties.append({"request": i, "step": stop, "gap": gaps[stop]})
        if not (head["finished"][i] and len(got) == MAX_NEW
                and got[:stop] == mine[:stop] == want[:stop]):
            bad.append({"request": i, "ranks": got, "single": mine,
                        "reference": want, "compared": stop})
        compared += stop
    # the state runs
    stops = [stop_of(g) for _, g in four_traces]
    pre_stops = [stop_of(g) for _, g in pre_traces]
    prefix, asyn, moves, moved_in = (r[0] for r in runs[1:])
    trace = Trace.load(rank_trace)
    replayed = replay_trace(trace).outputs() == {
        f"r{i}": t for i, t in enumerate(prefix["tokens"])}

    def strip(recs):
        return [{k: strip([v])[0] if isinstance(v, dict) else v
                 for k, v in r.items() if k not in ("now", "at", "host_s")}
                for r in recs]

    one_rec = Trace.load(one_trace)
    trace_equal = (strip(trace.records) == strip(one_rec.records)
                   and strip([trace.header]) == strip([one_rec.header]))
    moved_at = {m["request"].request_id: {
        "tokens_at_move": m["request"].num_output_tokens,
        "bytes": _payload_bytes(m)} for m in moves["moved"]}
    eng = engine()
    finished = {}
    for m in moves["moved"]:
        req = move_in(eng, m)
        eng.drain()
        finished[req.request_id] = req.output_token_ids
    del eng, params
    _free()
    moved_out = [m["request"].request_id for m in moves["moved"]]
    move_ok = sorted(moved_out) == ["r1", "r2"] and all(
        t[:stops[int(r[1:])]] == four_single[int(r[1:])][:stops[int(r[1:])]]
        for r, t in [*finished.items(), *moved_in["moved_in"].items()])
    state = {
        "prefix": {"requests": len(pre), "shared_tokens": len(shared),
                   "hits": prefix["prefix"]["hits"],
                   "tokens_adopted": prefix["prefix"]["tokens"],
                   "one_process": {"hits": pre_hits[0],
                                   "tokens_adopted": pre_hits[1]},
                   "tokens_equal": all(
                       g[:k] == w[:k] == t[:k] for g, w, (t, _), k in zip(
                           prefix["tokens"], pre_single, pre_traces,
                           pre_stops)),
                   "trace_replays": replayed, "trace_equal": trace_equal,
                   "trace_ticks": len(trace.ticks),
                   "ticks": prefix["stats"]["ticks"],
                   "ms_per_tick": prefix["wall_s"] / prefix["stats"]["ticks"]
                   * 1e3},
        "async": {"tokens_equal": all(
                      g[:k] == w[:k] for g, w, k in zip(
                          asyn["tokens"], four_single, stops)),
                  "ticks": asyn["stats"]["ticks"],
                  "requests": len(four),
                  "ms_per_tick": asyn["wall_s"] / asyn["stats"]["ticks"]
                  * 1e3,
                  "sync_ms_per_tick": moves["wall_s"]
                  / moves["stats"]["ticks"] * 1e3,
                  "sync_run": "the migration run: the same 4 prompts, "
                              "sync, r1 and r2 moved out at step "
                              f"{RANK_MOVE_STEP}"},
        "migration": {
            "out": moved_at,
            "out_s": [s_ for d, s_ in moves["move_s"] if d == "out"],
            "in": {"request": "r3", "bytes": _payload_bytes(into),
                   "tokens_at_move": into["request"].num_output_tokens},
            "in_s": [s_ for d, s_ in moved_in["move_s"] if d == "in"],
            "state_bytes_per_rank": [
                o["rank_stats"]["traffic"]["bytes"].get("state", 0)
                for o in runs[3]],
            "state_s_per_rank": [
                o["rank_stats"]["traffic"]["seconds"].get("state", 0.0)
                for o in runs[3]],
            "tokens_equal": move_ok}}
    row = {"phase": phase, "arch": RANK_ARCH, "layers": RANK_F32_LAYERS,
           "pp": RANK_PP, "tp": RANK_TP, "ranks": len(out),
           "backend": "gloo", "requests": len(prompts),
           "tokens_compared": compared, "near_ties": near_ties,
           "ticks": head["stats"]["ticks"],
           "ticks_equal_single": head["ticks"] == ticks,
           "single_ticks": len(ticks), "single_s": single_s,
           "ranks_s": ranks_s, "wall_s": head["wall_s"],
           "per_rank": _rank_rows(out, head["stats"]["ticks"]),
           "state": state,
           "spec": _spec_checks(raw, cfg, single,
                                [stop_of(g) for _, g in traces])}
    try:
        row["launches"] = _rank_launches_ok(out, cfg)
    finally:
        row["s"] = time.perf_counter() - t0
        emit(row)
    if bad or not row["ticks_equal_single"]:
        raise AssertionError(f"{phase}: tokens or ticks differ from the "
                             f"single-process engine's: {bad}")
    pr = state["prefix"]
    if not (pr["tokens_equal"] and pr["trace_replays"] and pr["trace_equal"]
            and (pr["hits"], pr["tokens_adopted"]) == pre_hits
            and pr["hits"] > 0 and state["async"]["tokens_equal"]
            and move_ok):
        raise AssertionError(f"{phase}: a state run disagrees with the "
                             f"one-process engine: {state}")
    if not row["spec"]["ok"]:
        raise AssertionError(f"{phase}: the serving stack over the ranks "
                             f"disagrees: {row['spec']}")
    return row


def phase_serve_ranks_bf16(pp_rows: dict) -> dict:
    """serve-bf16's batch on qwen2.5-14b at full width, cut to
    `RANK_BF16_LAYERS`, in bf16 over pp=2 x tp=2 ranks, bucketed, eager and
    sync."""
    from repro_torch.core import ThrottleConfig
    from repro_torch.launch.mesh import rank_layout
    from repro_torch.launch.serve import FULL_DIMS
    from torch_rank_jobs import serve_rank

    phase = "serve-ranks-bf16"
    t0 = time.perf_counter()
    cfg = _rank_cfg(RANK_ARCH, RANK_BF16_LAYERS, "bfloat16", RANK_PP,
                    RANK_TP)
    prompts = _prompts(12, 32, cfg.vocab_size)
    temps = [0.8 if i % 8 == 7 else 0.0 for i in range(len(prompts))]
    job = dict(cfg=cfg, dims=FULL_DIMS,
               throttle=ThrottleConfig(pipeline_depth=RANK_PP),
               prompts=prompts, temps=temps, max_new=MAX_NEW, device=DEV,
               dtype="bfloat16", seed=0, bucketed=True)
    _free()
    out = _spawn_ranks(serve_rank, rank_layout(1, RANK_PP, RANK_TP), job,
                       phase)
    head = out[0]
    st = head["stats"]
    toks = sum(len(t) for t in head["tokens"])
    vocab = cfg.vocab_size
    ok = all(f and len(t) == MAX_NEW and all(0 <= x < vocab for x in t)
             for f, t in zip(head["finished"], head["tokens"]))
    row = {"phase": phase, "arch": RANK_ARCH, "layers": cfg.num_layers,
           "layers_per_stage": cfg.layers_per_stage, "pp": RANK_PP,
           "tp": RANK_TP, "ranks": len(out), "backend": "gloo",
           "bucketed": True, "cuda_graphs": False, "async_dispatch": False,
           "requests": len(prompts), "temperature_requests": sum(
               t > 0 for t in temps),
           "output_tokens": toks, "wall_s": head["wall_s"],
           "output_tokens_per_s": toks / head["wall_s"],
           "ticks": st["ticks"], "prefill_ticks": st["prefill_ticks"],
           "decode_ticks": st["decode_ticks"],
           "ms_per_tick": head["wall_s"] / st["ticks"] * 1e3,
           "bubble_stage_ticks": st["bubble_stage_ticks"],
           "padded_prefill": st["padded_prefill"],
           "padded_decode": st["padded_decode"],
           "per_rank": _rank_rows(out, st["ticks"]),
           "single_process": {
               f"pp{pp}": {k: r[k] for k in ("output_tokens_per_s",
                                             "ms_per_tick", "ticks",
                                             "cuda_graphs", "bucketed",
                                             "async_dispatch")}
               for pp, r in pp_rows.items()},
           "note": "one card shared by 4 processes: the protocol's cost, "
                   "not pipelining's gain"}
    try:
        row["launches"] = _rank_launches_ok(out, cfg)
    finally:
        row["s"] = time.perf_counter() - t0
        emit(row)
    if not ok:
        raise AssertionError(f"{phase}: a request did not finish with "
                             f"{MAX_NEW} valid tokens")
    return row


def phase_train_ranks() -> dict:
    """qwen1.5-0.5b at full width over dp=2 x pp=2 x tp=2 ranks: the lr-0
    loss of a 4-layer f32 cut against the dense cross-entropy, its weights
    restored at the layout from a checkpoint the parent saved in one
    process; then a cut to `RANK_TRAIN_BF16_LAYERS` in bf16 with ring8 for
    a few steps on one batch, saved across the ranks at its last step and
    restored in the parent, every leaf against each rank's own."""
    from repro_torch.data.tokens import batches
    from repro_torch.launch import ranks as rk
    from repro_torch.launch.mesh import rank_layout
    from repro_torch.launch.train import train_rank
    from repro_torch.models.reference import dense_forward
    from repro_torch.models.transformer import (
        abstract_params,
        cross_entropy,
        init_params,
        leaf_parts,
        param_pspecs,
        shard_block,
        tree_items,
    )
    from repro_torch.runtime.checkpoint import (
        leaf_digest,
        restore_checkpoint,
        save_checkpoint,
    )

    phase = "train-ranks"
    t0 = time.perf_counter()
    layout = rank_layout(2, 2, 2)
    cut = _train_cfg(ARCH, TRAIN_F32_LAYERS, "float32")
    batch = next(batches(cut.vocab_size, 2, 2, RANK_TRAIN_SEQ, seed=0))
    params = init_params(cut, 0, dtype=torch.float32, device=DEV)
    toks, labs = (torch.as_tensor(batch[k], device=DEV).reshape(
        4, RANK_TRAIN_SEQ).long() for k in ("tokens", "labels"))
    want = float(cross_entropy(dense_forward(cut, params, toks), labs))
    ck32, ck16 = (ROOT / "build" / "ranks" / n for n in ("ckpt-f32",
                                                        "ckpt-bf16"))
    for d in (ck32, ck16):
        shutil.rmtree(d, ignore_errors=True)
    t1 = time.perf_counter()
    save_checkpoint(str(ck32), params, extra={"step": 0})
    save32_s = time.perf_counter() - t1
    del params, toks, labs
    _free()
    staged = _rank_cfg(ARCH, TRAIN_F32_LAYERS, "float32", 2, 2)
    full = _rank_cfg(ARCH, RANK_TRAIN_BF16_LAYERS, "bfloat16", 2, 2)
    b16 = next(batches(full.vocab_size, 2, 2, RANK_TRAIN_SEQ, seed=1))
    runs = _spawn_ranks(rk.run_each, layout, [
        (train_rank, dict(cfg=staged, steps=1, batches=[batch], lr=0.0,
                          aux_coef=0.0, device=DEV, dtype="float32",
                          seed=7, ckpt=str(ck32), resume=True)),
        (train_rank, dict(cfg=full, steps=RANK_TRAIN_STEPS,
                          batches=[b16] * RANK_TRAIN_STEPS, lr=TRAIN_LR,
                          grad_compression="ring8", device=DEV,
                          dtype="bfloat16", seed=0, ckpt=str(ck16),
                          ckpt_every=RANK_TRAIN_STEPS,
                          digest=RANK_TRAIN_STEPS))], phase)
    f32, bf16 = [r[0] for r in runs], [r[1] for r in runs]
    # the ranks' checkpoint, restored whole in one process: each rank's
    # block of every leaf is the leaf that rank held
    t1 = time.perf_counter()
    whole = dict(tree_items(restore_checkpoint(
        str(ck16), abstract_params(full, torch.bfloat16))))
    restore16_s = time.perf_counter() - t1
    specs = dict(tree_items(param_pspecs(full)))
    leaves_equal = all(
        leaf_digest(shard_block(whole[k], specs[k], layout, o["rank"],
                                leaf_parts(k)).contiguous()) == v
        for o in bf16 for k, v in o["digests"].items())
    ckpt_bytes = sum(f.stat().st_size for f in ck16.iterdir())
    loss = f32[0]["loss"][0]
    losses = bf16[0]["loss"]
    row = {"phase": phase, "arch": ARCH, "dp": 2, "pp": 2, "tp": 2,
           "ranks": layout.world, "backend": "gloo", "seq": RANK_TRAIN_SEQ,
           "micro_batches": 2, "sequences_per_micro_batch": 2,
           "f32": {"layers": TRAIN_F32_LAYERS, "dense_loss": want,
                   "loss": loss, "loss_err": abs(loss - want),
                   "loss_tol": TRAIN_LOSS_TOL,
                   "same_on_every_rank": len({o["loss"][0] for o in f32})
                   == 1},
           "bf16": {"layers": full.num_layers, "grad_compression": "ring8",
                    "lr": TRAIN_LR, "steps": RANK_TRAIN_STEPS,
                    "batch": "one batch, repeated", "loss": losses,
                    "gnorm": bf16[0]["gnorm"], "step_s": bf16[0]["step_s"],
                    "params_s": bf16[0]["params_s"],
                    "per_rank": [{"rank": o["rank"],
                                  "peak_bytes": o["peak_bytes"],
                                  "weight_bytes": o["weight_bytes"],
                                  "traffic": o["traffic"]} for o in bf16]},
           "checkpoint": {
               "bf16_saved_at_ranks": {
                   "bytes": ckpt_bytes,
                   "write_s_per_rank": [o["ckpt_s"] for o in bf16],
                   "write_bytes_per_rank": [o["ckpt_bytes"] for o in bf16],
                   "restore_whole_s": restore16_s,
                   "leaves_equal_rank_leaves": leaves_equal},
               "f32_restored_at_ranks": {
                   "saved_in_one_process_s": save32_s,
                   "resumed": all(o["resumed"] for o in f32),
                   "read_s_per_rank": [o["params_s"] for o in f32],
                   "read_bytes_per_rank": [o["weight_bytes"] for o in f32]},
               "warm": "the reads follow the writes: page cache warm"},
           "s": time.perf_counter() - t0}
    emit(row)
    shutil.rmtree(ck32, ignore_errors=True)
    shutil.rmtree(ck16, ignore_errors=True)
    if not (row["f32"]["loss_err"] <= TRAIN_LOSS_TOL
            and leaves_equal and all(o["resumed"] for o in f32)
            and row["f32"]["same_on_every_rank"]
            and all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{phase}: the loss disagrees or did not fall")
    return row


# ------------------------------------------------------ tensor-parallel phases

# serve-tp-f32's models, full width, f32: (arch, tp, layers, kinds), a
# uniform pattern cut to its first `layers` layers, jamba to its first
# MAMBA_MLP layer (`cut_to_kinds`; 8.3 GB with its embedding and head),
# whisper-small to its first ENC_LAYER and DEC_LAYER; olmoe's 4 layers are
# 7.5 GB
TP_F32 = (("minicpm3-4b", 2, 4, ()), ("rwkv6-3b", 2, 4, ()),
          (JAMBA_ARCH, 2, 0, ("mamba_mlp",)),
          (MOE_ARCH, 4, 4, ()), ("whisper-small", 4, 0, WHISPER_KINDS))
TP_MAX_NEW = 8
# the request-state move of serve-tp-f32 (r0 taken off its rank engine
# once it holds 3 tokens, in a second run of the same spawn)
TP_MOVE_ARCH, TP_MOVE_LAYERS = "rwkv6-3b", 4
TP_BF16_REQUESTS = 16       # serve-tp-bf16: the jamba cut's one batch
TP_TRAIN_LAYERS = 2         # train-tp: olmoe-1b-7b cut to 2 of 16 layers
# a rank's launches by kernel: its wrapper's name, its module's
WRAPPERS = {"paged_flash_attention": "paged_attention",
            "fused_moe_ffn": "moe_gemm",
            "rwkv6_chunked_scan": "rwkv6_scan",
            "mamba_chunked_scan": "mamba_scan"}


def _gb(nbytes: int) -> float:
    return nbytes / 1e9


def _tp_reference(arch: str, layers: int, kinds, greedy_trace,
                  seed: int) -> tuple:
    """The one-process engine of serve-tp-f32's `arch` (`_f32_engine`) over
    a batch of four prompts: (the ranks' serve job at the same weights, the
    engine's tokens and ticks, the dense reference's tokens and top-2 gaps,
    seconds).  The engine and its weights are freed before returning."""
    from repro_torch.core import SamplingParams
    from repro_torch.launch.serve import enc_inputs

    t0 = time.perf_counter()
    eng = _f32_engine(arch, layers, kinds)
    cfg = eng.cfg
    rng = np.random.default_rng(seed)
    lens = [16, 200] + [int(x) for x in rng.integers(16, 201, 2)]
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, L)]
               for L in lens]
    encs = [enc_inputs(cfg, eng.dims, rng).get("enc_embeds")
            for _ in prompts]
    ticks = _record_ticks(eng)
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=TP_MAX_NEW),
                            request_id=f"r{i}",
                            **({} if e is None else {"enc_embeds": e}))
            for i, (p, e) in enumerate(zip(prompts, encs))]
    eng.drain()
    torch.cuda.synchronize()
    traces = [greedy_trace(cfg, eng.params, p, TP_MAX_NEW, e)
              for p, e in zip(prompts, encs)]
    job = dict(cfg=cfg, dims=eng.dims, throttle=eng.scheduler.cfg,
               prompts=prompts, encs=encs if cfg.is_encoder_decoder
               else None, max_new=TP_MAX_NEW, device=DEV, dtype="float32",
               seed=0)
    single = [r.output_token_ids for r in reqs]
    del eng, reqs
    _free()
    return job, single, ticks, traces, time.perf_counter() - t0


def _state_row(phase: str, arch: str, moved: list, job: dict, single,
               stops: dict, build) -> dict:
    """The move out of a serve phase's second run (`serve_rank`'s runs)
    against a fresh one-process engine on the same weights (`build`;
    `_move_against`): its payloads within `MOVE_TOL` of that engine's
    export of the same request at the same progress, and its tokens,
    resumed there, the one-process run's up to the dense reference's
    first near-tie (`stops`: request index -> step)."""
    (m,) = moved[0]["moved"]
    i = int(m["request"].request_id[1:])
    stop = stops.get(i, job["max_new"])
    eng = build()
    row = _move_against(eng, job["prompts"], m, job["max_new"])
    del eng
    _free()
    row.update(move_s=moved[0]["move_s"], compared=stop,
               state_bytes_per_rank=[
                   o["rank_stats"]["traffic"]["bytes"].get("state", 0)
                   for o in moved])
    row["ok"] &= row["tokens"][:stop] == single[i][:stop]
    emit({"phase": f"{phase} state", "arch": arch, **{
        k: v for k, v in row.items() if k != "tokens"}})
    if not row["ok"]:
        raise AssertionError(f"{phase} {arch}: the moved request's payload "
                             f"or tokens differ from the one-process "
                             f"engine's: {row}")
    return row


def _tp_launches(out: list, cfg) -> dict:
    """Each rank's launches of every kernel against `_launch_want` for the
    batch rank 0's engine served (every rank runs every layer of its
    stage, at pp=1 all of them)."""
    st = out[0]["stats"]
    want = _launch_want(cfg, st["ticks"], st["prefill_ticks"],
                        st["decode_ticks"], WRAPPERS)
    got = {o["rank"]: {w: o["launches"][m] for w, m in WRAPPERS.items()}
           for o in out}
    if any(g != want for g in got.values()):
        raise AssertionError(f"{cfg.name}: the ranks launched {got}, want "
                             f"{want} each")
    return {"want_per_rank": want, "per_rank": got}


def _tp_f32_row(arch: str, tp: int, job: dict, single, ticks, traces,
                out: list, ref_s: float) -> dict:
    """serve-tp-f32's line of one arch: the ranks' tokens against the
    one-process engine's up to the dense reference's first near-tie, the
    engine's against the reference's, the ticks, and each rank's
    launches."""
    head = out[0]
    compared, near_ties, bad = 0, [], []
    for i, ((want, gaps), mine, got) in enumerate(zip(traces, single,
                                                      head["tokens"])):
        stop = next((k for k, g in enumerate(gaps) if g < NEAR_TIE),
                    TP_MAX_NEW)
        if stop < TP_MAX_NEW:
            near_ties.append({"request": i, "step": stop, "gap": gaps[stop]})
        if not (head["finished"][i] and len(got) == TP_MAX_NEW
                and got[:stop] == mine[:stop] == want[:stop]):
            bad.append({"request": i, "ranks": got, "single": mine,
                        "reference": want, "compared": stop})
        compared += stop
    cfg = job["cfg"]
    row = {"phase": "serve-tp-f32", "arch": arch, "tp": tp,
           "layers": cfg.num_layers,
           "kinds": sorted({b.kind.value for b in cfg.pattern}),
           "ranks": len(out), "backend": "gloo",
           "requests": len(job["prompts"]),
           "prompt_lens": [len(p) for p in job["prompts"]],
           "tokens_compared": compared, "near_ties": near_ties,
           "ticks": head["stats"]["ticks"],
           "ticks_equal_single": head["ticks"] == ticks,
           "reference_s": ref_s, "wall_s": head["wall_s"],
           "per_rank": _rank_rows(out, head["stats"]["ticks"])}
    try:
        row["launches"] = _tp_launches(out, cfg)
    finally:
        emit(row)
    if bad or not row["ticks_equal_single"]:
        raise AssertionError(f"serve-tp-f32 {arch}: tokens or ticks differ "
                             f"from the single-process engine's: {bad}")
    return row


def _tp_bf16_job() -> dict:
    """serve-tp-bf16's job: the jamba cut (MAMBA_MLP, MAMBA_MOE and
    ATTN_MOE; 44.0 GB in bf16) at tp=2, bucketed, one batch."""
    from repro_torch.configs import BlockKind
    from repro_torch.core import ThrottleConfig
    from repro_torch.launch.serve import FULL_DIMS, serve_config

    cfg, _ = serve_config(JAMBA_ARCH, dtype=torch.bfloat16,
                          cut=[BlockKind(k) for k in JAMBA_KINDS])
    return dict(cfg=cfg.with_plan(tp=2), dims=FULL_DIMS,
                throttle=ThrottleConfig(pipeline_depth=1),
                prompts=_prompts(12, TP_BF16_REQUESTS, cfg.vocab_size),
                max_new=MAX_NEW, device=DEV, dtype="bfloat16", seed=0,
                bucketed=True)


def _tp_bf16_row(job: dict, out: list, s: float) -> dict:
    head = out[0]
    st = head["stats"]
    cfg = job["cfg"]
    toks = sum(len(t) for t in head["tokens"])
    valid = sum(len(t) == MAX_NEW and all(0 <= x < cfg.vocab_size
                                          for x in t)
                for t in head["tokens"])
    row = {"phase": "serve-tp-bf16", "arch": JAMBA_ARCH,
           "kinds": list(JAMBA_KINDS), "tp": 2, "ranks": len(out),
           "backend": "gloo", "bucketed": True, "cuda_graphs": False,
           "requests": len(job["prompts"]), "valid_requests": valid,
           "finished": sum(head["finished"]), "output_tokens": toks,
           "wall_s": head["wall_s"], "ticks": st["ticks"],
           "prefill_ticks": st["prefill_ticks"],
           "decode_ticks": st["decode_ticks"],
           "ms_per_tick": head["wall_s"] / st["ticks"] * 1e3,
           "peak_gb_per_rank": [_gb(o["peak_bytes"]) for o in out],
           "per_rank": _rank_rows(out, st["ticks"]), "s": s,
           "note": "two processes share one card: the protocol's cost, "
                   "not tensor parallelism's gain"}
    try:
        row["launches"] = _tp_launches(out, cfg)
    finally:
        emit(row)
    if valid != len(job["prompts"]) or not all(head["finished"]):
        raise AssertionError(f"serve-tp-bf16: {valid} of "
                             f"{len(job['prompts'])} requests finished with "
                             f"{MAX_NEW} valid tokens")
    return row


def phase_tp(greedy_trace) -> dict:
    """serve-tp-f32, serve-tp-bf16 and train-tp, in two launches of ranks
    that share the card: at tp=2, minicpm3-4b (MLA_MLP), rwkv6-3b (RWKV)
    and jamba's MAMBA_MLP layer in f32, then the jamba cut in bf16; at
    tp=4, olmoe-1b-7b (ATTN_MOE) and whisper-small (ENC_LAYER, DEC_LAYER)
    in f32, then olmoe's lr-0 train step.  Each f32 model's one-process
    engine runs (and is freed) before its ranks, on the same weights."""
    import dataclasses

    from repro_torch.data.tokens import batches
    from repro_torch.launch import ranks as rk
    from repro_torch.launch.mesh import rank_layout
    from torch_rank_jobs import serve_rank
    from repro_torch.launch.train import train_rank
    from repro_torch.models.reference import dense_forward
    from repro_torch.models.transformer import cross_entropy, init_params

    rows = {"serve-tp-f32": {}}
    for tp in (2, 4):
        t0 = time.perf_counter()
        refs, jobs = [], []
        for i, (arch, t, layers, kinds) in enumerate(TP_F32):
            if t != tp:
                continue
            job, single, ticks, traces, ref_s = _tp_reference(
                arch, layers, kinds, greedy_trace, seed=60 + i)
            job["cfg"] = job["cfg"].with_plan(tp=tp)
            if arch == TP_MOVE_ARCH:
                job["runs"] = [{}, dict(export={"r0": {"tokens": 3}})]
            refs.append((arch, job, single, ticks, traces, ref_s))
            jobs.append((serve_rank, job))
        phases = ["serve-tp-f32"]
        if tp == 2:
            bf16 = _tp_bf16_job()
            jobs.append((serve_rank, bf16))
            phases.append("serve-tp-bf16")
        else:
            # dropless: no expert can hold more rows than there are, so a
            # capacity factor of E / top_k drops none, in the dense forward
            # over both sequences as in the step over one
            cut = _train_cfg(MOE_ARCH, TP_TRAIN_LAYERS, "float32")
            cut = dataclasses.replace(cut, moe_capacity_factor=(
                cut.num_experts / cut.num_experts_per_tok))
            batch = next(batches(cut.vocab_size, 2, 1, RANK_TRAIN_SEQ,
                                 seed=0))
            params = init_params(cut, 0, dtype=torch.float32, device=DEV)
            toks, labs = (torch.as_tensor(batch[k], device=DEV).reshape(
                2, RANK_TRAIN_SEQ).long() for k in ("tokens", "labels"))
            dense = float(cross_entropy(dense_forward(cut, params, toks),
                                        labs))
            del params, toks, labs
            _free()
            jobs.append((train_rank, dict(
                cfg=cut.with_plan(tp=tp), steps=1, batches=[batch], lr=0.0,
                aux_coef=0.0, device=DEV, dtype="float32", seed=0)))
            phases.append("train-tp")
        t1 = time.perf_counter()
        runs = _spawn_ranks(rk.run_each, rank_layout(1, 1, tp), jobs,
                            f"tp={tp}", sum(RANK_BUDGET_S[p]
                                            for p in phases))
        launch_s = time.perf_counter() - t1
        for k, (arch, job, single, ticks, traces, ref_s) in enumerate(refs):
            res = [r[k] for r in runs]
            if "runs" in res[0]:
                res, moved = _flat_runs(res)
            rows["serve-tp-f32"][arch] = _tp_f32_row(
                arch, tp, job, single, ticks, traces, res, ref_s)
            if arch == TP_MOVE_ARCH:
                rows["serve-tp-f32"][arch]["state"] = _state_row(
                    "serve-tp-f32", arch, moved, job, single, {
                        i: next((k for k, g in enumerate(gaps)
                                 if g < NEAR_TIE), TP_MAX_NEW)
                        for i, (_, gaps) in enumerate(traces)},
                    lambda: _f32_engine(TP_MOVE_ARCH, TP_MOVE_LAYERS))
        last = [r[-1] for r in runs]
        if tp == 2:
            rows["serve-tp-bf16"] = _tp_bf16_row(bf16, last, launch_s)
            continue
        loss = last[0]["loss"][0]
        row = {"phase": "train-tp", "arch": MOE_ARCH,
               "layers": TP_TRAIN_LAYERS, "tp": tp, "ranks": len(last),
               "backend": "gloo", "seq": RANK_TRAIN_SEQ,
               "micro_batches": 2, "dense_loss": dense, "loss": loss,
               "loss_err": abs(loss - dense), "loss_tol": TRAIN_LOSS_TOL,
               "same_on_every_rank": len({o["loss"][0] for o in last}) == 1,
               "moe_ff_per_rank": cut.moe_d_ff // tp,
               "launches": {o["rank"]: o["launches"] for o in last},
               "step_s": last[0]["step_s"], "params_s": last[0]["params_s"],
               "peak_gb_per_rank": [_gb(o["peak_bytes"]) for o in last],
               "launch_s": launch_s, "s": time.perf_counter() - t0}
        emit(row)
        rows["train-tp"] = row
        # at least once a layer and micro-batch (the backward's
        # recompute of each layer launches it again)
        layers_moe = TP_TRAIN_LAYERS * 2
        if not (row["loss_err"] <= TRAIN_LOSS_TOL
                and row["same_on_every_rank"]
                and all(o["launches"]["moe_gemm"] >= layers_moe
                        for o in last)):
            raise AssertionError(f"train-tp: the loss disagrees or the MoE "
                                 f"kernel did not run under autograd: {row}")
    return rows


EP_DP, EP_TP = 2, 2
EP_BF16_REQUESTS = 16       # serve-ep-bf16: the kimi-k2 cut's one batch
EP_TRAIN_SEQ = 512          # train-ep: tokens a sequence, one a data rank


def ep_dropless_cf(cfg, dp: int) -> float:
    """The least capacity factor at which expert parallelism over `dp`
    ranks drops no row: every send buffer holds all of a rank's
    assignments (``cap_send >= N``: cf >= dp) and every expert buffer all
    the rows the dp ranks can send it, one a token each (``cap_e >=
    dp * T``: cf >= E_loc / top_k).  The number of experts, the
    one-process engine's dropless factor, is dropless too, but inflates
    each rank's expert buffers dp * cf-fold (jamba's, f32: 2.3 GB a rank
    a prefill tick, beside 14.2 GB of weights and three more ranks)."""
    local = cfg.num_experts // dp
    return float(max(dp, -(-local // cfg.num_experts_per_tok)))


def _ep_caps(cfg, rows: int, dp: int) -> tuple:
    """(cap_send, cap_e) of `moe_apply(ep=)` at `rows` token rows a rank."""
    from repro_torch.models.moe import _round8

    n, cf = rows * cfg.num_experts_per_tok, cfg.moe_capacity_factor
    cap_send = _round8(int(n / dp * cf) + 1)
    local = cfg.num_experts // dp
    return cap_send, _round8(int(dp * cap_send / local * cf) + 1)


def _replica_replay(prompts, dims, throttle, dp: int, max_new: int):
    """The scheduler over `dp` replicas' pools on the host, every sampled
    token 0 (greedy batches do not depend on the tokens): the batch of
    every tick and each row's replica, as `serve_rank` records them."""
    from repro_torch.core import (PipelineScheduler, ReplicaKVManager,
                                  Request, SamplingParams)

    kv = ReplicaKVManager(dp, dims.pages, dims.page)
    sched = PipelineScheduler(
        throttle, kv, max_model_len=dims.page * max(dims.Bp, dims.Bd),
        max_prefill_seqs=dims.Sp, max_chunk_tokens=dims.C,
        max_decode_seqs=dims.Sd)
    for i, p in enumerate(prompts):
        sched.add_request(Request(f"r{i}", list(p),
                                  SamplingParams(max_new_tokens=max_new)))
    ticks, homes = [], []
    while sched.has_work:
        b = sched.schedule()
        if b.is_empty:
            sched.complete(b.batch_id, [])
            ticks.append(None)
            homes.append(None)
            continue
        ticks.append([[[q.request.request_id, q.start_pos, q.num_tokens]
                       for q in b.prefill],
                      [q.request.request_id for q in b.decode]])
        homes.append([[kv.replica_of(q.request.request_id) for q in rows]
                      for rows in (b.prefill, b.decode)])
        sched.complete(b.batch_id, [0] * sum(q.produces_token
                                             for q in b.seqs))
        sched.check_invariants()
    return ticks, homes


def _idle_replica_ticks(homes) -> int:
    """Ticks on which one replica had rows and another none."""
    return sum(1 for h in homes if h is not None
               and len(set(h[0]) | set(h[1])) == 1)


EP_TRACE = ROOT / "build" / "ranks" / "ep-f32.trace.jsonl"
SEQ_TICKS = 3               # sequence-sharded decode ticks, the last at
SEQ_CONTEXT = 524288        # context 524,288 (long_500k's)
SEQ_CHUNK = 2048            # pool pages drawn a generator seed
# the sharded ticks' logits against the unsharded ones', of the latter's
# largest magnitude: f32 throughout, the two differ in the attention's
# summation order (the shard's keys, the merge) and what that moves
SEQ_TOL = 1e-4


def _seq_fill(caches, shard, dp: int, t: int, dev) -> None:
    """Fill `caches` with seeded values for tensor index `t`: every KV
    pool page from its chunk's generator (global pages ``[c * SEQ_CHUNK,
    (c + 1) * SEQ_CHUNK)`` from seed ``1000 * t + c``), the whole
    interleaved sequence (`shard` None) or shard `shard`'s pages of it
    (local page b = global page b * dp + shard); the Mamba states from
    seed ``t``, scaled by 0.1.  Every data replica of one tensor index
    holds the same sequence."""
    for gk, grp in caches.items():
        for name, pool in grp.items():
            if name != "kv":
                g = torch.Generator(device=dev).manual_seed(t)
                pool.copy_(0.1 * torch.randn(pool.shape, generator=g,
                                             device=dev))
                continue
            per = SEQ_CHUNK if shard is None else SEQ_CHUNK // dp
            pages = pool.shape[2] - 1           # the scratch page stays 0
            shape = (pool.shape[1], SEQ_CHUNK) + tuple(pool.shape[3:])
            for c in range(-(-pages // per)):
                g = torch.Generator(device=dev).manual_seed(1000 * t + c)
                chunk = torch.randn(shape, generator=g, device=dev)
                if shard is not None:
                    chunk = chunk[:, shard::dp]
                n = min(per, pages - c * per)
                pool[0, :, c * per:c * per + n] = chunk[:, :n]


def _seq_ticks(ranks, cfg, dims, params, dev, tokens, shard) -> tuple:
    """`SEQ_TICKS` decode ticks of one sequence on the rank tick at
    `dims`, its pools filled by `_seq_fill`: the logits of this rank's
    vocab slice each tick, the seconds a tick, the paged-attention
    launches and the KV pools' bytes."""
    from repro_torch.distributed.pipeline import build_rank_serve_tick
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import serve as serve_lib
    from repro_torch.models import transformer as tfm

    dp, r = ranks.size("data"), ranks.index("data")
    local = tfm.shard_config(cfg, ranks.size("tensor"),
                             tfm.expert_parts(cfg, dp))
    caches = serve_lib.init_caches(local, dims, torch.float32, dev)
    _seq_fill(caches, shard, dp, ranks.index("tensor"), dev)
    tick = build_rank_serve_tick(cfg, dims, ranks)
    table = np.arange(dims.Bd, dtype=np.int32)
    seen, head = [], tfm.head_apply
    tfm.head_apply = lambda *a: seen.append(
        head(*a).float().clone()) or seen[-1]
    launches, times = pa.launches, []
    try:
        for k, tok in enumerate(tokens):
            pos = SEQ_CONTEXT - SEQ_TICKS + k
            g = pos // dims.page
            m = serve_lib.zero_meta(dims)
            m["d_positions"][0] = pos
            m["d_context_lens"][0] = pos + 1
            m["d_block_tables"][0] = table
            m["d_slot_pages"][0] = (g if shard is None else
                                    g // dp if g % dp == r else -1)
            m["d_slot_offsets"][0] = pos % dims.page
            m["d_valid"][0] = 1
            meta = {key: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                    for key, v in serve_lib.host_meta(m, dims).items()}
            meta["p_tok"] = torch.zeros((0, 0), dtype=torch.int32,
                                        device=dev)
            meta["d_tok"] = torch.full((dims.Sd,), tok, dtype=torch.int32,
                                       device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                caches, _ = tick(params, caches, meta, None)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    finally:
        tfm.head_apply = head
    kv = sum(t.numel() * t.element_size() for grp in caches.values()
             for name, t in grp.items() if name == "kv")
    del caches
    return [x.cpu() for x in seen], times, pa.launches - launches, kv


def _seq_shard_run(ranks, job: dict, params, dev) -> dict:
    """Sequence-sharded decode at the `serve_cell_dims(jamba, long_500k,
    data=2)` geometry on this rank's shard: `SEQ_TICKS` ticks over each
    replica's interleaved half of one sequence's KV (the kernel's
    log-sum-exp partials merged over `data`), then the same ticks over the
    whole sequence on every replica (no shard); this rank's logits must
    agree within `SEQ_TOL`."""
    import dataclasses

    from repro_torch.configs import ASSIGNED_SHAPES, get_config
    from repro_torch.launch.shapes import serve_cell_dims

    dp = ranks.size("data")
    local = serve_cell_dims(get_config(JAMBA_ARCH),
                            ASSIGNED_SHAPES["long_500k"], data=dp)
    whole = dataclasses.replace(
        local, pages=dp * local.Bd + local.pages - local.Bd,
        Bd=dp * local.Bd, seq_shard=False)
    tokens = [int(x) for x in np.random.default_rng(17).integers(
        0, job["cfg"].vocab_size, SEQ_TICKS)]
    got, t_shard, n_shard, kv_shard = _seq_ticks(
        ranks, job["cfg"], local, params, dev, tokens, ranks.index("data"))
    torch.cuda.empty_cache()
    want, t_whole, n_whole, kv_whole = _seq_ticks(
        ranks, job["cfg"], whole, params, dev, tokens, None)
    errs = [float((a - b).abs().max()) / float(b.abs().max())
            for a, b in zip(got, want)]
    return {"rank": ranks.rank, "coords": ranks.coords,
            "dims": dataclasses.asdict(local), "context": SEQ_CONTEXT,
            "ticks": SEQ_TICKS, "rel_err": errs, "tol": SEQ_TOL,
            "ok": len(errs) == SEQ_TICKS and max(errs) <= SEQ_TOL,
            "kv_gb_shard": _gb(kv_shard), "kv_gb_whole": _gb(kv_whole),
            "tick_ms_shard": [t * 1e3 for t in t_shard],
            "tick_ms_whole": [t * 1e3 for t in t_whole],
            "attention_launches_shard": n_shard,
            "attention_launches_whole": n_whole}


def ep_f32_rank(ranks, job: dict) -> dict:
    """serve-ep-f32's rank function (`launch.ranks.spawn` pickles it by
    name): `torch_rank_jobs.serve_rank`'s runs, then the sequence-sharded
    decode (`_seq_shard_run`) on the same shard."""
    import gc

    from torch_rank_jobs import job_shard, serve_runs

    dev, dtype, params, keys = job_shard(ranks, job)
    runs = serve_runs(ranks, job, dev, dtype, params)
    gc.collect()
    torch.cuda.empty_cache()
    return {**keys, "runs": runs,
            "seq_shard": _seq_shard_run(ranks, job, params, dev)}


def _ep_f32_job(jamba: dict) -> dict:
    """serve-ep-f32's job: serve-jamba-f32's cut (MAMBA_MLP and ATTN_MOE,
    f32) on its weights (the rank draw is the slice of the whole tree's)
    and its 8 prompts at dp=2 x tp=2, dropless under expert parallelism
    (`ep_dropless_cf`)."""
    import dataclasses

    from repro_torch.core import ThrottleConfig

    cfg = jamba["cfg"].with_plan(tp=EP_TP)
    cfg = dataclasses.replace(cfg,
                              moe_capacity_factor=ep_dropless_cf(cfg, EP_DP))
    EP_TRACE.parent.mkdir(parents=True, exist_ok=True)
    EP_TRACE.unlink(missing_ok=True)
    return dict(cfg=cfg, dims=jamba["dims"],
                throttle=ThrottleConfig(pipeline_depth=1),
                prompts=jamba["prompts"], max_new=jamba["max_new_tokens"],
                device=DEV, dtype="float32", seed=0,
                runs=[dict(trace_out=str(EP_TRACE)),
                      dict(export={"r0": {"tokens": 3}})])


def _ep_trace(head: dict) -> dict:
    """The traced dp=2 run's trace, replayed strictly on this host: its
    header's pools, its ticks' rows' replicas against the ones the run
    recorded, the replay's tokens against the run's."""
    from repro_torch.runtime.trace import Trace, replay_trace

    trace = Trace.load(str(EP_TRACE))
    t0 = time.perf_counter()
    report = replay_trace(trace)
    kv = trace.header["kv"]
    out = {"ticks": len(trace.ticks), "bytes": EP_TRACE.stat().st_size,
           "replicas": kv.get("replicas"), "pool_pages": kv.get("pool_pages"),
           "replay_s": time.perf_counter() - t0,
           "replicas_equal": [t.get("replicas") for t in trace.ticks]
           == head["replicas"],
           "tokens_equal": report.outputs() == {
               f"r{i}": t for i, t in enumerate(head["tokens"])}}
    out["ok"] = (out["replicas"] == EP_DP and out["replicas_equal"]
                 and out["tokens_equal"])
    return out


def _ep_f32_row(job: dict, jamba: dict, out: list, seq: list) -> dict:
    """serve-ep-f32's line: the ranks' tokens against serve-jamba-f32's
    one-process engine's up to the dense reference's first near-tie, the
    ticks and rows' replicas against the host replay, each rank's
    launches, and each rank's sequence-sharded decode (`seq`)."""
    head, cfg, max_new = out[0], job["cfg"], job["max_new"]
    stops = {t["request"]: t["step"] for t in jamba["near_ties"]}
    compared, bad = 0, []
    for i, (mine, got) in enumerate(zip(jamba["tokens"], head["tokens"])):
        stop = stops.get(i, max_new)
        if not (head["finished"][i] and len(got) == max_new
                and got[:stop] == mine[:stop]):
            bad.append({"request": i, "ranks": got, "single": mine,
                        "compared": stop})
        compared += stop
    ticks, homes = _replica_replay(job["prompts"], job["dims"],
                                   job["throttle"], EP_DP, max_new)
    dims = job["dims"]
    row = {"phase": "serve-ep-f32", "arch": JAMBA_ARCH,
           "kinds": list(JAMBA_F32_KINDS), "dp": EP_DP, "tp": EP_TP,
           "ranks": len(out), "backend": "gloo",
           "experts_per_rank": cfg.num_experts // EP_DP,
           "moe_ff_per_rank": cfg.moe_d_ff // EP_TP,
           "capacity_factor": cfg.moe_capacity_factor,
           "caps_prefill_tick": _ep_caps(cfg, dims.Sp * dims.C + dims.Sd,
                                         EP_DP),
           "requests": len(job["prompts"]), "tokens_compared": compared,
           "near_ties": jamba["near_ties"],
           "ticks": head["stats"]["ticks"],
           "ticks_equal_replay": head["ticks"] == ticks,
           "replicas_equal_replay": head["replicas"] == homes,
           "idle_replica_ticks": _idle_replica_ticks(homes),
           "wall_s": head["wall_s"],
           "weight_gb_per_rank": [_gb(o["weight_bytes"]) for o in out],
           "peak_gb_per_rank": [_gb(o["peak_bytes"]) for o in out],
           "per_rank": _rank_rows(out, head["stats"]["ticks"]),
           "seq_shard": seq}
    try:
        row["trace"] = _ep_trace(head)
        row["launches"] = _tp_launches(out, cfg)
    finally:
        emit(row)
    ran_ep = all(o["rank_stats"]["traffic"]["bytes"].get("ep", 0) > 0
                 for o in out)
    if bad or not (row["ticks_equal_replay"] and row["trace"]["ok"]
                   and row["replicas_equal_replay"] and ran_ep):
        raise AssertionError(f"serve-ep-f32: tokens or ticks differ from "
                             f"the one-process engine's and the replay's, "
                             f"or a rank exchanged no expert rows: {bad}")
    # each tick launches the kernel once per attention layer on every rank
    layers = sum(bs.repeat for bs in cfg.pattern
                 if bs.kind.value.startswith("attn"))
    if not all(r["ok"] and r["attention_launches_shard"] == SEQ_TICKS
               * layers for r in seq):
        raise AssertionError(f"serve-ep-f32: the sequence-sharded decode "
                             f"disagrees with the unsharded ticks or did "
                             f"not launch the kernel: {seq}")
    return row


def _ep_bf16_job() -> dict:
    """serve-ep-bf16's job: the kimi-k2 cut (its first ATTN_MOE layer, 384
    experts, 38.9 GB in bf16) at its published tp=2 and dp=2, bucketed, at
    the config's capacity factor."""
    from repro_torch.configs import BlockKind
    from repro_torch.core import ThrottleConfig
    from repro_torch.launch.serve import FULL_DIMS, serve_config

    cfg, _ = serve_config(KIMI_ARCH, dtype=torch.bfloat16,
                          cut=[BlockKind.ATTN_MOE])
    return dict(cfg=cfg.with_plan(tp=EP_TP), dims=FULL_DIMS,
                throttle=ThrottleConfig(pipeline_depth=1),
                prompts=_prompts(13, EP_BF16_REQUESTS, cfg.vocab_size),
                max_new=MAX_NEW, device=DEV, dtype="bfloat16", seed=0,
                bucketed=True)


def _ep_bf16_row(job: dict, out: list) -> dict:
    head = out[0]
    st = head["stats"]
    cfg = job["cfg"]
    toks = sum(len(t) for t in head["tokens"])
    valid = sum(len(t) == MAX_NEW and all(0 <= x < cfg.vocab_size
                                          for x in t)
                for t in head["tokens"])
    first = {}
    for tick, h in zip(head["ticks"], head["replicas"]):
        if tick is not None:
            for (rid, _, _), r in zip(tick[0], h[0]):
                first.setdefault(rid, r)
    row = {"phase": "serve-ep-bf16", "arch": KIMI_ARCH, "kinds": ["attn_moe"],
           "dp": EP_DP, "tp": EP_TP, "ranks": len(out), "backend": "gloo",
           "bucketed": True, "cuda_graphs": False,
           "experts_per_rank": cfg.num_experts // EP_DP,
           "moe_ff_per_rank": cfg.moe_d_ff // EP_TP,
           "capacity_factor": cfg.moe_capacity_factor,
           "requests": len(job["prompts"]),
           "requests_per_replica": [list(first.values()).count(r)
                                    for r in range(EP_DP)],
           "valid_requests": valid, "finished": sum(head["finished"]),
           "output_tokens": toks, "wall_s": head["wall_s"],
           "ticks": st["ticks"], "prefill_ticks": st["prefill_ticks"],
           "decode_ticks": st["decode_ticks"],
           "idle_replica_ticks": _idle_replica_ticks(head["replicas"]),
           "ms_per_tick": head["wall_s"] / st["ticks"] * 1e3,
           "weight_gb_per_rank": [_gb(o["weight_bytes"]) for o in out],
           "peak_gb_per_rank": [_gb(o["peak_bytes"]) for o in out],
           "per_rank": _rank_rows(out, st["ticks"]),
           "note": "four processes share one card: the protocol's cost, "
                   "not expert parallelism's gain"}
    try:
        row["launches"] = _tp_launches(out, cfg)
    finally:
        emit(row)
    if valid != len(job["prompts"]) or not all(head["finished"]) or any(
            o["rank_stats"]["traffic"]["bytes"].get("ep", 0) == 0
            for o in out):
        raise AssertionError(f"serve-ep-bf16 (or its expert exchanges): "
                             f"{valid} of "
                             f"{len(job['prompts'])} requests finished with "
                             f"{MAX_NEW} valid tokens")
    return row


def _ep_train_case():
    """train-ep's config and batch: reduced kimi-k2 (`make_reduced` at the
    MoE kernel's widths: d 128, expert ff 256, 128 a tensor rank; two
    ATTN_MOE layers with the shared expert), f32, dropless for the dense
    forward and under expert parallelism alike (capacity factor E / top_k
    = 2 = `ep_dropless_cf` at dp=2), and one batch of 2 micro-batches of 2
    sequences, one a data rank."""
    import dataclasses

    from repro_torch.configs import BlockKind, BlockSpec, get_config
    from repro_torch.configs import make_reduced
    from repro_torch.data.tokens import batches

    cfg = make_reduced(get_config(KIMI_ARCH), d_model=128, d_ff=256)
    cfg = dataclasses.replace(
        cfg.with_plan(pp=1, tp=1), dtype="float32", moe_d_ff=256,
        num_layers=2, pattern=(BlockSpec(BlockKind.ATTN_MOE, 2),),
        moe_capacity_factor=cfg.num_experts / cfg.num_experts_per_tok)
    assert cfg.moe_capacity_factor >= ep_dropless_cf(cfg, EP_DP)
    return cfg, next(batches(cfg.vocab_size, 2, EP_DP, EP_TRAIN_SEQ, seed=0))


def phase_ep(jamba: dict) -> dict:
    """serve-ep-f32, serve-ep-bf16 and train-ep in one launch of dp=2 x
    tp=2 = 4 ranks that share the card (`launch.ranks.run_each`): the
    jamba cut in f32 on serve-jamba-f32's weights and prompts (its tokens
    are the reference: that engine served them before), then the kimi-k2
    cut in bf16, then reduced kimi-k2's lr-0 train step.  Full-width
    kimi-k2 training does not fit the card: its cut's 38.9 GB of weights
    with Adam's two f32 moments are ~3 x 38.9 GB over the four ranks."""
    from repro_torch.launch import ranks as rk
    from repro_torch.launch.mesh import rank_layout
    from torch_rank_jobs import serve_rank
    from repro_torch.launch.train import train_rank
    from repro_torch.models.reference import dense_forward
    from repro_torch.models.transformer import cross_entropy, init_params

    t0 = time.perf_counter()
    f32 = _ep_f32_job(jamba)
    bf16 = _ep_bf16_job()
    cut, batch = _ep_train_case()
    params = init_params(cut, 0, dtype=torch.float32, device=DEV)
    toks, labs = (torch.as_tensor(batch[k], device=DEV).reshape(
        2 * EP_DP, EP_TRAIN_SEQ).long() for k in ("tokens", "labels"))
    dense = float(cross_entropy(dense_forward(cut, params, toks), labs))
    del params, toks, labs
    _free()
    train = dict(cfg=cut.with_plan(tp=EP_TP), steps=1, batches=[batch],
                 lr=0.0, aux_coef=0.0, device=DEV, dtype="float32", seed=0)
    t1 = time.perf_counter()
    runs = _spawn_ranks(rk.run_each, rank_layout(EP_DP, 1, EP_TP),
                        [(ep_f32_rank, f32), (serve_rank, bf16),
                         (train_rank, train)], "ep",
                        sum(RANK_BUDGET_S[p] for p in
                            ("serve-ep-f32", "serve-ep-bf16", "train-ep")))
    launch_s = time.perf_counter() - t1
    ep32, moved = _flat_runs([r[0] for r in runs])
    seq = [r[0]["seq_shard"] for r in runs]
    rows = {"serve-ep-f32": _ep_f32_row(f32, jamba, ep32, seq),
            "serve-ep-bf16": _ep_bf16_row(bf16, [r[1] for r in runs])}
    last = [r[2] for r in runs]
    loss = last[0]["loss"][0]
    local = cut.num_experts // EP_DP
    row = {"phase": "train-ep", "arch": KIMI_ARCH, "config": "reduced",
           "d_model": cut.d_model, "layers": cut.num_layers, "dp": EP_DP,
           "tp": EP_TP, "ranks": len(last), "backend": "gloo",
           "seq": EP_TRAIN_SEQ, "micro_batches": 2, "dense_loss": dense,
           "loss": loss, "loss_err": abs(loss - dense),
           "loss_tol": TRAIN_LOSS_TOL,
           "same_on_every_rank": len({o["loss"][0] for o in last}) == 1,
           "experts_per_rank": local, "moe_ff_per_rank": cut.moe_d_ff // EP_TP,
           "launches": {o["rank"]: o["launches"] for o in last},
           "ep_bytes": {o["rank"]: o["traffic"]["bytes"].get("ep", 0)
                        for o in last},
           "step_s": last[0]["step_s"], "params_s": last[0]["params_s"],
           "peak_gb_per_rank": [_gb(o["peak_bytes"]) for o in last],
           "launch_s": launch_s, "s": time.perf_counter() - t0}
    emit(row)
    rows["train-ep"] = row
    rows["serve-ep-f32"]["state"] = _state_row(
        "serve-ep-f32", JAMBA_ARCH, moved, f32, jamba["tokens"],
        {t["request"]: t["step"] for t in jamba["near_ties"]},
        lambda: _f32_engine(JAMBA_ARCH, kinds=JAMBA_F32_KINDS))
    # at least once a layer and micro-batch, again in the backward's
    # recompute of each layer
    want = cut.num_layers * 2 * 2
    if not (row["loss_err"] <= TRAIN_LOSS_TOL and row["same_on_every_rank"]
            and all(o["launches"]["moe_gemm"] >= want for o in last)):
        raise AssertionError(f"train-ep: the loss disagrees or the MoE "
                             f"kernel did not run under autograd: {row}")
    return rows


# the dry run's predicted bytes against the card's peak: within these
# factors of it
DRYRUN_BYTES = (0.5, 2.0)


def phase_dryrun(bf16: dict, train_bf16: dict) -> dict:
    """The dry run (`launch.dryrun`) of two programs this script runs, on
    the meta device: serve-bf16's qwen1.5-0.5b tick at `FULL_DIMS` on one
    rank, and train-bf16's qwen step (M = 2 micro-batches of one 4,096-
    token sequence, Adam): predicted per-rank bytes (arguments plus peak
    temporaries) beside `max_memory_allocated`, and the bound's ms at the
    data sheet's rates beside the measured ms a tick and a step."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import rank_layout
    from repro_torch.launch.serve import FULL_DIMS, serve_config
    from repro_torch.launch.shapes import TrainDims
    from repro_torch.launch.train import M, MBG

    one = rank_layout(1, 1, 1)
    cfg, _ = serve_config(ARCH, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    serve = dryrun.count_serve(cfg, FULL_DIMS, one, 0)
    t1 = time.perf_counter()
    train = dryrun.count_train(_train_cfg(ARCH, 24, "bfloat16"),
                               TrainDims(M=M, mbg=MBG, T=TRAIN_SEQ), one, 0)
    t2 = time.perf_counter()
    qwen = train_bf16["qwen"]
    rows = {"serve-bf16 qwen1.5-0.5b tick at FULL_DIMS": (
                serve, bf16["max_memory_allocated"], bf16["ms_per_tick"],
                "measured ms a tick (the bucketed graph engine's mixed "
                "ticks; the count is one full-dims tick)", t1 - t0),
            "train-bf16 qwen1.5-0.5b step": (
                train, qwen["peak_gb"] * 1e9, qwen["median_ms_per_step"],
                "measured median ms a step", t2 - t1)}
    out = {"phase": "dryrun", "rates": "predicted at the H100 SXM data "
                                       "sheet's rates (989 TFLOP/s bf16, "
                                       "3.35 TB/s)",
           "bytes_within": DRYRUN_BYTES, "programs": {}}
    ok = True
    for name, (st, peak, ms, what, secs) in rows.items():
        ratio = st["memory_bytes"] / peak
        ok &= DRYRUN_BYTES[0] <= ratio <= DRYRUN_BYTES[1]
        out["programs"][name] = {
            "predicted_bytes": st["memory_bytes"],
            "argument_bytes": st["argument_bytes"],
            "peak_temporary_bytes": st["peak_live_bytes"],
            "max_memory_allocated": peak, "predicted_over_measured": ratio,
            "flops": st["flops"], "bytes_moved": st["bytes"],
            "bound_ms_predicted": st["bound_s"] * 1e3, "measured_ms": ms,
            "measured": what, "count_s": secs}
    emit(out)
    if not ok:
        raise AssertionError(f"dryrun: predicted bytes outside "
                             f"{DRYRUN_BYTES} of the measured peak")
    return out


def _launches(run: dict, name: str) -> list:
    """A router run's launches of kernel `name`, one count per replica."""
    return [r["launches"][name] for r in run["replicas_run"]]


def _train_launches(ssm_f32: dict, ssm_bf16: dict, module: str) -> dict:
    """A scan kernel's launches on the training paths (0: the train forms
    are plain PyTorch; the dense reference runs the kernel)."""
    out = {}
    for r in ssm_f32["steps"]:
        out[f"train-ssm-f32 {r['config']} (lr-0 step)"] = \
            r["step_launches"][module]
        out[f"train-ssm-f32 {r['config']} (dense reference)"] = \
            r["dense_launches"][module]
    for arch in (RWKV_ARCH, JAMBA_ARCH):
        row = ssm_bf16[arch]
        out[f"train-ssm-bf16 {arch} ({row['layers']} layers, "
            f"{row['steps']} steps)"] = row["launches"][module]
    return out


def _kernel_entry(name, source, replaces, launches, rows, main_row):
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "shape": f"{main_row['shape']} {main_row['dtype']}",
        "max_abs_err": main_row["max_abs_err"],
        "max_abs_err_all_shapes": max(r["max_abs_err"] for r in rows),
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shapes": [{k: r[k] for k in ("shape", "dtype", "max_abs_err",
                                      "excess", "planted_excess",
                                      "planted_tf32_excess", "kernel_ms",
                                      "recurrent_ms", "plain_ms",
                                      "library_ms", "bound_ms", "bound_by",
                                      "lse_max_abs_err", "lse_ms",
                                      "lse_plain_ms")
                    if k in r}
                   for r in rows]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False    # f32 means f32
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT / "src"))
    # the rank phases' batch runs (`torch_rank_jobs.serve_rank`), which
    # the CPU tests share; spawned ranks inherit this path
    sys.path.insert(0, str(ROOT / "tests"))
    try:
        from repro_torch.kernels import build
        from repro_torch.kernels import mamba_scan as s6
        from repro_torch.kernels import moe_gemm as mg
        from repro_torch.kernels import paged_attention as pa
        from repro_torch.kernels import rwkv6_scan as wkv
        from repro_torch.launch.serve import build_engine
        from repro_torch.models.reference import greedy_trace
        from repro_torch.roofline import analysis
    except ImportError as exc:
        print(f"chip_smoke: the repro_torch package is not beside this "
              f"script ({exc})", file=sys.stderr)
        return 1
    global HBM_BYTES_PER_S
    HBM_BYTES_PER_S = analysis.HBM_BW
    PEAK_FLOPS["bfloat16"] = analysis.PEAK_FLOPS

    device = phase_device()
    planted = {PLANTED: planted_source(build),
               MOE_PLANTED: moe_planted_source(build),
               MOE_TF32_PLANTED: moe_tf32_planted_source(build),
               RWKV_PLANTED: rwkv_planted_source(build),
               RWKV_CHUNK_PLANTED: rwkv_chunk_planted_source(build),
               RWKV_TF32_PLANTED: rwkv_tf32_planted_source(build),
               RWKV_RECURRENT: rwkv_recurrent_source(build),
               MAMBA_PLANTED: mamba_planted_source(build),
               MAMBA_SEG_PLANTED: mamba_seg_planted_source(build),
               MAMBA_RECURRENT: mamba_recurrent_source(build)}
    phase_build(build, planted)
    shapes = phase_kernel(pa, planted[PLANTED])
    phase_serve_f32(pa, build_engine, greedy_trace)
    bf16, bf16_weights = phase_serve_bf16(pa, build_engine)
    traced = phase_trace_bf16(pa, bf16_weights)
    del bf16_weights
    phase_sim_h100(traced)
    phase_serve_pp_f32(pa, build_engine, greedy_trace)
    pp_bf16 = phase_serve_pp_bf16(pa, build_engine, layers=PP_LAYERS)
    moe_shapes = phase_moe_kernel(mg, planted[MOE_PLANTED],
                                  planted[MOE_TF32_PLANTED])
    phase_serve_olmoe_f32(pa, mg, greedy_trace)
    olmoe = phase_serve_olmoe_bf16(pa, mg)
    rwkv_shapes = phase_rwkv_kernel(wkv, planted)
    phase_serve_rwkv_f32(wkv, greedy_trace)
    rwkv = phase_serve_rwkv_bf16(wkv, build_engine)
    mamba_shapes = phase_mamba_kernel(s6, planted)
    jamba_f32 = phase_serve_jamba_f32(pa, mg, s6, greedy_trace)
    jamba = phase_serve_jamba_bf16(pa, mg, s6, build_engine)
    router_f32 = phase_serve_router_f32(pa, greedy_trace)
    router_rwkv = phase_serve_router_rwkv_f32(wkv, greedy_trace)
    router_bf16 = phase_serve_router_bf16(pa)
    phase_serve_archs_f32(pa, greedy_trace)
    phase_attention_plain()
    archs_bf16 = phase_serve_archs_bf16(pa, mg, build_engine)
    big_bf16 = phase_serve_pp_bf16(pa, build_engine, BIG_ARCH,
                                   "serve-32b-bf16", profiled=(1,),
                                   layers=BIG_LAYERS)
    train_f32 = phase_train_f32(mg)
    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    train_bf16, final = phase_train_bf16(mg, ckpt_dir)
    phase_dryrun(bf16, train_bf16)
    phase_train_ckpt(final, ckpt_dir, train_bf16["qwen"]["loss"][0],
                     build_engine)
    del final
    ssm_f32 = phase_train_ssm_f32()
    ssm_bf16 = phase_train_ssm_bf16()
    ranks_f32 = phase_serve_ranks_f32(greedy_trace)
    ranks_bf16 = phase_serve_ranks_bf16(pp_bf16)
    phase_train_ranks()
    tp = phase_tp(greedy_trace)
    ep = phase_ep(jamba_f32)
    del jamba_f32

    def tp_launches(kernel: str) -> dict:
        """`kernel`'s launches on every rank of the tensor- and
        expert-parallel serve phases (those of the paths it is on)."""
        out = {}
        runs = [(f"serve-tp-f32 {arch}", row)
                for arch, row in tp["serve-tp-f32"].items()]
        runs.append(("serve-tp-bf16 jamba cut", tp["serve-tp-bf16"]))
        runs.append(("serve-ep-f32 jamba cut", ep["serve-ep-f32"]))
        runs.append(("serve-ep-bf16 kimi-k2 cut", ep["serve-ep-bf16"]))
        for name, row in runs:
            if row["launches"]["want_per_rank"][kernel]:
                for rank, n in row["launches"]["per_rank"].items():
                    out[f"{name} rank {rank}"] = n[kernel]
        return out

    pa_entry = _kernel_entry(
        "paged_flash_attention",
        "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention.py:112",
        bf16["launches"]["paged_flash_attention"], shapes,
        next(r for r in shapes if r["shape"] == "qwen1.5 decode"
             and r["dtype"] == "bfloat16"))
    pa_entry["launches_by_path"] = {
        "serve-bf16": bf16["launches"]["paged_flash_attention"],
        "serve-olmoe-bf16": olmoe["launches"]["paged_flash_attention"],
        "serve-jamba-bf16": jamba["launches"]["paged_flash_attention"],
        **{f"serve-router-f32 {run}": _launches(router_f32[run],
                                                "paged_flash_attention")
           for run in ("balanced", "disagg", "prefix")},
        **{f"serve-router-bf16 {run}": _launches(router_bf16[run],
                                                 "paged_flash_attention")
           for run in router_bf16},
        **{f"serve-pp-bf16 pp={pp}": row["launches"]["paged_flash_attention"]
           for pp, row in pp_bf16.items()},
        **{f"serve-archs-bf16 {arch}": row["launches"]["paged_flash_attention"]
           for arch, row in archs_bf16.items()},
        **{f"serve-32b-bf16 pp={pp}": row["launches"]["paged_flash_attention"]
           for pp, row in big_bf16.items()},
        **{f"{r['phase']} rank {rank}": n for r in (ranks_f32, ranks_bf16)
           for rank, n in r["launches"]["per_rank"].items()},
        **tp_launches("paged_flash_attention")}
    moe_entry = _kernel_entry(
        "fused_moe_ffn", "src/repro_torch/kernels/csrc/moe_ffn.cu",
        "src/repro/kernels/moe_gemm.py:53",
        olmoe["launches"]["fused_moe_ffn"], moe_shapes,
        next(r for r in moe_shapes if r["shape"] == "olmoe serve"
             and r["dtype"] == "bfloat16"))
    moe_entry["launches_by_path"] = {
        "serve-olmoe-bf16": olmoe["launches"]["fused_moe_ffn"],
        "serve-jamba-bf16": jamba["launches"]["fused_moe_ffn"],
        f"serve-archs-bf16 {KIMI_ARCH}":
            archs_bf16[KIMI_ARCH]["launches"]["fused_moe_ffn"],
        "train-bf16 olmoe cut (10 steps)":
            train_bf16["olmoe"]["launches"]["moe_gemm"],
        **{f"train-ssm-f32 {r['config']} (lr-0 step)":
           r["step_launches"]["moe_gemm"] for r in ssm_f32["steps"]},
        **tp_launches("fused_moe_ffn"),
        **{f"train-tp {MOE_ARCH} (lr-0 step) rank {rank}": n["moe_gemm"]
           for rank, n in tp["train-tp"]["launches"].items()},
        **{f"train-ep reduced {KIMI_ARCH} (lr-0 step) rank {rank}":
           n["moe_gemm"] for rank, n in ep["train-ep"]["launches"].items()}}
    # under autograd (train-f32): the kernel forward, the f32 bmm backward
    moe_entry["backward"] = [
        {k: r[k] for k in ("shape", "dtype", "live_rows", "max_abs_err",
                           "excess", "planted_excess",
                           "planted_tf32_excess", "backward_ms",
                           "backward_bound_ms", "backward_bound_by",
                           "fn_fwd_bwd_ms", "plain_fwd_bwd_ms",
                           "library_fwd_bwd_ms")}
        for r in train_f32["moe_backward"]]
    rwkv_entry = _kernel_entry(
        "rwkv6_chunked_scan", "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
        "src/repro/kernels/rwkv6_scan.py:78",
        rwkv["launches"]["rwkv6_chunked_scan"], rwkv_shapes,
        next(r for r in rwkv_shapes if r["shape"] == "rwkv6-3b decode"
             and r["dtype"] == "bfloat16"))
    rwkv_entry["launches_by_path"] = {
        "serve-rwkv-bf16": rwkv["launches"]["rwkv6_chunked_scan"],
        "serve-router-rwkv-f32": _launches(router_rwkv,
                                           "rwkv6_chunked_scan"),
        **_train_launches(ssm_f32, ssm_bf16, "rwkv6_scan"),
        **tp_launches("rwkv6_chunked_scan")}
    mamba_entry = _kernel_entry(
        "mamba_chunked_scan", "src/repro_torch/kernels/csrc/mamba_scan.cu",
        "src/repro/kernels/mamba_scan.py:60",
        jamba["launches"]["mamba_chunked_scan"], mamba_shapes,
        next(r for r in mamba_shapes if r["shape"] == "jamba decode"
             and r["dtype"] == "bfloat16"))
    mamba_entry["launches_by_path"] = {
        "serve-jamba-bf16": jamba["launches"]["mamba_chunked_scan"],
        **_train_launches(ssm_f32, ssm_bf16, "mamba_scan"),
        **tp_launches("mamba_chunked_scan")}
    emit({"phase": "done"})
    emit({"kernels": [pa_entry, moe_entry, rwkv_entry, mamba_entry]})
    print(device["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                 "count": device["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
