"""Smoke run of the PyTorch port on one NVIDIA H100: kernels, serving,
training, the continuous loop, the supervised training world, the
multi-tenant scheduler, the completed serving tier, the GRU and MoE
families and, on two or more cards, the model axis and the seq axis.

    python3 chip_smoke.py

Needs one CUDA card of compute capability 9.0 and ``nvcc``; exits non-zero
without them, and without the ``dct_tpu_torch`` package beside this file.

1. The card: name and power limit (``nvidia-smi``), torch and CUDA versions.
2. Builds every kernel of the serving and training paths from the sources in
   the checkout (``dct_tpu_torch/ops/csrc/flash_fwd.cu`` and ``flash_bwd.cu``,
   both including ``sm90.cuh``; one ``nvcc`` each, in parallel) and prints
   the build time and ptxas's registers, spills and warnings per kernel
   instance (raises if a tensor-core kernel spills or ptxas warns of it,
   as it does when it serializes the wgmmas). Counts the tensor-core
   instructions (``HGMMA``, ``HMMA``) of each tensor-core kernel's instances
   in ``cuobjdump -sass`` of the built libraries (``flash_fwd``,
   ``flash_bwd_dkdv`` and ``flash_bwd_dq``, bf16 and f32 in 3xTF32); raises
   if one has none at some head dim.
3. Holds each kernel against its plain PyTorch version on the card at the
   serving shape (B=32 windows, H=8, T=1024, D=64), f32 and bf16, causal and
   not, with the log-sum-exp; tolerances on o f32 1e-5 (3xTF32 products
   lose about 2^-22 of their size; a single TF32 pass would miss it), bf16
   2e-2, and 1e-4 on lse. Times the kernel, the plain version and
   ``F.scaled_dot_product_attention`` (the library yardstick; the port never
   calls it) with CUDA events: after warm-up, the median of 5 runs of 10
   calls launched back to back, per call (``time_ms``). ``bound_ms`` is the
   larger of the compulsory bytes over 3.35 TB/s and the operations over
   the datasheet's tensor-core peak for the input type: bf16 at 989
   TFLOP/s dense; f32 at f32 accuracy, which the tensor cores give as
   3xTF32 (three TF32 products per product at 495 TFLOP/s), so 3 x the
   operations over 495 TFLOP/s (``bound_basis`` says which).
4. Serves three random packages (seed 0) of the repo's full-width transformer
   (d_model 512, 8 heads, 4 layers, d_ff 2048, seq_len 1024, 5 features):
   ``weather_transformer`` and ``weather_transformer_causal`` (horizon 1) in
   f32, and the bf16 twin of the first (``::bf16`` weights, served at bf16
   compute), through the port's HTTP server on ``cuda``. Posts 1, 3, 8 and 32
   windows to each with the kernels' launch counts set to 0 just before and
   read just after; checks that every answer is finite and sums to 1, that
   two windows match the port's f32 CPU path (plain attention) on the same
   weights within 1e-4 (f32) or 2e-2 (bf16), and that the flash kernel ran
   once per layer of every padded forward.

5. Holds the two backward kernels (dK/dV and dQ) against
   ``flash_attention_bwd_plain`` at the training shape (B=32, H=G=8, T=1024,
   D=64), f32 and bf16, causal and not, on o and lse from the forward kernel
   and a seeded dO. Error: max|kernel - plain| / max|plain| per output,
   tolerance 1e-4 (f32) and 1e-2 (bf16: about one bf16 step of the largest
   gradient; dropping a 64-row tile from a sum errs by some 1/16 of it).
   The absolute errors are printed beside. Times each kernel
   (``time_ms``), the plain version, and the backward of
   ``F.scaled_dot_product_attention`` alone (``library_ms``; it computes
   dq, dk and dv, so it stands on both rows and is compared with the sum of
   the two kernels). ``bound_ms``: compulsory bytes over 3.35 TB/s against
   8*D (dK/dV) or 6*D (dQ) flops per unmasked (q, k) pair over the peak
   (as in 3.).
6. Trains the same full-width configuration on ``cuda`` through the port's
   entry points (``make_windows``, ``contiguous_split``, ``BatchLoader`` at
   batch 32 over seeded AR(1) rows; ``create_train_state`` with adam, lr
   1e-3, seed 0; the step functions):
   (a) one train body with dropout 0, kernels against an injected plain
       attention (plain forward and backward) from identical parameters:
       loss and every gradient within 1e-4 (f32) or 2e-2 (bf16 compute) of
       that gradient's max;
   (b) 8 steps of ``make_epoch_train_eval_step`` with the default dropout
       0.2 for ``weather_transformer`` in bf16 compute (the trainer's
       default) and f32 and ``weather_transformer_causal`` (horizon 1) in
       f32 and bf16, with the launch counts set to 0 just before and read
       just after (4 forward launches per train step and per eval batch, 4
       dK/dV and 4 dQ per train step); every loss and eval sum finite;
       step time (median of 5 timed ``make_train_step`` calls), samples/s
       and tokens/s;
   (c) 8 steps on one fixed batch (bf16 compute, dropout 0) for both
       families at each lr of ``OVERFIT_LRS``, printing every loss; the
       check: ``weather_transformer_causal`` at ``OVERFIT_LR`` ends below
       ``OVERFIT_RATIO`` of its first loss. At lr 1e-3 Adam's first,
       near-sign update overshoots at this width, and the pooled family
       does not overfit 32 window labels in 8 steps at any of these lrs;
   (d) one step with ``remat=True``: 8 forward launches, gradients equal to
       the step without remat within (a)'s tolerance;
   (e) one step of each (b) configuration under ``torch.profiler``: the
       device time of every kernel, summed by kind (the three flash kernels,
       GEMMs, the optimizer's foreach passes, the rest), the distinct kernel
       names of each kind (which kernel of a dtype ran), and the device's
       idle share between the step's first and last kernel.

7. (c1/c2) The two repairs of the wrappers and the grids, on the card:
   forward and backward at head dims 8 and 48 (T=256, B=2, H=4, zero-padded
   by the wrappers to the 16 and 64 instances), f32 and bf16, against the
   plain version (1e-5 on o and 1e-4 of max|plain| on the gradients in f32,
   2e-2 and 1e-2 in bf16); and one forward, dK/dV and dQ at B*H = 65536
   (B=8192, H=8, T=128, D=16, causal), past the 65535 blocks
   ``gridDim.y`` allows, in bf16 and in f32 (the two dtypes' kernels read
   the grid differently), against the plain version with the same gates.
8. (f) ``Trainer.fit`` of ``weather_mlp`` under the val-parity protocol
   (``tests/test_val_parity.py``): 4000 rows of the port's synthetic CSV,
   z-scored per column with the sample std and labelled ``rain -> 1`` as
   the ETL does, the seeded 80/20 split, batch 4, Adam at lr 0.01,
   dropout 0.2, 10 epochs, the trainer's defaults otherwise, on ``cuda:0``
   and then with ``device="cpu"``: both reach val_acc > 0.8 and their
   val_losses lie within 0.03 of each other (the dropout streams differ
   by device, so the band is the claim). The best checkpoint goes through
   ``generate_score_package``; the package's ``score.py`` (numpy) scores
   32 rows within 1e-5 of the checkpoint's model on the card (f32
   compute). Prints each epoch's wall time and samples/s.
9. (g) ``Trainer.fit`` of ``weather_transformer`` at full width (bf16
   compute, Adam lr 1e-3, batch 32, one epoch over the AR(1) rows of 6.,
   passed as ``data=``), with the kernels' launch counts set to 0 just
   before and read just after: 4 forward launches per train step and per
   eval batch, 4 dK/dV and 4 dQ per train step. Prints the epoch's wall
   time, its share per train step and the median device time of a train
   step (CUDA events around each step, no synchronization) beside (b)'s
   median step; reloads ``last.ckpt`` into a fresh model and holds its
   validation loss to the fit's within 1e-6.
10. (h) The continuous loop at the width of 4.:
   (h0) ``python -m dct_tpu_torch.preprocess_job`` over 1,000,000 rows of
       the synthetic weather CSV, then over 100,000 appended rows: the
       generation goes 1 -> 2 with exactly one new part file and the row
       counts; prints each run's seconds and rows/s (the job's wall time,
       interpreter start included); reads the processed dir back through
       ``load_processed_dataset`` with pyarrow never imported (the port's
       parquet codec is all that ran) and prints the host's pyarrow
       version, if it has one, from another interpreter;
   (h1) two ``run_episodic_cycle`` calls for ``weather_transformer`` (bf16
       compute, Adam lr 1e-3, batch 32, one epoch a round) on 6,304
       synthetic rows (4,224 train windows, as (g)), 2,000 rows appended
       between them, with the gate's ``torch`` engine on ``cuda``: cycle 1
       deploys straight to 100%; cycle 2 runs the incremental ETL
       (generation 2), resumes the trajectory (2 epochs completed),
       packages the new best and walks shadow -> gate -> canary -> gate ->
       full, or holds, on a ``LocalEndpointClient``. Launch counts are set
       to 0 just before the gate and read just after: forward launches =
       layers x chunks x 2 models x 1 engine pass (the second consult reads
       the cached ``eval_report.json``), no backward launch; the cycle's
       training launches as in (g). The deployed endpoint (numpy runtime)
       answers 3 held-out windows within 1e-4 of the engine on the card.
       Prints each stage's seconds, the freshness, the gate's decision and
       its 90% bootstrap band, and the engine's windows/s (CUDA-synchronized
       host clock around each engine call);
   (h2) ``python -m dct_tpu_torch.loop_job`` in a subprocess (inline mode,
       2 rounds, the same configuration), 2,000 rows appended once round
       1's fit has started: exit 0, 2 rounds, at least one promotion, finite
       freshness; then a third run, SIGTERMed once its round has started:
       the round's preemption guard takes the signal (the epoch in flight
       ends and is saved), exit 0, reason ``preempted``, no round counted,
       one ``preempt.checkpoint_saved`` and ``last.ckpt`` written after the
       signal.
11. (i) The supervised world at the width of 4., on (h)'s 6,304 rows (4,224
   train windows, as (g)), two epochs a world, each world ``python -m
   dct_tpu_torch.resilience.supervise --world-size 1 -- python -m
   dct_tpu_torch.train_job`` on ``cuda:0`` (backoff 1 s). First an
   uninterrupted world, which each healed world's final train state is
   held to (bitwise, else within 0.03 on the last val_loss, and the
   largest difference printed). (i1) ``crash@rank0:epoch1``: exit 0, two
   attempts, classification ``crash``, ``fault.injected`` /
   ``restart.relaunch`` / ``launch_end`` in ``events.jsonl``, heartbeat
   ``done``; prints the time to recover (the crashed rank's
   ``fault.injected`` to the relaunched rank's ``trainer.startup`` span
   end, where its first step is issued) with ``lost_wall_s`` and the
   backoff. (i2) ``hang@rank0:epoch1`` with a 20 s heartbeat stall window
   (the monitor's startup grace too, so it must exceed a cold rank's 8-11 s
   from launch to its first beat on an H100 host): stall-killed (SIGTERM,
   SIGKILL 3 s later), relaunched once, exit 0; the relaunched rank finds
   the card's memory free again; it runs last, alone on the card (its
   free-memory check reads the whole card), after (j). (i1) and (i2)
   print each attempt's
   seconds from ``launch_start`` to its first beat (``fit_start``). (i3)
   SIGTERM to the rank while ``slow_epoch`` holds it (1 s) in epoch 0: it
   finishes the epoch, saves, exits 75; a free relaunch finishes; no epoch
   lost. (i4)
   ``nan:epoch0`` under ``DCT_HALT_ON_NAN``: the rank exits 76, the
   supervisor 1, no relaunch. (i5) ``python -m dct_tpu_torch.loop_job``
   with no ``DCT_LOOP_TRAIN_MODE`` (supervised rounds): two rounds, rows
   appended once round 1 trains, at least one promotion, freshness per
   round; then a SIGTERM run that drains with exit 0 (reason
   ``preempted``) and ``last.ckpt`` written after the signal. Every rank
   prints its flash launch counts at exit (``[train_job] launches``, all
   but a crashed or killed rank), attempt by attempt: each equals the
   epochs that attempt trained times the per-epoch counts of its data
   (4 forward launches per train step and per eval batch, 4 dK/dV and 4 dQ
   per train step); they join the ``kernels`` line's counts
   (``launches_by_path.supervised``). After the uninterrupted world, (i1),
   (i3) and (i4) run one after another beside (i5).

12. (j) The multi-tenant scheduler at the width of 4., every tenant (h)'s
   bf16 transformer on (h)'s 6,304 rows (the hot tenant on 6,304 other
   rows), through ``python -m dct_tpu_torch.scheduler_job`` on ``cuda:0``
   with ``DCT_METRICS_DIR`` armed:
   (j1) two inline tenants, ``alpha`` (weight 1) and ``beta`` (weight 2),
       one epoch a round, one lease at a time, SIGTERMed once 14 leases
       were released: exit 0, ``sched.stop`` with ``tenant.stop`` for both
       and no ``tenant.parked``; each tenant's granted chip time
       (``dct_tenant_chip_seconds_total`` on one aggregated scrape) within
       20% of its share (1/3, 2/3); beta promotes at least twice (its
       first deploy goes straight, later ones through the gate); the job's
       flash launches equal the rounds x the per-epoch counts plus 8
       forward launches per gate consult (one engine pass per package the
       gate judged); the job loads the libraries this process built and
       builds none, and no library under ``build/dct_tpu_torch`` changes;
   (j2) supervised tenants ``bulk`` (low, 2 epochs a round, epoch 0 held
       3 s by ``slow_epoch``), ``hot`` (high, 1 epoch, one round; its rows
       arrive once bulk's world fired the slow epoch) and, for (j3),
       ``sick`` (low, ``nan:epoch0`` under ``DCT_HALT_ON_NAN``), with
       ``DCT_SCHED_PREEMPT_WAIT_S=2``: ``sched.preempt`` names bulk and
       waiter hot; bulk's world exits 75 after saving epoch 0
       (``supervise_preempted``, no relaunch), hot is granted and trains,
       bulk's next lease resumes at epoch 1 (each ``epoch_end`` once) and
       ends bitwise equal to (i)'s uninterrupted 2-epoch world;
   (j3) sick's rank exits 76, the tenant parks (``health_halt``), bulk is
       granted after sick's release, and the job exits 1. Each rank's
       launches are one epoch of the per-epoch counts; the job's own are
       the gate engines'. (j2)/(j3) run last, alone on the card (the
       revoked world must save and exit within the preemption grace,
       which a loaded card's slower epoch can outlast). Prints each
       sub-phase's wall.

(k) Completes the serving path at the same full width (``serving_phase``;
   ``--phase k`` runs only the kernel build and (k), over a random
   checkpoint and synthetic rows):
   (k1) the int8 twin of the f32 ``weather_transformer`` package (seed 0)
       through the HTTP server on the card, 1, 3, 8 and 32 windows:
       answers finite, summing to 1, within 0.05 (``prob_bound``) of the
       f32 package's, within 1e-4 of the port's CPU path on the int8
       package; 4 flash launches a padded forward; resident bytes of both
       (``torch.cuda.memory_allocated`` deltas and the scorer's tensors);
       (k1b) an MLP package from the port's ``score_gen`` served on the
       card within 1e-5 of the numpy runtime (C4);
   (k2) ``python -m dct_tpu_torch.serve`` over (g)'s checkpoint: process
       start to the banner, the first and the tenth one-window request,
       with the warm start and with ``serve.main(warm=False)``;
   (k3) ``DCT_SERVE_PROCS`` 1 and 2 over the f32 package: at 2 a
       ``crash_worker@proc1:req2`` fault kills child 1, which is respawned
       (``serve.pool_child_death``, ``serve.pool_respawn``), both procs
       answer on one fleet scrape; then a closed-loop sweep at concurrency
       1, 4 and 16 of 8-window requests (rps, p50, p99; launches read off
       ``dct_kernel_launches`` on the scrape, 4 a flush), and at 1 the
       same with one window; SIGTERM exits 0;
   (k4) ``slow_score:ms100`` with ``DCT_SERVE_ADMIT=1`` and the in-process
       autoscaler: 16 keep-alive senders of 4 one-window low-priority
       requests each; sheds are 429 with ``Retry-After``; the shed counter
       and ``dct_serve_workers`` on one scrape; the workers scale up and
       back to 1; the admitted answers equal an unarmed server's bit for
       bit;
   (k5) endpoint mode: the f32 package (blue) and its int8 twin (green)
       at 50/50, mirror to green: both slots routed, ``?slot=`` pins, a
       stage flip written to the state JSON applies to the next request,
       per-slot counters on ``/metrics``, 4 launches a forward (mirror
       copies included);
   (k6) ``python -m dct_tpu_torch.predict_job`` over (h)'s processed rows
       with (g)'s checkpoint in chunks of 256 windows (one d_ff activation
       is 2 GiB in f32 at that chunk; the job's default 8192 would need
       64 GiB): windows/s, 4 launches a chunk, the parquet read back by
       the port's codec, the first 16 windows within 1e-4 of the numpy
       engine;
   (k7) the knobs that select a plain path are refused on the card,
       naming themselves, with no launch: ``DCT_FLASH=off`` and
       ``DCT_FLASH_BLOCK_Q=96`` stop the server at its warm start; one f32
       train step under ``DCT_FLASH_BWD=remat`` launches its 4 forwards
       and raises in the backward with no backward launch.
   (k2), (k3) and (k6) (child processes) run beside (k4), (k5) and (k7).

(l) The GRU and MoE families (``families_phase``; ``--phase l`` runs only
   the kernel build and (l), over synthetic rows):
   (l1) ``weather_moe`` at the width of the bench's MoE leg
       (``bench.py:998-1003``: d_model 512, 8 heads, 2 layers, d_ff 1024,
       T=512, 32 experts, batch 8, bf16 compute; ``auto`` picks sorted):
       one train body at dropout 0 against the same model with plain
       attention (loss and every gradient within 2e-2 of that gradient's
       max; 2 forward, 2 dK/dV and 2 dQ launches; the tokens whose first
       choice differs between the two runs are counted and, where any
       does, the gradients are compared again with the plain run's
       routing pinned to the kernel run's; the worst leaf is printed); the
       sorted and einsum
       engines on the same weights and batch, f32 and bf16, top-1 and
       top-2 (loss, logits and gradients within 1e-5 f32, 2e-2 bf16); the
       bf16 train step of each engine, median of 5 (``sorted_ms``,
       ``einsum_ms``, ``sorted_speedup``, the bench's ``moe`` leg);
   (l2) ``python -m dct_tpu_torch.train_job`` for ``weather_moe`` (bf16)
       and ``weather_gru`` (f32, hidden 64, 2 layers, T=32:
       ``dct_tpu/config.py:74-83``), 2 epochs at batch 32 over LOOP_ROWS
       synthetic rows (those of (h1)'s first cycle):
       a finite val_loss, a checkpoint, the launches of every step and eval
       batch (none for the GRU); its package through the HTTP server on the
       card at 1, 3 and 8 windows within 1e-4 of the numpy runtime (the
       worst window printed; the MoE
       one forward per layer per request, the GRU none); ``predict_job`` in
       chunks of 256 (the MoE over 356 synthetic windows, the GRU over
       those rows): windows/s and every full chunk within 1e-4 of the numpy
       engine on that chunk (the worst row printed). The two families'
       chains run beside (l1) and each other; (l1) and the servers, which
       read this process's launch counts, one at a time.

(m) The model axis (``model_axis_phase``; ``--phase m`` runs only the
   kernel build and (m)), on two or more cards, one ``train_job`` process
   per card on NCCL, at the bench's width (d_model 512, 8 heads, 4 layers,
   d_ff 2048, T=1024; 2,624 synthetic rows: 1,600 windows, 400 train and
   176 val at val fraction 0.75; global batch 16; SGD lr 0.01 momentum
   0.9; 2 epochs). First, on one card and on any count of cards, the
   three kernels are held to their plain versions at the per-rank shapes
   the worlds launch them at, ``[B/D, H/M, T, D]`` = ``[16, 4]``,
   ``[8, 4]`` and ``[16, 2]`` (f32 and bf16; FWD_TOL, BWD_TOL). Each
   world is compared with the W=1 run at the same global batch: every
   rank ends on the same val_loss, within 1e-5 of W=1's (f32) or 2e-2
   (bf16), and launched W=1's kernels (each rank runs every step and
   eval batch), at ``H/M`` and ``G/M`` local heads.
   (m1) ``weather_transformer`` tensor-parallel at ``model=2`` and, on
       four cards, ``data=2, model=2``, f32 and bf16; the best
       checkpoint's ``qkv_proj`` kernel is dense (512 x 1536);
   (m2) ``weather_moe`` (4 experts, the sorted engine, capacity factor 8)
       expert-parallel at ``model=2`` and ``model=4``;
   (m3) on four cards, ZeRO-1 and FSDP at ``data=4`` against DP: the same
       val_loss within 1e-5, less optimizer state (and, FSDP, fewer
       parameter bytes) per rank; under the family tables only the leaves
       outside the tensor-parallel units split (the reference's rule), so
       each runs again with ``DCT_SHARD_RULES`` replicating the units,
       where it must hold at most 0.3x DP's bytes;
   (m4) on four cards, at ``data=2, model=2`` with ZeRO-1, one epoch and a
       resumed one against two straight: the same val_loss and resume
       state within 1e-6.
   Prints each world's val_loss, step time, samples/s, per-rank peak
   memory, parameter and optimizer bytes and launches, then all of them
   on one ``[smoke] (m) summary`` line and in ``phase_m.json`` under the
   phase's directory. On one card it prints one line,
   ``{"phase": "m", "ran": false, "cards": 1}``, and the other phases run
   as before.

(n) The seq axis (``sequence_phase``; ``--phase n`` runs only the kernel
   build and (n)):
   (n0) on any count of cards, the ring's variants of the three kernels
       against their plain versions at B=16, H=8, D=64, f32 and bf16
       (FWD_TOL on o, 1e-4 on lse, BWD_TOL of max|plain| on dq, dk, dv;
       every value finite), each backward with a nonzero lse cotangent:
       square, causal, ``q_offset`` 256 and 512 under window 256 at
       T=256 and 512 (the windowed ring's partial-band steps; some rows,
       or all, reach no key), and non-causal Tq/Tk = 512/256, 256/512,
       256/128, 128/256 (the striped ring's half-chunk blocks at T/S =
       512 and 256). Each kernel's time (``time_ms``), its bound (this
       variant's unmasked pairs: 4, 8 and 6 x D flops a pair; each input
       read once and each output written once, the lse and its
       cotangent included), the plain versions' times and SDPA's forward
       and backward (the band as a boolean mask; SDPA gives o, not the
       lse);
   (n1), (n2) on two or more cards, ``train_job`` worlds on NCCL on
       (m)'s rows and schedule (the bench's width, T=1024, 400 train and
       176 val windows, global batch 16, SGD lr 0.01 momentum 0.9, 2
       epochs), each against a W=1 run of its configuration (the W=1
       runs side by side, one a card): (n1) ``weather_transformer`` f32,
       the ring at ``seq=2`` and, on four cards, a2a at ``seq=4`` and the
       ring at ``data=2, seq=2``; (n2) ``weather_transformer_causal`` f32,
       on four cards the striped ring at ``seq=4``, the contiguous one
       (``DCT_RING_STRIPED=off``) at ``seq=4``, the windowed one
       (``DCT_ATTN_WINDOW=256``) at ``seq=4`` and ``seq=2``, the striped
       one at ``model=2, seq=2``, and bf16 striped at ``seq=4`` (on two
       cards striped and windowed at ``seq=2``). Every rank ends on one
       val_loss, within 1e-4 of W=1's in f32 (2e-2 bf16), and launched
       W=1's kernels times the engine's forward calls per layer on its
       seq index ``my`` (``sp_forward_calls``: the ring S, contiguous
       causal 1 + my, striped 3 + (S - 1), windowed 1 + min(my, steps -
       1), a2a 1); the step ms, samples/s and per-rank peak memory of
       each world are printed, then all of them on ``[smoke] (n)
       summary`` and in ``phase_n.json``. On one card it prints
       ``{"phase": "n", "ran": false, "cards": 1}`` after (n0) and (n3a).
   (n3) ``--phase n3`` runs it alone: the MoE, the GRU and ZeRO-1/FSDP on
       the seq axis. (n3a), on any count of cards: the three kernels
       against their plain versions at the per-rank shapes the MoE's
       worlds launch, ``[B, H, T, 64]`` = ring steps ``[16, 8, 512]``
       (seq=2), ``[8, 8, 512]`` (data=2 seq=2), ``[16, 4, 512]`` (model=2
       seq=2), ``[16, 8, 256]`` (a seq=4 ring), each backward with an lse
       cotangent, and a2a's full-length ``[16, 2|4, 1024]``; f32 and bf16
       (FWD_TOL, BWD_TOL). (n3b), on four cards, ``train_job`` worlds on
       (m)'s rows and schedule against a W=1 run each (the four W=1 runs
       side by side): ``weather_moe`` (4 experts, f32; sorted at capacity
       factor 8, einsum at 1.25, where tokens drop in the global order)
       on the ring at ``seq=2``, a2a at ``seq=4``, the ring at ``data=2
       seq=2`` and at ``model=2 seq=2`` (experts split); ``weather_gru``
       (f32, hidden 64, 2 layers, T=32) at ``seq=2``; the transformer with
       ZeRO-1 and with FSDP at ``data=2 seq=2`` (the units replicated by
       rules). Worlds whose cards add up to four run side by side. Every
       rank ends within 1e-5 of W=1's val_loss (f32; 5e-3 bf16) and
       launched W=1's kernels times its calls per layer (the GRU none).

(o) The engines on a mesh, the re-map of a shard-saved resume, per-layer
   FSDP and rule layouts outside the family tables
   (``mesh_engines_phase``; ``--phase o`` runs only the kernel build and
   (o)), on (m)'s rows (1600 windows of 1024) and a random bench-width
   transformer checkpoint (seed 15):
   (o0) on any count of cards: flash_fwd, f32 and bf16, against its plain
       version at the per-rank shapes of (o2)'s worlds (chunks of
       PREDICT_CHUNK: one card ``[256, 8]``, data=4 ``[64, 8]``, data=2
       model=2 ``[128, 4]``, a data=2 seq=2 ring step ``[128, 8]`` over
       512 of 512 positions; FWD_TOL on o, 1e-4 on the lse), then
       ``predict_job`` on one card in f32 and in bf16
       (``DCT_PREDICT_DTYPE``), bf16 within 2e-2 of f32, each with its
       windows/s (the loop's, and after the first chunk), its set-up
       seconds and 4 forward launches a chunk. In the whole script it
       runs at the end of the (f) chain;
   (o1) on four cards, ``train_job`` on (m)'s schedule (f32, ZeRO-1): one
       epoch at ``data=2, model=2`` resumed for a second at ``data=4``, and
       one epoch by 2 processes at ``data=2`` resumed by 4 (the new ranks
       from their siblings' files). Each saved state restored by one CPU
       process on model=1 equals the dense value tiled from the ranks'
       files leaf for leaf; every rank of a pivoted run logs
       ``shard.topology_remap`` (its leaf count printed) and ends within
       1e-5 of the val_loss of the control continuation on the saving
       grid;
   (o2) on four cards, ``predict_job`` at ``data=4``, ``data=2 model=2``
       and ``data=2 seq=2`` (the ring), f32 within 1e-5 and bf16 within
       2e-2 of one card's f32 probabilities, only the coordinator writing;
       every rank launches one card's chunks times 4 layers times its
       calls per layer (the ring 2); the windows/s of each (the loop's,
       and after the first chunk) and its set-up seconds beside one
       card's;
   (o3) on four cards, one epoch each: FSDP at ``data=4`` (the units
       replicated by rules, so every leaf splits) against DP (1e-5), each
       rank's peak of gathered parameter bytes at most its largest unit's
       beside the small units' held for the step, and below the whole
       model's; the three clauses
       ``qkv_proj.*/kernel$=``, ``head/kernel$=-,model`` and
       ``in_proj/kernel$=seq`` in one world at ``data=2, model=2``
       within 1e-5 of W=1, and ``in_proj/kernel$=-,seq`` at ``data=2
       seq=2`` within 1e-4 (the ring); step ms, samples/s and peak
       memory per rank printed.
   Then ``[smoke] (o) summary`` and ``phase_o.json``; on fewer than four
   cards one line, ``{"phase": "o", "ran": false, "cards": 1}``.

(p) The pipe axis (``pipeline_phase``; ``--phase p`` runs only the kernel
   build and (p)): ``weather_transformer_pp`` at the bench's width
   (4 layers in ``n_stages`` stages) on (m)'s rows and schedule:
   (p0) on any count of cards: the three kernels against their plain
       versions at (p1)'s per-rank microbatch shapes (``[8, 8]``,
       ``[4, 8]``, ``[8, 4]`` of ``[B, H]``; f32 and bf16, FWD_TOL and
       BWD_TOL), then ``train_job`` on one card at ``n_stages=2``,
       ``pipe=1`` (the stages one after another), f32 and bf16 side by
       side, every layer's kernels once a train step and eval batch; the
       f32 package through the HTTP server at 1, 3 and 8 windows and its
       bf16 and int8 twins through the torch scorer at 3, against the
       reference's numpy forward (1e-5 f32 and int8 with its kernels
       dequantized, 2e-2 bf16 against f32), 4 forward launches a
       request; and ``predict_job`` over (m)'s windows, the first and
       last window of every chunk within 1e-5 of the numpy engine, 4
       launches a chunk. In the whole script it runs at the end of the
       (l) chain, once (i)'s drills have ended;
   (p1) on four cards, one epoch each, f32 and bf16: ``pipe=2`` with
       ``M`` 2 and 4 (side by side), ``pipe=4`` (``M`` 4), ``data=2
       pipe=2`` and ``model=2 pipe=2``, each against one card's
       sequential run from the same init (``n_stages`` 2, or 4 for
       ``pipe=4``): every rank's val_loss within 1e-5 (f32) and 5e-3
       (bf16), every rank's launches exactly ``(n_layers / P) x M`` a
       train step and eval batch (backward as many a train step); step
       ms, samples/s, peak memory per rank and each stage's idle share
       of the traced schedules (``DCT_PIPE_TRACE``) beside the bubble
       ``(P-1)/(M+P-1)``;
   (p2) on four cards: a shard-saved resume, one epoch at ``data=2
       pipe=2`` resumed at ``model=2 pipe=2`` and one at ``pipe=2``
       resumed on one card, as (o1): every leaf of the restored state
       equal to the tiled files, every rank logging
       ``shard.topology_remap``, each within 1e-5 of its control
       continuation (``n_stages`` must equal ``pipe``, so a two-stage
       checkpoint resumes on two-stage grids).
   Then ``[smoke] (p) summary`` and ``phase_p.json``; on fewer than four
   cards one line, ``{"phase": "p", "ran": false, "cards": 1}``.
(q) The MPMD pipeline (``mpmd_phase``; ``--phase q`` runs only the kernel
   build and (q)): ``weather_transformer_pp`` at the bench's width on (m)'s
   rows and schedule (global batch 16, SGD), dropout 0, each stage a
   program of its own (:mod:`dct_tpu_torch.parallel.mpmd`):
   (q0) on any count of cards: the three kernels against their plain
       versions at the stage microbatch shapes (``[8, 8]`` and ``[4, 8]``
       of ``[B, H]``; f32 and bf16, FWD_TOL and BWD_TOL); ``train_job`` on
       one card at ``n_stages=2``, ``pipe=1``, every step's loss logged
       (the sequential runs: f32 3 epochs of whole batches; bf16 1 epoch,
       of whole batches and accumulating over M 2 and M 4 microbatches,
       ``_q_seq_key``); the in-process ``MpmdTrainer`` at ``1,1`` on
       ``cuda:0`` (the ``DCT_DEVICE`` override: both stages on one card,
       a thread each), 1f1b with M 2 and M 4 (f32: 3 epochs) and gpipe
       with M 4, f32 and bf16, from train_job's init: every step's loss
       and val_loss within 1e-5 (f32, against whole batches) and 5e-3
       (bf16, against the same microbatches; the whole-batch differences
       printed beside), each stage's launches
       exactly ``2 (L/P) M`` forwards and ``(L/P) M`` dK/dV and dQ a train
       step and ``(L/P) M`` forwards an eval batch, read from its
       per-stage tally of that run; step ms, samples/s, peak memory, each
       stage's busy, transfer-wait, fill, steady and drain seconds, and
       ``analytic_bubble`` and ``measured_bubble`` from M 2 and M 4. The
       supervised worker (``resilience.supervise --world-size 2 --
       mpmd_worker``, ``1,1`` on one card, 1f1b M 4), f32 (3 epochs) with
       a SIGTERM to both stages in the second epoch (each finishes it,
       saves, exits 75 and reports ``mpmd.stage_done preempted=true``; one
       free relaunch resumes every stage) and bf16 (1 epoch): the
       manifest and both stage files, one ``mpmd.step_report`` an epoch,
       each process's launches an attempt's, its last val_loss within
       1e-5 (f32; bf16 5e-3) of the in-process run and within (q)'s
       tolerance of train_job's. The pivots, bitwise on every leaf: the
       worker's stage files adopted here (each merged leaf its stage's)
       and by ``train_job``'s resume (its ``mpmd.pivot`` digest against
       this process's merge), and train_job's ``train_state`` split by a
       resumed worker world (each stage's ``mpmd.pivot`` digest against
       this process's split). In the whole script it runs at the end of
       the (f) chain, after (o0);
   (q1) on four cards, one epoch each, f32 and bf16: ``1,1,1,1`` (one
       layer a stage) with 1f1b and gpipe and ``1,1`` on two cards (M 4),
       each stage on its own card, against one card's train_job from the
       same init (``n_stages`` 4 or 2), held as (q0)'s in-process runs.
   Then ``[smoke] (q) summary`` and ``phase_q.json``; on fewer than four
   cards one line, ``{"phase": "q", "ran": false, "cards": 1}``.

After (g), four chains share the card: (h1) then (k) in this thread,
(l) then (p0) beside them (the two hold one lock around every part that
reads this process's launch counts; (p0) waits for (i)'s drills to end),
(i) then (j1), and (f), (h0), (h2), (o0) then (q0); (l) runs over its own LOOP_ROWS rows (those of (h1)'s first
cycle). (i2), (j2)/(j3), (m), (n), (o)'s, (p)'s and (q1)'s worlds follow
once all four have ended. Each phase prints its wall on a ``[smoke] wall`` line, and
all of them, with the total, on ``[smoke] walls``.

Prints the ``kernels`` JSON line (each kernel with its f32 numbers at the
top level, as earlier slices did, a ``bf16`` summary beside them, its
``tensor_core_instructions`` by dtype and (n0)'s ``sp_variants``;
``launches_by_path`` gains ``serve_k``, ``predict``, ``knobs``,
``families``, ``model_axis``, ``sequence_parallel``, (o)'s
``predict_mesh``, ``fsdp_layers`` and ``remap``, (p)'s ``pipeline``
and (q)'s ``mpmd``),
then the card line,
then, last, ``{"ok": true, "device": {...}}``. Any failure raises.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
# Datasheet peaks of the H100 SXM (dense): bf16 and TF32 on the tensor
# cores, HBM3 bandwidth. f32 accuracy on the tensor cores takes three TF32
# products per product (3xTF32), so an f32 bound counts 3 x its operations
# at the TF32 rate (165 TFLOP/s in effect, against 67 on the FMA units).
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
FWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}  # on o; lse 1e-4
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}  # of max|plain|
SERVE_CFG = dict(seq_len=1024, d_model=512, n_heads=8, n_layers=4, d_ff=2048)
REQUEST_SIZES = (1, 3, 8, 32)
DEVICE = "cuda"
BATCH = 32  # windows per train step (bench.py's scaled batch)
TRAIN_STEPS = 8
OVERFIT_LRS = (1e-3, 1e-4, 3e-5, 1e-5)
OVERFIT_LR = 3e-5
OVERFIT_RATIO = 0.7  # measured 0.470 on an H100
BWD_FLOPS_PER_PAIR = {"flash_bwd_dkdv": 8, "flash_bwd_dq": 6}  # x D


# The tensor-core kernels by (kernel, dtype): (library, name in the SASS).
# Each must hold HGMMA at every head dim.
TENSOR_CORE_SASS = {
    ("flash_fwd", "bf16"): ("flash_fwd", "flash_fwd_kernel_wgmma"),
    ("flash_fwd", "f32"): ("flash_fwd", "flash_fwd_kernel_tf32"),
    ("flash_bwd_dkdv", "bf16"): ("flash_bwd", "flash_bwd_dkdv_kernel_wgmma"),
    ("flash_bwd_dkdv", "f32"): ("flash_bwd", "flash_bwd_dkdv_kernel_tf32"),
    ("flash_bwd_dq", "bf16"): ("flash_bwd", "flash_bwd_dq_kernel_wgmma"),
    ("flash_bwd_dq", "f32"): ("flash_bwd", "flash_bwd_dq_kernel_tf32"),
}


def ptxas_report(log: str) -> dict[str, dict]:
    """Registers, spill bytes and any performance warning (such as wgmma
    serialization) per kernel instance from nvcc's ``-Xptxas -v``
    output."""
    report, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)", line)
        if m:
            fn = m.group(1)
            report.setdefault(fn, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            report[fn]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            report[fn]["registers"] = int(m.group(1))
        m = re.search(r"Potential Performance Loss: (.*) in the function "
                      r"'([\w$]+)'", line)
        if m:
            report.setdefault(m.group(2), {})["ptxas_warning"] = m.group(1)
    return report


def tensor_core_instructions(build) -> dict[str, dict]:
    """Per kernel and dtype: HGMMA and HMMA counts of each tensor-core
    instance (by head dim) in ``cuobjdump -sass`` of the built library.
    Where a kernel has a second instance per head dim for the seq axis's
    variants (template flag ``VARIANT``, mangled ``Lb1E``), that one must
    hold HGMMA too, and the counts reported are the other one's."""
    sass = {lib: build.sass(lib) for lib in ("flash_fwd", "flash_bwd")}
    counts = {}
    for (name, dtype), (lib, tag) in TENSOR_CORE_SASS.items():
        found, cur = {}, None
        for line in sass[lib].splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                cur = None
                if tag in m.group(1):
                    i = re.search(r"Li(\d+)E(Lb1E)?", m.group(1))
                    cur = (int(i.group(1)), bool(i.group(2)))
                    found[cur] = {"HGMMA": 0, "HMMA": 0}
            elif cur is not None:
                for op in ("HGMMA", "HMMA"):
                    if re.search(rf"\b{op}\.", line):
                        found[cur][op] += 1
        by_dim = {d: c for (d, var), c in found.items() if not var}
        if sorted(by_dim) != [16, 32, 64, 128]:
            raise AssertionError(f"{name} {dtype}: instances "
                                 f"{sorted(found)} in the SASS, want head "
                                 "dims 16-128")
        if not all(c["HGMMA"] > 0 for c in found.values()):
            raise AssertionError(f"{name} {dtype}: an instance without "
                                 f"HGMMA: {found}")
        counts.setdefault(name, {})[dtype] = {
            "kernel": tag, "HGMMA": by_dim[64]["HGMMA"],
            "HMMA": by_dim[64]["HMMA"], "head_dim": 64, "by_head_dim": by_dim}
    return counts


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, runs: int = 5, per_run: int = 10, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: the median over ``runs`` of the
    CUDA-event time of ``per_run`` calls launched back to back, over
    ``per_run``. Back to back, the device runs one call while the host
    prepares the next, so the host's part of a call (the wrapper's checks,
    allocations and ctypes call) is not counted, as it is when two events
    bracket a single call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_run):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per_run)
    return statistics.median(times)


def _pairs(t, causal, window):
    """Unmasked (q, k) pairs of one head."""
    if not causal:
        return t * t
    return int(np.minimum(np.arange(t) + 1, window or t).sum())


def _bound(flops, nbytes, dtype):
    """(ms, 'bytes' | 'operations', basis): the basis names the peak, as
    'operations (3xTF32)' for f32 and 'operations (bf16)', or 'bytes'."""
    if dtype == torch.float32:
        t_ops, peak = 3 * flops / PEAK_TF32, "3xTF32"
    else:
        t_ops, peak = flops / PEAK_BF16, "bf16"
    t_bytes = nbytes / PEAK_BYTES
    by = "operations" if t_ops >= t_bytes else "bytes"
    return (max(t_ops, t_bytes) * 1e3, by,
            f"operations ({peak})" if by == "operations" else "bytes")


def attention_bound(b, h, g, t, d, dtype, causal, window, lse):
    """Least time for the work: ``_bound``'s (ms, by, basis)."""
    flops = 4.0 * b * h * d * _pairs(t, causal, window)
    itemsize = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * h * t + 2 * b * g * t) * d * itemsize
    if lse:
        nbytes += b * h * t * 4
    return _bound(flops, nbytes, dtype)


def bwd_bound(kernel, b, h, g, t, d, dtype, causal, window):
    """Least time of a backward kernel: it reads q, o, dO, k, v and the f32
    lse once and writes dk and dv (kernel 2) or dq (kernel 3) once."""
    flops = BWD_FLOPS_PER_PAIR[kernel] * d * b * h * _pairs(t, causal, window)
    itemsize = torch.tensor([], dtype=dtype).element_size()
    out = 2 * b * g * t if kernel == "flash_bwd_dkdv" else b * h * t
    nbytes = (3 * b * h * t + 2 * b * g * t + out) * d * itemsize + b * h * t * 4
    return _bound(flops, nbytes, dtype)


def check_flash_kernel(fa) -> list[dict]:
    """flash_fwd against its plain version at the serving shape."""
    b, h, g, t, d = 32, 8, 8, 1024, 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    variants = []
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(b, h, t, d, generator=gen, device="cuda").to(dtype)
        k = torch.randn(b, g, t, d, generator=gen, device="cuda").to(dtype)
        v = torch.randn(b, g, t, d, generator=gen, device="cuda").to(dtype)
        for causal in (False, True):
            o, lse = fa.flash_attention(q, k, v, causal=causal,
                                        return_lse=True)
            torch.cuda.synchronize()
            po, plse = fa.flash_attention_plain(q, k, v, causal=causal)
            err = (o.float() - po.float()).abs().max().item()
            lse_err = (lse - plse).abs().max().item()
            if not (err <= FWD_TOL[dtype] and lse_err <= 1e-4):
                raise AssertionError(
                    f"flash_fwd {dtype} causal={causal}: max |o - plain| "
                    f"{err} (tol {FWD_TOL[dtype]}), max |lse - plain| "
                    f"{lse_err} (tol 1e-4)"
                )
            bound_ms, bound_by, basis = attention_bound(
                b, h, g, t, d, dtype, causal, None, lse=True)
            variants.append({
                "dtype": str(dtype).replace("torch.", ""), "causal": causal,
                "shape": [b, h, t, d], "max_abs_err": err,
                "lse_max_abs_err": lse_err, "tol": FWD_TOL[dtype],
                "ms": time_ms(lambda: fa.flash_attention(
                    q, k, v, causal=causal, return_lse=True)),
                "plain_ms": time_ms(lambda: fa.flash_attention_plain(
                    q, k, v, causal=causal)),
                "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal)),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_basis": basis,
            })
            print(f"[smoke] flash_fwd {variants[-1]}", flush=True)
    return variants


def post(port: int, windows: np.ndarray) -> tuple[np.ndarray, float]:
    body = json.dumps({"data": windows.tolist()}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/score", data=body)
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        payload = json.loads(r.read())
    return np.asarray(payload["probabilities"]), (time.perf_counter() - t0) * 1e3


def serve_package(family: str, pkg_dir: str, fa, quant=None) -> dict:
    """Drive one package (f32, or its ``quant="bf16"`` twin) through the
    port's HTTP server on the card."""
    from dct_tpu_torch.config import ServingConfig
    from dct_tpu_torch.serving.batching import TorchScorer
    from dct_tpu_torch.serving.package import (
        init_package_weights,
        load_package,
        write_package,
    )
    from dct_tpu_torch.serving.quant import quantize_weights
    from dct_tpu_torch.serving.server import make_server

    meta = dict(model=family, name=family, input_dim=5, num_classes=2,
                horizon=1, **SERVE_CFG)
    weights = init_package_weights(meta, seed=0)
    if quant is not None:
        weights, meta = quantize_weights(weights, meta, dtype=quant)
    write_package(pkg_dir, weights, meta)
    server = make_server(pkg_dir, serving=ServingConfig(workers=2))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    rng = np.random.default_rng(1)
    answers, latencies = {}, {}
    try:
        port = server.server_address[1]
        fa.reset_launches()
        forwards0 = server.scorer.forwards
        for n in REQUEST_SIZES:
            x = rng.standard_normal((n, SERVE_CFG["seq_len"], 5)).astype(
                np.float32
            )
            probs, ms = post(port, x)
            answers[n] = (x, probs)
            latencies[n] = ms
        launches = fa.launches
        forwards = server.scorer.forwards - forwards0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)
    dtype = torch.bfloat16 if quant == "bf16" else torch.float32
    if server.scorer.dtype != dtype:
        raise AssertionError(f"{family} {quant}: served at "
                             f"{server.scorer.dtype}, not {dtype}")
    if launches != SERVE_CFG["n_layers"] * forwards or forwards < 1:
        raise AssertionError(
            f"{family}: {launches} flash launches for {forwards} forwards of "
            f"{SERVE_CFG['n_layers']} layers"
        )
    for n, (x, probs) in answers.items():
        if probs.shape != (n, 2) or not np.isfinite(probs).all():
            raise AssertionError(f"{family}: bad answer {probs.shape} for {n}")
        if np.abs(probs.sum(axis=-1) - 1).max() > 1e-5:
            raise AssertionError(f"{family}: probabilities do not sum to 1")
    # Two windows against the port's f32 CPU path (plain attention) on the
    # package's own (for bf16: widened) weights.
    weights, meta = load_package(pkg_dir)
    meta.pop("quant", None)
    cpu = TorchScorer(weights, meta, "cpu")
    x, probs = answers[32]
    pick = [0, 31]
    ref = cpu(x[pick])
    err = float(np.abs(ref - probs[pick]).max())
    if err > TOL[dtype]:
        raise AssertionError(
            f"{family} {quant}: cuda vs cpu probabilities differ {err} "
            f"(tol {TOL[dtype]})"
        )
    result = {"family": family, "dtype": str(dtype).replace("torch.", ""),
              "forwards": forwards, "launches": launches,
              "cuda_vs_cpu_max_abs_err": err,
              "latency_ms": {str(n): latencies[n] for n in REQUEST_SIZES}}
    print(f"[smoke] serve {result}", flush=True)
    return result


def abs_rel_err(got, ref) -> tuple[float, float]:
    """(max|got - ref|, that over max|ref|)."""
    ref = ref.float()
    err = (got.float() - ref).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-30)


def check_bwd_kernels(fa) -> dict[str, list[dict]]:
    """flash_bwd_dkdv and flash_bwd_dq against flash_attention_bwd_plain at
    the training shape."""
    b, h, g, t, d = BATCH, 8, 8, 1024, 64
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {"flash_bwd_dkdv": [], "flash_bwd_dq": []}
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(b, h, t, d, generator=gen, device="cuda").to(dtype)
        k = torch.randn(b, g, t, d, generator=gen, device="cuda").to(dtype)
        v = torch.randn(b, g, t, d, generator=gen, device="cuda").to(dtype)
        do = torch.randn(b, h, t, d, generator=gen, device="cuda").to(dtype)
        for causal in (False, True):
            o, lse = fa.flash_attention(q, k, v, causal=causal,
                                        return_lse=True)
            args = (q, k, v, o, lse, do)
            dk, dv = fa.flash_bwd_dkdv(*args, causal=causal)
            dq = fa.flash_bwd_dq(*args, causal=causal)
            torch.cuda.synchronize()
            pdq, pdk, pdv = fa.flash_attention_bwd_plain(*args, causal=causal)
            both = {"dq": abs_rel_err(dq, pdq), "dk": abs_rel_err(dk, pdk),
                    "dv": abs_rel_err(dv, pdv)}
            errs = {n: rel for n, (_, rel) in both.items()}
            abs_errs = {n: err for n, (err, _) in both.items()}
            bad = {n: e for n, e in errs.items() if not e <= BWD_TOL[dtype]}
            if bad:
                raise AssertionError(
                    f"flash backward {dtype} causal={causal}: relative "
                    f"errors {bad} above {BWD_TOL[dtype]}"
                )
            plain_ms = time_ms(lambda: fa.flash_attention_bwd_plain(
                *args, causal=causal), runs=3, per_run=2, warmup=1)
            qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
            o_sdpa = F.scaled_dot_product_attention(qg, kg, vg,
                                                    is_causal=causal)
            library_ms = time_ms(lambda: torch.autograd.grad(
                o_sdpa, (qg, kg, vg), do, retain_graph=True))
            del o_sdpa
            timed = {
                "flash_bwd_dkdv": (time_ms(lambda: fa.flash_bwd_dkdv(
                    *args, causal=causal)), ("dk", "dv")),
                "flash_bwd_dq": (time_ms(lambda: fa.flash_bwd_dq(
                    *args, causal=causal)), ("dq",)),
            }
            kernels_ms = sum(ms for ms, _ in timed.values())
            for name, (ms, outs) in timed.items():
                bound_ms, bound_by, basis = bwd_bound(name, b, h, g, t, d,
                                                      dtype, causal, None)
                out[name].append({
                    "dtype": str(dtype).replace("torch.", ""),
                    "causal": causal, "shape": [b, h, t, d],
                    "max_abs_err": max(abs_errs[n] for n in outs),
                    "max_rel_err": max(errs[n] for n in outs),
                    "errors": errs, "abs_errors": abs_errs,
                    "tol": BWD_TOL[dtype],
                    "ms": ms, "plain_ms": plain_ms,
                    "library_ms": library_ms,
                    "library_covers": "dq+dk+dv",
                    "kernels_sum_ms": kernels_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "bound_basis": basis,
                })
                print(f"[smoke] {name} {out[name][-1]}", flush=True)
    return out


class PlainAttention(torch.autograd.Function):
    """The flash path's plain versions, forward and backward, as an
    attention function for (a): the yardstick the kernels are held to."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        from dct_tpu_torch.ops import flash_attention as fa

        o, lse = fa.flash_attention_plain(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        from dct_tpu_torch.ops import flash_attention as fa

        q, k, v, o, lse = ctx.saved_tensors
        grads = fa.flash_attention_bwd_plain(q, k, v, o, lse, do.contiguous(),
                                             causal=ctx.causal)
        return (*grads, None)


def ar1_rows():
    """Seeded AR(1) rows, 5 features, labelled by the sign of the first:
    132 train batches of windows, a gap of seq_len, then one batch of val
    windows."""
    from dct_tpu_torch.data.dataset import WeatherArrays

    seq = SERVE_CFG["seq_len"]
    n_windows = int((seq + BATCH) / 0.2)
    rng = np.random.default_rng(0)
    rows = np.zeros((n_windows + seq, 5), np.float32)
    noise = rng.standard_normal(rows.shape).astype(np.float32)
    for i in range(1, len(rows)):
        rows[i] = 0.9 * rows[i - 1] + 0.44 * noise[i]
    labels = (rows[:, 0] > 0).astype(np.int32)
    return WeatherArrays(rows, labels, [f"f{i}" for i in range(5)])


def train_data(family: str):
    """Seeded AR(1) rows (5 features; the label is the sign of the next
    row's first feature, which the window's last rows predict) through the
    port's windows, split and loader: ``TRAIN_STEPS`` train batches and
    the validation batches, as ``[S, B, ...]`` stacks."""
    from dct_tpu_torch.data.pipeline import BatchLoader, contiguous_split
    from dct_tpu_torch.data.windows import make_windows
    from dct_tpu_torch.models.registry import is_causal_model

    seq = SERVE_CFG["seq_len"]
    causal = is_causal_model(family)
    data = make_windows(ar1_rows(), seq, per_position_labels=causal)
    train_idx, val_idx = contiguous_split(len(data), val_fraction=0.2,
                                          gap=seq)
    train = BatchLoader(data, train_idx, global_batch=BATCH, shuffle=True,
                        seed=0).epoch_stacked(0)
    val = BatchLoader(data, val_idx, global_batch=BATCH,
                      shuffle=False).epoch_stacked(0)
    return [a[:TRAIN_STEPS] for a in train], val


def train_state(family, compute_dtype, *, dropout=0.2, remat=False,
                lr=1e-3):
    from dct_tpu_torch.config import ModelConfig
    from dct_tpu_torch.models.registry import get_model
    from dct_tpu_torch.train.state import create_train_state

    cfg = ModelConfig(name=family, dropout=dropout, remat=remat, horizon=1,
                      **SERVE_CFG)
    model = get_model(cfg, input_dim=5, device=DEVICE,
                      compute_dtype=compute_dtype)
    return create_train_state(model, input_dim=5, lr=lr, seed=0,
                              example_shape=(1, SERVE_CFG["seq_len"], 5))


def grads_close(ga, gb, tol) -> float:
    """Largest gradient error relative to that gradient's max."""
    worst = 0.0
    for a, b in zip(ga, gb):
        scale = b.float().abs().max().item()
        err = (a.float() - b.float()).abs().max().item() / max(scale, 1e-30)
        worst = max(worst, err)
    if not worst <= tol:
        raise AssertionError(f"gradients differ by {worst} (tol {tol})")
    return worst


def _kernel_kind(name: str) -> str:
    low = name.lower()
    for kind in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
        if kind + "_kernel" in low:
            return kind
    # cuBLAS names its Hopper GEMMs nvjet_*, its older ones *gemm*.
    if any(tag in low for tag in ("gemm", "cutlass", "xmma", "nvjet")):
        return "gemm"
    if "multi_tensor_apply" in low:
        return "optimizer_foreach"
    if "nccl" in low:
        return "collective"
    if "memcpy" in low or "memset" in low:
        return "memcpy_memset"
    return "other"


def trace_step(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: device ms per kernel
    kind, the share of each in the device's busy time, the busiest kernels,
    the distinct kernel names of each kind, and the idle share between the
    first kernel's start and the last one's end. ``{"device_events": 0}``
    when the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events() if e.device_type == DeviceType.CUDA
    )
    if not spans:
        return {"device_events": 0}
    kinds, names, by_kind = {}, {}, {}
    busy, cur_start, cur_end = 0.0, spans[0][0], spans[0][1]
    for start, end, name in spans:
        kind = _kernel_kind(name)
        kinds[kind] = kinds.get(kind, 0.0) + (end - start) / 1e3
        names[name] = names.get(name, 0.0) + (end - start) / 1e3
        by_kind.setdefault(kind, set()).add(name[:90])
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy = (busy + cur_end - cur_start) / 1e3
    span = (max(e for _, e, _ in spans) - spans[0][0]) / 1e3
    top = sorted(names.items(), key=lambda kv: -kv[1])[:10]
    return {"device_events": len(spans), "span_ms": span, "busy_ms": busy,
            "idle_share": 1 - busy / span if span > 0 else 0.0,
            "ms_by_kind": kinds,
            "share_by_kind": {k: v / busy for k, v in kinds.items()},
            "top_kernels_ms": [[n[:90], ms] for n, ms in top],
            "kernel_names_by_kind": {k: sorted(v)
                                     for k, v in by_kind.items()}}


def train_phase(fa) -> dict:
    """(a)-(e) of the module docstring; returns what the kernels line and
    the log need."""
    from dct_tpu_torch.train import steps

    n_layers = SERVE_CFG["n_layers"]
    data = {f: train_data(f) for f in ("weather_transformer",
                                       "weather_transformer_causal")}
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    results = {"a": [], "b": []}

    # (a) kernels against plain attention, one train body, dropout 0.
    for family, dname in (("weather_transformer", "f32"),
                          ("weather_transformer", "bf16"),
                          ("weather_transformer_causal", "f32")):
        (xs, ys, ws), _ = data[family]
        kern = train_state(family, dtypes[dname], dropout=0.0)
        plain = train_state(family, dtypes[dname], dropout=0.0)
        causal = family == "weather_transformer_causal"
        for block in plain.model.blocks():
            block.attn.attn_fn = (
                lambda q, k, v, c=causal: PlainAttention.apply(q, k, v, c))
        fa.reset_launches()
        loss_k, grads_k = steps.loss_and_grads(kern, xs[0], ys[0], ws[0])
        torch.cuda.synchronize()
        counts = fa.launch_counts()
        want = {"flash_fwd": n_layers, "flash_bwd_dkdv": n_layers,
                "flash_bwd_dq": n_layers}
        if counts != want:
            raise AssertionError(f"(a) {family} {dname}: launches {counts}, "
                                 f"want {want}")
        loss_p, grads_p = steps.loss_and_grads(plain, xs[0], ys[0], ws[0])
        if fa.launch_counts() != counts:
            raise AssertionError("(a) the plain path launched a kernel")
        tol = TOL[dtypes[dname]]
        loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
        if not loss_err <= tol:
            raise AssertionError(f"(a) {family} {dname}: loss {loss_k.item()}"
                                 f" vs plain {loss_p.item()}")
        res = {"family": family, "compute": dname, "loss": loss_k.item(),
               "loss_rel_err": loss_err,
               "grad_rel_err": grads_close(grads_k, grads_p, tol), "tol": tol}
        results["a"].append(res)
        print(f"[smoke] train (a) kernels vs plain {res}", flush=True)
        del kern, plain, grads_k, grads_p

    # (b) the default configuration, per family and compute dtype.
    for family, dname in (("weather_transformer", "bf16"),
                          ("weather_transformer", "f32"),
                          ("weather_transformer_causal", "f32"),
                          ("weather_transformer_causal", "bf16")):
        (xs, ys, ws), (vxs, vys, vws) = data[family]
        state = train_state(family, dtypes[dname])
        dev = [torch.as_tensor(a, device=DEVICE)
               for a in (xs, ys, ws, vxs, vys, vws)]
        epoch = steps.make_epoch_train_eval_step(with_grad_norms=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        t0 = time.perf_counter()
        state, losses, sums, gnorms = epoch(state, *dev)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        counts = fa.launch_counts()
        n_train, n_val = len(xs), len(vxs)
        want = {"flash_fwd": n_layers * (n_train + n_val),
                "flash_bwd_dkdv": n_layers * n_train,
                "flash_bwd_dq": n_layers * n_train}
        if counts != want:
            raise AssertionError(f"(b) {family} {dname}: launches {counts}, "
                                 f"want {want}")
        values = torch.cat([losses, gnorms, torch.stack(sums)])
        if not bool(torch.isfinite(values).all()):
            raise AssertionError(f"(b) {family} {dname}: non-finite "
                                 f"{values.tolist()}")
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        step = steps.make_train_step()
        step(state, dev[0][0], dev[1][0], dev[2][0])  # warm-up
        times = []
        for i in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            i %= n_train
            step(state, dev[0][i], dev[1][i], dev[2][i])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        step_ms = statistics.median(times)
        trace = trace_step(lambda: step(state, dev[0][0], dev[1][0],
                                        dev[2][0]))
        res = {"family": family, "compute": dname, "steps": n_train,
               "val_batches": n_val, "launches": counts,
               "losses": losses.tolist(), "grad_norms": gnorms.tolist(),
               "val_loss": (sums[0] / sums[2]).item(),
               "val_acc": (sums[1] / sums[2]).item(),
               "epoch_s": epoch_s, "step_ms": step_ms,
               "step_ms_runs": times,
               "samples_per_s": BATCH / step_ms * 1e3,
               "tokens_per_s": BATCH * SERVE_CFG["seq_len"] / step_ms * 1e3,
               "peak_mem_gib": peak_gib}
        results["b"].append(res)
        print(f"[smoke] train (b) {res}", flush=True)
        print(f"[smoke] train (e) trace {family} {dname} {trace}", flush=True)
        del state, dev

    # (c) overfit one fixed batch, for each family and lr of the sweep.
    results["c"] = []
    for family in ("weather_transformer", "weather_transformer_causal"):
        (xs, ys, ws), _ = data[family]
        for lr in OVERFIT_LRS:
            state = train_state(family, torch.bfloat16, dropout=0.0, lr=lr)
            step = steps.make_train_step()
            losses = []
            for _ in range(TRAIN_STEPS):
                state, metrics = step(state, xs[0], ys[0], ws[0])
                losses.append(metrics["train_loss"].item())
            res = {"family": family, "compute": "bf16", "lr": lr,
                   "losses": losses, "last_over_first": losses[-1] / losses[0]}
            results["c"].append(res)
            print(f"[smoke] train (c) overfit {res}", flush=True)
            del state
    checked = [r for r in results["c"]
               if r["family"] == "weather_transformer_causal"
               and r["lr"] == OVERFIT_LR][0]
    if not checked["last_over_first"] < OVERFIT_RATIO:
        raise AssertionError(f"(c) one batch did not overfit: {checked}")
    print(f"[smoke] train (c) check: weather_transformer_causal at lr "
          f"{OVERFIT_LR}: {checked['last_over_first']} < {OVERFIT_RATIO}",
          flush=True)

    # (d) remat: the recompute runs the forward kernel again and draws the
    # same dropout masks.
    (xs, ys, ws), _ = data["weather_transformer"]
    plain_state = train_state("weather_transformer", torch.float32)
    remat_state = train_state("weather_transformer", torch.float32,
                              remat=True)
    _, grads = steps.loss_and_grads(plain_state, xs[0], ys[0], ws[0])
    fa.reset_launches()
    _, grads_r = steps.loss_and_grads(remat_state, xs[0], ys[0], ws[0])
    torch.cuda.synchronize()
    counts = fa.launch_counts()
    want = {"flash_fwd": 2 * n_layers, "flash_bwd_dkdv": n_layers,
            "flash_bwd_dq": n_layers}
    if counts != want:
        raise AssertionError(f"(d) remat launches {counts}, want {want}")
    results["d"] = {"launches": counts,
                    "grad_rel_err": grads_close(grads_r, grads,
                                                TOL[torch.float32])}
    print(f"[smoke] train (d) remat {results['d']}", flush=True)
    return results


def c2_row(fa, gen, dtype, shape) -> dict:
    """(c2): forward, dK/dV and dQ at B*H past gridDim.y's 65535 against
    the plain version, and their times at that shape."""
    b, h, t, d = shape
    q, k, v, do = (torch.randn(b, h, t, d, generator=gen, device="cuda",
                               dtype=dtype) for _ in range(4))
    o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    dk, dv = fa.flash_bwd_dkdv(q, k, v, o, lse, do, causal=True)
    dq = fa.flash_bwd_dq(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    po, plse = fa.flash_attention_plain(q, k, v, causal=True)
    row = {"shape": [b, h, t, d], "rows": b * h,
           "dtype": str(dtype).replace("torch.", ""),
           "o_err": (o.float() - po.float()).abs().max().item(),
           "lse_err": (lse - plse).abs().max().item()}
    del po, plse
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True)
    row["grad_rel_errs"] = {n: abs_rel_err(got, ref)[1] for n, got, ref in
                            zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
    del want
    row["ms"] = {
        "flash_fwd": time_ms(lambda: fa.flash_attention(q, k, v, causal=True,
                                                        return_lse=True),
                             runs=3, per_run=3),
        "flash_bwd_dkdv": time_ms(lambda: fa.flash_bwd_dkdv(
            q, k, v, o, lse, do, causal=True), runs=3, per_run=3),
        "flash_bwd_dq": time_ms(lambda: fa.flash_bwd_dq(
            q, k, v, o, lse, do, causal=True), runs=3, per_run=3),
    }
    if not (row["o_err"] <= FWD_TOL[dtype] and row["lse_err"] <= 1e-4
            and max(row["grad_rel_errs"].values()) <= BWD_TOL[dtype]):
        raise AssertionError(f"(c2) B*H = {b * h}: {row}")
    print(f"[smoke] (c2) {row}", flush=True)
    del q, k, v, do, o, lse, dk, dv, dq
    torch.cuda.empty_cache()
    return row


def check_repairs(fa) -> dict:
    """(c1/c2): padded head dims and the grid past 65535 rows."""
    out = {"c1": [], "c2": {}}
    gen = torch.Generator(device="cuda").manual_seed(4)
    b, h, g, t = 2, 4, 2, 256
    for d in (8, 48):
        for dtype in (torch.float32, torch.bfloat16):
            causal = d == 48
            q = torch.randn(b, h, t, d, generator=gen, device="cuda").to(dtype)
            k, v = (torch.randn(b, g, t, d, generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            do = torch.randn(b, h, t, d, generator=gen, device="cuda").to(dtype)
            o, lse = fa.flash_attention(q, k, v, causal=causal,
                                        return_lse=True)
            po, plse = fa.flash_attention_plain(q, k, v, causal=causal)
            o_err = (o.float() - po.float()).abs().max().item()
            lse_err = (lse - plse).abs().max().item()
            args = (q, k, v, o, lse, do)
            dk, dv = fa.flash_bwd_dkdv(*args, causal=causal)
            dq = fa.flash_bwd_dq(*args, causal=causal)
            want = fa.flash_attention_bwd_plain(*args, causal=causal)
            errs = {n: abs_rel_err(got, ref)[1]
                    for n, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                           want)}
            row = {"d": d, "dtype": str(dtype).replace("torch.", ""),
                   "causal": causal, "o_err": o_err, "lse_err": lse_err,
                   "grad_rel_errs": errs}
            if not (o_err <= FWD_TOL[dtype] and lse_err <= 1e-4
                    and max(errs.values()) <= BWD_TOL[dtype]
                    and dq.shape == q.shape and dk.shape == k.shape):
                raise AssertionError(f"(c1) padded head dim: {row}")
            out["c1"].append(row)
            print(f"[smoke] (c1) {row}", flush=True)
    b, h, t, d = 8192, 8, 128, 16
    for dtype in (torch.bfloat16, torch.float32):
        out["c2"][str(dtype).replace("torch.", "")] = c2_row(fa, gen, dtype,
                                                            (b, h, t, d))
    return out


def etl_rows(path: str):
    """The ETL's transform of a weather CSV in numpy: each feature
    z-scored with its sample std, ``Rain == "rain"`` -> 1."""
    from dct_tpu_torch.data.dataset import WeatherArrays
    from dct_tpu_torch.data.synthetic import FEATURE_COLUMNS

    raw = np.genfromtxt(path, delimiter=",", skip_header=1, dtype=str)
    x = raw[:, :5].astype(np.float64)
    x = ((x - x.mean(0)) / x.std(0, ddof=1)).astype(np.float32)
    y = (raw[:, 5] == "rain").astype(np.int32)
    return WeatherArrays(x, y, [f"{c}_norm" for c in FEATURE_COLUMNS])


def fit_mlp_phase(root: str, devices=("cuda:0", "cpu")) -> dict:
    """(f): the val-parity protocol through Trainer.fit on the card and on
    the CPU, then the score package against the card's forward."""
    import importlib.util

    from dct_tpu_torch.checkpoint.manager import flatten_tree, load_checkpoint
    from dct_tpu_torch.config import DataConfig, ModelConfig, RunConfig
    from dct_tpu_torch.config import TrainConfig
    from dct_tpu_torch.convert import load_flax_weights
    from dct_tpu_torch.data.synthetic import generate_weather_csv
    from dct_tpu_torch.models.registry import config_from_meta, get_model
    from dct_tpu_torch.serving.score_gen import generate_score_package
    from dct_tpu_torch.tracking.client import LocalTracking
    from dct_tpu_torch.train.trainer import Trainer

    data = etl_rows(generate_weather_csv(os.path.join(root, "weather.csv"),
                                         rows=4000, seed=0))
    results = []
    for i, device in enumerate(devices):
        tag = f"{device.split(':')[0]}{i}"
        cfg = RunConfig(
            data=DataConfig(models_dir=os.path.join(root, f"models-{tag}")),
            model=ModelConfig(name="weather_mlp", dropout=0.2),
            train=TrainConfig(epochs=10, batch_size=4, lr=0.01))
        res = Trainer(cfg, device=device, tracker=LocalTracking(
            root=os.path.join(root, "mlruns"))).fit(data)
        row = {"device": device, "val_loss": res.val_loss,
               "val_acc": res.val_acc,
               "val_losses": [h["val_loss"] for h in res.history],
               "epoch_s": res.epoch_seconds,
               "samples_per_s": res.samples_per_sec,
               "steady_samples_per_s": res.steady_samples_per_sec,
               "best": os.path.basename(res.best_model_path)}
        results.append((row, res))
        print(f"[smoke] (f) fit weather_mlp {row}", flush=True)
    (cuda_row, cuda_res), (cpu_row, _) = results
    gap = abs(cuda_row["val_loss"] - cpu_row["val_loss"])
    if not (cuda_row["val_acc"] > 0.8 and cpu_row["val_acc"] > 0.8
            and gap < 0.03):
        raise AssertionError(f"(f) val parity: cuda {cuda_row} cpu {cpu_row}")
    if not all(p.device == torch.device(devices[0])
               for p in cuda_res.state.params):
        raise AssertionError("(f) the card's fit left a parameter off the card")

    pkg = os.path.join(root, "package")
    meta = generate_score_package(cuda_res.best_model_path, pkg)
    params, _ = load_checkpoint(cuda_res.best_model_path)
    model = get_model(config_from_meta(meta), device=DEVICE)
    load_flax_weights(model, flatten_tree(params["params"]))
    x = np.random.default_rng(7).standard_normal((32, 5)).astype(np.float32)
    with torch.no_grad():
        want = torch.softmax(model(torch.from_numpy(x).to(DEVICE)),
                             -1).cpu().numpy()
    os.environ["AZUREML_MODEL_DIR"] = pkg
    spec = importlib.util.spec_from_file_location(
        "smoke_score", os.path.join(pkg, "score.py"))
    score = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(score)
    score.init()
    got = np.asarray(score.run(json.dumps({"data": x.tolist()}))[
        "probabilities"])
    err = float(np.abs(got - want).max())
    if not (got.shape == (32, 2) and err <= 1e-5):
        raise AssertionError(f"(f) package vs card forward: {err} (tol 1e-5)")
    out = {"cuda": cuda_row, "cpu": cpu_row, "val_loss_gap": gap,
           "package_vs_card_max_abs_err": err,
           "package": sorted(os.listdir(pkg))}
    print(f"[smoke] (f) check: val_acc {cuda_row['val_acc']:.4f} (cuda), "
          f"{cpu_row['val_acc']:.4f} (cpu) > 0.8; |val_loss gap| {gap} < "
          f"0.03; package vs card {err} <= 1e-5", flush=True)
    return out


def fit_transformer_phase(fa, root: str, step_ms_b: float) -> dict:
    """(g): one epoch of the full-width transformer through Trainer.fit,
    its kernel launches counted."""
    from dct_tpu_torch.checkpoint.manager import flatten_tree, load_checkpoint
    from dct_tpu_torch.config import DataConfig, ModelConfig, RunConfig
    from dct_tpu_torch.config import TrainConfig
    from dct_tpu_torch.convert import load_flax_weights
    from dct_tpu_torch.data.pipeline import BatchLoader, contiguous_split
    from dct_tpu_torch.data.windows import make_windows
    from dct_tpu_torch.models.registry import config_from_meta, get_model
    from dct_tpu_torch.tracking.client import LocalTracking
    from dct_tpu_torch.train import steps
    from dct_tpu_torch.train.state import TrainState
    from dct_tpu_torch.train.trainer import Trainer

    rows = ar1_rows()
    seq = SERVE_CFG["seq_len"]
    cfg = RunConfig(
        data=DataConfig(models_dir=os.path.join(root, "models-tf")),
        model=ModelConfig(name="weather_transformer", **SERVE_CFG),
        train=TrainConfig(epochs=1, batch_size=BATCH, lr=1e-3, seed=0))
    events = []
    body = steps._train_body

    def timed_body(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = body(*args)
        end.record()
        events.append((start, end))
        return out

    steps._train_body = timed_body
    try:
        torch.cuda.synchronize()
        fa.reset_launches()
        t0 = time.perf_counter()
        res = Trainer(cfg, device=DEVICE, tracker=LocalTracking(
            root=os.path.join(root, "mlruns"))).fit(rows)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = fa.launch_counts()
    finally:
        steps._train_body = body
    windows = make_windows(rows, seq)
    train_idx, val_idx = contiguous_split(len(windows), val_fraction=0.2,
                                          gap=seq)
    n_train = BatchLoader(windows, train_idx, global_batch=BATCH,
                          shuffle=True).num_batches
    n_val = BatchLoader(windows, val_idx, global_batch=BATCH,
                        shuffle=False).num_batches
    n_layers = SERVE_CFG["n_layers"]
    want = {"flash_fwd": n_layers * (n_train + n_val),
            "flash_bwd_dkdv": n_layers * n_train,
            "flash_bwd_dq": n_layers * n_train}
    if counts != want or len(events) != n_train:
        raise AssertionError(f"(g) launches {counts}, want {want}; "
                             f"{len(events)} train steps, want {n_train}")
    step_ms = [s.elapsed_time(e) for s, e in events]
    hist = res.history[-1]
    if not (np.isfinite(hist["val_loss"]) and np.isfinite(hist["train_loss"])):
        raise AssertionError(f"(g) non-finite losses {hist}")
    # last.ckpt into a fresh model: the same validation loss.
    params, meta = load_checkpoint(res.last_model_path)
    model = get_model(config_from_meta(meta), device=DEVICE,
                      compute_dtype=torch.bfloat16)
    load_flax_weights(model, flatten_tree(params["params"]))
    val = BatchLoader(windows, val_idx, global_batch=BATCH,
                      shuffle=False).epoch_stacked(0)
    fresh = TrainState(model=model, tx=res.state.tx, opt_state=None, step=0,
                       seed=0, rng=0)
    sums = steps.make_epoch_eval_step()(fresh, *val)
    reloaded = (sums[0] / sums[2]).item()
    if not abs(reloaded - hist["val_loss"]) <= 1e-6 * max(
            1.0, abs(hist["val_loss"])):
        raise AssertionError(f"(g) last.ckpt eval loss {reloaded} vs fit "
                             f"{hist['val_loss']}")
    out = {"family": "weather_transformer", "compute": "bf16",
           "train_steps": n_train, "val_batches": n_val, "launches": counts,
           "train_loss": hist["train_loss"], "val_loss": hist["val_loss"],
           "val_acc": hist["val_acc"], "reloaded_val_loss": reloaded,
           "fit_s": fit_s, "epoch_s": res.epoch_seconds[0],
           "epoch_ms_per_train_step": res.epoch_seconds[0] / n_train * 1e3,
           "step_ms_events_median": statistics.median(step_ms),
           "step_ms_events_min": min(step_ms),
           "b_step_ms_median": step_ms_b,
           "samples_per_s": res.samples_per_sec}
    print(f"[smoke] (g) fit weather_transformer {out}", flush=True)
    return out


# ----------------------------------------------------------------------
# (h) The continuous loop at full width.

ETL_ROWS, ETL_APPEND = 1_000_000, 100_000
# (g)'s 4224 train windows: (seq_len + BATCH) / 0.2 windows + seq_len rows.
LOOP_ROWS = int((SERVE_CFG["seq_len"] + BATCH) / 0.2) + SERVE_CFG["seq_len"]
LOOP_APPEND = 2000
ENDPOINT = "weather-smoke"
AGREE_TOL = 1e-4  # the deployed numpy endpoint vs the torch engine, f32


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def etl_phase(root: str, card: str) -> dict:
    """(h0): ``python -m dct_tpu_torch.preprocess_job`` over ETL_ROWS rows,
    then over ETL_APPEND appended rows; the processed dir read back through
    ``load_processed_dataset`` in a process without pyarrow in it."""
    import importlib.util

    from dct_tpu_torch.data.dataset import load_processed_dataset
    from dct_tpu_torch.data.synthetic import (
        append_weather_rows,
        generate_weather_csv,
    )
    from dct_tpu_torch.etl.parquet import part_files
    from dct_tpu_torch.etl.preprocess import read_etl_state

    raw, proc = os.path.join(root, "raw.csv"), os.path.join(root, "proc")
    t0 = time.perf_counter()
    generate_weather_csv(raw, rows=ETL_ROWS, seed=0)
    gen_s = time.perf_counter() - t0
    env = {k: v for k, v in os.environ.items() if not k.startswith("DCT_")}
    env.update(PYTHONPATH=HERE, DCT_RAW_CSV=raw, DCT_PROCESSED_DIR=proc,
               DCT_ETL_ENGINE="native")
    runs = []
    for rows in (ETL_ROWS, ETL_APPEND):
        if rows == ETL_APPEND:
            append_weather_rows(raw, rows=ETL_APPEND, seed=1)
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "dct_tpu_torch.preprocess_job"],
                       env=env, cwd=HERE, check=True, timeout=600,
                       capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        state = read_etl_state(proc)
        runs.append({"rows": rows, "s": seconds, "rows_per_s": rows / seconds,
                     "generation": state["generation"], "mode": state["mode"],
                     "parts": len(part_files(os.path.join(
                         proc, "data.parquet")))})
    full, delta = runs
    if not (full["generation"] == 1 and delta["generation"] == 2
            and delta["mode"] == "delta"
            and delta["parts"] == full["parts"] + 1
            and read_etl_state(proc)["rows"] == ETL_ROWS + ETL_APPEND):
        raise AssertionError(f"(h0) ETL generations/parts/rows: {runs}")
    t0 = time.perf_counter()
    data = load_processed_dataset(proc)
    load_s = time.perf_counter() - t0
    if not (len(data) == ETL_ROWS + ETL_APPEND
            and np.isfinite(data.features).all()
            and data.features.dtype == np.float32):
        raise AssertionError(f"(h0) loaded {len(data)} rows")
    if "pyarrow" in sys.modules:
        raise AssertionError("(h0) pyarrow was imported")
    # Whether the host has pyarrow at all (asked of another interpreter,
    # so this process never imports it).
    pyarrow_version = None
    if importlib.util.find_spec("pyarrow") is not None:
        pyarrow_version = subprocess.run(
            [sys.executable, "-c", "import pyarrow; print(pyarrow.__version__)"],
            capture_output=True, text=True, timeout=120).stdout.strip()
    out = {"csv_rows_generated_s": gen_s, "full": full, "delta": delta,
           "load_rows": len(data), "load_s": load_s,
           "host_pyarrow": pyarrow_version, "pyarrow_imported": False,
           "card": card}
    print(f"[smoke] (h0) etl {out}", flush=True)
    return out


def _loop_env(root: str) -> dict:
    """The ``DCT_*`` environment that (h1) and (h2) both run under: the
    full-width transformer, bf16 training, inline rounds of one epoch, no
    soak, the gate's torch engine."""
    env = dict(
        DCT_RAW_CSV=os.path.join(root, "raw", "weather.csv"),
        DCT_PROCESSED_DIR=os.path.join(root, "processed"),
        DCT_MODELS_DIR=os.path.join(root, "models"),
        DCT_TRACKING_DIR=os.path.join(root, "mlruns"),
        DCT_EVENTS_DIR=os.path.join(root, "events"),
        DCT_LOOP_PACKAGES_DIR=os.path.join(root, "packages"),
        DCT_LOOP_ENDPOINT=ENDPOINT, DCT_LOOP_TRAIN_MODE="inline",
        DCT_LOOP_EPOCHS_PER_ROUND="1", DCT_LOOP_SOAK_S="0",
        DCT_GATE_ENGINE="torch", DCT_MODEL="weather_transformer",
        DCT_SEQ_LEN=str(SERVE_CFG["seq_len"]),
        DCT_D_MODEL=str(SERVE_CFG["d_model"]),
        DCT_N_HEADS=str(SERVE_CFG["n_heads"]),
        DCT_N_LAYERS=str(SERVE_CFG["n_layers"]),
        DCT_D_FF=str(SERVE_CFG["d_ff"]), DCT_EPOCHS="1",
        DCT_BATCH_SIZE=str(BATCH), DCT_LR="1e-3", DCT_SEED="0",
        DCT_BF16_COMPUTE="1")
    if DEVICE == "cpu":
        env["DCT_DEVICE"] = "cpu"
    return env


def _set_dct_env(env: dict) -> None:
    """Make ``env`` this process's whole ``DCT_*`` environment; a no-op
    when it already is (other threads read the environment)."""
    now = {k: v for k, v in os.environ.items() if k.startswith("DCT_")}
    if now != env:
        for key in now:
            del os.environ[key]
        os.environ.update(env)


def _without_dct(environ) -> dict:
    return {k: v for k, v in environ.items() if not k.startswith("DCT_")}


def _expected_train_launches(cfg) -> dict:
    """4 forward launches per train step and per eval batch, 4 dK/dV and
    4 dQ per train step, over the processed dir's windows."""
    from dct_tpu_torch.data.dataset import load_processed_dataset
    from dct_tpu_torch.data.pipeline import BatchLoader, contiguous_split
    from dct_tpu_torch.data.windows import make_windows

    seq = SERVE_CFG["seq_len"]
    windows = make_windows(load_processed_dataset(cfg.data.processed_dir),
                           seq)
    train_idx, val_idx = contiguous_split(len(windows), val_fraction=0.2,
                                          gap=seq)
    n_train = BatchLoader(windows, train_idx, global_batch=BATCH,
                          shuffle=True).num_batches
    n_val = BatchLoader(windows, val_idx, global_batch=BATCH,
                        shuffle=False).num_batches
    n = SERVE_CFG["n_layers"]
    return {"flash_fwd": n * (n_train + n_val),
            "flash_bwd_dkdv": n * n_train, "flash_bwd_dq": n * n_train}


def episodic_phase(fa, root: str, card: str) -> dict:
    """(h1): two ``run_episodic_cycle`` calls at full width on the card,
    rows appended between them; the second cycle's train and gate launches
    counted, the gate's torch engine timed, the deployed endpoint held to
    the engine."""
    from dct_tpu_torch.config import EvaluationConfig, RunConfig
    from dct_tpu_torch.continuous.evaluator import PromotionEvaluator
    from dct_tpu_torch.continuous.loop import run_episodic_cycle
    from dct_tpu_torch.data.synthetic import (
        append_weather_rows,
        generate_weather_csv,
    )
    from dct_tpu_torch.deploy.local import LocalEndpointClient
    from dct_tpu_torch.etl.preprocess import read_etl_state
    from dct_tpu_torch.evaluation import harness

    _set_dct_env(_loop_env(root))
    cfg = RunConfig.from_env()
    generate_weather_csv(cfg.data.raw_csv, rows=LOOP_ROWS, seed=1)
    client = LocalEndpointClient(
        state_path=os.path.join(root, "endpoint_state.json"))
    evaluator = PromotionEvaluator(
        cfg.data.models_dir, cfg.loop.packages_dir, client=client,
        endpoint=ENDPOINT, processed_dir=cfg.data.processed_dir, soak_s=0.0,
        device=DEVICE)
    engine = {"windows": 0, "s": 0.0, "calls": 0}
    engine_fn = harness._batched_probs_torch
    scored = []  # the gate's engine calls, held to the plain version below

    def timed_engine(weights, meta, x, batch_size, device):
        _sync()
        t0 = time.perf_counter()
        probs = engine_fn(weights, meta, x, batch_size, device)
        _sync()
        engine["s"] += time.perf_counter() - t0
        engine["windows"] += len(x)
        engine["calls"] += 1
        scored.append((weights, meta, x, batch_size, device, probs))
        return probs

    counts = {}
    check_once = evaluator.check_once

    def counted_check_once():
        _sync()
        counts["train"] = fa.launch_counts()
        fa.reset_launches()  # just before the gate
        out = check_once()
        _sync()
        counts["gate"] = fa.launch_counts()  # just after it
        return out

    harness._batched_probs_torch = timed_engine
    evaluator.check_once = counted_check_once
    try:
        first = run_episodic_cycle(cfg, client=client, evaluator=evaluator,
                                   device=DEVICE)
        if not (first["promoted"] and client.get_traffic(ENDPOINT)
                == {"blue": 100} and counts["gate"]["flash_fwd"] == 0):
            raise AssertionError(f"(h1) cycle 1 did not deploy straight to "
                                 f"100%: {first} {client.ops}")
        append_weather_rows(cfg.data.raw_csv, rows=LOOP_APPEND, seed=2)
        ops_before = len(client.ops)
        fa.reset_launches()
        second = run_episodic_cycle(cfg, client=client, evaluator=evaluator,
                                    device=DEVICE)
    finally:
        harness._batched_probs_torch = engine_fn
        evaluator.check_once = check_once
    state = read_etl_state(cfg.data.processed_dir)
    with open(os.path.join(cfg.data.models_dir, "train_state", "p0",
                           "state", "meta.json")) as f:
        resumed = json.load(f)["epochs_completed"]
    challenger = os.path.join(cfg.loop.packages_dir, "pkg-00002")
    with open(os.path.join(challenger, "eval_report.json")) as f:
        report = json.load(f)
    walk = [op for op in client.ops[ops_before:]
            if op[0] in ("set_traffic", "set_mirror_traffic")]
    held = evaluator.held[-1] if evaluator.held else None
    if not (second["generation"] == 2 and state["mode"] == "delta"
            and resumed == 2 and os.path.exists(os.path.join(
                challenger, "model.npz"))
            and walk[:2] == [("set_traffic", ENDPOINT,
                              {"blue": 100, "green": 0}),
                             ("set_mirror_traffic", ENDPOINT,
                              {"green": 20})]
            and (second["promoted"] or held is not None)):
        raise AssertionError(f"(h1) cycle 2: {second} state {state} "
                             f"epochs {resumed} walk {walk} held {held}")
    if second["promoted"] and walk[-1] != ("set_traffic", ENDPOINT,
                                           {"green": 100}):
        raise AssertionError(f"(h1) promoted without the full flip: {walk}")
    # The gate's launches: layers x chunks x models x the consults that ran
    # the engine (the second consult reads the cached eval_report.json).
    x, y = harness.load_eval_split(cfg.data.processed_dir,
                                   harness.load_model(challenger)[1])
    eval_batch = EvaluationConfig.from_env().eval_batch
    chunks = -(-len(x) // eval_batch)
    want_gate = {"flash_fwd": SERVE_CFG["n_layers"] * chunks * 2 * 1,
                 "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
    want_train = _expected_train_launches(cfg)
    if counts["gate"] != want_gate or counts["train"] != want_train:
        raise AssertionError(f"(h1) launches {counts}, want gate "
                             f"{want_gate}, train {want_train}")
    if engine["calls"] != 2 or engine["windows"] != 2 * len(x):
        raise AssertionError(f"(h1) engine calls {engine}")
    # Every window the gate scored on the card, champion and challenger,
    # against the same engine with the kernel's plain version in its place.
    fa_kernel = fa.flash_attention

    def plain_attention(q, k, v, *, causal=False, window=None, **_):
        return fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window)[0]

    fa.flash_attention = plain_attention
    fa.reset_launches()
    try:
        gate_vs_plain = max(
            float(np.abs(probs - engine_fn(weights, meta, xs, batch_size,
                                           device)).max())
            for weights, meta, xs, batch_size, device, probs in scored)
    finally:
        fa.flash_attention = fa_kernel
    if not (gate_vs_plain <= AGREE_TOL
            and sum(fa.launch_counts().values()) == 0):
        raise AssertionError(f"(h1) gate engine vs plain {gate_vs_plain} "
                             f"(tol {AGREE_TOL}), {fa.launch_counts()}")
    # The deployed champion's endpoint (the numpy runtime) against the
    # torch engine on the card, on 3 held-out windows.
    live = max(client.get_traffic(ENDPOINT).items(), key=lambda kv: kv[1])[0]
    pkg = client.deployment_package_dir(ENDPOINT, live)
    served = np.asarray(client.score(ENDPOINT, {"data": x[:3].tolist()})[
        "probabilities"])
    weights, meta = harness.load_model(pkg)
    fa.reset_launches()
    on_card = harness.batched_probs(weights, meta, x[:3], engine="torch",
                                    device=DEVICE)
    agree = float(np.abs(served - on_card).max())
    if not (served.shape == (3, 2) and agree <= AGREE_TOL
            and fa.launch_counts()["flash_fwd"] == SERVE_CFG["n_layers"]):
        raise AssertionError(f"(h1) endpoint vs engine {agree} (tol "
                             f"{AGREE_TOL}), {fa.launch_counts()}")
    boot = report.get("bootstrap") or {}
    out = {
        "cycle1": {k: first[k] for k in ("etl_s", "train_s", "deploy_s",
                                          "cycle_s", "freshness_s",
                                          "val_loss", "generation")},
        "cycle2": {k: second[k] for k in ("etl_s", "train_s", "deploy_s",
                                           "cycle_s", "freshness_s",
                                           "val_loss", "generation",
                                           "promoted")},
        "gate": {"decision": "promote" if second["promoted"]
                 else held["decision"],
                 "reason": None if second["promoted"] else held["reason"],
                 "mean_delta": report["mean_delta"],
                 "ci90": [boot.get("ci_low"), boot.get("ci_high")],
                 "p_better": boot.get("p_better"),
                 "champion_loss": report["champion"]["loss_mean"],
                 "challenger_loss": report["challenger"]["loss_mean"],
                 "eval_windows": len(x), "eval_batch": eval_batch,
                 "engine_s": engine["s"],
                 "windows_per_s": engine["windows"] / engine["s"]},
        "walk": walk, "launches": counts,
        "gate_vs_plain_max_abs_err": gate_vs_plain,
        "endpoint_vs_engine_max_abs_err": agree, "card": card,
    }
    print(f"[smoke] (h1) episodic {out}", flush=True)
    return out


def _loop_job(env: dict, root: str, name: str, *, on_round_start=None,
              wait_s=900):
    """Run ``python -m dct_tpu_torch.loop_job``, its stderr into
    ``<root>/<name>.log``; ``on_round_start(proc)`` is called once the
    first round's fit has started its tracking run. Returns the summary and
    the job's stdout (a supervised round's ranks print there too)."""
    runs_dir = os.path.join(env["DCT_TRACKING_DIR"], "weather_forecasting")
    before = set(os.listdir(runs_dir)) if os.path.isdir(runs_dir) else set()
    log = open(os.path.join(root, f"{name}.log"), "w")
    proc = subprocess.Popen([sys.executable, "-m", "dct_tpu_torch.loop_job"],
                            env=env, cwd=HERE, stdout=subprocess.PIPE,
                            stderr=log, text=True)
    watcher = None
    if on_round_start is not None:
        def watch():
            while proc.poll() is None:
                now = (set(os.listdir(runs_dir)) if os.path.isdir(runs_dir)
                       else set())
                if now - before:
                    on_round_start(proc)
                    return
                time.sleep(0.05)

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
    try:
        out, _ = proc.communicate(timeout=wait_s)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        log.close()
        if watcher is not None:
            watcher.join(timeout=10)
    line = [x for x in out.splitlines()
            if x.startswith("[loop_job] summary ")]
    if proc.returncode != 0 or not line:
        raise AssertionError(f"loop_job ({name}) exit {proc.returncode}: "
                             f"{out[-2000:]} (stderr in {log.name})")
    return json.loads(line[-1][len("[loop_job] summary "):]), out


def loop_job_phase(root: str, card: str) -> dict:
    """(h2): ``python -m dct_tpu_torch.loop_job`` (inline, 2 rounds) with
    rows appended while round 1 trains; then a third run SIGTERMed
    mid-round."""
    import signal

    from dct_tpu_torch.data.synthetic import (
        append_weather_rows,
        generate_weather_csv,
    )

    loop_env = _loop_env(root)
    raw = loop_env["DCT_RAW_CSV"]
    generate_weather_csv(raw, rows=LOOP_ROWS, seed=3)
    env = _without_dct(os.environ)
    env.update(loop_env, PYTHONPATH=HERE, DCT_LOOP_MAX_ROUNDS="2",
               DCT_LOOP_POLL_S="0.5", DCT_LOOP_EVAL_POLL_S="0.5")
    appended = {}

    def append_rows(proc):
        appended["at"] = time.time()
        append_weather_rows(raw, rows=LOOP_APPEND, seed=4)

    t0 = time.perf_counter()
    two, _ = _loop_job(env, root, "two_rounds", on_round_start=append_rows)
    two_s = time.perf_counter() - t0
    fresh = two["freshness_s"]
    if not (two["rounds"] == 2 and two["reason"] == "max_rounds"
            and two["promotions"] >= 1 and fresh
            and all(np.isfinite(fresh)) and "at" in appended
            and two["ingested_generations"] == 2
            and two["ingested_generations"] == 2
            and two["evaluator_errors"] == 0 and two["ingest_errors"] == 0):
        raise AssertionError(f"(h2) two rounds: {two}")
    env["DCT_LOOP_MAX_ROUNDS"] = "0"
    signalled = {}

    def sigterm(proc):
        signalled["at"] = time.time()
        proc.send_signal(signal.SIGTERM)

    drained, _ = _loop_job(env, root, "sigterm", on_round_start=sigterm)
    last = os.path.join(loop_env["DCT_MODELS_DIR"], "last.ckpt")
    # The inline round's guard takes the signal: the epoch in flight ends,
    # both tiers are saved, and the loop drains without counting the
    # stopped round.
    from dct_tpu_torch.observability.events import read_events

    saved = _named(read_events(loop_env["DCT_EVENTS_DIR"]),
                   "preempt.checkpoint_saved")
    if not (drained["reason"] == "preempted" and drained["rounds"] == 0
            and "at" in signalled and drained["evaluator_errors"] == 0
            and drained["ingest_errors"] == 0 and drained["error"] is None
            and [s["ts"] >= signalled["at"] for s in saved] == [True]
            and os.path.getmtime(last) >= signalled["at"]):
        raise AssertionError(f"(h2) SIGTERM drain: {drained} {saved}")
    out = {"two_rounds": two, "two_rounds_wall_s": two_s,
           "sigterm": drained, "card": card}
    print(f"[smoke] (h2) loop_job {out}", flush=True)
    return out


# ----------------------------------------------------------------------
# (i) The supervised world at full width.

# (i2)'s heartbeat stall window, seconds. The monitor also takes it as the
# grace for a rank's first beat, which a cold rank on an H100 host writes
# 8-11 s after its launch (torch import, CUDA context): a 10 s window
# stall-killed a healthy relaunch as "missing". (i2) runs alone, so 20 s
# keeps about twice the slowest first beat seen.
SUP_STALL_S = 20
SUP_GRACE_S = 3  # SIGTERM -> SIGKILL escalation window in (i2)
SUP_BAND = 0.03  # val-loss band if a healed world is not bitwise equal


def _sup_env(root: str, name: str, **extra) -> dict:
    """A training world's environment in (i): (h)'s full-width transformer
    and data, 2 epochs, the world's own models, events and heartbeats."""
    env = _without_dct(os.environ)
    env.update(_loop_env(root))
    env.update(PYTHONPATH=HERE, DCT_EPOCHS="2",
               DCT_MODELS_DIR=os.path.join(root, name, "models"),
               DCT_TRACKING_DIR=os.path.join(root, name, "mlruns"),
               DCT_EVENTS_DIR=os.path.join(root, name, "events"),
               DCT_HEARTBEAT_DIR=os.path.join(root, name, "hb"))
    env.update(extra)
    return env


def _events_of(env: dict) -> list[dict]:
    from dct_tpu_torch.observability.events import read_events

    return read_events(env["DCT_EVENTS_DIR"])


def _named(events, name):
    return [e for e in events if e["event"] == name]


def _event_names(events) -> list:
    return [(e["component"], e["event"]) for e in events]


def _first_beat_s(events) -> list:
    """Per attempt, seconds from its ``launch_start`` to the rank's first
    beat (``fit_start`` follows the startup beat at once); None for an
    attempt that never beat."""
    out, start = [], None
    for e in events:
        if e["event"] == "launch_start":
            if start is not None:
                out.append(None)
            start = e["ts"]
        elif e["event"] == "fit_start" and start is not None:
            out.append(round(e["ts"] - start, 3))
            start = None
    return out + ([None] if start is not None else [])


def _epochs_of(per_epoch: dict, *epochs: int) -> list[dict]:
    """One rank's expected launch counts per attempt: ``epochs`` epochs of
    ``per_epoch`` each."""
    return [{k: n * v for k, v in per_epoch.items()} for n in epochs]


def _child_launches(out: str, want: list[dict], where: str) -> dict:
    """The flash launch counts the ranks printed (``[train_job] launches``
    at every exit but a crash or a kill), attempt by attempt, held to
    ``want``; returns their sum."""
    got = [json.loads(line[len("[train_job] launches "):])
           for line in out.splitlines()
           if line.startswith("[train_job] launches ")]
    if got != want:
        raise AssertionError(f"({where}) child launches {got}, want {want}")
    return {k: sum(c[k] for c in got) for k in want[0]}


def _supervise(env: dict, root: str, name: str, *, on_start=None,
               timeout=900) -> tuple[int, str]:
    """``python -m dct_tpu_torch.resilience.supervise --world-size 1 --
    python -m dct_tpu_torch.train_job``; stderr into ``<root>/<name>.log``.
    ``on_start(proc)`` runs on a thread once the process is up."""
    log = open(os.path.join(root, f"{name}.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dct_tpu_torch.resilience.supervise",
         "--world-size", "1", "--backoff", "1", "--",
         sys.executable, "-m", "dct_tpu_torch.train_job"],
        env=env, cwd=HERE, stdout=subprocess.PIPE, stderr=log, text=True)
    watcher = None
    if on_start is not None:
        watcher = threading.Thread(target=on_start, args=(proc,),
                                   daemon=True)
        watcher.start()
    try:
        out, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        log.close()
        if watcher is not None:
            watcher.join(timeout=10)
    return proc.returncode, out


def _resume_state(env: dict) -> list[np.ndarray]:
    path = os.path.join(env["DCT_MODELS_DIR"], "train_state", "p0", "state",
                        "state.npz")
    with np.load(path) as npz:
        return [npz[str(i)] for i in range(len(npz.files))]


def _against_clean(env: dict, clean_env: dict, where: str) -> dict:
    """The healed world's final train state against the uninterrupted
    world's: bitwise, else within SUP_BAND on the last val_loss."""
    got, want = _resume_state(env), _resume_state(clean_env)
    equal = len(got) == len(want) and all(
        np.array_equal(a, b) for a, b in zip(got, want))
    diff = max(float(np.max(np.abs(a.astype(np.float64)
                                   - b.astype(np.float64))))
               for a, b in zip(got, want))
    vl = [_named(_events_of(e), "epoch_end")[-1]["val_loss"]
          for e in (env, clean_env)]
    if not (equal or abs(vl[0] - vl[1]) <= SUP_BAND):
        raise AssertionError(f"({where}) healed world {vl[0]} vs "
                             f"uninterrupted {vl[1]}, max diff {diff}")
    return {"bitwise_equal": equal, "max_abs_diff": diff,
            "val_loss": vl[0], "uninterrupted_val_loss": vl[1]}


def _free_gib(out: str) -> list[float]:
    return [float(m.group(1)) for m in re.finditer(
        r"\[train_job\] \S+: ([0-9.]+) of [0-9.]+ GiB free at start", out)]


def supervised_phase(root: str, card: str) -> dict:
    """(i): the supervised world on the card through the supervise CLI:
    an uninterrupted 2-epoch world, then two chains side by side: (i1)
    crash, (i3) SIGTERM and (i4) nan drills against it, one after
    another, and (i5) loop_job in its default (supervised) mode. The (i2)
    hang drill runs later, alone on the card (:func:`hang_drill`)."""
    import signal

    from dct_tpu_torch.config import DataConfig, RunConfig
    from dct_tpu_torch.data.synthetic import generate_weather_csv
    from dct_tpu_torch.etl.preprocess import preprocess_csv_to_parquet
    from dct_tpu_torch.observability.events import read_events

    phase_t0 = time.perf_counter()
    os.makedirs(root, exist_ok=True)
    base = _loop_env(root)
    generate_weather_csv(base["DCT_RAW_CSV"], rows=LOOP_ROWS, seed=3)
    preprocess_csv_to_parquet(base["DCT_RAW_CSV"], base["DCT_PROCESSED_DIR"])
    per_epoch = _expected_train_launches(RunConfig(
        data=DataConfig(processed_dir=base["DCT_PROCESSED_DIR"])))

    # The uninterrupted world every drill is held to.
    clean = _sup_env(root, "clean")
    t0 = time.perf_counter()
    rc, out = _supervise(clean, root, "clean")
    clean_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"(i) uninterrupted world exit {rc}: "
                             f"{out[-2000:]}")
    launches = _child_launches(out, _epochs_of(per_epoch, 2), "i0")
    free_gib = _free_gib(out)

    def crash_drill():
        # (i1) crash@rank0:epoch1: one restart, classified crash.
        env = _sup_env(root, "crash", DCT_FAULT_SPEC="crash@rank0:epoch1")
        t0 = time.perf_counter()
        rc, out = _supervise(env, root, "crash")
        crash_s = time.perf_counter() - t0
        ev = _events_of(env)
        relaunch = _named(ev, "restart.relaunch")
        fault = _named(ev, "fault.injected")
        hb = json.load(open(os.path.join(env["DCT_HEARTBEAT_DIR"],
                                         "rank_00000.json")))
        if not (rc == 0 and len(_named(ev, "launch_start")) == 2
                and [e["classification"] for e in relaunch] == ["crash"]
                and [e["returncode"] for e in _named(ev, "rank_exit")]
                == [117, 0] and len(fault) == 1 and _named(ev, "launch_end")
                and [e["epoch"] for e in _named(ev, "epoch_end")] == [0, 1]
                and hb["phase"] == "done"):
            raise AssertionError(f"(i1) crash drill exit {rc}: "
                                 f"{_event_names(ev)}")
        counts = _child_launches(out, _epochs_of(per_epoch, 1), "i1")
        # Time to recover: from the crashed rank's last act (fault.injected,
        # just before os._exit) to the relaunched rank's first trained step
        # (the end of its trainer.startup span: the first step is issued
        # there; it adds one step time, about 20 ms at this width).
        spans = [json.loads(x) for x in open(os.path.join(
            env["DCT_EVENTS_DIR"], "spans", "rank_00000.jsonl"))]
        startup = [r for r in spans if r["name"] == "trainer.startup"
                   and r["t0"] > fault[0]["ts"]]
        exit_ts = [e["ts"] for e in _named(ev, "rank_exit")
                   if e["returncode"] == 117][0]
        crash = {
            "exit": rc, "wall_s": crash_s, "attempts": 2,
            "classification": relaunch[0]["classification"],
            "recover_s": startup[0]["t1"] - fault[0]["ts"],
            "exit_seen_after_s": exit_ts - fault[0]["ts"],
            "relaunch_startup_s": startup[0]["t1"] - startup[0]["t0"],
            "backoff_s": relaunch[0]["backoff_s"],
            "lost_wall_s": relaunch[0]["lost_wall_s"],
            "free_gib_at_start": _free_gib(out),
            "first_beat_s": _first_beat_s(ev),
            **_against_clean(env, clean, "i1"),
        }
        print(f"[smoke] (i1) crash drill {crash}", flush=True)
        print(f"[smoke] (i1) time to recover {crash['recover_s']:.3f} s "
              f"(lost_wall_s {crash['lost_wall_s']}, backoff "
              f"{crash['backoff_s']} s) on {card}", flush=True)
        return crash, counts

    def sigterm_drill():
        # (i3) SIGTERM to the rank in mid-epoch (held by slow_epoch): 75, a
        # free relaunch, exit 0.
        env = _sup_env(root, "sigterm",
                       DCT_FAULT_SPEC="slow_epoch@rank0:epoch0",
                       DCT_FAULT_SLEEP_S="1")
        signalled = {}

        def sigterm_rank(proc):
            while proc.poll() is None:
                if _named(_events_of(env), "fault.injected"):
                    pid = json.load(open(os.path.join(
                        env["DCT_HEARTBEAT_DIR"], "rank_00000.json")))["pid"]
                    signalled["at"] = time.time()
                    os.kill(pid, signal.SIGTERM)
                    return
                time.sleep(0.05)

        t0 = time.perf_counter()
        rc, out = _supervise(env, root, "sigterm", on_start=sigterm_rank)
        sigterm_s = time.perf_counter() - t0
        ev = _events_of(env)
        relaunch = _named(ev, "restart.relaunch")
        saved = _named(ev, "preempt.checkpoint_saved")
        if not (rc == 0 and "at" in signalled
                and [e["returncode"] for e in _named(ev, "rank_exit")]
                == [75, 0]
                and [(e["classification"], e["restarts_used"], e["backoff_s"])
                     for e in relaunch] == [("preempted", 0, 0)]
                and [e["epochs_completed"] for e in saved] == [1]
                and [e["epoch"] for e in _named(ev, "epoch_end")] == [0, 1]):
            raise AssertionError(f"(i3) SIGTERM drill exit {rc}: "
                                 f"{_event_names(ev)}")
        counts = _child_launches(out, _epochs_of(per_epoch, 1, 1), "i3")
        sigterm = {"exit": rc, "wall_s": sigterm_s, "epochs_lost": 0,
                   "saved_after_signal_s": saved[0]["ts"] - signalled["at"],
                   **_against_clean(env, clean, "i3")}
        print(f"[smoke] (i3) SIGTERM drill {sigterm}", flush=True)
        return sigterm, counts

    def nan_drill():
        # (i4) nan under the halt policy: 76, no relaunch, the supervisor 1.
        env = _sup_env(root, "nan", DCT_FAULT_SPEC="nan:epoch0",
                       DCT_HALT_ON_NAN="1")
        t0 = time.perf_counter()
        rc, out = _supervise(env, root, "nan")
        nan_s = time.perf_counter() - t0
        ev = _events_of(env)
        gave_up = _named(ev, "restart.gave_up")
        if not (rc == 1 and [e["returncode"] for e in _named(ev, "rank_exit")]
                == [76] and len(_named(ev, "launch_start")) == 1
                and [e["classification"] for e in gave_up] == ["health_halt"]
                and _named(ev, "health.nan_loss")
                and not _named(ev, "epoch_end")):
            raise AssertionError(f"(i4) nan drill exit {rc}: "
                                 f"{_event_names(ev)}")
        counts = _child_launches(out, _epochs_of(per_epoch, 1), "i4")
        print(f"[smoke] (i4) nan drill: exit {rc}, rank exit 76, "
              f"classification health_halt, no relaunch, {nan_s:.1f} s",
              flush=True)
        return {"exit": rc, "wall_s": nan_s}, counts

    def loop_drill():
        # (i5) loop_job in its default mode: two supervised rounds, then a
        # SIGTERM run that drains.
        from dct_tpu_torch.data.synthetic import append_weather_rows

        lroot = os.path.join(root, "loop")
        loop_env = _loop_env(lroot)
        generate_weather_csv(loop_env["DCT_RAW_CSV"], rows=LOOP_ROWS, seed=3)
        env = _without_dct(os.environ)
        env.update(loop_env, PYTHONPATH=HERE, DCT_LOOP_MAX_ROUNDS="2",
                   DCT_LOOP_POLL_S="0.5", DCT_LOOP_EVAL_POLL_S="0.5",
                   DCT_HEARTBEAT_DIR=os.path.join(lroot, "hb"))
        del env["DCT_LOOP_TRAIN_MODE"]
        appended = {}

        def append_rows(proc):
            appended["at"] = time.time()
            append_weather_rows(loop_env["DCT_RAW_CSV"], rows=LOOP_APPEND,
                                seed=4)

        t0 = time.perf_counter()
        two, out = _loop_job(env, lroot, "two_rounds",
                             on_round_start=append_rows)
        two_s = time.perf_counter() - t0
        rounds = _named(read_events(loop_env["DCT_EVENTS_DIR"]),
                        "loop.round")
        fresh = two["freshness_s"]
        if not (two["rounds"] == 2 and two["reason"] == "max_rounds"
                and two["promotions"] >= 1 and fresh
                and all(np.isfinite(fresh)) and "at" in appended
                and two["ingested_generations"] == 2
                and two["evaluator_errors"] == 0 and two["ingest_errors"] == 0
                and [(r["mode"], r["classification"]) for r in rounds]
                == [("supervised", "success")] * 2):
            raise AssertionError(f"(i5) two supervised rounds: {two} {rounds}")
        # Round 2 trains on the appended rows too.
        grown = _expected_train_launches(RunConfig(
            data=DataConfig(processed_dir=loop_env["DCT_PROCESSED_DIR"])))
        counts = _child_launches(out, [per_epoch, grown], "i5")
        env["DCT_LOOP_MAX_ROUNDS"] = "0"
        # The rank finishes its span (one epoch of the grown rows, beside
        # the (i1)-(i4) worlds on the same card) before it saves and exits
        # 75: the supervisor's grace window must outlast that span, or it
        # SIGKILLs the rank before its snapshot and its launch line.
        env["DCT_PREEMPT_GRACE_S"] = "90"
        signalled = {}

        def sigterm_loop(proc):
            signalled["at"] = time.time()
            proc.send_signal(signal.SIGTERM)

        t0 = time.perf_counter()
        drained, out = _loop_job(env, lroot, "sigterm",
                                 on_round_start=sigterm_loop)
        drained_s = time.perf_counter() - t0
        last = os.path.join(loop_env["DCT_MODELS_DIR"], "last.ckpt")
        if not (drained["reason"] == "preempted" and drained["rounds"] == 1
                and drained["error"] is None and "at" in signalled
                and os.path.getmtime(last) >= signalled["at"]):
            raise AssertionError(f"(i5) SIGTERM drain: {drained}")
        saved = _named(read_events(loop_env["DCT_EVENTS_DIR"]),
                       "preempt.checkpoint_saved")
        if len(saved) != 1:
            raise AssertionError(f"(i5) SIGTERM drain: the rank saved "
                                 f"{len(saved)} resume snapshots, want 1")
        counts = {k: v + counts[k] for k, v in
                  _child_launches(out, [grown], "i5").items()}
        loop = {"two_rounds": two, "two_rounds_wall_s": two_s,
                "round_classifications": [r["classification"] for r in rounds],
                "freshness_s": fresh, "sigterm": drained,
                "sigterm_wall_s": drained_s,
                "saved_after_signal_s": saved[0]["ts"] - signalled["at"]}
        print(f"[smoke] (i5) loop_job supervised {loop}", flush=True)
        return loop, counts

    with ThreadPoolExecutor(2) as pool:
        chain = pool.submit(lambda: [crash_drill(), sigterm_drill(),
                                     nan_drill()])
        looped = pool.submit(loop_drill)
        (crash, c1), (sigterm, c3), (nan, c4) = chain.result()
        loop, c5 = looped.result()
    for counts in (c1, c3, c4, c5):
        launches = {k: v + counts[k] for k, v in launches.items()}
    out = {"uninterrupted_wall_s": clean_s, "free_gib_at_start": free_gib,
           "clean_models_dir": clean["DCT_MODELS_DIR"], "clean_env": clean,
           "crash": crash, "sigterm": sigterm, "nan": nan, "loop": loop,
           "launches": launches, "per_epoch": per_epoch, "card": card}
    out["phase_s"] = time.perf_counter() - phase_t0
    print(f"[smoke] (i) supervised launches {launches} "
          f"(per epoch {per_epoch}); uninterrupted world {clean_s:.1f} s, "
          f"phase {out['phase_s']:.1f} s on {card}", flush=True)
    return out


def hang_drill(root: str, card: str, clean: dict, per_epoch: dict) -> dict:
    """(i2) hang@rank0:epoch1 against (i)'s uninterrupted world ``clean``:
    stall-killed, relaunched. Run with no other process on the card: its
    check that the killed rank's memory came back reads the card's free
    memory at each start."""
    import signal

    # (i2) hang@rank0:epoch1: stall-killed, relaunched.
    env = _sup_env(root, "hang", DCT_FAULT_SPEC="hang@rank0:epoch1",
                   DCT_HEARTBEAT_STALL_SECONDS=str(SUP_STALL_S),
                   DCT_HEARTBEAT_INTERVAL="1",
                   DCT_PREEMPT_GRACE_S=str(SUP_GRACE_S))
    t0 = time.perf_counter()
    rc, out = _supervise(env, root, "hang")
    hang_s = time.perf_counter() - t0
    ev = _events_of(env)
    relaunch = _named(ev, "restart.relaunch")
    free = _free_gib(out)
    if not (rc == 0 and [e["classification"] for e in relaunch] == ["hang"]
            and _named(ev, "restart.stall_kill") and _named(ev, "rank_stalled")
            and [e["returncode"] for e in _named(ev, "rank_exit")]
            == [-signal.SIGKILL, 0]
            and [e["epoch"] for e in _named(ev, "epoch_end")] == [0, 1]
            and (DEVICE == "cpu"  # a CPU rehearsal prints no card memory
                 or (len(free) == 2 and free[1] >= free[0] - 1.0))):
        raise AssertionError(f"(i2) hang drill exit {rc}, free {free}, "
                             f"first beat {_first_beat_s(ev)} s: "
                             f"{[(e['component'], e['event']) for e in ev]}")
    launches = _child_launches(out, _epochs_of(per_epoch, 1), "i2")
    hang = {"exit": rc, "wall_s": hang_s,
            "classification": relaunch[0]["classification"],
            "stall_s": SUP_STALL_S,
            "stall_kill_after_fault_s": _named(ev, "restart.stall_kill")[0][
                "ts"] - _named(ev, "fault.injected")[0]["ts"],
            "lost_wall_s": relaunch[0]["lost_wall_s"],
            "free_gib_at_start": free, "first_beat_s": _first_beat_s(ev),
            **_against_clean(env, clean, "i2")}
    print(f"[smoke] (i2) hang drill {hang}", flush=True)
    return dict(hang, launches=launches, card=card)


# ----------------------------------------------------------------------
# (j) The multi-tenant scheduler at full width.

SCHED_RELEASES = 14  # (j1): lease releases seen before the SIGTERM (>= 12)
SCHED_QUOTA_BAND = 0.2  # (j1): granted share within 20% of the quota share
SCHED_PREEMPT_WAIT_S = 2  # (j2): a starved waiter's wait before it preempts
SCHED_SLOW_S = 3  # (j2): bulk's epoch 0 held this long (slow_epoch)


def _job_lines(out: str, tag: str) -> list:
    return [json.loads(line[len(tag) + 1:]) for line in out.splitlines()
            if line.startswith(tag + " ")]


def _sched_env(root: str, tenants: list, **extra) -> dict:
    """``scheduler_job``'s environment: (h)'s full-width transformer and
    loop settings (bf16, one epoch a round, the gate's torch engine), the
    roster, the scheduler's own events and the metrics plane armed."""
    env = _without_dct(os.environ)
    env.update(_loop_env(root))
    for key in ("DCT_RAW_CSV", "DCT_PROCESSED_DIR", "DCT_MODELS_DIR",
                "DCT_LOOP_PACKAGES_DIR", "DCT_LOOP_ENDPOINT"):
        del env[key]  # the scheduler assigns each tenant its own
    env.update(PYTHONPATH=HERE, DCT_TENANTS=json.dumps(tenants),
               DCT_SCHED_ROOT=os.path.join(root, "tenants"),
               DCT_EVENTS_DIR=os.path.join(root, "events"),
               DCT_METRICS_DIR=os.path.join(root, "metrics"),
               DCT_METRICS_PUBLISH_S="0.5", DCT_SCHED_POLL_S="0.2",
               DCT_LOOP_POLL_S="0.5", DCT_LOOP_EVAL_POLL_S="0.5")
    env.update(extra)
    return env


def _scheduler_job(env: dict, root: str, name: str, *, watch=None,
                   timeout=600) -> tuple[int, str]:
    """``python -m dct_tpu_torch.scheduler_job``, its stderr into
    ``<root>/<name>.log``; ``watch(proc)`` runs on a thread while it runs.
    Returns the exit code and the job's stdout (the ranks print there
    too)."""
    log = open(os.path.join(root, f"{name}.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dct_tpu_torch.scheduler_job"], env=env,
        cwd=HERE, stdout=subprocess.PIPE, stderr=log, text=True)
    watcher = None
    if watch is not None:
        watcher = threading.Thread(target=watch, args=(proc,), daemon=True)
        watcher.start()
    try:
        out, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        log.close()
        if watcher is not None:
            watcher.join(timeout=10)
    return proc.returncode, out


def _lib_state() -> dict:
    """Every kernel library under ``build/dct_tpu_torch`` with its mtime:
    a rebuild would change the set or a time."""
    from dct_tpu_torch.ops.build import BUILD_DIR

    if not os.path.isdir(BUILD_DIR):  # a CPU rehearsal builds nothing
        return {}
    return {n: os.path.getmtime(os.path.join(BUILD_DIR, n))
            for n in sorted(os.listdir(BUILD_DIR)) if n.endswith(".so")}


def _check_job_kernels(out: str, where: str, names: tuple) -> dict:
    """The job loaded the libraries ``names`` (the ones this process built
    or loaded) and built none itself."""
    from dct_tpu_torch.ops import build

    got = _job_lines(out, "[scheduler_job] kernels")[-1]
    if DEVICE == "cpu":  # the plain path loads no library
        return got
    want = {n: build.build_info[n]["path"] for n in names}
    if {n: g["path"] for n, g in got.items()} != want or any(
            g["built"] for g in got.values()):
        raise AssertionError(f"({where}) kernel libraries {got}, want the "
                             f"built ones {want} loaded, none built")
    return got


def _gate_per_consult() -> int:
    """Forward launches of one gate engine pass: every layer, for the
    champion and the challenger, over one chunk of held-out windows."""
    return SERVE_CFG["n_layers"] * 2


def _check_sched_launches(got: dict, want: dict, where: str) -> None:
    if got != want:
        raise AssertionError(f"({where}) launches {got}, want {want}")


def sched_quota_phase(root: str, card: str, per_epoch: dict) -> dict:
    """(j1): two inline tenants, weights 1 and 2, one epoch a round on (h)'s
    rows; SIGTERM once SCHED_RELEASES leases were released."""
    import signal

    from dct_tpu_torch.data.synthetic import generate_weather_csv
    from dct_tpu_torch.observability.aggregate import aggregate_text
    from dct_tpu_torch.observability.events import read_events

    os.makedirs(root, exist_ok=True)
    raw = os.path.join(root, "raw", "weather.csv")
    generate_weather_csv(raw, rows=LOOP_ROWS, seed=3)
    tenants = [{"name": "alpha", "weight": 1.0, "env": {"DCT_RAW_CSV": raw}},
               {"name": "beta", "weight": 2.0, "env": {"DCT_RAW_CSV": raw}}]
    env = _sched_env(root, tenants, DCT_SCHED_CONCURRENT="1")
    events_dir = env["DCT_EVENTS_DIR"]
    signalled = {}

    def sigterm_after_releases(proc):
        while proc.poll() is None:
            if len(_named(read_events(events_dir),
                          "sched.release")) >= SCHED_RELEASES:
                signalled["at"] = time.time()
                proc.send_signal(signal.SIGTERM)
                return
            time.sleep(0.1)

    libs = _lib_state()
    t0 = time.perf_counter()
    rc, out = _scheduler_job(env, root, "j1", watch=sigterm_after_releases)
    wall_s = time.perf_counter() - t0
    ev = read_events(events_dir)
    summary = _job_lines(out, "[scheduler_job] summary")[-1]
    stops = _named(ev, "tenant.stop")
    if not (rc == 0 and "at" in signalled and _named(ev, "sched.stop")
            and sorted(s["tenant"] for s in stops) == ["alpha", "beta"]
            and not _named(ev, "tenant.parked")
            and summary["reason"] == "signal_15"
            and len(_named(ev, "sched.release")) == summary["total_rounds"]
            >= SCHED_RELEASES):
        raise AssertionError(f"(j1) exit {rc}: {summary} "
                             f"{[(e['event'], e.get('tenant')) for e in ev]}")
    # The quota account on ONE aggregated scrape of the metrics dir.
    _, merged = aggregate_text(env["DCT_METRICS_DIR"], stale_s=0)
    chip = {t: merged.value("dct_tenant_chip_seconds_total", {"tenant": t})
            for t in ("alpha", "beta")}
    total = sum(chip.values())
    shares = {t: chip[t] / total for t in chip}
    quota = {"alpha": 1 / 3, "beta": 2 / 3}
    off = {t: abs(shares[t] - quota[t]) / quota[t] for t in quota}
    if max(off.values()) > SCHED_QUOTA_BAND:
        raise AssertionError(f"(j1) granted shares {shares} against {quota}")
    beta_promotions = summary["tenants"]["beta"]["promotions"]
    if beta_promotions < 2:  # the first deploys straight; later ones gate
        raise AssertionError(f"(j1) beta promoted {beta_promotions} times")
    # Launches: every round one epoch of (h)'s rows; 8 forward launches
    # (4 layers x 2 models x one chunk of (h1)'s 432 windows) per gate
    # consult, one engine pass per package the gate judged (every
    # promotion but a tenant's first, and every hold).
    consults = sum(s["promotions"] + s["held"] - (1 if s["promotions"] else 0)
                   for s in stops)
    rounds = summary["total_rounds"]
    got = _job_lines(out, "[scheduler_job] launches")[-1]
    want = {k: rounds * v for k, v in per_epoch.items()}
    want["flash_fwd"] += _gate_per_consult() * consults
    _check_sched_launches(got, want, "j1")
    kernels = _check_job_kernels(out, "j1", ("flash_fwd", "flash_bwd"))
    if _lib_state() != libs:
        raise AssertionError("(j1) kernel libraries rebuilt")
    grants = [e["tenant"] for e in _named(ev, "sched.grant")]
    res = {"exit": rc, "wall_s": wall_s, "rounds": rounds,
           "grants": grants, "chip_s": chip, "granted_share": shares,
           "share_error": off, "promotions": {
               s["tenant"]: s["promotions"] for s in stops},
           "held": {s["tenant"]: s["held"] for s in stops},
           "gate_consults": consults, "launches": got, "kernels": kernels,
           "mean_wait_s": {t: summary["tenants"][t]["mean_wait_s"]
                           for t in quota},
           "goodput_fraction": {t: summary["tenants"][t]["goodput_fraction"]
                                for t in quota}, "card": card}
    print(f"[smoke] (j1) quota {res}", flush=True)
    print(f"[smoke] (j1) wall {wall_s:.1f} s on {card}", flush=True)
    return res


def sched_revocation_phase(root: str, card: str, per_epoch: dict,
                           clean_models_dir: str) -> dict:
    """(j2) + (j3): supervised tenants ``bulk`` (low, 2 epochs a round,
    epoch 0 held by ``slow_epoch``), ``hot`` (high, 1 epoch, its data
    arriving once bulk's world trains) and ``sick`` (low, nan under the
    halt policy)."""
    from dct_tpu_torch.data.synthetic import generate_weather_csv
    from dct_tpu_torch.observability.aggregate import aggregate_text
    from dct_tpu_torch.observability.events import read_events

    os.makedirs(root, exist_ok=True)
    raw = os.path.join(root, "raw", "weather.csv")
    raw_hot = os.path.join(root, "raw", "hot.csv")
    generate_weather_csv(raw, rows=LOOP_ROWS, seed=3)  # (i)'s rows
    tenants = [
        {"name": "bulk", "priority": "low",
         "env": {"DCT_RAW_CSV": raw, "DCT_LOOP_EPOCHS_PER_ROUND": "2",
                 "DCT_LOOP_MAX_ROUNDS": "2",
                 "DCT_FAULT_SPEC": "slow_epoch@rank0:epoch0",
                 "DCT_FAULT_SLEEP_S": str(SCHED_SLOW_S)}},
        {"name": "hot", "priority": "high",
         "env": {"DCT_RAW_CSV": raw_hot, "DCT_LOOP_MAX_ROUNDS": "1"}},
        {"name": "sick", "priority": "low",
         "env": {"DCT_RAW_CSV": raw, "DCT_FAULT_SPEC": "nan:epoch0",
                 "DCT_HALT_ON_NAN": "1"}},
    ]
    env = _sched_env(root, tenants, DCT_LOOP_TRAIN_MODE="supervised",
                     DCT_SCHED_PREEMPT_WAIT_S=str(SCHED_PREEMPT_WAIT_S))
    troot = env["DCT_SCHED_ROOT"]
    bulk_events = os.path.join(troot, "bulk", "events")
    staged = {}

    def stage_hot_data(proc):
        # hot's data arrives once bulk's world trains (its epoch 0 began).
        while proc.poll() is None:
            if _named(read_events(bulk_events), "fault.injected"):
                generate_weather_csv(raw_hot, rows=LOOP_ROWS, seed=5)
                staged["at"] = time.time()
                return
            time.sleep(0.05)

    libs = _lib_state()
    t0 = time.perf_counter()
    rc, out = _scheduler_job(env, root, "j2", watch=stage_hot_data)
    wall_s = time.perf_counter() - t0
    ev = read_events(env["DCT_EVENTS_DIR"])
    summary = _job_lines(out, "[scheduler_job] summary")[-1]
    bulk = read_events(bulk_events)
    preempts = _named(ev, "sched.preempt")
    order = [(e["event"], e.get("tenant")) for e in ev
             if e["event"] in ("sched.grant", "sched.release",
                               "sched.preempt", "tenant.parked")]
    # (j2) revocation: bulk's world exits 75, no relaunch in the lease.
    if not (rc == 1 and "at" in staged
            and [(p["tenant"], p["waiter"]) for p in preempts]
            == [("bulk", "hot")]
            and len(_named(bulk, "supervise_preempted")) == 1
            and not _named(bulk, "restart.relaunch")
            and [e["returncode"] for e in _named(bulk, "rank_exit")]
            == [75, 0]
            and [e["epochs_completed"] for e in _named(
                bulk, "preempt.checkpoint_saved")] == [1]
            and [e["epoch"] for e in _named(bulk, "epoch_end")] == [0, 1]
            and [r.get("preempted") for r in _named(bulk, "loop.round")]
            == [True, None]):
        seen = {"staged": "at" in staged,
                "preempts": [(p["tenant"], p["waiter"]) for p in preempts],
                "rank_exits": [e["returncode"]
                               for e in _named(bulk, "rank_exit")],
                "saved": [e["epochs_completed"] for e in _named(
                    bulk, "preempt.checkpoint_saved")],
                "epochs": [e["epoch"] for e in _named(bulk, "epoch_end")],
                "rounds": [r.get("preempted")
                           for r in _named(bulk, "loop.round")]}
        raise AssertionError(f"(j2) exit {rc}, {seen}: {order} "
                             f"{_event_names(bulk)}")
    after = order[order.index(("sched.preempt", "bulk")):]
    hot_epochs = _named(read_events(os.path.join(troot, "hot", "events")),
                        "epoch_end")
    if not (("sched.grant", "hot") in after and len(hot_epochs) == 1):
        raise AssertionError(f"(j2) hot after the preemption: {order}")
    # The resumed trajectory against (i)'s uninterrupted 2-epoch world.
    got = _resume_state({"DCT_MODELS_DIR": os.path.join(troot, "bulk",
                                                        "models")})
    want = _resume_state({"DCT_MODELS_DIR": clean_models_dir})
    equal = len(got) == len(want) and all(
        np.array_equal(a, b) for a, b in zip(got, want))
    diff = max(float(np.max(np.abs(a.astype(np.float64)
                                   - b.astype(np.float64))))
               for a, b in zip(got, want))
    if not equal:
        raise AssertionError(f"(j2) resumed bulk differs from the "
                             f"uninterrupted world: max diff {diff}")
    # (j3) isolation: sick halts (76) and parks; bulk keeps taking rounds.
    sick = read_events(os.path.join(troot, "sick", "events"))
    parked = _named(ev, "tenant.parked")
    if not ([e["returncode"] for e in _named(sick, "rank_exit")] == [76]
            and [(p["tenant"], p["classification"]) for p in parked]
            == [("sick", "health_halt")]
            and ("sched.grant", "bulk") in order[
                order.index(("sched.release", "sick")):]
            and summary["tenants"]["sick"]["state"] == "parked"
            and summary["tenants"]["bulk"]["state"] == "stopped"):
        raise AssertionError(f"(j3) isolation: {order}")
    # Every rank of the session trained one epoch of (h)'s rows' size
    # (bulk twice, hot, sick's halted epoch 0); the job's own launches are
    # the gate engines'.
    ranks = _job_lines(out, "[train_job] launches")
    _check_sched_launches(
        sorted(json.dumps(c, sort_keys=True) for c in ranks),
        [json.dumps(per_epoch, sort_keys=True)] * 4, "j2 ranks")
    job = _job_lines(out, "[scheduler_job] launches")[-1]
    stops = _named(ev, "tenant.stop")
    consults = sum(s["promotions"] + s["held"] - (1 if s["promotions"] else 0)
                   for s in stops)
    _check_sched_launches(job, {"flash_fwd": _gate_per_consult() * consults,
                                "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}, "j2")
    # The job itself runs only the gate engines (forward); the ranks load
    # both libraries from the same build (the set and times checked next).
    kernels = _check_job_kernels(out, "j2", ("flash_fwd",))
    if _lib_state() != libs:
        raise AssertionError("(j2) kernel libraries rebuilt")
    _, merged = aggregate_text(env["DCT_METRICS_DIR"], stale_s=0)
    saved = _named(bulk, "preempt.checkpoint_saved")[0]["ts"]
    preempt_ts = preempts[0]["ts"]
    res = {"exit": rc, "wall_s": wall_s, "order": order,
           "preempt_waited_s": preempts[0]["waited_s"],
           "revoked_to_saved_s": saved - preempt_ts,
           "bulk_bitwise_equal": equal, "bulk_max_abs_diff": diff,
           "sick_parked": parked[0]["classification"],
           "restarts_total": merged.total("dct_restarts_total"),
           "parked_gauge": merged.value("dct_tenant_parked",
                                        {"tenant": "sick"}),
           "rank_launches": {k: sum(c[k] for c in ranks) for k in per_epoch},
           "job_launches": job, "gate_consults": consults,
           "kernels": kernels, "card": card}
    print(f"[smoke] (j2/j3) revocation and isolation {res}", flush=True)
    print(f"[smoke] (j2/j3) wall {wall_s:.1f} s on {card}", flush=True)
    return res


def scheduler_quota(root: str, card: str) -> dict:
    """(j1): the per-epoch launch counts of (h)'s rows, then the quota
    session (:func:`sched_quota_phase`)."""
    from dct_tpu_torch.config import DataConfig, RunConfig
    from dct_tpu_torch.data.synthetic import generate_weather_csv
    from dct_tpu_torch.etl.preprocess import preprocess_csv_to_parquet

    os.makedirs(root, exist_ok=True)
    # The per-epoch counts of (h)'s rows (the same for every tenant here).
    probe = os.path.join(root, "probe")
    generate_weather_csv(os.path.join(probe, "raw.csv"), rows=LOOP_ROWS,
                         seed=3)
    preprocess_csv_to_parquet(os.path.join(probe, "raw.csv"),
                              os.path.join(probe, "processed"))
    per_epoch = _expected_train_launches(RunConfig(data=DataConfig(
        processed_dir=os.path.join(probe, "processed"))))
    quota = sched_quota_phase(os.path.join(root, "quota"), card, per_epoch)
    return dict(quota, per_epoch=per_epoch)


def scheduler_phase(root: str, card: str, clean_models_dir: str,
                    quota: dict) -> dict:
    """(j): ``python -m dct_tpu_torch.scheduler_job`` on the card: (j1)'s
    ``quota`` session (:func:`scheduler_quota`), then (j2) revocation
    with (j3) isolation in one session. (j2) runs with no other work on
    the card: its revoked world must save and exit within the preemption
    grace, which a loaded card's slower epoch can outlast."""
    per_epoch = quota["per_epoch"]
    revoke = sched_revocation_phase(os.path.join(root, "revoke"), card,
                                    per_epoch, clean_models_dir)
    launches = {k: quota["launches"][k] + revoke["rank_launches"][k]
                + revoke["job_launches"][k] for k in per_epoch}
    gate = {k: 0 for k in per_epoch}
    gate["flash_fwd"] = _gate_per_consult() * (quota["gate_consults"]
                                               + revoke["gate_consults"])
    out = {"quota": quota, "revoke": revoke, "launches": launches,
           "gate_launches": gate, "card": card,
           "phase_s": quota["wall_s"] + revoke["wall_s"]}
    print(f"[smoke] (j) scheduler launches {launches} (gate {gate}); "
          f"(j1) {quota['wall_s']:.1f} s, (j2/j3) {revoke['wall_s']:.1f} s "
          f"on {card}", flush=True)
    return out


# ----------------------------------------------------------------------
# (k) The serving path, completed: int8, the warm start, the pool,
# overload, endpoint mode, the predict job and the DCT_FLASH knobs.

PROB_BOUND = 0.05  # int8 against its f32 twin (the package's prob_bound)
PREDICT_CHUNK = 256  # windows a forward: one d_ff activation is 2 GiB f32
SWEEP_LEVELS = (1, 4, 16)
SWEEP_REQUESTS = 24  # per level, 8 windows a request
BURST_THREADS, BURST_EACH = 16, 4  # (k4): keep-alive senders x requests
K_META = dict(model="weather_transformer", name="weather_transformer",
              input_dim=5, num_classes=2, horizon=1, **SERVE_CFG)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return thread


def _stop(server, thread):
    server.shutdown()
    server.server_close()
    thread.join(30)


def _windows(rng, n):
    return rng.standard_normal((n, SERVE_CFG["seq_len"], 5)).astype(
        np.float32)


def _post_raw(port, windows, path="/score", headers=None):
    """(status, payload, headers, ms) of one POST; a 4xx/5xx is returned,
    not raised."""
    import urllib.error

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps({"data": windows.tolist()}).encode(),
        headers=headers or {})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            status, body, hdrs = r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        status, body, hdrs = e.code, e.read(), dict(e.headers)
    return status, json.loads(body), hdrs, (time.perf_counter() - t0) * 1e3


def _scrape(port) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=60) as r:
        return r.read().decode()


def _metric(text: str, name: str, labels: str = "") -> float:
    """The fleet total of ``name{labels}`` (the line without ``proc``)."""
    key = f"{name}{{{labels}}}" if labels else name
    for line in text.splitlines():
        if line.startswith(key + " "):
            return float(line.rsplit(" ", 1)[1])
    raise AssertionError(f"{key} not on the scrape")


def _procs(text: str) -> set:
    return {line.split('proc="')[1].split('"')[0]
            for line in text.splitlines()
            if line.startswith("dct_requests_total{") and 'proc="' in line}


def _check_probs(where, probs, n):
    if probs.shape[0] != n or not np.isfinite(probs).all():
        raise AssertionError(f"{where}: bad answer {probs.shape} for {n}")
    if np.abs(probs.sum(axis=-1) - 1).max() > 1e-5:
        raise AssertionError(f"{where}: probabilities do not sum to 1")


def k_int8_phase(fa, root: str) -> dict:
    """(k1) the int8 twin of the f32 package through the HTTP server
    against the f32 package and the port's CPU path; (k1b) an MLP package
    written by the port's ``score_gen``, served on the card."""
    from dct_tpu_torch.checkpoint.manager import save_checkpoint
    from dct_tpu_torch.config import ServingConfig
    from dct_tpu_torch.models.registry import config_from_meta, get_model
    from dct_tpu_torch.serving.batching import TorchScorer
    from dct_tpu_torch.serving.package import (
        init_package_weights,
        load_package,
        write_package,
    )
    from dct_tpu_torch.serving.quant import quantize_package
    from dct_tpu_torch.serving.runtime import score_payload
    from dct_tpu_torch.serving.score_gen import generate_score_package
    from dct_tpu_torch.serving.server import make_server

    pkgs = {"f32": os.path.join(root, "f32"), "int8": os.path.join(root,
                                                                    "int8")}
    write_package(pkgs["f32"], init_package_weights(K_META, seed=0), K_META)
    quantize_package(pkgs["f32"], pkgs["int8"], "int8")
    out = {"sizes": list(REQUEST_SIZES)}
    answers = {}
    for variant in ("f32", "int8"):
        _sync()
        mem0 = torch.cuda.memory_allocated()
        server = make_server(pkgs[variant], device=DEVICE,
                             serving=ServingConfig(workers=2))
        _sync()
        resident = torch.cuda.memory_allocated() - mem0
        thread = _start(server)
        rng = np.random.default_rng(7)
        lat, answers[variant] = {}, {}
        try:
            fa.reset_launches()
            forwards0 = server.scorer.forwards
            for n in REQUEST_SIZES:
                x = _windows(rng, n)
                status, payload, _, ms = _post_raw(server.server_address[1],
                                                   x)
                if status != 200:
                    raise AssertionError(f"(k1) {variant}: {status} {payload}")
                probs = np.asarray(payload["probabilities"])
                _check_probs(f"(k1) {variant}", probs, n)
                answers[variant][n] = (x, probs)
                lat[str(n)] = ms
            launches = fa.launches
            forwards = server.scorer.forwards - forwards0
        finally:
            _stop(server, thread)
        if launches != SERVE_CFG["n_layers"] * forwards or forwards < 1:
            raise AssertionError(f"(k1) {variant}: {launches} launches for "
                                 f"{forwards} forwards")
        out[variant] = {"resident_bytes_allocated": resident,
                        "resident_bytes_tensors":
                            server.scorer.resident_bytes(),
                        "latency_ms": lat, "launches": launches,
                        "forwards": forwards}
        del server
        torch.cuda.empty_cache()
    twin_err = max(float(np.abs(answers["int8"][n][1]
                                - answers["f32"][n][1]).max())
                   for n in REQUEST_SIZES)
    if not twin_err <= PROB_BOUND:
        raise AssertionError(f"(k1) int8 vs f32 {twin_err} > {PROB_BOUND}")
    weights, meta = load_package(pkgs["int8"])
    x, probs = answers["int8"][32]
    pick = [0, 31]
    cpu_err = float(np.abs(TorchScorer(weights, meta, "cpu")(x[pick])
                           - probs[pick]).max())
    if not cpu_err <= TOL[torch.float32]:
        raise AssertionError(f"(k1) int8 card vs cpu {cpu_err}")
    out.update(int8_vs_f32_max_abs=twin_err, int8_cuda_vs_cpu=cpu_err,
               memory_ratio=(out["int8"]["resident_bytes_tensors"]
                             / out["f32"]["resident_bytes_tensors"]))
    print(f"[smoke] (k1) int8 {out}", flush=True)

    # (k1b) the MLP package of the port's own packager (C4).
    mlp_meta = {"model": "weather_mlp", "name": "weather_mlp",
                "input_dim": 5, "hidden_dim": 64, "num_classes": 2}
    torch.manual_seed(0)
    ckpt = save_checkpoint(os.path.join(root, "mlp.ckpt"),
                           get_model(config_from_meta(mlp_meta),
                                     device="cpu"), mlp_meta)
    mlp_pkg = os.path.join(root, "mlp")
    generate_score_package(ckpt, mlp_pkg)
    server = make_server(mlp_pkg, device=DEVICE,
                         serving=ServingConfig(workers=1))
    thread = _start(server)
    rows = np.random.default_rng(3).standard_normal((8, 5)).astype(np.float32)
    try:
        fa.reset_launches()
        status, payload, _, ms = _post_raw(server.server_address[1], rows)
        mlp_launches = fa.launches
    finally:
        _stop(server, thread)
    weights, meta = load_package(mlp_pkg)
    ref = np.asarray(score_payload(weights, meta, rows.tolist())
                     ["probabilities"])
    got = np.asarray(payload["probabilities"])
    err = float(np.abs(got - ref).max()) if status == 200 else float("inf")
    if status != 200 or not err <= 1e-5 or server.device.type != DEVICE:
        raise AssertionError(f"(k1b) mlp {status} {payload} err {err}")
    out["mlp"] = {"keys": sorted(weights), "device": str(server.device),
                  "vs_numpy_max_abs_err": err, "latency_ms": ms,
                  "launches": mlp_launches}
    print(f"[smoke] (k1b) mlp package on the card {out['mlp']}", flush=True)
    return out


class _Proc:
    """A server subprocess whose stdout lines are collected on a thread."""

    def __init__(self, cmd, env, log_path):
        self.lines = []
        self.log = open(log_path, "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(cmd, env=env, cwd=HERE, text=True,
                                     stdout=subprocess.PIPE, stderr=self.log)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append((time.perf_counter(), line.rstrip("\n")))

    def wait_for(self, prefix, timeout=240.0) -> float:
        """Seconds from the start to the first stdout line with ``prefix``."""
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            for t, line in list(self.lines):
                if line.startswith(prefix):
                    return t - self.t0
            if self.proc.poll() is not None:
                break
            time.sleep(0.02)
        self.stop()
        raise AssertionError(f"no {prefix!r} line (exit {self.proc.poll()}; "
                             f"stderr in {self.log.name})")

    def line(self, prefix):
        found = [line for _, line in self.lines if line.startswith(prefix)]
        return found[-1] if found else None

    def terminate(self, timeout=120.0) -> int:
        import signal

        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=timeout)
        finally:
            self.stop()
        self.reader.join(10)
        return rc

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(30)
        self.log.close()


def _child_env(**extra) -> dict:
    """This environment without ``DCT_*``, the checkout first on the path,
    and ``extra``."""
    env = _without_dct(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p)
    if DEVICE == "cpu":
        env["DCT_DEVICE"] = "cpu"
    env.update(extra)
    return env


def _serve_env(root, name, port, **extra) -> dict:
    return _child_env(**{
        "DCT_SERVE_HOST": "127.0.0.1", "DCT_SERVE_PORT": str(port),
        "DCT_EVENTS_DIR": os.path.join(root, f"events-{name}"),
        "DCT_METRICS_DIR": os.path.join(root, f"metrics-{name}"),
        "DCT_METRICS_PUBLISH_S": "0.2", **extra})


def k_warm_phase(root: str, ckpt: str) -> dict:
    """(k2) ``python -m dct_tpu_torch.serve`` over a checkpoint: process
    start to the banner, the first and the tenth request, with the warm
    start and without it (``serve.main(warm=False)``)."""
    out = {}
    x = _windows(np.random.default_rng(5), 1)
    for warm in (True, False):
        port = _free_port()
        name = "warm" if warm else "cold"
        proc = _Proc([sys.executable, "-c",
                      "import sys; from dct_tpu_torch import serve; "
                      f"sys.exit(serve.main(warm={warm}))"],
                     _serve_env(root, name, port, DCT_CKPT=ckpt,
                                DCT_METRICS_DIR=""),
                     os.path.join(root, f"{name}.log"))
        ready_s = proc.wait_for("serving ")
        lat = []
        for _ in range(10):
            status, payload, _, ms = _post_raw(port, x)
            if status != 200:
                proc.stop()
                raise AssertionError(f"(k2) {name}: {status} {payload}")
            lat.append(ms)
        rc = proc.terminate()
        line = proc.line("[serve] launches ")
        launches = json.loads(line.split(" ", 2)[2].replace("'", '"')) \
            if line else None
        want = SERVE_CFG["n_layers"] * (10 + warm)
        if rc != 0 or not launches or launches["flash_fwd"] != want:
            raise AssertionError(f"(k2) {name}: exit {rc}, launches "
                                 f"{launches}, want {want}")
        out[name] = {"start_to_ready_s": ready_s, "first_ms": lat[0],
                     "tenth_ms": lat[9], "median_ms": statistics.median(lat),
                     "launches": launches}
    print(f"[smoke] (k2) warm start {out}", flush=True)
    return out


def k_pool_phase(root: str, pkg: str) -> dict:
    """(k3) ``DCT_SERVE_PROCS`` 1 and 2: the heal drill (``crash_worker``
    on child 1) at 2, then the same closed-loop sweep on each, launches
    read off the fleet scrape, SIGTERM to exit 0; at 1 the sweep also runs
    at one window a request. (``scripts/serve_concurrency_compare.py``
    holds a server past concurrency 1 against the reference's.)"""
    from dct_tpu_torch.serving import loadgen

    body = json.dumps({"data": _windows(np.random.default_rng(9), 8).tolist()
                       }).encode()
    out = {}
    for procs in (1, 2):
        name = f"procs{procs}"
        port = _free_port()
        extra = dict(DCT_PACKAGE_DIR=pkg, DCT_SERVE_PROCS=str(procs),
                     DCT_SERVE_WORKERS="2")
        if procs == 2:
            extra.update(DCT_FAULT_SPEC="crash_worker@proc1:req2",
                         DCT_SERVE_MAX_RESTARTS="2")
        env = _serve_env(root, name, port, **extra)
        proc = _Proc([sys.executable, "-m", "dct_tpu_torch.serve"], env,
                     os.path.join(root, f"{name}.log"))
        try:
            proc.wait_for("serving ")
            x1 = _windows(np.random.default_rng(1), 1)
            deadline = time.perf_counter() + 240
            healed, answered = procs == 1, 0
            while time.perf_counter() < deadline:
                try:
                    status, payload, _, _ = _post_raw(port, x1)
                    answered += status == 200
                except OSError:  # not bound yet, or the torn connection
                    time.sleep(0.2)
                    continue
                names = [e["event"] for e in _events_of(env)]
                healed = healed or "serve.pool_respawn" in names
                if healed and answered >= 4 and (
                        procs == 1 or len(_procs(_scrape(port))) == procs):
                    break
            if not healed:
                raise AssertionError(f"(k3) {name}: no respawn")
            time.sleep(0.6)  # every child republished
            before = _scrape(port)
            sweep = loadgen.sweep_closed_loop(
                "127.0.0.1", port, body, levels=list(SWEEP_LEVELS),
                requests_per_level=SWEEP_REQUESTS, duration_s=60.0)
            time.sleep(0.6)
            after = _scrape(port)
            if procs == 1:
                # One window a request: an eighth of the body to parse.
                small = loadgen.sweep_closed_loop(
                    "127.0.0.1", port, json.dumps({"data": x1.tolist()}
                                                  ).encode(),
                    levels=[1, 4], requests_per_level=SWEEP_REQUESTS,
                    duration_s=60.0)
            launches = (_metric(after, "dct_kernel_launches",
                                'kernel="flash_fwd"')
                        - _metric(before, "dct_kernel_launches",
                                  'kernel="flash_fwd"'))
            flushes = (_metric(after, "dct_serve_batch_rows_count")
                       - _metric(before, "dct_serve_batch_rows_count"))
            seen = _procs(after)
            rc = proc.terminate()
        finally:
            proc.stop()
        events = _events_of(env)
        names = [e["event"] for e in events]
        errors = sum(r["errors"] for r in sweep["levels"])
        if (rc != 0 or errors or len(seen) != procs
                or launches != SERVE_CFG["n_layers"] * flushes):
            raise AssertionError(
                f"(k3) {name}: exit {rc}, {errors} errors, procs {seen}, "
                f"{launches} launches for {flushes} flushes")
        if procs == 2:
            death = [e for e in events
                     if e["event"] == "serve.pool_child_death"]
            if (not death or death[0]["index"] != 1
                    or names.index("serve.pool_child_death")
                    > names.index("serve.pool_respawn")):
                raise AssertionError(f"(k3) heal drill events {names}")
        out[name] = {
            "levels": [{k: r[k] for k in ("concurrency", "requests", "qps",
                                          "p50_ms", "p99_ms", "duration_s")}
                       for r in sweep["levels"]],
            "launches": launches, "flushes": flushes, "procs_seen": len(seen),
            "pool_events": [n for n in names if n.startswith("serve.pool")],
            "exit": rc}
        if procs == 1:
            out[name]["one_window_levels"] = [
                {k: r[k] for k in ("concurrency", "requests", "qps", "p50_ms",
                                   "p99_ms")} for r in small["levels"]]
    print(f"[smoke] (k3) pool {out}", flush=True)
    return out


def k_overload_phase(fa, root: str) -> dict:
    """(k4) ``slow_score`` with admission and the in-process autoscaler on:
    ``BURST_THREADS`` keep-alive senders of ``BURST_EACH`` one-window
    requests each (no retry); sheds come back 429 with ``Retry-After``;
    the shed counter and the capacity gauge on one scrape; the workers
    scale up and back; the admitted answers equal an unarmed server's bit
    for bit (one window a flush on both)."""
    import http.client

    from dct_tpu_torch.config import ServingConfig
    from dct_tpu_torch.resilience import faults
    from dct_tpu_torch.serving.package import load_package
    from dct_tpu_torch.serving.server import make_server_from_weights

    weights, meta = load_package(os.path.join(root, "f32"))
    armed = ServingConfig(max_batch=1, workers=1, admit=True,
                          admit_max_queue=4, admit_wait_ms=100.0,
                          retry_after_s=0.05, autoscale=True, scale_min=1,
                          scale_max=3, scale_poll_s=0.05, scale_up_queue=2,
                          scale_down_queue=0, scale_hysteresis=1,
                          scale_cooldown_s=0.2)
    faults.set_default(faults.FaultPlan.parse("slow_score:ms100"))
    server = make_server_from_weights(weights, meta, serving=armed,
                                      device=DEVICE)
    thread = _start(server)
    port = server.server_address[1]
    xs = _windows(np.random.default_rng(11), BURST_THREADS * BURST_EACH)
    results = [None] * len(xs)
    peak = [1]
    done = threading.Event()

    def watch():
        while not done.is_set():
            peak[0] = max(peak[0], server.batcher.workers)
            time.sleep(0.005)

    def sender(t):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        try:
            for i in range(t * BURST_EACH, (t + 1) * BURST_EACH):
                conn.request("POST", "/score", json.dumps(
                    {"data": xs[i:i + 1].tolist()}).encode(),
                    {"Content-Type": "application/json",
                     "x-dct-priority": "low"})
                resp = conn.getresponse()
                results[i] = (resp.status, json.loads(resp.read()),
                              dict(resp.getheaders()))
        finally:
            conn.close()

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    try:
        fa.reset_launches()
        forwards0 = server.scorer.forwards
        t0 = time.perf_counter()
        burst = [threading.Thread(target=sender, args=(t,))
                 for t in range(BURST_THREADS)]
        for t in burst:
            t.start()
        for t in burst:
            t.join(300)
        burst_s = time.perf_counter() - t0
        text = _scrape(port)
        launches = fa.launches
        forwards = server.scorer.forwards - forwards0
        deadline = time.perf_counter() + 20
        while server.batcher.workers > 1 and time.perf_counter() < deadline:
            time.sleep(0.05)
        settled = server.batcher.workers
    finally:
        done.set()
        faults.set_default(None)
        _stop(server, thread)
    shed = [r for r in results if r is not None and r[0] == 429]
    admitted = [(i, r) for i, r in enumerate(results)
                if r is not None and r[0] == 200]
    if (not shed or not admitted or len(shed) + len(admitted) != len(xs)
            or not all(r[2].get("Retry-After", "").isdigit() for r in shed)):
        raise AssertionError(f"(k4) statuses {[r and r[0] for r in results]}")
    shed_total = _metric(text, "dct_serve_shed_total", 'class="low"')
    gauge = _metric(text, "dct_serve_workers")
    if (shed_total != len(shed) or peak[0] < 2 or settled != 1
            or launches != SERVE_CFG["n_layers"] * forwards):
        raise AssertionError(f"(k4) shed {shed_total} vs {len(shed)}, workers "
                             f"peak {peak[0]} settled {settled}, {launches} "
                             f"launches for {forwards} forwards")
    plain = make_server_from_weights(weights, meta, device=DEVICE,
                                     serving=ServingConfig(max_batch=1,
                                                           workers=1))
    thread = _start(plain)
    try:
        for i, r in admitted:
            status, payload, _, _ = _post_raw(plain.server_address[1],
                                              xs[i:i + 1])
            if status != 200 or payload["probabilities"] != r[1][
                    "probabilities"]:
                raise AssertionError(f"(k4) admitted answer {i} differs from "
                                     "the unarmed server's")
    finally:
        _stop(plain, thread)
    out = {"requests": len(xs), "admitted": len(admitted),
           "shed": len(shed), "shed_rate": len(shed) / len(xs),
           "burst_s": burst_s,
           "retry_after_header_s": sorted({int(r[2]["Retry-After"])
                                           for r in shed}),
           "scrape_shed_total": shed_total, "scrape_workers_gauge": gauge,
           "workers_peak": peak[0], "workers_settled": settled,
           "launches": launches, "forwards": forwards,
           "admitted_bitwise_equal_unarmed": True}
    print(f"[smoke] (k4) overload {out}", flush=True)
    return out


def k_endpoint_phase(fa, root: str) -> dict:
    """(k5) two slots, the f32 package and its int8 twin, 50/50 with a
    mirror to the int8 slot: routing, ``?slot=`` pinning, per-slot
    counters, a stage flip written to the state JSON mid-serve."""
    from dct_tpu_torch.config import ServingConfig
    from dct_tpu_torch.deploy.local import LocalEndpointClient
    from dct_tpu_torch.serving.server import make_endpoint_server

    state = os.path.join(root, "endpoint_state.json")
    name = "k-endpoint"
    client = LocalEndpointClient(state_path=state)
    client.create_endpoint(name)
    client.deploy(name, "blue", os.path.join(root, "f32"))
    client.deploy(name, "green", os.path.join(root, "int8"))
    client.set_traffic(name, {"blue": 50, "green": 50})
    client.set_mirror_traffic(name, {"green": 100})
    server = make_endpoint_server(name, state_path=state, device=DEVICE,
                                  serving=ServingConfig(workers=2))
    thread = _start(server)
    port = server.server_address[1]
    x = _windows(np.random.default_rng(13), 1)

    def forwards():
        return sum(s.forwards for _, s in server.batcher._scorers.values())

    try:
        fa.reset_launches()
        f0 = forwards()
        routed = [_post_raw(port, x)[1]["slot"] for _ in range(16)]
        pinned = {slot: _post_raw(port, x, path=f"/score?slot={slot}")[1]
                  for slot in ("blue", "green")}
        LocalEndpointClient(state_path=state).set_traffic(
            name, {"blue": 0, "green": 100})
        flipped = [_post_raw(port, x)[1]["slot"] for _ in range(6)]
        time.sleep(0.5)  # the last mirror copies score after their replies
        text = _scrape(port)
        launches, n_fwd = fa.launches, forwards() - f0
    finally:
        _stop(server, thread)
    counts = {s: _metric(text, "dct_requests_total", f'slot="{s}"')
              for s in ("blue", "green")}
    pin_err = float(np.abs(np.asarray(pinned["blue"]["probabilities"])
                           - np.asarray(pinned["green"]["probabilities"])
                           ).max())
    mirrored = sum(1 for _ in open(state + "_mirror.jsonl"))
    if (set(routed) != {"blue", "green"} or set(flipped) != {"green"}
            or [p["slot"] for p in pinned.values()] != ["blue", "green"]
            or not pin_err <= PROB_BOUND or mirrored < 1
            or launches != SERVE_CFG["n_layers"] * n_fwd):
        raise AssertionError(f"(k5) routed {routed}, flipped {flipped}, "
                             f"pinned err {pin_err}, mirrored {mirrored}, "
                             f"{launches} launches for {n_fwd} forwards")
    out = {"routed": {s: routed.count(s) for s in ("blue", "green")},
           "after_flip": {s: flipped.count(s) for s in ("blue", "green")},
           "scrape_requests_by_slot": counts, "mirrored": mirrored,
           "pinned_blue_vs_green_max_abs": pin_err, "launches": launches,
           "forwards": n_fwd}
    print(f"[smoke] (k5) endpoint {out}", flush=True)
    return out



def _predict_line(line: str) -> dict:
    """``predict_job``'s ``scored`` line: windows, the scoring loop's
    seconds (``score_s``), the set-up's (``build_s``: the model built and
    its weights loaded), the first chunk's, the windows a second of the
    chunks after it, and the flash launches."""
    m = re.match(r"\[predict_job\] scored (\d+) in ([0-9.]+) s \(build "
                 r"([0-9.]+) s, first chunk ([0-9.]+) s, ([0-9.]+) windows/s "
                 r"after it; .*launches (\{.*\})", line)
    if not m:
        raise AssertionError(f"predict_job line not understood: {line}")
    return {"windows": int(m.group(1)), "score_s": float(m.group(2)),
            "build_s": float(m.group(3)), "first_chunk_s": float(m.group(4)),
            "steady_windows_per_s": float(m.group(5)),
            "launches": json.loads(m.group(6))}

def k_predict_phase(root: str, ckpt: str, processed: str) -> dict:
    """(k6) ``python -m dct_tpu_torch.predict_job`` on the card over (h)'s
    processed rows with (g)'s checkpoint, chunks of ``PREDICT_CHUNK``;
    the numpy engine on the first 16 windows of the first chunk."""
    from dct_tpu_torch import predict_job
    from dct_tpu_torch.data.dataset import load_processed_dataset
    from dct_tpu_torch.data.windows import make_windows
    from dct_tpu_torch.etl.parquet import read_table
    from dct_tpu_torch.serving.score_gen import weights_from_checkpoint

    out_path = os.path.join(root, "predictions.parquet")
    env = _child_env(DCT_CKPT=ckpt, DCT_PROCESSED_DIR=processed,
                     DCT_PREDICTIONS=out_path,
                     DCT_PREDICT_CHUNK=str(PREDICT_CHUNK))
    r = subprocess.run([sys.executable, "-m", "dct_tpu_torch.predict_job"],
                       env=env, cwd=HERE, capture_output=True, text=True,
                       timeout=600)
    line = [x for x in r.stdout.splitlines()
            if x.startswith("[predict_job] scored ")]
    if r.returncode != 0 or not line:
        raise AssertionError(f"(k6) exit {r.returncode}: {r.stderr[-2000:]}")
    job = _predict_line(line[-1])
    n, seconds, launches = job["windows"], job["score_s"], job["launches"]
    chunks = -(-n // PREDICT_CHUNK)
    table = read_table(out_path)
    probs = np.stack([table["prob_0"], table["prob_1"]], axis=1)
    weights, meta = weights_from_checkpoint(ckpt)
    windows = make_windows(load_processed_dataset(processed),
                           int(meta["seq_len"]))
    ref = predict_job.score(weights, meta, windows.features[:16], 16,
                            engine="numpy")
    err = float(np.abs(probs[:16] - ref).max())
    want = {"flash_fwd": SERVE_CFG["n_layers"] * chunks, "flash_bwd_dkdv": 0,
            "flash_bwd_dq": 0}
    if (launches != want or len(table["row"]) != n or not err <= 1e-4
            or not np.isfinite(probs).all()
            or np.abs(probs.sum(axis=1) - 1).max() > 1e-5):
        raise AssertionError(f"(k6) launches {launches} (want {want}), rows "
                             f"{len(table['row'])} of {n}, numpy err {err}")
    out = {"windows": n, "chunk": PREDICT_CHUNK, "chunks": chunks,
           "build_s": job["build_s"], "score_s": seconds,
           "windows_per_s": n / seconds,
           "steady_windows_per_s": job["steady_windows_per_s"],
           "launches": launches, "launches_per_chunk": launches["flash_fwd"]
           / chunks, "torch_vs_numpy_first16_max_abs": err,
           "columns": sorted(table)}
    print(f"[smoke] (k6) predict job {out}", flush=True)
    return out


def k_knobs_phase(fa, root: str) -> dict:
    """(k7) On the card a knob that would select a plain path raises,
    naming itself, and launches nothing: ``DCT_FLASH=off`` and a
    ``DCT_FLASH_BLOCK_Q`` that does not divide T stop the server at its
    warm start, before the port is bound. One train step under
    ``DCT_FLASH_BWD=remat`` launches its forwards and raises in the
    backward with no backward launch; the same step without the knob
    launches all three kernels on every layer."""
    from dct_tpu_torch.config import ServingConfig
    from dct_tpu_torch.serving.server import make_server
    from dct_tpu_torch.train import steps

    refusals = {}
    for name, key, value in (("flash_off", "DCT_FLASH", "off"),
                             ("blocks", "DCT_FLASH_BLOCK_Q", "96")):
        os.environ[key] = value
        fa.reset_launches()
        try:
            server = make_server(os.path.join(root, "f32"), device=DEVICE,
                                 serving=ServingConfig(workers=1))
            server.server_close()
            server.batcher.close()
            raise AssertionError(f"(k7) {key}={value}: the server started")
        except ValueError as e:
            msg = str(e)
        finally:
            del os.environ[key]
        if f"{key}=" not in msg or fa.launches != 0:
            raise AssertionError(f"(k7) {key}={value}: {fa.launches} "
                                 f"launches, error {msg!r}")
        refusals[name] = {"launches": fa.launches, "error": msg}
    (xs, ys, ws), _ = train_data("weather_transformer")
    state = train_state("weather_transformer", torch.float32, dropout=0.0)
    fa.reset_launches()
    steps.loss_and_grads(state, xs[0], ys[0], ws[0])
    _sync()
    kernel_counts = fa.launch_counts()
    os.environ["DCT_FLASH_BWD"] = "remat"
    try:
        fa.reset_launches()
        steps.loss_and_grads(state, xs[0], ys[0], ws[0])
        raise AssertionError("(k7) DCT_FLASH_BWD=remat: the backward ran")
    except ValueError as e:
        remat_msg = str(e)
    finally:
        del os.environ["DCT_FLASH_BWD"]
    _sync()
    remat_counts = fa.launch_counts()
    n = SERVE_CFG["n_layers"]
    if (remat_counts != {"flash_fwd": n, "flash_bwd_dkdv": 0,
                         "flash_bwd_dq": 0}
            or "DCT_FLASH_BWD=remat" not in remat_msg
            or kernel_counts != {"flash_fwd": n, "flash_bwd_dkdv": n,
                                 "flash_bwd_dq": n}):
        raise AssertionError(f"(k7) remat launches {remat_counts}, error "
                             f"{remat_msg!r}, kernel path {kernel_counts}")
    out = {"refusals": refusals,
           "remat": {"launches": remat_counts, "error": remat_msg,
                     "kernel_path_launches": kernel_counts}}
    print(f"[smoke] (k7) knobs {out}", flush=True)
    del state
    torch.cuda.empty_cache()
    return out


def serving_phase(fa, root: str, ckpt: str, processed: str,
                  card: str, counted=None) -> dict:
    """(k1)-(k7); each sub-phase's launches and wall. (k2), (k3) and
    (k6) drive child processes beside (k4), (k5) and (k7), which, as
    (k1), hold ``counted`` (as :func:`families_phase`)."""
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    phase_t0 = time.perf_counter()
    walls = {}
    counted = counted or threading.Lock()

    def timed(key, fn, *args, lock=None):
        with lock or contextlib.nullcontext():
            t0 = time.perf_counter()
            res = fn(*args)
            walls[key] = time.perf_counter() - t0
        return res

    k1 = timed("k1", k_int8_phase, fa, root, lock=counted)
    # The child-process drills (their launches are the children's) run
    # beside the in-process ones, which alone touch this process's counts.
    with ThreadPoolExecutor(3) as pool:
        children = [pool.submit(timed, "k2", k_warm_phase, root, ckpt),
                    pool.submit(timed, "k3", k_pool_phase, root,
                                os.path.join(root, "f32")),
                    pool.submit(timed, "k6", k_predict_phase, root, ckpt,
                                processed)]
        k4 = timed("k4", k_overload_phase, fa, root, lock=counted)
        k5 = timed("k5", k_endpoint_phase, fa, root, lock=counted)
        k7 = timed("k7", k_knobs_phase, fa, root, lock=counted)
        k2, k3, k6 = (c.result() for c in children)
    in_process = (k1["f32"]["launches"] + k1["int8"]["launches"]
                  + k1["mlp"]["launches"] + k4["launches"] + k5["launches"])
    children = (sum(v["launches"]["flash_fwd"] for v in k2.values())
                + int(sum(v["launches"] for v in k3.values())))
    out = {"k1": k1, "k2": k2, "k3": k3, "k4": k4, "k5": k5, "k6": k6,
           "k7": k7, "walls_s": walls,
           "launches": {"serve_k": in_process + children,
                        "serve_k_children": children,
                        "predict": k6["launches"]["flash_fwd"],
                        "knobs": {k: k7["remat"]["kernel_path_launches"][k]
                                  + k7["remat"]["launches"][k]
                                  for k in k7["remat"]["launches"]}},
           "phase_s": time.perf_counter() - phase_t0, "card": card}
    print(f"[smoke] (k) serving launches {out['launches']}, walls "
          f"{walls}, phase {out['phase_s']:.1f} s on {card}", flush=True)
    return out


# ------------------------------------------------------------------- (l)

# bench.py:998-1003: the MoE leg's width (32 experts, d_ff 1024, batch 8,
# bf16); dct_tpu/config.py:74-83: the repo's one GRU width.
MOE_CFG = dict(seq_len=512, d_model=512, n_heads=8, n_layers=2, d_ff=1024,
               n_experts=32)
MOE_BATCH = 8
GRU_CFG = dict(seq_len=32, hidden_dim=64, n_layers=2)
FAMILY_EPOCHS = 2  # train_job epochs over (h)'s rows in (l2)
FAMILY_BATCH = 32  # train_job's batch in (l2)
ENGINE_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# (l2)'s MoE predict: a full chunk and a partial one (the numpy engine
# checks each full chunk, some 25-30 s a chunk at this width).
MOE_PREDICT_ROWS = MOE_CFG["seq_len"] + PREDICT_CHUNK + 100


def moe_state(compute_dtype, *, engine="auto", top_k=1):
    """A full-width ``weather_moe`` train state on the card (seed 0,
    dropout 0): the same weights whatever the engine."""
    from dct_tpu_torch.config import ModelConfig
    from dct_tpu_torch.models.registry import get_model
    from dct_tpu_torch.train.state import create_train_state

    cfg = ModelConfig(name="weather_moe", dropout=0.0, moe_dispatch=engine,
                      router_top_k=top_k, **MOE_CFG)
    model = get_model(cfg, input_dim=5, device=DEVICE,
                      compute_dtype=compute_dtype)
    return create_train_state(model, input_dim=5, lr=1e-3, seed=0,
                              example_shape=(1, MOE_CFG["seq_len"], 5))


def moe_batch(seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((MOE_BATCH, MOE_CFG["seq_len"], 5)).astype(
        np.float32)
    y = rng.integers(0, 2, MOE_BATCH).astype(np.int32)
    return x, y, np.ones(MOE_BATCH, np.float32)


def _rel_err(a, b) -> float:
    scale = b.float().abs().max().item()
    return (a.float() - b.float()).abs().max().item() / max(scale, 1e-30)


def _router_hooks(model, logits: list, pin=None) -> list:
    """Forward hooks on every MoE layer's router that append its logits
    to ``logits``; with ``pin`` (an earlier run's logits), each layer's
    logits take the pinned values (their gradient still flows through the
    router), so routing and gates are the pinned run's."""
    handles = []
    for i, block in enumerate(model.blocks()):
        def hook(mod, inputs, out, i=i):
            logits.append(out.detach())
            if pin is not None:
                return out + (pin[i] - out).detach()
        handles.append(block.moe.router.register_forward_hook(hook))
    return handles


def _routed(state, x, y, w, logits: list, pin=None):
    """``steps.loss_and_grads`` with the routers' logits recorded (and
    pinned, with ``pin``)."""
    from dct_tpu_torch.train import steps

    handles = _router_hooks(state.model, logits, pin)
    try:
        return steps.loss_and_grads(state, x, y, w)
    finally:
        for h in handles:
            h.remove()


def worst_leaf(names, ga, gb) -> tuple[str, float]:
    """The parameter whose gradient differs most, relative to its max."""
    errs = [(_rel_err(a, b), n) for n, a, b in zip(names, ga, gb)]
    err, name = max(errs)
    return name, err


def moe_train_phase(fa) -> dict:
    """(l1): the MoE at the bench's width on the card: one train body with
    the kernels against plain attention, the two engines on the same
    weights (f32 and bf16, top-1 and top-2), and the step time of each."""
    from dct_tpu_torch.train import steps

    n_layers = MOE_CFG["n_layers"]
    per_step = {"flash_fwd": n_layers, "flash_bwd_dkdv": n_layers,
                "flash_bwd_dq": n_layers}
    x, y, w = moe_batch(0)
    out = {}

    kern = moe_state(torch.bfloat16)
    plain = moe_state(torch.bfloat16)
    names = [n for n, _ in kern.model.named_parameters()]
    for block in plain.model.blocks():
        block.attn.attn_fn = lambda q, k, v: PlainAttention.apply(q, k, v,
                                                                  False)
    route_k, route_p = [], []
    fa.reset_launches()
    loss_k, grads_k = _routed(kern, x, y, w, route_k)
    torch.cuda.synchronize()
    counts = fa.launch_counts()
    if counts != per_step:
        raise AssertionError(f"(l1) launches {counts}, want {per_step}")
    # auto at this width: k*N*E*C = 4096*32*160 >= 2^21, so sorted.
    want_engine = kern.model.block_0.moe.engine_for(
        MOE_BATCH * MOE_CFG["seq_len"])
    engines = [b.moe.last_engine for b in kern.model.blocks()]
    if engines != [want_engine] * n_layers:
        raise AssertionError(f"(l1) auto picked {engines}, want "
                             f"{want_engine}")
    loss_p, grads_p = _routed(plain, x, y, w, route_p)
    loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    if not loss_err <= TOL[torch.bfloat16]:
        raise AssertionError(f"(l1) loss {loss_k.item()} vs plain "
                             f"{loss_p.item()}")
    # Tokens whose first choice differs between the two runs (a routing
    # tie that attention's rounding tipped) move whole expert gradients;
    # where any did, the plain run is repeated with the kernel run's
    # routing pinned, so the gradient check sees the attention alone.
    flips = [int((a.argmax(-1) != b.argmax(-1)).sum())
             for a, b in zip(route_k, route_p)]
    unpinned = None
    if any(flips):
        unpinned = worst_leaf(names, grads_k, grads_p)
        del grads_p
        loss_p, grads_p = _routed(plain, x, y, w, [], pin=route_k)
    if fa.launch_counts() != counts:
        raise AssertionError("(l1) the plain path launched a kernel")
    leaf = worst_leaf(names, grads_k, grads_p)
    print(f"[smoke] (l1) routing flips per layer {flips} of "
          f"{route_k[0].shape[0]} tokens, pinned {unpinned is not None} "
          f"(unpinned worst leaf {unpinned}); worst leaf {leaf}", flush=True)
    out["kernels_vs_plain"] = {
        "loss": loss_k.item(), "aux": kern.model.aux_loss().item(),
        "loss_rel_err": loss_err, "engines": engines,
        "routing_flips_per_layer": flips,
        "tokens_per_layer": int(route_k[0].shape[0]),
        "unpinned_worst_leaf": unpinned, "pinned": unpinned is not None,
        "grad_rel_err": grads_close(grads_k, grads_p, TOL[torch.bfloat16]),
        "worst_leaf": leaf[0], "tol": TOL[torch.bfloat16],
        "launches": counts}
    print(f"[smoke] (l1) moe kernels vs plain {out['kernels_vs_plain']}",
          flush=True)
    del kern, plain, grads_k, grads_p

    agree = []
    for dtype in (torch.float32, torch.bfloat16):
        for top_k in (1, 2):
            runs = {}
            for engine in ("sorted", "einsum"):
                st = moe_state(dtype, engine=engine, top_k=top_k)
                loss, grads = steps.loss_and_grads(st, x, y, w)
                st.model.eval()
                with torch.no_grad():
                    logits = st.model(torch.as_tensor(x, device=DEVICE))
                runs[engine] = (loss, grads, logits)
                del st
            (ls, gs, os_), (le, ge, oe) = runs["sorted"], runs["einsum"]
            tol = ENGINE_TOL[dtype]
            row = {"dtype": str(dtype).replace("torch.", ""), "top_k": top_k,
                   "loss_rel_err": abs(ls.item() - le.item()) / abs(le.item()),
                   "logits_rel_err": _rel_err(os_, oe),
                   "grad_rel_err": grads_close(gs, ge, tol), "tol": tol}
            if not (row["loss_rel_err"] <= tol and row["logits_rel_err"] <= tol):
                raise AssertionError(f"(l1) engines disagree {row}")
            agree.append(row)
            print(f"[smoke] (l1) sorted vs einsum {row}", flush=True)
            del runs, gs, ge
    out["engines_agree"] = agree

    step = steps.make_train_step()
    times, launches = {}, dict.fromkeys(per_step, 0)
    for engine in ("sorted", "einsum"):
        st = moe_state(torch.bfloat16, engine=engine)
        dev = [torch.as_tensor(a, device=DEVICE) for a in (x, y, w)]
        step(st, *dev)  # warm-up
        torch.cuda.synchronize()
        fa.reset_launches()
        ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            st, metrics = step(st, *dev)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        counts = fa.launch_counts()
        if counts != {k: 5 * v for k, v in per_step.items()}:
            raise AssertionError(f"(l1) {engine} steps launched {counts}")
        if not bool(torch.isfinite(metrics["train_loss"])):
            raise AssertionError(f"(l1) {engine}: non-finite loss")
        for k, v in counts.items():
            launches[k] += v
        times[engine] = statistics.median(ms)
        del st
    out.update(sorted_ms=times["sorted"], einsum_ms=times["einsum"],
               sorted_speedup=times["einsum"] / times["sorted"],
               launches=launches)
    print(f"[smoke] (l1) moe step (bf16, batch {MOE_BATCH}, median of 5): "
          f"sorted {times['sorted']:.3f} ms, einsum {times['einsum']:.3f} "
          f"ms, sorted_speedup {out['sorted_speedup']:.3f}", flush=True)
    return out


def _family_env(family: str) -> dict:
    if family == "weather_moe":
        cfg = {"DCT_MODEL": family, "DCT_SEQ_LEN": MOE_CFG["seq_len"],
               "DCT_D_MODEL": MOE_CFG["d_model"],
               "DCT_N_HEADS": MOE_CFG["n_heads"],
               "DCT_N_LAYERS": MOE_CFG["n_layers"],
               "DCT_D_FF": MOE_CFG["d_ff"],
               "DCT_N_EXPERTS": MOE_CFG["n_experts"],
               "DCT_BF16_COMPUTE": 1}
    else:
        cfg = {"DCT_MODEL": family, "DCT_SEQ_LEN": GRU_CFG["seq_len"],
               "DCT_HIDDEN_DIM": GRU_CFG["hidden_dim"],
               "DCT_N_LAYERS": GRU_CFG["n_layers"], "DCT_BF16_COMPUTE": 0}
    return {k: str(v) for k, v in cfg.items()}


def _family_launches(family: str, processed: str, epochs: int) -> dict:
    """Forward launches per train step and eval batch and one dK/dV and
    one dQ per train step, per layer, for the MoE; none for the GRU."""
    from dct_tpu_torch.data.dataset import load_processed_dataset
    from dct_tpu_torch.data.pipeline import BatchLoader, contiguous_split
    from dct_tpu_torch.data.windows import make_windows

    if family != "weather_moe":
        return {"flash_fwd": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
    seq = MOE_CFG["seq_len"]
    windows = make_windows(load_processed_dataset(processed), seq)
    train_idx, val_idx = contiguous_split(len(windows), val_fraction=0.2,
                                          gap=seq)
    n_train = BatchLoader(windows, train_idx, global_batch=FAMILY_BATCH,
                          shuffle=True).num_batches
    n_val = BatchLoader(windows, val_idx, global_batch=FAMILY_BATCH,
                        shuffle=False).num_batches
    n = MOE_CFG["n_layers"] * epochs
    return {"flash_fwd": n * (n_train + n_val),
            "flash_bwd_dkdv": n * n_train, "flash_bwd_dq": n * n_train}


def family_train_job(family: str, root: str, processed: str) -> dict:
    """(l2) ``python -m dct_tpu_torch.train_job`` for ``family`` on the
    card over ``processed``: exit 0, a finite val_loss, a checkpoint, and
    the flash launches of every step and eval batch."""
    models = os.path.join(root, f"models-{family}")
    env = _child_env(DCT_PROCESSED_DIR=processed, DCT_MODELS_DIR=models,
                     DCT_TRACKING_DIR=os.path.join(root, "mlruns"),
                     DCT_EPOCHS=str(FAMILY_EPOCHS),
                     DCT_BATCH_SIZE=str(FAMILY_BATCH), **_family_env(family))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "dct_tpu_torch.train_job"],
                       env=env, cwd=HERE, capture_output=True, text=True,
                       timeout=900)
    wall = time.perf_counter() - t0
    done = [x for x in r.stdout.splitlines() if "done: val_loss=" in x]
    if r.returncode != 0 or not done:
        raise AssertionError(f"(l2) {family} train_job exit {r.returncode}: "
                             f"{r.stderr[-2000:]}")
    fields = dict(kv.split("=", 1) for kv in done[-1].split("done: ")[1]
                  .split() if "=" in kv)
    want = _family_launches(family, processed, FAMILY_EPOCHS)
    launches = _child_launches(r.stdout, [want], f"l2 {family}")
    ckpt = os.path.join(models, "last.ckpt")
    val_loss = float(fields["val_loss"])
    if not (np.isfinite(val_loss) and os.path.exists(ckpt)):
        raise AssertionError(f"(l2) {family}: val_loss {val_loss}, "
                             f"checkpoint {os.path.exists(ckpt)}")
    out = {"family": family, "wall_s": wall, "val_loss": val_loss,
           "val_acc": float(fields["val_acc"]),
           "samples_per_s": float(fields["samples/sec"]),
           "launches": launches, "ckpt": ckpt}
    print(f"[smoke] (l2) train_job {out}", flush=True)
    return out


def family_serve(fa, family: str, ckpt: str, root: str) -> dict:
    """(l2) the port's package of ``ckpt`` through the HTTP server (torch
    engine) on the card: 1, 3 and 8 windows against the numpy runtime
    (1e-4); the MoE launches one forward per layer per request (a request
    is its own segment), the GRU none."""
    from dct_tpu_torch.config import ServingConfig
    from dct_tpu_torch.serving.numpy_runtime import forward_numpy, softmax_numpy
    from dct_tpu_torch.serving.score_gen import generate_score_package
    from dct_tpu_torch.serving.package import load_package
    from dct_tpu_torch.serving.server import make_server

    pkg = os.path.join(root, f"pkg-{family}")
    generate_score_package(ckpt, pkg)
    weights, meta = load_package(pkg)
    server = make_server(pkg, serving=ServingConfig(workers=1),
                         device=None if DEVICE == "cuda" else DEVICE)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    rng = np.random.default_rng(3)
    per_request = (MOE_CFG["n_layers"] if family == "weather_moe" else 0)
    rows, launches = [], 0
    try:
        port = server.server_address[1]
        for n in (1, 3, 8):
            x = rng.standard_normal((n, int(meta["seq_len"]), 5)).astype(
                np.float32)
            fa.reset_launches()
            probs, ms = post(port, x)
            got = fa.launches
            want = softmax_numpy(forward_numpy(weights, meta, x))
            gap = np.abs(probs - want)
            err = float(gap.max())
            if got != per_request or not err <= AGREE_TOL:
                raise AssertionError(f"(l2) {family} serve {n}: launches "
                                     f"{got} (want {per_request}), numpy "
                                     f"err {err}")
            launches += got
            rows.append({"windows": n, "ms": ms, "numpy_max_abs_err": err,
                         "worst_window": int(gap.max(axis=-1).argmax())})
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)
    out = {"family": family, "requests": rows, "launches": launches}
    print(f"[smoke] (l2) serve {out}", flush=True)
    return out


def family_predict(family: str, ckpt: str, processed: str,
                   root: str) -> dict:
    """(l2) ``python -m dct_tpu_torch.predict_job`` on the card, chunks of
    ``PREDICT_CHUNK``: windows/s, the flash launches (one a layer a chunk
    for the MoE), and every full chunk within 1e-4 of the numpy engine on
    that chunk (the MoE's partial last chunk is padded as the reference's
    accelerator engine pads it, which the numpy engine does not)."""
    from dct_tpu_torch import predict_job
    from dct_tpu_torch.data.dataset import load_processed_dataset
    from dct_tpu_torch.data.windows import make_windows
    from dct_tpu_torch.etl.parquet import read_table
    from dct_tpu_torch.serving.score_gen import weights_from_checkpoint

    out_path = os.path.join(root, f"predictions-{family}.parquet")
    env = _child_env(DCT_CKPT=ckpt, DCT_PROCESSED_DIR=processed,
                     DCT_PREDICTIONS=out_path,
                     DCT_PREDICT_CHUNK=str(PREDICT_CHUNK))
    r = subprocess.run([sys.executable, "-m", "dct_tpu_torch.predict_job"],
                       env=env, cwd=HERE, capture_output=True, text=True,
                       timeout=600)
    line = [x for x in r.stdout.splitlines()
            if x.startswith("[predict_job] scored ")]
    if r.returncode != 0 or not line:
        raise AssertionError(f"(l2) {family} predict exit {r.returncode}: "
                             f"{r.stderr[-2000:]}")
    job = _predict_line(line[-1])
    n, seconds, launches = job["windows"], job["score_s"], job["launches"]
    chunks = -(-n // PREDICT_CHUNK)
    table = read_table(out_path)
    probs = np.stack([table["prob_0"], table["prob_1"]], axis=1)
    weights, meta = weights_from_checkpoint(ckpt)
    windows = make_windows(load_processed_dataset(processed),
                           int(meta["seq_len"])).features
    full = (n // PREDICT_CHUNK) * PREDICT_CHUNK
    err, worst_row = 0.0, -1
    for start in range(0, full, PREDICT_CHUNK):
        ref = predict_job.score(weights, meta,
                                windows[start:start + PREDICT_CHUNK],
                                PREDICT_CHUNK, engine="numpy")
        gap = np.abs(probs[start:start + PREDICT_CHUNK] - ref).max(axis=-1)
        if gap.max() > err:
            err, worst_row = float(gap.max()), start + int(gap.argmax())
    per_chunk = MOE_CFG["n_layers"] if family == "weather_moe" else 0
    want = {"flash_fwd": per_chunk * chunks, "flash_bwd_dkdv": 0,
            "flash_bwd_dq": 0}
    if (launches != want or len(table["row"]) != n or not err <= AGREE_TOL
            or not np.isfinite(probs).all()):
        raise AssertionError(f"(l2) {family} predict launches {launches} "
                             f"(want {want}), rows {len(table['row'])} of "
                             f"{n}, numpy err {err}")
    out = {"family": family, "windows": n, "chunk": PREDICT_CHUNK,
           "chunks": chunks, "full_chunks_checked": full // PREDICT_CHUNK,
           "build_s": job["build_s"], "score_s": seconds,
           "windows_per_s": n / seconds,
           "steady_windows_per_s": job["steady_windows_per_s"],
           "launches": launches, "numpy_max_abs_err": err,
           "worst_row": worst_row}
    print(f"[smoke] (l2) predict job {out}", flush=True)
    return out


def families_phase(fa, root: str, processed: str, card: str,
                   counted=None) -> dict:
    """(l1) and (l2); each sub-phase's launches and wall. The two
    families' (l2) chains run beside (l1). ``counted``: the lock every
    phase that reads this process's launch counts holds (one of its
    own by default)."""
    from dct_tpu_torch.data.synthetic import generate_weather_csv
    from dct_tpu_torch.etl.preprocess import preprocess_csv_to_parquet

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    phase_t0 = time.perf_counter()
    walls = {}
    raw = os.path.join(root, "predict-raw.csv")
    generate_weather_csv(raw, rows=MOE_PREDICT_ROWS, seed=2)
    moe_rows = os.path.join(root, "predict-processed")
    preprocess_csv_to_parquet(raw, moe_rows)
    # The in-process work (l1, each family's server) reads this process's
    # launch counts: one at a time.
    counted = counted or threading.Lock()

    def family_chain(family):
        t0 = time.perf_counter()
        trained = family_train_job(family, root, processed)
        with counted:
            served = family_serve(fa, family, trained["ckpt"], root)
        predicted = family_predict(
            family, trained["ckpt"],
            moe_rows if family == "weather_moe" else processed, root)
        walls[f"l2_{family}"] = time.perf_counter() - t0
        return {"train_job": trained, "serve": served, "predict": predicted}

    families = ("weather_moe", "weather_gru")
    with ThreadPoolExecutor(len(families)) as pool:
        chains = [pool.submit(family_chain, f) for f in families]
        with counted:
            t0 = time.perf_counter()
            l1 = moe_train_phase(fa)
            walls["l1"] = time.perf_counter() - t0
        l2 = {f: c.result() for f, c in zip(families, chains)}
    moe = l2["weather_moe"]
    launches = {k: (l1["launches"][k] + moe["train_job"]["launches"][k]
                    + moe["predict"]["launches"][k])
                for k in l1["launches"]}
    launches["flash_fwd"] += moe["serve"]["launches"]
    out = {"l1": l1, "l2": l2, "launches": launches, "walls_s": walls,
           "phase_s": time.perf_counter() - phase_t0, "card": card}
    print(f"[smoke] (l) families launches {launches}, walls {walls}, phase "
          f"{out['phase_s']:.1f} s on {card}", flush=True)
    return out


def serving_probe(root: str) -> tuple[str, str]:
    """A random full-width checkpoint and a processed dir of LOOP_ROWS
    synthetic rows, for ``--phase k`` (the whole script uses (g)'s
    checkpoint and (h)'s rows)."""
    from dct_tpu_torch.checkpoint.manager import save_checkpoint
    from dct_tpu_torch.models.registry import config_from_meta, get_model

    os.makedirs(root, exist_ok=True)
    torch.manual_seed(0)
    ckpt = save_checkpoint(os.path.join(root, "last.ckpt"), get_model(
        config_from_meta(K_META), device="cpu"), K_META)
    return ckpt, synthetic_rows(root)


def synthetic_rows(root: str) -> str:
    """A processed dir of LOOP_ROWS synthetic rows (seed 1, the rows of
    (h1)'s first cycle) under ``root``."""
    from dct_tpu_torch.data.synthetic import generate_weather_csv
    from dct_tpu_torch.etl.preprocess import preprocess_csv_to_parquet

    raw = os.path.join(root, "raw", "weather.csv")
    generate_weather_csv(raw, rows=LOOP_ROWS, seed=1)
    processed = os.path.join(root, "processed")
    preprocess_csv_to_parquet(raw, processed)
    return processed


# (m) the model axis: one process per card, NCCL, through train_job.
MESH_CFG = dict(SERVE_CFG)  # bench.py:216-227's width
MESH_ROWS = 2624  # 1600 windows of 1024: 400 train, 176 val (fraction 0.75)
MESH_VAL_FRACTION = 0.75
MESH_BATCH = 16  # global batch: 25 train steps, 11 eval batches an epoch
MESH_EPOCHS = 2
MESH_LR = 0.01  # SGD with momentum 0.9: Adam's first update is about
MESH_MOMENTUM = 0.9  # lr * sign(g), which parts two runs on rounding alone
MESH_MOE_CAPACITY = 8.0  # ample, as the reference's drill
MESH_TOL = {"0": 1e-5, "1": 2e-2}  # |val_loss - W=1's|, f32 and bf16
MESH_REPLICATE_UNITS = "(qkv_proj|o_proj|ffn_in|ffn_out).*="


def _mesh_env(root: str, name: str, processed: str, *, family: str,
              bf16: bool, data: int, model: int, batch: int,
              epochs: int = MESH_EPOCHS, **extra) -> dict:
    """A train_job rank's environment on (m)'s rows and schedule at the
    bench's width; ``extra`` overrides (the GRU's width, an engine)."""
    env = _child_env(
        DCT_PROCESSED_DIR=processed,
        DCT_MODELS_DIR=os.path.join(root, f"models-{name}"),
        DCT_TRACKING_DIR=os.path.join(root, "mlruns"),
        DCT_MODEL=family, DCT_SEQ_LEN=str(MESH_CFG["seq_len"]),
        DCT_D_MODEL=str(MESH_CFG["d_model"]),
        DCT_N_HEADS=str(MESH_CFG["n_heads"]),
        DCT_N_LAYERS=str(MESH_CFG["n_layers"]),
        DCT_D_FF=str(MESH_CFG["d_ff"]), DCT_EPOCHS=str(epochs),
        DCT_BATCH_SIZE=str(batch), DCT_BF16_COMPUTE="1" if bf16 else "0",
        DCT_OPTIMIZER="sgd", DCT_LR=str(MESH_LR),
        DCT_MOMENTUM=str(MESH_MOMENTUM),
        DCT_VAL_FRACTION=str(MESH_VAL_FRACTION),
        DCT_MESH_DATA=str(data), DCT_MESH_MODEL=str(model))
    if family == "weather_moe":
        env.update(DCT_MOE_DISPATCH="sorted",
                   DCT_CAPACITY_FACTOR=str(MESH_MOE_CAPACITY))
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _start_world(root: str, name: str, processed: str, *,
                 world: int | None = None, **kw) -> dict:
    """Start one world of train_job ranks (rank r on cuda:r, NCCL; the
    ranks' world is ``data x model`` unless ``world`` says otherwise)."""
    world = world or kw["data"] * kw["model"]
    port = _free_port()
    procs = []
    for r in range(world):
        env = _mesh_env(root, name, processed, **kw)
        if world > 1:
            env.update(WORLD_SIZE=str(world), NODE_RANK=str(r),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dct_tpu_torch.train_job"], env=env,
            cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    return {"name": name, "world": world, "procs": procs,
            "t0": time.perf_counter(),
            "models": os.path.join(root, f"models-{name}"),
            "global_batch": kw["batch"] * kw["data"]}


def _finish_world(started: dict, timeout: float = 600) -> dict:
    """Wait for a started world (``timeout`` seconds a rank); each rank's
    fit line, launches and stdout."""
    procs, name = started.pop("procs"), started["name"]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - started.pop("t0")
    ranks = []
    for r, (rc, out, err) in enumerate(outs):
        if rc != 0:
            raise AssertionError(f"{name} rank {r} exit {rc}: "
                                 f"{err[-3000:]}")
        fit = json.loads([x for x in out.splitlines()
                          if x.startswith("[train_job] fit ")][-1][16:])
        fit["launches"] = json.loads([x for x in out.splitlines() if
                                      x.startswith("[train_job] launches ")]
                                     [-1][21:])
        pipe = [x for x in out.splitlines()
                if x.startswith("[train_job] pipeline ")]
        if pipe:
            fit["pipeline"] = json.loads(pipe[-1][21:])
        ranks.append(fit)
    return dict(started, wall_s=wall, ranks=ranks)


def _mesh_world(root: str, name: str, processed: str, **kw) -> dict:
    """One world of train_job ranks, run to its end."""
    return _finish_world(_start_world(root, name, processed, **kw))


def _mesh_summary(run: dict, base: dict | None = None) -> dict:
    r0 = run["ranks"][0]
    out = {"val_loss": r0["val_loss"],
           "samples_per_s": r0["samples_per_sec"],
           "steady_samples_per_s": r0["steady_samples_per_sec"],
           "step_ms": 1e3 * run["global_batch"] / r0["steady_samples_per_sec"],
           "max_memory_allocated": [r.get("max_memory_allocated")
                                    for r in run["ranks"]],
           "param_bytes": [r["param_bytes"] for r in run["ranks"]],
           "opt_bytes": [r["opt_bytes"] for r in run["ranks"]],
           "launches": [r["launches"] for r in run["ranks"]],
           "local_heads": r0.get("local_heads"), "wall_s": run["wall_s"]}
    if base is not None:
        out["val_loss_diff"] = abs(r0["val_loss"] - base["ranks"][0][
            "val_loss"])
    return out


def _check_mesh_run(run: dict, base: dict, tol: float, *, heads=None,
                    where: str, tag: str = "(m)") -> dict:
    """Every rank ends on the same val_loss, within ``tol`` of the W=1 run
    at the same global batch; every rank launched the W=1 run's kernels
    (the same steps and eval batches, each layer once), at ``heads``."""
    summary = _mesh_summary(run, base)
    losses = {r["val_loss"] for r in run["ranks"]}
    want = base["ranks"][0]["launches"]
    if DEVICE == "cuda" and not all(want.values()):
        raise AssertionError(f"{tag} {where}: the W=1 run launched {want}")
    bad = [r["launches"] for r in run["ranks"] if r["launches"] != want]
    if len(losses) != 1 or summary["val_loss_diff"] > tol or bad:
        raise AssertionError(f"{tag} {where}: val_losses {losses} against "
                             f"{base['ranks'][0]['val_loss']} (tol {tol}), "
                             f"launches {bad} against {want}")
    if heads is not None and any(r["local_heads"] != heads
                                 for r in run["ranks"]):
        raise AssertionError(f"{tag} {where}: local heads "
                             f"{[r['local_heads'] for r in run['ranks']]}"
                             f" against {heads}")
    print(f"[smoke] {tag} {where}: {json.dumps(summary)}", flush=True)
    return summary


def _rank_shape_row(fa, gen, shape, dtype, *, g_lse: bool, where: str):
    """The three kernels against their plain versions at one per-rank
    shape ``[B, H, T, D]`` (q, k, v alike), not causal, with a nonzero
    lse cotangent in the backward when ``g_lse`` (a ring step's merge),
    held to FWD_TOL and BWD_TOL; the row, printed under ``where``."""
    b, h, t, d = shape
    q, k, v, do = (torch.randn(b, h, t, d, generator=gen,
                               device="cuda").to(dtype) for _ in range(4))
    gl = (torch.randn(b, h, t, generator=gen, device="cuda") if g_lse
          else None)
    o, lse = fa.flash_attention(q, k, v, causal=False, return_lse=True)
    args = (q, k, v, o, lse, do)
    dk, dv = fa.flash_bwd_dkdv(*args, causal=False, g_lse=gl)
    dq = fa.flash_bwd_dq(*args, causal=False, g_lse=gl)
    torch.cuda.synchronize()
    po, plse = fa.flash_attention_plain(q, k, v, causal=False)
    pdq, pdk, pdv = fa.flash_attention_bwd_plain(*args, causal=False,
                                                 g_lse=gl)
    row = {"shape": [b, h, t, d], "dtype": str(dtype).replace("torch.", ""),
           "g_lse": g_lse, "o_max_abs_err": abs_rel_err(o, po)[0],
           "lse_max_abs_err": (lse - plse).abs().max().item(),
           **{f"{n}_max_rel_err": abs_rel_err(got, ref)[1]
              for n, got, ref in (("dq", dq, pdq), ("dk", dk, pdk),
                                  ("dv", dv, pdv))}}
    bad = (row["o_max_abs_err"] > FWD_TOL[dtype]
           or row["lse_max_abs_err"] > 1e-4
           or any(row[f"{n}_max_rel_err"] > BWD_TOL[dtype]
                  for n in ("dq", "dk", "dv")))
    if bad:
        raise AssertionError(
            f"{where} kernels at the per-rank shape: {row} (tol "
            f"{FWD_TOL[dtype]} on o, 1e-4 on lse, {BWD_TOL[dtype]} "
            "relative on dq, dk, dv)")
    print(f"[smoke] {where} rank shape {json.dumps(row)}", flush=True)
    return row


def check_rank_shapes(fa) -> list[dict]:
    """The three kernels against their plain versions, on one card, at the
    per-rank shapes ``[B/D, H/M, T, D]`` that (m)'s worlds launch them at
    (every step and eval batch): ``[16, 4]`` at ``model=2``, ``[8, 4]`` at
    ``data=2, model=2``, ``[16, 2]`` at the MoE's ``model=4``; f32 and
    bf16, not causal, with FWD_TOL and BWD_TOL."""
    h, t = MESH_CFG["n_heads"], MESH_CFG["seq_len"]
    d = MESH_CFG["d_model"] // h
    gen = torch.Generator(device="cuda").manual_seed(12)
    return [_rank_shape_row(fa, gen, (b, hl, t, d), dtype, g_lse=False,
                            where="(m)")
            for b, hl in ((MESH_BATCH, h // 2), (MESH_BATCH // 2, h // 2),
                          (MESH_BATCH, h // 4))
            for dtype in (torch.float32, torch.bfloat16)]


def model_axis_phase(root: str, card: str) -> dict:
    """(m) The model axis on two or more cards (module docstring); one
    line saying it did not run on fewer. The kernels' check at the
    per-rank shapes needs one card and runs on any."""
    from dct_tpu_torch.checkpoint.manager import load_checkpoint
    from dct_tpu_torch.data.synthetic import generate_weather_csv
    from dct_tpu_torch.etl.preprocess import preprocess_csv_to_parquet
    from dct_tpu_torch.ops import flash_attention as fa

    rank_shapes = check_rank_shapes(fa)
    cards = torch.cuda.device_count()
    zero = {"flash_fwd": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
    if cards < 2:
        print(json.dumps({"phase": "m", "ran": False, "cards": cards}),
              flush=True)
        return {"ran": False, "launches": zero, "rank_shapes": rank_shapes}
    t_phase = time.perf_counter()
    shutil.rmtree(root, ignore_errors=True)
    raw = os.path.join(root, "raw", "weather.csv")
    generate_weather_csv(raw, rows=MESH_ROWS, seed=12)
    processed = os.path.join(root, "processed")
    preprocess_csv_to_parquet(raw, processed)
    h = MESH_CFG["n_heads"]
    out = {"ran": True, "cards": cards, "card": card,
           "rank_shapes": rank_shapes, "m1": {}, "m2": {}, "m3": {},
           "m4": {}}
    runs = []

    def world(name, **kw):
        run = _mesh_world(root, name, processed, **kw)
        runs.append(run)
        return run

    tf = "weather_transformer"
    # (m1) tensor parallelism, f32 and bf16, against W=1.
    for bf16 in (False, True):
        tag = "bf16" if bf16 else "f32"
        base = world(f"m1-{tag}-w1", family=tf, bf16=bf16, data=1, model=1,
                     batch=MESH_BATCH)
        out["m1"][f"{tag}_w1"] = _mesh_summary(base)
        meshes = [(1, 2)] + ([(2, 2)] if cards >= 4 else [])
        for d, m in meshes:
            run = world(f"m1-{tag}-d{d}m{m}", family=tf, bf16=bf16, data=d,
                        model=m, batch=MESH_BATCH // d)
            out["m1"][f"{tag}_d{d}m{m}"] = _check_mesh_run(
                run, base, MESH_TOL["1" if bf16 else "0"],
                heads=[h // m, h // m], where=f"m1 {tag} data={d} model={m}")
            best = [n for n in os.listdir(run["models"])
                    if n.startswith("weather-best-")]
            params, _ = load_checkpoint(os.path.join(run["models"], best[0]))
            qkv = params["params"]["block_0"]["attn"]["qkv_proj"]["kernel"]
            want = (MESH_CFG["d_model"], 3 * MESH_CFG["d_model"])
            if tuple(qkv.shape) != want:
                raise AssertionError(f"(m1) best checkpoint's qkv kernel "
                                     f"{qkv.shape}, not dense {want}")
    # (m2) expert parallelism: the sorted engine, ample capacity.
    base = world("m2-w1", family="weather_moe", bf16=False, data=1, model=1,
                 batch=MESH_BATCH)
    out["m2"]["w1"] = _mesh_summary(base)
    for m in [2] + ([4] if cards >= 4 else []):
        run = world(f"m2-model{m}", family="weather_moe", bf16=False,
                    data=1, model=m, batch=MESH_BATCH)
        out["m2"][f"model{m}"] = _check_mesh_run(
            run, base, MESH_TOL["0"], heads=[h // m, h // m],
            where=f"m2 moe model={m}")
    if cards >= 4:
        # (m3) ZeRO-1 and FSDP against DP at data=4.
        dp = world("m3-dp", family=tf, bf16=False, data=4, model=1,
                   batch=MESH_BATCH // 4)
        out["m3"]["dp"] = _mesh_summary(dp)
        # Under the family tables the transformer's projections keep their
        # (here trivial) model placement and only the other leaves split
        # over data, as the reference's rule has it; with the units
        # replicated by rules every leaf whose leading dim divides splits.
        for tag, knob, rules in (
                ("zero1", "DCT_SHARD_OPT_STATE", None),
                ("fsdp", "DCT_SHARD_PARAMS", None),
                ("zero1_rules", "DCT_SHARD_OPT_STATE", MESH_REPLICATE_UNITS),
                ("fsdp_rules", "DCT_SHARD_PARAMS", MESH_REPLICATE_UNITS)):
            extra = {knob: "1"}
            if rules:
                extra["DCT_SHARD_RULES"] = rules
            run = world(f"m3-{tag}", family=tf, bf16=False, data=4, model=1,
                        batch=MESH_BATCH // 4, **extra)
            s = _check_mesh_run(run, dp, 1e-5, where=f"m3 {tag} data=4")
            dp_bytes = out["m3"]["dp"]
            # With the units replicated, at most 0.3x of DP's bytes.
            limit = 0.3 if rules else 1.0
            smaller = (max(s["opt_bytes"]) < limit * min(dp_bytes["opt_bytes"])
                       and (knob != "DCT_SHARD_PARAMS"
                            or max(s["param_bytes"]) <
                            limit * min(dp_bytes["param_bytes"])))
            if not smaller:
                raise AssertionError(f"(m3) {tag} holds no less per rank: "
                                     f"{s} against {dp_bytes}")
            out["m3"][tag] = s
        # (m4) shard-saved resume at data=2, model=2 (with ZeRO-1): one
        # epoch, then one resumed, against two straight.
        kw = dict(family=tf, bf16=False, data=2, model=2,
                  batch=MESH_BATCH // 2, DCT_SHARD_OPT_STATE="1")
        straight = world("m4-straight", **kw)
        world("m4-split", epochs=1, **kw)
        resumed = world("m4-split", epochs=1, DCT_RESUME="1", **kw)
        diffs = []
        for r in range(4):
            states = [np.load(os.path.join(run["models"], "train_state",
                                           f"p{r}", "state", "state.npz"))
                      for run in (straight, resumed)]
            if sorted(states[0].files) != sorted(states[1].files):
                raise AssertionError(f"(m4) rank {r}: keys differ")
            diffs.append(max(float(np.abs(states[0][k].astype(np.float64)
                                          - states[1][k]).max())
                             for k in states[0].files))
        a, b = (run["ranks"][0]["val_loss"] for run in (straight, resumed))
        out["m4"] = {"val_loss_straight": a, "val_loss_resumed": b,
                     "max_abs_state_diff": max(diffs),
                     "shard_keys_rank0": sum("_s" in k for k in np.load(
                         os.path.join(resumed["models"], "train_state", "p0",
                                      "state", "state.npz")).files)}
        if abs(a - b) > 1e-6 or max(diffs) > 1e-6:
            raise AssertionError(f"(m4) resumed run parts from the straight "
                                 f"one: {out['m4']}")
        print(f"[smoke] (m4) {json.dumps(out['m4'])}", flush=True)
    launches = {k: sum(r["launches"][k] for run in runs
                       for r in run["ranks"]) for k in zero}
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[smoke] (m) model axis on {cards} cards, launches {launches}, "
          f"phase {out['phase_s']:.1f} s on {card}", flush=True)
    print(f"[smoke] (m) summary {json.dumps(out)}", flush=True)
    with open(os.path.join(root, "phase_m.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


# (n) the seq axis: the flash variants of the ring (n0), then train_job
# worlds of the two transformer families on NCCL against one card.
SP_SHAPE = dict(b=16, h=8, d=64)
# (tq, tk, q_offset, window): the windowed ring's partial-band steps
# (square, causal, shifted by one or two shards) and the striped ring's
# half-chunk blocks (rectangular, not causal) at T/S = 512 and 256.
SP_VARIANTS = [(256, 256, 256, 256), (256, 256, 512, 256),
               (512, 512, 256, 256), (512, 512, 512, 256),
               (512, 256, 0, None), (256, 512, 0, None),
               (256, 128, 0, None), (128, 256, 0, None)]
SP_TOL = {"0": 1e-4, "1": 2e-2}  # |val_loss - W=1's|, f32 and bf16
# (n3): the MoE (4 experts), the GRU and ZeRO-1/FSDP on the seq axis, on
# (m)'s rows and schedule. The sorted engine at MESH_MOE_CAPACITY, where
# no token drops, so every shard routes as one card does; einsum at the
# port's default capacity factor, where tokens drop in the global order
# (at 8 its one-hot dispatch would be [16384, 4, 32768] f32, 8.6 GB, a
# layer on one card).
N3_EINSUM_CAPACITY = 1.25
N3_TOL = {"0": 1e-5, "1": 5e-3}  # |val_loss - W=1's|, f32 and bf16
# (n3a) the per-rank (B, H, T) of the MoE worlds' attention: ring steps
# (merged by lse, so their backward takes its cotangent) at seq=2, at
# data=2 seq=2, at model=2 seq=2 (H/2 heads) and a seq=4 ring's shard;
# the all-to-all engine's full-length call at H/4 and H/2 heads.
N3_RING_SHAPES = [(16, 8, 512), (8, 8, 512), (16, 4, 512), (16, 8, 256)]
N3_A2A_SHAPES = [(16, 2, 1024), (16, 4, 1024)]


def _sp_reach(tq, tk, q_offset, window):
    """(pairs, rows, keys) of one head: the unmasked (q, k) pairs, the q
    rows that reach a key and the keys some row reaches. Without causal
    every pair; else q position ``pos = q_offset + r`` reaches the keys
    ``(pos - window, pos]`` that exist, so the band reaches only keys
    ``[max(0, q_offset - window + 1), min(tk, q_offset + tq))``."""
    if window is None and not q_offset:
        return tq * tk, tq, tk
    pos = q_offset + np.arange(tq)
    lo = np.maximum(0, pos - (window or tk + q_offset) + 1)
    hi = np.minimum(pos, tk - 1)
    n = np.maximum(0, hi - lo + 1)
    hit = n > 0
    keys = int(hi[hit].max() - lo[hit].min() + 1) if hit.any() else 0
    return int(n.sum()), int(hit.sum()), keys


def check_sp_variants(fa) -> list[dict]:
    """(n0) flash_fwd, flash_bwd_dkdv and flash_bwd_dq at each of
    ``SP_VARIANTS`` (B=16, H=8, D=64), f32 and bf16, against their plain
    versions (FWD_TOL on o, 1e-4 on lse, BWD_TOL of max|plain| on dq, dk,
    dv), each backward with a nonzero lse cotangent; each kernel's time,
    its bound (this variant's unmasked pairs; the q-side inputs of the
    rows that reach a key and the K/V of the keys some row reaches, each
    read once, and every output written whole), the plain version's and
    SDPA's (the forward's and the backward's; a band as a boolean mask,
    so SDPA computes the same o, without the lse)."""
    b, h, d = SP_SHAPE["b"], SP_SHAPE["h"], SP_SHAPE["d"]
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    rows = []
    for tq, tk, q_offset, window in SP_VARIANTS:
        causal = window is not None
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        mask = None
        if causal:
            pos = q_offset + torch.arange(tq, device=DEVICE)[:, None]
            key = torch.arange(tk, device=DEVICE)[None, :]
            mask = (pos >= key) & (pos - key < window)
        pairs, n_rows, n_keys = (b * h * n for n in
                             _sp_reach(tq, tk, q_offset, window))
        for dtype in (torch.float32, torch.bfloat16):
            q, do = (torch.randn(b, h, tq, d, generator=gen,
                                 device=DEVICE).to(dtype) for _ in range(2))
            k, v = (torch.randn(b, h, tk, d, generator=gen,
                                device=DEVICE).to(dtype) for _ in range(2))
            g_lse = torch.randn(b, h, tq, generator=gen, device=DEVICE)
            o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
            args = (q, k, v, o, lse, do)
            dk, dv = fa.flash_bwd_dkdv(*args, g_lse=g_lse, **kw)
            dq = fa.flash_bwd_dq(*args, g_lse=g_lse, **kw)
            torch.cuda.synchronize()
            po, plse = fa.flash_attention_plain(q, k, v, **kw)
            pdq, pdk, pdv = fa.flash_attention_bwd_plain(*args, g_lse=g_lse,
                                                         **kw)
            finite = all(bool(torch.isfinite(x).all())
                         for x in (o, lse, dq, dk, dv))
            itemsize = torch.tensor([], dtype=dtype).element_size()
            row = {"tq": tq, "tk": tk, "q_offset": q_offset,
                   "window": window, "causal": causal,
                   "dtype": str(dtype).replace("torch.", ""),
                   "shape": [b, h, d], "pairs": pairs,
                   "rows_reached": n_rows, "keys_reached": n_keys,
                   "o_max_abs_err": abs_rel_err(o, po)[0],
                   "lse_max_abs_err": (lse - plse).abs().max().item(),
                   "masked_rows": int((plse < -1e29).sum().item()),
                   "finite": finite}
            for n, got, ref in (("dq", dq, pdq), ("dk", dk, pdk),
                                ("dv", dv, pdv)):
                row[f"{n}_max_abs_err"], row[f"{n}_max_rel_err"] = (
                    abs_rel_err(got, ref))
            bad = (not finite or row["o_max_abs_err"] > FWD_TOL[dtype]
                   or row["lse_max_abs_err"] > 1e-4
                   or any(row[f"{n}_max_rel_err"] > BWD_TOL[dtype]
                          for n in ("dq", "dk", "dv")))
            if bad:
                raise AssertionError(
                    f"(n0) flash variant {row} (tol {FWD_TOL[dtype]} on o, "
                    f"1e-4 on lse, {BWD_TOL[dtype]} relative on dq, dk, dv)")
            # row_b: one row of d. The reached q rows (q, o, dO) and keys (k,
            # v) read, o or dq over tq and dk, dv over tk written; f32 lse
            # and g_lse read at the reached rows, lse written over tq.
            row_b, lse_b = d * itemsize, 4
            reads = 2 * n_keys * row_b
            bounds = {
                "flash_fwd": _bound(
                    4.0 * d * pairs, n_rows * row_b + reads
                    + b * h * tq * (row_b + lse_b), dtype),
                "flash_bwd_dkdv": _bound(
                    8.0 * d * pairs, n_rows * (3 * row_b + 2 * lse_b) + reads
                    + 2 * b * h * tk * row_b, dtype),
                "flash_bwd_dq": _bound(
                    6.0 * d * pairs, n_rows * (3 * row_b + 2 * lse_b) + reads
                    + b * h * tq * row_b, dtype),
            }
            timed = {
                "flash_fwd": lambda: fa.flash_attention(
                    q, k, v, return_lse=True, **kw),
                "flash_bwd_dkdv": lambda: fa.flash_bwd_dkdv(
                    *args, g_lse=g_lse, **kw),
                "flash_bwd_dq": lambda: fa.flash_bwd_dq(
                    *args, g_lse=g_lse, **kw),
            }
            for name, fn in timed.items():
                ms, (bound_ms, by, basis) = time_ms(fn), bounds[name]
                row[name] = {"ms": ms, "bound_ms": bound_ms, "bound_by": by,
                             "bound_basis": basis}
            row["plain_fwd_ms"] = time_ms(lambda: fa.flash_attention_plain(
                q, k, v, **kw), runs=3, per_run=2, warmup=1)
            row["plain_bwd_ms"] = time_ms(
                lambda: fa.flash_attention_bwd_plain(*args, g_lse=g_lse,
                                                     **kw),
                runs=3, per_run=2, warmup=1)
            row["library_fwd_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       attn_mask=mask))
            qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
            o_sdpa = F.scaled_dot_product_attention(qg, kg, vg,
                                                    attn_mask=mask)
            row["library_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
                o_sdpa, (qg, kg, vg), do, retain_graph=True))
            del o_sdpa, qg, kg, vg
            print(f"[smoke] (n0) variant {json.dumps(row)}", flush=True)
            rows.append(row)
    return rows


def check_n3_rank_shapes(fa) -> list[dict]:
    """(n3a) The three kernels against their plain versions at the
    per-rank shapes (n3)'s MoE worlds launch (``N3_RING_SHAPES`` with an
    lse cotangent, ``N3_A2A_SHAPES``), f32 and bf16, on one card."""
    d = MESH_CFG["d_model"] // MESH_CFG["n_heads"]
    gen = torch.Generator(device="cuda").manual_seed(14)
    return [_rank_shape_row(fa, gen, (b, h, t, d), dtype, g_lse=ring,
                            where="(n3a)")
            for shapes, ring in ((N3_RING_SHAPES, True),
                                 (N3_A2A_SHAPES, False))
            for b, h, t in shapes
            for dtype in (torch.float32, torch.bfloat16)]


def n3_worlds() -> list:
    """(n3b)'s worlds: ``(where, world kw, layout, W=1 base)``, a layout
    of None where no kernel lies on the path (the GRU)."""
    tf = dict(family="weather_transformer", bf16=False)
    worlds = []
    for engine in ("sorted", "einsum"):
        moe = dict(family="weather_moe", bf16=False, DCT_N_EXPERTS=4,
                   DCT_MOE_DISPATCH=engine)
        if engine == "einsum":
            moe["DCT_CAPACITY_FACTOR"] = N3_EINSUM_CAPACITY
        base = f"moe_{engine}"
        worlds += [
            (f"moe {engine} ring seq=2", dict(moe, seq=2), "ring", base),
            (f"moe {engine} a2a seq=4",
             dict(moe, seq=4, DCT_SP_ENGINE="a2a"), "a2a", base),
            (f"moe {engine} ring data=2 seq=2", dict(moe, data=2, seq=2),
             "ring", base),
            (f"moe {engine} ring model=2 seq=2", dict(moe, model=2, seq=2),
             "ring", base)]
    # Pair the two-card worlds, then the four-card ones.
    worlds = worlds[0::4] + [w for i, w in enumerate(worlds) if i % 4]
    worlds += [
        ("gru seq=2", dict(N3_BASES["gru"], seq=2), None, "gru"),
        # The units replicated by rules, so the large leaves split too.
        ("zero1 data=2 seq=2", dict(tf, data=2, seq=2, DCT_SHARD_OPT_STATE=1,
                                    DCT_SHARD_RULES=MESH_REPLICATE_UNITS),
         "ring", "tf"),
        ("fsdp data=2 seq=2", dict(tf, data=2, seq=2, DCT_SHARD_PARAMS=1,
                                   DCT_SHARD_RULES=MESH_REPLICATE_UNITS),
         "ring", "tf")]
    return worlds


# (n3b)'s one-card runs, one a card at once.
N3_BASES = {
    "moe_sorted": dict(family="weather_moe", bf16=False, DCT_N_EXPERTS=4,
                       DCT_MOE_DISPATCH="sorted"),
    "moe_einsum": dict(family="weather_moe", bf16=False, DCT_N_EXPERTS=4,
                       DCT_MOE_DISPATCH="einsum",
                       DCT_CAPACITY_FACTOR=N3_EINSUM_CAPACITY),
    "gru": dict(family="weather_gru", bf16=False,
                DCT_SEQ_LEN=GRU_CFG["seq_len"],
                DCT_HIDDEN_DIM=GRU_CFG["hidden_dim"],
                DCT_N_LAYERS=GRU_CFG["n_layers"]),
    "tf": dict(family="weather_transformer", bf16=False),
}


def _packed_worlds(root: str, processed: str, specs: list,
                   cards: int, timeout: float = 600) -> list:
    """``(name, kw)`` worlds of ``data x model x seq x pipe`` ranks
    (global batch MESH_BATCH), side by side where their cards add up to
    at most ``cards``, each on cards of its own
    (``CUDA_VISIBLE_DEVICES``)."""
    done, i = [], 0
    while i < len(specs):
        started, used = [], 0
        while i < len(specs):
            name, kw = specs[i]
            kw = dict(kw)
            data, model = kw.pop("data", 1), kw.pop("model", 1)
            seq, pipe = kw.pop("seq", 1), kw.pop("pipe", 1)
            size = data * model * seq * pipe
            if used + size > cards:
                break
            visible = ",".join(str(c) for c in range(used, used + size))
            started.append(_start_world(
                root, name, processed, data=data, model=model, world=size,
                batch=MESH_BATCH // data, DCT_MESH_SEQ=seq,
                DCT_MESH_PIPE=pipe, CUDA_VISIBLE_DEVICES=visible, **kw))
            started[-1]["seq"] = seq
            used += size
            i += 1
        done += [_finish_world(w, timeout) for w in started]
    return done


def _sp_world(root: str, name: str, processed: str, *, family: str,
              bf16: bool, data: int = 1, model: int = 1, seq: int = 1,
              **extra) -> dict:
    """One world of ``data x model x seq`` train_job ranks on (m)'s rows
    and schedule (global batch MESH_BATCH)."""
    run = _mesh_world(root, name, processed, family=family, bf16=bf16,
                      data=data, model=model, world=data * model * seq,
                      batch=MESH_BATCH // data, DCT_MESH_SEQ=str(seq),
                      **extra)
    run["seq"] = seq
    return run


def sp_forward_calls(layout: str, my: int, s: int, n_steps: int) -> int:
    """Forward kernel calls per layer on seq rank ``my`` of ``s`` (the
    engines' step structure): the non-causal ring ``s``; the contiguous
    causal ring ``1 + my``; the striped ring ``3 + (s - 1)``; the windowed
    contiguous ring ``1 + min(my, n_steps - 1)``; the all-to-all engine
    1."""
    return {"ring": s, "contiguous": 1 + my, "striped": 3 + (s - 1),
            "windowed": 1 + min(my, n_steps - 1), "a2a": 1}[layout]


def _check_sp_run(run: dict, base: dict, tol: float, *, layout: str,
                  n_steps: int = 1, where: str, tag: str = "(n)") -> dict:
    """Every rank ends on the same val_loss, within ``tol`` of W=1's; each
    rank launched W=1's kernels times its forward calls per layer
    (:func:`sp_forward_calls`; rank r sits at seq index r % S), none
    where no kernel lies on the path (``layout`` None)."""
    summary = _mesh_summary(run, base)
    losses = {r["val_loss"] for r in run["ranks"]}
    want1 = base["ranks"][0]["launches"]
    if DEVICE == "cuda" and (layout is None) == all(want1.values()):
        raise AssertionError(f"{tag} {where}: the W=1 run launched {want1}")
    s, bad, per_rank = run["seq"], [], []
    for r, rank in enumerate(run["ranks"]):
        calls = (0 if layout is None
                 else sp_forward_calls(layout, r % s, s, n_steps))
        want = {k: v * calls for k, v in want1.items()}
        per_rank.append(calls)
        if rank["launches"] != want:
            bad.append((r, rank["launches"], want))
    summary["forward_calls_per_layer"] = per_rank
    if len(losses) != 1 or summary["val_loss_diff"] > tol or bad:
        raise AssertionError(f"{tag} {where}: val_losses {losses} against "
                             f"{base['ranks'][0]['val_loss']} (tol {tol}), "
                             f"launches (rank, got, want) {bad}")
    print(f"[smoke] {tag} {where}: {json.dumps(summary)}", flush=True)
    return summary


def sequence_phase(root: str, card: str, *, n3_only: bool = False) -> dict:
    """(n) The seq axis: (n0) and (n3a) on any count of cards, the worlds
    on two or more (module docstring); one line saying they did not run
    on fewer. ``n3_only``: (n3) alone."""
    from dct_tpu_torch.data.synthetic import generate_weather_csv
    from dct_tpu_torch.etl.preprocess import preprocess_csv_to_parquet
    from dct_tpu_torch.ops import flash_attention as fa

    t_phase = time.perf_counter()
    variants = [] if n3_only else check_sp_variants(fa)
    n3a = check_n3_rank_shapes(fa)
    cards = torch.cuda.device_count()
    zero = {"flash_fwd": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
    if cards < 2:
        print(json.dumps({"phase": "n", "ran": False, "cards": cards}),
              flush=True)
        return {"ran": False, "launches": zero, "variants": variants,
                "n3a": n3a, "phase_s": time.perf_counter() - t_phase}
    shutil.rmtree(root, ignore_errors=True)
    raw = os.path.join(root, "raw", "weather.csv")
    generate_weather_csv(raw, rows=MESH_ROWS, seed=12)
    processed = os.path.join(root, "processed")
    preprocess_csv_to_parquet(raw, processed)
    out = {"ran": True, "cards": cards, "card": card, "variants": variants,
           "n3a": n3a, "n1": {}, "n2": {}, "n3": {}}
    runs = []
    if not n3_only:
        n12_phase(root, processed, cards, out, runs)
    n3_phase(root, processed, cards, out, runs)
    launches = {k: sum(r["launches"][k] for run in runs
                       for r in run["ranks"]) for k in zero}
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[smoke] (n) seq axis on {cards} cards, launches {launches}, "
          f"phase {out['phase_s']:.1f} s on {card}", flush=True)
    print(f"[smoke] (n) summary {json.dumps(out)}", flush=True)
    with open(os.path.join(root, "phase_n.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


def n3_phase(root: str, processed: str, cards: int, out: dict,
             runs: list) -> None:
    """(n3b): the W=1 runs side by side, then every world of
    :func:`n3_worlds` that fits on ``cards``, held to its W=1 run
    (``N3_TOL``) with each rank's launches W=1's times its calls per
    layer."""
    t0 = time.perf_counter()
    bases = _packed_worlds(root, processed, [
        (f"n3-w1-{n}", kw) for n, kw in N3_BASES.items()], cards)
    base = dict(zip(N3_BASES, bases))
    runs += bases
    for n, run in base.items():
        out.setdefault("n3_w1", {})[n] = _mesh_summary(run)
    worlds = [w for w in n3_worlds()
              if w[1].get("data", 1) * w[1].get("model", 1)
              * w[1]["seq"] <= cards]
    done = _packed_worlds(root, processed, [
        ("n3-" + where.replace(" ", "-").replace("=", ""), kw)
        for where, kw, _, _ in worlds], cards)
    runs += done
    for (where, kw, layout, key), run in zip(worlds, done):
        out["n3"][where] = _check_sp_run(
            run, base[key], N3_TOL["1" if kw["bf16"] else "0"],
            layout=layout, where=f"n3 {where}")
    out["n3_s"] = time.perf_counter() - t0
    print(f"[smoke] (n3) {len(done)} worlds on {cards} cards, wall "
          f"{out['n3_s']:.1f} s", flush=True)


def n12_phase(root: str, processed: str, cards: int, out: dict,
              runs: list) -> None:
    """(n1) and (n2): the transformer families' worlds (module
    docstring) against their W=1 runs."""

    def world(name, **kw):
        run = _sp_world(root, name, processed, **kw)
        runs.append(run)
        return run

    tf, causal = "weather_transformer", "weather_transformer_causal"
    # The W=1 runs each world is held to, one a card at once.
    bases = {"tf": dict(family=tf, bf16=False),
             "causal": dict(family=causal, bf16=False),
             "window": dict(family=causal, bf16=False, DCT_ATTN_WINDOW="256"),
             "causal_bf16": dict(family=causal, bf16=True)}
    base = dict(zip(bases, _packed_worlds(root, processed, [
        (f"n-w1-{n}", kw) for n, kw in bases.items()], cards)))
    for n, run in base.items():
        runs.append(run)
        out.setdefault("w1", {})[n] = _mesh_summary(run)
    # (n1) weather_transformer, f32: the ring (not causal).
    n1 = [("ring seq=2", dict(seq=2), "ring", None)]
    if cards >= 4:
        n1 += [("a2a seq=4", dict(seq=4, DCT_SP_ENGINE="a2a"), "a2a", None),
               ("ring data=2 seq=2", dict(data=2, seq=2), "ring", None)]
    for where, kw, layout, _ in n1:
        run = world("n1-" + where.replace(" ", "-").replace("=", ""),
                    family=tf, bf16=False, **kw)
        out["n1"][where] = _check_sp_run(run, base["tf"], SP_TOL["0"],
                                         layout=layout, where=f"n1 {where}")
    # (n2) weather_transformer_causal: striped, contiguous, windowed rings.
    if cards >= 4:
        n2 = [("striped seq=4", dict(seq=4), "striped", "causal"),
              ("contiguous seq=4", dict(seq=4, DCT_RING_STRIPED="off"),
               "contiguous", "causal"),
              ("windowed seq=4", dict(seq=4, DCT_ATTN_WINDOW="256"),
               "windowed", "window"),
              ("windowed seq=2", dict(seq=2, DCT_ATTN_WINDOW="256"),
               "windowed", "window"),
              ("striped model=2 seq=2", dict(model=2, seq=2), "striped",
               "causal"),
              ("striped bf16 seq=4", dict(seq=4, bf16=True), "striped",
               "causal_bf16")]
    else:
        n2 = [("striped seq=2", dict(seq=2), "striped", "causal"),
              ("windowed seq=2", dict(seq=2, DCT_ATTN_WINDOW="256"),
               "windowed", "window")]
    for where, kw, layout, key in n2:
        kw = dict(kw)
        bf16 = kw.pop("bf16", False)
        s = kw["seq"]
        steps = 1
        if layout == "windowed":
            from dct_tpu_torch.ops.attention import _ring_window_steps

            steps = _ring_window_steps(256, MESH_CFG["seq_len"] // s, s)
        run = world("n2-" + where.replace(" ", "-").replace("=", ""),
                    family=causal, bf16=bf16, **kw)
        out["n2"][where] = _check_sp_run(
            run, base[key], SP_TOL["1" if bf16 else "0"], layout=layout,
            n_steps=steps, where=f"n2 {where}")


# (o) the engines on a mesh, the re-map of a shard-saved resume, per-layer
# FSDP and rule layouts outside the family tables, on (m)'s rows.
O_PREDICT_MESHES = {"data4": {"data": 4},
                    "data2_model2": {"data": 2, "model": 2},
                    "data2_seq2": {"data": 2, "seq": 2}}
O_PREDICT_TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # against W=1 f32
# The three clauses outside the family tables, in one world at data=2,
# model=2 (seq is one process there), and a seq placement the processed
# rows' five input features allow (in_proj's output dim) at data=2 seq=2.
O_RULES = "qkv_proj.*/kernel$=;head/kernel$=-,model;in_proj/kernel$=seq"
O_SEQ_RULE = "in_proj/kernel$=-,seq"


def _fwd_rank_row(fa, gen, shape, dtype, *, where: str) -> dict:
    """flash_fwd against its plain version at one per-rank shape ``[B, H,
    Tq, Tk, D]`` (q and k/v alike, not causal), FWD_TOL on o and 1e-4 on
    the lse; the plain version in row blocks of 32 (its scores are
    ``B H Tq Tk`` floats)."""
    b, h, tq, tk, d = shape
    q = torch.randn(b, h, tq, d, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(b, h, tk, d, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    o, lse = fa.flash_attention(q, k, v, causal=False, return_lse=True)
    torch.cuda.synchronize()
    parts = [fa.flash_attention_plain(q[i:i + 32], k[i:i + 32], v[i:i + 32],
                                      causal=False) for i in range(0, b, 32)]
    po = torch.cat([p[0] for p in parts])
    plse = torch.cat([p[1] for p in parts])
    row = {"shape": [b, h, tq, tk, d],
           "dtype": str(dtype).replace("torch.", ""),
           "o_max_abs_err": abs_rel_err(o, po)[0],
           "lse_max_abs_err": (lse - plse).abs().max().item()}
    if (not row["o_max_abs_err"] <= FWD_TOL[dtype]
            or not row["lse_max_abs_err"] <= 1e-4):
        raise AssertionError(f"{where} flash_fwd at the per-rank shape: "
                             f"{row} (tol {FWD_TOL[dtype]} on o, 1e-4 on "
                             "the lse)")
    print(f"[smoke] {where} rank shape {json.dumps(row)}", flush=True)
    return row


def check_o_rank_shapes(fa) -> list[dict]:
    """(o0) flash_fwd, f32 and bf16, at the per-rank shapes of (o2)'s
    predict worlds (chunks of PREDICT_CHUNK windows, T=1024, D=64): one
    card ``[256, 8]``, data=4 ``[64, 8]``, data=2 model=2 ``[128, 4]`` and
    a data=2 seq=2 ring step ``[128, 8]`` over 512 of 512 positions."""
    h, t = MESH_CFG["n_heads"], MESH_CFG["seq_len"]
    d, c = MESH_CFG["d_model"] // h, PREDICT_CHUNK
    gen = torch.Generator(device="cuda").manual_seed(15)
    return [_fwd_rank_row(fa, gen, shape, dtype, where="(o0)")
            for shape in ((c, h, t, t, d), (c // 4, h, t, t, d),
                          (c // 2, h // 2, t, t, d),
                          (c // 2, h, t // 2, t // 2, d))
            for dtype in (torch.float32, torch.bfloat16)]


def o_inputs(root: str) -> tuple[str, str]:
    """(o)'s inputs: (m)'s rows (MESH_ROWS, seed 12: 1600 windows of 1024)
    and a random bench-width transformer checkpoint (seed 15)."""
    from dct_tpu_torch.checkpoint.manager import save_checkpoint
    from dct_tpu_torch.data.synthetic import generate_weather_csv
    from dct_tpu_torch.etl.preprocess import preprocess_csv_to_parquet
    from dct_tpu_torch.models.registry import config_from_meta, get_model

    shutil.rmtree(root, ignore_errors=True)
    raw = os.path.join(root, "raw", "weather.csv")
    generate_weather_csv(raw, rows=MESH_ROWS, seed=12)
    processed = os.path.join(root, "processed")
    preprocess_csv_to_parquet(raw, processed)
    torch.manual_seed(15)
    ckpt = save_checkpoint(os.path.join(root, "ckpt", "last.ckpt"),
                           get_model(config_from_meta(K_META), device="cpu"),
                           K_META)
    return ckpt, processed


def _start_predict(root: str, name: str, ckpt: str, processed: str, *,
                   mesh: dict, dtype: str, first_card: int = 0) -> dict:
    """One world of ``predict_job`` ranks (rank r on the r-th of its
    cards, NCCL; one process without a world) over ``processed``."""
    world = math.prod(mesh.values())
    port = _free_port()
    procs = []
    for r in range(world):
        env = _child_env(
            DCT_CKPT=ckpt, DCT_PROCESSED_DIR=processed,
            DCT_PREDICTIONS=os.path.join(root, f"{name}.{r}.parquet"),
            DCT_PREDICT_CHUNK=str(PREDICT_CHUNK), DCT_PREDICT_DTYPE=dtype,
            CUDA_VISIBLE_DEVICES=",".join(
                str(first_card + i) for i in range(world)),
            **{f"DCT_MESH_{a.upper()}": str(n) for a, n in mesh.items()})
        if world > 1:
            env.update(WORLD_SIZE=str(world), NODE_RANK=str(r),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dct_tpu_torch.predict_job"], env=env,
            cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    return {"name": name, "procs": procs, "mesh": mesh, "dtype": dtype,
            "root": root}


def _finish_predict(started: dict) -> dict:
    """Each rank's windows, seconds and launches, and the coordinator's
    probabilities (no other rank writes)."""
    from dct_tpu_torch.etl.parquet import read_table

    procs, name, root = started["procs"], started["name"], started["root"]
    ranks = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=600)
            line = [x for x in out.splitlines()
                    if x.startswith("[predict_job] scored ")]
            if p.returncode != 0 or not line:
                raise AssertionError(f"(o) predict {name} rank {r} exit "
                                     f"{p.returncode}: {err[-3000:]}")
            ranks.append(_predict_line(line[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(os.path.exists(os.path.join(root, f"{name}.{r}.parquet"))
           for r in range(1, len(procs))):
        raise AssertionError(f"(o) predict {name}: a rank other than the "
                             "coordinator wrote predictions")
    table = read_table(os.path.join(root, f"{name}.0.parquet"))
    probs = np.stack([table["prob_0"], table["prob_1"]], axis=1)
    n = ranks[0]["windows"]
    if len(probs) != n or not np.isfinite(probs).all():
        raise AssertionError(f"(o) predict {name}: {len(probs)} rows of {n}")
    return {"name": name, "mesh": started["mesh"],
            "dtype": started["dtype"], "probs": probs, "ranks": ranks,
            "windows": n, "windows_per_s": n / max(r["score_s"]
                                                  for r in ranks),
            "steady_windows_per_s": min(r["steady_windows_per_s"]
                                        for r in ranks)}


def _predict_summary(run: dict, base: dict, calls_per_layer: int) -> dict:
    """``run`` against one card's f32 probabilities (O_PREDICT_TOL of its
    dtype); every rank's forward launches one card's chunks times the
    layers times ``calls_per_layer``."""
    chunks = -(-run["windows"] // PREDICT_CHUNK)
    want = {"flash_fwd": chunks * MESH_CFG["n_layers"] * calls_per_layer,
            "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
    err = float(np.abs(run["probs"] - base["probs"]).max())
    out = {"mesh": run["mesh"], "dtype": run["dtype"],
           "windows": run["windows"], "windows_per_s": run["windows_per_s"],
           "steady_windows_per_s": run["steady_windows_per_s"],
           "build_s": [r["build_s"] for r in run["ranks"]],
           "score_s": [r["score_s"] for r in run["ranks"]],
           "launches": [r["launches"] for r in run["ranks"]],
           "max_abs_err_vs_one_card_f32": err}
    bad = [r["launches"] for r in run["ranks"] if r["launches"] != want]
    if DEVICE == "cuda" and bad or not err <= O_PREDICT_TOL[run["dtype"]]:
        raise AssertionError(f"(o) predict {run['name']}: {out} (launches "
                             f"want {want}, tol {O_PREDICT_TOL[run['dtype']]}"
                             ")")
    print(f"[smoke] (o) predict {run['name']}: {json.dumps(out)}",
          flush=True)
    return out


def o_one_card(fa, root: str, counted=None) -> dict:
    """(o0) on any count of cards (module docstring); ``counted`` is held
    around the kernel checks, which launch in this process. ``root`` is
    emptied first."""
    with counted or contextlib.nullcontext():
        rank_shapes = check_o_rank_shapes(fa)
    ckpt, processed = o_inputs(root)
    runs = {dtype: _finish_predict(_start_predict(
        root, f"o0-{dtype}", ckpt, processed, mesh={"data": 1},
        dtype=dtype)) for dtype in ("float32", "bfloat16")}
    base = runs["float32"]
    out = {"rank_shapes": rank_shapes, "ckpt": ckpt, "processed": processed,
           "base": base,
           "predict": {d: _predict_summary(r, base, 1)
                       for d, r in runs.items()}}
    out["launches"] = {k: sum(r["launches"][k] for run in runs.values()
                              for r in run["ranks"])
                       for k in ("flash_fwd", "flash_bwd_dkdv",
                                 "flash_bwd_dq")}
    print(f"[smoke] (o0) {json.dumps(out['predict'])}", flush=True)
    return out


def _remap_check(models: str, ranks: int, meta: dict | None = None
                 ) -> dict:
    """Rank 0's shard-saved state of ``models`` (a model of ``meta``)
    restored by one CPU process on model=1 from its siblings' files:
    every leaf equal to the dense value tiled from the ``ranks`` files
    (``np.array_equal``)."""
    from dct_tpu_torch.checkpoint.manager import (
        TrainStateCheckpointer,
        state_leaves,
    )
    from dct_tpu_torch.models.registry import config_from_meta, get_model
    from dct_tpu_torch.parallel.mesh import ProcessMesh
    from dct_tpu_torch.train.state import create_train_state

    files = []
    for r in range(ranks):
        with np.load(os.path.join(models, "train_state", f"p{r}", "state",
                                  "state.npz")) as npz:
            files.append({k: npz[k] for k in npz.files})
    meta = meta or K_META
    model = get_model(config_from_meta(meta), device="cpu")
    st = create_train_state(model, input_dim=meta["input_dim"],
                            lr=MESH_LR, seed=0, optimizer="sgd",
                            momentum=MESH_MOMENTUM,
                            mesh=ProcessMesh(1, 1, rank=0, world=1),
                            family=meta["model"])
    ck = TrainStateCheckpointer(os.path.join(models, "train_state", "p0"))
    ck.restore(st)
    unequal = []
    for n, leaf in enumerate(state_leaves(st)):
        dense = np.zeros(np.shape(leaf), np.asarray(leaf).dtype)
        for entries in files:
            for k, v in entries.items():
                if k == str(n):
                    dense[...] = v
                elif k.startswith(f"{n}_s"):
                    off = [int(o) for o in k[len(f"{n}_s"):].split("x")]
                    dense[tuple(slice(o, o + s)
                                for o, s in zip(off, v.shape))] = v
        if not np.array_equal(np.asarray(leaf), dense):
            unequal.append(n)
    if unequal or not ck.last_remap:
        raise AssertionError(f"(o1) {models}: leaves {unequal} restored "
                             f"apart from the saved state ({ck.last_remap})")
    return {"leaves_remapped_on_model1": ck.last_remap["leaves"],
            "leaves_bitwise": len(state_leaves(st))}


def _remap_events(models: str) -> list[dict]:
    with open(os.path.join(models, "events", "events.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r for r in recs if r["event"] == "shard.topology_remap"]


def o1_remap(root: str, processed: str, out: dict, runs: list) -> None:
    """(o1) one epoch at data=2 model=2 (ZeRO-1) resumed for a second at
    data=4, and one epoch by 2 processes at data=2 resumed by 4, each
    against the control continuation on its saving grid."""
    tf = "weather_transformer"
    for name in ("grid", "two", "pivot", "grown"):
        shutil.rmtree(os.path.join(root, f"models-o1-{name}"),
                      ignore_errors=True)

    def world(name, data, model, size=None, **extra):
        run = _mesh_world(root, name, processed, family=tf, bf16=False,
                          data=data, model=model, world=size,
                          batch=MESH_BATCH // data, epochs=1,
                          DCT_SHARD_OPT_STATE="1",
                          DCT_EVENTS_DIR=os.path.join(
                              root, f"models-{name}", "events"), **extra)
        runs.append(run)
        return run

    world("o1-grid", 2, 2)
    world("o1-two", 2, 1)
    bitwise = {}
    for src, dst, ranks in (("grid", "pivot", 4), ("two", "grown", 2)):
        shutil.copytree(os.path.join(root, f"models-o1-{src}"),
                        os.path.join(root, f"models-o1-{dst}"))
        bitwise[dst] = _remap_check(os.path.join(root, f"models-o1-{dst}"),
                                    ranks)
    pairs = {"pivot": (world("o1-grid", 2, 2, DCT_RESUME="1"),
                       world("o1-pivot", 4, 1, DCT_RESUME="1")),
             "grown": (world("o1-two", 2, 1, DCT_RESUME="1"),
                       world("o1-grown", 4, 1, DCT_RESUME="1"))}
    for name, (control, pivot) in pairs.items():
        s = _mesh_summary(pivot, control)
        remaps = [r for r in _remap_events(pivot["models"])
                  if r.get("to_processes") == 4]
        s.update(bitwise[name], remapped_leaves_by_rank={
            r["rank"]: r["leaves"] for r in remaps},
            from_mesh=remaps[0]["from_mesh"] if remaps else None)
        losses = {r["val_loss"] for r in pivot["ranks"]}
        if (len(losses) != 1 or s["val_loss_diff"] > 1e-5
                or sorted(s["remapped_leaves_by_rank"]) != [0, 1, 2, 3]):
            raise AssertionError(f"(o1) {name}: {s} (val_losses {losses}, "
                                 "tol 1e-5)")
        print(f"[smoke] (o1) {name}: shard.topology_remap leaves "
              f"{s['remapped_leaves_by_rank']}; {json.dumps(s)}", flush=True)
        out["o1"][name] = s


def o2_predict(root: str, ckpt: str, processed: str, base: dict, out: dict,
               counts: dict) -> None:
    """(o2) predict_job on the three grids, f32 and bf16, against one
    card's f32 probabilities."""
    for name, mesh in O_PREDICT_MESHES.items():
        calls = sp_forward_calls("ring", 0, mesh.get("seq", 1), 1)
        for dtype in ("float32", "bfloat16"):
            tag = f"{name}_{dtype}"
            run = _finish_predict(_start_predict(
                root, f"o2-{tag}", ckpt, processed, mesh=mesh, dtype=dtype))
            out["o2"][tag] = s = _predict_summary(run, base, calls)
            s["windows_per_s_one_card_f32"] = base["windows_per_s"]
            for launches in s["launches"]:
                for k, v in launches.items():
                    counts[k] += v


def o3_fsdp_and_rules(root: str, processed: str, out: dict,
                      runs: list) -> None:
    """(o3) per-layer FSDP at data=4 against DP; the rule layouts at
    data=2 model=2 and data=2 seq=2 against W=1; one epoch each."""
    tf = "weather_transformer"

    def world(name, data=1, model=1, seq=1, **extra):
        shutil.rmtree(os.path.join(root, f"models-{name}"),
                      ignore_errors=True)
        run = _mesh_world(root, name, processed, family=tf, bf16=False,
                          data=data, model=model, world=data * model * seq,
                          batch=MESH_BATCH // data, epochs=1,
                          DCT_MESH_SEQ=str(seq), **extra)
        run["seq"] = seq
        runs.append(run)
        return run

    dp = world("o3-dp", data=4)
    # The units replicated by rules, so every leaf whose leading dim
    # divides is FSDP's (under the tables the projections keep their
    # trivial model placement).
    fsdp = world("o3-fsdp", data=4, DCT_SHARD_PARAMS="1",
                 DCT_SHARD_RULES=MESH_REPLICATE_UNITS)
    s = _check_mesh_run(fsdp, dp, 1e-5, where="fsdp data=4", tag="(o3)")
    s["gathered"] = [{k: r[k] for k in (
        "gathered_peak_bytes", "unit_bytes_max", "unit_bytes_sum",
        "step_unit_bytes")} for r in fsdp["ranks"]]
    for g in s["gathered"]:
        # One unit at a time (no prefetch) beside the small units held for
        # the step; the whole model's FSDP leaves are what one gather held
        # before.
        if not 0 < g["gathered_peak_bytes"] <= g["unit_bytes_max"] + g[
                "step_unit_bytes"] < g["unit_bytes_sum"]:
            raise AssertionError(f"(o3) fsdp gathered {g}")
    out["o3"]["fsdp"] = s
    out["o3"]["dp"] = _mesh_summary(dp)
    print(f"[smoke] (o3) fsdp gathered bytes per rank {s['gathered']}",
          flush=True)
    base = world("o3-w1")
    out["o3"]["w1"] = _mesh_summary(base)
    rules = world("o3-rules", data=2, model=2, DCT_SHARD_RULES=O_RULES)
    out["o3"]["rules_data2_model2"] = _check_mesh_run(
        rules, base, 1e-5, where="rules data=2 model=2", tag="(o3)")
    seq = world("o3-seq-rule", data=2, seq=2, DCT_SHARD_RULES=O_SEQ_RULE)
    out["o3"]["seq_rule_data2_seq2"] = _check_sp_run(
        seq, base, SP_TOL["0"], layout="ring", where="seq rule data=2 seq=2",
        tag="(o3)")


def mesh_engines_phase(fa, root: str, card: str, o0: dict | None = None
                       ) -> dict:
    """(o) (module docstring): (o0) on any count of cards (unless given),
    (o1)-(o3) on four; one line saying they did not run on fewer."""
    t_phase = time.perf_counter()
    if o0 is None:
        o0 = o_one_card(fa, os.path.join(root, "o0"))
    cards = torch.cuda.device_count()
    zero = {"flash_fwd": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
    out = {"o0": {k: o0[k] for k in ("rank_shapes", "predict")},
           "predict_launches": o0["launches"], "fsdp_launches": dict(zero),
           "remap_launches": dict(zero)}
    if cards < 4:
        print(json.dumps({"phase": "o", "ran": False, "cards": cards}),
              flush=True)
        return out
    out.update(ran=True, cards=cards, card=card, o1={}, o2={}, o3={})
    runs, fsdp_runs = [], []
    o1_remap(root, o0["processed"], out, runs)
    counts = dict(out["predict_launches"])
    o2_predict(root, o0["ckpt"], o0["processed"], o0["base"], out, counts)
    out["predict_launches"] = counts
    o3_fsdp_and_rules(root, o0["processed"], out, fsdp_runs)
    out["fsdp_launches"] = {k: sum(r["launches"][k] for run in fsdp_runs
                                   for r in run["ranks"]) for k in zero}
    out["remap_launches"] = {k: sum(r["launches"][k] for run in runs
                                    for r in run["ranks"]) for k in zero}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[smoke] (o) engines on {cards} cards, phase "
          f"{out['phase_s']:.1f} s on {card}", flush=True)
    print(f"[smoke] (o) summary {json.dumps(out)}", flush=True)
    with open(os.path.join(root, "phase_o.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


# ----------------------------------------------------------------------
# (p) The pipe axis: weather_transformer_pp through train_job on (m)'s
# rows and schedule, served and batch-scored; its worlds on four cards.

PP = "weather_transformer_pp"
PP_STAGES = 2
PP_TOL = {"0": 1e-5, "1": 5e-3}  # |val_loss - one card's|, f32 and bf16
PP_SERVE_TOL = {"f32": 1e-5, "int8": 1e-5, "bf16": 2e-2}  # vs numpy
PP_WORLD_S = 300  # a (p) world's bound; one takes well under a minute


def _mesh_batches(processed: str) -> tuple[int, int]:
    """(train steps, eval batches) an epoch of (m)'s schedule."""
    from dct_tpu_torch.data.dataset import load_processed_dataset
    from dct_tpu_torch.data.pipeline import BatchLoader, contiguous_split
    from dct_tpu_torch.data.windows import make_windows

    seq = MESH_CFG["seq_len"]
    windows = make_windows(load_processed_dataset(processed), seq)
    train_idx, val_idx = contiguous_split(
        len(windows), val_fraction=MESH_VAL_FRACTION, gap=seq)
    return tuple(BatchLoader(windows, idx, global_batch=MESH_BATCH,
                             shuffle=shuffle).num_batches
                 for idx, shuffle in ((train_idx, True), (val_idx, False)))


def pp_launches(batches: tuple, epochs: int, *, pipe: int = 1,
                microbatches: int = 1) -> dict:
    """One rank's flash launches over ``epochs`` of ``batches`` (train
    steps, eval batches): its stage's ``n_layers / P`` layers on each of
    ``M`` microbatches (the ramp ticks skipped) every train step and eval
    batch, as many dK/dV and dQ every train step; on one card (``pipe``
    1) every layer once a batch."""
    n_train, n_val = batches
    per = (MESH_CFG["n_layers"] // pipe * microbatches if pipe > 1
           else MESH_CFG["n_layers"])
    return {"flash_fwd": epochs * per * (n_train + n_val),
            "flash_bwd_dkdv": epochs * per * n_train,
            "flash_bwd_dq": epochs * per * n_train}


def check_p_rank_shapes(fa) -> list[dict]:
    """The three kernels against their plain versions at (p1)'s per-rank
    microbatch shapes ``[B/(D M), H/M_model, T, D]``: ``[8, 8]`` (pipe=2,
    M=2), ``[4, 8]`` (M=4, pipe=4, data=2 pipe=2), ``[8, 4]`` (model=2
    pipe=2); f32 and bf16, not causal, FWD_TOL and BWD_TOL."""
    h, t = MESH_CFG["n_heads"], MESH_CFG["seq_len"]
    d = MESH_CFG["d_model"] // h
    gen = torch.Generator(device="cuda").manual_seed(16)
    return [_rank_shape_row(fa, gen, (b, hl, t, d), dtype, g_lse=False,
                            where="(p0)")
            for b, hl in ((MESH_BATCH // 2, h), (MESH_BATCH // 4, h),
                          (MESH_BATCH // 2, h // 2))
            for dtype in (torch.float32, torch.bfloat16)]


def _pp_rows(root: str) -> str:
    """(m)'s rows (MESH_ROWS, seed 12), processed under ``root``."""
    from dct_tpu_torch.data.synthetic import generate_weather_csv
    from dct_tpu_torch.etl.preprocess import preprocess_csv_to_parquet

    raw = os.path.join(root, "raw", "weather.csv")
    generate_weather_csv(raw, rows=MESH_ROWS, seed=12)
    processed = os.path.join(root, "processed")
    preprocess_csv_to_parquet(raw, processed)
    return processed


def _pp_world_check(run: dict, base: dict, tol: float, want: dict, *,
                    pipe: int, microbatches: int, where: str) -> dict:
    """Every rank of ``run`` on one val_loss within ``tol`` of ``base``'s,
    with ``want`` launches; its step, memory and each stage's idle share
    of the traced schedules beside the bubble ``(P-1)/(M+P-1)``."""
    from dct_tpu_torch.parallel.pipeline import bubble

    s = _mesh_summary(run, base)
    losses = {r["val_loss"] for r in run["ranks"]}
    bad = [r["launches"] for r in run["ranks"] if r["launches"] != want]
    if (len(losses) != 1 or not s["val_loss_diff"] <= tol
            or DEVICE == "cuda" and bad):
        raise AssertionError(f"(p) {where}: val_losses {losses} against "
                             f"{base['ranks'][0]['val_loss']} (tol {tol}), "
                             f"launches {bad} against {want}")
    s["bubble"] = bubble(microbatches, pipe)
    s["stages"] = []
    for r in run["ranks"]:
        tr = r.get("pipeline") or {}
        span, busy = tr.get("median_span_ms"), tr.get("median_busy_ms")
        s["stages"].append({
            "median_schedule_ms": span, "median_busy_ms": busy,
            "idle_share": (1 - busy / span) if span else None,
            "schedules": tr.get("schedules")})
    print(f"[smoke] (p) {where}: {json.dumps(s)}", flush=True)
    return s


def _pp_serve(fa, ckpt: str, root: str) -> dict:
    """(p0) the package of ``ckpt`` through the HTTP server (torch engine,
    the sequential stack on the card) at 1, 3 and 8 windows against the
    reference's numpy forward (``transformer_pp_forward_numpy``), and its
    bf16 and int8 twins through the torch scorer; one forward launch a
    layer a request."""
    from dct_tpu_torch.config import ServingConfig
    from dct_tpu_torch.serving.batching import TorchScorer
    from dct_tpu_torch.serving.numpy_runtime import (
        softmax_numpy,
        transformer_pp_forward_numpy,
    )
    from dct_tpu_torch.serving.package import load_package
    from dct_tpu_torch.serving.quant import quantize_package
    from dct_tpu_torch.serving.score_gen import generate_score_package
    from dct_tpu_torch.serving.server import make_server

    pkg = os.path.join(root, "pkg-pp")
    generate_score_package(ckpt, pkg)
    weights, meta = load_package(pkg)
    rng = np.random.default_rng(16)
    layers = MESH_CFG["n_layers"]
    rows, launches = [], 0

    def numpy_probs(w, x):
        w = {k: v.dequantize() if hasattr(v, "dequantize") else v
             for k, v in w.items()}
        return softmax_numpy(transformer_pp_forward_numpy(w, meta, x))

    # The numpy forward takes about a second a window at this width: one
    # f32 reference for every request's windows.
    x = rng.standard_normal((8, MESH_CFG["seq_len"], 5)).astype(np.float32)
    want = numpy_probs(weights, x)

    server = make_server(pkg, serving=ServingConfig(workers=1),
                         device=None if DEVICE == "cuda" else DEVICE)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        for n in (1, 3, 8):
            fa.reset_launches()
            probs, ms = post(port, x[:n])
            got = fa.launches
            err = float(np.abs(probs - want[:n]).max())
            if (DEVICE == "cuda" and got != layers
                    or not err <= PP_SERVE_TOL["f32"]):
                raise AssertionError(f"(p0) serve {n}: launches {got} "
                                     f"(want {layers}), numpy err {err}")
            launches += got
            rows.append({"windows": n, "ms": ms, "numpy_max_abs_err": err})
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)
    for quant in ("bf16", "int8"):
        qdir = os.path.join(root, f"pkg-pp-{quant}")
        quantize_package(pkg, qdir, quant)
        qw, qmeta = load_package(qdir)
        scorer = TorchScorer(qw, qmeta, "cuda:0" if DEVICE == "cuda"
                             else DEVICE)
        fa.reset_launches()
        probs = scorer(x[:3])
        got = fa.launches
        # bf16 against the f32 reference (its bound is bf16's rounding);
        # int8 against numpy over its own dequantized kernels.
        ref = want[:3] if quant == "bf16" else numpy_probs(qw, x[:3])
        err = float(np.abs(probs - ref).max())
        if (DEVICE == "cuda" and got != layers
                or not err <= PP_SERVE_TOL[quant]):
            raise AssertionError(f"(p0) {quant} scorer: launches {got} "
                                 f"(want {layers}), numpy err {err}")
        launches += got
        rows.append({"package": quant, "windows": 3,
                     "numpy_max_abs_err": err})
    out = {"requests": rows, "launches": launches}
    print(f"[smoke] (p0) serve {json.dumps(out)}", flush=True)
    return out


def _pp_predict(ckpt: str, processed: str, root: str) -> dict:
    """(p0) ``predict_job`` on one card over (m)'s rows, chunks of
    PREDICT_CHUNK: one forward a layer a chunk; the first and last
    window of every chunk within 1e-5 of the numpy engine (a window's
    probabilities do not depend on the others'; the numpy forward takes
    about a second a window at this width)."""
    from dct_tpu_torch import predict_job
    from dct_tpu_torch.data.dataset import load_processed_dataset
    from dct_tpu_torch.data.windows import make_windows
    from dct_tpu_torch.etl.parquet import read_table
    from dct_tpu_torch.serving.score_gen import weights_from_checkpoint

    out_path = os.path.join(root, "predictions-pp.parquet")
    r = subprocess.run(
        [sys.executable, "-m", "dct_tpu_torch.predict_job"],
        env=_child_env(DCT_CKPT=ckpt, DCT_PROCESSED_DIR=processed,
                       DCT_PREDICTIONS=out_path,
                       DCT_PREDICT_CHUNK=str(PREDICT_CHUNK)),
        cwd=HERE, capture_output=True, text=True, timeout=600)
    line = [x for x in r.stdout.splitlines()
            if x.startswith("[predict_job] scored ")]
    if r.returncode != 0 or not line:
        raise AssertionError(f"(p0) predict exit {r.returncode}: "
                             f"{r.stderr[-2000:]}")
    job = _predict_line(line[-1])
    n = job["windows"]
    chunks = -(-n // PREDICT_CHUNK)
    table = read_table(out_path)
    probs = np.stack([table["prob_0"], table["prob_1"]], axis=1)
    weights, meta = weights_from_checkpoint(ckpt)
    windows = make_windows(load_processed_dataset(processed),
                           int(meta["seq_len"])).features
    rows = sorted({r for i in range(0, n, PREDICT_CHUNK)
                   for r in (i, min(i + PREDICT_CHUNK, n) - 1)})
    err = float(np.abs(probs[rows] - predict_job.score(
        weights, meta, windows[rows], PREDICT_CHUNK, engine="numpy")).max())
    want = {"flash_fwd": chunks * MESH_CFG["n_layers"], "flash_bwd_dkdv": 0,
            "flash_bwd_dq": 0}
    if (DEVICE == "cuda" and job["launches"] != want or len(probs) != n
            or not err <= PP_SERVE_TOL["f32"]
            or not np.isfinite(probs).all()):
        raise AssertionError(f"(p0) predict launches {job['launches']} "
                             f"(want {want}), rows {len(probs)} of {n}, "
                             f"numpy err {err}")
    out = {"windows": n, "chunks": chunks, "windows_checked": len(rows),
           "build_s": job["build_s"],
           "score_s": job["score_s"],
           "steady_windows_per_s": job["steady_windows_per_s"],
           "launches": job["launches"], "numpy_max_abs_err": err}
    print(f"[smoke] (p0) predict job {json.dumps(out)}", flush=True)
    return out


def p_one_card(fa, root: str, counted=None) -> dict:
    """(p0) on any count of cards (module docstring); ``counted`` is held
    around the parts that launch in this process. ``root`` is emptied
    first."""
    with counted or contextlib.nullcontext():
        rank_shapes = check_p_rank_shapes(fa)
    shutil.rmtree(root, ignore_errors=True)
    processed = _pp_rows(root)
    batches = _mesh_batches(processed)
    started = [_start_world(root, f"p0-{tag}", processed, family=PP,
                            bf16=bf16, data=1, model=1, batch=MESH_BATCH,
                            DCT_N_STAGES=PP_STAGES)
               for tag, bf16 in (("f32", False), ("bf16", True))]
    runs = dict(zip(("f32", "bf16"), (_finish_world(w, PP_WORLD_S)
                                      for w in started)))
    want = pp_launches(batches, MESH_EPOCHS)
    train = {}
    for tag, run in runs.items():
        s = _mesh_summary(run)
        if (DEVICE == "cuda" and s["launches"] != [want]
                or not np.isfinite(s["val_loss"])):
            raise AssertionError(f"(p0) train_job {tag}: {s} (launches "
                                 f"want {want})")
        train[tag] = s
        print(f"[smoke] (p0) train_job {tag}: {json.dumps(s)}", flush=True)
    ckpt = os.path.join(runs["f32"]["models"], "last.ckpt")
    with counted or contextlib.nullcontext():
        served = _pp_serve(fa, ckpt, root)
    predicted = _pp_predict(ckpt, processed, root)
    launches = {k: sum(r["launches"][k] for run in runs.values()
                       for r in run["ranks"]) + predicted["launches"][k]
                for k in want}
    launches["flash_fwd"] += served["launches"]
    out = {"rank_shapes": rank_shapes, "train": train, "serve": served,
           "predict": predicted, "launches": launches, "batches": batches,
           "processed": processed}
    print(f"[smoke] (p0) launches {launches}", flush=True)
    return out


def p1_worlds(root: str, processed: str, batches: tuple, cards: int,
              out: dict, runs: list) -> None:
    """(p1) one epoch of each pipe world, f32 and bf16, against one
    card's sequential run from the same init (module docstring)."""
    trace = {"DCT_PIPE_TRACE": "1"}
    bases = {}
    for stages in (PP_STAGES, 4):
        for bf16 in (False, True):
            bases[(stages, bf16)] = dict(family=PP, bf16=bf16, epochs=1,
                                         DCT_N_STAGES=stages)
    done = _packed_worlds(root, processed, [
        (f"p1-w1-s{st}-{'bf16' if b else 'f32'}", kw)
        for (st, b), kw in bases.items()], cards, PP_WORLD_S)
    base = dict(zip(bases, done))
    runs += done
    for (st, b), run in base.items():
        out["p1"][f"w1_s{st}_{'bf16' if b else 'f32'}"] = _mesh_summary(run)
    grids = [("pipe=2 M=2", dict(pipe=2), 2), ("pipe=2 M=4", dict(pipe=2), 4),
             ("pipe=4 M=4", dict(pipe=4), 4),
             ("data=2 pipe=2", dict(data=2, pipe=2), 2),
             ("model=2 pipe=2", dict(model=2, pipe=2), 2)]
    for bf16 in (False, True):
        tag = "bf16" if bf16 else "f32"
        specs = []
        for where, mesh, m in grids:
            stages = mesh["pipe"]
            specs.append((f"p1-{tag}-" + where.replace(" ", "-").replace(
                "=", ""), dict(mesh, family=PP, bf16=bf16, epochs=1,
                               DCT_N_STAGES=stages, DCT_N_MICROBATCHES=m,
                               **trace)))
        done = _packed_worlds(root, processed, specs, cards, PP_WORLD_S)
        runs += done
        for (where, mesh, m), run in zip(grids, done):
            p = mesh["pipe"]
            want = pp_launches(batches, 1, pipe=p, microbatches=m)
            out["p1"][f"{tag} {where}"] = _pp_world_check(
                run, base[(p, bf16)], PP_TOL["1" if bf16 else "0"], want,
                pipe=p, microbatches=m, where=f"p1 {tag} {where}")


def _pp_remap_check(models: str, ranks: int) -> dict:
    """:func:`_remap_check` for the pipeline family's state (two
    stages)."""
    meta = dict(K_META, model=PP, name=PP, n_stages=PP_STAGES)
    return _remap_check(models, ranks, meta=meta)


def p2_remap(root: str, processed: str, out: dict, runs: list) -> None:
    """(p2) a shard-saved resume re-mapped: one epoch at data=2 pipe=2
    resumed for a second at model=2 pipe=2, and one at pipe=2 resumed on
    one card, each against the control continuation on its saving grid
    (``n_stages`` equals ``pipe``, so a two-stage checkpoint resumes on
    two-stage grids)."""
    for name in ("grid", "two", "pivot", "one"):
        shutil.rmtree(os.path.join(root, f"models-p2-{name}"),
                      ignore_errors=True)

    def spec(name, **kw):
        return (f"p2-{name}", dict(kw, family=PP, bf16=False, epochs=1,
                                   DCT_N_STAGES=PP_STAGES,
                                   DCT_EVENTS_DIR=os.path.join(
                                       root, f"models-p2-{name}",
                                       "events")))

    runs += _packed_worlds(root, processed, [
        spec("grid", data=2, pipe=2), spec("two", pipe=2)], 4, PP_WORLD_S)
    bitwise = {}
    for src, dst, ranks in (("grid", "pivot", 4), ("two", "one", 2)):
        shutil.copytree(os.path.join(root, f"models-p2-{src}"),
                        os.path.join(root, f"models-p2-{dst}"))
        bitwise[dst] = _pp_remap_check(
            os.path.join(root, f"models-p2-{dst}"), ranks)
    resume = {"DCT_RESUME": "1"}
    done = _packed_worlds(root, processed, [
        spec("grid", data=2, pipe=2, **resume),
        spec("pivot", model=2, pipe=2, **resume),
        spec("two", pipe=2, **resume), spec("one", **resume)], 4,
        PP_WORLD_S)
    runs += done
    control_grid, pivot, control_two, one = done
    for name, control, run, to in (("pivot", control_grid, pivot, 4),
                                   ("one", control_two, one, 1)):
        s = _mesh_summary(run, control)
        remaps = _remap_events(run["models"])
        s.update(bitwise[name], remapped_leaves_by_rank={
            r["rank"]: r["leaves"] for r in remaps
            if r.get("to_processes") == to},
            from_mesh=remaps[0]["from_mesh"] if remaps else None)
        losses = {r["val_loss"] for r in run["ranks"]}
        if (len(losses) != 1 or s["val_loss_diff"] > 1e-5
                or sorted(s["remapped_leaves_by_rank"]) != list(range(to))):
            raise AssertionError(f"(p2) {name}: {s} (val_losses {losses}, "
                                 "tol 1e-5)")
        print(f"[smoke] (p2) {name}: shard.topology_remap leaves "
              f"{s['remapped_leaves_by_rank']}; {json.dumps(s)}", flush=True)
        out["p2"][name] = s


def pipeline_phase(fa, root: str, card: str, p0: dict | None = None
                   ) -> dict:
    """(p) (module docstring): (p0) on any count of cards (unless given),
    (p1) and (p2) on four; one line saying they did not run on fewer."""
    t_phase = time.perf_counter()
    if p0 is None:
        p0 = p_one_card(fa, os.path.join(root, "p0"))
    cards = torch.cuda.device_count()
    out = {"p0": {k: p0[k] for k in ("rank_shapes", "train", "serve",
                                      "predict")},
           "launches": dict(p0["launches"])}
    if cards < 4:
        print(json.dumps({"phase": "p", "ran": False, "cards": cards}),
              flush=True)
        return out
    out.update(ran=True, cards=cards, card=card, p1={}, p2={})
    processed, runs = p0["processed"], []
    p1_worlds(root, processed, p0["batches"], cards, out, runs)
    p2_remap(root, processed, out, runs)
    for k in out["launches"]:
        out["launches"][k] += sum(r["launches"][k] for run in runs
                                  for r in run["ranks"])
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[smoke] (p) pipe axis on {cards} cards, launches "
          f"{out['launches']}, phase {out['phase_s']:.1f} s on {card}",
          flush=True)
    print(f"[smoke] (p) summary {json.dumps(out)}", flush=True)
    with open(os.path.join(root, "phase_p.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


# ----------------------------------------------------------------------
# (q) The MPMD pipeline.

MPMD_STAGES = "1,1"
# Epochs of the sequential runs, the long in-process run and the worker,
# f32 and bf16: in bf16 a microbatched step's rounding parts its loss from
# the whole batch's by up to 7.3e-3 (against 5e-3) by the third epoch.
MPMD_EPOCHS = {False: 3, True: 1}
MPMD_RUNS = (("1f1b", 2, False), ("1f1b", 4, True), ("gpipe", 4, False))
# (schedule, M, runs MPMD_EPOCHS) of the in-process runs; the rest 1 epoch
MPMD_TOL = {"0": 1e-5, "1": 5e-3}  # every step's loss and val_loss against
# train_job's, f32 and bf16
MPMD_WORKER_TOL = {"0": 1e-5, "1": 5e-3}  # the worker's val_loss against
# the in-process run's
MPMD_WORLD_S = 600
MPMD_Q1 = (("1,1,1,1", "1f1b"), ("1,1,1,1", "gpipe"), ("1,1", "1f1b"))


_Q_PROCS: list = []  # (q)'s child processes, stopped if the phase fails


def _q_stop_children() -> None:
    """SIGTERM every (q) child still running (a supervisor drains its
    world), then SIGKILL what outlives 60 s."""
    for p in _Q_PROCS:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + 60
    for p in _Q_PROCS:
        try:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _q_dtype(bf16: bool) -> str:
    return "bf16" if bf16 else "f32"


def _q_env(root: str, name: str, processed: str, *, bf16: bool,
           stages: str = MPMD_STAGES, epochs: int = 1,
           m: int = 4, schedule: str = "1f1b", **extra) -> dict:
    """A train_job or mpmd_worker environment in (q): (m)'s rows and
    schedule at the bench's width, ``n_stages`` from the stage map,
    dropout 0, every step's loss logged, the world's own events,
    heartbeats and tracking store."""
    return _mesh_env(
        root, name, processed, family=PP, bf16=bf16, data=1, model=1,
        batch=MESH_BATCH, epochs=epochs,
        DCT_N_STAGES=len(stages.split(",")), DCT_DROPOUT=0,
        DCT_LOG_EVERY_N_STEPS=1,
        DCT_EVENTS_DIR=os.path.join(root, f"events-{name}"),
        DCT_HEARTBEAT_DIR=os.path.join(root, f"hb-{name}"),
        DCT_TRACKING_DIR=os.path.join(root, f"mlruns-{name}"),
        DCT_MPMD_STAGES=stages, DCT_MPMD_MICROBATCHES=m,
        DCT_MPMD_SCHEDULE=schedule, **extra)


def _q_seq_key(bf16: bool, m: int):
    """Which sequential run a pipeline of ``m`` microbatches is held to:
    the whole-batch train_job in f32 (None); in bf16 train_job
    accumulating over the same ``m`` consecutive row blocks of each
    global batch (``m``), because bf16 rounding alone parts a run of
    whole batches from one of microbatches by more than MPMD_TOL within
    an epoch (both printed beside each other in (q0))."""
    return m if bf16 else None


def _q_seq_env(bf16: bool, key) -> dict:
    """The environment of :func:`_q_seq_key`'s run: ``DCT_BATCH_SIZE``
    global/M and ``DCT_GRAD_ACCUM_STEPS`` M, so one update takes the same
    rows in the same microbatches as the pipeline's step."""
    if key is None:
        return {}
    return {"DCT_BATCH_SIZE": MESH_BATCH // key, "DCT_GRAD_ACCUM_STEPS": key}


def _q_sequential(root: str, name: str, processed: str, *, bf16: bool,
                  stages: str = MPMD_STAGES, epochs: int = 1,
                  **extra) -> dict:
    """Start ``train_job`` on one card (pipe=1, the stages one after
    another) with (q)'s environment."""
    env = {k: str(v) for k, v in _q_env(
        root, name, processed, bf16=bf16, stages=stages, epochs=epochs,
        **extra).items()}
    proc = subprocess.Popen(
        [sys.executable, "-m", "dct_tpu_torch.train_job"], env=env,
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    _Q_PROCS.append(proc)
    return {"name": name, "world": 1, "procs": [proc],
            "t0": time.perf_counter(), "env": env,
            "models": env["DCT_MODELS_DIR"], "global_batch": MESH_BATCH}


def _q_trajectory(run: dict) -> dict:
    """A finished train_job's every step loss (its tracking store) and
    every epoch's val_loss (its event log)."""
    env = run["env"]
    steps = []
    for root_dir, _, files in os.walk(env["DCT_TRACKING_DIR"]):
        if "metrics.jsonl" in files:
            with open(os.path.join(root_dir, "metrics.jsonl")) as f:
                steps += [json.loads(x) for x in f if x.strip()]
    losses = [r["train_loss"] for r in sorted(steps, key=lambda r: r["step"])
              if "train_loss" in r]
    vals = [e["val_loss"] for e in _named(_events_of(env), "epoch_end")]
    return {"step_losses": losses, "val_losses": vals,
            "launches": run["ranks"][0]["launches"],
            "fit": {k: run["ranks"][0][k] for k in (
                "val_loss", "samples_per_sec", "steady_samples_per_sec")}}


def _q_cfg(root: str, name: str, processed: str, *, bf16: bool,
           stages: str, schedule: str, m: int, epochs: int):
    """(q)'s in-process run, configured as :func:`_q_env`'s (the
    environment's defaults elsewhere)."""
    from dct_tpu_torch.config import ModelConfig, MpmdConfig, RunConfig

    cfg = RunConfig()
    cfg.data.processed_dir = processed
    cfg.data.models_dir = os.path.join(root, f"models-{name}")
    cfg.data.val_fraction = MESH_VAL_FRACTION
    cfg.model = ModelConfig(
        name=PP, seq_len=MESH_CFG["seq_len"], d_model=MESH_CFG["d_model"],
        n_heads=MESH_CFG["n_heads"], n_layers=MESH_CFG["n_layers"],
        d_ff=MESH_CFG["d_ff"], n_stages=len(stages.split(",")),
        dropout=0.0)
    cfg.train.epochs, cfg.train.batch_size = epochs, MESH_BATCH
    cfg.train.bf16_compute = bf16
    cfg.train.optimizer, cfg.train.lr = "sgd", MESH_LR
    cfg.train.momentum = MESH_MOMENTUM
    cfg.obs.events_dir = os.path.join(root, f"events-{name}")
    cfg.mpmd = MpmdConfig(stages=stages, microbatches=m, schedule=schedule)
    return cfg


def mpmd_launches(batches: tuple, epochs: int, *, stages: int,
                  microbatches: int) -> dict:
    """One stage's flash launches over ``epochs`` of ``batches`` (train
    steps, eval batches): ``2 (L/P) M`` forwards a train step (the fwd op
    and the backward's recompute) and ``(L/P) M`` dK/dV and dQ; ``(L/P)
    M`` forwards an eval batch."""
    n_train, n_val = batches
    per = MESH_CFG["n_layers"] // stages * microbatches
    return {"train": {"flash_fwd": epochs * n_train * 2 * per,
                      "flash_bwd_dkdv": epochs * n_train * per,
                      "flash_bwd_dq": epochs * n_train * per},
            "eval": {"flash_fwd": epochs * n_val * per,
                     "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}}


def _q_check(where: str, got: dict, base: dict, tol: float) -> dict:
    """Every step's loss and every epoch's val_loss of ``got`` within
    ``tol`` of ``base``'s first as many."""
    steps, vals = got["step_losses"], got["val_losses"]
    step_diff = max(abs(a - b) for a, b in zip(steps,
                                               base["step_losses"]))
    val_diff = max(abs(a - b) for a, b in zip(vals, base["val_losses"]))
    if (len(base["step_losses"]) < len(steps)
            or len(base["val_losses"]) < len(vals)
            or not (step_diff <= tol and val_diff <= tol)
            or not np.isfinite(steps + vals).all()):
        raise AssertionError(
            f"(q) {where}: step losses {steps[:4]}... val {vals} against "
            f"{base['step_losses'][:4]}... val {base['val_losses']}: "
            f"max diffs {step_diff}, {val_diff} (tol {tol})")
    return {"steps": len(steps), "step_loss_max_diff": step_diff,
            "val_loss_max_diff": val_diff}


def q_inprocess(root: str, processed: str, batches: tuple, *, bf16: bool,
                stages: str, schedule: str, m: int, epochs: int,
                base: dict, device, whole: dict | None = None) -> dict:
    """One in-process ``MpmdTrainer`` fit held to ``base`` (train_job's
    trajectory, :func:`_q_seq_key`): its steps and val losses, each
    stage's launches exactly :func:`mpmd_launches`, its step ms,
    samples/s and the last step's bubble report; ``whole``'s (the
    whole-batch run's) differences printed beside them."""
    from dct_tpu_torch.train.mpmd_trainer import MpmdTrainer

    p = len(stages.split(","))
    name = f"{_q_dtype(bf16)}-{stages.replace(',', '')}-{schedule}-m{m}"
    cfg = _q_cfg(root, name, processed, bf16=bf16, stages=stages,
                 schedule=schedule, m=m, epochs=epochs)
    shutil.rmtree(cfg.data.models_dir, ignore_errors=True)
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = MpmdTrainer(cfg, device=device).fit()
    wall = time.perf_counter() - t0
    want = mpmd_launches(batches, epochs, stages=p, microbatches=m)
    if DEVICE == "cuda" and any(s != want for s in res.stage_launches):
        raise AssertionError(f"(q) {name}: stage launches "
                             f"{res.stage_launches}, want {want} a stage")
    out = {"stages": stages, "schedule": schedule, "microbatches": m,
           "dtype": _q_dtype(bf16), "epochs": epochs,
           **_q_check(name, {"step_losses": res.step_losses,
                             "val_losses": res.val_losses}, base,
                      MPMD_TOL["1" if bf16 else "0"]),
           "val_losses": res.val_losses,
           **({"whole_batch_step_loss_max_diff": max(
               abs(a - b) for a, b in zip(res.step_losses,
                                          whole["step_losses"])),
               "whole_batch_val_loss_max_diff": max(
                   abs(a - b) for a, b in zip(res.val_losses,
                                              whole["val_losses"]))}
              if whole else {}),
           "step_ms": 1e3 * statistics.median(res.step_seconds),
           "samples_per_s": MESH_BATCH / statistics.median(res.step_seconds),
           "stage_launches": res.stage_launches, "wall_s": wall,
           "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                    if DEVICE == "cuda" else None),
           "bubble": res.bubble}
    print(f"[smoke] (q) {name}: {json.dumps(out)}", flush=True)
    return out


def _free_port_block(n: int) -> int:
    """A base port whose next ``n`` ports were free a moment ago."""
    import socket

    for _ in range(50):
        base = _free_port()
        if base + n >= 65535:
            continue
        socks = []
        try:
            for i in range(1, n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", base + i))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free port block")


def _q_world(root: str, name: str, processed: str, *, bf16: bool,
             on_start=None, **extra) -> dict:
    """``resilience.supervise --world-size 2 -- mpmd_worker`` at ``1,1``
    on one card (``DCT_DEVICE``), run to its end; ``on_start(proc,
    env)`` on a thread once it is up."""
    env = {k: str(v) for k, v in _q_env(
        root, name, processed, bf16=bf16,
        DCT_MPMD_PORT_BASE=_free_port_block(3),
        DCT_MPMD_TRANSFER_TIMEOUT_S=300,
        DCT_DEVICE="cuda:0" if DEVICE == "cuda" else "cpu",
        **extra).items()}
    log = open(os.path.join(root, f"{name}.log"), "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dct_tpu_torch.resilience.supervise",
         "--world-size", "2", "--backoff", "1", "--",
         sys.executable, "-m", "dct_tpu_torch.train.mpmd_worker"],
        env=env, cwd=HERE, stdout=subprocess.PIPE, stderr=log, text=True)
    _Q_PROCS.append(proc)
    watcher = None
    if on_start is not None:
        watcher = threading.Thread(target=on_start, args=(proc, env),
                                   daemon=True)
        watcher.start()
    try:
        out, _ = proc.communicate(timeout=MPMD_WORLD_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        log.close()
        if watcher is not None:
            watcher.join(timeout=10)
    events = _events_of(env)
    reports = _named(events, "mpmd.step_report")
    launches = {k: [json.loads(x.split(" launches ", 1)[1])
                    for x in out.splitlines()
                    if x.startswith(f"[mpmd_worker s{k}] launches ")]
                for k in (0, 1)}
    memory = {k: [json.loads(x.split(" memory ", 1)[1])
                  ["max_memory_allocated"] for x in out.splitlines()
                  if x.startswith(f"[mpmd_worker s{k}] memory ")]
              for k in (0, 1)}
    return {"name": name, "exit": proc.returncode, "env": env,
            "events": events, "wall_s": time.perf_counter() - t0,
            "val_losses": [r["val_loss"] for r in reports],
            "train_losses": [r["train_loss"] for r in reports],
            "epochs_reported": [r["epoch"] for r in reports],
            "launches": launches, "memory": memory,
            "models": env["DCT_MODELS_DIR"], "log": log.name}


def _sigterm_stages_in(epoch: int, signalled: dict):
    """An ``on_start`` that SIGTERMs both stage processes (their
    heartbeat files' pids) once both beat in ``epoch``."""
    import signal

    from dct_tpu_torch.observability.heartbeat import (
        heartbeat_path,
        read_heartbeat,
    )

    def watch(proc, env):
        while proc.poll() is None:
            beats = [read_heartbeat(heartbeat_path(env["DCT_HEARTBEAT_DIR"],
                                                   k)) for k in (0, 1)]
            if all(b and b.get("epoch") == epoch and b.get("phase") == "train"
                   for b in beats):
                signalled["at"] = time.time()
                for b in beats:
                    os.kill(int(b["pid"]), signal.SIGTERM)
                return
            time.sleep(0.05)

    return watch


def _stage_file_leaves(models: str, k: int) -> list[np.ndarray]:
    path = os.path.join(models, "train_state_mpmd", f"stage{k}", "p0",
                        "state", "state.npz")
    with np.load(path) as npz:
        return [npz[str(i)] for i in range(len(npz.files))]


def _q_pivots(root: str, processed: str, worker: dict, seq: dict,
              device) -> dict:
    """Both pivots, bitwise on every leaf: the worker's stage files merged
    by ``train_job``'s resume (its ``mpmd.pivot`` digest against this
    process's merge of the same files, and this process's adoption
    against the files, leaf by leaf), and ``train_job``'s train_state
    split by the worker world's resume (each stage's ``mpmd.pivot``
    digest against this process's split)."""
    from dct_tpu_torch.checkpoint.manager import (
        TrainStateCheckpointer,
        state_leaves,
    )
    from dct_tpu_torch.data.dataset import load_processed_dataset
    from dct_tpu_torch.parallel import mpmd
    from dct_tpu_torch.train import mpmd_trainer as mt

    cfg = _q_cfg(root, "pivot", processed, bf16=False, stages=MPMD_STAGES,
                 schedule="1f1b", m=4, epochs=1)
    dim = load_processed_dataset(processed).input_dim

    def template():
        return mt.build_full_state(cfg, dim, device=device)

    # MPMD -> SPMD, in this process: every merged leaf is its stage's.
    adopt_dir = os.path.join(root, "models-pivot-adopt")
    shutil.rmtree(adopt_dir, ignore_errors=True)
    shutil.copytree(worker["models"], adopt_dir)
    shutil.rmtree(os.path.join(adopt_dir, "train_state"), ignore_errors=True)
    mt.adopt_mpmd_checkpoint(adopt_dir, template())
    adopted = TrainStateCheckpointer(os.path.join(
        adopt_dir, "train_state", "p0")).restore(template())
    leaves = 0
    for k in range(2):
        got = state_leaves(mpmd.split_state(adopted, k, 2))
        want = _stage_file_leaves(worker["models"], k)
        if len(got) != len(want) or not all(
                np.array_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"(q) adopt: stage {k}'s leaves differ")
        leaves += len(got)
    merged = mpmd.merge_stage_states(
        [mt.stage_checkpointer(worker["models"], k).restore(
            mpmd.split_state(template(), k, 2)) for k in range(2)],
        template())
    want_merged = mt.state_digest(merged)
    want_split = [mt.state_digest(mpmd.split_state(
        TrainStateCheckpointer(os.path.join(
            seq["models"], "train_state", "p0")).restore(template()), k, 2))
        for k in range(2)]
    del adopted, merged

    # Through the entry points: train_job adopts the worker's files, the
    # worker world splits train_job's train_state, side by side.
    job_dir = os.path.join(root, "models-pivot-job")
    split_name = "pivot-split"
    split_dir = os.path.join(root, f"models-{split_name}")
    for d, src in ((job_dir, worker["models"]), (split_dir, seq["models"])):
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(src, d)
    shutil.rmtree(os.path.join(job_dir, "train_state"), ignore_errors=True)
    job = _q_sequential(root, "pivot-job", processed, bf16=False, epochs=1,
                        DCT_RESUME=1, DCT_MODELS_DIR=job_dir)
    split = {}
    splitter = threading.Thread(target=lambda: split.update(_q_world(
        root, split_name, processed, bf16=False, epochs=1, DCT_RESUME=1)))
    splitter.start()
    job_run = _finish_world(job, MPMD_WORLD_S)
    splitter.join()
    job_pivots = _named(_events_of(job["env"]), "mpmd.pivot")
    split_pivots = sorted(_named(split["events"], "mpmd.pivot"),
                          key=lambda e: e["stage"])
    job_meta = TrainStateCheckpointer(os.path.join(
        job_dir, "train_state", "p0")).load_meta()
    out = {"adopt_leaves_bitwise": leaves,
           "train_job_adopt": {
               "digest_equal": [e.get("digest") for e in job_pivots]
               == [want_merged],
               "epochs_completed": job_meta.get("epochs_completed"),
               "val_loss": job_run["ranks"][0]["val_loss"]},
           "worker_split": {
               "exit": split["exit"],
               "digests_equal": [e.get("digest") for e in split_pivots]
               == want_split,
               "epochs_reported": split["epochs_reported"]}}
    if not (out["train_job_adopt"]["digest_equal"]
            and [e["direction"] for e in job_pivots] == ["mpmd_to_spmd"]
            and job_meta.get("epochs_completed") == MPMD_EPOCHS[False] + 1
            and split["exit"] == 0 and out["worker_split"]["digests_equal"]
            and [e["direction"] for e in split_pivots]
            == ["spmd_to_mpmd"] * 2
            and split["epochs_reported"] == [MPMD_EPOCHS[False]]):
        raise AssertionError(f"(q) pivots: {out}")
    print(f"[smoke] (q) pivots {json.dumps(out)}", flush=True)
    return {"pivots": out, "launches": [job_run["ranks"][0]["launches"],
                                        *split["launches"][0],
                                        *split["launches"][1]]}


def _q_worker_check(run: dict, inproc: dict, seq: dict, *, bf16: bool,
                    drill: bool, batches: tuple, signalled: dict) -> dict:
    """The supervised worker world against the in-process run and
    train_job: exit 0, the manifest and both stage files, one step report
    an epoch, each stage's launches a whole attempt's; with ``drill`` the
    SIGTERM in epoch index 1: both stages exit 75 and report
    ``preempted``, one free relaunch resumes every stage, no epoch runs
    twice."""
    from dct_tpu_torch.train import mpmd_trainer as mt

    tag = f"worker {_q_dtype(bf16)}"
    ev = run["events"]
    manifest = mt.read_manifest(run["models"])
    files = [os.path.exists(os.path.join(
        run["models"], "train_state_mpmd", f"stage{k}", "p0", "state",
        "state.npz")) for k in (0, 1)]
    per_epoch = mpmd_launches(batches, 1, stages=2, microbatches=4)
    one = {k: per_epoch["train"][k] + per_epoch["eval"][k]
           for k in per_epoch["train"]}
    epochs = MPMD_EPOCHS[bf16]
    epochs_by_attempt = [2, epochs - 2] if drill else [epochs]
    want_launches = [{k: n * v for k, v in one.items()}
                     for n in epochs_by_attempt]
    exits = [e["returncode"] for e in _named(ev, "rank_exit")]
    done = _named(ev, "mpmd.stage_done")
    relaunch = _named(ev, "restart.relaunch")
    ok = (run["exit"] == 0 and all(files)
          and manifest.get("epochs_completed") == epochs
          and run["epochs_reported"] == list(range(epochs))
          and (DEVICE != "cuda" or all(run["launches"][k] == want_launches
                                       for k in (0, 1))))
    if drill:
        ok = ok and ("at" in signalled
                     and sorted(exits) == [0, 0, 75, 75]
                     and sorted((e["stage"], e["preempted"])
                                for e in done)
                     == [(0, False), (0, True), (1, False), (1, True)]
                     and [e["classification"] for e in relaunch]
                     == ["preempted"])
    out = {"exit": run["exit"], "wall_s": run["wall_s"],
           "rank_exits": exits,
           "stage_done": [(e["stage"], e["preempted"]) for e in done],
           "relaunches": [e["classification"] for e in relaunch],
           "manifest_epochs": manifest.get("epochs_completed"),
           "val_losses": run["val_losses"],
           "val_loss_diff_inprocess": abs(run["val_losses"][-1]
                                          - inproc["val_losses"][-1])
           if run["val_losses"] else None,
           "val_loss_diff_train_job": abs(run["val_losses"][-1]
                                          - seq["val_losses"][-1])
           if run["val_losses"] else None,
           "launches": run["launches"],
           "max_memory_allocated": run["memory"]}
    if drill and "at" in signalled:
        saved = [e for e in _named(ev, "resume_state_saved")
                 if e["ts"] >= signalled["at"]]
        out["saved_after_signal_s"] = (saved[0]["ts"] - signalled["at"]
                                       if saved else None)
    key = "1" if bf16 else "0"
    if not (ok and out["val_loss_diff_inprocess"] is not None
            and out["val_loss_diff_inprocess"] <= MPMD_WORKER_TOL[key]
            and out["val_loss_diff_train_job"] <= MPMD_TOL[key]):
        raise AssertionError(f"(q) {tag}: {out}; log {run['log']}")
    print(f"[smoke] (q) {tag}{' SIGTERM drill' if drill else ''}: "
          f"{json.dumps(out)}", flush=True)
    return out


def check_q_rank_shapes(fa) -> list[dict]:
    """The three kernels against their plain versions at (q)'s stage
    microbatch shapes ``[B/M, H, T, D]``: ``[8, 8]`` (M=2) and ``[4, 8]``
    (M=4); f32 and bf16, not causal, FWD_TOL and BWD_TOL."""
    h, t = MESH_CFG["n_heads"], MESH_CFG["seq_len"]
    d = MESH_CFG["d_model"] // h
    gen = torch.Generator(device="cuda").manual_seed(17)
    return [_rank_shape_row(fa, gen, (b, h, t, d), dtype, g_lse=False,
                            where="(q0)")
            for b in (MESH_BATCH // 2, MESH_BATCH // 4)
            for dtype in (torch.float32, torch.bfloat16)]


def q_one_card(fa, root: str, counted=None) -> dict:
    """(q0) on any count of cards (module docstring); ``counted`` is held
    around the parts that launch in this process. ``root`` is emptied
    first."""
    try:
        return _q_one_card(fa, root, counted)
    except BaseException:
        _q_stop_children()
        raise


def _q_one_card(fa, root: str, counted) -> dict:
    lock = counted or contextlib.nullcontext()
    device = "cuda:0" if DEVICE == "cuda" else "cpu"
    with lock:
        rank_shapes = check_q_rank_shapes(fa) if DEVICE == "cuda" else []
    shutil.rmtree(root, ignore_errors=True)
    processed = _pp_rows(root)
    batches = _mesh_batches(processed)
    # The children first: train_job f32 and bf16 (the sequential runs:
    # :func:`_q_seq_key`) and the supervised worker worlds, f32 with the
    # SIGTERM drill.
    seq_keys = sorted({(bf16, _q_seq_key(bf16, m)) for bf16 in (False, True)
                       for _, m, _ in MPMD_RUNS} | {(True, None)}, key=str)
    seq_started = {
        (bf16, key): _q_sequential(
            root, f"seq-{_q_dtype(bf16)}" + (f"-accum{key}" if key else ""),
            processed, bf16=bf16, epochs=MPMD_EPOCHS[bf16],
            **_q_seq_env(bf16, key))
        for bf16, key in seq_keys}
    signalled: dict = {}
    workers: dict = {}

    def run_workers():
        drill = threading.Thread(target=lambda: workers.update({False: _q_world(
            root, "worker-f32", processed, bf16=False,
            epochs=MPMD_EPOCHS[False],
            on_start=_sigterm_stages_in(1, signalled))}))
        drill.start()
        workers[True] = _q_world(root, "worker-bf16", processed, bf16=True,
                                 epochs=MPMD_EPOCHS[True])
        drill.join()

    worker_thread = threading.Thread(target=run_workers, daemon=True)
    worker_thread.start()
    seq = {k: _finish_world(w, MPMD_WORLD_S)
           for k, w in seq_started.items()}
    base = {k: _q_trajectory(dict(run, env=seq_started[k]["env"]))
            for k, run in seq.items()}
    for (bf16, key), b in base.items():
        if len(b["step_losses"]) != MPMD_EPOCHS[bf16] * batches[0] or len(
                b["val_losses"]) != MPMD_EPOCHS[bf16]:
            raise AssertionError(f"(q0) train_job {_q_dtype(bf16)} {key}: "
                                 f"{len(b['step_losses'])} step losses, "
                                 f"{b['val_losses']}")
        print(f"[smoke] (q0) train_job {_q_dtype(bf16)} accumulating "
              f"{key or 1}: {json.dumps(b['fit'])}", flush=True)
    inproc = {}
    with lock:
        for bf16 in (False, True):
            for schedule, m, long in MPMD_RUNS:
                inproc[(bf16, schedule, m)] = q_inprocess(
                    root, processed, batches, bf16=bf16, stages=MPMD_STAGES,
                    schedule=schedule, m=m,
                    epochs=MPMD_EPOCHS[bf16] if long else 1,
                    base=base[(bf16, _q_seq_key(bf16, m))], device=device,
                    whole=base[(bf16, None)] if bf16 else None)
    from dct_tpu_torch.parallel.mpmd import analytic_bubble, measured_bubble

    bubbles = {}
    for bf16 in (False, True):
        t2 = inproc[(bf16, "1f1b", 2)]["step_ms"]
        t4 = inproc[(bf16, "1f1b", 4)]["step_ms"]
        bubbles[_q_dtype(bf16)] = {
            "step_ms_m2": t2, "step_ms_m4": t4,
            "analytic_m2": analytic_bubble(2, 2),
            "analytic_m4": analytic_bubble(2, 4),
            "measured_m2": measured_bubble(t2, t4, 2, 4),
            "stages_m4": inproc[(bf16, "1f1b", 4)]["bubble"]["stages"]}
    print(f"[smoke] (q0) bubbles (global batch {MESH_BATCH}, so the "
          f"microbatch halves from M=2 to M=4): {json.dumps(bubbles)}",
          flush=True)
    worker_thread.join()
    checked = {_q_dtype(bf16): _q_worker_check(
        workers[bf16], inproc[(bf16, "1f1b", 4)],
        base[(bf16, _q_seq_key(bf16, 4))], bf16=bf16, drill=not bf16,
        batches=batches, signalled=signalled)
        for bf16 in (False, True)}
    # The pivots launch no kernel here (copies and digests).
    pivots = _q_pivots(root, processed, workers[False],
                       seq[(False, None)], device)
    launches = {k: 0 for k in ("flash_fwd", "flash_bwd_dkdv",
                               "flash_bwd_dq")}
    for counts in ([r["launches"] for run in seq.values()
                    for r in run["ranks"]]
                   + [c for w in workers.values()
                      for k in (0, 1) for c in w["launches"][k]]
                   + pivots["launches"]
                   + [s[part] for r in inproc.values()
                      for s in r["stage_launches"]
                      for part in ("train", "eval")]):
        for k in launches:
            launches[k] += counts[k]
    out = {"rank_shapes": rank_shapes,
           "train_job": {f"{_q_dtype(b)} accumulating {k or 1}":
                         base[(b, k)]["fit"] for b, k in base},
           "inprocess": {f"{_q_dtype(b)} {s} M={m}": r
                         for (b, s, m), r in inproc.items()},
           "bubbles": bubbles, "workers": checked,
           "pivots": pivots["pivots"], "launches": launches,
           "batches": batches, "processed": processed}
    print(f"[smoke] (q0) launches {launches}", flush=True)
    return out


def q1_runs(root: str, processed: str, batches: tuple, out: dict) -> dict:
    """(q1) on four cards: ``1,1,1,1`` (one layer a stage) with 1f1b and
    gpipe and ``1,1`` on two cards, f32 and bf16, one epoch each, against
    one card's train_job from the same init (``n_stages`` 4 or 2;
    :func:`_q_seq_key` at M 4); each stage on its own card. Returns the
    launches."""
    starts = {}
    for stages in ("1,1,1,1", "1,1"):
        for bf16 in (False, True):
            name = f"q1-seq-{stages.replace(',', '')}-{_q_dtype(bf16)}"
            starts[(stages, bf16)] = _q_sequential(
                root, name, processed, bf16=bf16, stages=stages, epochs=1,
                **_q_seq_env(bf16, _q_seq_key(bf16, 4)))
    base = {key: _q_trajectory(dict(_finish_world(w, MPMD_WORLD_S),
                                    env=w["env"]))
            for key, w in starts.items()}
    launches = {k: 0 for k in ("flash_fwd", "flash_bwd_dkdv",
                               "flash_bwd_dq")}
    for b in base.values():
        for k in launches:
            launches[k] += b["launches"][k]
    for stages, schedule in MPMD_Q1:
        for bf16 in (False, True):
            r = q_inprocess(root, processed, batches, bf16=bf16,
                            stages=stages, schedule=schedule, m=4, epochs=1,
                            base=base[(stages, bf16)], device=None)
            r["train_job"] = base[(stages, bf16)]["fit"]
            out["q1"][f"{_q_dtype(bf16)} {stages} {schedule}"] = r
            for s in r["stage_launches"]:
                for part in ("train", "eval"):
                    for k in launches:
                        launches[k] += s[part][k]
    return launches


def mpmd_phase(fa, root: str, card: str, q0: dict | None = None) -> dict:
    """(q) (module docstring): (q0) on any count of cards (unless given),
    (q1) on four; one line saying it did not run on fewer."""
    t_phase = time.perf_counter()
    if q0 is None:
        q0 = q_one_card(fa, os.path.join(root, "q0"))
    cards = torch.cuda.device_count()
    out = {"q0": {k: q0[k] for k in ("rank_shapes", "train_job",
                                      "inprocess", "bubbles", "workers",
                                      "pivots")},
           "launches": dict(q0["launches"])}
    if cards < 4:
        print(json.dumps({"phase": "q", "ran": False, "cards": cards}),
              flush=True)
        return out
    out.update(ran=True, cards=cards, card=card, q1={})
    try:
        q1 = q1_runs(root, q0["processed"], q0["batches"], out)
    except BaseException:
        _q_stop_children()
        raise
    for k in out["launches"]:
        out["launches"][k] += q1[k]
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[smoke] (q) MPMD on {cards} cards, launches {out['launches']}, "
          f"phase {out['phase_s']:.1f} s on {card}", flush=True)
    print(f"[smoke] (q) summary {json.dumps(out)}", flush=True)
    with open(os.path.join(root, "phase_q.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase",
                    choices=("all", "k", "l", "m", "n", "n3", "o", "p",
                             "q"),
                    default="all",
                    help="k: build the kernels and run only (k), over a "
                         "random full-width checkpoint and synthetic rows; "
                         "l: only (l), over synthetic rows; m: only (m), "
                         "the model axis, on two or more cards; n: only "
                         "(n), the seq axis (its worlds on two or more "
                         "cards); n3: only (n3), the MoE, the GRU and "
                         "ZeRO-1/FSDP on the seq axis; o: only (o), the "
                         "engines on a mesh, the re-map and per-layer FSDP "
                         "(its worlds on four cards); p: only (p), the pipe "
                         "axis (its worlds on four cards); q: only (q), "
                         "the MPMD pipeline ((q1) on four cards)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    walls: dict = {}

    def walled(name, fn, *a, **kw):
        """``fn(*a, **kw)``, its wall printed on its own line and kept."""
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            walls[name] = round(time.perf_counter() - t0, 3)
            print(f"[smoke] wall {name}: {walls[name]:.1f} s", flush=True)

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from dct_tpu_torch.device import resolve_device
    from dct_tpu_torch.ops import build
    from dct_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    device = resolve_device()  # raises unless capability 9.0
    cap = torch.cuda.get_device_capability(device)
    print(f"[smoke] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, capability {cap[0]}.{cap[1]}", flush=True)

    t0 = time.perf_counter()
    build.load_kernels("flash_fwd", "flash_bwd")
    build_s = time.perf_counter() - t0
    walls["build"] = round(build_s, 3)
    for name in ("flash_fwd", "flash_bwd"):
        info = build.build_info[name]
        print(f"[smoke] {'built' if info['built'] else 'reused'} {name} "
              f"(parallel build {build_s:.1f} s): {info['path']}", flush=True)
        for fn, rep in ptxas_report(info["log"]).items():
            print(f"[smoke]   ptxas: {fn}: {rep}", flush=True)
            tensor_core = any(tag in fn
                              for _, tag in TENSOR_CORE_SASS.values())
            if tensor_core and (rep.get("spill_bytes", 0) > 0
                                or "ptxas_warning" in rep):
                raise AssertionError(f"tensor-core kernel {fn}: {rep}")
    tc_counts = tensor_core_instructions(build)
    print(f"[smoke] tensor-core instructions: {tc_counts}", flush=True)

    engines_root = os.path.join(HERE, "build", "chip_smoke_engines")
    pipe_root = os.path.join(HERE, "build", "chip_smoke_pipe")
    mpmd_root = os.path.join(HERE, "build", "chip_smoke_mpmd")
    if args.phase in ("m", "n", "n3", "o", "p", "q"):
        if args.phase == "m":
            model_axis_phase(os.path.join(HERE, "build", "chip_smoke_mesh"),
                             card)
        elif args.phase == "o":
            walled("engines", mesh_engines_phase, fa, engines_root, card)
        elif args.phase == "p":
            walled("pipe", pipeline_phase, fa, pipe_root, card)
        elif args.phase == "q":
            walled("mpmd", mpmd_phase, fa, mpmd_root, card)
        else:
            sequence_phase(os.path.join(HERE, "build", "chip_smoke_seq"),
                           card, n3_only=args.phase == "n3")
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}), flush=True)
        return 0
    if args.phase in ("k", "l"):
        probe_root = os.path.join(HERE, "build", "chip_smoke_probe")
        shutil.rmtree(probe_root, ignore_errors=True)
        ckpt, processed = serving_probe(probe_root)
        if args.phase == "k":
            serving_phase(fa, os.path.join(HERE, "build",
                                           "chip_smoke_serving"),
                          ckpt, processed, card)
        else:
            families_phase(fa, os.path.join(HERE, "build",
                                            "chip_smoke_families"),
                           processed, card)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}), flush=True)
        return 0

    variants = walled("kernels_fwd", check_flash_kernel, fa)
    bwd_variants = walled("kernels_bwd", check_bwd_kernels, fa)

    pkg_root = os.path.join(HERE, "build", "chip_smoke_packages")
    served = [
        walled(f"serve_{family}_{quant}", serve_package, family,
               os.path.join(pkg_root, f"{family}-{quant}"), fa, quant)
        for family, quant in (("weather_transformer", None),
                              ("weather_transformer_causal", None),
                              ("weather_transformer", "bf16"))
    ]
    launches = sum(s["launches"] for s in served)
    forwards = sum(s["forwards"] for s in served)

    trained = walled("train", train_phase, fa)
    train_counts = {name: sum(r["launches"][name] for r in trained["b"])
                    for name in ("flash_fwd", "flash_bwd_dkdv",
                                 "flash_bwd_dq")}
    train_steps = sum(r["steps"] for r in trained["b"])

    repairs = walled("repairs", check_repairs, fa)
    fit_root = os.path.join(HERE, "build", "chip_smoke_fit")
    b_bf16 = [r for r in trained["b"] if r["family"] == "weather_transformer"
              and r["compute"] == "bf16"][0]
    fitted = walled("fit_transformer", fit_transformer_phase, fa, fit_root,
                    b_bf16["step_ms"])
    fit_counts = fitted["launches"]
    print(f"[smoke] (g) trainer overhead: fit's device step median "
          f"{fitted['step_ms_events_median']:.3f} ms, its epoch "
          f"{fitted['epoch_ms_per_train_step']:.3f} ms per train step, "
          f"(b)'s step median {b_bf16['step_ms']:.3f} ms", flush=True)

    # From here four chains share the card. This thread and the (l) chain
    # run the phases that read this process's launch counts, one at a
    # time (``counted``); the other two drive child processes (whose
    # launches their outputs carry) and (f), which runs no flash kernel.
    # The phases that must have the card to themselves come last.
    loop_root = os.path.join(HERE, "build", "chip_smoke_loop")
    shutil.rmtree(loop_root, ignore_errors=True)  # (h) starts from nothing
    sup_root = os.path.join(HERE, "build", "chip_smoke_supervised")
    shutil.rmtree(sup_root, ignore_errors=True)  # (i) starts from nothing
    sched_root = os.path.join(HERE, "build", "chip_smoke_scheduler")
    shutil.rmtree(sched_root, ignore_errors=True)  # (j) starts from nothing
    fam_root = os.path.join(HERE, "build", "chip_smoke_families")
    shutil.rmtree(fam_root, ignore_errors=True)  # (l) starts from nothing
    counted = threading.Lock()
    # (h1) sets the process's DCT_* environment; set before the chains
    # start, which read it.
    _set_dct_env(_loop_env(os.path.join(loop_root, "episodic")))

    # (p0) starts once (i)'s drills have ended: their SIGTERM and stall
    # timings are what a busier card would move.
    drills_done = threading.Event()

    def supervised_then_quota():
        try:
            supervised = walled("supervised", supervised_phase, sup_root,
                                card)
        finally:
            drills_done.set()
        return supervised, walled("scheduler_quota", scheduler_quota,
                                  sched_root, card)

    def mlp_then_loop_job():
        walled("fit_mlp", fit_mlp_phase, fit_root)
        walled("etl", etl_phase, os.path.join(loop_root, "etl"), card)
        walled("loop_job", loop_job_phase,
               os.path.join(loop_root, "loop_job"), card)
        o0 = walled("o0", o_one_card, fa,
                    os.path.join(engines_root, "o0"), counted)
        return o0, walled("q0", q_one_card, fa,
                          os.path.join(mpmd_root, "q0"), counted)

    def families_then_pipe():
        rows = synthetic_rows(os.path.join(fam_root, "rows"))
        fam = walled("families", families_phase, fa,
                     os.path.join(fam_root, "phase"), rows, card, counted)
        drills_done.wait()
        return fam, walled("p0", p_one_card, fa,
                           os.path.join(pipe_root, "p0"), counted)

    with ThreadPoolExecutor(3) as pool:
        chain_i = pool.submit(supervised_then_quota)
        chain_f = pool.submit(mlp_then_loop_job)
        chain_l = pool.submit(families_then_pipe)
        with counted:
            episodic = walled("episodic", episodic_phase, fa,
                              os.path.join(loop_root, "episodic"), card)
        loop_counts = episodic["launches"]
        served_k = walled(
            "serving", serving_phase, fa,
            os.path.join(HERE, "build", "chip_smoke_serving"),
            os.path.join(fit_root, "models-tf", "last.ckpt"),
            os.path.join(loop_root, "episodic", "processed"), card, counted)
        k_counts = served_k["launches"]
        families_out, p0 = chain_l.result()
        l_counts = families_out["launches"]
        supervised, quota = chain_i.result()
        o0, q0 = chain_f.result()
    torch.cuda.empty_cache()  # the drills below read the card alone
    hang = walled("hang_drill", hang_drill, sup_root, card,
                  supervised["clean_env"], supervised["per_epoch"])
    sup_counts = {k: v + hang["launches"][k]
                  for k, v in supervised["launches"].items()}
    sched = walled("scheduler_revocation", scheduler_phase, sched_root,
                   card, supervised["clean_models_dir"], quota)
    sched_counts = sched["launches"]
    mesh = walled("model_axis", model_axis_phase,
                  os.path.join(HERE, "build", "chip_smoke_mesh"), card)
    m_counts = mesh["launches"]
    torch.cuda.empty_cache()
    seq = walled("seq_axis", sequence_phase,
                 os.path.join(HERE, "build", "chip_smoke_seq"), card)
    n_counts = seq["launches"]
    engines = walled("engines", mesh_engines_phase, fa, engines_root, card,
                     o0)
    o_predict, o_fsdp = engines["predict_launches"], engines["fsdp_launches"]
    o_remap = engines["remap_launches"]
    p_counts = walled("pipe", pipeline_phase, fa, pipe_root, card,
                      p0)["launches"]
    q_counts = walled("mpmd", mpmd_phase, fa, mpmd_root, card,
                      q0)["launches"]

    def bf16_summary(rows):
        row = [r for r in rows
               if r["dtype"] == "bfloat16" and not r["causal"]][0]
        return {"ms": row["ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "bound_basis": row["bound_basis"],
                "library_ms": row["library_ms"],
                "plain_ms": row["plain_ms"], "max_err": row["max_abs_err"],
                "causal": False}

    head = variants[0]  # f32, not causal: the first package's shape
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "dct_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "dct_tpu/ops/pallas_attention.py:81 (_flash_fwd_kernel; "
                    "pallas_call at :260)",
        "launches": (launches + train_counts["flash_fwd"]
                     + fit_counts["flash_fwd"]
                     + loop_counts["train"]["flash_fwd"]
                     + loop_counts["gate"]["flash_fwd"]
                     + sup_counts["flash_fwd"]
                     + sched_counts["flash_fwd"]
                     + k_counts["serve_k"] + k_counts["predict"]
                     + k_counts["knobs"]["flash_fwd"]
                     + l_counts["flash_fwd"] + m_counts["flash_fwd"]
                     + n_counts["flash_fwd"] + o_predict["flash_fwd"]
                     + o_fsdp["flash_fwd"] + o_remap["flash_fwd"]
                     + p_counts["flash_fwd"] + q_counts["flash_fwd"]),
        "launches_by_path": {"serve": launches,
                             "train": train_counts["flash_fwd"],
                             "fit": fit_counts["flash_fwd"],
                             "loop_train": loop_counts["train"]["flash_fwd"],
                             "gate": loop_counts["gate"]["flash_fwd"],
                             "supervised": sup_counts["flash_fwd"],
                             "scheduler": sched_counts["flash_fwd"],
                             "serve_k": k_counts["serve_k"],
                             "predict": k_counts["predict"],
                             "knobs": k_counts["knobs"]["flash_fwd"],
                             "families": l_counts["flash_fwd"],
                             "model_axis": m_counts["flash_fwd"],
                             "sequence_parallel": n_counts["flash_fwd"],
                             "predict_mesh": o_predict["flash_fwd"],
                             "fsdp_layers": o_fsdp["flash_fwd"],
                             "remap": o_remap["flash_fwd"],
                             "pipeline": p_counts["flash_fwd"],
                             "mpmd": q_counts["flash_fwd"]},
        "gate_launches_per_consult": loop_counts["gate"]["flash_fwd"],
        "max_abs_err": head["max_abs_err"], "ms": head["ms"],
        "kernel_ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "bound_basis": head["bound_basis"],
        "library_ms": head["library_ms"],
        "launches_per_forward": launches / forwards,
        "bf16": bf16_summary(variants),
        "tensor_core_instructions": tc_counts["flash_fwd"],
        "variants": variants,
    }]
    for name, line in (("flash_bwd_dkdv", 303), ("flash_bwd_dq", 373)):
        head = bwd_variants[name][0]  # f32, not causal
        call = 487 if name == "flash_bwd_dkdv" else 529
        kernels.append({
            "name": name, "route": "cuda",
            "source": "dct_tpu_torch/ops/csrc/flash_bwd.cu",
            "replaces": f"dct_tpu/ops/pallas_attention.py:{line} "
                        f"(_{name}_kernel; pallas_call at :{call})",
            "launches": (train_counts[name] + fit_counts[name]
                         + loop_counts["train"][name] + sup_counts[name]
                         + sched_counts[name] + k_counts["knobs"][name]
                         + l_counts[name] + m_counts[name]
                         + n_counts[name] + o_fsdp[name] + o_remap[name]
                         + p_counts[name] + q_counts[name]),
            "launches_by_path": {"train": train_counts[name],
                                 "fit": fit_counts[name],
                                 "loop_train": loop_counts["train"][name],
                                 "gate": loop_counts["gate"][name],
                                 "supervised": sup_counts[name],
                                 "scheduler": sched_counts[name],
                                 "serve_k": 0, "predict": 0,
                                 "knobs": k_counts["knobs"][name],
                                 "families": l_counts[name],
                                 "model_axis": m_counts[name],
                                 "sequence_parallel": n_counts[name],
                                 "predict_mesh": o_predict[name],
                                 "fsdp_layers": o_fsdp[name],
                                 "remap": o_remap[name],
                                 "pipeline": p_counts[name],
                                 "mpmd": q_counts[name]},
            "launches_per_step": train_counts[name] / train_steps,
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "kernel_ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "bound_basis": head["bound_basis"],
            "library_ms": head["library_ms"],
            "library_covers": head["library_covers"],
            "bf16": bf16_summary(bwd_variants[name]),
            "tensor_core_instructions": tc_counts[name],
            "variants": bwd_variants[name],
        })
    for k in kernels:
        k["grid_beyond_65535_ms"] = {dt: row["ms"][k["name"]]
                                     for dt, row in repairs["c2"].items()}
        # (n0): the ring's variants (q_offset, Tq != Tk, the lse
        # cotangent in the backward), each with its time and bound.
        k["sp_variants"] = [
            {"tq": r["tq"], "tk": r["tk"], "q_offset": r["q_offset"],
             "window": r["window"], "dtype": r["dtype"], **r[k["name"]],
             "plain_ms": r["plain_fwd_ms" if k["name"] == "flash_fwd"
                           else "plain_bwd_ms"],
             "library_ms": r["library_fwd_ms" if k["name"] == "flash_fwd"
                             else "library_bwd_ms"]}
            for r in seq["variants"]]
    walls["total"] = round(time.perf_counter() - t_start, 3)
    print(f"[smoke] walls {json.dumps(walls)} on {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
