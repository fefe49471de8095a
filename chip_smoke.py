"""On-card smoke test of the PyTorch/CUDA port (``ddlpc_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is caught:

1. the card's name and power limit (``nvidia-smi``), then the kernels'
   build from ``ddlpc_tpu_torch/kernels/csrc`` with its time;
2. each gradient-codec kernel at the flagship U-Net's flat gradient size,
   held against its plain PyTorch version on the same inputs with
   ``torch.equal`` (bit-identical), and timed with CUDA events beside its
   bound, its achieved GB/s, the plain version and, where one exists, a
   single PyTorch call computing the same function.  The clock
   (``time_ms``) takes the median of 25 launches, each on a cold and clean
   L2: a 256 MB buffer written once is read whole before each launch, so
   the previous launch's dirty lines are written back outside the timed
   window, and a short spin then holds the stream so that the launch is
   queued before the window opens, which keeps host time out of the
   window; each wrapper's host time per call is measured apart
   (``host_ms``).  Beside the kernels it times the floor of plain data
   movement on the same clock, ``y.copy_(x)`` and ``x.sum()`` over the
   flagship's fp32 buffer.  Decode is timed on the fp16, int8 and int16
   wires.  ``encode_sr``'s and ``fake_quantize_sr``'s operations bounds
   count the instructions of their main loops in this build's SASS
   (``cuobjdump -sass``; ``fake_quantize_sr`` along its vector path).  The max-abs pass
   is also held against ``x.abs().amax()`` on NaN, ±inf, -0.0, subnormal,
   empty, odd-size and unaligned inputs.  The fake-quantize rows are timed
   as the main path calls them (in place: the max-abs pass, then the
   kernel) and the kernel alone.  The stochastic kernels are also held to
   each other (a _noise kernel fed the plain Philox field equals the _sr
   kernel), to the offset-slice property, and to unbiasedness over 64 keys;
3. small-input reference checks: the tiny U-Net trains two optimizer steps
   with the fp16 codec, and two with int8 stochastic rounding, on the card
   and on the CPU from the same weights, data and seed, and must agree;
   so do a tiny U-Net++ (deep supervision, bilinear up-sampling, group
   norm) and a tiny DeepLabV3+ (the stride-2 stem and 'SAME' pool, dilated
   blocks, ASPP), two steps each without a codec;
4. the main paths, each through the CLI's own entry (``parse_args`` →
   ``Trainer.fit``) on ``configs/vaihingen_unet_tpu_flagship.json`` as
   written (no ``--set`` but the epochs and the micro-batch) at full width
   and 512² tiles for three optimizer steps, with the kernels' launch
   counts set to 0 just before and read just after each run (each must
   equal the path's expected count: one launch a step of each codec
   kernel, two of the max-abs pass): first the config as it is (fp16
   codec, nearest rounding), whose three losses must be the committed bits
   (``FLAGSHIP_LOSSES``), then
   with ``compression.mode=int8, rounding=stochastic`` (which must warn
   about its large super-batch).  Every loss must be finite.  The config's
   own settings run: the device-resident tile cache, whose batches of
   every epoch must equal ``DeviceLoader``'s (``torch.equal``); a chunked
   (DWC2) checkpoint each epoch, written in the background, three kept;
   the stall watchdog; five PNG triples an epoch, whose last epoch's files
   must decode (zlib) to the palette of the final state's predictions, the
   labels and the images; and a ``kind="perf"`` record each epoch with the
   FLOP model's exact count (12,234,214,342,656 a step), the card's peak
   known and MFU > 0.  Each path prints its epochs' ``epoch_time_s``,
   ``step_time_s``, ``t_data_s``, MFU and goodput beside the card.  Then
   the host libraries on this machine's host (``host row``): the native
   gather of the epoch's 512 tiles against numpy's and ``index_select``,
   and the checkpoint wire's deflate and inflate against Python's zlib,
   with both zlib versions printed;

4a. ``traced``: the fp16 main path again (three steps, the same checks)
   with ``TRACED``: the span tracer with a sampled ``step_sync`` every
   step, the telemetry endpoint on an ephemeral port and epoch 2 under
   ``torch.profiler`` (``train.profile_epoch=2``), while a thread arms a
   one-step capture through ``GET /debug/trace?steps=1`` and scrapes
   ``/metrics`` (JSON and Prometheus text) and ``/healthz`` during the
   run.  The losses must be the committed bits and the codec's launches
   the untraced path's; ``spans.jsonl`` must hold 3 ``epoch``, 3
   ``step_sync``, 3 ``evaluate`` and 3 ``checkpoint_snapshot`` spans and
   the ``data`` and ``step`` stages, ``trace.json`` must load; every
   ``metrics.jsonl`` record must pass the port's ``obs/schema.check_record``;
   the scrape must show ``ddlpc_mfu``, ``ddlpc_goodput`` and
   ``ddlpc_train_loss``; ``top_ops_001.json`` must report the device plane
   with ``device_total_ms > 0``; and the epoch capture's ``ops.json`` must
   name a codec kernel.  The traced and untraced step times and the sizes
   of the trace and the captures are printed beside the card;

4b. the checkpoint phase, on the fp16 main path's run: every blob verifies;
   a fresh Trainer on a copy of the workdir whose newest checkpoint is
   epoch 1 resumes and runs epoch 2, whose loss must equal the
   uninterrupted epoch 2's bits; a blob with one flipped byte is
   quarantined and the restore falls back to the one before.  Then the
   same resume from epoch 1's state rewritten as a legacy monolithic blob
   (``ckpt_2.msgpack.z``, the port's flax msgpack codec; its ``.dwc``
   dropped) in another copy: it must verify with JAX's summary, resume to
   epoch 2's loss and canonical state bit for bit with one fp16 step's
   launches (``encode_to_wire``, ``decode_from_wire``,
   ``fake_quantize_fused`` one each, ``absmax`` two), and a copy with one
   flipped byte must be quarantined and fall back to ``ckpt_1.dwc``; the
   synchronous save and the restore of both formats on that tree, and
   their disk bytes, go into the row.  Then the
   save's cost on the live trainer: the training thread's stall (the
   snapshot into reusable pinned host buffers, and, for comparison, into
   new pageable ones), the background write, its GB/s, the restore, the
   raw and on-disk bytes, and a step's time with no save in flight and
   with one; then the write and the restore with the native wire and with
   Python's zlib, in turns.  It prints one ``checkpoint row`` JSON line;

4b''. the serve phase, from a copy of the fp16 main path's run (its
   ``config.json`` and checkpoints): the flagship U-Net served at full
   width through ``configs/serve_vaihingen.json`` as written.  In this
   process, per weight mode ``off``, ``int8`` and ``bf16``:
   ``InferenceEngine.from_workdir(device="cuda")``, ``warmup()``, the
   2566×1893 scene (35 windows), a ``reload()``, with the codec's launches
   set to 0 just before and read just after (int8: ``absmax`` and
   ``encode_to_wire`` once a param leaf at each restore, ``decode_from_wire``
   once a leaf a forward; the other modes none; the ``serve_int8`` path of
   the kernels line); the warmup's and the scene's forwards under the
   collective census, held to the program auditor's serve-arm contracts
   (``program.check_serve_forward``: no collective, int8 one decode a
   leaf and forward, 82 leaves, equal to the launches); ``hbm_bytes()`` exactly fp32 4 B, bf16 2 B, int8 1 B a
   param plus 4 B a leaf, and the bytes the restore's tensors request from
   the allocator the same (plus, at most, the max-abs pass's scratch); each bucket 1, 2, 4, 8: one forward's device
   ms on the kernel rows' clock and tiles/s, the whole ``forward_windows``
   on the host's, and the launches of one forward at 1 and 8 (profiler);
   two windows through a CPU engine of the same mode (max |Δlogit| ≤ 5e-2 ·
   max |logit| and ≥ 99 % of the classes equal: both compute in bf16) and
   the int8 and bf16 trees, and their dequantized weights, bit-equal
   between card and CPU.  Then three ``python -m
   ddlpc_tpu_torch.serve.server`` processes start on free ports while
   ``python -m ddlpc_tpu_torch.predict`` writes the class-map PNGs of two
   images, which must decode to the in-process engine's class maps; the
   first server answers ``/healthz`` (ready, the mode, the step), the scene
   (its class map must equal the in-process engine's of the config's
   mode), a load of 4 clients × 16 tiles plus 2 scenes in the bulk class
   (no error, shed or expired deadline; the ``/metrics`` quantiles and
   tiles/s printed), and a ``POST /reload`` to a newer checkpoint written
   while requests are in flight (all answered 200, the version and step
   advance); then each server is sent SIGTERM with a scene in flight: the
   scene is answered, the process exits 0 within ``drain_timeout_s`` and
   its stderr holds no "terminate called";

4e. the fleet phase, on the serve phase's run (its newest checkpoint):
   ``python -m ddlpc_tpu_torch.serve.fleet`` on ``configs/fleet_vaihingen.json``
   as written but for ``quantize: int8`` (a copy in the run directory) and
   a free ``--port``: three replicas on ``cuda:0``, each ready once its
   port file lands (the seconds of each are printed); the scene and four
   tiles through the router must give the serve phase's in-process int8
   engine's class maps, bit for bit; a smoke load (4 closed-loop clients,
   8 s: tiles/s and p50/p99 from the fleet's ``/metrics``, labelled smoke
   readings: the replicas time-share one card); one replica SIGKILLed
   under load, relaunched and readmitted (its seconds printed); a rolling
   reload to a newer checkpoint under load (every replica ends on its
   step); a reload to a newest blob with one flipped byte, which must
   come back aborted and leave every replica on the previous step; no
   client may see a non-200 through any of it; the fleet's ``/metrics``
   must carry ``ddlpc_router_*`` and ``ddlpc_fleet_*`` families and its
   ``/healthz`` the SLO status; then SIGTERM: the fleet exits 0 within
   ``drain_timeout_s``, every replica's last exit is 0 and no log holds
   "terminate called".  The codec's launches in the replicas are not
   counted but derived, and stand only in the fleet row's
   ``derived_launches``, never in a kernel row: restores
   and reloads × leaves for ``absmax`` and ``encode_to_wire``, forwards ×
   leaves for ``decode_from_wire``, the forwards read from the fleet's
   rollup of the replicas' ``ddlpc_serve_jit_cache_*`` counters plus the
   4 warmup forwards of each launch;

4f. the supervised phase: the fp16 main path's command (the flagship
   as written, three epochs) under ``resilience.supervisor.Supervisor``
   with the watchdog at 10 s; attempt 0 runs with ``DDLPC_CHAOS=kill@2``,
   attempt 1 with ``stall@2:120`` (the watchdog's exit 42), attempt 2
   clean.  The causes must be ``oom_kill``, ``stall``, ``clean``, each
   attempt a checkpoint further (no backoff), the supervisor's result ok,
   the epoch losses the committed bits and the final checkpoint's digest
   the uninterrupted run's.  Each attempt's wall and each restart's
   overhead (the child's death to the next child's ``fit`` and its first
   step) are printed; the codec's launches are derived from the steps run
   and stand only in the supervised row's ``derived_launches``;

4b'. ``flagship_options``: the flagship with every optimizer option of
   the JAX trainer and remat (``FLAGSHIP_OPTIONS``: AdamW with weight
   decay, a cosine schedule after one warmup step, clipping at global norm
   1) through the CLI's entry for three optimizer steps: finite losses,
   the fp16 codec's launches as on the main path, each step's rate the
   schedule's (0, lr, lr / 2), and its peak memory and step time printed
   beside the plain flagship's of the same run;

4c. the other models' main paths: ``configs/vaihingen_unetpp.json``,
   ``vaihingen_unetpp_s2d.json`` and ``potsdam_deeplabv3p.json`` as
   written (no ``--set`` but the epochs) at full width on 512² tiles,
   through the CLI's entry for ``ZOO_EPOCHS`` = 1 epoch each (7, 2 and 4
   optimizer steps; cut from two epochs to keep the script inside its
   time limit): finite losses, no codec kernel launched (``compression.mode``
   is ``none``), every epoch's ``perf`` record carrying the JAX package's
   conv FLOPs a step (12,480,638,091,264; 3,246,995,275,776;
   7,940,345,954,304), the PNG triples decoding to the eval forward's
   predictions (U-Net++'s ensemble readout), and the host loader's
   batches equal to ``DeviceLoader``'s.  Each prints its epochs' step
   time, MFU and goodput and its peak memory beside the card;

4c'. ``unetpp_remat``: ``configs/vaihingen_unetpp.json`` as written with
   ``train.remat=true``, ``REMAT_STEPS`` = 2 optimizer steps of the
   trainer's own step on its loader's first batches, from the ``unetpp``
   run's initial weights (held by digest): the first loss must be that
   run's bits, the second loss and every BatchNorm statistic within
   ``REMAT_RTOL`` (1e-4) relative of its, no codec launch; it prints its
   peak memory beside the ``unetpp`` run's through the same steps
   (``unetpp_remat row``);

4d. the data paths, each through the CLI's entry for ``DATA_EPOCHS`` (1)
   epoch, their fixtures written meanwhile by a process of this script
   (``--fixtures``) at the lowest CPU priority, with the
   same checks as the main paths (exact launches, the FLOP integer, PNGs,
   the loader's batches equal to ``DeviceLoader``'s on the same wire) and,
   for each run, a ``data path row``: the last epoch's step time,
   ``t_data_s`` and ``t_loader_{gather,cast,upload}_s``, the producer's
   tiles/s over its stages, the loader's delivered tiles/s alone against
   the ≈ 985 tiles/s that the flagship's 512 tiles in 0.52 s need, the
   idle share of a profiled step (``profile_phase``), the peak memory,
   MFU and the codec's launches, beside the card:
   ``flagship_tiles_dir`` writes 157 Vaihingen-like tiles of 512² from
   the seed (the reference's 127 and 30 held out), as ``--format npy`` and
   as PNG, and trains the flagship as written from them
   (``--set data.data_dir=``): npy eager on the device cache, png eager
   (its losses must be npy's bits), and npy with ``lazy_tiles``, the host
   loader, four workers and the compact wire (its first loss npy's bits,
   any later one within one fp32 ulp); ``flagship_scenes`` writes 33 uint8
   scenes at the sizes of ``docs/disk_fit/scene_scale.json`` (152.3
   MPix) and trains in crop mode (``crops_per_epoch=512,
   test_split_scenes=1, device_cache=false``), eager and then with
   ``mmap_scenes``, ``augment``, the compact wire and four workers, each
   run's loader equal by digest, epoch for epoch, to the same loader over
   the other residency; ``cityscapes_full_width`` trains
   ``configs/cityscapes_unet_v5e64.json`` as written at one replica
   (``--set parallel.data_axis_size=-1``; 33,445,104 parameters, its fp16
   codec with ``quantize_local=false`` launching the fake-quantize of the
   mean and its max-abs once a step), synthetic, and then from a
   Cityscapes layout of 24 frames of 2048×1024 with void label ids,
   converted by ``python -m ddlpc_tpu_torch.data.prepare_cityscapes``.
   The codec's kernels are then timed and held against their plain
   versions again at the Cityscapes gradient size (``cityscapes_kernels``);

4g. ``spatial_cityscapes``: ``configs/cityscapes_unet_v5e64.json`` as
   written with ``parallel.data_axis_size=-1, space_axis_size=2``: two
   gloo processes of this script (``--spatial-rank``) on ``cuda:0``, each
   holding 256 of every tile's 512 rows (the halo-exchanged convs, the
   BatchNorm statistics and the loss over both), through the CLI's entry:
   three steps on the synthetic data (three epochs of one step: 16
   training tiles and 8 held out, ``data.synthetic_len`` and
   ``test_split`` cut to fit), then one epoch from the 24-frame Cityscapes
   layout with void labels that ``cityscapes_full_width`` converted.
   Every rank's launches must be one ``absmax`` and one
   ``fake_quantize_fused`` a step, every rank's canonical state the same
   bits, every perf record half the unsharded step's FLOPs, the host
   loader's rows ``DeviceLoader``'s; the synthetic run's losses must lie
   within ``SPATIAL_LOSS_RTOL`` (the tiny models' card-vs-CPU 1e-4) of
   the same config unsharded in one process, and its checkpoint must
   restore into that unsharded trainer bit for bit.  It prints the step
   times, each rank's peak memory against the unsharded run's, a halo
   hop's ms (one bf16 row each way of the first down block) and the
   gradient all-reduce's ms (``spatial_cityscapes row``);

4g'. ``spatial_unetpp``: ``configs/vaihingen_unetpp.json`` as written
   (full width, features 32…512, deep supervision, bf16, no stem, 512²
   tiles, no codec) with ``parallel.data_axis_size=-1,
   space_axis_size=2``, in the same two rank processes after
   ``spatial_cityscapes``'s runs (one start-up for both), each holding 256
   rows (16 of U-Net++'s 16-row units), three steps of 4 micro-batches
   of 4 on the synthetic data (no directory run).  The same gates as
   ``spatial_cityscapes`` but no codec launch at all, and its FLOPs half
   of 12,480,638,091,264 a step.  The unsharded reference runs twice:
   past the first step (whose loss no update has moved, held at
   ``SPATIAL_LOSS_RTOL``) the loss gate is ``SPATIAL_LOSS_RTOL`` or twice
   the reference's own spread, whichever is larger.  It prints the same
   row (``spatial_unetpp row``), with the phase's wall seconds;

4g''. ``spatial_deeplabv3p``: ``configs/potsdam_deeplabv3p.json`` as
   written (full width, output stride 16, ASPP rates 6/12/18, bf16, micro
   8 × sync 4, no codec) with ``parallel.data_axis_size=-1,
   space_axis_size=2``, in the same two rank processes, each holding 256
   rows (16 units of 16: the ASPP sees 16 of its 32 rows, so the rate-18
   conv's halo takes the neighbour's whole 16 rows and two past the
   global edge).  First the config's own data for the zoo phase's epoch
   (4 steps): its batches' row blocks must be the ``deeplabv3p`` zoo
   phase's batches digest for digest, so that run is its unsharded
   reference (its losses are printed against the ranks', not gated: in
   bf16 one rounding flip spreads through the encoder and Adam's first
   update, and two unsharded runs of the same config already differ by
   1e-4 and more past the first step); then the config computing in
   float32 with SGD, two steps on 32 training tiles, whose losses must lie
   within ``SPATIAL_LOSS_RTOL`` of the same run unsharded here, the first
   step too.  The other gates are ``spatial_unetpp``'s (the first run's
   checkpoint restored unsharded), its FLOPs half of 7,940,345,954,304 a
   step.  The timed hop is the rate-18 conv's input, 8 × 512 × 16 × 32
   bf16 (``spatial_deeplabv3p row``);

4g'''. ``spatial_uneven``: ``configs/cityscapes_unet_v5e64.json`` as
   written with ``parallel.data_axis_size=-1, space_axis_size=8``: eight
   gloo processes (``--spatial-rank``, a world of their own after the
   two-rank one) on ``cuda:0``, each holding 64 of the 512 rows, half
   the U-Net's row unit of 128, so that the 8-row level is resharded to
   even boundaries before the fifth pool and four of the eight ranks hold
   none of the bottleneck's 4 rows (``parallel.halo.reshard``).  The
   synthetic run of ``spatial_cityscapes`` (three steps, its batches and
   seed), with its gates: losses within ``SPATIAL_LOSS_RTOL`` of that
   phase's unsharded run, every rank's state the same bits, one
   ``absmax`` and one ``fake_quantize_fused`` a step a rank, each perf
   record an eighth of the unsharded step's FLOPs, the checkpoint
   restored unsharded bit for bit, and four reshards a step a rank (the
   space-2 phases, whose levels split evenly, none).  It prints the step
   times, each rank's peak, the gradient all-reduce's ms, and what the
   reshards moved a step: calls, bytes sent and seconds, each rank's
   (``spatial_uneven row``).

   Every rank of the four space phases trains under the collective
   census (``parallel/mesh.census``), every run held to the program
   auditor's space-arm contracts at full width
   (``program.check_spatial_step``): ``placement`` (the param storage, the
   gradient, the moments against the state's ``StateLayout``) and
   ``codec-calls`` (one max-abs and one fake-quantize a bucket a step,
   equal to the launches); each rank's census is printed;

4h. ``pipe2_flagship``: ``parallel/pipeline.PipelineTrainStep`` on the
   flagship at full width, pipe 2 × data 1, the same two gloo processes
   after the space phases (``--spatial-rank``: one start-up of the
   processes for the four phases) on ``cuda:0``, ``PIPE_M`` = 4 micro-batches
   of 128 a step (the flagship trainer's own super-batches of epochs
   0–2), three steps with the flagship's fp16 codec in each stage's
   update (3 launches of each of its kernels, ``absmax`` 6, a stage).
   The canonical state and the losses must lie within
   ``reference_phase``'s allowance of the unstaged step with the same
   codec on the same micro-batches (run here, in one process), its
   codec's scale taken over each stage's parameters as the stages' own
   updates take it (``stagewise_codec``); the unstaged step as written,
   its scale over the whole gradient, is printed beside it (the fp16
   lattice of ±100 levels keeps different gradients under the two
   scales, which Adam turns into full-size updates).  Both ranks'
   ``canonical()`` must be the same bits; ``last_schedule`` executed
   12, idle 2, bubble 0.1429; the last stage's carry stash
   ``pipeline_carry_stash_bytes``.  It prints the step times against
   the unstaged step's, each stage's resident bytes against
   ``pipeline_stage_hbm_bytes`` and the stash (``pipeline row``).  Each
   rank's three steps run under the collective census and are held to
   the program auditor's contracts for its stage's programs at full
   width (``program.check_pipeline_rank``): the forward and backward
   segments to ``stage-boundary`` (only the sync-BN sums, within their
   budget, no codec call, every carry sent in bf16, the flagship's
   compute dtype), the stage update to ``comm-closed-form``,
   ``dtype-flow``, ``placement`` and ``codec-calls`` (the launches too);
   each program's census is printed.
   zero2 within the stages is not run here: with one replica a stage it
   resolves to ``off``, so it is held to ``off`` on the CPU at data 2
   (``tests/test_torch_pipeline.py``).  The two ranks time-share one
   card: their step times are no scaling number;

5. the data-parallel paths, each a world of W processes of this script
   (``--dp-rank``, started by ``mesh.spawn_world`` under a deadline that
   kills the world) through the CLI's entry on
   ``configs/vaihingen_unet_v5e8.json`` at full width, 512² tiles,
   micro-batch 128 a replica and ``DP_EPOCHS`` = 2 optimizer steps (3
   until the script needed the time):
   ``dp4_zero2_fp16`` (4 replicas, ZeRO-2, the f16 wire) and
   ``dp2_off_int8_sr`` (2 replicas, the replicated fused all-reduce on the
   int8 wire with stochastic rounding), the config as written: the host
   loader with the native gather into its pinned ring, whose batches (and
   those of a ring at micro-batch 4, seven batches an epoch through three
   slots, all held at once) must equal ``DeviceLoader``'s; every epoch's
   ``perf`` record must carry 3,058,553,585,664 FLOPs and its ``comm``
   record, and every rank's byte counter, the closed form of the step's
   collectives.  One card runs every rank on
   ``cuda:0`` over gloo; a host with a card a rank runs NCCL.  Each rank's
   launch counts must equal the path's (one launch a step of each codec
   kernel, two of the max-abs pass), every rank's params must hash alike,
   the losses be finite, and the world's sync of seeded gradient buffers
   must equal the plain single-process simulation of the same sync over
   all W buffers, bit for bit.  Each phase prints its backend and devices,
   each rank's peak memory and the card's use, the step times, and the
   sync's wall time a step beside its collectives alone and its codec
   kernels alone.  The W ranks time-share one card here: their step time
   is no scaling number.  Every rank prints (rank 0) and gates its state's
   placement: its ``StateLayout``'s decisions per kind (the rules and
   reasons, which kinds persist chunked: the level's rung), the
   ``obs/hbm.py`` breakdown, and the trainer's
   ``ddlpc_hbm_replicated_by_rule_bytes`` gauge, which must equal the
   bytes of the leaves whose decision reads ``replicated-by-rule``,
   counted here from the decision trees, and the layout's
   ``replicated_by_rule_bytes()``; beside them the padding each
   layout adds to ``n``, the port's flat regions and JAX's per-leaf
   chunks.  ``dp4_zero2_fp16`` also checkpoints its ZeRO-2
   state (the moments gathered, rank 0 writing), and then every rank
   builds a fresh Trainer that restores it: every rank's params and its
   own chunk of the moments must be bit-identical to the ones saved.
   Phases of the same world size share one world of processes, run one
   after another (``DP_SHARED``): the ring and zero3 phases run in
   ``dp4_zero2_fp16``'s processes, ``dp2_off_int8_sr_traced`` in
   ``dp2_off_int8_sr``'s.
   ``dp4_zero1_int8_ring`` (4 replicas, zero1, the int8 codec on the ring
   transport: point-to-point hops of the int8 chunks themselves) and
   ``dp4_zero3_fp16_bucket`` (4 replicas, zero3, 8 MiB gradient buckets:
   5 of the flagship's gradient, one set of codec launches each) run the
   same checks (the ring's plain simulation snaps the exact sum's mean
   once, as its owners do; its comm record carries ``ring_wire_report``'s
   bytes); the ring phase also times one hop.  The zero3 phase also
   checks every rank's state bytes against ``obs/hbm.py`` and its live
   buffers (the param buffer freed between steps), then trains a zero2
   twin at the same ranks, buckets and steps in the same processes, whose
   params must equal zero3's bit for bit and which must hold at least the
   full param buffer less a chunk more memory, and exactly as much more
   as the caching allocator's blocks of the two buffers say (the twin's
   param buffer and zero3's own chunk, read in ``torch.cuda.memory_snapshot``:
   what it saves beyond the buffer less a chunk is the blocks' rounding,
   printed beside the priced padding), and one
   process at ``shard_update='off'`` restores the zero3 checkpoint bit
   for bit.
   ``dp2_off_int8_sr_traced`` is ``dp2_off_int8_sr`` under
   ``train.trace`` with a sampled sync every step: every rank then runs
   the fenced comm probe once an epoch (``PROBE_SYNCS`` more syncs, whose
   codec launches the expected counts include); rank 0's losses, every
   rank's last loss and the replicas' digest must equal the untraced
   phase's bit for bit, and rank 0's ``comm`` records must carry a
   ``comm_s_per_step`` within ``PROBE_SYNC_MARGIN`` of the phase's own
   sync a step and below the record's ``step_time_s``, and a
   ``comm_fraction`` in [0, 1].
   Every rank of every data-parallel phase trains under the collective
   census (``parallel/mesh.census``) and holds its run to the program
   auditor's four contracts at full width (``analysis/program.check_step``):
   the census' ``wire`` collectives against ``obs/comm.comm_plan`` byte for
   byte and row for row a bucket (the traced twin's probe syncs
   counted), the wire dtype no wider than declared, the state's bytes a
   kind (the param storage and chunks, the synced gradient, the moments;
   zero3's param buffer released as a step leaves it) against its
   ``StateLayout``, and the codec's entry calls against the closed form a
   sync a bucket and against ``LAUNCHES``; the trainer's own
   ``ddlpc_comm_bytes_total{stage="wire"}`` rows must be the audit's.
   Each rank prints its census on a line of its own.

Before the main paths it also times the zero2 path's chunk-size kernels
(decode, the max-abs pass, the fake-quantize against a given max-abs) at
the chunk of 4 and of 8 replicas, on the card's clock and the host's, and
counts the fp32 values on which ``torch.sqrt`` on the card differs from
the correctly rounded square root that Adam takes (``optim.sqrt_rn``),
over 2**23 values spanning 1e-12..1e2.

6. the stall watchdog (run beside the supervised phase, its outcome read
   after it): a process of this script (``--stall``) trains a
   tiny config on the card with ``stall_timeout_s=2`` and
   ``stall_action=abort`` while its loader sleeps 6 s in the second batch;
   it must exit 42 with ``stall.log`` naming the phase ``data`` and the
   breadcrumb ``stalled``.

7. ``analysis``: the port's invariant checker, ``python -m
   ddlpc_tpu_torch.analysis.check --sanitize``, in a process of its own
   started after the kernel-timing phases (it runs beside the reference
   and main-path phases): the import tiers, the AST rules, the lock
   smoke on this card, and the host batch kernel's self-test under ASan,
   UBSan and (where the toolchain runs it) TSan; it must exit 0 with no
   violation and no suppression.  Then, in this process, the lock smoke
   with the detector on (``analysis/lock_fixtures.run_smoke``): the
   loader ring's arm on pinned slots with live CUDA events, the
   checkpointer's saving a state on the card; no lock-order cycle, no
   guarded-by violation, every arm run.  Once the checker has exited
   (so that it has the cores the auditor's 8 ranks would take), the program
   auditor: ``python -m ddlpc_tpu_torch.analysis.check --programs``
   (JAX's 28 arms and 36 programs, one step each in a world of 8 gloo
   ranks on ``cuda:0``, its ``kind="program"`` stream into ``WORKDIR``)
   must exit 0 with no violation, its codec calls equal to the kernels'
   launches, and no ``census-drift`` against
   ``docs/port_analysis/program_baseline.json``, which the CPU wrote: the
   card's census is the CPU's; then ``--programs --inject
   extra-collective`` must exit 1 naming ``int8_simulate`` and
   ``comm-closed-form``.  Its row is printed on a
   line of its own before the card's line.

With ``--profile``, after each single-process main path (once its launch
counts are read) it runs one more optimizer step of that path under
``torch.profiler`` and
prints the device time by kernel, the device's idle share over that step
and the step's FLOPs against the card's bf16 peak (this phase is for
measurement, not part of the plain smoke run).

After each phase it prints ``phase_seconds: {...}``, every phase's wall
seconds so far (also when the phase fails), so that a failed run's
output places the failure.  It prints one JSON line with every kernel's
numbers and the floor, then the card's ``nvidia-smi`` line, then the
contract line
``{"ok": true, "device": {...}}`` last.  Without CUDA, or without the rest
of the repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import warnings

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(REPO, "configs", "vaihingen_unet_tpu_flagship.json")
V5E8 = os.path.join(REPO, "configs", "vaihingen_unet_v5e8.json")
WORKDIR = os.path.join(REPO, "runs", "chip_smoke")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
# H100 SXM fp32 outside the tensor cores, published; NVIDIA publishes no
# CUDA-core integer rate, so the Philox kernels' integer operations count at it too.
FP32_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores, published
EPOCHS = 3  # one optimizer step per epoch on the flagship (97 tiles, super-batch 512)
MICRO_BATCH = 128  # the flagship's own
# The flagship nearest path's losses as the host loader gave them (PERF.md
# section 5): the device cache serves the same batch bytes.
FLAGSHIP_LOSSES = [2.0308308601379395, 1.8359242677688599, 1.6781508922576904]
# The conv FLOPs of one optimizer step a replica, as the JAX package's
# jaxpr walk counts them (obs/flops.py): the flagship, micro 128 x sync 4,
# and v5e8, micro 128 x sync 1.
FLAGSHIP_FLOPS = 12_234_214_342_656
V5E8_FLOPS = 3_058_553_585_664
IMAGES_PER_EPOCH = 5  # every committed config's train.dump_images_per_epoch
STALL_SLEEP_S = 6.0  # the watchdog phase's stall, against stall_timeout_s 2
# The stochastic main path: the flagship recipe's int8-stochastic arm.
STOCHASTIC = (
    "compression.mode=int8",
    "compression.rounding=stochastic",
    "compression.codec_backend=pallas",
)
# The traced paths: the trainer's span tracer with a sampled sync every
# step, the telemetry endpoint on an ephemeral port and the last epoch
# under the profiler.  Traced, each replica of a world also runs the fenced
# comm probe once an epoch, its first call warming up with one more sync:
# DP_EPOCHS + 1 syncs of the step's own, the codec's launches with them.
TRACED = ("train.trace=True", "train.trace_sync_every_steps=1", "train.telemetry_port=0",
          "train.profile_epoch=2")
DP_EPOCHS = 2  # the data-parallel phases' steps (one an epoch); 3 until the script needed the time
PROBE_SYNCS = DP_EPOCHS + 1
# The probe times one sync of the step's own; the phase also times that
# sync (the median of 5, ``sync_ms``).  One probe sample must lie within
# this factor of it either way: a probe that timed a step (≈ 30 syncs)
# or no sync at all fails (readings on one H100: 0.96–1.5 times the sync).
PROBE_SYNC_MARGIN = 3.0
# The data-parallel paths: (replicas, extra overrides, resolved level,
# expected launches a step and a gradient bucket of each kernel, whether
# the large-batch warning fires).  v5e8 at 4 replicas (8 do not fit one
# card) is fp16 nearest at 100 levels on the f16 wire (4 x 100 <= 2048)
# and resolves to zero2; its int8-stochastic arm (codec_backend=pallas,
# with quantize_mean) resolves to the replicated fused all-reduce on the
# int8 wire (2 x 10 <= 127).  The ring at 4 replicas and int8's 10 levels
# hops on int8 (4 x 10 <= 127) under zero1; zero3 with 8 MiB buckets cuts
# the flagship's 33.5 MB of gradient into 5.
DP_PHASES = {
    "dp4_zero2_fp16": (4, (), "zero2",
                       {"encode_to_wire": 1, "decode_from_wire": 1, "fake_quantize_fused": 1, "absmax": 2},
                       False),
    "dp2_off_int8_sr": (2, STOCHASTIC, "off",
                        {"encode_sr": 1, "decode_from_wire": 1, "fake_quantize_sr": 1, "absmax": 2},
                        True),
    # Its twin under the tracer, which adds the comm probe's syncs.
    "dp2_off_int8_sr_traced": (2, STOCHASTIC + TRACED[:2], "off",
                               {"encode_sr": 1, "decode_from_wire": 1, "fake_quantize_sr": 1,
                                "absmax": 2},
                               True),
    "dp4_zero1_int8_ring": (4, ("parallel.shard_update=zero1", "compression.mode=int8",
                                "compression.transport=ring"), "zero1",
                            {"encode_to_wire": 1, "decode_from_wire": 1, "absmax": 1}, False),
    "dp4_zero3_fp16_bucket": (4, ("parallel.shard_update=zero3", "compression.bucket_mb=8"), "zero3",
                              {"encode_to_wire": 1, "decode_from_wire": 1, "fake_quantize_fused": 1,
                               "absmax": 2},
                              False),
}
# The phases that run after a phase in its world of processes, one after
# another (one start-up of the ranks for all of them): the same world
# size, backend and card.
DP_SHARED = {"dp4_zero2_fp16": ("dp4_zero1_int8_ring", "dp4_zero3_fp16_bucket"),
             "dp2_off_int8_sr": ("dp2_off_int8_sr_traced",)}
DP_FOLLOWERS = {f for fs in DP_SHARED.values() for f in fs}
# Substrings of the codec's CUDA kernels' names, as the profiler names them.
CODEC_KERNEL_NAMES = ("encode_kernel", "encode_sr_kernel", "encode_noise_kernel", "decode_kernel",
                      "fake_quantize", "absmax")
# The flagship with every optimizer option the JAX trainer has, and remat.
FLAGSHIP_OPTIONS = ("train.optimizer=adamw", "train.weight_decay=1e-4", "train.lr_schedule=cosine",
                    "train.warmup_steps=1", "train.grad_clip_norm=1.0", "train.remat=true")
# The other models' main paths, each config as written but for the epochs:
# config, the conv FLOPs a step (the JAX package's integer) and the
# optimizer steps an epoch (97 tiles over the super-batch, rounded up).
ZOO_EPOCHS = 1  # one epoch each, to keep the script well inside its time limit
# unetpp_remat: the zoo run it is held against, its steps and tolerance.
REMAT_REFERENCE = "unetpp"
REMAT_STEPS = 2
REMAT_RTOL = 1e-4
ZOO_PATHS = {
    "unetpp": ("vaihingen_unetpp.json", 12_480_638_091_264, 7),
    "unetpp_s2d": ("vaihingen_unetpp_s2d.json", 3_246_995_275_776, 2),
    "deeplabv3p": ("potsdam_deeplabv3p.json", 7_940_345_954_304, 4),
}
# The card-vs-CPU reference models (fp32, two steps): (model, tile size).
TINY_UNET = {"features": [8, 16], "bottleneck_features": 16, "stem": "s2d", "stem_factor": 2,
             "detail_head": True}
TINY_ZOO = {
    "unetpp": ({"name": "unetpp", "features": [8, 16, 32], "deep_supervision": True,
                "up_sample_mode": "bilinear", "norm": "group"}, 32),
    "deeplabv3p": ({"name": "deeplabv3p", "features": [64, 128, 256, 512], "width_divisor": 8},
                   128),
}
# The data-path phases: the flagship from a tile directory (the reference's
# 127 training tiles and 30 held out) and from scenes at the reference
# scale of docs/disk_fit/scene_scale.json (its six sizes, cycled over 33
# scenes: 152.3 MPix), and the Cityscapes config at full width.
DATA_EPOCHS = 1  # 2 until PR 16's spatial_unetpp needed the script's time
TILES_DIR_TILES = 157
TILE_PX = 512
SCENE_SIZES = ((2566, 1893), (2428, 2006), (2500, 1934), (1281, 2336), (2546, 1903), (2064, 2494))
N_SCENES = 33
CITYSCAPES = os.path.join(REPO, "configs", "cityscapes_unet_v5e64.json")
CITYSCAPES_FRAMES = 24
CITYSCAPES_FRAME = (1024, 2048)  # a frame's (H, W), before the converter's downscale of 2
CITYSCAPES_STEPS = {"cityscapes_synthetic": 7, "cityscapes_dir": 1}  # steps an epoch: 97/16, 16/16
CITYSCAPES_PARAMS = 33_445_104
CITYSCAPES_FLOPS = 2_588_254_666_752  # micro 16 x sync 1, as the JAX package counts them
# Tiles a second the host path must deliver to keep the card busy: the
# flagship's 512 tiles a step at 0.52 s.
NEED_TILES_PER_S = 512 / 0.52
DP_DEADLINE_S = 420  # a world still running then is killed, and the run fails
SYNC_STEP = 7  # the step whose key the sync-level check's stochastic rounding uses
SNAP_OPS_PER_ELEM = 7  # divide, multiply, add, floor, 2 compares, convert
# Instruction rates of an H100 SXM (132 SMs at the published 1,980 MHz
# boost clock): an SM issues 4 warp instructions a clock; a 32-bit integer
# multiply (IMAD.HI, IMAD.WIDE) runs at 64 lanes a clock an SM, the CUDA C++
# Programming Guide's throughput for compute capability 9.0.
INSTR_LANES_PER_S = 132 * 4 * 32 * 1.98e9
IMUL_LANES_PER_S = 132 * 64 * 1.98e9
# Bytes a SASS store instruction writes, by its width suffix (none: 4).
STORE_BYTES = {"U8": 1, "S8": 1, "U16": 2, "S16": 2, "64": 8, "128": 16}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


PHASE_SECONDS: dict = {}  # each phase's wall seconds, in the order run


def timed(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its wall seconds recorded under ``name``
    and the map so far printed (``phase_seconds: {...}``), also when it
    fails, so that a failed run's output places its failure and its
    time."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kwargs)
    finally:
        PHASE_SECONDS[name] = round(time.perf_counter() - t0, 1)
        log("phase_seconds: " + json.dumps(PHASE_SECONDS))


def smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        fail(f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 25) -> float:
    """Median device time of ``fn()`` over ``reps`` launches, each timed
    with CUDA events on a cold and clean 50 MB L2 (the codec meets its
    gradients cold after a backward pass): a 256 MB buffer, written once
    here, is read whole before each launch.  That read evicts whatever the
    previous launch left dirty in L2 and pays its write-back outside the
    timed window, so the window holds the kernel's own traffic alone.  A
    spin of about 0.5 ms on the stream follows the flush, so that ``fn``'s
    launches are queued before the start event fires and the window holds
    no host time (a wrapper's Python and launch calls), however slow the
    host; ``host_ms`` measures that time apart."""
    flush = torch.ones(64 << 20, dtype=torch.float32, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        flush.sum()
        torch.cuda._sleep(1_000_000)  # cycles; touches no memory
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_ms(fn, calls: int = 50, batches: int = 10) -> float:
    """Host time of one call of ``fn`` (a wrapper's Python, its checks and
    its launches): the wall clock over ``calls`` calls issued back to back
    from an idle device, over the call count, the least of ``batches``
    such batches (other work on the host's cores only adds time).  The
    launch queue holds more than ``calls`` calls' launches, so the host
    does not wait on the device inside a batch."""
    fn()
    times = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e3)
    torch.cuda.synchronize()
    return min(times)


def encode_sr_sass(lib_path: str) -> dict:
    """The main loop of ``encode_sr_kernel<WireI8, kVec = true>`` in the
    SASS of the library at ``lib_path`` (``cuobjdump -sass``): among the
    kernel's loops (a backward branch and the instructions from its target
    to it), the one with the fewest instructions per element stored,
    counted statically, an element being one byte stored to the int8 wire.
    Integer multiplies (``IMAD.HI``, ``IMAD.WIDE``) are counted apart:
    Hopper issues them at half the rate of the rest."""
    from ddlpc_tpu_torch.kernels.build import find_nvcc

    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    r = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        fail(f"cuobjdump failed: {r.stderr}")
    code, labels, pending, inside = [], {}, [], False
    for line in r.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if inside:
                break
            inside = re.search(r"encode_sr_kernelINS_\d+WireI8ELb1E", m.group(1)) is not None
            continue
        if not inside:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            addr = int(m.group(1), 16)
            for name in pending:
                labels[name] = addr
            pending = []
            text = re.sub(r"^@!?U?P[T\d]+\s+", "", m.group(2))
            code.append((addr, text.split()[0], text))
    best = None
    for addr, op, text in code:
        if not op.startswith("BRA"):
            continue
        m = re.search(r"`\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\b", text)
        target = labels.get(m.group(1)) if m and m.group(1) else (int(m.group(2), 16) if m else None)
        if target is None or target > addr:
            continue
        body = [c for c in code if target <= c[0] <= addr]
        stored = sum(STORE_BYTES.get(c[1].split(".")[-1], 4) for c in body if c[1].startswith("STG"))
        if stored and (best is None or len(body) / stored < best["per_elem"]):
            imul = sum(1 for c in body if c[1].startswith(("IMAD.HI", "IMAD.WIDE")))
            best = {"loop_instructions": len(body), "elements": stored,
                    "per_elem": len(body) / stored, "imul_per_elem": imul / stored}
    if best is None:
        fail("no loop that stores in the SASS of encode_sr_kernel<WireI8, vec>")
    log(f"SASS of encode_sr_kernel<WireI8, vec>'s main loop: {best['loop_instructions']} "
        f"instructions for {best['elements']} elements, {best['per_elem']:.3f} an element "
        f"({best['imul_per_elem']:.3f} IMAD.HI/IMAD.WIDE)")
    return best


def loop_path_sass(lib_path: str, kernel: str, elem_bytes: int) -> dict:
    """The instructions an element of ``kernel``'s main loop in the SASS of
    the library at ``lib_path`` (``cuobjdump -sass``), counted along one
    trip: the loop's body (a backward branch and the instructions from its
    target to it) is cut into basic blocks, and the trip is the path through
    them, from the loop's head to its back branch, with the fewest
    instructions among those that take the widest store, the vector path
    (a tail branch that stores element by element lies on another path).
    An element is ``elem_bytes`` of that store.  Integer multiplies
    (``IMAD.HI``, ``IMAD.WIDE``) are counted apart.  The function's SASS is
    written to ``runs/chip_smoke/<kernel>.sass``."""
    from ddlpc_tpu_torch.kernels.build import find_nvcc

    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    r = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        fail(f"cuobjdump failed: {r.stderr}")
    code, labels, pending, inside, text_lines = [], {}, [], False, []
    for line in r.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if inside:
                break
            inside = re.search(kernel, m.group(1)) is not None
            continue
        if not inside:
            continue
        text_lines.append(line)
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            addr = int(m.group(1), 16)
            for name in pending:
                labels[name] = addr
            pending = []
            pred = re.match(r"^@!?U?P[T\d]+\s+", m.group(2)) is not None
            text = re.sub(r"^@!?U?P[T\d]+\s+", "", m.group(2))
            code.append((addr, text.split()[0], text, pred))
    os.makedirs(WORKDIR, exist_ok=True)
    with open(os.path.join(WORKDIR, re.sub(r"\W", "_", kernel) + ".sass"), "w") as f:
        f.write("\n".join(text_lines))

    def target_of(text):
        m = re.search(r"`\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\b", text)
        if not m:
            return None
        return labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)

    def width(op):
        return STORE_BYTES.get(op.split(".")[-1], 4) if op.startswith("STG") else 0

    best = None
    for i, (addr, op, text, _) in enumerate(code):
        head = target_of(text) if op.startswith("BRA") else None
        if head is None or head > addr:
            continue
        body = [c for c in code if head <= c[0] <= addr]
        widest = max(width(c[1]) for c in body)
        if not widest:
            continue
        leaders = {head} | {t for c in body if c[1].startswith("BRA")
                            for t in [target_of(c[2])] if t is not None and head <= t <= addr}
        for j, c in enumerate(body[:-1]):
            if c[1].startswith(("BRA", "EXIT", "RET")):
                leaders.add(body[j + 1][0])
        starts = sorted(leaders)
        blocks = {a: [c for c in body if a <= c[0] < (starts[k + 1] if k + 1 < len(starts) else addr + 1)]
                  for k, a in enumerate(starts)}

        def succ(a):
            last = blocks[a][-1]
            nxt = [b for b in starts if b > a][:1]
            if last[0] == addr:
                return []
            if last[1].startswith("BRA"):
                t = target_of(last[2])
                out = [t] if t is not None and head <= t <= addr and t > a else []
                return out + (nxt if last[3] else [])
            if last[1].startswith(("EXIT", "RET")):
                return nxt if last[3] else []
            return nxt

        # Fewest instructions from the head to the back branch through a
        # block with the widest store (blocks only lead forward: a DAG).
        # cost[a] = (without the store, with it), each (instructions,
        # multiplies, bytes of widest stores) or None.
        def add(p, blk):
            if p is None:
                return None
            imul = sum(1 for c in blk if c[1].startswith(("IMAD.HI", "IMAD.WIDE")))
            wide = sum(widest for c in blk if width(c[1]) == widest)
            return (p[0] + len(blk), p[1] + imul, p[2] + wide)

        def better(p, q):
            return q if p is None or (q is not None and q[0] < p[0]) else p

        def has_store(blk):
            return any(width(c[1]) == widest for c in blk)

        cost = {a: [None, None] for a in starts}
        cost[head][int(has_store(blocks[head]))] = add((0, 0, 0), blocks[head])
        for a in starts:
            for b in succ(a):
                if has_store(blocks[b]):
                    cost[b][1] = better(cost[b][1], better(add(cost[a][0], blocks[b]),
                                                           add(cost[a][1], blocks[b])))
                else:
                    cost[b][0] = better(cost[b][0], add(cost[a][0], blocks[b]))
                    cost[b][1] = better(cost[b][1], add(cost[a][1], blocks[b]))
        found = cost[max(starts)][1]
        if found is None:
            continue
        elements = found[2] / elem_bytes  # an unrolled trip stores more than once
        row = {"loop_instructions": found[0], "elements": elements, "per_elem": found[0] / elements,
               "imul_per_elem": found[1] / elements, "body_instructions": len(body)}
        if best is None or row["per_elem"] < best["per_elem"]:
            best = row
    if best is None:
        fail(f"no loop with a store in the SASS of {kernel}")
    log(f"SASS of {kernel}'s main loop: {best['loop_instructions']} instructions on the vector "
        f"path (of {best['body_instructions']} in the loop body) for {best['elements']:g} elements, "
        f"{best['per_elem']:.3f} an element ({best['imul_per_elem']:.3f} IMAD.HI/IMAD.WIDE)")
    return best


def codec_inputs(n: int, levels: float) -> torch.Tensor:
    """Gradient-like values: a normal body, a zero tail, and a block placed
    on half-lattice points of the pinned scale 1.0 (ties for rintf)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(n, generator=g, device="cuda") * 0.05
    x.clamp_(-0.9, 0.9)
    x[0] = 1.0
    x[n - 4096 :] = 0.0
    k = torch.arange(-levels, levels, device="cuda")[: min(4096, n // 4)]
    x[1 : 1 + k.numel()] = (k + 0.5) / levels
    return x


def same_absmax(got: torch.Tensor, want: torch.Tensor) -> bool:
    """NaN by position (its payload may differ), anything else bit for bit
    (so -0.0 against +0.0 fails)."""
    if bool(torch.isnan(want).item()):
        return bool(torch.isnan(got).item())
    return torch.equal(got.view(torch.int32), want.view(torch.int32))


def absmax_checks(x: torch.Tensor) -> None:
    """``cq.absmax`` against its plain version ``x.abs().amax()`` (0 for an
    empty buffer) on the codec inputs and on edge inputs."""
    from ddlpc_tpu_torch.ops import cuda_quantize as cq

    n = x.numel()
    cases = {"codec inputs": x, "x[1:]": x[1:], "empty": x[:0]}
    for m in (1, 7, 15, 17, 100_003):
        cases[f"x[:{m}]"] = x[:m]
        cases[f"x[1:{m + 1}]"] = x[1 : m + 1]
    for name, value, at in (("NaN", float("nan"), n // 3), ("+inf", float("inf"), n - 1),
                            ("-inf", float("-inf"), 0), ("NaN and inf", float("nan"), n - 2)):
        y = x.clone()
        y[at] = value
        if name == "NaN and inf":
            y[5] = float("inf")
        cases[name] = y
    cases["-0.0"] = torch.full((1025,), -0.0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    cases["subnormals"] = torch.randint(
        1, 0x007FFFFF, (100_003,), generator=g, device="cuda", dtype=torch.int32
    ).view(torch.float32)
    for name, t in cases.items():
        got = cq.absmax(t)
        want = t.abs().amax().reshape(1) if t.numel() else torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        if got.shape != (1,) or not same_absmax(got, want):
            fail(f"absmax on {name}: {got.tolist()} != plain {want.tolist()}")
    log(f"absmax == x.abs().amax() (NaN by position, else bit for bit) on: {', '.join(cases)}")


def kernel_phase(n: int) -> list:
    from ddlpc_tpu_torch.config import CompressionConfig
    from ddlpc_tpu_torch.ops import cuda_quantize as cq
    from ddlpc_tpu_torch.ops import quantize as plain

    cfg = CompressionConfig(mode="float16")  # the flagship's codec
    levels = float(plain.levels_for(cfg))
    x = codec_inputs(n, levels)
    absmax_checks(x)
    scale = x.abs().amax().reshape(1)
    safe = plain.safe_divisor(scale)
    inv = plain.true_div(scale, levels)
    ties = int(((x / safe * levels) % 1 == 0.5).sum())
    log(f"codec inputs: n={n} zero tail 4096, exact half-lattice ties {ties}")

    # Bit-identity on every wire the encode/decode kernels are built for.
    for mode, wire in (("float16", torch.float16), ("int8", torch.int8), ("int8", torch.int16)):
        c = CompressionConfig(mode=mode)
        lv = float(plain.levels_for(c))
        q_k = cq.encode_to_wire(x, safe, c, wire)
        q_p = plain.encode_with_scale(x, safe, lv, wire)
        d_k = cq.decode_from_wire(q_k, inv)
        d_p = plain.decode_with_inv(q_p, inv)
        f_k = cq.fake_quantize_fused(x, c)
        f_p = cq.fake_quantize_plain(x, c)
        torch.cuda.synchronize()
        for what, a, b in (("encode", q_k, q_p), ("decode", d_k, d_p), ("fake_quantize", f_k, f_p)):
            if not torch.equal(a, b):
                bad = int((a != b).sum())
                fail(f"{what} kernel ({mode}, {wire}) differs from its plain version at {bad} elements")
        log(f"kernels == plain versions, bit for bit: {mode} codec, {wire} wire")

    wire = torch.float16
    q = cq.encode_to_wire(x, safe, cfg, wire)
    out = torch.empty_like(x)
    fq_out = torch.empty_like(x)
    fq_in = x.clone()  # the main path fake-quantizes its buffer in place
    src = "ddlpc_tpu_torch/kernels/csrc/quantize.cu"
    specs = [
        dict(
            name="encode_to_wire",
            replaces="ddlpc_tpu/ops/pallas_quantize.py:142",
            kernel=lambda: cq.encode_to_wire(x, safe, cfg, wire),
            plain=lambda: plain.encode_with_scale(x, safe, levels, wire),
            library=None,
            bytes=4 * n + 2 * n + 4,
            ops=5 * n, source=src,
            err=lambda: (cq.encode_to_wire(x, safe, cfg, wire).float()
                         - plain.encode_with_scale(x, safe, levels, wire).float()).abs().max(),
        ),
        dict(
            name="decode_from_wire",
            replaces="ddlpc_tpu/ops/pallas_quantize.py:170",
            kernel=lambda: cq.decode_from_wire(q, inv, out=out),
            plain=lambda: plain.decode_with_inv(q, inv),
            library=lambda: torch.mul(q, inv),
            bytes=2 * n + 4 * n + 4,
            ops=n, source=src,
            err=lambda: (cq.decode_from_wire(q, inv) - plain.decode_with_inv(q, inv)).abs().max(),
        ),
        dict(
            name="fake_quantize_fused",
            replaces="ddlpc_tpu/ops/pallas_quantize.py:50",
            kernel=lambda: cq.fake_quantize_fused(fq_in, cfg, out=fq_in),
            plain=lambda: cq.fake_quantize_plain(x, cfg),
            library=lambda: torch.fake_quantize_per_tensor_affine(
                x, plain.true_div(x.abs().amax().reshape(1), levels),
                torch.zeros(1, dtype=torch.int32, device="cuda"),
                -int(levels), int(levels),
            ),
            bytes=4 * n + 4 * n + 4,
            ops=6 * n, source=src,
            err=lambda: (cq.fake_quantize_fused(x, cfg) - cq.fake_quantize_plain(x, cfg)).abs().max(),
        ),
        dict(
            name="absmax",
            source="ddlpc_tpu_torch/kernels/csrc/absmax.cu",
            # Not a Pallas kernel: XLA's reduction global_absmax, which runs
            # before the fake-quantize Pallas call.
            replaces="ddlpc_tpu/ops/quantize.py:119",
            kernel=lambda: cq.absmax(x),
            plain=lambda: plain.global_absmax([x]).reshape(1),
            library=lambda: torch.linalg.vector_norm(x, float("inf")),
            bytes=4 * n + 4,
            ops=2 * n,  # an AND and an integer max an element
            err=lambda: (cq.absmax(x) - x.abs().amax()).abs().max(),
        ),
    ]
    results = [timed_row(s) for s in specs]
    # The fake-quantize row times the wrapper as the main path calls it (the
    # max-abs pass, then the kernel, in place); the kernel alone is timed
    # through its C entry point with the max-abs ready.
    amax = cq.absmax(x)
    results[2]["kernel_ms"] = time_ms(lambda: raw_launch(
        "ddlpc_fake_quantize", x.data_ptr(), fq_out.data_ptr(), n, amax.data_ptr(),
        levels, 1, stream()))
    results[2]["out_of_place_ms"] = time_ms(lambda: cq.fake_quantize_fused(x, cfg, out=fq_out))
    results[3]["abs_amax_ms"] = time_ms(lambda: x.abs().amax())
    log(f"fake_quantize_fused: in place {results[2]['ms']:.4f} ms, out of place "
        f"{results[2]['out_of_place_ms']:.4f} ms, its kernel alone {results[2]['kernel_ms']:.4f} ms; "
        f"absmax {results[3]['ms']:.4f} ms against x.abs().amax() "
        f"{results[3]['abs_amax_ms']:.4f} ms and torch.linalg.vector_norm(x, inf) "
        f"{results[3]['library_ms']:.4f} ms")
    # The int8 wire against torch.quantize_per_tensor, which does close to
    # the same work: it multiplies by the reciprocal of its scale (where the
    # kernel divides x by the max-abs, then multiplies by the levels) and
    # clamps to the qint8 range -128..127 (the kernel clips to +-levels).
    i8 = CompressionConfig(mode="int8")
    lv8 = float(plain.levels_for(i8))
    step8 = plain.true_div(scale, lv8)
    results[0]["int8_wire_ms"] = time_ms(lambda: cq.encode_to_wire(x, safe, i8, torch.int8))
    results[0]["int8_wire_gb_per_s"] = gb_per_s(5 * n + 4, results[0]["int8_wire_ms"])
    qscale = float(step8)  # quantize_per_tensor takes its scale as a Python float
    results[0]["int8_wire_library_ms"] = time_ms(
        lambda: torch.quantize_per_tensor(x, qscale, 0, torch.qint8))
    log(f"encode_to_wire, int8 wire: {results[0]['int8_wire_ms']:.4f} ms, "
        f"torch.quantize_per_tensor {results[0]['int8_wire_library_ms']:.4f} ms")
    # Decode on the int8 wire (the stochastic main path's) and the int16
    # wire as well as fp16.
    inv8 = plain.true_div(scale, lv8)
    for wire8 in (torch.int8, torch.int16):
        tag = str(wire8).replace("torch.", "")
        q8 = cq.encode_to_wire(x, safe, i8, wire8)
        n_bytes = q8.element_size() * n + 4 * n + 4
        ms = results[1][f"{tag}_wire_ms"] = time_ms(lambda: cq.decode_from_wire(q8, inv8, out=out))
        results[1][f"{tag}_wire_gb_per_s"] = gb_per_s(n_bytes, ms)
        results[1][f"{tag}_wire_bound_ms"] = n_bytes / HBM_BYTES_PER_S * 1e3
        results[1][f"{tag}_wire_plain_ms"] = time_ms(lambda: plain.decode_with_inv(q8, inv8))
        results[1][f"{tag}_wire_library_ms"] = time_ms(lambda: torch.mul(q8, inv8))
        log(f"decode_from_wire, {tag} wire: {ms:.4f} ms, {gb_per_s(n_bytes, ms):.0f} GB/s (bound "
            f"{n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms), plain "
            f"{results[1][f'{tag}_wire_plain_ms']:.4f} ms, torch.mul "
            f"{results[1][f'{tag}_wire_library_ms']:.4f} ms")
    return results


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def raw_launch(name: str, *args) -> None:
    """One kernel through its C entry point, bypassing the wrapper (to time
    a kernel apart from the work its wrapper does around it)."""
    from ddlpc_tpu_torch.kernels.build import load_library

    status = getattr(load_library(), name)(*args)
    if status != 0:
        fail(f"{name} failed to launch (cudaError {status})")


def timed_row(s: dict) -> dict:
    """A kernel's JSON row: its error against the plain version, its time,
    the plain version's, the bound's and the library call's."""
    bound_bytes_ms = s["bytes"] / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = s["ops_ms"] if "ops_ms" in s else s["ops"] / FP32_OPS_PER_S * 1e3
    row = {
        "name": s["name"],
        "route": "cuda",
        "source": s["source"],
        "replaces": s["replaces"],
        "launches": 0,
        "max_abs_err": float(s["err"]()),
        "ms": time_ms(s["kernel"]),
        "plain_ms": time_ms(s["plain"]),
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        "library_ms": None if s["library"] is None else time_ms(s["library"]),
        "host_ms": host_ms(s["kernel"]),
    }
    row["gb_per_s"] = gb_per_s(s["bytes"], row["ms"])
    log(
        f"{row['name']}: {row['ms']:.4f} ms, host {row['host_ms']:.4f} ms a call, "
        f"{row['gb_per_s']:.0f} GB/s (bound "
        f"{row['bound_ms']:.4f} ms by {row['bound_by']}: bytes {bound_bytes_ms:.4f}, "
        f"operations {bound_ops_ms:.4f}; plain {row['plain_ms']:.4f} ms, library "
        f"{row['library_ms']} ms), max_abs_err {row['max_abs_err']}"
    )
    return row


def gb_per_s(n_bytes: float, ms: float) -> float:
    """Achieved rate: the bytes a row counts (each input read once, each
    output written once) over its measured time."""
    return n_bytes / ms / 1e6


def floor_phase(n: int) -> dict:
    """What plain data movement costs on this card and clock, beside the
    kernel rows: ``y.copy_(x)`` of an n-element fp32 buffer (8n bytes) and
    ``x.sum()`` (4n bytes read)."""
    x = codec_inputs(n, 100.0)
    y = torch.empty_like(x)
    runs = {"copy": (lambda: y.copy_(x), 8 * n), "sum": (lambda: x.sum(), 4 * n)}
    floor = {}
    for name, (fn, n_bytes) in runs.items():
        ms = time_ms(fn)
        floor[name] = {"bytes": n_bytes, "ms": ms, "gb_per_s": gb_per_s(n_bytes, ms)}
        log(f"floor {name}: {ms:.4f} ms, {gb_per_s(n_bytes, ms):.0f} GB/s over {n_bytes} "
            f"bytes (bytes bound {n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    return floor


def must_equal(what: str, a: torch.Tensor, b: torch.Tensor) -> None:
    torch.cuda.synchronize()
    if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
        bad = int((a != b).sum()) if a.shape == b.shape else -1
        fail(f"{what}: differs at {bad} elements")


def stochastic_kernel_phase(n: int, sass: dict, fq_sass: dict) -> list:
    """The four stochastic kernel families at the flagship's size: bit for
    bit against their plain versions on every wire, _noise fed the plain
    Philox field against _sr, the offset-slice property at one offset that
    is a multiple of 4 and one that is not, unbiasedness over 64 keys; then
    one timed row each at the int8 stochastic main path's settings.
    ``sass`` is ``encode_sr_sass``'s count, for ``encode_sr``'s bound, and
    ``fq_sass`` ``loop_path_sass``'s for ``fake_quantize_sr``'s."""
    from ddlpc_tpu_torch.config import CompressionConfig
    from ddlpc_tpu_torch.ops import cuda_quantize as cq
    from ddlpc_tpu_torch.ops import philox
    from ddlpc_tpu_torch.ops import quantize as plain

    x = codec_inputs(n, 100.0)
    scale = x.abs().amax().reshape(1)
    safe = plain.safe_divisor(scale)
    key = philox.rounding_key(0, 0, "local")
    for mode, wire in (("float16", torch.float16), ("int8", torch.int8), ("int8", torch.int16)):
        c = CompressionConfig(mode=mode, rounding="stochastic")
        lv = float(plain.levels_for(c))
        u = philox.uniform(key, 0, n, device="cuda")
        q = cq.encode_to_wire(x, safe, c, wire, key=key)
        must_equal(f"encode_sr ({wire}) vs plain", q, plain.encode_with_scale(x, safe, lv, wire, key=key))
        must_equal(f"encode_noise ({wire}) vs plain", cq.encode_to_wire(x, safe, c, wire, noise=u),
                   plain.encode_with_scale(x, safe, lv, wire, noise=u))
        must_equal(f"encode_noise ({wire}) on the Philox field vs encode_sr", cq.encode_to_wire(x, safe, c, wire, noise=u), q)
        f = cq.fake_quantize_fused(x, c, key=key)
        must_equal(f"fake_quantize_sr ({mode}) vs plain", f, cq.fake_quantize_plain(x, c, key=key))
        must_equal(f"fake_quantize_noise ({mode}) vs plain", cq.fake_quantize_fused(x, c, noise=u),
                   cq.fake_quantize_plain(x, c, noise=u))
        must_equal(f"fake_quantize_noise ({mode}) on the Philox field vs fake_quantize_sr",
                   cq.fake_quantize_fused(x, c, noise=u), f)
        for o in (4096, 4097):
            must_equal(f"encode_sr ({wire}) on x[{o}:] at offset {o} vs the full draw's slice",
                       cq.encode_to_wire(x[o:], safe, c, wire, key=key, offset=o), q[o:])
            y = x.clone()
            y[o + 5] = 1.0  # the max-abs inside the slice too, so both scales agree
            must_equal(f"fake_quantize_sr ({mode}) on y[{o}:] at offset {o} vs the full draw's slice",
                       cq.fake_quantize_fused(y[o:], c, key=key, offset=o),
                       cq.fake_quantize_fused(y, c, key=key)[o:])
        log(f"stochastic kernels == plain versions, bit for bit, and _noise(Philox field) == _sr, "
            f"and x[o:] at offset o == slice (o = 4096, 4097): {mode} codec, {wire} wire")

    # Unbiased over 64 keys: the mean error over all elements within the
    # Monte-Carlo tolerance of tests/test_stochastic_rounding.py (4 sigma,
    # sigma <= step/2 a trial) with trials = 64 keys x n elements; each
    # element within 6 sigma (the test's 4 sigma would be exceeded by
    # chance at ~6e-5 of 8.4M elements; 6 sigma at < 2e-9).
    c = CompressionConfig(mode="int8", rounding="stochastic")
    keys = 64
    acc = torch.zeros(n, dtype=torch.float64, device="cuda")
    for i in range(keys):
        acc += cq.fake_quantize_fused(x, c, key=philox.rounding_key(0, i, "mean")).double()
    err = acc / keys - x.double()
    step_abs = float(scale) / c.int8_levels
    sigma = (step_abs / 2) / math.sqrt(keys)
    bias = abs(float(err.mean()))
    worst = float(err.abs().max())
    over4 = int((err.abs() > 4 * sigma).sum())
    log(f"unbiased over {keys} keys: |mean error| {bias:.3e} (tolerance "
        f"{4 * sigma / math.sqrt(n):.3e}), max |error| {worst:.3e} (6 sigma "
        f"{6 * sigma:.3e}), elements beyond 4 sigma {over4} of {n}")
    if bias > 4 * sigma / math.sqrt(n) or worst > 6 * sigma:
        fail("stochastic fake-quantize is biased over 64 keys")

    cfg = CompressionConfig(mode="int8", rounding="stochastic")  # the main path's
    levels = float(plain.levels_for(cfg))
    wire = torch.int8
    u = philox.uniform(key, 0, n, device="cuda")
    out = torch.empty_like(x)
    fq_in = x.clone()  # the main path fake-quantizes its buffer in place
    src = "ddlpc_tpu_torch/kernels/csrc/stochastic.cu"
    specs = [
        dict(
            name="encode_sr", source=src,
            replaces="ddlpc_tpu/ops/pallas_quantize.py:142",
            kernel=lambda: cq.encode_to_wire(x, safe, cfg, wire, key=key),
            plain=lambda: plain.encode_with_scale(x, safe, levels, wire, key=key),
            bytes=4 * n + n + 4,
            ops_ms=n * max(sass["per_elem"] / INSTR_LANES_PER_S,
                           sass["imul_per_elem"] / IMUL_LANES_PER_S) * 1e3,
            err=lambda: (cq.encode_to_wire(x, safe, cfg, wire, key=key).float()
                         - plain.encode_with_scale(x, safe, levels, wire, key=key).float()).abs().max(),
        ),
        dict(
            name="fake_quantize_sr", source=src,
            replaces="ddlpc_tpu/ops/pallas_quantize.py:50",
            kernel=lambda: cq.fake_quantize_fused(fq_in, cfg, out=fq_in, key=key),
            plain=lambda: cq.fake_quantize_plain(x, cfg, key=key),
            bytes=4 * n + 4 * n + 4,
            ops_ms=n * max(fq_sass["per_elem"] / INSTR_LANES_PER_S,
                           fq_sass["imul_per_elem"] / IMUL_LANES_PER_S) * 1e3,
            err=lambda: (cq.fake_quantize_fused(x, cfg, key=key)
                         - cq.fake_quantize_plain(x, cfg, key=key)).abs().max(),
        ),
        dict(
            name="encode_noise", source=src,
            replaces="ddlpc_tpu/ops/pallas_quantize.py:163",
            kernel=lambda: cq.encode_to_wire(x, safe, cfg, wire, noise=u),
            plain=lambda: plain.encode_with_scale(x, safe, levels, wire, noise=u),
            bytes=4 * n + 4 * n + n + 4, ops=SNAP_OPS_PER_ELEM * n,
            err=lambda: (cq.encode_to_wire(x, safe, cfg, wire, noise=u).float()
                         - plain.encode_with_scale(x, safe, levels, wire, noise=u).float()).abs().max(),
        ),
        dict(
            name="fake_quantize_noise", source=src,
            replaces="ddlpc_tpu/ops/pallas_quantize.py:71",
            kernel=lambda: cq.fake_quantize_fused(fq_in, cfg, out=fq_in, noise=u),
            plain=lambda: cq.fake_quantize_plain(x, cfg, noise=u),
            bytes=4 * n + 4 * n + 4 * n + 4, ops=(SNAP_OPS_PER_ELEM + 3) * n,
            err=lambda: (cq.fake_quantize_fused(x, cfg, noise=u)
                         - cq.fake_quantize_plain(x, cfg, noise=u)).abs().max(),
        ),
    ]
    for s in specs:
        s["library"] = None
    log("library_ms is null for the stochastic kernels: no single PyTorch call "
        "rounds stochastically, with or without a Philox draw")
    rows = [timed_row(s) for s in specs]
    rows[0]["sass_per_elem"], rows[0]["sass_imul_per_elem"] = sass["per_elem"], sass["imul_per_elem"]
    rows[1]["sass_per_elem"], rows[1]["sass_imul_per_elem"] = fq_sass["per_elem"], fq_sass["imul_per_elem"]
    k0, k1 = key
    amax = cq.absmax(x)
    rows[1]["kernel_ms"] = time_ms(lambda: raw_launch(
        "ddlpc_fake_quantize_sr", x.data_ptr(), out.data_ptr(), n, amax.data_ptr(),
        levels, 0, k0, k1, 0, stream()))
    rows[3]["kernel_ms"] = time_ms(lambda: raw_launch(
        "ddlpc_fake_quantize_noise", x.data_ptr(), u.data_ptr(), out.data_ptr(), n,
        amax.data_ptr(), levels, 0, stream()))
    rows[1]["out_of_place_ms"] = time_ms(lambda: cq.fake_quantize_fused(x, cfg, out=out, key=key))
    rows[3]["out_of_place_ms"] = time_ms(lambda: cq.fake_quantize_fused(x, cfg, out=out, noise=u))
    for r in (rows[1], rows[3]):
        log(f"{r['name']}: in place {r['ms']:.4f} ms, out of place {r['out_of_place_ms']:.4f} ms, "
            f"kernel alone {r['kernel_ms']:.4f} ms")
    return rows


def reference_phase(compression: dict, loss_rtol: float, param_share: float,
                    model: dict = TINY_UNET, size: int = 32, param_step: int = 2) -> None:
    """A tiny ``model`` (the U-Net by default), two steps on the card and
    on the CPU from the same weights, data and ``train.seed``, on
    ``size``² tiles; the losses must agree within ``loss_rtol``, and all
    but ``param_share`` of the parameters after step ``param_step`` within
    rtol 1e-4 / atol 1e-6.  fp32 compute with TF32 off, so only the
    convolutions' summation order differs between the devices; the codec
    kernels equal their plain versions bit for bit (the stochastic ones
    draw the plain Philox stream), but where the two devices' gradients
    straddle a rounding boundary they snap to neighbouring lattice points,
    which moves an Adam update by up to the learning rate (the reasons of
    tests/test_torch_train_step.py's fp16 case).

    U-Net++ and DeepLabV3+ are held after their first step (``param_step``
    1), the second step's loss being the forward of the updated params:
    DeepLabV3+'s image-pool BatchNorm normalizes four nearly equal pooled
    means, which magnifies summation-order noise into the second update,
    and U-Net++ with group norm does the same at 32², so that two CPU runs
    of either with another thread count already leave many params apart
    after two steps, and almost none after one.  The second step's share
    is printed."""
    from ddlpc_tpu_torch.config import ExperimentConfig
    from ddlpc_tpu_torch.data.datasets import SyntheticTiles
    from ddlpc_tpu_torch.models import build_model
    from ddlpc_tpu_torch.parallel.train_step import create_train_state, make_train_step
    from ddlpc_tpu_torch.train.optim import Adam

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ExperimentConfig.from_dict({
        "model": {**model, "compute_dtype": "float32", "head_dtype": "float32"},
        "train": {"seed": 3},
        "compression": compression,
    })
    ds = SyntheticTiles(num_tiles=8, image_size=(size, size), seed=0)
    images = torch.from_numpy(ds.images.reshape(2, 4, size, size, 3))
    labels = torch.from_numpy(ds.labels.reshape(2, 4, size, size).astype("int64"))
    losses, params = {}, {}
    for dev in ("cpu", "cuda"):
        net = build_model(cfg.model, seed=0).to(dev)
        tx = Adam(2e-3)
        state = create_train_state(net, tx)
        step = make_train_step(tx, cfg.compression, seed=cfg.train.seed)
        losses[dev] = []
        for k in range(1, 3):
            losses[dev].append(float(step(state, images.to(dev), labels.to(dev))["loss"]))
            params[dev, k] = state.params.data.to("cpu", copy=True)
    what = f"tiny {cfg.model.name} 2 steps, {compression}"
    rel = max(abs(a - b) / abs(a) for a, b in zip(losses["cpu"], losses["cuda"]))
    shares = {}
    for k in (1, 2):
        want, got = params["cpu", k], params["cuda", k]
        shares[k] = float(((got - want).abs() > 1e-4 * want.abs() + 1e-6).float().mean())
    want, got = params["cpu", param_step], params["cuda", param_step]
    share = shares[param_step]
    log(f"{what}, card vs CPU: losses {losses['cuda']} vs {losses['cpu']} (max rel "
        f"diff {rel:.3e}, limit {loss_rtol}); params off rtol 1e-4 after step {param_step}: "
        f"share {share:.5f} (limit {param_share}), max |diff| "
        f"{float((got - want).abs().max()):.3e}; share after steps 1, 2: {shares[1]:.5f}, "
        f"{shares[2]:.5f}")
    if not all(math.isfinite(v) for v in losses["cuda"]) or rel > loss_rtol or share > param_share:
        fail(f"{what}: the card disagrees with the CPU")


def main_path_phase(label: str, extra: tuple, expect: dict, warns: bool, config: str = FLAGSHIP,
                    epochs: int = EPOCHS, micro_batch=MICRO_BATCH, flops: int = FLAGSHIP_FLOPS,
                    loader: str = "DeviceCachedLoader", prepare=None) -> dict:
    """Train ``config`` (the flagship by default) for ``epochs`` epochs
    through the CLI's entry with the ``extra`` overrides (and the
    micro-batch, unless None); the launch counts are set to 0 just before
    and read just after, and must equal ``expect`` (0 for a kernel it does
    not name).  Every epoch's perf record must carry ``flops``, and the
    run's loader be ``loader``.  ``prepare(trainer)`` runs before ``fit``."""
    import shutil

    from ddlpc_tpu_torch.ops import cuda_quantize as cq
    from ddlpc_tpu_torch.train.__main__ import parse_args
    from ddlpc_tpu_torch.train.trainer import Trainer

    workdir = os.path.join(WORKDIR, label)
    argv = ["--config", config, "--device", "cuda", "--no-resume",
            "--workdir", workdir, "--set", f"train.epochs={epochs}"]
    if micro_batch is not None:
        argv += ["--set", f"train.micro_batch_size={micro_batch}"]
    for o in extra:
        argv += ["--set", o]
    log(f"main path [{label}]: python -m ddlpc_tpu_torch.train " + " ".join(argv))
    metrics_path = os.path.join(workdir, "metrics.jsonl")
    shutil.rmtree(workdir, ignore_errors=True)
    cfg, resume, device, backend = parse_args(argv)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        trainer = Trainer(cfg, resume=resume, device=device, dist_backend=backend)
    for w in caught:
        log(f"warning: {w.message}")
    warned = any("global super-batch" in str(w.message) for w in caught)
    if warned != warns:
        fail(f"[{label}] large-batch stochastic-rounding warning: expected {warns}, got {warned}")
    n_params = trainer.state.params.numel
    log(f"[{label}] {cfg.model.name}: {n_params} parameters in one flat buffer, "
        f"{len(trainer.state.params.names)} leaves")
    if prepare is not None:
        prepare(trainer)
    torch.cuda.reset_peak_memory_stats()
    cq.reset_launch_counts()
    trainer.fit()
    torch.cuda.synchronize()
    launches = dict(cq.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    with open(metrics_path) as f:
        lines = [json.loads(line) for line in f]
    records = [r for r in lines if "kind" not in r]
    for r in records:
        log(f"[{label}] epoch {r['epoch']}: loss {r['loss']} step_time_s {r['step_time_s']} "
            f"epoch_time_s {r['epoch_time_s']} grad_norm {r['grad_norm']} val_miou {r.get('val_miou')}")
        if not math.isfinite(r["loss"]) or not math.isfinite(r["grad_norm"]):
            fail(f"[{label}] non-finite training metrics {r}")
    if len(records) != epochs:
        fail(f"[{label}] expected {epochs} epoch records, got {len(records)}")
    perf = perf_checks(label, lines, flops, epochs)
    snap = trainer.registry.snapshot()
    if snap["ddlpc_flops_per_step"] != flops or snap["ddlpc_peak_flops_assumed"] != 0:
        fail(f"[{label}] registry: ddlpc_flops_per_step {snap['ddlpc_flops_per_step']}, "
             f"assumed {snap['ddlpc_peak_flops_assumed']}")
    if type(trainer.loader).__name__ != loader:
        fail(f"[{label}] expected the {loader}, ran {type(trainer.loader).__name__}")
    loader_equal(label, trainer, trainer.loader, epochs)
    png_checks(label, trainer, epochs)
    log(f"[{label}] max_memory_allocated {peak} bytes ({peak / 2**30:.2f} GiB)")
    log(f"[{label}] kernels " + json.dumps(launches))
    want = {name: expect.get(name, 0) for name in launches}
    if launches != want:
        fail(f"[{label}] kernel launches in {epochs} epochs: {launches}, expected {want}")
    return {"launches": launches, "n_params": n_params, "trainer": trainer, "argv": argv,
            "losses": [r["loss"] for r in records], "peak_bytes": peak,
            "epochs": path_row(label, records, perf)}


def _scrape(port: int, out: dict) -> None:
    """The traced phase's scraper thread: arms a one-step capture through
    ``/debug/trace?steps=1`` while the first step runs, then reads
    ``/metrics`` (JSON and Prometheus text) and ``/healthz`` once the first
    epoch's loss and perf gauges are published."""
    try:
        out["arm"] = json.loads(_http(port, "GET", "/debug/trace?steps=1")[2])
        deadline = time.monotonic() + 300.0
        snap = {}
        while time.monotonic() < deadline:
            snap = json.loads(_http(port, "GET", "/metrics")[2])
            if "ddlpc_train_loss" in snap and "ddlpc_mfu" in snap:
                break
            time.sleep(0.05)
        out["json"] = snap
        out["text"] = _http(port, "GET", "/metrics", headers={"Accept": "text/plain"})[2].decode()
        out["healthz"] = json.loads(_http(port, "GET", "/healthz")[2])
    except Exception as e:  # noqa: BLE001 — the phase fails on the missing keys
        out["error"] = f"{type(e).__name__}: {e}"


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path) for f in files)


def traced_phase(untraced: dict) -> dict:
    """``traced`` (module docstring, phase 4a): the nearest fp16 main path
    again with ``TRACED`` and a scraper thread; the losses must be the
    committed bits and the launches the untraced path's, and the spans,
    the stream, the scrape and both captures must hold what the trainer's
    observability promises."""
    import threading

    from ddlpc_tpu_torch.obs.schema import check_record

    scraped: dict = {}
    threads = []

    def prepare(trainer):
        t = threading.Thread(target=_scrape, args=(trainer.telemetry.port, scraped), daemon=True)
        t.start()
        threads.append(t)

    run = main_path_phase("traced", TRACED, untraced["launches"], warns=False, prepare=prepare)
    for t in threads:
        t.join(timeout=60.0)
    trainer = run["trainer"]
    workdir = trainer.workdir
    trainer.close()
    if run["losses"] != FLAGSHIP_LOSSES:
        fail(f"[traced] losses {run['losses']} != the committed bits {FLAGSHIP_LOSSES}")
    with open(os.path.join(workdir, "spans.jsonl")) as f:
        spans = [json.loads(line) for line in f]
    counts: dict = {}
    for sp in spans:
        counts[sp["name"]] = counts.get(sp["name"], 0) + 1
    want = {"epoch": EPOCHS, "step_sync": EPOCHS, "evaluate": EPOCHS, "checkpoint_snapshot": EPOCHS}
    if {k: counts.get(k) for k in want} != want or not {"data", "step"} <= set(counts):
        fail(f"[traced] spans {counts}: expected {want} and the data and step stages")
    with open(os.path.join(workdir, "trace.json")) as f:
        trace_doc = json.load(f)
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    bad = [(r.get("kind", "train"), err) for r in lines for err in check_record(r)]
    if bad:
        fail(f"[traced] metrics.jsonl records fail the schema: {bad[:5]}")
    if "error" in scraped:
        fail(f"[traced] the scrape failed: {scraped['error']}")
    snap, text = scraped.get("json", {}), scraped.get("text", "")
    for gauge in ("ddlpc_mfu", "ddlpc_goodput", "ddlpc_train_loss"):
        if gauge not in snap or not re.search(rf"^{gauge} \S+$", text, re.M):
            fail(f"[traced] the scrape lacks {gauge}: JSON keys {sorted(snap)[:40]}")
    if scraped["healthz"].get("status") != "ok" or not scraped["arm"].get("armed"):
        fail(f"[traced] /healthz {scraped['healthz']}, /debug/trace {scraped['arm']}")
    with open(os.path.join(workdir, "top_ops_001.json")) as f:
        top = json.load(f)
    if top.get("planes") != ["device"] or not top.get("device_total_ms", 0) > 0 or "error" in top:
        fail(f"[traced] top_ops_001.json: planes {top.get('planes')}, device_total_ms "
             f"{top.get('device_total_ms')}, error {top.get('error')}")
    with open(os.path.join(workdir, "profile", "ops.json")) as f:
        ops = json.load(f)
    codec = sorted({o["op"][:80] for o in ops if any(k in o["op"] for k in CODEC_KERNEL_NAMES)})
    if not codec:
        fail("[traced] the profile_epoch capture names no codec kernel")
    step_untraced = [e["step_time_s"] for e in untraced["epochs"]]
    step_traced = [e["step_time_s"] for e in run["epochs"]]
    sizes = {"trace_json": os.path.getsize(os.path.join(workdir, "trace.json")),
             "spans_jsonl": os.path.getsize(os.path.join(workdir, "spans.jsonl")),
             "profile_epoch": _dir_bytes(os.path.join(workdir, "profile")),
             "profile_001": _dir_bytes(os.path.join(workdir, "profile_001"))}
    log(f"[traced] losses == the committed bits; launches == nearest_fp16's; spans {json.dumps(counts)}; "
        f"{len(trace_doc['traceEvents'])} trace events; {len(lines)} records pass the schema; the scrape "
        f"shows ddlpc_mfu {snap['ddlpc_mfu']}, ddlpc_goodput {snap['ddlpc_goodput']}, ddlpc_train_loss "
        f"{snap['ddlpc_train_loss']}")
    log(f"[traced] top_ops_001 (1 step, armed over HTTP): device_total_ms {top['device_total_ms']}, "
        f"wall_ms_per_step {top.get('wall_ms_per_step')}; the epoch-2 capture's codec kernels: {codec}")
    log(f"[traced] step_time_s traced {step_traced} against untraced {step_untraced}; bytes "
        f"{json.dumps(sizes)} ({smi_line()})")
    del trainer, run["trainer"]
    gc.collect()
    torch.cuda.empty_cache()
    return {**run, "step_time_s": step_traced, "untraced_step_time_s": step_untraced,
            "sizes": sizes, "span_counts": counts, "top_ops_001": {
                k: top.get(k) for k in ("planes", "device_total_ms", "per_step_ms", "wall_ms_per_step")},
            "codec_in_capture": codec}


def traced_dp_checks(dp: dict) -> dict:
    """``dp2_off_int8_sr_traced`` against its untraced twin: each rank's
    last loss, rank 0's every loss and the replicas' digest bit for bit
    (the probe's rounding touches no training draw), and rank 0's comm
    records carrying the probe's sample."""
    twin, base = dp["dp2_off_int8_sr_traced"], dp["dp2_off_int8_sr"]
    same = {k: (twin[k], base[k]) for k in ("losses", "rank_last_losses", "params_hash")}
    if any(a != b for a, b in same.values()):
        fail(f"[dp2_off_int8_sr_traced] differs from dp2_off_int8_sr: {same}")
    probes = twin["comm_probe"]
    # comm_fraction is clamped to 1; the unclamped readings are gated.
    lo = min(twin["sync_ms"]) / 1e3 / PROBE_SYNC_MARGIN
    hi = max(twin["sync_ms"]) / 1e3 * PROBE_SYNC_MARGIN
    if len(probes) != DP_EPOCHS or not all(
            p["comm_s_per_step"] is not None and lo <= p["comm_s_per_step"] <= hi
            and p["step_time_s"] is not None and p["comm_s_per_step"] < p["step_time_s"]
            and p["comm_fraction"] is not None and 0 <= p["comm_fraction"] <= 1 for p in probes):
        fail(f"[dp2_off_int8_sr_traced] comm records {probes}: expected every epoch "
             f"{lo:.6f} <= comm_s_per_step <= {hi:.6f} s (the phase's sync a step "
             f"{twin['sync_ms']} ms, within {PROBE_SYNC_MARGIN}x), comm_s_per_step < step_time_s "
             f"and 0 <= comm_fraction <= 1")
    log(f"[dp2_off_int8_sr_traced] losses, every rank's last loss and the replicas' digest == "
        f"dp2_off_int8_sr's bit for bit; comm probe {json.dumps(probes)}; probe debit "
        f"{twin['debit_probe_s']} s; step_time_s traced {twin['step_time_s']} against untraced "
        f"{base['step_time_s']} ({smi_line()})")
    return {"comm_probe": probes, "debit_probe_s": twin["debit_probe_s"],
            "step_time_s": twin["step_time_s"], "untraced_step_time_s": base["step_time_s"]}


def options_phase(flagship: dict) -> dict:
    """The flagship with ``FLAGSHIP_OPTIONS`` (AdamW with decay, a cosine
    schedule after one warmup step, clipping at norm 1, remat) through the
    CLI's entry for ``EPOCHS`` epochs (``main_path_phase``; the fp16
    codec's launches as on the main path): finite losses, and the rate of
    each step the schedule's, ``warmup_cosine_decay_schedule(0, lr, 1,
    3)`` = [0, lr, lr / 2] (float64, within 1e-6; optax's fp32 is that
    within an ulp).  Prints its peak memory and step time beside the
    plain flagship's of this run (``flagship``)."""
    rates = []

    def prepare(trainer) -> None:
        step_size = trainer.tx.step_size

        def recorded(count: int) -> float:
            rates.append((count, -step_size(count)))
            return step_size(count)

        trainer.tx.step_size = recorded

    run = main_path_phase(
        "flagship_options", FLAGSHIP_OPTIONS, warns=False, prepare=prepare,
        expect={"encode_to_wire": EPOCHS, "decode_from_wire": EPOCHS,
                "fake_quantize_fused": EPOCHS, "absmax": 2 * EPOCHS},
    )
    trainer = run.pop("trainer")
    lr = trainer.cfg.train.learning_rate
    want = [0.0, lr, lr * 0.5 * (1 + math.cos(math.pi / 2))]
    log(f"[flagship_options] rate each step (count, lr): {rates}; the schedule's {want}")
    if [c for c, _ in rates] != list(range(EPOCHS)) or any(
            abs(got - w) > 1e-6 * lr for (_, got), w in zip(rates, want)):
        fail(f"[flagship_options] the rates {rates} are not the schedule's {want}")
    step = [row["step_time_s"] for row in run["epochs"]]
    base = [row["step_time_s"] for row in flagship["epochs"]]
    log(f"[flagship_options] peak memory {run['peak_bytes']} bytes ({run['peak_bytes'] / 2**30:.2f} "
        f"GiB), step_time_s {step}; the plain flagship in this run: {flagship['peak_bytes']} bytes "
        f"({flagship['peak_bytes'] / 2**30:.2f} GiB), step_time_s {base} ({smi_line()})")
    run["rates"] = rates
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return run


def zoo_phase(label: str, profile: bool) -> dict:
    """One of the other models' committed configs as written, through the
    CLI's entry for ``ZOO_EPOCHS`` epochs (``main_path_phase``): no codec
    kernel may launch (``compression.mode=none``), and the optimizer must
    take ``ZOO_EPOCHS`` times the config's steps an epoch.  Prints its
    peak memory beside the card."""
    config, flops, steps = ZOO_PATHS[label]
    recorded = {}
    # A space phase that reuses this run as its unsharded reference needs
    # its steps' losses and the row blocks of its batches.
    blocks = max((s["space"] for s in SPATIAL_PHASES.values()
                  if s.get("reference", (None, None))[1] == label), default=0)
    prepare = None
    if blocks:
        prepare = lambda t: record_steps(t, recorded)  # noqa: E731
    elif label == REMAT_REFERENCE:
        prepare = lambda t: record_remat_reference(t, recorded)  # noqa: E731
    run = main_path_phase(label, (), {}, warns=False, config=os.path.join(REPO, "configs", config),
                          epochs=ZOO_EPOCHS, micro_batch=None, flops=flops,
                          loader="ShardedLoader", prepare=prepare)
    trainer = run["trainer"]
    if blocks:
        run.update(recorded, batch_digests=batch_digests(trainer.loader, blocks))
    elif label == REMAT_REFERENCE:
        run["remat_reference"] = recorded
    if trainer.state.step != ZOO_EPOCHS * steps:
        fail(f"[{label}] {trainer.state.step} optimizer steps, expected {ZOO_EPOCHS} x {steps}")
    log(f"[{label}] {trainer.state.step} optimizer steps; peak memory {run['peak_bytes']} bytes "
        f"({run['peak_bytes'] / 2**30:.2f} GiB) ({smi_line()})")
    if profile:
        profile_phase(trainer, label)
    del run["trainer"], trainer
    gc.collect()
    torch.cuda.empty_cache()
    return run


def record_steps(trainer, into: dict) -> None:
    """Wrap ``trainer.train_step`` so that each step appends its loss to
    ``into["step_losses"]`` (a space phase holds each step's loss)."""
    step = trainer.train_step
    into["step_losses"] = []

    def recorded(state, images, labels):
        m = step(state, images, labels)
        into["step_losses"].append(float(m["loss"]))
        return m

    trainer.train_step = recorded


def bn_stats(model) -> dict:
    """A copy of the BatchNorm running statistics, on the card."""
    return {name: b.detach().clone() for name, b in model.named_buffers()
            if name.endswith(("running_mean", "running_var"))}


def record_remat_reference(trainer, into: dict) -> None:
    """The ``unetpp`` zoo run as ``unetpp_remat``'s reference: its initial
    params' digest, its first ``REMAT_STEPS`` steps' losses and, after
    them, its BatchNorm statistics and peak memory (no host sync added)."""
    into["init_digest"] = _digest(trainer.state.params.data)
    step = trainer.train_step
    into["step_losses"] = []

    def recorded(state, images, labels):
        m = step(state, images, labels)
        into["step_losses"].append(m["loss"].detach().clone())
        if len(into["step_losses"]) == REMAT_STEPS:
            into["stats"] = bn_stats(state.model)
            into["peak_bytes"] = torch.cuda.max_memory_allocated()
        return m

    trainer.train_step = recorded


def unetpp_remat_phase(reference: dict) -> dict:
    """``unetpp_remat``: ``configs/vaihingen_unetpp.json`` as written with
    ``train.remat=true``, ``REMAT_STEPS`` optimizer steps of the trainer's
    own step on its loader's first batches, from the ``unetpp`` zoo run's
    initial weights (the same seed; held by digest).  The first loss must
    be that run's bits (the same forward); the later losses and the
    BatchNorm statistics within ``REMAT_RTOL`` relative (a leaf's largest
    difference over its largest magnitude: cuDNN's backward is not
    bitwise deterministic).  Prints the peak memory beside the ``unetpp``
    run's through the same steps."""
    import shutil

    from ddlpc_tpu_torch.ops import cuda_quantize as cq
    from ddlpc_tpu_torch.train.__main__ import parse_args
    from ddlpc_tpu_torch.train.trainer import Trainer

    workdir = os.path.join(WORKDIR, "unetpp_remat")
    shutil.rmtree(workdir, ignore_errors=True)
    argv = ["--config", UNETPP, "--device", "cuda", "--no-resume", "--workdir", workdir,
            "--set", "train.remat=true"]
    log("unetpp_remat: python -m ddlpc_tpu_torch.train " + " ".join(argv))
    cfg, resume, device, backend = parse_args(argv)
    trainer = Trainer(cfg, resume=resume, device=device, dist_backend=backend)
    if not cfg.train.remat or _digest(trainer.state.params.data) != reference["init_digest"]:
        fail("[unetpp_remat] the initial params differ from the unetpp run's")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cq.reset_launch_counts()
    trainer.loader.set_epoch(0)
    it = iter(trainer.loader)
    losses, step_s = [], []
    for _ in range(REMAT_STEPS):
        images, labels = next(it)
        t0 = time.perf_counter()
        m = trainer.train_step(trainer.state, images, labels)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    it.close()
    want = [float(x) for x in reference["step_losses"][:REMAT_STEPS]]
    rel_loss = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
    stats = bn_stats(trainer.state.model)
    rel_stats = {k: float((stats[k] - v).abs().max() / v.abs().max().clamp_min(1e-30))
                 for k, v in reference["stats"].items()}
    worst = max(rel_stats, key=rel_stats.get)
    row = {"card": smi_line(), "losses": losses, "unetpp_losses": want, "loss_rel": rel_loss,
           "bn_stats_max_rel": rel_stats[worst], "bn_stats_worst": worst, "bn_leaves": len(stats),
           "step_s": step_s, "peak_bytes": peak, "unetpp_peak_bytes": reference["peak_bytes"],
           "launches": {k: v for k, v in cq.LAUNCHES.items() if v}}
    log("unetpp_remat row: " + json.dumps(row))
    if losses[0] != want[0]:
        fail(f"[unetpp_remat] first loss {losses[0]} != the unetpp run's {want[0]} (bit for bit)")
    if max(rel_loss) > REMAT_RTOL or rel_stats[worst] > REMAT_RTOL or row["launches"]:
        fail(f"[unetpp_remat] losses {losses} against {want} (rel {rel_loss}), BatchNorm statistics "
             f"{rel_stats[worst]} at {worst}, codec launches {row['launches']}: expected within "
             f"{REMAT_RTOL} and none")
    log(f"[unetpp_remat] first loss == the unetpp run's bit for bit, step {REMAT_STEPS} within "
        f"{max(rel_loss):.3g}, BatchNorm statistics within {rel_stats[worst]:.3g} ({worst}); peak "
        f"{peak / 2**30:.2f} GiB against the unetpp run's {reference['peak_bytes'] / 2**30:.2f} GiB "
        f"through the same steps ({smi_line()})")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return row


def batch_digests(loader, blocks: int, epoch: int = 0) -> list:
    """The digests of the ``blocks`` row blocks (images and labels) of each
    of ``loader``'s batches in ``epoch``: what a space phase needs to
    reuse an unsharded run as its reference (its ranks' batches, taken
    with ``blocks`` 1, must be these blocks)."""
    loader.set_epoch(epoch)
    out = []
    for images, labels in loader:
        h = images.shape[2] // blocks
        out.append([_digest(images[:, :, i * h : (i + 1) * h], labels[:, :, i * h : (i + 1) * h])
                    for i in range(blocks)])
    return out


def vaihingen_like(rng, h: int, w: int):
    """uint8 imagery [h, w, 3] and int32 labels [h, w] of six classes in
    32-pixel blocks, each class a colour with noise (the synthetic tiles'
    structure, drawn as integers so that gigapixel fixtures take seconds)."""
    import numpy as np

    palette = rng.integers(25, 231, (6, 3))
    grid = rng.integers(0, 6, (-(-h // 32), -(-w // 32)))
    labels = np.repeat(np.repeat(grid, 32, 0), 32, 1)[:h, :w].astype(np.int32)
    noise = rng.integers(-12, 13, (h, w, 3))
    return np.clip(palette[labels] + noise, 0, 255).astype(np.uint8), labels


def tile_dirs(root: str) -> tuple:
    """The npy and the PNG tile directories under the fixtures' ``root``."""
    return os.path.join(root, "tiles_npy"), os.path.join(root, "tiles_png")


def write_tile_dirs(root: str) -> tuple:
    """``TILES_DIR_TILES`` tiles of 512², from the seed, with void pixels
    in every fifth label, written once as ``--format npy`` (``<stem>_img.npy``)
    and once as PNG, each beside its ``<stem>.npy`` int32 mask."""
    import numpy as np

    from ddlpc_tpu_torch.data import png

    t0 = time.perf_counter()
    npy_dir, png_dir = tile_dirs(root)
    for d in (npy_dir, png_dir):
        os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(TILES_DIR_TILES):
        img, lab = vaihingen_like(rng, TILE_PX, TILE_PX)
        if i % 5 == 0:
            lab[:16, :16] = -1
        np.save(os.path.join(npy_dir, f"top_{i:03d}_img.npy"), img)
        png.write_png(os.path.join(png_dir, f"top_{i:03d}.png"), img, level=1)
        for d in (npy_dir, png_dir):
            np.save(os.path.join(d, f"top_{i:03d}.npy"), lab)
    log(f"tile directories: {TILES_DIR_TILES} tiles of {TILE_PX}², npy and png, written in "
        f"{time.perf_counter() - t0:.1f} s")
    return npy_dir, png_dir


def write_scene_dir(root: str) -> str:
    """``N_SCENES`` uint8 scenes at the sizes of
    ``docs/disk_fit/scene_scale.json`` (its six, cycled: 152.3 MPix in
    all), ``<stem>_img.npy`` and int32 ``<stem>.npy``, from the seed."""
    import numpy as np

    t0 = time.perf_counter()
    path = os.path.join(root, "scenes")
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(1)
    pixels = 0
    for i in range(N_SCENES):
        h, w = SCENE_SIZES[i % len(SCENE_SIZES)]
        img, lab = vaihingen_like(rng, h, w)
        np.save(os.path.join(path, f"scene_{i:02d}_img.npy"), img)
        np.save(os.path.join(path, f"scene_{i:02d}.npy"), lab)
        pixels += h * w
    log(f"scene directory: {N_SCENES} scenes, {pixels / 1e6:.1f} MPix, written in "
        f"{time.perf_counter() - t0:.1f} s")
    return path


def write_cityscapes(root: str) -> str:
    """A Cityscapes checkout's layout (``leftImg8bit/train/<city>`` RGB
    frames and ``gtFine/train/<city>`` labelIds, 2048×1024 PNGs) of
    ``CITYSCAPES_FRAMES`` frames from the seed, with void label ids (0, 1
    and 4 have no trainId), converted with the port's
    ``prepare_cityscapes`` (downscale 2, ``--format npy``) into 1024×512
    tiles.  Returns the tile directory."""
    import numpy as np

    from ddlpc_tpu_torch.data import png, prepare_cityscapes

    t0 = time.perf_counter()
    rng = np.random.default_rng(2)
    ids = np.array([0, 1, 4, 7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 26, 27, 28, 32, 33])
    for i in range(CITYSCAPES_FRAMES):
        city = ("aachen", "bochum")[i % 2]
        for kind in ("leftImg8bit", "gtFine"):
            os.makedirs(os.path.join(root, kind, "train", city), exist_ok=True)
        stem = f"{city}_{i:06d}_000019"
        img, lab = vaihingen_like(rng, *CITYSCAPES_FRAME)
        png.write_png(os.path.join(root, "leftImg8bit", "train", city, f"{stem}_leftImg8bit.png"), img,
                      level=1)
        label_ids = ids[(lab * 3 + rng.integers(0, 4, lab.shape)) % len(ids)].astype(np.uint8)
        png.write_png(os.path.join(root, "gtFine", "train", city, f"{stem}_gtFine_labelIds.png"),
                      label_ids, level=1)
    t1 = time.perf_counter()
    tiles = os.path.join(root, "tiles")
    prepare_cityscapes.main(["--root", root, "--split", "train", "--out", tiles, "--downscale", "2",
                             "--format", "npy"])
    log(f"cityscapes layout: {CITYSCAPES_FRAMES} frames of {CITYSCAPES_FRAME} written in {t1 - t0:.1f} s, "
        f"converted (python -m ddlpc_tpu_torch.data.prepare_cityscapes --downscale 2 --format npy) "
        f"in {time.perf_counter() - t1:.1f} s")
    return tiles


def write_fixtures(root: str) -> None:
    """The data phases' fixtures under ``root``: the tile directories, the
    scene directory and the converted Cityscapes layout.  A process of
    this script (``--fixtures``, :func:`start_fixtures`) writes them at
    the lowest CPU priority while the phases before the data phases run."""
    os.nice(19)
    write_tile_dirs(root)
    write_scene_dir(root)
    write_cityscapes(os.path.join(root, "cityscapes"))


def start_fixtures(root: str) -> subprocess.Popen:
    """Start the fixture writer; it is killed if this script exits first."""
    import atexit

    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--fixtures", root],
                            cwd=REPO)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def wait_fixtures(proc: subprocess.Popen) -> None:
    rc = proc.wait()
    if rc != 0:
        fail(f"the fixture writer (--fixtures) exited {rc}")


def host_rate(loader, epochs: int = 1) -> float:
    """Tiles a second the loader alone delivers onto the card: ``epochs``
    epochs through it, host clock, ending in a synchronize."""
    n = 0
    t0 = time.perf_counter()
    for e in range(epochs):
        loader.set_epoch(e)
        for images, _ in loader:
            n += images.shape[0] * images.shape[1]
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def loader_digest(loader, epoch: int) -> str:
    """The hash of one epoch of ``loader``'s batches (bf16 images by their
    bits)."""
    loader.set_epoch(epoch)
    return _digest(*(t.view(torch.int16) if t.dtype == torch.bfloat16 else t
                     for batch in loader for t in batch))


def data_path_row(label: str, run: dict) -> dict:
    """One data path's numbers, printed beside the card: the last epoch's
    step time, data wait and loader stages, the producer's tiles/s over
    its stages, the loader's delivered tiles/s alone (``host_rate``)
    against ``NEED_TILES_PER_S``, the idle share of a profiled step, the
    peak memory, MFU and the codec's launches."""
    trainer = run["trainer"]
    rec = run["epochs"][-1]
    stages = [rec.get(f"t_loader_{s}_s") or 0.0 for s in ("gather", "cast", "upload")]
    profiled = profile_phase(trainer, label)
    row = {"path": label, "loader": type(trainer.loader).__name__,
           "tiles_a_step": trainer.loader.super_batch, "step_time_s": rec["step_time_s"],
           "t_data_s": rec["t_data_s"], "t_loader_gather_s": rec.get("t_loader_gather_s"),
           "t_loader_cast_s": rec.get("t_loader_cast_s"), "t_loader_upload_s": rec.get("t_loader_upload_s"),
           "producer_tiles_per_s": trainer.loader.super_batch / sum(stages) if sum(stages) else None,
           "host_tiles_per_s": host_rate(trainer.loader), "need_tiles_per_s": NEED_TILES_PER_S,
           "idle_share": profiled["idle_share"], "profiled_step_ms": profiled["wall_ms"],
           "peak_gib": run["peak_bytes"] / 2**30, "mfu": rec["mfu"], "launches": run["launches"]}
    log(f"data path row: {json.dumps(row)} ({smi_line()})")
    return row


def free(run: dict) -> None:
    run.pop("trainer", None)
    gc.collect()
    torch.cuda.empty_cache()


def codec_expect(steps: int) -> dict:
    """The flagship's launches in ``steps`` steps (the nearest fp16 codec)."""
    return {"encode_to_wire": steps, "decode_from_wire": steps, "fake_quantize_fused": steps,
            "absmax": 2 * steps}


def tiles_dir_phase(root: str) -> dict:
    """``flagship_tiles_dir``: the flagship as written from a tile
    directory (``--set data.data_dir=``), ``DATA_EPOCHS`` epochs (one step
    each) three ways: (a) npy, eager, the device cache as written; (b) png,
    eager, whose losses must be (a)'s bits; (c) npy, ``lazy_tiles``, the
    host loader with four workers and the compact wire, whose first loss
    must be (a)'s bits and any later one within one fp32 ulp of it."""
    import numpy as np

    npy_dir, png_dir = tile_dirs(root)
    runs, rows = {}, {}
    for label, data_dir, extra, loader in (
        ("tiles_npy_eager", npy_dir, (), "DeviceCachedLoader"),
        ("tiles_png_eager", png_dir, (), "DeviceCachedLoader"),
        ("tiles_npy_lazy_compact_w4", npy_dir, ("data.lazy_tiles=True", "data.device_cache=False",
                                                 "data.loader_workers=4", "data.compact_upload=True"),
         "ShardedLoader"),
    ):
        run = main_path_phase(label, (f"data.data_dir={data_dir}", *extra), codec_expect(DATA_EPOCHS),
                              warns=False, epochs=DATA_EPOCHS, micro_batch=None, loader=loader)
        if len(run["trainer"].train_ds) != TILES_DIR_TILES - 30:
            fail(f"[{label}] {len(run['trainer'].train_ds)} training tiles, expected {TILES_DIR_TILES - 30}")
        rows[label] = data_path_row(label, run)
        free(run)
        runs[label] = run
    a = runs["tiles_npy_eager"]["losses"]
    if runs["tiles_png_eager"]["losses"] != a:
        fail(f"[flagship_tiles_dir] png losses {runs['tiles_png_eager']['losses']} != npy's {a}")
    c = runs["tiles_npy_lazy_compact_w4"]["losses"]
    ulp = [float(abs(np.float32(x) - np.float32(y)) / np.spacing(np.float32(y))) for x, y in zip(c, a)]
    if c[0] != a[0] or max(ulp) > 1:
        fail(f"[flagship_tiles_dir] lazy compact losses {c} against npy's {a}: {ulp} ulp")
    log(f"[flagship_tiles_dir] losses: npy {a}, png == npy bit for bit, lazy+compact+4 workers {c} "
        f"({ulp} ulp from npy's)")
    return {"runs": runs, "rows": rows}


def scenes_phase(root: str) -> dict:
    """``flagship_scenes``: the flagship as written over a scene directory
    at the reference's scale (``write_scene_dir``) in crop mode,
    ``crops_per_epoch=512, test_split_scenes=1, device_cache=false``,
    ``DATA_EPOCHS`` epochs: eager, then ``mmap_scenes, augment, compact_upload,
    loader_workers=4``.  Each loader's first epoch must equal by digest
    the same loader's over the other residency: the eager run's against an
    mmap loading of the same settings, the mmap run's against the eager
    scenes under its own augmentation, wire and workers."""
    from ddlpc_tpu_torch.data.datasets import DihedralAugment, build_dataset
    from ddlpc_tpu_torch.data.loader import ShardedLoader

    scenes = os.path.join(root, "scenes")
    base = (f"data.data_dir={scenes}", "data.crops_per_epoch=512", "data.test_split_scenes=1",
            "data.device_cache=False")
    rows, runs = {}, {}
    eager = main_path_phase("scenes_eager", base, codec_expect(DATA_EPOCHS), warns=False,
                            epochs=DATA_EPOCHS, micro_batch=None, loader="ShardedLoader")
    rows["scenes_eager"] = data_path_row("scenes_eager", eager)
    data_cfg = eager["trainer"].cfg.data

    def twin(ds, loader):
        return ShardedLoader(ds, micro_batch=loader.micro_batch, sync_period=loader.sync_period,
                             device=loader.device, seed=data_cfg.seed, compact=loader.compact,
                             workers=loader.workers)

    t0 = time.perf_counter()
    mmap_train, _ = build_dataset(dataclasses.replace(data_cfg, mmap_scenes=True))
    log(f"[flagship_scenes] mmap load {time.perf_counter() - t0:.3f} s")
    loader = eager["trainer"].loader
    digest = loader_digest(loader, 0)
    if digest != loader_digest(twin(mmap_train, loader), 0):
        fail("[flagship_scenes] the eager loader's batches differ from mmap's by digest")
    eager_train = eager["trainer"].train_ds
    del loader, mmap_train
    free(eager)
    runs["scenes_eager"] = eager
    mmap = main_path_phase(
        "scenes_mmap_aug_compact_w4",
        (*base, "data.mmap_scenes=True", "data.augment=True", "data.compact_upload=True",
         "data.loader_workers=4"),
        codec_expect(DATA_EPOCHS), warns=False, epochs=DATA_EPOCHS, micro_batch=None,
        loader="ShardedLoader")
    rows["scenes_mmap_aug_compact_w4"] = data_path_row("scenes_mmap_aug_compact_w4", mmap)
    loader = mmap["trainer"].loader
    if loader_digest(loader, 0) != loader_digest(
            twin(DihedralAugment(eager_train, seed=data_cfg.seed), loader), 0):
        fail("[flagship_scenes] the mmap loader's batches differ from eager's by digest")
    log(f"[flagship_scenes] an epoch of 512 crops: eager == mmap by digest, plain ({digest}) and "
        f"augmented + compact + 4 workers")
    del loader
    free(mmap)
    runs["scenes_mmap_aug_compact_w4"] = mmap
    return {"runs": runs, "rows": rows}


def cityscapes_phase(root: str) -> dict:
    """``cityscapes_full_width``: ``configs/cityscapes_unet_v5e64.json`` as
    written at one replica (``parallel.data_axis_size=-1``), synthetic,
    ``DATA_EPOCHS`` epochs of 7 steps (fp16 codec with
    ``quantize_local=false``: the fake-quantize of the mean and its
    max-abs, once a step); then ``DATA_EPOCHS`` epochs of 1 step from a
    converted Cityscapes layout (``write_cityscapes``) with
    void labels, ``data.test_split`` cut to 8 for the 24 frames."""
    rows, runs = {}, {}
    for label in CITYSCAPES_STEPS:
        extra = ()
        if label == "cityscapes_dir":
            extra = (f"data.data_dir={os.path.join(root, 'cityscapes', 'tiles')}",
                     "data.test_split=8")
        steps = CITYSCAPES_STEPS[label]
        run = main_path_phase(label, ("parallel.data_axis_size=-1", *extra),
                              {"fake_quantize_fused": DATA_EPOCHS * steps, "absmax": DATA_EPOCHS * steps},
                              warns=False, config=CITYSCAPES, epochs=DATA_EPOCHS, micro_batch=None,
                              flops=CITYSCAPES_FLOPS, loader="ShardedLoader")
        trainer = run["trainer"]
        if trainer.state.step != DATA_EPOCHS * steps:
            fail(f"[{label}] {trainer.state.step} optimizer steps, expected {DATA_EPOCHS} x {steps}")
        void = float((trainer.test_ds.labels == -1).mean())
        if label == "cityscapes_dir" and not 0 < void < 1:
            fail(f"[{label}] eval labels void share {void}: the layout's void ids were lost")
        log(f"[{label}] {run['n_params']} parameters, {trainer.state.step} steps, eval void share "
            f"{void:.4f}, peak {run['peak_bytes'] / 2**30:.2f} GiB ({smi_line()})")
        del trainer
        rows[label] = data_path_row(label, run)
        free(run)
        runs[label] = run
    return {"runs": runs, "rows": rows}


def path_row(label: str, records: list, perf: list) -> list:
    """Each epoch's times, MFU and goodput, printed beside the card."""
    rows = [{"epoch": r["epoch"], "epoch_time_s": r["epoch_time_s"], "step_time_s": r["step_time_s"],
             "t_data_s": r.get("t_data_s"), "t_step_s": r.get("t_step_s"),
             **{k: r[k] for k in ("t_loader_gather_s", "t_loader_cast_s", "t_loader_upload_s") if k in r},
             "mfu": p["mfu"], "goodput": p["goodput"]} for r, p in zip(records, perf)]
    card = smi_line()
    for row in rows:
        log(f"[{label}] epoch {row['epoch']}: " + " ".join(f"{k} {v}" for k, v in row.items() if k != "epoch")
            + f" ({card})")
    return rows


def perf_checks(label: str, lines: list, flops: int, epochs: int = EPOCHS) -> list:
    """Every epoch's ``kind="perf"`` record: the FLOP model's exact count
    (0 if it failed), the card's peak known, MFU > 0, and the reconciliation
    productive + debits <= wall."""
    perf = [r for r in lines if r.get("kind") == "perf"]
    if len(perf) != epochs:
        fail(f"[{label}] expected {epochs} perf records, got {len(perf)}")
    for r in perf:
        debits = sum(v for k, v in r.items() if k.startswith("debit_"))
        if (r["flops_per_step"] != flops or r["peak_flops_assumed"] or not r["mfu"] > 0
                or r["productive_s"] + debits > r["wall_s"] + 1e-3):
            fail(f"[{label}] perf record {r}: expected flops_per_step {flops}, a known peak, "
                 f"MFU > 0 and productive + debits <= wall")
    log(f"[{label}] perf records: flops_per_step {flops} on every epoch, peak "
        f"{perf[0]['peak_flops_per_device']:.3e} known; " + json.dumps(perf[-1]))
    return perf


def loader_equal(label: str, trainer, loader, epochs: int) -> int:
    """``loader``'s batches of ``epochs`` epochs, every batch held at once,
    against ``DeviceLoader``'s (the plain host path) on the same split,
    seed, replica and wire, with ``torch.equal``.  Returns the batch
    count."""
    from ddlpc_tpu_torch.data.loader import DeviceLoader

    plain = DeviceLoader(trainer.train_ds, micro_batch=loader.micro_batch,
                         sync_period=loader.sync_period, device=trainer.device,
                         shuffle=trainer.cfg.data.shuffle, seed=trainer.cfg.data.seed,
                         replica=loader.replica, world=loader.world, compact=loader.compact,
                         space=loader.space)
    n = 0
    for e in range(epochs):
        loader.set_epoch(e)
        plain.set_epoch(e)
        held = list(loader)
        for (gi, gl), (wi, wl) in zip(held, plain):
            if not (gi.dtype == wi.dtype and gl.dtype == wl.dtype
                    and torch.equal(gi, wi) and torch.equal(gl, wl)):
                fail(f"[{label}] {type(loader).__name__} batch {n} of epoch {e} differs from "
                     f"DeviceLoader's")
            n += 1
        del held
    log(f"[{label}] {type(loader).__name__}: {n} batches of {epochs} epoch(s), micro {loader.micro_batch} "
        f"x sync {loader.sync_period}, replica {loader.replica} of {loader.world}, compact "
        f"{loader.compact}, == DeviceLoader's (torch.equal)")
    return n


def read_png(path: str):
    """An 8-bit RGB PNG whose rows are all filter 0 (what the trainer's
    writer emits), decoded with zlib; each chunk's CRC checked."""
    import struct
    import zlib

    import numpy as np

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        fail(f"{path}: not a PNG")
    pos, idat, size = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0] != zlib.crc32(kind + body):
            fail(f"{path}: bad CRC on {kind}")
        if kind == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
            if (depth, color) != (8, 2):
                fail(f"{path}: depth {depth}, color type {color}")
            size = (h, w)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    h, w = size
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        fail(f"{path}: a row filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def png_checks(label: str, trainer, epochs: int = EPOCHS) -> None:
    """``IMAGES_PER_EPOCH`` triples an epoch; the last epoch's decode to
    the palette of the final state's predictions and of the labels (void
    drawn as class 0, as the writer draws it), and to the image at x255."""
    import numpy as np

    from ddlpc_tpu_torch.train.observability import class_palette

    root = os.path.join(trainer.workdir, "images")
    want = sorted(f"{k} {i}.png" for k in ("Model", "Label", "Image") for i in range(IMAGES_PER_EPOCH))
    for e in range(epochs):
        got = sorted(os.listdir(os.path.join(root, f"epoch_{e:04d}")))
        if got != want:
            fail(f"[{label}] images of epoch {e}: {got}")
    images = trainer.test_ds.images[:IMAGES_PER_EPOCH]
    labels = trainer.test_ds.labels[:IMAGES_PER_EPOCH]
    preds = trainer.predict(images)
    pal = class_palette(trainer.cfg.model.num_classes)
    last = os.path.join(root, f"epoch_{epochs - 1:04d}")
    for i in range(IMAGES_PER_EPOCH):
        for kind, rgb in (("Model", pal[preds[i]]), ("Label", pal[np.clip(labels[i], 0, len(pal) - 1)]),
                          ("Image", np.clip(images[i] * 255.0, 0, 255).astype(np.uint8))):
            if not np.array_equal(read_png(os.path.join(last, f"{kind} {i}.png")), rgb):
                fail(f"[{label}] {kind} {i}.png of epoch {epochs - 1} does not decode to its pixels")
    log(f"[{label}] {len(want)} PNGs an epoch; epoch {epochs - 1}'s decode (zlib) to palette[pred], "
        f"palette[label] and the image; predicted classes {np.bincount(preds.ravel(), minlength=len(pal)).tolist()}")


ANALYSIS_DEADLINE_S = 300
PROGRAMS_DEADLINE_S = 420  # each of the program auditor's two runs


def _programs_runs(out: str, into: dict, after: subprocess.Popen) -> None:
    """The program auditor's two runs, one after the other: every arm
    (``--out``), then the extra-collective injection, once the checker's
    process ``after`` has exited (or its deadline passed), so that the
    checker's seconds are not the auditor's ranks' share of the cores.
    Each runs in a session of its own, killed whole (its ranks too) at the
    deadline."""
    end = time.monotonic() + ANALYSIS_DEADLINE_S
    while after.poll() is None and time.monotonic() < end:
        time.sleep(0.5)
    base = [sys.executable, "-m", "ddlpc_tpu_torch.analysis.check", "--programs"]
    for name, argv in (("arms", ["--out", out]), ("inject", ["--inject", "extra-collective"])):
        t0 = time.perf_counter()
        proc = subprocess.Popen(base + argv, cwd=REPO, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True, start_new_session=True)
        try:
            text, _ = proc.communicate(timeout=PROGRAMS_DEADLINE_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            text, _ = proc.communicate()
            text += f"\n(killed at {PROGRAMS_DEADLINE_S} s)"
        into[name] = {"rc": proc.returncode, "text": text, "s": time.perf_counter() - t0}


def start_analysis() -> tuple:
    """The analysis phase's checker: ``python -m ddlpc_tpu_torch.analysis.check
    --sanitize`` in a process of its own (the import tiers, the AST rules,
    the lock smoke on this card, and the host batch kernel's self-test
    under ASan, UBSan and, where it works, TSan), its ``kind="analysis"``
    stream into ``WORKDIR``, and the program auditor's thread, whose runs
    wait for the checker to exit.  Started after the kernel-timing
    phases."""
    out = os.path.join(WORKDIR, "analysis.jsonl")
    if os.path.exists(out):
        os.remove(out)
    proc = subprocess.Popen(
        [sys.executable, "-m", "ddlpc_tpu_torch.analysis.check", "--sanitize", "--out", out],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    programs_out = os.path.join(WORKDIR, "programs.jsonl")
    if os.path.exists(programs_out):
        os.remove(programs_out)
    programs: dict = {}
    thread = threading.Thread(target=_programs_runs, args=(programs_out, programs, proc),
                              daemon=True)
    thread.start()
    return proc, out, thread, programs, programs_out


def analysis_phase(started: tuple) -> dict:
    """The checker's process must exit 0 with no violation and no
    suppression (its output printed); then, in this process, the lock
    smoke with the detector on: its ring arm on pinned slots with live
    CUDA events, its checkpointer saving a state on the card; no cycle,
    no guarded-by violation, every arm run."""
    from ddlpc_tpu_torch.analysis import lockcheck
    from ddlpc_tpu_torch.analysis.lock_fixtures import run_smoke

    proc, out, thread, programs, programs_out = started
    try:
        text, _ = proc.communicate(timeout=ANALYSIS_DEADLINE_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"[analysis] the checker ran past {ANALYSIS_DEADLINE_S} s")
    log("[analysis] checker: " + " | ".join(text.strip().splitlines()))
    if proc.returncode != 0:
        fail(f"[analysis] the checker exited {proc.returncode}")
    with open(out) as f:
        summary = [json.loads(line) for line in f][-1]
    if summary["violations"] or summary["suppressed"]:
        fail(f"[analysis] the checker's summary: {summary}")
    lockcheck.enable()
    lockcheck.reset()
    try:
        smoke = run_smoke(workdir=WORKDIR, device="cuda")
    finally:
        lockcheck.disable()
        lockcheck.reset()
    arms = ["MicroBatcher", "Tracer", "HealthMonitor", "CircuitBreaker", "StageTimer", "_Ring",
            "AsyncCheckpointer"]
    if smoke["cycles"] or smoke["guard_violations"] or smoke["arms"] != arms:
        fail(f"[analysis] lock smoke on the card: {smoke}")
    row = {"files": summary["files_scanned"], "checker_s": summary["duration_s"],
           "rules": summary["rules_run"],
           "violations": 0, "suppressed": 0, "lock_smoke": smoke,
           "sanitizers": [line for line in text.splitlines()
                          if line.startswith(("asan:", "ubsan:", "tsan"))]}
    row["programs"] = programs_checks(thread, programs, programs_out)
    return row


def programs_checks(thread, programs: dict, out: str) -> dict:
    """The program auditor's runs: every arm clean on the card (exit 0, 28
    arms, 36 programs in JAX's order, no violation, each program's codec
    calls equal to its launches, which the contracts hold, and no
    ``census-drift`` against the committed baseline, which the CPU wrote),
    and the injection caught (exit 1, naming ``int8_simulate`` and
    ``comm-closed-form``)."""
    from ddlpc_tpu_torch.analysis import program

    thread.join(2 * PROGRAMS_DEADLINE_S)
    if thread.is_alive() or set(programs) != {"arms", "inject"}:
        fail(f"[analysis] the program auditor's runs did not end: {sorted(programs)}")
    arms, inject = programs["arms"], programs["inject"]
    log("[analysis] program auditor: " + " | ".join(
        line for line in arms["text"].strip().splitlines()[-40:]
        if line.startswith("program_audit")))
    log("[analysis] program auditor --inject extra-collective: "
        + " | ".join(inject["text"].strip().splitlines()[-6:]))
    if arms["rc"] != 0:
        fail(f"[analysis] the program auditor exited {arms['rc']}")
    with open(out) as f:
        recs = [json.loads(line) for line in f]
    summary, audits = recs[-1], [r for r in recs if r.get("record") == "audit"]
    if (summary.get("record") != "summary" or summary["violations"] or summary["census_drift"]
            or summary["world"] != 8 or summary["device"] != "cuda:0"
            or summary["arms"] != len(program.ARMS) or summary["baseline"] is None
            or [a["program"] for a in audits] != list(program.PROGRAMS)):
        fail(f"[analysis] the program auditor's stream: {summary}, "
             f"programs {[a['program'] for a in audits]}")
    caught = "VIOLATION int8_simulate/step+extra-collective: [comm-closed-form]"
    if inject["rc"] != 1 or caught not in inject["text"]:
        fail(f"[analysis] --inject extra-collective exited {inject['rc']} without {caught!r}")
    return {"arms": summary["arms"], "programs": len(audits), "violations": 0,
            "census_drift": 0, "baseline": summary["baseline"], "world": summary["world"],
            "device": summary["device"], "audit_s": summary["seconds"],
            "process_s": round(arms["s"], 3), "inject_rc": inject["rc"],
            "inject_process_s": round(inject["s"], 3),
            "wire_bytes": {a["program"]: a["wire_bytes"] for a in audits if a["wire_bytes"]},
            "codec_calls": {a["program"]: a["codec_calls"] for a in audits if a["codec_calls"]}}


def sqrt_phase() -> dict:
    """Adam's square root (ROADMAP C7): how many of 2**23 fp32 values,
    log-uniform over 1e-12..1e2, ``torch.sqrt`` rounds otherwise than the
    correctly rounded root (the fp64 root rounded once), on the card and on
    this host's CPU.  ``optim.sqrt_rn`` takes ``torch.sqrt`` on a card, so
    a difference there fails the run."""
    from ddlpc_tpu_torch.train.optim import sqrt_rn

    g = torch.Generator(device="cuda").manual_seed(2)
    lo, hi = math.log(1e-12), math.log(1e2)
    u = torch.rand(1 << 23, generator=g, device="cuda", dtype=torch.float64)
    x = torch.exp(u * (hi - lo) + lo).float()
    exact = sqrt_rn(x.cpu())  # the fp64 root rounded once
    row = {"values": x.numel(),
           "cuda_differs": int((torch.sqrt(x).cpu() != exact).sum()),
           "cpu_differs": int((torch.sqrt(x.cpu()) != exact).sum())}
    log(f"sqrt: torch.sqrt differs from the correctly rounded root on {row['cuda_differs']} "
        f"of {row['values']} fp32 values on the card, {row['cpu_differs']} on the CPU")
    if row["cuda_differs"]:
        fail("torch.sqrt on the card is not correctly rounded: Adam's sqrt_rn needs the fp64 route there")
    return row


def checkpoint_phase(trainer, argv: list, losses: list) -> dict:
    """The fp16 main path's checkpoints (``EPOCHS`` of them, one an epoch):
    verified, resumed from epoch 1 to the uninterrupted epoch 2's bits,
    one corrupted and fallen back from; the same resume from epoch 1's
    state rewritten as a legacy monolithic blob (:func:`monolithic_resume`);
    then a save's cost on the live trainer (module docstring, phase 4b)."""
    import shutil

    from ddlpc_tpu_torch.train import checkpoint as ckpt
    from ddlpc_tpu_torch.train.__main__ import parse_args
    from ddlpc_tpu_torch.train.trainer import Trainer

    final = _canonical_digest(trainer.state)
    steps = ckpt._steps(trainer.ckpt_dir)
    if steps != list(range(1, EPOCHS + 1)):
        fail(f"checkpoint steps {steps}, expected one an epoch")
    newest = os.path.join(trainer.ckpt_dir, f"ckpt_{EPOCHS}.dwc")
    for s in steps:
        summary = ckpt.verify_checkpoint(os.path.join(trainer.ckpt_dir, f"ckpt_{s}.dwc"))
        if summary["verified_chunks"] != summary["chunks"]:
            fail(f"checkpoint {s}: {summary}")
    manifest = ckpt._read_manifest_tail(newest)
    raw = sum(c[2] for leaf in manifest["leaves"] for c in leaf.get("chunks", []))
    row = {"card": smi_line(), "raw_bytes": raw, "disk_bytes": os.path.getsize(newest),
           "chunks": summary["chunks"]}

    # A fresh Trainer on a copy whose newest checkpoint is epoch 1.
    work = os.path.join(WORKDIR, "checkpoint_resume")
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(trainer.workdir, work)
    for suffix in (".dwc", ".json"):
        os.remove(os.path.join(work, "checkpoints", f"ckpt_{EPOCHS}{suffix}"))
    os.remove(os.path.join(work, "metrics.jsonl"))
    at = argv.index("--workdir")
    cfg, _, device, backend = parse_args(
        [a for a in argv[:at] + ["--workdir", work] + argv[at + 2:] if a != "--no-resume"])
    fresh = Trainer(cfg, resume=False, device=device, dist_backend=backend)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh._restore_synchronized()
    torch.cuda.synchronize()
    row["restore_ms"] = (time.perf_counter() - t0) * 1e3
    if (fresh.start_epoch, fresh.state.step) != (EPOCHS - 1, EPOCHS - 1):
        fail(f"resume from epoch {EPOCHS - 2}: start epoch {fresh.start_epoch}, step {fresh.state.step}")
    fresh.fit()
    with open(os.path.join(work, "metrics.jsonl")) as f:
        resumed = [r for r in map(json.loads, f) if "kind" not in r]
    if [r["epoch"] for r in resumed] != [EPOCHS - 1] or resumed[0]["loss"] != losses[-1]:
        fail(f"resumed epoch {resumed} != the uninterrupted epoch {EPOCHS - 1}'s loss {losses[-1]}")
    log(f"[checkpoint] resumed from epoch {EPOCHS - 2}: epoch {EPOCHS - 1} loss "
        f"{resumed[0]['loss']} == uninterrupted {losses[-1]} (bit for bit)")
    del fresh

    # One flipped byte in the newest blob: quarantined, the fallback taken.
    bad = os.path.join(work, "checkpoints", f"ckpt_{EPOCHS}.dwc")
    with open(bad, "r+b") as f:
        f.seek(12)
        b = f.read(1)
        f.seek(12)
        f.write(bytes([b[0] ^ 0xFF]))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, meta = ckpt.restore_checkpoint(os.path.join(work, "checkpoints"))
    if (meta["step"] != EPOCHS - 1 or meta.get("quarantined_steps") != [EPOCHS]
            or not os.path.exists(bad + ".bad") or not caught):
        fail(f"corrupt blob: restored step {meta['step']}, {meta.get('quarantined_steps')}")
    log(f"[checkpoint] a flipped byte in ckpt_{EPOCHS}.dwc: quarantined, restored step {meta['step']}")
    row["monolithic"] = monolithic_resume(trainer, argv, losses, final)

    # The save's cost on the live trainer, three times: a step with no save
    # in flight, a save (the stall), a step while it writes, the write.
    images, labels = next(iter(trainer.loader))
    ac = trainer.checkpointer
    timing_dir = os.path.join(WORKDIR, "checkpoint_timing", "checkpoints")
    shutil.rmtree(timing_dir, ignore_errors=True)

    def step_s() -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer.train_step(trainer.state, images, labels)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    runs = []
    for _ in range(3):
        ac.wait()
        idle = step_s()
        step = trainer.state.step
        ac.save(timing_dir, trainer.state, step, metadata=trainer._metadata(EPOCHS, step))
        stall, started = ac.last_stall_s, ac.in_flight
        busy = step_s()
        overlapped = ac.in_flight
        ac.wait()
        runs.append({"step_idle_s": idle, "stall_ms": stall * 1e3, "step_with_save_s": busy,
                     "write_ms": ac.last_write_s * 1e3, "in_flight_at_step": started,
                     "in_flight_after_step": overlapped})
    pageable = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ckpt.snapshot_state(trainer.state)
        pageable.append((time.perf_counter() - t) * 1e3)
    row["runs"] = runs
    row["stall_ms"] = statistics.median(r["stall_ms"] for r in runs)
    row["stall_pageable_ms"] = statistics.median(pageable)
    row["write_ms"] = statistics.median(r["write_ms"] for r in runs)
    row["write_gb_per_s"] = raw / row["write_ms"] / 1e6
    row["step_idle_s"] = statistics.median(r["step_idle_s"] for r in runs)
    row["step_with_save_s"] = statistics.median(r["step_with_save_s"] for r in runs)
    # The wire's two implementations in turns on this host (native,
    # Python, Python, native): the background write and the restore.
    from ddlpc_tpu_torch.utils import wire

    wires = {"native": [], "python": []}
    for name in ("native", "python", "python", "native"):
        wire.set_native(name == "native")
        step = trainer.state.step
        ac.save(timing_dir, trainer.state, step, metadata=trainer._metadata(EPOCHS, step))
        ac.wait()
        t = time.perf_counter()
        ckpt.restore_checkpoint(timing_dir)
        wires[name].append({"write_ms": ac.last_write_s * 1e3,
                            "restore_ms": (time.perf_counter() - t) * 1e3})
    wire.set_native(True)
    row["wire_ab"] = wires
    log("checkpoint row: " + json.dumps(row))
    return row


def monolithic_resume(trainer, argv: list, losses: list, final: str) -> dict:
    """The fp16 flagship's epoch-1 state (``ckpt_{EPOCHS-1}``) rewritten as a
    legacy monolithic blob (``ckpt_<step>.msgpack.z``: the port's flax
    msgpack codec, one DWZ1 frame) in a copy of the workdir, its ``.dwc``
    dropped: verified (JAX's summary), resumed by a fresh ``Trainer`` to
    the uninterrupted epoch 2's loss and canonical state bit for bit, with
    one fp16 step's kernel launches; a corrupted copy quarantined and
    fallen back from.  Times the save and the restore of each format on
    the same tree and prints them beside the card."""
    import shutil

    from ddlpc_tpu_torch.ops import cuda_quantize as cq
    from ddlpc_tpu_torch.train import checkpoint as ckpt
    from ddlpc_tpu_torch.train.__main__ import parse_args
    from ddlpc_tpu_torch.train.trainer import Trainer

    step = EPOCHS - 1
    work = os.path.join(WORKDIR, "checkpoint_monolithic")
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(trainer.workdir, work)
    ckpt_dir = os.path.join(work, "checkpoints")
    for suffix in (".dwc", ".json"):
        os.remove(os.path.join(ckpt_dir, f"ckpt_{EPOCHS}{suffix}"))
    os.remove(os.path.join(work, "metrics.jsonl"))
    tree, meta = ckpt.restore_checkpoint(ckpt_dir, step=step)
    flat = ckpt.flatten_tree(tree)
    os.remove(os.path.join(ckpt_dir, f"ckpt_{step}.dwc"))
    row = {"card": smi_line()}
    # Each format's synchronous save (the tree in, the durable blob out)
    # and restore of the same tree, in turns: chunked, monolithic, twice.
    timing = os.path.join(WORKDIR, "checkpoint_formats")
    times = {"chunked": [], "monolithic": []}
    for fmt in ("chunked", "monolithic", "monolithic", "chunked"):
        d = os.path.join(timing, fmt)
        shutil.rmtree(d, ignore_errors=True)
        t0 = time.perf_counter()
        path = ckpt.save_snapshot(d, flat, step, metadata=meta, format=fmt)
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ckpt.restore_checkpoint(d)
        times[fmt].append({"save_ms": save_ms, "restore_ms": (time.perf_counter() - t0) * 1e3,
                           "disk_bytes": os.path.getsize(path)})
    for fmt, runs in times.items():
        row[fmt] = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    path = ckpt.save_snapshot(ckpt_dir, flat, step, metadata=meta, format="monolithic")
    summary = ckpt.verify_checkpoint(path)
    row["raw_bytes"] = summary["bytes"]
    if summary != {"format": "monolithic", "bytes": summary["bytes"], "verified_chunks": 0} or (
            ckpt.checkpoint_path(ckpt_dir, step) != (path, "monolithic")):
        fail(f"[checkpoint] the monolithic blob {path} verifies as {summary}")
    bad_dir = os.path.join(WORKDIR, "checkpoint_monolithic_bad")
    shutil.rmtree(bad_dir, ignore_errors=True)
    shutil.copytree(ckpt_dir, bad_dir)

    at = argv.index("--workdir")
    cfg, _, device, backend = parse_args(
        [a for a in argv[:at] + ["--workdir", work] + argv[at + 2:] if a != "--no-resume"])
    fresh = Trainer(cfg, resume=False, device=device, dist_backend=backend)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh._restore_synchronized()
    torch.cuda.synchronize()
    row["trainer_restore_ms"] = (time.perf_counter() - t0) * 1e3
    if (fresh.start_epoch, fresh.state.step) != (step, step):
        fail(f"[checkpoint] monolithic resume: start epoch {fresh.start_epoch}, step {fresh.state.step}")
    cq.reset_launch_counts()
    fresh.fit()
    torch.cuda.synchronize()
    launches = dict(cq.LAUNCHES)
    want = {name: 0 for name in launches}
    want.update(encode_to_wire=1, decode_from_wire=1, fake_quantize_fused=1, absmax=2)
    with open(os.path.join(work, "metrics.jsonl")) as f:
        resumed = [r for r in map(json.loads, f) if "kind" not in r]
    got = _canonical_digest(fresh.state)
    if [r["epoch"] for r in resumed] != [step] or resumed[0]["loss"] != losses[-1] or got != final:
        fail(f"[checkpoint] the monolithic resume's epoch {resumed} / state {got[:16]} != the "
             f"uninterrupted epoch {step}'s loss {losses[-1]} / state {final[:16]}")
    if launches != want:
        fail(f"[checkpoint] the monolithic resume's kernel launches {launches}, expected {want}")
    row["launches"] = launches
    log(f"[checkpoint] resumed from ckpt_{step}.msgpack.z (monolithic): epoch {step} loss "
        f"{resumed[0]['loss']} == uninterrupted {losses[-1]}, canonical state {got[:16]} == "
        f"uninterrupted (bit for bit); kernels {json.dumps(launches)}")
    del fresh

    bad = os.path.join(bad_dir, f"ckpt_{step}.msgpack.z")
    with open(bad, "r+b") as f:
        f.seek(12)
        b = f.read(1)
        f.seek(12)
        f.write(bytes([b[0] ^ 0xFF]))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, meta = ckpt.restore_checkpoint(bad_dir)
    if (meta["step"] != step - 1 or meta.get("quarantined_steps") != [step]
            or not os.path.exists(bad + ".bad") or not caught):
        fail(f"[checkpoint] corrupt monolithic blob: restored step {meta['step']}, "
             f"{meta.get('quarantined_steps')}")
    log(f"[checkpoint] a flipped byte in ckpt_{step}.msgpack.z: quarantined, restored step "
        f"{meta['step']} (ckpt_{step - 1}.dwc)")
    log("checkpoint row (monolithic against chunked: a synchronous save and a restore of "
        "epoch 1's tree): " + json.dumps(row))
    return row


def profile_phase(trainer, label: str) -> dict:
    """One more optimizer step of the path under ``torch.profiler``: device
    time by kernel, the device's idle share over the step (1 − summed
    kernel time / wall time; one stream, so kernels do not overlap), and
    the step's FLOPs — counted with ``FlopCounterMode`` on one tile's
    forward and backward, times the super-batch — against the bf16 peak.
    Returns the step's wall and busy ms, idle share and launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    from ddlpc_tpu_torch.parallel.train_step import loss_from_logits

    images, labels = next(iter(trainer.loader))
    model = trainer.state.model
    model.train()
    with FlopCounterMode(display=False) as counter:
        loss, _ = loss_from_logits(model(images[0, :1]), labels[0, :1],
                                   getattr(model, "train_head_layout", "fullres"))
        loss.backward()
    step_flops = counter.get_total_flops() * trainer.loader.super_batch
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(trainer.state, images, labels)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        fail("the profiler recorded no device kernels")
    busy_s = sum(e.time_range.elapsed_us() for e in kernels) * 1e-6
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() * 1e-3
    log(f"[{label}] profiled step: wall {wall_s * 1e3:.3f} ms, device busy {busy_s * 1e3:.3f} ms, "
        f"idle share {1.0 - busy_s / wall_s:.4f}, {len(kernels)} kernel launches")
    log(f"[{label}] profiled step: {step_flops:.6e} FLOP (one tile x {trainer.loader.super_batch}), "
        f"{step_flops / wall_s / 1e12:.2f} TFLOP/s = "
        f"{step_flops / wall_s / BF16_FLOPS_PER_S:.4f} of the bf16 peak")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:20]:
        log(f"  {ms:10.3f} ms  {ms / (busy_s * 1e3):.4f}  {name[:110]}")
    codec = {n: ms for n, ms in by_name.items()
             if any(k in n for k in ("encode_", "decode_kernel", "fake_quantize_", "absmax"))}
    log(f"[{label}] codec kernels in the step: {sum(codec.values()):.4f} ms, "
        + ", ".join(f"{n[:60]} {ms:.4f} ms" for n, ms in sorted(codec.items())))
    return {"wall_ms": wall_s * 1e3, "busy_ms": busy_s * 1e3, "idle_share": 1.0 - busy_s / wall_s,
            "launches": len(kernels)}


def shard_kernel_rows(n: int) -> list:
    """The zero2 path's kernels on one replica's chunk of the flagship's
    flat buffer at 4 and 8 replicas (K = ``flat_chunk_rows(n, N)``):
    decode from the f16 wire, the max-abs pass, and the fake-quantize
    wrapper in place against a given max-abs (the mean stage), each held
    against its plain version bit for bit, then timed on the card's clock
    (``time_ms``) and on the host's (``host_ms``, a wrapper's time a
    call).  Where a row's host time exceeds its device time, the host
    bounds that call."""
    from ddlpc_tpu_torch.config import CompressionConfig
    from ddlpc_tpu_torch.ops import cuda_quantize as cq
    from ddlpc_tpu_torch.ops import quantize as plain
    from ddlpc_tpu_torch.parallel.shard_update import flat_chunk_rows

    cfg = CompressionConfig(mode="float16")
    levels = float(plain.levels_for(cfg))
    rows = []
    for shards in (4, 8):
        k = flat_chunk_rows(n, shards)
        x = codec_inputs(k, levels)
        amax = cq.absmax(x)
        safe = plain.safe_divisor(amax)
        inv = plain.times_reciprocal(amax, levels * shards)
        q = cq.encode_to_wire(x, safe, cfg, torch.float16)
        out = torch.empty_like(x)
        fq_in = x.clone()
        must_equal(f"decode at K={k}", cq.decode_from_wire(q, inv), plain.decode_with_inv(q, inv))
        must_equal(f"absmax at K={k}", cq.absmax(x), x.abs().amax().reshape(1))
        must_equal(f"fake_quantize(amax=) at K={k}", cq.fake_quantize_fused(x, cfg, amax=amax),
                   cq.fake_quantize_plain(x, cfg, amax=amax))
        for name, fn, n_bytes in (
            ("decode_from_wire", lambda: cq.decode_from_wire(q, inv, out=out), 6 * k + 4),
            ("absmax", lambda: cq.absmax(x), 4 * k + 4),
            ("fake_quantize_fused", lambda: cq.fake_quantize_fused(fq_in, cfg, out=fq_in, amax=amax),
             8 * k + 4),
        ):
            row = {"name": name, "shards": shards, "k": k, "ms": time_ms(fn), "host_ms": host_ms(fn),
                   "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3}
            row["host_bound"] = row["host_ms"] > row["ms"]
            rows.append(row)
            log(f"chunk K={k} ({shards} replicas) {name}: {row['ms']:.4f} ms on the card, host "
                f"{row['host_ms']:.4f} ms a call, bound {row['bound_ms']:.4f} ms"
                + (" — the host bounds it" if row["host_bound"] else ""))
    return rows


def stall_config(workdir: str) -> str:
    """A tiny U-Net on 32-pixel tiles, four steps an epoch, the fp16 codec
    (so the kernels load), the watchdog at 2 s with ``abort``."""
    cfg = {
        "model": {"features": [8, 16], "bottleneck_features": 16, "stem": "s2d",
                  "stem_factor": 2, "detail_head": True},
        "data": {"image_size": [32, 32], "synthetic_len": 20, "test_split": 4},
        "train": {"epochs": 2, "micro_batch_size": 4, "sync_period": 1,
                  "checkpoint_every_epochs": 0, "dump_images_per_epoch": 0,
                  "stall_timeout_s": 2.0, "stall_action": "abort"},
        "compression": {"mode": "float16"},
    }
    from ddlpc_tpu_torch.utils.fsio import atomic_write_json

    return atomic_write_json(os.path.join(workdir, "tiny.json"), cfg, indent=None)


def stall_run(workdir: str) -> None:
    """The watchdog phase's training process (``--stall``): the tiny config
    on the card, its loader sleeping ``STALL_SLEEP_S`` in its second batch
    (this script's doing; the package has no fault hook).  One step before
    ``fit`` sets up cuDNN and cuBLAS, so that their first call is not the
    stall.  The watchdog must end the process with 42 inside that sleep."""
    from ddlpc_tpu_torch.train.__main__ import parse_args
    from ddlpc_tpu_torch.train.trainer import Trainer

    cfg, _, device, _ = parse_args(["--config", stall_config(workdir), "--device", "cuda",
                                    "--no-resume", "--workdir", os.path.join(workdir, "run")])
    trainer = Trainer(cfg, resume=False, device=device)
    trainer.train_step(trainer.state, *next(iter(trainer.loader)))
    torch.cuda.synchronize()

    class Stalling(type(trainer.loader)):
        def __iter__(self):
            for i, batch in enumerate(super().__iter__()):
                if i == 1:
                    time.sleep(STALL_SLEEP_S)
                yield batch

    trainer.loader.__class__ = Stalling
    trainer.fit()
    log("stall run: fit returned")


def start_stall() -> tuple:
    """Start the watchdog phase's training process (``--stall``), its output
    into files: it runs beside the supervised phase (a tiny model, asleep
    most of its life) and :func:`stall_phase` collects it.  It is killed if
    this script exits first."""
    import atexit
    import shutil

    workdir = os.path.join(WORKDIR, "stall")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    out, err = (open(os.path.join(workdir, f"stall.{k}"), "w") for k in ("out", "err"))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--stall", workdir],
                            stdout=out, stderr=err, text=True, cwd=REPO)
    out.close()
    err.close()
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, workdir, t0


def stall_phase(started: tuple) -> dict:
    """The training process of :func:`start_stall`, whose data fetch
    stalls: it must exit 42 (``EXIT_STALL``) with ``stall.log`` naming the
    phase ``data`` and the breadcrumb ``stalled``."""
    from ddlpc_tpu_torch.resilience.protocol import EXIT_STALL, read_breadcrumb

    proc, workdir, t0 = started
    rc = proc.wait(timeout=300)
    wall = time.perf_counter() - t0
    run = os.path.join(workdir, "run")
    crumb = read_breadcrumb(run) or {}
    try:
        with open(os.path.join(run, "stall.log")) as f:
            diagnosis = f.read()
    except OSError:
        diagnosis = ""
    row = {"rc": rc, "wall_s": wall, "phase": crumb.get("phase"),
           "stall_tag": crumb.get("stall_tag"), "stall_age_s": crumb.get("stall_age_s")}
    log(f"stall phase: " + json.dumps(row) + "; stall.log: "
        + (diagnosis.splitlines()[0] if diagnosis else "(none)"))
    if (rc != EXIT_STALL or crumb.get("phase") != "stalled"
            or crumb.get("stall_tag") != "data" or "last phase: 'data'" not in diagnosis):
        with open(os.path.join(workdir, "stall.out")) as f:
            out = f.read()
        with open(os.path.join(workdir, "stall.err")) as f:
            err = f.read()
        fail(f"stall phase: expected exit {EXIT_STALL}, breadcrumb stalled at data and a stall.log "
             f"naming it; got {row}\nstdout: {out[-2000:]}\nstderr: {err[-4000:]}")
    return row


def host_phase(trainer) -> list:
    """The host C++ libraries on this machine's host, at the flagship's
    sizes: ``dwb_gather_pack`` of the epoch's 512 wrap-filled tiles into a
    pinned buffer against numpy's ``take`` and ``torch.index_select`` into
    the same buffer, and the checkpoint wire's deflate of the flagship's
    params (level 1, and level 0 as adaptive stores dense fp32) and its
    inflate, native against Python's zlib.  Host clock, median of 5 (3
    for Python's deflate).  Prints the zlib Python links and the one the
    native library links; level-1 frames are the same bytes where the two
    are one zlib."""
    import ctypes
    import zlib

    import numpy as np

    from ddlpc_tpu_torch.data.loader import DeviceLoader
    from ddlpc_tpu_torch.utils import native, wire

    def median_s(fn, reps=5):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    ds = trainer.train_ds
    plain = DeviceLoader(ds, micro_batch=MICRO_BATCH, sync_period=4, device=trainer.device,
                         seed=trainer.cfg.data.seed)
    flat = np.ascontiguousarray(next(plain.index_chunks()), np.int64)
    img = torch.empty((len(flat), *ds.image_shape), dtype=torch.float32, pin_memory=True)
    lab = torch.empty((len(flat), *ds.labels.shape[1:]), dtype=torch.int32, pin_memory=True)
    lib = native.load_batch()
    gather = lambda: lib.gather_pack(ds.images, ds.labels, flat, img.numpy(), lab.numpy())  # noqa: E731

    def numpy_take():
        np.take(ds.images, flat, axis=0, out=img.numpy())
        np.take(ds.labels, flat, axis=0, out=lab.numpy())

    src_i, src_l, idx = torch.from_numpy(ds.images), torch.from_numpy(ds.labels), torch.from_numpy(flat)

    def index_select():
        torch.index_select(src_i, 0, idx, out=img)
        torch.index_select(src_l, 0, idx, out=lab)

    gather()
    if not (np.array_equal(img.numpy(), ds.images[flat]) and np.array_equal(lab.numpy(), ds.labels[flat])):
        fail("dwb_gather_pack differs from numpy's gather")
    n_bytes = 2 * (img.numel() * 4 + lab.numel() * 4)  # each byte read once, written once
    g = {"name": "dwb_gather_pack", "source": "ddlpc_tpu_torch/kernels/host/batch.cc",
         "copy_of": "csrc/batch.cc", "tiles": len(flat), "bytes": n_bytes,
         "threads": native.MAX_THREADS, "ms": median_s(gather) * 1e3,
         "plain_ms": median_s(numpy_take) * 1e3, "library_ms": median_s(index_select) * 1e3}
    g["gb_per_s"] = n_bytes / g["ms"] / 1e6
    del img, lab

    payload = trainer.state.params.data.cpu().numpy().tobytes()
    nw = native.load_wire()
    zv = ctypes.CDLL(native.library_path("libdwz")).zlibVersion
    zv.restype = ctypes.c_char_p
    versions = {"python_zlib": zlib.ZLIB_RUNTIME_VERSION, "native_zlib": zv().decode()}
    rows = [g]
    for level in (1, 0):
        frame = nw.compress(payload, level, wire.BLOCK_SIZE)
        wire.set_native(False)
        python = wire.compress(payload, level)
        py_ms = median_s(lambda: wire.compress(payload, level), reps=3) * 1e3
        py_inflate_ms = median_s(lambda: wire.decompress(frame), reps=3) * 1e3
        wire.set_native(True)
        if nw.decompress(python) != payload or wire.decompress(frame) != payload:
            fail(f"the native wire and Python's zlib do not read each other's frames (level {level})")
        same = frame == python
        if level == 1 and versions["python_zlib"] == versions["native_zlib"] and not same:
            fail(f"level-1 frames differ under one zlib {versions}")
        rows.append({"name": f"dwz_compress level {level}", "source": "ddlpc_tpu_torch/kernels/host/wire.cc",
                     "copy_of": "csrc/wire.cc", "bytes": len(payload), "frame_bytes": len(frame),
                     "threads": native.MAX_THREADS,
                     "ms": median_s(lambda: nw.compress(payload, level, wire.BLOCK_SIZE)) * 1e3,
                     "plain_ms": py_ms, "same_bytes_as_python": same, **versions})
        rows.append({"name": f"dwz_decompress level {level}", "source": "ddlpc_tpu_torch/kernels/host/wire.cc",
                     "copy_of": "csrc/wire.cc", "bytes": len(payload), "threads": native.MAX_THREADS,
                     "ms": median_s(lambda: nw.decompress(frame)) * 1e3, "plain_ms": py_inflate_ms})
    for row in rows:
        log("host row: " + json.dumps(row))
    return rows


def simulate_sync(bufs: list, compression, key, buckets=None, n_elements=None) -> torch.Tensor:
    """The whole world's sync of ``bufs`` (one flat buffer a replica) in
    plain PyTorch, in one process: what every replica must hold after
    ``sync_gradients`` (``off``, ``zero1``; the ring too) or the
    all-gathered chunks of ``sync_gradients_scatter`` (``zero2``,
    ``zero3``).  Each bucket region ``(start, elements)`` of ``buckets``
    (None: the whole buffer) is synced on its own: the shared scale, each
    replica's encode with its own local draw, the exact integer (or
    fp16-lattice) sum, the decode, the mean stage.  The ring
    (``transport='ring'``, nearest) snaps the exact sum's mean once, as
    its owners do, and the gathered lattice is decoded against
    ``scale / levels``."""
    from ddlpc_tpu_torch.ops import cuda_quantize as cq
    from ddlpc_tpu_torch.ops import philox
    from ddlpc_tpu_torch.ops import quantize as plain
    from ddlpc_tpu_torch.parallel.compressed_allreduce import wire_dtype
    from ddlpc_tpu_torch.parallel.grad_sync import simulate_wire_dtype

    world = len(bufs)
    levels = float(plain.levels_for(compression))
    out = torch.zeros_like(bufs[0])
    if compression.transport == "ring":
        if key is not None:
            fail("[sync check] the ring's plain simulation is nearest only")
        m = world * -(-n_elements // world)
        xs = [b[:m] for b in bufs]
        scale = torch.stack([plain.global_absmax([x]) for x in xs]).amax().reshape(1)
        wire = wire_dtype(world, int(levels))
        total = sum(plain.encode_with_scale(x, plain.safe_divisor(scale), levels, wire).double()
                    for x in xs).float()
        snapped = plain.snap_to_lattice(plain.times_reciprocal(total, float(world)), levels).to(wire)
        out[:m] = plain.decode_with_inv(snapped, plain.times_reciprocal(scale, levels))
        return out
    wire = simulate_wire_dtype(world, compression)
    if wire is None:
        fail(f"[sync check] {compression} has no narrow wire at {world} replicas")
    regions = buckets if buckets and len(buckets) > 1 else [(0, out.numel())]
    for b, (start, size) in enumerate(regions):
        bkey = key if key is None or len(regions) == 1 else philox.fold_in(key, b)
        parts = [buf[start : start + size] for buf in bufs]
        scale = torch.stack([plain.global_absmax([p]) for p in parts]).amax().reshape(1)
        total = torch.zeros(size, dtype=torch.float64, device=out.device)
        for r, p in enumerate(parts):
            local = None if bkey is None else philox.stage_key(bkey, "local", replica=r)
            total += plain.encode_with_scale(p, plain.safe_divisor(scale), levels, wire, key=local).double()
        mean = plain.decode_with_inv(total.float(), plain.times_reciprocal(scale, levels * world))
        if compression.quantize_mean:
            mean = cq.fake_quantize_plain(mean, compression,
                                          key=None if bkey is None else philox.stage_key(bkey, "mean"))
        out[start : start + size] = mean
    return out


def _timed_ms(fn, reps: int = 5) -> float:
    """Median wall time of ``fn()`` in the world, ranks lined up by a
    barrier before each rep and the card drained after it."""
    import torch.distributed as dist

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _digest(*tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().to("cpu", copy=True).contiguous().numpy().tobytes())
    return h.hexdigest()


def _canonical_digest(state) -> str:
    """The hash of a state's canonical params, moments, count and step (every
    replica must call it: it gathers)."""
    from ddlpc_tpu_torch.convert import gather_canonical

    sd, opt = gather_canonical(state)
    names = sorted(state.params.names)
    tensors = [sd[k] for k in names]
    for key in sorted(state.opt_state.buffers()):
        tensors += [opt[key][k] for k in names]
    return _digest(*tensors, torch.tensor([opt["count"], state.step]))


def audit_row(audit: dict, rows: list) -> dict:
    """A program audit (``analysis/program``'s check functions) as a JSON
    row: its violations, codec calls, placement and census, each census
    row counted (``program.census_strings``)."""
    from ddlpc_tpu_torch.analysis import program

    return {"program": audit["program"],
            "violations": [v.format() if hasattr(v, "format") else v for v in audit["violations"]],
            "codec_calls": audit["codec_calls"],
            "placement": {k: [v["measured"], v["bytes"]] for k, v in audit["placement"].items()},
            "census": program.census_strings(rows)}


def audit_gate(label: str, rank: int, audit: dict) -> None:
    """Fail on a violation of a full-width rank's program audit; print its
    census on a line of its own."""
    log(f"[{label}] rank {rank} {audit['program']}: codec {json.dumps(audit['codec_calls'])}, "
        f"placement {json.dumps(audit['placement'])}, census {json.dumps(audit['census'])}")
    if audit["violations"]:
        fail(f"[{label}] rank {rank}: the program auditor's contracts: {audit['violations']}")


def write_rank_result(workdir: str, rank: int, result: dict) -> str:
    """A rank process's result, ``rank{rank}.json`` in ``workdir``, which
    the parent reads when the world has ended: written atomically, so a
    rank that fails while writing leaves no torn file (and a file from an
    earlier run stays whole)."""
    from ddlpc_tpu_torch.utils.fsio import atomic_write_json

    return atomic_write_json(os.path.join(workdir, f"rank{rank}.json"), result, indent=None)


def dp_rank(label: str, workdir: str, backend: str, device: str) -> None:
    """One rank of a data-parallel phase (``mesh.spawn_world`` starts it
    with ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``), then of each phase that
    shares its world (``DP_SHARED``), each in its own directory under
    ``WORKDIR`` (:func:`_dp_rank_run`)."""
    from ddlpc_tpu_torch.parallel import mesh

    mesh.initialize_distributed(backend, f"file://{os.path.join(workdir, 'rendezvous')}")
    _dp_rank_run(label, workdir, backend, device)
    for other in DP_SHARED.get(label, ()):
        gc.collect()
        torch.cuda.empty_cache()
        _dp_rank_run(other, os.path.join(WORKDIR, other), backend, device)
    mesh.destroy_distributed()


def _dp_rank_run(label: str, workdir: str, backend: str, device: str) -> None:
    """One rank's run of a data-parallel phase: the CLI's entry on v5e8 for
    ``DP_EPOCHS`` steps with the launch counts set to 0 just before and
    read just after, the params' hash all-gathered, the state's placement
    (its ``StateLayout``'s decisions by kind, the HBM breakdown and the
    ``ddlpc_hbm_replicated_by_rule_bytes`` gauge), the sync-level check,
    and the sync's cost; writes ``rank<r>.json`` into ``workdir`` for the
    parent."""
    import torch.distributed as dist

    from ddlpc_tpu_torch.analysis import program
    from ddlpc_tpu_torch.obs import hbm
    from ddlpc_tpu_torch.ops import cuda_quantize as cq
    from ddlpc_tpu_torch.ops.philox import step_key
    from ddlpc_tpu_torch.parallel import grad_sync, mesh, partition
    from ddlpc_tpu_torch.train.__main__ import parse_args
    from ddlpc_tpu_torch.train.trainer import Trainer

    world, extra, level = DP_PHASES[label][:3]
    start = time.perf_counter()
    rank = mesh.replica_index()

    def argv_for(run: str, extra: tuple) -> list:
        argv = ["--config", V5E8, "--device", device, "--dist-backend", backend, "--no-resume",
                "--workdir", os.path.join(workdir, run), "--set", f"train.epochs={DP_EPOCHS}",
                "--set", f"train.micro_batch_size={MICRO_BATCH}",
                "--set", f"parallel.data_axis_size={world}"]
        for o in extra:
            argv += ["--set", o]
        return argv

    cfg, resume, dev, backend_arg = parse_args(argv_for("run", extra))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        trainer = Trainer(cfg, resume=resume, device=dev, dist_backend=backend_arg)
    warned = any("global super-batch" in str(w.message) for w in caught)
    flat = trainer.state.params
    torch.cuda.reset_peak_memory_stats()
    cq.reset_launch_counts()
    t0 = time.perf_counter()
    with mesh.census() as census:
        last = trainer.fit()
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(cq.LAUNCHES)
    # The program auditor's contracts over the run: the zero3 param buffer
    # released as a step leaves it (the epoch's eval gathered it).
    trainer.state.release_params()
    traced = "train.trace=True" in extra
    audit = program.check_step(f"{label}/rank{rank}", census, trainer.state, cfg.compression, world,
                               syncs=DP_EPOCHS + (PROBE_SYNCS if traced else 0), steps=DP_EPOCHS,
                               launches=launches)
    audit = {"violations": [v.format() for v in audit["violations"]],
             "exceptions": audit["exceptions"], "gauge_wire": audit["gauge_wire"],
             "placement": audit["placement"], "codec_calls": audit["codec_calls"],
             "declared_wire": audit["declared_wire"], "census": program.census_strings(census.rows)}
    log(f"[{label}] rank {rank} census: " + json.dumps(audit["census"]))
    del census
    peak = torch.cuda.max_memory_allocated()
    free, total = torch.cuda.mem_get_info()
    placement = trainer.state.placement
    sizes = [size for _, size in flat.segments()]
    state_layout = {
        "level": placement.level, "decisions": placement.summary(),
        "hbm": hbm.state_hbm_bytes(trainer.state),
        "gauge": trainer.registry.snapshot()["ddlpc_hbm_replicated_by_rule_bytes"],
        "replicated_by_rule_bytes": placement.replicated_by_rule_bytes(),
        # The gauge's count made here from the decisions themselves: every
        # leaf the engine kept whole by rule, 4 bytes an element (the
        # state's leaves are fp32, optax's count int32).
        "by_rule_from_decisions": sum(
            4 * math.prod(d.shape)
            for tree in (placement.param_decisions, placement.opt_decisions)
            for _, d in partition.leaves_with_path(tree)
            if d.reason == partition.REASON_REPLICATED_BY_RULE),
        # What each layout adds to the n params: the port's regions padded
        # to N·rows_b, JAX's leaves to N·ceil(n_leaf / N).
        "padding_bytes": {"port": 4 * (flat.data.numel() - flat.numel),
                          "jax": 4 * (world * sum(-(-k // world) for k in sizes) - flat.numel)},
    }
    trainer.state.gather_params()
    digest = _digest(flat.data)
    hashes = [None] * world
    dist.all_gather_object(hashes, digest)
    # The host path's batches: the run's own loader (the native gather into
    # the pinned ring) over its epochs, and a ring at micro-batch 4, whose
    # epoch of 7 batches runs through the 3 slots while every batch is held.
    from ddlpc_tpu_torch.data.loader import ShardedLoader

    if not isinstance(trainer.loader, ShardedLoader) or trainer.loader._native is None:
        fail(f"[{label}] v5e8 (device_cache=false, native_gather) ran {type(trainer.loader).__name__}")
    loader_equal(label, trainer, trainer.loader, DP_EPOCHS)
    ring = ShardedLoader(trainer.train_ds, micro_batch=4, sync_period=1, device=trainer.device,
                         shuffle=cfg.data.shuffle, seed=cfg.data.seed, replica=rank, world=world)
    ring_batches = loader_equal(label, trainer, ring, 1)
    del ring
    counter = trainer.registry.get("ddlpc_comm_bytes_total")
    comm_wire = {row["collective"]: counter.value(collective=row["collective"], codec=row["codec"],
                                                  stage="wire")
                 for row in trainer.comm.plan}

    # The sync-level check: each rank's gradient buffer from its own seed
    # (the padding kept zero), synced by the path's own function; rank 0
    # holds the world's result against the plain simulation over all W
    # buffers.
    n = flat.numel
    buckets = flat.buckets()
    covered = torch.zeros(flat.grad.numel(), dtype=torch.bool, device=flat.grad.device)
    for o, size in flat.segments():
        covered[o : o + size] = True

    def seeded(r: int) -> torch.Tensor:
        g = torch.Generator(device=flat.grad.device).manual_seed(1000 + r)
        buf = torch.zeros_like(flat.grad)
        buf[covered] = torch.randn(n, generator=g, device=buf.device) * (0.01 * (1 + r))
        return buf

    key = step_key(cfg.train.seed, SYNC_STEP) if cfg.compression.rounding == "stochastic" else None
    scatter = level in ("zero2", "zero3")

    def sync(buf: torch.Tensor) -> torch.Tensor:
        if scatter:
            grad_sync.sync_gradients_scatter(buf, cfg.compression, world, key=key, buckets=buckets)
            return flat.all_gather_(buf)
        return grad_sync.sync_gradients(buf, cfg.compression, axis_size=world, key=key,
                                        buckets=buckets, n_elements=n)

    synced = sync(seeded(rank))
    torch.cuda.synchronize()
    sync_hashes = [None] * world
    dist.all_gather_object(sync_hashes, _digest(synced))
    sync_equal = None
    if rank == 0:
        want = simulate_sync([seeded(r) for r in range(world)], cfg.compression, key,
                             buckets=buckets, n_elements=n)
        torch.cuda.synchronize()
        sync_equal = bool(torch.equal(synced, want))
        if not sync_equal:
            log(f"[{label}] sync check: {int((synced != want).sum())} elements differ from the plain simulation")

    # The sync's cost a step: the whole sync; for dp4_zero2_fp16 and
    # dp2_off_int8_sr its collectives alone on buffers of the same sizes
    # and dtypes, then its codec kernels alone; for the ring one hop of its
    # int8 chunk.
    from ddlpc_tpu_torch.parallel.grad_sync import simulate_wire_dtype

    buf = seeded(rank)
    cost = {"sync_ms": _timed_ms(lambda: sync(buf)), "collectives_ms": None, "codec_ms": None}
    if label in ("dp4_zero2_fp16", "dp2_off_int8_sr"):
        wire = simulate_wire_dtype(world, cfg.compression)
        q = torch.zeros(buf.numel(), dtype=wire, device=buf.device)
        one = torch.ones(1, device=buf.device)
        k = flat.shard

        def collectives():
            mesh.all_reduce_(one, "max")
            if level == "zero2":
                mesh.reduce_scatter(q)
                mesh.all_reduce_(one, "max")
                mesh.all_gather_(flat.data)
            else:
                mesh.all_reduce_(q)

        def codec():
            from ddlpc_tpu_torch.ops import quantize as plain

            scale = cq.absmax(buf)
            draw = {} if key is None else {"key": (1, 2)}
            qq = cq.encode_to_wire(buf, plain.safe_divisor(scale), cfg.compression, wire, **draw)
            part = qq if level == "off" else qq[:k]
            out = buf if level == "off" else buf[:k]
            cq.decode_from_wire(part, scale, out=out)
            if level == "off":
                cq.fake_quantize_fused(out, cfg.compression, out=out, **draw)
            else:
                cq.fake_quantize_fused(out, cfg.compression, out=out, amax=cq.absmax(out))

        cost.update(collectives_ms=_timed_ms(collectives), codec_ms=_timed_ms(codec))
        del q
    if cfg.compression.transport == "ring":
        hop = torch.zeros(-(-n // world), dtype=torch.int8, device=buf.device)
        cost["hop_ms"] = _timed_ms(lambda: mesh.ring_shift(hop), reps=9)
        cost["hop_bytes"] = hop.numel()
        del hop
    result = {
        "rank": rank, "world": world, "level": trainer.shard_update, "backend": backend,
        "device": str(trainer.device), "launches": launches, "warned": warned,
        "params_hashes": hashes, "sync_hashes": sync_hashes, "sync_equal": sync_equal,
        "peak_bytes": peak, "card_used_bytes": total - free, "fit_s": fit_s,
        "last": last, "n_params": n, "padded": flat.data.numel(), "shard": flat.shard,
        "n_buckets": len(flat.regions), **cost,
        "ring_batches": ring_batches, "comm_wire": comm_wire, "state_layout": state_layout,
        "audit": audit,
    }
    del buf
    if label == "dp4_zero2_fp16":
        # The run checkpointed each epoch (the moments gathered, rank 0
        # writing): a fresh Trainer on every rank restores the newest, and
        # the params and this rank's chunk of the moments must be the bits
        # the run ended on.

        def digests(t) -> list:
            o = t.state.opt_state
            return [_digest(v) for v in (t.state.params.data, o.mu, o.nu)] + [o.count, t.state.step]

        saved = digests(trainer)
        del trainer, flat
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        again = Trainer(cfg, resume=True, device=dev, dist_backend=backend_arg)
        torch.cuda.synchronize()
        result["zero2_restore"] = {
            "trainer_with_restore_s": time.perf_counter() - t0,
            "start_epoch": again.start_epoch, "equal": digests(again) == saved,
            "ckpt_steps": sorted(os.listdir(again.ckpt_dir)) if rank == 0 else None,
        }
    if level == "zero3":
        # The state bytes: the param buffer freed between steps, this
        # replica's chunks the only copy, as obs/hbm.py counts them; the
        # canonical state (for the parent's restore into off); then a zero2
        # twin at the same ranks, buckets and steps, which must end on the
        # same params bit for bit and hold the full param buffer more.
        state = trainer.state
        breakdown = hbm.state_hbm_bytes(state, "zero3")
        canonical = _canonical_digest(state)
        state.release_params()
        torch.cuda.synchronize()
        live = {"params": state.owned.numel() * 4 + flat.data.untyped_storage().nbytes(),
                "opt_state": sum(v.numel() * 4 for v in state.opt_state.buffers().values())}
        allocated = torch.cuda.memory_allocated()
        chunk_block = allocator_block(state.owned)
        del trainer, state, flat
        gc.collect()
        torch.cuda.empty_cache()
        twin_cfg, _, _, _ = parse_args(argv_for(
            "twin", tuple(o for o in extra if not o.startswith("parallel.shard_update"))
            + ("parallel.shard_update=zero2",)))
        twin = Trainer(twin_cfg, resume=False, device=dev, dist_backend=backend_arg)
        cq.reset_launch_counts()
        twin.fit()
        torch.cuda.synchronize()
        twin_launches = dict(cq.LAUNCHES)
        twin_hashes = [None] * world
        dist.all_gather_object(twin_hashes, _digest(twin.state.params.data))
        result["zero3"] = {
            "canonical": canonical, "hbm": breakdown, "live": live, "allocated": allocated,
            "twin_allocated": torch.cuda.memory_allocated(), "twin_level": twin.shard_update,
            "twin_hashes": twin_hashes, "twin_launches": twin_launches,
            "twin_hbm": hbm.state_hbm_bytes(twin.state, "zero2"),
            "chunk_block": chunk_block, "twin_block": allocator_block(twin.state.params.data),
        }
    result["wall_s"] = time.perf_counter() - start
    write_rank_result(workdir, rank, result)


def zero3_restore_into_off(label: str, workdir: str, want: str) -> dict:
    """One process at ``shard_update='off'`` restores the zero3 world's
    newest checkpoint: its canonical state must be the bits the world
    ended on."""
    from ddlpc_tpu_torch.train.__main__ import parse_args
    from ddlpc_tpu_torch.train.trainer import Trainer

    argv = ["--config", V5E8, "--device", "cuda", "--workdir", os.path.join(workdir, "run"),
            "--set", f"train.epochs={DP_EPOCHS}", "--set", f"train.micro_batch_size={MICRO_BATCH}",
            "--set", "parallel.data_axis_size=1", "--set", "parallel.shard_update=off"]
    for o in DP_PHASES[label][1]:
        if not o.startswith("parallel.shard_update"):
            argv += ["--set", o]
    cfg, _, dev, backend = parse_args(argv)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, resume=True, device=dev, dist_backend=backend)
    got = _canonical_digest(trainer.state)
    row = {"level": trainer.shard_update, "start_epoch": trainer.start_epoch,
           "trainer_with_restore_s": time.perf_counter() - t0, "equal": got == want}
    log(f"[{label}] the zero3 checkpoint restored into one process at off: " + json.dumps(row))
    if not row["equal"] or row["level"] != "off" or row["start_epoch"] != DP_EPOCHS:
        fail(f"[{label}] the zero3 checkpoint did not restore into off bit for bit: {row}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return row


def dp_phase(label: str) -> dict:
    """A data-parallel phase: ``W`` ranks of this script (``dp_rank``) as
    one world under ``DP_DEADLINE_S``, NCCL with a card a rank where the
    host has ``W`` cards, else gloo with every rank on ``cuda:0``; then
    every rank's checks.  A phase that shares an earlier phase's world
    (``DP_SHARED``) ran there: its checks read what that world wrote."""
    import shutil

    from ddlpc_tpu_torch.parallel import mesh

    world, _, level, per_bucket, warns = DP_PHASES[label]
    workdir = os.path.join(WORKDIR, label)
    if torch.cuda.device_count() >= world:
        backend, device = "nccl", "cuda"
    else:
        backend, device = "gloo", "cuda:0"
    world_wall_s = None
    if label in DP_FOLLOWERS:
        log(f"[{label}] ran in an earlier phase's world of {world} ranks")
    else:
        for d in (label, *DP_SHARED.get(label, ())):
            shutil.rmtree(os.path.join(WORKDIR, d), ignore_errors=True)
            os.makedirs(os.path.join(WORKDIR, d))
        log(f"[{label}] {world} ranks, backend {backend}, device {device} "
            f"({torch.cuda.device_count()} card(s) on this host)")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        mesh.spawn_world([sys.executable, os.path.abspath(__file__), "--dp-rank", label, workdir,
                          backend, device], world, DP_DEADLINE_S, cwd=REPO)
        world_wall_s = time.perf_counter() - t0  # with the phases that share the world
    ranks = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    wall_s = max(rr["wall_s"] for rr in ranks)  # the ranks' own run of this phase
    with open(os.path.join(workdir, "run", "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    records = [r for r in lines if "kind" not in r]
    n_buckets = ranks[0]["n_buckets"]
    syncs = DP_EPOCHS + (PROBE_SYNCS if "train.trace=True" in DP_PHASES[label][1] else 0)
    want = {name: syncs * n_buckets * per_bucket.get(name, 0) for name in ranks[0]["launches"]}
    fmt = lambda v: "n/a" if v is None else f"{v:.3f}"  # noqa: E731
    for rr in ranks:
        log(f"[{label}] rank {rr['rank']} on {rr['device']}: level {rr['level']}, {rr['n_buckets']} "
            f"bucket(s), kernels {json.dumps(rr['launches'])}, peak {rr['peak_bytes'] / 2**30:.2f} GiB, "
            f"card in use {rr['card_used_bytes'] / 2**30:.2f} GiB; sync a step {rr['sync_ms']:.3f} ms "
            f"(collectives alone {fmt(rr['collectives_ms'])} ms, codec kernels alone "
            f"{fmt(rr['codec_ms'])} ms" + (f", one ring hop of {rr['hop_bytes']} bytes "
                                            f"{rr['hop_ms']:.3f} ms" if "hop_ms" in rr else "") + ")")
        if rr["level"] != level:
            fail(f"[{label}] rank {rr['rank']} resolved shard_update to {rr['level']}, expected {level}")
        if rr["launches"] != want:
            fail(f"[{label}] rank {rr['rank']} kernel launches in {DP_EPOCHS} steps ({syncs} syncs): "
                 f"{rr['launches']}, expected {want} ({n_buckets} bucket(s))")
        if rr["warned"] != warns:
            fail(f"[{label}] large-batch stochastic-rounding warning: expected {warns}, got {rr['warned']}")
    if len(set(ranks[0]["params_hashes"])) != 1:
        fail(f"[{label}] the replicas' params differ: {ranks[0]['params_hashes']}")
    layout = state_layout_checks(label, ranks, level)
    audit = audit_checks(label, ranks)
    restored = [rr.get("zero2_restore") for rr in ranks]
    if label == "dp4_zero2_fp16":
        for rr, z in zip(ranks, restored):
            if not z["equal"] or z["start_epoch"] != DP_EPOCHS:
                fail(f"[{label}] rank {rr['rank']}: the restored zero2 checkpoint differs from the "
                     f"state saved ({z})")
        log(f"[{label}] zero2 checkpoint {restored[0]['ckpt_steps']}: every rank's params and moment "
            f"chunk restored bit for bit; a fresh Trainer with the restore "
            f"{max(z['trainer_with_restore_s'] for z in restored):.2f} s")
    zero3 = zero3_checks(label, ranks, workdir) if level == "zero3" else None
    if len(set(ranks[0]["sync_hashes"])) != 1 or not ranks[0]["sync_equal"]:
        fail(f"[{label}] the synced gradient differs between replicas or from the plain simulation")
    for rec in records:
        log(f"[{label}] step {rec['epoch'] + 1}: loss {rec['loss']} step_time_s {rec['step_time_s']} "
            f"grad_norm {rec['grad_norm']} val_miou {rec.get('val_miou')}")
        if not math.isfinite(rec["loss"]) or not math.isfinite(rec["grad_norm"]):
            fail(f"[{label}] non-finite training metrics {rec}")
    if len(records) != DP_EPOCHS:
        fail(f"[{label}] expected {DP_EPOCHS} epoch records, got {len(records)}")
    perf = perf_checks(label, lines, V5E8_FLOPS, DP_EPOCHS)
    comm_checks(label, lines, ranks, level)
    log(f"[{label}] replicas bit-identical ({ranks[0]['params_hashes'][0][:16]}), synced gradient "
        f"== plain simulation bit for bit; the ranks' run {wall_s:.1f} s, the world's wall "
        f"{'n/a' if world_wall_s is None else f'{world_wall_s:.1f} s'}")
    return {
        "world": world, "backend": backend, "device": device, "level": level,
        "launches": ranks[0]["launches"], "n_buckets": n_buckets, "wall_s": wall_s,
        "world_wall_s": world_wall_s,
        "step_time_s": [rec["step_time_s"] for rec in records],
        "losses": [rec["loss"] for rec in records],
        "peak_bytes": [rr["peak_bytes"] for rr in ranks],
        "card_used_bytes": max(rr["card_used_bytes"] for rr in ranks),
        "sync_ms": [rr["sync_ms"] for rr in ranks],
        "collectives_ms": [rr["collectives_ms"] for rr in ranks],
        "codec_ms": [rr["codec_ms"] for rr in ranks],
        "hop_ms": [rr.get("hop_ms") for rr in ranks], "hop_bytes": ranks[0].get("hop_bytes"),
        "n_params": ranks[0]["n_params"], "padded": ranks[0]["padded"], "shard": ranks[0]["shard"],
        "zero2_restore": restored[0], "zero3": zero3, "state_layout": layout,
        "epochs": path_row(label, records, perf),
        "rank_last_losses": [rr["last"]["loss"] for rr in ranks],
        "params_hash": ranks[0]["params_hashes"][0],
        "comm_probe": [{k: r.get(k) for k in ("comm_s_per_step", "comm_fraction", "overlap_headroom_s",
                                              "step_time_s")}
                       for r in lines if r.get("kind") == "comm"],
        "debit_probe_s": [r.get("debit_probe_s") for r in perf],
        "audit": audit,
    }


def audit_checks(label: str, ranks: list) -> dict:
    """Every rank's run held to the program auditor's contracts (no
    violation) and the trainer's ``ddlpc_comm_bytes_total{stage="wire"}``
    rows equal to the audit's, which the census backs."""
    for rr in ranks:
        a = rr["audit"]
        if a["violations"]:
            fail(f"[{label}] rank {rr['rank']}: the program auditor's contracts: "
                 + " | ".join(a["violations"]))
        if {k: int(v) for k, v in rr["comm_wire"].items()} != a["gauge_wire"]:
            fail(f"[{label}] rank {rr['rank']}: the trainer's wire counter {rr['comm_wire']} != "
                 f"the audited {a['gauge_wire']}")
    a = ranks[0]["audit"]
    log(f"[{label}] program audit on every rank: comm-closed-form, dtype-flow ({a['declared_wire']}"
        f"{'; ' + '; '.join(a['exceptions']) if a['exceptions'] else ''}), placement "
        + json.dumps({k: v["measured"] for k, v in a["placement"].items()})
        + f", codec-calls {json.dumps(a['codec_calls'])} == LAUNCHES; the trainer's wire counter "
        f"== the census' {json.dumps(a['gauge_wire'])} ({smi_line()})")
    return {"gauge_wire": a["gauge_wire"], "codec_calls": a["codec_calls"],
            "placement": {k: v["measured"] for k, v in a["placement"].items()},
            "exceptions": a["exceptions"]}


def allocator_block(t: torch.Tensor) -> dict:
    """The caching allocator's block that holds ``t``'s storage, from
    ``torch.cuda.memory_snapshot``: the bytes it counts in
    ``memory_allocated``, the bytes asked for, and its segment's size."""
    ptr = t.untyped_storage().data_ptr()
    for seg in torch.cuda.memory_snapshot():
        addr = seg["address"]
        for b in seg["blocks"]:
            if addr == ptr:
                return {"size": b["size"], "requested": b.get("requested_size"),
                        "segment": seg["total_size"]}
            addr += b["size"]
    fail(f"no allocator block starts at the storage of a tensor of {t.numel()} elements")


def state_layout_checks(label: str, ranks: list, level: str) -> dict:
    """Every rank's placement as its ``StateLayout`` decided it: the kinds
    it chunks are the level's rung (``shard_update.LEVEL_CHUNKS``), and its
    ``ddlpc_hbm_replicated_by_rule_bytes`` gauge, as the trainer published
    it, equals the bytes of the leaves whose decision reads
    ``replicated-by-rule``, counted by the rank from the decision trees,
    and ``replicated_by_rule_bytes()``.  Prints rank 0's decisions per
    kind, the breakdown and the gauge beside the card."""
    from ddlpc_tpu_torch.parallel.shard_update import LEVEL_CHUNKS

    for rr in ranks:
        sl = rr["state_layout"]
        chunked = {k: sl["decisions"][k]["chunked"] for k in ("params", "grads", "opt_state")}
        if not sl["gauge"] == sl["by_rule_from_decisions"] == sl["replicated_by_rule_bytes"]:
            fail(f"[{label}] rank {rr['rank']}: ddlpc_hbm_replicated_by_rule_bytes {sl['gauge']}, "
                 f"the replicated-by-rule leaves' bytes {sl['by_rule_from_decisions']}, the layout's "
                 f"replicated_by_rule_bytes() {sl['replicated_by_rule_bytes']}: not all equal")
        if sl["level"] != level or chunked != LEVEL_CHUNKS[level]:
            fail(f"[{label}] rank {rr['rank']}: the state layout places {level} as {sl['level']}, "
                 f"chunked (params, grads, moments) {chunked}")
    sl = ranks[0]["state_layout"]
    log(f"[{label}] state layout (rank 0), level {sl['level']}: "
        + json.dumps({k: v for k, v in sl["decisions"].items()})
        + f"; hbm bytes {json.dumps(sl['hbm'])}; ddlpc_hbm_replicated_by_rule_bytes {sl['gauge']} "
        f"== the replicated-by-rule leaves' bytes == replicated_by_rule_bytes() on every rank; "
        f"padding over n: port "
        f"{sl['padding_bytes']['port']} B, JAX's chunks {sl['padding_bytes']['jax']} B ({smi_line()})")
    return sl


def zero3_checks(label: str, ranks: list, workdir: str) -> dict:
    """The zero3 phase's own checks: every rank's state bytes as
    ``obs/hbm.py`` counts them, and its live buffers the same (the param
    buffer freed, the chunks and the moments ``K`` elements); the zero2
    twin's params equal to zero3's bit for bit, its launches the same,
    its memory larger by at least the full param buffer less a chunk (1
    MiB of slack), and by exactly that plus the rounding of the allocator's
    blocks of the twin's param buffer and zero3's chunk; and the
    checkpoint restored into one process at off."""
    first = ranks[0]
    k, padded = first["shard"], first["padded"]
    want = {"params": 4 * k, "grads": 4 * k, "grads_accum": 4 * padded, "opt_state": 8 * k}
    for rr in ranks:
        z = rr["zero3"]
        got = {key: z["hbm"][key] for key in want}
        twin = {key: z["twin_hbm"][key] for key in want}
        saved = z["twin_allocated"] - z["allocated"]
        log(f"[{label}] rank {rr['rank']} state bytes (obs/hbm.py) zero3 {json.dumps(got)}, zero2 twin "
            f"{json.dumps(twin)}; live zero3 {json.dumps(z['live'])}; memory_allocated zero3 "
            f"{z['allocated']}, twin {z['twin_allocated']} (zero3 holds {saved} bytes less)")
        pad = rr["state_layout"]["padding_bytes"]
        full, chunk = z["twin_block"], z["chunk_block"]
        residual = saved - 4 * (padded - k)
        rounding = (full["size"] - 4 * padded) - (chunk["size"] - 4 * k)
        log(f"[{label}] rank {rr['rank']} zero3's saving priced: the param buffer less a chunk "
            f"{4 * (padded - k)} bytes, so {residual} bytes beyond it; the allocator's blocks: the "
            f"twin's param buffer of {4 * padded} bytes in a block of {full['size']} (segment "
            f"{full['segment']}), zero3's chunk of {4 * k} in one of {chunk['size']} (segment "
            f"{chunk['segment']}), {rounding} bytes of rounding between them; "
            f"the padding over n is the port's {pad['port']} bytes (Σ N·rows_b − n) against JAX's "
            f"{pad['jax']} (Σ N·ceil(n_leaf/N) − n)")
        if residual != rounding:
            fail(f"[{label}] rank {rr['rank']}: zero3 saves {residual} bytes beyond the param buffer "
                 f"less a chunk, the allocator's blocks of the two buffers round by {rounding}")
        if got != want or z["live"] != {"params": want["params"], "opt_state": want["opt_state"]}:
            fail(f"[{label}] rank {rr['rank']}: zero3 state bytes {got} / live {z['live']}, expected {want}")
        if twin["params"] != 4 * padded or saved < 4 * (padded - k) - (1 << 20):
            fail(f"[{label}] rank {rr['rank']}: the zero2 twin holds {twin['params']} param bytes and "
                 f"{saved} bytes more than zero3, expected {4 * padded} and >= {4 * (padded - k)}")
        if z["twin_level"] != "zero2" or z["twin_launches"] != rr["launches"]:
            fail(f"[{label}] rank {rr['rank']}: twin level {z['twin_level']}, launches "
                 f"{z['twin_launches']} against zero3's {rr['launches']}")
    twin_hashes = first["zero3"]["twin_hashes"]
    if twin_hashes != first["params_hashes"]:
        fail(f"[{label}] the zero2 twin's params {twin_hashes} != zero3's {first['params_hashes']}")
    log(f"[{label}] after {DP_EPOCHS} steps the zero2 twin (same ranks, buckets, steps) holds zero3's "
        f"params bit for bit ({twin_hashes[0][:16]})")
    restore = zero3_restore_into_off(label, workdir, first["zero3"]["canonical"])
    return {"hbm": first["zero3"]["hbm"], "twin_hbm": first["zero3"]["twin_hbm"],
            "allocated": [rr["zero3"]["allocated"] for rr in ranks],
            "twin_allocated": [rr["zero3"]["twin_allocated"] for rr in ranks],
            "restore_into_off": restore}


def comm_rows(label: str, n: int, padded: int, level: str, world: int, buckets: int) -> dict:
    """The closed form of a step's collectives (obs/comm.py): the codec's
    declared payload on the ``n`` gradients, and the bytes the port moves,
    the flat buffer of ``padded`` elements on the wire plus a 4-byte
    max-abs all-reduce a bucket for the shared scale and, under
    zero2/zero3, one for the mean stage; the ring's 2(N−1) hops of
    ``ceil(n/N)`` int8 elements (``ring_wire_report``); the params'
    all-gather of every chunked level."""
    if label == "dp4_zero1_int8_ring":
        hops = 2 * (world - 1) * -(-n // world)
        rows = {"ring_all_reduce": {"bytes_pre": 4 * hops, "bytes_post": hops, "bytes_wire": hops}}
    else:
        item = {"dp4_zero2_fp16": 2, "dp2_off_int8_sr": 1, "dp2_off_int8_sr_traced": 1,
                "dp4_zero3_fp16_bucket": 2}[label]
        scatter = level in ("zero2", "zero3")
        grad = "reduce_scatter" if scatter else "all_reduce"
        rows = {grad: {"bytes_pre": 4 * n, "bytes_post": item * n + 4 * buckets,
                       "bytes_wire": item * padded + 4 * buckets * (2 if scatter else 1)}}
    if level != "off":
        rows["all_gather"] = {"bytes_pre": 4 * n, "bytes_post": 4 * n, "bytes_wire": 4 * padded}
    return rows


def comm_checks(label: str, lines: list, ranks: list, level: str) -> None:
    """Rank 0's ``kind="comm"`` record each epoch, and every rank's byte
    counter after the run, against :func:`comm_rows`."""
    first = ranks[0]
    want = comm_rows(label, first["n_params"], first["padded"], level, first["world"],
                     first["n_buckets"])
    recs = [r for r in lines if r.get("kind") == "comm"]
    if len(recs) != DP_EPOCHS:
        fail(f"[{label}] expected {DP_EPOCHS} comm records, got {len(recs)}")
    for e, r in enumerate(recs):
        for name, row in want.items():
            got = {k: r[f"{name}_{k}_per_step"] for k in row}
            if got != row or r["steps"] != e + 1:
                fail(f"[{label}] comm record {r}: {name} {got} != closed form {row}")
    for rr in ranks:
        total = {name: DP_EPOCHS * row["bytes_wire"] for name, row in want.items()}
        if rr["comm_wire"] != total:
            fail(f"[{label}] rank {rr['rank']} ddlpc_comm_bytes_total wire {rr['comm_wire']} != {total}")
    log(f"[{label}] comm records == closed form a step " + json.dumps(want)
        + f"; every rank's wire counter == {DP_EPOCHS} steps of it")


SERVE_CONFIG = os.path.join(REPO, "configs", "serve_vaihingen.json")
SERVE_MODES = ("off", "int8", "bf16")
SERVE_BUCKETS = (1, 2, 4, 8)
SERVE_SCENE = SCENE_SIZES[0]  # (H, W): the largest of docs/disk_fit/scene_scale.json, 35 windows
SERVE_CLIENTS, SERVE_TILE_REQUESTS, SERVE_SCENES = 4, 16, 2
SERVE_PREDICT_IMAGES = ((1100, 900), (700, 1300))
# Card against CPU, the flagship's bf16 compute on both (the tests' bf16
# rule, tests/test_torch_model.py): max |Δlogit| ≤ 5e-2 · max |logit|, and
# the class of at least 99 % of the pixels the same.
SERVE_CPU_LOGIT_SHARE, SERVE_CPU_AGREE = 5e-2, 0.99


def _serve_image(seed: int, h: int, w: int):
    import numpy as np

    img, _ = vaihingen_like(np.random.default_rng(seed), h, w)
    return img.astype(np.float32) / 255.0


def _npy(a) -> bytes:
    import io

    import numpy as np

    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def _http(port: int, method: str, path: str, body=None, headers=None, timeout: float = 300.0):
    """(status, headers, body) of one request to the server on localhost."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Proc:
    """``python -m <module> <args>`` of the port on the card as a user
    starts it, its output in ``WORKDIR/<name>.out`` and ``.err``.  It runs
    in a session of its own, so ``kill_tree`` ends it and every process it
    started (a fleet's replicas) at once; that runs at exit too, so a
    failed phase leaves nothing running."""

    def __init__(self, module: str, args: list, name: str):
        import atexit

        self.out = open(os.path.join(WORKDIR, f"{name}.out"), "w+")
        self.err = open(os.path.join(WORKDIR, f"{name}.err"), "w+")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", module, *args], cwd=REPO, stdout=self.out, stderr=self.err,
            env=dict(os.environ, PYTHONPATH=REPO), start_new_session=True,
        )
        atexit.register(self.kill_tree)

    def stderr(self) -> str:
        self.err.flush()
        self.err.seek(0)
        return self.err.read()

    def kill_tree(self) -> None:
        import signal

        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        self.proc.wait()
        self.out.close()
        self.err.close()


def _wait_for(what: str, pred, timeout: float, every: float = 0.1):
    """``pred()``'s first true value, polled every ``every`` s; the run
    fails if none comes within ``timeout`` s."""
    deadline = time.perf_counter() + timeout
    while True:
        got = pred()
        if got:
            return got
        if time.perf_counter() > deadline:
            fail(f"timed out after {timeout} s waiting for {what}")
        time.sleep(every)


def _load(port: int, clients: list, seconds: float = 0.0, during=None, timeout: float = 300.0):
    """Closed-loop clients posting to the server or fleet at ``port``.
    Each of ``clients`` is ``(path, body, count)``: it posts ``body(j)``
    for j = 0, 1, ..., ``count`` times, or with ``count`` None until
    ``during()`` has returned and ``seconds`` have passed.  Returns
    (statuses, wall s, what ``during`` returned).  A request that raised,
    whatever the exception, counts as a status that is not 200; a client
    still running ``timeout`` s after the load stopped fails the run."""
    import threading

    statuses, lock, stop = [], threading.Lock(), threading.Event()

    def client(path, body, count):
        j = 0
        while not stop.is_set() if count is None else j < count:
            try:
                st = _http(port, "POST", path, body(j), timeout=timeout)[0]
            except Exception as e:  # noqa: BLE001 - every failure is one the gates must see
                st = f"{type(e).__name__}: {e}"
            with lock:
                statuses.append(st)
            j += 1

    threads = [threading.Thread(target=client, args=c, daemon=True) for c in clients]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    try:
        result = during() if during is not None else None
        time.sleep(max(0.0, seconds - (time.perf_counter() - t0)))
    finally:
        stop.set()
        deadline = time.perf_counter() + timeout
        for t in threads:
            t.join(max(0.0, deadline - time.perf_counter()))
    hung = sum(t.is_alive() for t in threads)
    if hung:
        fail(f"{hung} of {len(threads)} load clients still running {timeout} s after the load "
             f"stopped")
    return statuses, time.perf_counter() - t0, result


class _ServerProc(_Proc):
    """``python -m ddlpc_tpu_torch.serve.server`` on the card as a user
    starts it: the config as written, the run as ``--workdir``, a free
    ``--port``; ready once its port file exists (written after warmup)."""

    def __init__(self, run: str, tag: str):
        self.tag = tag
        self.port = _free_port()
        self.port_file = os.path.join(WORKDIR, f"serve_{tag}.port")
        if os.path.exists(self.port_file):
            os.remove(self.port_file)
        super().__init__("ddlpc_tpu_torch.serve.server",
                         ["--config", SERVE_CONFIG, "--workdir", run, "--port", str(self.port),
                          "--port-file", self.port_file], f"serve_{tag}")

    def wait_ready(self, timeout: float = 300.0) -> float:
        def ready():
            if self.proc.poll() is not None:
                fail(f"[serve {self.tag}] server exited {self.proc.returncode} before ready: "
                     f"{self.stderr()[-2000:]}")
            return os.path.exists(self.port_file)

        _wait_for(f"[serve {self.tag}]'s port file", ready, timeout)
        return time.perf_counter() - self.t0

    def drain(self, drain_timeout_s: float, inflight_body: bytes) -> dict:
        """SIGTERM with one request in flight: that request must be answered,
        the process must exit 0 within ``drain_timeout_s`` and its stderr
        must hold no "terminate called" (C13)."""
        import signal
        import threading

        got = []

        def request():
            try:
                got.append(_http(self.port, "POST", "/predict", inflight_body)[0])
            except OSError as e:
                got.append(f"{type(e).__name__}: {e}")

        t = threading.Thread(target=request)
        t.start()
        time.sleep(0.5)  # the scene's body is on the server, its windows queued
        t0 = time.perf_counter()
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=drain_timeout_s + 30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            fail(f"[serve {self.tag}] still running {drain_timeout_s + 30} s after SIGTERM")
        exit_s = time.perf_counter() - t0
        t.join(60)
        err = self.stderr()
        row = {"tag": self.tag, "rc": rc, "exit_s": exit_s, "inflight": got,
               "terminate_called": "terminate called" in err}
        log(f"[serve {self.tag}] SIGTERM: " + json.dumps(row))
        if rc != 0 or exit_s > drain_timeout_s or row["terminate_called"] or got != [200]:
            fail(f"[serve {self.tag}] drain: {row}; stderr tail {err[-2000:]}")
        self.out.close()
        self.err.close()
        return row


def serve_engine_phase(run: str, scfg, scene) -> dict:
    """The engine in this process, per weight mode: restore + quantize
    time and launches, resident bytes, per-bucket forward time and
    launches, the card against a CPU engine, the quantized trees against
    their plain versions."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ddlpc_tpu_torch.analysis import program
    from ddlpc_tpu_torch.ops import cuda_quantize as cq
    from ddlpc_tpu_torch.parallel import mesh
    from ddlpc_tpu_torch.serve import quantized as sq
    from ddlpc_tpu_torch.serve.engine import InferenceEngine

    rows, engines = {}, {}
    for mode in SERVE_MODES:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        base_req = torch.cuda.memory_stats().get("requested_bytes.all.current", 0)
        # The path: restore, warmup, one scene, a reload — launches counted.
        cq.reset_launch_counts()
        t0 = time.perf_counter()
        eng = InferenceEngine.from_workdir(run, max_bucket=scfg.max_batch, echo=False, quantize=mode,
                                           quantize_activations=scfg.quantize_activations,
                                           device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        resident = torch.cuda.memory_allocated() - base
        requested = torch.cuda.memory_stats().get("requested_bytes.all.current", 0) - base_req
        hbm = eng.hbm_bytes()
        leaves = len(eng.state.params)
        n = sum(p.numel() for p in eng.state.params.values())
        # The in-process forwards under the census, held to the serve
        # arms' contracts: no collective, one decode a leaf and forward
        # under int8 (and the launches the calls).
        before = dict(cq.LAUNCHES)
        with mesh.census() as census:
            t0 = time.perf_counter()
            eng.warmup()
            warmup_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            classes = eng.predict_classes(scene, overlap=scfg.overlap, batch=scfg.max_batch)
            scene_s = time.perf_counter() - t0
            torch.cuda.synchronize()
        audit = program.check_serve_forward(
            f"serve_{'fp32' if mode == 'off' else mode}/forward", census, mode, leaves,
            forwards=eng.forward_calls, launches={k: cq.LAUNCHES[k] - before[k] for k in before})
        audit = audit_row(audit, census.rows)
        del census
        audit_gate(f"serve {mode}", 0, audit)
        meta = eng.reload()
        torch.cuda.synchronize()
        launches = dict(cq.LAUNCHES)
        forwards = eng.forward_calls
        want = {k: 0 for k in launches}
        if mode == "int8":
            want.update(absmax=2 * leaves, encode_to_wire=2 * leaves,
                        decode_from_wire=forwards * leaves)
        if launches != want:
            fail(f"[serve {mode}] launches {launches}, expected {want} ({leaves} leaves, "
                 f"{forwards} forwards, 2 restores)")
        param_bytes = {"off": 4 * n, "int8": n + 4 * leaves, "bf16": 2 * n + 4 * leaves}[mode]
        if hbm["params"] != param_bytes:
            fail(f"[serve {mode}] hbm_bytes {hbm}, expected params {param_bytes}")
        # The bytes the tensors asked for (the allocator's blocks round them
        # up): the state and, with int8, at most the max-abs pass's scratch.
        if not hbm["params"] + hbm["batch_stats"] <= requested <= (
                hbm["params"] + hbm["batch_stats"] + 4 * 1025):
            fail(f"[serve {mode}] {requested} bytes requested against hbm_bytes {hbm}")
        # Per bucket: the device work of one forward (dequantization, the
        # cast, the model) on the kernel rows' clock, the whole
        # forward_windows (upload, forward, download) on the host's, and
        # the launches of one forward.
        state = eng.qstate if mode != "off" else eng.state
        th, tw = eng.tile
        gen = torch.Generator(device=eng.device).manual_seed(0)
        buckets = {}
        for b in SERVE_BUCKETS:
            x = torch.rand(b, th, tw, eng.channels, device=eng.device, generator=gen)
            with torch.inference_mode():
                ms = time_ms(lambda: eng.device_logits(state, x), reps=10)
            xs = x.cpu().numpy()
            walls = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.forward_windows(xs)
                walls.append(time.perf_counter() - t0)
            row = {"device_ms": ms, "tiles_per_s": b / ms * 1e3,
                   "wall_ms": statistics.median(walls) * 1e3,
                   "wall_tiles_per_s": b / statistics.median(walls)}
            if b in (1, 8):
                torch.cuda.synchronize()
                with torch.inference_mode(), profile(
                        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    eng.device_logits(state, x)
                    torch.cuda.synchronize()
                kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
                row["launches"] = len(kernels)
                row["decode_launches"] = sum("decode" in k for k in kernels)
            buckets[b] = row
        # The card against a CPU engine on two windows of the scene.
        cpu = InferenceEngine.from_workdir(run, max_bucket=scfg.max_batch, echo=False, quantize=mode,
                                           quantize_activations=scfg.quantize_activations,
                                           device="cpu")
        wins = np.stack([scene[:th, :tw], scene[-th:, -tw:]])
        a, c = eng.forward_windows(wins), cpu.forward_windows(wins)
        d = float(np.abs(a - c).max())
        agree = float((a.argmax(-1) == c.argmax(-1)).mean())
        if not (np.isfinite(a).all() and d <= SERVE_CPU_LOGIT_SHARE * float(np.abs(c).max())
                and agree >= SERVE_CPU_AGREE):
            fail(f"[serve {mode}] card vs CPU: max |dlogit| {d} (max |logit| {np.abs(c).max()}), "
                 f"classes agree on {agree}")
        if mode != "off":
            # The quantized trees, and the dequantized weights, card = CPU.
            for k, q in eng.qstate.params.items():
                bits = (lambda t: t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
                if not (torch.equal(bits(q.cpu()), bits(cpu.qstate.params[k]))
                        and torch.equal(eng.qstate.scales[k].cpu().view(torch.int32),
                                        cpu.qstate.scales[k].view(torch.int32))):
                    fail(f"[serve {mode}] quantized leaf {k} differs between card and CPU")
            with torch.inference_mode():
                card_w = sq.dequantize_params(eng.qstate, mode)
                cpu_w = sq.dequantize_params(cpu.qstate, mode)
            for k in card_w:
                if not torch.equal(card_w[k].cpu().view(torch.int32), cpu_w[k].view(torch.int32)):
                    fail(f"[serve {mode}] dequantized leaf {k} differs between card and CPU")
        del cpu
        rows[mode] = {"card": smi_line(), "leaves": leaves, "params": n, "restore_s": restore_s,
                      "reload_restore_s": meta["restore_seconds"], "warmup_s": warmup_s,
                      "scene_s": scene_s, "hbm_bytes": hbm, "requested_bytes": requested,
                      "allocated_bytes": resident,
                      "path_launches": {k: v for k, v in launches.items() if v},
                      "path_forwards": forwards, "audit": audit, "buckets": buckets,
                      "cpu_max_abs_dlogit": d, "cpu_class_agree": agree}
        log(f"serve row [{mode}]: " + json.dumps(rows[mode]))
        engines[mode] = (eng, classes)
    return {"rows": rows, "engines": engines}


def _new_checkpoint(run: str, seed: int) -> int:
    """A newer checkpoint (the step after the newest) with other weights:
    every param times 1 + 5 % seeded noise."""
    import numpy as np

    from ddlpc_tpu_torch.train import checkpoint as ckpt

    ckdir = os.path.join(run, "checkpoints")
    tree, meta = ckpt.restore_checkpoint(ckdir)
    rng = np.random.default_rng(seed)

    def perturb(node):
        if isinstance(node, dict):
            return {k: perturb(v) for k, v in node.items()}
        a = np.asarray(node)
        return (a * (1 + 0.05 * rng.standard_normal(a.shape))).astype(a.dtype)

    tree["params"] = perturb(tree["params"])
    step = int(meta["step"]) + 1
    keep = {k: meta[k] for k in ("epoch", "input_channels") if k in meta}
    ckpt.save_snapshot(ckdir, ckpt.flatten_tree(tree), step, metadata=keep)
    return step


def serve_phase(argv: list) -> dict:
    """Serving the flagship's own checkpoint (module docstring, phase 4b'')."""
    import shutil
    import threading

    import numpy as np

    from ddlpc_tpu_torch.config import ServeConfig
    from ddlpc_tpu_torch.data.datasets import load_image_file
    from ddlpc_tpu_torch.data.png import read_png, write_png
    from ddlpc_tpu_torch.train import checkpoint as ckpt
    from ddlpc_tpu_torch.train.observability import class_palette

    src = argv[argv.index("--workdir") + 1]
    run = os.path.join(WORKDIR, "serve_run")
    shutil.rmtree(run, ignore_errors=True)
    os.makedirs(run)
    shutil.copy(os.path.join(src, "config.json"), run)
    shutil.copytree(os.path.join(src, "checkpoints"), os.path.join(run, "checkpoints"))
    step = ckpt.latest_step(os.path.join(run, "checkpoints"))
    with open(SERVE_CONFIG) as f:
        scfg = ServeConfig.from_json(f.read())
    scene = _serve_image(11, *SERVE_SCENE)
    eng_phase = serve_engine_phase(run, scfg, scene)
    off, _ = eng_phase["engines"]["off"]
    live, live_classes = eng_phase["engines"][scfg.quantize]

    # The servers start (three: each is drained once) while predict runs.
    servers = [_ServerProc(run, tag) for tag in ("a", "b", "c")]

    # python -m ddlpc_tpu_torch.predict on two images, onto the card.
    pin = os.path.join(WORKDIR, "serve_predict_in")
    pout = os.path.join(WORKDIR, "serve_predict_out")
    shutil.rmtree(pin, ignore_errors=True)
    shutil.rmtree(pout, ignore_errors=True)
    os.makedirs(pin)
    for i, (h, w) in enumerate(SERVE_PREDICT_IMAGES):
        img, _ = vaihingen_like(np.random.default_rng(20 + i), h, w)
        write_png(os.path.join(pin, f"img{i}.png"), img)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "ddlpc_tpu_torch.predict", "--workdir", run,
                        "--input", pin, "--output", pout], cwd=REPO, capture_output=True,
                       text=True, timeout=600, env=dict(os.environ, PYTHONPATH=REPO))
    predict_s = time.perf_counter() - t0
    if r.returncode != 0 or "wrote 2 predictions" not in r.stdout:
        fail(f"[serve predict] rc {r.returncode}: {r.stdout[-1000:]} {r.stderr[-2000:]}")
    pal = class_palette(off.cfg.model.num_classes)
    for i in range(len(SERVE_PREDICT_IMAGES)):
        got = read_png(os.path.join(pout, f"img{i}_pred.png"))
        image = load_image_file(os.path.join(pin, f"img{i}.png"), None, channels=off.channels)
        want = pal[off.predict_classes(image, overlap=0.25, batch=8)]
        if got.shape != want.shape or not np.array_equal(got, want):
            fail(f"[serve predict] img{i}: the CLI's PNG differs from the engine's class map "
                 f"in {int((got != want).any(-1).sum())} pixels")
    log(f"[serve predict] 2 PNGs equal the in-process engine's class maps ({predict_s:.1f} s)")

    ready = {s.tag: s.wait_ready() for s in servers}
    a = servers[0]
    status, _, body = _http(a.port, "GET", "/healthz")
    health = json.loads(body)
    if (status != 200 or health["status"] != "ok" or health["quant_mode"] != scfg.quantize
            or health["checkpoint_step"] != step):
        fail(f"[serve http] healthz {status} {health}")
    # One scene, against the in-process engine of the same weight mode.
    t0 = time.perf_counter()
    status, headers, body = _http(a.port, "POST", "/predict", _npy(scene))
    scene_http_s = time.perf_counter() - t0
    if status != 200 or headers.get("X-DDLPC-Model-Step") != str(step):
        fail(f"[serve http] scene predict {status} {headers}")
    got = np.load(__import__("io").BytesIO(body))
    differ = int((got != live_classes).sum())
    if got.shape != live_classes.shape or differ:
        fail(f"[serve http] the server's class map differs from the engine's in {differ} pixels")
    log(f"[serve http] scene {SERVE_SCENE}: class map == the in-process {scfg.quantize} engine's "
        f"({scene_http_s:.2f} s)")

    # A short load: tiles from 4 clients, and 2 scenes in the bulk class.
    def load(n_tiles: int, scenes: int, during=None) -> list:
        tiles = lambda c: lambda j: _npy(_serve_image(c * 100 + j, *off.tile))  # noqa: E731
        clients = [("/predict", tiles(c), n_tiles) for c in range(SERVE_CLIENTS)]
        clients += [("/predict?priority=batch", lambda j: _npy(scene), 1)] * scenes
        return _load(a.port, clients, during=during)[0]

    tiles0 = json.loads(_http(a.port, "GET", "/metrics")[2])["tiles"]
    t0 = time.perf_counter()
    statuses = load(SERVE_TILE_REQUESTS, SERVE_SCENES)
    load_s = time.perf_counter() - t0
    _, _, body = _http(a.port, "GET", "/metrics")
    snap = json.loads(body)
    errors = sum(s != 200 for s in statuses)
    # /metrics' own rate spans the time since its last periodic emit; the
    # load's rate is its tiles counter's growth over the load's wall.
    load_row = {"requests": len(statuses), "errors": errors, "wall_s": load_s,
                "load_tiles": snap["tiles"] - tiles0,
                "load_tiles_per_s": (snap["tiles"] - tiles0) / load_s,
                **{k: snap.get(k) for k in ("p50_ms", "p95_ms", "p99_ms", "interactive_p99_ms",
                                            "batch_p99_ms", "tiles_per_sec", "requests_per_sec",
                                            "shed", "deadline_exceeded", "batch_occupancy")}}
    log("[serve http] load: " + json.dumps(load_row))
    if errors or snap.get("shed") or snap.get("deadline_exceeded"):
        fail(f"[serve http] load: {load_row}")
    _, _, text = _http(a.port, "GET", "/metrics", headers={"Accept": "text/plain"})
    families = sorted({ln.split()[2] for ln in text.decode().splitlines() if ln.startswith("# TYPE")})

    # A reload while requests are in flight, to a newer checkpoint.
    new_step = _new_checkpoint(run, seed=5)
    reload_ans = {}

    def do_reload():
        time.sleep(0.3)
        s, _, b = _http(a.port, "POST", "/reload", b"{}")
        reload_ans.update(json.loads(b), status=s)

    statuses = load(8, 1, during=do_reload)
    status, _, body = _http(a.port, "GET", "/healthz")
    health = json.loads(body)
    if (reload_ans.get("status") != 200 or reload_ans.get("step") != new_step
            or health["version"] != 1 or health["checkpoint_step"] != new_step
            or any(s != 200 for s in statuses)):
        fail(f"[serve http] reload: {reload_ans}; healthz {health}; statuses {statuses}")
    log(f"[serve http] reload under load: step {step} -> {new_step}, version {health['version']}, "
        f"restore_seconds {reload_ans['restore_seconds']}, {len(statuses)} requests all 200")

    tile_body = _npy(_serve_image(7, *off.tile))
    for s in servers[1:]:
        if _http(s.port, "POST", "/predict", tile_body)[0] != 200:
            fail(f"[serve {s.tag}] predict failed")
    drains = [s.drain(scfg.drain_timeout_s, _npy(scene)) for s in servers]
    int8_engine = eng_phase["engines"]["int8"][0]  # the fleet phase's reference
    del eng_phase["engines"], off, live
    gc.collect()
    torch.cuda.empty_cache()
    return {"card": smi_line(), "config": os.path.relpath(SERVE_CONFIG, REPO), "step": step,
            "run": run, "int8_engine": int8_engine, "scene": scene,
            "modes": eng_phase["rows"], "ready_s": ready, "scene_http_s": scene_http_s,
            "load": load_row, "metric_families": len(families),
            "reload": {"step": new_step, "restore_seconds": reload_ans["restore_seconds"],
                       "restore_format": reload_ans.get("restore_format")},
            "predict_cli_s": predict_s, "drains": drains}


FLEET_CONFIG = os.path.join(REPO, "configs", "fleet_vaihingen.json")
FLEET_CLIENTS = 4  # closed-loop clients of each load
FLEET_LOAD_S = 8.0  # the smoke load's length: a smoke reading, not a capacity
FLEET_TILES = 4  # distinct 512² tiles the clients send
FLEET_DEADLINE_S = 300.0  # each wait on the fleet (readiness, readmission, a reload)
# The supervised flagship: attempt 0 is SIGKILLed after its second step,
# attempt 1 stalls in its second step until the watchdog ends it (42),
# attempt 2 runs clean.  The watchdog's timeout is set for every attempt
# (the command is one); 10 s rather than the stall phase's 2 s, because a
# fresh process's first step on the card also sets up cuDNN and cuBLAS,
# which the stall phase does before its watchdog starts.  The stall ends
# on its own after 120 s, so a watchdog that failed to act fails the phase
# instead of holding the run.
SUPERVISED_CHAOS = ("kill@2", "stall@2:120")
SUPERVISED_STALL_TIMEOUT_S = 10.0


def _fleet_get(port: int, path: str) -> dict:
    return json.loads(_http(port, "GET", path, timeout=60)[2])


def fleet_phase(serve: dict) -> dict:
    """The serve run from a fleet of three replicas (module docstring,
    phase 4e): ``configs/fleet_vaihingen.json`` with int8 weights, its
    answers held to the serve phase's in-process int8 engine, a smoke
    load, a replica SIGKILLed under load, a rolling reload, a quarantined
    reload rolled back, the fleet's metrics, then SIGTERM."""
    import shutil
    import signal

    import numpy as np

    from ddlpc_tpu_torch.config import FleetConfig
    from ddlpc_tpu_torch.train import checkpoint as ckpt
    from ddlpc_tpu_torch.utils.fsio import atomic_write_json

    run, ref, scene = serve["run"], serve.pop("int8_engine"), serve.pop("scene")
    with open(FLEET_CONFIG) as f:
        raw = json.load(f)
    raw["quantize"] = "int8"
    cfg = FleetConfig.from_dict(raw).replace(workdir=run)
    cfg_path = atomic_write_json(os.path.join(run, "fleet_int8.json"), raw)
    fleet_dir = cfg.resolved_fleet_dir()
    shutil.rmtree(fleet_dir, ignore_errors=True)
    step = ckpt.latest_step(os.path.join(run, "checkpoints"))
    # The reference: the serve phase's int8 engine on the same checkpoint.
    ref.reload()
    if ref.checkpoint_step != step:
        fail(f"[fleet] the reference engine serves step {ref.checkpoint_step}, not {step}")
    bodies = [_npy(_serve_image(40 + i, *ref.tile)) for i in range(FLEET_TILES)]
    want_tiles = [ref.predict_classes(_serve_image(40 + i, *ref.tile), overlap=cfg.overlap,
                                       batch=cfg.max_batch) for i in range(FLEET_TILES)]
    want_scene = ref.predict_classes(scene, overlap=cfg.overlap, batch=cfg.max_batch)
    leaves = len(ref.qstate.params)
    port = _free_port()
    log(f"[fleet] python -m ddlpc_tpu_torch.serve.fleet --config {cfg_path} --workdir {run} "
        f"--port {port} ({cfg.replicas} replicas, int8, step {step})")
    fleet = _Proc("ddlpc_tpu_torch.serve.fleet",
                  ["--config", cfg_path, "--workdir", run, "--port", str(port)], "fleet")
    clients = [("/predict", lambda j, c=c: bodies[(c + j) % len(bodies)], None)
               for c in range(FLEET_CLIENTS)]

    def load(seconds: float = 0.0, during=None):
        return _load(port, clients, seconds=seconds, during=during, timeout=120.0)

    def wait_for(what: str, pred):
        return _wait_for(f"[fleet] {what}", pred, FLEET_DEADLINE_S)

    row = {"card": smi_line(), "config": os.path.relpath(FLEET_CONFIG, REPO),
           "changes": {"quantize": "int8", "port": port}, "replicas": cfg.replicas, "step": step}
    try:
        # 1. Readiness: each replica's port file lands after its warmup.
        ready_s = {}

        def all_ready():
            if fleet.proc.poll() is not None:
                fail(f"[fleet] exited {fleet.proc.returncode}: {fleet.stderr()[-3000:]}")
            for i in range(cfg.replicas):
                name = f"r{i}"
                if name not in ready_s and os.path.exists(os.path.join(fleet_dir, name, "port")):
                    ready_s[name] = time.perf_counter() - fleet.t0
            return len(ready_s) == cfg.replicas

        wait_for("the replicas' port files", all_ready)

        def front_end():
            try:
                h = _fleet_get(port, "/healthz")
            except (OSError, ValueError):
                return None
            scraped = all(r["checkpoint_step"] is not None for r in h.get("replica_status", []))
            return h if h.get("ready") == cfg.replicas and scraped else None

        health = wait_for("the fleet's front end", front_end)
        row["ready_s"] = ready_s
        row["fleet_ready_s"] = time.perf_counter() - fleet.t0
        modes = {r["quant_mode"] for r in health["replica_status"]}
        if health["checkpoint_steps"] != [step] or modes != {"int8"} or not health.get("slo"):
            fail(f"[fleet] healthz {health}")
        log(f"[fleet] {cfg.replicas}/{cfg.replicas} ready: " + json.dumps(row["ready_s"])
            + f", front end {row['fleet_ready_s']:.1f} s")

        # 2. Answers through the router, against the in-process int8 engine.
        t0 = time.perf_counter()
        status, headers, body = _http(port, "POST", "/predict", _npy(scene))
        row["scene_s"] = time.perf_counter() - t0
        got = np.load(__import__("io").BytesIO(body)) if status == 200 else None
        if status != 200 or headers.get("X-DDLPC-Model-Step") != str(step):
            fail(f"[fleet] scene: {status} {headers} {body[:300]}")
        if got.shape != want_scene.shape or (got != want_scene).any():
            fail(f"[fleet] the scene's class map differs from the in-process int8 engine's in "
                 f"{int((got != want_scene).sum()) if got.shape == want_scene.shape else got.shape}")
        for body_i, want in zip(bodies, want_tiles):
            status, _, body = _http(port, "POST", "/predict", body_i)
            got = np.load(__import__("io").BytesIO(body)) if status == 200 else None
            if status != 200 or got.shape != want.shape or (got != want).any():
                fail(f"[fleet] a tile's class map differs from the in-process int8 engine's")
        log(f"[fleet] the {SERVE_SCENE} scene and {FLEET_TILES} tiles through the router: class "
            f"maps == the in-process int8 engine's, bit for bit ({row['scene_s']:.2f} s the scene)")

        # 3. A smoke load.
        m0 = _fleet_get(port, "/metrics")
        statuses, wall, _ = load(seconds=FLEET_LOAD_S)
        m1 = _fleet_get(port, "/metrics")
        row["smoke_load"] = {
            "label": "smoke reading: 4 closed-loop clients for 8 s on replicas time-sharing one "
                     "card; no capacity and no scaling number",
            "clients": FLEET_CLIENTS, "requests": len(statuses), "wall_s": wall,
            "errors": sum(s != 200 for s in statuses),
            "tiles_per_s": (m1["requests"] - m0["requests"]) / wall,
            **{k: m1.get(k) for k in ("p50_ms", "p95_ms", "p99_ms", "requests_per_sec")}}
        log("[fleet] smoke load: " + json.dumps(row["smoke_load"]))
        if row["smoke_load"]["errors"]:
            fail(f"[fleet] smoke load: {statuses}")

        # 4. One replica SIGKILLed under load: relaunched and readmitted.
        def kill():
            time.sleep(1.0)
            victim = _fleet_get(port, "/fleet")["supervisor"]["replicas"][1]
            t_kill = time.perf_counter()
            os.kill(victim["pid"], signal.SIGKILL)

            def readmitted():
                f = _fleet_get(port, "/fleet")
                rp = next(r for r in f["supervisor"]["replicas"] if r["name"] == victim["name"])
                st = next((r for r in f["replica_status"] if r["name"] == victim["name"]), None)
                return (rp["launches"] == victim["launches"] + 1 and rp["ready"] and st is not None
                        and st["ready"] and st["healthy"] and not st["draining"])

            wait_for(f"{victim['name']}'s readmission", readmitted)
            return {"replica": victim["name"], "pid": victim["pid"],
                    "readmit_s": time.perf_counter() - t_kill}

        statuses, wall, killed = load(during=kill)
        row["kill"] = {**killed, "requests": len(statuses), "wall_s": wall,
                       "errors": sum(s != 200 for s in statuses)}
        log("[fleet] SIGKILL under load: " + json.dumps(row["kill"]))
        if row["kill"]["errors"]:
            fail(f"[fleet] client-visible errors through the kill: {statuses}")

        # 5. A rolling reload to a newer checkpoint, under load.
        def reload():
            time.sleep(1.0)
            t0 = time.perf_counter()
            st, _, b = _http(port, "POST", "/reload", b"{}", timeout=FLEET_DEADLINE_S)
            return st, json.loads(b), time.perf_counter() - t0

        new_step = _new_checkpoint(run, seed=6)
        statuses, wall, (st, ans, reload_s) = load(during=reload)
        wait_for("every replica on the new step",
                  lambda: _fleet_get(port, "/healthz")["checkpoint_steps"] == [new_step])
        row["reload"] = {"status": st, "step": ans.get("step"), "old_step": ans.get("old_step"),
                         "seconds": reload_s, "requests": len(statuses),
                         "errors": sum(s != 200 for s in statuses),
                         "replicas": [r["replica"] for r in ans.get("replicas", [])]}
        log("[fleet] rolling reload under load: " + json.dumps(row["reload"]))
        if (st != 200 or not ans.get("ok") or ans.get("step") != new_step
                or ans.get("old_step") != step or row["reload"]["errors"]):
            fail(f"[fleet] rolling reload: {ans}; statuses {statuses}")

        # 6. A reload to a corrupt newest blob: aborted, rolled back.
        bad_step = _new_checkpoint(run, seed=7)
        with open(os.path.join(run, "checkpoints", f"ckpt_{bad_step}.dwc"), "r+b") as f:
            f.seek(12)
            b = f.read(1)
            f.seek(12)
            f.write(bytes([b[0] ^ 0xFF]))
        statuses, wall, (qst, qans, q_s) = load(during=reload)
        health = wait_for("the fleet back on the previous step", lambda: (
            lambda h: h if h["checkpoint_steps"] == [new_step] and h["ready"] == cfg.replicas
            else None)(_fleet_get(port, "/healthz")))
        row["rollback"] = {"status": qst, "reason": qans.get("reason"),
                           "aborted_on": qans.get("aborted_on"),
                           "rolled_back_to": qans.get("rolled_back_to"),
                           "rollback_clean": qans.get("rollback_clean"), "seconds": q_s,
                           "requests": len(statuses), "errors": sum(s != 200 for s in statuses),
                           "checkpoint_steps": health["checkpoint_steps"]}
        log("[fleet] quarantined reload: " + json.dumps(row["rollback"]))
        if (qst != 409 or qans.get("ok") is not False or "quarantined" not in str(qans.get("reason"))
                or qans.get("rolled_back_to") != new_step or not qans.get("rollback_clean")
                or row["rollback"]["errors"]):
            fail(f"[fleet] quarantine rollback: {qans}; statuses {statuses}")

        # 7. The fleet's metrics and SLO status.
        _, _, text = _http(port, "GET", "/metrics", headers={"Accept": "text/plain"})
        text = text.decode()
        families = sorted({ln.split()[2] for ln in text.splitlines() if ln.startswith("# TYPE")})
        router = [f for f in families if f.startswith("ddlpc_router_")]
        rollups = [f for f in families if f.startswith("ddlpc_fleet_")]
        metrics = _fleet_get(port, "/metrics")
        health = _fleet_get(port, "/healthz")
        slo = health.get("slo") or {}
        if not router or not rollups or "availability_objective" not in slo or metrics["errors_5xx"]:
            fail(f"[fleet] metrics: router {router}, rollups {rollups[:5]}, slo {slo}, "
                 f"errors_5xx {metrics.get('errors_5xx')}")
        served = 0
        for ln in text.splitlines():
            if (ln.startswith(("ddlpc_fleet_serve_jit_cache_hits_total{",
                               "ddlpc_fleet_serve_jit_cache_misses_total{"))
                    and 'replica="fleet"' in ln):
                served += int(float(ln.rsplit(" ", 1)[1]))
        launches = sum(r["launches"] for r in _fleet_get(port, "/fleet")["supervisor"]["replicas"])
        # Reloads that restored and quantized: each replica once in the
        # rolling reload; in the aborted one, the quarantining reload and
        # the explicit pin back on every replica it had reached.
        reloads = len(ans["replicas"]) + 2 * len(qans["replicas"])
        forwards = 4 * launches + served  # warmup's buckets 1, 2, 4, 8 at each launch
        row["metrics"] = {"router_families": len(router), "fleet_families": len(rollups),
                          "errors_5xx": metrics["errors_5xx"], "requests": metrics["requests"],
                          "retries": metrics["retries"], "hedges": metrics["hedges"],
                          "slo": {k: slo[k] for k in sorted(slo) if k != "kind"}}
        row["derived_launches"] = {
            "how": "derived: (launches + reloads) x leaves for absmax and encode_to_wire; "
                   "(4 warmup forwards a launch + the fleet rollup of ddlpc_serve_jit_cache_"
                   "{hits,misses}_total) x leaves for decode_from_wire, a lower bound (the "
                   "killed process's forwards after its last scrape are not counted)",
            "leaves": leaves, "replica_launches": launches, "reloads": reloads,
            "served_forwards": served, "forwards": forwards,
            "absmax": (launches + reloads) * leaves, "encode_to_wire": (launches + reloads) * leaves,
            "decode_from_wire": forwards * leaves}
        log("[fleet] metrics: " + json.dumps(row["metrics"]))
        log("[fleet] launches in the replicas: " + json.dumps(row["derived_launches"]))

        # 8. SIGTERM: the fleet and every replica drain and exit 0.
        t0 = time.perf_counter()
        fleet.proc.send_signal(signal.SIGTERM)
        try:
            rc = fleet.proc.wait(timeout=cfg.drain_timeout_s + 60)
        except subprocess.TimeoutExpired:
            fail(f"[fleet] still running {cfg.drain_timeout_s + 60} s after SIGTERM")
        exit_s = time.perf_counter() - t0
        err = fleet.stderr()
        last_exit = {}
        for ln in err.splitlines():
            m = re.match(r"\[fleet\] (r\d+): exit (-?\d+) \((\w+)\)", ln)
            if m:
                last_exit[m.group(1)] = (int(m.group(2)), m.group(3))
        logs = [err] + [open(os.path.join(fleet_dir, f"r{i}", "replica.log"), errors="replace").read()
                        for i in range(cfg.replicas)]
        row["drain"] = {"rc": rc, "exit_s": exit_s, "replica_exits": last_exit,
                        "terminate_called": any("terminate called" in t for t in logs)}
        log("[fleet] SIGTERM: " + json.dumps(row["drain"]))
        if (rc != 0 or exit_s > cfg.drain_timeout_s or row["drain"]["terminate_called"]
                or last_exit != {f"r{i}": (0, "clean") for i in range(cfg.replicas)}):
            fail(f"[fleet] drain: {row['drain']}; stderr tail {err[-3000:]}")
    finally:
        fleet.kill_tree()
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    return row


class _Attempt:
    """One supervised child as ``Supervisor`` sees a ``Popen``, timed: its
    launch, the moment its trainer's ``fit`` began (the breadcrumb it
    writes then, watched from a thread) and its exit."""

    def __init__(self, cmd, env, workdir: str, n: int):
        import threading

        self.n = n
        self.log = open(os.path.join(workdir, f"attempt{n}.log"), "w")
        self.t_launch = time.time()
        self.proc = subprocess.Popen(cmd, env=env, cwd=REPO, stdout=self.log,
                                     stderr=subprocess.STDOUT)
        self.pid = self.proc.pid
        self.t_fit = None
        self.t_exit = None
        self._workdir = workdir
        self._watch = threading.Thread(target=self._watch_fit, daemon=True)
        self._watch.start()

    def _watch_fit(self):
        from ddlpc_tpu_torch.resilience.protocol import read_breadcrumb

        while self.proc.poll() is None and self.t_fit is None:
            crumb = read_breadcrumb(self._workdir) or {}
            if crumb.get("pid") == self.pid and "start_epoch" in crumb:
                self.t_fit = crumb["time"]
            time.sleep(0.02)

    def wait(self):
        rc = self.proc.wait()
        self.t_exit = time.time()
        self._watch.join(5)
        self.log.close()
        return rc

    def poll(self):
        return self.proc.poll()

    def send_signal(self, sig):
        self.proc.send_signal(sig)


def _checkpoint_digest(ckpt_dir: str, step: int) -> str:
    """sha256 over a checkpoint's leaves (sorted paths, their bytes)."""
    import hashlib

    import numpy as np

    from ddlpc_tpu_torch.train import checkpoint as ckpt

    tree, _ = ckpt.restore_checkpoint(ckpt_dir, step=step)
    h = hashlib.sha256()
    for path, leaf in ckpt.flatten_tree(tree).items():
        h.update("/".join(path).encode())
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.view(torch.int16) if leaf.dtype == torch.bfloat16 else leaf
            leaf = leaf.numpy()
        if not isinstance(leaf, dict):
            h.update(np.ascontiguousarray(leaf).tobytes())
    return h.hexdigest()


def supervised_phase(argv: list) -> dict:
    """The flagship under the port's ``Supervisor`` (module docstring, phase
    4f): killed, stalled, then clean, to the committed loss bits and the
    uninterrupted run's final checkpoint."""
    import shutil

    from ddlpc_tpu_torch.resilience.supervisor import Supervisor

    ref_dir = argv[argv.index("--workdir") + 1]
    workdir = os.path.join(WORKDIR, "supervised")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    args = [a for a in argv if a != "--no-resume"]
    args[args.index("--workdir") + 1] = workdir
    cmd = [sys.executable, "-m", "ddlpc_tpu_torch.train", *args,
           "--set", f"train.stall_timeout_s={SUPERVISED_STALL_TIMEOUT_S}"]

    def env_fn(attempt: int) -> dict:
        env = dict(os.environ, PYTHONPATH=REPO)
        env.pop("DDLPC_CHAOS", None)
        if attempt < len(SUPERVISED_CHAOS):
            env["DDLPC_CHAOS"] = SUPERVISED_CHAOS[attempt]
        return env

    attempts, sleeps = [], []
    metrics_path = os.path.join(workdir, "metrics.jsonl")

    def records():
        try:
            with open(metrics_path) as f:
                return [r for r in map(json.loads, f) if "kind" not in r]
        except OSError:
            return []

    def popen(cmd, env=None):
        a = _Attempt(cmd, env, workdir, len(attempts))
        attempts.append(a)
        return a

    def sleep(s):
        sleeps.append(s)
        time.sleep(s)

    log(f"[supervised] python -m ddlpc_tpu_torch.resilience.supervisor --workdir {workdir} -- "
        f"python {' '.join(cmd[1:])}; chaos by attempt {list(SUPERVISED_CHAOS)}, then none")
    t0 = time.perf_counter()
    sup = Supervisor(cmd, workdir=workdir, env_fn=env_fn, popen=popen, sleep=sleep)
    result = sup.run()
    wall = time.perf_counter() - t0
    with open(os.path.join(workdir, "resilience.jsonl")) as f:
        res = [json.loads(ln) for ln in f]
    recs = records()
    losses = [r["loss"] for r in recs]
    by_epoch = {r["epoch"]: r for r in recs}
    row = {"card": smi_line(), "ok": result.ok, "attempts": result.attempts,
           "restarts_by_cause": result.restarts_by_cause, "wall_s": wall, "backoffs": sleeps,
           "causes": [r["cause"] for r in res], "progressed": [r["progressed"] for r in res],
           "ckpt_steps": [(r["ckpt_step_before"], r["ckpt_step_after"]) for r in res],
           "losses": losses}
    row["attempt_wall_s"] = [a.t_exit - a.t_launch for a in attempts]
    overhead = []
    for k in range(1, len(attempts)):
        first = by_epoch.get(k)  # attempt k resumes at epoch k, one step an epoch
        a, prev = attempts[k], attempts[k - 1]
        if a.t_fit is None or first is None:
            fail(f"[supervised] attempt {k}: no fit start or no epoch {k} record")
        overhead.append({"to_fit_s": a.t_fit - prev.t_exit, "first_step_s": first["step_time_s"],
                         "total_s": a.t_fit - prev.t_exit + first["step_time_s"]})
    row["restart_overhead"] = overhead
    # The codec launches in the children, derived: each step launches the
    # encode, the decode and the fake-quantize once and the max-abs pass
    # twice; a killed or stalled attempt ran one step past its last record.
    steps = len(recs) + sum(1 for r in res if r["cause"] != "clean")
    row["derived_launches"] = {"how": "derived from the steps run (records + one step past the "
                                      "last record of each killed or stalled attempt)",
                               "steps": steps, "encode_to_wire": steps, "decode_from_wire": steps,
                               "fake_quantize_fused": steps, "absmax": 2 * steps}
    want = _checkpoint_digest(os.path.join(ref_dir, "checkpoints"), EPOCHS)
    got = _checkpoint_digest(os.path.join(workdir, "checkpoints"), EPOCHS)
    row["checkpoint_digest_equal"] = got == want
    try:
        with open(os.path.join(workdir, "stall.log")) as f:
            row["stall_log"] = f.read().splitlines()[0]
    except (OSError, IndexError):
        row["stall_log"] = None
    log("[supervised] " + json.dumps(row))
    if (not result.ok or row["causes"] != ["oom_kill", "stall", "clean"]
            or not all(row["progressed"]) or sleeps or losses != FLAGSHIP_LOSSES
            or sorted(by_epoch) != list(range(EPOCHS)) or got != want):
        fail(f"[supervised] {row}; the uninterrupted run's checkpoint {want}, this run's {got}")
    log(f"[supervised] losses == the committed bits {FLAGSHIP_LOSSES}; the final checkpoint == the "
        f"uninterrupted run's ({want[:16]})")
    return row


# ---------------------------------------------------------------------------
# the space axis and the pipeline stages (phases 5a and 5b)

SPATIAL_WORLD = 2  # data 1 × space 2, both ranks on RANK_DEVICE over gloo
RANK_DEVICE = "cuda:0"  # every rank of the two phases time-shares the one card
SPATIAL_SETS = ("parallel.data_axis_size=-1", "parallel.space_axis_size=2")
# The synthetic run: 16 training tiles (one optimizer step an epoch:
# Cityscapes' micro 16, U-Net++'s micro 4 × sync 4) and 8 held out, three
# epochs: three optimizer steps; then, for Cityscapes, one epoch from the
# converted Cityscapes layout (16 of its 24 frames train: one step).
SPATIAL_RUNS = {"synthetic": ("data.synthetic_len=24", "data.test_split=8", "train.epochs=3"),
                "dir": ("data.test_split=8", "train.epochs=1"),
                # The config's own data as written (Potsdam: 97 training
                # tiles, 30 held out), for the zoo phase's epochs.
                "zoo": (f"train.epochs={ZOO_EPOCHS}",),
                # The config computing in float32 with SGD, on 32 training
                # tiles (one step of micro 8 × sync 4 an epoch) and 8 held
                # out, two epochs: two optimizer steps, the second's loss a
                # smooth function of the first's gradient (Adam's first
                # update is lr·sign(g), which rounding flips wherever g
                # nearly vanishes).
                "fp32_sgd": ("model.compute_dtype=float32", "train.optimizer=sgd",
                             "data.synthetic_len=40", "data.test_split=8", "train.epochs=2")}
SPATIAL_LOSS_RTOL = 1e-4  # the tiny models' card-vs-CPU tolerance (reference_phase)
SPATIAL_DEADLINE_S = 420
UNETPP = os.path.join(REPO, "configs", "vaihingen_unetpp.json")
DEEPLAB = os.path.join(REPO, "configs", "potsdam_deeplabv3p.json")
# The space-axis phases: the config as written at space 2, its runs and
# their optimizer steps (one an epoch unless ``epochs`` says otherwise;
# the first run's checkpoint is restored unsharded, and its step, peak,
# halo hop and all-reduce are timed), the unsharded step's FLOPs, the
# codec kernels each step launches once, the halo hop (a conv's input:
# micro, channels, this rank's rows, columns, and its halo rows), the
# ``gate`` run (default the first), whose step losses are held within
# ``SPATIAL_LOSS_RTOL`` of the same run unsharded here (twice under
# ``twice``, to measure its own spread), and a ``reference``: a run of the
# phase and the zoo phase that ran it unsharded before, whose batches'
# row blocks must be the ranks' batches and whose losses it is compared
# with.
SPATIAL_PHASES = {
    "spatial_cityscapes": {"config": CITYSCAPES, "steps": {"synthetic": 3, "dir": 1},
                           "flops": CITYSCAPES_FLOPS,
                           "codec": ("fake_quantize_fused", "absmax"),
                           "halo": (16, 64, 64, 256, 1), "twice": False},
    "spatial_unetpp": {"config": UNETPP, "steps": {"synthetic": 3},
                       "flops": ZOO_PATHS["unetpp"][1], "codec": (),
                       "halo": (4, 32, 256, 512, 1), "twice": True},
    # The ASPP's rate-18 input at 512² and output stride 16: 16 of its 32
    # rows a rank, so the halo takes all 16 of the neighbour's (the other
    # two rows lie past the global edge).  bf16 and Adam as written are
    # compared with the zoo phase's run; the loss gate runs in float32
    # with SGD, because a rounding's difference grows through the bf16
    # encoder and Adam's first update into 1e-4–1e-2 of the loss with no
    # fault (PERF.md §6).
    "spatial_deeplabv3p": {"config": DEEPLAB,
                           "steps": {"zoo": ZOO_PATHS["deeplabv3p"][2], "fp32_sgd": 2},
                           "epochs": {"zoo": ZOO_EPOCHS}, "gate": "fp32_sgd",
                           "flops": ZOO_PATHS["deeplabv3p"][1], "codec": (),
                           "halo": (8, 512, 16, 32, 18), "twice": False,
                           "reference": ("zoo", "deeplabv3p"), "space": SPATIAL_WORLD},
}
# The Cityscapes config at space 8, in a world of its own: 64 of 512 rows
# a rank, half the U-Net's row unit of 128 (s2d ×4, five pools).  The
# 8-row level is resharded to even boundaries before the fifth pool, whose
# 4 rows lie on four of the eight ranks (the other four hold none), and
# the transposed conv's 8 rows are resharded back.  Its synthetic run's
# batches and seed are ``spatial_cityscapes``'s, whose unsharded run is
# its reference.
UNEVEN_LABEL, UNEVEN_SPACE = "spatial_uneven", 8
SPATIAL_PHASES[UNEVEN_LABEL] = {"config": CITYSCAPES, "steps": {"synthetic": 3},
                                "flops": CITYSCAPES_FLOPS,
                                "codec": ("fake_quantize_fused", "absmax"), "halo": None,
                                "twice": False, "space": UNEVEN_SPACE,
                                "unsharded": "spatial_cityscapes", "reshards": 4}
# pipe2_flagship's stages are the space world's two ranks.
PIPE_LABEL = "pipe2_flagship"
PIPE_STAGES, PIPE_M, PIPE_MICRO, PIPE_STEPS = SPATIAL_WORLD, 4, 128, 3
PIPE_SCHEDULE = {"executed_slots": 12, "idle_slots": 2, "measured_bubble": 0.1429}
PIPE_PARAM_SHARE = 2e-2  # reference_phase's allowance: params apart, each within 2·lr a step
PIPE_LOSS_RTOL = 1e-4  # reference_phase's loss tolerance


@contextlib.contextmanager
def stagewise_codec(flat, stage_names: list):
    """Within the block, the train step's gradient sync runs the codec with
    its scale over each stage's parameters (``stage_names``, one list a
    stage), as ``PipelineTrainStep``'s stage updates take it, instead of
    over the whole gradient: the stages' gradients are gathered into one
    buffer, one bucket a stage, synced, and scattered back."""
    from ddlpc_tpu_torch.parallel import train_step

    where = dict(zip(flat.names, flat.segments()))
    index = [torch.cat([torch.arange(where[n][0], where[n][0] + where[n][1]) for n in names])
             .to(flat.grad.device) for names in stage_names]
    sizes = [int(i.numel()) for i in index]
    stage_buckets = [(sum(sizes[:s]), n) for s, n in enumerate(sizes)]
    real = train_step.sync_for_level

    def per_stage(grad, compression, axis_size, chunked_grads, key=None, buckets=None,
                  n_elements=None):
        if chunked_grads or axis_size != 1:
            raise ValueError("the stage-wise codec reference is one replica at 'off'")
        buf = torch.cat([grad[i] for i in index])
        real(buf, compression, axis_size, chunked_grads, key=key, buckets=stage_buckets,
             n_elements=buf.numel())
        for i, part in zip(index, buf.split(sizes)):
            grad[i] = part
        return None

    train_step.sync_for_level = per_stage
    try:
        yield
    finally:
        train_step.sync_for_level = real


def spatial_argv(label: str, workdir: str, run: str, space: int, device: str,
                 data_dir: str) -> list:
    argv = ["--config", SPATIAL_PHASES[label]["config"], "--device", device, "--workdir",
            os.path.join(workdir, run)]
    if device != "cuda":
        argv += ["--dist-backend", "gloo"]
    sets = SPATIAL_RUNS[run] + (f"data.data_dir={data_dir}",) * (run == "dir")
    for o in ("parallel.data_axis_size=-1", f"parallel.space_axis_size={space}", *sets):
        argv += ["--set", o]
    return argv


def spatial_rank(labels: str, data_dir: str) -> None:
    """One rank of the space-axis phases (``SPATIAL_PHASES``; ``labels``
    comma-separated) and then of ``pipe2_flagship``, one world of two
    processes for all of them: each space phase's runs through the CLI's
    entry at space 2 with the launch counts set to 0 just before and read
    just after, the canonical state's digest all-gathered, then a halo
    hop and the world's gradient all-reduce timed; writes each phase's
    ``rank<r>.json`` into ``WORKDIR/<label>``."""
    from ddlpc_tpu_torch.parallel import mesh

    mesh.initialize_distributed("gloo", f"file://{os.path.join(WORKDIR, 'spatial_rendezvous')}")
    for label in labels.split(","):
        if label == PIPE_LABEL:
            pipe_rank(os.path.join(WORKDIR, label))
        else:
            _spatial_rank_phase(label, data_dir)
        gc.collect()
        torch.cuda.empty_cache()
    mesh.destroy_distributed()


def _spatial_rank_phase(label: str, data_dir: str) -> None:
    import torch.distributed as dist

    from ddlpc_tpu_torch.analysis import program
    from ddlpc_tpu_torch.ops import cuda_quantize as cq
    from ddlpc_tpu_torch.parallel import mesh
    from ddlpc_tpu_torch.parallel.halo import halo_exchange
    from ddlpc_tpu_torch.train.__main__ import parse_args
    from ddlpc_tpu_torch.train.trainer import Trainer

    from ddlpc_tpu_torch.parallel import halo

    workdir = os.path.join(WORKDIR, label)
    rank = mesh.world_rank()
    start = time.perf_counter()
    result = {"rank": rank, "runs": {}}
    spec = SPATIAL_PHASES[label]
    space = spec.get("space", SPATIAL_WORLD)
    first = next(iter(spec["steps"]))
    for run in spec["steps"]:
        cfg, _, dev, backend = parse_args(
            ["--no-resume"] + spatial_argv(label, workdir, run, space, RANK_DEVICE, data_dir))
        trainer = Trainer(cfg, resume=False, device=dev, dist_backend=backend)
        if run == first:
            loader_equal(f"{label} rank {rank}", trainer, trainer.loader, 1)
        steps = {}
        record_steps(trainer, steps)
        moved = reshards_in_steps(trainer, halo.RESHARD_STATS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cq.reset_launch_counts()
        t0 = time.perf_counter()
        with mesh.census() as census:
            last = trainer.fit()
            torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = dict(cq.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        # The program auditor's space-arm contracts over the run at full
        # width: placement and codec-calls (against the launches too).
        audit = program.check_spatial_step(f"{label}:{run}/rank{rank}", census, trainer.state,
                                           cfg.compression, steps=spec["steps"][run],
                                           launches=launches)
        audit = audit_row(audit, census.rows)
        del census
        if run == spec.get("reference", (None,))[0]:
            steps["batch_digests"] = batch_digests(trainer.loader, 1)
        digest = _canonical_digest(trainer.state)
        hashes = [None] * space
        dist.all_gather_object(hashes, digest)
        row = {"launches": launches, "peak_bytes": peak, "fit_s": fit_s, "hashes": hashes,
               "audit": audit,
               "last": last, "spatial": trainer.spatial, "space": list(trainer.space),
               "level": trainer.shard_update, "n_params": trainer.state.params.numel,
               "reshard": moved, **steps}
        if run == first and spec["halo"]:
            # A halo hop of the phase's conv input (bf16 rows each way;
            # more rows than the neighbour holds come from it whole, the
            # rest are past the global edge), and the step's fp32 gradient
            # all-reduce.
            b, c, h, w, rows = spec["halo"]
            x = torch.randn(b, c, h, w, device=trainer.device).to(torch.bfloat16)
            row["halo_ms"] = _timed_ms(lambda: halo_exchange(x, rows, multi_hop=True), reps=9)
            row["halo_bytes"] = 2 * min(rows, h) * b * c * w * 2
            grad = trainer.state.params.grad
            del x
        if run == first:
            grad = trainer.state.params.grad
            row["allreduce_ms"] = _timed_ms(lambda: mesh.all_reduce_(grad, "sum", "stage"))
            row["allreduce_bytes"] = grad.numel() * 4
            del grad
        result["runs"][run] = row
        trainer.close()
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    result["wall_s"] = time.perf_counter() - start
    write_rank_result(workdir, rank, result)


def reshards_in_steps(trainer, stats: dict) -> dict:
    """Wrap ``trainer.train_step`` so that the returned dict sums what
    ``parallel.halo``'s reshards moved (``stats``: calls, bytes sent,
    seconds) inside the training steps only, not in evaluation."""
    step, moved = trainer.train_step, {k: 0 for k in stats}

    def counted(*args, **kwargs):
        before = dict(stats)
        out = step(*args, **kwargs)
        for k in moved:
            moved[k] += stats[k] - before[k]
        return out

    trainer.train_step = counted
    return moved


def spatial_world(data_dir: str, space: int = SPATIAL_WORLD) -> None:
    """The ranks (``--spatial-rank``) of every phase of ``SPATIAL_PHASES``
    at ``space`` (two: then of ``pipe2_flagship`` too): one start-up of
    the processes for all of them."""
    import shutil

    from ddlpc_tpu_torch.parallel import mesh

    labels = [label for label, spec in SPATIAL_PHASES.items()
              if spec.get("space", SPATIAL_WORLD) == space]
    labels += [PIPE_LABEL] * (space == SPATIAL_WORLD)
    for label in labels:
        shutil.rmtree(os.path.join(WORKDIR, label), ignore_errors=True)
        os.makedirs(os.path.join(WORKDIR, label))
    with contextlib.suppress(FileNotFoundError):
        os.remove(os.path.join(WORKDIR, "spatial_rendezvous"))
    torch.cuda.empty_cache()
    mesh.spawn_world([sys.executable, os.path.abspath(__file__), "--spatial-rank",
                      ",".join(labels), data_dir], space, SPATIAL_DEADLINE_S, cwd=REPO)


def _run_records(path: str) -> tuple:
    with open(os.path.join(path, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    return lines, [r for r in lines if "kind" not in r]


def _unsharded(label: str, workdir: str, data_dir: str, run: str, name: str) -> tuple:
    """The phase's ``run`` unsharded in this process, in
    ``<workdir>/<name>``: its step losses, epoch records and peak memory."""
    from ddlpc_tpu_torch.train.__main__ import parse_args
    from ddlpc_tpu_torch.train.trainer import Trainer

    argv = spatial_argv(label, workdir, run, 1, RANK_DEVICE.split(":")[0], data_dir)
    argv[argv.index("--workdir") + 1] = os.path.join(workdir, name)
    cfg, _, dev, backend = parse_args(["--no-resume"] + argv)
    ref = Trainer(cfg, resume=False, device=dev, dist_backend=backend)
    steps = {}
    record_steps(ref, steps)
    torch.cuda.reset_peak_memory_stats()
    ref.fit()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ref.close()
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    return steps["step_losses"], _run_records(os.path.join(workdir, name))[1], peak


def _max_rel(got: list, want: list) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def spatial_phase(label: str, data_dir: str, reference: dict = None,
                  unsharded: dict = None) -> dict:
    """A space-axis phase (``SPATIAL_PHASES``): the config as written with
    ``parallel.data_axis_size=-1`` and ``space_axis_size=2``, run by the
    two gloo ranks of :func:`spatial_world` on ``cuda:0``, each holding
    256 of every tile's 512 rows; this checks their records and runs the
    unsharded reference.  ``spatial_cityscapes``:
    ``configs/cityscapes_unet_v5e64.json`` (512×1024, 19 classes, full
    width, s2d ×4, bf16, the fp16 codec on the mean), the synthetic run
    and the converted layout's; ``spatial_unetpp``:
    ``configs/vaihingen_unetpp.json`` (full width, deep supervision, bf16,
    no stem, no codec), the synthetic run; ``spatial_deeplabv3p``:
    ``configs/potsdam_deeplabv3p.json`` (full width, output stride 16,
    ASPP rates 6/12/18, bf16, no codec) on its own data for the zoo
    phase's epoch, against ``reference``, the ``deeplabv3p`` zoo phase's
    run, then computing in float32 with SGD for two steps.  Gates: finite losses;
    every rank's canonical state the same bits; the codec's launches
    exactly one of each of the phase's kernels a step a rank and none of
    the others; each epoch's FLOPs half the unsharded step's; the host
    loader's rows ``DeviceLoader``'s; the gate run's step losses within
    ``SPATIAL_LOSS_RTOL`` of the same run unsharded in one process (under
    ``twice``, the unsharded run repeats, and past the first step, whose
    loss no update has moved, the gate widens to twice its own spread
    where that is larger); a reference run's batches split into the
    ranks' row blocks the ranks' batches, digest for digest (its losses
    against the reference's are reported); and the first run's
    checkpoint restored into an unsharded trainer bit for bit.
    ``spatial_uneven``: the Cityscapes config at space 8 (``UNEVEN_SPACE``,
    a world of its own), the synthetic run, gated as
    ``spatial_cityscapes`` against that phase's unsharded run
    (``unsharded``, its output: same config, batches and seed), each
    epoch's FLOPs an eighth of the unsharded step's, and printing what its
    reshards moved a step."""
    from ddlpc_tpu_torch.train.__main__ import parse_args
    from ddlpc_tpu_torch.train.trainer import Trainer

    spec = SPATIAL_PHASES[label]
    space = spec.get("space", SPATIAL_WORLD)
    workdir = os.path.join(WORKDIR, label)
    t0 = time.perf_counter()
    ranks = []
    for r in range(space):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    out = {"world": space, "runs": {}}
    first = next(iter(spec["steps"]))
    for run, steps in spec["steps"].items():
        epochs = spec.get("epochs", {}).get(run, steps)
        lines, records = _run_records(os.path.join(workdir, run))
        perf = perf_checks(f"{label}:{run}", lines, spec["flops"] // space, len(records))
        want = {name: 0 for name in ranks[0]["runs"][run]["launches"]}
        want.update({name: steps for name in spec["codec"]})
        for rr in ranks:
            row = rr["runs"][run]
            log(f"[{label}:{run}] rank {rr['rank']} space {row['space']}: kernels "
                f"{json.dumps(row['launches'])}, peak {row['peak_bytes'] / 2**30:.2f} GiB, fit "
                f"{row['fit_s']:.1f} s")
            if not row["spatial"] or row["launches"] != want:
                fail(f"[{label}:{run}] rank {rr['rank']}: spatial {row['spatial']}, launches "
                     f"{row['launches']}, expected {want} ({steps} steps)")
            audit_gate(f"{label}:{run}", rr["rank"], row["audit"])
            if len(set(row["hashes"])) != 1:
                fail(f"[{label}:{run}] the ranks' states differ: {row['hashes']}")
            # Even layouts reshard nothing; the uneven phase's four a step
            # (the fifth pool's input and the transposed conv's output,
            # forward and backward), every rank sending or receiving.
            if row["reshard"]["calls"] != spec.get("reshards", 0) * steps:
                fail(f"[{label}:{run}] rank {rr['rank']}: {row['reshard']['calls']} reshards in "
                     f"{steps} steps, expected {spec.get('reshards', 0)} a step")
        for rec in records:
            log(f"[{label}:{run}] epoch {rec['epoch']}: loss {rec['loss']} step_time_s "
                f"{rec['step_time_s']} grad_norm {rec['grad_norm']} val_miou {rec.get('val_miou')}")
            if not math.isfinite(rec["loss"]) or not math.isfinite(rec["grad_norm"]):
                fail(f"[{label}:{run}] non-finite training metrics {rec}")
        if len(records) != epochs or len(ranks[0]["runs"][run]["step_losses"]) != steps:
            fail(f"[{label}:{run}] {len(records)} epoch records and "
                 f"{len(ranks[0]['runs'][run]['step_losses'])} steps for {epochs} and {steps}")
        out["runs"][run] = {"losses": ranks[0]["runs"][run]["step_losses"],
                            "step_time_s": [r["step_time_s"] for r in records],
                            "peak_bytes": [rr["runs"][run]["peak_bytes"] for rr in ranks],
                            "launches": ranks[0]["runs"][run]["launches"],
                            "epochs": path_row(f"{label}:{run}", records, perf)}
    # A reference run: its batches the zoo phase's run's row blocks, and
    # its losses against that run's.
    ref_run, ref_label = spec.get("reference", (None, None))
    drift = None
    if ref_run:
        if reference is None:
            fail(f"[{label}] no {ref_label} run to hold the ranks against")
        for t, blocks in enumerate(reference["batch_digests"]):
            mine = [rr["runs"][ref_run]["batch_digests"][t][0] for rr in ranks]
            if mine != blocks:
                fail(f"[{label}:{ref_run}] batch {t}: the ranks' batches {mine} are not the row "
                     f"blocks of the {ref_label} run's {blocks}")
        got, want = out["runs"][ref_run]["losses"], reference["step_losses"]
        if len(got) != len(want):
            fail(f"[{label}:{ref_run}] {len(got)} losses at space {space} against {len(want)} "
                 f"unsharded")
        drift = {"losses": got, "unsharded_losses": want, "max_rel": _max_rel(got, want),
                 "first_rel": _max_rel(got[:1], want[:1])}
        log(f"[{label}:{ref_run}] the ranks' batches are the row blocks of the {ref_label} run's, "
            f"{len(reference['batch_digests'])} batches, digest for digest; losses at space {space} "
            f"{got} "
            f"against the {ref_label} run's {want}: max rel {drift['max_rel']:.3e}, first step "
            f"{drift['first_rel']:.3e}")
    # The gate run unsharded in one process (twice under ``twice``), or
    # the unsharded run of the phase ``spec["unsharded"]`` names.
    gate = spec.get("gate", first)
    if spec.get("unsharded"):
        if unsharded is None or unsharded["row"]["gate_run"] != gate:
            fail(f"[{label}] no {spec['unsharded']} {gate} run to hold the ranks against")
        want = unsharded["row"]["unsharded_losses"]
        ref_records = [{"step_time_s": s} for s in unsharded["row"]["unsharded_step_time_s"]]
        gate_peak = unsharded["row"]["unsharded_peak_gib"] * 2**30
        log(f"[{label}:{gate}] unsharded reference: {spec['unsharded']}'s {gate} run, the same "
            f"config, batches and seed")
    else:
        want, ref_records, gate_peak = _unsharded(label, workdir, data_dir, gate, "unsharded")
    got = out["runs"][gate]["losses"]
    if len(got) != len(want):
        fail(f"[{label}:{gate}] {len(got)} losses at space {space} against {len(want)} unsharded")
    self_rel, rtol = None, SPATIAL_LOSS_RTOL
    if spec["twice"]:
        again = _unsharded(label, workdir, data_dir, gate, "unsharded_again")[0]
        self_rel = _max_rel(again, want)
        rtol = max(SPATIAL_LOSS_RTOL, 2 * self_rel)
        log(f"[{label}:{gate}] unsharded twice: {want} and {again}, max rel {self_rel:.3e}; the "
            f"gate past the first step {rtol:.3e}")
    first_rel, rel = _max_rel(got[:1], want[:1]), _max_rel(got, want)
    log(f"[{label}:{gate}] losses at space {space} {got} against unsharded {want}: max rel "
        f"{rel:.3e}, first step {first_rel:.3e} (tolerance {SPATIAL_LOSS_RTOL}, then {rtol:.3e})")
    if first_rel > SPATIAL_LOSS_RTOL or _max_rel(got[1:], want[1:]) > rtol:
        fail(f"[{label}:{gate}] losses {got} not within rtol {SPATIAL_LOSS_RTOL} (first step) and "
             f"{rtol:.3e} of unsharded {want}")
    if ref_run:  # the first run's unsharded times and peak are the zoo run's
        ref_step_s = [r["step_time_s"] for r in reference["epochs"]]
        ref_peak = reference["peak_bytes"]
    else:
        ref_step_s, ref_peak = [r["step_time_s"] for r in ref_records], gate_peak
    argv = spatial_argv(label, workdir, first, 1, RANK_DEVICE.split(":")[0], data_dir)
    cfg, _, dev, backend = parse_args(argv)
    restored = Trainer(cfg, resume=True, device=dev, dist_backend=backend)
    equal = _canonical_digest(restored.state) == ranks[0]["runs"][first]["hashes"][0]
    epochs = spec.get("epochs", {}).get(first, spec["steps"][first])
    if restored.spatial or restored.start_epoch != epochs or not equal:
        fail(f"[{label}] the space-{space} checkpoint restored into one unsharded process: spatial "
             f"{restored.spatial}, start_epoch {restored.start_epoch}, bits equal {equal}")
    restored.close()
    del restored
    gc.collect()
    torch.cuda.empty_cache()
    syn = ranks[0]["runs"][first]
    row = {"step_time_s": out["runs"][first]["step_time_s"],
           "unsharded_step_time_s": ref_step_s,
           "losses": got, "unsharded_losses": want, "max_rel": rel, "first_rel": first_rel,
           "unsharded_self_rel": self_rel, "loss_rtol": rtol, "gate_run": gate,
           "reference_drift": drift,
           "peak_gib": [rr["runs"][first]["peak_bytes"] / 2**30 for rr in ranks],
           "unsharded_peak_gib": ref_peak / 2**30,
           "halo_ms": [rr["runs"][first].get("halo_ms") for rr in ranks],
           "halo_bytes": syn.get("halo_bytes"), "halo_shape": spec["halo"] and list(spec["halo"]),
           "reshard_per_step": [{k: v / spec["steps"][first]
                                 for k, v in rr["runs"][first]["reshard"].items()}
                                for rr in ranks],
           "allreduce_ms": [rr["runs"][first]["allreduce_ms"] for rr in ranks],
           "allreduce_bytes": syn["allreduce_bytes"], "restored_unsharded": equal,
           "ranks_s": ranks[0]["wall_s"], "wall_s": ranks[0]["wall_s"] + time.perf_counter() - t0}
    log(f"{label} row: {json.dumps(row)} ({smi_line()})")
    out["row"] = row
    return out


def pipe_batches(cfg, device) -> list:
    """The flagship trainer's super-batches of epochs 0..``PIPE_STEPS``−1 (its
    sampler over the synthetic training split), as ``PIPE_M`` micro-batches
    of ``PIPE_MICRO``, on ``device``."""
    from ddlpc_tpu_torch.data.datasets import build_dataset
    from ddlpc_tpu_torch.data.loader import EpochSampler

    train_ds, _ = build_dataset(cfg.data)
    sampler = EpochSampler(train_ds, PIPE_M * PIPE_MICRO, shuffle=cfg.data.shuffle,
                           seed=cfg.data.seed)
    out = []
    for e in range(PIPE_STEPS):
        sampler.set_epoch(e)
        images, labels = train_ds.gather(sampler.epoch_indices()[: PIPE_M * PIPE_MICRO])
        out.append((torch.from_numpy(images).view(PIPE_M, PIPE_MICRO, *images.shape[1:]).to(device),
                    torch.from_numpy(labels.astype("int64")).view(PIPE_M, PIPE_MICRO,
                                                                  *labels.shape[1:]).to(device)))
    return out


def pipe_model(cfg):
    from ddlpc_tpu_torch.models import build_model
    from ddlpc_tpu_torch.train.optim import build_optimizer

    return build_model(cfg.model, seed=cfg.train.seed), build_optimizer(cfg.train)


def pipe_rank(workdir: str) -> None:
    """One rank of ``pipe2_flagship``, in the world of the space phases
    (:func:`spatial_rank`, after them): ``PipelineTrainStep`` on the
    flagship at full width with its own codec, ``PIPE_STEPS`` steps, the
    codec's launches counted a stage; writes ``rank<r>.json`` (and rank 0
    the canonical state's parameters and statistics)."""
    import torch.distributed as dist

    from ddlpc_tpu_torch.analysis import program
    from ddlpc_tpu_torch.config import ExperimentConfig
    from ddlpc_tpu_torch.convert import gather_canonical
    from ddlpc_tpu_torch.obs import hbm
    from ddlpc_tpu_torch.ops import cuda_quantize as cq
    from ddlpc_tpu_torch.parallel import mesh
    from ddlpc_tpu_torch.parallel.pipeline import make_pipeline_train_step
    from ddlpc_tpu_torch.parallel.train_step import create_train_state

    start = time.perf_counter()
    mesh.init_grid(PIPE_STAGES, 1, 1)
    rank = mesh.world_rank()
    device = torch.device(RANK_DEVICE)
    with open(FLAGSHIP) as f:
        cfg = ExperimentConfig.from_json(f.read())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batches = pipe_batches(cfg, device)
    model, tx = pipe_model(cfg)
    full = create_train_state(model, tx, 1, "off")
    drv = make_pipeline_train_step(model, tx, cfg.compression, PIPE_M, seed=cfg.train.seed,
                                   device=device)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    p = drv.init_state(full)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() - before
    priced = hbm.pipeline_stage_hbm_bytes(p.stages)[0]
    torch.cuda.reset_peak_memory_stats()
    cq.reset_launch_counts()
    metrics, times = [], []
    with mesh.census() as census:
        for images, labels in batches:
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            p, m = drv.step(p, images, labels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            metrics.append(m)
    launches = dict(cq.LAUNCHES)
    # The program auditor's stage programs at full width: the segments
    # under stage-boundary with the flagship's carries, the update under
    # the four contracts (against the launches too).
    audits = [audit_row(a, a["census"]) for a in program.check_pipeline_rank(
        PIPE_LABEL, census, drv, p, cfg.compression, steps=PIPE_STEPS, launches=launches)]
    del census
    stash_want = 0
    if drv.stage > 0:
        shapes = drv.carry_shapes((PIPE_MICRO, *cfg.data.image_size, 3))
        stash_want = hbm.pipeline_carry_stash_bytes(shapes[drv.stage - 1], PIPE_M, 1)
    can = drv.canonical(p)
    result = {
        "rank": rank, "level": drv._level, "metrics": metrics, "step_s": times,
        "launches": launches, "schedule": drv.last_schedule, "stage": drv.stage,
        "blocks": list(drv.blocks), "resident_bytes": resident, "priced": priced,
        "stash_bytes": drv.stash_bytes, "stash_priced": stash_want,
        "peak_bytes": torch.cuda.max_memory_allocated(), "digest": _canonical_digest(can),
        "names": list(p.stages[0].params.names), "wall_s": time.perf_counter() - start,
        "audits": audits,
    }
    if rank == 0:
        sd, _ = gather_canonical(can)
        torch.save({k: v.clone() for k, v in sd.items()}, os.path.join(workdir, "staged.pt"))
    write_rank_result(workdir, rank, result)


def pipe_phase() -> dict:
    """``pipe2_flagship``: ``PipelineTrainStep`` on the flagship U-Net at
    full width (``configs/vaihingen_unet_tpu_flagship.json``, its fp16
    codec), pipe 2 × data 1: the two gloo ranks of :func:`spatial_world`
    on ``cuda:0`` after the space phases, ``PIPE_M`` = 4 micro-batches of 128 (the flagship's
    super-batch of 512) a step, three steps.  Gates: the canonical state
    and losses within ``reference_phase``'s allowance of the unstaged step
    with the same codec on the same micro-batches, its scale taken a
    stage (computed here, in one process; the whole-gradient scale is
    printed beside it);
    both ranks' canonical states the same bits; ``last_schedule``
    executed 12, idle 2, bubble 0.1429; the codec launched once a step a
    stage (``absmax`` twice); the last stage's carry stash equal to
    ``pipeline_carry_stash_bytes``; finite losses."""
    from ddlpc_tpu_torch.config import ExperimentConfig
    from ddlpc_tpu_torch.convert import gather_canonical
    from ddlpc_tpu_torch.parallel.train_step import create_train_state, make_train_step

    label = PIPE_LABEL
    workdir = os.path.join(WORKDIR, label)
    t0 = time.perf_counter()
    stages = {}
    for r in range(PIPE_STAGES):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            a = json.load(f)
        stages[a["stage"]] = a
        log(f"[{label}] stage {a['stage']} ({len(a['blocks'])} blocks {a['blocks'][0]} .. "
            f"{a['blocks'][-1]}): step s {a['step_s']}, losses "
            f"{[m['loss'] for m in a['metrics']]}, kernels {json.dumps(a['launches'])}, resident "
            f"{a['resident_bytes']} B against pipeline_stage_hbm_bytes {json.dumps(a['priced'])}, "
            f"carry stash {a['stash_bytes']} B against pipeline_carry_stash_bytes "
            f"{a['stash_priced']}, peak {a['peak_bytes'] / 2**30:.2f} GiB")
        if a["schedule"] != PIPE_SCHEDULE:
            fail(f"[{label}] last_schedule {a['schedule']} != {PIPE_SCHEDULE}")
        if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]) for m in a["metrics"]):
            fail(f"[{label}] non-finite metrics {a['metrics']}")
        if a["stash_bytes"] != a["stash_priced"]:
            fail(f"[{label}] stage {a['stage']} stashed {a['stash_bytes']} B, priced "
                 f"{a['stash_priced']}")
        want = {name: 0 for name in a["launches"]}
        want.update(codec_expect(PIPE_STEPS))
        if a["launches"] != want:
            fail(f"[{label}] stage {a['stage']} launches {a['launches']}, expected {want}")
        for audit in a["audits"]:
            audit_gate(label, a["rank"], audit)
    if len({a["digest"] for a in stages.values()}) != 1:
        fail(f"[{label}] the ranks' canonical states differ")
    # The unstaged step with the same codec on the same micro-batches: once
    # with the codec's scale taken over each stage's parameters, as the
    # stages' updates take it (the gate), once as written, over the whole
    # gradient (printed: what the stage-wise scale moves).
    with open(FLAGSHIP) as f:
        cfg = ExperimentConfig.from_json(f.read())
    device = torch.device(RANK_DEVICE)
    batches = pipe_batches(cfg, device)
    lr = cfg.train.learning_rate
    staged = torch.load(os.path.join(workdir, "staged.pt"))
    staged_losses = [m["loss"] for m in stages[0]["metrics"]]
    runs = {}
    for scale in ("stage", "whole"):
        model, tx = pipe_model(cfg)
        state = create_train_state(model.to(device), tx, 1, "off")
        step = make_train_step(tx, cfg.compression, 1, seed=cfg.train.seed)
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        with (stagewise_codec(state.params, [stages[s]["names"] for s in sorted(stages)])
              if scale == "stage" else contextlib.nullcontext()):
            for images, labels in batches:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                m = step(state, images, labels)
                losses.append(float(m["loss"]))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t1)
        peak = torch.cuda.max_memory_allocated()
        sd, _ = gather_canonical(state)
        names = set(state.params.names)
        total = apart = 0
        worst = stats_rel = 0.0
        for k, want in sd.items():
            diff = (staged[k] - want).abs()
            if k in names:
                apart += int((diff > 1e-4 * want.abs() + 1e-6).sum())
                total += want.numel()
                worst = max(worst, float(diff.max()))
            else:
                stats_rel = max(stats_rel, float((diff / (want.abs() + 1e-6)).max()))
        rel = max(abs(a - b) / abs(b) for a, b in zip(staged_losses, losses))
        runs[scale] = {"step_s": times, "losses": losses, "peak": peak, "share": apart / total,
                       "worst": worst, "stats_rel": stats_rel, "loss_rel": rel}
        over = "the whole gradient" if scale == "whole" else "each stage"
        log(f"[{label}] fp16 codec, staged against unstaged (scale over {over}) after "
            f"{PIPE_STEPS} steps: losses {staged_losses} / {losses} (max rel {rel:.3e}); "
            f"params apart (rtol 1e-4, atol 1e-6) "
            f"{apart} of {total} (share {apart / total:.5f}), max |diff| {worst:.3e}; BatchNorm "
            f"statistics max rel {stats_rel:.3e}")
        del state, step, model
        gc.collect()
        torch.cuda.empty_cache()
    gate = runs["stage"]
    if (gate["loss_rel"] > PIPE_LOSS_RTOL or gate["share"] > PIPE_PARAM_SHARE
            or gate["worst"] > 2 * lr * PIPE_STEPS):
        fail(f"[{label}] the staged state is not within the allowance of the unstaged one with "
             f"the stages' codec scale (losses rtol {PIPE_LOSS_RTOL}, params apart share "
             f"{PIPE_PARAM_SHARE}, max |diff| {2 * lr * PIPE_STEPS:.3e})")
    del batches
    gc.collect()
    torch.cuda.empty_cache()
    unstaged_s, unstaged_losses = runs["whole"]["step_s"], runs["whole"]["losses"]
    unstaged_peak, share, worst = runs["whole"]["peak"], gate["share"], gate["worst"]
    order = sorted(stages)
    row = {"step_s": stages[0]["step_s"], "unstaged_step_s": unstaged_s,
           "losses": staged_losses, "unstaged_losses": unstaged_losses,
           "resident_bytes": [stages[s]["resident_bytes"] for s in order],
           "priced": [stages[s]["priced"] for s in order],
           "stash_bytes": [stages[s]["stash_bytes"] for s in order],
           "stash_priced": [stages[s]["stash_priced"] for s in order],
           "peak_gib": [stages[s]["peak_bytes"] / 2**30 for s in order],
           "unstaged_peak_gib": unstaged_peak / 2**30, "schedule": stages[0]["schedule"],
           "launches": [stages[s]["launches"] for s in order], "param_share": share,
           "max_abs_diff": worst, "loss_rel": gate["loss_rel"],
           "whole_scale": {k: runs["whole"][k] for k in ("share", "worst", "stats_rel", "loss_rel")},
           "ranks_s": max(a["wall_s"] for a in stages.values()),
           "wall_s": max(a["wall_s"] for a in stages.values()) + time.perf_counter() - t0}
    log(f"pipeline row: {json.dumps(row)} ({smi_line()})")
    return {"row": row, "launches": stages[0]["launches"], "launches_s1": stages[1]["launches"]}


def main() -> int:
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    sys.path.insert(0, REPO)
    try:
        import ddlpc_tpu_torch  # noqa: F401
        from ddlpc_tpu_torch.kernels import build as kbuild
    except ImportError as e:
        fail(f"the port is not beside this script ({e})")
    if sys.argv[1:2] == ["--dp-rank"]:  # one rank of a data-parallel phase
        dp_rank(*sys.argv[2:6])
        return 0
    if sys.argv[1:2] == ["--spatial-rank"]:  # one rank of the space-axis phases
        spatial_rank(*sys.argv[2:4])
        return 0
    if sys.argv[1:2] == ["--stall"]:  # the watchdog phase's training process
        stall_run(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--fixtures"]:  # the data phases' fixture writer
        write_fixtures(sys.argv[2])
        return 0
    smi = smi_line()
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    start = t0 = time.perf_counter()
    path = timed("build", kbuild.build, verbose=True)
    kbuild.load_library()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s: {path}")
    sass = encode_sr_sass(path)
    fq_sass = loop_path_sass(path, r"fake_quantize_sr_kernelILb1E", elem_bytes=4)

    from ddlpc_tpu_torch.config import ExperimentConfig
    from ddlpc_tpu_torch.models import build_model

    with open(FLAGSHIP) as f:
        flagship = ExperimentConfig.from_json(f.read())
    n = sum(p.numel() for p in build_model(flagship.model).parameters())
    floor = timed("floor", floor_phase, n)
    rows = timed("kernels", kernel_phase, n)
    sr_rows = timed("stochastic_kernels", stochastic_kernel_phase, n, sass, fq_sass)
    chunk_rows = timed("chunk_kernels", shard_kernel_rows, n)
    sqrt_row = timed("sqrt", sqrt_phase)
    # The checker runs beside the reference and main-path phases, after
    # the kernels are timed; its result is read at the end.
    analysis_started = start_analysis()

    def references():
        reference_phase({"mode": "float16"}, loss_rtol=1e-4, param_share=2e-2)
        reference_phase({"mode": "int8", "rounding": "stochastic"}, loss_rtol=1e-4,
                        param_share=2e-2)
        for model, size in TINY_ZOO.values():
            reference_phase({"mode": "none"}, loss_rtol=1e-4, param_share=2e-2, model=model,
                            size=size, param_step=1)

    timed("references", references)
    main = timed(
        "nearest_fp16", main_path_phase, "nearest_fp16", (), warns=False,
        expect={"encode_to_wire": EPOCHS, "decode_from_wire": EPOCHS,
                "fake_quantize_fused": EPOCHS, "absmax": 2 * EPOCHS},
    )
    if main["losses"] != FLAGSHIP_LOSSES:
        fail(f"[nearest_fp16] losses {main['losses']} != the committed bits {FLAGSHIP_LOSSES}")
    log(f"[nearest_fp16] losses == the committed bits {FLAGSHIP_LOSSES}")
    profile = "--profile" in sys.argv[1:]
    if profile:
        timed("profile_nearest_fp16", profile_phase, main["trainer"], "nearest_fp16")
    host_rows = timed("host", host_phase, main["trainer"])
    ckpt_row = timed("checkpoint", checkpoint_phase, main["trainer"], main["argv"], main["losses"])
    # The data phases' fixtures are written meanwhile, after the host and
    # checkpoint rows, which time the host.
    data_root = os.path.join(WORKDIR, "data")
    fixtures = start_fixtures(data_root)
    del main["trainer"]  # free its state, so the next run's peak memory is its own
    # The first Trainer of a process is also held by a cycle until a
    # collection: its FLOP model's meta forward is what imports
    # torch._dynamo, and torch.fx's import keeps the importing frames.
    gc.collect()
    torch.cuda.empty_cache()
    traced = timed("traced", traced_phase, main)
    serve = timed("serve", serve_phase, main["argv"])
    fleet = timed("fleet", fleet_phase, serve)
    stall = start_stall()
    supervised = timed("supervised", supervised_phase, main["argv"])
    stall_row = timed("stall", stall_phase, stall)
    sr = timed(
        "stochastic_int8", main_path_phase, "stochastic_int8", STOCHASTIC, warns=True,
        expect={"encode_sr": EPOCHS, "decode_from_wire": EPOCHS,
                "fake_quantize_sr": EPOCHS, "absmax": 2 * EPOCHS},
    )
    if profile:
        timed("profile_stochastic_int8", profile_phase, sr["trainer"], "stochastic_int8")
    del sr["trainer"]
    gc.collect()
    torch.cuda.empty_cache()
    opts = timed("flagship_options", options_phase, main)
    zoo = {label: timed(label, zoo_phase, label, profile) for label in ZOO_PATHS}
    remat = timed("unetpp_remat", unetpp_remat_phase, zoo[REMAT_REFERENCE].pop("remat_reference"))
    timed("fixtures_wait", wait_fixtures, fixtures)
    data = {}
    for name, phase in (("flagship_tiles_dir", tiles_dir_phase), ("flagship_scenes", scenes_phase),
                        ("cityscapes_full_width", cityscapes_phase)):
        data = {key: {**data.get(key, {}), **part}
                for key, part in timed(name, phase, data_root).items()}
    data_runs = data["runs"]
    cs_run = data_runs.pop("cityscapes_synthetic")
    cs_dir_run = data_runs.pop("cityscapes_dir")
    if cs_run["n_params"] != CITYSCAPES_PARAMS:
        fail(f"the Cityscapes config has {cs_run['n_params']} parameters, not {CITYSCAPES_PARAMS}")
    # The codec's kernels at the Cityscapes config's gradient size.
    cs_rows = timed("cityscapes_kernels", kernel_phase, cs_run["n_params"])
    for row in cs_rows:
        row["launches"] = cs_run["launches"][row["name"]]
        row["launches_by_path"] = {"cityscapes_synthetic": row["launches"],
                                   "cityscapes_dir": cs_dir_run["launches"][row["name"]]}
    cs_tiles = os.path.join(data_root, "cityscapes", "tiles")
    timed("spatial_ranks", spatial_world, cs_tiles)
    spatial = timed("spatial_cityscapes", spatial_phase, "spatial_cityscapes", cs_tiles)
    spatial_pp = timed("spatial_unetpp", spatial_phase, "spatial_unetpp", cs_tiles)
    spatial_dl = timed("spatial_deeplabv3p", spatial_phase, "spatial_deeplabv3p", cs_tiles,
                       zoo["deeplabv3p"])
    for row in cs_rows:
        for label, run in (("spatial_cityscapes", spatial), ("spatial_unetpp", spatial_pp),
                           ("spatial_deeplabv3p", spatial_dl)):
            row["launches_by_path"][label] = sum(
                r["launches"][row["name"]] for r in run["runs"].values())
    timed("uneven_ranks", spatial_world, cs_tiles, UNEVEN_SPACE)
    uneven = timed(UNEVEN_LABEL, spatial_phase, UNEVEN_LABEL, cs_tiles, unsharded=spatial)
    for row in cs_rows:
        row["launches_by_path"][UNEVEN_LABEL] = sum(
            r["launches"][row["name"]] for r in uneven["runs"].values())
    pipe = timed("pipe2_flagship", pipe_phase)
    dp = {label: timed(label, dp_phase, label) for label in DP_PHASES}
    traced_dp = traced_dp_checks(dp)
    analysis = timed("analysis", analysis_phase, analysis_started)
    for run in (main, traced, sr, opts, *dp.values(), *data_runs.values()):
        if run["n_params"] != n:
            fail(f"main path flat gradient {run['n_params']} != kernel phase size {n}")
    # Each row's launches are read from the single-process path that runs
    # its kernel, with every path's count beside it (rank 0's for the
    # data-parallel ones); the _noise kernels run on no main path (the
    # kernel phase drives them).
    for path_rows, path in ((rows, "nearest_fp16"), (sr_rows, "stochastic_int8")):
        for row in path_rows:
            by_path = {"nearest_fp16": main["launches"][row["name"]],
                       "traced": traced["launches"][row["name"]],
                       "stochastic_int8": sr["launches"][row["name"]],
                       "flagship_options": opts["launches"][row["name"]],
                       **{label: run["launches"][row["name"]] for label, run in dp.items()},
                       **{label: run["launches"][row["name"]] for label, run in zoo.items()},
                       **{label: run["launches"][row["name"]] for label, run in data_runs.items()}}
            by_path["serve_int8"] = serve["modes"]["int8"]["path_launches"].get(row["name"], 0)
            by_path["pipe2_flagship_stage0"] = pipe["launches"][row["name"]]
            by_path["pipe2_flagship_stage1"] = pipe["launches_s1"][row["name"]]
            for label, run in (("spatial_unetpp", spatial_pp), ("spatial_deeplabv3p", spatial_dl)):
                by_path[label] = sum(r["launches"][row["name"]] for r in run["runs"].values())
            row["launches"] = by_path[path]
            row["launches_by_path"] = by_path
    rows += sr_rows
    paths = {"nearest_fp16": main["epochs"], "traced": traced["epochs"], "stochastic_int8": sr["epochs"],
             "flagship_options": opts["epochs"],
             **{label: run["epochs"] for label, run in dp.items()},
             **{label: run["epochs"] for label, run in zoo.items()},
             **{label: run["epochs"] for label, run in data_runs.items()},
             "cityscapes_synthetic": cs_run["epochs"], "cityscapes_dir": cs_dir_run["epochs"]}
    log("paths: " + json.dumps({"card": smi, "epochs": paths,
                                "peak_bytes": {"nearest_fp16": main["peak_bytes"],
                                               "traced": traced["peak_bytes"],
                                               "stochastic_int8": sr["peak_bytes"],
                                               "flagship_options": opts["peak_bytes"],
                                               **{k: r["peak_bytes"] for k, r in zoo.items()},
                                               **{k: r["peak_bytes"] for k, r in data_runs.items()},
                                               "cityscapes_synthetic": cs_run["peak_bytes"],
                                               "cityscapes_dir": cs_dir_run["peak_bytes"]}}))
    print(json.dumps({"kernels": rows, "cityscapes_kernels": cs_rows, "floor": floor,
                      "chunk_rows": chunk_rows, "data_parallel": dp, "data_paths": data["rows"],
                      "checkpoint": ckpt_row, "sqrt": sqrt_row, "host": host_rows,
                      "unetpp_remat": remat,
                      "stall": stall_row, "paths": paths, "serve": serve, "fleet": fleet,
                      "supervised": supervised,
                      "traced": {k: traced[k] for k in ("step_time_s", "untraced_step_time_s", "sizes",
                                                        "span_counts", "top_ops_001",
                                                        "codec_in_capture")},
                      "traced_dp": traced_dp, "spatial": spatial["row"],
                      "spatial_unetpp": spatial_pp["row"],
                      "spatial_deeplabv3p": spatial_dl["row"], UNEVEN_LABEL: uneven["row"],
                      "pipeline": pipe["row"], "analysis": analysis,
                      "phase_seconds": PHASE_SECONDS}))
    PHASE_SECONDS["total"] = round(time.perf_counter() - start, 1)
    log("phase_seconds: " + json.dumps(PHASE_SECONDS) + f" ({smi})")
    log("analysis: " + json.dumps(analysis) + f" ({smi})")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
