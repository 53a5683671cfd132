#!/usr/bin/env python3
"""Drive karpenter_tpu_torch on one NVIDIA card and check what comes out.

    python3 chip_smoke.py               # every phase
    python3 chip_smoke.py --through N   # phases 1-N (N = 1-18), then exit 3

Phases (each failure exits non-zero before the last line is printed; each
prints its seconds, ``phase N took X s``):

1. Device: requires ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. Build: compiles every CUDA source of the package with ``nvcc`` (all at
   once) and prints the ``-Xptxas -v`` summary of each, then the registers
   and spills of each instance of ``choose_config_kernel``, of the
   frontier-window scan and of the verdict and prologue kernels (fails on
   a spill).
3. Kernel vs plain: each kernel beside its plain PyTorch version on the
   same card tensors, both objectives; every output must be bit-equal, and
   each scan call must launch the kernel expected of it (the wrapper picks
   by shape, `fused_packer.scan_kernel`):
   - each problem at the main path's shapes: the resident tensors a cold
     ``TorchScheduler.solve`` on the card seeds (``ops/resident.py``);
   - config 2 (``heterogeneous_problem``, 512 slots) and the flagship
     (``flagship_problem``): ``choose_config`` and the resident ``ffd_scan``;
     config 2 also through ``ffd_scan_global`` at its own 512 slots;
   - config 2's pods on 2,000 live nodes (4096 slots, Cp 8192), the shape
     at which phase 5's solves launch ``ffd_scan_cluster``: the slot state
     does not fit one block, so the cluster scan, and also the global scan
     and the cluster scan on each other cluster size that holds the shape
     (the sizes phase 4 times in turns);
   - config 2 padded to 4096, 8192 and 16,384 slots: the cluster scan on
     the cluster the shape rule picks for each (8 CTAs of 512 threads, of
     1024, and of 1024 with 2 slots a thread);
   - the wrap case (``testing.wrap_arrays``: the scan's int32 sums wrap) at
     256 slots (resident) and 4096 (cluster, and global), and at 4096 and
     16,384 slots with its prefilled slots straddling slot K / 2, a CTA
     boundary (cluster; at 4096 on every cluster size);
   - config 2's pods on 10,000 and 20,000 live nodes (`LARGE_LIVE`: Kp and
     Cp 16,384 and 32,768), the shapes at which phase 5's solves launch
     ``ffd_scan_grid`` (one cluster of 8 CTAs, two), and the global scan
     there too; the wrap case at 32,768 and 65,536 slots (two clusters,
     four) with its prefilled slots straddling the first boundary between
     two CTAs of a cluster and, separately, between two clusters
     (`grid_wrap_cases`); the grid's co-resident clusters
     (``cudaOccupancyMaxActiveClusters``) are printed; the grid's batch
     and fleet modes (`compare_grid_batches`): ``testing.frontier_arrays``'
     wrap case at 32,768 slots with a what-if batch of `GRID_BATCH`
     elements (more than the 7 groups of two clusters), its prefilled slots
     at 0 (the frontier-window scan first) and across each boundary, and
     its "past" case at Kp 16,384 (two elements leave the window for the
     grid), through ``ffd_scan_batch`` and through the grid on every
     element, then a fleet of two wrap tenants at 32,768 slots; then, each in a
     process of its own, the grid scan with a spin budget of one clock
     cycle, alone and with a batch axis, must trap and torch must raise
     (`spin_trap`);
   - the main-path tensors of four of phase 17's problems, each captured
     from the ``ffd_pack`` call of a cold card solve (`main_path_args`):
     config 5 (Cp 16,384: the resident scan's 169,344-byte layout), the
     100k-pod tick (Kp 2,048 at 2 slots a thread, 1,000 live rows),
     config 3 (the tracked signature, a class with maxper 1 over 214
     classes) and the co-location macro units (`PHASE3_CONFIGS`);
   - the choice alone (``compare_choose``): ``choose_config`` on the three
     main-path problems, the wrap case (Gp 10), ``testing.tie_arrays``
     (first-index ties, a class that fits nothing, a class with maxper 0)
     at 4096 and 16,384 configs, 6 configs, and config 2 with ``feas`` one
     byte off (the last two read a config at a time).
4. Kernel times: each kernel's device time per launch (torch.profiler)
   and its CUDA-event time over many launches after warm-up, beside the
   plain versions' times (CUDA events) and each kernel's bound at this
   run's inputs, at each of the five problems of phase 5 (the scan the
   shapes pick).  At config 2 the global and resident scans run in turns
   (global, resident, resident, global); at the live cluster the global
   and cluster scans (global, cluster, every other cluster size and back,
   cluster, global); on 10,000 and 20,000 live nodes the global and grid
   scans (global, grid, grid, global); their ratios are printed.  The
   bound counts the bytes and operations this run's data needs; each scan
   kernel also gets its
   latency floor, class steps x (its barriers x barrier round trip + its
   exposed dependent L2 loads x L2 round trip), with the round trips (the
   block barrier per thread count, the cluster barrier per cluster size,
   the L2 load, and for the grid past one cluster the cluster barrier
   followed by the round trip between its clusters through device memory)
   measured here by ``csrc/latency_probe.cu``.  The kernels line gives
   each kernel at the problem whose solves launch it: ``choose_config``
   and ``ffd_scan`` at config 2, ``ffd_scan_cluster`` on the live cluster,
   and ``ffd_scan_global`` there too, timed through its own entry point,
   ``ffd_scan_grid`` on 20,000 live nodes; the grid and global rows also
   give their time, bound and floor at both problems past one cluster.
5. The slice: ``TorchScheduler(device="cuda").solve`` on config 2 (10,000
   pods, 317 classes), on the flagship, on config 2's pods arriving at a
   cluster of 2,000 live nodes (4096 slots: the cluster scan) and at
   clusters of 10,000 and 20,000 (16,384 and 32,768 slots: the grid
   scan).  On one scheduler a problem, 2 warm-up + 10 timed solves of each
   kind (1 + 3 past one cluster, `solve_counts`): cold
   (its compile cache and resident states dropped first), hit (the same
   pods again: a compile-cache hit that packs from the resident tensors)
   and delta (1 % of the pods replaced by new pod objects of existing
   shapes and, on the live cluster, 10 nodes' usage grown: the resident
   tensors absorb the diff).  The launch counters are set to 0 just before
   and read just after.  All pods must be placed; every hit and delta
   solve must pack from the resident tensors; after each delta the card
   tensors must equal their host mirrors bit for bit; every solve must
   launch ``choose_config`` and the scan its shapes pick once (the
   resident one on the two bench problems, the cluster one on the live
   cluster, the grid one past it: `PHASE5_SCAN`) and none
   ``ffd_scan_global``; the last cold and the last delta
   result must equal a CPU cold solve through the plain version.  Then one
   solve of each kind per problem runs under torch.profiler, after the
   counts are read and just after an unprofiled solve of its kind, for the
   device time of each kernel and the device's busy share of the solve.
   The phase's seconds are printed, and before the kernels line the
   script's.
6. The consolidation verdicts: ``TorchScheduler(device="cuda")``'s
   ``evaluate_removals`` and ``evaluate_population`` on two problems, both
   objectives.  ``sweep``: the cluster of ``bench.py``'s configs 4b/4c (560
   pods of two sizes over the 4 and 8 vCPU catalog, opened by a cold solve
   on the card: about 60 live nodes, Kp 1024, the resident scan), every
   node a candidate; the singles, then a ``SearchPlan`` pass at population
   320, 2 rounds.  ``live``: 2,000 live nodes of ``std1.large`` (4 vCPU)
   of config 2's general pool, each holding 1-4 seeded pods of those two
   sizes, the universe its 64 least-loaded nodes (Kp 4096, the cluster
   scan); the 64 singles and the 64 drop-one subsets, then a pass at
   population 512, 2 rounds.  ``live10k``: the same on 10,000 live nodes
   (Kp and Cp 16,384: the grid scan's batch mode; one timed pass; its CPU
   drives, both objectives, in spawned processes beside the card's drives,
   `VERDICT_TWINNED`; each problem's drive seconds printed).  The launch counters are set to 0 just before
   the drive and read just after: the batched scans of each problem's
   shapes (`fused_packer.batch_launches`: the frontier-window scan alone at
   ``sweep``, whose Kp 1024 fits its window, the cluster scan alone at
   ``live``, whose 2,000 live slots pass it, the grid scan alone at
   ``live10k``), each of `verdict_rows`' three
   launches (``verdict_summary``, ``verdict_configs``, ``verdict_write``)
   and ``population_pairs`` (the prologue) must have launched, no other
   batched scan; each batched launch group's shapes, W, plan, the elements
   the window finished and those the picked scan took (its ``done`` mask,
   read after a synchronize, must be the elements whose frontier stays
   within W), and the largest element frontier.  The
   decoded verdicts (and the plan's proposals and pick) must equal the
   same calls through ``device="cpu"``.  Then on the same card tensors
   each kernel against its plain version, bit for bit: the batched scan
   (full outputs, as the wrapper launches it and the picked scan on every
   element; at ``live`` and ``live10k`` also through the global scan),
   ``population_prologue``'s three outputs and the [B, 6] rows; then the
   tie and edge cases (``testing.verdict_tie_arrays``: equal masked prices
   across warps and config tiles, elements in two groups, an element with
   every config masked, one with no new slot, one with many; Gp 8 and 40;
   Cp 6, 1000 and 8192 at the live problem's Kp 4096 and B 512; next0 0
   and K), both objectives, through ``removal_verdicts`` and through
   `verdict_rows` at next0, 0 and K; the prologue with U and Gp past its
   block (``testing.population_arrays``); the frontier-window cases
   (``testing.frontier_arrays``: frontiers inside, at and past W, next0
   past W, Kp within W, -0.0 usages in the tail and the window, a request
   of +inf, caps of 2^30), each with the launches its plan makes, its
   ``done`` mask, its outputs and its verdict rows, together all three
   plans and elements the picked scan took after the window.  Each
   kernel's device time
   (torch.profiler; `verdict_rows`' launches and their sum, and its
   CUDA-event time a back-to-back call), its bound and the batched scan's
   latency floor (class steps x (barrier + 2 / 32 L2 loads) x ceil(B /
   elements the card runs at once)), the plain versions' times,
   ``torch.argsort(stable=True)`` beside the prologue, the p50 of both
   entry points with their last phases, and the count of ``needs_host``
   verdicts (`verdict_rows` and the prologue at ``sweep`` and ``live``
   only).  At ``live10k`` the grid's batched scan and the global scan are
   timed in turns on the removal batch (B 128) and
   the population (B 512), each with its bound and latency floor
   (`grid_turns`).
7. The operator: the port's provisioning loop through its normal entry
   point, ``testing.Environment(device="cuda")`` (the `Operator` over the
   fake cloud, a fake clock and the fake kubelet) over config 2's catalog
   with its ``general`` and ``dedicated`` pools and a default NodeClass
   (their ``consolidate_after`` outlasts the drive: the disruption
   controller runs every tick and takes no action).
   All 10,000 of config 2's pods go into the store and the run ticks
   (``env.step``, 2 s of fake clock) until every pod is bound; then 5
   churn rounds each replace 100 bound pods by new pods of their shapes
   (an arrival tick, then the tick that solves and binds them).  The
   launch counters are set to 0 just before the drive and read just after:
   every solve must run on the card (``last_kernel == "cuda_ffd"``) and
   launch ``choose_config`` and the scan `fused_packer.scan_kernel` picks
   for its resident state, ``ffd_scan_global`` never; every pod must be
   bound; no controller may have failed a reconcile
   (``karpenter_controller_reconcile_errors_total``); and the run's
   NodeClaims, Nodes, bindings and nominations, cloud calls, ledger stream
   and solver counters (`testing.operator_state`) must equal those of the
   same drive on the port's CPU operator.  One line a tick: the
   operator's tick ms, each controller's ms, the solve's kind (cold, hit,
   delta) and phases, the garbage collector's ms in the step, the
   diagnosis tail's ms (`TailTimer`: the operator's `_observe_tick` and
   its SLO evaluation, anomaly scan and flight record), and the
   device observatory's tick section with its
   launches by function, new signatures, transfer bytes by site and
   resident updates; then the p50 tick of each kind, the tail's p50 and
   p99, and the device busy share of the last churn round's solve tick,
   profiled (device-side events only).
8. Single-pod arrivals: the same operator with the admission fast path and
   the singleton bypass on; the 10,000 pods bound, a seeded 30 % of them
   deleted (headroom on most nodes), then one arrival a tick: 200 single
   pods of config 2's shapes, 10 bursts of 2-8 pods of one shape (each
   with a quiet tick after it) and 5 pods of 100+ vCPU, interleaved so
   that the first ``ARRIVAL_CUT`` entries hold every kind.  Fails on a
   fast-path mismatch, on fewer than half of the singles nominated by the
   fast path, on ``admit_kernel`` launches unequal to the scored attempts;
   the CPU drive (in a spawned process, `CpuTwins`, beside the card's
   drives) and the card drive with the fast path off run the first
   ``ARRIVAL_CUT`` entries only, must show every outcome and fallback
   reason of the card's full drive, and must equal the card's drive at
   that tick (`testing.operator_state`; the placements).  Then
   ``admit_kernel`` bit for bit against its plain version (every class of
   the resident state, the live cluster, the wrap cases and each of
   ``testing.admit_edge_arrays``' cases), its times and bound at the
   resident state and the live cluster, and its latency floor at both: an
   empty one-block launch at its thread count (``probe_barrier_kernel``
   with no iteration, timed here) plus its 2 block barriers and its
   dependent L2 load rounds (2, and one for each further pair of slot
   rounds that holds a live slot: `admit_loads`) at the round trips
   ``csrc/latency_probe.cu`` measures here.
9. Consolidation through the operator: `testing.consolidating_cluster`
   on the card (config 2's 10,000 pods bound, a seeded half deleted, the
   pools' ``consolidate_after`` lowered to 6 s; the default Settings, so
   the pipelined schedule brackets each tick with the disruption
   controller's speculative stages), then ticks until disruption takes no
   action for 3 ticks in a row with no pod pending (120 at most).  The
   launch counters are set to 0 just before the drive and read just
   after: ``choose_config``, the frontier-window scan, ``verdict_summary``,
   ``verdict_configs``, ``verdict_write`` and ``population_pairs`` must
   have launched, ``ffd_scan_global_batched`` not; at least one action,
   every pod bound, no reconcile error, no verdict mismatch; the ledger's
   ``NodeDisrupted`` / ``VerdictFallback`` events in order and the final
   `testing.operator_state` must equal the same drive on the CPU (run in
   the spawned process too).  Prints
   nodes and summed price before and after, actions by mechanism and
   reason, evaluations by path, the disruption reconcile's ms, the tick
   ms of ticks that consolidate and of those that do not, the
   speculation's outcomes, and profiled ticks (the device busy share of
   the first one that consolidates), and each batched launch group as
   phase 6 prints them.  Then phase 9's base (`consolidation_base`: the
   removal base the drive built at its largest Kp, with a seeded first
   population round as its batch): the wrapper's launches and the picked
   scan on every element held to the plain version bit for bit, the
   batched scan's bound and latency floors at these shapes, and the two
   timed in turns (the parent's batched scan; the window scan and the
   launch after it; twice; the parent's), which gives the window scan's
   row of the kernels line.
10. The simulator on the card: ``sim.runner.run_scenario(...,
   device="cuda")`` with a ``TraceWriter`` for each of `SIM_CELLS`, at the
   reference tests' seeds and ticks: ``steady``, ``resident-churn``,
   ``single-pod-trickle``, ``consolidation-storm``, the two scale
   anchors at full size (``anchor-500-antiaffinity``: 500 anti-affine
   pods, one node each; ``anchor-6600-density``: 6,600 pods at 110 a node
   on 60 nodes), the load corpus's ``gang-slice``, ``spot-shock-drought``
   and ``catalog-deprecations``, ``batch-waves``, ``flash-crowd``,
   ``api-storm+catalog-roll``, ``interruption-storm``, ``slo-burn``,
   ``chaos-soak`` and ``diurnal+interruption-storm``.  The launch counters are set to 0 before each scenario
   and read after it; across the phase ``choose_config``, a solve scan,
   ``admit_kernel``, the frontier-window scan, the three verdict kernels
   and ``population_pairs`` must launch.  Fails on an invariant
   violation, an anchor outside its settle budget or with other than its
   node count, a fast-path mismatch or no nomination in
   ``single-pod-trickle``, a verdict mismatch, a card trace unequal byte
   for byte to the same scenario's trace on the CPU (run in the spawned
   process, `CpuTwins`), or a replay on the card of one card trace
   (`SIM_REPLAYED`) that does not reproduce its report and its trace
   bytes.  Prints, for each scenario on the card and on the CPU, the wall
   seconds, the tick p50 / p99 ms, the time to settle, the nodes and the
   summed node price at the end, and the launches on the card.
11. The multi-tenant solver service on the card (``service/server.py``).
   First the fleet pack (``fused_packer.fleet_pack``: ``choose_config``
   with a grid y of B, then the picked scan in fleet mode) bit for bit
   against its plain version on the same card tensors and against one
   solo ``ffd_pack`` a tenant, both objectives, each call launching both
   fleet kernels once: B 1, 4 and 16 at the bench cell's shape, B 4 at
   config 2's (the resident scan), B 4 at the live cluster's (config 2 on
   2,000 live nodes, each tenant's live usage and counts seeded apart:
   Kp 4096, the cluster scan; and through the global scan's own entry
   point, ``scan="ffd_scan_global"``), B 4 ``wrap_arrays`` tenants at 256
   slots (int32 sums that wrap), each from its own seed; and past one
   cluster (`FLEET_GRID`: such tenants on 10,000 live nodes at B 4 and 16,
   Kp 16,384: the grid's fleet mode; phase 3 holds it at two clusters an
   element), each then timed in turns against the global fleet scan
   (`fleet_grid_turns`).  Then two cells,
   each one ``SolverServer(multi_tenant=True)`` and one legacy sidecar on
   the card, all of a cell's tenants in one solve group (else the phase
   fails): ``service-16-bench`` (``bench.py:run_solver_service`` at full
   scale: 16 tenants of 240 pods, tenant i 0.25 (i + 1) vCPU and 1 GiB)
   and ``service-16-config2`` (16 tenants, each a seeded 95 % subset of
   config 2's 10,000 pods, ``default_rng(100 + i)``, with its two pools
   and catalog).  Every tenant's answer through the sidecar is its twin;
   one solve a tenant warms the service's pool; then 5 rounds of a
   barrier-released burst of every tenant through the service and the
   same 16 solves one after another through the sidecar.  Fails on a
   mismatch, on no batched solve, on a fleet kernel never launched in the
   bursts (the launch counters are set to 0 just before the rounds), on
   tenant tensors uploaded in the last (warm) burst, or on ``info`` not
   reporting the card.  Prints the bursts' and the sequential rounds' p50
   and their ratio, the batch sizes, the warm burst's uploads by site, the
   pool's bytes; then each fleet launch's device time at B 16
   (torch.profiler) beside 16 solo launches', the stack's time, both
   entry points' times a call, the plain version's, and the bounds.
12. Two replicas failing over on one shared cluster store:
   ``testing.HAHarness`` (one ``StoreServer``, two ``RemoteKubeStore``
   clients negotiating ``bin1``, two operators with ``LeaderElector``s
   over one fake cloud and clock) over phase 7's cell, both operators'
   solvers on the card.  ``testing.ha_drive``: config 2's 10,000 pods
   through replica A's client, rounds of 2 s (the clock, the kubelet,
   each live replica's tick, the kubelet, both mirrors synced after
   each) until every pod is bound under A, a churn round of 100 pods
   (`HA_CHURN`: one a term, where ``testing.ha_drive`` runs 3, 3 and 2); A crashes (stops
   ticking and renewing), the clock steps past the lease and B takes
   over in a round with nothing pending, then a churn round; B releases
   the lease and A, with its first term's resident tensors and compile
   cache, leads a churn round.  The launch counters
   are set to 0 just before the drive and read just after.  Fails unless
   every launch came from the replica that led its round and no claim
   launched twice, B launched nothing in its take-over round and saw
   A's claims, no pod is pending, the consistency checker finds nothing,
   every solve ran on the card and launched ``choose_config`` and a scan
   (``ffd_scan_global`` none), after each solve the resident tensors
   equal their host mirrors, each term's first solve equals a cold CPU
   solve of its pods and live nodes, and the launch list, the ticks'
   solve kinds, the server's canonical objects and each replica's
   ``testing.operator_state`` equal the same drive on the CPU (in a
   spawned process beside it, ``CpuTwins``).  Prints each tick, the tick
   p50 by term, replica and solve kind beside phase 7's, the failover
   (rounds and simulated seconds from the crash to B's first nomination,
   B's first solve, A's first solve of its second term with its resident
   hits and rebuilds), each replica's compile-cache hits and misses,
   ``_flush_dirty`` ms (the harness wraps the method) and ``wait_synced``
   ms, the store plane's RPCs by verb and bytes by codec, and launches by
   replica.  Then a spawned process enables the runtime lock sanitizer
   before it imports the port and runs the crash-and-take-over drive on
   the card on the first 1,000 of config 2's pods with the lock watchdog
   armed: zero findings and no watchdog fire, or the phase fails; it
   prints the witness's locks and edges, the kernel wrappers' locks among
   them.
13. The fleet simulator and the deployed process.  (a) The three fleet
   scenarios of ``sim/fleet.py`` (`FLEET_CELLS`, at the JAX package's own
   test sizes: ``store-fleet-chaos`` and ``store-fleet-shard-chaos``, 36
   ticks of 3 operators; ``solver-fleet``, 24 ticks of 12 operators, each
   a tenant of one multi-tenant solver service) on the card, each also on
   the CPU in a spawned process beside it (`CpuTwins`); fails on a double
   launch, an invariant violation, a refusal by the solver service, or a
   card trace or launch list unequal to the CPU's, and unless the
   ``solver-fleet`` card trace, replayed on the card, reproduces its
   report and its bytes.  (b) The scaled cell `SCALED_FLEET`
   (``solver-fleet-config2``): ``solver-fleet``, 12 operators, 8 ticks,
   over config 2's catalog, with its two pools and the first
   `SCALED_FLEET_PODS` (2,000) of its pods put through ``op-0``'s client
   before tick 0, launches one at a time,
   consolidation held off and the tick-time SLO rule left out
   (`fleet_runner`), held as
   (a) holds each scenario; the launch counters are set to 0 just before
   the drive and read just after: ``choose_config`` and a scan must
   launch, ``ffd_scan_global`` not.  Prints the wall seconds, the tick
   p50 / p99, ``_flush_dirty`` ms a call by operator, the service's solves
   by tenant, each new leader's first remote solve (ms, and the bytes the
   service uploaded for it by site), the ticks from each crash to the next
   nomination, and the launches by kernel (`FleetProbe`, `fleet_run`).
   (c) ``python -m karpenter_tpu_torch --interval 0.05 --metrics-port
   <free> --demo-pods 10000`` on the card with ``enable_profiling`` and
   ``profile_dir`` set (`deployed_process`): once its solve has placed
   the pods (launched NodeClaims on /metrics, ``ffd_pack`` on
   /debug/device), SIGTERM; fails unless it exits 0, prints its span
   report and writes ``spans.json``, and its profiler timelines hold
   device events of ``choose_config`` and a scan.
14. The static analysis, the tools and the legacy API (`analysis_phase`).
   (a) ``python -m karpenter_tpu_torch lint --json --profile`` in a
   subprocess over the port's tree, started first and read after (b) and
   (c), which run beside it: it must exit 0 with zero live findings
   from all 18 rules.  A line before it prints the rule count, the launch
   wrappers ``tracer-safety`` discovers (``analysis/tracer.py``) and the
   upload sites ``device-put`` matches with its allowlist emptied (each
   count must be above 0), and the lint's seconds by rule.  (b)
   ``tools/allocatable_diff.diff_rows`` over phase 7's operator drive on
   the card (config 2's 10,000 pods bound): one row per managed node,
   printed; fails on a row whose computed allocatable or capacity differs
   from the node's registered one, or a skipped node.  (c) A v1alpha5
   Provisioner and an AWSNodeTemplate converted by ``api/legacy.py`` drive
   an operator on the card (`LEGACY_PODS` pods that tolerate the
   Provisioner's taint): the launch counters are set to 0 just before its
   ticks and read just after, every pod must be nominated by the tick
   that solves, ``choose_config`` and a scan must launch, every pod bound
   after, and ``testing.operator_state`` must equal the same drive on the
   CPU.
15. The device mesh (`mesh_phase`; ``parallel/mesh.py``,
   ``csrc/mesh_pack.cu`` and the shard modes of ``csrc/ffd_pack.cu``): a
   (4, 2) mesh of `MESH_SHARDS` shards over the machine's cards in turn (all 8 on the one card of a one-card machine),
   its devices printed (the solver takes the mesh only when asked, so
   this phase builds it by hand).  The main path, with the launch
   counts set to 0 just before and read just after: config 2's cold, hit
   and delta ticks through ``TorchScheduler(pack_fn=mesh_pack_fn(mesh))``,
   the flagship and the live cluster (2,000 live nodes: the prefix crosses
   shards with existing nodes) through it, and ``sharded_solve_step`` on a
   factorized problem at config 2's shapes (Gp 320, Cp 8192, Kp 4096);
   the scan the plan picks (``fused_packer.shard_scan_kernel``: the one
   cluster launch ``ffd_shard_scan`` where every data row sits on one
   card, else the cap / apply pair), the choice tiles and
   ``assemble_feasibility`` must launch (once a device: the step's
   tiles of a device in one launch), the other scan and every
   single-device kernel may not; each solve must decode equal to a
   single-device scheduler's, the hit and delta must pack from the
   sharded resident state, whose buffers must equal their mirrors.  Then
   ``mesh_pack_fn`` against the single-device ``ffd_pack`` at the three
   problems, both objectives; ``ffd_shard_scan`` whole against
   ``ffd_shard_scan_reference`` on the same card shards (every shard
   buffer) on the main path's resident tensors, and with ``ffd_pack`` on
   ``testing.wrap_arrays`` (256, and 4096 with the prefilled slots across
   shards) and two ``testing.frontier_arrays`` elements, both objectives
   there (`mesh_whole_scan`), and on the default mesh of one card, (1, 1),
   at config 2 and a frontier element (one CTA holding every slot); the
   pair, driven directly, and the choice against their plain versions step
   by step (`mesh_lockstep`) on the same cases; ``assemble_feasibility``
   whole and tile by tile (one launch a device, no mask byte copied on
   one card), and (`assemble_cases`) on tiles whose bounds and widths are
   no multiples of 16, fresh and in place into masks prefilled with
   `ASSEMBLE_SENTINEL` whose rows are C and C + 3 bytes apart, several
   tiles in one launch, and on rows of 60,000 types.  Then at
   config 2: the sharded pack through
   ``ffd_shard_scan``, through the pair (`mesh_pair_pack`) and the
   single-device ``ffd_pack`` in turns (wall ms a solve), the launches a
   solve of each scan, the pair's exchange host share, the device's busy
   and copy time of each, each kernel's profiler time a launch beside its
   plain version's and its bound from this run's data; ``ffd_shard_scan``
   also at the live cluster, with its latency floor at both (classes x the
   measured cluster exchange and barrier of its CTAs, plus the class
   tiles' L2 loads); ``assemble_feasibility``'s whole-mask launch beside
   an empty launch of its grid (`assemble_floor_ms`), its bound and the
   step's mask exchange bytes.
16. The chart on the card (`chart_phase`, `chart_topology`): the port's
   chart (``deploy/chart_torch``) rendered by the port's renderer with the
   HA and tenant values (`CHART_VALUES`: two controller replicas, the store,
   the multi-tenant solver), the settings configmap's ``settings.json``
   written to a temporary directory, and each Deployment's container
   started as a process from its rendered ``command`` + ``args``, only
   three things changed and the mapping printed (`map_argv`: service
   hostnames and the bind-all address become 127.0.0.1, every port a free
   one, the store's default telemetry port 8083 named so that it is mapped
   too, ``/etc/karpenter`` the temporary directory): the store server;
   then, through one ``RemoteKubeStore`` client, config 2's NodeClass, its
   two pools and all `CHART_PODS` of its pods (no cut of scale); the solver
   sidecar on the card; the two controllers on the card, which serve with
   the catalog the entry point builds (``generate_catalog()``).  A thread a
   controller pages its ``/events`` forward (`EventFollower`).  Fails
   unless exactly one controller leads (and no other ever did), every pod
   is nominated and the ring dropped none of its events, the store's
   NodeClaims are the ones the leader launched, their multiset of
   (instance type, zone, capacity type, pods) equals that of the CPU twin
   (`chart_twin`: the port's in-process ``Operator(device="cpu")`` over the
   same objects and catalog, in a spawned process beside the card's run),
   the solver's ``/debug/device`` shows ``choose_config`` and a scan
   launched and neither controller launched one, the leader's ``/metrics``
   and ``/healthz`` answer, each process's peak RSS (``VmHWM``) is within
   its rendered memory limit, and SIGTERM ends every process with exit
   code 0.  Prints each process's peak RSS against its limit, the seconds
   to the leader's first NodeClaim, the leader's solve (wall and phases,
   from its ``/metrics``), and the solver's launches by kernel.
17. The rest of ``bench.py``'s solve problems (`configs_phase`), built at
   full scale by the port's problem functions in ``testing.py``
   (`CONFIG_PROBLEMS`): configs 3 and 5 (5 in both objectives), the four
   co-location lines, relaxation, the hybrid line and the 100k-pod
   resident tick.  Each problem's pack shapes come from a cold card
   solve's pack (`main_path_args`), and the shape rule must pick the scan
   `CONFIG_SCAN` names there.  On one ``TorchScheduler(device="cuda")`` a problem,
   `CONFIG_SOLVES` warm-up and timed solves of each kind: cold (compile
   cache and resident states dropped first) and hit (the same pods), and
   on the 100k problem delta (1 % of the pods replaced by new objects of
   their shapes; after each, the card tensors equal their host mirrors).
   Each solve places every pod, reports the path, continuation and count
   of pods relaxed at compile time that the JAX package reports
   (`CONFIG_EXPECT`), and launches ``choose_config`` and the scan its
   shapes pick once each (`CONFIG_SCAN`); the last cold result (and the
   100k problem's last delta) equals a CPU solve of the port in canonical
   form (`canonical`).  Then config 4
   (``testing.consolidation_repack``: 5,000 pods settled, every node a
   candidate) runs ``_simulate`` over every candidate on the card; its
   decision (`repack_decision`) equals the same drive on the
   CPU.  Prints each problem's p50 by kind with its phases, launches by
   kernel and seconds.
18. ``bench.py``'s device lines (`bench_phase`), each through the port's
   drive function in ``testing.py`` with bench's constants, at full scale, the
   launch counters set to 0 just before each drive and read just after;
   the CPU drives in two spawned processes started at the phase's start
   (`bench_line_twins`, `BENCH_TWIN_GROUPS`).  ``admission_single_pod_p99``
   (``testing.admission_drive``: `resident_100k_problem`'s 1,000 live
   nodes, a one-pod seed, the trust window, 3 warm-ups, 2 passes of 200
   single-pod ``fastpath.try_admit`` calls): fails unless every attempt
   is nominated, the warm window adds no launch signature,
   ``admit_kernel`` launches once an attempt and the nominated nodes, in
   order, equal the CPU drive's; prints p99, p50, the p99 sample's
   phases, the link floor and the warm transfer bytes an attempt beside
   README's 1 ms (recorded, not a gate).  ``reconcile_tick_pipelined_p50``
   (``testing.pipelined_tick_drive``: ``diurnal+interruption-storm``,
   150 ticks, seed 11, population 256, 0.01 s between ticks), sequential
   then pipelined: fails unless each tick's state (the claims deleted,
   the disruption controller's pending set, each pod's node) is equal
   across both schedules and the CPU's sequential drive, and a
   speculation is adopted; prints both p50s, their ratio, the overlap,
   the outcomes and the largest controller phase beside bench's floors
   (recorded); then the pipelined schedule once more under torch.profiler,
   each tick a ``record_function`` range, and for each tick that adopts a
   speculation the device work in flight at its start and whether its
   first host-to-device copy waited for device work enqueued before it
   (`upload_waits`).  ``load_harness_1m_events``
   (``testing.load_harness_drive``: ``million-events``, 850 ticks, seed
   23) with a `hashed_trace`: fails unless it applies at least 1,000,000
   events with no invariant violation and checks ticks on the vectorized
   plane, and its trace's sha256 equals the CPU run's; prints the events a
   second, the phase totals and the harness fraction beside bench's 20 %
   (recorded).
Then it prints the kernels JSON line (every kernel, the old and the new;
``operator_launches`` is phase 7's count, ``consolidation_launches``
phase 9's, ``sim_launches`` phase 10's over its scenarios,
``service_launches`` phase 11's over its cells' rounds, ``ha_launches``
phase 12's over its card drive, ``fleet_launches`` phase 13's over the
scaled cell's drive, ``legacy_launches`` phase 14's over the converted
objects' drive, ``mesh_launches`` phase 15's main path,
``chart_launches`` phase 16's solver sidecar, ``configs_launches``
phase 17's solves and repack, ``bench_launches`` phase 18's drives (the
profiled run left out); the five mesh
kernels' rows take ``launches`` from there, ``forced_launches`` from the
rest of the phase, where the pair is driven directly, ``timer`` the
clock of ``ms`` (profiler, or CUDA events with the gaps between launches),
and ``ffd_shard_scan``'s row its latency floor and its time, its timer,
bound and floor at the live cluster; ``ffd_scan_grid_batched``'s and
``ffd_scan_grid_fleet``'s rows their readings in turns with the global
scan, ``in_turns``, the fleet row also its launches in phase 11's checks,
``forced_launches``: no cell reaches its shapes), the card line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

# published peaks of one H100 SXM (NVIDIA data sheet) at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
WARMUP_SOLVES, TIMED_SOLVES = 2, 10
SOLVE_KINDS = ("cold", "hit", "delta")  # phase 5's solves of each problem
DELTA_PODS = 100  # pods replaced each delta tick: 1 % of 10,000
DELTA_NODES = 10  # live nodes whose usage changes each delta tick
KERNEL_SOURCE = "karpenter_tpu_torch/csrc/ffd_pack.cu"
REPLACES = "karpenter_tpu/ops/pallas_packer.py:99"  # _pack_step
SCAN_KERNELS = ("ffd_scan", "ffd_scan_global", "ffd_scan_cluster", "ffd_scan_grid")
# the consolidation verdicts' kernels (phase 6): the scans with the batch
# axis, counted apart from the solve's, the three launches of
# `verdict_rows` and the one of `population_prologue`
VERDICT_ROWS = ("verdict_summary", "verdict_configs", "verdict_write")
VERDICT_KERNELS = ("ffd_scan_batched", "ffd_scan_cluster_batched",
                   "ffd_scan_global_batched", "ffd_scan_window_batched",
                   "ffd_scan_grid_batched", *VERDICT_ROWS, "population_pairs")
# the wrapper (the function held to its plain version) of each verdict launch
VERDICT_FUNCTION = {**{k: "verdict_rows" for k in VERDICT_ROWS},
                    "population_pairs": "population_prologue"}
KERNELS = ("choose_config", *SCAN_KERNELS, *VERDICT_KERNELS, "admit_kernel",
           "choose_config_fleet", "ffd_scan_fleet", "ffd_scan_cluster_fleet",
           "ffd_scan_global_fleet", "ffd_scan_grid_fleet", "assemble_feasibility",
           "choose_config_shard",
           "ffd_shard_scan", "ffd_shard_cap", "ffd_shard_apply")
LIVE_NODES = 2000  # phase 5's live cluster: 2,000 + 256 slots -> 4096
# phase 5's clusters past one thread-block cluster (config 2's pods on
# 10,000 and 20,000 live nodes: Kp 16,384 and 32,768, the grid scan), each
# driven with fewer solves (warm-up, timed) to stay inside the run's time
LARGE_LIVE = {"config2_live10k": 10_000, "config2_live20k": 20_000}
LARGE_SOLVES = (1, 3)
# phase 3's wrap cases on the grid scan: two clusters and four; the first
# also with a what-if batch axis (B elements: more than the groups of two
# clusters an H100 holds, 7) and as a fleet of two
GRID_WRAP_SLOTS = (32768, 65536)
GRID_BATCH = 16
# phase 3's frontier case whose elements leave the window for the grid
# (`testing.frontier_arrays`' "past" at Kp 16,384: Cp 20,000 puts its
# feasibility ring past a cluster's CTA)
GRID_FRONTIER = dict(case="past", k_slots=16384, configs=20000)
# the scan each of phase 5's problems must launch once a solve
PHASE5_SCAN = {"config2": "ffd_scan", "flagship": "ffd_scan",
               "config2_live": "ffd_scan_cluster",
               **{name: "ffd_scan_grid" for name in LARGE_LIVE}}
# the problem each kernel's row of the kernels line is measured at: the one
# whose solves launch it (the global scan: where it ran before the cluster
# scan took that shape)
ROW_PROBLEM = {"choose_config": "config2", "ffd_scan": "config2",
               "ffd_scan_global": "config2_live", "ffd_scan_cluster": "config2_live",
               "ffd_scan_grid": "config2_live20k",
               "ffd_scan_batched": "sweep", "ffd_scan_cluster_batched": "live",
               "ffd_scan_global_batched": "live",
               "ffd_scan_window_batched": "consolidation",
               "ffd_scan_grid_batched": "live10k",
               **{k: "live" for k in VERDICT_FUNCTION},
               "admit_kernel": "arrivals",
               "choose_config_fleet": "service-16-config2",
               "ffd_scan_fleet": "service-16-config2",
               "ffd_scan_cluster_fleet": "fleet_live", "ffd_scan_global_fleet": "fleet_live",
               "ffd_scan_grid_fleet": "fleet_live10k",
               # phase 15: the factorized step at config 2's shapes, and the
               # sharded pack over config 2's resident state on the mesh
               "assemble_feasibility": "mesh_step", "choose_config_shard": "config2_mesh",
               "ffd_shard_scan": "config2_mesh", "ffd_shard_cap": "config2_mesh",
               "ffd_shard_apply": "config2_mesh"}
OBJECTIVES = ("nodes", "cost")
# phase 6: the sweep's pods, the live cluster's nodes and universe, each
# problem's population and rounds, the plan's seed, timed repeats
# the JAX package's device functions each verdict kernel takes the place of
# (jitted XLA functions, not Pallas kernels): the batched scans run
# removal_verdict_kernel's vmapped _pack_core, verdict_rows' launches its
# _verdict_row epilogue, population_pairs population_verdict_kernel's
# prologue
VERDICT_REPLACES = {
    "ffd_scan_batched": "karpenter_tpu/ops/packer.py:615",
    "ffd_scan_cluster_batched": "karpenter_tpu/ops/packer.py:615",
    "ffd_scan_global_batched": "karpenter_tpu/ops/packer.py:615",
    "ffd_scan_window_batched": "karpenter_tpu/ops/packer.py:615",
    "ffd_scan_grid_batched": "karpenter_tpu/ops/packer.py:615",
    **{k: "karpenter_tpu/ops/packer.py:525" for k in VERDICT_ROWS},
    "population_pairs": "karpenter_tpu/ops/packer.py:686",
}
SWEEP_PODS = 560
LIVE_UNIVERSE = 64
# the live cluster past one thread-block cluster (Kp and Cp 16,384: the
# grid scan), built as ``live`` is
LIVE10K_NODES = 10_000
POPULATION = {"sweep": 320, "live": 512, "live10k": 512}
SEARCH_ROUNDS, SEARCH_SEED, VERDICT_SEED = 2, 7, 8
# timed passes a problem (``live10k`` fewer, to stay inside the run's time)
TIMED_VERDICTS = {"sweep": 5, "live": 5, "live10k": 1}
# the scan each verdict problem's shapes pick (its batched form runs after
# the frontier-window scan where `fused_packer.batch_launches` says so: at
# ``sweep`` the window holds every slot, at ``live`` and ``live10k`` next0
# is past it)
VERDICT_SCAN = {"sweep": "ffd_scan", "live": "ffd_scan_cluster", "live10k": "ffd_scan_grid"}
# the problems whose batched scan is also held to and timed against the
# global scan's (forced through `fused_packer._launch_global`)
VERDICT_GLOBAL = ("live", "live10k")
# the problems whose CPU drives (the card's drives repeated through the
# plain versions, each objective) run in spawned processes, one an
# objective, beside the card's drives (`verdict_twin`: live10k's takes
# about 24 s an objective on the card's host), and the problems at which
# `verdict_rows`' and the prologue's launches are timed (their rows are
# measured at ``live``)
VERDICT_TWINNED = ("live10k",)
VERDICT_ROWS_TIMED = ("sweep", "live")
# the grid's batched scan and the global one timed in turns (global, grid,
# grid, global) on live10k's removal batch and population: CUDA-event
# calls a reading
GRID_TURN_ITERS = 3
L2_PROBE_BYTES = 8 << 20  # pointer-chase buffer: past L1, well inside L2
PROFILE_ATTEMPTS = 3  # profiler windows a kernel's device time may take
# a kernel the profiler names otherwise than "<name>_kernel": the choice
# tile is choose_config_kernel's shard mode (timed where it alone launches)
PROFILE_SYMBOL = {"choose_config_shard": "choose_config_kernel",
                  "ffd_shard_scan": "ffd_scan_cluster_kernel"}
SLEEP_PROBE_CYCLES = 10_000_000  # the sleep kernel's calibration (events_device_ms)
# the kernels whose registers phase 2 prints and whose spills fail the run
SPILL_CHECKED = ("choose_config", "ffd_scan_window", *VERDICT_ROWS, "population_pairs",
                 "admit", "ffd_scan_grid")
# the same: the cluster scan, whose shard mode is the mesh's ffd_shard_scan
MESH_SPILL_CHECKED = ("ffd_scan_cluster",)
# phase 7: the operator over config 2's catalog and all of its pods, ticks
# of fake clock, the ticks allowed until every pod is bound, the churn
OPERATOR_PODS = 10_000
TICK_S = 2.0
MAX_BIND_TICKS = 12
CHURN_ROUNDS, CHURN_PODS, CHURN_SEED = 5, 100, 3
# the operator's controllers, in its order (interruption only runs with a
# queue, which phases 7-9 do not set)
CONTROLLERS = ("nodeclass", "provisioner", "lifecycle", "disruption", "termination",
               "link", "garbagecollection", "tagging", "metrics_state", "consistency")
# phases 7 and 8 drive provisioning: their pools' consolidate_after outlasts
# the drive, so the disruption controller runs each tick and takes no action
HOLD_CONSOLIDATION_S = 1e9
# phase 8: on the bound cluster of phase 7's first ticks with a seeded 30 %
# of its pods deleted (headroom on most nodes), one arrival a tick: single
# pods of config 2's shapes, bursts of 2-8 pods of one class (each followed
# by a quiet tick), pods larger than any live node's headroom, interleaved
# so that the first ARRIVAL_CUT entries hold every kind
ARRIVALS, BURSTS, OVERSIZED = 200, 10, 5
BURST_SIZES = (2, 8)
ARRIVAL_SEED = 11
HEADROOM_SEED, HEADROOM_SHARE = 17, 0.3
BURST_EVERY, OVERSIZED_EVERY = 20, 40  # a burst after every 20th single, ...
# plan entries the CPU and fast-path-off drives run: past the instance-type
# cache's 300 s TTL (150 ticks), whose roll is one of the fast path's
# fallback reasons
ARRIVAL_CUT = 160
OVERSIZED_CPU = 100.0  # vCPU: more than half the largest type, so one a node
ADMIT_REPLACES = "karpenter_tpu/ops/packer.py:197"  # admit_kernel, jitted XLA
ADMIT_ITERS = 200  # launches a timing reading averages
# admit_kernel's chain (csrc/ffd_pack.cu): 2 block barriers (the warps'
# slot round totals, whose shared words carry the open bit too; the placed
# total) and 2 dependent load rounds: the class row, the slots' configs and
# the configs' bytes; then the first group of ADMIT_SLOT_GROUP slot rounds'
# feasibility bytes and alloc and used0 axes with the first group of
# candidate configs' alloc axes.  Each further group of slot rounds that
# holds a live slot is a round more; a warp none of whose first configs
# fits tests the next group in a further round (data-dependent: the floor
# counts none).
ADMIT_BARRIERS, ADMIT_FIXED_LOADS, ADMIT_SLOT_GROUP = 2, 2, 2
# phase 9: consolidation through the operator (testing.consolidating_cluster:
# phase 7's bound cluster, a seeded half of its pods deleted), ticks until
# disruption takes no action for CONSOLIDATION_QUIET ticks in a row with no
# pod pending, at most CONSOLIDATION_TICKS; profiled ticks at most
CONSOLIDATION_QUIET, CONSOLIDATION_TICKS, PROFILED_TICKS = 3, 120, 6
# phase 9's base: the removal batch its kernels are held and timed on (the
# first round of a SearchPlan pass over the base's universe, as the
# disruption controller's population search sizes it), and the timed calls
# of each side of the in-turns reading
BASE_POPULATION, BASE_SEED, BASE_ITERS = 128, 19, 5
# what phase 9's drive must launch through the operator
CONSOLIDATION_KERNELS = ("choose_config", *VERDICT_ROWS, "population_pairs")
# the CPU drives of phases 8-10 run in a process of their own, beside
# the card's drives, on this many of the host's threads
CPU_TWIN_THREADS = 3
# phase 10: (scenario, seed, ticks) as the JAX package's tests run them, the
# anchors at full size; the node count each anchor must end with; the
# scenario whose card trace is replayed on the card
SIM_CELLS = (
    ("steady", 3, 40),
    ("resident-churn", 21, 70),
    ("single-pod-trickle", 11, 60),
    ("consolidation-storm", 7, 60),
    ("gang-slice", 7, 30),  # tests/test_load.py:345-351
    ("spot-shock-drought", 7, 32),
    ("catalog-deprecations", 7, 30),
    ("batch-waves", 7, 50),  # tests/test_sim.py:130-138
    ("flash-crowd", 7, 50),
    ("api-storm+catalog-roll", 7, 100),
    ("interruption-storm", 5, 60),  # tests/test_sim.py:65
    ("slo-burn", 3, 30),  # tests/test_diagnosis.py:836
    ("chaos-soak", 3, 60),  # tests/test_consolidation_batch.py:110-124
    ("diurnal+interruption-storm", 11, 40),  # tests/test_pipeline.py:410
    ("anchor-500-antiaffinity", 1, 15),
    ("anchor-6600-density", 1, 15),
)
ANCHOR_NODES = {"anchor-500-antiaffinity": 500, "anchor-6600-density": 60}
SIM_REPLAYED = "consolidation-storm"
# what phase 10 must launch, over its scenarios (and a solve scan)
SIM_KERNELS = ("choose_config", "admit_kernel", "ffd_scan_window_batched", *VERDICT_ROWS,
               "population_pairs")

# phase 11: the solver service's cells (bench.py:run_solver_service at full
# scale: 16 tenants of 240 pods; config 2 as a fleet: 16 seeded 95 %
# subsets of its pods), each cell's bursts and sequential rounds, the
# fleet parity cases (B at the bench shape; the live cluster's per-tenant
# usage seed; the wrap tenants' first seed) and the profiled calls a fleet
# reading averages
SERVICE_TENANTS, SERVICE_PODS, SERVICE_SHARE, SERVICE_SEED = 16, 240, 0.95, 100
SERVICE_ROUNDS = 5
FLEET_BATCHES = (1, 4, 16)
FLEET_LIVE_SEED, FLEET_WRAP_SEED, FLEET_ITERS = 23, 7, 20
# the fleet pack's launches (choose_config with a grid y of B, the picked
# scan in fleet mode), in place of the JAX package's fleet_pack_kernel, a
# jitted vmap of _pack_core (not a Pallas kernel)
FLEET_KERNELS = ("choose_config_fleet", "ffd_scan_fleet", "ffd_scan_cluster_fleet",
                 "ffd_scan_global_fleet", "ffd_scan_grid_fleet")
# the fleets past one thread-block cluster: problem, tenants (config 2 on
# 10,000 live nodes at B 4 and 16, more than the 15 groups of one cluster;
# a fleet of two clusters an element is phase 3's, on wrap tenants at 32,768
# slots: PERF.md §4)
FLEET_GRID = (("config2_live10k", 4), ("config2_live10k", 16))
FLEET_REPLACES = "karpenter_tpu/ops/packer.py:930"
# phase 12: two replicas over one shared cluster store, phase 7's cell
# (config 2's pods, CHURN_PODS a churn round, `HA_CHURN` churn rounds in the
# three terms: one a term, cut from testing.HA_CHURN_ROUNDS' 3, 3, 2, PERF.md
# §4); the sanitized failover's first pods of config 2, its churn rounds and
# pods, and the lock watchdog's stall bound
HA_CHURN = (1, 1, 1)
HA_SANITIZED_PODS, HA_SANITIZED_ROUNDS, HA_SANITIZED_CHURN = 1000, (1, 1, 1), 10
HA_WATCHDOG_STALL_S = 30.0
# phase 13: the fleet scenarios (sim/fleet.py) at the JAX package's own test
# sizes, (scenario, seed, ticks, operators); the one whose card trace is
# replayed on the card; the scaled cell (solver-fleet over config 2's
# catalog, pools and pods); what it must launch; the deployed process's
# demo pods and how long it may take to solve them
FLEET_CELLS = (
    ("store-fleet-chaos", 0, 36, 3),  # tests/test_sim_fleet.py:22
    ("store-fleet-shard-chaos", 0, 36, 3),  # tests/test_sim_fleet_shards.py:27
    ("solver-fleet", 0, 24, 12),  # tests/test_service_tenants.py:326-327
)
FLEET_REPLAYED = "solver-fleet"
# (the scaled cell's ticks cut from the tests' 24 and its pods from config
# 2's 10,000: PERF.md §4; phases 12 and 16 run all 10,000 over the store)
SCALED_FLEET = ("solver-fleet-config2", "solver-fleet", 0, 8, 12)
SCALED_FLEET_PODS = 2_000
DEPLOYED_PODS, DEPLOYED_WAIT_S = 10_000, 300.0
# phase 14: the lint's rules, its time limit, and the converted legacy
# objects' drive (pods; ticks until they are nominated)
LINT_RULES = 18
LINT_TIMEOUT_S = 600
# phase 15: the device mesh (parallel/mesh.py, csrc/mesh_pack.cu)
MESH_SHARDS = 8  # a (4, 2) mesh: 8 shards on one card, one a card on eight
MESH_SOURCE = "karpenter_tpu_torch/csrc/mesh_pack.cu"
# the choice tile and the one-launch scan are the shard modes of
# ffd_pack.cu's choose_config_kernel and ffd_scan_cluster_kernel
MESH_SOURCES = {"choose_config_shard": KERNEL_SOURCE, "ffd_shard_scan": KERNEL_SOURCE}
MESH_KERNELS = ("assemble_feasibility", "choose_config_shard", "ffd_shard_scan",
                "ffd_shard_cap", "ffd_shard_apply")
MESH_PAIR = ("ffd_shard_cap", "ffd_shard_apply")  # the scan across cards, a pair a class
MESH_REPLACES = {  # the jitted XLA the mesh kernels replace (the reference's mesh)
    "assemble_feasibility": "karpenter_tpu/parallel/mesh.py:74",
    "choose_config_shard": "karpenter_tpu/ops/packer.py:97",
    "ffd_shard_scan": "karpenter_tpu/ops/packer.py:154",
    "ffd_shard_cap": "karpenter_tpu/ops/packer.py:124",
    "ffd_shard_apply": "karpenter_tpu/ops/packer.py:133",
}
MESH_STEP_TYPES = 1024  # the factorized step at config 2's shapes: Cp 8192 ...
MESH_STEP_CLASSES = 320  # ... Gp 320, at the live cluster's 4096 slots
MESH_TIMED = 3  # timed sharded packs (and single-device packs) at config 2
ASSEMBLE_SENTINEL = 0xA5  # the bytes of a prefilled mask outside its tiles
LEGACY_PODS, LEGACY_TICKS = 40, 4

# phase 16: the port's chart (deploy/chart_torch) rendered with the HA and
# tenant values, each Deployment's container started as a process
CHART_DIR = "deploy/chart_torch"
CHART_VALUES = {"replicas": "2", "store.enabled": "true",
                "service.multiTenant.enabled": "true"}
CHART_MOUNT = "/etc/karpenter"  # where the settings configmap is mounted
CHART_PORT_FLAGS = ("--port", "--metrics-port", "--telemetry-port")
# a port a container binds without its argv naming it: the store server's
# telemetry (service/store_server.py), named here so that it is mapped too
CHART_IMPLICIT_PORTS = {"store": "--telemetry-port=8083"}
CHART_PODS = OPERATOR_PODS  # all of config 2's pods: no cut of scale
CHART_DEADLINE_S = 300.0  # the processes' start, the load and every nomination
CHART_STOP_S = 60.0  # a process's wait to exit after SIGTERM

# phase 17: bench.py's other solve problems, built by the port's testing.py at full scale
CONFIG_PROBLEMS = ("config3", "config5", "coloc-tensor", "coloc-crossclass",
                   "coloc-inequiv", "coloc-prefer", "relax", "hybrid", "resident100k")
CONFIG_OBJECTIVES = {"config5": OBJECTIVES}  # the others: the nodes objective
# (path, continuation, pods relaxed at compile time) as the JAX package
# reports them for each problem at full scale
CONFIG_EXPECT = {**{name: ("tensor", "", 0) for name in CONFIG_PROBLEMS},
                 "relax": ("tensor", "", 3000), "hybrid": ("hybrid", "join", 0)}
# the scan each problem's solves must launch once (the resident scan: the
# 100k tick at Kp 2,048 and 2 slots a thread, config 5 at Cp 16,384)
CONFIG_SCAN = {name: "ffd_scan" for name in CONFIG_PROBLEMS}
CONFIG_SOLVES = (1, 3)  # warm-up, timed solves of each kind
CONFIG_DELTA = "resident100k"  # the problem that also runs bench's warm tick
CONFIG_DELTA_SHARE = 100  # its delta replaces 1 pod in 100
REPACK_SIMULATIONS = (1, 3)  # config 4's warm-up, timed ``_simulate`` calls
# phase 3: the problems whose main-path tensors it holds each kernel to
PHASE3_CONFIGS = ("config5", "resident100k", "config3", "coloc-tensor")
# phase 18: bench.py's device lines.  Its CPU drives run in two processes,
# so that the load harness starts at once: the two short lines, and the
# load harness
BENCH_TWIN_GROUPS = (("admission", "pipelined"), ("load",))
# the profiled pipelined drive: the longest window of ticks it profiles; in
# its timeline, the names of the CUDA runtime's calls on the host, of a
# host-to-device copy on the device, and of a tick's record_function range
PROFILED_TICKS = 12
RUNTIME_PREFIX = "cu"
UPLOAD_EVENT = "Memcpy HtoD"
TICK_RANGE = "pipelined tick "

LAST_PHASE = 18


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def parse_through(argv) -> int:
    """The last phase to run: ``--through N`` (N = 1-`LAST_PHASE`) stops
    after phase N; no argument runs them all.  Anything else exits 2."""
    if not argv:
        return LAST_PHASE
    phases = tuple(str(n) for n in range(1, LAST_PHASE + 1))
    if len(argv) == 2 and argv[0] == "--through" and argv[1] in phases:
        return int(argv[1])
    print(f"usage: python3 chip_smoke.py [--through N]  (N = 1-{LAST_PHASE}: stop after "
          f"phase N)", file=sys.stderr, flush=True)
    raise SystemExit(2)


_PHASE_CLOCK: dict = {}


def phase_seconds(phase: int) -> None:
    """Prints the seconds since the previous phase ended (the script's
    start for phase 1)."""
    now = time.perf_counter()
    print(f"  phase {phase} took {now - _PHASE_CLOCK.get('last', now):.3f} s", flush=True)
    _PHASE_CLOCK["last"] = now


def phase_done(phase: int, through: int) -> None:
    """Prints the phase's seconds; ends a partial run after ``phase``:
    exit 3, no result line."""
    phase_seconds(phase)
    if phase >= through:
        print(f"chip_smoke: stopped after phase {phase} (partial run)",
              file=sys.stderr, flush=True)
        raise SystemExit(3)


def ptxas_resources(log: str):
    """``{kernel symbol: (registers, spill store bytes, spill load bytes)}``
    from an ``nvcc -Xptxas -v`` log."""
    import re

    out, current, spills = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            current = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            out[current] = (int(m.group(1)), *spills)
            current, spills = None, (0, 0)
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
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


def problems():
    from karpenter_tpu_torch import testing as T

    pools, inv, pods = T.heterogeneous_problem()
    pool, types, fpods = T.flagship_problem()
    return {
        "config2": (pools, inv, pods, []),
        "flagship": ([pool], {pool.name: types}, fpods, []),
        "config2_live": (pools, inv, pods, T.live_cluster(LIVE_NODES)),
        **{name: (pools, inv, pods, T.live_cluster(n)) for name, n in LARGE_LIVE.items()},
    }


def compiled(spec):
    from karpenter_tpu_torch.ops.tensorize import compile_problem

    pools, inv, pods, existing = spec
    return compile_problem(pods, pools, inv, existing=existing)


def max_abs_err(torch, got, want) -> float:
    """Largest absolute difference over paired outputs; a float output must
    also match bit for bit, or the error is reported as infinite."""
    err = 0.0
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            return float("inf")
        if a.dtype == torch.float32 and not torch.equal(
            a.view(torch.int32), b.view(torch.int32)
        ):
            return float("inf")
        if a.numel():
            err = max(err, (a.double() - b.double()).abs().max().item())
    return err


def scan_step_model(kernel: str, K: int):
    """``(block barriers, exposed dependent L2 loads)`` per class step of a
    scan kernel of ffd_pack.cu.

    ``ffd_scan_global``: one barrier after loading the class's req row,
    three per chunk of its block scan, three in each of its two block sums;
    it waits on the req row and on feas[g, cfg[k]] gathered through the
    slot's config (loads whose address or data the previous step decides
    and that no earlier step touched).

    ``ffd_scan`` (resident): one barrier, to exchange the warp totals (a
    second only where an int32 sum can wrap, which the bench problems never
    do).  Its feasibility rows arrive in shared memory ahead of the step;
    its class rows arrive a tile of ``SCAN_TILE`` classes at a time, whose
    load waits on two dependent L2 loads (c_star, then the alloc row), so
    2 / SCAN_TILE per step.

    ``ffd_scan_cluster``: the resident step with its one barrier a cluster
    barrier (the warp totals exchanged through the cluster's shared
    memory), and the same 2 / SCAN_TILE loads.

    ``ffd_scan_grid``: the cluster step, its one exchange the cluster's
    barrier and, past one cluster, the round trip between clusters through
    device memory (the caller passes the two together, as the grid probe
    measures them); each slot's feasibility byte is gathered a step ahead,
    so only the class tiles' 2 / SCAN_TILE loads wait."""
    from karpenter_tpu_torch.ops.fused_packer import SCAN_TILE, scan_threads

    if kernel == "ffd_scan_global":
        return 1 + 3 * -(-K // scan_threads(K)) + 3 + 3, 2
    if kernel in ("ffd_scan", "ffd_scan_cluster", "ffd_scan_grid"):
        return 1, 2 / SCAN_TILE
    raise ValueError(f"no step model for {kernel}")


def kernel_bounds(args, take, node_cfg):
    """Least milliseconds each kernel could take on this card for this
    run's inputs: max(bytes moved / HBM rate, operations / f32 rate).
    Every input the function needs is read once and every output written
    once; where the need depends on the data (which slots are open, which
    configs a class fits) only what this run's data needs is counted."""
    import numpy as np

    host = lambda t: t if isinstance(t, int) else t.cpu().numpy()
    (req, cnt, maxper, slot, feas, alloc, price, openable,
     used0, cfg0, npods0, _next0, sig0) = (host(a) for a in args)
    take, node_cfg = host(take), host(node_cfg)
    G, R = req.shape
    K = used0.shape[0]
    ru = (req > 0).sum(axis=1)  # axes each class requests

    # choose_config: every feasibility bit and openable/price entry decides
    # the argmin; the capacity (4 ops per requested axis: div, add, floor,
    # min) and the score (4: clamp, div, add, compare) only where the class
    # fits and the config can open; 2 ops per pair for the mask and argmin
    # select, 1 per config for the price ceiling
    fo = feas & openable[None, :]
    ops_choose = int((fo.sum(axis=1) * (4 * ru + 4)).sum()) + 2 * G * fo.shape[1] + fo.shape[1]
    bytes_choose = (
        feas.nbytes + openable.nbytes + price.nbytes + req.nbytes + maxper.nbytes
        + int(fo.any(axis=0).sum()) * R * 4  # alloc rows of fitting configs
        + 3 * G * 4  # c_star, new_ok, per
    )

    # ffd_scan: slot k is open at class g if it was filled before the scan
    # or first took pods at a class before g; a class reads feas and the
    # slot's alloc row only for open slots, once per distinct config, and
    # its signature counter only where it fits
    taken = take > 0
    first = np.where(taken.any(axis=0), taken.argmax(axis=0), G)
    opened_at = np.where(cfg0 >= 0, -1, first)
    open_ = np.arange(G)[:, None] > opened_at[None, :]  # [G, K]
    cfg_k = np.maximum(node_cfg, 0)
    fits = open_ & feas[:, cfg_k]
    feas_pairs = sum(len(np.unique(cfg_k[open_[g]])) for g in range(G))
    alloc_rows = len(np.unique(cfg_k[fits.any(axis=0)]))
    gi, ki = np.nonzero(fits)
    sig_pairs = len(np.unique(slot[gi].astype(np.int64) * K + ki))
    # per fitting slot: capacity (4 per requested axis) plus the signature
    # room, min, prefix and clip (5); per slot that takes pods: the usage
    # update (mul + add per requested axis) and the take, pod and
    # signature counts (3)
    ops_scan = int((fits * (4 * ru + 5)[:, None]).sum()
                   + (taken * (2 * ru + 3)[:, None]).sum())
    bytes_scan = (
        req.nbytes + cnt.nbytes + maxper.nbytes + slot.nbytes + 3 * G * 4
        + feas_pairs + alloc_rows * R * 4 + sig_pairs * 4
        + used0.nbytes + cfg0.nbytes + npods0.nbytes
        + take.nbytes + G * 4 + 2 * K * 4 + K * R * 4  # outputs
    )
    out = {}
    for name, b, o in (
        ("choose_config", bytes_choose, ops_choose),
        ("ffd_scan", bytes_scan, ops_scan),
    ):
        t_bytes, t_ops = b / HBM_BYTES_PER_S * 1e3, o / F32_OPS_PER_S * 1e3
        out[name] = {
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(b),
            "operations": int(o),
        }
    return out


def scan_latency_floor_ms(kernel: str, G: int, K: int, barrier_us: float,
                          l2_us: float) -> float:
    """A scan kernel's floor as a chain of dependent class steps: each step
    passes its barriers and waits on its dependent L2 loads in turn."""
    barriers, loads = scan_step_model(kernel, K)
    return G * (barriers * barrier_us + loads * l2_us) / 1e3


def _latency_lib():
    """csrc/latency_probe.cu, built and loaded, its C signatures declared."""
    import ctypes

    from karpenter_tpu_torch.ops import _build

    lib = _build.load("latency_probe")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.probe_barrier.argtypes, lib.probe_barrier.restype = [I, I, P, P], I
    lib.probe_chase.argtypes, lib.probe_chase.restype = [P, I, P, P], I
    lib.probe_cluster_barrier.argtypes = [I, I, I, P, P]
    lib.probe_cluster_barrier.restype = I
    lib.probe_grid_exchange.argtypes = [I, I, I, I, P, P, P]
    lib.probe_grid_exchange.restype = I
    lib.probe_empty_grid.argtypes = [I] * 5 + [P]
    lib.probe_empty_grid.restype = I
    return lib


def _per_step_us(torch, launch, n1: int, n2: int) -> float:
    """Microseconds a step of a probe ``launch(steps, stream)`` (a CUDA
    error code), from launches at ``n1`` and ``n2`` steps: the difference
    cancels the launch."""
    def launched(err):
        if err != 0:
            fail(f"latency probe launch failed with CUDA error {err}")

    stream = torch.cuda.current_stream().cuda_stream
    t = lambda n: cuda_ms(torch, lambda: launched(launch(n, stream)), iters=3, warmup=1)
    return (t(n2) - t(n1)) / (n2 - n1) * 1e3


def probe_latencies(torch, threads, clusters):
    """``({threads: barrier round trip}, {(ctas, threads): cluster barrier
    round trip}, dependent L2 load round trip)`` in microseconds: the
    barrier of one block at each thread count in ``threads``, the
    exchange and barrier of one cluster at each (size, threads) in
    ``clusters``; each from two launches of csrc/latency_probe.cu at
    different step counts (the difference cancels the launch)."""
    import numpy as np

    lib = _latency_lib()
    dev = torch.device("cuda")
    out = torch.empty(8 * 1024, dtype=torch.int32, device=dev)
    lines = L2_PROBE_BYTES // 128
    order = np.random.RandomState(0).permutation(lines)
    chain = np.zeros(lines * 32, np.int32)
    chain[order * 32] = np.roll(order, -1) * 32  # one cycle over every line
    chain = torch.from_numpy(chain).to(dev)
    barrier_us = {
        b: _per_step_us(
            torch, lambda n, st, b=b: lib.probe_barrier(b, n, out.data_ptr(), st), 20000, 220000)
        for b in threads
    }
    cluster_us = {
        (c, b): _per_step_us(
            torch, lambda n, st, c=c, b=b: lib.probe_cluster_barrier(c, b, n, out.data_ptr(), st),
            20000, 220000)
        for c, b in clusters
    }
    l2_us = _per_step_us(
        torch, lambda n, st: lib.probe_chase(chain.data_ptr(), n, out.data_ptr(), st),
        lines, 4 * lines)
    return barrier_us, cluster_us, l2_us


def probe_grid_exchange(torch, grids) -> dict:
    """``{(clusters, ctas, threads): round trip}`` in microseconds: the grid
    scan's class step past one cluster, the cluster probe's exchange and
    barrier followed by the round trip between that many co-resident
    clusters through device memory (a tagged entry each, published with
    st.release.gpu, read with ld.acquire.gpu), from two launches of
    csrc/latency_probe.cu at different step counts."""
    lib = _latency_lib()
    dev = torch.device("cuda")
    out = {}
    for q, c, b in grids:
        entries = torch.zeros(2 * q, dtype=torch.int64, device=dev)
        wide = torch.empty(q * c * b, dtype=torch.int32, device=dev)

        def launch(n, st, q=q, c=c, b=b, entries=entries, wide=wide):
            entries.zero_()  # no tag of the last launch matches
            return lib.probe_grid_exchange(q, c, b, n, entries.data_ptr(), wide.data_ptr(), st)

        out[(q, c, b)] = _per_step_us(torch, launch, 20000, 220000)
    return out


def pack_shapes(args):
    """``(K, R, S, C)`` of a pack's arguments, as `fused_packer.scan_kernel`
    takes them."""
    return args[8].shape[0], args[0].shape[1], args[12].shape[0], args[5].shape[0]


def other_cluster_sizes(K, R, S, C):
    """The cluster sizes other than the one the shape rule picks that hold
    these shapes."""
    from karpenter_tpu_torch.ops import fused_packer as F

    picked = (F.cluster_layout(K, R, S, C) or (None,))[0]
    return [n for n in F.CLUSTER_SIZES if n != picked and F.cluster_layout(K, R, S, C, n)]


def grid_wrap_cases(max_clusters: int) -> dict:
    """Phase 3's wrap cases on the grid scan: name -> (slots, at) of
    ``testing.wrap_arrays`` at each of `GRID_WRAP_SLOTS`, its prefilled
    slots straddling the first boundary between two CTAs of a cluster and,
    separately, the first boundary between two clusters (``at`` = the
    boundary - 2) of the grid `fused_packer.grid_layout` gives the shape."""
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.ops import fused_packer as F

    out = {}
    for k in GRID_WRAP_SLOTS:
        K, R, S, _ = pack_shapes(T.wrap_arrays(k))
        g = F.grid_layout(K, R, S, max_clusters)
        kp = g.per_thread * F.scan_threads(-(-K // (g.clusters * g.ctas)))  # a CTA's slots
        for where, b in (("a CTA boundary", kp), ("a cluster boundary", g.ctas * kp)):
            out[f"wrap k_slots={k} straddling slot {b} ({where})"] = (k, b - 2)
    return out


def layout_note(shapes, picked: str, max_clusters: int) -> str:
    """The cluster or grid layout of the scan phase 3 expects at these
    shapes, for its case line."""
    from karpenter_tpu_torch.ops import fused_packer as F

    K, R, S, C = shapes
    if picked == "ffd_scan_cluster":
        ctas, per_thread, smem = F.cluster_layout(K, R, S, C)
        return (f" (cluster of {ctas} CTAs, {per_thread} slots a thread, {smem} bytes of "
                f"shared memory each)")
    if picked == "ffd_scan_grid":
        g = F.grid_layout(K, R, S, max_clusters)
        return (f" (grid of {g.clusters} clusters of {g.ctas} CTAs, {g.per_thread} slots a "
                f"thread, {g.smem} bytes of shared memory each)")
    if picked == "ffd_scan":
        per_thread, smem = F.resident_layout(K, R, S, C)
        return f" (one block, {per_thread} slots a thread, {smem} bytes of shared memory)"
    return ""


SPIN_TRAP_SCRIPT = """
import sys
import torch
from karpenter_tpu_torch import testing as T
from karpenter_tpu_torch.ops import fused_packer as F, packer as P
K, batched = %d, %r
dev = torch.device("cuda")
if batched:
    (req, maxper, slot, feas, alloc, price, openable, used0, cfg0, npods0, next0, sig0,
     *_, cnt_b, rm_b, perm_b) = P.to_device(T.frontier_arrays("wrap", k_slots=K, batch=%d), dev)
    cnt, batch = cnt_b[0], (perm_b.shape[0], perm_b, cnt_b, rm_b)
else:
    (req, cnt, maxper, slot, feas, alloc, price, openable, used0, cfg0, npods0, next0,
     sig0) = P.to_device(T.wrap_arrays(K), dev)
    batch = None
chosen = F.choose_config(req, maxper, feas, alloc, price, openable)
args = (req, cnt, maxper, slot, feas, alloc, *chosen, used0, cfg0, npods0, next0, sig0)
shapes = (req.shape[0], alloc.shape[0], K, req.shape[1], sig0.shape[0])
layout = F.grid_layout(K, shapes[3], shapes[4], F.grid_clusters(0))
torch.cuda.synchronize()
try:
    F._launch_grid(args, shapes, layout, batch, spin_budget=1)
    torch.cuda.synchronize()
except RuntimeError as exc:
    print("raised: " + str(exc).splitlines()[0])
    sys.exit(0)
print("no error")
sys.exit(1)
"""


def spin_trap(card: str) -> None:
    """Phase 3's check that a lost entry ends the grid scan's launch: in a
    process of its own for each (the trap ends its CUDA context), the grid
    scan at `GRID_WRAP_SLOTS`' first count (two clusters an element) with a
    spin budget of one clock cycle, so a wait on the other cluster outlasts
    it, on ``wrap_arrays`` alone and with a what-if batch of `GRID_BATCH`
    elements over it (``frontier_arrays``' wrap case); each launch must
    fail and torch must raise at the next synchronize."""
    import pathlib

    for batched in (False, True):
        what = f"with a batch of {GRID_BATCH}" if batched else "alone"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", SPIN_TRAP_SCRIPT % (GRID_WRAP_SLOTS[0], batched, GRID_BATCH)],
            cwd=pathlib.Path(__file__).resolve().parent, capture_output=True, text=True,
            timeout=300)
        said = (proc.stdout.strip().splitlines() or [""])[-1]
        if proc.returncode != 0 or not said.startswith("raised: "):
            fail(f"ffd_scan_grid {what} with a spin budget of 1 cycle did not trap and raise "
                 f"(exit {proc.returncode}): {said} {proc.stderr[-2000:]}")
        print(f" ffd_scan_grid {what} with a spin budget of 1 cycle at {GRID_WRAP_SLOTS[0]} "
              f"slots: the launch trapped and torch {said} ({time.perf_counter() - t0:.3f} s, "
              f"{card})")


def compare_grid_batches(torch, max_clusters: int) -> dict:
    """Phase 3's grid scan with a batch axis, against the plain versions
    bit for bit, both objectives: `testing.frontier_arrays`' wrap case at
    `GRID_WRAP_SLOTS`' first count (two clusters an element), `GRID_BATCH`
    elements, its prefilled slots at 0 (the frontier-window scan first) and
    straddling each boundary of `grid_wrap_cases`, and `GRID_FRONTIER`
    (two elements leave the window for the grid); each through
    `ffd_scan_batch` (the launches `batch_launches` names) and through the
    grid on every element (`grid_runs`).  Then a fleet of two wrap tenants at
    the same slots (`compare_fleet`).  Returns the largest error of each
    kernel."""
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P

    dev = torch.device("cuda")
    k = GRID_WRAP_SLOTS[0]
    cases = {f"wrap k_slots={k}": dict(case="wrap", k_slots=k, batch=GRID_BATCH),
             **{name: dict(case="wrap", k_slots=k, batch=GRID_BATCH, at=at)
                for name, (kk, at) in grid_wrap_cases(max_clusters).items() if kk == k},
             f"frontier past k_slots={GRID_FRONTIER['k_slots']}": GRID_FRONTIER}
    errs = {}
    for name, shape in cases.items():
        a = P.to_device(T.frontier_arrays(**shape), dev)
        (req, maxper, slot, feas, alloc, price, openable, used0, cfg0, npods0, next0, sig0,
         *_, cnt_b, rm_b, perm_b) = a
        for objective in OBJECTIVES:
            chosen = F.choose_config(req, maxper, feas, alloc, price, openable, objective)
            scan_args = (req, maxper, slot, feas, alloc, *chosen, used0, cfg0, npods0, next0,
                         sig0, cnt_b, rm_b, perm_b)
            plan = F.batch_launches(next0, *batch_shapes(scan_args))
            if plan[-1] != "ffd_scan_grid_batched":
                fail(f"{name} batched: the plan is {plan}, not the grid's")
            outs, moved = launches_of(torch, lambda: F.ffd_scan_batch(*scan_args))
            if moved != dict.fromkeys(plan, 1):
                fail(f"{name} batched: launched {moved}, expected {plan}")
            want = P.ffd_scan_batch_reference(*scan_args)
            got = [("ffd_scan_batch", outs), ("grid", grid_runs(torch, scan_args)["grid"]())]
            torch.cuda.synchronize()
            e = {what: max_abs_err(torch, o, want) for what, o in got}
            front = T.element_frontiers(want[2].cpu().numpy(), next0)
            print(f"  {name} batched B={perm_b.shape[0]} Kp={used0.shape[0]} {objective}: "
                  f"launches {plan}, largest frontier {int(front.max())}, max_abs_err "
                  f"{json.dumps(e)}", flush=True)
            if any(e.values()):
                fail(f"{name} batched {objective}: the grid scan differs from its plain version")
            errs["ffd_scan_grid_batched"] = max(errs.get("ffd_scan_grid_batched", 0.0),
                                                *e.values())
    tenants = [P.to_device(T.fleet_tenant_arrays("wrap", FLEET_WRAP_SEED + i, k), dev)
               for i in range(2)]
    errs["ffd_scan_grid_fleet"] = compare_fleet(torch, f"wrap k_slots={k}", tenants,
                                                "ffd_scan_grid")
    return errs


def compare_kernels(torch, args, picked, extra):
    """Phase 3 on one problem's padded card tensors, both objectives:
    `choose_config` and the scan against the plain versions, the scan
    through `fused_packer.ffd_scan` (whose shape rule must pick
    ``picked``) and through each ``(label, wrapper, kernel)`` of ``extra``.
    Each scan call must launch the kernel expected of it.  Returns the
    largest error per kernel and the nodes objective's scan outputs."""
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P

    (req, cnt, maxper, slot, feas, alloc, price, openable,
     used0, cfg0, npods0, next0, sig0) = args
    K = used0.shape[0]
    if F.scan_kernel(*pack_shapes(args)) != picked:
        fail(f"the shape rule picks {F.scan_kernel(*pack_shapes(args))} at K={K}, "
             f"expected {picked}")
    scans = [(picked, F.ffd_scan, picked), *extra]
    errs, nodes_out = {}, None
    for objective in ("nodes", "cost"):
        chosen = F.choose_config(req, maxper, feas, alloc, price, openable, objective)
        torch.cuda.synchronize()
        plain = P.choose_config_reference(
            req, maxper, feas, alloc, price, openable, objective
        )
        want = P.ffd_scan_reference(req, cnt, maxper, slot, feas, alloc, *plain,
                                    used0, cfg0, npods0, next0, sig0)
        torch.cuda.synchronize()
        e1 = max_abs_err(torch, chosen, plain)
        errs["choose_config"] = max(errs.get("choose_config", 0.0), e1)
        for label, scan, expect in scans:
            before = dict(F.LAUNCHES)
            got = scan(req, cnt, maxper, slot, feas, alloc, *chosen,
                       used0, cfg0, npods0, next0, sig0)
            torch.cuda.synchronize()
            ran = [k for k in SCAN_KERNELS if F.LAUNCHES[k] != before[k]]
            if ran != [expect]:
                fail(f"{label} at K={K} launched {ran}, expected {expect}")
            e2 = max_abs_err(torch, got, want)
            print(f"  {objective}: choose_config max_abs_err={e1} {label} "
                  f"max_abs_err={e2} placed={int(got[0].sum())} "
                  f"leftover={int(got[1].sum())} nodes={int((got[2] >= 0).sum())}")
            if e1 != 0 or e2 != 0:
                fail(f"kernel disagrees with its plain version ({objective})")
            errs[expect] = max(errs.get(expect, 0.0), e2)
            if objective == "nodes" and nodes_out is None:
                nodes_out = got
    return errs, nodes_out


def compare_choose(torch, name, args):
    """Phase 3's choice cases: `choose_config` against the plain version on
    one case's card tensors, both objectives, bit for bit, each call
    launching the kernel once.  Returns the largest error."""
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P

    req, _, maxper, _, feas, alloc, price, openable = args[:8]
    choice = (req, maxper, feas, alloc, price, openable)
    err = 0.0
    for objective in ("nodes", "cost"):
        want = P.choose_config_reference(*choice, objective)
        before = dict(F.LAUNCHES)
        got = F.choose_config(*choice, objective)
        torch.cuda.synchronize()
        moved = {k: F.LAUNCHES[k] - before[k] for k in F.LAUNCHES if F.LAUNCHES[k] != before[k]}
        if moved != {"choose_config": 1}:
            fail(f"{name}: choose_config launched {moved}, expected choose_config once")
        e = max_abs_err(torch, got, want)
        err = max(err, e)
        if e != 0:
            fail(f"{name}: choose_config disagrees with its plain version ({objective}): "
                 f"max_abs_err={e}")
    print(f"  {name} Gp={req.shape[0]} Cp={alloc.shape[0]}: choose_config equals the plain "
          f"version (nodes and cost)")
    return err


def _device_us(ev) -> float:
    dev_us = getattr(ev, "self_device_time_total", None)
    return dev_us if dev_us is not None else getattr(ev, "self_cuda_time_total", 0.0)


def sleep_cycles_per_ms(torch) -> float:
    """Cycles of ``torch.cuda._sleep`` a device millisecond, measured once
    by CUDA events."""
    if "cycles" not in _SLEEP:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(SLEEP_PROBE_CYCLES)
        end.record()
        end.synchronize()
        _SLEEP["cycles"] = SLEEP_PROBE_CYCLES / start.elapsed_time(end)
    return _SLEEP["cycles"]


_SLEEP: dict = {}


def events_device_ms(torch, fn, iters: int, launches: int = 1) -> float:
    """Device milliseconds per launch of ``fn``'s kernel (``fn`` launching
    it ``launches`` times a call and nothing else), from CUDA events around
    ``iters`` calls.  A sleep kernel queued first keeps the stream busy
    while the host enqueues the events and the calls (twice the calls'
    measured host time, plus 1 ms), so the events time the launches back
    to back on the device, not the host's enqueue: the fallback where
    torch.profiler records no device time.  The device's gap between two
    launches is in it, so a kernel of a few microseconds reads higher
    than the profiler's duration of it (PERF.md §7)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * host_ms + 1) * sleep_cycles_per_ms(torch)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * launches)


def profiled_launches_ms(torch, fn, kernels, iters: int, fallback=None) -> dict:
    """Mean device milliseconds per launch of each kernel of ``kernels``
    over ``iters`` calls of ``fn``, from torch.profiler.  The profiler now
    and then records no device event over a whole window (PERF.md §7), so
    a window that misses a kernel is profiled again, `PROFILE_ATTEMPTS`
    windows at most; then ``fallback(missing)`` (CUDA events, where the
    caller has one) times the kernels still missing, or the run fails."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        out, missing = {}, []
        for kernel in kernels:
            total_us, count = 0.0, 0
            symbol = PROFILE_SYMBOL.get(kernel, f"{kernel}_kernel")
            for ev in events:
                if symbol in ev.key and _device_us(ev) > 0:
                    total_us += _device_us(ev)
                    count += ev.count
            if count:
                out[kernel] = total_us / count / 1e3
            else:
                missing.append(kernel)
        if not missing:
            return out
        print(f"  torch.profiler saw no device time of {', '.join(missing)} in window "
              f"{attempt} of {PROFILE_ATTEMPTS}", flush=True)
    if fallback is None:
        fail(f"torch.profiler saw no device time of {', '.join(missing)} in "
             f"{PROFILE_ATTEMPTS} windows")
    timed = fallback(missing)
    print(f"  {', '.join(missing)} timed by CUDA events instead: {json.dumps(timed)} ms a "
          "launch", flush=True)
    return {**out, **timed}


def profiled_ms(torch, fn, kernel: str, iters: int, fallback=None):
    """Mean device milliseconds per launch of ``kernel`` over ``iters``
    calls of ``fn``, from torch.profiler (``fallback`` as
    `profiled_launches_ms` takes it)."""
    return profiled_launches_ms(torch, fn, (kernel,), iters, fallback)[kernel]


def time_kernels(torch, args, scan_turns: bool = False):
    """Phase 4: per kernel at one problem's shapes (nodes objective), its
    device ms per launch (profiler), its CUDA-event ms per call over
    back-to-back calls (the wrapper's host enqueue included where it is
    slower than the kernel), its plain version's CUDA-event ms, and the
    profiler readings it was averaged from.  The scan is the one
    `fused_packer.scan_kernel` picks for the shapes; with ``scan_turns``
    the global scan is timed too, in turns with it (global, picked,
    picked, global), and where the picked scan is the cluster one, each
    other cluster size that holds the shapes between them (global,
    picked, others, others reversed, picked, global), each under the
    label ``ffd_scan_cluster ctas=N``."""
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P

    (req, cnt, maxper, slot, feas, alloc, price, openable,
     used0, cfg0, npods0, next0, sig0) = args
    chosen = F.choose_config(req, maxper, feas, alloc, price, openable)
    scan_args = (req, cnt, maxper, slot, feas, alloc, *chosen,
                 used0, cfg0, npods0, next0, sig0)
    choose = lambda: F.choose_config(req, maxper, feas, alloc, price, openable)
    shapes = pack_shapes(args)
    picked = F.scan_kernel(*shapes)
    # label -> (call, kernel symbol)
    scans = {picked: (lambda: F.ffd_scan(*scan_args), picked)}
    order = [picked]
    if scan_turns:
        if picked == "ffd_scan_global":
            fail("scan turns need the resident or cluster scan's shapes")
        scans["ffd_scan_global"] = (lambda: F.ffd_scan_global(*scan_args), "ffd_scan_global")
        others = []
        if picked == "ffd_scan_cluster":
            for n in other_cluster_sizes(*shapes):
                others.append(f"ffd_scan_cluster ctas={n}")
                scans[others[-1]] = (
                    lambda n=n: F.ffd_scan_cluster(*scan_args, ctas=n), "ffd_scan_cluster")
        order = ["ffd_scan_global", picked, *others, *others[::-1], picked, "ffd_scan_global"]
    readings = {k: [] for k in scans}
    for k in order:
        fn, symbol = scans[k]
        readings[k].append(profiled_ms(torch, fn, symbol, iters=50))
    plain_scan = cuda_ms(torch, lambda: P.ffd_scan_reference(*scan_args),
                         iters=1, warmup=1)
    choose_ms = profiled_ms(torch, choose, "choose_config", iters=200)
    out = {"choose_config": (
        choose_ms,
        cuda_ms(torch, choose, iters=200),
        cuda_ms(torch, lambda: P.choose_config_reference(
            req, maxper, feas, alloc, price, openable), iters=20),
        [choose_ms],
    )}
    for k, (fn, _) in scans.items():
        out[k] = (statistics.mean(readings[k]), cuda_ms(torch, fn, iters=50),
                  plain_scan, readings[k])
    return out


def canonical(result):
    """A result in canonical form (``testing.canonical_result``: per new
    node the pool, types, zones, capacity type and pods; the existing
    placements; the unschedulable pods)."""
    from karpenter_tpu_torch import testing as T

    return T.canonical_result(result)


def profile_solve(torch, solve, pods):
    """One more solve (``solve(pods)``) under torch.profiler: the launches
    the port's wrappers counted during it, the device time of each of the
    port's kernels and of all device work (kernels, copies and fills: the
    device-side events only, so no CPU op's attributed time counts twice),
    the device events that took the most of it, and the solve's wall time.
    Returns None where the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from karpenter_tpu_torch.ops import fused_packer as F

    before = dict(F.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve(pods)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = {k: 0.0 for k in KERNELS}
    device_events = []
    for ev in prof.key_averages():
        dev_us = _device_us(ev)
        if ev.device_type != DeviceType.CUDA or dev_us <= 0:
            continue
        device_events.append((dev_us, ev.key, ev.count))
        for k in per_kernel:
            if f"{k}_kernel" in ev.key:
                per_kernel[k] += dev_us
    busy_us = sum(us for us, _, _ in device_events)
    if busy_us <= 0:
        return None
    return {
        "wall_ms": wall_ms,
        "launches": {k: F.LAUNCHES[k] - before[k] for k in KERNELS},
        "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / 1e3 / wall_ms,
        "kernel_device_ms": {k: v / 1e3 for k, v in per_kernel.items()},
        "top_device_events": [
            {"name": name[:60], "count": n, "ms": us / 1e3}
            for us, name, n in sorted(device_events, reverse=True)[:6]
        ],
    }


def main_path_state(torch, spec):
    """The resident state a cold ``TorchScheduler.solve`` on the card seeds:
    its tensors are the pack arguments the main path gives the kernels."""
    from karpenter_tpu_torch.scheduling.solver import TorchScheduler

    pools, inv, pods, existing = spec
    sched = TorchScheduler(pools, inv, existing=existing, device="cuda")
    sched.solve(pods)
    torch.cuda.synchronize()
    if not sched.last_resident:
        fail("a cold solve on the card seeded no resident state")
    return sched._resident.states[-1]


def cold_solve(sched, pods):
    """A cold solve on a long-lived scheduler: its compile cache and
    resident states are dropped first (its catalog stays built)."""
    sched._compile_cache.clear()
    sched._resident.states.clear()
    return sched.solve(pods)


def churn(rng, pods, existing, n: int = DELTA_PODS):
    """One delta tick's input: ``n`` pods (``DELTA_PODS``) leave the batch
    and as many new pod objects, with the shapes of pods of the batch, join
    its end (as pods arrive in a pending queue) and, on a live cluster,
    ``DELTA_NODES`` nodes' usage grows by a bound pod."""
    import dataclasses

    from karpenter_tpu_torch.api import Pod, Resources

    gone = set(rng.sample(range(len(pods)), n))
    out = [p for i, p in enumerate(pods) if i not in gone]
    out += [dataclasses.replace(pods[rng.randrange(len(pods))], name="")
            for _ in range(n)]
    for sn in rng.sample(existing, min(DELTA_NODES, len(existing))):
        bp = Pod(requests=Resources(cpu=0.25, memory="256Mi"), node_name=sn.name,
                 phase="Running")
        sn.pods = sn.pods + [bp]
        sn.used = sn.used + bp.requests
    return out


MIRRORS = ("req", "cnt", "feas", "alloc", "price", "openable", "used0", "npods0")


def check_mirrors(torch, name, st) -> None:
    """The resident state's card tensors against its host mirrors, bit for
    bit, and its slot configs against the live node count."""
    import numpy as np

    for m in MIRRORS:
        d, h = host_of(getattr(st, f"d_{m}")), getattr(st, f"h_{m}")
        if d.dtype == np.float32:
            d, h = d.view(np.int32), h.view(np.int32)
        if d.shape != h.shape or not np.array_equal(d, h):
            fail(f"{name}: resident d_{m} differs from its host mirror")
    E = len(st.live)
    cfg0 = np.full(st.Kp, -1, np.int32)
    cfg0[:E] = np.arange(st.fe, st.fe + E)
    if not np.array_equal(host_of(st.d_cfg0), cfg0):
        fail(f"{name}: resident d_cfg0 is not the live slots' configs")


def host_of(t):
    """A resident buffer read back whole: a card tensor, or a buffer
    sharded over a mesh (``parallel/mesh.Sharded``)."""
    return t.host() if hasattr(t, "host") else t.cpu().numpy()


def placed_all(name, sched, result, n_pods) -> None:
    placed = sum(len(n.pods) for n in result.new_nodes) + len(result.existing_placements)
    if placed != n_pods or result.unschedulable:
        fail(f"{name}: placed {placed} of {n_pods} pods")
    if sched.last_kernel != "cuda_ffd" or sched.last_path != "tensor":
        fail(f"{name}: path {sched.last_path}/{sched.last_kernel}")


def cpu_equal(name, label, spec, pods, result, objective: str = "nodes") -> None:
    """The card's result against a cold CPU solve through the plain version
    of the same pods and live nodes."""
    from karpenter_tpu_torch.scheduling.solver import TorchScheduler

    pools, inv, _, existing = spec
    cpu = TorchScheduler(pools, inv, existing=existing, objective=objective,
                         device="cpu").solve(pods)
    if canonical(cpu) != canonical(result):
        fail(f"{name}: the card's {label} solve differs from the CPU plain solve")
    print(f"    {label}: equals the CPU plain-version cold solve ({len(cpu.new_nodes)} nodes)")


def solve_counts(name: str):
    """Phase 5's ``(warm-up, timed)`` solves of each kind at one problem:
    fewer past one thread-block cluster (`LARGE_LIVE`)."""
    return LARGE_SOLVES if name in LARGE_LIVE else (WARMUP_SOLVES, TIMED_SOLVES)


def drive_solves(torch, name, spec, rng):
    """Phase 5 on one problem: warm-up + timed solves (`solve_counts`) of
    each kind on one scheduler on the card, cold (compile cache and
    resident states dropped first), hit (the same pods again: a
    compile-cache hit that packs from the resident tensors) and delta
    (after each `churn`: the resident tensors absorb the diff).  Returns
    the scheduler, the last pods, and per kind the timed milliseconds and
    the last solve's phases."""
    from karpenter_tpu_torch.scheduling.solver import TorchScheduler

    pools, inv, pods, existing = spec
    sched = TorchScheduler(pools, inv, existing=existing, device="cuda")
    times = {kind: [] for kind in SOLVE_KINDS}
    phases = {}
    warmup, timed = solve_counts(name)
    for kind in SOLVE_KINDS:
        last = None
        for i in range(warmup + timed):
            if kind == "delta":
                pods = churn(rng, pods, existing)
            hits = sched.compile_cache_hits
            t0 = time.perf_counter()
            result = cold_solve(sched, pods) if kind == "cold" else sched.solve(pods)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if i >= warmup:
                times[kind].append(ms)
            placed_all(name, sched, result, len(pods))
            hit = sched.compile_cache_hits > hits
            if kind != "cold" and not sched.last_resident:
                fail(f"{name}: a {kind} solve did not pack from the resident tensors")
            if (kind == "hit") != hit:
                fail(f"{name}: a {kind} solve was {'' if hit else 'not '}a compile-cache hit")
            if kind == "delta":
                if sched.last_delta_rows <= 0:
                    fail(f"{name}: a delta tick scattered {sched.last_delta_rows} rows")
                check_mirrors(torch, name, sched._resident.states[-1])
            last = result
        phases[kind] = dict(sched.last_phases)
        if kind == "cold":
            cpu_equal(name, "last cold", spec, pods, last)
            cold = canonical(last)
        elif kind == "hit" and canonical(last) != cold:
            fail(f"{name}: a compile-cache hit decoded another result than the cold solve")
    cpu_equal(name, "last delta", spec, pods, last)
    print(f"    after each delta tick the resident card tensors equal their host mirrors; "
          f"last delta scattered {sched.last_delta_rows} rows")
    return sched, pods, times, phases


# ---------------------------------------------------------------------------
# Phase 6: the consolidation verdicts
# ---------------------------------------------------------------------------


def verdict_specs(device: str = "cuda", names=tuple(POPULATION)):
    """Phase 6's problems ``names``: name -> dict of pools, inventory,
    existing nodes, the candidate universe, the removal subsets, node
    prices, the population and the rounds.  The sweep's nodes come from a
    cold port solve on ``device``."""
    from karpenter_tpu_torch import testing as T

    def spec(pools, inv, existing, universe, subsets, name):
        node = {sn.name: sn for sn in existing}
        return dict(pools=pools, inventory=inv, existing=existing, universe=universe,
                    subsets=subsets, population=POPULATION[name],
                    prices=T.node_prices([node[c.node_name] for c in universe], inv))

    specs = {}
    if "sweep" in names:
        pools, inv, existing, cands = T.consolidation_sweep(SWEEP_PODS, device=device)
        specs["sweep"] = spec(pools, inv, existing, cands, [[c] for c in cands], "sweep")
    hpools, hinv, _ = T.heterogeneous_problem(scale=1 / T.N_PODS)
    std = next(it for it in hinv["general"] if it.name == "std1.large")
    for name, nodes in (("live", LIVE_NODES), ("live10k", LIVE10K_NODES)):
        if name not in names:
            continue
        existing, cands = T.consolidation_cluster(VERDICT_SEED, nodes, [std])
        universe = cands[:LIVE_UNIVERSE]
        drop_one = [[c for c in universe if c is not d] for d in universe]
        specs[name] = spec(hpools, hinv, existing, universe,
                           [[c] for c in universe] + drop_one, name)
    return specs


def key_masks(keys, width):
    import numpy as np

    m = np.zeros((len(keys), width), bool)
    for r, k in enumerate(keys):
        m[r, list(k)] = True
    return m


def drive_verdicts(sched, spec):
    """One consolidation pass on ``sched``: `evaluate_removals` on the
    problem's subsets, then a `SearchPlan` pass, each round through
    `evaluate_population`.  Returns the verdicts, each round's keys and
    verdicts, the plan's pick, and each call's wall ms and last phases."""
    from karpenter_tpu_torch.scheduling.popsearch import SearchPlan

    universe = spec["universe"]
    t0 = time.perf_counter()
    removals = sched.evaluate_removals(spec["subsets"], universe)
    calls = [("evaluate_removals", (time.perf_counter() - t0) * 1e3, dict(sched.last_phases))]
    plan = SearchPlan(len(universe), spec["prices"], [False] * len(universe),
                      spec["population"], SEARCH_ROUNDS, SEARCH_SEED)
    rounds = []
    while True:
        keys = plan.propose()
        if not keys:
            break
        t0 = time.perf_counter()
        got = sched.evaluate_population(key_masks(keys, len(universe)), universe)
        calls.append(("evaluate_population", (time.perf_counter() - t0) * 1e3,
                      dict(sched.last_phases)))
        plan.observe(keys, [(v.fits, v.replacement_price) for v in got])
        rounds.append((keys, got))
    return removals, rounds, plan.best(), calls


def verdict_twin(objective: str, _phases, conn) -> None:
    """The CPU drives of `VERDICT_TWINNED`'s problems for ``objective``, in
    a process of their own (`CpuTwins`) started as phase 6 begins, so that
    they run beside the card's drives: each sent back through ``conn`` as
    ``(name, (removals, rounds, best, seconds))``, or ``("error", text)``."""
    import traceback

    import torch

    from karpenter_tpu_torch.scheduling.solver import TorchScheduler

    torch.set_num_threads(CPU_TWIN_THREADS)
    try:
        specs = verdict_specs("cpu", VERDICT_TWINNED)
        for name, spec in specs.items():
            t0 = time.perf_counter()
            cpu = TorchScheduler(spec["pools"], spec["inventory"], existing=spec["existing"],
                                 device="cpu", objective=objective)
            conn.send((name, (*drive_verdicts(cpu, spec)[:3], time.perf_counter() - t0)))
    except Exception:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def verdict_inputs(torch, sched, spec):
    """The card tensors of one problem's verdict launches: the removal base,
    the removal batch ``(cnt_b, rm_b, perm_b)`` of its subsets, and the
    first population round's masks as the dispatch pads them."""
    from karpenter_tpu_torch.ops import packer as P
    from karpenter_tpu_torch.scheduling.popsearch import SearchPlan

    universe = spec["universe"]
    base = sched._removal_base(tuple(universe))
    if base.reason or base.empty or base.pop_reason:
        fail(f"the removal base refused the universe: {base.reason or base.pop_reason}")
    cnt, rm, perm, bad = sched._subset_batch(base, spec["subsets"])
    if bad:
        fail(f"{len(bad)} subsets outside the compiled universe")
    keys = SearchPlan(len(universe), spec["prices"], [False] * len(universe),
                      spec["population"], SEARCH_ROUNDS, SEARCH_SEED).propose()
    pp = P._bucket(len(keys), floor=sched.MIN_REMOVAL_BATCH)
    masks = key_masks(keys, base.cand_slot.shape[0])
    import numpy as np

    masks = np.concatenate([masks, np.zeros((pp - len(keys), masks.shape[1]), bool)])
    dev = torch.device("cuda")
    batch = P.to_device((cnt, rm, perm), dev)
    return base, batch, torch.from_numpy(masks).to(dev)


def window_report(torch, label, records, each: bool = False) -> dict:
    """The batched launch groups `fused_packer.WINDOW_RECORDS` took (read
    after a synchronize, off the main path): for each group its B, Gp, Kp,
    Cp, next0, W and plan, how many elements the frontier-window scan
    finished and how many the picked scan took after it, and the largest
    element frontier (`testing.element_frontiers` of its node_cfg).  Fails
    where the window's `done` mask is not the elements whose frontier stays
    within W (the main path's usages are sums of requests: clean and
    finite, so no tail moves).  ``each``: a line a group, else a line per
    distinct shape.  Returns the totals."""
    from karpenter_tpu_torch import testing as T

    torch.cuda.synchronize()
    lines, tot = {}, {"groups": 0, "elements": 0, "window": 0, "second": 0, "max_frontier": 0}
    for r in records:
        front = T.element_frontiers(r["node_cfg"].cpu().numpy(), r["next0"])
        if r["done"] is None:
            finished = 0
        else:
            done = r["done"].cpu().numpy()
            if (done != (front <= r["W"])).any():
                fail(f"{label}: the window's done mask {done.tolist()} is not the elements whose "
                     f"frontier {front.tolist()} stays within W {r['W']}")
            finished = int(done.sum())
        second = r["B"] - finished if r["plan"] != "window" else 0
        key = tuple(r[k] for k in ("B", "Gp", "Kp", "Cp", "next0", "W", "plan"))
        line = lines.setdefault(key if not each else (len(lines), *key), [0, 0, 0, 0])
        line[0] += 1
        line[1] += finished
        line[2] += second
        line[3] = max(line[3], int(front.max()))
        for k, v in (("groups", 1), ("elements", r["B"]), ("window", finished),
                     ("second", second)):
            tot[k] += v
        tot["max_frontier"] = max(tot["max_frontier"], int(front.max()))
    for key, (n, fin, sec, mf) in lines.items():
        B, Gp, Kp, Cp, next0, W, plan = key[-7:]
        print(f"  {label} batched launch{'es' if n > 1 else ''}: {n} x B={B} Gp={Gp} Kp={Kp} "
              f"Cp={Cp} next0={next0} W={W} plan={plan}: the window finished {fin}, the picked "
              f"scan took {sec}; largest element frontier {mf}")
    print(f"  {label} batched totals: {json.dumps(tot)}")
    return tot


def compare_verdict_kernels(torch, name, base, batch, masks, objective):
    """Phase 6's bit-equality on one problem's card tensors: the batched
    scan on the removal batch and on the population (the global scan too at
    `VERDICT_GLOBAL`, `grid_runs`), `population_prologue`, and
    `verdict_rows` on each batch, against their plain versions.  Returns
    the largest error per kernel, the population's inputs and scan outputs
    (for the times and bounds) and each batch's scan arguments."""
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P

    (req, _, maxper, slot, feas, alloc, price, openable,
     used0, cfg0, npods0, next0, sig0) = base.args
    chosen = F.choose_config(req, maxper, feas, alloc, price, openable, objective)
    pop = (base.cand_cnt, base.cand_slot, base.cand_occ, base.sort_rank, base.occ_span,
           masks, base.k_slots)
    got_pop = F.population_prologue(*pop)
    want_pop = P.population_prologue_reference(*pop)
    torch.cuda.synchronize()
    errs = {"population_prologue": max_abs_err(torch, got_pop, want_pop)}
    picked = F.scan_kernel(*pack_shapes(base.args))
    if picked != VERDICT_SCAN[name]:
        fail(f"{name}: the shape rule picks {picked}, expected {VERDICT_SCAN[name]}")
    shapes = (req.shape[0], alloc.shape[0], used0.shape[0], req.shape[1], sig0.shape[0])
    plan = F.batch_launches(next0, *pack_shapes(base.args))
    pop_outs, batches = None, {}
    for label, (cnt_b, rm_b, perm_b) in (("removal batch", batch), ("population", got_pop)):
        scan_args = (req, maxper, slot, feas, alloc, *chosen, used0, cfg0, npods0, next0,
                     sig0, cnt_b, rm_b, perm_b)
        outs, moved = launches_of(torch, lambda: F.ffd_scan_batch(*scan_args))
        if moved != dict.fromkeys(plan, 1):
            fail(f"{name} {label}: the batched scan launched {moved}, expected {plan}")
        want = P.ffd_scan_batch_reference(*scan_args)
        # the plan's launches, and the picked scan on every element
        scans = [(k, outs) for k in plan]
        scans.append((f"{picked}_batched", forced_scan(F, scan_args)()))
        if name in VERDICT_GLOBAL:
            scans.append(("ffd_scan_global_batched", grid_runs(torch, scan_args)["global"]()))
        torch.cuda.synchronize()
        for k, got in scans:
            errs[k] = max(errs.get(k, 0.0), max_abs_err(torch, got, want))
        tail = (perm_b, feas, alloc, price, openable, base.pool_id, base.zone_id, base.ct_id,
                base.compactable, next0)
        rows = F.verdict_rows(*outs, *tail)
        want_rows = P.verdict_rows_reference(*want, *tail)
        torch.cuda.synchronize()
        errs["verdict_rows"] = max(errs.get("verdict_rows", 0.0),
                                   max_abs_err(torch, [rows], [want_rows]))
        print(f"  {name} {objective} {label}: B={perm_b.shape[0]} Gp={req.shape[0]} "
              f"Kp={used0.shape[0]} Cp={alloc.shape[0]} R={req.shape[1]} launches {plan}: "
              + " ".join(f"{k} max_abs_err={v!r}" for k, v in sorted(errs.items())))
        if label == "population":
            pop_outs = (scan_args, outs, tail)
        batches[label] = scan_args
    if any(v != 0 for v in errs.values()):
        fail(f"{name} {objective}: a verdict kernel disagrees with its plain version: {errs}")
    return errs, pop, pop_outs, batches


def launches_of(torch, fn):
    """``fn()``'s result (after a synchronize) and the launches it made."""
    from karpenter_tpu_torch.ops import fused_packer as F

    before = dict(F.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: n - before[k] for k, n in F.LAUNCHES.items() if n != before[k]}


def batched_scan_bound(torch, scan_args, outs):
    """The batched scan's least time for this run's inputs: the base's
    inputs read once (feasibility and alloc rows only where a slot the
    element has open meets the class), each element's batch rows, every
    output written once; operations as `kernel_bounds` counts them, summed
    over the elements."""
    (req, maxper, slot, feas, alloc, c_star, new_ok, per, used0, cfg0, npods0, _next0,
     sig0, cnt_b, rm_b, perm_b) = scan_args
    take, leftover, node_cfg, node_pods, node_used = outs
    B, G, K = take.shape
    C = feas.shape[1]
    pl = perm_b.long()
    taken = take > 0
    gi = torch.arange(G, device=take.device)
    first = torch.where(taken.any(1), taken.int().argmax(1), G)  # [B, K]
    cfg_in = torch.where(rm_b, -1, cfg0[None, :])
    opened_at = torch.where(cfg_in >= 0, -1, first)
    open_ = gi[None, :, None] > opened_at[:, None, :]  # [B, G, K]
    cfg_k = node_cfg.clamp(min=0).long()
    fits = open_ & feas[pl].gather(2, cfg_k[:, None, :].expand(B, G, K))
    ru = (req > 0).sum(1)[pl]  # [B, G]
    ops = int((fits * (4 * ru + 5)[:, :, None]).sum()) + int((taken * (2 * ru + 3)[:, :, None]).sum())
    pairs = (pl[:, :, None] * C + cfg_k[:, None, :])[open_]
    feas_bytes = int(torch.unique(pairs).numel())
    alloc_rows = int(torch.unique(cfg_k[:, None, :].expand(B, G, K)[fits]).numel())
    sig_pairs = int(torch.unique((slot[pl].long()[:, :, None] * K
                                  + torch.arange(K, device=take.device))[fits]).numel())
    nb = lambda t: t.numel() * t.element_size()
    byts = (nb(req) + nb(maxper) + nb(slot) + 3 * G * 4 + feas_bytes + alloc_rows * alloc.shape[1] * 4
            + sig_pairs * 4 + nb(used0) + nb(cfg0) + nb(npods0) + nb(cnt_b) + nb(rm_b) + nb(perm_b)
            + sum(nb(t) for t in outs))
    return _bound(byts, ops)


def _bound(byts: int, ops: int) -> dict:
    t_bytes, t_ops = byts / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(byts), "operations": int(ops)}


def verdict_rows_bound(torch, outs, tail, rows):
    """`verdict_rows`' least time for this run's data.  Bytes: each element
    reads its leftovers, the pod counts of the slots past next0, the take
    column and usage row of each new slot and of k_star, its class order;
    the config arrays and the feasibility rows of the classes on new slots
    are read once.  Operations, as the data needs them: per element a test
    per window slot and a class test per new slot; per config the slack add
    of each axis; per (element, config) pair the openable test and the
    three key compares; where the config is openable with the element's
    c_star key, the fit compare of each axis, a feasibility test per class
    on k_star and the argmin's compare and select; where the element's row
    reads `hold` (new_count >= 2, at most one non-donor), per openable
    config the compare of each axis, a feasibility test per class on a new
    slot and the or.  ``parts`` splits the bytes and operations over the
    three launches: the per-element reads and the slot and class tests
    (`verdict_summary`), the config arrays, the feasibility rows and the
    per-config tests (`verdict_configs`), the rows (`verdict_write`)."""
    take, leftover, node_cfg, node_pods, node_used = outs
    (perm_b, feas, alloc, price, openable, pool_id, zone_id, ct_id, compactable, next0) = tail
    B, G, K = take.shape
    C, R = alloc.shape
    new = rows[:, 1].long()  # new slots per element
    n0 = int(next0)
    taken = take > 0
    newmask = (torch.arange(K, device=take.device) >= n0)[None, :] & (node_pods > 0)  # [B, K]
    on_any = (taken & newmask[:, None, :]).any(2)  # [B, G]
    feas_rows = int(torch.unique(perm_b.long()[on_any]).numel())
    k_star = newmask.to(torch.uint8).argmax(1)
    cs = node_cfg.gather(1, k_star[:, None])[:, 0].clamp(min=0).long()
    on_k = taken.gather(2, k_star[:, None, None].expand(B, G, 1))[:, :, 0].sum(1)  # [B]
    same = ((pool_id[None, :] == pool_id[cs][:, None]) & (zone_id[None, :] == zone_id[cs][:, None])
            & (ct_id[None, :] == ct_id[cs][:, None]) & openable[None, :])  # [B, C]
    bad = (taken & ~compactable[perm_b.long()][:, :, None]).any(1)  # [B, K]
    non_donors = (newmask & ((node_pods > 8) | bad)).sum(1)
    hold = (new >= 2) & (non_donors <= 1)
    argmin_ops = int((same.sum(1) * (R + on_k + 2)).sum())
    hold_ops = int((hold * (R + on_any.sum(1) + 1)).sum()) * int(openable.sum())
    summary = (B * G * 4 + B * (K - n0) * 4 + B * 4 + int((new + 1).sum()) * (G + R) * 4
               + B * G * 4 + G, B * (K - n0) + int(new.sum()) * G)
    configs = (feas_rows * C + C * (R * 4 + 4 + 1 + 12), C * R + 4 * B * C + argmin_ops + hold_ops)
    write = (B * 6 * 4, 0)
    parts = dict(zip(("verdict_summary", "verdict_configs", "verdict_write"),
                     (summary, configs, write)))
    out = _bound(sum(b for b, _ in parts.values()), sum(o for _, o in parts.values()))
    out["parts"] = {k: _bound(*v) for k, v in parts.items()}
    return out


def prologue_bound(pop, outs):
    """`population_prologue`'s least time: the masks and candidate tensors
    read once, the three outputs written once; per member and class a sum
    and a min over its selected candidates, and the rank's compares."""
    cand_cnt, cand_slot, cand_occ, sort_rank, _span, masks, k_slots = pop
    P, U = masks.shape
    G = sort_rank.shape[0]
    sel = int(masks.sum())
    nb = lambda t: t.numel() * t.element_size()
    byts = nb(masks) + nb(cand_cnt) + nb(cand_occ) + nb(cand_slot) + nb(sort_rank) + sum(nb(t) for t in outs)
    ops = sel * G * 2 + P * G * G + sel
    return _bound(byts, ops)


def batch_shapes(scan_args):
    """``(K, R, S, C)`` of `ffd_scan_batch`'s arguments, as `pack_shapes`."""
    return (scan_args[8].shape[0], scan_args[0].shape[1], scan_args[12].shape[0],
            scan_args[4].shape[0])


def forced_scan(F, scan_args):
    """A call of the scan `scan_kernel` picks at the shapes, with the batch
    axis, on every element of ``scan_args`` (no window scan before it)."""
    req, cnt_b, rm_b, perm_b = scan_args[0], *scan_args[13:]
    K, R, S, C = batch_shapes(scan_args)
    return lambda: F._launch_picked((req, cnt_b[0], *scan_args[1:13]), (req.shape[0], C, K, R, S),
                                    (perm_b.shape[0], perm_b, cnt_b, rm_b))


def grid_runs(torch, scan_args) -> dict:
    """The scans past one cluster on every element of ``scan_args`` (no
    window scan before them): ``"global"``, the global scan forced through
    `fused_packer._launch_global`, and where the grid holds the shapes
    ``"grid"``, its groups as the wrapper launches them."""
    from karpenter_tpu_torch.ops import fused_packer as F

    req, cnt_b, rm_b, perm_b = scan_args[0], *scan_args[13:]
    K, R, S, C = batch_shapes(scan_args)
    args, shapes = (req, cnt_b[0], *scan_args[1:13]), (req.shape[0], C, K, R, S)
    batch = (perm_b.shape[0], perm_b, cnt_b, rm_b)
    runs = {"global": lambda: F._launch_global(args, shapes, batch)}
    layout = F.grid_layout(K, R, S, F.grid_clusters(torch.cuda.current_device()))
    if layout is not None:
        runs["grid"] = lambda: F._launch_grid(args, shapes, layout, batch)
    return runs


def timed_in_turns(torch, runs: dict, iters: int) -> dict:
    """Mean ms a call of each of ``runs`` (CUDA events, ``iters`` calls a
    reading), read in turns: the first run, the others, the others again
    in reverse order, the first again; each the mean of its two
    readings."""
    names = list(runs)
    order = names + names[:0:-1] + names[:1]
    got = {k: [] for k in names}
    for k in order:
        got[k].append(cuda_ms(torch, runs[k], iters=iters, warmup=1))
    return {k: statistics.mean(v) for k, v in got.items()}


def time_verdict_kernels(torch, name, pop, pop_outs):
    """Device ms a launch (torch.profiler) of the batched scan the shapes
    pick (on every element: `forced_scan`) and, where the wrapper launches
    it, of the frontier-window scan (through `ffd_scan_batch`), each launch
    of `verdict_rows` and `population_pairs` on the population's tensors,
    beside their plain versions (CUDA events) and, beside the prologue,
    ``torch.argsort(stable=True)`` of the same keys' shape; where the
    global batched scan's row is measured, its ms a launch by CUDA
    events.  Returns those, the argsort's ms and `verdict_rows`' CUDA-event
    ms per back-to-back call of the wrapper (its three launches and their
    host enqueue); outside `VERDICT_ROWS_TIMED` the scans alone, and None
    for both."""
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P

    scan_args, outs, tail = pop_outs
    picked = VERDICT_SCAN[name]
    scan_plain = cuda_ms(torch, lambda: P.ffd_scan_batch_reference(*scan_args), iters=2, warmup=1)
    out = {f"{picked}_batched": (
        profiled_ms(torch, forced_scan(F, scan_args), picked, iters=20), scan_plain)}
    if "ffd_scan_window_batched" in F.batch_launches(scan_args[11], *batch_shapes(scan_args)):
        out["ffd_scan_window_batched"] = (profiled_ms(
            torch, lambda: F.ffd_scan_batch(*scan_args), "ffd_scan_window", iters=20), scan_plain)
    if name not in VERDICT_ROWS_TIMED:
        return out, None, None
    rows = lambda: F.verdict_rows(*outs, *tail)
    rows_ms = profiled_launches_ms(torch, rows, VERDICT_ROWS, iters=50)
    rows_plain = cuda_ms(torch, lambda: P.verdict_rows_reference(*outs, *tail), iters=2, warmup=1)
    out.update({k: (rows_ms[k], rows_plain) for k in VERDICT_ROWS})
    out["population_pairs"] = (
        profiled_ms(torch, lambda: F.population_prologue(*pop), "population_pairs", iters=50),
        cuda_ms(torch, lambda: P.population_prologue_reference(*pop), iters=5, warmup=1))
    rows_events = cuda_ms(torch, rows, iters=50)
    if ROW_PROBLEM["ffd_scan_global_batched"] == name:
        # CUDA events: the profiler records no device time for this
        # kernel's batched launches on the card (PERF.md §7)
        out["ffd_scan_global_batched"] = (
            cuda_ms(torch, grid_runs(torch, scan_args)["global"], iters=3, warmup=1),
            out[f"{picked}_batched"][1])
    keys = torch.randint(0, 2**30, (pop[5].shape[0], pop[3].shape[0]), dtype=torch.int32,
                         device="cuda")
    argsort_ms = cuda_ms(torch, lambda: torch.argsort(keys, dim=1, stable=True), iters=50)
    return out, argsort_ms, rows_events


def batched_floor_ms(torch, name, base, B, barrier_us, l2_us, kernel=None) -> float:
    """A batched scan's latency floor: class steps x (its barriers x
    ``barrier_us`` + its exposed dependent L2 loads, `scan_step_model`: 2 /
    SCAN_TILE but in the global scan) x ceil(B / elements the card runs at
    once).  ``kernel``: the scan the base's shapes pick (``None``), another
    scan, or ``"ffd_scan_window"``, whose step is the resident scan's (one
    block barrier, the same tiles of class rows)."""
    from karpenter_tpu_torch.ops import fused_packer as F

    K, R, S, C = pack_shapes(base.args)
    G = base.args[0].shape[0]
    kernel = kernel or F.scan_kernel(K, R, S, C)
    at_once = F.scan_concurrency(K, R, S, C, kernel)
    waves = -(-B // at_once)
    barriers, loads = scan_step_model("ffd_scan" if kernel == "ffd_scan_window" else kernel, K)
    ms = G * (barriers * barrier_us + loads * l2_us) * waves / 1e3
    print(f"  {name} {kernel}_batched latency floor: {G} steps x ({barriers} x {barrier_us!r} us "
          f"barrier + {loads} L2 x {l2_us!r} us) x {waves} waves ({B} elements, {at_once} at "
          f"once) = {ms!r} ms")
    return ms


def grid_turns(torch, name, base, batches, card, floors) -> dict:
    """The batched scans past one cluster on each of a problem's batches
    (at ``live10k`` the removal batch, B 128, and the population, B 512),
    timed in turns (`grid_runs`' global and grid scans, `timed_in_turns`), beside the batch's bound (`batched_scan_bound`: the
    take write alone is B x Gp x Kp x 4 bytes) and each scan's latency floor
    (`batched_floor_ms`: ``floors`` holds the grid's exchange, the global
    scan's block barrier and the L2 round trip, in us).  Returns each B's
    readings."""
    out = {}
    for label, scan_args in batches.items():
        B = scan_args[15].shape[0]
        runs = grid_runs(torch, scan_args)
        ms = timed_in_turns(torch, runs, GRID_TURN_ITERS)
        bound = batched_scan_bound(torch, scan_args, runs["grid"]())
        fl = {"grid": batched_floor_ms(torch, name, base, B, floors["grid"], floors["l2"],
                                       "ffd_scan_grid"),
              "global": batched_floor_ms(torch, name, base, B, floors["glob"], floors["l2"],
                                         "ffd_scan_global")}
        print(f"  {name} {label} B={B} in turns (global, grid, grid, global), "
              f"ms a launch (CUDA events): {json.dumps(ms)}; global / grid "
              f"{ms['global'] / ms['grid']!r}; bound {bound['bound_ms']!r} ms "
              f"({bound['bound_by']}, take alone {B * scan_args[0].shape[0] * scan_args[8].shape[0] * 4} "
              f"bytes); latency floors {json.dumps(fl)} ms ({card})", flush=True)
        out[str(B)] = dict(ms=ms, bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                           latency_floor_ms=fl)
    return out


def rows_in_groups(F, group: int, outs, tail):
    """`verdict_rows` with its config pass on element groups of ``group``
    (`fused_packer.verdict_group` replaced for the call)."""
    rule = F.verdict_group
    F.verdict_group = lambda *shape: group
    try:
        return F.verdict_rows(*outs, *tail)
    finally:
        F.verdict_group = rule


def compare_tie_cases(torch):
    """Phase 6's tie and edge cases, both objectives, kernels against their
    plain versions bit for bit: on each of `testing.VERDICT_TIE_CASES` the
    removal verdicts through the card (the choice, the batched scans
    `fused_packer.batch_launches` names, the three launches of
    `verdict_rows`, each once) and
    `verdict_rows` on the scan's outputs at next0, 0 and K (on the first
    case also on every element group); `population_prologue` on each of
    `testing.PROLOGUE_CASES` (one launch).  Returns the largest error per
    function."""
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P

    dev = torch.device("cuda")
    errs = {"verdict_rows": 0.0, "population_prologue": 0.0}
    first = next(iter(T.VERDICT_TIE_CASES))

    for name, shape in T.VERDICT_TIE_CASES.items():
        a = P.to_device(T.verdict_tie_arrays(*shape), dev)
        (req, maxper, slot, feas, alloc, price, openable, used0, cfg0, npods0, next0, sig0,
         pool_id, zone_id, ct_id, compactable, cnt_b, rm_b, perm_b) = a
        K, R = used0.shape
        scans = F.batch_launches(next0, K, R, sig0.shape[0], alloc.shape[0])
        scan = "+".join(scans)
        tail = (perm_b, feas, alloc, price, openable, pool_id, zone_id, ct_id, compactable)
        for objective in OBJECTIVES:
            got, moved = launches_of(torch, lambda: F.removal_verdicts(*a, objective=objective))
            if moved != {"choose_config": 1, **dict.fromkeys(scans, 1),
                         **{k: 1 for k in VERDICT_ROWS}}:
                fail(f"{name}: removal_verdicts launched {moved}")
            e = max_abs_err(torch, [got], [P.removal_verdicts_reference(*a, objective=objective)])
            chosen = F.choose_config(req, maxper, feas, alloc, price, openable, objective)
            outs = F.ffd_scan_batch(req, maxper, slot, feas, alloc, *chosen, used0, cfg0, npods0,
                                    next0, sig0, cnt_b, rm_b, perm_b)
            for n0 in sorted({next0, 0, K}):
                e = max(e, max_abs_err(torch, [F.verdict_rows(*outs, *tail, n0)],
                                       [P.verdict_rows_reference(*outs, *tail, n0)]))
            groups = F.verdict_groups(F.verdict_shape()[1]) if name == first else ()
            want = P.verdict_rows_reference(*outs, *tail, next0) if groups else None
            for group in groups:  # each element group of the config pass
                e = max(e, max_abs_err(torch, [rows_in_groups(F, group, outs, (*tail, next0))],
                                       [want]))
            smem = F.verdict_rows_in_smem(torch.cuda.current_device(), req.shape[0], R)
            print(f"  {name} {objective}: B={perm_b.shape[0]} Gp={req.shape[0]} Kp={K} "
                  f"Cp={alloc.shape[0]} R={R} next0={next0} ({scan}; config pass rows in "
                  f"{'shared' if smem else 'device'} memory): verdict_rows max_abs_err={e!r} "
                  f"(also at next0 0 and K{', groups ' + repr(groups) if groups else ''}); rows "
                  f"{int(torch.isinf(got[:, 3]).sum())} +inf, "
                  f"c_min {sorted(set(got[:, 2].int().tolist()))[:6]}...")
            if e != 0:
                fail(f"{name} {objective}: verdict_rows disagrees with its plain version")
            errs["verdict_rows"] = max(errs["verdict_rows"], e)
    for U, G, K, Pm in T.PROLOGUE_CASES:
        a = P.to_device(T.population_arrays(U, G, K, Pm), dev)
        got, moved = launches_of(torch, lambda: F.population_prologue(*a))
        if moved != {"population_pairs": 1}:
            fail(f"population_prologue at U {U} Gp {G} launched {moved}")
        e = max_abs_err(torch, got, P.population_prologue_reference(*a))
        errs["population_prologue"] = max(errs["population_prologue"], e)
        print(f"  population_prologue U={U} Gp={G} K={K} P={Pm}: max_abs_err={e!r}")
        if e != 0:
            fail(f"population_prologue disagrees with its plain version at U {U} Gp {G}")
    return errs


def compare_batch_limit(torch):
    """Phase 6's batch past one launch: `testing.verdict_tie_arrays` at Gp 8,
    Kp 64 and B = `fused_packer.MAX_BATCH` + 101 elements.  The batched scan
    (at Kp 64 the frontier-window scan alone) must launch twice, each launch
    writing its slice, and equal its plain version bit for bit, as must
    `verdict_rows` on its outputs.  Returns the largest error per
    function."""
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P

    B = F.MAX_BATCH + 101
    a = P.to_device(T.verdict_tie_arrays(8, 300, 64, B, 4), torch.device("cuda"))
    (req, maxper, slot, feas, alloc, price, openable, used0, cfg0, npods0, next0, sig0,
     pool_id, zone_id, ct_id, compactable, cnt_b, rm_b, perm_b) = a
    chosen = F.choose_config(req, maxper, feas, alloc, price, openable)
    scan_args = (req, maxper, slot, feas, alloc, *chosen, used0, cfg0, npods0, next0, sig0,
                 cnt_b, rm_b, perm_b)
    outs, moved = launches_of(torch, lambda: F.ffd_scan_batch(*scan_args))
    plan = F.batch_launches(next0, *batch_shapes(scan_args))
    if moved != dict.fromkeys(plan, 2):
        fail(f"the batched scan at B {B} launched {moved}, not {plan} twice")
    e_scan = max_abs_err(torch, outs, P.ffd_scan_batch_reference(*scan_args))
    tail = (perm_b, feas, alloc, price, openable, pool_id, zone_id, ct_id, compactable, next0)
    e_rows = max_abs_err(torch, [F.verdict_rows(*outs, *tail)],
                         [P.verdict_rows_reference(*outs, *tail)])
    print(f"  batch past one launch: B={B} Gp={req.shape[0]} Kp={used0.shape[0]} "
          f"(take {outs[0].numel() * 4} bytes), launches {moved}: "
          f"scan max_abs_err={e_scan!r}, verdict_rows max_abs_err={e_rows!r}")
    if e_scan != 0 or e_rows != 0:
        fail(f"the batched scan or verdict_rows at B {B} disagrees with its plain version")
    return {**dict.fromkeys(plan, e_scan), "verdict_rows": e_rows}


def compare_frontier_cases(torch):
    """Phase 6's frontier-window cases (`testing.frontier_arrays`), both
    objectives: `ffd_scan_batch` must make the launches `window_plan` says
    (the window alone, both, or the picked scan alone), its window's `done`
    mask must be `testing.window_finishes` (the elements whose frontier
    stays within W, where the tail does not move), and every output must
    equal the plain version bit for bit, as must the removal verdicts'
    rows.  The cases together must show all three plans and elements the
    picked scan took after they left the window.  Returns the largest error
    per function."""
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P

    dev = torch.device("cuda")
    errs = {"ffd_scan_window_batched": 0.0, "verdict_rows": 0.0}
    plans, left = set(), 0
    for case, (_, _, _, what) in T.FRONTIER_CASES.items():
        a = P.to_device(T.frontier_arrays(case), dev)
        (req, maxper, slot, feas, alloc, price, openable, used0, cfg0, npods0, next0, sig0,
         *_, cnt_b, rm_b, perm_b) = a
        K, R = used0.shape
        W = F.window_layout(K, R, sig0.shape[0], alloc.shape[0])[0]
        for objective in OBJECTIVES:
            chosen = F.choose_config(req, maxper, feas, alloc, price, openable, objective)
            scan_args = (req, maxper, slot, feas, alloc, *chosen, used0, cfg0, npods0, next0,
                         sig0, cnt_b, rm_b, perm_b)
            F.WINDOW_RECORDS = []
            try:
                outs, moved = launches_of(torch, lambda: F.ffd_scan_batch(*scan_args))
                (rec,) = F.WINDOW_RECORDS
            finally:
                F.WINDOW_RECORDS = None
            plan = F.batch_launches(next0, *batch_shapes(scan_args))
            if moved != dict.fromkeys(plan, 1):
                fail(f"frontier case {case}: the batched scan launched {moved}, expected {plan}")
            want = P.ffd_scan_batch_reference(*scan_args)
            e = max_abs_err(torch, outs, want)
            finishes = T.window_finishes(used0.cpu().numpy(), req.cpu().numpy(),
                                         want[2].cpu().numpy(), next0, W)
            done = rec["done"].cpu().numpy() if rec["done"] is not None else None
            if done is not None and (done != finishes).any():
                fail(f"frontier case {case}: the window's done mask {done.tolist()}, "
                     f"expected {finishes.astype(int).tolist()}")
            rows = F.removal_verdicts(*a, objective=objective)
            e_rows = max_abs_err(torch, [rows], [P.removal_verdicts_reference(
                *a, objective=objective)])
            front = T.element_frontiers(want[2].cpu().numpy(), next0)
            finished = 0 if done is None else int(done.sum())
            second = 0 if rec["plan"] == "window" else perm_b.shape[0] - finished
            print(f"  frontier case {case} ({what}) {objective}: B={perm_b.shape[0]} "
                  f"Gp={req.shape[0]} Kp={K} Cp={alloc.shape[0]} next0={next0} W={W} "
                  f"plan={rec['plan']} {plan}: the window finished {finished}, the picked scan "
                  f"took {second}; frontiers {front.min()}-{front.max()}; scan "
                  f"max_abs_err={e!r}, verdict rows max_abs_err={e_rows!r}")
            if e != 0 or e_rows != 0:
                fail(f"frontier case {case} {objective}: the batched scan or the verdict rows "
                     f"disagree with the plain version")
            plans.add(rec["plan"])
            if rec["plan"] == "both":
                left += second
            errs["ffd_scan_window_batched"] = max(errs["ffd_scan_window_batched"], e)
            errs["verdict_rows"] = max(errs["verdict_rows"], e_rows)
    if plans != {"pick", "window", "both"} or not left:
        fail(f"the frontier cases showed the plans {sorted(plans)} and {left} elements that "
             f"left the window")
    return errs


def hold_verdicts(name: str, objective: str, runs, want, card: str) -> None:
    """Phase 6: each of a problem's card drives ``runs`` against its CPU
    drive ``want``, with the verdicts' counts and (nodes objective) the
    calls' times printed."""
    for got in runs:
        if got[0] != want[0] or [r[0] for r in got[1]] != [r[0] for r in want[1]] \
                or [r[1] for r in got[1]] != [r[1] for r in want[1]] or got[2] != want[2]:
            fail(f"{name} {objective}: the card's verdicts differ from the CPU's")
    removals, rounds, best = runs[0][:3]
    verdicts = list(removals) + [v for _, vs in rounds for v in vs]
    print(f"  {name} {objective}: {len(verdicts)} verdicts equal the CPU's "
          f"({sum(v.fits for v in verdicts)} fit, "
          f"{sum(v.replacement_price > 0 for v in verdicts)} with a replacement, "
          f"needs_host {sum(v.needs_host for v in verdicts)}); plan best {best}")
    if objective == "nodes":
        for call in ("evaluate_removals", "evaluate_population"):
            ms = [c[1] for run in runs[1:] for c in run[3] if c[0] == call]
            last = [c[2] for c in runs[-1][3] if c[0] == call][-1]
            print(f"  {name} {call}: p50_ms={statistics.median(ms)!r} min_ms={min(ms)!r} "
                  f"max_ms={max(ms)!r} over {len(ms)} calls ({card}); last_phases_ms="
                  + json.dumps({k: v * 1e3 for k, v in sorted(last.items())}))


def verdict_phase(torch, card):
    """Phase 6 as the module docstring lists it.  Returns the kernels-line
    figures of its kernels."""
    import functools

    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.scheduling.solver import TorchScheduler

    specs = verdict_specs()
    for name, spec in specs.items():
        print(f"  {name}: {len(spec['existing'])} live nodes, universe {len(spec['universe'])}, "
              f"{len(spec['subsets'])} subsets, population {spec['population']}", flush=True)
    records = F.WINDOW_RECORDS = []
    F.reset_launches()
    card_runs, per_problem, per_records = {}, {}, {}
    try:
        for name, spec in specs.items():
            before, first, t0 = dict(F.LAUNCHES), len(records), time.perf_counter()
            for objective in OBJECTIVES:
                sched = TorchScheduler(spec["pools"], spec["inventory"],
                                       existing=spec["existing"], device="cuda",
                                       objective=objective)
                timed = TIMED_VERDICTS[name] if objective == "nodes" else 0
                runs = [drive_verdicts(sched, spec) for _ in range(1 + timed)]
                torch.cuda.synchronize()
                card_runs[(name, objective)] = (sched, runs)
            per_problem[name] = {k: F.LAUNCHES[k] - before[k] for k in VERDICT_KERNELS}
            per_records[name] = records[first:]
            print(f"  {name}: the card's drive took {time.perf_counter() - t0:.3f} s", flush=True)
    finally:
        F.WINDOW_RECORDS = None
    launches = dict(F.LAUNCHES)
    print(f"  launches over the drive: {{{', '.join(f'{k!r}: {launches[k]}' for k in VERDICT_KERNELS)}}}"
          f", per problem {per_problem}")
    batched = [k for k in VERDICT_KERNELS if k.startswith("ffd_scan")]
    for name, got in per_problem.items():
        base = card_runs[(name, "nodes")][0]._removal_base(tuple(specs[name]["universe"]))
        plan = F.batch_launches(base.args[11], *pack_shapes(base.args))
        for k in (*plan, *VERDICT_FUNCTION):
            if got[k] <= 0:
                fail(f"{name}: {k} launched no time in the drive")
        if any(got[k] for k in batched if k not in plan):
            fail(f"{name}: batched scans launched {got}, expected only {plan}")
        print(f"  {name}: the batched scans ran as {plan} (fused_packer.batch_launches)")
        window_report(torch, f"{name} drive", per_records[name])
    # the twinned problems' CPU drives, one process an objective, from here
    # on beside the rest of the phase (started after the timed card drives)
    twins = {o: CpuTwins((), target=functools.partial(verdict_twin, o)) for o in OBJECTIVES}
    try:
        return verdict_checks(torch, card, specs, card_runs, launches, twins)
    finally:
        for t in twins.values():
            t.close()


def verdict_checks(torch, card, specs, card_runs, launches, twins):
    """Phase 6 after the card's drives: each drive held to the CPU's (the
    `VERDICT_TWINNED` problems' last, from ``twins``, their processes by
    objective), each kernel to its plain version, then the times."""
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.scheduling.solver import TorchScheduler

    # the same calls through the plain versions on the CPU
    for (name, objective), (sched, runs) in card_runs.items():
        if name in VERDICT_TWINNED:
            continue
        spec = specs[name]
        t0 = time.perf_counter()
        cpu = TorchScheduler(spec["pools"], spec["inventory"], existing=spec["existing"],
                             device="cpu", objective=objective)
        want = drive_verdicts(cpu, spec)
        print(f"  {name} {objective}: the CPU's drive took {time.perf_counter() - t0:.3f} s",
              flush=True)
        hold_verdicts(name, objective, runs, want, card)
    # the kernels against their plain versions on the same card tensors
    errs, timing, turn_batches = {}, {}, {}
    for name, spec in specs.items():
        t0 = time.perf_counter()
        for objective in OBJECTIVES:
            sched = card_runs[(name, objective)][0]
            base, batch, masks = verdict_inputs(torch, sched, spec)
            e, pop, pop_outs, batches = compare_verdict_kernels(torch, name, base, batch, masks,
                                                                objective)
            for k, v in e.items():
                errs[k] = max(errs.get(k, 0.0), v)
            if objective == "nodes":
                timing[name] = (base, pop, pop_outs)
                turn_batches[name] = batches
        print(f"  {name}: the kernels against their plain versions took "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
    for k, v in (*compare_tie_cases(torch).items(), *compare_batch_limit(torch).items(),
                 *compare_frontier_cases(torch).items()):
        errs[k] = max(errs.get(k, 0.0), v)
    # times, bounds and floors
    threads = sorted({F.scan_threads(pack_shapes(t[0].args)[0]) for t in timing.values()}
                     | {F.WINDOW_THREADS})
    K, R, S, C = pack_shapes(timing["live"][0].args)
    ctas, _, _ = F.cluster_layout(K, R, S, C)
    K10, R10, S10, _ = pack_shapes(timing["live10k"][0].args)
    grid = F.grid_layout(K10, R10, S10, F.grid_clusters(torch.cuda.current_device()))
    grid_probe = (grid.ctas, F.scan_threads(-(-K10 // (grid.clusters * grid.ctas))))
    barrier_us, cluster_us, l2_us = probe_latencies(
        torch, threads, [(ctas, F.scan_threads(-(-K // ctas))), grid_probe])
    grid_us = (probe_grid_exchange(torch, [(grid.clusters, *grid_probe)])[(grid.clusters,
                                                                           *grid_probe)]
               if grid.clusters > 1 else cluster_us[grid_probe])
    figures = {}
    for name, (base, pop, pop_outs) in timing.items():
        t, argsort_ms, rows_events = time_verdict_kernels(torch, name, pop, pop_outs)
        scan_args, outs, tail = pop_outs
        b_scan = batched_scan_bound(torch, scan_args, outs)
        bounds = {f"{VERDICT_SCAN[name]}_batched": b_scan}
        if name in VERDICT_ROWS_TIMED:
            b_rows = verdict_rows_bound(torch, outs, tail, F.verdict_rows(*outs, *tail))
            bounds.update(b_rows["parts"], population_pairs=prologue_bound(pop, scan_args[13:16]))
        if ROW_PROBLEM["ffd_scan_global_batched"] == name:
            bounds["ffd_scan_global_batched"] = b_scan
        B = scan_args[15].shape[0]
        Kb = pack_shapes(base.args)[0]
        if VERDICT_SCAN[name] == "ffd_scan_cluster":
            b_us = cluster_us[(ctas, F.scan_threads(-(-Kb // ctas)))]
        elif VERDICT_SCAN[name] == "ffd_scan_grid":
            b_us = grid_us
        else:
            b_us = barrier_us[F.scan_threads(Kb)]
        floor = batched_floor_ms(torch, name, base, B, b_us, l2_us)
        turns = None
        if name in turn_batches and VERDICT_SCAN[name] == "ffd_scan_grid":
            turns = grid_turns(torch, name, base, turn_batches[name], card, floors=dict(
                grid=b_us, glob=barrier_us[F.scan_threads(Kb)], l2=l2_us))
        if "ffd_scan_window_batched" in t:
            bounds["ffd_scan_window_batched"] = b_scan
            batched_floor_ms(torch, name, base, B, barrier_us[F.WINDOW_THREADS], l2_us,
                             kernel="ffd_scan_window")
        for k, (dev_ms, plain_ms) in t.items():
            print(f"  {name} {k}: kernel {dev_ms!r} ms device (profiler), plain {plain_ms!r} ms "
                  f"(CUDA events), bound {bounds[k]} ({card})")
            if ROW_PROBLEM[k] == name:
                figures[k] = dict(ms=dev_ms, plain_ms=plain_ms, bound=bounds[k],
                                  floor=floor if k == f"{VERDICT_SCAN[name]}_batched" else None,
                                  argsort_ms=argsort_ms if k == "population_pairs" else None,
                                  turns=turns if k == "ffd_scan_grid_batched" else None)
        if name not in VERDICT_ROWS_TIMED:
            continue
        launch_sum = sum(t[k][0] for k in VERDICT_ROWS)
        group = F.verdict_group(B, tail[2].shape[0], F._sm_count(torch.cuda.current_device()),
                                *F.verdict_shape())
        print(f"  {name} verdict_rows (config pass on element groups of {group}): "
              f"{' + '.join(f'{k} {t[k][0]!r}' for k in VERDICT_ROWS)} = "
              f"{launch_sum!r} ms device (profiler); {rows_events!r} ms per back-to-back call of "
              f"the wrapper (CUDA events); bound {b_rows['bound_ms']!r} ms "
              f"({b_rows['bound_by']}) ({card})")
        print(f"  {name} torch.argsort(stable=True) of [{pop[5].shape[0]}, {pop[3].shape[0]}] "
              f"int32 keys: {argsort_ms!r} ms a call (CUDA events) beside population_pairs' "
              f"{t['population_pairs'][0]!r} ms")
    for f in ("ffd_scan_batched", "ffd_scan_cluster_batched", "ffd_scan_global_batched",
              "ffd_scan_window_batched", "ffd_scan_grid_batched", "verdict_rows",
              "population_prologue"):
        if f not in errs:
            fail(f"phase 6 never compared {f}")
    for (name, objective), (sched, runs) in card_runs.items():
        if name not in VERDICT_TWINNED:
            continue
        t0 = time.perf_counter()
        *want, took = twins[objective].get(name)
        print(f"  {name} {objective}: the CPU's drive took {took:.3f} s in its spawned process, "
              f"waited for {time.perf_counter() - t0:.3f} s", flush=True)
        hold_verdicts(name, objective, runs, want, card)
    # the window scan's row is measured at phase 9's base
    return {k: dict(figures.get(k, {}), launches=launches[k],
                    err=errs[VERDICT_FUNCTION.get(k, k)]) for k in VERDICT_KERNELS}



# ---------------------------------------------------------------------------
# Phase 7: the operator's provisioning loop
# ---------------------------------------------------------------------------


def operator_env(device: str, fastpath: bool = False, bypass: bool = False):
    """The port's operator environment over config 2's catalog, its
    ``general`` and tainted ``dedicated`` pools and a default NodeClass,
    the Provisioner's solver on ``device``.  The pools' consolidate_after
    outlasts the drive: the disruption controller runs every tick and
    takes no action.  Its drift feature gate is off: the drift check asks
    the cloud for every node's instance each tick, one batch window a
    node (phase 9 runs it).  Launches go one at a time in
    claim order (the simulator's determinism knob), so a card run and a
    CPU run hand out the same instance ids.  ``fastpath`` switches on the
    admission fast path, ``bypass`` the singleton bypass (a lone fresh pod
    goes to the batched solve at once instead of waiting out the batch
    window)."""
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.api import Disruption, Settings, reset_name_sequences
    from karpenter_tpu_torch.cloud.fake.catalog import generate_catalog

    reset_name_sequences()
    settings = Settings(cluster_name="chip-smoke", enable_admission_fastpath=fastpath,
                        provision_fastpath_bypass=bypass, enable_pipelined_reconcile=False,
                        feature_gate_drift=False)
    env = T.Environment(shapes=generate_catalog(**T.CONFIG2_CATALOG), settings=settings,
                        device=device)
    env.default_node_class()
    hold = lambda: Disruption(consolidate_after=HOLD_CONSOLIDATION_S)
    env.default_node_pool(name="general", disruption=hold())
    env.default_node_pool(name="dedicated", taints=[T.DEDICATED_TAINT], disruption=hold())
    env.operator.provisioner.launch_concurrency = 1
    return env


class GcTimer:
    """A ``gc.callbacks`` entry that sums the milliseconds of the garbage
    collector's passes."""

    def __init__(self):
        self.ms = 0.0
        self._t0 = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.ms += (time.perf_counter() - self._t0) * 1e3


class TailTimer:
    """Times an operator's diagnosis tail: ``Operator._observe_tick`` (the
    tick histogram, the observatory's export, the SLO rules, the anomaly
    scan, the flight record, a dump when one is due) and three of its
    parts, the SLO engine's ``evaluate``, the detector's ``scan`` and the
    flight recorder's ``record``, each wrapped on the operator's own
    objects.  ``ticks`` holds one ``{"tail", "slo", "detect", "flight"}``
    dict of ms a tick."""

    PARTS = (("slo", "slo", "evaluate"), ("detect", "detector", "scan"),
             ("flight", "flight", "record"))

    def __init__(self, operator):
        self.ticks = []
        self._cur = {}
        tail = operator._observe_tick

        def observe(dur_s):
            self._cur = {}
            t0 = time.perf_counter()
            try:
                tail(dur_s)
            finally:
                self._cur["tail"] = (time.perf_counter() - t0) * 1e3
                self.ticks.append(self._cur)

        operator._observe_tick = observe
        for label, attr, method in self.PARTS:
            owner = getattr(operator, attr)
            setattr(owner, method, self._timed(label, getattr(owner, method)))

    def _timed(self, label: str, fn):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self._cur[label] = (time.perf_counter() - t0) * 1e3

        return timed


def tick_summary(tick: int, kind: str, tick_s: float, controller_s: dict,
                 phases: dict, kernel: str, section: dict, detail: dict,
                 launches: dict, gc_ms: float = 0.0, tail_ms=None) -> dict:
    """One operator tick as phase 7 prints it: the operator's own tick time
    (``karpenter_reconcile_tick_duration_seconds``) and each controller's
    in ms, the solve's kind ("" where the tick solved nothing), its phases
    in ms and the kernel it ran, the kernel launches the tick counted, the
    garbage collector's ms in the step, the diagnosis tail's ms
    (`TailTimer`; empty where not timed), and the device observatory's
    tick section with its breakdown."""
    return {
        "tick": tick,
        "tick_ms": tick_s * 1e3,
        "gc_ms": gc_ms,
        "tail_ms": dict(tail_ms or {}),
        "controllers_ms": {k: v * 1e3 for k, v in controller_s.items()},
        "solve": kind,
        "kernel": kernel if kind else "",
        "phases_ms": {k: v * 1e3 for k, v in sorted(phases.items())} if kind else {},
        "launches": {k: v for k, v in launches.items() if v},
        "device": {**section, **detail},
    }


def operator_tick(env, tick: int, launches=None, gc_timer=None, tail=None) -> dict:
    """One ``env.step`` of fake clock, read back as its `tick_summary`.
    ``launches`` is the kernel wrappers' counter dict (None on the CPU),
    ``gc_timer`` a `GcTimer`, ``tail`` a `TailTimer` (None: not timed)."""
    from karpenter_tpu_torch.obs.device import OBSERVATORY
    from karpenter_tpu_torch.operator import solve_kind, solver_counters

    sched = env.operator.provisioner.scheduler
    before = solver_counters(sched)
    counted = dict(launches) if launches is not None else {}
    gc0 = gc_timer.ms if gc_timer is not None else 0.0
    env.step(TICK_S)
    kind = solve_kind(before, solver_counters(sched))
    reg = env.registry
    controller_s = {}
    for name in CONTROLLERS:
        samples = reg.histogram("karpenter_controller_reconcile_time_seconds",
                                {"controller": name})
        controller_s[name] = samples[-1] if samples else 0.0
    tick_s = reg.histogram("karpenter_reconcile_tick_duration_seconds")[-1]
    return tick_summary(
        tick, kind, tick_s, controller_s, sched.last_phases, sched.last_kernel,
        OBSERVATORY.tick_section(), OBSERVATORY.tick_detail(),
        {k: v - counted[k] for k, v in launches.items()} if launches is not None else {},
        gc_timer.ms - gc0 if gc_timer is not None else 0.0,
        tail.ticks[-1] if tail is not None else None,
    )


def churn_bound(env, rng, n: int) -> None:
    """Replace ``n`` bound pods (drawn from the bound pods in key order) by
    new pending pods of their shapes."""
    from karpenter_tpu_torch.api import Pod

    kube = env.kube
    bound = sorted(k for k, p in kube.pods.items() if p.node_name)
    for key in rng.sample(bound, n):
        old = kube.pods[key]
        kube.delete_pod(key)
        kube.put_pod(Pod(requests=old.requests, node_selector=dict(old.node_selector),
                         tolerations=list(old.tolerations)))


def drive_operator(device: str, n_pods: int = OPERATOR_PODS, rounds: int = CHURN_ROUNDS,
                   churn_pods: int = CHURN_PODS, launches=None, profile_last=None,
                   gc_timer=None):
    """Phase 7's drive on ``device``: config 2's first ``n_pods`` pods into
    the store, ticks until every pod is bound, then ``rounds`` churn rounds
    (an arrival tick, a solving tick, and up to two more while pods wait).
    ``profile_last(run_tick)`` wraps the last round's solving tick; each
    tick's diagnosis tail is timed (`TailTimer`).
    Returns (env, tick summaries, what ``profile_last`` returned)."""
    import random

    from karpenter_tpu_torch import testing as T

    env = operator_env(device)
    for p in T.heterogeneous_pods(n_pods):
        env.kube.put_pod(p)
    ticks = []
    tail = TailTimer(env.operator)

    def run_tick():
        ticks.append(operator_tick(env, len(ticks) + 1, launches, gc_timer, tail))

    for _ in range(MAX_BIND_TICKS):
        run_tick()
        if not env.kube.pending_pods():
            break
    if env.kube.pending_pods():
        fail(f"phase 7 ({device}): {len(env.kube.pending_pods())} of {n_pods} pods "
             f"unbound after {MAX_BIND_TICKS} ticks")
    rng = random.Random(CHURN_SEED)
    profiled = None
    for r in range(rounds):
        churn_bound(env, rng, churn_pods)
        run_tick()
        if profile_last is not None and r == rounds - 1:
            profiled = profile_last(run_tick)
        else:
            run_tick()
        for _ in range(2):
            if env.kube.pending_pods():
                run_tick()
        if env.kube.pending_pods():
            fail(f"phase 7 ({device}): churn round {r + 1} left "
                 f"{len(env.kube.pending_pods())} pods unbound")
    errors = env.registry.counters.get("karpenter_controller_reconcile_errors_total", {})
    if errors:
        fail(f"phase 7 ({device}): controller reconcile errors {dict(errors)}")
    return env, ticks, profiled


def tick_p50s(ticks) -> dict:
    """The p50 of the operator's tick ms by the kind of its solve ("none"
    where the tick solved nothing), with the tick count of each kind."""
    by_kind = {}
    for t in ticks:
        by_kind.setdefault(t["solve"] or "none", []).append(t["tick_ms"])
    return {k: {"p50_ms": statistics.median(v), "ticks": len(v)}
            for k, v in sorted(by_kind.items())}


def operator_phase(torch, card):
    """Phase 7 as the module docstring lists it.  Returns the launch counts
    of the card's drive and its tick p50s by solve kind."""
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.ops import fused_packer as F

    F.reset_launches()
    t0 = time.perf_counter()

    def profiled_tick(run_tick):
        torch.cuda.synchronize()
        return profile_solve(torch, lambda _: run_tick(), None)

    import gc

    gc_timer = GcTimer()
    gc.callbacks.append(gc_timer)
    try:
        env, ticks, profiled = drive_operator("cuda", launches=F.LAUNCHES,
                                              profile_last=profiled_tick, gc_timer=gc_timer)
    finally:
        gc.callbacks.remove(gc_timer)
    torch.cuda.synchronize()
    launches = dict(F.LAUNCHES)
    card_s = time.perf_counter() - t0
    sched = env.operator.provisioner.scheduler
    for t in ticks:
        print("  tick " + json.dumps(t), flush=True)
    solves = [t for t in ticks if t["solve"]]
    print(f"  {len(ticks)} ticks, {len(solves)} solves "
          f"({', '.join(t['solve'] for t in solves)}) in {card_s!r} s; "
          f"{len(env.kube.node_claims)} NodeClaims, {len(env.kube.nodes)} nodes, "
          f"{len(env.kube.pods)} pods bound; launches over the drive {launches}", flush=True)
    for t in solves:
        if t["kernel"] != "cuda_ffd":
            fail(f"phase 7: tick {t['tick']} solved with {t['kernel']!r}, not on the card")
        got = t["launches"]
        if got.get("choose_config", 0) < 1 or sum(got.get(k, 0) for k in SCAN_KERNELS) < 1:
            fail(f"phase 7: tick {t['tick']}'s solve launched {got}")
    if launches["choose_config"] < len(solves) or launches["ffd_scan_global"]:
        fail(f"phase 7: launches {launches} over {len(solves)} solves")
    if sched.last_resident:
        picked = F.scan_kernel(*pack_shapes(sched._resident.states[-1].pack_args()))
        if not solves[-1]["launches"].get(picked):
            fail(f"phase 7: the last solve did not launch {picked}, the scan its shapes pick")
        print(f"  the last solve ran {picked}, the scan its resident state's shapes pick")
    print(f"  tick p50 by solve kind ({card}): {json.dumps(tick_p50s(ticks))}")
    print(f"  diagnosis tail ms a tick ({card}): " + json.dumps({
        part: percentiles([t["tail_ms"][part] for t in ticks if part in t["tail_ms"]])
        for part in ("tail", "slo", "detect", "flight")}))
    print(f"  profiled churn solve tick (torch.profiler, {card}): "
          + (json.dumps(profiled) if profiled else "not measured: no device time seen"))
    print(f"  observatory totals: {json.dumps(observatory_totals())}", flush=True)
    t0 = time.perf_counter()
    cpu_env, cpu_ticks, _ = drive_operator("cpu")
    print(f"  the same drive on the CPU (plain version): {len(cpu_ticks)} ticks in "
          f"{time.perf_counter() - t0!r} s", flush=True)
    card_state, cpu_state = T.operator_state(env), T.operator_state(cpu_env)
    for key in card_state:
        if card_state[key] != cpu_state[key]:
            fail(f"phase 7: the card's {key} differ from the CPU operator's")
    if [t["solve"] for t in ticks] != [t["solve"] for t in cpu_ticks]:
        fail("phase 7: the card's solve kinds differ from the CPU operator's")
    print(f"  the card's NodeClaims, nodes, bindings, cloud calls, ledger "
          f"({sum(card_state['event_counts'].values())} events, the last "
          f"{len(card_state['events'])} compared one by one) and solver counters equal "
          f"the CPU operator's")
    return launches, tick_p50s(ticks)


# ---------------------------------------------------------------------------
# Phase 8: single-pod arrivals through the admission fast path
# ---------------------------------------------------------------------------


class AdmitTimer:
    """Wraps ``fastpath.try_admit`` for a drive: each attempt's outcome,
    reason, wall ms on the host clock (an attempt ends with its [K+2]
    fetch) and its phases (delta: the resident refresh; dispatch;
    device_block; oracle; decode; the rest is the eligibility checks)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from karpenter_tpu_torch.scheduling import fastpath
        from karpenter_tpu_torch.utils.trace import phase_collect

        self._mod, self._orig = fastpath, fastpath.try_admit

        def timed(scheduler, pods):
            sink = {}
            t0 = time.perf_counter()
            with phase_collect(sink):
                res = self._orig(scheduler, pods)
            self.calls.append({"outcome": res.outcome, "reason": res.reason,
                               "ms": (time.perf_counter() - t0) * 1e3,
                               "phases_ms": {k: v * 1e3 for k, v in sink.items()}})
            return res

        fastpath.try_admit = timed
        return self

    def __exit__(self, *exc):
        self._mod.try_admit = self._orig


def live_headroom_cpu(env) -> float:
    """The most vCPU any live node has free (allocatable less its bound
    pods' requests)."""
    used = {}
    for p in env.kube.pods.values():
        if p.node_name:
            used[p.node_name] = used.get(p.node_name, 0.0) + p.requests.cpu
    return max((n.allocatable.cpu - used.get(name, 0.0) for name, n in env.kube.nodes.items()),
               default=0.0)


def fastpath_counts(reg) -> dict:
    """The fast path's counters: outcomes, fallback reasons, mismatches."""
    read = lambda name: {dict(k).get("outcome", dict(k).get("reason", "")): v
                         for k, v in reg.counters.get(name, {}).items()}
    return {"outcome": read("karpenter_admission_fastpath_total"),
            "reason": read("karpenter_admission_fastpath_fallback_total"),
            "mismatch": sum(reg.counters.get("karpenter_admission_fastpath_mismatch_total",
                                             {}).values())}


def arrival_plan(pods, live_headroom, arrivals: int = ARRIVALS, bursts: int = BURSTS,
                 oversized: int = OVERSIZED):
    """Phase 8's arrivals, one entry a tick: ``(kind, pods)``.
    ``arrivals`` single pods of the shapes of pods drawn from ``pods``
    (seed `ARRIVAL_SEED`); after every `BURST_EVERY`-th single a burst of
    2-8 pods of one drawn shape and a quiet tick (a burst the batched path
    waits a window for is placed before the next arrives), ``bursts`` in
    all; after every `OVERSIZED_EVERY`-th single a pod of `OVERSIZED_CPU`
    vCPU or more, past every live node's headroom (``live_headroom()``
    reads it when the entry comes, and its entry is a callable that makes
    the pod), ``oversized`` in all; the ones left over go at the end."""
    import random

    from karpenter_tpu_torch.api import Pod, Resources

    def shaped(name, tpl):
        return Pod(name=name, requests=tpl.requests, node_selector=dict(tpl.node_selector),
                   tolerations=list(tpl.tolerations))

    def big(o):
        def make():
            cpu = max(OVERSIZED_CPU, float(int(live_headroom())) + 1.0)
            return [Pod(name=f"oversized-{o}", requests=Resources(cpu=cpu, memory="4Gi"))]
        return ("oversized", make)

    rng = random.Random(ARRIVAL_SEED)
    singles = [shaped(f"arrival-{i:03d}", rng.choice(pods)) for i in range(arrivals)]
    queued = []
    for b in range(bursts):
        tpl, n = rng.choice(pods), rng.randint(*BURST_SIZES)
        queued.append([shaped(f"burst-{b:02d}-{j}", tpl) for j in range(n)])
    plan, o = [], 0
    for i, pod in enumerate(singles):
        plan.append(("single", [pod]))
        if (i + 1) % BURST_EVERY == 0 and queued:
            plan += [("burst", queued.pop(0)), ("quiet", [])]
        if (i + 1) % OVERSIZED_EVERY == 0 and o < oversized:
            plan.append(big(o))
            o += 1
    for b in queued:
        plan += [("burst", b), ("quiet", [])]
    plan += [big(k) for k in range(o, oversized)]
    return plan


def drive_arrivals(device: str, fastpath: bool = True, n_pods: int = OPERATOR_PODS,
                   arrivals: int = ARRIVALS, bursts: int = BURSTS, oversized: int = OVERSIZED,
                   cut: int = 0, stop_at_cut: bool = False, launches=None, at_cut=None):
    """Phase 8's drive on ``device``: config 2's first ``n_pods`` pods into
    the store and ticks until every pod is bound (phase 7's start), then a
    seeded `HEADROOM_SHARE` of the bound pods deleted (numpy
    ``default_rng(HEADROOM_SEED)``, uniformly over pods, so that most
    arrivals fit a live node), then `arrival_plan`'s entries (``arrivals``
    singles, ``bursts`` bursts, ``oversized`` oversized pods), one a tick
    of `TICK_S` of fake clock, and up to three ticks while arrivals are
    pending.  ``at_cut(env)`` runs after the tick of entry ``cut``; with
    ``stop_at_cut`` the drive ends there, so that its state compares with
    a full drive's at that tick.  The singleton bypass is on, the fast
    path as ``fastpath`` says.  Every tick's line carries its arrival
    kind and the fast-path outcomes it counted.  Returns (env, tick
    summaries)."""
    import numpy as np

    from karpenter_tpu_torch import testing as T

    env = operator_env(device, fastpath=fastpath, bypass=True)
    pods = T.heterogeneous_pods(n_pods)
    for p in pods:
        env.kube.put_pod(p)
    ticks = []

    def run_tick(kind):
        before = fastpath_counts(env.registry)["outcome"]
        t = operator_tick(env, len(ticks) + 1, launches)
        after = fastpath_counts(env.registry)["outcome"]
        t["arrival"] = kind
        t["fastpath"] = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
        ticks.append(t)

    for _ in range(MAX_BIND_TICKS):
        run_tick("batch")
        if not env.kube.pending_pods():
            break
    if env.kube.pending_pods():
        fail(f"phase 8 ({device}): {len(env.kube.pending_pods())} pods unbound")
    bound = sorted(k for k, p in env.kube.pods.items() if p.node_name)
    rng = np.random.default_rng(HEADROOM_SEED)
    for i in sorted(rng.choice(len(bound), size=int(len(bound) * HEADROOM_SHARE),
                               replace=False)):
        env.kube.delete_pod(bound[i])
    plan = arrival_plan(pods, lambda: live_headroom_cpu(env), arrivals, bursts, oversized)
    for n, (kind, new) in enumerate(plan[:cut] if stop_at_cut else plan):
        for p in new() if callable(new) else new:
            env.kube.put_pod(p)
        run_tick(kind)
        if n + 1 == cut and at_cut is not None:
            at_cut(env)
    for _ in range(0 if stop_at_cut else 3):
        if env.kube.pending_pods():
            run_tick("settle")
    if env.kube.pending_pods() and not stop_at_cut:
        fail(f"phase 8 ({device}): {len(env.kube.pending_pods())} arrivals unbound")
    errors = env.registry.counters.get("karpenter_controller_reconcile_errors_total", {})
    if errors:
        fail(f"phase 8 ({device}): controller reconcile errors {dict(errors)}")
    return env, ticks


def percentiles(xs) -> dict:
    """p50 and p99 (nearest rank) of ``xs``, with the count."""
    if not xs:
        return {"n": 0}
    v = sorted(xs)
    return {"n": len(v), "p50": statistics.median(v),
            "p99": v[min(len(v) - 1, int(0.99 * len(v)))]}


def admit_args(args):
    """``admit_kernel``'s inputs from a pack's arguments: req, cnt, feas,
    alloc, openable, used0, cfg0."""
    return tuple(args[i] for i in (0, 1, 4, 5, 7, 8, 9))


def admit_bound(args, g: int) -> dict:
    """``admit_kernel``'s least time for class ``g`` on this run's data.
    The open-capacity bit is an any(): the configs up to and including the
    first that fits settle it (all of them when none fits).  Bytes: the
    class's req row and count, cfg0, its feasibility bytes at the live
    slots' configs and at those configs, openable where such a config's
    byte is set, the requested axes of alloc and used0 of each slot the
    class may use (a live slot with a feasible config), the requested axes
    of alloc of each such config it may open on, the [K+2] output.
    Operations: per such slot the capacity (sub, div, add, floor, min a
    requested axis) and the prefix and clip (3); per such config the
    capacity without the sub (4 a requested axis) and its test (1)."""
    import numpy as np

    from karpenter_tpu_torch.ops.packer import _per_node_cap

    req, cnt, feas, alloc, openable, used0, cfg0 = (t.cpu() for t in args)
    fits = (feas[g] & openable & (_per_node_cap(alloc, req[g]) > 0)).numpy()
    req, feas, openable, cfg0 = (t.numpy() for t in (req, feas, openable, cfg0))
    K = cfg0.shape[0]
    ru = int((req[g] > 0).sum())
    live = cfg0[cfg0 >= 0]
    slots = int(feas[g][live].sum())
    first = int(np.argmax(fits)) if fits.any() else fits.shape[0] - 1
    swept = np.arange(first + 1)
    configs = int((feas[g][swept] & openable[swept]).sum())
    feas_bytes = np.union1d(live, swept).size
    byts = (req.shape[1] * 4 + 4 + K * 4 + feas_bytes + int(feas[g][swept].sum())
            + slots * ru * 8 + configs * ru * 4 + (K + 2) * 4)
    ops = slots * (5 * ru + 3) + configs * (4 * ru + 1)
    return _bound(byts, ops)


def compare_admit(torch, name, args) -> float:
    """``admit`` against ``admit_reference`` for every class of ``args``
    (card tensors), bit for bit; one launch each.  Returns the largest
    error."""
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P

    err = 0.0
    G = args[0].shape[0]
    for g in range(G):
        before = F.LAUNCHES["admit_kernel"]
        got = F.admit(*args, g)
        torch.cuda.synchronize()
        if F.LAUNCHES["admit_kernel"] != before + 1:
            fail(f"{name}: admit for class {g} did not launch admit_kernel once")
        err = max(err, max_abs_err(torch, [got], [P.admit_reference(*args, g)]))
    print(f"  admit_kernel {name}: Gp={G} Kp={args[5].shape[0]} Cp={args[3].shape[0]} "
          f"R={args[0].shape[1]}: every class, max_abs_err={err!r}")
    if err != 0:
        fail(f"{name}: admit_kernel disagrees with admit_reference")
    return err


def time_admit(torch, name, args, g: int, card) -> dict:
    """``admit_kernel``'s device ms a launch (torch.profiler), a
    back-to-back wrapper call (CUDA events), the plain version's ms (CUDA
    events) and the bound, for class ``g``."""
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P

    call = lambda: F.admit(*args, g)
    out = {"ms": profiled_ms(torch, call, "admit", iters=ADMIT_ITERS),
           "call_ms": cuda_ms(torch, call, iters=ADMIT_ITERS),
           "plain_ms": cuda_ms(torch, lambda: P.admit_reference(*args, g), iters=20),
           "bound": admit_bound(args, g)}
    print(f"  admit_kernel {name} class {g}: kernel {out['ms']!r} ms device (profiler), "
          f"{out['call_ms']!r} ms a back-to-back call (CUDA events), plain {out['plain_ms']!r} ms "
          f"(CUDA events), bound {out['bound']} ({card})", flush=True)
    return out


def arrivals_phase(torch, card, live_args, twins):
    """Phase 8 as the module docstring lists it.  ``live_args``: phase 5's
    live cluster's pack arguments on the card; ``twins``: the `CpuTwins`
    that runs the CPU drive.  Returns the kernels-line figures of
    ``admit_kernel``."""
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P

    at_cut = {}

    def snapshot(env):
        at_cut["state"] = T.operator_state(env)
        at_cut["placed"] = placed(env)
        at_cut["outcomes"] = fastpath_outcomes(env.registry)

    F.reset_launches()
    t0 = time.perf_counter()
    with AdmitTimer() as timer:
        env, ticks = drive_arrivals("cuda", cut=ARRIVAL_CUT, launches=F.LAUNCHES,
                                    at_cut=snapshot)
    torch.cuda.synchronize()
    launches = dict(F.LAUNCHES)
    card_s = time.perf_counter() - t0
    counts = fastpath_counts(env.registry)
    print(f"  {len(ticks)} ticks in {card_s!r} s; fast path {json.dumps(counts)}; launches over "
          f"the drive {json.dumps({k: v for k, v in launches.items() if v})}", flush=True)
    for t in ticks:
        if t["arrival"] in ("batch", "oversized", "settle") or t["tick"] <= 4:
            print("  tick " + json.dumps(t))
    if counts["mismatch"] or counts["outcome"].get("mismatch"):
        fail(f"phase 8: the fast path counted a mismatch {counts}")
    singles = [t for t in ticks if t["arrival"] == "single"]
    nominated_singles = sum(1 for t in singles if t["fastpath"].get("nominated"))
    print(f"  single arrivals nominated by the fast path: {nominated_singles} of {len(singles)}")
    if 2 * nominated_singles < len(singles):
        fail(f"phase 8: the fast path nominated {nominated_singles} of {len(singles)} "
             f"single arrivals, fewer than half")
    dispatched = sum(1 for c in timer.calls if "dispatch" in c["phases_ms"])
    if launches["admit_kernel"] != dispatched or not dispatched:
        fail(f"phase 8: {launches['admit_kernel']} admit_kernel launches on the card for "
             f"{dispatched} scored attempts")
    st = env.operator.provisioner.scheduler._resident.states[-1]
    if st.d_req.device.type != "cuda":
        fail("phase 8: the resident state is not on the card")
    reg = env.registry
    latency = {path: percentiles(reg.histogram("karpenter_admission_latency_seconds",
                                               {"path": path})) for path in ("fast", "batch")}
    print(f"  karpenter_admission_latency_seconds by path (fake clock, pending to nominated): "
          f"{json.dumps(latency)}")
    nominated = [c for c in timer.calls if c["outcome"] == "nominated"]
    phases = sorted({k for c in nominated for k in c["phases_ms"]})
    print(f"  fast path attempts (host clock, ends with the [K+2] fetch, {card}): nominated "
          f"{json.dumps(percentiles([c['ms'] for c in nominated]))} ms; fallbacks "
          f"{json.dumps(percentiles([c['ms'] for c in timer.calls if c['outcome'] != 'nominated']))}"
          f" ms; phases p50 of the nominated "
          + json.dumps({k: statistics.median(c["phases_ms"].get(k, 0.0) for c in nominated)
                        for k in phases}))
    by_kind = {}
    for t in ticks:
        if t["arrival"] == "batch":
            continue
        kind = ("fast" if t["fastpath"].get("nominated") else t["solve"] or "none")
        by_kind.setdefault(f"{t['arrival']}:{kind}", []).append(t["tick_ms"])
    print(f"  tick ms by arrival and admission ({card}): "
          + json.dumps({k: percentiles(v) for k, v in sorted(by_kind.items())}), flush=True)

    # the CPU and fast-path-off drives run the plan's first ARRIVAL_CUT
    # entries: they must show every outcome and reason the card's full
    # drive shows, and equal the card's drive at that tick
    if not at_cut:
        fail(f"phase 8: the card's drive never reached entry {ARRIVAL_CUT}")
    full = fastpath_outcomes(env.registry)
    if not full <= at_cut["outcomes"]:
        fail(f"phase 8: the first {ARRIVAL_CUT} entries miss the outcomes "
             f"{sorted(full - at_cut['outcomes'])} of the card's drive")
    cpu = twins.get("arrivals")
    print(f"  the same drive on the CPU (plain version), cut to the first {ARRIVAL_CUT} "
          f"entries ({cpu['ticks']} ticks), in {cpu['seconds']!r} s (beside the card's drives, "
          f"in a process of its own)", flush=True)
    card_state, cpu_state = at_cut["state"], cpu["state"]
    for key in card_state:
        if card_state[key] != cpu_state[key]:
            fail(f"phase 8: the card's {key} differ from the CPU operator's at tick "
                 f"{cpu['ticks']}")
    if cpu["outcomes"] != at_cut["outcomes"]:
        fail("phase 8: the CPU drive's outcomes differ from the card's")
    print(f"  the card's state at tick {cpu['ticks']} equals the CPU drive's "
          f"({sum(card_state['event_counts'].values())} events; outcomes and reasons "
          f"{sorted(at_cut['outcomes'])}, every one of the full drive's; fast-path counters "
          f"{card_state['counters']['karpenter_admission_fastpath_total']})")
    t0 = time.perf_counter()
    off_env, off_ticks = drive_arrivals("cuda", fastpath=False, cut=ARRIVAL_CUT,
                                        stop_at_cut=True)
    if placed(off_env) != at_cut["placed"]:
        fail(f"phase 8: the placements at tick {len(off_ticks)} differ from the same drive "
             f"with the fast path off")
    off_kind = {}
    for t in off_ticks:
        if t["arrival"] != "batch":
            off_kind.setdefault(f"{t['arrival']}:{t['solve'] or 'none'}", []).append(t["tick_ms"])
    print(f"  the same drive on the card with the fast path off, cut to the first "
          f"{ARRIVAL_CUT} entries, in {time.perf_counter() - t0!r} s: every pod on the same "
          f"node; tick ms by arrival and solve ({card}): "
          + json.dumps({k: percentiles(v) for k, v in sorted(off_kind.items())}), flush=True)

    # the kernel: bit-equality and times at the main path's shapes
    state_args = admit_args(st.pack_args())
    live = admit_args(live_args)
    err = max(compare_admit(torch, "phase 8's resident state", state_args),
              compare_admit(torch, "the live cluster", live))
    for k in (256, 4096):
        err = max(err, compare_admit(torch, f"wrap k_slots={k}",
                                     admit_args(P.to_device(T.wrap_arrays(k), torch.device("cuda")))))
    for case in T.ADMIT_EDGE_CASES:
        err = max(err, compare_admit(torch, f"edge case {case}",
                                     P.to_device(T.admit_edge_arrays(case), torch.device("cuda"))))
    row = time_admit(torch, "phase 8's resident state", state_args, 0, card)
    live_row = time_admit(torch, "the live cluster", live, 0, card)
    floor = admit_floor(torch, state_args, row["ms"], card)
    admit_floor(torch, live, live_row["ms"], card)
    return dict(row, launches=launches["admit_kernel"], err=err, **floor)


def placed(env) -> dict:
    """Every pod's node (empty while pending)."""
    return {k: p.node_name for k, p in sorted(env.kube.pods.items())}


def fastpath_outcomes(reg) -> set:
    """The fast path's outcomes and fallback reasons a drive has shown."""
    counts = fastpath_counts(reg)
    return ({f"outcome:{k}" for k, v in counts["outcome"].items() if v}
            | {f"reason:{k}" for k, v in counts["reason"].items() if v})


def empty_launch_ms(torch, threads: int, iters: int) -> float:
    """Device ms of a launch of one block of ``threads`` threads that
    passes no barrier and stores one word a thread
    (``probe_barrier_kernel`` with 0 iterations, csrc/latency_probe.cu),
    from torch.profiler: what any one-block launch costs."""
    import ctypes

    from karpenter_tpu_torch.ops import _build

    lib = _build.load("latency_probe")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.probe_barrier.argtypes, lib.probe_barrier.restype = [I, I, P, P], I
    out = torch.empty(1024, dtype=torch.int32, device="cuda")

    def launch():
        if lib.probe_barrier(threads, 0, out.data_ptr(),
                             torch.cuda.current_stream().cuda_stream) != 0:
            fail("the empty probe launch failed")

    return profiled_ms(torch, launch, "probe_barrier", iters=iters)


def admit_loads(K: int, Cp: int, live_end: int) -> int:
    """``admit_kernel``'s dependent L2 load rounds at K slots and Cp
    configs whose live slots end at ``live_end``: `ADMIT_FIXED_LOADS`, and
    one for each further group of `ADMIT_SLOT_GROUP` slot rounds (a round
    is `fused_packer.admit_threads` slots) that holds a live slot."""
    from karpenter_tpu_torch.ops import fused_packer as F

    live_rounds = -(-live_end // F.admit_threads(K, Cp))
    return ADMIT_FIXED_LOADS + max(0, -(-live_rounds // ADMIT_SLOT_GROUP) - 1)


def admit_floor(torch, args, kernel_ms: float, card) -> dict:
    """``admit_kernel``'s latency floor at ``args``' shapes: an empty
    one-block launch at its thread count (`fused_packer.admit_threads`),
    plus its `ADMIT_BARRIERS` block barriers at that thread count and its
    `admit_loads` dependent L2 load rounds, each at the round trip
    csrc/latency_probe.cu measures here."""
    from karpenter_tpu_torch.ops import fused_packer as F

    K, C = args[5].shape[0], args[3].shape[0]
    threads = F.admit_threads(K, C)
    live = (args[6] >= 0).nonzero()
    live_end = int(live.max()) + 1 if live.numel() else 0
    loads = admit_loads(K, C, live_end)
    barrier_us, _, l2_us = probe_latencies(torch, [threads], [])
    empty = empty_launch_ms(torch, threads, ADMIT_ITERS)
    floor = empty + (ADMIT_BARRIERS * barrier_us[threads] + loads * l2_us) / 1e3
    print(f"  admit_kernel latency floor at Kp {K}, Cp {C} ({threads} threads, {card}): empty "
          f"one-block launch {empty!r} ms (profiler) + {ADMIT_BARRIERS} barriers x "
          f"{barrier_us[threads]!r} us + {loads} L2 loads x {l2_us!r} us = {floor!r} ms; "
          f"kernel / floor {kernel_ms / floor!r}, kernel / empty launch {kernel_ms / empty!r}",
          flush=True)
    return {"latency_floor_ms": floor, "empty_launch_ms": empty}


def cpu_twin_drives(phases, conn) -> None:
    """The CPU drives phases 8-10, 12 and 13 are held to, in a process of
    their own (`CpuTwins`): phase 8's drive cut to `ARRIVAL_CUT` entries,
    phase 9's drive, phase 10's scenarios, phase 12's failover drive and
    phase 13's fleet runs (`FLEET_CELLS`, then `SCALED_FLEET`), each sent
    back through ``conn`` as
    ``(name, readings)``, or ``("error", text)``."""
    import traceback

    import torch

    from karpenter_tpu_torch import testing as T

    torch.set_num_threads(CPU_TWIN_THREADS)
    try:
        if 8 in phases:
            t0 = time.perf_counter()
            env, ticks = drive_arrivals("cpu", cut=ARRIVAL_CUT, stop_at_cut=True)
            conn.send(("arrivals", {"state": T.operator_state(env), "ticks": len(ticks),
                                    "outcomes": fastpath_outcomes(env.registry),
                                    "seconds": time.perf_counter() - t0}))
        if 9 in phases:
            t0 = time.perf_counter()
            env, _before, ticks, events, _ = drive_consolidation("cpu")
            conn.send(("consolidation", {"state": T.operator_state(env), "ticks": len(ticks),
                                         "events": events,
                                         "seconds": time.perf_counter() - t0}))
            del env
        if 10 in phases:
            runs = {name: sim_run(name, seed, ticks, "cpu") for name, seed, ticks in SIM_CELLS}
            conn.send(("sim", runs))
        if 12 in phases:
            h = ha_harness("cpu")
            try:
                marks = ha_run(h)
                conn.send(("ha", dict(ha_readings(h), seconds=marks["seconds"])))
            finally:
                h.close()
        if 13 in phases:
            runs = {name: fleet_run(name, seed, ticks, operators, "cpu")
                    for name, seed, ticks, operators in FLEET_CELLS}
            conn.send(("fleet", runs))
            name, scenario, seed, ticks, operators = SCALED_FLEET
            conn.send(("fleet_scaled", fleet_run(scenario, seed, ticks, operators, "cpu",
                                                 n_pods=SCALED_FLEET_PODS)))
    except SystemExit as exc:
        conn.send(("error", f"exit {exc.code}"))
    except Exception:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


class CpuTwins:
    """`cpu_twin_drives` (or ``target``, with the same arguments) for
    ``phases`` in a spawned process, started at once so that it runs beside
    the card's drives; a thread receives each drive's readings as the
    process sends them (a send blocks while the pipe is full, so the process
    goes on to its next drive at once), `get` waits for one drive's
    readings, `close` ends the process."""

    def __init__(self, phases, target=None):
        import multiprocessing
        import threading

        ctx = multiprocessing.get_context("spawn")
        self._conn, child = ctx.Pipe(duplex=False)
        self._proc = ctx.Process(target=target or cpu_twin_drives,
                                 args=(tuple(phases), child), daemon=True)
        self._proc.start()
        child.close()
        self._got, self._arrived = {}, threading.Condition()
        threading.Thread(target=self._receive, daemon=True).start()

    def _receive(self) -> None:
        while True:
            try:
                key, value = self._conn.recv()
            except (EOFError, OSError):
                key, value = "ended", None
            with self._arrived:
                self._got[key] = value
                self._arrived.notify_all()
            if key in ("ended", "error"):
                return

    def get(self, name: str) -> dict:
        with self._arrived:
            while name not in self._got:
                if "error" in self._got:
                    fail(f"the spawned process failed: {self._got['error']}")
                if "ended" in self._got:
                    fail(f"the spawned process ended before sending {name}")
                self._arrived.wait()
            return self._got[name]

    def close(self) -> None:
        if self._proc.is_alive():
            self._proc.terminate()
        self._proc.join()


# ---------------------------------------------------------------------------
# Phase 9: consolidation through the operator
# ---------------------------------------------------------------------------


def live_fleet(env) -> dict:
    """The live NodeClaims (not marked for deletion): count and summed price."""
    live = [c for c in env.kube.node_claims.values() if c.deleted_at is None]
    return {"nodes": len(live), "price": sum(c.price for c in live)}


def counter_sum(reg, name: str) -> float:
    return sum(reg.counters.get(name, {}).values())


def counter_by(reg, name: str, label: str) -> dict:
    """A counter's values summed by one label."""
    out = {}
    for k, v in reg.counters.get(name, {}).items():
        key = dict(k).get(label, "")
        out[key] = out.get(key, 0.0) + v
    return out


def drive_consolidation(device: str, n_pods: int = OPERATOR_PODS, launches=None,
                        profile_tick=None, bases=None):
    """Phase 9's drive on ``device``: `testing.consolidating_cluster` (config
    2's first ``n_pods`` pods bound, a seeded half deleted, consolidate_after lowered
    to a few ticks; the default Settings, so the pipelined schedule is on),
    then ticks of `TICK_S` until the disruption controller takes no action
    for `CONSOLIDATION_QUIET` ticks in a row with no pod pending, or
    `CONSOLIDATION_TICKS` ticks.  ``profile_tick(run_tick)`` runs a tick
    under the profiler and returns what it saw; it is asked for each tick
    until a profiled tick consolidates, at most `PROFILED_TICKS` times.
    Each tick's line carries its disruption actions, its speculation
    outcomes and the ledger's ``NodeDisrupted`` / ``VerdictFallback``
    events.  Returns (env, the fleet before, tick summaries, the events in
    order, the profiled ticks).  ``bases``: a list that gets each removal
    base the disruption controller's scheduler builds, in order."""
    from karpenter_tpu_torch import testing as T

    env = T.consolidating_cluster(device, n_pods=n_pods)
    reg = env.registry
    before = live_fleet(env)
    ticks, events, profiled = [], [], []
    seen = [max((ev.seq for ev in env.operator.ledger.recent(limit=1 << 30)), default=0)]

    def run_tick():
        actions0 = counter_sum(reg, "karpenter_deprovisioning_actions")
        spec0 = counter_by(reg, "karpenter_pipeline_speculation_total", "outcome")
        t = operator_tick(env, len(ticks) + 1, launches)
        t["actions"] = counter_sum(reg, "karpenter_deprovisioning_actions") - actions0
        spec = counter_by(reg, "karpenter_pipeline_speculation_total", "outcome")
        t["speculation"] = {k: v - spec0.get(k, 0) for k, v in spec.items() if v != spec0.get(k, 0)}
        new = [ev for ev in env.operator.ledger.recent(limit=1 << 30) if ev.seq > seen[0]]
        if new:
            seen[0] = new[-1].seq
        mine = [(ev.ts, ev.type, sorted(ev.attrs.items())) for ev in new
                if ev.type in T.DISRUPTION_EVENTS]
        t["disrupted"] = sum(1 for e in mine if e[1] == "NodeDisrupted")
        t["fallbacks"] = sum(1 for e in mine if e[1] == "VerdictFallback")
        t["pending"] = len(env.kube.pending_pods())
        events.extend(mine)
        ticks.append(t)
        if bases is not None:
            for entry in env.operator.disruption._scheduler._removal_cache.values():
                if all(entry[0] is not b for b in bases):
                    bases.append(entry[0])

    quiet = 0
    for _ in range(CONSOLIDATION_TICKS):
        if (profile_tick is not None and len(profiled) < PROFILED_TICKS
                and not any(p["actions"] for p in profiled)):
            prof = profile_tick(run_tick) or {}
            profiled.append(dict(prof, tick=len(ticks), actions=ticks[-1]["actions"]))
        else:
            run_tick()
        quiet = 0 if ticks[-1]["actions"] else quiet + 1
        if quiet >= CONSOLIDATION_QUIET and not env.kube.pending_pods():
            break
    if env.kube.pending_pods():
        fail(f"phase 9 ({device}): {len(env.kube.pending_pods())} pods unbound after "
             f"{len(ticks)} ticks")
    errors = reg.counters.get("karpenter_controller_reconcile_errors_total", {})
    if errors:
        fail(f"phase 9 ({device}): controller reconcile errors {dict(errors)}")
    return env, before, ticks, events, profiled


def consolidation_base(torch, card, bases) -> dict:
    """Phase 9's base: of the removal bases the drive built, the one at the
    largest Kp (the last of them), with the first round of a `SearchPlan`
    pass over its universe (`BASE_POPULATION` members, the controller's
    objective "cost") as its batch, through `population_prologue` on the
    card.  Prints its launch group (`window_report`); holds
    `ffd_scan_batch` (the window scan and the picked scan after it) and the
    picked scan on every element (the parent's batched scan) to the plain
    version bit for bit; prints the batched scan's bound and both latency
    floors at these shapes; times the two in turns (parent, new, new,
    parent: profiler ms a launch of each kernel and CUDA-event ms a call).
    Returns the window scan's kernels-line figures."""
    import numpy as np

    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P
    from karpenter_tpu_torch.scheduling.popsearch import SearchPlan
    from karpenter_tpu_torch.scheduling.solver import TorchScheduler

    usable = [b for b in bases if b.args and not (b.reason or b.empty or b.pop_reason)]
    if not usable:
        fail("phase 9: the drive built no removal base with a population path")
    base = max(reversed(usable), key=lambda b: b.kp)
    (req, _, maxper, slot, feas, alloc, price, openable,
     used0, cfg0, npods0, next0, sig0) = base.args
    U = base.cand_slot.shape[0]
    keys = SearchPlan(U, [1.0] * U, [False] * U, BASE_POPULATION, SEARCH_ROUNDS,
                      BASE_SEED).propose()
    pp = P._bucket(len(keys), floor=TorchScheduler.MIN_REMOVAL_BATCH)
    masks = key_masks(keys, U)
    masks = np.concatenate([masks, np.zeros((pp - len(keys), U), bool)])
    pop = (base.cand_cnt, base.cand_slot, base.cand_occ, base.sort_rank, base.occ_span,
           torch.from_numpy(masks).to(used0.device), base.k_slots)
    cnt_b, rm_b, perm_b = F.population_prologue(*pop)
    chosen = F.choose_config(req, maxper, feas, alloc, price, openable, "cost")
    scan_args = (req, maxper, slot, feas, alloc, *chosen, used0, cfg0, npods0, next0, sig0,
                 cnt_b, rm_b, perm_b)
    shapes = K, R, S, C = batch_shapes(scan_args)
    B = perm_b.shape[0]
    plan = F.batch_launches(next0, *shapes)
    picked = F.scan_kernel(*shapes)
    print(f"  phase 9's base ({len(bases)} built; the last at the largest Kp): B={B} "
          f"Gp={req.shape[0]} Kp={K} Cp={C} R={R} S={S} next0={next0}, universe {U}; "
          f"launches {plan}", flush=True)
    F.WINDOW_RECORDS = []
    try:
        outs, moved = launches_of(torch, lambda: F.ffd_scan_batch(*scan_args))
        records = F.WINDOW_RECORDS
    finally:
        F.WINDOW_RECORDS = None
    if moved != dict.fromkeys(plan, 1):
        fail(f"phase 9's base: the batched scan launched {moved}, expected {plan}")
    window_report(torch, "phase 9's base", records, each=True)
    parent = forced_scan(F, scan_args)
    want = P.ffd_scan_batch_reference(*scan_args)
    err = max_abs_err(torch, outs, want)
    err_parent = max_abs_err(torch, parent(), want)
    print(f"  phase 9's base: ffd_scan_batch ({'+'.join(plan)}) max_abs_err={err!r}, "
          f"{picked}_batched on every element max_abs_err={err_parent!r}")
    if err != 0 or err_parent != 0:
        fail("phase 9's base: a batched scan disagrees with its plain version")
    bound = batched_scan_bound(torch, scan_args, outs)
    print(f"  phase 9's base batched scan bound: {bound} ({card})")
    clusters = []
    if picked == "ffd_scan_cluster":
        ctas = F.cluster_layout(*shapes)[0]
        clusters = [(ctas, F.scan_threads(-(-K // ctas)))]
    barrier_us, cluster_us, l2_us = probe_latencies(
        torch, sorted({F.WINDOW_THREADS, F.scan_threads(K)}), clusters)
    floor = batched_floor_ms(torch, "phase 9's base", base, B, barrier_us[F.WINDOW_THREADS],
                             l2_us, kernel="ffd_scan_window")
    batched_floor_ms(torch, "phase 9's base", base, B,
                     cluster_us[clusters[0]] if clusters else barrier_us[F.scan_threads(K)],
                     l2_us)
    # CUDA events around back-to-back calls, each side: the profiler records
    # no device time for the batched cluster scan at these shapes (PERF.md §7)
    args14 = (req, cnt_b[0], *scan_args[1:13])
    shapes5 = (req.shape[0], C, K, R, S)
    batch = (B, perm_b, cnt_b, rm_b)
    done = torch.empty(B, dtype=torch.int32, device=used0.device)
    scratch = F._scan_outputs(req.shape[0], K, R, used0.device, (B,))
    layout = F.window_layout(*shapes)
    sides = {
        "parent": parent,
        "window": lambda: F._launch_window(args14, shapes5, layout, batch, done, scratch),
        "after": lambda: F._launch_picked(args14, shapes5, (*batch, done), scratch),
        "call": lambda: F.ffd_scan_batch(*scan_args),
    }
    if plan[-1] == "ffd_scan_window_batched":
        del sides["after"]
    turns = {k: [] for k in sides}
    for side in ("parent", "new", "new", "parent"):
        for k in (("parent",) if side == "parent" else [k for k in sides if k != "parent"]):
            turns[k].append(cuda_ms(torch, sides[k], iters=BASE_ITERS, warmup=1))
        print(f"  phase 9's base in turns, {side}: ms a call (CUDA events) "
              f"{json.dumps({k: v[-1] for k, v in turns.items() if v})} ({card})", flush=True)
    mean = {k: statistics.mean(v) for k, v in turns.items()}
    print(f"  phase 9's base: the parent's {picked}_batched {mean['parent']!r} ms a launch; the "
          f"window scan {mean['window']!r} ms, the launch after it {mean.get('after')!r} ms "
          f"({int(done.sum())} of {B} elements done), ffd_scan_batch {mean['call']!r} ms a call; "
          f"parent / call {mean['parent'] / mean['call']!r}x; bound {bound['bound_ms']!r} ms, "
          f"window floor {floor!r} ms (CUDA events, {card})")
    window_ms = mean["window"]
    seen = profile_solve(torch, lambda _: parent(), None)
    print(f"  phase 9's base: torch.profiler over one call of the parent's "
          f"{picked}_batched saw " + (json.dumps(seen["top_device_events"]) if seen
                                      else "no device time"))
    plain_ms = cuda_ms(torch, lambda: P.ffd_scan_batch_reference(*scan_args), iters=1, warmup=1)
    return dict(ms=window_ms, plain_ms=plain_ms, bound=bound, floor=floor, err=err,
                argsort_ms=None)


def consolidation_phase(torch, card, twins):
    """Phase 9 as the module docstring lists it; ``twins``: the `CpuTwins`
    that runs the CPU drive.  Returns the launch counts of the card's drive
    and the window scan's figures at its base (`consolidation_base`)."""
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.ops import fused_packer as F

    def profiled_tick(run_tick):
        torch.cuda.synchronize()
        return profile_solve(torch, lambda _: run_tick(), None)

    F.reset_launches()
    bases, records = [], []
    F.WINDOW_RECORDS = records
    t0 = time.perf_counter()
    try:
        env, before, ticks, events, profiled = drive_consolidation(
            "cuda", launches=F.LAUNCHES, profile_tick=profiled_tick, bases=bases)
        torch.cuda.synchronize()
    finally:
        F.WINDOW_RECORDS = None
    launches = dict(F.LAUNCHES)
    card_s = time.perf_counter() - t0
    reg = env.registry
    after = live_fleet(env)
    for t in ticks:
        if t["actions"] or t["tick"] <= 3 or t["fallbacks"]:
            print("  tick " + json.dumps(t))
    actions = counter_by(reg, "karpenter_deprovisioning_actions", "mechanism")
    reasons = {}
    for _ts, kind, attrs in events:
        if kind == "NodeDisrupted":
            r = dict(attrs).get("reason", "")
            reasons[r] = reasons.get(r, 0) + 1
    evals = counter_by(reg, "karpenter_consolidation_evals_total", "path")
    spec = counter_by(reg, "karpenter_pipeline_speculation_total", "outcome")
    disruption_ms = [t["controllers_ms"]["disruption"] for t in ticks]
    acting = [t["tick_ms"] for t in ticks if t["actions"]]
    idle = [t["tick_ms"] for t in ticks if not t["actions"]]
    print(f"  {len(ticks)} ticks in {card_s!r} s ({card}; the 10,000-pod bind and the deletions "
          f"before them not counted, the tick lines above in ms on the same card); launches "
          f"over the drive "
          f"{json.dumps({k: v for k, v in launches.items() if v})}", flush=True)
    print(f"  nodes {before['nodes']} -> {after['nodes']}, summed node price "
          f"{before['price']!r} -> {after['price']!r} per hour")
    print(f"  actions by mechanism {json.dumps(actions)}; NodeDisrupted by reason "
          f"{json.dumps(reasons)}; VerdictFallback events "
          f"{sum(1 for e in events if e[1] == 'VerdictFallback')}")
    print(f"  karpenter_consolidation_evals_total by path {json.dumps(evals)}; search winners "
          f"{json.dumps(counter_by(reg, 'karpenter_consolidation_search_winners_total', 'action'))}")
    print(f"  disruption reconcile ms ({card}): {json.dumps(percentiles(disruption_ms))}; "
          f"tick ms of the ticks that consolidate {json.dumps(percentiles(acting))}, of those "
          f"that do not {json.dumps(percentiles(idle))}")
    print(f"  speculation outcomes (pipelined schedule): {json.dumps(spec)}")
    for p in profiled:
        print(f"  profiled tick {p['tick']} (torch.profiler, {card}, {p['actions']} actions): "
              + json.dumps({k: v for k, v in p.items() if k not in ("tick", "actions")}))
    if not any(p.get("actions") and p.get("device_busy_share") is not None for p in profiled):
        fail("phase 9: no profiled tick consolidated with device time seen")
    mismatch = counter_sum(reg, "karpenter_consolidation_verdict_mismatch_total")
    if not sum(actions.values()):
        fail("phase 9: the drive took no consolidation action")
    if mismatch:
        fail(f"phase 9: {mismatch} verdict mismatches")
    for k in CONSOLIDATION_KERNELS:
        if not launches[k]:
            fail(f"phase 9: {k} never launched through the operator")
    batched = {k: launches[k] for k in ("ffd_scan_batched", "ffd_scan_cluster_batched",
                                        "ffd_scan_window_batched")}
    if not batched["ffd_scan_window_batched"]:
        fail(f"phase 9: the frontier-window scan never launched through the operator {batched}")
    if launches["ffd_scan_global_batched"]:
        fail(f"phase 9: ffd_scan_global_batched launched {launches['ffd_scan_global_batched']} "
             f"times")
    window_report(torch, "phase 9", records, each=True)
    planned = {k: 0 for k in batched}
    for r in records:
        for k in F.batch_launches(r["next0"], r["Kp"], r["R"], r["S"], r["Cp"]):
            planned[k] = planned.get(k, 0) + 1
    if planned != batched:
        fail(f"phase 9: the batched launches {batched} are not those the launch groups' plans "
             f"make {planned}")
    cache = list(env.operator.disruption._scheduler._removal_cache.values())
    base = cache[-1] if cache else None
    if base is not None and base[0].args:
        picked = F.scan_kernel(*pack_shapes(base[0].args))
        print(f"  the last removal base (Kp {base[0].kp}, Gp {base[0].gp}) picks {picked}: the "
              f"batched launches over the drive {batched}")
    cpu = twins.get("consolidation")
    print(f"  the same drive on the CPU (plain versions): {cpu['ticks']} ticks in "
          f"{cpu['seconds']!r} s (beside the card's drives, in a process of its own)", flush=True)
    if cpu["ticks"] != len(ticks):
        fail(f"phase 9: the CPU drive ran {cpu['ticks']} ticks, the card's {len(ticks)}")
    if cpu["events"] != events:
        fail("phase 9: the ledger's NodeDisrupted / VerdictFallback events differ from the "
             "CPU drive's")
    card_state, cpu_state = T.operator_state(env), cpu["state"]
    for key in card_state:
        if card_state[key] != cpu_state[key]:
            fail(f"phase 9: the card's {key} differ from the CPU operator's")
    print(f"  the card's NodeClaims created and deleted, bindings, cloud calls, ledger "
          f"({len(events)} NodeDisrupted / VerdictFallback events in order) and solver and "
          f"disruption counters equal the CPU operator's")
    return launches, consolidation_base(torch, card, bases)


# ---------------------------------------------------------------------------
# Phase 10: the simulator on the card
# ---------------------------------------------------------------------------


def sim_run(name: str, seed: int, ticks: int, device: str, trace_path=None) -> dict:
    """One scenario through the simulator's ``run_scenario`` on ``device``
    with a ``TraceWriter`` (writing ``trace_path`` too, when given), read
    back: the trace text, the report, the wall seconds, the operator's tick
    ms (p50 / p99), the time to settle and its budget, the nodes and the
    summed price of the live NodeClaims at the end, the invariant
    violations, the fast path's nominations and mismatches, the
    consolidation verdict mismatches, and where the run's time went: each
    controller's reconcile ms and each solver phase's ms, summed over the
    run."""
    from karpenter_tpu_torch.sim.runner import run_scenario
    from karpenter_tpu_torch.sim.trace import TraceWriter

    writer = TraceWriter(trace_path)
    t0 = time.perf_counter()
    runner, report = run_scenario(name, seed, ticks, trace=writer, device=device)
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    env = runner.env
    reg = env.registry
    tick_ms = [v * 1e3 for v in reg.histogram("karpenter_reconcile_tick_duration_seconds")]
    return {
        "trace": writer.text(),
        "report": report,
        "wall_s": wall,
        "ticks": percentiles(tick_ms),
        "settle_s": report["fleet"]["time_to_settle_s"],
        "settle_budget_s": report["fleet"]["settle_budget_s"],
        "nodes": len(env.kube.nodes),
        "pods": runner.pods_created,
        "price_per_hour": live_fleet(env)["price"],
        "violations": report["invariants"]["violations"],
        "nominated": reg.counter("karpenter_admission_fastpath_total", {"outcome": "nominated"}),
        "fastpath_mismatch": counter_sum(reg, "karpenter_admission_fastpath_mismatch_total"),
        "verdict_mismatch": counter_sum(reg, "karpenter_consolidation_verdict_mismatch_total"),
        "controllers_ms": histogram_ms(reg, "karpenter_controller_reconcile_time_seconds",
                                       "controller"),
        "solver_phases_ms": histogram_ms(reg, "karpenter_solver_phase_seconds", "phase"),
    }


def histogram_ms(reg, name: str, label: str) -> dict:
    """A histogram family's summed samples in ms, by one label."""
    out = {}
    for k, h in reg.histograms.get(name, {}).items():
        key = dict(k).get(label, "")
        out[key] = out.get(key, 0.0) + h.total * 1e3
    return dict(sorted(out.items()))


def sim_line(run: dict) -> str:
    """A `sim_run`'s figures as phase 10 prints them (no trace, no report)."""
    return json.dumps({k: v for k, v in run.items() if k not in ("trace", "report")})


def sim_checks(name: str, run: dict) -> None:
    """What phase 10 holds each scenario's card run to, apart from the CPU
    trace and the launches."""
    if run["violations"]:
        fail(f"phase 10: {name}: invariant violations {run['violations'][:5]}")
    if run["verdict_mismatch"]:
        fail(f"phase 10: {name}: {run['verdict_mismatch']} verdict mismatches")
    if run["fastpath_mismatch"]:
        fail(f"phase 10: {name}: {run['fastpath_mismatch']} fast-path mismatches")
    if name == "single-pod-trickle" and not run["nominated"]:
        fail("phase 10: single-pod-trickle: the fast path nominated no pod")
    if name in ANCHOR_NODES:
        budget = run["settle_budget_s"]
        if budget is None or not 0.0 <= run["settle_s"] <= budget:
            fail(f"phase 10: {name}: settled at +{run['settle_s']} s (budget {budget} s)")
        if run["nodes"] != ANCHOR_NODES[name]:
            fail(f"phase 10: {name}: {run['nodes']} nodes at the end, not "
                 f"{ANCHOR_NODES[name]}")


def sim_phase(torch, card, twins) -> dict:
    """Phase 10 as the module docstring lists it; ``twins``: the `CpuTwins`
    that runs the CPU side.  Returns the launches summed over the
    scenarios."""
    import os
    import tempfile

    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.sim.runner import replay
    from karpenter_tpu_torch.sim.trace import TraceWriter

    total = {k: 0 for k in KERNELS}
    card_runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, seed, ticks in SIM_CELLS:
            path = os.path.join(tmp, f"{name}.jsonl")
            F.reset_launches()
            run = sim_run(name, seed, ticks, "cuda", trace_path=path)
            launches = {k: v for k, v in F.LAUNCHES.items() if v}
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            card_runs[name] = run
            print(f"  {name} (seed {seed}, {ticks} ticks) on the card ({card}): "
                  f"{sim_line(run)}", flush=True)
            print(f"    launches {json.dumps(launches)}", flush=True)
            sim_checks(name, run)
        F.reset_launches()
        writer = TraceWriter()
        t0 = time.perf_counter()
        _runner, replayed, recorded = replay(os.path.join(tmp, f"{SIM_REPLAYED}.jsonl"),
                                             trace=writer, device="cuda")
        torch.cuda.synchronize()
        original = card_runs[SIM_REPLAYED]
        print(f"  {SIM_REPLAYED} replayed on the card in {time.perf_counter() - t0!r} s, "
              f"launches {json.dumps({k: v for k, v in F.LAUNCHES.items() if v})}", flush=True)
        if recorded != original["report"] or replayed != original["report"]:
            fail(f"phase 10: the replay of {SIM_REPLAYED} did not reproduce its report")
        if writer.text() != original["trace"]:
            fail(f"phase 10: the replay of {SIM_REPLAYED} did not reproduce its trace bytes")
        print(f"  the replay reproduced the report and the trace, byte for byte "
              f"({len(writer.text())} bytes)")
    print(f"  launches over the phase's scenarios: "
          f"{json.dumps({k: v for k, v in total.items() if v})}", flush=True)
    for k in SIM_KERNELS:
        if not total.get(k):
            fail(f"phase 10: {k} never launched through the simulator")
    if not sum(total.get(k, 0) for k in SCAN_KERNELS):
        fail("phase 10: no solve scan launched through the simulator")
    cpu = twins.get("sim")
    for name, _seed, _ticks in SIM_CELLS:
        run = cpu[name]
        print(f"  {name} on the CPU (plain versions, beside the card's drives): "
              f"{sim_line(run)}", flush=True)
        if run["trace"] != card_runs[name]["trace"]:
            card_lines, cpu_lines = card_runs[name]["trace"].splitlines(), run["trace"].splitlines()
            at = next((i for i, (a, b) in enumerate(zip(card_lines, cpu_lines)) if a != b),
                      min(len(card_lines), len(cpu_lines)))
            fail(f"phase 10: {name}: the card's trace differs from the CPU's at line {at}")
    print(f"  every card trace equals its CPU trace byte for byte "
          f"({sum(len(r['trace']) for r in card_runs.values())} bytes over "
          f"{len(SIM_CELLS)} scenarios)")
    return total


# ---------------------------------------------------------------------------
# Phase 11: the multi-tenant solver service
# ---------------------------------------------------------------------------


def bench_tenants(n: int = SERVICE_TENANTS, pods: int = SERVICE_PODS) -> dict:
    """``bench.py:run_solver_service``'s tenants at full scale: tenant i
    (``t-00`` ...) has ``pods`` pods of 0.25 (i + 1) vCPU and 1 GiB on
    `testing.Environment`'s default pool and catalog, compiled."""
    from karpenter_tpu_torch.api import Pod, Resources
    from karpenter_tpu_torch.ops.tensorize import compile_problem
    from karpenter_tpu_torch.testing import Environment

    env = Environment(device="cpu")  # its catalog only: nothing solves here
    pool = env.default_node_pool()
    env.default_node_class()
    types = env.instance_types.list(pool, env.kube.get_node_class("default"))
    return {
        f"t-{i:02d}": compile_problem(
            [Pod(requests=Resources(cpu=0.25 * (i + 1), memory="1Gi")) for _ in range(pods)],
            [pool], {pool.name: types})
        for i in range(n)
    }


def config2_tenants(n: int = SERVICE_TENANTS, share: float = SERVICE_SHARE,
                    seed: int = SERVICE_SEED, scale: float = 1.0) -> dict:
    """Config 2 as a fleet: tenant i is a seeded ``share`` of config 2's
    pods (``numpy.random.default_rng(seed + i)``), with config 2's two pools
    and catalog, compiled."""
    import numpy as np

    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.ops.tensorize import compile_problem

    pools, inv, pods = T.heterogeneous_problem(scale)
    out = {}
    for i in range(n):
        rng = np.random.default_rng(seed + i)
        idx = np.sort(rng.choice(len(pods), int(share * len(pods)), replace=False))
        out[f"t-{i:02d}"] = compile_problem([pods[j] for j in idx], pools, inv)
    return out


def one_group(name: str, probs: dict) -> tuple:
    """The one solve group (``service.server.solve_group_key``) every
    tenant of a cell lands in, or a failure: a cell whose tenants do not
    stack into one fleet pack would quietly measure solo solves."""
    from karpenter_tpu_torch.ops.packer import pad_problem
    from karpenter_tpu_torch.service.server import solve_group_key

    keys = set()
    for prob in probs.values():
        args, kp = pad_problem(prob)
        keys.add(solve_group_key(args, kp, "nodes"))
    if len(keys) != 1:
        fail(f"{name}: the tenants fall into {len(keys)} solve groups, not one: "
             f"{sorted(keys)}")
    return next(iter(keys))


def tenant_args(torch, probs: dict, dev) -> list:
    """Each tenant's padded pack arguments on ``dev``, in tenant order."""
    from karpenter_tpu_torch.ops import packer as P

    return [P.to_device(P.pad_problem(prob)[0], dev) for prob in probs.values()]


def live_tenants(torch, prob, n: int, dev) -> list:
    """``n`` tenants of config 2 on its live nodes (2,000: Kp 4096; 10,000
    and 20,000: Kp 16,384 and 32,768): each the padded problem with every live node's usage scaled by a seeded
    factor in [0.5, 1) and each class's count cut by a seeded share up to
    10 % (``numpy.random.default_rng(FLEET_LIVE_SEED + i)``)."""
    import numpy as np

    from karpenter_tpu_torch.ops import packer as P

    base, _ = P.pad_problem(prob)
    E = base[11]
    out = []
    for i in range(n):
        rng = np.random.default_rng(FLEET_LIVE_SEED + i)
        args = list(base)
        used0 = args[8].copy()
        used0[:E] = (used0[:E] * rng.uniform(0.5, 1.0, (E, 1))).astype(np.float32)
        args[8] = used0
        cnt = args[1]
        args[1] = (cnt - np.floor(cnt * rng.uniform(0.0, 0.1, cnt.shape))).astype(np.int32)
        out.append(P.to_device(tuple(args), dev))
    return out


def compare_fleet(torch, name: str, tenants: list, picked: str, scan=None) -> float:
    """`fleet_pack` of ``tenants`` (card tensors) bit for bit against its
    plain version on the same tensors and against one solo `ffd_pack` a
    tenant, both objectives; each call must launch `choose_config` and
    ``picked`` once each, in fleet mode.  Returns the largest error."""
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P

    cols = T.fleet_columns(tenants)
    K = tenants[0][8].shape[0]
    err = 0.0
    for objective in OBJECTIVES:
        got, launched = launches_of(torch, lambda: F.fleet_pack(
            cols, k_slots=K, objective=objective, scan=scan))
        want = {"choose_config_fleet": 1, f"{picked}_fleet": 1}
        if launched != want:
            fail(f"fleet {name} {objective}: launched {launched}, expected {want}")
        plain = P.fleet_pack_reference(cols, k_slots=K, objective=objective)
        solo = [F.ffd_pack(*t, objective=objective) for t in tenants]
        solo = tuple(torch.stack(o) for o in zip(*solo))
        e_plain, e_solo = max_abs_err(torch, got, plain), max_abs_err(torch, got, solo)
        print(f"  fleet {name} B={len(tenants)} {objective}: {picked}, max_abs_err vs plain "
              f"{e_plain!r}, vs {len(tenants)} solo ffd_pack {e_solo!r}", flush=True)
        if e_plain or e_solo:
            fail(f"fleet {name} {objective}: fleet_pack differs (plain {e_plain}, solo {e_solo})")
        err = max(err, e_plain, e_solo)
    return err


def fleet_grid_turns(torch, name: str, tenants: list, card: str) -> dict:
    """The fleet scan past one cluster on its own (the stacked tenants and
    their choices made once): the grid scan as `fused_packer.fleet_pack`
    launches it and the global scan, `fused_packer._launch_global` in its
    fleet mode, timed in turns (`timed_in_turns`, `GRID_TURN_ITERS` calls a
    reading); the global scan's outputs must equal the grid's.  Prints and
    returns both ms a launch and the scan's bound (`fleet_bounds`)."""
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.ops import fused_packer as F

    B = len(tenants)
    cols = T.fleet_columns(tenants)
    stacked = [torch.stack(list(c)) for i, c in enumerate(cols) if i != F._NEXT0]
    shapes = F._fleet_check(stacked, B)
    req, cnt, maxper, slot, feas, alloc, price, openable, used0, cfg0, npods0, sig0 = stacked
    chosen = [torch.stack(c) for c in zip(*(F.choose_config(*(t[i] for i in (0, 2, 4, 5, 6, 7)))
                                            for t in tenants))]
    args = (req, cnt, maxper, slot, feas, alloc, *chosen, used0, cfg0, npods0, 0, sig0)
    batch = F.Fleet(B, torch.tensor([int(n) for n in cols[F._NEXT0]], dtype=torch.int32,
                                    device=req.device))
    runs = {"global": lambda: F._launch_global(args, shapes, batch),
            "grid": lambda: F._launch_picked(args, shapes, batch)}
    outs = runs["grid"]()
    e = max_abs_err(torch, runs["global"](), outs)
    if e:
        fail(f"fleet {name} B={B}: the global scan differs from the grid scan ({e})")
    ms = timed_in_turns(torch, runs, GRID_TURN_ITERS)
    bound = fleet_bounds(tenants, outs)["ffd_scan"]
    print(f"  {name} B={B} fleet scans in turns (global, grid, grid, global), ms a launch "
          f"(CUDA events): {json.dumps(ms)}; global / grid {ms['global'] / ms['grid']!r}; "
          f"bound {bound['bound_ms']!r} ms ({bound['bound_by']}) ({card})", flush=True)
    return dict(ms=ms, bound_ms=bound["bound_ms"], bound_by=bound["bound_by"])


def fleet_bounds(tenants: list, outs) -> dict:
    """The two fleet launches' bounds: each tenant's work counted as
    `kernel_bounds` counts one problem's, summed over the tenants."""
    sums = {"choose_config": [0, 0], "ffd_scan": [0, 0]}
    for b, args in enumerate(tenants):
        for k, v in kernel_bounds(args, outs[0][b], outs[2][b]).items():
            sums[k][0] += v["bytes"]
            sums[k][1] += v["operations"]
    return {k: _bound(*v) for k, v in sums.items()}


def time_fleet(torch, name: str, tenants: list, card: str, scan=None) -> dict:
    """One shape's fleet launches on the card: each launch's device time
    (torch.profiler, mean over `FLEET_ITERS` calls), beside the B solo
    launches they replace (the same, over B `ffd_pack` calls: their summed
    time), the stack's device time (CUDA events), both entry points'
    times a back-to-back call (CUDA events), the plain version's, and the
    bounds."""
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P

    cols = T.fleet_columns(tenants)
    K = tenants[0][8].shape[0]
    B = len(tenants)
    picked = scan or F.scan_kernel(*pack_shapes(tenants[0]))
    fleet = lambda: F.fleet_pack(cols, k_slots=K, scan=scan)
    solo_fn = F.ffd_scan_global if scan else F.ffd_scan

    def solo():
        for t in tenants:
            c = F.choose_config(*(t[i] for i in (0, 2, 4, 5, 6, 7)))
            solo_fn(*t[:6], *c, *t[8:])

    kernels = ("choose_config", picked)
    f_ms = profiled_launches_ms(torch, fleet, kernels, FLEET_ITERS)
    s_ms = profiled_launches_ms(torch, solo, kernels, FLEET_ITERS)
    stack_ms = cuda_ms(torch, lambda: [torch.stack(list(c)) for i, c in enumerate(cols)
                                       if i != 11], FLEET_ITERS)
    call_ms = cuda_ms(torch, fleet, FLEET_ITERS)
    solo_call_ms = cuda_ms(torch, lambda: [F.ffd_pack(*t) for t in tenants], FLEET_ITERS)
    # one call, no warm-up: the plain version is a host loop of seconds a
    # call at config 2, and the script's time limit holds every phase
    plain_ms = cuda_ms(torch, lambda: P.fleet_pack_reference(cols, k_slots=K), 1, warmup=0)
    outs = fleet()
    torch.cuda.synchronize()
    bounds = fleet_bounds(tenants, outs)
    out = {"B": B, "picked": picked, "stack_ms": stack_ms, "call_ms": call_ms,
           "solo_call_ms": solo_call_ms, "plain_ms": plain_ms, "rows": {}}
    for k, bound in zip(kernels, (bounds["choose_config"], bounds["ffd_scan"])):
        out["rows"][f"{k}_fleet"] = {"ms": f_ms[k], "solo_ms": s_ms[k] * B,
                                     "solo_launch_ms": s_ms[k], "bound": bound}
        print(f"  {name} B={B} {k}_fleet: {f_ms[k]!r} ms a launch (profiler) against "
              f"{B} solo launches {s_ms[k] * B!r} ms ({s_ms[k]!r} each); bound "
              f"{bound['bound_ms']!r} ms ({bound['bound_by']}) ({card})", flush=True)
    print(f"  {name} B={B}: the stack {stack_ms!r} ms (CUDA events), fleet_pack "
          f"{call_ms!r} ms a call against {B} ffd_pack calls {solo_call_ms!r} ms, the plain "
          f"version {plain_ms!r} ms (CUDA events) ({card})", flush=True)
    return out


def concurrent_round(remotes: dict, probs: dict, results=None) -> float:
    """``bench.py``'s burst: every tenant released on one barrier, solving
    through its own client; the seconds from release to the last answer."""
    import threading

    start = threading.Barrier(len(remotes) + 1)
    done = threading.Barrier(len(remotes) + 1)
    errs = []

    def worker(t):
        try:
            start.wait(timeout=120)
            out = remotes[t].pack_problem(probs[t])
            if results is not None:
                results[t] = out
        except BaseException as exc:  # reported after the round
            errs.append((t, exc))
        finally:
            done.wait(timeout=600)

    threads = [threading.Thread(target=worker, args=(t,), daemon=True) for t in remotes]
    for th in threads:
        th.start()
    start.wait(timeout=120)
    t0 = time.perf_counter()
    done.wait(timeout=600)
    dt = time.perf_counter() - t0
    for th in threads:
        th.join(timeout=60)
    if errs:
        fail(f"a tenant's solve failed: {errs[:3]}")
    return dt


def mismatches(got: dict, want: dict) -> int:
    """Fields of every tenant's answer that differ from its twin's."""
    import numpy as np

    return sum(
        not np.array_equal(getattr(got[t], f), getattr(want[t], f))
        for t in want for f in ("take", "leftover", "node_cfg", "node_pods", "node_used"))


def fingerprint_ms(probs: dict) -> float:
    """Host milliseconds the tenant pool's content fingerprints of one
    tenant's wire arrays take (``ops/resident._content_fp``, sha1), the
    median over the tenants."""
    import statistics as stats

    from karpenter_tpu_torch.ops.packer import pad_problem
    from karpenter_tpu_torch.ops.resident import _content_fp

    out = []
    for prob in probs.values():
        arrays = [a for a in pad_problem(prob)[0] if not isinstance(a, int)]
        t0 = time.perf_counter()
        for a in arrays:
            _content_fp(a)
        out.append((time.perf_counter() - t0) * 1e3)
    return stats.median(out)


def service_cell(name: str, probs: dict, device: str, rounds: int = SERVICE_ROUNDS) -> dict:
    """One cell: a ``SolverServer(multi_tenant=True)`` and a legacy sidecar
    on ``device``; every tenant's answer through the sidecar (the twin),
    one warm-up solve a tenant through the service (its pool upload), then
    ``rounds`` times a barrier-released burst of every tenant through the
    service and the same solves one after another through the sidecar.
    Every answer must equal the sidecar's; the service must have batched.
    The launch counters cover the bursts and the sidecar's rounds; the
    device observatory's transfer bytes the last burst (warm)."""
    import statistics as stats

    from karpenter_tpu_torch.obs.device import OBSERVATORY
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.service import RemoteSolver, SolverServer

    key = one_group(name, probs)
    srv = SolverServer(port=0, multi_tenant=True, resident_budget_mb=256,
                       device=device).start_background()
    legacy = SolverServer(port=0, device=device).start_background()
    remotes = {t: RemoteSolver(*srv.address, tenant=t) for t in probs}
    sidecar = RemoteSolver(*legacy.address)
    try:
        info = remotes[next(iter(probs))].info()
        if info.get("platform") != device or not info.get("multi_tenant"):
            fail(f"{name}: the service reports {info}, expected platform {device}")
        expected = {t: sidecar.pack_problem(p) for t, p in probs.items()}
        warm = {t: remotes[t].pack_problem(p) for t, p in probs.items()}
        bad = mismatches(warm, expected)
        F.reset_launches()
        conc, seq = [], []
        scope = None
        for r in range(rounds):
            got = {}
            if r == rounds - 1:
                OBSERVATORY.enabled = True
                scope = OBSERVATORY.begin_scope()
            conc.append(concurrent_round(remotes, probs, got))
            if scope is not None:
                OBSERVATORY.end_scope(scope)
            bad += mismatches(got, expected)
            t0 = time.perf_counter()
            for t, p in probs.items():
                sidecar.pack_problem(p)
            seq.append(time.perf_counter() - t0)
        launches = {k: v for k, v in F.LAUNCHES.items() if v}
        # the server's own time a dispatch (the flight ring: the pool's
        # fingerprints and swaps, the launches, the fetch), by path
        dispatch = {}
        for tick in srv.flight._ring:
            dispatch.setdefault(tick["summary"].get("path", "?"), []).append(tick["dur_s"] * 1e3)
        payload = srv.tenants_payload()
        batched = sum(d.get("batched", 0) for d in payload["tenants"].values())
        sizes = [int(ev.attrs["size"]) for ev in srv.ledger.recent(4096)
                 if ev.type == "TenantBatch"]
        with srv._pool_lock:
            pool_bytes = srv._pool.total_bytes()
    finally:
        for c in (*remotes.values(), sidecar):
            c.close()
        srv.stop()
        legacy.stop()
    conc_p50, seq_p50 = stats.median(conc) * 1e3, stats.median(seq) * 1e3
    out = {
        "tenants": len(probs), "group": key, "info": info, "mismatches": bad,
        "batched": batched, "batch_sizes": sizes, "launches": launches,
        "concurrent_ms": [x * 1e3 for x in conc], "sequential_ms": [x * 1e3 for x in seq],
        "concurrent_p50_ms": conc_p50, "sequential_p50_ms": seq_p50,
        "speedup_vs_sidecars": seq_p50 / conc_p50,
        "warm_transfer_bytes": dict(scope.transfer_bytes), "pool_bytes": pool_bytes,
        "dispatch_p50_ms": {k: stats.median(v) for k, v in sorted(dispatch.items())},
        "fingerprint_ms": fingerprint_ms(probs),
    }
    if bad:
        fail(f"{name}: {bad} answers differ from the dedicated sidecar's")
    if not batched:
        fail(f"{name}: no burst took the batched path")
    if scope.transfer_bytes.get("tenant_resident", 0):
        fail(f"{name}: a warm burst uploaded {scope.transfer_bytes['tenant_resident']} "
             f"bytes of tenant tensors")
    return out


def service_phase(torch, card, probs) -> dict:
    """Phase 11, as the module docstring lists it.  Returns the kernels
    line's fleet rows and each kernel's launches in the cells."""
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P

    dev = torch.device("cuda")
    cells = {"service-16-bench": bench_tenants(), "service-16-config2": config2_tenants()}
    for name, tp in cells.items():
        one_group(name, tp)
        args, kp = P.pad_problem(next(iter(tp.values())))
        G, R = args[0].shape
        print(f"  {name}: {len(tp)} tenants of {sum(p.total_pods() for p in tp.values())} "
              f"pods in one solve group: Gp={G} Cp={args[5].shape[0]} Kp={kp} R={R} "
              f"Sp={args[12].shape[0]} (classes {[p.feas.shape[0] for p in tp.values()]})",
              flush=True)
    bench = tenant_args(torch, cells["service-16-bench"], dev)
    config2 = tenant_args(torch, cells["service-16-config2"], dev)
    live = live_tenants(torch, probs["config2_live"], 4, dev)
    wrap = [P.to_device(T.fleet_tenant_arrays("wrap", FLEET_WRAP_SEED + i, 256), dev)
            for i in range(4)]
    # the fleets past one cluster (`FLEET_GRID`), each B the first of its tenants
    most = {name: max(n for p, n in FLEET_GRID if p == name) for name, _ in FLEET_GRID}
    grid_tenants = {name: live_tenants(torch, probs[name], n, dev) for name, n in most.items()}
    print("  [fleet vs plain and vs solo] bit-equality on the card", flush=True)
    err = {}

    def held(kernel, e):
        err[kernel] = max(err.get(kernel, 0.0), e)

    for B in FLEET_BATCHES:
        e = compare_fleet(torch, "bench", bench[:B], F.scan_kernel(*pack_shapes(bench[0])))
        held("choose_config_fleet", e)
        held(f"{F.scan_kernel(*pack_shapes(bench[0]))}_fleet", e)
    for name, tenants in (("config2", config2[:4]), ("config2_live", live), ("wrap", wrap)):
        picked = F.scan_kernel(*pack_shapes(tenants[0]))
        e = compare_fleet(torch, name, tenants, picked)
        held("choose_config_fleet", e)
        held(f"{picked}_fleet", e)
    held("ffd_scan_global_fleet",
         compare_fleet(torch, "config2_live global", live, "ffd_scan_global",
                       scan="ffd_scan_global"))
    t0, grid_before = time.perf_counter(), F.LAUNCHES["ffd_scan_grid_fleet"]
    for name, n in FLEET_GRID:
        e = compare_fleet(torch, name, grid_tenants[name][:n], "ffd_scan_grid")
        held("choose_config_fleet", e)
        held("ffd_scan_grid_fleet", e)
    print(f"  the fleets past one cluster held in {time.perf_counter() - t0:.3f} s", flush=True)
    for k in FLEET_KERNELS:
        if k not in err:
            fail(f"phase 11 never held {k} to its plain version")

    print(f"  [cells] the solver service on the card, {card}", flush=True)
    results = {}
    for name, tp in cells.items():
        r = results[name] = service_cell(name, tp, "cuda")
        print(f"  {name}: mismatches {r['mismatches']}, batched {r['batched']}, batch sizes "
              f"{r['batch_sizes']}, launches {r['launches']} ({card})")
        print(f"    concurrent round p50 {r['concurrent_p50_ms']!r} ms "
              f"({r['concurrent_ms']!r}), sequential round through the sidecar p50 "
              f"{r['sequential_p50_ms']!r} ms ({r['sequential_ms']!r}), "
              f"speedup_vs_sidecars {r['speedup_vs_sidecars']!r} ({card})")
        print(f"    warm burst's uploads by site {r['warm_transfer_bytes']}, the pool's "
              f"resident bytes {r['pool_bytes']}, info {r['info']}", flush=True)
        print(f"    the server's time a dispatch p50 by path {r['dispatch_p50_ms']!r} ms (host "
              f"clock), the pool's fingerprints of one tenant's arrays "
              f"{r['fingerprint_ms']!r} ms (host clock) ({card})", flush=True)
        for k in ("choose_config_fleet", "ffd_scan_fleet"):
            if not r["launches"].get(k):
                fail(f"{name}: {k} never launched in the cells' bursts")
    launches = {k: sum(r["launches"].get(k, 0) for r in results.values()) for k in F.LAUNCHES}

    print(f"  [fleet times] torch.profiler and CUDA events, {card}", flush=True)
    times = {
        "service-16-bench": time_fleet(torch, "service-16-bench", bench, card),
        "service-16-config2": time_fleet(torch, "service-16-config2", config2, card),
        "fleet_live": time_fleet(torch, "fleet_live", live, card),
        "fleet_live global": time_fleet(torch, "fleet_live global", live, card,
                                        scan="ffd_scan_global"),
    }
    t0 = time.perf_counter()
    row_name, row_b = "config2_live10k", 4  # ROW_PROBLEM's fleet_live10k
    times["fleet_live10k"] = time_fleet(torch, "fleet_live10k",
                                        grid_tenants[row_name][:row_b], card)
    turns = {f"{name.removeprefix('config2_')} B={n}": fleet_grid_turns(
        torch, name, grid_tenants[name][:n], card) for name, n in FLEET_GRID}
    print(f"  the fleets past one cluster timed in {time.perf_counter() - t0:.3f} s", flush=True)
    rows = {}
    for k in FLEET_KERNELS:
        where = ROW_PROBLEM[k] + (" global" if k == "ffd_scan_global_fleet" else "")
        t = times[where]
        rows[k] = dict(t["rows"][k], err=err[k], plain_ms=t["plain_ms"], B=t["B"],
                       stack_ms=t["stack_ms"], call_ms=t["call_ms"],
                       solo_call_ms=t["solo_call_ms"])
    # no cell reaches the grid's shapes: its launches are those of the checks
    # and timings above
    rows["ffd_scan_grid_fleet"].update(
        turns=turns, forced_launches=F.LAUNCHES["ffd_scan_grid_fleet"] - grid_before)
    return {"rows": rows, "launches": launches, "cells": results}


# ---------------------------------------------------------------------------
# Phase 12: two replicas failing over on one shared cluster store
# ---------------------------------------------------------------------------


def ha_harness(device: str, launches=None, on_tick=None, sanitized: bool = False):
    """`testing.HAHarness` over phase 7's cell: config 2's catalog, its
    ``general`` and tainted ``dedicated`` pools (consolidation held off),
    the fast path, the pipelined reconcile and the drift gate off, both
    replicas' solvers on ``device``.  ``sanitized`` sets the lock
    sanitizer's settings and `HA_WATCHDOG_STALL_S`."""
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.api import Disruption, Settings
    from karpenter_tpu_torch.cloud.fake.catalog import generate_catalog

    extra = (dict(enable_lock_sanitizer=True, lock_watchdog_stall_s=HA_WATCHDOG_STALL_S)
             if sanitized else {})
    settings = Settings(cluster_name="chip-smoke", enable_admission_fastpath=False,
                        provision_fastpath_bypass=False, enable_pipelined_reconcile=False,
                        feature_gate_drift=False, **extra)
    h = T.HAHarness(device=device, shapes=generate_catalog(**T.CONFIG2_CATALOG),
                    settings=settings, launches=launches, on_tick=on_tick)
    h.default_node_class()
    hold = lambda: Disruption(consolidate_after=HOLD_CONSOLIDATION_S)
    h.node_pool("general", disruption=hold())
    h.node_pool("dedicated", taints=[T.DEDICATED_TAINT], disruption=hold())
    h.sync("pools")
    for name, kube in h.kubes.items():
        if kube._sock_codec != "bin1":
            fail(f"phase 12: {name}'s client negotiated {kube._sock_codec!r}, not bin1")
    return h


def ha_run(h, n_pods: int = OPERATOR_PODS, churn_rounds=HA_CHURN, churn_pods: int = CHURN_PODS):
    """The failover drive (`testing.ha_drive`) on config 2's first
    ``n_pods`` pods, its invariants (`testing.ha_checks`) and the leader's
    consistency checker.  Every failed check fails the phase."""
    from karpenter_tpu_torch import testing as T

    t0 = time.perf_counter()
    try:
        marks = T.ha_drive(h, T.heterogeneous_pods(n_pods), churn_pods=churn_pods,
                           churn_rounds=churn_rounds, seed=CHURN_SEED)
        T.ha_checks(h, marks)
        violations = T.ha_consistency(h)
    except AssertionError as exc:
        fail(f"phase 12 ({h.device}): {exc}")
    if violations:
        fail(f"phase 12 ({h.device}): consistency violations {violations[:3]}")
    marks["seconds"] = time.perf_counter() - t0
    return marks


def ha_readings(h) -> dict:
    """What the card's drive is held to: each replica's `operator_state`,
    the launch list, the server's canonical store state, each tick's
    (round, replica, led, solve kind)."""
    from karpenter_tpu_torch import testing as T

    return {
        "state": {name: T.operator_state(h.view(name)) for name in T.HA_REPLICAS},
        "launches": list(h.launches),
        "store": h.store_state(),
        "ticks": [(t["round"], t["replica"], t["led"], t["kind"]) for t in h.ticks],
    }


def store_plane(h) -> dict:
    """The store plane's counters: each client's RPCs by verb (count and
    summed seconds of ``karpenter_store_rpc_seconds``), its bytes by codec,
    its watch resyncs; the server's requests by verb and bytes by codec."""
    def by(reg, name, label):
        return {dict(k).get(label, ""): v for k, v in sorted(reg.counters.get(name, {}).items())}

    out = {}
    for name, kube in h.kubes.items():
        reg = kube.registry
        rpcs = {dict(k).get("method", ""): {"n": hist.count, "s": hist.total}
                for k, hist in sorted(reg.histograms.get("karpenter_store_rpc_seconds",
                                                         {}).items())}
        out[name] = {"rpcs": rpcs,
                     "bytes_sent": by(reg, "karpenter_store_bytes_sent_total", "codec"),
                     "bytes_received": by(reg, "karpenter_store_bytes_received_total", "codec"),
                     "resyncs": dict(kube.watch_resyncs)}
    reg = h.server.registry
    out["server"] = {"requests": by(reg, "karpenter_store_requests_total", "method"),
                     "bytes_sent": by(reg, "karpenter_store_bytes_sent_total", "codec"),
                     "bytes_received": by(reg, "karpenter_store_bytes_received_total",
                                          "codec")}
    return out


class HaCardChecks:
    """The card drive's per-tick checks, as the harness's ``on_tick`` and
    a wrapper of each replica's ``scheduler.solve``: every solve ran on the
    card (``cuda_ffd``) and launched ``choose_config`` and a scan; after
    each solve the resident state's card tensors equal their host mirrors
    (`check_mirrors`); the first solve of each term equals a cold CPU
    solve of the same pods and live nodes (`cpu_equal`), its time taken
    out of the tick's.  Each tick record gains ``solve_ms`` and the
    resident hits and rebuilds of its solve."""

    def __init__(self, torch):
        self.torch = torch
        self.excluded_ms = 0.0
        self.firsts = set()
        self.prev = {}

    def wrap(self, h) -> None:
        for name, op in h.ops.items():
            sched = op.provisioner.scheduler
            self.prev[name] = (sched.resident_hits, sched.resident_rebuilds)

            def solve(pods, _solve=sched.solve, _name=name, _sched=sched):
                pods = list(pods)
                result = _solve(pods)
                if (h.term, _name) not in self.firsts:
                    self.firsts.add((h.term, _name))
                    t0 = time.perf_counter()
                    self.torch.cuda.synchronize()
                    cpu_equal(f"phase 12 {_name}", f"term {h.term}'s first",
                              (_sched.pools, _sched.instance_types, None, _sched.existing),
                              pods, result)
                    self.excluded_ms += (time.perf_counter() - t0) * 1e3
                return result

            sched.solve = solve

    def __call__(self, h, rec) -> None:
        name = rec["replica"]
        sched = h.ops[name].provisioner.scheduler
        rec["tick_ms"] -= self.excluded_ms
        rec["check_ms"], self.excluded_ms = self.excluded_ms, 0.0
        hits, rebuilds = self.prev[name]
        self.prev[name] = (sched.resident_hits, sched.resident_rebuilds)
        rec["resident_hits"] = sched.resident_hits - hits
        rec["resident_rebuilds"] = sched.resident_rebuilds - rebuilds
        if not rec["kind"]:
            return
        rec["solve_ms"] = sum(sched.last_phases.values()) * 1e3
        if sched.last_kernel != "cuda_ffd":
            fail(f"phase 12: {name} solved round {rec['round']} with {sched.last_kernel!r}")
        got = rec["launches"]
        if got.get("choose_config", 0) < 1 or sum(got.get(k, 0) for k in SCAN_KERNELS) < 1:
            fail(f"phase 12: {name}'s solve in round {rec['round']} launched {got}")
        if sched._resident.states:
            self.torch.cuda.synchronize()
            check_mirrors(self.torch, f"phase 12 {name} round {rec['round']}",
                          sched._resident.states[-1])


def ha_summary(h, marks) -> dict:
    """Phase 12's readings: tick ms p50 by term and solve kind, the
    failover (rounds and simulated seconds from A's crash to B's first
    nomination; B's first solve; A's first solve of its second term),
    each replica's compile-cache counters, ``_flush_dirty`` ms a tick
    and ``wait_synced`` ms, and launches by kernel for each replica."""
    ticks = h.ticks
    by = {}
    for t in ticks:
        by.setdefault(f"{t['term']} {t['replica']} {t['kind'] or 'none'}", []).append(t["tick_ms"])
    first_nom = next(t for t in ticks if t["term"] == "B1" and t["nominated"])
    first = lambda term: next(t for t in ticks if t["term"] == term and t["kind"])
    solve = lambda t: {k: t.get(k) for k in ("round", "kind", "solve_ms", "tick_ms",
                                             "resident_hits", "resident_rebuilds",
                                             "launches")}
    launches = {}
    for t in ticks:
        per = launches.setdefault(t["replica"], {})
        for k, v in t["launches"].items():
            per[k] = per.get(k, 0) + v
    return {
        "tick_p50_ms": {k: {"p50_ms": statistics.median(v), "ticks": len(v)}
                        for k, v in sorted(by.items())},
        "failover": {"rounds": first_nom["round"] - marks["crash_round"],
                     "sim_s": first_nom["clock"] - marks["crash_clock"],
                     "b_first_solve": solve(first("B1")),
                     "a_second_term_first_solve": solve(first("A2"))},
        "compile_cache": {name: {"hits": op.provisioner.scheduler.compile_cache_hits,
                                 "misses": op.provisioner.scheduler.compile_cache_misses}
                          for name, op in h.ops.items()},
        "flush_ms": {name: percentiles(v) for name, v in h.flush_ms.items()},
        "flush_ms_by_term": {
            term: percentiles([t["flush_ms"] for t in ticks if t["term"] == term])
            for term in ("A1", "B1", "A2")},
        "wait_synced_ms": percentiles(h.sync_ms),
        "launches": launches,
    }


def sanitized_failover(_phases, conn) -> None:
    """The crash-and-take-over drive under the runtime lock sanitizer, in
    a process of its own: the sanitizer is enabled before the port is
    imported, so every lock the port builds (the kernel wrappers' module
    locks too) is wrapped; both operators arm the lock watchdog.  Sends
    back the findings, the watchdog's fires, the witness's edge count and
    its edges into the kernel wrappers' locks, or ``("error", text)``."""
    import traceback

    try:
        from karpenter_tpu_torch.analysis import sanitizer

        san = sanitizer.enable("chip-smoke")
        import torch

        from karpenter_tpu_torch.ops import fused_packer as F

        h = ha_harness("cuda", sanitized=True)
        fired = []
        dogs = [op.watchdog for op in h.ops.values()]
        if any(d is None for d in dogs):
            raise RuntimeError("an operator armed no lock watchdog under the sanitizer")
        for d in dogs:
            d.on_stall = fired.append
            d.start()
        try:
            F.reset_launches()
            marks = ha_run(h, n_pods=HA_SANITIZED_PODS, churn_rounds=HA_SANITIZED_ROUNDS,
                           churn_pods=HA_SANITIZED_CHURN)
            torch.cuda.synchronize()
            launches = {k: v for k, v in F.LAUNCHES.items() if v}
        finally:
            for d in dogs:
                d.stop()
            h.close()
        sanitizer.disable()
        w = san.witness()
        wrapper_locks = {"_build._LOAD_LOCK", "fused_packer._LOCK"}
        conn.send(("sanitized", {
            "findings": [f.render() for f in san.findings()],
            "fired": len(fired),
            "locks": len(w.locks),
            "edges": len(w.edges),
            "wrapper_locks": sorted(wrapper_locks & set(w.locks)),
            "wrapper_edges": [(e["outer"], e["inner"]) for e in w.edges
                              if e["inner"] in wrapper_locks or e["outer"] in wrapper_locks],
            "launches": launches,
            "rounds": h.round_no,
            "seconds": marks["seconds"],
        }))
    except SystemExit as exc:
        conn.send(("error", f"exit {exc.code}"))
    except Exception:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def ha_phase(torch, card, p50_7: dict) -> dict:
    """Phase 12 as the module docstring lists it.  Returns the launch
    counts of the card's drive."""
    from karpenter_tpu_torch.ops import fused_packer as F

    twins = CpuTwins((12,))
    try:
        checks = HaCardChecks(torch)
        h = ha_harness("cuda", launches=F.LAUNCHES, on_tick=checks)
        checks.wrap(h)
        try:
            F.reset_launches()
            marks = ha_run(h)
            torch.cuda.synchronize()
            launches = dict(F.LAUNCHES)
            got = dict(ha_readings(h), summary=ha_summary(h, marks), plane=store_plane(h))
            solves = [t for t in h.ticks if t["kind"]]
        finally:
            h.close()
        for t in h.ticks:
            print("  tick " + json.dumps({k: t[k] for k in (
                "round", "replica", "term", "led", "kind", "tick_ms", "flush_ms", "nominated",
                "launches") if k in t} | {k: t[k] for k in ("solve_ms", "check_ms") if k in t}),
                flush=True)
        s = got["summary"]
        print(f"  {h.round_no} rounds, {len(h.ticks)} ticks, {len(solves)} solves "
              f"({', '.join(t['kind'] for t in solves)}) in {marks['seconds']!r} s; "
              f"{len(h.launches)} launches, launches by kernel over the drive {launches}",
              flush=True)
        if launches["choose_config"] < len(solves) or launches["ffd_scan_global"]:
            fail(f"phase 12: launches {launches} over {len(solves)} solves")
        print(f"  tick p50 by term, replica and solve kind ({card}): "
              f"{json.dumps(s['tick_p50_ms'])}")
        print(f"  phase 7's tick p50 by solve kind, in process ({card}): {json.dumps(p50_7)}")
        print(f"  failover: {json.dumps(s['failover'])}")
        print(f"  compile cache by replica: {json.dumps(s['compile_cache'])}")
        print(f"  _flush_dirty ms a call by replica: {json.dumps(s['flush_ms'])}; "
              f"a tick by term: {json.dumps(s['flush_ms_by_term'])}")
        print(f"  wait_synced ms: {json.dumps(s['wait_synced_ms'])}")
        print(f"  store plane: {json.dumps(got['plane'])}")
        print(f"  launches by replica: {json.dumps(s['launches'])}", flush=True)
        print("  the sanitized failover on the card (a process of its own):", flush=True)
        spawned = CpuTwins((), target=sanitized_failover)
        try:
            san = spawned.get("sanitized")
        finally:
            spawned.close()
        print(f"    {HA_SANITIZED_PODS} pods, {san['rounds']} rounds in {san['seconds']!r} s: "
              f"{len(san['findings'])} findings, {san['fired']} watchdog fires, "
              f"{san['locks']} locks, {san['edges']} edges in the witness, the kernel "
              f"wrappers' locks {san['wrapper_locks']} with edges {san['wrapper_edges']}; "
              f"launches {san['launches']}", flush=True)
        if san["findings"] or san["fired"]:
            fail("phase 12: the sanitized failover found " + "; ".join(san["findings"])
                 + f" ({san['fired']} watchdog fires)")
        if not san["launches"].get("choose_config"):
            fail(f"phase 12: the sanitized failover launched {san['launches']}")
        cpu = twins.get("ha")
    finally:
        twins.close()
    print(f"  the same drive on the CPU (plain version): {cpu['seconds']!r} s (beside the "
          f"card's, in a process of its own)", flush=True)
    for key in ("ticks", "launches", "store"):
        if got[key] != cpu[key]:
            fail(f"phase 12: the card's {key} differ from the CPU drive's")
    for name, state in got["state"].items():
        for key in state:
            if state[key] != cpu["state"][name][key]:
                fail(f"phase 12: {name}'s {key} differ from the CPU drive's")
    print(f"  the card's launch list ({len(got['launches'])} launches), ticks, store state "
          f"({sum(len(v) for v in got['store'].values())} objects) and each replica's "
          f"operator state equal the CPU drive's", flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 13: the fleet simulator and the deployed process
# ---------------------------------------------------------------------------


def fleet_runner(scenario: str, seed: int, ticks: int, operators: int, device: str,
                 n_pods: int = 0, trace_path=None):
    """A `sim.fleet.FleetRunner` of ``scenario`` on ``device`` (its trace
    written to ``trace_path`` too, when given).  With ``n_pods`` it is the
    scaled cell: the fake cloud runs config 2's catalog, and config 2's
    ``general`` and tainted ``dedicated`` pools and its first ``n_pods``
    pods are put through ``op-0``'s client and synced before tick 0, the
    scenario's churn and failover storm on top.  Three settings keep the
    cell's trace a function of its seed at this size, as the simulator's
    scenarios and phase 7 keep theirs: each provisioner launches one claim
    at a time (concurrent launches hand out instance ids in thread order,
    and a 10,000-pod solve launches about 150 claims at once); the SLO
    engines leave out the rule on the tick's wall time
    (``testing.WALL_CLOCK_SIGNAL``: a replica's tick passes its 1 s here);
    and consolidation is held off on every pool, the scenario's
    ``default`` pool too: the cell is the service's tenancy across
    failovers, and each leader's consolidation what-ifs run on its own
    card state, not through the service (phase 9 drives them)."""
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.api import Disruption
    from karpenter_tpu_torch.cloud.fake.catalog import generate_catalog
    from karpenter_tpu_torch.obs.slo import default_rules
    from karpenter_tpu_torch.sim.fleet import FleetRunner, _FleetTrace

    shapes = generate_catalog(**T.CONFIG2_CATALOG) if n_pods else None
    runner = FleetRunner(scenario, seed, ticks, operators=operators,
                         trace=_FleetTrace(trace_path), device=device, shapes=shapes)
    if not n_pods:
        return runner
    try:
        for op in runner.ops.values():
            op.provisioner.launch_concurrency = 1
            op.slo.replace_rules([r for r in default_rules(op.settings)
                                  if r.signal != T.WALL_CLOCK_SIGNAL])
        kube = runner.kubes[runner.names[0]]
        hold = lambda: Disruption(consolidate_after=HOLD_CONSOLIDATION_S)
        kube.put_node_pool(T.default_node_pool(disruption=hold()))
        kube.put_node_pool(T.default_node_pool(name="general", disruption=hold()))
        kube.put_node_pool(T.default_node_pool(name="dedicated", taints=[T.DEDICATED_TAINT],
                                               disruption=hold()))
        for pod in T.heterogeneous_pods(n_pods):
            kube.put_pod(pod)
        runner._sync("config 2")
    except BaseException:
        runner.close()
        raise
    return runner


class FleetProbe:
    """Times a `FleetRunner`'s ticks (wrapping ``_tick``) and each client's
    ``_flush_dirty`` (wrapping the method on the client) and, where the
    operators pack through the solver service, each remote solve that
    follows another replica's (a new leader's first): its ms and the bytes
    the service uploaded for it, by site (the device observatory's
    ``transfer_bytes``: the service runs in this process)."""

    def __init__(self, runner):
        from karpenter_tpu_torch.obs.device import OBSERVATORY

        self._obs = OBSERVATORY
        self._runner = runner
        self._last = None
        self.tick_ms = []
        self.flush_ms = {name: [] for name in runner.names}
        self.first_solves = []
        runner._tick = self._timed(runner._tick, self.tick_ms)
        for name, kube in runner.kubes.items():
            kube._flush_dirty = self._timed(kube._flush_dirty, self.flush_ms[name])
        for name, op in runner.ops.items():
            sched = op.provisioner.scheduler
            if sched.pack_fn is not None:
                sched.pack_fn = self._first_solve(name, sched.pack_fn)

    @staticmethod
    def _timed(fn, into: list):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                into.append((time.perf_counter() - t0) * 1e3)

        return timed

    def _first_solve(self, name: str, pack):
        def solve(*args, **kw):
            if name == self._last:
                return pack(*args, **kw)
            self._last = name
            before = self._obs.snapshot()["transfer_bytes"]
            t0 = time.perf_counter()
            out = pack(*args, **kw)
            ms = (time.perf_counter() - t0) * 1e3
            after = self._obs.snapshot()["transfer_bytes"]
            self.first_solves.append({
                "tick": self._runner.tick_no, "replica": name, "ms": ms,
                "uploaded": {k: v - before.get(k, 0) for k, v in after.items()
                             if v != before.get(k, 0)}})
            return out

        return solve


def crash_rounds(trace: str) -> list:
    """For each ``op_crash`` of a fleet trace, the ticks from the crash to
    the next tick with a ``PodNominated`` ledger event (None if none
    follows)."""
    lines = [json.loads(line) for line in trace.splitlines()]
    noms = sorted({x["tick"] for x in lines if x["t"] == "led" and x["type"] == "PodNominated"})
    return [next((n - x["tick"] for n in noms if n >= x["tick"]), None)
            for x in lines if x["t"] == "ev" and x["kind"] == "op_crash"]


def fleet_run(scenario: str, seed: int, ticks: int, operators: int, device: str,
              n_pods: int = 0, trace_path=None) -> dict:
    """One fleet run (`fleet_runner`) with its `FleetProbe`, read back: the
    trace text, the report, the seconds to build the runner (and put the
    scaled cell's pools and pods in), the wall seconds of the run, the tick
    p50 / p99 ms and each tick's,
    ``_flush_dirty`` ms by operator, the service's solves by tenant and
    refusals, each new leader's first remote solve, the ticks from each
    crash to the next nomination, the launch list (tick, replica, claim),
    the double launches, the invariant violations, and the kernel launches
    of the run (the counters set to 0 just before it)."""
    from karpenter_tpu_torch.ops import fused_packer as F

    t0 = time.perf_counter()
    runner = fleet_runner(scenario, seed, ticks, operators, device, n_pods, trace_path)
    setup = time.perf_counter() - t0
    probe = FleetProbe(runner)
    F.reset_launches()
    t0 = time.perf_counter()
    report = runner.run()
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    trace = runner.trace.text()
    solver = report.get("solver") or {}
    return {
        "trace": trace,
        "report": report,
        "setup_s": setup,
        "wall_s": wall,
        "kernel_launches": {k: v for k, v in F.LAUNCHES.items() if v},
        "ticks": percentiles(probe.tick_ms),
        "tick_ms": probe.tick_ms,
        "flush_ms": {name: percentiles(v) for name, v in probe.flush_ms.items()},
        "solves_by_tenant": solver.get("solves_by_tenant", {}),
        "refused": solver.get("refused", 0),
        "first_solves": probe.first_solves,
        "crash_rounds": crash_rounds(trace),
        "launches": [list(x) for x in runner.launches],
        "double_launches": report["double_launches"],
        "violations": report["invariants"]["violations"],
    }


def fleet_line(run: dict) -> str:
    """A `fleet_run`'s figures as phase 13 prints them (no trace, report or
    launch list)."""
    return json.dumps({k: v for k, v in run.items() if k not in ("trace", "report", "launches")}
                      | {"launches": len(run["launches"])})


def fleet_checks(name: str, run: dict, cpu: dict) -> None:
    """What phase 13 holds each fleet run on the card to: no double launch,
    no invariant violation, no refusal by the solver service, and its
    trace and launch list equal to the same run's on the CPU."""
    if run["double_launches"] or run["violations"]:
        fail(f"phase 13: {name}: {run['double_launches']} double launches, violations "
             f"{run['violations'][:5]}")
    if run["refused"]:
        fail(f"phase 13: {name}: the solver service refused {run['refused']} solves")
    if run["trace"] != cpu["trace"]:
        card_lines, cpu_lines = run["trace"].splitlines(), cpu["trace"].splitlines()
        at = next((i for i, (a, b) in enumerate(zip(card_lines, cpu_lines)) if a != b),
                  min(len(card_lines), len(cpu_lines)))
        show = lambda lines: lines[at][:400] if at < len(lines) else "(none)"
        fail(f"phase 13: {name}: the card's trace differs from the CPU's at line {at}: "
             f"card {show(card_lines)}; CPU {show(cpu_lines)}")
    if run["launches"] != cpu["launches"]:
        fail(f"phase 13: {name}: the card's launch list differs from the CPU's")


def kernel_events(trace_path: str) -> dict:
    """The device kernels of a ``torch.profiler`` Chrome trace: count and
    summed device ms by kernel name."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    out = {}
    for e in events:
        if e.get("cat") == "kernel":
            n, ms = out.get(e["name"], (0, 0.0))
            out[e["name"]] = (n + 1, ms + e.get("dur", 0) / 1e3)
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def scrape(port: int, path: str):
    """The body of ``http://127.0.0.1:<port><path>``, or None if the
    process does not answer yet."""
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as resp:
            return resp.read().decode()
    except OSError:
        return None


def metric_sum(body: str, name: str) -> float:
    """A Prometheus exposition's samples of ``name``, summed over labels."""
    return sum(float(line.rsplit(" ", 1)[1]) for line in body.splitlines()
               if line.startswith(name) and line[len(name)] in " {")


def deployed_process(card: str) -> dict:
    """Phase 13 (c): ``python -m karpenter_tpu_torch --device cuda
    --interval 0.05 --metrics-port <free> --demo-pods DEPLOYED_PODS`` with
    ``enable_profiling`` and ``profile_dir`` in its settings file.  Waits
    until its demo pods are placed (the process has no kubelet, as the
    reference's has none: its pods are nominated to launched claims, never
    bound): ``/debug/device`` shows ``ffd_pack`` launched and ``/metrics``
    launched NodeClaims.  Scrapes both, sends SIGTERM; fails unless the
    process exits 0, printed its span report and wrote ``spans.json``, its
    profiler timelines under ``profile_dir`` hold device events of
    ``choose_config`` and of a scan, and ``/debug/device`` shows the solve's
    launch and the resident state it seeded on the card."""
    import glob
    import os
    import signal
    import tempfile

    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        prof = os.path.join(tmp, "prof")
        settings = os.path.join(tmp, "settings.json")
        with open(settings, "w") as f:
            json.dump({"cluster_name": "chip-smoke-deployed", "enable_profiling": True,
                       "profile_dir": prof}, f)
        port = free_port()
        out_path, err_path = os.path.join(tmp, "stdout"), os.path.join(tmp, "stderr")
        cmd = [sys.executable, "-m", "karpenter_tpu_torch", "--device", "cuda",
               "--interval", "0.05", "--metrics-port", str(port),
               "--demo-pods", str(DEPLOYED_PODS), "--settings-file", settings]
        t0 = time.perf_counter()
        with open(out_path, "w") as out, open(err_path, "w") as err:
            proc = subprocess.Popen(cmd, cwd=repo, stdout=out, stderr=err)
            try:
                device, metrics, placed_s = {}, "", None
                while time.perf_counter() - t0 < DEPLOYED_WAIT_S and proc.poll() is None:
                    body = scrape(port, "/debug/device")
                    metrics = scrape(port, "/metrics") or ""
                    device = json.loads(body) if body else {}
                    if (device.get("dispatches", {}).get("ffd_pack")
                            and metric_sum(metrics, "karpenter_nodeclaims_launched") > 0):
                        placed_s = time.perf_counter() - t0
                        break
                    time.sleep(0.5)
                if placed_s is None:
                    fail(f"phase 13: the deployed process placed no pod in "
                         f"{DEPLOYED_WAIT_S} s (exit {proc.poll()})")
                time.sleep(1.0)
                device = json.loads(scrape(port, "/debug/device") or "{}")
                metrics = scrape(port, "/metrics") or ""
                proc.send_signal(signal.SIGTERM)
                rc = proc.wait(timeout=120)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        wall = time.perf_counter() - t0
        with open(out_path) as f:
            stdout = f.read()
        with open(err_path) as f:
            stderr = f.read()
        if rc != 0:
            fail(f"phase 13: the deployed process exited {rc} on SIGTERM: {stderr[-2000:]}")
        if "total_ms" not in stdout:
            fail("phase 13: the deployed process printed no span report")
        if not os.path.exists(os.path.join(prof, "spans.json")):
            fail("phase 13: the deployed process wrote no spans.json")
        with open(os.path.join(prof, "spans.json")) as f:
            spans = json.load(f)["stats"]
        traces = sorted(glob.glob(os.path.join(prof, "solve-*.pt.trace.json")))
        kernels = {}
        for path in traces:
            for k, (n, ms) in kernel_events(path).items():
                got = kernels.get(k, (0, 0.0))
                kernels[k] = (got[0] + n, got[1] + ms)
        names = " ".join(kernels)
        if "choose_config" not in names or "ffd_scan" not in names:
            fail(f"phase 13: the profiler's timelines ({len(traces)} files) hold no device "
                 f"event of choose_config and a scan: {sorted(kernels)[:8]}")
        resident = device.get("resident", {}).get("bytes_total", 0)
        if not device.get("dispatches", {}).get("ffd_pack") or not resident:
            fail(f"phase 13: /debug/device shows no launch or no resident state: {device}")
    return {
        "placed_s": placed_s,
        "wall_s": wall,
        "claims_launched": metric_sum(metrics, "karpenter_nodeclaims_launched"),
        "debug_device": {k: device.get(k) for k in ("tick", "dispatches", "compiles",
                                                     "transfer_bytes", "resident")},
        "profiler_files": len(traces),
        "kernels": {k: {"events": n, "device_ms": ms} for k, (n, ms) in sorted(kernels.items())},
        "spans": {k: v for k, v in spans.items() if k.startswith(("controller.provisioner",
                                                                   "solver"))},
    }


def fleet_phase(torch, card) -> dict:
    """Phase 13 as the module docstring lists it.  Returns the launches of
    the scaled cell's drive."""
    import os
    import tempfile

    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.sim.fleet import _FleetTrace, replay_fleet

    twins = CpuTwins((13,))
    try:
        card_runs, total = {}, {}
        with tempfile.TemporaryDirectory() as tmp:
            for name, seed, ticks, operators in FLEET_CELLS:
                run = fleet_run(name, seed, ticks, operators, "cuda",
                                trace_path=os.path.join(tmp, f"{name}.jsonl"))
                for k, v in run["kernel_launches"].items():
                    total[k] = total.get(k, 0) + v
                card_runs[name] = run
                print(f"  {name} (seed {seed}, {ticks} ticks, {operators} operators) on the card "
                      f"({card}): {fleet_line(run)}", flush=True)
            F.reset_launches()
            writer = _FleetTrace()
            t0 = time.perf_counter()
            _runner, replayed, recorded = replay_fleet(
                os.path.join(tmp, f"{FLEET_REPLAYED}.jsonl"), trace=writer, device="cuda")
            torch.cuda.synchronize()
            original = card_runs[FLEET_REPLAYED]
            print(f"  {FLEET_REPLAYED} replayed on the card in {time.perf_counter() - t0!r} s, "
                  f"launches {json.dumps({k: v for k, v in F.LAUNCHES.items() if v})}",
                  flush=True)
            if recorded != original["report"] or replayed != original["report"]:
                fail(f"phase 13: the replay of {FLEET_REPLAYED} did not reproduce its report")
            if writer.text() != original["trace"]:
                fail(f"phase 13: the replay of {FLEET_REPLAYED} did not reproduce its trace bytes")
            print(f"  the replay reproduced the report and the trace, byte for byte "
                  f"({len(writer.text())} bytes)", flush=True)
        print(f"  launches over the three scenarios: {json.dumps(total)}", flush=True)
        label, scenario, seed, ticks, operators = SCALED_FLEET
        print(f"  {label}: {scenario} (seed {seed}, {ticks} ticks, {operators} operators) over "
              f"config 2's catalog, pools and first {SCALED_FLEET_PODS} pods, on the card "
              f"({card}):", flush=True)
        scaled = fleet_run(scenario, seed, ticks, operators, "cuda", n_pods=SCALED_FLEET_PODS)
        launches = {k: scaled["kernel_launches"].get(k, 0) for k in KERNELS}
        report = scaled["report"]
        print(f"    setup {scaled['setup_s']!r} s (the runner, then the pools and pods through "
              f"op-0's client); wall {scaled['wall_s']!r} s; tick ms "
              f"{json.dumps(scaled['ticks'])}, each {json.dumps(scaled['tick_ms'])}", flush=True)
        print(f"    _flush_dirty ms a call by operator: {json.dumps(scaled['flush_ms'])}",
              flush=True)
        print(f"    the service's solves by tenant: {json.dumps(scaled['solves_by_tenant'])}; "
              f"refused {scaled['refused']}", flush=True)
        for first in scaled["first_solves"]:
            print(f"    a new leader's first remote solve: {json.dumps(first)}", flush=True)
        print(f"    ticks from each crash to the next nomination: {scaled['crash_rounds']}; "
              f"{len(scaled['launches'])} launches, {report['replicas_led']} led, "
              f"{report['leader_transitions']} leader transitions", flush=True)
        print(f"    launches by kernel over the drive: {json.dumps(scaled['kernel_launches'])}",
              flush=True)
        if not launches["choose_config"] or not sum(launches[k] for k in SCAN_KERNELS):
            fail(f"phase 13: {label} launched {launches}")
        if launches["ffd_scan_global"]:
            fail(f"phase 13: {label} launched ffd_scan_global {launches['ffd_scan_global']} times")
        cpu_runs = twins.get("fleet")
        for name, _seed, _ticks, _operators in FLEET_CELLS:
            print(f"  {name} on the CPU (plain versions, beside the card's drives): "
                  f"{fleet_line(cpu_runs[name])}", flush=True)
            fleet_checks(name, card_runs[name], cpu_runs[name])
        print(f"  every card trace and launch list equals the CPU's "
              f"({sum(len(r['trace']) for r in card_runs.values())} bytes over "
              f"{len(FLEET_CELLS)} scenarios)", flush=True)
        cpu = twins.get("fleet_scaled")
        print(f"  {label} on the CPU: {fleet_line(cpu)}", flush=True)
        fleet_checks(label, scaled, cpu)
        print(f"  {label}: the card's trace ({len(scaled['trace'])} bytes) and launch list "
              f"({len(scaled['launches'])}) equal the CPU's", flush=True)
    finally:
        twins.close()
    print(f"  the deployed process: python -m karpenter_tpu_torch --demo-pods {DEPLOYED_PODS} "
          f"with enable_profiling and profile_dir ({card}):", flush=True)
    print(f"    {json.dumps(deployed_process(card))}", flush=True)
    return launches


def lint_discovery() -> tuple:
    """What the port's two device rules find on its tree: the launch
    wrappers ``tracer-safety`` discovers and the upload sites
    ``device-put`` matches with its allowlist emptied ("file:Qual")."""
    from karpenter_tpu_torch.analysis import RULES, PackageSnapshot
    from karpenter_tpu_torch.analysis.allowlists import ALLOWLISTS
    from karpenter_tpu_torch.analysis.tracer import discover_wrappers

    snap = PackageSnapshot.load()
    exempt = frozenset(e for e in ALLOWLISTS["tracer-safety"] if isinstance(e, str))
    wrappers = discover_wrappers(snap, exempt).names()
    sites = sorted({f"{f.file}:{f.message.split(':')[0]}"
                    for f in RULES["device-put"]().check(snap, frozenset())})
    return wrappers, sites


def start_lint():
    """Phase 14 (a): the lint subcommand over the port's tree, started in a
    fresh process, a thread reading its output as it comes and noting its
    wall seconds when it exits; the phase's drives run beside it.
    `finish_lint` reads the report."""
    import pathlib
    import threading

    proc = subprocess.Popen(
        [sys.executable, "-m", "karpenter_tpu_torch", "lint", "--json", "--profile"],
        cwd=pathlib.Path(__file__).resolve().parent, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
    )
    t0, got = time.perf_counter(), {}

    def read() -> None:
        try:
            got["out"], got["err"] = proc.communicate(timeout=LINT_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            got["out"], got["err"] = proc.communicate()
            got["timeout"] = True
        got["wall"] = time.perf_counter() - t0

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    return proc, reader, got


def finish_lint(started) -> dict:
    """The lint of `start_lint`, waited for: its JSON report and wall
    seconds."""
    proc, reader, got = started
    reader.join()
    if got.get("timeout"):
        fail(f"phase 14: lint ran past {LINT_TIMEOUT_S} s")
    if proc.returncode != 0:
        fail(f"phase 14: lint exited {proc.returncode}:\n{got['out'][-4000:]}"
             f"{got['err'][-4000:]}")
    report = json.loads(got["out"])
    report["wall_s"] = got["wall"]
    return report


def legacy_env(device: str):
    """Phase 14 (c): an operator environment on ``device`` whose NodeClass
    and NodePool are a v1alpha5 AWSNodeTemplate and Provisioner converted by
    ``api/legacy.py``, with `LEGACY_PODS` pending pods that tolerate the
    Provisioner's taint."""
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.api import Pod, Resources, reset_name_sequences
    from karpenter_tpu_torch.api.legacy import convert_aws_node_template, convert_provisioner
    from karpenter_tpu_torch.api.objects import Toleration

    reset_name_sequences()
    env = T.Environment(device=device)
    env.operator.provisioner.launch_concurrency = 1
    env.kube.put_node_class(convert_aws_node_template({
        "apiVersion": "karpenter.k8s.aws/v1alpha1", "kind": "AWSNodeTemplate",
        "metadata": {"name": "default"},
        "spec": {"subnetSelector": {"Name": "*"}, "securityGroupSelector": {"Name": "*"}},
    }))
    env.kube.put_node_pool(convert_provisioner({
        "apiVersion": "karpenter.sh/v1alpha5", "kind": "Provisioner",
        "metadata": {"name": "default"},
        "spec": {
            "providerRef": {"name": "default"},
            "consolidation": {"enabled": True},
            "taints": [{"key": "dedicated", "value": "ml", "effect": "NoSchedule"}],
            "limits": {"resources": {"cpu": "1000"}},
        },
    }))
    for i in range(LEGACY_PODS):
        env.kube.put_pod(Pod(requests=Resources(cpu=0.5 + (i % 4) * 0.5, memory="1Gi"),
                             tolerations=[Toleration(key="dedicated", value="ml")]))
    return env


def legacy_drive(device: str, launches=None) -> tuple:
    """Phase 14 (c)'s ticks: 2 s steps until every pod is nominated (at most
    `LEGACY_TICKS`), then until every pod is bound.  Returns (env, the tick
    that nominated them, the launches of those ticks by kernel)."""
    env = legacy_env(device)
    prov = env.operator.provisioner
    if launches is not None:
        launches.reset_launches()
    for tick in range(1, LEGACY_TICKS + 1):
        env.step(2.0)
        if all(prov.cluster.nominated_node(p.key()) is not None or p.node_name
               for p in env.kube.pods.values()):
            break
    else:
        fail(f"phase 14 ({device}): pods not nominated after {LEGACY_TICKS} ticks")
    counts = dict(launches.LAUNCHES) if launches is not None else {}
    env.settle()
    if env.kube.pending_pods():
        fail(f"phase 14 ({device}): {len(env.kube.pending_pods())} converted-pool pods unbound")
    return env, tick, counts


def analysis_phase(torch, card) -> dict:
    """Phase 14 as the module docstring lists it (the lint in its process
    beside the drives of (b) and (c)); returns (c)'s launches."""
    lint = start_lint()
    try:
        launched = analysis_drives(torch, card)
    except BaseException:
        lint[0].kill()
        lint[1].join()
        raise
    wrappers, sites = lint_discovery()
    report = finish_lint(lint)
    rules, timings = report["rules"], report.get("timings_s", {})
    print(f"  lint: {len(rules)} rules; tracer-safety discovered {len(wrappers)} launch "
          f"wrappers {wrappers}; device-put matched {len(sites)} upload sites {sites}; "
          f"seconds by rule {json.dumps(timings, sort_keys=True)}", flush=True)
    if not wrappers or not sites:
        fail(f"phase 14: tracer-safety found {len(wrappers)} wrappers, device-put "
             f"{len(sites)} upload sites")
    counts = report["counts"]
    print(f"  lint --json: exit 0, {counts['findings']} live findings, "
          f"{counts['baselined']} baselined, {len(rules)} rules, "
          f"{sum(timings.values())!r} s in rules, {report['wall_s']!r} s wall beside the "
          f"phase's drives ({card})")
    if counts["findings"] or report["findings"] or len(rules) != LINT_RULES:
        fail(f"phase 14: lint reported {counts} over {len(rules)} rules")
    return launched


def analysis_drives(torch, card) -> dict:
    """Phase 14 (b) and (c), beside the lint's process; returns (c)'s
    launches."""
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.tools.allocatable_diff import diff_rows

    env, _, _ = drive_operator("cuda", rounds=0)
    diff = diff_rows(env.operator)
    print(f"  allocatable-diff over phase 7's drive on the card: {len(diff.rows)} managed "
          f"nodes, {len(diff.skipped)} skipped ({card})")
    drift = 0
    for r in diff.rows:
        moved = (r.alloc_mem_diff_mi, r.alloc_cpu_diff_m,
                 r.expected_capacity_mem_mi - r.actual_capacity_mem_mi,
                 r.expected_capacity_cpu_m - r.actual_capacity_cpu_m)
        drift += any(moved)
        print(f"    {r.node} {r.instance_type}: allocatable expected "
              f"{r.expected_alloc_mem_mi} Mi / {r.expected_alloc_cpu_m} m, actual "
              f"{r.actual_alloc_mem_mi} Mi / {r.actual_alloc_cpu_m} m, diff {moved}")
    print(f"  allocatable-diff: {drift} rows of drift")
    if not diff.rows or drift or diff.skipped:
        fail(f"phase 14: allocatable-diff shows {drift} rows of drift, "
             f"{len(diff.skipped)} skipped, over {len(diff.rows)} rows")
    del env

    card_env, tick, launched = legacy_drive("cuda", F)
    sched = card_env.operator.provisioner.scheduler
    print(f"  legacy Provisioner + AWSNodeTemplate: {LEGACY_PODS} pods nominated at tick "
          f"{tick}, {len(card_env.kube.node_claims)} claims, kernel {sched.last_kernel}, "
          f"launches {json.dumps({k: v for k, v in launched.items() if v})}")
    if sched.last_kernel != "cuda_ffd":
        fail(f"phase 14: the converted pool's solve ran {sched.last_kernel}")
    if not launched.get("choose_config") or not any(launched.get(k) for k in SCAN_KERNELS):
        fail(f"phase 14: the converted pool's solve launched {launched}")
    cpu_env, _, _ = legacy_drive("cpu")
    if T.operator_state(card_env) != T.operator_state(cpu_env):
        fail("phase 14: the converted objects' drive on the card differs from the CPU's")
    print("  legacy drive: operator_state equal to the CPU drive's")
    return launched


def mesh_devices(torch) -> list:
    """Phase 15's shards: `MESH_SHARDS` over the machine's cards in turn
    (all of them on the one card of a one-card machine)."""
    n = torch.cuda.device_count()
    return [torch.device("cuda", i % n) for i in range(MESH_SHARDS)]


def _differ(torch, a, b, fields):
    """A card flag: any of the shard buffers ``fields`` of ``a`` and ``b``
    differ (float32 by bit pattern)."""
    out = None
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        d = (x != y).any()
        out = d if out is None else out | d
    return out


# the shard buffers each step writes (ops/packer.py: MeshShard)
CAP_FIELDS = ("used", "cfg", "npods", "sig", "take", "leftover", "cap", "nxt", "xchg")
APPLY_FIELDS = ("take", "xchg")


def mesh_lockstep(torch, name, mesh, args, objective, plain_s=None) -> tuple:
    """Each mesh kernel against its plain version on the same card tensors,
    step by step: every tile's choice records, then per class each shard's
    cap and apply launches on one copy of the shard and the plain steps on
    another, every buffer the step writes compared bit for bit (mismatch
    flags kept on the card, read once at the end).  ``plain_s`` collects
    the plain steps' seconds and calls by kernel.  Returns the kernels' and
    the plain steps' five outputs and the choice records' max_abs_err."""
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P
    from karpenter_tpu_torch.parallel import mesh as PM

    plan, reps, slots, next0 = PM.pack_layout(mesh, args, site="mesh_smoke")
    recs_k, recs_p = [], []
    for dev, g0, g1, c0, c1 in plan.tile_bounds():
        rep = reps[dev]
        a = (rep[0], rep[2], rep[4], rep[5], rep[6], rep[7], g0, g1, c0, c1, objective)
        recs_k.append(F.choose_config_shard(*a))
        recs_p.append(P.choose_config_shard_reference(*a))
    e_choose = max_abs_err(torch, recs_k, recs_p)
    if e_choose != 0.0:
        fail(f"{name} {objective}: choose_config_shard differs from its plain version "
             f"(max_abs_err {e_choose!r})")
    kern = P.mesh_shards(plan, reps, recs_k, slots, next0)
    plain = P.mesh_shards(plan, reps, recs_p, slots, next0)
    G = kern[0].take.shape[0]
    bad = {k: [None] * len(kern) for k in ("ffd_shard_cap", "ffd_shard_apply")}

    def step(kernel, fn, ref, fields, g):
        for i, (a, b) in enumerate(zip(kern, plain)):
            fn(a, g)
            t0 = time.perf_counter()
            ref(b, g)
            if plain_s is not None:
                torch.cuda.synchronize()
                plain_s[kernel][0] += time.perf_counter() - t0
                plain_s[kernel][1] += 1
            d = _differ(torch, a, b, fields)
            bad[kernel][i] = d if bad[kernel][i] is None else bad[kernel][i] | d

    for g in range(G + 1):
        step("ffd_shard_cap", F.ffd_shard_cap, P.ffd_shard_cap_reference, CAP_FIELDS, g)
        if g == G:
            break
        P.mesh_exchange_row(kern, 0, g)
        P.mesh_exchange_row(plain, 0, g)
        step("ffd_shard_apply", F.ffd_shard_apply, P.ffd_shard_apply_reference, APPLY_FIELDS, g)
        P.mesh_exchange_row(kern, 1, g)
        P.mesh_exchange_row(plain, 1, g)
    for kernel, flags in bad.items():
        if any(bool(f) for f in flags):
            fail(f"{name} {objective}: {kernel} differs from its plain version")
    return P.mesh_outputs(kern), P.mesh_outputs(plain), e_choose


def mesh_pair_pack(plan, reps, slots, next0, objective: str = "nodes"):
    """The sharded pack through the pair on any plan, as `mesh_pack` runs
    it where the data rows lie on several cards: the choice tiles, the
    shards, ``mesh_scan`` over ``ffd_shard_cap`` / ``ffd_shard_apply``,
    the outputs gathered."""
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P

    recs = [F.choose_config_shard(*(reps[dev][i] for i in (0, 2, 4, 5, 6, 7)),
                                  g0, g1, c0, c1, objective)
            for dev, g0, g1, c0, c1 in plan.tile_bounds()]
    shards = P.mesh_shards(plan, reps, recs, slots, next0)
    P.mesh_scan(shards, F.ffd_shard_cap, F.ffd_shard_apply)
    return P.mesh_outputs(shards)


# the shard buffers ffd_shard_scan leaves (its exchanges stay in the cluster)
SCAN_FIELDS = ("used", "cfg", "npods", "sig", "take", "leftover", "nxt")


def mesh_whole_scan(torch, name, mesh, args, objective, single=None, plain_s=None):
    """``ffd_shard_scan`` against its plain version on the same card
    shards: the tiles' choice records through the kernel, two copies of
    each data row's shard, one launch of the kernel on one set and
    `ffd_shard_scan_reference` on the other, every buffer a shard keeps
    compared bit for bit, then the five outputs (and, given ``single``, a
    single-device pack's outputs against them).  ``plain_s`` collects the
    plain call's seconds.  Returns the kernel's outputs and their
    max_abs_err against the plain version's."""
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P
    from karpenter_tpu_torch.parallel import mesh as PM

    plan, reps, slots, next0 = PM.pack_layout(mesh, args, site="mesh_smoke")
    rep = reps[plan.tiles[0][0]]
    picked = F.shard_scan_kernel(plan, plan.k_bounds[-1], rep[0].shape[1],
                                 slots[0][3].shape[0], rep[4].shape[1])
    if picked != "ffd_shard_scan":
        fail(f"{name}: the plan's scan is {picked}, not ffd_shard_scan")
    recs = [F.choose_config_shard(*(reps[dev][i] for i in (0, 2, 4, 5, 6, 7)),
                                  g0, g1, c0, c1, objective)
            for dev, g0, g1, c0, c1 in plan.tile_bounds()]
    kern = P.mesh_shards(plan, reps, recs, slots, next0)
    plain = P.mesh_shards(plan, reps, recs, slots, next0)
    card = kern[0].device.type == "cuda"  # CPU shards: both sides plain (the tests)
    sync = torch.cuda.synchronize if card else (lambda: None)
    before = F.LAUNCHES["ffd_shard_scan"]
    F.ffd_shard_scan(kern)
    sync()
    if F.LAUNCHES["ffd_shard_scan"] != before + card:
        fail(f"{name}: ffd_shard_scan did not launch once")
    t0 = time.perf_counter()
    P.ffd_shard_scan_reference(plain)
    sync()
    if plain_s is not None:
        plain_s.append(time.perf_counter() - t0)
    for a, b in zip(kern, plain):
        if bool(_differ(torch, a, b, SCAN_FIELDS)):
            fail(f"{name} {objective}: ffd_shard_scan differs from its plain version "
                 f"on data shard {a.d}")
    k_out = P.mesh_outputs(kern)
    err = max_abs_err(torch, k_out, P.mesh_outputs(plain))
    if err != 0.0 or (single is not None and max_abs_err(torch, k_out, single) != 0.0):
        fail(f"{name} {objective}: ffd_shard_scan's outputs differ (max_abs_err {err!r})")
    return k_out, err


def mesh_scan_bound(torch, plan, args_host, outs) -> dict:
    """The least time of one ``ffd_shard_scan`` launch from this run's
    data, from the function's own inputs and outputs: the single-device
    scan's bytes and operations (`kernel_bounds`: the inputs this data
    needs read once, the pack's five outputs written once), with the
    choice read from the model shards' records once (M x G records of 16
    bytes) in place of the three choice rows.  The shards' copies of the
    records, their other leftover rows, the signature counters and next
    free slots they keep are the mesh's state, not the function's, and are
    not counted."""
    M = len(plan.tiles[0])
    tensors = tuple(a if isinstance(a, int) else torch.from_numpy(a) for a in args_host)
    b = kernel_bounds(tensors, outs[0], outs[2])["ffd_scan"]
    G = args_host[0].shape[0]
    return _bound(b["bytes"] - 3 * G * 4 + M * G * 16, b["operations"])


def open_steps(take, node_cfg, next0: int):
    """For each class step g, the slots that hold a config before it: the
    live slots, and each new slot from the class whose window opened it
    (the first class it takes pods from)."""
    import numpy as np

    K = node_cfg.shape[0]
    G = take.shape[0]
    opened_at = np.full(K, G + 1)
    idx = np.arange(K)
    live = (node_cfg >= 0) & (idx < next0)
    opened_at[live] = 0
    new = (node_cfg >= 0) & (idx >= next0)
    took = take[:, new] > 0
    opened_at[new] = np.where(took.any(0), took.argmax(0) + 1, G + 1)
    return opened_at  # slot k holds a config at class step g iff opened_at[k] <= g


def mesh_bounds(plan, args_host, outs, R_req) -> dict:
    """The least time of one launch of each scan kernel, averaged over a
    pack's launches, from this run's data: per class step g the cap launch
    of a shard reads and writes its slots' state (usage R floats, config,
    take, pod count, signature counter; the caps written) and gathers the
    alloc row and the feasibility byte of each slot that holds a config
    then, and the apply launch reads the caps and writes the takes; their
    operations are the usage FMAs and the requested axes' divisions of each
    live slot.  The choice tile reads its classes' rows, its configs' feas
    bytes and alloc rows and every config's price and openable byte."""
    import numpy as np

    req = args_host[0]
    G, R = req.shape
    C = args_host[5].shape[0]
    D = len(plan.tiles)
    take, _, node_cfg, _, _ = (o.cpu().numpy() for o in outs)
    opened_at = open_steps(take, node_cfg, int(args_host[11]))
    kb = plan.k_bounds
    cap_b = cap_o = app_b = app_o = 0
    for d in range(D):
        kd = kb[d + 1] - kb[d]
        at = opened_at[kb[d]: kb[d + 1]]
        live_by_g = np.searchsorted(np.sort(at), np.arange(G + 1), side="right")
        live = int(live_by_g.sum())
        cap_b += (G + 1) * kd * (8 * R + 4 * 9) + live * (4 * R + 1)
        cap_o += G * kd * R + live * 3 * max(R_req, 1)
        app_b += G * kd * 8
        app_o += G * kd * 3
    n_cap, n_app = (G + 1) * D, G * D
    tiles = len(plan.tiles) * len(plan.tiles[0])
    ch_b = G * (4 * R + 4 + 16) + G * C + C * 4 * R + tiles * C * 5
    ch_o = G * C * (max(R_req, 1) + 4) + tiles * C
    return {"ffd_shard_cap": _bound(cap_b / n_cap, cap_o / n_cap),
            "ffd_shard_apply": _bound(app_b / n_app, app_o / n_app),
            "choose_config_shard": _bound(ch_b / tiles, ch_o / tiles)}


def mesh_events_ms(torch, mesh, args, kernels) -> dict:
    """Phase 15's fallback where torch.profiler records no device time of
    the sharded pack's kernels: device ms a launch of each of ``kernels``
    from CUDA events (`events_device_ms`) on the pack's own tensors
    ``args``, on a mesh of one card.  The choice tiles are timed alone, and
    ``ffd_shard_scan`` on fresh shards; the pair's scan over the classes on
    fresh shards (one card: the exchange copies nothing) gives the cap and
    apply launches' sum, from which a pass of apply launches alone over the
    finished shards (each writes only its class's take row) is taken
    out."""
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P
    from karpenter_tpu_torch.parallel import mesh as PM

    if len(mesh.distinct()) != 1:
        fail("torch.profiler saw no device time of the mesh kernels; the CUDA-event "
             "fallback times a mesh of one card only")
    plan, reps, slots, next0 = PM.pack_layout(mesh, args, site="mesh_smoke")
    tiles = list(plan.tile_bounds())

    def choose():
        return [F.choose_config_shard(*(reps[dev][i] for i in (0, 2, 4, 5, 6, 7)),
                                      g0, g1, c0, c1) for dev, g0, g1, c0, c1 in tiles]

    out = {"choose_config_shard": events_device_ms(torch, choose, 5, len(tiles))}
    recs = choose()
    if "ffd_shard_scan" in kernels:
        sets = [P.mesh_shards(plan, reps, recs, slots, next0) for _ in range(5)]
        out["ffd_shard_scan"] = events_device_ms(torch, lambda: F.ffd_shard_scan(sets.pop()), 2)
        if not set(kernels) & set(MESH_PAIR):
            return {k: out[k] for k in kernels}
    fresh = [P.mesh_shards(plan, reps, recs, slots, next0) for _ in range(5)]
    done = fresh[-1]
    G, D = done[0].take.shape[0], len(done)
    scan_ms = events_device_ms(
        torch, lambda: P.mesh_scan(fresh.pop(), F.ffd_shard_cap, F.ffd_shard_apply), 2)
    out["ffd_shard_apply"] = events_device_ms(
        torch, lambda: [F.ffd_shard_apply(sh, g) for g in range(G) for sh in done], 2, G * D)
    out["ffd_shard_cap"] = (scan_ms - out["ffd_shard_apply"] * G * D) / ((G + 1) * D)
    return {k: out[k] for k in kernels}


def assemble_bound(p) -> dict:
    S = p["type_ok"].shape[0]
    G, C = len(p["sig_of"]), len(p["t_of"])
    byts = 4 * G + 12 * C + S * (p["type_ok"].shape[1] + p["zone_ok"].shape[1]
                                 + p["ct_ok"].shape[1]) + G * C
    return _bound(byts, 2 * G * C)


def assemble_cases(torch, adm) -> tuple:
    """``assemble_feasibility`` past the whole mask on ``adm``'s device
    (the seven admission tensors), each case against the plain version on
    the same inputs: tiles whose bounds and widths (1, 15, 17) are no
    multiples of 16, each as a tile of its own and written in place
    (`assemble_tiles`, one tile) into a mask prefilled with
    `ASSEMBLE_SENTINEL` bytes, its rows C and C + 3 bytes apart; then 9
    disjoint unaligned tiles in one `assemble_tiles` call into such masks.
    Returns ({case: bytes that differ, the mask's bytes outside the tiles
    included}, the launches of each call of the kernel's side)."""
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P

    G, C = adm[3].shape[0], adm[4].shape[0]
    dev = adm[0].device
    tiles = [(3, G, 5, C - 2), (3, G, 5, 6), (3, G, 5, 20), (3, G, 5, 22),
             (1, G // 2, 3, C - 5)]
    launches = []

    def counted(call, *args):
        before = F.LAUNCHES["assemble_feasibility"]
        got = call(*args)
        launches.append(F.LAUNCHES["assemble_feasibility"] - before)
        return got

    def prefilled(pad):
        base = torch.full((G, C + pad), ASSEMBLE_SENTINEL, dtype=torch.uint8, device=dev)
        return base, base[:, :C].view(torch.bool)

    def in_place(tiles, pad):
        (kb, kv), (pb, pv) = prefilled(pad), prefilled(pad)
        counted(F.assemble_tiles, *adm, tiles, kv)
        P.assemble_tiles_reference(*adm, tiles, pv)
        return int((kb != pb).sum())

    diff = {}
    for t in tiles:
        got = counted(F.assemble_feasibility, *adm, *t)
        diff[f"tile {t}"] = int((got != P.assemble_feasibility_reference(*adm, *t)).sum())
        for pad in (0, 3):
            diff[f"in place {t}, rows {C + pad} bytes apart"] = in_place([t], pad)
    gb = [3 + b for b in P.split_bounds(G - 3, 4)]
    cb = [5 + b for b in P.split_bounds(C - 7, 2)]
    multi = [(gb[i], gb[i + 1], cb[j], cb[j + 1]) for i in range(4) for j in range(2)]
    multi.append((0, 1, 0, 1))
    for pad in (0, 3):
        diff[f"{len(multi)} tiles in one call, rows {C + pad} bytes apart"] = in_place(multi, pad)
    return diff, launches


def assemble_floor_ms(torch, adm, iters: int) -> tuple:
    """Device ms of an empty launch (``probe_empty_grid_kernel``,
    csrc/latency_probe.cu) of the grid and block that
    ``assemble_feasibility`` gives the whole mask of ``adm``
    (`fused_packer.assemble_layout`) on ``adm``'s device, from
    torch.profiler, or from CUDA events (`events_device_ms`) where the
    profiler saw no device time in `PROFILE_ATTEMPTS` windows, as the
    kernel's own reading falls back: the kernel's floor for launch
    latency.  Returns (ms, grid, the timer)."""
    from karpenter_tpu_torch.ops import fused_packer as F

    dev = adm[0].device
    G, C = adm[3].shape[0], adm[4].shape[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lay = F.assemble_layout([(0, G, 0, C, 0)], sms)
    lib = _latency_lib()

    def launch():
        if lib.probe_empty_grid(*lay.grid, 32, F.ASSEMBLE_WARPS,
                                torch.cuda.current_stream(dev).cuda_stream) != 0:
            fail("the empty grid probe launch failed")

    timer = ["profiler"]

    def by_events(_missing):
        timer[0] = "events"
        return {"probe_empty_grid": events_device_ms(torch, launch, 20)}

    ms = profiled_ms(torch, launch, "probe_empty_grid", iters, by_events)
    return ms, lay.grid, timer[0]


def mesh_phase(torch, card) -> dict:
    """Phase 15 as the module docstring lists it; returns the kernels
    line's rows of the mesh kernels and the counts of its main path."""
    import random

    import numpy as np

    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.obs.device import OBSERVATORY
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P
    from karpenter_tpu_torch.parallel import mesh as PM
    from karpenter_tpu_torch.scheduling.solver import TorchScheduler

    dev = torch.device("cuda")
    mesh = PM.make_mesh(MESH_SHARDS, mesh_devices(torch))
    if mesh.shape != (4, 2):
        fail(f"phase 15: a mesh of {MESH_SHARDS} shards has shape {mesh.shape}")
    print(f"  mesh {mesh.shape}: data rows "
          f"{[[str(d) for d in row] for row in mesh.devices]} ({card})", flush=True)
    # the mesh phase's own three problems: past one cluster the mesh's
    # one-card scan (a CTA holds at most 2,048 slots) is the pair
    specs = {name: spec for name, spec in problems().items() if name not in LARGE_LIVE}
    rng = random.Random(15)
    pools, inv, pods, _ = specs["config2"]
    ticks = {"cold": pods, "hit": pods, "delta": churn(rng, pods, [])}
    step_p = T.mesh_step_problem(classes=MESH_STEP_CLASSES, k_slots=4096, types=MESH_STEP_TYPES)

    # the single-device reference solves, before the counted window
    single = TorchScheduler(pools, inv, device=dev)
    want, single_ms, phases = {}, {}, {"single": {}, "mesh": {}}
    for kind, p in ticks.items():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want[kind] = canonical(single.solve(p))
        single_ms[kind] = (time.perf_counter() - t1) * 1e3
        phases["single"][kind] = {k: round(v * 1e3, 3) for k, v in single.last_phases.items()}
    if single.pack_fn is not None or single.last_kernel != "cuda_ffd":
        fail(f"phase 15: the single-device scheduler picked {single.last_kernel}")
    for name in ("flagship", "config2_live"):
        pl, iv, pd, ex = specs[name]
        want[name] = canonical(TorchScheduler(pl, iv, existing=ex, device=dev).solve(pd))

    # ---- the main path: counts zeroed just before, read just after --------
    fn = PM.mesh_pack_fn(mesh)
    F.reset_launches()
    t0 = time.perf_counter()
    msched = TorchScheduler(pools, inv, device=dev, pack_fn=fn)
    got, solve_ms = {}, {}
    for kind, p in ticks.items():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got[kind] = canonical(msched.solve(p))
        torch.cuda.synchronize()
        solve_ms[kind] = (time.perf_counter() - t1) * 1e3
        phases["mesh"][kind] = {k: round(v * 1e3, 3) for k, v in msched.last_phases.items()}
        # the cold solve seeds the sharded resident state and packs from it;
        # the hit and the delta pack from it with no seed
        seeds = (msched.resident_rebuilds, msched.resident_hits)
        if (msched.last_kernel != "scan-sharded" or not msched.last_resident
                or seeds != {"cold": (1, 0), "hit": (1, 1), "delta": (1, 2)}[kind]):
            fail(f"phase 15: the mesh's {kind} solve ran {msched.last_kernel}, "
                 f"resident={msched.last_resident}, rebuilds and hits {seeds}")
    scheds = {}
    for name in ("flagship", "config2_live"):
        pl, iv, pd, ex = specs[name]
        scheds[name] = TorchScheduler(pl, iv, existing=ex, device=dev, pack_fn=fn)
        got[name] = canonical(scheds[name].solve(pd))
    step_out = PM.sharded_solve_step(mesh, 4096)(*(step_p[k] for k in T.MESH_STEP_ARGS))
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    counts = dict(F.LAUNCHES)
    print(f"  main path ({main_s:.3f} s): config 2 cold / hit / delta through "
          f"TorchScheduler(pack_fn=mesh_pack_fn(mesh)) ({json.dumps(solve_ms)} ms), the "
          f"flagship, the live cluster, sharded_solve_step at Gp {MESH_STEP_CLASSES} Cp "
          f"{len(step_p['t_of'])} Kp 4096; launches "
          f"{json.dumps({k: v for k, v in counts.items() if v})}", flush=True)
    st = msched._resident.states[-1]
    margs = st.pack_args()
    main_scan = F.shard_scan_kernel(P.mesh_plan(mesh.devices, st.Gp, st.Cp, st.Kp), st.Kp,
                                    margs[0].shape[1], margs[12].shape[0], st.Cp)
    if len(mesh.distinct()) == 1 and main_scan != "ffd_shard_scan":
        fail(f"phase 15: the one-card plan's scan is {main_scan}")
    path = ("assemble_feasibility", "choose_config_shard",
            *(("ffd_shard_scan",) if main_scan == "ffd_shard_scan" else MESH_PAIR))
    print(f"  config 2 solve ms by kind, single-device scheduler (before the window) "
          f"{json.dumps(single_ms)}; phases ms, single-device then mesh: "
          f"{json.dumps(phases)}", flush=True)
    for k in path:
        if not counts[k]:
            fail(f"phase 15: the main path never launched {k}")
    if counts["assemble_feasibility"] != len(mesh.distinct()):
        fail(f"phase 15: the factorized step launched assemble_feasibility "
             f"{counts['assemble_feasibility']} times on {len(mesh.distinct())} device(s)")
    off_path = [k for k in MESH_KERNELS if k not in path and counts[k]]
    if off_path:
        fail(f"phase 15: the main path launched {off_path} beside {main_scan}")
    print(f"  the plan's scan: {main_scan} (one launch a pack where every data row sits "
          f"on one card); {', '.join(k for k in MESH_KERNELS if k not in path)} "
          f"launched 0 times", flush=True)
    single_path = [k for k in ("choose_config", *SCAN_KERNELS) if counts[k]]
    if single_path:
        fail(f"phase 15: the mesh's solves launched the single-device {single_path}")
    for key, val in got.items():
        if val != want[key]:
            fail(f"phase 15: the mesh's {key} solve decodes unlike the single-device one")
    print("  decoded: config 2 cold / hit / delta, the flagship and the live cluster equal "
          "the single-device scheduler's", flush=True)
    check_mirrors(torch, "phase 15 config2", st)
    if st.mesh is not mesh or st.d_used0.spec != "on_k":
        fail("phase 15: the resident state is not sharded over the mesh")

    # ---- mesh_pack_fn against the single-device ffd_pack -----------------
    dp = mesh.shape[0]
    for name, spec in specs.items():
        prob = compiled(spec)
        args, kp = P.pad_problem(prob, max(P.node_slot_bound(prob), 8 * dp))
        for objective in OBJECTIVES:
            before = F.LAUNCHES[main_scan if main_scan == "ffd_shard_scan" else MESH_PAIR[0]]
            m = fn(prob, k_slots=kp, objective=objective)
            s = F.ffd_pack(*P.to_device(args, dev), objective=objective)
            if max_abs_err(torch, m, s) != 0.0:
                fail(f"phase 15: mesh_pack_fn differs from ffd_pack at {name} {objective}")
            if F.LAUNCHES[main_scan if main_scan == "ffd_shard_scan" else MESH_PAIR[0]] == before:
                fail(f"phase 15: mesh_pack_fn at {name} did not launch {main_scan}")
        print(f"  mesh_pack_fn == ffd_pack at {name} (Kp {kp}, both objectives, through "
              f"{main_scan})", flush=True)

    # ---- each kernel against its plain version -----------------------------
    errs = {k: 0.0 for k in MESH_KERNELS}
    plain_s = {k: [0.0, 0] for k in MESH_PAIR}
    scan_plain_s = []  # ffd_shard_scan_reference's seconds at config 2
    states = {"config2": st, "flagship": scheds["flagship"]._resident.states[-1],
              "config2_live": scheds["config2_live"]._resident.states[-1]}
    outs = {}
    for name, state in states.items():
        args = state.pack_args()
        k_out, p_out, e_choose = mesh_lockstep(torch, name, mesh, args, "nodes",
                                               plain_s if name == "config2" else None)
        errs["choose_config_shard"] = max(errs["choose_config_shard"], e_choose)
        outs[name] = (args, k_out)
        for k in MESH_PAIR:
            errs[k] = max(errs[k], max_abs_err(torch, k_out, p_out))
        s_out, e_scan = mesh_whole_scan(torch, name, mesh, args, "nodes",
                                        plain_s=scan_plain_s if name == "config2" else None)
        errs["ffd_shard_scan"] = max(errs["ffd_shard_scan"], e_scan,
                                     max_abs_err(torch, s_out, k_out))
        print(f"  {name}: ffd_shard_scan's shard buffers equal its plain version's, the pair "
              f"every step (Gp {state.Gp}, Cp {state.Cp}, Kp {state.Kp}, "
              f"live {len(state.live)})", flush=True)
    cases = {"wrap 256": T.wrap_arrays(256), "wrap 4096 straddling 2048":
             T.wrap_arrays(4096, at=2046), "frontier wrap": T.frontier_pack("wrap", 0),
             "frontier past": T.frontier_pack("past", -1)}
    for name, args in cases.items():
        for objective in OBJECTIVES:
            k_out, p_out, e_choose = mesh_lockstep(torch, name, mesh, args, objective)
            errs["choose_config_shard"] = max(errs["choose_config_shard"], e_choose)
            e = max_abs_err(torch, k_out, p_out)
            for k in MESH_PAIR:
                errs[k] = max(errs[k], e)
            want_out = P.pack_reference(*P.to_device(args, dev), objective=objective)
            if max_abs_err(torch, k_out, want_out) != 0.0:
                fail(f"phase 15: the sharded pack differs from the plain pack at {name}")
            single_out = F.ffd_pack(*P.to_device(args, dev), objective=objective)
            s_out, e_scan = mesh_whole_scan(torch, name, mesh, args, objective,
                                            single=single_out)
            errs["ffd_shard_scan"] = max(errs["ffd_shard_scan"], e_scan,
                                         max_abs_err(torch, s_out, want_out))
        print(f"  {name}: ffd_shard_scan equal to its plain version and to ffd_pack, the "
              f"pair every step, both objectives", flush=True)
    # the default mesh of one card, (1, 1): a cluster of one CTA holding
    # every slot (the frontier element's 2,048: two a thread)
    one = PM.make_mesh(1, [dev])
    prob2 = compiled(specs["config2"])
    d1 = {"config2": P.pad_problem(prob2, max(P.node_slot_bound(prob2), 32))[0],
          "frontier wrap": cases["frontier wrap"]}
    for name, args in d1.items():
        for objective in OBJECTIVES:
            single_out = F.ffd_pack(*P.to_device(args, dev), objective=objective)
            s_out, e_scan = mesh_whole_scan(torch, f"{name} on (1, 1)", one, args, objective,
                                            single=single_out)
            errs["ffd_shard_scan"] = max(errs["ffd_shard_scan"], e_scan)
        print(f"  {name} on the (1, 1) mesh (Kp {args[8].shape[0]}, one CTA): ffd_shard_scan "
              f"equal to its plain version and to ffd_pack, both objectives", flush=True)
    adm = [step_p[k] for k in T.MESH_STEP_ARGS[:7]]
    adm_dev = P.to_device(tuple(adm), dev)
    whole = F.assemble_feasibility(*adm_dev)
    plain_mask = P.assemble_feasibility_reference(*adm_dev, 0, len(step_p["sig_of"]), 0,
                                                  len(step_p["t_of"]))
    errs["assemble_feasibility"] = max_abs_err(torch, [whole], [plain_mask])
    if errs["assemble_feasibility"] != 0.0:
        fail("phase 15: assemble_feasibility differs from its plain version")
    step_args = P.to_device(tuple(plain_mask if k == "feas" else step_p[k] for k in (
        "req", "cnt", "maxper", "slot", "feas", "alloc", "price", "openable",
        "used0", "cfg0", "npods0", "next0", "sig0")), dev)
    step_args = step_args[:11] + (int(step_p["next0"]),) + step_args[12:]
    if max_abs_err(torch, step_out, P.pack_reference(*step_args)) != 0.0:
        fail("phase 15: sharded_solve_step differs from the plain pack of its mask")
    # the step's own tiles: one launch a device in place, the other
    # devices' tiles copied in
    G_s, C_s = len(step_p["sig_of"]), len(step_p["t_of"])
    plan = P.mesh_plan(mesh.devices, G_s, C_s, 4096)
    site = lambda: OBSERVATORY.snapshot()["transfer_bytes"].get(P.MESH_SITE, 0)
    counted, OBSERVATORY.enabled = OBSERVATORY.enabled, True
    bytes0, launches0 = site(), F.LAUNCHES["assemble_feasibility"]
    masks = F.mesh_assemble_feasibility(plan, {d: adm_dev for d in mesh.distinct()}, G_s, C_s)
    mask_bytes = site() - bytes0
    OBSERVATORY.enabled = counted
    mask_launches = F.LAUNCHES["assemble_feasibility"] - launches0
    for m in masks.values():
        errs["assemble_feasibility"] = max(errs["assemble_feasibility"],
                                           max_abs_err(torch, [m], [plain_mask]))
    if errs["assemble_feasibility"] != 0.0:
        fail("phase 15: the tiled assemble_feasibility differs from its plain version")
    n_dev = len(mesh.distinct())
    if mask_launches != n_dev or mask_bytes != (n_dev - 1) * G_s * C_s:
        fail(f"phase 15: the expansion on {n_dev} device(s) launched {mask_launches} times "
             f"and copied {mask_bytes} bytes")
    # unaligned, in place, several tiles a launch; and rows of 60,000 types
    cases, launches = assemble_cases(torch, adm_dev)
    wide_cases, wide_launches = assemble_cases(
        torch, P.to_device(T.assemble_arrays(C=300, S=4, T=60000), dev))
    cases.update({f"T 60,000 {k}": v for k, v in wide_cases.items()})
    launches += wide_launches
    bad = {k: v for k, v in cases.items() if v}
    if bad or set(launches) != {1}:
        fail(f"phase 15: assemble_feasibility differs from its plain version: {bad}, "
             f"launches a call {launches} (each must be 1)")
    print(f"  assemble_feasibility: whole and tiled bit-equal at Gp {G_s} Cp {C_s}; the "
          f"factorized step's expansion {mask_launches} launch(es) on {n_dev} device(s), mask "
          f"exchange bytes {mask_bytes} (copying every tile into every device's mask: "
          f"{n_dev * G_s * C_s}); bit-equal, the bytes outside each tile untouched, one "
          f"launch a call, in {len(cases)} unaligned, in-place and several-tile cases, at "
          f"the step's arrays and at T 60,000", flush=True)

    # ---- times at config 2 (and ffd_shard_scan at the live cluster) --------
    sst = single._resident.states[-1]
    sargs = sst.pack_args()
    lst = scheds["config2_live"]._resident.states[-1]
    largs = lst.pack_args()

    def packer(pack_args, pack=F.mesh_pack):
        def call():
            return pack(*PM.pack_layout(mesh, pack_args, site="mesh_smoke"))
        return call

    scan_pack, pair_pack = packer(margs), packer(margs, mesh_pair_pack)
    live_pack = packer(largs)

    def single_pack():
        return F.ffd_pack(*sargs)

    walls = {"ffd_shard_scan": [], "ffd_shard_pair": [], "ffd_pack": []}
    exch = {"s": 0.0}
    real_row = P.mesh_exchange_row

    def timed_row(*a):
        t = time.perf_counter()
        real_row(*a)
        exch["s"] += time.perf_counter() - t

    for _ in range(MESH_TIMED):  # in turns: the one-launch scan, the pair, ffd_pack
        for which, call in (("ffd_shard_scan", scan_pack), ("ffd_shard_pair", pair_pack),
                            ("ffd_pack", single_pack)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            call()
            torch.cuda.synchronize()
            walls[which].append((time.perf_counter() - t) * 1e3)
    P.mesh_exchange_row = timed_row
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        pair_pack()
        torch.cuda.synchronize()
        exch_wall = (time.perf_counter() - t) * 1e3
    finally:
        P.mesh_exchange_row = real_row
    per_solve = {}
    for which, call in (("ffd_shard_scan", scan_pack), ("ffd_shard_pair", pair_pack)):
        before = dict(F.LAUNCHES)
        call()
        torch.cuda.synchronize()
        per_solve[which] = {k: F.LAUNCHES[k] - before[k] for k in MESH_KERNELS
                            if F.LAUNCHES[k] - before[k]}
    by_events = set()  # the kernels the profiler missed, timed by CUDA events

    def events_for(timer):
        def fallback(missing):
            by_events.update(missing)
            return timer(missing)
        return fallback

    dev_ms = profiled_launches_ms(
        torch, scan_pack, ("choose_config_shard", "ffd_shard_scan"), 1,
        events_for(lambda missing: mesh_events_ms(torch, mesh, margs, missing)))
    dev_ms.update(profiled_launches_ms(
        torch, pair_pack, MESH_PAIR, 1,
        events_for(lambda missing: mesh_events_ms(torch, mesh, margs, missing))))
    live_missed = set()

    def live_events(missing):
        live_missed.update(missing)
        return mesh_events_ms(torch, mesh, largs, missing)

    live_ms = profiled_launches_ms(torch, live_pack, ("ffd_shard_scan",), 1,
                                   live_events)["ffd_shard_scan"]
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    busy = {}
    for which, call in (("ffd_shard_scan", scan_pack), ("ffd_shard_pair", pair_pack)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        b = c = 0.0
        for ev in prof.key_averages():
            us = _device_us(ev)
            if ev.device_type == DeviceType.CUDA and us > 0:
                b += us
                if "Memcpy" in ev.key or "memcpy" in ev.key:
                    c += us
        busy[which] = (b / 1e3, c / 1e3)
    step_dev = P.to_device(tuple(adm), dev)
    assemble = lambda: F.assemble_feasibility(*step_dev)
    dev_ms["assemble_feasibility"] = profiled_ms(
        torch, assemble, "assemble_feasibility", 3,
        events_for(lambda missing: {"assemble_feasibility": events_device_ms(torch, assemble, 20)}))
    assemble_floor, assemble_grid, floor_timer = assemble_floor_ms(torch, step_dev, 3)
    rep = [t.parts[mesh.rows[0]] for t in margs[:8]]
    b = P.split_bounds(st.Cp, mesh.shape[1])
    g1 = P.split_bounds(st.Gp, mesh.shape[0])[1]
    choose_args = (rep[0], rep[2], rep[4], rep[5], rep[6], rep[7], 0, g1, b[0], b[1])
    plain_ms = {
        "assemble_feasibility": cuda_ms(torch, lambda: P.assemble_feasibility_reference(
            *step_dev, 0, G_s, 0, C_s), 3),
        "choose_config_shard": cuda_ms(torch, lambda: P.choose_config_shard_reference(
            *choose_args), 3),
        "ffd_shard_scan": statistics.median(scan_plain_s) * 1e3,
        **{k: v[0] / v[1] * 1e3 for k, v in plain_s.items()},
    }
    # the same tile through the kernel, for its CUDA-event time
    event_ms = {"choose_config_shard": cuda_ms(torch, lambda: F.choose_config_shard(
        *choose_args), 20)}
    host_args = tuple(host_of(a) if hasattr(a, "host") else a for a in margs)
    live_host = tuple(host_of(a) if hasattr(a, "host") else a for a in largs)
    R_req = int((host_args[0] > 0).sum(1).max())
    plan_c2 = P.mesh_plan(mesh.devices, st.Gp, st.Cp, st.Kp)
    plan_live = P.mesh_plan(mesh.devices, lst.Gp, lst.Cp, lst.Kp)
    bounds = mesh_bounds(plan_c2, host_args, outs["config2"][1], R_req)
    bounds["assemble_feasibility"] = assemble_bound(step_p)
    bounds["ffd_shard_scan"] = mesh_scan_bound(torch, plan_c2, host_args, outs["config2"][1])
    live_bound = mesh_scan_bound(torch, plan_live, live_host, outs["config2_live"][1])
    # ffd_shard_scan's latency floor: a class a step, each step one exchange
    # and barrier of the cluster's CTAs and the class tiles' 2 / SCAN_TILE
    # dependent L2 loads (the slot chain inside a step is not in it)
    D = mesh.shape[0]
    shapes = {"config2": (st.Gp, max(np.diff(plan_c2.k_bounds))),
              "config2_live": (lst.Gp, max(np.diff(plan_live.k_bounds)))}
    probe = sorted({(D, F.scan_threads(int(kd))) for _, kd in shapes.values()})
    _, cluster_us, l2_us = probe_latencies(torch, [], probe)
    floors = {name: G * (cluster_us[(D, F.scan_threads(int(kd)))] + 2 / F.SCAN_TILE * l2_us) / 1e3
              for name, (G, kd) in shapes.items()}
    p50 = {k: statistics.median(v) for k, v in walls.items()}
    print(f"  config 2 per solve ({card}), in turns: ffd_shard_scan "
          f"{walls['ffd_shard_scan']!r} ms (p50 {p50['ffd_shard_scan']!r}), the pair "
          f"{walls['ffd_shard_pair']!r} ms (p50 {p50['ffd_shard_pair']!r}), single-device "
          f"ffd_pack {walls['ffd_pack']!r} ms (p50 {p50['ffd_pack']!r}); launches a solve "
          f"{json.dumps(per_solve)}; the pair's exchange host time {exch['s'] * 1e3!r} ms "
          f"of a {exch_wall!r} ms pack ({exch['s'] * 1e3 / exch_wall!r}); device busy and "
          f"copy ms a pack {json.dumps(busy)}", flush=True)
    print(f"  ffd_shard_scan latency probes ({card}): cluster exchange + barrier "
          f"{cluster_us!r} us (by CTAs, threads), dependent L2 load {l2_us!r} us; floor "
          f"config 2 {floors['config2']!r} ms ({shapes['config2'][0]} classes, Kd "
          f"{shapes['config2'][1]}), live cluster {floors['config2_live']!r} ms "
          f"({shapes['config2_live'][0]} classes, Kd {shapes['config2_live'][1]})", flush=True)
    print(f"  ffd_shard_scan at the live cluster: {live_ms!r} ms a launch "
          f"({'CUDA events' if live_missed else 'profiler'}), bound {live_bound}, "
          f"measured / floor {live_ms / floors['config2_live']!r}", flush=True)
    rows = {}
    phase_counts = dict(F.LAUNCHES)
    for k in MESH_KERNELS:
        rows[k] = {"ms": dev_ms[k], "plain_ms": plain_ms[k], "bound": bounds[k],
                   "err": errs[k], "launches": counts[k],
                   "forced_launches": phase_counts[k] - counts[k],
                   "per_solve": per_solve["ffd_shard_pair" if k in MESH_PAIR
                                          else "ffd_shard_scan"].get(k, 0)}
        rows[k]["timer"] = "events" if k in by_events else "profiler"
        how = ("CUDA events, the gaps between back-to-back launches included: the profiler "
               "saw none" if k in by_events else "profiler")
        print(f"  {k}: {dev_ms[k]!r} ms a launch ({how}), plain {plain_ms[k]!r} ms a "
              f"call, bound {bounds[k]}, {rows[k]['per_solve']} launches a config-2 solve"
              f"{' (the pair forced)' if k in MESH_PAIR else ''}, {counts[k]} on the main "
              f"path, {rows[k]['forced_launches']} more in this phase's checks"
              + (f", {event_ms[k]!r} ms (CUDA events)" if k in event_ms else ""), flush=True)
    rows["ffd_shard_scan"].update({
        "latency_floor_ms": floors["config2"], "live_ms": live_ms,
        "live_timer": "events" if live_missed else "profiler",
        "live_bound_ms": live_bound["bound_ms"], "live_bound_by": live_bound["bound_by"],
        "live_latency_floor_ms": floors["config2_live"]})
    print(f"  ffd_shard_scan measured / floor at config 2: "
          f"{dev_ms['ffd_shard_scan'] / floors['config2']!r}", flush=True)
    rows["assemble_feasibility"]["latency_floor_ms"] = assemble_floor
    print(f"  assemble_feasibility ({card}): a whole-mask launch at Gp {G_s} Cp {C_s} "
          f"{dev_ms['assemble_feasibility']!r} ms ({rows['assemble_feasibility']['timer']}), "
          f"an empty launch of its grid {list(assemble_grid)} {assemble_floor!r} ms "
          f"({floor_timer}), bound {bounds['assemble_feasibility']}, measured / bound "
          f"{dev_ms['assemble_feasibility'] / bounds['assemble_feasibility']['bound_ms']!r}; "
          f"{counts['assemble_feasibility']} launch(es) and {mask_bytes} mask exchange bytes "
          f"a factorized step on {n_dev} device(s)", flush=True)
    return {"rows": rows, "launches": counts, "solve_p50_ms": p50["ffd_shard_scan"],
            "pair_p50_ms": p50["ffd_shard_pair"], "single_p50_ms": p50["ffd_pack"]}


# ---------------------------------------------------------------------------
# Phase 16: the chart on the card
# ---------------------------------------------------------------------------


def chart_values(values: dict, tmp: str) -> dict:
    """``values`` and the two settings the phase sets: a cluster name, and
    the flight recorder's directory inside the phase's temporary one."""
    import os

    return {**values, "settings.cluster_name": "chip-smoke-chart",
            "settings.flight_dir": os.path.join(tmp, "flight")}


def chart_render(values: dict, chart: str = CHART_DIR) -> tuple:
    """The port's chart rendered by the port's renderer with ``values``:
    (each Deployment's container by its name, `chart_workloads`; the
    settings configmap's ``settings.json`` payload)."""
    import os

    import yaml

    from karpenter_tpu_torch.tools.render_chart import render_chart

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), chart)
    docs = [d for text in render_chart(path, dict(values))
            for d in yaml.safe_load_all(text) if d]
    (cm,) = [d for d in docs if d["kind"] == "ConfigMap"]
    return chart_workloads(docs), cm["data"]["settings.json"]


def chart_workloads(docs) -> dict:
    """Each rendered Deployment's one container by its name: the
    Deployment's replicas, ``argv`` (command + args), the memory limit
    (None without one), the accelerator limits and the env."""
    out = {}
    for d in docs:
        if d["kind"] != "Deployment":
            continue
        (c,) = d["spec"]["template"]["spec"]["containers"]
        limits = (c.get("resources") or {}).get("limits") or {}
        out[c["name"]] = {
            "replicas": int(d["spec"]["replicas"]),
            "argv": [str(a) for a in c["command"] + c.get("args", [])],
            "memory": limits.get("memory"),
            "accelerators": {k: v for k, v in limits.items() if k not in ("cpu", "memory")},
            "env": {e["name"]: str(e["value"]) for e in c.get("env", [])},
        }
    return out


def listen_ports(argv) -> list:
    """The ports a rendered container listens on (`CHART_PORT_FLAGS`)."""
    return [int(a.partition("=")[2]) for a in argv
            if a.partition("=")[0] in CHART_PORT_FLAGS]


def implicit_ports(name: str, argv) -> list:
    """The `CHART_IMPLICIT_PORTS` argument of container ``name`` where its
    argv does not name that flag, as a list of at most one argument."""
    arg = CHART_IMPLICIT_PORTS.get(name)
    flags = {a.partition("=")[0] for a in argv}
    return [arg] if arg and arg.partition("=")[0] not in flags else []


def map_argv(argv, ports: dict, mount: str) -> tuple:
    """A rendered container's argv as this host runs it: (the argv, the
    (argument, mapped argument) pairs that changed).  Only three things
    change: a service hostname (the host of a ``host:port`` value, and the
    bind-all address 0.0.0.0) becomes 127.0.0.1, a port becomes
    ``ports[port]`` (a port the map lacks raises ``KeyError``), and
    `CHART_MOUNT` becomes ``mount``."""
    import re

    out, changed = [], []
    for arg in argv:
        flag, eq, value = arg.partition("=")
        if eq:
            value = value.replace(CHART_MOUNT, mount)
            m = re.fullmatch(r"[A-Za-z0-9.-]+:(\d+)", value)
            if m:
                value = f"127.0.0.1:{ports[int(m.group(1))]}"
            elif value == "0.0.0.0":
                value = "127.0.0.1"
            elif flag in CHART_PORT_FLAGS:
                value = str(ports[int(value)])
        mapped = flag + eq + value
        out.append(mapped)
        if mapped != arg:
            changed.append((arg, mapped))
    return out, changed


def memory_bytes(quantity: str) -> int:
    """A Kubernetes memory quantity (``512Mi``, ``1.5Gi``, ``800M``,
    plain bytes) in bytes."""
    import re

    m = re.fullmatch(r"([0-9]+(?:\.[0-9]+)?)([KMGT]i?)?", str(quantity).strip())
    if not m:
        raise ValueError(f"not a memory quantity: {quantity!r}")
    unit = m.group(2) or ""
    scale = 2 ** (10 * "KMGT".index(unit[0]) + 10) if unit.endswith("i") else (
        10 ** (3 * "KMGT".index(unit) + 3) if unit else 1)
    return int(float(m.group(1)) * scale)


def proc_memory(pid: int) -> dict:
    """A live process's ``Vm*`` and ``Rss*`` lines of ``/proc/<pid>/status``
    in bytes (``VmHWM`` is the peak resident set, ``VmRSS`` the current one,
    ``RssAnon`` / ``RssFile`` its anonymous and file-backed parts; a kernel
    that does not keep one leaves it out)."""
    out = {}
    with open(f"/proc/{pid}/status") as f:
        for line in f:
            key, _, value = line.partition(":")
            if key.startswith(("Vm", "Rss")) and value.strip().endswith("kB"):
                out[key] = int(value.split()[0]) * 1024
    return out


def rss_over_limit(peaks: dict, limits: dict) -> list:
    """The processes whose peak RSS (bytes) passes their rendered memory
    limit (a quantity; None: no limit), by name."""
    return sorted(name for name, peak in peaks.items()
                  if limits.get(name) is not None and peak > memory_bytes(limits[name]))


def claims_multiset(claims: dict, nominated: dict) -> list:
    """A cluster's NodeClaims as a sorted multiset: ``claims`` maps a
    claim's name to its (instance type, zone, capacity type), ``nominated``
    a pod's key to the claim it was nominated to; one (instance type, zone,
    capacity type, sorted pod keys) a claim.  Claim names and instance ids
    follow launch order, so they are left out."""
    pods = {}
    for pod, claim in nominated.items():
        pods.setdefault(claim, []).append(pod)
    return sorted((*meta, tuple(sorted(pods.get(name, ())))) for name, meta in claims.items())


def multiset_diff(got, want) -> tuple:
    """(what ``got`` has beyond ``want``, what it lacks), each a sorted list."""
    from collections import Counter

    a, b = Counter(map(tuple, got)), Counter(map(tuple, want))
    return sorted((a - b).elements()), sorted((b - a).elements())


def chart_objects(n_pods: int) -> tuple:
    """What phase 16 puts in the store: config 2's default NodeClass, its
    ``general`` and tainted ``dedicated`` pools, and the first ``n_pods``
    of `heterogeneous_pods`, named ``chart-<i>`` so that the CPU twin
    builds the same keys."""
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.api import NodeClass, NodePool
    from karpenter_tpu_torch.api.objects import SelectorTerm

    node_class = NodeClass(name="default",
                           subnet_selector_terms=[SelectorTerm.of(Name="*")],
                           security_group_selector_terms=[SelectorTerm.of(Name="*")])
    pools = [NodePool(name="general", node_class_ref="default"),
             NodePool(name="dedicated", node_class_ref="default",
                      taints=[T.DEDICATED_TAINT])]
    pods = T.heterogeneous_pods(n_pods)
    for i, pod in enumerate(pods):
        pod.name = f"chart-{i:05d}"
    return node_class, pools, pods


def chart_twin(n_pods: int, payload: str, ticks: int = 8) -> dict:
    """The CPU twin of phase 16's leader: the port's in-process
    `Operator(device="cpu")` over a fake cloud built as the entry point
    builds it (`generate_catalog()`, the default topology; a fake clock),
    with the rendered settings, the same objects (`chart_objects`), ticks
    of 2 s until every pod is nominated.  Returns its claims multiset
    (`claims_multiset`) and the ticks it took."""
    import json as _json

    from karpenter_tpu_torch.api.settings import Settings
    from karpenter_tpu_torch.cloud.fake.backend import FakeCloud, generate_catalog
    from karpenter_tpu_torch.metrics.registry import Registry
    from karpenter_tpu_torch.operator import Operator
    from karpenter_tpu_torch.state.kube import KubeStore
    from karpenter_tpu_torch.utils.clock import FakeClock

    settings = Settings(**_json.loads(payload))
    cloud = FakeCloud(FakeClock(), shapes=generate_catalog()).with_default_topology()
    kube = KubeStore()
    op = Operator(cloud, kube, settings=settings, registry=Registry(), device="cpu")
    node_class, pools, pods = chart_objects(n_pods)
    kube.put_node_class(node_class)
    for pool in pools:
        kube.put_node_pool(pool)
    for pod in pods:
        kube.put_pod(pod)
    keys = {p.key() for p in pods}
    for tick in range(1, ticks + 1):
        cloud.clock.step(2.0)
        op.reconcile_once()
        nominated = dict(op.cluster.nominations())
        if keys <= nominated.keys():
            break
    else:
        raise RuntimeError(f"the CPU twin nominated {len(nominated)} of {n_pods} pods "
                           f"in {ticks} ticks")
    claims = {c.name: (c.instance_type_name, c.zone, c.capacity_type)
              for c in kube.node_claims.values()}
    return {"claims": claims_multiset(claims, {k: nominated[k] for k in keys}), "ticks": tick}


class EventFollower:
    """A thread that pages one controller's ``/events`` forward by its
    ``since_seq`` cursor, as a dashboard would, and keeps each
    ``NodeLaunched`` claim with the time it was read and each pod's first
    ``PodNominated`` claim; ``dropped`` counts the events the ledger's ring
    evicted before a page read them."""

    def __init__(self, port: int):
        import threading

        self.port, self.seq, self.dropped = port, 0, 0
        self.launched, self.nominated = {}, {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            self.poll()
            self._stop.wait(0.01)

    def poll(self) -> None:
        body = scrape(self.port, f"/events?since_seq={self.seq}&limit=1000000")
        if not body:
            return
        page = json.loads(body)
        self.dropped += page["dropped"]
        for ev in page["events"]:
            attrs = ev["attrs"]
            if ev["type"] == "NodeLaunched":
                self.launched.setdefault(attrs["claim"], time.perf_counter())
            elif ev["type"] == "PodNominated":
                self.nominated.setdefault(attrs["pod"], attrs["node"])
        self.seq = page["last_seq"]

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()


def wait_listening(port: int, proc, label: str, deadline: float) -> None:
    """Until ``port`` on 127.0.0.1 accepts a connection; fails if the
    process exits or the deadline passes."""
    import socket

    while time.perf_counter() < deadline:
        if proc.poll() is not None:
            fail(f"phase 16: {label} exited {proc.returncode} before listening on {port}")
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return
        except OSError:
            time.sleep(0.1)
    fail(f"phase 16: {label} did not listen on {port} in time")


def prom_value(body: str, name: str, labels: str = "") -> float:
    """One sample of a Prometheus exposition (``labels`` as printed, e.g.
    ``{phase="pack"}``), 0.0 where it is absent."""
    for line in body.splitlines():
        if line.startswith(name + labels + " "):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def chart_topology(n_pods: int = CHART_PODS, values=None, extra_args=None, twin=None,
                   on_card: bool = True, deadline_s: float = CHART_DEADLINE_S) -> dict:
    """Phase 16 as the module docstring lists it: the port's chart rendered
    with ``values`` (default `CHART_VALUES`), its settings payload written
    to a temporary directory, and each Deployment's container started as a
    process from its rendered argv (`map_argv`; ``extra_args`` by container
    name are appended, as the CPU test asks for ``--device=cpu``), the
    store first, then config 2's objects through one `RemoteKubeStore`
    client, the solver, and the rendered controller replicas.  ``twin``
    returns the CPU twin's readings (default `chart_twin` in this
    process).  ``on_card``: the solver runs on the card, so its
    ``/debug/device`` must show ``choose_config`` and a scan launched.
    Fails on any of the holds; returns the readings.  Every process it
    started has ended when it returns."""
    import os
    import signal
    import tempfile

    from karpenter_tpu_torch.api.settings import Settings
    from karpenter_tpu_torch.metrics.registry import Registry
    from karpenter_tpu_torch.state.remote import RemoteKubeStore

    repo = os.path.dirname(os.path.abspath(__file__))
    extra_args = extra_args or {}
    t_phase = time.perf_counter()
    deadline = t_phase + deadline_s
    procs, followers, client = {}, {}, None
    with tempfile.TemporaryDirectory(prefix="chart-") as tmp:
        values = chart_values(CHART_VALUES if values is None else values, tmp)
        workloads, payload = chart_render(values)
        with open(os.path.join(tmp, "settings.json"), "w") as f:
            f.write(payload)
        settings = Settings.from_file(os.path.join(tmp, "settings.json"))
        print(f"    rendered {CHART_DIR} with {json.dumps(values)}: "
              + ", ".join(f"{name} x{w['replicas']}" for name, w in workloads.items()),
              flush=True)

        def bound(name: str) -> list:  # the ports the container listens on
            argv = workloads[name]["argv"]
            return listen_ports(argv + implicit_ports(name, argv))

        shared = {p: free_port() for name in ("store", "solver") for p in bound(name)}

        def sample(p: dict) -> None:  # the peaks of the process's memory lines
            try:
                mem = proc_memory(p["proc"].pid)
            except OSError:
                return
            for key, value in mem.items():
                p["vm"][key] = max(p["vm"].get(key, 0), value)

        def start(label: str, name: str, ports: dict):
            w = workloads[name]
            implicit = implicit_ports(name, w["argv"])
            argv, changed = map_argv(w["argv"] + implicit, ports, tmp)
            argv = [sys.executable if a == "python" and i == 0 else a
                    for i, a in enumerate(argv)] + list(extra_args.get(name, ()))
            out = open(os.path.join(tmp, f"{label}.out"), "w")
            err = open(os.path.join(tmp, f"{label}.err"), "w")
            proc = subprocess.Popen(argv, cwd=repo, stdout=out, stderr=err,
                                    env={**os.environ, **w["env"]})
            procs[label] = {"proc": proc, "memory": w["memory"], "err": err.name, "vm": {}}
            print(f"    {label}: {' '.join(w['argv'])}"
                  + (f" (and its default {' '.join(implicit)})" if implicit else "")
                  + f"; limits: memory {w['memory'] or 'none'}, {json.dumps(w['accelerators'])}",
                  flush=True)
            print(f"      mapped: {json.dumps(changed)}; python -> {sys.executable}"
                  + (f"; appended {extra_args[name]}" if name in extra_args else "")
                  + (f"; env {json.dumps(w['env'])}" if w["env"] else ""), flush=True)
            return proc

        try:
            store = start("store", "store", shared)
            store_port = shared[bound("store")[0]]
            wait_listening(store_port, store, "the store", deadline)
            t0 = time.perf_counter()
            client = RemoteKubeStore("127.0.0.1", store_port, identity="chip-smoke-loader",
                                     codec=settings.store_codec, registry=Registry())
            while not all(ch.ever_synced for ch in client._channels):
                if time.perf_counter() > deadline:
                    fail("phase 16: the loader's watch never synced")
                time.sleep(0.01)
            node_class, pools, pods = chart_objects(n_pods)
            client.put_node_class(node_class)
            for pool in pools:
                client.put_node_pool(pool)
            for pod in pods:
                client.put_pod(pod)
            if not client.wait_synced(timeout=60.0):
                fail("phase 16: the loader's mirror did not sync after the puts")
            load_s = time.perf_counter() - t0
            print(f"    put the NodeClass, {len(pools)} pools and {n_pods} pods through one "
                  f"RemoteKubeStore client in {load_s!r} s", flush=True)
            solver = start("solver", "solver", shared)
            for p in bound("solver"):
                wait_listening(shared[p], solver, "the solver", deadline)
            ctrl_ports = {}
            t_controllers = time.perf_counter()
            for i in range(workloads["controller"]["replicas"]):
                own = {p: free_port() for p in bound("controller")}
                start(f"controller-{i}", "controller", {**shared, **own})
                (ctrl_ports[f"controller-{i}"],) = own.values()
                followers[f"controller-{i}"] = EventFollower(ctrl_ports[f"controller-{i}"])
            keys = {p.key() for p in pods}
            led, leaders = set(), []
            while True:
                for label, p in procs.items():
                    if p["proc"].poll() is not None:
                        with open(p["err"]) as f:
                            tail = f.read()[-3000:]
                        fail(f"phase 16: {label} exited {p['proc'].returncode}: {tail}")
                    sample(p)
                leaders = []
                for label, port in ctrl_ports.items():
                    body = scrape(port, "/metrics")
                    if body is not None and metric_sum(
                            body, "karpenter_leader_election_leading") == 1.0:
                        leaders.append(label)
                led.update(leaders)
                done = [lb for lb, fo in followers.items() if keys <= fo.nominated.keys()]
                if done and len(leaders) == 1:
                    break
                if time.perf_counter() > deadline:
                    fail(f"phase 16: in {deadline_s} s "
                         + ", ".join(f"{lb} nominated {len(fo.nominated)} of {n_pods}"
                                     for lb, fo in followers.items())
                         + f"; leaders {leaders}")
                time.sleep(0.2)
            nominated_s = time.perf_counter() - t_controllers
            (leader,) = leaders
            if len(led) != 1:
                fail(f"phase 16: more than one controller led: {sorted(led)}")
            fo = followers[leader]
            if fo.dropped:
                fail(f"phase 16: the leader's event ring evicted {fo.dropped} events before "
                     f"/events read them")
            first_claim_s = min(fo.launched.values()) - t_controllers
            if not client.wait_synced(timeout=30.0):
                fail("phase 16: the loader's mirror did not sync after the solve")
            claims = {c.name: (c.instance_type_name, c.zone, c.capacity_type)
                      for c in client.node_claims.values()}
            if set(claims) != set(fo.launched):
                fail(f"phase 16: the store holds {len(claims)} NodeClaims, the leader "
                     f"launched {len(fo.launched)}")
            got = claims_multiset(claims, {k: fo.nominated[k] for k in keys})
            metrics = scrape(ctrl_ports[leader], "/metrics") or ""
            healthz = scrape(ctrl_ports[leader], "/healthz")
            if not metrics or healthz is None:
                fail("phase 16: the leader's /metrics or /healthz did not answer")
            (telemetry,) = (shared[int(a.partition("=")[2])] for a in workloads["solver"]["argv"]
                            if a.startswith("--telemetry-port="))
            solver_device = json.loads(scrape(telemetry, "/debug/device") or "{}")
            ctrl_device = {lb: json.loads(scrape(port, "/debug/device") or "{}")
                           for lb, port in ctrl_ports.items()}
            for p in procs.values():
                sample(p)
            limits = {lb: p["memory"] for lb, p in procs.items()}
            # SIGTERM: the standby, then the leader, the solver, the store
            order = [lb for lb in ctrl_ports if lb != leader] + [leader, "solver", "store"]
            client.close()
            client = None
            rcs = {}
            for lb in order:
                procs[lb]["proc"].send_signal(signal.SIGTERM)
                try:
                    rcs[lb] = procs[lb]["proc"].wait(timeout=CHART_STOP_S)
                except subprocess.TimeoutExpired:
                    rcs[lb] = None
        finally:
            for fo in followers.values():
                fo.stop()
            if client is not None:
                client.close()
            for p in procs.values():
                if p["proc"].poll() is None:
                    p["proc"].kill()
                    p["proc"].wait()
        bad = {lb: rc for lb, rc in rcs.items() if rc != 0}
        if bad:
            tails = {}
            for lb in bad:
                with open(procs[lb]["err"]) as f:
                    tails[lb] = f.read()[-1500:]
            fail(f"phase 16: SIGTERM did not end with exit code 0: {bad}: {tails}")
    # the peak: VmHWM where the kernel keeps it, else the largest VmRSS
    # sampled (wait4's ru_maxrss would count the launching process's own
    # resident set, which a child keeps as its high-water mark across exec)
    peaks = {lb: max(p["vm"].get("VmHWM", 0), p["vm"].get("VmRSS", 0))
             for lb, p in procs.items()}
    memory = {lb: {"VmHWM": p["vm"].get("VmHWM"), "VmRSS_max_sampled": p["vm"].get("VmRSS"),
                   **{k: v for k, v in p["vm"].items() if k.startswith("Rss")}}
              for lb, p in procs.items()}
    want = (twin or (lambda: chart_twin(n_pods, payload)))()
    extra, missing = multiset_diff(got, want["claims"])
    if extra or missing:
        fail(f"phase 16: the claims differ from the CPU twin's: {len(extra)} not in the twin "
             f"(first {extra[:2]}), {len(missing)} missing (first {missing[:2]})")
    for lb, peak in peaks.items():
        print(f"    {lb} peak RSS {peak} bytes ({peak / 2 ** 20!r} MiB) against its rendered "
              f"memory limit {limits[lb] or 'none'} (VmHWM, and the largest VmRSS sampled "
              f"every 0.2 s: {json.dumps(memory[lb])})", flush=True)
    over = rss_over_limit(peaks, limits)
    if over:
        fail("phase 16: peak RSS past the rendered memory limit: "
             + ", ".join(f"{lb} {peaks[lb]} bytes > {limits[lb]}" for lb in over))
    launches = solver_device.get("launches", {})
    if on_card and not (launches.get("choose_config")
                        and any(launches.get(k) for k in SCAN_KERNELS)):
        fail(f"phase 16: the solver's /debug/device shows no choose_config and scan "
             f"launched: {launches}")
    for lb, d in ctrl_device.items():
        packed = {k: n for k, n in d.get("launches", {}).items()
                  if k in ("choose_config", *SCAN_KERNELS)}
        if packed:
            fail(f"phase 16: {lb} packed on its own card with --solver-address: {packed}")
    return {
        "leader": leader, "nominated": len(keys), "claims": len(got),
        "load_s": load_s, "first_claim_s": first_claim_s, "nominated_s": nominated_s,
        "solve_s": prom_value(metrics, "karpenter_provisioner_scheduling_duration_seconds_sum"),
        "solves": prom_value(metrics, "karpenter_provisioner_scheduling_duration_seconds_count"),
        "phases_s": {ph: prom_value(metrics, "karpenter_solver_phase_seconds_sum",
                                    f'{{phase="{ph}"}}')
                     for ph in ("delta", "partition", "compile", "pad", "dispatch",
                                "device_block", "oracle", "decode", "other")},
        "peaks": peaks, "memory": memory, "limits": limits, "rcs": rcs,
        "solver_launches": launches,
        "solver_dispatches": solver_device.get("dispatches", {}),
        "controller_launches": {lb: d.get("launches", {}) for lb, d in ctrl_device.items()},
        "controller_uploads": {lb: d.get("transfer_bytes", {}) for lb, d in ctrl_device.items()},
        "twin_ticks": want["ticks"], "seconds": time.perf_counter() - t_phase,
    }


def chart_twin_process(payload: str, _phases, conn) -> None:
    """`chart_twin` at `CHART_PODS` in a process of its own (`CpuTwins`),
    its readings sent back through ``conn`` as ``("chart", readings)``, or
    ``("error", text)``."""
    import traceback

    import torch

    torch.set_num_threads(CPU_TWIN_THREADS)
    try:
        t0 = time.perf_counter()
        conn.send(("chart", dict(chart_twin(CHART_PODS, payload),
                                 seconds=time.perf_counter() - t0)))
    except Exception:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def chart_phase(torch, card) -> dict:
    """Phase 16 as the module docstring lists it; the CPU twin runs in a
    spawned process beside the processes on the card.  Returns the
    solver's launches by kernel."""
    import functools
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        _, payload = chart_render(chart_values(CHART_VALUES, tmp))
    twins = CpuTwins((16,), target=functools.partial(chart_twin_process, payload))
    try:
        r = chart_topology(twin=lambda: twins.get("chart"))
    finally:
        twins.close()
    standby = [lb for lb in r["rcs"] if lb.startswith("controller-") and lb != r["leader"]]
    print(f"    one leader: {r['leader']} (standby {', '.join(standby) or 'none'})", flush=True)
    print(f"    all {r['nominated']} pods nominated; the {r['claims']} NodeClaims' multiset of "
          f"(instance type, zone, capacity type, pods) equals the CPU twin's "
          f"({r['twin_ticks']} ticks of 2 s of fake clock)", flush=True)
    print(f"    the solver's launches by kernel on the card (/debug/device, {card}): "
          f"{json.dumps(r['solver_launches'])}; its dispatches {json.dumps(r['solver_dispatches'])}",
          flush=True)
    print(f"    the controllers' launches on their cards: {json.dumps(r['controller_launches'])}; "
          f"uploads {json.dumps(r['controller_uploads'])}", flush=True)
    print(f"    {r['first_claim_s']!r} s from the controllers' start to the leader's first "
          f"NodeClaim, {r['nominated_s']!r} s to the last nomination; the loader put the "
          f"objects in {r['load_s']!r} s", flush=True)
    print(f"    the leader's solve: {r['solve_s']!r} s wall over {r['solves']!r} solve(s) "
          f"(karpenter_provisioner_scheduling_duration_seconds), phases s "
          f"{json.dumps(r['phases_s'])} ({card})", flush=True)
    print(f"    SIGTERM exit codes: {json.dumps(r['rcs'])}", flush=True)
    print(f"  the topology took {r['seconds']!r} s", flush=True)
    return dict(r["solver_launches"])


# ---------------------------------------------------------------------------
# Phase 17: the rest of bench.py's solve problems
# ---------------------------------------------------------------------------


def config_problems() -> dict:
    """Phase 17's problems at full scale, by the port's problem functions: name ->
    ``(pools, inventory, pods, existing)``."""
    from karpenter_tpu_torch import testing as T

    build = {
        "config3": T.affinity_topology_problem,
        "config5": T.multipool_spot_problem,
        **{f"coloc-{v}": (lambda v=v: T.coloc_problem(v)) for v in T.COLOC_VARIANTS},
        "relax": T.relax_problem,
        "hybrid": T.hybrid_problem,
        "resident100k": T.resident_100k_problem,
    }
    out = {}
    for name in CONFIG_PROBLEMS:
        spec = tuple(build[name]())
        out[name] = spec + ((),) * (4 - len(spec))
    return out


def main_path_args(torch, spec):
    """The card tensors a cold ``TorchScheduler.solve`` hands the pack (the
    arguments of its last ``fused_packer.ffd_pack`` call): the resident
    tensors where the solve seeds them, else the padded upload."""
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.scheduling.solver import TorchScheduler

    pools, inv, pods, existing = spec
    calls, real = [], F.ffd_pack

    def recorded(*args, **kw):
        calls.append(args)
        return real(*args, **kw)

    F.ffd_pack = recorded
    try:
        TorchScheduler(pools, inv, existing=existing, device="cuda").solve(pods)
        torch.cuda.synchronize()
    finally:
        F.ffd_pack = real
    if not calls:
        fail("a cold solve on the card launched no pack")
    return calls[-1]


def config_checks(name, sched, result, n_pods, moved, objective) -> None:
    """One of phase 17's solves: every pod placed, the JAX package's path,
    continuation and relaxed count, and ``choose_config`` and the picked
    scan launched once each (no other scan)."""
    label = f"{name} ({objective})"
    placed = sum(len(n.pods) for n in result.new_nodes) + len(result.existing_placements)
    if placed != n_pods or result.unschedulable:
        fail(f"{label}: placed {placed} of {n_pods} pods")
    got = (sched.last_path, sched.last_continuation, sched.last_compile_relaxed)
    if got != CONFIG_EXPECT[name] or sched.last_kernel != "cuda_ffd":
        fail(f"{label}: path, continuation, relaxed {got} on {sched.last_kernel}, "
             f"expected {CONFIG_EXPECT[name]} on cuda_ffd")
    want = {"choose_config": 1, CONFIG_SCAN[name]: 1}
    if {k: v for k, v in moved.items() if v} != want:
        fail(f"{label}: a solve launched {moved}, expected {want}")


def drive_config(torch, name, spec, objective, rng) -> dict:
    """Phase 17 on one problem and objective: `CONFIG_SOLVES` of each kind
    on one scheduler on the card, each held by `config_checks`.  Returns
    per kind the timed milliseconds and the last solve's phases, and the
    launches by kernel."""
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.scheduling.solver import TorchScheduler

    pools, inv, pods, existing = spec
    sched = TorchScheduler(pools, inv, existing=existing, objective=objective,
                           device="cuda")
    kinds = ("cold", "hit", "delta") if name == CONFIG_DELTA else ("cold", "hit")
    times, phases, total = {k: [] for k in kinds}, {}, {k: 0 for k in KERNELS}
    warmup, timed = CONFIG_SOLVES
    for kind in kinds:
        for i in range(warmup + timed):
            if kind == "delta":
                pods = churn(rng, pods, (), n=len(pods) // CONFIG_DELTA_SHARE)
            before, hits = dict(F.LAUNCHES), sched.compile_cache_hits
            t0 = time.perf_counter()
            result = cold_solve(sched, pods) if kind == "cold" else sched.solve(pods)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            moved = {k: F.LAUNCHES[k] - before[k] for k in KERNELS}
            for k, v in moved.items():
                total[k] += v
            if i >= warmup:
                times[kind].append(ms)
            config_checks(name, sched, result, len(pods), moved, objective)
            if (kind == "hit") != (sched.compile_cache_hits > hits):
                fail(f"{name}: a {kind} solve was {'not ' if kind == 'hit' else ''}"
                     f"a compile-cache hit")
            if kind == "delta":
                if not sched.last_resident or sched.last_delta_rows <= 0:
                    fail(f"{name}: a delta tick did not pack from the resident tensors "
                         f"({sched.last_delta_rows} rows)")
                check_mirrors(torch, name, sched._resident.states[-1])
        phases[kind] = dict(sched.last_phases)
        if kind == "hit" and canonical(result) != cold:
            fail(f"{name}: a compile-cache hit decoded another result than the cold solve")
        if kind == "cold":
            cold = canonical(result)
        if kind != "hit":
            cpu_equal(f"{name} ({objective})", f"last {kind}", spec, pods, result, objective)
    return {"times": times, "phases": phases, "launches": total,
            "resident": sched.last_resident}


def repack_decision(dc, candidates) -> dict:
    """One ``dc._simulate(candidates)`` of either package as plain data:
    whether the pods fit, the replacement's price and canonical node, the
    removed nodes, and the canonical result of the repack's solve."""
    from karpenter_tpu_torch import testing as T

    sched, results = dc._scheduler, []
    solve = sched.solve

    def recorded(pods, *a, **kw):
        results.append(solve(pods, *a, **kw))
        return results[-1]

    sched.solve = recorded
    try:
        fits, price, vn = dc._simulate(candidates)
    finally:
        del sched.solve
    return {
        "fits": fits,
        "price": price,
        "replacement": None if vn is None else T.canonical_node(vn),
        "removed": sorted(c.state.name for c in candidates),
        "repack": canonical(results[-1]) if results else None,
        "path": sched.last_path,
    }


def drive_repack(torch, device: str) -> dict:
    """Config 4 on ``device``: the settled cluster of
    ``testing.consolidation_repack``, then `REPACK_SIMULATIONS` calls of
    ``_simulate`` over every candidate.  Returns the decision, the timed
    milliseconds, the last call's phases and the launches of the calls."""
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.ops import fused_packer as F

    dc, candidates = T.consolidation_repack(device)
    warmup, timed = REPACK_SIMULATIONS
    before, times = dict(F.LAUNCHES), []
    for i in range(warmup + timed):
        t0 = time.perf_counter()
        decision = repack_decision(dc, candidates)
        if device == "cuda":
            torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    return {"decision": decision, "times": times, "phases": dict(dc._scheduler.last_phases),
            "kernel": dc._scheduler.last_kernel,
            "launches": {k: F.LAUNCHES[k] - before[k] for k in KERNELS}}


def configs_phase(torch, card, specs) -> dict:
    """Phase 17 as the module docstring lists it: each problem's pack
    shapes (a cold card solve's `main_path_args`, whose scan the shape rule
    must pick as `CONFIG_SCAN` says), then its drives.  Returns the
    launches by kernel of its drives and of the repack's simulations."""
    import random

    rng = random.Random(17)
    launches = {k: 0 for k in KERNELS}
    from karpenter_tpu_torch.ops import fused_packer as F

    max_clusters = F.grid_clusters(torch.cuda.current_device())
    for name, spec in specs.items():
        args = main_path_args(torch, spec)
        shapes = pack_shapes(args)
        if F.scan_kernel(*shapes) != CONFIG_SCAN[name]:
            fail(f"{name}: the shape rule picks {F.scan_kernel(*shapes)}, expected "
                 f"{CONFIG_SCAN[name]}")
        print(f"  {name}: {len(spec[2])} pods, {len(spec[3])} live nodes; the pack's "
              f"Gp={args[0].shape[0]} ({int((args[1] > 0).sum())} classes) Cp={shapes[3]} "
              f"Kp={shapes[0]} R={shapes[1]} S={shapes[2]} next0={args[11]}: "
              f"{CONFIG_SCAN[name]}{layout_note(shapes, CONFIG_SCAN[name], max_clusters)}", flush=True)
        for objective in CONFIG_OBJECTIVES.get(name, ("nodes",)):
            t0 = time.perf_counter()
            print(f"  {name} ({objective}):", flush=True)
            run = drive_config(torch, name, spec, objective, rng)
            for k, v in run["launches"].items():
                launches[k] += v
            for kind, ts in run["times"].items():
                print(f"    {kind}: p50_ms={statistics.median(ts)!r} min_ms={min(ts)!r} "
                      f"max_ms={max(ts)!r} ({card})")
                print(f"      last_phases_ms="
                      f"{json.dumps({k: v * 1e3 for k, v in sorted(run['phases'][kind].items())})}")
            print(f"    launches {json.dumps({k: v for k, v in run['launches'].items() if v})}; "
                  f"resident={run['resident']}; {time.perf_counter() - t0:.3f} s", flush=True)
    t0 = time.perf_counter()
    print("  config4 repack: _simulate over every candidate", flush=True)
    card_run = drive_repack(torch, "cuda")
    cpu_run = drive_repack(torch, "cpu")
    d = card_run["decision"]
    if card_run["kernel"] != "cuda_ffd" or not card_run["launches"]["choose_config"]:
        fail(f"config4: the repack ran {card_run['kernel']} with launches "
             f"{card_run['launches']}")
    if d != cpu_run["decision"]:
        fail("config4: the card's repack decision differs from the CPU's")
    for k, v in card_run["launches"].items():
        launches[k] += v
    ts = card_run["times"]
    print(f"    decision: fits={d['fits']} price={d['price']!r} removed {len(d['removed'])} "
          f"nodes, the repack {len(d['repack'][0])} new nodes on path {d['path']}; equals the "
          f"CPU's")
    print(f"    _simulate: p50_ms={statistics.median(ts)!r} min_ms={min(ts)!r} "
          f"max_ms={max(ts)!r} ({card}); CPU p50_ms={statistics.median(cpu_run['times'])!r}")
    print(f"      last_phases_ms="
          f"{json.dumps({k: v * 1e3 for k, v in sorted(card_run['phases'].items())})}")
    print(f"    launches {json.dumps({k: v for k, v in card_run['launches'].items() if v})}; "
          f"{time.perf_counter() - t0:.3f} s")
    print(f"  phase 17 launches {json.dumps({k: v for k, v in launches.items() if v})}")
    return launches


# ---------------------------------------------------------------------------
# Phase 18: bench.py's device lines
# ---------------------------------------------------------------------------


def hashed_trace():
    """A simulator `TraceWriter` that keeps a running sha256 of its lines
    (each line and its newline, so ``sha256()`` is ``TraceWriter``'s of the
    same run) and their count and bytes, not the lines: the million-event
    run's trace would hold about a million of them.  ``digest_s`` sums the
    wall seconds of its per-tick state digests."""
    import hashlib

    from karpenter_tpu_torch.sim.trace import TraceWriter, _dumps

    class HashedTrace(TraceWriter):
        def __init__(self):
            super().__init__(None)
            self._sha = hashlib.sha256()
            self.lines = self.nbytes = 0
            self.digest_s = 0.0

        def _write(self, obj: dict) -> None:
            line = (_dumps(obj) + "\n").encode()
            with self._lock:
                self._sha.update(line)
                self.lines += 1
                self.nbytes += len(line)

        def digest(self, tick: int, env) -> None:
            t0 = time.perf_counter()
            super().digest(tick, env)
            self.digest_s += time.perf_counter() - t0

        def text(self) -> str:
            raise RuntimeError("a hashed trace keeps no lines")

        def sha256(self) -> str:
            with self._lock:
                return self._sha.hexdigest()

    return HashedTrace()


def state_digests(states) -> list:
    """Each tick's state (`testing.pipeline_state`) as a sha256 hex digest:
    what phase 18 sends between its processes and compares."""
    import hashlib

    return [hashlib.sha256(repr(state).encode()).hexdigest() for state in states]


def bench_line_twins(lines, conn) -> None:
    """Phase 18's CPU drives of ``lines`` (of `BENCH_TWIN_GROUPS`), in a
    process of their own (`CpuTwins` with this target), each at full scale
    and sent back through ``conn`` as ``(line, readings)``, or ``("error",
    text)``: the admission drive, the sequential pipelined drive (its
    states as `state_digests`), the load harness with a `hashed_trace`.
    Each message stays small: a send blocks while the pipe is full, and the
    phase reads the pipe only after its own drives."""
    import traceback

    import torch

    from karpenter_tpu_torch import testing as T

    torch.set_num_threads(CPU_TWIN_THREADS)
    try:
        if "admission" in lines:
            t0 = time.perf_counter()
            adm = T.admission_drive("cpu")
            conn.send(("admission", {"nodes": adm["nodes"], "outcomes": adm["outcomes"],
                                     "p50_ms": adm["p50_ms"], "p99_ms": adm["p99_ms"],
                                     "seconds": time.perf_counter() - t0}))
        if "pipelined" in lines:
            t0 = time.perf_counter()
            seq = T.pipelined_tick_drive("cpu", False)
            conn.send(("pipelined", {"states": state_digests(seq["states"]),
                                     "p50_ms": seq["p50_ms"],
                                     "seconds": time.perf_counter() - t0}))
        if "load" in lines:
            trace = hashed_trace()
            load = T.load_harness_drive("cpu", trace=trace)
            conn.send(("load", {**{k: v for k, v in load.items() if k != "report"},
                                "sha256": trace.sha256(), "lines": trace.lines,
                                "bytes": trace.nbytes, "digest_s": trace.digest_s}))
    except Exception:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def first_difference(a: list, b: list):
    """The first index at which two lists differ (the shorter's length
    where one is a prefix of the other), or None."""
    at = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
    return None if at == len(a) == len(b) else at


def kineto_events(prof) -> list:
    """The profiler's raw events as ``(name, on_device, start_us, end_us,
    correlation)``: on the host, ops, ranges and CUDA runtime calls; on the
    device, kernels and copies (not the ranges' copies on the device's
    timeline).  A runtime call and the device work it enqueued share a
    correlation id."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.profiler.kineto_results.events():
        on_device = ev.device_type() == DeviceType.CUDA
        if on_device and ev.is_user_annotation():
            continue  # a record_function range drawn on the device's timeline
        start = ev.start_ns() / 1e3
        out.append((ev.name(), on_device, start, start + ev.duration_ns() / 1e3,
                    ev.correlation_id()))
    return out


def upload_waits(events, ticks) -> dict:
    """For each tick of ``ticks`` in a profiled pipelined drive (its host
    range the ``TICK_RANGE`` event of `kineto_events`' ``events``): the
    device work enqueued before the tick began and still running at its
    start (``in_flight_ms``, 0 where none), and the tick's first
    host-to-device copy: its device start less the moment the host enqueued
    it (``enqueue_to_start_ms``), the device work enqueued before it and still
    running then (``pending_ms``), and ``waited``, true where the copy
    started only as that work ended (within 2 us).  A tick with no copy
    has ``upload`` None.  Device work counts only through a runtime call
    of the same correlation id (not 0) enqueued before it started."""
    host = {}
    for name, on_device, start, end, corr in events:
        if not on_device and corr > 0 and name.startswith(RUNTIME_PREFIX):
            host[corr] = (start, end)
    device = []  # (enqueued at, device start, device end, name)
    for name, on_device, start, end, corr in events:
        if on_device and corr in host and start >= host[corr][0]:
            device.append((host[corr][0], start, end, name))
    device.sort()
    spans = {int(name[len(TICK_RANGE):]): (start, end) for name, on_device, start, end, _
             in events if not on_device and name.startswith(TICK_RANGE)}
    out = {}
    for t in ticks:
        if t not in spans:
            continue
        s, e = spans[t]
        before = [d for d in device if d[0] < s and d[2] > s]
        first = next((d for d in device if s <= d[0] <= e and d[3].startswith(UPLOAD_EVENT)),
                     None)
        row = {"in_flight_ms": (max(d[2] for d in before) - s) / 1e3 if before else 0.0,
               "upload": None}
        if first is not None:
            enqueued, ds = first[0], first[1]
            pending = [d[2] for d in device if d[0] < enqueued and d[2] > enqueued]
            pending_end = max(pending) if pending else enqueued
            row["upload"] = {"enqueue_to_start_ms": (ds - enqueued) / 1e3,
                             "pending_ms": (pending_end - enqueued) / 1e3,
                             "waited": bool(pending) and ds >= pending_end - 2.0}
        out[t] = row
    return out


def profile_window(adopted: list, ticks: int, most: int = PROFILED_TICKS) -> tuple:
    """The ticks (first, last) phase 18 profiles: the longest run of
    consecutive adopting ticks (the first such run on a tie), from the tick
    before it to the tick after it, at most ``most`` ticks, within the
    drive's ``ticks``; None where nothing was adopted."""
    runs, start = [], None
    for i, t in enumerate(adopted):
        if start is None or t != adopted[i - 1] + 1:
            start = t
            runs.append([t, t])
        runs[-1][1] = t
    if not runs:
        return None
    lo, hi = max(runs, key=lambda r: (r[1] - r[0], -r[0]))
    first = max(0, lo - 1)
    return first, min(ticks - 1, hi + 1, first + most - 1)


class TickWindowProfiler:
    """A ``tick_span`` for `testing.pipelined_tick_drive`: torch.profiler
    (host and device activity) runs from the start of tick ``lo`` to the end
    of tick ``hi``, each of those ticks in a ``record_function`` range named
    `TICK_RANGE` and its number."""

    def __init__(self, torch, lo: int, hi: int):
        self.torch, self.lo, self.hi = torch, lo, hi
        self.prof = None

    @contextlib.contextmanager
    def __call__(self, t: int):
        from torch.profiler import ProfilerActivity, profile, record_function

        if t == self.lo:
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
        if self.lo <= t <= self.hi:
            with record_function(f"{TICK_RANGE}{t}"):
                yield
        else:
            yield
        if t == self.hi:
            self.torch.cuda.synchronize()
            self.prof.__exit__(None, None, None)


def profile_pipelined(torch, card, adopted: list) -> dict:
    """The pipelined schedule of phase 18 once more on the card, torch.profiler
    (host and device activity) over `profile_window`'s ticks of the
    unprofiled run's adopting ticks ``adopted``, each tick in a
    ``record_function`` range; `upload_waits` at the window's ticks that
    adopt a speculation in this run."""
    from karpenter_tpu_torch import testing as T

    window = profile_window(adopted, T.PIPELINE_TICKS)
    if window is None:
        fail("phase 18: no adopting tick to profile")
    t0 = time.perf_counter()
    span = TickWindowProfiler(torch, *window)
    run = T.pipelined_tick_drive("cuda", True, tick_span=span)
    drive_s = time.perf_counter() - t0
    ticks = [t for t, o in enumerate(run["outcomes_by_tick"])
             if o.get("adopted") and window[0] <= t <= window[1]]
    events = kineto_events(span.prof)
    waits = upload_waits(events, ticks)
    device = [e for e in events if e[1]]
    matched = len({e[4] for e in device} & {
        e[4] for e in events if not e[1] and e[0].startswith(RUNTIME_PREFIX)} - {0})
    longest = sorted(device, key=lambda e: e[2] - e[3])[:3]
    print(f"  the pipelined schedule profiled over ticks {window[0]}-{window[1]} ({card}): the "
          f"drive {drive_s:.3f} s, the timeline read in {time.perf_counter() - t0 - drive_s:.3f} "
          f"s; {len(events)} events, {len(device)} on the device, {matched} correlation ids "
          f"shared with a runtime call; the longest device events "
          f"{[(e[0][:48], round((e[3] - e[2]) / 1e3, 4)) for e in longest]} ms; adopting ticks "
          f"{ticks} (the unprofiled run's in the window: "
          f"{[t for t in adopted if window[0] <= t <= window[1]]})", flush=True)
    for t, row in waits.items():
        print(f"    tick {t}: {json.dumps(row)}", flush=True)
    with_upload = [row for row in waits.values() if row["upload"] is not None]
    waited = [row for row in with_upload if row["upload"]["waited"]]
    print(f"    of {len(waits)} adopting ticks in the timeline, {len(with_upload)} upload; the "
          f"first upload waited for device work in flight in {len(waited)}, "
          f"{sum(r['upload']['pending_ms'] for r in waited)!r} ms in all; device work in flight "
          f"at the tick's start in {sum(1 for r in waits.values() if r['in_flight_ms'] > 0)}",
          flush=True)
    return {"window": window, "ticks": ticks, "waits": waits, "device_events": len(device)}


def admission_checks(adm: dict, launches: dict) -> None:
    """What phase 18 holds the admission drive to on the card: the resident
    plane seeded, every attempt (the first, the warm-ups and both passes)
    nominated with no mismatch, no new launch signature in the warm window,
    and ``admit_kernel`` launched once an attempt (``launches``)."""
    from karpenter_tpu_torch import testing as T

    attempts = 1 + T.ADMISSION_WARMUP + 2 * adm["iters"]
    if not adm["seeded"] or adm["attempts"] != attempts:
        fail(f"phase 18: admission seeded={adm['seeded']} with {adm['attempts']} attempts, "
             f"expected {attempts}")
    if adm["outcomes"] != {"nominated": attempts}:
        fail(f"phase 18: admission outcomes {adm['outcomes']}: every attempt must be "
             "nominated, no mismatch")
    if adm["new_signatures_warm"]:
        fail(f"phase 18: the warm admissions added {adm['new_signatures_warm']} launch "
             "signatures")
    if launches.get("admit_kernel") != attempts:
        fail(f"phase 18: admit_kernel launched {launches.get('admit_kernel')} times over "
             f"{attempts} attempts")


def pipelined_checks(seq: dict, pipe: dict) -> None:
    """Phase 18's pipelined tick: both schedules' states equal tick for tick
    (the twin contract of ``tests/test_pipeline.py``), a speculation
    adopted, no verdict mismatch."""
    at = first_difference(seq["states"], pipe["states"])
    if at is not None:
        fail(f"phase 18: the pipelined schedule's actions differ from the sequential's at "
             f"tick {at}")
    if not pipe["outcomes"].get("adopted"):
        fail(f"phase 18: no speculation adopted on the card: {pipe['outcomes']}")
    if seq["verdict_mismatch"] or pipe["verdict_mismatch"]:
        fail("phase 18: a consolidation verdict mismatch in the pipelined drives")


def load_checks(load: dict, min_events: int | None = None) -> None:
    """Phase 18's load harness: at least ``min_events`` events applied
    (bench's 1,000,000 by default), no invariant violation, ticks checked
    on the vectorized plane."""
    from karpenter_tpu_torch import testing as T

    least = T.LOAD_HARNESS_MIN_EVENTS if min_events is None else min_events
    if load["events"] < least:
        fail(f"phase 18: the load harness applied {load['events']} events, fewer than {least}")
    if load["violations"]:
        fail(f"phase 18: invariant violations {load['violations'][:5]}")
    if not load["vector_checked_ticks"]:
        fail("phase 18: no tick checked on the vectorized invariant plane")


def twin_checks(line: str, what: str, card: list, cpu: list) -> None:
    """A phase 18 line's card drive against the CPU's: ``card`` and ``cpu``
    equal item for item."""
    at = first_difference(card, cpu)
    if at is not None:
        fail(f"phase 18: {line}: the card's {what} differ from the CPU's at item {at}")


def bench_phase(torch, card) -> dict:
    """Phase 18 as the module docstring lists it.  Returns the launches by
    kernel of its card drives (the profiled run left out)."""
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.ops import fused_packer as F

    total = {k: 0 for k in KERNELS}

    def launched() -> dict:
        got = {k: F.LAUNCHES[k] for k in KERNELS}
        for k, v in got.items():
            total[k] += v
        return {k: v for k, v in got.items() if v}

    short, long_ = (CpuTwins(group, target=bench_line_twins) for group in BENCH_TWIN_GROUPS)
    try:
        # admission_single_pod_p99 (bench.py:1251-1385)
        F.reset_launches()
        t0 = time.perf_counter()
        adm = T.admission_drive("cuda")
        launches = launched()
        print(f"  admission_single_pod_p99 (bench.py:1251) on the card ({card}), the drive "
              f"{time.perf_counter() - t0:.3f} s: {adm['live_nodes']} live nodes, "
              f"{adm['attempts']} attempts "
              f"{json.dumps(adm['outcomes'])} onto {sorted(set(adm['nodes']) - {None})}; "
              f"p99 {adm['p99_ms']!r} ms, p50 {adm['p50_ms']!r} ms, noise {adm['noise_ms']!r} ms "
              f"(README's limit {T.ADMISSION_BUDGET_MS} ms, recorded); the p99 sample's phases "
              f"{json.dumps(adm['p99_phases_ms'])}; cold {adm['cold_ms']!r} ms; link floor "
              f"{adm['link_floor_ms']!r} ms; new launch signatures cold "
              f"{adm['new_signatures_cold']} warm {adm['new_signatures_warm']}; transfer bytes "
              f"cold {adm['transfer_bytes_cold']} warm {adm['transfer_bytes_warm']!r} an "
              f"attempt; launches {json.dumps(launches)}", flush=True)
        admission_checks(adm, launches)

        # reconcile_tick_pipelined_p50 (bench.py:1048-1158)
        runs = {}
        for pipelined in (False, True):
            F.reset_launches()
            runs[pipelined] = T.pipelined_tick_drive("cuda", pipelined)
            runs[pipelined]["launches"] = launched()
        seq, pipe = runs[False], runs[True]
        ratio = pipe["p50_ms"] / seq["p50_ms"]
        for label, run in (("sequential", seq), ("pipelined", pipe)):
            print(f"  reconcile_tick_pipelined_p50 (bench.py:1048), {label}, on the card ({card}): "
                  f"{run['ticks']} ticks in {run['wall_s']!r} s, tick p50 {run['p50_ms']!r} ms, "
                  f"controller p50s {json.dumps(run['phases_ms'])}, max phase "
                  f"{run['max_phase']} {run['max_phase_ms']!r} ms, p50_vs_max_phase "
                  f"{run['p50_vs_max_phase']!r}, overlap {run['overlap_seconds']!r} s, "
                  f"speculations {json.dumps(run['outcomes'])}; launches "
                  f"{json.dumps(run['launches'])}", flush=True)
        print(f"    pipelined / sequential p50 {ratio!r} (bench's floors, recorded: overlap > 0 "
              f"{pipe['overlap_seconds'] > 0}, ratio <= {T.PIPELINE_MAX_RATIO} "
              f"{ratio <= T.PIPELINE_MAX_RATIO})", flush=True)
        pipelined_checks(seq, pipe)
        adopted = [t for t, o in enumerate(pipe["outcomes_by_tick"]) if o.get("adopted")]
        profiled = profile_pipelined(torch, card, adopted)

        # load_harness_1m_events (bench.py:1166-1222)
        F.reset_launches()
        trace = hashed_trace()
        load = T.load_harness_drive("cuda", trace=trace)
        launches = launched()
        print(f"  load_harness_1m_events (bench.py:1166) on the card ({card}): {load['ticks']} "
              f"ticks, {load['events']} events {json.dumps(load['event_counts'])} in "
              f"{load['wall_s']!r} s ({load['events_per_s']!r} events a second, the trace's "
              f"state digests {trace.digest_s!r} s of it); phases s "
              f"{json.dumps(load['phases_s'])}, harness fraction {load['harness_fraction']!r} "
              f"(bench's limit {T.LOAD_HARNESS_MAX_FRACTION}, recorded); vector-checked ticks "
              f"{load['vector_checked_ticks']}; violations {len(load['violations'])}; trace "
              f"{trace.lines} lines, {trace.nbytes} bytes, sha256 {trace.sha256()}; launches "
              f"{json.dumps(launches)}", flush=True)
        load_checks(load)

        t0 = time.perf_counter()
        cpu = short.get("admission")
        print(f"  admission on the CPU (plain versions, beside the card's drives): "
              f"{json.dumps(cpu['outcomes'])}, p50 {cpu['p50_ms']!r} ms, p99 {cpu['p99_ms']!r} "
              f"ms, {cpu['seconds']!r} s", flush=True)
        twin_checks("admission", "nodes", adm["nodes"], cpu["nodes"])
        cpu = short.get("pipelined")
        print(f"  the sequential schedule on the CPU: tick p50 {cpu['p50_ms']!r} ms, "
              f"{cpu['seconds']!r} s", flush=True)
        twin_checks("pipelined tick", "states", state_digests(seq["states"]), cpu["states"])
        cpu = long_.get("load")
        print(f"  waited {time.perf_counter() - t0:.3f} s for the CPU drives", flush=True)
        print(f"  the load harness on the CPU: {cpu['events']} events in {cpu['wall_s']!r} s, "
              f"harness fraction {cpu['harness_fraction']!r}, trace {cpu['lines']} lines, "
              f"{cpu['bytes']} bytes, sha256 {cpu['sha256']}", flush=True)
        twin_checks("load harness", "trace", [trace.sha256(), load["events"]],
                    [cpu["sha256"], cpu["events"]])
        print("  the admissions' nodes, the pipelined ticks' actions and the million-event "
              "trace equal the CPU's", flush=True)
    finally:
        short.close()
        long_.close()
    return {"launches": total, "admission": adm, "pipelined": runs, "profiled": profiled,
            "load": load}


def phase_launches(kernel: str, per_phase: dict) -> dict:
    """A kernels-line row's launches on each phase's path: ``per_phase``
    maps each column (``operator_launches``: phase 7's drive,
    ``consolidation_launches`` phase 9's, ``sim_launches`` phase 10's
    scenarios, ``service_launches`` phase 11's rounds, ``ha_launches``
    phase 12's card drive, ``fleet_launches`` phase 13's scaled cell,
    ``legacy_launches`` phase 14's converted objects, ``mesh_launches``
    phase 15's main path, ``chart_launches`` phase 16's sidecar,
    ``configs_launches`` phase 17's problems, ``bench_launches`` phase
    18's drives) to that phase's launch counts."""
    return {col: counts.get(kernel, 0) for col, counts in per_phase.items()}


def observatory_totals() -> dict:
    from karpenter_tpu_torch.obs.device import OBSERVATORY

    snap = OBSERVATORY.snapshot()
    return {k: snap[k] for k in ("dispatches", "compiles", "compile_seconds",
                                 "transfer_bytes", "resident")}


def main(argv) -> int:
    """The run as the module docstring lists it."""
    through = parse_through(argv)
    t_start = _PHASE_CLOCK["last"] = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA card")
    try:
        from karpenter_tpu_torch.ops import _build
        from karpenter_tpu_torch.ops import fused_packer as F
        from karpenter_tpu_torch.scheduling.solver import TorchScheduler
    except ImportError as exc:
        fail(f"karpenter_tpu_torch is not importable next to this script: {exc}")
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind} x{torch.cuda.device_count()} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    phase_done(1, through)

    t0 = time.perf_counter()
    _build.build_all()
    print(f"[build] {len(_build.SOURCES)} source(s) in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    for name in _build.SOURCES:
        log = _build.BUILD_LOG.get(name, "").strip()
        if not log:
            fail(f"no -Xptxas -v summary for {name}.cu")
        for line in log.splitlines():
            print(f"  {name}: {line}")
    res = ptxas_resources(_build.BUILD_LOG["ffd_pack"])
    choice = [k for k in res if "choose_config_kernel" in k]
    if len(choice) != 4:  # kMulti false and true, each solo and shard
        fail(f"ptxas reported {len(choice)} instances of choose_config_kernel, expected 4")
    res_mesh = ptxas_resources(_build.BUILD_LOG["mesh_pack"])
    for name in (*SPILL_CHECKED, *MESH_SPILL_CHECKED, "assemble_feasibility"):
        syms = [k for k in (res_mesh if name == "assemble_feasibility" else res)
                if f"{name}_kernel" in k]
        if not syms:
            fail(f"ptxas reported no {name}_kernel")
        for sym in sorted(syms):
            regs, st, ld = {**res, **res_mesh}[sym]
            print(f"  {name}_kernel {sym}: {regs} registers, spill stores {st} bytes, "
                  f"spill loads {ld} bytes")
            if st or ld:
                fail(f"{name}_kernel {sym} spills ({st} / {ld} bytes)")
    phase_done(2, through)

    specs = problems()
    probs = {name: compiled(spec) for name, spec in specs.items()}
    for name, prob in probs.items():
        G, C = prob.feas.shape
        print(f"[problem] {name}: pods={prob.total_pods()} classes={G} "
              f"configs={C} axes={len(prob.axes)} tracked={prob.n_track_slots}")
    t0 = time.perf_counter()
    config_specs = config_problems()
    print(f"[problem] phase 17's problems built in {time.perf_counter() - t0:.3f} s: "
          + ", ".join(f"{name} {len(spec[2])} pods" for name, spec in config_specs.items()))

    print("[kernel vs plain] bit-equality on the card", flush=True)
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.ops import packer as P

    padded = lambda prob, k=0: P.to_device(P.pad_problem(prob, k)[0], dev)
    wrap = lambda k, at=0: P.to_device(T.wrap_arrays(k, at=at), dev)
    # each problem at the main path's shapes: the resident tensors a cold
    # solve on the card seeds (config 2 and the flagship: 512 slots)
    kargs = {name: main_path_state(torch, spec).pack_args() for name, spec in specs.items()}
    # phase 17's problems at the inputs that reach the kernels there: the
    # arguments of a cold card solve's pack
    cargs = {name: main_path_args(torch, config_specs[name]) for name in PHASE3_CONFIGS}
    for name, args in {**kargs, **cargs}.items():
        G, R = args[0].shape
        print(f"  {name}: main-path tensors Gp={G} Cp={args[5].shape[0]} "
              f"Kp={args[8].shape[0]} R={R} S={args[12].shape[0]} next0={args[11]} "
              f"classes with maxper 1: {int((args[2] == 1).sum())}")
    glob = [("ffd_scan_global", F.ffd_scan_global, "ffd_scan_global")]

    def sizes(args):  # the cluster scan forced onto each other cluster size
        return [(f"ffd_scan_cluster ctas={n}",
                 lambda *a, n=n: F.ffd_scan_cluster(*a, ctas=n), "ffd_scan_cluster")
                for n in other_cluster_sizes(*pack_shapes(args))]

    straddle = wrap(4096, at=4096 // 2 - 2)
    max_clusters = F.grid_clusters(torch.cuda.current_device())
    print(f"  ffd_scan_grid: {max_clusters} clusters of {F.GRID_CTAS} CTAs resident at once at "
          f"one CTA a SM (cudaOccupancyMaxActiveClusters, {card})")
    # name -> (card tensors, the scan the shape rule must pick, more scans)
    cases = {
        "config2": (kargs["config2"], "ffd_scan", glob),
        "flagship": (kargs["flagship"], "ffd_scan", []),
        "config2_live": (kargs["config2_live"], "ffd_scan_cluster",
                         glob + sizes(kargs["config2_live"])),
        "config2 k_slots=4096": (padded(probs["config2"], 4096), "ffd_scan_cluster", []),
        "config2 k_slots=8192": (padded(probs["config2"], 8192), "ffd_scan_cluster", []),
        "config2 k_slots=16384": (padded(probs["config2"], 16384), "ffd_scan_cluster", []),
        "wrap k_slots=256": (wrap(256), "ffd_scan", []),
        "wrap k_slots=4096": (wrap(4096), "ffd_scan_cluster", glob),
        "wrap k_slots=4096 straddling slot 2048": (straddle, "ffd_scan_cluster", sizes(straddle)),
        "wrap k_slots=16384 straddling slot 8192": (
            wrap(16384, at=16384 // 2 - 2), "ffd_scan_cluster", []),
        **{name: (kargs[name], "ffd_scan_grid", glob) for name in LARGE_LIVE},
        **{name: (cargs[name], CONFIG_SCAN[name], []) for name in PHASE3_CONFIGS},
        **{name: (wrap(k, at=at), "ffd_scan_grid", [])
           for name, (k, at) in grid_wrap_cases(max_clusters).items()},
    }
    errs, kouts = {}, {}
    for name, (args, picked, extra) in cases.items():
        print(f" {name}{layout_note(pack_shapes(args), picked, max_clusters)}", flush=True)
        e, kouts[name] = compare_kernels(torch, args, picked, extra)
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
    grid_batch_errs = compare_grid_batches(torch, max_clusters)
    spin_trap(card)
    # the choice on its own cases
    shifted = list(kargs["config2"])
    feas = shifted[4]
    buf = torch.zeros(feas.numel() + 1, dtype=torch.bool, device=dev)
    buf[1:] = feas.reshape(-1)
    shifted[4] = buf[1:].view(feas.shape)  # one byte off: read a config at a time
    choose_cases = {
        **kargs,
        "wrap k_slots=256": wrap(256),
        "ties": P.to_device(T.tie_arrays(), dev),
        "ties configs=16384": P.to_device(T.tie_arrays(16384), dev),
        "configs=6": P.to_device(T.first_configs(T.wrap_arrays(256), 6), dev),
        "config2 feas one byte off": tuple(shifted),
    }
    for name, args in choose_cases.items():
        errs["choose_config"] = max(errs.get("choose_config", 0.0),
                                    compare_choose(torch, name, args))
    for k in ("choose_config", *SCAN_KERNELS):
        if k not in errs:
            fail(f"phase 3 never ran {k}")
    phase_done(3, through)

    print(f"[kernel times] torch.profiler device time and CUDA events, {card}", flush=True)
    times = {name: time_kernels(torch, args,
                                scan_turns=name in ("config2", "config2_live", *LARGE_LIVE))
             for name, args in kargs.items()}
    for name, t in times.items():
        for k, (dev_ms, ev_ms, plain, readings) in t.items():
            print(f"  {name} {k}: kernel {dev_ms!r} ms device (profiler, mean of "
                  f"{readings!r}), {ev_ms!r} ms per call (CUDA events), "
                  f"plain {plain!r} ms (CUDA events)")
    c2t, livet = times["config2"], times["config2_live"]
    print(f"  config2 ffd_scan_global / ffd_scan device time, in turns at "
          f"{kargs['config2'][8].shape[0]} slots: "
          f"{c2t['ffd_scan_global'][0] / c2t['ffd_scan'][0]!r}")
    print(f"  config2_live ffd_scan_global / ffd_scan_cluster device time, in turns at "
          f"{kargs['config2_live'][8].shape[0]} slots: "
          f"{livet['ffd_scan_global'][0] / livet['ffd_scan_cluster'][0]!r}")
    for name in LARGE_LIVE:
        t = times[name]
        print(f"  {name} ffd_scan_global / ffd_scan_grid device time, in turns at "
              f"{kargs[name][8].shape[0]} slots: "
              f"{t['ffd_scan_global'][0] / t['ffd_scan_grid'][0]!r}")
    bounds = {}
    for k in ("choose_config", *SCAN_KERNELS):
        name = ROW_PROBLEM[k]
        take, _, node_cfg, _, _ = kouts[name]
        b = kernel_bounds(kargs[name], take, node_cfg)
        bounds[k] = b[k if k == "choose_config" else "ffd_scan"]  # one function, four scans
        print(f"  {name} {k} bound: {bounds[k]}")
    large_bounds = {}
    for name in LARGE_LIVE:  # the scan's bound at both problems past one cluster
        take, _, node_cfg, _, _ = kouts[name]
        large_bounds[name] = kernel_bounds(kargs[name], take, node_cfg)["ffd_scan"]
        print(f"  {name} ffd_scan_grid and ffd_scan_global bound: {large_bounds[name]}")
    steps = {name: (kargs[name][0].shape[0], kargs[name][8].shape[0])
             for name in ("config2", "config2_live", *LARGE_LIVE)}
    live_shapes = pack_shapes(kargs["config2_live"])
    cluster_threads = {n: F.scan_threads(-(-live_shapes[0] // n)) for n in F.CLUSTER_SIZES
                       if F.cluster_layout(*live_shapes, n)}
    # each large problem's grid: (clusters, CTAs a cluster, threads a CTA)
    grids = {}
    for name in LARGE_LIVE:
        K, R, S, _ = pack_shapes(kargs[name])
        g = F.grid_layout(K, R, S, max_clusters)
        grids[name] = (g.clusters, g.ctas, F.scan_threads(-(-K // (g.clusters * g.ctas))))
    barrier_us, cluster_us, l2_us = probe_latencies(
        torch, sorted({F.scan_threads(K) for _, K in steps.values()}),
        sorted({*cluster_threads.items(), *((c, b) for _, c, b in grids.values())}))
    grid_us = probe_grid_exchange(torch, sorted({g for g in grids.values() if g[0] > 1}))
    print(f"  latency probes ({card}): barrier round trip {barrier_us!r} us "
          f"(by threads), cluster exchange + barrier round trip {cluster_us!r} us "
          f"(by cluster size, threads), dependent L2 load {l2_us!r} us, cluster exchange + "
          f"barrier + round trip between clusters {grid_us!r} us (by clusters, cluster size, "
          f"threads)")
    for g, us in grid_us.items():
        print(f"  the round trip between {g[0]} clusters alone: {us - cluster_us[g[1:]]!r} us "
              f"(the grid probe less the cluster probe at {g[1]} CTAs of {g[2]} threads)")

    def floor_ms(kernel, name, ctas=None):
        """``ctas``: a cluster size the rule does not pick (phase 4's label)."""
        G, K = steps[name]
        barriers, loads = scan_step_model(kernel, K)
        label = f"{kernel} ctas={ctas}" if ctas else None
        if kernel == "ffd_scan_cluster":
            n = ctas or F.cluster_layout(*live_shapes)[0]
            b_us, where = cluster_us[(n, cluster_threads[n])], (
                f"cluster barriers of {n} CTAs of {cluster_threads[n]} threads")
        elif kernel == "ffd_scan_grid":
            q, c, b = grids[name]
            b_us = grid_us[(q, c, b)] if q > 1 else cluster_us[(c, b)]
            where = (f"cluster barriers of {c} CTAs of {b} threads"
                     + (f" and round trips between {q} clusters" if q > 1 else ""))
        else:
            b_us, where = barrier_us[F.scan_threads(K)], (
                f"barriers at {F.scan_threads(K)} threads")
        ms = scan_latency_floor_ms(kernel, G, K, b_us, l2_us)
        print(f"  {name} {label or kernel} latency floor: {G} steps x ({barriers} {where} + "
              f"{loads} L2 loads) = {ms!r} ms; measured / floor "
              f"{times[name][label or kernel][0] / ms!r}")
        return ms

    large_floors = {name: {k: floor_ms(k, name) for k in ("ffd_scan_grid", "ffd_scan_global")}
                    for name in LARGE_LIVE}
    floors = {"choose_config": None}
    floors.update({k: large_floors[ROW_PROBLEM[k]][k] if ROW_PROBLEM[k] in LARGE_LIVE
                   else floor_ms(k, ROW_PROBLEM[k]) for k in SCAN_KERNELS})
    for n in other_cluster_sizes(*live_shapes):
        floor_ms("ffd_scan_cluster", "config2_live", ctas=n)
    pr1_floor = floor_ms("ffd_scan_global", "config2")
    print(f"  config2 ffd_scan / the global kernel's floor model at config2: "
          f"{c2t['ffd_scan'][0] / pr1_floor!r}")
    phase_done(4, through)

    print(f"[slice] TorchScheduler.solve on the card, {card}", flush=True)
    import random

    t5 = time.perf_counter()
    rng = random.Random(0)
    F.reset_launches()
    solved, per_problem = {}, {}
    for name, spec in specs.items():
        print(f"  {name}:", flush=True)
        before = dict(F.LAUNCHES)
        solved[name] = drive_solves(torch, name, spec, rng)
        per_problem[name] = {k: F.LAUNCHES[k] - before[k] for k in KERNELS}
    launches = dict(F.LAUNCHES)
    n_solves = {name: len(SOLVE_KINDS) * sum(solve_counts(name)) for name in specs}
    print(f"  launches over {sum(n_solves.values())} solves: {launches}, "
          f"per problem {per_problem}")
    for name, got in per_problem.items():
        solves = n_solves[name]
        for k in ("choose_config", PHASE5_SCAN[name]):
            if got[k] != solves:
                fail(f"{name}: kernel {k} launched {got[k]} times over {solves} solves")
        if got["ffd_scan_global"]:
            fail(f"{name}: ffd_scan_global launched {got['ffd_scan_global']} times")
    print(f"  the timed solves took {time.perf_counter() - t5:.3f} s", flush=True)
    for name, (sched, pods, ts, phases) in solved.items():
        for sk in SOLVE_KINDS:
            print(f"  {name} {sk}: p50_ms={statistics.median(ts[sk])!r} "
                  f"min_ms={min(ts[sk])!r} max_ms={max(ts[sk])!r} ({card})")
            print(f"    last_phases_ms={json.dumps({k: v * 1e3 for k, v in sorted(phases[sk].items())})}")
        for sk in SOLVE_KINDS:
            # each profiled solve follows an unprofiled one of its kind
            solve = (lambda q, s=sched: cold_solve(s, q)) if sk == "cold" else sched.solve
            warm = p = pods
            if sk == "delta":
                warm = churn(rng, pods, specs[name][3])
                p = churn(rng, warm, specs[name][3])
            solve(warm)
            torch.cuda.synchronize()
            prof = profile_solve(torch, solve, p)
            print(f"    profiled {sk} solve (torch.profiler, {card}, "
                  f"resident={sched.last_resident}): "
                  + (json.dumps(prof) if prof else "not measured: no device time seen"))

    phase_done(5, through)

    print(f"[verdicts] the consolidation verdicts on the card, {card}", flush=True)
    verdicts = verdict_phase(torch, card)
    v = verdicts["ffd_scan_grid_batched"]  # held in phase 3 too
    v["err"] = max(v["err"], grid_batch_errs["ffd_scan_grid_batched"])
    phase_done(6, through)

    print(f"[operator] the provisioning loop on the card, {card}", flush=True)
    op_launches, op_p50 = operator_phase(torch, card)
    phase_done(7, through)

    print(f"[arrivals] single-pod arrivals through the admission fast path, {card}", flush=True)
    twins = CpuTwins(tuple(p for p in (8, 9, 10) if p <= through))
    try:
        admit = arrivals_phase(torch, card, kargs["config2_live"], twins)
        phase_done(8, through)

        print(f"[consolidation] the disruption controller through the operator, {card}",
              flush=True)
        consolidation, window_row = consolidation_phase(torch, card, twins)
        phase_done(9, through)

        print(f"[sim] the simulator's scenarios on the card, {card}", flush=True)
        sim_launches = sim_phase(torch, card, twins)
    finally:
        twins.close()
    phase_done(10, through)

    print(f"[service] the multi-tenant solver service on the card, {card}", flush=True)
    service = service_phase(torch, card, probs)
    v = service["rows"]["ffd_scan_grid_fleet"]  # held in phase 3 too
    v["err"] = max(v["err"], grid_batch_errs["ffd_scan_grid_fleet"])
    phase_done(11, through)

    print(f"[ha] two replicas failing over on one shared cluster store, {card}", flush=True)
    ha_launches = ha_phase(torch, card, op_p50)
    phase_done(12, through)

    print(f"[fleet] the fleet simulator and the deployed process, {card}", flush=True)
    fleet_launches = fleet_phase(torch, card)
    verdicts["ffd_scan_window_batched"].update(window_row, err=max(
        window_row["err"], verdicts["ffd_scan_window_batched"]["err"]))
    phase_done(13, through)

    print(f"[analysis] the static analysis, the tools and the legacy API, {card}", flush=True)
    legacy_launches = analysis_phase(torch, card)
    phase_done(14, through)

    print(f"[mesh] the sharded pack on a {MESH_SHARDS}-shard device mesh, {card}", flush=True)
    mesh = mesh_phase(torch, card)
    phase_done(15, through)

    print(f"[chart] {CHART_DIR}'s topology as processes on the card, {card}", flush=True)
    chart_launches = chart_phase(torch, card)
    phase_done(16, through)

    print(f"[configs] the rest of bench.py's solve problems on the card, {card}", flush=True)
    configs_launches = configs_phase(torch, card, config_specs)
    phase_done(17, through)

    print(f"[bench lines] bench.py's device lines on the card, {card}", flush=True)
    bench_lines = bench_phase(torch, card)
    phase_seconds(18)

    per_phase = {"operator_launches": op_launches, "consolidation_launches": consolidation,
                 "sim_launches": sim_launches, "service_launches": service["launches"],
                 "ha_launches": ha_launches, "fleet_launches": fleet_launches,
                 "legacy_launches": legacy_launches, "mesh_launches": mesh["launches"],
                 "chart_launches": chart_launches, "configs_launches": configs_launches,
                 "bench_launches": bench_lines["launches"]}
    kernels = []
    for k in ("choose_config", *SCAN_KERNELS):
        dev_ms, _, plain, _ = times[ROW_PROBLEM[k]][k]
        kernels.append({
            "name": k,
            "problem": ROW_PROBLEM[k],
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": REPLACES,
            "launches": launches[k],
            "max_abs_err": errs[k],
            "ms": dev_ms,
            "plain_ms": plain,
            "bound_ms": bounds[k]["bound_ms"],
            "bound_by": bounds[k]["bound_by"],
            "library_ms": None,
            "latency_floor_ms": floors[k],
            **phase_launches(k, per_phase),
            # the scans past one cluster, timed in turns at both problems
            **({"past_one_cluster": {name: {
                "ms": times[name][k][0], "bound_ms": large_bounds[name]["bound_ms"],
                "latency_floor_ms": large_floors[name][k]} for name in LARGE_LIVE}}
               if k in ("ffd_scan_grid", "ffd_scan_global") else {}),
        })
    for k in VERDICT_KERNELS:
        v = verdicts[k]
        kernels.append({
            "name": k,
            "problem": ROW_PROBLEM[k],
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": VERDICT_REPLACES[k],
            "launches": v["launches"],
            "max_abs_err": v["err"],
            "ms": v["ms"],
            "plain_ms": v["plain_ms"],
            "bound_ms": v["bound"]["bound_ms"],
            "bound_by": v["bound"]["bound_by"],
            "library_ms": None,
            "latency_floor_ms": v["floor"],
            **phase_launches(k, per_phase),
            **({"argsort_ms": v["argsort_ms"]} if v["argsort_ms"] is not None else {}),
            # the grid's batched scan against the global one, in turns at each B
            **({"in_turns": v["turns"]} if v.get("turns") else {}),
        })
    kernels.append({
        "name": "admit_kernel",
        "problem": ROW_PROBLEM["admit_kernel"],
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": ADMIT_REPLACES,
        "launches": admit["launches"],
        "max_abs_err": admit["err"],
        "ms": admit["ms"],
        "plain_ms": admit["plain_ms"],
        "bound_ms": admit["bound"]["bound_ms"],
        "bound_by": admit["bound"]["bound_by"],
        "library_ms": None,
        "latency_floor_ms": admit["latency_floor_ms"],
        "empty_launch_ms": admit["empty_launch_ms"],
        **phase_launches("admit_kernel", per_phase),
        "call_ms": admit["call_ms"],
    })
    for k in FLEET_KERNELS:
        v = service["rows"][k]
        kernels.append({
            "name": k,
            "problem": ROW_PROBLEM[k],
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": FLEET_REPLACES,
            "launches": service["launches"][k],
            "max_abs_err": v["err"],
            "ms": v["ms"],
            "plain_ms": v["plain_ms"],
            "bound_ms": v["bound"]["bound_ms"],
            "bound_by": v["bound"]["bound_by"],
            "library_ms": None,
            "B": v["B"],
            "solo_ms": v["solo_ms"],
            "stack_ms": v["stack_ms"],
            "call_ms": v["call_ms"],
            "solo_call_ms": v["solo_call_ms"],
            **phase_launches(k, per_phase),
            # the grid's fleet scan against the global one, in turns at each
            # fleet, and its launches off the cells' path
            **({"in_turns": v["turns"], "forced_launches": v["forced_launches"]}
               if v.get("turns") else {}),
        })
    for k in MESH_KERNELS:
        v = mesh["rows"][k]
        kernels.append({
            "name": k,
            "problem": ROW_PROBLEM[k],
            "route": "cuda",
            "source": MESH_SOURCES.get(k, MESH_SOURCE),
            "replaces": MESH_REPLACES[k],
            "launches": v["launches"],
            "max_abs_err": v["err"],
            "ms": v["ms"],
            "plain_ms": v["plain_ms"],
            "bound_ms": v["bound"]["bound_ms"],
            "bound_by": v["bound"]["bound_by"],
            "library_ms": None,
            "launches_per_solve": v["per_solve"],
            "forced_launches": v["forced_launches"],
            "timer": v["timer"],
            **{f: v[f] for f in ("latency_floor_ms", "live_ms", "live_timer", "live_bound_ms",
                                 "live_bound_by", "live_latency_floor_ms") if f in v},
            **phase_launches(k, per_phase),
        })
    print(f"chip_smoke took {time.perf_counter() - t_start:.3f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
