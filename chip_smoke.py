#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``gpushare_device_plugin_tpu_torch``) on
one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each of which fails the run with a non-zero exit:

1. Build every CUDA kernel from ``ops/csrc`` and hold the forward
   against its plain PyTorch version at Llama-3-8B attention shapes
   (H=32, Hkv=8, D=128), each case through the entry ``flash_fwd`` picks
   for its dtype and head dim (bf16 at D in {64, 128}: the tensor-core
   ``flash_fwd``; f32: ``flash_fwd_scalar``), bf16 and f32: S in {64,
   512, 2048} causal, a left-padded (``start``) batch with fully masked
   rows, a right-padded (``kv_len``) batch; and in bf16 a ragged S=300,
   D=64 at S=2048, and the training shape B=4 x S=2048 (causal, no
   bounds), and the draft's served shape (1 x 512, D=64, causal,
   ``kv_len``: phase 15's draft prefill). At the served shape (1 x 512),
   the draft's and the training shape ``flash_fwd_scalar`` runs too, on
   the same inputs. Every entry runs
   twice and must give the same bits. Times each kernel (with its TFLOP/s
   and the fraction of its bound), the plain version, one PyTorch library
   call on the same inputs (a yardstick the port never calls) and the
   bound; kernel and library call also by device time alone
   (``torch.profiler``), which leaves out the host's cost per call.
2. Serve: ``llama3_8b()`` at full width and depth (32 layers, bf16,
   random weights made on the card from a seeded generator) in
   ``SlotEngine(slots=8, max_len=2048, prefill_chunk=512)`` over a
   16-request Poisson trace. Kernel launch counts are zeroed just before
   the run and read just after: ``flash_fwd`` must run and
   ``flash_fwd_scalar`` never. The shape guard must stay at one shape per
   program.
3. Engine vs solo and kernel vs plain, end to end: each request's tokens
   against the port's solo greedy ``generate``, and one full-depth
   prefill's last-position logits with ``attention="flash"`` against
   ``"plain"``.
   (c) The static lockstep baseline: ``run_static_baseline`` on phase 2's
   weights cut to their first 4 layers (PAGED_LAYERS), phase 2's trace, in
   waves of 8 (one padded prefill, then the trace's largest ``max_new``
   decode steps for every row). Each request's tokens must equal solo
   greedy decode's at that depth or pass phase 3's near-tie rule; its
   launches are one ``flash_fwd`` a layer per wave (the off-clock warmup
   wave included) and nothing else. Prints ticks, wall and goodput.
4. The backward kernels against ``flash_bwd_plain`` at the same attention
   shapes, each case through the entries ``flash_bwd`` picks for its dtype
   and head dim (bf16 at D in {64, 128}: the tensor-core ``flash_bwd_dq``
   / ``flash_bwd_dkv``; f32: ``flash_bwd_dq_scalar`` /
   ``flash_bwd_dkv_scalar``): causal S in {512, 2048}, the training shape
   B=4 x S=2048 (bf16, where the scalar entries run too, on the same
   inputs), a ``start`` batch with dead rows, a ``kv_len`` batch, bf16 at
   D=64, and one ``flash_attention_lse`` backward with a nonzero lse
   cotangent. Every entry runs twice and must give the same bits. Times
   each kernel (with its TFLOP/s and the fraction of its bound), the plain
   version, the backward of ``F.scaled_dot_product_attention`` (a
   yardstick that computes all three gradients in one call) and the
   bound.
5. Train: ``llama3_8b()`` at full width cut to 4 layers, bf16 compute, f32
   params made on the card from a seeded generator, remat "full", the
   default AdamW: ``run_train_loop(DecoderTask(batch=4, seq=2048))`` for 8
   steps. Launch counts are zeroed just before and read just after; the
   loss must be finite and fall, each tensor-core backward kernel must
   run once per layer per step, the scalar ones never, and the forward
   twice (once more in the recompute).
6. Flash against plain, gradient end to end: one ``loss_fn`` backward at
   the same width and depth (B=1, S=2048) with ``attention="flash"`` and
   with ``"plain"``: every leaf gets a nonzero gradient, losses and
   gradients agree.
7. Paged serve, on phase 2's weights cut to their first 4 layers
   (PAGED_LAYERS; run straight after phase 3): a
   24-request ``shared_prefix_trace`` (two 1024-token system prompts,
   64-512-token tails, half critical, half best-effort) through
   ``PagedSlotEngine(max_len=2048, prefill_chunk=512, page_size=16)``
   twice. Run A: 16 slots over the pages ``paged_plan_from_pod_env`` grants a
   24 GiB slice (73,797 pages). Run B: 8 slots over 256 pages (two max_len rows), so
   requests preempt. Launch counts are zeroed just before each run and
   read just after, and the prefill program's dispatches are counted.
   Each run must serve every request, keep the shape guard at one shape
   per program, leak no page (used pages == the radix cache's), launch
   ``flash_fwd`` exactly once per layer per prefill dispatch (and more
   than 0) and ``flash_fwd_scalar`` never; run A must hit the prefix cache and
   run B must preempt. Each run's decode step is profiled
   (``torch.profiler``): kernels, busy share, page gather and scatter time.
8. Paged correctness: every preempted request of run B and four prefix-hit
   requests of run A against solo greedy decode by phase 3's near-tie
   rule; run A's trace drained at half its ticks, the snapshot (through
   JSON) restored on a fresh engine, the combined tokens held to the same
   rule; one request's pages exported and imported into the second
   engine's pool, the same bits back.
9. BERT-base alone: ``bert_base()`` at full width and depth (12 layers,
   d 768, 12 heads, d_ff 3072, vocab 30522), bf16 compute over f32 params,
   remat on, AdamW 1e-4: ``run_train_loop(BertTask(batch=32, seq=512))``
   for 8 steps. Launch counts are zeroed just before and read just after:
   each step must launch ``flash_fwd`` 24 times (forward and recompute,
   non-causal, D=64) and ``flash_bwd_dq`` / ``flash_bwd_dkv`` 12 times each,
   the scalar entries never; the loss must be finite and fall. Then one
   full-depth ``loss_fn`` backward with ``attention="flash"`` against
   ``"plain"`` by phase 6's rule. One step is profiled.
10. ResNet-50 alone: ``resnet50()`` on ``demo_batch(batch=64, size=224)``
   (ImageNet's training resolution), SGD with Nesterov momentum at 0.1,
   32 steps through ``ResNetTask`` (see RESNET_STEPS): the loss finite and
   falling, the BN running statistics changed and finite. One step is
   profiled.
11. Binpack on one card through the pod env: six child processes start
   at once, each given only the env phase 21's allocator granted it
   (``TPU_VISIBLE_CHIPS=0``, ``ALIYUN_COM_TPU_MEM_{IDX,POD,CONTAINER,DEV}``,
   ``TPU_HBM_LIMIT_FRACTION``, ...) and each calling
   ``configure_torch_from_env()`` first, as the
   ``demo/binpack-1`` pods do: four MNIST pods at 2 GiB (three
   ``mnist.train(steps=200)``, one ``steps=100``), BERT-base as phase 9 at
   16 GiB and ResNet-50 as phase 10 at 32 GiB (a model whose phase 9 or 10
   peak exceeds 0.95 of its slice trains at half the batch, and says so).
   Every child must exit 0 with a falling loss and its peak reserved
   memory at or below its cap; each pod's step p50 prints beside its
   phase 9/10 p50 alone.
12. A pod that overruns its slice OOMs itself: a BERT-base child at half
   phase 9's peak (whole GiB, rounded down) must die of
   ``torch.cuda.OutOfMemoryError`` (a marker it prints), while an MNIST
   control child at the same slice passes.
13. Multi-LoRA paged serve, on phase 2's weights cut to their first 4
   layers (run straight after phase 8): four tenants' adapters (rank 8, alpha 16, on wq, wkv, wo, wi
   and wdown; seeded, ``b`` random, each target's delta scaled to 0.2 of
   its weight in Frobenius norm) serve phase 7's trace with
   ``adapters=["t0", "t1", "t2", "t3", ""]``. Run A: 16 slots over
   ``paged_plan_from_pod_env(lora=True)`` for the 24-unit env. Run B: the
   first 12 requests, 8 slots over 328 pages (two max_len rows and two
   adapters), so adapters evict and rows preempt. Each run has phase 7's
   gates (leaks counted with the resident adapters' pages), and at least
   four adapter misses; run A
   must hit and run B must evict. Every request of run A is held to
   merged-solo (``merge_lora`` of its tenant, solo greedy decode) by phase
   3's near-tie rule, one tenant's merged weights on the card at a time;
   run B and a drain/restore of run A (through JSON, ``adapter_id`` rows
   included) are held to run A the same way; each tenant must differ from
   the base model on one of its requests; t0's paged prefill logits through the BGMV path must agree with ``merge_lora`` + ``prefill``
   within LORA_LOGIT_REL of the largest logit. The profiled decode step
   reports the adapter slab's gather apart from the page gathers.
14. LoRA fine-tuning in a pod: a child with the plugin's env for a
   32-unit slice, ``configure_torch_from_env()`` first, makes ``llama3_8b()``
   at full depth in bf16 on the card and trains the reference's default
   adapters (rank 8 on wq and wo) with ``make_lora_train_step(lr=1e-3)``
   on one fixed B=2 x S=2048 batch for 8 steps, remat "full". The loss must
   fall, every base leaf's checksum stay, ``b`` move off zero, each step
   launch 64 ``flash_fwd`` and 32 ``flash_bwd_dq`` / ``flash_bwd_dkv`` (the
   scalar entries never), and the peak reserved memory stay within the cap
   (past it the pod trains at half the batch, and says so). Then, in this
   process, one ``lora_loss_fn`` backward at full width cut to 4 layers,
   B=1, flash against plain by phase 6's rule.
15. Speculative paged serve, on phase 2's weights cut to their first 4
   layers (SPEC_LAYERS; run straight after phase 13): a draft
   of Llama-3.2-1B's published shape cut to its first 4 of 16 layers
   (DRAFT_LAYERS; d 2048,
   32/8 heads at head dim 64; seeded, see the constants) proposes
   ``SPEC_K`` tokens a round. First the plain paged engine serves phase
   7's trace at this depth, 16 slots over the 24-unit env's plan (the
   tokens the speculative runs are held to). Run A: the 8B target with
   that draft, 16
   slots over ``paged_plan_from_pod_env(draft_cfg=, draft_weight_bytes=)``
   for the 24-unit env, on phase 7's trace. Run B: the target as its own
   draft, 8 slots, the trace's first 8 requests, beside the plain engine
   on the same requests and pool. Each run has phase 7's gates with five
   programs in the shape guard and ``flash_fwd`` launched once per target
   and draft layer per prefill dispatch (8 in run A, 8 in run B); run A
   must roll back pages, run B must accept at least SPEC_ACCEPT_MIN of its
   proposals and take fewer ticks than the plain engine. Every request's
   tokens equal the plain run's, or solo decode's by phase 3's near-tie
   rule. Run A's spec engine is drained at mid-run into a plain engine,
   and a plain engine's drained rows into the spec engine, each with the
   same tokens and no request lost or twice. Then ``speculative_generate``
   at B=1 on a 512-token prompt with each draft against ``generate``.
   Each round's wall time is kept, and one round is profiled.
16. Interference, on phase 2's weights cut to their first 4 layers (run
   straight after phase 15): a latency-critical ``SlotEngine(slots=8, max_len=2048, prefill_chunk=512,
   metrics_pod=CRIT_POD)`` beside a best-effort ``PagedSlotEngine(slots=16,
   total_pages=1024, page_size=16, radix=False, metrics_pod=BE_POD)`` with
   Llama-3-8B-shaped weights of its own at the same depth (seed BE_SEED),
   in this process, with the
   port's ``MetricsServer`` on localhost. Solo: a settle run and six trials
   of the critical trace, the profiler's ring write on and off in turn.
   Governor off: the best-effort trace loops on a thread while the
   critical trace replays three times and a monitor thread grades the
   critical rolling step p99 against 1.3x solo into an ``SloBudget``, which
   must page. Governor on: the same, the best-effort
   engine paced by a ``StepGovernor`` on that budget, which must engage and
   throttle. A short profiled trial in each part gives the device busy
   share. Fails unless the critical tokens are the same in every trial, the
   drained best-effort tokens are a prefix of its ungoverned run's, both
   shape guards hold, every page comes back, ``flash_fwd`` runs (the scalar
   entry never), ``/metrics`` (scraped and parsed here) carries the step
   p99 of both pods and the governor, SLO, page and preemption families,
   and ``/traces`` holds each critical request's ``serve.request`` tree.
   An ``InterferenceDetector`` (threshold 1.25, the reference's) runs one
   ``InterferenceLoop`` pass after each solo and governor-off trial:
   residency from a fake apiserver holding the critical pod alone on card
   0, then the best-effort pod beside it; step p99s scraped by
   ``step_p99s_from_urls`` from the phase's ``/metrics``. Fails unless it
   gives card 0 a verdict with the critical pod as victim and the
   best-effort pod as aggressor, and the node annotation that
   ``interference_from_node`` reads back is that verdict; its ratio prints
   beside the phase's own p99 over solo (governor off), not gated.
17. Disaggregated prefill/decode serving, on phase 2's weights cut to
   their first 4 layers (run straight after phase 16; see
   DISAGG_LAYERS): the reference's ``bench_serve_disagg`` trace
   at its full settings (24 requests, every 4th prompt 512-768 tokens, the
   rest 16-64, max_new from (16, 32, 128); see the constants) through one
   unified ``PagedSlotEngine(slots=8, total_pages=192, max_len=1024,
   page_size=64, prefill_chunk=256)``, then through ``DisaggServer`` over a
   prefill tier (4 slots, 64 pages) and a decode tier (8 slots, 128 pages)
   with the same weights: the live handoff, journaled (a WAL and an
   ``AssumeCache``), and the forced fallback (``BrokenTransport``, two
   attempts) on the trace's first 12 requests. Launch counts are zeroed
   just before each run and read just after. Fails unless no request is
   dropped, every engine keeps its shape
   guard and returns every page, the live run delivers at least one
   handoff and leaves no pending journal entry, no staged page is left,
   ``flash_fwd`` runs once per layer per prefill dispatch on both tiers
   (and ``flash_fwd_scalar`` never), the fallback re-prefills every
   request, and every request's tokens equal the unified engine's or pass
   phase 3's near-tie rule (bit equality is counted, not gated). Prints
   TTFT and TPOT p50/p99 (ticks and ms) of both runs beside the unified
   engine's, handoffs by outcome, pages and bytes shipped, and a
   handoff's wall time split into the device-to-host fetch, the encode,
   the CRCs and protocol, the decode and the host-to-device write.
18. The serving fleet, on phase 2's weights cut to their first 4 layers
   (run straight after phase 17): the reference's ``bench_serve_fleet`` trace at its full settings
   (24 requests over three 384-token system prompts; see the constants)
   through one unified ``PagedSlotEngine(slots=24, total_pages=384,
   max_len=1024, page_size=64, prefill_chunk=256)``, then four times
   through ``FleetServer`` over three engines of 8 slots and 128 pages
   each, fresh engines every run: ``prefix-affinity``, ``spread``,
   ``prefix-affinity`` with a journaled scale-down of e0 at tick 3 (a WAL
   and an ``AssumeCache``), and e0 killed mid-decode on the trace's first
   12 requests. Launch counts are zeroed just before each run and read
   just after. Fails unless no request is dropped or served twice, every
   engine keeps its shape guard and returns every page, ``flash_fwd``
   runs once per layer per prefill dispatch (``flash_fwd_scalar`` never),
   affinity's fleet prefix-hit ratio is above spread's, the scale-down
   completes one op, migrates a request and leaves no pending journal
   entry, the kill re-queues a request, and every request's tokens equal
   the unified engine's or pass phase 3's near-tie rule (bit equality is
   counted, not gated). Prints each run's wall and tokens/s, router
   outcomes, hit ratios, TTFT and TPOT p50/p99 in ticks, the migrated and
   re-queued requests and the scale-down protocol's host time.
19. Context parallelism on the one card. Every rank is a child process
   given the plugin's env for its slice (``configure_torch_from_env()``
   first) and the multi-host env of a world on localhost
   (``initialize_multihost(backend="gloo")``), then ``make_mesh(MeshSpec(
   sp=n), backend="gloo")``: NCCL refuses two ranks on one card, and gloo
   moves CUDA tensors through host memory. First the three main-path
   kernels at the phase's new shapes against their plain versions, timed
   beside SDPA: the ring's non-causal hop (1 x 4,096, 32/8 heads) and
   Ulysses's whole-sequence call at sp=2 (1 x 8,192, 16/4, causal). (a)
   Attention at global B=1 x 16,384, 32/8 heads, D=128, bf16, with a
   seeded dO, on four ranks: the ring with flash hops, causal and not,
   and Ulysses with ``ulysses_inner_attn("flash")``, causal. Each rank's O
   (phase 1's rule), dQ, dK and dV (phase 4's) against its shard of one
   single-process ``flash_attention`` over the whole sequence, which this
   process computes first; each rank's launches must be the hop rule's
   (rank i of a causal ring of n: i+1 of each kernel; n when not causal;
   one for Ulysses). (b) The decoder at ``llama3_8b()`` width cut to 2
   layers, B=1 x 8,192, AdamW, remat "full": ``run_train_loop`` for 3
   steps as a 1-rank control here, then on two ranks at ``MeshSpec(sp=2)``
   with the ring, then with Ulysses (at 2 steps the second step's loss, on
   a new batch, sits above the first). Each run's losses must be finite and
   fall and its launches be the hop rule's times the forward and its
   recompute; the first step's loss must match the control's by phase 6's
   rule, and rank 0 holds the first step's gradients, summed over the
   mesh, against the 1-rank control's, which it computes itself, leaf by
   leaf by phase 6's rule. Prints each rank's exchanges (calls, bytes
   staged through the host, seconds), each run's step p50 and peak memory.
20. Tensor parallelism and FSDP on the one card, two gloo ranks as in
   phase 19. First the three main-path kernels at a tp=2 training rank's
   shape (2 x 2,048, 16/4 heads, causal) against their plain versions,
   timed beside SDPA. (a1) ``llama3_8b()``'s weights drawn at 32 layers and
   served cut to their first 4, in bf16, on the
   reference's ``bench_serve_tp`` trace at its full settings: a solo
   ``SlotEngine`` here, then ``SlotEngine(mesh=gang_mesh(...))`` on two
   ranks given a 2-chip gang's env, each drawing its shards of the same
   seeded weights. (a2) the model cut to 4 layers, eight of phase 13's
   requests and its four tenants: a solo and a tp ``PagedSlotEngine`` over
   ``paged_plan_for_slice(n_chips=2)``'s pool. Every rank's tokens must be
   the solo engine's or pass phase 3's near-tie rule (phase 13's for
   tenants), its shape guard stay ``{1, 1, 1}``, its ``flash_fwd``
   launches equal the solo run's, its weights, KV and slab be its shards'
   bytes (half the solo's; the slab the plan's per-chip charge). (a1)
   once more with an int8 KV cache on the trace's first 4 requests (bf16
   weights: a gang shards no int8 tree): tokens the one-rank int8-KV
   engine's or within phase 3's near-tie rule, each rank's cache half the
   one-rank engine's (K, V and their scales split over tp). (b)
   ``llama3_8b()`` width at 2 layers, B=2 x 2,048, AdamW with clip_norm
   1.0, remat "full", 2 steps: a 1-rank control here, then fsdp=2 and tp=2
   on two ranks. Each rank's first loss by phase 6's rule against the
   control's, its first-step gradients (its blocks against the control's,
   summed over the axes a leaf is cut on) leaf by leaf by phase 6's rule,
   losses falling, launches 4 / 2 / 2, and its parameter and AdamW bytes
   the sum of its shards'. Prints walls, decode p50, goodput, step p50,
   peaks and every exchange's calls, bytes and seconds per rank.
21. The device plugin's own path, from discovering the card to the env a
   pod is granted (run straight after phase 1: every later pod env comes
   from it). (a) Discovery: in a child process that must never import
   torch, ``from_name("nvml")`` probes, lists one chip per ``nvidia-smi
   --query-gpu=uuid`` line with the same UUIDs, and runs three
   ``watch_health`` polls 0.05 s apart that must raise no Unhealthy event
   (it prints the volatile ECC counts it read); here ``from_name("cuda")``
   must give the same ids and whole GiB (both byte counts print) and
   ``from_name("auto")`` must pick NVML. (b) ``DeviceInventory`` of NVML's
   chips: one fake device a GiB (``<uuid>-_-0 .. -_-N-1``) and one core
   device. (c) One first-fit ``LocalAllocator`` grants phase 11's six pods
   in order (56 GiB, each grant's host time printed in us), refuses a
   seventh larger than what is left (``AssignmentError``), and frees a
   released pod's units. Phase 11 starts each pod with the env (c)
   granted it, and every other slice env of the script (phases 7, 12-15,
   the non-gang ranks of 19 and 20) is ``plugin_env``: a fresh
   ``LocalAllocator`` over (b)'s inventory granting that one slice. Phase
   20's gang env stays hand-written (gangs are the cluster allocator's).
   The phase imports no gRPC: the plugin's server is held to the
   reference on the CPU (``tests/test_torch_plugin.py``).

22. The node agent in standalone mode (run straight after phase 21). (a)
   Its node half in a child that must load neither torch nor grpc, and
   must take none of the card's memory, as the DaemonSet's process must
   not: ``TpuShareManager(from_name("auto"), ManagerConfig(standalone=True,
   health_check=True, ...))`` must pick NVML; ``_build_inventory`` gives
   phase 21's one card; the manager's mem allocate function grants phase
   11's six pods and refuses a seventh; its core allocate function refuses
   a hold of card 0 while mem units are held, and after a rebuild (what
   SIGHUP does: a fresh allocator, every mem unit released) the hold goes
   through and a mem grant is refused; three NVML polls through a
   ``HealthWatcher`` whose sink is the manager's ``_local_sink`` raise no
   Unhealthy event; with the signal handlers installed, SIGQUIT must leave
   a stack dump and SIGUSR1 a flight record with ``traces``, ``logs`` and
   ``timeline``. The card's free memory while the child lives against
   after it exits must differ by less than ``CONTEXT_BYTES``, which a
   control child retaining one CUDA context through ``libcuda`` must
   exceed (NVIDIA's ``nvmlInit_v2`` maps ``libcuda`` and opens
   ``/dev/nvidia-uvm`` itself, so those are printed, not gated; the
   port's own imports must map no ``libcuda``). (b) Where the machine has
   grpc, the daemon itself, ``python -m
   gpushare_device_plugin_tpu_torch.cli.daemon --standalone --health-check
   --metrics-port N``, against a kubelet made of the port's v1beta1
   bindings: both resources register, ``/readyz`` turns 200, ListAndWatch
   streams 79 healthy devices and one core device, an Allocate of two
   units is card 0's, the daemon takes none of the card's memory and maps
   no ``libtorch``, and SIGTERM exits 0. The phase launches no kernel and
   must take under 5 s. The daemon's gRPC half is held to the reference
   on the CPU too (``tests/test_torch_manager.py``,
   ``tests/test_torch_daemon.py``).
23. The node agent in cluster mode. ``tests/fake_apiserver.py`` (loaded
   by path; it imports only the standard library) holds 50 nodes of 110
   pods each (the kubelet's default ``max-pods``; the Kubernetes
   documentation's large-cluster scale cut from 5,000 nodes). This node's
   pods: 94 that ask for nothing, and 16 pending share pods with the
   scheduler extender's assume annotations for card 0 (phase 11's six
   slices and ten more of 2 GiB: 76 GiB). (a) The port's informer lists
   this node's 110 pods; the daemon (``python -m
   gpushare_device_plugin_tpu_torch.cli.daemon --node-name N
   --health-check --checkpoint-path ...``, ``auto`` discovery, a JSON
   kubeconfig) registers with a kubelet made of the port's bindings,
   which sends the 16 Allocates eight at a time: every pod ends assigned,
   every env is its pod's units on card 0, and ``cluster_chip_state``
   equals the annotations' sum. A 16-GiB pod is refused on the full card,
   then admitted once a 16-GiB and a 2-GiB pod are deleted. (b) A daemon
   with ``TPUSHARE_FAULTS=allocator.post_persist=crash:1`` and
   ``--reconcile-interval 0`` dies in one Allocate after its PATCH (the
   WAL holds one unresolved begin) and is SIGKILLed; a second daemon on
   the same plugin dir and WAL registers, replays exactly one entry,
   raises the fence generation by one, lets its reconciler commit the
   entry, admits a fresh pod and exits 0 on SIGTERM. (c) Each daemon holds
   under ``CONTEXT_BYTES`` of the card, where a control context holds
   more, and maps no ``libtorch``. It prints the informer's first list,
   the Allocates' ms p50 / p99, the reclaim's seconds, the replay count,
   the fence generations and its seconds, and must take under 30 s. The
   daemon (a) also runs the node's loops (``--defrag-interval 0.25
   --interference-interval 0.25 --timeline-interval 0.25 --metrics-port N``):
   after the admissions the node's defrag status must show 0 moves on one
   card, and ``python -m gpushare_device_plugin_tpu_torch.cli.inspect``
   (what ``kubectl-inspect-gpushare-cuda`` runs) in a child that imports no
   torch must show card 0 at 76 of 79 GiB with every pod on it; before (a)
   stops, the child renders the daemon's ``/timeline`` with at least two
   ``util_pct`` samples (its buckets are 10 s wide, so this waits for a
   second one). The
   cluster half is held to the reference on the CPU
   (``tests/test_torch_cluster_*.py``).

24. A live defragmentation move of a serving pod's slice, on phase 2's
   weights cut to their first 4 layers (DEFRAG_LAYERS). A fake apiserver's
   node lists two cards, 0 and 1, and both are the one H100 (a move
   across cards needs two; phase 20's gang env is written by hand for the
   same reason). Two ``PagedSlotEngine``s, each sized by the plugin env of
   an 8-GiB slice, serve an 8-request ``poisson_trace`` (prompts 128-512,
   max_new 32-64); one undrained run gives the reference tokens. Then
   three moves of a pod from card 0 to card 1 through the port's
   ``SliceMover`` (a real WAL, ``AssumeCache`` and apiserver PATCHes): its
   drain hook calls ``request_drain`` / ``wait_drained`` on the source
   while it serves on a thread, its restore hook ``restore_snapshot`` on
   the destination. One move is clean; one dies past the switch
   (``defrag.switch``) and a fresh ``DriftReconciler`` rolls it forward
   from the journaled snapshot; one dies before it (``defrag.copy``) and
   rolls back, the source re-serving its own snapshot. Fails unless the
   pre-drain plus the restored tokens are the undrained run's (or leave
   them only at a near tie, phase 3's rule), no request is lost or served
   twice, a second delivery of the journaled snapshot serves nothing, the
   WAL and the ledger are empty, the pod's annotation names card 1 (card
   0 after the roll-back), and each restore launched ``flash_fwd`` once a
   layer per prefill dispatch. Prints each move's host seconds (drain,
   WAL and PATCH, restore) and, for the clean move's restore, run under
   ``torch.profiler`` (which slows its host seconds), its kernel seconds.
   The whole phase runs under the port's lock-order witness
   (``lockrank.set_witness(True)`` before its engines, WAL and mover are
   made): it prints the violations counted and the names of the ranked
   locks acquired, and fails on any violation or unless ``serving.drain``
   and ``serving.radix`` (the drain handshake's and the radix cache's
   locks, taken by the serving thread and the mover) are among them.
   (d) One more clean move, of a slice serving ``quantize_decoder``'s tree
   of the same 4 layers with an int8 KV cache, held to the same gates.
25. The scheduler extender, host only (it builds nothing and launches no
   kernel; under ``EXTENDER_BUDGET_S``). (a) Phase 23's 50-node cluster, the
   other 49 nodes at 78 of their 79 GiB and this node's 16 share pods
   pending with no node. The port's extender (``python -m
   gpushare_device_plugin_tpu_torch.extender.server --port P --metrics-port
   M1 --checkpoint-path ...``) receives each pod's ``/scheduler/filter``
   and ``/scheduler/prioritize`` with the 50 node objects (the extender
   stanza in ``deploy/scheduler-extender.yaml`` is not node-cache capable),
   then ``/scheduler/bind`` to its top node; phase 23's daemon admits the
   16 through a kubelet of the port's bindings. Fails unless every pod is
   bound here, ``simcluster.audit_cluster`` over the 50 nodes is empty,
   the envs' card and units are the extender's annotations, ``inspect
   trace default/<pod>`` in a child without torch over both processes'
   ``/traces`` renders one tree (admission, ``extender.bind``,
   ``plugin.allocate``), both exit 0 on SIGTERM and the extender loads no
   torch (``-X importtime``, ``/proc/<pid>/maps``). Prints each verb's ms
   p50 / p99. (b) In process, the reference bench's largest scale
   configuration (1,000 ``make_cluster`` nodes, 8 shards each with its own
   WAL, fanout 2, 8 workers, 600 events) with a gang group every 40
   arrivals: the audit empty, no gang2pc entry after ``resolve_gang2pc``;
   prints admissions/s, admit p50 / p99 ms, gang groups and failures. Then
   the same under the lock-order witness at the bench's smoke settings
   (``WITNESSED_DRILL``; the witness triples the full run's host time): no
   lock-order violation either. (c) ``python -m
   gpushare_device_plugin_tpu_torch.extender.shards --shards 4
   --checkpoint-dir D --metrics-port M2``'s ``main`` in a child armed with
   ``TPUSHARE_FAULTS=gang2pc.commit=crash:1`` admits a two-member gang
   group across shards (the webhook has no verb for a group, so the child
   drives the router ``main`` built, in process), dies at the commit and
   is SIGKILLed; a second ``python -m ... extender.shards`` on the same
   ``D`` must leave no gang in flight and the group whole (its decision
   was durable: rolled forward), and ``inspect shards`` in a child without
   torch must render its ``/shards``.

26. BERT's and ResNet's sharded training on the one card, two gloo ranks
   as in phase 19, each capped by the plugin's env for a 16-GiB slice.
   First the three main-path kernels at a rank's BERT-base shapes (fsdp=2:
   4 x 512, 12 heads; tp=2: 8 x 512, 6 heads; D=64, non-causal) against
   their plain versions, timed beside SDPA. Then ``bert_base()`` at full
   width and depth, bf16, remat, B=8 x S=512 of ``demo_batch``, AdamW, 6
   steps: a 1-rank control here, then ``MeshSpec(fsdp=2)`` and
   ``MeshSpec(tp=2)`` on the two ranks; and ``resnet50()`` at 224, B=16,
   SGD with Nesterov momentum 0.9 at 0.001 for 8 steps: a control, then
   dp=2 and fsdp=2. Each rank first runs the first step in f32 on its shards and
   the control's in f32 and bf16: its f32 loss by phase 6's rule, every
   leaf's f32 gradient (summed over the leaf's axes; its blocks against
   the control's, the squares added over the axes a leaf is cut on) by
   phase 6's rule and none zero, ResNet's new BN state by the same rule.
   Then the bf16 run: its first loss by phase 6's rule against the
   control's, its first-step gradients nonzero (their error against the
   bf16 control's printed), ResNet's BN running mean and variance after
   step 1 by phase 6's rule (synchronized batch norm), losses falling,
   its parameter bytes its shards', and BERT's launches per rank and mesh
   ``flash_fwd`` 2 x 12 x 6 = 144, ``flash_bwd_dq`` 72, ``flash_bwd_dkv`` 72
   and no scalar entry. Prints each run's step p50,
   peak reserved memory and exchanges (calls, bytes, host seconds).

27. Quantized serving, on phase 2's bf16 weights at full width and depth
   (run straight after phase 24). (a) The reference bench's
   ``bench_serve``: ``quantize_decoder`` (a layer, or a block of the
   embedding's rows or the head's columns, at a time; layers 0-1 of ``wi``
   and the whole head must equal a whole-leaf ``quantize``), the bf16 and
   int8 ``param_bytes`` and the KV bytes at batch 8 x (2,048 + 32) for both
   cache dtypes; one 2,048-token prompt's int8 prefill logits against
   bf16's, rel-L2 at most 0.1 (the reference's gate), and whether the
   argmax matches; then ``make_generate`` for bf16, int8, bf16 with an
   int8 KV cache and int8 with an int8 KV cache at batch 1 and 8 on
   2,048-token prompts, 32 new tokens (the reference's 128, cut for time),
   a warm-up of 2 tokens and one timed run each: every output of the expected shape
   in the vocabulary, every wall at least 32 weight streams at 3.35 TB/s
   over 1.25, ``flash_fwd`` 32 times a generate call. (b) The int8 pod: a
   child with only the plugin's env for a 16-GiB slice caps itself
   (``configure_torch_from_env``), must see ``slots_from_pod_env`` refuse
   the bf16 tree's bytes with the reference's "quantize" error, draws an
   int8 8B tree a leaf at a time (the whole bf16 tree does not fit),
   sizes ``PagedSlotEngine`` with ``paged_plan_from_pod_env(kv_dtype=
   "int8")`` (212 slots over 6,864 pages: the reference's plan), serves
   phase 2's trace's first 8 requests at 32 layers with an int8 KV cache,
   and holds each request's tokens to solo greedy decode on the same tree
   and cache (phase 3's near-tie rule); shape guard, no page leaked,
   ``flash_fwd`` 32 times a prefill dispatch, peak reserved memory at or
   below the cap; an OOM fails the phase. Prints the pages, slots, peak,
   cap, TTFT and decode step p50.
28. int8 on the serving paths phase 27 bypasses, on phase 2's bf16 weights
   (run straight after phase 27). (b) Phase 15's run A with the target cut
   to 4 layers and its Llama-3.2-1B-shaped draft (4 of 16) both
   ``quantize_decoder``'d, int8 KV, the pool from
   ``paged_plan_from_pod_env(draft_cfg=..., kv_dtype="int8")``: tokens a
   plain int8 engine's or within phase 3's near-tie rule, rollback pages,
   no page leaked, the five programs' guard, ``flash_fwd`` per prefill
   dispatch 4 at D=128 and 4 at D=64 (counted by head dim). (c) Phase
   17's live handoff over the int8 tree of its 4 layers, int8 KV on both
   tiers and the unified engine: nothing dropped, a delivery, no pending
   journal entry or staged page, tokens the unified engine's or within
   the near-tie rule; prints the wire bytes per page against a bf16
   page's and a handoff's wall split. (a) Multi-LoRA over the int8 8B cut
   to 16 layers in a 16-GiB pod: phase 13's four tenants drawn for phase
   2's weights, each tenant's int8-base prefill logits against bf16
   merged-solo within rel-L2 0.1; then a child with only the plugin's env
   loads its int8 tree through host memory, sizes a 16-slot pool with
   ``paged_plan_from_pod_env(lora=True, kv_dtype="int8")`` (at least 8
   max_len rows of pages), serves each tenant's and the base model's
   first request of phase 13's trace (the pod loads its tree and warms up
   while (b) and (c) run, and serves once they end, alone on the card),
   then serves each alone on the same engine: every token equal to its
   one-request run's or within the near-tie rule, at least 4 adapter
   misses, no page leaked, the shape guard, ``flash_fwd`` 16 a prefill
   dispatch, peak reserved at or below the cap; an OOM fails the phase.

The phases run in the order 1, 21, 22, 23, 25, 2, 3, 2 (c), 7, 8, 13, 15,
16, 17, 18, 24, 27, 28, 14, 4, 5, 6, 9-12, 19, 20, 26; each phase's seconds
print on one JSON line (``phase seconds``) before the script's. ``python3
chip_smoke.py --phase 17`` (or ``--phase 18``, ``--phase 19``, ``--phase
20``, ``--phase 24``, ``--phase 26``, ``--phase 27`` or ``--phase 28``) builds
the kernels and runs that phase alone on fresh weights (a quick check; it
prints no contract lines); ``--phase 21``, ``--phase 22``, ``--phase
23`` and ``--phase 25`` run that phase alone and build nothing (they
launch no kernel).
Phase 1 and 4 also hold every entry at BERT-base's attention shape
(bf16, B=32, S=512, H=Hkv=12, D=64, non-causal: the scalar entries on the
same inputs too), non-causal f32 at S=512, and a non-causal ragged S=300
in bf16. Phase 7's run A sizes its pool with ``paged_plan_from_pod_env``
from a plugin-style env for a 24-unit slice.

The children run ``python3 -c "import chip_smoke; chip_smoke.pod_main(...)"``
(:func:`pod_main`) from the same directory; they load the kernels the
parent built in phase 1.

Float32 matrix products run in full f32 (TF32 off, set below). The last
line of stdout is ``{"ok": true, "device": {...}}``; the line before it
is the card's name and power limit from ``nvidia-smi``; before that, the
script's seconds and each phase's; before those, one
JSON line ``{"kernels": [...]}``, whose launches per path include
``lora_serve`` (phase 13, runs A and B), ``lora_train`` (phase 14's
pod, from its JSON line), ``spec_serve`` (phase 15, runs A and B),
``interference`` (phase 16, both tenants), ``disagg`` (phase 17's
live handoff run, both tiers), ``fleet`` (phase 18's affinity run,
all three engines), ``defrag`` (phase 24's restores), ``ring`` and ``ulysses`` (phase 19 (b)'s runs, both
ranks), ``tp_serve``, ``tp_paged`` and ``tp_train`` (phase 20's (a1),
(a2) and (b), both ranks, (b) both meshes), ``static_baseline`` (phase 2
(c)), ``train_bert_fsdp`` and ``train_bert_tp`` (phase 26, both ranks),
``int8_serve`` (phase 27 (a)'s generate runs), ``int8_pod`` (phase 27
(b)'s pod), ``int8_lora_pod``, ``int8_spec`` and ``int8_disagg`` (phase
28 (a)'s pod, (b)'s speculative run, (c)'s live run), ``int8_tp_serve``
(phase 20's int8 KV run, both ranks) and ``int8_defrag`` (phase 24 (d)'s
restore); the ``flash_fwd`` row also carries ``int8_spec_by_head_dim``;
the forward rows carry ``at_draft_shape``, and the main-path rows
``at_ring_hop_shape``, ``at_ulysses_shape`` (phase 19),
``at_tp_train_shape`` (phase 20), ``at_bert_fsdp_shape`` and
``at_bert_tp_shape`` (phase 26).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import importlib.util
import json
import logging
import math
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from gpushare_device_plugin_tpu_torch import const
from gpushare_device_plugin_tpu_torch.allocator.binpack import AssignmentError
from gpushare_device_plugin_tpu_torch.allocator.local import LocalAllocator
from gpushare_device_plugin_tpu_torch.device import DeviceInventory
from gpushare_device_plugin_tpu_torch.discovery import from_name
from gpushare_device_plugin_tpu_torch.discovery.nvmldev import NvmlBackend, pair_with_cuda
from gpushare_device_plugin_tpu_torch.ops import _build
from gpushare_device_plugin_tpu_torch.ops import flash_attention as fa
from gpushare_device_plugin_tpu_torch.parallel.collectives import all_reduce, all_reduce_sum_
from gpushare_device_plugin_tpu_torch.parallel.mesh import (
    Mesh,
    MeshSpec,
    make_mesh,
    shard,
    shard_axes,
)
from gpushare_device_plugin_tpu_torch.parallel.podenv import (
    MEMORY_FRACTION,
    PodTpuEnv,
    configure_torch_from_env,
    gang_mesh,
    initialize_multihost,
)
from gpushare_device_plugin_tpu_torch.parallel.ring import ring_attention
from gpushare_device_plugin_tpu_torch.parallel.ulysses import ulysses_attention
from gpushare_device_plugin_tpu_torch.serving import StepGovernor
from gpushare_device_plugin_tpu_torch.serving.engine import (
    TIER_CRITICAL,
    PagedSlotEngine,
    Request,
    SlotEngine,
    kv_slot_bytes,
    paged_plan_from_pod_env,
    poisson_trace,
    run_static_baseline,
    shared_prefix_trace,
    slots_from_pod_env,
)
from gpushare_device_plugin_tpu_torch.serving.pages import paged_plan_for_slice, pages_for
from gpushare_device_plugin_tpu_torch.serving.profiler import ceil_rank_quantile
from gpushare_device_plugin_tpu_torch.utils import metric_catalog as MC
from gpushare_device_plugin_tpu_torch.utils import tracing
from gpushare_device_plugin_tpu_torch.utils.metrics import MetricsServer
from gpushare_device_plugin_tpu_torch.utils.slo import SloBudget, SloObjective
from gpushare_device_plugin_tpu_torch.workloads import bert as B
from gpushare_device_plugin_tpu_torch.workloads import generate as G
from gpushare_device_plugin_tpu_torch.workloads import lora as L
from gpushare_device_plugin_tpu_torch.workloads import mnist
from gpushare_device_plugin_tpu_torch.workloads import quant as Q
from gpushare_device_plugin_tpu_torch.workloads import resnet as R
from gpushare_device_plugin_tpu_torch.workloads import transformer as T
from gpushare_device_plugin_tpu_torch.workloads.attention import ulysses_inner_attn
from gpushare_device_plugin_tpu_torch.workloads.optim import make_optimizer, tree_leaves
from gpushare_device_plugin_tpu_torch.workloads.trainer import (
    BertTask,
    DecoderTask,
    ResNetTask,
    TrainLoopConfig,
    fold_in,
    run_train_loop,
)
from gpushare_device_plugin_tpu_torch.workloads.transformer import init_params, llama3_8b

# H100 SXM published peaks (dense): device memory rate and the operation
# rate per input type (f32 runs outside the tensor cores).
MEM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Kernel vs plain tolerances. f32: both sum the same f32 terms in another
# order. bf16: O is rounded to an 8-bit mantissa and P is rounded to bf16
# before the PV product in both, at other running maxima, so they may
# differ by two roundings: |diff| <= 2^-7 * max(|plain|, 1). lse is f32 in
# both from the same exact products.
F32_ATOL = 1e-5
BF16_REL = 2.0 ** -7
LSE_ATOL = 1e-4
# End to end in bf16 (32 layers): the engine's batched products and the
# solo run's take other cuBLAS algorithms, so logits differ slightly, and
# the logits are bf16 values (the output projection runs in bf16), so
# near ties are common over a 128k vocabulary. A token may differ only at
# a step where the solo run's top-two gap is at most TOP2_GAP_REL * |top
# logit| (two bf16 steps); from there on the sequences are not compared.
# The flash and plain prefills' last-position logits must agree within
# LOGIT_REL * max|logit| (four bf16 steps).
TOP2_GAP_REL = 2.0 ** -6
LOGIT_REL = 2.0 ** -5
SERVED_S = 512  # the engine's prompt chunk: the kernel's shape on the main path
SERVE_TRACE = dict(n=16, seed=0, rate=0.5, prompt_lens=(128, 1536), max_new=(16, 64))
STATIC_BATCH = 8  # phase 2 (c)'s lockstep waves
EOS_ID = 128001  # Llama-3's end-of-text token
# Phase 7: run A sizes its pool for a 24-unit (GiB) slice of the card from
# the env the plugin injects, which for the 8B weights at PAGED_LAYERS layers
# buys 73,797 pages of 0.25 MiB (3,399 of 2 MiB at 32); run B gets two
# max_len rows of pages (the minimum is one), so requests preempt. Phases 7
# and 8 serve phase 2's model cut to its first PAGED_LAYERS layers (full
# width): at 32 layers they took 147 s on one H100, at 8 42 s, which the
# script's time limit cannot spare on a slower host.
PAGED_SLICE_UNITS = 24
PAGED_LAYERS = 4
RUN_A_PAGES = 73797
PRESSURE_PAGES = 256
PAGED_PROFILE_CONTEXT = 1536  # positions each row reads in the profiled decode step
# Phase 13: four tenants' adapters on every target the hooks have, each
# target's delta scaled to LORA_RATIO of its weight (Frobenius norms over
# the layer stack), so every tenant's tokens leave the base model's. The
# phase serves phase 2's model cut to its first LORA_SERVE_LAYERS layers
# (full width): at 32 layers it took 197-243 s on one H100, at 16 86 s, at
# 8 47 s, which the script's time limit cannot spare. At rank 8 and 4 layers
# an adapter is 2,359,296 floats, 36 slab pages of 16 x 4096; run B's pool holds
# two max_len rows and two adapters, so adapters evict and rows preempt.
LORA_TENANTS = ("t0", "t1", "t2", "t3")
LORA_TARGETS = ("wq", "wkv", "wo", "wi", "wdown")
LORA_RANK, LORA_ALPHA, LORA_RATIO = 8, 16.0, 0.2
LORA_SERVE_LAYERS = 4
# Run B serves the trace's first LORA_PRESSURE_REQUESTS requests (of 24),
# to keep the script's time down: it then evicts 6 adapters in 364 ticks
# (24 requests: 8 in 722), as the same lengths and pages give on the CPU.
LORA_PRESSURE_REQUESTS = 12
# Phase 7's trace but for the seed: seed 0's 24 draws from the five ids name
# no request for t2, so phase 13 takes seed 1, the first whose requests
# name all four tenants and the base model (6, 4, 5, 4, 5 of them).
LORA_TRACE_SEED = 1
# BGMV against merge_lora + prefill, last-position logits of a bf16
# prefill: the merged path rounds every adapted weight (W + delta) to
# bf16, a relative change of up to 2^-9 in each entry of five of the seven
# matrices of every layer, where the BGMV path rounds W, x·A and the
# delta apart. Phase 3's flash vs plain (which rounds P otherwise) reaches
# 2^-5.6 of the largest logit and is held to 2^-5 (four bf16 steps); this
# allows as much again: 2^-4 of the largest logit.
LORA_LOGIT_REL = 2.0 ** -4
# The same rounding moves each served logit by up to four bf16 steps at the
# top (0.121 at a top logit of 4.34 on one H100), twice what phase 3's
# engine-vs-solo differences reach, so a tenant's tokens may first leave
# merged-solo's at a step whose solo top-two gap is up to four bf16 steps,
# 2^-5 of the top logit (phase 3's rule: 2^-6). A request of this trace
# first diverges at a gap of three steps (0.094 at 4.34).
LORA_TOP2_GAP_REL = 2.0 ** -5
# Phase 15: the draft has Llama-3.2-1B's published shape (vocab 128256, d
# 2048, 16 layers, 32 heads over 8 kv heads, so head dim 64, d_ff 8192, RoPE
# theta 500000), bf16, seeded random weights. It differs from the
# published model where TransformerConfig models less: its output head is
# a matrix of its own (the published one is tied to the embedding), and
# RoPE has no llama3 frequency scaling. 1.50 B parameters, 3.0 GB; a page
# of its KV (16 positions) is 0.5 MiB beside the target's 2 MiB (at the
# phase's DRAFT_LAYERS and SPEC_LAYERS: 0.77 B, 1.5 GB; 0.125 and 0.25
# MiB). Run B's
# self-draft accepts all but a few proposals (bf16 near ties between the
# draft's one-token steps and the verify's block): at least SPEC_ACCEPT_MIN.
SPEC_K = 4
DRAFT_D = 64
SPEC_B_REQUESTS = 8
SPEC_ACCEPT_MIN = 0.9
SPEC_MAX_NEW = 32  # the contiguous speculative_generate's run, on a 512-token prompt
# Phase 15 serves the first SPEC_LAYERS of the 8B weights' 32 layers and the
# draft's first DRAFT_LAYERS of its 16: at 16 and 16 it took 150 s on one
# H100, at 8 and 16 121 s (run A's draft rounds most of it), which the
# script's time limit cannot spare on a slower host.
SPEC_LAYERS = 4
DRAFT_LAYERS = 4
# Phase 16: a latency-critical tenant's SlotEngine beside a best-effort
# tenant's PagedSlotEngine, both Llama-3-8B, in one process on one card,
# with the parameters of the reference's bench_mfu.py::bench_serve_interference
# (the objective at 1.3x the solo step p99, goal 0.95; the governor at 0.2
# dispatches a second, a bucket of 0.2, a poll every dispatch, no release).
CRIT_POD, BE_POD = "smoke/critical", "smoke/besteffort"
INTERFERENCE_NODE = "h100-interference-node"
INTERFERENCE_POD_UNITS = 8  # each tenant's slice, as the detector reads the pods
INTERFERENCE_OBJECTIVE = 1.3
INTERFERENCE_GOAL = 0.95
INTERFERENCE_TRIALS = 3
GOVERNOR_KW = dict(throttled_steps_per_s=0.2, burst=0.2, poll_interval_steps=1,
                   release_after=100_000)
BE_SEED = 16  # the best-effort tenant's own weights
# Both tenants are Llama-3-8B at full width cut to their first
# INTERFERENCE_LAYERS layers: at 32 layers the phase took 191-236 s on one
# H100, at 16 116 s, at 8 67 s, which the script's time limit cannot spare.
INTERFERENCE_LAYERS = 4
# The busy-share windows profile a short critical trial: the same requests
# with 16 new tokens, whose tokens are the first 16 of the full trial's (a
# row's tokens depend on its own row only).
BUSY_MAX_NEW = 16
# Phase 17: the reference's bench_mfu.py::bench_serve_disagg at its full
# settings: 24 requests, Poisson arrivals at 0.1 a tick from RandomState(17),
# every 4th prompt long (512-768 tokens), the rest short (16-64), max_new
# drawn from (16, 32, 128); max_len 1024, pages of 64 positions, prompt
# chunks of 256. A prefill tier of 4 slots over 64 pages (4 max_len rows)
# and a decode tier of 8 over 128, beside one unified engine of 8 slots over
# the same 192 pages (a page of the 8B model's KV is 8 MiB at 32 layers, 32
# x 64 positions x 8 kv heads x 128 x 2 bytes x K and V; at the phase's 4
# layers 1 MiB, 0.1875 GiB in all). The
# engines stop at Llama-3's EOS like every phase here (the bench's eos is 2).
DISAGG_REQUESTS, DISAGG_RATE, DISAGG_SEED = 24, 0.1, 17
DISAGG_SHORT, DISAGG_LONG, DISAGG_MIX = (16, 64), (512, 768), (16, 32, 128)
DISAGG_MAX_LEN, DISAGG_PAGE, DISAGG_CHUNK = 1024, 64, 256
DISAGG_PREFILL_SLOTS, DISAGG_DECODE_SLOTS = 4, 8
# The forced fallback serves the trace's first 12 requests: every one
# re-prefills, most then leave the unified engine's tokens at a bf16 near
# tie and are held to solo decode one by one (22 of 24 on all 24, 166 s for
# the phase on one H100), which the script's time limit cannot spare.
DISAGG_FALLBACK_REQUESTS = 12
# Phase 17 serves phase 2's model cut to its first DISAGG_LAYERS layers (full
# width): at 32 layers it took 155-166 s on one H100, at 16 61 s, at 8 39 s,
# which the script's time limit cannot spare.
DISAGG_LAYERS = 4
# Phase 18: the reference's bench_mfu.py::bench_serve_fleet at its full
# settings: shared_prefix_trace(24, seed=23, rate=0.15, prefixes=(3, 384),
# tail_lens=(16, 64), max_new drawn from [16, 32, 128]) over the 8B vocabulary:
# three 384-token system prompts, six 64-token pages each. Three engines of 8
# slots over 128 pages (8 max_len rows of 16 pages; 0.125 GiB each at 4
# layers), max_len 1024, prompt chunks of 256, beside one unified engine of
# 24 slots over 384 pages, on phase 2's model cut to its first FLEET_LAYERS
# layers (full width): at 32 layers the phase took 200.7-357.8 s on one
# H100, at 16 138 s, at 8 83 s, which the script's time limit cannot spare. The scale-down drains e0 at tick 3 (the bench's); the kill run
# serves the trace's first FLEET_KILL_REQUESTS requests and kills e0
# FLEET_KILL_AFTER ticks after its first request arrives, when that request
# is decoding (2 prompt chunks, then at least 16 new tokens). The engines
# stop at Llama-3's EOS (the bench's eos is 2).
FLEET_REQUESTS, FLEET_RATE, FLEET_SEED = 24, 0.15, 23
FLEET_PREFIXES, FLEET_TAILS, FLEET_MIX = (3, 384), (16, 64), [16, 32, 128]
FLEET_ENGINES, FLEET_SLOTS = 3, 8
FLEET_MAX_LEN, FLEET_PAGE, FLEET_CHUNK = 1024, 64, 256
FLEET_SCALE_TICK = 3
FLEET_KILL_REQUESTS, FLEET_KILL_AFTER = 12, 8
FLEET_LAYERS = 4
# Phase 14: the LoRA pod's slice, batch and steps.
LORA_TRAIN_UNITS, LORA_TRAIN_B, LORA_TRAIN_S, LORA_TRAIN_STEPS = 32, 2, 2048, 8
# Backward kernels vs plain. f32: the same f32 sums in another order, over
# up to g*S = 8192 terms, and expf against torch.exp: 1e-4 of the tensor's
# largest magnitude. bf16: P and dS are rounded to an 8-bit mantissa in
# both versions at slightly different f32 scores, and each output once:
# one output rounding, 2^-7 * |plain|, plus 2^-8 of the tensor's largest
# magnitude for the terms that round the other way.
BWD_F32_REL = 1e-4
BWD_BF16_REL = 2.0 ** -7
BWD_BF16_TOP = 2.0 ** -8
TRAIN_B, TRAIN_S, TRAIN_LAYERS, TRAIN_STEPS = 4, 2048, 4, 8
# BERT-base's attention: the phase 1/4 cases at this shape, phases 9-12.
BERT_B, BERT_S, BERT_H, BERT_D = 32, 512, 12, 64
RESNET_B, RESNET_SIZE = 64, 224
BERT_STEPS = 8  # alone and in a pod
# ResNet-50 trains 32 steps, alone and in a pod: the reference's recipe
# (SGD, Nesterov momentum 0.9 at 0.1, no warmup) on random images first
# drives the loss up (the head's step grows with the squared norm of 2,048
# nearly constant features) and brings it below the first step's only
# after about 16 steps; tests/test_torch_resnet.py holds the first steps
# to the JAX reference's, which rise the same way.
RESNET_STEPS = 32
# Phase 11's pods, as (name, workload, slice in GiB, steps): demo/binpack-1's
# four MNIST pods (binpack-1.yaml runs 200 steps, job.yaml 100) and the
# BASELINE.md config-3 pair.
PODS = [("mnist-0", "mnist", 2, 200), ("mnist-1", "mnist", 2, 200),
        ("mnist-2", "mnist", 2, 200), ("mnist-job", "mnist", 2, 100),
        ("bert", "bert", 16, BERT_STEPS), ("resnet", "resnet", 32, RESNET_STEPS)]
SLICE_FULL = 0.95  # a model alone past this share of its slice halves its batch
# Phase 21: the device plugin's own path. NVML discovery and PLUGIN_POLLS
# health polls PLUGIN_POLL_INTERVAL_S apart run in NVML_CHILD, a child that
# must never import torch: the daemon's backend opens no CUDA context.
PLUGIN_POLLS, PLUGIN_POLL_INTERVAL_S = 3, 0.05
NVML_CHILD = r'''
import json, sys, time
from gpushare_device_plugin_tpu_torch.discovery import from_name
polls, interval = int(sys.argv[1]), float(sys.argv[2])
t0 = time.perf_counter()
backend = from_name("nvml", poll_s=0.0)
probe = backend.probe()
chips = backend.chips()
discovery_s = time.perf_counter() - t0
done = [0]


def stop():  # asked once at the top of every poll (poll_s=0)
    done[0] += 1
    if done[0] > 1:
        time.sleep(interval)
    return done[0] > polls


events = [[e.chip_id, e.health.value, e.reason, e.severity] for e in backend.watch_health(stop)]
print(json.dumps({
    "probe": probe, "discovery_s": discovery_s,
    "chips": [[c.id, c.index, c.device_path, c.hbm_bytes] for c in chips],
    "name": backend.topology().generation, "polls": done[0] - 1, "events": events,
    "ecc": backend.error_counters(), "torch_loaded": "torch" in sys.modules,
}))
'''
# Phase 22: the node agent. NODE_AGENT_CHILD drives the standalone manager's
# node half in a child that must load neither torch nor grpc, and must hold
# no CUDA context, as the DaemonSet's process on a GPU node must not; the
# phase must take under NODE_AGENT_BUDGET_S. NVIDIA's nvmlInit_v2 maps
# libcuda.so and opens /dev/nvidia-uvm itself (NVML 580.159.03 on an H100
# host), so what is held to account is the card's memory: the free
# memory while a child lives against after it exits. CUDA_CONTEXT_CHILD, a
# control that only retains the card's primary context through libcuda,
# shows what one context costs, and must cost at least CONTEXT_BYTES.
NODE_AGENT_BUDGET_S = 5.0
CONTEXT_BYTES = 64 << 20
CUDA_CONTEXT_CHILD = r'''
import ctypes, sys
cu = ctypes.CDLL("libcuda.so.1")
dev, ctx = ctypes.c_int(), ctypes.c_void_p()
print([cu.cuInit(0), cu.cuDeviceGet(ctypes.byref(dev), 0),
       cu.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev)], flush=True)
sys.stdin.readline()
'''
NODE_AGENT_CHILD = r'''
import glob, json, os, signal, sys, time
t0 = time.perf_counter()
from gpushare_device_plugin_tpu_torch.discovery import from_name
from gpushare_device_plugin_tpu_torch.discovery.nvmldev import NvmlBackend
from gpushare_device_plugin_tpu_torch.manager import HealthWatcher, ManagerConfig, TpuShareManager

pods, polls, interval, tmp = json.loads(sys.argv[1]), int(sys.argv[2]), float(sys.argv[3]), sys.argv[4]


def libcuda():
    return "libcuda" in open("/proc/self/maps").read()


def device_files():
    """The /dev/nvidia* files this process holds open."""
    out = set()
    for fd in os.listdir("/proc/self/fd"):
        try:
            path = os.readlink(f"/proc/self/fd/{fd}")
        except OSError:
            continue
        if path.startswith("/dev/nvidia"):
            out.add(path)
    return sorted(out)


libcuda_before_nvml = libcuda()  # the port's own imports
cfg = ManagerConfig(standalone=True, health_check=True, plugin_dir=os.path.join(tmp, "plugins"),
                    coredump_dir=os.path.join(tmp, "core"), flightrecord_dir=os.path.join(tmp, "fr"))
os.makedirs(cfg.coredump_dir)
manager = TpuShareManager(from_name("auto"), cfg)
backend = manager._backend
out = {"auto": type(backend).__name__}
t = time.perf_counter()
inv = manager._build_inventory()
out["inventory_s"] = time.perf_counter() - t
out["chips"] = [[c.id, inv.units_of(c.id)] for c in inv.chips()]
ids = [d.id for d in inv.mem_fake_devices()]


def refused(fn, granted):
    try:
        fn(granted)
        return None
    except RuntimeError as e:  # AssignmentError, or a refused hold
        return str(e)


# the mem plugin's allocate function: phase 11's pods, then one too many
mem = manager._build_allocator(inv, unhealthy_fn=lambda: [])
core = manager._build_core_allocate_fn(inv, unhealthy_fn=lambda: [])
grants, grant_us, used = {}, {}, 0
for name, units in pods:
    t = time.perf_counter()
    (grant,) = mem([ids[used:used + units]])
    grant_us[name] = (time.perf_counter() - t) * 1e6
    grants[name] = grant.envs
    used += units
out.update(grants=grants, grant_us=grant_us, used=manager._local.used_by_chip())
left = inv.total_units() - used
out["seventh"] = [left + 1, refused(mem, [ids[:left + 1]])]
# a core hold of a card with mem units in use is refused
chip0 = inv.chips()[0].id
out["core_while_mem"] = refused(core, [[chip0]])
# a rebuild (what SIGHUP or a kubelet restart does) starts a fresh
# allocator: every mem unit released; the hold goes through, then a mem
# grant has no card left
mem = manager._build_allocator(inv, unhealthy_fn=lambda: [])
core = manager._build_core_allocate_fn(inv, unhealthy_fn=lambda: [])
(hold,) = core([[chip0]])
out["core_hold"] = hold.envs
out["mem_while_held"] = refused(mem, [ids[:1]])
out["core_held"] = sorted(manager._local.core_held())

# health: NVML polls through a HealthWatcher into the manager's allocator sink
backend._poll_s = interval  # the daemon's default is 5 s a poll
seen, events = [], []
read = backend.error_counters


def counted(devices=None):  # NVML's counters are read once a poll
    seen.append(time.perf_counter())
    return read(devices)


backend.error_counters = counted
watcher = HealthWatcher(backend, sinks=[manager._local_sink(inv)], on_event=events.append)
t = time.perf_counter()
watcher.start()
while len(seen) < polls and time.perf_counter() - t < 3.0:
    time.sleep(0.005)
watcher.stop()
out.update(polls=len(seen), poll_s=time.perf_counter() - t, restarts=watcher.restarts,
           events=[[e.chip_id, e.health.value, e.reason, e.severity] for e in events],
           unhealthy=sorted(manager._local._unhealthy))

# signals: SIGQUIT's stack dump, SIGUSR1's flight record
manager._install_flight_recorder()
manager.install_signal_handlers()


def wait_for(pattern, timeout=2.0):
    t = time.perf_counter()
    while time.perf_counter() - t < timeout:
        found = glob.glob(pattern)
        if found:
            return found[0]
        time.sleep(0.005)
    return None


t = time.perf_counter()
os.kill(os.getpid(), signal.SIGQUIT)
stack = wait_for(os.path.join(cfg.coredump_dir, "tpushare_*.txt"))
out["stack_dump"] = stack and os.path.basename(stack)
out["stack_threads"] = stack and open(stack).read().count("--- thread ")
os.kill(os.getpid(), signal.SIGUSR1)
record = wait_for(os.path.join(cfg.flightrecord_dir, "tpushare-flightrec-*-SIGUSR1.json"))
out["flight_record"] = record and os.path.basename(record)
out["flight_record_keys"] = record and sorted(json.load(open(record)))
out["signals_s"] = time.perf_counter() - t
out.update(torch_loaded="torch" in sys.modules, grpc_loaded="grpc" in sys.modules,
           libcuda_before_nvml=libcuda_before_nvml, libcuda_mapped=libcuda(),
           device_files=device_files(), seconds=time.perf_counter() - t0)
print(json.dumps(out), flush=True)
sys.stdin.readline()  # the parent reads the card's free memory while this process lives
'''
# Phase 23: the node agent in cluster mode. The fake apiserver
# (tests/fake_apiserver.py, loaded by path: it imports only the standard
# library) holds CLUSTER_NODES nodes of CLUSTER_NODE_PODS pods each: the
# kubelet's default max-pods (110) at the Kubernetes documentation's
# "Considerations for large clusters" scale, cut from 5,000 nodes to 50 for
# the phase's time. This node's pods: CLUSTER_NODE_PODS less the share pods
# ask for nothing; the share pods are phase 11's six slices and ten more of
# 2 GiB (76 of the card's 79 GiB), pending with the extender's assume
# annotations for card 0. A kubelet made of the port's v1beta1 bindings
# sends their Allocates CLUSTER_WORKERS at a time.
CLUSTER_NODES, CLUSTER_NODE_PODS = 50, 110
CLUSTER_SHARE_UNITS = [units for _, _, units, _ in PODS] + [2] * 10
CLUSTER_WORKERS = 8
CLUSTER_NODE = "h100-node-0"
CLUSTER_BUDGET_S = 30.0
CLUSTER_DAEMON_TIMEOUT_S = 20.0
# The extender's per-container allocation annotation (the reference's
# const.ANN_EXTENDER_ALLOCATION), written with its assume annotations.
ANN_EXTENDER_ALLOCATION = "scheduler.framework.tpushare.allocation"
OOM_MARK = "POD-OOM"
READY = "POD-READY"
POD_TIMEOUT_S = 600
# Phase 19: context parallelism, every rank a process on the one card,
# capped by the plugin's env and joined by the multi-host env over gloo
# (NCCL refuses two ranks on one card, and gloo has no CUDA send, receive
# or all-to-all, so each exchange goes through host memory). (a) attention
# at Llama-3-8B's heads (32/8, D=128), global B=1 x CP_ATTN_S over
# CP_ATTN_RANKS ranks: the ring's hops are 1 x 4,096. (b) the decoder at
# llama3_8b() width cut to CP_TRAIN_LAYERS layers, B=1 x CP_TRAIN_S, on
# CP_TRAIN_RANKS ranks at sp=2 beside a 1-rank control. A rank holds 1.49 B
# f32 parameters with their gradients and AdamW moments (23.8 GB) and the
# logits of 4,096 tokens (about 7 GB) inside its CP_TRAIN_UNITS-GiB slice.
CP_SEED = 19
CP_ATTN_S, CP_ATTN_RANKS, CP_ATTN_UNITS = 16384, 4, 8
CP_TRAIN_S, CP_TRAIN_LAYERS, CP_TRAIN_STEPS = 8192, 2, 3
CP_TRAIN_RANKS, CP_TRAIN_UNITS = 2, 36
# The kernels at the phase's new shapes: (B, S, H, Hkv, causal).
CP_KERNEL_SHAPES = {"ring_hop": (1, CP_ATTN_S // CP_ATTN_RANKS, 32, 8, False),
                    "ulysses": (1, CP_TRAIN_S, 32 // CP_TRAIN_RANKS, 8 // CP_TRAIN_RANKS, True)}
CP_COLLECTIVE_TIMEOUT_S = 300  # a rank's rendezvous and each collective
CP_TIMEOUT_S = 600  # a run of ranks, start to exit
# Phase 20: tensor parallelism and FSDP on the one card, TP_RANKS gloo
# ranks. (a1) the reference's bench_serve_tp trace at its full settings
# (bench_mfu.py): slots 8, max_len 1,024, chunk 256, 24 requests, prompts
# 64-512, max_new drawn from (16, 24, 32, 192), seed 13, on llama3_8b()'s
# weights drawn at 32 layers and served cut to their first TP_SERVE_LAYERS
# (at 32 the phase took 131.4-243.9 s on one H100, at 16 117 s, at 8 90 s,
# which the script's time limit cannot spare); each rank holds half the weights (8.0 GB drawn) and
# half the KV, inside a TP_SERVE_UNITS-GiB share of the card (its init
# draws the largest leaf, wi at 7.5 GB in bf16, whole). (a2) the first
# TP_PAGED_REQUESTS requests of phase 13's trace and its four tenants on
# the model cut to TP_PAGED_LAYERS layers (at 16, the ranks' part took
# 20-25 s on one H100, at 8 13-17 s, which the script's time limit cannot
# spare), the
# pool sized by paged_plan_for_slice for a TP_PAGED_UNITS-GiB share of each
# of the two chips. (b) llama3_8b() width at TP_TRAIN_LAYERS layers, B=2 x 2,048,
# AdamW with clip_norm 1.0, remat "full", 2 steps (3 took 10-12 s more on
# one H100, which the script's time limit cannot spare): a 1-rank control,
# then fsdp=2, then tp=2 in the same two ranks (each rank also computes the
# control's first-step gradients and holds its own blocks against them).
TP_SEED, TP_RANKS = 20, 2
TP_SERVE_KW = dict(slots=8, max_len=1024, prefill_chunk=256, eos_id=EOS_ID)
TP_TRACE = dict(n=24, seed=13, rate=0.2, prompt_lens=(64, 512), max_new=[16, 24, 32, 192])
TP_SERVE_UNITS = 24
TP_SERVE_LAYERS = 4
# (a1) once more with an int8 KV cache (bf16 weights: a tp gang shards no
# int8 tree, as the reference's shard_params refuses one), on the trace's
# first TP_INT8_REQUESTS requests: K, V and their scales split over tp.
TP_INT8_REQUESTS = 4
TP_PAGED_LAYERS, TP_PAGED_REQUESTS, TP_PAGED_UNITS = 4, 8, 12
TP_PAGED_GEO = dict(max_len=2048, prefill_chunk=512, page_size=16, eos_id=EOS_ID)
TP_TRAIN_LAYERS, TP_TRAIN_B, TP_TRAIN_S, TP_TRAIN_STEPS = 2, 2, 2048, 2
TP_TRAIN_UNITS, TP_CLIP_NORM = 36, 1.0
# The kernels at a tp=2 training rank's shape: (B, S, H, Hkv, causal).
TP_KERNEL_SHAPES = {"tp_train": (TP_TRAIN_B, TP_TRAIN_S, 32 // TP_RANKS, 8 // TP_RANKS, True)}
# Phase 26: BERT's and ResNet's sharded training on the one card,
# SHARD_RANKS gloo ranks, each capped by the plugin's env for a
# SHARD_UNITS-GiB slice (NCCL refuses two ranks on one card). BERT-base at
# full width and depth (12 layers, d 768, 12 heads, vocab 30,522), bf16,
# remat, B=8 x S=512 of demo_batch, the default AdamW: a 1-rank control
# here, then fsdp=2 and tp=2 in the same two ranks, 6 steps (at 3 the
# control's loss had not fallen, 10.814 -> 10.849 -> 10.817 on one H100;
# steps 4-8 sat at 10.67-10.74). ResNet-50 at 224 x 224, B=16: a control,
# then dp=2 and fsdp=2, 8 steps of SGD with Nesterov momentum 0.9 at
# SHARD_RESNET_LR. At the reference's 0.1 (phase 10) random images drive
# the loss up 5-25x before it falls, and over steps 25-32 it still spiked
# above the first step's (9.3 and 11.7 against 6.57 on one H100), so
# "losses falling" would pass or fail by chance; at 0.001 it falls step by
# step. Each rank computes the control's first step in f32 and in bf16 and
# holds its own blocks against them: the gradients in f32 (in bf16 a
# rank's batch of another size takes other GEMM and convolution
# algorithms, and their rounding grows through the network: 3.7% of a
# BERT leaf, 1.2x of ResNet's stem in a first run).
SHARD_SEED, SHARD_RANKS, SHARD_UNITS = 26, 2, 16
SHARD_BERT_B, SHARD_BERT_S, SHARD_BERT_STEPS = 8, 512, 6
SHARD_RESNET_B, SHARD_RESNET_STEPS, SHARD_RESNET_LR = 16, 8, 1e-3
SHARD_MESHES = {"bert": ("fsdp", "tp"), "resnet": ("dp", "fsdp")}
# The kernels at a rank's new BERT-base shapes: (B, S, H, Hkv, causal, D).
SHARD_KERNEL_SHAPES = {
    "bert_fsdp": (SHARD_BERT_B // SHARD_RANKS, SHARD_BERT_S, 12, 12, False, 64),
    "bert_tp": (SHARD_BERT_B, SHARD_BERT_S, 12 // SHARD_RANKS, 12 // SHARD_RANKS, False, 64),
}
# Phase 6, flash vs plain at full width in bf16: the kernels round P and dS
# to bf16 where the plain path keeps f32 softmax (and its bf16 scores), so
# the losses may differ by one bf16 step and each gradient leaf by 2^-5 in
# relative Frobenius norm.
GRAD_LOSS_REL = 2.0 ** -7
GRAD_LEAF_REL = 2.0 ** -5


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(fn, iters: int = 10) -> float | None:
    """Device time of one call of ``fn``: the kernel time ``torch.profiler``
    sums over ``iters`` calls, over ``iters``. Unlike :func:`cuda_ms` it
    leaves out the gaps in which the device waits for the host, which set
    the time of a small call made through a Python wrapper. The profiler
    now and then records no kernel at all; such a window is taken again,
    up to three times, and then the time is None ("not measured")."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        total = sum(getattr(e, "self_device_time_total", 0.0) for e in events)
        if total > 0:
            return total / 1e3 / iters
    return None


def attention_inputs(gen, B, S, H, Hkv, D, dtype):
    """q [B,S,H,D] and k/v as strided views of one [B,S,2,Hkv,D] tensor,
    the layout the decoder's projection hands the kernel."""
    q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype)
    kv = torch.randn((B, S, 2, Hkv, D), generator=gen, device="cuda").to(dtype)
    return q, kv[:, :, 0], kv[:, :, 1]


def case_inputs(gen, dtype, B, S, D, mode):
    """A kernel case's q, k, v and bounds. "noncausal" is BERT-base's
    attention: H = Hkv = 12, q, k, v strided views of one [B,S,3,H,D]
    tensor (BERT's fused projection), no bounds. The other modes are
    Llama-3-8B's causal attention (H=32, Hkv=8): "causal" a full prompt
    chunk (kv_len = S, as prefill_slot passes it), "train" no bounds,
    "start" a left-padded batch whose row 1 has dead rows, "kv_len" a
    right-padded one."""
    if mode == "noncausal":
        qkv = torch.randn((B, S, 3, BERT_H, D), generator=gen, device="cuda").to(dtype)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], dict(causal=False, start=None,
                                                              kv_len=None)
    q, k, v = attention_inputs(gen, B, S, 32, 8, D, dtype)
    start = kv_len = None
    if mode == "causal":
        kv_len = torch.tensor([S], dtype=torch.int32, device="cuda")
    if mode == "start":
        start = torch.tensor([0, 200], dtype=torch.int32, device="cuda")
    if mode == "kv_len":
        kv_len = torch.tensor([S, 300], dtype=torch.int32, device="cuda")
    return q, k, v, dict(causal=True, start=start, kv_len=kv_len)


def sdpa_mask(B, S, bounds):
    """(attn_mask, is_causal) for ``F.scaled_dot_product_attention`` on a
    case's bounds; None when SDPA has no like-for-like call (its dead rows
    are NaN)."""
    if bounds["start"] is not None:
        return None
    if bounds["kv_len"] is not None and bool((bounds["kv_len"] < S).any()):
        return fa._visible(B, S, causal=True, start=None, kv_len=bounds["kv_len"],
                           device="cuda")[:, None], False
    return None, bounds["causal"]


def flash_bound(q, k, v, *, causal, start, kv_len):
    """Least time for this call on the card: each input read once, each
    output written once, against 4*D flops per visible (query, key) pair
    per head, counted from these inputs' masks. Returns (ms, what bounds
    it, flops)."""
    B, S, H, D = q.shape
    vis = fa._visible(B, S, causal=causal, start=start, kv_len=kv_len, device=q.device)
    flops = 4.0 * D * H * float(vis.sum())
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v)) * 1.0
    nbytes += q.numel() * q.element_size() + B * S * H * 4  # O and lse
    nbytes += sum(b.numel() * 4 for b in (start, kv_len) if b is not None)
    t_ops = flops / PEAK_OPS_PER_S[q.dtype]
    t_mem = nbytes / MEM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes"), flops


def compare(o, lse, po, plse, dtype):
    """Max |O - plain| and whether O and lse are within tolerance."""
    err = (o.float() - po.float()).abs()
    if dtype == torch.float32:
        ok = bool((err <= F32_ATOL).all())
    else:
        ok = bool((err <= BF16_REL * po.float().abs().clamp(min=1.0)).all())
    dead = torch.isneginf(plse)
    ok &= bool((torch.isneginf(lse) == dead).all())
    ok &= bool(((lse - plse).abs()[~dead] <= LSE_ATOL).all())
    ok &= bool(torch.isfinite(o.float()).all())
    return float(err.max()), ok


def phase_kernels(gen) -> dict:
    """Phase 1; returns the rows at the served, the draft's served, the
    training and the BERT shape, by (kernel entry, "served", "draft",
    "train" or "bert")."""
    print("phase 1: flash forward kernels vs plain", flush=True)
    failures = 0
    rows = {}
    shapes = {(torch.bfloat16, 1, SERVED_S, 128, "causal"): "served",
              (torch.bfloat16, 1, SERVED_S, DRAFT_D, "causal"): "draft",
              (torch.bfloat16, TRAIN_B, TRAIN_S, 128, "train"): "train",
              (torch.bfloat16, BERT_B, BERT_S, BERT_D, "noncausal"): "bert"}
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for S in (64, 512, 2048):
            cases.append((dtype, 1, S, 128, "causal"))
        cases.append((dtype, 2, 512, 128, "start"))
        cases.append((dtype, 2, 512, 128, "kv_len"))
    cases += [(torch.bfloat16, 1, 300, 128, "causal"), (torch.bfloat16, 1, 2048, 64, "causal"),
              (torch.bfloat16, 1, SERVED_S, DRAFT_D, "causal"),
              (torch.bfloat16, TRAIN_B, TRAIN_S, 128, "train"),
              (torch.bfloat16, BERT_B, BERT_S, BERT_D, "noncausal"),
              (torch.float32, BERT_B, BERT_S, BERT_D, "noncausal"),
              (torch.bfloat16, BERT_B, 300, BERT_D, "noncausal")]
    for case in cases:
        dtype, B, S, D, mode = case
        q, k, v, bounds = case_inputs(gen, dtype, B, S, D, mode)
        plain = lambda: fa.flash_fwd_plain(q, k, v, scale=D ** -0.5, **bounds)  # noqa: E731
        po, plse = plain()
        plain_ms = cuda_ms(plain, 3, warmup=1)
        lib_ms = lib_device_ms = None
        sdpa = sdpa_mask(B, S, bounds)
        if sdpa is not None:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # same tensors, [B,H,S,D] views
            mask, is_causal = sdpa
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask, is_causal=is_causal, enable_gqa=True
            )
            lib_ms = cuda_ms(lib, 20)
            lib_device_ms = device_ms(lib)
        bound_ms, bound_by, flops = flash_bound(q, k, v, **bounds)
        entries = [fa.fwd_entry(dtype, D)]
        if case in shapes:  # the scalar entry too, on the same inputs
            entries.append("flash_fwd_scalar")
        for entry in entries:
            run = lambda: fa._launch_fwd(entry, q, k, v, scale=D ** -0.5, **bounds)  # noqa: E731
            (o, lse), (o2, lse2) = run(), run()
            torch.cuda.synchronize()
            err, ok = compare(o, lse, po, plse, dtype)
            same_bits = torch.equal(o, o2) and torch.equal(lse, lse2)
            ms = cuda_ms(run, 20)
            dev_ms = device_ms(run)
            row = dict(
                kernel=entry, dtype=str(dtype).split(".")[-1], B=B, S=S, H=q.shape[2],
                Hkv=k.shape[2], D=D, mode=mode, max_abs_err=err, ok=ok, same_bits=same_bits,
                ms=ms, device_ms=dev_ms, tflops=flops / ms / 1e9, bound_fraction=bound_ms / ms,
                device_bound_fraction=bound_ms / dev_ms if dev_ms else None, plain_ms=plain_ms,
                library_ms=lib_ms, library_device_ms=lib_device_ms,
                bound_ms=bound_ms, bound_by=bound_by,
            )
            print("  ", json.dumps(row), flush=True)
            failures += not (ok and same_bits)
            if case in shapes:
                rows[(entry, shapes[case])] = row
    if failures:
        raise SystemExit(f"phase 1 failed: {failures} case(s) out of tolerance or not repeatable")
    return rows


def profile_decode_step(engine, steps: int = 3) -> dict:
    """Device busy share of the engine's pool-wide decode step (all rows
    active): summed kernel time from ``torch.profiler`` over the host wall
    time of ``steps`` steps, and the kernels that take most of it. Runs
    after the served trace, on retired rows, and touches no result."""
    from torch.profiler import ProfilerActivity, profile

    toks = torch.ones(engine.n_slots, dtype=torch.long, device="cuda")
    active = torch.ones(engine.n_slots, dtype=torch.bool, device="cuda")
    engine._decode(toks, active)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine._decode(toks, active)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0)  # noqa: E731
    busy_ms = sum(dev_us(e) for e in events) / 1e3 / steps
    top = sorted(events, key=dev_us, reverse=True)[:4]
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "kernels_per_step": sum(e.count for e in events) / steps,
        "top_kernels_ms": {e.key[:60]: dev_us(e) / 1e3 / steps for e in top},
    }


def solo_with_gaps(params, cfg, prompt, max_new):
    """Solo greedy decode of one prompt, step for step as ``generate``
    runs it, with the top-two logit gap at every step."""
    p = torch.tensor([prompt], dtype=torch.long, device="cuda")
    cache = G.init_cache(cfg, 1, len(prompt) + max_new)
    logits, cache = G.prefill(params, p, cache, cfg)
    toks, gaps = [], []
    for step in range(max_new):
        top2 = torch.topk(logits[0], 2).values
        gaps.append((float(top2[0] - top2[1]), float(top2[0].abs())))
        tok = torch.argmax(logits, -1)
        toks.append(int(tok))
        if step + 1 < max_new:
            logits, cache = G.decode_step(params, tok, cache, cfg)
    return toks, gaps


class SoloDecode:
    """:func:`solo_with_gaps`, decoded only as far as a check reads it: the
    near-tie rule compares nothing past the first step where the served
    tokens leave the solo ones, so the decode stops there and resumes if a
    later check reads further. It ends at ``max_new`` tokens or at Llama-3's
    EOS (the engine retires a request there), and then frees its cache. It
    holds no reference to the weights: each call is given them."""

    def __init__(self, params, cfg, prompt, max_new, kv_dtype=None):
        self.max_new = max_new
        self.toks: list[int] = []
        self.gaps: list[tuple[float, float]] = []
        p = torch.tensor([prompt], dtype=torch.long, device="cuda")
        self._cache = G.init_cache(cfg, 1, len(prompt) + max_new, kv_dtype=kv_dtype)
        self._logits, self._cache = G.prefill(params, p, self._cache, cfg)
        self._tok = None

    def done(self) -> bool:
        return len(self.toks) == self.max_new or (bool(self.toks) and self.toks[-1] == EOS_ID)

    def upto(self, params, cfg, n: int) -> list[int]:
        """The solo tokens, decoded to at least ``n`` of them unless the
        decode ends first."""
        while len(self.toks) < n and not self.done():
            if self._tok is not None:
                self._logits, self._cache = G.decode_step(params, self._tok, self._cache, cfg)
            top2 = torch.topk(self._logits[0], 2).values
            self.gaps.append((float(top2[0] - top2[1]), float(top2[0].abs())))
            self._tok = torch.argmax(self._logits, -1)
            self.toks.append(int(self._tok))
        if self.done():
            self._cache = self._logits = self._tok = None
        return self.toks


def check_vs_solo(phase, params, cfg, req, got, want=None, solos=None,
                  gap_rel=TOP2_GAP_REL, kv_dtype=None) -> list[dict]:
    """Hold one request's served tokens against the port's solo greedy
    decode by the near-tie rule: they may differ first only at a step where
    the solo top-two gap is at most ``gap_rel`` * |top|. Tokens that equal
    ``want`` (an earlier run's, already held) need no solo run; ``solos``
    keeps each request's :class:`SoloDecode` (over a ``kv_dtype`` cache),
    so a request held twice decodes once. Returns the divergence, if any,
    for the log."""
    if want is not None and got == want:
        return []
    solos = {} if solos is None else solos
    key = (req.prompt, req.max_new)
    if key not in solos:
        solos[key] = SoloDecode(params, cfg, list(req.prompt), req.max_new, kv_dtype)
    solo = solos[key]
    j = next((i for i, tok in enumerate(got)
              if len(solo.upto(params, cfg, i + 1)) <= i or solo.toks[i] != tok), None)
    if j is None or j >= len(solo.toks):
        n = len(solo.upto(params, cfg, len(got) + 1))
        if n != len(got):
            raise SystemExit(f"{phase} failed: request {req.rid} length {len(got)} != {n}")
        return []
    gap, top = solo.gaps[j]
    if gap > gap_rel * top:
        raise SystemExit(
            f"{phase} failed: request {req.rid} diverges at step {j} "
            f"where the solo top-two gap {gap} > {gap_rel} * {top}"
        )
    return [{"rid": req.rid, "step": j, "solo_top2_gap": gap, "top": top,
             "gap_over_top": gap / top if top else 0.0}]


def tensor_bytes(params) -> int:
    return sum(
        t.numel() * t.element_size() for t in
        [params["embed"], params["out"], params["final_norm"], *params["layers"].values()]
    )


def phase_serve(gen):
    """Phases 2 and 3; returns the served run's kernel launches and decode
    step p50 (ms), the 8B weights and their config."""
    print("phase 2: serve llama3_8b (32 layers, bf16)", flush=True)
    cfg = llama3_8b()
    params = init_params(cfg, gen, device="cuda", dtype=torch.bfloat16)
    weight_gb = tensor_bytes(params) / 1e9
    engine = SlotEngine(params, cfg, slots=8, max_len=2048, prefill_chunk=512, eos_id=EOS_ID)
    engine.warmup()
    trace = poisson_trace(vocab=cfg.vocab, **SERVE_TRACE)
    torch.cuda.reset_peak_memory_stats()
    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0
    stats = engine.run(trace)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    summary = stats.summary()
    serve = {
        "weights_gb": round(weight_gb, 3),
        "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3),
        "requests": summary["requests"],
        "tokens": summary["tokens"],
        "ticks": summary["ticks"],
        "wall_s": summary["wall_s"],
        "goodput_tokens_per_s": summary["goodput_tokens_per_s"],
        "ttft_p50_ms": summary["ttft_p50_ms"],
        "ttft_p99_ms": summary["ttft_p99_ms"],
        "decode_step_p50_ms": engine.profiler.p50() * 1e3,
        "decode_step_p99_ms": engine.profiler.p99() * 1e3,
        "decode_steps": engine.profiler.count,
        "shape_guard": stats.trace_counts,
        "launches": launches,
    }
    print("  serve", json.dumps(serve), flush=True)
    serve["decode_step_profile"] = profile_decode_step(engine)
    print("  decode step profile", json.dumps(serve["decode_step_profile"]), flush=True)
    if stats.trace_counts != {"prefill": 1, "extend": 1, "decode": 1}:
        raise SystemExit(f"phase 2 failed: shape guard moved: {stats.trace_counts}")
    if launches["flash_fwd"] < 1 or launches["flash_fwd_scalar"]:
        raise SystemExit(f"phase 2 failed: the serving path's forward launches {launches}")
    if len(stats.results) != len(trace):
        raise SystemExit("phase 2 failed: not every request was served")

    print("phase 3: engine vs solo generate, flash vs plain prefill", flush=True)
    diverged = []
    for req, res in zip(trace, stats.results):
        if req.rid == 0:
            want, _ = solo_with_gaps(params, cfg, list(req.prompt), req.max_new)
            ref = G.generate(params, [list(req.prompt)], cfg, max_new=req.max_new)
            if ref[0, len(req.prompt):].tolist() != want:
                raise SystemExit("phase 3 failed: solo decode != generate")
        diverged += check_vs_solo("phase 3", params, cfg, req, res.tokens)
    print("  engine vs solo:", len(trace) - len(diverged), "identical,",
          "diverged at near ties:", json.dumps(diverged), flush=True)
    prompt = torch.tensor([list(trace[0].prompt)], dtype=torch.long, device="cuda")
    logits = {}
    for attention in ("flash", "plain"):
        c = dataclasses.replace(cfg, attention=attention)
        cache = G.init_cache(c, 1, prompt.shape[1])
        logits[attention], _ = G.prefill(params, prompt, cache, c)
    diff = float((logits["flash"] - logits["plain"]).abs().max())
    tol = LOGIT_REL * float(logits["plain"].abs().max())
    print(f"  prefill logits flash vs plain: max |diff| {diff} (tolerance {tol})", flush=True)
    if not math.isfinite(diff) or diff > tol:
        raise SystemExit(f"phase 3 failed: flash vs plain logits differ by {diff}")

    return launches, serve["decode_step_p50_ms"], params, cfg


def phase_static_baseline(params, cfg) -> dict:
    """Phase 2 (c), on phase 2's weights cut to their first PAGED_LAYERS
    layers: ``run_static_baseline`` over phase 2's trace in lockstep waves
    of STATIC_BATCH. Each request's tokens must equal solo greedy decode's
    at the same depth, or pass phase 3's near-tie rule; the launches are
    the waves' padded prefills alone (the warmup's wave included), one
    ``flash_fwd`` a layer, and nothing else. Returns its kernel launches."""
    print(f"phase 2 (c): static lockstep baseline, llama3_8b ({PAGED_LAYERS} of 32 layers), "
          f"waves of {STATIC_BATCH}", flush=True)
    cfg = dataclasses.replace(cfg, n_layers=PAGED_LAYERS)
    params = {**params, "layers": {k: v[:PAGED_LAYERS] for k, v in params["layers"].items()}}
    trace = poisson_trace(vocab=cfg.vocab, **SERVE_TRACE)
    fresh_run()
    stats = run_static_baseline(params, cfg, trace, batch=STATIC_BATCH, eos_id=EOS_ID)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    summary = stats.summary()
    waves = len({r.first_token_tick for r in stats.results})
    report = {k: summary[k] for k in ("requests", "tokens", "ticks", "wall_s",
                                      "goodput_tokens_per_s", "goodput_tokens_per_tick",
                                      "ttft_p50_ticks", "ttft_p99_ticks", "ttft_p99_ms")}
    report.update(waves=waves, launches=launches)
    by_rid = {r.rid: r for r in trace}
    diverged = []
    for res in stats.results:
        diverged += check_vs_solo("phase 2 (c)", params, cfg, by_rid[res.rid], res.tokens)
    report["diverged_at_near_ties"] = diverged
    print("  static", json.dumps(report), flush=True)
    want = {e: 0 for e in fa.LAUNCHES} | {"flash_fwd": (waves + 1) * cfg.n_layers}
    if launches != want:
        raise SystemExit(f"phase 2 (c) failed: launches {launches} != {want}")
    if len(stats.results) != len(trace):
        raise SystemExit("phase 2 (c) failed: not every request was served")
    return launches


def profile_paged_decode_step(engine, steps: int = 3) -> dict:
    """Device busy share of a made-up pool-wide decode step of the paged
    engine (not one of the trace's steps: all rows active, each reading
    PAGED_PROFILE_CONTEXT positions of real pages through its table and
    writing to the scratch page): summed kernel time from
    ``torch.profiler`` over the host wall time of ``steps`` steps, the
    kernel count, and the device time of the page gathers
    (``aten::index_select``) and scatters (``aten::index_copy_``). On a
    multi-LoRA engine every row runs a resident adapter (round robin, a
    base-model row among them), and the adapter slab's gathers (the
    ``index_select`` a layer whose input is the slab) are reported apart
    from the page gathers, with their bytes. Runs after the trace; reads pages,
    writes only the scratch page, and puts the rows' lengths back."""
    from torch.profiler import ProfilerActivity, profile

    n, mp, ps = engine.n_slots, engine.row_pages, engine.page_size
    ctx = min(mp - 1, PAGED_PROFILE_CONTEXT // ps)
    tables = torch.zeros((n, mp), dtype=torch.int32)  # SCRATCH
    tables[:, :ctx] = (torch.arange(n * ctx) % engine.total_pages + 1).reshape(n, ctx)
    tables = tables.cuda()
    toks = torch.ones(n, dtype=torch.long, device="cuda")
    active = torch.ones(n, dtype=torch.bool, device="cuda")
    saved = engine.cache["len"]
    atab = None
    if engine.adapters is not None:
        ids = [a for a in sorted(engine.lora_store) if engine.adapters.resident(a)] + [""]
        rows = [engine.adapters.pages_of(ids[i % len(ids)]) if ids[i % len(ids)]
                else [0] * engine.pages_per_adapter for i in range(n)]
        atab = torch.tensor(rows, dtype=torch.int32, device="cuda")

    def step():
        engine._decode(toks, tables, active, atab)

    engine.cache["len"] = torch.full((n,), ctx * ps, dtype=torch.int32, device="cuda")
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    engine.cache["len"] = saved
    averages = prof.key_averages()
    kernels = [e for e in averages if e.device_type.name == "CUDA"]
    busy_ms = sum(getattr(e, "self_device_time_total", 0.0) for e in kernels) / 1e3 / steps
    op_ms = {e.key: getattr(e, "device_time_total", 0.0) / 1e3 / steps for e in averages
             if e.key in ("aten::index_select", "aten::index_copy_")}
    out = {
        "step": f"made up, not from the trace: all {n} rows active at {ctx * ps} positions",
        "context": ctx * ps,
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "kernels_per_step": sum(e.count for e in kernels) / steps,
        "gather_ms": op_ms.get("aten::index_select", 0.0),
        "scatter_ms": op_ms.get("aten::index_copy_", 0.0),
    }
    if atab is not None:
        slab_shape = list(engine._lora_slab.shape)
        adapter = [e for e in prof.key_averages(group_by_input_shape=True)
                   if e.key == "aten::index_select" and e.input_shapes
                   and list(e.input_shapes[0]) == slab_shape]
        adapter_ms = sum(getattr(e, "device_time_total", 0.0) for e in adapter) / 1e3 / steps
        # a layer at a time, each slab row that holds a row's part of the
        # layer read once and written once
        views = G.lora_bgmv_views(engine._lora_slab, atab, engine.cfg, engine.lora_cfg)
        slab_rows = atab.shape[0] * sum(cols.numel() for cols, _ in views.reads)
        adapter_bytes = 2 * slab_rows * slab_shape[1] * 4
        # every layer gathers each row's mp pages of K and V: the distinct
        # pages the tables name read once, the n * mp output pages written once
        pages_read = len(set(tables.reshape(-1).tolist())) + tables.numel()
        kv_bytes = sum(pages_read * v.shape[0] * v[0, 0].numel() * v.element_size()
                       for k, v in engine.cache.items() if k != "len")
        # the same gather alone, by CUDA events: a check on the profiler's split
        gather_alone_ms = cuda_ms(
            lambda: [G._layer_lora(views, i) for i in range(engine.cfg.n_layers)], 10)
        out.update(adapter_gather_ms=adapter_ms, adapter_gather_alone_ms=gather_alone_ms,
                   adapter_gather_bytes=adapter_bytes,
                   page_gather_ms=out["gather_ms"] - adapter_ms, page_gather_bytes=kv_bytes,
                   adapter_gather_bound_ms=adapter_bytes / MEM_BYTES_PER_S * 1e3)
    return out


def spec_round_probe(engine) -> dict:
    """Wrap a speculative engine's round: each round's wall time (a round
    ends in one copy to the host, which waits for its device work), and
    one round after the eighth under ``torch.profiler`` (its kernels and
    device busy time; that round's wall is not among the others)."""
    from torch.profiler import ProfilerActivity, profile

    out = {"wall_s": [], "profile": None}
    method = engine._spec_round

    def timed(*args):
        t0 = time.perf_counter()
        if out["profile"] is not None or len(out["wall_s"]) < 8:
            rows = method(*args)
            if rows:
                out["wall_s"].append(time.perf_counter() - t0)
            return rows
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            rows = method(*args)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        if rows:
            kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
            busy_ms = sum(getattr(e, "self_device_time_total", 0.0) for e in kernels) / 1e3
            out["profile"] = {"rows": len(rows), "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                              "device_busy_share": busy_ms / wall_ms,
                              "kernels": sum(e.count for e in kernels)}
        return rows

    engine._spec_round = timed
    return out


@contextlib.contextmanager
def launches_by_head_dim():
    """Yield a dict that counts, while the block runs, the ``flash_fwd``
    launches by the head dim of their q (``fa._launch_fwd`` wrapped; the
    kernel's own count, ``fa.LAUNCHES``, is untouched)."""
    by_dim: dict[int, int] = {}
    launch = fa._launch_fwd

    def tallied(entry, q, *args, **kw):
        out = launch(entry, q, *args, **kw)
        if entry == "flash_fwd" and q.numel():
            by_dim[int(q.shape[-1])] = by_dim.get(int(q.shape[-1]), 0) + 1
        return out

    fa._launch_fwd = tallied
    try:
        yield by_dim
    finally:
        fa._launch_fwd = launch


def paged_run(label, make_engine, trace, phase="phase 7", profile=True,
              head_dims=False) -> tuple[object, dict, object, dict]:
    """One measured run of the paged engine that ``make_engine`` builds:
    launch counts zeroed just before and read just after, prefill
    dispatches counted by wrapping the engine's prefill program, and the
    run's own peak memory (its pool and activations: the peak less what
    was held before the engine was built). A speculative engine's rounds
    are timed (:func:`spec_round_probe`). Checks the run's gates (a
    multi-LoRA engine's resident adapters count as used pages; a
    speculative engine has five programs and its draft prefills with the
    target); returns the engine, its report, stats and launches.
    ``profile`` profiles a made-up decode step after the run; ``head_dims``
    adds the run's ``flash_fwd`` launches by head dim to the report."""
    torch.cuda.synchronize()
    held_gb = torch.cuda.memory_allocated() / 1e9  # weights, earlier engines
    engine = make_engine()
    engine.warmup()
    prefills = []
    program = engine._prefill

    def counted(*args):
        prefills.append(1)
        return program(*args)

    engine._prefill = counted
    spec = engine.draft_cfg is not None
    rounds = spec_round_probe(engine) if spec else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0
    with launches_by_head_dim() if head_dims else contextlib.nullcontext({}) as by_dim:
        stats = engine.run(trace)
        torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    del engine._prefill  # the class's program again, and no engine -> engine cycle
    if spec:
        del engine._spec_round
    s = stats.summary()
    report = {
        "requests": s["requests"], "tokens": s["tokens"], "ticks": s["ticks"],
        "wall_s": s["wall_s"], "goodput_tokens_per_s": s["goodput_tokens_per_s"],
        "ttft_p50_ms": s["ttft_p50_ms"], "ttft_p99_ms": s["ttft_p99_ms"],
        "ttft_p50_ticks": s["ttft_p50_ticks"], "ttft_p99_ticks": s["ttft_p99_ticks"],
        "decode_step_p50_ms": engine.profiler.p50() * 1e3,
        "decode_step_p99_ms": engine.profiler.p99() * 1e3,
        "decode_steps": engine.profiler.count,
        "own_peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9 - held_gb, 3),
        "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3),
        "held_before_gb": round(held_gb, 3),
        "prefill_dispatches": len(prefills),
        "shape_guard": stats.trace_counts,
        "launches": launches,
        "cache_stats": engine.cache_stats(),
        "tiers": s.get("tiers"),
    }
    if head_dims:
        report["flash_fwd_by_head_dim"] = by_dim
    if spec:
        walls = rounds["wall_s"]
        report.update(rounds=len(walls) + (rounds["profile"] is not None),
                      round_wall_p50_ms=float(np.median(walls)) * 1e3 if walls else None,
                      round_profile=rounds["profile"],
                      tokens_per_row_per_step=engine.profiler.tokens_per_step())
    print(f"  {label}", json.dumps(report), flush=True)
    if profile:
        report["decode_step_profile"] = profile_paged_decode_step(engine)
        print(f"  {label} made-up decode step profile",
              json.dumps(report["decode_step_profile"]), flush=True)
    fail = []
    if len(stats.results) != len(trace):
        fail.append("not every request was served")
    guard = {"prefill": 1, "extend": 1, "decode": 1}
    if spec:
        guard.update(draft=1, verify=1)
    if stats.trace_counts != guard:
        fail.append(f"shape guard moved: {stats.trace_counts}")
    held = engine.radix.cached_pages
    if engine.adapters is not None:
        held += engine.adapters.cached_pages
    if engine.allocator.used_pages != held:
        fail.append(f"pages leaked: {engine.allocator.used_pages} used, {held} held by the "
                    "radix cache and resident adapters")
    layers = engine.cfg.n_layers + (engine.draft_cfg.n_layers if spec else 0)
    if not launches["flash_fwd"] == layers * len(prefills) > 0:
        fail.append(f"flash_fwd launches {launches['flash_fwd']} != "
                    f"{layers} x {len(prefills)} prefill dispatches")
    if launches["flash_fwd_scalar"]:
        fail.append(f"flash_fwd_scalar launched {launches['flash_fwd_scalar']} times")
    if fail:
        raise SystemExit(f"{phase} failed ({label}): " + "; ".join(fail))
    return engine, report, stats, launches


def paged_trace(cfg, seed=0, adapters=None) -> list:
    """Phase 7's trace: 24 requests over two 1024-token system prompts with
    64-512-token tails, half critical, half best-effort."""
    return shared_prefix_trace(
        24, seed=seed, rate=0.5, vocab=cfg.vocab, prefixes=(2, 1024), tail_lens=(64, 512),
        max_new=(16, 64), tiers=[("critical", 0.5, 16, 4), ("best_effort", 0.5, None, None)],
        adapters=adapters,
    )


def phase_paged(params, cfg, serve_decode_p50_ms) -> dict:
    """Phases 7 and 8, on the 8B weights of phase 2; returns the kernel
    launches of runs A and B together."""
    print(f"phase 7: paged serve llama3_8b ({PAGED_LAYERS} of 32 layers, bf16)", flush=True)
    cfg = dataclasses.replace(cfg, n_layers=PAGED_LAYERS)
    params = {**params, "layers": {k: v[:PAGED_LAYERS] for k, v in params["layers"].items()}}
    weight_bytes = tensor_bytes(params)
    pod = PodTpuEnv.from_env(plugin_env(PAGED_SLICE_UNITS))
    plan = paged_plan_from_pod_env(
        cfg, 2048, weight_bytes=weight_bytes, page_size=16, prefill_chunk=512, env=pod,
        slots=16,
    )
    print("  plan from the pod env", json.dumps(dataclasses.asdict(plan)), flush=True)
    if plan.total_pages != RUN_A_PAGES:
        raise SystemExit(f"phase 7 failed: the {PAGED_SLICE_UNITS}-unit slice's plan has "
                         f"{plan.total_pages} pages, not {RUN_A_PAGES}")
    trace = paged_trace(cfg)
    geo = dict(max_len=2048, prefill_chunk=512, page_size=16, eos_id=EOS_ID)
    run_a, report_a, stats_a, launches_a = paged_run(
        "run A (slice-sized)",
        lambda: PagedSlotEngine(params, cfg, slots=16, total_pages=plan.total_pages, **geo),
        trace,
    )
    if not report_a["cache_stats"]["prefix_hit_ratio"] > 0:
        raise SystemExit("phase 7 failed (run A): no prefix hit")
    run_b, report_b, stats_b, launches_b = paged_run(
        "run B (pressured)",
        lambda: PagedSlotEngine(params, cfg, slots=8, total_pages=PRESSURE_PAGES, **geo),
        trace,
    )
    if report_b["cache_stats"]["preemptions"] < 1:
        raise SystemExit("phase 7 failed (run B): no preemption")
    print(f"  decode step p50 at 8 slots: paged ({PAGED_LAYERS} layers)",
          report_b["decode_step_p50_ms"], "ms, contiguous (phase 2, 32 layers)",
          serve_decode_p50_ms, "ms", flush=True)
    del run_b

    print("phase 8: paged engine vs solo generate, drain/restore, page export/import",
          flush=True)
    by_rid = {r.rid: r for r in trace}
    preempted = [r for r in stats_b.results if r.preemptions]
    hits = [r for r in stats_a.results if r.prefix_tokens > 0][:4]
    if len(hits) < 4:
        raise SystemExit(f"phase 8 failed: only {len(hits)} run-A requests hit the prefix cache")
    solos = {}
    diverged = []
    for res in preempted + hits:
        diverged += check_vs_solo("phase 8", params, cfg, by_rid[res.rid], res.tokens,
                                  solos=solos)
    print(f"  {len(preempted)} preempted (run B) and {len(hits)} prefix-hit (run A) requests "
          "vs solo; diverged at near ties:", json.dumps(diverged), flush=True)

    served = {r.rid: r.tokens for r in stats_a.results}
    part = run_a.run(trace, drain_at_tick=stats_a.ticks // 2)
    snap = run_a.drain_snapshot()
    if not snap or not snap["requests"]:
        raise SystemExit("phase 8 failed: the drain captured nothing")
    dst = PagedSlotEngine(params, cfg, slots=16, total_pages=plan.total_pages, **geo)
    rest = dst.restore_snapshot(json.loads(json.dumps(snap)))
    combined = {r.rid: r.tokens for r in part.results}
    combined.update({r.rid: r.tokens for r in rest.results})
    if sorted(combined) != sorted(served):
        raise SystemExit("phase 8 failed: drain/restore lost or duplicated requests")
    diverged = []
    for rid, tokens in combined.items():
        diverged += check_vs_solo("phase 8", params, cfg, by_rid[rid], tokens, want=served[rid],
                                  solos=solos)
    print(f"  drained at tick {snap['drain_tick']}: {len(part.results)} retired, "
          f"{len(snap['requests'])} restored ({rest.ticks} ticks); {len(solos)} solo decodes in "
          "phase 8; diverged from run A at near ties:", json.dumps(diverged), flush=True)

    _, pages = run_a.radix.match(trace[0].prompt)
    blobs = run_a.export_kv_pages(pages)
    targets = dst.allocator.alloc(len(pages))
    dst.import_kv_pages(targets, blobs)
    back = dst.export_kv_pages(targets)
    run_a.allocator.release(pages)
    dst.allocator.release(targets)
    same = all(np.array_equal(a[k], b[k]) for a, b in zip(back, blobs) for k in b)
    print(f"  export/import of {len(pages)} pages of request 0: same bits {same}", flush=True)
    if not pages or not same:
        raise SystemExit("phase 8 failed: export/import did not round-trip")
    return {name: launches_a[name] + launches_b[name] for name in fa.LAUNCHES}


def lora_store_for(params, cfg, lcfg) -> tuple[dict, dict]:
    """Phase 13's four tenants: adapters drawn on the host from a seeded
    generator with ``b`` random, each target scaled so that
    ||scale·A·B||_F / ||W||_F is LORA_RATIO over the layer stack. Returns
    the store (on the host, where a serving pod keeps its tenants) and the
    ratios as measured after scaling."""
    gen = torch.Generator().manual_seed(13)
    store, ratios = {}, {}
    w_norm = {
        name: math.sqrt(sum(float(params["layers"][name][i].float().square().sum())
                            for i in range(cfg.n_layers)))
        for name in lcfg.targets
    }
    for aid in LORA_TENANTS:
        lora = L.init_lora(cfg, lcfg, gen, device="cpu")
        ratios[aid] = {}
        for name in lcfg.targets:
            ab = lora[name]
            ab["b"] = torch.randn(ab["b"].shape, generator=gen)
            a, b = ab["a"].cuda(), ab["b"].cuda()
            d_norm = lambda b: math.sqrt(sum(  # noqa: E731
                float(L._delta(a[i : i + 1], b[i : i + 1], lcfg.scale).square().sum())
                for i in range(cfg.n_layers)))
            ab["b"].mul_(LORA_RATIO * w_norm[name] / d_norm(b))
            ratios[aid][name] = round(d_norm(ab["b"].cuda()) / w_norm[name], 4)
        store[aid] = lora
    return store, ratios


def lora_logits_check(params, merged, cfg, lcfg, adapter, prompt, kv_dtype=None) -> dict:
    """One paged prefill of ``prompt`` (one chunk) through the
    BGMV path with ``adapter`` in a slab (over a ``kv_dtype`` pool), against
    ``merge_lora`` + ``prefill``: last-position logits, max |diff| against
    max |logit|, and the relative L2 error."""
    ps = 16
    n = len(prompt)
    ppa = -(-L.lora_flat_len(cfg, lcfg) // (ps * cfg.d_model))
    slab = torch.zeros((ppa + 1, ps * cfg.d_model), dtype=torch.float32, device="cuda")
    flat = L.flatten_lora(adapter, cfg, lcfg).cuda()
    slab.view(-1)[ps * cfg.d_model : ps * cfg.d_model + flat.numel()] = flat
    views = G.lora_bgmv_views(slab, torch.arange(1, ppa + 1, device="cuda")[None], cfg, lcfg)
    cache = G.init_paged_cache(cfg, 1, n // ps + 1, ps, kv_dtype=kv_dtype)
    table = torch.arange(1, n // ps + 1, dtype=torch.int32, device="cuda")
    toks = torch.tensor(prompt, dtype=torch.long, device="cuda")
    got, _ = G.paged_prefill_slot(params, toks, cache, cfg, slot=0, page_table=table, n_real=n,
                                  lora=views, lora_scale=lcfg.scale)
    want, _ = G.prefill(merged, toks[None], G.init_cache(cfg, 1, n), cfg)
    diff = float((got - want).abs().max())
    top = float(want.abs().max())
    rel_l2 = float(torch.linalg.vector_norm((got - want).double())
                   / torch.linalg.vector_norm(want.double()).clamp_min(1e-30))
    return {"max_abs_diff": diff, "max_abs_logit": top, "bound": LORA_LOGIT_REL * top,
            "rel_l2": rel_l2, "same_argmax": bool(torch.equal(got.argmax(-1), want.argmax(-1)))}


def phase_lora_serve(params, cfg) -> dict:
    """Phase 13, on phase 2's weights cut to their first LORA_SERVE_LAYERS
    layers; returns the launches of runs A and B together."""
    print(f"phase 13: multi-LoRA paged serve llama3_8b ({LORA_SERVE_LAYERS} of 32 layers, bf16)",
          flush=True)
    cfg = dataclasses.replace(cfg, n_layers=LORA_SERVE_LAYERS)
    params = {**params, "layers": {k: v[:LORA_SERVE_LAYERS] for k, v in params["layers"].items()}}
    lcfg = L.LoraConfig(rank=LORA_RANK, alpha=LORA_ALPHA, targets=LORA_TARGETS)
    store, ratios = lora_store_for(params, cfg, lcfg)
    ppa = -(-L.lora_flat_len(cfg, lcfg) // (16 * cfg.d_model))
    print(f"  adapters: {L.lora_flat_len(cfg, lcfg)} floats each ({ppa} pages of 16 x "
          f"{cfg.d_model}); ||scale·A·B||_F / ||W||_F by target:", json.dumps(ratios), flush=True)
    weight_bytes = tensor_bytes(params)
    pod = PodTpuEnv.from_env(plugin_env(PAGED_SLICE_UNITS))
    plan = paged_plan_from_pod_env(
        cfg, 2048, weight_bytes=weight_bytes, page_size=16, prefill_chunk=512, env=pod,
        slots=16, lora=True,
    )
    print("  plan from the pod env (lora=True)", json.dumps(dataclasses.asdict(plan)), flush=True)
    trace = paged_trace(cfg, seed=LORA_TRACE_SEED, adapters=[*LORA_TENANTS, ""])
    geo = dict(max_len=2048, prefill_chunk=512, page_size=16, eos_id=EOS_ID, lora_store=store,
               lora_cfg=lcfg)
    run_a, report_a, stats_a, launches_a = paged_run(
        "run A (slice-sized, multi-LoRA)",
        lambda: PagedSlotEngine(params, cfg, slots=16, total_pages=plan.total_pages, **geo),
        trace, phase="phase 13",
    )
    run_b, report_b, stats_b, launches_b = paged_run(
        "run B (pressured, multi-LoRA)",
        lambda: PagedSlotEngine(params, cfg, slots=8, total_pages=2 * 128 + 2 * ppa, **geo),
        trace[:LORA_PRESSURE_REQUESTS], phase="phase 13",
    )
    fail = []
    for name, rep_, want in (("A", report_a, "hits"), ("B", report_b, "evictions")):
        row = rep_["cache_stats"]["adapters"]
        if row["misses"] < len(LORA_TENANTS) or not row[want] > 0:
            fail.append(f"run {name}: adapters {row} (want misses >= {len(LORA_TENANTS)}, "
                        f"{want} > 0)")
    if fail:
        raise SystemExit("phase 13 failed: " + "; ".join(fail))
    del run_b

    served = {r.rid: r.tokens for r in stats_a.results}
    part = run_a.run(trace, drain_at_tick=stats_a.ticks // 2)
    snap = run_a.drain_snapshot()
    del run_a
    if not snap or not snap["requests"]:
        raise SystemExit("phase 13 failed: the drain captured nothing")
    dst = PagedSlotEngine(params, cfg, slots=16, total_pages=plan.total_pages, **geo)
    rest = dst.restore_snapshot(json.loads(json.dumps(snap)))
    del dst
    combined = {r.rid: r.tokens for r in part.results}
    combined.update({r.rid: r.tokens for r in rest.results})
    if sorted(combined) != sorted(served):
        raise SystemExit("phase 13 failed: drain/restore lost or duplicated requests")
    print(f"  drained at tick {snap['drain_tick']}: {len(part.results)} retired, "
          f"{len(snap['requests'])} restored ({rest.ticks} ticks), adapter rows "
          f"{sorted({r['adapter_id'] for r in snap['requests']})}", flush=True)
    torch.cuda.empty_cache()

    # Merged-solo, one tenant's merged weights on the card at a time: run A
    # against solo decode; run B and the restored run against run A.
    by_rid = {r.rid: r for r in trace}
    diverged, differs, logits = [], {}, None
    for aid in ("", *LORA_TENANTS):
        t0 = time.perf_counter()
        adapter = {n: {k: v.cuda() for k, v in ab.items()} for n, ab in store[aid].items()} \
            if aid else None
        merged = L.merge_lora(params, adapter, lcfg) if aid else params
        solos = {}
        for res in stats_a.results:
            req = by_rid[res.rid]
            if req.adapter_id == aid:
                diverged += check_vs_solo("phase 13", merged, cfg, req, res.tokens, solos=solos,
                                          gap_rel=LORA_TOP2_GAP_REL)
        for run, got in (("B", {r.rid: r.tokens for r in stats_b.results}), ("restore", combined)):
            for rid, tokens in got.items():
                if by_rid[rid].adapter_id == aid:
                    diverged += [dict(d, run=run) for d in check_vs_solo(
                        "phase 13", merged, cfg, by_rid[rid], tokens, want=served[rid],
                        solos=solos, gap_rel=LORA_TOP2_GAP_REL)]
        if aid == LORA_TENANTS[0]:
            first = next(r for r in trace if r.adapter_id == aid)
            logits = lora_logits_check(params, merged, cfg, lcfg, adapter,
                                       list(first.prompt[:512]))
        del merged, adapter
        torch.cuda.empty_cache()
        print(f"  merged-solo {aid or 'base'}: {len(solos)} solo decodes, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    base_solos = {}
    for aid in LORA_TENANTS:
        own = [r for r in stats_a.results if by_rid[r.rid].adapter_id == aid]
        checked = 0
        for res in own:
            req = by_rid[res.rid]
            key = (req.prompt, req.max_new)
            if key not in base_solos:
                base_solos[key] = solo_with_gaps(params, cfg, list(req.prompt), req.max_new)[0]
            base = base_solos[key]
            base = base[: base.index(EOS_ID) + 1] if EOS_ID in base else base
            checked += 1
            if res.tokens != base:
                break
        else:
            raise SystemExit(f"phase 13 failed: tenant {aid}'s {len(own)} requests all equal the "
                             "base model's tokens: the adapter does not show")
        differs[aid] = f"differs from base-model solo on request {res.rid} ({checked} checked, " \
                       f"{len(own)} requests)"
    print("  run A, run B and the restored run vs merged-solo; diverged at near ties:",
          json.dumps(diverged), flush=True)
    print("  tenants vs the base model:", json.dumps(differs), flush=True)
    print("  t0's paged prefill logits, BGMV vs merge_lora + prefill:", json.dumps(logits),
          flush=True)
    if not logits["max_abs_diff"] <= logits["bound"]:
        raise SystemExit(f"phase 13 failed: BGMV vs merged logits differ by {logits}")
    prof = report_a["decode_step_profile"]
    print(f"  decode step: adapter gather {prof['adapter_gather_ms']:.4f} ms "
          f"({prof['adapter_gather_alone_ms']:.4f} ms alone, by CUDA events) for "
          f"{prof['adapter_gather_bytes'] / 1e9:.3f} GB (bound "
          f"{prof['adapter_gather_bound_ms']:.4f} ms); page gather {prof['page_gather_ms']:.4f} "
          f"ms for {prof['page_gather_bytes'] / 1e9:.3f} GB", flush=True)
    return {name: launches_a[name] + launches_b[name] for name in fa.LAUNCHES}


def llama32_1b_shape() -> T.TransformerConfig:
    """Llama-3.2-1B's published shape (see the constants of phase 15)."""
    return T.TransformerConfig(
        vocab=128256, d_model=2048, n_layers=16, n_heads=32, n_kv_heads=8, d_ff=8192,
        max_seq=131072, rope_theta=500000.0,
    )


def phase_spec_serve(params, cfg) -> dict:
    """Phase 15, on phase 2's weights cut to their first SPEC_LAYERS
    layers, the draft cut to its first DRAFT_LAYERS. Returns the launches of runs A and B together."""
    print(f"phase 15: speculative paged serve llama3_8b ({SPEC_LAYERS} of 32 layers), a "
          f"Llama-3.2-1B-shaped draft ({DRAFT_LAYERS} of 16 layers)", flush=True)
    cfg = dataclasses.replace(cfg, n_layers=SPEC_LAYERS)
    params = {**params, "layers": {k: v[:SPEC_LAYERS] for k, v in params["layers"].items()}}
    dcfg = dataclasses.replace(llama32_1b_shape(), n_layers=DRAFT_LAYERS)
    dparams = init_params(dcfg, torch.Generator(device="cuda").manual_seed(15), device="cuda",
                          dtype=torch.bfloat16)
    draft_bytes = tensor_bytes(dparams)
    pod = PodTpuEnv.from_env(plugin_env(PAGED_SLICE_UNITS))
    plan_kw = dict(weight_bytes=tensor_bytes(params), page_size=16, prefill_chunk=512, env=pod)
    plan_a = paged_plan_from_pod_env(cfg, 2048, slots=16, draft_cfg=dcfg,
                                     draft_weight_bytes=draft_bytes, **plan_kw)
    plan_b = paged_plan_from_pod_env(cfg, 2048, slots=SPEC_B_REQUESTS, draft_cfg=cfg,
                                     draft_weight_bytes=0, **plan_kw)
    print(f"  draft {draft_bytes / 1e9:.3f} GB; plan A (1B-shaped draft)",
          json.dumps(dataclasses.asdict(plan_a)), "; plan B (self-draft)",
          json.dumps(dataclasses.asdict(plan_b)), flush=True)
    trace = paged_trace(cfg)
    by_rid = {r.rid: r for r in trace}
    geo = dict(max_len=2048, prefill_chunk=512, page_size=16, eos_id=EOS_ID)
    plan_plain = paged_plan_from_pod_env(cfg, 2048, slots=16, **plan_kw)
    plain_engine, plain_report, plain_stats, _ = paged_run(
        "plain run (no draft)",
        lambda: PagedSlotEngine(params, cfg, slots=16, total_pages=plan_plain.total_pages, **geo),
        trace, phase="phase 15", profile=False)
    del plain_engine
    served = {r.rid: r.tokens for r in plain_stats.results}
    solos, diverged, fail = {}, [], []

    def spec_engine(draft_params, draft_cfg, slots, pages):
        return lambda: PagedSlotEngine(params, cfg, slots=slots, total_pages=pages,
                                       draft_params=draft_params, draft_cfg=draft_cfg,
                                       spec_k=SPEC_K, **geo)

    def hold(run, got):
        """Each request's tokens (``got``, by rid) against the plain run's,
        or solo greedy decode's by phase 3's rule."""
        for rid, tokens in got.items():
            diverged.extend(dict(d, run=run) for d in check_vs_solo(
                "phase 15", params, cfg, by_rid[rid], tokens, want=served[rid], solos=solos))

    run_a, rep_a, stats_a, launches_a = paged_run(
        "run A (1B-shaped draft, slice-sized)",
        spec_engine(dparams, dcfg, 16, plan_a.total_pages), trace, phase="phase 15",
        profile=False)
    hold("A", {r.rid: r.tokens for r in stats_a.results})
    spec_a = rep_a["cache_stats"]["speculative"]
    if not spec_a["rollback_pages"] > 0:
        fail.append(f"run A rolled back no page: {spec_a}")

    first = trace[:SPEC_B_REQUESTS]
    plain_b_engine = lambda: PagedSlotEngine(params, cfg, slots=SPEC_B_REQUESTS,  # noqa: E731
                                             total_pages=plan_b.total_pages, **geo)
    _, rep_plain_b, stats_plain_b, _ = paged_run(
        "run B's plain engine", plain_b_engine, first, phase="phase 15", profile=False)
    run_b, rep_b, stats_b, launches_b = paged_run(
        "run B (self-draft)", spec_engine(params, cfg, SPEC_B_REQUESTS, plan_b.total_pages),
        first, phase="phase 15", profile=False)
    del run_b
    hold("B", {r.rid: r.tokens for r in stats_b.results})
    spec_b = rep_b["cache_stats"]["speculative"]
    acceptance_b = spec_b["accepted"] / max(spec_b["proposed"], 1)
    if not acceptance_b >= SPEC_ACCEPT_MIN:
        fail.append(f"run B's self-draft accepted {acceptance_b:.4f} < {SPEC_ACCEPT_MIN}")
    if not stats_b.ticks < stats_plain_b.ticks:
        fail.append(f"run B took {stats_b.ticks} ticks, the plain engine {stats_plain_b.ticks}")

    # Drain: run A's spec engine at mid-run into a plain engine, then a plain
    # engine's drained rows into the spec engine.
    moves = {}
    plain = PagedSlotEngine(params, cfg, slots=16, total_pages=plan_a.total_pages, **geo)
    for name, src, dst, tick in (("spec -> plain", run_a, plain, stats_a.ticks // 2),
                                 ("plain -> spec", plain, run_a, plain_stats.ticks // 2)):
        part = src.run(trace, drain_at_tick=tick)
        snap = src.drain_snapshot()
        if not snap or not snap["requests"]:
            raise SystemExit(f"phase 15 failed: the {name} drain captured nothing")
        rest = dst.restore_snapshot(json.loads(json.dumps(snap)))
        combined = {r.rid: r.tokens for r in part.results}
        combined.update({r.rid: r.tokens for r in rest.results})
        if sorted(combined) != sorted(served) or len(part.results) + len(rest.results) != len(trace):
            fail.append(f"{name}: drain/restore lost or duplicated requests")
        hold(name, combined)
        moves[name] = {"drain_tick": snap["drain_tick"], "retired": len(part.results),
                       "restored": len(snap["requests"]), "restore_ticks": rest.ticks}
    for name, eng in (("spec", run_a), ("plain", plain)):
        if eng.allocator.used_pages != eng.radix.cached_pages:
            fail.append(f"{name} engine leaked pages after the drains")
    del run_a, plain

    # Contiguous: speculative_generate at B=1 against generate's greedy tokens.
    prompt = list(trace[0].prompt[:512])
    req = Request(rid=-15, prompt=tuple(prompt), max_new=SPEC_MAX_NEW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    G.generate(params, [prompt], cfg, max_new=SPEC_MAX_NEW)
    torch.cuda.synchronize()
    contiguous = {"generate_wall_s": time.perf_counter() - t0}
    for name, dp, dc in (("1B-shaped", dparams, dcfg), ("self", params, cfg)):
        for n in fa.LAUNCHES:
            fa.LAUNCHES[n] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, st = G.speculative_generate(params, dp, [prompt], cfg, dc, max_new=SPEC_MAX_NEW,
                                         k=SPEC_K, return_stats=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = dict(fa.LAUNCHES)
        got = out[0, len(prompt):].tolist()
        found = check_vs_solo("phase 15", params, cfg, req, got, solos=solos)
        diverged.extend(dict(d, run=f"contiguous {name}") for d in found)
        if launched["flash_fwd"] != cfg.n_layers + dc.n_layers or launched["flash_fwd_scalar"]:
            fail.append(f"contiguous {name}: launches {launched}")
        contiguous[name] = {**st, "wall_s": wall, "acceptance": st["accepted"] / st["drafted"],
                            "flash_fwd": launched["flash_fwd"],
                            "perfect_draft_rounds": -(-(SPEC_MAX_NEW - 1) // (SPEC_K + 1))}
    del dparams
    torch.cuda.empty_cache()

    per_prefill = {"A": launches_a["flash_fwd"] / rep_a["prefill_dispatches"],
                   "B": launches_b["flash_fwd"] / rep_b["prefill_dispatches"]}
    summary = {
        "plan_pages": {"A": plan_a.total_pages, "B": plan_b.total_pages},
        "acceptance": {"A": spec_a["accepted"] / max(spec_a["proposed"], 1), "B": acceptance_b},
        "speculative": {"A": spec_a, "B": spec_b},
        "ticks": {"A": stats_a.ticks, "B": stats_b.ticks, "B plain": stats_plain_b.ticks,
                  "plain": plain_stats.ticks},
        "round_wall_p50_ms": {"A": rep_a["round_wall_p50_ms"], "B": rep_b["round_wall_p50_ms"]},
        "round_profile": {"A": rep_a["round_profile"], "B": rep_b["round_profile"]},
        "decode_step_p50_ms": {"A": rep_a["decode_step_p50_ms"],
                               "B plain": rep_plain_b["decode_step_p50_ms"],
                               "plain": plain_report["decode_step_p50_ms"]},
        "goodput_tokens_per_s": {"A": rep_a["goodput_tokens_per_s"],
                                 "B": rep_b["goodput_tokens_per_s"],
                                 "B plain": rep_plain_b["goodput_tokens_per_s"],
                                 "plain": plain_report["goodput_tokens_per_s"]},
        "flash_fwd_per_prefill": per_prefill,
        "drain": moves,
        "contiguous": contiguous,
        "solo_decodes": len(solos),
        "diverged_at_near_ties": diverged,
    }
    print("  phase 15 summary", json.dumps(summary), flush=True)
    if per_prefill != {"A": cfg.n_layers + dcfg.n_layers, "B": 2 * cfg.n_layers}:
        fail.append(f"flash_fwd launches per prefill dispatch {per_prefill}")
    if fail:
        raise SystemExit("phase 15 failed: " + "; ".join(fail))
    return {name: launches_a[name] + launches_b[name] for name in fa.LAUNCHES}


def bwd_close(got, want, dtype) -> bool:
    got, want = got.float(), want.float()
    top = float(want.abs().max())
    if dtype == torch.float32:
        tol = BWD_F32_REL * max(top, 1.0)
    else:
        tol = BWD_BF16_REL * want.abs() + BWD_BF16_TOP * top
    return bool(((got - want).abs() <= tol).all()) and bool(torch.isfinite(got).all())


DQ_ENTRIES = ("flash_bwd_dq", "flash_bwd_dq_scalar")


def bwd_bound(entry, q, k, v, *, causal, start, kv_len):
    """Least time for one backward kernel call: 6*D (dQ) or 8*D (dK/dV)
    flops per visible (query, key) pair per head, against q, k, v, dO,
    lse and delta read once and the kernel's outputs written once.
    Returns (ms, what bounds it, flops)."""
    B, S, H, D = q.shape
    vis = fa._visible(B, S, causal=causal, start=start, kv_len=kv_len, device=q.device)
    per_pair = 6.0 if entry in DQ_ENTRIES else 8.0
    flops = per_pair * D * H * float(vis.sum())
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q)) + 2 * B * S * H * 4.0
    nbytes += sum(b.numel() * 4 for b in (start, kv_len) if b is not None)
    nbytes += (q.numel() * q.element_size() if entry in DQ_ENTRIES
               else 2 * k.numel() * k.element_size())
    t_ops = flops / PEAK_OPS_PER_S[q.dtype]
    t_mem = nbytes / MEM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes"), flops


def sdpa_backward_ms(q, k, v, do, mask, is_causal) -> float:
    """Time of the backward of ``F.scaled_dot_product_attention`` on the
    same inputs (k/v [B, Hkv, S, D] views, GQA passed as enable_gqa=True),
    which computes dq, dk and dv in one call: a yardstick only."""
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=is_causal, enable_gqa=True
    )
    dot = do.transpose(1, 2)
    return cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True), 5)


def phase_backward() -> dict:
    """Phase 4; returns the rows at the training and the BERT shape, by
    (kernel entry, "train" or "bert")."""
    print("phase 4: flash backward kernels vs plain", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(4)
    failures = 0
    rows = {}
    shapes = {(torch.bfloat16, TRAIN_B, TRAIN_S, 128, "train"): "train",
              (torch.bfloat16, BERT_B, BERT_S, BERT_D, "noncausal"): "bert"}
    cases = list(shapes)
    for dtype in (torch.bfloat16, torch.float32):
        cases += [(dtype, 1, 512, 128, "train"), (dtype, 1, 2048, 128, "train"),
                  (dtype, 2, 512, 128, "start"), (dtype, 2, 512, 128, "kv_len")]
    cases += [(torch.bfloat16, 1, 2048, 64, "train"),
              (torch.float32, BERT_B, BERT_S, BERT_D, "noncausal"),
              (torch.bfloat16, BERT_B, 300, BERT_D, "noncausal")]
    for case in cases:
        dtype, B, S, D, mode = case
        q, k, v, bounds = case_inputs(gen, dtype, B, S, D, mode)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
        o, lse = fa.flash_fwd(q, k, v, **bounds)
        delta = (do.float() * o.float()).sum(-1)
        plain = lambda: fa.flash_bwd_plain(q, k, v, do, lse, delta, scale=D ** -0.5, **bounds)  # noqa: E731
        want = dict(zip(("dq", "dk", "dv"), plain()))
        plain_ms = cuda_ms(plain, 3, warmup=1)
        sdpa = sdpa_mask(B, S, bounds)
        lib_ms = None if sdpa is None else sdpa_backward_ms(q, k, v, do, *sdpa)
        entries = list(fa.bwd_entries(dtype, D))
        if case in shapes:  # the scalar entries too, on the same inputs
            entries += fa.bwd_entries(torch.float32, D)
        for entry in entries:
            run = lambda: fa._launch_bwd(entry, q, k, v, do, lse, delta, scale=D ** -0.5, **bounds)  # noqa: E731
            names = ("dq",) if entry in DQ_ENTRIES else ("dk", "dv")
            got, again = run(), run()
            torch.cuda.synchronize()
            got = dict(zip(names, got if isinstance(got, tuple) else (got,)))
            again = dict(zip(names, again if isinstance(again, tuple) else (again,)))
            ok = all(bwd_close(got[n], want[n], dtype) for n in names)
            same_bits = all(torch.equal(got[n], again[n]) for n in names)
            if mode == "start":  # dead rows' dq, unseen keys' dk and dv: exactly 0
                ok &= not any(got[n][1, :200].any() for n in names)
            if mode == "kv_len":
                ok &= not any(got[n][1, 300:].any() for n in names if n != "dq")
            err = max(float((got[n].float() - want[n].float()).abs().max()) for n in names)
            ms = cuda_ms(run, 10)
            dev_ms = device_ms(run) if case in shapes else None
            bound_ms, bound_by, flops = bwd_bound(entry, q, k, v, **bounds)
            row = dict(
                kernel=entry, dtype=str(dtype).split(".")[-1], B=B, S=S, H=q.shape[2],
                Hkv=k.shape[2], D=D, mode=mode, max_abs_err=err, ok=ok, same_bits=same_bits,
                ms=ms, device_ms=dev_ms, tflops=flops / ms / 1e9, bound_fraction=bound_ms / ms,
                device_bound_fraction=bound_ms / dev_ms if dev_ms else None,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
            )
            print("  ", json.dumps(row), flush=True)
            if case in shapes:
                rows[(entry, shapes[case])] = row
            failures += not (ok and same_bits)

    # The (O, lse) pair with a nonzero lse cotangent, through the autograd
    # Function: the kernels against the plain version given the same
    # delta, and against autograd through the plain forward.
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (t.requires_grad_() for t in attention_inputs(gen, 1, 512, 32, 8, 128, dtype))
        do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
        dlse = torch.randn(q.shape[:3], generator=gen, device="cuda")
        o, lse = fa.flash_attention_lse(q, k, v)
        got = torch.autograd.grad((o, lse), (q, k, v), (do, dlse))
        delta = (do.float() * o.detach().float()).sum(-1) - dlse
        want = fa.flash_bwd_plain(q.detach(), k.detach(), v.detach(), do, lse.detach(), delta,
                                  causal=True, scale=128 ** -0.5)
        ok = all(bwd_close(g, w, dtype) for g, w in zip(got, want))
        if dtype == torch.float32:
            po, plse = fa.flash_fwd_plain(q, k, v, causal=True, scale=128 ** -0.5)
            auto = torch.autograd.grad((po, plse), (q, k, v), (do, dlse))
            ok &= all(bwd_close(g, w, dtype) for g, w in zip(got, auto))
        errs = {n: float((g.float() - w.float()).abs().max()) for n, g, w in zip(("dq", "dk", "dv"), got, want)}
        print("   lse pair", str(dtype).split(".")[-1], json.dumps({"ok": ok, **errs}), flush=True)
        failures += not ok
    if failures:
        raise SystemExit(f"phase 4 failed: {failures} case(s) out of tolerance")
    return rows


def profile_train_step(step_fn, state, batch) -> dict:
    """Device busy share of one more training step: summed kernel time
    from ``torch.profiler`` over the step's host wall time, the kernels
    that take most of it, and each flash kernel's time and launches."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, loss = step_fn(state, batch)
        float(loss)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0)  # noqa: E731
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:8]
    flash = [e for e in events
             if any(n in e.key for n in ("flash", "fwd_kernel", "dq_kernel", "dkv_kernel"))]
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "kernels": sum(e.count for e in events),
        "top_kernels_ms": {e.key[:60]: dev_us(e) / 1e3 for e in top},
        "flash_kernels_ms_launches": {e.key[:60]: [dev_us(e) / 1e3, e.count] for e in flash},
    }


def phase_train() -> dict:
    """Phase 5; returns the kernel launches of the training run."""
    print(f"phase 5: train llama3_8b width, {TRAIN_LAYERS} layers, B={TRAIN_B} S={TRAIN_S}",
          flush=True)
    cfg = dataclasses.replace(llama3_8b(), n_layers=TRAIN_LAYERS)
    task = DecoderTask(cfg, batch=TRAIN_B, seq=TRAIN_S)
    losses, step_s = [], []
    clock = [time.perf_counter()]

    def on_metrics(step, loss):
        now = time.perf_counter()
        step_s.append(now - clock[0])
        clock[0] = now
        losses.append(loss)

    fresh_run()
    state, _ = run_train_loop(
        task, TrainLoopConfig(total_steps=TRAIN_STEPS, log_every=1), 0, on_metrics=on_metrics
    )
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    p50 = sorted(step_s[1:])[len(step_s[1:]) // 2]
    train = {
        "params": sum(t.numel() for t in tree_leaves(state[0])),
        "losses": losses,
        "step_s": step_s,
        "step_p50_s_steps_1_7": p50,
        "tokens_per_s": TRAIN_B * TRAIN_S / p50,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
    }
    print("  train", json.dumps(train), flush=True)
    batch = task.make_batch(torch.Generator().manual_seed(99), TRAIN_STEPS).cuda()
    print("  train step profile",
          json.dumps(profile_train_step(task.make_step(), state, batch)), flush=True)
    per_run = TRAIN_LAYERS * TRAIN_STEPS
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise SystemExit(f"phase 5 failed: losses {losses}")
    want = {name: 0 for name in fa.LAUNCHES}  # the scalar entries, flash_fwd_scalar too: never
    want.update(flash_fwd=2 * per_run, flash_bwd_dq=per_run, flash_bwd_dkv=per_run)
    if launches != want:
        raise SystemExit(f"phase 5 failed: launches {launches} != {want}")
    return launches


def phase_grad_parity() -> None:
    print("phase 6: loss_fn gradients, flash vs plain", flush=True)
    cfg = dataclasses.replace(llama3_8b(), n_layers=TRAIN_LAYERS)
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(6), device="cuda")
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    names = list(T._flatten(params))
    tokens = T.demo_batch(torch.Generator().manual_seed(6), 1, TRAIN_S, cfg.vocab).cuda()
    loss, grads = {}, {}
    for attention in ("flash", "plain"):
        out = T.loss_fn(params, tokens, dataclasses.replace(cfg, attention=attention))
        grads[attention] = torch.autograd.grad(out, leaves)
        loss[attention] = float(out.detach())
    rel = {
        n: float((f - p).float().norm() / p.float().norm())
        for n, f, p in zip(names, grads["flash"], grads["plain"])
    }
    zero = [n for n, g in zip(names, grads["flash"]) if not (torch.isfinite(g).all() and g.any())]
    print("  losses", json.dumps(loss), "relative Frobenius error by leaf", json.dumps(rel),
          "zero or non-finite flash gradients", zero, flush=True)
    if zero:
        raise SystemExit(f"phase 6 failed: no gradient reached {zero}")
    if abs(loss["flash"] - loss["plain"]) > GRAD_LOSS_REL * abs(loss["plain"]):
        raise SystemExit(f"phase 6 failed: losses {loss}")
    bad = {n: r for n, r in rel.items() if not r <= GRAD_LEAF_REL}
    if bad:
        raise SystemExit(f"phase 6 failed: gradients differ: {bad}")


def card_gib() -> int:
    """The card's whole GiB: what the plugin advertises as its units."""
    return torch.cuda.get_device_properties(0).total_memory >> 30


@functools.cache
def node_inventory() -> DeviceInventory:
    """The card as the port's plugin advertises it: NVML discovery's chips
    fanned out into GiB devices (phase 21 builds it first)."""
    return DeviceInventory(from_name("nvml").chips())


def plugin_env(units: int) -> dict[str, str]:
    """The env the port's plugin grants a pod of one ``units``-GiB
    container: a fresh ``LocalAllocator`` over phase 21's inventory places
    the single slice and writes its env, as Allocate() would."""
    (grant,) = LocalAllocator(node_inventory()).allocate([units])
    return grant.envs


def gang_env(units: int, n: int) -> dict[str, str]:
    """What the plugin's Allocate() injects for an ``n``-chip gang of
    ``units`` GiB a chip. Here every member is card 0 (one card), so each
    rank sees that card and is capped at its per-chip share of it."""
    return {
        const.ENV_TPU_VISIBLE_CHIPS: "0",
        const.ENV_GANG_CHIPS: ",".join(str(i) for i in range(n)),
        const.ENV_GANG_SHAPE: f"{n}x1x1",
        const.ENV_GANG_PER_CHIP: str(units),
        const.ENV_MEM_CONTAINER: str(units * n),
        const.ENV_MEM_DEV: str(card_gib()),
    }


def train_pod(workload: str, batch: int, steps: int) -> tuple[dict, object, object]:
    """Train one pod's workload on the card: MNIST through ``mnist.train``,
    BERT-base and ResNet-50 through ``run_train_loop``. Returns (report,
    task, state); the report has the losses, each step's wall time (the
    loss is read every step, which waits for it), the step p50 over steps
    1.., and the peak memory."""
    losses, step_s = [], []
    clock = [time.perf_counter()]

    def on_metrics(step, loss):
        now = time.perf_counter()
        step_s.append(now - clock[0])
        clock[0] = now
        losses.append(loss)

    task = state = None
    if workload == "mnist":
        mnist.train(steps=steps, batch=batch, on_metrics=on_metrics)
    else:
        if workload == "bert":
            task = BertTask(B.bert_base(), batch=batch, seq=BERT_S)
        else:
            task = ResNetTask(R.resnet50(), batch=batch, image_size=RESNET_SIZE)
        state, _ = run_train_loop(task, TrainLoopConfig(total_steps=steps, log_every=1), 0,
                                  on_metrics=on_metrics)
    torch.cuda.synchronize()
    rest = sorted(step_s[1:] or step_s)
    p50 = rest[len(rest) // 2]
    report = {
        "workload": workload, "batch": batch, "steps": steps, "losses": losses,
        "step_s": step_s, "step_p50_s": p50,
        "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
        "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
    }
    if workload == "bert":
        report["tokens_per_s"] = batch * BERT_S / p50
    if workload == "resnet":
        report["images_per_s"] = batch / p50
    return report, task, state


def after_first_p50(step_s) -> float:
    """The p50 of the step times after the first (which carries the
    warmup), or the first when it is the only one."""
    rest = sorted(step_s[1:] or step_s)
    return rest[len(rest) // 2]


def falling(losses) -> bool:
    return all(math.isfinite(x) for x in losses) and len(losses) > 1 and losses[-1] < losses[0]


def fresh_run() -> None:
    """Free what earlier phases cached and zero the peak and the launch
    counts, just before a phase's measured run."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0


def phase_bert() -> tuple[dict, dict]:
    """Phase 9; returns the run's report and its kernel launches."""
    print(f"phase 9: train bert_base alone, B={BERT_B} S={BERT_S}, {BERT_STEPS} steps", flush=True)
    fresh_run()
    report, task, state = train_pod("bert", BERT_B, BERT_STEPS)
    launches = dict(fa.LAUNCHES)
    report["launches"] = launches
    print("  bert", json.dumps({k: v for k, v in report.items() if k != "peak_reserved_bytes"}),
          flush=True)
    cfg = task.cfg
    batch = tuple(t.cuda() for t in task.make_batch(torch.Generator().manual_seed(99), 0))
    print("  bert step profile",
          json.dumps(profile_train_step(task.make_step(), state, batch)), flush=True)
    want = {name: 0 for name in fa.LAUNCHES}
    per_run = cfg.n_layers * BERT_STEPS
    want.update(flash_fwd=2 * per_run, flash_bwd_dq=per_run, flash_bwd_dkv=per_run)
    if launches != want:
        raise SystemExit(f"phase 9 failed: launches {launches} != {want}")
    if not falling(report["losses"]):
        raise SystemExit(f"phase 9 failed: losses {report['losses']}")
    del state
    torch.cuda.empty_cache()

    # flash against plain, one full-depth loss_fn backward (phase 6's rule)
    params = B.init_params(cfg, torch.Generator(device="cuda").manual_seed(9))
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    names = list(T._flatten(params))
    batch = tuple(t.cuda() for t in B.demo_batch(torch.Generator().manual_seed(9), 8, BERT_S, cfg))
    loss, grads = {}, {}
    for attention in ("flash", "plain"):
        out = B.loss_fn(params, *batch, dataclasses.replace(cfg, attention=attention))
        grads[attention] = torch.autograd.grad(out, leaves, materialize_grads=True)
        loss[attention] = float(out.detach())
    rel = {n: float((f - p).float().norm() / p.float().norm())
           for n, f, p in zip(names, grads["flash"], grads["plain"]) if n != "seg_embed"}
    zero = [n for n, g in zip(names, grads["flash"])
            if n != "seg_embed" and not (torch.isfinite(g).all() and g.any())]
    print("  flash vs plain: losses", json.dumps(loss), "relative Frobenius error by leaf",
          json.dumps(rel), "zero or non-finite flash gradients", zero, flush=True)
    if zero:
        raise SystemExit(f"phase 9 failed: no gradient reached {zero}")
    if abs(loss["flash"] - loss["plain"]) > GRAD_LOSS_REL * abs(loss["plain"]):
        raise SystemExit(f"phase 9 failed: flash vs plain losses {loss}")
    bad = {n: r for n, r in rel.items() if not r <= GRAD_LEAF_REL}
    if bad:
        raise SystemExit(f"phase 9 failed: flash vs plain gradients differ: {bad}")
    return report, launches


def phase_resnet() -> dict:
    """Phase 10; returns the run's report."""
    print(f"phase 10: train resnet50 alone, B={RESNET_B} at {RESNET_SIZE}x{RESNET_SIZE}, "
          f"{RESNET_STEPS} steps", flush=True)
    fresh_run()
    report, task, state = train_pod("resnet", RESNET_B, RESNET_STEPS)
    print("  resnet", json.dumps({k: v for k, v in report.items()
                                  if k != "peak_reserved_bytes"}), flush=True)
    bn = T._flatten(state[1])  # running mean starts at 0, var at 1
    moved = [n for n, t in bn.items()
             if not torch.equal(t, torch.full_like(t, float(n.endswith("__var"))))]
    finite = all(bool(torch.isfinite(t).all()) for t in bn.values())
    print(f"  BN running statistics: {len(moved)} of {len(bn)} changed, all finite {finite}",
          flush=True)
    batch = tuple(t.cuda() for t in task.make_batch(torch.Generator().manual_seed(99), 0))
    print("  resnet step profile",
          json.dumps(profile_train_step(task.make_step(), state, batch)), flush=True)
    if not falling(report["losses"]):
        raise SystemExit(f"phase 10 failed: losses {report['losses']}")
    if len(moved) != len(bn) or not finite:
        raise SystemExit("phase 10 failed: BN running statistics did not all change, or "
                         "are not finite")
    del state
    torch.cuda.empty_cache()
    return report


def checksums(params, chunk: int = 1 << 26) -> list[int]:
    """An exact checksum of every leaf: the sum of its raw bits as integers,
    taken ``chunk`` entries at a time (a leaf of the 8B model as int64 would
    take 28 GiB)."""
    ints = {2: torch.int16, 4: torch.int32}
    out = []
    for t in tree_leaves(params):
        flat = t.reshape(-1).view(ints[t.element_size()])
        out.append(sum(int(flat[i : i + chunk].long().sum()) for i in range(0, flat.numel(), chunk)))
    return out


def train_lora_pod(batch: int, steps: int) -> dict:
    """Phase 14's pod: LoRA fine-tuning of ``llama3_8b()`` at full depth,
    seeded bf16 base weights made on the card, the reference's default
    ``LoraConfig()``, ``make_lora_train_step(lr=1e-3)`` on one fixed
    ``demo_batch`` of ``batch`` x LORA_TRAIN_S, remat "full". Builds the
    model, says READY and waits for the go, then trains ``steps`` steps
    with the launch counts zeroed just before; returns the report."""
    cfg = llama3_8b()
    lcfg = L.LoraConfig()
    gen = torch.Generator(device="cuda").manual_seed(14)
    params = init_params(cfg, gen, device="cuda", dtype=torch.bfloat16)
    lora = L.init_lora(cfg, lcfg, gen, device="cuda")
    tokens = T.demo_batch(torch.Generator().manual_seed(14), batch, LORA_TRAIN_S, cfg.vocab).cuda()
    step, init_opt = L.make_lora_train_step(cfg, lcfg, lr=1e-3)
    opt_state = init_opt(lora)
    before = checksums(params)
    print(READY, flush=True)
    sys.stdin.readline()
    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        lora, opt_state, loss = step(params, lora, opt_state, tokens)
        losses.append(float(loss))  # waits for the step
        step_s.append(time.perf_counter() - t0)
    launches = dict(fa.LAUNCHES)
    rest = sorted(step_s[1:])
    p50 = rest[len(rest) // 2]
    return {
        "workload": "lora", "batch": batch, "steps": steps, "losses": losses, "step_s": step_s,
        "step_p50_s": p50, "tokens_per_s": batch * LORA_TRAIN_S / p50,
        "weights_gb": tensor_bytes(params) / 1e9,
        "adapter_params": L.lora_param_count(lora),
        "base_unchanged": checksums(params) == before,
        "b_abs_sum": {n: float(ab["b"].detach().abs().sum()) for n, ab in lora.items()},
        "launches": launches,
        "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
        "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
    }


def tpot_p99_ms(stats) -> float:
    """Per-request wall time per output token after the first, p99 (ms)."""
    vals = [(r.finish_s - r.first_token_s) / (len(r.tokens) - 1)
            for r in stats.results if len(r.tokens) > 1]
    return ceil_rank_quantile(vals, 0.99) * 1e3


def busy_share(run_fn) -> tuple[object, dict | None]:
    """Device busy share of the whole card while ``run_fn`` (a short
    critical trial) runs beside whatever else runs: summed kernel time from
    ``torch.profiler`` (CUDA activity, every thread's kernels) over the
    trial's wall time. The engines dispatch on one stream, so summed kernel
    time is busy time. Returns ``run_fn``'s result and the share, None
    where the profiler recorded no kernel ("not measured")."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run_fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    kernel_s = sum(getattr(e, "self_device_time_total", 0.0) for e in events) / 1e6
    if kernel_s <= 0:
        return out, None
    return out, {"window_s": wall, "kernel_s": kernel_s, "busy_share": kernel_s / wall,
                 "kernels": sum(e.count for e in events)}


def scrape(url: str) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.read().decode()


def parse_exposition(text: str) -> dict[str, list[tuple[dict, float]]]:
    """Samples of a text-format exposition by sample name: (labels, value)."""
    out: dict[str, list[tuple[dict, float]]] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        head, value = line.rsplit(" ", 1)
        name, _, raw = head.partition("{")
        labels = dict(part.split("=", 1) for part in raw.rstrip("}").split(",") if part)
        out.setdefault(name, []).append(
            ({k: v.strip('"') for k, v in labels.items()}, float(value)))
    return out


def interference_pod(key: str, *, best_effort: bool = False) -> dict:
    """A share pod ``ns/name`` running on card 0 of INTERFERENCE_NODE, as
    the interference detector reads it from the apiserver."""
    ns, name = key.split("/")
    ann = {**assumed_on_card0(INTERFERENCE_POD_UNITS, card_gib()),
           const.ENV_ASSIGNED_FLAG: "true"}
    if best_effort:
        ann[const.ANN_WORKLOAD_CLASS] = const.WORKLOAD_BEST_EFFORT
    pod = cluster_pod(name, INTERFERENCE_NODE, INTERFERENCE_POD_UNITS, phase="Running",
                      annotations=ann,
                      labels={const.LABEL_RESOURCE_KEY: const.LABEL_RESOURCE_VALUE})
    pod["metadata"]["namespace"] = ns
    return pod


def phase_interference(params, cfg) -> tuple[dict, dict]:
    """Phase 16, on phase 2's weights cut to their first INTERFERENCE_LAYERS
    layers: a latency-critical SlotEngine beside a best-effort
    PagedSlotEngine with weights of its own, governor off and on. An
    ``InterferenceDetector`` (the reference's threshold, 1.25) runs one
    pass after each solo and governor-off trial: residency from a fake
    apiserver holding the critical pod alone on card 0, then the
    best-effort pod beside it; step p99s scraped from the phase's own
    ``/metrics``. Returns the path's kernel launches and the phase's
    report."""
    from gpushare_device_plugin_tpu_torch.cluster import interference as TI
    from gpushare_device_plugin_tpu_torch.cluster.apiserver import ApiServerClient
    from gpushare_device_plugin_tpu_torch.cluster.podsource import ApiServerPodSource

    print("phase 16: interference, critical llama3_8b SlotEngine beside best-effort "
          f"llama3_8b PagedSlotEngine ({INTERFERENCE_LAYERS} of 32 layers, bf16)", flush=True)
    t_phase = time.perf_counter()
    fail: list[str] = []
    cfg = dataclasses.replace(cfg, n_layers=INTERFERENCE_LAYERS)
    params = {**params, "layers": {k: v[:INTERFERENCE_LAYERS]
                                   for k, v in params["layers"].items()}}
    be_params = init_params(cfg, torch.Generator(device="cuda").manual_seed(BE_SEED),
                            device="cuda", dtype=torch.bfloat16)
    crit = SlotEngine(params, cfg, slots=8, max_len=2048, prefill_chunk=512,
                      metrics_pod=CRIT_POD, profiler_capacity=4096)
    be = PagedSlotEngine(be_params, cfg, slots=16, max_len=2048, prefill_chunk=512,
                         page_size=16, total_pages=1024, radix=False, metrics_pod=BE_POD)
    crit_reqs = poisson_trace(8, seed=17, rate=0.5, vocab=cfg.vocab, prompt_lens=(128, 512),
                              max_new=(64, 64))
    busy_reqs = [dataclasses.replace(r, max_new=BUSY_MAX_NEW) for r in crit_reqs]
    be_reqs = poisson_trace(16, seed=19, rate=1.0, vocab=cfg.vocab, prompt_lens=(512, 1536),
                            max_new=(32, 64))
    tracing.TRACER.configure(sample_ratio=1.0)
    server = MetricsServer(host="127.0.0.1", port=0).start()
    report: dict = {"weights_gb": round((tensor_bytes(params) + tensor_bytes(be_params)) / 1e9, 3)}
    api = load_fake_apiserver().FakeApiServer()
    api.add_node(INTERFERENCE_NODE, capacity={const.RESOURCE_MEM: str(card_gib()),
                                              const.RESOURCE_COUNT: "1"})
    api.add_pod(interference_pod(CRIT_POD))
    api.start()
    client = ApiServerClient(api.url)
    detector = TI.InterferenceDetector(threshold=1.25)
    detect = TI.InterferenceLoop(detector, client, INTERFERENCE_NODE,
                                 ApiServerPodSource(client, INTERFERENCE_NODE),
                                 scrape_urls=[f"http://127.0.0.1:{server.port}"])
    passes: list[list] = []
    try:
        crit.warmup()
        be.warmup()
        warm_c, warm_b = dict(crit.trace_counts), dict(be.trace_counts)
        torch.cuda.synchronize()
        for name in fa.LAUNCHES:
            fa.LAUNCHES[name] = 0
        streams = {"critical": torch.cuda.current_stream().cuda_stream}
        be_ref = {r.rid: list(r.tokens) for r in be.run(be_reqs).results}

        # --- solo: a settle run, then six trials, the ring write on and off
        crit.run(crit_reqs)
        crit_tokens = None
        crit.profiler.reset()
        tpot = {True: [], False: []}
        for trial in range(6):
            profiled = trial % 2 == 0
            if not profiled:
                crit.profiler.record = lambda *a, **k: None
            stats = crit.run(crit_reqs)
            crit.profiler.__dict__.pop("record", None)
            passes.append(detect.run_once())
            toks = {r.rid: list(r.tokens) for r in stats.results}
            crit_tokens = crit_tokens or toks
            if toks != crit_tokens:
                fail.append(f"solo trial {trial}: critical tokens differ")
            tpot[profiled].append(tpot_p99_ms(stats))
        p50_solo, p99_solo = crit.profiler.p50(), crit.profiler.p99()
        med = lambda v: sorted(v)[len(v) // 2]  # noqa: E731
        overhead = (med(tpot[True]) / med(tpot[False]) - 1.0) * 100.0
        steps_solo = crit.profiler.count

        def check_tokens(stats, where, n=None):
            """Every request's tokens equal solo's (their first ``n``)."""
            got = {r.rid: list(r.tokens) for r in stats.results}
            if got != {rid: toks[:n] for rid, toks in crit_tokens.items()}:
                fail.append(f"{where}: critical tokens differ from solo")

        busy_stats, busy_solo = busy_share(lambda: crit.run(busy_reqs))
        check_tokens(busy_stats, "solo, busy window", BUSY_MAX_NEW)
        report["solo"] = {"step_p50_ms": p50_solo * 1e3, "step_p99_ms": p99_solo * 1e3,
                          "steps": steps_solo, "tpot_p99_ms_profiled": tpot[True],
                          "tpot_p99_ms_unprofiled": tpot[False],
                          "profiler_overhead_pct_tpot_p99": overhead, "busy": busy_solo}
        print("  solo", json.dumps(report["solo"]), flush=True)

        # --- the SLO budget, graded by a monitor thread against 1.3x solo
        target_s = p99_solo * INTERFERENCE_OBJECTIVE
        pages_fired: list[str] = []
        budget = SloBudget(
            {TIER_CRITICAL: SloObjective(tier=TIER_CRITICAL, goal=INTERFERENCE_GOAL)},
            on_page=lambda tier, v: pages_fired.append(tier),
        )

        def monitor(stop: threading.Event) -> None:
            while not stop.wait(0.01):
                p99 = crit.profiler.p99()
                if p99 == p99:  # not nan
                    budget.record(TIER_CRITICAL, p99 <= target_s)

        def window(label: str, after_trial=None) -> dict:
            """The critical trace INTERFERENCE_TRIALS times while the
            best-effort tenant loops its own trace on a thread and the
            monitor thread grades the critical tenant; then a short trial
            inside a busy-share window. The co-tenant is drained at the
            end."""
            stop_be, stop_mon = threading.Event(), threading.Event()
            be_out = {"tokens": 0, "runs": 0, "error": None, "retired_ok": True}

            def be_loop() -> None:
                streams["besteffort"] = torch.cuda.current_stream().cuda_stream
                try:
                    while not stop_be.is_set():
                        st = be.run(be_reqs)
                        be_out["runs"] += 1
                        for r in st.results:
                            be_out["tokens"] += len(r.tokens)
                            be_out["retired_ok"] &= list(r.tokens) == be_ref[r.rid]
                except BaseException as e:  # noqa: BLE001 — reported by the main thread
                    be_out["error"] = repr(e)

            crit.profiler.reset()
            be_thread = threading.Thread(target=be_loop, name="besteffort", daemon=True)
            mon = threading.Thread(target=monitor, args=(stop_mon,), name="monitor", daemon=True)
            t0 = time.perf_counter()
            be_thread.start()
            mon.start()
            try:
                for _ in range(INTERFERENCE_TRIALS):
                    last = crit.run(crit_reqs)
                    check_tokens(last, label)
                    if after_trial is not None:
                        after_trial()
                p50, p99, steps = crit.profiler.p50(), crit.profiler.p99(), crit.profiler.count
                busy_stats, busy = busy_share(lambda: crit.run(busy_reqs))
                check_tokens(busy_stats, f"{label}, busy window", BUSY_MAX_NEW)
            finally:
                stop_mon.set()
                stop_be.set()
                be.request_drain()
                mon.join(timeout=5.0)
                be_thread.join(timeout=120.0)
            wall = time.perf_counter() - t0
            out = {"step_p50_ms": p50 * 1e3, "step_p99_ms": p99 * 1e3, "steps": steps,
                   "p50_over_solo": p50 / p50_solo, "p99_over_solo": p99 / p99_solo,
                   "wall_s": wall, "busy": busy, "last_stats": last}
            if be_thread.is_alive():
                fail.append(f"{label}: the best-effort tenant did not drain")
            if be_out["error"]:
                fail.append(f"{label}: the best-effort tenant raised {be_out['error']}")
            try:
                snap = be.wait_drained(timeout=0.5)
            except TimeoutError:
                snap = None
            rows = (snap or {}).get("requests", [])
            drained_tokens = sum(len(row.get("tokens") or []) for row in rows)
            prefix_ok = be_out["retired_ok"] and all(
                list(row.get("tokens") or []) == be_ref[int(row["rid"])][: len(row.get("tokens") or [])]
                for row in rows)
            if not prefix_ok:
                fail.append(f"{label}: best-effort tokens left its ungoverned run's")
            return {**out, "besteffort_runs": be_out["runs"], "besteffort_drained_rows": len(rows),
                    "besteffort_tokens": be_out["tokens"] + drained_tokens,
                    "besteffort_tokens_per_s": (be_out["tokens"] + drained_tokens) / wall}

        # --- governor off: one window, after which the budget must page;
        # the detector sees the best-effort pod beside the critical one
        solo_baseline = detector.baseline(CRIT_POD)
        api.add_pod(interference_pod(BE_POD, best_effort=True))
        off = window("governor off", after_trial=lambda: passes.append(detect.run_once()))
        verdicts = passes[-1]
        published = TI.interference_from_node(client.get_node(INTERFERENCE_NODE)) or {}
        mine = [r for r in verdicts if r.chip == 0 and r.victim == CRIT_POD]
        report["detector"] = {
            "passes": len(passes), "solo_baseline_p99_ms": (solo_baseline or 0.0) * 1e3,
            "verdicts": [r.to_dict() for r in verdicts],
            "annotation": published,
            "ratio_vs_phase_p99_over_solo": {
                "detector": mine[0].ratio if mine else None,
                "phase": off["p99_over_solo"]},
        }
        print("  interference detector", json.dumps(report["detector"]), flush=True)
        if solo_baseline is None:
            fail.append("the detector took no solo baseline for the critical pod")
        if not mine or mine[0].aggressors != (BE_POD,):
            fail.append(f"the detector gave no verdict for card 0 with {CRIT_POD} as victim "
                        f"and {BE_POD} as aggressor: {[r.to_dict() for r in verdicts]}")
        else:
            row = published.get("chips", {}).get("0", {})
            want = {"victim": CRIT_POD, "aggressors": [BE_POD], "ratio": round(mine[0].ratio, 3),
                    "flagged": mine[0].flagged}
            if row != want or published.get("threshold") != 1.25:
                fail.append(f"the node's interference annotation {published} is not the "
                            f"report {want}")
        off_verdict = budget.publish(pod=CRIT_POD)[TIER_CRITICAL]
        report["off"] = {k: v for k, v in off.items() if k != "last_stats"}
        report["off"].update(severity=off_verdict.severity,
                             budget=off_verdict.to_dict(), pages_fired=len(pages_fired))
        print("  governor off", json.dumps(report["off"]), flush=True)
        if off_verdict.severity != "page" or not pages_fired:
            fail.append(f"the budget did not page with the governor off ({off_verdict.to_dict()})")

        # --- governor on: the same co-tenant, paced by the burning budget
        gov = StepGovernor(lambda: budget.severity(TIER_CRITICAL), pod=BE_POD, **GOVERNOR_KW)
        be.governor = gov
        try:
            on = window("governor on")
        finally:
            be.governor = None
        on_verdict = budget.publish(pod=CRIT_POD)[TIER_CRITICAL]
        report["on"] = {k: v for k, v in on.items() if k != "last_stats"}
        report["on"].update(severity=on_verdict.severity, budget=on_verdict.to_dict())
        report["governor"] = gov.stats()
        report["streams"] = streams
        print("  governor on", json.dumps(report["on"]), flush=True)
        print("  governor", json.dumps(report["governor"]), "; streams (cuda_stream handles)",
              json.dumps(streams), flush=True)
        if gov.engagements < 1 or gov.throttled_steps <= 0:
            fail.append(f"the governor did not throttle: {gov.stats()}")

        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)
        if crit.trace_counts != warm_c or be.trace_counts != warm_b:
            fail.append(f"shape guards moved: {crit.trace_counts} / {be.trace_counts}")
        if be.allocator.used_pages != 0:
            fail.append(f"{be.allocator.used_pages} pages not returned")
        if launches["flash_fwd"] < 1 or launches["flash_fwd_scalar"]:
            fail.append(f"the path's forward launches {launches}")

        # --- /metrics and /traces from the port's MetricsServer
        url = f"http://127.0.0.1:{server.port}"
        samples = parse_exposition(scrape(f"{url}/metrics"))

        def has(name, **labels):
            return any(all(lab.get(k) == v for k, v in labels.items())
                       for lab, _ in samples.get(name, []))

        want = [(MC.ENGINE_STEP_P99_SECONDS, dict(pod=CRIT_POD)),
                (MC.ENGINE_STEP_P99_SECONDS, dict(pod=BE_POD)),
                (MC.ENGINE_STEP_SECONDS + "_count", dict(pod=CRIT_POD)),
                (MC.GOVERNOR_ENGAGED, dict(pod=BE_POD)),
                (MC.GOVERNOR_ENGAGEMENTS_TOTAL, dict(pod=BE_POD)),
                (MC.GOVERNOR_THROTTLED_STEPS_TOTAL, dict(pod=BE_POD)),
                (MC.GOVERNOR_THROTTLE_SECONDS_TOTAL, dict(pod=BE_POD)),
                (MC.SLO_BURN_RATE, dict(pod=CRIT_POD, tier=TIER_CRITICAL, window="5m")),
                (MC.SLO_ERROR_BUDGET_REMAINING, dict(pod=CRIT_POD, tier=TIER_CRITICAL)),
                (MC.SLO_SEVERITY, dict(pod=CRIT_POD, tier=TIER_CRITICAL)),
                (MC.ENGINE_KV_PAGES_TOTAL, dict(pod=BE_POD)),
                (MC.ENGINE_KV_PAGES_FREE, dict(pod=BE_POD)),
                (MC.ENGINE_KV_PAGES_USED, dict(pod=BE_POD)),
                (MC.ENGINE_PREEMPTIONS, dict(pod=BE_POD)),
                (MC.BUILD_INFO, dict(component="engine"))]
        if be.preemptions:
            want.append((MC.ENGINE_PREEMPTIONS_TOTAL, dict(pod=BE_POD)))
        missing = [f"{n}{lab}" for n, lab in want if not has(n, **lab)]
        # the best-effort engine runs without a radix cache (a warm cache
        # would serve its looped trace from its own pages, and the tokens
        # could leave the ungoverned run's), so it publishes no prefix family
        prefix = sorted(n for n, v in samples.items() if n.startswith("tpushare_engine_prefix")
                        and any(lab.get("pod") == BE_POD for lab, _ in v))
        print(f"  /metrics: {sum(len(v) for v in samples.values())} samples, "
              f"{len(want) - len(missing)} of {len(want)} wanted series; {BE_POD}'s prefix "
              f"families {prefix} (it has no radix cache)", flush=True)
        if missing:
            fail.append(f"/metrics lacks {missing}")
        trees = 0
        for res in on["last_stats"].results:
            spans = tracing.spans_from_otlp(json.loads(scrape(f"{url}/traces?trace_id={res.trace_id}")))
            root = [s for s in spans if s["name"] == "serve.request"]
            names = sorted(s["name"] for s in spans)
            if res.trace_id and len(root) == 1 and names == [
                    "serve.decode", "serve.prefill", "serve.queue", "serve.request",
                    "serve.retire"] and all(
                    s["parent_id"] == root[0]["span_id"] for s in spans if s is not root[0]):
                trees += 1
        print(f"  /traces: {trees} of {len(crit_reqs)} critical requests with a serve.request "
              "tree", flush=True)
        if trees != len(crit_reqs):
            fail.append(f"/traces holds {trees} of {len(crit_reqs)} request trees")
    finally:
        server.stop()
        api.stop()
    report["launches"] = launches
    report["seconds"] = time.perf_counter() - t_phase
    print("  interference", json.dumps({
        "p99_ms": {"solo": report["solo"]["step_p99_ms"], "off": report["off"]["step_p99_ms"],
                   "on": report["on"]["step_p99_ms"]},
        "p99_over_solo": {"off": report["off"]["p99_over_solo"],
                          "on": report["on"]["p99_over_solo"]},
        "besteffort_tokens_per_s": {"off": report["off"]["besteffort_tokens_per_s"],
                                    "on": report["on"]["besteffort_tokens_per_s"]},
        "busy_share": {k: (report[k]["busy"] or {}).get("busy_share")
                       for k in ("solo", "off", "on")},
        "flash_fwd_launches": launches["flash_fwd"], "seconds": report["seconds"],
    }), flush=True)
    del crit, be, be_params
    torch.cuda.empty_cache()
    if fail:
        raise SystemExit("phase 16 failed: " + "; ".join(fail))
    return launches, report


def disagg_trace(vocab: int) -> list:
    """Phase 17's bimodal long-prefill trace, drawn as the reference's
    ``bench_serve_disagg`` draws it."""
    rng = np.random.RandomState(DISAGG_SEED)
    reqs, t = [], 0.0
    for rid in range(DISAGG_REQUESTS):
        t += float(rng.exponential(1.0 / DISAGG_RATE))
        lo, hi = DISAGG_LONG if rid % 4 == 3 else DISAGG_SHORT
        plen = int(rng.randint(lo, hi + 1))
        reqs.append(Request(
            rid=rid, prompt=tuple(int(x) for x in rng.randint(0, vocab, plen)),
            max_new=int(DISAGG_MIX[int(rng.randint(len(DISAGG_MIX)))]), arrival=t,
        ))
    return reqs


def quantiles(vals) -> dict:
    return {"p50": ceil_rank_quantile(vals, 0.5), "p99": ceil_rank_quantile(vals, 0.99)}


def smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def count_prefills(engine, box):
    """Append to ``box`` on each of ``engine``'s prefill dispatches (``del
    engine._prefill`` restores the method)."""
    program = engine._prefill

    def counted(*args):
        box.append(1)
        return program(*args)

    engine._prefill = counted


def measured(run):
    """``run()`` with the launch counts zeroed just before and read just
    after; (its result, wall seconds, launches)."""
    torch.cuda.synchronize()
    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(fa.LAUNCHES)


def phase_disagg(params, cfg, int8: bool = False) -> tuple[dict, dict]:
    """Phase 17, on phase 2's weights cut to their first DISAGG_LAYERS
    layers: the reference's disaggregated-serving bench at full width. One
    unified engine (the control), then
    a prefill and a decode tier behind ``DisaggServer`` twice: the live
    handoff, journaled (a WAL in a temporary directory and an
    ``AssumeCache``), and the forced fallback (``BrokenTransport``, two
    attempts), where every request re-prefills on the decode tier. Returns
    the live run's kernel launches and the phase's report. ``int8``: phase
    28 (c), the same over ``quantize_decoder``'s tree with int8 KV in every
    engine, the live run only, and each page's wire bytes against a bf16
    page's of the same geometry."""
    import tempfile

    from gpushare_device_plugin_tpu_torch.allocator.assume import AssumeCache
    from gpushare_device_plugin_tpu_torch.allocator.checkpoint import AllocationCheckpoint
    from gpushare_device_plugin_tpu_torch.serving import BrokenTransport, DisaggServer

    from gpushare_device_plugin_tpu_torch.serving.handoff import encode_page

    phase, kv = ("phase 28 (c)", "int8") if int8 else ("phase 17", None)
    print(f"{phase}: disaggregated prefill/decode serve, llama3_8b ({DISAGG_LAYERS} of 32 "
          f"layers, {'int8 weights and KV' if int8 else 'bf16'}), {DISAGG_REQUESTS} requests of "
          "bench_serve_disagg", flush=True)
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(cfg, n_layers=DISAGG_LAYERS)
    params = {**params, "layers": {k: v[:DISAGG_LAYERS] for k, v in params["layers"].items()}}
    if int8:
        params = Q.quantize_decoder(params)
    reqs = disagg_trace(cfg.vocab)
    rows = -(-DISAGG_MAX_LEN // DISAGG_PAGE)
    p_pages, d_pages = DISAGG_PREFILL_SLOTS * rows, DISAGG_DECODE_SLOTS * rows
    guard = {"prefill": 1, "extend": 1, "decode": 1}
    fail = []

    def mk(slots, pages):
        return PagedSlotEngine(params, cfg, slots=slots, max_len=DISAGG_MAX_LEN,
                               total_pages=pages, page_size=DISAGG_PAGE,
                               prefill_chunk=DISAGG_CHUNK, eos_id=EOS_ID, kv_dtype=kv)

    def check_engine(label, eng):
        if eng.trace_counts != guard:
            fail.append(f"{label}: shape guard moved: {eng.trace_counts}")
        if eng.allocator.used_pages != eng.radix.cached_pages:
            fail.append(f"{label}: {eng.allocator.used_pages} pages used, "
                        f"{eng.radix.cached_pages} held by the radix cache")

    def check_launches(label, launches, prefills):
        if not launches["flash_fwd"] == cfg.n_layers * prefills > 0:
            fail.append(f"{label}: flash_fwd launches {launches['flash_fwd']} != "
                        f"{cfg.n_layers} x {prefills} prefill dispatches")
        if launches["flash_fwd_scalar"]:
            fail.append(f"{label}: flash_fwd_scalar launched {launches['flash_fwd_scalar']} times")

    # --- the control: one engine, the same pages in all
    unified = mk(DISAGG_DECODE_SLOTS, p_pages + d_pages)
    unified.warmup()
    u_prefills: list = []
    count_prefills(unified, u_prefills)
    u_stats, u_wall, u_launches = measured(lambda: unified.run(reqs))
    del unified._prefill
    check_engine("unified", unified)
    check_launches("unified", u_launches, len(u_prefills))
    if len(u_stats.results) != len(reqs):
        fail.append("unified: not every request was served")
    u_tokens = {r.rid: list(r.tokens) for r in u_stats.results}
    u_tick_ms = u_wall * 1e3 / max(u_stats.ticks, 1)
    report = {"card": smi_line(), "requests": len(reqs),
              "long_prompts": sum(len(r.prompt) >= DISAGG_LONG[0] for r in reqs),
              "prompt_tokens": sum(len(r.prompt) for r in reqs),
              "unified": {
                  "slots": DISAGG_DECODE_SLOTS, "pages": p_pages + d_pages,
                  "ticks": u_stats.ticks, "wall_s": u_wall, "tick_ms": u_tick_ms,
                  "ttft_ticks": quantiles([r.ttft_ticks for r in u_stats.results]),
                  "tpot_ticks": quantiles([r.tpot_ticks for r in u_stats.results
                                           if len(r.tokens) > 1]),
                  "flash_fwd": u_launches["flash_fwd"], "prefill_dispatches": len(u_prefills),
              }}
    del unified
    torch.cuda.empty_cache()

    solos: dict = {}
    launches_live: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = AllocationCheckpoint(os.path.join(tmp, "handoff.wal"))
        runs = [("live", dict(checkpoint=ckpt, assume=AssumeCache())),
                ("fallback", dict(transport=BrokenTransport(), peer_kwargs={"attempts": 2}))]
        for label, kw in runs[:1] if int8 else runs:
            ds = DisaggServer(mk(DISAGG_PREFILL_SLOTS, p_pages), mk(DISAGG_DECODE_SLOTS, d_pages),
                              node="smoke", **kw)
            ds.warmup()
            boxes: dict = {"prefill": [], "decode": []}
            count_prefills(ds.prefill, boxes["prefill"])
            count_prefills(ds.decode, boxes["decode"])
            trace = reqs if label == "live" else reqs[:DISAGG_FALLBACK_REQUESTS]
            out, wall, launches = measured(lambda: ds.serve(trace))
            del ds.prefill._prefill, ds.decode._prefill
            if label == "live":
                launches_live = launches
            for tier in ("prefill", "decode"):
                check_engine(f"{label} {tier} tier", getattr(ds, tier))
            dispatches = len(boxes["prefill"]) + len(boxes["decode"])
            check_launches(label, launches, dispatches)
            if out["dropped"] or len(out["results"]) != len(trace):
                fail.append(f"{label}: dropped {out['dropped']}")
            if ds.ledger.pages_in_flight:
                fail.append(f"{label}: {ds.ledger.pages_in_flight} pages still in flight")
            paths = {rid: e["path"] for rid, e in out["results"].items()}
            if label == "live":
                if ds.outcomes.get("delivered", 0) < 1:
                    fail.append(f"live: no handoff delivered ({ds.outcomes})")
                if ckpt.pending():
                    fail.append(f"live: the journal holds {len(ckpt.pending())} pending entries")
                ckpt.close()
            elif any(p != "reprefill" for rid, p in paths.items() if len(u_tokens[rid]) > 1):
                fail.append(f"fallback: not every request re-prefilled: {paths}")
            bit_equal, divergences = 0, []
            for r in trace:
                got = out["results"][r.rid]["tokens"]
                bit_equal += got == u_tokens[r.rid]
                divergences += check_vs_solo(f"{phase} ({label})", params, cfg, r, got,
                                             want=u_tokens[r.rid], solos=solos, kv_dtype=kv)
            pst, dst = out["prefill"], out["decode"]
            tick_ms = (pst.wall_s + dst.wall_s) * 1e3 / max(pst.ticks + dst.ticks, 1)
            w = ds.wire
            handoffs = max(sum(ds.outcomes.values()), 1)
            report[label] = {
                "requests": len(trace),
                "outcomes": dict(ds.outcomes),
                "paths": {p: sum(v == p for v in paths.values())
                          for p in sorted(set(paths.values()))},
                "bit_equal_to_unified": bit_equal,
                "divergences": divergences,
                "max_gap_over_top": max((d["gap_over_top"] for d in divergences), default=None),
                "ticks": {"prefill": pst.ticks, "decode": dst.ticks},
                "wall_s": wall, "tick_ms": tick_ms,
                "ttft_ticks": quantiles([e["ttft_ticks"] for e in out["results"].values()
                                         if e["ttft_ticks"] is not None]),
                "tpot_ticks": quantiles([e["tpot_ticks"] for e in out["results"].values()
                                         if e["tpot_ticks"] is not None]),
                "peer": out["peer"],
                "wire": dict(w),
                "per_handoff_ms": {
                    "d2h": w["fetch_s"] * 1e3 / handoffs,
                    "encode": w["encode_s"] * 1e3 / handoffs,
                    "crc_journal_protocol":
                        (w["mover_s"] - w["decode_s"] - w["h2d_s"]) * 1e3 / handoffs,
                    "decode": w["decode_s"] * 1e3 / handoffs,
                    "h2d": w["h2d_s"] * 1e3 / handoffs,
                },
                "d2h_gb_per_s": w["bytes"] / w["fetch_s"] / 1e9 if w["fetch_s"] else None,
                "h2d_gb_per_s": w["bytes"] / w["h2d_s"] / 1e9 if w["h2d_s"] else None,
                "flash_fwd": launches["flash_fwd"], "prefill_dispatches": dict(
                    (k, len(v)) for k, v in boxes.items()),
            }
            for q in ("ttft_ticks", "tpot_ticks"):
                report[label][q.replace("ticks", "ms")] = {
                    k: v * tick_ms for k, v in report[label][q].items()}
            # the sink's callbacks close a cycle through the server, which
            # holds both engines (and the weights): collect it now, or the
            # weights outlive `del params` into the training phases
            del ds
            gc.collect()
            torch.cuda.empty_cache()
    for q in ("ttft_ticks", "tpot_ticks"):
        report["unified"][q.replace("ticks", "ms")] = {
            k: v * u_tick_ms for k, v in report["unified"][q].items()}
    report["disagg_ttft_p99_ms"] = report["live"]["ttft_ms"]["p99"]
    report["disagg_tpot_p99_ms"] = report["live"]["tpot_ms"]["p99"]
    wire = report["live"]["wire"]
    # a bf16 page of the same geometry, as phase 17 ships it
    shape = (cfg.n_layers, DISAGG_PAGE, cfg.kv_heads, cfg.head_dim)
    bf16_page = len(encode_page({key: torch.zeros(shape, dtype=torch.bfloat16)
                                 for key in ("k", "v")}))
    report["wire_bytes_per_page"] = wire["bytes"] / max(wire["pages"], 1)
    report["bf16_wire_bytes_per_page"] = bf16_page
    report["seconds"] = time.perf_counter() - t_phase
    print("  disagg", json.dumps(report), flush=True)
    if int8:
        split = report["live"]["per_handoff_ms"]
        print(f"  wire bytes per page {report['wire_bytes_per_page']:.1f} against a bf16 page's "
              f"{bf16_page} ({report['wire_bytes_per_page'] / bf16_page:.4f}); a handoff's "
              "wall split (ms): " + json.dumps(split), flush=True)
    if fail:
        raise SystemExit(f"{phase} failed: " + "; ".join(fail))
    return launches_live, report


def fleet_kill_tick(trace) -> int:
    """The tick at which the kill run kills e0: FLEET_KILL_AFTER ticks after
    the arrival of the first request the router sends there. Routing is
    deterministic, so a router over fresh replicas (no fingerprints, every
    slot free, as the fleet's first scrape finds them) places the trace as
    the fleet's will."""
    from gpushare_device_plugin_tpu_torch.serving.router import FleetMembership, FleetRouter
    from gpushare_device_plugin_tpu_torch.utils.decisions import DecisionLog
    from gpushare_device_plugin_tpu_torch.utils.metrics import MetricsRegistry

    reg = MetricsRegistry()
    members = FleetMembership(registry=reg)
    for i in range(FLEET_ENGINES):
        members.add(f"e{i}", None, capacity=FLEET_SLOTS)
    router = FleetRouter(members, page_size=FLEET_PAGE, decisions=DecisionLog(), registry=reg)
    for r in sorted(trace, key=lambda r: (r.arrival, r.rid)):
        if router.route(str(r.rid), r.prompt, r.tier).engine == "e0":
            return int(math.ceil(r.arrival)) + FLEET_KILL_AFTER
    raise SystemExit("phase 18 failed: the router sends the kill run nothing on e0")


def time_scale_hooks(executor) -> dict:
    """Time a ``ScaleExecutor``'s ``execute`` and its drain and migrate
    hooks (both run engines); the rest of ``execute`` is the protocol's
    host time: journal records, claims, cordon, rows and release. Returns
    the dict of seconds, which fills as the executor runs."""
    timing = {"drain_s": 0.0, "migrate_s": 0.0, "execute_s": 0.0}

    def timed(fn, key):
        def call(*a):
            t0 = time.perf_counter()
            try:
                return fn(*a)
            finally:
                timing[key] += time.perf_counter() - t0

        return call

    executor._drain = timed(executor._drain, "drain_s")
    executor._migrate = timed(executor._migrate, "migrate_s")
    executor.execute = timed(executor.execute, "execute_s")
    return timing


def phase_fleet(params, cfg) -> tuple[dict, dict]:
    """Phase 18, on phase 2's weights cut to their first FLEET_LAYERS
    layers: the reference's fleet bench at full width. One unified engine (the control), then three engines
    behind ``FleetServer`` four times, each on fresh engines:
    ``prefix-affinity``, ``spread`` (affinity-blind), ``prefix-affinity``
    with a journaled scale-down of e0 (a WAL in a temporary directory and
    an ``AssumeCache``), and e0 killed mid-decode on the trace's first
    requests. Returns the affinity run's kernel launches and the phase's
    report."""
    import tempfile

    from gpushare_device_plugin_tpu_torch.allocator.assume import AssumeCache
    from gpushare_device_plugin_tpu_torch.allocator.checkpoint import AllocationCheckpoint
    from gpushare_device_plugin_tpu_torch.serving import FleetServer

    print(f"phase 18: the serving fleet, llama3_8b ({FLEET_LAYERS} of 32 layers, bf16), "
          f"{FLEET_ENGINES} engines, {FLEET_REQUESTS} requests of bench_serve_fleet", flush=True)
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(cfg, n_layers=FLEET_LAYERS)
    params = {**params, "layers": {k: v[:FLEET_LAYERS] for k, v in params["layers"].items()}}
    reqs = shared_prefix_trace(FLEET_REQUESTS, seed=FLEET_SEED, rate=FLEET_RATE, vocab=cfg.vocab,
                               prefixes=FLEET_PREFIXES, tail_lens=FLEET_TAILS, max_new=FLEET_MIX)
    pages = FLEET_SLOTS * -(-FLEET_MAX_LEN // FLEET_PAGE)
    guard = {"prefill": 1, "extend": 1, "decode": 1}
    fail = []

    spent = {"warmup_s": 0.0, "solo_check_s": 0.0}

    def mk(slots, n_pages):
        t0 = time.perf_counter()
        eng = PagedSlotEngine(params, cfg, slots=slots, max_len=FLEET_MAX_LEN,
                              total_pages=n_pages, page_size=FLEET_PAGE,
                              prefill_chunk=FLEET_CHUNK, eos_id=EOS_ID)
        eng.warmup()
        torch.cuda.synchronize()
        spent["warmup_s"] += time.perf_counter() - t0
        return eng

    def check_pool(label, eng):
        if eng.trace_counts != guard:
            fail.append(f"{label}: shape guard moved: {eng.trace_counts}")
        if eng.allocator.used_pages != eng.radix.cached_pages:
            fail.append(f"{label}: {eng.allocator.used_pages} pages used, "
                        f"{eng.radix.cached_pages} held by the radix cache")

    def check_launches(label, launches, prefills):
        if not launches["flash_fwd"] == cfg.n_layers * prefills > 0:
            fail.append(f"{label}: flash_fwd launches {launches['flash_fwd']} != "
                        f"{cfg.n_layers} x {prefills} prefill dispatches")
        if launches["flash_fwd_scalar"]:
            fail.append(f"{label}: flash_fwd_scalar launched {launches['flash_fwd_scalar']} times")

    def latencies(results):
        return {q: quantiles([e[q] for e in results if e[q] is not None])
                for q in ("ttft_ticks", "tpot_ticks")}

    # --- the control: one engine of every slot, never fleeted
    unified = mk(FLEET_SLOTS * FLEET_ENGINES, pages * FLEET_ENGINES)
    u_prefills: list = []
    count_prefills(unified, u_prefills)
    u_stats, u_wall, u_launches = measured(lambda: unified.run(reqs))
    del unified._prefill
    check_pool("unified", unified)
    check_launches("unified", u_launches, len(u_prefills))
    if len(u_stats.results) != len(reqs):
        fail.append("unified: not every request was served")
    u_tokens = {r.rid: list(r.tokens) for r in u_stats.results}
    generated = sum(len(t) for t in u_tokens.values())
    report = {"card": smi_line(), "requests": len(reqs), "engines": FLEET_ENGINES,
              "slots_per_engine": FLEET_SLOTS, "pages_per_engine": pages,
              "prompt_tokens": sum(len(r.prompt) for r in reqs),
              "unified": {
                  "slots": FLEET_SLOTS * FLEET_ENGINES, "pages": pages * FLEET_ENGINES,
                  "ticks": u_stats.ticks, "wall_s": u_wall, "generated_tokens": generated,
                  "tokens_per_s": generated / u_wall,
                  "prefix_hit_ratio": unified.radix.hit_ratio(),
                  **latencies([{"ttft_ticks": r.ttft_ticks,
                                "tpot_ticks": r.tpot_ticks if len(r.tokens) > 1 else None}
                               for r in u_stats.results]),
                  "flash_fwd": u_launches["flash_fwd"], "prefill_dispatches": len(u_prefills),
              }}
    del unified
    torch.cuda.empty_cache()

    solos: dict = {}

    def one_run(tmp, label, policy, trace, serve_kw) -> tuple[dict, dict]:
        """One fleet run on fresh engines: (its report row, its launches).
        Everything it built dies with its frame, but for the cycle the
        caller collects."""
        engines = {f"e{i}": mk(FLEET_SLOTS, pages) for i in range(FLEET_ENGINES)}
        kw = {}
        if label == "scale_down":
            ckpt = AllocationCheckpoint(os.path.join(tmp, "scale.wal"))
            kw = dict(checkpoint=ckpt, assume=AssumeCache())
        fleet = FleetServer(engines, policy=policy, node="smoke", **kw)
        boxes = {name: [] for name in engines}
        for name, eng in engines.items():
            count_prefills(eng, boxes[name])
        timing = time_scale_hooks(fleet.executor)
        out, wall, launches = measured(lambda: fleet.serve(trace, **serve_kw))
        for name, eng in engines.items():
            del eng._prefill
            check_pool(f"{label} {name}", eng)
        prefills = sum(len(b) for b in boxes.values())
        check_launches(label, launches, prefills)
        results = out["results"]
        if out["dropped"] or out["double_served"] or len(results) != len(trace):
            fail.append(f"{label}: dropped {out['dropped']}, double-served "
                        f"{out['double_served']}, {len(results)} of {len(trace)} served")
        paths = [e["path"] for e in results.values()]
        bit_equal, divergences = 0, []
        t0 = time.perf_counter()
        for r in trace:
            if r.rid not in results:
                continue
            got = results[r.rid]["tokens"]
            bit_equal += got == u_tokens[r.rid]
            divergences += check_vs_solo(f"phase 18 ({label})", params, cfg, r, got,
                                         want=u_tokens[r.rid], solos=solos)
        spent["solo_check_s"] += time.perf_counter() - t0
        generated = sum(len(e["tokens"]) for e in results.values())
        row = {
            "policy": policy, "requests": len(trace), "wall_s": wall,
            "generated_tokens": generated, "tokens_per_s": generated / wall,
            "router": out["router"], "prefix_hit_ratio": out["prefix_hit_ratio"],
            "replicas": {n: r["state"] for n, r in out["replicas"].items()},
            "requests_by_engine": {n: sum(e["engine"] == n for e in results.values())
                                   for n in sorted(engines)},
            "paths": {p: paths.count(p) for p in sorted(set(paths))},
            "bit_equal_to_unified": bit_equal, "divergences": divergences,
            "max_gap_over_top": max((d["gap_over_top"] for d in divergences), default=None),
            **latencies(list(results.values())),
            "flash_fwd": launches["flash_fwd"], "prefill_dispatches": prefills,
        }
        if label == "scale_down":
            ex = fleet.executor
            row["scale"] = {
                "completed_ops": ex.completed_ops, "migrated_requests": ex.migrated_requests,
                "pending": len(ckpt.pending()), **timing,
                "protocol_host_s": timing["execute_s"] - timing["drain_s"] - timing["migrate_s"],
            }
            if ex.completed_ops != 1:
                fail.append(f"scale_down: {ex.completed_ops} scale ops, expected 1")
            if ex.migrated_requests < 1:
                fail.append("scale_down: no request migrated")
            if ckpt.pending():
                fail.append(f"scale_down: the journal holds {len(ckpt.pending())} pending entries")
            ckpt.close()
        if label == "kill":
            row["kill_tick"] = serve_kw["kill_engine"][1]
            row["requeued"] = paths.count("requeued")
            if not row["requeued"]:
                fail.append(f"kill: nothing re-queued (e0 killed at tick {row['kill_tick']})")
        return row, launches

    runs = (("affinity", "prefix-affinity", reqs, {}),
            ("spread", "spread", reqs, {}),
            ("scale_down", "prefix-affinity", reqs, {"scale_down": ("e0", FLEET_SCALE_TICK)}),
            ("kill", "prefix-affinity", reqs[:FLEET_KILL_REQUESTS],
             {"kill_engine": ("e0", fleet_kill_tick(reqs[:FLEET_KILL_REQUESTS]))}))
    launches_fleet: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, policy, trace, serve_kw in runs:
            report[label], launches = one_run(tmp, label, policy, trace, serve_kw)
            if label == "affinity":
                launches_fleet = launches
            # the executor and the scrape clients hold the server's bound
            # methods, a cycle through the engines: collect it now, or the
            # pools (and, after the last run, the weights) outlive the run
            gc.collect()
            torch.cuda.empty_cache()
    if not report["affinity"]["prefix_hit_ratio"] > report["spread"]["prefix_hit_ratio"]:
        fail.append(f"affinity's prefix-hit ratio {report['affinity']['prefix_hit_ratio']} is "
                    f"not above spread's {report['spread']['prefix_hit_ratio']}")
    report.update(spent, solo_decodes=len(solos))
    report["fleet_goodput_tokens_per_s"] = report["affinity"]["tokens_per_s"]
    report["fleet_prefix_hit_ratio"] = report["affinity"]["prefix_hit_ratio"]
    report["seconds"] = time.perf_counter() - t_phase
    print("  fleet", json.dumps(report), flush=True)
    if fail:
        raise SystemExit("phase 18 failed: " + "; ".join(fail))
    return launches_fleet, report


def cp_attention_inputs():
    """Phase 19 (a)'s global q [1, S, 32, 128], k, v [1, S, 8, 128] and dO,
    bf16, seeded on the card."""
    gen = torch.Generator(device="cuda").manual_seed(CP_SEED)
    shapes = ((1, CP_ATTN_S, 32, 128), (1, CP_ATTN_S, 8, 128), (1, CP_ATTN_S, 8, 128),
              (1, CP_ATTN_S, 32, 128))
    return [torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16) for s in shapes]


def cp_train_cfg(scheme: str | None) -> T.TransformerConfig:
    """Phase 19 (b)'s decoder: ``llama3_8b()`` width cut to CP_TRAIN_LAYERS
    layers, remat "full"; sequence parallel by ``scheme`` (None: the
    1-rank control)."""
    seq = dict(seq_parallel=True, context_parallel=scheme) if scheme else {}
    return dataclasses.replace(llama3_8b(), n_layers=CP_TRAIN_LAYERS, **seq)


def cp_first_batch(cfg) -> torch.Tensor:
    """The global batch ``run_train_loop`` makes for step 0 at CP_SEED."""
    gen = torch.Generator().manual_seed(fold_in(fold_in(CP_SEED, 1), 0))
    return DecoderTask(cfg, batch=1, seq=CP_TRAIN_S).make_batch(gen, 0)


def cp_first_params(cfg, device) -> dict:
    """The parameters ``run_train_loop`` starts from at CP_SEED."""
    gen = torch.Generator(device=device).manual_seed(fold_in(CP_SEED, 0))
    return init_params(cfg, gen, device=device)


def cp_hops(rank: int, n: int, causal: bool) -> int:
    """Flash calls a rank of a ring of n makes per forward: its diagonal
    hop and the earlier blocks (all n when not causal)."""
    return rank + 1 if causal else n


def cp_rank_main(argv: list[str]) -> int:
    """One rank of phase 19, in a child whose env is the plugin's for its
    slice of the card plus the multi-host bootstrap (``TPUSHARE_*``): cap
    the process, join the gloo world, build the sp mesh, run ``argv =
    [job, workdir]`` ("attention", "ring" or "ulysses"). Prints one JSON
    line."""
    job, workdir = argv[0], argv[1]
    configure_torch_from_env()
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = initialize_multihost(backend="gloo", timeout_s=CP_COLLECTIVE_TIMEOUT_S)
    mesh = make_mesh(MeshSpec(sp=spec.num_processes), backend="gloo")
    doc = {"job": job, "rank": mesh.rank, "device": str(mesh.device)}
    doc.update(cp_attention_rank(mesh, workdir) if job == "attention"
               else cp_train_rank(mesh, job))
    print(json.dumps(doc), flush=True)
    dist.destroy_process_group()
    return 0


def cp_attention_rank(mesh, workdir: str) -> dict:
    """Phase 19 (a) on one rank: its shard of the ring (flash hops, causal
    and not) and of Ulysses (flash inner attention, causal), forward and
    backward, against the parent's single-process flash_attention."""
    data = torch.load(os.path.join(workdir, "attention.pt"), mmap=True, weights_only=True)
    n, r = mesh.shape["sp"], mesh.axis_index("sp")
    T_ = CP_ATTN_S // n

    def mine(t):
        return t[:, r * T_:(r + 1) * T_].to(mesh.device)

    q, k, v, do = (mine(t) for t in data["inputs"])
    out = {}
    cases = (("warmup", "ring", True), ("ring_causal", "ring", True),
             ("ring_noncausal", "ring", False), ("ulysses_causal", "ulysses", True))
    for name, scheme, causal in cases:
        x = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        before = dict(fa.LAUNCHES)
        mesh.traffic.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if scheme == "ring":
            o = ring_attention(*x, mesh, causal=causal, hop_attention="flash")
        else:
            o = ulysses_attention(*x, mesh, causal=causal, attn_fn=ulysses_inner_attn("flash"))
        grads = torch.autograd.grad(o, x, do)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if name == "warmup":
            continue
        launches = {e: fa.LAUNCHES[e] - before[e] for e in fa.LAUNCHES if fa.LAUNCHES[e] > before[e]}
        want = [mine(t) for t in data["causal" if causal else "noncausal"]]
        err = (o.float() - want[0].float()).abs()
        o_ok = bool((err <= BF16_REL * want[0].float().abs().clamp(min=1.0)).all())
        o_ok &= bool(torch.isfinite(o.float()).all())
        g_ok = {nm: bwd_close(g, w, torch.bfloat16)
                for nm, g, w in zip(("dq", "dk", "dv"), grads, want[1:])}
        calls = cp_hops(r, n, causal) if scheme == "ring" else 1
        expect = {"flash_fwd": calls, "flash_bwd_dq": calls, "flash_bwd_dkv": calls}
        out[name] = {
            "ok": o_ok and all(g_ok.values()) and launches == expect,
            "o_max_abs_err": float(err.max()), "o_ok": o_ok, "grads_ok": g_ok,
            "grad_max_abs_err": {nm: float((g.float() - w.float()).abs().max())
                                 for nm, g, w in zip(("dq", "dk", "dv"), grads, want[1:])},
            "launches": launches, "expected_launches": expect,
            "hops": ({"diagonal": 1, "earlier": calls - 1, "skipped": n - calls}
                     if scheme == "ring" else None),
            "wall_s": wall,
            "exchanges": {kind: dataclasses.asdict(t) for kind, t in mesh.traffic.items()},
        }
    return out


def cp_control_grads(device) -> list:
    """The 1-rank control's gradients of the first step (no mesh, the whole
    sequence), on ``device``."""
    cfg = cp_train_cfg(None)
    params = cp_first_params(cfg, device)
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    loss = T.loss_fn(params, cp_first_batch(cfg).to(device), cfg)
    return [g.detach() for g in torch.autograd.grad(loss, leaves)]


def cp_train_rank(mesh, scheme: str) -> dict:
    """Phase 19 (b) on one rank: the first step's loss and gradients
    summed over the mesh (rank 0 holds them against the 1-rank control's,
    which it computes itself), then ``run_train_loop`` for CP_TRAIN_STEPS
    steps on the mesh."""
    cfg = cp_train_cfg(scheme)
    dev = mesh.device
    doc: dict = {"scheme": scheme}
    control = cp_control_grads(dev) if mesh.rank == 0 else None
    params = cp_first_params(cfg, dev)
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    loss = T.loss_fn(params, cp_first_batch(cfg).to(dev), cfg, mesh)
    grads = list(torch.autograd.grad(loss, leaves))
    all_reduce_sum_(grads, mesh, T.REPLICA_AXES)
    doc["first_loss"] = float(loss.detach())
    if control is not None:
        doc["grad_rel_by_leaf"] = {
            name: float((g - c).float().norm() / c.float().norm())
            for name, g, c in zip(T._flatten(params), grads, control)}
        doc["zero_grads"] = [name for name, g in zip(T._flatten(params), grads)
                             if not (torch.isfinite(g).all() and g.any())]
    del params, leaves, grads, control, loss
    gc.collect()
    fresh_run()
    mesh.traffic.clear()
    losses, step_s = [], []
    clock = [time.perf_counter()]

    def on_metrics(step, value):
        now = time.perf_counter()
        step_s.append(now - clock[0])
        clock[0] = now
        losses.append(value)

    run_train_loop(DecoderTask(cfg, batch=1, seq=CP_TRAIN_S),
                   TrainLoopConfig(total_steps=CP_TRAIN_STEPS, log_every=1), CP_SEED,
                   mesh=mesh, on_metrics=on_metrics)
    torch.cuda.synchronize()
    n, r = mesh.shape["sp"], mesh.axis_index("sp")
    per_run = CP_TRAIN_LAYERS * CP_TRAIN_STEPS
    calls = cp_hops(r, n, True) if scheme == "ring" else 1
    doc.update(
        losses=losses, step_s=step_s, step_p50_s=sorted(step_s)[len(step_s) // 2],
        peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
        launches=dict(fa.LAUNCHES),
        # forward and the recompute of remat "full", then the backward
        expected_launches={e: 0 for e in fa.LAUNCHES} | {
            "flash_fwd": 2 * calls * per_run, "flash_bwd_dq": calls * per_run,
            "flash_bwd_dkv": calls * per_run},
        exchanges={kind: dataclasses.asdict(t) for kind, t in mesh.traffic.items()},
    )
    return doc


def run_ranks(job: str, n: int, units: int, workdir: str, *, entry: str = "cp_rank_main",
              phase: str = "phase 19", gang: bool = False) -> list[dict]:
    """Start ``n`` ranks of ``job`` at once (``chip_smoke.<entry>`` in
    children), each with the plugin's env for a ``units``-GiB slice (with
    ``gang``, the env of an n-chip gang grant of ``units`` GiB a chip) and
    the multi-host env of an n-process world on localhost; wait for all (a
    watchdog kills every one past CP_TIMEOUT_S). Returns their JSON
    documents by rank; raises if any rank fails."""
    return collect_ranks(start_ranks(job, n, units, workdir, entry=entry, gang=gang), phase)


def start_ranks(job: str, n: int, units: int, workdir: str, *, entry: str,
                gang: bool = False):
    """:func:`run_ranks`' start: the ranks run on while the caller works;
    hand the result to :func:`collect_ranks`."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(n):
        env = {k: v for k, v in os.environ.items() if k != const.ENV_CUDA_VISIBLE_DEVICES}
        env.update(gang_env(units, n) if gang else plugin_env(units))
        env.update({const.ENV_COORDINATOR_ADDRESS: f"127.0.0.1:{port}",
                    const.ENV_NUM_PROCESSES: str(n), const.ENV_PROCESS_ID: str(rank)})
        log = open(os.path.join(workdir, f"{job}-{rank}.log"), "w+")
        code = f"import sys, chip_smoke; sys.exit(chip_smoke.{entry}(sys.argv[1:]))"
        procs.append((subprocess.Popen(
            [sys.executable, "-c", code, job, workdir],
            cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
            stdout=log, stderr=subprocess.STDOUT, text=True), log))
    watchdog = threading.Timer(CP_TIMEOUT_S, lambda: [p.kill() for p, _ in procs])
    watchdog.start()
    return job, procs, watchdog


def wait_ready(handle, workdir: str, phase: str) -> None:
    """Wait until every rank of :func:`start_ranks` wrote its
    ``ready-<rank>`` file; a rank that ends first fails the phase (the
    caller then stops the others with :func:`collect_ranks`)."""
    _, procs, _ = handle
    while not all(os.path.exists(os.path.join(workdir, f"ready-{r}")) for r in range(len(procs))):
        if any(p.poll() is not None for p, _ in procs):
            raise SystemExit(f"{phase} failed: a rank ended before it was ready")
        time.sleep(0.05)


def collect_ranks(handle, phase: str, kill: bool = False) -> list[dict]:
    """Wait for the ranks of :func:`start_ranks` (``kill``: stop them first,
    when the caller failed meanwhile); their JSON documents by rank, or
    raise if any rank failed."""
    job, procs, watchdog = handle
    try:
        if kill:
            for p, _ in procs:
                p.kill()
        codes = [p.wait() for p, _ in procs]
    finally:
        watchdog.cancel()
    docs, fail = [], []
    for rank, ((_, log), rc) in enumerate(zip(procs, codes)):
        log.seek(0)
        text = log.read()
        log.close()
        lines = [line for line in text.splitlines() if line.startswith("{")]
        if rc != 0 or not lines:
            fail.append(f"rank {rank} exited {rc}: {text[-3000:]}")
        else:
            docs.append(json.loads(lines[-1]))
    if fail:
        raise SystemExit(f"{phase} failed ({job}): " + "; ".join(fail))
    return docs


def cp_kernel_rows(gen, shapes=CP_KERNEL_SHAPES, phase: str = "phase 19") -> dict:
    """The three main-path kernels at a phase's new ``shapes`` against their
    plain versions, each with its time, bound and PyTorch's SDPA. Phase
    19's: the ring's non-causal hop (1 x 4,096 of phase (a)'s ring, 32/8
    heads) and Ulysses's whole-sequence call at sp=2 (1 x 8,192, 16/4
    heads, causal; phase (b)). Returns rows by (entry, shape label)."""
    rows, failures = {}, 0
    for label, (Bk, S, H, Hkv, causal, *head_dim) in shapes.items():
        D = head_dim[0] if head_dim else 128
        q, k, v = attention_inputs(gen, Bk, S, H, Hkv, D, torch.bfloat16)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
        bounds = dict(causal=causal, start=None, kv_len=None)
        sc = D ** -0.5
        plain = lambda: fa.flash_fwd_plain(q, k, v, scale=sc, **bounds)  # noqa: E731
        po, plse = plain()
        plain_ms = cuda_ms(plain, 2, warmup=1)
        run = lambda: fa._launch_fwd("flash_fwd", q, k, v, scale=sc, **bounds)  # noqa: E731
        o, lse = run()
        err, ok = compare(o, lse, po, plse, torch.bfloat16)
        del po, plse
        ms = cuda_ms(run, 20)
        bound_ms, bound_by, flops = flash_bound(q, k, v, **bounds)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), 20)
        rows[("flash_fwd", label)] = dict(
            shape=f"bf16 B={Bk} S={S} H={H} Hkv={Hkv} D={D} " + ("causal" if causal else "non-causal"),
            max_abs_err=err, ok=ok, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=lib_ms, tflops=flops / ms / 1e9,
            bound_fraction=bound_ms / ms)
        failures += not ok
        delta = (do.float() * o.float()).sum(-1)
        bplain = lambda: fa.flash_bwd_plain(q, k, v, do, lse, delta, scale=sc, **bounds)  # noqa: E731
        want = dict(zip(("dq", "dk", "dv"), bplain()))
        bplain_ms = cuda_ms(bplain, 1, warmup=0)
        lib_bwd_ms = sdpa_backward_ms(q, k, v, do, None, causal)
        for entry in fa.bwd_entries(torch.bfloat16, D):
            brun = lambda: fa._launch_bwd(entry, q, k, v, do, lse, delta, scale=sc, **bounds)  # noqa: E731
            got = brun()
            names = ("dq",) if entry in DQ_ENTRIES else ("dk", "dv")
            got = dict(zip(names, got if isinstance(got, tuple) else (got,)))
            bok = all(bwd_close(got[nm], want[nm], torch.bfloat16) for nm in names)
            bms = cuda_ms(brun, 10)
            b_bound, b_by, b_flops = bwd_bound(entry, q, k, v, **bounds)
            rows[(entry, label)] = dict(
                shape=rows[("flash_fwd", label)]["shape"], ok=bok,
                max_abs_err=max(float((got[nm].float() - want[nm].float()).abs().max())
                                for nm in names),
                ms=bms, plain_ms=bplain_ms, bound_ms=b_bound, bound_by=b_by,
                library_ms=lib_bwd_ms, tflops=b_flops / bms / 1e9, bound_fraction=b_bound / bms)
            failures += not bok
        del want
        torch.cuda.empty_cache()
    for key, row in rows.items():
        print("  ", key[1], key[0], json.dumps(row), flush=True)
    if failures:
        raise SystemExit(f"{phase} failed: {failures} kernel case(s) out of tolerance")
    return rows


def phase_context_parallel(gen) -> tuple[dict, dict, dict, dict]:
    """Phase 19; returns the kernel launches of (b)'s ring and Ulysses runs
    (summed over ranks), the kernel rows at the phase's shapes, and a
    report."""
    print(f"phase 19: context parallelism, {CP_ATTN_RANKS} and {CP_TRAIN_RANKS} gloo ranks "
          "on one card", flush=True)
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    rows = cp_kernel_rows(gen)
    report: dict = {}
    fail = []
    with tempfile.TemporaryDirectory() as workdir:
        # (a) attention on four ranks, against one flash_attention here.
        q, k, v, do = cp_attention_inputs()
        saved = {"inputs": [t.cpu() for t in (q, k, v, do)]}
        for label, causal in (("causal", True), ("noncausal", False)):
            x = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            o = fa.flash_attention(*x, causal=causal)
            saved[label] = [o.detach().cpu(), *(g.cpu() for g in torch.autograd.grad(o, x, do))]
        torch.save(saved, os.path.join(workdir, "attention.pt"))
        del saved, q, k, v, do, x, o
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        docs = run_ranks("attention", CP_ATTN_RANKS, CP_ATTN_UNITS, workdir)
        report["attention_s"] = time.perf_counter() - t0
        for doc in docs:
            doc.pop("job")
            print("   attention", json.dumps(doc), flush=True)
            fail += [f"(a) rank {doc['rank']} {case}" for case in
                     ("ring_causal", "ring_noncausal", "ulysses_causal") if not doc[case]["ok"]]

        # (b) decoder training: the 1-rank control here, then the ring and
        # Ulysses at sp=2.
        fresh_run()
        cfg = cp_train_cfg(None)
        losses, step_s = [], []
        clock = [time.perf_counter()]

        def on_metrics(step, value):
            now = time.perf_counter()
            step_s.append(now - clock[0])
            clock[0] = now
            losses.append(value)

        state, _ = run_train_loop(DecoderTask(cfg, batch=1, seq=CP_TRAIN_S),
                                  TrainLoopConfig(total_steps=CP_TRAIN_STEPS, log_every=1),
                                  CP_SEED, on_metrics=on_metrics)
        torch.cuda.synchronize()
        per_run = CP_TRAIN_LAYERS * CP_TRAIN_STEPS
        control = {"losses": losses, "step_s": step_s,
                   "step_p50_s": sorted(step_s)[len(step_s) // 2],
                   "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "launches": dict(fa.LAUNCHES)}
        print("   control", json.dumps(control), flush=True)
        want = {e: 0 for e in fa.LAUNCHES} | {"flash_fwd": 2 * per_run,
                                              "flash_bwd_dq": per_run, "flash_bwd_dkv": per_run}
        if control["launches"] != want:
            fail.append(f"(b) control launches {control['launches']} != {want}")
        if not falling(losses):
            fail.append(f"(b) control losses {losses}")
        report["control"] = control
        del state
        gc.collect()
        torch.cuda.empty_cache()
        launches = {}
        for scheme in ("ring", "ulysses"):
            t0 = time.perf_counter()
            docs = run_ranks(scheme, CP_TRAIN_RANKS, CP_TRAIN_UNITS, workdir)
            report[f"{scheme}_s"] = time.perf_counter() - t0
            launches[scheme] = {e: sum(d["launches"][e] for d in docs) for e in fa.LAUNCHES}
            report[scheme] = docs
            for doc in docs:
                print(f"   {scheme}", json.dumps(doc), flush=True)
                tag = f"(b) {scheme} rank {doc['rank']}"
                if abs(doc["first_loss"] - losses[0]) > GRAD_LOSS_REL * abs(losses[0]):
                    fail.append(f"{tag}: first loss {doc['first_loss']} vs control {losses[0]}")
                if not falling(doc["losses"]):
                    fail.append(f"{tag}: losses {doc['losses']}")
                if doc["launches"] != doc["expected_launches"]:
                    fail.append(f"{tag}: launches {doc['launches']} != {doc['expected_launches']}")
                if "grad_rel_by_leaf" in doc:
                    bad = {nm: e for nm, e in doc["grad_rel_by_leaf"].items()
                           if not e <= GRAD_LEAF_REL}
                    if bad or doc["zero_grads"]:
                        fail.append(f"{tag}: gradients {bad}, zero {doc['zero_grads']}")
    report["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 19: {report['seconds']:.1f} s (attention {report['attention_s']:.1f}, "
          f"ring {report['ring_s']:.1f}, ulysses {report['ulysses_s']:.1f})", flush=True)
    if fail:
        raise SystemExit("phase 19 failed: " + "; ".join(fail))
    return launches["ring"], launches["ulysses"], rows, report


def nbytes(tree) -> int:
    """Bytes of a tree's tensors (lists and dicts; a cache's ``len`` too)."""
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def shard_bytes(cfg, mesh_shape: dict, itemsize: int, norms_itemsize: int = 4) -> int:
    """Bytes of one rank's shards of ``cfg``'s params (matmul weights and
    the embedding at ``itemsize``, the norms' gains at ``norms_itemsize``),
    from the shapes and the pruned specs alone."""

    # rank 0 of the mesh, with no groups: the spec arithmetic needs only its shape
    mesh = Mesh(MeshSpec(**mesh_shape), rank=0, device=torch.device("cpu"), backend="gloo",
                groups={}, ranks={})
    specs = T._flatten(T.param_shardings(mesh, cfg))
    total = 0
    for name, shape in T._flatten(T.param_shapes(cfg)).items():
        size = itemsize if name not in ("layers__ln1", "layers__ln2", "final_norm") \
            else norms_itemsize
        total += int(np.prod(T.local_shape(shape, specs[name], mesh))) * size
    return total


def tp_paged_plan(cfg):
    """Phase 20 (a2)'s pool: paged_plan_for_slice over a TP_PAGED_UNITS-GiB
    share of each of TP_RANKS chips, for the adapters' slab too."""
    return paged_plan_for_slice(
        TP_PAGED_UNITS * 2**30, cfg, TP_PAGED_GEO["max_len"], page_size=TP_PAGED_GEO["page_size"],
        prefill_chunk=TP_PAGED_GEO["prefill_chunk"], weight_bytes=shard_bytes(cfg, {}, 2),
        slots=8, lora=True, n_chips=TP_RANKS)


def tp_serve_run(engine, trace, mesh=None) -> dict:
    """Warm ``engine`` up, then serve ``trace`` with the launch counts set to
    0 just before; returns the tokens by rid and the run's numbers."""
    engine.warmup()
    fresh_run()
    if mesh is not None:
        mesh.traffic.clear()
    stats = engine.run(trace)
    torch.cuda.synchronize()
    summary = stats.summary()
    doc = {
        "tokens": {r.rid: r.tokens for r in stats.results},
        "wall_s": summary["wall_s"], "ticks": summary["ticks"],
        "goodput_tokens_per_s": summary["goodput_tokens_per_s"],
        "decode_step_p50_ms": engine.profiler.p50() * 1e3,
        "shape_guard": stats.trace_counts, "launches": dict(fa.LAUNCHES),
        "weight_bytes": nbytes(engine.params),
        "kv_bytes": nbytes({k: v for k, v in engine.cache.items() if k != "len"}),
        "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    if getattr(engine, "adapters", None) is not None:
        doc["slab_bytes"] = nbytes(engine._lora_slab)
        doc["pages_per_adapter"] = engine.pages_per_adapter
    if mesh is not None:
        doc["exchanges"] = {kind: dataclasses.asdict(t) for kind, t in mesh.traffic.items()}
    return doc


def tp_serve_view(cfg, params):
    """(a1)'s config and weights: the first TP_SERVE_LAYERS layers of the
    32-layer ``cfg`` and ``params`` (whole or a rank's shards), as views."""
    return (dataclasses.replace(cfg, n_layers=TP_SERVE_LAYERS),
            {**params, "layers": {k: v[:TP_SERVE_LAYERS] for k, v in params["layers"].items()}})


def tp_paged_setup(cfg, params):
    """(a2)'s config, layers, trace, plan and engine geometry from the 32-layer
    ``cfg`` and ``params`` (whole or a rank's shards): the first
    TP_PAGED_LAYERS layers, copied out so the rest can be freed."""
    cfg16 = dataclasses.replace(cfg, n_layers=TP_PAGED_LAYERS)
    params16 = {**params, "layers": {k: v[:TP_PAGED_LAYERS].clone()
                                     for k, v in params["layers"].items()}}
    trace = paged_trace(cfg16, seed=LORA_TRACE_SEED,
                        adapters=[*LORA_TENANTS, ""])[:TP_PAGED_REQUESTS]
    plan = tp_paged_plan(cfg16)
    return cfg16, params16, trace, plan


def tp_lora_cfg():
    return L.LoraConfig(rank=LORA_RANK, alpha=LORA_ALPHA, targets=LORA_TARGETS)


def tp_rank_main(argv: list[str]) -> int:
    """One rank of phase 20, in a child whose env is the plugin's (a gang's
    for "serve") plus the multi-host bootstrap: cap the process, join the
    gloo world, run ``argv = [job, workdir]``: "serve" on the gang's tp
    mesh from the env, or "train" at ``MeshSpec(fsdp=n)`` and then at
    ``MeshSpec(tp=n)``. Prints one JSON line."""
    job, workdir = argv[0], argv[1]
    configure_torch_from_env()
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = initialize_multihost(backend="gloo", timeout_s=CP_COLLECTIVE_TIMEOUT_S)
    if job == "serve":
        mesh = gang_mesh(backend="gloo")
        doc = tp_serve_rank(mesh, workdir)
    else:
        control = tp_control_grads()
        doc = {}
        for kind in ("fsdp", "tp"):
            mesh = make_mesh(MeshSpec(**{kind: spec.num_processes}), backend="gloo")
            doc[kind] = tp_train_rank(mesh, control)
        del control
    print(json.dumps({"job": job, "rank": mesh.rank, "device": str(mesh.device), **doc}),
          flush=True)
    dist.destroy_process_group()
    return 0


def tp_serve_rank(mesh, workdir: str) -> dict:
    """Phase 20 (a1) and (a2) on one rank of the gang: the rank's shards of
    phase 20's seeded 8B weights (each leaf drawn whole, then cut), served
    by the tp SlotEngine, then by the tp PagedSlotEngine with the parent's
    adapters. The ranks start while the parent prepares its solo engines:
    each says when it holds its shards (a "ready-<rank>" file), and the
    parent runs its timed solo engines only then and writes its "go" file
    (the adapters written by then) after them, so no rank works beside a
    timed solo run."""
    cfg = llama3_8b()
    gen = torch.Generator(device=mesh.device).manual_seed(TP_SEED)
    params = init_params(cfg, gen, device=mesh.device, dtype=torch.bfloat16, mesh=mesh)
    torch.cuda.synchronize()
    open(os.path.join(workdir, f"ready-{mesh.rank}"), "w").close()
    deadline = time.perf_counter() + CP_TIMEOUT_S
    while not os.path.exists(os.path.join(workdir, "go")):
        if time.perf_counter() > deadline:
            raise SystemExit("phase 20: the parent never wrote its go file")
        time.sleep(0.05)
    trace = poisson_trace(vocab=cfg.vocab, **TP_TRACE)
    cfg_a1, params_a1 = tp_serve_view(cfg, params)
    out = {"serve": tp_serve_run(SlotEngine(params_a1, cfg_a1, mesh=mesh, **TP_SERVE_KW), trace,
                                 mesh)}
    gc.collect()
    out["serve_int8"] = tp_serve_run(
        SlotEngine(params_a1, cfg_a1, mesh=mesh, kv_dtype="int8", **TP_SERVE_KW),
        trace[:TP_INT8_REQUESTS], mesh)
    del params_a1
    gc.collect()
    cfg16, params16, ptrace, plan = tp_paged_setup(cfg, params)
    del params
    gc.collect()
    store = torch.load(os.path.join(workdir, "adapters.pt"), weights_only=True)
    engine = PagedSlotEngine(params16, cfg16, mesh=mesh, slots=plan.slots,
                             total_pages=plan.total_pages, lora_store=store,
                             lora_cfg=tp_lora_cfg(), **TP_PAGED_GEO)
    out["paged"] = tp_serve_run(engine, ptrace, mesh)
    return out


def tp_first_batch(cfg) -> torch.Tensor:
    """The global batch ``run_train_loop`` makes for step 0 at TP_SEED."""
    gen = torch.Generator().manual_seed(fold_in(fold_in(TP_SEED, 1), 0))
    return DecoderTask(cfg, batch=TP_TRAIN_B, seq=TP_TRAIN_S).make_batch(gen, 0)


def tp_train_cfg():
    return dataclasses.replace(llama3_8b(), n_layers=TP_TRAIN_LAYERS)


def tp_control_grads() -> list:
    """The 1-rank control's first-step gradients (no mesh), on the card."""
    cfg = tp_train_cfg()
    whole = init_params(cfg, torch.Generator(device="cuda").manual_seed(fold_in(TP_SEED, 0)),
                        device="cuda")
    leaves = [t.requires_grad_() for t in tree_leaves(whole)]
    loss = T.loss_fn(whole, tp_first_batch(cfg).cuda(), cfg)
    control = [g.detach() for g in torch.autograd.grad(loss, leaves)]
    del whole, leaves, loss
    gc.collect()
    return control


def tp_train_rank(mesh, control) -> dict:
    """Phase 20 (b) on one rank of ``mesh``: ``run_train_loop`` for
    TP_TRAIN_STEPS steps on the rank's shards. The first step's gradients,
    each leaf summed over its axes, are held against the 1-rank
    ``control``'s as the optimizer receives them: each rank compares its
    block, and the squared sums are added over the axes a leaf is cut on
    (its first loss is the loop's first)."""
    cfg = tp_train_cfg()
    doc: dict = {"mesh": mesh.shape}
    opt = make_optimizer(clip_norm=TP_CLIP_NORM)
    update = opt.update

    def checked_update(grads, state, params, **kw):
        if "grad_rel_by_leaf" not in doc:
            # per leaf: |g - control|^2, |control|^2 and |g|^2 over this
            # rank's block, summed over the axes the leaf is cut on
            specs = T.leaf_specs(params, mesh, cfg)
            sq = torch.stack([torch.stack([(g.float() - c.float()).square().sum(),
                                           c.float().square().sum(), g.float().square().sum()])
                              for g, c in zip(grads, (shard(c, mesh, sp) for c, sp in
                                                      zip(control, specs)))], 1)
            for axis in mesh.shape:
                on = torch.tensor([axis in shard_axes(sp) for sp in specs], device=sq.device)
                if bool(on.any()):
                    sq = torch.where(on, all_reduce(sq, mesh, axis), sq)
            sq = sq.tolist()
            doc["grad_rel_by_leaf"] = {name: math.sqrt(d / c) for name, d, c in
                                       zip(T._flatten(params), sq[0], sq[1])}
            doc["zero_grads"] = [name for name, n in zip(T._flatten(params), sq[2])
                                 if not (math.isfinite(n) and n > 0)]
        return update(grads, state, params, **kw)

    opt.update = checked_update
    fresh_run()
    mesh.traffic.clear()
    losses, step_s = [], []
    clock = [time.perf_counter()]

    def on_metrics(step, value):
        now = time.perf_counter()
        step_s.append(now - clock[0])
        clock[0] = now
        losses.append(value)

    task = DecoderTask(cfg, batch=TP_TRAIN_B, seq=TP_TRAIN_S, optimizer=opt)
    state, _ = run_train_loop(task, TrainLoopConfig(total_steps=TP_TRAIN_STEPS, log_every=1),
                              TP_SEED, mesh=mesh, on_metrics=on_metrics)
    torch.cuda.synchronize()
    per_run = TP_TRAIN_LAYERS * TP_TRAIN_STEPS
    doc.update(
        first_loss=losses[0], losses=losses, step_s=step_s, step_p50_s=after_first_p50(step_s),
        peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
        launches=dict(fa.LAUNCHES),
        # forward and the recompute of remat "full", then the backward, each
        # on the rank's heads (tp) or its batch row (fsdp): one call a layer
        expected_launches={e: 0 for e in fa.LAUNCHES} | {
            "flash_fwd": 2 * per_run, "flash_bwd_dq": per_run, "flash_bwd_dkv": per_run},
        param_bytes=nbytes(state[0]), adam_bytes=nbytes(state[1]),
        expected_param_bytes=shard_bytes(cfg, mesh.shape, 4),
        exchanges={kind: dataclasses.asdict(t) for kind, t in mesh.traffic.items()},
    )
    return doc


def tp_check_serve(label, cfg, trace, solo, docs, fail, *, solos_for, expect_kv,
                   expect_slab=None, kv_dtype=None) -> dict:
    """Hold every rank of (a1) or (a2) against the solo run: tokens (equal,
    or the near-tie rule against solo decode of ``solos_for(req)``'s
    weights, one tenant's at a time, over a ``kv_dtype`` cache), shape
    guard, flash launches, and the bytes a rank holds. Returns the report's
    row."""
    by_rid = {r.rid: r for r in trace}
    row = {"solo": {k: v for k, v in solo.items() if k != "tokens"}, "ranks": []}
    held = []  # (adapter, rid, rank, tokens) to hold against solo decode
    want_w = shard_bytes(cfg, {"tp": TP_RANKS}, 2)
    for doc in docs:
        run = doc[label]
        tag = f"({label}) rank {doc['rank']}"
        tokens = {int(k): v for k, v in run.pop("tokens").items()}
        if set(tokens) != set(solo["tokens"]):
            fail.append(f"{tag}: served {sorted(tokens)}")
            continue
        run["equal_to_solo"] = sum(got == solo["tokens"][rid] for rid, got in tokens.items())
        held += [(by_rid[rid].adapter_id, rid, doc["rank"], got)
                 for rid, got in tokens.items() if got != solo["tokens"][rid]]
        if run["shape_guard"] != {"prefill": 1, "extend": 1, "decode": 1}:
            fail.append(f"{tag}: shape guard {run['shape_guard']}")
        if run["launches"]["flash_fwd"] != solo["launches"]["flash_fwd"] or \
                run["launches"]["flash_fwd_scalar"]:
            fail.append(f"{tag}: launches {run['launches']} vs solo {solo['launches']}")
        if run["weight_bytes"] != want_w or 2 * run["kv_bytes"] != solo["kv_bytes"] or \
                run["kv_bytes"] != expect_kv:
            fail.append(f"{tag}: weights {run['weight_bytes']} (want {want_w}), kv "
                        f"{run['kv_bytes']} (solo {solo['kv_bytes']}, want {expect_kv})")
        if expect_slab is not None and run["slab_bytes"] != expect_slab:
            fail.append(f"{tag}: slab {run['slab_bytes']} != the plan's {expect_slab}")
        run["weight_share_of_solo"] = run["weight_bytes"] / solo["weight_bytes"]
        row["ranks"].append(run)
    diverged, solos = [], {}
    for aid, rid, rank, got in sorted(held, key=lambda h: (h[0], h[1], h[2])):
        weights, gap_rel = solos_for(by_rid[rid])
        diverged += [dict(d, rank=rank) for d in check_vs_solo(
            f"phase 20 ({label})", weights, cfg, by_rid[rid], got,
            solos=solos.setdefault(aid, {}), gap_rel=gap_rel, kv_dtype=kv_dtype)]
    row["diverged_at_near_ties"] = diverged
    print(f"   {label}", json.dumps(row), flush=True)
    return row


def tp_control_run() -> dict:
    """Phase 20 (b)'s 1-rank control: ``run_train_loop`` here, no mesh."""
    fresh_run()
    losses, step_s = [], []
    clock = [time.perf_counter()]

    def on_metrics(step, value):
        now = time.perf_counter()
        step_s.append(now - clock[0])
        clock[0] = now
        losses.append(value)

    task = DecoderTask(tp_train_cfg(), batch=TP_TRAIN_B, seq=TP_TRAIN_S,
                       optimizer=make_optimizer(clip_norm=TP_CLIP_NORM))
    state, _ = run_train_loop(task, TrainLoopConfig(total_steps=TP_TRAIN_STEPS, log_every=1),
                              TP_SEED, on_metrics=on_metrics)
    torch.cuda.synchronize()
    control = {"losses": losses, "step_s": step_s, "step_p50_s": after_first_p50(step_s),
               "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
               "param_bytes": nbytes(state[0]), "adam_bytes": nbytes(state[1]),
               "launches": dict(fa.LAUNCHES)}
    print("   control", json.dumps(control), flush=True)
    return control


def tp_check_train(docs, control, fail) -> tuple[dict, dict]:
    """Hold (b)'s ranks against the control; returns their launches (both
    meshes, both ranks) and the report's rows."""
    losses = control["losses"]
    launches, rows = {e: 0 for e in fa.LAUNCHES}, {}
    for kind in ("fsdp", "tp"):
        rows[kind] = [dict(d[kind], rank=d["rank"]) for d in docs]
        for doc in rows[kind]:
            for e in fa.LAUNCHES:
                launches[e] += doc["launches"][e]
            doc["state_share_of_control"] = ((doc["param_bytes"] + doc["adam_bytes"])
                                             / (control["param_bytes"] + control["adam_bytes"]))
            print(f"   {kind}", json.dumps(doc), flush=True)
            tag = f"(b) {kind}=2 rank {doc['rank']}"
            if abs(doc["first_loss"] - losses[0]) > GRAD_LOSS_REL * abs(losses[0]):
                fail.append(f"{tag}: first loss {doc['first_loss']} vs control {losses[0]}")
            if not falling(doc["losses"]):
                fail.append(f"{tag}: losses {doc['losses']}")
            if doc["launches"] != doc["expected_launches"]:
                fail.append(f"{tag}: launches {doc['launches']} != {doc['expected_launches']}")
            if doc["param_bytes"] != doc["expected_param_bytes"] or \
                    doc["adam_bytes"] != 2 * doc["param_bytes"] + 8:
                fail.append(f"{tag}: params {doc['param_bytes']} (want "
                            f"{doc['expected_param_bytes']}), AdamW {doc['adam_bytes']}")
            bad = {nm: e for nm, e in doc.get("grad_rel_by_leaf", {}).items()
                   if not e <= GRAD_LEAF_REL}
            if bad or doc["zero_grads"]:
                fail.append(f"{tag}: gradients {bad}, zero {doc['zero_grads']}")
    return launches, rows


def phase_tensor_parallel(gen) -> tuple[dict, dict, dict, dict, dict, dict]:
    """Phase 20; returns the kernel launches of (a1), (a2), (b) and (a1)'s
    int8 KV run (each summed over its ranks, (b) over both meshes), the
    kernel rows at a tp=2 training rank's shape, and a report. Order: the kernels; (b)'s control
    (its 34 GB peak alone on the card); the solo engines; the serving
    ranks; then (b)'s ranks, which run while this process holds the
    serving ranks' tokens to solo decode."""
    print(f"phase 20: tensor parallelism and FSDP, {TP_RANKS} gloo ranks on one card",
          flush=True)
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    rows = cp_kernel_rows(gen, TP_KERNEL_SHAPES, "phase 20")
    report: dict = {}
    fail: list[str] = []
    t0 = time.perf_counter()
    control = tp_control_run()
    per_run = TP_TRAIN_LAYERS * TP_TRAIN_STEPS
    want = {e: 0 for e in fa.LAUNCHES} | {"flash_fwd": 2 * per_run,
                                          "flash_bwd_dq": per_run, "flash_bwd_dkv": per_run}
    if control["launches"] != want:
        fail.append(f"(b) control launches {control['launches']} != {want}")
    if not falling(control["losses"]):
        fail.append(f"(b) control losses {control['losses']}")
    report["control"] = control
    gc.collect()
    torch.cuda.empty_cache()
    report["control_s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as workdir:
        # (a1) and (a2): the gang's two ranks start and draw their shards
        # while this process prepares the solo engines, which run once the
        # ranks are ready; the ranks serve on the "go" file after them.
        t0 = time.perf_counter()
        serving = start_ranks("serve", TP_RANKS, TP_SERVE_UNITS, workdir, entry="tp_rank_main",
                              gang=True)
        try:
            cfg = llama3_8b()
            params = init_params(cfg, torch.Generator(device="cuda").manual_seed(TP_SEED),
                                 device="cuda", dtype=torch.bfloat16)
            trace = poisson_trace(vocab=cfg.vocab, **TP_TRACE)
            cfg16, params16, ptrace, plan = tp_paged_setup(cfg, params)
            lcfg = tp_lora_cfg()
            store, _ = lora_store_for(params16, cfg16, lcfg)
            torch.save(store, os.path.join(workdir, "adapters.pt"))
            wait_ready(serving, workdir, "phase 20")
            cfg_a1, params_a1 = tp_serve_view(cfg, params)
            solo_a1 = tp_serve_run(SlotEngine(params_a1, cfg_a1, **TP_SERVE_KW), trace)
            gc.collect()
            solo_int8 = tp_serve_run(SlotEngine(params_a1, cfg_a1, kv_dtype="int8",
                                                **TP_SERVE_KW), trace[:TP_INT8_REQUESTS])
            gc.collect()
            solo_a2 = tp_serve_run(
                PagedSlotEngine(params16, cfg16, slots=plan.slots, total_pages=plan.total_pages,
                                lora_store=store, lora_cfg=lcfg, **TP_PAGED_GEO), ptrace)
            gc.collect()
            torch.cuda.empty_cache()
        except BaseException:
            collect_ranks(serving, "phase 20", kill=True)
            raise
        report["solo_s"] = time.perf_counter() - t0
        open(os.path.join(workdir, "go"), "w").close()
        docs = collect_ranks(serving, "phase 20")
        report["ranks_serve_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        training = start_ranks("train", TP_RANKS, TP_TRAIN_UNITS, workdir, entry="tp_rank_main")
        try:
            launches_serve = {e: sum(d["serve"]["launches"][e] for d in docs)
                              for e in fa.LAUNCHES}
            launches_paged = {e: sum(d["paged"]["launches"][e] for d in docs)
                              for e in fa.LAUNCHES}
            launches_int8 = {e: sum(d["serve_int8"]["launches"][e] for d in docs)
                             for e in fa.LAUNCHES}
            report["serve"] = tp_check_serve(
                "serve", cfg_a1, trace, solo_a1, docs, fail,
                solos_for=lambda req: (params_a1, TOP2_GAP_REL),
                expect_kv=solo_a1["kv_bytes"] // TP_RANKS)
            report["serve_int8"] = tp_check_serve(
                "serve_int8", cfg_a1, trace[:TP_INT8_REQUESTS], solo_int8, docs, fail,
                solos_for=lambda req: (params_a1, TOP2_GAP_REL), kv_dtype="int8",
                expect_kv=TP_SERVE_KW["slots"] * kv_slot_bytes(
                    cfg_a1, TP_SERVE_KW["max_len"], "int8") // TP_RANKS)
            merged = {}

            def merged_for(req):
                aid = req.adapter_id
                if aid not in merged:
                    merged.clear()
                    gc.collect()
                    adapter = {n: {k: v.cuda() for k, v in ab.items()} for n, ab in
                               store[aid].items()} if aid else None
                    merged[aid] = L.merge_lora(params16, adapter, lcfg) if aid else params16
                return merged[aid], LORA_TOP2_GAP_REL

            report["paged"] = tp_check_serve(
                "paged", cfg16, ptrace, solo_a2, sorted(docs, key=lambda d: d["rank"]), fail,
                solos_for=merged_for, expect_kv=plan.kv_bytes, expect_slab=plan.adapter_bytes)
            report["paged"]["plan"] = dataclasses.asdict(plan)
            report["serve_checks_s"] = time.perf_counter() - t0
            del params, params_a1, params16, store, merged
            gc.collect()
            torch.cuda.empty_cache()
        except BaseException:
            collect_ranks(training, "phase 20", kill=True)
            raise
        docs = collect_ranks(training, "phase 20")
        report["ranks_train_s"] = time.perf_counter() - t0
        launches_train, train_rows = tp_check_train(docs, control, fail)
        report.update(train_rows)
    report["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 20: {report['seconds']:.1f} s (control {report['control_s']:.1f}, solo "
          f"{report['solo_s']:.1f}, serving ranks from their start {report['ranks_serve_s']:.1f}, "
          "training "
          f"ranks {report['ranks_train_s']:.1f}, of which the serving checks "
          f"{report['serve_checks_s']:.1f})", flush=True)
    if fail:
        raise SystemExit("phase 20 failed: " + "; ".join(fail))
    return launches_serve, launches_paged, launches_train, launches_int8, rows, report


def shard_task(model: str, optimizer=None):
    """Phase 26's task for ``model`` ("bert" or "resnet"), trained by
    ``optimizer`` (:func:`shard_optimizer` unless given)."""
    optimizer = optimizer or shard_optimizer(model)
    if model == "bert":
        return BertTask(B.bert_base(), batch=SHARD_BERT_B, seq=SHARD_BERT_S, optimizer=optimizer)
    return ResNetTask(R.resnet50(), batch=SHARD_RESNET_B, image_size=RESNET_SIZE,
                      optimizer=optimizer)


def shard_steps(model: str) -> int:
    return SHARD_BERT_STEPS if model == "bert" else SHARD_RESNET_STEPS


def shard_optimizer(model: str):
    return B.make_optimizer() if model == "bert" else R.make_optimizer(SHARD_RESNET_LR)


def shard_first_step(model: str, dtype: torch.dtype, mesh=None) -> dict:
    """The first step of ``model``'s phase 26 run at compute ``dtype``,
    without the optimizer: its loss, every leaf's gradient by name (on a
    ``mesh``, this rank's shards, summed over ``grad_sum_axes`` as the step
    sums them) and ResNet's new BN state. The 1-rank control without a
    mesh."""
    M = B if model == "bert" else R
    task = shard_task(model)
    cfg = dataclasses.replace(task.cfg, compute_dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(fold_in(SHARD_SEED, 0))
    params = M.init_params(cfg, gen, mesh=mesh)
    params, bn = (params, None) if model == "bert" else params
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    batch = task.make_batch(torch.Generator().manual_seed(fold_in(fold_in(SHARD_SEED, 1), 0)), 0)
    batch = tuple(t.cuda() for t in batch)
    out = {}
    if model == "bert":
        loss = B.loss_fn(params, *batch, cfg, mesh)
    else:
        loss, new_bn = R.loss_fn(params, bn, *batch, cfg, mesh)
        out["bn"] = {n: t.detach() for n, t in T._flatten(new_bn).items()}
    grads = list(torch.autograd.grad(loss, leaves, materialize_grads=True))
    if mesh is not None:
        for g, axes in zip(grads, M.grad_sum_axes(params, mesh, cfg)):
            all_reduce_sum_([g], mesh, axes)
        out["specs"] = dict(zip(T._flatten(params), M.leaf_specs(params, mesh, cfg)))
    out.update(loss=float(loss.detach()),
               grads=dict(zip(T._flatten(params), (g.detach() for g in grads))))
    del params, leaves, loss
    gc.collect()
    return out


def rel_by_leaf(mesh, got: dict, want: dict, specs: dict) -> tuple[dict, list]:
    """Per leaf, the relative Frobenius error of this rank's blocks
    ``got`` against the matching blocks of the whole ``want``, the squared
    sums added over the axes each leaf is cut on; and the leaves whose
    gradient is zero or not finite."""
    names = list(got)
    sq = torch.stack([torch.stack([(got[n].float() - c.float()).square().sum(),
                                   c.float().square().sum(), got[n].float().square().sum()])
                      for n, c in ((n, shard(want[n], mesh, specs[n])) for n in names)], 1)
    for axis in mesh.shape:
        on = torch.tensor([axis in shard_axes(specs[n]) for n in names], device=sq.device)
        if bool(on.any()):
            sq = torch.where(on, all_reduce(sq, mesh, axis), sq)
    sq = sq.tolist()
    rel = {n: math.sqrt(d / c) if c > 0 else (0.0 if d == 0 else math.inf)
           for n, d, c in zip(names, sq[0], sq[1])}
    zero = [n for n, g in zip(names, sq[2]) if not (math.isfinite(g) and g > 0)]
    return rel, zero


def _no_seg(model: str, grads: dict) -> dict:
    """BERT's ``seg_embed`` is unused without segments: zero in every run."""
    return {n: g for n, g in grads.items() if not (model == "bert" and n == "seg_embed")}


def shard_train_rank(mesh, model: str, controls: dict) -> dict:
    """Phase 26 on one rank of ``mesh``. First the gradient check in f32
    (in bf16, rounding that a rank's other batch size moves through other
    GEMM and convolution algorithms grows through the network to more
    than 2^-5 of a leaf; f32 leaves the check its bugs to find): the first
    step's loss, every leaf's summed gradient and ResNet's new BN state on
    the rank's shards against the f32 control's. Then ``run_train_loop``
    of ``model``'s task in bf16 on the rank's shards, whose first-step
    gradients (as the optimizer receives them) are held against the bf16
    control's for being nonzero, with their error printed, and whose BN
    state after step 1 is held against the bf16 control's."""
    M = B if model == "bert" else R
    check = shard_first_step(model, torch.float32, mesh)
    ref = controls[torch.float32]
    rel, zero = rel_by_leaf(mesh, _no_seg(model, check["grads"]), ref["grads"], check["specs"])
    doc: dict = {"mesh": mesh.shape, "f32_first_loss": check["loss"],
                 "f32_control_loss": ref["loss"], "f32_grad_rel_by_leaf": rel,
                 "f32_zero_grads": zero}
    if model == "resnet":
        doc["f32_bn_rel_by_leaf"] = {n: float((check["bn"][n] - c).norm() / c.norm())
                                     for n, c in ref["bn"].items()}
    del check
    gc.collect()
    opt = shard_optimizer(model)
    update = opt.update

    def checked_update(grads, state, params, **kw):
        if "grad_rel_by_leaf" not in doc:
            names = list(T._flatten(params))
            specs = dict(zip(names, M.leaf_specs(params, mesh, task.cfg)))
            doc["grad_rel_by_leaf"], doc["zero_grads"] = rel_by_leaf(
                mesh, _no_seg(model, dict(zip(names, grads))), controls[torch.bfloat16]["grads"],
                specs)
        return update(grads, state, params, **kw)

    opt.update = checked_update
    task = shard_task(model, opt)
    make_step = task.make_step

    def make_checked_step(mesh=None):
        step = make_step(mesh)

        def fn(state, batch):
            state, loss = step(state, batch)
            if model == "resnet" and "bn_rel_by_leaf" not in doc:
                bn = T._flatten(state[1])
                doc["bn_rel_by_leaf"] = {n: float((bn[n] - c).norm() / c.norm())
                                         for n, c in controls[torch.bfloat16]["bn"].items()}
            return state, loss

        return fn

    task.make_step = make_checked_step
    fresh_run()
    mesh.traffic.clear()
    losses, step_s = [], []
    clock = [time.perf_counter()]

    def on_metrics(step, value):
        now = time.perf_counter()
        step_s.append(now - clock[0])
        clock[0] = now
        losses.append(value)

    steps = shard_steps(model)
    state, _ = run_train_loop(task, TrainLoopConfig(total_steps=steps, log_every=1), SHARD_SEED,
                              mesh=mesh, on_metrics=on_metrics)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    specs = M.leaf_specs(state[0], mesh, task.cfg)
    shapes = T._flatten(M.param_shapes(task.cfg) if model == "bert"
                        else M.param_shapes(task.cfg)[0])
    want_bytes = sum(int(np.prod(T.local_shape(shapes[n], sp, mesh))) * 4
                     for n, sp in zip(T._flatten(state[0]), specs))
    expected = {e: 0 for e in fa.LAUNCHES}
    if model == "bert":  # forward and remat's recompute, then the backward: one call a layer
        per_run = task.cfg.n_layers * steps
        expected |= {"flash_fwd": 2 * per_run, "flash_bwd_dq": per_run, "flash_bwd_dkv": per_run}
    doc.update(
        first_loss=losses[0], losses=losses, step_s=step_s, step_p50_s=after_first_p50(step_s),
        peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
        launches=launches, expected_launches=expected,
        param_bytes=nbytes(state[0]), expected_param_bytes=want_bytes,
        exchanges={kind: dataclasses.asdict(t) for kind, t in mesh.traffic.items()},
    )
    del state
    gc.collect()
    return doc


def shard_rank_main(argv: list[str]) -> int:
    """One rank of phase 26, in a child whose env is the plugin's plus the
    multi-host bootstrap: cap the process, join the gloo world, and for
    each model compute the control's first step in f32 and in bf16, then
    check and train on each of its meshes. Prints one JSON line."""
    configure_torch_from_env()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = initialize_multihost(backend="gloo", timeout_s=CP_COLLECTIVE_TIMEOUT_S)
    doc = {}
    for model, kinds in SHARD_MESHES.items():
        controls = {dt: shard_first_step(model, dt) for dt in (torch.float32, torch.bfloat16)}
        for kind in kinds:
            mesh = make_mesh(MeshSpec(**{kind: spec.num_processes}), backend="gloo")
            doc[f"{model}_{kind}"] = shard_train_rank(mesh, model, controls)
        del controls
        gc.collect()
    print(json.dumps({"job": argv[0], "rank": mesh.rank, "device": str(mesh.device), **doc}),
          flush=True)
    dist.destroy_process_group()
    return 0


def shard_control_run(model: str) -> dict:
    """Phase 26's 1-rank control for ``model``: ``run_train_loop`` here, no
    mesh."""
    fresh_run()
    losses, step_s = [], []
    clock = [time.perf_counter()]

    def on_metrics(step, value):
        now = time.perf_counter()
        step_s.append(now - clock[0])
        clock[0] = now
        losses.append(value)

    state, _ = run_train_loop(shard_task(model), TrainLoopConfig(total_steps=shard_steps(model),
                                                                 log_every=1),
                              SHARD_SEED, on_metrics=on_metrics)
    torch.cuda.synchronize()
    control = {"losses": losses, "step_s": step_s, "step_p50_s": after_first_p50(step_s),
               "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
               "param_bytes": nbytes(state[0]), "launches": dict(fa.LAUNCHES)}
    print(f"   {model} control", json.dumps(control), flush=True)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return control


def phase_sharded_training(gen) -> tuple[dict, dict, dict, dict]:
    """Phase 26; returns the kernel launches of the BERT runs at fsdp=2 and
    at tp=2 (each summed over both ranks), the kernel rows at a rank's
    BERT shapes, and a report."""
    print(f"phase 26: BERT-base and ResNet-50 sharded training, {SHARD_RANKS} gloo ranks on "
          "one card", flush=True)
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    rows = cp_kernel_rows(gen, SHARD_KERNEL_SHAPES, "phase 26")
    report: dict = {}
    fail: list[str] = []
    t0 = time.perf_counter()
    controls = {model: shard_control_run(model) for model in SHARD_MESHES}
    report["controls_s"] = time.perf_counter() - t0
    per_run = B.bert_base().n_layers * SHARD_BERT_STEPS
    want = {e: 0 for e in fa.LAUNCHES} | {"flash_fwd": 2 * per_run, "flash_bwd_dq": per_run,
                                          "flash_bwd_dkv": per_run}
    if controls["bert"]["launches"] != want:
        fail.append(f"bert control launches {controls['bert']['launches']} != {want}")
    for model, control in controls.items():
        if not falling(control["losses"]):
            fail.append(f"{model} control losses {control['losses']}")
    report["controls"] = controls
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        docs = run_ranks("shard", SHARD_RANKS, SHARD_UNITS, workdir, entry="shard_rank_main",
                         phase="phase 26")
    report["ranks_s"] = time.perf_counter() - t0
    launches = {}
    for model, kinds in SHARD_MESHES.items():
        first = controls[model]["losses"][0]
        for kind in kinds:
            key = f"{model}_{kind}"
            launches[key] = {e: sum(d[key]["launches"][e] for d in docs) for e in fa.LAUNCHES}
            rows_k = []
            for d in docs:
                run = dict(d[key], rank=d["rank"])
                tag = f"{model} {kind}={SHARD_RANKS} rank {d['rank']}"
                rel = run.pop("f32_grad_rel_by_leaf")
                bf16_rel = run.pop("grad_rel_by_leaf", {})
                bn_rels = {k: run.pop(k, {}) for k in ("f32_bn_rel_by_leaf", "bn_rel_by_leaf")}
                run["f32_grad_rel_max"] = max(rel.values(), default=None)
                run["f32_grad_rel_top"] = dict(sorted(rel.items(), key=lambda kv: -kv[1])[:3])
                run["bf16_grad_rel_max"] = max(bf16_rel.values(), default=None)
                run["bf16_grad_rel_by_leaf"] = {n: round(e, 4) for n, e in bf16_rel.items()}
                for k, v in bn_rels.items():
                    run[k.replace("_by_leaf", "_max")] = max(v.values(), default=None)
                print(f"   {key}", json.dumps(run), flush=True)
                rows_k.append(run)
                if abs(run["first_loss"] - first) > GRAD_LOSS_REL * abs(first):
                    fail.append(f"{tag}: first loss {run['first_loss']} vs control {first}")
                f32_first = run["f32_control_loss"]
                if abs(run["f32_first_loss"] - f32_first) > GRAD_LOSS_REL * abs(f32_first):
                    fail.append(f"{tag}: f32 first loss {run['f32_first_loss']} vs {f32_first}")
                if not falling(run["losses"]):
                    fail.append(f"{tag}: losses {run['losses']}")
                if run["launches"] != run["expected_launches"]:
                    fail.append(f"{tag}: launches {run['launches']} != {run['expected_launches']}")
                if run["param_bytes"] != run["expected_param_bytes"]:
                    fail.append(f"{tag}: params {run['param_bytes']} bytes, its shards "
                                f"{run['expected_param_bytes']}")
                bad = {n: e for n, e in rel.items() if not e <= GRAD_LEAF_REL}
                if not rel or bad or run["f32_zero_grads"]:
                    fail.append(f"{tag}: f32 gradients {bad}, zero {run['f32_zero_grads']}")
                if not bf16_rel or run["zero_grads"]:
                    fail.append(f"{tag}: bf16 step's zero gradients {run['zero_grads']}")
                for k, v in bn_rels.items():
                    bad_bn = {n: e for n, e in v.items() if not e <= GRAD_LEAF_REL}
                    if model == "resnet" and (not v or bad_bn):
                        fail.append(f"{tag}: BN running statistics after step 1 ({k}) {bad_bn}")
            report[key] = rows_k
    report["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 26: {report['seconds']:.1f} s (controls {report['controls_s']:.1f}, ranks "
          f"{report['ranks_s']:.1f})", flush=True)
    if fail:
        raise SystemExit("phase 26 failed: " + "; ".join(fail))
    return launches["bert_fsdp"], launches["bert_tp"], rows, report


def pod_main(argv: list[str]) -> int:
    """One pod, in a child process whose env is the plugin's: cap the
    process from the env first, then train ``argv = [workload, batch,
    steps]``. Prints one JSON line; a pod that runs out of its slice
    prints the OOM marker and exits 3."""
    workload, batch, steps = argv[0], int(argv[1]), int(argv[2])
    settings = configure_torch_from_env()
    pod = PodTpuEnv.from_env()
    fraction = float(settings[MEMORY_FRACTION])
    doc = {"workload": workload, "slice_gib": pod.mem_units_container, "fraction": fraction,
           "cap_bytes": int(fraction * torch.cuda.get_device_properties(0).total_memory),
           "visible": os.environ.get(const.ENV_CUDA_VISIBLE_DEVICES)}
    try:
        if workload == "lora":
            doc.update(train_lora_pod(batch, steps))
            print(json.dumps(doc), flush=True)
            return 0
        # One untimed step sets up the libraries and loads the kernels; then
        # wait for the parent's go, so the pods' timed steps run together.
        train_pod(workload, batch, 1)
        print(READY, flush=True)
        sys.stdin.readline()
        doc["window_s"] = [time.time()]
        report, _, _ = train_pod(workload, batch, steps)
        doc["window_s"].append(time.time())
    except torch.cuda.OutOfMemoryError as e:
        doc.update(oom=OOM_MARK, error=str(e).splitlines()[0][:300],
                   peak_reserved_bytes=torch.cuda.max_memory_reserved())
        print(json.dumps(doc), flush=True)
        return 3
    doc.update(report)
    print(json.dumps(doc), flush=True)
    return 0


def start_pod(name, workload, units, batch, steps, grant=None):
    """Start one pod child with only the plugin's env for its slice on top
    of the parent's (no CUDA_VISIBLE_DEVICES): ``grant``, the env the
    port's allocator granted it, or :func:`plugin_env`'s."""
    env = {k: v for k, v in os.environ.items() if k != const.ENV_CUDA_VISIBLE_DEVICES}
    env.update(plugin_env(units) if grant is None else grant)
    code = "import sys, chip_smoke; sys.exit(chip_smoke.pod_main(sys.argv[1:]))"
    proc = subprocess.Popen(
        [sys.executable, "-c", code, workload, str(batch), str(steps)],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    return name, units, proc


def finish_pods(started) -> dict:
    """Let the pods train together once each has capped itself and is
    ready, then wait for every one (a watchdog kills all of them past
    POD_TIMEOUT_S); returns each pod's (exit code, JSON document or None,
    stderr tail) by name."""
    watchdog = threading.Timer(POD_TIMEOUT_S, lambda: [p.kill() for _, _, p in started])
    watchdog.start()
    early = {}
    try:
        for name, _, proc in started:  # a pod that dies first ends its stdout: no hang
            early[name] = []
            while (line := proc.stdout.readline()) and line.strip() != READY:
                early[name].append(line)
        for _, _, proc in started:
            try:
                proc.stdin.write("go\n")
                proc.stdin.flush()
            except BrokenPipeError:
                pass  # it died before the barrier; its exit code tells
        out = {}
        for name, _, proc in started:
            stdout, stderr = proc.communicate()
            lines = early[name] + stdout.splitlines()
            docs = [line for line in lines if line.startswith("{")]
            out[name] = (proc.returncode, json.loads(docs[-1]) if docs else None, stderr[-2000:])
        return out
    finally:
        watchdog.cancel()


def phase_binpack(alone: dict, grants: dict) -> None:
    """Phase 11; ``alone`` holds phases 9 and 10's reports by workload,
    ``grants`` the env phase 21's allocator granted each pod."""
    print("phase 11: six pods binpacked on one card through the pod env", flush=True)
    fresh_run()
    batches = {"mnist": 256, "bert": BERT_B, "resnet": RESNET_B}
    for name, workload, units, _ in PODS:
        if workload in alone and alone[workload]["peak_reserved_bytes"] > SLICE_FULL * units * 2**30:
            batches[workload] //= 2
            print(f"  {workload} alone peaked at {alone[workload]['peak_reserved_gb']:.3f} GB, "
                  f"above {SLICE_FULL} of its {units} GiB slice: its pod trains at batch "
                  f"{batches[workload]}", flush=True)
    t0 = time.perf_counter()
    started = [start_pod(name, workload, units, batches[workload], steps, grants[name])
               for name, workload, units, steps in PODS]
    results = finish_pods(started)
    wall = time.perf_counter() - t0
    go = min((doc["window_s"][0] for _, doc, _ in results.values() if doc and "window_s" in doc),
             default=0.0)
    fail = []
    for name, workload, units, _ in PODS:
        rc, doc, err = results[name]
        if rc != 0 or doc is None:
            fail.append(f"{name} exited {rc}: {err}")
            continue
        row = {
            "pod": name, "slice_gib": units, "batch": doc["batch"],
            "cap_gb": doc["cap_bytes"] / 1e9, "peak_reserved_gb": doc["peak_reserved_gb"],
            "first_loss": doc["losses"][0], "last_loss": doc["losses"][-1],
            "steps": len(doc["losses"]), "step_p50_s": doc["step_p50_s"],
            "alone_step_p50_s": alone[workload]["step_p50_s"] if workload in alone else None,
            "window_s": [t - go for t in doc["window_s"]],  # timed steps, from the first go
        }
        print("  ", json.dumps(row), flush=True)
        if not falling(doc["losses"]):
            fail.append(f"{name}: losses do not fall ({doc['losses'][0]} -> {doc['losses'][-1]})")
        if doc["peak_reserved_bytes"] > doc["cap_bytes"]:
            fail.append(f"{name}: peak reserved {doc['peak_reserved_bytes']} > cap "
                        f"{doc['cap_bytes']}")
    print(f"  phase 11: {wall:.1f} s", flush=True)
    if fail:
        raise SystemExit("phase 11 failed: " + "; ".join(fail))


def phase_lora_train() -> dict:
    """Phase 14; returns the pod's kernel launches over its run."""
    print(f"phase 14: LoRA fine-tune llama3_8b at full depth in a {LORA_TRAIN_UNITS} GiB pod, "
          f"B={LORA_TRAIN_B} S={LORA_TRAIN_S}, {LORA_TRAIN_STEPS} steps", flush=True)
    fresh_run()
    batch = LORA_TRAIN_B
    rc, doc, err = finish_pods([start_pod("lora", "lora", LORA_TRAIN_UNITS, batch,
                                          LORA_TRAIN_STEPS)])["lora"]
    if rc == 3 and doc is not None and doc.get("oom") == OOM_MARK:
        batch //= 2  # past its slice: half the batch, as phase 11 does
        print(f"  the pod ran out of its slice at B={LORA_TRAIN_B} ({doc['error']}): "
              f"training at B={batch}", flush=True)
        rc, doc, err = finish_pods([start_pod("lora", "lora", LORA_TRAIN_UNITS, batch,
                                              LORA_TRAIN_STEPS)])["lora"]
    if rc != 0 or doc is None:
        raise SystemExit(f"phase 14 failed: the pod exited {rc}: {err or (doc or {}).get('error')}")
    print("  lora pod", json.dumps({k: v for k, v in doc.items() if k != "peak_reserved_bytes"}),
          flush=True)
    per_run = llama3_8b().n_layers * LORA_TRAIN_STEPS
    want = {name: 0 for name in fa.LAUNCHES}
    want.update(flash_fwd=2 * per_run, flash_bwd_dq=per_run, flash_bwd_dkv=per_run)
    fail = []
    if not falling(doc["losses"]):
        fail.append(f"losses {doc['losses']}")
    if not doc["base_unchanged"]:
        fail.append("the frozen base changed")
    if not all(v > 0 for v in doc["b_abs_sum"].values()):
        fail.append(f"b did not move: {doc['b_abs_sum']}")
    if doc["launches"] != want:
        fail.append(f"launches {doc['launches']} != {want}")
    if doc["peak_reserved_bytes"] > doc["cap_bytes"]:
        fail.append(f"peak reserved {doc['peak_reserved_bytes']} > cap {doc['cap_bytes']}")
    if fail:
        raise SystemExit("phase 14 failed: " + "; ".join(fail))

    # flash against plain: one lora_loss_fn backward at full width, 4 layers
    cfg = dataclasses.replace(llama3_8b(), n_layers=TRAIN_LAYERS)
    lcfg = L.LoraConfig()
    gen = torch.Generator(device="cuda").manual_seed(15)
    params = init_params(cfg, gen, device="cuda", dtype=torch.bfloat16)
    lora = L.init_lora(cfg, lcfg, gen, device="cuda")
    for ab in lora.values():  # b off zero, so a's gradient is not zero
        ab["b"].normal_(0.0, 0.01, generator=gen)
    leaves = [t.requires_grad_() for t in tree_leaves(lora)]
    names = list(T._flatten(lora))
    tokens = T.demo_batch(torch.Generator().manual_seed(15), 1, TRAIN_S, cfg.vocab).cuda()
    loss, grads = {}, {}
    for attention in ("flash", "plain"):
        out = L.lora_loss_fn(lora, params, tokens, dataclasses.replace(cfg, attention=attention),
                             lcfg)
        grads[attention] = torch.autograd.grad(out, leaves)
        loss[attention] = float(out.detach())
    rel = {n: float((f - p).float().norm() / p.float().norm())
           for n, f, p in zip(names, grads["flash"], grads["plain"])}
    zero = [n for n, g in zip(names, grads["flash"]) if not (torch.isfinite(g).all() and g.any())]
    print("  flash vs plain lora_loss_fn, 4 layers, B=1: losses", json.dumps(loss),
          "relative Frobenius error by adapter leaf", json.dumps(rel),
          "zero or non-finite flash gradients", zero, flush=True)
    if zero:
        raise SystemExit(f"phase 14 failed: no gradient reached {zero}")
    if abs(loss["flash"] - loss["plain"]) > GRAD_LOSS_REL * abs(loss["plain"]):
        raise SystemExit(f"phase 14 failed: flash vs plain losses {loss}")
    bad = {n: r for n, r in rel.items() if not r <= GRAD_LEAF_REL}
    if bad:
        raise SystemExit(f"phase 14 failed: flash vs plain gradients differ: {bad}")
    return doc["launches"]


def phase_overrun(bert_peak_bytes: int) -> None:
    """Phase 12: BERT-base at half its phase-9 peak OOMs itself; an MNIST
    control at the same slice passes."""
    units = int(bert_peak_bytes / 2 / 2**30)
    print(f"phase 12: bert_base in a {units} GiB slice (half its peak alone) must OOM itself",
          flush=True)
    results = finish_pods([start_pod("bert-overrun", "bert", units, BERT_B, BERT_STEPS),
                           start_pod("mnist-control", "mnist", units, 256, 100)])
    rc, doc, err = results["bert-overrun"]
    print("   bert-overrun", rc, json.dumps(doc), flush=True)
    if rc != 3 or doc is None or doc.get("oom") != OOM_MARK:
        raise SystemExit(f"phase 12 failed: the overrunning pod did not OOM itself "
                         f"(exit {rc}): {err}")
    rc, doc, err = results["mnist-control"]
    summary = doc and {k: doc[k] for k in ("slice_gib", "cap_bytes", "peak_reserved_bytes",
                                           "step_p50_s")}
    print("   mnist-control", rc, json.dumps(summary), flush=True)
    if rc != 0 or doc is None or not falling(doc["losses"]):
        raise SystemExit(f"phase 12 failed: the control pod failed (exit {rc}): {err}")


def nvidia_smi_uuids() -> list[str]:
    """The cards' UUIDs, as ``nvidia-smi`` lists them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=uuid", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def phase_plugin() -> tuple[dict, dict]:
    """Phase 21: the device plugin's path on the card, from discovery to the
    env a pod is granted. Returns phase 11's grants (each pod's env, by
    name) and the report."""
    print("phase 21: the device plugin's path (NVML and CUDA discovery, fan-out, allocate)",
          flush=True)
    t_phase = time.perf_counter()
    fail = []
    report = {}

    # (a) discovery: NVML in a child that never imports torch, then NVML,
    # CUDA and auto here
    smi = nvidia_smi_uuids()
    child = subprocess.run(
        [sys.executable, "-c", NVML_CHILD, str(PLUGIN_POLLS), str(PLUGIN_POLL_INTERVAL_S)],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
        timeout=120,
    )
    if child.returncode != 0:
        raise SystemExit(f"phase 21 failed: the NVML child exited {child.returncode}: "
                         f"{child.stderr[-2000:]}")
    doc = json.loads(child.stdout.strip().splitlines()[-1])
    print("  nvml child", json.dumps(doc), flush=True)
    child_ids = [c[0] for c in doc["chips"]]
    if not doc["probe"]:
        fail.append("the NVML backend did not probe")
    if sorted(child_ids) != sorted(smi):
        fail.append(f"NVML's chips {child_ids} are not nvidia-smi's {smi}")
    if doc["torch_loaded"]:
        fail.append("the NVML child imported torch")
    if doc["polls"] != PLUGIN_POLLS:
        fail.append(f"the NVML child polled {doc['polls']} times, not {PLUGIN_POLLS}")
    sick = [e for e in doc["events"] if e[1] == "Unhealthy"]
    if sick:
        fail.append(f"a sound card went Unhealthy: {sick}")

    nvml = from_name("nvml")
    t0 = time.perf_counter()
    inventory = node_inventory()
    report["inventory_s"] = time.perf_counter() - t0
    cuda = from_name("cuda")
    if not cuda.probe():
        fail.append("the CUDA backend did not probe")
    nv_chips, cu_chips = nvml.chips(), cuda.chips()
    cu_inventory = DeviceInventory(cu_chips)
    memory_bytes = {"nvml": {c.id: c.hbm_bytes for c in nv_chips},
                    "cuda": {c.id: c.hbm_bytes for c in cu_chips}}
    print("  memory bytes (NVML's total and total_memory differ by the driver's reservation)",
          json.dumps(memory_bytes), flush=True)
    names = {"nvml": nvml.topology().generation, "cuda": cuda.topology().generation}
    if names["nvml"] != names["cuda"]:
        fail.append(f"the backends name the card differently: {names}")
    # the backends' cards paired by UUID: same whole GiB, and the same
    # device file wherever CUDA can read the driver's minor
    pairs, problems = pair_with_cuda(nv_chips, cu_chips)
    fail.extend(problems)
    if len(pairs) != len(nv_chips):
        fail.append(f"CUDA sees {len(cu_chips)} cards, NVML {len(nv_chips)}")
    units = {"nvml": {cu.id: inventory.units_of(nv.id) for nv, cu in pairs},
             "cuda": {cu.id: cu_inventory.units_of(cu.id) for _, cu in pairs}}
    paths = {"nvml": {cu.id: nv.device_path for nv, cu in pairs},
             "cuda": {cu.id: cu.device_path for _, cu in pairs}}
    print("  whole GiB", json.dumps(units), "names", json.dumps(names), flush=True)
    print("  device files (CUDA's empty where the driver's /proc entry for the card is "
          "not readable: then no mount, never another card's)", json.dumps(paths), flush=True)
    auto = from_name("auto")
    if not isinstance(auto, NvmlBackend):
        fail.append(f"auto picked {type(auto).__name__}, not the NVML backend")

    # (b) the fan-out: one fake device a GiB, one core device a card
    fakes = inventory.mem_fake_devices()
    want = [f"{c.id}-_-{j}" for c in inventory.chips() for j in range(c.hbm_bytes // 2**30)]
    cores = inventory.core_devices()
    print(f"  fan-out: {len(fakes)} fake devices ({fakes[0].id} .. {fakes[-1].id}), "
          f"{len(cores)} core device(s)", flush=True)
    if [d.id for d in fakes] != want or not all(d.healthy for d in fakes):
        fail.append(f"the fan-out is not one healthy device a GiB: {len(fakes)} against "
                    f"{len(want)}")
    if len(cores) != 1:
        fail.append(f"{len(cores)} core devices, not one")

    # (c) allocate: phase 11's pods, first-fit, then one too many
    alloc = LocalAllocator(inventory, policy="first-fit")
    grants, grant_us = {}, {}
    for name, _, slice_units, _ in PODS:
        t0 = time.perf_counter()
        (grant,) = alloc.allocate([slice_units], pod_key=name)
        grant_us[name] = (time.perf_counter() - t0) * 1e6
        grants[name] = grant.envs
        if grant.envs[const.ENV_TPU_VISIBLE_CHIPS] != "0":
            fail.append(f"{name} was granted chip {grant.envs[const.ENV_TPU_VISIBLE_CHIPS]}")
    granted = sum(u for _, _, u, _ in PODS)
    left = inventory.total_units() - granted
    print(f"  grants ({granted} of {inventory.total_units()} units), host us",
          json.dumps(grant_us), "env of", PODS[-1][0], json.dumps(grants[PODS[-1][0]]),
          flush=True)
    if alloc.used_by_chip() != {0: granted}:
        fail.append(f"used {alloc.used_by_chip()} after the grants, not {{0: {granted}}}")
    try:
        alloc.allocate([left + 1], pod_key="seventh")
        fail.append(f"a seventh pod of {left + 1} units was granted")
    except AssignmentError as e:
        print(f"  a seventh pod of {left + 1} units is refused: {e}", flush=True)
    alloc.release(PODS[0][0])
    if alloc.used_by_chip() != {0: granted - PODS[0][2]}:
        fail.append(f"releasing {PODS[0][0]} left {alloc.used_by_chip()}")
    report.update(nvml_child=doc, smi_uuids=smi, units=units, memory_bytes=memory_bytes,
                  fake_devices=len(fakes), grant_us=grant_us,
                  seconds=time.perf_counter() - t_phase)
    print("  phase 21", json.dumps({k: report[k] for k in ("inventory_s", "fake_devices",
                                                           "seconds")}), flush=True)
    if fail:
        raise SystemExit("phase 21 failed: " + "; ".join(fail))
    return grants, report


def free_device_bytes() -> int:
    """The card's free memory, every process's use counted, once it has
    settled (a process's context is freed as it exits)."""
    free = 0
    for _ in range(10):
        free = max(free, torch.cuda.mem_get_info()[0])
        time.sleep(0.01)
    return free


def held_device_bytes(proc: subprocess.Popen) -> tuple[str, int]:
    """``proc`` prints one line when it is ready and then waits for a line
    on its stdin. Returns that line and the card memory ``proc`` held: the
    free memory after it exits less the free memory while it lived."""
    timer = threading.Timer(60, proc.kill)
    timer.start()
    try:
        line = proc.stdout.readline()
        during = torch.cuda.mem_get_info()[0]
        try:
            proc.stdin.write("\n")
            proc.stdin.flush()
        except BrokenPipeError:
            pass
        proc.wait(timeout=60)
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return line, free_device_bytes() - during


def open_device_files(pid: int) -> list[str]:
    """The /dev/nvidia* files process ``pid`` holds open."""
    out = set()
    for fd in os.listdir(f"/proc/{pid}/fd"):
        try:
            path = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            continue
        if path.startswith("/dev/nvidia"):
            out.add(path)
    return sorted(out)


def node_agent_daemon(tmp: str, meanwhile):
    """Phase 22 (b): the daemon as a DaemonSet starts it, ``python -m
    gpushare_device_plugin_tpu_torch.cli.daemon --standalone --health-check
    --metrics-port N`` (``auto`` discovery, so NVML), against a kubelet
    made of the port's own v1beta1 bindings on a tmp plugin dir: both
    resources register, ``/readyz`` turns 200, ListAndWatch streams the
    card's whole GiB healthy and one core device, an Allocate of two
    units is granted card 0, and SIGTERM exits 0. ``meanwhile()`` runs
    while the daemon starts. Returns the report, the failures and what
    ``meanwhile`` returned."""
    import queue
    from concurrent import futures

    import grpc

    from gpushare_device_plugin_tpu_torch.plugin.api import (
        DevicePluginStub,
        RegistrationServicer,
        add_registration_servicer,
        pb,
    )

    plugin_dir = os.path.join(tmp, "plugins")
    os.makedirs(plugin_dir)
    registrations = queue.Queue()

    class Kubelet(RegistrationServicer):
        def Register(self, request, context):
            registrations.put((request, time.perf_counter()))
            return pb.Empty()

    kubelet = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    add_registration_servicer(Kubelet(), kubelet)
    kubelet.add_insecure_port(f"unix:{os.path.join(plugin_dir, 'kubelet.sock')}")
    kubelet.start()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        metrics_port = sock.getsockname()[1]
    log_path = os.path.join(tmp, "daemon.log")
    report, fail = {}, []
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "gpushare_device_plugin_tpu_torch.cli.daemon", "--standalone",
             "--health-check", "--plugin-dir", plugin_dir, "--coredump-dir", tmp,
             "--metrics-port", str(metrics_port)],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=log,
            stderr=subprocess.STDOUT)

    def readyz():
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{metrics_port}/readyz",
                                        timeout=2) as r:
                return r.status
        except urllib.error.HTTPError as e:
            return e.code
        except OSError:
            return None

    def first_list(endpoint):
        with grpc.insecure_channel(f"unix:{os.path.join(plugin_dir, endpoint)}") as ch:
            call = DevicePluginStub(ch).ListAndWatch(pb.Empty(), timeout=10)
            devices = [(d.ID, d.health) for d in next(call).devices]
            call.cancel()
            return devices

    try:
        side = meanwhile()
        got = [registrations.get(timeout=30) for _ in range(2)]
        regs = {r.resource_name: r for r, _ in got}
        report["registered_s"] = max(t for _, t in got) - t0
        deadline = time.perf_counter() + 10
        while readyz() != 200 and time.perf_counter() < deadline:
            time.sleep(0.01)
        report["readyz"] = readyz()
        mem = first_list(regs[const.RESOURCE_MEM].endpoint)
        core = first_list(regs[const.RESOURCE_CORE].endpoint)
        with grpc.insecure_channel(
                f"unix:{os.path.join(plugin_dir, regs[const.RESOURCE_MEM].endpoint)}") as ch:
            t = time.perf_counter()
            resp = DevicePluginStub(ch).Allocate(pb.AllocateRequest(container_requests=[
                pb.ContainerAllocateRequest(devicesIDs=[d for d, _ in mem[:2]])]), timeout=10)
            report["allocate_ms"] = (time.perf_counter() - t) * 1e3
        envs = dict(resp.container_responses[0].envs)
        maps = open(f"/proc/{proc.pid}/maps").read()
        report.update(
            resources=sorted(regs), mem_devices=len(mem), core_devices=len(core),
            unhealthy=[d for d, h in mem + core if h != "Healthy"], envs=envs,
            torch_mapped="libtorch" in maps, libcuda_mapped="libcuda" in maps,
            device_files=open_device_files(proc.pid))
        during = torch.cuda.mem_get_info()[0]
        t = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        report["exit"] = proc.wait(timeout=15)
        report["stop_s"] = time.perf_counter() - t
        report["held_bytes"] = free_device_bytes() - during
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        kubelet.stop(0)
    report["seconds"] = time.perf_counter() - t0
    if sorted(report.get("resources", [])) != sorted([const.RESOURCE_MEM, const.RESOURCE_CORE]):
        fail.append(f"registered {report.get('resources')}")
    if report.get("readyz") != 200:
        fail.append(f"/readyz answered {report.get('readyz')} after registration")
    if report.get("core_devices") != 1 or report.get("unhealthy"):
        fail.append(f"{report.get('core_devices')} core devices, unhealthy "
                    f"{report.get('unhealthy')}")
    if report.get("envs", {}).get(const.ENV_TPU_VISIBLE_CHIPS) != "0" or report.get(
            "envs", {}).get(const.ENV_MEM_POD) != "2":
        fail.append(f"the Allocate's env is not card 0's 2 units: {report.get('envs')}")
    if report.get("torch_mapped"):
        fail.append("the daemon mapped libtorch")
    if report.get("held_bytes", CONTEXT_BYTES) >= CONTEXT_BYTES:
        fail.append(f"the daemon held {report.get('held_bytes')} bytes of the card")
    if report.get("exit") != 0:
        fail.append(f"SIGTERM exited {report.get('exit')}: {open(log_path).read()[-2000:]}")
    return report, fail, side


def phase_node_agent() -> dict:
    """Phase 22: the node agent on the card. (a) Its node half in a child
    that loads neither torch nor grpc and holds no CUDA context
    (:data:`NODE_AGENT_CHILD`); (b) the daemon itself
    (:func:`node_agent_daemon`). Returns the report."""
    print("phase 22: the node agent (standalone manager: NVML inventory, allocate, core "
          "holds, health, stack dump and flight record)", flush=True)
    torch.zeros(1, device="cuda")  # this process's context (phase 1 made it in a whole run)
    t_phase = time.perf_counter()
    pods = [[name, units] for name, _, units, _ in PODS]

    def node_half_and_control():
        """(a) and the control, one after the other, while (b)'s daemon
        starts. Sound with the overlap: another process taking memory
        inside a child's window only lowers that child's reading, and any
        such process is itself held to account; the daemon's own window
        opens after both children have exited."""
        with tempfile.TemporaryDirectory() as tmp:
            err_path = os.path.join(tmp, "child.err")
            with open(err_path, "w") as err:
                line, child_bytes = held_device_bytes(subprocess.Popen(
                    [sys.executable, "-c", NODE_AGENT_CHILD, json.dumps(pods),
                     str(PLUGIN_POLLS), str(PLUGIN_POLL_INTERVAL_S), tmp],
                    cwd=os.path.dirname(os.path.abspath(__file__)), stdin=subprocess.PIPE,
                    stdout=subprocess.PIPE, stderr=err, text=True))
            if not line.strip():
                raise SystemExit(f"phase 22 failed: the node agent's child printed nothing: "
                                 f"{open(err_path).read()[-2000:]}")
        control = held_device_bytes(subprocess.Popen(
            [sys.executable, "-c", CUDA_CONTEXT_CHILD], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True))
        return json.loads(line), child_bytes, control

    # (b) the daemon itself, as a DaemonSet runs it, where this machine has grpc
    daemon, problems = None, []
    if importlib.util.find_spec("grpc") is None:
        print("  (b) not run: this machine has no grpc", flush=True)
        doc, child_bytes, (control_rc, control_bytes) = node_half_and_control()
    else:
        with tempfile.TemporaryDirectory() as tmp:
            daemon, problems, (doc, child_bytes, (control_rc, control_bytes)) = (
                node_agent_daemon(tmp, node_half_and_control))
    print("  node agent child", json.dumps(doc), flush=True)
    fail = []
    if doc["auto"] != NvmlBackend.__name__:
        fail.append(f"auto picked {doc['auto']}, not NVML")
    if len(doc["chips"]) != 1:
        fail.append(f"{len(doc['chips'])} cards in the inventory, not one")
    units = doc["chips"][0][1] if doc["chips"] else 0
    granted = sum(u for _, u in pods)
    if doc["used"] != {"0": granted}:
        fail.append(f"used {doc['used']} after the grants, not {{0: {granted}}}")
    wrong = {n: e[const.ENV_TPU_VISIBLE_CHIPS] for n, e in doc["grants"].items()
             if e[const.ENV_TPU_VISIBLE_CHIPS] != "0" or e[const.ENV_MEM_DEV] != str(units)}
    if wrong or sorted(doc["grants"]) != sorted(n for n, _ in pods):
        fail.append(f"the grants are not every pod on card 0 of {units} units: {wrong}")
    if doc["seventh"][1] is None:
        fail.append(f"a seventh pod of {doc['seventh'][0]} units was granted")
    if not doc["core_while_mem"] or "fractional units in use" not in doc["core_while_mem"]:
        fail.append(f"a core hold beside mem units was not refused: {doc['core_while_mem']}")
    if doc["core_hold"].get(const.ENV_TPU_VISIBLE_CHIPS) != "0" or doc["core_held"] != [0]:
        fail.append(f"the core hold after the release did not go through: {doc['core_hold']}")
    if doc["mem_while_held"] is None:
        fail.append("a mem grant went through beside the core hold")
    if doc["polls"] < PLUGIN_POLLS or doc["restarts"]:
        fail.append(f"{doc['polls']} health polls and {doc['restarts']} restarts, not "
                    f"{PLUGIN_POLLS} and 0")
    sick = [e for e in doc["events"] if e[1] == "Unhealthy"]
    if sick or doc["unhealthy"]:
        fail.append(f"a sound card went Unhealthy: {sick}, allocator {doc['unhealthy']}")
    if not doc["stack_dump"] or not doc["stack_threads"]:
        fail.append("SIGQUIT left no stack dump")
    if not doc["flight_record"] or not {"traces", "logs", "timeline"} <= set(
            doc["flight_record_keys"] or ()):
        fail.append(f"SIGUSR1 left no flight record with traces, logs and timeline: "
                    f"{doc['flight_record_keys']}")
    for key in ("torch_loaded", "grpc_loaded", "libcuda_before_nvml"):
        if doc[key]:
            fail.append(f"the node agent's child has {key}")
    # NVIDIA's nvmlInit_v2 maps libcuda.so and opens /dev/nvidia-uvm
    # itself, so both are printed, not gated. What a DaemonSet must not do
    # is take the card's memory with a CUDA context: the control shows what
    # one costs.
    held = {"control": control_bytes, "child": child_bytes}
    print("  card memory held (bytes): a control holding one CUDA context", control_bytes,
          "(return codes", control_rc.strip(), "), the node agent's child", child_bytes,
          "; the child's /dev/nvidia* files", doc["device_files"], flush=True)
    if control_bytes < CONTEXT_BYTES:
        fail.append(f"a CUDA context cost {control_bytes} bytes, under {CONTEXT_BYTES}: "
                    "the memory check cannot see one")
    if child_bytes >= CONTEXT_BYTES:
        fail.append(f"the node agent's child held {child_bytes} bytes of the card")
    if daemon is not None:
        print("  (b) the daemon", json.dumps(daemon), flush=True)
        fail.extend(f"(b) {p}" for p in problems)
    seconds = time.perf_counter() - t_phase
    if seconds >= NODE_AGENT_BUDGET_S:
        fail.append(f"the phase took {seconds:.2f} s, not under {NODE_AGENT_BUDGET_S}")
    report = {"child": doc, "daemon": daemon, "held_bytes": held, "seconds": seconds}
    print("  phase 22", json.dumps({"child_s": doc["seconds"], "daemon_s": daemon and
                                    daemon["seconds"], "seconds": seconds}), flush=True)
    if fail:
        raise SystemExit("phase 22 failed: " + "; ".join(fail))
    return report


def load_fake_apiserver():
    """``tests/fake_apiserver.py`` by path (a module of the standard library
    alone, not a package)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "fake_apiserver.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_fake_apiserver", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cluster_pod(name: str, node: str, units: int = 0, *, phase: str = "Pending",
                annotations: dict | None = None, labels: dict | None = None,
                created: int = 0) -> dict:
    limits = {const.RESOURCE_MEM: str(units)} if units else {}
    return {
        "metadata": {"name": name, "namespace": "default", "uid": f"uid-{node}-{name}",
                     "creationTimestamp": time.strftime(
                         "%Y-%m-%dT%H:%M:%SZ", time.gmtime(1767225600 + created)),
                     "annotations": annotations or {}, "labels": labels or {}},
        "spec": {"nodeName": node, "containers": [
            {"name": "c0", "image": "busybox", "resources": {"limits": limits}}]},
        "status": {"phase": phase},
    }


def assumed_on_card0(units: int, card_units: int) -> dict:
    """The annotations the scheduler extender writes at bind: card 0."""
    return {const.ENV_MEM_IDX: "0", const.ENV_MEM_POD: str(units),
            const.ENV_MEM_DEV: str(card_units), const.ENV_ASSIGNED_FLAG: "false",
            const.ENV_ASSUME_TIME: str(time.time_ns()),
            ANN_EXTENDER_ALLOCATION: json.dumps({"c0": {"0": units}})}


def seed_cluster(api, card_units: int) -> list[tuple[str, int]]:
    """CLUSTER_NODES nodes of CLUSTER_NODE_PODS pods; -> this node's share
    pods as (name, units), oldest first."""
    share = []
    for n in range(CLUSTER_NODES):
        node = CLUSTER_NODE if n == 0 else f"h100-node-{n}"
        cap = {const.RESOURCE_MEM: str(card_units), const.RESOURCE_COUNT: "1"}
        api.add_node(node, capacity=cap)
        prefix = "" if n == 0 else f"n{n}-"  # pod names are unique per namespace
        for i, units in enumerate(CLUSTER_SHARE_UNITS):
            name = f"{prefix}share-{i}"
            if n == 0:
                api.add_pod(cluster_pod(name, node, units, created=i,
                                        annotations=assumed_on_card0(units, card_units)))
                share.append((name, units))
            else:  # admitted and running elsewhere
                ann = {**assumed_on_card0(units, card_units), const.ENV_ASSIGNED_FLAG: "true"}
                api.add_pod(cluster_pod(name, node, units, phase="Running", annotations=ann,
                                        labels={const.LABEL_RESOURCE_KEY:
                                                const.LABEL_RESOURCE_VALUE}))
        for i in range(CLUSTER_NODE_PODS - len(CLUSTER_SHARE_UNITS)):
            api.add_pod(cluster_pod(f"{prefix}plain-{i}", node, phase="Running", created=i))
    return share


def annotated_units(api) -> dict[int, int]:
    """Units per card from this node's assigned pods' annotations alone."""
    used: dict[int, int] = {}
    with api._lock:
        for pod in api.pods.values():
            meta = pod["metadata"]
            ann = meta.get("annotations") or {}
            if (pod["spec"].get("nodeName") == CLUSTER_NODE
                    and ann.get(const.ENV_ASSIGNED_FLAG) == "true"):
                idx = int(ann[const.ENV_MEM_IDX])
                used[idx] = used.get(idx, 0) + int(ann[const.ENV_MEM_POD])
    return used


def wal_pending(path: str) -> set:
    """Keys the journal file begins and never commits or aborts."""
    pending: set = set()
    if not os.path.exists(path):
        return pending
    for line in open(path).read().splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue  # a torn tail
        key = tuple(rec.get("key") or ())
        if rec.get("op") == "begin":
            pending.add(key)
        elif rec.get("op") in ("commit", "abort"):
            pending.discard(key)
    return pending


class ClusterDaemon:
    """``python -m gpushare_device_plugin_tpu_torch.cli.daemon --node-name
    N`` in cluster mode (``auto`` discovery, so NVML), reading the fake
    apiserver through a JSON kubeconfig, against a kubelet made of the
    port's v1beta1 bindings on the plugin dir."""

    def __init__(self, tmp: str, name: str, kubelet, *args: str, faults: str = ""):
        self.kubelet = kubelet
        self.log_path = os.path.join(tmp, f"{name}.log")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(KUBECONFIG=os.path.join(tmp, "kubeconfig.json"), HOME=tmp,
                   TPUSHARE_FAULTS=faults)
        while not kubelet.registrations.empty():  # an earlier daemon's
            kubelet.registrations.get_nowait()
        self.t0 = time.perf_counter()
        with open(self.log_path, "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "gpushare_device_plugin_tpu_torch.cli.daemon",
                 "--node-name", CLUSTER_NODE, "--health-check", "--plugin-dir",
                 kubelet.plugin_dir, "--coredump-dir", tmp, "--checkpoint-path",
                 os.path.join(tmp, "wal.ckpt"), "-v", "1", *args],
                cwd=os.path.dirname(os.path.abspath(__file__)), env=env, stdout=log,
                stderr=subprocess.STDOUT)
        got = [kubelet.registrations.get(timeout=CLUSTER_DAEMON_TIMEOUT_S) for _ in range(2)]
        self.regs = {r.resource_name: r for r, _ in got}
        self.registered_s = max(t for _, t in got) - self.t0
        self.mem_ids = kubelet.first_list(self.regs[const.RESOURCE_MEM].endpoint)

    def allocate(self, ids: list[str], timeout: float = 10):
        import grpc

        from gpushare_device_plugin_tpu_torch.plugin.api import DevicePluginStub, pb

        path = os.path.join(self.kubelet.plugin_dir, self.regs[const.RESOURCE_MEM].endpoint)
        with grpc.insecure_channel(f"unix:{path}") as ch:
            resp = DevicePluginStub(ch).Allocate(pb.AllocateRequest(container_requests=[
                pb.ContainerAllocateRequest(devicesIDs=ids)]), timeout=timeout)
        return dict(resp.container_responses[0].envs)

    def log(self) -> str:
        return open(self.log_path).read()

    def finish(self, sig=signal.SIGTERM) -> dict:
        """Stop the daemon; -> its exit code, the card memory it held, and
        whether it mapped libtorch."""
        maps = open(f"/proc/{self.proc.pid}/maps").read()
        during = torch.cuda.mem_get_info()[0]
        self.proc.send_signal(sig)
        try:
            code = self.proc.wait(timeout=15)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        return {"exit": code, "held_bytes": free_device_bytes() - during,
                "torch_mapped": "libtorch" in maps, "registered_s": self.registered_s}


def cluster_kubelet(plugin_dir: str):
    """A kubelet's registration service and ListAndWatch reader, made of
    the port's v1beta1 bindings."""
    import queue
    from concurrent import futures

    import grpc

    from gpushare_device_plugin_tpu_torch.plugin.api import (
        DevicePluginStub,
        RegistrationServicer,
        add_registration_servicer,
        pb,
    )

    class Kubelet(RegistrationServicer):
        plugin_dir = ""
        registrations = queue.Queue()

        def Register(self, request, context):
            self.registrations.put((request, time.perf_counter()))
            return pb.Empty()

        def first_list(self, endpoint):
            path = os.path.join(self.plugin_dir, endpoint)
            with grpc.insecure_channel(f"unix:{path}") as ch:
                call = DevicePluginStub(ch).ListAndWatch(pb.Empty(), timeout=10)
                ids = [d.ID for d in next(call).devices]
                call.cancel()
                return ids

    kubelet = Kubelet()
    kubelet.plugin_dir = plugin_dir
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    add_registration_servicer(kubelet, server)
    server.add_insecure_port(f"unix:{os.path.join(plugin_dir, 'kubelet.sock')}")
    server.start()
    return kubelet, server


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def inspect_child(tmp: str, *argv: str) -> dict:
    """``python -m gpushare_device_plugin_tpu_torch.cli.inspect ARGV`` (what
    ``kubectl-inspect-gpushare-cuda`` runs) in a child process reading the
    fake apiserver through the phase's kubeconfig; -> its exit code, its
    output, its seconds and the torch modules it imported (``-X
    importtime`` lists every module the child loads)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(KUBECONFIG=os.path.join(tmp, "kubeconfig.json"), HOME=tmp)
    t = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "gpushare_device_plugin_tpu_torch.cli.inspect",
         *argv], cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        capture_output=True, text=True, timeout=60)
    loaded = [line.rsplit("|", 1)[-1].strip() for line in out.stderr.splitlines()
              if line.startswith("import time:")]
    return {"rc": out.returncode, "out": out.stdout, "seconds": time.perf_counter() - t,
            "torch": [m for m in loaded if m.split(".")[0] == "torch"],
            "err": "\n".join(line for line in out.stderr.splitlines()
                             if not line.startswith("import time:"))[-1500:]}


def check_inspect(tmp: str, api, share, ledger_units: int,
                  card_units: int, fail: list) -> dict:
    """Phase 23's inspect child against daemon (a): the summary and the
    details after the admissions, and the timeline once the daemon's ring
    holds two samples."""
    from gpushare_device_plugin_tpu_torch.allocator.defrag import status_from_node

    t = time.perf_counter()
    status = None
    while status is None and time.perf_counter() - t < 10:
        status = status_from_node(api.nodes[CLUSTER_NODE])
        if status is None:
            time.sleep(0.05)
    out: dict = {"defrag_status": status, "defrag_wait_s": time.perf_counter() - t}
    if status is None or status.get("planned") != 0 or status.get("completed") != 0:
        fail.append(f"(a) the node's defrag status is {status}, not 0 moves on one card")
    summary = inspect_child(tmp, CLUSTER_NODE)
    details = inspect_child(tmp, "-d", CLUSTER_NODE)
    out["summary"], out["details"] = summary["out"], details["out"]
    out["child_s"] = [summary["seconds"], details["seconds"]]
    for label, run in (("summary", summary), ("details", details)):
        if run["rc"] != 0 or run["torch"]:
            fail.append(f"(a) inspect {label} exited {run['rc']}, imported torch "
                        f"{run['torch'][:3]}: {run['err']}")
    if f"chip0: {ledger_units}/{card_units}" not in summary["out"]:
        fail.append(f"(a) the summary does not show card 0 at {ledger_units}/{card_units}: "
                    f"{summary['out']}")
    missing = [n for n, _ in share if f" {n} " not in details["out"]]
    if missing or f"Allocated : {ledger_units} " not in details["out"]:
        fail.append(f"(a) the details lack pods {missing} or {ledger_units} allocated: "
                    f"{details['out'][:1500]}")
    return out


def check_timeline(tmp: str, metrics_url: str, fail: list) -> dict:
    """The daemon's ``/timeline`` rendered by the inspect child, once it
    holds two samples of ``util_pct`` (its buckets are 10 s wide)."""
    t = time.perf_counter()
    points = 0
    while points < 2 and time.perf_counter() - t < 12:
        doc = json.loads(scrape(f"{metrics_url}/timeline"))
        points = len(doc["series"].get("util_pct", []))
        if points < 2:
            time.sleep(0.1)
    run = inspect_child(tmp, "timeline", "--timeline-url", metrics_url)
    rows = [line for line in run["out"].splitlines() if line.startswith("util_pct")]
    n = int(rows[0].rsplit("n=", 1)[1]) if rows else 0
    if run["rc"] != 0 or run["torch"] or n < 2:
        fail.append(f"(a) inspect timeline exited {run['rc']} with {n} util_pct samples, "
                    f"imported torch {run['torch'][:3]}: {run['out']} {run['err']}")
    return {"timeline": run["out"], "timeline_wait_s": time.perf_counter() - t - run["seconds"],
            "child_s": run["seconds"], "util_pct_samples": n}


def phase_cluster_agent() -> dict:
    """Phase 23: the node agent in cluster mode against a 50-node fake
    apiserver. (a) 16 share pods admitted through the daemon's informer and
    ClusterAllocator, and a deleted pod's units reclaimed; (b) a crash after
    an admission's PATCH, and the restart that replays, fences and
    reconciles it; (c) neither daemon takes card memory. Returns the
    report."""
    from concurrent import futures

    from gpushare_device_plugin_tpu_torch.allocator.cluster import cluster_chip_state
    from gpushare_device_plugin_tpu_torch.cluster.apiserver import ApiServerClient
    from gpushare_device_plugin_tpu_torch.cluster.informer import PodInformer
    from gpushare_device_plugin_tpu_torch.cluster.podsource import ApiServerPodSource

    print("phase 23: the node agent in cluster mode (informer, ClusterAllocator, WAL, "
          "fence, reconciler) against a 50-node fake apiserver", flush=True)
    torch.zeros(1, device="cuda")  # this process's context (phase 1 made it in a whole run)
    t_phase = time.perf_counter()
    card_units = card_gib()
    fake = load_fake_apiserver()
    api = fake.FakeApiServer()
    share = seed_cluster(api, card_units)
    api.start()
    report: dict = {"pods": len(api.pods), "nodes": len(api.nodes), "card_units": card_units}
    fail: list[str] = []
    daemons: list[ClusterDaemon] = []
    tails: list[str] = []  # each daemon's log's end, for a failure's message
    control = {}

    def context_control():
        rc, held = held_device_bytes(subprocess.Popen(
            [sys.executable, "-c", CUDA_CONTEXT_CHILD], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True))
        control.update(rc=rc.strip(), bytes=held)

    control_thread = threading.Thread(target=context_control)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            with open(os.path.join(tmp, "kubeconfig.json"), "w") as f:
                json.dump({"current-context": "fake",
                           "contexts": [{"name": "fake", "context": {"cluster": "fake"}}],
                           "clusters": [{"name": "fake", "cluster": {"server": api.url}}]}, f)
            plugin_dir = os.path.join(tmp, "plugins")
            os.makedirs(plugin_dir)
            kubelet, kubelet_server = cluster_kubelet(plugin_dir)
            client = ApiServerClient(api.url)
            try:
                # the informer's first LIST of this node's pods, as the daemon's
                t = time.perf_counter()
                informer = PodInformer(client, CLUSTER_NODE).start(sync_timeout_s=10)
                report["informer_list"] = {"seconds": time.perf_counter() - t,
                                           "pods": len(informer.all_pods())}
                informer.stop()
                control_thread.start()  # meanwhile: the context control
                # --- (a) admission, inspect, reclaim ---------------------
                metrics_url = f"http://127.0.0.1:{free_port()}"
                a = ClusterDaemon(tmp, "a", kubelet, "--reconcile-interval", "0.5",
                                  "--defrag-interval", "0.25", "--interference-interval", "0.25",
                                  "--timeline-interval", "0.25", "--metrics-port",
                                  metrics_url.rsplit(":", 1)[1])
                daemons.append(a)
                report["mem_devices"] = len(a.mem_ids)
                slices, at = [], 0
                for _, units in share:
                    slices.append(a.mem_ids[at:at + units])
                    at += units

                def timed_allocate(ids):
                    t = time.perf_counter()
                    envs = a.allocate(ids)
                    return envs, (time.perf_counter() - t) * 1e3

                with futures.ThreadPoolExecutor(CLUSTER_WORKERS) as pool:
                    results = list(pool.map(timed_allocate, slices))
                ms = [m for _, m in results]
                report["allocate_ms"] = {"p50": ceil_rank_quantile(ms, 0.5),
                                         "p99": ceil_rank_quantile(ms, 0.99), "n": len(ms)}
                bad_env = [(units, e.get(const.ENV_MEM_POD), e.get(const.ENV_TPU_VISIBLE_CHIPS))
                           for (_, units), (e, _) in zip(share, results)
                           if e.get(const.ENV_MEM_POD) != str(units)
                           or e.get(const.ENV_TPU_VISIBLE_CHIPS) != "0"
                           or e.get(const.ENV_MEM_IDX) != "0"]
                if bad_env:
                    fail.append(f"envs not their pods' units on card 0: {bad_env}")
                unassigned = [n for n, _ in share if api.pods[("default", n)]["metadata"][
                    "annotations"].get(const.ENV_ASSIGNED_FLAG) != "true"]
                if unassigned:
                    fail.append(f"pods not assigned: {unassigned}")
                source = ApiServerPodSource(client, CLUSTER_NODE)
                ledger = cluster_chip_state(source)()[0]
                report["ledger"] = ledger
                if ledger != annotated_units(api) or ledger != {0: sum(CLUSTER_SHARE_UNITS)}:
                    fail.append(f"ledger {ledger} is not the annotations' "
                                f"{annotated_units(api)}")
                report["inspect"] = check_inspect(tmp, api, share,
                                                  ledger.get(0, 0), card_units, fail)
                # reclaim: a 16-GiB pod cannot fit until two pods are deleted
                big = next(n for n, u in share if u == 16)
                small = next(n for n, u in share if u == 2)
                api.add_pod(cluster_pod("late-16", CLUSTER_NODE, 16, created=200))
                try:
                    a.allocate(a.mem_ids[:16])
                    fail.append("a 16-GiB pod was admitted onto a card with 3 GiB free")
                except Exception:  # refused: the card is full
                    pass
                t = time.perf_counter()
                api.delete_pod("default", big)
                api.delete_pod("default", small)
                envs = None
                while envs is None and time.perf_counter() - t < 10:
                    try:
                        envs = a.allocate(a.mem_ids[:16])
                    except Exception:  # the informer has not seen the deletes yet
                        time.sleep(0.02)
                report["reclaim_s"] = time.perf_counter() - t
                if not envs or envs.get(const.ENV_MEM_POD) != "16":
                    fail.append(f"the 16-GiB pod was not admitted after the deletes: {envs}")
                report["inspect"].update(check_timeline(tmp, metrics_url, fail))
                report["daemon_a"] = a.finish()
                # --- (b) a crash after the PATCH, and the restart ---------
                b1 = ClusterDaemon(tmp, "b1", kubelet, "--reconcile-interval", "0",
                                   faults="allocator.post_persist=crash:1")
                daemons.append(b1)
                gen1 = int(api.nodes[CLUSTER_NODE]["metadata"]["annotations"][
                    "tpushare.aliyun.com/fence-generation"].partition(":")[0])
                api.add_pod(cluster_pod("victim", CLUSTER_NODE, 2, created=201,
                                        annotations=assumed_on_card0(2, card_units)))
                try:  # the crashed admission never answers: a short deadline
                    b1.allocate(b1.mem_ids[:2], timeout=2)
                    fail.append("(b) the crash site did not fire")
                except Exception:  # the admission died after its PATCH
                    pass
                wal = os.path.join(tmp, "wal.ckpt")
                report["wal_pending_after_crash"] = len(wal_pending(wal))
                if wal_pending(wal) != {("default", "victim")}:
                    fail.append(f"(b) the WAL holds {wal_pending(wal)}, not the victim's begin")
                report["daemon_b1"] = b1.finish(signal.SIGKILL)
                b2 = ClusterDaemon(tmp, "b2", kubelet, "--reconcile-interval", "0.5")
                daemons.append(b2)
                gen2 = int(api.nodes[CLUSTER_NODE]["metadata"]["annotations"][
                    "tpushare.aliyun.com/fence-generation"].partition(":")[0])
                report["fence_generations"] = [gen1, gen2]
                if gen2 != gen1 + 1:
                    fail.append(f"(b) the fence went {gen1} -> {gen2}, not up by one")
                replayed = [line for line in b2.log().splitlines() if "device-state replay" in line]
                report["replayed"] = replayed[-1].split("replay: ")[1].split()[0] if replayed else "0"
                if report["replayed"] != "1":
                    fail.append(f"(b) replayed {report['replayed']} entries, not 1")
                t = time.perf_counter()
                while wal_pending(wal) and time.perf_counter() - t < 10:
                    time.sleep(0.02)
                report["reconciled_s"] = time.perf_counter() - t
                if wal_pending(wal):
                    fail.append("(b) the reconciler left the victim's entry pending")
                api.add_pod(cluster_pod("fresh", CLUSTER_NODE, 2, created=202,
                                        annotations=assumed_on_card0(2, card_units)))
                envs = b2.allocate(b2.mem_ids[:2])
                if envs.get(const.ENV_MEM_POD) != "2" or envs.get(const.ENV_MEM_IDX) != "0":
                    fail.append(f"(b) the fresh pod's env is {envs}")
                report["daemon_b2"] = b2.finish()
                ledger = cluster_chip_state(source)()[0]
                report["final_ledger"] = ledger
                if ledger != annotated_units(api):
                    fail.append(f"(b) ledger {ledger} is not the annotations' "
                                f"{annotated_units(api)}")
            finally:
                for d in daemons:
                    if d.proc.poll() is None:
                        d.proc.kill()
                        d.proc.wait()
                    tails.append(f"\n--- {os.path.basename(d.log_path)}\n{d.log()[-1500:]}")
                kubelet_server.stop(0)
                if control_thread.ident:
                    control_thread.join(60)
    finally:
        api.stop()
    # --- (c) the agent takes none of the card ---------------------------
    report["control_bytes"] = control.get("bytes")
    if (control.get("bytes") or 0) < CONTEXT_BYTES:
        fail.append(f"a CUDA context cost {control.get('bytes')} bytes, under {CONTEXT_BYTES}: "
                    "the memory check cannot see one")
    for name in ("daemon_a", "daemon_b1", "daemon_b2"):
        d = report.get(name, {})
        if name != "daemon_b1" and d.get("exit") != 0:
            fail.append(f"{name} exited {d.get('exit')} on SIGTERM")
        if d.get("held_bytes", CONTEXT_BYTES) >= CONTEXT_BYTES or d.get("torch_mapped"):
            fail.append(f"{name} held {d.get('held_bytes')} bytes of the card, libtorch "
                        f"mapped: {d.get('torch_mapped')}")
    report["seconds"] = time.perf_counter() - t_phase
    if report["seconds"] >= CLUSTER_BUDGET_S:
        fail.append(f"the phase took {report['seconds']:.2f} s, not under {CLUSTER_BUDGET_S}")
    print("  phase 23", json.dumps(report), flush=True)
    if fail:
        raise SystemExit("phase 23 failed: " + "; ".join(fail) + "".join(tails))
    return report


# Phase 25: the scheduler extender on the card's machine (host only: it
# builds nothing and launches no kernel). (a) One admission from the
# scheduler's webhooks to the pod's env: phase 23's cluster (50 nodes of 110
# pods), the other 49 nodes holding EXTENDER_OTHER_UNITS of their 79 GiB so
# the filter refuses each; this node's 16 share pods pending with no node.
# (b) The sharded extender in process at the reference bench's largest scale
# configuration (bench.py run_scale_bench at SCALE_NODE_COUNTS[-1] and
# SCALE_SHARD_COUNTS[-1]: 1,000 nodes, 8 shards, fanout 2, 8 workers, 600
# events, its seed), with a gang group every 40 arrivals (its storm's rate);
# then the same router under the lock-order witness at WITNESSED_DRILL.
# (c) The shard router's webhook process, killed in a cross-shard gang bind
# and restarted on the same WALs.
EXTENDER_BUDGET_S = 60.0
EXTENDER_OTHER_UNITS = sum(CLUSTER_SHARE_UNITS) + 2  # 78 of 79: 1 GiB free
SCALE_NODES, SCALE_SHARDS, SCALE_FANOUT, SCALE_WORKERS = 1000, 8, 2, 8
SCALE_EVENTS, SCALE_GANG_EVERY, SCALE_SEED = 600, 40, 20260804
# The lock-order witness roughly triples the scale run's host time (73 s
# against 27 s on an 8-core CPU), past the phase's budget, so the bench's
# numbers come from a run without it (as the bench takes them) and the
# witness checks the bench's --scale-smoke settings with its storm's gang
# rate (bench.py: 16 nodes, 2 shards, 80 events, 4 workers, a gang group
# every 12 arrivals) at seed 0, as tests/test_torch_shards.py does.
WITNESSED_DRILL = dict(nodes=16, shards=2, fanout=2, workers=4, events=80, gang_every=12,
                       seed=0)
ROUTER_SHARDS = 4
ROUTER_GROUP = "h100-xg"
# The router child: `python -m gpushare_device_plugin_tpu_torch.extender.shards`'s
# main, run in a thread of a process that then drives one cross-shard gang
# group through the router main built (the webhook has no verb for a gang
# group: the reference drives them in process too). Blocked imports make
# any torch import fail.
ROUTER_CHILD = r'''
import json, sys, threading, time
for name in ("torch", "requests", "urllib3", "yaml"):
    sys.modules[name] = None
from gpushare_device_plugin_tpu_torch.extender import shards
from gpushare_device_plugin_tpu_torch.cluster.apiserver import ApiServerClient
from gpushare_device_plugin_tpu_torch.utils.faults import SimulatedCrash
argv, members, n_nodes = json.loads(sys.argv[1])
built = []
init = shards.ShardRouter.__init__
def capture(self, *a, **kw):
    init(self, *a, **kw)
    built.append(self)
shards.ShardRouter.__init__ = capture
threading.Thread(target=shards.main, args=(argv,), daemon=True).start()
t = time.perf_counter()
while time.perf_counter() - t < 20 and not (built and sum(
        built[0].shards_doc()["ring"]["nodes_per_shard"].values()) == n_nodes and all(
        s.core.ready() for s in built[0]._shards.values())):
    time.sleep(0.02)
api = ApiServerClient.from_env()
pods = [api.get_pod("default", name) for name in members]
try:
    print("NO-CRASH", json.dumps(built[0].admit_gang_group(pods)), flush=True)
except SimulatedCrash as e:
    print("CRASHED", e, flush=True)
time.sleep(60)  # the parent SIGKILLs this process
'''


def extender_seed_cluster(api, card_units: int) -> tuple[list[str], list[tuple[str, int]]]:
    """Phase 23's cluster with this node's share pods pending unbound and
    every other node at EXTENDER_OTHER_UNITS; -> (the node names, this
    node's share pods as (name, units), oldest first)."""
    names, share = [], []
    for n in range(CLUSTER_NODES):
        node = CLUSTER_NODE if n == 0 else f"h100-node-{n}"
        names.append(node)
        api.add_node(node, capacity={const.RESOURCE_MEM: str(card_units),
                                     const.RESOURCE_COUNT: "1"})
        prefix = "" if n == 0 else f"n{n}-"
        units_list = CLUSTER_SHARE_UNITS if n == 0 else CLUSTER_SHARE_UNITS + [2]
        for i, units in enumerate(units_list):
            name = f"{prefix}share-{i}"
            if n == 0:  # pending: the scheduler has not placed it
                api.add_pod(cluster_pod(name, "", units, created=i))
                share.append((name, units))
            else:
                ann = {**assumed_on_card0(units, card_units), const.ENV_ASSIGNED_FLAG: "true"}
                api.add_pod(cluster_pod(name, node, units, phase="Running", annotations=ann,
                                        labels={const.LABEL_RESOURCE_KEY:
                                                const.LABEL_RESOURCE_VALUE}))
        for i in range(CLUSTER_NODE_PODS - len(units_list)):
            api.add_pod(cluster_pod(f"{prefix}plain-{i}", node, phase="Running", created=i))
    return names, share


def torch_imported(log_path: str) -> list[str]:
    """The torch modules a child run with ``-X importtime`` loaded."""
    loaded = [line.rsplit("|", 1)[-1].strip() for line in open(log_path).read().splitlines()
              if line.startswith("import time:")]
    return [m for m in loaded if m.split(".")[0] == "torch"]


def extender_child(tmp: str, name: str, module: str, *args: str, faults: str = ""):
    """``python -X importtime -m MODULE ARGS`` against the phase's kubeconfig,
    logging to ``tmp/<name>.log``."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(KUBECONFIG=os.path.join(tmp, "kubeconfig.json"), HOME=tmp,
               TPUSHARE_FAULTS=faults)
    log_path = os.path.join(tmp, f"{name}.log")
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "-X", "importtime", "-m", module, *args],
                                cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                                stdout=log, stderr=subprocess.STDOUT)
    return proc, log_path


def wait_http(url: str, timeout: float, proc=None) -> float:
    """Seconds until ``url`` answers 200 (raises past ``timeout``)."""
    t = time.perf_counter()
    while True:
        try:
            with urllib.request.urlopen(url, timeout=2) as resp:
                if resp.status == 200:
                    return time.perf_counter() - t
        except (urllib.error.URLError, ConnectionError, OSError):
            pass
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(f"{url}: the process exited {proc.returncode}")
        if time.perf_counter() - t > timeout:
            raise RuntimeError(f"{url} did not answer 200 within {timeout} s")
        time.sleep(0.05)


def post_json(url: str, body: dict) -> tuple[object, float]:
    """POST ``body`` as JSON; -> (the reply, its ms)."""
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t = time.perf_counter()
    with urllib.request.urlopen(req, timeout=10) as resp:
        out = json.loads(resp.read())
    return out, (time.perf_counter() - t) * 1e3


def stop_child(proc, sig=signal.SIGTERM, timeout: float = 15) -> int:
    maps = open(f"/proc/{proc.pid}/maps").read() if proc.poll() is None else ""
    proc.send_signal(sig)
    try:
        code = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if "libtorch" in maps:
        raise RuntimeError(f"pid {proc.pid} mapped libtorch")
    return code


def check_trace_tree(out: str, spans: list) -> str:
    """Why ``inspect trace``'s render and spans are not one tree admission →
    extender.bind → plugin.allocate, or ''."""
    roots = [s["name"] for s in spans if not s.get("parent_id")]
    ids = {s["span_id"] for s in spans}
    by_id = {s["span_id"]: s for s in spans}
    if roots != ["admission"] or any(s["parent_id"] not in ids for s in spans if s["parent_id"]):
        return f"roots {roots}, orphans {[s['name'] for s in spans if s['parent_id'] and s['parent_id'] not in ids]}"
    alloc = [s for s in spans if s["name"] == "plugin.allocate"]
    if not alloc or by_id[alloc[0]["parent_id"]]["name"] != "extender.bind":
        return "plugin.allocate is not under extender.bind"
    if by_id[[s for s in spans if s["name"] == "extender.bind"][0]["parent_id"]]["name"] != "admission":
        return "extender.bind is not under admission"
    lines = out.splitlines()
    order = [next((i for i, ln in enumerate(lines) if key in ln), -1)
             for key in ("admission", "extender.bind", "plugin.allocate")]
    if -1 in order or order != sorted(order) or sum(ln.startswith("admission") for ln in lines) != 1:
        return f"the render's order {order}: {out[:800]}"
    return ""


def extender_admission(tmp: str, api, card_units: int, fail: list) -> dict:
    """Phase 25 (a): the port's extender and daemon, two processes, one
    admission of 16 pods from the webhooks to the env."""
    from concurrent import futures

    from gpushare_device_plugin_tpu_torch.extender import simcluster

    node_names, share = extender_seed_cluster(api, card_units)
    report: dict = {"pods": len(api.pods), "nodes": len(api.nodes)}
    port, m1, m2 = free_port(), free_port(), free_port()
    ext, ext_log = extender_child(
        tmp, "extender", "gpushare_device_plugin_tpu_torch.extender.server", "--port",
        str(port), "--host", "127.0.0.1", "--metrics-port", str(m1), "--checkpoint-path",
        os.path.join(tmp, "extender-wal.ckpt"))
    daemon = None
    plugin_dir = os.path.join(tmp, "plugins")
    os.makedirs(plugin_dir)
    kubelet, kubelet_server = cluster_kubelet(plugin_dir)
    try:
        report["extender_ready_s"] = wait_http(f"http://127.0.0.1:{m1}/readyz", 20, ext)
        daemon = ClusterDaemon(tmp, "daemon", kubelet, "--reconcile-interval", "0.5",
                               "--metrics-port", str(m2))
        url = f"http://127.0.0.1:{port}/scheduler"
        nodes = [api.nodes[n] for n in node_names]
        ms: dict[str, list] = {"filter": [], "prioritize": [], "bind": []}
        for name, _ in share:
            pod = api.pods[("default", name)]
            got, t = post_json(f"{url}/filter", {"pod": pod, "nodes": {"items": nodes}})
            ms["filter"].append(t)
            fits = got.get("nodenames") or []
            refused = sorted((got.get("failedNodes") or {}))
            if fits != [CLUSTER_NODE] or len(refused) != CLUSTER_NODES - 1:
                fail.append(f"(a) filter of {name}: fits {fits}, {len(refused)} refused")
            scores, t = post_json(f"{url}/prioritize", {
                "pod": pod, "nodes": {"items": [api.nodes[n] for n in fits]}})
            ms["prioritize"].append(t)
            top = max(scores, key=lambda e: e["score"])["host"] if scores else ""
            out, t = post_json(f"{url}/bind", {"podName": name, "podNamespace": "default",
                                               "podUID": pod["metadata"]["uid"], "node": top})
            ms["bind"].append(t)
            if out != {"error": ""}:
                fail.append(f"(a) bind of {name} to {top!r}: {out}")
        report["verb_ms"] = {v: {"p50": ceil_rank_quantile(x, 0.5), "p99": ceil_rank_quantile(x, 0.99),
                                 "n": len(x)} for v, x in ms.items()}
        bound = {n: api.pods[("default", n)]["spec"].get("nodeName") for n, _ in share}
        if set(bound.values()) != {CLUSTER_NODE}:
            fail.append(f"(a) pods bound elsewhere: {bound}")
        assumed = {n: dict(api.pods[("default", n)]["metadata"]["annotations"]) for n, _ in share}
        slices, at = [], 0
        for _, units in share:
            slices.append(daemon.mem_ids[at:at + units])
            at += units

        def timed_allocate(ids):
            t = time.perf_counter()
            envs = daemon.allocate(ids)
            return envs, (time.perf_counter() - t) * 1e3

        with futures.ThreadPoolExecutor(CLUSTER_WORKERS) as pool:
            results = list(pool.map(timed_allocate, slices))
        alloc_ms = [m for _, m in results]
        report["allocate_ms"] = {"p50": ceil_rank_quantile(alloc_ms, 0.5),
                                 "p99": ceil_rank_quantile(alloc_ms, 0.99)}
        granted = sorted((e.get(const.ENV_MEM_IDX), e.get(const.ENV_MEM_POD)) for e, _ in results)
        wrote = sorted((a.get(const.ENV_MEM_IDX), a.get(const.ENV_MEM_POD))
                       for a in assumed.values())
        if granted != wrote or any(i != "0" for i, _ in granted):
            fail.append(f"(a) the envs' (card, units) {granted} are not the extender's {wrote}")
        unassigned = [n for n, _ in share if api.pods[("default", n)]["metadata"][
            "annotations"].get(const.ENV_ASSIGNED_FLAG) != "true"]
        if unassigned:
            fail.append(f"(a) pods not assigned: {unassigned}")
        violations = simcluster.audit_cluster(list(api.nodes.values()), list(api.pods.values()))
        report["audit"] = violations
        if violations:
            fail.append(f"(a) audit: {violations[:3]}")
        first = share[0][0]
        urls = ("--traces-url", f"http://127.0.0.1:{m1}", "--traces-url", f"http://127.0.0.1:{m2}")
        text = inspect_child(tmp, "trace", f"default/{first}", *urls)
        doc = inspect_child(tmp, "trace", f"default/{first}", *urls, "-o", "json")
        report["trace"] = text["out"]
        report["inspect_child_s"] = [text["seconds"], doc["seconds"]]
        why = ("inspect failed" if text["rc"] or doc["rc"] or text["torch"] or doc["torch"]
               else check_trace_tree(text["out"], json.loads(doc["out"])))
        if why:
            fail.append(f"(a) inspect trace: {why} {text['err']}{doc['err']}")
        report["daemon"] = daemon.finish()
        if report["daemon"]["exit"] != 0 or report["daemon"]["torch_mapped"]:
            fail.append(f"(a) the daemon: {report['daemon']}")
        report["extender_exit"] = stop_child(ext)
        if report["extender_exit"] != 0:
            fail.append(f"(a) the extender exited {report['extender_exit']} on SIGTERM")
        report["extender_torch"] = torch_imported(ext_log)
        if report["extender_torch"]:
            fail.append(f"(a) the extender imported {report['extender_torch'][:3]}")
    finally:
        for proc in (ext, daemon.proc if daemon else None):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
        kubelet_server.stop(0)
        if fail:
            fail.append("extender log: " + open(ext_log).read()[-1500:])
    return report


def extender_scale(tmp: str, fake, fail: list, label: str, *, nodes: int, shards: int,
                   fanout: int, workers: int, events: int, gang_every: int, seed: int,
                   witness: bool) -> dict:
    """Phase 25 (b): the sharded extender in process over ``nodes``
    ``make_cluster`` nodes, each shard with its own WAL, driven by the
    churn simulator; ``witness`` creates every lock under the lock-order
    witness."""
    from gpushare_device_plugin_tpu_torch.allocator.checkpoint import AllocationCheckpoint
    from gpushare_device_plugin_tpu_torch.cluster.apiserver import ApiServerClient
    from gpushare_device_plugin_tpu_torch.cluster.informer import PodInformer
    from gpushare_device_plugin_tpu_torch.extender import simcluster
    from gpushare_device_plugin_tpu_torch.extender.shards import (
        LeaderLease,
        ShardExtender,
        ShardRouter,
        resolve_gang2pc,
    )
    from gpushare_device_plugin_tpu_torch.utils import lockrank

    lockrank.set_witness(witness)
    lockrank.reset_violations()
    logging.disable(logging.WARNING)  # the churn's refused binds, one line each
    api = fake.FakeApiServer(chaos=False)
    catalog = simcluster.make_cluster(nodes, seed=seed)
    for n in catalog:
        api.nodes[n["metadata"]["name"]] = n
    api.start()
    informer = None
    try:
        client = ApiServerClient(api.url)
        t = time.perf_counter()
        informer = PodInformer(client).start(sync_timeout_s=60)
        members = [ShardExtender(f"shard-{i}", client, informer=informer,
                                 checkpoint=AllocationCheckpoint(
                                     os.path.join(tmp, f"{label}-shard-{i}.wal")))
                   for i in range(shards)]
        lease = LeaderLease()
        router = ShardRouter(members, fanout=fanout, lease=lease)
        router.set_nodes(catalog)
        setup_s = time.perf_counter() - t
        driver = simcluster.ChurnDriver(
            create_pod_fn=api.add_pod, delete_pod_fn=api.delete_pod, admit_fn=router.admit,
            admit_gang_fn=router.admit_gang_group, seed=seed, gang_every=gang_every,
            workers=workers)
        stats = driver.run(events)
        pods = client.list_pods()
        violations = simcluster.audit_cluster(catalog, pods)
        resolved = resolve_gang2pc(members, client, lease=lease)
        pending = sum(len(s.twopc_pending()) for s in members)
        found = lockrank.violations()
        report = {"nodes": nodes, "shards": shards, "fanout": fanout, "workers": workers,
                  "events": events, "gang_every": gang_every, "seed": seed,
                  "lock_witness": witness, "setup_s": setup_s, "run_s": stats.wall_s,
                  **simcluster.summarize(stats), "audit": violations[:5],
                  "gang2pc_resolve": resolved, "gang2pc_pending_after": pending,
                  "lock_violations": len(found)}
        if violations:
            fail.append(f"(b) {label}: audit {violations[:3]}")
        if pending:
            fail.append(f"(b) {label}: {pending} gang2pc entries left after resolve_gang2pc")
        if stats.gang_groups <= 0 or stats.admitted <= 0:
            fail.append(f"(b) {label}: nothing admitted or no gang group: "
                        f"{simcluster.summarize(stats)}")
        if found:
            fail.append(f"(b) {label}: lock order {found[0].brief()}")
        return report
    finally:
        if informer is not None:
            informer.stop()
        api.stop()
        lockrank.set_witness(None)
        lockrank.reset_violations()
        logging.disable(logging.NOTSET)


def extender_router(tmp: str, fake, fail: list) -> dict:
    """Phase 25 (c): the shard router's process killed in a cross-shard gang
    bind, and a second one on the same WALs."""
    from gpushare_device_plugin_tpu_torch.extender import simcluster
    from gpushare_device_plugin_tpu_torch.extender.shards import HashRing

    api = fake.FakeApiServer(chaos=False)
    ring, nodes, i = HashRing([f"shard-{i}" for i in range(ROUTER_SHARDS)]), {}, 0
    while len(nodes) < ROUTER_SHARDS:  # one whole-node "2x1" slice a shard
        name = f"xsn-{i:04d}"
        i += 1
        nodes.setdefault(ring.owner(name), simcluster.synth_node(name, "2x1", 2, 32))
    for n in nodes.values():
        api.nodes[n["metadata"]["name"]] = n
    members = [f"{ROUTER_GROUP}-m{m}" for m in range(2)]
    for name in members:
        api.add_pod(cluster_pod(name, "", 64, annotations={
            const.ANN_GANG_SHAPE: "2x1", const.ANN_GANG_GROUP: ROUTER_GROUP}))
    api.start()
    wal_dir = os.path.join(tmp, "router-wals")
    report: dict = {}
    procs = []
    try:
        kc = os.path.join(tmp, "kubeconfig.json")
        with open(kc, "w") as f:
            json.dump({"current-context": "fake",
                       "contexts": [{"name": "fake", "context": {"cluster": "fake"}}],
                       "clusters": [{"name": "fake", "cluster": {"server": api.url}}]}, f)
        argv = ["--shards", str(ROUTER_SHARDS), "--checkpoint-dir", wal_dir, "--port",
                str(free_port()), "--host", "127.0.0.1", "--metrics-port", str(free_port())]
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(KUBECONFIG=kc, HOME=tmp, TPUSHARE_FAULTS="gang2pc.commit=crash:1")
        t = time.perf_counter()
        first = subprocess.Popen(
            [sys.executable, "-c", ROUTER_CHILD, json.dumps([argv, members, len(nodes)])],
            cwd=os.path.dirname(os.path.abspath(__file__)), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        procs.append(first)
        lines = []
        while first.poll() is None and time.perf_counter() - t < 30:
            line = first.stdout.readline()
            lines.append(line)
            if line.startswith(("CRASHED", "NO-CRASH")):
                break
        report["crash"] = lines[-1].strip() if lines else ""
        report["crash_s"] = time.perf_counter() - t
        if not report["crash"].startswith("CRASHED"):
            fail.append(f"(c) the router did not crash at gang2pc.commit: {''.join(lines)[-1500:]}")
        first.kill()
        first.wait()
        journal = [json.loads(line) for w in sorted(os.listdir(wal_dir))
                   for line in open(os.path.join(wal_dir, w)).read().splitlines() if line.strip()]
        report["wal_records"] = len(journal)
        before = [bool(api.pods[("default", m)]["metadata"].get("annotations", {}).get(
            const.ENV_GANG_CHIPS)) for m in members]
        report["members_bound_at_crash"] = before
        m2 = free_port()
        second, log2 = extender_child(
            tmp, "router", "gpushare_device_plugin_tpu_torch.extender.shards", "--shards",
            str(ROUTER_SHARDS), "--checkpoint-dir", wal_dir, "--port", str(free_port()),
            "--host", "127.0.0.1", "--metrics-port", str(m2))
        procs.append(second)
        report["restart_ready_s"] = wait_http(f"http://127.0.0.1:{m2}/readyz", 20, second)
        doc = {}
        t = time.perf_counter()
        while time.perf_counter() - t < 10:  # the catalog refresh has run
            doc = json.loads(scrape(f"http://127.0.0.1:{m2}/shards"))
            if sum(doc["ring"]["nodes_per_shard"].values()) == len(nodes):
                break
            time.sleep(0.05)
        report["gangs_2pc_after"] = doc.get("gangs_2pc")
        after = [bool(api.pods[("default", m)]["metadata"].get("annotations", {}).get(
            const.ENV_GANG_CHIPS)) for m in members]
        report["members_bound_after"] = after
        # the decision was durable before the crash: the group rolls forward
        if doc.get("gangs_2pc") or not all(after):
            fail.append(f"(c) after the restart: gangs in flight {doc.get('gangs_2pc')}, "
                        f"members bound {after} (at the crash {before})")
        violations = simcluster.audit_cluster(list(nodes.values()), list(api.pods.values()))
        if violations:
            fail.append(f"(c) audit: {violations[:3]}")
        shown = inspect_child(tmp, "shards", "--shards-url", f"http://127.0.0.1:{m2}")
        report["inspect_shards"] = shown["out"]
        if (shown["rc"] or shown["torch"]
                or f"shard map — {ROUTER_SHARDS} shard(s)" not in shown["out"]):
            fail.append(f"(c) inspect shards: rc {shown['rc']}, torch {shown['torch'][:3]}: "
                        f"{shown['out']}{shown['err']}")
        report["router_exit"] = stop_child(second)
        report["router_torch"] = torch_imported(log2)
        if report["router_exit"] != 0 or report["router_torch"]:
            fail.append(f"(c) the router exited {report['router_exit']}, imported "
                        f"{report['router_torch'][:3]}: {open(log2).read()[-1500:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        api.stop()
    return report


def phase_extender() -> dict:
    """Phase 25: the port's scheduler extender on the card's machine, host
    only. Returns the report."""
    print("phase 25: the scheduler extender (webhooks to env, the sharded router at "
          "1,000 nodes, the router's crash and restart)", flush=True)
    t_phase = time.perf_counter()
    fake = load_fake_apiserver()
    card_units = card_gib()
    fail: list[str] = []
    report: dict = {"card": smi_line()}
    with tempfile.TemporaryDirectory() as tmp:
        api = fake.FakeApiServer()
        api.start()
        try:
            with open(os.path.join(tmp, "kubeconfig.json"), "w") as f:
                json.dump({"current-context": "fake",
                           "contexts": [{"name": "fake", "context": {"cluster": "fake"}}],
                           "clusters": [{"name": "fake", "cluster": {"server": api.url}}]}, f)
            t = time.perf_counter()
            report["a"] = extender_admission(tmp, api, card_units, fail)
            report["a"]["seconds"] = time.perf_counter() - t
        finally:
            api.stop()
        t = time.perf_counter()
        report["b"] = extender_scale(
            tmp, fake, fail, "scale", nodes=SCALE_NODES, shards=SCALE_SHARDS,
            fanout=SCALE_FANOUT, workers=SCALE_WORKERS, events=SCALE_EVENTS,
            gang_every=SCALE_GANG_EVERY, seed=SCALE_SEED, witness=False)
        report["b"]["seconds"] = time.perf_counter() - t
        t = time.perf_counter()
        report["b_witnessed"] = extender_scale(tmp, fake, fail, "witnessed", **WITNESSED_DRILL,
                                               witness=True)
        report["b_witnessed"]["seconds"] = time.perf_counter() - t
        t = time.perf_counter()
        report["c"] = extender_router(tmp, fake, fail)
        report["c"]["seconds"] = time.perf_counter() - t
    report["seconds"] = time.perf_counter() - t_phase
    if report["seconds"] >= EXTENDER_BUDGET_S:
        fail.append(f"the phase took {report['seconds']:.2f} s, not under {EXTENDER_BUDGET_S}")
    print("  phase 25", json.dumps(report, default=str), flush=True)
    if fail:
        raise SystemExit("phase 25 failed: " + "; ".join(fail))
    return report


# Phase 24: a live defragmentation move of a serving pod's slice.
DEFRAG_LAYERS = 4  # phase 2's weights cut to their first 4 layers
DEFRAG_SLICE_UNITS = 8
DEFRAG_NODE = "h100-defrag-node"
DEFRAG_TRACE = dict(seed=24, rate=0.5, prompt_lens=(128, 512), max_new=(32, 64))
DEFRAG_REQUESTS = 8
DEFRAG_DRAIN_TICK = 60  # the move starts this far into the serving run
# (label, the fault site the mover dies at or None, rolled forward)
DEFRAG_MOVES = (("clean", None, True), ("rolled forward", "defrag.switch", True),
                ("rolled back", "defrag.copy", False))


# ranks phase 24 must take under the witness: the drain handshake's lock
# (mover and serving thread) and the radix cache's (the engines' prefix tree)
DEFRAG_WITNESSED_RANKS = ("serving.drain", "serving.radix")


def phase_defrag(params, cfg) -> tuple[dict, dict]:
    """Phase 24 under the port's lock-order witness: :func:`defrag_moves`
    with ``lockrank.set_witness(True)`` from before its engines and locks
    are made to its end, in bf16 and then (d) int8. Fails on any of the
    moves' failures, on any lock-order violation, or unless the ranks of
    DEFRAG_WITNESSED_RANKS were acquired. Returns the launches of the moves
    by path (``defrag``, ``int8_defrag``) and the phase's report, which
    gains ``int8`` (the (d) move's) and ``witness``: the violations counted
    and the ranks acquired."""
    from gpushare_device_plugin_tpu_torch.utils import lockrank

    lockrank.set_witness(True)
    lockrank.reset_violations()
    try:
        launches, report, fail = defrag_moves(params, cfg)
        int8_launches, report["int8"], int8_fail = defrag_moves(params, cfg, int8=True)
        fail += int8_fail
        found = lockrank.violations()
        ranks = lockrank.acquired_ranks()
    finally:
        lockrank.set_witness(None)
        lockrank.reset_violations()
    report["witness"] = {"violations": len(found), "ranks_acquired": ranks}
    print("  phase 24 witness", json.dumps(report["witness"]), flush=True)
    fail += [f"lock-order violation: {v.brief()}" for v in found]
    missing = [name for name in DEFRAG_WITNESSED_RANKS if name not in ranks]
    if missing:
        fail.append(f"the witness saw no acquire of {missing}")
    if fail:
        raise SystemExit("phase 24 failed: " + "; ".join(fail))
    return {"defrag": launches, "int8_defrag": int8_launches}, report


def defrag_moves(params, cfg, int8: bool = False) -> tuple[dict, dict, list[str]]:
    """Phase 24's moves, on phase 2's weights cut to their first
    DEFRAG_LAYERS layers: a serving pod's slice moved by the port's
    ``SliceMover`` three times (clean, crashed past the switch and rolled
    forward, crashed before it and rolled back). ``int8``: (d), one clean
    move of a slice serving ``quantize_decoder``'s tree with an int8 KV
    cache. Returns the launches of the moves, the phase's report and what
    failed.

    The fake apiserver's node lists two cards, 0 and 1, and both are the
    one H100: a move across cards needs two, as phase 20's gang env does,
    so the destination engine is a second ``PagedSlotEngine`` on the same
    card, each sized by the plugin env of its slice."""
    from gpushare_device_plugin_tpu_torch.allocator import defrag as TD
    from gpushare_device_plugin_tpu_torch.allocator.assume import AssumeCache
    from gpushare_device_plugin_tpu_torch.allocator.checkpoint import (
        AllocationCheckpoint,
        replay_checkpoint,
    )
    from gpushare_device_plugin_tpu_torch.cluster.apiserver import ApiServerClient
    from gpushare_device_plugin_tpu_torch.cluster.podsource import ApiServerPodSource
    from gpushare_device_plugin_tpu_torch.cluster.reconciler import DriftReconciler
    from gpushare_device_plugin_tpu_torch.utils.faults import FAULTS, SimulatedCrash

    if int8:
        print(f"phase 24 (d): live defragmentation of a slice serving the int8 llama3_8b "
              f"({DEFRAG_LAYERS} of 32 layers, int8 KV), moved clean", flush=True)
    else:
        print(f"phase 24: live defragmentation of a serving llama3_8b slice ({DEFRAG_LAYERS} of "
              "32 layers, bf16), moved clean, rolled forward and rolled back", flush=True)
    t_phase = time.perf_counter()
    fail: list[str] = []
    cfg = dataclasses.replace(cfg, n_layers=DEFRAG_LAYERS)
    params = {**params, "layers": {k: v[:DEFRAG_LAYERS] for k, v in params["layers"].items()}}
    kv, moves, tag = (None, DEFRAG_MOVES, "")
    if int8:
        params = Q.quantize_decoder(params)
        kv, moves, tag = "int8", DEFRAG_MOVES[:1], "int8 "
    card_units = card_gib()
    pod_env = PodTpuEnv.from_env(plugin_env(DEFRAG_SLICE_UNITS))
    plan = paged_plan_from_pod_env(cfg, 2048, weight_bytes=Q.param_bytes(params), page_size=16,
                                   prefill_chunk=512, env=pod_env, slots=8, kv_dtype=kv)
    geo = dict(slots=8, total_pages=plan.total_pages, max_len=2048, prefill_chunk=512,
               page_size=16, eos_id=EOS_ID, kv_dtype=kv)
    src, dst = PagedSlotEngine(params, cfg, **geo), PagedSlotEngine(params, cfg, **geo)
    src.warmup()
    dst.warmup()
    trace = poisson_trace(DEFRAG_REQUESTS, vocab=cfg.vocab, **DEFRAG_TRACE)
    by_rid = {r.rid: r for r in trace}
    ref = {r.rid: list(r.tokens) for r in src.run(trace).results}
    report: dict = {"plan": {"slots": plan.slots, "total_pages": plan.total_pages},
                    "moves": []}
    prefills: list[int] = []
    program = dst._prefill

    def counted(*args):
        prefills.append(1)
        return program(*args)

    dst._prefill = counted
    fake = load_fake_apiserver()
    api = fake.FakeApiServer()
    cap = {const.RESOURCE_MEM: str(2 * card_units), const.RESOURCE_COUNT: "2"}
    api.add_node(DEFRAG_NODE, capacity=cap)
    api.start()
    units_by_index = lambda: {0: card_units, 1: card_units}  # noqa: E731
    solos: dict = {}
    launches = {name: 0 for name in fa.LAUNCHES}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for i, (label, site, forward) in enumerate(moves):
                label, name = tag + label, f"serve-{tag.strip() or 'bf16'}-{i}"
                api.add_pod(cluster_pod(
                    name, DEFRAG_NODE, DEFRAG_SLICE_UNITS, phase="Running", created=i,
                    annotations={**assumed_on_card0(DEFRAG_SLICE_UNITS, card_units),
                                 const.ENV_ASSIGNED_FLAG: "true"},
                    labels={const.LABEL_RESOURCE_KEY: const.LABEL_RESOURCE_VALUE}))
                wal = os.path.join(tmp, f"wal-{i}.ckpt")
                times = {"drain_s": 0.0, "restore_s": 0.0}
                restored: list = []
                drained: list = []

                def drain(key):
                    t = time.perf_counter()
                    src.request_drain()
                    snap = src.wait_drained(timeout=60)
                    times["drain_s"] = time.perf_counter() - t
                    drained.append(snap)
                    return snap

                def restore(key, snap, times=times, restored=restored,
                            profiled=i == 0 and not int8):
                    t = time.perf_counter()
                    before = len(prefills)
                    for n in fa.LAUNCHES:
                        fa.LAUNCHES[n] = 0
                    # the first move's restore runs under the profiler for
                    # its kernel seconds (which slows its host seconds)
                    if profiled:
                        rest, busy = busy_share(lambda: dst.restore_snapshot(snap))
                    else:
                        rest, busy = dst.restore_snapshot(snap), None
                    torch.cuda.synchronize()
                    got = dict(fa.LAUNCHES)
                    for n, v in got.items():
                        launches[n] += v
                    times["restore_s"] = time.perf_counter() - t
                    times["restore_device_s"] = (busy or {}).get("kernel_s")
                    times["restore_prefills"] = len(prefills) - before
                    times["restore_flash_fwd"] = got["flash_fwd"]
                    restored.append((snap, rest))

                client = ApiServerClient(api.url)
                source = ApiServerPodSource(client, DEFRAG_NODE)
                ckpt = AllocationCheckpoint(wal)
                assume = AssumeCache()
                mover = TD.SliceMover(client, source, assume, ckpt, DEFRAG_NODE, units_by_index,
                                      drain_fn=drain, restore_fn=restore)
                served: dict = {}
                src.ticks = 0  # the last run's count; the new run restarts it
                thread = threading.Thread(target=lambda: served.update(part=src.run(trace)),
                                          name="serving", daemon=True)
                thread.start()
                while src.ticks < DEFRAG_DRAIN_TICK and thread.is_alive():
                    time.sleep(0.001)
                t_move = time.perf_counter()
                move = TD.MovePlan(pod=("default", name), src=0, dst=1, units=DEFRAG_SLICE_UNITS)
                outcome = None
                if site is None:
                    outcome = "completed" if mover.execute(move) else "aborted"
                else:
                    try:
                        with FAULTS.injected(site, "crash", times=1):
                            mover.execute(move)
                    except SimulatedCrash:
                        pass
                    ckpt.abandon()  # the process died: nothing flushed or closed
                    ckpt = AllocationCheckpoint(wal)
                    assume = AssumeCache()
                    replay_checkpoint(ckpt, assume)
                    drift = DriftReconciler(api=client, pod_source=source, assume=assume,
                                            checkpoint=ckpt, node_name=DEFRAG_NODE,
                                            move_restore_fn=restore).reconcile_once()
                    outcome = next(iter(drift), None)
                move_s = time.perf_counter() - t_move
                thread.join(timeout=120)
                part = served.get("part")
                snap = drained[0] if drained else None
                if thread.is_alive() or part is None or not snap or not snap.get("requests"):
                    fail.append(f"{label}: the source did not drain mid-run")
                    continue
                if not forward:
                    # rolled back: the workload never left the source, whose
                    # own supervisor re-serves the snapshot it drained
                    if restored:
                        fail.append(f"{label}: a rolled-back move restored on the destination")
                    t = time.perf_counter()
                    rest = src.restore_snapshot(snap)
                    torch.cuda.synchronize()
                    times["restore_s"] = time.perf_counter() - t
                    restored.append((snap, rest))
                elif len(restored) != 1:
                    fail.append(f"{label}: {len(restored)} restores on the destination, not 1")
                    continue
                journaled, rest = restored[0]
                again = dst.restore_snapshot(journaled) if forward else None
                if again is not None and again.results:
                    fail.append(f"{label}: a repeated delivery served {len(again.results)} "
                                "requests")
                pre = {r.rid: list(r.tokens) for r in part.results}
                post = {r.rid: list(r.tokens) for r in rest.results}
                if set(pre) & set(post) or sorted({**pre, **post}) != sorted(ref):
                    fail.append(f"{label}: requests lost or served twice "
                                f"({len(pre)} before the drain, {len(post)} restored)")
                diverged = []
                for rid, toks in {**pre, **post}.items():
                    diverged += check_vs_solo("phase 24", params, cfg, by_rid[rid], toks,
                                              want=ref.get(rid), solos=solos, kv_dtype=kv)
                pod = client.get_pod("default", name)
                ann = pod["metadata"]["annotations"]
                want_idx = "1" if forward else "0"
                mem_used, _held = source.chip_state()
                if ann.get(const.ENV_MEM_IDX) != want_idx:
                    fail.append(f"{label}: the pod's annotation names card "
                                f"{ann.get(const.ENV_MEM_IDX)}, not {want_idx}")
                if forward and mem_used.get(1, 0) < DEFRAG_SLICE_UNITS:
                    fail.append(f"{label}: the ledger {mem_used} does not count card 1")
                if ckpt.pending() or any(assume.snapshot()):
                    fail.append(f"{label}: the WAL holds {list(ckpt.pending())}, the ledger "
                                f"{assume.snapshot()}")
                if forward and not (times.get("restore_flash_fwd") ==
                                    DEFRAG_LAYERS * times.get("restore_prefills", 0) > 0):
                    fail.append(f"{label}: the restore's flash_fwd launches "
                                f"{times.get('restore_flash_fwd')} are not {DEFRAG_LAYERS} x "
                                f"{times.get('restore_prefills')} prefill dispatches")
                ckpt.close()
                want_outcome = {"clean": "completed", "rolled forward": "move_rollforward",
                                "rolled back": "move_rollback"}[label[len(tag):]]
                if outcome != want_outcome:
                    fail.append(f"{label}: the move ended {outcome!r}, not {want_outcome!r}")
                row = {"move": label, "crash_site": site, "outcome": outcome,
                       "drain_tick": snap.get("drain_tick"), "retired_before_drain": len(pre),
                       "restored_requests": len(post), "host_s": move_s,
                       "drain_s": times["drain_s"],
                       "wal_patch_s": move_s - times["drain_s"] - (
                           times["restore_s"] if forward else 0.0),
                       "restore_s": times["restore_s"], "restore_profiled": i == 0 and not int8,
                       "restore_device_s": times.get("restore_device_s"),
                       "restore_prefills": times.get("restore_prefills"),
                       "restore_flash_fwd": times.get("restore_flash_fwd"),
                       "card": ann.get(const.ENV_MEM_IDX), "diverged_at_near_ties": diverged}
                report["moves"].append(row)
                print("  move", json.dumps(row), flush=True)
    finally:
        api.stop()
        del dst._prefill
    if dst.allocator.used_pages != dst.radix.cached_pages:
        fail.append(f"destination pages leaked: {dst.allocator.used_pages} used, "
                    f"{dst.radix.cached_pages} cached")
    report["launches"] = launches
    report["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 24{' (d)' if int8 else ''}",
          json.dumps({k: v for k, v in report.items() if k != "moves"}), flush=True)
    del src, dst
    torch.cuda.empty_cache()
    return launches, report, fail


# Phase 27: quantized serving. (a) is the reference bench's bench_serve
# (bench_mfu.py:460-557) at full width and depth on phase 2's bf16 weights:
# int8 prefill logits against bf16's (its gate: rel-L2 <= 0.1), then
# make_generate for four precisions at batch 1 and 8 on 2,048-token prompts,
# each wall held to bench_serve's weight-stream roofline guard at the H100
# SXM's HBM rate. bench_serve decodes 128 tokens and times 5 runs after a
# warm-up; here 32 tokens and one timed run after a warm-up of 2 tokens
# (the same programs; nothing compiles), for the script's time limit.
# (b) is the product the plugin sells: the 8B served as int8 from a 16-GiB
# slice, which refuses the bf16 tree. A child with only the plugin's env
# draws and quantizes its own weights (never the whole bf16 tree, which
# the slice cannot hold), sizes the int8 paged pool from the env and
# serves SERVE_TRACE's first requests at 32 layers inside its cap.
QUANT_TP = 2048
QUANT_MAX_NEW = 32
QUANT_WARMUP_NEW = 2
QUANT_BATCHES = (1, 8)
QUANT_GATE_REL_L2 = 0.1
QUANT_ROOFLINE_SLACK = 1.25  # a wall may beat max_new weight streams by no more
QUANT_PRECISIONS = (("bf16", False, None), ("int8", True, None), ("bf16_kv8", False, "int8"),
                    ("int8_kv8", True, "int8"))  # (label, int8 weights, kv_dtype)
QUANT_POD_UNITS = 16
QUANT_POD_SEED = 27
QUANT_POD_REQUESTS = 8  # SERVE_TRACE's first 8
QUANT_GEO = dict(max_len=2048, prefill_chunk=512, page_size=16)
# The reference's plan for the int8 8B at QUANT_GEO in a 16-GiB slice
# (tests/test_torch_pod_sizing.py holds the port's to it, from byte counts).
QUANT_POD_SLOTS, QUANT_POD_PAGES = 212, 6864


def drawn_int8_decoder(cfg, gen) -> dict:
    """``quantize_decoder(init_params(cfg, gen, dtype=torch.bfloat16))``,
    drawn a leaf at a time: the same draws in the same order, each leaf
    quantized (``quant.quantize_leaf``) and dropped before the next is
    drawn, so the whole bf16 tree never exists."""
    shapes = T.param_shapes(cfg)

    def leaf(name, shape, fan_in):
        w = torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
        return Q.quantize_leaf(name, w.mul_(1.0 / math.sqrt(fan_in)))

    def ones(shape):
        return torch.ones(shape, dtype=torch.float32, device="cuda")

    d = cfg.d_model
    embed = leaf("embed", shapes["embed"], d)
    layers = {name: leaf(name, shapes["layers"][name], cfg.d_ff if name == "wdown" else d)
              for name in ("wq", "wkv", "wo", "wi", "wdown")}
    layers.update(ln1=ones(shapes["layers"]["ln1"]), ln2=ones(shapes["layers"]["ln2"]))
    return {"embed": embed, "layers": layers, "final_norm": ones(shapes["final_norm"]),
            "out": leaf("out", shapes["out"], d)}


def moved(tree, device):
    """A tree of dicts of tensors with every tensor moved to ``device``."""
    if isinstance(tree, dict):
        return {key: moved(val, device) for key, val in tree.items()}
    return tree.to(device)


def own_peak_gb(held: int) -> float:
    """Peak allocated since the last reset, less ``held`` bytes."""
    return round((torch.cuda.max_memory_allocated() - held) / 1e9, 3)


def quant_serve(params, cfg) -> tuple[dict, dict]:
    """Phase 27 (a); returns its report and the launches of its generate
    runs (warm-ups and timed runs, every precision and batch)."""
    print("phase 27 (a): bench_serve, llama3_8b (32 layers): bf16, int8, bf16_kv8, int8_kv8",
          flush=True)
    fail = []
    # Earlier phases' reference cycles, collected in the middle of a run,
    # would free memory under its peak and turn its own peak negative.
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    q = Q.quantize_decoder(params)
    torch.cuda.synchronize()
    rep = {"quantize_s": round(time.perf_counter() - t0, 3),
           "param_bytes_bf16": Q.param_bytes(params), "param_bytes_int8": Q.param_bytes(q)}
    rep["quantize_own_peak_gb"] = own_peak_gb(held + rep["param_bytes_int8"])
    rep["hbm_saving_x"] = round(rep["param_bytes_bf16"] / rep["param_bytes_int8"], 3)
    # A stacked quantize of layers 0-1 and a whole-leaf one of the head: the
    # scales reduce over the contraction axes only (wi [L, d, 2, F] over d,
    # out [d, V] over d), so slicing by layer or by column changes no code.
    for name, whole, got in (
        ("wi", Q.quantize(params["layers"]["wi"][:2], (1,)),
         {k: v[:2] for k, v in q["layers"]["wi"].items()}),
        ("out", Q.quantize(params["out"], (0,)), q["out"]),
    ):
        if not all(torch.equal(whole[k], got[k]) for k in ("q8", "scale")):
            fail.append(f"the sliced quantize of {name} differs from the whole-leaf one")
        del whole, got
    # The one-pass dequantize rounds the f32 product as it stores it: the
    # reference's two-pass values, bit for bit, on the card's cast path.
    if not torch.equal(Q.dequantize(q["out"], torch.bfloat16),
                       (q["out"]["q8"].float() * q["out"]["scale"]).to(torch.bfloat16)):
        fail.append("dequantize differs from (q8.float() * scale).to(bf16) on the head")
    bmax = max(QUANT_BATCHES)
    for label, kv in (("bf16", None), ("int8", "int8")):
        rep[f"kv_cache_bytes_{label}"] = bmax * kv_slot_bytes(cfg, QUANT_TP + QUANT_MAX_NEW, kv)
    print("  bytes", json.dumps(rep), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(7)
    prompt = torch.randint(0, cfg.vocab, (1, QUANT_TP), generator=gen, device="cuda")
    logits = {}
    for label, p in (("bf16", params), ("int8", q)):
        cache = G.init_cache(cfg, 1, QUANT_TP + QUANT_MAX_NEW)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        logits[label], _ = G.prefill(p, prompt, cache, cfg)
        torch.cuda.synchronize()
        rep[f"prefill_own_peak_gb_{label}"] = own_peak_gb(before)
        del cache
    lo16, lo8 = logits["bf16"].double(), logits["int8"].double()
    norm = float(torch.linalg.vector_norm(lo16))
    rel_l2 = float(torch.linalg.vector_norm(lo8 - lo16)) / max(norm, 1e-30)
    rep["logits_rel_l2"] = rel_l2
    rep["argmax_match"] = bool(torch.argmax(lo8, -1)[0] == torch.argmax(lo16, -1)[0])
    print(f"  int8 prefill logits against bf16: rel-L2 {rel_l2} (gate {QUANT_GATE_REL_L2}), "
          f"argmax match {rep['argmax_match']}; the prefill's own peak bf16 "
          f"{rep['prefill_own_peak_gb_bf16']} GB, int8 {rep['prefill_own_peak_gb_int8']} GB",
          flush=True)
    if not rel_l2 <= QUANT_GATE_REL_L2:
        fail.append(f"int8 prefill logits rel-L2 {rel_l2} > {QUANT_GATE_REL_L2}")

    rows = []
    torch.cuda.synchronize()
    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0
    calls = 0
    for batch in QUANT_BATCHES:
        prompt = torch.randint(0, cfg.vocab, (batch, QUANT_TP), generator=gen, device="cuda")
        row = {"batch": batch}
        first = {}
        for label, int8, kv in QUANT_PRECISIONS:
            p, pbytes = (q, rep["param_bytes_int8"]) if int8 else (params,
                                                                     rep["param_bytes_bf16"])
            G.make_generate(cfg, max_new=QUANT_WARMUP_NEW, kv_dtype=kv)(p, prompt)
            run = G.make_generate(cfg, max_new=QUANT_MAX_NEW, kv_dtype=kv)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = run(p, prompt)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            calls += 2
            floor = QUANT_MAX_NEW * pbytes / MEM_BYTES_PER_S
            row[f"{label}_wall_ms"] = wall * 1e3
            row[f"{label}_tokens_per_s"] = batch * QUANT_MAX_NEW / wall
            row[f"{label}_roofline_ms"] = floor * 1e3
            row[f"{label}_own_peak_gb"] = own_peak_gb(before)
            gen_toks = out[:, QUANT_TP:]
            if tuple(out.shape) != (batch, QUANT_TP + QUANT_MAX_NEW) or not bool(
                    ((gen_toks >= 0) & (gen_toks < cfg.vocab)).all()):
                fail.append(f"{label} batch {batch}: output {tuple(out.shape)} out of shape "
                            "or vocabulary")
            if wall < floor / QUANT_ROOFLINE_SLACK:
                fail.append(f"{label} batch {batch}: wall {wall * 1e3:.1f} ms beats the "
                            f"{QUANT_MAX_NEW}-step weight-stream roofline {floor * 1e3:.1f} ms "
                            f"by more than {QUANT_ROOFLINE_SLACK}x")
            first[label] = gen_toks[:, 0]
            del out
        row["int8_speedup"] = row["bf16_wall_ms"] / row["int8_wall_ms"]
        row["first_token_equal_to_bf16"] = {
            label: int((first[label] == first["bf16"]).sum()) for label in first}
        rows.append(row)
        print("  serve", json.dumps(row), flush=True)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    rep["serve"] = rows
    if launches["flash_fwd"] != cfg.n_layers * calls or launches["flash_fwd_scalar"]:
        fail.append(f"launches {launches}: not {cfg.n_layers} flash_fwd for each of {calls} "
                    "prefills")
    del q
    if fail:
        raise SystemExit("phase 27 (a) failed: " + "; ".join(fail))
    return rep, launches


def loaded_int8_decoder(cfg, doc: dict) -> dict:
    """A pod's int8 8B tree (:func:`drawn_int8_decoder` at QUANT_POD_SEED),
    loaded as a pod loads it; adds ``draw_s``, ``weight_bytes``,
    ``draw_peak_reserved_bytes`` and ``load_s`` to ``doc``."""
    t0 = time.perf_counter()
    q = drawn_int8_decoder(cfg, torch.Generator(device="cuda").manual_seed(QUANT_POD_SEED))
    torch.cuda.synchronize()
    doc["draw_s"] = round(time.perf_counter() - t0, 3)
    doc["weight_bytes"] = Q.param_bytes(q)
    doc["draw_peak_reserved_bytes"] = torch.cuda.max_memory_reserved()
    # A pod loads its int8 weights from storage, a leaf at a time, into an
    # empty allocator; a round trip through host memory gives that state.
    # Left where they were drawn, the leaves sit in segments the draw's bf16
    # leaves split, which strand 1.70 GiB of the 15.20 GiB cap on an H100
    # 80GB HBM3.
    t0 = time.perf_counter()
    host = moved(q, "cpu")
    del q
    torch.cuda.empty_cache()
    q = moved(host, "cuda")
    del host
    torch.cuda.synchronize()
    doc["load_s"] = round(time.perf_counter() - t0, 3)
    return q


def quant_pod_main(argv: list[str]) -> int:
    """Phase 27 (b), in a child process whose env is the plugin's for a
    QUANT_POD_UNITS slice: cap the process from the env, check that the
    slice refuses the bf16 tree (``argv = [its bytes, a directory]``),
    draw the int8 tree, size the int8 paged pool from the env, serve,
    profile a step that attends every row (the pool's largest transient,
    inside the peak the cap gate reads), and hold every request to solo
    greedy decode on the same tree and cache, after writing the
    directory's "solo" file (nothing after it is timed). Prints one JSON
    line; exits 3 on an OOM, and through SystemExit on a failed gate."""
    bf16_bytes = int(argv[0])
    settings = configure_torch_from_env()
    fraction = float(settings[MEMORY_FRACTION])
    cap = int(fraction * torch.cuda.get_device_properties(0).total_memory)
    doc = {"slice_gib": PodTpuEnv.from_env().mem_units_container, "fraction": fraction,
           "cap_bytes": cap}
    cfg = llama3_8b()
    fail = []
    try:
        slots_from_pod_env(cfg, QUANT_GEO["max_len"], weight_bytes=bf16_bytes)
        fail.append(f"the slice did not refuse the bf16 tree ({bf16_bytes} bytes)")
    except ValueError as e:
        doc["bf16_refused"] = str(e)
        if "quantize" not in str(e):
            fail.append(f"the bf16 refusal does not say to quantize: {e}")
    try:
        q = loaded_int8_decoder(cfg, doc)
        plan = paged_plan_from_pod_env(cfg, weight_bytes=doc["weight_bytes"], kv_dtype="int8",
                                       **QUANT_GEO)
        doc["plan"] = dataclasses.asdict(plan)
        if (plan.slots, plan.total_pages) != (QUANT_POD_SLOTS, QUANT_POD_PAGES):
            fail.append(f"plan {plan.slots} slots x {plan.total_pages} pages, not the "
                        f"reference's {QUANT_POD_SLOTS} x {QUANT_POD_PAGES}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        engine = PagedSlotEngine(q, cfg, slots=plan.slots, total_pages=plan.total_pages,
                                 eos_id=EOS_ID, kv_dtype="int8", **QUANT_GEO)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        engine.warmup()
        doc["warmup_s"] = round(time.perf_counter() - t0, 3)
        trace = poisson_trace(vocab=cfg.vocab, **SERVE_TRACE)[:QUANT_POD_REQUESTS]
        prefills = []
        count_prefills(engine, prefills)
        stats, wall, launches = measured(lambda: engine.run(trace))
        del engine._prefill
        s = stats.summary()
        t0 = time.perf_counter()
        doc["decode_step_profile"] = profile_paged_decode_step(engine, steps=1)
        doc["profile_s"] = round(time.perf_counter() - t0, 3)
        doc.update(
            resident_bytes=resident, peak_reserved_bytes=torch.cuda.max_memory_reserved(),
            peak_allocated_bytes=torch.cuda.max_memory_allocated(),
            transient_peak_bytes=torch.cuda.max_memory_allocated() - resident,
            requests=s["requests"], tokens=s["tokens"], ticks=s["ticks"], wall_s=wall,
            ttft_p50_ms=s["ttft_p50_ms"], ttft_p99_ms=s["ttft_p99_ms"],
            decode_step_p50_ms=engine.profiler.p50() * 1e3,
            decode_step_p99_ms=engine.profiler.p99() * 1e3,
            prefill_dispatches=len(prefills), shape_guard=stats.trace_counts,
            launches=launches,
        )
        if len(stats.results) != len(trace):
            fail.append("not every request was served")
        if stats.trace_counts != {"prefill": 1, "extend": 1, "decode": 1}:
            fail.append(f"shape guard moved: {stats.trace_counts}")
        if engine.allocator.used_pages != engine.radix.cached_pages:
            fail.append(f"pages leaked: {engine.allocator.used_pages} used, "
                        f"{engine.radix.cached_pages} cached")
        if not launches["flash_fwd"] == cfg.n_layers * len(prefills) > 0 or \
                launches["flash_fwd_scalar"]:
            fail.append(f"launches {launches}: not {cfg.n_layers} flash_fwd for each of "
                        f"{len(prefills)} prefill dispatches")
        if doc["peak_reserved_bytes"] > cap or doc["draw_peak_reserved_bytes"] > cap:
            fail.append(f"peak reserved {doc['peak_reserved_bytes']} over the cap {cap}")
        del engine
        by_rid = {r.rid: r for r in trace}
        open(os.path.join(argv[1], "solo"), "w").close()
        t0 = time.perf_counter()
        solos, diverged = {}, []
        for res in stats.results:
            diverged += check_vs_solo("phase 27 (b)", q, cfg, by_rid[res.rid], res.tokens,
                                      solos=solos, kv_dtype="int8")
        doc["solo_s"] = round(time.perf_counter() - t0, 3)
        doc["diverged_at_near_ties"] = diverged
    except torch.cuda.OutOfMemoryError as e:
        doc.update(oom=str(e).splitlines()[0][:400],
                   peak_reserved_bytes=torch.cuda.max_memory_reserved(),
                   peak_allocated_bytes=torch.cuda.max_memory_allocated())
        print(json.dumps(doc), flush=True)
        return 3
    doc["fail"] = fail
    print(json.dumps(doc), flush=True)
    return 1 if fail else 0


def start_int8_pod(entry: str, workdir: str, *args: str) -> subprocess.Popen:
    """Start ``chip_smoke.<entry>(args)`` in a child with only the plugin's
    env for QUANT_POD_UNITS on top of the parent's, its output in files
    under ``workdir``."""
    gc.collect()
    torch.cuda.empty_cache()
    env = {k: v for k, v in os.environ.items() if k != const.ENV_CUDA_VISIBLE_DEVICES}
    env.update(plugin_env(QUANT_POD_UNITS))
    code = f"import sys, chip_smoke; sys.exit(chip_smoke.{entry}(sys.argv[1:]))"
    with open(os.path.join(workdir, "pod.out"), "w") as out, \
            open(os.path.join(workdir, "pod.err"), "w") as err:
        return subprocess.Popen([sys.executable, "-c", code, *args],
                                cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                                stdout=out, stderr=err, text=True)


def wait_for_file(phase: str, proc: subprocess.Popen, path: str) -> bool:
    """Wait until a child writes ``path`` (True) or exits first (False);
    fail ``phase`` after POD_TIMEOUT_S."""
    deadline = time.perf_counter() + POD_TIMEOUT_S
    while not os.path.exists(path):
        if proc.poll() is not None:
            return False
        if time.perf_counter() > deadline:
            stop(proc)
            raise SystemExit(f"{phase} failed: no {os.path.basename(path)} file in "
                             f"{POD_TIMEOUT_S} s")
        time.sleep(0.05)
    return True


def stop(proc: subprocess.Popen) -> None:
    """Kill a child this script started, if it still runs, and reap it."""
    if proc.poll() is None:
        proc.kill()
    proc.wait()


def finish_int8_pod(phase: str, proc: subprocess.Popen, workdir: str) -> dict:
    """Wait for a pod :func:`start_int8_pod` started; returns its JSON line,
    and fails ``phase`` unless it exits 0 with no failed gate."""
    try:
        proc.wait(timeout=POD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        stop(proc)
        raise SystemExit(f"{phase} failed: the pod ran past {POD_TIMEOUT_S} s")
    with open(os.path.join(workdir, "pod.out")) as f:
        docs = [line for line in f.read().splitlines() if line.startswith("{")]
    with open(os.path.join(workdir, "pod.err")) as f:
        stderr = f.read()
    doc = json.loads(docs[-1]) if docs else None
    print("  int8 pod", json.dumps(doc), flush=True)
    if proc.returncode != 0 or doc is None or doc.get("fail"):
        raise SystemExit(f"{phase} failed: exit {proc.returncode}; "
                         f"{(doc or {}).get('fail') or (doc or {}).get('oom')}; "
                         f"stderr: {stderr[-2000:]}")
    return doc


def quant_pod(bf16_bytes: int, during_solo=None) -> tuple[dict, dict]:
    """Phase 27 (b): run :func:`quant_pod_main` in a child with only the
    plugin's env for QUANT_POD_UNITS on top of the parent's; call
    ``during_solo`` (if given) once the child has reached its solo
    checks, which time nothing. Returns the child's report and its run's
    launches."""
    print(f"phase 27 (b): the int8 8B (32 layers) served from a {QUANT_POD_UNITS}-GiB pod, "
          f"int8 KV cache, {QUANT_POD_REQUESTS} requests", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        proc = start_int8_pod("quant_pod_main", tmp, str(bf16_bytes), tmp)
        if during_solo is not None:
            try:
                if wait_for_file("phase 27 (b)", proc, os.path.join(tmp, "solo")):
                    during_solo()
            except BaseException:
                stop(proc)
                raise
        doc = finish_int8_pod("phase 27 (b)", proc, tmp)
    gib = 2 ** 30
    print(f"  pod: plan {doc['plan']['slots']} slots x {doc['plan']['total_pages']} pages; peak "
          f"reserved {doc['peak_reserved_bytes'] / gib:.3f} GiB of a "
          f"{doc['cap_bytes'] / gib:.3f} GiB cap; TTFT p50 {doc['ttft_p50_ms']:.1f} ms, decode "
          f"step p50 {doc['decode_step_p50_ms']:.1f} ms", flush=True)
    return doc, doc["launches"]


def phase_quant(params, cfg, during_solo=None) -> tuple[dict, dict]:
    """Phase 27 on phase 2's bf16 8B weights: (a) :func:`quant_serve`, then
    (b) :func:`quant_pod` (``during_solo`` as there). Returns the launches
    of both paths, by path name (``int8_serve``, ``int8_pod``), and the
    phase's report."""
    t0 = time.perf_counter()
    serve, serve_launches = quant_serve(params, cfg)
    t1 = time.perf_counter()
    pod, pod_launches = quant_pod(serve["param_bytes_bf16"], during_solo)
    t2 = time.perf_counter()
    print(f"  phase 27 (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s", flush=True)
    report = {"serve": serve, "pod": pod, "seconds": t2 - t0}
    return {"int8_serve": serve_launches, "int8_pod": pod_launches}, report


# Phase 28: int8 on the serving paths phase 27 bypasses, each run at
# llama3_8b() width on seeded bf16 weights quantized with quantize_decoder.
# (a) Multi-LoRA over the int8 8B cut to QUANT_LORA_LAYERS, in a child pod
# of QUANT_POD_UNITS: phase 13's four tenants (rank 8 on every target),
# drawn here for phase 2's weights at that depth and handed to the pod in a
# file; the pod draws its own int8 tree, as phase 27 (b)'s does (it cannot
# hold phase 2's bf16 one). QUANT_LORA_SLOTS rows, since the pool-wide decode
# step attends every slot, active or not (phase 27 (b)'s 212 took 500 ms a
# step). The pod serves each tenant's and the base model's first request
# of phase 13's trace (5 requests, in trace order: requests 0-3 and 10):
# its first 8 name only t0-t2 (t3 first at request 10), and the gate on
# adapter misses needs all four tenants. At 32 layers its first 11, the
# shortest head that names them all, took 174.5 s for (a) on one H100
# 80GB HBM3 at 700 W (111.8 s of it the one-request runs, a pool-wide
# step 237 ms p50), past the time this phase may add; so 5 requests at 16
# layers. (b) Speculative paged serving at SPEC_LAYERS with the
# Llama-3.2-1B-shaped draft at DRAFT_LAYERS, both int8, int8 KV, on phase
# 15's run A. (c) Phase 17's disaggregated serving at DISAGG_LAYERS, int8
# weights and both tiers' caches int8.
QUANT_LORA_SLOTS = 16
QUANT_LORA_LAYERS = 16
QUANT_LORA_MIN_ROWS = 8  # max_len rows of pages the pod's plan must buy


def first_per_tenant(trace) -> list:
    """Each adapter id's first request (the base model's too), in trace
    order."""
    seen: set = set()
    return [r for r in trace if not (r.adapter_id in seen or seen.add(r.adapter_id))]


def one_request_runs(engine, trace) -> dict:
    """Each request of ``trace`` served alone by ``engine`` (a one-request
    run, arriving at tick 0), with the top-two logit gap at each token it
    emits: ``{rid: (tokens, [(gap, |top|), ...])}``. The gaps come from the
    logits each program takes its token from: the last prompt chunk's,
    then each decode step's at the request's row."""
    names = ("paged_prefill_slot", "paged_extend_slot", "paged_decode_step")
    originals = {name: getattr(G, name) for name in names}
    seen: dict = {}
    calls: list = []

    def keep(fn):
        def wrapped(*args, **kw):
            logits, cache = fn(*args, **kw)
            seen["logits"] = logits
            return logits, cache
        return wrapped

    def program(name):
        method = getattr(engine, name)

        def wrapped(*args):
            tok = method(*args)
            logits, pick = seen.pop("logits"), tok
            if name == "_decode":
                row = int(torch.nonzero(args[2])[0, 0])
                logits, pick = logits[row], tok[row]
            else:
                logits = logits[0]
            top2 = torch.topk(logits.float(), 2).values
            calls.append((name, int(pick), float(top2[0] - top2[1]), float(top2[0].abs())))
            return tok
        return wrapped

    out = {}
    for name in names:
        setattr(G, name, keep(originals[name]))
    try:
        for req in trace:
            calls.clear()
            for name in ("_prefill", "_extend", "_decode"):
                setattr(engine, name, program(name))
            try:
                stats = engine.run([dataclasses.replace(req, arrival=0.0)])
            finally:
                for name in ("_prefill", "_extend", "_decode"):
                    delattr(engine, name)
            first = next((i for i, c in enumerate(calls) if c[0] == "_decode"), len(calls))
            emitted = calls[first - 1: first] + [c for c in calls[first:] if c[0] == "_decode"]
            (res,) = stats.results
            if [c[1] for c in emitted[: len(res.tokens)]] != list(res.tokens):
                raise SystemExit(f"request {req.rid}: the recorded programs do not give the "
                                 "one-request run's tokens")
            out[req.rid] = (list(res.tokens), [(c[2], c[3]) for c in emitted])
    finally:
        for name, fn in originals.items():
            setattr(G, name, fn)
    return out


def near_tie_divergence(rid, got, want, gaps) -> dict | None:
    """Phase 3's rule for ``got`` against ``want`` (whose top-two gaps are
    ``gaps``): None if equal; the first divergence if it is at a near tie;
    SystemExit otherwise."""
    j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if j is None:
        if len(got) != len(want):
            raise SystemExit(f"request {rid}: {len(got)} tokens, {len(want)} served alone")
        return None
    gap, top = gaps[j]
    if gap > TOP2_GAP_REL * top:
        raise SystemExit(f"request {rid} diverges at step {j} where the top-two gap alone "
                         f"{gap} > {TOP2_GAP_REL} * {top}")
    return {"rid": rid, "step": j, "solo_top2_gap": gap, "top": top,
            "gap_over_top": gap / top if top else 0.0}


def quant_lora_pod_main(argv: list[str]) -> int:
    """Phase 28 (a), in a child whose env is the plugin's for a
    QUANT_POD_UNITS slice (``argv = [the tenants' file, a directory]``):
    cap the process, load the int8 tree and the tenants, size the int8
    multi-LoRA pool from the env (``lora=True``), warm the engine up, write
    the directory's "ready" file (the parent times nothing beside this
    set-up), wait for its "go" file (the parent's other runs end first, so
    the timed runs have the card alone), serve each tenant's first request
    of phase 13's trace, then each alone on the same engine. Prints one
    JSON line; exits 3 on an OOM, and 1 on a failed gate."""
    settings = configure_torch_from_env()
    fraction = float(settings[MEMORY_FRACTION])
    cap = int(fraction * torch.cuda.get_device_properties(0).total_memory)
    doc = {"slice_gib": PodTpuEnv.from_env().mem_units_container, "fraction": fraction,
           "cap_bytes": cap}
    cfg = dataclasses.replace(llama3_8b(), n_layers=QUANT_LORA_LAYERS)
    lcfg = L.LoraConfig(rank=LORA_RANK, alpha=LORA_ALPHA, targets=LORA_TARGETS)
    fail = []
    try:
        q = loaded_int8_decoder(cfg, doc)
        store = torch.load(argv[0], weights_only=True)
        plan = paged_plan_from_pod_env(cfg, weight_bytes=doc["weight_bytes"], kv_dtype="int8",
                                       lora=True, slots=QUANT_LORA_SLOTS, **QUANT_GEO)
        doc["plan"] = dataclasses.asdict(plan)
        doc["plan_rows"] = plan.total_pages // pages_for(QUANT_GEO["max_len"],
                                                         QUANT_GEO["page_size"])
        if doc["plan_rows"] < QUANT_LORA_MIN_ROWS:
            fail.append(f"the plan buys {doc['plan_rows']} max_len rows of pages, not "
                        f"{QUANT_LORA_MIN_ROWS}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine = PagedSlotEngine(q, cfg, slots=plan.slots, total_pages=plan.total_pages,
                                 eos_id=EOS_ID, kv_dtype="int8", lora_store=store,
                                 lora_cfg=lcfg, **QUANT_GEO)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        engine.warmup()
        doc["engine_warmup_s"] = round(time.perf_counter() - t0, 3)
        open(os.path.join(argv[1], "ready"), "w").close()
        t0 = time.perf_counter()
        while not os.path.exists(os.path.join(argv[1], "go")):
            if time.perf_counter() - t0 > POD_TIMEOUT_S:
                raise SystemExit("phase 28 (a): the parent never wrote its go file")
            time.sleep(0.05)
        doc["waited_for_go_s"] = round(time.perf_counter() - t0, 3)
        trace = first_per_tenant(paged_trace(cfg, seed=LORA_TRACE_SEED,
                                             adapters=[*LORA_TENANTS, ""]))
        prefills = []
        count_prefills(engine, prefills)
        stats, wall, launches = measured(lambda: engine.run(trace))
        del engine._prefill
        s = stats.summary()
        adapters = engine.cache_stats()["adapters"]
        doc.update(
            resident_bytes=resident, requests=s["requests"], tokens=s["tokens"],
            ticks=s["ticks"], wall_s=wall, ttft_p50_ms=s["ttft_p50_ms"],
            ttft_p99_ms=s["ttft_p99_ms"], decode_step_p50_ms=engine.profiler.p50() * 1e3,
            decode_step_p99_ms=engine.profiler.p99() * 1e3, prefill_dispatches=len(prefills),
            shape_guard=stats.trace_counts, launches=launches, adapters=adapters,
            tenants={aid or "base": sum(r.adapter_id == aid for r in trace)
                     for aid in (*LORA_TENANTS, "")},
        )
        if len(stats.results) != len(trace):
            fail.append("not every request was served")
        if stats.trace_counts != {"prefill": 1, "extend": 1, "decode": 1}:
            fail.append(f"shape guard moved: {stats.trace_counts}")
        if adapters["misses"] < len(LORA_TENANTS):
            fail.append(f"adapters {adapters}: fewer than {len(LORA_TENANTS)} misses")
        if not launches["flash_fwd"] == cfg.n_layers * len(prefills) > 0 or \
                launches["flash_fwd_scalar"]:
            fail.append(f"launches {launches}: not {cfg.n_layers} flash_fwd for each of "
                        f"{len(prefills)} prefill dispatches")

        def leak(label):
            held = engine.radix.cached_pages + engine.adapters.cached_pages
            if engine.allocator.used_pages != held:
                fail.append(f"{label}: {engine.allocator.used_pages} pages used, {held} held by "
                            "the radix cache and resident adapters")

        leak("after the run")
        t0 = time.perf_counter()
        alone = one_request_runs(engine, trace)
        doc["alone_s"] = round(time.perf_counter() - t0, 3)
        leak("after the one-request runs")
        if engine.trace_counts != {"prefill": 1, "extend": 1, "decode": 1}:
            fail.append(f"shape guard moved in the one-request runs: {engine.trace_counts}")
        diverged = []
        for res in stats.results:
            found = near_tie_divergence(res.rid, list(res.tokens), *alone[res.rid])
            diverged += [found] if found else []
        doc["diverged_at_near_ties"] = diverged
        doc["equal_to_alone"] = len(stats.results) - len(diverged)
        doc.update(peak_reserved_bytes=torch.cuda.max_memory_reserved(),
                   peak_allocated_bytes=torch.cuda.max_memory_allocated(),
                   transient_peak_bytes=torch.cuda.max_memory_allocated() - resident)
        if doc["peak_reserved_bytes"] > cap or doc["draw_peak_reserved_bytes"] > cap:
            fail.append(f"peak reserved {doc['peak_reserved_bytes']} over the cap {cap}")
        del engine
    except torch.cuda.OutOfMemoryError as e:
        doc.update(oom=str(e).splitlines()[0][:400],
                   peak_reserved_bytes=torch.cuda.max_memory_reserved(),
                   peak_allocated_bytes=torch.cuda.max_memory_allocated())
        print(json.dumps(doc), flush=True)
        return 3
    doc["fail"] = fail
    print(json.dumps(doc), flush=True)
    return 1 if fail else 0


def start_lora_pod(params, cfg, workdir: str) -> dict:
    """Phase 28 (a)'s first half, on phase 2's bf16 weights cut to
    QUANT_LORA_LAYERS: phase 13's four tenants drawn for them and handed
    to :func:`quant_lora_pod_main`, started in a child pod (it sets up,
    writes ``workdir``'s "ready" file and waits for its "go" file); then,
    meanwhile, each tenant's int8-base prefill logits (BGMV over
    ``quantize_decoder``'s tree and an int8 pool) against bf16
    merged-solo (``merge_lora`` + prefill) by rel-L2. Returns what
    :func:`phase_int8_paths` needs."""
    print(f"phase 28 (a): multi-LoRA over the int8 8B ({QUANT_LORA_LAYERS} of 32 layers) in a "
          f"{QUANT_POD_UNITS}-GiB pod, int8 KV cache, {QUANT_LORA_SLOTS} slots, each tenant's "
          "first request of phase 13's trace", flush=True)
    t0 = time.perf_counter()
    cfg = dataclasses.replace(cfg, n_layers=QUANT_LORA_LAYERS)
    params = {**params, "layers": {k: v[:QUANT_LORA_LAYERS]
                                   for k, v in params["layers"].items()}}
    lcfg = L.LoraConfig(rank=LORA_RANK, alpha=LORA_ALPHA, targets=LORA_TARGETS)
    store, ratios = lora_store_for(params, cfg, lcfg)
    path = os.path.join(workdir, "tenants.pt")
    torch.save(store, path)
    proc = start_int8_pod("quant_lora_pod_main", workdir, path, workdir)
    try:
        trace = paged_trace(cfg, seed=LORA_TRACE_SEED, adapters=[*LORA_TENANTS, ""])
        q = Q.quantize_decoder(params)
        logits, fail = {}, []
        for aid in LORA_TENANTS:
            adapter = {n: {k: v.cuda() for k, v in ab.items()} for n, ab in store[aid].items()}
            merged = L.merge_lora(params, adapter, lcfg)
            first = next(r for r in trace if r.adapter_id == aid)
            logits[aid] = lora_logits_check(q, merged, cfg, lcfg, adapter,
                                            list(first.prompt[:512]), kv_dtype="int8")
            del merged, adapter
            torch.cuda.empty_cache()
            if not logits[aid]["rel_l2"] <= QUANT_GATE_REL_L2:
                fail.append(f"{aid}: int8-base logits rel-L2 {logits[aid]['rel_l2']} > "
                            f"{QUANT_GATE_REL_L2}")
        del q, store
        torch.cuda.empty_cache()
        print("  each tenant's prefill logits, int8 base (BGMV) against bf16 merged-solo:",
              json.dumps(logits), flush=True)
        if fail:
            raise SystemExit("phase 28 (a) failed: " + "; ".join(fail))
    except BaseException:
        stop(proc)
        raise
    return {"proc": proc, "workdir": workdir, "logits": logits, "adapter_ratios": ratios,
            "parent_s": time.perf_counter() - t0}


def finish_lora_pod(pod: dict) -> tuple[dict, dict]:
    """Phase 28 (a)'s second half: write the "go" file, so the pod serves
    alone on the card, and hold its report. Returns the report and the
    pod's run's launches."""
    t0 = time.perf_counter()
    open(os.path.join(pod["workdir"], "go"), "w").close()
    doc = finish_int8_pod("phase 28 (a)", pod["proc"], pod["workdir"])
    doc.update(logits=pod["logits"], adapter_ratios=pod["adapter_ratios"],
               seconds={"parent_set_up": pod["parent_s"], "waited_for_ready": pod["waited_s"],
                        "after_go": time.perf_counter() - t0})
    gib = 2 ** 30
    print(f"  pod: plan {doc['plan']['slots']} slots x {doc['plan']['total_pages']} pages "
          f"({doc['plan_rows']} max_len rows); peak reserved "
          f"{doc['peak_reserved_bytes'] / gib:.3f} GiB of a {doc['cap_bytes'] / gib:.3f} GiB "
          f"cap; TTFT p50 {doc['ttft_p50_ms']:.1f} ms, decode step p50 "
          f"{doc['decode_step_p50_ms']:.1f} ms; adapters {json.dumps(doc['adapters'])}; "
          f"{doc['equal_to_alone']} of {doc['requests']} equal to their one-request runs; "
          f"seconds {json.dumps(doc['seconds'])}", flush=True)
    return doc, doc["launches"]


def spec_int8(params, cfg) -> tuple[dict, dict]:
    """Phase 28 (b): phase 15's run A with the target (phase 2's weights cut
    to SPEC_LAYERS) and its Llama-3.2-1B-shaped draft (DRAFT_LAYERS) both
    int8 and an int8 KV cache, against a plain int8 engine on the same
    trace. Returns the report and the speculative run's launches."""
    print(f"phase 28 (b): speculative paged serve, int8 llama3_8b ({SPEC_LAYERS} of 32 layers) "
          f"and an int8 Llama-3.2-1B-shaped draft ({DRAFT_LAYERS} of 16), int8 KV", flush=True)
    cfg = dataclasses.replace(cfg, n_layers=SPEC_LAYERS)
    q = Q.quantize_decoder({**params, "layers": {k: v[:SPEC_LAYERS]
                                                 for k, v in params["layers"].items()}})
    dcfg = dataclasses.replace(llama32_1b_shape(), n_layers=DRAFT_LAYERS)
    dq = Q.quantize_decoder(init_params(dcfg, torch.Generator(device="cuda").manual_seed(15),
                                        device="cuda", dtype=torch.bfloat16))
    pod = PodTpuEnv.from_env(plugin_env(PAGED_SLICE_UNITS))
    plan_kw = dict(weight_bytes=Q.param_bytes(q), page_size=16, prefill_chunk=512, env=pod,
                   kv_dtype="int8", slots=16)
    plan = paged_plan_from_pod_env(cfg, 2048, draft_cfg=dcfg,
                                   draft_weight_bytes=Q.param_bytes(dq), **plan_kw)
    plan_plain = paged_plan_from_pod_env(cfg, 2048, **plan_kw)
    print(f"  int8 target {Q.param_bytes(q) / 1e9:.3f} GB, draft {Q.param_bytes(dq) / 1e9:.3f} "
          "GB; plan", json.dumps(dataclasses.asdict(plan)), flush=True)
    trace = paged_trace(cfg)
    by_rid = {r.rid: r for r in trace}
    geo = dict(max_len=2048, prefill_chunk=512, page_size=16, eos_id=EOS_ID, kv_dtype="int8")
    plain, plain_rep, plain_stats, _ = paged_run(
        "plain int8 engine",
        lambda: PagedSlotEngine(q, cfg, slots=16, total_pages=plan_plain.total_pages, **geo),
        trace, phase="phase 28 (b)", profile=False)
    del plain
    torch.cuda.empty_cache()
    served = {r.rid: r.tokens for r in plain_stats.results}
    spec, rep, stats, launches = paged_run(
        "int8 target and draft",
        lambda: PagedSlotEngine(q, cfg, slots=16, total_pages=plan.total_pages,
                                draft_params=dq, draft_cfg=dcfg, spec_k=SPEC_K, **geo),
        trace, phase="phase 28 (b)", profile=False, head_dims=True)
    del spec
    torch.cuda.empty_cache()
    solos, diverged, fail = {}, [], []
    for res in stats.results:
        diverged += check_vs_solo("phase 28 (b)", q, cfg, by_rid[res.rid], res.tokens,
                                  want=served[res.rid], solos=solos, kv_dtype="int8")
    del solos, q, dq
    torch.cuda.empty_cache()
    row = rep["cache_stats"]["speculative"]
    by_dim = rep["flash_fwd_by_head_dim"]
    report = {
        "plan": dataclasses.asdict(plan), "speculative": row,
        "acceptance": row["accepted"] / max(row["proposed"], 1),
        "round_wall_p50_ms": rep["round_wall_p50_ms"],
        "plain_decode_step_p50_ms": plain_rep["decode_step_p50_ms"],
        "ticks": {"spec": stats.ticks, "plain": plain_stats.ticks},
        "goodput_tokens_per_s": {"spec": rep["goodput_tokens_per_s"],
                                 "plain": plain_rep["goodput_tokens_per_s"]},
        "flash_fwd_by_head_dim": by_dim, "prefill_dispatches": rep["prefill_dispatches"],
        "equal_to_plain": sum(r.tokens == served[r.rid] for r in stats.results),
        "diverged_at_near_ties": diverged,
    }
    print("  phase 28 (b)", json.dumps(report), flush=True)
    print(f"  acceptance {report['acceptance']:.4f}; a round's wall p50 "
          f"{report['round_wall_p50_ms']:.1f} ms against the plain int8 step's "
          f"{report['plain_decode_step_p50_ms']:.1f} ms", flush=True)
    if not row["rollback_pages"] > 0:
        fail.append(f"no page rolled back: {row}")
    if by_dim.get(DRAFT_D, 0) != dcfg.n_layers * rep["prefill_dispatches"] or \
            by_dim.get(cfg.head_dim, 0) != cfg.n_layers * rep["prefill_dispatches"]:
        fail.append(f"flash_fwd by head dim {by_dim}: not {dcfg.n_layers} at D={DRAFT_D} and "
                    f"{cfg.n_layers} at D=128 a prefill dispatch")
    if fail:
        raise SystemExit("phase 28 (b) failed: " + "; ".join(fail))
    return report, launches


def phase_int8_paths(params, cfg, pod: dict | None = None) -> tuple[dict, dict]:
    """Phase 28 on phase 2's bf16 8B weights: (a)'s logits check and pod
    (``pod``, from :func:`start_lora_pod`: the whole script starts it while
    phase 27 (b)'s pod runs its solo checks, which time nothing; started
    here when not given), then, once that pod is warm (its "ready" file),
    so that no timed run shares the card with its set-up, (b)
    :func:`spec_int8`, (c) :func:`phase_disagg` over int8, then (a)'s pod
    serves alone on the card (:func:`finish_lora_pod`). Returns the
    launches of each path by name (``int8_lora_pod``, ``int8_spec``,
    ``int8_disagg``) and the phase's report."""
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        where = "beside phase 27 (b)'s solo checks"
        if pod is None:
            pod = start_lora_pod(params, cfg, stack.enter_context(tempfile.TemporaryDirectory()))
            where = "here"
        try:
            if not wait_for_file("phase 28 (a)", pod["proc"],
                                 os.path.join(pod["workdir"], "ready")):
                finish_int8_pod("phase 28 (a)", pod["proc"], pod["workdir"])
                raise SystemExit("phase 28 (a) failed: the pod exited before its warm-up ended")
            t1 = time.perf_counter()
            pod["waited_s"] = t1 - t0
            spec, spec_launches = spec_int8(params, cfg)
            t2 = time.perf_counter()
            disagg_launches, disagg = phase_disagg(params, cfg, int8=True)
        except BaseException:
            stop(pod["proc"])
            raise
        t3 = time.perf_counter()
        lora_pod, pod_launches = finish_lora_pod(pod)
    t4 = time.perf_counter()
    print(f"  phase 28 (a) set up {where} ({pod['parent_s']:.1f} s in this process), "
          f"{t1 - t0:.1f} s waited for its pod to warm up, {t4 - t3:.1f} s after (c); (b) "
          f"{t2 - t1:.1f} s, (c) {t3 - t2:.1f} s", flush=True)
    report = {"lora_pod": lora_pod, "spec": spec, "disagg": disagg, "seconds": t4 - t0,
              "seconds_by_run": {"a": (t1 - t0) + (t4 - t3), "b": t2 - t1, "c": t3 - t2}}
    return {"int8_lora_pod": pod_launches, "int8_spec": spec_launches,
            "int8_disagg": disagg_launches}, report


def main(argv: list[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Drive the port on one NVIDIA card.")
    ap.add_argument("--phase", type=int,
                    choices=(17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28),
                    help="build the kernels and run only this phase (a quick check; "
                         "the contract's lines are not printed); phases 21, 22, 23 and "
                         "25 build nothing")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "device", torch.cuda.get_device_name(0), flush=True)

    t_script = time.perf_counter()
    if args.phase == 21:
        _, report = phase_plugin()
        print(f"phase 21: {report['seconds']:.1f} s; chip_smoke: "
              f"{time.perf_counter() - t_script:.1f} s", flush=True)
        return 0
    if args.phase == 22:
        report = phase_node_agent()
        print(f"phase 22: {report['seconds']:.2f} s; chip_smoke: "
              f"{time.perf_counter() - t_script:.1f} s", flush=True)
        return 0
    if args.phase == 23:
        report = phase_cluster_agent()
        print(f"phase 23: {report['seconds']:.2f} s; chip_smoke: "
              f"{time.perf_counter() - t_script:.1f} s", flush=True)
        return 0
    if args.phase == 25:
        report = phase_extender()
        print(f"phase 25: {report['seconds']:.2f} s; chip_smoke: "
              f"{time.perf_counter() - t_script:.1f} s", flush=True)
        return 0
    seconds = {}  # each phase's, printed on one line before the script's

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[label] = round(time.perf_counter() - t0, 1)
        print(f"phase {label}: {seconds[label]:.1f} s", flush=True)
        return out

    t0 = time.perf_counter()
    _build.build()
    seconds["build"] = round(time.perf_counter() - t0, 1)
    print(f"build: {seconds['build']:.1f} s", flush=True)
    for name in _build.sources():
        print(_build.build_log(name).strip(), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.phase == 20:
        tp_serve, tp_paged, tp_train, tp_int8, _, report = phase_tensor_parallel(gen)
        print(f"phase 20: {report['seconds']:.1f} s; launches tp_serve {json.dumps(tp_serve)}, "
              f"tp_paged {json.dumps(tp_paged)}, tp_train {json.dumps(tp_train)}, int8_tp_serve "
              f"{json.dumps(tp_int8)}; chip_smoke: {time.perf_counter() - t_script:.1f} s",
              flush=True)
        return 0
    if args.phase == 26:
        bert_fsdp, bert_tp, _, report = phase_sharded_training(gen)
        print(f"phase 26: {report['seconds']:.1f} s; launches train_bert_fsdp "
              f"{json.dumps(bert_fsdp)}, train_bert_tp {json.dumps(bert_tp)}; chip_smoke: "
              f"{time.perf_counter() - t_script:.1f} s", flush=True)
        return 0
    if args.phase == 19:
        ring, ulysses, _, report = phase_context_parallel(gen)
        print(f"phase 19: {report['seconds']:.1f} s; launches ring {json.dumps(ring)}, ulysses "
              f"{json.dumps(ulysses)}; chip_smoke: {time.perf_counter() - t_script:.1f} s",
              flush=True)
        return 0
    if args.phase is not None:
        cfg = llama3_8b()
        params = init_params(cfg, gen, device="cuda", dtype=torch.bfloat16)
        run = {17: phase_disagg, 18: phase_fleet, 24: phase_defrag, 27: phase_quant,
               28: phase_int8_paths}[args.phase]
        launches, report = run(params, cfg)
        print(f"phase {args.phase}: {report['seconds']:.1f} s; launches {json.dumps(launches)}; "
              f"chip_smoke: {time.perf_counter() - t_script:.1f} s", flush=True)
        return 0
    forward = timed("1", phase_kernels, gen)
    grants, _ = timed("21", phase_plugin)
    timed("22", phase_node_agent)
    timed("23", phase_cluster_agent)
    timed("25", phase_extender)

    serve_launches, serve_decode_p50_ms, params, cfg = timed("2-3", phase_serve, gen)
    static_launches = timed("2c", phase_static_baseline, params, cfg)
    paged_launches = timed(
        "7-8", phase_paged, params, cfg, serve_decode_p50_ms)
    lora_serve_launches = timed("13", phase_lora_serve, params, cfg)
    spec_launches = timed("15", phase_spec_serve, params, cfg)
    interference_launches, _ = timed("16", phase_interference, params, cfg)
    disagg_launches, _ = timed("17", phase_disagg, params, cfg)
    fleet_launches, _ = timed("18", phase_fleet, params, cfg)
    defrag_launches, _ = timed("24", phase_defrag, params, cfg)
    # phase 28 (a)'s pod sets up while phase 27 (b)'s runs its solo checks
    with tempfile.TemporaryDirectory() as lora_dir:
        lora_pod: dict = {}
        try:
            quant_launches, _ = timed(
                "27", phase_quant, params, cfg,
                lambda: lora_pod.update(start_lora_pod(params, cfg, lora_dir)))
            int8_launches, int8_report = timed("28", phase_int8_paths, params, cfg,
                                               lora_pod or None)
        except BaseException:
            if lora_pod:
                stop(lora_pod["proc"])
            raise
    del params
    torch.cuda.empty_cache()
    lora_train_launches = timed("14", phase_lora_train)
    backward = timed("4", phase_backward)
    train_launches = timed("5", phase_train)
    timed("6", phase_grad_parity)

    bert, bert_launches = timed("9", phase_bert)
    resnet = timed("10", phase_resnet)
    timed("11", phase_binpack, {"bert": bert, "resnet": resnet}, grants)
    timed("12", phase_overrun, bert["peak_reserved_bytes"])
    ring_launches, ulysses_launches, cp_rows, _ = timed("19", phase_context_parallel, gen)
    tp_serve_launches, tp_paged_launches, tp_train_launches, tp_int8_launches, tp_rows, _ = \
        timed("20", phase_tensor_parallel, gen)
    bert_fsdp_launches, bert_tp_launches, shard_rows, _ = timed(
        "26", phase_sharded_training, gen)
    cp_rows = {**cp_rows, **tp_rows, **shard_rows}

    paths = {"serve": serve_launches, "paged_serve": paged_launches, "train": train_launches,
             "train_bert": bert_launches, "lora_serve": lora_serve_launches,
             "lora_train": lora_train_launches, "spec_serve": spec_launches,
             "interference": interference_launches, "disagg": disagg_launches,
             "fleet": fleet_launches, **defrag_launches, "ring": ring_launches,
             "ulysses": ulysses_launches,
             "tp_serve": tp_serve_launches, "tp_paged": tp_paged_launches,
             "tp_train": tp_train_launches, "static_baseline": static_launches,
             "train_bert_fsdp": bert_fsdp_launches, "train_bert_tp": bert_tp_launches,
             **quant_launches, **int8_launches, "int8_tp_serve": tp_int8_launches}
    cp_numbers = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                  "tflops", "bound_fraction")
    numbers = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "tflops",
               "bound_fraction")
    fwd_numbers = (*numbers, "device_ms", "device_bound_fraction", "library_device_ms")
    bert_shape = (f"bf16 B={BERT_B} S={BERT_S} H={BERT_H} Hkv={BERT_H} D={BERT_D} non-causal "
                  "(BERT-base)")
    kernels = []
    fwd_main = fa.fwd_entry(torch.bfloat16, 128)
    for entry in (fwd_main, fa.fwd_entry(torch.float32, 128)):
        kernels.append({
            "name": entry,
            "route": "cuda",
            "source": f"gpushare_device_plugin_tpu_torch/ops/csrc/{fa._SOURCE[entry]}.cu",
            "replaces": "gpushare_device_plugin_tpu/ops/flash_attention.py:96",
            "launches": serve_launches[entry],
            "launches_by_path": {k: v[entry] for k, v in paths.items()},
            **({"int8_spec_by_head_dim": int8_report["spec"]["flash_fwd_by_head_dim"]}
               if entry == fwd_main else {}),
            "on_main_path": entry == fwd_main,
            "shape": "served: bf16 B=1 S=512 H=32 Hkv=8 D=128 causal kv_len",
            **{k: forward[(entry, "served")][k] for k in fwd_numbers},
            "at_training_shape": {
                "shape": f"bf16 B={TRAIN_B} S={TRAIN_S} H=32 Hkv=8 D=128 causal",
                **{k: forward[(entry, "train")][k] for k in fwd_numbers},
            },
            "at_bert_shape": {"shape": bert_shape,
                              **{k: forward[(entry, "bert")][k] for k in fwd_numbers}},
            "at_draft_shape": {
                "shape": f"bf16 B=1 S={SERVED_S} H=32 Hkv=8 D={DRAFT_D} causal kv_len "
                         "(the Llama-3.2-1B-shaped draft's prefill, phase 15)",
                **{k: forward[(entry, "draft")][k] for k in fwd_numbers}},
            **({f"at_{label}_shape": {k: cp_rows[(entry, label)][k] for k in cp_numbers}
                for label in {**CP_KERNEL_SHAPES, **TP_KERNEL_SHAPES, **SHARD_KERNEL_SHAPES}}
               if entry == fwd_main else {}),
        })
    main_path = fa.bwd_entries(torch.bfloat16, 128)
    bwd_numbers = (*numbers, "device_ms", "device_bound_fraction")
    for entry in (*main_path, *fa.bwd_entries(torch.float32, 128)):
        row = backward[(entry, "train")]
        kernels.append({
            "name": entry,
            "route": "cuda",
            "source": f"gpushare_device_plugin_tpu_torch/ops/csrc/{fa._SOURCE[entry]}.cu",
            "replaces": "gpushare_device_plugin_tpu/ops/flash_attention.py:"
                        + ("251" if entry in DQ_ENTRIES else "309"),
            "launches": train_launches[entry],
            "launches_by_path": {k: v[entry] for k, v in paths.items()},
            "on_main_path": entry in main_path,
            **{k: row[k] for k in bwd_numbers},
            "at_bert_shape": {"shape": bert_shape,
                              **{k: backward[(entry, "bert")][k] for k in bwd_numbers}},
            **({f"at_{label}_shape": {k: cp_rows[(entry, label)][k] for k in cp_numbers}
                for label in {**CP_KERNEL_SHAPES, **TP_KERNEL_SHAPES, **SHARD_KERNEL_SHAPES}}
               if entry in main_path else {}),
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    card = smi_line()
    print("phase seconds", json.dumps(seconds), flush=True)
    print(f"chip_smoke: {time.perf_counter() - t_script:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
