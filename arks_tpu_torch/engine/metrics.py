"""The engine's metric families (the port of ``arks_tpu/engine/engine.py``
``EngineMetrics``): the reference's names, help strings, labels and
buckets, in its registration order, so ``GET /metrics`` reads the same on
both servers.

Only the families whose mechanism the port has are registered.  Left out,
with its subsystem: live resize (``resize_seconds``; the
``engine_resizes_total`` family counts scale-to-zero and re-arm only).

Every update reads host-side values (the engine's host mirrors and batch
arrays), never a device tensor.
"""

from __future__ import annotations

from arks_tpu_torch.utils import metrics as prom


class EngineMetrics:
    """Normalized runtime metric names (the names a Prometheus
    ServiceMonitor relabels vLLM/SGLang names into)."""

    def __init__(self, registry: prom.Registry | None = None):
        self.registry = registry or prom.Registry()
        r = self.registry
        self.num_requests_running = r.gauge(
            "num_requests_running", "Requests currently decoding")
        self.num_requests_waiting = r.gauge(
            "num_requests_waiting", "Requests queued for admission")
        self.prompt_tokens_total = r.counter(
            "prompt_tokens_total", "Prefilled prompt tokens")
        self.generation_tokens_total = r.counter(
            "generation_tokens_total", "Generated tokens")
        self.time_to_first_token_seconds = r.histogram(
            "time_to_first_token_seconds", "TTFT",
            buckets=[0.01, 0.025, 0.05, 0.1, 0.2, 0.4, 0.8, 1.6, 3.2, 6.4, 12.8])
        self.time_per_output_token_seconds = r.histogram(
            "time_per_output_token_seconds", "TPOT",
            buckets=[0.002, 0.005, 0.01, 0.02, 0.04, 0.08, 0.16, 0.32, 0.64])
        self.e2e_request_latency_seconds = r.histogram(
            "e2e_request_latency_seconds", "End-to-end request latency",
            buckets=[0.1, 0.25, 0.5, 1, 2.5, 5, 10, 20, 40, 80, 160])
        self.request_success_total = r.counter(
            "request_success_total", "Finished requests by reason")
        # Prefix-cache family (reference dashboard's cache hit-rate panel —
        # docs/monitoring.md:118-144 — normalized like the other names).
        self.prefix_cache_query_tokens_total = r.counter(
            "prefix_cache_query_tokens_total",
            "Prompt tokens checked against the prefix cache")
        self.prefix_cache_hit_tokens_total = r.counter(
            "prefix_cache_hit_tokens_total",
            "Prompt tokens served from the prefix cache")
        self.prefix_cache_usage_bytes = r.gauge(
            "prefix_cache_usage_bytes",
            "Bytes held by the prefix cache, by tier (device = retained "
            "pool pages, host = host-RAM blocks)")
        self.prefix_cache_hit_rate = r.gauge(
            "prefix_cache_hit_rate", "Lifetime prefix-cache token hit rate")
        # Hierarchical prefix cache (paged engines): tier 0 is the
        # allocator's on-device page index, tier 1 the host-RAM spill
        # store — the families that make HBM-pressure thrash (spill storm)
        # and restore latency visible on a dashboard.
        self.prefix_spill_blocks_total = r.counter(
            "prefix_spill_blocks_total",
            "KV pages spilled from the device prefix index to the host tier")
        self.prefix_restore_blocks_total = r.counter(
            "prefix_restore_blocks_total",
            "KV pages restored from the host tier into fresh pool pages")
        self.prefix_restore_seconds = r.histogram(
            "prefix_restore_seconds",
            "Host-tier restore latency (scatter issue -> request unparked)",
            buckets=[0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                     0.5, 1, 2.5])
        # Tier 2 (the disk tier) and fleet peer fetch: disk-budget churn,
        # a poisoned disk tier (corrupt reads), and fetches.
        self.prefix_disk_evictions_total = r.counter(
            "prefix_disk_evictions_total",
            "KV page blocks LRU-evicted from the tier-2 disk store past "
            "its byte budget")
        self.prefix_disk_corrupt_total = r.counter(
            "prefix_disk_corrupt_total",
            "Tier-2 block files rejected on read (corrupt, truncated, or "
            "stale-epoch) and deleted")
        self.prefix_peer_fetch_blocks_total = r.counter(
            "prefix_peer_fetch_blocks_total",
            "Prefix KV blocks fetched into the host tier, by source "
            "(disk = local tier 2, peer = remote replica)")
        self.prefix_peer_fetch_seconds = r.histogram(
            "prefix_peer_fetch_seconds",
            "Disk/peer prefix fetch latency (park -> blocks staged in "
            "the host tier)",
            buckets=[0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1,
                     2.5, 5, 10])
        self.guided_requests_total = r.counter(
            "guided_requests_total",
            "Admitted guided-decoding requests by guide kind")
        # Guide compile pipeline (engine.guides): async worker-pool
        # compiles + LRU registry — the families that make a cold-compile
        # stall or an eviction storm visible on a dashboard.
        self.guide_compile_seconds = r.histogram(
            "guide_compile_seconds",
            "Guided-decoding DFA compile latency (worker-pool threads)",
            buckets=[0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60, 120])
        self.guide_cache_hits_total = r.counter(
            "guide_cache_hits_total",
            "Guide requests served from the compiled registry")
        self.guide_cache_misses_total = r.counter(
            "guide_cache_misses_total",
            "Guide requests that scheduled a cold compile")
        self.guide_cache_evictions_total = r.counter(
            "guide_cache_evictions_total",
            "Guides evicted from the registry (LRU, no active slot)")
        self.guide_registry_guides_in_use = r.gauge(
            "guide_registry_guides_in_use",
            "Guides currently packed in the registry")
        self.guide_registry_rows_in_use = r.gauge(
            "guide_registry_rows_in_use",
            "DFA rows currently packed in the transition table")
        # Speculative decoding: proposals, acceptances, the lifetime rate,
        # and the tokens each speculating lane lands a dispatch (1: none
        # accepted; draft_len: the whole block and the bonus).
        self.spec_decode_proposed_tokens_total = r.counter(
            "spec_decode_proposed_tokens_total",
            "Draft tokens proposed to the verifier")
        self.spec_decode_accepted_tokens_total = r.counter(
            "spec_decode_accepted_tokens_total",
            "Draft tokens accepted by the verifier")
        self.spec_decode_acceptance_rate = r.gauge(
            "spec_decode_acceptance_rate",
            "Lifetime draft-token acceptance rate")
        self.spec_decode_accepted_length = r.histogram(
            "spec_decode_accepted_length",
            "Tokens landed per speculating request per spec dispatch",
            buckets=[1, 2, 3, 4, 6, 8, 12, 16])
        # Mixed-step scheduling (ARKS_MIXED_STEP): one token-budget dispatch
        # per iteration carrying decode tokens + prefill-chunk tokens.
        self.mixed_batch_tokens = r.histogram(
            "mixed_batch_tokens",
            "Valid tokens per mixed dispatch (decode + chunk)",
            buckets=[1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048])
        self.mixed_chunk_tokens_total = r.counter(
            "mixed_chunk_tokens_total",
            "Prefill-chunk tokens processed inside mixed dispatches")
        # Ragged-grid padding waste (ops.paged_attention ragged work list):
        # steps_total counts the page-compute steps the ACTIVE grid mode
        # executes per mixed dispatch; ideal_total counts the per-sequence
        # causal minimum (what the ragged work list runs).  Their ratio is
        # the padding-waste factor — 1.0 under ARKS_MIXED_GRID=ragged,
        # up to S*num_qb*max_pages/ideal under the dense fallback
        # (docs/monitoring.md has the alert row).
        self.mixed_grid_steps_total = r.counter(
            "mixed_grid_steps_total",
            "Page-compute grid steps executed by mixed dispatches")
        self.mixed_grid_steps_ideal_total = r.counter(
            "mixed_grid_steps_ideal_total",
            "Per-sequence causal minimum page-compute steps for the same "
            "mixed dispatches")
        # KV bytes-moved pair (engine/paged.mixed_kv_bytes): bytes_total
        # mirrors the ragged kernel's actual DMA schedule (every q-block
        # re-streams its causal page prefix at the PLAN's block_q — the
        # GQA head-grouped autotune entries earn their keep by raising
        # block_q, which this counter shows directly); ideal_total counts
        # each distinct causal page once per dispatch.  The ratio is the
        # KV streaming waste factor (docs/monitoring.md alert).
        self.mixed_kv_bytes_total = r.counter(
            "mixed_kv_bytes_total",
            "KV bytes streamed from HBM by mixed dispatches (plan mirror)")
        self.mixed_kv_bytes_ideal_total = r.counter(
            "mixed_kv_bytes_ideal_total",
            "KV bytes a perfect once-per-page schedule would stream for "
            "the same mixed dispatches")
        # Windowed-residency decode (ARKS_RESIDENCY_WINDOW_PAGES): spans
        # attended and cold pages prefetched for contexts larger than the
        # device page pool.
        self.residency_spans_total = r.counter(
            "residency_spans_total",
            "Windowed-residency attention spans attended")
        self.residency_prefetch_pages_total = r.counter(
            "residency_prefetch_pages_total",
            "Cold KV pages restored into staging by residency prefetch")
        self.sampler_fused_dispatch_total = r.counter(
            "sampler_fused_dispatch_total",
            "Steady-state decode dispatches issued through the fused "
            "attention+sampler program (ARKS_SAMPLER_FUSE) with zero "
            "host-side prep arrays")
        # Scheduler phase breakdown (seconds of engine-thread wall time):
        # where a serving cycle actually goes, to attribute throughput loss
        # (admit vs chunk vs decode).
        self.scheduler_seconds_total = r.counter(
            "scheduler_seconds_total",
            "Engine-thread wall seconds by scheduler phase")
        self.decode_resolve_wait_seconds_total = r.counter(
            "decode_resolve_wait_seconds_total",
            "Seconds blocked fetching decode results (pure device-stream "
            "wait, unpolluted by overlapped host work), split by "
            "mode=pipelined|sequential")
        # Pipelined decode (ARKS_PIPELINE_DEPTH): in-flight dispatches
        # after each issue.  At depth N steady state this sits at N — a
        # histogram stuck at 1 means the engine keeps leaving the
        # pipelined path (admission churn, aborts, oversized stop sets).
        self.pipeline_depth_occupancy = r.histogram(
            "pipeline_depth_occupancy",
            "In-flight decode dispatches after each pipelined issue",
            buckets=[1, 2, 3, 4, 6, 8])
        # Fault isolation and recovery (engine/faults.py and the engine's
        # ``_recover_from_fault``): who faulted (phase, kind), who
        # survived, who was quarantined, and how long the replay took.
        self.engine_faults_total = r.counter(
            "engine_faults_total",
            "Scheduler-step faults by phase and kind")
        self.requests_recovered_total = r.counter(
            "requests_recovered_total",
            "In-flight requests restored to serving after an engine fault "
            "(token-replay resume or re-queued admission)")
        self.requests_quarantined_total = r.counter(
            "requests_quarantined_total",
            "Culprit requests failed alone after exhausting "
            "ARKS_FAULT_RETRIES")
        self.engine_recovery_seconds = r.histogram(
            "engine_recovery_seconds",
            "Fault-to-resumed-decoding recovery latency",
            buckets=[0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60, 120])
        # 0=serving 1=recovering 2=wedged (faults.STATE_CODES); /readiness
        # answers 503 "recovering"/"wedged" while nonzero.
        self.engine_state = r.gauge(
            "engine_state",
            "Engine serving state (0=serving, 1=recovering, 2=wedged)")
        # Resolved-config info gauge (value always 1, config as labels —
        # the kube-state-metrics "_info" idiom): which KV layout / decode
        # impl / overlap mode a replica ACTUALLY runs, so an operator can
        # tell the perf envelope from /metrics instead of reading logs.
        self.engine_config_info = r.gauge(
            "engine_config_info",
            "Resolved engine configuration (labels; value is always 1)")
        # ---- Multi-model pool (engine/model_pool.py)
        self.model_pool_resident_bytes = r.gauge(
            "model_pool_resident_bytes",
            "Device weight bytes per pool model (0 while evicted)")
        self.model_switch_seconds = r.histogram(
            "model_switch_seconds",
            "Model switch latency: first request parked for the model to "
            "the model serving (includes the overlapped weight load)",
            buckets=[0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                     60.0, 120.0])
        self.model_cold_starts_total = r.counter(
            "model_cold_starts_total",
            "Pool model loads from cold (weights not resident)")
        self.requests_parked = r.gauge(
            "requests_parked",
            "Requests parked by reason: guide compile, host-tier KV "
            "restore, a pending model switch, or a preemptive KV swap")
        # ---- Scale-to-zero of an idle engine and its re-arm
        self.engine_resizes_total = r.counter(
            "engine_resizes_total",
            "Live topology resizes by mode (resize|scale_to_zero|rearm) "
            "and outcome (ok|error|rejected)")
        self.scale_from_zero_seconds = r.histogram(
            "scale_from_zero_seconds",
            "Scale-from-zero re-arm latency: demand arrival to serving "
            "(weight stream + cache/program rebuild + warm-up issue)",
            buckets=[0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                     60.0, 120.0])
        # ---- SLO tiers + preemptive KV swap (arks_tpu_torch.slo,
        # ARKS_PREEMPT)
        # Per-tier latency families carry the tier NAME as a label so one
        # dashboard row per rung of the ladder can alert on its own
        # target (docs/monitoring.md); without ARKS_SLO_TIERS everything
        # lands in tier="default" and the families mirror the global
        # TTFT/TPOT histograms.
        self.ttft_seconds = r.histogram(
            "ttft_seconds", "TTFT by SLO tier",
            buckets=[0.01, 0.025, 0.05, 0.1, 0.2, 0.4, 0.8, 1.6, 3.2, 6.4, 12.8])
        self.tpot_seconds = r.histogram(
            "tpot_seconds", "TPOT by SLO tier",
            buckets=[0.002, 0.005, 0.01, 0.02, 0.04, 0.08, 0.16, 0.32, 0.64])
        self.requests_preempted_total = r.counter(
            "requests_preempted_total",
            "Running requests preempted for a higher tier, by victim tier")
        self.preempt_swap_seconds = r.histogram(
            "preempt_swap_seconds",
            "Preemptive-swap leg latency (issue -> host copy landed, and "
            "resume issue -> slot live again)",
            buckets=[0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                     0.5, 1, 2.5])
        # ---- Tenant-fair admission + overload ladder (engine.fairqueue)
        # The tenant label rides through TenantLabels (first-K tenants
        # keep their id, the rest share "other") so hostile key churn
        # cannot mint unbounded series — tests/test_torch_metrics.py holds
        # the bound.
        self.requests_shed_total = r.counter(
            "requests_shed_total",
            "Requests rejected by the overload ladder, by reason "
            "(queue_full|tenant_cap|deadline), tier, and bounded tenant "
            "label")
        self.admission_queue_depth = r.gauge(
            "admission_queue_depth",
            "Admission-queue depth across all tiers and tenants (compare "
            "against ARKS_QUEUE_MAX for the saturation fraction)")
