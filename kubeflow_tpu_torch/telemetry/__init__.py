"""The in-pod telemetry agent of the PyTorch port: its step hook, scrape and
capture endpoints, and the backends for the card (``agent.py``).

The wire constants below are the reference's
(``kubeflow_tpu/telemetry/__init__.py``), copied: the platform's collector
and gang aggregator read these family names and paths, whichever agent
serves them.
"""
from __future__ import annotations

TELEMETRY_PORT = 8890
TELEMETRY_PATH = "/metrics"

FAMILY_DUTY_CYCLE = "tpu_duty_cycle"
# 1 when the duty cycle is a real measurement, 0 when the agent has no duty
# signal (an unknown duty must never read as idle)
FAMILY_DUTY_KNOWN = "tpu_duty_cycle_known"
FAMILY_HBM_USED = "tpu_hbm_used_bytes"
FAMILY_HBM_TOTAL = "tpu_hbm_total_bytes"
FAMILY_DEVICE_COUNT = "tpu_device_count"
FAMILY_STEP_TOTAL = "tpu_step_total"
# per-step record stream: one sample per recent step id, the wall timestamp;
# the currently open step has a start sample only
FAMILY_STEP_START = "tpu_step_start_seconds"
FAMILY_STEP_END = "tpu_step_end_seconds"
# completed steps republished each scrape
STEP_WINDOW = 32

FAMILY_COMPILE_TOTAL = "tpu_compile_total"
FAMILY_COMPILE_SECONDS = "tpu_compile_seconds_total"
FAMILY_COMPILE_CACHE_HITS = "tpu_compile_cache_hits_total"

# on-demand capture: GET /capture?steps=N beside the scrape path
CAPTURE_PATH = "/capture"
CAPTURE_DEFAULT_STEPS = 5
CAPTURE_MAX_STEPS = 64
