from repro_torch.serving.engine import (ServingEngine, make_decode_step,
                                        make_prefill_step)
from repro_torch.serving.fleet import FleetEngine, FleetState, FleetSweepPolicy
from repro_torch.serving.loadgen import (LoadgenConfig, Microbatch, Request,
                                         find_knee, make_schedule,
                                         plan_microbatches, record_slo,
                                         simulate)
from repro_torch.serving.vision import VisionEngine

__all__ = ["FleetEngine", "FleetState", "FleetSweepPolicy", "LoadgenConfig",
           "Microbatch", "Request", "ServingEngine", "VisionEngine",
           "find_knee", "make_decode_step", "make_prefill_step",
           "make_schedule", "plan_microbatches", "record_slo", "simulate"]
