from repro_torch.trace.synth import (SCENARIOS, SyntheticTrace, TraceConfig,
                               generate_trace, list_scenarios, make_trace)

__all__ = ["SCENARIOS", "SyntheticTrace", "TraceConfig", "generate_trace",
           "list_scenarios", "make_trace"]
