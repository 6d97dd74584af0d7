"""repro_torch.sim: the event-driven dynamic-federation simulator (paper
§5), the port of the JAX package's ``repro.sim``.

The engine gives the churn primitives (pure ``join`` / ``leave`` /
``infer`` transitions and an arena that grows and compacts); this package
drives them over time: a ``Timeline`` of typed events (``Join``,
``Leave``, ``Straggle``, ``Drift``, ``Delay``, ``Availability`` windows),
drawn at random (``Timeline.from_poisson``, the same events as the JAX
package's for a seed), read from a JSON trace either package wrote
(``Timeline.from_trace``) or written out, and ``simulate(state, timeline,
rounds)``, which interleaves the events with the engine's rounds and
records the §5 joined-client accuracy curve.
"""
from repro_torch.sim.events import (Availability, Delay, Drift, Join,  # noqa: F401
                                    Leave, Straggle, event_from_dict, to_dict)
from repro_torch.sim.simulate import (SimLog, routed_accuracy,  # noqa: F401
                                      routed_model, simulate)
from repro_torch.sim.timeline import Timeline  # noqa: F401

__all__ = [
    "Availability", "Delay", "Drift", "Join", "Leave", "Straggle", "Timeline",
    "SimLog", "simulate", "routed_model", "routed_accuracy",
    "event_from_dict", "to_dict",
]
