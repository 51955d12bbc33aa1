"""Client-population simulation: churn, stragglers and partial
participation over the fused engine's fixed cohort lanes (a numpy copy of
``repro/population``; the JAX package's docs/ENGINES.md "Client
populations" describes it).

A :class:`ClientPopulation` models a pool of P simulated clients, each
with a split point, a (typically non-IID Dirichlet) data shard and a
seeded availability/straggler process, that is much larger than the
profile's fixed cohort-lane layout.  Every round a
:class:`ParticipationSchedule` draws a :class:`ParticipationPlan` mapping
the sampled active clients onto the fixed slots, with a per-slot 0/1
participation mask that the engine stages to the device beside the
batches, so churn never changes staged shapes or the launches of a round.
"""
from repro_torch.population.population import (ClientPopulation,
                                               PopulationClient,
                                               PopulationCursor)
from repro_torch.population.schedule import (ParticipationPlan,
                                             ParticipationSchedule)

__all__ = [
    "ClientPopulation",
    "PopulationClient",
    "PopulationCursor",
    "ParticipationPlan",
    "ParticipationSchedule",
]
