"""Fleet layer of the port (counterpart of ``repro/fleet``): N simulated
device replicas over one shared nested tree, each with its own store,
pager chain, engine and scheduler on a shared virtual clock; delta
segments flow through a deduplicating, multicasting origin -> edge tier,
and a fleet controller rebalances per-replica budget envelopes over the
local rung policies."""
from .controller import (CONTROLLER_MODES, BudgetEnvelope, Fleet, FleetController,
                         FleetReport, build_fleet)
from .distribution import DeltaDistribution, EdgeClientPager
from .replica import ChaosProfile, Replica, ReplicaSpec, build_policy, build_replica

__all__ = [
    "ChaosProfile", "Replica", "ReplicaSpec", "build_policy",
    "build_replica",
    "DeltaDistribution", "EdgeClientPager",
    "BudgetEnvelope", "FleetController", "Fleet", "FleetReport",
    "build_fleet", "CONTROLLER_MODES",
]
