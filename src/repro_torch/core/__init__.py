"""Paper core: Green-aware Constraint Generator and the float64 planner
(public API re-exports)."""
from .adapter import (
    KubernetesAdapter,
    to_dicts,
    to_json,
    to_kubernetes,
    to_prolog,
)
from .energy import (
    EnergyEstimator,
    EnergyMixGatherer,
    K_TRANSMISSION_KWH_PER_GB_2025,
    static_signal,
)
from .explain import ExplainabilityReport, generate_report
from .generator import ConstraintGenerator, quantile_inf
from .kb import KBEnricher, KnowledgeBase, Stats, StoredConstraint
from .library import (
    AffinityModule,
    AvoidNodeModule,
    ConstraintLibrary,
    ConstraintModule,
)
from .lowering import (
    DenseLowering,
    LoweredProblem,
    ScenarioBatch,
    SparseCommLowering,
    lower,
    lower_constraints,
    pad_lowering,
    substitute_profiles,
)
from .pipeline import GeneratorOutput, GreenConstraintPipeline
from .problem import BucketSpec, PlacementProblem, PlanResult, PlanStats
from .ranker import ConstraintRanker
from .scheduler import (
    GreenScheduler,
    ReferenceScheduler,
    SchedulerConfig,
    compile_cache_stats,
    reference_objective,
    reset_compile_cache_counters,
)
from .types import (
    Affinity,
    Application,
    AvoidNode,
    CommunicationLink,
    Constraint,
    DeploymentPlan,
    EnergySample,
    Flavour,
    FlavourRequirements,
    Infrastructure,
    MonitoringData,
    Node,
    NodeCapabilities,
    Placement,
    Service,
    ServiceRequirements,
    Subnet,
    TrafficSample,
)
