"""Core library: the paper's performance-prediction mechanism for
intermediate storage systems, plus the configuration-space explorer.

    Costa et al., "Predicting Intermediate Storage Performance for
    Workflow Applications", 2013.
"""
from .compile import MicroOps, compile_workflow
from .faults import (DEAD_TIME, FAILED_THRESHOLD, DiskDegradation,
                     FaultScenario, NodeFailure, Straggler, from_pod_health,
                     parse_faults, seeded_scenario)
from .placement import FileLoc, Manager
from .predictor import Predictor
from .sweep import (Candidate, CompileCache, Evaluation, ExecutionBackend,
                    InlineBackend, SweepEngine, SweepSession,
                    default_compile_cache, default_engine, default_session,
                    explore, explore_many, grid, pareto_front,
                    successive_halving, with_faults)
from .types import (GB, KB, MB, PAPER_HDD, PAPER_RAMDISK, TPU_POD_STAGING,
                    FileAttr, Placement, RunReport, ServiceTimes,
                    StorageConfig, Task, Workflow, collocated_config,
                    partitioned_config)

__all__ = [
    "MicroOps", "compile_workflow", "FileLoc", "Manager", "Predictor",
    "DEAD_TIME", "FAILED_THRESHOLD", "DiskDegradation", "FaultScenario",
    "NodeFailure", "Straggler", "from_pod_health", "parse_faults",
    "seeded_scenario", "with_faults",
    "Candidate", "CompileCache", "Evaluation", "ExecutionBackend",
    "InlineBackend", "SweepEngine", "SweepSession",
    "default_compile_cache", "default_engine", "default_session",
    "explore", "explore_many", "grid", "pareto_front",
    "successive_halving",
    "GB", "KB", "MB", "PAPER_HDD", "PAPER_RAMDISK", "TPU_POD_STAGING",
    "FileAttr", "Placement", "RunReport", "ServiceTimes", "StorageConfig",
    "Task", "Workflow", "collocated_config", "partitioned_config",
]
