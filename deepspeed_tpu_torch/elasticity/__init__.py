"""Elastic batch-size math.

Port of ``deepspeed_tpu/elasticity``: ``elasticity.py`` (the valid world
sizes ``compute_elastic_config`` finds, which the fleet autoscaler snaps
pool sizes to). The training-side elastic agent, its gang state and the
training supervisor are ROADMAP A8: their names resolve lazily and raise
``NotImplementedError``.
"""

from deepspeed_tpu_torch.elasticity.elasticity import (ElasticityConfig, ElasticityConfigError,
                                                       ElasticityError, ElasticityIncompatibleWorldSize,
                                                       compute_elastic_config, elasticity_enabled)

__all__ = ["ElasticityConfig", "ElasticityConfigError", "ElasticityError", "ElasticityIncompatibleWorldSize",
           "compute_elastic_config", "elasticity_enabled"]

# the training-side agent (elastic_agent.py, gang.py, train_supervisor.py of
# the JAX package) comes with ROADMAP A8
_A8_NAMES = ("DSElasticAgent", "ElasticAgentError", "GangHeartbeat", "read_gang_state", "read_heartbeats",
             "write_gang_state", "TrainSupervisor")


def __getattr__(name):
    if name in _A8_NAMES:
        raise NotImplementedError(f"elasticity.{name} is not ported to deepspeed_tpu_torch yet "
                                  f"(see ROADMAP.md A8)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
