"""Elasticity: the batch-size math, the gang's liveness, the elastic agent
and the training supervisor.

Port of ``deepspeed_tpu/elasticity``: ``elasticity.py`` (the valid world
sizes ``compute_elastic_config`` finds), ``gang.py`` (``GangHeartbeat``,
``read_heartbeats``, the gang-state document), ``elastic_agent.py``
(``DSElasticAgent``: a worker's death or hang tears the gang down, and it is
relaunched at an elasticity-valid world size) and ``train_supervisor.py``
(``TrainSupervisor``: one training process restarted on a crash).
"""

from deepspeed_tpu_torch.elasticity.elastic_agent import DSElasticAgent, ElasticAgentError
from deepspeed_tpu_torch.elasticity.elasticity import (ElasticityConfig, ElasticityConfigError, ElasticityError,
                                                       ElasticityIncompatibleWorldSize, compute_elastic_config,
                                                       elasticity_enabled)
from deepspeed_tpu_torch.elasticity.gang import GangHeartbeat, read_gang_state, read_heartbeats, write_gang_state
from deepspeed_tpu_torch.elasticity.train_supervisor import TrainSupervisor

__all__ = ["DSElasticAgent", "ElasticAgentError", "ElasticityConfig", "ElasticityConfigError", "ElasticityError",
           "ElasticityIncompatibleWorldSize", "GangHeartbeat", "TrainSupervisor", "compute_elastic_config",
           "elasticity_enabled", "read_gang_state", "read_heartbeats", "write_gang_state"]
