"""Communication constants (port of ``deepspeed_tpu/comm/constants.py``):
the port's backends are torch.distributed's."""

NCCL_BACKEND = "nccl"
GLOO_BACKEND = "gloo"
CPU_BACKEND = GLOO_BACKEND
DEFAULT_BACKEND = NCCL_BACKEND

COMMS_LOGGER_FORMAT = "COMMS"

# config keys
COMMS_LOGGER = "comms_logger"
COMMS_LOGGER_ENABLED = "enabled"
COMMS_LOGGER_ENABLED_DEFAULT = False
COMMS_LOGGER_VERBOSE = "verbose"
COMMS_LOGGER_VERBOSE_DEFAULT = False
COMMS_LOGGER_PROF_OPS = "prof_ops"
COMMS_LOGGER_PROF_OPS_DEFAULT = []
COMMS_LOGGER_PROF_ALL = "prof_all"
COMMS_LOGGER_PROF_ALL_DEFAULT = True
COMMS_LOGGER_DEBUG = "debug"
COMMS_LOGGER_DEBUG_DEFAULT = False
