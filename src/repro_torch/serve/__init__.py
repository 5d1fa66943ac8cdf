"""Serving front ends (port of ``repro.serve``): the multi-tenant join
admission service (``JoinService``). The LM decode engine arrives with the
LM slice."""
from repro_torch.serve.engine import RequestRejected
from repro_torch.serve.join_service import (JoinRequest, JoinService,
                                            ServedJoin, ServiceConfig)

__all__ = ["RequestRejected", "JoinRequest", "JoinService", "ServedJoin",
           "ServiceConfig"]
