"""Serving front ends (port of ``repro.serve``): continuous-batching LM
decode (``ServeEngine``) and the multi-tenant join admission service
(``JoinService``)."""
from repro_torch.serve.engine import Request, RequestRejected, ServeEngine
from repro_torch.serve.join_service import (JoinRequest, JoinService,
                                            ServedJoin, ServiceConfig)

__all__ = ["Request", "RequestRejected", "ServeEngine", "JoinRequest",
           "JoinService", "ServedJoin", "ServiceConfig"]
