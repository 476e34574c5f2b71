"""The scheduler-extender HTTP surface (the port's copy of
``platform_aware_scheduling_tpu/extender``): wire types and the server."""

from platform_aware_scheduling_tpu_torch.extender.server import (
    HTTPRequest,
    HTTPResponse,
    Server,
    apply_middleware,
    configure_secure_context,
)
from platform_aware_scheduling_tpu_torch.extender.types import (
    Args,
    BindingArgs,
    BindingResult,
    FilterResult,
    HostPriority,
    Scheduler,
    encode_host_priority_list,
)

__all__ = [
    "Args",
    "BindingArgs",
    "BindingResult",
    "FilterResult",
    "HTTPRequest",
    "HTTPResponse",
    "HostPriority",
    "Scheduler",
    "Server",
    "apply_middleware",
    "configure_secure_context",
    "encode_host_priority_list",
]
