"""Serving layer: the continuous-batching async JPEG decode service."""
from .decode_service import (BucketAdmissionError, DeadlineExceeded,
                             DecodeService, QueueFull, RequestRejected,
                             RequestTooLarge, ServeError, ServeResult,
                             ServiceClosed, ServiceConfig, run_open_loop)

__all__ = [
    "DecodeService",
    "ServiceConfig",
    "ServeResult",
    "ServeError",
    "ServiceClosed",
    "RequestRejected",
    "RequestTooLarge",
    "QueueFull",
    "BucketAdmissionError",
    "DeadlineExceeded",
    "run_open_loop",
]
