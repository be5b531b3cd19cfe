from .scheduler import Request, RequestState, Scheduler

__all__ = ["Scheduler", "Request", "RequestState"]
