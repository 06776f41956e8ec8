from paddlebox_tpu_torch.runtime.fleet_executor import (  # noqa: F401
    Carrier, ComputeInterceptor, FleetExecutor, Interceptor, Message,
    MessageBus, SinkInterceptor, SourceInterceptor, TaskNode)
