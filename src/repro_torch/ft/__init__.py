"""Fault tolerance for the streaming engines: fault injection
(:mod:`~repro_torch.ft.inject`), straggler detection
(:mod:`~repro_torch.ft.straggler`), elastic re-meshing
(:mod:`~repro_torch.ft.elastic`) and the recovering stream supervisor
(:mod:`~repro_torch.ft.supervise`), under the reference's names."""
from repro_torch.ft.elastic import (  # noqa: F401
    ElasticPlan, build_mesh, plan_mesh, plan_stream_mesh, recover)
from repro_torch.ft.inject import (  # noqa: F401
    CollectiveDropError, DelayDevice, DeviceLostError, DropCollective,
    FailDeviceAt, FaultInjector)
from repro_torch.ft.straggler import StragglerConfig, StragglerMonitor  # noqa: F401
from repro_torch.ft.supervise import (  # noqa: F401
    NoSurvivorsError, RecoveryEvent, StreamSupervisor)
