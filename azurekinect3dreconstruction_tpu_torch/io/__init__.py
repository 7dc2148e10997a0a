"""Frame sources (the synthetic renderer, npz replay, MKV replay and live
k4a capture), capture threads and the host-to-device frame feeder."""

from azurekinect3dreconstruction_tpu_torch.io.replay import (
    FrameRecorder,
    FrameSource,
    NpzReplaySource,
    SyntheticSource,
)
from azurekinect3dreconstruction_tpu_torch.io.streams import (
    CaptureThread,
    DeviceFeeder,
    MultiCameraRig,
    prefetch_to_device,
)
from azurekinect3dreconstruction_tpu_torch.io.synthetic import (
    Plane,
    Scene,
    Sphere,
    SyntheticCamera,
    orbit_trajectory,
)

__all__ = [
    "CaptureThread",
    "DeviceFeeder",
    "FrameRecorder",
    "MultiCameraRig",
    "FrameSource",
    "NpzReplaySource",
    "Plane",
    "Scene",
    "Sphere",
    "SyntheticCamera",
    "SyntheticSource",
    "orbit_trajectory",
    "prefetch_to_device",
]
