"""Native streaming runtime: the real-time plumbing around the torch
compute path (ring buffers, FIFO framing, codec/proc status handshake,
frame clock; counterpart of ``spatial_audio_framework_tpu/runtime``) —
the reference's audio-callback infrastructure
(examples/src/matrixconv/matrixconv.c:117-151, _common.h:199-224)."""
from spatial_audio_framework_tpu_torch.runtime.native import (  # noqa: F401
    CODEC_STATUS_INITIALISED,
    CODEC_STATUS_INITIALISING,
    CODEC_STATUS_NOT_INITIALISED,
    PROC_STATUS_NOT_ONGOING,
    PROC_STATUS_ONGOING,
    FifoFramer,
    FrameClock,
    RingBuffer,
    StatusFlags,
    native_available,
)
from spatial_audio_framework_tpu_torch.runtime.stream import (  # noqa: F401
    StreamRunner,
    torch_frame_fn,
)
from spatial_audio_framework_tpu_torch.runtime.watchdog import (  # noqa: F401
    DeviceWedgeError,
    Watchdog,
    probe_device,
)
