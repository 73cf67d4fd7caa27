"""Host-side utilities: metrics logging and the paper-style error tables,
profiling (`Timer`, `throughput_meter`, `trace`) and debugging
(`seed_everything`, `nan_guard`)."""
from gpe_tpu_torch.utils.debug import nan_guard, seed_everything  # noqa: F401
from gpe_tpu_torch.utils.profiling import Timer, throughput_meter, trace  # noqa: F401
