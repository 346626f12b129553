"""Host utilities of the PyTorch port: the storage seam (local and
gs:// paths) and the TensorBoard event writer with the JSONL job-event
side channel; the port's own copies of `cloud_tpu/utils/storage.py` and
`cloud_tpu/utils/events.py`."""

from cloud_tpu_torch.utils import events, storage

__all__ = ["events", "storage"]
