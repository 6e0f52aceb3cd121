from vad_tpu_torch.data.image_dataset import MVTecDataset, get_dataloaders  # noqa: F401
from vad_tpu_torch.data.loader import DistributedLoader, Loader, device_prefetch  # noqa: F401
from vad_tpu_torch.data.video_dataset import (  # noqa: F401
    IPADDataset,
    VideoDataset,
    VideoFileDataset,
    get_video_dataloaders,
)
