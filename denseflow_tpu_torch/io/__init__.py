from denseflow_tpu_torch.io.writer import (
    flow_file_name,
    h5_file_name,
    write_flow_images,
    write_flow_images_png,
    write_images,
    write_hdf5,
    create_h5_file,
    done_paths,
    mark_done,
)
from denseflow_tpu_torch.io.reader import (
    VideoSource,
    FrameFolderSource,
    open_source,
    expand_jobs,
)

__all__ = [
    "flow_file_name",
    "h5_file_name",
    "write_flow_images",
    "write_flow_images_png",
    "write_images",
    "write_hdf5",
    "create_h5_file",
    "done_paths",
    "mark_done",
    "VideoSource",
    "FrameFolderSource",
    "open_source",
    "expand_jobs",
]
