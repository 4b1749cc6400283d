from denseflow_tpu_torch.io.writer import (
    flow_file_name,
    write_flow_images,
    write_images,
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
    "write_flow_images",
    "write_images",
    "done_paths",
    "mark_done",
    "VideoSource",
    "FrameFolderSource",
    "open_source",
    "expand_jobs",
]
