from .kitti_eval import kitti_eval  # noqa: F401
