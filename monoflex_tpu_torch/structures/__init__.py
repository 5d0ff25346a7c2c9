from .image_list import ImageList, to_image_list
from .params_3d import ParamsList

__all__ = ["ImageList", "to_image_list", "ParamsList"]
