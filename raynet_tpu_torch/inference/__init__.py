from .forward_pass import (  # noqa: F401
    ForwardPass,
    HartmannForwardPass,
    MultiViewCNNForwardPass,
    MultiViewCNNVoxelSpaceForwardPass,
    RayNetForwardPass,
    get_forward_pass_factory,
)
