from .forward_pass import (  # noqa: F401
    CasMVSNetForwardPass,
    ForwardPass,
    HartmannForwardPass,
    MultiViewCNNForwardPass,
    MultiViewCNNVoxelSpaceForwardPass,
    MVSNetForwardPass,
    RayNetForwardPass,
    get_forward_pass_factory,
)
