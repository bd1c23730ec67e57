from .feature_extractor import FeatureExtractor, zeropad_images  # noqa: F401
