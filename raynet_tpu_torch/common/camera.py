"""Finite pinhole camera (Hartley & Zisserman notation).

Copy of ``raynet_tpu/common/camera.py``: K (3x3), R (3x3 world->camera),
t (3x1); P = K[R|t] and its pseudo-inverse are computed lazily; the camera
center is -R^-1 t in homogeneous coordinates.
"""
import numpy as np


class Camera:
    def __init__(self, K, R, t):
        assert K.shape == (3, 3)
        assert R.shape == (3, 3)
        assert t.shape == (3, 1)
        self._K = K
        self._R = R
        self._t = t
        self._P = None
        self._P_pinv = None
        self._center = None

    @property
    def K(self):
        return self._K

    @property
    def R(self):
        return self._R

    @property
    def t(self):
        return self._t

    @property
    def center(self):
        """Camera center as a homogeneous (4, 1) float32 column vector."""
        if self._center is None:
            self._center = np.vstack(
                [(-np.linalg.inv(self._R)).dot(self._t), [1]]
            ).astype(np.float32)
        return self._center

    @property
    def P(self):
        """3x4 projection matrix K [R | t]."""
        if self._P is None:
            self._P = self._K.dot(np.hstack([self._R, self._t]))
        return self._P

    @property
    def P_pinv(self):
        """4x3 Moore-Penrose pseudo-inverse of P (ray back-projection)."""
        if self._P_pinv is None:
            self._P_pinv = np.linalg.pinv(self.P)
        return self._P_pinv
