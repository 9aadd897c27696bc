"""The inputs that need cv2 (port of the cv2 parts of
``mast3r_slam_tpu/data/dataloader.py``): images that are neither PNG nor
JPEG, and the webcam.  cv2 is imported where it is used, so this module
loads without it and each of these raises ``ImportError`` there; PNG and
JPEG sequences and video files (``data/video.py``) never load it.
"""

from __future__ import annotations

from .dataloader import MonocularDataset


def imread_rgb(path):
    """(H, W, 3) uint8 RGB of an image file cv2 reads."""
    import cv2

    img = cv2.imread(str(path))
    if img is None:
        raise ValueError(f"{path}: cv2 cannot read it")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def imread_gray(path):
    """(H, W) uint8 of an image file cv2 reads, in gray."""
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise ValueError(f"{path}: cv2 cannot read it")
    return img


class Webcam(MonocularDataset):
    """Live webcam stream through cv2."""

    def __init__(self, device_index: int = -1):
        super().__init__()
        import cv2

        self._cv2 = cv2
        self.cap = cv2.VideoCapture(device_index)
        self.save_results = False
        self.timestamps = []

    def __len__(self):
        return 999_999

    def read_img(self, idx):
        ok, img = self.cap.read()
        if not ok:
            raise ValueError("failed to read webcam frame")
        self.timestamps.append(str(idx / 30.0))
        return self._cv2.cvtColor(img, self._cv2.COLOR_BGR2RGB)

    def subsample(self, stride):
        pass
