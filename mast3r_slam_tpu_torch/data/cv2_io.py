"""The inputs that need cv2 (port of the cv2 parts of
``mast3r_slam_tpu/data/dataloader.py``): JPEG and other non-PNG images,
MP4 video and the webcam.  cv2 is imported where it is used, so this module
loads without it and each of these raises ``ImportError`` there; the PNG
sequences never load it.
"""

from __future__ import annotations

import pathlib

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



class MP4Dataset(MonocularDataset):
    """Video ingest through cv2."""

    def __init__(self, dataset_path, stride: int = 1):
        super().__init__()
        import cv2

        self._cv2 = cv2
        self.dataset_path = pathlib.Path(dataset_path)
        self.cap = cv2.VideoCapture(str(self.dataset_path))
        self.fps = self.cap.get(cv2.CAP_PROP_FPS) or 30.0
        self.total_frames = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.stride = stride
        self._next_decode = 0
        self.timestamps = [str(i * stride / self.fps) for i in range(len(self))]

    def __len__(self):
        return self.total_frames // self.stride

    def subsample(self, stride: int):
        self.stride *= stride
        self.timestamps = [str(i * self.stride / self.fps) for i in range(len(self))]

    def read_img(self, idx):
        cv2 = self._cv2
        target = idx * self.stride
        if target != self._next_decode:
            self.cap.set(cv2.CAP_PROP_POS_FRAMES, target)
        ret, img = self.cap.read()
        self._next_decode = target + 1
        if not ret:
            raise ValueError(f"failed to decode frame {target}")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
