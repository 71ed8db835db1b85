"""Input pipeline: ImageNet-style folder loading, CIFAR, synthetic and
procedural data (counterpart of ``uvc_tpu/data/pipeline.py``).

The loaders are the JAX package's, copied: every batch they yield is a
numpy ``(uint8 [B, H, W, C], int32 [B])`` pair, bit for bit what the JAX
package's loaders yield for the same arguments (train: RandomResizedCrop +
horizontal flip and the optional RandAugment / jitter; eval: resize +
center crop; per-host sharding of the epoch-seeded permutation; eval
shards padded with label -1).  The decode runs in a thread pool with a
bounded prefetch queue.  No PIL is used: the PIL path's decode, crops and
resizes, the native path (the JAX package's ``native/uvc_loader.cpp``
re-implemented, ``data/native_loader.py``) and CIFAR's resize run in the
port's own image library (``data/imagelib.py``), each giving the bits of
its JAX counterpart.

Two functions are the card's own: ``device_prefetch`` moves batches to
the device through pinned host buffers on a side CUDA stream, keeping
``depth`` batches in flight, and ``normalize_on_device`` turns the uint8
images into normalized f32 on their device.
"""

from __future__ import annotations

import collections
import functools
import os
import pickle
import queue
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from uvc_tpu_torch.data import imagelib
from uvc_tpu_torch.interop import resolve_device
from uvc_tpu_torch.utils.profiler import span

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def _torch_dtype(a: np.ndarray) -> torch.dtype:
    return torch.from_numpy(np.empty(0, a.dtype)).dtype


class _Slot:
    """One batch's pinned host buffers and the event of their last copy."""

    def __init__(self, arrays):
        self.host = [torch.empty(a.shape, dtype=_torch_dtype(a),
                                 pin_memory=True) for a in arrays]
        self.event = None

    def fits(self, arrays) -> bool:
        return len(arrays) == len(self.host) and all(
            tuple(h.shape) == a.shape and h.dtype == _torch_dtype(a)
            for h, a in zip(self.host, arrays))


def device_prefetch(iterator, depth: int = 2, device="cuda"):
    """Overlap the host-to-device copy with compute: keep ``depth``
    batches in flight.  Each batch (a tuple of numpy arrays) is written
    into pinned host buffers and copied with ``non_blocking`` on a side
    CUDA stream; the consumer's stream waits on the copy's event before it
    gets the tensors, which are marked used on it (``record_stream``) so
    that the allocator does not hand their memory to the copy stream while
    the step still reads them.  A slot of pinned buffers is written again
    only after its last copy's event has completed, so no copy reads a
    buffer that the host is refilling.  On the CPU the batches pass
    through as tensors sharing the arrays' memory.  ``device`` defaults to
    the card and raises where there is none."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        for item in iterator:
            yield tuple(torch.from_numpy(np.ascontiguousarray(a))
                        for a in item)
        return
    stream = torch.cuda.Stream(device=dev)
    slots: "collections.deque" = collections.deque()
    free: List[_Slot] = []
    inflight: "collections.deque" = collections.deque()

    def issue(item):
        arrays = [np.ascontiguousarray(a) for a in item]
        slot = next((s for s in free if s.fits(arrays)), None)
        if slot is None:
            slot = _Slot(arrays)
        else:
            free.remove(slot)
            slot.event.synchronize()      # its last copy has read it
        for h, a in zip(slot.host, arrays):
            h.numpy()[...] = a
        with torch.cuda.stream(stream):
            out = tuple(h.to(dev, non_blocking=True) for h in slot.host)
            slot.event = torch.cuda.Event()
            slot.event.record(stream)
        slots.append(slot)
        inflight.append(out)

    def hand_over():
        out, slot = inflight.popleft(), slots.popleft()
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(slot.event)
        for t in out:
            t.record_stream(consumer)
        free.append(slot)
        return out

    for item in iterator:
        issue(item)
        if len(inflight) >= depth:
            yield hand_over()
    while inflight:
        yield hand_over()


@functools.lru_cache(maxsize=16)
def _stats(mean: tuple, std: tuple, device):
    """The mean and std as f32 tensors on ``device``, made once: a copy
    from the host every batch would wait for the card's queue."""
    return (torch.tensor(mean, dtype=torch.float32, device=device),
            torch.tensor(std, dtype=torch.float32, device=device))


def normalize_on_device(x: torch.Tensor, mean=IMAGENET_MEAN,
                        std=IMAGENET_STD) -> torch.Tensor:
    """uint8 ``[B, H, W, C]`` -> normalized f32 ``(x / 255 - mean) / std``
    on ``x``'s device (a float batch is taken as already scaled)."""
    with span("uvc.normalize"):
        if x.dtype == torch.uint8:
            x = x.float() / 255.0
        m, s = _stats(tuple(float(v) for v in np.asarray(mean, np.float32)),
                      tuple(float(v) for v in np.asarray(std, np.float32)),
                      x.device)
        return (x - m) / s


# ---------------------------------------------------------------------------
# folder scanning
# ---------------------------------------------------------------------------


def scan_image_folder(root: str) -> Tuple[List[str], np.ndarray, List[str]]:
    """torchvision ImageFolder semantics: class = sorted subdirectory."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    paths, labels = [], []
    for idx, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        for dirpath, _, files in os.walk(cdir):
            for f in sorted(files):
                if f.lower().endswith(IMG_EXTS):
                    paths.append(os.path.join(dirpath, f))
                    labels.append(idx)
    return paths, np.asarray(labels, np.int64), classes


# ---------------------------------------------------------------------------
# transforms (the PIL path's, on the port's image library)
# ---------------------------------------------------------------------------
#
# Each transform is a crop plan for ``imagelib.load_crop``: (crop box x0,
# y0, w, h; resize to w, h; centre crop x0, y0, size; flip; filter).  The
# plans are drawn here with numpy as the JAX package draws them around its
# PIL calls, and the library does the pixel work as PIL does it.


def _interp(name: str) -> int:
    return {"bilinear": imagelib.BILINEAR, "bicubic": imagelib.BICUBIC,
            "nearest": imagelib.NEAREST}[name]


def _random_resized_crop(wh: Tuple[int, int], rng: np.random.Generator,
                         size: int, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                         interpolation: str = "bilinear") -> List[int]:
    """The plan of torchvision's RandomResizedCrop for an image of size
    ``wh``: ``img.crop(box).resize((size, size))``."""
    w, h = wh
    area = w * h
    for _ in range(10):
        target = area * rng.uniform(*scale)
        log_r = rng.uniform(np.log(ratio[0]), np.log(ratio[1]))
        ar = np.exp(log_r)
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            x0 = rng.integers(0, w - cw + 1)
            y0 = rng.integers(0, h - ch + 1)
            return [int(x0), int(y0), cw, ch, size, size, 0, 0, size, 0,
                    _interp(interpolation)]
    # fallback: center crop
    return _center_crop(wh, size, size)


def _center_crop(wh: Tuple[int, int], size: int,
                 resize_to: Optional[int] = None,
                 interpolation: str = "bilinear") -> List[int]:
    """The plan of a resize of the shorter side to ``resize_to`` (none
    without it) and a ``size`` x ``size`` centre crop."""
    w, h = wh
    rw, rh = w, h
    if resize_to:
        if w < h:
            rw, rh = resize_to, int(h * resize_to / w)
        else:
            rw, rh = int(w * resize_to / h), resize_to
    return [0, 0, w, h, rw, rh, (rw - size) // 2, (rh - size) // 2, size, 0,
            _interp(interpolation)]


def load_train_image(path: str, rng: np.random.Generator,
                     size: int = 224,
                     interpolation: str = "bilinear") -> np.ndarray:
    plan = _random_resized_crop(imagelib.image_size(path), rng, size,
                                interpolation=interpolation)
    plan[9] = int(rng.random() < 0.5)   # FLIP_LEFT_RIGHT
    return imagelib.load_crop(path, plan)


def eval_resize_for(size: int) -> int:
    """Eval resize target: the reference's Resize(256)+CenterCrop(224)
    ratio (data_utils.py:92-100), scaled to the crop size so 384-px
    configs do not center-crop beyond the resized image."""
    return max(size, int(round(size * 256 / 224)))


def load_eval_image(path: str, size: int = 224,
                    resize_to: int = None,
                    interpolation: str = "bilinear") -> np.ndarray:
    if resize_to is None:
        resize_to = eval_resize_for(size)
    return imagelib.load_crop(path, _center_crop(
        imagelib.image_size(path), size, resize_to,
        interpolation=interpolation))


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------


def load_split_file(root: str, txt: str, rate: float = 1.0):
    """Data-fraction subset from a split file (Baseline_pruning/
    datasets.py:16-42, split_imagenet_dataset): each line is
    ``relpath label``; keep the first ``rate`` fraction of each class."""
    paths, labels = [], []
    with open(txt) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            paths.append(os.path.join(root, parts[0]))
            labels.append(int(parts[1]))
    paths = np.asarray(paths)
    labels = np.asarray(labels, np.int64)
    keep = []
    for c in np.unique(labels):
        idx = np.nonzero(labels == c)[0]
        keep.extend(idx[: int(len(idx) * rate)].tolist())
    return paths[keep].tolist(), labels[keep]


def load_inat(root: str, train: bool = True, year: int = 2018,
              category: str = "name"):
    """iNaturalist annotation-json reader (Baseline_pruning/
    datasets.py:62-100, INatDataset): reads train{year}.json /
    val{year}.json + categories.json, remaps category ids to a dense
    label space keyed by the chosen taxonomic ``category`` level.

    Returns (paths, labels, num_classes) — plug the result into a
    FolderLoader-style consumer or ArrayLoader after decoding.
    """
    import json

    with open(os.path.join(
            root, f"{'train' if train else 'val'}{year}.json")) as f:
        data = json.load(f)
    with open(os.path.join(root, "categories.json")) as f:
        data_catg = json.load(f)
    with open(os.path.join(root, f"train{year}.json")) as f:
        data_train = json.load(f)

    targeter = {}
    for elem in data_train["annotations"]:
        king = data_catg[int(elem["category_id"])][category]
        if king not in targeter:
            targeter[king] = len(targeter)

    paths, labels = [], []
    for elem in data["images"]:
        cut = elem["file_name"].split("/")
        target_current = int(cut[2])
        paths.append(os.path.join(root, cut[0], cut[2], cut[3]))
        labels.append(targeter[data_catg[target_current][category]])
    return paths, np.asarray(labels, np.int64), len(targeter)


def ra_sampler_indices(n: int, epoch: int, rank: int, num_replicas: int,
                       shuffle: bool = True) -> np.ndarray:
    """Repeated-augmentation sampling (DeiT recipe) — RASampler semantics
    (Baseline_pruning/samplers.py:8-59): shuffle with the epoch as seed,
    repeat each index 3x, pad to a multiple of the replica count, stride-
    subsample by rank, then truncate so each replica sees
    floor(n // 256 * 256 / num_replicas) samples."""
    rng = np.random.default_rng(epoch)
    idx = rng.permutation(n) if shuffle else np.arange(n)
    idx = np.repeat(idx, 3)
    num_samples = -(-n * 3 // num_replicas)
    total = num_samples * num_replicas
    idx = np.concatenate([idx, idx[: total - len(idx)]])
    idx = idx[rank:total:num_replicas]
    num_selected = int(n // 256 * 256 / num_replicas)
    return idx[:num_selected]


class FolderLoader:
    """Threaded, double-buffered loader over an image folder.

    Per-host sharding: process ``pid`` of ``pcount`` sees indices
    ``perm[pid::pcount]`` of the epoch-seeded permutation (train) or a
    contiguous slice (eval)."""

    def __init__(self, root: str, batch_size: int, *, train: bool,
                 img_size: int = 224, seed: int = 42, num_workers: int = 16,
                 drop_last: bool = True, pid: int = 0, pcount: int = 1,
                 prefetch: int = 4, repeated_aug: bool = False,
                 split_file: Optional[str] = None, split_rate: float = 1.0,
                 aug=None, interpolation: str = "bilinear"):
        if split_file:
            self.paths, self.labels = load_split_file(root, split_file,
                                                      split_rate)
            self.classes = sorted(set(int(c) for c in self.labels))
        elif isinstance(root, tuple):
            # pre-resolved (paths, labels) — e.g. load_inat output
            self.paths, self.labels = root[0], np.asarray(root[1])
            self.classes = sorted(set(int(c) for c in self.labels))
        else:
            self.paths, self.labels, self.classes = scan_image_folder(root)
        self.batch_size = batch_size
        self.train = train
        self.img_size = img_size
        self.seed = seed
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.pid, self.pcount = pid, pcount
        self.prefetch = prefetch
        self.repeated_aug = repeated_aug
        # per-image augmentation fn(uint8_hwc, np_rng) -> uint8_hwc applied
        # after crop+flip (timm transform order: RandAugment / color jitter,
        # see uvc_tpu/data/augment.py)
        self.aug = aug
        # the native path implements bilinear AND bicubic (the DeiT recipe
        # trains bicubic); other interpolations (nearest) select the PIL
        # path
        self.interpolation = interpolation
        self.epoch = 0

    def __len__(self):
        if self.train:
            if self.repeated_aug:
                n = int(len(self.paths) // 256 * 256 / self.pcount)
            else:
                n = len(self.paths) // self.pcount
            return n // self.batch_size if self.drop_last else \
                -(-n // self.batch_size)
        # eval: every image is seen exactly once globally; shards and the
        # final batch are padded with sentinel label -1 entries (masked in
        # the eval reduction) instead of dropped.  Fixes the reference
        # --dist-eval duplication bias (Baseline_pruning/main.py:221-227)
        # and the plain DataLoader tail drop.
        shard = -(-len(self.paths) // self.pcount)
        return -(-shard // self.batch_size)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.paths)
        if self.train:
            if self.repeated_aug:
                return ra_sampler_indices(n, self.seed + self.epoch,
                                          self.pid, self.pcount)
            rng = np.random.default_rng(self.seed + self.epoch)
            perm = rng.permutation(n)
            return perm[self.pid::self.pcount]
        # eval: contiguous shards padded to equal size with -1 sentinels so
        # every process runs the same number of equally-shaped batches
        shard = -(-n // self.pcount)
        idx = np.full(shard * self.pcount, -1, np.int64)
        idx[:n] = np.arange(n)
        return idx[self.pid * shard:(self.pid + 1) * shard]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        idx = self._indices()
        if self.train:
            nb = len(idx) // self.batch_size if self.drop_last else \
                -(-len(idx) // self.batch_size)
        else:
            nb = -(-len(idx) // self.batch_size)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                from concurrent.futures import ThreadPoolExecutor
                from uvc_tpu_torch.data import native_loader
                use_native = (native_loader.available() and
                              self.interpolation in ("bilinear", "bicubic"))
                base_rng = np.random.default_rng(
                    (self.seed + self.epoch) * 1000 + self.pid)
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in range(nb):
                        if stop.is_set():
                            return
                        bs = self.batch_size
                        sel = idx[b * bs:(b + 1) * bs]
                        if not self.train and len(sel) < bs:
                            # pad the final eval batch to the static shape
                            sel = np.concatenate(
                                [sel, np.full(self.batch_size - len(sel), -1,
                                              np.int64)])
                        pad = sel < 0
                        sel = np.where(pad, 0, sel)
                        seeds = base_rng.integers(0, 2**31, len(sel))
                        if use_native:
                            # the native path; the files it does not take go
                            # through the PIL path one by one
                            x = native_loader.load_batch(
                                [self.paths[i] for i in sel], self.img_size,
                                train=self.train,
                                seeds=seeds.astype(np.uint64),
                                interpolation=self.interpolation,
                                num_threads=self.num_workers)
                        else:
                            def one(args):
                                i, s = args
                                if self.train:
                                    return load_train_image(
                                        self.paths[i],
                                        np.random.default_rng(int(s)),
                                        self.img_size,
                                        interpolation=self.interpolation)
                                return load_eval_image(
                                    self.paths[i], self.img_size,
                                    interpolation=self.interpolation)

                            x = np.stack(list(pool.map(one, zip(sel, seeds))))
                        if self.train and self.aug is not None:
                            # RandAugment / jitter on the cropped image, one
                            # rng stream per image derived from its crop seed
                            def aug_one(args):
                                img, s = args
                                return self.aug(
                                    img, np.random.default_rng(int(s) + 17))

                            x = np.stack(list(pool.map(aug_one,
                                                       zip(x, seeds))))
                        y = self.labels[sel].astype(np.int32)
                        if pad.any():
                            x[pad] = 0
                            y[pad] = -1   # sentinel, masked in eval reductions
                        out_q.put((x, y))
            except BaseException as e:  # noqa: BLE001 - the consumer raises it
                out_q.put(e)
                return
            out_q.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item      # a file that cannot be read, say
                yield item
        finally:
            stop.set()


class SyntheticLoader:
    """Deterministic random data; used by bench.py and smoke tests."""

    def __init__(self, batch_size: int, *, num_batches: int = 100,
                 img_size: int = 224, num_classes: int = 1000,
                 seed: int = 0):
        rng = np.random.default_rng(seed)
        self.x = rng.integers(0, 256, (batch_size, img_size, img_size, 3),
                              dtype=np.uint8)
        self.y = rng.integers(0, num_classes, (batch_size,)).astype(np.int32)
        self.num_batches = num_batches
        self.batch_size = batch_size

    def __len__(self):
        return self.num_batches

    def set_epoch(self, epoch: int):
        pass

    def __iter__(self):
        for _ in range(self.num_batches):
            yield self.x, self.y


class ProceduralLoader:
    """Learnable synthetic data for end-to-end accuracy evidence.

    Each class is a fixed low-frequency pattern (a seeded sum of 2-D
    sinusoids per RGB channel); an image is ``contrast * template +
    (1 - contrast) * noise`` with a fresh per-image noise field.  The
    train split draws a new noise stream every epoch (effectively
    infinite data) while the eval split is a fixed held-out stream, so
    eval accuracy measures genuine generalization — unlike
    ``SyntheticLoader``'s label-free random batch.  No dataset files are
    needed (this environment has no network egress and no ImageNet);
    this is the closest attainable stand-in for the reference's
    accuracy-at-scale evidence (its published ImageNet logs).
    """

    def __init__(self, batch_size: int, *, num_batches: int = 50,
                 img_size: int = 32, num_classes: int = 10,
                 train: bool = True, contrast: float = 0.55,
                 freq: float = 4.0, noise_mode: str = "white",
                 jitter: int = 0, contrast_range=None,
                 seed: int = 0, pid: int = 0, pcount: int = 1):
        """Difficulty knobs (defaults reproduce the original task):

        contrast    template weight in the template/noise blend.
        freq        max spatial frequency of the class templates (cycles
                    per image).
        noise_mode  "white": iid uniform noise (trivially averaged out by
                    a low-frequency template matcher).  "lowpass": noise
                    filtered into the SAME spectral band as the templates
                    — distractors the model cannot remove by smoothing.
        jitter      per-image random circular shift (px) applied to the
                    template: class identity stays (the frequency set is
                    shift-invariant) but pixel-position memorization
                    stops working.
        contrast_range  (lo, hi): per-IMAGE contrast drawn uniformly from
                    the range instead of the scalar ``contrast``.  A
                    difficulty *spectrum* makes accuracy measure where a
                    model's decoding threshold sits — strictly increasing
                    in model quality with no 1.0 ceiling (images near
                    ``lo`` stay ambiguous for any model), which keeps the
                    e2e accuracy gates discriminative at every pipeline
                    stage (VERDICT r4: a single-contrast task saturates
                    once the total training budget is large enough).
        """
        self.batch_size = batch_size
        self.num_batches = num_batches
        self.img_size = img_size
        self.num_classes = num_classes
        self.train = train
        self.contrast = contrast
        self.contrast_range = contrast_range
        self.freq = freq
        self.noise_mode = noise_mode
        self.jitter = jitter
        self.seed = seed
        self.pid = pid
        self.pcount = pcount
        self.epoch = 0
        # class templates: K waves per channel, low spatial frequency so
        # patches carry class signal at any patch size
        trng = np.random.default_rng(seed + 7919)
        yy, xx = np.mgrid[0:img_size, 0:img_size] / img_size
        tpl = np.zeros((num_classes, img_size, img_size, 3), np.float32)
        for c in range(num_classes):
            for ch in range(3):
                for _ in range(4):
                    fx, fy = trng.uniform(-freq, freq, 2)
                    ph = trng.uniform(0, 2 * np.pi)
                    tpl[c, :, :, ch] += np.sin(
                        2 * np.pi * (fx * xx + fy * yy) + ph)
        lo = tpl.min(axis=(1, 2, 3), keepdims=True)
        hi = tpl.max(axis=(1, 2, 3), keepdims=True)
        self.templates = (tpl - lo) / (hi - lo + 1e-8)

    def __len__(self):
        return self.num_batches

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _lowpass_noise(self, rng, n):
        """Gaussian noise band-limited to the template spectrum (cutoff
        = self.freq cycles/image), per-image normalized to [0, 1]."""
        s = self.img_size
        z = rng.standard_normal((n, s, s, 3)).astype(np.float32)
        spec = np.fft.rfft2(z, axes=(1, 2))
        fy = (np.fft.fftfreq(s) * s)[:, None]
        fx = (np.fft.rfftfreq(s) * s)[None, :]
        keep = (np.sqrt(fx * fx + fy * fy) <= self.freq
                )[None, :, :, None]
        x = np.fft.irfft2(spec * keep, s=(s, s), axes=(1, 2)
                          ).astype(np.float32)
        lo = x.min(axis=(1, 2, 3), keepdims=True)
        hi = x.max(axis=(1, 2, 3), keepdims=True)
        return (x - lo) / (hi - lo + 1e-8)

    def _batch(self, rng):
        y = rng.integers(0, self.num_classes,
                         (self.batch_size,)).astype(np.int32)
        if self.noise_mode == "lowpass":
            noise = self._lowpass_noise(rng, self.batch_size)
        else:
            noise = rng.random(
                (self.batch_size, self.img_size, self.img_size, 3),
                dtype=np.float32)
        tpl = self.templates[y]
        if self.jitter:
            sh = rng.integers(-self.jitter, self.jitter + 1,
                              (self.batch_size, 2))
            tpl = np.stack([
                np.roll(t, (int(dy), int(dx)), axis=(0, 1))
                for t, (dy, dx) in zip(tpl, sh)])
        if self.contrast_range is not None:
            lo, hi = self.contrast_range
            c = rng.uniform(lo, hi, (self.batch_size, 1, 1, 1)
                            ).astype(np.float32)
        else:
            c = self.contrast
        x = c * tpl + (1.0 - c) * noise
        return (x * 255.0).astype(np.uint8), y

    def __iter__(self):
        # train: stream re-seeded every epoch (tags 2, 3, ...); eval: the
        # epoch-independent held-out tag 1 — disjoint for any seed >= 0
        tag = (self.epoch + 2) if self.train else 1
        rng = np.random.default_rng(
            (self.seed * 131 + tag) * 1009 + self.pid * 31 + 1)
        for _ in range(self.num_batches):
            yield self._batch(rng)


def cifar_arrays(data_dir: str, dataset: str = "cifar10", train: bool = True
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Read standard CIFAR python-pickle batches from disk
    (reference downloads via torchvision: data_utils.py:19-65)."""
    if dataset == "cifar10":
        base = os.path.join(data_dir, "cifar-10-batches-py")
        files = [f"data_batch_{i}" for i in range(1, 6)] if train \
            else ["test_batch"]
        label_key = b"labels"
    else:
        base = os.path.join(data_dir, "cifar-100-python")
        files = ["train"] if train else ["test"]
        label_key = b"fine_labels"
    xs, ys = [], []
    for f in files:
        with open(os.path.join(base, f), "rb") as fh:
            d = pickle.load(fh, encoding="bytes")
        xs.append(d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        ys.append(np.asarray(d[label_key]))
    return np.concatenate(xs).astype(np.uint8), \
        np.concatenate(ys).astype(np.int32)


class ArrayLoader:
    """In-memory loader (CIFAR); resizes to img_size on the fly."""

    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int, *,
                 train: bool, img_size: int = 224, seed: int = 42,
                 pid: int = 0, pcount: int = 1, aug=None):
        self.x, self.y = x, y
        self.batch_size = batch_size
        self.train = train
        self.img_size = img_size
        self.seed = seed
        self.pid, self.pcount = pid, pcount
        self.aug = aug
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        if self.train:
            return (len(self.x) // self.pcount) // self.batch_size
        shard = -(-len(self.x) // self.pcount)
        return -(-shard // self.batch_size)

    def __iter__(self):
        n = len(self.x)
        if self.train:
            rng = np.random.default_rng(self.seed + self.epoch)
            idx = rng.permutation(n)[self.pid::self.pcount]
        else:
            # padded full-coverage eval shards (see FolderLoader._indices)
            shard = -(-n // self.pcount)
            idx = np.full(shard * self.pcount, -1, np.int64)
            idx[:n] = np.arange(n)
            idx = idx[self.pid * shard:(self.pid + 1) * shard]
        for b in range(len(self)):
            sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
            pad = None
            if not self.train:
                if len(sel) < self.batch_size:
                    sel = np.concatenate(
                        [sel, np.full(self.batch_size - len(sel), -1,
                                      np.int64)])
                pad = sel < 0
                sel = np.where(pad, 0, sel)
            if self.img_size != self.x.shape[1]:
                imgs = [imagelib.resize(self.x[i], self.img_size,
                                        self.img_size, imagelib.BILINEAR)
                        for i in sel]
                xb = np.stack(imgs)
            else:
                xb = self.x[sel]
            if self.train and self.aug is not None:
                rng2 = np.random.default_rng(
                    (self.seed + self.epoch) * 7919 + b)
                xb = np.stack([self.aug(img, rng2) for img in xb])
            yb = self.y[sel].astype(np.int32)
            if pad is not None and pad.any():
                xb = xb.copy()
                xb[pad] = 0
                yb[pad] = -1
            yield xb, yb
