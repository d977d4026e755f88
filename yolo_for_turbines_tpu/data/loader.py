"""Batched, prefetching data loader feeding the accelerator.

Replaces torch DataLoader worker processes (reference: code/utils.py:704-784)
with a thread-pool producer + a bounded prefetch queue. PIL decode and numpy
augmentation release the GIL for their hot parts, so threads overlap host
work with device steps without fork overhead; `prefetch_to_device` moves
batches to the device asynchronously so step N+1's transfer overlaps step N's
compute.

Mixed-size safety: the reference defines a padding `collate_fn` but never
wires it in (SURVEY.md section 2 quirk 3); here every batch is materialized
at the dataset's size *at batch-assembly time*, so a mid-epoch
`change_scale()` always produces whole batches of one bucketed size by
construction.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

from .. import config as cfg
from .augment import set_train_transforms, test_transforms
from .dataset import YOLODataset


def collate(samples):
    """Stack (img, (t0, t1, t2)) samples; pads images to the batch max size
    (constant 255) if sizes are mixed (parity with the reference's unused
    collate_fn, code/utils.py:664-702)."""
    images, targets = zip(*samples)
    max_h = max(im.shape[0] for im in images)
    max_w = max(im.shape[1] for im in images)
    padded = []
    for im in images:
        if im.shape[0] != max_h or im.shape[1] != max_w:
            out = np.full((max_h, max_w, im.shape[2]), 255 / 255.0, np.float32)
            out[: im.shape[0], : im.shape[1]] = im
            padded.append(out)
        else:
            padded.append(im)
    batch_imgs = np.stack(padded)
    batch_targets = tuple(
        np.stack([t[i] for t in targets]) for i in range(len(targets[0]))
    )
    return batch_imgs, batch_targets


class DataLoader:
    """Iterates batches; worker threads run __getitem__ concurrently."""

    def __init__(
        self,
        dataset: YOLODataset,
        batch_size: int,
        shuffle: bool = False,
        num_workers: int = 8,
        drop_last: bool = False,
        seed: int = 0,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batch_indices(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        batches = []
        for i in range(0, len(order), self.batch_size):
            chunk = order[i : i + self.batch_size]
            if len(chunk) < self.batch_size and self.drop_last:
                continue
            batches.append(chunk)
        return batches

    def __iter__(self) -> Iterator[Tuple[np.ndarray, tuple]]:
        batches = self._batch_indices()
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            # never block forever on a full queue: a consumer that abandons
            # iteration mid-epoch sets `stop` from the generator's finally,
            # and the producer must notice even while the queue is full
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            # any data failure (corrupt image, bad label file) must still
            # wake the consumer: deliver the exception through the queue
            # rather than dying silently and leaving q.get() blocked forever.
            # BaseException (KeyboardInterrupt/SystemExit during interpreter
            # shutdown) is NOT delivered as a data item — it wakes the
            # consumer with the end-of-data sentinel and propagates in this
            # thread, keeping shutdown semantics distinct from data errors.
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for batch in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__, batch))
                        if not put_or_stop(collate(samples)):
                            return
            except Exception as e:  # re-raised in consumer
                put_or_stop(e)
                return
            except BaseException:
                put_or_stop(None)
                raise
            put_or_stop(None)

        t = threading.Thread(target=produce, daemon=True, name="DataLoader-producer")
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=5.0)


def prefetch_to_device(iterator, size: int = 2, sharding=None):
    """Move batches to device ahead of consumption (double-buffering).

    With a NamedSharding, batches are placed sharded across the mesh's data
    axis (host->HBM transfer overlaps the previous step's compute). A
    CALLABLE `sharding` is used as the placement function batch -> placed
    batch (for meshes whose leaves need different shardings, e.g. spatial
    partitioning: image rows shard, target rows can't — parallel/spatial.py).
    """
    import collections

    import jax

    buf = collections.deque()

    def put(batch):
        if sharding is not None and callable(sharding) and not isinstance(
            sharding, jax.sharding.Sharding
        ):
            return sharding(batch)
        if sharding is not None:
            return jax.tree_util.tree_map(
                lambda x: jax.device_put(x, sharding), batch
            )
        return jax.tree_util.tree_map(jax.device_put, batch)

    it = iter(iterator)
    try:
        for _ in range(size):
            buf.append(put(next(it)))
    except StopIteration:
        pass
    while buf:
        yield buf.popleft()
        try:
            buf.append(put(next(it)))
        except StopIteration:
            pass


def get_loaders(
    csv_folder_path,
    batch_size: int,
    anchors=cfg.ANCHORS,
    train: bool = True,
    image_folder=None,
    annotation_folder=None,
    num_classes: int = cfg.NUM_TURBINE_CLASSES,
    num_workers: int = 8,
    mosaic: bool = False,
    image_size: int = cfg.DEF_IMAGE_SIZE,
    strides=cfg.STRIDES,
    cache_images: bool = False,
):
    """Build train/val/test loaders from split CSVs
    (parity with reference code/utils.py:704-784). `strides` selects the
    detection-scale layout (e.g. (32, 16) for yolov3-tiny)."""
    csv_folder = Path(csv_folder_path)
    image_folder = image_folder or csv_folder / "images"
    annotation_folder = annotation_folder or csv_folder / "labels"
    grid_sizes = cfg.grid_sizes_for(image_size, strides)

    def make(split, transform, is_train):
        return YOLODataset(
            csv_split_file=csv_folder / f"{split}.csv",
            img_folder=image_folder,
            annotation_folder=annotation_folder,
            anchors=anchors,
            batch_size=batch_size,
            image_size=image_size,
            grid_sizes=grid_sizes,
            num_classes=num_classes,
            transform=transform,
            mosaic=mosaic if is_train else False,
            multi_scale=is_train,
            cache_images=cache_images,
        )

    if train:
        train_ds = make("train", set_train_transforms(image_size), True)
        val_ds = make("val", test_transforms(image_size), False)
        # drop_last keeps every training batch full -- required for the
        # data-parallel sharding (batch % mesh size == 0) and avoids
        # recompiles for ragged final batches
        train_loader = DataLoader(
            train_ds, batch_size, shuffle=True, num_workers=num_workers,
            drop_last=True,
        )
        val_loader = DataLoader(
            val_ds, batch_size, shuffle=False, num_workers=num_workers
        )
        return train_loader, val_loader, train_ds
    test_ds = make("test", test_transforms(image_size), False)
    return DataLoader(test_ds, batch_size, shuffle=False, num_workers=num_workers)
