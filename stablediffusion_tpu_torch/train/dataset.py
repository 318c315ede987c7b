"""Folder dataset: *.jpg/*.png images with sibling *.txt captions.

The port's own copy of the jax-free ``stablediffusion_tpu/train/dataset.py``
(the port imports nothing of the JAX package), unchanged in behaviour: with
the same seed it yields the same batches, array for array.

The reference's SDLoRADataset (train_lora_pipeline.py:62-123): random square
crop at native min side, resize to target, hflip, normalize to [-1,1], plus
the SDXL micro-conditioning tuple (original_sizes, crop_top_left,
target_sizes).  The reference's hflip probability is accidentally 1.0
(train_lora_pipeline.py:74); here it is 0.5 and flag-controlled per the
SURVEY.md behavior-vs-bug ledger.

Host-side numpy/PIL; emits ready NHWC float32 batches.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np

try:
    from PIL import Image

    _HAS_PIL = True
except ImportError:  # pragma: no cover
    _HAS_PIL = False

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".webp", ".bmp")


@dataclass
class Example:
    pixel_values: np.ndarray  # [H, W, 3] float32 in [-1, 1]
    caption: str
    original_size: tuple
    crop_top_left: tuple
    target_size: tuple
    filename: str = ""
    # ControlNet training: the control image, SAME geometry as pixel_values
    # but in [0, 1] (diffusers train_controlnet.py conditioning transforms
    # have no normalize)
    conditioning_pixel_values: Optional[np.ndarray] = None


def bucket_resolutions(
    base_resolution: int,
    step: int = 64,
    max_ar: float = 2.0,
    min_side: Optional[int] = None,
) -> List[tuple]:
    """kohya-style aspect-ratio buckets: every (H, W) with both sides
    multiples of `step`, area <= base_resolution^2 (maximized per aspect),
    aspect ratio within [1/max_ar, max_ar], sides >= min_side.  XLA compiles
    one train-step executable per bucket shape, so the list is kept small
    (typically 10-20 buckets at step 64)."""
    if min_side is None:
        # kohya's 256 floor at production sizes; scale down for small bases
        min_side = max(step, min(256, base_resolution // 2))
    area = base_resolution * base_resolution
    buckets = {(base_resolution, base_resolution)}
    w = min_side
    while w * min_side <= area:
        h = min(int(area / w) // step * step, int(w * max_ar) // step * step)
        if h >= min_side and h >= w / max_ar:
            buckets.add((h, w))
            buckets.add((w, h))
        w += step
    return sorted(buckets)


def assign_bucket(height: int, width: int, buckets: List[tuple]) -> int:
    """Index of the bucket whose aspect ratio is nearest (in log space) to
    the image's."""
    a = np.log(width / height)
    return int(np.argmin([abs(np.log(bw / bh) - a) for bh, bw in buckets]))


def transform_image(
    img,
    rng: np.random.Generator,
    resolution,
    center_crop: bool,
    random_flip: bool,
    flip_p: float,
    conditioning_img=None,
):
    """Shared train-time transform (ref: train_lora_pipeline.py:62-123 and the
    diffusers CLIs' train_transforms): square crop at native min side, resize,
    optional hflip, [-1,1] normalize; returns the SDXL micro-conditioning
    tuple alongside the array.

    `conditioning_img` (ControlNet training) gets the IDENTICAL geometry
    (crop/resize/flip) but stays in [0, 1] — paired pixels must line up.

    `resolution`: an int keeps the reference's square crop-then-resize
    path bit-identical; an (H, W) tuple is the aspect-ratio-bucket path
    (cover-resize then crop to the bucket, diffusers SDXL convention:
    crop coordinates recorded in resized space)."""
    img = img.convert("RGB")
    W, H = img.size
    original_size = (H, W)

    if isinstance(resolution, (tuple, list)):
        th, tw = int(resolution[0]), int(resolution[1])
        scale = max(th / H, tw / W)
        rh, rw = max(th, round(H * scale)), max(tw, round(W * scale))
        if center_crop:
            top, left = (rh - th) // 2, (rw - tw) // 2
        else:
            top = int(rng.integers(0, rh - th + 1))
            left = int(rng.integers(0, rw - tw + 1))
        flip = random_flip and rng.random() < flip_p

        def geom_bucket(im):
            im = im.resize((rw, rh), Image.BILINEAR)
            im = im.crop((left, top, left + tw, top + th))
            a = np.asarray(im, np.float32) / 255.0
            return a[:, ::-1] if flip else a

        arr = geom_bucket(img)
        cond_arr = None
        if conditioning_img is not None:
            cond_arr = geom_bucket(conditioning_img.convert("RGB")).copy()
        if flip:
            left = rw - left - tw
        arr = arr * 2.0 - 1.0
        return arr.copy(), original_size, (top, left), (th, tw), cond_arr

    side = min(H, W)
    if center_crop:
        top, left = (H - side) // 2, (W - side) // 2
    else:
        top = int(rng.integers(0, H - side + 1))
        left = int(rng.integers(0, W - side + 1))
    flip = random_flip and rng.random() < flip_p

    def geom(im):
        im = im.crop((left, top, left + side, top + side))
        im = im.resize((resolution, resolution), Image.BILINEAR)
        a = np.asarray(im, np.float32) / 255.0
        return a[:, ::-1] if flip else a

    arr = geom(img)
    cond_arr = None
    if conditioning_img is not None:
        cond_arr = geom(conditioning_img.convert("RGB")).copy()
    if flip:
        # mirror the crop x-coordinate for the conditioning tuple
        left = W - left - side
    arr = arr * 2.0 - 1.0
    return arr.copy(), original_size, (top, left), (resolution, resolution), cond_arr


def _collate(examples) -> Dict[str, np.ndarray]:
    out = {
        "pixel_values": np.stack([e.pixel_values for e in examples]),
        "captions": [e.caption for e in examples],
        "filenames": [e.filename for e in examples],
        "original_sizes": np.asarray(
            [e.original_size for e in examples], np.float32
        ),
        "crop_top_lefts": np.asarray(
            [e.crop_top_left for e in examples], np.float32
        ),
        "target_sizes": np.asarray(
            [e.target_size for e in examples], np.float32
        ),
    }
    if examples[0].conditioning_pixel_values is not None:
        out["conditioning_pixel_values"] = np.stack(
            [e.conditioning_pixel_values for e in examples]
        )
    return out


class SDLoRADataset:
    def __init__(
        self,
        data_dir: str,
        resolution: int = 1024,
        random_flip: bool = True,
        flip_p: float = 0.5,
        center_crop: bool = False,
        seed: int = 0,
        conditioning_dir: Optional[str] = None,
        aspect_ratio_bucketing: bool = False,
        bucket_step: int = 64,
        max_bucket_ar: float = 2.0,
        max_buckets: Optional[int] = None,
    ):
        """`conditioning_dir` (ControlNet training): a sibling folder holding
        the control image for each training image under the SAME filename.

        `aspect_ratio_bucketing` (kohya-style, beyond the reference's square
        crop): images group into buckets of equal aspect ratio at ~constant
        area resolution^2; every batch is drawn from ONE bucket, so non-
        square images train at their native aspect instead of being center-
        mutilated.  Each distinct bucket shape costs one extra XLA compile
        of the train step (the step is shape-polymorphic under jit).

        `max_buckets` caps the number of OCCUPIED buckets (each one is a
        separate multi-minute XLA train-step compile on a remote-compile
        TPU; benchmarks/bench_bucket_compile.py records the per-bucket
        bill): smallest buckets merge into the nearest-aspect survivor
        (items re-crop to the surviving shape) until the cap holds."""
        self.data_dir = data_dir
        self.resolution = resolution
        self.random_flip = random_flip
        self.flip_p = flip_p
        self.center_crop = center_crop
        self.conditioning_dir = conditioning_dir
        self.rng = np.random.default_rng(seed)
        self.items: List[str] = sorted(
            os.path.join(data_dir, f)
            for f in os.listdir(data_dir)
            if f.lower().endswith(IMAGE_EXTS)
        )
        if not self.items:
            raise ValueError(f"no images found in {data_dir}")
        if conditioning_dir is not None:
            missing = [
                os.path.basename(p)
                for p in self.items
                if self._conditioning_path(p) is None
            ]
            if missing:
                raise ValueError(
                    f"no conditioning image in {conditioning_dir} for: "
                    f"{missing[:5]}"
                )
        self.buckets: Optional[List[tuple]] = None
        if aspect_ratio_bucketing:
            self.buckets = bucket_resolutions(
                resolution, step=bucket_step, max_ar=max_bucket_ar)
            # PIL reads only the header for .size — no pixel decode here
            self.bucket_items: List[List[int]] = [[] for _ in self.buckets]
            for i, path in enumerate(self.items):
                with Image.open(path) as im:
                    w, h = im.size
                self.bucket_items[assign_bucket(h, w, self.buckets)].append(i)
            if max_buckets is not None:
                self._merge_buckets(int(max_buckets))

    def _merge_buckets(self, max_buckets: int) -> None:
        """Merge the smallest occupied buckets into their nearest-aspect
        (log-space) occupied neighbor until at most `max_buckets` remain.
        Compile cost scales with OCCUPIED shapes only, so empties are free
        and ignored."""
        if max_buckets < 1:
            raise ValueError(f"max_buckets must be >= 1, got {max_buckets}")

        def occupied():
            return [b for b, it in enumerate(self.bucket_items) if it]

        while len(occupied()) > max_buckets:
            occ = occupied()
            src = min(occ, key=lambda b: len(self.bucket_items[b]))
            sh, sw = self.buckets[src]
            a = np.log(sw / sh)
            dst = min(
                (b for b in occ if b != src),
                key=lambda b: abs(
                    np.log(self.buckets[b][1] / self.buckets[b][0]) - a
                ),
            )
            self.bucket_items[dst].extend(self.bucket_items[src])
            self.bucket_items[src] = []

    def _conditioning_path(self, img_path: str) -> Optional[str]:
        if self.conditioning_dir is None:
            return None
        stem = os.path.splitext(os.path.basename(img_path))[0]
        for ext in IMAGE_EXTS:
            cand = os.path.join(self.conditioning_dir, stem + ext)
            if os.path.exists(cand):
                return cand
        return None

    def __len__(self) -> int:
        return len(self.items)

    def _caption(self, img_path: str) -> str:
        txt = os.path.splitext(img_path)[0] + ".txt"
        if os.path.exists(txt):
            with open(txt, encoding="utf-8") as f:
                return f.read().strip()
        return ""

    def __getitem__(self, idx: int) -> Example:
        return self._load_item(idx, self.rng)

    def _load_item(self, idx: int, rng, size=None) -> Example:
        path = self.items[idx]
        cond_path = self._conditioning_path(path)
        arr, original_size, crop_top_left, target_size, cond = transform_image(
            Image.open(path), rng, size or self.resolution, self.center_crop,
            self.random_flip, self.flip_p,
            conditioning_img=Image.open(cond_path) if cond_path else None,
        )
        return Example(
            pixel_values=arr,
            caption=self._caption(path),
            original_size=original_size,
            crop_top_left=crop_top_left,
            target_size=target_size,
            filename=os.path.basename(path),
            conditioning_pixel_values=cond,
        )

    def batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        epochs: Optional[int] = None,
        shard_index: int = 0,
        num_shards: int = 1,
        drop_last: bool = True,
        num_workers: int = 8,
        prefetch: int = 1,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Epoch iterator of collated batches (collate analog,
        train_lora_pipeline.py:320-342).  `shard_index/num_shards` give
        per-host sharding for multi-host data parallel.

        Image decode/augment runs on `num_workers` threads (PIL releases the
        GIL) with `prefetch` batches built ahead, so host-side IO overlaps
        the device step.  Each item gets its own spawned RNG — results don't
        depend on thread scheduling or worker count."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(num_workers) if num_workers > 1 else None
        # batch-assembly wrappers block on per-item futures; they must run on
        # their OWN executor or they could occupy every item worker and
        # deadlock (wrappers waiting on item tasks that can never start)
        assembler = ThreadPoolExecutor(prefetch + 1) if pool is not None else None

        def load_batch(idxs, rngs, size=None):
            # rngs are spawned by the CALLER (main thread) so the stream is
            # deterministic regardless of worker scheduling
            pairs = list(zip([int(i) for i in idxs], rngs))
            if pool is None:
                ex = [self._load_item(i, r, size=size) for i, r in pairs]
            else:
                ex = list(pool.map(lambda p: self._load_item(
                    p[0], p[1], size=size), pairs))
            return _collate(ex)

        def index_stream():
            """Yields (idxs, size): size is None on the square path, the
            bucket (H, W) under aspect-ratio bucketing (batches are drawn
            from ONE bucket; batch ORDER is shuffled across buckets and
            sharded at batch granularity so every host sees whole,
            shape-homogeneous batches)."""
            epoch = 0
            while epochs is None or epoch < epochs:
                if getattr(self, "buckets", None):
                    all_batches = []
                    for b, bidxs in enumerate(self.bucket_items):
                        order = np.asarray(bidxs)
                        if shuffle:
                            self.rng.shuffle(order)
                        stop = len(order) - (batch_size - 1 if drop_last else 0)
                        for s in range(0, max(stop, 0), batch_size):
                            all_batches.append(
                                (order[s : s + batch_size], self.buckets[b]))
                    border = (
                        self.rng.permutation(len(all_batches))
                        if shuffle else np.arange(len(all_batches))
                    )
                    for i in border[shard_index::num_shards]:
                        yield all_batches[int(i)]
                else:
                    order = np.arange(len(self))
                    if shuffle:
                        self.rng.shuffle(order)
                    order = order[shard_index::num_shards]
                    stop = len(order) - (batch_size - 1 if drop_last else 0)
                    for s in range(0, stop, batch_size):
                        idxs = order[s : s + batch_size]
                        if drop_last and len(idxs) < batch_size:
                            break
                        yield idxs, None
                epoch += 1

        try:
            if pool is None:
                for idxs, size in index_stream():
                    yield load_batch(idxs, self.rng.spawn(len(idxs)), size)
                return
            pending = deque()
            stream = index_stream()
            for idxs, size in stream:
                pending.append(
                    assembler.submit(
                        load_batch, idxs, self.rng.spawn(len(idxs)), size)
                )
                if len(pending) > prefetch:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()
        finally:
            if pool is not None:
                assembler.shutdown(wait=False, cancel_futures=True)
                pool.shutdown(wait=False, cancel_futures=True)


class DreamBoothDataset:
    """Prior-preservation pairing (Ruiz et al. 2022, arXiv 2208.12242; the
    diffusers train_dreambooth collate): every batch is
    [instance images | class images] with their fixed prompts; the loss
    splits the halves and weights the class (prior) half separately.

    The class stream cycles forever — epochs are counted on the instance
    set.  Aspect-ratio bucketing is not supported (the two halves must
    share one shape)."""

    def __init__(
        self,
        instance_dir: str,
        instance_prompt: str,
        class_dir: str,
        class_prompt: str,
        **ds_kwargs,
    ):
        if ds_kwargs.get("aspect_ratio_bucketing"):
            raise ValueError(
                "DreamBooth prior preservation cannot use aspect-ratio "
                "bucketing (instance/class halves must share one shape)")
        self.instance = SDLoRADataset(instance_dir, **ds_kwargs)
        self.class_set = SDLoRADataset(class_dir, **ds_kwargs)
        self.instance_prompt = instance_prompt
        self.class_prompt = class_prompt
        self.buckets = None

    def __len__(self) -> int:
        return len(self.instance)

    def batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        epochs: Optional[int] = None,
        shard_index: int = 0,
        num_shards: int = 1,
        **kw,
    ):
        gi = self.instance.batches(
            batch_size, shuffle=shuffle, epochs=epochs,
            shard_index=shard_index, num_shards=num_shards, **kw,
        )
        gc = self.class_set.batches(
            batch_size, shuffle=shuffle, epochs=None,
            shard_index=shard_index, num_shards=num_shards, **kw,
        )

        def gen():
            try:
                for bi in gi:
                    bc = next(gc)
                    n_i = bi["pixel_values"].shape[0]
                    n_c = bc["pixel_values"].shape[0]
                    out = {
                        "pixel_values": np.concatenate(
                            [bi["pixel_values"], bc["pixel_values"]]
                        ),
                        "captions": (
                            [self.instance_prompt] * n_i
                            + [self.class_prompt] * n_c
                        ),
                        "filenames": bi["filenames"] + bc["filenames"],
                    }
                    for k in ("original_sizes", "crop_top_lefts",
                              "target_sizes"):
                        out[k] = np.concatenate([bi[k], bc[k]])
                    yield out
            finally:
                gi.close()
                gc.close()

        return gen()


class HFImageCaptionDataset(SDLoRADataset):
    """`datasets`-backed image/caption dataset — the reference CLIs'
    `--dataset_name` path (hub dataset, local `load_dataset` script, or a
    local imagefolder with metadata captions; ref:
    diffusers_scripts/train_text_to_image_lora.py:594-709).

    Column resolution mirrors the reference: explicit --image_column /
    --caption_column win; otherwise 'image'/'text'-style names, falling back
    to the first (image) and second (caption) columns.
    """

    #: well-known caption column names, in priority order
    CAPTION_CANDIDATES = ("text", "caption", "captions", "prompt")

    def __init__(
        self,
        dataset_name: Optional[str] = None,
        dataset_config_name: Optional[str] = None,
        data_dir: Optional[str] = None,
        cache_dir: Optional[str] = None,
        image_column: Optional[str] = None,
        caption_column: Optional[str] = None,
        split: str = "train",
        resolution: int = 1024,
        random_flip: bool = True,
        flip_p: float = 0.5,
        center_crop: bool = False,
        seed: int = 0,
        conditioning_image_column: Optional[str] = None,
    ):
        import datasets as hf_datasets

        if dataset_name is not None:
            ds = hf_datasets.load_dataset(
                dataset_name,
                dataset_config_name,
                cache_dir=cache_dir,
                data_dir=data_dir,
            )
        else:
            # local folder with metadata.jsonl / class subfolders
            ds = hf_datasets.load_dataset(
                "imagefolder", data_dir=data_dir, cache_dir=cache_dir
            )
        if split not in ds:
            split = next(iter(ds))
        self.ds = ds[split]

        cols = list(self.ds.column_names)
        if image_column is None:
            image_column = "image" if "image" in cols else cols[0]
        elif image_column not in cols:
            raise ValueError(
                f"--image_column {image_column!r} not in dataset columns {cols}"
            )
        if caption_column is None:
            caption_column = next(
                (c for c in self.CAPTION_CANDIDATES if c in cols),
                cols[1] if len(cols) > 1 else None,
            )
        elif caption_column not in cols:
            raise ValueError(
                f"--caption_column {caption_column!r} not in dataset columns {cols}"
            )
        self.image_column = image_column
        self.caption_column = caption_column
        # ControlNet training (diffusers train_controlnet.py
        # --conditioning_image_column, default 'conditioning_image')
        if conditioning_image_column is not None and (
            conditioning_image_column not in cols
        ):
            raise ValueError(
                f"--conditioning_image_column {conditioning_image_column!r} "
                f"not in dataset columns {cols}"
            )
        self.conditioning_image_column = conditioning_image_column

        self.resolution = resolution
        self.random_flip = random_flip
        self.flip_p = flip_p
        self.center_crop = center_crop
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.ds)

    def _pick_caption(self, value, rng=None) -> str:
        # the reference accepts str or list-of-str columns (random choice)
        rng = rng if rng is not None else self.rng
        if value is None:
            return ""
        if isinstance(value, str):
            return value
        if isinstance(value, (list, tuple, np.ndarray)):
            if len(value) == 0:
                return ""
            return str(value[int(rng.integers(0, len(value)))])
        raise ValueError(
            f"caption column should be str or list of str, got {type(value)}"
        )

    def __getitem__(self, idx: int) -> Example:
        return self._load_item(idx, self.rng)

    def _load_item(self, idx: int, rng, size=None) -> Example:
        row = self.ds[int(idx)]
        img = row[self.image_column]
        if isinstance(img, str):  # path column
            img = Image.open(img)
        cond_img = None
        if self.conditioning_image_column is not None:
            cond_img = row[self.conditioning_image_column]
            if isinstance(cond_img, str):
                cond_img = Image.open(cond_img)
        arr, original_size, crop_top_left, target_size, cond = transform_image(
            img, rng, size or self.resolution, self.center_crop,
            self.random_flip, self.flip_p, conditioning_img=cond_img,
        )
        caption = (
            self._pick_caption(row.get(self.caption_column), rng)
            if self.caption_column
            else ""
        )
        return Example(
            pixel_values=arr,
            caption=caption,
            original_size=original_size,
            crop_top_left=crop_top_left,
            target_size=target_size,
            filename=str(idx),
            conditioning_pixel_values=cond,
        )
