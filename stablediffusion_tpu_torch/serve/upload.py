"""Image upload sink for serving: when BUCKET_ENDPOINT_URL is set, images are
uploaded and URLs returned; otherwise the handler answers in base64.

The port's copy of ``stablediffusion_tpu/serve/upload.py``.  Backends,
resolved from BUCKET_ENDPOINT_URL's scheme:
  * ``gs://bucket/prefix``      — Google Cloud Storage (google-cloud-storage
                                  library)
  * ``file:///path`` or a bare  — local/NFS directory (also the test backend)
    directory path
  * ``s3://bucket/prefix``      — S3 via boto3 when installed
  * ``http(s)://...``           — one HTTP PUT per image to endpoint/<name>
                                  (S3-compatible presigned-style endpoints)

`make_uploader()` returns None when no sink is configured, in which case the
handler falls back to base64.
"""

from __future__ import annotations

import io
import logging
import os
from typing import List, Optional

import numpy as np

logger = logging.getLogger(__name__)

ENV_VAR = "BUCKET_ENDPOINT_URL"


def _jpegs(images01: np.ndarray, quality: int = 95) -> List[bytes]:
    from PIL import Image

    from stablediffusion_tpu_torch.utils.images import as_uint8

    out = []
    for im in as_uint8(images01):
        buf = io.BytesIO()
        Image.fromarray(im).save(buf, format="JPEG", quality=quality)
        out.append(buf.getvalue())
    return out


class Uploader:
    """Upload JPEG-encoded images, return their URLs."""

    def __init__(self, endpoint: str):
        self.endpoint = endpoint.rstrip("/")

    def upload(self, images01: np.ndarray, request_id: str) -> List[str]:
        raise NotImplementedError


class FileUploader(Uploader):
    def __init__(self, endpoint: str):
        super().__init__(endpoint)
        self.root = self.endpoint[len("file://"):] if endpoint.startswith(
            "file://"
        ) else self.endpoint

    def upload(self, images01, request_id):
        os.makedirs(os.path.join(self.root, request_id or "job"), exist_ok=True)
        urls = []
        for i, blob in enumerate(_jpegs(images01)):
            path = os.path.join(self.root, request_id or "job", f"{i}.jpg")
            with open(path, "wb") as f:
                f.write(blob)
            urls.append("file://" + os.path.abspath(path))
        return urls


class GCSUploader(Uploader):
    def __init__(self, endpoint: str):
        super().__init__(endpoint)
        from google.cloud import storage

        rest = self.endpoint[len("gs://"):]
        bucket_name, _, prefix = rest.partition("/")
        self.client = storage.Client()
        self.bucket = self.client.bucket(bucket_name)
        self.prefix = prefix

    def upload(self, images01, request_id):
        urls = []
        for i, blob_bytes in enumerate(_jpegs(images01)):
            name = "/".join(p for p in (self.prefix, request_id or "job",
                                        f"{i}.jpg") if p)
            blob = self.bucket.blob(name)
            blob.upload_from_string(blob_bytes, content_type="image/jpeg")
            urls.append(f"gs://{self.bucket.name}/{name}")
        return urls


class S3Uploader(Uploader):
    def __init__(self, endpoint: str):
        super().__init__(endpoint)
        import boto3  # optional

        rest = self.endpoint[len("s3://"):]
        self.bucket, _, self.prefix = rest.partition("/")
        self.client = boto3.client(
            "s3",
            endpoint_url=os.environ.get("BUCKET_S3_ENDPOINT"),
            aws_access_key_id=os.environ.get("BUCKET_ACCESS_KEY_ID"),
            aws_secret_access_key=os.environ.get("BUCKET_SECRET_ACCESS_KEY"),
        )

    def upload(self, images01, request_id):
        urls = []
        for i, blob in enumerate(_jpegs(images01)):
            key = "/".join(p for p in (self.prefix, request_id or "job",
                                       f"{i}.jpg") if p)
            self.client.put_object(
                Bucket=self.bucket, Key=key, Body=blob,
                ContentType="image/jpeg",
            )
            urls.append(f"s3://{self.bucket}/{key}")
        return urls


class HTTPUploader(Uploader):
    """One PUT per image to endpoint/<request_id>/<i>.jpg (stdlib only)."""

    def upload(self, images01, request_id):
        import urllib.request

        urls = []
        for i, blob in enumerate(_jpegs(images01)):
            url = f"{self.endpoint}/{request_id or 'job'}/{i}.jpg"
            req = urllib.request.Request(
                url, data=blob, method="PUT",
                headers={"Content-Type": "image/jpeg"},
            )
            with urllib.request.urlopen(req, timeout=60) as resp:
                resp.read()
            urls.append(url)
        return urls


def make_uploader(endpoint: Optional[str] = None) -> Optional[Uploader]:
    endpoint = endpoint if endpoint is not None else os.environ.get(ENV_VAR)
    if not endpoint:
        return None
    if endpoint.startswith("gs://"):
        return GCSUploader(endpoint)
    if endpoint.startswith("s3://"):
        try:
            return S3Uploader(endpoint)
        except ImportError:
            logger.warning("boto3 not installed; s3:// sink disabled")
            return None
    if endpoint.startswith(("http://", "https://")):
        return HTTPUploader(endpoint)
    return FileUploader(endpoint)
