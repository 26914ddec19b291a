"""Checkpoint and file cache utilities (AllenNLP-style ``cached_path``).

The port of ``curriculum_learning_for_vln_tpu/models/file_utils.py``
(ref: tasks/R2R-judy/src/model/file_utils.py:31-231), the same code: URL
to local-cache resolution with ETag-keyed filenames, and the small file
helpers.  The transports differ from the reference on purpose:

* ``http(s)://`` uses urllib (stdlib) with the reference's ETag cache
  contract; without a network the download raises a clear error instead
  of hanging;
* ``s3://`` is parsed the same way (``split_s3_path``) but needs boto3 at
  call time, an optional dependency;
* ``file://`` URLs are first-class (tests and offline mirrors).

Checkpoint conversion lives in models/vilbert.py
(``convert_torch_state_dict``); this module only resolves paths.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import urllib.parse
import urllib.request
from hashlib import sha256
from pathlib import Path
from typing import Optional, Set, Tuple, Union

DEFAULT_CACHE = os.path.join(os.path.expanduser("~"), ".cache", "vln_torch")


def url_to_filename(url: str, etag: Optional[str] = None) -> str:
    """sha256(url)[.sha256(etag)] — byte-compatible with the reference
    naming (ref: file_utils.py:31-46)."""
    url_bytes = url.encode("utf-8")
    filename = sha256(url_bytes).hexdigest()
    if etag:
        filename += "." + sha256(etag.encode("utf-8")).hexdigest()
    return filename


def filename_to_url(filename: str, cache_dir: Optional[str] = None) -> Tuple[str, Optional[str]]:
    """Recover (url, etag) from a cache entry's sidecar metadata
    (ref: file_utils.py:49-70)."""
    cache_dir = cache_dir or DEFAULT_CACHE
    cache_path = os.path.join(cache_dir, filename)
    if not os.path.exists(cache_path):
        raise FileNotFoundError(f"file {cache_path} not found")
    meta_path = cache_path + ".json"
    if not os.path.exists(meta_path):
        raise FileNotFoundError(f"file {meta_path} not found")
    with open(meta_path) as f:
        metadata = json.load(f)
    return metadata["url"], metadata.get("etag")


def split_s3_path(url: str) -> Tuple[str, str]:
    """(bucket, key) from an s3:// url (ref: file_utils.py:101-111)."""
    parsed = urllib.parse.urlparse(url)
    if not parsed.netloc or not parsed.path:
        raise ValueError(f"bad s3 path {url}")
    return parsed.netloc, parsed.path.lstrip("/")


def _http_etag(url: str, timeout: float = 10.0) -> Optional[str]:
    req = urllib.request.Request(url, method="HEAD")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.headers.get("ETag")


def _http_get(url: str, temp_file, timeout: float = 60.0) -> None:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        shutil.copyfileobj(resp, temp_file)


def _s3_etag(url: str) -> Optional[str]:
    import boto3  # optional dependency

    bucket, key = split_s3_path(url)
    obj = boto3.resource("s3").Object(bucket, key)
    return obj.e_tag


def _s3_get(url: str, temp_file) -> None:
    import boto3

    bucket, key = split_s3_path(url)
    boto3.resource("s3").Bucket(bucket).download_fileobj(key, temp_file)


def get_from_cache(url: str, cache_dir: Optional[str] = None) -> str:
    """Resolve a remote url through the on-disk cache, downloading on miss
    (ref: file_utils.py:162-216).  file:// urls copy from the local
    filesystem with a content-hash standing in for the ETag."""
    cache_dir = cache_dir or DEFAULT_CACHE
    os.makedirs(cache_dir, exist_ok=True)

    scheme = urllib.parse.urlparse(url).scheme
    etag: Optional[str] = None
    if scheme == "s3":
        etag = _s3_etag(url)
    elif scheme == "file":
        src = urllib.request.url2pathname(urllib.parse.urlparse(url).path)
        if not os.path.exists(src):
            raise FileNotFoundError(f"file url target {src} not found")
        with open(src, "rb") as f:
            etag = sha256(f.read()).hexdigest()
    else:
        try:
            etag = _http_etag(url)
        except OSError as e:
            raise OSError(
                f"could not reach {url} (zero-egress environment?); place the "
                f"file locally and pass its path instead") from e

    filename = url_to_filename(url, etag)
    cache_path = os.path.join(cache_dir, filename)
    if os.path.exists(cache_path):
        return cache_path

    with tempfile.NamedTemporaryFile(dir=cache_dir, delete=False) as temp_file:
        if scheme == "s3":
            _s3_get(url, temp_file)
        elif scheme == "file":
            with open(src, "rb") as f:
                shutil.copyfileobj(f, temp_file)
        else:
            _http_get(url, temp_file)
        temp_name = temp_file.name
    os.replace(temp_name, cache_path)  # atomic publish
    with open(cache_path + ".json", "w") as meta_file:
        json.dump({"url": url, "etag": etag}, meta_file)
    return cache_path


def cached_path(url_or_filename: Union[str, Path], cache_dir: Optional[str] = None) -> str:
    """Local path passthrough or cached download (ref: file_utils.py:73-98)."""
    if isinstance(url_or_filename, Path):
        url_or_filename = str(url_or_filename)
    scheme = urllib.parse.urlparse(url_or_filename).scheme
    if scheme in ("http", "https", "s3", "file"):
        return get_from_cache(url_or_filename, cache_dir)
    if os.path.exists(url_or_filename):
        return url_or_filename
    if scheme == "":
        raise FileNotFoundError(f"file {url_or_filename} not found")
    raise ValueError(f"unable to parse {url_or_filename} as URL or local path")


def read_set_from_file(filename: str) -> Set[str]:
    """(ref: file_utils.py:219-228)"""
    collection: Set[str] = set()
    with open(filename, encoding="utf-8") as f:
        for line in f:
            collection.add(line.rstrip())
    return collection


def get_file_extension(path: str, dot: bool = True, lower: bool = True) -> str:
    """(ref: file_utils.py:231-233)"""
    ext = os.path.splitext(path)[1]
    ext = ext if dot else ext[1:]
    return ext.lower() if lower else ext
