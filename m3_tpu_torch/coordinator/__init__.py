"""Coordinator: query serving + ingest + embedded downsampler + admin API
(port of m3_tpu/coordinator; reference: src/query server/coordinator and
src/cmd/services/m3coordinator)."""

from .admin import AdminAPI
from .downsample import Downsampler
from .http_api import HTTPApi, HTTPError, Request
from .ingest import DownsamplerAndWriter, M3MsgIngester
from .selfscrape import SelfScraper
from .server import Coordinator, run_clustered, run_embedded

__all__ = [
    "AdminAPI", "Coordinator", "Downsampler", "DownsamplerAndWriter",
    "HTTPApi", "HTTPError", "M3MsgIngester", "Request", "SelfScraper",
    "run_clustered", "run_embedded",
]
