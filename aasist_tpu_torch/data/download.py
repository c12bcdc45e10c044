"""ASVspoof2019-LA dataset fetcher (own copy of
``aasist_tpu/data/download.py``).

Equivalent of the reference's ``download_dataset.py`` (curl + unzip of
LA.zip from Edinburgh DataShare), implemented with stdlib urllib and
zipfile, with download-to-temp and an extraction check.

A host with no network cannot fetch the 24 GB archive; the synthetic
corpus (``aasist_tpu_torch.data.synthetic``) is a corpus-shaped stand-in.
"""

from __future__ import annotations

import shutil
import sys
import urllib.request
import zipfile
from pathlib import Path

LA_URL = ("https://datashare.ed.ac.uk/bitstream/handle/10283/3336/"
          "LA.zip?sequence=3&isAllowed=y")


def download(dest_dir=".", url: str = LA_URL, chunk: int = 1 << 20) -> Path:
    """Download LA.zip into ``dest_dir`` and extract it.  Returns the
    extracted LA/ directory path."""
    dest_dir = Path(dest_dir)
    dest_dir.mkdir(parents=True, exist_ok=True)
    zip_path = dest_dir / "LA.zip"
    tmp_path = zip_path.with_suffix(".zip.part")

    if not zip_path.exists():
        print(f"Downloading {url} -> {zip_path}")
        try:
            with urllib.request.urlopen(url) as resp, \
                    open(tmp_path, "wb") as out:
                total = int(resp.headers.get("Content-Length", 0))
                done = 0
                while True:
                    buf = resp.read(chunk)
                    if not buf:
                        break
                    out.write(buf)
                    done += len(buf)
                    if total:
                        pct = 100 * done / total
                        print(f"\r  {done >> 20} MiB / {total >> 20} MiB "
                              f"({pct:.1f}%)", end="", file=sys.stderr)
        except OSError as e:
            raise RuntimeError(
                f"download failed ({e}); if this host has no network, "
                "generate a synthetic corpus instead: "
                "python -c \"from aasist_tpu_torch.data import synthetic; "
                "synthetic.generate('./data/LA')\"") from e
        shutil.move(tmp_path, zip_path)
        print()

    print(f"Extracting {zip_path}")
    with zipfile.ZipFile(zip_path) as zf:
        zf.extractall(dest_dir)
    la_dir = dest_dir / "LA"
    if not la_dir.exists():
        raise RuntimeError("archive did not contain the expected LA/ root")
    return la_dir


if __name__ == "__main__":
    download(sys.argv[1] if len(sys.argv) > 1 else ".")
