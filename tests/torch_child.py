"""Bounded waits on child processes for the port's tests.

`Lines` drains a child's text stream in a thread, so a test waits for a
line with a deadline and never blocks in a read.  `PtyChild` runs a
program on a pseudo-terminal (curses needs one) and reads it with
`select` and a deadline.  `stop` ends a child that is still running.
"""
import os
import pty
import re
import select
import subprocess
import threading
import time


class Lines:
    """Every line a stream yields, collected by a reader thread."""

    def __init__(self, stream):
        self._lines: list[str] = []
        self._cond = threading.Condition()
        self._eof = False
        self._thread = threading.Thread(target=self._pump, args=(stream,),
                                        daemon=True)
        self._thread.start()

    def _pump(self, stream):
        try:
            for line in iter(stream.readline, ""):
                with self._cond:
                    self._lines.append(line)
                    self._cond.notify_all()
        finally:
            with self._cond:
                self._eof = True
                self._cond.notify_all()

    def text(self) -> str:
        with self._cond:
            return "".join(self._lines)

    def wait_for(self, pattern: str, timeout: float) -> re.Match:
        """The first match of `pattern` in a line; AssertionError with
        the output so far when the stream ends or the deadline passes
        first."""
        rx = re.compile(pattern)
        deadline = time.monotonic() + timeout
        seen = 0
        with self._cond:
            while True:
                for line in self._lines[seen:]:
                    m = rx.search(line)
                    if m:
                        return m
                seen = len(self._lines)
                left = deadline - time.monotonic()
                if self._eof or left <= 0:
                    why = "stream ended" if self._eof else f"{timeout} s"
                    raise AssertionError(
                        f"no line matching {pattern!r} ({why}):\n"
                        + "".join(self._lines)[-4000:])
                self._cond.wait(left)

    def finish(self, timeout: float) -> str:
        """All the output, once the stream has ended (within timeout)."""
        self._thread.join(timeout)
        assert not self._thread.is_alive(), "stream still open"
        return self.text()


def stop(proc: subprocess.Popen, timeout: float = 30):
    """Kill the child if it still runs, and reap it."""
    if proc.poll() is None:
        proc.kill()
    proc.wait(timeout=timeout)


class PtyChild:
    """A child on a pseudo-terminal: its terminal output accumulates in
    `out` as the test reads it; stderr may go elsewhere."""

    def __init__(self, argv, env, stderr=None, cwd=None):
        self.fd, slave = pty.openpty()
        # a session of its own: the terminal is the child's, and nothing
        # it does reaches the test's process group
        self.proc = subprocess.Popen(
            argv, env=env, cwd=cwd, stdin=slave, stdout=slave,
            stderr=slave if stderr is None else stderr, close_fds=True,
            start_new_session=True)
        os.close(slave)
        self.out = b""
        self.eof = False

    def read_for(self, secs: float):
        end = time.monotonic() + secs
        while (left := end - time.monotonic()) > 0:
            r, _, _ = select.select([self.fd], [], [], min(left, 0.3))
            if r:
                try:
                    chunk = os.read(self.fd, 65536)
                except OSError:        # the child closed the terminal
                    chunk = b""
                if not chunk:
                    self.eof = True
                    return
                self.out += chunk

    def wait_for(self, needle: bytes, timeout: float):
        end = time.monotonic() + timeout
        while (needle not in self.out and not self.eof
               and time.monotonic() < end):
            self.read_for(0.5)
        assert needle in self.out, self.out[-2000:]

    def send(self, keys: bytes, settle: float = 1.0):
        os.write(self.fd, keys)
        self.read_for(settle)

    def close(self, timeout: float = 30) -> int:
        """Wait for the child's exit (killing it after timeout) and
        close the terminal; the exit code."""
        end = time.monotonic() + timeout
        while self.proc.poll() is None and time.monotonic() < end:
            if self.eof:
                time.sleep(0.1)
            else:
                self.read_for(0.3)
        try:
            os.close(self.fd)
        except OSError:
            pass
        if self.proc.poll() is None:
            stop(self.proc)
            return -9
        return self.proc.returncode


def http(url: str, data: bytes | None = None, headers: dict | None = None,
         timeout: float = 60):
    """(status, content type, body) of one request; HTTP errors too."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


class GuiClient:
    """The web GUI's HTTP surface as the page uses it: the per-session
    token comes from the page at `/`, as a browser gets it."""

    def __init__(self, base: str):
        self.base = base.rstrip("/")
        status, _, page = http(self.base + "/")
        assert status == 200, status
        self.token = re.search(rb"const TOKEN = '([0-9a-f]+)'",
                               page).group(1).decode()

    def get(self, path: str):
        return http(self.base + path)

    def state(self) -> dict:
        import json

        status, _, body = self.get("/api/state")
        assert status == 200, body[:500]
        return json.loads(body)

    def intent(self, name: str, arg=None) -> dict:
        import json

        status, _, body = http(
            self.base + "/api/intent",
            json.dumps({"intent": name, "arg": arg}).encode(),
            {"Content-Type": "application/json",
             "X-Session-Token": self.token})
        assert status == 200, (status, body[:500])
        return json.loads(body)

    def wait_until(self, done, timeout: float, every: float = 0.2) -> dict:
        """Poll /api/state until done(state) holds; the state."""
        end = time.monotonic() + timeout
        while True:
            snap = self.state()
            if done(snap):
                return snap
            assert time.monotonic() < end, f"GUI not ready: {snap}"
            time.sleep(every)


def gui_in_thread(main, argv: list, timeout: float = 60):
    """main(argv + --use-gui on a free port) on a thread of this process,
    as a user's `--use-gui` would run; (thread, a list that receives the
    exit code, a client once the server answers)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    rc: list = []
    t = threading.Thread(target=lambda: rc.append(main(
        [*argv, "--use-gui", "--port", str(port)])), daemon=True)
    t.start()
    end = time.monotonic() + timeout
    while True:
        try:
            return t, rc, GuiClient(f"http://127.0.0.1:{port}/")
        except OSError:
            assert t.is_alive() and time.monotonic() < end, rc
            t.join(0.1)


def start_gui(argv: list, env: dict, cwd=None, timeout: float = 300):
    """Start a `--use-gui` process; (proc, its stderr Lines, client)
    once it prints its URL."""
    proc = subprocess.Popen(argv, env=env, cwd=cwd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    err = Lines(proc.stderr)
    Lines(proc.stdout)             # drained, so the child never blocks
    try:
        url = err.wait_for(r"GUI at (http://\S+/)", timeout).group(1)
        return proc, err, GuiClient(url)
    except BaseException:
        stop(proc)
        raise


def png16(data: bytes):
    """The (H, W, 3) uint16 pixels of the 48-bit PNG that /api/image
    serves with deep=1 (Pillow would read it as 8-bit RGB)."""
    import struct
    import zlib

    import numpy as np

    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        (n,) = struct.unpack_from(">I", data, pos)
        tag, payload = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack_from(">IIBB", payload)
            assert (depth, ctype) == (16, 2), (depth, ctype)
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), dtype=np.uint8).reshape(
        h, 1 + 6 * w)
    assert not rows[:, 0].any(), "filtered scanlines"
    return rows[:, 1:].copy().view(">u2").reshape(h, w, 3).astype(np.uint16)
