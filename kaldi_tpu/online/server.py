"""TCP audio server: streaming decode over a socket.

(ref: onlinebin/online-audio-server-decode-faster.cc + the legacy
 online/online-tcp-source.h — clients stream raw 16-bit little-endian PCM;
 the server runs the online decoder and writes partial hypotheses as they
 change, then the final hypothesis when the client shuts down its writing
 side. One thread per connection (the reference forks a decode thread per
 stream); the device decode itself is the shared jitted program.)
"""

from __future__ import annotations

import socket
import socketserver
import threading

import numpy as np


class DecodeSession:
    """Factory-produced per-connection state: a feature pipeline + online
    decoder + word-symbol mapper."""

    def __init__(self, make_pipeline, make_decoder, am, words,
                 chunk_samples: int = 4096):
        self.pipeline = make_pipeline()
        self.decoder = make_decoder()
        self.am = am
        self.words = words
        self._consumed = 0
        self._pcm_tail = b""   # TCP reads have no 2-byte alignment

    def accept_pcm(self, pcm: bytes):
        data = self._pcm_tail + pcm
        usable = len(data) - (len(data) % 2)
        self._pcm_tail = data[usable:]
        if usable == 0:
            return
        wave = np.frombuffer(data[:usable], dtype="<i2").astype(np.float32)
        self.pipeline.accept_waveform(wave)
        self._advance()

    def _advance(self):
        feats = self.pipeline.get_features()
        if feats.shape[0] <= self._consumed:
            return
        new = feats[self._consumed:]
        ll = self.am.loglikes_np(new[None])[0]
        self.decoder.advance_decoding(ll)
        self._consumed = feats.shape[0]

    def finish(self):
        self.pipeline.input_finished()
        self._advance()

    def hypothesis(self, final: bool = False) -> str:
        res = self.decoder.best_path(use_final_probs=final)
        if res is None:
            return ""
        words, _tids, _c = res
        return " ".join(self.words.sym(w) for w in words)


class FusedDecodeSession:
    """DecodeSession over the single-dispatch fused streaming decoder
    (kaldi_tpu/online/fused.py): one XLA program per audio chunk, one
    partial-traceback dispatch per hypothesis query — the low-latency
    serving path for plain base-feature AMs."""

    def __init__(self, fused, words):
        self.fused = fused
        fused.reset()
        self.words = words
        self._pcm_tail = b""

    def accept_pcm(self, pcm: bytes):
        data = self._pcm_tail + pcm
        usable = len(data) - (len(data) % 2)
        self._pcm_tail = data[usable:]
        if usable == 0:
            return
        wave = np.frombuffer(data[:usable], dtype="<i2").astype(np.float32)
        self.fused.accept_waveform(wave)

    def finish(self):
        self.fused.input_finished()

    def hypothesis(self, final: bool = False) -> str:
        res = self.fused.best_path(use_final_probs=final)
        if res is None:
            return ""
        words, _tids, _c = res
        return " ".join(self.words.sym(w) for w in words)


class AudioServer:
    def __init__(self, host: str, port: int, session_factory,
                 chunk_bytes: int = 8192):
        self.addr = (host, port)
        self.session_factory = session_factory
        self.chunk_bytes = chunk_bytes
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sess = outer.session_factory()
                last = ""
                while True:
                    data = self.request.recv(outer.chunk_bytes)
                    if not data:
                        break
                    sess.accept_pcm(data)
                    hyp = sess.hypothesis()
                    if hyp != last:
                        self.request.sendall(
                            f"PARTIAL {hyp}\n".encode())
                        last = hyp
                sess.finish()
                self.request.sendall(
                    f"FINAL {sess.hypothesis(final=True)}\n".encode())

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server(self.addr, Handler)

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def serve(self, num_connections: int):
        """Handle exactly num_connections connections, then close —
        the scripted-use loop (the reference servers run forever)."""
        for _ in range(max(num_connections, 1)):
            self._server.handle_request()
        self._server.server_close()

    def serve_in_background(self) -> threading.Thread:
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self._server.shutdown()
        self._server.server_close()


def stream_wave(host: str, port: int, wave: np.ndarray,
                chunk_samples: int = 4000) -> list[str]:
    """Test/demo client: stream float wave as PCM16, return server lines."""
    pcm = np.clip(wave, -32768, 32767).astype("<i2").tobytes()
    out = []
    with socket.create_connection((host, port)) as s:
        for lo in range(0, len(pcm), chunk_samples * 2):
            s.sendall(pcm[lo: lo + chunk_samples * 2])
        s.shutdown(socket.SHUT_WR)
        buf = b""
        while True:
            data = s.recv(4096)
            if not data:
                break
            buf += data
    return [ln for ln in buf.decode().splitlines() if ln]
