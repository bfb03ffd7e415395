"""Model encryption for save/load (a copy of ``paddle_tpu/framework/
io_crypto.py``: pure Python, so the two packages read each other's files).

Reference: paddle/fluid/framework/io/crypto/ — ``CipherFactory``/
``AESCipher`` (AES-GCM, cipher.cc) encrypting serialized programs/params
so models at rest are unreadable without the key.

Primary construction: **AES-256-GCM** via the ``cryptography`` package
when it imports (the reference's AESCipher family). Without it: a
pure-stdlib authenticated stream cipher (SHAKE-256 keystream,
HMAC-SHA256 tag, encrypt-then-MAC), keystream per 64MB chunk (SHAKE-256
over key||nonce||chunk_offset) XORed via numpy. Formats (self-describing
by magic; decrypt reads both): ``PTPUENC3 || nonce(12) || ct+tag``
(AES-GCM) and ``PTPUENC2 || nonce(16) || ciphertext || tag(32)`` (SHAKE).
A machine without ``cryptography`` writes v2 and reads v2 only.
"""
from __future__ import annotations

import hashlib
import hmac
import os

__all__ = ["Cipher", "CipherFactory", "encrypt_bytes", "decrypt_bytes",
           "encrypt_file", "decrypt_file"]

_MAGIC_GCM = b"PTPUENC3"  # v3: AES-256-GCM (reference-parity cipher)
_MAGIC = b"PTPUENC2"  # v2: chunked offset-keyed SHAKE keystream (fallback)
_MAGIC_V1 = b"PTPUENC1"  # pre-release whole-buffer keystream (unsupported)
_NONCE = 16
_GCM_NONCE = 12
_TAG = 32


def _aesgcm():
    """AESGCM class when ``cryptography`` is importable, else None."""
    try:
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM
        return AESGCM
    except ImportError:
        return None


_CHUNK = 64 * 1024 * 1024


def _xor_stream(data: bytes, key: bytes, nonce: bytes) -> bytes:
    """XOR ``data`` with the SHAKE-256 keystream in bounded chunks: numpy
    bitwise_xor per 64MB block keeps peak memory ~1 chunk above the output
    (a whole-buffer big-int XOR would peak at ~5x the plaintext)."""
    import numpy as _np
    out = bytearray(len(data))
    view = memoryview(data)
    for off in range(0, len(data), _CHUNK):
        block = view[off:off + _CHUNK]
        ks = hashlib.shake_256(
            key + nonce + off.to_bytes(8, "little")).digest(len(block))
        out[off:off + _CHUNK] = _np.bitwise_xor(
            _np.frombuffer(block, dtype=_np.uint8),
            _np.frombuffer(ks, dtype=_np.uint8)).tobytes()
    return bytes(out)


def _derive(key: bytes, purpose: bytes) -> bytes:
    return hmac.new(key, purpose, hashlib.sha256).digest()


def encrypt_bytes(data: bytes, key: bytes) -> bytes:
    AESGCM = _aesgcm()
    if AESGCM is not None:
        nonce = os.urandom(_GCM_NONCE)
        ct = AESGCM(_derive(key, b"aes")).encrypt(nonce, data, _MAGIC_GCM)
        return _MAGIC_GCM + nonce + ct
    nonce = os.urandom(_NONCE)
    enc_key = _derive(key, b"enc")
    mac_key = _derive(key, b"mac")
    ct = _xor_stream(data, enc_key, nonce)
    tag = hmac.new(mac_key, nonce + ct, hashlib.sha256).digest()
    return _MAGIC + nonce + ct + tag


def decrypt_bytes(blob: bytes, key: bytes) -> bytes:
    if blob.startswith(_MAGIC_GCM):
        AESGCM = _aesgcm()
        if AESGCM is None:
            raise ValueError(
                "blob is AES-GCM encrypted but the 'cryptography' package "
                "is not importable in this environment")
        nonce = blob[len(_MAGIC_GCM):len(_MAGIC_GCM) + _GCM_NONCE]
        ct = blob[len(_MAGIC_GCM) + _GCM_NONCE:]
        try:
            return AESGCM(_derive(key, b"aes")).decrypt(nonce, ct,
                                                        _MAGIC_GCM)
        except Exception:
            raise ValueError(
                "decryption failed: wrong key or corrupted data") from None
    if blob.startswith(_MAGIC_V1):
        # v1 used a different keystream derivation; XORing with the v2
        # stream would return garbage that still passes the (ciphertext)
        # MAC — fail loudly instead
        raise ValueError(
            "blob uses the pre-release PTPUENC1 format, which this version "
            "no longer decrypts — re-encrypt with the current release")
    if not blob.startswith(_MAGIC):
        raise ValueError("not an encrypted paddle_tpu blob")
    nonce = blob[len(_MAGIC):len(_MAGIC) + _NONCE]
    ct = blob[len(_MAGIC) + _NONCE:-_TAG]
    tag = blob[-_TAG:]
    mac_key = _derive(key, b"mac")
    expect = hmac.new(mac_key, nonce + ct, hashlib.sha256).digest()
    if not hmac.compare_digest(tag, expect):
        raise ValueError("decryption failed: wrong key or corrupted data")
    enc_key = _derive(key, b"enc")
    return _xor_stream(ct, enc_key, nonce)


def encrypt_file(src: str, dst: str, key: bytes):
    with open(src, "rb") as f:
        data = f.read()
    with open(dst, "wb") as f:
        f.write(encrypt_bytes(data, key))


def decrypt_file(src: str, dst: str, key: bytes):
    with open(src, "rb") as f:
        blob = f.read()
    with open(dst, "wb") as f:
        f.write(decrypt_bytes(blob, key))


class Cipher:
    """reference crypto/cipher.h Cipher interface."""

    def __init__(self, key: bytes = None):
        self._key = key or os.urandom(32)

    @property
    def key(self) -> bytes:
        return self._key

    def encrypt(self, plaintext: bytes) -> bytes:
        return encrypt_bytes(plaintext, self._key)

    def decrypt(self, ciphertext: bytes) -> bytes:
        return decrypt_bytes(ciphertext, self._key)

    def encrypt_to_file(self, plaintext: bytes, path: str):
        with open(path, "wb") as f:
            f.write(self.encrypt(plaintext))

    def decrypt_from_file(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return self.decrypt(f.read())


class CipherFactory:
    """reference crypto/cipher_factory — key management helper."""

    @staticmethod
    def create_cipher(key: bytes = None) -> Cipher:
        return Cipher(key)

    @staticmethod
    def generate_key() -> bytes:
        return os.urandom(32)
