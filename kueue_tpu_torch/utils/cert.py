"""Serving-certificate management — the pkg/util/cert analog, ported
from ``kueue_tpu/utils/cert.py``.

The reference manages its webhook/visibility serving certs internally
(self-signed CA, rotated, written to a cert dir watched by the servers).
This standalone analog generates a self-signed serving certificate and
writes the tls.crt / tls.key pair the HTTP endpoints load.

``cryptography`` is imported inside ``generate_self_signed``: nothing
imports it until a certificate is made (a TLS endpoint's first start on
an empty cert dir), so a deployment without it runs every other path.
"""

from __future__ import annotations

import datetime
import ipaddress
import os


def generate_self_signed(host: str = "127.0.0.1",
                         days: int = 365) -> tuple[bytes, bytes]:
    """Returns (cert_pem, key_pem) for a self-signed serving cert whose
    SAN covers ``host`` (DNS name or IP literal)."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, host)])
    try:
        san = x509.SubjectAlternativeName(
            [x509.IPAddress(ipaddress.ip_address(host))])
    except ValueError:
        san = x509.SubjectAlternativeName([x509.DNSName(host)])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder()
            .subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=days))
            .add_extension(san, critical=False)
            .sign(key, hashes.SHA256()))
    cert_pem = cert.public_bytes(serialization.Encoding.PEM)
    key_pem = key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.TraditionalOpenSSL,
        serialization.NoEncryption())
    return cert_pem, key_pem


def ensure_cert_dir(cert_dir: str, host: str = "127.0.0.1"
                    ) -> tuple[str, str]:
    """Write (or reuse) tls.crt / tls.key under ``cert_dir`` — the
    reference's cert-dir contract. Returns the two paths."""
    os.makedirs(cert_dir, exist_ok=True)
    crt = os.path.join(cert_dir, "tls.crt")
    key = os.path.join(cert_dir, "tls.key")
    if not (os.path.exists(crt) and os.path.exists(key)):
        cert_pem, key_pem = generate_self_signed(host)
        with open(crt, "wb") as fh:
            fh.write(cert_pem)
        with open(key, "wb") as fh:
            fh.write(key_pem)
        os.chmod(key, 0o600)
    return crt, key
