"""Self-signed TLS bootstrap (``rbg_tpu/runtime/tlsutil.py``): a CA and a
server certificate for the kv-pool wire, minted under ``cert_dir`` and
reused while valid; the server certificate is re-minted under the same CA
30 days before expiry, so clients' pinned ``ca.crt`` stays valid.
Minting needs the ``cryptography`` package (imported on first use);
``server_context`` / ``client_context`` need only ``ssl``.
"""

from __future__ import annotations

import datetime
import ipaddress
import os
from typing import List, Tuple

CA_CERT = "ca.crt"
CA_KEY = "ca.key"          # persisted so server-cert rotation keeps the CA
SERVER_CERT = "tls.crt"
SERVER_KEY = "tls.key"
_VALID_DAYS = 365
_ROTATE_BEFORE_DAYS = 30


def _still_valid(cert_path: str) -> bool:
    from cryptography import x509
    try:
        with open(cert_path, "rb") as f:
            cert = x509.load_pem_x509_certificate(f.read())
    except (OSError, ValueError):
        return False
    horizon = (datetime.datetime.now(datetime.timezone.utc)
               + datetime.timedelta(days=_ROTATE_BEFORE_DAYS))
    return cert.not_valid_after_utc > horizon


def ensure_certs(cert_dir: str,
                 dns_names: Tuple[str, ...] = ("localhost",),
                 ip_addresses: Tuple[str, ...] = ("127.0.0.1",),
                 ) -> Tuple[str, str, str]:
    """Create (or reuse) a CA + server cert pair under ``cert_dir``.
    Returns (ca_cert_path, server_cert_path, server_key_path).

    Rotation preserves the CA: when the server cert nears expiry but the
    CA is still valid, the server cert is re-minted under the EXISTING CA
    key — clients' pinned ``ca.crt`` copies stay valid. Only an expiring
    CA forces full regeneration (clients must then re-pin). Rotation runs
    at process start; a plane outliving the server-cert lifetime needs a
    restart (docs/operations.md)."""
    os.makedirs(cert_dir, exist_ok=True)
    ca_path = os.path.join(cert_dir, CA_CERT)
    ca_key_path = os.path.join(cert_dir, CA_KEY)
    crt_path = os.path.join(cert_dir, SERVER_CERT)
    key_path = os.path.join(cert_dir, SERVER_KEY)
    if (_still_valid(ca_path) and _still_valid(crt_path)
            and os.path.exists(key_path)):
        return ca_path, crt_path, key_path

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    now = datetime.datetime.now(datetime.timezone.utc)
    until = now + datetime.timedelta(days=_VALID_DAYS)

    ca_key = ca_cert = None
    if _still_valid(ca_path) and os.path.exists(ca_key_path):
        try:
            with open(ca_key_path, "rb") as f:
                ca_key = serialization.load_pem_private_key(f.read(), None)
            with open(ca_path, "rb") as f:
                ca_cert = x509.load_pem_x509_certificate(f.read())
        except (OSError, ValueError):
            ca_key = ca_cert = None
    ca_name = (ca_cert.subject if ca_cert is not None else x509.Name(
        [x509.NameAttribute(NameOID.COMMON_NAME, "rbg-tpu-admin-ca")]))
    if ca_key is None:
        ca_key = ec.generate_private_key(ec.SECP256R1())
        ca_cert = (x509.CertificateBuilder()
                   .subject_name(ca_name).issuer_name(ca_name)
                   .public_key(ca_key.public_key())
                   .serial_number(x509.random_serial_number())
                   .not_valid_before(now).not_valid_after(until)
                   .add_extension(x509.BasicConstraints(ca=True,
                                                        path_length=0),
                                  critical=True)
                   .sign(ca_key, hashes.SHA256()))

    srv_key = ec.generate_private_key(ec.SECP256R1())
    sans: List[x509.GeneralName] = [x509.DNSName(d) for d in dns_names]
    sans += [x509.IPAddress(ipaddress.ip_address(i)) for i in ip_addresses]
    srv_cert = (x509.CertificateBuilder()
                .subject_name(x509.Name([x509.NameAttribute(
                    NameOID.COMMON_NAME, "rbg-tpu-admin")]))
                .issuer_name(ca_name)
                .public_key(srv_key.public_key())
                .serial_number(x509.random_serial_number())
                .not_valid_before(now).not_valid_after(until)
                .add_extension(x509.SubjectAlternativeName(sans),
                               critical=False)
                .add_extension(x509.ExtendedKeyUsage(
                    [x509.oid.ExtendedKeyUsageOID.SERVER_AUTH]),
                    critical=False)
                .sign(ca_key, hashes.SHA256()))

    def _write(path: str, data: bytes, mode: int):
        # Private keys must be born 0600 — a chmod AFTER an umask-default
        # open leaves a readable window on shared hosts.
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, mode)
        try:
            os.write(fd, data)
        finally:
            os.close(fd)
        os.chmod(path, mode)  # pre-existing files: enforce too

    pem_priv = lambda k: k.private_bytes(       # noqa: E731
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption())
    _write(ca_path, ca_cert.public_bytes(serialization.Encoding.PEM), 0o644)
    _write(ca_key_path, pem_priv(ca_key), 0o600)
    _write(crt_path, srv_cert.public_bytes(serialization.Encoding.PEM), 0o644)
    _write(key_path, pem_priv(srv_key), 0o600)
    return ca_path, crt_path, key_path


def server_context(cert_path: str, key_path: str):
    import ssl
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert_path, key_path)
    return ctx


def client_context(ca_path: str):
    import ssl
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_verify_locations(ca_path)
    ctx.check_hostname = False  # we verify against the pinned CA, not names
    return ctx
