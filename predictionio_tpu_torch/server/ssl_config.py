"""TLS configuration for the HTTP servers: the port's copy of the JAX
package's ``server/ssl_config.py``.

Reference: [U] common/src/main/scala/.../configuration/
SSLConfiguration.scala (SURVEY.md §2a), where a JKS keystore enables
HTTPS on the event and engine servers. Here a PEM cert/key pair named by
env vars (or explicit paths) builds an ``ssl.SSLContext`` that
:class:`~predictionio_tpu_torch.server.http.HTTPServer` accepts.

Env contract::

    PIO_SSL_CERT_PATH  path to PEM certificate (fullchain)
    PIO_SSL_KEY_PATH   path to PEM private key
    PIO_SSL_KEY_PASSWORD  optional key passphrase
"""

from __future__ import annotations

import os
import ssl
from typing import Optional


def ssl_context_from_env(
    cert_path: Optional[str] = None,
    key_path: Optional[str] = None,
    password: Optional[str] = None,
) -> Optional[ssl.SSLContext]:
    """Build a server-side SSLContext, or None when TLS is not
    configured. Explicit args win over env vars."""
    cert = cert_path or os.environ.get("PIO_SSL_CERT_PATH")
    key = key_path or os.environ.get("PIO_SSL_KEY_PATH")
    if not cert and not key:
        return None
    if not cert or not key:
        raise ValueError(
            "both PIO_SSL_CERT_PATH and PIO_SSL_KEY_PATH must be set for TLS")
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.load_cert_chain(
        cert, key, password or os.environ.get("PIO_SSL_KEY_PASSWORD"))
    return ctx
