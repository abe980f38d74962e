"""TLS for the ops servers.

The port's own copy of ``incubator_predictionio_tpu/common/ssl_config.py``
plus :class:`TLSServerMixin`, which serves a threaded ``http.server``
with the context (the reference hands it to aiohttp).

Reference: common/.../SSLConfiguration.scala — a JKS keystore configured via
`pio-env.sh` turns every spray server (event server, engine server, dashboard,
admin) HTTPS. This package uses PEM files from the environment:

  PIO_SSL_CERTFILE  path to a PEM certificate chain
  PIO_SSL_KEYFILE   path to the PEM private key
  PIO_SSL_KEY_PASSWORD  optional key passphrase

When both files are set, every server (engine, event, dashboard, storage)
serves HTTPS only, and a missing or bad file stops it at start-up;
otherwise plain HTTP (the reference's default is also off unless a keystore
is configured).
"""

from __future__ import annotations

import os
import ssl
from typing import Optional


def ssl_context_from_env(env: Optional[dict] = None) -> Optional[ssl.SSLContext]:
    e = os.environ if env is None else env
    cert = e.get("PIO_SSL_CERTFILE")
    key = e.get("PIO_SSL_KEYFILE")
    if not cert or not key:
        return None
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert, key, password=e.get("PIO_SSL_KEY_PASSWORD"))
    return ctx


def loopback_client_context() -> ssl.SSLContext:
    """A client context for an https call to this host's own server (a
    deploy's probe, its rollback call): the server's certificate need not
    name 127.0.0.1, so it is not verified."""
    ctx = ssl.create_default_context()
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    return ctx


#: seconds a connection may take to finish its TLS handshake: a client
#: that connects and says nothing holds its own thread, never the listener
HANDSHAKE_TIMEOUT = 10.0


class TLSServerMixin:
    """HTTPS for a ``socketserver`` threading server (``http.server``):
    put it before ``ThreadingHTTPServer`` in the bases and set
    ``ssl_context`` (None serves plain HTTP).

    The accepted socket is wrapped with ``do_handshake_on_connect=False``
    and its handshake runs in the connection's own thread, so one silent
    or plaintext client never stalls ``accept`` for everybody; a failed
    handshake closes that connection only. A peer that drops a keep-alive
    connection without TLS's close_notify is a normal close, not an error
    to log."""

    ssl_context: Optional[ssl.SSLContext] = None

    def get_request(self):
        sock, addr = super().get_request()
        if self.ssl_context is not None:
            sock = self.ssl_context.wrap_socket(
                sock, server_side=True, do_handshake_on_connect=False)
        return sock, addr

    def process_request_thread(self, request, client_address):
        if isinstance(request, ssl.SSLSocket):
            timeout = request.gettimeout()
            try:
                request.settimeout(HANDSHAKE_TIMEOUT)
                request.do_handshake()
                request.settimeout(timeout)
            except (ssl.SSLError, OSError):
                self.shutdown_request(request)
                return
        super().process_request_thread(request, client_address)

    def handle_error(self, request, client_address):
        import sys

        exc = sys.exc_info()[1]
        if isinstance(exc, (ssl.SSLEOFError, ssl.SSLZeroReturnError,
                            ConnectionResetError, BrokenPipeError)):
            return
        super().handle_error(request, client_address)

