"""Cross-cutting helpers of the port."""
