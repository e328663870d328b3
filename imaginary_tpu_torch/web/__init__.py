"""HTTP layer of the port: the reference's aiohttp application."""
