"""Transverse Mercator projection (USGS series formulas), numpy float64.

Counterpart of `satmvs_tpu/geo/tmerc.py` on the host only: it rasterizes
fused (lat, lon, h) points into a UTM-gridded DSM.  WHU-TLC's projection:
central meridian -135°, scale factor 0.9996, false easting 500000, WGS-84.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class Ellipsoid:
    """Reference ellipsoid; defaults are WGS-84."""

    a: float = 6378137.000
    inv_f: float = 298.257223563

    @property
    def f(self) -> float:
        return 1.0 / self.inv_f

    @property
    def b(self) -> float:
        return self.a * (1.0 - self.f)

    @property
    def e(self) -> float:
        return math.sqrt(2.0 * self.f - self.f * self.f)

    @property
    def sec_e(self) -> float:
        e2 = self.e * self.e
        return math.sqrt(e2 / (1.0 - e2))


WGS84 = Ellipsoid()


def _meridional_arc(a: float, e2: float, lat_rad):
    """Meridional arc length from the equator (series expansion)."""
    e4 = e2 * e2
    e6 = e4 * e2
    return a * (
        (1 - e2 / 4 - 3 * e4 / 64 - 5 * e6 / 256) * lat_rad
        - (3 * e2 / 8 + 3 * e4 / 32 + 45 * e6 / 1024) * np.sin(2 * lat_rad)
        + (15 * e4 / 256 + 45 * e6 / 1024) * np.sin(4 * lat_rad)
        - (35 * e6 / 3072) * np.sin(6 * lat_rad)
    )


@dataclasses.dataclass(frozen=True)
class TransverseMercator:
    """lat/lon ↔ easting/northing under a Transverse Mercator projection.
    `proj(pts)` takes (..., 2) [lat, lon] in degrees, `proj(pts, reverse=True)`
    [E, N] in metres."""

    ellipsoid: Ellipsoid = WGS84
    lat_origin: float = 0.0
    lon_origin: float = 0.0
    scale_factor: float = 1.0
    false_easting: float = 500000.0
    false_northing: float = 0.0

    @classmethod
    def whu_tlc(cls) -> "TransverseMercator":
        """The WHU-TLC dataset's projection."""
        return cls(WGS84, 0.0, -135.0, 0.9996, 500000.0, 0.0)

    @classmethod
    def utm_for(cls, lon: float) -> "TransverseMercator":
        """The UTM projection of the zone holding longitude `lon` (the series
        is accurate only a few degrees from the central meridian)."""
        zone = int((lon + 180.0) // 6.0) + 1
        return cls(WGS84, 0.0, -183.0 + 6.0 * zone, 0.9996, 500000.0, 0.0)

    def proj(self, pts, reverse: bool = False) -> np.ndarray:
        pts = np.asarray(pts, np.float64)
        flat = pts.reshape(-1, 2)
        fn = self.en_to_latlon if reverse else self.latlon_to_en
        return np.stack(fn(flat[:, 0], flat[:, 1]), axis=-1).reshape(pts.shape)

    def latlon_to_en(self, lat_deg, lon_deg):
        """Forward projection: degrees → (easting, northing) metres."""
        a, e, sec_e = self.ellipsoid.a, self.ellipsoid.e, self.ellipsoid.sec_e
        e2 = e * e
        lat = lat_deg * (math.pi / 180.0)
        lon = lon_deg * (math.pi / 180.0)
        lat0 = self.lat_origin * math.pi / 180.0
        lon0 = self.lon_origin * math.pi / 180.0

        m0 = _meridional_arc(a, e2, np.float64(lat0))
        cos_lat, sin_lat, tan_lat = np.cos(lat), np.sin(lat), np.tan(lat)
        t = tan_lat * tan_lat
        c = e2 * cos_lat * cos_lat / (1 - e2)
        aa = (lon - lon0) * cos_lat
        v = a / np.sqrt(1 - e2 * sin_lat * sin_lat)
        m = _meridional_arc(a, e2, lat)

        a2 = aa * aa
        a3 = a2 * aa
        se2 = sec_e * sec_e
        east = self.false_easting + self.scale_factor * v * (
            aa + (1 - t + c) * a3 / 6 + (5 - 18 * t + t * t + 72 * c - 58 * se2) * a2 * a3 / 120
        )
        north = self.false_northing + self.scale_factor * (
            m - m0
            + v * tan_lat * (
                a2 / 2
                + (5 - t + 9 * c + 4 * c * c) * a2 * a2 / 24
                + (61 - 58 * t + t * t + 600 * c - 330 * se2) * a3 * a3 / 720
            )
        )
        return east, north

    def en_to_latlon(self, east, north):
        """Reverse projection: (easting, northing) metres → degrees."""
        a, e, sec_e = self.ellipsoid.a, self.ellipsoid.e, self.ellipsoid.sec_e
        e2 = e * e
        lat0 = self.lat_origin * math.pi / 180.0
        lon0 = self.lon_origin * math.pi / 180.0

        m0 = _meridional_arc(a, e2, np.float64(lat0))
        temp_e = math.sqrt(1 - e2)
        e1 = (1 - temp_e) / (1 + temp_e)
        m1 = m0 + (north - self.false_northing) / self.scale_factor
        u1 = m1 / (a * (1 - e2 / 4 - 3 * e2 * e2 / 64 - 5 * e2 * e2 * e2 / 256))

        e1_2 = e1 * e1
        lat1 = (
            u1
            + (3 * e1 / 2 - 27 * e1_2 * e1 / 32) * np.sin(2 * u1)
            + (21 * e1_2 / 16 - 55 * e1_2 * e1_2 / 32) * np.sin(4 * u1)
            + (151 * e1_2 * e1 / 96) * np.sin(6 * u1)
            + (1097 * e1_2 * e1_2 / 512) * np.sin(8 * u1)
        )

        temp = np.sqrt(1 - e2 * np.sin(lat1) * np.sin(lat1))
        v1 = a / temp
        p1 = a * (1 - e2) / (temp * temp * temp)
        t1 = np.tan(lat1) * np.tan(lat1)
        c1 = (sec_e * np.cos(lat1)) ** 2
        d = (east - self.false_easting) / (v1 * self.scale_factor)

        d2 = d * d
        d3 = d2 * d
        se2 = sec_e * sec_e
        lat = lat1 - (v1 * np.tan(lat1) / p1) * (
            d2 / 2
            - (5 + 3 * t1 + 10 * c1 - 4 * c1 * c1 - 9 * se2) * d2 * d2 / 24
            + (61 + 90 * t1 + 298 * c1 + 45 * t1 * t1 - 252 * se2 - 3 * c1 * c1) * d3 * d3 / 720
        )
        lon = lon0 + (
            d
            - (1 + 2 * t1 + c1) * d3 / 6
            + (5 - 2 * c1 + 28 * t1 - 3 * c1 * c1 + 8 * se2 + 24 * t1 * t1) * d2 * d3 / 120
        ) / np.cos(lat1)
        return lat * (180.0 / math.pi), lon * (180.0 / math.pi)
