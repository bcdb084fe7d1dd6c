"""TPC-DS connector: deterministic star-schema data generated on the fly.

Reference parity: ``presto-tpcds`` — like ``presto-tpch``, data derived
from the scale factor at scan time with zero stored bytes (SURVEY.md
§2.2), so the TPC-DS benchmark configs of BASELINE.json (Q64/Q95) run
against exactly reproducible fixtures and the sqlite oracle can assert
exact results over the SAME data.

TPU-first: reuses the closed-form generator machinery of
``connectors.tpch`` — splitmix64 streams keyed by (column, row index),
arithmetic bijections for multi-line orders (ticket/order cycles), and
dictionary-id varchar columns (strings never materialize per row).
Returns tables are derived row-maps of their sales tables (return j
references sale row j*K), which keeps the (item, order) FK pairs exact
in O(1) per row — the property official dsdgen gets from sequential
generation.

Coverage: the 17 tables Q64/Q95 touch (store/catalog/web sales +
returns, date_dim, item, customer, customer_address,
customer_demographics, household_demographics, income_band, store,
promotion, warehouse, web_site), with the columns those queries and the
general test corpus exercise. Distributions are TPC-DS-shaped, not
bit-identical to dsdgen (BASELINE.md provenance: no published reference
numbers exist; correctness is oracle-diffed).
"""

from __future__ import annotations

import datetime
from typing import Dict, Sequence

import numpy as np

from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.spi import (
    ColumnStats,
    Connector,
    ConnectorMetadata,
    ConnectorSplit,
    SplitSource,
    TableHandle,
    TableStats,
)
from presto_tpu_torch.connectors.tpch import (
    COLORS,
    DictColumn,
    _fixed,
    _LazyCombo,
    _numbered,
    _stream,
    _uniform,
)

SCHEMAS = {"tiny": 0.01, "sf1": 1.0, "sf10": 10.0, "sf100": 100.0}

_EPOCH = datetime.date(1970, 1, 1)
_D_START = (datetime.date(1990, 1, 1) - _EPOCH).days
_D_END = (datetime.date(2002, 12, 31) - _EPOCH).days
N_DATES = _D_END - _D_START + 1  # 4748 days
_DATE_SK0 = 2415022  # official dsdgen julian-ish base for d_date_sk

#: sales dates concentrated where the benchmark queries look (Q64 self-
#: joins syear 1999 x 2000; Q95 windows inside 1999) — official dsdgen
#: also clusters sales in the 1998-2002 band
_SOLD_LO = (datetime.date(1998, 1, 1) - _EPOCH).days
_SOLD_HI = (datetime.date(2000, 12, 31) - _EPOCH).days

REASON_DESCS = [
    "Did not fit", "Did not like the color", "Did not like the model",
    "Did not like the warranty", "Does not work", "Duplicate purchase",
    "Found a better extension", "Found a better price", "Gift exchange",
    "Lost my job", "No service location in my area", "Not the product",
    "Package was damaged", "Parts missing", "Stopped working",
    "Unauthorized purchase", "Wrong size",
]
SHIP_TYPES = ["EXPRESS", "LIBRARY", "NEXT DAY", "OVERNIGHT", "REGULAR",
              "TWO DAY"]
SHIP_CODES = ["AIR", "SEA", "SURFACE"]
CARRIERS = ["AIRBORNE", "ALLIANCE", "BARIAN", "BOXBUNDLES", "DHL",
            "FEDEX", "GERMA", "GREAT EASTERN", "HARMSTORF", "LATVIAN",
            "MSC", "ORIENTAL", "PRIVATECARRIER", "RUPEKSA", "TBS", "UPS",
            "USPS", "ZHOU", "ZOUROS", "DIAMOND"]
CC_NAMES = ["California", "Hawaii/Alaska", "Mid Atlantic", "Midwest",
            "NY Metro", "North Midwest", "Northwest", "Pacific Northwest",
            "South Atlantic", "Southwest"]
MARITAL = ["D", "M", "S", "U", "W"]
GENDER = ["F", "M"]
EDUCATION = [
    "2 yr Degree", "4 yr Degree", "Advanced Degree", "College",
    "Primary", "Secondary", "Unknown",
]
CREDIT = ["Good", "High Risk", "Low Risk", "Unknown"]
BUY_POTENTIAL = ["0-500", "1001-5000", "501-1000", ">10000", "5001-10000",
                 "Unknown"]
STATES = ["CA", "GA", "IL", "MI", "NY", "OH", "PA", "TN", "TX", "WA"]
CITIES = [
    "Antioch", "Bridgeport", "Centerville", "Clifton", "Fairview",
    "Five Points", "Glendale", "Greenfield", "Liberty", "Lincoln",
    "Marion", "Midway", "Mount Olive", "Mount Zion", "Oak Grove",
    "Oak Hill", "Oakland", "Pleasant Grove", "Pleasant Hill", "Riverside",
    "Salem", "Shady Grove", "Springdale", "Spring Hill", "Sulphur Springs",
    "Union", "Unionville", "Walnut Grove", "White Oak", "Woodville",
]
STREET_W1 = [
    "1st", "2nd", "3rd", "4th", "5th", "6th", "7th", "8th", "9th", "10th",
    "Adams", "Birch", "Cedar", "Chestnut", "Church", "College", "Davis",
    "Dogwood", "East", "Elm",
]
STREET_W2 = [
    "Ave", "Blvd", "Circle", "Court", "Dr", "Lane", "Parkway", "Pkwy",
    "RD", "ST", "Street", "Way", "Wy", "Boulevard", "Cir", "Ct", "Drive",
    "Ln", "Pl", "Road",
]
STORE_NAMES = ["able", "anti", "ation", "bar", "cally", "eing", "ese",
               "n st", "ought", "pri"]
COUNTIES = [
    "Barrow County", "Bronx County", "Daviess County", "Fairfield County",
    "Franklin Parish", "Luce County", "Mobile County", "Richland County",
    "Walker County", "Williamson County",
]
COMPANIES = ["pri", "able", "ese", "anti", "cally", "ation"]
CATEGORIES = ["Books", "Children", "Electronics", "Home", "Jewelry",
              "Men", "Music", "Shoes", "Sports", "Women"]
CLASSES = [
    "accent", "arts", "athletic", "bedding", "bridal", "blinds/shades",
    "bracelets", "classical", "computers", "consignment", "country",
    "curtains/drapes", "decor", "dresses", "fiction", "history",
]
FIRST_NAMES = [
    "Aaron", "Alice", "Amy", "Anna", "Brian", "Carol", "Chad", "Daniel",
    "David", "Diane", "Earl", "Edna", "Frank", "Grace", "Helen", "Irene",
    "Jack", "James", "Karen", "Larry", "Linda", "Maria", "Nancy", "Oscar",
    "Paul", "Rachel", "Sarah", "Thomas", "Velma", "Walter",
]
LAST_NAMES = [
    "Adams", "Baker", "Brown", "Clark", "Davis", "Evans", "Garcia",
    "Harris", "Hill", "Johnson", "Jones", "King", "Lewis", "Lopez",
    "Martin", "Miller", "Moore", "Nelson", "Parker", "Roberts",
    "Robinson", "Scott", "Smith", "Taylor", "Thompson", "Turner",
    "Walker", "White", "Williams", "Young",
]
PROMO_CHANNELS = ["N", "Y"]

_STREET_NAME = _LazyCombo(STREET_W1, STREET_W2)
_I_NAME = _LazyCombo(COLORS, COLORS)
_ZIPS = [f"{z:05d}" for z in range(10000, 10000 + 100 * 97, 97)]
_STREET_NUMS = [str(n) for n in range(1, 1001)]

D7_2 = T.decimal(7, 2)


# -------------------------------------------------- multi-line order maps

#: tickets/orders carry 1..4 line items cycling; closed form mirrors
#: tpch's lineitem cycle (connectors.tpch._lineitem_order)
_CYC = np.array([0, 1, 3, 6, 10], dtype=np.int64)  # prefix sums of 1..4
_ROWS_PER_CYC = 10
_ORDERS_PER_CYC = 4


def _sparse_amount(pick_tag: int, amt_tag: int, rows: np.ndarray):
    """80%-zero coupon amounts, 1.00..20.00 otherwise (shared by the
    store and catalog channels so the sparsity stays aligned)."""
    r = _uniform(pick_tag, rows, 0, 9)
    return np.where(r < 8, 0, _uniform(amt_tag, rows, 100, 2000))


def _order_of_row(rows: np.ndarray):
    """sales row -> (order index 0-based, line number 1-based)."""
    cyc, rr = np.divmod(rows, _ROWS_PER_CYC)
    j = np.searchsorted(_CYC, rr, side="right") - 1
    return cyc * _ORDERS_PER_CYC + j, rr - _CYC[j] + 1


# ------------------------------------------------------------- row counts


def _counts(sf: float) -> Dict[str, int]:
    root = max(sf, 0.01) ** 0.5
    ss = max(int(2_880_000 * sf), 100)
    cs = max(int(1_440_000 * sf), 100)
    ws = max(int(720_000 * sf), 90)
    return {
        "date_dim": N_DATES,
        "time_dim": 86_400,
        "reason": max(int(35 * root), 5),
        "ship_mode": 20,
        "call_center": max(int(6 * root), 2),
        "web_page": max(int(60 * sf), 10),
        "catalog_page": max(int(11_718 * root), 100),
        # items x warehouses x weekly inventory dates (official dsdgen
        # shape: one snapshot per week across the 1998-2002 band)
        "inventory": max(int(18_000 * sf), 100) * 5 * 261,
        "income_band": 20,
        "customer_demographics": 5600,  # 2*5*7*20*4 mixed radix
        "household_demographics": 1200,  # 20*6*10 mixed radix
        "warehouse": 5,
        "web_site": 6,
        "store": max(int(12 * root), 2),
        "promotion": max(int(300 * sf), 3),
        "item": max(int(18_000 * sf), 100),
        "customer": max(int(100_000 * sf), 500),
        "customer_address": max(int(50_000 * sf), 250),
        "store_sales": ss,
        "store_returns": ss // 2,
        "catalog_sales": cs,
        "catalog_returns": cs // 2,
        "web_sales": ws,
        "web_returns": ws // 3,
    }


# --------------------------------------------------------------- schemas

TABLE_SCHEMAS: Dict[str, Dict[str, T.DataType]] = {
    "date_dim": {
        "d_date_sk": T.INTEGER,
        "d_date": T.DATE,
        "d_year": T.INTEGER,
        "d_moy": T.INTEGER,
        "d_dom": T.INTEGER,
        "d_dow": T.INTEGER,
        "d_qoy": T.INTEGER,
        "d_day_name": T.VARCHAR,
        "d_month_seq": T.INTEGER,
        "d_quarter_name": T.VARCHAR,
        "d_week_seq": T.INTEGER,
    },
    "income_band": {
        "ib_income_band_sk": T.INTEGER,
        "ib_lower_bound": T.INTEGER,
        "ib_upper_bound": T.INTEGER,
    },
    "time_dim": {
        "t_time_sk": T.INTEGER,
        "t_time_id": T.VARCHAR,
        "t_time": T.INTEGER,
        "t_hour": T.INTEGER,
        "t_minute": T.INTEGER,
        "t_second": T.INTEGER,
        "t_am_pm": T.VARCHAR,
        "t_meal_time": T.VARCHAR,
        "t_shift": T.VARCHAR,
    },
    "reason": {
        "r_reason_sk": T.INTEGER,
        "r_reason_id": T.VARCHAR,
        "r_reason_desc": T.VARCHAR,
    },
    "ship_mode": {
        "sm_ship_mode_sk": T.INTEGER,
        "sm_ship_mode_id": T.VARCHAR,
        "sm_type": T.VARCHAR,
        "sm_code": T.VARCHAR,
        "sm_carrier": T.VARCHAR,
    },
    "call_center": {
        "cc_call_center_sk": T.INTEGER,
        "cc_call_center_id": T.VARCHAR,
        "cc_name": T.VARCHAR,
        "cc_manager": T.VARCHAR,
        "cc_county": T.VARCHAR,
        "cc_state": T.VARCHAR,
    },
    "web_page": {
        "wp_web_page_sk": T.INTEGER,
        "wp_web_page_id": T.VARCHAR,
        "wp_url": T.VARCHAR,
        "wp_char_count": T.INTEGER,
        "wp_link_count": T.INTEGER,
    },
    "catalog_page": {
        "cp_catalog_page_sk": T.INTEGER,
        "cp_catalog_page_id": T.VARCHAR,
        "cp_catalog_number": T.INTEGER,
        "cp_catalog_page_number": T.INTEGER,
        "cp_department": T.VARCHAR,
    },
    "inventory": {
        "inv_date_sk": T.INTEGER,
        "inv_item_sk": T.INTEGER,
        "inv_warehouse_sk": T.INTEGER,
        "inv_quantity_on_hand": T.INTEGER,
    },
    "customer_demographics": {
        "cd_demo_sk": T.INTEGER,
        "cd_gender": T.VARCHAR,
        "cd_marital_status": T.VARCHAR,
        "cd_education_status": T.VARCHAR,
        "cd_purchase_estimate": T.INTEGER,
        "cd_credit_rating": T.VARCHAR,
        "cd_dep_count": T.INTEGER,
        "cd_dep_employed_count": T.INTEGER,
        "cd_dep_college_count": T.INTEGER,
    },
    "household_demographics": {
        "hd_demo_sk": T.INTEGER,
        "hd_income_band_sk": T.INTEGER,
        "hd_buy_potential": T.VARCHAR,
        "hd_dep_count": T.INTEGER,
        "hd_vehicle_count": T.INTEGER,
    },
    "warehouse": {
        "w_warehouse_sk": T.INTEGER,
        "w_warehouse_name": T.VARCHAR,
        "w_state": T.VARCHAR,
        "w_warehouse_sq_ft": T.INTEGER,
        "w_city": T.VARCHAR,
        "w_county": T.VARCHAR,
        "w_country": T.VARCHAR,
    },
    "web_site": {
        "web_site_sk": T.INTEGER,
        "web_site_id": T.VARCHAR,
        "web_name": T.VARCHAR,
        "web_company_name": T.VARCHAR,
    },
    "store": {
        "s_store_sk": T.INTEGER,
        "s_store_id": T.VARCHAR,
        "s_store_name": T.VARCHAR,
        "s_city": T.VARCHAR,
        "s_state": T.VARCHAR,
        "s_zip": T.VARCHAR,
        "s_number_employees": T.INTEGER,
        "s_company_name": T.VARCHAR,
        "s_county": T.VARCHAR,
        "s_gmt_offset": T.INTEGER,
        "s_company_id": T.INTEGER,
        "s_street_number": T.VARCHAR,
        "s_street_name": T.VARCHAR,
        "s_street_type": T.VARCHAR,
        "s_suite_number": T.VARCHAR,
        "s_market_id": T.INTEGER,
    },
    "promotion": {
        "p_promo_sk": T.INTEGER,
        "p_promo_id": T.VARCHAR,
        "p_channel_email": T.VARCHAR,
        "p_channel_event": T.VARCHAR,
        "p_channel_dmail": T.VARCHAR,
        "p_channel_tv": T.VARCHAR,
    },
    "item": {
        "i_item_sk": T.INTEGER,
        "i_item_id": T.VARCHAR,
        "i_item_desc": T.VARCHAR,
        "i_product_name": T.VARCHAR,
        "i_color": T.VARCHAR,
        "i_current_price": D7_2,
        "i_category": T.VARCHAR,
        "i_category_id": T.INTEGER,
        "i_class": T.VARCHAR,
        "i_class_id": T.INTEGER,
        "i_brand": T.VARCHAR,
        "i_brand_id": T.INTEGER,
        "i_manufact_id": T.INTEGER,
        "i_manufact": T.VARCHAR,
        "i_size": T.VARCHAR,
        "i_units": T.VARCHAR,
        "i_manager_id": T.INTEGER,
        "i_wholesale_cost": D7_2,
    },
    "customer": {
        "c_customer_sk": T.INTEGER,
        "c_customer_id": T.VARCHAR,
        "c_first_name": T.VARCHAR,
        "c_last_name": T.VARCHAR,
        "c_current_cdemo_sk": T.INTEGER,
        "c_current_hdemo_sk": T.INTEGER,
        "c_current_addr_sk": T.INTEGER,
        "c_first_sales_date_sk": T.INTEGER,
        "c_first_shipto_date_sk": T.INTEGER,
        "c_birth_year": T.INTEGER,
        "c_birth_month": T.INTEGER,
        "c_birth_day": T.INTEGER,
        "c_birth_country": T.VARCHAR,
        "c_login": T.VARCHAR,
        "c_email_address": T.VARCHAR,
        "c_last_review_date_sk": T.INTEGER,
        "c_salutation": T.VARCHAR,
        "c_preferred_cust_flag": T.VARCHAR,
    },
    "customer_address": {
        "ca_address_sk": T.INTEGER,
        "ca_street_number": T.VARCHAR,
        "ca_street_name": T.VARCHAR,
        "ca_city": T.VARCHAR,
        "ca_state": T.VARCHAR,
        "ca_zip": T.VARCHAR,
        "ca_county": T.VARCHAR,
        "ca_gmt_offset": T.INTEGER,
        "ca_country": T.VARCHAR,
        "ca_street_type": T.VARCHAR,
        "ca_suite_number": T.VARCHAR,
        "ca_location_type": T.VARCHAR,
    },
    "store_sales": {
        "ss_sold_date_sk": T.INTEGER,
        "ss_item_sk": T.INTEGER,
        "ss_customer_sk": T.INTEGER,
        "ss_cdemo_sk": T.INTEGER,
        "ss_hdemo_sk": T.INTEGER,
        "ss_addr_sk": T.INTEGER,
        "ss_store_sk": T.INTEGER,
        "ss_promo_sk": T.INTEGER,
        "ss_ticket_number": T.INTEGER,
        "ss_quantity": T.INTEGER,
        "ss_wholesale_cost": D7_2,
        "ss_list_price": D7_2,
        "ss_sales_price": D7_2,
        "ss_ext_sales_price": D7_2,
        "ss_ext_list_price": D7_2,
        "ss_ext_tax": D7_2,
        "ss_coupon_amt": D7_2,
        "ss_net_profit": D7_2,
        "ss_ext_discount_amt": D7_2,
        "ss_ext_wholesale_cost": D7_2,
        "ss_net_paid": D7_2,
        "ss_sold_time_sk": T.INTEGER,
    },
    "store_returns": {
        "sr_returned_date_sk": T.INTEGER,
        "sr_item_sk": T.INTEGER,
        "sr_ticket_number": T.INTEGER,
        "sr_return_amt": D7_2,
        "sr_net_loss": D7_2,
        "sr_store_sk": T.INTEGER,
        "sr_customer_sk": T.INTEGER,
        "sr_return_quantity": T.INTEGER,
        "sr_reason_sk": T.INTEGER,
        "sr_cdemo_sk": T.INTEGER,
    },
    "catalog_sales": {
        "cs_sold_date_sk": T.INTEGER,
        "cs_ship_date_sk": T.INTEGER,
        "cs_bill_customer_sk": T.INTEGER,
        "cs_bill_cdemo_sk": T.INTEGER,
        "cs_item_sk": T.INTEGER,
        "cs_promo_sk": T.INTEGER,
        "cs_ship_mode_sk": T.INTEGER,
        "cs_call_center_sk": T.INTEGER,
        "cs_warehouse_sk": T.INTEGER,
        "cs_order_number": T.INTEGER,
        "cs_quantity": T.INTEGER,
        "cs_list_price": D7_2,
        "cs_sales_price": D7_2,
        "cs_coupon_amt": D7_2,
        "cs_ext_list_price": D7_2,
        "cs_ext_sales_price": D7_2,
        "cs_net_profit": D7_2,
        "cs_catalog_page_sk": T.INTEGER,
        "cs_bill_hdemo_sk": T.INTEGER,
        "cs_ext_discount_amt": D7_2,
        "cs_wholesale_cost": D7_2,
        "cs_ext_ship_cost": D7_2,
        "cs_ext_wholesale_cost": D7_2,
        "cs_net_paid": D7_2,
        "cs_ship_addr_sk": T.INTEGER,
        "cs_bill_addr_sk": T.INTEGER,
        "cs_ship_customer_sk": T.INTEGER,
        "cs_sold_time_sk": T.INTEGER,
    },
    "catalog_returns": {
        "cr_returned_date_sk": T.INTEGER,
        "cr_item_sk": T.INTEGER,
        "cr_order_number": T.INTEGER,
        "cr_refunded_cash": D7_2,
        "cr_reversed_charge": D7_2,
        "cr_store_credit": D7_2,
        "cr_return_amount": D7_2,
        "cr_net_loss": D7_2,
        "cr_catalog_page_sk": T.INTEGER,
        "cr_return_quantity": T.INTEGER,
        "cr_returning_customer_sk": T.INTEGER,
        "cr_returning_addr_sk": T.INTEGER,
        "cr_call_center_sk": T.INTEGER,
    },
    "web_sales": {
        "ws_sold_date_sk": T.INTEGER,
        "ws_ship_date_sk": T.INTEGER,
        "ws_item_sk": T.INTEGER,
        "ws_ship_addr_sk": T.INTEGER,
        "ws_web_site_sk": T.INTEGER,
        "ws_warehouse_sk": T.INTEGER,
        "ws_ship_mode_sk": T.INTEGER,
        "ws_order_number": T.INTEGER,
        "ws_ext_ship_cost": D7_2,
        "ws_ext_sales_price": D7_2,
        "ws_net_profit": D7_2,
        "ws_web_page_sk": T.INTEGER,
        "ws_promo_sk": T.INTEGER,
        "ws_sales_price": D7_2,
        "ws_quantity": T.INTEGER,
        "ws_list_price": D7_2,
        "ws_wholesale_cost": D7_2,
        "ws_ext_discount_amt": D7_2,
        "ws_ext_wholesale_cost": D7_2,
        "ws_ext_list_price": D7_2,
        "ws_net_paid": D7_2,
        "ws_sold_time_sk": T.INTEGER,
        "ws_ship_hdemo_sk": T.INTEGER,
        "ws_bill_customer_sk": T.INTEGER,
        "ws_bill_addr_sk": T.INTEGER,
    },
    "web_returns": {
        "wr_returned_date_sk": T.INTEGER,
        "wr_item_sk": T.INTEGER,
        "wr_order_number": T.INTEGER,
        "wr_return_amt": D7_2,
        "wr_net_loss": D7_2,
        "wr_web_page_sk": T.INTEGER,
        "wr_return_quantity": T.INTEGER,
        "wr_returning_customer_sk": T.INTEGER,
        "wr_returning_addr_sk": T.INTEGER,
        "wr_refunded_cash": D7_2,
        "wr_reason_sk": T.INTEGER,
        "wr_refunded_cdemo_sk": T.INTEGER,
        "wr_refunded_addr_sk": T.INTEGER,
        "wr_returning_cdemo_sk": T.INTEGER,
        "wr_fee": D7_2,
    },
}


# ------------------------------------------------------------ generators


class TpcdsGenerator:
    def __init__(self, sf: float):
        self.sf = sf
        self.counts = _counts(sf)

    def generate(
        self, table: str, lo: int, hi: int, columns: Sequence[str]
    ) -> Dict[str, object]:
        rows = np.arange(lo, hi, dtype=np.int64)
        return getattr(self, f"_gen_{table}")(rows, list(columns))

    # -- dimensions ---------------------------------------------------

    def _gen_date_dim(self, rows, columns):
        days = _D_START + rows
        dates = [_EPOCH + datetime.timedelta(days=int(d)) for d in days]
        out = {}
        for c in columns:
            if c == "d_date_sk":
                out[c] = _DATE_SK0 + rows
            elif c == "d_date":
                out[c] = days
            elif c == "d_year":
                out[c] = np.asarray([d.year for d in dates], np.int64)
            elif c == "d_moy":
                out[c] = np.asarray([d.month for d in dates], np.int64)
            elif c == "d_dom":
                out[c] = np.asarray([d.day for d in dates], np.int64)
            elif c == "d_dow":
                out[c] = (days + 4) % 7  # 0=Sunday, matching d_day_name
            elif c == "d_qoy":
                out[c] = np.asarray(
                    [(d.month - 1) // 3 + 1 for d in dates], np.int64
                )
            elif c == "d_quarter_name":
                out[c] = _fixed(
                    [f"{y}Q{q}" for y in range(1990, 2004)
                     for q in range(1, 5)],
                    np.asarray(
                        [(d.year - 1990) * 4 + (d.month - 1) // 3
                         for d in dates],
                        np.int64,
                    ),
                )
            elif c == "d_day_name":
                out[c] = _fixed(
                    ["Sunday", "Monday", "Tuesday", "Wednesday",
                     "Thursday", "Friday", "Saturday"],
                    (days + 4) % 7,  # 1970-01-01 was a Thursday
                )
            elif c == "d_month_seq":
                # monotone month counter (the official dimension's
                # sequence anchor differs; queries only ever use
                # RANGES of it, which are translation-invariant)
                out[c] = np.asarray(
                    [(d.year - 1900) * 12 + d.month - 1 for d in dates],
                    np.int64,
                )
            elif c == "d_week_seq":
                # monotone week counter, Sunday-aligned like d_dow
                out[c] = (days + 4) // 7
        return out

    def _date_sk_for(self, days: np.ndarray) -> np.ndarray:
        """epoch-days -> d_date_sk (clipped into the dimension)."""
        return _DATE_SK0 + np.clip(days - _D_START, 0, N_DATES - 1)

    def _gen_time_dim(self, rows, columns):
        out = {}
        hour = rows // 3600
        for c in columns:
            if c == "t_time_sk":
                out[c] = rows
            elif c == "t_time_id":
                out[c] = _numbered(
                    "Time", self.counts["time_dim"], rows + 1
                )
            elif c == "t_time":
                out[c] = rows
            elif c == "t_hour":
                out[c] = hour
            elif c == "t_minute":
                out[c] = (rows // 60) % 60
            elif c == "t_second":
                out[c] = rows % 60
            elif c == "t_am_pm":
                out[c] = _fixed(["AM", "PM"], (hour >= 12).astype(np.int64))
            elif c == "t_meal_time":
                # official domains: breakfast 6-9, lunch 11-14,
                # dinner 17-20, empty otherwise
                pick = np.where(
                    (hour >= 6) & (hour < 9), 1,
                    np.where(
                        (hour >= 11) & (hour < 14), 2,
                        np.where((hour >= 17) & (hour < 20), 3, 0),
                    ),
                )
                out[c] = _fixed(
                    ["", "breakfast", "lunch", "dinner"], pick
                )
            elif c == "t_shift":
                out[c] = _fixed(
                    ["first", "second", "third"],
                    np.clip(hour // 8, 0, 2),
                )
        return out

    def _gen_reason(self, rows, columns):
        out = {}
        for c in columns:
            if c == "r_reason_sk":
                out[c] = rows + 1
            elif c == "r_reason_id":
                out[c] = _numbered(
                    "Reason", self.counts["reason"], rows + 1
                )
            elif c == "r_reason_desc":
                out[c] = _fixed(REASON_DESCS, rows % len(REASON_DESCS))
        return out

    def _gen_ship_mode(self, rows, columns):
        out = {}
        for c in columns:
            if c == "sm_ship_mode_sk":
                out[c] = rows + 1
            elif c == "sm_ship_mode_id":
                out[c] = _numbered(
                    "ShipMode", self.counts["ship_mode"], rows + 1
                )
            elif c == "sm_type":
                out[c] = _fixed(SHIP_TYPES, rows % len(SHIP_TYPES))
            elif c == "sm_code":
                out[c] = _fixed(SHIP_CODES, (rows // 5) % len(SHIP_CODES))
            elif c == "sm_carrier":
                out[c] = _fixed(CARRIERS, rows % len(CARRIERS))
        return out

    def _gen_call_center(self, rows, columns):
        out = {}
        for c in columns:
            if c == "cc_call_center_sk":
                out[c] = rows + 1
            elif c == "cc_call_center_id":
                out[c] = _numbered(
                    "CallCenter", self.counts["call_center"], rows + 1
                )
            elif c == "cc_name":
                out[c] = _fixed(CC_NAMES, rows % len(CC_NAMES))
            elif c == "cc_manager":
                out[c] = _numbered(
                    "Manager", self.counts["call_center"], rows + 1
                )
            elif c == "cc_county":
                out[c] = _fixed(COUNTIES, rows % len(COUNTIES))
            elif c == "cc_state":
                out[c] = _fixed(STATES, rows % len(STATES))
        return out

    def _gen_web_page(self, rows, columns):
        out = {}
        for c in columns:
            if c == "wp_web_page_sk":
                out[c] = rows + 1
            elif c == "wp_web_page_id":
                out[c] = _numbered(
                    "WebPage", self.counts["web_page"], rows + 1
                )
            elif c == "wp_url":
                out[c] = _fixed(["http://www.foo.com"], rows * 0)
            elif c == "wp_char_count":
                out[c] = _uniform(3101, rows, 100, 8000)
            elif c == "wp_link_count":
                out[c] = _uniform(3102, rows, 2, 25)
        return out

    def _gen_catalog_page(self, rows, columns):
        out = {}
        for c in columns:
            if c == "cp_catalog_page_sk":
                out[c] = rows + 1
            elif c == "cp_catalog_page_id":
                out[c] = _numbered(
                    "CatalogPage", self.counts["catalog_page"], rows + 1
                )
            elif c == "cp_catalog_number":
                out[c] = rows // 108 + 1  # 108 pages per catalog
            elif c == "cp_catalog_page_number":
                out[c] = rows % 108 + 1
            elif c == "cp_department":
                out[c] = _fixed(["DEPARTMENT"], rows * 0)
        return out

    def _gen_inventory(self, rows, columns):
        # row = ((week * n_items) + item) * 5 + warehouse: every
        # (item, warehouse) pair snapshots once per week
        n_items = self.counts["item"]
        wh = rows % 5
        item = (rows // 5) % n_items
        week = rows // (5 * n_items)
        out = {}
        for c in columns:
            if c == "inv_date_sk":
                out[c] = self._date_sk_for(_SOLD_LO + week * 7)
            elif c == "inv_item_sk":
                out[c] = item + 1
            elif c == "inv_warehouse_sk":
                out[c] = wh + 1
            elif c == "inv_quantity_on_hand":
                out[c] = _uniform(3201, rows, 0, 1000)
        return out

    def _gen_income_band(self, rows, columns):
        out = {}
        for c in columns:
            if c == "ib_income_band_sk":
                out[c] = rows + 1
            elif c == "ib_lower_bound":
                out[c] = rows * 10000
            elif c == "ib_upper_bound":
                out[c] = rows * 10000 + 9999
        return out

    def _gen_customer_demographics(self, rows, columns):
        out = {}
        for c in columns:
            if c == "cd_demo_sk":
                out[c] = rows + 1
            elif c == "cd_gender":
                out[c] = _fixed(GENDER, rows % 2)
            elif c == "cd_marital_status":
                out[c] = _fixed(MARITAL, (rows // 2) % 5)
            elif c == "cd_education_status":
                out[c] = _fixed(EDUCATION, (rows // 10) % 7)
            elif c == "cd_purchase_estimate":
                out[c] = 500 * (1 + (rows // 70) % 20)
            elif c == "cd_credit_rating":
                out[c] = _fixed(CREDIT, (rows // 1400) % 4)
            elif c == "cd_dep_count":
                out[c] = (rows // 35) % 7
            elif c == "cd_dep_employed_count":
                out[c] = (rows // 245) % 7
            elif c == "cd_dep_college_count":
                out[c] = (rows // 1715) % 7
        return out

    def _gen_household_demographics(self, rows, columns):
        out = {}
        for c in columns:
            if c == "hd_demo_sk":
                out[c] = rows + 1
            elif c == "hd_income_band_sk":
                out[c] = rows % 20 + 1
            elif c == "hd_buy_potential":
                out[c] = _fixed(BUY_POTENTIAL, (rows // 20) % 6)
            elif c == "hd_dep_count":
                out[c] = (rows // 120) % 10
            elif c == "hd_vehicle_count":
                out[c] = (rows // 7) % 6 - 1  # official domain -1..4
        return out

    def _gen_warehouse(self, rows, columns):
        out = {}
        for c in columns:
            if c == "w_warehouse_sk":
                out[c] = rows + 1
            elif c == "w_warehouse_sq_ft":
                out[c] = _uniform(1220, rows, 50000, 1000000)
            elif c == "w_city":
                out[c] = _fixed(CITIES, rows % len(CITIES))
            elif c == "w_county":
                out[c] = _fixed(COUNTIES, rows % len(COUNTIES))
            elif c == "w_country":
                out[c] = _fixed(["United States"], rows * 0)
            elif c == "w_warehouse_name":
                out[c] = _fixed(
                    ["Bad cards must make.",
                     "Conventional childr",
                     "Doors canno",
                     "Important issues liv",
                     "Rooms cook ",
                     ][: max(int(self.counts["warehouse"]), 1)],
                    rows % self.counts["warehouse"],
                )
            elif c == "w_state":
                out[c] = _fixed(STATES, rows % len(STATES))
        return out

    def _gen_web_site(self, rows, columns):
        out = {}
        for c in columns:
            if c == "web_site_sk":
                out[c] = rows + 1
            elif c == "web_site_id":
                out[c] = _numbered("site", self.counts["web_site"], rows + 1)
            elif c == "web_name":
                out[c] = _numbered("web", self.counts["web_site"], rows + 1)
            elif c == "web_company_name":
                # 2 of 6 sites belong to 'pri' (Q95's company filter must
                # select a meaningful slice at every scale)
                out[c] = _fixed(COMPANIES, rows % 3)
        return out

    def _gen_store(self, rows, columns):
        out = {}
        for c in columns:
            if c == "s_store_sk":
                out[c] = rows + 1
            elif c == "s_store_id":
                out[c] = _numbered("Store", self.counts["store"], rows + 1)
            elif c == "s_store_name":
                out[c] = _fixed(STORE_NAMES, rows % len(STORE_NAMES))
            elif c == "s_city":
                out[c] = _fixed(CITIES, rows % len(CITIES))
            elif c == "s_number_employees":
                out[c] = _uniform(1210, rows, 200, 300)
            elif c == "s_state":
                out[c] = _fixed(STATES, rows % len(STATES))
            elif c == "s_zip":
                out[c] = _fixed(_ZIPS, rows % len(_ZIPS))
            elif c == "s_company_name":
                out[c] = _fixed(["Unknown", "ought"], rows % 2)
            elif c == "s_county":
                out[c] = _fixed(COUNTIES, rows % len(COUNTIES))
            elif c == "s_gmt_offset":
                # continental offsets; -5 modal like customer_address
                out[c] = -5 - (rows % 4) % 3 - (rows % 4) // 3 * 3
            elif c == "s_company_id":
                out[c] = rows % 2 + 1
            elif c == "s_street_number":
                out[c] = _fixed(
                    _STREET_NUMS,
                    _uniform(1211, rows, 0, len(_STREET_NUMS) - 1),
                )
            elif c == "s_street_name":
                out[c] = _STREET_NAME.column(1212, rows)
            elif c == "s_street_type":
                out[c] = _fixed(
                    ["Street", "Ave", "Blvd", "Road", "Lane"],
                    rows % 5,
                )
            elif c == "s_suite_number":
                out[c] = _fixed(
                    [f"Suite {n}" for n in range(0, 300, 10)],
                    _uniform(1213, rows, 0, 29),
                )
            elif c == "s_market_id":
                out[c] = rows % 10 + 1
        return out

    def _gen_promotion(self, rows, columns):
        out = {}
        for c in columns:
            if c == "p_promo_sk":
                out[c] = rows + 1
            elif c == "p_promo_id":
                out[c] = _numbered(
                    "Promo", self.counts["promotion"], rows + 1
                )
            elif c == "p_channel_email":
                out[c] = _fixed(PROMO_CHANNELS, rows % 2)
            elif c == "p_channel_event":
                # phase-shifted vs email so OR filters select a real mix
                out[c] = _fixed(PROMO_CHANNELS, (rows // 2) % 2)
            elif c == "p_channel_dmail":
                out[c] = _fixed(PROMO_CHANNELS, (rows // 4) % 2)
            elif c == "p_channel_tv":
                out[c] = _fixed(PROMO_CHANNELS, (rows // 8) % 2)
        return out

    def _gen_item(self, rows, columns):
        # hoisted picks: each id/name pair (category, class, brand,
        # manufact) is functionally dependent through a single draw
        cat = _uniform(1404, rows, 0, 9)
        cls = _uniform(1406, rows, 0, len(CLASSES) - 1)
        brand = _uniform(1407, rows, 1, 500)
        manufact = _uniform(1405, rows, 1, 1000)
        out = {}
        for c in columns:
            if c == "i_item_sk":
                out[c] = rows + 1
            elif c == "i_item_id":
                out[c] = _numbered("Item", self.counts["item"], rows + 1)
            elif c == "i_product_name":
                out[c] = _I_NAME.column(1401, rows)
            elif c == "i_item_desc":
                out[c] = _I_NAME.column(1409, rows)
            elif c == "i_color":
                out[c] = _fixed(
                    COLORS,
                    (_stream(1402, rows) % np.uint64(len(COLORS))).astype(
                        np.int64
                    ),
                )
            elif c == "i_current_price":
                # 50.00..90.00: Q64's price-window parameters select a
                # real slice of items at every scale factor
                out[c] = _uniform(1403, rows, 5000, 9000)
            elif c == "i_category":
                out[c] = _fixed(CATEGORIES, cat)
            elif c == "i_category_id":
                out[c] = cat + 1
            elif c == "i_class":
                out[c] = _fixed(CLASSES, cls)
            elif c == "i_class_id":
                out[c] = cls + 1
            elif c == "i_brand":
                # brand name derived from the same draw as i_brand_id
                # (functional dependence, like dsdgen's brand hierarchy)
                out[c] = _numbered("brand", 500, brand)
            elif c == "i_brand_id":
                out[c] = brand
            elif c == "i_manufact_id":
                out[c] = manufact
            elif c == "i_manufact":
                out[c] = _numbered("manufact", 1000, manufact)
            elif c == "i_size":
                out[c] = _fixed(
                    ["small", "medium", "large", "extra large",
                     "economy", "petite", "N/A"],
                    _uniform(1411, rows, 0, 6),
                )
            elif c == "i_units":
                out[c] = _fixed(
                    ["Each", "Oz", "Pound", "Dozen", "Carton",
                     "Case", "Bunch", "Unknown"],
                    _uniform(1412, rows, 0, 7),
                )
            elif c == "i_manager_id":
                out[c] = _uniform(1408, rows, 1, 100)
            elif c == "i_wholesale_cost":
                # 20.00..80.00, independent of i_current_price like the
                # official generator's separate draw
                out[c] = _uniform(1410, rows, 2000, 8000)
        return out

    def _gen_customer(self, rows, columns):
        cn = self.counts
        out = {}
        for c in columns:
            if c == "c_customer_sk":
                out[c] = rows + 1
            elif c == "c_customer_id":
                out[c] = _numbered("Customer", cn["customer"], rows + 1)
            elif c == "c_first_name":
                out[c] = _fixed(
                    FIRST_NAMES,
                    _uniform(1507, rows, 0, len(FIRST_NAMES) - 1),
                )
            elif c == "c_last_name":
                out[c] = _fixed(
                    LAST_NAMES,
                    _uniform(1508, rows, 0, len(LAST_NAMES) - 1),
                )
            elif c == "c_current_cdemo_sk":
                out[c] = _uniform(
                    1501, rows, 1, cn["customer_demographics"]
                )
            elif c == "c_current_hdemo_sk":
                out[c] = _uniform(
                    1502, rows, 1, cn["household_demographics"]
                )
            elif c == "c_current_addr_sk":
                out[c] = _uniform(1503, rows, 1, cn["customer_address"])
            elif c == "c_first_sales_date_sk":
                out[c] = self._date_sk_for(
                    _uniform(1504, rows, _D_START, _SOLD_HI)
                )
            elif c == "c_first_shipto_date_sk":
                out[c] = self._date_sk_for(
                    _uniform(1505, rows, _D_START, _SOLD_HI)
                )
            elif c == "c_birth_year":
                out[c] = _uniform(1506, rows, 1930, 1990)
            elif c == "c_birth_month":
                out[c] = _uniform(1511, rows, 1, 12)
            elif c == "c_birth_day":
                out[c] = _uniform(1512, rows, 1, 28)
            elif c == "c_birth_country":
                out[c] = _fixed(
                    ["UNITED STATES", "CANADA", "MEXICO", "FRANCE",
                     "GERMANY", "JAPAN", "BRAZIL", "INDIA"],
                    _uniform(1513, rows, 0, 7),
                )
            elif c == "c_login":
                out[c] = _numbered("login", cn["customer"], rows + 1)
            elif c == "c_email_address":
                out[c] = _numbered("email", cn["customer"], rows + 1)
            elif c == "c_last_review_date_sk":
                out[c] = self._date_sk_for(
                    _uniform(1514, rows, _D_START, _SOLD_HI)
                )
            elif c == "c_salutation":
                out[c] = _fixed(
                    ["Mr.", "Mrs.", "Ms.", "Dr.", "Sir", "Miss"],
                    _uniform(1509, rows, 0, 5),
                )
            elif c == "c_preferred_cust_flag":
                out[c] = _fixed(["N", "Y"], _uniform(1510, rows, 0, 1))
        return out

    def _gen_customer_address(self, rows, columns):
        out = {}
        for c in columns:
            if c == "ca_address_sk":
                out[c] = rows + 1
            elif c == "ca_street_number":
                out[c] = _fixed(
                    _STREET_NUMS,
                    _uniform(1601, rows, 0, len(_STREET_NUMS) - 1),
                )
            elif c == "ca_street_name":
                out[c] = _STREET_NAME.column(1602, rows)
            elif c == "ca_city":
                out[c] = _fixed(
                    CITIES, _uniform(1603, rows, 0, len(CITIES) - 1)
                )
            elif c == "ca_state":
                out[c] = _fixed(
                    STATES, _uniform(1604, rows, 0, len(STATES) - 1)
                )
            elif c == "ca_zip":
                out[c] = _fixed(
                    _ZIPS, _uniform(1605, rows, 0, len(_ZIPS) - 1)
                )
            elif c == "ca_county":
                out[c] = _fixed(
                    COUNTIES, _uniform(1606, rows, 0, len(COUNTIES) - 1)
                )
            elif c == "ca_country":
                out[c] = _fixed(["United States"], rows * 0)
            elif c == "ca_street_type":
                out[c] = _fixed(
                    ["Street", "Ave", "Blvd", "Road", "Lane"],
                    _uniform(1608, rows, 0, 4),
                )
            elif c == "ca_suite_number":
                out[c] = _fixed(
                    [f"Suite {n}" for n in range(0, 300, 10)],
                    _uniform(1609, rows, 0, 29),
                )
            elif c == "ca_location_type":
                out[c] = _fixed(
                    ["apartment", "condo", "single family"],
                    _uniform(1610, rows, 0, 2),
                )
            elif c == "ca_gmt_offset":
                # continental offsets; -5 is the modal official
                # substitution value so it must select a real slice
                out[c] = np.asarray([-5, -5, -6, -7, -8], np.int64)[
                    _uniform(1607, rows, 0, 4)
                ]
        return out

    # -- fact tables --------------------------------------------------

    def _ss_fields(self, rows):
        """Shared store_sales row fields (store_returns derives from the
        same closed forms via its row map, keeping FK pairs exact)."""
        cn = self.counts
        ticket, _line = _order_of_row(rows)
        return {
            "ticket": ticket + 1,
            "item": _uniform(1701, rows, 1, cn["item"]),
            "sold": _uniform(1702, rows, _SOLD_LO, _SOLD_HI),
        }

    def _gen_store_sales(self, rows, columns):
        cn = self.counts
        f = self._ss_fields(rows)
        # hoisted shared draws: per-unit and extended columns must stay
        # row-wise consistent, so each quantity/price stream is drawn
        # exactly once here (the consistency invariant lives in these
        # bindings, not in matching magic tags across branches)
        wholesale = _uniform(1703, rows, 100, 10000)
        quantity = _uniform(1710, rows, 1, 100)
        list_price = wholesale + _uniform(1711, rows, 0, 5000)
        sales_price = _uniform(1714, rows, 50, 9900)
        out = {}
        for c in columns:
            if c == "ss_sold_date_sk":
                out[c] = self._date_sk_for(f["sold"])
            elif c == "ss_item_sk":
                out[c] = f["item"]
            elif c == "ss_customer_sk":
                # drawn from the TICKET, not the row: every line of a
                # ticket belongs to one customer (official dsdgen;
                # Q34-class per-ticket counts join this to customer)
                out[c] = _uniform(1704, f["ticket"], 1, cn["customer"])
            elif c == "ss_cdemo_sk":
                out[c] = _uniform(
                    1705, rows, 1, cn["customer_demographics"]
                )
            elif c == "ss_hdemo_sk":
                out[c] = _uniform(
                    1706, rows, 1, cn["household_demographics"]
                )
            elif c == "ss_addr_sk":
                out[c] = _uniform(1707, rows, 1, cn["customer_address"])
            elif c == "ss_store_sk":
                out[c] = _uniform(1708, rows, 1, cn["store"])
            elif c == "ss_promo_sk":
                out[c] = _uniform(1709, rows, 1, cn["promotion"])
            elif c == "ss_ticket_number":
                out[c] = f["ticket"]
            elif c == "ss_quantity":
                out[c] = quantity
            elif c == "ss_wholesale_cost":
                out[c] = wholesale
            elif c == "ss_list_price":
                out[c] = list_price
            elif c == "ss_sales_price":
                out[c] = sales_price
            elif c == "ss_ext_sales_price":
                # sales_price * quantity, in cents; max 99.00 * 100 =
                # 9900.00, inside decimal(7,2)
                out[c] = sales_price * quantity
            elif c == "ss_ext_list_price":
                # list_price * quantity <= 150.00 * 100, inside d(7,2)
                out[c] = list_price * quantity
            elif c == "ss_ext_tax":
                out[c] = _uniform(1715, rows, 0, 90000)
            elif c == "ss_coupon_amt":
                out[c] = _sparse_amount(1712, 1713, rows)
            elif c == "ss_net_profit":
                out[c] = _uniform(1716, rows, -500000, 1000000)
            elif c == "ss_ext_discount_amt":
                out[c] = _uniform(1717, rows, 0, 100000)
            elif c == "ss_ext_wholesale_cost":
                out[c] = wholesale * quantity
            elif c == "ss_net_paid":
                # quantity * sales_price, from the SAME hoisted draws
                out[c] = quantity * sales_price
            elif c == "ss_sold_time_sk":
                out[c] = _uniform(1718, rows, 0, 86399)
        return out

    def _gen_store_returns(self, rows, columns):
        src = rows * 2  # return j <-> store_sales row 2j
        f = self._ss_fields(src)
        out = {}
        for c in columns:
            if c == "sr_returned_date_sk":
                out[c] = self._date_sk_for(
                    f["sold"] + _uniform(1801, rows, 1, 90)
                )
            elif c == "sr_item_sk":
                out[c] = f["item"]
            elif c == "sr_ticket_number":
                out[c] = f["ticket"]
            elif c == "sr_return_amt":
                out[c] = _uniform(1802, rows, 100, 10000)
            elif c == "sr_net_loss":
                out[c] = _uniform(1803, rows, 100, 8000)
            elif c == "sr_store_sk":
                # SAME closed form store_sales evaluates at the source
                # row: the (ticket, item) FK pair stays store-consistent
                out[c] = _uniform(1708, src, 1, self.counts["store"])
            elif c == "sr_customer_sk":
                # SAME ticket-keyed closed form store_sales evaluates
                # at the source row, so (ticket, customer) stays exact
                out[c] = _uniform(
                    1704, f["ticket"], 1, self.counts["customer"]
                )
            elif c == "sr_return_quantity":
                out[c] = _uniform(1805, rows, 1, 40)
            elif c == "sr_reason_sk":
                out[c] = _uniform(
                    1806, rows, 1, self.counts["reason"]
                )
            elif c == "sr_cdemo_sk":
                out[c] = _uniform(
                    1807, rows, 1, self.counts["customer_demographics"]
                )
        return out

    def _cs_fields(self, rows):
        cn = self.counts
        order, _line = _order_of_row(rows)
        return {
            "order": order + 1,
            "item": _uniform(1901, rows, 1, cn["item"]),
            "sold": _uniform(1902, rows, _SOLD_LO, _SOLD_HI),
        }

    def _gen_catalog_sales(self, rows, columns):
        cn = self.counts
        f = self._cs_fields(rows)
        out = {}
        for c in columns:
            if c == "cs_sold_date_sk":
                out[c] = self._date_sk_for(f["sold"])
            elif c == "cs_ship_date_sk":
                # 1..120-day ship lag: Q99's latency buckets all select
                out[c] = self._date_sk_for(
                    f["sold"] + _uniform(1912, rows, 1, 120)
                )
            elif c == "cs_ship_mode_sk":
                out[c] = _uniform(1913, rows, 1, cn["ship_mode"])
            elif c == "cs_call_center_sk":
                out[c] = _uniform(1914, rows, 1, cn["call_center"])
            elif c == "cs_warehouse_sk":
                out[c] = _uniform(1915, rows, 1, cn["warehouse"])
            elif c == "cs_bill_customer_sk":
                # ORDER-keyed: every line of an order bills one
                # customer (official dsdgen; matches ws/ss channels)
                out[c] = _uniform(1903, f["order"], 1, cn["customer"])
            elif c == "cs_bill_cdemo_sk":
                out[c] = _uniform(
                    1906, rows, 1, cn["customer_demographics"]
                )
            elif c == "cs_item_sk":
                out[c] = f["item"]
            elif c == "cs_promo_sk":
                out[c] = _uniform(1907, rows, 1, cn["promotion"])
            elif c == "cs_order_number":
                out[c] = f["order"]
            elif c == "cs_quantity":
                out[c] = _uniform(1904, rows, 1, 100)
            elif c == "cs_list_price":
                # sales <= list, like the store channel's
                # wholesale-plus-delta invariant
                out[c] = _uniform(1909, rows, 50, 9900) + _uniform(
                    1908, rows, 0, 5100
                )
            elif c == "cs_sales_price":
                out[c] = _uniform(1909, rows, 50, 9900)
            elif c == "cs_coupon_amt":
                out[c] = _sparse_amount(1910, 1911, rows)
            elif c == "cs_ext_list_price":
                out[c] = _uniform(1905, rows, 10000, 100000)
            elif c == "cs_ext_sales_price":
                out[c] = _uniform(1916, rows, 100, 30000)
            elif c == "cs_bill_hdemo_sk":
                out[c] = _uniform(
                    1920, rows, 1, cn["household_demographics"]
                )
            elif c == "cs_net_profit":
                out[c] = _uniform(1917, rows, -5000, 20000)
            elif c == "cs_catalog_page_sk":
                out[c] = _uniform(
                    1918, rows, 1, cn["catalog_page"]
                )
            elif c == "cs_ext_discount_amt":
                out[c] = _uniform(1921, rows, 0, 100000)
            elif c == "cs_wholesale_cost":
                out[c] = _uniform(1929, rows, 100, 10000)
            elif c == "cs_ext_ship_cost":
                out[c] = _uniform(1922, rows, 100, 10000)
            elif c == "cs_ext_wholesale_cost":
                out[c] = _uniform(1923, rows, 100, 1000000)
            elif c == "cs_net_paid":
                out[c] = _uniform(1924, rows, 100, 300000)
            elif c == "cs_ship_addr_sk":
                out[c] = _uniform(
                    1925, rows, 1, cn["customer_address"]
                )
            elif c == "cs_bill_addr_sk":
                # order-keyed like the bill customer: one address per
                # order (q33/q56/q60 group channel revenue by it)
                out[c] = _uniform(
                    1926, f["order"], 1, cn["customer_address"]
                )
            elif c == "cs_ship_customer_sk":
                out[c] = _uniform(1927, rows, 1, cn["customer"])
            elif c == "cs_sold_time_sk":
                out[c] = _uniform(1928, rows, 0, 86399)
        return out

    def _gen_catalog_returns(self, rows, columns):
        src = rows * 2  # return j <-> catalog_sales row 2j
        f = self._cs_fields(src)
        out = {}
        for c in columns:
            if c == "cr_returned_date_sk":
                out[c] = self._date_sk_for(
                    f["sold"] + _uniform(2001, rows, 1, 90)
                )
            elif c == "cr_item_sk":
                out[c] = f["item"]
            elif c == "cr_order_number":
                out[c] = f["order"]
            elif c == "cr_refunded_cash":
                # bounded well below cs_ext_list_price so Q64's cs_ui
                # HAVING (sale > 2*refund) keeps a healthy item fraction
                out[c] = _uniform(2002, rows, 0, 15000)
            elif c == "cr_reversed_charge":
                out[c] = _uniform(2003, rows, 0, 5000)
            elif c == "cr_store_credit":
                out[c] = _uniform(2004, rows, 0, 5000)
            elif c == "cr_return_amount":
                out[c] = _uniform(2005, rows, 100, 10000)
            elif c == "cr_net_loss":
                out[c] = _uniform(2006, rows, 100, 8000)
            elif c == "cr_catalog_page_sk":
                # SAME closed form catalog_sales evaluates at the
                # source row: a return's page is its sale's page
                out[c] = _uniform(
                    1918, src, 1, self.counts["catalog_page"]
                )
            elif c == "cr_return_quantity":
                out[c] = _uniform(2008, rows, 1, 40)
            elif c == "cr_returning_customer_sk":
                # usually the billing customer of the source sale,
                # sometimes a different party (official mix); 1903 is
                # catalog_sales' ORDER-keyed bill-customer closed form
                bill = _uniform(
                    1903, f["order"], 1, self.counts["customer"]
                )
                other = _uniform(
                    2009, rows, 1, self.counts["customer"]
                )
                out[c] = np.where(
                    _uniform(2010, rows, 0, 9) < 8, bill, other
                )
            elif c == "cr_returning_addr_sk":
                out[c] = _uniform(
                    2011, rows, 1, self.counts["customer_address"]
                )
            elif c == "cr_call_center_sk":
                out[c] = _uniform(
                    2012, rows, 1, self.counts["call_center"]
                )
        return out

    def _ws_fields(self, rows):
        cn = self.counts
        order, _line = _order_of_row(rows)
        sold = _uniform(2101, rows, _SOLD_LO, _SOLD_HI)
        return {
            "order": order + 1,
            "item": _uniform(2102, rows, 1, cn["item"]),
            "sold": sold,
        }

    def _gen_web_sales(self, rows, columns):
        cn = self.counts
        f = self._ws_fields(rows)
        out = {}
        for c in columns:
            if c == "ws_sold_date_sk":
                out[c] = self._date_sk_for(f["sold"])
            elif c == "ws_ship_date_sk":
                out[c] = self._date_sk_for(
                    f["sold"] + _uniform(2103, rows, 1, 30)
                )
            elif c == "ws_item_sk":
                out[c] = f["item"]
            elif c == "ws_ship_addr_sk":
                out[c] = _uniform(2104, rows, 1, cn["customer_address"])
            elif c == "ws_web_site_sk":
                out[c] = _uniform(2105, rows, 1, cn["web_site"])
            elif c == "ws_warehouse_sk":
                # 3 warehouses in rotation: multi-line orders usually mix
                # warehouses, so Q95's ws_wh self-join inequality selects
                # a real slice
                out[c] = _uniform(2106, rows, 1, 3)
            elif c == "ws_ship_mode_sk":
                out[c] = _uniform(2109, rows, 1, cn["ship_mode"])
            elif c == "ws_ext_sales_price":
                out[c] = _uniform(2110, rows, 100, 30000)
            elif c == "ws_order_number":
                out[c] = f["order"]
            elif c == "ws_ext_ship_cost":
                out[c] = _uniform(2107, rows, 100, 10000)
            elif c == "ws_net_profit":
                out[c] = _uniform(2108, rows, -5000, 20000)
            elif c == "ws_bill_customer_sk":
                # drawn from the ORDER number, not the row: every line
                # of an order bills the same customer (q38/q87/q97
                # count distinct customers per channel)
                out[c] = _uniform(2111, f["order"], 1, cn["customer"])
            elif c == "ws_bill_addr_sk":
                out[c] = _uniform(
                    2112, f["order"], 1, cn["customer_address"]
                )
            elif c == "ws_web_page_sk":
                out[c] = _uniform(2113, rows, 1, cn["web_page"])
            elif c == "ws_promo_sk":
                out[c] = _uniform(2115, rows, 1, cn["promotion"])
            elif c == "ws_sales_price":
                out[c] = _uniform(2116, rows, 50, 9900)
            elif c == "ws_quantity":
                out[c] = _uniform(2117, rows, 1, 100)
            elif c == "ws_list_price":
                out[c] = _uniform(2118, rows, 100, 15000)
            elif c == "ws_wholesale_cost":
                out[c] = _uniform(2119, rows, 100, 10000)
            elif c == "ws_ext_discount_amt":
                out[c] = _uniform(2120, rows, 0, 100000)
            elif c == "ws_ext_wholesale_cost":
                out[c] = _uniform(2121, rows, 100, 1000000)
            elif c == "ws_ext_list_price":
                out[c] = _uniform(2122, rows, 100, 1500000)
            elif c == "ws_net_paid":
                out[c] = _uniform(2123, rows, 100, 990000)
            elif c == "ws_sold_time_sk":
                out[c] = _uniform(2124, rows, 0, 86399)
            elif c == "ws_ship_hdemo_sk":
                out[c] = _uniform(
                    2125, rows, 1, cn["household_demographics"]
                )
        return out

    def _gen_web_returns(self, rows, columns):
        src = rows * 3  # return j <-> web_sales row 3j
        f = self._ws_fields(src)
        out = {}
        for c in columns:
            if c == "wr_returned_date_sk":
                out[c] = self._date_sk_for(
                    f["sold"] + _uniform(2201, rows, 1, 90)
                )
            elif c == "wr_item_sk":
                out[c] = f["item"]
            elif c == "wr_order_number":
                out[c] = f["order"]
            elif c == "wr_return_amt":
                out[c] = _uniform(2202, rows, 100, 10000)
            elif c == "wr_net_loss":
                out[c] = _uniform(2203, rows, 100, 8000)
            elif c == "wr_web_page_sk":
                # source web_sales row's page (same closed form)
                out[c] = _uniform(
                    2113, src, 1, self.counts["web_page"]
                )
            elif c == "wr_return_quantity":
                out[c] = _uniform(2205, rows, 1, 40)
            elif c == "wr_returning_customer_sk":
                bill = _uniform(
                    2111, f["order"], 1, self.counts["customer"]
                )
                other = _uniform(
                    2206, rows, 1, self.counts["customer"]
                )
                out[c] = np.where(
                    _uniform(2207, rows, 0, 9) < 8, bill, other
                )
            elif c == "wr_returning_addr_sk":
                out[c] = _uniform(
                    2208, rows, 1, self.counts["customer_address"]
                )
            elif c == "wr_refunded_cash":
                out[c] = _uniform(2209, rows, 0, 15000)
            elif c == "wr_reason_sk":
                out[c] = _uniform(
                    2210, rows, 1, self.counts["reason"]
                )
            elif c == "wr_refunded_cdemo_sk":
                out[c] = _uniform(
                    2211, rows, 1, self.counts["customer_demographics"]
                )
            elif c == "wr_refunded_addr_sk":
                out[c] = _uniform(
                    2212, rows, 1, self.counts["customer_address"]
                )
            elif c == "wr_returning_cdemo_sk":
                out[c] = _uniform(
                    2213, rows, 1, self.counts["customer_demographics"]
                )
            elif c == "wr_fee":
                out[c] = _uniform(2214, rows, 50, 10000)
        return out


# -------------------------------------------------------------- connector


#: value-range stats for date-dimension attributes (the calendar is a
#: known domain): lets grouped CTE outputs keyed on d_year pack into
#: composite join keys, and sharpens range selectivities
_DATE_COL_STATS = {
    "d_year": ColumnStats(distinct_count=14, min_value=1990, max_value=2003),
    "d_moy": ColumnStats(distinct_count=12, min_value=1, max_value=12),
    "d_qoy": ColumnStats(distinct_count=4, min_value=1, max_value=4),
    "d_dom": ColumnStats(distinct_count=31, min_value=1, max_value=31),
    "d_dow": ColumnStats(distinct_count=7, min_value=0, max_value=6),
    "d_week_seq": ColumnStats(
        distinct_count=731, min_value=1043, max_value=1774
    ),
    "d_month_seq": ColumnStats(
        distinct_count=168, min_value=1080, max_value=1247
    ),
}


class _TpcdsMetadata(ConnectorMetadata):
    PRIMARY_KEYS = {
        "date_dim": ("d_date_sk",),
        "income_band": ("ib_income_band_sk",),
        "customer_demographics": ("cd_demo_sk",),
        "household_demographics": ("hd_demo_sk",),
        "warehouse": ("w_warehouse_sk",),
        "web_site": ("web_site_sk",),
        "store": ("s_store_sk",),
        "promotion": ("p_promo_sk",),
        "item": ("i_item_sk",),
        "customer": ("c_customer_sk",),
        "customer_address": ("ca_address_sk",),
        "time_dim": ("t_time_sk",),
        "reason": ("r_reason_sk",),
        "ship_mode": ("sm_ship_mode_sk",),
        "call_center": ("cc_call_center_sk",),
        "web_page": ("wp_web_page_sk",),
        "catalog_page": ("cp_catalog_page_sk",),
        # fact tables: NO primary key declared — the closed-form
        # generators draw items independently per line, so (item, order)
        # pairs can repeat; declaring a PK would license build-unique
        # join plans that those duplicates would silently break
    }

    FOREIGN_KEYS = {
        "ss_item_sk": "item", "ss_customer_sk": "customer",
        "ss_cdemo_sk": "customer_demographics",
        "ss_hdemo_sk": "household_demographics",
        "ss_addr_sk": "customer_address", "ss_store_sk": "store",
        "ss_promo_sk": "promotion",
        "sr_item_sk": "item",
        "cs_item_sk": "item", "cs_bill_customer_sk": "customer",
        "cs_bill_cdemo_sk": "customer_demographics",
        "cs_promo_sk": "promotion",
        "cr_item_sk": "item",
        "ws_item_sk": "item", "ws_ship_addr_sk": "customer_address",
        "ws_web_site_sk": "web_site", "ws_warehouse_sk": "warehouse",
        "wr_item_sk": "item",
        "c_current_cdemo_sk": "customer_demographics",
        "c_current_hdemo_sk": "household_demographics",
        "c_current_addr_sk": "customer_address",
        "hd_income_band_sk": "income_band",
        "inv_item_sk": "item",
        "inv_warehouse_sk": "warehouse",
        "ws_ship_mode_sk": "ship_mode",
        "cs_ship_mode_sk": "ship_mode",
        "cs_call_center_sk": "call_center",
        "cs_warehouse_sk": "warehouse",
        # round-5 columns (stats keep the optimizer's NDV formula and
        # output-capacity sizing honest — a stats-less fan-in key
        # otherwise defaults to the no-info path)
        "sr_customer_sk": "customer",
        "sr_store_sk": "store",
        "sr_reason_sk": "reason",
        "sr_cdemo_sk": "customer_demographics",
        "cs_bill_hdemo_sk": "household_demographics",
        "cs_catalog_page_sk": "catalog_page",
        "cs_ship_addr_sk": "customer_address",
        "cs_bill_addr_sk": "customer_address",
        "cs_ship_customer_sk": "customer",
        "cr_catalog_page_sk": "catalog_page",
        "cr_returning_customer_sk": "customer",
        "cr_returning_addr_sk": "customer_address",
        "cr_call_center_sk": "call_center",
        "ws_bill_customer_sk": "customer",
        "ws_bill_addr_sk": "customer_address",
        "ws_web_page_sk": "web_page",
        "ws_promo_sk": "promotion",
        "ws_ship_hdemo_sk": "household_demographics",
        "wr_returning_customer_sk": "customer",
        "wr_returning_addr_sk": "customer_address",
        "wr_web_page_sk": "web_page",
        "wr_reason_sk": "reason",
    }

    #: 0-based time surrogate keys (t_time_sk = 0..86399): packed
    #: separately so min/max stats stay exact for bijective key packing
    TIME_FKS = ("ss_sold_time_sk", "cs_sold_time_sk", "ws_sold_time_sk")

    DATE_FKS = (
        "ss_sold_date_sk", "sr_returned_date_sk", "cs_sold_date_sk",
        "cr_returned_date_sk", "ws_sold_date_sk", "ws_ship_date_sk",
        "wr_returned_date_sk", "c_first_sales_date_sk",
        "c_first_shipto_date_sk", "inv_date_sk", "cs_ship_date_sk",
    )

    def list_schemas(self):
        return list(SCHEMAS)

    def list_tables(self, schema):
        return list(TABLE_SCHEMAS)

    def get_table_schema(self, handle: TableHandle):
        if handle.schema not in SCHEMAS:
            raise KeyError(f"unknown tpcds schema: {handle.schema}")
        if handle.table not in TABLE_SCHEMAS:
            raise KeyError(f"unknown tpcds table: {handle.table}")
        return dict(TABLE_SCHEMAS[handle.table])

    def get_table_stats(self, handle: TableHandle):
        counts = _counts(SCHEMAS[handle.schema])
        n = counts[handle.table]
        pk = self.PRIMARY_KEYS.get(handle.table)
        cols: Dict[str, ColumnStats] = {}
        for name in TABLE_SCHEMAS[handle.table]:
            if pk and len(pk) == 1 and name == pk[0]:
                cols[name] = ColumnStats(
                    distinct_count=n, min_value=1, max_value=n
                )
            elif name in self.DATE_FKS:
                cols[name] = ColumnStats(
                    distinct_count=min(N_DATES, n),
                    min_value=_DATE_SK0,
                    max_value=_DATE_SK0 + N_DATES - 1,
                )
            elif name in self.TIME_FKS:
                cols[name] = ColumnStats(
                    distinct_count=min(86_400, n),
                    min_value=0,
                    max_value=86_399,
                )
            elif handle.table == "date_dim" and name in _DATE_COL_STATS:
                cols[name] = _DATE_COL_STATS[name]
            elif name in self.FOREIGN_KEYS:
                ref = counts[self.FOREIGN_KEYS[name]]
                cols[name] = ColumnStats(
                    distinct_count=min(ref, n), min_value=1, max_value=ref
                )
        return TableStats(row_count=float(n), columns=cols, primary_key=pk)


class TpcdsConnector(Connector):
    """Catalog 'tpcds': schemas tiny/sf1/sf10/sf100, zero stored bytes."""

    def __init__(self, **config):
        self._metadata = _TpcdsMetadata()
        self._gens: Dict[str, TpcdsGenerator] = {}

    def metadata(self):
        return self._metadata

    def _gen(self, schema: str) -> TpcdsGenerator:
        if schema not in self._gens:
            self._gens[schema] = TpcdsGenerator(SCHEMAS[schema])
        return self._gens[schema]

    def get_splits(self, handle: TableHandle, target_split_rows: int = 1 << 20, constraint=()):
        n = self._gen(handle.schema).counts[handle.table]
        splits = [
            ConnectorSplit(handle, lo, min(lo + target_split_rows, n))
            for lo in range(0, n, target_split_rows)
        ] or [ConnectorSplit(handle, 0, 0)]
        return SplitSource(splits)

    def create_page_source(self, split: ConnectorSplit, columns):
        return self._gen(split.table.schema).generate(
            split.table.table, split.row_start, split.row_end, columns
        )
