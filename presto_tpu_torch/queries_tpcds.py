"""TPC-DS query corpus (BASELINE.json configs Q64/Q95 + breadth): the
port's own copy of ``presto_tpu/queries_tpcds.py``, query texts
unchanged, so ``chip_smoke.py`` and ``chip_profile.py`` can take them
without importing the JAX package.

Official query shapes rendered in this engine's dialect (Presto-style
date arithmetic; catalog-qualified tables). Substitution parameters
chosen so each query selects a non-empty slice at every scale factor —
the official templates parameterize exactly these literals.

Module-level ``Q64``/``Q95``/``BREADTH``/``OFFICIAL`` are bound to the
``tiny`` schema; ``queries_for(schema)`` and ``official_for(schema)``
rebind the corpus for larger scale factors.
"""

S = "tpcds.tiny"


def queries_for(schema: str):
    """(q64, q95, breadth) rebound to ``tpcds.<schema>``."""
    target = f"tpcds.{schema}"
    return (
        Q64.replace(S, target),
        Q95.replace(S, target),
        {k: v.replace(S, target) for k, v in BREADTH.items()},
    )


def official_for(schema: str):
    """The OFFICIAL corpus rebound to ``tpcds.<schema>``."""
    target = f"tpcds.{schema}"
    return {k: v.replace(S, target) for k, v in OFFICIAL.items()}

# Q95: ws_wh self-join inequality CTE (the Q21 pattern), two IN
# subqueries, count(distinct), date-window scan
Q95 = f"""
with ws_wh as (
  select ws1.ws_order_number
  from {S}.web_sales ws1, {S}.web_sales ws2
  where ws1.ws_order_number = ws2.ws_order_number
    and ws1.ws_warehouse_sk <> ws2.ws_warehouse_sk)
select count(distinct ws_order_number) as order_count,
       sum(ws_ext_ship_cost) as total_shipping_cost,
       sum(ws_net_profit) as total_net_profit
from {S}.web_sales ws1, {S}.date_dim, {S}.customer_address, {S}.web_site
where d_date between date '1999-02-01'
      and date '1999-02-01' + interval '60' day
  and ws1.ws_ship_date_sk = d_date_sk
  and ws1.ws_ship_addr_sk = ca_address_sk
  and ca_state = 'IL'
  and ws1.ws_web_site_sk = web_site_sk
  and web_company_name = 'pri'
  and ws1.ws_order_number in (select ws_order_number from ws_wh)
  and ws1.ws_order_number in (
    select wr_order_number
    from {S}.web_returns, ws_wh
    where wr_order_number = ws_wh.ws_order_number)
order by order_count
"""

# Q64: the star-join stress — cs_ui HAVING CTE, 17-table cross_sales
# with three date_dim / two demographics / two address instances and a
# string-inequality residual, then a same-CTE self-join across years
Q64 = f"""
with cs_ui as (
  select cs_item_sk,
         sum(cs_ext_list_price) as sale,
         sum(cr_refunded_cash + cr_reversed_charge + cr_store_credit)
           as refund
  from {S}.catalog_sales, {S}.catalog_returns
  where cs_item_sk = cr_item_sk and cs_order_number = cr_order_number
  group by cs_item_sk
  having sum(cs_ext_list_price) >
         2 * sum(cr_refunded_cash + cr_reversed_charge + cr_store_credit)),
cross_sales as (
  select i_product_name as product_name, i_item_sk as item_sk,
         s_store_name as store_name, s_zip as store_zip,
         ad1.ca_street_number as b_street_number,
         ad1.ca_street_name as b_street_name,
         ad1.ca_city as b_city, ad1.ca_zip as b_zip,
         ad2.ca_street_number as c_street_number,
         ad2.ca_street_name as c_street_name,
         ad2.ca_city as c_city, ad2.ca_zip as c_zip,
         d1.d_year as syear, d2.d_year as fsyear, d3.d_year as s2year,
         count(*) as cnt,
         sum(ss_wholesale_cost) as s1, sum(ss_list_price) as s2,
         sum(ss_coupon_amt) as s3
  from {S}.store_sales, {S}.store_returns, cs_ui,
       {S}.date_dim d1, {S}.date_dim d2, {S}.date_dim d3,
       {S}.store, {S}.customer,
       {S}.customer_demographics cd1, {S}.customer_demographics cd2,
       {S}.promotion,
       {S}.household_demographics hd1, {S}.household_demographics hd2,
       {S}.customer_address ad1, {S}.customer_address ad2,
       {S}.income_band ib1, {S}.income_band ib2, {S}.item
  where ss_store_sk = s_store_sk
    and ss_sold_date_sk = d1.d_date_sk
    and ss_customer_sk = c_customer_sk
    and ss_cdemo_sk = cd1.cd_demo_sk
    and ss_hdemo_sk = hd1.hd_demo_sk
    and ss_addr_sk = ad1.ca_address_sk
    and ss_item_sk = i_item_sk
    and ss_item_sk = sr_item_sk
    and ss_ticket_number = sr_ticket_number
    and ss_item_sk = cs_ui.cs_item_sk
    and c_current_cdemo_sk = cd2.cd_demo_sk
    and c_current_hdemo_sk = hd2.hd_demo_sk
    and c_current_addr_sk = ad2.ca_address_sk
    and c_first_sales_date_sk = d2.d_date_sk
    and c_first_shipto_date_sk = d3.d_date_sk
    and ss_promo_sk = p_promo_sk
    and hd1.hd_income_band_sk = ib1.ib_income_band_sk
    and hd2.hd_income_band_sk = ib2.ib_income_band_sk
    and cd1.cd_marital_status <> cd2.cd_marital_status
    and i_color in ('purple', 'burlywood', 'indian', 'spring',
                    'floral', 'medium')
    and i_current_price between 64 and 74
    and i_current_price between 65 and 79
  group by i_product_name, i_item_sk, s_store_name, s_zip,
           ad1.ca_street_number, ad1.ca_street_name, ad1.ca_city,
           ad1.ca_zip, ad2.ca_street_number, ad2.ca_street_name,
           ad2.ca_city, ad2.ca_zip, d1.d_year, d2.d_year, d3.d_year)
select cs1.product_name, cs1.store_name, cs1.store_zip,
       cs1.b_street_number, cs1.b_street_name, cs1.b_city, cs1.b_zip,
       cs1.c_street_number, cs1.c_street_name, cs1.c_city, cs1.c_zip,
       cs1.syear as syear1, cs1.cnt as cnt1,
       cs1.s1 as s11, cs1.s2 as s21, cs1.s3 as s31,
       cs2.s1 as s12, cs2.s2 as s22, cs2.s3 as s32,
       cs2.syear as syear2, cs2.cnt as cnt2
from cross_sales cs1, cross_sales cs2
where cs1.item_sk = cs2.item_sk
  and cs1.syear = 1999
  and cs2.syear = 2000
  and cs2.cnt <= cs1.cnt
  and cs1.store_name = cs2.store_name
  and cs1.store_zip = cs2.store_zip
order by cs1.product_name, cs1.store_name, cnt2,
         cs1.b_street_number, cs1.b_street_name, cs1.b_city, cs1.b_zip,
         cs1.c_street_number, cs1.c_street_name, cs1.c_city, cs1.c_zip,
         s11, s12
"""
# (ORDER BY extended beyond the official product_name/store_name/cnt
# triple: those keys leave ties, so engine-vs-oracle row order within a
# tie is unspecified and the ordered diff would flag spurious mismatches)

#: smaller star-join / breadth corpus exercising each tpcds table
BREADTH = {
    "dim_scan": f"""
        select d_year, count(*) as days
        from {S}.date_dim group by d_year order by d_year""",
    "ss_star": f"""
        select s_store_name, d_year,
               sum(ss_list_price) as revenue, count(*) as n
        from {S}.store_sales, {S}.date_dim, {S}.store
        where ss_sold_date_sk = d_date_sk and ss_store_sk = s_store_sk
          and d_year = 1999
        group by s_store_name, d_year
        order by s_store_name""",
    "returns_ratio": f"""
        select i_category,
               sum(sr_return_amt) as returned,
               count(*) as n_returns
        from {S}.store_returns, {S}.store_sales, {S}.item
        where sr_item_sk = ss_item_sk
          and sr_ticket_number = ss_ticket_number
          and ss_item_sk = i_item_sk
        group by i_category
        order by returned desc""",
    "demo_bands": f"""
        select ib_lower_bound, ib_upper_bound, count(*) as households
        from {S}.household_demographics, {S}.income_band
        where hd_income_band_sk = ib_income_band_sk
        group by ib_lower_bound, ib_upper_bound
        order by ib_lower_bound""",
    "web_profit": f"""
        select web_company_name, sum(ws_net_profit) as profit
        from {S}.web_sales, {S}.web_site
        where ws_web_site_sk = web_site_sk
        group by web_company_name
        order by profit desc""",
    "cs_topn": f"""
        select cs_item_sk, sum(cs_ext_list_price) as sale
        from {S}.catalog_sales
        group by cs_item_sk
        order by sale desc
        limit 10""",
}

#: official TPC-DS query templates beyond the two BASELINE configs,
#: rendered in this engine's dialect with substitution parameters chosen
#: (by probing the deterministic generator) so every query selects a
#: non-empty slice at tiny scale and above
OFFICIAL = {
    # Q3: brand revenue by year for one manufacturer in November
    "q3": f"""
        select d_year, i_brand_id as brand_id, i_brand as brand,
               sum(ss_ext_sales_price) as sum_agg
        from {S}.date_dim, {S}.store_sales, {S}.item
        where d_date_sk = ss_sold_date_sk
          and ss_item_sk = i_item_sk
          and i_manufact_id = 156
          and d_moy = 11
        group by d_year, i_brand_id, i_brand
        order by d_year, sum_agg desc, brand_id
        limit 100""",
    # Q7: average item economics for a demographic + promo channel slice
    "q7": f"""
        select i_item_id,
               avg(ss_quantity) as agg1,
               avg(ss_list_price) as agg2,
               avg(ss_coupon_amt) as agg3,
               avg(ss_sales_price) as agg4
        from {S}.store_sales, {S}.customer_demographics, {S}.date_dim,
             {S}.item, {S}.promotion
        where ss_sold_date_sk = d_date_sk
          and ss_item_sk = i_item_sk
          and ss_cdemo_sk = cd_demo_sk
          and ss_promo_sk = p_promo_sk
          and cd_gender = 'M'
          and cd_marital_status = 'S'
          and cd_education_status = 'College'
          and (p_channel_email = 'N' or p_channel_event = 'N')
          and d_year = 1999
        group by i_item_id
        order by i_item_id
        limit 100""",
    # Q19: brand revenue where the customer's zip differs from the
    # store's zip (the cross-shopping filter)
    "q19": f"""
        select i_brand_id as brand_id, i_brand as brand,
               i_manufact_id as man_id, i_manufact as man,
               sum(ss_ext_sales_price) as ext_price
        from {S}.date_dim, {S}.store_sales, {S}.item, {S}.customer,
             {S}.customer_address, {S}.store
        where d_date_sk = ss_sold_date_sk
          and ss_item_sk = i_item_sk
          and i_manager_id = 64
          and d_moy = 11
          and d_year = 1999
          and ss_customer_sk = c_customer_sk
          and c_current_addr_sk = ca_address_sk
          and substring(ca_zip, 1, 5) <> substring(s_zip, 1, 5)
          and ss_store_sk = s_store_sk
        group by i_brand_id, i_brand, i_manufact_id, i_manufact
        order by ext_price desc, brand_id, man_id
        limit 100""",
    # Q42: category revenue for one month
    "q42": f"""
        select d_year, i_category_id, i_category,
               sum(ss_ext_sales_price) as revenue
        from {S}.date_dim, {S}.store_sales, {S}.item
        where d_date_sk = ss_sold_date_sk
          and ss_item_sk = i_item_sk
          and d_moy = 11
          and d_year = 1999
        group by d_year, i_category_id, i_category
        order by revenue desc, d_year, i_category_id, i_category
        limit 100""",
    # Q52: brand revenue for one month
    "q52": f"""
        select d_year, i_brand_id as brand_id, i_brand as brand,
               sum(ss_ext_sales_price) as ext_price
        from {S}.date_dim, {S}.store_sales, {S}.item
        where d_date_sk = ss_sold_date_sk
          and ss_item_sk = i_item_sk
          and d_moy = 11
          and d_year = 1999
        group by d_year, i_brand_id, i_brand
        order by d_year, ext_price desc, brand_id
        limit 100""",
    # Q55: brand revenue for one manager's items
    "q55": f"""
        select i_brand_id as brand_id, i_brand as brand,
               sum(ss_ext_sales_price) as ext_price
        from {S}.date_dim, {S}.store_sales, {S}.item
        where d_date_sk = ss_sold_date_sk
          and ss_item_sk = i_item_sk
          and i_manager_id = 64
          and d_moy = 11
          and d_year = 1999
        group by i_brand_id, i_brand
        order by ext_price desc, brand_id
        limit 100""",
    # Q68: per-ticket shopping carts where the bought-in city differs
    # from the customer's current city (subquery-in-FROM + two address
    # instances)
    "q68": f"""
        select c_last_name, c_first_name, ca_city, bought_city,
               ss_ticket_number, extended_price, extended_tax,
               list_price
        from (select ss_ticket_number, ss_customer_sk,
                     ca_city as bought_city,
                     sum(ss_ext_sales_price) as extended_price,
                     sum(ss_ext_list_price) as list_price,
                     sum(ss_ext_tax) as extended_tax
              from {S}.store_sales, {S}.date_dim, {S}.store,
                   {S}.household_demographics, {S}.customer_address
              where ss_sold_date_sk = d_date_sk
                and ss_store_sk = s_store_sk
                and ss_hdemo_sk = hd_demo_sk
                and ss_addr_sk = ca_address_sk
                and d_dom between 1 and 2
                and (hd_dep_count = 4 or hd_vehicle_count = 3)
                and d_year in (1998, 1999, 2000)
                and s_city in ('Antioch', 'Bridgeport')
              group by ss_ticket_number, ss_customer_sk, ss_addr_sk,
                       ca_city) dn,
             {S}.customer, {S}.customer_address current_addr
        where ss_customer_sk = c_customer_sk
          and c_current_addr_sk = current_addr.ca_address_sk
          and current_addr.ca_city <> bought_city
        order by c_last_name, ss_ticket_number,
                 c_first_name, ca_city, bought_city, extended_price,
                 extended_tax, list_price
        limit 100""",
    # Q43: per-store weekday sales pivot (sum(case ...) columns)
    "q43": f"""
        select s_store_name, s_store_id,
               sum(case when d_day_name = 'Sunday'
                   then ss_sales_price else null end) as sun_sales,
               sum(case when d_day_name = 'Monday'
                   then ss_sales_price else null end) as mon_sales,
               sum(case when d_day_name = 'Tuesday'
                   then ss_sales_price else null end) as tue_sales,
               sum(case when d_day_name = 'Wednesday'
                   then ss_sales_price else null end) as wed_sales,
               sum(case when d_day_name = 'Thursday'
                   then ss_sales_price else null end) as thu_sales,
               sum(case when d_day_name = 'Friday'
                   then ss_sales_price else null end) as fri_sales,
               sum(case when d_day_name = 'Saturday'
                   then ss_sales_price else null end) as sat_sales
        from {S}.date_dim, {S}.store_sales, {S}.store
        where d_date_sk = ss_sold_date_sk and s_store_sk = ss_store_sk
          and d_year = 1999
        group by s_store_name, s_store_id
        order by s_store_name, s_store_id, sun_sales, mon_sales,
                 tue_sales, wed_sales, thu_sales, fri_sales, sat_sales
        limit 100""",
    # Q26: catalog-channel demographic averages (Q7's catalog twin)
    "q26": f"""
        select i_item_id,
               avg(cs_quantity) as agg1,
               avg(cs_list_price) as agg2,
               avg(cs_coupon_amt) as agg3,
               avg(cs_sales_price) as agg4
        from {S}.catalog_sales, {S}.customer_demographics, {S}.date_dim,
             {S}.item, {S}.promotion
        where cs_sold_date_sk = d_date_sk
          and cs_item_sk = i_item_sk
          and cs_bill_cdemo_sk = cd_demo_sk
          and cs_promo_sk = p_promo_sk
          and cd_gender = 'F'
          and cd_marital_status = 'W'
          and cd_education_status = 'Primary'
          and (p_channel_email = 'N' or p_channel_event = 'N')
          and d_year = 1999
        group by i_item_id
        order by i_item_id
        limit 100""",
    # Q98: per-item revenue share of its class — a window aggregate
    # OVER the grouped output (sum(sum(x)) over (partition by i_class))
    "q98": f"""
        select i_item_id, i_item_desc, i_category, i_class,
               i_current_price,
               sum(ss_ext_sales_price) as itemrevenue,
               sum(ss_ext_sales_price) * 100 /
                 sum(sum(ss_ext_sales_price))
                   over (partition by i_class) as revenueratio
        from {S}.store_sales, {S}.item, {S}.date_dim
        where ss_item_sk = i_item_sk
          and i_category in ('Sports', 'Books', 'Home')
          and ss_sold_date_sk = d_date_sk
          and d_date between date '1999-02-22'
              and date '1999-02-22' + interval '30' day
        group by i_item_id, i_item_desc, i_category, i_class,
                 i_current_price
        order by i_category, i_class, i_item_id, i_item_desc,
                 revenueratio""",
    # Q79: per-ticket coupon/profit for Monday shoppers at mid-size
    # stores
    "q79": f"""
        select c_last_name, c_first_name,
               substring(s_city, 1, 30) as city_part, ss_ticket_number,
               amt, profit
        from (select ss_ticket_number, ss_customer_sk, s_city,
                     sum(ss_coupon_amt) as amt,
                     sum(ss_net_profit) as profit
              from {S}.store_sales, {S}.date_dim, {S}.store,
                   {S}.household_demographics
              where ss_sold_date_sk = d_date_sk
                and ss_store_sk = s_store_sk
                and ss_hdemo_sk = hd_demo_sk
                and (hd_dep_count = 6 or hd_vehicle_count > 2)
                and d_dow = 1
                and d_year in (1998, 1999, 2000)
                and s_number_employees between 200 and 295
              group by ss_ticket_number, ss_customer_sk, ss_addr_sk,
                       s_city) ms,
             {S}.customer
        where ss_customer_sk = c_customer_sk
        order by c_last_name, c_first_name, city_part, profit,
                 ss_ticket_number, amt
        limit 100""",
    # Q62: web shipping latency buckets by warehouse/ship-mode/site
    # (official parameterizes d_month_seq; this dialect has d_year)
    "q62": f"""
        select substring(w_warehouse_name, 1, 20) as wname, sm_type,
               web_name,
               sum(case when ws_ship_date_sk - ws_sold_date_sk <= 30
                        then 1 else 0 end) as d30,
               sum(case when ws_ship_date_sk - ws_sold_date_sk > 30
                         and ws_ship_date_sk - ws_sold_date_sk <= 60
                        then 1 else 0 end) as d60,
               sum(case when ws_ship_date_sk - ws_sold_date_sk > 60
                        then 1 else 0 end) as dmore
        from {S}.web_sales, {S}.warehouse, {S}.ship_mode,
             {S}.web_site, {S}.date_dim
        where ws_ship_date_sk = d_date_sk
          and ws_warehouse_sk = w_warehouse_sk
          and ws_ship_mode_sk = sm_ship_mode_sk
          and ws_web_site_sk = web_site_sk
          and d_year = 1999
        group by substring(w_warehouse_name, 1, 20), sm_type, web_name
        order by wname, sm_type, web_name
        limit 100""",
    # Q99: catalog shipping latency buckets by call center/ship mode
    "q99": f"""
        select substring(w_warehouse_name, 1, 20) as wname, sm_type,
               cc_name,
               sum(case when cs_ship_date_sk - cs_sold_date_sk <= 30
                        then 1 else 0 end) as d30,
               sum(case when cs_ship_date_sk - cs_sold_date_sk > 30
                         and cs_ship_date_sk - cs_sold_date_sk <= 60
                        then 1 else 0 end) as d60,
               sum(case when cs_ship_date_sk - cs_sold_date_sk > 60
                         and cs_ship_date_sk - cs_sold_date_sk <= 90
                        then 1 else 0 end) as d90,
               sum(case when cs_ship_date_sk - cs_sold_date_sk > 90
                        then 1 else 0 end) as dmore
        from {S}.catalog_sales, {S}.warehouse, {S}.ship_mode,
             {S}.call_center, {S}.date_dim
        where cs_ship_date_sk = d_date_sk
          and cs_warehouse_sk = w_warehouse_sk
          and cs_ship_mode_sk = sm_ship_mode_sk
          and cs_call_center_sk = cc_call_center_sk
          and d_year = 1999
        group by substring(w_warehouse_name, 1, 20), sm_type, cc_name
        order by wname, sm_type, cc_name
        limit 100""",
    # Q12: Q98's web-channel twin — revenue ratio within class
    "q12": f"""
        select i_item_id, i_item_desc, i_category, i_class,
               i_current_price,
               sum(ws_ext_sales_price) as itemrevenue,
               sum(ws_ext_sales_price) * 100 /
                 sum(sum(ws_ext_sales_price))
                   over (partition by i_class) as revenueratio
        from {S}.web_sales, {S}.item, {S}.date_dim
        where ws_item_sk = i_item_sk
          and i_category in ('Sports', 'Books', 'Home')
          and ws_sold_date_sk = d_date_sk
          and d_date between date '1999-02-22'
              and date '1999-02-22' + interval '30' day
        group by i_item_id, i_item_desc, i_category, i_class,
                 i_current_price
        order by i_category, i_class, i_item_id, i_item_desc,
                 revenueratio
        limit 100""",
    # Q20: Q98's catalog-channel twin
    "q20": f"""
        select i_item_id, i_item_desc, i_category, i_class,
               i_current_price,
               sum(cs_ext_sales_price) as itemrevenue,
               sum(cs_ext_sales_price) * 100 /
                 sum(sum(cs_ext_sales_price))
                   over (partition by i_class) as revenueratio
        from {S}.catalog_sales, {S}.item, {S}.date_dim
        where cs_item_sk = i_item_sk
          and i_category in ('Sports', 'Books', 'Home')
          and cs_sold_date_sk = d_date_sk
          and d_date between date '1999-02-22'
              and date '1999-02-22' + interval '30' day
        group by i_item_id, i_item_desc, i_category, i_class,
                 i_current_price
        order by i_category, i_class, i_item_id, i_item_desc,
                 revenueratio
        limit 100""",
    # Q37: Q82's catalog-channel twin — inventory band + catalog sales
    "q37": f"""
        select i_item_id, i_item_desc, i_current_price
        from {S}.item, {S}.inventory, {S}.date_dim, {S}.catalog_sales
        where i_current_price between 10 and 80
          and inv_item_sk = i_item_sk
          and d_date_sk = inv_date_sk
          and d_date between date '1999-01-01'
                         and date '1999-01-01' + interval '60' day
          and cs_item_sk = i_item_sk
          and inv_quantity_on_hand between 50 and 700
        group by i_item_id, i_item_desc, i_current_price
        order by i_item_id
        limit 100""",
    # Q82: items in an inventory quantity band that also sold in store
    "q82": f"""
        select i_item_id, i_item_desc, i_current_price
        from {S}.item, {S}.inventory, {S}.date_dim, {S}.store_sales
        where i_current_price between 30 and 60
          and inv_item_sk = i_item_sk
          and d_date_sk = inv_date_sk
          and d_date between date '1998-03-01'
                         and date '1998-03-01' + interval '60' day
          and ss_item_sk = i_item_sk
          and inv_quantity_on_hand between 100 and 500
        group by i_item_id, i_item_desc, i_current_price
        order by i_item_id
        limit 100""",
    # Q15: catalog revenue by customer zip for one quarter (zip-prefix
    # OR state OR big-ticket filter)
    "q15": f"""
        select ca_zip, sum(cs_sales_price) as sum_sales
        from {S}.catalog_sales, {S}.customer, {S}.customer_address,
             {S}.date_dim
        where cs_bill_customer_sk = c_customer_sk
          and c_current_addr_sk = ca_address_sk
          and (substring(ca_zip, 1, 5) in
                 ('85669','86197','88274','83405','86475',
                  '85392','85460','80348','81792')
               or ca_state in ('CA','WA','GA')
               or cs_sales_price > 500)
          and cs_sold_date_sk = d_date_sk
          and d_qoy = 2 and d_year = 1999
        group by ca_zip
        order by ca_zip
        limit 100""",
    # Q21: warehouse inventory ratio before/after a pivot date for a
    # price band of items
    "q21": f"""
        select w_warehouse_name, i_item_id,
               sum(case when d_date < date '1999-06-01'
                        then inv_quantity_on_hand else 0 end)
                 as inv_before,
               sum(case when d_date >= date '1999-06-01'
                        then inv_quantity_on_hand else 0 end)
                 as inv_after
        from {S}.inventory, {S}.warehouse, {S}.item, {S}.date_dim
        where i_current_price between 50 and 60
          and i_item_sk = inv_item_sk
          and inv_warehouse_sk = w_warehouse_sk
          and inv_date_sk = d_date_sk
          and d_date between date '1999-06-01' - interval '30' day
                         and date '1999-06-01' + interval '30' day
        group by w_warehouse_name, i_item_id
        having case when sum(case when d_date < date '1999-06-01'
                                  then inv_quantity_on_hand else 0 end)
                         > 0
                    then cast(sum(case when d_date >= date '1999-06-01'
                                       then inv_quantity_on_hand
                                       else 0 end) as double)
                         / cast(sum(case when d_date < date '1999-06-01'
                                         then inv_quantity_on_hand
                                         else 0 end) as double)
                    else null end between 0.666667 and 1.5
        order by w_warehouse_name, i_item_id
        limit 100""",
    # Q40: catalog sales net of returns by warehouse state, before and
    # after a pivot date (left join to returns on order+item)
    "q40": f"""
        select w_state, i_item_id,
               sum(case when d_date < date '1999-06-01'
                        then cs_sales_price
                             - coalesce(cr_refunded_cash, 0)
                        else 0 end) as sales_before,
               sum(case when d_date >= date '1999-06-01'
                        then cs_sales_price
                             - coalesce(cr_refunded_cash, 0)
                        else 0 end) as sales_after
        from {S}.catalog_sales
             left outer join {S}.catalog_returns
               on (cs_order_number = cr_order_number
                   and cs_item_sk = cr_item_sk),
             {S}.warehouse, {S}.item, {S}.date_dim
        where i_current_price between 55 and 60
          and i_item_sk = cs_item_sk
          and cs_warehouse_sk = w_warehouse_sk
          and cs_sold_date_sk = d_date_sk
          and d_date between date '1999-06-01' - interval '30' day
                         and date '1999-06-01' + interval '30' day
        group by w_state, i_item_id
        order by w_state, i_item_id
        limit 100""",
    # Q46: weekend sales tickets by demographic slice where the bought
    # city differs from the customer's current city
    "q46": f"""
        select c_last_name, c_first_name, ca_city, bought_city,
               ss_ticket_number, amt, profit
        from (select ss_ticket_number, ss_customer_sk,
                     ca_city as bought_city,
                     sum(ss_coupon_amt) as amt,
                     sum(ss_net_profit) as profit
              from {S}.store_sales, {S}.date_dim, {S}.store,
                   {S}.household_demographics, {S}.customer_address
              where ss_sold_date_sk = d_date_sk
                and ss_store_sk = s_store_sk
                and ss_hdemo_sk = hd_demo_sk
                and ss_addr_sk = ca_address_sk
                and (household_demographics.hd_dep_count = 5
                     or household_demographics.hd_vehicle_count = 3)
                and d_dow in (6, 0)
                and d_year in (1999, 2000, 2001)
                and s_city in ('Antioch', 'Bridgeport')
              group by ss_ticket_number, ss_customer_sk, ss_addr_sk,
                       ca_city) dn,
             {S}.customer, {S}.customer_address current_addr
        where ss_customer_sk = c_customer_sk
          and customer.c_current_addr_sk = current_addr.ca_address_sk
          and current_addr.ca_city <> bought_city
        order by c_last_name, c_first_name, ca_city, bought_city,
                 ss_ticket_number
        limit 100""",
    # Q48: quantity sold under OR'd demographic x price and
    # address x profit bands (the join equalities factored out of the
    # OR groups — distributively identical to the official template)
    "q48": f"""
        select sum(ss_quantity) as total_quantity
        from {S}.store_sales, {S}.store, {S}.customer_demographics,
             {S}.customer_address, {S}.date_dim
        where s_store_sk = ss_store_sk
          and ss_sold_date_sk = d_date_sk and d_year = 1999
          and cd_demo_sk = ss_cdemo_sk
          and ((cd_marital_status = 'M'
                and cd_education_status = '4 yr Degree'
                and ss_sales_price between 100.00 and 150.00)
            or (cd_marital_status = 'D'
                and cd_education_status = '2 yr Degree'
                and ss_sales_price between 50.00 and 100.00)
            or (cd_marital_status = 'S'
                and cd_education_status = 'College'
                and ss_sales_price between 150.00 and 200.00))
          and ss_addr_sk = ca_address_sk
          and ((ca_state in ('CO', 'OH', 'TX')
                and ss_net_profit between 0 and 2000)
            or (ca_state in ('OR', 'MN', 'KY')
                and ss_net_profit between 150 and 3000)
            or (ca_state in ('VA', 'CA', 'MS')
                and ss_net_profit between 50 and 25000))""",
    # Q63: manager monthly sales vs their yearly monthly average
    # (window aggregate over a grouped aggregate)
    "q63": f"""
        select *
        from (select i_manager_id,
                     sum(ss_sales_price) as sum_sales,
                     avg(sum(ss_sales_price))
                       over (partition by i_manager_id)
                       as avg_monthly_sales
              from {S}.item, {S}.store_sales, {S}.date_dim, {S}.store
              where ss_item_sk = i_item_sk
                and ss_sold_date_sk = d_date_sk
                and ss_store_sk = s_store_sk
                and d_year = 1999
                and ((i_category in ('Books', 'Children', 'Electronics')
                      and i_class in ('personal', 'portable',
                                      'reference', 'self-help'))
                  or (i_category in ('Women', 'Music', 'Men')
                      and i_class in ('accessories', 'classical',
                                      'fragrances', 'pants')))
              group by i_manager_id, d_moy) tmp1
        where case when avg_monthly_sales > 0
                   then abs(sum_sales - avg_monthly_sales)
                        / avg_monthly_sales
                   else null end > 0.1
        order by i_manager_id, avg_monthly_sales, sum_sales
        limit 100""",
    # Q1: customers returning over 1.2x their store's average return
    # (CTE referenced twice + equality-correlated scalar subquery)
    "q1": f"""
        with customer_total_return as (
          select sr_customer_sk as ctr_customer_sk,
                 sr_store_sk as ctr_store_sk,
                 sum(sr_return_amt) as ctr_total_return
          from {S}.store_returns, {S}.date_dim
          where sr_returned_date_sk = d_date_sk and d_year = 1999
          group by sr_customer_sk, sr_store_sk)
        select c_customer_id
        from customer_total_return ctr1, {S}.store, {S}.customer
        where ctr1.ctr_total_return >
                (select avg(ctr_total_return) * 1.2
                 from customer_total_return ctr2
                 where ctr1.ctr_store_sk = ctr2.ctr_store_sk)
          and s_store_sk = ctr1.ctr_store_sk
          and s_state = 'CA'
          and ctr1.ctr_customer_sk = c_customer_sk
        order by c_customer_id
        limit 100""",
    # Q6: states whose customers bought items priced 20% over their
    # category average, for one month (two scalar subqueries)
    "q6": f"""
        select a.ca_state as state, count(*) as cnt
        from {S}.customer_address a, {S}.customer c,
             {S}.store_sales s, {S}.date_dim d, {S}.item i
        where a.ca_address_sk = c.c_current_addr_sk
          and c.c_customer_sk = s.ss_customer_sk
          and s.ss_sold_date_sk = d.d_date_sk
          and s.ss_item_sk = i.i_item_sk
          and d.d_month_seq =
                (select distinct d_month_seq from {S}.date_dim
                 where d_year = 2000 and d_moy = 8)
          and i.i_current_price >
                1.2 * (select avg(j.i_current_price) from {S}.item j
                       where j.i_category = i.i_category)
        group by a.ca_state
        having count(*) >= 10
        order by cnt, a.ca_state
        limit 100""",
    # Q31: counties where web sales grew faster than store sales across
    # two consecutive quarters (six self-joined CTE instances)
    "q31": f"""
        with ss as (
          select ca_county, d_qoy, d_year,
                 sum(ss_ext_sales_price) as store_sales
          from {S}.store_sales, {S}.date_dim, {S}.customer_address
          where ss_sold_date_sk = d_date_sk
            and ss_addr_sk = ca_address_sk
          group by ca_county, d_qoy, d_year),
        ws as (
          select ca_county, d_qoy, d_year,
                 sum(ws_ext_sales_price) as web_sales
          from {S}.web_sales, {S}.date_dim, {S}.customer_address
          where ws_sold_date_sk = d_date_sk
            and ws_bill_addr_sk = ca_address_sk
          group by ca_county, d_qoy, d_year)
        select ss1.ca_county, ss1.d_year,
               ws2.web_sales / ws1.web_sales as web_q1_q2_increase,
               ss2.store_sales / ss1.store_sales as store_q1_q2_increase,
               ws3.web_sales / ws2.web_sales as web_q2_q3_increase,
               ss3.store_sales / ss2.store_sales as store_q2_q3_increase
        from ss ss1, ss ss2, ss ss3, ws ws1, ws ws2, ws ws3
        where ss1.d_qoy = 1 and ss1.d_year = 1999
          and ss1.ca_county = ss2.ca_county
          and ss2.d_qoy = 2 and ss2.d_year = 1999
          and ss2.ca_county = ss3.ca_county
          and ss3.d_qoy = 3 and ss3.d_year = 1999
          and ss1.ca_county = ws1.ca_county
          and ws1.d_qoy = 1 and ws1.d_year = 1999
          and ws1.ca_county = ws2.ca_county
          and ws2.d_qoy = 2 and ws2.d_year = 1999
          and ws1.ca_county = ws3.ca_county
          and ws3.d_qoy = 3 and ws3.d_year = 1999
          and case when ws1.web_sales > 0
                   then ws2.web_sales / ws1.web_sales
                   else null end
            > case when ss1.store_sales > 0
                   then ss2.store_sales / ss1.store_sales
                   else null end
          and case when ws2.web_sales > 0
                   then ws3.web_sales / ws2.web_sales
                   else null end
            > case when ss2.store_sales > 0
                   then ss3.store_sales / ss2.store_sales
                   else null end
        order by ss1.ca_county""",
    # Q38: customers active in ALL THREE channels for one year
    # (INTERSECT chain under a count)
    "q38": f"""
        select count(*) as cnt from (
          (select distinct c_last_name, c_first_name, d_date
           from {S}.store_sales, {S}.date_dim, {S}.customer
           where ss_sold_date_sk = d_date_sk
             and ss_customer_sk = c_customer_sk
             and d_month_seq between 1188 and 1199)
          intersect
          (select distinct c_last_name, c_first_name, d_date
           from {S}.catalog_sales, {S}.date_dim, {S}.customer
           where cs_sold_date_sk = d_date_sk
             and cs_bill_customer_sk = c_customer_sk
             and d_month_seq between 1188 and 1199)
          intersect
          (select distinct c_last_name, c_first_name, d_date
           from {S}.web_sales, {S}.date_dim, {S}.customer
           where ws_sold_date_sk = d_date_sk
             and ws_bill_customer_sk = c_customer_sk
             and d_month_seq between 1188 and 1199)
        ) hot_cust
        limit 100""",
    # Q47 (v1): store-brand months deviating >10% from the yearly
    # average, with the neighbouring months via rank self-joins
    "q47": f"""
        with v1 as (
          select i_category, i_brand, s_store_name, s_company_name,
                 d_year, d_moy,
                 sum(ss_sales_price) as sum_sales,
                 avg(sum(ss_sales_price)) over (
                   partition by i_category, i_brand, s_store_name,
                                s_company_name, d_year)
                   as avg_monthly_sales,
                 rank() over (
                   partition by i_category, i_brand, s_store_name,
                                s_company_name
                   order by d_year, d_moy) as rn
          from {S}.item, {S}.store_sales, {S}.date_dim, {S}.store
          where ss_item_sk = i_item_sk
            and ss_sold_date_sk = d_date_sk
            and ss_store_sk = s_store_sk
            and (d_year = 1999
                 or (d_year = 1998 and d_moy = 12)
                 or (d_year = 2000 and d_moy = 1))
          group by i_category, i_brand, s_store_name, s_company_name,
                   d_year, d_moy),
        v2 as (
          select v1.i_category, v1.i_brand, v1.s_store_name,
                 v1.s_company_name, v1.d_year, v1.d_moy,
                 v1.avg_monthly_sales, v1.sum_sales,
                 v1_lag.sum_sales as psum,
                 v1_lead.sum_sales as nsum
          from v1, v1 v1_lag, v1 v1_lead
          where v1.i_category = v1_lag.i_category
            and v1.i_brand = v1_lag.i_brand
            and v1.s_store_name = v1_lag.s_store_name
            and v1.s_company_name = v1_lag.s_company_name
            and v1.i_category = v1_lead.i_category
            and v1.i_brand = v1_lead.i_brand
            and v1.s_store_name = v1_lead.s_store_name
            and v1.s_company_name = v1_lead.s_company_name
            and v1.rn = v1_lag.rn + 1
            and v1.rn = v1_lead.rn - 1)
        select *
        from v2
        where d_year = 1999
          and avg_monthly_sales > 0
          and case when avg_monthly_sales > 0
                   then abs(sum_sales - avg_monthly_sales)
                        / avg_monthly_sales
                   else null end > 0.1
        order by sum_sales - avg_monthly_sales, 3
        limit 100""",
    # Q57: the catalog-channel sibling of Q47 (call centers for stores)
    "q57": f"""
        with v1 as (
          select i_category, i_brand, cc_name, d_year, d_moy,
                 sum(cs_sales_price) as sum_sales,
                 avg(sum(cs_sales_price)) over (
                   partition by i_category, i_brand, cc_name, d_year)
                   as avg_monthly_sales,
                 rank() over (
                   partition by i_category, i_brand, cc_name
                   order by d_year, d_moy) as rn
          from {S}.item, {S}.catalog_sales, {S}.date_dim,
               {S}.call_center
          where cs_item_sk = i_item_sk
            and cs_sold_date_sk = d_date_sk
            and cc_call_center_sk = cs_call_center_sk
            and (d_year = 1999
                 or (d_year = 1998 and d_moy = 12)
                 or (d_year = 2000 and d_moy = 1))
          group by i_category, i_brand, cc_name, d_year, d_moy),
        v2 as (
          select v1.i_category, v1.i_brand, v1.cc_name, v1.d_year,
                 v1.d_moy, v1.avg_monthly_sales, v1.sum_sales,
                 v1_lag.sum_sales as psum,
                 v1_lead.sum_sales as nsum
          from v1, v1 v1_lag, v1 v1_lead
          where v1.i_category = v1_lag.i_category
            and v1.i_brand = v1_lag.i_brand
            and v1.cc_name = v1_lag.cc_name
            and v1.i_category = v1_lead.i_category
            and v1.i_brand = v1_lead.i_brand
            and v1.cc_name = v1_lead.cc_name
            and v1.rn = v1_lag.rn + 1
            and v1.rn = v1_lead.rn - 1)
        select *
        from v2
        where d_year = 1999
          and avg_monthly_sales > 0
          and case when avg_monthly_sales > 0
                   then abs(sum_sales - avg_monthly_sales)
                        / avg_monthly_sales
                   else null end > 0.1
        order by sum_sales - avg_monthly_sales, 3
        limit 100""",
    # Q65: items selling at or below a tenth of their store's average
    # item revenue. Parameter deviation: a 2-month window instead of
    # the official 12 — the closed-form generator draws item
    # popularity uniformly (no official Pareto skew), so over 12
    # months no item sits 10x below its store's average; the 2-month
    # window reintroduces the cold items the template is after
    "q65": f"""
        select s_store_name, i_item_desc, sc.revenue,
               i_current_price, i_wholesale_cost, i_brand
        from {S}.store, {S}.item,
             (select ss_store_sk, avg(revenue) as ave
              from (select ss_store_sk, ss_item_sk,
                           sum(ss_sales_price) as revenue
                    from {S}.store_sales, {S}.date_dim
                    where ss_sold_date_sk = d_date_sk
                      and d_month_seq between 1198 and 1199
                    group by ss_store_sk, ss_item_sk) sa
              group by ss_store_sk) sb,
             (select ss_store_sk, ss_item_sk,
                     sum(ss_sales_price) as revenue
              from {S}.store_sales, {S}.date_dim
              where ss_sold_date_sk = d_date_sk
                and d_month_seq between 1198 and 1199
              group by ss_store_sk, ss_item_sk) sc
        where sb.ss_store_sk = sc.ss_store_sk
          and sc.revenue <= 0.1 * sb.ave
          and s_store_sk = sc.ss_store_sk
          and i_item_sk = sc.ss_item_sk
        order by s_store_name, i_item_desc
        limit 100""",
    # Q73: frequent small-basket shoppers for a demographic slice
    # (ticket line counts 1..5, the official bound)
    "q73": f"""
        select c_last_name, c_first_name, c_salutation,
               c_preferred_cust_flag, ss_ticket_number, cnt
        from (select ss_ticket_number, ss_customer_sk, count(*) as cnt
              from {S}.store_sales, {S}.date_dim, {S}.store,
                   {S}.household_demographics
              where ss_sold_date_sk = d_date_sk
                and ss_store_sk = s_store_sk
                and ss_hdemo_sk = hd_demo_sk
                and d_dom between 1 and 2
                and (hd_buy_potential = '>10000'
                     or hd_buy_potential = 'Unknown')
                and hd_vehicle_count > 0
                and case when hd_vehicle_count > 0
                         then cast(hd_dep_count as double)
                              / cast(hd_vehicle_count as double)
                         else null end > 1
                and d_year in (1999, 2000, 2001)
                and s_county in ('Barrow County', 'Bronx County')
              group by ss_ticket_number, ss_customer_sk) dj,
             {S}.customer
        where ss_customer_sk = c_customer_sk
          and cnt between 1 and 5
        order by cnt desc, c_last_name asc, c_first_name,
                 ss_ticket_number
        limit 100""",
    # Q87: customers who bought in-store but never by catalog or web
    # in one year (EXCEPT chain under a count)
    "q87": f"""
        select count(*) as cnt from (
          (select distinct c_last_name, c_first_name, d_date
           from {S}.store_sales, {S}.date_dim, {S}.customer
           where ss_sold_date_sk = d_date_sk
             and ss_customer_sk = c_customer_sk
             and d_month_seq between 1188 and 1199)
          except
          (select distinct c_last_name, c_first_name, d_date
           from {S}.catalog_sales, {S}.date_dim, {S}.customer
           where cs_sold_date_sk = d_date_sk
             and cs_bill_customer_sk = c_customer_sk
             and d_month_seq between 1188 and 1199)
          except
          (select distinct c_last_name, c_first_name, d_date
           from {S}.web_sales, {S}.date_dim, {S}.customer
           where ws_sold_date_sk = d_date_sk
             and ws_bill_customer_sk = c_customer_sk
             and d_month_seq between 1188 and 1199)
        ) cool_cust""",
    # Q89: store-brand months deviating from the yearly class average
    # (window aggregate over grouped sums, two category groups)
    "q89": f"""
        select *
        from (select i_category, i_class, i_brand, s_store_name,
                     s_company_name, d_moy,
                     sum(ss_sales_price) as sum_sales,
                     avg(sum(ss_sales_price)) over (
                       partition by i_category, i_brand, s_store_name,
                                    s_company_name)
                       as avg_monthly_sales
              from {S}.item, {S}.store_sales, {S}.date_dim, {S}.store
              where ss_item_sk = i_item_sk
                and ss_sold_date_sk = d_date_sk
                and ss_store_sk = s_store_sk
                and d_year = 1999
                and ((i_category in ('Books', 'Electronics', 'Sports')
                      and i_class in ('computers', 'stereo',
                                      'football'))
                  or (i_category in ('Men', 'Jewelry', 'Women')
                      and i_class in ('shirts', 'birdal', 'dresses')))
              group by i_category, i_class, i_brand, s_store_name,
                       s_company_name, d_moy) tmp1
        where case when avg_monthly_sales <> 0
                   then abs(sum_sales - avg_monthly_sales)
                        / avg_monthly_sales
                   else null end > 0.1
        order by sum_sales - avg_monthly_sales, s_store_name
        limit 100""",
    # Q97: store/catalog channel overlap of (customer, item) pairs for
    # one year (full outer join of grouped CTEs)
    "q97": f"""
        with ssci as (
          select ss_customer_sk as customer_sk, ss_item_sk as item_sk
          from {S}.store_sales, {S}.date_dim
          where ss_sold_date_sk = d_date_sk
            and d_month_seq between 1188 and 1199
          group by ss_customer_sk, ss_item_sk),
        csci as (
          select cs_bill_customer_sk as customer_sk,
                 cs_item_sk as item_sk
          from {S}.catalog_sales, {S}.date_dim
          where cs_sold_date_sk = d_date_sk
            and d_month_seq between 1188 and 1199
          group by cs_bill_customer_sk, cs_item_sk)
        select sum(case when ssci.customer_sk is not null
                         and csci.customer_sk is null
                        then 1 else 0 end) as store_only,
               sum(case when ssci.customer_sk is null
                         and csci.customer_sk is not null
                        then 1 else 0 end) as catalog_only,
               sum(case when ssci.customer_sk is not null
                         and csci.customer_sk is not null
                        then 1 else 0 end) as store_and_catalog
        from ssci full outer join csci
          on (ssci.customer_sk = csci.customer_sk
              and ssci.item_sk = csci.item_sk)
        limit 100""",
    # Q94: web orders shipped from multiple warehouses with NO return,
    # for one state/site/60-day window (q95's sibling: anti-join on
    # returns instead of the returns semi-join)
    "q94": f"""
        select count(distinct ws_order_number) as order_count,
               sum(ws_ext_ship_cost) as total_shipping_cost,
               sum(ws_net_profit) as total_net_profit
        from {S}.web_sales ws1, {S}.date_dim, {S}.customer_address,
             {S}.web_site
        where d_date between date '1999-02-01'
              and date '1999-02-01' + interval '60' day
          and ws1.ws_ship_date_sk = d_date_sk
          and ws1.ws_ship_addr_sk = ca_address_sk
          and ca_state = 'IL'
          and ws1.ws_web_site_sk = web_site_sk
          and web_company_name = 'pri'
          and exists (select *
                      from {S}.web_sales ws2
                      where ws1.ws_order_number = ws2.ws_order_number
                        and ws1.ws_warehouse_sk <> ws2.ws_warehouse_sk)
          and not exists (select *
                          from {S}.web_returns wr1
                          where ws1.ws_order_number
                                = wr1.wr_order_number)
        order by count(distinct ws_order_number)
        limit 100""",
    # Q14: brand/class/category combos sold in ALL three channels
    # (INTERSECT chain), channel revenue over the average, ROLLUP over
    # channel x hierarchy
    "q14": f"""
        with cross_items as (
          select i_item_sk as ss_item_sk
          from {S}.item,
               (select iss.i_brand_id as brand_id,
                       iss.i_class_id as class_id,
                       iss.i_category_id as category_id
                from {S}.store_sales, {S}.item iss, {S}.date_dim d1
                where ss_item_sk = iss.i_item_sk
                  and ss_sold_date_sk = d1.d_date_sk
                  and d1.d_year between 1998 and 1998 + 2
                intersect
                select ics.i_brand_id as brand_id,
                       ics.i_class_id as class_id,
                       ics.i_category_id as category_id
                from {S}.catalog_sales, {S}.item ics, {S}.date_dim d2
                where cs_item_sk = ics.i_item_sk
                  and cs_sold_date_sk = d2.d_date_sk
                  and d2.d_year between 1998 and 1998 + 2
                intersect
                select iws.i_brand_id as brand_id,
                       iws.i_class_id as class_id,
                       iws.i_category_id as category_id
                from {S}.web_sales, {S}.item iws, {S}.date_dim d3
                where ws_item_sk = iws.i_item_sk
                  and ws_sold_date_sk = d3.d_date_sk
                  and d3.d_year between 1998 and 1998 + 2) x
          where i_brand_id = brand_id
            and i_class_id = class_id
            and i_category_id = category_id),
        avg_sales as (
          select avg(quantity * list_price) as average_sales
          from (select ss_quantity as quantity,
                       ss_list_price as list_price
                from {S}.store_sales, {S}.date_dim
                where ss_sold_date_sk = d_date_sk
                  and d_year between 1998 and 1998 + 2
                union all
                select cs_quantity as quantity,
                       cs_list_price as list_price
                from {S}.catalog_sales, {S}.date_dim
                where cs_sold_date_sk = d_date_sk
                  and d_year between 1998 and 1998 + 2
                union all
                select ws_quantity as quantity,
                       ws_list_price as list_price
                from {S}.web_sales, {S}.date_dim
                where ws_sold_date_sk = d_date_sk
                  and d_year between 1998 and 1998 + 2) x)
        select channel, i_brand_id, i_class_id, i_category_id,
               sum(sales) as sum_sales,
               sum(number_sales) as sum_number_sales
        from (select 'store' as channel, i_brand_id, i_class_id,
                     i_category_id,
                     sum(ss_quantity * ss_list_price) as sales,
                     count(*) as number_sales
              from {S}.store_sales, {S}.item, {S}.date_dim
              where ss_item_sk in (select ss_item_sk
                                   from cross_items)
                and ss_item_sk = i_item_sk
                and ss_sold_date_sk = d_date_sk
                and d_year = 2000
                and d_moy = 11
              group by i_brand_id, i_class_id, i_category_id
              having sum(ss_quantity * ss_list_price) >
                     (select average_sales from avg_sales)
              union all
              select 'catalog' as channel, i_brand_id, i_class_id,
                     i_category_id,
                     sum(cs_quantity * cs_list_price) as sales,
                     count(*) as number_sales
              from {S}.catalog_sales, {S}.item, {S}.date_dim
              where cs_item_sk in (select ss_item_sk
                                   from cross_items)
                and cs_item_sk = i_item_sk
                and cs_sold_date_sk = d_date_sk
                and d_year = 2000
                and d_moy = 11
              group by i_brand_id, i_class_id, i_category_id
              having sum(cs_quantity * cs_list_price) >
                     (select average_sales from avg_sales)
              union all
              select 'web' as channel, i_brand_id, i_class_id,
                     i_category_id,
                     sum(ws_quantity * ws_list_price) as sales,
                     count(*) as number_sales
              from {S}.web_sales, {S}.item, {S}.date_dim
              where ws_item_sk in (select ss_item_sk
                                   from cross_items)
                and ws_item_sk = i_item_sk
                and ws_sold_date_sk = d_date_sk
                and d_year = 2000
                and d_moy = 11
              group by i_brand_id, i_class_id, i_category_id
              having sum(ws_quantity * ws_list_price) >
                     (select average_sales from avg_sales)) y
        group by rollup (channel, i_brand_id, i_class_id,
                         i_category_id)
        order by channel, i_brand_id, i_class_id, i_category_id
        limit 100""",
    # Q23: off-season catalog/web revenue from frequent-item,
    # best-customer purchases (HAVING against scalar CTE maxima)
    "q23": f"""
        with frequent_ss_items as (
          select substr(i_item_desc, 1, 30) as itemdesc,
                 i_item_sk as item_sk, d_date as solddate,
                 count(*) as cnt
          from {S}.store_sales, {S}.date_dim, {S}.item
          where ss_sold_date_sk = d_date_sk
            and ss_item_sk = i_item_sk
            and d_year in (1998, 1998 + 1, 1998 + 2)
          group by substr(i_item_desc, 1, 30), i_item_sk, d_date
          having count(*) > 4),
        max_store_sales as (
          select max(csales) as tpcds_cmax
          from (select c_customer_sk,
                       sum(ss_quantity * ss_sales_price) as csales
                from {S}.store_sales, {S}.customer, {S}.date_dim
                where ss_customer_sk = c_customer_sk
                  and ss_sold_date_sk = d_date_sk
                  and d_year in (1998, 1998 + 1, 1998 + 2)
                group by c_customer_sk) t),
        best_ss_customer as (
          select c_customer_sk,
                 sum(ss_quantity * ss_sales_price) as ssales
          from {S}.store_sales, {S}.customer
          where ss_customer_sk = c_customer_sk
          group by c_customer_sk
          having sum(ss_quantity * ss_sales_price) >
                 (50 / 100.0) * (select tpcds_cmax
                                 from max_store_sales))
        select sum(sales) as total
        from (select cs_quantity * cs_list_price as sales
              from {S}.catalog_sales, {S}.date_dim
              where d_year = 2000
                and d_moy = 2
                and cs_sold_date_sk = d_date_sk
                and cs_item_sk in (select item_sk
                                   from frequent_ss_items)
                and cs_bill_customer_sk in
                    (select c_customer_sk from best_ss_customer)
              union all
              select ws_quantity * ws_list_price as sales
              from {S}.web_sales, {S}.date_dim
              where d_year = 2000
                and d_moy = 2
                and ws_sold_date_sk = d_date_sk
                and ws_item_sk in (select item_sk
                                   from frequent_ss_items)
                and ws_bill_customer_sk in
                    (select c_customer_sk from best_ss_customer)) x
        limit 100""",
    # Q51: item-date cumulative web vs store revenue crossover — ROWS
    # running sums inside the CTEs, running max over the FULL OUTER
    # join of both channels
    "q51": f"""
        with web_v1 as (
          select ws_item_sk as item_sk, d_date,
                 sum(sum(ws_sales_price))
                   over (partition by ws_item_sk
                         order by d_date
                         rows between unbounded preceding
                         and current row) as cume_sales
          from {S}.web_sales, {S}.date_dim
          where ws_sold_date_sk = d_date_sk
            and d_month_seq between 1188 and 1188 + 11
          group by ws_item_sk, d_date),
        store_v1 as (
          select ss_item_sk as item_sk, d_date,
                 sum(sum(ss_sales_price))
                   over (partition by ss_item_sk
                         order by d_date
                         rows between unbounded preceding
                         and current row) as cume_sales
          from {S}.store_sales, {S}.date_dim
          where ss_sold_date_sk = d_date_sk
            and d_month_seq between 1188 and 1188 + 11
          group by ss_item_sk, d_date)
        select *
        from (select item_sk, d_date, web_sales, store_sales,
                     max(web_cumulative)
                       over (partition by item_sk
                             order by d_date
                             rows between unbounded preceding
                             and current row) as web_cumulative,
                     max(store_cumulative)
                       over (partition by item_sk
                             order by d_date
                             rows between unbounded preceding
                             and current row) as store_cumulative
              from (select case when web.item_sk is not null
                                then web.item_sk
                                else store.item_sk end as item_sk,
                           case when web.d_date is not null
                                then web.d_date
                                else store.d_date end as d_date,
                           web.cume_sales as web_sales,
                           store.cume_sales as store_sales,
                           web.cume_sales as web_cumulative,
                           store.cume_sales as store_cumulative
                    from web_v1 web
                         full join store_v1 store
                           on web.item_sk = store.item_sk
                          and web.d_date = store.d_date) x) y
        where web_cumulative > store_cumulative
        order by item_sk, d_date
        limit 100""",
    # Q36: gross margin by category hierarchy ROLLUP with rank within
    # each hierarchy level (grouping() in window partition keys and a
    # string CASE sort key)
    "q36": f"""
        select sum(ss_net_profit) / sum(ss_ext_sales_price)
                 as gross_margin,
               i_category, i_class,
               grouping(i_category) + grouping(i_class)
                 as lochierarchy,
               rank() over (
                 partition by
                   grouping(i_category) + grouping(i_class),
                   case when grouping(i_class) = 0
                        then i_category end
                 order by sum(ss_net_profit)
                          / sum(ss_ext_sales_price) asc)
                 as rank_within_parent
        from {S}.store_sales, {S}.date_dim d1, {S}.item, {S}.store
        where d1.d_year = 1999
          and d1.d_date_sk = ss_sold_date_sk
          and i_item_sk = ss_item_sk
          and s_store_sk = ss_store_sk
          and s_state in ('CA', 'GA')
        group by rollup (i_category, i_class)
        order by lochierarchy desc,
                 case when lochierarchy = 0 then i_category end,
                 rank_within_parent
        limit 100""",
    # Q70: profitable-state counties ROLLUP, states prefiltered by a
    # windowed top-5 subquery
    "q70": f"""
        select sum(ss_net_profit) as total_sum, s_state, s_county,
               grouping(s_state) + grouping(s_county)
                 as lochierarchy,
               rank() over (
                 partition by
                   grouping(s_state) + grouping(s_county),
                   case when grouping(s_county) = 0
                        then s_state end
                 order by sum(ss_net_profit) desc)
                 as rank_within_parent
        from {S}.store_sales, {S}.date_dim d1, {S}.store
        where d1.d_month_seq between 1188 and 1188 + 11
          and d1.d_date_sk = ss_sold_date_sk
          and s_store_sk = ss_store_sk
          and s_state in (select s_state
                          from (select s_state as s_state,
                                       rank() over (
                                         partition by s_state
                                         order by sum(ss_net_profit)
                                                  desc) as ranking
                                from {S}.store_sales, {S}.store,
                                     {S}.date_dim
                                where d_month_seq between 1188
                                      and 1188 + 11
                                  and d_date_sk = ss_sold_date_sk
                                  and s_store_sk = ss_store_sk
                                group by s_state) tmp1
                          where ranking <= 5)
        group by rollup (s_state, s_county)
        order by lochierarchy desc,
                 case when lochierarchy = 0 then s_state end,
                 rank_within_parent
        limit 100""",
    # Q86: web revenue by category hierarchy ROLLUP with rank within
    # parent (Q36's web twin)
    "q86": f"""
        select sum(ws_net_paid) as total_sum, i_category, i_class,
               grouping(i_category) + grouping(i_class)
                 as lochierarchy,
               rank() over (
                 partition by
                   grouping(i_category) + grouping(i_class),
                   case when grouping(i_class) = 0
                        then i_category end
                 order by sum(ws_net_paid) desc)
                 as rank_within_parent
        from {S}.web_sales, {S}.date_dim d1, {S}.item
        where d1.d_month_seq between 1188 and 1188 + 11
          and d1.d_date_sk = ws_sold_date_sk
          and i_item_sk = ws_item_sk
        group by rollup (i_category, i_class)
        order by lochierarchy desc,
                 case when lochierarchy = 0 then i_category end,
                 rank_within_parent
        limit 100""",
    # Q24: returned-store purchases where the customer's birth country
    # differs from their address country, one market's stores zip-tied
    # to the customer address (cross-dictionary string predicates)
    "q24": f"""
        with ssales as (
          select c_last_name, c_first_name, s_store_name, ca_state,
                 s_state, i_color, i_current_price, i_manager_id,
                 i_units, i_size,
                 sum(ss_net_paid) as netpaid
          from {S}.store_sales, {S}.store_returns, {S}.store,
               {S}.item, {S}.customer, {S}.customer_address
          where ss_ticket_number = sr_ticket_number
            and ss_item_sk = sr_item_sk
            and ss_customer_sk = c_customer_sk
            and ss_item_sk = i_item_sk
            and ss_store_sk = s_store_sk
            and c_current_addr_sk = ca_address_sk
            and c_birth_country <> upper(ca_country)
            and s_zip = ca_zip
            and s_market_id = 1
          group by c_last_name, c_first_name, s_store_name, ca_state,
                   s_state, i_color, i_current_price, i_manager_id,
                   i_units, i_size)
        select c_last_name, c_first_name, s_store_name,
               sum(netpaid) as paid
        from ssales
        where i_color = 'peach'
        group by c_last_name, c_first_name, s_store_name
        having sum(netpaid) > (select 0.05 * avg(netpaid)
                               from ssales)
        order by c_last_name, c_first_name, s_store_name
        """,
    # Q54: customers buying one month's promoted category via
    # web/catalog, segmented by their next-quarter in-county store
    # revenue (month-seq scalar arithmetic subqueries)
    "q54": f"""
        with my_customers as (
          select distinct c_customer_sk, c_current_addr_sk
          from (select cs_sold_date_sk as sold_date_sk,
                       cs_bill_customer_sk as customer_sk,
                       cs_item_sk as item_sk
                from {S}.catalog_sales
                union all
                select ws_sold_date_sk as sold_date_sk,
                       ws_bill_customer_sk as customer_sk,
                       ws_item_sk as item_sk
                from {S}.web_sales) cs_or_ws_sales,
               {S}.item, {S}.date_dim, {S}.customer
          where sold_date_sk = d_date_sk
            and item_sk = i_item_sk
            and i_category = 'Women'
            and i_class = 'dresses'
            and c_customer_sk = cs_or_ws_sales.customer_sk
            and d_moy = 5
            and d_year = 1999),
        my_revenue as (
          select c_customer_sk,
                 sum(ss_ext_sales_price) as revenue
          from my_customers, {S}.store_sales,
               {S}.customer_address, {S}.store, {S}.date_dim
          where c_current_addr_sk = ca_address_sk
            and ca_county = s_county
            and ca_state = s_state
            and ss_customer_sk = c_customer_sk
            and ss_sold_date_sk = d_date_sk
            and ss_store_sk = s_store_sk
            and d_month_seq between
                (select distinct d_month_seq + 1
                 from {S}.date_dim
                 where d_year = 1999 and d_moy = 5)
                and (select distinct d_month_seq + 3
                     from {S}.date_dim
                     where d_year = 1999 and d_moy = 5)
          group by c_customer_sk),
        segments as (
          select cast(revenue / 50 as integer) as segment
          from my_revenue)
        select segment, count(*) as num_customers,
               segment * 50 as segment_base
        from segments
        group by segment
        order by segment, num_customers
        limit 100""",
    # Q66: warehouse 12-month web+catalog shipping report, month CASE
    # sums by carrier and a daytime window. Deviation: the generator
    # has no *_net_paid_inc_tax columns, so the net rows aggregate
    # ws_net_paid / cs_net_paid
    "q66": f"""
        select w_warehouse_name, w_warehouse_sq_ft, w_city, w_county,
               w_state, w_country, ship_carriers, year_,
               sum(jan_sales) as jan_sales,
               sum(feb_sales) as feb_sales,
               sum(mar_sales) as mar_sales,
               sum(apr_sales) as apr_sales,
               sum(may_sales) as may_sales,
               sum(jun_sales) as jun_sales,
               sum(jul_sales) as jul_sales,
               sum(aug_sales) as aug_sales,
               sum(sep_sales) as sep_sales,
               sum(oct_sales) as oct_sales,
               sum(nov_sales) as nov_sales,
               sum(dec_sales) as dec_sales,
               sum(jan_sales / w_warehouse_sq_ft)
                 as jan_sales_per_sq_foot,
               sum(dec_sales / w_warehouse_sq_ft)
                 as dec_sales_per_sq_foot,
               sum(jan_net) as jan_net,
               sum(dec_net) as dec_net
        from (select w_warehouse_name, w_warehouse_sq_ft, w_city,
                     w_county, w_state, w_country,
                     'DHL,BARIAN' as ship_carriers,
                     d_year as year_,
                     sum(case when d_moy = 1
                         then ws_ext_sales_price * ws_quantity
                         else 0 end) as jan_sales,
                     sum(case when d_moy = 2
                         then ws_ext_sales_price * ws_quantity
                         else 0 end) as feb_sales,
                     sum(case when d_moy = 3
                         then ws_ext_sales_price * ws_quantity
                         else 0 end) as mar_sales,
                     sum(case when d_moy = 4
                         then ws_ext_sales_price * ws_quantity
                         else 0 end) as apr_sales,
                     sum(case when d_moy = 5
                         then ws_ext_sales_price * ws_quantity
                         else 0 end) as may_sales,
                     sum(case when d_moy = 6
                         then ws_ext_sales_price * ws_quantity
                         else 0 end) as jun_sales,
                     sum(case when d_moy = 7
                         then ws_ext_sales_price * ws_quantity
                         else 0 end) as jul_sales,
                     sum(case when d_moy = 8
                         then ws_ext_sales_price * ws_quantity
                         else 0 end) as aug_sales,
                     sum(case when d_moy = 9
                         then ws_ext_sales_price * ws_quantity
                         else 0 end) as sep_sales,
                     sum(case when d_moy = 10
                         then ws_ext_sales_price * ws_quantity
                         else 0 end) as oct_sales,
                     sum(case when d_moy = 11
                         then ws_ext_sales_price * ws_quantity
                         else 0 end) as nov_sales,
                     sum(case when d_moy = 12
                         then ws_ext_sales_price * ws_quantity
                         else 0 end) as dec_sales,
                     sum(case when d_moy = 1
                         then ws_net_paid * ws_quantity
                         else 0 end) as jan_net,
                     sum(case when d_moy = 12
                         then ws_net_paid * ws_quantity
                         else 0 end) as dec_net
              from {S}.web_sales, {S}.warehouse, {S}.date_dim,
                   {S}.time_dim, {S}.ship_mode
              where ws_warehouse_sk = w_warehouse_sk
                and ws_sold_date_sk = d_date_sk
                and ws_sold_time_sk = t_time_sk
                and ws_ship_mode_sk = sm_ship_mode_sk
                and d_year = 1999
                and t_time between 30838 and 30838 + 28800
                and sm_carrier in ('DHL', 'BARIAN')
              group by w_warehouse_name, w_warehouse_sq_ft, w_city,
                       w_county, w_state, w_country, d_year
              union all
              select w_warehouse_name, w_warehouse_sq_ft, w_city,
                     w_county, w_state, w_country,
                     'DHL,BARIAN' as ship_carriers,
                     d_year as year_,
                     sum(case when d_moy = 1
                         then cs_sales_price * cs_quantity
                         else 0 end) as jan_sales,
                     sum(case when d_moy = 2
                         then cs_sales_price * cs_quantity
                         else 0 end) as feb_sales,
                     sum(case when d_moy = 3
                         then cs_sales_price * cs_quantity
                         else 0 end) as mar_sales,
                     sum(case when d_moy = 4
                         then cs_sales_price * cs_quantity
                         else 0 end) as apr_sales,
                     sum(case when d_moy = 5
                         then cs_sales_price * cs_quantity
                         else 0 end) as may_sales,
                     sum(case when d_moy = 6
                         then cs_sales_price * cs_quantity
                         else 0 end) as jun_sales,
                     sum(case when d_moy = 7
                         then cs_sales_price * cs_quantity
                         else 0 end) as jul_sales,
                     sum(case when d_moy = 8
                         then cs_sales_price * cs_quantity
                         else 0 end) as aug_sales,
                     sum(case when d_moy = 9
                         then cs_sales_price * cs_quantity
                         else 0 end) as sep_sales,
                     sum(case when d_moy = 10
                         then cs_sales_price * cs_quantity
                         else 0 end) as oct_sales,
                     sum(case when d_moy = 11
                         then cs_sales_price * cs_quantity
                         else 0 end) as nov_sales,
                     sum(case when d_moy = 12
                         then cs_sales_price * cs_quantity
                         else 0 end) as dec_sales,
                     sum(case when d_moy = 1
                         then cs_net_paid * cs_quantity
                         else 0 end) as jan_net,
                     sum(case when d_moy = 12
                         then cs_net_paid * cs_quantity
                         else 0 end) as dec_net
              from {S}.catalog_sales, {S}.warehouse, {S}.date_dim,
                   {S}.time_dim, {S}.ship_mode
              where cs_warehouse_sk = w_warehouse_sk
                and cs_sold_date_sk = d_date_sk
                and cs_sold_time_sk = t_time_sk
                and cs_ship_mode_sk = sm_ship_mode_sk
                and d_year = 1999
                and t_time between 30838 and 30838 + 28800
                and sm_carrier in ('DHL', 'BARIAN')
              group by w_warehouse_name, w_warehouse_sq_ft, w_city,
                       w_county, w_state, w_country, d_year) x
        group by w_warehouse_name, w_warehouse_sq_ft, w_city,
                 w_county, w_state, w_country, ship_carriers, year_
        order by w_warehouse_name
        limit 100""",
    # Q49: worst in-channel return ratios, rank unioned across the
    # three channels (return-amount threshold fitted to the
    # generator's 1.00-100.00 return domain)
    "q49": f"""
        select channel, item, return_ratio, return_rank,
               currency_rank
        from (select 'web' as channel, web.item, web.return_ratio,
                     web.return_rank, web.currency_rank
              from (select item, return_ratio, currency_ratio,
                           rank() over (order by return_ratio)
                             as return_rank,
                           rank() over (order by currency_ratio)
                             as currency_rank
                    from (select ws.ws_item_sk as item,
                                 cast(sum(coalesce(
                                     wr.wr_return_quantity, 0))
                                   as decimal(15,4))
                                 / cast(sum(coalesce(
                                     ws.ws_quantity, 0))
                                   as decimal(15,4))
                                   as return_ratio,
                                 cast(sum(coalesce(
                                     wr.wr_return_amt, 0))
                                   as decimal(15,4))
                                 / cast(sum(coalesce(
                                     ws.ws_net_paid, 0))
                                   as decimal(15,4))
                                   as currency_ratio
                          from {S}.web_sales ws
                               left join {S}.web_returns wr
                                 on ws.ws_order_number
                                    = wr.wr_order_number
                                and ws.ws_item_sk = wr.wr_item_sk,
                               {S}.date_dim
                          where wr.wr_return_amt > 50
                            and ws.ws_net_profit > 1
                            and ws.ws_net_paid > 0
                            and ws.ws_quantity > 0
                            and ws_sold_date_sk = d_date_sk
                            and d_year = 1999
                            and d_moy = 11
                          group by ws.ws_item_sk) in_web) web
              where web.return_rank <= 10
                 or web.currency_rank <= 10
              union
              select 'catalog' as channel, catalog.item,
                     catalog.return_ratio, catalog.return_rank,
                     catalog.currency_rank
              from (select item, return_ratio, currency_ratio,
                           rank() over (order by return_ratio)
                             as return_rank,
                           rank() over (order by currency_ratio)
                             as currency_rank
                    from (select cs.cs_item_sk as item,
                                 cast(sum(coalesce(
                                     cr.cr_return_quantity, 0))
                                   as decimal(15,4))
                                 / cast(sum(coalesce(
                                     cs.cs_quantity, 0))
                                   as decimal(15,4))
                                   as return_ratio,
                                 cast(sum(coalesce(
                                     cr.cr_return_amount, 0))
                                   as decimal(15,4))
                                 / cast(sum(coalesce(
                                     cs.cs_net_paid, 0))
                                   as decimal(15,4))
                                   as currency_ratio
                          from {S}.catalog_sales cs
                               left join {S}.catalog_returns cr
                                 on cs.cs_order_number
                                    = cr.cr_order_number
                                and cs.cs_item_sk = cr.cr_item_sk,
                               {S}.date_dim
                          where cr.cr_return_amount > 50
                            and cs.cs_net_profit > 1
                            and cs.cs_net_paid > 0
                            and cs.cs_quantity > 0
                            and cs_sold_date_sk = d_date_sk
                            and d_year = 1999
                            and d_moy = 11
                          group by cs.cs_item_sk) in_cat) catalog
              where catalog.return_rank <= 10
                 or catalog.currency_rank <= 10
              union
              select 'store' as channel, store.item,
                     store.return_ratio, store.return_rank,
                     store.currency_rank
              from (select item, return_ratio, currency_ratio,
                           rank() over (order by return_ratio)
                             as return_rank,
                           rank() over (order by currency_ratio)
                             as currency_rank
                    from (select sts.ss_item_sk as item,
                                 cast(sum(coalesce(
                                     sr.sr_return_quantity, 0))
                                   as decimal(15,4))
                                 / cast(sum(coalesce(
                                     sts.ss_quantity, 0))
                                   as decimal(15,4))
                                   as return_ratio,
                                 cast(sum(coalesce(
                                     sr.sr_return_amt, 0))
                                   as decimal(15,4))
                                 / cast(sum(coalesce(
                                     sts.ss_net_paid, 0))
                                   as decimal(15,4))
                                   as currency_ratio
                          from {S}.store_sales sts
                               left join {S}.store_returns sr
                                 on sts.ss_ticket_number
                                    = sr.sr_ticket_number
                                and sts.ss_item_sk = sr.sr_item_sk,
                               {S}.date_dim
                          where sr.sr_return_amt > 50
                            and sts.ss_net_profit > 1
                            and sts.ss_net_paid > 0
                            and sts.ss_quantity > 0
                            and ss_sold_date_sk = d_date_sk
                            and d_year = 1999
                            and d_moy = 11
                          group by sts.ss_item_sk) in_store) store
              where store.return_rank <= 10
                 or store.currency_rank <= 10) sq1
        group by channel, item, return_ratio, return_rank,
                 currency_rank
        order by 1, 4, 5, 2
        limit 100""",
    # Q85: web returns by refunding demographics/address/reason
    "q85": f"""
        select substring(r_reason_desc, 1, 20) as reason,
               avg(ws_quantity) as aq,
               avg(wr_refunded_cash) as arc,
               avg(wr_fee) as af
        from (select ws_quantity, wr_refunded_cash, wr_fee,
                     r_reason_desc
              from {S}.web_sales, {S}.web_returns, {S}.web_page,
                   {S}.customer_demographics cd1,
                   {S}.customer_demographics cd2,
                   {S}.customer_address, {S}.date_dim, {S}.reason
              where ws_web_page_sk = wp_web_page_sk
                and ws_item_sk = wr_item_sk
                and ws_order_number = wr_order_number
                and ws_sold_date_sk = d_date_sk
                and d_year = 2000
                and cd1.cd_demo_sk = wr_refunded_cdemo_sk
                and cd2.cd_demo_sk = wr_returning_cdemo_sk
                and ca_address_sk = wr_refunded_addr_sk
                and r_reason_sk = wr_reason_sk
                and ((cd1.cd_marital_status = 'M'
                      and cd1.cd_marital_status
                          = cd2.cd_marital_status
                      and cd1.cd_education_status = 'Advanced Degree'
                      and cd1.cd_education_status
                          = cd2.cd_education_status
                      and ws_sales_price between 10 and 50)
                  or (cd1.cd_marital_status = 'S'
                      and cd1.cd_marital_status
                          = cd2.cd_marital_status
                      and cd1.cd_education_status = 'College'
                      and cd1.cd_education_status
                          = cd2.cd_education_status
                      and ws_sales_price between 20 and 70)
                  or (cd1.cd_marital_status = 'W'
                      and cd1.cd_marital_status
                          = cd2.cd_marital_status
                      and cd1.cd_education_status = '2 yr Degree'
                      and cd1.cd_education_status
                          = cd2.cd_education_status
                      and ws_sales_price between 30 and 90))
                and ((ca_country = 'United States'
                      and ca_state in ('TX', 'OH', 'CA')
                      and ws_net_profit between 100 and 200)
                  or (ca_country = 'United States'
                      and ca_state in ('GA', 'IL', 'NY')
                      and ws_net_profit between 150 and 300)
                  or (ca_country = 'United States'
                      and ca_state in ('MI', 'PA', 'WA')
                      and ws_net_profit between 50 and 250))) t
        group by r_reason_desc
        order by substring(r_reason_desc, 1, 20), avg(ws_quantity),
                 avg(wr_refunded_cash), avg(wr_fee)
        limit 100""",
    # Q8: store revenue for stores whose zip prefix matches a list
    # AND belongs to a zip with >=10 preferred customers (INTERSECT)
    "q8": f"""
        select s_store_name, sum(ss_net_profit) as profit
        from {S}.store_sales, {S}.date_dim, {S}.store,
             (select ca_zip
              from (select substr(ca_zip, 1, 5) as ca_zip
                    from {S}.customer_address
                    where substr(ca_zip, 1, 5) in
                          ('10097', '10485', '11881', '12305',
                           '13493', '14687', '15881', '16299',
                           '17393', '18681', '19099')
                    intersect
                    select ca_zip
                    from (select substr(ca_zip, 1, 5) as ca_zip,
                                 count(*) as cnt
                          from {S}.customer_address, {S}.customer
                          where ca_address_sk = c_current_addr_sk
                            and c_preferred_cust_flag = 'Y'
                          group by ca_zip
                          having count(*) > 2) a1) a2) v1
        where ss_store_sk = s_store_sk
          and ss_sold_date_sk = d_date_sk
          and d_qoy = 2
          and d_year = 1998
          and substr(s_zip, 1, 2) = substr(v1.ca_zip, 1, 2)
        group by s_store_name
        order by s_store_name
        limit 100""",
    # Q53: manager quarterly revenue with the category/brand filter
    # pairs, avg window over the manager (Q63/Q89's sibling)
    "q53": f"""
        select * from
          (select i_manufact_id,
                  sum(ss_sales_price) as sum_sales,
                  avg(sum(ss_sales_price))
                    over (partition by i_manufact_id)
                    as avg_quarterly_sales
           from {S}.item, {S}.store_sales, {S}.date_dim, {S}.store
           where ss_item_sk = i_item_sk
             and ss_sold_date_sk = d_date_sk
             and ss_store_sk = s_store_sk
             and d_month_seq in (1188, 1189, 1190, 1191, 1192, 1193,
                                 1194, 1195, 1196, 1197, 1198, 1199)
             and ((i_category in ('Books', 'Children', 'Electronics')
                   and i_class in ('fiction', 'bedding', 'computers'))
               or (i_category in ('Women', 'Music', 'Men')
                   and i_class in ('dresses', 'country', 'athletic')))
           group by i_manufact_id, d_qoy) tmp1
        where case when avg_quarterly_sales > 0
                   then abs(sum_sales - avg_quarterly_sales)
                        / avg_quarterly_sales
                   else null end > 0.1
        order by avg_quarterly_sales, sum_sales, i_manufact_id
        limit 100""",
    # Q4: three-channel year-over-year customer growth (six instances
    # of one CTE; web AND catalog both outpacing store)
    "q4": f"""
        with year_total as (
          select c_customer_id as customer_id,
                 c_first_name as customer_first_name,
                 c_last_name as customer_last_name,
                 d_year as dyear,
                 sum(((ss_ext_list_price - ss_ext_wholesale_cost
                       - ss_ext_discount_amt) + ss_ext_sales_price)
                     / 2) as year_total,
                 's' as sale_type
          from {S}.customer, {S}.store_sales, {S}.date_dim
          where c_customer_sk = ss_customer_sk
            and ss_sold_date_sk = d_date_sk
          group by c_customer_id, c_first_name, c_last_name, d_year
          union all
          select c_customer_id as customer_id,
                 c_first_name as customer_first_name,
                 c_last_name as customer_last_name,
                 d_year as dyear,
                 sum(((cs_ext_list_price - cs_ext_wholesale_cost
                       - cs_ext_discount_amt) + cs_ext_sales_price)
                     / 2) as year_total,
                 'c' as sale_type
          from {S}.customer, {S}.catalog_sales, {S}.date_dim
          where c_customer_sk = cs_bill_customer_sk
            and cs_sold_date_sk = d_date_sk
          group by c_customer_id, c_first_name, c_last_name, d_year
          union all
          select c_customer_id as customer_id,
                 c_first_name as customer_first_name,
                 c_last_name as customer_last_name,
                 d_year as dyear,
                 sum(((ws_ext_list_price - ws_ext_wholesale_cost
                       - ws_ext_discount_amt) + ws_ext_sales_price)
                     / 2) as year_total,
                 'w' as sale_type
          from {S}.customer, {S}.web_sales, {S}.date_dim
          where c_customer_sk = ws_bill_customer_sk
            and ws_sold_date_sk = d_date_sk
          group by c_customer_id, c_first_name, c_last_name, d_year)
        select t_s_secyear.customer_id,
               t_s_secyear.customer_first_name,
               t_s_secyear.customer_last_name
        from year_total t_s_firstyear, year_total t_s_secyear,
             year_total t_c_firstyear, year_total t_c_secyear,
             year_total t_w_firstyear, year_total t_w_secyear
        where t_s_secyear.customer_id = t_s_firstyear.customer_id
          and t_s_firstyear.customer_id = t_c_secyear.customer_id
          and t_s_firstyear.customer_id = t_c_firstyear.customer_id
          and t_s_firstyear.customer_id = t_w_firstyear.customer_id
          and t_s_firstyear.customer_id = t_w_secyear.customer_id
          and t_s_firstyear.sale_type = 's'
          and t_c_firstyear.sale_type = 'c'
          and t_w_firstyear.sale_type = 'w'
          and t_s_secyear.sale_type = 's'
          and t_c_secyear.sale_type = 'c'
          and t_w_secyear.sale_type = 'w'
          and t_s_firstyear.dyear = 1999
          and t_s_secyear.dyear = 1999 + 1
          and t_c_firstyear.dyear = 1999
          and t_c_secyear.dyear = 1999 + 1
          and t_w_firstyear.dyear = 1999
          and t_w_secyear.dyear = 1999 + 1
          and t_s_firstyear.year_total > 0
          and t_c_firstyear.year_total > 0
          and t_w_firstyear.year_total > 0
          and (case when t_c_firstyear.year_total > 0
                    then t_c_secyear.year_total
                         / t_c_firstyear.year_total
                    else null end)
            > (case when t_s_firstyear.year_total > 0
                    then t_s_secyear.year_total
                         / t_s_firstyear.year_total
                    else null end)
          and (case when t_c_firstyear.year_total > 0
                    then t_c_secyear.year_total
                         / t_c_firstyear.year_total
                    else null end)
            > (case when t_w_firstyear.year_total > 0
                    then t_w_secyear.year_total
                         / t_w_firstyear.year_total
                    else null end)
        order by t_s_secyear.customer_id,
                 t_s_secyear.customer_first_name,
                 t_s_secyear.customer_last_name
        limit 100""",
    # Q71: brand revenue by hour across all three channels during
    # breakfast/dinner meal times
    "q71": f"""
        select i_brand_id as brand_id, i_brand as brand,
               t_hour, t_minute,
               sum(ext_price) as ext_price
        from {S}.item,
             (select ws_ext_sales_price as ext_price,
                     ws_sold_date_sk as sold_date_sk,
                     ws_item_sk as sold_item_sk,
                     ws_sold_time_sk as time_sk
              from {S}.web_sales, {S}.date_dim
              where d_date_sk = ws_sold_date_sk
                and d_moy = 11
                and d_year = 1999
              union all
              select cs_ext_sales_price as ext_price,
                     cs_sold_date_sk as sold_date_sk,
                     cs_item_sk as sold_item_sk,
                     cs_sold_time_sk as time_sk
              from {S}.catalog_sales, {S}.date_dim
              where d_date_sk = cs_sold_date_sk
                and d_moy = 11
                and d_year = 1999
              union all
              select ss_ext_sales_price as ext_price,
                     ss_sold_date_sk as sold_date_sk,
                     ss_item_sk as sold_item_sk,
                     ss_sold_time_sk as time_sk
              from {S}.store_sales, {S}.date_dim
              where d_date_sk = ss_sold_date_sk
                and d_moy = 11
                and d_year = 1999) tmp, {S}.time_dim
        where sold_item_sk = i_item_sk
          and i_manager_id = 1
          and time_sk = t_time_sk
          and (t_meal_time = 'breakfast' or t_meal_time = 'dinner')
        group by i_brand, i_brand_id, t_hour, t_minute
        order by ext_price desc, i_brand_id
        """,
    # Q83: item return quantities per channel for three linked weeks
    "q83": f"""
        with sr_items as (
          select i_item_id as item_id,
                 sum(sr_return_quantity) as sr_item_qty
          from {S}.store_returns, {S}.item, {S}.date_dim
          where sr_item_sk = i_item_sk
            and d_date in (select d_date
                           from {S}.date_dim
                           where d_week_seq in
                                 (select d_week_seq
                                  from {S}.date_dim
                                  where d_date in (date '2000-06-30',
                                                   date '2000-09-27',
                                                   date '2000-11-17')))
            and sr_returned_date_sk = d_date_sk
          group by i_item_id),
        cr_items as (
          select i_item_id as item_id,
                 sum(cr_return_quantity) as cr_item_qty
          from {S}.catalog_returns, {S}.item, {S}.date_dim
          where cr_item_sk = i_item_sk
            and d_date in (select d_date
                           from {S}.date_dim
                           where d_week_seq in
                                 (select d_week_seq
                                  from {S}.date_dim
                                  where d_date in (date '2000-06-30',
                                                   date '2000-09-27',
                                                   date '2000-11-17')))
            and cr_returned_date_sk = d_date_sk
          group by i_item_id),
        wr_items as (
          select i_item_id as item_id,
                 sum(wr_return_quantity) as wr_item_qty
          from {S}.web_returns, {S}.item, {S}.date_dim
          where wr_item_sk = i_item_sk
            and d_date in (select d_date
                           from {S}.date_dim
                           where d_week_seq in
                                 (select d_week_seq
                                  from {S}.date_dim
                                  where d_date in (date '2000-06-30',
                                                   date '2000-09-27',
                                                   date '2000-11-17')))
            and wr_returned_date_sk = d_date_sk
          group by i_item_id)
        select sr_items.item_id,
               sr_item_qty,
               sr_item_qty
               / (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0 * 100
                 as sr_dev,
               cr_item_qty,
               cr_item_qty
               / (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0 * 100
                 as cr_dev,
               wr_item_qty,
               wr_item_qty
               / (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0 * 100
                 as wr_dev,
               (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0
                 as average
        from sr_items, cr_items, wr_items
        where sr_items.item_id = cr_items.item_id
          and sr_items.item_id = wr_items.item_id
        order by sr_items.item_id, sr_item_qty
        limit 100""",
    # Q39: warehouse/item monthly inventory mean & coefficient of
    # variation, consecutive-month pairs of the same CTE
    "q39": f"""
        with inv as (
          select w_warehouse_name, w_warehouse_sk, i_item_sk, d_moy,
                 stdev, mean,
                 case mean when 0 then null
                      else stdev / mean end as cov
          from (select w_warehouse_name, w_warehouse_sk, i_item_sk,
                       d_moy,
                       stddev_samp(inv_quantity_on_hand) as stdev,
                       avg(inv_quantity_on_hand) as mean
                from {S}.inventory, {S}.item, {S}.warehouse,
                     {S}.date_dim
                where inv_item_sk = i_item_sk
                  and inv_warehouse_sk = w_warehouse_sk
                  and inv_date_sk = d_date_sk
                  and d_year = 1999
                group by w_warehouse_name, w_warehouse_sk, i_item_sk,
                         d_moy) foo
          where case mean when 0 then 0
                     else stdev / mean end > 1)
        select inv1.w_warehouse_sk as wsk1, inv1.i_item_sk as isk1,
               inv1.d_moy as moy1, inv1.mean as mean1,
               inv1.cov as cov1,
               inv2.w_warehouse_sk as wsk2, inv2.i_item_sk as isk2,
               inv2.d_moy as moy2, inv2.mean as mean2,
               inv2.cov as cov2
        from inv inv1, inv inv2
        where inv1.i_item_sk = inv2.i_item_sk
          and inv1.w_warehouse_sk = inv2.w_warehouse_sk
          and inv1.d_moy = 1
          and inv2.d_moy = 1 + 1
        order by inv1.w_warehouse_sk, inv1.i_item_sk, inv1.d_moy,
                 inv1.mean, inv1.cov, inv2.d_moy, inv2.mean, inv2.cov
        limit 100""",
    # Q76: sales with a NULL surrogate key per channel (this engine's
    # closed-form generator emits no NULL foreign keys, so every
    # branch is empty — oracle-exact over the same data, exercised for
    # shape parity with the official template)
    "q76": f"""
        select channel, col_name, d_year, d_qoy, i_category,
               count(*) as sales_cnt,
               sum(ext_sales_price) as sales_amt
        from (select 'store' as channel,
                     'ss_store_sk' as col_name,
                     d_year, d_qoy, i_category,
                     ss_ext_sales_price as ext_sales_price
              from {S}.store_sales, {S}.item, {S}.date_dim
              where ss_store_sk is null
                and ss_sold_date_sk = d_date_sk
                and ss_item_sk = i_item_sk
              union all
              select 'web' as channel,
                     'ws_ship_customer_sk' as col_name,
                     d_year, d_qoy, i_category,
                     ws_ext_sales_price as ext_sales_price
              from {S}.web_sales, {S}.item, {S}.date_dim
              where ws_bill_customer_sk is null
                and ws_sold_date_sk = d_date_sk
                and ws_item_sk = i_item_sk
              union all
              select 'catalog' as channel,
                     'cs_ship_addr_sk' as col_name,
                     d_year, d_qoy, i_category,
                     cs_ext_sales_price as ext_sales_price
              from {S}.catalog_sales, {S}.item, {S}.date_dim
              where cs_ship_addr_sk is null
                and cs_sold_date_sk = d_date_sk
                and cs_item_sk = i_item_sk) foo
        group by channel, col_name, d_year, d_qoy, i_category
        order by channel, col_name, d_year, d_qoy, i_category
        limit 100""",
    # Q44: best/worst performing items by average net profit, ranked
    # ascending and descending against a store-wide baseline
    "q44": f"""
        select asceding.rnk, i1.i_product_name as best_performing,
               i2.i_product_name as worst_performing
        from (select *
              from (select item_sk,
                           rank() over (order by rank_col asc) as rnk
                    from (select ss_item_sk as item_sk,
                                 avg(ss_net_profit) as rank_col
                          from {S}.store_sales ss1
                          where ss_store_sk = 2
                          group by ss_item_sk
                          having avg(ss_net_profit) > 0.9 *
                                 (select avg(ss_net_profit)
                                         as rank_col
                                  from {S}.store_sales
                                  where ss_store_sk = 2
                                    and ss_hdemo_sk is null
                                  group by ss_store_sk)) v1) v11
              where rnk < 11) asceding,
             (select *
              from (select item_sk,
                           rank() over (order by rank_col desc) as rnk
                    from (select ss_item_sk as item_sk,
                                 avg(ss_net_profit) as rank_col
                          from {S}.store_sales ss1
                          where ss_store_sk = 2
                          group by ss_item_sk
                          having avg(ss_net_profit) > 0.9 *
                                 (select avg(ss_net_profit)
                                         as rank_col
                                  from {S}.store_sales
                                  where ss_store_sk = 2
                                    and ss_hdemo_sk is null
                                  group by ss_store_sk)) v2) v21
              where rnk < 11) descending,
             {S}.item i1, {S}.item i2
        where asceding.rnk = descending.rnk
          and i1.i_item_sk = asceding.item_sk
          and i2.i_item_sk = descending.item_sk
        order by asceding.rnk
        limit 100""",
    # Q10: county customers active in store AND (web OR catalog) —
    # the exists-OR-exists shape lowered via mark joins
    "q10": f"""
        select cd_gender, cd_marital_status, cd_education_status,
               count(*) as cnt1,
               cd_purchase_estimate, count(*) as cnt2,
               cd_credit_rating, count(*) as cnt3,
               cd_dep_count, count(*) as cnt4,
               cd_dep_employed_count, count(*) as cnt5,
               cd_dep_college_count, count(*) as cnt6
        from {S}.customer c, {S}.customer_address ca,
             {S}.customer_demographics
        where c.c_current_addr_sk = ca.ca_address_sk
          and ca_county in ('Barrow County', 'Bronx County',
                            'Daviess County', 'Franklin Parish',
                            'Luce County')
          and cd_demo_sk = c.c_current_cdemo_sk
          and exists (select *
                      from {S}.store_sales, {S}.date_dim
                      where c.c_customer_sk = ss_customer_sk
                        and ss_sold_date_sk = d_date_sk
                        and d_year = 2000
                        and d_moy between 1 and 1 + 3)
          and (exists (select *
                       from {S}.web_sales, {S}.date_dim
                       where c.c_customer_sk = ws_bill_customer_sk
                         and ws_sold_date_sk = d_date_sk
                         and d_year = 2000
                         and d_moy between 1 and 1 + 3)
            or exists (select *
                       from {S}.catalog_sales, {S}.date_dim
                       where c.c_customer_sk = cs_ship_customer_sk
                         and cs_sold_date_sk = d_date_sk
                         and d_year = 2000
                         and d_moy between 1 and 1 + 3))
        group by cd_gender, cd_marital_status, cd_education_status,
                 cd_purchase_estimate, cd_credit_rating, cd_dep_count,
                 cd_dep_employed_count, cd_dep_college_count
        order by cd_gender, cd_marital_status, cd_education_status,
                 cd_purchase_estimate, cd_credit_rating, cd_dep_count,
                 cd_dep_employed_count, cd_dep_college_count
        limit 100""",
    # Q35: dependent-count statistics for multi-channel customers
    "q35": f"""
        select ca_state, cd_gender, cd_marital_status, cd_dep_count,
               count(*) as cnt1,
               avg(cd_dep_count) as a1,
               max(cd_dep_count) as m1,
               sum(cd_dep_count) as s1,
               cd_dep_employed_count, count(*) as cnt2,
               avg(cd_dep_employed_count) as a2,
               max(cd_dep_employed_count) as m2,
               sum(cd_dep_employed_count) as s2,
               cd_dep_college_count, count(*) as cnt3,
               avg(cd_dep_college_count) as a3,
               max(cd_dep_college_count) as m3,
               sum(cd_dep_college_count) as s3
        from {S}.customer c, {S}.customer_address ca,
             {S}.customer_demographics
        where c.c_current_addr_sk = ca.ca_address_sk
          and cd_demo_sk = c.c_current_cdemo_sk
          and exists (select *
                      from {S}.store_sales, {S}.date_dim
                      where c.c_customer_sk = ss_customer_sk
                        and ss_sold_date_sk = d_date_sk
                        and d_year = 2000
                        and d_qoy < 4)
          and (exists (select *
                       from {S}.web_sales, {S}.date_dim
                       where c.c_customer_sk = ws_bill_customer_sk
                         and ws_sold_date_sk = d_date_sk
                         and d_year = 2000
                         and d_qoy < 4)
            or exists (select *
                       from {S}.catalog_sales, {S}.date_dim
                       where c.c_customer_sk = cs_ship_customer_sk
                         and cs_sold_date_sk = d_date_sk
                         and d_year = 2000
                         and d_qoy < 4))
        group by ca_state, cd_gender, cd_marital_status, cd_dep_count,
                 cd_dep_employed_count, cd_dep_college_count
        order by ca_state, cd_gender, cd_marital_status, cd_dep_count,
                 cd_dep_employed_count, cd_dep_college_count
        limit 100""",
    # Q69: Q10's twin with NOT EXISTS on the other channels
    "q69": f"""
        select cd_gender, cd_marital_status, cd_education_status,
               count(*) as cnt1,
               cd_purchase_estimate, count(*) as cnt2,
               cd_credit_rating, count(*) as cnt3
        from {S}.customer c, {S}.customer_address ca,
             {S}.customer_demographics
        where c.c_current_addr_sk = ca.ca_address_sk
          and ca_state in ('GA', 'TX', 'MI')
          and cd_demo_sk = c.c_current_cdemo_sk
          and exists (select *
                      from {S}.store_sales, {S}.date_dim
                      where c.c_customer_sk = ss_customer_sk
                        and ss_sold_date_sk = d_date_sk
                        and d_year = 2000
                        and d_moy between 4 and 4 + 2)
          and (not exists (select *
                           from {S}.web_sales, {S}.date_dim
                           where c.c_customer_sk = ws_bill_customer_sk
                             and ws_sold_date_sk = d_date_sk
                             and d_year = 2000
                             and d_moy between 4 and 4 + 2))
          and (not exists (select *
                           from {S}.catalog_sales, {S}.date_dim
                           where c.c_customer_sk = cs_ship_customer_sk
                             and cs_sold_date_sk = d_date_sk
                             and d_year = 2000
                             and d_moy between 4 and 4 + 2))
        group by cd_gender, cd_marital_status, cd_education_status,
                 cd_purchase_estimate, cd_credit_rating
        order by cd_gender, cd_marital_status, cd_education_status,
                 cd_purchase_estimate, cd_credit_rating
        limit 100""",
    # Q74: customer year-over-year net-paid growth, store vs web
    # (four instances of one CTE)
    "q74": f"""
        with year_total as (
          select c_customer_id as customer_id,
                 c_first_name as customer_first_name,
                 c_last_name as customer_last_name,
                 d_year as year_,
                 sum(ss_net_paid) as year_total,
                 's' as sale_type
          from {S}.customer, {S}.store_sales, {S}.date_dim
          where c_customer_sk = ss_customer_sk
            and ss_sold_date_sk = d_date_sk
            and d_year in (1999, 1999 + 1)
          group by c_customer_id, c_first_name, c_last_name, d_year
          union all
          select c_customer_id as customer_id,
                 c_first_name as customer_first_name,
                 c_last_name as customer_last_name,
                 d_year as year_,
                 sum(ws_net_paid) as year_total,
                 'w' as sale_type
          from {S}.customer, {S}.web_sales, {S}.date_dim
          where c_customer_sk = ws_bill_customer_sk
            and ws_sold_date_sk = d_date_sk
            and d_year in (1999, 1999 + 1)
          group by c_customer_id, c_first_name, c_last_name, d_year)
        select t_s_secyear.customer_id,
               t_s_secyear.customer_first_name,
               t_s_secyear.customer_last_name
        from year_total t_s_firstyear, year_total t_s_secyear,
             year_total t_w_firstyear, year_total t_w_secyear
        where t_s_secyear.customer_id = t_s_firstyear.customer_id
          and t_s_firstyear.customer_id = t_w_secyear.customer_id
          and t_s_firstyear.customer_id = t_w_firstyear.customer_id
          and t_s_firstyear.sale_type = 's'
          and t_w_firstyear.sale_type = 'w'
          and t_s_secyear.sale_type = 's'
          and t_w_secyear.sale_type = 'w'
          and t_s_firstyear.year_ = 1999
          and t_s_secyear.year_ = 1999 + 1
          and t_w_firstyear.year_ = 1999
          and t_w_secyear.year_ = 1999 + 1
          and t_s_firstyear.year_total > 0
          and t_w_firstyear.year_total > 0
          and (case when t_w_firstyear.year_total > 0
                    then t_w_secyear.year_total
                         / t_w_firstyear.year_total
                    else null end)
            > (case when t_s_firstyear.year_total > 0
                    then t_s_secyear.year_total
                         / t_s_firstyear.year_total
                    else null end)
        order by 1, 2, 3
        limit 100""",
    # Q75: brand-level net sales count/amount vs prior year across all
    # channels (UNION distinct of per-line sales minus returns)
    "q75": f"""
        with all_sales as (
          select d_year, i_brand_id, i_class_id, i_category_id,
                 i_manufact_id,
                 sum(sales_cnt) as sales_cnt,
                 sum(sales_amt) as sales_amt
          from (select d_year, i_brand_id, i_class_id, i_category_id,
                       i_manufact_id,
                       cs_quantity - coalesce(cr_return_quantity, 0)
                         as sales_cnt,
                       cs_ext_sales_price
                       - coalesce(cr_return_amount, 0.0) as sales_amt
                from {S}.catalog_sales
                     join {S}.item on i_item_sk = cs_item_sk
                     join {S}.date_dim on d_date_sk = cs_sold_date_sk
                     left join {S}.catalog_returns
                       on cs_order_number = cr_order_number
                      and cs_item_sk = cr_item_sk
                where i_category = 'Books'
                union
                select d_year, i_brand_id, i_class_id, i_category_id,
                       i_manufact_id,
                       ss_quantity - coalesce(sr_return_quantity, 0)
                         as sales_cnt,
                       ss_ext_sales_price
                       - coalesce(sr_return_amt, 0.0) as sales_amt
                from {S}.store_sales
                     join {S}.item on i_item_sk = ss_item_sk
                     join {S}.date_dim on d_date_sk = ss_sold_date_sk
                     left join {S}.store_returns
                       on ss_ticket_number = sr_ticket_number
                      and ss_item_sk = sr_item_sk
                where i_category = 'Books'
                union
                select d_year, i_brand_id, i_class_id, i_category_id,
                       i_manufact_id,
                       ws_quantity - coalesce(wr_return_quantity, 0)
                         as sales_cnt,
                       ws_ext_sales_price
                       - coalesce(wr_return_amt, 0.0) as sales_amt
                from {S}.web_sales
                     join {S}.item on i_item_sk = ws_item_sk
                     join {S}.date_dim on d_date_sk = ws_sold_date_sk
                     left join {S}.web_returns
                       on ws_order_number = wr_order_number
                      and ws_item_sk = wr_item_sk
                where i_category = 'Books') sales_detail
          group by d_year, i_brand_id, i_class_id, i_category_id,
                   i_manufact_id)
        select prev_yr.d_year as prev_year,
               curr_yr.d_year as year_,
               curr_yr.i_brand_id,
               curr_yr.i_class_id,
               curr_yr.i_category_id,
               curr_yr.i_manufact_id,
               prev_yr.sales_cnt as prev_yr_cnt,
               curr_yr.sales_cnt as curr_yr_cnt,
               curr_yr.sales_cnt - prev_yr.sales_cnt
                 as sales_cnt_diff,
               curr_yr.sales_amt - prev_yr.sales_amt
                 as sales_amt_diff
        from all_sales curr_yr, all_sales prev_yr
        where curr_yr.i_brand_id = prev_yr.i_brand_id
          and curr_yr.i_class_id = prev_yr.i_class_id
          and curr_yr.i_category_id = prev_yr.i_category_id
          and curr_yr.i_manufact_id = prev_yr.i_manufact_id
          and curr_yr.d_year = 2000
          and prev_yr.d_year = 2000 - 1
          and cast(curr_yr.sales_cnt as decimal(17,2))
              / cast(prev_yr.sales_cnt as decimal(17,2)) < 0.9
        order by sales_cnt_diff, sales_amt_diff
        limit 100""",
    # Q78: store sales with no same-order return, ratioed against the
    # customer-item's other-channel volume
    "q78": f"""
        with ws as (
          select d_year as ws_sold_year, ws_item_sk,
                 ws_bill_customer_sk as ws_customer_sk,
                 sum(ws_quantity) as ws_qty,
                 sum(ws_wholesale_cost) as ws_wc,
                 sum(ws_sales_price) as ws_sp
          from {S}.web_sales
               left join {S}.web_returns
                 on wr_order_number = ws_order_number
                and ws_item_sk = wr_item_sk
               join {S}.date_dim on ws_sold_date_sk = d_date_sk
          where wr_order_number is null
          group by d_year, ws_item_sk, ws_bill_customer_sk),
        cs as (
          select d_year as cs_sold_year, cs_item_sk,
                 cs_bill_customer_sk as cs_customer_sk,
                 sum(cs_quantity) as cs_qty,
                 sum(cs_wholesale_cost) as cs_wc,
                 sum(cs_sales_price) as cs_sp
          from {S}.catalog_sales
               left join {S}.catalog_returns
                 on cr_order_number = cs_order_number
                and cs_item_sk = cr_item_sk
               join {S}.date_dim on cs_sold_date_sk = d_date_sk
          where cr_order_number is null
          group by d_year, cs_item_sk, cs_bill_customer_sk),
        ss as (
          select d_year as ss_sold_year, ss_item_sk,
                 ss_customer_sk,
                 sum(ss_quantity) as ss_qty,
                 sum(ss_wholesale_cost) as ss_wc,
                 sum(ss_sales_price) as ss_sp
          from {S}.store_sales
               left join {S}.store_returns
                 on sr_ticket_number = ss_ticket_number
                and ss_item_sk = sr_item_sk
               join {S}.date_dim on ss_sold_date_sk = d_date_sk
          where sr_ticket_number is null
          group by d_year, ss_item_sk, ss_customer_sk)
        select ss_sold_year, ss_item_sk, ss_customer_sk,
               round(ss_qty / (coalesce(ws_qty, 0)
                               + coalesce(cs_qty, 0) + 1), 2)
                 as ratio,
               ss_qty as store_qty,
               ss_wc as store_wholesale_cost,
               ss_sp as store_sales_price,
               coalesce(ws_qty, 0) + coalesce(cs_qty, 0)
                 as other_chan_qty,
               coalesce(ws_wc, 0) + coalesce(cs_wc, 0)
                 as other_chan_wholesale_cost,
               coalesce(ws_sp, 0) + coalesce(cs_sp, 0)
                 as other_chan_sales_price
        from ss
             left join ws on ws_sold_year = ss_sold_year
                         and ws_item_sk = ss_item_sk
                         and ws_customer_sk = ss_customer_sk
             left join cs on cs_sold_year = ss_sold_year
                         and cs_item_sk = ss_item_sk
                         and cs_customer_sk = ss_customer_sk
        where (coalesce(ws_qty, 0) > 0 or coalesce(cs_qty, 0) > 0)
          and ss_sold_year = 1999
        order by ss_sold_year, ss_item_sk, ss_customer_sk, ss_qty desc,
                 ss_wc desc, ss_sp desc, other_chan_qty,
                 other_chan_wholesale_cost, other_chan_sales_price,
                 ratio
        limit 100""",
    # Q11: customer year-over-year growth, web outpacing store
    # (list-price-minus-discount variant of Q74)
    "q11": f"""
        with year_total as (
          select c_customer_id as customer_id,
                 c_first_name as customer_first_name,
                 c_last_name as customer_last_name,
                 c_preferred_cust_flag,
                 c_birth_country, c_login, c_email_address,
                 d_year as dyear,
                 sum(ss_ext_list_price - ss_ext_discount_amt)
                   as year_total,
                 's' as sale_type
          from {S}.customer, {S}.store_sales, {S}.date_dim
          where c_customer_sk = ss_customer_sk
            and ss_sold_date_sk = d_date_sk
          group by c_customer_id, c_first_name, c_last_name,
                   c_preferred_cust_flag, c_birth_country, c_login,
                   c_email_address, d_year
          union all
          select c_customer_id as customer_id,
                 c_first_name as customer_first_name,
                 c_last_name as customer_last_name,
                 c_preferred_cust_flag,
                 c_birth_country, c_login, c_email_address,
                 d_year as dyear,
                 sum(ws_ext_list_price - ws_ext_discount_amt)
                   as year_total,
                 'w' as sale_type
          from {S}.customer, {S}.web_sales, {S}.date_dim
          where c_customer_sk = ws_bill_customer_sk
            and ws_sold_date_sk = d_date_sk
          group by c_customer_id, c_first_name, c_last_name,
                   c_preferred_cust_flag, c_birth_country, c_login,
                   c_email_address, d_year)
        select t_s_secyear.customer_id,
               t_s_secyear.customer_first_name,
               t_s_secyear.customer_last_name,
               t_s_secyear.c_preferred_cust_flag
        from year_total t_s_firstyear, year_total t_s_secyear,
             year_total t_w_firstyear, year_total t_w_secyear
        where t_s_secyear.customer_id = t_s_firstyear.customer_id
          and t_s_firstyear.customer_id = t_w_secyear.customer_id
          and t_s_firstyear.customer_id = t_w_firstyear.customer_id
          and t_s_firstyear.sale_type = 's'
          and t_w_firstyear.sale_type = 'w'
          and t_s_secyear.sale_type = 's'
          and t_w_secyear.sale_type = 'w'
          and t_s_firstyear.dyear = 1999
          and t_s_secyear.dyear = 1999 + 1
          and t_w_firstyear.dyear = 1999
          and t_w_secyear.dyear = 1999 + 1
          and t_s_firstyear.year_total > 0
          and t_w_firstyear.year_total > 0
          and (case when t_w_firstyear.year_total > 0
                    then t_w_secyear.year_total
                         / t_w_firstyear.year_total
                    else 0.0 end)
            > (case when t_s_firstyear.year_total > 0
                    then t_s_secyear.year_total
                         / t_s_firstyear.year_total
                    else 0.0 end)
        order by t_s_secyear.customer_id,
                 t_s_secyear.customer_first_name,
                 t_s_secyear.customer_last_name,
                 t_s_secyear.c_preferred_cust_flag
        limit 100""",
    # Q32: catalog discounts more than 1.3x the item's 90-day average
    # (correlated scalar over the same fact slice)
    "q32": f"""
        select sum(cs_ext_discount_amt) as excess_discount_amount
        from {S}.catalog_sales, {S}.item, {S}.date_dim
        where i_manufact_id = 77
          and i_item_sk = cs_item_sk
          and d_date between date '1999-01-27'
              and date '1999-01-27' + interval '90' day
          and d_date_sk = cs_sold_date_sk
          and cs_ext_discount_amt >
              (select 1.3 * avg(cs_ext_discount_amt)
               from {S}.catalog_sales, {S}.date_dim
               where cs_item_sk = i_item_sk
                 and d_date between date '1999-01-27'
                     and date '1999-01-27' + interval '90' day
                 and d_date_sk = cs_sold_date_sk)
        limit 100""",
    # Q92: Q32's web twin
    "q92": f"""
        select sum(ws_ext_discount_amt) as excess_discount_amount
        from {S}.web_sales, {S}.item, {S}.date_dim
        where i_manufact_id = 350
          and i_item_sk = ws_item_sk
          and d_date between date '1999-01-27'
              and date '1999-01-27' + interval '90' day
          and d_date_sk = ws_sold_date_sk
          and ws_ext_discount_amt >
              (select 1.3 * avg(ws_ext_discount_amt)
               from {S}.web_sales, {S}.date_dim
               where ws_item_sk = i_item_sk
                 and d_date between date '1999-01-27'
                     and date '1999-01-27' + interval '90' day
                 and d_date_sk = ws_sold_date_sk)
        order by sum(ws_ext_discount_amt)
        limit 100""",
    # Q93: actual sales after subtracting returns for one return reason
    "q93": f"""
        select ss_customer_sk, sum(act_sales) as sumsales
        from (select ss_item_sk, ss_ticket_number, ss_customer_sk,
                     case when sr_return_quantity is not null
                          then (ss_quantity - sr_return_quantity)
                               * ss_sales_price
                          else ss_quantity * ss_sales_price
                     end as act_sales
              from {S}.store_sales
                   left join {S}.store_returns
                     on sr_item_sk = ss_item_sk
                    and sr_ticket_number = ss_ticket_number,
                   {S}.reason
              where sr_reason_sk = r_reason_sk
                and r_reason_desc = 'Does not work') t
        group by ss_customer_sk
        order by sumsales, ss_customer_sk
        limit 100""",
    # Q91: call-center catalog return losses for one demographic slice
    "q91": f"""
        select cc_call_center_id as call_center,
               cc_name as call_center_name,
               cc_manager as manager,
               sum(cr_net_loss) as returns_loss
        from {S}.call_center, {S}.catalog_returns, {S}.date_dim,
             {S}.customer, {S}.customer_address,
             {S}.customer_demographics, {S}.household_demographics
        where cr_call_center_sk = cc_call_center_sk
          and cr_returned_date_sk = d_date_sk
          and cr_returning_customer_sk = c_customer_sk
          and cd_demo_sk = c_current_cdemo_sk
          and hd_demo_sk = c_current_hdemo_sk
          and ca_address_sk = c_current_addr_sk
          and d_year = 1998
          and d_moy = 11
          and ((cd_marital_status = 'M'
                and cd_education_status = 'Unknown')
            or (cd_marital_status = 'W'
                and cd_education_status = 'Advanced Degree'))
          and hd_buy_potential like '0-500%'
          and ca_gmt_offset = -6
        group by cc_call_center_id, cc_name, cc_manager,
                 cd_marital_status, cd_education_status
        order by sum(cr_net_loss) desc""",
    # Q84: income-band customers with store returns (six-way dimension
    # chain, || name assembly)
    "q84": f"""
        select c_customer_id as customer_id,
               coalesce(c_last_name, '') || ', '
               || coalesce(c_first_name, '') as customername
        from {S}.customer, {S}.customer_address,
             {S}.customer_demographics, {S}.household_demographics,
             {S}.income_band, {S}.store_returns
        where ca_city = 'Fairview'
          and c_current_addr_sk = ca_address_sk
          and ib_lower_bound >= 38128
          and ib_upper_bound <= 38128 + 50000
          and ib_income_band_sk = hd_income_band_sk
          and cd_demo_sk = c_current_cdemo_sk
          and hd_demo_sk = c_current_hdemo_sk
          and sr_cdemo_sk = cd_demo_sk
        order by c_customer_id
        limit 100""",
    # Q33: manufacturer revenue across all three channels for one
    # category's items, spliced by UNION ALL
    "q33": f"""
        with ss as (
          select i_manufact_id,
                 sum(ss_ext_sales_price) as total_sales
          from {S}.store_sales, {S}.date_dim, {S}.customer_address,
               {S}.item
          where i_manufact_id in (select i_manufact_id
                                  from {S}.item
                                  where i_category in ('Electronics'))
            and ss_item_sk = i_item_sk
            and ss_sold_date_sk = d_date_sk
            and d_year = 1998
            and d_moy = 5
            and ss_addr_sk = ca_address_sk
            and ca_gmt_offset = -5
          group by i_manufact_id),
        cs as (
          select i_manufact_id,
                 sum(cs_ext_sales_price) as total_sales
          from {S}.catalog_sales, {S}.date_dim,
               {S}.customer_address, {S}.item
          where i_manufact_id in (select i_manufact_id
                                  from {S}.item
                                  where i_category in ('Electronics'))
            and cs_item_sk = i_item_sk
            and cs_sold_date_sk = d_date_sk
            and d_year = 1998
            and d_moy = 5
            and cs_bill_addr_sk = ca_address_sk
            and ca_gmt_offset = -5
          group by i_manufact_id),
        ws as (
          select i_manufact_id,
                 sum(ws_ext_sales_price) as total_sales
          from {S}.web_sales, {S}.date_dim, {S}.customer_address,
               {S}.item
          where i_manufact_id in (select i_manufact_id
                                  from {S}.item
                                  where i_category in ('Electronics'))
            and ws_item_sk = i_item_sk
            and ws_sold_date_sk = d_date_sk
            and d_year = 1998
            and d_moy = 5
            and ws_bill_addr_sk = ca_address_sk
            and ca_gmt_offset = -5
          group by i_manufact_id)
        select i_manufact_id, sum(total_sales) as total_sales
        from (select * from ss
              union all
              select * from cs
              union all
              select * from ws) tmp1
        group by i_manufact_id
        order by total_sales, i_manufact_id
        limit 100""",
    # Q56: Q33's shape keyed by item id over a color slice
    "q56": f"""
        with ss as (
          select i_item_id,
                 sum(ss_ext_sales_price) as total_sales
          from {S}.store_sales, {S}.date_dim, {S}.customer_address,
               {S}.item
          where i_item_id in (select i_item_id
                              from {S}.item
                              where i_color in ('slate', 'blanched',
                                                'burnished'))
            and ss_item_sk = i_item_sk
            and ss_sold_date_sk = d_date_sk
            and d_year = 2000
            and d_moy = 2
            and ss_addr_sk = ca_address_sk
            and ca_gmt_offset = -5
          group by i_item_id),
        cs as (
          select i_item_id,
                 sum(cs_ext_sales_price) as total_sales
          from {S}.catalog_sales, {S}.date_dim,
               {S}.customer_address, {S}.item
          where i_item_id in (select i_item_id
                              from {S}.item
                              where i_color in ('slate', 'blanched',
                                                'burnished'))
            and cs_item_sk = i_item_sk
            and cs_sold_date_sk = d_date_sk
            and d_year = 2000
            and d_moy = 2
            and cs_bill_addr_sk = ca_address_sk
            and ca_gmt_offset = -5
          group by i_item_id),
        ws as (
          select i_item_id,
                 sum(ws_ext_sales_price) as total_sales
          from {S}.web_sales, {S}.date_dim, {S}.customer_address,
               {S}.item
          where i_item_id in (select i_item_id
                              from {S}.item
                              where i_color in ('slate', 'blanched',
                                                'burnished'))
            and ws_item_sk = i_item_sk
            and ws_sold_date_sk = d_date_sk
            and d_year = 2000
            and d_moy = 2
            and ws_bill_addr_sk = ca_address_sk
            and ca_gmt_offset = -5
          group by i_item_id)
        select i_item_id, sum(total_sales) as total_sales
        from (select * from ss
              union all
              select * from cs
              union all
              select * from ws) tmp1
        group by i_item_id
        order by total_sales
        limit 100""",
    # Q60: Q33's shape keyed by item id over a category slice
    "q60": f"""
        with ss as (
          select i_item_id,
                 sum(ss_ext_sales_price) as total_sales
          from {S}.store_sales, {S}.date_dim, {S}.customer_address,
               {S}.item
          where i_item_id in (select i_item_id
                              from {S}.item
                              where i_category in ('Music'))
            and ss_item_sk = i_item_sk
            and ss_sold_date_sk = d_date_sk
            and d_year = 1998
            and d_moy = 9
            and ss_addr_sk = ca_address_sk
            and ca_gmt_offset = -5
          group by i_item_id),
        cs as (
          select i_item_id,
                 sum(cs_ext_sales_price) as total_sales
          from {S}.catalog_sales, {S}.date_dim,
               {S}.customer_address, {S}.item
          where i_item_id in (select i_item_id
                              from {S}.item
                              where i_category in ('Music'))
            and cs_item_sk = i_item_sk
            and cs_sold_date_sk = d_date_sk
            and d_year = 1998
            and d_moy = 9
            and cs_bill_addr_sk = ca_address_sk
            and ca_gmt_offset = -5
          group by i_item_id),
        ws as (
          select i_item_id,
                 sum(ws_ext_sales_price) as total_sales
          from {S}.web_sales, {S}.date_dim, {S}.customer_address,
               {S}.item
          where i_item_id in (select i_item_id
                              from {S}.item
                              where i_category in ('Music'))
            and ws_item_sk = i_item_sk
            and ws_sold_date_sk = d_date_sk
            and d_year = 1998
            and d_moy = 9
            and ws_bill_addr_sk = ca_address_sk
            and ca_gmt_offset = -5
          group by i_item_id)
        select i_item_id, sum(total_sales) as total_sales
        from (select * from ss
              union all
              select * from cs
              union all
              select * from ws) tmp1
        group by i_item_id
        order by i_item_id, total_sales
        limit 100""",
    # Q9: five quantity buckets choosing avg(discount) vs avg(net_paid)
    # by a count threshold — 15 uncorrelated scalar subqueries in CASE
    "q9": f"""
        select case when (select count(*)
                          from {S}.store_sales
                          where ss_quantity between 1 and 20) > 10000
                    then (select avg(ss_ext_discount_amt)
                          from {S}.store_sales
                          where ss_quantity between 1 and 20)
                    else (select avg(ss_net_paid)
                          from {S}.store_sales
                          where ss_quantity between 1 and 20)
               end as bucket1,
               case when (select count(*)
                          from {S}.store_sales
                          where ss_quantity between 21 and 40) > 15000
                    then (select avg(ss_ext_discount_amt)
                          from {S}.store_sales
                          where ss_quantity between 21 and 40)
                    else (select avg(ss_net_paid)
                          from {S}.store_sales
                          where ss_quantity between 21 and 40)
               end as bucket2,
               case when (select count(*)
                          from {S}.store_sales
                          where ss_quantity between 41 and 60) > 5000
                    then (select avg(ss_ext_discount_amt)
                          from {S}.store_sales
                          where ss_quantity between 41 and 60)
                    else (select avg(ss_net_paid)
                          from {S}.store_sales
                          where ss_quantity between 41 and 60)
               end as bucket3,
               case when (select count(*)
                          from {S}.store_sales
                          where ss_quantity between 61 and 80) > 20000
                    then (select avg(ss_ext_discount_amt)
                          from {S}.store_sales
                          where ss_quantity between 61 and 80)
                    else (select avg(ss_net_paid)
                          from {S}.store_sales
                          where ss_quantity between 61 and 80)
               end as bucket4,
               case when (select count(*)
                          from {S}.store_sales
                          where ss_quantity between 81 and 100) > 1000
                    then (select avg(ss_ext_discount_amt)
                          from {S}.store_sales
                          where ss_quantity between 81 and 100)
                    else (select avg(ss_net_paid)
                          from {S}.store_sales
                          where ss_quantity between 81 and 100)
               end as bucket5
        from {S}.reason
        where r_reason_sk = 1""",
    # Q13: store demographic/geography averages with OR'd filter blocks
    "q13": f"""
        select avg(ss_quantity) as a1,
               avg(ss_ext_sales_price) as a2,
               avg(ss_ext_wholesale_cost) as a3,
               sum(ss_ext_wholesale_cost) as s1
        from {S}.store_sales, {S}.store, {S}.customer_demographics,
             {S}.household_demographics, {S}.customer_address,
             {S}.date_dim
        where s_store_sk = ss_store_sk
          and ss_sold_date_sk = d_date_sk
          and d_year = 1999
          and ((ss_hdemo_sk = hd_demo_sk
                and cd_demo_sk = ss_cdemo_sk
                and cd_marital_status = 'M'
                and cd_education_status = 'Advanced Degree'
                and ss_sales_price between 10 and 60
                and hd_dep_count = 3)
            or (ss_hdemo_sk = hd_demo_sk
                and cd_demo_sk = ss_cdemo_sk
                and cd_marital_status = 'S'
                and cd_education_status = 'College'
                and ss_sales_price between 20 and 80
                and hd_dep_count = 1)
            or (ss_hdemo_sk = hd_demo_sk
                and cd_demo_sk = ss_cdemo_sk
                and cd_marital_status = 'W'
                and cd_education_status = '2 yr Degree'
                and ss_sales_price between 30 and 90
                and hd_dep_count = 1))
          and ((ss_addr_sk = ca_address_sk
                and ca_country = 'United States'
                and ca_state in ('TX', 'OH', 'TX')
                and ss_net_profit between 100 and 200)
            or (ss_addr_sk = ca_address_sk
                and ca_country = 'United States'
                and ca_state in ('OR', 'NM', 'KY')
                and ss_net_profit between 150 and 300)
            or (ss_addr_sk = ca_address_sk
                and ca_country = 'United States'
                and ca_state in ('VA', 'TX', 'MS')
                and ss_net_profit between 50 and 250))""",
    # Q16: shipped-from-multiple-warehouses catalog orders without
    # returns (Q94's catalog twin)
    "q16": f"""
        select count(distinct cs_order_number) as order_count,
               sum(cs_ext_ship_cost) as total_shipping_cost,
               sum(cs_net_profit) as total_net_profit
        from {S}.catalog_sales cs1, {S}.date_dim,
             {S}.customer_address, {S}.call_center
        where d_date between date '1999-02-01'
              and date '1999-02-01' + interval '60' day
          and cs1.cs_ship_date_sk = d_date_sk
          and cs1.cs_ship_addr_sk = ca_address_sk
          and ca_state = 'GA'
          and cs1.cs_call_center_sk = cc_call_center_sk
          and cc_county in ('Barrow County', 'Bronx County',
                            'Daviess County', 'Luce County',
                            'Mobile County')
          and exists (select *
                      from {S}.catalog_sales cs2
                      where cs1.cs_order_number = cs2.cs_order_number
                        and cs1.cs_warehouse_sk <> cs2.cs_warehouse_sk)
          and not exists (select *
                          from {S}.catalog_returns cr1
                          where cs1.cs_order_number
                                = cr1.cr_order_number)
        order by count(distinct cs_order_number)
        limit 100""",
    # Q17: quantity statistics (count/avg/stddev + coefficient of
    # variation) across the sale->return->catalog-repurchase triangle
    "q17": f"""
        select i_item_id, i_item_desc, s_state,
               count(ss_quantity) as store_sales_quantitycount,
               avg(ss_quantity) as store_sales_quantityave,
               stddev_samp(ss_quantity) as store_sales_quantitystdev,
               stddev_samp(ss_quantity) / avg(ss_quantity)
                 as store_sales_quantitycov,
               count(sr_return_quantity) as store_returns_quantitycount,
               avg(sr_return_quantity) as store_returns_quantityave,
               stddev_samp(sr_return_quantity)
                 as store_returns_quantitystdev,
               stddev_samp(sr_return_quantity)
               / avg(sr_return_quantity) as store_returns_quantitycov,
               count(cs_quantity) as catalog_sales_quantitycount,
               avg(cs_quantity) as catalog_sales_quantityave,
               stddev_samp(cs_quantity) as catalog_sales_quantitystdev,
               stddev_samp(cs_quantity) / avg(cs_quantity)
                 as catalog_sales_quantitycov
        from {S}.store_sales, {S}.store_returns, {S}.catalog_sales,
             {S}.date_dim d1, {S}.date_dim d2, {S}.date_dim d3,
             {S}.store, {S}.item
        where d1.d_quarter_name = '2000Q1'
          and d1.d_date_sk = ss_sold_date_sk
          and i_item_sk = ss_item_sk
          and s_store_sk = ss_store_sk
          and ss_customer_sk = sr_customer_sk
          and ss_item_sk = sr_item_sk
          and ss_ticket_number = sr_ticket_number
          and sr_returned_date_sk = d2.d_date_sk
          and d2.d_quarter_name in ('2000Q1', '2000Q2', '2000Q3')
          and sr_customer_sk = cs_bill_customer_sk
          and sr_item_sk = cs_item_sk
          and cs_sold_date_sk = d3.d_date_sk
          and d3.d_quarter_name in ('2000Q1', '2000Q2', '2000Q3')
        group by i_item_id, i_item_desc, s_state
        order by i_item_id, i_item_desc, s_state
        limit 100""",
    # Q29: quantity averages over the same triangle, three-year window
    "q29": f"""
        select i_item_id, i_item_desc, s_store_id, s_store_name,
               avg(ss_quantity) as store_sales_quantity,
               avg(sr_return_quantity) as store_returns_quantity,
               avg(cs_quantity) as catalog_sales_quantity
        from {S}.store_sales, {S}.store_returns, {S}.catalog_sales,
             {S}.date_dim d1, {S}.date_dim d2, {S}.date_dim d3,
             {S}.store, {S}.item
        where d1.d_moy = 4
          and d1.d_year = 1999
          and d1.d_date_sk = ss_sold_date_sk
          and i_item_sk = ss_item_sk
          and s_store_sk = ss_store_sk
          and ss_customer_sk = sr_customer_sk
          and ss_item_sk = sr_item_sk
          and ss_ticket_number = sr_ticket_number
          and sr_returned_date_sk = d2.d_date_sk
          and d2.d_moy between 4 and 4 + 3
          and d2.d_year = 1999
          and sr_customer_sk = cs_bill_customer_sk
          and sr_item_sk = cs_item_sk
          and cs_sold_date_sk = d3.d_date_sk
          and d3.d_year in (1999, 1999 + 1, 1999 + 2)
        group by i_item_id, i_item_desc, s_store_id, s_store_name
        order by i_item_id, i_item_desc, s_store_id, s_store_name
        limit 100""",
    # Q30: customers returning more than 1.2x their state's average
    # web-return total (correlated scalar over the CTE)
    "q30": f"""
        with customer_total_return as (
          select wr_returning_customer_sk as ctr_customer_sk,
                 ca_state as ctr_state,
                 sum(wr_return_amt) as ctr_total_return
          from {S}.web_returns, {S}.date_dim, {S}.customer_address
          where wr_returned_date_sk = d_date_sk
            and d_year = 2000
            and wr_returning_addr_sk = ca_address_sk
          group by wr_returning_customer_sk, ca_state)
        select c_customer_id, c_salutation, c_first_name, c_last_name,
               c_preferred_cust_flag, c_birth_day, c_birth_month,
               c_birth_year, c_birth_country, c_login,
               c_email_address, c_last_review_date_sk,
               ctr_total_return
        from customer_total_return ctr1, {S}.customer_address,
             {S}.customer
        where ctr1.ctr_total_return >
              (select avg(ctr_total_return) * 1.2
               from customer_total_return ctr2
               where ctr1.ctr_state = ctr2.ctr_state)
          and ca_address_sk = c_current_addr_sk
          and ca_state = 'GA'
          and ctr1.ctr_customer_sk = c_customer_sk
        order by c_customer_id, c_salutation, c_first_name,
                 c_last_name, c_preferred_cust_flag, c_birth_day,
                 c_birth_month, c_birth_year, c_birth_country,
                 c_login, c_email_address, c_last_review_date_sk,
                 ctr_total_return
        limit 100""",
    # Q81: Q30's catalog twin with the full return address in the output
    "q81": f"""
        with customer_total_return as (
          select cr_returning_customer_sk as ctr_customer_sk,
                 ca_state as ctr_state,
                 sum(cr_return_amount) as ctr_total_return
          from {S}.catalog_returns, {S}.date_dim,
               {S}.customer_address
          where cr_returned_date_sk = d_date_sk
            and d_year = 2000
            and cr_returning_addr_sk = ca_address_sk
          group by cr_returning_customer_sk, ca_state)
        select c_customer_id, c_salutation, c_first_name, c_last_name,
               ca_street_number, ca_street_name, ca_street_type,
               ca_suite_number, ca_city, ca_county, ca_state, ca_zip,
               ca_country, ca_gmt_offset, ca_location_type,
               ctr_total_return
        from customer_total_return ctr1, {S}.customer_address,
             {S}.customer
        where ctr1.ctr_total_return >
              (select avg(ctr_total_return) * 1.2
               from customer_total_return ctr2
               where ctr1.ctr_state = ctr2.ctr_state)
          and ca_address_sk = c_current_addr_sk
          and ca_state = 'GA'
          and ctr1.ctr_customer_sk = c_customer_sk
        order by c_customer_id, c_salutation, c_first_name,
                 c_last_name, ca_street_number, ca_street_name,
                 ca_street_type, ca_suite_number, ca_city, ca_county,
                 ca_state, ca_zip, ca_country, ca_gmt_offset,
                 ca_location_type, ctr_total_return
        limit 100""",
    # Q88: eight half-hour store traffic counts cross-joined
    "q88": f"""
        select * from
          (select count(*) as h8_30_to_9
           from {S}.store_sales, {S}.household_demographics,
                {S}.time_dim, {S}.store
           where ss_sold_time_sk = t_time_sk
             and ss_hdemo_sk = hd_demo_sk
             and ss_store_sk = s_store_sk
             and t_hour = 8 and t_minute >= 30
             and ((hd_dep_count = 4 and hd_vehicle_count <= 4 + 2)
               or (hd_dep_count = 2 and hd_vehicle_count <= 2 + 2)
               or (hd_dep_count = 0 and hd_vehicle_count <= 0 + 2))
             and s_store_name = 'ese') s1,
          (select count(*) as h9_to_9_30
           from {S}.store_sales, {S}.household_demographics,
                {S}.time_dim, {S}.store
           where ss_sold_time_sk = t_time_sk
             and ss_hdemo_sk = hd_demo_sk
             and ss_store_sk = s_store_sk
             and t_hour = 9 and t_minute < 30
             and ((hd_dep_count = 4 and hd_vehicle_count <= 4 + 2)
               or (hd_dep_count = 2 and hd_vehicle_count <= 2 + 2)
               or (hd_dep_count = 0 and hd_vehicle_count <= 0 + 2))
             and s_store_name = 'ese') s2,
          (select count(*) as h9_30_to_10
           from {S}.store_sales, {S}.household_demographics,
                {S}.time_dim, {S}.store
           where ss_sold_time_sk = t_time_sk
             and ss_hdemo_sk = hd_demo_sk
             and ss_store_sk = s_store_sk
             and t_hour = 9 and t_minute >= 30
             and ((hd_dep_count = 4 and hd_vehicle_count <= 4 + 2)
               or (hd_dep_count = 2 and hd_vehicle_count <= 2 + 2)
               or (hd_dep_count = 0 and hd_vehicle_count <= 0 + 2))
             and s_store_name = 'ese') s3,
          (select count(*) as h10_to_10_30
           from {S}.store_sales, {S}.household_demographics,
                {S}.time_dim, {S}.store
           where ss_sold_time_sk = t_time_sk
             and ss_hdemo_sk = hd_demo_sk
             and ss_store_sk = s_store_sk
             and t_hour = 10 and t_minute < 30
             and ((hd_dep_count = 4 and hd_vehicle_count <= 4 + 2)
               or (hd_dep_count = 2 and hd_vehicle_count <= 2 + 2)
               or (hd_dep_count = 0 and hd_vehicle_count <= 0 + 2))
             and s_store_name = 'ese') s4,
          (select count(*) as h10_30_to_11
           from {S}.store_sales, {S}.household_demographics,
                {S}.time_dim, {S}.store
           where ss_sold_time_sk = t_time_sk
             and ss_hdemo_sk = hd_demo_sk
             and ss_store_sk = s_store_sk
             and t_hour = 10 and t_minute >= 30
             and ((hd_dep_count = 4 and hd_vehicle_count <= 4 + 2)
               or (hd_dep_count = 2 and hd_vehicle_count <= 2 + 2)
               or (hd_dep_count = 0 and hd_vehicle_count <= 0 + 2))
             and s_store_name = 'ese') s5,
          (select count(*) as h11_to_11_30
           from {S}.store_sales, {S}.household_demographics,
                {S}.time_dim, {S}.store
           where ss_sold_time_sk = t_time_sk
             and ss_hdemo_sk = hd_demo_sk
             and ss_store_sk = s_store_sk
             and t_hour = 11 and t_minute < 30
             and ((hd_dep_count = 4 and hd_vehicle_count <= 4 + 2)
               or (hd_dep_count = 2 and hd_vehicle_count <= 2 + 2)
               or (hd_dep_count = 0 and hd_vehicle_count <= 0 + 2))
             and s_store_name = 'ese') s6,
          (select count(*) as h11_30_to_12
           from {S}.store_sales, {S}.household_demographics,
                {S}.time_dim, {S}.store
           where ss_sold_time_sk = t_time_sk
             and ss_hdemo_sk = hd_demo_sk
             and ss_store_sk = s_store_sk
             and t_hour = 11 and t_minute >= 30
             and ((hd_dep_count = 4 and hd_vehicle_count <= 4 + 2)
               or (hd_dep_count = 2 and hd_vehicle_count <= 2 + 2)
               or (hd_dep_count = 0 and hd_vehicle_count <= 0 + 2))
             and s_store_name = 'ese') s7,
          (select count(*) as h12_to_12_30
           from {S}.store_sales, {S}.household_demographics,
                {S}.time_dim, {S}.store
           where ss_sold_time_sk = t_time_sk
             and ss_hdemo_sk = hd_demo_sk
             and ss_store_sk = s_store_sk
             and t_hour = 12 and t_minute < 30
             and ((hd_dep_count = 4 and hd_vehicle_count <= 4 + 2)
               or (hd_dep_count = 2 and hd_vehicle_count <= 2 + 2)
               or (hd_dep_count = 0 and hd_vehicle_count <= 0 + 2))
             and s_store_name = 'ese') s8""",
    # Q90: morning/evening web traffic ratio
    "q90": f"""
        select cast(amc as decimal(15,4)) / cast(pmc as decimal(15,4))
                 as am_pm_ratio
        from (select count(*) as amc
              from {S}.web_sales, {S}.household_demographics,
                   {S}.time_dim, {S}.web_page
              where ws_sold_time_sk = t_time_sk
                and ws_ship_hdemo_sk = hd_demo_sk
                and ws_web_page_sk = wp_web_page_sk
                and t_hour between 8 and 8 + 1
                and hd_dep_count = 6
                and wp_char_count between 5000 and 5200) at_,
             (select count(*) as pmc
              from {S}.web_sales, {S}.household_demographics,
                   {S}.time_dim, {S}.web_page
              where ws_sold_time_sk = t_time_sk
                and ws_ship_hdemo_sk = hd_demo_sk
                and ws_web_page_sk = wp_web_page_sk
                and t_hour between 19 and 19 + 1
                and hd_dep_count = 6
                and wp_char_count between 5000 and 5200) pt
        order by am_pm_ratio
        limit 100""",
    # Q96: half-hour store traffic count for one dep-count slice
    "q96": f"""
        select count(*) as cnt
        from {S}.store_sales, {S}.household_demographics,
             {S}.time_dim, {S}.store
        where ss_sold_time_sk = t_time_sk
          and ss_hdemo_sk = hd_demo_sk
          and ss_store_sk = s_store_sk
          and t_hour = 20
          and t_minute >= 30
          and hd_dep_count = 7
          and s_store_name = 'ese'
        order by count(*)
        limit 100""",
    # Q2: web+catalog weekly day-name sums, year-over-year ratio via a
    # 53-week-shifted self-join of the same CTE
    "q2": f"""
        with wscs as (
          select sold_date_sk, sales_price
          from (select ws_sold_date_sk as sold_date_sk,
                       ws_ext_sales_price as sales_price
                from {S}.web_sales
                union all
                select cs_sold_date_sk as sold_date_sk,
                       cs_ext_sales_price as sales_price
                from {S}.catalog_sales) x),
        wswscs as (
          select d_week_seq,
                 sum(case when d_day_name = 'Sunday'
                     then sales_price else null end) as sun_sales,
                 sum(case when d_day_name = 'Monday'
                     then sales_price else null end) as mon_sales,
                 sum(case when d_day_name = 'Tuesday'
                     then sales_price else null end) as tue_sales,
                 sum(case when d_day_name = 'Wednesday'
                     then sales_price else null end) as wed_sales,
                 sum(case when d_day_name = 'Thursday'
                     then sales_price else null end) as thu_sales,
                 sum(case when d_day_name = 'Friday'
                     then sales_price else null end) as fri_sales,
                 sum(case when d_day_name = 'Saturday'
                     then sales_price else null end) as sat_sales
          from wscs, {S}.date_dim
          where d_date_sk = sold_date_sk
          group by d_week_seq)
        select d_week_seq1,
               round(sun_sales1 / sun_sales2, 2) as r_sun,
               round(mon_sales1 / mon_sales2, 2) as r_mon,
               round(tue_sales1 / tue_sales2, 2) as r_tue,
               round(wed_sales1 / wed_sales2, 2) as r_wed,
               round(thu_sales1 / thu_sales2, 2) as r_thu,
               round(fri_sales1 / fri_sales2, 2) as r_fri,
               round(sat_sales1 / sat_sales2, 2) as r_sat
        from (select wswscs.d_week_seq as d_week_seq1,
                     sun_sales as sun_sales1, mon_sales as mon_sales1,
                     tue_sales as tue_sales1, wed_sales as wed_sales1,
                     thu_sales as thu_sales1, fri_sales as fri_sales1,
                     sat_sales as sat_sales1
              from wswscs, {S}.date_dim
              where date_dim.d_week_seq = wswscs.d_week_seq
                and d_year = 1999) y,
             (select wswscs.d_week_seq as d_week_seq2,
                     sun_sales as sun_sales2, mon_sales as mon_sales2,
                     tue_sales as tue_sales2, wed_sales as wed_sales2,
                     thu_sales as thu_sales2, fri_sales as fri_sales2,
                     sat_sales as sat_sales2
              from wswscs, {S}.date_dim
              where date_dim.d_week_seq = wswscs.d_week_seq
                and d_year = 2000) z
        where d_week_seq1 = d_week_seq2 - 53
        order by d_week_seq1""",
    # Q25: store sale -> store return -> catalog repurchase profit
    # triangle over three date windows
    "q25": f"""
        select i_item_id, i_item_desc, s_store_id, s_store_name,
               sum(ss_net_profit) as store_sales_profit,
               sum(sr_net_loss) as store_returns_loss,
               sum(cs_net_profit) as catalog_sales_profit
        from {S}.store_sales, {S}.store_returns, {S}.catalog_sales,
             {S}.date_dim d1, {S}.date_dim d2, {S}.date_dim d3,
             {S}.store, {S}.item
        where d1.d_moy = 4
          and d1.d_year = 2000
          and d1.d_date_sk = ss_sold_date_sk
          and i_item_sk = ss_item_sk
          and s_store_sk = ss_store_sk
          and ss_customer_sk = sr_customer_sk
          and ss_item_sk = sr_item_sk
          and ss_ticket_number = sr_ticket_number
          and sr_returned_date_sk = d2.d_date_sk
          and d2.d_moy between 4 and 10
          and d2.d_year = 2000
          and sr_customer_sk = cs_bill_customer_sk
          and sr_item_sk = cs_item_sk
          and cs_sold_date_sk = d3.d_date_sk
          and d3.d_moy between 4 and 10
          and d3.d_year = 2000
        group by i_item_id, i_item_desc, s_store_id, s_store_name
        order by i_item_id, i_item_desc, s_store_id, s_store_name
        limit 100""",
    # Q28: six cross-joined single-row buckets of list-price stats
    # incl. count(distinct) per bucket (bounds fitted to the
    # generator's price domains)
    "q28": f"""
        select * from
          (select avg(ss_list_price) as b1_lp,
                  count(ss_list_price) as b1_cnt,
                  count(distinct ss_list_price) as b1_cntd
           from {S}.store_sales
           where ss_quantity between 0 and 5
             and (ss_list_price between 8 and 18
                  or ss_coupon_amt between 2 and 12
                  or ss_wholesale_cost between 57 and 77)) b1,
          (select avg(ss_list_price) as b2_lp,
                  count(ss_list_price) as b2_cnt,
                  count(distinct ss_list_price) as b2_cntd
           from {S}.store_sales
           where ss_quantity between 6 and 10
             and (ss_list_price between 90 and 100
                  or ss_coupon_amt between 4 and 14
                  or ss_wholesale_cost between 31 and 51)) b2,
          (select avg(ss_list_price) as b3_lp,
                  count(ss_list_price) as b3_cnt,
                  count(distinct ss_list_price) as b3_cntd
           from {S}.store_sales
           where ss_quantity between 11 and 15
             and (ss_list_price between 142 and 152
                  or ss_coupon_amt between 6 and 16
                  or ss_wholesale_cost between 80 and 100)) b3,
          (select avg(ss_list_price) as b4_lp,
                  count(ss_list_price) as b4_cnt,
                  count(distinct ss_list_price) as b4_cntd
           from {S}.store_sales
           where ss_quantity between 16 and 20
             and (ss_list_price between 135 and 145
                  or ss_coupon_amt between 8 and 18
                  or ss_wholesale_cost between 38 and 58)) b4,
          (select avg(ss_list_price) as b5_lp,
                  count(ss_list_price) as b5_cnt,
                  count(distinct ss_list_price) as b5_cntd
           from {S}.store_sales
           where ss_quantity between 21 and 25
             and (ss_list_price between 122 and 132
                  or ss_coupon_amt between 10 and 20
                  or ss_wholesale_cost between 17 and 37)) b5,
          (select avg(ss_list_price) as b6_lp,
                  count(ss_list_price) as b6_cnt,
                  count(distinct ss_list_price) as b6_cntd
           from {S}.store_sales
           where ss_quantity between 26 and 30
             and (ss_list_price between 154 and 164
                  or ss_coupon_amt between 1 and 11
                  or ss_wholesale_cost between 7 and 27)) b6
        limit 100""",
    # Q34: month-end bulk shoppers by ticket (count range fitted to
    # the generator's 1-4 lines per ticket vs the official 15-20)
    "q34": f"""
        select c_last_name, c_first_name, c_salutation,
               c_preferred_cust_flag, ss_ticket_number, cnt
        from (select ss_ticket_number, ss_customer_sk, count(*) as cnt
              from {S}.store_sales, {S}.date_dim, {S}.store,
                   {S}.household_demographics
              where ss_sold_date_sk = d_date_sk
                and ss_store_sk = s_store_sk
                and ss_hdemo_sk = hd_demo_sk
                and (d_dom between 1 and 3 or d_dom between 25 and 28)
                and (hd_buy_potential = '>10000'
                     or hd_buy_potential = 'Unknown')
                and hd_vehicle_count > 0
                and (case when hd_vehicle_count > 0
                     then hd_dep_count / hd_vehicle_count
                     else null end) > 1.2
                and d_year in (1998, 1999, 2000)
                and s_county in ('Barrow County', 'Bronx County',
                                 'Daviess County', 'Luce County')
              group by ss_ticket_number, ss_customer_sk) dn,
             {S}.customer
        where ss_customer_sk = c_customer_sk
          and cnt between 2 and 4
        order by c_last_name, c_first_name, c_salutation,
                 c_preferred_cust_flag desc, ss_ticket_number""",
    # Q41: manufacturers with qualifying size/color/unit combos — a
    # correlated count subquery over the same dimension
    "q41": f"""
        select distinct i_product_name
        from {S}.item i1
        where i_manufact_id between 700 and 740
          and (select count(*) as item_cnt
               from {S}.item
               where i_manufact = i1.i_manufact
                  and (((i_category = 'Women'
                        and (i_color = 'powder' or i_color = 'khaki')
                        and (i_units = 'Each' or i_units = 'Oz')
                        and (i_size = 'medium'
                             or i_size = 'extra large'))
                    or (i_category = 'Women'
                        and (i_color = 'brown' or i_color = 'honeydew')
                        and (i_units = 'Bunch' or i_units = 'Carton')
                        and (i_size = 'N/A' or i_size = 'small'))
                    or (i_category = 'Men'
                        and (i_color = 'floral' or i_color = 'deep')
                        and (i_units = 'Case' or i_units = 'Dozen')
                        and (i_size = 'petite' or i_size = 'large'))
                    or (i_category = 'Men'
                        and (i_color = 'light' or i_color = 'cornflower')
                        and (i_units = 'Unknown' or i_units = 'Pound')
                        and (i_size = 'medium'
                             or i_size = 'extra large')))
                  or ((i_category = 'Women'
                        and (i_color = 'midnight' or i_color = 'snow')
                        and (i_units = 'Pound' or i_units = 'Bunch')
                        and (i_size = 'medium'
                             or i_size = 'extra large'))
                    or (i_category = 'Women'
                        and (i_color = 'cyan' or i_color = 'papaya')
                        and (i_units = 'Carton' or i_units = 'Oz')
                        and (i_size = 'N/A' or i_size = 'small'))
                    or (i_category = 'Men'
                        and (i_color = 'orange' or i_color = 'frosted')
                        and (i_units = 'Each' or i_units = 'Case')
                        and (i_size = 'petite' or i_size = 'large'))
                    or (i_category = 'Men'
                        and (i_color = 'forest' or i_color = 'ghost')
                        and (i_units = 'Dozen' or i_units = 'Bunch')
                        and (i_size = 'medium'
                             or i_size = 'extra large'))))) > 0
        order by i_product_name
        limit 100""",
    # Q45: web revenue by customer geography — zip-prefix list OR'd
    # with an item-sk IN subquery
    "q45": f"""
        select ca_zip, ca_city, sum(ws_sales_price) as total
        from {S}.web_sales, {S}.customer, {S}.customer_address,
             {S}.date_dim, {S}.item
        where ws_bill_customer_sk = c_customer_sk
          and c_current_addr_sk = ca_address_sk
          and ws_item_sk = i_item_sk
          and (substr(ca_zip, 1, 5) in ('10097', '10485', '11881',
                                        '12305', '13493', '14687',
                                        '15881', '16299', '17393')
               or i_item_id in (select i_item_id
                                from {S}.item
                                where i_item_sk in (2, 3, 5, 7, 11,
                                                    13, 17, 19, 23)))
          and ws_sold_date_sk = d_date_sk
          and d_qoy = 2
          and d_year = 2000
        group by ca_zip, ca_city
        order by ca_zip, ca_city
        limit 100""",
    # Q50: returned-in-how-many-days buckets per store (full store
    # address grouping)
    "q50": f"""
        select s_store_name, s_company_id, s_street_number,
               s_street_name, s_street_type, s_suite_number, s_city,
               s_county, s_state, s_zip,
               sum(case when sr_returned_date_sk - ss_sold_date_sk
                        <= 30 then 1 else 0 end) as days_30,
               sum(case when sr_returned_date_sk - ss_sold_date_sk
                        > 30 and sr_returned_date_sk - ss_sold_date_sk
                        <= 60 then 1 else 0 end) as days_31_60,
               sum(case when sr_returned_date_sk - ss_sold_date_sk
                        > 60 and sr_returned_date_sk - ss_sold_date_sk
                        <= 90 then 1 else 0 end) as days_61_90,
               sum(case when sr_returned_date_sk - ss_sold_date_sk
                        > 90 and sr_returned_date_sk - ss_sold_date_sk
                        <= 120 then 1 else 0 end) as days_91_120,
               sum(case when sr_returned_date_sk - ss_sold_date_sk
                        > 120 then 1 else 0 end) as days_over_120
        from {S}.store_sales, {S}.store_returns, {S}.store,
             {S}.date_dim d1, {S}.date_dim d2
        where d2.d_year = 2000
          and d2.d_moy = 8
          and ss_ticket_number = sr_ticket_number
          and ss_item_sk = sr_item_sk
          and ss_sold_date_sk = d1.d_date_sk
          and sr_returned_date_sk = d2.d_date_sk
          and ss_customer_sk = sr_customer_sk
          and ss_store_sk = s_store_sk
        group by s_store_name, s_company_id, s_street_number,
                 s_street_name, s_street_type, s_suite_number, s_city,
                 s_county, s_state, s_zip
        order by s_store_name, s_company_id, s_street_number,
                 s_street_name, s_street_type, s_suite_number, s_city,
                 s_county, s_state, s_zip
        limit 100""",
    # Q58: items whose one-week revenue agrees within 10% across all
    # three channels (nested scalar week-seq subqueries)
    "q58": f"""
        with ss_items as (
          select i_item_id as item_id,
                 sum(ss_ext_sales_price) as ss_item_rev
          from {S}.store_sales, {S}.item, {S}.date_dim
          where ss_item_sk = i_item_sk
            and d_date in (select d_date
                           from {S}.date_dim
                           where d_week_seq =
                                 (select d_week_seq
                                  from {S}.date_dim
                                  where d_date = date '2000-01-03'))
            and ss_sold_date_sk = d_date_sk
          group by i_item_id),
        cs_items as (
          select i_item_id as item_id,
                 sum(cs_ext_sales_price) as cs_item_rev
          from {S}.catalog_sales, {S}.item, {S}.date_dim
          where cs_item_sk = i_item_sk
            and d_date in (select d_date
                           from {S}.date_dim
                           where d_week_seq =
                                 (select d_week_seq
                                  from {S}.date_dim
                                  where d_date = date '2000-01-03'))
            and cs_sold_date_sk = d_date_sk
          group by i_item_id),
        ws_items as (
          select i_item_id as item_id,
                 sum(ws_ext_sales_price) as ws_item_rev
          from {S}.web_sales, {S}.item, {S}.date_dim
          where ws_item_sk = i_item_sk
            and d_date in (select d_date
                           from {S}.date_dim
                           where d_week_seq =
                                 (select d_week_seq
                                  from {S}.date_dim
                                  where d_date = date '2000-01-03'))
            and ws_sold_date_sk = d_date_sk
          group by i_item_id)
        select ss_items.item_id,
               ss_item_rev,
               ss_item_rev / ((ss_item_rev + cs_item_rev + ws_item_rev)
                              / 3) * 100 as ss_dev,
               cs_item_rev,
               cs_item_rev / ((ss_item_rev + cs_item_rev + ws_item_rev)
                              / 3) * 100 as cs_dev,
               ws_item_rev,
               ws_item_rev / ((ss_item_rev + cs_item_rev + ws_item_rev)
                              / 3) * 100 as ws_dev,
               (ss_item_rev + cs_item_rev + ws_item_rev) / 3
                 as average
        from ss_items, cs_items, ws_items
        where ss_items.item_id = cs_items.item_id
          and ss_items.item_id = ws_items.item_id
          and ss_item_rev between 0.9 * cs_item_rev
              and 1.1 * cs_item_rev
          and ss_item_rev between 0.9 * ws_item_rev
              and 1.1 * ws_item_rev
          and cs_item_rev between 0.9 * ss_item_rev
              and 1.1 * ss_item_rev
          and cs_item_rev between 0.9 * ws_item_rev
              and 1.1 * ws_item_rev
          and ws_item_rev between 0.9 * ss_item_rev
              and 1.1 * ss_item_rev
          and ws_item_rev between 0.9 * cs_item_rev
              and 1.1 * cs_item_rev
        order by ss_items.item_id, ss_item_rev
        limit 100""",
    # Q59: store weekly day-name sums, this-year vs next-year ratio by
    # a 52-week-shifted self-join
    "q59": f"""
        with wss as (
          select d_week_seq, ss_store_sk,
                 sum(case when d_day_name = 'Sunday'
                     then ss_sales_price else null end) as sun_sales,
                 sum(case when d_day_name = 'Monday'
                     then ss_sales_price else null end) as mon_sales,
                 sum(case when d_day_name = 'Tuesday'
                     then ss_sales_price else null end) as tue_sales,
                 sum(case when d_day_name = 'Wednesday'
                     then ss_sales_price else null end) as wed_sales,
                 sum(case when d_day_name = 'Thursday'
                     then ss_sales_price else null end) as thu_sales,
                 sum(case when d_day_name = 'Friday'
                     then ss_sales_price else null end) as fri_sales,
                 sum(case when d_day_name = 'Saturday'
                     then ss_sales_price else null end) as sat_sales
          from {S}.store_sales, {S}.date_dim
          where d_date_sk = ss_sold_date_sk
          group by d_week_seq, ss_store_sk)
        select s_store_name1, s_store_id1, d_week_seq1,
               sun_sales1 / sun_sales2 as r_sun,
               mon_sales1 / mon_sales2 as r_mon,
               tue_sales1 / tue_sales2 as r_tue,
               wed_sales1 / wed_sales2 as r_wed,
               thu_sales1 / thu_sales2 as r_thu,
               fri_sales1 / fri_sales2 as r_fri,
               sat_sales1 / sat_sales2 as r_sat
        from (select s_store_name as s_store_name1,
                     wss.d_week_seq as d_week_seq1,
                     s_store_id as s_store_id1,
                     sun_sales as sun_sales1, mon_sales as mon_sales1,
                     tue_sales as tue_sales1, wed_sales as wed_sales1,
                     thu_sales as thu_sales1, fri_sales as fri_sales1,
                     sat_sales as sat_sales1
              from wss, {S}.store, {S}.date_dim d
              where d.d_week_seq = wss.d_week_seq
                and ss_store_sk = s_store_sk
                and d_month_seq between 1188 and 1188 + 11) y,
             (select s_store_name as s_store_name2,
                     wss.d_week_seq as d_week_seq2,
                     s_store_id as s_store_id2,
                     sun_sales as sun_sales2, mon_sales as mon_sales2,
                     tue_sales as tue_sales2, wed_sales as wed_sales2,
                     thu_sales as thu_sales2, fri_sales as fri_sales2,
                     sat_sales as sat_sales2
              from wss, {S}.store, {S}.date_dim d
              where d.d_week_seq = wss.d_week_seq
                and ss_store_sk = s_store_sk
                and d_month_seq between 1188 + 12 and 1188 + 23) x
        where s_store_id1 = s_store_id2
          and d_week_seq1 = d_week_seq2 - 52
        order by s_store_name1, s_store_id1, d_week_seq1
        limit 100""",
    # Q61: promotional share of jewelry revenue in one geography —
    # two single-row derived tables, decimal(15,4) ratio
    "q61": f"""
        select promotions, total,
               cast(promotions as decimal(15,4))
               / cast(total as decimal(15,4)) * 100 as ratio
        from (select sum(ss_ext_sales_price) as promotions
              from {S}.store_sales, {S}.store, {S}.promotion,
                   {S}.date_dim, {S}.customer, {S}.customer_address,
                   {S}.item
              where ss_sold_date_sk = d_date_sk
                and ss_store_sk = s_store_sk
                and ss_promo_sk = p_promo_sk
                and ss_customer_sk = c_customer_sk
                and ca_address_sk = c_current_addr_sk
                and ss_item_sk = i_item_sk
                and ca_gmt_offset = -5
                and i_category = 'Jewelry'
                and (p_channel_dmail = 'Y' or p_channel_email = 'Y'
                     or p_channel_tv = 'Y')
                and s_gmt_offset = -5
                and d_year = 1998
                and d_moy = 11) promotional_sales,
             (select sum(ss_ext_sales_price) as total
              from {S}.store_sales, {S}.store, {S}.date_dim,
                   {S}.customer, {S}.customer_address, {S}.item
              where ss_sold_date_sk = d_date_sk
                and ss_store_sk = s_store_sk
                and ss_customer_sk = c_customer_sk
                and ca_address_sk = c_current_addr_sk
                and ss_item_sk = i_item_sk
                and ca_gmt_offset = -5
                and i_category = 'Jewelry'
                and s_gmt_offset = -5
                and d_year = 1998
                and d_moy = 11) all_sales
        order by promotions, total
        limit 100""",
    # Q72: catalog orders promised from low inventory — inventory
    # week-matched to the sale, 5-day ship lag, promo split counts
    "q72": f"""
        select i_item_desc, w_warehouse_name,
               d1.d_week_seq as d_week_seq,
               sum(case when p_promo_sk is null then 1 else 0 end)
                 as no_promo,
               sum(case when p_promo_sk is not null then 1 else 0 end)
                 as promo,
               count(*) as total_cnt
        from {S}.catalog_sales
             join {S}.inventory on cs_item_sk = inv_item_sk
             join {S}.warehouse on w_warehouse_sk = inv_warehouse_sk
             join {S}.item on i_item_sk = cs_item_sk
             join {S}.customer_demographics
               on cs_bill_cdemo_sk = cd_demo_sk
             join {S}.household_demographics
               on cs_bill_hdemo_sk = hd_demo_sk
             join {S}.date_dim d1 on cs_sold_date_sk = d1.d_date_sk
             join {S}.date_dim d2 on inv_date_sk = d2.d_date_sk
             join {S}.date_dim d3 on cs_ship_date_sk = d3.d_date_sk
             left join {S}.promotion on cs_promo_sk = p_promo_sk
             left join {S}.catalog_returns
               on cr_item_sk = cs_item_sk
              and cr_order_number = cs_order_number
        where d1.d_week_seq = d2.d_week_seq
          and inv_quantity_on_hand < cs_quantity
          and d3.d_date > d1.d_date + interval '5' day
          and hd_buy_potential = '>10000'
          and d1.d_year = 1999
          and cd_marital_status = 'D'
        group by i_item_desc, w_warehouse_name, d1.d_week_seq
        order by total_cnt desc, i_item_desc, w_warehouse_name,
                 d_week_seq
        limit 100""",
    # Q5: per-channel sales/returns/profit report — three
    # sales+returns UNION ALL CTEs (store/catalog page/web site), then
    # ROLLUP (channel, id) over the spliced channels
    "q5": f"""
        with ssr as (
          select s_store_id as store_id,
                 sum(sales_price) as sales,
                 sum(profit) as profit,
                 sum(return_amt) as returns_,
                 sum(net_loss) as profit_loss
          from (select ss_store_sk as store_sk,
                       ss_sold_date_sk as date_sk,
                       ss_ext_sales_price as sales_price,
                       ss_net_profit as profit,
                       cast(0 as decimal(7,2)) as return_amt,
                       cast(0 as decimal(7,2)) as net_loss
                from {S}.store_sales
                union all
                select sr_store_sk as store_sk,
                       sr_returned_date_sk as date_sk,
                       cast(0 as decimal(7,2)) as sales_price,
                       cast(0 as decimal(7,2)) as profit,
                       sr_return_amt as return_amt,
                       sr_net_loss as net_loss
                from {S}.store_returns) salesreturns,
               {S}.date_dim, {S}.store
          where date_sk = d_date_sk
            and d_date between date '2000-08-23'
                and date '2000-08-23' + interval '14' day
            and store_sk = s_store_sk
          group by s_store_id),
        csr as (
          select cp_catalog_page_id as catalog_page_id,
                 sum(sales_price) as sales,
                 sum(profit) as profit,
                 sum(return_amt) as returns_,
                 sum(net_loss) as profit_loss
          from (select cs_catalog_page_sk as page_sk,
                       cs_sold_date_sk as date_sk,
                       cs_ext_sales_price as sales_price,
                       cs_net_profit as profit,
                       cast(0 as decimal(7,2)) as return_amt,
                       cast(0 as decimal(7,2)) as net_loss
                from {S}.catalog_sales
                union all
                select cr_catalog_page_sk as page_sk,
                       cr_returned_date_sk as date_sk,
                       cast(0 as decimal(7,2)) as sales_price,
                       cast(0 as decimal(7,2)) as profit,
                       cr_return_amount as return_amt,
                       cr_net_loss as net_loss
                from {S}.catalog_returns) salesreturns,
               {S}.date_dim, {S}.catalog_page
          where date_sk = d_date_sk
            and d_date between date '2000-08-23'
                and date '2000-08-23' + interval '14' day
            and page_sk = cp_catalog_page_sk
          group by cp_catalog_page_id),
        wsr as (
          select web_site_id,
                 sum(sales_price) as sales,
                 sum(profit) as profit,
                 sum(return_amt) as returns_,
                 sum(net_loss) as profit_loss
          from (select ws_web_site_sk as wsr_web_site_sk,
                       ws_sold_date_sk as date_sk,
                       ws_ext_sales_price as sales_price,
                       ws_net_profit as profit,
                       cast(0 as decimal(7,2)) as return_amt,
                       cast(0 as decimal(7,2)) as net_loss
                from {S}.web_sales
                union all
                select ws.ws_web_site_sk as wsr_web_site_sk,
                       wr_returned_date_sk as date_sk,
                       cast(0 as decimal(7,2)) as sales_price,
                       cast(0 as decimal(7,2)) as profit,
                       wr_return_amt as return_amt,
                       wr_net_loss as net_loss
                from {S}.web_returns wr
                     left join {S}.web_sales ws
                       on wr.wr_item_sk = ws.ws_item_sk
                      and wr.wr_order_number = ws.ws_order_number)
               salesreturns,
               {S}.date_dim, {S}.web_site
          where date_sk = d_date_sk
            and d_date between date '2000-08-23'
                and date '2000-08-23' + interval '14' day
            and wsr_web_site_sk = web_site_sk
          group by web_site_id)
        select channel, id,
               sum(sales) as sales,
               sum(returns_) as returns_,
               sum(profit) as profit
        from (select 'store channel' as channel,
                     'store' || store_id as id,
                     sales, returns_,
                     profit - profit_loss as profit
              from ssr
              union all
              select 'catalog channel' as channel,
                     'catalog_page' || catalog_page_id as id,
                     sales, returns_,
                     profit - profit_loss as profit
              from csr
              union all
              select 'web channel' as channel,
                     'web_site' || web_site_id as id,
                     sales, returns_,
                     profit - profit_loss as profit
              from wsr) x
        group by rollup (channel, id)
        order by channel, id
        limit 100""",
    # Q18: catalog demographic averages over a four-level geography
    # ROLLUP, two customer_demographics instances
    "q18": f"""
        select i_item_id, ca_country, ca_state, ca_county,
               avg(cast(cs_quantity as decimal(12,2))) as agg1,
               avg(cast(cs_list_price as decimal(12,2))) as agg2,
               avg(cast(cs_coupon_amt as decimal(12,2))) as agg3,
               avg(cast(cs_sales_price as decimal(12,2))) as agg4,
               avg(cast(cs_net_profit as decimal(12,2))) as agg5,
               avg(cast(c_birth_year as decimal(12,2))) as agg6,
               avg(cast(cd1.cd_dep_count as decimal(12,2))) as agg7
        from {S}.catalog_sales,
             {S}.customer_demographics cd1,
             {S}.customer_demographics cd2,
             {S}.customer, {S}.customer_address, {S}.date_dim,
             {S}.item
        where cs_sold_date_sk = d_date_sk
          and cs_item_sk = i_item_sk
          and cs_bill_cdemo_sk = cd1.cd_demo_sk
          and cs_bill_customer_sk = c_customer_sk
          and cd1.cd_gender = 'F'
          and cd1.cd_education_status = 'Unknown'
          and c_current_cdemo_sk = cd2.cd_demo_sk
          and c_current_addr_sk = ca_address_sk
          and c_birth_month in (1, 6, 8, 9, 12, 2)
          and d_year = 1998
          and ca_state in ('GA', 'IL', 'MI', 'NY', 'OH', 'PA', 'TX')
        group by rollup (i_item_id, ca_country, ca_state, ca_county)
        order by ca_country, ca_state, ca_county, i_item_id
        limit 100""",
    # Q77: per-channel sales vs returns with outer-joined return CTEs
    # (catalog returns ride a global-agg CROSS JOIN), ROLLUP splice
    "q77": f"""
        with ss as (
          select s_store_sk,
                 sum(ss_ext_sales_price) as sales,
                 sum(ss_net_profit) as profit
          from {S}.store_sales, {S}.date_dim, {S}.store
          where ss_sold_date_sk = d_date_sk
            and d_date between date '2000-08-23'
                and date '2000-08-23' + interval '30' day
            and ss_store_sk = s_store_sk
          group by s_store_sk),
        sr as (
          select s_store_sk,
                 sum(sr_return_amt) as returns_,
                 sum(sr_net_loss) as profit_loss
          from {S}.store_returns, {S}.date_dim, {S}.store
          where sr_returned_date_sk = d_date_sk
            and d_date between date '2000-08-23'
                and date '2000-08-23' + interval '30' day
            and sr_store_sk = s_store_sk
          group by s_store_sk),
        cs as (
          select cs_call_center_sk,
                 sum(cs_ext_sales_price) as sales,
                 sum(cs_net_profit) as profit
          from {S}.catalog_sales, {S}.date_dim
          where cs_sold_date_sk = d_date_sk
            and d_date between date '2000-08-23'
                and date '2000-08-23' + interval '30' day
          group by cs_call_center_sk),
        cr as (
          select sum(cr_return_amount) as returns_,
                 sum(cr_net_loss) as profit_loss
          from {S}.catalog_returns, {S}.date_dim
          where cr_returned_date_sk = d_date_sk
            and d_date between date '2000-08-23'
                and date '2000-08-23' + interval '30' day),
        ws as (
          select wp_web_page_sk,
                 sum(ws_ext_sales_price) as sales,
                 sum(ws_net_profit) as profit
          from {S}.web_sales, {S}.date_dim, {S}.web_page
          where ws_sold_date_sk = d_date_sk
            and d_date between date '2000-08-23'
                and date '2000-08-23' + interval '30' day
            and ws_web_page_sk = wp_web_page_sk
          group by wp_web_page_sk),
        wr as (
          select wp_web_page_sk,
                 sum(wr_return_amt) as returns_,
                 sum(wr_net_loss) as profit_loss
          from {S}.web_returns, {S}.date_dim, {S}.web_page
          where wr_returned_date_sk = d_date_sk
            and d_date between date '2000-08-23'
                and date '2000-08-23' + interval '30' day
            and wr_web_page_sk = wp_web_page_sk
          group by wp_web_page_sk)
        select channel, id,
               sum(sales) as sales,
               sum(returns_) as returns_,
               sum(profit) as profit
        from (select 'store channel' as channel,
                     ss.s_store_sk as id, sales,
                     coalesce(returns_, 0) as returns_,
                     profit - coalesce(profit_loss, 0) as profit
              from ss left join sr on ss.s_store_sk = sr.s_store_sk
              union all
              select 'catalog channel' as channel,
                     cs_call_center_sk as id, sales, returns_,
                     profit - profit_loss as profit
              from cs cross join cr
              union all
              select 'web channel' as channel,
                     ws.wp_web_page_sk as id, sales,
                     coalesce(returns_, 0) as returns_,
                     profit - coalesce(profit_loss, 0) as profit
              from ws left join wr
                on ws.wp_web_page_sk = wr.wp_web_page_sk) x
        group by rollup (channel, id)
        order by channel, id, returns_
        limit 100""",
    # Q80: per-channel promotional sales/returns with outer-joined
    # returns at line granularity, TV-channel promotion filter, ROLLUP
    "q80": f"""
        with ssr as (
          select 'store' || s_store_id as id,
                 sum(ss_ext_sales_price) as sales,
                 sum(coalesce(sr_return_amt, 0)) as returns_,
                 sum(ss_net_profit - coalesce(sr_net_loss, 0))
                   as profit
          from {S}.store_sales
               left join {S}.store_returns
                 on ss_item_sk = sr_item_sk
                and ss_ticket_number = sr_ticket_number,
               {S}.date_dim, {S}.store, {S}.item, {S}.promotion
          where ss_sold_date_sk = d_date_sk
            and d_date between date '2000-08-23'
                and date '2000-08-23' + interval '30' day
            and ss_store_sk = s_store_sk
            and ss_item_sk = i_item_sk
            and i_current_price > 50
            and ss_promo_sk = p_promo_sk
            and p_channel_tv = 'N'
          group by s_store_id),
        csr as (
          select 'catalog_page' || cp_catalog_page_id as id,
                 sum(cs_ext_sales_price) as sales,
                 sum(coalesce(cr_return_amount, 0)) as returns_,
                 sum(cs_net_profit - coalesce(cr_net_loss, 0))
                   as profit
          from {S}.catalog_sales
               left join {S}.catalog_returns
                 on cs_item_sk = cr_item_sk
                and cs_order_number = cr_order_number,
               {S}.date_dim, {S}.catalog_page, {S}.item,
               {S}.promotion
          where cs_sold_date_sk = d_date_sk
            and d_date between date '2000-08-23'
                and date '2000-08-23' + interval '30' day
            and cs_catalog_page_sk = cp_catalog_page_sk
            and cs_item_sk = i_item_sk
            and i_current_price > 50
            and cs_promo_sk = p_promo_sk
            and p_channel_tv = 'N'
          group by cp_catalog_page_id),
        wsr as (
          select 'web_site' || web_site_id as id,
                 sum(ws_ext_sales_price) as sales,
                 sum(coalesce(wr_return_amt, 0)) as returns_,
                 sum(ws_net_profit - coalesce(wr_net_loss, 0))
                   as profit
          from {S}.web_sales
               left join {S}.web_returns
                 on ws_item_sk = wr_item_sk
                and ws_order_number = wr_order_number,
               {S}.date_dim, {S}.web_site, {S}.item, {S}.promotion
          where ws_sold_date_sk = d_date_sk
            and d_date between date '2000-08-23'
                and date '2000-08-23' + interval '30' day
            and ws_web_site_sk = web_site_sk
            and ws_item_sk = i_item_sk
            and i_current_price > 50
            and ws_promo_sk = p_promo_sk
            and p_channel_tv = 'N'
          group by web_site_id)
        select channel, id,
               sum(sales) as sales,
               sum(returns_) as returns_,
               sum(profit) as profit
        from (select 'store channel' as channel, id, sales,
                     returns_, profit
              from ssr
              union all
              select 'catalog channel' as channel, id, sales,
                     returns_, profit
              from csr
              union all
              select 'web channel' as channel, id, sales,
                     returns_, profit
              from wsr) x
        group by rollup (channel, id)
        order by channel, id
        limit 100""",
    # Q22: inventory quantity-on-hand over a 12-month window, item
    # hierarchy ROLLUP (grouping-sets desugar: 5 aggregation branches)
    "q22": f"""
        select i_product_name, i_brand, i_class, i_category,
               avg(inv_quantity_on_hand) as qoh
        from {S}.inventory, {S}.date_dim, {S}.item
        where inv_date_sk = d_date_sk
          and inv_item_sk = i_item_sk
          and d_month_seq between 1200 and 1200 + 11
        group by rollup (i_product_name, i_brand, i_class, i_category)
        order by qoh, i_product_name, i_brand, i_class, i_category
        limit 100""",
    # Q27: store-channel demographic averages with state ROLLUP and
    # grouping() in the select list
    "q27": f"""
        select i_item_id, s_state, grouping(s_state) as g_state,
               avg(ss_quantity) as agg1,
               avg(ss_list_price) as agg2,
               avg(ss_coupon_amt) as agg3,
               avg(ss_sales_price) as agg4
        from {S}.store_sales, {S}.customer_demographics, {S}.date_dim,
             {S}.store, {S}.item
        where ss_sold_date_sk = d_date_sk
          and ss_item_sk = i_item_sk
          and ss_store_sk = s_store_sk
          and ss_cdemo_sk = cd_demo_sk
          and cd_gender = 'M'
          and cd_marital_status = 'S'
          and cd_education_status = 'College'
          and d_year = 2002
          and s_state in ('TN', 'GA', 'AL', 'SC', 'KY', 'VA')
        group by rollup (i_item_id, s_state)
        order by i_item_id, s_state
        limit 100""",
    # Q67: the 8-column ROLLUP stress (9 aggregation branches) with a
    # rank() within category over the unioned grouping sets
    "q67": f"""
        select *
        from (select i_category, i_class, i_brand, i_product_name,
                     d_year, d_qoy, d_moy, s_store_id, sumsales,
                     rank() over (partition by i_category
                                  order by sumsales desc) as rk
              from (select i_category, i_class, i_brand,
                           i_product_name, d_year, d_qoy, d_moy,
                           s_store_id,
                           sum(coalesce(ss_sales_price * ss_quantity,
                                        0)) as sumsales
                    from {S}.store_sales, {S}.date_dim, {S}.store,
                         {S}.item
                    where ss_sold_date_sk = d_date_sk
                      and ss_item_sk = i_item_sk
                      and ss_store_sk = s_store_sk
                      and d_month_seq between 1200 and 1200 + 11
                    group by rollup (i_category, i_class, i_brand,
                                     i_product_name, d_year, d_qoy,
                                     d_moy, s_store_id)) dw1) dw2
        where rk <= 100
        order by i_category, i_class, i_brand, i_product_name, d_year,
                 d_qoy, d_moy, s_store_id, sumsales, rk
        limit 100""",
}
